"""One command for every port tool — the port of the JAX package's
``tools/tpu_batch.sh`` (the batch) and ``tools/relay_watch.sh`` (wait for
the accelerator, then run the batch).

Each step runs as a subprocess under its own hard timeout, in a
directory of its own under the batch's work directory (its cwd; the
artifacts it writes — event log, flight dump, drift table, soak tally,
autotune table — and its output, ``output.log``, land there), and prints
one JSON line: ``{"tool", "rc", "seconds", "record"}`` — the record is the
step's last JSON line, else its last line of text. Every step runs even
after one fails, none is skipped, and the batch exits 1 if any step
did (the last line is the summary).

Steps, in order: the soak's ``all`` batteries; the chaos and race
drills; ``plan_snapshot``, ``plan_verify``; ``topology_flip``; the flight
and provenance drills; ``traffic`` in its three modes (overload,
``--slo``, ``--slices``); ``multihost_check --nproc 2``; ``lockcheck``;
``matlint``; ``pagerank_overlap``; the eight examples. The JAX batch's
``bench.py`` / ``bench_all.py`` steps belong to the benchmark; its
``north_star_sweep``, ``gram_*`` and ``autotune_capture`` steps are
``chip_smoke.py`` phases.

Modes:
  (default)  on the card (``--device cuda``), artifacts under
             ``build/batch/`` of the checkout, the log in
             ``build/batch/batch.log``;
  --dry      the CPU fire drill (``tpu_batch.sh --dry``): the same
             sequence on the CPU at toy sizes, every artifact under
             ``--dry-dir`` (default a fresh temp dir) — nothing lands in
             the checkout;
  --wait     ``relay_watch.sh``: probe the card in a subprocess under a
             timeout (CUDA initialises and one B2 launch completes),
             sleeping ``PROBE_INTERVAL_S`` between probes until it
             answers, then run the batch.

Steps run one at a time on the card (they would share it and its
timings), ``DRY_JOBS`` at a time in a dry run.

Run: python -m matrel_tpu_torch.tools.batch [--dry [--dry-dir DIR]]
         [--wait]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

EXAMPLES = ("graph_demo", "linreg_demo", "chain_optimizer_demo",
            "relational_sql_demo", "analytics_demo",
            "layout_aware_planning_demo", "autotune_demo",
            "distributed_sparse_demo")

#: The dry run's toy sizes (the traffic harness's short windows, the
#: soak's and race drill's seeds, the overlap experiment's graph).
DRY_ENV = {"MATREL_TRAFFIC_SECONDS": "1.5",
           "MATREL_TRAFFIC_TAIL_SECONDS": "1",
           "MATREL_TRAFFIC_CAL": "30", "MATREL_RACE_SEEDS": "2",
           "OMP_NUM_THREADS": "1"}
DRY_SEEDS, CARD_SEEDS = 1, 8
DRY_JOBS = 3
DRY_OVERLAP = ["--n", "20000", "--edges", "100000"]
#: ``--wait``: seconds between probes (relay_watch.sh's sleep), and the
#: probes before giving up (None: never, as relay_watch.sh).
PROBE_INTERVAL_S = 600.0
MAX_PROBES: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Step:
    """One tool run: ``argv`` after the interpreter, its hard timeout."""
    name: str
    argv: Sequence[str]
    timeout_s: float


def steps(device: str, dry: bool) -> List[Step]:
    """The batch's sequence on ``device`` (toy sizes with ``dry``)."""
    dev = ["--device", device]
    tool = "matrel_tpu_torch.tools."
    scale = 1 if dry else 4             # card steps run at full size

    def t(name, *args, timeout=120.0):
        return Step(name, ["-m", tool + name.split()[0], *args],
                    timeout * scale)

    seeds = str(DRY_SEEDS if dry else CARD_SEEDS)
    out = [
        t("soak", "all", "--seeds", seeds, *dev, timeout=300.0),
        t("chaos_drill", *dev), t("race_drill", *dev),
        t("plan_snapshot", *dev), t("plan_verify", *dev),
        t("topology_flip", *dev), t("flight_drill", *dev),
        t("provenance_drill", *dev),
        t("traffic", *dev), t("traffic --slo", "--slo", *dev),
        t("traffic --slices", "--slices", *dev),
        t("multihost_check", "--nproc", "2", *dev, timeout=240.0),
        t("lockcheck"), t("matlint"),
        t("pagerank_overlap", *dev, *(DRY_OVERLAP if dry else [])),
    ]
    out += [Step(f"examples.{e}",
                 ["-m", f"matrel_tpu_torch.examples.{e}", *dev],
                 300.0 * scale) for e in EXAMPLES]
    return out


def artifact_env(workdir: str, dry: bool) -> Dict[str, str]:
    """The environment of a step run in ``workdir``: the checkout on
    ``PYTHONPATH``, every artifact path under ``workdir`` (and the toy
    sizes when ``dry``)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.update({
        "MATREL_OBS_EVENT_LOG": os.path.join(workdir, "events.jsonl"),
        "MATREL_OBS_FLIGHT_RECORDER_PATH": os.path.join(workdir,
                                                        "flight.json"),
        "MATREL_DRIFT_TABLE_PATH": os.path.join(workdir, "drift.json"),
        "MATREL_SOAKLOG_PATH": os.path.join(workdir, "soaklog.jsonl"),
        "MATREL_AUTOTUNE_TABLE_PATH": os.path.join(workdir,
                                                   "autotune.json")})
    if dry:
        env.update(DRY_ENV)
    return env


def _record(stdout: str):
    """A step's record: its last JSON object line that holds a key (an
    explain's ``== Collectives ==`` section ends in a bare ``{}`` on one
    card), else its last line."""
    lines = [ln.strip() for ln in stdout.splitlines() if ln.strip()]
    for ln in reversed(lines):
        if ln.startswith("{"):
            try:
                rec = json.loads(ln)
            except ValueError:
                continue
            if rec:
                return rec
    return lines[-1] if lines else None


def run_step(step: Step, root: str, dry: bool) -> dict:
    """Run one step in a directory of its own under ``root`` (its cwd and
    its artifacts; its output in ``output.log`` there) to its end or its
    timeout (the process group killed then; rc 124, as ``timeout``
    gives)."""
    workdir = os.path.join(root, step.name.replace(" ", "_"))
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, *step.argv], cwd=workdir,
                            env=artifact_env(workdir, dry),
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=step.timeout_s)
        rc = proc.returncode
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        out, _ = proc.communicate()
        rc = 124
    seconds = time.perf_counter() - t0
    with open(os.path.join(workdir, "output.log"), "w") as f:
        f.write(out)
    return {"tool": step.name, "rc": rc, "seconds": round(seconds, 3),
            "record": _record(out)}


def run_steps(todo: Sequence[Step], root: str, dry: bool = False,
              emit: Callable[[str], None] = print,
              jobs: int = 1) -> List[dict]:
    """Every step, one JSON line each as it ends (``jobs`` at a time;
    one on the card, where steps would share it); none is skipped.
    Returns the rows in step order."""
    from concurrent.futures import ThreadPoolExecutor, as_completed
    rows: Dict[int, dict] = {}
    with ThreadPoolExecutor(max_workers=max(jobs, 1)) as pool:
        futs = {pool.submit(run_step, st, root, dry): i
                for i, st in enumerate(todo)}
        for fut in as_completed(futs):
            rows[futs[fut]] = row = fut.result()
            emit(json.dumps(row, default=str))
    return [rows[i] for i in range(len(todo))]


PROBE = r"""
import json, torch
from matrel_tpu_torch.ops import pallas_spmv as pc, spmv as spmv_lib
assert torch.cuda.is_available(), "no CUDA device"
plan = spmv_lib.build_spmv_plan([0, 1, 2], [2, 0, 1], None, 4, 4)
before = pc.LAUNCHES_SPMV
y = pc.spmv_compact(plan, torch.ones(4), device="cuda")
torch.cuda.synchronize()
assert pc.LAUNCHES_SPMV == before + 1 and float(y.sum()) == 3.0
print(json.dumps({"probe": "ok", "device": torch.cuda.get_device_name(0)}))
"""


def probe(workdir: str, timeout_s: float = 300.0) -> bool:
    """Does the card answer: CUDA initialises and one B2 launch
    completes, in a subprocess under ``timeout_s``?"""
    try:
        out = subprocess.run([sys.executable, "-c", PROBE],
                             env=artifact_env(workdir, False),
                             cwd=REPO, capture_output=True, text=True,
                             timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return False
    return out.returncode == 0 and '"probe": "ok"' in out.stdout


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m matrel_tpu_torch.tools.batch")
    ap.add_argument("--dry", action="store_true",
                    help="the CPU fire drill at toy sizes")
    ap.add_argument("--dry-dir", default=None,
                    help="where a dry run's artifacts go (default: a "
                         "fresh temp dir)")
    ap.add_argument("--wait", action="store_true",
                    help="probe the card until it answers, then run")
    args = ap.parse_args(argv)
    if args.dry:
        workdir = args.dry_dir or tempfile.mkdtemp(prefix="matrel_batch_")
    else:
        workdir = os.path.join(REPO, "build", "batch")
    os.makedirs(workdir, exist_ok=True)
    log = open(os.path.join(workdir, "batch.log"), "a")

    def emit(line: str) -> None:
        print(line, flush=True)
        log.write(f"{time.strftime('%H:%M:%S')} {line}\n")
        log.flush()

    try:
        if args.wait:
            probes = 0
            while not probe(workdir):
                probes += 1
                emit(json.dumps({"probe": "down", "probes": probes}))
                if MAX_PROBES is not None and probes >= MAX_PROBES:
                    emit(json.dumps({"batch": "gave up waiting",
                                     "probes": probes}))
                    return 3
                time.sleep(PROBE_INTERVAL_S)
            emit(json.dumps({"probe": "ok"}))
        todo = steps("cpu" if args.dry else "cuda", args.dry)
        emit(json.dumps({"batch": "start", "dry": args.dry,
                         "workdir": workdir, "steps": len(todo)}))
        rows = run_steps(todo, workdir, args.dry, emit,
                         DRY_JOBS if args.dry else 1)
        failed = [r["tool"] for r in rows if r["rc"] != 0]
        emit(json.dumps({"batch": "done", "steps": len(rows),
                         "failed": failed,
                         "seconds": round(sum(r["seconds"] for r in rows),
                                          3)}))
        return 1 if failed else 0
    finally:
        log.close()


if __name__ == "__main__":
    sys.exit(main())
