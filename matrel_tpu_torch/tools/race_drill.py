"""race_drill — deterministic-seeded thread-interleaving drill for the
serve / fleet concurrency plane, run with runtime lockdep armed
(``utils/lockdep.py``) — the port of the JAX package's
``tools/race_drill.py``.

Four schedules, each the scene of a past or predicted race, each trial
seeded so a failure reproduces by seed:

  submit_close_drain   concurrent submit / close / drain against one
                       pipeline
  kill_replication     kill_slice racing a rebind's re-replication and
                       in-flight directory inserts
  rebind_probes        register() rebinds racing identical template
                       queries (plan-template reuse, CSE probes)
  delta_serve          register_delta IVM maintenance under live serve
                       load

Rebinds and deltas are value-preserving (same numbers, new objects), so
every resolved answer has one oracle whatever the interleaving: any
mismatch is a real race.

Contract (the one JSON line): 0 wrong answers, 0 untyped failures (every
refusal is ResilienceError-family), the lockdep order graph acyclic with
0 inversions, across all seeds × schedules.

Knobs (env): MATREL_RACE_SEEDS (trials a schedule, default 8),
MATREL_RACE_QUERIES (queries a trial, default 10), MATREL_RACE_SCHEDULES
(comma list, default all).

    python -m matrel_tpu_torch.tools.race_drill [--device cpu]

It runs on the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading

import numpy as np

N = 48                  # table side: interleaving, not FLOPs
TIMEOUT = 60            # every wait in the drill is bounded


def _base_cfg(**kw):
    """Drill base config; MATREL_* env still flows over it."""
    from matrel_tpu_torch.config import MatrelConfig
    base = dict(lockdep_enable=True, lockdep_raise=False,
                serve_max_batch=1, result_cache_max_bytes=64 << 20)
    base.update(kw)
    return MatrelConfig.from_env(MatrelConfig(**base))


def _session(device, **kw):
    from matrel_tpu_torch.session import MatrelSession
    return MatrelSession(config=_base_cfg(**kw), device=device)


def _mats(sess, rng, names=("A", "B")):
    mats = {}
    for nm in names:
        arr = rng.standard_normal((N, N)).astype(np.float32)
        mats[nm] = arr
        sess.register(nm, sess.from_numpy(arr))
    return mats


def _score(futs, oracle, tol=3e-3):
    """(wrong, untyped, resolved) over futures sharing one oracle. Typed
    refusals are the contract, not failures."""
    from matrel_tpu_torch.resilience.errors import ResilienceError
    wrong = untyped = resolved = 0
    for fut in futs:
        try:
            got = np.asarray(fut.result(timeout=TIMEOUT).to_numpy())
            err = float(np.abs(got - oracle).max())
            if err > tol * max(float(np.abs(oracle).max()), 1.0):
                wrong += 1
            else:
                resolved += 1
        except ResilienceError:
            pass
        except Exception:  # noqa: BLE001 — untyped IS the finding
            untyped += 1
    return wrong, untyped, resolved


def _close(sess):
    try:
        sess.serve_close(timeout=TIMEOUT)
    except Exception:  # noqa: BLE001 — teardown best-effort
        pass


# -- schedules -----------------------------------------------------------------


def sched_submit_close_drain(seed: int, queries: int,
                             device="cuda") -> dict:
    """A submitter races a drainer and a closer on one pipeline: late
    submits refuse typed, resolved answers are right, nothing wedges."""
    from matrel_tpu_torch.resilience.errors import ResilienceError
    rng = np.random.default_rng(seed)
    sess = _session(device)
    try:
        mats = _mats(sess, rng)
        expr = sess.table("A").expr().multiply(sess.table("B").expr())
        oracle = mats["A"] @ mats["B"]
        close_after = int(rng.integers(1, max(queries - 1, 2)))
        submitted = threading.Semaphore(0)
        futs, errs = [], []

        def _drain():
            submitted.acquire(timeout=TIMEOUT)
            try:
                sess.serve_drain(timeout=TIMEOUT)
            except ResilienceError:
                pass
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        def _closer():
            for _ in range(close_after):
                submitted.acquire(timeout=TIMEOUT)
            try:
                sess.serve_close(timeout=TIMEOUT)
            except ResilienceError:
                pass
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        ts = [threading.Thread(target=_drain, daemon=True),
              threading.Thread(target=_closer, daemon=True)]
        for t in ts:
            t.start()
        typed_refusals = 0
        for _ in range(queries):
            try:
                futs.append(sess.submit(expr))
            except ResilienceError:
                typed_refusals += 1    # closed / shed mid-race: typed
            submitted.release()
        for _ in range(queries, close_after + 1):
            submitted.release()        # the closer never starves
        for t in ts:
            t.join(timeout=TIMEOUT)
        wedged = any(t.is_alive() for t in ts)
        wrong, untyped, resolved = _score(futs, oracle)
        untyped += len(errs) + (1 if wedged else 0)
        return {"wrong": wrong, "untyped": untyped,
                "resolved": resolved, "refused": typed_refusals}
    finally:
        _close(sess)


def sched_kill_replication(seed: int, queries: int, device="cuda") -> dict:
    """kill_slice concurrent with a value-preserving rebind (which
    re-replicates under the registration lock) and a live stream."""
    from matrel_tpu_torch.resilience.errors import ResilienceError
    rng = np.random.default_rng(seed)
    sess = _session(device, fleet_slices=2, fleet_replicate_hits=0)
    try:
        mats = _mats(sess, rng)
        expr = sess.table("A").expr().multiply(sess.table("B").expr())
        oracle = mats["A"] @ mats["B"]
        victim = int(rng.integers(0, 2))
        kill_at = int(rng.integers(1, max(queries - 1, 2)))
        errs = []

        def _rebind():
            try:
                # same values, new device objects: the whole on_register
                # surgery and re-replication
                sess.register("A", sess.from_numpy(mats["A"]))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        futs = []
        rb = threading.Thread(target=_rebind, daemon=True)
        for i in range(queries):
            futs.append(sess.submit(expr))
            if i == kill_at:
                rb.start()
                sess._fleet.kill_slice(victim)
        rb.join(timeout=TIMEOUT)
        try:
            sess.serve_drain(timeout=TIMEOUT)
        except ResilienceError:
            pass
        wrong, untyped, resolved = _score(futs, oracle)
        untyped += len(errs) + (1 if rb.is_alive() else 0)
        return {"wrong": wrong, "untyped": untyped,
                "resolved": resolved, "refused": 0}
    finally:
        _close(sess)


def sched_rebind_probes(seed: int, queries: int, device="cuda") -> dict:
    """A register() rebind storm racing identical template queries: the
    template and CSE sharing planes never serve a torn binding."""
    from matrel_tpu_torch.resilience.errors import ResilienceError
    rng = np.random.default_rng(seed)
    sess = _session(device)
    try:
        mats = _mats(sess, rng)
        expr = (sess.table("A").expr()
                .multiply(sess.table("B").expr()).add_scalar(1.0))
        oracle = mats["A"] @ mats["B"] + 1.0
        stop = threading.Event()
        errs = []

        def _rebinder():
            try:
                while not stop.is_set():
                    sess.register("A", sess.from_numpy(mats["A"]))
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        rb = threading.Thread(target=_rebinder, daemon=True)
        rb.start()
        futs = [sess.submit(expr) for _ in range(queries)]
        try:
            sess.serve_drain(timeout=TIMEOUT)
        except ResilienceError:
            pass
        stop.set()
        rb.join(timeout=TIMEOUT)
        wrong, untyped, resolved = _score(futs, oracle)
        untyped += len(errs) + (1 if rb.is_alive() else 0)
        return {"wrong": wrong, "untyped": untyped,
                "resolved": resolved, "refused": 0}
    finally:
        _close(sess)


def sched_delta_serve(seed: int, queries: int, device="cuda") -> dict:
    """register_delta (a zero-valued COO delta: the IVM machinery runs,
    values stand still) under live serve load."""
    from matrel_tpu_torch.resilience.errors import ResilienceError
    rng = np.random.default_rng(seed)
    sess = _session(device)
    try:
        mats = _mats(sess, rng)
        expr = sess.table("A").expr().multiply(sess.table("B").expr())
        oracle = mats["A"] @ mats["B"]
        errs = []
        k = 8
        rows = rng.integers(0, N, size=k)
        cols = rng.integers(0, N, size=k)
        vals = np.zeros(k, dtype=np.float32)
        futs = []
        for i in range(queries):
            futs.append(sess.submit(expr))
            if i % 3 == 1:
                try:
                    sess.register_delta("A", (rows, cols, vals),
                                        kind="coo")
                except ResilienceError:
                    pass
                except Exception as e:  # noqa: BLE001
                    errs.append(e)
        try:
            sess.serve_drain(timeout=TIMEOUT)
        except ResilienceError:
            pass
        wrong, untyped, resolved = _score(futs, oracle)
        untyped += len(errs)
        return {"wrong": wrong, "untyped": untyped,
                "resolved": resolved, "refused": 0}
    finally:
        _close(sess)


SCHEDULES = {
    "submit_close_drain": sched_submit_close_drain,
    "kill_replication": sched_kill_replication,
    "rebind_probes": sched_rebind_probes,
    "delta_serve": sched_delta_serve,
}


def drill(device="cuda", seeds: int = 8, queries: int = 10,
          names=None) -> dict:
    """Run ``seeds`` trials of each schedule in ``names`` (default all)
    on ``device``; returns the drill's record."""
    from matrel_tpu_torch.core.mesh import resolve_device
    from matrel_tpu_torch.utils import lockdep
    device = resolve_device(device)
    names = list(names or SCHEDULES)
    totals = {"wrong": 0, "untyped": 0, "resolved": 0, "refused": 0}
    per_sched = {}
    inversions = dispatch_holds = trials = 0
    acyclic = True
    for name in names:
        fn = SCHEDULES[name]
        agg = {k: 0 for k in totals}
        for seed in range(seeds):
            # a fresh order graph a trial: a cycle reproduces by
            # (schedule, seed), not by whatever ran before it
            lockdep.reset()
            res = fn(1000 * (list(SCHEDULES).index(name) + 1) + seed,
                     queries, device)
            trials += 1
            for key in totals:
                agg[key] += res[key]
                totals[key] += res[key]
            diags = lockdep.diagnostics()
            inversions += sum(1 for d in diags
                              if d["diag"] in ("inversion",
                                               "self_deadlock"))
            dispatch_holds += sum(1 for d in diags
                                  if d["diag"] == "held_across_dispatch")
            acyclic = acyclic and lockdep.is_acyclic()
            print(f"  {name} seed {seed}: {res}", file=sys.stderr,
                  flush=True)
        per_sched[name] = agg
    lockdep.reset()
    lockdep.disable()
    return {
        "metric": "race_drill", "device": str(device), "seeds": seeds,
        "queries": queries, "trials": trials, "schedules": per_sched,
        "wrong": totals["wrong"], "untyped": totals["untyped"],
        "resolved": totals["resolved"], "refused": totals["refused"],
        "inversions": inversions, "held_across_dispatch": dispatch_holds,
        "acyclic": acyclic,
        "ok": (totals["wrong"] == 0 and totals["untyped"] == 0
               and inversions == 0 and acyclic
               and totals["resolved"] > 0),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.race_drill",
        description="thread-interleaving drill of the PyTorch port's "
                    "serve / fleet plane")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    picked = os.environ.get("MATREL_RACE_SCHEDULES", "")
    record = drill(
        args.device, int(os.environ.get("MATREL_RACE_SEEDS", "8")),
        int(os.environ.get("MATREL_RACE_QUERIES", "10")),
        [s for s in picked.split(",") if s in SCHEDULES] if picked
        else None)
    print(json.dumps(record), flush=True)
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
