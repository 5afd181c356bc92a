"""Observability smoke drill: flight recorder + trace export + drift — the
port of the JAX package's ``tools/flight_drill.py``.

Drives a real session through the observability surfaces and asserts each
artifact end to end:

  1. a 3-query micro-batched serve admission (``run_many``) plus one
     async ``submit`` — the admission / compile / execute span trail;
  2. a COMPILE FAILURE (mixed-mesh expression) — the flight recorder's
     automatic dump must leave a parseable post-mortem artifact;
  3. ``explain(analyze=True)`` — one ``analyze`` event, the drift
     auditor's measured-vs-estimated feed;
  4. chrome export over the session's event log (span count + at least
     one parent link — the Perfetto-loadable acceptance);
  5. a drift report with the calibration table persisted.

Prints one JSON line (``flight_recorder_drill``); exit code 0 when it
holds. Unlike the JAX drill, which forces the CPU, this one runs on the
card unless ``--device cpu`` is given.

Artifact paths follow the config env knobs: MATREL_OBS_EVENT_LOG
(span/event log), MATREL_OBS_FLIGHT_RECORDER_PATH (dump artifact),
MATREL_DRIFT_TABLE_PATH (calibration table); unset, they are the
package's gitignored defaults in the working directory.

    python -m matrel_tpu_torch.tools.flight_drill [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np


def drill(device="cuda") -> dict:
    """Run the drill on ``device`` and return its record."""
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.obs import drift, trace as trace_lib
    from matrel_tpu_torch.obs.events import read_events, resolve_path
    from matrel_tpu_torch.session import MatrelSession

    # env (MATREL_*) overrides flow over the drill's base config
    cfg = MatrelConfig.from_env(MatrelConfig(
        obs_level="on", obs_flight_recorder=256,
        result_cache_max_bytes=1 << 26))
    mesh = mesh_lib.make_mesh((2, 4), device=device)
    sess = MatrelSession(mesh=mesh, config=cfg)
    rng = np.random.default_rng(0)
    A = sess.from_numpy(rng.standard_normal((64, 96)).astype(np.float32))
    B = sess.from_numpy(rng.standard_normal((96, 32)).astype(np.float32))

    try:
        # 1. the 3-query serve batch + one async submit so the
        #    admission-worker span trail exists too
        batch = [A.expr().multiply(B.expr()).multiply_scalar(s)
                 for s in (1.0, 2.0, 3.0)]
        outs = sess.run_many(batch)
        ok_batch = len(outs) == 3 and outs[0].shape == (64, 32)
        sess.submit(A.expr().multiply(B.expr())).result()
        sess.serve_drain()

        # 2. compile failure -> automatic flight-recorder dump. A
        #    mixed-mesh expression (a leaf on a 1 x 1 grid of the same
        #    device) fails the executor's _check_one_mesh inside
        #    compile_expr with the JAX package's ValueError — a real
        #    compile-path error, not a monkeypatched one.
        other = mesh_lib.make_mesh((1, 1), device=mesh.device)
        M_other = BlockMatrix.from_numpy(
            rng.standard_normal((96, 32)).astype(np.float32), mesh=other)
        compile_failed = False
        try:
            sess.run(A.expr().multiply(M_other.expr()))
        except ValueError:
            compile_failed = True
        flight_path = (cfg.obs_flight_recorder_path
                       or trace_lib.DEFAULT_FLIGHT_PATH)
        flight = None
        if os.path.exists(flight_path):
            with open(flight_path) as f:
                flight = json.load(f)

        # 3. one analyze event (the drift feed)
        sess.explain(A.expr().multiply(B.expr()), analyze=True)
    finally:
        sess.serve_close(timeout=60)

    # 4. chrome export over the whole log
    log_path = resolve_path(cfg.obs_event_log
                            or os.environ.get("MATREL_OBS_EVENT_LOG"))
    events = read_events(log_path)
    doc = trace_lib.chrome_trace(events)
    names = {ev["name"] for ev in doc["traceEvents"]}
    ids = {ev["args"].get("span_id") for ev in doc["traceEvents"]}
    parent_linked = sum(
        1 for ev in doc["traceEvents"]
        if ev["args"].get("parent_id") in ids
        and ev["args"].get("parent_id") is not None)

    # 5. drift report + persisted table
    table_path = drift.table_path(cfg)
    drift_report = drift.report(events, table_path_str=table_path)
    drift_rows = len(drift.calibrate(list(drift.iter_samples(events))))

    record = {
        "metric": "flight_recorder_drill",
        "device": str(mesh.device),
        "batch_ok": ok_batch,
        "compile_failure_dumped": bool(
            compile_failed and flight
            and flight.get("reason") == "compile_failure"
            and flight.get("records")),
        "flight_path": flight_path,
        "flight_records": len((flight or {}).get("records") or ()),
        "chrome_events": len(doc["traceEvents"]),
        "parent_linked": parent_linked,
        "span_names": sorted(names),
        "drift_rows": drift_rows,
        "drift_table": table_path,
        "log": log_path,
    }
    record["ok"] = bool(
        record["batch_ok"] and record["compile_failure_dumped"]
        and record["chrome_events"] > 0 and record["parent_linked"] > 0
        and {"serve.admit", "serve.batch", "plan.optimize",
             "serve.execute"} <= names
        and drift_rows >= 1
        and os.path.exists(table_path)
        and "drift audit" in drift_report)
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.flight_drill",
        description="flight recorder / trace export / drift drill of the "
                    "PyTorch port")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    record = drill(args.device)
    print(json.dumps(record))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
