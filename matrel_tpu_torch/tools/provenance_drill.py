"""Answer-provenance drill: the ledger on every serve path and its audit
replay — the port of the JAX package's ``tools/provenance_drill.py``.

Drives real sessions through every provenance-bearing serve path and then
proves the ledgers by full audit replay:

  1. a 3-query serve batch (``run_many``) twice — fresh ``execute``
     records, then whole ``rc_hit`` records — plus a superexpression
     (``rc_interior``) on a ledger-enabled session;
  2. a catalog REBIND (plain ``register``) followed by a COO delta
     (``register_delta``) — the re-served query's record is
     ``ivm_patched`` with the patch chain attached;
  3. a 2-slice fleet: repeat submits cross the directory
     (``fleet_directory``), trip hot-entry replication, and the next ask
     serves from the replica (``fleet_replica``);
  4. an injected-fault session that climbs the full degradation ladder —
     the completing attempt's record is ``degraded`` at rung 4;
  5. FULL audit replay over every ledger (cache bypassed, MV113
     comparison: bit-equal when the composed bound is 0, within the
     stamped err_bound otherwise) + the MV115 dynamic ledger check.

Prints one JSON line (``provenance_drill``); exit code 0 when it holds.
Unlike the JAX drill, which forces the CPU, this one runs on the card
unless ``--device cpu`` is given. The event log follows
MATREL_OBS_EVENT_LOG.

    python -m matrel_tpu_torch.tools.provenance_drill [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np


def _paths(sess):
    led = sess._prov
    return sorted({r.path for r in led.records()}) if led else []


def drill(device="cuda") -> dict:
    """Run the drill on ``device`` and return its record."""
    from matrel_tpu_torch.analysis import provenance_pass
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.obs import provenance as provenance_lib
    from matrel_tpu_torch.session import MatrelSession

    # env (MATREL_*) overrides flow over the drill's base configs
    base = dict(obs_level="on", obs_provenance=256,
                result_cache_max_bytes=1 << 28)
    mesh = mesh_lib.make_mesh((2, 4), device=device)
    rng = np.random.default_rng(0)
    sessions = []

    try:
        # 1. + 2. serve batch / hits / interior / rebind + delta patch
        sess = MatrelSession(
            mesh=mesh, config=MatrelConfig.from_env(MatrelConfig(**base)))
        sessions.append(sess)
        adj = (rng.random((48, 48)) < 0.2).astype(np.float32)
        sess.register("A", sess.from_numpy(adj, integral=True))
        sess.register("B", sess.from_numpy(
            rng.standard_normal((48, 32)).astype(np.float32)))

        def q_counts():
            return sess.table("A").expr().multiply(sess.table("A").expr())

        def q_ab():
            return sess.table("A").expr().multiply(sess.table("B").expr())

        batch = [q_ab(), q_ab().multiply_scalar(2.0), q_counts()]
        sess.run_many(batch)
        sess.run_many(batch)                      # whole hits
        sess.run(q_ab().multiply_scalar(3.0))     # interior substitution
        # rebind B (invalidation, a fresh execute on the re-serve) ...
        sess.register("B", sess.from_numpy(
            rng.standard_normal((48, 32)).astype(np.float32)))
        sess.run(q_ab())
        # ... then a sparse delta on A: the patched entry's next serve is
        # the ivm_patched path, exact (integer path counts)
        k = 6
        sess.register_delta(
            "A", (rng.integers(0, 48, k), rng.integers(0, 48, k),
                  np.ones(k, np.float32)), kind="coo")
        sess.run(q_counts())
        serve_paths = _paths(sess)

        # 3. fleet: directory hit, replication, replica-local serve
        fsess = MatrelSession(mesh=mesh, config=MatrelConfig.from_env(
            MatrelConfig(fleet_slices=2, fleet_replicate_hits=1, **base)))
        sessions.append(fsess)
        fsess.register("A", fsess.from_numpy(
            rng.standard_normal((64, 64)).astype(np.float32)))
        fsess.register("B", fsess.from_numpy(
            rng.standard_normal((64, 64)).astype(np.float32)))
        fq = fsess.table("A").expr().multiply(fsess.table("B").expr())
        fsess.submit(fq).result(timeout=120)      # placed execute
        fsess.serve_drain()
        fsess.submit(fq).result(timeout=120)      # directory hit (remote)
        fleet = fsess._ensure_fleet()
        fleet.quiesce_replication(timeout=60)
        for _ in range(4):
            # placement load-balances the preferred slice across repeats;
            # the ask that prefers the replica's slice serves from it
            fsess.submit(fq).result(timeout=120)
            fsess.serve_drain()
            if "fleet_replica" in _paths(fsess):
                break
        fleet_paths = _paths(fsess)
        fsess.serve_close()

        # 4. the full ladder: every attempt's execute faults until the
        #    cap, the completing attempt runs degraded at rung 4
        dsess = MatrelSession(mesh=mesh, config=MatrelConfig.from_env(
            MatrelConfig(fault_inject="execute:transient:p=1.0:max=4",
                         retry_max_attempts=4, retry_backoff_ms=0.5,
                         **base)))
        sessions.append(dsess)
        A = dsess.from_numpy(
            rng.standard_normal((32, 48)).astype(np.float32))
        B = dsess.from_numpy(
            rng.standard_normal((48, 16)).astype(np.float32))
        dsess.run(A.expr().multiply(B.expr()))
        degrade_paths = _paths(dsess)
        degrade_rungs = sorted({r.rung for r in dsess._prov.records()})

        # 5. full audit replay over every ledger + MV115 dynamic check
        audits = {name: provenance_lib.audit(s, sample=0)
                  for name, s in (("serve", sess), ("fleet", fsess),
                                  ("degrade", dsess))}
        mv115 = sum(len(provenance_pass.verify_ledger(s))
                    for s in (sess, fsess, dsess))
    finally:
        for s in sessions:
            s.serve_close(timeout=60)

    covered = set(serve_paths) | set(fleet_paths) | set(degrade_paths)
    need = {"execute", "rc_hit", "rc_interior", "ivm_patched",
            "fleet_directory", "fleet_replica", "degraded"}
    record = {
        "metric": "provenance_drill",
        "device": str(mesh.device),
        "serve_paths": serve_paths,
        "fleet_paths": fleet_paths,
        "degrade_paths": degrade_paths,
        "degrade_rungs": degrade_rungs,
        "missing_paths": sorted(need - covered),
        "mv115_findings": mv115,
        "audit": {name: {k: v[k] for k in
                         ("sampled", "replayable", "failed", "ok")}
                  for name, v in audits.items()},
    }
    record["ok"] = bool(
        not record["missing_paths"]
        and 4 in degrade_rungs
        and mv115 == 0
        and all(v["ok"] for v in audits.values()))
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.provenance_drill",
        description="answer-provenance drill of the PyTorch port")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    record = drill(args.device)
    print(json.dumps(record))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
