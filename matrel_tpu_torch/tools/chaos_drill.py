"""Chaos drill: a mixed serve stream under a seeded fault schedule — the
port of the JAX package's ``tools/chaos_drill.py``.

Drives >= 50 queries — direct ``run``, micro-batched ``run_many``, async
``submit`` — through a session whose every instrumented choke point
(compile, lower, strategy, execute, rc_probe, serve_admit, checkpoint)
injects transient faults on a deterministic seeded schedule, plus a
poison query and an impossible deadline, and asserts
converge-to-correct-or-typed-failure:

  - every healthy query's result matches its numpy oracle (0 wrong
    answers: retries and the degradation ladder absorb every transient);
  - only the deterministic-fault queries fail, each typed (the mixed-mesh
    poison raises ValueError and fails exactly its own future — batch
    bisection; the impossible deadline raises DeadlineExceeded);
  - zero hangs: the stream drains under ``serve_drain(timeout=...)``;
  - every instrumented site was both checked and fired (the injector's
    own stats);
  - a checkpoint save / restore survives its injected IO faults and
    round-trips the catalog exactly.

Prints one JSON line; exit code 0 when it holds. Unlike the JAX drill,
which forces the CPU, this one runs on the card unless ``--device cpu``
is given: the recovery plumbing there wraps real kernel launches.
``MATREL_CHAOS_SEED`` varies the schedule; a fixed seed fails the same
queries the same way (how many calls a site sees moves with how the
serve worker batches the submissions, which the host's load moves).

    python -m matrel_tpu_torch.tools.chaos_drill [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

#: Transient faults at every instrumented site: one guaranteed nth-call
#: fire a site (coverage cannot depend on luck) plus capped random fires
#: (max= bounds the total, so the stream provably converges).
FAULT_SPEC = (
    "compile:transient:n=3;compile:transient:p=0.05:max=2;"
    "lower:transient:n=40;lower:transient:p=0.002:max=2;"
    "strategy:transient:n=5;strategy:transient:p=0.02:max=2;"
    "execute:transient:n=4;execute:transient:p=0.05:max=2;"
    "rc_probe:transient:n=6;rc_probe:transient:p=0.03:max=2;"
    "serve_admit:transient:n=2;serve_admit:transient:p=0.1:max=2;"
    "checkpoint:transient:n=1"
)


def drill(device="cuda") -> dict:
    """Run the drill on ``device`` and return its record (``ok`` says
    whether every assertion held)."""
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.obs.events import read_events, resolve_path
    from matrel_tpu_torch.obs.history import summarize
    from matrel_tpu_torch.resilience import errors as rerrors, faults
    from matrel_tpu_torch.session import MatrelSession
    from matrel_tpu_torch.utils.checkpoint import CheckpointManager

    seed = int(os.environ.get("MATREL_CHAOS_SEED", "0"))
    faults.reset()
    # MATREL_* overrides flow over the drill's base config
    cfg = MatrelConfig.from_env(MatrelConfig(
        fault_inject=FAULT_SPEC, fault_inject_seed=seed,
        retry_max_attempts=6, retry_backoff_ms=1.0, retry_jitter=0.5,
        obs_level="on", result_cache_max_bytes=1 << 26,
        serve_max_batch=5))
    mesh = mesh_lib.make_mesh((2, 4), device=device)
    sess = MatrelSession(mesh=mesh, config=cfg)
    rng = np.random.default_rng(seed)
    an, bn = (rng.standard_normal((48, 64)).astype(np.float32),
              rng.standard_normal((64, 24)).astype(np.float32))
    A, B = sess.from_numpy(an), sess.from_numpy(bn)
    other = mesh_lib.make_mesh((1, 1), device=mesh.device)
    M_other = BlockMatrix.from_numpy(bn, mesh=other)

    wrong = 0
    typed_failures, untyped_failures = [], []
    n_queries = 0

    def check(got, want, tag):
        nonlocal wrong
        if not np.allclose(got, want, rtol=3e-4, atol=3e-4):
            wrong += 1
            print(f"# WRONG ANSWER: {tag}", file=sys.stderr)

    def tally(tag, ex):
        (typed_failures if isinstance(ex, rerrors.ResilienceError)
         else untyped_failures).append((tag, type(ex).__name__))

    def expr_oracle(i):
        s = float(i % 7 + 1)
        if i % 3 == 0:
            return (A.expr().t().multiply(A.expr()).multiply_scalar(s),
                    (an.T @ an) * s)
        if i % 3 == 1:
            return (A.expr().multiply(B.expr()).multiply_scalar(s),
                    (an @ bn) * s)
        return (A.expr().multiply(B.expr()).add(
            A.expr().multiply(B.expr())), 2 * (an @ bn))

    try:
        # 1. direct session.run stream (20 queries)
        for i in range(20):
            e, want = expr_oracle(i)
            n_queries += 1
            try:
                check(sess.run(e).to_numpy(), want, f"run[{i}]")
            except Exception as ex:  # noqa: BLE001 — tallied
                tally(f"run[{i}]", ex)

        # 2. micro-batched run_many (4 batches x 4 = 16 queries)
        for b in range(4):
            batch, wants = zip(*(expr_oracle(b * 4 + j) for j in range(4)))
            n_queries += len(batch)
            try:
                outs = sess.run_many(list(batch))
                for j, (o, w) in enumerate(zip(outs, wants)):
                    check(o.to_numpy(), w, f"run_many[{b}][{j}]")
            except Exception as ex:  # noqa: BLE001 — tallied
                tally(f"run_many[{b}]", ex)

        # 3. async submit stream with one poison in a 5-query batch
        # (batch bisection: exactly the poison's future may fail, typed)
        futs, wants = [], []
        for i in range(4):
            e, want = expr_oracle(10 + i)
            futs.append(sess.submit(e))
            wants.append(want)
        poison_fut = sess.submit(A.expr().multiply(M_other.expr()))
        n_queries += 5
        for i in range(9):          # a second wave keeps the worker busy
            e, want = expr_oracle(20 + i)
            futs.append(sess.submit(e))
            wants.append(want)
            n_queries += 1
        try:
            sess.serve_drain(timeout=300.0)
        except rerrors.DrainTimeout as ex:
            print(f"# DRAIN TIMEOUT: {ex}", file=sys.stderr)
            untyped_failures.append(("serve_drain", "DrainTimeout"))
        sibling_failures = 0
        for i, (f, w) in enumerate(zip(futs, wants)):
            ex = f.exception(timeout=60)
            if ex is not None:
                sibling_failures += 1
                untyped_failures.append((f"submit[{i}]", type(ex).__name__))
            else:
                check(f.result().to_numpy(), w, f"submit[{i}]")
        poison_ex = poison_fut.exception(timeout=60)
        poison_isolated = (isinstance(poison_ex, ValueError)
                           and sibling_failures == 0)
        if poison_ex is not None:
            typed_failures.append(("poison", type(poison_ex).__name__))

        # 4. an impossible deadline fails typed
        n_queries += 1
        deadline_typed = False
        try:
            sess.run(expr_oracle(0)[0], deadline_ms=1e-6)
        except rerrors.DeadlineExceeded:
            deadline_typed = True
            typed_failures.append(("deadline", "DeadlineExceeded"))
        except Exception as ex:  # noqa: BLE001 — wrong type = drill failure
            untyped_failures.append(("deadline", type(ex).__name__))

        # 5. checkpoint round trip under injected IO faults
        ckpt_ok = False
        d = tempfile.mkdtemp(prefix="matrel_torch_chaos_ckpt_")
        try:
            sess.register("A", A)
            mgr = CheckpointManager(d, config=cfg)
            for attempt in range(6):
                try:
                    mgr.save(attempt, matrices={"A": A})
                    got = mgr.restore(mesh)
                    ckpt_ok = (got is not None and np.allclose(
                        got[1]["A"].to_numpy(), an, rtol=1e-6, atol=1e-6))
                    break
                except rerrors.InjectedFault:
                    continue        # the drill's own retry of the round trip
        finally:
            shutil.rmtree(d, ignore_errors=True)
    finally:
        sess.serve_close(timeout=60)

    stats = faults.injector_for(cfg).stats()
    sites_checked = sorted(s for s, v in stats.items() if v["calls"] > 0)
    sites_fired = sorted(s for s, v in stats.items() if v["fires"] > 0)
    log_path = resolve_path(cfg.obs_event_log
                            or os.environ.get("MATREL_OBS_EVENT_LOG"))
    rollup = summarize(read_events(log_path)).get("resilience", {})
    record = {
        "metric": "chaos_drill",
        "seed": seed,
        "device": str(mesh.device),
        "queries": n_queries,
        "wrong_answers": wrong,
        "typed_failures": len(typed_failures),
        "untyped_failures": len(untyped_failures),
        "failure_heads": (typed_failures + untyped_failures)[:8],
        "poison_isolated": poison_isolated,
        "deadline_typed": deadline_typed,
        "checkpoint_ok": ckpt_ok,
        "sites_checked": sites_checked,
        "sites_fired": sites_fired,
        "fault_stats": stats,
        "retries": rollup.get("retries", 0),
        "degrades": rollup.get("degrades", 0),
        "log": log_path,
    }
    record["ok"] = bool(
        n_queries >= 50
        and wrong == 0
        and not untyped_failures
        and poison_isolated
        and deadline_typed
        and ckpt_ok
        and set(sites_checked) == set(faults.SITES)
        and set(sites_fired) == set(faults.SITES)
        and record["retries"] > 0)
    faults.reset()
    return record


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.chaos_drill",
        description="the resilience acceptance drill of the PyTorch port")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    record = drill(args.device)
    print(json.dumps(record))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
