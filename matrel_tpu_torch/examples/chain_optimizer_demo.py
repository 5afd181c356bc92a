"""The heart of the reference: cost-based matrix-chain reordering; the
port of the JAX package's ``examples/chain_optimizer_demo.py``.

MatRel's flagship optimization is the linear-algebra analogue of
join-order enumeration — an interval DP over a multiply chain with
sparsity-aware cost estimates. The skewed chain here (4096×64 · 64×4096 ·
4096×64) costs 64× fewer FLOPs right-associated; the optimizer picks that
order and both plans are timed through ``CompiledPlan.bound_runner()``,
the iteration path, as the JAX demo's ``timed`` does. The JAX demo reads
FLOPs from XLA's ``cost_analysis()``; the port has no compiled program to
ask, so it prints the FLOPs of each plan's chosen order as the port's
planner counts them (``ir/stats.matmul_cost`` over the optimized tree),
the measured ms a run (CUDA events on the card, the host clock on the
CPU) and ``sess.explain(expr, analyze=True)``.

Run: python -m matrel_tpu_torch.examples.chain_optimizer_demo [--device cpu]
"""

from __future__ import annotations

import sys
import time

import numpy as np

from matrel_tpu_torch.examples import parse_args

#: A: 4096×64, B: 64×4096, C: 4096×64 (seed 0, scaled by 1/64).
DIMS = ((4096, 64), (64, 4096), (4096, 64))


def flops_of(dims):
    """(left, right): FLOPs of (A·B)·C and A·(B·C)."""
    (n, k), (_, m), (_, p) = dims
    left = 2 * n * k * m + 2 * n * m * p       # (A·B)·C
    right = 2 * k * m * p + 2 * n * k * p      # A·(B·C)
    return left, right


def ms_per_run(fn, device, runs: int = 20) -> float:
    """Milliseconds a call of ``fn`` (after one warm call): CUDA events
    around ``runs`` calls on the card, the host clock on the CPU."""
    import torch
    fn()
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(runs):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / runs
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    return (time.perf_counter() - t0) * 1e3 / runs


def plan_flops(plan) -> float:
    """FLOPs of a plan's matmuls in its chosen order, as the planner
    counts them (density-aware ``matmul_cost``)."""
    from matrel_tpu_torch.ir import stats

    def walk(e) -> float:
        own = 0.0
        if e.kind == "matmul":
            a, b = e.children
            own = stats.matmul_cost(a.shape[0], a.shape[1], b.shape[1],
                                    a.density, b.density)
        return own + sum(walk(c) for c in e.children)

    return walk(plan.optimized)


def run(device=None, emit=print, dims=DIMS, runs: int = 20) -> dict:
    """The demo on ``device``; returns the numbers it prints."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.executor import compile_expr
    sess = MatrelSession(device=device)
    emit(f"mesh: {dict(zip(sess.mesh.axis_names, sess.mesh.grid))}")

    rng = np.random.default_rng(0)
    A, B, C = (sess.from_numpy(
        rng.standard_normal(d).astype(np.float32) / 64) for d in dims)
    expr = A.expr().multiply(B.expr()).multiply(C.expr())

    left, right = flops_of(dims)
    emit(f"(A·B)·C costs {left / 1e6:.0f} MFLOPs; "
         f"A·(B·C) costs {right / 1e6:.0f} MFLOPs")

    emit("\n--- optimizer explain (analyze=True: measured per-op ms "
         "next to the planner's strategy + comm estimate) ---")
    explain = sess.explain(expr, analyze=True)
    emit(explain)

    opt = sess.compile(expr)
    raw = compile_expr(expr, sess.mesh,
                       MatrelConfig(chain_opt=False, rewrite_rules=False))
    out = {"left_flops": left, "right_flops": right, "explain": explain}
    for plan, label, key in ((raw, "left-assoc", "raw"),
                             (opt, "DP-reordered", "opt")):
        step = plan.bound_runner()
        ms = ms_per_run(step, sess.device, runs)
        check = float(step().sum())        # padding is zero
        flops = plan_flops(plan)
        emit(f"{label:>12}: {flops / 1e6:7.0f} MFLOPs planned, "
             f"{ms:7.3f} ms/exec  (checksum {check:+.4f})")
        out.update({f"{key}_flops": flops, f"{key}_ms": ms,
                    f"{key}_checksum": check})
    ratio = out["raw_flops"] / out["opt_flops"]
    emit(f"\nchain DP cut planned FLOPs {ratio:.0f}x "
         f"(wall-clock {out['raw_ms'] / out['opt_ms']:.1f}x here; small "
         f"plans are launch-bound — the FLOP ratio is what scales)")
    out["flop_ratio"] = ratio
    return out


def main(argv=None) -> int:
    args = parse_args(argv, "chain_optimizer_demo", __doc__)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
