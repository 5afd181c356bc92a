"""Normal-equations linear regression end to end — session, DSL,
optimizer and execution; the port of the JAX package's
``examples/linreg_demo.py``.

Xᵀ·X and Xᵀ·y run as cuBLAS f32 GEMMs with TF32 off (what the JAX
package leaves to XLA), then one Cholesky solve.

Run: python -m matrel_tpu_torch.examples.linreg_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from matrel_tpu_torch.examples import parse_args

#: The JAX demo's problem: rows, features (seed 0).
N_ROWS, N_FEATURES = 100_000, 64


def run(device=None, emit=print, n: int = N_ROWS,
        k: int = N_FEATURES) -> dict:
    """The demo on ``device``; returns the numbers it prints."""
    from matrel_tpu_torch import MatrelSession, executor
    from matrel_tpu_torch.workloads import linreg
    sess = MatrelSession(device=device)
    mesh = dict(zip(sess.mesh.axis_names, sess.mesh.grid))
    emit(f"mesh: {mesh}")

    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, k)).astype(np.float32)
    theta_true = rng.standard_normal((k, 1)).astype(np.float32)
    y = x @ theta_true + 0.01 * rng.standard_normal((n, 1)).astype(
        np.float32)

    X, Y = sess.from_numpy(x), sess.from_numpy(y)

    # the optimizer at work on the full expression
    expr = X.t().multiply(X)
    explain = expr.explain()
    emit(explain)
    plan = sess.compile(expr)
    # the plan's matmul stamps and its collectives (none on one card;
    # the JAX demo reads XLA's collective counts of its compiled program)
    decisions = executor.plan_matmul_decisions(plan)
    stamps = [f"{d['strategy']}[{d['source']}]" for d in decisions]
    collectives = {d["strategy"]: d["est_ici_bytes"] for d in decisions
                   if d["est_ici_bytes"]}
    emit(f"strategies/collectives: {stamps} {collectives}")

    theta = linreg.fit(X, Y).cpu().numpy()
    err = float(np.linalg.norm(theta - theta_true)
                / np.linalg.norm(theta_true))
    emit(f"relative parameter error: {err:.2e}")
    return {"mesh": mesh, "explain": explain,
            "strategies": stamps, "theta": theta, "theta_true": theta_true,
            "rel_err": err}


def main(argv=None) -> int:
    args = parse_args(argv, "linreg_demo", __doc__)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
