"""Matrix-analytics queries: triangle counting and all-pairs cosine
similarity with a thresholded similarity join; the port of the JAX
package's ``examples/analytics_demo.py``.

- trace(A·A·A)/6 through the chain / aggregate optimizer (also reachable
  as SQL: ``trace(A * A * A)``),
- cosine similarity whose X·Xᵀ core takes the symmetric 2-pass bf16 Gram
  lowering under ``matmul_precision="high"`` (the bf16 passes on the
  card's tensor cores),
- a σ-thresholded "similar pairs" count on the result.

Run: python -m matrel_tpu_torch.examples.analytics_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from matrel_tpu_torch.examples import parse_args

#: The JAX demo's sizes: a 256-node graph at p = 0.05, 512 vectors of 64
#: features, threshold 0.8 (seed 0).
TRI_N, TRI_P, SIM_SHAPE, SIM_THRESHOLD = 256, 0.05, (512, 64), 0.8


def run(device=None, emit=print) -> dict:
    """The demo on ``device``; returns the numbers it prints."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.relational import ops as R
    from matrel_tpu_torch.workloads import similarity, triangles
    rng = np.random.default_rng(0)
    sess = MatrelSession(config=MatrelConfig(matmul_precision="high"),
                         device=device)

    # -- triangles ----------------------------------------------------------
    a = (rng.random((TRI_N, TRI_N)) < TRI_P).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    A = sess.from_numpy(a)
    tri = triangles.triangle_count(A, session=sess)
    tri_oracle = triangles.triangles_numpy_oracle(a)
    emit(f"triangles: {tri:.0f} (oracle {tri_oracle:.0f})")

    sess.register("A", A)
    tri_sql = sess.compute(sess.sql("trace(A * A * A)")).to_numpy()[0, 0] / 6
    emit(f"triangles via SQL: {tri_sql:.0f}")

    # -- cosine similarity + thresholded join -------------------------------
    x = rng.standard_normal(SIM_SHAPE).astype(np.float32)
    X = sess.from_numpy(x)
    S = similarity.cosine_similarity_expr(X)
    # similar pairs: entries of S above the threshold, counted (the n
    # diagonal self-pairs cos(x_i, x_i) = 1 are included)
    sim_pairs = R.aggregate(
        R.select_entries(S, lambda v: v > SIM_THRESHOLD), "count", "all")
    cnt = float(sess.compute(sim_pairs).to_numpy()[0, 0])
    oracle = int(np.count_nonzero(
        similarity.cosine_similarity_numpy_oracle(x) > SIM_THRESHOLD))
    emit(f"pairs with cos > {SIM_THRESHOLD}: {cnt:.0f} "
         f"(oracle {oracle}, incl. {len(x)} diagonal)")
    return {"triangles": float(tri), "triangles_oracle": float(tri_oracle),
            "triangles_sql": float(tri_sql), "pairs": cnt,
            "pairs_oracle": oracle}


def main(argv=None) -> int:
    args = parse_args(argv, "analytics_demo", __doc__)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
