"""Graph analytics on element-sparse matrices — COOMatrix + PageRank; the
port of the JAX package's ``examples/graph_demo.py``.

The edge list compiles once into an SpMV plan (``ops/spmv.py``); its CSR
view lives on the card, where ``matvec`` and every PageRank round are one
launch of the compact SpMV kernel B2 (``csrc/spmv_compact.cu``).
``rmatvec`` runs the transpose plan's expanded one-hot tables.

Run: python -m matrel_tpu_torch.examples.graph_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from matrel_tpu_torch.examples import parse_args

#: The JAX demo's graph: nodes, edges, PageRank rounds (seed 0).
N_NODES, N_EDGES, ROUNDS = 50_000, 400_000, 30


def run(device=None, emit=print, n: int = N_NODES,
        m: int = N_EDGES) -> dict:
    """The demo on ``device``; returns the numbers it prints."""
    from matrel_tpu_torch.core.coo import COOMatrix
    from matrel_tpu_torch.core.mesh import resolve_device
    from matrel_tpu_torch.workloads.pagerank import pagerank_edges
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, m)
    dst = rng.integers(0, n, m)

    # -- element-sparse linear algebra through COOMatrix ------------------
    A = COOMatrix.from_edges(src, dst, shape=(n, n))
    padding = A._get_plan().padding_ratio
    emit(f"adjacency: {A.shape}, nnz={A.nnz}, "
         f"plan padding ratio={padding:.2f}")
    ones = np.ones(n, np.float32)
    deg_out = A.matvec(ones, device=dev).cpu().numpy()      # out-degrees
    deg_in = A.rmatvec(ones, device=dev).cpu().numpy()      # in-degrees
    emit(f"mean degree: out={deg_out.mean():.2f} in={deg_in.mean():.2f}")

    # two-hop reachability mass from a seed set, Aᵀ·(Aᵀ·s)
    seed = np.zeros(n, np.float32)
    seed[:10] = 1.0
    two_hop = A.rmatvec(A.rmatvec(seed, device=dev),
                        device=dev).cpu().numpy()
    emit(f"two-hop mass from 10 seeds: {two_hop.sum():.0f} "
         f"(~{m / n:.0f}² × 10 expected)")

    # -- PageRank: 30 rounds, one B2 launch a round on the card -----------
    ranks = pagerank_edges(src, dst, n, rounds=ROUNDS,
                           device=dev).cpu().numpy()
    top = np.argsort(ranks)[::-1][:5]
    emit("top-5 nodes: " + ", ".join(f"{i} ({ranks[i]:.2e})" for i in top))
    emit(f"rank mass: {ranks.sum():.6f} (=1 up to fp)")
    return {"shape": A.shape, "nnz": A.nnz, "padding_ratio": padding,
            "deg_out": deg_out, "deg_in": deg_in, "two_hop": two_hop,
            "ranks": ranks, "top5": [int(i) for i in top],
            "rank_mass": float(ranks.sum())}


def main(argv=None) -> int:
    args = parse_args(argv, "graph_demo", __doc__)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
