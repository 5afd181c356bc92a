"""Plan-snapshot corpus — the port of the JAX package's
``tools/plan_snapshot.py`` (the Catalyst ``comparePlans`` idiom at corpus
scale).

A fixed corpus of ten representative expressions is built natively in the
port (the same ``default_rng(1234)`` draws in the same order, the same
shapes and specs), planned on the virtual (2, 4) grid, and each OPTIMIZED
plan's signature — node kinds, chosen strategies with provenance, join
schemes, inferred layouts — is diffed against the committed
``tests/plan_snapshots.json``, which this tool only reads. A planner
change in the port that moves a plan shows here as ``PLAN CHANGED``.

    python -m matrel_tpu_torch.tools.plan_snapshot [--device cpu]
    python -m matrel_tpu_torch.tools.plan_snapshot --update --out PATH

``--update`` writes the port's signatures to ``--out`` (required; the
committed snapshot is never written). The corpus's leaves live on
``--device`` (the card by default; raises without one).

Exit codes: 0 = every plan matches; 1 = a plan changed or the snapshot is
unreadable.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SNAPSHOT_PATH = os.path.join(REPO, "tests", "plan_snapshots.json")
#: The grid the corpus plans on: the JAX tool's (2, 4) test mesh, here the
#: virtual grid the port's planner prices on one device.
GRID = (2, 4)


def corpus(mesh):
    """(name, optimized-ready MatExpr) pairs. Deterministic: fixed seeds,
    fixed shapes; planning has no randomness."""
    import numpy as np

    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.coo import COOMatrix
    from matrel_tpu_torch.core.mesh import P
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.relational import ops as R

    rng = np.random.default_rng(1234)
    axes = tuple(mesh.axis_names)

    def bm(n, m, spec=None):
        return BlockMatrix.from_numpy(
            rng.standard_normal((n, m)).astype(np.float32), mesh=mesh,
            spec=spec)

    X = bm(4096, 256)
    y = bm(4096, 1)
    entries = []
    # 1. normal-equations linreg: the reference's headline pipeline
    entries.append(("linreg_normal_equations",
                    X.expr().t().multiply(X.expr()).solve(
                        X.expr().t().multiply(y.expr()))))
    # 2. skewed chain: the flagship chain-DP reorder
    A = bm(2048, 64)
    B = bm(64, 2048)
    C = bm(2048, 64)
    entries.append(("chain_skewed", A.expr().multiply(B.expr())
                    .multiply(C.expr())))
    # 3. FLOP-tied chain with a col-sharded middle operand: the
    #    layout-aware association flip
    entries.append(("chain_layout_flip",
                    bm(16, 512).expr()
                    .multiply(bm(512, 512, spec=P(None, axes)).expr())
                    .multiply(bm(512, 16).expr())))
    # 4. row-sharded leaf through a chain: interior bmm credit
    entries.append(("chain_interior_credit",
                    bm(1600, 512, spec=P(axes, None)).expr()
                    .multiply(bm(512, 512).expr())
                    .multiply(bm(512, 512).expr())))
    # 5. join feeding a matmul: align + consumer tiebreak
    entries.append(("join_under_matmul",
                    R.join_on_rows(bm(64, 4, spec=P(None, None)),
                                   bm(64, 3, spec=P(None, None)),
                                   "mul")
                    .multiply(bm(12, 8).expr())))
    # 6. replicated big operand: the symmetric rmm credit
    entries.append(("replicated_operand_matmul",
                    bm(512, 512, spec=P(None, None)).expr()
                    .multiply(bm(512, 128).expr())))
    # 7. COO SpMV dispatch (pagerank-shaped matvec chain step)
    adj = COOMatrix.from_edges(rng.integers(0, 2048, 8192),
                               rng.integers(0, 2048, 8192),
                               shape=(2048, 2048))
    entries.append(("coo_spmv_matvec", adj.multiply(bm(2048, 1).expr())))
    # 8. block-sparse x dense
    dense_for_tiles = rng.standard_normal((256, 256)).astype(np.float32)
    dense_for_tiles *= rng.random((256, 256)) < 0.3
    S = BlockSparseMatrix.from_numpy(dense_for_tiles, block_size=64,
                                     mesh=mesh)
    entries.append(("block_sparse_matmul",
                    S.multiply(bm(256, 128))))
    # 9. gram through transpose sharing (symmetric lowering candidate)
    G = bm(1024, 256)
    entries.append(("gram_AtA", G.expr().t().multiply(G.expr())))
    # 10. rank-1 update pushed through a multiply (R8)
    entries.append(("rank1_pushdown",
                    G.expr().rank_one_update(bm(1024, 1).expr(),
                                             bm(256, 1).expr())
                    .multiply(bm(256, 64).expr())))
    return entries


def signature(e, mesh, _lmemo=None):
    """Deterministic nested plan signature: kinds, strategy choices with
    provenance, join schemes, inferred layouts."""
    from matrel_tpu_torch.parallel import planner

    if _lmemo is None:
        _lmemo = {}
    sig = {"kind": e.kind, "shape": list(e.shape)}
    if "strategy" in e.attrs:
        sig["strategy"] = e.attrs["strategy"]
        sig["source"] = e.attrs.get("strategy_source")
    if "replicate" in e.attrs:
        sig["scheme"] = e.attrs["replicate"]
    lay = planner.infer_layout(e, mesh, _lmemo)
    if lay != "2d":
        sig["layout"] = lay
    if e.children:
        sig["children"] = [signature(c, mesh, _lmemo)
                           for c in e.children]
    return sig


def build_snapshots(device="cuda"):
    """{name: signature} of the corpus planned on the virtual (2, 4)
    grid, its leaves on ``device``."""
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.ir import rules
    from matrel_tpu_torch.parallel import planner

    mesh = mesh_lib.make_mesh(GRID, device=device)
    grid = mesh_lib.mesh_grid_shape(mesh)
    snaps = {}
    for name, e in corpus(mesh):
        opt = planner.annotate_strategies(
            rules.optimize(e, grid=grid, mesh=mesh), mesh)
        snaps[name] = signature(opt, mesh)
    return snaps


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.plan_snapshot",
        description="diff the port's corpus plans against "
                    "tests/plan_snapshots.json")
    p.add_argument("--update", action="store_true",
                   help="write the port's signatures to --out")
    p.add_argument("--out", default=None,
                   help="where --update writes (required with --update)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    if args.update and (args.out is None or os.path.abspath(args.out)
                        == os.path.abspath(SNAPSHOT_PATH)):
        p.error("--update writes only to an --out path other than "
                "tests/plan_snapshots.json")
    snaps = build_snapshots(args.device)
    if args.update:
        with open(args.out, "w") as f:
            json.dump(snaps, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"wrote {len(snaps)} plan snapshots to {args.out}")
        return 0
    try:
        with open(SNAPSHOT_PATH) as f:
            want = json.load(f)
    except (OSError, json.JSONDecodeError) as ex:
        print(f"snapshot unreadable ({ex!r})")
        return 1
    bad = sorted(set(n for n in snaps if snaps[n] != want.get(n))
                 | set(n for n in want if n not in snaps))
    for n in bad:
        print(f"PLAN CHANGED: {n}")
        print("  now:  ", json.dumps(snaps.get(n), sort_keys=True))
        print("  snap: ", json.dumps(want.get(n), sort_keys=True))
    matches = sum(1 for n in snaps if snaps[n] == want.get(n))
    print(f"{matches}/{len(snaps)} plans match")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
