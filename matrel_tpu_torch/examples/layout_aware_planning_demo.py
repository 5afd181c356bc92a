"""Layout-aware planning: the co-partitioning credit through plan
interiors; the port of the JAX package's
``examples/layout_aware_planning_demo.py``.

The reference's partitioner-aware planner skips shuffles for
co-partitioned inputs. ``infer_layout`` propagates each node's output
sharding bottom-up, so the credit fires on chain interiors and joins, and
the chain DP, strategy choice, join schemes and autotune gate all read
it. The JAX demo shows three effects on 8 CPU devices as (2, 4); the
port's planner prices the same virtual (2, 4) grid on one device (the
card unless asked for the CPU), so the stamps are the same and every
product still runs:

  1. a row-sharded input flips the strategy pick to broadcast-MM, and
     EXPLAIN prints the layouts next to the strategy provenance;
  2. a col-sharded MIDDLE operand flips a FLOP-tied chain's association
     — (A·B) consumes it in place;
  3. the same multiply picks a different strategy as an interior than
     as a plan root (roots pay a re-lay to the canonical sharding).

Run: python -m matrel_tpu_torch.examples.layout_aware_planning_demo [--device cpu]
"""

from __future__ import annotations

import sys

import numpy as np

from matrel_tpu_torch.examples import parse_args

#: The JAX demo's grid.
GRID = (2, 4)


def run(device=None, emit=print) -> dict:
    """The demo on ``device``; returns the stamps it prints."""
    from matrel_tpu_torch import executor
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.mesh import P
    from matrel_tpu_torch.ir.expr import leaf, matmul
    from matrel_tpu_torch.parallel import planner
    mesh = mesh_lib.make_mesh(GRID, device=device)
    emit(f"mesh: {dict(zip(mesh.axis_names, mesh.grid))} over {mesh.size} "
         f"grid cells (virtual, on {mesh.device})\n")
    rng = np.random.default_rng(0)
    out = {}

    # 1) leaf + INTERIOR layout credit, visible in EXPLAIN ------------
    x = rng.standard_normal((1600, 512)).astype(np.float32)
    b = rng.standard_normal((512, 512)).astype(np.float32)
    c = rng.standard_normal((512, 512)).astype(np.float32)
    X_row = BlockMatrix.from_numpy(x, mesh=mesh,
                                   spec=P(tuple(mesh.axis_names), None))
    e = (X_row.expr()
         .multiply(BlockMatrix.from_numpy(b, mesh=mesh).expr())
         .multiply(BlockMatrix.from_numpy(c, mesh=mesh).expr()))
    plan = executor.compile_expr(e, mesh)
    emit("row-sharded X through a chain — EXPLAIN shows layouts:")
    out["explain"] = plan.explain()
    emit(out["explain"])
    np.testing.assert_allclose(plan.run().to_numpy(), x @ b @ c,
                               rtol=2e-3, atol=2e-3)
    out["row_chain_stamps"] = [
        (d["strategy"], d["source"])
        for d in executor.plan_matmul_decisions(plan)]

    # 2) layout-aware chain DP: association flip ----------------------
    ca = rng.standard_normal((16, 512)).astype(np.float32)
    cb = rng.standard_normal((512, 512)).astype(np.float32)
    cc = rng.standard_normal((512, 16)).astype(np.float32)

    def assoc(spec):
        B = BlockMatrix.from_numpy(cb, mesh=mesh, spec=spec)
        pl = executor.compile_expr(
            BlockMatrix.from_numpy(ca, mesh=mesh).expr()
            .multiply(B.expr())
            .multiply(BlockMatrix.from_numpy(cc, mesh=mesh).expr()),
            mesh)
        left = pl.optimized.children[0].kind == "matmul"
        np.testing.assert_allclose(pl.run().to_numpy(), ca @ cb @ cc,
                                   rtol=2e-3, atol=2e-3)
        return "(A*B)*C" if left else "A*(B*C)"

    out["canonical"] = assoc(None)
    emit(f"FLOP-tied chain, canonical B:   {out['canonical']}")
    out["col_sharded"] = flipped = assoc(P(None, tuple(mesh.axis_names)))
    note = ("  <- (A*B) reads B in place"
            if flipped == "(A*B)*C" else
            "  (flip band is grid-specific; numerics verified)")
    emit(f"same chain, B col-sharded:      {flipped}{note}\n")

    # 3) root vs interior: the canonical-output re-lay charge ---------
    A_f = BlockMatrix.from_numpy(
        rng.standard_normal((1600, 512)).astype(np.float32), mesh=mesh)
    B_f = BlockMatrix.from_numpy(
        rng.standard_normal((512, 512)).astype(np.float32), mesh=mesh)
    node = matmul(leaf(A_f), leaf(B_f))
    out["interior"], _ = planner.choose_strategy_ex(node, mesh)
    out["root"], _ = planner.choose_strategy_ex(node, mesh,
                                                root_output=True)
    emit(f"(1600x512)@(512x512) as interior: {out['interior']}; as plan "
         f"root: {out['root']}")
    emit("(roots re-lay their output to the canonical sharding — a "
         "1D-emitting\n strategy pays that move, so the pick can "
         "legitimately differ)")
    return out


def main(argv=None) -> int:
    args = parse_args(argv, "layout_aware_planning_demo", __doc__)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
