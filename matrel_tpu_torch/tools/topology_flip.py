"""Weighted-mesh strategy-flip check — the port of the JAX package's
``tools/topology_flip.py``.

Prices the virtual (2, 4) grid with the y axis 8× dearer (the cross-slice
axis of a two-slice fabric) and proves, through the port's planner entry
points, that:

  1. the β-only ranking picks the slow-axis collective (rmm's A
     all-gather rides y) and the topology-weighted ranking flips to the
     fast-axis-friendly bmm_right;
  2. MV106 flags a hand-stamped slow-axis plan under the weighted config,
     and stays quiet on the planner's own output;
  3. a weighted config executes a real multiply to oracle numerics
     (weights re-route choices, never change results) — on the card
     unless ``--device cpu`` is given.

Prints one JSON line (``topology_strategy_flip``); exit code 0 when it
holds.

    python -m matrel_tpu_torch.tools.topology_flip [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

#: The flip shape: on the (2, 4) grid with 3a/8 < b_bytes < 3a/4, the
#: flat model's argmin (rmm) carries ~6× more y-axis bytes than the
#: broadcast alternative, so weighting y flips the pick.
N, K, M = 8192, 2048, 4096
AXIS_WEIGHTS = (1.0, 8.0)


def flip(device="cuda") -> dict:
    """Run the three checks on ``device`` and return the record."""
    import dataclasses
    from matrel_tpu_torch import analysis
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.mesh import P
    from matrel_tpu_torch.executor import execute
    from matrel_tpu_torch.ir.expr import leaf, matmul
    from matrel_tpu_torch.parallel import planner

    mesh = mesh_lib.make_mesh((2, 4), device=device)
    base = BlockMatrix.from_numpy(np.zeros((8, 8), np.float32),
                                  mesh=mesh)

    def fab(n, m, spec=None):
        src = base if spec is None else BlockMatrix.from_numpy(
            np.zeros((8, 8), np.float32), mesh=mesh, spec=spec)
        return leaf(dataclasses.replace(src, shape=(n, m)))

    cfg_flat = MatrelConfig()
    cfg_w = MatrelConfig(axis_cost_weights=AXIS_WEIGHTS)
    node = matmul(fab(N, K), fab(K, M))
    flat_pick, _ = planner.choose_strategy_ex(node, mesh, cfg_flat)
    w_pick, _ = planner.choose_strategy_ex(node, mesh, cfg_w)
    flat_axes = planner.comm_cost_axes(flat_pick, N, K, M, 1.0, 1.0,
                                       2, 4, weights=AXIS_WEIGHTS)
    flipped = (flat_pick == "rmm" and w_pick == "bmm_right"
               and flat_axes[1] > flat_axes[0])

    # MV106: hand-stamp the slow-axis pick (replicated B makes the
    # broadcast free — the grossest version of the smell) on a
    # NON-root-exposed node; the planner's own annotation stays clean
    stamped = matmul(
        matmul(fab(N, K), fab(K, M, spec=P(None, None)))
        .with_attrs(strategy="rmm", strategy_source="override"),
        fab(M, 64))
    diags = analysis.verify_plan(
        planner.annotate_strategies(stamped, mesh, cfg_w), mesh, cfg_w)
    mv106 = [d for d in diags if d.code == "MV106"]
    clean = analysis.verify_plan(
        planner.annotate_strategies(matmul(fab(N, K), fab(K, M)), mesh,
                                    cfg_w), mesh, cfg_w)

    # weighted config executes to oracle numerics (tiny real multiply)
    rng = np.random.default_rng(0)
    xa = rng.standard_normal((64, 32)).astype(np.float32)
    xb = rng.standard_normal((32, 48)).astype(np.float32)
    got = execute(
        BlockMatrix.from_numpy(xa, mesh=mesh).expr().multiply(
            BlockMatrix.from_numpy(xb, mesh=mesh).expr()),
        mesh, cfg_w).to_numpy()
    numerics_ok = bool(np.allclose(got, xa @ xb, rtol=1e-4, atol=1e-4))

    ok = bool(flipped and mv106 and not clean and numerics_ok)
    return {
        "metric": "topology_strategy_flip",
        "grid": [2, 4],
        "axis_weights": list(AXIS_WEIGHTS),
        "dims": [N, K, M],
        "unweighted": flat_pick,
        "weighted": w_pick,
        "slow_axis_bytes": flat_axes[1],
        "fast_axis_bytes": flat_axes[0],
        "mv106_flagged": bool(mv106),
        "clean_plan_quiet": not clean,
        "numerics_ok": numerics_ok,
        "ok": ok,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.topology_flip",
        description="topology-weighted strategy flip of the port's "
                    "planner")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    args = p.parse_args(argv)
    record = flip(args.device)
    print(json.dumps(record))
    return 0 if record["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
