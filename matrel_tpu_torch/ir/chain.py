"""Matrix-chain multiplication reordering — the counterpart of
``matrel_tpu/ir/chain.py``.

Collect maximal chains of matmul nodes A·B·C·…, run the O(n³) interval
DP with a dimension-, sparsity- and layout-aware cost model, and
re-parenthesise the tree to the minimum-cost order. Chains of three or
more operands run the O(n³) loop in the native optimizer core
(``native/chain_dp.cc`` through ``utils/native.py``, the same cost
semantics); the pure-Python DP below is the reference implementation,
used where the library is unavailable or the request prices what the
native mirror does not know (a precision tier's FLOP scale).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from matrel_tpu_torch.ir import stats
from matrel_tpu_torch.ir.expr import MatExpr, matmul


def collect_chain(e: MatExpr) -> List[MatExpr]:
    """Flatten a maximal matmul tree into its ordered operand list."""
    if e.kind != "matmul":
        return [e]
    return collect_chain(e.children[0]) + collect_chain(e.children[1])


def _operand_layouts(operands: List[MatExpr], mesh,
                     config=None) -> List[str]:
    """Layout of each chain operand on the mesh (planner.infer_layout),
    or all-"2d" when no mesh is given (the layout-blind DP)."""
    if mesh is None:
        return ["2d"] * len(operands)
    from matrel_tpu_torch.parallel import planner   # lazy: no import cycle
    memo: dict = {}
    return [planner.infer_layout(op, mesh, memo, config)
            for op in operands]


def optimal_order(operands: List[MatExpr],
                  grid: Tuple[int, int] = (1, 1),
                  mesh=None, config=None) -> Tuple[MatExpr, float]:
    """Interval DP over the operand list; returns (rebuilt expr, est. cost).

    cost[i][j] = min over split s of cost[i][s] + cost[s+1][j]
                 + stepCost(dims, densities, layouts, grid)
    """
    n = len(operands)
    gx, gy = grid
    if n == 1:
        return operands[0], 0.0
    lays = _operand_layouts(operands, mesh if gx * gy > 1 else None,
                            config)
    weights = (1.0, 1.0)
    if mesh is not None and gx * gy > 1:
        from matrel_tpu_torch.core import mesh as mesh_lib
        weights = mesh_lib.axis_weights(mesh, config)
    from matrel_tpu_torch.parallel import planner as _planner
    flop_scale = _planner.sla_compute_factor(config)
    # the native mirror predates precision tiers, staged-reshard
    # pricing and learned comm weights: scaled, budgeted or
    # coefficient-priced requests run the Python DP, the reference
    # implementation, never dishonest pricing
    reshard_budget = getattr(config, "reshard_peak_budget_bytes", 0) \
        if config is not None else 0
    # learned comm weights (parallel/coeffs.py): under
    # coeff_planner_enable each step's byte bill converts to
    # FLOP-equivalents at the MEASURED ratio of its shape class on the
    # plan's backend; cold classes keep the analytic constant
    coeff_cw = None
    shape_cls = None
    if (config is not None
            and getattr(config, "coeff_planner_enable", False)
            and gx * gy > 1):
        from matrel_tpu_torch.obs import drift as drift_lib
        from matrel_tpu_torch.parallel import coeffs as coeffs_lib
        backend = mesh.device.type if mesh is not None else "cpu"
        coeff_cw = coeffs_lib.chain_comm_weights(
            drift_lib.table_path(config), backend,
            min_samples=getattr(config, "coeff_min_samples", 1)) or None
        if coeff_cw is not None:
            shape_cls = drift_lib.shape_class
    if (n >= 3 and flop_scale == 1.0 and reshard_budget == 0
            and coeff_cw is None):
        from matrel_tpu_torch.utils import native
        dims = [op.shape[0] for op in operands] + [operands[-1].shape[1]]
        res = native.chain_dp(dims, [op.density for op in operands],
                              grid=grid,
                              layouts=[stats.LAYOUT_CODES[l] for l in lays],
                              weights=weights)
        if res is not None:
            splits, cost = res

            def build(i: int, j: int) -> MatExpr:
                if i == j:
                    return operands[i]
                s = int(splits[i][j])
                return matmul(build(i, s), build(s + 1, j))

            return build(0, n - 1), cost
    # best[i][j] = (cost, expr, layout) for operands[i..j] inclusive
    best: List[List[Optional[Tuple[float, MatExpr, str]]]] = [
        [None] * n for _ in range(n)
    ]
    for i in range(n):
        best[i][i] = (0.0, operands[i], lays[i])
    for span in range(2, n + 1):
        for i in range(0, n - span + 1):
            j = i + span - 1
            cand: Optional[Tuple[float, MatExpr, str]] = None
            for s in range(i, j):
                cl, el, ll = best[i][s]
                cr, er, lr = best[s + 1][j]
                cw = (coeff_cw.get(shape_cls(
                    (el.shape[0], el.shape[1], er.shape[1])))
                    if coeff_cw is not None else None)
                step, lay = stats.chain_step_cost_layout(
                    el.shape[0], el.shape[1], er.shape[1],
                    el.density, er.density, gx, gy, ll, lr,
                    weights=weights, flop_scale=flop_scale,
                    comm_weight=cw)
                total = cl + cr + step
                if cand is None or total < cand[0]:
                    cand = (total, matmul(el, er), lay)
            best[i][j] = cand
    cost, e, _ = best[0][n - 1]
    return e, cost


def reorder_chains(e: MatExpr, grid: Tuple[int, int] = (1, 1),
                   mesh=None, config=None) -> MatExpr:
    """Recursively find maximal matmul chains and DP-reorder each."""
    if e.kind == "matmul":
        ops = collect_chain(e)
        ops = [reorder_chains(o, grid, mesh, config)
               if o.kind != "leaf" else o for o in ops]
        if len(ops) > 2:
            new, _ = optimal_order(ops, grid, mesh, config)
            return new
        if len(ops) == 2:
            return matmul(ops[0], ops[1])
        return ops[0]
    if not e.children:
        return e
    new_children = tuple(reorder_chains(c, grid, mesh, config)
                         for c in e.children)
    if all(nc is oc for nc, oc in zip(new_children, e.children)):
        return e
    return e.with_children(new_children)


def chain_cost(e: MatExpr, grid: Tuple[int, int] = (1, 1)) -> float:
    """Total estimated matmul cost of a (sub)tree, for plan assertions."""
    total = 0.0
    if e.kind == "matmul":
        l, r = e.children
        total += stats.chain_step_cost(
            l.shape[0], l.shape[1], r.shape[1], l.density, r.density,
            grid[0], grid[1])
    for c in e.children:
        total += chain_cost(c, grid)
    return total
