"""Dimension + sparsity statistics propagation — the counterpart of
``matrel_tpu/ir/stats.py`` (the structure classifiers and SpGEMM
estimates of the S×S path are not ported yet).

Pure-Python estimates over the MatExpr tree, no devices involved:
  density(A·B)   ≈ 1 - (1 - dA*dB)^k   (k = contraction dim)
  density(A+B)   ≈ min(1, dA + dB)
  density(A⊙B)  ≈ dA * dB
"""

from __future__ import annotations

import math
from typing import Optional, Tuple


def density_of(nnz: Optional[int], shape: Tuple[int, int]) -> float:
    if nnz is None:
        return 1.0
    n = shape[0] * shape[1]
    return min(1.0, nnz / n) if n else 0.0


def nnz_from_density(d: float, shape: Tuple[int, int]) -> int:
    return int(round(min(1.0, max(0.0, d)) * shape[0] * shape[1]))


def matmul_density(da: float, db: float, k: int) -> float:
    """Probability an output entry is nonzero given k independent trials."""
    p = da * db
    if p <= 0.0:
        return 0.0
    if p >= 1.0:
        return 1.0
    return -math.expm1(k * math.log1p(-p))


def add_density(da: float, db: float) -> float:
    return min(1.0, da + db)


def elemmul_density(da: float, db: float) -> float:
    return da * db


def matmul_cost(n: int, k: int, m: int, da: float = 1.0,
                db: float = 1.0) -> float:
    """Estimated FLOP cost of an (n×k)·(k×m) multiply, sparsity-aware."""
    return 2.0 * n * k * m * da * db


#: HBM bytes → f32-FLOP-equivalents for the precision-tier cost model.
#: The planner's ranking constant, kept equal to the JAX package's so
#: the two planners stamp the same tiers (it was derived for the TPU;
#: it is a modelling ratio, not a measurement of this card).
HBM_FLOPS_PER_BYTE = 120.0

#: Interconnect bytes → FLOP-equivalents in the chain DP's step cost —
#: the same ranking constant as the JAX package (see HBM_FLOPS_PER_BYTE).
COMM_FLOPS_PER_BYTE = 1000.0


def integral_abs_bound(node, memo: dict = None):
    """Conservative upper bound on max|entry| of a provably-integral
    expression, or None when no bound can be proven (the int-tier
    overflow proof; see the JAX package's docstring)."""
    if memo is None:
        memo = {}

    def walk(n):
        key = ("bound", n.uid)
        if key in memo:
            return memo[key]
        memo[key] = got = _bound(n)
        return got

    def _mix(vals, fn):
        if any(v is None for v in vals):
            return None
        return float(fn(vals))

    def _bound(n):
        k = n.kind
        if k in ("leaf", "sparse_leaf", "coo_leaf"):
            v = getattr(n.attrs.get("matrix"), "int_abs_max", None)
            return float(v) if v is not None else None
        if k in ("transpose", "select_index", "select_block", "vec"):
            return walk(n.children[0])
        if k == "select_value":
            return _mix([walk(n.children[0]),
                         abs(float(n.attrs.get("fill", 0.0)))], max)
        if k == "matmul":
            ba, bb = walk(n.children[0]), walk(n.children[1])
            if ba is None or bb is None:
                return None
            return float(n.children[0].shape[1]) * ba * bb
        if k == "elemwise":
            op = n.attrs.get("op")
            vals = [walk(c) for c in n.children]
            if op in ("add", "sub"):
                return _mix(vals, sum)
            if op == "mul":
                return _mix(vals, lambda v: v[0] * v[1])
            if op in ("min", "max"):
                return _mix(vals, max)
            return None
        if k == "scalar":
            op, v = n.attrs["op"], abs(float(n.attrs["value"]))
            b = walk(n.children[0])
            if b is None:
                return None
            if op == "add":
                return b + v
            if op == "mul":
                return b * v
            if op == "pow" and v >= 1:
                return b ** v
            return None
        if k == "agg":
            kind, axis = n.attrs["agg"], n.attrs["axis"]
            c = n.children[0]
            b = walk(c)
            if kind == "count":
                return float(max(c.shape[0] * c.shape[1], 1))
            if b is None:
                return None
            if kind in ("max", "min"):
                return b
            if kind == "sum":
                terms = {"row": c.shape[1], "col": c.shape[0],
                         "all": c.shape[0] * c.shape[1],
                         "diag": min(c.shape)}[axis]
                return float(terms) * b
            return None
        if k == "rank1":
            ba, bu, bv = (walk(c) for c in n.children)
            if None in (ba, bu, bv):
                return None
            return ba + bu * bv
        return None

    return walk(node)


def infer_integral(node, memo: dict = None) -> bool:
    """Is this expression provably INTEGER-VALUED? Conservative: False
    whenever exactness cannot be proven (see the JAX package)."""
    if memo is None:
        memo = {}

    def walk(n) -> bool:
        key = ("int", n.uid)
        got = memo.get(key)
        if got is None:
            memo[key] = got = _integral(n)
        return got

    def _integral(n) -> bool:
        k = n.kind
        if k in ("leaf", "sparse_leaf", "coo_leaf"):
            return bool(getattr(n.attrs.get("matrix"), "integral", False))
        if k in ("transpose", "select_index", "select_block", "vec"):
            return walk(n.children[0])
        if k == "select_value":
            fill = float(n.attrs.get("fill", 0.0))
            return fill.is_integer() and walk(n.children[0])
        if k == "matmul":
            if n.attrs.get("precision_tier") in ("bf16x1", "bf16x3"):
                return False
            return all(walk(c) for c in n.children)
        if k == "elemwise":
            if n.attrs.get("op") == "div":
                return False
            return all(walk(c) for c in n.children)
        if k == "scalar":
            op, v = n.attrs["op"], float(n.attrs["value"])
            if op in ("add", "mul"):
                return v.is_integer() and walk(n.children[0])
            if op == "pow":
                return v.is_integer() and v >= 1 and walk(n.children[0])
            return False
        if k == "agg":
            kind = n.attrs["agg"]
            if kind == "count":
                return True
            if kind in ("sum", "max", "min"):
                return walk(n.children[0])
            return False
        if k == "rank1":
            return all(walk(c) for c in n.children)
        return False

    return walk(node)


def comm_proxy_layout(n: int, k: int, m: int, da: float, db: float,
                      gx: int, gy: int, itemsize: int = 4,
                      la: str = "2d", lb: str = "2d",
                      weights: tuple = (1.0, 1.0)) -> tuple:
    """(cheapest per-device interconnect cost, output layout of the
    argmin strategy) for an (n×k)·(k×m) multiply on a gx×gy grid — the
    chain DP's comm term. Tie-break order (bmm_right, bmm_left, cpmm,
    rmm) is the JAX package's."""
    p = gx * gy
    if p <= 1:
        return 0.0, "2d"
    from matrel_tpu_torch.parallel import planner   # lazy: no import cycle
    best, lay = None, "2d"
    for strat, out_lay in (("bmm_right", "row"), ("bmm_left", "col"),
                           ("cpmm", "2d"), ("rmm", "2d")):
        c = planner.comm_cost(strat, n, k, m, da, db, gx, gy,
                              itemsize, la, lb, weights=weights)
        if best is None or c < best:
            best, lay = c, out_lay
    return best, lay


def comm_proxy(n: int, k: int, m: int, da: float, db: float,
               gx: int, gy: int, itemsize: int = 4) -> float:
    return comm_proxy_layout(n, k, m, da, db, gx, gy, itemsize)[0]


def chain_step_cost(n: int, k: int, m: int, da: float, db: float,
                    gx: int = 1, gy: int = 1) -> float:
    """DP step cost: sparsity-aware FLOPs + the collective bill in
    FLOP-equivalents (exactly matmul_cost on a 1x1 grid)."""
    return (matmul_cost(n, k, m, da, db)
            + COMM_FLOPS_PER_BYTE * comm_proxy(n, k, m, da, db, gx, gy))


def chain_step_cost_layout(n: int, k: int, m: int, da: float, db: float,
                           gx: int, gy: int, la: str, lb: str,
                           weights: tuple = (1.0, 1.0),
                           flop_scale: float = 1.0) -> tuple:
    """(step cost, output layout): per-layout, topology-weighted comm
    terms; ``flop_scale`` is the precision tier's relative compute time
    per MAC (planner.sla_compute_factor)."""
    comm, lay = comm_proxy_layout(n, k, m, da, db, gx, gy, la=la, lb=lb,
                                  weights=weights)
    return (matmul_cost(n, k, m, da, db) * flop_scale
            + COMM_FLOPS_PER_BYTE * comm), lay


def matmul_out_nnz(n: int, k: int, m: int, nnz_a: Optional[int],
                   nnz_b: Optional[int]) -> Optional[int]:
    if nnz_a is None and nnz_b is None:
        return None
    da = density_of(nnz_a, (n, k))
    db = density_of(nnz_b, (k, m))
    return nnz_from_density(matmul_density(da, db, k), (n, m))
