"""Cost-based physical planning — the counterpart of
``matrel_tpu/parallel/planner.py``, ported as far as
``annotate_strategies`` reaches under the slice's configuration:
``choose_strategy_ex``, ``comm_cost``, ``infer_layout``,
``infer_dtype`` and ``choose_precision_tier``.

The strategy choice per matmul is made before execution from shapes,
densities and operand layouts, with a communication-cost model over the
mesh's (virtual) grid, and stamped on the node (``attrs["strategy"]`` /
``attrs["strategy_source"]``). On one card the grid is 1x1 and every
matmul stamps ``("xla", "default")``; a virtual grid reproduces the JAX
package's stamps. The join-scheme choice, autotune and the learned
coefficients are not ported (their knobs raise ``NotPortedError``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.core import mesh as mesh_lib
from matrel_tpu_torch.core.mesh import Mesh
from matrel_tpu_torch.ir.expr import MatExpr


def _bytes(shape: Tuple[int, int], density: float, itemsize: int = 4) -> float:
    return shape[0] * shape[1] * itemsize * max(density, 0.0)


def _to_2d_reshard(bytes_: float, layout: str, gx: int, gy: int) -> float:
    """Per-device bytes to re-lay an operand into the canonical P(x, y)
    tiling (replicated: free; 1D-sharded: gather along the other axis)."""
    p = max(gx * gy, 1)
    if layout == "rep":
        return 0.0
    if layout == "row":
        return (bytes_ / p) * (1 - 1 / gy)
    if layout == "col":
        return (bytes_ / p) * (1 - 1 / gx)
    return 0.0


def _to_2d_axis(layout: str) -> str:
    return "y" if layout == "row" else "x"


def _split_full_mesh(src_bytes: float, gx: int, gy: int,
                     wx: float, wy: float) -> Tuple[float, float, float]:
    """(weighted cost, x_bytes, y_bytes) of a full-mesh replication of
    ``src_bytes`` from an even p-way shard, cheaper stage order first."""
    p = gx * gy
    bx_yfirst = src_bytes * (gx - 1) / gx
    by_yfirst = src_bytes * (gy - 1) / p
    if wx == wy:
        return src_bytes * (p - 1) / p * wx, bx_yfirst, by_yfirst
    bx_xfirst = src_bytes * (gx - 1) / p
    by_xfirst = src_bytes * (gy - 1) / gy
    cost_yf = wx * bx_yfirst + wy * by_yfirst
    cost_xf = wx * bx_xfirst + wy * by_xfirst
    if cost_yf <= cost_xf:
        return cost_yf, bx_yfirst, by_yfirst
    return cost_xf, bx_xfirst, by_xfirst


def _comm_detail(strategy: str, n: int, k: int, m: int,
                 da: float, db: float, gx: int, gy: int,
                 itemsize: int = 4,
                 a_layout: str = "2d", b_layout: str = "2d",
                 alpha_bytes: float = 0.0,
                 weights: Tuple[float, float] = (1.0, 1.0)
                 ) -> Tuple[float, float, float]:
    """(weighted cost, x_bytes, y_bytes) of one strategy's collective
    legs — the same closed forms and summation order as the JAX
    package."""
    a_bytes = _bytes((n, k), da, itemsize)
    b_bytes = _bytes((k, m), db, itemsize)
    c_bytes = _bytes((n, m), 1.0, itemsize)
    p = gx * gy
    wx, wy = weights
    ax = {"x": 0.0, "y": 0.0}

    def leg(bytes_: float, axis: str) -> Tuple[float, float]:
        w = wx if axis == "x" else wy
        ax[axis] += bytes_
        return bytes_ * w, w

    def bcast(src_bytes: float) -> Tuple[float, float]:
        cost, bx, by = _split_full_mesh(src_bytes, gx, gy, wx, wy)
        ax["x"] += bx
        ax["y"] += by
        return cost, max(wx, wy)

    FREE = (0.0, 0.0)

    def total(*terms, extra_steps_w: float = 0.0):
        steps_w = sum(w for t, w in terms if t > 0.0) + extra_steps_w
        return sum(t for t, _w in terms) + alpha_bytes * steps_w

    def to2d(bytes_: float, layout: str) -> Tuple[float, float]:
        amt = _to_2d_reshard(bytes_, layout, gx, gy)
        return leg(amt, _to_2d_axis(layout)) if amt > 0.0 else FREE

    if strategy == "bmm_right":
        t_bcast = FREE if b_layout == "rep" else bcast(b_bytes)
        t_resh = (FREE if a_layout in ("row", "rep")
                  else leg((a_bytes / p) * (1 - 1 / gy), "y"))
        return total(t_bcast, t_resh), ax["x"], ax["y"]
    if strategy == "bmm_left":
        t_bcast = FREE if a_layout == "rep" else bcast(a_bytes)
        t_resh = (FREE if b_layout in ("col", "rep")
                  else leg((b_bytes / p) * (1 - 1 / gx), "x"))
        return total(t_bcast, t_resh), ax["x"], ax["y"]
    if strategy == "cpmm":
        t_a = to2d(a_bytes, a_layout)
        t_b = (FREE if b_layout == "rep"
               else leg((b_bytes / gy) * (gx - 1) / gx, "x"))
        t_c = leg((c_bytes / gx) * (gy - 1) / gy, "y")
        return total(t_a, t_b, t_c), ax["x"], ax["y"]
    if strategy in ("rmm", "xla"):
        t_a = (FREE if a_layout == "rep"
               else leg((a_bytes / gx) * (gy - 1) / gy, "y"))
        t_b = (FREE if b_layout == "rep"
               else leg((b_bytes / gy) * (gx - 1) / gx, "x"))
        return total(t_a, t_b), ax["x"], ax["y"]
    if strategy == "summa":
        g = max(gx, gy)
        ring_a = (a_bytes / p) * (g - 1)
        ring_b = (b_bytes / p) * (g - 1)
        ax["y"] += ring_a
        ax["x"] += ring_b
        if wx == wy:
            ring = (a_bytes / p + b_bytes / p) * (g - 1) * wx
        else:
            ring = ring_a * wy + ring_b * wx
        cost = ring + total(to2d(a_bytes, a_layout),
                            to2d(b_bytes, b_layout),
                            extra_steps_w=(g - 1) * wy + (g - 1) * wx)
        return cost, ax["x"], ax["y"]
    if strategy == "spgemm":
        return 0.0, 0.0, 0.0
    raise ValueError(f"unknown strategy {strategy}")


def comm_cost(strategy: str, n: int, k: int, m: int,
              da: float, db: float, gx: int, gy: int,
              itemsize: int = 4,
              a_layout: str = "2d", b_layout: str = "2d",
              alpha_bytes: float = 0.0,
              weights: Tuple[float, float] = (1.0, 1.0)) -> float:
    """Estimated per-device interconnect cost of one strategy, in
    weighted byte-equivalents (layout-aware, α-β, topology-weighted)."""
    return _comm_detail(strategy, n, k, m, da, db, gx, gy, itemsize,
                        a_layout, b_layout, alpha_bytes, weights)[0]


def _norm_axes(e):
    """Normalise one spec entry: 1-tuples to their element."""
    if isinstance(e, tuple):
        if len(e) == 0:
            return None
        if len(e) == 1:
            return e[0]
        return tuple(e)
    return e


def _layout_of(node: MatExpr, mesh: Mesh) -> str:
    """How a LEAF operand lives on the grid, from its spec."""
    if node.kind != "leaf":
        return "2d"
    spec = node.attrs["matrix"].spec
    x, y = mesh.axis_names
    row = _norm_axes(spec[0] if len(spec) > 0 else None)
    col = _norm_axes(spec[1] if len(spec) > 1 else None)
    if row is None and col is None:
        return "rep"
    flat = ((x, y), (y, x))
    if col is None and row in flat:
        return "row"
    if row is None and col in flat:
        return "col"
    from matrel_tpu_torch.core import padding
    cspec = padding.canonical_spec(padding.padded_shape(node.shape, mesh),
                                   mesh)
    crow = _norm_axes(cspec[0] if len(cspec) > 0 else None)
    ccol = _norm_axes(cspec[1] if len(cspec) > 1 else None)
    return "2d" if (row, col) == (crow, ccol) else "other"


def infer_layout(node: MatExpr, mesh: Mesh,
                 memo: Optional[dict] = None,
                 config: Optional[MatrelConfig] = None) -> str:
    """Best-effort output layout of any node's lowering on the grid,
    propagated bottom-up exactly as the JAX package does (memoised per
    uid)."""
    if memo is None:
        memo = {}
    cfg = config or default_config()

    def walk(n: MatExpr) -> str:
        if n.uid in memo:
            return memo[n.uid]
        memo[n.uid] = l = _infer(n)
        return l

    def _infer(n: MatExpr) -> str:
        k = n.kind
        if k == "leaf":
            return _layout_of(n, mesh)
        if k == "matmul":
            # branch order mirrors Lowerer._matmul: spgemm, then coo_leaf
            # on either side, then sparse_leaf
            if _spgemm_matmul(n, cfg):
                return "2d"
            if any(c.kind == "coo_leaf" for c in n.children):
                if not _coo_narrow_matmul(n):
                    return "2d"          # densify path: hard-coded xla
                # "rep" only where the lowering pins it: one device. The
                # compact sharded path (out_specs=P()) is not ported, so
                # a virtual multi-device grid claims nothing — the JAX
                # package's answer off the TPU.
                return "rep" if mesh.size == 1 else "2d"
            if any(c.kind == "sparse_leaf" for c in n.children):
                return "2d"
            return STRATEGY_OUT_LAYOUT.get(n.attrs.get("strategy"), "2d")
        if k == "transpose":
            c = walk(n.children[0])
            return {"row": "col", "col": "row"}.get(c, c)
        if k in ("scalar", "select_value", "select_index", "rank1"):
            return walk(n.children[0])
        if k == "elemwise":
            la, lb = walk(n.children[0]), walk(n.children[1])
            if n.children[0].shape != n.shape:
                return lb
            if n.children[1].shape != n.shape:
                return la
            if la == lb:
                return la
            if la == "rep":
                return lb
            if lb == "rep":
                return la
            return "2d"
        if k == "agg":
            axis = n.attrs["axis"]
            lc = walk(n.children[0])
            if axis in ("all", "diag"):
                return "rep"
            if axis == "row" and lc == "row":
                return "row"
            if axis == "col" and lc == "col":
                return "col"
            return "2d"
        return "2d"

    return walk(node)


#: Sparse leaf kinds: a matmul of two dispatches S×S SpGEMM, one beside
#: a dense operand its own SpMM / SpMV route.
SPARSE_KINDS = ("sparse_leaf", "coo_leaf")


def _spgemm_matmul(n: MatExpr, config=None) -> bool:
    """Will this matmul dispatch the S×S SpGEMM? The shared predicate
    lives in the executor; for the S×S path, which is not ported, it
    raises ``NotPortedError``."""
    l, r = n.children
    if l.kind in SPARSE_KINDS and r.kind in SPARSE_KINDS:
        from matrel_tpu_torch import executor as _exec
        return _exec._spgemm_dispatch(n, config)
    return False


def _coo_narrow_matmul(n: MatExpr) -> bool:
    """Will this matmul dispatch the narrow COO SpMV path? Consults
    ``executor._coo_dispatch_plan`` itself, so a refused plan (which
    densifies) is honoured too; the plan it builds is memoised on the
    matrix and needed at lowering anyway."""
    l, r = n.children
    if l.kind == "coo_leaf" or r.kind == "coo_leaf":
        from matrel_tpu_torch import executor as _exec
        return _exec._coo_dispatch_plan(n) is not None
    return False


_INT_DTYPES = (torch.int8, torch.int16, torch.int32, torch.int64,
               torch.uint8)


def _is_int(d: torch.dtype) -> bool:
    return d in _INT_DTYPES


def infer_dtype(node: MatExpr, config: Optional[MatrelConfig] = None,
                memo: Optional[dict] = None) -> Optional[torch.dtype]:
    """Statically-known output dtype of a node, or None — the mirror of
    the Lowerer's dtype behaviour (see the JAX package's docstring)."""
    cfg = config or default_config()
    if memo is None:
        memo = {}

    def walk(n: MatExpr):
        if n.uid in memo:
            return memo[n.uid]
        memo[n.uid] = d = _infer(n)
        return d

    def _promote(*ds):
        if any(d is None for d in ds):
            return None
        out = ds[0]
        for d in ds[1:]:
            out = torch.promote_types(out, d)
        return out

    def _infer(n: MatExpr):
        k = n.kind
        if k in ("leaf", "sparse_leaf"):
            return n.attrs["matrix"].dtype
        if k == "coo_leaf":
            # COO payloads are f32 by construction and the SpMV paths
            # accumulate f32: checked with a raise, so a dtype-bearing
            # COOMatrix fails loudly instead of planning as f32
            m = n.attrs["matrix"]
            vals = getattr(m, "vals", None)
            if vals is not None and np.dtype(vals.dtype) != np.float32:
                raise TypeError(
                    f"COOMatrix payload dtype {vals.dtype} != float32: "
                    "infer_dtype's COO rule (and the SpMV f32 "
                    "accumulation it mirrors) no longer holds")
            return torch.float32
        if k in ("transpose", "scalar", "agg", "vec", "select_value",
                 "select_index"):
            return walk(n.children[0])
        if k == "matmul":
            if n.attrs.get("precision_tier") in ("int32", "int8"):
                return torch.int32
            da, db = walk(n.children[0]), walk(n.children[1])
            if da is None or db is None:
                return None
            if cfg.keep_input_dtype and da == db:
                return da
            if torch.bfloat16 in (da, db):
                return torch.float32
            return _promote(da, db)
        if k in ("elemwise", "rank1"):
            return _promote(*(walk(c) for c in n.children))
        if k == "inverse":
            da = walk(n.children[0])
            if da is None:
                return None
            return da if cfg.keep_input_dtype else torch.float32
        if k == "solve":
            da, db = walk(n.children[0]), walk(n.children[1])
            if da is None or db is None:
                return None
            if cfg.keep_input_dtype and da == db:
                return da
            return torch.float32
        return None

    return walk(node)


# -- precision tiers (per-query accuracy SLAs) -------------------------------
#
# The tier vocabulary, pass counts, cost units and error bounds are the
# JAX package's planner constants: they rank tiers and bound their
# errors, and stay equal so both planners stamp the same tiers. On this
# card "f32" is one IEEE f32 product (TF32 off) and the bf16 tiers run
# their residual-split passes through the same strategy recipe.

PRECISION_TIERS = ("f32", "bf16x1", "bf16x3", "int32", "int8")
TIER_COMPUTE_UNITS = {"f32": 3.0, "bf16x1": 0.5, "bf16x3": 1.5,
                      "int32": 1.0, "int8": 0.25}
TIER_ITEMSIZE = {"f32": 4, "bf16x1": 2, "bf16x3": 4, "int32": 4, "int8": 1}
TIER_EPS = {"f32": 2.0 ** -20, "bf16x1": 2.0 ** -8,
            "bf16x3": 2.0 ** -15, "int32": 0.0, "int8": 0.0}
_DTYPE_SLA_TIER = {"float32": "f32", "bfloat16": "bf16x1",
                   "bf16x3": "bf16x3", "int32": "int32", "int8": "int8"}


def tier_matmul_cost(tier: str, n: int, k: int, m: int,
                     da: float = 1.0, db: float = 1.0) -> float:
    """Estimated cost of one multiply at a tier, in f32-FLOP-equivalents."""
    from matrel_tpu_torch.ir import stats
    compute = stats.matmul_cost(n, k, m, da, db) * TIER_COMPUTE_UNITS[tier]
    isz = TIER_ITEMSIZE[tier]
    hbm = (n * k * max(da, 0.0) + k * m * max(db, 0.0)) * isz \
        + n * m * 4.0
    return compute + stats.HBM_FLOPS_PER_BYTE * hbm


def sla_allowed_tiers(sla: str, integral: bool,
                      config: Optional[MatrelConfig] = None) -> tuple:
    """Tiers admissible under an SLA (an accuracy floor)."""
    cfg = config or default_config()
    if sla == "default":
        return ()
    pinned = _DTYPE_SLA_TIER.get(sla)
    if pinned is not None:
        return (pinned,)
    tiers = ["f32"]
    if cfg.precision_enable_int and integral:
        tiers.append("int32")
    if cfg.precision_enable_bf16:
        if sla in ("high", "fast"):
            tiers.append("bf16x3")
        if sla == "fast":
            tiers.append("bf16x1")
    return tuple(tiers)


def sla_compute_factor(config: Optional[MatrelConfig] = None) -> float:
    """Relative compute time per MAC of the session SLA's cheapest tier
    vs the default lowering (the chain DP's ``flop_scale``)."""
    cfg = config or default_config()
    tiers = sla_allowed_tiers(cfg.precision_sla, False, cfg)
    if not tiers:
        return 1.0
    best = min(tiers, key=lambda t: TIER_COMPUTE_UNITS[t])
    return TIER_COMPUTE_UNITS[best] / TIER_COMPUTE_UNITS["f32"]


INT32_ACC_MAX = float(2 ** 31 - 1)


def int_tier_fits(node: MatExpr, tier: str,
                  integral_memo: Optional[dict] = None) -> bool:
    """Is an int tier PROVABLY overflow-free for this matmul?"""
    from matrel_tpu_torch.ir import stats
    a, b = node.children
    ba = stats.integral_abs_bound(a, integral_memo)
    bb = stats.integral_abs_bound(b, integral_memo)
    if ba is None or bb is None:
        return False
    if tier == "int8" and (ba > 127.0 or bb > 127.0):
        return False

    def exact_operand(child, bound) -> bool:
        if child.attrs.get("precision_tier") in ("int32", "int8"):
            return bound <= INT32_ACC_MAX
        return bound <= 2.0 ** 24

    if not (exact_operand(a, ba) and exact_operand(b, bb)):
        return False
    return a.shape[1] * ba * bb <= INT32_ACC_MAX


def choose_precision_tier(node: MatExpr,
                          config: Optional[MatrelConfig] = None,
                          dtype_memo: Optional[dict] = None,
                          integral_memo: Optional[dict] = None
                          ) -> Optional[str]:
    """The tier one matmul runs at under the session SLA, or None for
    the default lowering (the JAX package's rules, verbatim)."""
    cfg = config or default_config()
    sla = cfg.precision_sla
    if sla == "default" or node.kind != "matmul":
        return None
    a, b = node.children
    if _spgemm_matmul(node, cfg) or any(
            c.kind in SPARSE_KINDS for c in node.children):
        return None
    da = infer_dtype(a, cfg, dtype_memo)
    db = infer_dtype(b, cfg, dtype_memo)
    if da is None or db is None:
        return None

    def _ok(d):
        return d == torch.float32 or _is_int(d)

    if not (_ok(da) and _ok(db)):
        return None
    from matrel_tpu_torch.ir import stats
    pinned = _DTYPE_SLA_TIER.get(sla)
    if _is_int(da) or _is_int(db):
        integral = all(_is_int(d) or stats.infer_integral(c, integral_memo)
                       for d, c in ((da, a), (db, b)))
        if pinned in ("int32", "int8"):
            return pinned
        if pinned is not None:
            return None
        if integral and cfg.precision_enable_int \
                and int_tier_fits(node, "int32", integral_memo):
            return "int32"
        return None
    integral = stats.infer_integral(node, integral_memo)
    tiers = sla_allowed_tiers(sla, integral, cfg)
    if pinned is None:
        tiers = tuple(t for t in tiers
                      if t not in ("int32", "int8")
                      or int_tier_fits(node, t, integral_memo))
    if not tiers:
        return None
    n, k = a.shape
    m = b.shape[1]
    best, best_cost = None, None
    for t in tiers:
        c = tier_matmul_cost(t, n, k, m, a.density, b.density)
        if best_cost is None or c < best_cost:
            best, best_cost = t, c
    return best


def strategy_hbm_bytes(strategy: str, pn: int, pk: int, pm: int,
                       gx: int, gy: int, itemsize: int = 4) -> float:
    """Per-device working set of one strategy on the grid, in bytes."""
    p = max(gx * gy, 1)
    a = float(pn) * pk * itemsize
    b = float(pk) * pm * itemsize
    c = float(pn) * pm * itemsize
    if strategy == "bmm_right":
        return b + a / p + c / p
    if strategy == "bmm_left":
        return a + b / p + c / p
    if strategy == "cpmm":
        return a / p + b / gy + c / gx
    if strategy == "rmm":
        return a / gx + b / gy + c / p
    if strategy == "summa":
        return 2.0 * (a / p + b / p) + c / p
    return 0.0


def admissible(strategy: str, pn: int, pk: int, pm: int,
               gx: int, gy: int, itemsize: int = 4,
               hbm_budget_bytes: int = 0) -> bool:
    """Do the strategy's specs divide the padded dims, and does its
    working set fit ``hbm_budget_bytes`` (when > 0)?"""
    p = gx * gy
    if (hbm_budget_bytes > 0 and strategy != "xla"
            and strategy_hbm_bytes(strategy, pn, pk, pm, gx, gy,
                                   itemsize) > hbm_budget_bytes):
        return False
    if strategy == "bmm_right":
        return pn % p == 0
    if strategy == "bmm_left":
        return pm % p == 0
    if strategy == "cpmm":
        return pn % gx == 0 and pk % gy == 0 and pm % gy == 0
    if strategy == "rmm":
        return pn % gx == 0 and pm % gy == 0
    if strategy == "summa":
        return (gx == gy and pn % gx == 0 and pm % gy == 0
                and pk % gx == 0 and pk % gy == 0)
    return True  # xla


def _root_reshard_cost(strategy: str, n: int, m: int, gx: int, gy: int,
                       transposed: bool = False,
                       weights: Tuple[float, float] = (1.0, 1.0)) -> float:
    """Bytes to re-lay a ROOT bmm output to the canonical layout."""
    p = gx * gy
    c_bytes = _bytes((n, m), 1.0)
    out_row = (strategy == "bmm_right") != transposed
    if strategy == "bmm_right" or strategy == "bmm_left":
        g_perp = gy if out_row else gx
        w = weights[1] if out_row else weights[0]
        return (c_bytes / p) * (1 - 1 / g_perp) * w
    return 0.0


#: Output layout each matmul strategy emits.
STRATEGY_OUT_LAYOUT = {"bmm_right": "row", "bmm_left": "col",
                       "cpmm": "2d", "rmm": "2d", "summa": "2d",
                       "xla": "2d", "spgemm": "2d"}

#: Near-tie band for the consumer-aware strategy tiebreak.
STRATEGY_TIE_REL = 0.10


def _hint_tiebreak(costs: dict, best, out_layout_of,
                   hint: Optional[str], tie_rel: float):
    """Among candidates within ``tie_rel`` of the cheapest, the cheapest
    whose output layout matches ``hint``; otherwise ``best``."""
    if hint is None:
        return best
    near = sorted((s for s in costs
                   if costs[s] <= costs[best] * (1.0 + tie_rel) + 1e-9),
                  key=costs.get)
    for s in near:
        if out_layout_of(s) == hint:
            return s
    return best


def choose_strategy_ex(node: MatExpr, mesh: Mesh,
                       config: Optional[MatrelConfig] = None,
                       dtype_memo: Optional[dict] = None,
                       layout_memo: Optional[dict] = None,
                       root_output: bool = False,
                       root_transposed: bool = False,
                       consumer_hint: Optional[str] = None,
                       root_scale: float = 1.0) -> Tuple[str, str]:
    """(strategy, source) for one matmul node: "dispatch" (S×S),
    "override", "model" (byte-model argmin) or "default" (single device
    / no admissible candidate)."""
    cfg = config or default_config()
    if _spgemm_matmul(node, cfg):
        return "spgemm", "dispatch"
    if cfg.strategy_override != "auto":
        return cfg.strategy_override, "override"
    a, b = node.children
    n, k = a.shape
    _, m = b.shape
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    if gx * gy == 1:
        return "xla", "default"  # single device: plain local dot
    from matrel_tpu_torch.core import padding
    pn, pk = padding.padded_shape((n, k), mesh)
    _, pm = padding.padded_shape((k, m), mesh)
    la = infer_layout(a, mesh, layout_memo, cfg)
    lb = infer_layout(b, mesh, layout_memo, cfg)
    da, db = a.density, b.density
    cands = {}
    a_bytes = _bytes((n, k), da)
    b_bytes = _bytes((k, m), db)
    al = cfg.comm_alpha_bytes
    wts = mesh_lib.axis_weights(mesh, cfg)
    if b_bytes <= cfg.broadcast_threshold_bytes:
        cands["bmm_right"] = comm_cost("bmm_right", n, k, m, da, db, gx, gy,
                                       a_layout=la, b_layout=lb,
                                       alpha_bytes=al, weights=wts)
    if a_bytes <= cfg.broadcast_threshold_bytes:
        cands["bmm_left"] = comm_cost("bmm_left", n, k, m, da, db, gx, gy,
                                      a_layout=la, b_layout=lb,
                                      alpha_bytes=al, weights=wts)
    cands["cpmm"] = comm_cost("cpmm", n, k, m, da, db, gx, gy,
                              a_layout=la, b_layout=lb, alpha_bytes=al,
                              weights=wts)
    cands["rmm"] = comm_cost("rmm", n, k, m, da, db, gx, gy,
                             a_layout=la, b_layout=lb, alpha_bytes=al,
                             weights=wts)
    if gx == gy and gx > 1:
        cands["summa"] = comm_cost("summa", n, k, m, da, db, gx, gy,
                                   a_layout=la, b_layout=lb,
                                   alpha_bytes=al, weights=wts)
    dt_out = infer_dtype(node, cfg, dtype_memo)
    isz = dt_out.itemsize if dt_out is not None else 4
    tier = node.attrs.get("precision_tier")
    if tier in TIER_ITEMSIZE:
        isz = TIER_ITEMSIZE[tier]
    cands = {s: c for s, c in cands.items()
             if admissible(s, pn, pk, pm, gx, gy, itemsize=isz,
                           hbm_budget_bytes=cfg.hbm_budget_bytes)}
    if root_output:
        cands = {s: c + _root_reshard_cost(s, n, m, gx, gy,
                                           root_transposed,
                                           weights=wts) * root_scale
                 for s, c in cands.items()}
    if not cands:
        return "xla", "default"
    best = min(cands, key=cands.get)
    if not root_output:
        best = _hint_tiebreak(cands, best, STRATEGY_OUT_LAYOUT.get,
                              consumer_hint, STRATEGY_TIE_REL)
    return best, "model"


def _child_root_scale(e: MatExpr, i: int, scale: float) -> float:
    """Fraction of the plan-root canonical re-lay charge child ``i``'s
    output layout is exposed to (see the JAX package)."""
    if scale <= 0.0:
        return 0.0

    def _elems(shape) -> float:
        return float(max(shape[0] * shape[1], 1))

    k = e.kind
    child = e.children[i]
    if k in ("scalar", "select_value", "select_index", "transpose"):
        return scale * _elems(e.shape) / _elems(child.shape)
    if k == "rank1":
        return scale if i == 0 else 0.0
    if k == "elemwise":
        if e.children[0].shape != e.children[1].shape:
            return scale if child.shape == e.shape else 0.0
        return scale * 0.5
    return 0.0


def _child_layout_hints(e: MatExpr, mesh: Optional[Mesh] = None,
                        config: Optional[MatrelConfig] = None,
                        dtype_memo: Optional[dict] = None
                        ) -> Tuple[Optional[str], ...]:
    """Layout each child's output would be consumed in place at by this
    node (a matmul reads its left operand row-sharded under bmm_right
    and its right operand col-sharded under bmm_left, when it could
    run that bmm)."""
    if e.kind == "matmul":
        if any(c.kind in SPARSE_KINDS for c in e.children):
            return (None, None)
        cfg = config or default_config()
        a, b = e.children
        right_ok = _bytes(b.shape, b.density) <= cfg.broadcast_threshold_bytes
        left_ok = _bytes(a.shape, a.density) <= cfg.broadcast_threshold_bytes
        if mesh is not None:
            from matrel_tpu_torch.core import padding
            gx, gy = mesh_lib.mesh_grid_shape(mesh)
            n, k = a.shape
            m = b.shape[1]
            pn, pk = padding.padded_shape((n, k), mesh)
            _, pm = padding.padded_shape((k, m), mesh)
            dt_out = infer_dtype(e, cfg, dtype_memo)
            isz = dt_out.itemsize if dt_out is not None else 4
            budget = cfg.hbm_budget_bytes
            right_ok = right_ok and admissible(
                "bmm_right", pn, pk, pm, gx, gy, itemsize=isz,
                hbm_budget_bytes=budget)
            left_ok = left_ok and admissible(
                "bmm_left", pn, pk, pm, gx, gy, itemsize=isz,
                hbm_budget_bytes=budget)
        return ("row" if right_ok else None,
                "col" if left_ok else None)
    return (None,) * len(e.children)


def annotate_strategies(e: MatExpr, mesh: Mesh,
                        config: Optional[MatrelConfig] = None,
                        _dtype_memo: Optional[dict] = None,
                        _layout_memo: Optional[dict] = None,
                        _consumer_hint: Optional[str] = None,
                        _root_scale: float = 1.0,
                        _root_swap: bool = False,
                        _integral_memo: Optional[dict] = None) -> MatExpr:
    """Bottom-up pass stamping ``precision_tier`` (non-default SLAs),
    ``strategy`` and ``strategy_source`` on every matmul node."""
    memo = {} if _dtype_memo is None else _dtype_memo
    lmemo = {} if _layout_memo is None else _layout_memo
    imemo = {} if _integral_memo is None else _integral_memo
    hints = _child_layout_hints(e, mesh, config, dtype_memo=memo)
    swap = _root_swap != (e.kind == "transpose")   # odd transposes flip
    new_children = tuple(
        annotate_strategies(c, mesh, config, memo, lmemo, h,
                            _child_root_scale(e, i, _root_scale), swap,
                            imemo)
        for i, (c, h) in enumerate(zip(e.children, hints)))
    if any(nc is not oc for nc, oc in zip(new_children, e.children)):
        e = e.with_children(new_children)
    if e.kind == "matmul" and "precision_tier" not in e.attrs:
        tier = choose_precision_tier(e, config, dtype_memo=memo,
                                     integral_memo=imemo)
        if tier is not None:
            e = e.with_attrs(precision_tier=tier)
    if e.kind == "matmul" and "strategy" not in e.attrs:
        strat, source = choose_strategy_ex(e, mesh, config,
                                           dtype_memo=memo,
                                           layout_memo=lmemo,
                                           root_output=_root_scale > 0.0,
                                           root_transposed=_root_swap,
                                           consumer_hint=_consumer_hint,
                                           root_scale=_root_scale)
        e = e.with_attrs(strategy=strat, strategy_source=source)
    infer_dtype(e, config, memo)     # seed this (possibly new-uid) node
    infer_layout(e, mesh, lmemo, config)
    return e
