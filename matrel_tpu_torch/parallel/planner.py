"""Cost-based physical planning — the counterpart of
``matrel_tpu/parallel/planner.py``, ported as far as
``annotate_strategies`` reaches under the slice's configuration:
``choose_strategy_ex``, ``comm_cost``, ``infer_layout``,
``infer_dtype`` and ``choose_precision_tier``; plus the read-only
decision records of an annotated plan (``matmul_decisions``,
``comm_cost_axes``).

The strategy choice per matmul is made before execution from shapes,
densities and operand layouts, with a communication-cost model over the
mesh's (virtual) grid, and stamped on the node (``attrs["strategy"]`` /
``attrs["strategy_source"]``). On one card the grid is 1x1 and every
dense matmul stamps ``("xla", "default")``; a virtual grid reproduces
the JAX package's stamps. An S×S matmul that dispatches SpGEMM stamps
``("spgemm", "dispatch")`` and the registry kernel it runs
(``spgemm_kernel``, ``spgemm_structure``, ``spgemm_kernel_source``).
Row/col index joins stamp the replication scheme ``choose_join_scheme``
picks (``attrs["replicate"]``: "left", "right" or "align"); the scheme
is priced with the closed-form reshard terms, or, with
``reshard_peak_budget_bytes`` > 0, from the compiled staged plan
(``parallel/reshard.py``). Under ``config.coeff_planner_enable`` a
model decision ranks in predicted milliseconds when every candidate
has a warm drift-table row for the plan's backend
(``parallel/coeffs.py``; stamp ``cost_model``).
With ``config.autotune`` on, a measured winner from
``parallel/autotune.py`` overrides the byte model for a dense product
on a grid of more than one device (source "measured"), and the S×S
kernel stamp may come from a measured SpGEMM winner.
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
              weights: Tuple[float, float] = (1.0, 1.0),
              coeff: Optional[dict] = None) -> float:
    """Estimated per-device interconnect cost of one strategy, in
    weighted byte-equivalents (layout-aware, α-β, topology-weighted) —
    or in calibrated milliseconds when a ``coeff`` row
    (``parallel/coeffs.py``) is passed: its ms/est-MiB ratio was
    calibrated against exactly this quantity. None keeps the raw
    byte-equivalents, bit-identical."""
    cost = _comm_detail(strategy, n, k, m, da, db, gx, gy, itemsize,
                        a_layout, b_layout, alpha_bytes, weights)[0]
    if coeff is not None:
        from matrel_tpu_torch.parallel import coeffs as coeffs_lib
        cm = coeff.get("ms_per_mib")
        if cm is None:
            cm = coeffs_lib.ANALYTIC_MS_PER_MIB
        return float(cm) * (cost / (1 << 20))
    return cost


def comm_cost_axes(strategy: str, n: int, k: int, m: int,
                   da: float, db: float, gx: int, gy: int,
                   itemsize: int = 4,
                   a_layout: str = "2d", b_layout: str = "2d",
                   weights: Tuple[float, float] = (1.0, 1.0),
                   coeff: Optional[dict] = None
                   ) -> Tuple[float, float]:
    """Raw (unweighted) per-device bytes a strategy moves over each
    grid axis, (x_bytes, y_bytes): the per-axis decomposition of
    :func:`comm_cost`'s bill. ``weights`` only choose the stage order a
    full-mesh collective's bytes are attributed under; ``coeff`` (same
    contract as :func:`comm_cost`) scales both into calibrated
    milliseconds."""
    _, bx, by = _comm_detail(strategy, n, k, m, da, db, gx, gy,
                             itemsize, a_layout, b_layout, 0.0, weights)
    if coeff is not None:
        from matrel_tpu_torch.parallel import coeffs as coeffs_lib
        cm = coeff.get("ms_per_mib")
        if cm is None:
            cm = coeffs_lib.ANALYTIC_MS_PER_MIB
        scale = float(cm) / (1 << 20)
        return bx * scale, by * scale
    return bx, by


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
                # JAX package also claims it for its compact sharded path
                # (out_specs=P()) when autotune is off, since a measured
                # "expanded" winner reroutes that dispatch; that path is
                # not ported, so a virtual multi-device grid claims
                # nothing, with autotune on or off — the JAX package's
                # answer off the TPU.
                return "rep" if mesh.size == 1 else "2d"
            if any(c.kind == "sparse_leaf" for c in n.children):
                return "2d"
            return STRATEGY_OUT_LAYOUT.get(n.attrs.get("strategy"), "2d")
        if k == "transpose":
            c = walk(n.children[0])
            return {"row": "col", "col": "row"}.get(c, c)
        if k in ("scalar", "select_value", "select_index", "select_block",
                 "rank1"):
            return walk(n.children[0])
        if k in ("elemwise", "join_index"):
            la, lb = walk(n.children[0]), walk(n.children[1])
            # broadcast: the full-shaped operand's layout carries
            if k == "elemwise" and n.children[0].shape != n.shape:
                return lb
            if k == "elemwise" and n.children[1].shape != n.shape:
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
        if k in ("join_rows", "join_cols"):
            rep = n.attrs.get("replicate")
            if rep in ("align", "left", "right"):
                return _scheme_out_layout(rep, n, walk(n.children[0]),
                                          walk(n.children[1]))
            return "2d"
        return "2d"

    return walk(node)


#: Sparse leaf kinds: a matmul of two dispatches S×S SpGEMM, one beside
#: a dense operand its own SpMM / SpMV route.
SPARSE_KINDS = ("sparse_leaf", "coo_leaf")


def _spgemm_matmul(n: MatExpr, config=None) -> bool:
    """Will this matmul dispatch the S×S SpGEMM? Consults the
    executor's ``_spgemm_dispatch``, the single source of truth."""
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
                 "select_index", "select_block"):
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
        if k in ("elemwise", "rank1", "join_value"):
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
        if k in ("join_rows", "join_cols", "join_index"):
            # structured merges promote; user callables may not
            if n.attrs.get("merge_kind") is not None:
                return _promote(*(walk(c) for c in n.children))
            return None
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
#: MXU passes a tier's multiply takes on the TPU (f32 is six bf16
#: passes there): a planner record field, kept equal to the JAX
#: package's.
TIER_PASSES = {"f32": 6, "bf16x1": 1, "bf16x3": 3, "int32": 1, "int8": 1}
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


def tier_error_bound(tier: str, k: int, amax: float = 1.0,
                     bmax: float = 1.0) -> float:
    """Documented max-abs error bound of a k-deep product at a tier
    (the TIER_EPS closed form)."""
    return TIER_EPS[tier] * float(k) * float(amax) * float(bmax)


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


def choose_strategy(node: MatExpr, mesh: Mesh,
                    config: Optional[MatrelConfig] = None,
                    dtype_memo: Optional[dict] = None,
                    layout_memo: Optional[dict] = None) -> str:
    """The cheapest admissible strategy for one matmul node."""
    return choose_strategy_ex(node, mesh, config, dtype_memo,
                              layout_memo)[0]


def choose_strategy_ex(node: MatExpr, mesh: Mesh,
                       config: Optional[MatrelConfig] = None,
                       dtype_memo: Optional[dict] = None,
                       layout_memo: Optional[dict] = None,
                       root_output: bool = False,
                       root_transposed: bool = False,
                       consumer_hint: Optional[str] = None,
                       root_scale: float = 1.0,
                       cost_detail: Optional[dict] = None
                       ) -> Tuple[str, str]:
    """(strategy, source) for one matmul node: "dispatch" (S×S),
    "override", "measured" (an autotune table winner, with
    ``config.autotune``), "model" (byte-model argmin) or "default"
    (single device / no admissible candidate).

    ``cost_detail`` (an out-param dict) reports which cost model priced
    a "model" decision under ``config.coeff_planner_enable``:
    ``{"cost": "measured"}`` when every admissible candidate had a warm
    ``parallel/coeffs.py`` row for this (strategy[@tier], shape-class,
    backend) population and the ranking ran in predicted milliseconds,
    ``{"cost": "analytic"}`` when any candidate was cold and the closed
    forms decided. The backend is the plan's device type."""
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
    if cfg.autotune:
        # A measured winner beats the byte model only where the table's
        # probes apply: both operand dtypes known and equal, dense
        # operands (the probes are dense; a density credit would be
        # bypassed), both laid out "2d" (as measured), admissible for
        # these exact dims, and not a 1D-emitting winner at a plan root
        # (the probes never pay the root's re-lay).
        dta = infer_dtype(a, cfg, dtype_memo)
        dtb = infer_dtype(b, cfg, dtype_memo)
        dense = ((a.density is None or a.density >= 1.0)
                 and (b.density is None or b.density >= 1.0))
        if (dense and dta is not None and dta == dtb
                and la == "2d" and lb == "2d"):
            from matrel_tpu_torch.parallel import autotune
            best = autotune.lookup_or_measure(n, k, m, mesh,
                                              autotune.dtype_name(dta), cfg)
            if (best is not None
                    and admissible(best, pn, pk, pm, gx, gy,
                                   itemsize=dta.itemsize,
                                   hbm_budget_bytes=cfg.hbm_budget_bytes)
                    and not (root_output
                             and STRATEGY_OUT_LAYOUT.get(best) != "2d")):
                return best, "measured"
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
    if cfg.coeff_planner_enable:
        # learned-coefficient ranking: only when EVERY admissible
        # candidate is warm (comparing one candidate's milliseconds
        # against another's byte-equivalents would be a units error)
        from matrel_tpu_torch.obs import drift as drift_lib
        from matrel_tpu_torch.parallel import coeffs as coeffs_lib
        cost_src = "analytic"
        path = drift_lib.table_path(cfg)
        cls = drift_lib.shape_class((n, k, m))
        backend = mesh.device.type
        gf = 2.0 * n * k * m / 1e9
        measured: Optional[dict] = {}
        for s, c in cands.items():
            row = coeffs_lib.strategy_row(s, cls, backend, path,
                                          tier=tier or "")
            if row is None or row["count"] < cfg.coeff_min_samples:
                measured = None
                break
            measured[s] = coeffs_lib.predict_ms(row, gf, c)
        if measured:
            cands = measured
            cost_src = "measured"
        if cost_detail is not None:
            cost_detail["cost"] = cost_src
    best = min(cands, key=cands.get)
    if not root_output:
        best = _hint_tiebreak(cands, best, STRATEGY_OUT_LAYOUT.get,
                              consumer_hint, STRATEGY_TIE_REL)
    return best, "model"


def _reshard_to_axis(bytes_: float, layout: str, axis: str,
                     gx: int, gy: int,
                     weights: Tuple[float, float] = (1.0, 1.0),
                     config: Optional[MatrelConfig] = None) -> float:
    """Per-device interconnect bytes to re-lay an operand 1D-sharded over
    all devices along ``axis`` ("row"/"col") from its ``layout``, billed
    at the topology weight of the mesh axis each move rides.

    With ``config.reshard_peak_budget_bytes`` > 0 the price is the
    compiled ReshardPlan's (``parallel/reshard.py``): bit-identical to
    these closed forms for single-axis moves, and the honestly higher
    staged bill where the budget forces the opposite-1D flip through
    2d. The default config never constructs a plan."""
    p = max(gx * gy, 1)
    wx, wy = weights
    if layout == axis or layout == "rep":
        return 0.0
    if config is not None and config.reshard_peak_budget_bytes > 0:
        from matrel_tpu_torch.parallel import reshard as reshard_lib
        return reshard_lib.compile_reshard(
            layout, axis, bytes_, gx, gy, weights,
            peak_budget=float(config.reshard_peak_budget_bytes)
        ).weighted_cost
    if layout in ("2d", "other"):
        # gather along the perpendicular mesh axis ("other" is costed
        # exactly like "2d")
        g_perp = gy if axis == "row" else gx
        w_perp = wy if axis == "row" else wx
        return (bytes_ / p) * (1 - 1 / g_perp) * w_perp
    # opposite 1D sharding: all-to-all redistribution of the local shard
    return _split_full_mesh(bytes_ / p, gx, gy, wx, wy)[0]


#: Near-tie band for the consumer-aware join-scheme tiebreak: schemes
#: within this relative margin of the cheapest are equal-cost, and the
#: one whose output layout the consumer reads in place wins.
JOIN_TIE_REL = 0.10


def _scheme_out_layout(scheme: str, node: MatExpr,
                       la: str, lb: str) -> str:
    """Output layout each join scheme produces (infer_layout's join case,
    phrased over candidate schemes)."""
    if scheme == "align":
        return "row" if node.kind == "join_rows" else "col"
    return lb if scheme == "left" else la


def choose_join_scheme(node: MatExpr, mesh: Mesh,
                       config: Optional[MatrelConfig] = None,
                       layout_memo: Optional[dict] = None,
                       consumer_hint: Optional[str] = None) -> str:
    """Which operand of a row/col index join to replicate — the
    reference's join-scheme selection to minimise replication, with
    per-layout cost terms:

      "left"/"right" — all-gather that side everywhere (free when it is
        already replicated); the kept side computes on its own layout;
      "align" — replicate nothing: both operands re-laid 1D-sharded
        along the join axis, the join computes shard-locally (only when
        the join axis has at least one row/col per device).

    Bytes are density-credited. Among schemes within ``JOIN_TIE_REL`` of
    the cheapest, the one whose output layout matches
    ``consumer_hint`` wins. Returns "left" | "right" | "align". On one
    card every cost is 0 and "left" is stamped; the lowering applies no
    placement there."""
    a, b = node.children
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    p = max(gx * gy, 1)
    axis = "row" if node.kind == "join_rows" else "col"
    la = infer_layout(a, mesh, layout_memo, config)
    lb = infer_layout(b, mesh, layout_memo, config)
    a_bytes = _bytes(a.shape, a.density if a.density is not None else 1.0)
    b_bytes = _bytes(b.shape, b.density if b.density is not None else 1.0)
    wts = mesh_lib.axis_weights(mesh, config)

    def ag(bytes_: float, layout: str) -> float:
        if layout == "rep":
            return 0.0
        return _split_full_mesh(bytes_, gx, gy, wts[0], wts[1])[0]

    cost = {"left": ag(a_bytes, la), "right": ag(b_bytes, lb)}
    a_extent = a.shape[0] if axis == "row" else a.shape[1]
    b_extent = b.shape[0] if axis == "row" else b.shape[1]
    if a_extent != b_extent:
        raise ValueError(
            f"{node.kind} operands disagree on the join axis extent "
            f"({a_extent} vs {b_extent}) — the align gate assumes the "
            f"constructor-enforced equality (relational/ops.py)")
    if a_extent >= p:
        cost["align"] = (
            _reshard_to_axis(a_bytes, la, axis, gx, gy, weights=wts,
                             config=config)
            + _reshard_to_axis(b_bytes, lb, axis, gx, gy, weights=wts,
                               config=config))
    best = min(cost, key=cost.get)
    return _hint_tiebreak(
        cost, best, lambda s: _scheme_out_layout(s, node, la, lb),
        consumer_hint, JOIN_TIE_REL)


def _child_root_scale(e: MatExpr, i: int, scale: float) -> float:
    """Fraction of the plan-root canonical re-lay charge child ``i``'s
    output layout is exposed to (see the JAX package)."""
    if scale <= 0.0:
        return 0.0

    def _elems(shape) -> float:
        return float(max(shape[0] * shape[1], 1))

    k = e.kind
    child = e.children[i]
    if k in ("scalar", "select_value", "select_index", "select_block",
             "transpose"):
        return scale * _elems(e.shape) / _elems(child.shape)
    if k == "rank1":
        return scale if i == 0 else 0.0
    if k in ("elemwise", "join_index"):
        if k == "elemwise" and e.children[0].shape != e.children[1].shape:
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
    ``strategy`` and ``strategy_source`` on every matmul node, and the
    join scheme (``replicate``) on every row/col index join."""
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
        # cost-model provenance: requested — and stamped — only under
        # coeff_planner_enable, so default plans carry no new attr
        detail = ({} if config is not None
                  and config.coeff_planner_enable else None)
        strat, source = choose_strategy_ex(e, mesh, config,
                                           dtype_memo=memo,
                                           layout_memo=lmemo,
                                           root_output=_root_scale > 0.0,
                                           root_transposed=_root_swap,
                                           consumer_hint=_consumer_hint,
                                           root_scale=_root_scale,
                                           cost_detail=detail)
        stamp = {"strategy": strat, "strategy_source": source}
        if detail is not None and detail.get("cost"):
            stamp["cost_model"] = detail["cost"]
        e = e.with_attrs(**stamp)
        if strat == "spgemm":
            # which registry kernel the S×S lowering runs, from the
            # shared chooser (executor.spgemm_kernel_choice)
            from matrel_tpu_torch import executor as _exec
            kid, struct, ksrc = _exec.spgemm_kernel_choice(e, config, mesh)
            e = e.with_attrs(spgemm_kernel=kid, spgemm_structure=struct,
                             spgemm_kernel_source=ksrc)
    if e.kind in ("join_rows", "join_cols") and "replicate" not in e.attrs:
        e = e.with_attrs(replicate=choose_join_scheme(
            e, mesh, config, layout_memo=lmemo,
            consumer_hint=_consumer_hint))
    infer_dtype(e, config, memo)     # seed this (possibly new-uid) node
    infer_layout(e, mesh, lmemo, config)
    return e


def matmul_decisions(root: MatExpr, mesh: Mesh,
                     config: Optional[MatrelConfig] = None) -> list:
    """Per-matmul decision records of an ANNOTATED plan: for every
    matmul node (shared nodes once, children first) the chosen strategy
    and why, the precision tier and what it costs, the dispatch a
    sparse operand takes (with the S×S kernel and its estimates), or,
    for a dense product, the operand layouts and the model's per-device
    interconnect bytes on the grid. A pure read: nothing is re-chosen.

    A matmul that anchors a fused region (``ir/fusion.py`` stamps)
    carries the region's boundary (``fused_region``, ``fused_census``,
    ``est_saved_dispatches``, ``est_saved_hbm_bytes``); with
    ``reshard_peak_budget_bytes`` > 0 a dense product carries the staged
    moves its lowering compiles (``reshard``). Operands that entered
    planning as result-cache or CSE leaves are marked (``rc_operands``,
    ``cse_operands``), and a delta-patch plan's records carry its
    pricing (``delta_rule``, ``delta_est_saved_flops``). Under
    ``coeff_planner_enable`` a model-ranked product records which cost
    model priced it (``cost``)."""
    cfg = config or default_config()
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    wts = mesh_lib.axis_weights(mesh, cfg)
    lmemo: dict = {}
    dmemo: dict = {}
    out: list = []
    seen: set = set()
    # anchor uid -> its region's stamp (stamps live on region roots);
    # empty with fusion off
    fused_of: dict = {}
    fseen: set = set()

    def fwalk(node: MatExpr):
        if node.uid in fseen:
            return
        fseen.add(node.uid)
        for c in node.children:
            fwalk(c)
        a_uid = node.attrs.get("fused_anchor")
        if "fused_region" in node.attrs and a_uid is not None:
            fused_of[a_uid] = node.attrs

    fwalk(root)

    def walk(n: MatExpr):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            walk(c)
        if n.kind != "matmul":
            return
        a, b = n.children
        nn, kk = a.shape
        mm = b.shape[1]
        rec = {"uid": n.uid, "dims": [nn, kk, mm],
               "strategy": n.attrs.get("strategy", "xla"),
               "source": n.attrs.get("strategy_source", "unknown"),
               "flops": 2.0 * nn * kk * mm}
        cm = n.attrs.get("cost_model")
        if cm:
            # which cost model priced the ranking ("measured" learned
            # coefficients / "analytic" closed forms); absent with
            # coeff_planner_enable off
            rec["cost"] = cm
        tier = n.attrs.get("precision_tier")
        if tier is not None:
            rec["precision_tier"] = tier
            rec["est_passes"] = TIER_PASSES.get(tier)
            rec["est_tier_cost"] = tier_matmul_cost(
                tier, nn, kk, mm,
                a.density if a.density is not None else 1.0,
                b.density if b.density is not None else 1.0) \
                if tier in TIER_COMPUTE_UNITS else None
            rec["est_rel_err"] = TIER_EPS.get(tier)
        # an operand that entered planning as a result-cache leaf, or
        # as a batch-shared CSE hoist (serve/): which side(s)
        rc_ops = [bool(c.kind == "leaf" and c.attrs.get("result_cache"))
                  for c in n.children]
        if any(rc_ops):
            rec["rc_operands"] = rc_ops
        cse_ops = [bool(c.kind == "leaf" and c.attrs.get("cse"))
                   for c in n.children]
        if any(cse_ops):
            rec["cse_operands"] = cse_ops
        if _spgemm_matmul(n, cfg):
            from matrel_tpu_torch import executor as _exec
            rec["dispatch"] = "spgemm"
            rec.update(_exec.spgemm_estimates(n, cfg))
            kid = n.attrs.get("spgemm_kernel")
            struct = n.attrs.get("spgemm_structure")
            ksrc = n.attrs.get("spgemm_kernel_source")
            if kid is None:
                kid, struct, ksrc = _exec.spgemm_kernel_choice(n, cfg, mesh)
            rec["kernel_id"] = kid
            rec["structure_class"] = struct
            rec["kernel_source"] = ksrc
            rec["est_vs_measured"] = ("measured" if ksrc == "measured"
                                      else "estimate")
        elif any(c.kind == "coo_leaf" for c in n.children):
            # before sparse_leaf, in Lowerer._matmul's order
            rec["dispatch"] = ("coo_spmv" if _coo_narrow_matmul(n)
                               else "densify")
        elif any(c.kind == "sparse_leaf" for c in n.children):
            rec["dispatch"] = "spmm"
            if getattr(mesh, "ranked", False):
                from matrel_tpu_torch import executor as _exec
                rec["spmm_ranks"] = _exec.spmm_rank_split(n, mesh)
        else:
            la = infer_layout(a, mesh, lmemo, cfg)
            lb = infer_layout(b, mesh, lmemo, cfg)
            rec["layouts"] = [la, lb]
            try:
                # raw byte-equivalents (flat weights), summable as bytes
                rec["est_ici_bytes"] = comm_cost(
                    rec["strategy"], nn, kk, mm, a.density, b.density,
                    gx, gy, a_layout=la, b_layout=lb,
                    alpha_bytes=cfg.comm_alpha_bytes)
                rec["est_axis_bytes"] = list(comm_cost_axes(
                    rec["strategy"], nn, kk, mm, a.density, b.density,
                    gx, gy, a_layout=la, b_layout=lb, weights=wts))
                if wts[0] != wts[1]:
                    # what the weighted ranking minimised: its own field
                    rec["est_weighted_cost"] = comm_cost(
                        rec["strategy"], nn, kk, mm, a.density,
                        b.density, gx, gy, a_layout=la, b_layout=lb,
                        alpha_bytes=cfg.comm_alpha_bytes, weights=wts)
                    rec["axis_weights"] = list(wts)
                    rec["topology_source"] = "config"
                if cfg.reshard_peak_budget_bytes > 0:
                    # the staged moves this product's lowering compiles
                    # (the one derivation the executor shares)
                    from matrel_tpu_torch.parallel import reshard as _resh
                    rr = _resh.moves_record(_resh.staged_matmul_moves(
                        n, mesh, cfg, lmemo, dmemo))
                    if rr is not None:
                        rec["reshard"] = rr
            except ValueError:       # an override the model doesn't know
                rec["est_ici_bytes"] = None
        ivm = root.attrs.get("ivm_patch")
        if isinstance(ivm, dict):
            # a delta-patch plan (serve/ivm.py stamps the root): the
            # pricing that chose patching over recompute
            rec["delta_rule"] = ivm.get("rule")
            rec["delta_est_saved_flops"] = ivm.get("est_saved_flops")
        fr = fused_of.get(n.uid)
        if fr is not None:
            # the anchored region's boundary; a SpGEMM anchor's
            # est_saved_hbm_bytes (saved vs densify) keeps its meaning
            rec["fused_region"] = fr.get("fused_region")
            rec["fused_census"] = dict(fr.get("fused_census") or {})
            rec["est_saved_dispatches"] = fr.get("fused_saved_dispatches")
            rec.setdefault("est_saved_hbm_bytes",
                           fr.get("fused_saved_hbm_bytes"))
        out.append(rec)

    walk(root)
    return out
