"""Executor — the counterpart of ``matrel_tpu/executor.py``.

Lowers an optimized, annotated MatExpr into a function over the leaf
tensors: each matmul goes to its planned strategy (one local product on
one card), the block-sparse operand to the SpMM kernel route, a COO
operand against a narrow dense one to the compact SpMV/SpMM kernel route
(``_coo_spmv_stack``), and everything else to torch ops. PyTorch runs
eagerly, so nothing stands in for ``jax.jit``: ``compile_expr`` plans
once and the returned :class:`CompiledPlan` re-runs the lowered
function — through ``run`` (rebindings as BlockMatrices), or through
``bound_runner``, the iteration path (raw padded tensors in and out,
the leaf layout resolved once). ``CompiledPlan.collectives`` counts
the collectives one run issues, under the JAX package's HLO names.

Zero-padding invariant: every lowered intermediate is exactly 0 outside
its logical region; ops that would break it (scalar-add, pow ≤ 0,
broadcast add/sub/div) re-mask, and aggregates mask padding where zeros
would change the answer (max/min).

An S×S matmul (block-sparse or COO leaves on both sides, any mix)
whose estimated output block density is below
``config.spgemm_density_threshold`` lowers through the tile-intersection
SpGEMM (``ops/spgemm.py``) with the planner's ``spgemm_kernel`` stamp;
above it, the densify fallthrough runs.

``solve``/``inverse`` are dense local solves on the logical shape (LU,
or Cholesky under ``assume="pos"``), in f32 with TF32 off.
:func:`compile_exprs` lowers several roots into one :class:`MultiPlan`
with one memo per call, so shared subexpressions (the Xᵀ of the normal
equations' XᵀX and Xᵀy) are computed once.

The relational nodes lower too: σ (select_value, select_index,
select_block) as masks, join_index as an elementwise merge, join_rows /
join_cols as a pairwise merge along the non-join axis (the planner's
join scheme is stamped, and on one card no placement applies), and
join_value as the capped pair matrix — or, under an aggregate, streamed
without the pairs (``relational/value_join.py``). Their size guards
raise before the operands are evaluated.

Lowered kinds: leaf, sparse_leaf, coo_leaf, transpose, matmul, solve,
inverse, elemwise, scalar, agg, vec, rank1, select_value, select_index,
select_block, join_index, join_value, join_rows, join_cols. Any other
kind raises ``NotPortedError``. With ``config.autotune`` on, both
compile paths measure the SpMV executor variant of every COO plan the
plan dispatches (``parallel/autotune.lookup_or_measure_spmv``) and the
lowering obeys a measured "compact" or "expanded"
(``Lowerer.spmv_choice``).

Whole-plan fusion (``config.fusion_enable``, ``ir/fusion.py``): both
compile paths stamp the fusable regions after the strategies, and a
stamped root lowers through ``Lowerer._eval_region`` — one member
evaluator for the region body and the epilogue, the member chain above
the anchor matmul handed to its epilogue slot (the SpGEMM hook over
B4–B7's tiles, ``spmm.apply``'s slot over B1's output, the finished
output of the COO SpMV stack over B2, ``strategies.run_matmul``'s slot
after the storage cast). ``compile_staged_units`` / ``compile_region_units``
emit the plan as a sequence of unit programs (one Python callable over
tensors each): one per physical op, or one per fused region.

Staged reshards (``config.reshard_peak_budget_bytes`` > 0,
``parallel/reshard.py``): the lowering compiles the ReshardPlan of
every dense matmul operand re-lay and of every root's canonical re-lay,
once per plan; on one card applying one is the identity, on a rank mesh
each step moves the blocks.

On a rank mesh (``core/mesh.init_distributed``) every rank runs the same
plan over its blocks (``collectives.Shard``), as the JAX package's GSPMD
partitions it. A dense matmul runs its stamped recipe
(``strategies.run_ranked``); S·D runs B1 on the rank's column slice of
D where ``spmm.rank_split`` allows (``Lowerer._spmm``), the product a
Shard by columns; a COO operand against a narrow dense one runs B2/B3
on the rank's slice of block rows, then one all-gather (the JAX
package's ``_coo_compact_sharded``). Elementwise, scalar, σ, index
joins and rank1 run on the rank's block (a Shard of another layout
relays to the first one's; a whole tensor is cut; index predicates and
re-masks read the block's global offsets); aggregates reduce the block,
then across the group that splits the reduced dim
(``collectives.axis_reduce``); row / col joins merge each rank's slice
of the join axis under the planner's scheme (``_join_axis_ranked``);
value joins split the query side (``_value_join_shares``, the pair
matrix by rows). What needs every entry gathers it whole through one
counted call (``collectives.gather_full``, tallied as ``gather_rep``):
solve and inverse (local dense solves, as the JAX package's), vec, a
broadcast vector, rank1's vectors, a "left" / "right" join's replicated
operand, a value join's entry vectors. Fused regions run their epilogue
on the rank's block of the anchor output; unit programs run over the
leaves' Shards; a root is cut to its canonical blocks.
"""

from __future__ import annotations

import dataclasses
import math
import time
from collections import Counter
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import MatrelConfig, NotPortedError, default_config
from matrel_tpu_torch.core import mesh as mesh_lib, padding
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import Mesh
from matrel_tpu_torch.ir import expr as expr_mod, rules
from matrel_tpu_torch.ir.expr import MatExpr, leaves as expr_leaves
from matrel_tpu_torch.obs import trace as trace_lib
from matrel_tpu_torch.parallel import planner, strategies
from matrel_tpu_torch.resilience import faults as faults_lib
from matrel_tpu_torch.utils.profiling import annotate

Tensor = torch.Tensor

#: Is a profiler recording? (one C call; the per-node range and label
#: are built only then)
_profiling = torch.autograd._profiler_enabled

LOWERED_KINDS = ("leaf", "sparse_leaf", "coo_leaf", "transpose", "matmul",
                 "solve", "inverse", "elemwise", "scalar", "agg", "vec",
                 "rank1", "select_value", "select_index", "select_block",
                 "join_index", "join_value", "join_rows", "join_cols")

# Narrow-operand threshold for the COO SpMV dispatch. The planner calls
# _coo_dispatch_plan itself (not this constant) so the plan-refusal
# fallback is honoured too.
COO_NARROW_MAX = 128


def _mask_to_logical(x: Tensor, shape: Tuple[int, int],
                     off: Tuple[int, int] = (0, 0)) -> Tensor:
    """Zero out everything outside the logical region; ``off`` is the
    global (row, col) of ``x``'s first entry (a rank's block)."""
    if off[0] + x.shape[0] <= shape[0] and off[1] + x.shape[1] <= shape[1]:
        return x
    return torch.where(padding.valid_mask(shape, tuple(x.shape), x.device, off), x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


#: jnp.sum's result dtype where it differs from torch.sum's int64: bool and
#: integers of up to 32 bits sum into int32 (signed) or uint32 (unsigned).
_JNP_SUM_DTYPE = {torch.bool: torch.int32, torch.int8: torch.int32,
                  torch.int16: torch.int32, torch.int32: torch.int32,
                  torch.uint8: torch.uint32, torch.uint16: torch.uint32,
                  torch.uint32: torch.uint32}


def _jnp_sum(x: Tensor, dim: Optional[int]) -> Tensor:
    """torch.sum with jnp.sum's result dtype. The int64 sum is cast down,
    which wraps modulo 2^32 as a 32-bit accumulator does (torch has no
    uint32 sum)."""
    s = x.sum() if dim is None else x.sum(dim=dim)
    dt = _JNP_SUM_DTYPE.get(x.dtype)
    return s if dt is None else s.to(dt)


def _unsigned_via_int64(lower, node: MatExpr, ev) -> Tensor:
    """``lower(node, ev)`` where torch lacks the op for an unsigned
    operand (uint16 and uint32, as jnp sums give them: torch has no add,
    min, max or pow for them): such operands are widened to int64 and an
    int64 result is cast back, which wraps modulo 2^32 as jnp's 32-bit
    arithmetic does. A Shard widens and narrows its block."""
    unsigned = []

    def widen(t):
        if t.dtype in (torch.uint16, torch.uint32):
            unsigned.append(t.dtype)
            t = t.to(torch.int64)
        return t

    def ev_wide(child: MatExpr) -> Tensor:
        return widen(ev(child))

    ev_wide.value = lambda child: widen(ev.value(child))
    out = lower(node, ev_wide)
    if unsigned and out.dtype == torch.int64:
        out = out.to(max(unsigned, key=lambda d: d.itemsize))
    return out


def _diag_reduce(d: Tensor, kind: str) -> Tensor:
    """sum/count/avg/max/min of a 1-D entry vector."""
    if kind == "sum":
        return d.sum()
    if kind == "count":
        return (d != 0).sum().to(d.dtype)
    if kind == "avg":
        c = (d != 0).sum()
        return torch.where(c > 0, d.sum() / c.clamp(min=1),
                           torch.zeros((), device=d.device)).to(d.dtype)
    if kind == "max":
        return d.max()
    if kind == "min":
        return d.min()
    raise NotImplementedError(kind)


def _mask(cond, device) -> Tensor:
    """A user predicate's result as a boolean tensor (jnp.where reads any
    nonzero as true; torch.where wants bool)."""
    t = torch.as_tensor(cond, device=device)
    return t if t.dtype == torch.bool else t != 0


def _index(n: int, device, start: int = 0) -> Tensor:
    """Row/col indices for index predicates, int32 like jnp.arange, so
    integer arithmetic in a predicate wraps as the JAX package's does;
    ``start`` is a rank's block's global offset."""
    return torch.arange(start, start + n, dtype=torch.int32, device=device)


def _region_info(root: MatExpr):
    """(members, anchor or None, epilogue is elementwise) of a stamped
    region root — what ``Lowerer._eval_region`` reads on every run."""
    from matrel_tpu_torch.ir import fusion as fusion_lib
    members = fusion_lib.region_nodes(root)
    anchor_uid = root.attrs.get("fused_anchor")
    anchor = members.get(anchor_uid) if anchor_uid is not None else None
    if anchor is None or anchor.uid == root.uid:
        return members, None, False
    return members, anchor, fusion_lib.epilogue_elementwise_chain(
        root, members, anchor.uid)


def _gather_rep(value, mesh) -> Tensor:
    """A Shard gathered whole on every rank for a lowering that runs
    locally: one counted call (``gather_rep`` in the tally)."""
    from matrel_tpu_torch.parallel import collectives as coll
    coll.TALLY[("exec", "gather_rep", "world")] += 1
    return coll.gather_full(value, mesh)


def _evaluator(value: Callable, mesh: Mesh, whole: Dict[int, Tensor]):
    """The two faces of a node's value a lowering asks for:
    ``ev.value(node)`` as lowered (a Shard stays a Shard) and
    ``ev(node)`` whole — a Shard gathered once (``_gather_rep``,
    memoised in ``whole``) for the lowerings that need every entry
    (solve, inverse, vec, a value join's entry vectors, a broadcast
    vector, a replicated join operand)."""
    ranked = mesh.ranked

    def ev(node: MatExpr) -> Tensor:
        out = value(node)
        if not ranked or isinstance(out, Tensor):
            return out
        if node.uid not in whole:
            whole[node.uid] = _gather_rep(out, mesh)
        return whole[node.uid]

    ev.value = value
    return ev


def _same(v):
    return v


def _t(v):
    """The transpose of a tensor or a Shard (no data moves)."""
    return v.T if isinstance(v, Tensor) else v.t()


#: The layout of a value every rank holds whole.
_WHOLE = ((), ())


class ShardLayoutError(ValueError):
    """A sharded lowering met operands whose blocks it cannot line up
    (their padded shapes differ)."""


def _op_label(node: MatExpr, region: bool) -> str:
    """A node's profiler / analyze label — the JAX package's: the
    region signature for a fused region, else the kind, a matmul's
    strategy and its precision tier."""
    if region:
        return f"fused:{node.attrs['fused_region']}"
    label = node.kind
    if node.kind == "matmul":
        label += ":" + node.attrs.get("strategy", "xla")
        tier = node.attrs.get("precision_tier")
        if tier is not None:
            label += f"@{tier}"
    return label


def _device_sync(mesh: Mesh) -> None:
    """Wait for the mesh's device (analyze mode only; nothing on the
    CPU, whose ops are synchronous)."""
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)  # matlint: disable=ML001 analyze-mode op_hook only (Lowerer.op_hook set), never a served query


def _pad_to(out: Tensor, pshape: Tuple[int, int]) -> Tensor:
    if tuple(out.shape) == tuple(pshape):
        return out
    return torch.nn.functional.pad(
        out, (0, pshape[1] - out.shape[1], 0, pshape[0] - out.shape[0]))


class Lowerer:
    """Recursively lowers MatExpr nodes to torch ops over padded tensors."""

    def __init__(self, mesh: Mesh, config: MatrelConfig,
                 op_hook: Optional[Callable] = None):
        self.mesh = mesh
        self.config = config
        # analyze-mode per-op hook: callable(node, label, seconds),
        # invoked after each node's evaluation WITH a device sync
        # (obs/analyze.py sets it; compile_expr never does, so the
        # query path stays sync-free)
        self.op_hook = op_hook
        # staged-reshard bookkeeping (budget > 0 only): layout/dtype
        # memos for the planner walks and the compiled moves, per node
        # uid (operand moves) or root uid (the root relay), so a
        # re-run compiles nothing
        self._lay_memo: Dict[int, str] = {}
        self._dt_memo: Dict[int, object] = {}
        self.staged_moves: Dict[int, list] = {}
        self.root_relays: Dict[int, object] = {}
        # fused-region root uid -> (members, anchor, epilogue is
        # elementwise): derived once per plan, not per run
        self._regions: Dict[int, tuple] = {}
        # id(plan) -> (plan, measured SpMV executor variant "compact" |
        # "expanded"), filled at compile time by the autotune loop; empty
        # = the hand defaults decide. The entry holds the plan itself and
        # a read checks identity, so a recycled id never misroutes.
        self.spmv_choice: Dict[int, Tuple[object, str]] = {}

    def _spmv_forced(self, plan) -> Optional[str]:
        """The measured executor variant forced for this plan object, or
        None (also for an id whose stored plan is another object)."""
        entry = self.spmv_choice.get(id(plan))
        return entry[1] if entry is not None and entry[0] is plan else None

    def lower(self, root: MatExpr, leaf_order: List[MatExpr]) -> Callable:
        """A function of the leaf tensors (in ``leaf_order``) returning
        the root's padded, contiguous value."""
        multi = self.lower_multi((root,), leaf_order)

        def fn(*leaf_arrays: Tensor) -> Tensor:
            return multi(*leaf_arrays)[0]

        return fn

    def lower_multi(self, roots, leaf_order: List[MatExpr]) -> Callable:
        """Several roots in one function with a SHARED memo: common
        subexpressions (by node identity) are computed once per call —
        e.g. XᵀX and Xᵀy of the normal equations share Xᵀ. Returns a
        tuple of padded, contiguous root values."""
        leaf_pos = {l.uid: i for i, l in enumerate(leaf_order)}
        pshapes = [padding.padded_shape(r.shape, self.mesh) for r in roots]
        ranked = self.mesh.ranked
        fused = self.config.fusion_enable
        cfg = self.config
        hook = self.op_hook
        if self.config.reshard_peak_budget_bytes > 0:
            for r in roots:
                self._stage_root_relay(r, None)

        def fn(*leaf_arrays: Tensor) -> Tuple[Tensor, ...]:
            memo: Dict[int, Tensor] = {}
            whole: Dict[int, Tensor] = {}
            # analyze-mode bookkeeping: a node's window contains its
            # children's, so each frame tracks child time and reports
            # the EXCLUSIVE remainder
            child_time: List[float] = []

            def value(node: MatExpr):
                """The node's value as lowered: a Shard on a rank mesh
                where the lowering keeps it sharded, else a tensor."""
                if node.uid not in memo:
                    # fault site "lower" (resilience/faults.py): one
                    # attribute read when injection is off
                    faults_lib.check("lower", cfg)
                    region = fused and "fused_region" in node.attrs
                    if hook is None and not _profiling():
                        out = self._eval_node(node, region, ev,
                                              leaf_arrays, leaf_pos)
                    else:
                        out = self._eval_observed(node, region, ev,
                                                  leaf_arrays, leaf_pos,
                                                  child_time)
                    memo[node.uid] = out
                return memo[node.uid]

            ev = _evaluator(value, self.mesh, whole)

            def root_out(r: MatExpr, ps) -> Tensor:
                if ranked:
                    return self._ranked_root(r, value(r), ps)
                out = _pad_to(ev(r), ps)
                if r.uid in self.root_relays:
                    out = self._stage_root_relay(r, out)
                return out.contiguous()

            try:
                return tuple(root_out(r, ps)
                             for r, ps in zip(roots, pshapes))
            finally:
                # value and ev refer to each other, so without this the
                # memo (every intermediate, the results included) and the
                # leaf tensors would outlive the call until the garbage
                # collector breaks the cycle: rebinding ev breaks it, and
                # the leaves go at return (bound_runner's donate promise)
                memo.clear()
                whole.clear()
                ev = None

        return fn

    def _eval_node(self, node: MatExpr, region: bool, ev, leaf_arrays,
                   leaf_pos):
        """One node's evaluation: a fused region (ir/fusion.py stamp)
        as one evaluation of its whole member set, else the node."""
        if region:
            return self._eval_region(node, ev, leaf_arrays, leaf_pos)
        return self._eval(node, ev, leaf_arrays, leaf_pos)

    def _eval_observed(self, node: MatExpr, region: bool, ev,
                       leaf_arrays, leaf_pos, child_time: list):
        """:meth:`_eval_node` under the node's profiler range
        ``matrel.<label>`` (the JAX package's per-operator
        ``annotate``) and, in analyze mode, timed exclusive of its
        children between two device syncs — the one sanctioned sync of
        the lowering path, reached only through ``op_hook``."""
        label = _op_label(node, region)
        hook = self.op_hook
        if hook is not None:
            child_time.append(0.0)
            _device_sync(self.mesh)
            t0 = time.perf_counter()  # matlint: disable=ML006 analyze-mode op_hook measurement — lands in analyze events
        with annotate(f"matrel.{label}"):
            out = self._eval_node(node, region, ev, leaf_arrays, leaf_pos)
        if hook is not None:
            _device_sync(self.mesh)
            dt = time.perf_counter() - t0  # matlint: disable=ML006 analyze-mode op_hook measurement
            spent_in_children = child_time.pop()
            if child_time:
                child_time[-1] += dt
            hook(node, label, max(dt - spent_in_children, 0.0))
        return out

    def _ranked_root(self, r: MatExpr, out, ps) -> Tensor:
        """This rank's block of a root under its canonical spec: a whole
        value is cut (no collective), a Shard moves — through the
        root's staged relay where one was compiled."""
        from matrel_tpu_torch.parallel import collectives as coll
        spec = padding.canonical_spec(ps, self.mesh)
        if isinstance(out, Tensor):
            return coll.shard_from_full(_pad_to(out, ps), spec,
                                        self.mesh).local
        if r.uid in self.root_relays:
            out = self._stage_root_relay(r, out)
        return coll.relay(out, spec, self.mesh).local.contiguous()

    # -- per-node lowering --------------------------------------------------

    def _eval(self, node: MatExpr, ev, leaf_arrays, leaf_pos) -> Tensor:
        k = node.kind
        if k == "leaf":
            return leaf_arrays[leaf_pos[node.uid]]
        if k == "sparse_leaf":
            # densify when a sparse matrix is used outside a matmul; the
            # SpMM path handles the matmul case
            bm = node.attrs["matrix"].to_dense(self.config)
            return bm.as_shard() if self.mesh.ranked else bm.data
        if k == "coo_leaf":
            # same densify fallback for element-sparse leaves; narrow
            # matmuls take the SpMV path in _matmul
            bm = node.attrs["matrix"].to_block(self.mesh, self.config)
            return bm.as_shard() if self.mesh.ranked else bm.data
        if k == "transpose":
            if self.mesh.ranked:
                v = ev.value(node.children[0])
                return v.t() if not isinstance(v, Tensor) else v.T
            return ev(node.children[0]).T
        if k == "matmul":
            return self._matmul(node, ev)
        if k == "solve":
            return self._solve(node, ev)
        if k == "inverse":
            return self._inverse(node, ev)
        if k == "elemwise":
            return _unsigned_via_int64(self._elemwise, node, ev)
        if k == "scalar":
            return _unsigned_via_int64(self._scalar, node, ev)
        if k == "agg":
            return _unsigned_via_int64(self._agg, node, ev)
        if k == "vec":
            return self._vec(node, ev)
        if k == "rank1":
            return _unsigned_via_int64(self._rank1, node, ev)
        if k == "select_value":
            x, off, wrap = self._block(node.children[0], ev)
            pred, fill = node.attrs["predicate"], node.attrs["fill"]
            out = torch.where(_mask(pred(x), x.device), x,
                              torch.tensor(fill, dtype=x.dtype,
                                           device=x.device))
            if fill != 0.0:
                out = _mask_to_logical(out, node.shape, off)
            return wrap(out)
        if k == "select_index":
            return self._select_index(node, ev)
        if k == "select_block":
            x, off, wrap = self._block(node.children[0], ev)
            bs = node.attrs["block_size"]
            pn, pm = x.shape
            bi = (_index(pn, x.device, off[0]) // bs)[:, None]
            bj = (_index(pm, x.device, off[1]) // bs)[None, :]
            return wrap(torch.where(
                _mask(node.attrs["predicate"](bi, bj), x.device), x,
                torch.zeros((), dtype=x.dtype, device=x.device)))
        if k == "join_index":
            a, b, off, wrap = self._pair(node, ev)
            return wrap(_mask_to_logical(node.attrs["merge"](a, b),
                                         node.shape, off))
        if k == "join_value":
            return self._join_value(node, ev)
        if k in ("join_rows", "join_cols"):
            return self._join_axis(node, ev)
        raise NotPortedError(
            f"lowering for node kind {k!r} is not ported to "
            f"matrel_tpu_torch yet (ported: {', '.join(LOWERED_KINDS)})")

    def _eval_region(self, root: MatExpr, ev, leaf_arrays,
                     leaf_pos) -> Tensor:
        """Lower one FUSED REGION (ir/fusion.py stamp) as one evaluation:
        members lower through ``_eval``, region inputs (non-member
        children) through the outer ``ev`` and its memo. The member
        chain ABOVE the anchor matmul is composed into an epilogue
        callable and handed to the producing kernel's epilogue slot, so
        fused and staged lowerings run the same member code on the same
        values (every re-mask of the zero-padding invariant runs where
        the staged path runs it)."""
        info = self._regions.get(root.uid)
        if info is None:
            info = self._regions[root.uid] = _region_info(root)
        members, anchor, epi_ew = info

        def make_lev(env: Dict[int, object], whole: Dict[int, Tensor]):
            """ONE member evaluator for the region body and the
            epilogue closure, so the two never diverge: a dict holding it
            under "lev", which the caller clears on the way out."""
            handle: Dict[str, Callable] = {}

            def value(n: MatExpr):
                out = env.get(n.uid)
                if out is not None:
                    return out
                if n.uid not in members:
                    out = ev.value(n)          # region input
                else:
                    out = self._eval(n, handle["lev"], leaf_arrays,
                                     leaf_pos)
                env[n.uid] = out
                return out

            handle["lev"] = _evaluator(value, self.mesh, whole)
            return handle

        # lev refers to itself through its handle, so each env and handle
        # are cleared on the way out: left to the garbage collector, the
        # intermediates and the leaf tensors they hold would outlive the
        # call (the lower_multi memo's rule)
        env: Dict[int, object] = {}
        whole: Dict[int, Tensor] = {}
        handle = make_lev(env, whole)
        lev = handle["lev"]
        try:
            if anchor is None:
                return lev.value(root)

            def epilogue(x):
                # x: the anchor's output — on a rank mesh this rank's
                # block (a Shard) where the anchor keeps it sharded, so
                # the chain's re-masks read the block's global offsets
                env2 = dict(env)
                env2[anchor.uid] = x
                whole2: Dict[int, Tensor] = {}
                handle2 = make_lev(env2, whole2)
                try:
                    return handle2["lev"].value(root)
                finally:
                    env2.clear()
                    whole2.clear()
                    handle2.clear()

            # the anchor's lowering consumes the epilogue: its output is
            # the region root's value (operand prologues below the anchor
            # lower through lev when the anchor evaluates its children)
            return self._matmul(anchor, lev, epilogue=epilogue,
                                epilogue_elementwise=epi_ew)
        finally:
            env.clear()
            whole.clear()
            handle.clear()

    def _pad_to_node(self, out: Tensor, node: MatExpr) -> Tensor:
        return _pad_to(out, padding.padded_shape(node.shape, self.mesh))

    # -- blocks on a rank mesh ----------------------------------------------

    def _block(self, child: MatExpr, ev):
        """(tensor, global (row, col) offset of its first entry, wrap):
        a child's value as a lowering runs on it — this rank's block of
        a Shard (``wrap`` makes the result a Shard of the same layout),
        else the whole tensor at (0, 0)."""
        v = ev.value(child)
        if isinstance(v, Tensor):
            return v, (0, 0), _same
        from matrel_tpu_torch.parallel import collectives as coll
        r0, _, c0, _ = coll.block_rect(v, self.mesh)
        return v.local, (r0, c0), (
            lambda t: coll.Shard(t, v.layout, v.pshape))

    def _align(self, v, ref) -> Tensor:
        """This rank's block of ``v`` (a whole tensor or a Shard) under
        Shard ``ref``'s layout: a whole tensor is cut (no collective), a
        Shard of another layout moves through one counted
        ``collectives.relay``."""
        from matrel_tpu_torch.parallel import collectives as coll
        if isinstance(v, Tensor):
            if tuple(v.shape) != tuple(ref.pshape):
                raise ShardLayoutError(
                    f"a whole {tuple(v.shape)} operand cannot meet a "
                    f"{ref.pshape} Shard")
            return coll.local_of(v, ref.layout, self.mesh)
        if tuple(v.pshape) != tuple(ref.pshape):
            raise ShardLayoutError(f"Shards of padded shapes {v.pshape} "
                                   f"and {ref.pshape} cannot line up")
        if v.layout != ref.layout:
            v = coll.relay(v, ref.layout, self.mesh)
        return v.local

    def _pair(self, node: MatExpr, ev):
        """(a, b, offset, wrap) for a same-shaped binary op: both whole,
        or both this rank's block under the first Shard's layout."""
        l, r = node.children
        va, vb = ev.value(l), ev.value(r)
        if isinstance(va, Tensor) and isinstance(vb, Tensor):
            return va, vb, (0, 0), _same
        from matrel_tpu_torch.parallel import collectives as coll
        ref = va if not isinstance(va, Tensor) else vb
        r0, _, c0, _ = coll.block_rect(ref, self.mesh)
        return (self._align(va, ref), self._align(vb, ref), (r0, c0),
                lambda t: coll.Shard(t, ref.layout, ref.pshape))

    def _select_index(self, node: MatExpr, ev) -> Tensor:
        x, off, wrap = self._block(node.children[0], ev)
        rows, cols = node.attrs["rows"], node.attrs["cols"]
        pn, pm = x.shape
        keep = torch.ones((), dtype=torch.bool, device=x.device)
        if rows is not None:
            keep = keep & _mask(rows(_index(pn, x.device, off[0])),
                                x.device)[:, None]
        if cols is not None:
            keep = keep & _mask(cols(_index(pm, x.device, off[1])),
                                x.device)[None, :]
        return wrap(torch.where(keep, x, torch.zeros((), dtype=x.dtype,
                                                     device=x.device)))

    def _join_axis(self, node: MatExpr, ev) -> Tensor:
        """Row/col index joins: the statically shaped pairwise merge along
        the non-join axis. The planner's ``attrs["replicate"]``
        (choose_join_scheme) names the scheme. On one card both
        operands are whole on the device, so no placement applies; on a
        rank mesh :meth:`_join_axis_ranked` places them by it."""
        out_entries = node.shape[0] * node.shape[1]
        cap = self.config.join_pair_cap_entries
        if out_entries > cap:
            raise ValueError(
                f"row/col join output has {node.shape[0]}x"
                f"{node.shape[1]} = {out_entries} entries (> "
                f"join_pair_cap_entries = {cap}); select/aggregate the "
                f"operands first or raise the cap in MatrelConfig.")
        if self.mesh.ranked:
            out = self._join_axis_ranked(node, ev)
            if out is not None:
                return out
        l, r = node.children
        a = ev(l)[: l.shape[0], : l.shape[1]]
        b = ev(r)[: r.shape[0], : r.shape[1]]
        return self._pad_to_node(self._merge_axis(node, a, b), node)

    @staticmethod
    def _merge_axis(node: MatExpr, a: Tensor, b: Tensor) -> Tensor:
        """The pairwise merge of a row (col) join over operands cut to
        their logical columns (rows) — whole, or one slice of the join
        axis."""
        l, r = node.children
        merge = node.attrs["merge"]
        if node.kind == "join_rows":
            out = merge(a[:, :, None], b[:, None, :])       # (n, ma, mb)
            return out.reshape(a.shape[0], l.shape[1] * r.shape[1])
        out = merge(a[:, None, :], b[None, :, :])           # (na, nb, m)
        return out.reshape(l.shape[0] * r.shape[0], a.shape[1])

    def _join_axis_ranked(self, node: MatExpr, ev):
        """A row/col join on a rank mesh, as the JAX package places it
        (``matrel_tpu/executor.py`` ``_join_axis``): every rank merges
        its slice of the join axis (the 1-D layout along it). Under
        "left" / "right" that operand is gathered whole (one counted
        ``gather_rep``) and cut to the slice; the other, and both under
        "align", are re-laid 1-D along the join axis — no whole operand
        moves. The result stays a Shard in that layout. None where the
        padded join axis does not split over the ranks (a 1-long axis):
        the caller's counted whole route."""
        from matrel_tpu_torch.parallel import collectives as coll
        rows = node.kind == "join_rows"
        l, r = node.children
        ext = l.shape[0] if rows else l.shape[1]
        pj = padding.pad_dim(ext, self.mesh.size)
        if pj % self.mesh.size or pj < self.mesh.size:
            return None
        line = coll.STATES["row" if rows else "col"]
        rep = node.attrs.get("replicate")

        def slice_of(c: MatExpr, replicated: bool) -> Tensor:
            if replicated:
                return coll.local_of(ev(c), line, self.mesh)
            v = ev.value(c)
            if isinstance(v, Tensor):
                return coll.local_of(v, line, self.mesh)
            return coll.relay(v, line, self.mesh).local

        a = slice_of(l, rep == "left")
        b = slice_of(r, rep == "right")
        pshape = padding.padded_shape(node.shape, self.mesh)
        j0 = coll.rect(line, self.mesh.ranks.coords, self.mesh.grid,
                       (pj, pj))[0 if rows else 2]
        if rows:
            out = self._merge_axis(node, a[:, : l.shape[1]],
                                   b[:, : r.shape[1]])
            out = _mask_to_logical(out, (node.shape[0], out.shape[1]),
                                   (j0, 0))
            out = _pad_to(out, (out.shape[0], pshape[1]))
        else:
            out = self._merge_axis(node, a[: l.shape[0]], b[: r.shape[0]])
            out = _mask_to_logical(out, (out.shape[0], node.shape[1]),
                                   (0, j0))
            out = _pad_to(out, (pshape[0], out.shape[1]))
        return coll.Shard(out, line, pshape)

    def _entry_vectors(self, node: MatExpr, ev):
        """Column-major logical-entry vectors (va, vb) of a join_value
        node's operands (the pair matrix's row/col coordinates) as f32,
        plus the dtype the dense lowering would produce (operand
        promotion), so the streamed result is cast to match it."""
        l, r = node.children
        a, b = ev(l), ev(r)
        va = a[: l.shape[0], : l.shape[1]].T.reshape(-1)
        vb = b[: r.shape[0], : r.shape[1]].T.reshape(-1)
        out_dtype = torch.promote_types(a.dtype, b.dtype)
        return va.float(), vb.float(), out_dtype

    def _agg_join_value(self, node: MatExpr, jnode: MatExpr, ev) -> Tensor:
        """agg(join_on_value(A, B)) without the (na, nb) pair matrix:
        sort-based O((na+nb)·log nb) for structured predicate+merge,
        bounded chunkwise enumeration for black-box callables (capped),
        elementwise for the diagonal."""
        from matrel_tpu_torch.relational import value_join as vj
        kind, axis = node.attrs["agg"], node.attrs["axis"]
        merge_fn = jnode.attrs["merge"]
        pred_fn = jnode.attrs["predicate"]
        pred_kind = jnode.attrs.get("pred_kind")
        merge_kind = jnode.attrs.get("merge_kind")
        na, nb = jnode.shape
        structured = (merge_kind is not None
                      and (pred_kind is not None or pred_fn is None)
                      and kind in vj.AGG_KINDS)
        if (axis != "diag" and not structured
                and na * nb > self.config.join_bruteforce_max_pairs):
            # guard BEFORE evaluating the operands
            raise ValueError(
                f"aggregated value-join with callable merge/"
                f"predicate must enumerate {na}x{nb} = {na * nb} "
                f"pairs (> join_bruteforce_max_pairs = "
                f"{self.config.join_bruteforce_max_pairs}). Use "
                f"structured forms (predicate in "
                f"{expr_mod.JOIN_PREDS}, merge in "
                f"{expr_mod.JOIN_MERGES}) for the O(n log n) sort "
                f"path, or raise the cap.")
        va, vb, out_dtype = self._entry_vectors(jnode, ev)
        query_n = na if axis in ("row", "all") else nb
        if (self.mesh.ranked and axis != "diag"
                and query_n >= 128 * self.mesh.size):
            if kind not in vj.AGG_KINDS:
                raise ValueError(f"unknown aggregate {kind!r}")
            # the JAX package's guard (matrel_tpu/executor.py): the query
            # side splits across the ranks, the other side stays whole
            stats = self._value_join_shares(
                va, vb, axis, query_n,
                lambda a, b: (vj.row_stats_sorted(
                    a, b, pred_kind or "always", merge_kind, axis)
                    if structured else vj.row_stats_chunked(
                        a, b, merge_fn, pred_fn, axis,
                        self.config.join_chunk_entries)))
            out = vj.finish(kind, axis, *stats)
            shape = {"row": (-1, 1), "col": (1, -1)}.get(axis, (1, 1))
            return self._pad_to_node(out.reshape(shape).to(out_dtype), node)
        if axis == "diag":
            L = min(na, nb)
            d = merge_fn(va[:L], vb[:L])
            if pred_fn is not None:
                d = torch.where(_mask(pred_fn(va[:L], vb[:L]), d.device), d,
                                torch.zeros((), dtype=d.dtype,
                                            device=d.device))
            out = _diag_reduce(d, kind)
            return self._pad_to_node(out.reshape(1, 1).to(out_dtype), node)
        if structured:
            out = vj.axis_agg_sorted(va, vb, pred_kind or "always",
                                     merge_kind, kind, axis)
        else:
            out = vj.axis_agg_chunked(va, vb, merge_fn, pred_fn, kind,
                                      axis, self.config.join_chunk_entries)
        if axis == "row":
            out = out.reshape(-1, 1)
        elif axis == "col":
            out = out.reshape(1, -1)
        else:
            out = out.reshape(1, 1)
        return self._pad_to_node(out.to(out_dtype), node)

    def _value_join_shares(self, va: Tensor, vb: Tensor, axis: str,
                           query_n: int, stats_of) -> tuple:
        """A value-join aggregate's per-query stats (Σ float64, nonzero
        count, max, min) with the query side split over the ranks: rank
        k computes the k-th equal share of the queries against the whole
        other side (``stats_of(a, b)``), and one all-gather
        (``share_gather``) brings every share to every rank, so the
        finish reads the stats one card computes."""
        from matrel_tpu_torch.parallel import collectives as coll
        size = -(-query_n // self.mesh.size)
        k = self.mesh.ranks.rank
        lo, hi = min(k * size, query_n), min((k + 1) * size, query_n)
        if axis in ("row", "all"):
            s64, nnz, mx, mn = stats_of(va[lo:hi], vb)
        else:
            s64, nnz, mx, mn = stats_of(va, vb[lo:hi])
        pack = torch.stack([s64.double(), nnz.double(), mx.double(),
                            mn.double()], dim=1)
        pack = torch.nn.functional.pad(pack, (0, 0, 0, size - pack.shape[0]))
        got = coll.share_gather(pack, self.mesh)[:query_n]
        return (got[:, 0], got[:, 1].long(), got[:, 2].float(),
                got[:, 3].float())

    def _join_value(self, node: MatExpr, ev) -> Tensor:
        """The materialised value join: the (|A|, |B|) pair matrix with
        merge(va, vb) where the predicate holds, else 0. Capped by
        ``config.join_pair_cap_entries`` (checked before the operands
        are evaluated); aggregate the join to stream it instead."""
        na, nb = node.shape
        cap = self.config.join_pair_cap_entries
        if na * nb > cap:
            raise ValueError(
                f"materialising a {na}x{nb} value-join pair matrix "
                f"({na * nb} entries) exceeds join_pair_cap_entries = "
                f"{cap}. Aggregate the join (e.g. agg(join, 'sum', "
                f"'row')) to stream it without materialisation, or "
                f"raise the cap in MatrelConfig.")
        l, r = node.children
        a, b = ev(l), ev(r)
        va = a[: l.shape[0], : l.shape[1]].T.reshape(-1)
        vb = b[: r.shape[0], : r.shape[1]].T.reshape(-1)
        merge, pred = node.attrs["merge"], node.attrs["predicate"]
        ranked = self.mesh.ranked and na >= 128 * self.mesh.size
        if ranked:
            # the pair matrix's rows split across the ranks (the query
            # side; the JAX package's guard): each rank builds its
            # block of rows against the whole B, and the result stays a
            # Shard — the pair matrix is the value that outgrows a rank
            from matrel_tpu_torch.parallel import collectives as coll
            line = coll.STATES["row"]
            pshape = padding.padded_shape(node.shape, self.mesh)
            i0, i1, _, _ = coll.rect(line, self.mesh.ranks.coords,
                                     self.mesh.grid, pshape)
            va = va[min(i0, na):min(i1, na)]
        A, B = va[:, None], vb[None, :]
        out = merge(A, B)
        if pred is not None:
            out = torch.where(_mask(pred(A, B), out.device), out,
                              torch.zeros((), dtype=out.dtype,
                                          device=out.device))
        if ranked:
            out = torch.as_tensor(out, device=va.device).expand(
                A.shape[0], B.shape[1])
            return coll.Shard(_pad_to(out, (i1 - i0, pshape[1])), line,
                              pshape)
        return self._pad_to_node(out, node)

    def _solve(self, node: MatExpr, ev) -> Tensor:
        """X = A⁻¹·B as a dense solve on the LOGICAL shapes — LU by
        default, Cholesky when attrs["assume"] == "pos" (the caller
        asserts SPD; a non-SPD lhs under "pos" yields NaNs, not the LU
        answer). Padded rows/cols are sliced off first (a zero-padded
        square matrix is singular). A local solve for small/medium
        systems such as the k×k Gram matrix, in f32 with TF32 off, cast
        back when keep_input_dtype asks for it."""
        strategies._highest_precision()
        l, r = node.children
        n, m = l.shape[0], r.shape[1]
        a = ev(l)[:n, :n]
        b = ev(r)[:n, :m]
        if node.attrs.get("assume") == "pos":
            c, info = torch.linalg.cholesky_ex(a.float())
            out = torch.cholesky_solve(b.float(), c)
            out = torch.where(info == 0, out,
                              torch.full((), float("nan"), device=out.device))
        else:
            out = torch.linalg.solve(a.float(), b.float())
        if self.config.keep_input_dtype and a.dtype == b.dtype:
            out = out.to(a.dtype)
        return self._pad_to_node(out, node)

    def _inverse(self, node: MatExpr, ev) -> Tensor:
        """A⁻¹ on the logical shape (see :meth:`_solve` for the padding
        and dtype contract). R7 rewrites A⁻¹·B into solve(A, B)."""
        strategies._highest_precision()
        (c,) = node.children
        n = c.shape[0]
        a = ev(c)[:n, :n]
        out = torch.linalg.inv(a.float())
        if self.config.keep_input_dtype:
            out = out.to(a.dtype)
        return self._pad_to_node(out, node)

    @staticmethod
    def _same_operand(u: MatExpr, v: MatExpr) -> bool:
        """Do two nodes denote the SAME evaluated operand?"""
        if u is v or u.uid == v.uid:
            return True
        return (u.kind == "leaf" and v.kind == "leaf"
                and u.attrs["matrix"] is v.attrs["matrix"])

    def _as_block_sparse(self, leaf_node: MatExpr, bs: int):
        """The BlockSparseMatrix form of an S×S matmul operand: a
        sparse_leaf carries one; a coo_leaf is bucketed into its touched
        tiles (never densified), memoised on the matrix per (block size,
        mesh)."""
        from matrel_tpu_torch.core.sparse import BlockSparseMatrix
        m = leaf_node.attrs["matrix"]
        if leaf_node.kind == "sparse_leaf":
            return m
        memo = getattr(m, "_block_sparse_memo", None)
        if memo is not None and memo[0] == bs and memo[1] is self.mesh:
            return memo[2]
        S = BlockSparseMatrix.from_coo_arrays(
            m.rows, m.cols, m.vals, m.shape, block_size=bs, mesh=self.mesh,
            config=self.config, dtype="float32")
        m._block_sparse_memo = (bs, self.mesh, S)
        return S

    def _spgemm(self, node: MatExpr, epilogue=None,
                epilogue_elementwise: bool = False) -> Tensor:
        """S×S below the density crossover: tile-intersection SpGEMM,
        scattered to the padded dense layout. The kernel comes from the
        planner's ``spgemm_kernel`` stamp; an unstamped node asks the
        shared chooser itself, so the two cannot drift."""
        from matrel_tpu_torch.ops import spgemm as spgemm_lib
        bs = _spgemm_block_size(node, self.config)
        SA = self._as_block_sparse(node.children[0], bs)
        SB = self._as_block_sparse(node.children[1], bs)
        kid = node.attrs.get("spgemm_kernel")
        if kid is None:
            kid, _, _ = spgemm_kernel_choice(node, self.config, self.mesh)
        return spgemm_lib.apply_dense(
            SA, SB, self.config, kernel=kid, epilogue=epilogue,
            epilogue_elementwise=epilogue_elementwise)

    def _matmul(self, node: MatExpr, ev, epilogue=None,
                epilogue_elementwise: bool = False) -> Tensor:
        """``epilogue`` is the fused-region slot (ir/fusion.py): a
        callable applied to this matmul's padded output — the staged
        consumer chain handed to the producing kernel. SpGEMM, SpMM and
        the dense strategies take it through their own slots; every
        other dispatch applies it to the branch's finished output
        (``fin``), so fused and staged lowerings compute the same
        values."""
        fin = (lambda out: out) if epilogue is None else epilogue
        l, r = node.children
        # S×S below the density crossover: SpGEMM. The dispatch predicate
        # is shared with the planner (_spgemm_dispatch).
        if _spgemm_dispatch(node, self.config):
            return self._spgemm(node, epilogue=epilogue,
                                epilogue_elementwise=epilogue_elementwise)
        # coo_leaf matmuls: the SpMV/SpMM kernels for narrow dense
        # operands; wide ones (or refused plans) densify. The dispatch
        # predicate is shared with the planner (_coo_dispatch_plan).
        if l.kind == "coo_leaf":
            A = l.attrs["matrix"]
            plan = _coo_dispatch_plan(node)
            if plan is None:
                blk = A.to_block(self.mesh, self.config)
                blk = blk.as_shard() if self.mesh.ranked else blk.data
                return strategies.run_matmul("xla", blk, self._operand(ev, r),
                                             self.mesh, self.config,
                                             epilogue=epilogue)
            out = self._coo_spmv_stack(plan, ev(r)[: A.shape[1],
                                                   : r.shape[1]])
            return fin(self._pad_to_node(out, node))
        if r.kind == "coo_leaf":
            # X·A = (Aᵀ·Xᵀ)ᵀ through the matrix's cached transpose plan
            S = r.attrs["matrix"]
            plan = _coo_dispatch_plan(node)
            if plan is None:
                blk = S.to_block(self.mesh, self.config)
                blk = blk.as_shard() if self.mesh.ranked else blk.data
                return strategies.run_matmul("xla", self._operand(ev, l), blk,
                                             self.mesh, self.config,
                                             epilogue=epilogue)
            a = ev(l)[: l.shape[0], : l.shape[1]]
            out = self._coo_spmv_stack(plan, a.T).T
            return fin(self._pad_to_node(out, node))
        if l.kind == "sparse_leaf":
            return self._spmm(l.attrs["matrix"], self._operand(ev, r),
                              r.shape, epilogue=epilogue)
        if r.kind == "sparse_leaf":
            # A·S = (Sᵀ·Aᵀ)ᵀ
            out = self._spmm(_sparse_transposed(r.attrs["matrix"]),
                             _t(self._operand(ev, l)),
                             (l.shape[1], l.shape[0]))
            return fin(_t(out))
        if _transposed_sparse(l):
            # Sᵀ·X: B1 over the transposed tile stack, never a densified
            # Sᵀ
            S = l.children[0].attrs["matrix"]
            return self._spmm(_sparse_transposed(S), self._operand(ev, r),
                              r.shape, epilogue=epilogue)
        if _transposed_sparse(r):
            # X·Sᵀ = (S·Xᵀ)ᵀ: the rewrite of t(S·D) into Dᵀ·Sᵀ lands
            # here, and runs B1's S·D on D itself
            out = self._spmm(r.children[0].attrs["matrix"],
                             _t(self._operand(ev, l)),
                             (l.shape[1], l.shape[0]))
            return fin(_t(out))
        gram = None
        if l.kind == "transpose" and self._same_operand(l.children[0], r):
            gram = ("AtA", r)
        elif r.kind == "transpose" and self._same_operand(r.children[0], l):
            gram = ("AAt", l)
        if node.attrs.get("precision_tier") is not None:
            gram = None
        strategy = node.attrs.get("strategy", "xla")
        if gram is not None and self.config.matmul_precision == "high":
            side, base = gram
            x = ev(base)
            if x.dtype == torch.float32:
                # symmetric 2-pass bf16 split for AᵀA / AAᵀ: the cross
                # terms of a Gram are transposes of each other, so one
                # pass becomes a k×k transpose (ops/gram.py)
                from matrel_tpu_torch.ops.gram import symmetric_gram

                def run(p, q):
                    out = strategies.run_matmul(strategy, p, q, self.mesh,
                                                self.config)
                    return (_gather_rep(out, self.mesh) if self.mesh.ranked
                            else out)

                if side == "AtA":
                    mm = lambda p, q: run(p.T, q)
                else:
                    mm = lambda p, q: run(p, q.T)
                return fin(symmetric_gram(x, mm).float())
        a, b = self._operand(ev, l), self._operand(ev, r)
        if self.config.reshard_peak_budget_bytes > 0:
            a, b = self._stage_matmul_operands(node, a, b)
        tier = node.attrs.get("precision_tier")
        if tier is not None and tier != "f32":
            # the tier owns the output dtype (int32 / f32 accumulation);
            # keep_input_dtype does not apply
            from matrel_tpu_torch.ops import precision as precision_lib
            if self.mesh.ranked:
                # the tier's passes run inside the recipe, on the blocks
                return fin(strategies.run_ranked(
                    strategy, a, b, self.mesh,
                    lambda p, q: precision_lib.tiered_matmul(
                        tier, p, q, strategies.local_dot)))
            mm = lambda p, q: strategies.run_matmul(
                strategy, p, q, self.mesh, self.config)
            return fin(precision_lib.tiered_matmul(tier, a, b, mm))

        def storage_epi(out: Tensor) -> Tensor:
            # the keep_input_dtype storage cast runs before the fused
            # epilogue, so the chain sees what the staged consumer sees
            if (self.config.keep_input_dtype and a.dtype == b.dtype
                    and out.dtype != a.dtype):
                out = out.to(a.dtype)
            return fin(out)

        return strategies.run_matmul(strategy, a, b, self.mesh,
                                     self.config, epilogue=storage_epi)

    def _spmm(self, S, d, d_shape, epilogue=None):
        """S·D through B1 (``ops/spmm.py``). On a rank mesh each rank
        runs B1 on its column slice of D where ``spmm.rank_split``
        allows it (the product stays a Shard, laid out by columns), else
        D is gathered whole (one counted ``gather_rep``) and every rank
        runs the whole product — the choice ``plan_matmul_decisions``
        records as ``spmm_ranks``."""
        from matrel_tpu_torch.ops import spmm as spmm_lib
        if self.mesh.ranked:
            pm = padding.pad_dim(d_shape[1], self.mesh.size)
            if spmm_lib.rank_split(S, pm, self.mesh) == "col_slice":
                return spmm_lib.apply_cols(S, d, d_shape, self.mesh,
                                           self.config, epilogue=epilogue)
            if not isinstance(d, Tensor):
                d = _gather_rep(d, self.mesh)
        return spmm_lib.apply(S, d, d_shape, self.config, epilogue=epilogue)

    def _operand(self, ev, node: MatExpr):
        """A dense matmul operand: on a rank mesh as lowered (a Shard
        stays sharded), else the tensor."""
        return ev.value(node) if self.mesh.ranked else ev(node)

    def _stage_root_relay(self, root: MatExpr, out):
        """A root's canonical re-lay through its compiled reshard steps
        (budget > 0 only; ``reshard.root_relay_plan``). The plan is
        compiled once, at lowering time (``out`` None); on one card
        applying it returns ``out``."""
        from matrel_tpu_torch.parallel import reshard as reshard_lib
        if root.uid not in self.root_relays:
            plan = reshard_lib.root_relay_plan(
                root, self.mesh, self.config, self._lay_memo,
                self._dt_memo)
            if plan is None:
                return out
            self.root_relays[root.uid] = plan
        if out is None:
            return None
        return reshard_lib.apply_staged(out, self.root_relays[root.uid],
                                        self.mesh)

    def _stage_matmul_operands(self, node: MatExpr, a: Tensor,
                               b: Tensor) -> Tuple[Tensor, Tensor]:
        """Apply the staged ReshardPlans of a dense matmul's operand
        re-lays (``reshard.staged_matmul_moves``, the derivation shared
        with ``matmul_decisions``), compiled once per node. With
        autotune on, a measured "naive" winner for a move's shape class
        skips its staging."""
        from matrel_tpu_torch.parallel import reshard as reshard_lib
        moves = self.staged_moves.get(node.uid)
        if moves is None:
            moves = reshard_lib.staged_matmul_moves(
                node, self.mesh, self.config, self._lay_memo,
                self._dt_memo)
            self.staged_moves[node.uid] = moves
        arrs = [a, b]
        for i, plan in moves:
            if self.config.autotune:
                from matrel_tpu_torch.parallel import autotune
                if autotune.lookup_or_measure_reshard(
                        plan, self.mesh, self.config) == "naive":
                    continue
            arrs[i] = reshard_lib.apply_staged(arrs[i], plan, self.mesh)
        return arrs[0], arrs[1]

    def _vec(self, node: MatExpr, ev) -> Tensor:
        """Column-major vec of the logical region, then padded rows."""
        (child,) = node.children
        n, m = child.shape
        v = ev(child)[:n, :m].T.reshape(n * m, 1)
        pshape = padding.padded_shape(node.shape, self.mesh)
        if v.shape[0] != pshape[0]:
            v = torch.nn.functional.pad(v, (0, 0, 0, pshape[0] - v.shape[0]))
        return v

    def _rank1(self, node: MatExpr, ev) -> Tensor:
        """A + u·vᵀ over the padded operands (their padding is zero). The
        outer product takes jnp.matmul's result dtype. On a rank mesh A
        keeps its blocks: u and v are gathered whole (vectors) and cut
        to the block's rows and columns."""
        a, off, wrap = self._block(node.children[0], ev)
        u, v = ev(node.children[1]), ev(node.children[2])
        u = u[off[0]: off[0] + a.shape[0]]
        v = v[off[1]: off[1] + a.shape[1]]
        uv = strategies.local_dot(u, v.T)
        return wrap(a + uv.to(torch.promote_types(u.dtype, v.dtype)))

    def _coo_spmv_stack(self, plan, X: Tensor) -> Tensor:
        """A·X for the k columns of ``X`` (n_cols, k) as an (n_rows, k)
        f32 tensor. With ``use_pallas`` the compact-table kernels run over
        the plan's CSR view (one B2 launch for k = 1, one B3 launch
        otherwise — the view's plain walk on the CPU); without it, or
        where the autotune loop measured "expanded" for this plan, the
        expanded one-hot path, in chunks of 64 columns."""
        from matrel_tpu_torch.ops import pallas_spmv as pc
        from matrel_tpu_torch.ops import spmv as spmv_lib
        dev = X.device
        X = X.float()
        static = (plan.n_rows, plan.n_cols, plan.block)
        compact = (pc.compact_enabled(self.config)
                   and self._spmv_forced(plan) != "expanded")
        if self.mesh.ranked:
            # each rank's slice of block rows, one all_gather (the JAX
            # package's _coo_compact_sharded); X arrives replicated
            if compact:
                if X.shape[1] == 1:
                    return pc.compact_sharded_apply(plan, X[:, 0],
                                                    self.mesh)[:, None]
                return pc.compact_sharded_matmat_apply(plan, X, self.mesh)
            if X.shape[1] == 1:
                return spmv_lib.spmv_sharded(plan, X[:, 0],
                                             self.mesh)[:, None]
            return spmv_lib.spmm_sharded(plan, X, self.mesh)
        if compact:
            if X.shape[1] == 1:
                return pc.compact_apply(plan, X[:, 0])[:, None]
            return pc.compact_matmat_apply(plan, X)
        arrays = plan.arrays(dev)
        if X.shape[1] == 1:
            return spmv_lib.spmv_apply(static, arrays, X[:, 0])[:, None]
        extra = plan.spmm_extra(dev)
        parts = [spmv_lib.spmm_apply(static, arrays, extra, X[:, j:j + 64])
                 for j in range(0, X.shape[1], 64)]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

    def _elemwise(self, node: MatExpr, ev) -> Tensor:
        l, r = node.children
        va, vb = ev.value(l), ev.value(r)
        if isinstance(va, Tensor) and isinstance(vb, Tensor):
            return self._elemwise_local(node, va, vb)
        from matrel_tpu_torch.parallel import collectives as coll
        # the full-shaped Shard sets the layout; a broadcast vector is
        # gathered alone (it is small) and cut to the block
        ref = next((v for v, c in ((va, l), (vb, r))
                    if not isinstance(v, Tensor) and c.shape == node.shape),
                   None)
        if ref is None:
            # two vectors broadcast against each other: the counted
            # whole route
            return self._elemwise_local(node, ev(l), ev(r))
        r0, r1, c0, c1 = coll.block_rect(ref, self.mesh)

        def local(v, c: MatExpr) -> Tensor:
            if c.shape == node.shape:
                return self._align(v, ref)
            v = ev(c)
            rows = slice(r0, r1) if c.shape[0] != 1 else slice(None)
            cols = slice(c0, c1) if c.shape[1] != 1 else slice(None)
            return v[rows, cols]

        out = self._elemwise_local(node, local(va, l), local(vb, r),
                                   (r0, c0))
        return coll.Shard(out, ref.layout, ref.pshape)

    def _elemwise_local(self, node: MatExpr, a: Tensor, b: Tensor,
                        off: Tuple[int, int] = (0, 0)) -> Tensor:
        """The op over whole operands, or over one rank's blocks whose
        first entry sits at global ``off``."""
        l, r = node.children
        broadcast = l.shape != r.shape
        if broadcast:
            a = self._slice_for_broadcast(a, l.shape, node.shape)
            b = self._slice_for_broadcast(b, r.shape, node.shape)
        op = node.attrs["op"]
        if op == "add":
            out = a + b
        elif op == "sub":
            out = a - b
        elif op == "mul":
            out = a * b
        elif op == "div":
            dt = torch.promote_types(a.dtype, b.dtype)
            safe_b = torch.where(b == 0, torch.ones((), dtype=b.dtype,
                                                    device=b.device), b)
            out = torch.where(b == 0, torch.zeros((), dtype=dt,
                                                  device=a.device),
                              a / safe_b)
        elif op == "min":
            out = torch.minimum(a, b)
        elif op == "max":
            out = torch.maximum(a, b)
        else:
            raise NotImplementedError(op)
        if broadcast and op != "mul":
            out = _mask_to_logical(out, node.shape, off)
        return out

    @staticmethod
    def _slice_for_broadcast(x: Tensor, lshape, out_shape) -> Tensor:
        if lshape[0] == 1 and out_shape[0] != 1 and x.shape[0] != 1:
            x = x[:1, :]
        if lshape[1] == 1 and out_shape[1] != 1 and x.shape[1] != 1:
            x = x[:, :1]
        return x

    def _scalar(self, node: MatExpr, ev) -> Tensor:
        x, off, wrap = self._block(node.children[0], ev)
        op, v = node.attrs["op"], node.attrs["value"]
        if (not x.dtype.is_floating_point and x.dtype != torch.bool
                and not (torch.iinfo(x.dtype).min <= v
                         <= torch.iinfo(x.dtype).max)):
            # a constant the integer dtype cannot hold (norm's ·-1 on an
            # unsigned value): computed in int64, so |x| = max(x, -x)
            # comes out as numpy's, not wrapped (the JAX package raises)
            x = x.to(torch.int64)
        s = torch.tensor(v, dtype=x.dtype, device=x.device)
        if op == "mul":
            return wrap(x * s)
        if op == "add":
            out = x + s
            return wrap(_mask_to_logical(out, node.shape, off)
                        if v != 0.0 else out)
        if op == "pow":
            out = torch.pow(x, s)
            return wrap(_mask_to_logical(out, node.shape, off)
                        if v <= 0 else out)
        raise NotImplementedError(op)

    def _agg(self, node: MatExpr, ev) -> Tensor:
        (child,) = node.children
        if child.kind == "join_value":
            # never materialise the pair matrix under an aggregate
            return self._agg_join_value(node, child, ev)
        v = ev.value(child)
        if not isinstance(v, Tensor):
            return self._agg_ranked(node, v)
        x = v
        kind, axis = node.attrs["agg"], node.attrs["axis"]
        n, m = child.shape
        pn, pm = x.shape
        if axis == "diag":
            d = torch.diagonal(x)[:n]
            return _diag_reduce(d, kind).reshape(1, 1).to(x.dtype)
        dim = {"row": 1, "col": 0, "all": None}[axis]

        def red(fn, t):
            return fn(t) if dim is None else fn(t, dim=dim)

        def finish(res: Tensor) -> Tensor:
            if axis == "row":
                return res.reshape(pn, 1)
            if axis == "col":
                return res.reshape(1, pm)
            return res.reshape(1, 1)

        if kind == "sum":
            out = finish(_jnp_sum(x, dim))
        elif kind == "count":
            out = finish(red(torch.sum, x != 0).to(x.dtype))
        elif kind == "avg":
            s = red(torch.sum, x)
            c = red(torch.sum, x != 0)
            out = finish(torch.where(c > 0, s / c.clamp(min=1),
                                     torch.zeros((), device=x.device)
                                     ).to(x.dtype))
        elif kind in ("max", "min"):
            masked = torch.where(padding.valid_mask((n, m), (pn, pm), x.device), x,
                                 _extreme_fill(x.dtype, kind, x.device))
            if dim is None:
                res = masked.max() if kind == "max" else masked.min()
            else:
                res = (masked.amax(dim=dim) if kind == "max"
                       else masked.amin(dim=dim))
            out = finish(res)
            out = torch.where(torch.isfinite(out), out,
                              torch.zeros((), dtype=x.dtype,
                                          device=x.device))
        else:
            raise NotImplementedError(kind)
        return _mask_to_logical(out, node.shape)

    def _agg_ranked(self, node: MatExpr, x) -> object:
        """An aggregate of a Shard: each rank reduces its block, then the
        ranks that split the reduced dim reduce across their group
        (``collectives.axis_reduce``): ``row_*`` over the column axes
        (the result stays sharded along the rows), ``col_*`` over the
        row axes, ``all`` and ``diag`` over every axis of the layout.
        count and avg carry (sum, count) pairs in one reduction; max /
        min fill the padding with their identity (C2's integer rule).
        The partial sums group differently from one card's sum (f32
        rounding of ``mesh.size`` partials)."""
        from matrel_tpu_torch.parallel import collectives as coll
        import torch.distributed as dist
        (child,) = node.children
        kind, axis = node.attrs["agg"], node.attrs["axis"]
        n, m = child.shape
        loc = x.local
        dev, dt = loc.device, loc.dtype
        r0, r1, c0, c1 = coll.block_rect(x, self.mesh)
        rows, cols = x.layout
        axes = {"row": cols, "col": rows}.get(axis, rows + cols)
        # sums run in f32 for narrower floats (one rounding at the end,
        # as torch.sum of a bf16 tensor accumulates) and in int64 for
        # integers and bool (jnp's 32-bit result cast at the end)
        wide = (torch.float32 if dt.is_floating_point and dt.itemsize < 4
                else dt if dt.is_floating_point else torch.int64)
        pair_dt = torch.float64 if dt.is_floating_point else torch.int64
        if axis == "diag":
            # the entries i < min(pn, pm, n) of the diagonal this block holds
            L = min(x.pshape[0], x.pshape[1], n)
            i0, i1 = max(r0, c0), max(min(r1, c1, L), max(r0, c0))
            idx = torch.arange(i0, i1, device=dev)
            vals = loc[idx - r0, idx - c0]
            dim = None
        else:
            vals = loc
            dim = {"row": 1, "col": 0, "all": None}[axis]

        def red(fn, t):
            return fn(t) if dim is None else fn(t, dim=dim)

        if kind in ("sum", "count", "avg"):
            s = red(torch.sum, vals.to(wide))
            c = red(torch.sum, vals != 0)
            pair = torch.stack([s.to(pair_dt), c.to(pair_dt)])
            pair = coll.axis_reduce(pair, self.mesh, axes)
            s, c = pair[0].to(wide), pair[1].to(torch.int64)
            if kind == "sum":
                res = s.to(_JNP_SUM_DTYPE.get(dt, dt)) \
                    if not dt.is_floating_point else s.to(dt)
            elif kind == "count":
                res = c.to(dt)
            else:
                res = torch.where(c > 0, s / c.clamp(min=1),
                                  torch.zeros((), device=dev)).to(dt)
        elif kind in ("max", "min"):
            fill = _extreme_fill(dt, kind, dev)
            if axis != "diag":
                vals = torch.where(padding.valid_mask((n, m), tuple(loc.shape), dev,
                                               (r0, c0)), loc, fill)
            if vals.numel() == 0:          # a block off the diagonal
                res = fill
            elif dim is None:
                res = vals.max() if kind == "max" else vals.min()
            else:
                res = (vals.amax(dim=dim) if kind == "max"
                       else vals.amin(dim=dim))
            res = coll.axis_reduce(res.clone(), self.mesh, axes,
                                   dist.ReduceOp.MAX if kind == "max"
                                   else dist.ReduceOp.MIN)
            if axis != "diag":
                res = torch.where(torch.isfinite(res), res,
                                  torch.zeros((), dtype=dt, device=dev))
        else:
            raise NotImplementedError(kind)
        if axis == "diag":
            return res.reshape(1, 1).to(dt)
        if axis == "all":
            return _mask_to_logical(res.reshape(1, 1), node.shape)
        if axis == "row":
            out = _mask_to_logical(res.reshape(-1, 1), node.shape, (r0, 0))
            lay, ps = (rows, ()), (x.pshape[0], 1)
        else:
            out = _mask_to_logical(res.reshape(1, -1), node.shape, (0, c0))
            lay, ps = ((), cols), (1, x.pshape[1])
        return out if lay == _WHOLE else coll.Shard(out, lay, ps)


def _extreme_fill(dtype: torch.dtype, kind: str, device) -> Tensor:
    """The identity of max / min in ``dtype``: ∓inf for floats and bool,
    an integer dtype's extreme value (it has no infinity)."""
    if dtype.is_floating_point or dtype == torch.bool:
        fill = float("-inf") if kind == "max" else float("inf")
    else:
        info = torch.iinfo(dtype)
        fill = info.min if kind == "max" else info.max
    return torch.tensor(fill, dtype=dtype, device=device)


def _spgemm_block_size(node: MatExpr, config=None):
    """The tile edge an S×S matmul's SpGEMM would run at, or None when
    the node is not an S×S candidate: both operands must be sparse
    leaves, and two block-sparse operands must agree on block size. COO
    operands adopt the block-sparse partner's grid, or
    ``config.block_size`` for COO×COO."""
    l, r = node.children
    if (l.kind not in planner.SPARSE_KINDS
            or r.kind not in planner.SPARSE_KINDS):
        return None
    sizes = [c.attrs["matrix"].block_size for c in node.children
             if c.kind == "sparse_leaf"]
    if len(sizes) == 2 and sizes[0] != sizes[1]:
        return None
    if sizes:
        return sizes[0]
    return (config or default_config()).block_size


def _block_density_of(child: MatExpr, bs: int) -> float:
    """Block-granular density of an S×S operand: block-sparse leaves
    carry it; COO leaves count their touched tiles exactly from the host
    edge lists (memoised per block size) — the probabilistic lift would
    saturate for any element density above ~1/bs²."""
    m = child.attrs["matrix"]
    if child.kind == "sparse_leaf":
        return m.density
    memo = getattr(m, "_block_density_memo", None)
    if memo is not None and memo[0] == bs:
        return memo[1]
    gr = math.ceil(m.shape[0] / bs)
    gc = math.ceil(m.shape[1] / bs)
    keys = (np.asarray(m.rows, np.int64) // bs) * gc \
        + np.asarray(m.cols, np.int64) // bs
    d = len(np.unique(keys)) / max(gr * gc, 1)
    m._block_density_memo = (bs, d)
    return d


def spgemm_out_block_density(node: MatExpr, config=None):
    """Estimated output BLOCK density of an S×S matmul — the quantity
    the dispatch threshold compares. None when not an S×S candidate."""
    from matrel_tpu_torch.ir import stats
    bs = _spgemm_block_size(node, config)
    if bs is None:
        return None
    l, r = node.children
    kb = max(1, math.ceil(l.shape[1] / bs))
    return stats.matmul_density(_block_density_of(l, bs),
                                _block_density_of(r, bs), kb)


def _spgemm_dispatch(node: MatExpr, config=None) -> bool:
    """Will this matmul lower through the SpGEMM path? The single
    source of truth, shared by ``Lowerer._matmul`` and the planner."""
    cfg = config or default_config()
    if cfg.spgemm_density_threshold <= 0.0:
        return False
    est = spgemm_out_block_density(node, cfg)
    return est is not None and est < cfg.spgemm_density_threshold


def spgemm_estimates(node: MatExpr, config=None) -> dict:
    """Estimated output block density of a SpGEMM dispatch, plus the
    pairs, FLOPs and HBM bytes it saves against the densify fallback."""
    from matrel_tpu_torch.ir import stats
    cfg = config or default_config()
    bs = _spgemm_block_size(node, cfg)
    l, r = node.children
    k, m = l.shape[1], r.shape[1]
    kb = max(1, math.ceil(k / bs))

    def nnzb_of(child):
        mtx = child.attrs["matrix"]
        if child.kind == "sparse_leaf":
            return float(mtx.nnzb)
        gr = math.ceil(child.shape[0] / bs)
        gc = math.ceil(child.shape[1] / bs)
        return _block_density_of(child, bs) * gr * gc

    rec = stats.spgemm_saved_estimate(nnzb_of(l), nnzb_of(r), kb, k, m,
                                      bs)
    rec["est_out_block_density"] = spgemm_out_block_density(node, cfg)
    rec["block_size"] = bs
    return rec


def spgemm_kernel_choice(node: MatExpr, config=None, mesh=None):
    """(kernel_id, structure_class, source) for a dispatching S×S
    matmul — the single chooser shared by the planner's stamp and the
    lowering of an unstamped node. With ``mesh`` and ``config.autotune``
    the registry may answer with a measured winner."""
    from matrel_tpu_torch.ir import stats
    from matrel_tpu_torch.ops import kernel_registry as kr
    cfg = config or default_config()
    bs = _spgemm_block_size(node, cfg)
    l, r = node.children
    structure = stats.pair_structure_class(
        kr.structure_of_child(l, bs), kr.structure_of_child(r, bs))
    est = spgemm_estimates(node, cfg)
    npairs = max(int(round(est.get("est_pairs") or 0.0)), 1)
    side = max(l.shape[0], l.shape[1], r.shape[1])
    kid, source = kr.select_kernel(structure, bs, npairs, cfg, side=side,
                                   mesh=mesh)
    return kid, structure, source


def _transposed_sparse(e: MatExpr) -> bool:
    """``e`` is the transpose of a block-sparse leaf."""
    return e.kind == "transpose" and e.children[0].kind == "sparse_leaf"


def _sparse_transposed(S):
    """Sᵀ of a block-sparse matrix: the tile stack is transposed once
    and memoised on the matrix."""
    st = getattr(S, "_transposed_memo", None)
    if st is None:
        st = S.transpose()
        S._transposed_memo = st
    return st


def spmm_rank_split(node: MatExpr, mesh: Mesh) -> str:
    """How an S·D (or D·S) matmul's B1 runs on a rank mesh: "col_slice"
    or "whole" (``ops/spmm.rank_split``), the choice
    ``Lowerer._spmm`` makes."""
    from matrel_tpu_torch.ops import spmm as spmm_lib
    l, r = node.children
    if l.kind == "sparse_leaf":
        S, width = l.attrs["matrix"], r.shape[1]
    else:
        S, width = r.attrs["matrix"], l.shape[0]
    return spmm_lib.rank_split(S, padding.pad_dim(width, mesh.size), mesh)


def _coo_dispatch_plan(node: MatExpr):
    """The EdgeSpMVPlan a coo_leaf matmul node dispatches through
    ``_coo_spmv_stack``, or None (the densify path). The single source
    of truth for the narrow-operand dispatch, shared with the planner."""
    l, r = node.children
    if l.kind == "coo_leaf":
        k = r.shape[1]
        return (l.attrs["matrix"]._get_plan()
                if 0 < k <= COO_NARROW_MAX else None)
    if r.kind == "coo_leaf":
        k = l.shape[0]
        return (r.attrs["matrix"]._get_plan_t()
                if 0 < k <= COO_NARROW_MAX else None)
    return None


def _autotune_spmv_choices(opts, mesh: Mesh, cfg: MatrelConfig) -> dict:
    """Measured SpMV executor variants for every COO matmul these plans
    dispatch through ``_coo_spmv_stack`` (``config.autotune`` on):
    id(plan) -> (plan, "compact" / "expanded"). Runs at compile time;
    the dispatch condition is ``_coo_dispatch_plan``, shared with
    ``Lowerer._matmul``."""
    from matrel_tpu_torch.parallel import autotune

    choices: dict = {}
    seen: set = set()

    def visit(n: MatExpr):
        if n.uid in seen:        # expressions are DAGs
            return
        seen.add(n.uid)
        if n.kind == "matmul" and any(c.kind == "coo_leaf"
                                      for c in n.children):
            plan = _coo_dispatch_plan(n)
            if plan is not None and id(plan) not in choices:
                best = autotune.lookup_or_measure_spmv(plan, mesh, cfg)
                if best is not None:
                    choices[id(plan)] = (plan, best)
        for c in n.children:
            visit(c)

    for o in opts:
        visit(o)
    return choices


def _lowerer(opts, mesh: Mesh, cfg: MatrelConfig,
             op_hook: Optional[Callable] = None) -> "Lowerer":
    """A Lowerer for these plans, with the measured SpMV variants when
    ``config.autotune`` is on (``op_hook``: the analyze-mode timer)."""
    low = Lowerer(mesh, cfg, op_hook=op_hook)
    if cfg.autotune:
        low.spmv_choice = _autotune_spmv_choices(opts, mesh, cfg)
    return low


def _fusion_meta(opts, cfg: MatrelConfig) -> Optional[Dict]:
    """Plan-level fusion roll-up for ``plan.meta["fusion"]``: region
    count, merged member census and the modelled dispatch/HBM savings
    of every stamped boundary. None with fusion off (no extra walk)."""
    if not cfg.fusion_enable:
        return None
    from matrel_tpu_torch.ir import fusion as fusion_lib
    regions = 0
    census: Dict[str, int] = {}
    saved_d = 0
    saved_b = 0.0
    for o in opts:
        for node in fusion_lib.collect_stamps(o):
            regions += 1
            for k, v in (node.attrs.get("fused_census") or {}).items():
                census[k] = census.get(k, 0) + v
            saved_d += int(node.attrs.get("fused_saved_dispatches") or 0)
            saved_b += float(node.attrs.get("fused_saved_hbm_bytes")
                             or 0.0)
    return {"regions": regions, "census": census,
            "est_saved_dispatches": saved_d,
            "est_saved_hbm_bytes": saved_b}


def _annotate(e: MatExpr, mesh: Mesh, cfg: MatrelConfig,
              rule_hits: Optional[dict] = None,
              fuse: bool = True) -> MatExpr:
    """optimize → strategies → (with ``fusion_enable``) fusion stamps:
    the planning half every compile path shares."""
    opt = planner.annotate_strategies(
        rules.optimize(e, cfg, grid=mesh_lib.mesh_grid_shape(mesh),
                       mesh=mesh, counts=rule_hits), mesh, cfg)
    if fuse and cfg.fusion_enable:
        from matrel_tpu_torch.ir import fusion as fusion_lib
        opt = fusion_lib.annotate_fusion(opt, mesh, cfg)
    return opt


def _precision_meta(opts, cfg: MatrelConfig) -> Optional[Dict]:
    """The query SLA, the stamped tier census and the worst-case
    relative error bound over every tiered matmul (TIER_EPS · k), or
    None under the "default" SLA — the JAX package's ``precision``
    plan meta (the result cache composes patched bounds from it)."""
    if cfg.precision_sla == "default":
        return None
    tiers: Dict[str, int] = {}
    bound = [0.0]
    seen: set = set()

    def walk(n: MatExpr):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            walk(c)
        t = n.attrs.get("precision_tier")
        if n.kind == "matmul" and t is not None:
            tiers[t] = tiers.get(t, 0) + 1
            eps = planner.TIER_EPS.get(t)
            if eps:
                bound[0] = max(bound[0], eps * n.children[0].shape[1])

    for o in opts:
        walk(o)
    return {"sla": cfg.precision_sla, "tiers": tiers,
            "est_rel_err_bound": bound[0]}


def _verify_plans(opts, mesh, cfg: MatrelConfig) -> Optional[List[dict]]:
    """Run the static verifier (``analysis/``) over the annotated roots
    when ``config.verify_plans`` asks for it — before lowering: at
    "error" a misdescribed or infeasible plan raises here and nothing
    is lowered, at "warn" the findings are logged and recorded. Returns
    the diagnostic dicts for ``plan.meta`` (None with the gate off, so
    the default compile path pays nothing). Imported lazily: the
    analysis → executor dependency stays one-way at module load."""
    if cfg.verify_plans == "off":
        return None
    from matrel_tpu_torch import analysis
    diags = []
    for o in opts:
        diags.extend(analysis.verify_plan(o, mesh, cfg))
    analysis.enforce(diags, cfg.verify_plans)
    return [d.to_dict() for d in diags]


def _plan_meta(opts, cfg: MatrelConfig, optimize_ms: float,
               trace_ms: float, rule_hits: dict,
               diagnostics: Optional[List[dict]] = None) -> Dict:
    meta = {"optimize_ms": round(optimize_ms, 3),
            "trace_ms": round(trace_ms, 3), "rule_hits": rule_hits}
    if diagnostics is not None:
        meta["diagnostics"] = diagnostics
    prec = _precision_meta(opts, cfg)
    if prec is not None:
        meta["precision"] = prec
    fus = _fusion_meta(opts, cfg)
    if fus is not None:
        meta["fusion"] = fus
    return meta


class DeviceMismatchError(ValueError):
    """A rebound leaf lies on another device than the plan's: a plan
    never copies a binding to its device quietly."""


def _check_device(t: Tensor, mesh: Mesh) -> None:
    if t.device != mesh.device:
        raise DeviceMismatchError(
            f"rebound leaf on {t.device}, the plan runs on {mesh.device}")


def _leaf_values(leaf_order, bindings, mesh) -> list:
    """The current or rebound (uid → BlockMatrix) leaves' values: their
    tensors, or on a rank mesh their Shards."""
    out = []
    for l in leaf_order:
        bound = (bindings or {}).get(l.uid)
        if bound is not None:
            _check_device(bound.data, mesh)
        m = bound if bound is not None else l.attrs["matrix"]
        out.append(m.as_shard() if mesh.ranked else m.data)
    return out


def _result(out: Tensor, root: MatExpr, mesh: Mesh) -> BlockMatrix:
    """A root's padded value (this rank's canonical block on a rank
    mesh) as a BlockMatrix."""
    pshape = padding.padded_shape(root.shape, mesh)
    return BlockMatrix.from_array(out, root.shape, mesh,
                                  padding.canonical_spec(pshape, mesh),
                                  nnz=root.nnz)


@dataclasses.dataclass
class CompiledPlan:
    """A planned, lowered expression plus its leaf binding order —
    re-runnable with fresh leaf data."""

    fn: Callable
    leaf_order: List[MatExpr]
    optimized: MatExpr
    mesh: Mesh
    config: MatrelConfig
    #: compile-time record: optimize_ms and rewrite-rule hit counts
    meta: Dict = dataclasses.field(default_factory=dict)

    def run(self, bindings: Optional[Dict[int, BlockMatrix]] = None
            ) -> BlockMatrix:
        """Execute with current or rebound leaves (uid → BlockMatrix)."""
        out = self.fn(*_leaf_values(self.leaf_order, bindings, self.mesh))
        return _result(out, self.optimized, self.mesh)

    def bound_runner(self, rebind_uids: tuple = (), donate: bool = False
                     ) -> Callable:
        """The iteration path: the leaf layout resolved ONCE, raw padded
        tensors in and out — none of ``run``'s per-call dict walk or
        BlockMatrix wrapping.

        Returns ``call(*tensors)``: one tensor for each uid of
        ``rebind_uids``, in that order, each replacing its leaf's padded
        tensor (on a rank mesh, this rank's block, in the leaf's
        layout); ``call`` returns the root's padded tensor (on a rank
        mesh, this rank's canonical block). With no ``rebind_uids`` it
        returns a zero-argument closure. An unknown uid raises
        ``KeyError`` here; a call with the wrong number of tensors
        raises ``ValueError``, one on another device than the plan's
        :class:`DeviceMismatchError`. Block-sparse and COO payloads stay
        inside the lowered function, as in ``run``.

        ``donate=True`` (honoured under ``config.donate_intermediates``)
        is the JAX package's contract for C ← f(C) loops: the caller
        gives up the rebound tensors. The runner keeps no reference to
        them, so once the caller drops its own the caching allocator
        hands their blocks to the next output; without the promise a
        caller may keep reading them, which ``call`` never writes."""
        uid_pos = {l.uid: i for i, l in enumerate(self.leaf_order)}
        positions = [uid_pos[u] for u in rebind_uids]
        base = _leaf_values(self.leaf_order, None, self.mesh)
        fn, mesh = self.fn, self.mesh
        if not positions:
            return lambda: fn(*base)
        ranked = mesh.ranked
        if ranked:
            from matrel_tpu_torch.parallel.collectives import Shard

        def call(*tensors: Tensor) -> Tensor:
            if len(tensors) != len(positions):
                raise ValueError(
                    f"bound runner expects {len(positions)} rebound "
                    f"tensor(s), got {len(tensors)}")
            argv = list(base)
            for p, t in zip(positions, tensors):
                _check_device(t, mesh)
                argv[p] = (Shard(t, base[p].layout, base[p].pshape)
                           if ranked else t)
            return fn(*argv)

        return call

    def collectives(self) -> Dict[str, int]:
        """{kind: count} of the collectives one run of the plan issues,
        under the JAX package's HLO names — the assertable plan shape.
        One card issues none (``{}``, as the JAX package's one-device
        plan). On a rank mesh the plan runs once, counted in
        ``parallel/collectives.TALLY`` under a phase of its own, so
        every rank calls this together, as it calls ``run``; the counts
        are kept in ``meta``."""
        if not self.mesh.ranked:
            return {}
        if "collectives" not in self.meta:
            from matrel_tpu_torch.parallel import collectives as coll
            before = Counter(coll.TALLY)
            with coll.phase("plan.collectives"):
                self.bound_runner()()
            issued: Counter = Counter()
            for key, n in coll.TALLY.items():     # (phase, kind, axis)
                name = _HLO_COLLECTIVE.get(key[1])
                if name is not None and n > before[key]:
                    issued[name] += n - before[key]
            self.meta["collectives"] = {k: issued[k] for k in _HLO_ORDER
                                        if issued[k]}
        return dict(self.meta["collectives"])

    def explain(self) -> str:
        """Optimized plan with strategies and inferred layouts, then the
        collectives one run issues (on a rank mesh every rank calls it:
        see :meth:`collectives`)."""
        from matrel_tpu_torch.ir.expr import pretty
        return "\n".join(["== Optimized plan ==",
                          pretty(self.optimized, mesh=self.mesh,
                                 config=self.config),
                          "== Collectives ==", str(self.collectives())])


#: The JAX package's HLO collective names, in its order, and the tally
#: kinds each counts. Not counted: ``gather_rep`` (a label on a gather
#: counted as such), ``broadcast`` / ``gather_object`` (the ranks'
#: agreement on a host object, which has no op in the JAX program).
_HLO_ORDER = ("all-gather", "reduce-scatter", "all-reduce",
              "collective-permute", "all-to-all")
_HLO_COLLECTIVE = {"all_gather": "all-gather", "share_gather": "all-gather",
                   "reduce_scatter": "reduce-scatter",
                   "all_reduce": "all-reduce", "axis_reduce": "all-reduce",
                   "p2p": "collective-permute", "all_to_all": "all-to-all"}


@dataclasses.dataclass
class MultiPlan:
    """Several optimized roots lowered into one function over their
    shared leaves (one memo per call, so common subexpressions run
    once) — the counterpart of the JAX package's one-program MultiPlan.
    ``run`` takes no ``donate``: as in ``CompiledPlan.bound_runner``,
    the plan keeps no reference to a rebound leaf, so the caching
    allocator reuses its blocks once the caller drops it."""

    fn: Callable
    leaf_order: List[MatExpr]
    optimized: Tuple[MatExpr, ...]
    mesh: Mesh
    config: MatrelConfig
    #: compile-time record: optimize_ms and rewrite-rule hit counts
    meta: Dict = dataclasses.field(default_factory=dict)

    def run(self, bindings: Optional[Dict[int, BlockMatrix]] = None
            ) -> Tuple[BlockMatrix, ...]:
        """Execute with current or rebound leaves (uid → BlockMatrix);
        one BlockMatrix per root, in order."""
        outs = self.fn(*_leaf_values(self.leaf_order, bindings, self.mesh))
        return tuple(_result(out, root, self.mesh)
                     for out, root in zip(outs, self.optimized))


def _check_one_mesh(expr: MatExpr, mesh: Mesh) -> None:
    """All leaves (dense and block-sparse) must live on the plan's device
    and grid. A COO leaf has no mesh: its host edge list goes to the
    plan's device at first use."""
    def walk(n: MatExpr):
        if n.kind in ("leaf", "sparse_leaf"):
            m = n.attrs["matrix"].mesh
            if m != mesh:
                raise ValueError(
                    f"expression mixes matrices from different meshes: "
                    f"{m} vs plan mesh {mesh}")
        for c in n.children:
            walk(c)
    walk(expr)


def compile_expr(expr: MatExpr, mesh: Optional[Mesh] = None,
                 config: Optional[MatrelConfig] = None) -> CompiledPlan:
    """optimize → plan → lower: the full Catalyst pipeline analogue."""
    cfg = config or default_config()
    lvs = expr_leaves(expr)
    if mesh is None:
        # a COO leaf carries no mesh: dense, then block-sparse leaves
        # decide, else the configured default
        sparse = [n for n in _walk(expr) if n.kind == "sparse_leaf"]
        first = lvs[0] if lvs else (sparse[0] if sparse else None)
        mesh = (first.attrs["matrix"].mesh if first is not None
                else mesh_lib.make_mesh(cfg.mesh_shape,
                                        cfg.mesh_axis_names))
    _check_one_mesh(expr, mesh)
    rule_hits: Dict[str, int] = {}
    # phase(): timed always (meta carries the durations), emitted as
    # parent-linked spans only when a tracer is active
    with trace_lib.phase("plan.optimize") as sp_opt:
        opt = _annotate(expr, mesh, cfg, rule_hits)
    with trace_lib.phase("plan.verify"):
        diags = _verify_plans((opt,), mesh, cfg)
    leaf_order = expr_leaves(opt)
    with trace_lib.phase("plan.trace") as sp_tr:
        fn = _lowerer((opt,), mesh, cfg).lower(opt, leaf_order)
    return CompiledPlan(fn=fn, leaf_order=leaf_order, optimized=opt,
                        mesh=mesh, config=cfg,
                        meta=_plan_meta((opt,), cfg, sp_opt.dur_ms,
                                        sp_tr.dur_ms, rule_hits, diags))


def compile_exprs(exprs, mesh: Optional[Mesh] = None,
                  config: Optional[MatrelConfig] = None) -> MultiPlan:
    """Compile several expressions into one plan with shared leaves."""
    cfg = config or default_config()
    exprs = tuple(exprs)
    all_leaves = _unique_leaves(exprs)
    if mesh is None:
        mesh = (all_leaves[0].attrs["matrix"].mesh if all_leaves
                else mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names))
    for e in exprs:
        _check_one_mesh(e, mesh)
    rule_hits: Dict[str, int] = {}
    with trace_lib.phase("plan.optimize", roots=len(exprs)) as sp_opt:
        opts = tuple(_annotate(e, mesh, cfg, rule_hits) for e in exprs)
    with trace_lib.phase("plan.verify"):
        diags = _verify_plans(opts, mesh, cfg)
    leaf_order = _unique_leaves(opts)
    with trace_lib.phase("plan.trace") as sp_tr:
        fn = _lowerer(opts, mesh, cfg).lower_multi(opts, leaf_order)
    return MultiPlan(fn=fn, leaf_order=leaf_order, optimized=opts,
                     mesh=mesh, config=cfg,
                     meta=_plan_meta(opts, cfg, sp_opt.dur_ms,
                                     sp_tr.dur_ms, rule_hits, diags))


def plan_matmul_decisions(plan) -> List[dict]:
    """Per-matmul planner-decision records of a compiled plan (a
    :class:`CompiledPlan` or :class:`MultiPlan`), derived on first access
    and cached in ``plan.meta``."""
    meta = plan.meta
    if "matmuls" not in meta:
        roots = (plan.optimized if isinstance(plan.optimized, tuple)
                 else (plan.optimized,))
        meta["matmuls"] = [
            d for o in roots
            for d in planner.matmul_decisions(o, plan.mesh, plan.config)]
        ivm = meta.get("ivm")
        if isinstance(ivm, dict):
            # a delta-patch plan (serve/ivm.py): the optimizer may
            # rebuild the stamped root, so the pricing rides plan.meta
            for d in meta["matmuls"]:
                d.setdefault("delta_rule", ivm.get("rule"))
                d.setdefault("delta_est_saved_flops",
                             ivm.get("est_saved_flops"))
    return meta["matmuls"]


def multiplan_root_decisions(plan: "MultiPlan") -> List[List[dict]]:
    """Per-root decision records of a MultiPlan, aligned with
    ``plan.optimized``; derived on first access, cached in
    ``plan.meta``."""
    meta = plan.meta
    if "matmuls_per_root" not in meta:
        meta["matmuls_per_root"] = [
            planner.matmul_decisions(o, plan.mesh, plan.config)
            for o in plan.optimized]
    return meta["matmuls_per_root"]


#: Decision-record columns the provenance ledger keeps: the chosen
#: strategy, WHY (autotune/model/override), the precision tier and a
#: delta-patch rule (the JAX package's projection).
_PROVENANCE_KEEP = ("strategy", "source", "precision_tier",
                    "delta_rule")


def plan_provenance(plan, decisions: Optional[List[dict]] = None
                    ) -> List[dict]:
    """A compiled plan's strategy/tier/coefficient provenance, projected
    for the answer ledger (obs/provenance.py). ``decisions`` lets
    MultiPlan callers pass one root's records
    (:func:`multiplan_root_decisions`)."""
    if decisions is None:
        decisions = plan_matmul_decisions(plan)
    return [{k: d[k] for k in _PROVENANCE_KEEP
             if d.get(k) is not None} for d in decisions]


def _unique_leaves(exprs) -> List[MatExpr]:
    """Dense leaves of several expressions, each once (by uid), in first
    appearance order."""
    out, seen = [], set()
    for e in exprs:
        for l in expr_leaves(e):
            if l.uid not in seen:
                seen.add(l.uid)
                out.append(l)
    return out


def execute(expr: MatExpr, mesh: Optional[Mesh] = None,
            config: Optional[MatrelConfig] = None) -> BlockMatrix:
    """Compile and run one expression."""
    return compile_expr(expr, mesh, config).run()


def _walk(e: MatExpr):
    yield e
    for c in e.children:
        yield from _walk(c)



# -- unit programs: the region seam (ir/fusion.py) ---------------------------
#
# ``compile_expr`` lowers the whole plan into one function; these
# builders emit the plan as a SEQUENCE of unit programs instead:
# ``compile_staged_units`` one per physical op (a dispatch and a
# round-trip through device memory per plan edge), ``compile_region_units``
# one per fused region. In eager PyTorch a unit is one Python callable
# over tensors, so both forms launch the same kernels; the fused form
# runs fewer units. The autotune ``fuse|`` loop measures one region's
# pair through the same builders.

#: Leaf kinds whose payloads stay INSIDE a unit (their lowerings read
#: static host metadata off the node attrs).
_UNIT_CONST_LEAVES = ("sparse_leaf", "coo_leaf")


def _unit_fn(low: Lowerer, root: MatExpr, input_uids: Tuple[int, ...]):
    """One unit program computing ``root`` from its unit inputs
    (everything not in ``input_uids`` — members of the unit's region,
    sparse-payload leaves — lowers inside, through the Lowerer's
    per-node paths, so fused and staged units agree exactly)."""

    def fn(*arrs):
        env = dict(zip(input_uids, arrs))
        whole: Dict[int, Tensor] = {}

        def value(n: MatExpr):
            v = env.get(n.uid)
            if v is not None:
                return v
            v = low._eval(n, lev, (), {})
            env[n.uid] = v
            return v

        lev = _evaluator(value, low.mesh, whole)
        try:
            return value(root)
        finally:
            env.clear()       # lev refers to itself (the memo's rule)
            whole.clear()

    return fn


@dataclasses.dataclass
class UnitPrograms:
    """An expression compiled as a sequence of unit programs —
    ``dispatches`` units per run (the count fusion shrinks). ``run()``
    executes the units in topological order over padded tensors and
    returns the root unit's output: on a rank mesh each rank runs its
    units over its leaves' Shards (a unit's output is what its lowering
    keeps — a Shard or a whole tensor) and returns its block of the root
    under the canonical spec, as ``CompiledPlan.run`` holds it."""

    #: (node, unit fn, input uids, member count) in execution order.
    units: List
    optimized: MatExpr
    leaf_order: List[MatExpr]
    mesh: Mesh
    config: MatrelConfig

    @property
    def dispatches(self) -> int:
        return len(self.units)

    def run(self, bindings: Optional[Dict[int, Tensor]] = None):
        ranked = self.mesh.ranked
        env = {l.uid: (l.attrs["matrix"].as_shard() if ranked
                       else l.attrs["matrix"].data)
               for l in self.leaf_order}
        if bindings:
            env.update(bindings)
        for node, fn, input_uids, _n in self.units:
            env[node.uid] = fn(*(env[u] for u in input_uids))
        out = env[self.optimized.uid]
        if not ranked:
            return out
        root = self.optimized
        return Lowerer(self.mesh, self.config)._ranked_root(
            root, out, padding.padded_shape(root.shape, self.mesh))


def _build_units(opt: MatExpr, mesh: Mesh, cfg: MatrelConfig,
                 per_region: bool) -> UnitPrograms:
    from matrel_tpu_torch.ir import fusion as fusion_lib
    low = Lowerer(mesh, cfg)
    units: List = []
    leaf_order: List[MatExpr] = []
    seen: set = set()
    member_of: Dict[int, int] = {}     # member uid -> region root uid
    if per_region:
        for stamp in fusion_lib.collect_stamps(opt):
            for u in stamp.attrs.get("fused_members") or ():
                member_of[u] = stamp.uid

    def walk(n: MatExpr):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            walk(c)
        if n.kind == "leaf":
            leaf_order.append(n)
            return
        if n.kind in _UNIT_CONST_LEAVES:
            return                      # inside the consumer unit
        if n.uid in member_of:
            return                      # inside its region unit
        if per_region and "fused_region" in n.attrs:
            members = fusion_lib.region_nodes(n)
            inputs = []
            in_seen = set()
            for m in members.values():
                for c in m.children:
                    if (c.uid not in members
                            and c.kind not in _UNIT_CONST_LEAVES
                            and c.uid not in in_seen):
                        in_seen.add(c.uid)
                        inputs.append(c.uid)
            units.append((n, _unit_fn(low, n, tuple(inputs)),
                          tuple(inputs), len(members)))
            return
        inputs = tuple(c.uid for c in n.children
                       if c.kind not in _UNIT_CONST_LEAVES)
        units.append((n, _unit_fn(low, n, inputs), inputs, 1))

    walk(opt)
    if not units:                       # a bare leaf plan: identity unit
        units.append((opt, lambda x: x, (opt.uid,), 1))
    return UnitPrograms(units=units, optimized=opt,
                        leaf_order=leaf_order, mesh=mesh, config=cfg)


def _units_mesh(expr: MatExpr, mesh: Optional[Mesh],
                cfg: MatrelConfig) -> Mesh:
    if mesh is None:
        lvs = expr_leaves(expr)
        mesh = lvs[0].attrs["matrix"].mesh if lvs else mesh_lib.make_mesh(
            cfg.mesh_shape, cfg.mesh_axis_names)
    return mesh


def compile_staged_units(expr: MatExpr, mesh: Optional[Mesh] = None,
                         config: Optional[MatrelConfig] = None
                         ) -> UnitPrograms:
    """One unit program PER PHYSICAL OP — the staged floor the fused
    form is measured against (fusion stamps are not applied)."""
    cfg = config or default_config()
    mesh = _units_mesh(expr, mesh, cfg)
    return _build_units(_annotate(expr, mesh, cfg, fuse=False), mesh, cfg,
                        per_region=False)


def compile_region_units(expr: MatExpr, mesh: Optional[Mesh] = None,
                         config: Optional[MatrelConfig] = None
                         ) -> UnitPrograms:
    """One unit program PER FUSED REGION (other nodes keep one each);
    the regions are ``ir/fusion.annotate_fusion``'s, so with
    ``config.fusion_enable`` off this equals the staged form."""
    cfg = config or default_config()
    mesh = _units_mesh(expr, mesh, cfg)
    return _build_units(_annotate(expr, mesh, cfg), mesh, cfg,
                        per_region=True)


def region_probe_programs(root_node: MatExpr, member_uids,
                          mesh: Mesh, cfg: MatrelConfig):
    """(fused_fn, staged_units, input_uids, probe_tensors, root_uid) for
    ONE region — the autotune ``fuse|`` measurement harness. Region
    inputs are replaced by padded f32 probes from
    ``np.random.default_rng(0)`` on the mesh's device; on a rank mesh
    each probe is this rank's Shard of that same array, cut as a leaf's
    ``as_shard()`` cuts it (the canonical spec), so every rank probes
    the same matrix and the fused and staged units run on every rank in
    step. A region whose members read sparse-leaf payloads returns None
    (a probe cannot stand in for static tile metadata)."""
    members = {root_node.uid: root_node}
    want = set(member_uids)
    stack = [root_node]
    while stack:
        n = stack.pop()
        for c in n.children:
            if c.uid in want and c.uid not in members:
                members[c.uid] = c
                stack.append(c)
    inputs: List[MatExpr] = []
    in_seen: set = set()
    for m in members.values():
        for c in m.children:
            if c.uid in members or c.uid in in_seen:
                continue
            if c.kind in _UNIT_CONST_LEAVES:
                return None
            in_seen.add(c.uid)
            inputs.append(c)
    low = Lowerer(mesh, cfg)
    input_uids = tuple(c.uid for c in inputs)
    fused = _unit_fn(low, root_node, input_uids)
    staged: List = []
    order: List[MatExpr] = []
    seen: set = set()

    def topo(n: MatExpr):
        if n.uid in seen or n.uid not in members:
            return
        seen.add(n.uid)
        for c in n.children:
            topo(c)
        order.append(n)

    topo(root_node)
    for n in order:
        ins = tuple(c.uid for c in n.children)
        staged.append((n, _unit_fn(low, n, ins), ins))
    rng = np.random.default_rng(0)
    arrays = {}
    for c in inputs:
        ps = padding.padded_shape(c.shape, mesh)
        full = torch.as_tensor(rng.standard_normal(ps).astype(np.float32),
                               device=mesh.device)
        if mesh.ranked:
            from matrel_tpu_torch.parallel import collectives as coll
            full = coll.shard_from_full(
                full, padding.canonical_spec(ps, mesh), mesh)
        arrays[c.uid] = full
    return fused, staged, input_uids, arrays, root_node.uid
