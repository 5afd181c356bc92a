"""Incremental view maintenance — the delta algebra, the counterpart
of ``matrel_tpu/ir/delta.py``.

Given a cached entry ``R = f(A, ...)`` and a small update
``A' = A + ΔA``, derive a patch expression computing ``f(A', ...)`` from
``R`` and ΔA, so the result cache (``serve/ivm.py``) patches its entries
instead of killing them on a rebind.

Delta representations (:class:`MatrixDelta`):
  coo      edge-style updates (rows, cols, vals) — canonically FACTORED:
           a c-edge COO delta is exactly the rank-c update ``ΔA = U·Vᵀ``
           with one scaled one-hot column per edge, so every product
           against ΔA is a thin dense product, and the factor leaves are
           REBINDABLE (``CompiledPlan.run(bindings=...)``).
  lowrank  an explicit (U, V) pair, ``ΔA = U·Vᵀ``.
  dense    a same-shaped correction matrix.

Sparse ΔA·B: when the delta's sparse form (a
:meth:`BlockSparseMatrix.from_coo_arrays` payload) multiplies a sparse
leaf, the emitted product is an S×S matmul over two sparse leaves —
what ``executor._spgemm_dispatch`` routes through the kernel registry
(B4–B7); the derivation consults that predicate, so the patch is priced
the way it will lower.

Rule table (Δf for one changed operand A; ``None`` = structural zero):
  leaf(A)                 ΔA
  transpose(x)            Δxᵀ
  matmul(a,b)  a only     Δa·b        (thin: U·(Vᵀ·b) when factored)
               b only     a·Δb
               both       Δa·b_old + a_new·Δb
  elemwise add/sub        Δa ± Δb
  elemwise mul            Δa∘b_old + a_new∘Δb
  elemwise div            Δa / b      (b must be independent)
  scalar mul/add          s·Δa / Δa
  agg sum|avg             agg(Δa)
  vec                     vec(Δa)
  rank1(base,u,v)         Δbase       (u, v must be independent)
  refine hook             root attr ``delta_refine`` (PageRank warm
                          restart; :func:`pagerank_warm_restart`)
  everything else         ineligible → the caller falls back to the
                          transitive kill.

Subtree reuse: a ``known`` map of structurally matching cached entries
(keyed by :func:`core_key`) lets the delta of an interior entry patched
earlier in the same generation enter downstream patches as a leaf.

Rules, stamps, keys, pricing and error bounds are the JAX package's.
``MatrixDelta.apply_to`` builds the rebound value on the device (a
scatter-add into a copy of a dense binding; a block-sparse binding
rebuilds only its touched tiles, then drops tiles left all zero — the
tile set ``BlockSparseMatrix.from_numpy`` of the sum would keep).

Nothing here runs on the default path: ``register_delta`` unused means
no MatrixDelta is ever constructed (``_CONSTRUCTED`` is the
poisoned-init test hook).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.ir import expr as E
from matrel_tpu_torch.ir.expr import MatExpr

#: Primary-rule vocabulary a patch stamp may carry (MV113 checks
#: membership; the autotune ``ivm|`` key embeds it).
DELTA_RULES = ("linear", "rank_k", "rank_k_both", "spgemm", "refine")

#: f32/HIGHEST per-product relative error unit — the MV108 bound table's
#: "f32" row (planner.TIER_EPS); patches compound it per generation.
_F32_EPS = 2.0 ** -20

#: Construction counter — the bit-identity test hook (ir/fusion.py's
#: ``_CONSTRUCTED`` idiom): the default path must never build a delta.
_CONSTRUCTED = {"count": 0}


class DeltaIneligible(Exception):
    """Internal control flow: the expression has no derivable patch."""


# ---------------------------------------------------------------------------
# MatrixDelta — the update payload, in whichever form the caller has it
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class MatrixDelta:
    """One registered update ``ΔA`` for a bound catalog matrix.

    kind: "coo" | "lowrank" | "dense" (see module docstring).
    shape: ΔA's logical shape (== the bound matrix's).
    integral: every delta entry is an exact integer — graph-count
      patches then ride the int paths EXACTLY (err bound 0).
    """

    kind: str
    shape: Tuple[int, int]
    rows: Optional[np.ndarray] = None
    cols: Optional[np.ndarray] = None
    vals: Optional[np.ndarray] = None
    u: Optional[np.ndarray] = None        # (n, c)
    v: Optional[np.ndarray] = None        # (m, c)
    dense: Optional[np.ndarray] = None    # (n, m)
    integral: bool = False
    _factors: Optional[tuple] = dataclasses.field(default=None,
                                                  repr=False)
    _dense_bm: Optional[object] = dataclasses.field(default=None,
                                                    repr=False)
    _sparse_bm: Optional[object] = dataclasses.field(default=None,
                                                     repr=False)

    def __post_init__(self):
        _CONSTRUCTED["count"] += 1

    # -- forms --------------------------------------------------------------

    @property
    def rank(self) -> Optional[int]:
        """Factored rank: COO nnz (one rank-1 term per edge), lowrank
        column count; None for dense (no cheap factorisation)."""
        if self.kind == "coo":
            return int(self.rows.shape[0])
        if self.kind == "lowrank":
            return int(self.u.shape[1])
        return None

    @property
    def nnz(self) -> Optional[int]:
        if self.kind == "coo":
            return int(self.rows.shape[0])
        if self.kind == "dense":
            return int(np.count_nonzero(self.dense))
        return None

    def to_dense_numpy(self) -> np.ndarray:
        """ΔA as a host array (the shared lowering of every kind)."""
        if self.kind == "dense":
            return np.asarray(self.dense, np.float32)
        if self.kind == "lowrank":
            return (np.asarray(self.u, np.float32)
                    @ np.asarray(self.v, np.float32).T)
        out = np.zeros(self.shape, np.float32)
        np.add.at(out, (self.rows, self.cols),
                  np.asarray(self.vals, np.float32))
        return out

    def factors(self, mesh, config: Optional[MatrelConfig] = None):
        """(U, V) dense BlockMatrices with ``ΔA = U·Vᵀ`` — the
        rebindable thin form — or None when the delta has no cheap
        factorisation (dense kind, or rank above
        ``config.delta_rank_max``: a fat factored product would cost
        more than it saves)."""
        cfg = config or default_config()
        r = self.rank
        if r is None or r > cfg.delta_rank_max:
            return None
        if self._factors is None:
            from matrel_tpu_torch.core.blockmatrix import BlockMatrix
            if self.kind == "lowrank":
                un = np.asarray(self.u, np.float32)
                vn = np.asarray(self.v, np.float32)
            else:
                # one scaled one-hot column per edge: U[:, t] =
                # vals[t]·e_rows[t], V[:, t] = e_cols[t]
                c = max(r, 1)
                un = np.zeros((self.shape[0], c), np.float32)
                vn = np.zeros((self.shape[1], c), np.float32)
                if r:
                    t = np.arange(r)
                    un[self.rows, t] = np.asarray(self.vals, np.float32)
                    vn[self.cols, t] = 1.0
            self._factors = (
                BlockMatrix.from_numpy(un, mesh=mesh, config=cfg,
                                       integral=self.integral),
                BlockMatrix.from_numpy(vn, mesh=mesh, config=cfg,
                                       integral=self.integral))
        return self._factors

    def materialize(self, mesh, config: Optional[MatrelConfig] = None):
        """ΔA as a dense BlockMatrix (elementwise contexts; rebindable
        under the ``delta_dense`` role). Cached per delta."""
        if self._dense_bm is None:
            from matrel_tpu_torch.core.blockmatrix import BlockMatrix
            cfg = config or default_config()
            self._dense_bm = BlockMatrix.from_numpy(
                self.to_dense_numpy(), mesh=mesh, config=cfg,
                integral=self.integral)
        return self._dense_bm

    def sparse(self, mesh, block_size: int,
               config: Optional[MatrelConfig] = None):
        """ΔA as a BlockSparseMatrix leaf payload — the S×S form whose
        products against sparse leaves dispatch the tile-intersection
        SpGEMM (ops/spgemm.py via executor._spgemm_dispatch). None for
        lowrank (no coordinate list to bucket)."""
        if self.kind == "lowrank":
            return None
        if self._sparse_bm is None or \
                self._sparse_bm.block_size != block_size:
            from matrel_tpu_torch.core.sparse import BlockSparseMatrix
            cfg = config or default_config()
            if self.kind == "coo":
                self._sparse_bm = BlockSparseMatrix.from_coo_arrays(
                    self.rows, self.cols, self.vals, self.shape,
                    block_size=block_size, mesh=mesh, config=cfg)
            else:
                self._sparse_bm = BlockSparseMatrix.from_numpy(
                    self.to_dense_numpy(), block_size=block_size,
                    mesh=mesh, config=cfg)
        return self._sparse_bm

    def coords(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(rows, cols, vals) of ΔA — the COO payload itself, or the
        nonzeros of the dense lowering."""
        if self.kind == "coo":
            return (self.rows, self.cols,
                    np.asarray(self.vals, np.float32))
        d = self.to_dense_numpy()
        r, c = np.nonzero(d)
        return r.astype(np.int64), c.astype(np.int64), d[r, c]

    def apply_to(self, old, mesh, config: Optional[MatrelConfig] = None):
        """The rebound value ``A' = A + ΔA`` in the OLD binding's
        representation: a dense BlockMatrix gets one scatter-add into a
        copy on its device; a BlockSparseMatrix rebuilds only its
        touched tiles (see :func:`_apply_block_sparse`).
        Integral/int_abs_max metadata composes conservatively so the
        precision planner's int-exactness proof stays honest."""
        from matrel_tpu_torch.core.blockmatrix import (BlockMatrix,
                                                       tensor_from_numpy)
        from matrel_tpu_torch.core.sparse import BlockSparseMatrix
        if isinstance(old, BlockSparseMatrix):
            # on a rank mesh the tile stack is whole on every rank:
            # every rank rebuilds the same touched tiles
            return _apply_block_sparse(old, self)
        if not isinstance(old, BlockMatrix):
            raise TypeError(
                f"register_delta target must be a BlockMatrix or "
                f"BlockSparseMatrix, got {type(old).__name__}")
        dev = old.data.device
        # on a rank mesh ``old.data`` is this rank's block: the entries
        # inside its rectangle land there, at block-local coordinates
        r0, r1, c0, c1 = _block_rect(old)
        if self.kind == "coo":
            rows = np.asarray(self.rows, np.int64)
            cols = np.asarray(self.cols, np.int64)
            vals = np.asarray(self.vals, np.float32)
            inside = (rows >= r0) & (rows < r1) & (cols >= c0) & (cols < c1)
            data = old.data.clone()
            data.index_put_(
                (torch.as_tensor(rows[inside] - r0, device=dev),
                 torch.as_tensor(cols[inside] - c0, device=dev)),
                tensor_from_numpy(vals[inside], old.data.dtype, dev),
                accumulate=True)
        else:
            pad = np.zeros(old.padded_shape, np.float32)
            d = self.to_dense_numpy()
            pad[: self.shape[0], : self.shape[1]] = d
            data = old.data + tensor_from_numpy(
                np.ascontiguousarray(pad[r0:r1, c0:c1]), old.data.dtype,
                dev)
        integral = bool(old.integral and self.integral)
        amax = None
        if integral and old.int_abs_max is not None:
            try:
                amax = float(old.int_abs_max) + float(
                    np.abs(self.to_dense_numpy()).max()
                    if self.kind != "coo"
                    else (np.abs(self.vals).max() if self.rank else 0.0))
            except ValueError:
                amax = None
        return dataclasses.replace(
            old, data=data, nnz=None, integral=integral,
            int_abs_max=amax)

    def signature(self) -> tuple:
        """Patch-plan reuse key: two deltas with equal signatures
        produce structurally identical patch plans, so the plane can
        rebind factor/dense leaves instead of recompiling (constant
        edge-batch streams hit this every step)."""
        return (self.kind, self.shape, self.rank, self.integral)


def _block_rect(bm) -> Tuple[int, int, int, int]:
    """(r0, r1, c0, c1) of the padded matrix ``bm.data`` holds: all of
    it on one card, this rank's block on a rank mesh."""
    if not getattr(bm.mesh, "ranked", False):
        return 0, bm.data.shape[0], 0, bm.data.shape[1]
    from matrel_tpu_torch.parallel import collectives as coll
    return coll.block_rect(bm.as_shard(), bm.mesh)


def _apply_block_sparse(old, delta: MatrixDelta):
    """``old + ΔA`` for a BlockSparseMatrix binding, tile by tile: the
    union of the old tiles and the tiles ΔA touches, each the f32 sum
    of the old tile and ΔA's tile (accumulated on the host in f32, as
    the dense lowering does), cast back to the old dtype; tiles left
    all zero drop (one zero tile stays when nothing is left) — the
    tiles ``BlockSparseMatrix.from_numpy`` of the dense sum keeps."""
    from matrel_tpu_torch.core.blockmatrix import tensor_from_numpy
    bs = old.block_size
    n, m = old.shape
    gc = -(-m // bs)
    orow, ocol = old.host_tiles()
    okeys = orow * gc + ocol
    rows, cols, vals = delta.coords()
    dkeys = (rows // bs) * gc + cols // bs
    keys = np.union1d(okeys, dkeys)
    dev = old.blocks.device
    blocks = torch.zeros((len(keys), bs, bs), dtype=torch.float32,
                         device=dev)
    blocks[torch.as_tensor(np.searchsorted(keys, okeys), device=dev)] = \
        old.blocks.float()
    if len(rows):
        dtiles, dpos = np.unique(dkeys, return_inverse=True)
        payload = np.zeros((len(dtiles), bs, bs), np.float32)
        np.add.at(payload, (dpos.ravel(), rows % bs, cols % bs), vals)
        at = torch.as_tensor(np.searchsorted(keys, dtiles), device=dev)
        blocks[at] += tensor_from_numpy(payload, torch.float32, dev)
    keep = (blocks != 0).flatten(1).any(dim=1).cpu().numpy()  # matlint: disable=ML001 a delta patch's new tile set — once per registered delta, not per query
    if not keep.any():
        keep[0] = True                 # one zero tile, as from_numpy
        blocks[0].zero_()
        keys = np.zeros_like(keys)
    keys, blocks = keys[keep], blocks[torch.as_tensor(keep, device=dev)]
    trows, tcols = keys // gc, keys % gc
    S = dataclasses.replace(
        old, blocks=blocks.to(old.dtype).contiguous(),
        block_rows=torch.as_tensor(trows.astype(np.int32), device=dev),
        block_cols=torch.as_tensor(tcols.astype(np.int32), device=dev))
    S._seed_host_tiles(trows, tcols)
    return S


def as_delta(payload, old, kind: str = "auto",
             config: Optional[MatrelConfig] = None) -> MatrixDelta:
    """Lift whatever the caller has into a :class:`MatrixDelta`.

    Accepted payloads: a COOMatrix; ``(rows, cols[, vals])`` index
    arrays (kind "coo"); ``(U, V)`` with ``ΔA = U·Vᵀ`` (kind
    "lowrank"); a same-shaped ndarray/BlockMatrix (kind "dense").
    ``kind="auto"`` disambiguates by shape; pass it explicitly when a
    2-tuple could mean either."""
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.coo import COOMatrix
    shape = tuple(old.shape)

    def _coo(rows, cols, vals=None):
        rows = np.asarray(rows, np.int64).ravel()
        cols = np.asarray(cols, np.int64).ravel()
        if vals is None:
            vals = np.ones(rows.shape, np.float32)
        vals = np.asarray(vals, np.float32).ravel()
        if rows.shape != cols.shape or rows.shape != vals.shape:
            raise ValueError("coo delta needs equal-length "
                             "rows/cols/vals")
        if rows.size and (rows.min() < 0 or rows.max() >= shape[0]
                          or cols.min() < 0 or cols.max() >= shape[1]):
            raise ValueError(
                f"coo delta indices out of bounds for {shape}")
        integral = bool(np.all(vals == np.round(vals)))
        return MatrixDelta(kind="coo", shape=shape, rows=rows,
                           cols=cols, vals=vals, integral=integral)

    def _lowrank(u, v):
        u = np.asarray(u, np.float32)
        v = np.asarray(v, np.float32)
        if u.ndim != 2 or v.ndim != 2 or u.shape[1] != v.shape[1] \
                or u.shape[0] != shape[0] or v.shape[0] != shape[1]:
            raise ValueError(
                f"lowrank delta needs U:({shape[0]},c) V:({shape[1]},c)"
                f"; got {u.shape}, {v.shape}")
        integral = bool(np.all(u == np.round(u))
                        and np.all(v == np.round(v)))
        return MatrixDelta(kind="lowrank", shape=shape, u=u, v=v,
                           integral=integral)

    def _dense(arr):
        if isinstance(arr, BlockMatrix):
            arr = arr.to_numpy()
        arr = np.asarray(arr, np.float32)
        if arr.shape != shape:
            raise ValueError(
                f"dense delta shape {arr.shape} != bound {shape}")
        integral = bool(np.all(arr == np.round(arr)))
        return MatrixDelta(kind="dense", shape=shape, dense=arr,
                           integral=integral)

    if isinstance(payload, COOMatrix):
        if tuple(payload.shape) != shape:
            raise ValueError(
                f"coo delta shape {payload.shape} != bound {shape}")
        return _coo(payload.rows, payload.cols, payload.vals)
    if isinstance(payload, MatrixDelta):
        return payload
    if kind == "coo":
        return _coo(*payload)
    if kind == "lowrank":
        return _lowrank(*payload)
    if kind == "dense":
        return _dense(payload)
    if kind != "auto":
        raise ValueError(f"unknown delta kind {kind!r} (expected "
                         f"'auto'/'coo'/'lowrank'/'dense')")
    if isinstance(payload, (tuple, list)):
        if len(payload) == 3:
            return _coo(*payload)
        if len(payload) == 2:
            a = np.asarray(payload[0])
            b = np.asarray(payload[1])
            if a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[1]:
                return _lowrank(a, b)
            if a.ndim == 1 and b.ndim == 1:
                return _coo(a, b)
        raise ValueError(
            "ambiguous delta payload — pass kind='coo' or 'lowrank'")
    return _dense(payload)


# ---------------------------------------------------------------------------
# Structural helpers
# ---------------------------------------------------------------------------


def _attr_tok(v) -> str:
    if v is None or isinstance(v, (bool, int, float, str)):
        return repr(v)
    if isinstance(v, (tuple, list)):
        return "[" + ",".join(_attr_tok(x) for x in v) + "]"
    return f"obj:{id(v)}"


def core_key(e: MatExpr, target_ids: frozenset) -> str:
    """Generation-invariant structural key: like the session's plan
    key, but the CHANGED matrix's leaves normalize to ``@T`` — so the
    same logical query over successive bindings of one catalog name
    keys identically, which is what lets the ``known`` map (and the
    patch-plan cache) match siblings across delta generations."""
    parts: List[str] = []

    def walk(n: MatExpr):
        if n.kind in ("leaf", "sparse_leaf", "coo_leaf"):
            m = n.attrs["matrix"]
            tok = "@T" if id(m) in target_ids else str(id(m))
            role = n.attrs.get("ivm_role")
            if role is not None:
                tok = f"@{role[0]}"
            parts.append(f"{n.kind}:{tok}:{n.shape}")
            return
        attrs = ",".join(f"{k}={_attr_tok(v)}"
                         for k, v in sorted(n.attrs.items()))
        parts.append(f"{n.kind}:{n.shape}:{attrs}(")
        for c in n.children:
            walk(c)
        parts.append(")")

    walk(e)
    return "|".join(parts)


def substitute(e: MatExpr, old, repl) -> MatExpr:
    """Replace every leaf bound to ``old`` (by identity) with a
    same-kind leaf over ``repl`` (a matrix) or with ``repl`` itself
    (a prepared MatExpr leaf). Interior structure and attrs are
    preserved — the substituted tree keys structurally identically to
    a fresh query over the new binding."""
    def walk(n: MatExpr) -> MatExpr:
        if n.kind in ("leaf", "sparse_leaf", "coo_leaf"):
            if n.attrs["matrix"] is old:
                if isinstance(repl, MatExpr):
                    return repl
                a = dict(n.attrs)
                a["matrix"] = repl
                return dataclasses.replace(n, attrs=a, nnz=getattr(
                    repl, "nnz", n.nnz), uid=next(E._ids))
            return n
        kids = tuple(walk(c) for c in n.children)
        if all(k is c for k, c in zip(kids, n.children)):
            return n
        return n.with_children(kids)

    return walk(e)


def depends_on(e: MatExpr, target_ids: frozenset,
               memo: Optional[dict] = None) -> bool:
    """Does the subtree read any leaf bound to a changed matrix?"""
    memo = memo if memo is not None else {}
    got = memo.get(e.uid)
    if got is not None:
        return got
    if e.kind in ("leaf", "sparse_leaf", "coo_leaf"):
        out = id(e.attrs["matrix"]) in target_ids
    else:
        out = any(depends_on(c, target_ids, memo) for c in e.children)
    memo[e.uid] = out
    return out


def estimate_flops(e: MatExpr,
                   config: Optional[MatrelConfig] = None,
                   memo: Optional[dict] = None) -> float:
    """Closed-form FLOP estimate of an expression — the patch-vs-
    recompute pricing input (``delta_est_saved_flops``). S×S matmuls
    that would dispatch the tile-intersection SpGEMM are priced by the
    dispatch's own pair estimate (executor.spgemm_estimates), so a
    sparse ΔA·B patch is credited the way it will actually lower."""
    cfg = config or default_config()
    memo = memo if memo is not None else {}

    def walk(n: MatExpr) -> float:
        if n.uid in memo:
            return 0.0            # shared DAG node: count once
        memo[n.uid] = True
        own = 0.0
        nm = float(n.shape[0]) * float(n.shape[1])
        if n.kind == "matmul":
            a, b = n.children
            own = 2.0 * a.shape[0] * a.shape[1] * b.shape[1]
            if a.kind in ("sparse_leaf", "coo_leaf") \
                    and b.kind in ("sparse_leaf", "coo_leaf"):
                from matrel_tpu_torch import executor as executor_lib
                if executor_lib._spgemm_dispatch(n, cfg):
                    est = executor_lib.spgemm_estimates(n, cfg)
                    bs = est.get("block_size") or cfg.block_size
                    own = 2.0 * max(est.get("est_pairs") or 1.0, 1.0) \
                        * float(bs) ** 3
        elif n.kind == "agg":
            # a reduction READS its child, the output is the cheap
            # part — costing the (n,1) output made rowSum(A) look
            # free and priced every aggregate patch out
            c = n.children[0]
            own = float(c.shape[0]) * float(c.shape[1])
        elif n.kind in ("elemwise", "scalar", "select_value",
                        "select_index", "join_index", "rank1"):
            own = nm
        elif n.kind in ("inverse", "solve"):
            own = float(n.children[0].shape[0]) ** 3
        return own + sum(walk(c) for c in n.children)

    return walk(e)


def _optimized_flops(e: MatExpr, mesh,
                     config: Optional[MatrelConfig] = None) -> float:
    """:func:`estimate_flops` on the OPTIMIZED tree — both sides of
    the patch-vs-recompute comparison compile through the optimizer
    (R2/R3 thin the factored aggregates, the chain DP re-associates
    (V·Uᵀ)·B into V·(Uᵀ·B)), so both are priced post-optimize."""
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.ir import rules as rules_lib
    cfg = config or default_config()
    try:
        opt = rules_lib.optimize(e, cfg,
                                 grid=mesh_lib.mesh_grid_shape(mesh),
                                 mesh=mesh)
    except Exception:           # pricing must never fail a register —
        opt = e                 # the raw tree is a safe overestimate
    return estimate_flops(opt, cfg)


# ---------------------------------------------------------------------------
# Patch derivation
# ---------------------------------------------------------------------------


#: Dynamic-leaf roles a patch plan rebinds across generations
#: (serve/ivm.py resolves them against the live context).
ROLE_FACTOR_U = ("factor_u",)
ROLE_FACTOR_V = ("factor_v",)
ROLE_DELTA_DENSE = ("delta_dense",)
ROLE_DELTA_SPARSE = ("delta_sparse",)
ROLE_TARGET_OLD = ("target_old",)
ROLE_TARGET_NEW = ("target_new",)
ROLE_OLD_RESULT = ("old_result",)


def _role_leaf(bm, role: tuple) -> MatExpr:
    """A leaf tagged with its rebind role (the ``ivm_role`` attr rides
    the plan's leaf_order so serve/ivm.py can rebind by role)."""
    kind = type(bm).__name__
    if kind == "BlockSparseMatrix":
        return bm.expr().with_attrs(ivm_role=role)
    return E.leaf(bm).with_attrs(ivm_role=role)


@dataclasses.dataclass
class PatchSpec:
    """One derivable patch: either an expression computing the PATCHED
    result directly (``old_result + Δf``, one compiled plan), or an
    iterative ``refine`` callable (the warm-restart family)."""

    rule: str                                 # DELTA_RULES member
    rules: Dict[str, int]                     # per-rule census
    est_patch_flops: float
    est_full_flops: float
    err_bound: float                          # bound ADDED by the patch
    expr: Optional[MatExpr] = None
    refine: Optional[Callable] = None
    rebindable: bool = True                   # factor/dense roles only
    known_keys: Tuple[str, ...] = ()          # sibling deps of the plan

    @property
    def est_saved_flops(self) -> float:
        return self.est_full_flops - self.est_patch_flops


class _Ctx:
    def __init__(self, old, new, delta: MatrixDelta, mesh, config,
                 known: Optional[dict]):
        self.old = old
        self.new = new
        self.delta = delta
        self.mesh = mesh
        self.config = config
        self.target_ids = frozenset({id(old)})
        self.known = known or {}
        self.census: Dict[str, int] = {}
        self.max_k = 0
        self.rebindable = True
        self.known_used: List[str] = []
        self.dep_memo: dict = {}

    def count(self, rule: str):
        self.census[rule] = self.census.get(rule, 0) + 1


def _delta_product(ctx: _Ctx, partner: MatExpr, side: str
                   ) -> Optional[MatExpr]:
    """ΔA·partner (side="left") or partner·ΔA (side="right") in the
    cheapest available form: sparse×sparse through the SpGEMM dispatch,
    else the thin factored product, else the dense delta leaf."""
    d = ctx.delta
    # S×S: the sparse delta against a sparse partner leaf is a native
    # SpGEMM through the kernel registry — consult the ONE dispatch
    # predicate so we only take this form when it will actually fire
    if partner.kind in ("sparse_leaf", "coo_leaf"):
        bs = getattr(partner.attrs["matrix"], "block_size",
                     ctx.config.block_size)
        sp = d.sparse(ctx.mesh, bs, ctx.config)
        if sp is not None:
            dleaf = _role_leaf(sp, ROLE_DELTA_SPARSE)
            node = (E.matmul(dleaf, partner) if side == "left"
                    else E.matmul(partner, dleaf))
            from matrel_tpu_torch import executor as executor_lib
            if executor_lib._spgemm_dispatch(node, ctx.config):
                ctx.count("spgemm")
                ctx.rebindable = False    # sparse payloads trace as
                return node               # constants — not rebindable
    fac = d.factors(ctx.mesh, ctx.config)
    if fac is not None:
        u, v = fac
        ul = _role_leaf(u, ROLE_FACTOR_U)
        vl = _role_leaf(v, ROLE_FACTOR_V)
        ctx.count("rank_k")
        ctx.max_k = max(ctx.max_k, u.shape[1], partner.shape[0],
                        partner.shape[1])
        if side == "left":
            # (U·Vᵀ)·B emitted pre-associated as U·(Vᵀ·B): the thin
            # ordering is the ESTIMATE, not a hope about the chain DP
            return E.matmul(ul, E.matmul(E.transpose(vl), partner))
        return E.matmul(E.matmul(partner, ul), E.transpose(vl))
    dl = _role_leaf(d.materialize(ctx.mesh, ctx.config),
                    ROLE_DELTA_DENSE)
    ctx.count("linear")
    node = (E.matmul(dl, partner) if side == "left"
            else E.matmul(partner, dl))
    ctx.max_k = max(ctx.max_k, partner.shape[0], partner.shape[1])
    return node


def _delta_leafwise(ctx: _Ctx, form: str = "factored") -> MatExpr:
    """ΔA as a same-shaped expression. ``form`` is the CONSUMER's
    preference: aggregate consumers want the FACTORED product ``U·Vᵀ``
    (they thin out through R3: ``rowSum(U·Vᵀ) → U·rowSum(Vᵀ)``, and
    the factor leaves stay rebindable); elementwise consumers want the
    dense materialization (a leaf costs nothing extra — the factored
    product would ADD an n·m·c multiply just to feed a pointwise op).
    Both fall back to the other when their form is unavailable."""
    fac = (ctx.delta.factors(ctx.mesh, ctx.config)
           if form == "factored" else None)
    if fac is not None:
        u, v = fac
        ctx.count("rank_k")
        ctx.max_k = max(ctx.max_k, u.shape[1])
        return E.matmul(_role_leaf(u, ROLE_FACTOR_U),
                        E.transpose(_role_leaf(v, ROLE_FACTOR_V)))
    ctx.count("linear")
    return _role_leaf(ctx.delta.materialize(ctx.mesh, ctx.config),
                      ROLE_DELTA_DENSE)


def _value_at(ctx: _Ctx, n: MatExpr, binding: str) -> MatExpr:
    """The subtree's VALUE at the old/new binding, cheapest first: a
    known sibling entry's materialized result as a leaf, else the tree
    itself with the target leaf swapped to the requested binding
    (re-evaluated inside the patch plan — priced honestly)."""
    ck = core_key(n, ctx.target_ids)
    hit = ctx.known.get(ck)
    if hit is not None:
        old_bm, new_bm = hit
        ctx.count("known")
        ctx.known_used.append(ck)
        bm = old_bm if binding == "old" else new_bm
        return _role_leaf(bm, ("known_" + binding, ck))
    if not depends_on(n, ctx.target_ids, ctx.dep_memo):
        return n
    if binding == "old":
        return substitute(n, ctx.old,
                          _role_leaf(ctx.old, ROLE_TARGET_OLD))
    return substitute(n, ctx.old, _role_leaf(ctx.new, ROLE_TARGET_NEW))


def _add(a: Optional[MatExpr], b: Optional[MatExpr],
         op: str = "add") -> Optional[MatExpr]:
    if a is None and b is None:
        return None
    if b is None:
        return a
    if a is None:
        if op == "sub":
            return E.scalar_op("mul", b, -1.0)
        return b
    return E.elemwise(op, a, b)


def _derive(ctx: _Ctx, n: MatExpr,
            form: str = "factored") -> Optional[MatExpr]:
    """Δ of a subtree under the registered update, or None for a
    structural zero (``form`` is the consuming context's preferred
    delta-leaf shape — see :func:`_delta_leafwise`). Raises
    :class:`DeltaIneligible` where no rule applies — the caller falls
    back to the transitive kill."""
    if not depends_on(n, ctx.target_ids, ctx.dep_memo):
        return None
    ck = core_key(n, ctx.target_ids)
    hit = ctx.known.get(ck)
    if hit is not None:
        # a sibling cached entry already carries this subtree's old
        # AND patched values — its delta enters as a leaf difference
        # instead of a re-derivation (propagation through the DAG)
        old_bm, new_bm = hit
        ctx.count("known")
        ctx.known_used.append(ck)
        return E.elemwise("sub",
                          _role_leaf(new_bm, ("known_new", ck)),
                          _role_leaf(old_bm, ("known_old", ck)))
    kind = n.kind
    if kind in ("leaf", "sparse_leaf", "coo_leaf"):
        return _delta_leafwise(ctx, form)
    if kind == "transpose":
        d = _derive(ctx, n.children[0], form)
        return None if d is None else E.transpose(d)
    if kind == "matmul":
        a, b = n.children
        a_dep = depends_on(a, ctx.target_ids, ctx.dep_memo)
        b_dep = depends_on(b, ctx.target_ids, ctx.dep_memo)
        # the sided fast forms when the changed operand IS the leaf:
        # emit the thin/sparse product directly
        terms: List[Optional[MatExpr]] = []
        if a_dep and not b_dep:
            if a.kind in ("leaf", "sparse_leaf", "coo_leaf"):
                return _delta_product(ctx, _value_at(ctx, b, "old"),
                                      "left")
            da = _derive(ctx, a)
            return None if da is None else E.matmul(
                da, _value_at(ctx, b, "old"))
        if b_dep and not a_dep:
            if b.kind in ("leaf", "sparse_leaf", "coo_leaf"):
                return _delta_product(ctx, _value_at(ctx, a, "old"),
                                      "right")
            db = _derive(ctx, b)
            return None if db is None else E.matmul(
                _value_at(ctx, a, "old"), db)
        # both sides change: Δ(a·b) = Δa·b_old + a_new·Δb (exact —
        # the Gram / linreg rank-k correction when a = bᵀ)
        ctx.count("rank_k_both")
        if a.kind in ("leaf", "sparse_leaf", "coo_leaf"):
            da_b = _delta_product(ctx, _value_at(ctx, b, "old"), "left")
        else:
            da = _derive(ctx, a)
            da_b = None if da is None else E.matmul(
                da, _value_at(ctx, b, "old"))
        if b.kind in ("leaf", "sparse_leaf", "coo_leaf"):
            a_db = _delta_product(ctx, _value_at(ctx, a, "new"),
                                  "right")
        else:
            db = _derive(ctx, b)
            a_db = None if db is None else E.matmul(
                _value_at(ctx, a, "new"), db)
        terms = [da_b, a_db]
        out = None
        for t in terms:
            out = _add(out, t)
        return out
    if kind == "elemwise":
        op = n.attrs["op"]
        a, b = n.children
        if a.shape != b.shape:
            # broadcast deltas are shape-ambiguous; keep the exact lane
            raise DeltaIneligible(f"broadcast elemwise {op}")
        if op in ("add", "sub"):
            return _add(_derive(ctx, a, "dense"),
                        _derive(ctx, b, "dense"), op)
        if op == "mul":
            da = _derive(ctx, a, "dense")
            db = _derive(ctx, b, "dense")
            t1 = None if da is None else E.elemwise(
                "mul", da, _value_at(ctx, b, "old"))
            t2 = None if db is None else E.elemwise(
                "mul", _value_at(ctx, a, "new"), db)
            return _add(t1, t2)
        if op == "div":
            if depends_on(b, ctx.target_ids, ctx.dep_memo):
                raise DeltaIneligible("div by a changed operand")
            da = _derive(ctx, a, "dense")
            return None if da is None else E.elemwise(
                "div", da, _value_at(ctx, b, "old"))
        raise DeltaIneligible(f"elemwise {op} is not linear")
    if kind == "scalar":
        op = n.attrs["op"]
        d = _derive(ctx, n.children[0], form)
        if d is None:
            return None
        if op == "mul":
            return E.scalar_op("mul", d, n.attrs["value"])
        if op == "add":
            return d
        raise DeltaIneligible("scalar pow is not linear")
    if kind == "agg":
        agg_kind, axis = n.attrs["agg"], n.attrs["axis"]
        if agg_kind not in ("sum", "avg"):
            raise DeltaIneligible(f"agg {agg_kind} is not linear")
        d = _derive(ctx, n.children[0], "factored")
        return None if d is None else E.agg(d, agg_kind, axis)
    if kind == "vec":
        d = _derive(ctx, n.children[0], "factored")
        return None if d is None else E.vec(d)
    if kind == "rank1":
        base, u, v = n.children
        if depends_on(u, ctx.target_ids, ctx.dep_memo) or \
                depends_on(v, ctx.target_ids, ctx.dep_memo):
            raise DeltaIneligible("rank1 with changed u/v")
        return _derive(ctx, base)
    raise DeltaIneligible(f"no delta rule for node kind {kind!r}")


def derive_patch(expr: MatExpr, old, new, delta: MatrixDelta,
                 old_result, mesh,
                 config: Optional[MatrelConfig] = None,
                 known: Optional[dict] = None) -> Optional[PatchSpec]:
    """Derive the patch for one cached entry ``old_result = expr`` (a
    tree over the OLD binding) under ``old → new = old + delta``.

    Returns None when no rule applies (the caller falls back to the
    transitive kill). ``known`` maps :func:`core_key` strings of
    sibling cached entries to their ``(old_result, patched_result)``
    BlockMatrices — the delta-propagation substrate."""
    cfg = config or default_config()
    refine = expr.attrs.get("delta_refine")
    est_full = _optimized_flops(expr, mesh, cfg)
    if callable(refine):
        # the iterative family (PageRank warm restart): re-solve from
        # the cached value instead of algebraic patching; the stamped
        # cost estimate (or a documented fraction) prices it
        est_patch = float(expr.attrs.get("delta_refine_flops")
                          or est_full * 0.25)
        return PatchSpec(rule="refine", rules={"refine": 1},
                         est_patch_flops=est_patch,
                         est_full_flops=est_full,
                         err_bound=float(
                             expr.attrs.get("delta_refine_bound")
                             or 0.0),
                         refine=refine, rebindable=False)
    ctx = _Ctx(old, new, delta, mesh, cfg, known)
    try:
        d = _derive(ctx, expr)
    except DeltaIneligible:
        return None
    base = _role_leaf(old_result, ROLE_OLD_RESULT)
    patched = base if d is None else E.elemwise("add", base, d)
    census = dict(ctx.census)
    if ctx.census.get("spgemm"):
        rule = "spgemm"
    elif ctx.census.get("rank_k_both"):
        rule = "rank_k_both"
    elif ctx.census.get("rank_k"):
        rule = "rank_k"
    else:
        rule = "linear"
    # exact iff the QUERY is provably integer-valued (ir/stats'
    # integer-exactness inference — the PR 7 int-path proof) AND the
    # delta is: integer patches of integer views compose exactly, so
    # graph-count maintenance asserts bit equality (err bound 0)
    from matrel_tpu_torch.ir import stats as stats_lib
    memo: dict = {}
    amax = stats_lib.integral_abs_bound(expr, memo)
    exact = bool(delta.integral
                 and (not old_result.dtype.is_floating_point
                      or (stats_lib.infer_integral(expr, memo)
                          # f32's contiguous-integer range: above it
                          # integer arithmetic in f32 rounds, so the
                          # "exact" claim needs the magnitude proof
                          # too (the int-tier overflow gate's rule)
                          and amax is not None
                          and amax <= 2.0 ** 24)))
    # error-bound composition: one f32 product unit per
    # contraction depth the patch adds, plus one for the combine —
    # integer-exact patches contribute zero (the int paths are exact)
    bound = 0.0 if exact else _F32_EPS * float(max(ctx.max_k, 1) + 1)
    est_patch = _optimized_flops(patched, mesh, cfg)
    return PatchSpec(rule=rule, rules=census,
                     est_patch_flops=est_patch,
                     est_full_flops=est_full,
                     err_bound=bound, expr=patched,
                     rebindable=ctx.rebindable,
                     known_keys=tuple(sorted(set(ctx.known_used))))


# ---------------------------------------------------------------------------
# Iterative refinement — the PageRank warm restart
# ---------------------------------------------------------------------------


def pagerank_warm_restart(adj: torch.Tensor, r0,
                          alpha: float = 0.85, rounds: int = 8,
                          tol: float = 1e-10) -> torch.Tensor:
    """Power-iteration PageRank over a (possibly updated) adjacency,
    STARTED from a cached rank vector instead of uniform — for a small
    ΔA the cached vector is already near the new fixed point, so a
    handful of rounds recovers what a cold start pays tens for (the
    iterative member of the delta-rule family).

    ``adj`` is the n×n adjacency tensor (any dtype) and ``r0`` a length-n
    vector (tensor or array); the iteration runs in float64 on
    ``adj``'s device and returns the rank vector there."""
    a = adj.to(torch.float64)
    n = a.shape[0]
    deg = a.sum(dim=1)
    w = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0),
                    torch.zeros((), dtype=torch.float64, device=a.device))
    dangling = (deg == 0).to(torch.float64)
    r = torch.as_tensor(r0, dtype=torch.float64,
                        device=a.device).reshape(-1)
    s = r.sum()
    if bool(s > 0):
        r = r / s
    for _ in range(max(rounds, 1)):
        contrib = a.T @ (w * r)
        dmass = (dangling @ r) / n
        nxt = alpha * (contrib + dmass) + (1.0 - alpha) / n
        if float((nxt - r).abs().sum()) < tol:  # matlint: disable=ML001 the warm restart's convergence test, one scalar a round as in the JAX package's; a streaming tick's refresh, not a query lowering
            r = nxt
            break
        r = nxt
    return r


def stamp_refine(expr: MatExpr, fn: Callable,
                 est_flops: Optional[float] = None,
                 err_bound: float = 0.0) -> MatExpr:
    """Stamp an expression with an iterative-refinement rule: on a
    registered delta, the plane calls ``fn(old_result, new_matrix,
    delta) -> BlockMatrix | ndarray`` instead of deriving an algebraic
    patch. The workload owns convergence; MV113's dynamic check still
    proves the refined result against fresh execution."""
    attrs = {"delta_refine": fn, "delta_refine_bound": float(err_bound)}
    if est_flops is not None:
        attrs["delta_refine_flops"] = float(est_flops)
    return expr.with_attrs(**attrs)


def delta_prefix(gen: int) -> str:
    """The result-cache key prefix of delta generation ``gen`` — the
    ``degr:``/``axisw:``/``prec:`` idiom: generation 0 (the delta
    plane never used) keeps the historical key format bit-identically;
    every later generation isolates its entries, so a patched result
    from generation N can never answer a query at N+1 without being
    re-patched or re-executed."""
    return "" if gen <= 0 else f"delta:{gen}|"
