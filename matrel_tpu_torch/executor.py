"""Executor — the counterpart of ``matrel_tpu/executor.py``.

Lowers an optimized, annotated MatExpr into a function over the leaf
tensors: each matmul goes to its planned strategy (one local product on
one card), the block-sparse operand to the SpMM kernel route, and
everything else to torch ops. PyTorch runs eagerly, so nothing stands
in for ``jax.jit``: ``compile_expr`` plans once and the returned
:class:`CompiledPlan` re-runs the lowered function.

Zero-padding invariant: every lowered intermediate is exactly 0 outside
its logical region; ops that would break it (scalar-add, pow ≤ 0,
broadcast add/sub/div) re-mask, and aggregates mask padding where zeros
would change the answer (max/min).

Lowered kinds: leaf, sparse_leaf, transpose, matmul, elemwise, scalar,
agg. Every other kind, and the S×S SpGEMM dispatch, raises
``NotPortedError``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

from matrel_tpu_torch.config import MatrelConfig, NotPortedError, default_config
from matrel_tpu_torch.core import mesh as mesh_lib, padding
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import Mesh
from matrel_tpu_torch.ir import rules
from matrel_tpu_torch.ir.expr import MatExpr, leaves as expr_leaves
from matrel_tpu_torch.parallel import planner, strategies

Tensor = torch.Tensor

LOWERED_KINDS = ("leaf", "sparse_leaf", "transpose", "matmul", "elemwise",
                 "scalar", "agg")


def _valid_mask(shape: Tuple[int, int], pshape: Tuple[int, int],
                device) -> Tensor:
    r = torch.arange(pshape[0], device=device)[:, None] < shape[0]
    c = torch.arange(pshape[1], device=device)[None, :] < shape[1]
    return r & c


def _mask_to_logical(x: Tensor, shape: Tuple[int, int]) -> Tensor:
    """Zero out everything outside the logical region."""
    if tuple(x.shape) == tuple(shape):
        return x
    return torch.where(_valid_mask(shape, tuple(x.shape), x.device), x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


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


def _pad_to(out: Tensor, pshape: Tuple[int, int]) -> Tensor:
    if tuple(out.shape) == tuple(pshape):
        return out
    return torch.nn.functional.pad(
        out, (0, pshape[1] - out.shape[1], 0, pshape[0] - out.shape[0]))


class Lowerer:
    """Recursively lowers MatExpr nodes to torch ops over padded tensors."""

    def __init__(self, mesh: Mesh, config: MatrelConfig):
        self.mesh = mesh
        self.config = config

    def lower(self, root: MatExpr, leaf_order: List[MatExpr]) -> Callable:
        """A function of the leaf tensors (in ``leaf_order``) returning
        the root's padded, contiguous value. Shared DAG nodes (by
        identity) are computed once per call."""
        leaf_pos = {l.uid: i for i, l in enumerate(leaf_order)}
        pshape = padding.padded_shape(root.shape, self.mesh)

        def fn(*leaf_arrays: Tensor) -> Tensor:
            memo: Dict[int, Tensor] = {}

            def ev(node: MatExpr) -> Tensor:
                if node.uid not in memo:
                    memo[node.uid] = self._eval(node, ev, leaf_arrays,
                                                leaf_pos)
                return memo[node.uid]

            return _pad_to(ev(root), pshape).contiguous()

        return fn

    # -- per-node lowering --------------------------------------------------

    def _eval(self, node: MatExpr, ev, leaf_arrays, leaf_pos) -> Tensor:
        k = node.kind
        if k == "leaf":
            return leaf_arrays[leaf_pos[node.uid]]
        if k == "sparse_leaf":
            # densify when a sparse matrix is used outside a matmul; the
            # SpMM path handles the matmul case
            return node.attrs["matrix"].to_dense(self.config).data
        if k == "transpose":
            return ev(node.children[0]).T
        if k == "matmul":
            return self._matmul(node, ev)
        if k == "elemwise":
            return self._elemwise(node, ev)
        if k == "scalar":
            return self._scalar(node, ev)
        if k == "agg":
            return self._agg(node, ev)
        raise NotPortedError(
            f"lowering for node kind {k!r} is not ported to "
            f"matrel_tpu_torch yet (ported: {', '.join(LOWERED_KINDS)})")

    @staticmethod
    def _same_operand(u: MatExpr, v: MatExpr) -> bool:
        """Do two nodes denote the SAME evaluated operand?"""
        if u is v or u.uid == v.uid:
            return True
        return (u.kind == "leaf" and v.kind == "leaf"
                and u.attrs["matrix"] is v.attrs["matrix"])

    def _matmul(self, node: MatExpr, ev) -> Tensor:
        l, r = node.children
        _spgemm_dispatch(node, self.config)   # S×S raises NotPortedError
        if l.kind == "sparse_leaf":
            from matrel_tpu_torch.ops import spmm as spmm_lib
            return spmm_lib.apply(l.attrs["matrix"], ev(r), r.shape,
                                  self.config)
        if r.kind == "sparse_leaf":
            # A·S = (Sᵀ·Aᵀ)ᵀ — the tile stack is transposed once and
            # memoised on the matrix
            from matrel_tpu_torch.ops import spmm as spmm_lib
            S = r.attrs["matrix"]
            st = getattr(S, "_transposed_memo", None)
            if st is None:
                st = S.transpose()
                S._transposed_memo = st
            out = spmm_lib.apply(st, ev(l).T, (l.shape[1], l.shape[0]),
                                 self.config)
            return out.T
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
                if side == "AtA":
                    mm = lambda p, q: strategies.run_matmul(
                        strategy, p.T, q, self.mesh, self.config)
                else:
                    mm = lambda p, q: strategies.run_matmul(
                        strategy, p, q.T, self.mesh, self.config)
                return symmetric_gram(x, mm).float()
        a, b = ev(l), ev(r)
        tier = node.attrs.get("precision_tier")
        if tier is not None and tier != "f32":
            # the tier owns the output dtype (int32 / f32 accumulation);
            # keep_input_dtype does not apply
            from matrel_tpu_torch.ops import precision as precision_lib
            mm = lambda p, q: strategies.run_matmul(
                strategy, p, q, self.mesh, self.config)
            return precision_lib.tiered_matmul(tier, a, b, mm)

        def storage_epi(out: Tensor) -> Tensor:
            if (self.config.keep_input_dtype and a.dtype == b.dtype
                    and out.dtype != a.dtype):
                out = out.to(a.dtype)
            return out

        return strategies.run_matmul(strategy, a, b, self.mesh,
                                     self.config, epilogue=storage_epi)

    def _elemwise(self, node: MatExpr, ev) -> Tensor:
        l, r = node.children
        a, b = ev(l), ev(r)
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
            out = _mask_to_logical(out, node.shape)
        return out

    @staticmethod
    def _slice_for_broadcast(x: Tensor, lshape, out_shape) -> Tensor:
        if lshape[0] == 1 and out_shape[0] != 1 and x.shape[0] != 1:
            x = x[:1, :]
        if lshape[1] == 1 and out_shape[1] != 1 and x.shape[1] != 1:
            x = x[:, :1]
        return x

    def _scalar(self, node: MatExpr, ev) -> Tensor:
        x = ev(node.children[0])
        op, v = node.attrs["op"], node.attrs["value"]
        s = torch.tensor(v, dtype=x.dtype, device=x.device)
        if op == "mul":
            return x * s
        if op == "add":
            out = x + s
            return _mask_to_logical(out, node.shape) if v != 0.0 else out
        if op == "pow":
            out = torch.pow(x, s)
            return _mask_to_logical(out, node.shape) if v <= 0 else out
        raise NotImplementedError(op)

    def _agg(self, node: MatExpr, ev) -> Tensor:
        (child,) = node.children
        x = ev(child)
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
            out = finish(red(torch.sum, x))
        elif kind == "count":
            out = finish(red(torch.sum, x != 0).to(x.dtype))
        elif kind == "avg":
            s = red(torch.sum, x)
            c = red(torch.sum, x != 0)
            out = finish(torch.where(c > 0, s / c.clamp(min=1),
                                     torch.zeros((), device=x.device)
                                     ).to(x.dtype))
        elif kind in ("max", "min"):
            fill = float("-inf") if kind == "max" else float("inf")
            masked = torch.where(_valid_mask((n, m), (pn, pm), x.device), x,
                                 torch.tensor(fill, dtype=x.dtype,
                                              device=x.device))
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


def _spgemm_dispatch(node: MatExpr, config=None) -> bool:
    """Will this matmul lower through the S×S SpGEMM path? Not ported:
    an S×S matmul (both operands sparse leaves) raises."""
    l, r = node.children
    if l.kind == "sparse_leaf" and r.kind == "sparse_leaf":
        raise NotPortedError(
            "S×S block-sparse matmul (SpGEMM, TPU kernels B4–B7) is not "
            "ported to matrel_tpu_torch yet")
    return False


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
        arrays = []
        for l in self.leaf_order:
            bound = (bindings or {}).get(l.uid)
            m = bound if bound is not None else l.attrs["matrix"]
            arrays.append(m.data)
        out = self.fn(*arrays)
        return BlockMatrix.from_array(
            out, self.optimized.shape, self.mesh,
            padding.canonical_spec(tuple(out.shape), self.mesh),
            nnz=self.optimized.nnz)

    def explain(self) -> str:
        """Optimized plan with strategies and inferred layouts."""
        from matrel_tpu_torch.ir.expr import pretty
        return "\n".join(["== Optimized plan ==",
                          pretty(self.optimized, mesh=self.mesh,
                                 config=self.config)])


def _check_one_mesh(expr: MatExpr, mesh: Mesh) -> None:
    """All leaves (dense and sparse) must live on the plan's device and
    grid."""
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
        sparse = [n for n in _walk(expr) if n.kind == "sparse_leaf"]
        first = lvs[0] if lvs else (sparse[0] if sparse else None)
        mesh = (first.attrs["matrix"].mesh if first is not None
                else mesh_lib.make_mesh(cfg.mesh_shape,
                                        cfg.mesh_axis_names))
    _check_one_mesh(expr, mesh)
    rule_hits: Dict[str, int] = {}
    t0 = time.perf_counter()
    opt = rules.optimize(expr, cfg, grid=mesh_lib.mesh_grid_shape(mesh),
                         mesh=mesh, counts=rule_hits)
    opt = planner.annotate_strategies(opt, mesh, cfg)
    optimize_ms = (time.perf_counter() - t0) * 1e3
    leaf_order = expr_leaves(opt)
    fn = Lowerer(mesh, cfg).lower(opt, leaf_order)
    return CompiledPlan(fn=fn, leaf_order=leaf_order, optimized=opt,
                        mesh=mesh, config=cfg,
                        meta={"optimize_ms": round(optimize_ms, 3),
                              "rule_hits": rule_hits})


def _walk(e: MatExpr):
    yield e
    for c in e.children:
        yield from _walk(c)

