"""Lazy matrix expression IR — the counterpart of ``matrel_tpu/ir/expr.py``.

Every DSL call constructs a ``MatExpr`` node; ``.compute()`` triggers
rewrite → chain-DP → physical planning → execution. Shape and sparsity
metadata live on the nodes so the optimizer runs as pure Python.

Every node kind of the JAX package is built and lowered here: the
leaves, transpose, matmul, elemwise, scalar, agg, vec, rank1, solve and
inverse, and the relational σ/⋈ nodes (select_value, select_index,
select_block, join_index, join_value, join_rows, join_cols). A
predicate or merge attr is a callable over torch tensors, or for joins
a structured string (``JOIN_PREDS`` / ``JOIN_MERGES``).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.ir import stats

_ids = itertools.count()

ELEMWISE_OPS = ("add", "sub", "mul", "div", "min", "max")
AGG_KINDS = ("sum", "count", "avg", "max", "min")
AGG_AXES = ("row", "col", "all", "diag")
SCALAR_OPS = ("add", "mul", "pow")


@dataclasses.dataclass(frozen=True)
class MatExpr:
    """One IR node. Immutable; children are MatExpr instances; equality
    and hashing by identity (exprs are DAG nodes, not values)."""

    kind: str
    children: Tuple["MatExpr", ...]
    shape: Tuple[int, int]
    nnz: Optional[int]
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)
    uid: int = dataclasses.field(default_factory=lambda: next(_ids))

    def __eq__(self, other):  # noqa: D105
        return self is other

    def __hash__(self):
        return self.uid

    # -- metadata ----------------------------------------------------------

    @property
    def density(self) -> float:
        return stats.density_of(self.nnz, self.shape)

    def with_attrs(self, **kw: Any) -> "MatExpr":
        a = dict(self.attrs)
        a.update(kw)
        return dataclasses.replace(self, attrs=a, uid=next(_ids))

    def with_children(self, children: Tuple["MatExpr", ...]) -> "MatExpr":
        return dataclasses.replace(self, children=tuple(children),
                                   uid=next(_ids))

    # -- DSL ---------------------------------------------------------------

    def t(self) -> "MatExpr":
        return transpose(self)

    def multiply(self, other) -> "MatExpr":
        return matmul(self, as_expr(other))

    def matmul(self, other) -> "MatExpr":
        return matmul(self, as_expr(other))

    def add(self, other) -> "MatExpr":
        return elemwise("add", self, as_expr(other))

    def subtract(self, other) -> "MatExpr":
        return elemwise("sub", self, as_expr(other))

    def elem_multiply(self, other) -> "MatExpr":
        return elemwise("mul", self, as_expr(other))

    def divide(self, other) -> "MatExpr":
        return elemwise("div", self, as_expr(other))

    def elem_min(self, other) -> "MatExpr":
        return elemwise("min", self, as_expr(other))

    def elem_max(self, other) -> "MatExpr":
        return elemwise("max", self, as_expr(other))

    def add_scalar(self, s: float) -> "MatExpr":
        return scalar_op("add", self, s)

    def multiply_scalar(self, s: float) -> "MatExpr":
        return scalar_op("mul", self, s)

    def power(self, p: float) -> "MatExpr":
        return scalar_op("pow", self, p)

    def row_sum(self) -> "MatExpr":
        return agg(self, "sum", "row")

    def col_sum(self) -> "MatExpr":
        return agg(self, "sum", "col")

    def sum(self) -> "MatExpr":
        return agg(self, "sum", "all")

    def trace(self) -> "MatExpr":
        return agg(self, "sum", "diag")

    def row_max(self) -> "MatExpr":
        return agg(self, "max", "row")

    def row_min(self) -> "MatExpr":
        return agg(self, "min", "row")

    def col_max(self) -> "MatExpr":
        return agg(self, "max", "col")

    def col_min(self) -> "MatExpr":
        return agg(self, "min", "col")

    def row_count(self) -> "MatExpr":
        return agg(self, "count", "row")

    def col_count(self) -> "MatExpr":
        return agg(self, "count", "col")

    def row_avg(self) -> "MatExpr":
        return agg(self, "avg", "row")

    def col_avg(self) -> "MatExpr":
        return agg(self, "avg", "col")

    def norm(self, kind: str = "fro") -> "MatExpr":
        """Matrix norm as a (1,1) expression (sugar over existing nodes)."""
        if kind == "fro":
            return scalar_op("pow", agg(elemwise("mul", self, self),
                                        "sum", "all"), 0.5)
        if kind in ("l1", "max"):
            absa = elemwise("max", self, self.multiply_scalar(-1.0))
            return agg(absa, "sum" if kind == "l1" else "max", "all")
        raise ValueError(f"unknown norm kind {kind!r} "
                         "(expected 'fro', 'l1', or 'max')")

    def inverse(self) -> "MatExpr":
        return inverse(self)

    def solve(self, b, assume: str = "general") -> "MatExpr":
        return solve(self, as_expr(b), assume=assume)

    def vec(self) -> "MatExpr":
        return vec(self)

    def rank_one_update(self, u, v) -> "MatExpr":
        return rank_one_update(self, as_expr(u), as_expr(v))

    def select_value(self, predicate: Callable,
                     fill: float = 0.0) -> "MatExpr":
        return select_value(self, predicate, fill)

    def select_index(self, *, rows=None, cols=None) -> "MatExpr":
        return select_index(self, rows=rows, cols=cols)

    def join_on_index(self, other, merge) -> "MatExpr":
        return join_on_index(self, as_expr(other), merge)

    def join_on_value(self, other, merge, predicate=None) -> "MatExpr":
        return join_on_value(self, as_expr(other), merge, predicate)

    def __matmul__(self, other):
        return self.multiply(other)

    def __add__(self, other):
        if isinstance(other, (int, float)):
            return self.add_scalar(other)
        return self.add(other)

    def __sub__(self, other):
        if isinstance(other, (int, float)):
            return self.add_scalar(-other)
        return self.subtract(other)

    def __mul__(self, other):
        if isinstance(other, (int, float)):
            return self.multiply_scalar(other)
        return self.elem_multiply(other)

    def __rmul__(self, other):
        if isinstance(other, (int, float)):
            return self.multiply_scalar(other)
        return NotImplemented

    def __truediv__(self, other):
        if isinstance(other, (int, float)):
            return self.multiply_scalar(1.0 / other)
        return self.divide(other)

    # -- actions -----------------------------------------------------------

    def compute(self, session=None) -> BlockMatrix:
        """Optimize + plan + execute (the Spark 'action' analogue)."""
        from matrel_tpu_torch.session import get_or_create_session
        sess = session or get_or_create_session()
        return sess.compute(self)

    def to_numpy(self, session=None):
        return self.compute(session).to_numpy()

    def optimized(self, config=None) -> "MatExpr":
        from matrel_tpu_torch.ir.rules import optimize
        return optimize(self, config)

    def explain(self, config=None) -> str:
        opt = self.optimized(config)
        return ("== Logical plan ==\n" + pretty(self)
                + "\n== Optimized plan ==\n" + pretty(opt))

    def __repr__(self):
        return f"MatExpr<{self.kind} {self.shape} nnz={self.nnz}>"


# -- constructors (shape/sparsity inference lives here) ---------------------


def as_expr(x: Union[MatExpr, BlockMatrix]) -> MatExpr:
    if isinstance(x, MatExpr):
        return x
    if isinstance(x, BlockMatrix):
        return leaf(x)
    make = getattr(x, "expr", None)       # sparse leaves lift themselves
    if callable(make):
        e = make()
        if isinstance(e, MatExpr):
            return e
    raise TypeError(f"cannot lift {type(x)} into MatExpr")


def leaf(m: BlockMatrix) -> MatExpr:
    return MatExpr("leaf", (), tuple(m.shape), m.nnz, {"matrix": m})


def transpose(a: MatExpr) -> MatExpr:
    return MatExpr("transpose", (a,), (a.shape[1], a.shape[0]), a.nnz)


def matmul(a: MatExpr, b: MatExpr) -> MatExpr:
    if a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shape mismatch: {a.shape} x {b.shape}")
    n, k, m = a.shape[0], a.shape[1], b.shape[1]
    return MatExpr("matmul", (a, b), (n, m),
                   stats.matmul_out_nnz(n, k, m, a.nnz, b.nnz))


def elemwise(op: str, a: MatExpr, b: MatExpr) -> MatExpr:
    if op not in ELEMWISE_OPS:
        raise ValueError(f"unknown elementwise op {op}")
    if a.shape != b.shape:
        bcast_ok = (
            (a.shape[0] == b.shape[0] and (a.shape[1] == 1 or b.shape[1] == 1))
            or (a.shape[1] == b.shape[1] and (a.shape[0] == 1 or b.shape[0] == 1))
            or b.shape == (1, 1) or a.shape == (1, 1)
        )
        if not bcast_ok:
            raise ValueError(f"elementwise shape mismatch: {a.shape} vs {b.shape}")
    shape = (max(a.shape[0], b.shape[0]), max(a.shape[1], b.shape[1]))
    da, db = a.density, b.density
    if op in ("mul", "div"):
        d = stats.elemmul_density(da, db) if op == "mul" else da
    else:
        d = stats.add_density(da, db)
    nnz = (None if (a.nnz is None and b.nnz is None)
           else stats.nnz_from_density(d, shape))
    return MatExpr("elemwise", (a, b), shape, nnz, {"op": op})


def scalar_op(op: str, a: MatExpr, s: float) -> MatExpr:
    if op not in SCALAR_OPS:
        raise ValueError(f"unknown scalar op {op}")
    if op == "mul":
        nnz = a.nnz if s != 0 else 0
    elif op == "add":
        nnz = a.nnz if s == 0 else None  # adding a scalar densifies
    else:  # pow
        nnz = a.nnz
    return MatExpr("scalar", (a,), a.shape, nnz, {"op": op, "value": float(s)})


def agg(a: MatExpr, kind: str, axis: str) -> MatExpr:
    if kind not in AGG_KINDS:
        raise ValueError(f"unknown agg kind {kind}")
    if axis not in AGG_AXES:
        raise ValueError(f"unknown agg axis {axis}")
    if axis == "diag" and a.shape[0] != a.shape[1]:
        raise ValueError(f"diag aggregate needs a square matrix, got {a.shape}")
    shape = {"row": (a.shape[0], 1), "col": (1, a.shape[1]),
             "all": (1, 1), "diag": (1, 1)}[axis]
    return MatExpr("agg", (a,), shape, None, {"agg": kind, "axis": axis})


def vec(a: MatExpr) -> MatExpr:
    """Column-major vectorisation vec(A): (n,m) → (n*m, 1)."""
    return MatExpr("vec", (a,), (a.shape[0] * a.shape[1], 1), a.nnz)


def rank_one_update(a: MatExpr, u: MatExpr, v: MatExpr) -> MatExpr:
    """A + u·vᵀ with u:(n,1), v:(m,1)."""
    n, m = a.shape
    if u.shape != (n, 1) or v.shape != (m, 1):
        raise ValueError(
            f"rank_one_update expects u:({n},1) v:({m},1); got {u.shape}, {v.shape}")
    return MatExpr("rank1", (a, u, v), a.shape, None)


def inverse(a: MatExpr) -> MatExpr:
    """A⁻¹ for square A (a dense local solve in the JAX package)."""
    n, m = a.shape
    if n != m:
        raise ValueError(f"inverse needs a square matrix, got {a.shape}")
    return MatExpr("inverse", (a,), a.shape, None)


def solve(a: MatExpr, b: MatExpr, assume: str = "general") -> MatExpr:
    """X = A⁻¹·B (solve A·X = B) for square A, on the logical shapes."""
    if assume not in ("general", "pos"):
        raise ValueError(f"solve assume must be 'general' or 'pos', "
                         f"got {assume!r}")
    n, m = a.shape
    if n != m:
        raise ValueError(f"solve needs a square lhs, got {a.shape}")
    if b.shape[0] != n:
        raise ValueError(f"solve shape mismatch: {a.shape} x {b.shape}")
    return MatExpr("solve", (a, b), b.shape, None, {"assume": assume})


def select_value(a: MatExpr, predicate: Callable,
                 fill: float = 0.0) -> MatExpr:
    """Relational σ on entry values (static-shape semantics)."""
    return MatExpr("select_value", (a,), a.shape, a.nnz,
                   {"predicate": predicate, "fill": float(fill)})


def select_index(a: MatExpr, *, rows=None, cols=None) -> MatExpr:
    """Relational σ on indices: keep rows/cols where the predicate holds
    (callables over index tensors, or None)."""
    return MatExpr("select_index", (a,), a.shape, a.nnz,
                   {"rows": rows, "cols": cols})


def join_on_index(a: MatExpr, b: MatExpr, merge) -> MatExpr:
    """⋈ on entry index equality: C[i,j] = merge(A[i,j], B[i,j]).
    ``merge`` is a binary callable over tensors or a structured string
    ("left"/"right"/"add"/"mul"), which lets the planner infer the
    output dtype."""
    if a.shape != b.shape:
        raise ValueError(f"join_on_index shape mismatch: {a.shape} vs {b.shape}")
    merge_kind, merge_fn = resolve_join_merge(merge)
    return MatExpr("join_index", (a, b), a.shape, None,
                   {"merge": merge_fn, "merge_kind": merge_kind})


JOIN_PREDS = ("eq", "lt", "le", "gt", "ge")
JOIN_MERGES = ("left", "right", "add", "mul")


def resolve_join_pred(pred):
    """(pred_kind, callable) for a structured-or-callable predicate.
    Structured kinds compare va ? vb: "lt" means va < vb."""
    if pred is None or callable(pred):
        return None, pred
    if pred not in JOIN_PREDS:
        raise ValueError(f"unknown join predicate {pred!r}; expected a "
                         f"callable or one of {JOIN_PREDS}")
    import operator
    fn = {"eq": operator.eq, "lt": operator.lt, "le": operator.le,
          "gt": operator.gt, "ge": operator.ge}[pred]
    return pred, fn


def _take_left(a, b):
    # broadcast WITHOUT arithmetic on b: a + 0*b turns a non-finite
    # discarded operand into NaN (inf·0)
    import torch
    return a + torch.zeros_like(b)


def resolve_join_merge(merge):
    """(merge_kind, callable) for a structured-or-callable merge."""
    if callable(merge):
        return None, merge
    if merge not in JOIN_MERGES:
        raise ValueError(f"unknown join merge {merge!r}; expected a "
                         f"callable or one of {JOIN_MERGES}")
    fn = {"left": _take_left,
          "right": lambda a, b: _take_left(b, a),
          "add": lambda a, b: a + b,
          "mul": lambda a, b: a * b}[merge]
    return merge, fn


def join_on_value(a: MatExpr, b: MatExpr, merge,
                  predicate=None) -> MatExpr:
    """⋈ on values: the (n·m_A) × (n·m_B) pair matrix over the
    column-major entries of A and B, holding merge(va, vb) where
    predicate(va, vb) holds and 0 elsewhere, as a lazy node.
    Materialising it is capped by ``config.join_pair_cap_entries``; an
    aggregate over it never materialises the pairs: structured
    predicate/merge strings stream in O((na+nb)·log nb) by sort
    (``relational/value_join.py``), callables fall back to capped
    chunkwise enumeration."""
    pred_kind, pred_fn = resolve_join_pred(predicate)
    merge_kind, merge_fn = resolve_join_merge(merge)
    na = a.shape[0] * a.shape[1]
    nb = b.shape[0] * b.shape[1]
    return MatExpr("join_value", (a, b), (na, nb), None,
                   {"merge": merge_fn, "predicate": pred_fn,
                    "merge_kind": merge_kind, "pred_kind": pred_kind})


# -- utilities --------------------------------------------------------------


def leaves(e: MatExpr) -> List[MatExpr]:
    """All leaf nodes in evaluation order (deduped by identity)."""
    seen: Dict[int, MatExpr] = {}

    def walk(n: MatExpr):
        if n.kind == "leaf":
            seen.setdefault(n.uid, n)
        for c in n.children:
            walk(c)

    walk(e)
    return list(seen.values())


def pretty(e: MatExpr, indent: int = 0, mesh=None,
           _lmemo: Optional[dict] = None, config=None) -> str:
    """Plan printer; with ``mesh`` each non-canonically-laid node is
    annotated ``layout=...`` from planner.infer_layout."""
    pad = "  " * indent
    extra = ""
    if e.kind == "elemwise":
        extra = f" op={e.attrs['op']}"
    elif e.kind == "scalar":
        extra = f" op={e.attrs['op']} v={e.attrs['value']}"
    elif e.kind == "agg":
        extra = f" {e.attrs['agg']}/{e.attrs['axis']}"
    elif e.kind == "matmul" and "strategy" in e.attrs:
        extra = f" strategy={e.attrs['strategy']}"
        if "strategy_source" in e.attrs:
            extra += f"[{e.attrs['strategy_source']}]"
        if "precision_tier" in e.attrs:
            extra += f" precision={e.attrs['precision_tier']}"
    elif e.kind in ("join_rows", "join_cols") and "replicate" in e.attrs:
        extra = f" replicate={e.attrs['replicate']}"
    elif e.kind == "join_value":
        mk = e.attrs.get("merge_kind") or "<callable>"
        pk = e.attrs.get("pred_kind") or (
            "<callable>" if e.attrs.get("predicate") else "always")
        extra = f" merge={mk} pred={pk}"
    if mesh is not None:
        from matrel_tpu_torch.parallel import planner as _pl
        if _lmemo is None:
            _lmemo = {}
        lay = _pl.infer_layout(e, mesh, _lmemo, config)
        if lay != "2d":
            extra += f" layout={lay}"
    line = f"{pad}{e.kind}{extra} shape={e.shape} nnz={e.nnz}\n"
    return line + "".join(pretty(c, indent + 1, mesh, _lmemo, config)
                          for c in e.children)
