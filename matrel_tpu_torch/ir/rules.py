"""Algebraic rewrite rules — the counterpart of ``matrel_tpu/ir/rules.py``
(the MatfastOptimizer rule batch):

  R1 (Aᵀ)ᵀ → A
  R2 (A·B)ᵀ → Bᵀ·Aᵀ ; (A∘B)ᵀ → Aᵀ∘Bᵀ ; (sA)ᵀ → s(Aᵀ)
  R3 aggregation push-down into multiply / transpose / scalar / add
  R4 scalar folding
  R5 index-selection push-down
  R6 matrix-chain DP reorder (chain.py)
  R7 solve fusion: A⁻¹·B → solve(A,B) ; A·B⁻¹ → solve(Bᵀ,Aᵀ)ᵀ
  R8 rank-1 multiply push-through

Each rule is a bottom-up tree transform; the batch runs to a bounded
fixpoint, Catalyst-style. Rule names and hit counts match the JAX
package's, so the two optimizers can be compared hit for hit.
"""

from __future__ import annotations

from typing import Callable, List, Optional

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.ir import chain as chain_lib
from matrel_tpu_torch.ir.expr import (
    MatExpr, agg, elemwise, matmul, scalar_op, select_index, solve,
    transpose,
)

Rule = Callable[[MatExpr], Optional[MatExpr]]


def _rewrite_bottom_up(e: MatExpr, rule: Rule,
                       counts: Optional[dict] = None) -> MatExpr:
    new_children = tuple(_rewrite_bottom_up(c, rule, counts)
                         for c in e.children)
    if any(nc is not oc for nc, oc in zip(new_children, e.children)):
        e = e.with_children(new_children)
    out = rule(e)
    if out is not None and counts is not None:
        name = getattr(rule, "__name__", str(rule))
        counts[name] = counts.get(name, 0) + 1
    return out if out is not None else e


def transpose_rules(e: MatExpr) -> Optional[MatExpr]:
    if e.kind != "transpose":
        return None
    (c,) = e.children
    if c.kind == "transpose":  # (Aᵀ)ᵀ → A
        return c.children[0]
    if c.kind == "matmul":  # (A·B)ᵀ → Bᵀ·Aᵀ
        a, b = c.children
        return matmul(transpose(b), transpose(a))
    if c.kind == "elemwise":  # (A∘B)ᵀ → Aᵀ∘Bᵀ  (shapes must match exactly)
        a, b = c.children
        if a.shape == b.shape:
            return elemwise(c.attrs["op"], transpose(a), transpose(b))
        return None
    if c.kind == "scalar":  # (s∘A)ᵀ → s∘(Aᵀ)
        return scalar_op(c.attrs["op"], transpose(c.children[0]),
                         c.attrs["value"])
    return None


def agg_pushdown(e: MatExpr) -> Optional[MatExpr]:
    if e.kind != "agg":
        return None
    kind, axis = e.attrs["agg"], e.attrs["axis"]
    (c,) = e.children
    if kind != "sum":
        return None  # max/min/count/avg don't distribute over matmul
    if c.kind == "matmul":
        a, b = c.children
        if axis == "row":   # rowSum(A·B) = A · rowSum(B)
            return matmul(a, agg(b, "sum", "row"))
        if axis == "col":   # colSum(A·B) = colSum(A) · B
            return matmul(agg(a, "sum", "col"), b)
        if axis == "all":   # sum(A·B) = colSum(A) · rowSum(B)
            return matmul(agg(a, "sum", "col"), agg(b, "sum", "row"))
        if axis == "diag":  # trace(A·B) = sum(A ⊙ Bᵀ)
            if a.shape == (b.shape[1], b.shape[0]):
                return agg(elemwise("mul", a, transpose(b)), "sum", "all")
        return None
    if c.kind == "transpose":
        inner = c.children[0]
        if axis == "row":   # rowSum(Aᵀ) = colSum(A)ᵀ
            return transpose(agg(inner, "sum", "col"))
        if axis == "col":
            return transpose(agg(inner, "sum", "row"))
        if axis in ("all", "diag"):  # invariant under transpose
            return agg(inner, "sum", axis)
        return None
    if c.kind == "scalar" and c.attrs["op"] == "mul":
        return scalar_op("mul", agg(c.children[0], "sum", axis),
                         c.attrs["value"])
    if c.kind == "elemwise" and c.attrs["op"] in ("add", "sub") \
            and c.children[0].shape == c.children[1].shape:
        a, b = c.children
        return elemwise(c.attrs["op"], agg(a, "sum", axis),
                        agg(b, "sum", axis))
    if c.kind == "rank1":
        a, u, v = c.children
        if axis == "row":
            return elemwise("add", agg(a, "sum", "row"),
                            matmul(u, agg(v, "sum", "all")))
        if axis == "col":
            return elemwise("add", agg(a, "sum", "col"),
                            matmul(agg(u, "sum", "all"), transpose(v)))
        if axis == "all":
            return elemwise("add", agg(a, "sum", "all"),
                            matmul(agg(u, "sum", "all"),
                                   agg(v, "sum", "all")))
    return None


def scalar_folding(e: MatExpr) -> Optional[MatExpr]:
    if e.kind != "scalar":
        return None
    op, v = e.attrs["op"], e.attrs["value"]
    (c,) = e.children
    if op == "mul" and v == 1.0:
        return c
    if op == "add" and v == 0.0:
        return c
    if op == "pow" and v == 1.0:
        return c
    if c.kind == "scalar" and c.attrs["op"] == op and op in ("mul", "add"):
        merged = v * c.attrs["value"] if op == "mul" else v + c.attrs["value"]
        return scalar_op(op, c.children[0], merged)
    return None


def selection_pushdown(e: MatExpr) -> Optional[MatExpr]:
    if e.kind != "select_index":
        return None
    rows, cols = e.attrs["rows"], e.attrs["cols"]
    (c,) = e.children
    if c.kind == "transpose":
        return transpose(select_index(c.children[0], rows=cols, cols=rows))
    if c.kind == "elemwise" and c.children[0].shape == c.children[1].shape:
        a, b = c.children
        return elemwise(c.attrs["op"],
                        select_index(a, rows=rows, cols=cols),
                        select_index(b, rows=rows, cols=cols))
    if c.kind == "scalar" and c.attrs["op"] == "mul":
        return scalar_op("mul",
                         select_index(c.children[0], rows=rows, cols=cols),
                         c.attrs["value"])
    if c.kind == "matmul":
        a, b = c.children
        if rows is not None or cols is not None:
            na = select_index(a, rows=rows, cols=None) if rows is not None else a
            nb = select_index(b, rows=None, cols=cols) if cols is not None else b
            if na is not a or nb is not b:
                return matmul(na, nb)
    return None


def rank1_pushdown(e: MatExpr) -> Optional[MatExpr]:
    """(A + u·vᵀ)·B → A·B + u·(vᵀ·B) ; B·(A + u·vᵀ) → B·A + (B·u)·vᵀ."""
    if e.kind != "matmul":
        return None
    a, b = e.children
    if a.kind == "rank1":
        base, u, v = a.children
        return elemwise("add", matmul(base, b),
                        matmul(u, matmul(transpose(v), b)))
    if b.kind == "rank1":
        base, u, v = b.children
        return elemwise("add", matmul(a, base),
                        matmul(matmul(a, u), transpose(v)))
    return None


def solve_fusion(e: MatExpr) -> Optional[MatExpr]:
    """A⁻¹·B → solve(A, B); A·B⁻¹ → solve(Bᵀ, Aᵀ)ᵀ; (A⁻¹)⁻¹ → A."""
    if e.kind == "inverse" and e.children[0].kind == "inverse":
        return e.children[0].children[0]
    if e.kind != "matmul":
        return None
    a, b = e.children
    if a.kind == "inverse":
        return solve(a.children[0], b)
    if b.kind == "inverse":
        return transpose(solve(transpose(b.children[0]), transpose(a)))
    return None


_RULES: List[Rule] = [
    transpose_rules,
    agg_pushdown,
    scalar_folding,
    selection_pushdown,
    solve_fusion,
    rank1_pushdown,
]

_MAX_ITERS = 10


def apply_rewrites(e: MatExpr, counts: Optional[dict] = None) -> MatExpr:
    """Run the rule batch to fixpoint (bounded)."""
    for _ in range(_MAX_ITERS):
        before = e
        for rule in _RULES:
            e = _rewrite_bottom_up(e, rule, counts)
        if _same_structure(e, before):
            break
    return e


def _same_structure(a: MatExpr, b: MatExpr) -> bool:
    if a is b:
        return True
    if (a.kind != b.kind or a.shape != b.shape
            or len(a.children) != len(b.children)):
        return False
    scalar = (int, float, str, bool, type(None))
    for k in set(a.attrs) | set(b.attrs):
        va, vb = a.attrs.get(k), b.attrs.get(k)
        if isinstance(va, scalar) and isinstance(vb, scalar):
            if va != vb:
                return False
        elif va is not vb:
            return False
    return all(_same_structure(x, y) for x, y in zip(a.children, b.children))


def common_subexpressions(e: MatExpr) -> MatExpr:
    """Hash-consing: structurally identical subtrees collapse to ONE
    node, so the executor's identity-keyed memo computes them once."""
    table: dict = {}

    def key_of(n: MatExpr, child_keys) -> tuple:
        attr_items = []
        for k, v in sorted(n.attrs.items()):
            if callable(v) or not isinstance(v, (int, float, str, bool,
                                                 type(None))):
                attr_items.append((k, id(v)))
            else:
                attr_items.append((k, v))
        return (n.kind, n.shape, tuple(attr_items), tuple(child_keys))

    def walk(n: MatExpr) -> tuple:
        child_pairs = [walk(c) for c in n.children]
        child_keys = [k for k, _ in child_pairs]
        new_children = tuple(c for _, c in child_pairs)
        k = key_of(n, child_keys)
        if k in table:
            return k, table[k]
        if any(nc is not oc for nc, oc in zip(new_children, n.children)):
            n = n.with_children(new_children)
        table[k] = n
        return k, n

    return walk(e)[1]


def optimize(e: MatExpr, config: Optional[MatrelConfig] = None,
             grid: tuple = (1, 1), mesh=None,
             counts: Optional[dict] = None) -> MatExpr:
    """Full logical optimization: rewrites, chain-DP reorder, CSE.
    ``counts`` accumulates per-rule hit counts plus ``chain_dp`` when
    the reorder restructured a chain."""
    cfg = config or default_config()
    if cfg.rewrite_rules:
        e = apply_rewrites(e, counts)
    if cfg.chain_opt:
        reordered = chain_lib.reorder_chains(e, grid, mesh, cfg)
        if counts is not None and reordered is not e \
                and not _same_structure(reordered, e):
            counts["chain_dp"] = counts.get("chain_dp", 0) + 1
        e = reordered
        if cfg.rewrite_rules:
            e = apply_rewrites(e, counts)  # reorder can expose new folds
    if cfg.rewrite_rules:
        e = common_subexpressions(e)
    return e
