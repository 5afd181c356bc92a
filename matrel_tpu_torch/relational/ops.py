"""Relational operators over matrices — the counterpart of
``matrel_tpu/relational/ops.py``, MatRel's σ/γ/⋈ on top of the linear
algebra.

A matrix is the relation (i, j, v):
  σ (selection)   on entry values, row/col indices, or blocks
  γ (aggregation) sum/count/avg/max/min over row/col/all/diag
  ⋈ (join)        of two matrices on index equality or value predicates,
                  entries combined by a merge function

Static-shape semantics: a selection returns a same-shaped matrix with
the non-matching entries at 0 (the relation's "missing"), so σ/γ compose
exactly with the linear-algebra ops. Predicates and merges are callables
over torch tensors (index predicates get integer index tensors); joins
also take the structured strings of ``ir.expr.JOIN_MERGES`` /
``JOIN_PREDS``. The nodes live in ``ir/expr.py`` and lower in
``executor.py``.
"""

from __future__ import annotations

from typing import Callable, Optional, Union

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.ir import expr as E

MatLike = Union[BlockMatrix, E.MatExpr]


# -- σ selection ------------------------------------------------------------


def select_entries(m: MatLike, predicate: Callable,
                   fill: float = 0.0) -> E.MatExpr:
    """σ_pred on entry values: entries failing ``predicate(v)`` become
    ``fill`` (default 0 = missing)."""
    return E.as_expr(m).select_value(predicate, fill=fill)


def select_rows(m: MatLike, predicate: Callable) -> E.MatExpr:
    """σ on row index: keep rows i where ``predicate(i)`` (vectorised)."""
    return E.as_expr(m).select_index(rows=predicate)


def select_cols(m: MatLike, predicate: Callable) -> E.MatExpr:
    return E.as_expr(m).select_index(cols=predicate)


def select_blocks(m: MatLike, predicate: Callable,
                  block_size: Optional[int] = None) -> E.MatExpr:
    """σ on block index: keep entries whose (row_block, col_block) =
    (i // bs, j // bs) satisfies ``predicate(bi, bj)``. ``block_size``
    defaults to the matrix's own, else ``config.block_size``."""
    e = E.as_expr(m)
    if block_size is None:
        block_size = getattr(m, "block_size", None)
        if block_size is None:
            from matrel_tpu_torch.config import default_config
            block_size = default_config().block_size
    return E.MatExpr("select_block", (e,), e.shape, e.nnz,
                     {"predicate": predicate, "block_size": block_size})


# -- γ aggregation ----------------------------------------------------------


def aggregate(m: MatLike, kind: str, axis: str) -> E.MatExpr:
    """γ_kind over axis ∈ {row, col, all, diag}; kind ∈ {sum, count, avg,
    max, min}. count counts nonzero entries (the relation's tuples)."""
    return E.agg(E.as_expr(m), kind, axis)


# -- ⋈ joins ---------------------------------------------------------------


def join_on_index(a: MatLike, b: MatLike, merge) -> E.MatExpr:
    """⋈ on (i, j) equality: C[i,j] = merge(A[i,j], B[i,j])."""
    return E.as_expr(a).join_on_index(E.as_expr(b), merge)


def join_on_rows(a: MatLike, b: MatLike, merge) -> E.MatExpr:
    """⋈ on row index only, statically shaped as the (n, m_a·m_b) matrix
    C[i, j_a·m_b + j_b] = merge(A[i,j_a], B[i,j_b]). The planner picks
    which operand to replicate (``attrs["replicate"]``). ``merge`` is a
    callable or a structured string; structured kinds let the planner
    infer the output dtype."""
    ae, be = E.as_expr(a), E.as_expr(b)
    if ae.shape[0] != be.shape[0]:
        raise ValueError(f"row join needs equal row counts: {ae.shape} "
                         f"vs {be.shape}")
    shape = (ae.shape[0], ae.shape[1] * be.shape[1])
    merge_kind, merge_fn = E.resolve_join_merge(merge)
    return E.MatExpr("join_rows", (ae, be), shape, None,
                     {"merge": merge_fn, "merge_kind": merge_kind})


def join_on_cols(a: MatLike, b: MatLike, merge) -> E.MatExpr:
    """⋈ on column index: C[(i_a, i_b), j] = merge(A[i_a,j], B[i_b,j]),
    statically shaped (n_a·n_b, m). ``merge`` as in join_on_rows."""
    ae, be = E.as_expr(a), E.as_expr(b)
    if ae.shape[1] != be.shape[1]:
        raise ValueError(f"col join needs equal col counts: {ae.shape} "
                         f"vs {be.shape}")
    shape = (ae.shape[0] * be.shape[0], ae.shape[1])
    merge_kind, merge_fn = E.resolve_join_merge(merge)
    return E.MatExpr("join_cols", (ae, be), shape, None,
                     {"merge": merge_fn, "merge_kind": merge_kind})


def join_on_values(a: MatLike, b: MatLike, merge,
                   predicate=None) -> E.MatExpr:
    """⋈ on a value predicate over all entry pairs (see
    ``ir.expr.join_on_value`` for the pair-matrix semantics). Structured
    forms (merge in "left"/"right"/"add"/"mul", predicate in
    "eq"/"lt"/"le"/"gt"/"ge") stream under an aggregate in
    O(n log n) without materialising pairs."""
    return E.as_expr(a).join_on_value(E.as_expr(b), merge, predicate)
