"""Streaming value joins — the counterpart of
``matrel_tpu/relational/value_join.py``: ``agg(join_on_value(A, B, ...))``
without the (na, nb) pair matrix.

- STRUCTURED predicate ("eq"/"lt"/"le"/"gt"/"ge" on ``va ? vb``) and
  merge ("left"/"right"/"add"/"mul"): B's entries are sorted once
  (``torch.sort``, NaNs last), and every per-A-entry aggregate over its
  match set is a contiguous range of the sorted vector: counts, sums
  and extrema come from ``torch.searchsorted`` and a prefix table in
  O((na + nb)·log nb) time and O(na + nb) memory.
- CALLABLE merge/predicate (black boxes): chunked enumeration over B
  with a bounded live tile (``config.join_chunk_entries``); the executor
  refuses it above ``config.join_bruteforce_max_pairs``.

Semantics are the dense lowering's (executor ``_join_value`` + ``_agg``):
the pair matrix holds merge(va, vb) where the predicate holds and 0
elsewhere, over ALL logical entries; "count" counts nonzero merged
values; max/min see the implicit zeros of unmatched pairs; avg =
sum/count. As in the JAX package, the streaming "count" decides whether
a merged pair is zero in exact arithmetic (range counts of vb == 0 and
vb == -va), where the dense path tests the f32-rounded merge.

The JAX package's three f32 traps (``docs/INTERNALS.md``, "Streaming
value joins") are kept:

1. prefix sums run over CENTRED values (``sv - nanmean(sv)``) and the
   mean comes back as ``cnt · mean``;
2. NaNs sort last, ranges are clamped to the non-NaN prefix and NaN
   queries get empty ranges — explicitly: ``torch.searchsorted`` is
   searched over the non-NaN prefix only, since over a NaN tail it does
   not place queries as ``jnp.searchsorted``'s "NaN as +inf" does;
3. counts stay integers (int64) until the final cast.

Where the JAX package keeps the prefix table and the range arithmetic in
f32 (the TPU has no f64), this port keeps them in float64 and casts each
result to f32 once: a parallel scan's rounding then sits below f32
resolution, so each result's error is derivable (``chip_smoke.py``
states the bound it checks). Reductions over the "all" axis also run
in float64 / int64 before their one cast.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

_PRED_SWAP = {"eq": "eq", "lt": "gt", "le": "ge", "gt": "lt",
              "ge": "le", "always": "always"}
_MERGE_SWAP = {"left": "right", "right": "left", "add": "add",
               "mul": "mul"}

AGG_KINDS = ("sum", "count", "avg", "max", "min")


def match_range(sv, x, pred: str):
    """[lo, hi) into ascending-sorted ``sv`` (NaNs sorted last) of the
    entries matching predicate(x, vb) — every structured predicate
    selects a contiguous run. ``sv``/``x`` are both torch tensors (the
    streaming executor path) or both numpy arrays
    (``COOMatrix.join_on_value``); returns int64 (lo, hi) of x's shape.

    IEEE semantics: NaN on either side matches NOTHING under the five
    comparison predicates, as in the dense masked lowering where
    pred(NaN, ·) is False. Both halves are explicit: the search runs
    over the non-NaN prefix only (``torch.searchsorted`` does not treat
    a NaN tail as +inf, so it may not search it), and NaN queries get
    empty ranges. "always" keeps every pair, NaNs included. On tensors
    the non-NaN count stays on the device (:func:`_search_head`)."""
    xp = torch if isinstance(sv, Tensor) else np
    nb = sv.shape[0]
    if pred == "always":      # predicate omitted: every pair matches
        z = (torch.zeros(x.shape, dtype=torch.int64, device=x.device)
             if xp is torch else np.zeros(x.shape, dtype=np.int64))
        return z, z + nb
    if xp is torch:
        head, n_valid = _search_head(sv)
        left = torch.minimum(torch.searchsorted(head, x, side="left"),
                             n_valid)
        right = torch.minimum(torch.searchsorted(head, x, side="right"),
                              n_valid)
    else:
        n_valid = nb - np.count_nonzero(np.isnan(sv))
        head = sv[:n_valid]
        left = np.searchsorted(head, x, side="left")
        right = np.searchsorted(head, x, side="right")
    if pred == "eq":
        lo, hi = left, right
    elif pred == "lt":        # vb > x
        lo, hi = right, xp.zeros_like(right) + n_valid
    elif pred == "le":        # vb >= x
        lo, hi = left, xp.zeros_like(left) + n_valid
    elif pred == "gt":        # vb < x
        lo, hi = xp.zeros_like(left), left
    elif pred == "ge":        # vb <= x
        lo, hi = xp.zeros_like(right), right
    else:
        raise ValueError(f"unknown structured predicate {pred!r}")
    hi = xp.where(xp.isnan(x), lo, hi)    # NaN query: empty range
    return lo, hi


def _search_head(sv: Tensor):
    """(head, n_valid) for searching ascending ``sv`` (NaNs last) over
    its non-NaN prefix with no host read: head is sv with the NaN tail
    read as +inf, n_valid the 0-d count of non-NaN entries on sv's
    device. Clamped to n_valid, a search of head equals a search of
    ``sv[:n_valid]``: no entry of the tail is below any x, and the tail
    is at most x only where x is +inf, past n_valid."""
    nan = torch.isnan(sv)
    head = sv.masked_fill(nan, torch.inf) if sv.is_floating_point() else sv
    return head, sv.shape[0] - nan.sum()


def _range_eq_count(sv: Tensor, v: Tensor, lo: Tensor,
                    hi: Tensor) -> Tensor:
    """#entries equal to v INSIDE [lo, hi) of sorted sv (int64, exact);
    ``v`` is one value per query or a single value for all. A NaN v
    equals nothing (searched over the non-NaN prefix only, as in
    :func:`match_range`)."""
    head, n_valid = _search_head(sv)
    zl = torch.minimum(torch.searchsorted(head, v, side="left"), n_valid)
    zr = torch.minimum(torch.searchsorted(head, v, side="right"), n_valid)
    n = (torch.minimum(zr, hi) - torch.maximum(zl, lo)).clamp_(min=0)
    return torch.where(torch.isnan(v), 0, n)


def entry_stats(va: Tensor, vb: Tensor, pred: str, merge: str) -> dict:
    """Per-A-entry aggregates of merge(va, ·) over the matched B set:

      cnt      — matched-pair count (int64)
      nnz      — matched pairs whose MERGED value is nonzero (int64)
      sum      — Σ merge over matches (float64)
      mx / mn  — max / min of the PAIR-MATRIX ROW (merge over matches,
                 0 for every unmatched pair, 0 when the row is empty),
                 f32 — what the dense lowering's masked row reduction
                 sees.
    """
    va = va.float()
    vb = vb.float()
    nb = vb.shape[0]
    i64 = torch.zeros(va.shape, dtype=torch.int64, device=va.device)
    if nb == 0:               # empty B: every row of the pair matrix empty
        z = torch.zeros_like(va)
        return {"cnt": i64, "nnz": i64, "sum": z.double(), "mx": z,
                "mn": z}
    sv = torch.sort(vb).values                       # NaNs last
    mean = torch.nan_to_num(torch.nanmean(sv.double()))
    ps = torch.zeros(nb + 1, dtype=torch.float64, device=sv.device)
    torch.cumsum(sv.double() - mean, dim=0, out=ps[1:])
    lo, hi = match_range(sv, va, pred)
    cnt_i = hi - lo
    some = cnt_i > 0
    cnt = cnt_i.double()
    sum_vb = (ps[hi] - ps[lo]) + cnt * mean
    del ps
    zero = torch.zeros((), dtype=torch.float32, device=va.device)
    mn_vb = torch.where(some, sv[lo.clamp(0, nb - 1)], zero)
    mx_vb = torch.where(some, sv[(hi - 1).clamp(0, nb - 1)], zero)
    z_one = zero.reshape(1)

    if merge == "left":
        m_sum = cnt * va.double()
        m_nnz = torch.where(va != 0, cnt_i, i64)
        m_mx = m_mn = va
    elif merge == "right":
        m_sum = sum_vb
        m_nnz = cnt_i - _range_eq_count(sv, z_one, lo, hi)
        m_mx, m_mn = mx_vb, mn_vb
    elif merge == "add":
        m_sum = cnt * va.double() + sum_vb
        m_nnz = cnt_i - _range_eq_count(sv, -va, lo, hi)
        m_mx, m_mn = va + mx_vb, va + mn_vb
    elif merge == "mul":
        m_sum = va.double() * sum_vb
        m_nnz = torch.where(
            va != 0, cnt_i - _range_eq_count(sv, z_one, lo, hi), i64)
        pos = va >= 0
        m_mx = va * torch.where(pos, mx_vb, mn_vb)
        m_mn = va * torch.where(pos, mn_vb, mx_vb)
    else:
        raise ValueError(f"unknown structured merge {merge!r}")

    # fold the implicit zeros of unmatched pairs into the row extrema
    full = cnt_i >= nb
    mx = torch.where(some, torch.where(full, m_mx,
                                       torch.clamp(m_mx, min=0.0)), zero)
    mn = torch.where(some, torch.where(full, m_mn,
                                       torch.clamp(m_mn, max=0.0)), zero)
    return {"cnt": cnt_i, "nnz": torch.where(some, m_nnz, i64),
            "sum": torch.where(some, m_sum, zero.double()),
            "mx": mx, "mn": mn}


def finish(kind: str, axis: str, s64: Tensor, nnz: Tensor, mx: Tensor,
           mn: Tensor) -> Tensor:
    """One axis result from per-query sums (float64), nonzero counts
    (integers) and row extrema (f32): f32 out, cast once ("row" and
    "col" alike: one result a query)."""
    if axis == "all":
        if kind == "sum":
            return s64.sum().float()
        if kind == "count":
            return nnz.sum().float()
        if kind == "avg":
            c = nnz.sum()
            return torch.where(c > 0, s64.sum() / c.clamp(min=1),
                               0.0).float()
        return mx.max() if kind == "max" else mn.min()
    if kind == "sum":
        return s64.float()
    if kind == "count":
        return nnz.float()
    if kind == "avg":
        return torch.where(nnz > 0, s64 / nnz.clamp(min=1), 0.0).float()
    return mx if kind == "max" else mn


def row_stats_sorted(va: Tensor, vb: Tensor, pred: str, merge: str,
                     axis: str = "row") -> tuple:
    """(Σ float64, nonzero count, max, min) of every QUERY entry's
    pair-matrix row (:func:`entry_stats`): A's entries for "row" /
    "all", B's for "col" (roles swapped, predicate and merge mirrored).
    Queries are independent, so a slice of them gives the slice of the
    stats — what a rank mesh splits."""
    if axis == "col":
        va, vb, pred, merge = vb, va, _PRED_SWAP[pred], _MERGE_SWAP[merge]
    st = entry_stats(va, vb, pred, merge)
    return st["sum"], st["nnz"], st["mx"], st["mn"]


def axis_agg_sorted(va: Tensor, vb: Tensor, pred: str, merge: str,
                    kind: str, axis: str) -> Tensor:
    """Aggregate the (na, nb) pair matrix without building it.

    axis "row" → (na,) per-A-entry results; "col" → (nb,) per-B-entry
    (roles swapped, predicate and merge mirrored); "all" → scalar ().
    """
    if kind not in AGG_KINDS:
        raise ValueError(f"unknown aggregate {kind!r}")
    if axis not in ("row", "col", "all"):
        raise ValueError(f"unknown axis {axis!r} for a value-join "
                         "aggregate (diag is handled elementwise upstream)")
    return finish(kind, axis, *row_stats_sorted(va, vb, pred, merge, axis))


def axis_agg_chunked(va: Tensor, vb: Tensor, merge_fn, pred_fn,
                     kind: str, axis: str, chunk_entries: int) -> Tensor:
    """Black-box fallback: enumerate pair blocks (na, cb) chunk by chunk
    over B, a bounded live tile; callers gate the total pairs with
    ``config.join_bruteforce_max_pairs``. axis "col" swaps the roles
    (argument order preserved by wrappers); "all" reduces the rows.

    The JAX package scans fixed-width chunks over a zero-padded B and
    masks the padded slots (to ∓inf for the extrema, so a row whose true
    pairs are all negative keeps a negative max). Here the loop slices
    the last chunk short instead, so no padded slot exists; real
    unmatched pairs keep their 0, as the dense lowering sees them."""
    if kind not in AGG_KINDS:
        raise ValueError(f"unknown aggregate {kind!r}")
    if (vb if axis != "col" else va).shape[0] == 0:
        # every row of the pair matrix is empty: all aggregates are 0
        na = (va if axis != "col" else vb).shape[0]
        z = torch.zeros(na, dtype=torch.float32, device=va.device)
        return z.sum() if axis == "all" else z
    return finish(kind, axis, *row_stats_chunked(
        va, vb, merge_fn, pred_fn, axis, chunk_entries))


def row_stats_chunked(va: Tensor, vb: Tensor, merge_fn, pred_fn,
                      axis: str, chunk_entries: int) -> tuple:
    """:func:`row_stats_sorted`'s stats for black-box callables, chunk
    by chunk over the other side (:func:`axis_agg_chunked`'s loop)."""
    if axis == "col":
        return row_stats_chunked(
            vb, va, lambda b, a: merge_fn(a, b),
            None if pred_fn is None else (lambda b, a: pred_fn(a, b)),
            "row", chunk_entries)
    va = va.float()
    vb = vb.float()
    na, nb = va.shape[0], vb.shape[0]
    if nb == 0:
        z = torch.zeros(na, dtype=torch.float32, device=va.device)
        return z.double(), z.long(), z, z
    cb = max(1, min(nb, chunk_entries // max(na, 1)))
    s = torch.zeros(na, dtype=torch.float64, device=va.device)
    c = torch.zeros(na, dtype=torch.int64, device=va.device)
    mx = torch.full((na,), float("-inf"), device=va.device)
    mn = torch.full((na,), float("inf"), device=va.device)
    a = va[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=va.device)
    for j in range(0, nb, cb):
        b = vb[None, j:j + cb]
        pairs = torch.as_tensor(merge_fn(a, b), device=va.device)
        pairs = pairs.float().expand(na, b.shape[1])
        if pred_fn is not None:
            keep = torch.as_tensor(pred_fn(a, b), device=va.device)
            pairs = torch.where(keep, pairs, zero)
        s += pairs.sum(dim=1, dtype=torch.float64)
        c += (pairs != 0).sum(dim=1)
        mx = torch.maximum(mx, pairs.amax(dim=1))
        mn = torch.minimum(mn, pairs.amin(dim=1))
    # no finiteness masking: a legitimate ±inf/NaN extremum surfaces as
    # the dense lowering reports it (nb >= 1: the inits never survive)
    return s, c, mx, mn
