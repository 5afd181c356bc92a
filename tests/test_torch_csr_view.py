"""PyTorch port: the per-plan CSR view (matrel_tpu_torch/ops/csr_view.py)
that the routed SpMV kernel (B8) and the k-wide compact SpMM kernel (B3)
walk, held against numpy and the JAX package on the CPU.

- The view of a routed plan (``RoutedSpMVPlan.csr_on``) and of a compact
  plan (``pallas_spmv.csr_view_on``) equals an ``np.lexsort`` reference
  of the slots its kernel adds: every kept slot once, rows ascending, a
  row's slots in plan order, exactly the padded and sentinel slots
  dropped (the kept slots are the input edges less the overflow COO),
  ``row_ptr`` monotone and ending at nnz.
- The plain walk of the view (the CPU mirror of the kernels' schedule)
  equals the plan's plain version on its own tables to one f32 ulp: both
  add the same f32 parts in f64 and round once.
- The plain walk against the JAX package, whose Pallas kernels run in
  interpret mode as tests/test_spmv.py runs them: the routed product at
  passes 1-3 within 2e-6 of max|y| (tests/test_torch_spmv_routed.py's
  bound), the compact product at k = 1, 5, 16 and 33 within 1e-4 of
  max|Y| (tests/test_spmv.py's SpMM bound).
"""

from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.ops import pallas_spmv as jpc
from matrel_tpu.ops import spmv as jspmv
from matrel_tpu.ops import spmv_routed as jrouted

from matrel_tpu_torch import convert
from matrel_tpu_torch.ops import csr_view as csr_lib
from matrel_tpu_torch.ops import pallas_spmv as tpc
from matrel_tpu_torch.ops import spmv as tspmv
from matrel_tpu_torch.ops import spmv_routed as trouted

from test_torch_native_guard import ensure_reference_native

# the JAX package's native library, whole and loaded in this process
ensure_reference_native()

SPAN = trouted.SPAN
#: routed product, port vs JAX interpret mode, relative to max|y|
ROUTED_VS_JAX = 2e-6
#: compact SpMM, port vs JAX interpret mode, relative to max|Y|
COMPACT_VS_JAX = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# -- cases ---------------------------------------------------------------------

ROUTED = ("ragged", "rectangular", "empty_group", "hot_cell", "hub_row")


def routed_case(name):
    """(rows, cols, vals, n_rows, n_cols, build kwargs): groups cut just
    past a boundary; a destination and a source group with no edge; one
    hot cell past capacity (overflow COO); a hub row spread over every
    source group."""
    rng = np.random.default_rng(20 + ROUTED.index(name))
    kw = {}
    n_rows = n_cols = 40_000
    m = 20_000
    if name == "rectangular":
        n_rows, n_cols, m = 5_000, 33_000, 8_000
    elif name == "empty_group":
        m, kw = 6_000, dict(max_padding=10.0)
    elif name == "hot_cell":
        m, kw = 3_000, dict(capacity_quantile=0.0, max_padding=1000.0)
    rows = rng.integers(0, n_rows, m)
    cols = rng.integers(0, n_cols, m)
    vals = rng.standard_normal(m).astype(np.float32)
    if name == "empty_group":
        rows = np.where(rows // SPAN == 1, rows - SPAN, rows)
        cols = np.where(cols // SPAN == 2, cols - 2 * SPAN, cols)
    elif name == "hot_cell":
        rows[:1500] = 7
        cols[:1500] = 11
    elif name == "hub_row":
        rows[rng.random(m) < 0.1] = 33_333
    return rows, cols, vals, n_rows, n_cols, kw


def routed_plans(name):
    rows, cols, vals, n_rows, n_cols, kw = routed_case(name)
    tp = trouted.build_routed_plan(rows, cols, vals, n_rows, n_cols, **kw)
    assert tp is not None
    return (rows, cols, vals), tp


COMPACT = ("uniform", "hub", "empty_blocks", "mostly_sentinel", "native",
           "block_128", "empty")


def compact_case(name):
    """(rows, cols, vals, n_rows, n_cols, build kwargs): a uniform graph;
    a hub row past capacity (overflow COO); blocks 1 and 3 with no edge;
    one dense block that sets the capacity, so the others are mostly
    sentinel slots; the JAX build's native fill (input order within a
    block); block 128; no edge at all."""
    rng = np.random.default_rng(40 + COMPACT.index(name))
    kw = {}
    n_rows, n_cols, m = 3000, 2500, 30_000
    if name == "hub":
        n_rows, n_cols, m = 4096, 512, 20_000
    elif name == "mostly_sentinel":
        n_rows, n_cols, m = 3000, 4096, 5000
    elif name == "block_128":
        kw = {"block": 128}
    elif name == "empty":
        m = 0
    rows = rng.integers(0, n_rows, m)
    cols = rng.integers(0, n_cols, m)
    vals = rng.standard_normal(m).astype(np.float32)
    if name == "hub":
        rows = np.where(rng.random(m) < 0.3, 7, rows)
    elif name == "empty_blocks":
        moved = np.isin(rows // 512, (1, 3))
        rows = np.where(moved, (rows + 512) % n_rows, rows)
    elif name == "mostly_sentinel":
        rows = np.where(rng.random(m) < 0.8, rows % 512, rows)
    return rows, cols, vals, n_rows, n_cols, kw


def to_port(jp):
    def a(v):
        return None if v is None else np.asarray(v)
    return convert.spmv_plan_from_arrays(
        jp.n_rows, jp.n_cols, jp.block, jp.capacity, np.asarray(jp.src8),
        np.asarray(jp.lane), np.asarray(jp.off), np.asarray(jp.val),
        a(jp.ov_cols), a(jp.ov_rows), a(jp.ov_vals), jp.padding_ratio)


def compact_plans(name):
    """(edges, JAX plan, port plan). The port plan is the JAX plan carried
    over for "native" (the JAX build's native fill, where it builds) and
    the port's own numpy build otherwise."""
    rows, cols, vals, n_rows, n_cols, kw = compact_case(name)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_rows,
                               n_cols=n_cols, **kw)
    if name == "native":
        tp = to_port(jp)
    else:
        tp = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_rows,
                                   n_cols=n_cols, **kw)
    assert jp is not None and tp is not None
    return (rows, cols, vals), jp, tp


# -- the view ------------------------------------------------------------------


def reference_view(rows, cols, vals, keep, n_rows):
    """numpy: the kept slots (flat plan order) ordered by row, stably."""
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    order = np.lexsort((np.arange(rows.size), rows))
    row_ptr = np.zeros(n_rows + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_rows), out=row_ptr[1:])
    cv = np.stack([cols[order].astype(np.int32),
                   vals[order].astype(np.float32).view(np.int32)], axis=1)
    return row_ptr, cv, order


def check_view(view, ref, edges, overflow, n_rows, n_cols):
    assert isinstance(view, csr_lib.CSRView) and view.n_cols == n_cols
    row_ptr, cv = view.row_ptr.numpy(), view.cv.numpy()
    ref_ptr, ref_cv, order = ref
    assert row_ptr.dtype == np.int32 and row_ptr.shape == (n_rows + 1,)
    assert cv.dtype == np.int32 and cv.shape == (ref_cv.shape[0], 2)
    assert row_ptr[0] == 0 and row_ptr[-1] == cv.shape[0]
    assert (np.diff(row_ptr) >= 0).all()                      # monotone
    np.testing.assert_array_equal(row_ptr, ref_ptr)
    np.testing.assert_array_equal(cv, ref_cv)
    # a row's slots keep plan order: ascending plan positions inside rows
    rows_v = np.repeat(np.arange(n_rows), np.diff(row_ptr))
    same = rows_v[1:] == rows_v[:-1]
    assert (order[1:][same] > order[:-1][same]).all()
    # every edge outside the overflow COO appears once, nothing else
    def multiset(r, c, v):
        return Counter(zip(np.asarray(r, np.int64).tolist(),
                           np.asarray(c, np.int64).tolist(),
                           np.asarray(v, np.float32).view(np.int32).tolist()))
    want = multiset(*edges)
    if overflow is not None:
        ov = multiset(*overflow)
        assert not ov - want                  # overflow edges are inputs
        want = want - ov
    got = multiset(rows_v, cv[:, 0], cv[:, 1].view(np.float32))
    assert got == want


@pytest.mark.parametrize("name", ROUTED)
def test_routed_view(name):
    edges, tp = routed_plans(name)
    g_s, g_d, cap = tp.loc_src.shape
    gs = np.arange(g_s)[:, None, None]
    gd = np.arange(g_d)[None, :, None]
    rows = (gd * SPAN + tp.loc_dst).reshape(-1)
    cols = (gs * SPAN + tp.loc_src).reshape(-1)
    vals = tp.val.reshape(-1)
    # the slots the kernel adds: real values, offsets inside the groups
    keep = ((vals != 0) & (tp.loc_src.reshape(-1) < SPAN)
            & (tp.loc_dst.reshape(-1) < SPAN) & (rows < tp.n_rows)
            & (cols < tp.n_cols))
    ref = reference_view(rows, cols, vals, keep, tp.n_rows)
    overflow = (None if tp.ov_rows is None
                else (tp.ov_rows, tp.ov_cols, tp.ov_vals))
    assert (overflow is not None) == (name == "hot_cell")
    check_view(tp.csr_on("cpu"), ref, edges, overflow, tp.n_rows, tp.n_cols)
    if name == "empty_group":
        row_ptr = tp.csr_on("cpu").row_ptr.numpy()
        assert row_ptr[SPAN] == row_ptr[2 * SPAN]
    if name == "hub_row":
        counts = np.diff(tp.csr_on("cpu").row_ptr.numpy())
        assert counts.argmax() == 33_333 and counts.max() > 1000


@pytest.mark.parametrize("name", COMPACT)
def test_compact_view(name):
    edges, _, tp = compact_plans(name)
    nb, cap = tp.src8.shape
    cols = (tp.src8.astype(np.int64) * 8 + tp.lane).reshape(-1)
    rows = (np.arange(nb)[:, None] * tp.block + tp.off).reshape(-1)
    vals = tp.val.reshape(-1)
    # sentinel slots read column n_cols; every other slot is added
    keep = (cols < tp.n_cols) & (tp.off.reshape(-1) < tp.block)
    assert (rows[keep] < tp.n_rows).all()
    ref = reference_view(rows, cols, vals, keep, tp.n_rows)
    overflow = (None if tp.ov_rows is None
                else (tp.ov_rows, tp.ov_cols, tp.ov_vals))
    if name == "hub":
        assert overflow is not None
    check_view(tpc.csr_view_on(tp, "cpu"), ref, edges, overflow, tp.n_rows,
               tp.n_cols)
    if name == "mostly_sentinel":
        assert keep.sum() < 0.5 * keep.size
    if name == "empty_blocks":
        row_ptr = tpc.csr_view_on(tp, "cpu").row_ptr.numpy()
        for b in (1, 3):
            assert row_ptr[b * 512] == row_ptr[(b + 1) * 512]


def test_views_memoised_per_device():
    _, tp = routed_plans("rectangular")
    assert tp.csr_on("cpu") is tp.csr_on("cpu")
    _, _, cp = compact_plans("uniform")
    assert tpc.csr_view_on(cp, "cpu") is tpc.csr_view_on(cp, "cpu")


def test_csr_view_refuses_mismatched_slots():
    with pytest.raises(ValueError):
        csr_lib.csr_view([0, 1], [0], [1.0, 2.0], 2, 1)


def _view_parts():
    view = csr_lib.csr_view([0, 0, 2], [1, 0, 2], [1.0, 2.0, 3.0], 3, 4)
    return view.row_ptr, view.cv, view.n_cols


@pytest.mark.parametrize("bad", (
    "row_ptr_dtype", "row_ptr_rank", "cv_dtype", "cv_width",
    "row_ptr_short_of_nnz", "row_ptr_past_nnz", "row_ptr_start",
    "row_ptr_decreasing", "column_past_n_cols", "negative_column",
    "n_cols_negative", "devices_differ"))
def test_view_checked_where_it_is_made(bad):
    """A view whose parts do not fit together is refused once, where it
    is made, so the kernels never read past cv or the dense operand."""
    row_ptr, cv, n_cols = _view_parts()
    assert csr_lib.CSRView(row_ptr, cv, n_cols).nnz == 3
    if bad == "row_ptr_dtype":
        row_ptr = row_ptr.long()
    elif bad == "row_ptr_rank":
        row_ptr = row_ptr[:, None]
    elif bad == "cv_dtype":
        cv = cv.long()
    elif bad == "cv_width":
        cv = torch.cat([cv, cv[:, :1]], dim=1)
    elif bad == "row_ptr_short_of_nnz":        # a row_ptr of another view
        cv = torch.cat([cv, cv[:1]])
    elif bad == "row_ptr_past_nnz":
        cv = cv[:2].contiguous()
    elif bad == "row_ptr_start":
        row_ptr = row_ptr + 1
    elif bad == "row_ptr_decreasing":
        row_ptr = torch.tensor([0, 3, 2, 3], dtype=torch.int32)
    elif bad == "column_past_n_cols":
        n_cols = 2
    elif bad == "negative_column":
        cv = cv.clone()
        cv[1, 0] = -1
    elif bad == "n_cols_negative":
        n_cols = -1
    elif bad == "devices_differ":
        cv = cv.to("meta")
    with pytest.raises((TypeError, ValueError)):
        csr_lib.CSRView(row_ptr, cv, n_cols)


# -- the plain walk ------------------------------------------------------------


def assert_within_one_ulp(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    ulp = np.spacing(np.maximum(np.abs(got), np.abs(want)))
    assert (np.abs(got.astype(np.float64) - want) <= ulp).all()


@pytest.mark.parametrize("passes", (1, 2, 3))
@pytest.mark.parametrize("name", ROUTED)
def test_routed_walk_equals_table_plain(name, passes):
    _, tp = routed_plans(name)
    x = torch.as_tensor(np.random.default_rng(passes).standard_normal(
        tp.n_cols).astype(np.float32))
    got = trouted.csr_scatter_plain(tp.csr_on("cpu"), x, passes)
    want = trouted.routed_scatter_plain(*tp.tables_on("cpu"), x, tp.n_rows,
                                        passes)
    assert_within_one_ulp(got.numpy(), want.numpy())
    # on CPU tensors the kernel wrapper runs the walk, counting no launch
    before = trouted.LAUNCHES_ROUTED
    via = trouted.routed_scatter(tp.csr_on("cpu"), x, passes)
    assert trouted.LAUNCHES_ROUTED == before
    torch.testing.assert_close(via, got, rtol=0, atol=0)


@pytest.mark.parametrize("passes", (2, 3))
@pytest.mark.parametrize("k", (1, 5, 16, 33))
@pytest.mark.parametrize("name", COMPACT)
def test_compact_walk_equals_table_plain(name, k, passes):
    _, _, tp = compact_plans(name)
    X = torch.as_tensor(np.random.default_rng(k).standard_normal(
        (tp.n_cols, k)).astype(np.float32))
    got = csr_lib.csr_walk_plain(tpc.csr_view_on(tp, "cpu"), X, passes,
                                 split_x=False)
    want = tpc.spmm_scatter_plain(*tpc.compact_tables(tp, "cpu"), X,
                                  tp.n_rows, tp.block, passes)
    assert_within_one_ulp(got.numpy(), want.numpy())
    before = tpc.LAUNCHES_SPMM
    via = tpc.spmm_scatter(tpc.csr_view_on(tp, "cpu"), X, passes)
    assert tpc.LAUNCHES_SPMM == before
    torch.testing.assert_close(via, got, rtol=0, atol=0)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("passes", (1, 2, 3))
@pytest.mark.parametrize("name", ROUTED)
def test_routed_walk_matches_jax(name, passes):
    rows, cols, vals, n_rows, n_cols, kw = routed_case(name)
    jp = jrouted.build_routed_plan(rows, cols, vals, n_rows, n_cols, **kw)
    _, tp = routed_plans(name)
    x = np.random.default_rng(9).standard_normal(n_cols).astype(np.float32)
    want = np.asarray(jrouted.routed_spmv(jp, jnp.asarray(x), passes=passes,
                                          interpret=True))
    y = trouted.csr_scatter_plain(tp.csr_on("cpu"), torch.as_tensor(x),
                                  passes).double()
    if tp.ov_rows is not None:
        y.index_add_(0, torch.as_tensor(tp.ov_rows).long(),
                     torch.as_tensor(x[tp.ov_cols] * tp.ov_vals).double())
    assert rel(y.float().numpy(), want) <= ROUTED_VS_JAX


@pytest.mark.parametrize("passes", (2, 3))
@pytest.mark.parametrize("k", (1, 5, 16, 33))
@pytest.mark.parametrize("name", ("uniform", "hub", "empty_blocks",
                                  "native"))
def test_compact_walk_matches_jax(name, k, passes):
    _, jp, tp = compact_plans(name)
    X = np.random.default_rng(k).standard_normal(
        (tp.n_cols, k)).astype(np.float32)
    want = np.asarray(jpc.spmm_compact(jp, jnp.asarray(X), passes=passes,
                                       interpret=True))
    Xt = torch.as_tensor(X)
    Y = csr_lib.csr_walk_plain(tpc.csr_view_on(tp, "cpu"), Xt, passes,
                               split_x=False)
    ov = tp.overflow_on("cpu")
    if ov:
        Y = tspmv._overflow_add_wide(Y, ov, Xt, tp.n_rows)
    assert Y.shape == (tp.n_rows, k)
    assert rel(Y.numpy(), want) <= COMPACT_VS_JAX
    if k > 1:                        # the route compute() takes for A·X
        got = tpc.spmm_compact(tp, X, passes=passes, device="cpu")
        torch.testing.assert_close(got, Y, rtol=0, atol=0)
