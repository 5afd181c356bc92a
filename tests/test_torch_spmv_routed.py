"""PyTorch port: the routed SpMV (matrel_tpu_torch/ops/spmv_routed.py,
TPU kernel B8) held against the JAX package on the CPU.

- The port's ``build_routed_plan`` equals the JAX build array for array
  (tables reshaped from the TPU tile layout, cap, groups, overflow COO,
  padding ratio), and both refuse the same graphs.
- ``routed_spmv(device="cpu")`` runs the kernel wrapper's plain version;
  the JAX side runs its Pallas kernels in interpret mode, as
  tests/test_spmv.py does. Both truncate x and x·val to the same bf16
  parts, so they differ only in the order of the sums (f32 one-hot
  contractions there, f64 sums rounded once here): 2e-6·max|y|. Against
  a float64 oracle the JAX tests' own bounds hold: 5e-4·max|y| at
  passes=2, 1e-6 at passes=3 (the overflow COO, summed in f32 with
  ``index_add_``, stays inside both).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.ops import spmv_routed as jrouted

from matrel_tpu_torch import convert
from matrel_tpu_torch.ops import spmv_routed as trouted

SPAN = trouted.SPAN
#: port vs JAX interpret mode on the same tables, relative to max|y|
PORT_VS_JAX = 2e-6
#: vs the float64 oracle, relative to max|y| (tests/test_spmv.py)
ORACLE_TOL = {1: 5e-2, 2: 5e-4, 3: 1e-6}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


CASES = ("two_groups", "rectangular", "empty_group", "overflow")


def _case(name):
    """(rows, cols, vals, n_rows, n_cols, build kwargs) — the JAX tests'
    shapes, each just past a group boundary."""
    rng = np.random.default_rng(CASES.index(name))
    kw = {}
    if name == "two_groups":            # 2 x 2 cells, the far ones small
        n_rows = n_cols = SPAN + 3_000
        m = 3_000
        kw = dict(max_padding=10.0)
    elif name == "rectangular":         # 1 destination x 3 source groups
        n_rows, n_cols, m = 5_000, 33_000, 8_000
    elif name == "empty_group":         # 3 x 3 cells, a destination and
        n_rows = n_cols = 40_000        # a source group with no edge
        m = 6_000
        kw = dict(max_padding=10.0)
    elif name == "overflow":            # one hot cell past capacity
        n_rows = n_cols = 40_000
        m = 3_000
        kw = dict(capacity_quantile=0.0, max_padding=1000.0)
    else:
        raise KeyError(name)
    rows = rng.integers(0, n_rows, m)
    cols = rng.integers(0, n_cols, m)
    vals = rng.standard_normal(m).astype(np.float32)
    if name == "empty_group":
        rows = np.where(rows // SPAN == 1, rows - SPAN, rows)
        cols = np.where(cols // SPAN == 2, cols - 2 * SPAN, cols)
    if name == "overflow":
        rows[:1500] = 7
        cols[:1500] = 11
    return rows, cols, vals, n_rows, n_cols, kw


def _plans(name):
    rows, cols, vals, n_rows, n_cols, kw = _case(name)
    jp = jrouted.build_routed_plan(rows, cols, vals, n_rows, n_cols, **kw)
    tp = trouted.build_routed_plan(rows, cols, vals, n_rows, n_cols, **kw)
    return (rows, cols, vals, n_rows, n_cols), jp, tp


def _jax_tables(jp):
    """The JAX plan's host tables, read before ``arrays()`` moves them."""
    return tuple(np.asarray(a) for a in (jp.loc_src, jp.loc_dst, jp.val))


def _oracle(rows, cols, vals, x, n_rows):
    out = np.zeros(n_rows)
    np.add.at(out, rows, vals.astype(np.float64) * x[cols].astype(np.float64))
    return out


@pytest.mark.parametrize("name", CASES)
def test_plan_equals_jax(name):
    _, jp, tp = _plans(name)
    assert jp is not None and tp is not None
    for f in ("n_rows", "n_cols", "g_src", "g_dst", "cap"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.padding_ratio == jp.padding_ratio
    shp = (jp.g_src, jp.g_dst, jp.cap)
    for got, want in zip((tp.loc_src, tp.loc_dst, tp.val), _jax_tables(jp)):
        assert got.shape == shp and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want.reshape(shp))
    if jp.ov_rows is None:
        assert tp.ov_rows is None and tp.ov_cols is None
    else:
        for got, want in ((tp.ov_rows, jp.ov_rows), (tp.ov_cols, jp.ov_cols),
                          (tp.ov_vals, jp.ov_vals)):
            np.testing.assert_array_equal(got, np.asarray(want))
    if name == "overflow":
        assert tp.ov_rows.shape[0] > 0
    if name == "empty_group":
        assert not tp.val[:, 1, :].any() and not tp.val[2, :, :].any()
    if name == "rectangular":
        assert (tp.g_src, tp.g_dst) == (3, 1)


def _gate_cases():
    rng = np.random.default_rng(5)
    small = (rng.integers(0, 100, 20), rng.integers(0, 100, 20),
             rng.standard_normal(20).astype(np.float32), 100, 100)
    dense = (rng.integers(0, 16_000, 300_000),
             rng.integers(0, 16_000, 300_000),
             rng.standard_normal(300_000).astype(np.float32), 16_000, 16_000)
    mid = (rng.integers(0, 20_000, 4_000), rng.integers(0, 20_000, 4_000),
           rng.standard_normal(4_000).astype(np.float32), 20_000, 20_000)
    return {
        # tests/test_spmv.py test_build_gates
        "max_padding": (small, {}),
        "max_slots": (small, dict(max_padding=100.0, max_slots=10)),
        # test_cap_ceiling_gates: one edge-dense cell past max_cap
        "max_cap": (dense, dict(max_padding=100.0)),
        "accepted": (mid, {}),
        "max_slots_accepts": (mid, dict(max_slots=1 << 20)),
    }


@pytest.mark.parametrize("gate", sorted(_gate_cases()))
def test_build_gates_match_jax(gate):
    (rows, cols, vals, n_r, n_c), kw = _gate_cases()[gate]
    jp = jrouted.build_routed_plan(rows, cols, vals, n_r, n_c, **kw)
    tp = trouted.build_routed_plan(rows, cols, vals, n_r, n_c, **kw)
    assert (jp is None) == (tp is None)
    assert (tp is None) == (gate not in ("accepted", "max_slots_accepts"))


@pytest.mark.parametrize("passes", (1, 2, 3))
@pytest.mark.parametrize("name", CASES)
def test_routed_spmv_matches_jax_and_oracle(name, passes):
    (rows, cols, vals, n_rows, n_cols), jp, tp = _plans(name)
    x = np.random.default_rng(7).standard_normal(n_cols).astype(np.float32)
    tables = _jax_tables(jp)
    want = np.asarray(jrouted.routed_spmv(jp, jnp.asarray(x), passes=passes,
                                          interpret=True), np.float64)
    got = trouted.routed_spmv(tp, x, passes=passes, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n_rows,)
    got = got.numpy().astype(np.float64)
    scale = max(np.abs(want).max(), 1e-9)
    assert np.abs(got - want).max() <= PORT_VS_JAX * scale
    oracle = _oracle(rows, cols, vals, x, n_rows)
    assert np.abs(got - oracle).max() <= ORACLE_TOL[passes] * \
        max(np.abs(oracle).max(), 1e-9)
    # the JAX plan's own tables, carried over, give the same answer
    cp = convert.routed_plan_from_arrays(
        jp.n_rows, jp.n_cols, jp.g_src, jp.g_dst, jp.cap, *tables,
        ov_rows=None if jp.ov_rows is None else np.asarray(jp.ov_rows),
        ov_cols=None if jp.ov_cols is None else np.asarray(jp.ov_cols),
        ov_vals=None if jp.ov_vals is None else np.asarray(jp.ov_vals),
        padding_ratio=jp.padding_ratio)
    again = trouted.routed_spmv(cp, x, passes=passes, device="cpu")
    np.testing.assert_array_equal(again.numpy().astype(np.float64), got)
    if name == "empty_group":
        assert not got[SPAN:2 * SPAN].any()


def test_three_passes_equal_compact_route():
    """At passes=3 both value sides are exact, so the routed and the
    compact (B2) products agree to f32 rounding of their sums."""
    from matrel_tpu_torch.ops import pallas_spmv as tpc
    from matrel_tpu_torch.ops import spmv as tspmv
    rows, cols, vals, n_rows, n_cols, kw = _case("two_groups")
    x = np.random.default_rng(8).standard_normal(n_cols).astype(np.float32)
    tp = trouted.build_routed_plan(rows, cols, vals, n_rows, n_cols, **kw)
    cp = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_rows,
                               n_cols=n_cols)
    a = trouted.routed_spmv(tp, x, passes=3, device="cpu").double()
    b = tpc.spmv_compact(cp, x, passes=3, device="cpu").double()
    assert float((a - b).abs().max()) <= 1e-6 * float(b.abs().max())


def test_plain_route_and_launch_count(monkeypatch):
    """use_pallas=False runs the plain version without the wrapper; on
    CPU tensors the wrapper itself runs the plain version and counts no
    launch."""
    _, _, tp = _plans("two_groups")
    x = torch.randn(tp.n_cols, generator=torch.Generator().manual_seed(1))
    before = trouted.LAUNCHES_ROUTED
    via_wrapper = trouted.routed_spmv(tp, x, device="cpu")
    assert trouted.LAUNCHES_ROUTED == before

    def refuse(*a, **k):
        raise AssertionError("kernel wrapper called")

    monkeypatch.setattr(trouted, "routed_scatter", refuse)
    plain = trouted.routed_spmv(tp, x, device="cpu", use_pallas=False)
    torch.testing.assert_close(plain, via_wrapper, rtol=0, atol=0)
    with pytest.raises(AssertionError, match="kernel wrapper"):
        trouted.routed_spmv(tp, x, device="cpu")


def _operands():
    _, _, tp = _plans("two_groups")
    view = tp.csr_on("cpu")
    return view.row_ptr, view.cv, view.n_cols, torch.zeros(tp.n_cols)


@pytest.mark.parametrize("bad", (
    "row_ptr_dtype", "cv_dtype", "x_dtype", "cv_width", "cv_rank",
    "x_rank", "noncontiguous", "passes", "misaligned", "row_ptr_empty",
    "device", "x_too_long", "x_too_short", "not_a_view"))
def test_wrapper_refuses_bad_operands(bad):
    row_ptr, cv, n_cols, x = _operands()
    passes = 2
    if bad == "row_ptr_dtype":
        row_ptr = row_ptr.long()
    elif bad == "cv_dtype":
        cv = cv.long()
    elif bad == "x_dtype":
        x = x.double()
    elif bad == "cv_width":
        cv = cv[:, :1].contiguous()
    elif bad == "cv_rank":
        cv = cv.reshape(-1)
    elif bad == "x_rank":
        x = x[:, None]
    elif bad == "noncontiguous":
        cv = cv.T.contiguous().T
    elif bad == "passes":
        passes = 4
    elif bad == "misaligned":           # records not on 8-byte boundaries
        cv = cv.reshape(-1)[1:-1].reshape(-1, 2)
    elif bad == "row_ptr_empty":
        row_ptr = row_ptr[:0]
    elif bad == "device":
        x = x.to("meta")
    elif bad == "x_too_long":
        x = torch.zeros(n_cols + 1)
    elif bad == "x_too_short":
        x = x[:-1]
    with pytest.raises((TypeError, ValueError)):
        view = ((row_ptr, cv) if bad == "not_a_view"
                else trouted.csr_lib.CSRView(row_ptr, cv, n_cols))
        trouted.routed_scatter(view, x, passes)


@pytest.mark.parametrize("nnz,n_rows,lanes", [
    (10_000_000, 1_000_000, 8),     # BASELINE row 5: ~10 slots a row
    (0, 100, 1), (150, 100, 1), (400, 100, 4), (10**6, 100, 32),
    (5, 1, 4)])
def test_lanes_per_row(nnz, n_rows, lanes):
    assert trouted.lanes_per_row(nnz, n_rows) == lanes
