"""PyTorch port: the SpMV plan and the compact-table kernels B2/B3
(matrel_tpu_torch/ops/spmv.py, ops/pallas_spmv.py, ops/spmv_routed.py)
held against the JAX package on the CPU.

The JAX side runs its Pallas kernels in interpret mode
(``spmv_compact(..., interpret=True)``, as tests/test_spmv.py does); the
port runs the kernel wrappers' plain PyTorch versions (CPU tensors).
Both read identical tables: the JAX plan's arrays are handed to the port
through ``convert.spmv_plan_from_arrays``. Tolerances are the JAX tests'
own (tests/test_spmv.py): passes=3 rel 1e-6 of max|y|, passes=2 rel
1e-4, overflow rel 1e-5, SpMM rel 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.ops import pallas_spmv as jpc
from matrel_tpu.ops import spmv as jspmv
from matrel_tpu.ops import spmv_routed as jrouted
from matrel_tpu.utils import native

from matrel_tpu_torch import convert
from matrel_tpu_torch.ops import pallas_spmv as tpc
from matrel_tpu_torch.ops import spmv as tspmv
from matrel_tpu_torch.ops import spmv_routed as trouted
from matrel_tpu_torch.utils import native as tnative

from test_torch_native_guard import ensure_reference_native

# the JAX package's native library, whole and loaded in this process
ensure_reference_native()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from crowding the timing-sensitive tests other workers run beside
    them."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def random_coo(rng, n_r, n_c, m):
    return (rng.integers(0, n_r, m), rng.integers(0, n_c, m),
            rng.standard_normal(m).astype(np.float32))


def hub_coo(rng, m=20_000):
    """A hub row that forces quantile-capacity overflow (test_spmv.py)."""
    rows = np.where(rng.random(m) < 0.3, 7,
                    rng.integers(0, 4096, m)).astype(np.int64)
    cols = rng.integers(0, 512, m).astype(np.int64)
    return rows, cols, rng.standard_normal(m).astype(np.float32), 4096, 512


def coo_oracle(rows, cols, vals, X, n_r):
    X = np.asarray(X, np.float64)
    out = np.zeros((n_r,) + X.shape[1:])
    np.add.at(out, rows, vals.astype(np.float64).reshape(
        (-1,) + (1,) * (X.ndim - 1)) * X[cols])
    return out


def to_port(jplan):
    """The JAX plan's tables, carried over as numpy arrays."""
    def a(v):
        return None if v is None else np.asarray(v)
    return convert.spmv_plan_from_arrays(
        jplan.n_rows, jplan.n_cols, jplan.block, jplan.capacity,
        np.asarray(jplan.src8), np.asarray(jplan.lane), np.asarray(jplan.off),
        np.asarray(jplan.val), a(jplan.ov_cols), a(jplan.ov_rows),
        a(jplan.ov_vals), jplan.padding_ratio)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture
def numpy_fill(monkeypatch):
    """Make both packages' plan builds take their numpy fill: the native
    counting-sort fill keeps input order within a block, the numpy fill
    sorts each block's slots by row (the native fills are held to each
    other in tests/test_torch_coo_plane.py)."""
    monkeypatch.setattr(native, "spmv_counts", lambda *a, **k: None)
    monkeypatch.setattr(tnative, "spmv_counts", lambda *a, **k: None)


@pytest.mark.parametrize("case", ["uniform", "hub", "weights_none",
                                  "block_128", "empty"])
def test_plan_tables_equal_jax(numpy_fill, case):
    rng = np.random.default_rng(11)
    kw = {}
    if case == "hub":
        rows, cols, vals, n_r, n_c = hub_coo(rng)
    elif case == "empty":
        rows = cols = np.zeros(0, np.int64)
        vals, n_r, n_c = np.zeros(0, np.float32), 700, 300
    else:
        n_r, n_c = 3000, 2500
        rows, cols, vals = random_coo(rng, n_r, n_c, 30_000)
        if case == "weights_none":
            vals = None
        if case == "block_128":
            kw = {"block": 128}
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c,
                               **kw)
    tp = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c,
                               **kw)
    assert (tp.n_rows, tp.n_cols, tp.block, tp.capacity) == (
        jp.n_rows, jp.n_cols, jp.block, jp.capacity)
    for name in ("src8", "lane", "off", "val"):
        want = np.asarray(getattr(jp, name))
        got = getattr(tp, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    assert (tp.ov_rows is None) == (jp.ov_rows is None)
    if case == "hub":
        assert tp.ov_rows is not None
        for name in ("ov_cols", "ov_rows", "ov_vals"):
            assert np.array_equal(getattr(tp, name),
                                  np.asarray(getattr(jp, name))), name
    assert tp.padding_ratio == pytest.approx(jp.padding_ratio)


def test_plan_refusals_match_jax(numpy_fill):
    rng = np.random.default_rng(2)
    # one dense hub block, the rest nearly empty: 2M padded slots for
    # 100k edges, past the 4x padding gate
    hub = np.concatenate([rng.integers(0, 512, 98_000),
                          rng.integers(0, 8_000_000, 2_000)])
    uniform = rng.integers(0, 20_000, 50_000)
    for rows, n_r, kw, refused in ((hub, 8_000_000, {}, True),
                                   (uniform, 20_000, {"max_slots": 5_000},
                                    True),
                                   (uniform, 20_000, {}, False)):
        cols = rng.integers(0, 1000, rows.shape[0])
        jp = jspmv.build_spmv_plan(rows, cols, n_rows=n_r, n_cols=1000, **kw)
        tp = tspmv.build_spmv_plan(rows, cols, n_rows=n_r, n_cols=1000, **kw)
        assert (jp is None) == refused and (tp is None) == refused
    assert tspmv.build_spmv_plan(rows[:5], cols[:5], max_slots=10) is None
    with pytest.raises(ValueError, match="out of bounds"):
        tspmv.build_spmv_plan([0, 9], [0, 1], n_rows=5, n_cols=5)


@pytest.mark.parametrize("passes,tol", [(3, 1e-6), (2, 1e-4)])
def test_b2_plain_matches_jax_interpret(passes, tol):
    rng = np.random.default_rng(passes)
    n_r, n_c = 3000, 2500
    rows, cols, vals = random_coo(rng, n_r, n_c, 30_000)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    x = rng.standard_normal(n_c).astype(np.float32)
    want = np.asarray(jpc.spmv_compact(jp, jnp.asarray(x), passes=passes,
                                       interpret=True))
    before = tpc.LAUNCHES_SPMV
    got = tpc.spmv_compact(to_port(jp), x, passes=passes,
                           device="cpu").numpy()
    assert tpc.LAUNCHES_SPMV == before          # CPU: plain version
    assert got.shape == (n_r,) and got.dtype == np.float32
    assert rel(got, want) < tol
    assert rel(got, coo_oracle(rows, cols, vals, x, n_r)) < tol


def test_b2_overflow_matches_jax_interpret():
    rng = np.random.default_rng(5)
    rows, cols, vals, n_r, n_c = hub_coo(rng)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    assert jp.ov_rows is not None
    x = rng.standard_normal(n_c).astype(np.float32)
    want = np.asarray(jpc.spmv_compact(jp, jnp.asarray(x), interpret=True))
    got = tpc.spmv_compact(to_port(jp), x, device="cpu").numpy()
    assert rel(got, want) < 1e-5
    assert rel(got, coo_oracle(rows, cols, vals, x, n_r)) < 1e-5


@pytest.mark.parametrize("n_r,n_c,m,k", [(3000, 2500, 25_000, 16),
                                         (1000, 1500, 8_000, 5)])
def test_b3_plain_matches_jax_interpret(n_r, n_c, m, k):
    rng = np.random.default_rng(k)
    rows, cols, vals = random_coo(rng, n_r, n_c, m)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    X = rng.standard_normal((n_c, k)).astype(np.float32)
    want = np.asarray(jpc.spmm_compact(jp, jnp.asarray(X), interpret=True))
    before = tpc.LAUNCHES_SPMM
    got = tpc.spmm_compact(to_port(jp), X, device="cpu").numpy()
    assert tpc.LAUNCHES_SPMM == before
    assert got.shape == (n_r, k)
    assert rel(got, want) < 1e-4
    assert rel(got, coo_oracle(rows, cols, vals, X, n_r)) < 1e-4


def test_b3_overflow_single_and_zero_columns():
    rng = np.random.default_rng(6)
    rows, cols, vals, n_r, n_c = hub_coo(rng)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    tp = to_port(jp)
    X = rng.standard_normal((n_c, 3)).astype(np.float32)
    want = np.asarray(jpc.spmm_compact(jp, jnp.asarray(X), interpret=True))
    got = tpc.spmm_compact(tp, X, device="cpu").numpy()
    assert rel(got, want) < 1e-4
    # k == 1 routes to B2 (same result as spmv_compact), k == 0 is empty
    y1 = tpc.spmm_compact(tp, X[:, :1], device="cpu").numpy()
    np.testing.assert_array_equal(
        y1[:, 0], tpc.spmv_compact(tp, X[:, 0], device="cpu").numpy())
    j1 = np.asarray(jpc.spmm_compact(jp, jnp.asarray(X[:, :1]),
                                     interpret=True))
    assert rel(y1, j1) < 1e-5
    assert tpc.spmm_compact(tp, X[:, :0], device="cpu").shape == (n_r, 0)


def test_native_filled_plan_same_results():
    """The JAX plan as its native fill lays it out (input order within a
    block, when the native library builds) carried into the port gives
    the JAX result: the sum is order-agnostic."""
    rng = np.random.default_rng(8)
    n_r, n_c = 2000, 2000
    rows, cols, vals = random_coo(rng, n_r, n_c, 20_000)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    x = rng.standard_normal(n_c).astype(np.float32)
    want = np.asarray(jpc.spmv_compact(jp, jnp.asarray(x), interpret=True))
    got = tpc.spmv_compact(to_port(jp), x, device="cpu").numpy()
    assert rel(got, want) < 1e-6
    ported = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    got2 = tpc.spmv_compact(ported, x, device="cpu").numpy()
    assert rel(got2, want) < 1e-6


def test_expanded_path_matches_jax():
    rng = np.random.default_rng(9)
    rows, cols, vals, n_r, n_c = hub_coo(rng)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    tp = to_port(jp)
    x = rng.standard_normal(n_c).astype(np.float32)
    X = rng.standard_normal((n_c, 70)).astype(np.float32)
    y = tspmv.spmv(tp, torch.as_tensor(x)).numpy()
    assert rel(y, np.asarray(jspmv.spmv(jp, jnp.asarray(x)))) < 1e-5
    Y = tspmv.spmm(tp, torch.as_tensor(X)).numpy()       # two col chunks
    assert rel(Y, np.asarray(jspmv.spmm(jp, jnp.asarray(X)))) < 1e-5
    assert rel(Y, coo_oracle(rows, cols, vals, X, n_r)) < 1e-5
    # tables expanded once per device and memoised on the plan
    assert set(tp._tables) == {"cpu"} and set(tp._spmm_tables) == {"cpu"}


def test_bf16_split_matches_jax():
    rng = np.random.default_rng(10)
    v = np.concatenate([rng.standard_normal(5000).astype(np.float32),
                        np.float32([0.0, -0.0, 1e-40, -3e-39, 3.4e38,
                                    1.0 + 2.0 ** -23])])
    for passes in (1, 2, 3):
        jparts = jrouted._bf16_split(jnp.asarray(v), passes)
        tparts = trouted._bf16_split(torch.as_tensor(v), passes)
        # equal values (a zero residual of a subnormal may differ in
        # sign: XLA's CPU backend flushes subnormal results)
        for jp_, tp_ in zip(jparts, tparts):
            np.testing.assert_array_equal(tp_.numpy(), np.asarray(jp_))
    # exactness on normal values (subnormal arithmetic may be flushed in
    # a process that also runs XLA's CPU backend)
    v = v[np.abs(v) >= np.finfo(np.float32).tiny]
    vt = torch.as_tensor(v)
    assert torch.equal(trouted.split_sum(vt, 3), vt)        # exact
    # two passes: the first two JAX parts, summed exactly in f32
    jp2 = [np.asarray(p) for p in jrouted._bf16_split(jnp.asarray(v), 2)]
    two = trouted.split_sum(vt, 2).numpy()
    np.testing.assert_array_equal(two, jp2[0] + jp2[1])
    assert (np.abs(two - v) / np.abs(v)).max() < 2.0 ** -15


def test_gather_1d_and_ext_table():
    rng = np.random.default_rng(12)
    t = rng.standard_normal(37).astype(np.float32)
    idx = rng.integers(0, 38, 200)                  # 37 is the sentinel
    got = tspmv.gather_1d(torch.as_tensor(t), torch.as_tensor(idx)).numpy()
    want = np.asarray(jspmv.gather_1d(jnp.asarray(t), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want)
    assert tspmv._ext_table(torch.as_tensor(t)).shape == (5, 8)


def test_kernel_wrappers_refuse_bad_operands():
    rng = np.random.default_rng(13)
    rows, cols, vals = random_coo(rng, 600, 400, 3000)
    tp = tspmv.build_spmv_plan(rows, cols, vals, n_rows=600, n_cols=400)
    tables = tpc.compact_tables(tp, "cpu")
    assert tpc.compact_tables(tp, "cpu") is tables           # memoised
    x = torch.as_tensor(rng.standard_normal(400).astype(np.float32))
    want = coo_oracle(rows, cols, vals, x.numpy(), 600)
    np.testing.assert_allclose(tpc.spmv_scatter_plain(*tables, x, 600).numpy(),
                               want, rtol=1e-5, atol=1e-5)
    view = tpc.csr_view_on(tp, "cpu")
    assert tpc.csr_view_on(tp, "cpu") is view                # memoised
    y = tpc.spmv_scatter(view, x)
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError):
        tpc.spmv_scatter(view, x.double())
    with pytest.raises(TypeError):
        tpc.spmv_scatter(tables, x)                          # not a view
    with pytest.raises(ValueError):
        tpc.spmv_scatter(view, x, passes=4)
    with pytest.raises(ValueError):
        tpc.spmv_scatter(view, x[None])                      # 2-D operand
    with pytest.raises(ValueError):
        tpc.spmm_scatter(view, x)                            # 1-D operand
    X = torch.as_tensor(rng.standard_normal((400, 6)).astype(np.float32))
    with pytest.raises(ValueError):
        tpc.spmm_scatter(view, X.T)                          # not contiguous
    with pytest.raises(ValueError):
        tpc.spmm_scatter(view, X[:-1])                       # X too short


@pytest.mark.parametrize("n", [399, 401])
def test_b2_refuses_x_of_another_length(n):
    """x must have exactly view.n_cols entries: the kernel gathers
    x[col] for every column of the view, and a longer x would hide a
    caller's mix-up."""
    rng = np.random.default_rng(15)
    rows, cols, vals = random_coo(rng, 600, 400, 3000)
    tp = tspmv.build_spmv_plan(rows, cols, vals, n_rows=600, n_cols=400)
    x = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
    with pytest.raises(ValueError, match="view's columns are 400"):
        tpc.spmv_scatter(tpc.csr_view_on(tp, "cpu"), x)


def b2_case(name, rng):
    """(rows, cols, vals, n_rows, n_cols, plan kwargs) of a B2 view case."""
    kw = {}
    if name == "hub_row":               # 1/3 of the edges on row 7, kept
        n_r, n_c, m = 4096, 3000, 6000  # in the tables (no overflow)
        rows, cols, vals = random_coo(rng, n_r, n_c, m)
        rows[rng.random(m) < 1 / 3] = 7
        kw = dict(capacity_quantile=1.0, max_padding=10.0)
    elif name == "empty_blocks":        # blocks 1 and 3 hold no slot
        n_r, n_c, m = 2500, 1999, 20_000
        rows, cols, vals = random_coo(rng, n_r, n_c, m)
        moved = np.isin(rows // tspmv.BLOCK, (1, 3))
        rows = np.where(moved, (rows + tspmv.BLOCK) % n_r, rows)
    elif name == "mostly_sentinel":     # ~30 edges a block of 128 slots
        n_r, n_c, m = 5000, 4096, 300
        rows, cols, vals = random_coo(rng, n_r, n_c, m)
        kw = dict(max_padding=10.0)
    else:                               # "overflow" and "transpose"
        rows, cols, vals, n_r, n_c = hub_coo(rng)
        if name == "transpose":         # x'·A: the plan of Aᵀ
            rows, cols, n_r, n_c = cols, rows, n_c, n_r
    return rows, cols, vals, n_r, n_c, kw


@pytest.mark.parametrize("passes,tol", [(3, 1e-6), (2, 1e-4)])
@pytest.mark.parametrize("case", ["hub_row", "empty_blocks",
                                  "mostly_sentinel", "overflow",
                                  "transpose"])
def test_b2_view_matches_jax_interpret(case, passes, tol):
    """B2 on the plan's CSR view (the wrapper's plain walk on the CPU)
    against its yardstick on the compact tables, and compact_apply
    (overflow included) against the JAX package's compact_apply in
    interpret mode, on the same tables."""
    rng = np.random.default_rng(40 + passes)
    rows, cols, vals, n_r, n_c, kw = b2_case(case, rng)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c,
                               **kw)
    tp = to_port(jp)
    assert (tp.ov_rows is not None) == (case == "overflow")
    x = rng.standard_normal(n_c).astype(np.float32)
    xt = torch.as_tensor(x)
    view = tpc.csr_view_on(tp, "cpu")
    before = tpc.LAUNCHES_SPMV
    y = tpc.spmv_scatter(view, xt, passes)
    assert tpc.LAUNCHES_SPMV == before          # CPU: plain walk
    yp = tpc.spmv_scatter_plain(*tpc.compact_tables(tp, "cpu"), xt, n_r,
                                tp.block, passes)
    assert rel(y, yp) < tol
    if case == "empty_blocks":
        assert not y[tspmv.BLOCK:2 * tspmv.BLOCK].any()
        assert not y[3 * tspmv.BLOCK:4 * tspmv.BLOCK].any()
    if case == "hub_row":
        hub = view.row_ptr[7:9].tolist()
        assert hub[1] - hub[0] > 1000
    ov = jp.overflow
    static = (jp.n_rows, jp.n_cols, jp.block, jspmv.LO)
    want = np.asarray(jpc.compact_apply(static, jpc.compact_tables(jp), ov,
                                        jnp.asarray(x), passes,
                                        interpret=True))
    got = tpc.compact_apply(tp, xt, passes).numpy()
    assert got.shape == (n_r,) and got.dtype == np.float32
    assert rel(got, want) < max(tol, 1e-5 if ov else 0.0)
    oracle_tol = {3: 1e-5, 2: 1e-4}[passes]
    assert rel(got, coo_oracle(rows, cols, vals, x, n_r)) < oracle_tol


@pytest.mark.parametrize("passes", [2, 3])
def test_run_pagerank_compact_on_view_matches_jax(passes):
    """PageRank's rounds go through B2 on the plan's CSR view; 10 rounds
    on a graph with a hub of in-edges agree with the JAX package's
    compact PageRank (interpret mode) at the JAX tests' bound."""
    from matrel_tpu.workloads import pagerank as jpr
    from matrel_tpu_torch.workloads import pagerank as tpr
    rng = np.random.default_rng(50 + passes)
    n, m = 3000, 24_000
    src = rng.integers(0, n, m)
    dst = np.where(rng.random(m) < 0.1, 11, rng.integers(0, n, m))
    want = np.asarray(jpr.run_pagerank_compact(
        jpr.prepare_pagerank_onehot(src, dst, n), rounds=10, passes=passes,
        interpret=True))
    prepared = tpr.prepare_pagerank_onehot(src, dst, n, device="cpu")
    got = tpr.run_pagerank_compact(prepared, rounds=10, passes=passes)
    assert tpc.csr_view_on(prepared[0], "cpu").n_rows == n
    assert rel(got.numpy(), want) < {3: 1e-5, 2: 1e-4}[passes]


@pytest.mark.parametrize("k,kc", [(1, 1), (2, 2), (5, 8), (16, 16),
                                  (33, 32), (128, 32), (200, 32)])
def test_b3_column_chunk(k, kc):
    # the columns a group of lanes walks: the next power of two >= k, at
    # most 32; wider X is walked in ceil(k / 32) column chunks
    assert tpc.column_chunk(k) == kc
    assert kc & (kc - 1) == 0 and kc <= 32
    assert -(-k // kc) == (1 if k <= 32 else -(-k // 32))


def test_use_pallas_false_runs_plain_version():
    rng = np.random.default_rng(14)
    rows, cols, vals = random_coo(rng, 900, 900, 5000)
    tp = tspmv.build_spmv_plan(rows, cols, vals, n_rows=900, n_cols=900)
    x = rng.standard_normal(900).astype(np.float32)
    a = tpc.spmv_compact(tp, x, device="cpu").numpy()
    b = tpc.spmv_compact(tp, x, device="cpu", use_pallas=False).numpy()
    np.testing.assert_array_equal(a, b)
