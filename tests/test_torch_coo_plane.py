"""PyTorch port: the rest of the COO plane — the native SpMV plan fill
(utils/native.py over native/spmv_plan.cc), save_plan / load_plan
(ops/spmv.py), compact_apply_chunked (ops/pallas_spmv.py) and the dense,
CSR and block-sparse PageRank (workloads/pagerank.py) — held against the
JAX package on the CPU.

Inputs come from ``np.random.default_rng(seed)`` at small sizes (≤ 4096
nodes, ≤ 25,000 edges, block sizes ≤ 64). The JAX compact kernel runs in
Pallas interpret mode, as tests/test_spmv.py runs it; the port's kernel
wrappers run their plain versions (CPU tensors). Tolerances: plan tables
and plan files exactly; native against numpy fill rtol 2e-5, atol 1e-5
(tests/test_native.py); the port's chunked walk bit-equal to its own
compact_apply and within 1e-5 of max|y| of the JAX kernel's (the SpMV
bound of tests/test_torch_coo.py); PageRank rtol 1e-3, atol 1e-6 against
the JAX package and its numpy oracle (tests/test_workloads.py), the CSR
form rtol 1e-4, atol 1e-8 against the edge-list form (the same file).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.blockmatrix import BlockMatrix as JBlockMatrix
from matrel_tpu.core.sparse import BlockSparseMatrix as JBlockSparse
from matrel_tpu.ops import pallas_spmv as jpc
from matrel_tpu.ops import spmv as jspmv
from matrel_tpu.workloads import pagerank as jpr

from matrel_tpu_torch import MatrelConfig
from matrel_tpu_torch.core import mesh as tmesh_lib
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.sparse import BlockSparseMatrix
from matrel_tpu_torch.ops import pallas_spmv as tpc
from matrel_tpu_torch.ops import spmv as tspmv
from matrel_tpu_torch.utils import native
from matrel_tpu_torch.workloads import pagerank as tpr

from test_torch_native_guard import ensure_reference_native

# the JAX package's native library, whole and loaded in this process
ensure_reference_native()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


def edges(case: str, seed: int = 0):
    """(rows, cols, vals or None, n_rows, n_cols) of one test graph."""
    rng = np.random.default_rng(seed)
    if case == "uniform":
        n_r, n_c, m = 2000, 1500, 25_000
    elif case == "small":
        n_r, n_c, m = 512, 512, 100
    elif case == "empty":
        n_r, n_c, m = 100, 100, 0
    elif case == "hub":             # row 7 overflows its block's capacity
        n_r, n_c, m = 4096, 512, 20_000
    else:                           # unit weights, ragged last block
        n_r, n_c, m = 3000, 2500, 24_000
    rows = rng.integers(0, n_r, m).astype(np.int64)
    if case == "hub":
        rows = np.where(rng.random(m) < 0.3, 7, rows)
    cols = rng.integers(0, n_c, m).astype(np.int64)
    vals = (None if case == "unweighted"
            else rng.standard_normal(m).astype(np.float32))
    return rows, cols, vals, n_r, n_c


CASES = ("uniform", "small", "empty", "hub", "unweighted")
TABLES = ("src8", "lane", "off", "val")
OVERFLOW = ("ov_rows", "ov_cols", "ov_vals")


def x_for(n_c: int, seed: int = 5) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n_c).astype(
        np.float32)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# -- the native fill -------------------------------------------------------------


def test_native_library_builds_into_the_ports_build_dir():
    lib = native.load_spmv()
    assert lib is not None, "the native plan fill must build (g++ is present)"
    assert native.SPMV_LIB_PATH.endswith(
        os.path.join("build", "native", "libmatrel_spmv_plan.so"))
    assert os.path.exists(native.SPMV_LIB_PATH)


@pytest.mark.parametrize("case", CASES)
def test_native_fill_tables_equal_jax(case):
    rows, cols, vals, n_r, n_c = edges(case)
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    tp = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    assert tp.fill == "native"
    assert (tp.n_rows, tp.n_cols, tp.block, tp.capacity) == (
        jp.n_rows, jp.n_cols, jp.block, jp.capacity)
    assert tp.padding_ratio == jp.padding_ratio
    for name in TABLES:
        want = np.asarray(getattr(jp, name))
        got = getattr(tp, name)
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in OVERFLOW:
        want = getattr(jp, name)
        got = getattr(tp, name)
        assert (got is None) == (want is None), name
        if want is not None:
            np.testing.assert_array_equal(got, np.asarray(want),
                                          err_msg=name)


def test_native_counts_match_bincount():
    rows = np.random.default_rng(0).integers(0, 5000, 20_000)
    np.testing.assert_array_equal(native.spmv_counts(rows, 512, 10),
                                  np.bincount(rows // 512, minlength=10))
    assert native.spmv_counts(np.array([-1]), 512, 10) is None
    assert native.spmv_counts(np.array([5120]), 512, 10) is None


@pytest.mark.parametrize("case", CASES)
def test_native_and_numpy_fills_give_equal_results(case, monkeypatch):
    rows, cols, vals, n_r, n_c = edges(case, seed=1)
    nat = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    monkeypatch.setattr(native, "spmv_counts", lambda *a, **k: None)
    nump = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    assert (nat.fill, nump.fill) == ("native", "numpy")
    assert nat.capacity == nump.capacity
    assert nat.padding_ratio == nump.padding_ratio
    assert (nat.ov_rows is None) == (nump.ov_rows is None)
    x = torch.as_tensor(x_for(n_c))
    for run in (lambda p: tpc.compact_apply(p, x),
                lambda p: tspmv.spmv(p, x)):
        np.testing.assert_allclose(run(nat).numpy(), run(nump).numpy(),
                                   rtol=2e-5, atol=1e-5)
    # the numpy fill lays out the JAX package's numpy-filled tables
    jnp_plan = jspmv._numpy_fill(rows, cols, vals, len(rows), n_c, 512,
                                 -(-n_r // 512), nump.capacity,
                                 np.bincount(rows // 512,
                                             minlength=-(-n_r // 512)))
    for name, want in zip(TABLES, jnp_plan[:4]):
        np.testing.assert_array_equal(getattr(nump, name), want)


# -- plan files ----------------------------------------------------------------


@pytest.mark.parametrize("case", ("uniform", "hub", "empty"))
@pytest.mark.parametrize("direction", ("port_to_jax", "jax_to_port"))
def test_plan_files_move_between_packages(tmp_path, case, direction):
    rows, cols, vals, n_r, n_c = edges(case, seed=2)
    path = str(tmp_path / "plan.npz")
    if direction == "port_to_jax":
        src = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r,
                                    n_cols=n_c)
        tspmv.save_plan(path, src)
        got = jspmv.load_plan(path)
    else:
        src = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r,
                                    n_cols=n_c)
        jspmv.save_plan(path, src)
        got = tspmv.load_plan(path)
        assert got.fill == "loaded"
    assert (got.n_rows, got.n_cols, got.block, got.capacity) == (
        src.n_rows, src.n_cols, src.block, src.capacity)
    assert got.padding_ratio == src.padding_ratio
    for name in TABLES + OVERFLOW:
        a, b = getattr(got, name), getattr(src, name)
        assert (a is None) == (b is None), name
        if a is not None:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    # the file's mode is what the umask gives a new file
    assert os.stat(path).st_mode & 0o777 == 0o666 & ~tspmv._UMASK
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]


def test_loaded_plan_runs_bit_equal(tmp_path):
    rows, cols, vals, n_r, n_c = edges("hub", seed=3)
    plan = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    tspmv.save_plan(str(tmp_path / "p.npz"), plan)
    loaded = tspmv.load_plan(str(tmp_path / "p.npz"))
    x = torch.as_tensor(x_for(n_c))
    assert torch.equal(tpc.compact_apply(loaded, x),
                       tpc.compact_apply(plan, x))


@pytest.mark.parametrize("meta_edit", ("version", "width", "lo", "legacy"))
@pytest.mark.parametrize("saver", ("port", "jax"))
def test_load_plan_refuses_other_constants(tmp_path, meta_edit, saver):
    rows, cols, vals, n_r, n_c = edges("small", seed=4)
    path = str(tmp_path / "p.npz")
    if saver == "port":
        tspmv.save_plan(path, tspmv.build_spmv_plan(rows, cols, vals,
                                                    n_rows=n_r, n_cols=n_c))
    else:
        jspmv.save_plan(path, jspmv.build_spmv_plan(rows, cols, vals,
                                                    n_rows=n_r, n_cols=n_c))
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    meta = payload["meta"].copy()
    if meta_edit == "legacy":
        meta = meta[:4]
    else:
        meta[{"version": 4, "width": 5, "lo": 6}[meta_edit]] += 1
    payload["meta"] = meta
    np.savez(path, **payload)
    for load in (tspmv.load_plan, jspmv.load_plan):
        with pytest.raises(ValueError, match="rebuild the plan"):
            load(path)


# -- compact_apply_chunked --------------------------------------------------------


@pytest.fixture(scope="module")
def chunk_case():
    rows, cols, vals, n_r, n_c = edges("hub", seed=6)
    n_r = 3000                       # ragged last block, hub overflow
    rows = rows % n_r
    jp = jspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    tp = tspmv.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
    x = x_for(n_c, seed=7)
    static = (jp.n_rows, jp.n_cols, jp.block, jspmv.LO)
    want = np.asarray(jpc.compact_apply_chunked(
        static, jpc.compact_tables(jp), jp.overflow, jnp.asarray(x),
        chunks=3, interpret=True))
    assert tp.ov_rows is not None
    return tp, torch.as_tensor(x), want


@pytest.mark.parametrize("chunks", (1, 2, 3, 4, 6, 100))
@pytest.mark.parametrize("use_pallas", (True, False))
def test_compact_apply_chunked(chunk_case, chunks, use_pallas):
    tp, x, want = chunk_case
    got = tpc.compact_apply_chunked(tp, x, chunks=chunks,
                                    use_pallas=use_pallas)
    assert torch.equal(got, tpc.compact_apply(tp, x, use_pallas=use_pallas))
    assert rel(got.numpy(), want) < 1e-5


def test_scatter_rows_checks_its_range(chunk_case):
    tp, x, _ = chunk_case
    view = tpc.csr_view_on(tp, "cpu")
    out = torch.zeros(tp.n_rows)
    with pytest.raises(ValueError, match="row range"):
        tpc.spmv_scatter_rows(view, x, 10, tp.n_rows + 1, out)
    with pytest.raises(ValueError, match="out must be"):
        tpc.spmv_scatter_rows(view, x, 0, 5, torch.zeros(3))
    # an empty range writes nothing
    assert torch.equal(tpc.spmv_scatter_rows(view, x, 7, 7, out),
                       torch.zeros(tp.n_rows))


# -- PageRank ------------------------------------------------------------------


def adjacency(n: int, seed: int, dangling=()):
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < 0.1).astype(np.float32)
    np.fill_diagonal(a, 0)
    a[list(dangling)] = 0
    return a


@pytest.mark.parametrize("grid", ((1, 1), (2, 4)))
@pytest.mark.parametrize("n,dangling", ((50, ()), (50, (3, 17)), (3, (2,))))
def test_dense_pagerank_matches_jax(jmesh, grid, n, dangling):
    if n == 3:        # tests/test_workloads.py's mass-conservation graph
        a = np.array([[0, 1, 1], [1, 0, 0], [0, 0, 0]], np.float32)
    else:
        a = adjacency(n, seed=n, dangling=dangling)
    want = np.asarray(jpr.pagerank(JBlockMatrix.from_numpy(a, mesh=jmesh),
                                   rounds=30))
    mesh = tmesh_lib.make_mesh(grid, device="cpu")
    got = tpr.pagerank(BlockMatrix.from_numpy(a, mesh=mesh), rounds=30)
    assert tuple(got.shape) == want.shape == (a.shape[0], 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               jpr.pagerank_numpy_oracle(a, rounds=30),
                               rtol=1e-3, atol=1e-6)
    assert float(got.sum()) == pytest.approx(1.0, rel=1e-3)


def test_dense_pagerank_refuses_non_square():
    with pytest.raises(ValueError, match="square"):
        tpr.pagerank(BlockMatrix.from_numpy(np.ones((3, 4), np.float32),
                                            mesh=tmesh_lib.make_mesh(
                                                device="cpu")))


@pytest.mark.parametrize("n,seed", ((80, 0), (200, 1)))
def test_pagerank_csr_matches_jax_and_edges(n, seed):
    a = adjacency(n, seed)
    src, dst = np.nonzero(a)
    got = tpr.pagerank_csr(src, dst, n, rounds=20, device="cpu")
    want = np.asarray(jpr.pagerank_csr(src, dst, n, rounds=20))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-6)
    seg = tpr.pagerank_edges(src, dst, n, rounds=20, device="cpu")
    np.testing.assert_allclose(got.numpy(), seg.numpy(), rtol=1e-4,
                               atol=1e-8)


def test_pagerank_csr_on_a_regular_graph_takes_the_table(monkeypatch):
    """In-degree exactly 4 everywhere: the table path runs, no fallback."""
    n = 256
    rng = np.random.default_rng(9)
    dst = np.repeat(np.arange(n), 4)
    src = rng.integers(0, n, dst.size)
    calls = []
    monkeypatch.setattr(tpr, "pagerank_edges",
                        lambda *a, **k: calls.append(1))
    got = tpr.pagerank_csr(src, dst, n, rounds=15, device="cpu")
    assert not calls
    a = np.zeros((n, n), np.float64)
    np.add.at(a, (src, dst), 1.0)
    np.testing.assert_allclose(got.numpy(), jpr.pagerank_numpy_oracle(
        a, rounds=15).ravel(), rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jpr.pagerank_csr(src, dst, n, rounds=15)), rtol=1e-3, atol=1e-6)


def test_pagerank_csr_falls_back_on_a_hub():
    n = 50
    src = np.arange(1, n, dtype=np.int32)
    dst = np.zeros(n - 1, dtype=np.int32)   # in-degree 49 >> mean 1
    got = tpr.pagerank_csr(src, dst, n, rounds=10, device="cpu")
    assert tuple(got.shape) == (n,) and abs(float(got.sum()) - 1.0) < 1e-3
    assert torch.equal(got, tpr.pagerank_edges(src, dst, n, rounds=10,
                                               device="cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jpr.pagerank_csr(src, dst, n, rounds=10)), rtol=1e-3, atol=1e-6)


def community_adjacency(n: int, bs: int, seed: int, weight: float = 1.0):
    rng = np.random.default_rng(seed)
    a = np.zeros((n, n), dtype=np.float32)
    a[0:bs, bs:2 * bs] = weight * (rng.random((bs, bs)) < 0.6)
    a[bs:2 * bs, 2 * bs:3 * bs] = weight * (rng.random((bs, bs)) < 0.6)
    a[2 * bs:3 * bs, 0:bs] = weight * (rng.random((bs, bs)) < 0.6)
    a[0:bs, 0:bs] += weight * (rng.random((bs, bs)) < 0.3)
    np.fill_diagonal(a, 0)
    return a


@pytest.mark.parametrize("weight", (1.0, 0.1))
@pytest.mark.parametrize("use_pallas", (True, False))
@pytest.mark.parametrize("n,bs", ((32, 8), (100, 16)))
def test_pagerank_block_sparse_matches_jax(jmesh, weight, use_pallas, n,
                                           bs):
    """Row sums below 1 with weight 0.1 (the epsilon floor); a ragged
    last block row at n = 100; block rows with no tiles (dangling)."""
    a = community_adjacency(n, bs, seed=n, weight=weight)
    want = np.asarray(jpr.pagerank_block_sparse(
        JBlockSparse.from_numpy(a, block_size=bs, mesh=jmesh), rounds=20,
        config=JConfig(use_pallas=False)))
    S = BlockSparseMatrix.from_numpy(
        a, block_size=bs, mesh=tmesh_lib.make_mesh(device="cpu"))
    got = tpr.pagerank_block_sparse(S, rounds=20,
                                    config=MatrelConfig(use_pallas=use_pallas))
    assert tuple(got.shape) == want.shape == (n, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.numpy(),
                               jpr.pagerank_numpy_oracle(a, rounds=20),
                               rtol=1e-3, atol=1e-6)
