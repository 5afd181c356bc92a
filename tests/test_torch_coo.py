"""PyTorch port: COOMatrix, the COO dispatch through
``MatrelSession.compute`` and PageRank over edges
(matrel_tpu_torch/core/coo.py, executor.py, parallel/planner.py,
workloads/pagerank.py) held against the JAX package on the CPU.

The JAX session runs on a 1x1 mesh with ``MatrelConfig(pallas_interpret
=True)``, so its COO matmuls take the compact Pallas kernels in
interpret mode, as on the TPU; the port's take the kernel wrappers'
plain versions (CPU tensors). Inputs come from
``np.random.default_rng(seed)`` and reach the port through
``matrel_tpu_torch.convert``. Tolerances: f32-faithful SpMV rel 1e-5 of
max|y| (test_spmv.py's overflow bound), SpMM rel 1e-4, PageRank rel
5e-4 and |Σr − 1| < 1e-3 (test_spmv.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.coo import COOMatrix as JCOO
from matrel_tpu.session import MatrelSession as JSession
from matrel_tpu.workloads import pagerank as jpr

from matrel_tpu_torch import (BlockSparseMatrix, DeviceUnavailableError,
                              MatrelConfig, MatrelSession, NotPortedError,
                              convert)
from matrel_tpu_torch.core.coo import COOMatrix
from matrel_tpu_torch.ops import pallas_spmv as tpc
from matrel_tpu_torch.parallel import planner as tplanner
from matrel_tpu_torch.workloads import pagerank as tpr


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tensors here are small: one intra-op thread keeps these tests
    from crowding the timing-sensitive tests other workers run beside
    them."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def graph(seed, n_r=2000, n_c=1800, m=20_000, hub=False):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_r, m)
    if hub:
        rows = np.where(rng.random(m) < 0.3, 5, rows)
    cols = rng.integers(0, n_c, m)
    vals = rng.standard_normal(m).astype(np.float32)
    A = JCOO.from_edges(rows, cols, vals, shape=(n_r, n_c))
    return rng, A, convert.from_reference(A, None)


def sessions(jmesh, **cfg):
    return (JSession(mesh=jmesh, config=JConfig(pallas_interpret=True,
                                                **cfg)),
            MatrelSession(config=MatrelConfig(**cfg), device="cpu"))


# -- COOMatrix methods -----------------------------------------------------------


@pytest.mark.parametrize("hub", [False, True])
def test_matvec_rmatvec_matmat_match_jax(hub):
    rng, A, tA = graph(1, hub=hub)
    assert isinstance(tA, COOMatrix) and tA.shape == A.shape
    assert tA.nnz == A.nnz
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    y = rng.standard_normal(A.shape[0]).astype(np.float32)
    X = rng.standard_normal((A.shape[1], 16)).astype(np.float32)
    before = (tpc.LAUNCHES_SPMV, tpc.LAUNCHES_SPMM)
    got = tA.matvec(x, device="cpu").numpy()
    assert rel(got, np.asarray(A.matvec(jnp.asarray(x)))) < 1e-5
    assert rel(got, A.to_dense().astype(np.float64) @ x) < 1e-5
    got = tA.rmatvec(y, device="cpu").numpy()
    assert rel(got, np.asarray(A.rmatvec(jnp.asarray(y)))) < 1e-5
    got = tA.matmat(X, device="cpu").numpy()
    assert rel(got, np.asarray(A.matmat(jnp.asarray(X)))) < 1e-4
    assert (tpc.LAUNCHES_SPMV, tpc.LAUNCHES_SPMM) == before   # CPU
    np.testing.assert_array_equal(tA.to_dense(), A.to_dense())
    assert tA.matmat(X[:, :0], device="cpu").shape == (A.shape[0], 0)


def test_use_pallas_off_takes_expanded_path(monkeypatch):
    from matrel_tpu_torch import config as tconfig
    rng, A, tA = graph(2)
    x = rng.standard_normal(A.shape[1]).astype(np.float32)
    X = rng.standard_normal((A.shape[1], 5)).astype(np.float32)
    monkeypatch.setattr(tconfig, "_default_config",
                        MatrelConfig(use_pallas=False))
    y = tA.matvec(x, device="cpu").numpy()
    Y = tA.matmat(X, device="cpu").numpy()
    plan = tA._get_plan()
    assert "cpu" in plan._tables and not plan._compact_dev
    assert rel(y, np.asarray(A.matvec(jnp.asarray(x)))) < 1e-5
    assert rel(Y, np.asarray(A.matmat(jnp.asarray(X)))) < 1e-4


def test_refused_plan_takes_segment_path():
    rng = np.random.default_rng(3)
    # one dense 512-row block in an 8M-row matrix: 2M padded slots for
    # 100k edges, past the 4x padding gate
    rows = np.concatenate([rng.integers(0, 512, 98_000),
                           rng.integers(0, 8_000_000, 2_000)])
    cols = rng.integers(0, 1000, rows.shape[0])
    vals = rng.standard_normal(rows.shape[0]).astype(np.float32)
    A = JCOO.from_edges(rows, cols, vals, shape=(8_000_000, 1000))
    tA = convert.from_reference(A, None)
    x = rng.standard_normal(1000).astype(np.float32)
    got = tA.matvec(x, device="cpu").numpy()
    assert tA._get_plan() is None and A._get_plan() is None
    assert "cpu" in tA._seg_fwd
    assert rel(got, np.asarray(A.matvec(jnp.asarray(x)))) < 1e-5
    X = rng.standard_normal((1000, 2)).astype(np.float32)
    got = tA.matmat(X, device="cpu").numpy()
    assert rel(got, np.asarray(A.matmat(jnp.asarray(X)))) < 1e-5


def test_transpose_view_and_from_scipy():
    import scipy.sparse as sp
    rng, A, tA = graph(4, n_r=300, n_c=200, m=2000)
    y = rng.standard_normal(300).astype(np.float32)
    got = tA.T.matvec(y, device="cpu").numpy()
    assert rel(got, tA.rmatvec(y, device="cpu").numpy()) < 1e-6
    B = COOMatrix.from_scipy(sp.random(50, 40, density=0.1, format="csr",
                                       random_state=0, dtype=np.float32))
    assert B.shape == (50, 40) and B.dtype == torch.float32
    with pytest.raises(ValueError, match="out of bounds"):
        COOMatrix.from_edges([0, 5], [0, 1], shape=(5, 5))


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, _, tA = graph(5, n_r=100, n_c=100, m=500)
    x = np.ones(100, np.float32)
    for call in (lambda: tA.matvec(x), lambda: tA.rmatvec(x),
                 lambda: tA.matmat(x[:, None]),
                 lambda: tpc.spmv_compact(tA._get_plan(), x),
                 lambda: tpc.spmm_compact(tA._get_plan(), x[:, None]),
                 lambda: tpr.pagerank_edges([0, 1], [1, 0], 2),
                 lambda: tpr.prepare_pagerank_onehot([0, 1], [1, 0], 2)):
        with pytest.raises(DeviceUnavailableError):
            call()


# -- compute() ---------------------------------------------------------------------


def compile_pair(js, ts, je, te):
    jp, tp = js.compile(je), ts.compile(te)
    assert tp.meta["rule_hits"] == jp.meta["rule_hits"]
    return jp, tp


@pytest.mark.parametrize("query", ["A·x", "xᵀ·A", "A·X16", "A·X200",
                                   "(A·X)ᵀ·2"])
def test_compute_matches_jax(jmesh, query):
    rng, A, tA = graph(6, n_r=1500, n_c=1200, m=15_000, hub=True)
    js, ts = sessions(jmesh)
    k = {"A·x": 1, "xᵀ·A": 1, "A·X16": 16, "A·X200": 200,
         "(A·X)ᵀ·2": 7}[query]
    if query == "xᵀ·A":
        x = rng.standard_normal((1500, k)).astype(np.float32)
    else:
        x = rng.standard_normal((1200, k)).astype(np.float32)
    jx = js.from_numpy(x)
    tx = convert.from_reference(jx, ts.mesh)
    if query == "xᵀ·A":
        je, te = jx.expr().t().multiply(A), tx.expr().t().multiply(tA)
    elif query == "(A·X)ᵀ·2":
        je = A.multiply(jx).t().multiply_scalar(2.0)
        te = tA.multiply(tx).t().multiply_scalar(2.0)
    else:
        je, te = A.multiply(jx), tA.multiply(tx)
    compile_pair(js, ts, je, te)
    want = js.compute(je).to_numpy()
    before = (tpc.LAUNCHES_SPMV, tpc.LAUNCHES_SPMM)
    got = ts.compute(te).to_numpy()
    assert (tpc.LAUNCHES_SPMV, tpc.LAUNCHES_SPMM) == before   # CPU
    assert got.shape == want.shape
    assert rel(got, want) < (1e-5 if k == 1 else 1e-4)
    dense = A.to_dense().astype(np.float64)
    if query == "xᵀ·A":
        oracle = x.T @ dense
    elif query == "(A·X)ᵀ·2":
        oracle = 2.0 * (dense @ x).T
    else:
        oracle = dense @ x
    assert rel(got, oracle) < (1e-5 if k == 1 else 1e-4)


def test_compute_expanded_path_and_densify_leaf(jmesh):
    rng, A, tA = graph(7, n_r=600, n_c=500, m=5000)
    js = JSession(mesh=jmesh, config=JConfig(use_pallas=False))
    ts = MatrelSession(config=MatrelConfig(use_pallas=False), device="cpu")
    X = rng.standard_normal((500, 3)).astype(np.float32)
    jX = js.from_numpy(X)
    tX = convert.from_reference(jX, ts.mesh)
    je, te = A.multiply(jX), tA.multiply(tX)
    compile_pair(js, ts, je, te)
    assert rel(ts.compute(te).to_numpy(), js.compute(je).to_numpy()) < 1e-5
    assert "cpu" in tA._get_plan()._tables        # expanded tables built
    # a COO leaf outside a matmul densifies
    je, te = A.expr().row_sum(), tA.expr().row_sum()
    compile_pair(js, ts, je, te)
    assert rel(ts.compute(te).to_numpy(), js.compute(je).to_numpy()) < 1e-5


def test_plan_cache_keys_coo_by_identity():
    rng, _, tA = graph(8, n_r=400, n_c=400, m=3000)
    tB = COOMatrix.from_edges(tA.rows, tA.cols, 2.0 * tA.vals,
                              shape=tA.shape)
    ts = MatrelSession(device="cpu")
    x = ts.from_numpy(rng.standard_normal((400, 1)).astype(np.float32))
    ya = ts.compute(tA.multiply(x)).to_numpy()
    yb = ts.compute(tB.multiply(x)).to_numpy()
    assert ts.plan_cache_info()["plans"] == 2
    np.testing.assert_allclose(yb, 2.0 * ya, rtol=1e-6, atol=1e-6)
    ts.compute(tA.multiply(x))
    assert ts.plan_cache_info()["plans"] == 2     # hit


def test_sparse_by_sparse_raises():
    _, _, tA = graph(9, n_r=64, n_c=64, m=300)
    ts = MatrelSession(device="cpu")
    S = BlockSparseMatrix.from_numpy(np.eye(64, dtype=np.float32),
                                     block_size=8, mesh=ts.mesh)
    for e in (tA.multiply(tA), tA.multiply(S), S.multiply(tA)):
        with pytest.raises(NotPortedError, match="S×S"):
            ts.compute(e)


def test_planner_coo_rules():
    _, _, tA = graph(10, n_r=256, n_c=256, m=1000)
    ts = MatrelSession(device="cpu")
    x = ts.from_numpy(np.ones((256, 1), np.float32))
    plan = ts.compile(tA.multiply(x))
    assert tplanner.infer_layout(plan.optimized, ts.mesh) == "rep"
    wide = ts.from_numpy(np.ones((256, 200), np.float32))
    plan = ts.compile(tA.multiply(wide))          # densify path
    assert tplanner.infer_layout(plan.optimized, ts.mesh) == "2d"
    assert tplanner.infer_dtype(tA.expr()) == torch.float32
    bad = COOMatrix(rows=tA.rows, cols=tA.cols,
                    vals=tA.vals.astype(np.float64), shape=tA.shape)
    with pytest.raises(TypeError, match="float32"):
        tplanner.infer_dtype(bad.expr())
    hi = ts.compile(tA.multiply(x), precision="high").optimized
    assert "precision_tier" not in hi.attrs       # COO keeps its numerics


# -- PageRank --------------------------------------------------------------------


def pr_graph(seed, n=3000, m=30_000):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, m), rng.integers(0, n, m), n


@pytest.mark.parametrize("impl", ["onehot", "segment", "auto"])
def test_pagerank_edges_matches_jax(impl):
    src, dst, n = pr_graph(11)
    want = np.asarray(jpr.pagerank_edges(src, dst, n, rounds=10,
                                         impl="onehot"))
    got = tpr.pagerank_edges(src, dst, n, rounds=10, impl=impl,
                             device="cpu").numpy()
    assert rel(got, want) < 5e-4
    assert abs(got.sum() - 1.0) < 1e-3
    a = np.zeros((n, n))
    np.add.at(a, (src, dst), 1.0)
    assert rel(got, tpr.pagerank_numpy_oracle(a, rounds=10).ravel()) < 5e-4


def test_pagerank_weighted_matches_jax():
    src, dst, n = pr_graph(12, n=1000, m=8000)
    w = np.random.default_rng(13).random(8000).astype(np.float32)
    want = np.asarray(jpr.pagerank_edges(src, dst, n, rounds=8, weights=w,
                                         impl="segment"))
    for impl in ("onehot", "segment"):
        got = tpr.pagerank_edges(src, dst, n, rounds=8, weights=w,
                                 impl=impl, device="cpu").numpy()
        assert rel(got, want) < 5e-4


def test_run_pagerank_compact_two_passes_matches_jax():
    src, dst, n = pr_graph(14)
    want = np.asarray(jpr.run_pagerank_compact(
        jpr.prepare_pagerank_onehot(src, dst, n), rounds=10, interpret=True))
    prepared = tpr.prepare_pagerank_onehot(src, dst, n, device="cpu")
    got = tpr.run_pagerank_compact(prepared, rounds=10).numpy()   # passes=2
    assert rel(got, want) < 5e-4
    assert abs(got.sum() - 1.0) < 1e-3
    expanded = tpr.run_pagerank_onehot(prepared, rounds=10).numpy()
    assert rel(got, expanded) < 5e-4
    with pytest.raises(ValueError):
        tpr.run_pagerank_compact(None)
    with pytest.raises(ValueError, match="unknown impl"):
        tpr.pagerank_edges(src, dst, n, impl="csr", device="cpu")


def test_pagerank_plan_cache_is_byte_aware(monkeypatch):
    monkeypatch.setattr(tpr, "_PLAN_CACHE", {})
    src, dst, n = pr_graph(15, n=1000, m=5000)
    tpr.pagerank_edges(src, dst, n, rounds=2, impl="onehot", device="cpu")
    assert len(tpr._PLAN_CACHE) == 1
    tpr.pagerank_edges(src.astype(np.int64), dst, n, rounds=2,
                       impl="onehot", device="cpu")
    assert len(tpr._PLAN_CACHE) == 1              # same graph, any dtype
    monkeypatch.setattr(tpr, "_PLAN_CACHE_MAX_SLOTS", 10)
    tpr.pagerank_edges(dst, src, n, rounds=2, impl="onehot", device="cpu")
    assert len(tpr._PLAN_CACHE) == 1              # oversized: uncached
