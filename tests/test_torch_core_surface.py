"""PyTorch port: the rest of the core surface held against the JAX package
on the CPU — ``MatrelSession.run_many`` (one MultiPlan a batch, in the
session's plan cache), the ``vec`` and ``rank1`` lowerings,
``planner.matmul_decisions`` / ``executor.plan_matmul_decisions`` over
the plan-snapshot corpus on a virtual (2, 4) grid (also with fusion on
and under reshard budgets), the native chain DP (``utils/native.py``)
against the Python DP, ``strategies.local_dot`` on bf16 operands, and
the leftovers: ``MatrelConfig.from_env`` / ``from_dict`` /
``set_default_config``, ``BlockMatrix.zeros`` / ``eye`` /
``from_block_fn`` and the leaf shortcuts, ``session.zeros`` / ``eye``,
``BlockSparseMatrix.from_scipy`` / ``norm``, ``planner.choose_strategy``
/ ``tier_error_bound`` and ``chain_bench.compile_chain``.

Tolerances: a ``run_many`` result equals the same query's own
``compute`` exactly (the same plan code on the same inputs) and the JAX
package's within its test tolerances (dense rtol 1e-4 / atol 1e-5,
sparse 1e-4); ``vec`` is a permutation, exact; ``rank1`` adds one
product per entry, exact in f32 against the JAX package for these
inputs and within 1e-6 of float64; decision records are equal field for
field (floats by ``pytest.approx``, 1e-12 relative); the native DP's
cost equals the Python DP's within 5% where densities are re-estimated
per split (nnz rounding, as tests/test_native.py allows), exactly on
dense chains.
"""

import importlib.util
import os

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrel_tpu import executor as j_exec
from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.coo import COOMatrix as JCOO
from matrel_tpu.core.sparse import BlockSparseMatrix as JBlockSparse
from matrel_tpu.ir import rules as j_rules
from matrel_tpu.parallel import planner as j_planner
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch import convert, executor as t_exec
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.ir import chain as t_chain, expr as TE, rules as t_rules
from matrel_tpu_torch.parallel import planner as t_planner, strategies
from matrel_tpu_torch.session import MatrelSession
from matrel_tpu_torch.utils import native
from matrel_tpu_torch.workloads import chain_bench as t_chain_bench

from test_torch_native_guard import ensure_reference_native

# the JAX package's native library, whole and loaded in this process
ensure_reference_native()

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


def sessions(jmesh, **cfg):
    return (JSession(mesh=jmesh, config=JConfig(**cfg)),
            MatrelSession(config=MatrelConfig(**cfg), device="cpu"))


def pair(js, ts, arr):
    jm = js.from_numpy(arr)
    return jm, convert.from_reference(jm, ts.mesh)


# -- run_many ----------------------------------------------------------------


def _batch(js, ts, kind, seed):
    """(JAX exprs, port exprs, float64 oracles) of one batch."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((40, 12)).astype(np.float32)
    b = rng.standard_normal((12, 30)).astype(np.float32)
    c = rng.standard_normal((30, 7)).astype(np.float32)
    (jA, tA), (jB, tB), (jC, tC) = (pair(js, ts, x) for x in (a, b, c))
    je = [jA.multiply(jB), jA.multiply(jB).multiply(jC)]
    te = [tA.multiply(tB), tA.multiply(tB).multiply(tC)]
    want = [a @ b, a @ b @ c]
    if kind in ("coo", "mixed"):
        rows = rng.integers(0, 40, 300)
        cols = rng.integers(0, 40, 300)
        vals = rng.standard_normal(300).astype(np.float32)
        jS = JCOO.from_edges(rows, cols, vals, shape=(40, 40))
        tS = convert.from_reference(jS, ts.mesh)
        s = np.zeros((40, 40))
        np.add.at(s, (rows, cols), vals)
        x = rng.standard_normal((40, 1)).astype(np.float32)
        jx, tx = pair(js, ts, x)
        je += [jS.multiply(jx), jS.multiply(jA)]
        te += [tS.multiply(tx), tS.multiply(tA)]
        want += [s @ x, s @ a]
    if kind in ("block_sparse", "mixed"):
        sp = np.zeros((48, 40), np.float32)
        sp[0:8, 8:16] = rng.standard_normal((8, 8))
        sp[24:32, 32:40] = rng.standard_normal((8, 8))
        jS = JBlockSparse.from_numpy(sp, block_size=8, mesh=js.mesh)
        tS = convert.from_reference(jS, ts.mesh)
        je.append(jS.multiply(jA))
        te.append(tS.multiply(tA))
        want.append(sp @ a)
    # a duplicate of the first root (a fresh expression, the same key)
    je.append(jA.multiply(jB))
    te.append(tA.multiply(tB))
    want.append(a @ b)
    return je, te, want


@pytest.mark.parametrize("kind", ["dense", "coo", "block_sparse", "mixed"])
def test_run_many_matches_jax(jmesh, kind):
    js, ts = sessions(jmesh)
    je, te, want = _batch(js, ts, kind, seed=len(kind))
    jout = js.run_many(je)
    tout = ts.run_many(te)
    assert len(tout) == len(te)
    for g, j, w, e in zip(tout, jout, want, te):
        assert g.shape == j.shape == w.shape
        np.testing.assert_allclose(g.to_numpy(), j.to_numpy(), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(g.to_numpy(), w, rtol=1e-4, atol=1e-4)
    # one MultiPlan, the duplicate root deduplicated (the same object)
    assert ts.plan_cache_info()["plans"] == js.plan_cache_info()["plans"] \
        == 1
    assert tout[-1] is tout[0]
    # a reordered batch is a cache hit, results in the new order
    rev = ts.run_many(list(reversed(te)))
    js.run_many(list(reversed(je)))
    assert ts.plan_cache_info()["plans"] == js.plan_cache_info()["plans"] \
        == 1
    for g, w in zip(rev, reversed(tout)):
        np.testing.assert_array_equal(g.to_numpy(), w.to_numpy())
    # each result equals its own compute() exactly
    for g, e in zip(tout, te):
        np.testing.assert_array_equal(g.to_numpy(), ts.compute(e).to_numpy())


def test_run_many_cache_keys(jmesh):
    js, ts = sessions(jmesh)
    je, te, _ = _batch(js, ts, "dense", seed=3)
    plan, hit, keys = ts._compile_multi_entry(te)
    assert not hit and len(keys) == len(te) and keys[0] == keys[-1]
    assert plan._root_keys == tuple(sorted(set(keys)))
    assert len(plan.optimized) == len(set(keys))
    assert ts._compile_multi_entry(list(reversed(te)))[1]
    # another precision SLA is another entry, keyed under its prefix
    _, hit_fast, _ = ts._compile_multi_entry(te, sla="fast")
    assert not hit_fast
    assert any(k.startswith("multi:prec:fast|") for k in ts._plan_cache)
    assert ts.plan_cache_info()["plans"] == 2
    jp, jhit, jkeys = js._compile_multi_entry(je)
    assert not jhit and len(jp.optimized) == len(plan.optimized)


def test_run_many_precision_matches_jax(jmesh):
    js, ts = sessions(jmesh)
    je, te, want = _batch(js, ts, "dense", seed=4)
    jout = js.run_many(je, precision="high")
    tout = ts.run_many(te, precision="high")
    for g, j in zip(tout, jout):
        # the bf16 split's bound (test_torch_session.py)
        np.testing.assert_allclose(g.to_numpy(), j.to_numpy(), rtol=2e-3,
                                   atol=2e-3)


def test_run_many_empty_and_unported_arguments(jmesh):
    js, ts = sessions(jmesh)
    assert ts.run_many([]) == [] and js.run_many([]) == []
    assert ts.plan_cache_info()["plans"] == 0
    A = ts.from_numpy(np.eye(4, dtype=np.float32))
    # the serve plane's arguments are ported (the batch deadline, the
    # tenant tag, the pipeline's channel and the brownout rung)
    for kw in ({"deadline_ms": 60_000.0}, {"tenant": "a"},
               {"_queue_wait_ms": [1.0]}, {"_inflight_depth": 2},
               {"_tenants": ["a"]}, {"_brownout_rung": 1}):
        out, = ts.run_many([A.multiply(A)], **kw)
        assert torch.equal(out.data, A.data)


# -- vec and rank1 -----------------------------------------------------------


@pytest.fixture(scope="module")
def grid_meshes(mesh8):
    return mesh8, make_mesh((2, 4), device="cpu")


SHAPES = [(4, 8), (5, 3), (1, 7), (9, 1), (13, 6)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_vec_matches_jax(grid_meshes, shape, dtype):
    jm, tm = grid_meshes
    js = JSession(mesh=jm)
    ts = MatrelSession(mesh=tm)
    rng = np.random.default_rng(shape[0] * 10 + shape[1])
    arr = rng.integers(-50, 50, shape).astype(np.float32)
    jA = js.from_numpy(arr.astype(np.int32) if dtype == "int32" else arr,
                       dtype=dtype)
    tA = convert.from_reference(jA, tm)
    jv = js.compute(jA.expr().vec())
    tv = ts.compute(tA.expr().vec())
    assert tv.shape == jv.shape == (shape[0] * shape[1], 1)
    # the padded layout too: zeros past the logical rows
    np.testing.assert_array_equal(
        tv.data.float().numpy(), np.asarray(jv.data).astype(np.float32))
    np.testing.assert_array_equal(tv.to_numpy()[:, 0].astype(np.float32),
                                  arr.T.reshape(-1))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_rank1_matches_jax(grid_meshes, shape, dtype):
    jm, tm = grid_meshes
    # rank1 reaches the lowering when the rewrite rules leave it alone
    js = JSession(mesh=jm, config=JConfig(rewrite_rules=False))
    ts = MatrelSession(mesh=tm, config=MatrelConfig(rewrite_rules=False))
    n, m = shape
    rng = np.random.default_rng(n * 10 + m + 1)
    npdt = np.float32 if dtype == "float32" else np.int32
    a, u, v = (rng.integers(-9, 9, s).astype(npdt)
               for s in ((n, m), (n, 1), (m, 1)))
    if dtype == "float32":
        a = a + rng.standard_normal((n, m)).astype(np.float32)
    (jA, tA), (ju, tu), (jv, tv) = (
        (lambda jx: (jx, convert.from_reference(jx, tm)))(js.from_numpy(x))
        for x in (a, u, v))
    got = ts.compute(tA.expr().rank_one_update(tu, tv))
    want = js.compute(jA.expr().rank_one_update(ju, jv))
    assert got.shape == want.shape == (n, m)
    assert got.to_numpy().dtype == want.to_numpy().dtype
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    oracle = a.astype(np.float64) + u.astype(np.float64) @ v.T
    np.testing.assert_allclose(got.to_numpy(), oracle, rtol=1e-6, atol=1e-6)


def test_vec_and_rank1_are_lowered():
    # twelve kinds after the eighth slice, nineteen with the relational
    # σ/⋈ kinds of the ninth
    assert len(t_exec.LOWERED_KINDS) == 19
    assert {"vec", "rank1"} <= set(t_exec.LOWERED_KINDS)


# -- matmul_decisions --------------------------------------------------------


def _load_snapshot_tool():
    spec = importlib.util.spec_from_file_location(
        "plan_snapshot", os.path.join(REPO, "tools", "plan_snapshot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(mesh8):
    return dict(_load_snapshot_tool().corpus(mesh8))


def to_port(e, tmesh, memo=None):
    """A JAX-package MatExpr carried node for node into the port's IR."""
    memo = {} if memo is None else memo
    if e.uid in memo:
        return memo[e.uid]
    attrs = dict(e.attrs)
    if "matrix" in attrs:
        attrs["matrix"] = convert.from_reference(attrs["matrix"], tmesh)
    out = TE.MatExpr(e.kind, tuple(to_port(c, tmesh, memo)
                                   for c in e.children),
                     tuple(e.shape), e.nnz, attrs)
    memo[e.uid] = out
    return out


#: The corpus cases the port plans (tests/test_torch_planner.py COVERED).
COVERED = ("block_sparse_matmul", "chain_interior_credit",
           "chain_layout_flip", "chain_skewed", "coo_spmv_matvec",
           "gram_AtA", "linreg_normal_equations", "rank1_pushdown",
           "replicated_operand_matmul")
CONFIGS = {"default": {}, "sla_fast": {"precision_sla": "fast"},
           "weighted_axes": {"axis_cost_weights": (1.0, 4.0)}}


def _strip(recs):
    """Records without the package-local node uid."""
    return [{k: v for k, v in r.items() if k != "uid"} for r in recs]


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(_strip(got), _strip(want)):
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            if isinstance(w[k], float):
                assert g[k] == pytest.approx(w[k], rel=1e-12), k
            elif isinstance(w[k], list):
                assert g[k] == pytest.approx(w[k], rel=1e-12), k
            else:
                assert g[k] == w[k], k


@pytest.mark.parametrize("cfg_name", CONFIGS)
@pytest.mark.parametrize("name", COVERED)
def test_matmul_decisions_match_jax(corpus, mesh8, name, cfg_name):
    cfg = CONFIGS[cfg_name]
    jcfg, tcfg = JConfig(**cfg), MatrelConfig(**cfg)
    tmesh = make_mesh((2, 4), device="cpu")
    je = corpus[name]
    jopt = j_planner.annotate_strategies(
        j_rules.optimize(je, jcfg, grid=(2, 4), mesh=mesh8), mesh8, jcfg)
    topt = t_planner.annotate_strategies(
        t_rules.optimize(to_port(je, tmesh), tcfg, grid=tmesh.grid,
                         mesh=tmesh), tmesh, tcfg)
    want = j_planner.matmul_decisions(jopt, mesh8, jcfg)
    got = t_planner.matmul_decisions(topt, tmesh, tcfg)
    assert want, name
    _assert_records_equal(got, want)
    assert len({r["uid"] for r in got}) == len(got)


@pytest.mark.parametrize("name", ["chain_skewed", "gram_AtA",
                                  "coo_spmv_matvec"])
def test_plan_matmul_decisions_match_jax(corpus, mesh8, name):
    tmesh = make_mesh((2, 4), device="cpu")
    je = corpus[name]
    jplan = j_exec.compile_expr(je, mesh8)
    tplan = t_exec.compile_expr(to_port(je, tmesh), tmesh)
    got = t_exec.plan_matmul_decisions(tplan)
    _assert_records_equal(got, j_exec.plan_matmul_decisions(jplan))
    assert t_exec.plan_matmul_decisions(tplan) is got     # cached in meta
    # a MultiPlan: every root's records, in root order
    multi = t_exec.compile_exprs((to_port(je, tmesh),), tmesh)
    _assert_records_equal(t_exec.plan_matmul_decisions(multi), got)


def test_comm_cost_axes_matches_jax():
    rng = np.random.default_rng(11)
    for strategy in strategies.STRATEGIES:
        for _ in range(8):
            n, k, m = (int(x) for x in rng.integers(1, 5000, 3))
            da, db = (float(x) for x in rng.choice([1.0, 0.3, 0.01], 2))
            la, lb = rng.choice(["2d", "row", "col", "rep"], 2)
            grid = [(2, 4), (4, 2), (2, 2), (1, 8)][int(rng.integers(4))]
            w = [(1.0, 1.0), (1.0, 4.0), (3.0, 1.0)][int(rng.integers(3))]
            args = (strategy, n, k, m, da, db, *grid)
            kw = dict(a_layout=str(la), b_layout=str(lb), weights=w)
            assert t_planner.comm_cost_axes(*args, **kw) == pytest.approx(
                j_planner.comm_cost_axes(*args, **kw), rel=1e-12)


# -- the native chain DP -----------------------------------------------------


@pytest.fixture(scope="module")
def lib():
    got = native.load()
    assert got is not None, "the native DP must build (g++ is present)"
    return got


def _ops(dims, dens=None, grid=(1, 1)):
    """Chain leaves of the given shapes and densities (metadata only, as
    tests/test_native.py builds them)."""
    import dataclasses
    mesh = make_mesh(grid, device="cpu")
    base = MatrelSession(mesh=mesh).from_numpy(np.zeros((8, 8), np.float32))
    ops = []
    for i in range(len(dims) - 1):
        shape = (dims[i], dims[i + 1])
        nnz = None if dens is None else int(dens[i] * shape[0] * shape[1])
        ops.append(TE.leaf(dataclasses.replace(base, shape=shape, nnz=nnz)))
    return ops


def _python_dp(ops, grid, monkeypatch):
    with monkeypatch.context() as mp:
        mp.setattr(native, "chain_dp", lambda *a, **k: None)
        return t_chain.optimal_order(ops, grid=grid)


def _lib_stale() -> bool:
    return native._is_stale(native.SOURCE, native.LIB_PATH)


def test_native_library_builds_in_build_dir(lib):
    assert native.LIB_PATH == os.path.join(REPO, "build", "native",
                                           "libmatrel_chain_dp.so")
    assert os.path.exists(native.LIB_PATH)
    assert not _lib_stale()


def test_native_matches_python_dense(lib, monkeypatch):
    dims = [30, 35, 15, 5, 10, 20, 25]
    ops = _ops(dims)
    got, cost = t_chain.optimal_order(ops)
    want, pcost = _python_dp(ops, (1, 1), monkeypatch)
    assert cost == pytest.approx(pcost) == 2 * 15125   # CLRS optimum
    assert (t_chain_bench.parenthesisation(got)
            == t_chain_bench.parenthesisation(want))


def _sparse_chains():
    """tests/test_native.py's ten random sparse chains (seed 7)."""
    rng = np.random.default_rng(7)
    out = []
    for _ in range(10):
        n = int(rng.integers(3, 8))
        dims = [int(rng.integers(2, 400)) for _ in range(n + 1)]
        dens = [float(rng.choice([1.0, 1.0, 0.1, 0.01])) for _ in range(n)]
        out.append((dims, dens))
    return out


def _comm_chains():
    """tests/test_native.py's ten random chains on grids (seed 9)."""
    rng = np.random.default_rng(9)
    out = []
    for _ in range(10):
        n = int(rng.integers(3, 7))
        dims = [int(rng.integers(2, 600)) for _ in range(n + 1)]
        dens = [float(rng.choice([1.0, 1.0, 0.2, 0.02])) for _ in range(n)]
        grid = tuple(int(g) for g in rng.choice([(1, 2), (2, 2), (2, 4),
                                                 (4, 2)]))
        out.append((dims, dens, grid))
    return out


def _jax_costs(dims, dens, grid, mesh8):
    """(native, Python) DP costs of the JAX package on the same chain."""
    import dataclasses
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    from matrel_tpu.ir import chain as j_chain
    from matrel_tpu.ir.expr import leaf as j_leaf
    from matrel_tpu.utils import native as j_native
    base = JBM.from_numpy(np.zeros((8, 8), np.float32), mesh=mesh8)
    ops = [j_leaf(dataclasses.replace(
        base, shape=(dims[i], dims[i + 1]),
        nnz=int(dens[i] * dims[i] * dims[i + 1])))
        for i in range(len(dens))]
    _, nat = j_chain.optimal_order(ops, grid=grid)
    keep = j_native.chain_dp
    j_native.chain_dp = lambda *a, **k: None
    try:
        _, py = j_chain.optimal_order(ops, grid=grid)
    finally:
        j_native.chain_dp = keep
    return nat, py


@pytest.mark.parametrize("i", range(10))
def test_native_matches_python_sparse(lib, monkeypatch, mesh8, i):
    dims, dens = _sparse_chains()[i]
    ops = _ops(dims, dens)
    _, cost = t_chain.optimal_order(ops)
    _, pcost = _python_dp(ops, (1, 1), monkeypatch)
    # same optimum within the nnz-int rounding of the density estimates
    assert cost == pytest.approx(pcost, rel=0.05)
    # and each DP equal to the JAX package's
    assert (cost, pcost) == _jax_costs(dims, dens, (1, 1), mesh8)


@pytest.mark.parametrize("i", range(10))
def test_native_comm_dp_matches_python(lib, monkeypatch, mesh8, i):
    dims, dens, grid = _comm_chains()[i]
    ops = _ops(dims, dens, grid)
    _, cost = t_chain.optimal_order(ops, grid=grid)
    _, pcost = _python_dp(ops, grid, monkeypatch)
    assert cost == pytest.approx(pcost, rel=0.05), (dims, dens, grid)
    assert (cost, pcost) == _jax_costs(dims, dens, grid, mesh8)


def test_native_matches_jax_native(lib):
    """The same C ABI as the JAX package's bridge: equal split tables
    and costs on the same chain, grid, layouts and weights."""
    from matrel_tpu.utils import native as j_native
    rng = np.random.default_rng(7)
    for _ in range(6):
        n = int(rng.integers(3, 9))
        dims = [int(x) for x in rng.integers(2, 900, n + 1)]
        dens = [float(x) for x in rng.choice([1.0, 0.5, 0.05], n)]
        grid = [(1, 1), (2, 4), (4, 2)][int(rng.integers(3))]
        lays = [int(x) for x in rng.integers(0, 5, n)]
        w = [None, (1.0, 1.0), (1.0, 3.0)][int(rng.integers(3))]
        got = native.chain_dp(dims, dens, grid=grid, layouts=lays,
                              weights=w)
        want = j_native.chain_dp(dims, dens, grid=grid, layouts=lays,
                                 weights=w)
        assert want is not None
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1] == want[1]


def test_native_raw_api(lib):
    splits, cost = native.chain_dp([10, 1000, 10, 1000], [1.0, 1.0, 1.0])
    assert splits[0][2] == 1
    assert cost == pytest.approx(2 * (10 * 1000 * 10 + 10 * 10 * 1000))
    with pytest.raises(ValueError):
        native.chain_dp([1, 2], [1.0, 1.0])


def test_native_rebuilds_when_stale_and_degrades_without_compiler(
        tmp_path, monkeypatch):
    src = tmp_path / "chain_dp.cc"
    src.write_text(open(native.SOURCE).read())
    monkeypatch.setattr(native, "SOURCE", str(src))
    monkeypatch.setattr(native, "LIB_PATH", str(tmp_path / "lib.so"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert _lib_stale()
    assert native.load() is not None and not _lib_stale()
    os.utime(src, (os.path.getmtime(native.LIB_PATH) + 10,) * 2)
    assert _lib_stale()
    # no compiler: load() gives None once no library exists, and the
    # chain order falls back to the Python DP
    os.remove(native.LIB_PATH)

    def no_gxx(*a, **k):
        raise FileNotFoundError("g++")

    monkeypatch.setattr(native.subprocess, "run", no_gxx)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    assert native.load() is None
    assert native.chain_dp([10, 20, 30, 40], [1.0] * 3) is None
    _, cost = t_chain.optimal_order(_ops([10, 20, 30, 40]))
    assert cost == pytest.approx(2 * (10 * 20 * 30 + 10 * 30 * 40))


# -- local_dot on bf16 -------------------------------------------------------


def test_local_dot_bf16_on_the_cpu_widens():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((33, 70)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((70, 9)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    got = strategies.local_dot(a, b)
    assert got.dtype == torch.float32
    assert torch.equal(got, torch.matmul(a.float(), b.float()))


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself on the card, so local_dot takes
    its CUDA branch (whose GEMMs the test replaces by CPU products)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("k,partial_bytes,want_groups", [
    (100, 256 << 20, 0),          # one GEMM
    (2 * strategies.TC_CHUNK - 1, 256 << 20, 0),
    (3 * strategies.TC_CHUNK + 5, 256 << 20, 1),
    (5 * strategies.TC_CHUNK, 2 * 4 * 6 * 4, 3),   # groups of two chunks
])
def test_local_dot_bf16_on_the_card_runs_tensor_core_chunks(
        monkeypatch, k, partial_bytes, want_groups):
    calls = []
    mm, bmm = torch.mm, torch.bmm

    def fake_mm(a, b, out_dtype=None, **kw):
        calls.append(("mm", tuple(a.shape), out_dtype))
        return mm(a.float(), b.float())

    def fake_bmm(a, b, out_dtype=None, **kw):
        calls.append(("bmm", tuple(a.shape), out_dtype))
        return bmm(a.float(), b.float())

    monkeypatch.setattr(torch, "mm", fake_mm)
    monkeypatch.setattr(torch, "bmm", fake_bmm)
    monkeypatch.setattr(strategies, "TC_PARTIAL_BYTES", partial_bytes)
    rng = np.random.default_rng(k)
    a = torch.from_numpy(rng.standard_normal((6, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, 4)).astype(np.float32))
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    # the left operand as a transposed view, as the Gram passes give it
    at = a.T.contiguous().T.as_subclass(_OnCard)
    got = strategies.local_dot(at, b.as_subclass(_OnCard))
    assert got.dtype == torch.float32 and tuple(got.shape) == (6, 4)
    assert all(c[2] == torch.float32 for c in calls)
    assert sum(c[0] == "bmm" for c in calls) == want_groups
    if want_groups:
        chunks = k // strategies.TC_CHUNK
        assert sum(c[1][0] for c in calls if c[0] == "bmm") == chunks
        assert all(c[1][1:] == (6, strategies.TC_CHUNK)
                   for c in calls if c[0] == "bmm")
    want = torch.matmul(a.double(), b.double())
    torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-4)


def test_local_dot_f32_and_mixed_stay_widened(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("no tensor-core path for these dtypes")

    monkeypatch.setattr(strategies, "_tensor_core_dot", refuse)
    a = torch.ones((3, 4)).as_subclass(_OnCard)
    b = torch.ones((4, 2), dtype=torch.bfloat16).as_subclass(_OnCard)
    assert strategies.local_dot(a, b).dtype == torch.float32
    assert strategies.local_dot(a, a.T).dtype == torch.float32


# -- fusion and reshard on the corpus: decision records -----------------------

PLANE_CONFIGS = {
    "fusion": {"fusion_enable": True},
    "reshard_tight": {"reshard_peak_budget_bytes": 4096},
    "reshard_loose": {"reshard_peak_budget_bytes": 1 << 30},
    "both": {"fusion_enable": True, "reshard_peak_budget_bytes": 4096},
}


def _stamps_by_position(root):
    order, seen = [], set()

    def walk(n):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            walk(c)
        order.append(n)

    walk(root)
    pos = {n.uid: i for i, n in enumerate(order)}
    return [(pos[n.uid], n.attrs["fused_region"],
             sorted(pos[u] for u in n.attrs["fused_members"]),
             None if n.attrs["fused_anchor"] is None
             else pos[n.attrs["fused_anchor"]],
             n.attrs["fused_census"], n.attrs["fused_tier"],
             n.attrs["fused_remask"], n.attrs["fused_saved_dispatches"],
             n.attrs["fused_saved_hbm_bytes"])
            for n in order if "fused_region" in n.attrs]


@pytest.mark.parametrize("cfg_name", PLANE_CONFIGS)
@pytest.mark.parametrize("name", COVERED)
def test_plane_decisions_match_jax(corpus, mesh8, name, cfg_name):
    """With fusion on and/or a reshard budget, compile_expr's stamps and
    decision records on the (2, 4) grid equal the JAX package's."""
    cfg = PLANE_CONFIGS[cfg_name]
    tmesh = make_mesh((2, 4), device="cpu")
    je = corpus[name]
    jplan = j_exec.compile_expr(je, mesh8, JConfig(**cfg))
    tplan = t_exec.compile_expr(to_port(je, tmesh), tmesh,
                                MatrelConfig(**cfg))
    _assert_records_equal(t_exec.plan_matmul_decisions(tplan),
                          j_exec.plan_matmul_decisions(jplan))
    assert _stamps_by_position(tplan.optimized) \
        == _stamps_by_position(jplan.optimized)
    assert tplan.meta.get("fusion") == jplan.meta.get("fusion")


# -- the core surface's leftovers ---------------------------------------------


def test_config_from_env_dict_and_default(monkeypatch):
    from matrel_tpu_torch import config as t_config
    monkeypatch.setenv("MATREL_BLOCK_SIZE", "128")
    monkeypatch.setenv("MATREL_MESH_SHAPE", "2x4")
    monkeypatch.setenv("MATREL_AXIS_COST_WEIGHTS", "1,4")
    monkeypatch.setenv("MATREL_FUSION_ENABLE", "yes")
    monkeypatch.setenv("MATREL_MATMUL_PRECISION", "high")
    got = MatrelConfig.from_env()
    want = JConfig.from_env()
    for f in ("block_size", "mesh_shape", "axis_cost_weights",
              "fusion_enable", "matmul_precision"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.mesh_shape == (2, 4) and got.fusion_enable is True
    base = MatrelConfig(block_size=64)
    assert MatrelConfig.from_env(base).block_size == 128
    d = {"block_size": 32, "reshard_peak_budget_bytes": 1 << 20,
         "spgemm_kernel_override": "pallas_band"}
    got = MatrelConfig.from_dict(d)
    want = JConfig.from_dict(d)
    assert all(getattr(got, k) == getattr(want, k) for k in d)
    with pytest.raises(KeyError, match="not_a_knob"):
        MatrelConfig.from_dict({"not_a_knob": 1})
    with pytest.raises(ValueError):
        MatrelConfig.from_dict({"reshard_peak_budget_bytes": -1})
    # every knob once fenced is read by both constructors as the JAX
    # package reads it, and refused where the JAX package refuses it
    for name in ONCE_FENCED:
        default = getattr(MatrelConfig(), name)
        other = ((not default) if isinstance(default, bool)
                 else default + 1)
        got, want = MatrelConfig.from_dict({name: other}), JConfig.from_dict(
            {name: other})
        assert getattr(got, name) == getattr(want, name) == other
    for name, bad in (("fleet_slices", -1), ("fleet_directory_max", 0)):
        with pytest.raises(ValueError, match=name):
            MatrelConfig.from_dict({name: bad})
        with pytest.raises(ValueError, match=name):
            JConfig.from_dict({name: bad})
    # the ported planes' knobs read from the environment
    monkeypatch.setenv("MATREL_CSE_ENABLE", "1")
    assert MatrelConfig.from_env().cse_enable is True
    monkeypatch.setenv("MATREL_OBS_LEVEL", "on")
    assert MatrelConfig.from_env().obs_level == "on"
    monkeypatch.setenv("MATREL_VERIFY_PLANS", "warn")
    assert MatrelConfig.from_env().verify_plans == "warn"
    monkeypatch.setenv("MATREL_FLEET_SLICES", "2")
    monkeypatch.setenv("MATREL_FLEET_FAILOVER", "0")
    got, want = MatrelConfig.from_env(), JConfig.from_env()
    assert (got.fleet_slices, got.fleet_failover) == (
        want.fleet_slices, want.fleet_failover) == (2, False)
    monkeypatch.setenv("MATREL_FLEET_SPAN_MARGIN", "0")
    with pytest.raises(ValueError, match="fleet_span_margin"):
        MatrelConfig.from_env()
    old = t_config.default_config()
    try:
        new = MatrelConfig(block_size=16)
        t_config.set_default_config(new)
        assert t_config.default_config() is new
    finally:
        t_config.set_default_config(old)
    assert t_config.default_config() is old


#: The observability and resilience planes' knobs (and the learned
#: planner coefficients'), which left ``UNPORTED_KNOBS`` together.
OBS_RESILIENCE_KNOBS = (
    "obs_level", "obs_event_log", "obs_event_log_max_bytes",
    "obs_metrics_port", "obs_flight_recorder", "obs_flight_recorder_path",
    "obs_provenance", "slo_targets", "slo_fast_window_s",
    "slo_slow_window_s", "slo_burn_threshold", "slo_burn_exit",
    "drift_table_path", "lockdep_enable", "lockdep_raise", "fault_inject",
    "fault_inject_seed", "brownout_enable", "brownout_window",
    "brownout_dwell", "brownout_wait_high_ms", "brownout_wait_low_ms",
    "brownout_depth_high", "brownout_depth_low", "brownout_miss_high",
    "brownout_miss_low", "breaker_threshold", "breaker_cooldown_ms",
    "breaker_half_open_probes", "coeff_planner_enable",
    "coeff_min_samples")

#: The verifier's, the re-plan controller's and the durable spill
#: hierarchy's knobs, which left ``UNPORTED_KNOBS`` together.
DURABLE_VERIFIER_KNOBS = (
    "verify_plans", "coeff_replan_enable", "coeff_replan_interval",
    "coeff_replan_cooldown", "spill_enable", "spill_host_max_bytes",
    "spill_disk_hits", "state_dir")

#: The last fenced knobs: the fleet's six and the three execution knobs
#: that took their torch meaning (``config.py``'s docstring).
ONCE_FENCED = (
    "pallas_interpret", "donate_intermediates", "plan_cache_max_bytes",
    "fleet_slices", "fleet_span_margin", "fleet_directory_max",
    "fleet_replicate_hits", "fleet_failover",
    "fleet_placement_calibration")


def test_unported_knobs_left_exactly_two():
    """The knob fence is gone: fusion_enable and
    reshard_peak_budget_bytes left it with the fusion slice, the serve
    plane's knobs with the serving slice, the observability and
    resilience planes' 31 with theirs, the verifier's, re-planner's and
    spill hierarchy's 8 with the durable slice, and the last 9 (the
    fleet's and the three execution knobs) with the fleet slice. Every
    one of them is accepted away from its default."""
    from matrel_tpu_torch import config as t_config
    assert not hasattr(t_config, "UNPORTED_KNOBS")
    assert len(OBS_RESILIENCE_KNOBS) == 31
    assert len(DURABLE_VERIFIER_KNOBS) == 8
    assert len(ONCE_FENCED) == 9
    MatrelConfig(pallas_interpret=True, donate_intermediates=False,
                 plan_cache_max_bytes=0, fleet_slices=2,
                 fleet_span_margin=0.5, fleet_directory_max=8,
                 fleet_replicate_hits=0, fleet_failover=False,
                 fleet_placement_calibration=False)
    MatrelConfig(fusion_enable=True, reshard_peak_budget_bytes=1 << 20,
                 cse_enable=True, delta_patch_mode="force",
                 obs_level="on", fault_inject="execute:transient:n=1",
                 brownout_enable=True, breaker_threshold=2,
                 coeff_planner_enable=True, verify_plans="error",
                 coeff_replan_enable=True, coeff_replan_interval=4,
                 coeff_replan_cooldown=0, result_cache_max_bytes=1 << 20,
                 spill_enable=True, spill_host_max_bytes=1 << 20,
                 spill_disk_hits=0, state_dir="unused")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_blockmatrix_constructors_match_jax(grid_meshes, dtype):
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix as TBM
    from matrel_tpu_torch.core.mesh import P
    jm, tm = grid_meshes
    for shape in ((13, 7), (16, 16), (1, 9)):
        jz, tz = JBM.zeros(shape, mesh=jm, dtype=dtype), TBM.zeros(
            shape, mesh=tm, dtype=dtype)
        assert tz.padded_shape == jz.padded_shape and tz.nnz == jz.nnz == 0
        assert tz.to_numpy().shape == shape and not tz.to_numpy().any()
        assert tuple(tz.spec) == tuple(jz.spec)
        assert tz.is_padded == jz.is_padded
        assert tz.sparsity == jz.sparsity
        np.testing.assert_array_equal(np.asarray(tz.valid_mask()),
                                      np.asarray(jz.valid_mask()))
        fn = lambda r, c: (r * 3 + c) % 7
        jf = JBM.from_block_fn(shape, fn, mesh=jm, dtype=dtype, nnz=5)
        tf = TBM.from_block_fn(shape, fn, mesh=tm, dtype=dtype, nnz=5)
        np.testing.assert_array_equal(tf.to_numpy(),
                                      np.asarray(jf.to_numpy(), np.float32))
        assert tf.padded_shape == jf.padded_shape and tf.nnz == 5
        assert float(tf.data.float().abs().sum()) == float(
            np.abs(np.asarray(jf.data, np.float32)).sum())   # zero padding
        assert tf.sparsity == jf.sparsity
    for n in (1, 8, 13):
        je, te = JBM.eye(n, mesh=jm, dtype=dtype), TBM.eye(n, mesh=tm,
                                                          dtype=dtype)
        np.testing.assert_array_equal(te.to_numpy(),
                                      np.asarray(je.to_numpy(), np.float32))
        assert te.nnz == je.nnz == n and te.padded_shape == je.padded_shape
        assert float(te.data.float().sum()) == n
    x = TBM.eye(8, mesh=tm)
    assert x.block_until_ready() is x
    assert x.with_spec(x.spec) is x
    y = x.with_spec(P(("x", "y"), None))
    assert y.spec == P(("x", "y"), None) and y.data is x.data
    assert t_planner.infer_layout(y.expr(), tm) == "row"


def test_blockmatrix_shortcuts_match_jax(jmesh):
    js, ts = sessions(jmesh)
    rng = np.random.default_rng(21)
    a = rng.standard_normal((12, 12)).astype(np.float32) + 12 * np.eye(
        12, dtype=np.float32)
    b = rng.standard_normal((12, 3)).astype(np.float32)
    u = rng.standard_normal((12, 1)).astype(np.float32)
    v = rng.standard_normal((12, 1)).astype(np.float32)
    (jA, tA), (jB, tB), (jU, tU), (jV, tV) = (pair(js, ts, x)
                                              for x in (a, b, u, v))
    cases = [(jA.norm(), tA.norm()), (jA.norm("max"), tA.norm("max")),
             (jA.inverse(), tA.inverse()), (jA.solve(jB), tA.solve(tB)),
             (jA.vec(), tA.vec()),
             (jA.rank_one_update(jU, jV), tA.rank_one_update(tU, tV))]
    for je, te in cases:
        assert te.kind == je.kind and te.shape == je.shape
        np.testing.assert_allclose(ts.compute(te).to_numpy(),
                                   js.compute(je).to_numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_session_zeros_eye_and_identity_product(jmesh):
    js, ts = sessions(jmesh)
    z, jz = ts.zeros((5, 3)), js.zeros((5, 3))
    np.testing.assert_array_equal(z.to_numpy(), np.asarray(jz.to_numpy()))
    assert z.mesh is ts.mesh
    eye = ts.eye(6)
    np.testing.assert_array_equal(eye.to_numpy(), np.eye(6, dtype=np.float32))
    a = np.random.default_rng(2).standard_normal((6, 4)).astype(np.float32)
    A = ts.from_numpy(a)
    np.testing.assert_array_equal(ts.compute(eye.multiply(A)).to_numpy(), a)


def test_block_sparse_from_scipy_and_norm(jmesh):
    import scipy.sparse as sps
    tmesh = make_mesh(device="cpu")
    m = sps.random(70, 45, density=0.05, format="csr", random_state=3,
                   dtype=np.float32)
    J = JBlockSparse.from_scipy(m, block_size=16, mesh=jmesh)
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix as TBS
    Tm = TBS.from_scipy(m, block_size=16, mesh=tmesh)
    np.testing.assert_array_equal(Tm.host_tiles()[0],
                                  np.asarray(J.block_rows))
    np.testing.assert_array_equal(Tm.host_tiles()[1],
                                  np.asarray(J.block_cols))
    np.testing.assert_array_equal(Tm.blocks.numpy(), np.asarray(J.blocks))
    np.testing.assert_allclose(Tm.to_numpy(), m.toarray(), rtol=0, atol=0)
    for kind in ("fro", "l1", "max"):
        assert Tm.norm(kind) == pytest.approx(J.norm(kind), rel=1e-12)
    with pytest.raises(ValueError):
        Tm.norm("spectral")
    empty = TBS.from_numpy(np.zeros((16, 16), np.float32), block_size=8,
                           mesh=tmesh)
    assert empty.norm("max") == JBlockSparse.from_numpy(
        np.zeros((16, 16), np.float32), block_size=8,
        mesh=jmesh).norm("max")


def test_choose_strategy_and_tier_error_bound_match_jax(corpus, mesh8):
    tmesh = make_mesh((2, 4), device="cpu")
    for name in ("chain_skewed", "gram_AtA", "replicated_operand_matmul"):
        je = corpus[name]
        jopt = j_rules.optimize(je, JConfig(), grid=(2, 4), mesh=mesh8)
        topt = t_rules.optimize(to_port(je, tmesh), MatrelConfig(),
                                grid=(2, 4), mesh=tmesh)
        jm = [n for n in _walk_nodes(jopt) if n.kind == "matmul"]
        tm = [n for n in _walk_nodes(topt) if n.kind == "matmul"]
        assert len(jm) == len(tm) > 0
        for j, t in zip(jm, tm):
            assert t_planner.choose_strategy(t, tmesh) \
                == j_planner.choose_strategy(j, mesh8)
    for tier in t_planner.TIER_EPS:
        for k, amax, bmax in ((1, 1.0, 1.0), (4096, 2.5, 0.5)):
            assert t_planner.tier_error_bound(tier, k, amax, bmax) \
                == j_planner.tier_error_bound(tier, k, amax, bmax)


def _walk_nodes(e):
    out, seen = [], set()

    def walk(n):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            walk(c)
        out.append(n)

    walk(e)
    return out


def test_compile_chain_matches_jax(jmesh):
    from matrel_tpu.workloads import chain_bench as j_chain_bench
    js, ts = sessions(jmesh)
    rng = np.random.default_rng(4)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((300, 20), (20, 300), (300, 20))]
    jm = [js.from_numpy(a) for a in arrs]
    tm = [ts.from_numpy(a) for a in arrs]
    jplan, jparen, jcost = j_chain_bench.compile_chain(jm)
    tplan, tparen, tcost = t_chain_bench.compile_chain(tm)
    assert tparen == jparen == "(A·(B·C))"
    assert tcost == pytest.approx(jcost, rel=1e-12)
    np.testing.assert_allclose(tplan.run().to_numpy(),
                               jplan.run().to_numpy(), rtol=1e-4, atol=1e-3)


# -- the three execution knobs with a torch meaning ----------------------------


def _knob_query(s, S, a, b):
    A, B = s.from_numpy(a), s.from_numpy(b)
    return S.expr().multiply(A.expr()).add(A.expr().multiply(B.expr()))


def _knob_run(s, S, a, b):
    e = _knob_query(s, S, a, b)
    plan = s.compile(e)
    stamps = [(n.kind, n.attrs.get("strategy"), n.attrs.get("precision"))
              for n in _post_order(plan.optimized)]
    return s.compute(e).to_numpy(), stamps, s.plan_cache_info()["plans"]


def _post_order(root):
    out, seen = [], set()

    def walk(n):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            walk(c)
        out.append(n)

    walk(root)
    return out


@pytest.mark.parametrize("knob,value", [
    ("pallas_interpret", True),
    ("donate_intermediates", False),
    ("plan_cache_max_bytes", 0),
    ("plan_cache_max_bytes", 1),
])
def test_execution_knobs_take_their_torch_meaning(jmesh, knob, value):
    """``pallas_interpret`` (the CPU route already runs each kernel's
    plain version), ``donate_intermediates`` (nothing to donate in
    torch) and ``plan_cache_max_bytes`` (a port plan pins no hoisted
    payloads) change no plan and no value: the port with the knob set
    equals the port at its default, and the JAX package with the same
    knob, stamp for stamp and within the JAX tests' tolerance — the
    block-sparse S·D term runs B1's path (its plain version here)."""
    rng = np.random.default_rng(5)
    sp = np.zeros((64, 64), np.float32)
    sp[:32, 32:] = rng.standard_normal((32, 32))
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    js, ts = sessions(jmesh, **{knob: value})
    base = MatrelSession(config=MatrelConfig(), device="cpu")
    JS = JBlockSparse.from_numpy(sp, block_size=16, mesh=jmesh)
    got, gstamps, gplans = _knob_run(ts, convert.from_reference(JS, ts.mesh),
                                     a, b)
    ref, rstamps, _ = _knob_run(base, convert.from_reference(
        JS, base.mesh), a, b)
    je = _knob_query(js, JS, a, b)
    jplan = js.compile(je)
    want = np.asarray(js.compute(je).to_numpy())
    np.testing.assert_array_equal(got, ref)
    assert gstamps == rstamps == [
        (n.kind, n.attrs.get("strategy"), n.attrs.get("precision"))
        for n in _post_order(jplan.optimized)]
    np.testing.assert_allclose(got, want, rtol=3e-4, atol=3e-4)
    np.testing.assert_allclose(got, sp @ a + a @ b, rtol=3e-4, atol=3e-4)
    # the byte bound counts zero bytes: the plan stays cached
    assert gplans == 1


def test_spmv_is_spmm():
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.ops import spmm as t_spmm
    tm = make_mesh(device="cpu")
    rng = np.random.default_rng(2)
    sp = np.kron(np.eye(2), rng.standard_normal((8, 8))).astype(np.float32)
    S = BlockSparseMatrix.from_numpy(sp, block_size=8, mesh=tm)
    v = rng.standard_normal((16, 1)).astype(np.float32)
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    V = BlockMatrix.from_numpy(v, mesh=tm)
    got = t_spmm.spmv(S, V).to_numpy()
    np.testing.assert_array_equal(got, t_spmm.spmm(S, V).to_numpy())
    np.testing.assert_allclose(got, sp @ v, rtol=1e-5, atol=1e-5)
