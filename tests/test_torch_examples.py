"""PyTorch port: the eight worked examples of ``matrel_tpu_torch/examples/``
held against the JAX package on the CPU.

Each example's ``run("cpu")`` returns the numbers it prints; the same
seeded inputs go through the JAX package's own functions in this process
(``COOMatrix`` and ``pagerank_edges``, ``linreg.fit``, the optimizer's
plans, the relational ops and SQL, ``triangle_count``, the planner's
strategy and association stamps on the (2, 4) mesh of the conftest's 8
CPU devices, the autotune table's keys) and the answers are compared:
integer counts exactly, f32 sums at rel 1e-4 (the SpMV / PageRank tests'
tolerance), products at 1e-3 of their scale (``test_torch_linreg.py``).
Every example runs at the JAX demo's own sizes (each under 10 s here).
``distributed_sparse_demo`` runs on 4 gloo CPU ranks under its join
timeout. Each example also runs as ``python -m
matrel_tpu_torch.examples.<name> --device cpu`` (rc 0, the JAX demo's
last line's words), and asks for the card without ``--device``.
"""

import importlib
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from matrel_tpu_torch import DeviceUnavailableError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAMES = ("graph_demo", "linreg_demo", "chain_optimizer_demo",
         "relational_sql_demo", "analytics_demo",
         "layout_aware_planning_demo", "autotune_demo",
         "distributed_sparse_demo")


def _ex(name):
    return importlib.import_module(f"matrel_tpu_torch.examples.{name}")


def _run(name, **kw):
    lines = []
    out = _ex(name).run("cpu", emit=lines.append, **kw)
    return out, lines


@pytest.fixture(autouse=True)
def _torch_threads():
    prior = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prior)


def test_graph_demo_matches_jax():
    from matrel_tpu.core.coo import COOMatrix as JCOO
    from matrel_tpu.workloads.pagerank import pagerank_edges as jpr
    got, lines = _run("graph_demo")
    ex = _ex("graph_demo")
    n, m = ex.N_NODES, ex.N_EDGES
    rng = np.random.default_rng(0)
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    A = JCOO.from_edges(src, dst, shape=(n, n))
    ones = np.ones(n, np.float32)
    np.testing.assert_array_equal(got["deg_out"],
                                  np.asarray(A.matvec(ones)))
    np.testing.assert_array_equal(got["deg_in"],
                                  np.asarray(A.rmatvec(ones)))
    seed = np.zeros(n, np.float32)
    seed[:10] = 1.0
    np.testing.assert_array_equal(
        got["two_hop"], np.asarray(A.rmatvec(A.rmatvec(seed))))
    assert got["padding_ratio"] == pytest.approx(
        A._get_plan().padding_ratio, rel=0.02)
    ranks = np.asarray(jpr(src, dst, n, rounds=ex.ROUNDS))
    np.testing.assert_allclose(got["ranks"], ranks, rtol=1e-4, atol=1e-9)
    assert got["top5"] == [int(i) for i in np.argsort(ranks)[::-1][:5]]
    assert abs(got["rank_mass"] - 1.0) < 1e-3
    assert lines[0].startswith("adjacency: (50000, 50000), nnz=400000")


def test_linreg_demo_matches_jax():
    from matrel_tpu.session import MatrelSession as JSession
    from matrel_tpu.workloads import linreg as jlinreg
    got, lines = _run("linreg_demo")
    ex = _ex("linreg_demo")
    rng = np.random.default_rng(0)
    n, k = ex.N_ROWS, ex.N_FEATURES
    x = rng.standard_normal((n, k)).astype(np.float32)
    theta_true = rng.standard_normal((k, 1)).astype(np.float32)
    y = x @ theta_true + 0.01 * rng.standard_normal((n, 1)).astype(
        np.float32)
    sess = JSession.builder().get_or_create()
    X, Y = sess.from_numpy(x), sess.from_numpy(y)
    theta = np.asarray(jlinreg.fit(X, Y))
    np.testing.assert_array_equal(got["theta_true"], theta_true)
    np.testing.assert_allclose(got["theta"], theta, rtol=1e-3, atol=1e-4)
    j_err = float(np.linalg.norm(theta - theta_true)
                  / np.linalg.norm(theta_true))
    assert got["rel_err"] == pytest.approx(j_err, rel=0.05, abs=2e-6)
    # the logical and optimized plans print the same nodes
    j_lines = [ln for ln in X.t().multiply(X).explain().splitlines()
               if ln.strip()]
    assert [ln for ln in got["explain"].splitlines() if ln.strip()] \
        == j_lines
    assert got["strategies"] == ["xla[default]"]
    assert lines[-1].startswith("relative parameter error: ")


def test_chain_optimizer_demo_matches_jax():
    from matrel_tpu.executor import compile_expr as jcompile
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.session import MatrelSession as JSession
    got, lines = _run("chain_optimizer_demo", runs=2)
    ex = _ex("chain_optimizer_demo")
    rng = np.random.default_rng(0)
    mats = [rng.standard_normal(d).astype(np.float32) / 64
            for d in ex.DIMS]
    sess = JSession.builder().get_or_create()
    A, B, C = (sess.from_numpy(a) for a in mats)
    expr = A.expr().multiply(B.expr()).multiply(C.expr())
    opt = sess.compile(expr)
    raw = jcompile(expr, sess.mesh, JConfig(chain_opt=False,
                                            rewrite_rules=False))
    # the JAX plans' association: the DP right-associates, raw does not
    assert opt.optimized.children[1].kind == "matmul"
    assert raw.optimized.children[0].kind == "matmul"
    left, right = ex.flops_of(ex.DIMS)
    assert (got["raw_flops"], got["opt_flops"]) == (left, right)
    assert got["flop_ratio"] == left / right == 64
    want = np.asarray(opt.run().to_numpy(), np.float64).sum()
    assert got["opt_checksum"] == pytest.approx(want, rel=1e-3, abs=1e-3)
    assert got["raw_checksum"] == pytest.approx(want, rel=1e-3, abs=1e-3)
    assert "== Analyzed physical plan" in got["explain"]
    assert "chain DP cut planned FLOPs 64x" in lines[-1]


def test_relational_sql_demo_matches_jax():
    from matrel_tpu.relational import ops as JR
    from matrel_tpu.session import MatrelSession as JSession
    got, lines = _run("relational_sql_demo")
    rng = np.random.default_rng(1)
    a = rng.standard_normal((64, 64)).astype(np.float32)
    b = rng.standard_normal((64, 64)).astype(np.float32)
    sess = JSession.builder().get_or_create()
    A, B = sess.from_numpy(a), sess.from_numpy(b)
    sess.register("A", A)
    sess.register("B", B)
    pos = JR.select_entries(JR.join_on_index(A, B, lambda x, y: x * y),
                            lambda v: v > 0)
    counts = JR.aggregate(pos, "count", "row").compute(sess).to_numpy()
    np.testing.assert_array_equal(got["counts"], counts)
    np.testing.assert_array_equal(got["top_rows"],
                                  np.argsort(-counts.ravel())[:5])
    mass = sess.compute(sess.sql(
        "SELECT rowsum(select(elemmult(A, B), 'v > 0'))")).to_numpy()
    np.testing.assert_allclose(got["pos_mass"], mass.ravel(), rtol=1e-5,
                               atol=1e-5)
    j = JR.join_on_values(A, B, merge="mul", predicate="lt")
    per_entry = JR.aggregate(j, "sum", "row").compute(sess).to_numpy()
    np.testing.assert_allclose(got["per_entry"], per_entry, rtol=1e-4,
                               atol=1e-3)
    assert got["sql_agrees"] is True
    w = sess.compute(sess.sql("SELECT A .* B FROM A, B WHERE v > 1"))
    assert got["where_nonzeros"] == int((w.to_numpy() != 0).sum()) == 419
    # the pushdown: rowSum(A·B) plans as A·rowSum(B) in both packages
    j_lines = [ln for ln in A.multiply(B).row_sum().explain().splitlines()
               if ln.strip()]
    assert [ln for ln in got["explain"].splitlines() if ln.strip()] \
        == j_lines
    assert lines[-2:] == ["SQL agrees: True", "elemmul + WHERE nonzeros: 419"]


def test_analytics_demo_matches_jax():
    from matrel_tpu.relational import ops as JR
    from matrel_tpu.session import MatrelSession as JSession
    from matrel_tpu.workloads import similarity as jsim, triangles as jtri
    got, lines = _run("analytics_demo")
    ex = _ex("analytics_demo")
    rng = np.random.default_rng(0)
    sess = JSession.builder().config(
        matmul_precision="high").get_or_create()
    a = (rng.random((ex.TRI_N, ex.TRI_N)) < ex.TRI_P).astype(np.float32)
    a = np.triu(a, 1)
    a = a + a.T
    A = sess.from_numpy(a)
    tri = jtri.triangle_count(A)
    sess.register("A", A)
    tri_sql = sess.compute(sess.sql("trace(A * A * A)")).to_numpy()[0, 0]
    assert got["triangles"] == tri == got["triangles_oracle"] == 344
    assert got["triangles_sql"] == tri_sql / 6
    x = rng.standard_normal(ex.SIM_SHAPE).astype(np.float32)
    S = jsim.cosine_similarity_expr(sess.from_numpy(x))
    cnt = sess.compute(JR.aggregate(JR.select_entries(
        S, lambda v: v > ex.SIM_THRESHOLD), "count", "all")).to_numpy()
    assert got["pairs"] == float(cnt[0, 0]) == got["pairs_oracle"] == 512
    assert lines[-1].startswith("pairs with cos > 0.8: 512 (oracle 512")


def test_layout_demo_stamps_match_jax(mesh8):
    from jax.sharding import PartitionSpec as JP
    from matrel_tpu import executor as jexec
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    from matrel_tpu.ir.expr import leaf, matmul
    from matrel_tpu.parallel import planner as jplanner
    got, _ = _run("layout_aware_planning_demo")
    mesh = mesh8
    rng = np.random.default_rng(0)
    x, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((1600, 512), (512, 512), (512, 512)))
    e = (JBM.from_numpy(x, mesh=mesh, spec=JP(tuple(mesh.axis_names), None))
         .expr().multiply(JBM.from_numpy(b, mesh=mesh).expr())
         .multiply(JBM.from_numpy(c, mesh=mesh).expr()))
    plan = jexec.compile_expr(e, mesh)
    # the plan sections agree; the Collectives sections differ by
    # design: the port's virtual grid runs on one device and issues none,
    # the JAX plan's HLO on eight CPU devices has them
    mine, cols = got["explain"].split("\n== Collectives ==\n")
    assert mine == plan.explain().split("\n== Collectives")[0]
    assert cols == "{}"
    ca, cb, cc = (rng.standard_normal(s).astype(np.float32)
                  for s in ((16, 512), (512, 512), (512, 16)))

    def assoc(spec):
        pl = jexec.compile_expr(
            JBM.from_numpy(ca, mesh=mesh).expr()
            .multiply(JBM.from_numpy(cb, mesh=mesh, spec=spec).expr())
            .multiply(JBM.from_numpy(cc, mesh=mesh).expr()), mesh)
        return ("(A*B)*C" if pl.optimized.children[0].kind == "matmul"
                else "A*(B*C)")

    assert got["canonical"] == assoc(None) == "A*(B*C)"
    assert got["col_sharded"] == assoc(
        JP(None, tuple(mesh.axis_names))) == "(A*B)*C"
    node = matmul(leaf(JBM.from_numpy(
        rng.standard_normal((1600, 512)).astype(np.float32), mesh=mesh)),
        leaf(JBM.from_numpy(rng.standard_normal((512, 512))
                            .astype(np.float32), mesh=mesh)))
    assert got["interior"] == jplanner.choose_strategy_ex(node, mesh)[0]
    assert got["root"] == jplanner.choose_strategy_ex(
        node, mesh, root_output=True)[0]
    assert (got["interior"], got["root"]) == ("bmm_right", "cpmm")


def test_autotune_demo_closes_the_loop_as_jax(tmp_path, mesh8):
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.parallel import autotune as jat
    from matrel_tpu.session import MatrelSession as JSession
    got, lines = _run("autotune_demo")
    assert got["first_measurements"] >= 2
    assert got["second_measurements"] == 0
    assert "[measured]" in got["second_line"] or "[model]" in \
        got["second_line"]
    assert lines[-1].endswith(
        f"{got['first_measurements']} in the first session, 0 in the "
        f"second")
    # the JAX loop on the same grid and shape writes the same key and
    # measures the same strategies
    path = str(tmp_path / "jax_table.json")
    jat._CACHE.clear()
    sess = JSession(mesh=mesh8, config=JConfig(autotune=True,
                                               autotune_table_path=path))
    rng = np.random.default_rng(0)
    a, b = (sess.from_numpy(rng.standard_normal((256, 256))
                            .astype(np.float32)) for _ in range(2))
    sess.explain(a.expr().multiply(b.expr()))
    j_table = jat.load_table(path)
    assert list(got["table"]) == list(j_table) == ["256|2x4|float32|cpu"]
    (t_entry,), (j_entry,) = got["table"].values(), j_table.values()
    assert set(t_entry["times"]) <= set(j_entry["times"])
    assert len(t_entry["times"]) >= 2


def test_distributed_sparse_demo_on_gloo_ranks():
    from matrel_tpu.core.sparse import BlockSparseMatrix as JBSM
    from matrel_tpu.ops import spmv as jspmv
    ex = _ex("distributed_sparse_demo")
    got, lines = _run("distributed_sparse_demo", nproc=4, timeout_s=120.0)
    assert got["ranks"] == 4
    for k, tol in (("spmm_err", ex.SPMM_TOL), ("b1_err", ex.SPMM_TOL),
                   ("spmv_err", ex.SPMV_TOL), ("b2_err", ex.SPMV_TOL)):
        assert got[k] <= tol, (k, got[k])
    a, d, src, dst, w, x = ex._data()
    S = JBSM.from_numpy(a, block_size=ex.SPMM_BS)
    assert got["nnzb"] == S.nnzb == 102
    plan = jspmv.build_spmv_plan(dst, src, w, ex.SPMV_NODES, ex.SPMV_NODES)
    # each rank holds ceil(blocks / ranks) block rows of the plan
    assert got["shard_rows"] == [math.ceil(plan.src8.shape[0] / 4)]
    assert got["launches"] == [{"spmm_blocksparse": 0,
                                "spmv_compact": 0}] * 4   # CPU: plain
    assert lines[0] == "mesh: {'x': 2, 'y': 2} over 4 ranks (gloo on cpu)"


@pytest.mark.parametrize("name", NAMES)
def test_example_cli_on_the_cpu(name):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    r = subprocess.run(
        [sys.executable, "-m", f"matrel_tpu_torch.examples.{name}",
         "--device", "cpu"], capture_output=True, text=True, timeout=240,
        env=env, cwd=REPO)
    assert r.returncode == 0, (name, r.stdout[-800:], r.stderr[-2000:])
    assert r.stdout.strip(), f"{name} printed nothing"


@pytest.mark.parametrize("name", NAMES)
def test_example_asks_for_the_card(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(DeviceUnavailableError):
        _ex(name).main([])
