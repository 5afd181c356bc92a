"""PyTorch port: the compiled plan's iteration path held against the JAX
package on the CPU — ``CompiledPlan.bound_runner`` (rebinding, the
zero-argument closure, an unknown uid, the ``donate`` chain, the wrong
arity, a tensor on another device), a block-sparse S·D plan (through
B1's plain version) and a COO matvec plan with x rebound (x ← A·x, the
PageRank pattern, through B2's plain version), the bench's overflow-
guarded bf16 chain step (C·B)·(2/N), and ``collectives()`` / explain's
Collectives section: ``{}`` on one device, and on a 2 × 2 world of gloo
CPU ranks the kinds of JAX's HLO on its 4-device CPU mesh.

Tolerances are tests/test_executor.py's (rtol = atol = 1e-4 for one
product, atol 1e-3 / 1e-2 for chains of two / three); the port's bound
runner is bit-equal to its own ``run`` (the same lowered function on the
same tensors). The bf16 chain is held against float64 numpy of the same
bf16 operands within BF16_CHAIN_RTOL of mean|C|.

The rank world runs in spawned processes that re-import this module, so
its top imports neither ``jax`` nor ``matrel_tpu``.
"""

import os
import pickle
import time
import traceback

import numpy as np
import pytest
import torch

from matrel_tpu_torch import MatrelConfig, MatrelSession
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.coo import COOMatrix
from matrel_tpu_torch.core.sparse import BlockSparseMatrix
from matrel_tpu_torch.executor import DeviceMismatchError, compile_expr
from matrel_tpu_torch.ops import csr_view, pallas_spmm

#: The bf16 chain: side, steps, and its bound against float64 numpy as
#: a share of the final mean|C| (each step rounds C to bf16: 2^-8
#: relative, and the steps' errors decay along the Perron direction).
BF16_N, BF16_STEPS, BF16_CHAIN_RTOL = 64, 8, 2e-2
#: The rank world's grid, its strategies and its product (the JAX
#: test's 64 × 64 under broadcast_threshold_bytes=1024).
GRID, RANK_N = (2, 2), 64
STRATS = ("bmm_left", "bmm_right", "cpmm", "rmm", "summa")
JOIN_TIMEOUT_S = 120.0


def _rng():
    return np.random.default_rng(42)


@pytest.fixture(scope="module")
def sess():
    return MatrelSession(device="cpu")


@pytest.fixture(scope="module")
def jmesh():
    import jax
    from matrel_tpu.core import mesh as jmesh_lib
    from test_torch_native_guard import ensure_reference_native
    # the JAX package's native library (its COO plan fill), whole and
    # loaded in this process
    ensure_reference_native()
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


def _jbm(a, mesh):
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    return JBM.from_numpy(np.asarray(a, np.float32), mesh=mesh)


def _jplan(expr, mesh):
    from matrel_tpu.executor import compile_expr as jcompile
    return jcompile(expr, mesh)


# -- TestBoundRunner (tests/test_executor.py) --------------------------------


def test_matches_run_and_rebinds(sess, jmesh):
    rng = _rng()
    a = rng.standard_normal((24, 24)).astype(np.float32)
    b = rng.standard_normal((24, 24)).astype(np.float32)
    A, B = sess.from_numpy(a), sess.from_numpy(b)
    plan = compile_expr(A.expr().multiply(B.expr()), sess.mesh)
    a_leaf = plan.leaf_order[0]
    step = plan.bound_runner(rebind_uids=(a_leaf.uid,))
    JA, JB = _jbm(a, jmesh), _jbm(b, jmesh)
    jplan = _jplan(JA.expr().multiply(JB.expr()), jmesh)
    jstep = jplan.bound_runner(rebind_uids=(jplan.leaf_order[0].uid,))
    cur, jcur = step(A.data), jstep(JA.data)
    np.testing.assert_allclose(cur.numpy()[:24, :24], a @ b, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(cur.numpy(), np.asarray(jcur), rtol=1e-4,
                               atol=1e-4)
    cur, jcur = step(cur), jstep(jcur)
    np.testing.assert_allclose(cur.numpy()[:24, :24], a @ b @ b,
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(cur.numpy(), np.asarray(jcur), rtol=1e-4,
                               atol=1e-3)
    # parity with the general run() path: the same function, bit-equal
    got = plan.run(bindings={a_leaf.uid: plan.run()}).data
    assert torch.equal(cur, got)
    assert isinstance(cur, torch.Tensor) and cur.shape == A.data.shape


def test_no_rebind_closure(sess, jmesh):
    a = _rng().standard_normal((16, 16)).astype(np.float32)
    A = sess.from_numpy(a)
    plan = compile_expr(A.expr().multiply(A.expr().t()), sess.mesh)
    fixed = plan.bound_runner()
    JA = _jbm(a, jmesh)
    want = np.asarray(_jplan(JA.expr().multiply(JA.expr().t()),
                             jmesh).bound_runner()())
    out = fixed().numpy()
    np.testing.assert_allclose(out[:16, :16], a @ a.T, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, want, rtol=1e-4, atol=1e-4)
    assert torch.equal(fixed(), plan.run().data)


def test_unknown_uid_raises(sess, jmesh):
    a = _rng().standard_normal((8, 8)).astype(np.float32)
    A = sess.from_numpy(a)
    plan = compile_expr(A.expr().multiply(A.expr()), sess.mesh)
    with pytest.raises(KeyError):
        plan.bound_runner(rebind_uids=(999999,))
    JA = _jbm(a, jmesh)
    with pytest.raises(KeyError):
        _jplan(JA.expr().multiply(JA.expr()), jmesh).bound_runner(
            rebind_uids=(999999,))


def test_donate_chain(sess, jmesh):
    rng = _rng()
    a = rng.standard_normal((16, 16)).astype(np.float32)
    b = rng.standard_normal((16, 16)).astype(np.float32)
    A, B = sess.from_numpy(a), sess.from_numpy(b)
    plan = compile_expr(A.expr().multiply(B.expr()), sess.mesh)
    leaf = plan.leaf_order[0]
    step = plan.bound_runner(rebind_uids=(leaf.uid,), donate=True)
    keep = plan.bound_runner(rebind_uids=(leaf.uid,))
    cur = step(A.data + 0)        # a fresh tensor (A.data stays live)
    cur = step(cur)
    cur = step(cur)
    np.testing.assert_allclose(cur.numpy()[:16, :16], a @ b @ b @ b,
                               rtol=1e-3, atol=1e-2)
    JA, JB = _jbm(a, jmesh), _jbm(b, jmesh)
    jplan = _jplan(JA.expr().multiply(JB.expr()), jmesh)
    jstep = jplan.bound_runner(rebind_uids=(jplan.leaf_order[0].uid,),
                               donate=True)
    jcur = jstep(jstep(jstep(JA.data + 0)))
    np.testing.assert_allclose(cur.numpy(), np.asarray(jcur), rtol=1e-3,
                               atol=1e-2)
    # donating changes no value: the kept chain is bit-equal
    assert torch.equal(cur, keep(keep(keep(A.data))))
    np.testing.assert_array_equal(A.data.numpy(), a)   # never written


def test_donated_inputs_go_at_return(sess):
    """The donate promise: once the caller drops a rebound tensor,
    nothing of a finished call holds it, so its block is free for the
    next output without waiting for Python's cycle collector."""
    import gc
    import weakref
    a = _rng().standard_normal((16, 16)).astype(np.float32)
    A = sess.from_numpy(a)
    plan = compile_expr(A.expr().multiply(A.expr()).multiply_scalar(0.5),
                        sess.mesh)
    step = plan.bound_runner(rebind_uids=(plan.leaf_order[0].uid,),
                             donate=True)
    cur, dropped = A.data.clone(), []
    gc.disable()
    try:
        for _ in range(4):
            dropped.append(weakref.ref(cur))
            cur = step(cur)
        assert [r() is None for r in dropped] == [True] * 4
    finally:
        gc.enable()


def test_wrong_arity_raises(sess):
    a = _rng().standard_normal((8, 8)).astype(np.float32)
    A, B = sess.from_numpy(a), sess.from_numpy(a)
    plan = compile_expr(A.expr().multiply(B.expr()), sess.mesh)
    step = plan.bound_runner(
        rebind_uids=tuple(l.uid for l in plan.leaf_order))
    with pytest.raises(ValueError, match="rebound"):
        step(A.data)


def test_wrong_device_raises(sess):
    """A rebound tensor on another device raises, in the runner and in
    run(): nothing is copied to the plan's device quietly."""
    a = _rng().standard_normal((8, 8)).astype(np.float32)
    A = sess.from_numpy(a)
    plan = compile_expr(A.expr().multiply(A.expr()), sess.mesh)
    step = plan.bound_runner(rebind_uids=(plan.leaf_order[0].uid,))
    elsewhere = A.data.to("meta")
    with pytest.raises(DeviceMismatchError, match="meta"):
        step(elsewhere)
    moved = BlockMatrix.from_array(elsewhere, A.shape, A.mesh, A.spec)
    with pytest.raises(DeviceMismatchError):
        plan.run(bindings={plan.leaf_order[0].uid: moved})


# -- the kernel paths through a bound runner ---------------------------------


def _counting(monkeypatch, module, name):
    calls = [0]
    inner = getattr(module, name)

    def counted(*a, **k):
        calls[0] += 1
        return inner(*a, **k)

    monkeypatch.setattr(module, name, counted)
    return calls


def _tiled(rng, n, bs):
    a = np.zeros((n, n), np.float32)
    for bi in range(n // bs):
        for bj in range(n // bs):
            if (bi + bj) % 3 != 1:
                a[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] = \
                    rng.standard_normal((bs, bs))
    return a


def test_block_sparse_payload_rides_along(sess, mesh8, monkeypatch):
    """tests/test_executor.py's hoisted-payload case: S·D through the
    closure and with D rebound (donated), B1's plain version each call,
    against numpy and the JAX package's bound runner on its mesh8."""
    from matrel_tpu.core.sparse import BlockSparseMatrix as JBS
    rng = _rng()
    n, bs = 256, 32
    a = _tiled(rng, n, bs)
    d = rng.standard_normal((n, 16)).astype(np.float32)
    d2 = rng.standard_normal((n, 16)).astype(np.float32)
    S = BlockSparseMatrix.from_numpy(a, block_size=bs, mesh=sess.mesh)
    plan = compile_expr(S.multiply(sess.from_numpy(d)), sess.mesh)
    calls = _counting(monkeypatch, pallas_spmm, "spmm_blocksparse_plain")
    out = plan.bound_runner()()
    np.testing.assert_allclose(out.numpy()[:n, :16], a @ d, rtol=1e-4,
                               atol=1e-4)
    leaf_uid = plan.leaf_order[0].uid
    step = plan.bound_runner(rebind_uids=(leaf_uid,), donate=True)
    out2 = step(torch.from_numpy(d2.copy()))
    np.testing.assert_allclose(out2.numpy()[:n, :16], a @ d2, rtol=1e-4,
                               atol=1e-4)
    assert calls[0] == 2
    jplan = _jplan(JBS.from_numpy(a, block_size=bs, mesh=mesh8).multiply(
        _jbm(d, mesh8)), mesh8)
    jstep = jplan.bound_runner(rebind_uids=(jplan.leaf_order[0].uid,),
                               donate=True)
    want = np.asarray(jstep(_jbm(d2, mesh8).data))
    np.testing.assert_allclose(out2.numpy()[:n, :16], want[:n, :16],
                               rtol=1e-4, atol=1e-4)


def _graph(rng, n, m):
    src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    return dst, src, (1.0 / outdeg[src]).astype(np.float32)


def test_coo_matvec_rebound(sess, jmesh, monkeypatch):
    """x ← A·x through a compiled COO plan with x rebound (the PageRank
    iteration), B2's plain walk each step, against float64 numpy and the
    JAX package's bound runner on the same edges."""
    from matrel_tpu.core.coo import COOMatrix as JCOO
    rng = _rng()
    n, m, steps = 300, 2400, 5
    rows, cols, vals = _graph(rng, n, m)
    x0 = np.full((n, 1), 1.0 / n, np.float32)
    A = COOMatrix.from_edges(rows, cols, vals, shape=(n, n))
    X = sess.from_numpy(x0)
    plan = compile_expr(A.multiply(X), sess.mesh)
    step = plan.bound_runner(rebind_uids=(plan.leaf_order[0].uid,))
    walks = _counting(monkeypatch, csr_view, "csr_walk_plain")
    cur = X.data
    for _ in range(steps):
        cur = step(cur)
    assert walks[0] == steps
    dense = np.zeros((n, n))
    np.add.at(dense, (rows, cols), vals.astype(np.float64))
    want = x0.astype(np.float64)
    for _ in range(steps):
        want = dense @ want
    np.testing.assert_allclose(cur.numpy()[:n], want, rtol=1e-4, atol=1e-5)
    JA = JCOO.from_edges(rows, cols, vals, shape=(n, n))
    jplan = _jplan(JA.multiply(_jbm(x0, jmesh)), jmesh)
    jstep = jplan.bound_runner(rebind_uids=(jplan.leaf_order[0].uid,))
    jcur = _jbm(x0, jmesh).data
    for _ in range(steps):
        jcur = jstep(jcur)
    np.testing.assert_allclose(cur.numpy()[:n], np.asarray(jcur)[:n],
                               rtol=1e-4, atol=1e-5)
    # parity with run(): bit-equal
    v = X
    for _ in range(steps):
        v = plan.run(bindings={plan.leaf_order[0].uid: v})
    assert torch.equal(cur, v.data)


def test_bf16_chain_step(sess, jmesh):
    """bench.py's bf16_safe_chain_step, (C·B)·(2/N), chained through the
    runner at a small N: bit-equal to the same chain through run(),
    within BF16_CHAIN_RTOL of float64 numpy on the same bf16 operands
    and of the JAX package's chain, mean|C| finite and O(1)."""
    n = BF16_N
    A = sess.random((n, n), seed=0, dtype="bfloat16")
    B = sess.random((n, n), seed=1, dtype="bfloat16")
    plan = compile_expr(A.expr().multiply(B.expr()).multiply_scalar(
        2.0 / n), sess.mesh)
    a_leaf = plan.leaf_order[0]
    step = plan.bound_runner(rebind_uids=(a_leaf.uid,))
    cur = step(A.data)
    for _ in range(BF16_STEPS - 1):
        cur = step(cur)
    assert cur.dtype == torch.bfloat16
    via_run = plan.run(bindings={a_leaf.uid: A})
    for _ in range(BF16_STEPS - 1):
        via_run = plan.run(bindings={a_leaf.uid: via_run})
    assert torch.equal(cur, via_run.data)
    a64, b64 = (t.data.double().numpy() for t in (A, B))
    want = a64
    for _ in range(BF16_STEPS):
        want = want @ b64 * (2.0 / n)
    got = cur.double().numpy()
    scale = float(np.abs(want).mean())
    assert np.isfinite(got).all() and 0.1 < float(np.abs(got).mean()) < 10
    assert float(np.abs(got - want).max()) <= BF16_CHAIN_RTOL * scale
    import jax.numpy as jnp
    JA = _jbm(a64, jmesh)
    JB = _jbm(b64, jmesh)
    JA.data = JA.data.astype(jnp.bfloat16)
    JB.data = JB.data.astype(jnp.bfloat16)
    jplan = _jplan(JA.expr().multiply(JB.expr()).multiply_scalar(2.0 / n),
                   jmesh)
    jstep = jplan.bound_runner(rebind_uids=(jplan.leaf_order[0].uid,))
    jcur = jstep(JA.data)
    for _ in range(BF16_STEPS - 1):
        jcur = jstep(jcur)
    jgot = np.asarray(jcur.astype(jnp.float32), np.float64)
    assert float(np.abs(got - jgot).max()) <= BF16_CHAIN_RTOL * scale


# -- collectives() and explain ------------------------------------------------


def test_collectives_one_device(sess, jmesh):
    """{} on one device, as the JAX package's on its 1-device mesh, and
    explain's Collectives section says so."""
    a = _rng().standard_normal((64, 64)).astype(np.float32)
    cfg = MatrelConfig(broadcast_threshold_bytes=1024,
                       strategy_override="cpmm")
    A = sess.from_numpy(a)
    plan = compile_expr(A.expr().multiply(A.expr()), sess.mesh, cfg)
    JA = _jbm(a, jmesh)
    jplan = _jplan(JA.expr().multiply(JA.expr()), jmesh)
    assert plan.collectives() == jplan.collectives() == {}
    assert plan.explain().endswith("\n== Collectives ==\n{}")
    assert jplan.explain().endswith("\n== Collectives ==\n{}")


def _rank_main(rank, world_size, store, out_dir):
    """One rank: per strategy, the forced plan's collectives(), explain
    and its result through run() and a bound runner (gathered whole)."""
    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.parallel import collectives as coll
    mesh = mesh_lib.init_distributed("gloo", "file://" + store, world_size,
                                     rank, grid=GRID, device="cpu",
                                     timeout_s=JOIN_TIMEOUT_S)
    try:
        rng = np.random.default_rng(0)
        a, b = (rng.standard_normal((RANK_N, RANK_N)).astype(np.float32)
                for _ in range(2))
        A, B = (BlockMatrix.from_numpy(x, mesh=mesh) for x in (a, b))
        res = {}
        for s in STRATS:
            cfg = MatrelConfig(broadcast_threshold_bytes=1024,
                               strategy_override=s)
            plan = compile_expr(A.expr().multiply(B.expr()), mesh, cfg)
            cols = plan.collectives()
            text = plan.explain()
            run = coll.gather_full(plan.run().as_shard(), mesh)
            uid = plan.leaf_order[0].uid
            step = plan.bound_runner(rebind_uids=(uid,), donate=True)
            cur = step(step(A.data.clone()))
            two = BlockMatrix.from_array(cur, A.shape, mesh, A.spec)
            res[s] = {"collectives": cols, "explain": text,
                      "again": plan.collectives(),
                      "run": run.numpy(),
                      "bound": coll.gather_full(two.as_shard(),
                                                mesh).numpy()}
    except BaseException:
        traceback.print_exc()
        raise
    mesh_lib.shutdown_distributed()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump((res, a, b), f)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = str(tmp_path_factory.mktemp("bound_ranks"))
    n = GRID[0] * GRID[1]
    os.environ["OMP_NUM_THREADS"] = "1"
    ctx = mp.start_processes(_rank_main,
                             args=(n, os.path.join(tmp, "store"), tmp),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    except Exception as e:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        logs = [open(os.path.join(tmp, f"rank{r}.log")).read()[-3000:]
                for r in range(n)
                if os.path.exists(os.path.join(tmp, f"rank{r}.log"))]
        pytest.fail(f"{e!r}\n" + "\n".join(logs))
    out = []
    for r in range(n):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def test_cpmm_reduce_scatter_on_ranks(world):
    """tests/test_strategies.py's plan-shape assertion on mesh8, on a
    2 × 2 rank world: a forced cpmm reduce-scatters, and explain shows
    the strategy and the Collectives section — on every rank alike."""
    for res, _, _ in world:
        cols = res["cpmm"]["collectives"]
        assert cols.get("reduce-scatter", 0) >= 1
        assert "strategy=cpmm" in res["cpmm"]["explain"]
        assert res["cpmm"]["explain"].endswith(
            "\n== Collectives ==\n" + str(cols))
        assert res["cpmm"]["again"] == cols
    assert all(r[0]["cpmm"]["collectives"] == world[0][0]["cpmm"][
        "collectives"] for r in world)


#: Where the port's set of kinds differs from the JAX HLO's, and why:
#: XLA's partitioner moves a block that exactly one other device holds
#: with a collective-permute, and it does so in its re-lays for CPMM and
#: for BMM-left; the port's ``collectives.relay`` has no point-to-point
#: re-lay and reaches those layouts by an all-gather (or an all-to-all)
#: over the smallest group, so ``collective-permute`` is XLA's alone
#: there. Every other kind agrees, CPMM's reduce-scatter and SUMMA's
#: shifts among them.
RELAY_ONLY_IN_XLA = {"bmm_left": {"collective-permute"},
                     "cpmm": {"collective-permute"}}


@pytest.mark.parametrize("strategy", STRATS)
def test_collective_kinds_match_jax(world, strategy, mesh_square):
    """Per strategy on the 2 × 2 grid: the port's kinds against the JAX
    HLO's on the conftest's 4-device mesh (the re-lay difference stated
    in RELAY_ONLY_IN_XLA), and each result against numpy."""
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    from matrel_tpu.executor import compile_expr as jcompile
    res, a, b = world[0]
    jcfg = JConfig(broadcast_threshold_bytes=1024,
                   strategy_override=strategy)
    A, B = (JBM.from_numpy(x, mesh=mesh_square) for x in (a, b))
    jplan = jcompile(A.expr().multiply(B.expr()), mesh_square, jcfg)
    want = set(jplan.collectives()) - RELAY_ONLY_IN_XLA.get(strategy,
                                                           set())
    assert set(res[strategy]["collectives"]) == want
    for r, _, _ in world:
        np.testing.assert_allclose(r[strategy]["run"], a @ b, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(r[strategy]["bound"], a @ b @ b,
                                   rtol=1e-4, atol=1e-3)
