"""PyTorch port: multi-rank execution over ``torch.distributed`` (gloo on
the CPU), held against the JAX package on its CPU meshes.

One spawn per world runs the whole battery (``_battery``) on every rank
of a 2×2 world (the square grid SUMMA needs; the JAX side on the
conftest's 4-device ``mesh_square``) and of a 2×4 world (the JAX tests'
``mesh8``), and hands each rank's results back through a pickle file.
The ranks rendezvous through a ``file://`` store in the test's temporary
directory, so parallel test workers never share a port, and run with
``OMP_NUM_THREADS=1``. A world that has not finished within
``JOIN_TIMEOUT_S`` is killed and the test fails with the ranks' output.

This module is imported by the rank processes, so it imports neither
``jax`` nor ``matrel_tpu`` at the top: the JAX side is imported inside
the tests, and every rank reports that neither was loaded.

Checked: every strategy recipe's result (the JAX tests' tolerance
rtol = atol = 1e-4) and its collective tally (CPMM one reduce-scatter on
y, RMM gathers only, SUMMA point-to-point only, BMM nothing after its
input re-lay — the JAX tests' HLO assertions); SUMMA on 2×4 runs CPMM;
planner stamps equal the JAX package's on the same grid; staged reshard
moves bit-equal; a budgeted plan bit-equal to budget 0; the sharded
SpMV/SpMM (the plain B2/B3 versions on the CPU, and the expanded
slices), sharded PageRank, ``spgemm_sharded``, ``spmm_sharded`` and
``streaming_chain_sharded``; measured choices agreed from rank 0; a
checkpoint of a rank-laid matrix (every rank gathers, rank 0 writes,
every rank restores its own block under the saved spec).
"""

import os
import pickle
import sys
import time
import traceback

import numpy as np
import pytest
import torch

JOIN_TIMEOUT_S = 120.0
WORLDS = {"2x2": (2, 2), "2x4": (2, 4)}
STRATS = ("bmm_left", "bmm_right", "cpmm", "rmm", "summa", "xla")
#: strategy inputs per world: the shapes of tests/test_strategies.py
SHAPES = {"2x2": ((12, 20), (20, 8)), "2x4": ((16, 24), (24, 32))}
RESHARD_PAIRS = (("row", "2d"), ("2d", "row"), ("col", "2d"),
                 ("2d", "col"), ("row", "col"), ("col", "row"),
                 ("2d", "rep"), ("row", "rep"), ("col", "rep"),
                 ("rep", "row"), ("rep", "2d"))
CHAIN = ((64, 48), (48, 80), (80, 16))
GRAPH_N, GRAPH_E = 700, 6000
CHAIN_N, CHAIN_TILE = 64, 8


def _graph(seed=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, GRAPH_N, GRAPH_E)
    dst = (src * 7 + rng.integers(0, 40, GRAPH_E)) % GRAPH_N
    return src, dst


def _inputs(world):
    (n, k), (_, m) = SHAPES[world]
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((k, m)).astype(np.float32))


def _chain_inputs():
    rng = np.random.default_rng(1)
    return [rng.standard_normal(s).astype(np.float32) for s in CHAIN]


def _stamps(plan):
    """Matmul strategy stamps in post-order (uids differ across
    packages)."""
    out = []

    def walk(n):
        for c in n.children:
            walk(c)
        if n.kind == "matmul":
            out.append(n.attrs.get("strategy"))

    walk(plan.optimized)
    return out


# -- the rank side ----------------------------------------------------------


def _mark(stage: str) -> None:
    """A line in the rank's log, so a world killed at its timeout shows
    where each rank was."""
    print(f"{time.monotonic():.1f} battery: {stage}", flush=True)


def _battery(mesh, world, out_dir):
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.coo import COOMatrix
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.ops import pallas_spmv as pc, spgemm, spmv
    from matrel_tpu_torch.parallel import autotune, collectives as coll
    from matrel_tpu_torch.parallel import reshard, strategies
    from matrel_tpu_torch.session import MatrelSession
    from matrel_tpu_torch.workloads import big_chain, pagerank

    res = {"coords": mesh.ranks.coords, "grid": mesh.grid}
    full = lambda s: coll.gather_full(s, mesh).numpy()

    _mark("strategy recipes")
    # strategy recipes and their collective tallies
    a, b = _inputs(world)
    A, B = (BlockMatrix.from_numpy(x, mesh=mesh) for x in (a, b))
    for s in STRATS:
        coll.reset_tally()
        out = strategies.run_matmul(s, A.as_shard(), B.as_shard(), mesh)
        res[f"mm_tally_{s}"] = (coll.tally("relay"), coll.tally("exec"))
        res[f"mm_layout_{s}"] = out.layout
        res[f"mm_{s}"] = full(out)[: a.shape[0], : b.shape[1]]

    _mark("the session on the rank mesh")
    # the session on the rank mesh: stamps, results, staged reshards
    x, y, z = _chain_inputs()
    for budget in (0, 4096):
        sess = MatrelSession(mesh=mesh, config=MatrelConfig(
            reshard_peak_budget_bytes=budget))
        X, Y, Z = (sess.from_numpy(v) for v in (x, y, z))
        expr = X.multiply(Y).multiply(Z)
        plan = sess.compile(expr)
        res[f"chain_stamps_{budget}"] = _stamps(plan)
        res[f"chain_{budget}"] = sess.compute(expr).to_numpy()
        res[f"chain_add_{budget}"] = sess.compute(
            X.multiply(Y).add(X.multiply(Y))).to_numpy()
        # a transposed leaf flows into the recipe as a swapped layout
        res[f"gram_{budget}"] = sess.compute(X.t().multiply(X)).to_numpy()

    _mark("staged reshard moves")
    # staged reshard moves: bit-equal, one step at a time
    src_full = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    moved = {}
    for src, dst in RESHARD_PAIRS:
        plan = reshard.compile_reshard(src, dst, 16 * 24 * 4.0, *mesh.grid,
                                       peak_budget=1.0)
        v = coll.shard_from_full(src_full, src, mesh)
        out = reshard.apply_staged(v, plan, mesh)
        moved[(src, dst)] = (plan.step_kinds, out.layout,
                             bool(torch.equal(coll.gather_full(out, mesh),
                                              src_full)))
    res["reshard_moves"] = moved
    plan2 = reshard.compile_reshard("row", "col", 4096 * 4.0, *mesh.grid,
                                    peak_budget=1.0)
    res["reshard_times"] = {v: autotune.measure_reshard_variant(
        v, plan2, mesh, n_times=1) for v in autotune.RESHARD_VARIANTS}
    res["reshard_choice"] = autotune.lookup_or_measure_reshard(plan2, mesh)

    _mark("sharded SpMV / SpMM")
    # sharded SpMV / SpMM over a COO graph: B2/B3 (plain on the CPU) per
    # rank, the expanded slices, and the executor's COO path
    src, dst = _graph()
    vals = np.random.default_rng(6).random(GRAPH_E).astype(np.float32)
    M = COOMatrix.from_edges(dst, src, vals, shape=(GRAPH_N, GRAPH_N))
    Ms = M.shard(mesh)
    xv = np.random.default_rng(7).standard_normal(GRAPH_N).astype(np.float32)
    Xk = np.random.default_rng(8).standard_normal(
        (GRAPH_N, 5)).astype(np.float32)
    res["coo_matvec"] = Ms.matvec(xv).numpy()
    res["coo_matmat"] = Ms.matmat(Xk).numpy()
    res["coo_one_card"] = (M.matvec(xv, device="cpu").numpy(),
                           M.matmat(Xk, device="cpu").numpy())
    plan = M._get_plan()
    res["spmv_expanded"] = spmv.spmv_sharded(plan, xv, mesh).numpy()
    res["spmm_expanded"] = spmv.spmm_sharded(plan, Xk, mesh).numpy()
    res["spmv_plain_tables"] = pc.spmv_compact_sharded(
        plan, xv, mesh, use_pallas=False).numpy()
    sl = spmv.shard_plan(plan, mesh)
    res["slice"] = (sl.local.n_rows, sl.local.src8.shape,
                    id(pc.csr_view_on(sl.local, mesh.device))
                    != id(pc.csr_view_on(plan, mesh.device)))
    sess = MatrelSession(mesh=mesh)
    Xb = sess.from_numpy(Xk)
    res["coo_compute"] = sess.compute(M.expr().multiply(Xb)).to_numpy()

    _mark("sharded PageRank")
    # sharded PageRank, both executors
    res["pagerank"] = pagerank.pagerank_edges(
        src, dst, GRAPH_N, rounds=20, impl="onehot", mesh=mesh).numpy()
    res["pagerank_one_card"] = pagerank.pagerank_edges(
        src, dst, GRAPH_N, rounds=20, impl="onehot", device="cpu").numpy()

    _mark("the sparse scale-out")
    # the sparse scale-out composites
    SA = BlockSparseMatrix.random((64, 64), 0.3, block_size=8, mesh=mesh,
                                  seed=2)
    SB = BlockSparseMatrix.random((64, 64), 0.3, block_size=8, mesh=mesh,
                                  seed=3)
    res["spgemm_in"] = (SA.to_numpy(), SB.to_numpy())
    res["spgemm"] = spgemm.spgemm_sharded(SA, SB).to_numpy()
    D = np.random.default_rng(9).standard_normal((64, 16)).astype(np.float32)
    res["spmm"] = SA.shard(mesh).multiply(
        BlockMatrix.from_numpy(D, mesh=mesh)).to_numpy()

    _mark("the north-star chain")
    # the north-star chain: panels over the ranks, one all_reduce
    gens = [big_chain.cheap_gen(s, CHAIN_TILE, torch.float32,
                                device=mesh.device) for s in (0, 1, 2)]
    panel = CHAIN_N // mesh.size
    res["chain_sharded"] = float(big_chain.streaming_chain_sharded(
        CHAIN_N, *gens, mesh, tile=CHAIN_TILE, panel=panel,
        dtype=torch.float32))
    res["chain_slab"] = float(big_chain.streaming_chain_slab(
        CHAIN_N, *gens, tile=CHAIN_TILE, panel=panel, dtype=torch.float32))

    _mark("a checkpoint on the ranks")
    # utils/checkpoint.py on a rank mesh: the save gathers (every rank),
    # rank 0 writes; each rank restores its own block under the spec
    import torch.distributed as dist
    from matrel_tpu_torch.utils.checkpoint import CheckpointManager
    cm = CheckpointManager(os.path.join(out_dir, "ckpt"))
    cm.save(0, matrices={"A": A}, state={"world": world})
    dist.barrier()
    step, mats, _arrs, state = cm.restore(mesh)
    got = mats["A"]
    res["ckpt"] = (step, state, tuple(got.spec) == tuple(A.spec),
                   got.shape == A.shape,
                   bool(torch.equal(got.data, A.data)),
                   bool(np.array_equal(got.to_numpy(), a)))

    _mark("a measured matmul choice")
    # a measured matmul choice: rank 0's medians on every rank
    best, times = autotune.autotune_matmul(16, 16, 16, mesh=mesh)
    res["autotune"] = (best, times)

    res["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib",
                                                  "matrel_tpu"))
    return res


def _rank_main(rank, world_size, grid, store, out_dir):
    """One rank: its output into ``rank<r>.log``, its results into
    ``rank<r>.pkl``."""
    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.parallel import autotune
    autotune._DEFAULT_TABLE = os.path.join(out_dir, "autotune.json")
    mesh = mesh_lib.init_distributed("gloo", "file://" + store, world_size,
                                     rank, grid=grid, device="cpu",
                                     timeout_s=JOIN_TIMEOUT_S)
    try:
        res = _battery(mesh, f"{grid[0]}x{grid[1]}", out_dir)
    except BaseException:
        traceback.print_exc()          # into the rank's log
        raise                          # the parent kills the world
    mesh_lib.shutdown_distributed()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _run_world(grid, tmp_dir):
    import torch.multiprocessing as mp
    n = grid[0] * grid[1]
    store = os.path.join(tmp_dir, "store")
    os.environ["OMP_NUM_THREADS"] = "1"
    ctx = mp.start_processes(_rank_main, args=(n, grid, store, tmp_dir),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"world {grid} did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    except Exception as e:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        logs = []
        for r in range(n):
            path = os.path.join(tmp_dir, f"rank{r}.log")
            if os.path.exists(path):
                logs.append(f"--- rank {r} ---\n"
                            + open(path).read()[-3000:])
        pytest.fail(f"{e!r}\n" + "\n".join(logs))
    out = []
    for r in range(n):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {name: _run_world(grid, str(tmp_path_factory.mktemp(name)))
            for name, grid in WORLDS.items()}


# -- the test side ------------------------------------------------------------


def _jax_mesh(world):
    import jax
    from matrel_tpu.core import mesh as mesh_lib
    gx, gy = WORLDS[world]
    return mesh_lib.make_mesh((gx, gy), devices=jax.devices()[:gx * gy])


def _jax_matmul(strategy, a, b, mesh):
    import jax
    from matrel_tpu.core.blockmatrix import BlockMatrix
    from matrel_tpu.parallel import strategies
    A = BlockMatrix.from_numpy(a, mesh=mesh)
    B = BlockMatrix.from_numpy(b, mesh=mesh)
    f = jax.jit(lambda x, y: strategies.run_matmul(strategy, x, y, mesh,
                                                   None))
    return np.asarray(f(A.data, B.data))[: a.shape[0], : b.shape[1]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", STRATS)
def test_strategy_matches_jax(worlds, world, strategy):
    a, b = _inputs(world)
    want = _jax_matmul(strategy, a, b, _jax_mesh(world))
    for r in worlds[world]:
        np.testing.assert_allclose(r[f"mm_{strategy}"], want, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(r[f"mm_{strategy}"], a @ b, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_collective_tallies(worlds, world):
    """The JAX tests' HLO assertions, as counted collectives: CPMM one
    reduce-scatter on y; RMM and BMM nothing after their input re-lay
    (RMM's re-lay only gathers); SUMMA point-to-point only on a square
    grid and CPMM's reduce-scatter on 2×4."""
    t = worlds[world][0]
    relay = {s: t[f"mm_tally_{s}"][0] for s in STRATS}
    exe = {s: t[f"mm_tally_{s}"][1] for s in STRATS}
    assert exe["cpmm"] == {"reduce_scatter:y": 1}
    assert exe["rmm"] == {} and exe["bmm_left"] == {} \
        and exe["bmm_right"] == {} and exe["xla"] == {}
    assert all(k.startswith("all_gather") for k in relay["rmm"])
    if world == "2x2":
        assert set(exe["summa"]) == {"p2p:x", "p2p:y"}
        # g-1 skew shifts + g-1 ring shifts per axis at g = 2
        assert exe["summa"] == {"p2p:x": 2, "p2p:y": 2}
    else:
        assert exe["summa"] == {"reduce_scatter:y": 1}
    assert t["mm_layout_bmm_right"] == (("x", "y"), ())
    assert t["mm_layout_bmm_left"] == ((), ("x", "y"))


@pytest.mark.parametrize("world", WORLDS)
def test_chain_stamps_and_results(worlds, world):
    """Stamps equal the JAX planner's on the same grid, on every rank;
    results match numpy; a budgeted plan (staged reshards moving for
    real) is bit-equal to budget 0."""
    from matrel_tpu import executor as j_exec
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    x, y, z = _chain_inputs()
    mesh = _jax_mesh(world)
    X, Y, Z = (JBM.from_numpy(v, mesh=mesh) for v in (x, y, z))
    jplan = j_exec.compile_expr(X.multiply(Y).multiply(Z), mesh)
    want = _stamps(jplan)
    for r in worlds[world]:
        assert r["chain_stamps_0"] == want
        np.testing.assert_allclose(r["chain_0"], x @ y @ z, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(r["chain_4096"], r["chain_0"])
        np.testing.assert_array_equal(r["chain_add_4096"],
                                      r["chain_add_0"])
        np.testing.assert_allclose(r["chain_add_0"], 2 * (x @ y),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["gram_0"], x.T @ x, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(r["gram_4096"], r["gram_0"])


@pytest.mark.parametrize("world", WORLDS)
def test_reshard_moves_bit_equal(worlds, world):
    """Every staged plan moves the blocks to the plan's final state, and
    the gathered matrix is bit-equal to the input; the plans are the
    JAX package's step for step."""
    from matrel_tpu.parallel import reshard as j_reshard
    from matrel_tpu_torch.parallel import collectives as coll
    gx, gy = WORLDS[world]
    for r in worlds[world]:
        for (src, dst), (kinds, layout, equal) in r["reshard_moves"].items():
            jp = j_reshard.compile_reshard(src, dst, 16 * 24 * 4.0, gx, gy,
                                           peak_budget=1.0)
            assert kinds == jp.step_kinds, (src, dst)
            assert equal, (src, dst)
            assert layout == coll.STATES[dst], (src, dst)


@pytest.mark.parametrize("world", WORLDS)
def test_reshard_measured_on_ranks(worlds, world):
    for r in worlds[world]:
        assert set(r["reshard_times"]) == {"staged", "naive"}
        assert all(t > 0 for t in r["reshard_times"].values())
    choices = {r["reshard_choice"] for r in worlds[world]}
    assert len(choices) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_spmv_spmm(worlds, world):
    """B2/B3's plain versions on each rank's slice equal the one-card
    result bit for bit; the expanded slices and the JAX package's sharded
    matvec agree within f32 rounding."""
    from matrel_tpu.core.coo import COOMatrix as JCOO
    src, dst = _graph()
    vals = np.random.default_rng(6).random(GRAPH_E).astype(np.float32)
    xv = np.random.default_rng(7).standard_normal(GRAPH_N).astype(np.float32)
    Xk = np.random.default_rng(8).standard_normal(
        (GRAPH_N, 5)).astype(np.float32)
    JM = JCOO.from_edges(dst, src, vals, shape=(GRAPH_N, GRAPH_N)).shard(
        _jax_mesh(world))
    want_v = np.asarray(JM.matvec(xv))
    want_m = np.asarray(JM.matmat(Xk))
    for r in worlds[world]:
        one_v, one_m = r["coo_one_card"]
        np.testing.assert_array_equal(r["coo_matvec"], one_v)
        np.testing.assert_array_equal(r["coo_matmat"], one_m)
        np.testing.assert_array_equal(r["spmv_plain_tables"], one_v)
        np.testing.assert_array_equal(r["coo_compute"], one_m)
        for got, want in ((r["coo_matvec"], want_v),
                          (r["spmv_expanded"], want_v),
                          (r["coo_matmat"], want_m),
                          (r["spmm_expanded"], want_m)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        n_rows, shape, own_view = r["slice"]
        p = WORLDS[world][0] * WORLDS[world][1]
        assert n_rows * p >= GRAPH_N and shape[0] * 512 == n_rows
        assert own_view


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pagerank(worlds, world):
    from matrel_tpu.workloads import pagerank as j_pr
    src, dst = _graph()
    want = np.asarray(j_pr.pagerank_edges(src, dst, GRAPH_N, rounds=20,
                                          impl="onehot",
                                          mesh=_jax_mesh(world)))
    a = np.zeros((GRAPH_N, GRAPH_N), np.float64)
    np.add.at(a, (src, dst), 1.0)
    ref = j_pr.pagerank_numpy_oracle(a, rounds=20)
    for r in worlds[world]:
        np.testing.assert_array_equal(r["pagerank"], r["pagerank_one_card"])
        np.testing.assert_allclose(r["pagerank"], want, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(r["pagerank"], np.ravel(ref), atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_spgemm_and_spmm_sharded(worlds, world):
    from matrel_tpu.core.sparse import BlockSparseMatrix as JBS
    from matrel_tpu.ops import spgemm as j_spgemm
    from matrel_tpu.ops.spmm_sharded import shard_block_sparse
    from matrel_tpu.ops.spmm_sharded import spmm_sharded as j_spmm
    mesh = _jax_mesh(world)
    r0 = worlds[world][0]
    a, b = r0["spgemm_in"]
    JA, JB = (JBS.from_numpy(v, block_size=8, mesh=mesh) for v in (a, b))
    want = np.asarray(j_spgemm.spgemm_sharded(JA, JB).to_numpy())
    D = np.random.default_rng(9).standard_normal((64, 16)).astype(np.float32)
    want_mm = np.asarray(j_spmm(shard_block_sparse(JA, mesh), D).to_numpy())
    for r in worlds[world]:
        np.testing.assert_allclose(r["spgemm"], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["spgemm"], a @ b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["spmm"], want_mm, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["spmm"], a @ D, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_streaming_chain_sharded(worlds, world):
    """One panel body a rank and one all_reduce: equal to the one-card
    slab schedule and to the JAX package's sharded chain within the
    reduction-order bound (f32 sums of ``mesh.size`` partials)."""
    import jax.numpy as jnp
    from matrel_tpu.workloads import big_chain as j_bc
    mesh = _jax_mesh(world)
    gens = [j_bc.cheap_gen(s, CHAIN_TILE, jnp.float32) for s in (0, 1, 2)]
    panel = CHAIN_N // mesh.size
    want = float(j_bc.streaming_chain_sharded(
        CHAIN_N, *gens, mesh, tile=CHAIN_TILE, panel=panel,
        dtype=jnp.float32))
    for r in worlds[world]:
        assert r["chain_sharded"] == pytest.approx(r["chain_slab"],
                                                   rel=1e-6)
        assert r["chain_sharded"] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_measured_choice_agreed(worlds, world):
    """autotune_matmul on the rank grid: every rank holds rank 0's
    medians and winner."""
    outs = [r["autotune"] for r in worlds[world]]
    assert all(o == outs[0] for o in outs)
    assert outs[0][1], "no strategy was measured"


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_on_ranks(worlds, world):
    """Every rank restores its own block of the rank-laid matrix, bit
    for bit, under the saved spec and state."""
    for r in worlds[world]:
        assert r["ckpt"] == (0, {"world": world}, True, True, True, True)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(worlds, world):
    for r in worlds[world]:
        assert r["loaded"] == []
    assert sorted(r["coords"] for r in worlds[world]) == [
        (i, j) for i in range(WORLDS[world][0])
        for j in range(WORLDS[world][1])]


def test_virtual_mesh_unchanged():
    """The one-card virtual grid holds whole tensors and runs every
    strategy as one local product, as before."""
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch.parallel import strategies
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.parallel import collectives as coll
    mesh = make_mesh((2, 4), device="cpu")
    assert not mesh.ranked and mesh.ranks is None
    for spec, state in ((mesh_lib.replicated, "rep"),
                        (mesh_lib.sharding_2d, "2d"),
                        (mesh_lib.sharding_row, "row"),
                        (mesh_lib.sharding_col, "col")):
        assert coll.layout_of(spec(mesh), mesh) == coll.STATES[state]
    a, b = _inputs("2x4")
    A = BlockMatrix.from_numpy(a, mesh=mesh)
    assert A.data.shape == A.padded_shape
    for s in STRATS:
        out = strategies.run_matmul(s, A.data, BlockMatrix.from_numpy(
            b, mesh=mesh).data, mesh)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_allclose(out.numpy()[:16, :32], a @ b,
                                   rtol=1e-5, atol=1e-5)


def test_backend_is_explicit():
    from matrel_tpu_torch.core import mesh as mesh_lib
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.init_distributed("mpi", "file:///nonexistent", 1, 0)
    if torch.cuda.device_count() < 4:
        with pytest.raises(mesh_lib.DeviceUnavailableError, match="nccl"):
            mesh_lib.init_distributed("nccl", "file:///nonexistent", 4, 0)
