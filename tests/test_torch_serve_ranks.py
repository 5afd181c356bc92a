"""PyTorch port: the serve plane and the fleet on a rank mesh, held
against float64 numpy and the JAX package on its CPU meshes.

One spawn per world runs its battery on every rank (gloo CPU ranks,
a ``file://`` store in the test's temporary directory,
``OMP_NUM_THREADS=1``; a world not finished within its
``JOIN_TIMEOUT_S`` is killed and the test fails with the ranks' logs), and hands each
rank's results back through a pickle file:

- **(1, 2)**: ``submit`` on the decision log (``serve/ranklog.py``).
  The first case is the fault the log repairs: both ranks submit the
  same three queries over one shared product, rank 1 sleeps after each
  submit, and without the log rank 0 batched the three (cross-query
  CSE) while rank 1 ran them one at a time — wrong sums on rank 0, a
  gloo timeout on rank 1. Then a deadline that has expired on the
  follower's clock but not on the lead's, an open breaker, the brownout
  rung, a result-cache hit, and a mismatched submission that fails
  typed (``RankDivergence``) on both ranks.
- **(2, 4)**: the fleet with 2 slices of 4 ranks and 4 slices of 2
  (``serve/fleet.py``): routing with correct answers, a directory hit
  anywhere, a migration under the byte budget and one priced out,
  ``kill_slice`` failover, write-through on ``register``, and the
  pipeline's contracts on a slice that does not hold the lead rank (a
  deadline that expires while the slice runs, a transient failure that
  retries, a failing query whose error reaches every rank as the same
  typed error); then the slices serving at the same time: slowed
  queries on different slices overlap, ``kill_slice`` re-admits an
  entry waiting in the dead slice's queue, placement sends a query past
  a busy slice, and ``check_health`` fails over a slice whose worker
  died with an entry waiting — each ``fleet_info`` equal on every rank
  and to the JAX package's on ``mesh8`` for the same sequence. Then the
  backlog bounds, which shed typed on every rank alike.

This module is imported by the rank processes, so it imports neither
``jax`` nor ``matrel_tpu`` at the top.
"""

import concurrent.futures
import importlib
import os
import pickle
import threading
import time
import traceback

import numpy as np
import pytest
import torch

WORLDS = {"1x2": (1, 2), "2x4": (2, 4)}
#: seconds a world may take before it is killed ((1, 2) runs in ~7 s
#: alone, (2, 4) in ~25 s)
JOIN_TIMEOUT_S = {"1x2": 60.0, "2x4": 120.0}
N = 64
#: the (1, 2) world's cases
SERVE_CASES = ("reproducer", "follower_deadline", "breaker", "brownout",
               "cache_hit", "mismatch")
#: the (2, 4) world's fleets and their cases
SLICES = (2, 4)
FLEET_CASES = ("routing", "directory_hit", "migration", "priced_out",
               "failover", "write_through", "late_deadline", "transient",
               "failing", "overlap", "queued_failover", "by_load", "wedged")
#: the cases that run with one query a batch (a slice's queue holds the
#: rest)
ONE_A_BATCH = ("queued_failover", "by_load", "backlog")
#: how long a slowed slice's run takes, and the deadline it outlives (s)
SLOW_S, LATE_MS = 1.0, 500.0
#: fleet_info keys that both packages report alike (result-cache bytes
#: and SLO windows are each package's own)
INFO_KEYS = ("source", "directory", "placed", "pinned", "migrations",
             "migrations_priced_out", "failovers", "requeued")


def _tables(seed=0):
    rng = np.random.default_rng(seed)
    return {nm: rng.standard_normal((N, N)).astype(np.float32)
            for nm in ("A", "B")}


def _mark(stage: str) -> None:
    print(f"{time.monotonic():.1f} serve_ranks: {stage}", flush=True)


def _outcome(fut, text=False):
    """("ok", array) or ("err", exception type name[, its text])."""
    try:
        return ("ok", np.asarray(fut.result(timeout=60).to_numpy()))
    except Exception as e:          # the typed error is the result
        return ("err", type(e).__name__) + ((str(e),) if text else ())


# -- the (1, 2) world: submit on the decision log ----------------------------


def _reproducer_queries(sess):
    A, B = sess.table("A").expr(), sess.table("B").expr()
    sh = A.multiply(B)
    return [sh.multiply(A), sh.multiply(B).multiply_scalar(2.0), sh.add(A)]


def _session(Session, Config, mesh, **kw):
    sess = Session(mesh=mesh, config=Config(**kw))
    for nm, arr in _tables().items():
        sess.register(nm, sess.from_numpy(arr))
    return sess


def _serve_case(case, mesh):
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.resilience import faults
    from matrel_tpu_torch.session import MatrelSession
    rank = mesh.ranks.rank
    res = {}
    if case == "reproducer":
        sess = _session(MatrelSession, MatrelConfig, mesh,
                        serve_max_batch=8, cse_enable=True)
        futs = []
        for q in _reproducer_queries(sess):
            futs.append(sess.submit(q))
            if rank == 1:
                time.sleep(0.5)
        res["out"] = [_outcome(f) for f in futs]
    elif case == "follower_deadline":
        sess = _session(MatrelSession, MatrelConfig, mesh)
        if rank == 0:
            time.sleep(0.6)
        fut = sess.submit(sess.table("A").expr().add(sess.table("B").expr()),
                          deadline_ms=400.0)
        res["out"] = [_outcome(fut)]
    elif case == "breaker":
        faults.reset()
        sess = _session(MatrelSession, MatrelConfig, mesh,
                        breaker_threshold=1, breaker_cooldown_ms=600000.0,
                        fault_inject="serve_admit:fatal:n=1")
        q = sess.table("A").expr().multiply(sess.table("B").expr())
        first = _outcome(sess.submit(q))
        second = _outcome(sess.submit(q))
        res["out"] = [first, second]
        res["breakers"] = sess._breakers.snapshot()
        faults.reset()
    elif case == "brownout":
        sess = _session(MatrelSession, MatrelConfig, mesh,
                        brownout_enable=True, brownout_dwell=1,
                        brownout_wait_high_ms=1e-3,
                        brownout_wait_low_ms=0.0)
        A, B = sess.table("A").expr(), sess.table("B").expr()
        out = []
        for k in range(3):
            out.append(_outcome(sess.submit(A.multiply_scalar(k + 1.0)
                                            .add(B))))
            sess.serve_drain()
        res["out"] = out
        res["brownout"] = sess._brownout.snapshot()
    elif case == "cache_hit":
        sess = _session(MatrelSession, MatrelConfig, mesh,
                        result_cache_max_bytes=1 << 24)
        q = sess.table("A").expr().multiply(sess.table("B").expr())
        first = _outcome(sess.submit(q))
        sess.serve_drain()
        second = _outcome(sess.submit(q))
        res["out"] = [first, second]
        info = sess.result_cache_info()
        res["rc"] = {k: info[k] for k in ("hits", "misses", "entries")}
    elif case == "mismatch":
        sess = _session(MatrelSession, MatrelConfig, mesh)
        A, B = sess.table("A").expr(), sess.table("B").expr()
        t0 = time.monotonic()
        bad = _outcome(sess.submit(A.multiply(B) if rank == 0
                                   else A.add(B)))
        res["seconds"] = time.monotonic() - t0
        res["out"] = [bad, _outcome(sess.submit(A.subtract(B)))]
    pipe = sess._serve
    res["counters"] = {"deadline_misses": pipe.deadline_misses,
                       "stale_served": pipe.stale_served,
                       "batches": pipe.batches,
                       "divergences": pipe.divergences,
                       "sheds": pipe._q.counters()}
    res["log"] = pipe._log.info()
    sess.serve_close(timeout=60)
    return res


def _serve_battery(mesh):
    out = {}
    for case in SERVE_CASES:
        _mark(case)
        out[case] = _serve_case(case, mesh)
    return out


# -- the (2, 4) world: the fleet on groups of ranks ---------------------------


def _fleet_q(sess):
    return sess.table("A").expr().multiply(sess.table("B").expr())


def _patched_runs(sess, fleet, wrap):
    """Wrap ``run_many`` of the parent and every slice session."""
    for s in [sess] + [sl.session for sl in fleet.slices]:
        s.run_many = wrap(s.run_many)


def _unpatched_runs(sess, fleet):
    for s in [sess] + [sl.session for sl in fleet.slices]:
        del s.run_many


def _slow(run):
    def slowed(*a, **k):
        time.sleep(SLOW_S)
        return run(*a, **k)
    return slowed


def _poison(run):
    def poisoned(*a, **k):
        raise ValueError("poison query")
    return poisoned


def _gate(sl):
    """Hold slice ``sl``'s runs until ``release`` is set; ``started`` is
    set when the first one begins."""
    started, release = threading.Event(), threading.Event()
    run = sl.session.run_many

    def gated(*a, **k):
        started.set()
        release.wait(60)
        return run(*a, **k)

    sl.session.run_many = gated
    return started, release


def _member(sl) -> bool:
    """Does this process run slice ``sl`` (always in the JAX
    package)?"""
    return getattr(sl, "member", True)


def _settled(fut):
    """Wait for ``fut`` without touching its value (``to_numpy`` is a
    collective that waits for every outstanding query)."""
    concurrent.futures.wait([fut], timeout=60)
    return fut


def _fleet_scenario(Session, Config, mesh, n_slices, case):
    """One fleet case, as either package runs it. Returns its results:
    outcomes and fleet_info."""
    faults = importlib.import_module(
        Session.__module__.split(".")[0] + ".resilience.faults")
    faults.reset()
    kw = {"fleet_slices": n_slices, "result_cache_max_bytes": 1 << 28}
    if case in ONE_A_BATCH:
        kw["serve_max_batch"] = 1
    if case == "migration":
        kw["fleet_replicate_hits"] = 1
    if case == "priced_out":
        kw.update(fleet_replicate_hits=1, reshard_peak_budget_bytes=64)
    if case == "transient":
        kw.update(fault_inject="serve_admit:transient:n=2",
                  retry_max_attempts=2)
    sess = _session(Session, Config, mesh, **kw)
    res = {"out": []}
    outs = res["out"]
    q = _fleet_q(sess)
    if case == "routing":
        futs = [sess.submit(q.multiply_scalar(float(i + 1)))
                for i in range(4)]
        outs.extend(_outcome(f) for f in futs)
    elif case in ("directory_hit", "migration", "priced_out"):
        for _ in range(4 if case != "directory_hit" else 2):
            outs.append(_outcome(sess.submit(q)))
            sess.serve_drain()
            fleet = sess._ensure_fleet()
            fleet.quiesce_replication(timeout=30)
    elif case == "failover":
        fleet = sess._ensure_fleet()
        outs.append(_outcome(sess.submit(q)))
        sess.serve_drain()
        fleet.kill_slice(0)
        futs = [sess.submit(q.multiply_scalar(float(i + 2)),
                            tenant="tenantA") for i in range(3)]
        outs.extend(_outcome(f) for f in futs)
    elif case == "write_through":
        outs.append(_outcome(sess.submit(q)))
        sess.serve_drain()
        new_a = _tables(seed=7)["A"]
        sess.register("A", sess.from_numpy(new_a))
        outs.append(_outcome(sess.submit(_fleet_q(sess))))
    elif case in ("late_deadline", "transient", "failing"):
        # the first query takes the round-robin's first slice, which
        # holds the lead rank; the case's own query lands on the next
        fleet = sess._ensure_fleet()
        outs.append(_outcome(sess.submit(q)))
        sess.serve_drain()
        if case == "late_deadline":
            _patched_runs(sess, fleet, _slow)
            fut = sess.submit(q.multiply_scalar(2.0), deadline_ms=LATE_MS)
            outs.append(_outcome(fut))
            sess.serve_drain()
            _unpatched_runs(sess, fleet)
        elif case == "failing":
            _patched_runs(sess, fleet, _poison)
            outs.append(_outcome(sess.submit(q.multiply_scalar(2.0)),
                                 text=True))
            sess.serve_drain()
            _unpatched_runs(sess, fleet)
        else:
            outs.append(_outcome(sess.submit(q.multiply_scalar(2.0))))
        outs.append(_outcome(sess.submit(q.multiply_scalar(3.0))))
    elif case == "overlap":
        fleet = sess._ensure_fleet()
        _patched_runs(sess, fleet, _slow)
        t0 = time.monotonic()
        futs = [sess.submit(q.multiply_scalar(float(i + 1)))
                for i in range(4)]
        concurrent.futures.wait(futs, timeout=60)
        res["seconds"] = time.monotonic() - t0
        sess.serve_drain()
        _unpatched_runs(sess, fleet)
        outs.extend(_outcome(f) for f in futs)
        # each slice's decision log: its lead rank, ranks and cycles
        res["logs"] = {sl.slice_id: (sl.session._serve._log.lead_rank,
                                     sl.session._serve._log.world)
                       for sl in fleet.slices if _member(sl)
                       and getattr(sl.session._serve, "_log", None)}
    elif case in ("queued_failover", "by_load"):
        # slice 0 holds its first query in a run until released; the
        # next query placed there waits in its queue
        fleet = sess._ensure_fleet()
        started, release = _gate(fleet.slices[0])
        futs = [sess.submit(q)]
        if _member(fleet.slices[0]):
            started.wait(60)
        # one query on each other slice, then slice 0's second (the
        # round-robin is back at slice 0, every load 0)
        futs += [_settled(sess.submit(q.multiply_scalar(float(i + 1))))
                 for i in range(1, n_slices)]
        futs.append(sess.submit(q.multiply_scalar(float(n_slices + 1))))
        if case == "queued_failover":
            res["requeued"] = fleet.kill_slice(0)
        else:
            # slice 0's load is 1: the next n queries go past it, the
            # last at a round-robin tick that points at slice 0
            futs += [_settled(sess.submit(q.multiply_scalar(
                float(n_slices + 2 + i)))) for i in range(n_slices)]
        release.set()
        outs.extend(_outcome(f) for f in futs)
        del fleet.slices[0].session.run_many
    elif case == "wedged":
        fleet = sess._ensure_fleet()
        for i in range(n_slices):
            outs.append(_outcome(sess.submit(q.multiply_scalar(
                float(i + 1)))))
        sess.serve_drain()
        sl = fleet.slices[0]
        if _member(sl):
            # the worker dies (a stop, then the stop flag erased) and is
            # not restarted: the next query placed there waits
            pipe = sl.session._serve
            pipe._stop.set()
            pipe._worker.join(timeout=10)
            pipe._stop.clear()
            pipe._ensure_worker = lambda: None
        fut = sess.submit(q.multiply_scalar(float(n_slices + 1)))
        fleet.check_health()
        outs.append(_outcome(fut))
    sess.serve_drain()
    faults.reset()
    info = sess.fleet_info()
    res["info"] = {k: info[k] for k in INFO_KEYS}
    res["slices"] = [{k: sl[k] for k in ("id", "alive", "devices",
                                          "submitted")}
                     for sl in info["slices"]]
    sess.serve_close(timeout=60)
    return res


def _backlog_scenario(mesh, n_slices):
    """The backlog bounds (``serve_tenant_queue_max`` = 1, one query a
    batch): with every run slowed, 2n + 1 queries of one tenant
    submitted at once find a query running and one waiting on every
    slice, so a slice's queue (or, sooner, the router's store) sheds at
    least the last; every rank fails the same futures typed."""
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.session import MatrelSession
    sess = _session(MatrelSession, MatrelConfig, mesh,
                    fleet_slices=n_slices, result_cache_max_bytes=1 << 28,
                    serve_tenant_queue_max=1, serve_max_batch=1)
    fleet = sess._ensure_fleet()
    q = _fleet_q(sess)
    _patched_runs(sess, fleet, _slow)
    futs = [sess.submit(q.multiply_scalar(float(i + 1)), tenant="tenantA")
            for i in range(2 * n_slices + 1)]
    sess.serve_drain()
    _unpatched_runs(sess, fleet)
    res = {"out": [_outcome(f) for f in futs],
           "sheds": sess._ensure_serve()._q.counters()["sheds"]}
    sess.serve_close(timeout=60)
    return res


COO_N, COO_E = 96, 600


def _coo_edges():
    rng = np.random.default_rng(5)
    return (rng.integers(0, COO_N, COO_E), rng.integers(0, COO_N, COO_E),
            rng.standard_normal(COO_E).astype(np.float32),
            rng.standard_normal((COO_N, 1)).astype(np.float32))


def _slice_tables_scenario(mesh, n_slices):
    """Block-sparse and COO tables reach a rank mesh's slices as they
    are (on one card's grid both stay pinned): S·D and a COO matvec are
    placed on slices (a span margin under 1), a repeat is a directory
    hit."""
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core.coo import COOMatrix
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.session import MatrelSession
    sess = _session(MatrelSession, MatrelConfig, mesh,
                    fleet_slices=n_slices, result_cache_max_bytes=1 << 28,
                    fleet_span_margin=0.01)
    r, c, v, x = _coo_edges()
    sess.register("E", COOMatrix.from_edges(r, c, v, shape=(COO_N, COO_N)))
    sess.register("x", sess.from_numpy(x))
    sess.register("S", BlockSparseMatrix.from_numpy(
        _tables()["A"] * (np.abs(_tables()["A"]) > 1.0), block_size=16,
        mesh=mesh))
    qs = [sess.table("E").expr().multiply(sess.table("x").expr()),
          sess.table("S").expr().multiply(sess.table("B").expr())]
    out = [_outcome(sess.submit(q)) for q in qs]
    sess.serve_drain()
    out += [_outcome(sess.submit(q)) for q in qs]
    info = sess.fleet_info()
    res = {"out": out, "info": {k: info[k] for k in INFO_KEYS}}
    sess.serve_close(timeout=60)
    return res


def _fleet_battery(mesh):
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.session import MatrelSession
    out = {}
    for n in SLICES:
        for case in FLEET_CASES:
            _mark(f"fleet {n} {case}")
            out[(n, case)] = _fleet_scenario(MatrelSession, MatrelConfig,
                                             mesh, n, case)
        _mark(f"fleet {n} backlog")
        out[(n, "backlog")] = _backlog_scenario(mesh, n)
        _mark(f"fleet {n} slice tables")
        out[(n, "slice_tables")] = _slice_tables_scenario(mesh, n)
    return out


def _rank_main(rank, world_size, grid, store, out_dir):
    """One rank: its output into ``rank<r>.log``, its results into
    ``rank<r>.pkl``."""
    name = next(k for k, v in WORLDS.items() if v == grid)
    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    import faulthandler
    # a hung or aborted world shows every thread's stack in the logs
    faulthandler.enable(all_threads=True)
    faulthandler.dump_traceback_later(JOIN_TIMEOUT_S[name] - 10,
                                      exit=False)
    from matrel_tpu_torch.core import mesh as mesh_lib
    mesh = mesh_lib.init_distributed("gloo", "file://" + store, world_size,
                                     rank, grid=grid, device="cpu",
                                     timeout_s=JOIN_TIMEOUT_S[name])
    try:
        res = (_serve_battery(mesh) if name == "1x2"
               else _fleet_battery(mesh))
    except BaseException:
        traceback.print_exc()          # into the rank's log
        raise                          # the parent kills the world
    import sys
    res["jax_loaded"] = any(m == "jax" or m.startswith(("jax.",
                                                         "matrel_tpu."))
                            for m in sys.modules)
    mesh_lib.shutdown_distributed()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _run_world(name, tmp_dir):
    import torch.multiprocessing as mp
    grid = WORLDS[name]
    timeout = JOIN_TIMEOUT_S[name]
    n = grid[0] * grid[1]
    store = os.path.join(tmp_dir, "store")
    os.environ["OMP_NUM_THREADS"] = "1"
    ctx = mp.start_processes(_rank_main, args=(n, grid, store, tmp_dir),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"world {grid} did not finish in "
                                   f"{timeout} s")
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
def serve_world(tmp_path_factory):
    """The (1, 2) world's ranks' results (one spawn per test process)."""
    return _run_world("1x2", str(tmp_path_factory.mktemp("1x2")))


@pytest.fixture(scope="module")
def fleet_world(tmp_path_factory):
    """The (2, 4) world's ranks' results (one spawn per test process)."""
    return _run_world("2x4", str(tmp_path_factory.mktemp("2x4")))


# -- the test side ------------------------------------------------------------


def _jax_mesh(grid):
    import jax
    from matrel_tpu.core import mesh as mesh_lib
    return mesh_lib.make_mesh(grid, devices=jax.devices()[:grid[0]
                                                          * grid[1]])


def _f64():
    return {k: v.astype(np.float64) for k, v in _tables().items()}


def _assert_same_on_ranks(ranks, key):
    for r in ranks[1:]:
        assert r[key] == ranks[0][key], key


def test_reproducer_matches_numpy_and_jax(serve_world):
    """The three queries over one shared product answer numpy's (float64)
    and the JAX package's ``submit`` on its (1, 2) mesh on BOTH ranks,
    one rank staggered."""
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.session import MatrelSession as JSession
    t = _f64()
    sh = t["A"] @ t["B"]
    want = [sh @ t["A"], (sh @ t["B"]) * 2.0, sh + t["A"]]
    jsess = _session(JSession, JConfig, _jax_mesh((1, 2)),
                     serve_max_batch=8, cse_enable=True)
    jax_out = [np.asarray(f.result(timeout=60).to_numpy())
               for f in [jsess.submit(q) for q in
                         _reproducer_queries(jsess)]]
    jsess.serve_close()
    for r in serve_world:
        got = r["reproducer"]["out"]
        assert [g[0] for g in got] == ["ok"] * 3, got
        for (_s, g), w, j in zip(got, want, jax_out):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(g, j, rtol=1e-4, atol=1e-4)
        assert r["reproducer"]["counters"]["divergences"] == 0


@pytest.mark.parametrize("case", SERVE_CASES)
def test_counters_agree_on_ranks(serve_world, case):
    """Every counter the plane reports is equal on both ranks, and so is
    every answer (the same typed error where there is one)."""
    ranks = [r[case] for r in serve_world]
    _assert_same_on_ranks(ranks, "counters")
    for a, b in zip(ranks[0]["out"], ranks[1]["out"]):
        assert a[0] == b[0]
        if a[0] == "ok":
            np.testing.assert_array_equal(a[1], b[1])
        else:
            assert a[1] == b[1]
    assert [r["log"]["cycles"] for r in ranks] == \
        [ranks[0]["log"]["cycles"]] * 2


def test_follower_deadline_follows_the_lead(serve_world):
    """The deadline had expired on the follower's clock when the lead
    admitted the query on its own: both ranks serve it."""
    t = _f64()
    for r in serve_world:
        got = r["follower_deadline"]
        assert got["out"][0][0] == "ok"
        np.testing.assert_allclose(got["out"][0][1], t["A"] + t["B"],
                                   rtol=1e-6, atol=1e-6)
        assert got["counters"]["deadline_misses"] == 0


def test_open_breaker_fails_fast_on_every_rank(serve_world):
    ranks = [r["breaker"] for r in serve_world]
    for got in ranks:
        assert [o[1] for o in got["out"]] == ["InjectedFault",
                                              "CircuitOpen"]
        assert len(got["breakers"]["open"]) == 1
    _assert_same_on_ranks(ranks, "breakers")


def test_brownout_rung_agrees(serve_world):
    ranks = [r["brownout"] for r in serve_world]
    _assert_same_on_ranks(ranks, "brownout")
    assert ranks[0]["brownout"]["max_rung_seen"] >= 1
    t = _f64()
    for got in ranks:
        for k, (s, g) in enumerate(got["out"]):
            assert s == "ok"
            # rung 1 downshifts to the "fast" tier
            np.testing.assert_allclose(g, t["A"] * (k + 1) + t["B"],
                                       rtol=2e-2, atol=2e-2)


def test_result_cache_hit_on_every_rank(serve_world):
    ranks = [r["cache_hit"] for r in serve_world]
    _assert_same_on_ranks(ranks, "rc")
    assert ranks[0]["rc"]["hits"] >= 1
    for got in ranks:
        np.testing.assert_array_equal(got["out"][0][1], got["out"][1][1])


def test_mismatched_submission_fails_typed(serve_world):
    """A different query under one sequence number fails with
    ``RankDivergence`` on both ranks well inside the join timeout, and
    the plane serves the next (matching) query."""
    t = _f64()
    for r in serve_world:
        got = r["mismatch"]
        assert got["out"][0] == ("err", "RankDivergence")
        assert got["seconds"] < JOIN_TIMEOUT_S["1x2"] / 4
        assert got["out"][1][0] == "ok"
        np.testing.assert_allclose(got["out"][1][1], t["A"] - t["B"],
                                   rtol=1e-6, atol=1e-6)
        assert got["counters"]["divergences"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(request, world):
    ranks = request.getfixturevalue(
        "serve_world" if world == "1x2" else "fleet_world")
    assert not any(r["jax_loaded"] for r in ranks)


# -- the fleet -----------------------------------------------------------------


def _jax_fleet(n_slices, case):
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.session import MatrelSession as JSession
    return _fleet_scenario(JSession, JConfig, _jax_mesh((2, 4)), n_slices,
                           case)


@pytest.mark.parametrize("case", FLEET_CASES)
@pytest.mark.parametrize("n_slices", SLICES)
def test_fleet_on_ranks_matches_jax(fleet_world, n_slices, case):
    """fleet_info is equal on every rank and to the JAX package's on
    ``mesh8`` for the same sequence; every answer equals the JAX
    package's at rtol = atol = 1e-4."""
    ranks = [r[(n_slices, case)] for r in fleet_world]
    _assert_same_on_ranks(ranks, "info")
    _assert_same_on_ranks(ranks, "slices")
    want = _jax_fleet(n_slices, case)
    assert ranks[0]["info"] == want["info"]
    assert ranks[0]["slices"] == want["slices"]
    for got in ranks:
        assert [o[0] for o in got["out"]] == [o[0] for o in want["out"]]
        for g, w in zip(got["out"], want["out"]):
            if g[0] == "ok":
                np.testing.assert_allclose(g[1], w[1], rtol=1e-4,
                                           atol=1e-4)
            else:           # the same typed error, with the same text
                assert g == w


@pytest.mark.parametrize("n_slices", SLICES)
def test_router_backlog_bound_sheds_typed(fleet_world, n_slices):
    """A query that finds its tenant's backlog at the bound is shed with
    ``AdmissionShed`` on every rank alike; the others answer numpy's."""
    t = _f64()
    ranks = [r[(n_slices, "backlog")] for r in fleet_world]
    _assert_same_on_ranks(ranks, "sheds")
    kinds = [[o[0] if o[0] == "ok" else o[1] for o in r["out"]]
             for r in ranks]
    assert all(k == kinds[0] for k in kinds)
    assert kinds[0][0] == "ok" and "AdmissionShed" in kinds[0]
    assert ranks[0]["sheds"] == {"tenantA": kinds[0].count("AdmissionShed")}
    for got in ranks:
        for i, o in enumerate(got["out"]):
            if o[0] == "ok":
                np.testing.assert_allclose(
                    o[1], (t["A"] @ t["B"]) * (i + 1), rtol=1e-4,
                    atol=1e-4)


@pytest.mark.parametrize("n_slices", SLICES)
def test_sparse_and_coo_tables_serve_on_slices(fleet_world, n_slices):
    """A COO matvec (B2's route) and S·D (B1's) placed on slices answer
    as float64 numpy does; the repeats are directory hits; counters are
    equal on every rank."""
    ranks = [r[(n_slices, "slice_tables")] for r in fleet_world]
    _assert_same_on_ranks(ranks, "info")
    info = ranks[0]["info"]
    assert info["placed"] == {"slice": 2, "span": 0}
    assert info["directory"]["hits"] == 2
    r, c, v, x = _coo_edges()
    E = np.zeros((COO_N, COO_N))
    np.add.at(E, (r, c), v.astype(np.float64))
    t = _f64()
    S = t["A"] * (np.abs(t["A"]) > 1.0)
    want = [E @ x, S @ t["B"]] * 2
    for got in ranks:
        for (s, g), w in zip(got["out"], want):
            assert s == "ok"
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def _slice_of(rank: int, n_slices: int) -> int:
    return rank // (8 // n_slices)


@pytest.mark.parametrize("n_slices", SLICES)
def test_slices_overlap(fleet_world, n_slices):
    """Four slowed queries on the slices finish in under 3 × SLOW_S on
    every rank (serialised slices took 4 ×); each slice's pipeline
    agrees on its own control group, its first rank the lead."""
    per = 8 // n_slices
    for r, got in enumerate(fleet_world):
        run = got[(n_slices, "overlap")]
        assert run["seconds"] < 3 * SLOW_S, (r, run["seconds"])
        sid = _slice_of(r, n_slices)
        assert run["logs"] == {sid: (sid * per, per)}


@pytest.mark.parametrize("n_slices", SLICES)
def test_queued_entry_requeued_on_failover(fleet_world, n_slices):
    """``kill_slice(0)`` while slice 0 runs one query and holds another
    in its queue: the queued one re-admits onto a survivor (``requeued``
    1 on every rank, the JAX package's count on ``mesh8``), the running
    one completes on the dead slice, every answer float64 numpy's."""
    want = _jax_fleet(n_slices, "queued_failover")
    t = _f64()
    base = t["A"] @ t["B"]
    scales = [1.0] + [float(i + 1) for i in range(1, n_slices + 1)]
    for got in (r[(n_slices, "queued_failover")] for r in fleet_world):
        assert got["requeued"] == want["requeued"] >= 1
        assert got["info"]["requeued"] == got["requeued"]
        assert got["slices"][0]["alive"] is False
        for (s, g), k in zip(got["out"], scales):
            assert s == "ok"
            np.testing.assert_allclose(g, base * k, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_slices", SLICES)
def test_placement_reads_slice_loads(fleet_world, n_slices):
    """With slice 0 busy and one query waiting there, the next queries
    go to the idle slices, the last one at a round-robin tick that
    points at slice 0 too: slice 0 took 2 queries, as
    ``placement.pick_slice`` decides in the JAX package."""
    want = _jax_fleet(n_slices, "by_load")
    assert want["slices"][0]["submitted"] == 2
    for got in (r[(n_slices, "by_load")] for r in fleet_world):
        assert got["slices"] == want["slices"]
        assert got["info"]["placed"] == {"slice": 2 * n_slices + 1,
                                         "span": 0}


@pytest.mark.parametrize("n_slices", SLICES)
def test_check_health_fails_over_a_wedged_slice(fleet_world, n_slices):
    """A slice whose worker died with a query waiting is failed over on
    every rank alike: the query answers through a survivor."""
    t = _f64()
    for got in (r[(n_slices, "wedged")] for r in fleet_world):
        assert got["info"]["failovers"] == 1
        assert got["info"]["requeued"] == 1
        assert got["slices"][0]["alive"] is False
        s, g = got["out"][-1]
        assert s == "ok"
        np.testing.assert_allclose(g, (t["A"] @ t["B"]) * (n_slices + 1),
                                   rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("n_slices", SLICES)
def test_failing_query_same_error_in_and_out_of_slice(fleet_world,
                                                      n_slices):
    """The poisoned query runs on slice 1: its ranks and every other
    rank raise the same typed error with the same text."""
    outs = [r[(n_slices, "failing")]["out"][1] for r in fleet_world]
    assert outs == [("err", "ValueError", "poison query")] * 8
