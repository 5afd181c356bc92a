"""PyTorch port: the serving plane held against the JAX package on the
CPU — the cross-query result cache (hits, interior substitution with its
``result_cache`` stamps and ``rc_operands`` decision records, transitive
rebind invalidation, pins, byte/entry-budgeted LRU eviction, the
cache-off bit identity), ``run_many``'s cache cases, the ``submit``
pipeline (futures, cancellation, deadlines, bisection, drain/close,
typed sheds), the per-tenant ``AdmissionQueue`` (mirroring
``tests/test_overload.py::TestAdmissionQueue``), ``result_cache_info``
and the serve knobs' validation.

Both packages run the same queries over matrices made from the same
seeded numpy arrays (the JAX package on a 1 x 1 mesh, the port on the
CPU). Results agree within the JAX tests' tolerances (rtol/atol 3e-4
against float64 numpy for products, 1e-5 between the packages) and
exactly where the JAX test asserts equality; cache counters, keys with
their id() tokens numbered by first appearance, stamps (less the
id-derived ``key_hash``, checked against each package's own key) and
entry metadata are equal. Every future wait, drain and close carries a
timeout, and every pipeline is closed in teardown.
"""

import gc
import hashlib
import queue
import re
import time
import weakref
from concurrent.futures import Future

import jax
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.serve.admission import AdmissionQueue as JAdmissionQueue
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch import executor as t_exec
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.resilience import errors as rerrors
from matrel_tpu_torch.resilience.retry import Deadline
from matrel_tpu_torch.serve.admission import AdmissionQueue
from matrel_tpu_torch.serve.pipeline import ServePipeline
from matrel_tpu_torch.serve.result_cache import ResultCache
from matrel_tpu_torch.session import MatrelSession, _plan_key

RC = dict(result_cache_max_bytes=64 << 20)
WAIT_S = 60.0


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture()
def closers():
    """Sessions registered here have their pipelines closed in teardown
    (with a timeout), whatever the test did."""
    live = []
    yield live
    for s in live:
        if getattr(s, "_serve", None) is not None:
            s._serve.close(timeout=WAIT_S)


def twins(jmesh, closers=None, **cfg):
    js = JSession(mesh=jmesh, config=JConfig(**cfg))
    ts = MatrelSession(config=MatrelConfig(**cfg), device="cpu")
    if closers is not None:
        closers.extend([js, ts])
    return js, ts


def mats(js, ts, arr, **kw):
    return js.from_numpy(arr, **kw), ts.from_numpy(arr, **kw)


def rand(rng, n, m):
    return rng.standard_normal((n, m)).astype(np.float32)


_ID = re.compile(r"((?:sparse_leaf|coo_leaf|leaf|fnid|fnrec|cyc|cell|"
                 r"obj:\w+|bigcont:\w+):)(\d+)")


def norm(key: str) -> str:
    """A key with its id() tokens numbered by first appearance."""
    ids: dict = {}
    return _ID.sub(lambda m: m.group(1)
                   + f"#{ids.setdefault(m.group(2), len(ids))}", key)


def entries(sess):
    """The cache's entries in LRU order, id-free."""
    out = []
    for k, e in sess._result_cache.items_snapshot():
        assert e.key_hash == hashlib.sha1(k.encode()).hexdigest()[:16]
        out.append((norm(k), e.layout, e.dtype, e.nbytes, e.prec,
                    e.err_bound, e.delta_gen, e.delta_rule,
                    len(e.dep_ids)))
    return out


def same_state(js, ts):
    assert ts.result_cache_info() == js.result_cache_info()
    assert entries(ts) == entries(js)


def records_equal(got, want):
    """Decision records equal field for field but the package-local
    node uid (floats to 1e-12 relative)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = {k: v for k, v in g.items() if k != "uid"}
        w = {k: v for k, v in w.items() if k != "uid"}
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            if isinstance(w[k], (float, list)):
                assert g[k] == pytest.approx(w[k], rel=1e-12), k
            else:
                assert g[k] == w[k], k


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(got.to_numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


# -- result-cache hits ---------------------------------------------------------


class TestResultCacheHits:
    def test_repeated_query_answers_from_cache(self, jmesh, rng):
        js, ts = twins(jmesh, **RC)
        jX, tX = mats(js, ts, rand(rng, 64, 16))
        for s, X in ((js, jX), (ts, tX)):
            gram = X.expr().t().multiply(X.expr())
            r1 = s.run(gram)
            assert s.run(gram) is r1
        assert ts.result_cache_info()["entries"] == 1
        assert ts.result_cache_info()["hits"] == 1
        same_state(js, ts)

    def test_structurally_identical_fresh_expr_hits(self, jmesh, rng):
        js, ts = twins(jmesh, **RC)
        jX, tX = mats(js, ts, rand(rng, 64, 16))
        for s, X in ((js, jX), (ts, tX)):
            r1 = s.run(X.expr().t().multiply(X.expr()))
            assert s.run(X.expr().t().multiply(X.expr())) is r1
        same_state(js, ts)

    def test_interior_subplan_enters_planning_as_leaf(self, jmesh, rng):
        js, ts = twins(jmesh, **RC)
        xn, yn = rand(rng, 64, 16), rand(rng, 64, 1)
        (jX, tX), (jy, ty) = mats(js, ts, xn), mats(js, ts, yn)
        want = xn.T @ xn @ (xn.T @ yn)
        stamps = []
        for s, X, y in ((js, jX, jy), (ts, tX, ty)):
            gram = X.expr().t().multiply(X.expr())
            s.run(gram)
            out = s.run(gram.multiply(X.expr().t().multiply(y.expr())))
            close(out, want, 3e-4)
            plan = list(s._plan_cache.values())[-1]
            got = [l.attrs["result_cache"] for l in plan.leaf_order
                   if l.attrs.get("result_cache")]
            assert len(got) == 1
            st = dict(got[0])
            key = [k for k, e in s._result_cache.items_snapshot()
                   if e.key_hash == st["key_hash"]]
            assert len(key) == 1         # the stamp names a live entry
            st["deps"] = len(st.pop("deps"))
            st.pop("key_hash")
            stamps.append(st)
        assert stamps[1] == stamps[0]
        same_state(js, ts)

    def test_matmul_decisions_record_rc_operands(self, jmesh, rng):
        js, ts = twins(jmesh, **RC)
        (jX, tX), (jB, tB) = (mats(js, ts, rand(rng, 64, 16)),
                              mats(js, ts, rand(rng, 16, 16)))
        from matrel_tpu import executor as j_exec
        decs = []
        for s, X, B, ex in ((js, jX, jB, j_exec), (ts, tX, tB, t_exec)):
            gram = X.expr().t().multiply(X.expr())
            s.run(gram)
            s.run(gram.multiply(B.expr()))
            plan = list(s._plan_cache.values())[-1]
            decs.append(ex.plan_matmul_decisions(plan))
        assert [True, False] in [d.get("rc_operands") for d in decs[1]]
        records_equal(decs[1], decs[0])


# -- invalidation and pins -----------------------------------------------------


class TestInvalidation:
    def test_catalog_rebind_invalidates_dependents(self, jmesh, rng):
        js, ts = twins(jmesh, **RC)
        a, b = rand(rng, 32, 32), rand(rng, 32, 32)
        for s in (js, ts):
            s.register("A", s.from_numpy(a))
            s.run(s.table("A").expr().t().multiply(s.table("A").expr()))
            assert s.result_cache_info()["entries"] == 1
            s.register("A", s.from_numpy(b))
            info = s.result_cache_info()
            assert info["entries"] == 0 and info["invalidated"] == 1
        same_state(js, ts)

    def test_invalidation_cascades_through_derived_entries(self, jmesh,
                                                           rng):
        js, ts = twins(jmesh, **RC)
        a, c = rand(rng, 32, 16), rand(rng, 16, 16)
        for s in (js, ts):
            A, C = s.from_numpy(a), s.from_numpy(c)
            s.register("A", A)
            gram = A.expr().t().multiply(A.expr())
            s.run(gram)
            s.run(gram.multiply(C.expr()))
            assert s.result_cache_info()["entries"] == 2
            s.register("A", C)
            assert s.result_cache_info()["entries"] == 0
        same_state(js, ts)

    @pytest.mark.parametrize("rebind", ["unrelated", "same_object"])
    def test_rebind_that_keeps_entries(self, jmesh, rng, rebind):
        js, ts = twins(jmesh, **RC)
        a, b, c = (rand(rng, 32, 32) for _ in range(3))
        for s in (js, ts):
            A = s.from_numpy(a)
            s.register("A", A)
            s.register("B", s.from_numpy(b))
            s.run(A.expr().t().multiply(A.expr()))
            if rebind == "unrelated":
                s.register("B", s.from_numpy(c))
            else:
                s.register("A", A)
            info = s.result_cache_info()
            assert info["entries"] == 1 and info["invalidated"] == 0
        same_state(js, ts)

    def test_pins_hold_every_keyed_object(self, rng):
        """The key names its matrices by id(): the entry's pins keep
        them (and their tensors) alive, so no address is recycled into
        a false hit; dropping the entry (and the plan that pins them
        too) releases them."""
        ts = MatrelSession(config=MatrelConfig(**RC), device="cpu")
        A = ts.from_numpy(rand(rng, 32, 32))
        ref_m, ref_t = weakref.ref(A), weakref.ref(A.data)
        key = _plan_key(A.expr().t().multiply(A.expr()))[0]
        ts.run(A.expr().t().multiply(A.expr()))
        del A
        gc.collect()
        assert ref_m() is not None and ref_t() is not None
        (k, ent), = ts._result_cache.items_snapshot()
        assert k == key and ref_m() in ent.pins
        ts._result_cache.clear()
        del ent
        gc.collect()
        # the compiled plan pins it too (the plan cache's own contract)
        assert ref_m() is not None
        ts._plan_cache.clear()
        gc.collect()
        assert ref_m() is None and ref_t() is None


# -- eviction ------------------------------------------------------------------


class TestEviction:
    def test_byte_budget_evicts_lru_order(self, jmesh, rng):
        # each 32x32 f32 result pins 4096 bytes; the budget holds 2
        js, ts = twins(jmesh, result_cache_max_bytes=2 * 32 * 32 * 4)
        arrs = [rand(rng, 32, 32) for _ in range(3)]
        for s in (js, ts):
            qs = [s.from_numpy(x) for x in arrs]
            qs = [m.expr().t().multiply(m.expr()) for m in qs]
            s.run(qs[0])
            s.run(qs[1])
            s.run(qs[2])                    # evicts qs[0] (LRU)
            info = s.result_cache_info()
            assert info["entries"] == 2 and info["evicted"] == 1
            hits = info["hits"]
            s.run(qs[0])                    # misses, evicts qs[1]
            assert s.result_cache_info()["hits"] == hits
            s.run(qs[2])
            assert s.result_cache_info()["hits"] == hits + 1
        same_state(js, ts)

    def test_hit_refreshes_lru_position(self, jmesh, rng):
        js, ts = twins(jmesh, result_cache_max_bytes=2 * 32 * 32 * 4)
        arrs = [rand(rng, 32, 32) for _ in range(3)]
        for s in (js, ts):
            qs = [s.from_numpy(x) for x in arrs]
            qs = [m.expr().t().multiply(m.expr()) for m in qs]
            r0 = s.run(qs[0])
            s.run(qs[1])
            assert s.run(qs[0]) is r0
            s.run(qs[2])                    # evicts qs[1], not qs[0]
            assert s.run(qs[0]) is r0
        same_state(js, ts)

    @pytest.mark.parametrize("cfg,entries_left", [
        (dict(result_cache_max_bytes=64 << 20,
              result_cache_max_entries=2), 2),
        (dict(result_cache_max_bytes=64), 0),
    ], ids=["entry_count_bound", "oversized_never_inserted"])
    def test_bounds(self, jmesh, rng, cfg, entries_left):
        js, ts = twins(jmesh, **cfg)
        arrs = [rand(rng, 32, 32) for _ in range(3)]
        for s in (js, ts):
            for x in arrs:
                m = s.from_numpy(x)
                s.run(m.expr().t().multiply(m.expr()))
            assert s.result_cache_info()["entries"] == entries_left
        same_state(js, ts)

    def test_bf16_results_size_as_two_bytes(self, rng):
        """The port sizes a result by ``numel() * element_size()`` of its
        padded tensor (the JAX package's numpy sizing has no bf16)."""
        ts = MatrelSession(config=MatrelConfig(**RC), device="cpu")
        X = ts.from_numpy(rand(rng, 32, 16), dtype="bfloat16")
        out = ts.run(X.expr().multiply_scalar(2.0))
        assert out.data.dtype == torch.bfloat16
        (_k, ent), = ts._result_cache.items_snapshot()
        assert ent.nbytes == out.data.numel() * 2
        assert ent.dtype == "bfloat16"


# -- cache off: bit identity ---------------------------------------------------


class TestCacheOffBitIdentical:
    def test_default_is_off(self):
        assert MatrelConfig().result_cache_max_bytes == 0 \
            == JConfig().result_cache_max_bytes

    def test_off_path_never_touches_the_cache(self, rng, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("result cache consulted while off")
        for name in ("lookup", "probe", "put"):
            monkeypatch.setattr(ResultCache, name, boom)
        ts = MatrelSession(device="cpu")
        A = ts.from_numpy(rand(rng, 32, 32))
        ts.run(A.expr().t().multiply(A.expr()))
        ts.run_many([A.expr().t()])

    def test_off_plans_and_results_unchanged(self, jmesh, rng):
        js, ts = twins(jmesh)
        xn = rand(rng, 64, 16)
        jX, tX = mats(js, ts, xn)
        keys = []
        for s, X in ((js, jX), (ts, tX)):
            e = X.expr().t().multiply(X.expr())
            plan, _hit, got_key = s._compile_entry(e)
            keys.append(norm(got_key))
            assert all(l.attrs.get("result_cache") is None
                       for l in plan.leaf_order)
            close(s.run(e), xn.T @ xn, 3e-4)
        assert keys[1] == keys[0]
        assert keys[1] == norm(_plan_key(tX.expr().t().multiply(
            tX.expr()))[0])

    def test_cached_results_match_uncached(self, rng):
        on = MatrelSession(config=MatrelConfig(**RC), device="cpu")
        off = MatrelSession(device="cpu")
        xn, yn = rand(rng, 64, 16), rand(rng, 64, 1)
        X, y = on.from_numpy(xn), on.from_numpy(yn)
        gram = X.expr().t().multiply(X.expr())
        q2 = gram.multiply(X.expr().t().multiply(y.expr()))
        for q in (gram, q2, gram, q2):
            np.testing.assert_allclose(on.run(q).to_numpy(),
                                       off.run(q).to_numpy(),
                                       rtol=1e-5, atol=1e-5)


# -- run_many's cache cases ----------------------------------------------------


class TestRunMany:
    def test_batch_with_result_cache(self, jmesh, rng):
        js, ts = twins(jmesh, **RC)
        a = rand(rng, 32, 32)
        for s in (js, ts):
            A = s.from_numpy(a)
            q = A.expr().t().multiply(A.expr())
            first = s.run_many([q, q.multiply_scalar(2.0)])
            again = s.run_many([q, q.multiply_scalar(2.0)])
            assert again[0] is first[0] and again[1] is first[1]
        same_state(js, ts)

    def test_batch_interior_hit_and_input_order(self, jmesh, rng):
        js, ts = twins(jmesh, **RC)
        a, b = rand(rng, 32, 16), rand(rng, 16, 32)
        outs = []
        for s in (js, ts):
            A, B = s.from_numpy(a), s.from_numpy(b)
            ab = A.expr().multiply(B.expr())
            s.run(ab)                      # the interior, cached
            got = s.run_many([ab.multiply_scalar(3.0), A.expr().t(), ab])
            outs.append([o.to_numpy() for o in got])
            assert s.result_cache_info()["interior_hits"] == 1
        for g, j in zip(outs[1], outs[0]):
            np.testing.assert_allclose(g, j, rtol=1e-5, atol=1e-5)
        same_state(js, ts)

    def test_deadline_and_tenant_arguments(self, jmesh, rng):
        js, ts = twins(jmesh, **RC)
        a = rand(rng, 16, 16)
        for s in (js, ts):
            A = s.from_numpy(a)
            out, = s.run_many([A.expr().t()], deadline_ms=60_000.0,
                              tenant="a")
            close(out, a.T)
        # the brownout rung the pipeline admits a batch under is
        # accepted (it rides the serve event)
        out, = ts.run_many([ts.from_numpy(a).expr()], _brownout_rung=1)
        close(out, a)

    def test_empty_batch(self):
        assert MatrelSession(device="cpu").run_many([]) == []


# -- futures -------------------------------------------------------------------


class TestFutures:
    def test_submit_result_matches_compute(self, jmesh, rng, closers):
        js, ts = twins(jmesh, closers, **RC)
        an = rand(rng, 32, 16)
        for s in (js, ts):
            A = s.from_numpy(an)
            out = s.submit(A.expr().t().multiply(A.expr())).result(
                timeout=WAIT_S)
            close(out, an.T @ an, 3e-4)
            s.serve_drain(timeout=WAIT_S)
        assert ts._serve._worker.name == "matrel-serve"
        same_state(js, ts)

    def test_submit_many_all_resolve(self, jmesh, rng, closers):
        js, ts = twins(jmesh, closers, **RC)
        an = rand(rng, 32, 32)
        for s in (js, ts):
            A = s.from_numpy(an)
            futs = [s.submit(A.expr().multiply_scalar(float(k)))
                    for k in range(6)]
            s.serve_drain(timeout=WAIT_S)
            for k, f in enumerate(futs):
                close(f.result(timeout=WAIT_S), an * k)
        assert ts.result_cache_info()["entries"] == 6
        assert ts.result_cache_info() == js.result_cache_info()

    def test_cancelled_future_does_not_kill_worker(self, rng):
        ts = MatrelSession(config=MatrelConfig(**RC), device="cpu")
        pl = ServePipeline(ts)
        try:
            A = ts.from_numpy(rand(rng, 32, 32))
            f_cancel, f_ok = Future(), Future()
            pl._q.put((A.expr().t(), f_cancel, time.perf_counter()))
            pl._q.put((A.expr().multiply_scalar(2.0), f_ok,
                       time.perf_counter()))
            assert f_cancel.cancel()
            pl._ensure_worker()
            out = f_ok.result(timeout=WAIT_S)
            np.testing.assert_allclose(out.to_numpy(), 2 * A.to_numpy(),
                                       rtol=1e-6, atol=1e-6)
            assert f_cancel.cancelled()
            pl.drain(timeout=WAIT_S)
            assert pl._worker.is_alive()
        finally:
            pl.close(timeout=WAIT_S)

    def test_submit_exception_propagates_and_bisects(self, jmesh, rng,
                                                     closers):
        js, ts = twins(jmesh, closers, join_pair_cap_entries=4)
        an, bn = rand(rng, 32, 1), rand(rng, 32, 1)
        for s in (js, ts):
            A, B = s.from_numpy(an), s.from_numpy(bn)
            bad = s.submit(A.expr().join_on_value(B.expr(), merge="add"))
            with pytest.raises(ValueError, match="join_pair_cap_entries"):
                bad.result(timeout=WAIT_S)
            ok = s.submit(A.expr().t())
            close(ok.result(timeout=WAIT_S), an.T, 1e-6)
            s.serve_drain(timeout=WAIT_S)

    def test_poison_query_isolated_in_its_batch(self, rng):
        """A batch holding one failing query bisects: only that future
        fails, its siblings resolve."""
        ts = MatrelSession(config=MatrelConfig(join_pair_cap_entries=4),
                           device="cpu")
        pl = ServePipeline(ts)
        try:
            A = ts.from_numpy(rand(rng, 32, 1))
            B = ts.from_numpy(rand(rng, 32, 1))
            qs = [A.expr().multiply_scalar(1.0),
                  A.expr().join_on_value(B.expr(), merge="add"),
                  A.expr().multiply_scalar(3.0),
                  B.expr().t()]
            futs = [Future() for _ in qs]
            for q, f in zip(qs, futs):
                pl._q.put((q, f, time.perf_counter()))
            pl._ensure_worker()
            with pytest.raises(ValueError):
                futs[1].result(timeout=WAIT_S)
            for k in (0, 2, 3):
                assert futs[k].result(timeout=WAIT_S).shape \
                    == qs[k].shape
            assert pl.batches == 2          # [0] and [2, 3] succeed
        finally:
            pl.close(timeout=WAIT_S)

    @pytest.mark.parametrize("where", ["queued", "config"])
    def test_expired_deadline_fails_typed(self, rng, closers, where):
        cfg = dict(RC, deadline_ms=0.001) if where == "config" else RC
        ts = MatrelSession(config=MatrelConfig(**cfg), device="cpu")
        closers.append(ts)
        A = ts.from_numpy(rand(rng, 16, 16))
        kw = {"deadline_ms": 0.001} if where == "queued" else {}
        fut = ts.submit(A.expr().t(), **kw)
        with pytest.raises(rerrors.DeadlineExceeded):
            fut.result(timeout=WAIT_S)
        assert ts._serve.deadline_misses == 1
        ts.serve_drain(timeout=WAIT_S)

    def test_concurrent_submit_stress(self, rng, closers):
        """More client threads than cores, a shortened switch interval:
        every future resolves to the right answer, and the cache's
        counters lose no update (hits + misses = submissions, one miss
        per distinct query once the first answers are in)."""
        import sys
        import threading
        ts = MatrelSession(config=MatrelConfig(
            serve_tenant_weights="a:3,b:1", serve_max_batch=4, **RC),
            device="cpu")
        closers.append(ts)
        A = ts.from_numpy(rand(rng, 16, 16))
        scales = [1.0, 2.0, 3.0]
        for k in scales:                    # the first computations
            ts.submit(A.expr().multiply_scalar(k)).result(timeout=WAIT_S)
        n_threads, per = 24, 10
        errors, done = [], []
        old = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            def client(i):
                try:
                    for j in range(per):
                        k = scales[(i + j) % len(scales)]
                        out = ts.submit(A.expr().multiply_scalar(k),
                                        tenant="ab"[i % 2]).result(
                                            timeout=WAIT_S)
                        if not torch.equal(out.data, A.data * k):
                            errors.append((i, j))
                        done.append(1)
                except BaseException as ex:   # noqa: BLE001 — reported
                    errors.append(ex)
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT_S)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old)
        assert errors == [] and len(done) == n_threads * per
        info = ts.result_cache_info()
        assert info["misses"] == len(scales)
        assert info["hits"] == n_threads * per
        ts.serve_drain(timeout=WAIT_S)

    def test_ready_event_and_inflight_bound(self, rng, closers):
        ts = MatrelSession(config=MatrelConfig(serve_max_inflight=1,
                                               serve_max_batch=2),
                           device="cpu")
        closers.append(ts)
        A = ts.from_numpy(rand(rng, 16, 16))
        futs = [ts.submit(A.expr().multiply_scalar(float(k)))
                for k in range(5)]
        for f in futs:
            f.result(timeout=WAIT_S)
            assert f.ready_event is None          # the CPU: no event
        ts.serve_drain(timeout=WAIT_S)
        assert ts._serve.inflight_depth == 0

    def test_close_then_submit_raises_typed(self, rng):
        ts = MatrelSession(device="cpu")
        A = ts.from_numpy(rand(rng, 8, 8))
        ts.submit(A.expr().t()).result(timeout=WAIT_S)
        ts.serve_close(timeout=WAIT_S)
        with pytest.raises(rerrors.PipelineClosed):
            ts.submit(A.expr().t())

    def test_drain_timeout_on_a_wedged_batch(self, rng):
        """A dispatched batch whose event never completes: drain gives up
        typed within its budget and keeps the batch for a later drain."""
        from matrel_tpu_torch.serve import pipeline as pl_lib

        class Wedged:
            def query(self):
                return False

            def synchronize(self):
                raise AssertionError("an unbounded wait on a wedge")

        ts = MatrelSession(device="cpu")
        pl = ServePipeline(ts)
        pl._inflight.append(pl_lib.Dispatched((), Wedged()))
        t0 = time.perf_counter()
        with pytest.raises(rerrors.DrainTimeout):
            pl.drain(timeout=0.05)
        assert time.perf_counter() - t0 < 5.0
        assert pl.inflight_depth == 1
        pl._inflight.clear()
        pl.close(timeout=WAIT_S)

    def test_tenant_quota_sheds_at_submit(self, rng):
        ts = MatrelSession(config=MatrelConfig(
            serve_tenant_weights="a:2,b:1", serve_tenant_queue_max=1),
            device="cpu")
        pl = ts._ensure_serve()
        A = ts.from_numpy(rand(rng, 8, 8))
        # the worker is not started yet: the quota counts queued entries
        pl._q.put((A.expr().t(), Future(), time.perf_counter(),
                   "default", None, "a", None), "a")
        with pytest.raises(rerrors.AdmissionShed) as ei:
            pl.submit(A.expr().t(), tenant="a")
        assert ei.value.scope == "tenant" and ei.value.tenant == "a"
        pl._ensure_worker()
        ts.serve_close(timeout=WAIT_S)

    def test_fleet_and_durable_state_stay_fenced(self, rng, tmp_path):
        ts = MatrelSession(device="cpu")
        A = ts.from_numpy(rand(rng, 8, 8))
        # the default submit builds no fleet; fleet_slices >= 1 routes
        # the same query through a fleet (serve/fleet.py) whose slices
        # share the 1 x 1 grid, with the same answer
        assert ts.submit(A.expr().t()).result(timeout=WAIT_S) is not None
        assert ts._fleet is None and ts.fleet_info() is None
        ts.serve_close(timeout=WAIT_S)
        fs = MatrelSession(config=MatrelConfig(fleet_slices=2),
                           device="cpu")
        fA = fs.from_numpy(A.to_numpy())
        fs.register("A", fA)
        out = fs.submit(fA.expr().t()).result(timeout=WAIT_S)
        np.testing.assert_array_equal(out.to_numpy(), A.to_numpy().T)
        info = fs.fleet_info()
        assert info["source"] == "shared" and len(info["slices"]) == 2
        assert info["placed"] == {"slice": 1, "span": 0}
        fs.serve_close(timeout=WAIT_S)
        # the durable state is ported (serve/spill.py): without a
        # directory save_state and restore refuse as the JAX package's
        # do; an empty directory restores as a clean cold start
        with pytest.raises(ValueError, match="state_dir"):
            ts.save_state()
        with pytest.raises(ValueError, match="state_dir"):
            ts.restore()
        assert ts.restore(str(tmp_path))["reason"] == "no snapshot"


# -- the admission queue (tests/test_overload.py::TestAdmissionQueue) ----------


def _entry(expr=None, deadline=None, tenant=""):
    return (expr, Future(), time.perf_counter(), "default", deadline,
            tenant, None)


def _pops(q, n):
    return [q.get_nowait()[0] for _ in range(n)]


def _both(**cfg):
    return (JAdmissionQueue(JConfig(**cfg)),
            AdmissionQueue(MatrelConfig(**cfg)))


class TestAdmissionQueue:
    @pytest.mark.parametrize("weights,per_tenant,n_pop,want", [
        ("", None, 6, [0, 1, 2, 3, 4, 5]),
        ("a:3,b:1", 12, 8, {"a": 6, "b": 2}),
        ("a:3,b:1", 20, 4, {"a": 3, "b": 1}),
    ], ids=["implicit_fifo", "weighted_proportional", "fair_batch"])
    def test_pop_order(self, weights, per_tenant, n_pop, want):
        got = []
        for q in _both(serve_tenant_weights=weights):
            if per_tenant is None:
                for i in range(6):
                    q.put(_entry(expr=i))
            elif n_pop == 8:
                for i in range(per_tenant):
                    q.put(_entry(expr=("a", i), tenant="a"), "a")
                    q.put(_entry(expr=("b", i), tenant="b"), "b")
            else:
                for i in range(per_tenant):
                    q.put(_entry(expr=("a", i), tenant="a"), "a")
                for i in range(per_tenant):
                    q.put(_entry(expr=("b", i), tenant="b"), "b")
            got.append(_pops(q, n_pop))
        assert got[1] == got[0]
        if isinstance(want, dict):
            assert {t: [p[0] for p in got[1]].count(t) for t in want} \
                == want
        else:
            assert got[1] == want

    def test_tenant_order_within_tenant_is_fifo(self):
        q = AdmissionQueue(MatrelConfig(serve_tenant_weights="a:2,b:1"))
        for i in range(4):
            q.put(_entry(expr=("a", i)), "a")
        seq = []
        while True:
            try:
                seq.append(q.get_nowait()[0])
            except queue.Empty:
                break
        assert [i for t, i in seq if t == "a"] == [0, 1, 2, 3]

    def test_tenant_quota_sheds_before_global(self):
        for q in _both(serve_tenant_weights="a:2,b:1",
                       serve_tenant_queue_max=2, serve_queue_max=100):
            q.put(_entry(), "a")
            q.put(_entry(), "a")
            with pytest.raises(Exception) as ei:
                q.put(_entry(), "a")
            assert type(ei.value).__name__ == "AdmissionShed"
            assert ei.value.tenant == "a" and ei.value.scope == "tenant"
            q.put(_entry(), "b")
            assert q.counters()["sheds"] == {"a": 1}

    def test_global_bound_sheds_typed(self):
        q = AdmissionQueue(MatrelConfig(serve_queue_max=2))
        q.put(_entry())
        q.put(_entry())
        with pytest.raises(rerrors.AdmissionShed) as ei:
            q.put(_entry())
        assert ei.value.scope == "queue"

    def test_full_of_expired_queue_admits_fresh(self):
        q = AdmissionQueue(MatrelConfig(serve_queue_max=3))
        dead = []
        for _ in range(3):
            e = _entry(deadline=Deadline(0.0))
            dead.append(e[1])
            q.put(e)
        time.sleep(0.01)
        live = _entry()
        q.put(live)
        assert q.qsize() == 1
        for fut in dead:
            assert isinstance(fut.exception(timeout=1),
                              rerrors.DeadlineExceeded)
        assert q.counters()["purged_expired"] == 3
        assert not live[1].done()
        assert q.unfinished_tasks == 1

    def test_tenant_quota_purges_expired_first(self):
        q = AdmissionQueue(MatrelConfig(serve_tenant_weights="a:2,b:1",
                                        serve_tenant_queue_max=2))
        q.put(_entry(deadline=Deadline(0.0)), "a")
        q.put(_entry(deadline=Deadline(0.0)), "a")
        time.sleep(0.01)
        q.put(_entry(), "a")
        assert q.tenant_depths() == {"a": 1}

    def test_idle_tenant_banks_no_credit(self):
        got = []
        for q in _both(serve_tenant_weights="a:1,b:1"):
            for i in range(8):
                q.put(_entry(expr=("a", i)), "a")
            for _ in range(6):
                q.get_nowait()
            q.put(_entry(expr=("b", 0)), "b")
            q.put(_entry(expr=("b", 1)), "b")
            got.append([p[0] for p in _pops(q, 4)])
        assert got[1] == got[0]
        assert got[1].count("b") <= 2 and got[1].count("a") >= 2

    def test_lowest_weight_tenant_set(self):
        q = AdmissionQueue(MatrelConfig(serve_tenant_weights="a:4,b:1"))
        assert q.lowest_weight_tenant("b") is True
        assert q.lowest_weight_tenant("a") is False
        assert q.lowest_weight_tenant("zzz") is True
        assert AdmissionQueue(
            MatrelConfig()).lowest_weight_tenant("x") is False
        assert AdmissionQueue(MatrelConfig(
            serve_tenant_weights="a:2,b:2")).lowest_weight_tenant(
                "a") is False

    @pytest.mark.parametrize("spec", ["a", "a:0", "a:1,a:2", ":3", "a:x",
                                      ","])
    def test_malformed_weights_refused(self, spec):
        with pytest.raises(ValueError) as jerr:
            JConfig(serve_tenant_weights=spec)
        with pytest.raises(ValueError) as terr:
            MatrelConfig(serve_tenant_weights=spec)
        assert str(terr.value) == str(jerr.value)


# -- the info surface and the knobs --------------------------------------------


class TestResultCacheInfoSurface:
    def test_info_fields(self, jmesh):
        js, ts = twins(jmesh, **RC)
        info = ts.result_cache_info()
        assert info == js.result_cache_info()
        assert set(info) == {"entries", "bytes", "hits", "misses",
                             "interior_hits", "evicted", "invalidated",
                             "stale_entries", "stale_bytes",
                             "stale_hits", "max_bytes", "max_entries",
                             "patched", "rekeyed"}
        assert info["max_bytes"] == RC["result_cache_max_bytes"]
        assert info["max_entries"] == 256

    @pytest.mark.parametrize("knob,value", [
        ("result_cache_max_bytes", 1 << 20),
        ("result_cache_max_entries", 7),
        ("serve_max_batch", 3), ("serve_max_inflight", 5),
        ("serve_queue_max", 9), ("serve_tenant_weights", "gold:4,b:1"),
        ("serve_tenant_queue_max", 2), ("deadline_ms", 250.0),
        ("retry_max_attempts", 2), ("retry_backoff_ms", 5.0),
        ("retry_backoff_mult", 3.0), ("retry_jitter", 0.25),
        ("cse_enable", True), ("cse_min_uses", 3),
        ("cse_template_max", 4), ("delta_patch_mode", "off"),
        ("delta_rank_max", 64),
    ])
    def test_serve_knobs_are_live(self, knob, value):
        """The serve plane's knobs are live: each is accepted at a
        non-default value, as a keyword and through ``from_dict``, as
        the JAX package accepts it."""
        got = getattr(MatrelConfig(**{knob: value}), knob)
        assert got == getattr(JConfig(**{knob: value}), knob) == value
        assert MatrelConfig.from_dict({knob: value}) \
            == MatrelConfig(**{knob: value})

    @pytest.mark.parametrize("kw,needle", [
        ({"serve_max_batch": 0}, "serve_max_batch"),
        ({"serve_max_inflight": 0}, "serve_max_inflight"),
        ({"result_cache_max_entries": 0}, "result_cache_max_entries"),
        ({"retry_max_attempts": -1}, "retry_max_attempts"),
        ({"retry_backoff_mult": 0.5}, "retry backoff"),
        ({"deadline_ms": -1.0}, "deadline_ms"),
        ({"serve_queue_max": -1}, "serve_queue_max"),
        ({"serve_tenant_queue_max": -1}, "serve_tenant_queue_max"),
    ])
    def test_config_validates_serve_knobs(self, kw, needle):
        with pytest.raises(ValueError, match=needle):
            JConfig(**kw)
        with pytest.raises(ValueError, match=needle):
            MatrelConfig(**kw)


# -- the error taxonomy (tests/test_resilience.py's classification) ------------


def _named(name, msg=""):
    """An exception whose type carries ``name`` — the taxonomy matches
    runtime errors by type name, as torch moves their classes."""
    return type(name, (RuntimeError,), {})(msg)


class TestErrorTaxonomy:
    @pytest.mark.parametrize("exc,want", [
        (_named("OutOfMemoryError", "CUDA out of memory. Tried to "
                "allocate 2.00 GiB"), "transient"),
        (MemoryError(), "transient"),
        (RuntimeError("NCCL collective timed out"), "transient"),
        # sticky CUDA faults poison the context: a retry cannot succeed
        (_named("AcceleratorError", "CUDA error: an illegal memory "
                "access was encountered"), "deterministic"),
        (_named("AcceleratorError", "CUDA error: device-side assert "
                "triggered"), "deterministic"),
        (_named("AcceleratorError", "CUDA error: out of memory"),
         "transient"),
        (ValueError("shape mismatch"), "deterministic"),
        (_named("VerificationError", "out of memory"), "deterministic"),
        (rerrors.DeadlineExceeded(5.0, 9.0), "deterministic"),
        (rerrors.AdmissionShed(4), "deterministic"),
        (RuntimeError("some unknown failure"), "deterministic"),
    ])
    def test_classify(self, exc, want):
        assert rerrors.classify(exc) == want
        assert rerrors.is_transient(exc) == (want == "transient")

    def test_only_ported_planes_types(self):
        """The taxonomy holds the serve, resilience, durable and fleet
        planes' typed errors (injected faults, open breakers, checkpoint
        and spill corruption, a lost slice; corruption and a lost slice
        deterministic), and none of the XLA runtime's names."""
        import matrel_tpu_torch.resilience.errors as mod
        for have in ("InjectedFault", "CircuitOpen",
                     "CheckpointCorruption", "SnapshotCorruption"):
            assert hasattr(mod, have)
        assert issubclass(mod.SnapshotCorruption, mod.CheckpointCorruption)
        assert mod.classify(mod.SnapshotCorruption("x")) == "deterministic"
        assert mod.classify(mod.FleetSliceLost(0)) == "deterministic"
        assert str(mod.FleetSliceLost(1, "no surviving slice")) == (
            "serving slice 1 lost: no surviving slice — query could not "
            "be re-admitted onto a surviving slice")
        assert not any("Xla" in n or "Jax" in n
                       for n in mod._TRANSIENT_TYPE_NAMES)
