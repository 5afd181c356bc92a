"""PyTorch port: the runtime lock-order sanitizer
(``matrel_tpu_torch/utils/lockdep.py``) held against the JAX package's
``matrel_tpu/utils/lockdep.py`` on the CPU, mirroring
``tests/test_lockdep.py``.

Each diagnostic fires on a seeded fixture (inversion, self-deadlock,
held-across-dispatch), in raise and record modes, with the
``dispatch_ok`` sanction, ``threading.Condition`` interop and the emit
hook. The same fixture driven through both packages' sanitizers yields
the same diagnostic records field for field (less the thread name and
the ``file:line`` sites) and the same order graph. The port's own
locks (``session.compile``, ``serve.pipeline``, ``serve.admission``,
``serve.result_cache``, the obs and resilience planes') are built
through the seam, and a serving + export sequence under an armed
session records no inversion. The default config builds no lockdep
object (poisoned ``__init__``).

The two modules keep separate global state; every test leaves both
disabled and empty.
"""

import threading
import urllib.request

import numpy as np
import pytest

from matrel_tpu.utils import lockdep as jlockdep

from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.session import MatrelSession
from matrel_tpu_torch.utils import lockdep

WAIT_S = 60.0


@pytest.fixture()
def armed():
    """Both sanitizers on (record mode), pristine graphs, restored."""
    for m in (lockdep, jlockdep):
        m.reset()
        m.enable(raise_on_violation=False)
    yield
    for m in (lockdep, jlockdep):
        m.reset()
        m.disable()


@pytest.fixture(autouse=True)
def _disarm_after():
    yield
    for m in (lockdep, jlockdep):
        m.set_emit(None)
        m.reset()
        m.disable()


def _invert(a, b):
    """Drive a -> b on this thread and b -> a on a second one."""
    with a:
        with b:
            pass

    def other():
        with b:
            with a:
                pass

    t = threading.Thread(target=other, daemon=True)
    t.start()
    t.join(timeout=WAIT_S)


def _strip(d: dict) -> dict:
    """A diagnostic record less its thread-, file- and line-specific
    fields."""
    return {k: v for k, v in d.items()
            if k not in ("site", "held_site", "thread")}


def _both(scenario):
    """Run ``scenario(module)`` through the port's sanitizer and the
    JAX package's; return their stripped diagnostics and graphs."""
    out = []
    for m in (lockdep, jlockdep):
        scenario(m)
        out.append(([_strip(d) for d in m.diagnostics()],
                    sorted(m.order_graph())))
    return out


class TestOrderGraph:
    def test_inversion_recorded(self, armed):
        a = lockdep.make_lock("fix.a")
        b = lockdep.make_lock("fix.b")
        _invert(a, b)
        diags = lockdep.diagnostics()
        assert any(d["diag"] == "inversion" for d in diags)
        assert not lockdep.is_acyclic()
        g = lockdep.order_graph()
        assert ("fix.a", "fix.b") in g and ("fix.b", "fix.a") in g

    def test_consistent_order_is_clean(self, armed):
        a = lockdep.make_lock("fix.c")
        b = lockdep.make_lock("fix.d")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert lockdep.diagnostics() == []
        assert lockdep.is_acyclic()

    def test_inversion_raises_in_raise_mode(self, armed):
        lockdep.enable(raise_on_violation=True)
        a = lockdep.make_lock("fix.e")
        b = lockdep.make_lock("fix.f")
        with a:
            with b:
                pass
        box = []

        def other():
            try:
                with b:
                    with a:
                        pass
            except lockdep.LockOrderInversion as e:
                box.append(e)

        t = threading.Thread(target=other, daemon=True)
        t.start()
        t.join(timeout=WAIT_S)
        assert box and box[0].record["diag"] == "inversion"

    def test_diag_record_shape(self, armed):
        a = lockdep.make_lock("fix.g")
        b = lockdep.make_lock("fix.h")
        _invert(a, b)
        d = next(d for d in lockdep.diagnostics()
                 if d["diag"] == "inversion")
        for key in ("kind", "lock", "held", "site", "held_site",
                    "thread", "msg"):
            assert key in d, key

    @pytest.mark.parametrize("names", [("p.a", "p.b"), ("p.x", "p.y"),
                                       ("p.b", "p.a")])
    def test_inversion_records_equal_the_jax_packages(self, armed, names):
        def scenario(m):
            a = m.make_lock(names[0])
            b = m.make_lock(names[1])
            _invert(a, b)
        (tg, tgraph), (jg, jgraph) = _both(scenario)
        assert tg == jg and tg
        assert tgraph == jgraph

    def test_three_lock_cycle_equal(self, armed):
        def scenario(m):
            a, b, c = (m.make_lock(f"cy.{n}") for n in "abc")
            with a:
                with b:
                    pass
            with b:
                with c:
                    pass

            def other():
                with c:
                    with a:
                        pass
            t = threading.Thread(target=other, daemon=True)
            t.start()
            t.join(timeout=WAIT_S)
        (tg, tgraph), (jg, jgraph) = _both(scenario)
        assert tg == jg and [d["diag"] for d in tg] == ["inversion"]
        assert tgraph == jgraph
        assert lockdep.is_acyclic() is jlockdep.is_acyclic() is False


class TestSelfDeadlock:
    def test_non_reentrant_double_acquire_is_fatal(self, armed):
        a = lockdep.make_lock("fix.sd")
        with pytest.raises(lockdep.LockOrderInversion) as ei:
            with a:
                with a:
                    pass
        assert ei.value.record["diag"] == "self_deadlock"
        assert ei.value.record["fatal"] is True

    def test_rlock_reentry_clean(self, armed):
        r = lockdep.make_rlock("fix.re")
        with r:
            with r:
                pass
        assert lockdep.diagnostics() == []

    def test_self_deadlock_record_equal(self, armed):
        def scenario(m):
            a = m.make_lock("sd.same")
            try:
                with a:
                    with a:
                        pass
            except m.LockOrderInversion:
                pass
        (tg, _), (jg, _) = _both(scenario)
        assert tg == jg and tg[0]["diag"] == "self_deadlock"


class TestHeldAcrossDispatch:
    def test_unsanctioned_hold_fires(self, armed):
        lockdep.enable(raise_on_violation=True)
        a = lockdep.make_lock("fix.disp")
        with pytest.raises(lockdep.HeldAcrossDispatch):
            with a:
                lockdep.note_dispatch("fix.dispatch_point")

    def test_dispatch_ok_lock_sanctioned(self, armed):
        lockdep.enable(raise_on_violation=True)
        a = lockdep.make_lock("fix.disp_ok", dispatch_ok=True)
        with a:
            lockdep.note_dispatch("fix.dispatch_point")
        assert lockdep.diagnostics() == []

    def test_note_dispatch_off_is_free(self):
        lockdep.disable()
        lockdep.note_dispatch("fix.nothing")

    def test_record_equal(self, armed):
        def scenario(m):
            a = m.make_lock("hd.a")
            with a:
                m.note_dispatch("hd.point")
        (tg, _), (jg, _) = _both(scenario)
        assert tg == jg and tg[0]["diag"] == "held_across_dispatch"

    def test_session_dispatch_under_a_held_lock_fires(self, armed):
        """The session's plan dispatch is a sanctioned point: running a
        query while holding an unsanctioned lock is diagnosed."""
        s = MatrelSession(config=MatrelConfig(lockdep_enable=True),
                          device="cpu")
        A = s.from_numpy(np.eye(4, dtype=np.float32))
        held = lockdep.make_lock("fix.user")
        with held:
            s.compute(A.multiply(A))
        d = [x for x in lockdep.diagnostics()
             if x["diag"] == "held_across_dispatch"]
        assert d and d[0]["lock"] == "fix.user"
        assert d[0]["dispatch"] == "session.dispatch"


class TestInterop:
    def test_condition_wait_clean(self, armed):
        lk = lockdep.make_lock("fix.cond")
        cv = threading.Condition(lk)
        box = []

        def waiter():
            with cv:
                box.append(cv.wait(timeout=WAIT_S))

        t = threading.Thread(target=waiter, daemon=True)
        t.start()
        while True:
            with cv:
                if box:
                    break
                cv.notify_all()
            if not t.is_alive():
                break
        t.join(timeout=WAIT_S)
        assert box == [True]
        assert lockdep.diagnostics() == []

    def test_emit_hook_receives_records(self, armed):
        got = []
        lockdep.set_emit(got.append)
        a = lockdep.make_lock("fix.em1")
        b = lockdep.make_lock("fix.em2")
        _invert(a, b)
        assert any(r["diag"] == "inversion" for r in got)

    def test_nonblocking_acquire_skips_checks(self, armed):
        a = lockdep.make_lock("fix.nb")
        with a:
            assert a.acquire(blocking=False) is False
        assert lockdep.diagnostics() == []


class TestStructuralZero:
    def test_default_off_returns_raw_primitives(self, monkeypatch):
        lockdep.disable()

        def poisoned(self, *a, **k):
            raise AssertionError(
                "lockdep object constructed while disabled")
        monkeypatch.setattr(lockdep._InstrumentedLock, "__init__",
                            poisoned)
        lk = lockdep.make_lock("fix.off")
        rl = lockdep.make_rlock("fix.off_r")
        assert type(lk) is type(threading.Lock())
        assert type(rl) is type(threading.RLock())
        # a default session builds its locks through the seam: raw
        s = MatrelSession(device="cpu")
        A = s.from_numpy(np.eye(4, dtype=np.float32))
        s.compute(A.multiply(A))
        assert type(s._compile_lock) is type(threading.RLock())

    def test_config_validation(self):
        with pytest.raises(ValueError, match="lockdep_raise"):
            MatrelConfig(lockdep_raise=True)
        cfg = MatrelConfig(lockdep_enable=True, lockdep_raise=True)
        assert cfg.lockdep_enable

    def test_session_emits_lockdep_into_flight_ring(self):
        sess = MatrelSession(config=MatrelConfig(
            lockdep_enable=True, obs_flight_recorder=64), device="cpu")
        a = lockdep.make_lock("fix.sess1")
        b = lockdep.make_lock("fix.sess2")
        _invert(a, b)
        ring = [r for r in sess._flight.snapshot()
                if r.get("kind") == "lockdep"]
        assert ring and ring[-1]["diag"] == "inversion"

    def test_session_locks_are_instrumented_and_named(self):
        s = MatrelSession(config=MatrelConfig(
            lockdep_enable=True, result_cache_max_bytes=1 << 20),
            device="cpu")
        assert isinstance(s._compile_lock, lockdep._InstrumentedLock)
        assert s._compile_lock.name == "session.compile"
        assert s._result_cache._lock.name == "serve.result_cache"
        pipe = s._ensure_serve()
        try:
            assert pipe._lock.name == "serve.pipeline"
            assert pipe._q._lock.name == "serve.admission"
        finally:
            s.serve_close(timeout=WAIT_S)


class TestServingSequenceIsAcyclic:
    def test_submit_export_sequence_records_no_inversion(self, tmp_path):
        """The serve worker, the caller's thread and the metrics
        exporter thread interleave over the session's locks: the order
        graph stays acyclic and no diagnostic is recorded."""
        lockdep.reset()
        cfg = MatrelConfig(
            lockdep_enable=True, obs_level="on",
            obs_event_log=str(tmp_path / "ev.jsonl"),
            obs_metrics_port=_free_port(), obs_flight_recorder=32,
            result_cache_max_bytes=1 << 22, brownout_enable=True,
            breaker_threshold=3, slo_targets="a:p95_ms=1000",
            serve_tenant_weights="a:2,b:1")
        s = MatrelSession(config=cfg, device="cpu")
        try:
            rng = np.random.default_rng(3)
            mats = [s.from_numpy(rng.standard_normal((8, 8))
                                 .astype(np.float32)) for _ in range(3)]
            futs = [s.submit(m.multiply(m), tenant="ab"[i % 2])
                    for i, m in enumerate(mats * 3)]
            url = s._exporter.url
            for path in ("/metrics", "/json"):
                with urllib.request.urlopen(url + path,
                                            timeout=WAIT_S) as r:
                    assert r.status == 200
            for f in futs:
                f.result(timeout=WAIT_S)
            s.compute(mats[0].multiply(mats[1]))
        finally:
            s.serve_close(timeout=WAIT_S)
        assert lockdep.diagnostics() == []
        assert lockdep.is_acyclic()
        names = {n for e in lockdep.order_graph() for n in e}
        assert "serve.admission" in names or not lockdep.order_graph()


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]
