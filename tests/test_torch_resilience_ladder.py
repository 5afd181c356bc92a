"""PyTorch port: the resilience ladder (``matrel_tpu_torch/resilience/``
— fault injection, the degradation ladder, circuit breakers, brownout —
and its session / pipeline seams) held against the JAX package's on the
CPU, mirroring ``tests/test_resilience.py`` and the breaker / brownout
classes of ``tests/test_overload.py``.

Compared between the packages, over the same seeded inputs:

- fault-firing call indices from the same spec and seed (Python
  ``random`` seeded by ``(seed, site, rule index, rule)`` in both);
- the session's ``fault`` / ``retry`` / ``degrade`` event sequences,
  the ``degr:<rung>|`` plan keys (id() tokens renumbered) and
  ``plan.meta["degrade"]`` under the same injected schedule;
- breaker transitions and snapshots under the same injected clock and
  outcome sequence;
- brownout rung sequences and snapshots under the same fed signals;
- results at every rung: within rtol/atol 3e-4 of float64 numpy (the
  JAX tests' tolerance) and 1e-5 of the JAX package's.

Rung 3 runs the composite paths (``use_pallas=False``: each kernel
wrapper's plain version) — by design, and only after a transient
failure; a deterministic error (a kernel that does not build or launch)
is raised, never laddered. The OFF contract: the default config builds
no ``FaultInjector``, ``BreakerRegistry``, ``LoadController`` or
``RetryPolicy`` (poisoned ``__init__``) and its plan keys carry no
``degr:`` prefix.
"""

import json
import os
import re
import time

import jax
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.resilience import breaker as jbreaker
from matrel_tpu.resilience import brownout as jbrownout
from matrel_tpu.resilience import degrade as jdegrade
from matrel_tpu.resilience import errors as jerrors
from matrel_tpu.resilience import faults as jfaults
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.coo import COOMatrix
from matrel_tpu_torch.core.sparse import BlockSparseMatrix
from matrel_tpu_torch.executor import compile_expr, plan_matmul_decisions
from matrel_tpu_torch.obs.events import read_events
from matrel_tpu_torch.ops import pallas_spmm
from matrel_tpu_torch.resilience import (breaker, brownout, degrade,
                                         errors, faults)
from matrel_tpu_torch.resilience.errors import (AdmissionShed,
                                                CircuitOpen,
                                                DeadlineExceeded,
                                                DrainTimeout,
                                                InjectedFault,
                                                PipelineClosed,
                                                QueryAborted)
from matrel_tpu_torch.resilience.faults import FaultInjector
from matrel_tpu_torch.resilience.retry import RetryPolicy
from matrel_tpu_torch.session import MatrelSession

WAIT_S = 60.0
TOL = 3e-4


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture(autouse=True)
def _fresh_faults():
    faults.reset()
    jfaults.reset()
    yield
    faults.reset()
    jfaults.reset()


@pytest.fixture()
def closers():
    live = []
    yield live
    for s in live:
        if getattr(s, "_serve", None) is not None:
            s._serve.close(timeout=WAIT_S)


def _sess(**cfg):
    return MatrelSession(config=MatrelConfig(**cfg), device="cpu")


def twins(jmesh, tmp_path, **cfg):
    jc, tc = dict(cfg), dict(cfg)
    if cfg.get("obs_level", "off") != "off":
        jc["obs_event_log"] = str(tmp_path / "j.jsonl")
        tc["obs_event_log"] = str(tmp_path / "t.jsonl")
    return (JSession(mesh=jmesh, config=JConfig(**jc)),
            MatrelSession(config=MatrelConfig(**tc), device="cpu"))


def rand(rng, n, m):
    return rng.standard_normal((n, m)).astype(np.float32)


_ID = re.compile(r"((?:sparse_leaf|coo_leaf|leaf):)(\d+)")


def norm(key: str) -> str:
    ids: dict = {}
    return _ID.sub(lambda m: m.group(1)
                   + f"#{ids.setdefault(m.group(2), len(ids))}", key)


def resil_events(path):
    out = []
    for e in read_events(path):
        if e["kind"] in ("fault", "retry", "degrade"):
            out.append({k: v for k, v in e.items() if k != "ts"})
        elif e["kind"] == "query":
            out.append({"kind": "query", "cache": e["cache"],
                        "degrade": e.get("degrade")})
    return out


# -- fault injection ------------------------------------------------------------


def _schedule(mod, spec, seed, site, n_calls=200):
    inj = mod.FaultInjector(spec, seed)
    fired = []
    for i in range(n_calls):
        try:
            inj.check(site)
        except (InjectedFault, jerrors.InjectedFault) as ex:
            fired.append((i, ex.kind, ex.call_index))
    return fired


class TestFaultInjection:
    def test_spec_validation_at_config_construction(self):
        for bad, match in (("warp_core:transient:p=0.5", "site"),
                           ("compile:sometimes:p=0.5", "kind"),
                           ("compile:transient", "exactly one"),
                           ("compile:transient:p=0.5:n=3", "exactly one"),
                           ("compile:transient:p=1.5", "p=")):
            with pytest.raises(ValueError, match=match):
                MatrelConfig(fault_inject=bad)
        MatrelConfig(fault_inject="compile:transient:p=0.5;"
                                  "execute:fatal:n=3:max=1")

    def test_sites_and_parse_equal_the_jax_packages(self):
        assert faults.SITES == jfaults.SITES
        assert faults.KINDS == jfaults.KINDS
        spec = "all:transient:n=2;execute:fatal:p=0.3:max=4"
        assert faults.parse_spec(spec) == jfaults.parse_spec(spec)

    @pytest.mark.parametrize("site", faults.SITES)
    @pytest.mark.parametrize("seed", [0, 42])
    def test_probability_schedule_equal_per_site(self, site, seed):
        spec = f"{site}:transient:p=0.1;{site}:fatal:p=0.05:max=3"
        got = _schedule(faults, spec, seed, site)
        assert got == _schedule(jfaults, spec, seed, site) and got
        assert got != _schedule(faults, spec, seed + 1, site)

    def test_sites_independent_streams(self):
        solo = _schedule(faults, "execute:transient:p=0.1", 7, "execute")
        inj = FaultInjector(
            "execute:transient:p=0.1;compile:transient:p=0.1", 7)
        fired = []
        for i in range(200):
            try:
                inj.check("compile")
            except InjectedFault:
                pass
            try:
                inj.check("execute")
            except InjectedFault as ex:
                fired.append((i, ex.kind, ex.call_index))
        assert fired == solo

    def test_nth_call_and_max(self):
        assert [i for i, *_ in _schedule(
            faults, "compile:transient:n=5", 0, "compile", 50)] == [4]
        assert [i for i, *_ in _schedule(
            faults, "execute:transient:p=1.0:max=3", 0, "execute",
            50)] == [0, 1, 2]
        assert _schedule(faults, "compile:transient:p=1.0", 0,
                         "execute") == []

    def test_all_site_expands_to_every_site(self):
        inj = FaultInjector("all:transient:n=1", 0)
        for site in faults.SITES:
            with pytest.raises(InjectedFault):
                inj.check(site)

    def test_sibling_rule_counters_advance_past_a_fire(self):
        inj = FaultInjector("execute:transient:n=1;execute:fatal:n=3", 0)
        with pytest.raises(InjectedFault) as e1:
            inj.check("execute")
        assert e1.value.transient
        inj.check("execute")
        with pytest.raises(InjectedFault) as e3:
            inj.check("execute")
        assert not e3.value.transient and e3.value.call_index == 3

    def test_injected_fault_is_typed_and_attributed(self):
        inj = FaultInjector("execute:fatal:n=1", 0)
        with pytest.raises(InjectedFault) as ei:
            inj.check("execute")
        assert (ei.value.site, ei.value.transient,
                ei.value.call_index) == ("execute", False, 1)
        assert str(ei.value) == str(jerrors.InjectedFault(
            "execute", "fatal", 1, rule="execute:fatal:n=1"))

    def test_injector_shared_per_spec_and_seed(self):
        c = MatrelConfig(fault_inject="execute:transient:n=2")
        assert faults.injector_for(c) is faults.injector_for(
            c.replace(block_size=8))
        assert faults.injector_for(MatrelConfig()) is None

    def test_session_sites_fire_on_the_same_calls(self, jmesh,
                                                  tmp_path, rng):
        """One spec over every session-level site, the same query
        sequence: the same calls fire in both packages."""
        spec = ("compile:transient:p=0.3;execute:transient:p=0.3;"
                "rc_probe:transient:p=0.3")
        cfg = dict(fault_inject=spec, fault_inject_seed=11,
                   retry_max_attempts=8, retry_backoff_ms=0.0,
                   result_cache_max_bytes=1 << 22)
        js, ts = twins(jmesh, tmp_path, **cfg)
        a, b = rand(rng, 16, 24), rand(rng, 24, 8)
        for s in (js, ts):
            A, B = s.from_numpy(a), s.from_numpy(b)
            for e in (A.expr().multiply(B.expr()), A.expr().t(),
                      A.expr().multiply(B.expr()), B.expr() * 2.0):
                s.run(e)
        tstats = faults.injector_for(ts.config).stats()
        jstats = jfaults.injector_for(js.config).stats()
        for site in ("compile", "execute", "rc_probe"):
            assert tstats[site] == jstats[site], site
        assert sum(v["fires"] for v in tstats.values()) > 0


class TestTaxonomy:
    def test_injected_faults_classify_by_kind(self):
        assert errors.classify(InjectedFault("x", "transient", 1)) \
            == "transient"
        assert errors.classify(InjectedFault("x", "fatal", 1)) \
            == "deterministic"

    @pytest.mark.parametrize("exc", [
        ValueError("shape"), TypeError("t"), KeyError("k"),
        NotImplementedError("n"), RuntimeError("nvcc failed: exit 1"),
        RuntimeError("CUDA error: an illegal memory access"),
        CircuitOpen("c", 1.0), DeadlineExceeded(1.0, 2.0),
        AdmissionShed(3), PipelineClosed("x")])
    def test_build_launch_and_typed_errors_deterministic(self, exc):
        assert errors.classify(exc) == "deterministic"

    def test_out_of_memory_is_the_runtime_transient(self):
        oom = type("OutOfMemoryError", (RuntimeError,), {})("CUDA oom")
        assert errors.classify(oom) == "transient"
        assert errors.classify(MemoryError()) == "transient"
        assert errors.classify(
            RuntimeError("CUDA out of memory. Tried to allocate")) \
            == "transient"

    def test_circuit_open_message_equal(self):
        assert str(CircuitOpen("matmul:<=8", 12.0, 2)) == \
            str(jerrors.CircuitOpen("matmul:<=8", 12.0, 2))


# -- the session ladder ------------------------------------------------------


class TestSessionLadder:
    @pytest.mark.parametrize("fires", [1, 2, 3, 4])
    def test_rungs_keys_meta_events_equal(self, jmesh, tmp_path, rng,
                                          fires):
        cfg = dict(fault_inject=f"execute:transient:p=1.0:max={fires}",
                   retry_max_attempts=4, retry_backoff_ms=0.0,
                   obs_level="on")
        js, ts = twins(jmesh, tmp_path, **cfg)
        a, b = rand(rng, 32, 48), rand(rng, 48, 16)
        outs = []
        for s in (js, ts):
            A, B = s.from_numpy(a), s.from_numpy(b)
            outs.append(s.run(A.expr().multiply(B.expr())))
        jo, to = outs
        np.testing.assert_allclose(to.to_numpy(), a.astype(np.float64)
                                   @ b, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(to.to_numpy(), jo.to_numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert sorted(map(norm, ts._plan_cache)) == \
            sorted(map(norm, js._plan_cache))
        key = next(k for k in ts._plan_cache
                   if k.startswith(f"degr:{fires}|"))
        assert ts._plan_cache[key].meta["degrade"] == \
            degrade.rung_meta(fires)
        assert resil_events(ts.config.obs_event_log) == \
            resil_events(js.config.obs_event_log)

    def test_rung3_runs_the_plain_composites(self):
        """A block-sparse product: rungs 0-2 reach B1's kernel wrapper
        (the kernel on a CUDA tensor, its plain version here); rung 3
        compiles with ``use_pallas=False`` and the product runs the
        plain composite without the wrapper — the same answer."""
        calls = []
        orig = pallas_spmm.spmm_blocksparse

        def spy(*a, **k):
            calls.append(1)
            return orig(*a, **k)
        rng = np.random.default_rng(9)
        sn = rand(rng, 64, 64)
        sn[rng.random((64, 64)) < 0.7] = 0.0
        d = rand(rng, 64, 16)
        cfgs = [degrade.apply_rung(MatrelConfig(block_size=16), r)
                for r in range(4)]
        assert [c.use_pallas for c in cfgs] == [True, True, True, False]
        per_rung = []
        pallas_spmm.spmm_blocksparse = spy
        try:
            for c in cfgs:
                s = MatrelSession(config=c, device="cpu")
                S = BlockSparseMatrix.from_numpy(sn, block_size=16,
                                                 mesh=s.mesh, config=c)
                n0 = len(calls)
                out = s.run(S.expr().multiply(s.from_numpy(d).expr()))
                per_rung.append(len(calls) - n0)
                np.testing.assert_allclose(
                    out.to_numpy(), sn.astype(np.float64) @ d,
                    rtol=TOL, atol=TOL)
        finally:
            pallas_spmm.spmm_blocksparse = orig
        assert all(n > 0 for n in per_rung[:3]) and per_rung[3] == 0

    def test_fatal_fault_raises_typed_without_retry(self, rng):
        s = _sess(fault_inject="compile:fatal:n=1", retry_max_attempts=3,
                  retry_backoff_ms=1.0)
        A = s.from_numpy(rand(rng, 32, 32))
        with pytest.raises(InjectedFault):
            s.run(A.expr().multiply(A.expr()))
        assert faults.injector_for(s.config).stats()["compile"]["calls"] \
            == 1

    def test_build_error_is_raised_not_laddered(self, rng, monkeypatch):
        """A kernel that fails to build is deterministic: one attempt,
        no rung climbed, the error raised as it came."""
        s = _sess(retry_max_attempts=4, retry_backoff_ms=0.0,
                  obs_flight_recorder=32)
        A = s.from_numpy(rand(rng, 16, 16))
        from matrel_tpu_torch import executor as t_exec
        calls = []

        def broken(*a, **k):
            calls.append(1)
            raise RuntimeError("nvcc failed to build the kernel")
        monkeypatch.setattr(t_exec.Lowerer, "_eval", broken)
        with pytest.raises(RuntimeError, match="nvcc"):
            s.run(A.expr().multiply(A.expr()))
        assert len(calls) == 1
        assert not any(k.startswith("degr:") for k in s._plan_cache)

    def test_retries_exhausted_raises_last_fault(self, rng):
        s = _sess(fault_inject="execute:transient:p=1.0",
                  retry_max_attempts=2, retry_backoff_ms=0.5)
        A = s.from_numpy(rand(rng, 32, 32))
        with pytest.raises(InjectedFault) as ei:
            s.run(A.expr().multiply(A.expr()))
        assert ei.value.transient

    def test_rc_bypass_rung_recovers_from_poisoned_probe(self, rng):
        s = _sess(fault_inject="rc_probe:transient:p=1.0",
                  retry_max_attempts=4, retry_backoff_ms=0.5,
                  result_cache_max_bytes=1 << 24)
        a, b = rand(rng, 32, 48), rand(rng, 48, 16)
        out = s.run(s.from_numpy(a).expr().multiply(s.from_numpy(b)
                                                    .expr()))
        np.testing.assert_allclose(out.to_numpy(), a.astype(np.float64)
                                   @ b, rtol=TOL, atol=TOL)
        assert any(k.startswith("degr:4|") for k in s._plan_cache)

    def test_lower_and_strategy_sites_are_retryable(self, rng):
        for site in ("lower", "strategy"):
            faults.reset()
            s = _sess(fault_inject=f"{site}:transient:n=1",
                      retry_max_attempts=2, retry_backoff_ms=0.0)
            a = rand(rng, 8, 8)
            out = s.run(s.from_numpy(a).expr().multiply(
                s.from_numpy(a).expr()))
            np.testing.assert_allclose(out.to_numpy(), a.astype(
                np.float64) @ a, rtol=TOL, atol=TOL)
            assert faults.injector_for(s.config).stats()[site]["fires"] \
                == 1

    def test_cancellation_between_attempts(self, rng):
        s = _sess(fault_inject="execute:transient:p=1.0",
                  retry_max_attempts=5, retry_backoff_ms=1.0)
        A = s.from_numpy(rand(rng, 32, 32))
        from matrel_tpu_torch.ir.expr import as_expr
        pol = RetryPolicy.from_config(s.config)
        with pytest.raises(QueryAborted):
            s._compute_resilient(as_expr(A.expr().multiply(A.expr())),
                                 False, "default", pol,
                                 should_abort=lambda: True)

    def test_run_many_ladder_equal(self, jmesh, tmp_path, rng):
        cfg = dict(fault_inject="execute:transient:p=1.0:max=2",
                   retry_max_attempts=3, retry_backoff_ms=0.0,
                   obs_level="on")
        js, ts = twins(jmesh, tmp_path, **cfg)
        a, b = rand(rng, 32, 48), rand(rng, 48, 16)
        res = []
        for s in (js, ts):
            A, B = s.from_numpy(a), s.from_numpy(b)
            res.append(s.run_many([A.expr().multiply(B.expr()),
                                   B.expr().t().multiply(A.expr().t())]))
        for g, w in zip(res[1], res[0]):
            np.testing.assert_allclose(g.to_numpy(), w.to_numpy(),
                                       rtol=1e-5, atol=1e-5)
        assert resil_events(ts.config.obs_event_log) == \
            resil_events(js.config.obs_event_log)
        assert sorted(map(norm, ts._plan_cache)) == \
            sorted(map(norm, js._plan_cache))

    def test_deadlines_typed(self, rng):
        s = _sess()
        A = s.from_numpy(rand(rng, 32, 32))
        with pytest.raises(DeadlineExceeded):
            s.run(A.expr().multiply(A.expr()), deadline_ms=1e-6)
        with pytest.raises(DeadlineExceeded):
            s.run_many([A.expr().multiply(A.expr())], deadline_ms=1e-6)

    def test_obs_off_resilient_path_emits_nothing(self, rng, tmp_path):
        log = tmp_path / "events.jsonl"
        s = _sess(fault_inject="execute:transient:n=1",
                  retry_max_attempts=2, retry_backoff_ms=1.0,
                  obs_event_log=str(log))
        A = s.from_numpy(rand(rng, 32, 32))
        s.run(A.expr().multiply(A.expr()))
        assert not log.exists()


class TestDegradationLadder:
    def test_rung0_is_identity(self):
        cfg = MatrelConfig()
        assert degrade.apply_rung(cfg, 0) is cfg
        assert degrade.key_prefix(0) == ""

    @pytest.mark.parametrize("rung", [1, 2, 3, 4, 5])
    def test_apply_rung_equal_the_jax_packages(self, rung):
        base = dict(autotune=True, spgemm_kernel_override="pallas_band",
                    fusion_enable=True)
        got = degrade.apply_rung(MatrelConfig(**base), rung)
        want = jdegrade.apply_rung(JConfig(**base), rung)
        for f in ("autotune", "strategy_override", "use_pallas",
                  "spgemm_density_threshold", "spgemm_kernel_override",
                  "fusion_enable"):
            assert getattr(got, f) == getattr(want, f), f
        assert degrade.key_prefix(rung) == jdegrade.key_prefix(rung)
        assert degrade.next_rung(rung) == jdegrade.next_rung(rung)
        assert degrade.rung_meta(rung) == jdegrade.rung_meta(rung)

    @pytest.mark.parametrize("rung", [1, 2, 3, 4])
    def test_each_rung_produces_correct_results(self, rng, rung):
        cfg = degrade.apply_rung(MatrelConfig(block_size=8), rung)
        s = MatrelSession(config=cfg, device="cpu")
        a, b = rand(rng, 48, 32), rand(rng, 32, 24)
        got = compile_expr(s.from_numpy(a).expr().multiply(
            s.from_numpy(b).expr()), s.mesh, cfg).run()
        np.testing.assert_allclose(got.to_numpy(), a.astype(np.float64)
                                   @ b, rtol=TOL, atol=TOL)
        sn = rand(rng, 48, 48)
        sn[rng.random((48, 48)) < 0.8] = 0.0
        S = BlockSparseMatrix.from_numpy(sn, block_size=8, mesh=s.mesh,
                                         config=cfg)
        got = compile_expr(S.expr().multiply(S.expr()), s.mesh,
                           cfg).run()
        np.testing.assert_allclose(got.to_numpy(), sn.astype(np.float64)
                                   @ sn, rtol=TOL, atol=TOL)
        rows, cols = np.nonzero(sn)
        C = COOMatrix.from_edges(rows, cols, sn[rows, cols],
                                 shape=sn.shape)
        d = rand(rng, 48, 24)
        got = compile_expr(C.expr().multiply(s.from_numpy(d).expr()),
                           s.mesh, cfg).run()
        np.testing.assert_allclose(got.to_numpy(), sn.astype(np.float64)
                                   @ d, rtol=TOL, atol=TOL)

    def test_rung2_plan_stamps_xla_everywhere(self, rng):
        cfg = degrade.apply_rung(MatrelConfig(mesh_shape=(2, 4)), 2)
        s = MatrelSession(config=cfg, device="cpu")
        A = s.from_numpy(rand(rng, 64, 64))
        plan = compile_expr(A.expr().multiply(A.expr()), s.mesh, cfg)
        assert all(d["strategy"] == "xla"
                   for d in plan_matmul_decisions(plan))


class TestDefaultConfigInert:
    def test_zero_resilience_objects_constructed(self, rng, monkeypatch):
        for cls in (FaultInjector, breaker.BreakerRegistry,
                    breaker.CircuitBreaker, brownout.LoadController):
            def boom(self, *a, _c=cls, **k):
                raise AssertionError(f"{_c.__name__} constructed")
            monkeypatch.setattr(cls, "__init__", boom)
        calls = []
        orig = RetryPolicy.__init__
        monkeypatch.setattr(RetryPolicy, "__init__",
                            lambda self, *a, **k: (calls.append(a),
                                                   orig(self, *a, **k))[1])
        s = _sess()
        A = s.from_numpy(rand(rng, 32, 32))
        s.run(A.expr().multiply(A.expr()))
        s.run_many([A.expr().multiply(A.expr())])
        assert calls == []
        assert s._breakers is None and s._brownout is None
        assert all(not k.startswith("degr:") for k in s._plan_cache)
        plan = s.compile(A.expr().multiply(A.expr()))
        assert "degrade" not in plan.meta

    def test_check_is_one_attribute_read_when_off(self):
        class Cfg:
            fault_inject = ""
        faults.check("execute", Cfg())
        faults.check("execute", None)
        assert faults._REGISTRY == {}


# -- circuit breakers -----------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive(mod, script, threshold=2, cooldown=100.0, probes=1):
    clock = _Clock()
    reg = mod.BreakerRegistry(threshold, cooldown, probes, clock=clock)
    trail = []
    for op, arg in script:
        if op == "tick":
            clock.t += arg
            continue
        if op == "admit":
            try:
                reg.admit(arg)
                trail.append(("admit", arg, "ok"))
            except (CircuitOpen, jerrors.CircuitOpen) as ex:
                trail.append(("admit", arg, "open",
                              round(ex.retry_after_ms, 6)))
        else:
            reg.record(arg, {"ok": True, "fail": False,
                             "none": None}[op])
        trail.append(("state", arg, reg.state(arg)))
    return trail, reg.snapshot()


class TestCircuitBreaker:
    SCRIPTS = [
        [("admit", "c"), ("fail", "c"), ("admit", "c"), ("fail", "c"),
         ("admit", "c"), ("tick", 0.05), ("admit", "c"), ("tick", 0.06),
         ("admit", "c"), ("ok", "c"), ("admit", "c")],
        [("admit", "c"), ("fail", "c"), ("fail", "c"), ("tick", 0.2),
         ("admit", "c"), ("admit", "c"), ("fail", "c"), ("admit", "c"),
         ("tick", 0.2), ("admit", "c"), ("none", "c"), ("admit", "c")],
        [("fail", "a"), ("ok", "a"), ("fail", "a"), ("admit", "a"),
         ("fail", "b"), ("fail", "b"), ("admit", "b"), ("admit", "a")],
    ]

    @pytest.mark.parametrize("i", range(len(SCRIPTS)))
    @pytest.mark.parametrize("probes", [1, 2])
    def test_transitions_equal_the_jax_packages(self, i, probes):
        got = _drive(breaker, self.SCRIPTS[i], probes=probes)
        want = _drive(jbreaker, self.SCRIPTS[i], probes=probes)
        assert got == want

    def test_counts_as_failure_taxonomy(self):
        assert breaker.counts_as_failure(InjectedFault("e", "fatal", 1))
        assert breaker.counts_as_failure(ValueError("x"))
        for ex in (DeadlineExceeded(1, 2), AdmissionShed(1),
                   CircuitOpen("c", 1.0), QueryAborted(),
                   PipelineClosed(), DrainTimeout(1.0, 1)):
            assert not breaker.counts_as_failure(ex)

    def test_plan_class_equal_the_jax_packages(self, jmesh, rng):
        a = rand(rng, 300, 40)
        js = JSession(mesh=jmesh, config=JConfig())
        ts = _sess()
        je = js.from_numpy(a).expr().t()
        te = ts.from_numpy(a).expr().t()
        assert breaker.plan_class(te) == jbreaker.plan_class(je) \
            == "transpose:<=512"

    def test_from_config_off_constructs_nothing(self):
        assert breaker.BreakerRegistry.from_config(MatrelConfig()) is None

    def test_session_trips_and_heals_with_the_jax_packages(self, jmesh,
                                                           rng):
        """A fatal injected fault at execute trips the class's breaker
        after ``breaker_threshold`` failures; admission raises typed;
        after the cooldown the probe runs and closes it."""
        cfg = dict(breaker_threshold=2, breaker_cooldown_ms=50.0,
                   fault_inject="execute:fatal:p=1.0:max=2")
        trails = []
        for S, C in ((JSession, JConfig), (MatrelSession, MatrelConfig)):
            kw = ({"mesh": jmesh} if S is JSession else {"device": "cpu"})
            s = S(config=C(**cfg), **kw)
            a = rand(rng, 8, 8)
            A = s.from_numpy(a)
            e = A.expr().multiply(A.expr())
            trail = []
            for _ in range(3):
                try:
                    s.run(e)
                    trail.append("ok")
                except Exception as ex:
                    trail.append(type(ex).__name__)
            time.sleep(0.08)
            out = s.run(e)
            trail.append(s._breakers.state("matmul:<=8"))
            np.testing.assert_allclose(out.to_numpy(), a.astype(
                np.float64) @ a, rtol=TOL, atol=TOL)
            trails.append((trail, s._breakers.snapshot()))
        assert trails[0] == trails[1]
        assert trails[1][0] == ["InjectedFault", "InjectedFault",
                                "CircuitOpen", "closed"]

    def test_serve_open_class_fails_future_fast(self, rng, closers):
        s = _sess(breaker_threshold=1, breaker_cooldown_ms=60_000.0,
                  fault_inject="execute:fatal:p=1.0:max=1")
        closers.append(s)
        A = s.from_numpy(rand(rng, 8, 8))
        e = A.expr().multiply(A.expr())
        with pytest.raises(InjectedFault):
            s.submit(e).result(timeout=WAIT_S)
        with pytest.raises(CircuitOpen):
            s.submit(e).result(timeout=WAIT_S)


# -- brownout ------------------------------------------------------------------

BROWNOUT = dict(brownout_enable=True, brownout_window=8,
                brownout_dwell=2, brownout_wait_high_ms=100.0,
                brownout_wait_low_ms=10.0, brownout_depth_high=16,
                brownout_depth_low=4, brownout_miss_high=0.5,
                brownout_miss_low=0.1)


def _signals(seed, n=80):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        hot = (i // 20) % 2 == 0
        waits = (rng.uniform(50, 400, 4) if hot
                 else rng.uniform(0, 8, 4)).round(3).tolist()
        depth = int(rng.integers(10, 30) if hot else rng.integers(0, 3))
        misses = int(rng.integers(0, 3)) if hot else 0
        out.append((depth, waits, misses, 4))
    return out


class TestLoadController:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_rung_sequence_equal_the_jax_packages(self, seed):
        ctl = brownout.LoadController(MatrelConfig(**BROWNOUT))
        jctl = jbrownout.LoadController(JConfig(**BROWNOUT))
        rungs, jrungs = [], []
        for depth, waits, misses, adm in _signals(seed):
            rungs.append(ctl.observe(depth, waits, misses, adm))
            jrungs.append(jctl.observe(depth, waits, misses, adm))
        assert rungs == jrungs
        assert ctl.snapshot() == jctl.snapshot()
        assert max(rungs) >= 1 and rungs[-1] < max(rungs)

    def test_hysteresis_band_holds_the_rung(self):
        ctl = brownout.LoadController(MatrelConfig(**BROWNOUT))
        for _ in range(4):
            ctl.observe(depth=0, waits_ms=[500.0] * 8, admitted=8)
        r = ctl.rung()
        assert r >= 1
        for _ in range(20):
            ctl.observe(depth=0, waits_ms=[50.0] * 8, admitted=8)
        assert ctl.rung() == r

    def test_climbs_to_max_and_saturates(self):
        ctl = brownout.LoadController(MatrelConfig(**BROWNOUT))
        for _ in range(40):
            ctl.observe(depth=100, waits_ms=[900.0] * 8, admitted=8)
        assert ctl.rung() == brownout.MAX_RUNG

    def test_downshift_stamp_equal(self):
        for st in (None, 0, 250.0):
            assert brownout.downshift_stamp(st) == \
                jbrownout.downshift_stamp(st)
        assert brownout.RUNG_LABELS == jbrownout.RUNG_LABELS

    def test_from_config_off_constructs_nothing(self):
        assert brownout.from_config(MatrelConfig()) is None

    @pytest.mark.parametrize("kw", [
        {"brownout_window": 0}, {"brownout_dwell": 0},
        {"brownout_wait_low_ms": 300.0}, {"brownout_depth_low": 64},
        {"brownout_miss_high": 1.5}, {"breaker_threshold": -1},
        {"breaker_cooldown_ms": 0.0}, {"breaker_half_open_probes": 0}])
    def test_knob_validation_equal(self, kw):
        with pytest.raises(ValueError):
            JConfig(**kw)
        with pytest.raises(ValueError):
            MatrelConfig(**kw)


class _StubController:
    """A brownout controller pinned at one rung (the reference tests'
    stub): observe() reports the pinned rung."""

    def __init__(self, rung):
        self._r = rung

    def observe(self, *a, **k):
        return self._r

    def rung(self):
        return self._r

    def snapshot(self):
        return {"rung": self._r}


class TestBrownoutActions:
    def test_rung1_downshifts_default_sla(self, rng, closers):
        s = _sess(**BROWNOUT)
        closers.append(s)
        s._brownout = _StubController(1)
        a = rand(rng, 32, 32)
        A = s.from_numpy(a)
        got = s.submit(A.expr().multiply(A.expr())).result(
            timeout=WAIT_S).to_numpy()
        want = a.astype(np.float64) @ a
        assert np.max(np.abs(got - want)) <= 2e-2 * max(
            float(np.max(np.abs(want))), 1.0)
        assert any("prec:fast|" in k for k in s._plan_cache)

    def test_rung1_leaves_explicit_sla_alone(self, rng, closers):
        s = _sess(**BROWNOUT)
        closers.append(s)
        s._brownout = _StubController(1)
        a = rand(rng, 32, 32)
        A = s.from_numpy(a)
        got = s.submit(A.expr().multiply(A.expr()),
                       precision="exact").result(timeout=WAIT_S)
        np.testing.assert_allclose(got.to_numpy(), a.astype(np.float64)
                                   @ a, rtol=1e-5, atol=1e-5)
        assert not any("prec:fast|" in k for k in s._plan_cache)

    def test_rung2_serves_stale_to_tolerant_queries(self, rng, closers):
        s = _sess(result_cache_max_bytes=64 << 20, obs_provenance=16,
                  **BROWNOUT)
        closers.append(s)
        a_old = rand(rng, 32, 32)
        A_old = s.from_numpy(a_old)
        s.register("A", A_old)
        e = A_old.expr() * 2.0
        old = s.run(e)
        s.register("A", s.from_numpy(rand(rng, 32, 32)))
        assert s.result_cache_info()["stale_entries"] == 1
        s._brownout = _StubController(2)
        fut = s.submit(e, staleness_ms=60_000.0)
        assert torch.equal(fut.result(timeout=WAIT_S).data, old.data)
        assert s._serve.stale_served == 1
        rec = s.why()[-1]
        assert rec["path"] == "stale"
        assert rec["stale"]["staleness_ms"] == 60_000.0

    def test_below_stale_rung_never_serves_stale(self, rng, closers):
        s = _sess(result_cache_max_bytes=64 << 20, **BROWNOUT)
        closers.append(s)
        A = s.from_numpy(rand(rng, 16, 16))
        s.register("A", A)
        e = A.expr() * 3.0
        s.run(e)
        s.register("A", s.from_numpy(rand(rng, 16, 16)))
        s._brownout = _StubController(1)
        s.submit(e, staleness_ms=60_000.0).result(timeout=WAIT_S)
        assert s._serve.stale_served == 0

    def test_default_config_drops_stale_on_rebind(self, rng):
        s = _sess(result_cache_max_bytes=64 << 20)
        A = s.from_numpy(rand(rng, 16, 16))
        s.register("A", A)
        s.run(A.expr() * 2.0)
        s.register("A", s.from_numpy(rand(rng, 16, 16)))
        assert s.result_cache_info()["stale_entries"] == 0

    def test_rung3_sheds_lowest_weight_tenant(self, rng, closers):
        s = _sess(serve_tenant_weights="gold:4,bronze:1", **BROWNOUT)
        closers.append(s)
        s._ensure_serve()
        s._serve._brownout = _StubController(3)
        A = s.from_numpy(rand(rng, 8, 8))
        with pytest.raises(AdmissionShed) as ei:
            s.submit(A.expr(), tenant="bronze")
        assert ei.value.scope == "brownout"
        s.submit(A.expr(), tenant="gold").result(timeout=WAIT_S)

    def test_rung3_single_implicit_tenant_sheds_nobody(self, rng,
                                                       closers):
        s = _sess(**BROWNOUT)
        closers.append(s)
        s._ensure_serve()
        s._serve._brownout = _StubController(3)
        A = s.from_numpy(rand(rng, 8, 8))
        s.submit(A.expr()).result(timeout=WAIT_S)

    def test_overload_events_follow_the_rungs(self, rng, tmp_path,
                                              closers):
        log = str(tmp_path / "e.jsonl")
        s = _sess(obs_level="on", obs_event_log=log,
                  serve_tenant_weights="a:2,b:1", **BROWNOUT)
        closers.append(s)
        A = s.from_numpy(rand(rng, 8, 8))
        for i in range(6):
            s.submit(A.expr() * float(i), tenant="ab"[i % 2]).result(
                timeout=WAIT_S)
        s.serve_drain(timeout=WAIT_S)
        ov = [e for e in read_events(log) if e["kind"] == "overload"]
        assert ov and all(e["rung"] == e["brownout"]["rung"] for e in ov)
        serves = [e for e in read_events(log) if e["kind"] == "serve"]
        assert serves and all("tenants" in e for e in serves)


# -- serve resilience ------------------------------------------------------------


class TestServeResilience:
    def test_serve_admit_transient_converges(self, rng, closers):
        s = _sess(fault_inject="serve_admit:transient:n=1",
                  retry_max_attempts=2, retry_backoff_ms=1.0)
        closers.append(s)
        a, b = rand(rng, 32, 48), rand(rng, 48, 16)
        f = s.submit(s.from_numpy(a).expr().multiply(
            s.from_numpy(b).expr()))
        np.testing.assert_allclose(f.result(timeout=WAIT_S).to_numpy(),
                                   a.astype(np.float64) @ b, rtol=TOL,
                                   atol=TOL)

    def test_readmit_and_bisect_emit_retry_events(self, rng, tmp_path,
                                                  closers):
        log = str(tmp_path / "e.jsonl")
        s = _sess(fault_inject="serve_admit:transient:n=1",
                  retry_max_attempts=2, retry_backoff_ms=1.0,
                  obs_level="on", obs_event_log=log)
        closers.append(s)
        A = s.from_numpy(rand(rng, 8, 8))
        s.submit(A.expr()).result(timeout=WAIT_S)
        retries = [e for e in read_events(log) if e["kind"] == "retry"]
        assert retries and retries[0]["scope"] == "serve_readmit"

    def test_drain_timeout_typed_on_wedged_worker(self, rng):
        from matrel_tpu_torch.serve.pipeline import ServePipeline
        s = _sess()
        p = ServePipeline(s)
        p._ensure_worker = lambda: None
        p.submit(s.from_numpy(rand(rng, 8, 8)).expr())
        with pytest.raises(DrainTimeout) as ei:
            p.drain(timeout=0.1)
        assert ei.value.pending == 1


class TestRobustReaders:
    def test_corrupt_drift_table_warns_and_rebuilds(self, tmp_path,
                                                    caplog):
        from matrel_tpu_torch.obs import drift
        p = tmp_path / "t.json"
        p.write_text("{broken")
        assert drift.load_table(str(p))["entries"] == {}
        assert "corrupt" in caplog.text

    def test_absent_table_reads_silently_empty(self, tmp_path, caplog):
        from matrel_tpu_torch.obs import drift
        assert drift.load_table(str(tmp_path / "none.json"))["entries"] \
            == {}
        assert "corrupt" not in caplog.text

    def test_corrupt_event_log_line_skipped_with_warning(self, tmp_path,
                                                         caplog):
        p = tmp_path / "e.jsonl"
        p.write_text(json.dumps({"schema": 1, "kind": "a"}) + "\n{torn\n")
        assert [e["kind"] for e in read_events(str(p))] == ["a"]
        assert "corrupt" in caplog.text
