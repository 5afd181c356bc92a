"""PyTorch port: the answer provenance ledger
(``matrel_tpu_torch/obs/provenance.py``) and ``session.why`` held
against the JAX package's on the CPU, mirroring
``tests/test_provenance.py`` (less its fleet hop, whose plane is not
ported, its ``why`` CLI and the MV115 verifier pass, which belong to
``__main__`` and ``analysis/``).

The same query sequence through a JAX session (1 x 1 mesh) and a port
session yields the same lineage records: path, SLA, rung, error bound,
cache ancestry (whole / interior, stamps), IVM patch chains, staleness
grants, degrade stamps and strategy stamps — field for field, with the
id()-derived ``key_hash`` / ``query_id`` fields compared by structure
(each ledger's own ids must cross-reference consistently) instead of by
value. Audit replay proves every served answer bit-equal (exact paths)
and catches a seeded corruption. ``obs_provenance = 0`` builds no ledger
or record object (poisoned ``__init__``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.obs import provenance as jprov
from matrel_tpu.resilience import faults as jfaults
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.obs import provenance as provenance_lib
from matrel_tpu_torch.obs.events import read_events
from matrel_tpu_torch.resilience import faults
from matrel_tpu_torch.session import MatrelSession

WAIT_S = 60.0
_IDS = ("key_hash", "query_id")


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


def twins(jmesh, **cfg):
    cfg.setdefault("obs_provenance", 64)
    cfg.setdefault("result_cache_max_bytes", 1 << 26)
    return (JSession(mesh=jmesh, config=JConfig(**cfg)),
            MatrelSession(config=MatrelConfig(**cfg), device="cpu"))


def _session(**cfg):
    cfg.setdefault("obs_provenance", 64)
    cfg.setdefault("result_cache_max_bytes", 1 << 26)
    return MatrelSession(config=MatrelConfig(**cfg), device="cpu")


def rand(rng, n, m):
    return rng.standard_normal((n, m)).astype(np.float32)


def _paths(sess):
    return [r.path for r in sess._prov.records()]


def canon(summaries):
    """Lineage summaries with every id-derived token replaced by its
    first-appearance index (per ledger), so two ledgers compare by
    structure: the same fields, the same cross-references."""
    table: dict = {}

    def walk(v, key=None):
        if isinstance(v, dict):
            return {k: walk(x, k) for k, x in v.items()}
        if isinstance(v, list):
            return [walk(x) for x in v]
        if key in _IDS and isinstance(v, str):
            return f"#{table.setdefault(v, len(table))}"
        return v

    return [walk(s) for s in summaries]


def _same_ledgers(js, ts):
    assert canon(ts.why(last=0)) == canon(js.why(last=0))


class TestLedgerCapture:
    def test_execute_then_hit_then_interior(self, jmesh, rng):
        js, ts = twins(jmesh)
        a, b = rand(rng, 48, 64), rand(rng, 64, 32)
        for s in (js, ts):
            A, B = s.from_numpy(a), s.from_numpy(b)
            s.run(A.expr().multiply(B.expr()))
            s.run(A.expr().multiply(B.expr()))
            s.run(A.expr().multiply(B.expr()).multiply_scalar(2.0))
        assert _paths(ts) == ["execute", "rc_hit", "rc_interior"]
        _same_ledgers(js, ts)
        recs = ts._prov.records()
        assert all(r.expr is not None and r.result is not None
                   for r in recs)
        cache = recs[2].summary["cache"]
        assert cache["kind"] == "interior"
        assert cache["leaves"][0]["provenance"]["query_id"] == \
            recs[0].query_id
        assert recs[1].summary["cache"]["entry"]["provenance"][
            "query_id"] == recs[0].query_id

    def test_execute_record_carries_strategy_stamps(self, jmesh, rng):
        js, ts = twins(jmesh, mesh_shape=(1, 1))
        a = rand(rng, 32, 32)
        for s in (js, ts):
            A = s.from_numpy(a)
            s.run(A.expr().multiply(A.expr()))
        (rec,) = ts._prov.records()
        assert rec.summary["strategies"] == [
            {"strategy": "xla", "source": "default"}]
        _same_ledgers(js, ts)

    def test_ivm_patched_record_carries_chain(self, jmesh, rng):
        js, ts = twins(jmesh)
        adj = (rng.random((32, 32)) < 0.2).astype(np.float32)
        deltas = [(rng.integers(0, 32, 4), rng.integers(0, 32, 4))
                  for _ in range(2)]
        for s in (js, ts):
            s.register("A", s.from_numpy(adj.copy(), integral=True))

            def q():
                return s.table("A").expr().multiply(s.table("A").expr())

            s.run(q())
            for rows, cols in deltas:
                s.register_delta("A", (rows, cols,
                                       np.ones(4, np.float32)),
                                 kind="coo")
            s.run(q())
        rec = ts._prov.records()[-1]
        assert rec.path == "ivm_patched" and rec.err_bound == 0.0
        chain = rec.summary["cache"]["ivm"]["chain"]
        assert [c["gen"] for c in chain] == [1, 2]
        _same_ledgers(js, ts)

    @pytest.mark.parametrize("fires", [1, 3, 4])
    def test_degraded_record_stamps_rung(self, jmesh, rng, fires):
        js, ts = twins(jmesh,
                       fault_inject=f"execute:transient:p=1.0:max={fires}",
                       retry_max_attempts=4, retry_backoff_ms=0.0)
        a, b = rand(rng, 32, 48), rand(rng, 48, 16)
        outs = []
        for s in (js, ts):
            outs.append(s.run(s.from_numpy(a).expr().multiply(
                s.from_numpy(b).expr())))
        rec = ts._prov.records()[-1]
        assert rec.path == "degraded" and rec.rung == fires
        assert rec.summary["degrade"] == {
            "rung": fires,
            "label": ("no-autotune", "xla-strategy", "no-kernels",
                      "no-result-cache")[fires - 1]}
        _same_ledgers(js, ts)
        np.testing.assert_allclose(outs[1].to_numpy(),
                                   outs[0].to_numpy(), rtol=1e-5,
                                   atol=1e-5)

    def test_stale_capture_carries_grant(self, jmesh, rng):
        js, ts = twins(jmesh)
        a = rand(rng, 32, 32)
        for s in (js, ts):
            A = s.from_numpy(a)
            e = A.expr().multiply(A.expr())
            s.run(e)
            (_, ent), = s._result_cache.items_snapshot()
            s._prov_capture_stale(e, ent, {"sla": None,
                                           "staleness_ms": 125.0,
                                           "tenant": "t0"})
        rec = ts._prov.records()[-1]
        assert rec.path == "stale"
        assert rec.summary["stale"] == {"staleness_ms": 125.0,
                                        "tenant": "t0"}
        _same_ledgers(js, ts)

    def test_cse_paths_equal(self, jmesh, rng):
        js, ts = twins(jmesh, cse_enable=True)
        a, b = rand(rng, 24, 24), rand(rng, 24, 24)
        for s in (js, ts):
            A, B = s.from_numpy(a), s.from_numpy(b)
            shared = A.expr().multiply(B.expr())
            s.run_many([shared.multiply_scalar(2.0),
                        shared.multiply_scalar(3.0)])
        paths = _paths(ts)
        assert "cse_hoist" in paths and "cse_interior" in paths
        _same_ledgers(js, ts)

    def test_batch_and_precision_records_equal(self, jmesh, rng):
        js, ts = twins(jmesh)
        a = rand(rng, 16, 16)
        for s in (js, ts):
            A = s.from_numpy(a)
            s.run_many([A.expr().t(), A.expr() * 2.0, A.expr().t()])
            s.run(A.expr().multiply(A.expr()), precision="fast")
        _same_ledgers(js, ts)
        assert ts.why(last=1)[0]["sla"] == "fast"

    def test_ledger_records_answers_without_cache_or_obs(self, jmesh,
                                                          rng):
        """With only ``obs_provenance`` on (no result cache, obs off)
        every answer still appends its record, as the ledger promises;
        the JAX package's fast-path gate omits the ledger, so there a
        plain compute() records nothing (a reference difference the
        port does not follow; the answers agree)."""
        cfg = dict(obs_provenance=8)
        js = JSession(mesh=jmesh, config=JConfig(**cfg))
        ts = MatrelSession(config=MatrelConfig(**cfg), device="cpu")
        a = rand(rng, 16, 16)
        outs = [s.run(s.from_numpy(a).expr().multiply(
            s.from_numpy(a).expr())) for s in (js, ts)]
        np.testing.assert_allclose(outs[1].to_numpy(), outs[0].to_numpy(),
                                   rtol=1e-5, atol=1e-5)
        assert js.why() == []
        [rec] = ts.why()
        assert rec["path"] == "execute" and rec["strategies"]

    def test_bounded_ledger_evicts_oldest(self, rng):
        s = _session(obs_provenance=3)
        A = s.from_numpy(rand(rng, 16, 16))
        for i in range(5):
            s.run(A.expr().multiply_scalar(float(i + 1)))
        info = s.provenance_info()
        assert (info["records"], info["cap"], info["captured"]) == \
            (3, 3, 5)

    def test_provenance_event_emitted(self, rng, tmp_path):
        log = str(tmp_path / "events.jsonl")
        s = _session(obs_level="on", obs_event_log=log)
        A = s.from_numpy(rand(rng, 32, 32))
        s.run(A.expr().multiply(A.expr()))
        evs = read_events(log, kinds=("provenance",))
        assert len(evs) == 1 and evs[0]["path"] == "execute"
        assert evs[0]["schema"] == provenance_lib.SCHEMA_VERSION \
            == jprov.SCHEMA_VERSION
        assert provenance_lib.PATHS == jprov.PATHS


class TestWhyConsole:
    def test_why_filters_and_render(self, jmesh, rng):
        js, ts = twins(jmesh)
        a = rand(rng, 32, 32)
        outs = []
        for s in (js, ts):
            A = s.from_numpy(a)
            o1 = s.run(A.expr().multiply(A.expr()))
            o2 = s.run(A.expr().multiply(A.expr()))
            outs.append((o1, o2))
        o1, o2 = outs[1]
        assert len(ts.why()) == 2
        assert ts.why(last=1)[0]["path"] == "rc_hit"
        assert o1 is o2
        assert {x["path"] for x in ts.why(o2)} == {"execute", "rc_hit"}
        qid = ts.why()[0]["query_id"]
        assert ts.why(qid)[0]["query_id"] == qid
        assert len(ts.why(ts.why()[0]["key_hash"])) == 2
        # the same summary renders identically through either package
        for summ in ts.why():
            assert provenance_lib.render(summ) == jprov.render(summ)
        text = provenance_lib.render(ts.why(last=1)[0])
        assert "path=rc_hit" in text and "cache: whole hit" in text

    def test_why_off_session_returns_empty(self, rng):
        s = MatrelSession(device="cpu")
        A = s.from_numpy(rand(rng, 16, 16))
        s.run(A.expr().t())
        assert s.why() == []
        assert s.provenance_info()["records"] == 0

    def test_render_degraded_and_stale_equal(self, jmesh, rng):
        js, ts = twins(jmesh, fault_inject="execute:transient:n=1",
                       retry_max_attempts=2, retry_backoff_ms=0.0)
        a = rand(rng, 8, 8)
        for s in (js, ts):
            s.run(s.from_numpy(a).expr() * 4.0)
        summ = ts.why(last=1)[0]
        assert "degrade: rung 1 (no-autotune)" in \
            provenance_lib.render(summ)
        assert provenance_lib.render(summ) == jprov.render(summ)


class TestAuditReplay:
    def test_audit_proves_all_paths(self, rng):
        s = _session()
        A, B = s.from_numpy(rand(rng, 48, 64)), s.from_numpy(
            rand(rng, 64, 32))
        s.run(A.expr().multiply(B.expr()))
        s.run(A.expr().multiply(B.expr()))
        s.run(A.expr().multiply(B.expr()).multiply_scalar(2.0))
        verdict = provenance_lib.audit(s, sample=0)
        assert verdict["ok"]
        assert verdict["sampled"] == verdict["replayable"] == 3
        assert all(r["exact"] for r in verdict["results"])

    def test_audit_catches_seeded_corruption(self, rng):
        cfg = MatrelConfig(obs_provenance=64,
                           result_cache_max_bytes=1 << 26)
        s = MatrelSession(config=cfg, device="cpu")
        A, B = s.from_numpy(rand(rng, 32, 48)), s.from_numpy(
            rand(rng, 48, 16))
        s.run(A.expr().multiply(B.expr()))
        (key, ent), = s._result_cache.items_snapshot()
        corrupt = s.from_numpy(ent.result.to_numpy() + 1.0)
        tampered = dataclasses.replace(ent, result=corrupt)
        assert s._result_cache.apply_patch(
            key, key, tampered, cfg.result_cache_max_bytes,
            cfg.result_cache_max_entries)
        served = s.run(A.expr().multiply(B.expr()))
        assert torch.equal(served.data, corrupt.data)
        verdict = provenance_lib.audit(s, sample=0)
        assert not verdict["ok"]
        bad = [r for r in verdict["results"] if not r["ok"]]
        assert bad and bad[0]["path"] == "rc_hit"
        assert bad[0]["rel_err"] > 0.0

    def test_audit_sampling_keeps_newest(self, rng):
        s = _session()
        A = s.from_numpy(rand(rng, 8, 8))
        for i in range(10):
            s.run(A.expr().multiply_scalar(float(i + 1)))
        verdict = provenance_lib.audit(s, sample=3)
        assert verdict["sampled"] == 3 and verdict["ok"]
        assert verdict["results"][-1]["query_id"] == \
            s._prov.records()[-1].query_id


class TestZeroOverhead:
    def test_default_config_builds_no_ledger_objects(self, rng,
                                                     monkeypatch):
        def no_ledgers(self, *a, **kw):
            raise AssertionError("ProvenanceLedger constructed")

        def no_records(self, *a, **kw):
            raise AssertionError("ProvenanceRecord constructed")

        monkeypatch.setattr(provenance_lib.ProvenanceLedger, "__init__",
                            no_ledgers)
        monkeypatch.setattr(provenance_lib.ProvenanceRecord, "__init__",
                            no_records)
        s = MatrelSession(config=MatrelConfig(
            result_cache_max_bytes=1 << 26, cse_enable=True),
            device="cpu")
        assert s._prov is None
        A, B = s.from_numpy(rand(rng, 48, 64)), s.from_numpy(
            rand(rng, 64, 32))
        s.run_many([A.expr().multiply(B.expr())])
        s.run(A.expr().multiply(B.expr()))
        s.run(A.expr().multiply(B.expr()).multiply_scalar(2.0))
        for _, ent in s._result_cache.items_snapshot():
            assert ent.provenance is None
        assert s.why() == []

    def test_ledger_answers_are_the_plain_answers(self, rng):
        a, b = rand(rng, 32, 16), rand(rng, 16, 8)
        outs = []
        for cfg in (MatrelConfig(), MatrelConfig(obs_provenance=8)):
            s = MatrelSession(config=cfg, device="cpu")
            outs.append(s.run(s.from_numpy(a).expr().multiply(
                s.from_numpy(b).expr())))
        assert torch.equal(outs[0].data, outs[1].data)

    def test_config_validation(self):
        with pytest.raises(ValueError, match="obs_provenance"):
            MatrelConfig(obs_provenance=-1)
        assert provenance_lib.from_config(MatrelConfig()) is None
        assert isinstance(provenance_lib.from_config(
            MatrelConfig(obs_provenance=4)),
            provenance_lib.ProvenanceLedger)
