"""PyTorch port: the observability plane (``matrel_tpu_torch/obs/``,
``utils/profiling.py``) held against the JAX package's on the CPU,
mirroring ``tests/test_obs.py`` (less its CLI classes, ``TestHistory``
and ``TestHistorySketchAgreement``, which belong to the JAX package's
``__main__``).

The same config and query sequence go through a JAX session (1 x 1
mesh) and a port session (``device="cpu"``) over matrices made from the
same seeded numpy arrays. Compared:

- the query / serve / analyze records field for field, timings
  (``ts``, ``*_ms``, ``t0``) and id()-derived fields (``query_id``,
  ``source_hash``, decision-record ``uid``) excepted; ``plan_cache``
  on its ``plans`` / ``evicted`` counts (the port pins no hoisted
  payloads — ``plan_cache_max_bytes`` stays fenced);
- the metrics registry's counter names and values, histogram names
  and counts;
- span trees as (name, parent name) multisets, the ``plan.verify``
  phase included;
- ``verify`` records (mode, count, errors, codes) with the static
  verifier's diagnostics;
- quantile sketches bucket for bucket and quantile for quantile (both
  are the same pure-Python arithmetic);
- drift-table keys, ratios and flags from the same injected records,
  and each package's reading of the other's event log and table.

Results agree within the JAX tests' tolerances (rtol/atol 1e-5 between
the packages). The OFF contract is structural: with default knobs no
``EventLog``, ``Span``, ``FlightRecorder``, ``SLOPlane``,
``MetricsExporter`` or ``ProvenanceLedger`` is constructed (poisoned
``__init__``), no thread or socket opens, and no device sync runs.
"""

import inspect
import json
import os
import socket
import threading
import urllib.request

import jax
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.obs import drift as jdrift
from matrel_tpu.obs import events as jevents
from matrel_tpu.obs import metrics as jmetrics
from matrel_tpu.obs import slo as jslo
from matrel_tpu.obs.trace import chrome_trace as jchrome_trace
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch import executor as t_exec
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.obs import analyze as t_analyze
from matrel_tpu_torch.obs import drift
from matrel_tpu_torch.obs import events as tevents
from matrel_tpu_torch.obs import export as t_export
from matrel_tpu_torch.obs import metrics
from matrel_tpu_torch.obs import provenance as t_prov
from matrel_tpu_torch.obs import slo
from matrel_tpu_torch.obs import trace as t_trace
from matrel_tpu_torch.obs.events import (EventLog, SCHEMA_VERSION,
                                         read_events)
from matrel_tpu_torch.obs.metrics import (MetricsRegistry,
                                          QuantileSketch, percentile)
from matrel_tpu_torch.session import MatrelSession
from matrel_tpu_torch.utils import profiling

WAIT_S = 60.0
TIMING = ("ts", "optimize_ms", "trace_ms", "execute_ms", "wall_ms",
          "query_id", "source_hash", "t0", "dur_ms")


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture(autouse=True)
def _fresh_registries():
    metrics.REGISTRY.reset()
    jmetrics.REGISTRY.reset()
    yield


def twins(jmesh, tmp_path, **cfg):
    """A JAX session and a port session on the same knobs, each
    logging to its own file."""
    jc = dict(cfg)
    tc = dict(cfg)
    if cfg.get("obs_level", "off") != "off" or "obs_event_log" in cfg:
        jc["obs_event_log"] = str(tmp_path / "j.jsonl")
        tc["obs_event_log"] = str(tmp_path / "t.jsonl")
    js = JSession(mesh=jmesh, config=JConfig(**jc))
    ts = MatrelSession(config=MatrelConfig(**tc), device="cpu")
    return js, ts


def arrs(seed=42):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((24, 32), (32, 40), (40, 16))]


def chain(s, a):
    A, B, C = (s.from_numpy(x) for x in a)
    return A.expr() @ B.expr() @ C.expr()


def strip(rec: dict) -> dict:
    out = {k: v for k, v in rec.items() if k not in TIMING}
    if "plan_cache" in out:
        out["plan_cache"] = {k: out["plan_cache"].get(k)
                             for k in ("plans", "evicted")}
    if "matmuls" in out:
        out["matmuls"] = [{k: v for k, v in d.items() if k != "uid"}
                          for d in out["matmuls"]]
    return out


def kinds(path, kind):
    return [e for e in read_events(path) if e["kind"] == kind]


def span_tree(path):
    spans = [e for e in read_events(path) if e["kind"] == "span"]
    by_id = {s["span_id"]: s for s in spans}
    out = []
    for s in spans:
        p = by_id.get(s["parent_id"])
        out.append((s["name"], p["name"] if p else None))
    return sorted(out, key=repr)


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got.to_numpy(), np.float64),
                               np.asarray(want.to_numpy(), np.float64),
                               rtol=tol, atol=tol)


# -- metrics registry ---------------------------------------------------------


class TestMetricsRegistry:
    def test_counter_semantics(self):
        reg = MetricsRegistry()
        c = reg.counter("plan_cache.hit")
        c.inc()
        c.inc(2.5)
        assert c.value == 3.5
        assert reg.counter("plan_cache.hit") is c
        assert reg.counter("plan_cache.miss").value == 0.0

    def test_gauge_last_write_wins(self):
        reg = MetricsRegistry()
        g = reg.gauge("plan_cache.plans")
        g.set(3)
        g.set(1)
        assert g.value == 1.0

    def test_histogram_semantics_equal_the_jax_packages(self):
        vals = (4.0, 1.0, 3.0, 2.0, 7.5, 0.0)
        h = MetricsRegistry().histogram("x")
        jh = jmetrics.MetricsRegistry().histogram("x")
        for v in vals:
            h.observe(v)
            jh.observe(v)
        assert h.summary() == jh.summary()
        for q in (0.0, 0.25, 0.5, 0.9, 1.0):
            assert h.percentile(q) == jh.percentile(q)

    def test_histogram_sketch_bounded(self):
        h = MetricsRegistry().histogram("x")
        n = 3 * metrics._MAX_BUCKETS
        for v in range(n):
            h.observe(float(v) * 1e3 + 0.5)
        assert len(h._sketch._buckets) <= metrics._MAX_BUCKETS
        assert h.count == n and h.min == 0.5

    def test_snapshot_and_reset(self):
        reg = MetricsRegistry()
        reg.counter("a").inc()
        reg.gauge("b").set(2)
        reg.histogram("c").observe(1.0)
        snap = reg.snapshot()
        assert snap["counters"] == {"a": 1.0}
        assert snap["gauges"] == {"b": 2.0}
        assert snap["histograms"]["c"]["count"] == 1
        json.dumps(snap)
        reg.reset()
        assert reg.snapshot() == {"counters": {}, "gauges": {},
                                  "histograms": {}}

    def test_thread_safety(self):
        reg = MetricsRegistry()

        def work():
            for _ in range(1000):
                reg.counter("n").inc()
                reg.histogram("h").observe(1.0)

        ts = [threading.Thread(target=work) for _ in range(4)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(WAIT_S)
        assert reg.counter("n").value == 4000
        assert reg.histogram("h").count == 4000


class TestQuantileSketch:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_buckets_and_quantiles_bit_equal(self, seed):
        rng = np.random.default_rng(seed)
        vals = rng.lognormal(0.0, 2.0, 2000).tolist() + [0.0, 1e-12]
        sk, jsk = QuantileSketch(), jmetrics.QuantileSketch()
        for v in vals:
            sk.add(v)
            jsk.add(v)
        assert sk.to_dict() == jsk.to_dict()
        for q in np.linspace(0.0, 1.0, 41):
            assert sk.quantile(q) == jsk.quantile(q)

    @pytest.mark.parametrize("split", [1, 100, 999])
    def test_merge_bit_equal_and_order_free(self, split):
        rng = np.random.default_rng(split)
        vals = rng.exponential(3.0, 1000).tolist()
        a, b = QuantileSketch(), QuantileSketch()
        ja, jb = jmetrics.QuantileSketch(), jmetrics.QuantileSketch()
        for v in vals[:split]:
            a.add(v)
            ja.add(v)
        for v in vals[split:]:
            b.add(v)
            jb.add(v)
        a.merge(b)
        ja.merge(jb)
        assert a.to_dict() == ja.to_dict()
        # the other merge order lands on the same buckets
        b2 = QuantileSketch.from_dict(jb.to_dict())
        b2.merge(QuantileSketch.from_dict(
            {**ja.to_dict(), "count": 0, "sum": 0.0, "zeros": 0,
             "buckets": {}, "min": None, "max": None}))
        assert b2.to_dict()["buckets"] == jb.to_dict()["buckets"]

    def test_cross_package_from_dict(self):
        sk = QuantileSketch()
        for v in (1.0, 2.0, 3.0, 50.0):
            sk.add(v)
        jsk = jmetrics.QuantileSketch.from_dict(sk.to_dict())
        back = QuantileSketch.from_dict(jsk.to_dict())
        assert back.to_dict() == sk.to_dict()
        assert jsk.quantile(0.5) == sk.quantile(0.5)

    def test_relative_error_bound(self):
        rng = np.random.default_rng(5)
        vals = rng.uniform(0.1, 1000.0, 5000)
        sk = QuantileSketch()
        for v in vals:
            sk.add(v)
        s = np.sort(vals)
        for q in (0.1, 0.5, 0.9, 0.95, 0.99):
            true = s[int(q * (len(s) - 1))]
            assert abs(sk.quantile(q) - true) <= \
                metrics.DEFAULT_ALPHA * true * (1 + 1e-9)

    def test_collapse_bounds_buckets_keeps_high_q(self):
        sk = QuantileSketch(max_buckets=16)
        jsk = jmetrics.QuantileSketch(max_buckets=16)
        for e in range(-20, 20):
            sk.add(10.0 ** (e / 4))
            jsk.add(10.0 ** (e / 4))
        assert len(sk._buckets) <= 16
        assert sk.to_dict() == jsk.to_dict()
        assert sk.quantile(0.99) == jsk.quantile(0.99)

    def test_validation_and_percentile(self):
        with pytest.raises(ValueError):
            QuantileSketch(alpha=0.0)
        with pytest.raises(ValueError):
            QuantileSketch(max_buckets=1)
        with pytest.raises(ValueError, match="alpha"):
            QuantileSketch(0.01).merge(QuantileSketch(0.02))
        assert percentile([], 0.5) is None
        vals = [3.0, 1.0, 2.0, 10.0]
        assert percentile(vals, 0.95) == jmetrics.percentile(vals, 0.95)


# -- event log ----------------------------------------------------------------


class TestEventLog:
    def test_jsonl_round_trip(self, tmp_path):
        log = EventLog(str(tmp_path / "ev.jsonl"))
        rec = log.emit("query", {"x": 1})
        assert rec["schema"] == SCHEMA_VERSION and rec["kind"] == "query"
        [back] = read_events(log.path)
        assert back["x"] == 1

    def test_numpy_and_tensor_values_serialise(self, tmp_path):
        log = EventLog(str(tmp_path / "ev.jsonl"))
        log.emit("x", {"a": np.float32(1.5), "b": np.arange(3),
                       "c": torch.tensor([1, 2])})
        [back] = read_events(log.path)
        assert back["a"] == 1.5 and back["b"] == [0, 1, 2]
        assert back["c"] == [1, 2]

    def test_reader_skips_garbage_and_foreign_schema(self, tmp_path):
        p = tmp_path / "ev.jsonl"
        p.write_text('{"schema": 1, "kind": "a"}\nnot json\n'
                     '{"schema": 99, "kind": "b"}\n[1]\n')
        assert [e["kind"] for e in read_events(str(p))] == ["a"]

    def test_missing_file_reads_empty(self, tmp_path):
        assert read_events(str(tmp_path / "nope.jsonl")) == []

    def test_emit_never_raises(self, tmp_path):
        log = EventLog(str(tmp_path / "no_dir" / "ev.jsonl"))
        assert log.emit("x", {"a": 1}) is None

    def test_schema_version_is_the_jax_packages(self):
        assert SCHEMA_VERSION == jevents.SCHEMA_VERSION
        assert tevents.DEFAULT_EVENT_LOG == jevents.DEFAULT_EVENT_LOG


class TestEventLogRotation:
    def test_off_path_never_rotates(self, tmp_path):
        log = EventLog(str(tmp_path / "ev.jsonl"))
        for i in range(50):
            log.emit("x", {"i": i})
        assert not os.path.exists(log.path + ".1")

    def test_rotates_to_single_sibling_and_readers_stitch(self, tmp_path):
        log = EventLog(str(tmp_path / "ev.jsonl"), max_bytes=400)
        for i in range(40):
            log.emit("x", {"i": i})
        assert os.path.exists(log.path + ".1")
        got = [e["i"] for e in read_events(log.path)]
        assert got == sorted(got) and got[-1] == 39
        # the JAX package's reader stitches the port's pair the same way
        assert [e["i"] for e in jevents.read_events(log.path)] == got

    def test_tail_bytes_spans_both_files(self, tmp_path):
        log = EventLog(str(tmp_path / "ev.jsonl"), max_bytes=300)
        for i in range(30):
            log.emit("x", {"i": i})
        tail = read_events(log.path, tail_bytes=500)
        assert tail and tail[-1]["i"] == 29
        assert [e["i"] for e in jevents.read_events(
            log.path, tail_bytes=500)] == [e["i"] for e in tail]

    def test_session_knob_rotates(self, jmesh, tmp_path):
        s = MatrelSession(config=MatrelConfig(
            obs_level="on", obs_event_log=str(tmp_path / "ev.jsonl"),
            obs_event_log_max_bytes=2000), device="cpu")
        A = s.from_numpy(np.eye(8, dtype=np.float32))
        for _ in range(12):
            s.compute(A.multiply(A))
        assert os.path.exists(str(tmp_path / "ev.jsonl.1"))
        assert len(kinds(str(tmp_path / "ev.jsonl"), "query")) >= 1


class TestCrossPackageLogs:
    def test_each_package_reads_the_others_log(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on")
        a = arrs()
        js.run(chain(js, a))
        ts.run(chain(ts, a))
        j_by_t = tevents.read_events(js.config.obs_event_log)
        t_by_j = jevents.read_events(ts.config.obs_event_log)
        assert [e["kind"] for e in j_by_t] == \
            [e["kind"] for e in jevents.read_events(
                js.config.obs_event_log)]
        assert [e["kind"] for e in t_by_j] == \
            [e["kind"] for e in read_events(ts.config.obs_event_log)]
        assert {e["kind"] for e in t_by_j} >= {"query", "span"}


# -- session events -----------------------------------------------------------


class TestSessionEvents:
    def test_query_records_equal_field_for_field(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on")
        a = arrs()
        for s in (js, ts):
            e = chain(s, a)
            s.run(e)
            s.run(e)
        jq = kinds(js.config.obs_event_log, "query")
        tq = kinds(ts.config.obs_event_log, "query")
        assert [r["cache"] for r in tq] == ["miss", "hit"]
        assert [strip(r) for r in tq] == [strip(r) for r in jq]
        assert tq[0]["backend"] == "cpu"
        assert "execute_clock" not in tq[0]

    def test_metric_names_and_counts_equal(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on")
        a = arrs()
        for s in (js, ts):
            e = chain(s, a)
            s.run(e)
            s.run(e)
            s.run_many([e, s.from_numpy(a[0]).expr().t()])
        tsnap = metrics.REGISTRY.snapshot()
        jsnap = jmetrics.REGISTRY.snapshot()
        assert tsnap["counters"] == jsnap["counters"]
        assert tsnap["counters"]["query.count"] == 4
        jg = {k for k in jsnap["gauges"] if k != "plan_cache.hoisted_bytes"}
        assert set(tsnap["gauges"]) == jg
        assert {k: h["count"] for k, h in tsnap["histograms"].items()} \
            == {k: h["count"] for k, h in jsnap["histograms"].items()}

    def test_rule_hits_compile_scoped(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on")
        a = arrs()
        for s in (js, ts):
            e = chain(s, a).t()
            s.run(e)
            s.run(e)
        tq = kinds(ts.config.obs_event_log, "query")
        jq = kinds(js.config.obs_event_log, "query")
        assert tq[1]["rule_hits"] == {}
        assert [r["rule_hits"] for r in tq] == [r["rule_hits"] for r in jq]

    def test_sql_source_tag(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on")
        a = arrs()
        for s in (js, ts):
            s.register("A", s.from_numpy(a[0]))
            s.run(s.sql("SELECT A * A FROM A") if False else
                  s.sql("SELECT A + A FROM A"))
        tq = kinds(ts.config.obs_event_log, "query")
        jq = kinds(js.config.obs_event_log, "query")
        assert tq[0]["source"] == jq[0]["source"] == "sql"
        assert tq[0]["source_hash"] == jq[0]["source_hash"]

    def test_eviction_counted(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on",
                       plan_cache_max_plans=1)
        a = arrs()
        for s in (js, ts):
            X = s.from_numpy(a[0])
            s.run(X.expr().t())
            s.run(X.expr() * 2.0)
        tq = kinds(ts.config.obs_event_log, "query")
        jq = kinds(js.config.obs_event_log, "query")
        assert tq[-1]["plan_cache"]["evicted"] == \
            jq[-1]["plan_cache"]["evicted"] == 1

    def test_serve_and_batched_query_records_equal(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on",
                       result_cache_max_bytes=1 << 22)
        a = arrs()
        for s in (js, ts):
            e = chain(s, a)
            X = s.from_numpy(a[0])
            s.run_many([e, X.expr().t()], tenant="t1")
            s.run_many([e, X.expr().t(), X.expr() * 3.0])
        for kind in ("serve", "query"):
            tr = [strip(r) for r in kinds(ts.config.obs_event_log, kind)]
            jr = [strip(r) for r in kinds(js.config.obs_event_log, kind)]
            assert tr == jr, kind
        serves = kinds(ts.config.obs_event_log, "serve")
        assert serves[1]["rc_hits"] == 2
        assert serves[0]["tenants"] == {"t1": 2}

    def test_results_unchanged_by_obs(self, tmp_path):
        a = arrs()
        off = MatrelSession(device="cpu")
        on = MatrelSession(config=MatrelConfig(
            obs_level="on", obs_event_log=str(tmp_path / "e.jsonl"),
            obs_flight_recorder=16, obs_provenance=8), device="cpu")
        r0 = off.run(chain(off, a))
        r1 = on.run(chain(on, a))
        assert torch.equal(r0.data, r1.data)


class TestExplainAnalyze:
    def test_one_timed_row_per_physical_op(self, tmp_path):
        ts = MatrelSession(device="cpu")
        text = ts.explain(chain(ts, arrs()), analyze=True)
        section = text.split("== Analyzed physical plan")[1]
        timed = [ln for ln in section.splitlines() if " ms]" in ln]
        # two matmuls and three leaves
        assert len(timed) == 5
        assert sum("matmul" in ln for ln in timed) == 2
        assert "plan as run:" in section

    def test_per_op_times_are_exclusive(self):
        ts = MatrelSession(device="cpu")
        plan = ts.compile(chain(ts, arrs()))
        per_op, total = t_analyze.measure_per_op(plan)
        assert sum(s for _, s in per_op.values()) <= total * 1.05 + 1e-3
        labels = sorted(lbl for lbl, _ in per_op.values())
        assert labels.count("matmul:xla") == 2

    def test_labels_equal_the_jax_packages(self, jmesh, tmp_path):
        from matrel_tpu.obs import analyze as jan
        js, ts = twins(jmesh, tmp_path)
        a = arrs()
        jplan = js.compile(chain(js, a))
        tplan = ts.compile(chain(ts, a))
        jl = sorted(lbl for lbl, _ in jan.measure_per_op(jplan)[0].values())
        tl = sorted(lbl for lbl, _ in
                    t_analyze.measure_per_op(tplan)[0].values())
        assert tl == jl

    def test_analyze_requires_physical(self):
        ts = MatrelSession(device="cpu")
        with pytest.raises(ValueError, match="physical"):
            ts.explain(chain(ts, arrs()), physical=False, analyze=True)

    def test_explain_sql_analyze(self):
        ts = MatrelSession(device="cpu")
        ts.register("A", ts.from_numpy(arrs()[0]))
        text = ts.explain_sql("SELECT A + A FROM A", analyze=True)
        assert "== Analyzed physical plan" in text and " ms]" in text

    def test_obs_level_analyze_measures_every_explain(self):
        ts = MatrelSession(config=MatrelConfig(obs_level="analyze",
                                               obs_event_log=os.devnull),
                           device="cpu")
        assert "== Analyzed" in ts.explain(chain(ts, arrs()))

    def test_analyze_syncs_only_through_the_hook(self, monkeypatch):
        """The lowering's one sync point is the analyze hook: a normal
        run calls it zero times, an analyzed run once per node edge."""
        calls = []
        monkeypatch.setattr(t_exec, "_device_sync",
                            lambda mesh: calls.append(mesh))
        ts = MatrelSession(device="cpu")
        plan = ts.compile(chain(ts, arrs()))
        plan.run()
        assert calls == []
        per_op, _ = t_analyze.measure_per_op(plan)
        assert len(calls) == 2 * len(per_op)


class TestAnalyzeEvent:
    def test_analyze_record_equal_the_jax_packages(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on")
        a = arrs()
        js.explain(chain(js, a), analyze=True)
        ts.explain(chain(ts, a), analyze=True)
        [tr] = kinds(ts.config.obs_event_log, "analyze")
        [jr] = kinds(js.config.obs_event_log, "analyze")
        assert tr["backend"] == jr["backend"] == "cpu"
        uids = {p["uid"] for p in tr["per_op"]}
        assert all(d["uid"] in uids for d in tr["matmuls"])
        assert sorted(p["label"] for p in tr["per_op"]) == \
            sorted(p["label"] for p in jr["per_op"])
        assert strip({"matmuls": tr["matmuls"]}) == \
            strip({"matmuls": jr["matmuls"]})

    def test_no_analyze_event_when_obs_off(self, tmp_path):
        ts = MatrelSession(config=MatrelConfig(
            obs_event_log=str(tmp_path / "e.jsonl")), device="cpu")
        ts.explain(chain(ts, arrs()), analyze=True)
        assert not (tmp_path / "e.jsonl").exists()

    def test_backend_reads_the_tensor_device(self):
        ts = MatrelSession(device="cpu")
        plan = ts.compile(chain(ts, arrs()))
        assert t_analyze.backend_of(plan) == "cpu"


# -- the OFF contract ---------------------------------------------------------


def _poison(monkeypatch, cls):
    def boom(self, *a, **k):
        raise AssertionError(f"{cls.__name__} constructed on the off path")
    monkeypatch.setattr(cls, "__init__", boom)


class TestObsOffContract:
    def test_no_events_spans_syncs_or_objects(self, monkeypatch, tmp_path):
        for cls in (EventLog, t_trace.FlightRecorder, t_trace.Tracer,
                    slo.SLOPlane, t_export.MetricsExporter,
                    t_prov.ProvenanceLedger):
            _poison(monkeypatch, cls)
        syncs = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda *a, **k: syncs.append(1))
        monkeypatch.setattr(t_exec, "_device_sync",
                            lambda mesh: syncs.append(1))
        before = set(threading.enumerate())
        ts = MatrelSession(config=MatrelConfig(
            obs_event_log=str(tmp_path / "e.jsonl")), device="cpu")
        a = arrs()
        e = chain(ts, a)
        ts.run(e)
        ts.run_many([e])
        # warm runs (plan-cache hits) build no span at all; a compile's
        # phase() timings are the only spans, as in the JAX package
        _poison(monkeypatch, t_trace.Span)
        out = ts.run(e)
        ts.run_many([e])
        assert out.shape == (24, 16)
        assert syncs == []
        assert not (tmp_path / "e.jsonl").exists()
        assert set(threading.enumerate()) == before
        assert ts._exporter is None and ts._tracer is None
        assert ts._flight is None and ts._slo is None and ts._prov is None

    def test_default_config_is_off(self):
        cfg = MatrelConfig()
        assert cfg.obs_level == "off" and cfg.obs_metrics_port == 0
        assert cfg.obs_flight_recorder == 0 and cfg.obs_provenance == 0

    def test_obs_level_validated_and_normalised(self):
        assert MatrelConfig(obs_level="OFF").obs_level == "off"
        assert MatrelConfig(obs_level="Analyze").obs_level == "analyze"
        with pytest.raises(ValueError, match="obs_level"):
            MatrelConfig(obs_level="of")

    @pytest.mark.parametrize("kw", [
        {"obs_metrics_port": -1}, {"obs_metrics_port": 70000},
        {"slo_targets": "a:p42_ms=3"}, {"slo_fast_window_s": 0.0},
        {"slo_burn_exit": 20.0}, {"obs_flight_recorder": -1},
        {"obs_provenance": -1}, {"obs_event_log_max_bytes": -1}])
    def test_knob_validation_matches_the_jax_packages(self, kw):
        with pytest.raises(ValueError):
            JConfig(**kw)
        with pytest.raises(ValueError):
            MatrelConfig(**kw)

    def test_span_is_the_shared_noop_without_tracer(self):
        assert t_trace.span("x") is t_trace._NOOP
        with t_trace.activate(None):
            assert t_trace.span("y") is t_trace._NOOP


class TestInstrumentationGuard:
    def test_every_lowering_dispatch_is_annotated(self):
        """Structural: the Lowerer's per-node dispatch reaches
        ``_eval_node`` either on the fast path (no profiler, no analyze
        hook — guarded by ``_profiling()``) or through
        ``_eval_observed``, whose call sits inside ``with annotate(``
        and is bracketed by the analyze hook."""
        src = inspect.getsource(t_exec.Lowerer.lower_multi)
        assert "faults_lib.check(\"lower\", cfg)" in src
        assert "if hook is None and not _profiling():" in src
        obs = inspect.getsource(t_exec.Lowerer._eval_observed)
        lines = obs.splitlines()
        [i] = [n for n, ln in enumerate(lines) if "self._eval_node(" in ln]
        assert "with annotate(f\"matrel.{label}\"):" in lines[i - 1]
        lines = inspect.getsource(t_exec).splitlines()
        sites = [n for n, ln in enumerate(lines)
                 if "self._eval_node(" in ln and "def " not in ln]
        assert len(sites) == 2

    def test_profiler_nests_ops_under_matrel_ranges(self):
        ts = MatrelSession(device="cpu")
        plan = ts.compile(chain(ts, arrs()))
        plan.run()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            plan.run()
        names = {e.key for e in prof.key_averages()}
        assert "matrel.matmul:xla" in names
        assert "matrel.leaf" in names

    def test_annotate_is_free_without_profiler(self):
        assert profiling.annotate("x") is profiling._NULL

    def test_trace_writes_chrome_json(self, tmp_path):
        ts = MatrelSession(device="cpu")
        plan = ts.compile(chain(ts, arrs()))
        with profiling.trace(str(tmp_path / "prof")):
            plan.run()
        with open(tmp_path / "prof" / "trace.json") as f:
            doc = json.load(f)
        assert any(str(ev.get("name", "")).startswith("matrel.")
                   for ev in doc["traceEvents"])

    def test_step_timer(self):
        t = profiling.StepTimer()
        with t.step("a", sync=torch.ones(2)):
            pass
        t.count("n", 3)
        assert t.counters == {"n": 3.0}
        assert "a" in t.table() and "n" in t.table()


# -- spans, flight recorder ---------------------------------------------------


class TestTracingSpans:
    def test_query_span_tree_equal(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on")
        a = arrs()
        js.run(chain(js, a))
        ts.run(chain(ts, a))
        tt = span_tree(ts.config.obs_event_log)
        assert tt == span_tree(js.config.obs_event_log)
        assert ("query.execute", "query") in tt
        assert ("plan", "query") in tt and ("plan.optimize", "plan") in tt
        assert ("plan.verify", "plan") in tt

    @pytest.mark.parametrize("mode", ["warn", "error"])
    def test_verify_records_equal(self, jmesh, tmp_path, mode):
        """With verify_plans on, each observed run emits one ``verify``
        record carrying the compile-time diagnostics: equal between the
        packages for a clean plan (a plan-cache hit re-reports it), and
        for a summa override on the (2, 4) grid (MV101: recorded at
        "warn", raised before lowering at "error", in both)."""
        js, ts = twins(jmesh, tmp_path, obs_level="on", verify_plans=mode)
        a = arrs()
        for s in (js, ts):
            s.run(chain(s, a))
            s.run(chain(s, a))
        from matrel_tpu_torch.core.mesh import make_mesh
        over = dict(obs_level="on", verify_plans=mode,
                    strategy_override="summa")
        jo = JSession(mesh=jmesh_lib.make_mesh((2, 4)), config=JConfig(
            obs_event_log=str(tmp_path / "jo.jsonl"), **over))
        to = MatrelSession(mesh=make_mesh((2, 4), device="cpu"),
                           config=MatrelConfig(
                               obs_event_log=str(tmp_path / "to.jsonl"),
                               **over))
        for s in (jo, to):
            A, B = s.from_numpy(a[0]), s.from_numpy(a[1])
            try:
                s.run(A.expr() @ B.expr())
            except Exception as ex:
                assert mode == "error"
                assert type(ex).__name__ == "VerificationError"
                assert "MV101" in str(ex)
        recs = [[{k: r[k] for k in ("mode", "count", "errors", "codes")}
                 for r in (kinds(x.config.obs_event_log, "verify")
                           + kinds(y.config.obs_event_log, "verify"))]
                for x, y in ((js, jo), (ts, to))]
        assert recs[0] == recs[1]
        clean = {"mode": mode, "count": 0, "errors": 0, "codes": []}
        flagged = {"mode": mode, "count": 1, "errors": 1,
                   "codes": ["MV101"]}
        assert recs[1] == ([clean, clean, flagged] if mode == "warn"
                           else [clean, clean])
        tt = span_tree(ts.config.obs_event_log)
        assert tt == span_tree(js.config.obs_event_log)
        assert ("plan.verify", "plan") in tt

    def test_serve_batch_span_tree_equal(self, jmesh, tmp_path):
        js, ts = twins(jmesh, tmp_path, obs_level="on",
                       result_cache_max_bytes=1 << 22)
        a = arrs()
        for s in (js, ts):
            X = s.from_numpy(a[0])
            s.run_many([chain(s, a), X.expr().t(), X.expr()])
        tt = span_tree(ts.config.obs_event_log)
        assert tt == span_tree(js.config.obs_event_log)
        assert ("serve.execute", "serve.batch") in tt

    def test_spans_schema_and_links(self, tmp_path):
        ts = MatrelSession(config=MatrelConfig(
            obs_level="on", obs_event_log=str(tmp_path / "e.jsonl")),
            device="cpu")
        ts.run(chain(ts, arrs()))
        spans = kinds(str(tmp_path / "e.jsonl"), "span")
        by_id = {s["span_id"]: s for s in spans}
        for s in spans:
            assert s["schema"] == SCHEMA_VERSION
            assert isinstance(s["dur_ms"], (int, float))
            seen = set()
            while s["parent_id"] is not None:
                assert s["span_id"] not in seen
                seen.add(s["span_id"])
                s = by_id[s["parent_id"]]
            assert s["name"] == "query"

    def test_chrome_export_equal_the_jax_packages(self, tmp_path):
        log = EventLog(str(tmp_path / "sp.jsonl"))
        for root in (1, 4):
            log.emit("span", {"name": "query", "span_id": root,
                              "parent_id": None, "t0": 100.0 + root,
                              "dur_ms": 5.0, "pid": 1, "tid": 1})
            log.emit("span", {"name": "plan", "span_id": root + 1,
                              "parent_id": root, "t0": 100.0 + root,
                              "dur_ms": 2.0, "pid": 1, "tid": 1})
        ev = read_events(log.path)
        for last in (None, 1, 2):
            assert t_trace.chrome_trace(ev, last=last) == \
                jchrome_trace(ev, last=last)
        got = {e["args"]["span_id"] for e in
               t_trace.chrome_trace(ev, last=1)["traceEvents"]}
        assert got == {4, 5}


class TestFlightRecorder:
    def test_records_spans_with_obs_off(self, tmp_path):
        ts = MatrelSession(config=MatrelConfig(
            obs_flight_recorder=64,
            obs_event_log=str(tmp_path / "e.jsonl")), device="cpu")
        ts.run(chain(ts, arrs()))
        assert not (tmp_path / "e.jsonl").exists()
        names = {r["name"] for r in ts._flight.snapshot()
                 if r.get("kind") == "span"}
        assert {"query", "plan.optimize", "query.execute"} <= names

    def test_ring_is_bounded(self):
        ts = MatrelSession(config=MatrelConfig(obs_flight_recorder=4),
                           device="cpu")
        for _ in range(5):
            ts.run(chain(ts, arrs()))
        assert len(ts._flight) == 4

    def test_explicit_dump_round_trip(self, tmp_path):
        p = str(tmp_path / "flight.json")
        ts = MatrelSession(config=MatrelConfig(
            obs_flight_recorder=64, obs_flight_recorder_path=p),
            device="cpu")
        ts.run(chain(ts, arrs()))
        assert ts.dump_flight_recorder() == p
        with open(p) as f:
            doc = json.load(f)
        assert doc["kind"] == "flight_recorder" and doc["records"]
        assert doc["schema"] == SCHEMA_VERSION

    def test_dump_disabled_returns_none(self):
        assert MatrelSession(device="cpu").dump_flight_recorder() is None

    def test_dump_on_compile_failure(self, tmp_path, monkeypatch):
        p = str(tmp_path / "flight.json")
        ts = MatrelSession(config=MatrelConfig(
            obs_flight_recorder=64, obs_flight_recorder_path=p),
            device="cpu")

        def broken(*a, **k):
            raise RuntimeError("planner exploded")
        monkeypatch.setattr(t_exec, "compile_expr", broken)
        with pytest.raises(RuntimeError, match="exploded"):
            ts.run(chain(ts, arrs()))
        with open(p) as f:
            doc = json.load(f)
        assert doc["reason"] == "compile_failure"
        assert "exploded" in doc["error"]

    def test_dump_on_serve_batch_failure(self, tmp_path, monkeypatch):
        p = str(tmp_path / "flight.json")
        ts = MatrelSession(config=MatrelConfig(
            obs_flight_recorder=64, obs_flight_recorder_path=p),
            device="cpu")

        def broken(*a, **k):
            raise RuntimeError("batch exploded")
        monkeypatch.setattr(ts, "run_many", broken)
        try:
            fut = ts.submit(chain(ts, arrs()))
            with pytest.raises(RuntimeError, match="batch exploded"):
                fut.result(timeout=WAIT_S)
        finally:
            ts.serve_close(timeout=WAIT_S)
        with open(p) as f:
            assert json.load(f)["reason"] == "serve_batch_failure"


class TestObsOffServePath:
    def test_repeated_serve_path_creates_no_spans(self, monkeypatch):
        ts = MatrelSession(config=MatrelConfig(
            result_cache_max_bytes=1 << 22), device="cpu")
        try:
            a = arrs()
            e = chain(ts, a)
            ts.submit(e).result(timeout=WAIT_S)        # compiles once
            _poison(monkeypatch, t_trace.Span)
            for _ in range(3):
                ts.submit(e).result(timeout=WAIT_S)
                ts.run_many([e])
        finally:
            ts.serve_close(timeout=WAIT_S)


# -- drift ----------------------------------------------------------------------


def _analyze_event(log, strategy, est_bytes, ms, dims=(1024, 1024, 1024),
                   uid=7, backend="cpu"):
    log.emit("analyze", {
        "backend": backend, "fused_ms": ms,
        "per_op": [{"uid": uid, "label": f"matmul:{strategy}", "ms": ms}],
        "matmuls": [{"uid": uid, "strategy": strategy, "dims": list(dims),
                     "flops": 2.0 * dims[0] * dims[1] * dims[2],
                     "est_ici_bytes": est_bytes}]})


def _seed_miscalibrated(path, backend="cpu"):
    log = EventLog(path)
    for _ in range(3):
        _analyze_event(log, "cpmm", 1.0 * 2 ** 20, 30.0, backend=backend)
        _analyze_event(log, "rmm", 4.0 * 2 ** 20, 10.0, backend=backend)
    return log.path


class TestDriftAuditor:
    @pytest.mark.parametrize("backend", ["cpu", "cuda"])
    def test_calibration_and_flags_equal(self, tmp_path, backend):
        events = read_events(_seed_miscalibrated(
            str(tmp_path / "d.jsonl"), backend))
        ts_ = list(drift.iter_samples(events))
        js_ = list(jdrift.iter_samples(events))
        assert ts_ == js_ and len(ts_) == 6
        calib = drift.calibrate(ts_)
        assert calib == jdrift.calibrate(js_)
        assert f"cpmm|<=1024|{backend}" in calib
        flags = drift.rank_flags(ts_)
        assert flags == jdrift.rank_flags(js_)
        assert flags[0]["model_prefers"] == "cpmm"

    def test_agreeing_log_raises_no_flag(self, tmp_path):
        log = EventLog(str(tmp_path / "ok.jsonl"))
        _analyze_event(log, "cpmm", 1.0 * 2 ** 20, 10.0)
        _analyze_event(log, "rmm", 4.0 * 2 ** 20, 30.0)
        assert drift.rank_flags(list(drift.iter_samples(
            read_events(log.path)))) == []

    def test_query_samples_filtered(self, tmp_path):
        log = EventLog(str(tmp_path / "q.jsonl"))
        base = {"source": "dsl", "out_shape": [4, 4], "backend": "cpu",
                "plan_cache": {},
                "matmuls": [{"uid": 1, "strategy": "rmm",
                             "dims": [64, 64, 64], "flops": 5e5,
                             "est_ici_bytes": 1024.0}]}
        log.emit("query", dict(base, cache="miss", execute_ms=5.0))
        log.emit("query", dict(base, cache="rc_hit", execute_ms=0.0))
        log.emit("query", dict(base, cache="hit", execute_ms=5.0,
                               batch={"size": 4, "index": 0}))
        # a CUDA query's execute_ms times the launch: not a sample
        log.emit("query", dict(base, cache="miss", execute_ms=5.0,
                               backend="cuda", execute_clock="host"))
        samples = list(drift.iter_samples(read_events(log.path)))
        assert len(samples) == 1 and samples[0]["source"] == "query"

    def test_table_persist_merge_and_cross_read(self, tmp_path):
        events = read_events(_seed_miscalibrated(str(tmp_path / "d.jsonl")))
        calib = drift.calibrate(list(drift.iter_samples(events)))
        path = str(tmp_path / "table.json")
        t1 = drift.update_table(path, calib)
        assert t1["entries"]["cpmm|<=1024|cpu"]["count"] == 3
        # the JAX package merges into the port's table, and back
        t2 = jdrift.update_table(path, jdrift.calibrate(
            list(jdrift.iter_samples(events))))
        assert t2["entries"]["cpmm|<=1024|cpu"]["count"] == 6
        t3 = drift.load_table(path)
        assert t3["entries"] == t2["entries"]
        with open(path, "w") as f:
            f.write("{nope")
        assert drift.load_table(path)["entries"] == {}

    def test_port_session_feeds_auditor_under_its_backend(self, tmp_path):
        ts = MatrelSession(config=MatrelConfig(
            obs_level="on", obs_event_log=str(tmp_path / "e.jsonl")),
            device="cpu")
        ts.explain(chain(ts, arrs()), analyze=True)
        events = read_events(str(tmp_path / "e.jsonl"))
        calib = drift.calibrate(list(drift.iter_samples(events)))
        assert calib and all(r["backend"] == "cpu" for r in calib.values())
        assert calib == jdrift.calibrate(list(jdrift.iter_samples(events)))

    def test_shape_class_equal(self):
        for dims in ((1, 1, 1), (900, 1000, 1024), (1025, 3, 7), ()):
            assert drift.shape_class(dims) == jdrift.shape_class(dims)


# -- SLO plane ----------------------------------------------------------------


class _Clock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def _feed(plane, clock, script):
    out = []
    for op, tenant, arg in script:
        clock.t += 0.5
        if op == "ok":
            plane.record_ok(tenant, arg)
        elif op == "shed":
            plane.record_shed(tenant)
        elif op == "miss":
            plane.record_miss(tenant)
        elif op == "lat":
            plane.observe_latency(tenant, arg)
        elif op == "idle":
            clock.t += arg
            plane.tick()
    return out


class TestSLOPlane:
    SPEC = "gold:p95_ms=50,avail=0.99;ivm:p95_ms=20"

    def _planes(self):
        kw = dict(slo_targets=self.SPEC, slo_fast_window_s=10.0,
                  slo_slow_window_s=60.0, slo_burn_threshold=2.0,
                  slo_burn_exit=1.0)
        got, jgot = [], []
        tc, jc = _Clock(), _Clock()
        p = slo.from_config(MatrelConfig(**kw), emit=got.append, clock=tc)
        jp = jslo.from_config(JConfig(**kw), emit=jgot.append, clock=jc)
        return (p, tc, got), (jp, jc, jgot)

    def test_off_is_none(self):
        assert slo.from_config(MatrelConfig()) is None

    @pytest.mark.parametrize("script", [
        [("ok", "gold", 10.0)] * 5 + [("ok", "gold", 400.0)] * 20
        + [("idle", None, 30.0)] + [("ok", "gold", 5.0)] * 5,
        [("shed", "gold", None)] * 10 + [("ok", "gold", 1.0)] * 30
        + [("idle", None, 100.0)],
        [("lat", "ivm", 50.0)] * 8 + [("lat", "ivm", 1.0)] * 40,
        [("miss", "gold", None), ("ok", "nobody", 3.0)] * 6])
    def test_transitions_and_snapshots_equal(self, script):
        (p, tc, got), (jp, jc, jgot) = self._planes()
        _feed(p, tc, script)
        _feed(jp, jc, script)
        assert got == jgot
        assert p.snapshot() == jp.snapshot()
        assert p.firing() == jp.firing()

    def test_parse_slo_targets_equal(self):
        from matrel_tpu.config import parse_slo_targets as jparse
        from matrel_tpu_torch.config import parse_slo_targets
        for spec in (self.SPEC, "a:avail=0.5", ""):
            assert parse_slo_targets(spec) == jparse(spec)
        for bad in ("a", "a:p1_ms=3", "a:avail=1.5", "a:p95_ms=-1",
                    "a:avail=0.9;a:avail=0.8"):
            with pytest.raises(ValueError):
                parse_slo_targets(bad)

    def test_session_alert_events_equal(self, jmesh, tmp_path):
        cfg = dict(obs_level="on", slo_targets="t:avail=0.9",
                   slo_fast_window_s=30.0, slo_slow_window_s=60.0,
                   slo_burn_threshold=2.0, slo_burn_exit=1.0)
        js, ts = twins(jmesh, tmp_path, **cfg)
        for s in (js, ts):
            for _ in range(4):
                s._slo.record_shed("t")
        ta = [strip(r) for r in kinds(ts.config.obs_event_log, "alert")]
        ja = [strip(r) for r in kinds(js.config.obs_event_log, "alert")]
        assert ta == ja and ta[0]["state"] == "firing"
        assert metrics.REGISTRY.counter("slo.alerts.fired").value == 1


# -- export -------------------------------------------------------------------


def _free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def _get(url):
    with urllib.request.urlopen(url, timeout=WAIT_S) as r:
        return r.status, r.read().decode()


class TestExport:
    def test_port_zero_builds_nothing(self, monkeypatch):
        _poison(monkeypatch, t_export.MetricsExporter)
        before = {t.name for t in threading.enumerate()}
        ts = MatrelSession(device="cpu")
        assert ts._exporter is None
        assert "matrel-metrics" not in {t.name for t in
                                        threading.enumerate()} - before

    def test_scrape_metrics_and_json(self, tmp_path):
        ts = MatrelSession(config=MatrelConfig(
            obs_level="on", obs_event_log=str(tmp_path / "e.jsonl"),
            obs_metrics_port=_free_port(), brownout_enable=True,
            breaker_threshold=2, slo_targets="a:p95_ms=100",
            result_cache_max_bytes=1 << 22), device="cpu")
        try:
            ts.run(chain(ts, arrs()))
            st, text = _get(ts._exporter.url + "/metrics")
            assert st == 200
            assert "matrel_query_count 1.0" in text
            assert "# TYPE matrel_query_count counter" in text
            assert "matrel_brownout_rung" in text
            st, body = _get(ts._exporter.url + "/json")
            doc = json.loads(body)
            assert doc["metrics"]["counters"]["query.count"] == 1.0
            assert doc["plan_cache"]["plans"] == 1
            assert doc["brownout"]["rung"] == 0
            assert doc["slo"]["tenants"]["a"]["counts"]["ok"] == 0
        finally:
            ts.serve_close(timeout=WAIT_S)
        assert not any(t.name == "matrel-metrics" and t.is_alive()
                       for t in threading.enumerate())

    def test_prometheus_text_equal_the_jax_packages(self):
        from matrel_tpu.obs.export import render_prometheus as jrender
        snap = {"metrics": {"counters": {"query.count": 3.0},
                            "gauges": {"plan_cache.plans": 2.0},
                            "histograms": {"query.execute_ms": {
                                "p50": 1.0, "p95": 2.0, "p99": 3.0,
                                "total": 6.0, "count": 3}}},
                "brownout": {"rung": 1, "queue_depth": 4,
                             "wait_p95_ms": 5.0},
                "breakers": {"open": ["matmul:<=8"], "half_open": []},
                "result_cache": {"entries": 1, "bytes": 64},
                "serve": {"queue_depth": 0, "tenant_depths": {"": 0},
                          "inflight": 0}}
        assert t_export.render_prometheus(snap) == jrender(snap)

    def test_unbindable_port_raises_at_construction(self):
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            sk.listen(1)
            port = sk.getsockname()[1]
            with pytest.raises(OSError):
                MatrelSession(config=MatrelConfig(obs_metrics_port=port),
                              device="cpu")

    def test_unknown_path_404(self):
        ts = MatrelSession(config=MatrelConfig(
            obs_metrics_port=_free_port()), device="cpu")
        try:
            with pytest.raises(urllib.error.HTTPError):
                _get(ts._exporter.url + "/nope")
        finally:
            ts.serve_close(timeout=WAIT_S)
