"""PyTorch port: the open-loop traffic harness
(``matrel_tpu_torch/tools/traffic.py``) held against the JAX package's
``tools/traffic.py`` on the CPU.

- ``arrival_schedule`` is bit-equal to the JAX function (seeds 0-4, both
  processes, and the generator left in the same state).
- ``_pctile``, ``oracle_ok`` and ``prometheus_parse_ok`` agree on the same
  inputs; the parser also accepts the port's own exporter text.
- ``build_pool``'s names and numpy oracles are bit-equal to the JAX pool's
  for a seed, and every entry's answer from the port matches the JAX
  package's within ``TOL``.
- A short ``drive_phase`` on the CPU: every completed answer right, every
  failure typed, arrivals = completed + shed + missed + failed.
- Each mode's ``main`` runs on the CPU at short phases with zero wrong
  answers and zero untyped errors. The timing-dependent acceptance
  (brownout entering and exiting, goodput, the alert firing and
  clearing) is the card's to check (``chip_smoke.py``'s ``path_tools``).
"""

import importlib.util
import json
import os
import time

import numpy as np
import pytest

from matrel_tpu_torch import MatrelConfig, MatrelSession
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.tools import traffic as t_traffic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POOL = ("matmul_s2", "matmul_s3", "triangles", "spgemm_band", "dash_0",
        "dash_1", "dash_2", "dash_3", "dash_4", "dash_5")


@pytest.fixture(scope="module")
def jt():
    spec = importlib.util.spec_from_file_location(
        "jax_traffic_tool", os.path.join(REPO, "tools", "traffic.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_declarations_equal(jt):
    assert t_traffic.TENANTS == jt.TENANTS
    assert t_traffic.TOL == jt.TOL
    assert t_traffic.TICK_S == jt.TICK_S


@pytest.mark.parametrize("process", ["poisson", "bursty"])
@pytest.mark.parametrize("seed", range(5))
def test_arrival_schedule_bit_equal(jt, seed, process):
    for rate, seconds in ((150.0, 2.0), (3000.0, 1.0), (5.0, 3.0)):
        ra, rb = np.random.default_rng(seed), np.random.default_rng(seed)
        a = jt.arrival_schedule(ra, rate, seconds, process)
        b = t_traffic.arrival_schedule(rb, rate, seconds, process)
        assert a == b
        assert ra.random() == rb.random()      # the same draws consumed


@pytest.mark.parametrize("vals,q", [
    ([], 0.5), ([3.0], 0.99), ([1.0, 2.0], 0.5),
    (sorted(np.random.default_rng(1).random(101).tolist()), 0.95),
    (sorted(np.random.default_rng(2).random(1000).tolist()), 0.99),
    (list(range(10)), 1.0)])
def test_pctile_agrees(jt, vals, q):
    assert t_traffic._pctile(vals, q) == jt._pctile(vals, q)


def _oracle_cases():
    rng = np.random.default_rng(3)
    o = rng.standard_normal((8, 6))
    scale = max(np.abs(o).max(), 1.0)
    return [(o, o), (o[:, :5], o), (o + 0.019 * scale, o),
            (o + 0.021 * scale, o), (np.full((2, 2), 0.019), np.zeros((2, 2))),
            (np.full((2, 2), 0.021), np.zeros((2, 2))),
            (np.array([[7.0]]), np.array([[7.0]]))]


@pytest.mark.parametrize("case", range(len(_oracle_cases())))
def test_oracle_ok_agrees(jt, case):
    got, oracle = _oracle_cases()[case]
    assert t_traffic.oracle_ok(got, oracle) == jt.oracle_ok(got, oracle)


PROM_TEXTS = [
    "# TYPE matrel_q counter\nmatrel_q 3\n",
    'matrel_lat{tenant="gold"} 1.5e-3\n',
    "matrel_x NaN\nmatrel_y +Inf\nmatrel_z -inf\n",
    "# HELP matrel_q queries\nmatrel_q 3\n\n",
    "# a free comment\nmatrel_q 3\n",
    "matrel_q\n",
    "matrel_q 3 1700000000\n",
    "",
    "# TYPE matrel_q counter\n",
    "9bad 1\n",
]


@pytest.mark.parametrize("text", PROM_TEXTS)
def test_prometheus_parse_agrees(jt, text):
    assert (t_traffic.prometheus_parse_ok(text)
            == jt.prometheus_parse_ok(text))


def test_prometheus_parses_the_port_exporter():
    from matrel_tpu_torch.obs import export
    sess = MatrelSession(mesh=make_mesh((2, 4), device="cpu"),
                         config=MatrelConfig(
                             obs_level="on",
                             slo_targets="gold:avail=0.9;bronze:avail=0.9",
                             serve_tenant_weights="gold:4,bronze:1"))
    try:
        a = sess.from_numpy(np.eye(8, dtype=np.float32))
        sess.submit(a.expr().multiply(a.expr()), tenant="gold").result(60)
        text = export.render_prometheus(export.snapshot(sess))
    finally:
        sess.serve_close(timeout=60)
    assert "matrel_" in text
    assert t_traffic.prometheus_parse_ok(text)


@pytest.fixture(scope="module")
def pools(jt, mesh8):
    from matrel_tpu.session import MatrelSession as JSession
    jsess = JSession(mesh=mesh8)
    tsess = MatrelSession(mesh=make_mesh((2, 4), device="cpu"))
    jp = jt.build_pool(jsess, np.random.default_rng(7))
    tp = t_traffic.build_pool(tsess, np.random.default_rng(7))
    yield jsess, jp, tsess, tp
    tsess.serve_close(timeout=60)


def test_pool_names_and_oracles_bit_equal(pools):
    _, jp, _, tp = pools
    assert [n for n, _e, _o in tp] == [n for n, _e, _o in jp] == list(POOL)
    for (_n, _e, o_t), (_m, _f, o_j) in zip(tp, jp):
        o_t, o_j = np.asarray(o_t), np.asarray(o_j)
        assert o_t.dtype == o_j.dtype and np.array_equal(o_t, o_j)


@pytest.mark.parametrize("name", POOL)
def test_pool_answer_matches_jax(pools, name):
    jsess, jp, tsess, tp = pools
    i = POOL.index(name)
    got_t = tsess.run(tp[i][1]).to_numpy()
    got_j = np.asarray(jsess.run(jp[i][1]).to_numpy())
    assert got_t.shape == got_j.shape
    assert t_traffic.oracle_ok(got_t, got_j)
    assert t_traffic.oracle_ok(got_t, tp[i][2])


def test_drive_phase_accounts_for_every_arrival():
    weights = ",".join(f"{t['name']}:{t['weight']:g}"
                       for t in t_traffic.TENANTS)
    sess = MatrelSession(mesh=make_mesh((2, 4), device="cpu"),
                         config=MatrelConfig(
                             serve_tenant_weights=weights,
                             serve_tenant_queue_max=4, serve_queue_max=8,
                             serve_max_batch=1, cse_enable=True,
                             brownout_enable=True, brownout_window=8,
                             brownout_dwell=2, brownout_depth_high=6,
                             brownout_depth_low=1,
                             precision_enable_bf16=False))
    try:
        rng = np.random.default_rng(0)
        pool = t_traffic.build_pool(sess, rng)
        sched = t_traffic.arrival_schedule(rng, 1500.0, 0.5, "bursty")
        outcomes, rungs = [], []
        wall = t_traffic.drive_phase(sess, pool, sched, t_traffic.TENANTS,
                                     rng, 500.0, outcomes, rungs)
        sess.serve_drain(timeout=60)
        deadline = time.monotonic() + 30
        while len(outcomes) < len(sched) and time.monotonic() < deadline:
            time.sleep(0.05)          # the last done-callbacks
    finally:
        sess.serve_close(timeout=60)
    assert wall > 0 and rungs
    assert len(outcomes) == len(sched) > 0
    counts = {}
    for rec in outcomes:
        counts[rec["status"]] = counts.get(rec["status"], 0) + 1
        if rec["status"] == "ok":
            assert t_traffic.oracle_ok(rec["result"].to_numpy(),
                                       rec["oracle"]), rec["workload"]
    assert set(counts) <= {"ok", "shed", "deadline", "circuit", "typed"}
    assert counts.get("ok", 0) > 0 and counts.get("shed", 0) > 0
    assert sum(counts.values()) == len(sched)


#: the JAX tool's record keys, mode by mode
RECORD_KEYS = {
    "traffic_overload_harness": {
        "seed", "process", "backend", "warmup_s",
        "capacity_qps_closed_loop", "capacity_qps_pre", "capacity_qps_post",
        "offered_rate_x", "offered_qps", "overload_seconds", "arrivals",
        "submitted", "tenants", "goodput_qps", "goodput_ratio",
        "fairness_jain", "wrong_answers", "untyped_errors", "deadline_ms",
        "p99_within_deadline", "brownout", "breakers", "queue", "mqo"},
    "traffic_slo_harness": {
        "seed", "process", "backend", "slo_targets", "windows_s",
        "burn_threshold", "burn_exit", "capacity_qps_closed_loop",
        "offered_qps", "arrivals", "alert_events", "alerts_fired",
        "alerts_cleared", "fired_objectives",
        "violated_tenant_fired_in_window", "uncleared",
        "alerts_active_final", "tenants", "prometheus", "brownout",
        "wrong_answers", "untyped_errors"},
    "traffic_fleet_harness": {
        "seed", "process", "backend", "slices", "capacity_qps_closed_loop",
        "offered_qps", "overload_seconds", "submitted", "completed",
        "wrong_answers", "untyped_errors", "sheds", "deadline_misses",
        "other_typed", "goodput_qps", "placed", "pinned", "directory",
        "failovers", "requeued_on_kill", "slices_served_before_kill",
        "slice_state"},
}


@pytest.mark.parametrize("mode,metric", [
    ("", "traffic_overload_harness"), ("--slo", "traffic_slo_harness"),
    ("--slices", "traffic_fleet_harness")])
def test_main_modes_on_the_cpu(mode, metric, tmp_path, monkeypatch,
                               capsys):
    for k, v in (("MATREL_TRAFFIC_SECONDS", "1.5"),
                 ("MATREL_TRAFFIC_TAIL_SECONDS", "1"),
                 ("MATREL_TRAFFIC_CAL", "30"),
                 ("MATREL_TRAFFIC_SLO_FAST_S", "0.5"),
                 ("MATREL_OBS_EVENT_LOG", str(tmp_path / "events.jsonl"))):
        monkeypatch.setenv(k, v)
    argv = ([mode] if mode else []) + ["--device", "cpu"]
    rc = t_traffic.cli(argv)
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["metric"] == metric
    assert RECORD_KEYS[metric] <= set(rec)
    assert rec["backend"] == "cpu" and "card" not in rec
    assert rec["wrong_answers"] == 0 and rec["untyped_errors"] == 0
    assert rc == (0 if rec["ok"] else 1)
    if metric == "traffic_fleet_harness":
        assert rec["failovers"] == 1


def test_default_device_needs_a_card(monkeypatch):
    import torch
    from matrel_tpu_torch.core.mesh import DeviceUnavailableError
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([], ["--slo"], ["--slices"]):
        with pytest.raises(DeviceUnavailableError):
            t_traffic.cli(argv)
