"""PyTorch port: the drift-fitted planner coefficients
(``matrel_tpu_torch/parallel/coeffs.py``) and their consults in the
planner, the chain DP and the session's plan key, held against the JAX
package's ``parallel/coeffs.py`` on the CPU, mirroring
``tests/test_coeffs.py``; and the re-plan controller
(``serve/replan.py``): ``TestReplanController``'s cases fed the same
query records in both packages give the same round records, epochs and
counters, and a session with ``coeff_replan_enable`` re-plans its warm
queries with unchanged answers.

The same drift table (written once, read by both packages) gives the
same strategy rows, class blends, chain comm weights and epoch token;
the same queries planned on the (2, 4) virtual grid give the same
strategy / ``cost_model`` stamps and decision records (``uid``
excepted), and the same chain-DP parenthesisation. The coefficient
rows are keyed by backend: the port reads its own device type ("cpu"
here, "cuda" on the card), so a row calibrated on another backend never
prices a port plan. Results are unchanged by the consult (rtol/atol
3e-4 against float64 numpy, 1e-5 between the packages).
"""

import json
import os
import re

import jax
import numpy as np
import pytest

from matrel_tpu import executor as jexec
from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.blockmatrix import BlockMatrix as JBlockMatrix
from matrel_tpu.obs import drift as jdrift
from matrel_tpu.parallel import coeffs as jcoeffs
from matrel_tpu.parallel import planner as jplanner
from matrel_tpu.serve import replan as jreplan
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch import executor as texec
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.obs import drift
from matrel_tpu_torch.parallel import coeffs, planner
from matrel_tpu_torch.serve import replan as treplan
from matrel_tpu_torch.session import MatrelSession

CLS = "<=128"
CANDS = ("bmm_right", "bmm_left", "cpmm", "rmm", "xla")
TOL = 3e-4


def _row(strategy, gf, mib, count=10, cls=CLS, backend="cpu"):
    return {"strategy": strategy, "class": cls, "backend": backend,
            "count": count, "ms_median": 1.0,
            "ms_per_gflop": gf, "ms_per_est_mib": mib}


def _write(path, rows):
    entries = {f"{r['strategy']}|{r['class']}|{r['backend']}": r
               for r in rows}
    with open(path, "w") as f:
        json.dump({"schema": 1, "entries": entries}, f)
    coeffs.reset_coefficient_cache()
    jcoeffs.reset_coefficient_cache()


@pytest.fixture()
def table(tmp_path):
    return str(tmp_path / "drift.json")


@pytest.fixture(scope="module")
def jmesh8():
    return jmesh_lib.make_mesh((2, 4))


def _seam(mod, table):
    return (mod.strategy_coefficients(table),
            mod.class_coefficients(table), mod.epoch(table),
            mod.chain_comm_weights(table, "cpu"))


class TestSeam:
    def test_cold_table(self, table):
        assert coeffs.strategy_coefficients(table) == {}
        assert coeffs.class_coefficients(table) == {}
        assert coeffs.epoch(table) == coeffs.COLD_EPOCH == "cold"
        assert coeffs.strategy_row("rmm", CLS, "cpu", table) is None

    @pytest.mark.parametrize("rows", [
        [_row("rmm", 1.5, 0.3), _row("rmm@bf16x3", 0.5, 0.3)],
        [_row("rmm", float("nan"), 0.3),
         _row("cpmm", float("inf"), float("nan"))],
        [_row("rmm", 1.0, 0.2, count=1), _row("cpmm", 3.0, 0.6, count=3)],
        [_row("rmm", 1.0, 0.4, count=5),
         _row("rmm@bf16x3", 9.0, 9.0, count=50, cls="<=256"),
         _row("cpmm", 1.0, 0.4, count=5, cls="<=512", backend="tpu"),
         _row("cpmm", 2.0, 0.1, count=7, cls="<=512", backend="cuda")],
        [_row("rmm", 1.0, 0.3, count=0)]])
    def test_seam_equal_the_jax_packages(self, table, rows):
        _write(table, rows)
        assert _seam(coeffs, table) == _seam(jcoeffs, table)

    def test_rows_and_tier_keying(self, table):
        _write(table, [_row("rmm", 1.5, 0.3),
                       _row("rmm@bf16x3", 0.5, 0.3)])
        bare = coeffs.strategy_row("rmm", CLS, "cpu", table)
        tiered = coeffs.strategy_row("rmm", CLS, "cpu", table,
                                     tier="bf16x3")
        assert bare["ms_per_gflop"] == 1.5
        assert tiered["ms_per_gflop"] == 0.5
        assert bare["source"] == tiered["source"] == "measured"

    def test_backend_keying_never_crosses_devices(self, table):
        _write(table, [_row("rmm", 1.0, 0.3, backend="tpu"),
                       _row("rmm", 2.0, 0.3, backend="cuda")])
        assert coeffs.strategy_row("rmm", CLS, "cpu", table) is None
        assert coeffs.strategy_row("rmm", CLS, "cuda",
                                   table)["ms_per_gflop"] == 2.0
        assert coeffs.chain_comm_weights(table, "cpu") == {}

    def test_nonfinite_ratios_dropped_fieldwise(self, table):
        _write(table, [_row("rmm", float("nan"), 0.3),
                       _row("cpmm", float("inf"), float("nan"))])
        row = coeffs.strategy_row("rmm", CLS, "cpu", table)
        assert row["ms_per_gflop"] is None and row["ms_per_mib"] == 0.3
        assert coeffs.strategy_row("cpmm", CLS, "cpu", table) is None

    def test_stat_signature_invalidation_without_reset(self, table):
        _write(table, [_row("rmm", 1.0, 0.3)])
        assert coeffs.strategy_row("rmm", CLS, "cpu",
                                   table)["ms_per_gflop"] == 1.0
        entries = {f"rmm|{CLS}|cpu": _row("rmm", 2.25, 0.3)}
        with open(table, "w") as f:
            json.dump({"schema": 1, "entries": entries}, f)
        os.utime(table, ns=(1, 1))
        assert coeffs.strategy_row("rmm", CLS, "cpu",
                                   table)["ms_per_gflop"] == 2.25

    def test_epoch_stable_across_count_only_merge(self, table):
        _write(table, [_row("rmm", 1.0, 0.3, count=10)])
        ep1 = coeffs.epoch(table)
        assert ep1 == jcoeffs.epoch(table)
        _write(table, [_row("rmm", 1.0, 0.3, count=20)])
        assert coeffs.epoch(table) == ep1
        _write(table, [_row("rmm", 1.1, 0.3, count=20)])
        assert coeffs.epoch(table) not in (ep1, coeffs.COLD_EPOCH)

    @pytest.mark.parametrize("row", [
        {"ms_per_gflop": 2.0, "ms_per_mib": 0.5},
        {"ms_per_gflop": 2.0, "ms_per_mib": None},
        {"ms_per_gflop": None, "ms_per_mib": 0.5}])
    def test_predict_ms_equal(self, row):
        assert coeffs.predict_ms(row, 3.0, 4 << 20) == \
            jcoeffs.predict_ms(row, 3.0, 4 << 20)

    def test_drift_calibration_round_trips_into_the_seam(self, tmp_path,
                                                         table):
        """Samples → drift.calibrate → update_table → the seam: the
        same rows in both packages."""
        from matrel_tpu_torch.obs.events import EventLog, read_events
        log = EventLog(str(tmp_path / "e.jsonl"))
        for strat, ms in (("rmm", 2.0), ("cpmm", 6.0), ("rmm", 2.2)):
            log.emit("analyze", {
                "backend": "cpu", "fused_ms": ms,
                "per_op": [{"uid": 1, "label": "m", "ms": ms}],
                "matmuls": [{"uid": 1, "strategy": strat,
                             "dims": [128, 128, 128], "flops": 4.2e6,
                             "est_ici_bytes": 1 << 20}]})
        ev = read_events(log.path)
        drift.update_table(table, drift.calibrate(
            list(drift.iter_samples(ev))))
        coeffs.reset_coefficient_cache()
        jcoeffs.reset_coefficient_cache()
        assert _seam(coeffs, table) == _seam(jcoeffs, table)
        assert set(coeffs.strategy_coefficients(table)) == \
            {f"rmm|{CLS}|cpu", f"cpmm|{CLS}|cpu"}


# -- planner --------------------------------------------------------------------


def _jdecisions(jmesh8, cfg, n=128, seed=7):
    A = JBlockMatrix.random((n, n), mesh=jmesh8, seed=seed)
    B = JBlockMatrix.random((n, n), mesh=jmesh8, seed=seed + 1)
    plan = jexec.compile_expr(A.expr().multiply(B.expr()), jmesh8, cfg)
    return jexec.plan_matmul_decisions(plan), plan


def _tdecisions(cfg, n=128, seed=7):
    s = MatrelSession(config=cfg, device="cpu")
    rng = np.random.default_rng(seed)
    A = s.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    B = s.from_numpy(rng.standard_normal((n, n)).astype(np.float32))
    plan = texec.compile_expr(A.expr().multiply(B.expr()), s.mesh, cfg)
    return texec.plan_matmul_decisions(plan), plan


def _strip(decs):
    return [{k: v for k, v in d.items() if k != "uid"} for d in decs]


class TestMeasuredRanking:
    def _cfgs(self, table, **kw):
        kw.setdefault("coeff_planner_enable", True)
        kw.setdefault("coeff_min_samples", 2)
        return (MatrelConfig(drift_table_path=table, mesh_shape=(2, 4),
                             **kw),
                JConfig(obs_level="off", drift_table_path=table, **kw))

    def test_poisoned_table_flips_pick_equal(self, jmesh8, table):
        analytic = _tdecisions(MatrelConfig(mesh_shape=(2, 4)))[0][0]
        decoy = next(s for s in CANDS if s != analytic["strategy"])
        _write(table, [_row(s, 0.01 if s == decoy else 1.0,
                            0.0001 if s == decoy else 0.5)
                       for s in CANDS])
        tc, jc = self._cfgs(table)
        td, tplan = _tdecisions(tc)
        jd, _ = _jdecisions(jmesh8, jc)
        assert td[0]["strategy"] == decoy
        assert td[0]["cost"] == "measured"
        assert _strip(td) == _strip(jd)
        out = tplan.run()
        assert out.shape == (128, 128)

    @pytest.mark.parametrize("case", ["partial", "min_samples",
                                      "other_backend"])
    def test_cold_coverage_stays_analytic_equal(self, jmesh8, table,
                                                case):
        if case == "partial":
            rows = [_row(s, 1.0, 0.5) for s in CANDS if s != "rmm"]
        elif case == "min_samples":
            rows = [_row(s, 1.0, 0.5, count=1) for s in CANDS]
        else:
            rows = [_row(s, 1.0, 0.5, backend="tpu") for s in CANDS]
        _write(table, rows)
        tc, jc = self._cfgs(table, coeff_min_samples=3)
        td, _ = _tdecisions(tc)
        jd, _ = _jdecisions(jmesh8, jc)
        assert td[0]["cost"] == "analytic"
        assert _strip(td) == _strip(jd)

    def test_default_config_emits_no_cost_stamp(self, table):
        _write(table, [_row(s, 1.0, 0.5) for s in CANDS])
        td, plan = _tdecisions(MatrelConfig(drift_table_path=table,
                                            mesh_shape=(2, 4)))
        assert all("cost" not in d for d in td)
        assert "cost_model" not in plan.optimized.attrs

    def test_stamped_plan_records_cost_model_attr(self, table):
        _write(table, [_row(s, 1.0, 0.5) for s in CANDS])
        tc, _ = self._cfgs(table)
        _, plan = _tdecisions(tc)
        assert plan.optimized.attrs["cost_model"] == "measured"

    @pytest.mark.parametrize("strategy", ["cpmm", "rmm", "bmm_left",
                                          "summa"])
    def test_comm_cost_coeff_scales_equal(self, strategy):
        for coeff in (None, {"ms_per_mib": 2.0}, {}):
            assert planner.comm_cost(strategy, 128, 96, 64, 1.0, 1.0, 2,
                                     2, coeff=coeff) == \
                jplanner.comm_cost(strategy, 128, 96, 64, 1.0, 1.0, 2, 2,
                                   coeff=coeff)
            assert planner.comm_cost_axes(strategy, 128, 96, 64, 1.0,
                                          1.0, 2, 4, coeff=coeff) == \
                jplanner.comm_cost_axes(strategy, 128, 96, 64, 1.0, 1.0,
                                        2, 4, coeff=coeff)


# -- chain DP ---------------------------------------------------------------------


def _chain_dims():
    # FLOP-cheapest and byte-cheapest parenthesisations differ here
    return [(512, 64), (64, 256), (256, 512), (512, 128)]


class TestChainDP:
    def _orders(self, jmesh8, table, **kw):
        rng = np.random.default_rng(3)
        arrs = [rng.standard_normal(s).astype(np.float32)
                for s in _chain_dims()]
        tcfg = MatrelConfig(drift_table_path=table, mesh_shape=(2, 4),
                            **kw)
        jcfg = JConfig(obs_level="off", drift_table_path=table, **kw)
        ts = MatrelSession(config=tcfg, device="cpu")
        js = JSession(mesh=jmesh8, config=jcfg)
        outs = []
        for s in (ts, js):
            ms = [s.from_numpy(a) for a in arrs]
            e = ms[0].expr()
            for m in ms[1:]:
                e = e.multiply(m.expr())
            plan = s.compile(e)
            outs.append((_paren(plan.optimized), plan))
        return outs, arrs

    @pytest.mark.parametrize("mib,gf", [(1e3, 1e-6), (1e-6, 1e3)])
    def test_comm_weights_change_the_order_equally(self, jmesh8, table,
                                                   mib, gf):
        # a measured comm weight far from the analytic one for the
        # class every step falls in: both packages re-parenthesise
        # alike, and the two extremes pick different orders
        _write(table, [_row("rmm", gf, mib, count=9, cls="<=512"),
                       _row("cpmm", gf, mib, count=9, cls="<=512")])
        (t, _tplan), (j, _jplan) = self._orders(
            jmesh8, table, coeff_planner_enable=True,
            coeff_min_samples=2)[0]
        assert t == j
        (t0, _), (j0, _) = self._orders(jmesh8, table)[0]
        assert t0 == j0
        assert coeffs.chain_comm_weights(table, "cpu", 2)

    def test_extreme_weights_pick_different_orders(self, jmesh8, table):
        got = set()
        for mib, gf in ((1e3, 1e-6), (1e-6, 1e3)):
            _write(table, [_row("rmm", gf, mib, count=9, cls="<=512")])
            got.add(self._orders(jmesh8, table,
                                 coeff_planner_enable=True)[0][0][0])
        assert len(got) == 2

    def test_answers_unchanged_by_the_weights(self, jmesh8, table):
        _write(table, [_row("rmm", 1e-6, 1e3, count=9, cls="<=256")])
        (outs, arrs) = self._orders(jmesh8, table,
                                    coeff_planner_enable=True)
        want = arrs[0].astype(np.float64)
        for a in arrs[1:]:
            want = want @ a
        scale = float(np.abs(want).max())
        for _paren_s, plan in outs:
            # the chain's float32 rounding, relative to its magnitude
            err = float(np.abs(plan.run().to_numpy() - want).max())
            assert err <= TOL * scale

    def test_step_cost_weight_equal(self):
        from matrel_tpu.ir import stats as jstats
        from matrel_tpu_torch.ir import stats as tstats
        for cw in (None, 1e-3, 12.5):
            assert tstats.chain_step_cost_layout(
                256, 8, 256, 1.0, 1.0, 2, 4, "2d", "row",
                comm_weight=cw) == jstats.chain_step_cost_layout(
                256, 8, 256, 1.0, 1.0, 2, 4, "2d", "row",
                comm_weight=cw)

    def test_default_runs_the_native_dp(self, monkeypatch):
        """With the consult off the DP stays on the native mirror (no
        learned weight to price)."""
        from matrel_tpu_torch.utils import native
        calls = []
        orig = native.chain_dp
        monkeypatch.setattr(native, "chain_dp",
                            lambda *a, **k: (calls.append(1),
                                             orig(*a, **k))[1])
        s = MatrelSession(config=MatrelConfig(mesh_shape=(2, 4)),
                          device="cpu")
        rng = np.random.default_rng(4)
        ms = [s.from_numpy(rng.standard_normal(d).astype(np.float32))
              for d in _chain_dims()]
        e = ms[0].expr()
        for m in ms[1:]:
            e = e.multiply(m.expr())
        s.compile(e)
        assert calls


def _paren(e) -> str:
    if e.kind == "leaf":
        return f"L{e.shape[0]}x{e.shape[1]}"
    if e.kind == "matmul":
        return f"({_paren(e.children[0])}*{_paren(e.children[1])})"
    return f"{e.kind}[" + ",".join(_paren(c) for c in e.children) + "]"


# -- the session's plan key -------------------------------------------------------


_ID = re.compile(r"(leaf:)(\d+)")


def norm(key: str) -> str:
    ids: dict = {}
    return _ID.sub(lambda m: m.group(1)
                   + f"#{ids.setdefault(m.group(2), len(ids))}", key)


class TestPlanKeyEpoch:
    def test_default_session_has_no_prefix(self):
        s = MatrelSession(device="cpu")
        assert s._coeff_epoch() is None and s._coeff_prefix() == ""
        A = s.from_numpy(np.eye(8, dtype=np.float32))
        s.run(A.expr().t())
        assert all(not k.startswith("coeffv:") for k in s._plan_cache)

    def test_enabled_session_prefixes_plan_keys_like_the_jax(
            self, table, jmesh8):
        _write(table, [_row("rmm", 1.0, 0.3)])
        ep = coeffs.epoch(table)
        ts = MatrelSession(config=MatrelConfig(
            drift_table_path=table, coeff_planner_enable=True),
            device="cpu")
        js = JSession(mesh=jmesh_lib.make_mesh((1, 1),
                                               devices=jax.devices()[:1]),
                      config=JConfig(drift_table_path=table,
                                     coeff_planner_enable=True))
        assert ts._coeff_prefix() == f"coeffv:{ep}|" == js._coeff_prefix()
        a = np.eye(8, dtype=np.float32)
        for s in (ts, js):
            A = s.from_numpy(a)
            s.run(A.expr().multiply(A.expr()))
        assert sorted(map(norm, ts._plan_cache)) == \
            sorted(map(norm, js._plan_cache))

    def test_epoch_change_recompiles_same_answer(self, table):
        _write(table, [_row("rmm", 1.0, 0.3)])
        s = MatrelSession(config=MatrelConfig(
            drift_table_path=table, coeff_planner_enable=True),
            device="cpu")
        rng = np.random.default_rng(1)
        a = rng.standard_normal((16, 16)).astype(np.float32)
        A = s.from_numpy(a)
        r1 = s.run(A.expr().multiply(A.expr()))
        _write(table, [_row("rmm", 1.7, 0.3)])
        r2 = s.run(A.expr().multiply(A.expr()))
        assert len(s._plan_cache) == 2
        np.testing.assert_array_equal(r1.to_numpy(), r2.to_numpy())

    def test_cold_prefix_is_self_describing(self, tmp_path):
        s = MatrelSession(config=MatrelConfig(
            drift_table_path=str(tmp_path / "none.json"),
            coeff_planner_enable=True), device="cpu")
        assert s._coeff_prefix() == "coeffv:cold|"

    def test_query_record_carries_the_epoch(self, table, tmp_path):
        from matrel_tpu_torch.obs.events import read_events
        _write(table, [_row("rmm", 1.0, 0.3)])
        log = str(tmp_path / "e.jsonl")
        s = MatrelSession(config=MatrelConfig(
            drift_table_path=table, coeff_planner_enable=True,
            obs_level="on", obs_event_log=log), device="cpu")
        A = s.from_numpy(np.eye(8, dtype=np.float32))
        s.run(A.expr().multiply(A.expr()))
        [q] = [e for e in read_events(log) if e["kind"] == "query"]
        assert q["coeff_epoch"] == coeffs.epoch(table)

    def test_defaults_and_validation(self):
        cfg = MatrelConfig()
        assert cfg.coeff_planner_enable is False
        with pytest.raises(ValueError, match="coeff_min_samples"):
            MatrelConfig(coeff_min_samples=0)
        with pytest.raises(ValueError, match="coeff_min_samples"):
            JConfig(coeff_min_samples=0)

    def test_default_table_path_equal(self):
        assert drift.table_path(MatrelConfig()) == \
            jdrift.table_path(JConfig()) == ".matrel_drift.json"


# -- the re-plan controller (serve/replan.py) ---------------------------------


def _query(strategy, ms, est, dims=(64, 64, 64)):
    return {"kind": "query", "backend": "cpu", "cache": "miss",
            "execute_ms": ms,
            "matmuls": [{"strategy": strategy, "dims": list(dims),
                         "flops": 2.0 * dims[0] * dims[1] * dims[2],
                         "est_ici_bytes": est}]}


class TestReplanController:
    """The JAX tests' cases, each fed to both packages' controllers (each
    with its own drift table); the round records, epochs and counters
    must be equal."""

    @staticmethod
    def _ctls(tmp_path, **kw):
        kw.setdefault("coeff_replan_cooldown", 2)
        kw.setdefault("coeff_replan_interval", 10 ** 6)
        out = []
        for mod, cfg, name in ((jreplan, JConfig, "j"),
                               (treplan, MatrelConfig, "t")):
            out.append(mod.from_config(cfg(
                obs_level="off",
                drift_table_path=str(tmp_path / f"{name}.json"),
                coeff_planner_enable=True, coeff_replan_enable=True,
                **kw)))
        return out

    @staticmethod
    def _feed(ctls, strategy, ms, est, k=3):
        for c in ctls:
            for _ in range(k):
                c.observe(_query(strategy, ms, est))

    @staticmethod
    def _check(ctls):
        recs = [c.check() for c in ctls]
        assert recs[0] == recs[1]
        assert ctls[0].info() == ctls[1].info()
        return recs[1]

    def test_from_config_default_is_structural_zero(self):
        for mod, cfg in ((jreplan, JConfig), (treplan, MatrelConfig)):
            before = mod._CONSTRUCTED["count"]
            assert mod.from_config(cfg()) is None
            assert mod._CONSTRUCTED["count"] == before

    def test_flag_fires_recalibrates_and_bumps_epoch(self, tmp_path):
        ctls = self._ctls(tmp_path)
        assert isinstance(ctls[1], treplan.ReplanController)
        self._feed(ctls, "cpmm", ms=10.0, est=1000.0)
        self._feed(ctls, "rmm", ms=1.0, est=2000.0)
        rec = self._check(ctls)
        assert rec is not None and ctls[1].replans == 1
        assert rec["classes"] == ["<=64"]
        assert rec["old_epoch"] == coeffs.COLD_EPOCH
        assert rec["epoch"] != coeffs.COLD_EPOCH
        assert rec["flags"][0]["model_prefers"] == "cpmm"
        assert rec["flags"][0]["measured_prefers"] == "rmm"
        assert rec["replanned"] == 0          # no session attached
        row = coeffs.strategy_row("cpmm", "<=64", "cpu",
                                  str(tmp_path / "t.json"))
        assert row is not None and row["source"] == "measured"
        assert ctls[1].info()["window"] == 0

    def test_cooldown_suppresses_immediate_refire(self, tmp_path):
        ctls = self._ctls(tmp_path)
        self._feed(ctls, "cpmm", ms=10.0, est=1000.0)
        self._feed(ctls, "rmm", ms=1.0, est=2000.0)
        assert self._check(ctls) is not None
        self._feed(ctls, "cpmm", ms=10.0, est=1000.0)
        self._feed(ctls, "rmm", ms=1.0, est=2000.0)
        assert self._check(ctls) is None
        assert ctls[1].replans == 1

    def test_reversal_needs_two_consecutive_checks(self, tmp_path):
        ctls = self._ctls(tmp_path, coeff_replan_cooldown=0)
        self._feed(ctls, "cpmm", ms=10.0, est=1000.0)
        self._feed(ctls, "rmm", ms=1.0, est=2000.0)
        assert self._check(ctls) is not None
        self._feed(ctls, "rmm", ms=10.0, est=1000.0)
        self._feed(ctls, "cpmm", ms=1.0, est=2000.0)
        assert self._check(ctls) is None
        assert self._check(ctls) is not None
        assert ctls[1].replans == 2

    def test_interval_triggers_check_from_observe(self, tmp_path):
        ctls = self._ctls(tmp_path, coeff_replan_interval=2)
        for c in ctls:
            c.observe(_query("rmm", 1.0, 1000.0))
            assert c.checks == 0
            c.observe(_query("rmm", 1.0, 1000.0))
            assert c.checks == 1

    def test_observe_never_raises(self, tmp_path):
        for c in self._ctls(tmp_path):
            c.observe({"kind": "query", "matmuls": 5,
                       "execute_ms": "garbage"})
            c.observe({})
            assert c.info()["window"] == 0

    def test_replan_config_requires_planner(self):
        for cfg in (JConfig, MatrelConfig):
            with pytest.raises(ValueError):
                cfg(coeff_replan_enable=True)


class TestReplanSession:
    def test_default_session_constructs_no_replan_state(self):
        before = treplan._CONSTRUCTED["count"]
        s = MatrelSession(device="cpu")
        rng = np.random.default_rng(2)
        x = rng.standard_normal((48, 16)).astype(np.float32)
        X = s.from_numpy(x)
        out = s.run(X.expr().t().multiply(X.expr()))
        assert treplan._CONSTRUCTED["count"] == before
        assert s._replan is None and s._coeff_prefix() == ""
        np.testing.assert_allclose(out.to_numpy(), x.T @ x, rtol=TOL,
                                   atol=TOL)

    def test_warm_queries_replan_with_unchanged_answers(self, tmp_path):
        """obs on, a 4-query interval and a poisoned drift table: the
        controller checks on the query stream, re-calibrates, bumps the
        epoch and re-warms the cached plan; every answer is bit-equal to
        the first."""
        table = str(tmp_path / "drift.json")
        s = MatrelSession(config=MatrelConfig(
            obs_level="on", obs_event_log=str(tmp_path / "ev.jsonl"),
            drift_table_path=table, coeff_planner_enable=True,
            coeff_replan_enable=True, coeff_replan_interval=4,
            coeff_replan_cooldown=0), device="cpu")
        ctl = s._replan
        assert isinstance(ctl, treplan.ReplanController)
        rng = np.random.default_rng(3)
        A = s.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
        B = s.from_numpy(rng.standard_normal((64, 64)).astype(np.float32))
        q = A.expr().multiply(B.expr())
        first = s.run(q).data.clone()
        # the model and the measurement disagree on this class: feed the
        # controller the inversion, then let the warm stream check it
        for _ in range(3):
            ctl.observe(_query("cpmm", 10.0, 1000.0))
            ctl.observe(_query("rmm", 1.0, 2000.0))
        for _ in range(8):
            assert torch_equal(s.run(q).data, first)
        ctl.drain(30.0)
        assert ctl.checks >= 2 and ctl.replans >= 1
        rec = ctl.events[0]
        assert rec["old_epoch"] == coeffs.COLD_EPOCH
        # the warm races the stream's own lazy recompile: it finds the
        # old-epoch plan, and maybe the new one too
        assert rec["matched"] >= 1 and rec["replanned"] == rec["matched"]
        assert ctl.events[-1]["epoch"] == coeffs.epoch(table)
        assert s._coeff_prefix() == f"coeffv:{coeffs.epoch(table)}|"
        assert torch_equal(s.run(q).data, first)
        kinds = [json.loads(line)["kind"]
                 for line in open(str(tmp_path / "ev.jsonl"))]
        assert "replan" in kinds


def torch_equal(a, b) -> bool:
    import torch
    return bool(torch.equal(a, b))
