"""PyTorch port: staged-reshard planning (``matrel_tpu_torch/parallel/reshard.py``,
its planner, chain-DP, executor and autotune hooks) held against the JAX
package on the CPU, mirroring ``tests/test_reshard.py``.

Plans are compared equal step for step with the JAX package's (the byte
accounting is the same float arithmetic, so equal means bit-equal), on
the grids of the JAX tests; decision records equal the JAX package's on
the (2, 4) grid (the JAX package's 8-device CPU mesh, the port's virtual
grid). On one card a staged move is a local copy, so a budgeted result
equals the default config's bit for bit, and the JAX package's within
its tests' tolerance (rtol = atol = 2e-4).
"""

import dataclasses
import json

import numpy as np
import pytest

from matrel_tpu import executor as j_exec
from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
from matrel_tpu.parallel import autotune as j_at, planner as j_planner
from matrel_tpu.parallel import reshard as j_reshard

from matrel_tpu_torch import executor as t_exec
from matrel_tpu_torch.config import MatrelConfig, NotPortedError
from matrel_tpu_torch.core.blockmatrix import BlockMatrix as TBM
from matrel_tpu_torch.core.mesh import P as TP, make_mesh
from matrel_tpu_torch.parallel import autotune as t_at, planner as t_planner
from matrel_tpu_torch.parallel import reshard as reshard_lib

GRIDS = ((2, 4), (4, 2), (2, 2), (1, 8), (8, 1))
PAIRS = (("row", "2d"), ("2d", "row"), ("col", "2d"), ("2d", "col"),
         ("row", "col"), ("col", "row"), ("2d", "rep"), ("row", "rep"),
         ("col", "rep"), ("rep", "row"), ("rep", "col"), ("rep", "2d"))


def _cfg(**kw):
    return MatrelConfig(**kw)


def _jcfg(**kw):
    return JConfig(obs_level="off", **kw)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh((2, 4), device="cpu")


@pytest.fixture(autouse=True)
def _port_autotune_table(tmp_path, monkeypatch):
    monkeypatch.setattr(t_at, "_DEFAULT_TABLE",
                        str(tmp_path / "port_autotune.json"))
    t_at.clear_caches()
    yield
    t_at.clear_caches()


def _same_plan(got, want):
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_dict() == want.to_dict()
    assert got.peak_bytes == want.peak_bytes


class TestCompile:
    @pytest.mark.parametrize("grid", GRIDS)
    def test_plans_equal_jax(self, grid):
        gx, gy = grid
        for src, dst in PAIRS + (("other", "row"), ("row", "row")):
            for B in (4096.0, 1e6, 12345678.0):
                for budget in (0.0, 4 * B / (gx * gy), B / (gx * gy)):
                    for wts in ((1.0, 1.0), (8.0, 1.0), (2.5, 1.5)):
                        _same_plan(
                            reshard_lib.compile_reshard(
                                src, dst, B, gx, gy, wts, budget),
                            j_reshard.compile_reshard(
                                src, dst, B, gx, gy, wts, budget))

    def test_steps_chain_src_to_dst(self):
        for gx, gy in GRIDS:
            for src, dst in PAIRS:
                plan = reshard_lib.compile_reshard(src, dst, 1e6, gx, gy)
                state = src
                for s in plan.steps:
                    assert s.src_state == state
                    state = s.dst_state
                    assert s.kind in reshard_lib.STEP_KINDS
                assert state == dst

    def test_identity_and_single_device_empty(self):
        assert reshard_lib.compile_reshard("row", "row", 1e6, 2,
                                           4).steps == ()
        assert reshard_lib.compile_reshard("row", "col", 1e6, 1,
                                           1).steps == ()

    def test_rep_source_is_free_slice(self):
        plan = reshard_lib.compile_reshard("rep", "col", 1e6, 2, 4)
        assert plan.step_kinds == ("slice",)
        assert plan.weighted_cost == 0.0
        assert plan.bytes_x == plan.bytes_y == 0.0

    def test_unknown_layout_raises(self):
        with pytest.raises(ValueError):
            reshard_lib.compile_reshard("diag", "2d", 1e6, 2, 4)

    def test_cost_bit_identical_to_closed_forms_uniform(self):
        for gx, gy in GRIDS:
            for B in (4096.0, 1e6, 12345678.0):
                for lay in ("row", "col"):
                    assert reshard_lib.compile_reshard(
                        lay, "2d", B, gx, gy).weighted_cost \
                        == t_planner._to_2d_reshard(B, lay, gx, gy)
                for lay, axis in (("2d", "row"), ("2d", "col"),
                                  ("row", "col"), ("col", "row"),
                                  ("rep", "row")):
                    assert reshard_lib.compile_reshard(
                        lay, axis, B, gx, gy).weighted_cost \
                        == t_planner._reshard_to_axis(B, lay, axis, gx, gy)
                for lay in ("2d", "row", "col"):
                    assert reshard_lib.compile_reshard(
                        lay, "rep", B, gx, gy).weighted_cost \
                        == t_planner._split_full_mesh(B, gx, gy, 1.0,
                                                      1.0)[0]

    def test_cost_bit_identical_weighted(self):
        for wts in ((8.0, 1.0), (1.0, 8.0), (2.5, 1.5)):
            for gx, gy in ((2, 4), (4, 2)):
                assert reshard_lib.compile_reshard(
                    "2d", "rep", 1e6, gx, gy, wts).weighted_cost \
                    == t_planner._split_full_mesh(1e6, gx, gy, *wts)[0]
                assert reshard_lib.compile_reshard(
                    "row", "col", 1e6, gx, gy, wts).weighted_cost \
                    == t_planner._reshard_to_axis(1e6, "row", "col", gx, gy,
                                                  weights=wts)

    def test_weighted_mesh_picks_cheaper_axis_order(self):
        gx, gy, B = 2, 4, 1e6
        plan = reshard_lib.compile_reshard("2d", "rep", B, gx, gy,
                                           (8.0, 1.0))
        naive_y_first = 8.0 * B * (gx - 1) / gx + 1.0 * B * (gy - 1) / 8
        assert plan.weighted_cost < naive_y_first
        assert [s.axis for s in plan.steps] == ["x", "y"]

    def test_budget_forces_staged_cross_move(self):
        gx, gy, B = 2, 4, 1e6
        unb = reshard_lib.compile_reshard("row", "col", B, gx, gy)
        assert unb.step_kinds == ("oneshot",) and unb.peak_bytes > B
        bounded = reshard_lib.compile_reshard("row", "col", B, gx, gy,
                                              peak_budget=4 * B / 8)
        assert bounded.step_kinds == ("all_to_all", "all_to_all")
        assert bounded.peak_bytes == 2 * B / 8
        assert bounded.fits(4 * B / 8)
        assert bounded.weighted_cost > unb.weighted_cost
        assert bounded.naive_peak_bytes == unb.peak_bytes

    def test_unfittable_budget_returns_min_peak_unfit_plan(self):
        plan = reshard_lib.compile_reshard("row", "col", 1e6, 2, 4,
                                           peak_budget=1e6 / 8)
        assert not plan.fits(1e6 / 8)
        assert plan.step_kinds == ("all_to_all", "all_to_all")

    def test_naive_peak_and_spill_plans_equal_jax(self):
        for gx, gy in GRIDS:
            for src, dst in PAIRS:
                assert reshard_lib.naive_peak_bytes(src, dst, 1e6, gx, gy) \
                    == j_reshard.naive_peak_bytes(src, dst, 1e6, gx, gy)
        tiers = reshard_lib.SPILL_TIERS
        assert tiers == j_reshard.SPILL_TIERS
        for a in tiers:
            for b in tiers:
                got = reshard_lib.spill_plan(a, b, 4096.0)
                _same_plan(got, j_reshard.spill_plan(a, b, 4096.0))
                for s in got.steps:
                    assert reshard_lib.spill_leg(s) == j_reshard.spill_leg(
                        j_reshard.ReshardStep(**dataclasses.asdict(s)))
        with pytest.raises(ValueError):
            reshard_lib.spill_plan("hbm", "tape", 1.0)
        with pytest.raises(ValueError):
            reshard_lib.spill_leg(reshard_lib.compile_reshard(
                "row", "2d", 1e6, 2, 4).steps[0])

    def test_strategy_moves_and_stageable_equal_jax(self):
        assert reshard_lib.STRATEGY_CONSUMED == j_reshard.STRATEGY_CONSUMED
        for s in tuple(reshard_lib.STRATEGY_CONSUMED) + ("bogus",):
            assert reshard_lib.strategy_moves(s) == j_reshard.strategy_moves(s)
        for pshape in ((64, 64), (16, 64), (1, 64), (6, 64), (64, 6)):
            for src, dst in PAIRS:
                got = reshard_lib.compile_reshard(src, dst, 1e6, 2, 4,
                                                  peak_budget=4e6 / 8)
                want = j_reshard.compile_reshard(src, dst, 1e6, 2, 4,
                                                 peak_budget=4e6 / 8)
                assert reshard_lib.plan_stageable(got, pshape) \
                    == j_reshard.plan_stageable(want, pshape)

    def test_to_dict_and_moves_record(self):
        plan = reshard_lib.compile_reshard("row", "col", 1e6, 2, 4,
                                           peak_budget=1e6)
        d = plan.to_dict()
        assert d["steps"] == list(plan.step_kinds)
        assert d["bytes_by_axis"] == [plan.bytes_x, plan.bytes_y]
        assert reshard_lib.moves_record([]) is None
        jplan = j_reshard.compile_reshard("row", "col", 1e6, 2, 4,
                                          peak_budget=1e6)
        assert reshard_lib.moves_record([(1, plan)]) \
            == j_reshard.moves_record([(1, jplan)])

    def test_apply_staged_is_the_identity_on_one_card(self, tmesh):
        import torch
        x = torch.arange(64.0).reshape(8, 8)
        plan = reshard_lib.compile_reshard("row", "col", 256.0, 2, 4,
                                           peak_budget=128.0)
        assert reshard_lib.apply_staged(x, plan, tmesh) is x
        assert reshard_lib._state_spec("row", tmesh) == TP(("x", "y"), None)


class TestPlannerPricing:
    def test_reshard_to_axis_plan_path_matches_closed_forms(self):
        cfg = _cfg(reshard_peak_budget_bytes=1 << 40)
        for gx, gy in GRIDS:
            for B in (4096.0, 1e6):
                for lay, axis in (("2d", "row"), ("2d", "col"),
                                  ("row", "col"), ("col", "row"),
                                  ("rep", "col"), ("row", "row")):
                    assert t_planner._reshard_to_axis(
                        B, lay, axis, gx, gy, config=cfg) \
                        == t_planner._reshard_to_axis(B, lay, axis, gx, gy)

    def test_tight_budget_prices_the_staged_bill(self):
        gx, gy, B = 2, 4, 1e6
        budget = int(4 * B / 8)
        got = t_planner._reshard_to_axis(
            B, "row", "col", gx, gy, config=_cfg(
                reshard_peak_budget_bytes=budget))
        assert got > t_planner._reshard_to_axis(B, "row", "col", gx, gy)
        assert got == j_planner._reshard_to_axis(
            B, "row", "col", gx, gy, config=_jcfg(
                reshard_peak_budget_bytes=budget))

    def test_default_config_constructs_no_plans(self, tmesh, monkeypatch):
        def poisoned(*a, **k):
            raise AssertionError("ReshardPlan constructed under the "
                                 "default config")

        monkeypatch.setattr(reshard_lib, "compile_reshard", poisoned)
        monkeypatch.setattr(reshard_lib, "ReshardPlan", poisoned)
        rng = np.random.default_rng(0)
        a = rng.random((64, 32), dtype=np.float32)
        b = rng.random((32, 48), dtype=np.float32)
        e = TBM.from_numpy(a, mesh=tmesh).multiply(TBM.from_numpy(
            b, mesh=tmesh))
        out = t_exec.execute(e, tmesh, _cfg())
        np.testing.assert_allclose(out.to_numpy(), a @ b, rtol=2e-4,
                                   atol=2e-4)
        plan = t_exec.compile_expr(e, tmesh, _cfg())
        assert all("reshard" not in r
                   for r in t_exec.plan_matmul_decisions(plan))

    def test_join_scheme_under_a_budget_equals_jax(self, mesh8, tmesh):
        """A row join whose align scheme prices a re-lay: the stamped
        scheme under a tight budget equals the JAX package's."""
        rng = np.random.default_rng(3)
        a = rng.random((64, 16), dtype=np.float32)
        b = rng.random((64, 8), dtype=np.float32)
        for budget in (0, 1 << 30, 256):
            jA = JBM.from_numpy(a, mesh=mesh8)
            jB = JBM.from_numpy(b, mesh=mesh8)
            tA = TBM.from_numpy(a, mesh=tmesh)
            tB = TBM.from_numpy(b, mesh=tmesh)
            merge = "mul"
            from matrel_tpu.relational.ops import join_on_rows as j_join
            from matrel_tpu_torch.relational.ops import join_on_rows as t_join
            je, te = j_join(jA, jB, merge), t_join(tA, tB, merge)
            jcfg = _jcfg(reshard_peak_budget_bytes=budget)
            tcfg = _cfg(reshard_peak_budget_bytes=budget)
            want = j_planner.choose_join_scheme(je, mesh8, jcfg)
            assert t_planner.choose_join_scheme(te, tmesh, tcfg) == want


def _bmm_left_case(mk_j, mk_t, mesh8, tmesh, spec_j, spec_t):
    rng = np.random.default_rng(0)
    a = rng.random((16, 64), dtype=np.float32)
    b = rng.random((64, 64), dtype=np.float32)
    je = mk_j(a).expr().multiply(JBM.from_numpy(b, mesh=mesh8, spec=spec_j)
                                 .expr())
    te = mk_t(a).expr().multiply(TBM.from_numpy(b, mesh=tmesh, spec=spec_t)
                                 .expr())
    return je, te, a @ b


class TestStagedExecution:
    def _case(self, mesh8, tmesh, row=True):
        from jax.sharding import PartitionSpec as JP
        x, y = mesh8.axis_names
        spec_j = JP((x, y), None) if row else JP(None, (x, y))
        spec_t = TP(("x", "y"), None) if row else TP(None, ("x", "y"))
        return _bmm_left_case(lambda v: JBM.from_numpy(v, mesh=mesh8),
                              lambda v: TBM.from_numpy(v, mesh=tmesh),
                              mesh8, tmesh, spec_j, spec_t)

    def test_end_to_end_staged_matmul_matches_oracle(self, mesh8, tmesh):
        """A bmm_left whose RIGHT operand is row-sharded: under the
        budget the plan stages the cross re-lay; the decision record
        equals the JAX package's and the value equals the default
        config's exactly."""
        je, te, ref = self._case(mesh8, tmesh)
        budget = int(4 * 64 * 64 * 4 / 8) + 1
        tcfg = _cfg(strategy_override="bmm_left",
                    reshard_peak_budget_bytes=budget)
        jcfg = _jcfg(strategy_override="bmm_left",
                     reshard_peak_budget_bytes=budget)
        out = t_exec.execute(te, tmesh, tcfg).to_numpy()
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-4)
        np.testing.assert_array_equal(out, t_exec.execute(
            te, tmesh, tcfg.replace(reshard_peak_budget_bytes=0)).to_numpy())
        np.testing.assert_allclose(
            out, j_exec.execute(je, mesh8, jcfg).to_numpy(), rtol=2e-4,
            atol=2e-4)
        (rec,) = t_exec.plan_matmul_decisions(
            t_exec.compile_expr(te, tmesh, tcfg))
        (jrec,) = j_exec.plan_matmul_decisions(
            j_exec.compile_expr(je, mesh8, jcfg))
        assert rec["reshard"] == jrec["reshard"]
        assert rec["reshard"]["steps"] == ["all_to_all", "all_to_all"]
        assert rec["reshard"]["moves"] == [
            {"operand": 1, "src": "row", "dst": "col"}]
        assert rec["reshard"]["peak_bytes"] <= budget

    def test_lowerer_compiles_the_moves_once(self, mesh8, tmesh):
        _, te, _ = self._case(mesh8, tmesh)
        cfg = _cfg(strategy_override="bmm_left",
                   reshard_peak_budget_bytes=int(4 * 64 * 64 * 4 / 8) + 1)
        plan = t_exec.compile_expr(te, tmesh, cfg)
        low = t_exec.Lowerer(tmesh, cfg)
        fn = low.lower(plan.optimized, plan.leaf_order)
        arrays = [l.attrs["matrix"].data for l in plan.leaf_order]
        first = fn(*arrays)
        ((i, mv),) = low.staged_moves[plan.optimized.uid]
        assert i == 1 and mv.step_kinds == ("all_to_all", "all_to_all")
        again = fn(*arrays)
        assert low.staged_moves[plan.optimized.uid][0][1] is mv
        assert np.array_equal(first.numpy(), again.numpy())

    def test_root_relay_plan_equals_jax(self, mesh8, tmesh):
        """A bmm_left root emits "col": the root's canonical re-lay is
        compiled at lowering time, equal to the JAX package's plan."""
        je, te, _ = self._case(mesh8, tmesh, row=False)
        tcfg = _cfg(strategy_override="bmm_left",
                    reshard_peak_budget_bytes=1 << 30)
        jcfg = _jcfg(strategy_override="bmm_left",
                     reshard_peak_budget_bytes=1 << 30)
        topt = t_planner.annotate_strategies(te, tmesh, tcfg)
        jopt = j_planner.annotate_strategies(je, mesh8, jcfg)
        got = reshard_lib.root_relay_plan(topt, tmesh, tcfg)
        want = j_reshard.root_relay_plan(jopt, mesh8, jcfg)
        assert got is not None
        _same_plan(got, want)
        low = t_exec.Lowerer(tmesh, tcfg)
        low.lower(topt, [c for c in topt.children])
        _same_plan(low.root_relays[topt.uid], want)

    def test_budgeted_suite_numerics_unchanged(self, tmesh):
        rng = np.random.default_rng(5)
        a = rng.random((64, 32), dtype=np.float32)
        b = rng.random((32, 48), dtype=np.float32)
        e = TBM.from_numpy(a, mesh=tmesh).multiply(
            TBM.from_numpy(b, mesh=tmesh)).add_scalar(1.0)
        base = t_exec.execute(e, tmesh, _cfg()).to_numpy()
        staged = t_exec.execute(
            e, tmesh, _cfg(reshard_peak_budget_bytes=1 << 30)).to_numpy()
        np.testing.assert_array_equal(base, staged)


class TestChainDegrade:
    def test_budget_degrades_native_to_python_dp(self, tmesh, monkeypatch):
        from matrel_tpu_torch.ir import chain
        from matrel_tpu_torch.utils import native

        def boom(*a, **k):
            raise AssertionError("native DP consulted under a reshard "
                                 "budget")

        monkeypatch.setattr(native, "chain_dp", boom)
        ops = [TBM.random(s, mesh=tmesh, seed=i).expr() for i, s in
               enumerate(((32, 64), (64, 16), (16, 48)))]
        e, cost = chain.optimal_order(
            ops, grid=(2, 4), mesh=tmesh,
            config=_cfg(reshard_peak_budget_bytes=1 << 20))
        assert cost >= 0.0 and e.kind == "matmul"

    def test_budget_zero_consults_native(self, tmesh, monkeypatch):
        from matrel_tpu_torch.ir import chain
        from matrel_tpu_torch.utils import native
        calls = []
        orig = native.chain_dp

        def counted(*a, **k):
            calls.append(1)
            return orig(*a, **k)

        monkeypatch.setattr(native, "chain_dp", counted)
        ops = [TBM.random(s, mesh=tmesh, seed=i).expr() for i, s in
               enumerate(((32, 64), (64, 16), (16, 48)))]
        chain.optimal_order(ops, grid=(2, 4), mesh=tmesh, config=_cfg())
        assert calls

    def test_budget_zero_matches_native_pricing(self):
        rng = np.random.default_rng(7)
        for _ in range(25):
            B = float(rng.integers(1 << 10, 1 << 24))
            gx, gy = GRIDS[rng.integers(0, len(GRIDS))]
            for lay in ("row", "col"):
                assert reshard_lib.compile_reshard(
                    lay, "2d", B, gx, gy).weighted_cost \
                    == t_planner._to_2d_reshard(B, lay, gx, gy)
            wts = (float(rng.integers(1, 9)), float(rng.integers(1, 9)))
            assert reshard_lib.compile_reshard(
                "2d", "rep", B, gx, gy, wts).weighted_cost \
                == t_planner._split_full_mesh(B, gx, gy, *wts)[0]

    def test_budgeted_chain_order_equals_jax(self, mesh8, tmesh):
        rng = np.random.default_rng(9)
        shapes = ((40, 400), (400, 24), (24, 320), (320, 16))
        arrs = [rng.random(s, dtype=np.float32) for s in shapes]
        from matrel_tpu.ir import chain as j_chain
        from matrel_tpu_torch.ir import chain as t_chain
        jops = [JBM.from_numpy(a, mesh=mesh8).expr() for a in arrs]
        tops = [TBM.from_numpy(a, mesh=tmesh).expr() for a in arrs]
        jcfg = _jcfg(reshard_peak_budget_bytes=4096)
        tcfg = _cfg(reshard_peak_budget_bytes=4096)
        je, jcost = j_chain.optimal_order(jops, grid=(2, 4), mesh=mesh8,
                                          config=jcfg)
        te, tcost = t_chain.optimal_order(tops, grid=(2, 4), mesh=tmesh,
                                          config=tcfg)
        assert tcost == pytest.approx(jcost, rel=1e-12)

        def paren(e, ids):
            if e.kind == "matmul":
                return "(" + paren(e.children[0], ids) + \
                    paren(e.children[1], ids) + ")"
            return ids[e.uid]

        assert paren(te, {o.uid: str(i) for i, o in enumerate(tops)}) \
            == paren(je, {o.uid: str(i) for i, o in enumerate(jops)})


class TestAutotuneReshard:
    def test_key_format_equals_jax(self):
        assert t_at._current_key_format("reshard|row>col|4096|2x4|cpu")
        assert t_at._current_key_format("reshard|row>col|4096|2x4|cpu|w1x8")
        assert not t_at._current_key_format("reshard|row>col|4096")
        for B in (256.0 * 256 * 4, 3800.0 ** 2 * 4, 1.0):
            for wts in ((1.0, 1.0), (1.0, 8.0)):
                plan = reshard_lib.compile_reshard("row", "col", B, 2, 4)
                jplan = j_reshard.compile_reshard("row", "col", B, 2, 4)
                assert t_at._reshard_key(plan, 2, 4, "cpu", wts) \
                    == j_at._reshard_key(jplan, 2, 4, wts)

    def test_lookup_measures_persists_and_caches(self, tmesh, monkeypatch,
                                                 tmp_path):
        table = tmp_path / "at.json"
        cfg = _cfg(autotune=True, autotune_table_path=str(table))
        plan = reshard_lib.compile_reshard(
            "row", "col", 256.0 * 256 * 4, 2, 4,
            peak_budget=4.0 * 256 * 256 * 4 / 8)
        times = {"staged": 0.001, "naive": 0.005}
        monkeypatch.setattr(t_at, "measure_reshard_variant",
                            lambda v, p, m, c=None, n_times=5: times[v])
        assert t_at.lookup_or_measure_reshard(plan, tmesh, cfg) == "staged"
        persisted = json.loads(table.read_text())
        (key,) = [k for k in persisted if k.startswith("reshard|")]
        assert persisted[key]["best"] == "staged"
        monkeypatch.setattr(t_at, "measure_reshard_variant",
                            lambda *a, **k: pytest.fail("re-measured"))
        assert t_at.lookup_or_measure_reshard(plan, tmesh, cfg) == "staged"

    def test_persisted_jax_row_is_honoured(self, tmesh, tmp_path,
                                           monkeypatch):
        table = str(tmp_path / "shared.json")
        jplan = j_reshard.compile_reshard("col", "row", 64.0 * 64 * 4, 2, 4,
                                          peak_budget=512.0)
        key = j_at._reshard_key(jplan, 2, 4)
        j_at._persist(table, key, "naive", {"staged": 2.0, "naive": 1.0})
        monkeypatch.setattr(t_at, "measure_reshard_variant",
                            lambda *a, **k: pytest.fail("re-measured"))
        plan = reshard_lib.compile_reshard("col", "row", 64.0 * 64 * 4, 2,
                                           4, peak_budget=512.0)
        cfg = _cfg(autotune=True, autotune_table_path=table)
        assert t_at.lookup_or_measure_reshard(plan, tmesh, cfg) == "naive"

    def test_single_step_plans_never_measured(self, tmesh, monkeypatch):
        monkeypatch.setattr(t_at, "measure_reshard_variant",
                            lambda *a, **k: pytest.fail("measured"))
        plan = reshard_lib.compile_reshard("row", "2d", 256.0 * 256 * 4, 2,
                                           4)
        assert t_at.lookup_or_measure_reshard(
            plan, tmesh, _cfg(autotune=True)) is None

    def test_measure_is_not_ported_on_one_card(self, tmesh, tmp_path):
        plan = reshard_lib.compile_reshard(
            "row", "col", 64.0 * 64 * 4, 2, 4,
            peak_budget=4.0 * 64 * 64 * 4 / 8)
        for v in t_at.RESHARD_VARIANTS:
            with pytest.raises(NotPortedError):
                t_at.measure_reshard_variant(v, plan, tmesh, _cfg())
        # the lookup drops both candidates: no winner, no row
        table = tmp_path / "none.json"
        cfg = _cfg(autotune=True, autotune_table_path=str(table))
        assert t_at.lookup_or_measure_reshard(plan, tmesh, cfg) is None
        assert not table.exists()

    def test_measured_naive_winner_skips_staging(self, tmesh, monkeypatch):
        monkeypatch.setattr(t_at, "lookup_or_measure_reshard",
                            lambda *a, **k: "naive")
        applied = []
        monkeypatch.setattr(reshard_lib, "apply_staged",
                            lambda arr, plan, mesh: applied.append(plan)
                            or arr)
        rng = np.random.default_rng(0)
        A = TBM.from_numpy(rng.random((16, 64), dtype=np.float32),
                           mesh=tmesh)
        Bm = TBM.from_numpy(rng.random((64, 64), dtype=np.float32),
                            mesh=tmesh, spec=TP(("x", "y"), None))
        cfg = _cfg(strategy_override="bmm_left", autotune=True,
                   reshard_peak_budget_bytes=1 << 20)
        e = t_planner.annotate_strategies(A.expr().multiply(Bm.expr()),
                                          tmesh, cfg)
        low = t_exec.Lowerer(tmesh, cfg)
        a2, b2 = low._stage_matmul_operands(e, A.data, Bm.data)
        assert a2 is A.data and b2 is Bm.data and not applied
        monkeypatch.setattr(t_at, "lookup_or_measure_reshard",
                            lambda *a, **k: None)
        low._stage_matmul_operands(e, A.data, Bm.data)
        assert len(applied) == 1


class TestConfig:
    def test_negative_budget_rejected(self):
        with pytest.raises(ValueError):
            MatrelConfig(reshard_peak_budget_bytes=-1)

    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("MATREL_RESHARD_PEAK_BUDGET_BYTES", "4096")
        assert MatrelConfig.from_env().reshard_peak_budget_bytes == 4096
        assert JConfig.from_env().reshard_peak_budget_bytes == 4096
