"""PyTorch port: the static plan verifier (``analysis/``) held against the
JAX package on the CPU — ``tests/test_analysis.py``'s 32 cases.

Each case builds the same plan natively in both packages (same seeded
numpy arrays, same hand-made stamps, same configs) on the JAX package's
CPU mesh and the port's virtual grid of the same shape, for the 1 x 1
and the (2, 4) grid, and runs the verifier in each. Both must give the
same diagnostics one for one: (code, severity, node kind, node position
in the verified tree's post-order, node shape) — node uids differ
between the packages, positions do not. Where a case checks a record
instead (a compiled plan's ``meta``, an EXPLAIN text, a ``verify``
event, the planner's HBM numbers) the records must be equal. The JAX
test's own assertions are then checked on the (2, 4) grid, the mesh it
runs on. ``render`` and ``enforce`` are compared too.

Differences the cases account for: the port refuses
``pallas_interpret`` (its kernels' plain versions run on the CPU), so the
mixed COO x sparse case runs the default config in both packages, whose
compact-path claim is "rep" on one device and none on a grid; the
autotune table's keys end in the device type in the port.
"""

import dataclasses
import importlib.util
import json
import os
import re
import types

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRIDS = [(1, 1), (2, 4)]


def ns(pkg, grid, mesh8):
    """One package's verifier-facing surface on a ``grid`` mesh."""
    if pkg == "jax":
        from jax.sharding import PartitionSpec
        from matrel_tpu import analysis, executor, session
        from matrel_tpu.analysis import layout_pass, padding_pass
        from matrel_tpu.config import MatrelConfig
        from matrel_tpu.core import mesh as mesh_lib
        from matrel_tpu.core.blockmatrix import BlockMatrix
        from matrel_tpu.core.coo import COOMatrix
        from matrel_tpu.core.sparse import BlockSparseMatrix
        from matrel_tpu.ir import expr as E, rules
        from matrel_tpu.parallel import autotune, planner
        mesh = (mesh8 if grid == (2, 4) else mesh_lib.make_mesh(
            grid, devices=jax.devices()[:grid[0] * grid[1]]))
        f32 = np.dtype("float32")
        key = lambda side, gx, gy, w: autotune._table_key(  # noqa: E731
            side, gx, gy, "float32", w)
    else:
        from matrel_tpu_torch import analysis, executor, session
        from matrel_tpu_torch.analysis import layout_pass, padding_pass
        from matrel_tpu_torch.config import MatrelConfig
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix
        from matrel_tpu_torch.core.coo import COOMatrix
        from matrel_tpu_torch.core.mesh import P as PartitionSpec
        from matrel_tpu_torch.core.mesh import make_mesh
        from matrel_tpu_torch.core.sparse import BlockSparseMatrix
        from matrel_tpu_torch.ir import expr as E, rules
        from matrel_tpu_torch.parallel import autotune, planner
        mesh = make_mesh(grid, device="cpu")
        f32 = torch.float32
        key = lambda side, gx, gy, w: autotune._table_key(  # noqa: E731
            side, gx, gy, "float32", "cpu", w)
    return types.SimpleNamespace(
        name=pkg, analysis=analysis, executor=executor, session=session,
        layout_pass=layout_pass, padding_pass=padding_pass,
        Config=MatrelConfig, BM=BlockMatrix, BSM=BlockSparseMatrix,
        COO=COOMatrix, E=E, rules=rules, planner=planner,
        autotune=autotune, P=PartitionSpec, mesh=mesh, grid=grid,
        f32=f32, table_key=key)


def annotated(k, e, cfg=None):
    cfg = cfg or k.Config()
    return k.planner.annotate_strategies(
        k.rules.optimize(e, cfg, grid=k.grid, mesh=k.mesh), k.mesh, cfg)


def dense(k, rng, n, m, spec=None):
    return k.BM.from_numpy(rng.standard_normal((n, m)).astype(np.float32),
                           mesh=k.mesh, spec=spec)


def phantom(k, shape, spec):
    """A planner-level stand-in for a matrix too large to materialise:
    the planner and the verifier read only shape/nnz/spec/dtype."""
    return k.E.leaf(types.SimpleNamespace(shape=shape, nnz=None, spec=spec,
                                          dtype=k.f32))


_ADDR = re.compile(r"^(\w+)#(\d+) (.*)$")


def norm(diags, root):
    """Diagnostics as (code, severity, kind, post-order position, shape):
    comparable across the packages, whose node uids differ."""
    pos = {}

    def walk(n):
        if n.uid in pos:
            return
        for c in n.children:
            walk(c)
        pos[n.uid] = len(pos)

    for r in (root if isinstance(root, tuple) else (root,)):
        walk(r)
    out = []
    for d in diags:
        m = _ADDR.match(d.node)
        addr = ((m.group(1), pos.get(int(m.group(2)), -1), m.group(3))
                if m else (d.node,))
        out.append((d.code, d.severity) + addr)
    return out


def verify(k, root, cfg=None):
    """Normalised diagnostics plus the raw ones (for message checks)."""
    diags = k.analysis.verify_plan(root, k.mesh, cfg)
    return norm(diags, root), diags


def paired(grid, mesh8, case):
    """Run ``case(k)`` in both packages; its records must be equal.
    Returns (record, raw) of the port's run, raw being whatever the case
    returns second (unchecked across packages: messages, objects)."""
    rec = []
    for pkg in ("jax", "torch"):
        out = case(ns(pkg, grid, mesh8))
        rec.append(out)
    assert rec[0][0] == rec[1][0], (rec[0][0], rec[1][0])
    return rec[1]


def codes(normed):
    return sorted({d[0] for d in normed})


# ---------------------------------------------------------------------------


@pytest.mark.parametrize("grid", GRIDS)
class TestCleanPlans:

    def test_dense_pipeline_clean(self, grid, mesh8):
        def case(k):
            rng = np.random.default_rng(42)
            X = dense(k, rng, 256, 64)
            y = dense(k, rng, 256, 1)
            e = X.expr().t().multiply(X.expr()).solve(
                X.expr().t().multiply(y.expr()))
            return verify(k, annotated(k, e))
        normed, _ = paired(grid, mesh8, case)
        assert normed == []

    def test_spgemm_and_masking_ops_clean(self, grid, mesh8):
        def case(k):
            S1 = k.BSM.random((256, 256), block_density=0.05,
                              block_size=64, mesh=k.mesh, seed=0)
            S2 = k.BSM.random((256, 256), block_density=0.05,
                              block_size=64, mesh=k.mesh, seed=1)
            e = S1.multiply(S2).add_scalar(1.0).power(-1.0).row_sum()
            return verify(k, annotated(k, e))
        normed, _ = paired(grid, mesh8, case)
        assert normed == []

    def test_compile_under_error_mode(self, grid, mesh8):
        def case(k):
            rng = np.random.default_rng(42)
            A = dense(k, rng, 64, 32)
            B = dense(k, rng, 32, 48)
            plan = k.executor.compile_expr(A.expr().multiply(B.expr()),
                                           k.mesh,
                                           k.Config(verify_plans="error"))
            got = plan.run().to_numpy()
            np.testing.assert_allclose(got, A.to_numpy() @ B.to_numpy(),
                                       rtol=1e-4, atol=1e-4)
            return plan.meta["diagnostics"], None
        assert paired(grid, mesh8, case)[0] == []

    def test_off_mode_pays_nothing(self, grid, mesh8):
        def case(k):
            A = dense(k, np.random.default_rng(42), 64, 32)
            plan = k.executor.compile_expr(A.expr().t().multiply(A.expr()),
                                           k.mesh, k.Config())
            return "diagnostics" in plan.meta, None
        assert paired(grid, mesh8, case)[0] is False


@pytest.mark.parametrize("grid", GRIDS)
class TestStrategyPass:

    def test_mv101_inadmissible_stamp(self, grid, mesh8):
        def case(k):
            rng = np.random.default_rng(42)
            A = dense(k, rng, 64, 64)
            B = dense(k, rng, 64, 64)
            bad = k.E.matmul(A.expr(), B.expr()).with_attrs(
                strategy="summa", strategy_source="model")
            return verify(k, bad)
        normed, _ = paired(grid, mesh8, case)
        if grid == (2, 4):      # summa needs a square grid
            assert codes(normed) == ["MV101"] and normed[0][1] == "error"
        else:
            assert normed == []

    def test_mv101_unknown_strategy(self, grid, mesh8):
        def case(k):
            A = dense(k, np.random.default_rng(42), 64, 64)
            bad = k.E.matmul(A.expr(), A.expr()).with_attrs(strategy="zmm")
            return verify(k, bad)
        normed, raw = paired(grid, mesh8, case)
        assert codes(normed) == ["MV101"]
        assert "vocabulary" in raw[0].message


def _spgemm_pair(k):
    S1 = k.BSM.random((256, 256), block_density=0.02, block_size=64,
                      mesh=k.mesh, seed=2)
    S2 = k.BSM.random((256, 256), block_density=0.02, block_size=64,
                      mesh=k.mesh, seed=3)
    return S1, S2


@pytest.mark.parametrize("grid", GRIDS)
class TestSpgemmPass:

    def test_mv104_stale_stamp_config_drift(self, grid, mesh8):
        def case(k):
            S1, S2 = _spgemm_pair(k)
            opt = annotated(k, S1.multiply(S2), k.Config())
            assert opt.attrs["strategy"] == "spgemm"
            return verify(k, opt, k.Config(spgemm_density_threshold=0.0))
        normed, _ = paired(grid, mesh8, case)
        assert "MV104" in codes(normed)

    def test_mv104_unstamped_dispatch(self, grid, mesh8):
        def case(k):
            S1, S2 = _spgemm_pair(k)
            bad = S1.multiply(S2).with_attrs(strategy="rmm",
                                             strategy_source="model")
            return verify(k, bad)
        normed, raw = paired(grid, mesh8, case)
        assert "MV104" in codes(normed)
        assert "misreport" in [d for d in raw
                               if d.code == "MV104"][0].message


@pytest.mark.parametrize("grid", GRIDS)
class TestLayoutPass:

    def test_mv102_unearned_credit(self, grid, mesh8, monkeypatch):
        def case(k):
            rng = np.random.default_rng(42)
            S = k.BSM.random((256, 256), block_density=0.05,
                             block_size=64, mesh=k.mesh, seed=4)
            D = dense(k, rng, 256, 128)
            opt = annotated(k, S.multiply(D))
            real = k.planner.infer_layout

            def unearned(node, mesh, memo=None, config=None):
                if node.kind == "matmul":
                    return "row"
                return real(node, mesh, memo, config)

            monkeypatch.setattr(k.planner, "infer_layout", unearned)
            try:
                return verify(k, opt)
            finally:
                monkeypatch.setattr(k.planner, "infer_layout", real)
        normed, _ = paired(grid, mesh8, case)
        mv102 = [d for d in normed if d[0] == "MV102"]
        assert mv102 and mv102[0][1] == "warning"

    def test_mixed_coo_sparse_takes_coo_path(self, grid, mesh8):
        def case(k):
            rng = np.random.default_rng(42)
            n_edges = 40_000
            A = k.COO.from_edges(rng.integers(0, 256, n_edges),
                                 rng.integers(0, 256, n_edges),
                                 shape=(256, 256))
            S = k.BSM.random((256, 64), block_density=1.0, block_size=64,
                             mesh=k.mesh, seed=6)
            cfg = k.Config()
            opt = annotated(k, A.multiply(S.expr()), cfg)
            decs = k.planner.matmul_decisions(opt, k.mesh, cfg)
            claim = k.planner.infer_layout(opt, k.mesh, {}, cfg)
            pin = k.layout_pass.pinned_matmul_layout(opt, k.mesh, cfg)
            normed, raw = verify(k, opt, cfg)
            return ([d["dispatch"] for d in decs], claim, pin, normed), raw
        (disp, claim, pin, normed), _ = paired(grid, mesh8, case)
        assert disp == ["coo_spmv"]
        assert claim == pin == ("rep" if grid == (1, 1) else "2d")
        assert [d for d in normed if d[0] == "MV102"] == []

    def test_clean_claims_match_pins(self, grid, mesh8):
        def case(k):
            rng = np.random.default_rng(42)
            S = k.BSM.random((256, 256), block_density=0.05,
                             block_size=64, mesh=k.mesh, seed=5)
            D = dense(k, rng, 256, 256)
            e = S.multiply(D).multiply(dense(k, rng, 256, 64).expr())
            return verify(k, annotated(k, e))
        normed, _ = paired(grid, mesh8, case)
        assert [d for d in normed if d[0] == "MV102"] == []


@pytest.mark.parametrize("grid", GRIDS)
class TestPaddingPass:

    def _flow(self, k, e, contract=None):
        diags = list(k.padding_pass.check_padding_flow(
            e, k.mesh, k.Config(), contract=contract))
        return norm(diags, e), diags

    def test_mv103_missing_remask_seeded(self, grid, mesh8):
        def case(k):
            A = dense(k, np.random.default_rng(42), 60, 60)
            e = annotated(k, A.expr().add_scalar(1.0))
            broken = dict(k.padding_pass.PADDING_CONTRACT,
                          scalar=lambda n: k.padding_pass.BREAKS)
            return self._flow(k, e, broken)
        normed, raw = paired(grid, mesh8, case)
        assert codes(normed) == ["MV103"] and normed[0][1] == "error"
        assert "scalar" in raw[0].message

    def test_mv103_unknown_kind_warns(self, grid, mesh8):
        def case(k):
            A = dense(k, np.random.default_rng(42), 32, 32)
            e = annotated(k, A.expr().row_sum())
            partial = {kk: v for kk, v in
                       k.padding_pass.PADDING_CONTRACT.items()
                       if kk != "agg"}
            return self._flow(k, e, partial)
        normed, raw = paired(grid, mesh8, case)
        assert codes(normed) == ["MV103"] and normed[0][1] == "warning"
        assert "no entry" in raw[0].message

    def test_real_contract_clean_on_breakers(self, grid, mesh8):
        def case(k):
            rng = np.random.default_rng(42)
            A = dense(k, rng, 60, 60)
            B = dense(k, rng, 1, 60)
            e = annotated(k, A.expr().add(B.expr()).add_scalar(2.0)
                          .power(-1.0))
            return self._flow(k, e)
        assert paired(grid, mesh8, case)[0] == []


class TestHBMFeasibility:
    """A plan that over-replicates under RMM on a 16 GiB budget is
    rejected by admissible(), flagged by the verifier and routed to
    cpmm — in both packages, with the same numbers."""

    N, K, M = 4096, 1 << 21, 4096

    def _matmul(self, k):
        axes = tuple(k.mesh.axis_names)
        A = phantom(k, (self.N, self.K), k.P(None, None))
        B = phantom(k, (self.K, self.M), k.P(axes[0], axes[1]))
        return k.E.matmul(A, B)

    @pytest.mark.parametrize("grid", GRIDS)
    def test_hbm_bytes_closed_forms(self, grid, mesh8):
        def case(k):
            return [k.planner.strategy_hbm_bytes(s, self.N, self.K,
                                                 self.M, 2, 4)
                    for s in ("rmm", "cpmm", "xla", "bmm_left",
                              "bmm_right", "summa")], None
        rmm, cpmm, xla = paired(grid, mesh8, case)[0][:3]
        gib = 2.0 ** 30
        assert rmm == pytest.approx(24.008 * gib, rel=0.001)
        assert cpmm == pytest.approx(12.031 * gib, rel=0.001)
        assert xla == 0.0

    @pytest.mark.parametrize("grid", GRIDS)
    def test_admissible_gate(self, grid, mesh8):
        def case(k):
            kw = dict(hbm_budget_bytes=16 << 30)
            adm = k.planner.admissible
            return [adm("rmm", self.N, self.K, self.M, 2, 4, **kw),
                    adm("cpmm", self.N, self.K, self.M, 2, 4, **kw),
                    adm("xla", self.N, self.K, self.M, 2, 4, **kw),
                    adm("rmm", self.N, self.K, self.M, 2, 4,
                        hbm_budget_bytes=0)], None
        assert paired(grid, mesh8, case)[0] == [False, True, True, True]

    @pytest.mark.parametrize("grid", GRIDS)
    def test_planner_routes_rmm_to_cpmm(self, grid, mesh8):
        def case(k):
            node = self._matmul(k)
            return [k.planner.choose_strategy_ex(node, k.mesh, cfg)
                    for cfg in (k.Config(hbm_budget_bytes=0),
                                k.Config())], None
        picks = paired(grid, mesh8, case)[0]
        if grid == (2, 4):
            assert picks == [("rmm", "model"), ("cpmm", "model")]

    @pytest.mark.parametrize("grid", GRIDS)
    def test_mv105_flags_overbudget_stamp(self, grid, mesh8):
        def case(k):
            bad = self._matmul(k).with_attrs(strategy="rmm",
                                             strategy_source="model")
            capped, raw = verify(k, bad, k.Config())
            free, _ = verify(k, bad, k.Config(hbm_budget_bytes=0))
            return (capped, [d for d in free if d[0] == "MV105"]), raw
        (capped, free), raw = paired(grid, mesh8, case)
        if grid == (2, 4):
            mv105 = [d for d in capped if d[0] == "MV105"]
            assert mv105 and mv105[0][1] == "error"
            assert "GiB per device" in [d for d in raw
                                        if d.code == "MV105"][0].message
        assert free == []


@pytest.mark.parametrize("grid", GRIDS)
class TestResultCachePass:

    def test_mv107_stale_layout_and_dtype_stamp(self, grid, mesh8):
        def case(k):
            rng = np.random.default_rng(42)
            B = dense(k, rng, 32, 32)
            cached = dense(k, rng, 32, 32)
            stale = k.E.leaf(cached).with_attrs(result_cache={
                "key_hash": "deadbeef", "layout": "rep",
                "dtype": "float64", "deps": []})
            return verify(k, annotated(k, stale.multiply(B.expr())))
        normed, raw = paired(grid, mesh8, case)
        mv107 = [d for d in raw if d.code == "MV107"]
        if grid == (2, 4):
            assert len(mv107) == 2       # one layout, one dtype finding
            assert any("layout" in d.message for d in mv107)
        assert all(d.severity == "warning" for d in mv107)
        assert any("dtype" in d.message for d in mv107)

    def test_mv107_quiet_on_live_substitution(self, grid, mesh8):
        def case(k):
            rng = np.random.default_rng(42)
            sess = k.session.MatrelSession(mesh=k.mesh, config=k.Config(
                result_cache_max_bytes=64 << 20))
            X = dense(k, rng, 64, 16)
            gram = X.expr().t().multiply(X.expr())
            sess.run(gram)
            B = dense(k, rng, 16, 16)
            sub = sess._rc_substitute(gram.multiply(B.expr()))
            assert any(c.attrs.get("result_cache") for c in sub.children)
            return verify(k, annotated(k, sub))
        normed, _ = paired(grid, mesh8, case)
        assert [d for d in normed if d[0] == "MV107"] == []

    def test_mv107_unstamped_leaves_ignored(self, grid, mesh8):
        def case(k):
            e = dense(k, np.random.default_rng(42), 32, 32).expr().t()
            return verify(k, annotated(k, e))
        normed, _ = paired(grid, mesh8, case)
        assert [d for d in normed if d[0] == "MV107"] == []


@pytest.mark.parametrize("grid", GRIDS)
class TestWiring:

    def test_compile_error_mode_raises_pre_lowering(self, grid, mesh8):
        def case(k):
            A = dense(k, np.random.default_rng(42), 64, 64)
            e = k.E.matmul(A.expr(), A.expr())
            try:
                k.executor.compile_expr(e, k.mesh, k.Config(
                    strategy_override="summa", verify_plans="error"))
            except k.analysis.VerificationError as ex:
                return ("raised", "MV101" in str(ex),
                        [(d.code, d.severity)
                         for d in ex.diagnostics]), None
            return ("compiled",), None
        rec = paired(grid, mesh8, case)[0]
        if grid == (2, 4):
            assert rec[:2] == ("raised", True)

    def test_compile_warn_mode_records_and_runs(self, grid, mesh8):
        def case(k):
            A = dense(k, np.random.default_rng(42), 64, 64)
            plan = k.executor.compile_expr(
                k.E.matmul(A.expr(), A.expr()), k.mesh,
                k.Config(strategy_override="summa", verify_plans="warn"))
            a = A.to_numpy()
            np.testing.assert_allclose(plan.run().to_numpy(), a @ a,
                                       rtol=1e-4, atol=1e-4)
            return [d["code"] for d in plan.meta["diagnostics"]], None
        got = paired(grid, mesh8, case)[0]
        assert got == (["MV101"] if grid == (2, 4) else [])

    def test_session_verify_and_explain(self, grid, mesh8):
        def case(k):
            sess = k.session.MatrelSession(k.mesh, k.Config())
            A = dense(k, np.random.default_rng(42), 64, 32)
            e = A.expr().t().multiply(A.expr())
            txt = sess.explain(e)
            section = txt[txt.index("== Verifier =="):].splitlines()[:2]
            return (sess.verify(e), section), None
        diags, section = paired(grid, mesh8, case)[0]
        assert diags == []
        assert section == ["== Verifier ==", "clean (0 diagnostics)"]

    def test_obs_verify_event(self, grid, mesh8, tmp_path):
        def case(k):
            log = str(tmp_path / f"{k.name}.jsonl")
            sess = k.session.MatrelSession(k.mesh, k.Config(
                obs_level="on", obs_event_log=log, verify_plans="warn"))
            A = dense(k, np.random.default_rng(42), 64, 32)
            sess.compute(A.expr().t().multiply(A.expr()))
            recs = [json.loads(line) for line in open(log)]
            ver = [r for r in recs if r["kind"] == "verify"]
            return ([r["kind"] for r in recs].count("verify"),
                    [{x: r[x] for x in ("mode", "count", "errors",
                                        "codes")} for r in ver]), None
        n, ver = paired(grid, mesh8, case)[0]
        assert n == 1
        assert ver == [{"mode": "warn", "count": 0, "errors": 0,
                        "codes": []}]

    def test_config_validates_verify_plans(self, grid, mesh8):
        def case(k):
            with pytest.raises(ValueError, match="verify_plans"):
                k.Config(verify_plans="eror")
            return k.Config(verify_plans="WARN").verify_plans, None
        assert paired(grid, mesh8, case)[0] == "warn"


def _load_snapshot_tool():
    spec = importlib.util.spec_from_file_location(
        "plan_snapshot", os.path.join(REPO, "tools", "plan_snapshot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _to_port(e, tmesh, memo=None):
    """A JAX-package MatExpr carried node for node into the port's IR
    (matrices through ``convert``; a structured join merge rebuilt from
    its ``merge_kind``)."""
    from matrel_tpu_torch import convert
    from matrel_tpu_torch.ir import expr as TE
    memo = {} if memo is None else memo
    if e.uid in memo:
        return memo[e.uid]
    attrs = dict(e.attrs)
    if "matrix" in attrs:
        attrs["matrix"] = convert.from_reference(attrs["matrix"], tmesh)
    if attrs.get("merge_kind") is not None:
        attrs["merge"] = TE.resolve_join_merge(attrs["merge_kind"])[1]
    out = TE.MatExpr(e.kind, tuple(_to_port(c, tmesh, memo)
                                   for c in e.children),
                     tuple(e.shape), e.nnz, attrs)
    memo[e.uid] = out
    return out


def test_plan_verify_selfcheck_green(mesh8):
    """Every plan of the snapshot corpus verifies with zero diagnostics
    in both packages on the (2, 4) grid (the JAX package's
    ``tools/plan_verify.py`` over the same corpus, carried into the
    port)."""
    from tools import plan_verify
    assert plan_verify.main() == 0
    tool = _load_snapshot_tool()
    j = ns("jax", (2, 4), mesh8)
    k = ns("torch", (2, 4), mesh8)
    for name, e in tool.corpus(mesh8):
        pe = _to_port(e, k.mesh)
        got = [verify(x, annotated(x, ex))[0]
               for x, ex in ((j, e), (k, pe))]
        assert got[0] == got[1] == [], name


@pytest.mark.parametrize("grid", GRIDS)
class TestTopologyPass:
    """MV106: the slow-axis collective smell on a weighted mesh."""

    @staticmethod
    def _wcfg(k):
        return k.Config(axis_cost_weights=(1.0, 8.0))

    @staticmethod
    def _stamped_slow(k):
        base = k.BM.from_numpy(np.zeros((8, 8), np.float32), mesh=k.mesh)
        brep = k.BM.from_numpy(np.zeros((8, 8), np.float32), mesh=k.mesh,
                               spec=k.P(None, None))

        def fab(src, n, m):
            return k.E.leaf(dataclasses.replace(src, shape=(n, m)))

        inner = k.E.matmul(fab(base, 8192, 2048),
                           fab(brep, 2048, 4096)).with_attrs(
            strategy="rmm", strategy_source="override")
        return k.E.matmul(inner, fab(base, 4096, 64))

    def test_mv106_fires_on_hand_stamped_slow_axis_plan(self, grid, mesh8):
        def case(k):
            cfg = self._wcfg(k)
            ann = k.planner.annotate_strategies(self._stamped_slow(k),
                                                k.mesh, cfg)
            return verify(k, ann, cfg)
        normed, raw = paired(grid, mesh8, case)
        if grid == (2, 4):
            mv106 = [d for d in raw if d.code == "MV106"]
            assert mv106 and all(d.severity == "warning" for d in mv106)
            assert "bmm_right" in mv106[0].message

    def test_mv106_quiet_on_planner_output(self, grid, mesh8):
        def case(k):
            cfg = self._wcfg(k)
            rng = np.random.default_rng(42)
            X = dense(k, rng, 256, 64)
            e = X.expr().t().multiply(X.expr()).multiply(
                dense(k, rng, 64, 32).expr())
            return verify(k, annotated(k, e, cfg), cfg)
        assert "MV106" not in codes(paired(grid, mesh8, case)[0])

    def test_mv106_free_on_uniform_mesh(self, grid, mesh8):
        def case(k):
            cfg = k.Config()
            ann = k.planner.annotate_strategies(self._stamped_slow(k),
                                                k.mesh, cfg)
            return verify(k, ann, cfg)
        assert "MV106" not in codes(paired(grid, mesh8, case)[0])

    def test_mv106_respects_root_exposure(self, grid, mesh8):
        def case(k):
            cfg = self._wcfg(k)
            base = k.BM.from_numpy(np.zeros((8, 8), np.float32),
                                   mesh=k.mesh)
            brep = k.BM.from_numpy(np.zeros((8, 8), np.float32),
                                   mesh=k.mesh, spec=k.P(None, None))
            stamped = k.E.matmul(
                k.E.leaf(dataclasses.replace(base, shape=(8192, 2048))),
                k.E.leaf(dataclasses.replace(brep, shape=(2048, 4096)))
            ).with_attrs(strategy="rmm", strategy_source="override")
            at_root, _ = verify(k, stamped, cfg)
            interior = k.E.matmul(stamped, k.E.leaf(dataclasses.replace(
                base, shape=(4096, 64))))
            inner, raw = verify(k, k.planner.annotate_strategies(
                interior, k.mesh, cfg), cfg)
            return (at_root, inner), raw
        (at_root, inner), _ = paired(grid, mesh8, case)
        assert "MV106" not in codes(at_root)
        if grid == (2, 4):
            assert "MV106" in codes(inner)

    def test_mv106_exempts_measured_stamps(self, grid, mesh8, tmp_path,
                                           monkeypatch):
        def case(k):
            path = str(tmp_path / f"{k.name}.json")
            cfg = self._wcfg(k).replace(autotune=True,
                                        autotune_table_path=path)
            gx, gy = grid
            json.dump({k.table_key(2048, gx, gy, (1.0, 8.0)): {
                "best": "rmm", "times": {"rmm": 1e-6, "cpmm": 1.0}}},
                open(path, "w"))
            k.autotune._CACHE.clear()
            if k.name == "torch":
                k.autotune.clear_caches()
            rng = np.random.default_rng(3)
            a = dense(k, rng, 2048, 2048)
            b = dense(k, rng, 2048, 2048)
            inner = k.E.matmul(a.expr(), b.expr())
            outer = k.E.matmul(inner, dense(k, rng, 2048, 64).expr())
            ann = k.planner.annotate_strategies(outer, k.mesh, cfg)
            k.autotune._CACHE.clear()
            src = ann.children[0].attrs["strategy_source"]
            normed, raw = verify(k, ann, cfg)
            return (src, normed), raw
        (src, normed), _ = paired(grid, mesh8, case)
        if grid == (2, 4):
            assert src == "measured"
        assert "MV106" not in codes(normed)


def test_render_and_enforce_match(mesh8):
    """``render`` and ``enforce`` agree: the all-clear text, one line per
    finding, warn logs without raising, error raises VerificationError
    carrying every diagnostic."""
    out = []
    for pkg in ("jax", "torch"):
        k = ns(pkg, (2, 4), mesh8)
        rng = np.random.default_rng(42)
        A = dense(k, rng, 64, 64)
        bad = k.E.matmul(A.expr(), A.expr()).with_attrs(
            strategy="summa", strategy_source="model")
        stale = k.E.leaf(dense(k, rng, 32, 32)).with_attrs(result_cache={
            "key_hash": "deadbeef", "layout": "rep", "dtype": "float64",
            "deps": []})
        diags = (k.analysis.verify_plan(bad, k.mesh)
                 + k.analysis.verify_plan(
                     annotated(k, stale.multiply(dense(k, rng, 32, 32)
                                                 .expr())), k.mesh))
        text = k.analysis.render(diags)
        k.analysis.enforce(diags, "off")
        k.analysis.enforce(diags, "warn")
        k.analysis.enforce([d for d in diags if d.severity != "error"],
                           "error")
        with pytest.raises(k.analysis.VerificationError) as ei:
            k.analysis.enforce(diags, "error")
        assert len(ei.value.diagnostics) == len(diags)
        # node uids differ between the packages: drop them
        out.append((k.analysis.render([]),
                    re.sub(r"#\d+", "#", text),
                    re.sub(r"#\d+", "#", str(ei.value)),
                    [d.to_dict()["code"] for d in diags]))
    assert out[0] == out[1]
    assert out[1][0] == "clean (0 diagnostics)"
