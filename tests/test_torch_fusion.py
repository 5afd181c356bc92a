"""PyTorch port: whole-plan fusion (``matrel_tpu_torch/ir/fusion.py``, the
executor's fused-region lowering and unit programs, the kernels' epilogue
slots, the autotune ``fuse|`` family) held against the JAX package on the
CPU, mirroring ``tests/test_fusion.py``.

Both packages plan on a (2, 4) grid: the JAX package on the 8-device CPU
mesh, the port on the virtual (2, 4) grid of one CPU device. Inputs come
from numpy seeds (block-sparse operands from the JAX package's generators,
carried over by ``matrel_tpu_torch.convert``). Stamps (region signature,
census, remask count, saved dispatches and HBM bytes, tier) are compared
equal; uids differ between the packages, so members and anchors are
matched by their post-order position. Values are compared at the JAX
tests' own tolerances (rtol = atol = 1e-4 against float64 and between the
packages, 1e-3 under the "high" SLA); the port's fused results equal its
staged results exactly (the same torch ops on the same values).
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from matrel_tpu import executor as j_exec
from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
from matrel_tpu.core.coo import COOMatrix as JCOO
from matrel_tpu.core.sparse import BlockSparseMatrix as JBSM
from matrel_tpu.ir import fusion as j_fusion
from matrel_tpu.ir.rules import optimize as j_optimize
from matrel_tpu.ops import kernel_registry as jkr
from matrel_tpu.parallel import autotune as j_at, planner as j_planner

from matrel_tpu_torch import convert, executor as t_exec
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.blockmatrix import BlockMatrix as TBM
from matrel_tpu_torch.core.coo import COOMatrix as TCOO
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.ir import expr as TE, fusion as t_fusion
from matrel_tpu_torch.ir.rules import optimize as t_optimize
from matrel_tpu_torch.ops import kernel_registry as kr
from matrel_tpu_torch.parallel import autotune as t_at, planner as t_planner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

J_OFF = JConfig(obs_level="off")
J_ON = J_OFF.replace(fusion_enable=True)
T_OFF = MatrelConfig()
T_ON = T_OFF.replace(fusion_enable=True)


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh((2, 4), device="cpu")


@pytest.fixture(autouse=True)
def _port_autotune_table(tmp_path, monkeypatch):
    """The port's autotune table and caches, fresh per test (the
    conftest does this for the JAX package only)."""
    monkeypatch.setattr(t_at, "_DEFAULT_TABLE",
                        str(tmp_path / "port_autotune.json"))
    t_at.clear_caches()
    j_at._FUSION_CACHE.clear()
    yield
    t_at.clear_caches()


# -- the two packages side by side -------------------------------------------


def _both(build, mesh8, tmesh, seed=0):
    """(JAX expr, port expr, extra) of ``build(mk, rng)`` where ``mk``
    makes a dense leaf from a numpy array in each package."""
    out = []
    for BM, mesh in ((JBM, mesh8), (TBM, tmesh)):
        rng = np.random.default_rng(seed)
        out.append(build(lambda a, BM=BM, mesh=mesh:
                         BM.from_numpy(a, mesh=mesh), rng))
    (je, extra), (te, _) = out
    return je, te, extra


def _chain(mk, rng, n=32, k=16):
    """(XᵀX)·(1/n) + λI, then row-mean — tests/test_fusion.py's chain."""
    x = rng.standard_normal((n, k)).astype(np.float32)
    X, I = mk(x), mk(np.eye(k, dtype=np.float32))
    e = X.expr().t().multiply(X.expr()).multiply_scalar(1.0 / n) \
        .add(I.expr().multiply_scalar(0.1)) \
        .row_sum().multiply_scalar(1.0 / k)
    ref = ((x.astype(np.float64).T @ x.astype(np.float64)) / n
           + 0.1 * np.eye(k)).sum(axis=1, keepdims=True) / k
    return e, ref


def _pagerank_step(mk, rng, n=48):
    """bench.py's PageRank step: α·(Aᵀ·(w∘r) + Σ(d∘r)/n) + (1-α)/n."""
    a = rng.random((n, n), dtype=np.float32)
    r = rng.random((n, 1), dtype=np.float32)
    w = rng.random((n, 1), dtype=np.float32)
    d = (rng.random((n, 1)) < 0.05).astype(np.float32)
    A, R, W, D = (mk(v) for v in (a, r, w, d))
    contrib = A.expr().t().multiply(W.expr().elem_multiply(R.expr()))
    dmass = D.expr().elem_multiply(R.expr()).sum().multiply_scalar(1.0 / n)
    e = contrib.add(dmass).multiply_scalar(0.85).add_scalar(0.15 / n)
    a64 = a.astype(np.float64)
    ref = 0.85 * (a64.T @ (w * r) + (d * r).sum() / n) + 0.15 / n
    return e, ref


def _linreg_epilogue(mk, rng, n=64, k=16):
    """bench.py's linreg epilogue: rowsum((XᵀX)/n + 0.1·I)/k."""
    x = rng.random((n, k), dtype=np.float32)
    X, I = mk(x), mk(np.eye(k, dtype=np.float32))
    e = X.expr().t().multiply(X.expr()).multiply_scalar(1.0 / n) \
        .add(I.expr().multiply_scalar(0.1)) \
        .row_sum().multiply_scalar(1.0 / k)
    x64 = x.astype(np.float64)
    ref = (x64.T @ x64 / n + 0.1 * np.eye(k)).sum(1, keepdims=True) / k
    return e, ref


def _j_annotated(e, mesh, cfg):
    opt = j_planner.annotate_strategies(j_optimize(e, cfg), mesh, cfg)
    return j_fusion.annotate_fusion(opt, mesh, cfg)


def _t_annotated(e, mesh, cfg):
    opt = t_planner.annotate_strategies(t_optimize(e, cfg), mesh, cfg)
    return t_fusion.annotate_fusion(opt, mesh, cfg)


def _postorder(root):
    out, seen = [], set()

    def walk(n):
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            walk(c)
        out.append(n)

    walk(root)
    return out


def stamps_by_position(root):
    """Every fusion stamp of an annotated plan with its uids replaced by
    post-order positions (the packages' uids differ)."""
    order = _postorder(root)
    pos = {n.uid: i for i, n in enumerate(order)}
    out = []
    for n in order:
        a = n.attrs
        if "fused_region" not in a:
            continue
        out.append({
            "root": pos[n.uid], "kind": n.kind,
            "sig": a["fused_region"],
            "members": sorted(pos[u] for u in a["fused_members"]),
            "anchor": (None if a["fused_anchor"] is None
                       else pos[a["fused_anchor"]]),
            "census": dict(a["fused_census"]), "tier": a["fused_tier"],
            "remask": a["fused_remask"],
            "saved_dispatches": a["fused_saved_dispatches"],
            "saved_hbm_bytes": a["fused_saved_hbm_bytes"]})
    return out


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x)


# -- off state ---------------------------------------------------------------


class TestOffStateBitIdentity:
    def test_off_constructs_no_region_objects(self, mesh8, tmesh):
        _, e, _ = _both(_chain, mesh8, tmesh)
        before = t_fusion._CONSTRUCTED["count"]
        plan = t_exec.compile_expr(e, tmesh, T_OFF)
        assert t_fusion._CONSTRUCTED["count"] == before
        assert not t_fusion.collect_stamps(plan.optimized)
        assert "fusion" not in plan.meta

    def test_off_poisoned_init(self, mesh8, tmesh, monkeypatch):
        def boom(*a, **k):
            raise AssertionError("FusedRegion constructed with "
                                 "fusion_enable off")

        monkeypatch.setattr(t_fusion, "FusedRegion", boom)
        je, te, ref = _both(_chain, mesh8, tmesh)
        got = t_exec.compile_expr(te, tmesh, T_OFF).run().to_numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            got, j_exec.compile_expr(je, mesh8, J_OFF).run().to_numpy(),
            rtol=1e-4, atol=1e-4)

    def test_segment_returns_empty_when_off(self, mesh8, tmesh):
        _, e, _ = _both(_chain, mesh8, tmesh)
        opt = t_planner.annotate_strategies(t_optimize(e, T_OFF), tmesh,
                                            T_OFF)
        assert t_fusion.segment(opt, T_OFF) == []
        assert t_fusion.annotate_fusion(opt, tmesh, T_OFF) is opt


# -- the ten plan snapshots with fusion and reshard off -----------------------


def _snapshot_tool():
    spec = importlib.util.spec_from_file_location(
        "plan_snapshot", os.path.join(REPO, "tools", "plan_snapshot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def snapshots(mesh8):
    tool = _snapshot_tool()
    with open(tool.SNAPSHOT_PATH) as f:
        want = json.load(f)
    return dict(tool.corpus(mesh8)), want


def _to_port(e, tmesh, memo=None):
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


def _signature(e, mesh, lmemo):
    sig = {"kind": e.kind, "shape": list(e.shape)}
    if "strategy" in e.attrs:
        sig["strategy"] = e.attrs["strategy"]
        sig["source"] = e.attrs.get("strategy_source")
    if "replicate" in e.attrs:
        sig["scheme"] = e.attrs["replicate"]
    lay = t_planner.infer_layout(e, mesh, lmemo)
    if lay != "2d":
        sig["layout"] = lay
    if e.children:
        sig["children"] = [_signature(c, mesh, lmemo) for c in e.children]
    return sig


SNAPSHOT_NAMES = ("block_sparse_matmul", "chain_interior_credit",
                  "chain_layout_flip", "chain_skewed", "coo_spmv_matvec",
                  "gram_AtA", "join_under_matmul",
                  "linreg_normal_equations", "rank1_pushdown",
                  "replicated_operand_matmul")


def test_snapshot_corpus_is_the_ten(snapshots):
    names, want = snapshots
    assert set(SNAPSHOT_NAMES) == set(names) == set(want)


@pytest.mark.parametrize("name", SNAPSHOT_NAMES)
def test_knobs_off_leave_snapshots_unchanged(snapshots, tmesh, name,
                                             monkeypatch):
    """Fusion and reshard off (the defaults): every corpus plan compiled
    through ``compile_expr`` equals its snapshot, with no FusedRegion and
    no ReshardPlan constructed and no fusion meta."""
    from matrel_tpu_torch.parallel import reshard as t_reshard

    def poisoned(*a, **k):
        raise AssertionError("constructed with the knobs off")

    monkeypatch.setattr(t_fusion, "FusedRegion", poisoned)
    monkeypatch.setattr(t_reshard, "ReshardPlan", poisoned)
    names, want = snapshots
    cfg = MatrelConfig()
    assert not cfg.fusion_enable and cfg.reshard_peak_budget_bytes == 0
    plan = t_exec.compile_expr(_to_port(names[name], tmesh), tmesh, cfg)
    assert _signature(plan.optimized, tmesh, {}) == want[name]
    assert not t_fusion.collect_stamps(plan.optimized)
    assert "fusion" not in plan.meta
    assert all("reshard" not in r and "fused_region" not in r
               for r in t_exec.plan_matmul_decisions(plan))


# -- region grammar ----------------------------------------------------------


def _rand_sq(n, seed):
    def build(mk, rng):
        return [mk(rng.standard_normal((n, n)).astype(np.float32))
                for _ in range(4)], None
    return build


class TestRegionGrammar:
    def _stamps_equal(self, je, te, mesh8, tmesh, jcfg=J_ON, tcfg=T_ON):
        jopt = _j_annotated(je, mesh8, jcfg)
        topt = _t_annotated(te, tmesh, tcfg)
        want = stamps_by_position(jopt)
        got = stamps_by_position(topt)
        assert got == want
        return topt, got

    def test_epilogue_chain_fuses_with_anchor(self, mesh8, tmesh):
        je, te, _ = _both(_chain, mesh8, tmesh)
        opt, stamps = self._stamps_equal(je, te, mesh8, tmesh)
        (s,) = stamps
        assert s["anchor"] is not None
        assert s["census"]["mm"] == 1 and s["census"]["elemwise.add"] == 1
        assert s["saved_dispatches"] >= 3 and s["saved_hbm_bytes"] > 0
        assert "|" not in s["sig"]

    def test_shared_node_is_a_boundary(self, mesh8, tmesh):
        def build(mk, rng):
            A = mk(rng.standard_normal((16, 16)).astype(np.float32))
            shared = A.expr().multiply_scalar(2.0)
            return shared.add(shared.elem_multiply(shared)), None

        je, te, _ = _both(build, mesh8, tmesh, seed=1)
        opt, _ = self._stamps_equal(je, te, mesh8, tmesh)
        counts = t_fusion.consumer_counts((opt,))
        for s in t_fusion.collect_stamps(opt):
            for uid in t_fusion.region_nodes(s):
                if uid != s.uid:
                    assert counts[uid] == 1

    def test_at_most_one_anchor(self, mesh8, tmesh):
        def build(mk, rng):
            m = [mk(rng.standard_normal((16, 16)).astype(np.float32))
                 for _ in range(4)]
            return m[0].expr().multiply(m[1].expr()).add(
                m[2].expr().multiply(m[3].expr())), None

        je, te, _ = _both(build, mesh8, tmesh, seed=2)
        opt, _ = self._stamps_equal(je, te, mesh8, tmesh)
        for s in t_fusion.collect_stamps(opt):
            assert sum(1 for n in t_fusion.region_nodes(s).values()
                       if n.kind == "matmul") <= 1

    def test_lone_fusable_op_is_not_a_region(self, mesh8, tmesh):
        def build(mk, rng):
            A, B = (mk(rng.standard_normal((16, 16)).astype(np.float32))
                    for _ in range(2))
            return A.expr().add(B.expr()), None

        je, te, _ = _both(build, mesh8, tmesh, seed=3)
        opt, stamps = self._stamps_equal(je, te, mesh8, tmesh)
        assert stamps == []

    def test_remask_census_counts_breakers(self, mesh8, tmesh):
        def build(mk, rng):
            A, B = (mk(rng.standard_normal((16, 16)).astype(np.float32))
                    for _ in range(2))
            return A.expr().multiply(B.expr()).add_scalar(1.0) \
                .multiply_scalar(2.0), None

        je, te, _ = _both(build, mesh8, tmesh, seed=4)
        _, (s,) = self._stamps_equal(je, te, mesh8, tmesh)
        assert s["remask"] == 1

    @pytest.mark.parametrize("chain", ["pagerank_step", "linreg_epilogue"])
    def test_bench_chains_stamp_alike(self, mesh8, tmesh, chain):
        build = {"pagerank_step": _pagerank_step,
                 "linreg_epilogue": _linreg_epilogue}[chain]
        je, te, _ = _both(build, mesh8, tmesh, seed=5)
        _, stamps = self._stamps_equal(je, te, mesh8, tmesh)
        assert len(stamps) == 1 and stamps[0]["anchor"] is not None


# -- fused execution ---------------------------------------------------------


class TestFusedExecutionAgrees:
    def test_dense_chain_oracle(self, mesh8, tmesh):
        je, te, ref = _both(_chain, mesh8, tmesh)
        got = t_exec.compile_expr(te, tmesh, T_ON).run().to_numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            got, j_exec.compile_expr(je, mesh8, J_ON).run().to_numpy(),
            rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("chain", ["chain", "pagerank_step",
                                       "linreg_epilogue"])
    def test_fused_equals_staged_exactly(self, mesh8, tmesh, chain):
        build = {"chain": _chain, "pagerank_step": _pagerank_step,
                 "linreg_epilogue": _linreg_epilogue}[chain]
        je, te, ref = _both(build, mesh8, tmesh, seed=5)
        a = t_exec.compile_expr(te, tmesh, T_OFF).run().to_numpy()
        b = t_exec.compile_expr(te, tmesh, T_ON).run().to_numpy()
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(b, ref, rtol=1e-4, atol=1e-4)
        jb = j_exec.compile_expr(je, mesh8, J_ON).run().to_numpy()
        np.testing.assert_allclose(b, jb, rtol=1e-4, atol=1e-4)

    @pytest.mark.parametrize("structure", ["row_band", "clustered_tile",
                                           "powerlaw_coo", "generic"])
    def test_spgemm_anchor_epilogue(self, mesh8, tmesh, structure):
        """An S×S anchor under the zero-preserving chain ((A·B)·0.5)^2:
        the port's stamp and epilogue mode equal the JAX package's, its
        fused result equals its staged result exactly and the JAX
        package's within 1e-4 (relative to max|ref|)."""
        bs = 8
        n = bs * 48
        SA = jkr.synthesize_structure(structure, n, bs, mesh8, seed=0)
        SB = jkr.synthesize_structure(structure, n, bs, mesh8, seed=1)
        TA, TB = (convert.from_reference(m, tmesh) for m in (SA, SB))
        ref = ((SA.to_numpy().astype(np.float64)
                @ SB.to_numpy().astype(np.float64)) * 0.5) ** 2
        je = SA.multiply(SB).multiply_scalar(0.5).power(2.0)
        te = TA.multiply(TB).multiply_scalar(0.5).power(2.0)
        jcfg = J_ON.replace(block_size=bs, spgemm_density_threshold=0.6)
        tcfg = T_ON.replace(block_size=bs, spgemm_density_threshold=0.6)
        jopt = _j_annotated(je, mesh8, jcfg)
        topt = _t_annotated(te, tmesh, tcfg)
        assert stamps_by_position(topt) == stamps_by_position(jopt)
        (s,) = t_fusion.collect_stamps(topt)
        members = t_fusion.region_nodes(s)
        anchor = members[s.attrs["fused_anchor"]]
        assert anchor.attrs.get("strategy") == "spgemm"
        ew = t_fusion.epilogue_elementwise_chain(s, members, anchor.uid)
        assert ew
        mode = kr.epilogue_mode(kr.pair_class_of(TA, TB), ew)
        assert mode == jkr.epilogue_mode(jkr.pair_class_of(SA, SB), ew)
        assert mode == ("dense" if structure == "generic" else "tilewise")
        got = t_exec.execute(te, tmesh, tcfg).to_numpy()
        staged = t_exec.execute(te, tmesh, tcfg.replace(
            fusion_enable=False)).to_numpy()
        np.testing.assert_array_equal(got, staged)
        want = j_exec.execute(je, mesh8, jcfg).to_numpy()
        scale = max(float(np.abs(ref).max()), 1.0)
        np.testing.assert_allclose(got / scale, ref / scale, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(got / scale, want / scale, rtol=1e-4,
                                   atol=1e-4)

    def test_precision_tier_preserved_in_region(self, mesh8, tmesh):
        def build(mk, rng):
            a = rng.random((32, 32), dtype=np.float32)
            b = rng.random((32, 32), dtype=np.float32)
            e = mk(a).expr().multiply(mk(b).expr()).multiply_scalar(2.0) \
                .add_scalar(0.5)
            return e, a.astype(np.float64) @ b.astype(np.float64) * 2 + 0.5

        je, te, ref = _both(build, mesh8, tmesh, seed=6)
        jcfg = J_ON.replace(precision_sla="high")
        tcfg = T_ON.replace(precision_sla="high")
        topt = _t_annotated(te, tmesh, tcfg)
        assert stamps_by_position(topt) == stamps_by_position(
            _j_annotated(je, mesh8, jcfg))
        (s,) = stamps_by_position(topt)
        assert s["tier"] == "bf16x3"
        got = t_exec.execute(te, tmesh, tcfg).to_numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(
            got, j_exec.execute(je, mesh8, jcfg).to_numpy(), rtol=1e-3,
            atol=1e-3)
        np.testing.assert_array_equal(got, t_exec.execute(
            te, tmesh, tcfg.replace(fusion_enable=False)).to_numpy())

    def test_coo_pagerank_step_region(self, mesh8, tmesh):
        """The PageRank step over a COOMatrix Âᵀ: one region anchored on
        the COO SpMV (B2's route), the prologue w∘r and the epilogue in
        it; fused equals staged exactly and the JAX package within
        1e-4."""
        n, m = 64, 400
        rng = np.random.default_rng(7)
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        vals = rng.random(m).astype(np.float32)
        r = rng.random((n, 1), dtype=np.float32)
        w = rng.random((n, 1), dtype=np.float32)
        d = (rng.random((n, 1)) < 0.1).astype(np.float32)

        def expr(COO, BM, mesh):
            A = COO.from_edges(dst, src, vals, shape=(n, n))
            R, W, D = (BM.from_numpy(v, mesh=mesh) for v in (r, w, d))
            contrib = A.multiply(W.expr().elem_multiply(R.expr()))
            dmass = D.expr().elem_multiply(R.expr()).sum() \
                .multiply_scalar(1.0 / n)
            return contrib.add(dmass).multiply_scalar(0.85) \
                .add_scalar(0.15 / n)

        je, te = expr(JCOO, JBM, mesh8), expr(TCOO, TBM, tmesh)
        topt = _t_annotated(te, tmesh, T_ON)
        stamps = stamps_by_position(topt)
        assert stamps == stamps_by_position(_j_annotated(je, mesh8, J_ON))
        (s,) = t_fusion.collect_stamps(topt)
        members = t_fusion.region_nodes(s)
        anchor = members[s.attrs["fused_anchor"]]
        assert anchor.children[0].kind == "coo_leaf"
        assert anchor.children[1].uid in members       # the w∘r prologue
        a = np.zeros((n, n))
        np.add.at(a, (dst, src), vals)
        ref = 0.85 * (a @ (w * r) + (d * r).sum() / n) + 0.15 / n
        got = t_exec.execute(te, tmesh, T_ON).to_numpy()
        np.testing.assert_array_equal(
            got, t_exec.execute(te, tmesh, T_OFF).to_numpy())
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(
            got, j_exec.execute(je, mesh8, J_ON).to_numpy(), rtol=1e-4,
            atol=1e-4)

    def test_block_sparse_spmm_region(self, mesh8, tmesh):
        """S·D under ·0.5: one region anchored on the SpMM (B1's route),
        its epilogue through ``spmm.apply``'s slot."""
        sp = np.zeros((64, 48), np.float32)
        rng = np.random.default_rng(8)
        sp[0:8, 8:16] = rng.standard_normal((8, 8))
        sp[24:32, 32:40] = rng.standard_normal((8, 8))
        dd = rng.standard_normal((48, 8)).astype(np.float32)
        JS = JBSM.from_numpy(sp, block_size=8, mesh=mesh8)
        TS = convert.from_reference(JS, tmesh)
        je = JS.multiply(JBM.from_numpy(dd, mesh=mesh8)).multiply_scalar(0.5)
        te = TS.multiply(TBM.from_numpy(dd, mesh=tmesh)).multiply_scalar(0.5)
        topt = _t_annotated(te, tmesh, T_ON)
        assert stamps_by_position(topt) == stamps_by_position(
            _j_annotated(je, mesh8, J_ON))
        got = t_exec.execute(te, tmesh, T_ON).to_numpy()
        np.testing.assert_array_equal(
            got, t_exec.execute(te, tmesh, T_OFF).to_numpy())
        np.testing.assert_allclose(got, sp @ dd * 0.5, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(
            got, j_exec.execute(je, mesh8, J_ON).to_numpy(), rtol=1e-4,
            atol=1e-4)


# -- the epilogue slots ------------------------------------------------------


class TestEpilogueSlots:
    def test_run_matmul_epilogue(self, tmesh):
        from matrel_tpu_torch.parallel import strategies
        rng = np.random.default_rng(7)
        a, b = (torch.as_tensor(rng.standard_normal((16, 16)).astype(
            np.float32)) for _ in range(2))
        plain = strategies.run_matmul("xla", a, b, tmesh, T_OFF)
        fused = strategies.run_matmul("xla", a, b, tmesh, T_OFF,
                                      epilogue=lambda x: x * 3.0)
        assert torch.equal(fused, plain * 3.0)

    def test_spmm_apply_epilogue(self, mesh8, tmesh):
        from matrel_tpu.ops import spmm as j_spmm
        from matrel_tpu_torch.ops import spmm as t_spmm
        JS = JBSM.random((64, 64), block_density=0.5, block_size=8,
                         mesh=mesh8, seed=0)
        D = np.random.default_rng(1).random((64, 8), dtype=np.float32)
        JD = JBM.from_numpy(D, mesh=mesh8)
        TS = convert.from_reference(JS, tmesh)
        TD = TBM.from_numpy(D, mesh=tmesh)
        plain = t_spmm.apply(TS, TD.data, TD.shape, T_OFF)
        fused = t_spmm.apply(TS, TD.data, TD.shape, T_OFF,
                             epilogue=lambda x: x + 1.0)
        assert torch.equal(fused, plain + 1.0)
        want = j_spmm.apply(JS, JD.data, JD.shape, J_OFF,
                            epilogue=lambda x: x + 1.0)
        np.testing.assert_allclose(_np(fused)[:64, :8],
                                   np.asarray(want)[:64, :8], rtol=1e-4,
                                   atol=1e-4)

    @pytest.mark.parametrize("structure", ["row_band", "clustered_tile",
                                           "powerlaw_coo"])
    def test_spgemm_tilewise_matches_dense_hook(self, mesh8, tmesh,
                                                structure):
        """A zero-preserving scalar epilogue applied tile-wise equals the
        dense post-scatter application bit for bit (the hook changes
        where the chain runs, never the product), and the JAX package's
        within 1e-6."""
        from matrel_tpu.ops import spgemm as j_sg
        from matrel_tpu_torch.ops import spgemm as t_sg
        bs = 8
        n = bs * 16
        SA = jkr.synthesize_structure(structure, n, bs, mesh8, seed=2)
        SB = jkr.synthesize_structure(structure, n, bs, mesh8, seed=3)
        TA, TB = (convert.from_reference(m, tmesh) for m in (SA, SB))
        assert kr.pair_class_of(TA, TB) == jkr.pair_class_of(SA, SB)
        assert kr.epilogue_mode(kr.pair_class_of(TA, TB), True) \
            == "tilewise"
        cfg = T_OFF.replace(block_size=bs)
        epi = lambda x: (x * 0.25) ** 2
        tile = t_sg.apply_dense(TA, TB, cfg, epilogue=epi,
                                epilogue_elementwise=True)
        dense = t_sg.apply_dense(TA, TB, cfg, epilogue=epi,
                                 epilogue_elementwise=False)
        assert torch.equal(tile, dense)
        assert torch.equal(dense, epi(t_sg.apply_dense(TA, TB, cfg)))
        want = j_sg.apply_dense(SA, SB, J_OFF.replace(block_size=bs),
                                epilogue=epi, epilogue_elementwise=True)
        np.testing.assert_allclose(_np(tile)[:n, :n],
                                   np.asarray(want)[:n, :n], rtol=1e-6,
                                   atol=1e-6)

    def test_hook_table_equals_jax(self):
        assert kr.EPILOGUE_MODES == jkr.EPILOGUE_MODES
        assert kr._EPILOGUE_HOOKS == jkr._EPILOGUE_HOOKS
        assert kr.epilogue_mode("generic", True) == "dense"
        assert kr.epilogue_mode("row_band", False) == "dense"
        assert kr.epilogue_mode("unclassified", True) == "dense"
        tiles = torch.ones(2, 3, 3)
        assert torch.equal(kr.apply_tile_epilogue(tiles, lambda t: t * 2),
                           tiles * 2)

    def test_register_epilogue_hook_validates(self):
        with pytest.raises(ValueError):
            kr.register_epilogue_hook("row_band", "bogus")


# -- unit programs -----------------------------------------------------------


class TestUnitProgramSeam:
    @pytest.mark.parametrize("chain", ["chain", "pagerank_step",
                                       "linreg_epilogue"])
    def test_dispatch_counts_shrink(self, mesh8, tmesh, chain):
        build = {"chain": _chain, "pagerank_step": _pagerank_step,
                 "linreg_epilogue": _linreg_epilogue}[chain]
        je, te, ref = _both(build, mesh8, tmesh, seed=14)
        staged = t_exec.compile_staged_units(te, tmesh, T_OFF)
        fused = t_exec.compile_region_units(te, tmesh, T_ON)
        assert fused.dispatches < staged.dispatches
        assert fused.dispatches == j_exec.compile_region_units(
            je, mesh8, J_ON).dispatches
        assert staged.dispatches == j_exec.compile_staged_units(
            je, mesh8, J_OFF).dispatches
        a, b = _np(staged.run()), _np(fused.run())
        np.testing.assert_array_equal(a, b)
        np.testing.assert_allclose(b[:ref.shape[0], :ref.shape[1]], ref,
                                   rtol=1e-4, atol=1e-4)

    def test_region_units_without_fusion_match_staged(self, mesh8, tmesh):
        _, te, _ = _both(_chain, mesh8, tmesh, seed=15)
        ru = t_exec.compile_region_units(te, tmesh, T_OFF)
        su = t_exec.compile_staged_units(te, tmesh, T_OFF)
        assert ru.dispatches == su.dispatches
        np.testing.assert_array_equal(_np(ru.run()), _np(su.run()))

    def test_bare_leaf_is_one_identity_unit(self, tmesh):
        X = TBM.from_numpy(np.ones((8, 8), np.float32), mesh=tmesh)
        units = t_exec.compile_region_units(X.expr(), tmesh, T_ON)
        assert units.dispatches == 1
        assert torch.equal(units.run(), X.data)

    def test_region_probe_programs(self, mesh8, tmesh):
        _, te, _ = _both(_chain, mesh8, tmesh, seed=16)
        opt = t_planner.annotate_strategies(t_optimize(te, T_ON), tmesh,
                                            T_ON)
        (region,) = t_fusion.segment(opt, T_ON, mesh=tmesh)
        node = t_fusion._find_uid(opt, region.root_uid)
        fused, staged, ins, arrays, root_uid = t_exec.region_probe_programs(
            node, region.member_uids, tmesh, T_ON)
        env = dict(arrays)
        for n, fn, i in staged:
            env[n.uid] = fn(*(env[u] for u in i))
        assert torch.equal(fused(*(arrays[u] for u in ins)), env[root_uid])
        # the probes are np.random.default_rng(0) draws, in input order
        first = np.random.default_rng(0).standard_normal(
            tuple(arrays[ins[0]].shape)).astype(np.float32)
        np.testing.assert_array_equal(arrays[ins[0]].numpy(), first)

    def test_sparse_payload_region_is_not_probeable(self, tmesh):
        sp = np.zeros((16, 16), np.float32)
        sp[0:8, 0:8] = 1.0
        from matrel_tpu_torch.core.sparse import BlockSparseMatrix
        S = BlockSparseMatrix.from_numpy(sp, block_size=8, mesh=tmesh)
        D = TBM.from_numpy(np.ones((16, 4), np.float32), mesh=tmesh)
        e = S.multiply(D).multiply_scalar(2.0)
        opt = t_planner.annotate_strategies(t_optimize(e, T_ON), tmesh,
                                            T_ON)
        (region,) = t_fusion.segment(opt, T_ON, mesh=tmesh)
        node = t_fusion._find_uid(opt, region.root_uid)
        assert t_exec.region_probe_programs(node, region.member_uids,
                                            tmesh, T_ON) is None


# -- the autotune fuse| family ------------------------------------------------


class TestAutotuneFuseFamily:
    def test_key_format_equals_jax(self):
        for sig, side in (("mmx1+scalar.mulx2", 512), ("agg.sumx2", 3000)):
            key = t_at._fusion_key(sig, side, 2, 4, "cpu")
            assert key == j_at._fusion_key(sig, side, 2, 4)
            assert t_at._current_key_format(key)
            assert t_at._current_key_format(key + "|w1x4")
        assert t_at._fusion_key("s", 512, 2, 4, "cpu", (1.0, 4.0)) \
            == j_at._fusion_key("s", 512, 2, 4, (1.0, 4.0))
        assert not t_at._current_key_format("fuse|sig|extra|f|g|h|i")

    def _region(self, mesh8, tmesh, seed):
        _, te, _ = _both(_chain, mesh8, tmesh, seed=seed)
        opt = t_planner.annotate_strategies(t_optimize(te, T_ON), tmesh,
                                            T_ON)
        (region,) = t_fusion.segment(opt, T_ON, mesh=tmesh)
        return region, opt

    def test_measure_and_persist_roundtrip(self, mesh8, tmesh, tmp_path):
        region, opt = self._region(mesh8, tmesh, 16)
        table = str(tmp_path / "fuse.json")
        cfg = T_ON.replace(autotune=True, autotune_table_path=table)
        times = t_at.measure_fusion_region(region, opt, tmesh, cfg,
                                           n_times=1)
        assert set(times) == {"fused", "staged"}
        assert all(t > 0.0 for t in times.values())
        best = t_at.lookup_or_measure_fusion(region, opt, tmesh, cfg)
        assert best in (None, "fused", "staged")
        persisted = t_at.load_table(table)
        (key,) = [k for k in persisted if k.startswith("fuse|")]
        assert set(persisted[key]["times"]) == {"fused", "staged"}
        t_at.clear_caches()
        again = t_at.lookup_or_measure_fusion(region, opt, tmesh, cfg)
        assert again == best

    def test_rows_cross_between_packages(self, mesh8, tmesh, tmp_path,
                                         monkeypatch):
        """A ``fuse|`` row the JAX package persisted is read by the port
        (no measurement) and a port row by the JAX package: one table
        format."""
        je, te, _ = _both(_chain, mesh8, tmesh, seed=17)
        table = str(tmp_path / "shared.json")
        jopt = j_planner.annotate_strategies(j_optimize(je, J_ON), mesh8,
                                             J_ON)
        (jreg,) = j_fusion.segment(jopt, J_ON, mesh=mesh8)
        topt = t_planner.annotate_strategies(t_optimize(te, T_ON), tmesh,
                                             T_ON)
        (treg,) = t_fusion.segment(topt, T_ON, mesh=tmesh)
        assert treg.sig == jreg.sig
        monkeypatch.setattr(j_at, "measure_fusion_region",
                            lambda *a, **k: {"fused": 1.0, "staged": 5.0})
        jcfg = J_ON.replace(autotune=True, autotune_table_path=table)
        assert j_at.lookup_or_measure_fusion(jreg, jopt, mesh8, jcfg) \
            == "fused"
        monkeypatch.setattr(t_at, "measure_fusion_region",
                            lambda *a, **k: pytest.fail("re-measured"))
        tcfg = T_ON.replace(autotune=True, autotune_table_path=table)
        assert t_at.lookup_or_measure_fusion(treg, topt, tmesh, tcfg) \
            == "fused"
        # a port row (another signature class) read back by the JAX side
        key = t_at._fusion_key("mmx1+scalar.mulx1", 64, 2, 4, "cpu")
        t_at._persist(table, key, "staged", {"fused": 3.0, "staged": 1.0})
        j_at._TABLE_CACHE.clear()
        assert j_at._load_table_cached(table)[key]["best"] == "staged"

    def test_staged_winner_suppresses_stamp(self, mesh8, tmesh,
                                            monkeypatch):
        _, te, _ = _both(_chain, mesh8, tmesh, seed=18)
        monkeypatch.setattr(t_at, "lookup_or_measure_fusion",
                            lambda *a, **k: "staged")
        cfg = T_ON.replace(autotune=True)
        opt = t_planner.annotate_strategies(t_optimize(te, cfg), tmesh, cfg)
        out = t_fusion.annotate_fusion(opt, tmesh, cfg)
        assert not t_fusion.collect_stamps(out)
        assert out is opt

    def test_fused_winner_keeps_stamp(self, mesh8, tmesh, monkeypatch):
        _, te, _ = _both(_chain, mesh8, tmesh, seed=18)
        monkeypatch.setattr(t_at, "lookup_or_measure_fusion",
                            lambda *a, **k: "fused")
        cfg = T_ON.replace(autotune=True)
        opt = t_planner.annotate_strategies(t_optimize(te, cfg), tmesh, cfg)
        assert len(t_fusion.collect_stamps(
            t_fusion.annotate_fusion(opt, tmesh, cfg))) == 1


# -- decision records and plan meta -------------------------------------------


def _strip_uid(recs):
    return [{k: v for k, v in r.items() if k != "uid"} for r in recs]


class TestObsSurfaces:
    @pytest.mark.parametrize("chain", ["chain", "pagerank_step",
                                       "linreg_epilogue"])
    def test_matmul_decisions_carry_boundary(self, mesh8, tmesh, chain):
        build = {"chain": _chain, "pagerank_step": _pagerank_step,
                 "linreg_epilogue": _linreg_epilogue}[chain]
        je, te, _ = _both(build, mesh8, tmesh, seed=18)
        tplan = t_exec.compile_expr(te, tmesh, T_ON)
        jplan = j_exec.compile_expr(je, mesh8, J_ON)
        got = t_exec.plan_matmul_decisions(tplan)
        want = j_exec.plan_matmul_decisions(jplan)
        assert _strip_uid(got) == pytest.approx(_strip_uid(want))
        (d,) = got
        assert d["fused_region"] and d["fused_census"]["mm"] == 1
        assert d["est_saved_dispatches"] >= 3
        assert d["est_saved_hbm_bytes"] > 0
        assert tplan.meta["fusion"] == jplan.meta["fusion"]
        assert tplan.meta["fusion"]["regions"] == 1

    def test_decisions_unchanged_when_off(self, mesh8, tmesh):
        je, te, _ = _both(_chain, mesh8, tmesh, seed=19)
        got = t_exec.plan_matmul_decisions(
            t_exec.compile_expr(te, tmesh, T_OFF))
        (d,) = got
        assert "fused_region" not in d
        assert "est_saved_dispatches" not in d
        assert _strip_uid(got) == pytest.approx(_strip_uid(
            j_exec.plan_matmul_decisions(
                j_exec.compile_expr(je, mesh8, J_OFF))))

    def test_multiplan_fusion_meta(self, mesh8, tmesh):
        _, te1, _ = _both(_chain, mesh8, tmesh, seed=20)
        _, te2, _ = _both(_linreg_epilogue, mesh8, tmesh, seed=21)
        multi = t_exec.compile_exprs((te1, te2), tmesh, T_ON)
        assert multi.meta["fusion"]["regions"] == 2
        outs = multi.run()
        for e, out in zip((te1, te2), outs):
            np.testing.assert_array_equal(
                out.to_numpy(),
                t_exec.compile_expr(e, tmesh, T_OFF).run().to_numpy())


class TestConfigKnob:
    def test_env_override(self, monkeypatch):
        monkeypatch.setenv("MATREL_FUSION_ENABLE", "1")
        assert MatrelConfig.from_env().fusion_enable is True
        assert JConfig.from_env().fusion_enable is True

    def test_from_dict(self):
        cfg = MatrelConfig.from_dict({"fusion_enable": True})
        assert cfg.fusion_enable and cfg == T_ON


class TestNoLeakedIntermediates:
    """The region and unit evaluators refer to themselves, so each
    clears its memo on the way out: with the garbage collector off, a
    fused run leaves no tensor in a reference cycle (on the card a
    leaked 4 GiB intermediate a call runs it out of memory)."""

    def _cycle_tensors(self, run):
        import gc
        gc.collect()
        gc.disable()
        try:
            gc.set_debug(gc.DEBUG_SAVEALL)
            out = run()
            gc.collect()
            leaked = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
        finally:
            gc.set_debug(0)
            gc.garbage.clear()
            gc.enable()
        return out, leaked

    @pytest.mark.parametrize("chain", ["chain", "pagerank_step"])
    def test_fused_compute_leaves_no_cycle(self, mesh8, tmesh, chain):
        build = {"chain": _chain, "pagerank_step": _pagerank_step}[chain]
        _, te, _ = _both(build, mesh8, tmesh, seed=22)
        plan = t_exec.compile_expr(te, tmesh, T_ON)
        assert t_fusion.collect_stamps(plan.optimized)
        plan.run()
        _, leaked = self._cycle_tensors(plan.run)
        assert leaked == []

    def test_spgemm_epilogue_leaves_no_cycle(self, mesh8, tmesh):
        SA = jkr.synthesize_structure("row_band", 128, 8, mesh8, seed=0)
        TA = convert.from_reference(SA, tmesh)
        cfg = T_ON.replace(block_size=8, spgemm_density_threshold=0.6)
        plan = t_exec.compile_expr(
            TA.multiply(TA).multiply_scalar(0.5).power(2.0), tmesh, cfg)
        plan.run()
        _, leaked = self._cycle_tensors(plan.run)
        assert leaked == []

    def test_units_leave_no_cycle(self, mesh8, tmesh):
        _, te, _ = _both(_chain, mesh8, tmesh, seed=23)
        for units in (t_exec.compile_region_units(te, tmesh, T_ON),
                      t_exec.compile_staged_units(te, tmesh, T_OFF)):
            units.run()
            _, leaked = self._cycle_tensors(units.run)
            assert leaked == []
