"""PyTorch port: the SpGEMM kernel registry's host side
(matrel_tpu_torch/ir/stats.py classifiers, ops/kernel_registry.py
selection, schedules and host tables, config.SPGEMM_KERNEL_IDS) held
against the JAX package on the CPU.

Everything here is host numpy on both sides: the same tile lists must
give the same structure class, the same kernel stamp and the same
tables array for array, so that both packages run the same schedule on
the same inputs. The JAX side's kernel gate is opened with
``MatrelConfig(pallas_interpret=True)`` (the counterpart of the port's
default ``use_pallas=True``); its runners are built but never run here.
The JAX band and grouped builders bake pre-gathered payload copies; the
port keeps only the index tables, so those are checked by gathering the
port's payload through its tables and comparing with JAX's copies.
"""

import jax
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.coo import COOMatrix as JCOO
from matrel_tpu.ir import stats as jstats
from matrel_tpu.ops import kernel_registry as jkr
from matrel_tpu.ops import spgemm as jsg
from matrel_tpu.parallel import planner as jplanner

from matrel_tpu_torch import MatrelSession, convert
from matrel_tpu_torch.config import SPGEMM_KERNEL_IDS, MatrelConfig
from matrel_tpu_torch.core.coo import COOMatrix
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.ir import stats
from matrel_tpu_torch.ops import kernel_registry as kr
from matrel_tpu_torch.ops import spgemm as sg


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def tmesh():
    return make_mesh(device="cpu")


# -- classifiers: the hand cases of tests/test_kernel_registry.py ------------


def _blobs():
    parts = []
    for (cr, cc) in ((2, 3), (10, 12), (17, 5)):
        ii, jj = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
        parts.append((cr + ii.ravel(), cc + jj.ravel()))
    return (np.concatenate([p[0] for p in parts]),
            np.concatenate([p[1] for p in parts]), 24, 24)


def _random_tiles(seed):
    flat = np.random.default_rng(seed).choice(32 * 32, size=50,
                                              replace=False)
    return flat // 32, flat % 32, 32, 32


HAND_CASES = {
    "diagonal": (np.arange(32), np.arange(32), 32, 32),
    "tridiagonal": (np.repeat(np.arange(16), 3),
                    np.clip(np.repeat(np.arange(16), 3)
                            + np.tile([-1, 0, 1], 16), 0, 15), 16, 16),
    "shifted band": (np.arange(24), np.clip(np.arange(24) + 5, 0, 31),
                     24, 32),
    "hub rows": (np.concatenate([np.zeros(24, np.int64),
                                 np.full(24, 7, np.int64), np.arange(24)]),
                 np.concatenate([np.arange(24), np.arange(24),
                                 np.full(24, 3, np.int64)]), 24, 24),
    "blobs": _blobs(),
    **{f"uniform seed {s}": _random_tiles(s) for s in range(5)},
    "too few tiles": (np.array([0, 1]), np.array([0, 1]), 16, 16),
    "degenerate grid": (np.arange(8), np.zeros(8), 8, 1),
    "skew under threshold": (
        np.concatenate([np.zeros(5, np.int64), 1 + np.arange(7) * 8]),
        np.concatenate([np.arange(5) * 9, (3 + np.arange(7) * 23) % 64]),
        64, 64),
}


@pytest.mark.parametrize("case", sorted(HAND_CASES))
def test_classifier_matches_jax_on_hand_cases(case):
    rows, cols, gr, gc = HAND_CASES[case]
    want = jstats.classify_block_structure(rows, cols, gr, gc)
    assert stats.classify_block_structure(rows, cols, gr, gc) == want


def test_classifier_constants_and_pair_class_match_jax():
    for name in ("STRUCTURE_CLASSES", "BAND_SPREAD_FRAC",
                 "BAND_SPREAD_TILES", "POWERLAW_SKEW", "POWERLAW_MIN_ROWS",
                 "CLUSTER_NEIGHBOR_LIFT", "CLUSTER_NEIGHBOR_MIN",
                 "CLUSTER_MAX_DENSITY", "STRUCTURE_MIN_TILES"):
        assert getattr(stats, name) == getattr(jstats, name), name
    names = stats.STRUCTURE_CLASSES + ("nonsense",)
    for a in names:
        for b in names:
            assert (stats.pair_structure_class(a, b)
                    == jstats.pair_structure_class(a, b)), (a, b)
    assert stats.block_density(1e-4, 16) == jstats.block_density(1e-4, 16)
    assert (stats.spgemm_saved_estimate(30, 40, 8, 128, 96, 16)
            == jstats.spgemm_saved_estimate(30, 40, 8, 128, 96, 16))


@pytest.mark.parametrize("structure", ["row_band", "clustered_tile",
                                       "powerlaw_coo", "generic"])
@pytest.mark.parametrize("n,bs", [(512, 8), (256, 16)])
def test_synthesize_structure_matches_jax(jmesh, tmesh, structure, n, bs):
    J = jkr.synthesize_structure(structure, n, bs, jmesh, seed=3)
    T = kr.synthesize_structure(structure, n, bs, tmesh, seed=3)
    rows, cols = T.host_tiles()
    np.testing.assert_array_equal(rows, np.asarray(J.block_rows))
    np.testing.assert_array_equal(cols, np.asarray(J.block_cols))
    np.testing.assert_array_equal(T.block_rows.numpy(),
                                  np.asarray(J.block_rows))
    np.testing.assert_array_equal(T.blocks.numpy(), np.asarray(J.blocks))
    assert T.shape == J.shape
    assert kr.structure_of_matrix(T) == jkr.structure_of_matrix(J)
    if n == 512:          # the JAX package's own labelled-generator case
        assert kr.structure_of_matrix(T) == structure


def test_synthesize_bf16_carries_the_same_bits(jmesh, tmesh):
    J = jkr.synthesize_structure("clustered_tile", 128, 16, jmesh, seed=4,
                                 dtype="bfloat16")
    T = kr.synthesize_structure("clustered_tile", 128, 16, tmesh, seed=4,
                                dtype="bfloat16")
    assert T.dtype == torch.bfloat16
    np.testing.assert_array_equal(T.blocks.float().numpy(),
                                  np.asarray(J.blocks, np.float32))


# -- selection ----------------------------------------------------------------


def test_vocabulary_matches_jax_and_config():
    assert kr.kernel_ids() == jkr.kernel_ids()
    assert set(SPGEMM_KERNEL_IDS) == set(kr.kernel_ids())
    assert kr.VMEM_PAIR_BUDGET_BYTES == jkr.VMEM_PAIR_BUDGET_BYTES
    for kid in kr.kernel_ids():
        t, j = kr.get_kernel(kid), jkr.get_kernel(kid)
        assert (t.structures, t.needs_pallas, t.group, t.universal,
                t.bucket_split) == (j.structures, j.needs_pallas, j.group,
                                    j.universal, j.bucket_split), kid
    for bs in (4, 8, 16, 64, 128, 512, 1024):
        for g in (1, 2, 8, 16):
            assert kr.grouped_factor(bs, g) == jkr.grouped_factor(bs, g)


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("override", [""] + list(SPGEMM_KERNEL_IDS))
def test_selection_matches_jax(use_pallas, override):
    """Port default (kernels on) ↔ JAX interpret mode (Pallas on);
    use_pallas=False on both sides."""
    jcfg = JConfig(pallas_interpret=use_pallas, use_pallas=use_pallas,
                   spgemm_kernel_override=override)
    tcfg = MatrelConfig(use_pallas=use_pallas,
                        spgemm_kernel_override=override)
    for structure in stats.STRUCTURE_CLASSES:
        for bs in (4, 8, 16, 512):
            for npairs in (0, 4):
                assert (kr.select_kernel(structure, bs, npairs, tcfg)
                        == jkr.select_kernel(structure, bs, npairs, jcfg)), \
                    (structure, bs, npairs)
                assert (kr.legacy_default(bs, npairs, tcfg)
                        == jkr.legacy_default(bs, npairs, jcfg))
                for kid in SPGEMM_KERNEL_IDS + ("gpu_warp",):
                    assert (kr.admissible(kid, bs, npairs, tcfg)
                            == jkr.admissible(kid, bs, npairs, jcfg)), kid


def test_unknown_override_raises_at_construction():
    with pytest.raises(ValueError, match="warp9000"):
        MatrelConfig(spgemm_kernel_override="warp9000")
    assert MatrelConfig(spgemm_density_threshold=0.1) \
        .spgemm_density_threshold == 0.1


def test_zero_threshold_means_zero_registry_lookups(tmesh):
    A = kr.synthesize_structure("generic", 256, 16, tmesh, seed=21)
    B = kr.synthesize_structure("generic", 256, 16, tmesh, seed=22)
    rng = np.random.default_rng(0)
    C = COOMatrix.from_edges(rng.integers(0, 256, 200),
                             rng.integers(0, 256, 200), shape=(256, 256))
    s = MatrelSession(config=MatrelConfig(spgemm_density_threshold=0.0),
                      device="cpu")
    before = kr._LOOKUPS["count"]
    for e in (A.multiply(B), C.multiply(A.expr()), C.multiply(C.expr())):
        plan = s.compile(e)
        assert "spgemm_kernel" not in plan.optimized.attrs
        assert plan.optimized.attrs["strategy"] != "spgemm"
        s.compute(e)
    assert kr._LOOKUPS["count"] == before
    # and with the default threshold the same S×S query consults it
    MatrelSession(device="cpu").compile(A.multiply(B))
    assert kr._LOOKUPS["count"] > before


# -- host tables and schedules ------------------------------------------------


def _cells(fn) -> dict:
    """The closure variables of a JAX runner, by name."""
    return dict(zip(fn.__code__.co_freevars,
                    (c.cell_contents for c in fn.__closure__)))


def _pair(jmesh, tmesh, structure, n, bs, seeds=(5, 6)):
    JA, JB = (jkr.synthesize_structure(structure, n, bs, jmesh, seed=s)
              for s in seeds)
    return JA, JB, convert.from_reference(JA, tmesh), \
        convert.from_reference(JB, tmesh)


def _runners(JA, JB, TA, TB, kid):
    jpairs = jsg._pair_structure_cached(JA, JB)
    pa, pb, slot, out_rows, out_cols = jpairs
    n_out = int(out_rows.size)
    jrun = jkr.build_runner(kid, JA, JB, JConfig(pallas_interpret=True),
                            True, (slot, pa, pb, out_rows, out_cols), n_out,
                            JA.dtype)
    trun = kr.build_runner(kid, TA, TB, MatrelConfig(),
                           (slot, pa, pb, out_rows, out_cols), n_out,
                           TA.dtype)
    return jrun, trun


def _baked(payload, pa, src, G):
    """The JAX grouped builder's pre-gathered A copy from the port's
    tables: (n_groups, bs, G·bs) row-concatenated tiles, zero tile at the
    padding positions."""
    bs = payload.shape[1]
    z = np.concatenate([payload, np.zeros((1, bs, bs), payload.dtype)])
    ext = np.concatenate([pa, [payload.shape[0]]])
    g = z[ext[src]]
    n_groups = src.size // G
    return g.reshape(n_groups, G, bs, bs).transpose(0, 2, 1, 3) \
        .reshape(n_groups, bs, G * bs)


def _check_grouped(tab, jga, jgs, TA):
    a = sg._edge_masked(TA).numpy()
    np.testing.assert_array_equal(np.asarray(jgs), tab["group_slot"])
    np.testing.assert_array_equal(
        np.asarray(jga), _baked(a, tab["pa"], tab["src"], tab["group"]))


@pytest.mark.parametrize("structure,unsorted_b",
                         [("generic", False), ("powerlaw_coo", False),
                          ("clustered_tile", True)])
def test_pair_structure_matches_jax(jmesh, tmesh, structure, unsorted_b):
    JA, JB, TA, TB = _pair(jmesh, tmesh, structure, 256, 8)
    rows, cols = TB.host_tiles()
    if unsorted_b:            # a hand-built B with unsorted block_rows
        perm = np.random.default_rng(0).permutation(rows.size)
        rows, cols = rows[perm], cols[perm]
    a_rows, a_cols = TA.host_tiles()
    got = sg.pair_structure(a_rows, a_cols, rows, cols, TB.grid[1])
    want = jsg.pair_structure(np.asarray(JA.block_rows),
                              np.asarray(JA.block_cols), rows, cols,
                              JB.grid[1])
    assert len(got[0]) > 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


def test_grouped_tables_and_adaptive_group_match_jax():
    rng = np.random.default_rng(1)
    for n_out, G in ((1, 2), (7, 3), (40, 8)):
        counts = rng.integers(1, 9, n_out)
        slot = np.repeat(np.arange(n_out), counts)
        for g, w in zip(kr._grouped_tables(slot, n_out, G, slot.size),
                        jkr._grouped_tables(slot, n_out, G, slot.size)):
            np.testing.assert_array_equal(g, w)
        for bs in (8, 16, 512):
            for req in (2, 8, 16):
                assert (kr._adaptive_group(counts, req, bs)
                        == jkr._adaptive_group(counts, req, bs))
    assert kr._adaptive_group(np.zeros(0, np.int64), 8, 16) \
        == jkr._adaptive_group(np.zeros(0, np.int64), 8, 16)


def test_cluster_schedule_matches_jax(jmesh, tmesh):
    JA, JB, TA, TB = _pair(jmesh, tmesh, "clustered_tile", 256, 8)
    jrun, trun = _runners(JA, JB, TA, TB, "pallas_cluster")
    assert "_build_grouped" in jrun.__qualname__
    assert trun.schedule == "grouped"
    c = _cells(jrun)
    _check_grouped(trun.tables, c["ga"], c["gs_dev"], TA)


@pytest.mark.parametrize("structure,n,bs,schedule", [
    ("row_band", 256, 8, "band"),
    ("row_band", 200, 16, "band"),
    ("powerlaw_coo", 256, 8, "grouped"),     # band too wide: fallback
])
def test_band_schedule_and_tables_match_jax(jmesh, tmesh, structure, n, bs,
                                            schedule):
    JA, JB, TA, TB = _pair(jmesh, tmesh, structure, n, bs)
    jrun, trun = _runners(JA, JB, TA, TB, "pallas_band")
    assert trun.schedule == schedule
    c = _cells(jrun)
    if schedule == "grouped":
        assert "_build_grouped" in jrun.__qualname__
        _check_grouped(trun.tables, c["ga"], c["gs_dev"], TA)
        return
    assert "_build_band" in jrun.__qualname__
    tab = trun.tables
    np.testing.assert_array_equal(np.asarray(c["sel_dev"]), tab["sel"])
    # JAX's baked strips are the payloads gathered through a_idx / b_idx
    wa, nch, rc = tab["wa"], tab["nchunks"], tab["rc"]
    gr = TA.grid[0]
    a = sg._edge_masked(TA).numpy()
    b = sg._edge_masked(TB).numpy()
    az = np.concatenate([a, np.zeros((1, bs, bs), a.dtype)])
    bz = np.concatenate([b, np.zeros((1, bs, bs), b.dtype)])
    ga = az[tab["a_idx"]].reshape(gr, wa, bs, bs).transpose(0, 2, 1, 3) \
        .reshape(gr, bs, wa * bs)
    gb = bz[tab["b_idx"]].reshape(gr, wa, nch, rc, bs, bs) \
        .transpose(0, 2, 1, 4, 3, 5).reshape(gr * nch, wa * bs, rc * bs)
    np.testing.assert_array_equal(np.asarray(c["ga"]), ga)
    np.testing.assert_array_equal(np.asarray(c["gb"]), gb)


def test_band_chunks_when_the_band_is_wider_than_the_budget(tmesh):
    """At bs = 256 the 5-wide band fits the budget only in chunks of
    rc < rr output columns; at bs = 512 it does not fit at all and the
    grouped schedule runs."""
    for bs, want in ((256, "band"), (512, "grouped")):
        A = kr.synthesize_structure("row_band", 6 * bs, bs, tmesh, seed=1,
                                    dtype="bfloat16")
        pairs = sg._pair_structure_cached(A, A)
        pa, pb, slot, out_rows, out_cols = pairs
        run = kr.build_runner("pallas_band", A, A, MatrelConfig(),
                              (slot, pa, pb, out_rows, out_cols),
                              int(out_rows.size), A.dtype)
        assert run.schedule == want
        if want == "band":
            assert run.tables["nchunks"] > 1


def test_powerlaw_buckets_match_jax(jmesh, tmesh):
    # A·Aᵀ of a powerlaw A: a hub row meets its own transpose in one
    # output tile with a run as long as the row, so both buckets fill
    JA = jkr.synthesize_structure("powerlaw_coo", 256, 8, jmesh, seed=7)
    JB = JA.transpose()
    TA, TB = (convert.from_reference(m, tmesh) for m in (JA, JB))
    jrun, trun = _runners(JA, JB, TA, TB, "pallas_powerlaw")
    assert trun.schedule == "bucketed"
    flat = _cells(jrun)["flat_args"]
    buckets = trun.tables["buckets"]
    assert len(flat) == 4 * len(buckets) == 8       # light + hub buckets
    a = sg._edge_masked(TA).numpy()
    for i, bk in enumerate(buckets):
        gs, ga, _, ids = flat[4 * i:4 * i + 4]
        np.testing.assert_array_equal(np.asarray(ids), bk["ids"])
        np.testing.assert_array_equal(np.asarray(gs), bk["group_slot"])
        np.testing.assert_array_equal(
            np.asarray(ga), _baked(a, bk["pa"], bk["src"], bk["group"]))


# -- planner stamps through compile, per structure class ----------------------


@pytest.mark.parametrize("structure,n,bs", [
    ("row_band", 2048, 16), ("clustered_tile", 256, 16),
    ("powerlaw_coo", 256, 16), ("generic", 256, 16)])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_planner_stamps_match_jax(jmesh, tmesh, structure, n, bs,
                                  use_pallas):
    JA, JB, TA, TB = _pair(jmesh, tmesh, structure, n, bs, seeds=(1, 2))
    jcfg = JConfig(pallas_interpret=use_pallas, use_pallas=use_pallas)
    j = jplanner.annotate_strategies(JA.multiply(JB), jmesh, jcfg).attrs
    t = MatrelSession(config=MatrelConfig(use_pallas=use_pallas),
                      device="cpu").compile(TA.multiply(TB)).optimized.attrs
    keys = ("strategy", "strategy_source", "spgemm_kernel",
            "spgemm_structure", "spgemm_kernel_source")
    assert j["strategy"] == "spgemm"
    assert {k: t.get(k) for k in keys} == {k: j.get(k) for k in keys}


def test_coo_operand_stamps_match_jax(jmesh, tmesh):
    rng = np.random.default_rng(3)
    n, nnz = 256, 150
    r1, c1 = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    r2, c2 = rng.integers(0, n, nnz), rng.integers(0, n, nnz)
    cfg = {"block_size": 16}
    JC1, JC2 = JCOO.from_edges(r1, c1, shape=(n, n)), \
        JCOO.from_edges(r2, c2, shape=(n, n))
    TC1, TC2 = COOMatrix.from_edges(r1, c1, shape=(n, n)), \
        COOMatrix.from_edges(r2, c2, shape=(n, n))
    j = jplanner.annotate_strategies(
        JC1.multiply(JC2.expr()), jmesh,
        JConfig(pallas_interpret=True, **cfg)).attrs
    t = MatrelSession(config=MatrelConfig(**cfg), device="cpu") \
        .compile(TC1.multiply(TC2.expr())).optimized.attrs
    for k in ("strategy", "spgemm_kernel", "spgemm_structure",
              "spgemm_kernel_source"):
        assert t.get(k) == j.get(k), k
