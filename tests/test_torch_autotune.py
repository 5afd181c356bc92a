"""PyTorch port: the measured-choice loop (parallel/autotune.py — its
matmul, SpMV and SpGEMM families), ``kernel_registry.select_kernel``'s
measured branch, the planner's autotune branch and the executor's
measured SpMV variant, held against the JAX package on the CPU.

Mirrors tests/test_io_cli.py's autotune classes and
tests/test_kernel_registry.py's measured-kernel cases, with ``measure_*``
monkeypatched where those tests patch them. The JAX package runs on the
conftest's 8 virtual CPU devices ((2, 4) grid) or one device; the port
on the CPU with the same virtual grid. Keys, pruned tables, winners,
stamps and sources are compared exactly; results of a measured SpMV
variant within 1e-5 of max|y| (the SpMV bound of
tests/test_torch_coo.py).
"""

import json

import jax
import numpy as np
import pytest
import torch

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.blockmatrix import BlockMatrix as JBlockMatrix
from matrel_tpu.core.coo import COOMatrix as JCOO
from matrel_tpu.ops import kernel_registry as jkr
from matrel_tpu.parallel import autotune as jat
from matrel_tpu.parallel import planner as jplanner
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch import MatrelConfig, MatrelSession, convert
from matrel_tpu_torch import executor as texec
from matrel_tpu_torch.core import mesh as tmesh_lib
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.ir import stats as tstats
from matrel_tpu_torch.ops import kernel_registry as tkr
from matrel_tpu_torch.ops import pallas_spmv as tpc
from matrel_tpu_torch.ops import spmv as tspmv
from matrel_tpu_torch.parallel import autotune as tat
from matrel_tpu_torch.parallel import planner as tplanner


@pytest.fixture(autouse=True)
def _port_table_tmp(tmp_path, monkeypatch):
    """Keep the port's default table out of the repo root, and start
    every test with empty in-process caches in both packages."""
    monkeypatch.setattr(tat, "_DEFAULT_TABLE",
                        str(tmp_path / "port_autotune.json"))
    tat.clear_caches()
    for c in (jat._CACHE, jat._SPMV_CACHE, jat._SPGEMM_CACHE,
              jat._TABLE_CACHE):
        c.clear()
    yield
    tat.clear_caches()


@pytest.fixture(scope="module")
def tmesh():
    return tmesh_lib.make_mesh((2, 4), device="cpu")


@pytest.fixture(scope="module")
def tmesh1():
    return tmesh_lib.make_mesh(device="cpu")


@pytest.fixture(scope="module")
def jmesh1():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


# -- keys and the table ----------------------------------------------------------

WEIGHTS = ((1.0, 1.0), (1.0, 8.0))


def swap_backend(key: str, field: int, backend: str) -> str:
    parts = key.split("|")
    parts[field] = backend
    return "|".join(parts)


@pytest.mark.parametrize("weights", WEIGHTS)
def test_matmul_keys_equal_jax_but_the_backend(weights):
    want = jat._table_key(4096, 2, 4, "float32", weights)
    assert tat._table_key(4096, 2, 4, "float32", "cpu", weights) == want
    assert tat._table_key(4096, 2, 4, "float32", "cuda", weights) == \
        swap_backend(want, 3, "cuda")


@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("side,structure,bs", ((1000, "row_band", 16),
                                               (32768, "generic", 512)))
def test_spgemm_keys_equal_jax_but_the_backend(weights, side, structure,
                                               bs):
    assert tat._spgemm_side_class(side) == jat._spgemm_side_class(side)
    want = jat._spgemm_key(side, structure, bs, 2, 4, weights)
    assert tat._spgemm_key(side, structure, bs, 2, 4, "cpu",
                           weights) == want
    assert tat._spgemm_key(side, structure, bs, 2, 4, "cuda",
                           weights) == swap_backend(want, 5, "cuda")


@pytest.mark.parametrize("weights", WEIGHTS)
def test_spmv_keys_equal_jax_but_the_backend(weights):
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, 3000, 20_000), rng.integers(0, 2000, 20_000)
    from matrel_tpu.ops import spmv as jspmv
    jp = jspmv.build_spmv_plan(rows, cols, n_rows=3000, n_cols=2000)
    tp = tspmv.build_spmv_plan(rows, cols, n_rows=3000, n_cols=2000)
    want = jat._spmv_key(jp, 2, 4, weights)
    assert tat._spmv_key(tp, 2, 4, "cpu", weights) == want
    assert tat._spmv_key(tp, 2, 4, "cuda", weights) == \
        swap_backend(want, 1, "cuda")


def mixed_table(backend_rows=("tpu", "cpu", "cuda")) -> dict:
    """One JSON holding every key family, current and stale."""
    t = {}
    for b in backend_rows:
        t[f"4096|2x4|float32|{b}"] = {"best": "cpmm", "times": {"cpmm": 1}}
        t[f"4096|2x4|float32|{b}|w1x8"] = {"best": None,
                                           "times": {"rmm": 1}}
        t[f"spmv|{b}|100x100|nb1|cap128|blk512|1x1"] = {
            "best": "compact", "times": {"compact": 1, "expanded": 2}}
        t[f"spgemm|<=1024|row_band|bs16|2x4|{b}"] = {
            "best": "xla_gather", "times": {"xla_gather": 1}}
        t[f"reshard|2d>row|4096|2x4|{b}"] = {"best": "staged",
                                             "times": {"staged": 1}}
        t[f"fuse|ew.add|<=1024|2x4|{b}"] = {"best": "fused",
                                            "times": {"fused": 1}}
        t[f"ivm|rank_k|1024|2x4|{b}"] = {"best": "patch",
                                         "times": {"patch": 1}}
    # stale: no backend field, retired taxonomies, garbage
    t["4096|2x4|float32"] = {"best": "cpmm", "times": {"cpmm": 1}}
    t["spmv|100x100|nb1|cap128|blk512|1x1"] = {"best": None, "times": {}}
    t["spgemm|<=1024|banded|bs16|2x4|cpu"] = {"best": "x", "times": {}}
    t["ivm|rank_7|1024|2x4|cpu"] = {"best": "patch", "times": {}}
    t["4096|2x4|float32|cpu|x1"] = {"best": "cpmm", "times": {}}
    return t


def test_load_table_prunes_as_jax_does(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(mixed_table()))
    got = tat.load_table(str(path))
    assert got == jat.load_table(str(path))
    assert len(got) == 21                # 7 families x 3 backends
    assert not any(k.startswith("spgemm|<=1024|banded") for k in got)


@pytest.mark.parametrize("content", ("{not json", "[1, 2]", ""))
def test_corrupt_or_odd_table_reads_empty(tmp_path, content):
    path = tmp_path / "t.json"
    path.write_text(content)
    assert tat.load_table(str(path)) == jat.load_table(str(path)) == {}
    assert tat.load_table(str(tmp_path / "absent.json")) == {}


def test_persist_keeps_every_row_it_did_not_write(tmp_path):
    path = tmp_path / "t.json"
    table = mixed_table()
    path.write_text(json.dumps(table))
    key = tat._spgemm_key(8192, "generic", 512, 1, 1, "cuda")
    tat._persist(str(path), key, "pallas_generic",
                 {"pallas_generic": 1e-3, "xla_gather": 5e-3})
    after = json.loads(path.read_text())
    want = jat.load_table(str(tmp_path / "unused.json"))   # {}
    want.update({k: v for k, v in table.items()
                 if jat._current_key_format(k)})
    want[key] = {"best": "pallas_generic",
                 "times": {"pallas_generic": 1e-3, "xla_gather": 5e-3}}
    assert after == want
    # and the JAX package reads the port's row as it reads its own
    assert jat.load_table(str(path))[key]["best"] == "pallas_generic"
    assert not list(tmp_path.glob("*.lock"))


def test_persist_skips_on_a_fresh_lock(tmp_path):
    path = tmp_path / "t.json"
    (tmp_path / "t.json.lock").write_text("")
    tat._persist(str(path), "1|1x1|float32|cpu", "xla", {"xla": 1.0})
    assert not path.exists()


def test_pick_winner_tie_rule():
    for pick in (tat._pick_winner, jat._pick_winner):
        assert pick({"rmm": 1.0, "cpmm": 1.2}) == "rmm"
        assert pick({"rmm": 1.0, "cpmm": 1.05}) is None
        assert pick({}) is None
        assert pick({"xla": 0.5}) is None
    assert tat.TIE_REL == jat.TIE_REL


# -- the matmul family -------------------------------------------------------


FAKE_TIMES = {"bmm_left": 5.0, "bmm_right": 4.0, "cpmm": 1.0, "rmm": 2.0,
              "summa": 3.0, "xla": 6.0}


def test_matmul_persist_and_replay(tmesh, mesh8, tmp_path, monkeypatch):
    monkeypatch.setattr(tat, "measure_strategy",
                        lambda s, A, B, cfg, **kw: FAKE_TIMES[s])
    monkeypatch.setattr(jat, "measure_strategy",
                        lambda s, A, B, cfg, **kw: FAKE_TIMES[s])
    path = str(tmp_path / "tuned.json")
    cfg = MatrelConfig(autotune=True, autotune_table_path=path)
    best = tat.lookup_or_measure(64, 64, 64, tmesh, "float32", cfg)
    jpath = str(tmp_path / "jtuned.json")
    jbest = jat.lookup_or_measure(
        64, 64, 64, mesh8, "float32",
        JConfig(autotune=True, autotune_table_path=jpath))
    assert best == jbest == "cpmm"
    key = tat._table_key(64, 2, 4, "float32", "cpu")
    assert tat.load_table(path) == jat.load_table(jpath)
    assert tat.load_table(path)[key]["best"] == best
    # a fresh process reads the file and measures nothing
    tat.clear_caches()
    monkeypatch.setattr(tat, "measure_strategy", lambda *a, **k: 1 / 0)
    assert tat.lookup_or_measure(64, 64, 64, tmesh, "float32", cfg) == best


def test_matmul_one_off_measurement_writes_no_file(tmesh, tmp_path,
                                                   monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(tat, "measure_strategy",
                        lambda s, A, B, cfg, **kw: FAKE_TIMES[s])
    best, times = tat.autotune_matmul(64, 64, 64, mesh=tmesh)
    assert best == "cpmm" and set(times) == set(FAKE_TIMES) - {"summa"}
    assert not list(tmp_path.iterdir())
    assert not (tmp_path / "port_autotune.json").exists()


def test_matmul_measures_for_real_on_the_cpu(tmesh):
    """Real marginal timings on a loaded host: which strategies survive
    the noise filter varies, so only their set and the cache are held."""
    best, times = tat.autotune_matmul(32, 32, 32, mesh=tmesh)
    assert best is None or best in times
    assert times and set(times) <= {"bmm_left", "bmm_right", "cpmm",
                                    "rmm", "xla"}   # no summa on 2 x 4
    assert all(t > 0 for t in times.values())
    assert tat.autotune_matmul(32, 32, 32, mesh=tmesh) == (best, times)


def test_empty_persisted_entry_remeasures(tmesh, tmp_path, monkeypatch):
    path = str(tmp_path / "tuned.json")
    key = tat._table_key(64, 2, 4, "float32", "cpu")
    json.dump({key: {"best": None, "times": {}}}, open(path, "w"))
    cfg = MatrelConfig(autotune=True, autotune_table_path=path)
    called = {}

    def fake(s, A, B, c, **kw):
        called[s] = True
        return {"cpmm": 1.0}.get(s, 2.0)

    monkeypatch.setattr(tat, "measure_strategy", fake)
    assert tat.lookup_or_measure(64, 64, 64, tmesh, "float32", cfg) == "cpmm"
    assert called and tat.load_table(path)[key]["times"]


def test_rectangular_and_oversize_shapes_are_not_measured(tmesh,
                                                          monkeypatch):
    monkeypatch.setattr(tat, "measure_strategy", lambda *a, **k: 1 / 0)
    cfg = MatrelConfig(autotune=True, autotune_max_dim=128)
    assert tat.lookup_or_measure(64, 8192, 64, tmesh, "float32", cfg) is None
    assert tat.lookup_or_measure(256, 256, 256, tmesh, "float32",
                                 cfg) is None


def dense_pair(jmesh, tmesh, n=64, k=64, m=64, seed=7):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((n, k)).astype(np.float32)
    b = rng.standard_normal((k, m)).astype(np.float32)
    je = JBlockMatrix.from_numpy(a, mesh=jmesh).expr().multiply(
        JBlockMatrix.from_numpy(b, mesh=jmesh).expr())
    te = BlockMatrix.from_numpy(a, mesh=tmesh).expr().multiply(
        BlockMatrix.from_numpy(b, mesh=tmesh).expr())
    return je, te


@pytest.mark.parametrize("forced", ("rmm", "cpmm", "summa", "bmm_left",
                                    "bmm_right", None))
@pytest.mark.parametrize("root_output", (False, True))
def test_choose_strategy_ex_matches_jax(mesh8, tmesh, tmp_path, forced,
                                        root_output, monkeypatch):
    """With a forced row the measured winner applies where it is
    admissible and not a 1D winner at a root; without one, a measured tie
    leaves the model's pick (source "model")."""
    je, te = dense_pair(mesh8, tmesh)
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    if forced is not None:
        json.dump({jat._table_key(64, 2, 4, "float32"): {
            "best": forced, "times": {forced: 1e-6}}}, open(jpath, "w"))
        json.dump({tat._table_key(64, 2, 4, "float32", "cpu"): {
            "best": forced, "times": {forced: 1e-6}}}, open(tpath, "w"))
    else:
        tie = lambda s, *a, **k: 1.0            # noqa: E731
        monkeypatch.setattr(jat, "measure_strategy", tie)
        monkeypatch.setattr(tat, "measure_strategy", tie)
    want = jplanner.choose_strategy_ex(
        je, mesh8, JConfig(autotune=True, autotune_table_path=jpath),
        root_output=root_output)
    got = tplanner.choose_strategy_ex(
        te, tmesh, MatrelConfig(autotune=True, autotune_table_path=tpath),
        root_output=root_output)
    assert got == tuple(want)
    if forced in ("rmm", "cpmm"):
        assert got == (forced, "measured")


def test_one_card_never_consults_the_matmul_table(tmesh1, monkeypatch):
    monkeypatch.setattr(tat, "lookup_or_measure", lambda *a, **k: 1 / 0)
    rng = np.random.default_rng(1)
    A = BlockMatrix.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32), mesh=tmesh1)
    e = A.expr().multiply(A.expr())
    assert tplanner.choose_strategy_ex(
        e, tmesh1, MatrelConfig(autotune=True)) == ("xla", "default")


def test_interior_chain_multiply_consults_the_table(mesh8, tmesh, tmp_path):
    rng = np.random.default_rng(3)
    mats = [rng.standard_normal((64, 64)).astype(np.float32)
            for _ in range(3)]
    jA, jB, jC = (JBlockMatrix.from_numpy(m, mesh=mesh8).expr()
                  for m in mats)
    tA, tB, tC = (BlockMatrix.from_numpy(m, mesh=tmesh).expr()
                  for m in mats)
    base = tplanner.choose_strategy_ex(tA.multiply(tB.multiply(tC)), tmesh,
                                       MatrelConfig())[0]
    forced = "rmm" if base != "rmm" else "cpmm"
    jpath, tpath = str(tmp_path / "j.json"), str(tmp_path / "t.json")
    json.dump({jat._table_key(64, 2, 4, "float32"): {
        "best": forced, "times": {forced: 1e-6}}}, open(jpath, "w"))
    json.dump({tat._table_key(64, 2, 4, "float32", "cpu"): {
        "best": forced, "times": {forced: 1e-6}}}, open(tpath, "w"))
    jann = jplanner.annotate_strategies(
        jA.multiply(jB.multiply(jC)), mesh8,
        JConfig(autotune=True, autotune_table_path=jpath))
    tann = tplanner.annotate_strategies(
        tA.multiply(tB.multiply(tC)), tmesh,
        MatrelConfig(autotune=True, autotune_table_path=tpath))
    for j, t in ((jann, tann), (jann.children[1], tann.children[1])):
        assert (t.attrs["strategy"], t.attrs["strategy_source"]) == (
            j.attrs["strategy"], j.attrs["strategy_source"]) == (
            forced, "measured")


def stamp_walk(e) -> list:
    out = [(e.kind, e.attrs.get("strategy"), e.attrs.get("strategy_source"))]
    for c in e.children:
        out += stamp_walk(c)
    return out


@pytest.mark.parametrize("query", ("dense_chain", "coo_matvec",
                                   "coo_rmatvec"))
def test_layout_stamps_with_autotune_equal_jax(mesh8, tmesh, query):
    """autotune=True with nothing measured (autotune_max_dim 1): the
    stamps and the inferred layouts equal the JAX package's on the
    (2, 4) grid, the COO dispatch's among them."""
    rng = np.random.default_rng(11)
    jcfg = JConfig(autotune=True, autotune_max_dim=1)
    tcfg = MatrelConfig(autotune=True, autotune_max_dim=1)
    if query == "dense_chain":
        mats = [rng.standard_normal(s).astype(np.float32)
                for s in ((64, 32), (32, 64), (64, 16))]
        j = [JBlockMatrix.from_numpy(m, mesh=mesh8).expr() for m in mats]
        t = [BlockMatrix.from_numpy(m, mesh=tmesh).expr() for m in mats]
        je = j[0].multiply(j[1]).multiply(j[2])
        te = t[0].multiply(t[1]).multiply(t[2])
    else:
        rows, cols = rng.integers(0, 96, 600), rng.integers(0, 80, 600)
        vals = rng.standard_normal(600).astype(np.float32)
        A = JCOO.from_edges(rows, cols, vals, shape=(96, 80))
        tA = convert.from_reference(A, None)
        if query == "coo_matvec":
            x = rng.standard_normal((80, 1)).astype(np.float32)
            je = A.multiply(JBlockMatrix.from_numpy(x, mesh=mesh8).expr())
            te = tA.multiply(BlockMatrix.from_numpy(x, mesh=tmesh).expr())
        else:
            x = rng.standard_normal((1, 96)).astype(np.float32)
            je = JBlockMatrix.from_numpy(x, mesh=mesh8).expr().multiply(A)
            te = BlockMatrix.from_numpy(x, mesh=tmesh).expr().multiply(tA)
    jann = jplanner.annotate_strategies(je, mesh8, jcfg)
    tann = tplanner.annotate_strategies(te, tmesh, tcfg)
    assert stamp_walk(tann) == stamp_walk(jann)
    assert tplanner.infer_layout(tann, tmesh, None, tcfg) == \
        jplanner.infer_layout(jann, mesh8, None, jcfg)


# -- the SpGEMM family ---------------------------------------------------------


def band_pair(mesh, seeds, n=64, bs=16):
    return (tkr.synthesize_structure("row_band", n, bs, mesh, seed=seeds[0]),
            tkr.synthesize_structure("row_band", n, bs, mesh, seed=seeds[1]))


@pytest.mark.parametrize("side", (1024, 2048))
def test_select_kernel_returns_measured_on_a_table_hit(mesh8, tmesh,
                                                       tmp_path, side):
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    times = {"xla_gather": 0.001, "pallas_band": 0.005}
    jpath.write_text(json.dumps({jat._spgemm_key(side, "row_band", 16, 2,
                                                 4): {
        "best": "xla_gather", "times": times}}))
    tpath.write_text(json.dumps({tat._spgemm_key(
        side, "row_band", 16, 2, 4, "cpu"): {"best": "xla_gather",
                                             "times": times}}))
    # 1024: the 2048² pair below has no row and is not measured
    jcfg = JConfig(pallas_interpret=True, autotune=True,
                   autotune_table_path=str(jpath), autotune_max_dim=side)
    tcfg = MatrelConfig(autotune=True, autotune_table_path=str(tpath),
                        autotune_max_dim=side)
    want = jkr.select_kernel("row_band", 16, 10, jcfg, side=side,
                             mesh=mesh8)
    got = tkr.select_kernel("row_band", 16, 10, tcfg, side=side, mesh=tmesh)
    assert got == tuple(want) == ("xla_gather", "measured")
    # no mesh or no side: the model decides, as in the JAX package
    assert tkr.select_kernel("row_band", 16, 10, tcfg) == ("pallas_band",
                                                          "model")
    # the planner's stamp and the decision record carry it end to end
    A, B = band_pair(tmesh, (15, 16), n=2048)
    e = A.expr().multiply(B.expr())
    ann = tplanner.annotate_strategies(e, tmesh, tcfg)
    src = "measured" if side == 2048 else "model"
    assert (ann.attrs["spgemm_kernel"], ann.attrs["spgemm_kernel_source"]) \
        == ("xla_gather" if side == 2048 else "pallas_band", src)
    rec = tplanner.matmul_decisions(ann, tmesh, tcfg)[0]
    assert rec["est_vs_measured"] == ("measured" if side == 2048
                                      else "estimate")
    # and the lowering runs the stamped kernel to the same answer
    got = texec.compile_expr(e, tmesh, tcfg).run().to_numpy()
    np.testing.assert_allclose(got, A.to_numpy() @ B.to_numpy(), rtol=1e-4,
                               atol=1e-3)


def test_override_beats_a_measured_winner(tmesh, tmp_path):
    tpath = tmp_path / "t.json"
    tpath.write_text(json.dumps({tat._spgemm_key(
        1024, "row_band", 16, 2, 4, "cpu"): {
            "best": "xla_gather",
            "times": {"xla_gather": 1e-3, "pallas_band": 5e-3}}}))
    cfg = MatrelConfig(autotune=True, autotune_table_path=str(tpath),
                       spgemm_kernel_override="pallas_generic")
    assert tkr.select_kernel("row_band", 16, 10, cfg, side=1024,
                             mesh=tmesh) == ("pallas_generic", "override")


@pytest.mark.parametrize("structure", tstats.STRUCTURE_CLASSES)
def test_spgemm_measure_persist_and_replay(tmesh, tmp_path, structure,
                                           monkeypatch):
    path = tmp_path / "table.json"
    cfg = MatrelConfig(autotune=True, autotune_table_path=str(path),
                       autotune_max_dim=512)
    best = tat.lookup_or_measure_spgemm(256, structure, 16, tmesh, cfg)
    want = set(tat.spgemm_candidates(structure, 16, cfg))
    assert want == {"xla_gather", "pallas_generic"} | {
        kid for kid, spec in tkr.REGISTRY.items()
        if structure in spec.structures}
    table = tat.load_table(str(path))
    assert len(table) == 1
    entry = next(iter(table.values()))
    assert set(entry["times"]) == want
    assert entry["best"] == best
    tat.clear_caches()
    measured = []
    orig = tat.measure_spgemm_kernel
    monkeypatch.setattr(tat, "measure_spgemm_kernel",
                        lambda *a, **k: measured.append(1) or orig(*a, **k))
    assert tat.lookup_or_measure_spgemm(256, structure, 16, tmesh,
                                        cfg) == best
    assert not measured


def test_spgemm_candidates_equal_jax(tmesh):
    jcfg = JConfig(pallas_interpret=True)
    for structure in tstats.STRUCTURE_CLASSES:
        for bs in (8, 16, 512):
            want = [kid for kid in jkr.kernel_ids()
                    if (jkr.get_kernel(kid).universal
                        or structure in jkr.get_kernel(kid).structures)
                    and jkr.admissible(kid, bs, 1, jcfg)]
            assert tat.spgemm_candidates(structure, bs) == want


def test_spgemm_oversize_sides_never_measured_inline(mesh8, tmesh,
                                                     monkeypatch):
    monkeypatch.setattr(tkr, "synthesize_structure", lambda *a, **k: 1 / 0)
    cfg = MatrelConfig(autotune=True, autotune_max_dim=512)
    assert tat.lookup_or_measure_spgemm(100_000, "row_band", 512, tmesh,
                                        cfg) is None
    jcfg = JConfig(pallas_interpret=True, autotune=True,
                   autotune_max_dim=512)
    assert jat.lookup_or_measure_spgemm(100_000, "row_band", 512, mesh8,
                                        jcfg) is None


def test_a_failing_candidate_drops_out_and_is_logged(tmesh, tmp_path,
                                                     monkeypatch, caplog):
    def fake(kid, A, B, cfg, n_times=5):
        if kid == "pallas_cluster":
            raise RuntimeError("launch failed")
        return {"xla_gather": 3.0, "pallas_generic": 1.0}[kid]

    monkeypatch.setattr(tat, "measure_spgemm_kernel", fake)
    cfg = MatrelConfig(autotune=True,
                       autotune_table_path=str(tmp_path / "t.json"))
    with caplog.at_level("WARNING", logger="matrel_tpu_torch.autotune"):
        best = tat.lookup_or_measure_spgemm(256, "clustered_tile", 16,
                                            tmesh, cfg)
    assert best == "pallas_generic"
    assert "pallas_cluster dropped" in caplog.text
    assert "launch failed" in caplog.text


# -- the SpMV family and the executor ------------------------------------------


def coo_pair(seed=0, n_r=3000, n_c=2000, m=20_000):
    rng = np.random.default_rng(seed)
    rows, cols = rng.integers(0, n_r, m), rng.integers(0, n_c, m)
    vals = rng.standard_normal(m).astype(np.float32)
    A = JCOO.from_edges(rows, cols, vals, shape=(n_r, n_c))
    return rng, A, convert.from_reference(A, None)


def test_spmv_measures_both_variants_and_restores_the_caches(tmesh1,
                                                             tmp_path):
    _, _, tA = coo_pair()
    plan = tA._get_plan()
    cfg = MatrelConfig(autotune=True,
                       autotune_table_path=str(tmp_path / "t.json"))
    best = tat.lookup_or_measure_spmv(plan, tmesh1, cfg)
    entry = tat.load_table(str(tmp_path / "t.json"))[
        tat._spmv_key(plan, 1, 1, "cpu")]
    assert set(entry["times"]) == {"compact", "expanded"}
    assert entry["best"] == best
    # the expanded probe's one-hot tables are not left on the plan
    assert plan._tables == {} and plan._spmm_tables == {}


def test_spmv_persist_and_replay(tmesh1, tmp_path, monkeypatch):
    _, _, tA = coo_pair(1)
    plan = tA._get_plan()
    monkeypatch.setattr(tat, "measure_spmv_variant",
                        lambda v, p, m, c, **k: {"compact": 2.0,
                                                 "expanded": 1.0}[v])
    cfg = MatrelConfig(autotune=True,
                       autotune_table_path=str(tmp_path / "t.json"))
    assert tat.lookup_or_measure_spmv(plan, tmesh1, cfg) == "expanded"
    tat.clear_caches()
    monkeypatch.setattr(tat, "measure_spmv_variant", lambda *a, **k: 1 / 0)
    assert tat.lookup_or_measure_spmv(plan, tmesh1, cfg) == "expanded"


@pytest.mark.parametrize("use_pallas", (True, False))
def test_spmv_one_variant_is_neither_winner_nor_row(tmesh1, tmp_path,
                                                    monkeypatch, use_pallas):
    """Over the expanded budget (or without the kernels) only one variant
    is admissible: no winner, nothing written."""
    _, _, tA = coo_pair(2)
    plan = tA._get_plan()
    nb, cap = plan.src8.shape
    if use_pallas:
        monkeypatch.setattr(tat, "SPMV_EXPANDED_BUDGET_BYTES",
                            nb * cap * 224 - 1)
    monkeypatch.setattr(tat, "measure_spmv_variant",
                        lambda v, p, m, c, **k: 1.0)
    path = tmp_path / "t.json"
    cfg = MatrelConfig(autotune=True, autotune_table_path=str(path),
                       use_pallas=use_pallas)
    assert tat.lookup_or_measure_spmv(plan, tmesh1, cfg) is None
    assert not path.exists()
    assert tat._spmv_admissible("expanded", plan, cfg) is not use_pallas
    assert tat._spmv_admissible("compact", plan, cfg) is use_pallas


@pytest.mark.parametrize("forced", ("compact", "expanded", "recycled"))
def test_executor_obeys_a_forced_spmv_variant(tmesh1, forced, monkeypatch):
    rng, A, tA = coo_pair(3)
    plan = tA._get_plan()
    x = torch.as_tensor(rng.standard_normal((2000, 1)).astype(np.float32))
    low = texec.Lowerer(tmesh1, MatrelConfig())
    if forced == "recycled":        # an id whose stored plan is another
        other = tspmv.build_spmv_plan([0], [0], n_rows=4, n_cols=4)
        low.spmv_choice = {id(plan): (other, "expanded")}
    else:
        low.spmv_choice = {id(plan): (plan, forced)}
    ran = []
    for mod, name in ((tpc, "compact_apply"), (tspmv, "spmv_apply")):
        orig = getattr(mod, name)
        monkeypatch.setattr(mod, name, lambda *a, _o=orig, _n=name, **k:
                            ran.append(_n) or _o(*a, **k))
    y = low._coo_spmv_stack(plan, x)
    assert ran == (["spmv_apply"] if forced == "expanded"
                   else ["compact_apply"])
    want = tpc.compact_apply(plan, x[:, 0])
    assert float((y[:, 0] - want).abs().max()) <= 1e-5 * float(
        want.abs().max())


@pytest.mark.parametrize("winner", ("compact", "expanded"))
@pytest.mark.parametrize("batch", (False, True))
def test_compute_obeys_the_shared_tables_spmv_row(jmesh1, tmp_path, winner,
                                                  batch):
    """One table file: the JAX package's spmv row (its backend "cpu")
    is the port's key for the same plan, and both executors obey it —
    through compute and through run_many's MultiPlan."""
    rng, A, tA = coo_pair(4)
    x = rng.standard_normal((2000, 1)).astype(np.float32)
    path = str(tmp_path / "shared.json")
    key = jat._spmv_key(A._get_plan(), 1, 1)
    json.dump({key: {"best": winner, "times": {"compact": 1.0,
                                                "expanded": 1.0}}},
              open(path, "w"))
    ts = MatrelSession(config=MatrelConfig(autotune=True,
                                           autotune_table_path=path),
                       device="cpu")
    js = JSession(mesh=jmesh1, config=JConfig(
        pallas_interpret=True, autotune=True, autotune_table_path=path))
    je = A.multiply(js.from_numpy(x))
    te = tA.multiply(ts.from_numpy(x))
    plan = tA._get_plan()
    assert tat._spmv_key(plan, 1, 1, "cpu") == key
    opt = tplanner.annotate_strategies(te, ts.mesh, ts.config)
    choices = texec._autotune_spmv_choices((opt,), ts.mesh, ts.config)
    assert choices == {id(plan): (plan, winner)}
    got = (ts.run_many([te])[0] if batch else ts.compute(te)).to_numpy()
    want = js.compute(je).to_numpy()
    default = MatrelSession(device="cpu").compute(
        tA.multiply(MatrelSession(device="cpu").from_numpy(x))).to_numpy()
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-5 * scale
    assert float(np.abs(got - default).max()) <= 1e-5 * scale
