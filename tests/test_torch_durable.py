"""PyTorch port: the durable half of serving held against the JAX package
on the CPU — ``tests/test_durable.py``'s cases as paired comparisons.

Each scenario runs once per package on the same seeded numpy arrays (the
JAX package on its (2, 4) CPU mesh, the port on the virtual (2, 4) grid,
``device="cpu"``), each with its own ``state_dir``, and returns a record
of what it observed: the spill hierarchy's counters, the restore
summaries, the MV117 diagnostics. The two records must be equal, and each
must satisfy the JAX test's own assertions. Answers are checked against
float64-free numpy oracles at the JAX test's tolerances (exactly for the
integer case).

Covered: the ``result_nbytes`` fallbacks, the host and disk tiers and the
expected-reuse gate, rebind kills across every tier, the structural zero
of the default config, warm restart, the sha1 miss, the corrupt-snapshot
cold start, MQO template seeding, the fleet directory's demand hints
(both packages' directories, and a fleet session's export and seed
through ``save_state`` / ``restore``), MV117 and the knobs' validation.
Added for the port: a bfloat16 result through the disk tier and a warm
restart, bit-equal.
"""

import logging
import os
import types

import numpy as np
import pytest
import torch

from matrel_tpu.analysis import spill_pass as j_spill_pass
from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
from matrel_tpu.ir import expr as JE
from matrel_tpu.parallel import reshard as j_reshard
from matrel_tpu.serve import fleet as j_fleet
from matrel_tpu.serve import mqo as j_mqo
from matrel_tpu.serve import result_cache as j_rc
from matrel_tpu.serve import spill as j_spill
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch.analysis import spill_pass as t_spill_pass
from matrel_tpu_torch.config import MatrelConfig as TConfig
from matrel_tpu_torch.core.blockmatrix import BlockMatrix as TBM
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.ir import expr as TE
from matrel_tpu_torch.parallel import reshard as t_reshard
from matrel_tpu_torch.resilience.errors import (CheckpointCorruption,
                                                SnapshotCorruption)
from matrel_tpu_torch.serve import fleet as t_fleet
from matrel_tpu_torch.serve import mqo as t_mqo
from matrel_tpu_torch.serve import result_cache as t_rc
from matrel_tpu_torch.serve import spill as t_spill
from matrel_tpu_torch.session import MatrelSession as TSession

N = 64
ENTRY = N * N * 4               # one 64x64 f32 gram result's device bytes


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh((2, 4), device="cpu")


class Pkg:
    """One package's face: session, config, matrix class, state dir."""

    def __init__(self, name, sess_cls, cfg_cls, bm_cls, mesh, root):
        self.name = name
        self.Session = sess_cls
        self.Config = cfg_cls
        self.BM = bm_cls
        self.mesh = mesh
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)

    def cfg(self, **over):
        cfg = dict(spill_enable=True,
                   result_cache_max_bytes=int(1.5 * ENTRY),
                   result_cache_max_entries=8,
                   spill_host_max_bytes=8 * ENTRY,
                   spill_disk_hits=0,
                   state_dir=self.root)
        cfg.update(over)
        return self.Config(**cfg)

    def session(self, **over):
        return self.Session(mesh=self.mesh, config=self.cfg(**over))


@pytest.fixture()
def pkgs(mesh8, tmesh8, tmp_path):
    return (Pkg("jax", JSession, JConfig, JBM, mesh8, tmp_path / "jax"),
            Pkg("torch", TSession, TConfig, TBM, tmesh8,
                tmp_path / "torch"))


def both(pkgs, scenario, *args):
    """Run ``scenario(pkg, *args)`` in both packages; the records must
    be equal. Returns the (shared) record."""
    rj = scenario(pkgs[0], *args)
    rt = scenario(pkgs[1], *args)
    assert rj == rt, (rj, rt)
    return rt


def arrays(names, seed=0, integral=False):
    rng = np.random.default_rng(seed)
    out = {}
    for nm in names:
        if integral:
            out[nm] = rng.integers(-4, 5, size=(N, N)).astype(np.float32)
        else:
            out[nm] = rng.standard_normal((N, N)).astype(np.float32)
    return out


def register(sess, arrs):
    for nm, a in arrs.items():
        sess.register(nm, sess.from_numpy(a))


def gram(m):
    return m.expr().t().multiply(m.expr())


def check(sess, arrs, name, exact=False):
    a = arrs[name]
    got = sess.run(gram(sess.catalog[name])).to_numpy()
    if exact:
        assert np.array_equal(got, a.T @ a)
    else:
        np.testing.assert_allclose(got, a.T @ a, rtol=1e-5, atol=1e-4)


def spill_info(sess):
    return sess.result_cache_info()["spill"]


# ---------------------------------------------------------------------------
# result_nbytes must never silently size an entry as 0
# ---------------------------------------------------------------------------


class TestResultNbytes:

    def _both(self, bm):
        j_rc._NBYTES_WARNED[0] = True
        t_rc._NBYTES_WARNED[0] = True
        got = (j_rc.result_nbytes(bm), t_rc.result_nbytes(bm))
        assert got[0] == got[1]
        return got[1]

    def test_foreign_array_falls_back_to_shape_estimate(self, caplog):
        bm = types.SimpleNamespace(data=object(), shape=(64, 16))
        for mod, logger in ((j_rc, "matrel_tpu.serve"),
                            (t_rc, "matrel_tpu_torch.serve")):
            mod._NBYTES_WARNED[0] = False
            caplog.clear()
            with caplog.at_level(logging.WARNING, logger):
                assert mod.result_nbytes(bm) == 64 * 16 * 4
            assert any("result_nbytes" in r.message
                       for r in caplog.records)

    def test_warns_once_per_process(self, caplog):
        bm = types.SimpleNamespace(data=object(), shape=(8, 8))
        for mod, logger in ((j_rc, "matrel_tpu.serve"),
                            (t_rc, "matrel_tpu_torch.serve")):
            mod._NBYTES_WARNED[0] = False
            with caplog.at_level(logging.WARNING, logger):
                mod.result_nbytes(bm)
                caplog.clear()
                assert mod.result_nbytes(bm) == 8 * 8 * 4
            assert not any("result_nbytes" in r.message
                           for r in caplog.records)

    def test_dtype_survives_when_only_shape_is_missing(self):
        for dt in (np.dtype("float64"), torch.float64):
            data = types.SimpleNamespace(dtype=dt)
            bm = types.SimpleNamespace(data=data, shape=(8, 8))
            j_rc._NBYTES_WARNED[0] = True
            t_rc._NBYTES_WARNED[0] = True
            assert t_rc.result_nbytes(bm) == 8 * 8 * 8
        assert self._both(types.SimpleNamespace(
            data=types.SimpleNamespace(dtype=np.dtype("float64")),
            shape=(8, 8))) == 8 * 8 * 8

    def test_real_blockmatrix_uses_padded_array(self, mesh8, tmesh8):
        a = np.random.default_rng(1).standard_normal(
            (N - 3, N)).astype(np.float32)
        jb = JBM.from_numpy(a, mesh=mesh8)
        tb = TBM.from_numpy(a, mesh=tmesh8)
        assert j_rc.result_nbytes(jb) == t_rc.result_nbytes(tb) == int(
            np.prod(tb.data.shape)) * 4
        bf = TBM.from_numpy(a, mesh=tmesh8, dtype="bfloat16")
        assert t_rc.result_nbytes(bf) == int(np.prod(bf.data.shape)) * 2

    def test_not_a_blockmatrix_at_all_is_zero(self):
        assert self._both(types.SimpleNamespace(data=object(),
                                                shape=None)) == 0


# ---------------------------------------------------------------------------
# tier round-trips, demotion order, the expected-reuse gate
# ---------------------------------------------------------------------------


def _host_round_trip(pkg):
    sess = pkg.session()
    arrs = arrays(["a", "b"])
    register(sess, arrs)
    check(sess, arrs, "a")
    check(sess, arrs, "b")               # evicts a -> host tier
    first = dict(spill_info(sess))
    assert first["demoted_host"] >= 1 and first["host_entries"] >= 1
    check(sess, arrs, "a")               # promote, not recompute
    after = dict(spill_info(sess))
    assert after["promoted"] >= 1
    return first, after


def _disk_round_trip(pkg):
    sess = pkg.session(spill_host_max_bytes=1)
    arrs = arrays(["a", "b"])
    register(sess, arrs)
    check(sess, arrs, "a")
    check(sess, arrs, "b")               # a: device -> host -> disk
    first = dict(spill_info(sess))
    assert first["demoted_disk"] == 1 and first["disk_entries"] == 1
    files = os.listdir(os.path.join(pkg.root, "spill"))
    assert [f for f in files if f.endswith(".npy")]
    check(sess, arrs, "a")               # disk_read + h2d thaw
    after = dict(spill_info(sess))
    assert after["promoted"] == 1 and after["corrupt"] == 0
    assert after["demoted_disk"] == 2 and after["disk_entries"] == 1
    return first, after


def _lru_pressure(pkg):
    sess = pkg.session(spill_host_max_bytes=int(1.5 * ENTRY))
    events = []
    sess._spill.emit = events.append
    arrs = arrays(["a", "b", "c"])
    register(sess, arrs)
    for nm in ("a", "b", "c"):
        check(sess, arrs, nm)
    sp = dict(spill_info(sess))
    assert sp["disk_entries"] == 1 and sp["host_entries"] == 1
    check(sess, arrs, "a")
    check(sess, arrs, "b")
    tiers = [e["tier"] for e in events if e["op"] == "promote"]
    assert len(tiers) == 2 and tiers[0] == "disk"
    legs = []
    for e in events:
        for leg in e["legs"]:
            assert leg["leg"] in ("d2h", "h2d", "disk_write",
                                  "disk_read")
            assert leg["bytes"] > 0 and leg["ms"] >= 0
            legs.append((e["op"], e["tier"], leg["leg"], leg["bytes"]))
        assert e["backend"] == ("cpu" if pkg.name == "torch"
                                else e["backend"])
    return sp, tiers, legs, [(e["op"], e.get("cost"))
                             for e in events]


def _reuse_gate(pkg):
    sess = pkg.session(spill_host_max_bytes=1, spill_disk_hits=5)
    arrs = arrays(["a", "b"])
    register(sess, arrs)
    check(sess, arrs, "a")
    check(sess, arrs, "b")               # a evicted cold: hits 0 < 5
    sp = dict(spill_info(sess))
    assert sp["dropped"] >= 1 and sp["disk_entries"] == 0
    assert not os.path.exists(os.path.join(pkg.root, "spill"))
    check(sess, arrs, "a")               # recompute stays correct
    assert spill_info(sess)["promoted"] == 0
    return sp


def _host_only(pkg):
    sess = pkg.session(state_dir="", spill_host_max_bytes=1)
    arrs = arrays(["a", "b"])
    register(sess, arrs)
    check(sess, arrs, "a")
    check(sess, arrs, "b")
    sp = dict(spill_info(sess))
    assert sp["disk_entries"] == 0 and sp["dropped"] >= 1
    with pytest.raises(ValueError):
        sess.save_state()                # nowhere durable to write
    return sp


class TestSpillTiers:

    def test_host_round_trip_recomputes_nothing_wrong(self, pkgs):
        both(pkgs, _host_round_trip)

    def test_disk_round_trip_writes_and_thaws_artifact(self, pkgs):
        both(pkgs, _disk_round_trip)

    def test_lru_pressure_ages_oldest_entry_deepest(self, pkgs):
        both(pkgs, _lru_pressure)

    def test_expected_reuse_gate_drops_cold_entries(self, pkgs):
        both(pkgs, _reuse_gate)

    def test_no_state_dir_means_host_only_tiering(self, pkgs):
        both(pkgs, _host_only)


# ---------------------------------------------------------------------------
# rebind invalidation cascades into every lower tier
# ---------------------------------------------------------------------------


def _rebind_host(pkg):
    sess = pkg.session()
    arrs = arrays(["a", "b"])
    register(sess, arrs)
    check(sess, arrs, "a")
    check(sess, arrs, "b")
    before = spill_info(sess)["host_entries"]
    sess.register("a", sess.from_numpy(arrays(["x"], seed=9)["x"]))
    return before, spill_info(sess)["host_entries"]


def _rebind_disk(pkg):
    sess = pkg.session(spill_host_max_bytes=1)
    arrs = arrays(["a", "b"])
    register(sess, arrs)
    check(sess, arrs, "a")
    check(sess, arrs, "b")
    spill_dir = os.path.join(pkg.root, "spill")
    before = len(os.listdir(spill_dir))
    sess.register("a", sess.from_numpy(arrays(["x"], seed=9)["x"]))
    return (before, spill_info(sess)["disk_entries"],
            os.listdir(spill_dir))


def _rebind_restored(pkg):
    cfg = dict(result_cache_max_bytes=64 << 20)
    sess1 = pkg.session(**cfg)
    arrs = arrays(["a", "b"])
    register(sess1, arrs)
    check(sess1, arrs, "a")
    check(sess1, arrs, "b")
    sess1.save_state()
    sess2 = pkg.session(**cfg)
    assert sess2.restore()["restored"]
    n0 = spill_info(sess2)["restored_entries"]
    arr2 = arrays(["x"], seed=9)["x"]
    sess2.register("a", sess2.from_numpy(arr2))
    n1 = spill_info(sess2)["restored_entries"]
    got = sess2.run(gram(sess2.catalog["a"])).to_numpy()
    np.testing.assert_allclose(got, arr2.T @ arr2, rtol=1e-5, atol=1e-4)
    check(sess2, arrs, "b")
    return n0, n1, spill_info(sess2)["thawed_restored"]


class TestInvalidation:

    def test_rebind_kills_host_tier_entries(self, pkgs):
        assert both(pkgs, _rebind_host) == (1, 0)

    def test_rebind_kills_disk_tier_and_unlinks_artifact(self, pkgs):
        assert both(pkgs, _rebind_disk) == (1, 0, [])

    def test_rebind_kills_restored_entries_by_name(self, pkgs):
        assert both(pkgs, _rebind_restored) == (2, 1, 1)


# ---------------------------------------------------------------------------
# structural zero — the default config constructs no spill objects
# ---------------------------------------------------------------------------


class TestDefaultZeroObjects:

    def test_default_config_never_constructs_spill(self, pkgs,
                                                   monkeypatch):
        def _boom(self, session):
            raise AssertionError(
                "SpillManager constructed under a spill-off config")
        for mod, pkg in ((j_spill, pkgs[0]), (t_spill, pkgs[1])):
            monkeypatch.setattr(mod.SpillManager, "__init__", _boom)
            base = mod._CONSTRUCTED["count"]
            sess = pkg.Session(mesh=pkg.mesh, config=pkg.Config())
            assert sess._spill is None
            cache_only = pkg.Session(mesh=pkg.mesh, config=pkg.Config(
                result_cache_max_bytes=64 << 20))
            assert cache_only._spill is None
            assert "spill" not in cache_only.result_cache_info()
            assert mod._CONSTRUCTED["count"] == base


# ---------------------------------------------------------------------------
# save_state / restore and corruption
# ---------------------------------------------------------------------------


def _warm_restart(pkg):
    cfg = dict(result_cache_max_bytes=64 << 20)
    sess1 = pkg.session(**cfg)
    arrs = arrays(["a", "b"])
    register(sess1, arrs)
    check(sess1, arrs, "a")
    check(sess1, arrs, "b")
    summary = sess1.save_state()
    sess2 = pkg.session(**cfg)
    out = sess2.restore()
    for nm in ("a", "b"):
        check(sess2, arrs, nm)
    info = sess2.result_cache_info()
    _ = sess2.run(gram(sess2.catalog["a"]))
    return ({k: summary[k] for k in ("rc_entries", "catalog",
                                     "rc_skipped", "step")},
            {k: out[k] for k in ("restored", "rc_entries", "catalog",
                                 "fleet", "mqo_templates", "step")},
            info["spill"]["thawed_restored"], info["hits"],
            info["misses"], sess2.result_cache_info()["hits"])


def _integer_restart(pkg):
    cfg = dict(result_cache_max_bytes=64 << 20)
    sess1 = pkg.session(**cfg)
    arrs = arrays(["ints"], integral=True)
    register(sess1, arrs)
    check(sess1, arrs, "ints", exact=True)
    sess1.save_state()
    sess2 = pkg.session(**cfg)
    assert sess2.restore()["restored"]
    check(sess2, arrs, "ints", exact=True)
    return spill_info(sess2)["thawed_restored"]


def _corrupt_snapshot(pkg):
    cfg = dict(result_cache_max_bytes=64 << 20)
    sess1 = pkg.session(**cfg)
    arrs = arrays(["a"])
    register(sess1, arrs)
    check(sess1, arrs, "a")
    sess1.save_state()
    state = os.path.join(pkg.root, "state")
    for dirpath, _dirs, files in os.walk(state):
        for f in files:
            with open(os.path.join(dirpath, f), "wb") as fh:
                fh.write(b"not a snapshot")
    sess2 = pkg.session(**cfg)
    out = sess2.restore()               # never raises
    assert out["restored"] is False and out.get("reason")
    register(sess2, arrs)
    check(sess2, arrs, "a")
    return out["restored"], sorted(out)


def _missing_snapshot(pkg):
    out = pkg.session().restore()
    return out["restored"], out["reason"]


def _tampered(pkg):
    cfg = dict(result_cache_max_bytes=64 << 20)
    sess1 = pkg.session(**cfg)
    arrs = arrays(["a", "b"])
    register(sess1, arrs)
    check(sess1, arrs, "a")
    check(sess1, arrs, "b")
    sess1.save_state()
    spill_dir = os.path.join(pkg.root, "spill")
    victim = sorted(f for f in os.listdir(spill_dir)
                    if f.endswith(".npy"))[0]
    with open(os.path.join(spill_dir, victim), "r+b") as fh:
        fh.seek(0, os.SEEK_END)
        fh.write(b"\x00tampered")
    sess2 = pkg.session(**cfg)
    n = sess2.restore()["rc_entries"]
    for nm in ("a", "b"):               # one thaws, one recomputes
        check(sess2, arrs, nm)
    sp = spill_info(sess2)
    return n, sp["corrupt"], sp["thawed_restored"]


def _spill_off_restore(pkg, caplog):
    sess1 = pkg.session(result_cache_max_bytes=64 << 20)
    arrs = arrays(["a"])
    register(sess1, arrs)
    check(sess1, arrs, "a")
    sess1.save_state()
    off = pkg.Config(result_cache_max_bytes=64 << 20, state_dir=pkg.root)
    sess2 = pkg.Session(mesh=pkg.mesh, config=off)
    assert sess2._spill is None
    caplog.clear()
    with caplog.at_level(logging.WARNING):
        out = sess2.restore()
    assert any("spill_enable is off" in r.message for r in caplog.records)
    check(sess2, arrs, "a")
    return out["restored"], out["catalog"], out["rc_entries"]


class TestSaveRestore:

    def test_warm_restart_serves_from_snapshot(self, pkgs):
        summary, out, thawed, hits, misses, hits_after = both(
            pkgs, _warm_restart)
        assert summary["rc_entries"] == 2 and summary["catalog"] == 2
        assert out["restored"] and out["rc_entries"] == 2
        assert out["catalog"] == 2 and out["fleet"] == 0
        assert thawed == 2 and hits == 2 and misses == 0
        assert hits_after == 3

    def test_integer_results_restore_bit_exact(self, pkgs):
        assert both(pkgs, _integer_restart) == 1

    def test_corrupt_snapshot_warns_and_cold_starts(self, pkgs):
        assert both(pkgs, _corrupt_snapshot)[0] is False

    def test_missing_snapshot_is_a_clean_cold_start(self, pkgs):
        assert both(pkgs, _missing_snapshot) == (False, "no snapshot")

    def test_sha1_tampered_artifact_is_a_miss_not_a_wrong_answer(
            self, pkgs):
        assert both(pkgs, _tampered) == (2, 1, 1)

    def test_read_artifact_raises_typed_snapshot_corruption(self, pkgs):
        assert issubclass(SnapshotCorruption, CheckpointCorruption)
        arr = np.arange(16, dtype=np.float32).reshape(4, 4)
        sha = []
        for pkg, payload in ((pkgs[0], arr),
                             (pkgs[1], torch.from_numpy(arr.copy()))):
            mgr = pkg.session()._spill
            file, sha1 = mgr._write_artifact("cafe0001", payload)
            sha.append(sha1)
            mod = j_spill if pkg.name == "jax" else t_spill
            te = mod.TierEntry(tier="disk", meta={"key_hash": "x"},
                               nbytes=64, file=file, sha1=sha1)
            np.testing.assert_array_equal(
                np.asarray(mgr._read_artifact(te)), arr)
            with open(file, "ab") as fh:
                fh.write(b"garbage")
            err = (j_spill.SnapshotCorruption if pkg.name == "jax"
                   else SnapshotCorruption)
            with pytest.raises(err, match="sha1 mismatch"):
                mgr._read_artifact(te)
            os.remove(file)
            with pytest.raises(err):
                mgr._read_artifact(te)
        # the port writes the JAX package's artifact byte for byte
        assert sha[0] == sha[1]

    def test_spill_off_restore_keeps_catalog_skips_entries(self, pkgs,
                                                           caplog):
        assert both(pkgs, _spill_off_restore, caplog) == (True, 1, 0)

    def test_save_state_without_any_directory_raises(self, pkgs):
        for pkg in pkgs:
            sess = pkg.Session(mesh=pkg.mesh, config=pkg.Config(
                spill_enable=True, result_cache_max_bytes=64 << 20))
            with pytest.raises(ValueError, match="state_dir"):
                sess.save_state()


# ---------------------------------------------------------------------------
# fleet demand hints and MQO template keys across a restart
# ---------------------------------------------------------------------------


class TestWarmSeeds:

    def test_fleet_seed_hints_merge_into_first_fresh_insert(self, pkgs):
        records = [{"key": "k1", "hits": {"0": 3, "1": 2}}, "junk",
                   {"key": 7}, {"key": "k2", "hits": {"0": 1}}]
        got = []
        for mod in (j_fleet, t_fleet):
            d = mod.FleetDirectory(max_entries=4)
            n = d.seed_hints(records)
            rec = mod.DirectoryRecord(
                owner=0, owner_key="local", nbytes=64, layout="2d",
                dtype="float32", dep_names=frozenset({"a"}), hits={0: 1})
            d.record_insert("k1", rec)
            got.append((n, d.lookup("k1").hits, d.info()))
        assert got[0] == got[1]
        assert got[1][:2] == (2, {0: 4, 1: 2})
        # a session without fleet_slices seeds nothing, in both
        for pkg, spill in zip(pkgs, (j_spill, t_spill)):
            assert spill._restore_fleet(pkg.session(), records) == 0

    def test_fleet_export_state_carries_unconsumed_hints(self, pkgs):
        got = []
        for mod in (j_fleet, t_fleet):
            d = mod.FleetDirectory(max_entries=4)
            d.seed_hints([{"key": "k2", "hits": {"1": 5}}])
            got.append(d.export_state())
        assert got[0] == got[1]
        assert {r["key"]: r for r in got[1]}["k2"]["hits"] == {"1": 5}
        # a session without a fleet exports an empty record in both
        assert (j_spill._export_fleet(pkgs[0].session())
                is t_spill._export_fleet(pkgs[1].session()) is None)

    def test_mqo_template_keys_seed_and_rewarm(self):
        got = []
        for mod, cfg in ((j_mqo, JConfig), (t_mqo, TConfig)):
            st = mod.MqoState(cfg(cse_enable=True))
            n = st.seed_templates(["t1", "t2", 3])
            keys0 = st.template_keys()
            st.put_template("t1", mod.TemplateEntry(
                plan=object(), slots=(), pins=()))
            got.append((n, keys0, st.info()["templates_rewarmed"],
                        st.info()["seeded_templates"],
                        st.template_keys()))
        assert got[0] == got[1] == (2, ["t1", "t2"], 1, 1, ["t2", "t1"])

    def test_mqo_seed_respects_template_bound(self):
        assert [mod.MqoState(cfg(cse_enable=True, cse_template_max=1))
                .seed_templates(["t1", "t2", "t3"])
                for mod, cfg in ((j_mqo, JConfig), (t_mqo, TConfig))] \
            == [1, 1]


# ---------------------------------------------------------------------------
# MV117 — spill-thaw provenance stamps cohere with the tier hierarchy
# ---------------------------------------------------------------------------


def _mv117_both(mesh8, tmesh8, spill, fits_from=None):
    """MV117 over the same stamped leaf in both packages:
    [(code, severity, message)], equal between them."""
    a = np.random.default_rng(5).standard_normal((32, 32)).astype(
        np.float32)
    out = []
    for BM, E, sp, cfg, mesh in (
            (JBM, JE, j_spill_pass, JConfig(), mesh8),
            (TBM, TE, t_spill_pass, TConfig(), tmesh8)):
        leaf = E.leaf(BM.from_numpy(a, mesh=mesh)).with_attrs(
            result_cache={"key_hash": "cafe", "layout": "2d",
                          "dtype": "float32", "deps": [],
                          "spill": dict(spill)})
        out.append([(d.code, d.severity, d.message)
                    for d in sp.check_spill_stamps(leaf, None, cfg)])
    assert out[0] == out[1]
    return out[1]


class TestMV117:

    def test_truthful_stamp_is_clean(self, mesh8, tmesh8):
        nbytes = 32 * 32 * 4
        fits = [r.spill_plan("host", "hbm", nbytes).fits(0.0)
                for r in (j_reshard, t_reshard)]
        assert fits[0] == fits[1]
        assert _mv117_both(mesh8, tmesh8, {
            "tier": "host", "legs": ["h2d"], "cost": "measured",
            "fits": fits[1]}) == []

    def test_hbm_tier_claim_fires(self, mesh8, tmesh8):
        diags = _mv117_both(mesh8, tmesh8, {
            "tier": "hbm", "legs": [], "cost": "measured"})
        assert len(diags) == 1 and diags[0][0] == "MV117"
        assert "an HBM hit never stamps" in diags[0][2]
        assert diags[0][1] == "warning"

    def test_unknown_leg_fires(self, mesh8, tmesh8):
        diags = _mv117_both(mesh8, tmesh8, {
            "tier": "host", "legs": ["dma"], "cost": "measured"})
        assert len(diags) == 1 and "transfer vocabulary" in diags[0][2]

    def test_wrong_legs_for_tier_fire(self, mesh8, tmesh8):
        diags = _mv117_both(mesh8, tmesh8, {
            "tier": "host", "legs": ["disk_read", "h2d"],
            "cost": "measured"})
        assert any("priced on transfers that did not run" in d[2]
                   for d in diags)

    def test_restored_tier_prices_the_disk_legs(self, mesh8, tmesh8):
        assert _mv117_both(mesh8, tmesh8, {
            "tier": "restored", "legs": ["disk_read", "h2d"],
            "cost": "measured"}) == []

    def test_stale_fits_verdict_fires(self, mesh8, tmesh8):
        diags = _mv117_both(mesh8, tmesh8, {
            "tier": "host", "legs": ["h2d"], "cost": "measured",
            "fits": False})
        assert any("budget story" in d[2] for d in diags)

    def test_unclassifiable_cost_provenance_fires(self, mesh8, tmesh8):
        diags = _mv117_both(mesh8, tmesh8, {
            "tier": "host", "legs": ["h2d"], "cost": "guessed"})
        assert any("cannot classify" in d[2] for d in diags)

    def test_live_promotion_stamp_passes_verify_plan(self, pkgs):
        def scenario(pkg):
            if pkg.name == "jax":
                from matrel_tpu import analysis
                from matrel_tpu.ir import rules
                from matrel_tpu.parallel import planner
            else:
                from matrel_tpu_torch import analysis
                from matrel_tpu_torch.ir import rules
                from matrel_tpu_torch.parallel import planner
            sess = pkg.session()
            arrs = arrays(["a", "b"])
            register(sess, arrs)
            check(sess, arrs, "a")
            check(sess, arrs, "b")
            check(sess, arrs, "a")       # promoted: entry now stamped
            B = sess.from_numpy(arrays(["x"], seed=4)["x"])
            sub = sess._rc_substitute(
                gram(sess.catalog["a"]).multiply(B.expr()))
            stamps = [c.attrs["result_cache"] for c in sub.children
                      if c.attrs.get("result_cache")]
            spill = stamps[0]["spill"]
            ann = planner.annotate_strategies(
                rules.optimize(sub, sess.config, grid=(2, 4),
                               mesh=pkg.mesh), pkg.mesh, sess.config)
            diags = analysis.verify_plan(ann, pkg.mesh, config=sess.config)
            return (spill["tier"], spill["legs"], spill["cost"],
                    spill["fits"],
                    [(d.code, d.severity) for d in diags])
        tier, legs, cost, fits, diags = both(pkgs, scenario)
        assert tier == "host" and legs == ["h2d"]
        assert [d for d in diags if d[0] == "MV117"] == []


# ---------------------------------------------------------------------------
# the durability knobs reject broken combinations
# ---------------------------------------------------------------------------


class TestConfigValidation:

    @staticmethod
    def _refused(kw, match):
        for cfg in (JConfig, TConfig):
            with pytest.raises(ValueError, match=match):
                cfg(**kw)

    def test_spill_requires_a_result_cache(self):
        self._refused(dict(spill_enable=True), "result_cache_max_bytes")

    def test_host_budget_must_be_positive(self):
        self._refused(dict(spill_host_max_bytes=0), "spill_host_max_bytes")

    def test_disk_hits_gate_must_be_nonnegative(self):
        self._refused(dict(spill_disk_hits=-1), "spill_disk_hits")


# ---------------------------------------------------------------------------
# bfloat16 through the disk tier and a warm restart (the port only: the
# JAX package's own disk tier cannot thaw a bf16 artifact)
# ---------------------------------------------------------------------------


def test_bf16_entry_survives_disk_tier_and_restart_bit_equal(tmesh8,
                                                             tmp_path):
    rng = np.random.default_rng(11)
    nbytes = N * N * 2
    cfg = TConfig(spill_enable=True, result_cache_max_bytes=int(1.5 * nbytes),
                  spill_host_max_bytes=1, spill_disk_hits=0,
                  state_dir=str(tmp_path))
    sess = TSession(mesh=tmesh8, config=cfg)
    for nm in ("a", "b"):
        sess.register(nm, sess.from_numpy(
            rng.standard_normal((N, N)).astype(np.float32),
            dtype="bfloat16"))
    qa = sess.catalog["a"].expr().multiply(sess.catalog["b"].expr())
    qb = sess.catalog["b"].expr().multiply(sess.catalog["a"].expr())
    first = sess.run(qa)
    assert first.dtype == torch.bfloat16
    want = first.data.clone()
    sess.run(qb)                         # qa: device -> host -> disk
    sp = spill_info(sess)
    assert sp["disk_entries"] == 1
    (art,) = [f for f in os.listdir(os.path.join(str(tmp_path), "spill"))
              if f.endswith(".npy")]
    raw = np.load(os.path.join(str(tmp_path), "spill", art))
    assert raw.dtype == np.dtype("V2")   # the |V2 payload numpy writes
    assert np.array_equal(raw.view(np.int16),
                          want.view(torch.int16).numpy())
    again = sess.run(qa)
    assert spill_info(sess)["promoted"] == 1
    assert again.dtype == torch.bfloat16
    assert torch.equal(again.data.view(torch.int16),
                       want.view(torch.int16))
    sess.save_state()
    sess2 = TSession(mesh=tmesh8, config=cfg.replace(
        result_cache_max_bytes=64 << 20))
    assert sess2.restore()["rc_entries"] == 2
    back = sess2.run(sess2.catalog["a"].expr().multiply(
        sess2.catalog["b"].expr()))
    assert spill_info(sess2)["thawed_restored"] == 1
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.data.view(torch.int16), want.view(torch.int16))
