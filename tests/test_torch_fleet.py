"""PyTorch port: the multi-slice serving fleet held against the JAX package
on the CPU — ``tests/test_fleet.py``'s 66 cases as paired comparisons.

Each scenario runs once per package (the JAX package on its (2, 4) CPU
mesh, the port on the virtual (2, 4) grid, ``device="cpu"``) over the same
seeded numpy arrays and returns a record of what it observed: slice
partitions, fleet keys, placement decisions, directory counters and
records, ``fleet_info``, the ``placement`` / ``fleet`` event records,
MV114 diagnostics. The two records must be equal (floats to 1e-9
relative), and each must satisfy the JAX test's own assertions. Answers
are held to float64 numpy at the JAX test's tolerances (rtol/atol 2e-4,
3e-3 for the rebind storm). Every pipeline is closed with a timeout.

Added for the port: the ``"shared"`` 1 x 1 grid (the card's form: one
slice mesh is the parent mesh, tables shared, not copied), and the
execution lock that ``_arbitrated_run`` takes only under a fleet.
"""

import dataclasses
import importlib
import json
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from matrel_tpu_torch.core.mesh import make_mesh

WAIT_S = 60.0
TOL = dict(rtol=2e-4, atol=2e-4)


class Pkg:
    """One package's face: its modules by the JAX package's relative
    names, and its (2, 4) mesh."""

    def __init__(self, name, root, mesh):
        self.name = name
        self.root = root
        self.mesh = mesh

    def mod(self, rel):
        return importlib.import_module(f"{self.root}.{rel}")

    def __getattr__(self, attr):
        table = {
            "Config": ("config", "MatrelConfig"),
            "Session": ("session", "MatrelSession"),
            "BM": ("core.blockmatrix", "BlockMatrix"),
            "COO": ("core.coo", "COOMatrix"),
            "Deadline": ("resilience.retry", "Deadline"),
        }
        if attr in table:
            rel, name = table[attr]
            return getattr(self.mod(rel), name)
        short = {"mesh_lib": "core.mesh", "placement": "serve.placement",
                 "fleet": "serve.fleet", "errors": "resilience.errors",
                 "expr": "ir.expr", "events": "obs.events",
                 "history": "obs.history", "export": "obs.export",
                 "top": "obs.top", "analysis": "analysis",
                 "placement_pass": "analysis.placement_pass"}
        if attr in short:
            return self.mod(short[attr])
        raise AttributeError(attr)


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh((2, 4), device="cpu")


@pytest.fixture()
def pkgs(mesh8, tmesh8):
    return (Pkg("jax", "matrel_tpu", mesh8),
            Pkg("torch", "matrel_tpu_torch", tmesh8))


def _approx(a, b):
    if isinstance(a, float) and isinstance(b, float):
        return a == pytest.approx(b, rel=1e-9, abs=1e-12)
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(_approx(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return len(a) == len(b) and all(_approx(x, y) for x, y in zip(a, b))
    return a == b


def both(pkgs, scenario, *args):
    """``scenario(pkg, *args)`` in both packages; the records must be
    equal. Returns the port's record."""
    rj = scenario(pkgs[0], *args)
    rt = scenario(pkgs[1], *args)
    assert _approx(rj, rt), (rj, rt)
    return rt


def _arrays(n=64, seed=42):
    rng = np.random.default_rng(seed)
    return {nm: rng.standard_normal((n, n)).astype(np.float32)
            for nm in ("A", "B")}


def _fleet_session(p, n=64, mesh=None, **kw):
    cfg = p.Config(fleet_slices=2, result_cache_max_bytes=1 << 28, **kw)
    sess = p.Session(mesh=mesh or p.mesh, config=cfg)
    mats = _arrays(n)
    for nm, a in mats.items():
        sess.register(nm, sess.from_numpy(a))
    return sess, mats


def _q(sess):
    return sess.table("A").expr().multiply(sess.table("B").expr())


def _np(m):
    return np.asarray(m.to_numpy())


def _dir_rec(rec):
    """A directory record, less its id-based owner/replica keys."""
    return (rec.owner, rec.nbytes, rec.layout, rec.dtype,
            sorted(rec.dep_names), dict(rec.hits), sorted(rec.replicas),
            sorted(rec.priced_out))


def _untimed(d):
    """A roll-up less its host-clock sums (``execute_ms``)."""
    if isinstance(d, dict):
        return {k: _untimed(v) for k, v in d.items() if k != "execute_ms"}
    if isinstance(d, list):
        return [_untimed(v) for v in d]
    return d


def _events(path, kind):
    from matrel_tpu_torch.obs.events import read_events
    return [{k: v for k, v in e.items() if k != "ts"}
            for e in read_events(path) if e.get("kind") == kind]


# ---------------------------------------------------------------------------
# core/mesh slice views
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class _FakeDev:
    id: int
    slice_index: int


class _FakeMesh:
    def __init__(self, rows):
        self.devices = np.asarray(rows, dtype=object)


class TestSliceViews:
    def test_virtual_partition_splits_contiguously(self, pkgs):
        def run(p):
            groups, source = p.mesh_lib.slice_device_groups(p.mesh, 2)
            return (source, [[d.id for d in g] for g in groups])

        source, ids = both(pkgs, run)
        assert source == "virtual" and [len(g) for g in ids] == [4, 4]
        assert len({i for g in ids for i in g}) == 8

    def test_virtual_meshes_near_square(self, pkgs):
        def run(p):
            meshes, source = p.mesh_lib.slice_meshes(p.mesh, 2)
            return source, [(p.mesh_lib.mesh_grid_shape(m),
                             tuple(m.axis_names)) for m in meshes]

        source, shapes = both(pkgs, run)
        assert source == "virtual"
        assert shapes == [((2, 2), ("x", "y"))] * 2
        # the port's slice meshes stay on the parent's device
        for m in pkgs[1].mesh_lib.slice_meshes(pkgs[1].mesh, 2)[0]:
            assert m.device == pkgs[1].mesh.device

    def test_shared_when_indivisible(self, pkgs):
        def run(p):
            groups, source = p.mesh_lib.slice_device_groups(p.mesh, 3)
            return source, [len(g) for g in groups]

        assert both(pkgs, run) == ("shared", [8, 8, 8])

    def test_detected_from_slice_index(self, pkgs):
        rows = [[_FakeDev(0, 0), _FakeDev(1, 0)],
                [_FakeDev(2, 1), _FakeDev(3, 1)]]

        def run(p):
            groups, source = p.mesh_lib.slice_device_groups(
                _FakeMesh(rows), 2)
            return source, [sorted(d.id for d in g) for g in groups]

        assert both(pkgs, run) == ("detected", [[0, 1], [2, 3]])

    def test_slice_index_mismatch_falls_back_virtual(self, pkgs):
        rows = [[_FakeDev(0, 0), _FakeDev(1, 0)],
                [_FakeDev(2, 1), _FakeDev(3, 1)]]

        def run(p):
            groups, source = p.mesh_lib.slice_device_groups(
                _FakeMesh(rows), 4)
            return source, [len(g) for g in groups]

        assert both(pkgs, run) == ("virtual", [1, 1, 1, 1])

    def test_bad_count_raises(self, pkgs):
        for p in pkgs:
            with pytest.raises(ValueError):
                p.mesh_lib.slice_device_groups(p.mesh, 0)

    def test_topology_detected_and_configured(self, pkgs):
        """``mesh_topology`` / ``detect_slice_axes``: the fake mesh's
        slice boundary weights its crossing axis, a configured weight
        wins, a port mesh detects nothing."""
        rows = [[_FakeDev(0, 0), _FakeDev(1, 0)],
                [_FakeDev(2, 1), _FakeDev(3, 1)]]

        def run(p):
            fake = _FakeMesh(rows)
            t = p.mesh_lib.mesh_topology(fake, p.Config())
            c = p.mesh_lib.mesh_topology(
                fake, p.Config(axis_cost_weights=(1.0, 2.0)))
            d = p.mesh_lib.mesh_topology(p.mesh, p.Config())
            return (p.mesh_lib.detect_slice_axes(fake), t.axis_weights,
                    t.source, t.uniform, c.axis_weights, c.source,
                    d.axis_weights, d.source,
                    p.mesh_lib.axis_weights(p.mesh, p.Config(
                        axis_cost_weights=(1.0, 4.0))))

        got = both(pkgs, run)
        assert got[:3] == ((True, False), (8.0, 1.0), "detected")
        assert got[7] == "default" and got[8] == (1.0, 4.0)

    def test_shared_one_card_grid_is_the_parent(self):
        """The card's form: on the 1 x 1 grid every slice mesh IS the
        parent mesh."""
        from matrel_tpu_torch.core import mesh as mesh_lib
        m = make_mesh(device="cpu")
        meshes, source = mesh_lib.slice_meshes(m, 2)
        assert source == "shared" and all(s is m for s in meshes)


# ---------------------------------------------------------------------------
# fleet keys
# ---------------------------------------------------------------------------


class TestFleetKey:
    def test_name_keyed_and_stable_across_replicas(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            e = _q(sess)
            k1 = p.placement.fleet_key(e, fleet._names)
            sl = fleet.slices[1]
            k2 = p.placement.fleet_key(fleet._rebind(e, sl),
                                       sl.names_by_id)
            return k1, k2

        k1, k2 = both(pkgs, run)
        assert "@A" in k1 and "@B" in k1 and "id(" not in k1 and k1 == k2

    def test_unnamed_leaf_is_ineligible(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            adhoc = sess.from_numpy(np.ones((64, 64), np.float32))
            e = sess.table("A").expr().multiply(adhoc.expr())
            return p.placement.fleet_key(e, fleet._names)

        assert both(pkgs, run) is None

    def test_prefix_isolates_slas(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            e = _q(sess)
            return (p.placement.fleet_key(e, fleet._names, ""),
                    p.placement.fleet_key(e, fleet._names, "prec:fast|"))

        k_def, k_fast = both(pkgs, run)
        assert k_def != k_fast and k_fast.startswith("prec:fast|")


# ---------------------------------------------------------------------------
# placement decisions
# ---------------------------------------------------------------------------


def _big_expr(p, n=1024):
    A = p.BM.random((n, n), mesh=p.mesh, seed=0)
    B = p.BM.random((n, n), mesh=p.mesh, seed=1)
    return A.expr().multiply(B.expr())


KW = dict(total_devices=8, slice_devices=4, slice_loads={0: 0, 1: 0},
          eligible=True)


def _dec(dec):
    return (dec.mode, dec.slice_id, dec.reason, dec.coeff_source,
            dec.est_slice_ms, dec.est_span_ms, tuple(dec.weights),
            dec.dcn_axis)


class TestPlacement:
    def test_effective_dcn_weight(self, pkgs):
        def run(p):
            return [p.placement.effective_dcn_weight(w) for w in (
                (1.0, 1.0), (1.0, 1.5), (8.0, 1.0), (1.0, 0.9),
                (0.5, 0.5))]

        assert both(pkgs, run) == [8.0, 1.5, 8.0, 1.0, 0.5]

    def test_decision_flips_with_axis_weights(self, pkgs):
        def run(p):
            cfg = p.Config(fleet_slices=2)
            e = _big_expr(p)
            return [_dec(p.placement.decide(e, cfg, w, backend="cpu",
                                            **KW))
                    for w in ((1.0, 1.5), (1.0, 8.0))]

        cheap, dear = both(pkgs, run)
        assert cheap[0] == "span" and cheap[2] == "cost"
        assert dear[0] == "slice" and dear[2] == "cost"

    def test_uniform_weights_price_virtual_cut_as_dcn(self, pkgs):
        def run(p):
            cfg = p.Config(fleet_slices=2)
            sess = p.Session(mesh=p.mesh, config=cfg)
            eye = np.eye(64, dtype=np.float32)
            e = sess.from_numpy(eye).expr().multiply(
                sess.from_numpy(eye).expr())
            return _dec(p.placement.decide(e, cfg, (1.0, 1.0), **KW))

        assert both(pkgs, run)[0] == "slice"

    def test_pinned_when_ineligible(self, pkgs):
        def run(p):
            cfg = p.Config(fleet_slices=2)
            return _dec(p.placement.decide(
                _big_expr(p, 64), cfg, (1.0, 8.0),
                **{**KW, "eligible": False}))

        got = both(pkgs, run)
        assert got[0] == "span" and got[2] == "pinned"

    def test_least_loaded_slice_wins(self, pkgs):
        def run(p):
            return _dec(p.placement.decide(
                _big_expr(p, 64), p.Config(fleet_slices=2), (1.0, 1.0),
                **{**KW, "slice_loads": {0: 5, 1: 0}}))

        assert both(pkgs, run)[1] == 1

    def test_round_robin_tie_break(self, pkgs):
        def run(p):
            e = _big_expr(p, 64)
            cfg = p.Config(fleet_slices=2)
            return [p.placement.decide(e, cfg, (1.0, 1.0), rr_tick=t,
                                       **KW).slice_id for t in range(4)]

        assert both(pkgs, run) == [0, 1, 0, 1]

    def test_stamp_carries_the_billed_dcn_weight(self, pkgs):
        def run(p):
            return p.placement.decide(
                _big_expr(p, 64), p.Config(fleet_slices=2), (1.0, 1.5),
                **KW).stamp()

        st = both(pkgs, run)
        assert st["dcn_weight"] == 1.5 and st["weights"] == [1.0, 1.5]
        assert set(st) == {"mode", "weights", "dcn_axis", "dcn_weight"}

    def test_span_margin_biases_toward_slices(self, pkgs):
        def run(p):
            e = _big_expr(p)
            return [p.placement.decide(e, p.Config(fleet_slices=2, **c),
                                       (1.0, 1.5), **KW).mode
                    for c in ({}, {"fleet_span_margin": 0.1})]

        assert both(pkgs, run) == ["span", "slice"]


# ---------------------------------------------------------------------------
# drift-calibrated coefficients
# ---------------------------------------------------------------------------


def _seed_drift_table(path, cls="<=1024", backend="cpu",
                      strategy="rmm", gflop=50.0, mib=2.0, count=4):
    table = {"schema": 1, "entries": {
        f"{strategy}|{cls}|{backend}": {
            "strategy": strategy, "class": cls, "backend": backend,
            "count": count, "ms_median": 1.0,
            "ms_per_gflop": gflop, "ms_per_est_mib": mib}}}
    with open(path, "w") as f:
        json.dump(table, f)


class TestPlacementCalibration:
    @pytest.fixture(autouse=True)
    def _fresh_cache(self, pkgs):
        for p in pkgs:
            p.placement.reset_coefficient_cache()
        yield
        for p in pkgs:
            p.placement.reset_coefficient_cache()

    def test_promotes_rows_per_class_backend_tier(self, pkgs, tmp_path):
        path = str(tmp_path / "drift.json")
        table = {"schema": 1, "entries": {
            "rmm|<=1024|cpu": {
                "strategy": "rmm", "class": "<=1024", "backend": "cpu",
                "count": 3, "ms_median": 1.0, "ms_per_gflop": 10.0,
                "ms_per_est_mib": 1.0},
            "cpmm|<=1024|cpu": {
                "strategy": "cpmm", "class": "<=1024", "backend": "cpu",
                "count": 1, "ms_median": 1.0, "ms_per_gflop": 50.0,
                "ms_per_est_mib": 5.0},
            "rmm@bf16x1|<=1024|cpu": {
                "strategy": "rmm@bf16x1", "class": "<=1024",
                "backend": "cpu", "count": 2, "ms_median": 1.0,
                "ms_per_gflop": 4.0, "ms_per_est_mib": 0.5}}}
        with open(path, "w") as f:
            json.dump(table, f)

        def run(p):
            p.placement.reset_coefficient_cache()
            return p.placement.placement_coefficients(path)

        coeffs = both(pkgs, run)
        row = coeffs[("<=1024", "cpu", "")]
        assert row["ms_per_gflop"] == pytest.approx(20.0)
        assert row["ms_per_mib"] == pytest.approx(2.0)
        assert row["source"] == "measured"
        assert coeffs[("<=1024", "cpu", "bf16x1")]["ms_per_gflop"] \
            == pytest.approx(4.0)

    @pytest.mark.parametrize("cls,calib,want", [
        ("<=1024", True, "measured"),      # measured ahead of closed forms
        ("<=64", True, "analytic"),        # cold class: analytic
        ("<=1024", False, "analytic"),     # calibration gate off
    ])
    def test_decide_coefficient_source(self, pkgs, tmp_path, cls, calib,
                                       want):
        path = str(tmp_path / "drift.json")
        _seed_drift_table(path, cls=cls)

        def run(p):
            p.placement.reset_coefficient_cache()
            cfg = p.Config(fleet_slices=2, drift_table_path=path,
                           fleet_placement_calibration=calib)
            return _dec(p.placement.decide(_big_expr(p), cfg, (1.0, 1.5),
                                           backend="cpu", **KW))

        got = both(pkgs, run)
        assert got[3] == want
        if want == "measured":
            assert got[4] > 10.0

    def test_absent_table_reads_empty(self, pkgs, tmp_path):
        for p in pkgs:
            assert p.placement.placement_coefficients(
                str(tmp_path / "nope.json")) == {}


# ---------------------------------------------------------------------------
# the fleet serve plane, end to end
# ---------------------------------------------------------------------------


def _info(sess):
    """``fleet_info`` less the id-free-but-timing-dependent parts."""
    return sess.fleet_info()


class TestFleetServe:
    def test_submit_routes_to_slices_and_answers_correctly(self, pkgs):
        def run(p):
            sess, mats = _fleet_session(p)
            futs = [sess.submit(_q(sess).multiply_scalar(float(i + 1)))
                    for i in range(4)]
            outs = [_np(f.result(timeout=WAIT_S)) for f in futs]
            oracle = mats["A"] @ mats["B"]
            for i, o in enumerate(outs):
                np.testing.assert_allclose(o, oracle * (i + 1), **TOL)
            sess.serve_drain(timeout=WAIT_S)
            info = _info(sess)
            sess.serve_close(timeout=WAIT_S)
            return info, outs

        (jinfo, jouts), (tinfo, touts) = (run(p) for p in pkgs)
        assert _approx(jinfo, tinfo), (jinfo, tinfo)
        for a, b in zip(jouts, touts):
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
        assert tinfo["placed"]["slice"] == 4
        assert {sl["id"] for sl in tinfo["slices"]} == {0, 1}

    def test_directory_hit_anywhere_answers_without_recompute(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            q = _q(sess)
            out1 = _np(sess.submit(q).result(timeout=WAIT_S))
            sess.serve_drain(timeout=WAIT_S)
            entries = fleet.directory.info()["entries"]
            before = {sl.slice_id: sl.submitted for sl in fleet.slices}
            out2 = _np(sess.submit(q).result(timeout=WAIT_S))
            np.testing.assert_array_equal(out2, out1)
            after = {sl.slice_id: sl.submitted for sl in fleet.slices}
            d = fleet.directory.info()
            sess.serve_close(timeout=WAIT_S)
            return entries, before, after, d

        entries, before, after, d = both(pkgs, run)
        assert entries == 1 and after == before
        assert d["hits"] == 1 and d["remote_hits"] == 1

    def test_slice_local_miss_recomputes_and_records_ownership(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            sess.submit(_q(sess).multiply_scalar(2.0)).result(
                timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            d = fleet.directory.info()
            sess.serve_close(timeout=WAIT_S)
            return d

        d = both(pkgs, run)
        assert d["entries"] == 2 and d["misses"] >= 2

    def test_migration_replicates_hot_entry_under_budget(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p, fleet_replicate_hits=1)
            fleet = sess._ensure_fleet()
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            fkey = p.placement.fleet_key(q, fleet._names)
            owner = fleet.directory.lookup(fkey).owner
            sess.submit(q).result(timeout=WAIT_S)
            fleet.quiesce_replication(timeout=30)
            migrations = fleet.migrations
            rec = fleet.directory.lookup(fkey)
            other = 1 - owner
            repl = fleet.slice_by_id(other).session
            ent = repl._result_cache.lookup(rec.replicas[other])
            stamp = dict(ent.fleet)
            entries = repl._result_cache.info()["entries"]
            sess.submit(q).result(timeout=WAIT_S)
            sess.submit(q).result(timeout=WAIT_S)
            fleet.quiesce_replication(timeout=30)
            out = (owner, migrations, _dir_rec(rec), stamp, entries,
                   fleet.migrations)
            sess.serve_close(timeout=WAIT_S)
            return out

        owner, migr, rec, stamp, entries, migr2 = both(pkgs, run)
        assert migr == 1 and (1 - owner) in rec[6]
        assert entries >= 1 and stamp["owner"] == owner
        assert migr2 == 1

    def test_migration_priced_out_by_peak_budget(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p, fleet_replicate_hits=1,
                                     reshard_peak_budget_bytes=64)
            fleet = sess._ensure_fleet()
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            fkey = p.placement.fleet_key(q, fleet._names)
            rec = fleet.directory.lookup(fkey)
            ent = fleet.slice_by_id(rec.owner).session._result_cache \
                .lookup(rec.owner_key)
            big = dataclasses.replace(rec, nbytes=1 << 30, layout="2d")
            target = fleet.slice_by_id(1 - rec.owner)
            fleet._replicate_entry(q, fkey, big, ent, "default", target)
            first = (fleet.migrations, fleet.migrations_priced_out)
            live = fleet.directory.lookup(fkey)
            memo = target.slice_id in live.priced_out
            live.hits[target.slice_id] = 99
            fleet._maybe_replicate(q, fkey, live, ent, "default", target)
            fleet.quiesce_replication(timeout=30)
            out = first, memo, fleet.migrations_priced_out
            sess.serve_close(timeout=WAIT_S)
            return out

        assert both(pkgs, run) == ((0, 1), True, 1)

    def test_replication_disabled_at_zero(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p, fleet_replicate_hits=0)
            fleet = sess._ensure_fleet()
            for _ in range(4):
                sess.submit(_q(sess)).result(timeout=WAIT_S)
                sess.serve_drain(timeout=WAIT_S)
            out = fleet.migrations, fleet.directory.info()
            sess.serve_close(timeout=WAIT_S)
            return out

        assert both(pkgs, run)[0] == 0


class TestFailover:
    def test_kill_slice_requeues_with_futures_intact(self, pkgs):
        def run(p):
            sess, mats = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sl = fleet.slices[0]
            pipe = sl.session._ensure_serve()
            futs = []
            for i in range(3):
                fut = Future()
                e = fleet._rebind(_q(sess).multiply_scalar(float(i + 1)),
                                  sl)
                pipe._q.put((e, fut, time.perf_counter(), "default",
                             None, "tenantA", None), "tenantA")
                futs.append(fut)
            requeued = fleet.kill_slice(0)
            sess.serve_drain(timeout=WAIT_S)
            oracle = mats["A"] @ mats["B"]
            for i, f in enumerate(futs):
                np.testing.assert_allclose(_np(f.result(timeout=WAIT_S)),
                                           oracle * (i + 1), **TOL)
            out = (requeued, fleet.slices[0].alive, fleet.failovers,
                   fleet.requeued)
            sess.serve_close(timeout=WAIT_S)
            return out

        assert both(pkgs, run) == (3, False, 1, 3)

    def test_failover_preserves_tenant_attribution(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(
                p, serve_tenant_weights="tenantA:2,tenantB:1")
            fleet = sess._ensure_fleet()
            sl = fleet.slices[0]
            pipe = sl.session._ensure_serve()
            fut = Future()
            pipe._q.put((fleet._rebind(_q(sess), sl), fut,
                         time.perf_counter(), "default", None, "tenantA",
                         None), "tenantA")
            target = fleet.slices[1].session._ensure_serve()
            target._ensure_worker = lambda: None
            fleet.kill_slice(0)
            depths = target._q.tenant_depths()
            del target._ensure_worker
            target._ensure_worker()
            sess.serve_drain(timeout=WAIT_S)
            ok = fut.result(timeout=WAIT_S) is not None
            sess.serve_close(timeout=WAIT_S)
            return depths, ok

        assert both(pkgs, run) == ({"tenantA": 1}, True)

    def test_expired_entry_fails_typed_on_failover(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sl = fleet.slices[0]
            pipe = sl.session._ensure_serve()
            fut = Future()
            dl = p.Deadline(0.01)
            time.sleep(0.005)
            pipe._q.put((fleet._rebind(_q(sess), sl), fut,
                         time.perf_counter(), "default", dl, "", None), "")
            time.sleep(0.02)
            fleet.kill_slice(0)
            with pytest.raises(p.errors.DeadlineExceeded):
                fut.result(timeout=10)
            sess.serve_close(timeout=WAIT_S)
            return fleet.requeued

        assert both(pkgs, run) == 0

    def test_failover_disabled_fails_typed(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p, fleet_failover=False)
            fleet = sess._ensure_fleet()
            sl = fleet.slices[0]
            pipe = sl.session._ensure_serve()
            fut = Future()
            pipe._q.put((fleet._rebind(_q(sess), sl), fut,
                         time.perf_counter(), "default", None, "", None),
                        "")
            fleet.kill_slice(0)
            with pytest.raises(p.errors.FleetSliceLost) as ei:
                fut.result(timeout=10)
            sess.serve_close(timeout=WAIT_S)
            return str(ei.value)

        assert "failover disabled" in both(pkgs, run)

    def test_no_survivors_is_typed(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            fleet.kill_slice(0)
            fleet.kill_slice(1)
            with pytest.raises(p.errors.FleetSliceLost) as ei:
                sess.submit(_q(sess)).result(timeout=10)
            sess.serve_close(timeout=WAIT_S)
            return str(ei.value), fleet.failovers

        msg, failovers = both(pkgs, run)
        assert "no live slices" in msg and failovers == 2

    def test_wedged_worker_detected_on_submit(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sl = fleet.slices[0]
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            pipe = sl.session._serve
            if pipe is None:
                sl = fleet.slices[1]
                pipe = sl.session._serve
            pipe._stop.set()
            pipe._worker.join(timeout=10)
            dead = not pipe._worker.is_alive()
            pipe._stop.clear()
            fut = Future()
            pipe._q.put((fleet._rebind(_q(sess).multiply_scalar(3.0), sl),
                         fut, time.perf_counter(), "default", None, "",
                         None), "")
            fleet.check_health()
            out = dead, sl.alive, fleet.failovers
            sess.serve_drain(timeout=WAIT_S)
            ok = fut.result(timeout=WAIT_S) is not None
            sess.serve_close(timeout=WAIT_S)
            return out + (ok,)

        assert both(pkgs, run) == (True, False, 1, True)

    def test_dead_slice_directory_records_drop(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            fkey = p.placement.fleet_key(q, fleet._names)
            fleet.kill_slice(fleet.directory.lookup(fkey).owner)
            gone = fleet.directory.lookup(fkey) is None
            ok = sess.submit(q).result(timeout=WAIT_S) is not None
            sess.serve_close(timeout=WAIT_S)
            return gone, ok

        assert both(pkgs, run) == (True, True)

    def test_readmit_into_closed_survivor_fails_typed(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            dead = fleet.slice_by_id(0)
            dead.alive = False
            fleet.slice_by_id(1).session._ensure_serve().close(timeout=30)
            fut = Future()
            entry = (fleet._rebind(q, dead), fut, time.perf_counter(),
                     "default", None, "", None)
            n = fleet._readmit([(entry, "")], dead)
            with pytest.raises(p.errors.FleetSliceLost):
                fut.result(timeout=5)
            sess.serve_close(timeout=WAIT_S)
            return n

        assert both(pkgs, run) == 0

    def test_replica_eviction_falls_back_to_owner(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p, fleet_replicate_hits=1)
            fleet = sess._ensure_fleet()
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            fkey = p.placement.fleet_key(q, fleet._names)
            sess.submit(q).result(timeout=WAIT_S)
            fleet.quiesce_replication(timeout=30)
            rec = fleet.directory.lookup(fkey)
            (repl_id, repl_key), = list(rec.replicas.items())
            fleet.slice_by_id(repl_id).session._result_cache.drop(repl_key)
            fleet.config = dataclasses.replace(fleet.config,
                                               fleet_replicate_hits=0)
            before = fleet.directory.info()["invalidated"]
            hit = fleet._directory_answer(q, fkey, "default", repl_id)
            rec2 = fleet.directory.lookup(fkey)
            out = (hit is not None, rec2 is not None,
                   repl_id in rec2.replicas,
                   fleet.directory.info()["invalidated"] - before)
            sess.serve_close(timeout=WAIT_S)
            return out

        assert both(pkgs, run) == (True, True, False, 0)


class TestCatalogWriteThrough:
    def test_idempotent_reregister_is_a_fleet_noop(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            d0, gen0 = fleet.directory.info(), fleet.directory.reg_gen
            sess.register("A", sess.catalog["A"])
            out = (d0, fleet.directory.reg_gen - gen0,
                   fleet.directory.info())
            sess.serve_close(timeout=WAIT_S)
            return out

        d0, dgen, d1 = both(pkgs, run)
        assert d0["entries"] >= 1 and dgen == 0
        assert d1["entries"] == d0["entries"]
        assert d1["invalidated"] == d0["invalidated"]

    def test_unreplicable_table_pins_up_front(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            coo = p.COO.from_edges(
                np.array([0, 1, 2]), np.array([1, 2, 0]),
                np.ones(3, dtype=np.float32), shape=(64, 64))
            sess.register("S", coo)
            e = coo.expr().multiply(sess.table("B").expr())
            pinned0 = fleet.pinned
            out = _np(sess.submit(e).result(timeout=WAIT_S))
            res = (id(coo) in fleet._names,
                   p.placement.fleet_key(e, fleet._names),
                   fleet.pinned - pinned0, out.shape)
            sess.serve_close(timeout=WAIT_S)
            return res, out

        (rj, oj), (rt, ot) = (run(p) for p in pkgs)
        assert rj == rt == (False, None, 1, (64, 64))
        np.testing.assert_allclose(ot, oj, rtol=1e-5, atol=1e-5)

    def test_register_replicates_and_invalidates(self, pkgs):
        def run(p):
            sess, mats = _fleet_session(p)
            fleet = sess._ensure_fleet()
            out1 = _np(sess.submit(_q(sess)).result(timeout=WAIT_S))
            sess.serve_drain(timeout=WAIT_S)
            e0 = fleet.directory.info()["entries"]
            newA = np.random.default_rng(7).standard_normal(
                (64, 64)).astype(np.float32)
            sess.register("A", sess.from_numpy(newA))
            e1 = fleet.directory.info()["entries"]
            held = all("A" in sl.session.catalog for sl in fleet.slices)
            out2 = _np(sess.submit(_q(sess)).result(timeout=WAIT_S))
            np.testing.assert_allclose(out2, newA @ mats["B"], **TOL)
            changed = not np.allclose(out1, out2)
            sess.serve_close(timeout=WAIT_S)
            return e0, e1, held, changed

        assert both(pkgs, run) == (1, 0, True, True)

    def test_rebind_invalidates_directory_before_replication(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            seen = {}
            orig = fleet._replicate

            def spy(name, matrix):
                seen["entries"] = fleet.directory.info()["entries"]
                seen["gen"] = fleet.directory.reg_gen
                return orig(name, matrix)

            gen0 = fleet.directory.reg_gen
            fleet._replicate = spy
            try:
                sess.register("A", sess.from_numpy(
                    np.ones((64, 64), np.float32)))
            finally:
                fleet._replicate = orig
            sess.serve_close(timeout=WAIT_S)
            return seen, gen0

        seen, gen0 = both(pkgs, run)
        assert seen == {"entries": 0, "gen": gen0 + 1}


class TestDirectoryHygiene:
    def test_no_ownership_record_when_slice_insert_declined(self, pkgs):
        def run(p):
            cfg = p.Config(fleet_slices=2, result_cache_max_bytes=1024)
            sess = p.Session(mesh=p.mesh, config=cfg)
            for nm, a in _arrays().items():
                sess.register(nm, sess.from_numpy(a))
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            n = sess._ensure_fleet().directory.info()["inserts"]
            sess.serve_close(timeout=WAIT_S)
            return n

        assert both(pkgs, run) == 0

    def test_close_tears_down_killed_slices(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            fleet.kill_slice(0)
            sess.serve_close(timeout=30)
            out = []
            for sl in fleet.slices:
                pipe = sl.session._serve
                if pipe is None:
                    out.append(None)
                    continue
                if pipe._worker is not None:
                    pipe._worker.join(timeout=10)
                out.append((pipe.closed, pipe._stop.is_set(),
                            pipe._worker is None
                            or not pipe._worker.is_alive()))
            return out

        got = both(pkgs, run)
        assert all(r is None or r == (True, True, True) for r in got)

    def test_close_sweeps_past_a_wedged_slice(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            boom = p.errors.DrainTimeout(0.0, 1)

            def wedge(timeout=None):
                raise boom

            live_close = fleet.slices[0].session.serve_close
            fleet.slices[0].session.serve_close = wedge
            stopped = []

            class _Exp:
                def stop(self):
                    stopped.append(True)

            sess._exporter = _Exp()
            with pytest.raises(p.errors.DrainTimeout):
                sess.serve_close(timeout=30)
            other = fleet.slices[1].session._serve
            parent = sess._serve
            sess._exporter = None
            live_close(timeout=WAIT_S)
            return (stopped, other is None or other.closed,
                    parent is None or parent.closed)

        assert both(pkgs, run) == ([True], True, True)

    def test_drain_covers_killed_slices(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            fleet.kill_slice(0)
            drained = []
            for sl in fleet.slices:
                orig = sl.session.serve_drain
                sl.session.serve_drain = (
                    lambda timeout=None, _i=sl.slice_id, _o=orig:
                    (drained.append(_i), _o(timeout=timeout))[1])
            sess.serve_drain(timeout=30)
            dead = {sl.slice_id for sl in fleet.slices if not sl.alive}
            sess.serve_close(timeout=WAIT_S)
            return drained, sorted(dead)

        drained, dead = both(pkgs, run)
        assert set(drained) == {0, 1}
        assert all(i in dead for i in drained[-len(dead):])


class TestDirectoryBounds:
    def _rec(self, mod, key, dep="A", owner=0):
        return mod.DirectoryRecord(
            owner=owner, owner_key=key, nbytes=8, layout="rep",
            dtype="float32", dep_names=frozenset({dep}))

    def test_lru_eviction_at_max(self, pkgs):
        def run(p):
            d = p.fleet.FleetDirectory(2)
            for i in range(3):
                d.record_insert(f"k{i}", self._rec(p.fleet, f"lk{i}"))
            return d.info(), d.lookup("k0") is None

        info, gone = both(pkgs, run)
        assert info["entries"] == 2 and info["evicted"] == 1 and gone

    def test_invalidate_by_name(self, pkgs):
        def run(p):
            d = p.fleet.FleetDirectory(8)
            d.record_insert("k1", self._rec(p.fleet, "a", "A"))
            d.record_insert("k2", self._rec(p.fleet, "b", "B", 1))
            n = d.invalidate_name("A")
            return n, d.lookup("k1") is None, d.lookup("k2") is not None

        assert both(pkgs, run) == (1, True, True)

    def test_claim_replica_refuses_across_generations(self, pkgs):
        def run(p):
            d = p.fleet.FleetDirectory(8)
            d.record_insert("K", self._rec(p.fleet, "k0"))
            staged = d.reg_gen
            d.invalidate_name("A")
            d.record_insert("K", self._rec(p.fleet, "k0b"))
            stale = d.claim_replica("K", 1, "k1", expected_gen=staged)
            absent = 1 not in d.lookup("K").replicas
            fresh = d.claim_replica("K", 1, "k1", expected_gen=d.reg_gen)
            return stale, absent, fresh, d.info()

        got = both(pkgs, run)
        assert got[:3] == (False, True, True)

    def test_drop_replica_keeps_owner_record(self, pkgs):
        def run(p):
            d = p.fleet.FleetDirectory(8)
            rec = self._rec(p.fleet, "k0")
            rec.replicas[1] = "k1"
            d.record_insert("K", rec)
            d.drop_replica("K", 1)
            kept = d.lookup("K")
            return (kept is not None, 1 not in kept.replicas,
                    d.info()["invalidated"])

        assert both(pkgs, run) == (True, True, 0)


# ---------------------------------------------------------------------------
# MV114
# ---------------------------------------------------------------------------


def _diags(ds):
    return [(d.code, d.severity, d.message) for d in ds]


class TestMV114:
    def _leaf_pair(self, p):
        rng = np.random.default_rng(0)
        A = p.BM.from_numpy(rng.random((64, 64), np.float32), mesh=p.mesh)
        B = p.BM.from_numpy(rng.random((64, 64), np.float32), mesh=p.mesh)
        return A.expr().multiply(B.expr())

    def _run(self, p, root, cfg=None):
        return _diags(p.placement_pass.check_placement_stamps(
            root, p.mesh, cfg or p.Config()))

    def test_registered_in_pipeline(self, pkgs):
        for p in pkgs:
            assert any(name == "placement"
                       for name, _ in p.analysis.PASSES)

    def test_stale_weights_flagged(self, pkgs):
        def run(p):
            e = self._leaf_pair(p).with_attrs(placement={
                "mode": "span", "weights": [1.0, 2.0], "dcn_axis": 1,
                "dcn_weight": 2.0})
            return self._run(p, e)

        assert any(c == "MV114" and "topology" in m
                   for c, _s, m in both(pkgs, run))

    def test_unpriced_cut_flagged(self, pkgs):
        def run(p):
            e = self._leaf_pair(p).with_attrs(placement={
                "mode": "span", "weights": [1.0, 1.5], "dcn_axis": 1,
                "dcn_weight": 1.0})
            return self._run(p, e, p.Config(axis_cost_weights=(1.0, 1.5)))

        assert any(c == "MV114" and "DCN axis weight" in m
                   for c, _s, m in both(pkgs, run))

    def test_fresh_span_stamp_quiet(self, pkgs):
        def run(p):
            cfg = p.Config(fleet_slices=2, axis_cost_weights=(1.0, 1.5))
            e = self._leaf_pair(p)
            dec = p.placement.decide(
                e, cfg, p.mesh_lib.axis_weights(p.mesh, cfg), **KW)
            return self._run(p, e.with_attrs(placement=dec.stamp()), cfg)

        assert both(pkgs, run) == []

    def test_slice_mode_stamp_not_checked(self, pkgs):
        def run(p):
            return self._run(p, self._leaf_pair(p).with_attrs(
                placement={"mode": "slice", "weights": [9.0, 9.0]}))

        assert both(pkgs, run) == []

    @pytest.mark.parametrize("owner_dtype,flagged", [("float64", True),
                                                     ("float32", False)])
    def test_replica_dtype_stamp(self, pkgs, owner_dtype, flagged):
        def run(p):
            M = p.BM.from_numpy(np.ones((64, 64), np.float32), mesh=p.mesh)
            leaf = p.expr.leaf(M).with_attrs(result_cache={
                "key_hash": "x", "layout": "rep", "dtype": "float32",
                "deps": [], "fleet": {"owner": 0, "layout": "rep",
                                      "dtype": owner_dtype}})
            return self._run(p, leaf.t())

        got = both(pkgs, run)
        assert any(c == "MV114" and "dtype" in m
                   for c, _s, m in got) == flagged

    def test_end_to_end_span_plan_verifies_clean(self, pkgs):
        def run(p):
            cfg = p.Config(fleet_slices=2, verify_plans="error",
                           result_cache_max_bytes=1 << 28)
            sess = p.Session(mesh=p.mesh, config=cfg)
            for nm, a in _arrays().items():
                sess.register(nm, sess.from_numpy(a))
            adhoc = sess.from_numpy(np.ones((64, 64), np.float32))
            e = sess.table("A").expr().multiply(adhoc.expr())
            ok = sess.submit(e).result(timeout=WAIT_S) is not None
            placed = sess.fleet_info()["placed"]
            sess.serve_close(timeout=WAIT_S)
            return ok, placed

        ok, placed = both(pkgs, run)
        assert ok and placed["span"] >= 1

    def test_fleet_written_stamps_verify_clean(self, pkgs):
        """MV114 over the stamps the port's own fleet writes: a span
        submission's ``placement`` stamp and a replicated entry's
        ``fleet`` provenance, lifted into a plan by a consumer query."""
        def run(p):
            sess, _ = _fleet_session(p, fleet_replicate_hits=1,
                                     verify_plans="error")
            fleet = sess._ensure_fleet()
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            sess.submit(q).result(timeout=WAIT_S)
            fleet.quiesce_replication(timeout=30)
            rec = fleet.directory.lookup(p.placement.fleet_key(
                q, fleet._names))
            (rid, rkey), = rec.replicas.items()
            repl = fleet.slice_by_id(rid).session
            ent = repl._result_cache.lookup(rkey)
            leaf = repl._rc_leaf(ent)
            diags = _diags(p.placement_pass.check_placement_stamps(
                leaf.t(), repl.mesh, repl.config))
            sess.serve_close(timeout=WAIT_S)
            return dict(ent.fleet), diags

        stamp, diags = both(pkgs, run)
        assert set(stamp) == {"owner", "layout", "dtype"} and diags == []


    def test_provenance_pass_over_fleet_records(self, pkgs):
        """The provenance pass over the ledger records the fleet itself
        writes — a directory hit (``fleet_directory``) and a hit on a
        replica (``fleet_replica``): no diagnostic, and the same paths
        and fleet hops as the JAX package's."""
        def run(p):
            sess, _ = _fleet_session(p, fleet_replicate_hits=1,
                                     obs_provenance=32)
            fleet = sess._ensure_fleet()
            q = _q(sess)
            for _ in range(4):
                sess.submit(q).result(timeout=WAIT_S)
                sess.serve_drain(timeout=WAIT_S)
                fleet.quiesce_replication(timeout=30)
            diags = _diags(p.mod("analysis.provenance_pass")
                           .verify_ledger(sess))
            recs = [(r["path"], r.get("fleet"), r.get("slice"))
                    for r in sess.why(last=10)]
            sess.serve_close(timeout=WAIT_S)
            return diags, recs

        diags, recs = both(pkgs, run)
        assert diags == []
        paths = [r[0] for r in recs]
        assert "fleet_directory" in paths
        assert all(f is not None for pth, f, _s in recs
                   if pth.startswith("fleet_"))


# ---------------------------------------------------------------------------
# default-config bit-identity
# ---------------------------------------------------------------------------


class TestFleetOffBitIdentity:
    def test_zero_fleet_objects_poisoned_init(self, pkgs, monkeypatch):
        def poisoned(self, *a, **k):
            raise AssertionError(
                "fleet object constructed with fleet_slices=0")

        outs = []
        for p in pkgs:
            monkeypatch.setattr(p.fleet.FleetController, "__init__",
                                poisoned)
            monkeypatch.setattr(p.fleet.FleetDirectory, "__init__",
                                poisoned)
            sess = p.Session(mesh=p.mesh, config=p.Config())
            mats = _arrays(32)
            for nm, a in mats.items():
                sess.register(nm, sess.from_numpy(a))
            out = _np(sess.run(_q(sess)))
            np.testing.assert_allclose(out, mats["A"] @ mats["B"], **TOL)
            assert sess.submit(_q(sess).multiply_scalar(2.0)).result(
                timeout=WAIT_S) is not None
            sess.serve_drain(timeout=WAIT_S)
            assert sess._fleet is None and sess.fleet_info() is None
            assert sess._exec_lock is None
            sess.serve_close(timeout=WAIT_S)
            outs.append(out)
        np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-5)

    def test_fleet_lazy_until_first_submit(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            lazy = sess._fleet is None
            sess.run(_q(sess))
            after_run = sess._fleet is None
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            built = sess._fleet is not None
            sess.serve_close(timeout=WAIT_S)
            return lazy, after_run, built

        assert both(pkgs, run) == (True, True, True)

    @pytest.mark.parametrize("kw", [{"fleet_slices": -1},
                                    {"fleet_span_margin": 0},
                                    {"fleet_directory_max": 0},
                                    {"fleet_replicate_hits": -1}])
    def test_config_validation(self, pkgs, kw):
        for p in pkgs:
            with pytest.raises(ValueError, match=next(iter(kw))):
                p.Config(**kw)

    def test_arbitrated_run_is_plan_run_without_fleet(self, monkeypatch):
        """Without a fleet ``_arbitrated_run`` is ``plan.run`` (no lock
        taken, no sync); with one it runs under the fleet's shared
        execution lock."""
        from matrel_tpu_torch.config import MatrelConfig
        from matrel_tpu_torch.session import MatrelSession
        sess = MatrelSession(config=MatrelConfig(), device="cpu")
        A = sess.from_numpy(np.eye(8, dtype=np.float32))
        plan = sess.compile(A.expr().t())
        calls = []
        monkeypatch.setattr(type(plan), "run",
                            lambda self, bindings=None: calls.append(
                                bindings) or "ran")
        assert sess._exec_lock is None
        assert sess._arbitrated_run(plan, bindings=None) == "ran"
        fs = MatrelSession(config=MatrelConfig(fleet_slices=2),
                           device="cpu")
        fleet = fs._ensure_fleet()
        assert fs._exec_lock is fleet._exec_lock
        assert all(sl.session._exec_lock is fleet._exec_lock
                   for sl in fleet.slices)
        held = []
        monkeypatch.setattr(type(plan), "run",
                            lambda self, bindings=None: held.append(
                                fleet._exec_lock._is_owned()) or "ran")
        assert fs._arbitrated_run(plan) == "ran" and held == [True]


# ---------------------------------------------------------------------------
# obs surfaces
# ---------------------------------------------------------------------------


class TestFleetObs:
    def test_placement_events_and_summary(self, pkgs, tmp_path):
        def run(p):
            log = str(tmp_path / f"{p.name}.jsonl")
            sess, _ = _fleet_session(p, obs_level="on", obs_event_log=log)
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            sess.serve_close(timeout=WAIT_S)
            events = p.events.read_events(log)
            placements = _events(log, "placement")
            tagged = sorted({e.get("slice") for e in events
                             if e.get("kind") == "query"
                             and e.get("slice") is not None})
            s = p.history.summarize(events)
            return (placements, tagged, _untimed(s["fleet"]),
                    "fleet:" in p.history.render_summary(events))

        placements, tagged, roll, rendered = both(pkgs, run)
        assert len(placements) == 2
        assert placements[0]["routed"] == "slice"
        assert placements[1]["routed"] in ("directory", "directory_remote")
        assert placements[0]["coeff_source"] in ("analytic", "measured")
        assert tagged and roll["placements"] == 2 and roll["slices"]
        assert rendered

    def test_fleet_event_on_kill(self, pkgs, tmp_path):
        def run(p):
            log = str(tmp_path / f"{p.name}.jsonl")
            sess, _ = _fleet_session(p, obs_level="on", obs_event_log=log)
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            sess._fleet.kill_slice(0)
            sess.serve_close(timeout=WAIT_S)
            return _events(log, "fleet")

        evs = both(pkgs, run)
        assert any(e.get("event") == "slice_kill" for e in evs)

    def test_migrate_event_records_reshard_pricing(self, pkgs, tmp_path):
        def run(p):
            log = str(tmp_path / f"{p.name}.jsonl")
            sess, _ = _fleet_session(p, obs_level="on", obs_event_log=log,
                                     fleet_replicate_hits=1)
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            sess.submit(q).result(timeout=WAIT_S)
            sess._fleet.quiesce_replication(timeout=30)
            sess.serve_close(timeout=WAIT_S)
            return [e for e in _events(log, "fleet")
                    if e.get("event") == "migrate"]

        evs = both(pkgs, run)
        assert len(evs) == 1 and evs[0]["fleet"]["migrations"] == 1
        assert evs[0]["est_dcn_cost"] == evs[0]["nbytes"] * 8.0

    def test_export_snapshot_and_top_show_fleet(self, pkgs):
        def run(p):
            sess, _ = _fleet_session(p)
            sess.submit(_q(sess)).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            snap = p.export.snapshot(sess)
            text = p.top.render(snap)
            sess.serve_close(timeout=WAIT_S)
            return snap["fleet"], text.splitlines()[1:]

        fl, lines = both(pkgs, run)
        assert len(fl["slices"]) == 2
        text = "\n".join(lines)
        assert "fleet: 2 slice(s)" in text
        assert "slice 0:" in text and "slice 1:" in text

    def test_no_fleet_snapshot_is_none(self, pkgs):
        for p in pkgs:
            sess = p.Session(mesh=p.mesh, config=p.Config())
            assert p.export.snapshot(sess)["fleet"] is None


# ---------------------------------------------------------------------------
# registration-plane locking
# ---------------------------------------------------------------------------


class TestRegistrationPlaneLocking:
    def test_replicate_runs_outside_controller_lock(self, pkgs):
        def run(p):
            sess, mats = _fleet_session(p, n=32)
            try:
                sess.submit(_q(sess)).result(timeout=WAIT_S)
                fc = sess._fleet
                orig = fc._replicate
                seen = {}

                def spy(name, matrix):
                    def probe():
                        free = fc._lock.acquire(blocking=False)
                        if free:
                            fc._lock.release()
                        seen["controller_free"] = free
                        reg_free = fc._reg_lock.acquire(blocking=False)
                        if reg_free:
                            fc._reg_lock.release()
                        seen["reg_held"] = not reg_free

                    t = threading.Thread(target=probe, daemon=True)
                    t.start()
                    t.join(timeout=30)
                    return orig(name, matrix)

                fc._replicate = spy
                sess.register("A", sess.from_numpy(mats["A"]))
                return seen
            finally:
                sess.serve_close(timeout=30)

        assert both(pkgs, run) == {"controller_free": True,
                                   "reg_held": True}

    def test_rebind_storm_with_concurrent_kill(self, pkgs):
        def run(p):
            sess, mats = _fleet_session(p, n=32)
            try:
                sess.submit(_q(sess)).result(timeout=WAIT_S)
                done = threading.Event()

                def rebinder():
                    for _ in range(4):
                        sess.register("A", sess.from_numpy(mats["A"]))
                    done.set()

                t = threading.Thread(target=rebinder, daemon=True)
                t.start()
                sess._fleet.kill_slice(0)
                out = _np(sess.submit(_q(sess)).result(timeout=WAIT_S))
                t.join(timeout=60)
                np.testing.assert_allclose(out, mats["A"] @ mats["B"],
                                           rtol=3e-3, atol=3e-3)
                return done.is_set()
            finally:
                sess.serve_close(timeout=30)

        assert both(pkgs, run) is True


# ---------------------------------------------------------------------------
# the card's form: shared slices on the 1 x 1 grid
# ---------------------------------------------------------------------------


class TestSharedOneCard:
    def test_shared_slices_share_tables_and_answer_bit_equal(self):
        """On the 1 x 1 grid the slices share the parent's tables (no
        copy), answer bit-equal to one plain session, and a repeat from
        the other slice answers through the directory."""
        from matrel_tpu_torch.config import MatrelConfig
        from matrel_tpu_torch.session import MatrelSession
        mats = _arrays()
        plain = MatrelSession(device="cpu")
        fs = MatrelSession(config=MatrelConfig(
            fleet_slices=2, result_cache_max_bytes=1 << 28), device="cpu")
        for s in (plain, fs):
            for nm, a in mats.items():
                s.register(nm, s.from_numpy(a))
        want = _np(plain.compute(_q(plain)))
        got = _np(fs.submit(_q(fs)).result(timeout=WAIT_S))
        fs.serve_drain(timeout=WAIT_S)
        np.testing.assert_array_equal(got, want)
        fleet = fs._fleet
        assert fleet.source == "shared"
        for sl in fleet.slices:
            assert sl.session.mesh is fs.mesh
            assert sl.session.catalog["A"] is fs.catalog["A"]
        again = _np(fs.submit(_q(fs)).result(timeout=WAIT_S))
        np.testing.assert_array_equal(again, want)
        assert fleet.directory.info()["hits"] == 1
        fs.serve_close(timeout=WAIT_S)

    def test_bf16_replica_keeps_dtype_and_bits(self, pkgs):
        """bf16 tables on virtual slices: the port rebuilds each slice's
        replica of a table, and of a hot entry, in its own dtype — the
        slices answer in bf16 as the parent does, the entry's replica is
        bit-equal to the owner's, and MV114 is quiet over it. The JAX
        package rebuilds both through its ``from_numpy`` default dtype,
        f32: its slices compute the product in f32."""
        got = {}
        for p in pkgs:
            sess = p.Session(mesh=p.mesh, config=p.Config(
                fleet_slices=2, result_cache_max_bytes=1 << 28,
                fleet_replicate_hits=1))
            for nm, a in _arrays().items():
                sess.register(nm, sess.from_numpy(a, dtype="bfloat16"))
            fleet = sess._ensure_fleet()
            q = _q(sess)
            sess.submit(q).result(timeout=WAIT_S)
            sess.serve_drain(timeout=WAIT_S)
            sess.submit(q).result(timeout=WAIT_S)
            fleet.quiesce_replication(timeout=30)
            rec = fleet.directory.lookup(p.placement.fleet_key(
                q, fleet._names))
            (rid, rkey), = rec.replicas.items()
            repl = fleet.slice_by_id(rid).session
            ent = repl._result_cache.lookup(rkey)
            own = fleet.slice_by_id(rec.owner).session._result_cache \
                .lookup(rec.owner_key)
            diags = _diags(p.placement_pass.check_placement_stamps(
                repl._rc_leaf(ent).t(), repl.mesh, repl.config))
            got[p.name] = (ent.dtype, rec.dtype, _np(ent.result),
                           _np(own.result), diags,
                           str(fleet.slices[0].session.catalog["A"]
                               .dtype).replace("torch.", ""))
            sess.serve_close(timeout=WAIT_S)
        dt, owner_dt, val, own_val, diags, table_dt = got["torch"]
        assert dt == owner_dt == table_dt == "bfloat16" and diags == []
        np.testing.assert_array_equal(val, own_val)
        jdt, jowner_dt, jval, jown_val, jdiags, jtable_dt = got["jax"]
        assert jdt == jowner_dt == jtable_dt == "float32" and jdiags == []
        np.testing.assert_array_equal(jval, jown_val)
        # the same bf16 inputs: the f32 product and the bf16 one agree to
        # bf16 rounding
        np.testing.assert_allclose(val, jval, rtol=1e-2, atol=0.1)


class TestHealthProbe:
    def test_worker_being_started_is_not_wedged(self, pkgs):
        """A submit enqueues and then starts its slice's worker under the
        pipeline's lock; between the two the worker thread exists but
        is not alive. The port's health probe waits for that lock, so a
        concurrent submit never mistakes the window for a wedge. The
        JAX package's probe reads without the lock and kills the
        healthy slice."""
        alive = {}
        for p in pkgs:
            sess, _ = _fleet_session(p)
            fleet = sess._ensure_fleet()
            sl = fleet.slices[0]
            pipe = sl.session._ensure_serve()
            fut = Future()
            probe = threading.Thread(target=fleet.check_health,
                                     daemon=True)
            with pipe._lock:
                pipe._q.put((fleet._rebind(_q(sess), sl), fut,
                             time.perf_counter(), "default", None, "",
                             None), "")
                pipe._worker = threading.Thread(target=lambda: None)
                probe.start()
                probe.join(timeout=1.0)
                pipe._worker = None
                if sl.alive:
                    pipe._ensure_worker()
            probe.join(timeout=30)
            alive[p.name] = (sl.alive, fleet.failovers)
            assert fut.result(timeout=WAIT_S) is not None
            sess.serve_close(timeout=WAIT_S)
        assert alive["torch"] == (True, 0)
        assert alive["jax"] == (False, 1)
