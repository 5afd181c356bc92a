"""PyTorch port: incremental view maintenance (``ir/delta.py``,
``serve/ivm.py``, ``session.register_delta``) held against the JAX
package on the CPU, mirroring ``tests/test_delta.py`` (all but its MV113
and obs classes, which belong to the analysis and obs planes): the
MatrixDelta forms, per-rule patch-vs-fresh equivalence (integer queries
bit-exact), the S×S dispatch of a sparse delta, the refine hook (a
tensor it returns stays on its device) and the PageRank warm restart (in
float64 over the session's binding, on its device), the fallback to the
transitive kill, pricing (the
estimate, force/off modes, a measured autotune ``ivm|`` winner),
generation prefixes, precision-tier isolation, steady-state patch-plan
reuse, the reconciliation of orphaned patch programs, the decision
records' delta pricing, and the default-config bit identity — then a
4-tick ``StreamingGraph`` through both packages with every dashboard
answer equal.

Every scenario runs in both packages over the same seeded numpy inputs
and the same deltas. ``register_delta``'s summaries are equal field for
field (less its wall-clock ``ms``), and so are the cache counters and
the entries (keys with id() tokens numbered by first appearance,
generation and precision prefixes, rules, composed error bounds).
Tolerances are the JAX tests': exact for integer queries, 2e-4
(1e-3 for the low-rank Gram) of the largest |entry| otherwise, atol
1e-4 for the sparse patch; answers agree with the JAX package's within
1e-5 relative, PageRank vectors within ``PR_ATOL``.
"""

import dataclasses
import gc
import hashlib
import re
import weakref

import jax
import numpy as np
import pytest
import torch

from matrel_tpu import executor as j_exec
from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.coo import COOMatrix as JCOO
from matrel_tpu.core.sparse import BlockSparseMatrix as JBSM
from matrel_tpu.ir import delta as j_delta
from matrel_tpu.ir import expr as JE
from matrel_tpu.parallel import autotune as j_at
from matrel_tpu.session import MatrelSession as JSession
from matrel_tpu.workloads import streaming as j_stream

from matrel_tpu_torch import executor as t_exec
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.coo import COOMatrix as TCOO
from matrel_tpu_torch.core.sparse import BlockSparseMatrix as TBSM
from matrel_tpu_torch.ir import delta as delta_lib
from matrel_tpu_torch.ir import expr as TE
from matrel_tpu_torch.parallel import autotune as t_at
from matrel_tpu_torch.serve.result_cache import (CacheEntry, ResultCache,
                                                 result_nbytes)
from matrel_tpu_torch.session import MatrelSession
from matrel_tpu_torch.workloads import streaming as t_stream

RC = dict(result_cache_max_bytes=256 << 20)
#: The PageRank warm restart against the JAX package's: both iterate in
#: float64, numpy's products in BLAS's reduction order and the port's in
#: ATen's, so the rank vectors (entries ~1/n) agree to a few f64 ulps.
PR_ATOL = 1e-15


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


class Pkg:
    """One package's classes, so a scenario runs against either."""

    def __init__(self, jax_side: bool):
        self.jax = jax_side
        self.delta = j_delta if jax_side else delta_lib
        self.E = JE if jax_side else TE
        self.BSM = JBSM if jax_side else TBSM
        self.COO = JCOO if jax_side else TCOO
        self.exec = j_exec if jax_side else t_exec
        self.stream = j_stream if jax_side else t_stream


J, T = Pkg(True), Pkg(False)


def sess_of(pkg, jmesh, **cfg):
    if pkg.jax:
        js = JSession(mesh=jmesh, config=JConfig(**cfg))
        # jax's CPU device_put may alias an aligned host array: the
        # scenarios (and StreamingGraph) keep mutating theirs as the
        # host oracle, so the JAX side gets a private copy
        js.from_numpy = lambda arr, **kw: JSession.from_numpy(
            js, np.array(arr, copy=True), **kw)
        return js
    return MatrelSession(config=MatrelConfig(**cfg), device="cpu")


def int_adj(rng, n):
    a = (rng.random((n, n)) < 0.06).astype(np.float32)
    a = np.triu(a, 1)
    return a + a.T


def coo_batch(rng, n, k, vals=None):
    rows = rng.integers(0, n, k)
    cols = rng.integers(0, n, k)
    v = np.ones(k, np.float32) if vals is None else vals
    return rows, cols, v


_ID = re.compile(r"((?:sparse_leaf|coo_leaf|leaf|fnid|fnrec|cyc|cell|"
                 r"obj:\w+|bigcont:\w+):)(\d+)")


def norm(key: str) -> str:
    ids: dict = {}
    return _ID.sub(lambda m: m.group(1)
                   + f"#{ids.setdefault(m.group(2), len(ids))}", key)


def state(s):
    ents = []
    for k, e in s._result_cache.items_snapshot():
        assert e.key_hash == hashlib.sha1(k.encode()).hexdigest()[:16]
        ents.append((norm(k), e.layout, e.dtype, e.nbytes, e.prec,
                     e.err_bound, e.delta_gen, e.delta_rule,
                     len(e.dep_ids)))
    return s.result_cache_info(), ents


def summary(s):
    """register_delta's record less its wall clock."""
    return {k: v for k, v in s.items() if k != "ms"}


def both(jmesh, scenario, cfg=RC, seed=7):
    """Run ``scenario(pkg, session, rng)`` in both packages from the
    same seed; assert the returned records and the cache state equal;
    return the two scenario results (JAX first)."""
    outs = []
    for pkg in (J, T):
        s = sess_of(pkg, jmesh, **cfg)
        out = scenario(pkg, s, np.random.default_rng(seed))
        outs.append((out, state(s)))
    (jo, jst), (to, tst) = outs
    assert tst == jst
    return jo, to


def records_equal(got, want):
    """Decision records equal field for field but the package-local
    node uid (floats to 1e-12 relative)."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = {k: v for k, v in g.items() if k != "uid"}
        w = {k: v for k, v in w.items() if k != "uid"}
        assert set(g) == set(w), (sorted(g), sorted(w))
        for k in w:
            if isinstance(w[k], (float, list)):
                assert g[k] == pytest.approx(w[k], rel=1e-12), k
            else:
                assert g[k] == w[k], k


def agree(t_out, j_out, exact):
    t_out, j_out = np.asarray(t_out), np.asarray(j_out)
    if exact:
        np.testing.assert_array_equal(t_out, j_out)
    else:
        scale = max(float(np.abs(j_out).max()), 1.0)
        np.testing.assert_allclose(t_out / scale, j_out / scale,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# MatrixDelta forms
# ---------------------------------------------------------------------------


class TestMatrixDelta:
    def test_coo_factors_reconstruct(self, rng):
        s = MatrelSession(device="cpu")
        old = s.from_numpy(int_adj(rng, 64), integral=True)
        rows, cols, v = coo_batch(rng, 64, 9)
        d = delta_lib.as_delta((rows, cols, v), old, "coo")
        u, vv = d.factors(s.mesh, MatrelConfig())
        np.testing.assert_array_equal(u.to_numpy() @ vv.to_numpy().T,
                                      d.to_dense_numpy())
        assert d.rank == 9 and d.integral
        assert u.integral and vv.integral

    def test_lowrank_and_dense_kinds(self, rng):
        s = MatrelSession(device="cpu")
        old = s.from_numpy(rng.standard_normal((48, 32)).astype(
            np.float32))
        U = rng.standard_normal((48, 3)).astype(np.float32)
        V = rng.standard_normal((32, 3)).astype(np.float32)
        d = delta_lib.as_delta((U, V), old, "lowrank")
        np.testing.assert_allclose(d.to_dense_numpy(), U @ V.T, rtol=1e-6)
        dd = delta_lib.as_delta(U @ V.T, old, "dense")
        assert dd.rank is None and dd.kind == "dense"
        assert d.signature() == ("lowrank", (48, 32), 3, False)

    def test_auto_disambiguation_and_validation(self, jmesh):
        msgs = []
        for pkg in (J, T):
            s = sess_of(pkg, jmesh)
            old = s.from_numpy(np.zeros((16, 16), np.float32))
            coo = pkg.COO.from_edges([1, 2], [3, 4], shape=(16, 16))
            assert pkg.delta.as_delta(coo, old).kind == "coo"
            got = []
            for payload, kind in ((([99], [0], [1.0]), "coo"),
                                  (np.zeros((4, 4), np.float32), "dense"),
                                  (np.zeros((16, 16)), "bogus"),
                                  ((np.zeros(3), np.zeros((2, 2))),
                                   "auto")):
                with pytest.raises(ValueError) as ei:
                    pkg.delta.as_delta(payload, old, kind)
                got.append(str(ei.value))
            msgs.append(got)
        assert msgs[1] == msgs[0]

    @pytest.mark.parametrize("kind", ["coo", "lowrank", "dense"])
    def test_apply_to_dense_matches_jax(self, jmesh, kind):
        def scenario(pkg, s, rng):
            a = int_adj(rng, 40)
            old = s.from_numpy(a, integral=True)
            if kind == "coo":
                payload = coo_batch(rng, 40, 7)
            elif kind == "lowrank":
                payload = (rng.integers(-1, 2, (40, 2)).astype(np.float32),
                           rng.integers(-1, 2, (40, 2)).astype(np.float32))
            else:
                payload = rng.integers(-1, 2, (40, 40)).astype(np.float32)
            d = pkg.delta.as_delta(payload, old, kind)
            new = d.apply_to(old, s.mesh, s.config)
            return (new.to_numpy(), new.integral, new.int_abs_max, new.nnz)
        (jv, ji, ja, jn), (tv, ti, ta, tn) = both(jmesh, scenario)
        np.testing.assert_array_equal(tv, jv)
        assert (ti, ta, tn) == (ji, ja, jn)

    @pytest.mark.parametrize("bs,k", [(16, 7), (8, 0), (16, 40)])
    def test_apply_to_block_sparse_tile_set(self, jmesh, bs, k):
        """The port rebuilds only the touched tiles; values and the kept
        tile set equal the JAX package's dense rebuild (tiles left all
        zero drop)."""
        def scenario(pkg, s, rng):
            a = int_adj(rng, 64)
            a[:bs, :bs] = 0.0
            a[0, 1] = 1.0                   # one tile a delta clears
            sp = pkg.BSM.from_numpy(a, block_size=bs, mesh=s.mesh)
            rows, cols, v = coo_batch(rng, 64, k)
            rows, cols = np.append(rows, 0), np.append(cols, 1)
            v = np.append(v, -1.0).astype(np.float32)
            d = pkg.delta.as_delta((rows, cols, v), sp, "coo")
            new = d.apply_to(sp, s.mesh, s.config)
            tiles = sorted(zip(np.asarray(new.block_rows).tolist(),
                               np.asarray(new.block_cols).tolist()))
            return new.to_numpy(), tiles, new.block_size
        (jv, jt, jb), (tv, tt, tb) = both(jmesh, scenario)
        np.testing.assert_array_equal(tv, jv)
        assert tt == jt and tb == jb

    def test_rank_above_bound_loses_factored_form(self, rng):
        s = MatrelSession(device="cpu")
        old = s.from_numpy(np.zeros((64, 64), np.float32))
        d = delta_lib.as_delta(coo_batch(rng, 64, 12), old, "coo")
        assert d.factors(s.mesh, MatrelConfig(delta_rank_max=8)) is None
        assert d.factors(s.mesh, MatrelConfig(delta_rank_max=16)) \
            is not None


# ---------------------------------------------------------------------------
# Per-rule patch-vs-fresh equivalence
# ---------------------------------------------------------------------------


def stream_check(pkg, s, rng, make_query, oracle, name, make_delta,
                 steps, exact, tol=2e-4):
    """Cold run, then per step: one delta (advancing the host oracle),
    register, re-run — the re-run must hit a patched entry and match
    the oracle. Returns the summaries and answers."""
    s.run(make_query())
    recs, answers = [], []
    for _ in range(steps):
        info0 = s.result_cache_info()
        payload, kind = make_delta()
        recs.append(summary(s.register_delta(name, payload, kind=kind)))
        got = s.run(make_query()).to_numpy()
        info1 = s.result_cache_info()
        assert info1["hits"] > info0["hits"], "re-run did not hit"
        assert info1["patched"] > info0["patched"], "nothing patched"
        want = np.asarray(oracle(), np.float32).reshape(got.shape)
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            scale = max(float(np.abs(want).max()), 1.0)
            np.testing.assert_allclose(got / scale, want / scale,
                                       atol=tol)
        answers.append(got)
    return recs, answers


RULE_CASES = ["matmul_left", "matmul_right", "gram_lowrank",
              "elemwise_scalar", "row_sum", "sum"]


def rule_scenario(case):
    def scenario(pkg, s, rng):
        n = {"gram_lowrank": 128, "elemwise_scalar": 64}.get(case, 96)
        if case == "gram_lowrank":
            x = rng.standard_normal((n, 24)).astype(np.float32)
            s.register("X", s.from_numpy(x))
            st = {"x": x}

            def mk():
                return s.table("X").expr().t().multiply(
                    s.table("X").expr())

            def delta():
                U = rng.standard_normal((n, 2)).astype(np.float32)
                V = rng.standard_normal((24, 2)).astype(np.float32)
                st["x"] = st["x"] + U @ V.T
                return (U, V), "lowrank"

            return stream_check(pkg, s, rng, mk,
                                lambda: st["x"].T @ st["x"], "X", delta,
                                2, exact=False, tol=1e-3)
        a = int_adj(rng, n)
        s.register("A", s.from_numpy(a, integral=True))
        st = {"a": a}
        f = rng.standard_normal((n, 24)).astype(np.float32)
        g = rng.standard_normal((16, n)).astype(np.float32)
        b = rng.standard_normal((n, n)).astype(np.float32)
        s.register("F", s.from_numpy(f))
        s.register("G", s.from_numpy(g))
        s.register("B", s.from_numpy(b))
        A = lambda: s.table("A").expr()          # noqa: E731
        mk, oracle, exact = {
            "matmul_left": (lambda: A().multiply(s.table("F").expr()),
                            lambda: st["a"] @ f, False),
            "matmul_right": (lambda: s.table("G").expr().multiply(A()),
                             lambda: g @ st["a"], False),
            "elemwise_scalar": (
                lambda: A().elem_multiply(s.table("B").expr())
                .multiply_scalar(3.0).add(s.table("B").expr()),
                lambda: st["a"] * b * 3.0 + b, False),
            "row_sum": (lambda: A().row_sum(),
                        lambda: st["a"].sum(1, keepdims=True), True),
            "sum": (lambda: A().sum(),
                    lambda: st["a"].sum().reshape(1, 1), True),
        }[case]

        def delta():
            rows, cols, v = coo_batch(rng, n, 4)
            np.add.at(st["a"], (rows, cols), v)
            return (rows, cols, v), "coo"

        return stream_check(pkg, s, rng, mk, oracle, "A", delta, 2,
                            exact=exact)
    return scenario


class TestRulePatchEquivalence:
    @pytest.mark.parametrize("case", RULE_CASES)
    def test_rule(self, jmesh, case):
        (jrecs, jans), (trecs, tans) = both(jmesh, rule_scenario(case))
        assert trecs == jrecs
        exact = case in ("row_sum", "sum")
        for t, j in zip(tans, jans):
            agree(t, j, exact)

    def test_triangle_trace_exact_via_known_propagation(self, jmesh):
        def scenario(pkg, s, rng):
            n = 96
            a = int_adj(rng, n)
            s.register("A", s.from_numpy(a, integral=True))
            A = lambda: s.table("A").expr()      # noqa: E731
            s.run(A().multiply(A()))
            s.run(A().multiply(A()).multiply(A()).trace())
            recs = []
            for _ in range(3):
                rows, cols, v = coo_batch(rng, n, 4)
                np.add.at(a, (rows, cols), v)
                rec = s.register_delta("A", (rows, cols, v), kind="coo")
                assert rec["patched"] == 2 and rec["killed"] == 0
                assert rec["rules"].get("known", 0) >= 1
                recs.append(summary(rec))
                np.testing.assert_array_equal(
                    s.run(A().multiply(A())).to_numpy(), a @ a)
                np.testing.assert_array_equal(
                    s.run(A().multiply(A()).multiply(A()).trace())
                    .to_numpy(),
                    np.float32(np.trace(a @ a @ a)).reshape(1, 1))
            return recs
        jrecs, trecs = both(jmesh, scenario)
        assert trecs == jrecs

    def test_sparse_delta_spgemm_dispatch(self, jmesh):
        cfg = dict(RC, delta_patch_mode="force")

        def scenario(pkg, s, rng):
            n, bs = 128, 16

            def tiles(k):
                m = np.zeros((n, n), np.float32)
                for _ in range(k):
                    bi = int(rng.integers(0, n // bs))
                    bj = int(rng.integers(0, n // bs))
                    blk = (rng.random((bs, bs)) < 0.2).astype(np.float32)
                    m[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] = blk
                return m
            a, b = tiles(5), tiles(5)
            s.register("SA", pkg.BSM.from_numpy(a, block_size=bs,
                                                 mesh=s.mesh))
            s.register("SB", pkg.BSM.from_numpy(b, block_size=bs,
                                                 mesh=s.mesh))

            def mk():
                return pkg.E.matmul(pkg.E.as_expr(s.table("SA")),
                                    pkg.E.as_expr(s.table("SB")))
            s.run(mk())
            rows, cols, v = coo_batch(rng, n, 6)
            np.add.at(a, (rows, cols), v)
            old = s.table("SA")
            d = pkg.delta.as_delta((rows, cols, v), old, "coo")
            new = d.apply_to(old, s.mesh, s.config)
            ent = s._result_cache.items_snapshot()[0][1]
            spec = pkg.delta.derive_patch(ent.expr, old, new, d,
                                          ent.result, s.mesh, s.config)
            assert spec is not None
            assert spec.rule == "spgemm" and not spec.rebindable
            rec = s.register_delta("SA", (rows, cols, v), kind="coo")
            assert rec["patched"] == 1
            got = s.run(mk()).to_numpy()
            np.testing.assert_allclose(got, a @ b, atol=1e-4)
            return (summary(rec), spec.rules, spec.err_bound,
                    spec.est_patch_flops, spec.est_full_flops)
        jo, to = both(jmesh, scenario, cfg=cfg)
        assert to == jo

    def test_repeated_sparse_deltas_recompile(self, rng):
        """An S×S patch plan bakes this generation's sparse payloads, so
        the port never re-runs it for the next same-signature delta: each
        generation compiles its own and stays right."""
        s = MatrelSession(config=MatrelConfig(delta_patch_mode="force",
                                              **RC), device="cpu")
        n, bs = 64, 16
        a = np.zeros((n, n), np.float32)
        a[0:16, 16:32] = (rng.random((16, 16)) < 0.3)
        a[32:48, 0:16] = (rng.random((16, 16)) < 0.3)
        b = a.T.copy()
        s.register("SA", TBSM.from_numpy(a, block_size=bs, mesh=s.mesh))
        s.register("SB", TBSM.from_numpy(b, block_size=bs, mesh=s.mesh))

        def mk():
            return TE.matmul(TE.as_expr(s.table("SA")),
                             TE.as_expr(s.table("SB")))
        s.run(mk())
        for _ in range(3):
            rows, cols, v = coo_batch(rng, n, 4)
            np.add.at(a, (rows, cols), v)
            rec = s.register_delta("SA", (rows, cols, v), kind="coo")
            assert rec["patched"] == 1 and rec["reused_plans"] == 0
            assert rec["rules"].get("spgemm")
            np.testing.assert_allclose(s.run(mk()).to_numpy(), a @ b,
                                       atol=1e-4)
        assert s._delta_plane.stats["patch_compiles"] == 3
        assert s._delta_plane._programs == {}

    def test_refine_hook_warm_restart(self, jmesh):
        def scenario(pkg, s, rng):
            n = 48
            a = int_adj(rng, n)
            s.register("A", s.from_numpy(a, integral=True))
            calls = []

            def refine(old_result, new_matrix, d):
                calls.append(1)
                return new_matrix.to_numpy().sum(1, keepdims=True)

            def mk():
                return pkg.delta.stamp_refine(
                    s.table("A").expr().row_sum(), refine)
            s.run(mk())
            rows, cols, v = coo_batch(rng, n, 3)
            np.add.at(a, (rows, cols), v)
            rec = s.register_delta("A", (rows, cols, v), kind="coo")
            assert rec["patched"] == 1 and rec["rules"] == {"refine": 1}
            assert calls == [1]
            np.testing.assert_array_equal(s.run(mk()).to_numpy(),
                                          a.sum(1, keepdims=True))
            return summary(rec)
        jo, to = both(jmesh, scenario)
        assert to == jo

    def test_refine_hook_tensor_stays_on_its_device(self, jmesh,
                                                   monkeypatch):
        """A refine hook that hands back a tensor: the refined entry is
        built from it where it lies, never through a host copy, and
        answers as the JAX package's (which receives the same values as
        an array)."""
        def scenario(pkg, s, rng):
            n = 40
            a = int_adj(rng, n)
            s.register("A", s.from_numpy(a, integral=True))

            def refine(old_result, new_matrix, d):
                # one function for both packages (the key hashes its
                # code and closure): a tensor binding sums on its device
                if isinstance(new_matrix.data, torch.Tensor):
                    return new_matrix.data[:n, :n].sum(1)
                return new_matrix.to_numpy().sum(1)

            def mk():
                return pkg.delta.stamp_refine(
                    s.table("A").expr().row_sum(), refine)
            s.run(mk())
            rows, cols, v = coo_batch(rng, n, 5)
            np.add.at(a, (rows, cols), v)
            if not pkg.jax:
                from matrel_tpu_torch.core.blockmatrix import BlockMatrix

                def no_host(*_a, **_k):
                    raise AssertionError("refined tensor went to the host")
                monkeypatch.setattr(BlockMatrix, "from_numpy",
                                    classmethod(no_host))
            rec = s.register_delta("A", (rows, cols, v), kind="coo")
            monkeypatch.undo()
            assert rec["patched"] == 1 and rec["rules"] == {"refine": 1}
            out = s.run(mk())
            np.testing.assert_array_equal(out.to_numpy(),
                                          a.sum(1, keepdims=True))
            return summary(rec), out.padded_shape, out.integral
        jo, to = both(jmesh, scenario)
        assert to == jo

    def test_pagerank_warm_restart_converges(self, rng):
        a = int_adj(rng, 64).astype(np.float64)
        ta = torch.from_numpy(a)
        u = np.full(64, 1 / 64)
        cold = delta_lib.pagerank_warm_restart(ta, u, rounds=300)
        assert cold.dtype == torch.float64 and cold.device == ta.device
        np.testing.assert_allclose(
            cold.numpy(), j_delta.pagerank_warm_restart(a, u, rounds=300),
            rtol=0, atol=PR_ATOL)
        np.add.at(a, (rng.integers(0, 64, 4), rng.integers(0, 64, 4)),
                  1.0)
        ta = torch.from_numpy(a).float()     # any dtype: run in float64
        cold2 = delta_lib.pagerank_warm_restart(ta, u, rounds=300)
        warm = delta_lib.pagerank_warm_restart(ta, cold, rounds=40)
        np.testing.assert_allclose(
            warm.numpy(), j_delta.pagerank_warm_restart(a, cold.numpy(),
                                                        rounds=40),
            rtol=0, atol=PR_ATOL)
        assert float((warm - cold2).abs().sum()) < 1e-8
        assert float((warm - cold2).abs().sum()) <= float((
            delta_lib.pagerank_warm_restart(ta, u, rounds=5)
            - cold2).abs().sum())


# ---------------------------------------------------------------------------
# Eligibility fallback + pricing
# ---------------------------------------------------------------------------


def pricing_scenario(case):
    def scenario(pkg, s, rng):
        n = 64
        a = int_adj(rng, n)
        s.register("A", s.from_numpy(a, integral=True))
        A = lambda: s.table("A").expr()          # noqa: E731
        if case == "ineligible":
            s.run(A().select_value(lambda v: v > 0.5))
            payload = coo_batch(rng, n, 3)
        elif case in ("priced_out", "force"):
            s.run(A().multiply(A()))
            payload = coo_batch(rng, n, n)        # a rank-n delta
        else:                                     # off
            s.run(A().row_sum())
            payload = ([1], [2], [1.0])
        rec = s.register_delta("A", payload, kind="coo")
        np.add.at(a, (payload[0], payload[1]), payload[2])
        if case == "ineligible":
            got = s.run(A().select_value(lambda v: v > 0.5)).to_numpy()
            np.testing.assert_array_equal(got, a * (a > 0.5))
        elif case == "force":
            np.testing.assert_array_equal(
                s.run(A().multiply(A())).to_numpy(), a @ a)
        return summary(rec)
    return scenario


class TestEligibilityAndPricing:
    @pytest.mark.parametrize("case,cfg,want", [
        ("ineligible", RC, {"patched": 0, "killed": 1}),
        ("priced_out", RC, {"patched": 0, "killed": 1, "priced_out": 1}),
        ("force", dict(RC, delta_patch_mode="force"),
         {"patched": 1, "priced_out": 0}),
        ("off", dict(RC, delta_patch_mode="off"),
         {"patched": 0, "killed": 1}),
    ])
    def test_fallback_and_modes(self, jmesh, case, cfg, want):
        jo, to = both(jmesh, pricing_scenario(case), cfg=cfg)
        assert to == jo
        assert {k: to[k] for k in want} == want

    def test_measured_ivm_winner_overrides_estimate(self, jmesh,
                                                    tmp_path,
                                                    monkeypatch):
        table = str(tmp_path / "tab.json")
        cfg = dict(RC, autotune=True, autotune_table_path=table)
        n = 96
        # the persisted row the JAX test writes, in each package's own
        # key (the backend field differs: "cpu" in both here)
        t_key = t_at._ivm_key("rank_k", n, 1, 1, "cpu")
        j_key = j_at._ivm_key("rank_k", n, 1, 1)
        assert t_key == j_key
        j_at._persist(table, j_key, "recompute",
                      {"patch": 2.0, "recompute": 1.0})
        j_at._IVM_CACHE.clear()
        j_at._TABLE_CACHE.clear()
        t_at.clear_caches()

        def scenario(pkg, s, rng):
            a = int_adj(rng, n)
            s.register("A", s.from_numpy(a, integral=True))
            s.run(s.table("A").expr().row_sum())
            rec = s.register_delta("A", ([1], [2], [1.0]), kind="coo")
            assert rec["patched"] == 0 and rec["priced_out"] == 1
            assert s._delta_plane.stats["measured_overrides"] == 1
            return summary(rec)
        jo, to = both(jmesh, scenario, cfg=cfg)
        assert to == jo
        t_at.clear_caches()

    def test_ivm_key_format_accepted_and_pruned(self):
        for k, ok in (("ivm|rank_k|1024|2x4|cpu", True),
                      ("ivm|spgemm|512|2x4|cuda|w1x8", True),
                      ("ivm|retired_rule|1024|2x4|cpu", False),
                      ("ivm|rank_k|1024|2x4", False)):
            assert t_at._current_key_format(k) is ok
        assert t_at.DELTA_RULES == delta_lib.DELTA_RULES \
            == j_delta.DELTA_RULES

    def test_lookup_or_measure_ivm(self, tmp_path):
        s = MatrelSession(device="cpu")
        cfg = MatrelConfig(autotune=True,
                           autotune_table_path=str(tmp_path / "t.json"))
        t_at.clear_caches()
        # a tie is no winner: persisted as measured, best None
        assert t_at.lookup_or_measure_ivm(
            "linear", 64, s.mesh, cfg, patch_s=lambda: 1.0,
            full_s=lambda: 1.0) is None
        row = t_at.load_table(str(tmp_path / "t.json"))[
            t_at._ivm_key("linear", 64, 1, 1, "cpu")]
        assert row["best"] is None and set(row["times"]) == {
            "patch", "recompute"}
        t_at.clear_caches()
        # no runners: no measurement, no negative caching
        assert t_at.lookup_or_measure_ivm("rank_k_both", 64, s.mesh,
                                          cfg) is None
        assert t_at._IVM_CACHE == {}
        # a clear winner persists, and the row replays with no runner
        assert t_at.lookup_or_measure_ivm(
            "rank_k", 64, s.mesh, cfg, patch_s=lambda: 1.0,
            full_s=lambda: 5.0) == "patch"
        t_at.clear_caches()
        assert t_at.lookup_or_measure_ivm("rank_k", 64, s.mesh,
                                          cfg) == "patch"
        t_at.clear_caches()


# ---------------------------------------------------------------------------
# Generation isolation + steady state
# ---------------------------------------------------------------------------


class TestGenerationIsolation:
    def test_keys_carry_generation_prefix(self, jmesh):
        def scenario(pkg, s, rng):
            n = 64
            a = int_adj(rng, n)
            b = rng.standard_normal((n, n)).astype(np.float32)
            s.register("A", s.from_numpy(a, integral=True))
            s.register("B", s.from_numpy(b))
            s.run(s.table("A").expr().row_sum())
            s.run(s.table("B").expr().row_sum())
            keys0 = [k for k, _ in s._result_cache.items_snapshot()]
            assert all(not k.startswith("delta:") for k in keys0)
            rec = s.register_delta("A", ([1], [2], [1.0]), kind="coo")
            assert rec["gen"] == 1 and rec["rekeyed"] == 1
            keys1 = [k for k, _ in s._result_cache.items_snapshot()]
            assert keys1 and all(k.startswith("delta:1|") for k in keys1)
            info0 = s.result_cache_info()
            s.run(s.table("B").expr().row_sum())
            assert s.result_cache_info()["hits"] == info0["hits"] + 1
            rec2 = s.register_delta("A", ([3], [4], [1.0]), kind="coo")
            assert rec2["gen"] == 2
            keys2 = [k for k, _ in s._result_cache.items_snapshot()]
            assert keys2 and all(k.startswith("delta:2|") for k in keys2)
            return [summary(rec), summary(rec2),
                    s._rc_key_prefix("default"), s._rc_key_prefix("fast")]
        jo, to = both(jmesh, scenario)
        assert to == jo
        assert to[2:] == ["delta:2|", "delta:2|prec:fast|"]

    def test_precision_prefix_survives_patching(self, jmesh):
        def scenario(pkg, s, rng):
            n = 64
            a = int_adj(rng, n)
            f = rng.standard_normal((n, 8)).astype(np.float32)
            s.register("A", s.from_numpy(a, integral=True))
            s.register("F", s.from_numpy(f))

            def mk():
                return s.table("A").expr().multiply(s.table("F").expr())
            s.run(mk(), precision="fast")
            rec = s.register_delta("A", ([1], [2], [1.0]), kind="coo")
            keys = [k for k, _ in s._result_cache.items_snapshot()]
            assert len(keys) == 1
            assert keys[0].startswith("delta:1|prec:fast|")
            info0 = s.result_cache_info()
            s.run(mk(), precision="fast")
            assert s.result_cache_info()["hits"] == info0["hits"] + 1
            s.run(mk(), precision="exact")
            assert s.result_cache_info()["misses"] > info0["misses"]
            return summary(rec)
        jo, to = both(jmesh, scenario)
        assert to == jo

    def test_patch_plan_reuse_steady_state(self, jmesh):
        def scenario(pkg, s, rng):
            n = 96
            a = int_adj(rng, n)
            s.register("A", s.from_numpy(a, integral=True))
            s.run(s.table("A").expr().row_sum())
            recs = []
            for gen in range(1, 4):
                rows, cols, v = coo_batch(rng, n, 3)
                np.add.at(a, (rows, cols), v)
                rec = s.register_delta("A", (rows, cols, v), kind="coo")
                assert rec["patched"] == 1
                assert rec["reused_plans"] == (0 if gen == 1 else 1)
                recs.append(summary(rec))
            assert s._delta_plane.stats["patch_compiles"] == 1
            assert s._delta_plane.stats["patch_reuses"] == 2
            np.testing.assert_array_equal(
                s.run(s.table("A").expr().row_sum()).to_numpy(),
                a.sum(1, keepdims=True))
            return recs
        jo, to = both(jmesh, scenario)
        assert to == jo

    def test_rebound_leaves_are_released(self, rng):
        """A kept patch plan holds shape-only stand-ins for its rebound
        leaves: no generation's tensors outlive its tick."""
        s = MatrelSession(config=MatrelConfig(**RC), device="cpu")
        n = 64
        a = int_adj(rng, n)
        f = rng.standard_normal((n, 8)).astype(np.float32)
        s.register("A", s.from_numpy(a, integral=True))
        s.register("F", s.from_numpy(f))
        q = lambda: s.table("A").expr().multiply(    # noqa: E731
            s.table("F").expr())
        s.run(q())
        refs = []
        for _ in range(3):
            refs.append(weakref.ref(s.table("A").data))
            rows, cols, v = coo_batch(rng, n, 3)
            np.add.at(a, (rows, cols), v)
            s.register_delta("A", (rows, cols, v), kind="coo")
            np.testing.assert_allclose(s.run(q()).to_numpy(),
                                       a @ f, rtol=2e-4, atol=2e-4)
        gc.collect()
        # generation 0 stays pinned by the cold query's cached plan
        # (the plan cache's contract); every later one is gone
        assert refs[0]() is not None
        assert all(r() is None for r in refs[1:])
        (prog,) = s._delta_plane._programs.values()
        roles = [l for l in prog.plan.leaf_order if "ivm_role" in l.attrs]
        assert roles and all(l.attrs["matrix"].data.device.type == "meta"
                             for l in roles)

    def test_signature_change_recompiles(self, jmesh):
        def scenario(pkg, s, rng):
            n = 96
            s.register("A", s.from_numpy(int_adj(rng, n), integral=True))
            s.run(s.table("A").expr().row_sum())
            s.register_delta("A", coo_batch(rng, n, 3), kind="coo")
            rec = s.register_delta("A", coo_batch(rng, n, 5), kind="coo")
            assert rec["reused_plans"] == 0 and rec["patched"] == 1
            assert s._delta_plane.stats["patch_compiles"] == 2
            return summary(rec)
        jo, to = both(jmesh, scenario)
        assert to == jo

    def test_known_propagation_is_tier_namespaced(self, jmesh):
        def scenario(pkg, s, rng):
            n = 96
            a = int_adj(rng, n)
            s.register("A", s.from_numpy(a, integral=True))

            def mk():
                return s.table("A").expr().multiply(s.table("A").expr())
            s.run(mk(), precision="fast")
            s.run(mk())
            rows, cols, v = coo_batch(rng, n, 4)
            np.add.at(a, (rows, cols), v)
            rec = s.register_delta("A", (rows, cols, v), kind="coo")
            assert rec["patched"] == 2
            np.testing.assert_array_equal(s.run(mk()).to_numpy(), a @ a)
            return summary(rec)
        jo, to = both(jmesh, scenario)
        assert to == jo

    def test_patch_programs_reconciled_after_kill(self, jmesh):
        def scenario(pkg, s, rng):
            n = 64
            a = int_adj(rng, n)
            s.register("A", s.from_numpy(a, integral=True))
            s.run(s.table("A").expr().row_sum())
            s.register_delta("A", ([1], [2], [1.0]), kind="coo")
            assert len(s._delta_plane._programs) == 1
            s.register("A", s.from_numpy(a, integral=True))
            assert s.result_cache_info()["entries"] == 0
            s.run(s.table("A").expr().row_sum())
            s.register_delta("A", ([3], [4], [1.0]), kind="coo")
            live = {e.ivm_id for _k, e in
                    s._result_cache.items_snapshot()}
            assert set(s._delta_plane._programs) == live
            return len(s._delta_plane._programs)
        jo, to = both(jmesh, scenario)
        assert to == jo == 1

    def test_apply_patch_budget_failure_restores_old(self, rng):
        rc_ = ResultCache()
        s = MatrelSession(device="cpu")
        bm = s.from_numpy(rng.standard_normal((32, 32)).astype(np.float32))
        ent = CacheEntry(key_hash="k", result=bm, pins=(),
                         dep_ids=frozenset({1}), layout="2d",
                         dtype="float32", nbytes=result_nbytes(bm))
        assert rc_.put("old", ent, 1 << 20)
        big = dataclasses.replace(ent, nbytes=2 << 20)
        assert not rc_.apply_patch("old", "new", big, 1 << 20)
        assert rc_.lookup("old") is ent
        assert rc_.patched == 0
        assert rc_.drop("old", keep_stale=True, stale_max=4,
                        stale_max_bytes=1 << 20)
        assert rc_.invalidated == 1
        assert rc_.info()["stale_entries"] == 1

    def test_register_delta_unbound_name_raises(self):
        s = MatrelSession(config=MatrelConfig(**RC), device="cpu")
        with pytest.raises(KeyError, match="not a bound"):
            s.register_delta("nope", ([0], [0], [1.0]), kind="coo")

    def test_plain_register_still_invalidates(self, jmesh):
        def scenario(pkg, s, rng):
            n = 64
            a = int_adj(rng, n)
            s.register("A", s.from_numpy(a, integral=True))
            s.run(s.table("A").expr().row_sum())
            s.register_delta("A", ([1], [2], [1.0]), kind="coo")
            assert s.result_cache_info()["entries"] == 1
            s.register("A", s.from_numpy(a, integral=True))
            assert s.result_cache_info()["entries"] == 0
        both(jmesh, scenario)

    def test_matmul_decisions_carry_delta_pricing(self, jmesh):
        def scenario(pkg, s, rng):
            n = 96
            a = int_adj(rng, n)
            f = rng.standard_normal((n, 16)).astype(np.float32)
            s.register("A", s.from_numpy(a, integral=True))
            s.register("F", s.from_numpy(f))
            s.run(s.table("A").expr().multiply(s.table("F").expr()))
            s.register_delta("A", ([1], [2], [1.0]), kind="coo")
            _key, ent = s._result_cache.items_snapshot()[0]
            prog = s._delta_plane._programs[ent.ivm_id]
            decs = pkg.exec.plan_matmul_decisions(prog.plan)
            assert decs
            for d in decs:
                assert d["delta_rule"] in pkg.delta.DELTA_RULES
                assert isinstance(d["delta_est_saved_flops"],
                                  (int, float))
            assert prog.plan.meta["ivm"]["est_saved_flops"] > 0
            return decs, prog.plan.meta["ivm"]
        (jdecs, jivm), (tdecs, tivm) = both(jmesh, scenario)
        records_equal(tdecs, jdecs)
        assert tivm == jivm

    def test_patched_entry_stamp_equals_jax(self, jmesh):
        """A patched entry consumed as an interior leaf carries the
        ``result_cache`` stamp with its ``delta`` provenance (generation,
        rule, composed error bound), equal to the JAX package's."""
        def scenario(pkg, s, rng):
            n = 64
            a = int_adj(rng, n)
            f = rng.standard_normal((n, 8)).astype(np.float32)
            s.register("A", s.from_numpy(a, integral=True))
            s.register("F", s.from_numpy(f))
            s.run(s.table("A").expr().multiply(s.table("F").expr()),
                  precision="fast")
            s.run(s.table("A").expr().row_sum())
            s.register_delta("A", ([1], [2], [1.0]), kind="coo")
            stamps = []
            for q, sla in ((s.table("A").expr().row_sum(), "default"),
                           (s.table("A").expr().multiply(
                               s.table("F").expr()), "fast")):
                _ent, key, _pins, sub = s._rc_admit(
                    q.multiply_scalar(2.0), s._rc_key_prefix(sla))
                leaf = sub.children[0]
                st = dict(leaf.attrs["result_cache"])
                hits = [k for k, e in s._result_cache.items_snapshot()
                        if e.key_hash == st["key_hash"]]
                assert len(hits) == 1 and hits[0].startswith(
                    s._rc_key_prefix(sla))
                st.pop("key_hash")
                st["deps"] = len(st["deps"])
                stamps.append((norm(key), st))
            return stamps
        jo, to = both(jmesh, scenario)
        assert to == jo
        assert to[0][1]["delta"]["gen"] == 1
        assert to[0][1]["delta"]["err_bound"] == 0.0      # exact int
        assert to[1][1]["delta"]["err_bound"] > 0.0       # f32 patch


# ---------------------------------------------------------------------------
# Default-config bit identity
# ---------------------------------------------------------------------------


class TestBitIdentity:
    def test_no_delta_objects_without_register_delta(self, rng,
                                                     monkeypatch):
        def boom(self, *a, **k):
            raise AssertionError("MatrixDelta constructed on the "
                                 "default path")
        monkeypatch.setattr(delta_lib.MatrixDelta, "__post_init__", boom)
        s = MatrelSession(config=MatrelConfig(**RC), device="cpu")
        a = int_adj(rng, 48)
        s.register("A", s.from_numpy(a, integral=True))
        s.run(s.table("A").expr().row_sum())
        s.run(s.table("A").expr().row_sum())
        s.register("A", s.from_numpy(a, integral=True))
        s.run(s.table("A").expr().row_sum())
        assert s._delta_plane is None and s._delta_gen == 0
        for k, ent in s._result_cache.items_snapshot():
            assert not k.startswith("delta:")
            assert ent.delta_gen == 0 and ent.ivm_id is None

    def test_construction_counter_quiet_on_serve_traffic(self, rng):
        before = delta_lib._CONSTRUCTED["count"]
        s = MatrelSession(config=MatrelConfig(**RC), device="cpu")
        X = s.from_numpy(rng.standard_normal((32, 8)).astype(np.float32))
        outs = s.run_many([X.expr().t().multiply(X.expr())
                           for _ in range(3)])
        assert len(outs) == 3
        assert delta_lib._CONSTRUCTED["count"] == before

    def test_config_validation(self):
        for cls in (JConfig, MatrelConfig):
            with pytest.raises(ValueError, match="delta_patch_mode"):
                cls(delta_patch_mode="sometimes")
            with pytest.raises(ValueError, match="delta_rank_max"):
                cls(delta_rank_max=0)
            assert cls(delta_patch_mode="FORCE").delta_patch_mode \
                == "force"


# ---------------------------------------------------------------------------
# The streaming dashboard
# ---------------------------------------------------------------------------


class TestStreamingGraph:
    def test_edge_stream_and_delta_arrays_match(self):
        js_, ts_ = (j_stream.EdgeStream(64, 6, 3, seed=5),
                    t_stream.EdgeStream(64, 6, 3, seed=5))
        for _ in range(6):
            (ja, je), (ta, te) = js_.step(), ts_.step()
            np.testing.assert_array_equal(ta, ja)
            np.testing.assert_array_equal(te, je)
            for x, y in zip(t_stream._delta_arrays(ta, te, 24),
                            j_stream._delta_arrays(ja, je, 24)):
                np.testing.assert_array_equal(x, y)
        with pytest.raises(ValueError, match="capacity"):
            t_stream._delta_arrays(ta, te, 2)

    @pytest.mark.parametrize("mode", ["delta", "rebind"])
    def test_four_ticks_through_both_packages(self, jmesh, mode):
        def scenario(pkg, s, rng):
            g = pkg.stream.StreamingGraph(s, n=64, batch_edges=6,
                                          window=3, feature_k=8, seed=3)
            ticks = [g.run_all()]
            recs = []
            for _ in range(4):
                rec = g.step_delta() if mode == "delta" \
                    else g.step_rebind()
                recs.append(summary(rec))
                got = g.run_all()
                want = g.oracle()
                for k in ("degrees", "label_counts", "common_neighbors",
                          "triangles6"):
                    np.testing.assert_array_equal(
                        got[k], np.asarray(want[k], np.float32))
                np.testing.assert_allclose(got["feature_product"],
                                           want["feature_product"],
                                           rtol=2e-4, atol=2e-4)
                ticks.append(got)
            if not pkg.jax:
                # the port iterates over the session's binding on its
                # device, not the host mirror: a wrong mirror changes
                # nothing
                g.adj = np.zeros_like(g.adj)
            prs = [g.pagerank(rounds=8, cold_rounds=60),
                   g.pagerank(rounds=8, cold_rounds=60)]
            return recs, ticks, g.triangle_count(), prs
        (jrecs, jticks, jtri, jpr), (trecs, tticks, ttri, tpr) = both(
            jmesh, scenario)
        assert trecs == jrecs
        assert ttri == jtri
        for t, j in zip(tpr, jpr):
            assert t.dtype == torch.float64
            np.testing.assert_allclose(t.numpy(), j, rtol=0, atol=PR_ATOL)
        for t, j in zip(tticks, jticks):
            assert set(t) == set(j)
            for k in t:
                agree(t[k], j[k], exact=k != "feature_product")
