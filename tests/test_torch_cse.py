"""PyTorch port: multi-query optimization (``serve/mqo.py`` + the
session's hoist and template seams) held against the JAX package on the
CPU, mirroring ``tests/test_cse.py``: cross-query CSE — a batch's shared
interior computes once (matmuls counted over every plan the batch runs),
feeds its consumers as ``cse``-stamped leaves whose stamps, decision
records (``cse_operands``) and ``mqo_info`` counters equal the JAX
package's, and answers bit-equal to the un-hoisted batch — and plan
templates: a structurally identical query over fresh dense leaves
rebinds into the cached plan and compiles nothing (the port counts
``compile_expr``/``compile_exprs`` calls where the JAX test reads its
obs events), isolated by SLA prefix, by leaf identity pattern and by
sparse-leaf identity. With ``cse_enable`` off nothing of the module is
constructed. MV116 (the JAX package's verifier pass) belongs to the
analysis plane, not ported.

Inputs are seeded numpy arrays given to both packages; results agree
with float64 numpy within the JAX tests' 3e-4 (rtol/atol), and with the
JAX package's within 1e-5.
"""

import jax
import numpy as np
import pytest
import scipy.sparse

from matrel_tpu import executor as j_exec
from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.sparse import BlockSparseMatrix as JBSM
from matrel_tpu.session import MatrelSession as JSession

from matrel_tpu_torch import executor as t_exec
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.sparse import BlockSparseMatrix
from matrel_tpu_torch.serve import mqo as mqo_lib
from matrel_tpu_torch.session import MatrelSession

CSE = dict(cse_enable=True)


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


def twins(jmesh, **cfg):
    return (JSession(mesh=jmesh, config=JConfig(**cfg)),
            MatrelSession(config=MatrelConfig(**cfg), device="cpu"))


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


def rand(rng, n, m):
    return rng.standard_normal((n, m)).astype(np.float32)


def gram_batch(X, k=4):
    """k structurally distinct consumers over ONE shared Gram interior
    (a matmul: a fused-region boundary, so a hoist candidate)."""
    g = X.expr().t().multiply(X.expr())
    return [g.multiply_scalar(1.0 + i) for i in range(k)]


def gram_oracles(xn, k=4):
    g = xn.astype(np.float64).T @ xn.astype(np.float64)
    return [g * (1.0 + i) for i in range(k)]


def dispatch_spy(monkeypatch, session_cls, exec_mod):
    """Matmuls of every MultiPlan a batch runs (the compute-once proof)."""
    counts = []
    orig = session_cls._arbitrated_run

    def spy(self, plan, bindings=None):
        counts.append(sum(
            len(d) for d in exec_mod.multiplan_root_decisions(plan)))
        return orig(self, plan, bindings=bindings)

    monkeypatch.setattr(session_cls, "_arbitrated_run", spy)
    return counts


def compile_spy(monkeypatch):
    calls = []
    for name in ("compile_expr", "compile_exprs"):
        orig = getattr(t_exec, name)

        def wrap(*a, _orig=orig, **k):
            calls.append(1)
            return _orig(*a, **k)

        monkeypatch.setattr(t_exec, name, wrap)
    return calls


def find_cse_leaf(e):
    if e.attrs.get("cse") is not None:
        return e
    for c in e.children:
        hit = find_cse_leaf(c)
        if hit is not None:
            return hit
    return None


def stamp_of(sess):
    """The newest substituted tree's cse stamp, less its id-derived
    parts (the key hash and the dep ids, counted)."""
    _orig, sub = sess._mqo.recent[-1]
    st = dict(find_cse_leaf(sub).attrs["cse"])
    assert len(st.pop("key_hash")) == 16
    st["deps"] = len(st["deps"])
    return st


class TestCrossQueryCSE:
    def test_shared_interior_computes_once_dispatch_counted(
            self, jmesh, rng, monkeypatch):
        xn = rand(rng, 48, 16)
        tcounts = dispatch_spy(monkeypatch, MatrelSession, t_exec)
        jcounts = dispatch_spy(monkeypatch, JSession, j_exec)
        outs = {}
        for cfg in ({}, CSE):
            js, ts = twins(jmesh, **cfg)
            tcounts.clear()
            jcounts.clear()
            jo = js.run_many(gram_batch(js.from_numpy(xn)))
            to = ts.run_many(gram_batch(ts.from_numpy(xn)))
            assert sum(tcounts) == sum(jcounts) \
                == (1 if cfg else 4)
            assert ts.mqo_info() == (js.mqo_info() if cfg else {
                "templates": 0, "template_hits": 0,
                "template_inserts": 0, "cse_hoisted": 0,
                "cse_batches": 0})
            for a, b in zip(to, jo):
                np.testing.assert_allclose(a.to_numpy(), b.to_numpy(),
                                           rtol=1e-5, atol=1e-5)
            outs[bool(cfg)] = [o.data.clone() for o in to]
        assert ts.mqo_info()["cse_hoisted"] == 1
        assert ts.mqo_info()["cse_batches"] == 1
        for a, b in zip(outs[True], outs[False]):
            assert np.array_equal(a.numpy(), b.numpy())

    def test_batch_answers_match_oracle(self, rng):
        ts = MatrelSession(config=MatrelConfig(**CSE), device="cpu")
        xn = rand(rng, 64, 24)
        outs = ts.run_many(gram_batch(ts.from_numpy(xn), k=5))
        for out, want in zip(outs, gram_oracles(xn, k=5)):
            np.testing.assert_allclose(out.to_numpy(), want, rtol=3e-4,
                                       atol=3e-4)

    def test_consumer_plan_carries_cse_stamp_and_pricing(self, jmesh,
                                                         rng):
        js, ts = twins(jmesh, **CSE)
        xn = rand(rng, 48, 16)
        bns = [rand(rng, 16, 16) for _ in range(3)]
        decs, stamps = [], []
        for s, ex in ((js, j_exec), (ts, t_exec)):
            X = s.from_numpy(xn)
            g = X.expr().t().multiply(X.expr())
            s.run_many([g.multiply(s.from_numpy(b).expr()) for b in bns])
            assert s.mqo_info()["cse_hoisted"] == 1
            stamps.append(stamp_of(s))
            plan = list(s._plan_cache.values())[-1]
            decs.append(ex.plan_matmul_decisions(plan))
        assert stamps[1] == stamps[0]
        assert stamps[1]["uses"] == 3
        assert stamps[1]["layout"] in ("2d", "row", "col", "rep", "other")
        assert [True, False] in [d.get("cse_operands") for d in decs[1]]
        records_equal(decs[1], decs[0])

    def test_matmul_free_share_is_not_hoisted(self, jmesh, rng):
        js, ts = twins(jmesh, **CSE)
        xn = rand(rng, 32, 32)
        for s in (js, ts):
            t = s.from_numpy(xn).expr().t()
            outs = s.run_many([t.multiply_scalar(2.0),
                               t.multiply_scalar(3.0)])
            assert s.mqo_info()["cse_hoisted"] == 0
            np.testing.assert_allclose(outs[0].to_numpy(), xn.T * 2.0,
                                       rtol=1e-6, atol=1e-6)
        assert ts.mqo_info() == js.mqo_info()

    def test_rebind_invalidates_hoisted_interior(self, jmesh, rng):
        js, ts = twins(jmesh, result_cache_max_bytes=64 << 20, **CSE)
        an, bn = rand(rng, 48, 16), rand(rng, 48, 16)
        for s in (js, ts):
            s.register("src", s.from_numpy(an))
            s.run_many(gram_batch(s.table("src"), k=3))
            assert s.mqo_info()["cse_hoisted"] == 1
            # the hoisted interior inserted under its own key with the
            # consumers: 1 + 3 entries
            assert s.result_cache_info()["entries"] == 4
            s.register("src", s.from_numpy(bn))
            assert s.result_cache_info()["entries"] == 0
            outs = s.run_many(gram_batch(s.table("src"), k=3))
            for out, want in zip(outs, gram_oracles(bn, k=3)):
                np.testing.assert_allclose(out.to_numpy(), want,
                                           rtol=3e-4, atol=3e-4)
        assert ts.result_cache_info() == js.result_cache_info()
        assert ts.mqo_info() == js.mqo_info()


class TestPlanTemplates:
    def test_template_hit_compiles_nothing(self, jmesh, rng,
                                           monkeypatch):
        js, ts = twins(jmesh, **CSE)
        an, bn = rand(rng, 48, 16), rand(rng, 48, 16)
        for s in (js, ts):
            A = s.from_numpy(an)
            s.run(A.expr().t().multiply(A.expr()))
        calls = compile_spy(monkeypatch)
        for s in (js, ts):
            B = s.from_numpy(bn)
            out = s.run(B.expr().t().multiply(B.expr()))
            np.testing.assert_allclose(
                out.to_numpy(), bn.astype(np.float64).T @ bn, rtol=3e-4,
                atol=3e-4)
            info = s.mqo_info()
            assert info["template_inserts"] == 1
            assert info["template_hits"] == 1
        assert calls == []                 # the port compiled nothing
        assert ts.mqo_info() == js.mqo_info()

    def test_multiplan_template_rebinds_whole_batch(self, jmesh, rng,
                                                    monkeypatch):
        js, ts = twins(jmesh, **CSE)
        an, bn = rand(rng, 48, 16), rand(rng, 48, 16)
        for s in (js, ts):
            s.run_many(gram_batch(s.from_numpy(an), k=3))
        calls = compile_spy(monkeypatch)
        for s in (js, ts):
            outs = s.run_many(gram_batch(s.from_numpy(bn), k=3))
            assert s.mqo_info()["template_hits"] >= 3
            for out, want in zip(outs, gram_oracles(bn, k=3)):
                np.testing.assert_allclose(out.to_numpy(), want,
                                           rtol=3e-4, atol=3e-4)
        assert calls == []
        assert ts.mqo_info() == js.mqo_info()

    def test_identity_pattern_never_aliases(self, jmesh, rng):
        js, ts = twins(jmesh, **CSE)
        an, bn, cn, dn = (rand(rng, 32, 32) for _ in range(4))
        for s in (js, ts):
            A, B, C, D = (s.from_numpy(x) for x in (an, bn, cn, dn))
            s.run(A.expr().t().multiply(A.expr()))
            out = s.run(B.expr().t().multiply(C.expr()))
            assert s.mqo_info()["template_hits"] == 0
            np.testing.assert_allclose(out.to_numpy(), bn.T @ cn,
                                       rtol=3e-4, atol=3e-4)
            out2 = s.run(D.expr().t().multiply(D.expr()))
            assert s.mqo_info()["template_hits"] == 1
            np.testing.assert_allclose(out2.to_numpy(), dn.T @ dn,
                                       rtol=3e-4, atol=3e-4)
        assert ts.mqo_info() == js.mqo_info()

    def test_sla_prefix_isolates_templates(self, jmesh, rng):
        js, ts = twins(jmesh, **CSE)
        an, bn = rand(rng, 48, 16), rand(rng, 48, 16)
        for s in (js, ts):
            A, B = s.from_numpy(an), s.from_numpy(bn)
            s.run(A.expr().t().multiply(A.expr()))
            s.run(B.expr().t().multiply(B.expr()), precision="high")
            assert s.mqo_info()["template_hits"] == 0
        assert ts.mqo_info() == js.mqo_info()

    def test_sparse_leaves_keep_identity_tokens(self, jmesh, rng):
        js, ts = twins(jmesh, **CSE)
        sp1 = scipy.sparse.random(64, 64, density=0.3, format="csr",
                                  random_state=1, dtype=np.float32)
        sp2 = scipy.sparse.random(64, 64, density=0.3, format="csr",
                                  random_state=2, dtype=np.float32)
        dn = rand(rng, 64, 8)
        for s, cls in ((js, JBSM), (ts, BlockSparseMatrix)):
            S1 = cls.from_scipy(sp1, block_size=16, mesh=s.mesh)
            S2 = cls.from_scipy(sp2, block_size=16, mesh=s.mesh)
            D = s.from_numpy(dn)
            o1 = s.run(S1.expr().multiply(D.expr()))
            o2 = s.run(S2.expr().multiply(D.expr()))
            assert s.mqo_info()["template_hits"] == 0
            np.testing.assert_allclose(o1.to_numpy(), sp1.toarray() @ dn,
                                       rtol=3e-4, atol=3e-4)
            np.testing.assert_allclose(o2.to_numpy(), sp2.toarray() @ dn,
                                       rtol=3e-4, atol=3e-4)
        assert ts.mqo_info() == js.mqo_info()

    def test_template_keys_equal_the_jax_package(self, jmesh, rng):
        """The leaf-abstracted keys are session-independent: for the
        same trees both packages produce the same string."""
        from matrel_tpu.serve import mqo as j_mqo
        js, ts = twins(jmesh)
        xn, yn = rand(rng, 24, 8), rand(rng, 8, 8)
        keys = []
        for s, mq in ((js, j_mqo), (ts, mqo_lib)):
            X = s.from_numpy(xn)
            Y = s.from_numpy(yn, integral=False)
            e = X.expr().t().multiply(X.expr()).multiply(Y.expr()) \
                .row_sum().multiply_scalar(0.5)
            akey, _pins, leaves = mq.template_key(e)
            keys.append((akey, len(leaves)))
        assert keys[1] == keys[0]


class TestZeroOverheadDefault:
    def test_default_config_constructs_nothing(self, rng):
        before = mqo_lib._CONSTRUCTED["count"]
        ts = MatrelSession(device="cpu")
        xn = rand(rng, 48, 16)
        X = ts.from_numpy(xn)
        outs = ts.run_many(gram_batch(X, k=4))
        ts.run(X.expr().t().multiply(X.expr()))
        assert mqo_lib._CONSTRUCTED["count"] == before
        assert ts._mqo is None
        assert ts.mqo_info() == {
            "templates": 0, "template_hits": 0, "template_inserts": 0,
            "cse_hoisted": 0, "cse_batches": 0}
        for out, want in zip(outs, gram_oracles(xn, k=4)):
            np.testing.assert_allclose(out.to_numpy(), want, rtol=3e-4,
                                       atol=3e-4)

    def test_default_is_off(self):
        assert MatrelConfig().cse_enable is False \
            and JConfig().cse_enable is False

    @pytest.mark.parametrize("kw,needle", [
        ({"cse_min_uses": 1}, "cse_min_uses"),
        ({"cse_template_max": 0}, "cse_template_max"),
    ])
    def test_config_validation(self, kw, needle):
        with pytest.raises(ValueError, match=needle):
            JConfig(**kw)
        with pytest.raises(ValueError, match=needle):
            MatrelConfig(**kw)
