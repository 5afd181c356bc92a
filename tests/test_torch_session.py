"""PyTorch port: ``MatrelSession.compute`` end to end (rewrites → chain
DP → planner → executor) held against the JAX package's session on the
CPU, on the same numpy inputs.

Plans are compared as equal: the chosen parenthesisation and the
rewrite-rule hit counts. Numbers at the JAX tests' tolerances: dense
products rtol=1e-4, atol=1e-5 (test_executor.py); the Gram under
``matmul_precision="high"`` rtol=atol=2e-3 (test_executor.py's bf16
split bound); SpMM rtol=atol=1e-4 (test_sparse.py).
"""

import jax
import numpy as np
import pytest

from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.sparse import BlockSparseMatrix as JBlockSparse
from matrel_tpu.session import MatrelSession as JSession
from matrel_tpu.workloads import chain_bench as j_chain

from matrel_tpu_torch import convert
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.session import MatrelSession
from matrel_tpu_torch.workloads import chain_bench as t_chain


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


def sessions(jmesh, **cfg):
    return (JSession(mesh=jmesh, config=JConfig(**cfg)),
            MatrelSession(config=MatrelConfig(**cfg), device="cpu"))


def pair(js, ts, arr):
    """The same numpy matrix in both sessions."""
    jm = js.from_numpy(arr)
    return jm, convert.from_reference(jm, ts.mesh)


def compare_plans(js, ts, je, te):
    jp, tp = js.compile(je), ts.compile(te)
    assert (t_chain.parenthesisation(tp.optimized)
            == j_chain.parenthesisation(jp.optimized))
    assert tp.meta["rule_hits"] == jp.meta["rule_hits"]
    return t_chain.parenthesisation(tp.optimized)


@pytest.mark.parametrize("dims", [(30, 5, 40, 6, 25), (8, 60, 4, 50, 3)])
def test_four_operand_chain(jmesh, dims):
    rng = np.random.default_rng(sum(dims))
    js, ts = sessions(jmesh)
    arrs = [rng.standard_normal((dims[i], dims[i + 1])).astype(np.float32)
            for i in range(4)]
    mats = [pair(js, ts, a) for a in arrs]
    je = j_chain.build_chain([m[0] for m in mats])
    te = t_chain.build_chain([m[1] for m in mats])
    compare_plans(js, ts, je, te)
    want = js.compute(je).to_numpy()
    got = ts.compute(te).to_numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got, arrs[0] @ arrs[1] @ arrs[2] @ arrs[3],
                               rtol=1e-4, atol=1e-4)


def test_skewed_abc_reorders(jmesh):
    rng = np.random.default_rng(2)
    js, ts = sessions(jmesh)
    n, mid = 200, 10
    arrs = [rng.random((n, mid), np.float32), rng.random((mid, n), np.float32),
            rng.random((n, mid), np.float32)]
    mats = [pair(js, ts, a) for a in arrs]
    je = j_chain.build_chain([m[0] for m in mats])
    te = t_chain.build_chain([m[1] for m in mats])
    assert compare_plans(js, ts, je, te) == "(A·(B·C))"
    np.testing.assert_allclose(ts.compute(te).to_numpy(),
                               js.compute(je).to_numpy(),
                               rtol=1e-4, atol=1e-5)


def test_gram_high_precision(jmesh):
    rng = np.random.default_rng(3)
    js, ts = sessions(jmesh, matmul_precision="high")
    a = rng.standard_normal((48, 24)).astype(np.float32)
    jX, tX = pair(js, ts, a)
    je = jX.expr().t().multiply(jX.expr())
    te = tX.expr().t().multiply(tX.expr())
    compare_plans(js, ts, je, te)
    got = ts.compute(te).to_numpy()
    np.testing.assert_allclose(got, js.compute(je).to_numpy(),
                               rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(got, a.T @ a, rtol=2e-3, atol=2e-3)


def test_rewrites_and_aggregates(jmesh):
    """(A·B)ᵀ·C with a row-sum on top: R2 transpose push-down and R3
    aggregation push-down fire the same number of times in both
    optimizers, and the answers agree."""
    rng = np.random.default_rng(4)
    js, ts = sessions(jmesh)
    a, b, c = (rng.standard_normal(s).astype(np.float32)
               for s in ((12, 7), (7, 12), (12, 5)))
    (jA, tA), (jB, tB), (jC, tC) = (pair(js, ts, x) for x in (a, b, c))
    je = jA.multiply(jB).t().multiply(jC).row_sum()
    te = tA.multiply(tB).t().multiply(tC).row_sum()
    compare_plans(js, ts, je, te)
    np.testing.assert_allclose(ts.compute(te).to_numpy(),
                               js.compute(je).to_numpy(),
                               rtol=1e-4, atol=1e-4)


def test_sparse_times_dense_query(jmesh):
    rng = np.random.default_rng(5)
    js, ts = sessions(jmesh)
    s_np = np.zeros((64, 48), np.float32)
    s_np[0:16, 16:32] = rng.standard_normal((16, 16))
    s_np[32:48, 0:16] = rng.standard_normal((16, 16))
    d = rng.standard_normal((48, 10)).astype(np.float32)
    jS = JBlockSparse.from_numpy(s_np, block_size=16, mesh=jmesh)
    tS = convert.from_reference(jS, ts.mesh)
    jD, tD = pair(js, ts, d)
    je, te = jS.multiply(jD), tS.multiply(tD)
    compare_plans(js, ts, je, te)
    got = ts.compute(te).to_numpy()
    np.testing.assert_allclose(got, js.compute(je).to_numpy(),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got, s_np @ d, rtol=1e-4, atol=1e-4)


def test_plan_cache_hits_on_repeat():
    ts = MatrelSession(device="cpu")
    rng = np.random.default_rng(6)
    A = ts.from_numpy(rng.standard_normal((6, 4)).astype(np.float32))
    B = ts.from_numpy(rng.standard_normal((4, 3)).astype(np.float32))
    e = A.multiply(B)
    _, hit1, key = ts._compile_entry(e)
    _, hit2, key2 = ts._compile_entry(A.multiply(B))
    assert (hit1, hit2) == (False, True) and key == key2
    _, hit3, key3 = ts._compile_entry(A.multiply(B), sla="fast")
    assert not hit3 and key3.startswith("prec:fast|")
    assert ts.plan_cache_info()["plans"] == 2


def test_precision_sla_tiers_match(jmesh):
    """Under SLA "fast" / "high" both planners stamp the same tier and
    the port's bf16 split stays inside the documented bound."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((32, 64)).astype(np.float32)
    b = rng.standard_normal((64, 16)).astype(np.float32)
    for sla, tier in (("fast", "bf16x1"), ("high", "bf16x3")):
        js, ts = sessions(jmesh, precision_sla=sla)
        (jA, tA), (jB, tB) = pair(js, ts, a), pair(js, ts, b)
        jp, tp = js.compile(jA.multiply(jB)), ts.compile(tA.multiply(tB))
        assert (tp.optimized.attrs["precision_tier"]
                == jp.optimized.attrs["precision_tier"] == tier)
        got = tp.run().to_numpy()
        bound = 2.0 ** (-8 if tier == "bf16x1" else -15) * 64 \
            * np.abs(a).max() * np.abs(b).max()
        assert np.abs(got - a @ b).max() <= bound


INT_QUERIES = {
    "sum": lambda A, B: A.sum(),
    "row_sum": lambda A, B: A.row_sum(),
    "col_sum": lambda A, B: A.col_sum(),
    "norm_fro": lambda A, B: A.expr().norm("fro"),
    "trace_of_product": lambda A, B: A.multiply(B).trace(),
}


@pytest.mark.parametrize("query", sorted(INT_QUERIES))
@pytest.mark.parametrize("dtype", ["int8", "int16", "int32", "uint8"])
def test_integer_sums_keep_jnp_dtype(jmesh, dtype, query):
    """Integer aggregates come back in jnp.sum's dtype (int8 and int16
    promote to int32, uint8 to uint32, int32 stays), not torch.sum's
    int64, with the reference's values. A 7 x 5 and a 5 x 7 operand keep
    the padded region in play."""
    rng = np.random.default_rng(31)
    js, ts = sessions(jmesh)
    a = rng.integers(0, 5, (7, 5)).astype(dtype)
    b = rng.integers(0, 5, (5, 7)).astype(dtype)
    jA, jB = (js.from_numpy(x, dtype=np.dtype(dtype)) for x in (a, b))
    tA, tB = (convert.from_reference(m, ts.mesh) for m in (jA, jB))
    want = js.compute(INT_QUERIES[query](jA, jB)).to_numpy()
    got = ts.compute(INT_QUERIES[query](tA, tB)).to_numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# -- max / min aggregates of integer values (ROADMAP Queue C, C2) -----------

INT_EXTREMES = {
    "row_max": (lambda A: A.expr().row_max(),
                lambda a: a.max(axis=1, keepdims=True)),
    "row_min": (lambda A: A.expr().row_min(),
                lambda a: a.min(axis=1, keepdims=True)),
    "col_max": (lambda A: A.expr().col_max(),
                lambda a: a.max(axis=0, keepdims=True)),
    "col_min": (lambda A: A.expr().col_min(),
                lambda a: a.min(axis=0, keepdims=True)),
    "norm_max": (lambda A: A.expr().norm("max"),
                 lambda a: np.abs(a).max().reshape(1, 1)),
}


@pytest.mark.parametrize("query", sorted(INT_EXTREMES))
@pytest.mark.parametrize("dtype", ["int8", "uint8", "int32"])
def test_integer_max_min_answer_as_numpy(dtype, query):
    """The padding is filled with the dtype's extreme value, not ±inf
    (which an integer tensor cannot hold), and norm's ·-1 on an unsigned
    value runs in int64. The JAX package raises here, so the oracle is
    numpy. A 7 x 5 leaf keeps the padded region in play on the (2, 4)
    grid; the values avoid int8's -128, whose |x| wraps in numpy as in
    torch."""
    from matrel_tpu_torch.core.mesh import make_mesh
    rng = np.random.default_rng(32)
    lo = 0 if dtype == "uint8" else -100
    a = rng.integers(lo, 100, (7, 5)).astype(dtype)
    for mesh in (make_mesh(device="cpu"), make_mesh((2, 4), device="cpu")):
        ts = MatrelSession(mesh=mesh)
        A = ts.from_numpy(a, dtype=dtype)
        build, oracle = INT_EXTREMES[query]
        got = ts.compute(build(A)).to_numpy()
        np.testing.assert_array_equal(got, oracle(a))


def test_exact_sla_integer_product_row_max():
    """Under precision_sla="exact" an integer-valued f32 product takes
    the int32 tier, so ``(A @ B).row_max()`` aggregates an integer
    value: it answers as numpy, through compute and through run_many."""
    rng = np.random.default_rng(33)
    a = rng.integers(-6, 7, (9, 6)).astype(np.float32)
    b = rng.integers(-6, 7, (6, 11)).astype(np.float32)
    ts = MatrelSession(config=MatrelConfig(precision_sla="exact"),
                       device="cpu")
    A, B = ts.from_numpy(a, integral=True), ts.from_numpy(b, integral=True)
    q = A.expr().multiply(B.expr()).row_max()
    q2 = A.expr().multiply(B.expr()).col_min()
    tiers = [n.attrs.get("precision_tier") for n in _walk(
        ts.compile(q).optimized) if n.kind == "matmul"]
    assert tiers == ["int32"]
    want, want2 = (a @ b).max(axis=1, keepdims=True), (a @ b).min(
        axis=0, keepdims=True)
    np.testing.assert_array_equal(ts.compute(q).to_numpy(), want)
    got = ts.run_many([q, q2])
    np.testing.assert_array_equal(got[0].to_numpy(), want)
    np.testing.assert_array_equal(got[1].to_numpy(), want2)


def _walk(n):
    yield n
    for c in n.children:
        yield from _walk(c)
