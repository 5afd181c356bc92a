"""PyTorch port: MatRel's relational σ/γ/⋈ surface held against the JAX
package on the CPU — the same numpy inputs, made from a seed, through
``matrel_tpu.relational.ops`` and ``matrel_tpu_torch.relational.ops``.

Covered: every σ kind (value with and without a fill, rows, cols,
blocks, and σ under a matmul), every γ kind × axis, the index / row /
col joins (structured and callable merges, result dtypes) with the
join-scheme stamp equal to the JAX package's on the virtual (2, 4)
grid, the streamed value join over every predicate × merge × kind ×
axis, its NaN, ±inf, empty-side, degenerate and centred-sum cases, the
chunked (callable) path, the size guards (raised before the operands
are evaluated), the COO σ/γ/⋈ methods, and ``match_range`` on torch
and numpy inputs.

Tolerances are the JAX tests' own (``tests/test_relational.py``):
selections and index joins rtol 1e-6 (they copy or merge one entry);
aggregates rtol 1e-4 / atol 1e-5; value joins rtol 1e-5 / atol 1e-5
(degenerate and extreme inputs rtol 1e-4 / atol 1e-6); counts and
extrema exact. The streamed path keeps its prefix table in float64
(the JAX package's in f32), so it sits closer to the float64 oracle
than the JAX package does, inside the same tolerances.

One case differs from the JAX package's streamed answer on purpose: a
NaN entry under an omitted predicate with merge "add". The JAX
package's streamed count subtracts B's NaN count there (its
searchsorted places a NaN query at the NaN tail), which disagrees with
its own dense lowering; the port gives the dense lowering's answer,
and that case is held against the JAX package's materialised pair
matrix.
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from matrel_tpu import executor as j_exec
from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
from matrel_tpu.core.coo import COOMatrix as JCOO
from matrel_tpu.parallel import planner as j_planner
from matrel_tpu.relational import ops as JR
from matrel_tpu.relational import value_join as j_vj

from matrel_tpu_torch import convert
from matrel_tpu_torch.config import MatrelConfig, NotPortedError
from matrel_tpu_torch.core.coo import COOMatrix
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.ir import expr as TE
from matrel_tpu_torch.parallel import planner as t_planner
from matrel_tpu_torch.relational import ops as TR
from matrel_tpu_torch.relational import value_join as t_vj
from matrel_tpu_torch.session import MatrelSession

PREDS = ("eq", "lt", "le", "gt", "ge", None)
MERGES = ("left", "right", "add", "mul")
KINDS = ("sum", "count", "avg", "max", "min")
AXES = ("row", "col", "all", "diag")


@pytest.fixture(scope="module")
def jmesh():
    return jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


@pytest.fixture(scope="module")
def ts():
    return MatrelSession(device="cpu")


def jt(jmesh, ts, *arrays, dtype=None):
    """Each numpy array as a (JAX BlockMatrix, port BlockMatrix) pair."""
    out = []
    for a in arrays:
        kw = {} if dtype is None else {"dtype": dtype}
        out.append((JBM.from_numpy(np.asarray(a), mesh=jmesh, **kw),
                    ts.from_numpy(np.asarray(a), **kw)))
    return out


def run_both(jexpr, texpr, ts):
    j = j_exec.execute(jexpr, jexpr_mesh(jexpr))
    t = ts.compute(texpr)
    return np.asarray(j.to_numpy()), t.to_numpy(), j, t


def jexpr_mesh(e):
    """The mesh of a JAX expression's first dense leaf."""
    from matrel_tpu.ir.expr import as_expr, leaves
    return leaves(as_expr(e))[0].attrs["matrix"].mesh


def _pair_oracle(a, b, merge, pred, kind, axis):
    """Dense numpy oracle of the aggregated pair matrix (the JAX tests'
    own): count = nonzero entries, max/min over merged-or-zero, avg =
    sum/count."""
    va = np.asarray(a, np.float32).T.reshape(-1)
    vb = np.asarray(b, np.float32).T.reshape(-1)
    with np.errstate(invalid="ignore"):
        P_ = merge(va[:, None], vb[None, :]).astype(np.float64)
        if pred is not None:
            P_ = np.where(pred(va[:, None], vb[None, :]), P_, 0.0)
    if axis == "diag":
        L = min(len(va), len(vb))
        P_ = P_[np.arange(L), np.arange(L)]
        axis = "all"
    ax = {"row": 1, "col": 0, "all": None}[axis]
    if kind == "sum":
        return P_.sum(axis=ax)
    if kind == "count":
        return (P_ != 0).sum(axis=ax).astype(np.float64)
    if kind == "avg":
        s = P_.sum(axis=ax)
        c = (P_ != 0).sum(axis=ax)
        return np.where(c > 0, s / np.maximum(c, 1), 0.0)
    return (np.max if kind == "max" else np.min)(P_, axis=ax)


_NP_PREDS = {"eq": np.equal, "lt": np.less, "le": np.less_equal,
             "gt": np.greater, "ge": np.greater_equal, None: None}
_NP_MERGES = {"left": lambda x, y: x + np.zeros_like(y),
              "right": lambda x, y: y + np.zeros_like(x),
              "add": np.add, "mul": np.multiply}


# -- σ ------------------------------------------------------------------------


SELECTIONS = {
    "value": (lambda R, m: R.select_entries(m, lambda v: v > 0)),
    "value_fill": (lambda R, m: R.select_entries(m, lambda v: v > 0,
                                                 fill=-1.0)),
    "rows": (lambda R, m: R.select_rows(m, lambda i: i % 2 == 0)),
    "cols": (lambda R, m: R.select_cols(m, lambda j: j < 3)),
    "rows_arith": (lambda R, m: R.select_rows(m, lambda i: i / 3 > 1.5)),
    "blocks": (lambda R, m: R.select_blocks(m, lambda bi, bj: bi == bj,
                                            block_size=4)),
    "blocks_default": (lambda R, m: R.select_blocks(m, lambda bi, bj:
                                                    bi >= bj)),
    "under_matmul": (lambda R, m: R.select_entries(m, lambda v: v > 0)
                     .multiply(m.expr())),
}


@pytest.mark.parametrize("name", sorted(SELECTIONS))
@pytest.mark.parametrize("dtype", ["float32", "int32"])
def test_selections_match_jax(jmesh, ts, name, dtype):
    rng = np.random.default_rng(3)
    a = rng.standard_normal((10, 10)) * 4
    a = a.astype(np.int32 if dtype == "int32" else np.float32)
    (JA, TA), = jt(jmesh, ts, a, dtype=dtype)
    build = SELECTIONS[name]
    jo, to, j, t = run_both(build(JR, JA), build(TR, TA), ts)
    rtol = 1e-4 if name == "under_matmul" else 1e-6
    np.testing.assert_allclose(to, jo, rtol=rtol, atol=1e-5 if
                               name == "under_matmul" else 0)
    assert str(t.dtype).split(".")[-1] == str(j.data.dtype)
    # the padding stays zero (the lowering's invariant)
    assert float(t.data[10:].abs().sum()) == 0.0


def test_select_block_uses_the_matrix_block_size(jmesh, ts):
    rng = np.random.default_rng(4)
    a = rng.standard_normal((12, 12)).astype(np.float32)
    TA = ts.from_numpy(a)
    TA.block_size = 4
    got = ts.compute(TR.select_blocks(TA, lambda bi, bj: bi == bj)
                     ).to_numpy()
    want = a * np.kron(np.eye(3), np.ones((4, 4)))
    np.testing.assert_array_equal(got, want.astype(np.float32))


# -- γ ------------------------------------------------------------------------


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("kind", KINDS)
def test_aggregates_match_jax(jmesh, ts, kind, axis):
    rng = np.random.default_rng(5)
    a = rng.standard_normal((7, 7)).astype(np.float32)
    a[a < 0.3] = 0
    (JA, TA), = jt(jmesh, ts, a)
    jo, to, _, _ = run_both(JR.aggregate(JA, kind, axis),
                            TR.aggregate(TA, kind, axis), ts)
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)


# -- index joins --------------------------------------------------------------


@pytest.mark.parametrize("merge", MERGES + ("callable",))
def test_join_on_index_matches_jax(jmesh, ts, merge):
    rng = np.random.default_rng(6)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    b = rng.standard_normal((6, 6)).astype(np.float32)
    (JA, TA), (JB, TB) = jt(jmesh, ts, a, b)
    m = (lambda x, y: x * y + 1) if merge == "callable" else merge
    jo, to, _, t = run_both(JR.join_on_index(JA, JB, m),
                            TR.join_on_index(TA, TB, m), ts)
    np.testing.assert_allclose(to, jo, rtol=1e-6)
    # merge(0, 0) = 1 in the padded region must not leak
    assert float(t.data[6:].abs().sum()) == 0.0


def test_index_join_then_aggregate_and_sugar(jmesh, ts):
    rng = np.random.default_rng(7)
    a = rng.standard_normal((8, 8)).astype(np.float32)
    b = rng.standard_normal((8, 8)).astype(np.float32)
    (JA, TA), (JB, TB) = jt(jmesh, ts, a, b)
    jo, to, _, _ = run_both(
        JR.aggregate(JA.join_on_index(JB, "add"), "sum", "all"),
        TR.aggregate(TA.join_on_index(TB, "add"), "sum", "all"), ts)
    np.testing.assert_allclose(to, jo, rtol=1e-5)
    jo, to, _, _ = run_both(JA.select_value(lambda v: v > 0),
                            TA.select_value(lambda v: v > 0), ts)
    np.testing.assert_array_equal(to, jo)
    jo, to, _, _ = run_both(JA.select_index(rows=lambda i: i < 3),
                            TA.select_index(rows=lambda i: i < 3), ts)
    np.testing.assert_array_equal(to, jo)


@pytest.mark.parametrize("joiner", ["rows", "cols"])
@pytest.mark.parametrize("merge", MERGES + ("callable",))
def test_row_col_joins_match_jax(jmesh, ts, joiner, merge):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((6, 3)).astype(np.float32)
    b = rng.standard_normal((6, 5)).astype(np.float32)
    if joiner == "cols":
        a, b = a.T.copy(), rng.standard_normal((4, 6)).astype(np.float32)
    (JA, TA), (JB, TB) = jt(jmesh, ts, a, b)
    m = (lambda x, y: y - 2 * x) if merge == "callable" else merge
    jf = JR.join_on_rows if joiner == "rows" else JR.join_on_cols
    tf = TR.join_on_rows if joiner == "rows" else TR.join_on_cols
    jo, to, _, t = run_both(jf(JA, JB, m), tf(TA, TB, m), ts)
    np.testing.assert_allclose(to, jo, rtol=1e-6)
    assert t.shape == tuple(jo.shape)


@pytest.mark.parametrize("kind", ["join_index", "join_rows", "join_value"])
@pytest.mark.parametrize("dtypes", [("int32", "int32"),
                                    ("int32", "float32"),
                                    ("bfloat16", "float32")])
def test_join_result_dtypes_match_jax(jmesh, ts, kind, dtypes):
    """Structured merges promote the operand dtypes (jnp promotion):
    the materialised and the streamed results and the planner's
    infer_dtype agree with the JAX package."""
    rng = np.random.default_rng(9)
    a = rng.integers(-3, 4, (4, 4)).astype(np.float32)
    b = rng.integers(-3, 4, (4, 4)).astype(np.float32)
    (JA, TA), = jt(jmesh, ts, a, dtype=dtypes[0])
    (JB, TB), = jt(jmesh, ts, b, dtype=dtypes[1])
    if kind == "join_index":
        je, te = JR.join_on_index(JA, JB, "add"), TR.join_on_index(TA, TB,
                                                                   "add")
    elif kind == "join_rows":
        je, te = JR.join_on_rows(JA, JB, "mul"), TR.join_on_rows(TA, TB,
                                                                 "mul")
    else:
        je = JR.aggregate(JR.join_on_values(JA, JB, "mul", "lt"), "sum",
                          "row")
        te = TR.aggregate(TR.join_on_values(TA, TB, "mul", "lt"), "sum",
                          "row")
    jo, to, j, t = run_both(je, te, ts)
    assert str(t.dtype).split(".")[-1] == str(j.data.dtype)
    np.testing.assert_allclose(to, jo, rtol=1e-2 if "bfloat16" in dtypes
                               else 1e-6)
    jd = j_planner.infer_dtype(je)
    td = t_planner.infer_dtype(te)
    assert (td is None) == (jd is None)
    if td is not None:
        assert str(td).split(".")[-1] == str(np.dtype(jd))


# -- join scheme on the virtual (2, 4) grid -----------------------------------


def _scheme_cases(mesh8, rng):
    """(name, JAX lhs, JAX rhs, joiner) — the JAX tests' scheme cases."""
    from jax.sharding import PartitionSpec as JP

    def bm(shape, spec=None, nnz=None, arr=None):
        arr = (rng.standard_normal(shape).astype(np.float32)
               if arr is None else arr)
        kw = {} if spec is None else {"spec": spec}
        return JBM.from_numpy(arr, mesh=mesh8, nnz=nnz, **kw)

    sparse = np.zeros((8, 256), np.float32)
    sparse[:, :1] = 1.0
    big_rep = bm((8, 64), JP(None, None))
    big_col = bm((64, 8), JP(None, ("x", "y")))
    big_row = bm((8, 64), JP(("x", "y"), None))
    small = bm((8, 4))
    big = bm((8, 64))
    return [
        ("row_small_big", small, big, "rows"),
        ("row_big_small", big, small, "rows"),
        ("col_small_big", bm((4, 8)), bm((64, 8)), "cols"),
        ("col_big_small", bm((64, 8)), bm((4, 8)), "cols"),
        ("replicated_larger", big_rep, small, "rows"),
        ("replicated_larger_right", small, big_rep, "rows"),
        ("density_credit", bm((8, 256), nnz=8, arr=sparse),
         bm((8, 16)), "rows"),
        ("density_credit_right", bm((8, 16)),
         bm((8, 256), nnz=8, arr=sparse), "rows"),
        ("colsharded_coljoin", big_col, bm((4, 8)), "cols"),
        ("colsharded_coljoin_right", bm((4, 8)), big_col, "cols"),
        ("rowsharded_rowjoin", big_row, small, "rows"),
        ("align_gated", bm((4, 32)), bm((4, 32)), "rows"),
        ("similar_2d_align", bm((8, 32)), bm((8, 32)), "rows"),
    ]


@pytest.mark.parametrize("case", range(13))
def test_join_scheme_stamp_matches_jax(mesh8, case):
    rng = np.random.default_rng(10)
    name, ja, jb, joiner = _scheme_cases(mesh8, rng)[case]
    tmesh = make_mesh((2, 4), device="cpu")
    ta, tb = (convert.from_reference(m, tmesh) for m in (ja, jb))
    jf = JR.join_on_rows if joiner == "rows" else JR.join_on_cols
    tf = TR.join_on_rows if joiner == "rows" else TR.join_on_cols
    merge = lambda x, y: x + y
    jann = j_planner.annotate_strategies(jf(ja, jb, merge), mesh8)
    tann = t_planner.annotate_strategies(tf(ta, tb, merge), tmesh)
    assert tann.attrs["replicate"] == jann.attrs["replicate"], name
    assert (t_planner.infer_layout(tann, tmesh)
            == j_planner.infer_layout(jann, mesh8)), name


def test_join_scheme_under_matmul_and_runs(jmesh, ts):
    """On one card every scheme costs 0: "left" is stamped, the result
    equals the JAX package's; under a matmul the consumer hint picks
    the scheme whose output the matmul reads in place (the tenth plan
    snapshot, tests/test_torch_planner.py)."""
    rng = np.random.default_rng(11)
    a = rng.standard_normal((8, 6)).astype(np.float32)
    b = rng.standard_normal((8, 6)).astype(np.float32)
    c = rng.standard_normal((36, 5)).astype(np.float32)
    (JA, TA), (JB, TB), (JC, TC) = jt(jmesh, ts, a, b, c)
    jo, to, _, _ = run_both(JR.join_on_rows(JA, JB, "mul").multiply(JC),
                            TR.join_on_rows(TA, TB, "mul").multiply(TC), ts)
    np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-5)
    plan = ts.compile(TR.join_on_rows(TA, TB, "mul"))
    assert plan.optimized.attrs["replicate"] == "left"
    assert "replicate=left" in plan.explain()


# -- the streamed value join --------------------------------------------------


@pytest.fixture(scope="module")
def vj_inputs():
    rng = np.random.default_rng(12)
    pool = np.array([-2.0, -1.0, 0.0, 0.0, 1.0, 1.0, 2.0, 3.0], np.float32)
    a = rng.choice(pool, size=(4, 3)).astype(np.float32)
    b = rng.choice(pool, size=(3, 4)).astype(np.float32)
    return a, b


@pytest.mark.parametrize("merge", MERGES)
@pytest.mark.parametrize("pred", PREDS)
def test_streamed_value_join_matches_jax(ts, vj_inputs, pred, merge):
    """Every kind × axis of agg(join_on_values(A, B, merge, pred)) through
    the port's executor, against the JAX package's streaming functions
    (``relational/value_join.py``, the code its executor calls) on the
    same column-major entry vectors, and against the dense pair oracle
    (the diagonal, elementwise in both packages, against the oracle)."""
    a, b = vj_inputs
    TA, TB = ts.from_numpy(a), ts.from_numpy(b)
    va = jnp.asarray(a.T.reshape(-1))
    vb = jnp.asarray(b.T.reshape(-1))
    for kind in KINDS:
        for axis in AXES:
            te = TR.aggregate(TR.join_on_values(TA, TB, merge, pred), kind,
                              axis)
            got = ts.compute(te).to_numpy()
            oracle = _pair_oracle(a, b, _NP_MERGES[merge], _NP_PREDS[pred],
                                  kind, axis)
            msg = f"{pred}/{merge}/{kind}/{axis}"
            np.testing.assert_allclose(got.reshape(np.shape(oracle)),
                                       oracle, rtol=1e-5, atol=1e-5,
                                       err_msg=msg)
            if axis == "diag":
                continue
            want = np.asarray(j_vj.axis_agg_sorted(
                va, vb, pred or "always", merge, kind, axis))
            np.testing.assert_allclose(got.reshape(want.shape), want,
                                       rtol=1e-5, atol=1e-5, err_msg=msg)


def test_streamed_value_join_executor_matches_jax(jmesh, ts, vj_inputs):
    """The same queries through both packages' executors (one JAX
    MultiPlan for every kind × axis)."""
    a, b = vj_inputs
    (JA, TA), (JB, TB) = jt(jmesh, ts, a, b)
    combos = [(k, x) for k in KINDS for x in AXES]
    jouts = j_exec.compile_exprs(
        [JR.aggregate(JR.join_on_values(JA, JB, "mul", "le"), k, x)
         for k, x in combos], jmesh).run()
    for (kind, axis), jout in zip(combos, jouts):
        got = ts.compute(TR.aggregate(TR.join_on_values(TA, TB, "mul", "le"),
                                      kind, axis)).to_numpy()
        np.testing.assert_allclose(got, np.asarray(jout.to_numpy()),
                                   rtol=1e-5, atol=1e-5,
                                   err_msg=f"{kind}/{axis}")


@pytest.mark.parametrize("pred", ["eq", "lt", "ge", None])
def test_materialised_value_join_matches_jax(jmesh, ts, vj_inputs, pred):
    a, b = vj_inputs
    (JA, TA), (JB, TB) = jt(jmesh, ts, a, b)
    for merge in (MERGES + (lambda x, y: x * x - y,)):
        jo, to, _, _ = run_both(JR.join_on_values(JA, JB, merge, pred),
                                TR.join_on_values(TA, TB, merge, pred), ts)
        np.testing.assert_allclose(to, jo, rtol=1e-6)


def test_streaming_join_nan_semantics(ts):
    """NaN on either side matches nothing under a comparison predicate
    (the dense lowering's pred(NaN, ·) is False)."""
    a = np.array([[1.0, np.nan], [0.5, 2.0]], np.float32)
    b = np.array([[np.nan, 1.5]], np.float32)
    TA, TB = ts.from_numpy(a), ts.from_numpy(b)
    va, vb = jnp.asarray(a.T.reshape(-1)), jnp.asarray(b.T.reshape(-1))
    for pred in ("eq", "lt", "le", "gt", "ge"):
        for kind, axis in (("count", "row"), ("sum", "all"),
                           ("max", "col"), ("min", "row")):
            to = ts.compute(TR.aggregate(TR.join_on_values(TA, TB, "left",
                                                           pred),
                                         kind, axis)).to_numpy()
            jo = np.asarray(j_vj.axis_agg_sorted(va, vb, pred, "left", kind,
                                                 axis))
            np.testing.assert_allclose(to.reshape(jo.shape), jo, rtol=1e-6,
                                       err_msg=f"{pred}/{kind}/{axis}")


def test_nan_query_without_predicate_follows_dense_lowering(jmesh, ts):
    """merge "add", no predicate: every pair of a NaN entry is NaN, so
    nonzero — the count the JAX package's materialised pair matrix
    gives (its streamed count differs here; see the module docstring)."""
    a = np.array([[1.0, np.nan], [0.5, -1.5]], np.float32)
    b = np.array([[np.nan, 1.5], [-0.5, 0.0]], np.float32)
    (JA, TA), (JB, TB) = jt(jmesh, ts, a, b)
    pairs = np.asarray(j_exec.execute(JR.join_on_values(JA, JB, "add"),
                                      jmesh).to_numpy())
    for axis, want in (("row", (pairs != 0).sum(1)[:, None]),
                       ("col", (pairs != 0).sum(0)[None, :]),
                       ("all", np.array([[(pairs != 0).sum()]]))):
        got = ts.compute(TR.aggregate(TR.join_on_values(TA, TB, "add"),
                                      "count", axis)).to_numpy()
        np.testing.assert_array_equal(got, want.astype(np.float32))


@pytest.mark.parametrize("case", ["ones_1x1", "zeros", "identical",
                                  "extreme"])
def test_degenerate_inputs_match_jax(ts, case):
    a, b = {
        "ones_1x1": (np.ones((1, 1)), np.ones((1, 1))),
        "zeros": (np.zeros((3, 3)), np.zeros((2, 2))),
        "identical": (np.full((4, 4), 2.5), np.full((3, 3), 2.5)),
        "extreme": (np.array([[1e30, -1e30], [1e-30, 1.0]]),
                    np.array([[1e30], [-1e-30]])),
    }[case]
    a, b = a.astype(np.float32), b.astype(np.float32)
    TA, TB = ts.from_numpy(a), ts.from_numpy(b)
    va, vb = jnp.asarray(a.T.reshape(-1)), jnp.asarray(b.T.reshape(-1))
    for pred in ("eq", "le"):
        for kind in ("sum", "count", "max", "min"):
            to = ts.compute(TR.aggregate(TR.join_on_values(TA, TB, "add",
                                                           pred),
                                         kind, "row")).to_numpy()[:, 0]
            want = _pair_oracle(a, b, np.add, _NP_PREDS[pred], kind, "row")
            jo = np.asarray(j_vj.axis_agg_sorted(va, vb, pred, "add", kind,
                                                 "row"))
            np.testing.assert_allclose(to, want, rtol=1e-4, atol=1e-6)
            np.testing.assert_allclose(to, jo, rtol=1e-4, atol=1e-6)


def test_empty_matches_and_empty_side(ts):
    """No pair matches (every row empty → every aggregate 0), and an
    empty B vector on both streaming paths."""
    a = np.array([[1.0, 2.0]], np.float32)
    b = np.array([[5.0], [6.0]], np.float32)
    TA, TB = ts.from_numpy(a), ts.from_numpy(b)
    for kind in KINDS:
        got = ts.compute(TR.aggregate(TR.join_on_values(TA, TB, "mul", "gt"),
                                      kind, "row")).to_numpy()
        np.testing.assert_array_equal(got, np.zeros((2, 1), np.float32))
    va = torch.tensor([1.0, -2.0])
    vb = torch.zeros(0)
    for kind in KINDS:
        for axis in ("row", "all"):
            s = t_vj.axis_agg_sorted(va, vb, "lt", "add", kind, axis)
            c = t_vj.axis_agg_chunked(va, vb, lambda x, y: x + y, None,
                                      kind, axis, 16)
            assert float(s.abs().sum()) == float(c.abs().sum()) == 0.0


def test_centred_prefix_keeps_one_pair_matches_exact(jmesh, ts):
    """2^16 same-sign entries: a raw f32 prefix sum would cancel on a
    one-pair match; the centred prefix keeps it exact."""
    n = 256
    b = np.full((n, n), 1000.0, np.float32)
    b[0, 0] = 1234.5
    a = np.array([[1200.0, 2000.0], [999.0, 1000.0]], np.float32)
    (JA, TA), (JB, TB) = jt(jmesh, ts, a, b)
    jo, to, _, _ = run_both(
        JR.aggregate(JR.join_on_values(JA, JB, "right", "lt"), "sum", "row"),
        TR.aggregate(TR.join_on_values(TA, TB, "right", "lt"), "sum", "row"),
        ts)
    want = _pair_oracle(a, b, _NP_MERGES["right"], np.less, "sum", "row")
    np.testing.assert_allclose(to[:, 0], want, rtol=1e-6)
    np.testing.assert_allclose(to, jo, rtol=1e-6)
    # column-major entries 1200, 999, 2000, 1000: the last one matches
    # one entry among 65,535 equal ones
    assert to[0, 0] == to[3, 0] == 1234.5 and to[2, 0] == 0.0


def test_callable_chunked_matches_jax(jmesh, ts):
    rng = np.random.default_rng(13)
    a = rng.standard_normal((4, 4)).astype(np.float32)
    b = rng.standard_normal((2, 8)).astype(np.float32)
    (JA, TA), (JB, TB) = jt(jmesh, ts, a, b)
    merge = lambda x, y: x * x + y
    pred = lambda x, y: x + y > 0.3
    for kind, axis in (("sum", "row"), ("count", "col"), ("max", "all"),
                       ("min", "row"), ("avg", "col"), ("sum", "diag")):
        jo, to, _, _ = run_both(
            JR.aggregate(JR.join_on_values(JA, JB, merge, pred), kind, axis),
            TR.aggregate(TR.join_on_values(TA, TB, merge, pred), kind, axis),
            ts)
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{kind}/{axis}")


@pytest.mark.parametrize("chunk", [1, 3, 7, 1 << 22])
def test_chunked_extrema_never_see_padding(ts, chunk):
    """A row whose true pairs are all negative keeps a negative max at
    any chunk width (nb not a multiple of it), and ±inf survive."""
    va = torch.tensor([-1.0, float("inf"), 2.0])
    vb = torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0])
    merge = lambda x, y: x * y
    mx = t_vj.axis_agg_chunked(va, vb, merge, None, "max", "row", chunk)
    mn = t_vj.axis_agg_chunked(va, vb, merge, None, "min", "row", chunk)
    np.testing.assert_array_equal(mx.numpy(), [-1.0, np.inf, 10.0])
    np.testing.assert_array_equal(mn.numpy(), [-5.0, np.inf, 2.0])
    cfg = MatrelConfig(join_chunk_entries=chunk * 9)
    s = MatrelSession(config=cfg, device="cpu")
    A = s.from_numpy(np.array([[-1.0, 3.0]], np.float32))
    B = s.from_numpy(np.arange(1, 8, dtype=np.float32)[None, :])
    got = s.compute(TR.aggregate(TR.join_on_values(A, B, merge), "max",
                                 "row")).to_numpy()[:, 0]
    np.testing.assert_array_equal(got, [-1.0, 21.0])


@pytest.mark.parametrize("pred", ["eq", "lt", "le", "gt", "ge", "always"])
def test_match_range_torch_and_numpy_agree_with_jax(pred):
    """The one predicate→range implementation on torch and numpy inputs
    against the JAX package's, NaN and ±inf on both sides."""
    sv = np.sort(np.array([-np.inf, -1.0, 0.0, 0.0, 2.0, np.inf, np.nan,
                           np.nan], np.float32))
    x = np.array([np.nan, -np.inf, -1.0, 0.0, 1.0, 2.0, np.inf, 5.0],
                 np.float32)
    jlo, jhi = (np.asarray(v) for v in j_vj.match_range(
        jnp.asarray(sv), jnp.asarray(x), pred))
    tlo, thi = t_vj.match_range(torch.from_numpy(sv), torch.from_numpy(x),
                                pred)
    nlo, nhi = t_vj.match_range(sv, x, pred)
    for lo, hi in ((tlo.numpy(), thi.numpy()), (nlo, nhi)):
        empty = jlo >= jhi
        np.testing.assert_array_equal(np.maximum(hi - lo, 0),
                                      np.maximum(jhi - jlo, 0))
        np.testing.assert_array_equal(lo[~empty], jlo[~empty])
    if pred != "always":
        assert thi[0] == tlo[0] and hi[0] == lo[0]    # NaN query: empty
        assert int(thi.max()) <= 6                      # NaN tail clamped


def test_structured_forms_validate():
    with pytest.raises(ValueError, match="unknown join merge"):
        TE.resolve_join_merge("xor")
    with pytest.raises(ValueError, match="unknown join predicate"):
        TE.resolve_join_pred("ne")
    inf = torch.tensor([float("inf")])
    left = TE.resolve_join_merge("left")[1]
    assert torch.equal(left(torch.tensor([2.0]), inf), torch.tensor([2.0]))


# -- refusals and their guards ------------------------------------------------


def _unevaluable(shape):
    """A node whose evaluation raises NotPortedError: a guard that fires
    first proves it runs before the operands are evaluated."""
    return TE.MatExpr("not_a_kind", (), shape, None, {})


def test_materialising_large_join_refused_before_evaluation(mesh8, ts):
    n = 128
    a = np.random.default_rng(14).standard_normal((n, n)).astype(np.float32)
    ja = JBM.from_numpy(a, mesh=mesh8)
    with pytest.raises(ValueError, match="join_pair_cap_entries") as jerr:
        j_exec.execute(JR.join_on_values(ja, ja, "add", "eq"), mesh8)
    x = _unevaluable((n, n))
    with pytest.raises(ValueError, match="join_pair_cap_entries") as terr:
        ts.compute(TE.join_on_value(x, x, "add", "eq"))
    assert str(terr.value) == str(jerr.value)


def test_blackbox_over_cap_refused_before_evaluation(mesh8, ts):
    n = 192
    a = np.random.default_rng(15).standard_normal((n, n)).astype(np.float32)
    ja = JBM.from_numpy(a, mesh=mesh8)
    merge, pred = (lambda x, y: x - y), (lambda x, y: x > y)
    with pytest.raises(ValueError, match="join_bruteforce_max_pairs") as je:
        j_exec.execute(JR.aggregate(JR.join_on_values(ja, ja, merge, pred),
                                    "sum", "row"), mesh8)
    x = _unevaluable((n, n))
    with pytest.raises(ValueError, match="join_bruteforce_max_pairs") as te:
        ts.compute(TE.agg(TE.join_on_value(x, x, merge, pred), "sum",
                          "row"))
    assert str(te.value) == str(je.value)
    with pytest.raises(NotPortedError):       # the structured form streams
        ts.compute(TE.agg(TE.join_on_value(x, x, "add", "lt"), "sum",
                          "row"))


def test_row_col_join_size_guard(mesh8, ts):
    ja = JBM.from_numpy(np.zeros((2, 8), np.float32), mesh=mesh8)
    from matrel_tpu.ir import expr as JE
    jnode = JE.MatExpr("join_rows", (ja.expr(), ja.expr()),
                       (1 << 13, 1 << 14), None,
                       {"merge": lambda x, y: x + y})
    with pytest.raises(ValueError, match="join_pair_cap_entries") as je:
        j_exec.execute(jnode, mesh8)
    x = _unevaluable((2, 8))
    tnode = TE.MatExpr("join_rows", (x, x), (1 << 13, 1 << 14), None,
                       {"merge": lambda x, y: x + y})
    with pytest.raises(ValueError, match="join_pair_cap_entries") as te:
        ts.compute(tnode)
    assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="row join needs equal row"):
        TR.join_on_rows(ts.from_numpy(np.zeros((2, 2))),
                        ts.from_numpy(np.zeros((3, 2))), "add")
    with pytest.raises(ValueError, match="col join needs equal col"):
        TR.join_on_cols(ts.from_numpy(np.zeros((2, 2))),
                        ts.from_numpy(np.zeros((2, 3))), "add")


# -- COO relational (host) ----------------------------------------------------


@pytest.fixture(scope="module")
def coo_pair():
    rng = np.random.default_rng(16)
    n, m, e = 40, 30, 300
    rows, cols = rng.integers(0, n, e), rng.integers(0, m, e)
    vals = rng.choice(np.array([-2.0, -1.0, 0.5, 1.0, 2.0, 3.0],
                               np.float32), e)
    return (JCOO.from_edges(rows, cols, vals, shape=(n, m)),
            COOMatrix.from_edges(rows, cols, vals, shape=(n, m)))


def _edges(c):
    order = np.lexsort((c.cols, c.rows))
    return c.rows[order], c.cols[order], c.vals[order]


def test_coo_selections_and_coalesce_match_jax(coo_pair):
    jc, tc = coo_pair
    for jx, tx in ((jc.coalesce(), tc.coalesce()),
                   (jc.select_value(lambda v: v > 0.75),
                    tc.select_value(lambda v: v > 0.75)),
                   (jc.select_index(rows=lambda i: i % 3 == 0,
                                    cols=lambda j: j < 20),
                    tc.select_index(rows=lambda i: i % 3 == 0,
                                    cols=lambda j: j < 20))):
        for u, v in zip(_edges(jx), _edges(tx)):
            np.testing.assert_array_equal(u, v)
        assert tx.shape == jx.shape
    with pytest.raises(ValueError, match="fill=0"):
        tc.select_value(lambda v: v > 0, fill=1.0)


@pytest.mark.parametrize("kind", KINDS)
def test_coo_aggregates_match_jax(coo_pair, kind):
    jc, tc = coo_pair
    for axis in ("row", "col"):
        np.testing.assert_allclose(tc._axis_agg(axis, kind),
                                   jc._axis_agg(axis, kind), rtol=1e-6)
    name = {"sum": "sum", "count": "count", "avg": "avg", "max": "max",
            "min": "min"}[kind]
    np.testing.assert_allclose(getattr(tc, f"row_{name}")(),
                               getattr(jc, f"row_{name}")(), rtol=1e-6)
    np.testing.assert_allclose(getattr(tc, f"col_{name}")(),
                               getattr(jc, f"col_{name}")(), rtol=1e-6)


def test_coo_norm_trace_sum_match_jax(coo_pair):
    jc, tc = coo_pair
    sq = COOMatrix.from_edges(tc.rows % 30, tc.cols, tc.vals, (30, 30))
    jsq = JCOO.from_edges(jc.rows % 30, jc.cols, jc.vals, shape=(30, 30))
    assert sq.trace() == pytest.approx(jsq.trace(), rel=1e-6)
    assert tc.sum() == pytest.approx(jc.sum(), rel=1e-6)
    for kind in ("fro", "l1", "max"):
        assert tc.norm(kind) == pytest.approx(jc.norm(kind), rel=1e-12)
    with pytest.raises(ValueError, match="unknown norm"):
        tc.norm("nuc")


def test_coo_join_on_index_matches_jax(coo_pair):
    jc, tc = coo_pair
    rng = np.random.default_rng(17)
    r, c = rng.integers(0, 40, 200), rng.integers(0, 30, 200)
    v = rng.standard_normal(200).astype(np.float32)
    jo = jc.join_on_index(JCOO.from_edges(r, c, v, shape=(40, 30)),
                          np.multiply)
    to = tc.join_on_index(COOMatrix.from_edges(r, c, v, shape=(40, 30)),
                          np.multiply)
    for u, w in zip(_edges(jo), _edges(to)):
        np.testing.assert_array_equal(u, w)
    with pytest.raises(ValueError, match="merge\\(0, 0\\)"):
        tc.join_on_index(tc, lambda x, y: x + y + 1)


@pytest.mark.parametrize("pred", ["eq", "lt", "ge", "callable"])
def test_coo_join_on_value_matches_jax(coo_pair, pred):
    jc, tc = coo_pair
    p = (lambda x, y: x > y + 1) if pred == "callable" else pred
    for merge in MERGES:
        jo = jc.join_on_value(jc, merge, p, max_pairs=1 << 20)
        to = tc.join_on_value(tc, merge, p, max_pairs=1 << 20)
        key = lambda t: np.lexsort((t[3], t[2], t[1], t[0]))
        for u, w in zip(jo, to):
            np.testing.assert_array_equal(np.asarray(u)[key(jo)],
                                          np.asarray(w)[key(to)])
    with pytest.raises(ValueError, match="max_pairs"):
        tc.join_on_value(tc, "mul", p, max_pairs=10)


def test_selected_coo_goes_on_to_the_kernels(coo_pair):
    """σ-filtered COOMatrix → matvec / matmat / compute (the compact SpMV
    path; its plain version on the CPU)."""
    _, tc = coo_pair
    sel = tc.select_value(lambda v: v > 0.75)
    dense = sel.to_dense().astype(np.float64)
    x = np.random.default_rng(18).standard_normal(30).astype(np.float32)
    X = np.random.default_rng(19).standard_normal((30, 4)).astype(np.float32)
    np.testing.assert_allclose(sel.matvec(x, device="cpu").numpy(),
                               dense @ x, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(sel.matmat(X, device="cpu").numpy(),
                               dense @ X, rtol=1e-5, atol=1e-5)
    s = MatrelSession(device="cpu")
    got = s.compute(sel.multiply(s.from_numpy(x[:, None]))).to_numpy()
    np.testing.assert_allclose(got[:, 0], dense @ x, rtol=1e-5, atol=1e-5)


# -- workloads on the relational surface --------------------------------------


def test_triangles_dense_block_sparse_and_sql_match_jax(jmesh, ts):
    """trace(A³)/6 through the dense leaf, a block-sparse leaf (the S×S
    registry, stamped as the JAX package stamps it) and SQL — exact
    integer counts, equal to the JAX package's and to numpy."""
    from matrel_tpu.core.sparse import BlockSparseMatrix as JBS
    from matrel_tpu.workloads import triangles as jtri
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.workloads import triangles as ttri
    rng = np.random.default_rng(20)
    n = 48
    a = (rng.random((n, n)) < 0.2).astype(np.float32)
    a[:16, 32:] = a[32:, :16] = 0                  # leave empty tiles
    a = np.triu(a, 1)
    a = a + a.T
    want = ttri.triangles_numpy_oracle(a)
    (JA, TA), = jt(jmesh, ts, a)
    assert ttri.triangle_count(TA, ts) == want
    jgot = float(np.asarray(j_exec.execute(jtri.triangle_count_expr(JA),
                                           jmesh).to_numpy())[0, 0]) / 6
    assert jgot == want
    # block-diagonal communities: S·S dispatches the S×S SpGEMM
    nb, bs = 96, 8
    c = np.zeros((nb, nb), np.float32)
    for k in range(0, nb, bs):
        c[k:k + bs, k:k + bs] = rng.random((bs, bs)) < 0.5
    c = np.triu(c, 1)
    c = c + c.T
    S = BlockSparseMatrix.from_numpy(c, block_size=bs, mesh=ts.mesh)
    JS = JBS.from_numpy(c, block_size=bs, mesh=jmesh)
    assert ttri.triangle_count(S, ts) == ttri.triangles_numpy_oracle(c) > 0
    tplan = ts.compile(ttri.triangle_count_expr(S))
    from matrel_tpu.config import MatrelConfig as JConfig
    # the JAX package stamps its Pallas ids with Pallas on (interpret
    # mode on the CPU), the counterpart of the port's kernels
    jplan = j_exec.compile_expr(jtri.triangle_count_expr(JS), jmesh,
                                JConfig(pallas_interpret=True))

    def kernels(e):
        found = [e.attrs["spgemm_kernel"]] if "spgemm_kernel" in e.attrs \
            else []
        return found + [k for c in e.children for k in kernels(c)]

    assert kernels(tplan.optimized) == kernels(jplan.optimized)
    assert kernels(tplan.optimized)
    ts.register("G", TA)
    got = ts.compute(ts.sql("SELECT trace(G * G * G) FROM G")).to_numpy()
    assert got[0, 0] / 6 == want
    with pytest.raises(ValueError, match="square"):
        ttri.triangle_count_expr(ts.from_numpy(np.zeros((3, 4))))


@pytest.mark.parametrize("precision", ["highest", "high"])
def test_cosine_similarity_matches_jax(jmesh, precision):
    """S = D⁻¹(X·Xᵀ)D⁻¹ at "highest" and at "high" (the symmetric bf16
    split of the Gram), then σ(v > 0.5) on it: the JAX package's answer
    within its workload tests' tolerance (1e-4 at "highest"; 2e-3 at
    "high", the bf16x3 error bound)."""
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.session import MatrelSession as JSession
    from matrel_tpu.workloads import similarity as jsim
    from matrel_tpu_torch.workloads import similarity as tsim
    x = np.random.default_rng(21).standard_normal((24, 10)).astype(
        np.float32)
    js = JSession(mesh=jmesh, config=JConfig(matmul_precision=precision))
    s = MatrelSession(config=MatrelConfig(matmul_precision=precision),
                      device="cpu")
    want = tsim.cosine_similarity_numpy_oracle(x.astype(np.float64))
    tol = 1e-4 if precision == "highest" else 2e-3
    got = tsim.cosine_similarity(s.from_numpy(x), s)
    jgot = np.asarray(js.compute(jsim.cosine_similarity_expr(
        js.from_numpy(x))).to_numpy())
    np.testing.assert_allclose(got, want, atol=tol)
    np.testing.assert_allclose(got, jgot, atol=tol)
    sel = s.compute(tsim.cosine_similarity_expr(s.from_numpy(x))
                    .select_value(lambda v: v > 0.5)).to_numpy()
    keep = want > 0.5 + tol
    np.testing.assert_allclose(sel[keep], want[keep], atol=tol)
    assert np.all(sel[want < 0.5 - tol] == 0)
