"""PyTorch port: the randomized expression fuzzer
(``matrel_tpu_torch/tools/fuzz.py``) held against the JAX package's
``tests/test_fuzz.py``, case for case.

Every parametrised case of ``tests/test_fuzz.py`` is one case here. Each
builds the same seed's tree with both generators and first asserts that
the trees are the same: node kinds, shapes, scalar constants, join kinds,
σ predicates (evaluated on an index range), dense leaf dtypes and specs,
and leaf arrays bit-equal. It then compiles the tree in both packages —
the JAX package on its conftest mesh, the port on the same virtual grid
of one CPU device — and holds the port's answer against the JAX
package's and both against ``np_eval`` at that test's own tolerance.
Where ``tests/test_fuzz.py`` compiles optimized and unoptimized plans,
each plan's stamps (every node's kind, shape and plain attrs, in
post-order) are compared between the packages. The dtype case compares
the predicted and executed tensor dtypes.
"""

import importlib.util
import os

import numpy as np
import pytest

from matrel_tpu import executor as j_exec
from matrel_tpu.config import MatrelConfig as JConfig
from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
from matrel_tpu.ir import expr as JE
from matrel_tpu.parallel.planner import infer_dtype as j_infer_dtype

from matrel_tpu_torch import executor as t_exec
from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.blockmatrix import BlockMatrix as TBM
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.ir import expr as TE
from matrel_tpu_torch.parallel.planner import infer_dtype as t_infer_dtype
from matrel_tpu_torch.tools import fuzz as tfuzz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_spec = importlib.util.spec_from_file_location(
    "_jax_fuzz_generator", os.path.join(REPO, "tests", "test_fuzz.py"))
jfuzz = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jfuzz)

RAW = dict(rewrite_rules=False, chain_opt=False)
_PLAIN = (str, int, float, bool, type(None))


@pytest.fixture(scope="module")
def tmesh8():
    return make_mesh((2, 4), device="cpu")


@pytest.fixture(scope="module")
def tmesh_square():
    return make_mesh((2, 2), device="cpu")


# -- the two trees ------------------------------------------------------------


def _plain_attrs(n):
    return {k: v for k, v in n.attrs.items()
            if isinstance(v, _PLAIN) or (isinstance(v, tuple) and all(
                isinstance(x, _PLAIN) for x in v))}


def _dtype_name(m):
    return str(m.dtype).replace("torch.", "")


def assert_same_tree(je, jenv, te, tenv):
    """The same node kinds, shapes, constants and predicates, and leaf
    arrays bit-equal, walking both trees in step."""
    assert je.kind == te.kind and tuple(je.shape) == tuple(te.shape), (
        je.kind, je.shape, te.kind, te.shape)
    assert len(je.children) == len(te.children), je.kind
    assert _plain_attrs(je) == _plain_attrs(te), (je.kind, je.attrs,
                                                  te.attrs)
    if je.kind in ("leaf", "sparse_leaf", "coo_leaf"):
        a, b = jenv[je.uid], tenv[te.uid]
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), je.kind
        if je.kind == "leaf":
            jm, tm = je.attrs["matrix"], te.attrs["matrix"]
            assert _dtype_name(jm) == _dtype_name(tm)
            assert tuple(jm.spec) == tuple(tm.spec), (jm.spec, tm.spec)
    if je.kind == "select_index":
        idx = np.arange(64)
        for key in ("rows", "cols"):
            fj, ft = je.attrs[key], te.attrs[key]
            assert (fj is None) == (ft is None)
            if fj is not None:
                assert np.array_equal(np.asarray(fj(idx)),
                                      np.asarray(ft(idx)))
    if je.kind == "select_value":
        probe = np.linspace(-1, 1, 41, dtype=np.float32)
        assert np.array_equal(np.asarray(je.attrs["predicate"](probe)),
                              np.asarray(te.attrs["predicate"](probe)))
    if je.kind in ("join_index", "join_value"):
        assert je.attrs.get("merge_kind") == te.attrs.get("merge_kind")
        assert je.attrs.get("pred_kind") == te.attrs.get("pred_kind")
    for cj, ct in zip(je.children, te.children):
        assert_same_tree(cj, jenv, ct, tenv)


def both_trees(seed, jmesh, tmesh, depth_of, **kw):
    """(JAX tree, its env, port tree, its env) of one seed, each drawn
    from a fresh ``default_rng(seed)``; ``depth_of(rng)`` draws the depth
    as the JAX test does, before the tree."""
    out = []
    for gen, mesh in ((jfuzz.gen_expr, jmesh), (tfuzz.gen_expr, tmesh)):
        rng = np.random.default_rng(seed)
        env = {}
        out.append((gen(rng, env, mesh, depth=depth_of(rng), **kw), env))
    (je, jenv), (te, tenv) = out
    assert_same_tree(je, jenv, te, tenv)
    return je, jenv, te, tenv


def _post_order(root):
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


def stamps(plan):
    """Every node of the optimized plan as (kind, shape, plain attrs), in
    post-order: strategies, precision tiers, layouts, chain orders."""
    return [(n.kind, tuple(n.shape), sorted(_plain_attrs(n).items()))
            for n in _post_order(plan.optimized)]


def run_both(je, te, jmesh, tmesh, jcfg, tcfg):
    """(JAX answer, port answer), with the plans' stamps held equal."""
    jplan = j_exec.compile_expr(je, jmesh, jcfg)
    tplan = t_exec.compile_expr(te, tmesh, tcfg)
    assert stamps(tplan) == stamps(jplan)
    return jplan.run().to_numpy(), tplan.run().to_numpy()


def assert_three(jgot, tgot, oracle, tag, **tol):
    np.testing.assert_allclose(tgot, jgot, **tol,
                               err_msg=f"port != JAX package ({tag})")
    np.testing.assert_allclose(jgot, oracle, **tol,
                               err_msg=f"JAX package != numpy ({tag})")
    np.testing.assert_allclose(tgot, oracle, **tol,
                               err_msg=f"port != numpy ({tag})")


def _opt_and_raw(seed, je, jenv, te, jmesh, tmesh):
    oracle = jfuzz.np_eval(je, jenv)
    for name, jcfg, tcfg in (
            ("unoptimized", JConfig(**RAW), MatrelConfig(**RAW)),
            ("optimized", JConfig(), MatrelConfig())):
        jgot, tgot = run_both(je, te, jmesh, tmesh, jcfg, tcfg)
        assert_three(jgot, tgot, oracle, f"{name}, seed {seed}",
                     rtol=2e-3, atol=2e-3)


# -- the cases of tests/test_fuzz.py -------------------------------------------


@pytest.mark.parametrize("seed", range(20))
def test_optimized_matches_unoptimized_and_numpy(seed, mesh8, tmesh8):
    je, jenv, te, tenv = both_trees(
        seed, mesh8, tmesh8, lambda r: int(r.integers(2, 5)))
    assert np.array_equal(tfuzz.np_eval(te, tenv), jfuzz.np_eval(je, jenv))
    _opt_and_raw(seed, je, jenv, te, mesh8, tmesh8)


@pytest.mark.parametrize("seed", range(40, 55))
def test_fuzz_mixed_leaf_kinds(seed, mesh8, tmesh8):
    je, jenv, te, _ = both_trees(
        seed, mesh8, tmesh8, lambda r: int(r.integers(2, 4)),
        leaf_kinds=("dense", "dense", "sparse", "coo"))
    _opt_and_raw(seed, je, jenv, te, mesh8, tmesh8)


@pytest.mark.parametrize("seed", range(20, 28))
def test_fuzz_on_square_mesh(seed, mesh_square, tmesh_square):
    je, jenv, te, _ = both_trees(seed, mesh_square, tmesh_square,
                                 lambda r: 3)
    jgot, tgot = run_both(je, te, mesh_square, tmesh_square, JConfig(),
                          MatrelConfig())
    assert_three(jgot, tgot, jfuzz.np_eval(je, jenv), f"seed {seed}",
                 rtol=2e-3, atol=2e-3)


def _value_join_case(seed, BM, E, mesh):
    """tests/test_fuzz.py's value-join case in one package: (expr, want,
    axis, the draws as a tuple)."""
    rng = np.random.default_rng(seed)
    pool = np.array([-2.0, -1.0, -1.0, 0.0, 0.0, 0.5, 1.0, 1.0, 3.0],
                    np.float32)
    sa = (int(rng.integers(2, 7)), int(rng.integers(2, 7)))
    sb = (int(rng.integers(2, 7)), int(rng.integers(2, 7)))
    a = rng.choice(pool, sa).astype(np.float32)
    b = rng.choice(pool, sb).astype(np.float32)
    A = E.leaf(BM.from_numpy(a, mesh=mesh))
    B = E.leaf(BM.from_numpy(b, mesh=mesh))
    structured = bool(rng.random() < 0.7)
    if structured:
        pred = str(rng.choice(["eq", "lt", "le", "gt", "ge"]))
        merge = str(rng.choice(["left", "right", "add", "mul"]))
        pred_np = {"eq": np.equal, "lt": np.less, "le": np.less_equal,
                   "gt": np.greater, "ge": np.greater_equal}[pred]
        merge_np = {"left": lambda x, y: x + 0 * y,
                    "right": lambda x, y: y + 0 * x,
                    "add": np.add, "mul": np.multiply}[merge]
    else:
        pred = pred_np = lambda x, y: x + y > 0.25
        merge = merge_np = lambda x, y: x * y - x
    kind = str(rng.choice(["sum", "count", "avg", "max", "min"]))
    axis = str(rng.choice(["row", "col", "all"]))
    va, vb = a.T.reshape(-1), b.T.reshape(-1)
    P = merge_np(va[:, None].astype(np.float64), vb[None, :])
    P = np.where(pred_np(va[:, None], vb[None, :]), P, 0.0)
    ax = {"row": 1, "col": 0, "all": None}[axis]
    if kind == "sum":
        want = P.sum(axis=ax)
    elif kind == "count":
        want = (P != 0).sum(axis=ax).astype(np.float64)
    elif kind == "avg":
        s, c = P.sum(axis=ax), (P != 0).sum(axis=ax)
        want = np.where(c > 0, s / np.maximum(c, 1), 0.0)
    else:
        want = (np.max if kind == "max" else np.min)(P, axis=ax)
    expr = E.agg(E.join_on_value(A, B, merge, pred), kind, axis)
    draws = (a.tobytes(), b.tobytes(), sa, sb, structured,
             pred if structured else None, merge if structured else None,
             kind, axis)
    return expr, want, axis, draws, {A.uid: a, B.uid: b}


@pytest.mark.parametrize("seed", range(60, 75))
def test_fuzz_value_join_streaming_vs_pair_matrix(seed, mesh8, tmesh8):
    je, want, axis, jd, jenv = _value_join_case(seed, JBM, JE, mesh8)
    te, want_t, _, td, tenv = _value_join_case(seed, TBM, TE, tmesh8)
    assert jd == td and np.array_equal(want, want_t)
    assert_same_tree(je, jenv, te, tenv)
    jout, tout = run_both(je, te, mesh8, tmesh8, JConfig(), MatrelConfig())
    pick = {"row": lambda o: o[:, 0], "col": lambda o: o[0],
            "all": lambda o: o[0, 0]}[axis]
    assert_three(pick(jout), pick(tout), want, f"seed {seed}",
                 rtol=1e-4, atol=1e-4)


def _gram_case(seed, gen, mesh, E):
    rng = np.random.default_rng(seed)
    env = {}
    n = int(rng.integers(3, 9))
    k = int(rng.integers(2, 9))
    if rng.random() < 0.5:
        x = gen(rng, env, mesh, depth=int(rng.integers(1, 3)), shape=(k, n))
        e = E.matmul(E.transpose(x), x)
    else:
        x = gen(rng, env, mesh, depth=int(rng.integers(1, 3)), shape=(n, k))
        e = E.matmul(x, E.transpose(x))
    if rng.random() < 0.5:
        e = E.agg(e, "sum", str(rng.choice(["row", "all", "diag"])))
    return e, env


@pytest.mark.parametrize("seed", range(80, 92))
def test_fuzz_gram_high_precision(seed, mesh8, tmesh8):
    je, jenv = _gram_case(seed, jfuzz.gen_expr, mesh8, JE)
    te, tenv = _gram_case(seed, tfuzz.gen_expr, tmesh8, TE)
    assert_same_tree(je, jenv, te, tenv)
    oracle = jfuzz.np_eval(je, jenv)
    tol = dict(rtol=1e-2, atol=1e-2 * max(1.0, np.abs(oracle).max()))
    jcfg = JConfig(matmul_precision="high")
    tcfg = MatrelConfig(matmul_precision="high")
    for name, jc, tc in (("optimized", jcfg, tcfg),
                         ("unoptimized", jcfg.replace(**RAW),
                          tcfg.replace(**RAW))):
        jgot, tgot = run_both(je, te, mesh8, tmesh8, jc, tc)
        assert_three(jgot, tgot, oracle, f"{name}, seed {seed}", **tol)


def test_fuzz_infer_dtype_matches_executed_dtype(mesh8, tmesh8):
    """For the JAX test's 24 mixed bf16/f32 trees: the port predicts what
    the JAX package predicts, executes the dtype the JAX package
    executes, and its prediction, where it makes one, is its executed
    dtype; at least half the seeds predict."""
    jcfg, tcfg = JConfig(), MatrelConfig()
    predicted_count = 0
    n_seeds = 24
    for seed in range(n_seeds):
        je, _, te, _ = both_trees(
            4000 + seed, mesh8, tmesh8, lambda r: int(r.integers(2, 4)),
            dtype_pop=("float32", "bfloat16"), structured_join=True)
        jpred, tpred = j_infer_dtype(je, jcfg), t_infer_dtype(te, tcfg)
        jgot = j_exec.execute(je, mesh8, jcfg).data.dtype
        tgot = t_exec.execute(te, tmesh8, tcfg).data.dtype
        tname = str(tgot).replace("torch.", "")
        assert tname == np.dtype(jgot).name, (seed, tgot, jgot)
        assert (tpred is None) == (jpred is None), (seed, tpred, jpred)
        if tpred is not None:
            predicted_count += 1
            assert np.dtype(jpred).name == str(tpred).replace(
                "torch.", ""), (seed, tpred, jpred)
            assert str(tpred).replace("torch.", "") == tname, (
                f"seed {seed}: predicted {tpred}, executed {tgot}")
    assert predicted_count >= n_seeds // 2, predicted_count


@pytest.mark.parametrize("seed", range(60, 75))
def test_fuzz_random_leaf_layouts(seed, mesh8, tmesh8):
    je, jenv, te, _ = both_trees(
        seed, mesh8, tmesh8, lambda r: int(r.integers(2, 5)),
        rand_specs=True)
    jgot, tgot = run_both(je, te, mesh8, tmesh8, JConfig(), MatrelConfig())
    assert_three(jgot, tgot, jfuzz.np_eval(je, jenv),
                 f"layout fuzz, seed {seed}", rtol=2e-3, atol=2e-3)
