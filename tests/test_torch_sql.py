"""PyTorch port: the SQL surface (``matrel_tpu_torch/sql.py``,
``MatrelSession.sql`` / ``explain_sql``) held against the JAX package on
the CPU — the same query text over the same numpy tables, made from a
seed, through both sessions; the same malformed text refused by both
with ``SqlError``; and the plan cache keyed like the JAX package's
(``_fn_token``): identical query text hits, distinct predicates miss.

Tolerances are the JAX SQL tests' own (``tests/test_sql.py``): rtol
1e-4 / atol 1e-4 for products and aggregates, rtol 1e-5 for elementwise
and relational results; counts and selections exact.
"""

import jax
import numpy as np
import pytest

from matrel_tpu.core import mesh as jmesh_lib
from matrel_tpu.session import MatrelSession as JSession
from matrel_tpu.sql import SqlError as JSqlError

from matrel_tpu_torch import session as t_session
from matrel_tpu_torch.session import MatrelSession
from matrel_tpu_torch.sql import SqlError


@pytest.fixture(scope="module")
def sessions():
    rng = np.random.default_rng(42)
    a = rng.standard_normal((8, 6)).astype(np.float32)
    b = rng.standard_normal((6, 8)).astype(np.float32)
    u = rng.standard_normal((8, 1)).astype(np.float32)
    v = rng.standard_normal((6, 1)).astype(np.float32)
    p = (a @ b).astype(np.float32)
    js = JSession(mesh=jmesh_lib.make_mesh((1, 1),
                                           devices=jax.devices()[:1]))
    ts = MatrelSession(device="cpu")
    for s in (js, ts):
        for name, arr in (("A", a), ("B", b), ("U", u), ("V", v), ("P", p),
                          ("C", a + 0.5), ("t1", p), ("t2", p * 0.5)):
            s.register(name, s.from_numpy(arr))
    return js, ts


QUERIES = [
    "SELECT A * B FROM A, B",
    "rowsum(transpose(A))",
    "trace(A * B)",
    "elemmult(A, A) + 1.5",
    "2 * A",
    "-A",
    "A / (A + 10)",
    "A - 2",
    "select(A, 'v > 0')",
    "select(A, 'v > 0', -1)",
    "selectrows(A, 'i % 2 == 0')",
    "selectrows(A, 'i / 3 > 1 and not i == 7')",
    "selectcols(A, 'j < 3 or j ** 2 == 16')",
    "selectblocks(P, 'bi == bj', 4)",
    "joinindex(A, C, 'x * y')",
    "joinindex(A, C, 'add')",
    "joinrows(A, A, 'mul')",
    "joinrows(A, A, 'x + y')",
    "joincols(A, A, 'left')",
    "joincols(A, A, 'x - y')",
    "rowsum(joinvalue(A, B, 'mul', 'lt'))",
    "colmax(joinvalue(A, B, 'add', 'ge'))",
    "count(joinvalue(A, B, 'right', 'eq'))",
    "sum(joinvalue(A, B, 'x + 2 * y', 'x > y and y > 0'))",
    "joinvalue(A, B, 'mul', 'lt')",
    "rowsum(select(A, 'v > 0'))",
    "solve(multiply(transpose(A), A), multiply(transpose(A), U))",
    "inverse(multiply(transpose(A), A))",
    "norm(A)",
    'norm(A, "l1")',
    "A .* A",
    "A % A",
    "SELECT A + 0 WHERE v > 0.5",
    "SELECT A * B FROM A, B WHERE v < 0",
    "power(A, 2)",
    "vec(A)",
    "rowmax(A)", "rowmin(A)", "colmax(A)", "colmin(A)", "rowcount(A)",
    "colcount(A)", "rowavg(A)", "colavg(A)", "colsum(A)", "sum(A)",
    "max(A)", "min(A)", "count(A)", "avg(A)",
    "diagsum(P)", "diagmax(P)", "diagmin(P)", "diagcount(P)", "diagavg(P)",
    "max(A * B)",
    "SeLeCt rowsum(A) FROM A;;",
    "rankone(A, U, V)",
    "rankone(A, U, V) * B",
    "elemmin(A, C)", "elemmax(A, C)",
    "SELECT t1.*t2",
    "SELECT 2.*A",
    "trace(P * P * P) PRECISION 'exact'",
    "SELECT rowsum(A) FROM A PRECISION fast",
]


@pytest.mark.parametrize("q", QUERIES)
def test_query_matches_jax(sessions, q):
    js, ts = sessions
    want = np.asarray(js.compute(js.sql(q)).to_numpy())
    got = ts.compute(ts.sql(q)).to_numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4, err_msg=q)


BAD = [
    "SELECT Zed * A",
    "select(A, '__import__(\"os\").system(\"true\")')",
    "select(A, 'v.__class__')",
    "select(A, 'v .* v')",
    "2 % A",
    "SELECT A * B FROM A, Q",
    "SELECT A FROM A B",
    "SELECT A FROM ",
    "SELECT A WHERE ",
    "A **", "A .* ", "((A)", "select(A, 'v >')",
    "joinvalue(A, B, 'x +', 'lt')", "A @", "FROM A",
    'joinvalue(A, B, \'__import__("os").system("x")\', "lt")',
    "joinrows(A, A, 'open(\"/etc/passwd\")')",
    "selectblocks(A, '__class__', 4)",
    "joinvalue(A, B, 'x + y', 'exec(\"1\")')",
    "foo(A)",
    "select(A, 0)",
    "power(A, B)",
    "select(A, 'w > 0')",
    "2 - A",
    "A PRECISION ''",
    "A PRECISION 'ultra'",
]


@pytest.mark.parametrize("q", BAD)
def test_refusals_match_jax(sessions, q):
    js, ts = sessions
    with pytest.raises(JSqlError):
        js.sql(q)
    with pytest.raises(SqlError):
        ts.sql(q)


def test_identical_text_hits_the_plan_cache_like_jax():
    rng = np.random.default_rng(1)
    a = rng.standard_normal((6, 6)).astype(np.float32)
    js = JSession(mesh=jmesh_lib.make_mesh((1, 1),
                                           devices=jax.devices()[:1]))
    ts = MatrelSession(device="cpu")
    plans = []
    for s in (js, ts):
        s.register("A", s.from_numpy(a))
        q = "SELECT rowsum(select(A, 'v > 0')) FROM A"
        first = s.compute(s.sql(q)).to_numpy()
        n1 = s.plan_cache_info()["plans"]
        second = s.compute(s.sql(q)).to_numpy()          # a hit
        n2 = s.plan_cache_info()["plans"]
        s.compute(s.sql("SELECT rowsum(select(A, 'v > 1')) FROM A"))
        n3 = s.plan_cache_info()["plans"]                # a miss
        np.testing.assert_array_equal(first, second)
        plans.append((n1, n2, n3))
    assert plans[1] == plans[0] == (1, 1, 2)


def test_explain_sql(sessions):
    js, ts = sessions
    txt = ts.explain_sql("SELECT rowsum(A * B) FROM A, B")
    opt = txt.split("== Optimized plan ==")[1]
    first = [ln for ln in opt.splitlines() if ln.strip()][0]
    jopt = js.explain_sql("SELECT rowsum(A * B) FROM A, B").split(
        "== Optimized plan ==")[1]
    assert first.startswith("matmul") and jopt.lstrip().startswith("matmul")
    txt2 = ts.explain_sql("rowsum(joinvalue(A, B, 'mul', 'lt'))")
    assert "join_value merge=mul pred=lt" in txt2
    assert "join_value merge=<callable> pred=<callable>" in ts.explain_sql(
        "sum(joinvalue(A, B, 'x * y', 'x < y'))")
    txt3 = ts.explain_sql("joinrows(A, A, 'x + y')")
    assert "join_rows replicate=left" in txt3
    # EXPLAIN ANALYZE: the measured per-op tree beside the plan
    txt4 = ts.explain_sql("sum(A)", analyze=True)
    assert "== Analyzed physical plan" in txt4
    assert "plan as run:" in txt4


def test_precision_clause_isolates_the_cache(sessions):
    _, ts = sessions
    e = ts.sql("SELECT A * B FROM A, B PRECISION 'fast'")
    assert e._sql_precision == "fast"
    plan = ts.compile(e)
    assert plan.config.precision_sla == "fast"
    assert ts.compile(e, precision="exact").config.precision_sla == "exact"


# -- plan-cache keys of callables (_fn_token) ---------------------------------


def _key(fn):
    return t_session._attr_token(fn, [])


def test_fn_token_keys_by_behaviour():
    f1 = lambda v: v > 0
    f2 = lambda v: v > 0
    f3 = lambda v: v > 1
    assert _key(f1) == _key(f2) != _key(f3)

    def make(t):
        return lambda v: v > t

    assert _key(make(0.5)) == _key(make(0.5)) != _key(make(-0.5))


THRESH = 0.5


def test_fn_token_reads_globals_defaults_and_bound_state():
    global THRESH
    f = lambda v: v > THRESH
    k1 = _key(f)
    THRESH = -0.5
    try:
        assert _key(f) != k1
    finally:
        THRESH = 0.5
    assert _key(lambda v, t=1: v > t) != _key(lambda v, t=2: v > t)

    class Thresh:
        def __init__(self, t):
            self.t = t

        def pred(self, v):
            return v > self.t

    pins = []
    a, b = Thresh(1), Thresh(1)
    assert t_session._attr_token(a.pred, pins) != t_session._attr_token(
        b.pred, pins)                    # instances key by pinned identity
    assert a in pins and b in pins


def test_fn_token_prefers_the_sql_tag_and_pins_identity_keys():
    f = lambda v: v > 0
    f.__matrel_key__ = "sql(v):v > 0"
    assert _key(f) == "fnkey:sql(v):v > 0"
    pins = []
    tok = t_session._attr_token(np.maximum, pins)     # no __code__
    assert tok.startswith("fnid:") and pins == [np.maximum]
    big = list(range(1000))
    pins = []
    assert t_session._attr_token(big, pins).startswith("bigcont:")
    assert pins == [big]
    cyc = []
    cyc.append(cyc)
    assert "cyc:" in t_session._attr_token(cyc, [])


def test_distinct_predicates_key_distinct_plans():
    ts = MatrelSession(device="cpu")
    A = ts.from_numpy(np.arange(12, dtype=np.float32).reshape(3, 4))
    outs = [ts.compute(A.select_value(lambda v, t=t: v > t)).to_numpy()
            for t in (2.0, 5.0, 2.0)]
    assert ts.plan_cache_info()["plans"] == 2
    np.testing.assert_array_equal(outs[0], outs[2])
    assert not np.array_equal(outs[0], outs[1])
