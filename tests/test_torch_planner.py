"""PyTorch port: planner stamps held against the committed plan-snapshot
corpus (tests/plan_snapshots.json, tools/plan_snapshot.py).

Each corpus expression is built by the JAX package's own corpus builder
on the (2, 4) test grid, carried node for node into the port's IR
(leaves through ``matrel_tpu_torch.convert``), optimized and annotated
by the port on the same virtual (2, 4) grid, and its signature — node
kinds, strategy with source, join schemes, inferred layouts — must equal
the snapshot's. Cases whose node kinds the port does not lower yet are
listed in ``NOT_PORTED`` (and in ROADMAP.md); none are left.
"""

import importlib.util
import json
import os

import pytest

from matrel_tpu_torch import convert
from matrel_tpu_torch.core.mesh import make_mesh
from matrel_tpu_torch.ir import expr as TE, rules as t_rules
from matrel_tpu_torch.parallel import planner as t_planner

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: corpus cases the port's slices cover (leaf, sparse_leaf, coo_leaf,
#: transpose, matmul, solve, elemwise, scalar, agg, join_rows; rank1 is
#: rewritten away by R8)
COVERED = ("block_sparse_matmul", "chain_interior_credit",
           "chain_layout_flip", "chain_skewed", "coo_spmv_matvec",
           "gram_AtA", "join_under_matmul", "linreg_normal_equations",
           "rank1_pushdown", "replicated_operand_matmul")
#: cases left for later slices
NOT_PORTED = ()


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "plan_snapshot", os.path.join(REPO, "tools", "plan_snapshot.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def corpus(mesh8):
    tool = _load_tool()
    with open(tool.SNAPSHOT_PATH) as f:
        want = json.load(f)
    return dict(tool.corpus(mesh8)), want


def to_port(e, tmesh, memo=None):
    """Carry a JAX-package MatExpr into the port's IR node for node
    (same kind, shape, nnz and attrs; matrices through convert; a
    structured join merge rebuilt from its ``merge_kind`` by the port's
    ``resolve_join_merge``, since a JAX callable cannot run here)."""
    memo = {} if memo is None else memo
    if e.uid in memo:
        return memo[e.uid]
    attrs = dict(e.attrs)
    if "matrix" in attrs:
        attrs["matrix"] = convert.from_reference(attrs["matrix"], tmesh)
    if attrs.get("merge_kind") is not None:
        attrs["merge"] = TE.resolve_join_merge(attrs["merge_kind"])[1]
    out = TE.MatExpr(e.kind, tuple(to_port(c, tmesh, memo)
                                   for c in e.children),
                     tuple(e.shape), e.nnz, attrs)
    memo[e.uid] = out
    return out


def signature(e, mesh, lmemo):
    sig = {"kind": e.kind, "shape": list(e.shape)}
    if "strategy" in e.attrs:
        sig["strategy"] = e.attrs["strategy"]
        sig["source"] = e.attrs.get("strategy_source")
    if "replicate" in e.attrs:
        sig["scheme"] = e.attrs["replicate"]
    lay = t_planner.infer_layout(e, mesh, lmemo)
    if lay != "2d":
        sig["layout"] = lay
    if e.children:
        sig["children"] = [signature(c, mesh, lmemo) for c in e.children]
    return sig


def test_corpus_split_is_complete(corpus):
    names, want = corpus
    assert set(COVERED) | set(NOT_PORTED) == set(names) == set(want)
    assert not set(COVERED) & set(NOT_PORTED)


@pytest.mark.parametrize("name", COVERED)
def test_port_reproduces_snapshot(corpus, name):
    names, want = corpus
    tmesh = make_mesh((2, 4), device="cpu")
    e = to_port(names[name], tmesh)
    opt = t_planner.annotate_strategies(
        t_rules.optimize(e, grid=tmesh.grid, mesh=tmesh), tmesh)
    got = signature(opt, tmesh, {})
    assert got == want[name], (
        f"port plan for {name!r} differs from the snapshot\n"
        f"port: {json.dumps(got, sort_keys=True)}\n"
        f"snap: {json.dumps(want[name], sort_keys=True)}")


def test_single_card_stamps_default(corpus):
    """On the 1x1 grid of one card every matmul stamps xla/default."""
    names, _ = corpus
    tmesh = make_mesh(device="cpu")
    e = to_port(names["chain_skewed"], tmesh)
    opt = t_planner.annotate_strategies(
        t_rules.optimize(e, grid=tmesh.grid, mesh=tmesh), tmesh)
    stamps = set()

    def walk(n):
        if n.kind == "matmul":
            stamps.add((n.attrs["strategy"], n.attrs["strategy_source"]))
        for c in n.children:
            walk(c)

    walk(opt)
    assert stamps == {("xla", "default")}
