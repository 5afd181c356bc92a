"""Sharding-flow check (MV102): every layout the cost model CLAIMS for
a matmul's output must be one its lowering actually PINS.

``planner.infer_layout`` hands out co-partitioning credits ("this bmm
output is row-sharded, the consumer reads it free") that change
strategy rankings and join schemes. The executor only honours those
claims where the lowering hard-codes an output layout — sparse_leaf
matmuls run the SpMM path (B1) and wide/refused COO matmuls run the
dense product, both IGNORING the stamped strategy, so consulting
STRATEGY_OUT_LAYOUT there would claim a "row"/"col" the executor never
produces (an unearned free-consume credit). This
pass re-derives the pinned layout from the executor's own dispatch
predicates and out_spec contracts and diffs it against the claim, so
that fix can never silently regress and no new dispatch can earn a
credit without pinning it.

Severity is "warning": a false claim mis-COSTS the plan (a worse
strategy may win, an extra reshard is unpriced) but the computed
numbers stay correct — the lowering performs the resharding the model
forgot.
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr
from matrel_tpu_torch.parallel import planner


def pinned_matmul_layout(node, mesh, config) -> str:
    """Output layout the EXECUTOR's matmul lowering actually pins for
    this node, mirrored from Lowerer._matmul's dispatch order via the
    executor's single-source-of-truth predicates. "2d" doubles as
    "no claim" — the conservative answer for paths whose output
    layout the lowering does not pin."""
    from matrel_tpu_torch import executor as exec_lib
    # branch order mirrors Lowerer._matmul: spgemm, then coo_leaf on
    # EITHER side, then sparse_leaf (a mixed coo×sparse matmul runs
    # the COO path, and its compact lowering pins "rep")
    if exec_lib._spgemm_dispatch(node, config):
        return "2d"         # apply_dense scatters to the canonical layout
    if any(c.kind == "coo_leaf" for c in node.children):
        if exec_lib._coo_dispatch_plan(node) is None:
            return "2d"     # densify path: hard-coded xla
        # the compact path (B2/B3) pins a replicated output on one
        # device; the JAX package's compact SHARDED path (which pins
        # "rep" on a multi-device grid) is not ported, so a virtual
        # grid pins nothing — planner.infer_layout's port rule
        return "rep" if mesh.size == 1 else "2d"
    if any(c.kind == "sparse_leaf" for c in node.children):
        return "2d"         # SpMM path ignores the stamp
    return planner.STRATEGY_OUT_LAYOUT.get(node.attrs.get("strategy"),
                                           "2d")


def check_layout_claims(root, mesh, config) -> Iterator[Diagnostic]:
    """MV102 on every matmul node: planner.infer_layout's claim must
    equal the pinned layout. Non-matmul nodes propagate claims
    structurally (transpose swaps, elemwise agrees, …) — the matmul
    rule is where claims are MINTED, so that is what gets verified."""
    seen = set()
    lmemo: dict = {}

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind != "matmul":
            return
        claimed = planner.infer_layout(n, mesh, lmemo, config)
        pinned = pinned_matmul_layout(n, mesh, config)
        if claimed != pinned:
            yield Diagnostic(
                code="MV102", severity="warning", node=node_addr(n),
                message=f"cost model claims output layout {claimed!r} "
                        f"but the lowering pins {pinned!r} — a "
                        "co-partitioning credit the executor never "
                        "earns (or a free consume it never reports)",
                fix_hint="teach planner.infer_layout's matmul rule the "
                         "dispatch this node takes, or re-plan under "
                         "the executing config")

    yield from walk(root)
