"""Strategy-stamp consistency passes: MV101 (admissibility) and MV104
(SpGEMM dispatch consistency).

The planner stamps every matmul with ``attrs["strategy"]``; the
executor's strategy recipes then carve the PADDED dims by that
strategy's layouts. A stamp outside the admissible set would make the
recipe's blocks fail to divide — a lowering-time crash at best, a
silent fallback at worst — and a stamp the lowering will not actually
run (the S×S SpGEMM dispatch ignores the byte model entirely) makes
every obs/ report and comm estimate describe a program that never
executes. Both are exactly the class of plan bug arXiv:2112.01075
argues must be caught before the chip sees the program.
"""

from __future__ import annotations

from typing import Iterator, Optional

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr
from matrel_tpu_torch.core import mesh as mesh_lib, padding
from matrel_tpu_torch.parallel import planner

#: Strategy vocabulary a stamp may carry (planner.STRATEGY_OUT_LAYOUT
#: is the one shared mapping; "spgemm" is the dispatch stamp).
KNOWN_STRATEGIES = tuple(planner.STRATEGY_OUT_LAYOUT)


def _dispatch_kind(node, config) -> Optional[str]:
    """Which off-strategy fast path the lowering takes for this matmul,
    or None for the dense strategy path. Consults the executor's OWN
    single-source-of-truth predicates (never a re-derivation), and
    checks them in Lowerer._matmul's exact ORDER — spgemm, then
    coo_leaf on either side, then sparse_leaf: a mixed coo×sparse
    matmul takes the COO path, not SpMM (the sparse-first order would
    misclassify that mix)."""
    from matrel_tpu_torch import executor as exec_lib
    if exec_lib._spgemm_dispatch(node, config):
        return "spgemm"
    if any(c.kind == "coo_leaf" for c in node.children):
        return ("coo_spmv" if exec_lib._coo_dispatch_plan(node) is not None
                else "densify")
    if any(c.kind == "sparse_leaf" for c in node.children):
        return "spmm"
    return None


def check_strategy_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    """MV101: every stamped strategy must be (a) in the known
    vocabulary and (b) admissible for the node's padded dims on this
    mesh grid — divisibility AND the HBM budget, the same
    ``planner.admissible`` gate the planner itself now runs, re-checked
    here so a plan annotated under a DIFFERENT mesh/config (a cached or
    hand-stamped plan) cannot smuggle an infeasible recipe through.
    Dispatch-overridden matmuls (SpMM/SpMV/SpGEMM paths) skip (b): the
    stamp is reporting metadata there, not a strategy recipe."""
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    seen = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind != "matmul" or "strategy" not in n.attrs:
            return
        strat = n.attrs["strategy"]
        if strat not in KNOWN_STRATEGIES:
            yield Diagnostic(
                code="MV101", severity="error", node=node_addr(n),
                message=f"stamped strategy {strat!r} is not in the "
                        f"planner vocabulary {KNOWN_STRATEGIES}",
                fix_hint="re-run planner.annotate_strategies, or fix "
                         "the strategy_override string")
            return
        if _dispatch_kind(n, config) is not None:
            return          # fast-path dispatch: no strategy recipe runs
        a, b = n.children
        nn, kk = a.shape
        mm = b.shape[1]
        pn, pk = padding.padded_shape((nn, kk), mesh)
        _, pm = padding.padded_shape((kk, mm), mesh)
        if not planner.admissible(strat, pn, pk, pm, gx, gy,
                                  hbm_budget_bytes=0):
            yield Diagnostic(
                code="MV101", severity="error", node=node_addr(n),
                message=f"stamped strategy {strat!r} cannot divide the "
                        f"padded dims ({pn}, {pk}, {pm}) on the "
                        f"{gx}x{gy} grid",
                fix_hint="the plan was annotated for a different "
                         "mesh/padding — re-plan on this mesh")

    yield from walk(root)


def check_spgemm_dispatch(root, mesh, config) -> Iterator[Diagnostic]:
    """MV104: a ``("spgemm", "dispatch")`` stamp and the executor's
    ``_spgemm_dispatch`` predicate must agree in BOTH directions.

    Stamp without dispatch: the lowering will densify (or run a
    dense strategy) while obs/explain report a SpGEMM that never
    ran and the comm model priced 0 bytes — the estimated-savings
    records (``spgemm_estimates``) become fiction. Dispatch without
    stamp: the lowering runs the tile-intersection kernel while the
    plan claims a dense strategy, so ``to_dense`` no-densify guarantees
    are asserted against the wrong path. The no-densify guarantee
    itself holds exactly when the stamp is truthful: the dispatch
    predicate requires both operands to be sparse leaves and the
    estimated output block density under the threshold, and the
    spgemm lowering (ops/spgemm.py) touches only the operand tile
    stacks — no ``to_dense`` is reachable from a truthfully-stamped
    node (test_spgemm.py's poisoned-to_dense test proves it
    dynamically; this pass pins it statically)."""
    seen = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind != "matmul":
            return
        stamped = n.attrs.get("strategy") == "spgemm"
        dispatches = _dispatch_kind(n, config) == "spgemm"
        if stamped and not dispatches:
            yield Diagnostic(
                code="MV104", severity="error", node=node_addr(n),
                message="stamped ('spgemm', "
                        f"{n.attrs.get('strategy_source', '?')!r}) but "
                        "executor._spgemm_dispatch refuses this node "
                        "under the verifying config — the lowering "
                        "would densify while the plan reports a "
                        "no-densify SpGEMM",
                fix_hint="re-plan under the executing config (the "
                         "spgemm_density_threshold or operand stats "
                         "changed since annotation)")
        elif dispatches and not stamped:
            yield Diagnostic(
                code="MV104", severity="error", node=node_addr(n),
                message=f"executor will dispatch the S×S SpGEMM but "
                        f"the stamp says "
                        f"{n.attrs.get('strategy', '<unstamped>')!r} — "
                        "obs/explain would misreport what executes",
                fix_hint="stamp via planner.annotate_strategies instead "
                         "of hand-setting attrs['strategy']")

    yield from walk(root)


def check_spgemm_kernel(root, mesh, config) -> Iterator[Diagnostic]:
    """MV110: a stamped ``spgemm_kernel`` must be truthful in BOTH
    directions under the verifying config.

    Forward: the stamped kernel id must exist in the registry
    (ops/kernel_registry.py), be runnable here (a kernel id stamped
    where its kernel cannot run would crash — or silently densify — at
    lowering), and be admissible for the operand pair's structure
    class: a specialized kernel stamped on a FOREIGN structure (absent
    the config forcing knob) means the plan was annotated under
    different operand statistics, so its cost record describes a
    schedule the registry would no longer pick. The stamped structure
    class itself is re-derived and compared, the MV104 re-check
    discipline. Backward: a kernel stamp on a node that does NOT
    dispatch the SpGEMM path is reporting metadata for a lowering that
    never runs."""
    from matrel_tpu_torch import executor as exec_lib
    from matrel_tpu_torch.ir import stats
    from matrel_tpu_torch.ops import kernel_registry as kr
    seen = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind != "matmul":
            return
        kid = n.attrs.get("spgemm_kernel")
        if kid is None:
            # unstamped dispatch is legal: the lowering asks the
            # shared chooser itself (MV104 owns stamp/dispatch
            # agreement for the strategy)
            return
        if _dispatch_kind(n, config) != "spgemm":
            yield Diagnostic(
                code="MV110", severity="error", node=node_addr(n),
                message=f"spgemm_kernel {kid!r} stamped but the node "
                        "does not dispatch the S×S SpGEMM under the "
                        "verifying config — the kernel record "
                        "describes a lowering that never runs",
                fix_hint="re-plan under the executing config")
            return
        if kid not in kr.REGISTRY:
            yield Diagnostic(
                code="MV110", severity="error", node=node_addr(n),
                message=f"stamped spgemm_kernel {kid!r} is not in the "
                        f"kernel registry {kr.kernel_ids()}",
                fix_hint="re-run planner.annotate_strategies, or fix "
                         "the spgemm_kernel_override string")
            return
        spec = kr.get_kernel(kid)
        bs = exec_lib._spgemm_block_size(n, config)
        est = exec_lib.spgemm_estimates(n, config)
        npairs = max(int(round(est.get("est_pairs") or 0.0)), 1)
        if not kr.admissible(kid, bs, npairs, config):
            # the FULL runnability gate (the lowering's own,
            # kernel_registry.admissible) — a stamp failing it makes
            # the lowering
            # silently swap in the legacy default while the decision
            # record still names this kernel
            yield Diagnostic(
                code="MV110", severity="error", node=node_addr(n),
                message=f"stamped spgemm_kernel {kid!r} is not "
                        "runnable under the verifying config (the "
                        "registry's kernel gate, block rule, or "
                        "budget-feasible group) — the lowering would "
                        "silently run the default while obs records "
                        "this kernel",
                fix_hint="re-plan under the executing config, or "
                         "force the composite entry "
                         "(spgemm_kernel_override='xla_gather')")
            return
        derived = stats.pair_structure_class(
            kr.structure_of_child(n.children[0], bs),
            kr.structure_of_child(n.children[1], bs))
        stamped_struct = n.attrs.get("spgemm_structure")
        if stamped_struct is not None and stamped_struct != derived:
            yield Diagnostic(
                code="MV110", severity="error", node=node_addr(n),
                message=f"stamped structure class {stamped_struct!r} "
                        f"but the operand pair classifies "
                        f"{derived!r} — operand statistics changed "
                        "since annotation",
                fix_hint="re-plan so the kernel choice sees the "
                         "current structure")
            return
        forced = (config.spgemm_kernel_override
                  if config is not None else "")
        if (not spec.universal and derived not in spec.structures
                and forced != kid):
            yield Diagnostic(
                code="MV110", severity="error", node=node_addr(n),
                message=f"specialized kernel {kid!r} stamped on "
                        f"foreign structure class {derived!r} "
                        f"(home: {spec.structures}) without an "
                        "override — the registry would not pick this "
                        "schedule here",
                fix_hint="re-plan, or force it explicitly via "
                         "config.spgemm_kernel_override")

    yield from walk(root)
