"""Precision pass: MV108 (stamped tier must satisfy the query SLA).

The precision tier chooser (planner.choose_precision_tier) picks
per-matmul among f32 / bf16 split-summation / integer-exact paths under
the query's accuracy SLA (``config.precision_sla``). A
fresh annotation cannot violate the SLA — the chooser only offers
satisfying tiers — so a violating stamp is a stale cached plan, a
hand-stamped attr, or config drift between stamping and verification:
exactly the class of silent WRONG-ANSWER bug (a "fast" bf16 tier
executing an "exact" query) the static layer exists to catch before
anything runs. Severity is "error": unlike a mispriced plan, a
mis-tiered plan computes a different answer than the SLA promised.

The pass also re-derives integer-exactness (stats.infer_integral): an
int tier stamped on operands that are NOT provably integer-valued
truncates real data — flagged even under "fast" (an accuracy SLA never
licenses silent truncation; the explicit "int32"/"int8" dtype SLAs are
the caller's declaration and downgrade the finding to a warning).
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr
from matrel_tpu_torch.ir import stats
from matrel_tpu_torch.parallel import planner


def _satisfying_tiers(sla: str, integral: bool, config) -> tuple:
    """Every tier admissible under the SLA for verification purposes —
    sla_allowed_tiers WITHOUT the enable-flag gating (the flags shape
    the chooser's search space, not the accuracy contract: a bf16x3
    stamp still satisfies "high" even if the gate that would have
    chosen it is now off)."""
    if sla == "default":
        # no SLA was requested; only the untier lowering is sanctioned
        return ()
    pinned = planner._DTYPE_SLA_TIER.get(sla)
    if pinned is not None:
        return (pinned,)
    tiers = ["f32"]
    if integral:
        tiers += ["int32", "int8"]
    if sla in ("high", "fast"):
        tiers.append("bf16x3")
    if sla == "fast":
        tiers.append("bf16x1")
    return tuple(tiers)


def check_precision_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    """MV108: every stamped ``precision_tier`` is (a) in the tier
    vocabulary and (b) at least as accurate as the query SLA promises
    for these operands. Plans with no stamps verify free; the
    "default" SLA with no stamps pays one attr read per matmul."""
    sla = config.precision_sla
    seen = set()
    imemo: dict = {}    # one shared integrality/magnitude memo per
    # verification run — per-node fresh memos would make deep-chain
    # verification O(nodes²) (the infer_dtype precedent)

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind != "matmul":
            return
        tier = n.attrs.get("precision_tier")
        if tier is None:
            return                 # untier lowering satisfies any SLA
        if tier not in planner.PRECISION_TIERS:
            yield Diagnostic(
                code="MV108", severity="error", node=node_addr(n),
                message=f"stamped precision tier {tier!r} is not in "
                        f"the vocabulary {planner.PRECISION_TIERS}",
                fix_hint="re-plan (annotate_strategies stamps only "
                         "vocabulary tiers)")
            return
        integral = stats.infer_integral(n, imemo)
        explicit_int = planner._DTYPE_SLA_TIER.get(sla) in ("int32",
                                                            "int8")
        if tier in ("int32", "int8") and not integral:
            yield Diagnostic(
                code="MV108",
                # an explicit "int32"/"int8" dtype SLA is the caller's
                # own declaration that the data is integer-valued — the
                # unprovable cast is then a warning, not an error
                severity="warning" if explicit_int else "error",
                node=node_addr(n),
                message=f"integer tier {tier!r} stamped on operands "
                        "that are not provably integer-valued — the "
                        "int cast would truncate real data",
                fix_hint="mark the source matrices integral "
                         "(BlockMatrix(..., integral=True)) if they "
                         "really hold integers, or re-plan")
            return
        if tier in ("int32", "int8") and integral \
                and not planner.int_tier_fits(n, tier, imemo):
            # the magnitude half of the exactness proof: a PROVABLE
            # int32-accumulator overflow (or int8 cast overflow) wraps
            # silently — wrong answers, error always; an UNKNOWN bound
            # is the caller's risk only under an explicit int pin
            ba = stats.integral_abs_bound(n.children[0], imemo)
            bb = stats.integral_abs_bound(n.children[1], imemo)
            provable = ba is not None and bb is not None
            yield Diagnostic(
                code="MV108",
                severity=("error" if provable or not explicit_int
                          else "warning"),
                node=node_addr(n),
                message=(f"integer tier {tier!r}: accumulated product "
                         f"bound k·|A|·|B| = "
                         f"{n.children[0].shape[1]}·{ba}·{bb} "
                         f"exceeds the int32 accumulator "
                         f"({planner.INT32_ACC_MAX:.3g}) — silent "
                         "wraparound" if provable else
                         f"integer tier {tier!r} stamped without a "
                         "provable magnitude bound — overflow safety "
                         "cannot be verified"),
                fix_hint="keep f32 for this magnitude (re-plan under "
                         "the named SLA — the chooser's overflow gate "
                         "refuses unprovable int picks) or shrink the "
                         "operand values")
            return
        ok = _satisfying_tiers(sla, integral, config)
        if tier not in ok:
            oks = str(ok) if ok else "(none: default SLA stamps nothing)"
            yield Diagnostic(
                code="MV108", severity="error", node=node_addr(n),
                message=f"stamped tier {tier!r} does not satisfy the "
                        f"query SLA {sla!r} for these operands "
                        f"(integral={integral}; satisfying tiers: "
                        f"{oks}) — the lowering would "
                        "compute a less accurate answer than promised",
                fix_hint="re-plan under the query's SLA "
                         "(session.run(expr, precision=...)) or relax "
                         "the SLA if the tier is intended")

    yield from walk(root)
