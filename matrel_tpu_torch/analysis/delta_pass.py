"""MV113 — delta-patched results must be provably maintained (the
MV108/MV110 verify-against-fresh-execution precedent applied to the IVM
plane).

Two halves, one code:

STATIC (registered in analysis.PASSES — ``check_delta_stamps``): a
plan consuming a result-cache entry that was delta-PATCHED carries
the delta provenance on its substitution stamp
(``attrs["result_cache"]["delta"]``: generation, rule, composed error
bound). The pass proves the stamp is COHERENT — the rule is in the
delta algebra's vocabulary (ir/delta.DELTA_RULES), the generation is
a positive integer, the bound is a finite non-negative float — so a
hand-built or tampered stamp cannot smuggle an unverifiable patch
past the obs surfaces that trust it. Error severity: an incoherent
provenance stamp means nobody can say what bound the consumed value
satisfies.

DYNAMIC (``verify_patched_entries`` — the test and soak harness
surface): every live patched entry's recorded
expression is RE-EXECUTED fresh (straight through the executor,
bypassing the result cache) and the patched value is proven equal
within the entry's composed error bound — exactly equal when the
bound is zero (the integer-exact graph-count patches). This is the
MV108 discipline — the stamped tier's documented bound IS the
asserted bound — pushed onto maintained state.
"""

from __future__ import annotations

import math
from typing import Iterator, List, Optional

import numpy as np

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr

_FIX = ("re-run the query through the session so substitution "
        "re-stamps from the live entry, or re-register the delta so "
        "the plane re-patches")

#: Relative floor for the dynamic check: a zero composed bound means
#: EXACT (integer paths); a nonzero bound is asserted as-is but never
#: below one f32 ulp-scale unit (measurement noise on reductions).
_REL_FLOOR = 2.0 ** -20


def check_delta_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    """The static half (see module docstring) — a read of the
    annotated tree, no device work, O(nodes)."""
    from matrel_tpu_torch.ir import delta as delta_lib
    seen: set = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        rc = n.attrs.get("result_cache")
        if n.kind == "leaf" and isinstance(rc, dict) \
                and rc.get("delta") is not None:
            yield from _check_stamp(n, rc["delta"], delta_lib)

    yield from walk(root)


def _check_stamp(n, d, delta_lib) -> Iterator[Diagnostic]:
    if not isinstance(d, dict):
        yield Diagnostic(
            code="MV113", severity="error", node=node_addr(n),
            message=(f"delta provenance stamp is {type(d).__name__}, "
                     f"not a record — the consumed value's "
                     f"maintenance history is unreadable"),
            fix_hint=_FIX)
        return
    gen = d.get("gen")
    if not isinstance(gen, int) or gen < 1:
        yield Diagnostic(
            code="MV113", severity="error", node=node_addr(n),
            message=(f"delta stamp claims generation {gen!r} — "
                     f"patched entries exist only at generation >= 1 "
                     f"(0 means fresh execution, which must carry NO "
                     f"delta stamp)"),
            fix_hint=_FIX)
    rule = d.get("rule")
    if rule not in delta_lib.DELTA_RULES:
        yield Diagnostic(
            code="MV113", severity="error", node=node_addr(n),
            message=(f"delta stamp claims rule {rule!r}, not in the "
                     f"delta algebra's vocabulary "
                     f"{delta_lib.DELTA_RULES} — no documented error "
                     f"bound exists for it"),
            fix_hint=_FIX)
    bound = d.get("err_bound")
    if not isinstance(bound, (int, float)) or bound < 0 \
            or not math.isfinite(float(bound)):
        yield Diagnostic(
            code="MV113", severity="error", node=node_addr(n),
            message=(f"delta stamp carries err_bound {bound!r} — the "
                     f"composed bound must be a finite float >= 0 "
                     f"(0 = exact, the integer paths)"),
            fix_hint=_FIX)


def verify_patched_entries(session, limit: Optional[int] = None
                           ) -> List[Diagnostic]:
    """The dynamic half: prove every live delta-patched result-cache
    entry against FRESH execution of its recorded expression, within
    its composed error bound (exactly, when the bound is 0). Returns
    the (possibly empty) MV113 diagnostic list — empty means every
    surviving patched entry is proven. Runs real compiles/executes;
    the bench/soak/test harness surface, never the hot path."""
    from matrel_tpu_torch import executor as executor_lib
    out: List[Diagnostic] = []
    checked = 0
    for key, ent in session._result_cache.items_snapshot():
        if not ent.delta_gen:
            continue
        if limit is not None and checked >= limit:
            break
        checked += 1
        if ent.expr is None:
            out.append(Diagnostic(
                code="MV113", severity="error",
                node=f"entry:{ent.key_hash}",
                message=("patched entry lost its expression — "
                         "nothing to verify against"),
                fix_hint=_FIX))
            continue
        try:
            plan = executor_lib.compile_expr(ent.expr, session.mesh,
                                             session.config)
            fresh = plan.run().to_numpy()
        except Exception as ex:
            out.append(Diagnostic(
                code="MV113", severity="error",
                node=f"entry:{ent.key_hash}",
                message=(f"fresh execution of the patched entry's "
                         f"expression failed: {ex!r}"),
                fix_hint=_FIX))
            continue
        got = ent.result.to_numpy()
        exact = (ent.err_bound or 0.0) <= 0.0
        scale = max(float(np.abs(fresh).max()), 1.0)
        err = float(np.abs(got.astype(np.float64)
                           - fresh.astype(np.float64)).max()) / scale
        tol = 0.0 if exact else max(float(ent.err_bound), _REL_FLOOR)
        bad = (err != 0.0) if exact else (err > tol)
        if bad:
            out.append(Diagnostic(
                code="MV113", severity="error",
                node=f"entry:{ent.key_hash}",
                message=(f"patched entry (gen {ent.delta_gen}, rule "
                         f"{ent.delta_rule}) diverges from fresh "
                         f"execution: rel err {err:.3e} vs stamped "
                         f"bound {'exact' if exact else ent.err_bound}"
                         ),
                fix_hint=_FIX))
    return out
