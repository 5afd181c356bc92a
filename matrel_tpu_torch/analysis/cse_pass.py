"""MV116 — cross-query CSE substitution must be provably transparent.

A consumer plan that feeds on a batch-shared hoisted interior
(serve/mqo.py) carries the ``cse`` stamp the session wrote at hoist
time (``attrs["cse"]``: the layout and dtype the hoist recorded, its
key hash, the transitive dep ids, the use count). Like MV107 for the
result cache, the planner credited the reuse on exactly the recorded
layout/dtype — a stamp that no longer agrees with the leaf's ACTUAL
matrix means the plan was costed (and will be reported by obs) on a
premise the hoist no longer backs.

The static half (:func:`check_cse_stamps`) is warning severity, the
MV107 class: the lowering reads the real matrix on the leaf, so
execution is numerically correct either way — what is wrong is the
plan's description of itself.

The dynamic half (:func:`verify_cse_executions`, the MV113
patched-entry idiom) is the acceptance proof of the whole CSE plane:
for each recent hoist-substituted batch root the session remembered
(``MqoState.recent``), compile and execute BOTH the original
(unshared) tree and the substituted tree fresh, and require the
answers bit-equal — CSE-substituted ≡ unshared execution over real
traffic, error severity on any divergence.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

import numpy as np

from matrel_tpu_torch.analysis.diagnostics import (Diagnostic, dtype_name,
                                                   node_addr)

#: Relative floor for the dynamic half — MV113's: both executions run
#: the SAME compile pipeline, so the comparison is exact by default;
#: the floor only applies under a non-default precision SLA whose
#: reduction order may legally differ between the two programs.
_REL_FLOOR = 2.0 ** -20

_FIX = ("re-run the batch through run_many so the hoist re-stamps "
        "against the freshly computed shared interior")


def check_cse_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    seen: set = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind == "leaf" and isinstance(n.attrs.get("cse"), dict):
            yield from _check_leaf(n, mesh)

    yield from walk(root)


def _check_leaf(n, mesh) -> Iterator[Diagnostic]:
    from matrel_tpu_torch.parallel import planner
    rec = n.attrs["cse"]
    m = n.attrs.get("matrix")
    actual_dtype = dtype_name(getattr(m, "dtype", None))
    actual_layout = planner._layout_of(n, mesh)
    stamped_layout = rec.get("layout")
    stamped_dtype = rec.get("dtype")
    if stamped_layout is not None and stamped_layout != actual_layout:
        yield Diagnostic(
            code="MV116", severity="warning", node=node_addr(n),
            message=(
                f"cse stamp claims layout {stamped_layout!r} but the "
                f"hoisted result lies {actual_layout!r} — the planner "
                f"credited a shared-interior reuse the hoist no "
                f"longer backs"),
            fix_hint=_FIX)
    if stamped_dtype is not None and stamped_dtype != actual_dtype:
        yield Diagnostic(
            code="MV116", severity="warning", node=node_addr(n),
            message=(
                f"cse stamp claims dtype {stamped_dtype!r} but the "
                f"hoisted result carries {actual_dtype!r} — autotune "
                f"consults and HBM gates keyed on the wrong itemsize"),
            fix_hint=_FIX)
    uses = rec.get("uses")
    if uses is not None and uses < 2:
        yield Diagnostic(
            code="MV116", severity="warning", node=node_addr(n),
            message=(
                f"cse stamp records uses={uses!r} — an interior used "
                f"once is not shared; the hoist added a dispatch "
                f"without removing one"),
            fix_hint=_FIX)


def verify_cse_executions(session, limit: Optional[int] = None
                          ) -> List[Diagnostic]:
    """The dynamic half: prove the recent CSE-substituted roots equal
    their unshared executions. Each remembered pair (original tree,
    substituted tree) compiles and runs fresh — the substituted tree's
    hoisted-leaf results enter as data, the original recomputes the
    interior from sources — and must agree bit-for-bit under the
    default SLA. Returns the (possibly empty) MV116 diagnostic list;
    empty means every surviving remembered substitution is proven.
    Runs real compiles/executes; the bench/soak/test harness surface,
    never the hot path."""
    from matrel_tpu_torch import executor as executor_lib
    out: List[Diagnostic] = []
    st = getattr(session, "_mqo", None)
    pairs = list(st.recent) if st is not None else []
    if limit is not None:
        pairs = pairs[-limit:]
    exact = session.config.precision_sla == "default"
    for orig, subst in pairs:
        try:
            unshared = executor_lib.compile_expr(
                orig, session.mesh, session.config).run().to_numpy()
            shared = executor_lib.compile_expr(
                subst, session.mesh, session.config).run().to_numpy()
        except Exception as ex:
            out.append(Diagnostic(
                code="MV116", severity="error",
                node=node_addr(orig),
                message=(f"fresh execution of a remembered CSE pair "
                         f"failed: {ex!r}"),
                fix_hint=_FIX))
            continue
        scale = max(float(np.abs(unshared).max()), 1.0)
        err = float(np.abs(shared.astype(np.float64)
                           - unshared.astype(np.float64)).max()) / scale
        bad = (err != 0.0) if exact else (err > _REL_FLOOR)
        if bad:
            out.append(Diagnostic(
                code="MV116", severity="error",
                node=node_addr(orig),
                message=(f"CSE-substituted execution diverges from "
                         f"unshared execution: rel err {err:.3e} "
                         f"(sla={session.config.precision_sla!r}) — "
                         f"the hoist is not transparent"),
                fix_hint=_FIX))
    return out
