"""MV117 — spill-thaw provenance stamps must cohere with the tiers.

A result-cache leaf whose entry was served from a LOWER tier of the
spill hierarchy (``serve/spill.py``) carries the promotion's
provenance inside its ``result_cache`` stamp (``stamp["spill"]``: the
serving tier, the staged transfer legs, the coefficient-priced bill,
and whether the device transient fit the peak-HBM budget). The plan
was admitted on exactly that story — so a stamp whose legs are not
the legs :func:`reshard.spill_plan` stages from the claimed tier, or
whose ``fits`` verdict disagrees with the entry's own byte count
against the live budget, describes a promotion that never happened
that way (a hand-built plan, a replay across a config change, or a
spill-manager regression).

Warning severity, the MV107 class: the matrix on the leaf is the real
thawed value, so execution is numerically correct either way — what
is wrong is the plan's description of how the value got there (and
therefore every obs record and cost consult built on it).
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr

_FIX = ("re-run the query through the session so the thaw re-stamps "
        "against the live spill hierarchy and budget")


def check_spill_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    seen: set = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        rc = n.attrs.get("result_cache")
        if (n.kind == "leaf" and isinstance(rc, dict)
                and isinstance(rc.get("spill"), dict)):
            yield from _check_leaf(n, rc["spill"], config)

    yield from walk(root)


def _check_leaf(n, sp, config) -> Iterator[Diagnostic]:
    from matrel_tpu_torch.parallel import coeffs, reshard
    tier = sp.get("tier")
    if tier not in ("host", "disk", "restored"):
        yield Diagnostic(
            code="MV117", severity="warning", node=node_addr(n),
            message=(
                f"spill stamp claims serving tier {tier!r} but only "
                f"host/disk/restored entries thaw — an HBM hit never "
                f"stamps spill provenance"),
            fix_hint=_FIX)
        return
    legs = sp.get("legs") or ()
    unknown = [l for l in legs if l not in coeffs.SPILL_LEGS]
    if unknown:
        yield Diagnostic(
            code="MV117", severity="warning", node=node_addr(n),
            message=(
                f"spill stamp carries leg(s) {unknown!r} outside the "
                f"reshard transfer vocabulary {coeffs.SPILL_LEGS!r} — "
                f"no coefficient row can ever price them"),
            fix_hint=_FIX)
        return
    # the legs a promotion from the claimed tier actually stages
    # (restored entries ARE disk-tier entries under a name key)
    m = n.attrs.get("matrix")
    nbytes = int(getattr(getattr(m, "data", None), "nbytes", 0) or 0)
    plan = reshard.spill_plan(
        "disk" if tier == "restored" else tier, "hbm", nbytes)
    expect = [reshard.spill_leg(s) for s in plan.steps]
    if list(legs) != expect:
        yield Diagnostic(
            code="MV117", severity="warning", node=node_addr(n),
            message=(
                f"spill stamp claims legs {list(legs)!r} but a "
                f"promotion from tier {tier!r} stages {expect!r} — "
                f"the plan was priced on transfers that did not run"),
            fix_hint=_FIX)
    if "fits" in sp and nbytes:
        actual = plan.fits(float(config.reshard_peak_budget_bytes))
        if bool(sp["fits"]) != actual:
            yield Diagnostic(
                code="MV117", severity="warning", node=node_addr(n),
                message=(
                    f"spill stamp claims fits={sp['fits']!r} but the "
                    f"entry's {nbytes} device-transient bytes "
                    f"{'respect' if actual else 'exceed'} the live "
                    f"reshard_peak_budget_bytes — the budget story "
                    f"the admission told is stale"),
                fix_hint=_FIX)
    cost = sp.get("cost")
    if cost not in ("measured", "analytic"):
        yield Diagnostic(
            code="MV117", severity="warning", node=node_addr(n),
            message=(
                f"spill stamp provenance {cost!r} is neither "
                f"'measured' nor 'analytic' — the coefficient-loop "
                f"audit cannot classify this promotion"),
            fix_hint=_FIX)
