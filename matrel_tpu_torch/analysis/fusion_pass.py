"""Fusion-stamp consistency pass: MV111.

The fusion pass (ir/fusion.py) stamps each fusable region on its root
node; the executor lowers EXACTLY the stamped member set under one
dispatch frame, with the chain above the anchor pushed into the
producing kernel's epilogue slot. A stamp that disagrees with the
grammar's own derivation under the verifying config is the MV104/MV110
class of plan bug: the obs decision records (``fused_region``, member
census, est saved dispatches/HBM) describe a program that never
executes, a member outside the fusable vocabulary would lower through
a path the region evaluator cannot instrument, and a stamp present
with ``config.fusion_enable`` OFF means the bit-identity contract is
already broken — the default path must stamp (and construct) nothing.

Checked per stamp, both directions (the MV104 re-check discipline):

* fusion off ⇒ NO stamp anywhere (error).
* every stamped member uid resolves to a reachable region node, is a
  fusable kind or the single anchor matmul, and the anchor uid names a
  matmul member (errors).
* the grammar's re-derivation at this root yields EXACTLY the stamped
  member set — a wider or narrower boundary means the plan was
  annotated under a different config/operand statistics (error).
* the stamped census/signature, precision tier (``fused_tier`` must
  equal the anchor's CURRENT ``precision_tier`` — fused regions
  preserve the stamped tier) and re-mask census (``fused_remask`` —
  the zero-padding invariant is restored at exactly the staged path's
  breaker set) all match re-derivation (errors).
* backward: a region the grammar WOULD form whose root carries no
  stamp. Error with autotune off; with ``config.autotune`` on only a
  warning — a measured ``fuse|…`` "staged" winner legitimately
  suppresses a stamp, and the verifier never re-measures.
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr
from matrel_tpu_torch.ir import fusion as fusion_lib


def check_fusion_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    """MV111 (see module docstring)."""
    stamps = fusion_lib.collect_stamps(root)
    enabled = bool(config is not None and config.fusion_enable)
    if not enabled:
        for n in stamps:
            yield Diagnostic(
                code="MV111", severity="error", node=node_addr(n),
                message="fused_region stamp present with "
                        "config.fusion_enable OFF — the default path "
                        "must stamp nothing (bit-identity contract); "
                        "the executor would lower per-op while obs "
                        "records a fused region",
                fix_hint="re-plan under the executing config, or drop "
                         "the hand-set fused_* attrs")
        return
    derived = {r.root_uid: r
               for r in fusion_lib.segment(root, config, mesh=mesh)}
    stamped_roots = set()
    for n in stamps:
        stamped_roots.add(n.uid)
        yield from _check_one(n, derived.get(n.uid), config)
    for uid, r in derived.items():
        if uid in stamped_roots:
            continue
        sev = "warning" if config.autotune else "error"
        node = fusion_lib._find_uid(root, uid)
        yield Diagnostic(
            code="MV111", severity=sev,
            node=node_addr(node) if node is not None else f"#{uid}",
            message=f"the fusion grammar derives a region "
                    f"({r.sig}) here but no stamp is present — the "
                    "executor will lower it per-op while the planner's "
                    "boundary says it should fuse"
                    + (" (a measured fuse| 'staged' winner may have "
                       "suppressed it)" if config.autotune else ""),
            fix_hint="re-plan under the executing config "
                     "(annotate_fusion runs inside compile when "
                     "fusion_enable is on)")


def _check_one(n, r, config) -> Iterator[Diagnostic]:
    members = fusion_lib.region_nodes(n)
    stamped = set(n.attrs.get("fused_members") or ())
    missing = stamped - (set(members) - {n.uid})
    if missing:
        yield Diagnostic(
            code="MV111", severity="error", node=node_addr(n),
            message=f"stamped member uid(s) {sorted(missing)} do not "
                    "resolve to reachable region nodes — the executor "
                    "would lower a different member set than the "
                    "stamp records",
            fix_hint="re-plan; member uids are remapped by "
                     "annotate_fusion, never hand-set")
        return
    anchor_uid = n.attrs.get("fused_anchor")
    mms = [m for m in members.values() if m.kind == "matmul"]
    if len(mms) > 1:
        yield Diagnostic(
            code="MV111", severity="error", node=node_addr(n),
            message=f"{len(mms)} matmul members in one region — the "
                    "epilogue-hook contract allows at most ONE "
                    "producer anchor per region",
            fix_hint="re-plan under the executing config")
        return
    anchor = members.get(anchor_uid) if anchor_uid is not None else None
    if anchor_uid is not None and (anchor is None
                                   or anchor.kind != "matmul"):
        yield Diagnostic(
            code="MV111", severity="error", node=node_addr(n),
            message=f"fused_anchor {anchor_uid} is not a matmul "
                    "member of this region",
            fix_hint="re-plan under the executing config")
        return
    for m in members.values():
        if m.uid == anchor_uid or m.uid == n.uid:
            continue
        if m.kind not in fusion_lib.FUSABLE_KINDS:
            yield Diagnostic(
                code="MV111", severity="error", node=node_addr(m),
                message=f"member kind {m.kind!r} is outside the "
                        f"fusable vocabulary "
                        f"{fusion_lib.FUSABLE_KINDS} — the region "
                        "evaluator has no single-frame lowering for "
                        "it",
                fix_hint="re-plan under the executing config")
            return
    if r is None:
        yield Diagnostic(
            code="MV111", severity="error", node=node_addr(n),
            message="fused_region stamped but the grammar derives NO "
                    "region at this root under the verifying config — "
                    "the boundary was drawn under different operand "
                    "statistics or a different fusion grammar",
            fix_hint="re-plan under the executing config")
        return
    if set(r.member_uids) != stamped:
        yield Diagnostic(
            code="MV111", severity="error", node=node_addr(n),
            message=f"stamped member set {sorted(stamped)} != the "
                    f"grammar's derivation {sorted(r.member_uids)} — "
                    "the stamp does not cover exactly the region the "
                    "executor lowers",
            fix_hint="re-plan under the executing config")
        return
    census = n.attrs.get("fused_census") or {}
    if census != r.census or n.attrs.get("fused_region") != r.sig:
        yield Diagnostic(
            code="MV111", severity="error", node=node_addr(n),
            message=f"stamped census/signature "
                    f"({n.attrs.get('fused_region')!r}, {census}) "
                    f"disagree with re-derivation ({r.sig!r}, "
                    f"{r.census}) — obs records (and fuse| autotune "
                    "keys) would describe a different region",
            fix_hint="re-plan under the executing config")
        return
    if int(n.attrs.get("fused_remask") or 0) != r.n_remask:
        yield Diagnostic(
            code="MV111", severity="error", node=node_addr(n),
            message=f"stamped re-mask census "
                    f"{n.attrs.get('fused_remask')} != derived "
                    f"{r.n_remask} — the fused lowering would restore "
                    "the zero-padding invariant at a different "
                    "breaker set than the staged path",
            fix_hint="re-plan under the executing config")
        return
    if anchor is not None:
        tier = anchor.attrs.get("precision_tier")
        if n.attrs.get("fused_tier") != tier:
            yield Diagnostic(
                code="MV111", severity="error", node=node_addr(n),
                message=f"stamped fused_tier "
                        f"{n.attrs.get('fused_tier')!r} != the "
                        f"anchor's precision_tier {tier!r} — fusing "
                        "must preserve the stamped tier's numerics",
                fix_hint="re-plan so the fusion stamp sees the "
                         "anchor's current tier")
