"""MV114 — fleet placement stamps must match the topology they
claim to be priced on. The fleet (``serve/fleet.py``) writes them: a
span-placed query's ``placement`` stamp, and a replicated entry's
``fleet`` provenance on its cache leaf.

Two hazard shapes, both the MV107 stale-stamp class:

1. **Span stamp vs topology.** A query the fleet placed as
   slice-SPANNING carries ``attrs["placement"]`` on the plan root
   with the weights it was priced under and the effective DCN weight
   its dominant collective was billed at
   (``serve/placement.effective_dcn_weight`` — the ONE helper the
   placer itself used). A stamp whose weights no longer match the
   verifying mesh's — or whose recorded DCN bill disagrees with what
   the shared helper derives from them — means the span/slice trade
   was decided on a topology this plan is not running on (a replayed
   stamp after re-calibration, or a hand-built plan smuggling a
   placement claim).

2. **Directory-hit substitution vs owning slice.** A result-cache
   leaf whose stamp carries ``fleet`` provenance was REPLICATED from
   another slice's cache; the owning slice's recorded layout/dtype
   rides the stamp. A replica whose own claims diverge from what the
   owner recorded is a migration that silently changed the value's
   shape-class — MV107 already proves stamp-vs-matrix, this proves
   stamp-vs-origin.

Warning severity (the MV102/MV106/MV107 class): execution reads the
real operands either way — what is wrong is the plan's description of
how it was priced. Free when no fleet stamps exist: plans without
them walk and yield nothing.
"""

from __future__ import annotations

from typing import Iterator

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr

_FIX = ("re-submit through the fleet so placement re-stamps against "
        "the live topology (serve/fleet.py)")
_FIX_REPL = ("drop and re-replicate the entry through the fleet API "
             "so the directory and the replica agree")


def check_placement_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    stamp = root.attrs.get("placement") if hasattr(root, "attrs") \
        else None
    if isinstance(stamp, dict) and stamp.get("mode") == "span":
        yield from _check_span(root, stamp, mesh, config)
    seen: set = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        rc = n.attrs.get("result_cache")
        if (n.kind == "leaf" and isinstance(rc, dict)
                and isinstance(rc.get("fleet"), dict)):
            yield from _check_replica(n, rc)

    yield from walk(root)


def _check_span(root, stamp: dict, mesh, config) -> Iterator[Diagnostic]:
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.serve import placement as placement_lib
    live = mesh_lib.axis_weights(mesh, config)
    stamped_w = tuple(float(v) for v in (stamp.get("weights") or ())
                      if isinstance(v, (int, float)))
    if len(stamped_w) != 2:
        yield Diagnostic(
            code="MV114", severity="warning", node=node_addr(root),
            message=("span placement stamp carries no usable "
                     "topology weights — the span/slice trade "
                     "cannot be re-checked"),
            fix_hint=_FIX)
        return
    if stamped_w != tuple(live):
        yield Diagnostic(
            code="MV114", severity="warning", node=node_addr(root),
            message=(
                f"span placement stamp was priced under axis weights "
                f"{stamped_w} but this mesh resolves {tuple(live)} — "
                f"the DCN-crossing trade was decided on a topology "
                f"this plan is not running on (stale stamp after "
                f"re-calibration?)"),
            fix_hint=_FIX)
    expect = placement_lib.effective_dcn_weight(stamped_w)
    got = stamp.get("dcn_weight")
    if isinstance(got, (int, float)) and float(got) != expect:
        yield Diagnostic(
            code="MV114", severity="warning", node=node_addr(root),
            message=(
                f"span placement stamp bills the cut at weight "
                f"{got:g} but its own weights {stamped_w} derive "
                f"{expect:g} — the dominant collective was not "
                f"priced on the DCN axis weight"),
            fix_hint=_FIX)


def _check_replica(n, rc: dict) -> Iterator[Diagnostic]:
    fl = rc["fleet"]
    own_layout, own_dtype = rc.get("layout"), rc.get("dtype")
    rec_layout, rec_dtype = fl.get("layout"), fl.get("dtype")
    if (rec_dtype is not None and own_dtype is not None
            and rec_dtype != own_dtype):
        yield Diagnostic(
            code="MV114", severity="warning", node=node_addr(n),
            message=(
                f"replicated cache entry claims dtype {own_dtype!r} "
                f"but the owning slice recorded {rec_dtype!r} — the "
                f"migration changed the value's dtype class"),
            fix_hint=_FIX_REPL)
    if (rec_layout is not None and own_layout is not None
            and rec_layout not in (own_layout, "rep")
            and own_layout != "rep"):
        # replication legitimately re-lays the value (a gather to
        # replicated form is the staged move); only a claim of a
        # THIRD sharded layout neither side ever held is incoherent
        yield Diagnostic(
            code="MV114", severity="warning", node=node_addr(n),
            message=(
                f"replicated cache entry claims layout {own_layout!r} "
                f"but the owning slice recorded {rec_layout!r} and "
                f"neither side is replicated — the directory and the "
                f"replica disagree about the value's layout"),
            fix_hint=_FIX_REPL)
