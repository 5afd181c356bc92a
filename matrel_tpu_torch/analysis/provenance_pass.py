"""MV115 — answer-provenance stamps must cohere with the seams.

The answer provenance ledger (obs/provenance.py) threads each consumed
cache entry's lineage stamp onto its substitution leaf
(``attrs["provenance"]``) next to the MV107 ``result_cache`` stamp, and
each ledger record names the serve path its answer took. Both are
DESCRIPTIONS of the same mechanisms the engine already stamps —
delta-patched entries carry a ``delta`` stamp, replicated entries a
``fleet`` stamp, degraded compiles a ``degrade`` meta — so a lineage
claim the mechanism stamps don't back (or a mechanism stamp the
lineage doesn't admit) means the account of the answer is wrong in one
direction or the other. The classic shapes: a hand-built or replayed
plan carrying a stale provenance stamp past an invalidation, and a
record-path vocabulary drift between writer and reader versions.

Two halves, the MV113 pattern:

- STATIC (:func:`check_provenance_stamps`, the registered pass): walk
  the annotated tree; on every substitution leaf cross-check the
  ``provenance`` stamp against the ``result_cache`` stamp BOTH ways
  (key-hash agreement; ``ivm_patched`` ⇔ ``delta``; ``fleet_replica``
  backed by ``fleet``), and warn on unknown path vocabulary or schema.
- DYNAMIC (:func:`verify_ledger`): audit a live session's ledger
  records for internal coherence — path ⇔ section agreement inside
  each summary (``degraded`` ⇔ ``degrade``, ``stale`` ⇔ grant,
  fleet paths ⇔ ``fleet`` hop). The numeric re-proof of the answers
  themselves is :func:`obs.provenance.audit`'s job.

Warning severity throughout (the MV102/MV106/MV107 class): execution
reads the real matrices either way — what is wrong is the plan's (or
the ledger's) description of itself.
"""

from __future__ import annotations

from typing import Iterator, List, Optional

from matrel_tpu_torch.analysis.diagnostics import Diagnostic, node_addr
from matrel_tpu_torch.obs import provenance as provenance_lib

_FIX = ("re-run the query through the session so substitution "
        "re-stamps lineage against the live cache entry")

#: Paths whose leaf stamp a ``fleet`` mechanism stamp may back — a
#: replica entry later delta-patched restamps ``ivm_patched`` while
#: keeping its fleet ancestry.
_FLEET_OK = ("fleet_replica", "ivm_patched")


def check_provenance_stamps(root, mesh, config) -> Iterator[Diagnostic]:
    seen: set = set()

    def walk(n) -> Iterator[Diagnostic]:
        if n.uid in seen:
            return
        seen.add(n.uid)
        for c in n.children:
            yield from walk(c)
        if n.kind == "leaf" and n.attrs.get("provenance") is not None:
            yield from _check_leaf(n)

    yield from walk(root)


def _check_leaf(n) -> Iterator[Diagnostic]:
    pv = n.attrs["provenance"]
    if not isinstance(pv, dict):
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=(f"provenance stamp is {type(pv).__name__!r}, "
                     f"not a lineage record — only the ledger's "
                     f"stamp writers may produce it"),
            fix_hint=_FIX)
        return
    schema = pv.get("schema")
    if schema != provenance_lib.SCHEMA_VERSION:
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=(f"provenance stamp schema {schema!r} != "
                     f"{provenance_lib.SCHEMA_VERSION} — written by a "
                     f"different ledger version; lineage readers may "
                     f"misrender it"),
            fix_hint=_FIX)
    path = pv.get("path")
    if path not in provenance_lib.PATHS:
        # unknown provenance KIND: warn, never error — a newer writer
        # must not brick an older verifier (the schema discipline)
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=(f"provenance stamp claims unknown serve path "
                     f"{path!r} (known: "
                     f"{', '.join(provenance_lib.PATHS)})"),
            fix_hint=_FIX)
    rc = n.attrs.get("result_cache")
    if not isinstance(rc, dict):
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=("provenance stamp without a result_cache stamp — "
                     "lineage claims a cache ancestry the plan itself "
                     "does not record (stale stamp past an "
                     "invalidation?)"),
            fix_hint=_FIX)
        return
    pk, rk = pv.get("key_hash"), rc.get("key_hash")
    if pk is not None and rk is not None and pk != rk:
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=(f"provenance stamp names entry {pk!r} but the "
                     f"result_cache stamp names {rk!r} — the lineage "
                     f"and the substitution disagree about which "
                     f"entry answered"),
            fix_hint=_FIX)
    has_delta = isinstance(rc.get("delta"), dict)
    if path == "ivm_patched" and not has_delta:
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=("provenance claims an IVM-patched ancestry but "
                     "the entry carries no delta stamp — the lineage "
                     "promises a patch chain the cache never applied"),
            fix_hint=_FIX)
    if has_delta and path != "ivm_patched":
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=(f"entry carries delta stamp (gen "
                     f"{rc['delta'].get('gen')}) but provenance "
                     f"claims path {path!r} — a patched value served "
                     f"under a fresh-execution lineage hides its "
                     f"composed err_bound from the audit"),
            fix_hint=_FIX)
    if path == "fleet_replica" and not isinstance(rc.get("fleet"),
                                                  dict):
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=("provenance claims a fleet-replica ancestry but "
                     "the entry carries no fleet stamp — no owning "
                     "slice to audit the hop against"),
            fix_hint=_FIX)
    if isinstance(rc.get("fleet"), dict) and path not in _FLEET_OK:
        yield Diagnostic(
            code="MV115", severity="warning", node=node_addr(n),
            message=(f"entry was replicated from slice "
                     f"{rc['fleet'].get('owner')!r} but provenance "
                     f"claims path {path!r} — the lineage omits the "
                     f"inter-slice hop"),
            fix_hint=_FIX)


# -- dynamic half: ledger-record coherence ------------------------------

def verify_ledger(session, limit: Optional[int] = None
                  ) -> List[Diagnostic]:
    """Check a live session's ledger records for internal coherence —
    each summary's path must admit exactly the sections it carries.
    Empty list when the ledger is off (nothing to check is not a
    finding). ``limit`` bounds the check to the newest N records."""
    led = getattr(session, "_prov", None)
    if led is None:
        return []
    out: List[Diagnostic] = []
    recs = led.records()
    if limit:
        recs = recs[-limit:]
    for rec in recs:
        out.extend(_check_record(rec))
    out.sort(key=lambda d: (d.severity != "error", d.code))
    return out


def _check_record(rec) -> Iterator[Diagnostic]:
    s = rec.summary
    addr = f"ledger:{rec.query_id}"
    if rec.path not in provenance_lib.PATHS:
        yield Diagnostic(
            code="MV115", severity="warning", node=addr,
            message=(f"ledger record claims unknown serve path "
                     f"{rec.path!r}"),
            fix_hint="bump the reader or fix the capture site")
    if s.get("schema") != provenance_lib.SCHEMA_VERSION:
        yield Diagnostic(
            code="MV115", severity="warning", node=addr,
            message=(f"ledger record schema {s.get('schema')!r} != "
                     f"{provenance_lib.SCHEMA_VERSION}"),
            fix_hint="bump the reader or fix the capture site")
    ivm = (s.get("cache") or {}).get("ivm")
    if rec.path == "ivm_patched" and not ivm:
        yield Diagnostic(
            code="MV115", severity="warning", node=addr,
            message=("record claims ivm_patched but carries no patch "
                     "chain — nothing for the audit to compose the "
                     "err_bound from"),
            fix_hint="capture via the delta plane's apply_patch seam")
    if ivm and rec.path != "ivm_patched":
        yield Diagnostic(
            code="MV115", severity="warning", node=addr,
            message=(f"record carries a patch chain but claims path "
                     f"{rec.path!r}"),
            fix_hint="capture via the delta plane's apply_patch seam")
    if rec.path in ("fleet_directory", "fleet_replica") \
            and not s.get("fleet"):
        yield Diagnostic(
            code="MV115", severity="warning", node=addr,
            message=(f"record claims {rec.path} but carries no fleet "
                     f"hop (owner -> serving slice)"),
            fix_hint="capture via the directory-answer seam")
    if rec.path == "degraded" and not s.get("degrade"):
        yield Diagnostic(
            code="MV115", severity="warning", node=addr,
            message=("record claims a degraded serve but carries no "
                     "rung stamp"),
            fix_hint="capture with the attempt's rung")
    if s.get("degrade") and not rec.rung:
        yield Diagnostic(
            code="MV115", severity="warning", node=addr,
            message=("record carries a degrade stamp but rung 0 — "
                     "the lineage claims a ladder step that never "
                     "escalated"),
            fix_hint="capture with the attempt's rung")
    if rec.path == "stale" and not s.get("stale"):
        yield Diagnostic(
            code="MV115", severity="warning", node=addr,
            message=("record claims a stale serve but carries no "
                     "staleness grant"),
            fix_hint="capture via the pipeline's stale-probe seam")
