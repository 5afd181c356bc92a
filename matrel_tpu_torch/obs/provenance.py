"""Answer provenance ledger — the counterpart of
``matrel_tpu/obs/provenance.py``.

Every answer the session returns while ``config.obs_provenance`` > 0
appends one compact, schema-versioned lineage record to an in-memory
bounded ledger (and emits it as a ``provenance`` event through the
session's one emission funnel). ``session.why`` reads it back.

A record names the serve PATH (:data:`PATHS`) and carries the
structural key hash, precision SLA, degrade rung, result-cache ancestry
(whole hit / interior substitution leaf stamps with entry generations),
the IVM patch chain (``delta:<gen>`` rules + composed err_bound),
staleness grants, and the planner's strategy/tier/coefficient
provenance. The summary's fields are the JAX package's, so a record
renders (:func:`render`) and compares the same from either package.

Capture happens only at the session's seams (``_rc_admit`` /
``_rc_insert``, the serve pipeline's stale-rung consult, the delta
plane's patch commit); every ``CacheEntry.provenance`` /
``attrs["provenance"]`` store lives in THIS file.

AUDIT REPLAY (:func:`audit`): sampled ledger records re-execute their
recorded expression fresh — straight through the executor, result
cache bypassed — and the served answer must be bit-equal when its
composed bound is 0 and within the stamped err_bound otherwise.

Zero-overhead contract: ``obs_provenance = 0`` (the default) builds NO
ledger and NO record objects anywhere on the serve path
(poisoned-``__init__`` test-enforced).
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import time
from collections import deque
from typing import Iterable, List, Optional
from matrel_tpu_torch.utils import lockdep

#: Bump when a reader-visible field changes meaning (the event-log
#: SCHEMA_VERSION discipline). Readers warn on records they don't know.
SCHEMA_VERSION = 1

#: The serve-path vocabulary — every answer is exactly one of these
#: (the JAX package's, fleet paths included). ``cse_hoist`` is
#: a batch's compute-once shared interior (serve/mqo.py — the producer
#: side); ``cse_interior`` a consumer answer that fed on one or more
#: hoisted results (the rc_interior refinement for the CSE plane).
PATHS = ("execute", "rc_hit", "rc_interior", "ivm_patched",
         "fleet_directory", "fleet_replica", "stale", "degraded",
         "cse_hoist", "cse_interior")

#: Relative floor for audit replay: a zero composed bound
#: means EXACT; a nonzero bound is asserted as-is but never below one
#: f32 ulp-scale unit (measurement noise on reductions).
_REL_FLOOR = 2.0 ** -20

_prov_seq = itertools.count(1)


def from_config(config) -> Optional["ProvenanceLedger"]:
    """The structural-zero gate (the brownout/breaker idiom): None —
    not an inert object, NO object — when the ledger is off."""
    cap = getattr(config, "obs_provenance", 0)
    if cap <= 0:
        return None
    return ProvenanceLedger(cap)


@dataclasses.dataclass
class ProvenanceRecord:
    """One served answer's lineage. ``summary`` is the JSON-safe
    projection (what the ``provenance`` event carries and ``why``
    renders); the live references (expr/result/mesh/config) exist so
    :func:`audit` can replay the answer fresh — None when the serving
    seam had no expression in hand (nothing to replay)."""

    query_id: str
    path: str
    key: str
    key_hash: str
    sla: str
    rung: int
    err_bound: float
    ts: float
    summary: dict
    expr: Optional[object] = None
    result: Optional[object] = None
    mesh: Optional[object] = None
    config: Optional[object] = None


class ProvenanceLedger:
    """Thread-safe bounded ledger of :class:`ProvenanceRecord` plus
    the per-entry IVM patch chains (ivm_id → [{gen, rule, err_bound}]
    in patch order — the composed-bound audit trail a single
    ``delta_gen`` stamp cannot carry)."""

    def __init__(self, cap: int):
        self.cap = cap
        self._records: "deque[ProvenanceRecord]" = deque(maxlen=cap)
        self._chains: dict = {}
        self._lock = lockdep.make_lock("obs.provenance")
        self.captured = 0

    # -- the sanctioned stamp writers -----------------------------------

    def stamp_entry(self, ent, path: str, query_id: str) -> None:
        """Write a fresh entry's ``provenance`` stamp (called from
        ``session._rc_insert`` and fleet replication — the put seam)."""
        ent.provenance = {"schema": SCHEMA_VERSION, "path": path,
                          "query_id": query_id,
                          "key_hash": ent.key_hash}

    def stamp_patched(self, ent, gen: int, rule: Optional[str],
                      err_bound: float) -> None:
        """Append one patch to the entry's chain and restamp it
        ``ivm_patched`` (called from the delta plane's ``apply_patch``
        commit — the ONE cache-mutation seam)."""
        link = {"gen": gen, "rule": rule,
                "err_bound": float(err_bound)}
        with self._lock:
            chain = self._chains.setdefault(ent.ivm_id, [])
            chain.append(link)
            chain_copy = list(chain)
        prev = ent.provenance or {}
        ent.provenance = {"schema": SCHEMA_VERSION,
                          "path": "ivm_patched",
                          "query_id": prev.get("query_id", ""),
                          "key_hash": ent.key_hash,
                          "chain": chain_copy}

    def stamp_leaf(self, leaf, ent):
        """Thread a consumed entry's provenance onto its substitution
        leaf (``attrs["provenance"]``), beside its ``result_cache``
        stamp.
        Entries inserted before the ledger existed pass through
        unstamped — the historical shape."""
        if ent.provenance is None:
            return leaf
        return leaf.with_attrs(provenance=dict(ent.provenance))

    def chain(self, ivm_id) -> List[dict]:
        with self._lock:
            return list(self._chains.get(ivm_id, ()))

    # -- capture (one call per served answer) --------------------------

    def capture(self, path: str, key: str, sla: str,
                rung: int = 0, expr=None, result=None, ent=None,
                executed=None, plan=None, strategies=None,
                mesh=None, config=None,
                fleet: Optional[dict] = None,
                stale: Optional[dict] = None,
                coeff_epoch: Optional[str] = None) -> dict:
        """Assemble + append one lineage record; returns the JSON-safe
        summary for the caller to emit as a ``provenance`` event.
        ``ent`` is the serving cache entry (hit paths), ``executed``
        the possibly-substituted tree that actually ran (interior
        ancestry), ``plan`` the compiled plan (strategy provenance);
        ``strategies`` overrides the plan's decision records with one
        root's (the MultiPlan batch path); ``coeff_epoch`` records
        which learned-coefficient epoch priced the answer's plan
        (None with the loop off: no new field, the bit-identity
        contract)."""
        from matrel_tpu_torch.resilience import degrade as degrade_lib
        qid = f"p{next(_prov_seq)}"
        if ent is not None and path in ("rc_hit", "stale"):
            # refine the consult paths by what the entry records: a
            # hit on a patched entry IS an IVM-maintained answer, a
            # hit on a replicated entry IS a fleet-replica answer
            if ent.delta_gen:
                path = "ivm_patched"
            elif getattr(ent, "fleet", None) and path == "rc_hit":
                path = "fleet_replica"
        interior = _interior_stamps(executed) if executed is not None \
            else []
        if path == "execute" and interior:
            # cse-stamped leaves refine to the CSE plane's path; mixed
            # cse+rc ancestry stays honest — the leaves list carries
            # both kinds of stamps either way
            path = ("cse_interior"
                    if any(s.get("cse") for s in interior)
                    else "rc_interior")
        if path == "execute" and rung > 0:
            path = "degraded"
        err_bound = 0.0
        if ent is not None:
            err_bound = float(ent.err_bound or 0.0)
        elif plan is not None:
            err_bound = float(((plan.meta or {}).get("precision") or {})
                              .get("est_rel_err_bound") or 0.0)
        key_hash = hashlib.sha1(key.encode()).hexdigest()[:16]
        summary: dict = {
            "schema": SCHEMA_VERSION,
            "query_id": qid,
            "path": path,
            "key_hash": key_hash,
            "sla": sla,
            "err_bound": err_bound,
        }
        if rung > 0:
            summary["degrade"] = degrade_lib.rung_meta(rung)
        if coeff_epoch is not None:
            summary["coeff_epoch"] = coeff_epoch
        if ent is not None:
            cache: dict = {"kind": "whole", "entry": _entry_stamp(ent)}
            if ent.delta_gen:
                cache["ivm"] = {"gen": ent.delta_gen,
                                "rule": ent.delta_rule,
                                "err_bound": float(ent.err_bound or 0.0),
                                "chain": self.chain(ent.ivm_id)}
            summary["cache"] = cache
        elif interior:
            summary["cache"] = {"kind": "interior", "leaves": interior}
        if fleet is not None:
            summary["fleet"] = dict(fleet)
        elif ent is not None and getattr(ent, "fleet", None):
            summary["fleet"] = dict(ent.fleet)
        if stale is not None:
            summary["stale"] = dict(stale)
        if plan is not None or strategies is not None:
            stamps = _strategy_stamps(plan, strategies)
            if stamps:
                summary["strategies"] = stamps
        rec = ProvenanceRecord(
            query_id=qid, path=path, key=key, key_hash=key_hash,
            sla=sla, rung=rung, err_bound=err_bound,
            ts=time.time(), summary=summary,  # record timestamp — the ledger's ts mirrors EventLog.emit's stamp
            expr=expr if expr is not None
            else (ent.expr if ent is not None else None),
            result=result if result is not None
            else (ent.result if ent is not None else None),
            mesh=mesh, config=config)
        with self._lock:
            self._records.append(rec)
            self.captured += 1
        return summary

    # -- read surfaces --------------------------------------------------

    def records(self) -> List[ProvenanceRecord]:
        with self._lock:
            return list(self._records)

    def last(self, n: int) -> List[ProvenanceRecord]:
        with self._lock:
            recs = list(self._records)
        return recs[-n:] if n else recs

    def find(self, key: str) -> List[ProvenanceRecord]:
        """Records whose full key or key hash contains ``key``."""
        with self._lock:
            recs = list(self._records)
        return [r for r in recs
                if key in r.key_hash or key in r.key
                or key == r.query_id]

    def info(self) -> dict:
        with self._lock:
            return {"records": len(self._records), "cap": self.cap,
                    "captured": self.captured,
                    "chains": len(self._chains)}


def _entry_stamp(ent) -> dict:
    """A cache entry's JSON-safe ancestry stamp — the ``_rc_leaf``
    vocabulary, projected for the ledger."""
    stamp = {"key_hash": ent.key_hash, "layout": ent.layout,
             "dtype": ent.dtype, "gen": ent.delta_gen,
             "err_bound": float(ent.err_bound or 0.0)}
    if ent.delta_rule:
        stamp["rule"] = ent.delta_rule
    if getattr(ent, "fleet", None):
        stamp["fleet"] = dict(ent.fleet)
    if ent.provenance is not None:
        stamp["provenance"] = dict(
            (k, v) for k, v in ent.provenance.items() if k != "chain")
    return stamp


def _interior_stamps(executed) -> List[dict]:
    """Substitution-leaf ancestry of the tree that actually ran: one
    stamp per ``result_cache`` leaf (whose stamps already
    carry delta/fleet provenance when the consumed entry did) and one
    per ``cse`` leaf (a batch-shared interior hoisted by serve/mqo.py
    — marked ``"cse": True`` so readers can tell the planes apart)."""
    out: List[dict] = []
    seen: set = set()

    def walk(n):
        if n.uid in seen:
            return
        seen.add(n.uid)
        rc = n.attrs.get("result_cache")
        if n.kind == "leaf" and isinstance(rc, dict):
            stamp = {k: v for k, v in rc.items() if k != "deps"}
            pv = n.attrs.get("provenance")
            if isinstance(pv, dict):
                stamp["provenance"] = {
                    k: v for k, v in pv.items() if k != "chain"}
            out.append(stamp)
        cse = n.attrs.get("cse")
        if n.kind == "leaf" and isinstance(cse, dict):
            stamp = {k: v for k, v in cse.items() if k != "deps"}
            stamp["cse"] = True
            out.append(stamp)
        for c in n.children:
            walk(c)

    walk(executed)
    return out


def _strategy_stamps(plan, decisions=None) -> List[dict]:
    """The planner's per-matmul decisions, projected to the
    provenance-relevant columns (executor.plan_provenance) — lazily
    derived + cached on the plan like the obs query event's feed."""
    from matrel_tpu_torch import executor as executor_lib
    try:
        return executor_lib.plan_provenance(plan, decisions)
    except Exception:
        return []


# -- audit replay (every serve path) ------------------------------------

def audit(session, sample: int = 8,
          records: Optional[Iterable[ProvenanceRecord]] = None) -> dict:
    """Replay sampled ledger records fresh — compile the recorded
    expression under the recorded mesh/config (falling back to the
    session's), run it with the result cache bypassed, and prove the
    served answer bit-equal when its composed bound is 0, within the
    stamped err_bound otherwise. Returns a verdict dict; ``ok`` is
    True iff every sampled lineage proved."""
    led = getattr(session, "_prov", None)
    if records is None:
        records = led.records() if led is not None else []
    records = list(records)
    replayable = [r for r in records
                  if r.expr is not None and r.result is not None]
    skipped = len(records) - len(replayable)
    if sample and len(replayable) > sample:
        # evenly spaced over the ledger, newest included — a tail-only
        # sample would never re-prove the oldest surviving lineage
        step = len(replayable) / sample
        picked = [replayable[min(int(i * step), len(replayable) - 1)]
                  for i in range(1, sample)] + [replayable[-1]]
    else:
        picked = replayable
    results = [_replay(session, r) for r in picked]
    failed = [r for r in results if not r["ok"]]
    return {"sampled": len(picked), "replayable": len(replayable),
            "skipped_no_expr": skipped, "failed": len(failed),
            "results": results, "ok": bool(picked) and not failed}


def _replay(session, rec: ProvenanceRecord) -> dict:
    import numpy as np

    from matrel_tpu_torch import executor as executor_lib
    out = {"query_id": rec.query_id, "path": rec.path,
           "key_hash": rec.key_hash, "err_bound": rec.err_bound}
    try:
        plan = executor_lib.compile_expr(
            rec.expr, rec.mesh or session.mesh,
            rec.config or session.config)
        fresh = plan.run().to_numpy()
        got = rec.result.to_numpy()
    except Exception as ex:
        out.update(ok=False, error=repr(ex))
        return out
    exact = (rec.err_bound or 0.0) <= 0.0
    scale = max(float(np.abs(fresh).max()), 1.0)
    err = float(np.abs(got.astype(np.float64)
                       - fresh.astype(np.float64)).max()) / scale
    tol = 0.0 if exact else max(float(rec.err_bound), _REL_FLOOR)
    out.update(exact=exact, rel_err=err, tol=tol,
               ok=(err == 0.0) if exact else (err <= tol))
    return out


# -- rendering ----------------------------------------------------------

def render(summary: dict) -> str:
    """One lineage record (the JSON-safe summary — live or read back
    from the event log) as an indented lineage tree."""
    lines = []
    head = (f"{summary.get('query_id', '?')}  "
            f"path={summary.get('path', '?')}  "
            f"key={summary.get('key_hash', '?')}  "
            f"sla={summary.get('sla', '?')}")
    if summary.get("slice") is not None:
        head += f"  slice={summary['slice']}"
    bound = summary.get("err_bound", 0.0)
    head += f"  err_bound={'exact' if not bound else f'{bound:.3e}'}"
    lines.append(head)
    deg = summary.get("degrade")
    if deg:
        lines.append(f"  degrade: rung {deg.get('rung')} "
                     f"({deg.get('label')})")
    cache = summary.get("cache")
    if cache:
        if cache.get("kind") == "whole":
            e = cache.get("entry") or {}
            lines.append(f"  cache: whole hit <- entry "
                         f"{e.get('key_hash')} (layout "
                         f"{e.get('layout')}, {e.get('dtype')})")
        else:
            lines.append(f"  cache: interior substitution "
                         f"({len(cache.get('leaves') or ())} leaves)")
            for leaf in cache.get("leaves") or ():
                d = leaf.get("delta")
                extra = (f", delta gen {d['gen']} rule {d.get('rule')}"
                         if d else "")
                lines.append(f"    <- entry {leaf.get('key_hash')} "
                             f"(layout {leaf.get('layout')}, "
                             f"{leaf.get('dtype')}{extra})")
        ivm = cache.get("ivm")
        if ivm:
            chain = ivm.get("chain") or []
            hops = " <- ".join(
                f"gen {c['gen']} {c.get('rule')} "
                f"(+{c.get('err_bound', 0.0):.1e})"
                for c in reversed(chain)) or (
                f"gen {ivm.get('gen')} {ivm.get('rule')}")
            lines.append(f"  ivm: patched, composed err_bound "
                         f"{ivm.get('err_bound', 0.0):.3e}")
            lines.append(f"    {hops}")
    fleet = summary.get("fleet")
    if fleet:
        serving = fleet.get("serving", fleet.get("owner"))
        remote = " (remote)" if fleet.get("remote") else ""
        lines.append(f"  fleet: owner slice {fleet.get('owner')} -> "
                     f"served by slice {serving}{remote}")
    stale = summary.get("stale")
    if stale:
        lines.append(f"  stale: served under a "
                     f"{stale.get('staleness_ms', 0):.0f}ms "
                     f"staleness grant")
    strategies = summary.get("strategies")
    if strategies:
        lines.append("  strategies: " + ", ".join(
            s.get("strategy", "?")
            + (f"@{s['tier']}" if s.get("tier") else "")
            + (f" [{s['provenance']}]" if s.get("provenance") else "")
            for s in strategies))
    return "\n".join(lines)


def _audit_workload(device=None):
    """A self-contained serve workload covering the replayable paths
    (fresh execute, whole rc hit, interior substitution, exact int
    path, rebind + delta patch) on a ledger-enabled session — what
    ``why --audit`` samples when no live session exists, on ``device``
    (the card unless the caller asks for another). Small sizes; the
    fleet and degrade paths need threads and are not in it."""
    import numpy as np

    from matrel_tpu_torch.config import default_config
    from matrel_tpu_torch.session import MatrelSession

    cfg = default_config().replace(obs_provenance=64,
                                   result_cache_max_bytes=1 << 26)
    sess = MatrelSession(config=cfg, device=device)
    rng = np.random.default_rng(7)
    A = sess.from_numpy(rng.standard_normal((48, 64)).astype(np.float32))
    B = sess.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    adj = (rng.random((32, 32)) < 0.2).astype(np.float32)
    sess.register("A", sess.from_numpy(adj, integral=True))

    def q_int():
        return sess.table("A").expr().multiply(
            sess.table("A").expr())

    # fresh executes (one batch, the int query riding it for the
    # exact path), the same batch again = whole hits, then a
    # superexpression = interior substitution
    batch = [A.expr().multiply(B.expr()),
             A.expr().multiply(B.expr()).multiply_scalar(2.0),
             q_int()]
    sess.run_many(batch)
    sess.run_many(batch)
    sess.run(A.expr().multiply(B.expr()).multiply_scalar(3.0))
    # rebind + delta patch: the patched entry's next
    # serve is the ivm_patched path, exact (integer counts)
    rows = rng.integers(0, 32, 5)
    cols = rng.integers(0, 32, 5)
    sess.register_delta("A", (rows, cols, np.ones(5, np.float32)),
                        kind="coo")
    sess.run(q_int())
    return sess


def main(args) -> int:
    """``python -m matrel_tpu_torch why`` — render lineage records from
    the event log, or (``--audit``) drive the self-contained workload on
    ``--device`` and replay sampled lineages fresh."""
    if getattr(args, "audit", False):
        sess = _audit_workload(getattr(args, "device", None))
        verdict = audit(sess, sample=args.sample)
        for r in verdict["results"]:
            status = "ok" if r["ok"] else "FAIL"
            detail = (f"bit-equal" if r.get("exact")
                      else f"rel_err {r.get('rel_err', 0.0):.3e} "
                           f"<= tol {r.get('tol', 0.0):.3e}")
            if not r["ok"]:
                detail = r.get(
                    "error",
                    f"rel_err {r.get('rel_err', 0.0):.3e} "
                    f"> tol {r.get('tol', 0.0):.3e}")
            print(f"audit {r['query_id']} [{r['path']}] "
                  f"{status}: {detail}")
        print(f"audit: {verdict['sampled']} sampled, "
              f"{verdict['failed']} failed, "
              f"{verdict['skipped_no_expr']} unreplayable"
              f" -> {'OK' if verdict['ok'] else 'FAILED'}")
        if getattr(args, "check", False):
            return 0 if verdict["ok"] else 1
        return 0
    from matrel_tpu_torch.obs.events import read_events
    events = read_events(getattr(args, "log", None) or None,
                         kinds=("provenance",))
    key = getattr(args, "key", None)
    if key:
        events = [e for e in events
                  if key in e.get("key_hash", "")
                  or key == e.get("query_id")]
    last = getattr(args, "last", None) or 10
    events = events[-last:]
    if not events:
        print("no provenance records (is obs_provenance > 0 and "
              "obs_level != 'off'?)")
        return 0
    for e in events:
        print(render(e))
    return 0
