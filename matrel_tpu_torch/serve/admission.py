"""Per-tenant admission: weighted-fair queuing + quota sheds for the
serve pipeline — the counterpart of ``matrel_tpu/serve/admission.py``.

- **Per-tenant queues, stride-scheduled.** Each tenant named by
  ``config.serve_tenant_weights`` (plus one implicit queue for everyone
  else) holds its own deque; ``get`` pops from the non-empty tenant with
  the smallest stride *pass* value, advancing that pass by
  ``STRIDE_BASE / weight`` — over any backlogged interval tenant service
  is proportional to weight, and batch formation inherits the same
  fairness because the worker's coalescing loop is repeated pops. A
  tenant going active re-enters at the current virtual time, so an idle
  tenant banks no credit. With no weights every entry lands in the one
  implicit queue and pop order is exactly FIFO.
- **Quota shed before global shed.** A tenant at its
  ``serve_tenant_queue_max`` quota sheds typed
  ``AdmissionShed(tenant=..., scope="tenant")`` before the global
  ``serve_queue_max`` bound is consulted.
- **Expired-entry purge at the shed decision point.** Both shed checks
  first purge deadline-expired entries (resolving their futures typed)
  and re-check the bound, so a queue full of expired entries admits a
  fresh query.

Thread-safety and the drain contract: one lock (``"serve.admission"``
in the lockdep inventory) backs everything; the
``all_tasks_done``/``unfinished_tasks``/``task_done`` surface mirrors
``queue.Queue``, and ``get``/``get_nowait`` raise ``queue.Empty``.

SLO feed (``obs/slo.py``; None when off): a typed shed and every purged
expired entry are availability bad events, reported per tenant outside
the lock (the monitor's alert emission does I/O).
"""

from __future__ import annotations

import queue
import threading
from collections import OrderedDict, deque
from typing import Dict, Optional, Tuple

from matrel_tpu_torch.config import parse_tenant_weights
from matrel_tpu_torch.resilience.errors import (AdmissionShed,
                                                DeadlineExceeded)
from matrel_tpu_torch.resilience.retry import now as _now
from matrel_tpu_torch.utils import lockdep

#: Stride-scheduling numerator: pass advances by BASE/weight per pop,
#: so a weight-4 tenant is popped 4x as often as a weight-1 tenant
#: over any backlogged interval.
STRIDE_BASE = 1024.0

#: Minimum seconds between purge SCANS at the shed decision points.
#: Under sustained overload thousands of sheds/s would each rescan the
#: full queue while holding the lock the worker needs to pop — a
#: deadline only expires on a wall-clock timescale, so one scan per
#: few milliseconds bounds the cost without changing the contract
#: (a queue sitting full of expired entries is always past the
#: throttle by the time a fresh submission tests it).
PURGE_INTERVAL_S = 0.005


class AdmissionQueue:
    """Weighted-fair multi-tenant admission queue (see module
    docstring). Entries are the pipeline's tuples; the queue only ever
    inspects ``entry[1]`` (the future) and ``entry[4]`` (the deadline)
    — both present from the 5-tuple shape on."""

    def __init__(self, config, slo=None):
        self.weights: Dict[str, float] = parse_tenant_weights(
            getattr(config, "serve_tenant_weights", ""))
        self.global_max = int(getattr(config, "serve_queue_max", 0))
        self.tenant_max = int(getattr(config,
                                      "serve_tenant_queue_max", 0))
        self.slo = slo
        self._lock = lockdep.make_lock("serve.admission")
        self._not_empty = threading.Condition(self._lock)
        # queue.Queue-compatible drain surface (pipeline.drain waits
        # on these exact names)
        self.all_tasks_done = threading.Condition(self._lock)
        self.unfinished_tasks = 0
        # tenant -> deque, created on first submission; deques are
        # bounded by the shed checks in put(), not by maxlen — a
        # maxlen deque DROPS silently, and the whole point here is
        # that refusal is typed
        self._queues: "OrderedDict[str, deque]" = OrderedDict()
        self._pass: Dict[str, float] = {}
        self._vtime = 0.0
        self._size = 0
        # lifetime counters (the overload event emitter reads these
        # and turns them into per-cycle deltas)
        self.sheds: Dict[str, int] = {}
        self.purged_expired = 0
        self._last_purge = 0.0
        #: the lead rank's queue on a rank mesh (``serve/ranklog.py``):
        #: a shed raises uncounted and a purge resolves nothing — both
        #: become entries of the next decision record, counted and
        #: resolved on every rank when the record is applied
        self.deferring = False
        self._deferred: list = []

    # -- weights -----------------------------------------------------------

    def weight(self, tenant: Optional[str]) -> float:
        return self.weights.get(tenant or "", 1.0)

    def lowest_weight_tenant(self, tenant: Optional[str]) -> bool:
        """True when ``tenant`` sits at the bottom of the configured
        weight order — the rung-3 brownout shed set. With no weights
        (or all weights equal) NOBODY is lowest: a single implicit
        tenant has no one to yield to."""
        if not self.weights:
            return False
        values = set(self.weights.values())
        if len(values) < 2:
            return False
        return self.weight(tenant) <= min(values)

    # -- producer side -----------------------------------------------------

    def put(self, entry, tenant: Optional[str] = None) -> None:
        """Admit one entry for ``tenant`` (None/"" = the implicit
        tenant). Sheds typed — per-tenant quota FIRST, then the global
        bound — after purging deadline-expired entries at each
        decision point. Purged futures resolve AFTER the lock drops:
        ``set_exception`` runs done-callbacks inline, and a callback
        that touches this queue (a resubmit, a qsize read) from inside
        the lock would deadlock the submitting thread."""
        key = tenant if tenant is not None else self._entry_tenant(
            entry)
        to_fail: list = []
        shed = False
        try:
            with self._lock:
                dq = self._queues.get(key)
                if dq is None:
                    dq = self._queues[key] = deque()  # matlint: disable=ML011 bounded by the typed shed checks below — a maxlen deque would DROP silently instead of refusing typed
                    self._pass[key] = self._vtime
                if self.tenant_max > 0 and len(dq) >= self.tenant_max:
                    self._purge_expired_locked(key, to_fail)
                    if len(dq) >= self.tenant_max:
                        shed = not self.deferring
                        if shed:
                            self.sheds[key] = self.sheds.get(key, 0) + 1
                        raise AdmissionShed(self.tenant_max,
                                            tenant=key or None,
                                            scope="tenant")
                if self.global_max > 0 \
                        and self._size >= self.global_max:
                    self._purge_expired_locked(None, to_fail)
                    if self._size >= self.global_max:
                        shed = not self.deferring
                        if shed:
                            self.sheds[key] = self.sheds.get(key, 0) + 1
                        raise AdmissionShed(self.global_max,
                                            tenant=key or None,
                                            scope="queue")
                # a tenant going active re-enters at the current
                # virtual time: no banked credit from idling
                # (standard stride)
                if not dq:
                    self._pass[key] = max(self._pass.get(key, 0.0),
                                          self._vtime)
                dq.append(entry)
                self._size += 1
                self.unfinished_tasks += 1
                self._not_empty.notify()
        finally:
            for fut, ex, _t in to_fail:
                # RUNNING first (the worker's own discipline): a
                # future the caller cancelled concurrently drops out
                # instead of racing set_exception
                if fut.set_running_or_notify_cancel():
                    fut.set_exception(ex)
            if self.slo is not None:
                if shed:
                    self.slo.record_shed(key or None)
                for _f, _ex, t in to_fail:
                    self.slo.record_miss(t or None)

    # queue.Queue compat (tests enqueue legacy short tuples directly)
    put_nowait = put

    def defer(self, entry, verdict: tuple) -> None:
        """Hold one entry the lead refused (``verdict``: ("shed", scope,
        bound) or ("purged", budget_ms, elapsed_ms)) for the next
        decision record; it counts as an unfinished task until the
        record is applied."""
        with self._lock:
            self._deferred.append((entry, verdict))
            self.unfinished_tasks += 1
            self._not_empty.notify()

    def take_deferred(self) -> list:
        with self._lock:
            out, self._deferred = self._deferred, []
            return out

    def note_purged(self, tenant: Optional[str]) -> None:
        """Count a purge a decision record carried."""
        with self._lock:
            self.purged_expired += 1
        if self.slo is not None:
            self.slo.record_miss(tenant or None)

    def record_shed(self, tenant: Optional[str]) -> None:
        """Count a shed decided outside the bounds (the brownout rung-3
        tenant shed happens in the pipeline, before ``put``)."""
        key = tenant or ""
        with self._lock:
            self.sheds[key] = self.sheds.get(key, 0) + 1
        if self.slo is not None:
            self.slo.record_shed(tenant)

    @staticmethod
    def entry_provenance(entry) -> dict:
        """One queue tuple projected for a lineage record (the
        provenance ledger's stale-serve capture)."""
        return {
            "tenant": (entry[5] or None) if len(entry) > 5 else None,
            "sla": entry[3] if len(entry) > 3 else None,
            "staleness_ms": entry[6] if len(entry) > 6 else None,
        }

    @staticmethod
    def _entry_tenant(entry) -> str:
        return (entry[5] or "") if len(entry) > 5 else ""

    def _purge_expired_locked(self, tenant: Optional[str],
                              to_fail: list) -> int:
        """Drop every queued entry whose deadline already expired —
        from one tenant's queue or all of them — collecting
        (future, typed error, tenant) triples into ``to_fail`` for the
        caller to resolve OUTSIDE the lock. Runs at the shed decision
        points so dead entries can never hold slots against live
        traffic."""
        t = _now()
        if t - self._last_purge < PURGE_INTERVAL_S:
            return 0
        self._last_purge = t
        purged = 0
        keys = (tenant,) if tenant is not None else tuple(self._queues)
        for key in keys:
            dq = self._queues.get(key)
            if not dq:
                continue
            keep: deque = deque()  # matlint: disable=ML011 transient rebuild buffer for one purge pass, bounded by the queue it rebuilds
            for it in dq:
                dl = it[4] if len(it) > 4 else None
                if dl is not None and dl.expired() and self.deferring:
                    self._deferred.append((it, (
                        "purged", dl.budget_ms, dl.elapsed_ms())))
                    self._size -= 1
                elif dl is not None and dl.expired():
                    to_fail.append((it[1], DeadlineExceeded(
                        dl.budget_ms, dl.elapsed_ms(),
                        context="queued query (purged)"), key))
                    purged += 1
                    self._size -= 1
                    self.unfinished_tasks -= 1
                else:
                    keep.append(it)
            if len(keep) != len(dq):
                dq.clear()
                dq.extend(keep)
        if purged:
            self.purged_expired += purged
            if self.unfinished_tasks <= 0:
                self.all_tasks_done.notify_all()
        return purged

    # -- consumer side (the worker) ----------------------------------------

    def _pop_locked(self):
        """Weighted-fair pop: the non-empty tenant with the smallest
        stride pass value wins (ties break by tenant creation order —
        deterministic); its pass advances by BASE/weight. One implicit
        tenant degenerates to popleft — the historical FIFO."""
        best = None
        for key, dq in self._queues.items():
            if not dq:
                continue
            p = self._pass.get(key, 0.0)
            if best is None or p < best[1]:
                best = (key, p)
        if best is None:
            raise queue.Empty
        key, p = best
        self._vtime = p
        self._pass[key] = p + STRIDE_BASE / self.weight(key)
        self._size -= 1
        return self._queues[key].popleft()

    def get(self, timeout: Optional[float] = None):
        with self._not_empty:
            if self._size == 0:
                self._not_empty.wait(timeout)
            return self._pop_locked()   # raises queue.Empty when dry

    def get_nowait(self):
        with self._lock:
            return self._pop_locked()

    def task_done(self) -> None:
        with self.all_tasks_done:
            self.unfinished_tasks -= 1
            if self.unfinished_tasks <= 0:
                self.all_tasks_done.notify_all()

    def steal_entries(self) -> list:
        """Remove and return every queued entry as ``(entry, tenant)``
        pairs — the dead/wedged-slice failover surface
        (``serve/fleet.py``): the fleet re-admits them onto surviving
        slices with futures, deadlines and tenants intact. The stolen
        entries' unfinished-task counts are released (their completion
        is another queue's business now), so a drain of the dead
        pipeline never waits on work that moved."""
        with self._lock:
            out = []
            for key, dq in self._queues.items():
                while dq:
                    out.append((dq.popleft(), key))
            self._size = 0
            self.unfinished_tasks = max(
                self.unfinished_tasks - len(out), 0)
            if self.unfinished_tasks <= 0:
                self.all_tasks_done.notify_all()
            return out

    # -- observability -----------------------------------------------------

    def qsize(self) -> int:
        with self._lock:
            return self._size

    def load(self) -> Tuple[int, bool]:
        """(queued entries, busy): busy while the worker holds entries
        it took (or deferred) and has not finished."""
        with self._lock:
            return self._size, self.unfinished_tasks > self._size

    def tenant_depths(self) -> Dict[str, int]:
        with self._lock:
            return {k: len(dq) for k, dq in self._queues.items()
                    if dq}

    def counters(self) -> dict:
        """Cumulative shed/purge counters (the overload event emitter
        diffs successive snapshots into per-cycle deltas)."""
        with self._lock:
            return {"sheds": dict(self.sheds),
                    "purged_expired": self.purged_expired}
