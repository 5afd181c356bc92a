"""Micro-batched admission + asynchronous execution — the counterpart of
``matrel_tpu/serve/pipeline.py``.

``session.submit(expr)`` returns a ``concurrent.futures.Future``; one
admission worker per session drains the submission queue, coalesces up
to ``config.serve_max_batch`` concurrent queries into ONE MultiPlan
(``session.run_many``) and resolves their futures as soon as the batch
is DISPATCHED: on a CUDA device ``run_many`` returns once the batch's
kernels are enqueued on the worker's stream, so the worker plans the
next batch while the card runs this one.

The overlap is bounded: past ``config.serve_max_inflight`` dispatched
but unsynced batches the worker waits on the oldest. A dispatched batch
is its results plus a ``torch.cuda.Event`` recorded on the worker's
stream right after it; syncing a batch waits on that event. Each future
carries the event as ``future.ready_event`` (None on the CPU): a
consumer on the device's default stream — the worker's stream too —
needs nothing, a consumer on another stream waits on the event before
touching the result.

The worker sets the session's device before its first batch (a CUDA
context is per thread); the kernels' lazy build (``utils/cuda_build``)
holds a lock, and the plan-level memos a kernel reads (CSR views, tile
payloads) are built idempotently, so either thread may reach them first.

Resilience and overload contracts kept from the JAX package:

- **Poison-query isolation by batch bisection**: a failing MultiPlan is
  recursively split — only the poison query's own future resolves with
  the error, siblings complete normally; a single query failing
  transient re-admits up to ``config.retry_max_attempts`` times.
- **Backpressure**: per-tenant (``serve_tenant_queue_max``) then global
  (``serve_queue_max``) bounds shed typed ``AdmissionShed``
  (``serve/admission.py``), after purging expired entries.
- **Deadlines**: a future whose deadline expires while queued — or
  whose batch finishes past it — resolves typed ``DeadlineExceeded``;
  expired entries never reach compilation.
- **Typed shutdown**: ``drain(timeout=...)`` raises ``DrainTimeout``
  instead of hanging on a wedged worker or a wedged batch (the event is
  polled against the budget); ``submit`` after ``close()`` raises
  ``PipelineClosed``.
- **Same-SLA batches**: mixed precision SLAs run as separate
  sub-batches, so a "fast" neighbour never changes an "exact" query.

- **Adaptive brownout**: with a session
  :class:`resilience.brownout.LoadController` the worker feeds it one
  sample per admission cycle (queue depth, queue waits, deadline
  misses) and acts on its rung: rung 1 downshifts default-SLA queries
  to the "fast" tier (stamped), rung 2 serves rebind-stale result-cache
  entries to queries declaring ``staleness_ms``, rung 3 sheds the
  lowest-weight tenants typed at submit.
- **Circuit breakers**: with a session
  :class:`resilience.breaker.BreakerRegistry`, an entry whose plan
  class is open fails fast (``CircuitOpen``); terminal outcomes feed
  the class's health.
- **Obs**: the admission span ``serve.admit`` (the serve trail's root
  in the worker thread), one ``overload`` event per admission cycle
  while the control plane is active (rung, tenant depths/waits,
  shed/purge/stale deltas, breaker state), ``retry`` events for
  re-admissions and bisections, the SLO outcome feed, and fault site
  ``serve_admit``.

Locks are built through ``utils/lockdep`` (``"serve.pipeline"``).
"""

from __future__ import annotations

import collections
import logging
import queue
import threading
import time
from concurrent.futures import Future
from typing import Optional

import torch

from matrel_tpu_torch.obs import trace as trace_lib
from matrel_tpu_torch.resilience import breaker as breaker_lib
from matrel_tpu_torch.resilience import brownout as brownout_lib
from matrel_tpu_torch.resilience import faults as faults_lib
from matrel_tpu_torch.resilience import retry as retry_lib
from matrel_tpu_torch.resilience.errors import (AdmissionShed,
                                                CircuitOpen,
                                                DeadlineExceeded,
                                                DrainTimeout,
                                                PipelineClosed,
                                                is_transient)
from matrel_tpu_torch.resilience.retry import Deadline
from matrel_tpu_torch.serve.admission import AdmissionQueue
from matrel_tpu_torch.utils import lockdep

log = logging.getLogger("matrel_tpu_torch.serve")

#: Entry layout: (expr, future, t_enqueue, sla, deadline, tenant,
#: staleness_ms). Shorter tuples (white-box callers) are right-padded
#: with these defaults.
_ENTRY_DEFAULTS = ("default", None, "", None)

#: Poll interval of a bounded sync (seconds): a batch's event is
#: queried this often until it completes or the budget runs out.
SYNC_POLL_S = 0.0005


class Dispatched:
    """One dispatched batch: its results and the event recorded on the
    worker's stream after its last kernel (None on the CPU, where a
    result exists when ``run_many`` returns)."""

    __slots__ = ("outs", "event")

    def __init__(self, outs, event):
        self.outs = outs
        self.event = event

    def done(self) -> bool:
        return self.event is None or self.event.query()

    def wait(self) -> None:
        if self.event is not None:
            self.event.synchronize()


def _record_event(device: torch.device):
    """A ``torch.cuda.Event`` recorded on ``device``'s current stream of
    the calling thread, or None off CUDA."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


class ServePipeline:
    """One session's admission queue + worker thread (daemon, started
    on first submit). Not a pool: queries of one session share its
    plan/result caches, so one worker keeps every cache consult
    race-free while the caller's thread stays free to submit."""

    def __init__(self, session):
        self.session = session
        self.max_batch = session.config.serve_max_batch
        self.max_inflight = session.config.serve_max_inflight
        # the SLO plane (None when off): the queue reports typed sheds
        # and purges, this pipeline resolution latency and deadline
        # misses — the outcome stream the burn-rate monitors watch
        self._slo = session._slo
        self._q = AdmissionQueue(session.config, slo=self._slo)
        self._inflight: "collections.deque" = collections.deque()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        # submit() holds it across the closed-check + enqueue +
        # _ensure_worker (which locks again) so a concurrent close()
        # can never interleave between them
        self._lock = lockdep.make_rlock("serve.pipeline")
        # overload control plane (session-owned; None when off): the
        # brownout controller and breakers, plus the last counter
        # snapshot the overload event diffs against
        self._brownout = session._brownout
        self._breakers = session._breakers
        self._overload_active = (
            self._brownout is not None or self._breakers is not None
            or self._slo is not None or bool(self._q.weights))
        self._overload_last: dict = {}
        self.stale_served = 0
        self.deadline_misses = 0
        # late deadline misses (a batch finished past a query's
        # deadline), folded into the NEXT cycle's controller sample:
        # one observe() per admission cycle. Worker-thread-only.
        self._late_misses = 0
        self.batches = 0

    # -- public surface ----------------------------------------------------

    def submit(self, expr, sla: str = "default",
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               staleness_ms: Optional[float] = None) -> Future:
        """Enqueue one query; returns its future. ``sla`` is the
        query's precision SLA (same-SLA queries coalesce);
        ``deadline_ms`` starts the query's deadline clock now (queue
        wait counts against it); ``tenant`` names the submitting tenant
        for weighted-fair admission (None = the implicit tenant).
        ``staleness_ms`` declares how old a STALE result-cache answer
        this query tolerates (consumed only at brownout rung >= 2)."""
        fut: Future = Future()
        fut.ready_event = None
        dl = Deadline(deadline_ms) if deadline_ms is not None else None
        entry = (expr, fut, time.perf_counter(), sla, dl, tenant or "",
                 staleness_ms)
        # closed-check + enqueue + worker-ensure are ONE atomic step vs
        # close(): no future can be stranded in a dead queue
        with self._lock:
            if self._closed:
                raise PipelineClosed(
                    "submit after close(): the admission worker is "
                    "stopped — build a new session (or pipeline) to "
                    "serve again")
            # brownout rung 3: shed lowest-weight tenants FIRST —
            # typed, before any queue slot is consumed
            ctl = self._brownout
            if (ctl is not None
                    and ctl.rung() >= brownout_lib.SHED_RUNG
                    and self._q.lowest_weight_tenant(tenant)):
                self._q.record_shed(tenant)
                raise AdmissionShed(self._q.tenant_max
                                    or self._q.global_max,
                                    tenant=tenant, scope="brownout")
            self._q.put(entry, tenant or "")
            self._ensure_worker()
        return fut

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted query is dispatched AND every
        dispatched batch has completed on the device. ``timeout``
        (seconds) bounds the whole wait: a wedged worker or batch
        raises the typed ``DrainTimeout``; queue state is untouched."""
        t_abs = (retry_lib.now() + timeout
                 if timeout is not None else None)
        with self._q.all_tasks_done:
            while self._q.unfinished_tasks:
                rem = (None if t_abs is None
                       else t_abs - retry_lib.now())
                if rem is not None and rem <= 0:
                    raise DrainTimeout(timeout,
                                       self._q.unfinished_tasks)
                self._q.all_tasks_done.wait(rem)
        while self._inflight:
            rem = None if t_abs is None else t_abs - retry_lib.now()
            if rem is not None and rem <= 0:
                raise DrainTimeout(timeout, len(self._inflight))
            try:
                batch = self._inflight.popleft()
            except IndexError:      # the worker synced it concurrently
                break
            if not _sync_bounded(batch, rem):
                # the batch goes BACK in front: a later drain can
                # finish it
                self._inflight.appendleft(batch)
                raise DrainTimeout(timeout, len(self._inflight))

    def close(self, timeout: Optional[float] = None) -> None:
        """Stop the worker after the queue drains. A later ``submit``
        raises the typed ``PipelineClosed``."""
        with self._lock:
            # flip FIRST (atomic vs submit): a submit that already
            # passed the check has its entry enqueued with the worker
            # alive, and the drain below processes it
            self._closed = True
        try:
            self.drain(timeout=timeout)
        finally:
            self._stop.set()

    def readmit_entry(self, entry, tenant: str) -> None:
        """Fleet-failover seam (``serve/fleet.py`` is the one caller):
        enqueue an already-built entry under the same closed-check +
        enqueue + worker-ensure atomicity ``submit`` keeps, so a stolen
        future re-admitted into a pipeline a concurrent ``close()`` just
        flipped refuses typed instead of stranding in a workerless
        queue. Raises ``PipelineClosed`` / ``AdmissionShed``."""
        with self._lock:
            if self._closed:
                raise PipelineClosed(
                    "re-admission after close(): the admission "
                    "worker is stopped")
            self._q.put(entry, tenant)
            self._ensure_worker()

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def inflight_depth(self) -> int:
        return len(self._inflight)

    # -- worker ------------------------------------------------------------

    def _ensure_worker(self) -> None:
        with self._lock:
            if self._closed:
                return
            if self._worker is None or not self._worker.is_alive():
                self._stop.clear()
                self._worker = threading.Thread(
                    target=self._run, name="matrel-serve", daemon=True)
                self._worker.start()

    def _run(self) -> None:
        dev = self.session.device
        if dev.type == "cuda":
            # a CUDA context is per thread: launch on the session's card
            torch.cuda.set_device(dev)
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                if self._slo is not None:
                    # burn decays as the windows slide: a drained plane
                    # clears its alerts without waiting for a query
                    self._slo.tick()
                continue
            pulled = [first]
            while len(pulled) < self.max_batch:
                try:
                    pulled.append(self._q.get_nowait())
                except queue.Empty:
                    break
            pulled = [(*it, *_ENTRY_DEFAULTS[len(it) - 3:])
                      if len(it) < 7 else it for it in pulled]
            # RUNNING first: a future the caller cancelled while queued
            # drops out here — set_result on it would raise and kill
            # the worker, stranding every sibling future
            batch = [it for it in pulled
                     if it[1].set_running_or_notify_cancel()]
            t_admit = time.perf_counter()
            cycle_waits = [round((t_admit - it[2]) * 1e3, 3)
                           for it in batch]
            # deadline shed BEFORE compilation
            live = []
            misses = 0
            for it in batch:
                dl = it[4]
                if dl is not None and dl.expired():
                    _fail(it[1], DeadlineExceeded(
                        dl.budget_ms, dl.elapsed_ms(),
                        context="queued query"))
                    misses += 1
                    if self._slo is not None:
                        self._slo.record_miss(it[5] or None)
                else:
                    live.append(it)
            self.deadline_misses += misses
            # circuit breakers: an entry whose plan class is OPEN fails
            # fast (typed, probe schedule attached)
            if self._breakers is not None:
                admitted = []
                for it in live:
                    try:
                        self._breakers.admit(
                            self._breakers.plan_class(it[0]))
                    except CircuitOpen as ex:
                        _fail(it[1], ex)
                        if self._slo is not None:
                            self._slo.record_shed(it[5] or None)
                    else:
                        admitted.append(it)
                live = admitted
            # per-tenant queue waits AT ADMISSION — what the controller
            # and the overload event read
            tenant_waits: dict = {}
            for it, w in zip(batch, cycle_waits):
                tenant_waits.setdefault(it[5] or "", []).append(w)
            # brownout: ONE load sample per admission cycle (late
            # deadline misses of earlier batches fold in here), then
            # act on the (possibly new) rung
            rung = 0
            ctl = self._brownout
            if ctl is not None:
                late, self._late_misses = self._late_misses, 0
                rung = ctl.observe(depth=self._q.qsize(),
                                   waits_ms=cycle_waits,
                                   misses=misses + late,
                                   admitted=len(live))
            stale_served = 0
            if (rung >= brownout_lib.STALE_RUNG
                    and self.session._rc_enabled()):
                # rung 2: a query that DECLARED a staleness tolerance
                # may be answered by the stale ghost of a rebind-
                # invalidated entry — exact answer, slightly old
                # catalog; nothing compiles, nothing runs
                remaining = []
                for it in live:
                    ent = (self.session._rc_stale_probe(
                        it[0], it[3], it[6]) if it[6] else None)
                    if ent is not None:
                        if not it[1].done():
                            it[1].set_result(ent.result)
                        stale_served += 1
                        if self.session._prov is not None:
                            self.session._prov_capture_stale(
                                it[0], ent,
                                AdmissionQueue.entry_provenance(it))
                        if self._slo is not None:
                            self._slo.record_ok(
                                it[5] or None,
                                (time.perf_counter() - it[2]) * 1e3)
                        # a cache hit says nothing about the class's
                        # execution health: release the probe slot
                        self._breaker_done(it[0], None)
                    else:
                        remaining.append(it)
                live = remaining
                self.stale_served += stale_served
            if rung >= brownout_lib.TIER_RUNG:
                # rung 1: default-SLA queries downshift to the "fast"
                # tier, stamped on the expr root (the prec:fast| key
                # prefix isolates the browned-out plan and result)
                live = [self._downshift(it, rung) for it in live]
            # same-SLA sub-batches, admission order preserved
            groups: "collections.OrderedDict" = collections.OrderedDict()
            for it in live:
                groups.setdefault(it[3], []).append(it)
            try:
                for sla, part in groups.items():
                    self._run_group(
                        sla, part, t_admit, depth=0,
                        retries=self.session.config.retry_max_attempts,
                        rung=rung)
            finally:
                for _ in pulled:
                    self._q.task_done()
                if self._overload_active:
                    self._emit_overload(rung, tenant_waits, misses,
                                        stale_served)

    @staticmethod
    def _downshift(it, rung: int):
        """Rung >= 1: rewrite one entry's expr/sla for the fast tier.
        Non-default SLAs pass through — an explicit accuracy ask is an
        ask. The stamp carries the AUTHORIZING rung
        (``brownout.downshift_stamp``), so every downshifted plan
        shares one cache key whatever the instantaneous rung."""
        if it[3] != "default":
            return it
        stamp = brownout_lib.downshift_stamp(
            it[6] if rung >= brownout_lib.STALE_RUNG else None)
        e = it[0].with_attrs(brownout=stamp)
        return (e, it[1], it[2], "fast", it[4], it[5], it[6])

    def _breaker_done(self, expr, ok, ex: BaseException = None) -> None:
        """Record one admitted entry's terminal outcome against its
        plan-class breaker (no-op when breakers are off). Outcomes that
        say nothing about the class — deadline, shed, abort — release
        the probe slot without a transition."""
        if self._breakers is None:
            return
        cls = self._breakers.plan_class(expr)
        if ok:
            self._breakers.record(cls, True)
        elif ex is not None and breaker_lib.counts_as_failure(ex):
            self._breakers.record(cls, False)
        else:
            self._breakers.record(cls, None)

    def _emit_overload(self, rung: int, tenant_waits: dict,
                       misses: int, stale_served: int) -> None:
        """One ``overload`` record per admission cycle while the
        control plane is active: rung/depths, this cycle's per-tenant
        admission-time waits, and shed/purge/breaker-transition DELTAS
        against the last cycle."""
        sess = self.session
        if not (sess._obs_enabled() or sess._flight is not None):
            return
        try:
            counters = self._q.counters()
            last = self._overload_last
            shed_delta = {
                t: n - last.get("sheds", {}).get(t, 0)
                for t, n in counters["sheds"].items()
                if n - last.get("sheds", {}).get(t, 0)}
            admitted = {t: len(ws) for t, ws in tenant_waits.items()}
            rec = {
                "rung": rung,
                "rung_label": brownout_lib.rung_label(rung),
                "queue_depth": self._q.qsize(),
                "tenant_depths": self._q.tenant_depths(),
                "admitted": admitted,
                "tenant_waits_ms": tenant_waits,
                "sheds": shed_delta,
                "purged_expired": (counters["purged_expired"]
                                   - last.get("purged_expired", 0)),
                "deadline_misses": misses,
                "stale_served": stale_served,
            }
            if self._brownout is not None:
                rec["brownout"] = self._brownout.snapshot()
            if self._slo is not None:
                rec["slo"] = self._slo.snapshot()
            if self._breakers is not None:
                snap = self._breakers.snapshot()
                lt = last.get("breaker_transitions", {})
                rec["breakers"] = {
                    "open": snap["open"],
                    "half_open": snap["half_open"],
                    "transitions": {
                        k: v - lt.get(k, 0)
                        for k, v in snap["transitions"].items()},
                }
                counters["breaker_transitions"] = snap["transitions"]
            self._overload_last = counters
            sess._emit_overload_event(rec)
        except Exception:   # the never-fail obs contract
            log.warning("obs: overload event dropped", exc_info=True)

    def _run_group(self, sla: str, batch: list, t_admit: float,
                   depth: int, retries: int = 0, rung: int = 0) -> None:
        """Run one same-SLA sub-batch through ``session.run_many`` and
        resolve its futures. A failing batch bisects; a single query
        failing transient re-admits up to ``retries`` times."""
        if not batch:
            return
        waits_ms = [round((t_admit - it[2]) * 1e3, 3) for it in batch]
        sess = self.session
        try:
            # fault site "serve_admit" INSIDE the try: an injected
            # admission fault takes the bisection/re-admission path
            faults_lib.check("serve_admit", sess.config)
            # worker-thread tracer activation: the admission span is
            # the serve trail's root; run_many's spans link under it
            with trace_lib.activate(sess._tracer), \
                    trace_lib.span(
                        "serve.admit", batch=len(batch),
                        inflight=len(self._inflight),
                        bisect_depth=depth,
                        max_wait_ms=(max(waits_ms) if waits_ms
                                     else 0.0)):
                outs = sess.run_many(
                    [it[0] for it in batch], precision=sla,
                    _queue_wait_ms=waits_ms,
                    _inflight_depth=len(self._inflight),
                    _tenants=[it[5] for it in batch],
                    _brownout_rung=rung or None)
            done = Dispatched(outs, _record_event(sess.device))
        except Exception as ex:  # noqa: BLE001 — bisect, re-admit or
            # fail the lone future; the worker survives either way
            if depth == 0:
                # the post-mortem trail of a failed serve batch (no-op
                # with the flight recorder off)
                sess._flight_auto_dump(ex, reason="serve_batch_failure")
            if len(batch) == 1:
                if retries > 0 and is_transient(ex):
                    sess._emit_retry_event(ex, attempt=depth + 1,
                                           rung=0, scope="serve_readmit")
                    self._run_group(sla, batch, t_admit, depth + 1,
                                    retries=retries - 1, rung=rung)
                else:
                    # TERMINAL single-query failure: the breaker's
                    # class-health signal (retry budget spent)
                    self._breaker_done(batch[0][0], False, ex)
                    _fail(batch[0][1], ex)
                    if self._slo is not None:
                        self._slo.record_bad(batch[0][5] or None,
                                             "error")
                return
            sess._emit_retry_event(ex, attempt=depth + 1, rung=0,
                                   scope="serve_bisect")
            mid = len(batch) // 2
            self._run_group(sla, batch[:mid], t_admit, depth + 1,
                            retries=retries, rung=rung)
            self._run_group(sla, batch[mid:], t_admit, depth + 1,
                            retries=retries, rung=rung)
            return
        self.batches += 1
        for it, out in zip(batch, outs):
            fut, dl = it[1], it[4]
            if dl is not None and dl.expired():
                # the batch finished past this query's deadline: the
                # future resolves typed, never a late answer; the miss
                # folds into the NEXT cycle's controller sample
                self.deadline_misses += 1
                self._late_misses += 1
                self._breaker_done(it[0], None)
                _fail(fut, DeadlineExceeded(
                    dl.budget_ms, dl.elapsed_ms(),
                    context="served query"))
                if self._slo is not None:
                    self._slo.record_miss(it[5] or None)
            else:
                self._breaker_done(it[0], True)
                if not fut.done():
                    fut.ready_event = done.event
                    fut.set_result(out)
                if self._slo is not None:
                    # resolution latency = enqueue → dispatched, the
                    # serve plane's own clock (host; no device sync)
                    self._slo.record_ok(
                        it[5] or None,
                        (time.perf_counter() - it[2]) * 1e3)
        if outs:
            self._inflight.append(done)
        while len(self._inflight) > self.max_inflight:
            # backpressure: wait for the OLDEST dispatched batch before
            # planning more
            try:
                _sync(self._inflight.popleft())
            except IndexError:
                break


def _fail(fut: Future, ex: BaseException) -> None:
    if not fut.done():
        fut.set_exception(ex)


def _sync_bounded(batch: Dispatched, rem: Optional[float]) -> bool:
    """Wait for one dispatched batch within ``rem`` seconds (None = no
    bound) by polling its event, so a wedged batch cannot hang the
    caller: False when the budget ran out first."""
    if rem is None:
        _sync(batch)
        return True
    t_end = retry_lib.now() + rem
    while not batch.done():
        if retry_lib.now() >= t_end:
            return False
        time.sleep(SYNC_POLL_S)
    return True


def _sync(batch: Dispatched) -> None:
    # sanctioned blocking point (utils/lockdep.py): with the sanitizer
    # on, a serve lock held here is a HeldAcrossDispatch diagnostic
    lockdep.note_dispatch("serve.sync")
    try:
        batch.wait()
    except Exception:  # a device-side error surfaces at the consumer's
        # own touch of the result; the pipeline only needed the
        # backpressure
        log.warning("serve: in-flight batch sync failed", exc_info=True)
