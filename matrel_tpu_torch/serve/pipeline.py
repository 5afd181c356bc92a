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

- **One decision path** (``serve/ranklog.py``): every admission cycle
  is a record that the worker decides (:meth:`ServePipeline._decide`)
  and then applies (:meth:`ServePipeline._apply`). Off a rank mesh the
  log has one rank and exchanges nothing. On a rank mesh
  (``session.mesh.ranked``) the lead rank decides and every rank
  applies the same record; a shed or purge the lead decides fails the
  future typed on every rank, so there ``submit`` never raises
  ``AdmissionShed`` itself: the future carries it. The worker holds the
  world's execution lock (``RankGroups.cycle``) while it applies a
  record; the session's collective entry points drain it first and
  hold the same lock (``RankGroups.held``). A fleet slice's pipeline
  on a rank mesh (``serve/fleet.py``) runs on the slice's ranks only,
  its records on the slice's own control group with the slice's first
  rank as lead, so the slices serve at the same time; the fleet's
  router files each slice-placed query into it
  (:meth:`ServePipeline.admit_routed`) under the sequence number the
  router's record assigned, and it keeps every contract above. The
  router drives the parent's pipeline (a span-placed query), and a
  slice's where the slices share the world, one routed query a cycle
  (:meth:`ServePipeline.decide_routed` /
  :meth:`ServePipeline.apply_routed`).

Locks are built through ``utils/lockdep`` (``"serve.pipeline"``).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
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
                                                RankDivergence,
                                                is_transient)
from matrel_tpu_torch.resilience.retry import Deadline
from matrel_tpu_torch.serve import ranklog
from matrel_tpu_torch.serve.admission import AdmissionQueue
from matrel_tpu_torch.utils import lockdep

log = logging.getLogger("matrel_tpu_torch.serve")

#: Entry layout: (expr, future, t_enqueue, sla, deadline, tenant,
#: staleness_ms), and on a rank mesh also (sequence number, rank key).
#: Shorter tuples (white-box callers) are right-padded with these
#: defaults.
_ENTRY_DEFAULTS = ("default", None, "", None)

#: Positions of the rank-mesh fields (``serve/ranklog.py``).
SEQ, KEY = 7, 8

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
        self._inflight: "collections.deque" = collections.deque()  # matlint: disable=ML011 bounded by the serve_max_inflight sync loop in _run_group
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
        # the decision log (one rank off a rank mesh). On a rank mesh
        # the lead's queue defers its sheds and purges into the next
        # record, a follower keeps its entries in a store keyed by
        # sequence number
        self._log = ranklog.DecisionLog(session.mesh)
        self._ranked = self._log.world > 1
        #: a rank mesh's worker registers with the world's drain-and-hold
        #: and takes its execution lock around a cycle (a fleet slice of
        #: one rank too, though its log exchanges nothing)
        self._on_ranks = session.mesh.ranked
        self.control = self._log.group
        #: the fleet's hooks for a slice-placed answer on a rank mesh
        #: (``serve/fleet.py``): ``wrap(out)``, ``info(batch, outs)``,
        #: ``served(batch, info, late)``; None elsewhere
        self.route = None
        #: set by a fleet failover on every rank of a slice whose worker
        #: lives: the lead's worker publishes one last record,
        #: ``{"stop": True}``, that releases a follower waiting for a
        #: record on an entry the failover took away
        self._await_stop = False
        self._seq = itertools.count()
        self._store = None
        self._tasks = self._q
        self.divergences = 0
        if self._ranked:
            if self._log.lead:
                self._q.deferring = True
            else:
                self._store = self._tasks = ranklog.EntryStore(SEQ)

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
        entry = (expr, fut, time.perf_counter(), sla, dl, tenant or "",  # matlint: disable=ML006 queue-wait timestamp — lands in the serve event record
                 staleness_ms)
        # closed-check + enqueue + worker-ensure are ONE atomic step vs
        # close(): no future can be stranded in a dead queue
        with self._lock:
            if self._closed:
                raise PipelineClosed(
                    "submit after close(): the admission worker is "
                    "stopped — build a new session (or pipeline) to "
                    "serve again")
            if self._ranked:
                self._ensure_worker()
                self._admit_ranked(
                    (*entry, next(self._seq), ranklog.rank_key(expr)),
                    tenant)
                return fut
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

    def _admit_ranked(self, entry, tenant: Optional[str]) -> None:
        """A rank mesh's enqueue: a follower files the entry under its
        sequence number; the lead admits it, and a shed it decides
        (brownout rung 3, a quota, the global bound) rides the next
        record instead of raising here."""
        if self._store is not None:
            self._store.put(entry)
            return
        ctl = self._brownout
        if (ctl is not None and ctl.rung() >= brownout_lib.SHED_RUNG
                and self._q.lowest_weight_tenant(tenant)):
            self._q.defer(entry, ("shed", "brownout",
                                  self._q.tenant_max or self._q.global_max))
            return
        try:
            self._q.put(entry, tenant or "")
        except AdmissionShed as ex:
            self._q.defer(entry, ("shed", ex.scope, ex.queue_max))

    def owns_thread(self) -> bool:
        """Is the caller this pipeline's worker thread?"""
        return threading.current_thread() is self._worker

    def drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted query is dispatched AND every
        dispatched batch has completed on the device. ``timeout``
        (seconds) bounds the whole wait: a wedged worker or batch
        raises the typed ``DrainTimeout``; queue state is untouched."""
        t_abs = (retry_lib.now() + timeout
                 if timeout is not None else None)
        tasks = self._tasks
        with tasks.all_tasks_done:
            while tasks.unfinished_tasks:
                rem = (None if t_abs is None
                       else t_abs - retry_lib.now())
                if rem is not None and rem <= 0:
                    raise DrainTimeout(timeout, tasks.unfinished_tasks)
                tasks.all_tasks_done.wait(rem)
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
            if self._on_ranks:
                self.session.mesh.ranks.unregister_worker(self)
                # the worker leaves within one poll: a rank's process
                # must not reach its teardown with it still running
                if self._worker is not None and not self.owns_thread():
                    self._worker.join(timeout=1.0)

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
                if self._on_ranks:
                    self.session.mesh.ranks.register_worker(self)
                self._stop.clear()
                self._worker = threading.Thread(
                    target=self._run, name="matrel-serve", daemon=True)
                self._worker.start()

    def _run(self) -> None:
        """One decision cycle a loop: the lead pulls a batch, decides
        and publishes the record; a follower waits for entries of its
        own, then for the record and the entries it names. Every rank
        applies the record (on a rank mesh under the world's execution
        lock). After a fleet failover (``_await_stop``) the lead ends
        with a ``{"stop": True}`` record and a follower reads records
        until it."""
        dev = self.session.device
        if dev.type == "cuda":
            # a CUDA context is per thread: launch on the session's card
            torch.cuda.set_device(dev)
        log = self._log
        while True:
            stopping = self._stop.is_set()
            if stopping and (log.lead or not self._await_stop):
                break
            if log.lead:
                deferred = self._q.take_deferred()
                pulled = self._pull(0.0 if deferred else 0.05)
                if not pulled and not deferred:
                    if self._slo is not None:
                        # burn decays as the windows slide: a drained
                        # plane clears its alerts without a query
                        self._slo.tick()
                    continue
                entries = {it[SEQ]: it
                           for it in [d[0] for d in deferred] + pulled}
                rec = log.publish(self._decide(pulled, deferred))
            else:
                if not stopping and not self._store.wait_any(0.05):
                    continue
                rec = log.publish()
                if rec.get("stop"):
                    break
                entries = self._store.take(rec["seqs"],
                                           ranklog.RANK_WAIT_S)
            try:
                with self._cycle():
                    self._apply(rec, entries)
            finally:
                if log.lead:
                    for _ in entries:
                        self._q.task_done()
                else:
                    self._store.done(len(entries))
        if log.lead and self._ranked and self._await_stop:
            log.publish({"stop": True})

    def _cycle(self):
        """The world's execution lock around one cycle (a rank mesh)."""
        return (self.session.mesh.ranks.cycle() if self._on_ranks
                else contextlib.nullcontext())

    def _pull(self, timeout: float) -> list:
        """Up to ``max_batch`` queued entries (none within ``timeout``
        seconds: an empty list)."""
        try:
            pulled = [self._q.get(timeout=timeout)]
        except queue.Empty:
            return []
        while len(pulled) < self.max_batch:
            try:
                pulled.append(self._q.get_nowait())
            except queue.Empty:
                break
        return [self._numbered(it) for it in pulled]

    def _numbered(self, it):
        """An entry in the full layout: a shorter tuple (a white-box
        caller's, or one re-admitted by the one-card fleet) padded with
        the defaults and given the next sequence number."""
        if len(it) > SEQ:
            return it
        if len(it) < 7:
            it = (*it, *_ENTRY_DEFAULTS[len(it) - 3:])
        return (*it[:7], next(self._seq), None)

    def _decide(self, pulled: list, deferred: list) -> dict:
        """The lead's decisions for one cycle, as the record every rank
        applies: sheds and purges it deferred, deadline verdicts on its
        clock, breaker verdicts, the brownout sample and rung, the
        stale serves, and its depths and waits for the overload
        event. Off a rank mesh a future the caller cancelled while
        queued drops out here; on a rank mesh it rides its cycle (the
        other ranks run it) and simply receives nothing."""
        if not self._ranked:
            # RUNNING first: set_result on a cancelled future would
            # raise and kill the worker, stranding every sibling
            pulled = [it for it in pulled
                      if it[1].set_running_or_notify_cancel()]
        t_admit = time.perf_counter()  # matlint: disable=ML006 queue-wait timestamp — lands in the serve event record
        fail = {it[SEQ]: verdict for it, verdict in deferred}
        live, misses = [], 0
        for it in pulled:
            dl = it[4]
            if dl is not None and dl.expired():
                fail[it[SEQ]] = ("deadline", dl.budget_ms, dl.elapsed_ms())
                misses += 1
            else:
                live.append(it)
        admit = []
        if self._breakers is not None:
            kept = []
            for it in live:
                cls = self._breakers.plan_class(it[0])
                try:
                    self._breakers.admit(cls)
                except CircuitOpen as ex:
                    admit.append((it[SEQ], cls, False))
                    fail[it[SEQ]] = ("breaker", ex.plan_class,
                                     ex.retry_after_ms, ex.probes)
                else:
                    admit.append((it[SEQ], cls, True))
                    kept.append(it)
            live = kept
        waits = {it[SEQ]: round((t_admit - it[2]) * 1e3, 3)
                 for it in pulled}
        sample, rung = None, 0
        if self._brownout is not None:
            late, self._late_misses = self._late_misses, 0
            sample = {"depth": self._q.qsize(),
                      "waits_ms": [waits[it[SEQ]] for it in pulled],
                      "misses": misses + late, "admitted": len(live)}
            rung = self._brownout.observe(**sample)
        stale = []
        if (rung >= brownout_lib.STALE_RUNG
                and self.session._rc_enabled()):
            stale = [it[SEQ] for it in live if it[6]
                     and self.session._rc_stale_probe(
                         it[0], it[3], it[6], peek=True) is not None]
        return {"cycle": self._log.cycles,
                "seqs": [it[SEQ] for it, _v in deferred]
                + [it[SEQ] for it in pulled],
                "fail": fail, "admit": admit, "sample": sample,
                "rung": rung, "stale": stale, "waits": waits,
                "depth": self._q.qsize(),
                "tenant_depths": self._q.tenant_depths()}

    def _facts(self, rec: dict, entries: dict, run: list) -> dict:
        """What this rank holds for ``rec``: per sequence number its
        presence, rank key, result-cache pattern (entries that run) and
        stale entry (stale serves) — what the ranks compare before any
        collective."""
        sess = self.session
        facts = {s: [s in entries, entries[s][KEY] if s in entries
                     else None, None, None] for s in rec["seqs"]}
        for it in run:
            facts[it[SEQ]][2] = sess._rc_pattern(it[0], it[3])
        for s in rec["stale"]:
            if s in entries:
                it = entries[s]
                facts[s][3] = sess._rc_stale_probe(
                    it[0], it[3], it[6], peek=True, aged=True) is not None
        return {s: tuple(v) for s, v in facts.items()}

    def _apply(self, rec: dict, entries: dict) -> None:
        """Apply one record on this rank (the lead too): agree, mirror
        the lead's breaker and brownout state, resolve the refused and
        stale-served futures, run the SLA groups in order."""
        log, sess = self._log, self.session
        seqs, fail, rung = rec["seqs"], rec["fail"], rec["rung"]
        stale = [s for s in rec["stale"] if s in entries]
        t_admit = time.perf_counter()  # matlint: disable=ML006 queue-wait timestamp — lands in the serve event record
        if self._ranked:
            for it in entries.values():
                # a cancelled future still rides its cycle (the other
                # ranks run it); it simply receives nothing
                it[1].set_running_or_notify_cancel()
        run = [entries[s] for s in seqs
               if s in entries and s not in fail and s not in stale]
        if rung >= brownout_lib.TIER_RUNG:
            run = [self._downshift(it, rung) for it in run]
        why = (ranklog.divergence(
            log.gather(self._facts(rec, entries, run)), seqs)
            if self._ranked else None)
        if not log.lead:
            if self._breakers is not None:
                for _s, cls, ok in rec["admit"]:
                    self._breakers.follow(cls, ok)
            if rec["sample"] is not None:
                self._late_misses = 0
                self._brownout.observe(**rec["sample"])
        if why is not None:
            ex = RankDivergence(rec["cycle"], why)
            self.divergences += 1
            if self._breakers is not None:
                for _s, cls, ok in rec["admit"]:
                    if ok:
                        self._breakers.record(cls, None)
            for s in seqs:
                if s in entries:
                    _fail(entries[s][1], ex)
                else:
                    self._store.mark_dead(s, ex)
            return
        misses = 0
        for s in seqs:
            v = fail.get(s)
            if v is None:
                continue
            it = entries[s]
            tenant = it[5] or None
            if v[0] == "shed":
                self._q.record_shed(it[5])
                _fail(it[1], AdmissionShed(v[2], tenant=tenant,
                                           scope=v[1]))
            elif v[0] == "purged":
                self._q.note_purged(it[5])
                _fail(it[1], DeadlineExceeded(
                    v[1], v[2], context="queued query (purged)"))
            elif v[0] == "deadline":
                misses += 1
                _fail(it[1], DeadlineExceeded(v[1], v[2],
                                              context="queued query"))
                if self._slo is not None:
                    self._slo.record_miss(tenant)
            else:
                _fail(it[1], CircuitOpen(v[1], v[2], v[3]))
                if self._slo is not None:
                    self._slo.record_shed(tenant)
        self.deadline_misses += misses
        for s in stale:
            # rung 2: a query that DECLARED a staleness tolerance is
            # answered by the stale ghost of a rebind-invalidated entry
            # — exact answer, slightly old catalog; nothing runs
            it = entries[s]
            ent = sess._rc_stale_probe(it[0], it[3], it[6], aged=True)
            if not it[1].done():
                it[1].set_result(self._wrap(
                    ent.result if ent is not None else None))
            if ent is not None and sess._prov is not None:
                sess._prov_capture_stale(
                    it[0], ent, AdmissionQueue.entry_provenance(it))
            if self._slo is not None:
                self._slo.record_ok(it[5] or None,
                                    (time.perf_counter() - it[2]) * 1e3)  # matlint: disable=ML006 SLO resolution-latency sample — lands in the slo plane's sketches and alert records
            self._breaker_done(it[0], None)
        self.stale_served += len(stale)
        tenant_waits: dict = {}
        for s, w in rec["waits"].items():
            tenant_waits.setdefault(entries[s][5] or "", []).append(w)
        groups: "collections.OrderedDict" = collections.OrderedDict()
        for it in run:
            groups.setdefault(it[3], []).append(it)
        try:
            for sla, part in groups.items():
                self._run_group(
                    sla, part, t_admit, depth=0,
                    retries=sess.config.retry_max_attempts, rung=rung)
        finally:
            if self._overload_active:
                # the lead's depths on a rank mesh; the queue's own now
                # off it
                self._emit_overload(
                    rung, tenant_waits, misses, len(stale),
                    depth=rec["depth"] if self._ranked else None,
                    tenant_depths=(rec["tenant_depths"] if self._ranked
                                   else None))

    # -- the fleet on a rank mesh (serve/fleet.py) --------------------------

    def attach_route(self, route) -> None:
        """Serve as a fleet slice's pipeline: answers go through
        ``route``'s hooks, and a shed or purge the lead decides rides
        the next record (on every rank of the slice, typed)."""
        self.route = route
        self._q.deferring = True

    def admit_routed(self, entry) -> None:
        """File one entry the fleet's router placed on this slice, on
        each of the slice's ranks at the router's record: the lead
        admits it (a shed rides the next record), a follower files it
        under its sequence number; the worker starts if need be."""
        with self._lock:
            if self._closed:
                raise PipelineClosed("re-admission after close(): the "
                                     "admission worker is stopped")
            self._admit_ranked(entry, entry[5] or None)
            self._ensure_worker()

    def load(self) -> tuple:
        """(queued entries, busy): the lead's admission queue and
        whether its worker holds entries it has taken (the fleet's
        placement load)."""
        return self._q.load()

    def wedged(self) -> bool:
        """Did the worker die with entries waiting and no stop asked?"""
        with self._lock:
            return (self._worker is not None
                    and not self._worker.is_alive()
                    and not self._stop.is_set()
                    and self._tasks.unfinished_tasks > 0)

    def abandon(self) -> list:
        """A fleet failover on each rank of the slice: close, stop the
        worker, and on the lead take every entry it has not admitted,
        each as ``(entry, verdict)``: a deadline that expired while it
        waited (("deadline", budget ms, elapsed ms), on the lead's
        clock), a shed or purge it had deferred, or None. Entries
        already in a cycle complete normally."""
        with self._lock:
            self._closed = True
            self._await_stop = (self._ranked and self._worker is not None
                                and self._worker.is_alive())
            self._stop.set()
        if not self._log.lead:
            return []
        deferred = self._q.take_deferred()
        for _ in deferred:
            self._q.task_done()
        out = []
        for it, _tenant in self._q.steal_entries():
            dl = it[4]
            out.append((it, ("deadline", dl.budget_ms, dl.elapsed_ms())
                        if dl is not None and dl.expired() else None))
        return deferred + out

    def decide_routed(self, entry) -> dict:
        """The lead's record for one query the fleet routed to this
        pipeline: admitted as a submission is (a brownout rung-3 shed,
        the queue's bounds), then decided as a cycle. The router is the
        worker: this pipeline's own never starts."""
        self._admit_ranked(entry, entry[5] or None)
        deferred = self._q.take_deferred()
        pulled = self._pull(0.0) if not deferred else []
        try:
            return self._decide(pulled, deferred)
        finally:
            for _ in range(len(pulled) + len(deferred)):
                self._q.task_done()

    def apply_routed(self, rec: dict, entry) -> None:
        """Apply :meth:`decide_routed`'s record on this rank (every rank
        of the world, inside the router's cycle)."""
        self._apply(rec, {entry[SEQ]: entry})

    def _wrap(self, out):
        return self.route.wrap(out) if self.route is not None else out

    def _agree_group(self, batch: list, outs, ex):
        """One group's outcome, agreed over the ranks: (error or None,
        transient, late sequence numbers, latencies in ms, the lead's
        route info). A failure is the first failing rank's error, the
        same typed error on every rank (a rank keeps its own instance when it
        is of that class); the retry decision is the failing ranks' own
        classification. After a success the lead judges late deadlines
        and latencies on its clock once every rank has finished."""
        log = self._log
        mine = {"err": None if ex is None else ranklog.error_record(ex),
                "info": (self.route.info(batch, outs)
                         if self.route is not None and ex is None
                         else None)}
        got = log.gather(mine)
        bad = [g["err"] for g in got if g["err"] is not None]
        if bad:
            agreed = ranklog.rebuild_error(bad[0])
            if ex is not None and type(ex) is type(agreed) \
                    and mine["err"]["text"] == bad[0]["text"]:
                agreed = ex
            elif ex is not None:
                agreed.__cause__ = ex
            return (agreed, all(b["transient"] for b in bad), None, None,
                    None)
        info = got[0]["info"]
        if not (any(it[4] is not None for it in batch)
                or self._slo is not None):
            return None, False, set(), None, info
        verdict = None
        if log.lead:
            t = time.perf_counter()  # matlint: disable=ML006 the lead's queue-wait verdict — broadcast in the cycle's record, lands in the serve event record
            verdict = ([it[SEQ] for it in batch
                        if it[4] is not None and it[4].expired()],
                       {it[SEQ]: (t - it[2]) * 1e3 for it in batch})
        late, lat = log.broadcast(verdict)
        return None, False, set(late), lat, info

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
        return (e, it[1], it[2], "fast", it[4], it[5], it[6], *it[7:])

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
                       misses: int, stale_served: int,
                       depth: Optional[int] = None,
                       tenant_depths: Optional[dict] = None) -> None:
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
                "queue_depth": (self._q.qsize() if depth is None
                                else depth),
                "tenant_depths": (self._q.tenant_depths()
                                  if tenant_depths is None
                                  else tenant_depths),
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

    def _run_many(self, sla: str, batch: list, depth: int,
                  waits_ms: list, rung: int) -> list:
        sess = self.session
        # worker-thread tracer activation: the admission span is the
        # serve trail's root; run_many's spans link under it
        with trace_lib.activate(sess._tracer), trace_lib.span(
                "serve.admit", batch=len(batch),
                inflight=len(self._inflight), bisect_depth=depth,
                max_wait_ms=max(waits_ms) if waits_ms else 0.0):
            return sess.run_many(
                [it[0] for it in batch], precision=sla,
                _queue_wait_ms=waits_ms,
                _inflight_depth=len(self._inflight),
                _tenants=[it[5] for it in batch],
                _brownout_rung=rung or None)

    def _run_group(self, sla: str, batch: list, t_admit: float,
                   depth: int, retries: int = 0, rung: int = 0) -> None:
        """Run one same-SLA sub-batch through ``session.run_many`` and
        resolve its futures. A failing batch bisects; a single query
        failing transient re-admits up to ``retries`` times."""
        if not batch:
            return
        waits_ms = [round((t_admit - it[2]) * 1e3, 3) for it in batch]
        sess = self.session
        ex = late = lat = info = None
        outs = [None] * len(batch)
        try:
            # fault site "serve_admit" INSIDE the try: an injected
            # admission fault takes the bisection/re-admission path
            # (checked on every rank, so it fires on every rank)
            faults_lib.check("serve_admit", sess.config)
            outs = self._run_many(sla, batch, depth, waits_ms, rung)
        except Exception as e:  # noqa: BLE001 — bisect, re-admit or
            # fail the lone future; the worker survives either way
            ex = e
        if self._ranked:
            ex, transient, late, lat, info = self._agree_group(
                batch, outs, ex)
        else:
            transient = ex is not None and is_transient(ex)
            if ex is None and self.route is not None:
                late = {it[SEQ] for it in batch
                        if it[4] is not None and it[4].expired()}
                info = self.route.info(batch, outs)
        if ex is not None:
            if depth == 0:
                # the post-mortem trail of a failed serve batch (no-op
                # with the flight recorder off)
                sess._flight_auto_dump(ex, reason="serve_batch_failure")
            if len(batch) == 1:
                if retries > 0 and transient:
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
        done = Dispatched(outs, _record_event(sess.device))
        if self.route is not None:
            # before the futures resolve: the fleet reports each answer
            # with what the slice's ranks cached of it
            self.route.served(batch, info, late)
        for it, out in zip(batch, outs):
            fut, dl = it[1], it[4]
            if (it[SEQ] in late if late is not None
                    else dl is not None and dl.expired()):
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
                    fut.set_result(self._wrap(out))
                if self._slo is not None:
                    # resolution latency = enqueue → dispatched, the
                    # serve plane's own clock (host; no device sync;
                    # the lead's on a rank mesh)
                    self._slo.record_ok(
                        it[5] or None,
                        lat[it[SEQ]] if lat is not None
                        else (time.perf_counter() - it[2]) * 1e3)  # matlint: disable=ML006 SLO resolution-latency sample — lands in the slo plane's sketches and alert records
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
