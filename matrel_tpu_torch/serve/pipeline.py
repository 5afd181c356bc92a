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

Not ported (their knobs stay fenced): the brownout controller (tier
downshift, stale serving, tenant shed), circuit breakers, the SLO feed,
fault injection, the tracer and the overload/serve obs events. Locks are
plain ``threading`` locks; their JAX-package names are in comments.
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

from matrel_tpu_torch.resilience import retry as retry_lib
from matrel_tpu_torch.resilience.errors import (DeadlineExceeded,
                                                DrainTimeout,
                                                PipelineClosed,
                                                is_transient)
from matrel_tpu_torch.resilience.retry import Deadline
from matrel_tpu_torch.serve.admission import AdmissionQueue

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
        self._q = AdmissionQueue(session.config)
        self._inflight: "collections.deque" = collections.deque()
        self._worker: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._closed = False
        # RLock ("serve.pipeline"): submit() holds it across the
        # closed-check + enqueue + _ensure_worker (which locks again) so
        # a concurrent close() can never interleave between them
        self._lock = threading.RLock()
        self.deadline_misses = 0
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
        ``staleness_ms`` rides the entry as in the JAX package; only
        brownout rung 2 (not ported) would consume it."""
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
            # deadline shed BEFORE compilation
            live = []
            for it in batch:
                dl = it[4]
                if dl is not None and dl.expired():
                    _fail(it[1], DeadlineExceeded(
                        dl.budget_ms, dl.elapsed_ms(),
                        context="queued query"))
                    self.deadline_misses += 1
                else:
                    live.append(it)
            # same-SLA sub-batches, admission order preserved
            groups: "collections.OrderedDict" = collections.OrderedDict()
            for it in live:
                groups.setdefault(it[3], []).append(it)
            try:
                for sla, part in groups.items():
                    self._run_group(
                        sla, part, t_admit, depth=0,
                        retries=self.session.config.retry_max_attempts)
            finally:
                for _ in pulled:
                    self._q.task_done()

    def _run_group(self, sla: str, batch: list, t_admit: float,
                   depth: int, retries: int = 0) -> None:
        """Run one same-SLA sub-batch through ``session.run_many`` and
        resolve its futures. A failing batch bisects; a single query
        failing transient re-admits up to ``retries`` times."""
        if not batch:
            return
        waits_ms = [round((t_admit - it[2]) * 1e3, 3) for it in batch]
        try:
            outs = self.session.run_many(
                [it[0] for it in batch], precision=sla,
                _queue_wait_ms=waits_ms,
                _inflight_depth=len(self._inflight),
                _tenants=[it[5] for it in batch])
            done = Dispatched(outs, _record_event(self.session.device))
        except Exception as ex:  # noqa: BLE001 — bisect, re-admit or
            # fail the lone future; the worker survives either way
            if len(batch) == 1:
                if retries > 0 and is_transient(ex):
                    self._run_group(sla, batch, t_admit, depth + 1,
                                    retries=retries - 1)
                else:
                    _fail(batch[0][1], ex)
                return
            mid = len(batch) // 2
            self._run_group(sla, batch[:mid], t_admit, depth + 1,
                            retries=retries)
            self._run_group(sla, batch[mid:], t_admit, depth + 1,
                            retries=retries)
            return
        self.batches += 1
        for it, out in zip(batch, outs):
            fut, dl = it[1], it[4]
            if dl is not None and dl.expired():
                # the batch finished past this query's deadline: the
                # future resolves typed, never a late answer
                self.deadline_misses += 1
                _fail(fut, DeadlineExceeded(
                    dl.budget_ms, dl.elapsed_ms(),
                    context="served query"))
            elif not fut.done():
                fut.ready_event = done.event
                fut.set_result(out)
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
    try:
        batch.wait()
    except Exception:  # a device-side error surfaces at the consumer's
        # own touch of the result; the pipeline only needed the
        # backpressure
        log.warning("serve: in-flight batch sync failed", exc_info=True)
