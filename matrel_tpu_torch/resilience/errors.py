"""Typed error taxonomy of the serve plane — the counterpart of
``matrel_tpu/resilience/errors.py``.

The single authority for "is this failure worth retrying?":

- **transient** failures (device/runtime hiccups: out of memory, a
  collective timeout, injected transients from the fault harness) are
  retry candidates — re-running the same work can succeed;
- **deterministic** failures (compile/shape/type errors, verification
  errors, injected fatals, a kernel that fails to build or launch)
  would fail identically on every attempt; the retry policy re-raises
  them at once, so the degradation ladder never climbs around them.

Every resilience-surface error is typed: callers catch
``DeadlineExceeded``/``DrainTimeout``/``AdmissionShed``/
``PipelineClosed`` by class. The classes, their messages and the
classification are the JAX package's, with the device runtime's failure
vocabulary replaced by the CUDA runtime's: out of memory is the only
transient runtime error that was not injected.
"""

from __future__ import annotations

from typing import Optional


class ResilienceError(Exception):
    """Base for every typed error the resilience layer raises itself
    (deadlines, sheds, closed pipelines). External failures — device
    runtime errors, verification errors — keep their own types and are
    CLASSIFIED by :func:`classify` instead."""


class InjectedFault(ResilienceError):
    """A fault the seeded injection harness raised at an instrumented
    choke point (``resilience/faults.py``). ``transient`` drives the
    retry classification: transient injections model device hiccups
    and ARE retried (each retry climbing one rung of the degradation
    ladder); fatal ones model deterministic poison and are not."""

    def __init__(self, site: str, kind: str, call_index: int,
                 rule: Optional[str] = None):
        self.site = site
        self.kind = kind
        self.transient = kind == "transient"
        self.call_index = call_index
        self.rule = rule
        super().__init__(
            f"injected {kind} fault at site {site!r} "
            f"(call #{call_index}"
            + (f", rule {rule!r}" if rule else "") + ")")


class DeadlineExceeded(ResilienceError, TimeoutError):
    """A query's per-query deadline expired before it produced a
    result — raised at admission, between retry attempts, or when a
    backoff sleep would overshoot the deadline. Never retried."""

    def __init__(self, deadline_ms: float, elapsed_ms: float,
                 context: str = "query"):
        self.deadline_ms = deadline_ms
        self.elapsed_ms = elapsed_ms
        super().__init__(
            f"{context} deadline of {deadline_ms:.0f} ms exceeded "
            f"({elapsed_ms:.0f} ms elapsed)")


class QueryAborted(ResilienceError):
    """The caller cancelled (or the pipeline stopped) BETWEEN retry
    attempts — the sanctioned cancellation point: a running device
    dispatch cannot be interrupted, but the retry loop checks its
    abort hook before every new attempt."""


class DrainTimeout(ResilienceError, TimeoutError):
    """``session.serve_drain(timeout=...)`` gave up waiting on a wedged
    admission worker. The queue state is untouched — a later drain
    (or a healthy worker) can still finish the work."""

    def __init__(self, timeout_s: float, pending: int):
        self.timeout_s = timeout_s
        self.pending = pending
        super().__init__(
            f"serve drain timed out after {timeout_s:g} s "
            f"({pending} task(s) still unfinished)")


class PipelineClosed(ResilienceError):
    """``submit`` after ``close()``: the admission worker is stopped,
    so enqueueing would strand the future forever. Typed so callers
    can distinguish "session shut down" from a query failure."""


class AdmissionShed(ResilienceError):
    """Backpressure shed: the bounded admission queue is full (the
    global ``config.serve_queue_max`` bound, or — checked FIRST — this
    tenant's ``config.serve_tenant_queue_max`` quota), or the brownout
    controller's rung-3 tenant shed refused the submission. The
    submission is REFUSED rather than allowed to grow the queue
    without bound — the typed load-shedding contract protecting the
    queries already admitted. ``tenant`` names the shed tenant (None
    for the implicit single tenant); ``scope`` says which bound fired
    ("tenant" quota / "queue" global / "brownout" rung 3)."""

    def __init__(self, queue_max: int, tenant: Optional[str] = None,
                 scope: str = "queue"):
        self.queue_max = queue_max
        self.tenant = tenant
        self.scope = scope
        who = f" (tenant {tenant!r})" if tenant else ""
        if scope == "brownout":
            msg = (f"submission shed{who}: brownout rung 3 sheds "
                   f"lowest-weight tenants under sustained overload — "
                   f"retry later")
        elif scope == "tenant":
            msg = (f"per-tenant admission quota full{who} "
                   f"({queue_max} pending); submission shed — retry "
                   f"later or raise config.serve_tenant_queue_max")
        else:
            msg = (f"serve admission queue full ({queue_max} "
                   f"pending){who}; submission shed — retry later or "
                   f"raise config.serve_queue_max")
        super().__init__(msg)


class FleetSliceLost(ResilienceError):
    """A serving slice died (or was killed) with this query queued on
    it and the fleet could not re-admit it elsewhere: failover is off
    (``config.fleet_failover=False``), no surviving slice exists, or
    the query's leaves could not be rebound onto a survivor's catalog.
    The refusal is typed: the caller knows the answer was never
    computed (``serve/fleet.py``)."""

    def __init__(self, slice_id: int, detail: str = ""):
        self.slice_id = slice_id
        self.detail = detail
        super().__init__(
            f"serving slice {slice_id} lost"
            + (f": {detail}" if detail else "")
            + " — query could not be re-admitted onto a surviving "
              "slice")


class RankDivergence(ResilienceError):
    """The ranks of a rank mesh did not submit the same work
    (``serve/ranklog.py``): a sequence number the lead rank decided on
    never reached another rank's queue within the bound, or reached it
    with another plan key, or a rank's result-cache state would split
    the cycle. Every future of that decision cycle fails with this
    error on EVERY rank, before any rank starts a collective the others
    would not join. Never retried: the programs differ, not the
    hardware."""

    def __init__(self, cycle: int, detail: str = ""):
        self.cycle = cycle
        self.detail = detail
        super().__init__(
            f"ranks diverged at decision cycle {cycle}"
            + (f": {detail}" if detail else "")
            + " — every rank must submit the same queries in the same "
              "order")


class CircuitOpen(ResilienceError):
    """A plan class's circuit breaker is OPEN
    (``resilience/breaker.py``): the class kept failing after the retry
    budget, so further queries of that class fail FAST instead of
    burning compile/retry budget the healthy classes need. Carries the
    half-open probe schedule: ``retry_after_ms`` until the next probe
    window, ``probes`` allowed then. Never retried."""

    def __init__(self, plan_class: str, retry_after_ms: float,
                 probes: int = 1):
        self.plan_class = plan_class
        self.retry_after_ms = retry_after_ms
        self.probes = probes
        super().__init__(
            f"circuit open for plan class {plan_class!r}: the class "
            f"kept failing past its retry budget — fails fast; "
            f"half-open probe window ({probes} probe(s)) in "
            f"{max(retry_after_ms, 0.0):.0f} ms")


class CheckpointCorruption(ResilienceError):
    """A checkpoint artifact failed its stored checksum (or its
    metadata does not parse): the restore refuses to hand back
    silently-corrupt arrays. The caller decides whether an older step
    is acceptable."""


class SnapshotCorruption(CheckpointCorruption):
    """A durable-state artifact (a disk-tier spill entry or a
    ``save_state()`` snapshot member — ``serve/spill.py``) failed its
    stored sha1 or does not parse. Same checksum discipline and the same
    deterministic classification as :class:`CheckpointCorruption`; the
    session's restore catches it and cold-starts with a warning, and a
    disk-tier thaw treats it as a cache miss: the entry drops, the query
    recomputes, the answer is never wrong."""

    def __init__(self, artifact: str, detail: str = ""):
        self.artifact = artifact
        self.detail = detail
        super().__init__(
            f"durable-state artifact {artifact!r} is corrupt"
            + (f": {detail}" if detail else "")
            + " — refusing to thaw silently-corrupt data")


class SnapshotGridMismatch(ResilienceError):
    """A ``save_state()`` snapshot holds cached results as per-rank
    blocks of another rank grid (or whole values where this session's
    mesh holds blocks, or blocks where it holds whole values): a block
    cut for one grid is not a block of another, so the restore refuses
    before it registers anything rather than thaw a wrong block."""

    def __init__(self, saved, current):
        self.saved = saved
        self.current = current
        super().__init__(
            f"snapshot cached results were saved on rank grid {saved} "
            f"(None: one device) and cannot be restored on {current}")


#: Exception type names treated as transient runtime faults: the CUDA
#: allocator's out-of-memory error as torch raises it (``OutOfMemoryError``;
#: a retry after the caching allocator releases blocks can succeed).
#: Matched by NAME so the taxonomy works across versions that move the
#: class. Other CUDA faults (``AcceleratorError``: an illegal address, a
#: device-side assert) are sticky — they poison the context, so a retry
#: cannot succeed — and classify deterministic unless their message
#: carries a marker below.
_TRANSIENT_TYPE_NAMES = frozenset({"OutOfMemoryError"})

#: Message substrings that mark an otherwise-ambiguous runtime error
#: transient: failures a retry can plausibly clear.
_TRANSIENT_MARKERS = ("out of memory", "collective")


def is_transient(exc: BaseException) -> bool:
    """True when a retry of the SAME work can plausibly succeed."""
    if isinstance(exc, InjectedFault):
        return exc.transient
    if isinstance(exc, ResilienceError):
        # deadlines, sheds, closed pipelines, corruption: all
        # deterministic by construction — retrying cannot help
        return False
    name = type(exc).__name__
    if name == "VerificationError":
        # the static verifier's findings are properties of the PLAN —
        # identical on every attempt
        return False
    if name in _TRANSIENT_TYPE_NAMES:
        return True
    if isinstance(exc, (MemoryError,)):
        return True
    if isinstance(exc, (ValueError, TypeError, KeyError,
                        NotImplementedError, AssertionError,
                        AttributeError, IndexError, ZeroDivisionError)):
        # compile/user/shape errors: deterministic
        return False
    msg = str(exc)
    return any(m in msg for m in _TRANSIENT_MARKERS)


def classify(exc: BaseException) -> str:
    """``"transient"`` or ``"deterministic"`` — the retry policy's one
    question. Unknown exception types classify DETERMINISTIC unless
    they carry a transient marker: silently retrying an unknown bug
    class would mask it (and burn deadline) instead of surfacing it."""
    return "transient" if is_transient(exc) else "deterministic"
