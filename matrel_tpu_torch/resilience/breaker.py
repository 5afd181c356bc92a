"""Per-plan-class circuit breakers — fail fast when retrying stopped
helping; the counterpart of ``matrel_tpu/resilience/breaker.py``.

The retry ladder (``resilience/retry.py`` + ``degrade.py``) is the right
answer to a TRANSIENT fault; it is the wrong answer to a POISONED plan
class — a shape/kind whose every execution fails burns its full retry
budget (backoff sleeps included) on every query, and under load that
budget is stolen from the healthy classes queued behind it. The
breaker closes that hole: per plan class (the drift auditor's
``kind:shape-class`` key, so a poisoned 8k matmul class never shades
the healthy 512 class) it counts TERMINAL failures — failures that
already exhausted the retry budget — and past
``config.breaker_threshold`` consecutive ones it OPENS: further
queries of the class fail immediately with the typed
:class:`errors.CircuitOpen` carrying the half-open probe schedule.

State machine (the classic three states, transitions test-pinned)::

    closed ──(threshold consecutive terminal failures)──> open
    open   ──(cooldown_ms elapsed, next admit)──────────> half_open
    half_open admits `breaker_half_open_probes` probes:
        probe success ──> closed   (failure count reset)
        probe failure ──> open     (cooldown restarts)

Deadline expiries, admission sheds, cancellations and ``CircuitOpen``
itself never count as class failures (:func:`counts_as_failure`) — a
starved query says nothing about whether its PLAN is poisoned. A probe
whose outcome is such a non-counting error releases its probe slot
without a transition (``record(cls, None)``).

The OFF contract is structural: ``BreakerRegistry.from_config``
returns None for ``breaker_threshold == 0`` (the default) and no
breaker object is ever constructed (poisoned-init test, the
fault-injector precedent). ``clock`` is injectable so transition tests
are deterministic.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

from matrel_tpu_torch.resilience.errors import (AdmissionShed, CircuitOpen,
                                          DeadlineExceeded,
                                          DrainTimeout, PipelineClosed,
                                          QueryAborted)
from matrel_tpu_torch.resilience.retry import now
from matrel_tpu_torch.utils import lockdep

#: Failure types that say nothing about the PLAN CLASS: starvation,
#: backpressure and cancellation outcomes never trip a breaker.
_NON_CLASS_FAILURES = (DeadlineExceeded, AdmissionShed, QueryAborted,
                       PipelineClosed, DrainTimeout, CircuitOpen)

STATES = ("closed", "open", "half_open")


def counts_as_failure(exc: BaseException) -> bool:
    """True when a terminal failure should count against the plan
    class (everything except the starvation/backpressure taxonomy —
    injected faults DO count: they model exactly the poisoned-class
    failures the breaker exists for)."""
    return not isinstance(exc, _NON_CLASS_FAILURES)


def plan_class(expr) -> str:
    """The breaker's class key: root kind + the drift auditor's
    pow2 shape-class bucket (obs/drift.shape_class), so breaker state
    joins the same per-class vocabulary calibration rows use."""
    from matrel_tpu_torch.obs.drift import shape_class
    try:
        dims = tuple(int(d) for d in (expr.shape or ()))
    except (TypeError, ValueError):
        dims = ()
    return f"{expr.kind}:{shape_class(dims)}"


class CircuitBreaker:
    """One plan class's breaker. NOT thread-safe on its own — the
    registry's lock covers every transition."""

    __slots__ = ("plan_class", "threshold", "cooldown_s", "probes",
                 "_clock", "state", "failures", "_open_until",
                 "_probes_out", "transitions")

    def __init__(self, plan_cls: str, threshold: int,
                 cooldown_ms: float, probes: int,
                 clock: Callable[[], float]):
        self.plan_class = plan_cls
        self.threshold = int(threshold)
        self.cooldown_s = float(cooldown_ms) / 1e3
        self.probes = int(probes)
        self._clock = clock
        self.state = "closed"
        self.failures = 0          # consecutive terminal failures
        self._open_until = 0.0
        self._probes_out = 0
        self.transitions = {"open": 0, "half_open": 0, "close": 0}

    def admit(self) -> None:
        """Gate one query of this class: closed passes, open fails
        fast (typed, with the probe schedule), half-open passes up to
        the probe budget. An open breaker whose cooldown elapsed
        transitions to half-open HERE — the next query IS the probe."""
        if self.state == "closed":
            return
        t = self._clock()
        if self.state == "open":
            if t < self._open_until:
                raise CircuitOpen(self.plan_class,
                                  (self._open_until - t) * 1e3,
                                  self.probes)
            self.state = "half_open"
            self._probes_out = 0
            self.transitions["half_open"] += 1
        # half_open: admit up to the probe budget, fail the rest fast
        if self._probes_out < self.probes:
            self._probes_out += 1
            return
        raise CircuitOpen(self.plan_class, self.cooldown_s * 1e3,
                          self.probes)

    def follow(self, admitted: bool) -> None:
        """Mirror the lead rank's admission verdict (a rank mesh,
        ``serve/ranklog.py``): the state moves exactly as :meth:`admit`
        moved it on the lead, without reading this rank's clock."""
        if not admitted or self.state == "closed":
            return
        if self.state == "open":
            self.state = "half_open"
            self._probes_out = 0
            self.transitions["half_open"] += 1
        self._probes_out += 1

    def record(self, ok: Optional[bool]) -> None:
        """One admitted query's terminal outcome. ``None`` = the
        outcome says nothing about the class (deadline/shed/abort):
        release the probe slot, no transition."""
        if ok is None:
            if self.state == "half_open" and self._probes_out > 0:
                self._probes_out -= 1
            return
        if ok:
            if self.state == "half_open":
                self.state = "closed"
                self.transitions["close"] += 1
                self._probes_out = 0
            self.failures = 0
            return
        if self.state == "half_open":
            self._trip()           # probe failure: cooldown restarts
            return
        self.failures += 1
        if self.state == "closed" and self.failures >= self.threshold:
            self._trip()

    def _trip(self) -> None:
        self.state = "open"
        self._open_until = self._clock() + self.cooldown_s
        self._probes_out = 0
        self.transitions["open"] += 1

    def snapshot(self) -> dict:
        return {"class": self.plan_class, "state": self.state,
                "failures": self.failures,
                "transitions": dict(self.transitions)}


class BreakerRegistry:
    """Thread-safe plan-class → breaker map (session-owned; the serve
    worker and the caller's thread share one view of class health).
    Breakers are created lazily on first admit, all in the closed
    state — an all-healthy session holds one dict and nothing else."""

    def __init__(self, threshold: int, cooldown_ms: float,
                 probes: int,
                 clock: Optional[Callable[[], float]] = None):
        self.threshold = int(threshold)
        self.cooldown_ms = float(cooldown_ms)
        self.probes = int(probes)
        self._clock = clock if clock is not None else now
        self._lock = lockdep.make_lock("resilience.breaker")
        self._by_class: Dict[str, CircuitBreaker] = {}

    @staticmethod
    def from_config(config, clock: Optional[Callable[[], float]] = None
                    ) -> Optional["BreakerRegistry"]:
        """None for the default config (breaker_threshold 0): the OFF
        path constructs nothing — the faults.check precedent."""
        if getattr(config, "breaker_threshold", 0) <= 0:
            return None
        return BreakerRegistry(config.breaker_threshold,
                               config.breaker_cooldown_ms,
                               config.breaker_half_open_probes,
                               clock=clock)

    plan_class = staticmethod(plan_class)

    def _get(self, plan_cls: str) -> CircuitBreaker:
        br = self._by_class.get(plan_cls)
        if br is None:
            br = self._by_class[plan_cls] = CircuitBreaker(
                plan_cls, self.threshold, self.cooldown_ms,
                self.probes, self._clock)
        return br

    def admit(self, plan_cls: str) -> None:
        with self._lock:
            self._get(plan_cls).admit()

    def follow(self, plan_cls: str, admitted: bool) -> None:
        """Apply the lead rank's verdict for one entry (see
        :meth:`CircuitBreaker.follow`)."""
        with self._lock:
            self._get(plan_cls).follow(admitted)

    def record(self, plan_cls: str, ok: Optional[bool]) -> None:
        with self._lock:
            self._get(plan_cls).record(ok)

    def state(self, plan_cls: str) -> str:
        with self._lock:
            br = self._by_class.get(plan_cls)
            return br.state if br is not None else "closed"

    def snapshot(self) -> dict:
        """Obs-facing view: which classes are open/half-open now, plus
        CUMULATIVE transition counts (the overload event emitter turns
        these into per-cycle deltas)."""
        with self._lock:
            trans = {"open": 0, "half_open": 0, "close": 0}
            open_now, half_now = [], []
            for cls, br in self._by_class.items():
                for k in trans:
                    trans[k] += br.transitions[k]
                if br.state == "open":
                    open_now.append(cls)
                elif br.state == "half_open":
                    half_now.append(cls)
            return {"classes": len(self._by_class),
                    "open": sorted(open_now),
                    "half_open": sorted(half_now),
                    "transitions": trans}
