"""Per-tenant SLO monitors — multi-window burn-rate alerting; the
counterpart of ``matrel_tpu/obs/slo.py``.

Declarative per-tenant objectives (``config.slo_targets`` — latency
quantile targets and availability) are tracked continuously against
the serve plane's actual outcomes (the admission queue's sheds and
purges, the pipeline's resolutions and deadline misses, the session's
``register_delta`` patch latency), and an alert fires WHILE the burn is
happening.

The alerting scheme is the Google-SRE multi-window burn rate:

- every objective reduces to a BAD-EVENT predicate plus an ERROR
  BUDGET fraction (``p95_ms=50`` → bad means "resolved slower than
  50 ms", budget 5%; ``avail=0.999`` → bad means "shed / deadline
  miss / terminal error", budget 0.1%);
- the **burn rate** of a window is the window's bad fraction divided
  by the budget — 1.0 means the budget is being consumed exactly at
  the sustainable rate, 14.4 (the default threshold) means 2% of a
  30-day budget per hour;
- an alert FIRES when BOTH the fast window (default 1 m) and the slow
  window (default 30 m) exceed ``slo_burn_threshold`` — the fast
  window gives detection latency, the slow window confirms the burn
  is sustained rather than one bad second;
- it CLEARS when the fast window's burn falls below ``slo_burn_exit``
  (< the fire threshold, validated — the separated-thresholds
  hysteresis the brownout controller established). An idle window
  burns nothing, so a drained plane always clears within one fast
  window.

Alert TRANSITIONS (fire and clear, never steady state) are emitted
through the session's funnel as ``alert`` events: they land in the
JSONL event log when ``obs_level`` is on and in the flight-recorder
ring whenever the ring exists — REGARDLESS of ``obs_level``, because
an alert transition is exactly the record a post-mortem needs.

The OFF contract is structural: :func:`from_config` returns None for
an empty ``slo_targets`` (the default) and no monitor, window or
sketch object is ever constructed (poisoned-``__init__`` test, the
brownout/breaker precedent). ``clock`` is injectable for
deterministic tests.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from matrel_tpu_torch.config import parse_slo_targets
from matrel_tpu_torch.obs.metrics import QuantileSketch
from matrel_tpu_torch.utils import lockdep

#: The latency-objective vocabulary → (quantile, budget fraction).
#: ``avail`` is handled separately (its budget comes from the target).
_LATENCY_OBJECTIVES = {"p50_ms": 0.50, "p90_ms": 0.90,
                       "p95_ms": 0.95, "p99_ms": 0.99}

#: The pseudo-tenant ``register_delta`` patch latency reports under —
#: declare e.g. ``ivm:p95_ms=20`` to put the IVM patch path under an
#: objective.
IVM_TENANT = "ivm"


def from_config(config, emit: Optional[Callable] = None,
                clock: Optional[Callable[[], float]] = None
                ) -> Optional["SLOPlane"]:
    """None for the default config: the OFF path constructs nothing
    (the brownout/breaker structural-zero precedent)."""
    if not getattr(config, "slo_targets", ""):
        return None
    return SLOPlane(config, emit=emit, clock=clock)


class _Window:
    """Trailing-time good/bad counter: fixed-width time buckets in a
    bounded deque, expired buckets dropped on read. Bucket width is
    window/20 (clamped to >= 50 ms) — fine enough that the window
    slides smoothly, coarse enough that a sustained overload is a
    handful of buckets, not one entry per event."""

    __slots__ = ("seconds", "width", "_buckets", "_clock")

    def __init__(self, seconds: float, clock: Callable[[], float]):
        self.seconds = float(seconds)
        self.width = max(self.seconds / 20.0, 0.05)
        cap = int(self.seconds / self.width) + 2
        self._buckets: deque = deque(maxlen=cap)   # [idx, good, bad]
        self._clock = clock

    def add(self, good: int = 0, bad: int = 0) -> None:
        idx = int(self._clock() / self.width)
        if self._buckets and self._buckets[-1][0] == idx:
            b = self._buckets[-1]
            b[1] += good
            b[2] += bad
        else:
            self._buckets.append([idx, good, bad])

    def totals(self) -> Tuple[int, int]:
        """(good, bad) over the trailing window, expired dropped."""
        lo = int((self._clock() - self.seconds) / self.width)
        while self._buckets and self._buckets[0][0] <= lo:
            self._buckets.popleft()
        good = sum(b[1] for b in self._buckets)
        bad = sum(b[2] for b in self._buckets)
        return good, bad


class SLOMonitor:
    """One (tenant, objective): two burn-rate windows + the alert
    state machine. Not thread-safe on its own — the plane's lock
    covers it."""

    def __init__(self, tenant: str, objective: str, target: float,
                 config, clock: Callable[[], float]):
        self.tenant = tenant
        self.objective = objective
        self.target = float(target)
        if objective == "avail":
            self.budget = 1.0 - self.target
        else:
            self.budget = 1.0 - _LATENCY_OBJECTIVES[objective]
        self.threshold = float(config.slo_burn_threshold)
        self.exit = float(config.slo_burn_exit)
        self.fast = _Window(config.slo_fast_window_s, clock)
        self.slow = _Window(config.slo_slow_window_s, clock)
        self.firing = False
        self.fired = 0
        self.cleared = 0

    def record(self, good: int = 0, bad: int = 0) -> None:
        self.fast.add(good, bad)
        self.slow.add(good, bad)

    @staticmethod
    def _burn(good: int, bad: int, budget: float) -> float:
        n = good + bad
        if n == 0:
            return 0.0
        return (bad / n) / budget

    def evaluate(self) -> Optional[dict]:
        """Re-evaluate the state machine; returns the transition
        record on a fire/clear edge, None on steady state."""
        gf, bf = self.fast.totals()
        gs, bs = self.slow.totals()
        burn_fast = self._burn(gf, bf, self.budget)
        burn_slow = self._burn(gs, bs, self.budget)
        transition = None
        if (not self.firing and burn_fast >= self.threshold
                and burn_slow >= self.threshold):
            self.firing = True
            self.fired += 1
            transition = "firing"
        elif self.firing and burn_fast < self.exit:
            self.firing = False
            self.cleared += 1
            transition = "clear"
        if transition is None:
            return None
        n_slow = gs + bs
        return {"tenant": self.tenant, "objective": self.objective,
                "target": self.target, "state": transition,
                "burn_fast": round(burn_fast, 3),
                "burn_slow": round(burn_slow, 3),
                "attainment": (round(gs / n_slow, 5) if n_slow
                               else None),
                "window_fast_s": self.fast.seconds,
                "window_slow_s": self.slow.seconds}

    def status(self) -> dict:
        gf, bf = self.fast.totals()
        gs, bs = self.slow.totals()
        n_slow = gs + bs
        return {"target": self.target,
                "state": "firing" if self.firing else "ok",
                "burn_fast": round(self._burn(gf, bf, self.budget), 3),
                "burn_slow": round(self._burn(gs, bs, self.budget), 3),
                "attainment": (round(gs / n_slow, 5) if n_slow
                               else None),
                "fired": self.fired, "cleared": self.cleared}


class SLOPlane:
    """The session's live SLO tracker: monitors per declared (tenant,
    objective), one latency sketch + traffic window per tenant (the
    endpoint's per-tenant p50/p95/p99 and QPS), and the alert emission
    hook. Thread-safe: outcomes arrive from submit-side shed paths,
    the admission worker and ``register_delta`` concurrently.
    Transitions are emitted OUTSIDE the lock — the emit callback does
    I/O (event log, flight ring) and must not serialise recording."""

    def __init__(self, config, emit: Optional[Callable] = None,
                 clock: Optional[Callable[[], float]] = None):
        self.targets = parse_slo_targets(config.slo_targets)
        self.emit = emit
        clk = clock or time.monotonic
        self._lock = lockdep.make_lock("obs.slo")
        self.monitors: Dict[Tuple[str, str], SLOMonitor] = {}
        for tenant, objs in self.targets.items():
            for obj, target in objs.items():
                self.monitors[(tenant, obj)] = SLOMonitor(
                    tenant, obj, target, config, clk)
        # per-tenant read surfaces for the endpoint/`top`: lifetime
        # latency sketch + a fast-window traffic counter (QPS), plus
        # lifetime outcome counters — only for DECLARED tenants, so an
        # undeclared tenant costs nothing per event
        self._latency: Dict[str, QuantileSketch] = {
            t: QuantileSketch() for t in self.targets}
        self._traffic: Dict[str, _Window] = {
            t: _Window(config.slo_fast_window_s, clk)
            for t in self.targets}
        self.counts: Dict[str, dict] = {
            t: {"ok": 0, "shed": 0, "miss": 0, "error": 0}
            for t in self.targets}

    def _key(self, tenant: Optional[str]) -> str:
        return tenant or ""

    # -- write side (the serve plane's outcome feed) -----------------------

    def record_ok(self, tenant: Optional[str],
                  latency_ms: Optional[float] = None) -> None:
        """One successfully served query: good for availability, and
        — when its resolution latency is known — good/bad against
        every latency objective of the tenant."""
        t = self._key(tenant)
        if t not in self.targets:
            return
        out: List[dict] = []
        with self._lock:
            self.counts[t]["ok"] += 1
            self._traffic[t].add(good=1)
            if latency_ms is not None:
                self._latency[t].add(float(latency_ms))
            for (mt, obj), mon in self.monitors.items():
                if mt != t:
                    continue
                if obj == "avail":
                    mon.record(good=1)
                elif latency_ms is not None:
                    if float(latency_ms) <= mon.target:
                        mon.record(good=1)
                    else:
                        mon.record(bad=1)
                tr = mon.evaluate()
                if tr is not None:
                    out.append(tr)
        self._emit(out)

    def record_bad(self, tenant: Optional[str],
                   kind: str = "error") -> None:
        """One refused/failed query (``kind`` in shed/miss/error):
        bad for availability. Latency objectives see nothing — a
        query that never resolved has no latency to judge."""
        t = self._key(tenant)
        if t not in self.targets:
            return
        out: List[dict] = []
        with self._lock:
            self.counts[t][kind] = self.counts[t].get(kind, 0) + 1
            self._traffic[t].add(bad=1)
            for (mt, obj), mon in self.monitors.items():
                if mt == t and obj == "avail":
                    mon.record(bad=1)
                    tr = mon.evaluate()
                    if tr is not None:
                        out.append(tr)
        self._emit(out)

    def record_shed(self, tenant: Optional[str]) -> None:
        self.record_bad(tenant, "shed")

    def record_miss(self, tenant: Optional[str]) -> None:
        self.record_bad(tenant, "miss")

    def observe_latency(self, tenant: Optional[str],
                        latency_ms: float) -> None:
        """A bare latency sample with no availability implication —
        the ``register_delta`` patch-latency feed (pseudo-tenant
        ``ivm``) and any future measurement-only source."""
        t = self._key(tenant)
        if t not in self.targets:
            return
        out: List[dict] = []
        with self._lock:
            self._latency[t].add(float(latency_ms))
            self._traffic[t].add(good=1)
            for (mt, obj), mon in self.monitors.items():
                if mt != t or obj == "avail":
                    continue
                mon.record(good=1 if float(latency_ms) <= mon.target
                           else 0,
                           bad=0 if float(latency_ms) <= mon.target
                           else 1)
                tr = mon.evaluate()
                if tr is not None:
                    out.append(tr)
        self._emit(out)

    def tick(self) -> None:
        """Idle re-evaluation: burn decays as the windows slide, so a
        drained plane must CLEAR without waiting for the next query —
        the admission worker calls this once per empty cycle, and the
        endpoint's snapshot path rides through it too."""
        out: List[dict] = []
        with self._lock:
            for mon in self.monitors.values():
                tr = mon.evaluate()
                if tr is not None:
                    out.append(tr)
        self._emit(out)

    def _emit(self, transitions: List[dict]) -> None:
        if not transitions or self.emit is None:
            return
        active = sum(1 for m in self.monitors.values() if m.firing)
        for tr in transitions:
            tr["active"] = active
            self.emit(tr)

    # -- read side (the endpoint / `top` / overload events) ----------------

    def firing(self) -> List[dict]:
        """Currently-firing (tenant, objective) pairs — evaluated
        fresh, so a drained plane reads clear."""
        self.tick()
        with self._lock:
            return [{"tenant": t, "objective": o,
                     "target": m.target}
                    for (t, o), m in sorted(self.monitors.items())
                    if m.firing]

    def snapshot(self) -> dict:
        """JSON-ready state for the endpoint / ``top`` / the overload
        event's ``slo`` field: per tenant the declared objectives
        (state, burns, attainment), the latency sketch's quantiles,
        fast-window QPS and lifetime outcome counters."""
        self.tick()
        with self._lock:
            tenants: dict = {}
            for t in sorted(self.targets):
                good, bad = self._traffic[t].totals()
                win = self._traffic[t].seconds
                tenants[t] = {
                    "objectives": {
                        o: m.status()
                        for (mt, o), m in sorted(self.monitors.items())
                        if mt == t},
                    "latency_ms": self._latency[t].summary(),
                    "qps": round((good + bad) / win, 3),
                    "shed_rate": (round(bad / (good + bad), 4)
                                  if good + bad else None),
                    "counts": dict(self.counts[t]),
                }
            return {"tenants": tenants,
                    "alerts_active": sum(
                        1 for m in self.monitors.values() if m.firing),
                    "alerts_fired": sum(
                        m.fired for m in self.monitors.values()),
                    "alerts_cleared": sum(
                        m.cleared for m in self.monitors.values())}
