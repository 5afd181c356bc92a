"""Adaptive brownout — trade fidelity for admission under sustained
overload, with hysteresis; the counterpart of
``matrel_tpu/resilience/brownout.py``.

The degradation ladder (resilience/degrade.py) answers "this QUERY
keeps failing"; brownout answers "the whole PLANE is saturated". A
load controller sampled once per admission cycle watches three
signals over a sliding window — queue depth, queue-wait p95,
deadline-miss rate — and climbs a cumulative rung ladder when any
signal holds above its ENTER threshold, descending only when every
signal falls below its (strictly lower) EXIT threshold and the dwell
has elapsed, so the ladder cannot flap on one noisy sample:

    rung 0  normal
    rung 1  tier-downshift: default-SLA queries compile under the
            "fast" precision tier (results stay
            SLA-key-isolated — a browned-out result can never answer
            a later full-fidelity query)
    rung 2  + stale-serve: result-cache entries a catalog rebind
            marked STALE may answer queries that declare a
            ``staleness_ms`` tolerance (the query's own contract —
            nothing is served stale to a caller who didn't opt in)
    rung 3  + tenant-shed: lowest-weight tenants shed typed
            (AdmissionShed, scope="brownout") at submit

Every rung is a fidelity trade, never a correctness trade: rung 1
results carry the fast tier's documented error bound, rung 2 results
are exact answers to a slightly-old catalog, rung 3 refusals are
typed. The OFF contract is structural: :func:`from_config` returns
None for ``brownout_enable == False`` (the default) and no controller
object is ever constructed (poisoned-init test, the faults/breaker
precedent). ``clock`` is injectable for deterministic tests.
"""

from __future__ import annotations

from collections import deque
from typing import Optional

from matrel_tpu_torch.obs.metrics import percentile
from matrel_tpu_torch.utils import lockdep

#: The rung vocabulary (cumulative; labels ride obs events and docs).
MAX_RUNG = 3
TIER_RUNG = 1
STALE_RUNG = 2
SHED_RUNG = 3

RUNG_LABELS = {0: "normal", 1: "tier-downshift", 2: "stale-serve",
               3: "tenant-shed"}


def rung_label(rung: int) -> str:
    return RUNG_LABELS.get(rung, f"rung-{rung}")


def downshift_stamp(staleness_ms: Optional[float] = None) -> dict:
    """The brownout stamp a downshifted default-SLA query carries
    (expr root ``attrs["brownout"]``). The stamped
    rung is the rung that AUTHORIZES the stamp's strongest claim —
    TIER_RUNG for a plain tier downshift, STALE_RUNG when a staleness
    tolerance rides along — NOT the controller's instantaneous rung:
    the plan's fidelity change is identical at rung 1 and rung 3, and
    keying it by the live rung would shatter the plan cache into one
    entry per rung for byte-identical programs. The staleness claim
    is the boolean ``stale_ok``, never the caller's raw tolerance
    value — the stamp forms the plan key, and distinct tolerances for
    byte-identical programs would shatter the cache the same way."""
    stamp = {"rung": (STALE_RUNG if staleness_ms else TIER_RUNG),
             "sla": "fast"}
    if staleness_ms:
        stamp["stale_ok"] = True
    return stamp


def from_config(config) -> Optional["LoadController"]:
    """None for the default config: the OFF path constructs nothing
    (the faults.check / BreakerRegistry.from_config precedent)."""
    if not getattr(config, "brownout_enable", False):
        return None
    return LoadController(config)


class LoadController:
    """The admission worker's load sensor + rung ladder. One
    ``observe()`` per admission cycle; ``rung()`` is what the worker
    acts on. Thread-safe (submit-side rung-3 sheds read the rung from
    the caller's thread while the worker observes)."""

    def __init__(self, config):
        self.window = int(config.brownout_window)
        self.dwell = int(config.brownout_dwell)
        self.wait_high = float(config.brownout_wait_high_ms)
        self.wait_low = float(config.brownout_wait_low_ms)
        self.depth_high = int(config.brownout_depth_high)
        self.depth_low = int(config.brownout_depth_low)
        self.miss_high = float(config.brownout_miss_high)
        self.miss_low = float(config.brownout_miss_low)
        self._lock = lockdep.make_lock("resilience.brownout")
        self._waits: deque = deque(maxlen=self.window)
        # per-query outcome bits over the window (1 = missed its
        # deadline, 0 = admitted fine) — the miss-RATE signal
        self._outcomes: deque = deque(maxlen=self.window)
        self._depth = 0
        self._rung = 0
        self._since_change = self.dwell   # first move needs no warmup
        self._samples = 0
        self.entered = 0                  # lifetime rung-up count
        self.exited = 0                   # lifetime rung-down count
        self.max_rung_seen = 0

    # -- sensing -----------------------------------------------------------

    def observe(self, depth: int, waits_ms=(), misses: int = 0,
                admitted: int = 0) -> int:
        """One admission cycle's sample: current queue depth, the
        cycle's queue waits, and its deadline misses vs admitted
        count. Re-evaluates the rung and returns it."""
        with self._lock:
            self._depth = int(depth)
            for w in waits_ms or ():
                self._waits.append(float(w))  # matlint: disable=ML013 bounded sliding window — measurement IS the brownout controller, its p95 reads through obs.metrics.percentile
            for _ in range(max(int(misses), 0)):
                self._outcomes.append(1)
            for _ in range(max(int(admitted), 0)):
                self._outcomes.append(0)
            self._samples += 1
            self._since_change += 1
            self._evaluate()
            return self._rung

    def _p95_wait(self) -> float:
        # the shared quantile definition (obs/metrics.percentile):
        # the threshold this signal is compared against is the same
        # number the SLO plane / endpoint / history report, within the
        # sketch's documented relative error
        est = percentile(self._waits, 0.95)
        return 0.0 if est is None else est

    def _miss_rate(self) -> float:
        if not self._outcomes:
            return 0.0
        return sum(self._outcomes) / len(self._outcomes)

    def _evaluate(self) -> None:
        """The hysteresis core: climb when ANY signal is hot, descend
        only when EVERY signal is cold — with ``dwell`` samples
        between moves. The separated enter/exit thresholds mean a
        signal between low and high HOLDS the current rung (neither
        climbs nor releases it) — that band is the hysteresis."""
        wait = self._p95_wait()
        miss = self._miss_rate()
        hot = (wait > self.wait_high or self._depth > self.depth_high
               or miss > self.miss_high)
        cold = (wait < self.wait_low and self._depth < self.depth_low
                and miss < self.miss_low)
        if self._since_change < self.dwell:
            return
        if hot and self._rung < MAX_RUNG:
            self._rung += 1
            self._since_change = 0
            self.entered += 1
            self.max_rung_seen = max(self.max_rung_seen, self._rung)
        elif cold and self._rung > 0:
            self._rung -= 1
            self._since_change = 0
            self.exited += 1

    # -- acting ------------------------------------------------------------

    def rung(self) -> int:
        with self._lock:
            return self._rung

    def snapshot(self) -> dict:
        """Obs-facing view (rides ``overload`` events)."""
        with self._lock:
            return {"rung": self._rung,
                    "rung_label": rung_label(self._rung),
                    "wait_p95_ms": round(self._p95_wait(), 3),
                    "queue_depth": self._depth,
                    "miss_rate": round(self._miss_rate(), 4),
                    "samples": self._samples,
                    "entered": self.entered,
                    "exited": self.exited,
                    "max_rung_seen": self.max_rung_seen}
