"""Drift-triggered re-planning of live cached plans — the counterpart of
``matrel_tpu/serve/replan.py``.

The closing arc of the cost-model loop: the drift auditor calibrates
coefficients from query events (obs/drift.py), the planner ranks by
them (parallel/coeffs.py + choose_strategy_ex), and THIS controller
makes a firing DRIFT rank-order flag fix the plans it indicts instead
of waiting for a human to read ``history --drift``.

Mechanism, per ``config.coeff_replan_interval`` observed queries:

1. ``rank_flags`` over a bounded window of live samples — the same
   flag logic, same ``RANK_FLAG_MARGIN``, as the offline audit.
2. A firing flag on a non-cooling population re-CALIBRATES: the
   window's samples for the flagged (class, backend) populations merge
   into the drift table (``drift.update_table`` — count-weighted, so
   poisoned priors wash out round by round instead of whiplashing).
3. The table rewrite bumps the coefficient EPOCH
   (``parallel/coeffs.epoch``), which the session embeds in every plan
   key as the ``coeffv:<epoch>|`` prefix — so every affected cached
   plan/MultiPlan is invalidated LAZILY: old entries keep serving
   in-flight queries, new lookups miss and recompile under the
   corrected coefficients. In-flight queries never block.
4. A background daemon thread re-WARMS the affected plans proactively
   (``session._replan_warm`` recompiles cached entries whose decisions
   touch the flagged shape classes, from their pinned root exprs) —
   an optimization over the lazy miss, never a correctness surface.
5. One ``replan`` obs event records the round: flags, classes, old →
   new epoch, plans re-warmed.

Hysteresis (the brownout enter/exit + dwell discipline — the "provably
never oscillates" contract the soak battery checks):

- An actioned population enters a COOLDOWN of
  ``coeff_replan_cooldown`` checks, and its window samples are
  dropped: the loop can never re-fire on the stale evidence it just
  acted on — only on fresh samples measured under the NEW plans.
- A flag that exactly REVERSES this controller's own last action on a
  population (model now prefers what measurement preferred then, and
  vice versa) must fire on two consecutive checks before it actions —
  a single noisy window cannot ping-pong a population.

Default-off contract: ``from_config`` returns None unless
``config.coeff_replan_enable`` — zero controller objects, zero
threads, zero new event kinds (``_CONSTRUCTED`` stays 0, the
mqo/lockdep poisoned-init pattern).
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Optional

from matrel_tpu_torch.utils import lockdep

log = logging.getLogger("matrel_tpu_torch.serve")

#: Construction counter — the structural-zero proof hook (the
#: serve/mqo.py pattern): tests assert it stays 0 for default configs.
_CONSTRUCTED = {"count": 0}

#: Bounded sample window (the metrics reservoir discipline): enough
#: for several check intervals of multi-strategy traffic, never
#: unbounded.
REPLAN_WINDOW = 512


def from_config(config, session=None) -> Optional["ReplanController"]:
    """None unless ``coeff_replan_enable`` — the structural-zero
    constructor gate (brownout/breaker/mqo precedent)."""
    if not getattr(config, "coeff_replan_enable", False):
        return None
    return ReplanController(config, session)


class ReplanController:
    """Watches the query event stream and closes the drift loop."""

    def __init__(self, config, session=None):
        _CONSTRUCTED["count"] += 1
        self._config = config
        self._session = session
        self._lock = lockdep.make_lock("serve.replan")
        self._samples: deque = deque(maxlen=REPLAN_WINDOW)
        self._since_check = 0
        # population (class, backend) -> remaining cooldown checks
        self._cooldown: dict = {}
        # population -> (model_prefers, measured_prefers) of the last
        # action — the reversal-detection memory
        self._last_action: dict = {}
        # population -> True when a reversal flag awaits confirmation
        self._pending: dict = {}
        self._worker: Optional[threading.Thread] = None
        self.checks = 0
        self.replans = 0
        #: Round records (the ``replan`` event payloads), newest last —
        #: the in-memory mirror unit tests and ``info()`` read.
        self.events: list = []

    # -- the observe/check loop -----------------------------------------

    def observe(self, query_record: dict) -> None:
        """Feed one query event record (session._emit_query_event calls
        this after emission). Never raises — the loop must never fail
        the query that fed it."""
        try:
            from matrel_tpu_torch.obs import drift
            rec = dict(query_record)
            rec.setdefault("kind", "query")
            with self._lock:
                for s in drift.iter_samples([rec]):
                    self._samples.append(s)
                self._since_check += 1
                due = (self._since_check
                       >= self._config.coeff_replan_interval)
                if due:
                    self._since_check = 0
            if due:
                self.check()
        except Exception:
            log.warning("replan: observe failed", exc_info=True)

    def check(self) -> Optional[dict]:
        """One drift check: fire flags, re-calibrate, bump the epoch,
        kick the background warm. Returns the round record when a
        re-plan actioned, else None."""
        from matrel_tpu_torch.obs import drift
        from matrel_tpu_torch.parallel import coeffs
        self.checks += 1
        with self._lock:
            samples = list(self._samples)
            for key in [k for k, v in self._cooldown.items() if v > 0]:
                self._cooldown[key] -= 1
        flags = drift.rank_flags(samples)
        fire = []
        pending_next: dict = {}
        for fl in flags:
            key = (fl["class"], fl["backend"])
            if self._cooldown.get(key, 0) > 0:
                continue          # hysteresis: fresh samples first
            last = self._last_action.get(key)
            if (last is not None
                    and (fl["model_prefers"], fl["measured_prefers"])
                    == (last[1], last[0])):
                # exact reversal of our own last action: demand it on
                # two consecutive checks (the brownout dwell) before
                # acting — one noisy window cannot ping-pong a
                # population
                if not self._pending.get(key):
                    pending_next[key] = True
                    continue
            if not any(k == key for k, _ in fire):
                fire.append((key, fl))
        self._pending = pending_next
        if not fire:
            return None
        keys = {k for k, _ in fire}
        calib = drift.calibrate(
            [s for s in samples
             if (s["class"], s["backend"]) in keys])
        path = drift.table_path(self._config)
        old_epoch = coeffs.epoch(path)
        try:
            drift.update_table(path, calib)
        except OSError:
            log.warning("replan: calibration table not persisted",
                        exc_info=True)
            return None
        new_epoch = coeffs.epoch(path)
        with self._lock:
            cooldown = self._config.coeff_replan_cooldown
            for key, fl in fire:
                self._cooldown[key] = cooldown
                self._last_action[key] = (fl["model_prefers"],
                                          fl["measured_prefers"])
            # drop the actioned populations' samples: the next check
            # must see evidence measured under the NEW plans only
            kept = [s for s in self._samples
                    if (s["class"], s["backend"]) not in keys]
            self._samples = deque(kept, maxlen=REPLAN_WINDOW)
        self.replans += 1
        classes = sorted({fl["class"] for _, fl in fire})
        record = {
            "round": self.replans,
            "classes": classes,
            "old_epoch": old_epoch,
            "epoch": new_epoch,
            "flags": [{"class": fl["class"], "backend": fl["backend"],
                       "model_prefers": fl["model_prefers"],
                       "measured_prefers": fl["measured_prefers"],
                       "slowdown": fl["slowdown"]}
                      for _, fl in fire],
        }
        self.events.append(record)
        self._spawn_warm(set(classes), record)
        return record

    # -- background warm --------------------------------------------------

    def _spawn_warm(self, classes: set, record: dict) -> None:
        """Re-warm affected cached plans on a daemon thread, then emit
        the round's ``replan`` event (with the warm census attached).
        One warm in flight at a time: a still-running warm means the
        lazy ``coeffv:`` miss already covers correctness — skipping a
        proactive pass costs latency, never answers."""
        session = self._session
        if session is None:
            record["replanned"] = 0
            return
        if self._worker is not None and self._worker.is_alive():
            record["replanned"] = None    # warm skipped, lazy covers
            session._obs_emit("replan", record)
            return

        def warm():
            try:
                census = session._replan_warm(classes)
                record.update(census)
            except Exception:
                log.warning("replan: background warm failed",
                            exc_info=True)
            try:
                session._obs_emit("replan", record)
            except Exception:
                log.warning("replan: event dropped", exc_info=True)

        t = threading.Thread(target=warm, name="matrel-replan",
                             daemon=True)
        self._worker = t
        t.start()

    def drain(self, timeout: float = 30.0) -> None:
        """Join any in-flight background warm (test/soak hook)."""
        t = self._worker
        if t is not None and t.is_alive():
            t.join(timeout)

    def info(self) -> dict:
        """``plan_cache_info``-style surface."""
        with self._lock:
            return {"checks": self.checks, "replans": self.replans,
                    "window": len(self._samples),
                    "cooling": sum(1 for v in self._cooldown.values()
                                   if v > 0)}
