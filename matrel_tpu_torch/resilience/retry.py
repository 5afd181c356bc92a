"""Retry policy: exponential backoff + jitter, per-query deadlines,
cancellation between attempts — the counterpart of
``matrel_tpu/resilience/retry.py``.

The policy answers three questions for the session's attempt loop
(``session._compute_resilient`` / ``_run_many_resilient``):

- **retry?** — only failures :func:`errors.classify` calls transient,
  and only while attempts remain (``config.retry_max_attempts``);
- **when?** — exponential backoff (``retry_backoff_ms`` ×
  ``retry_backoff_mult``^(attempt-1)) with symmetric jitter seeded per
  (config seed, per-policy nonce): concurrent queries draw distinct
  jitter streams, a pinned nonce reproduces a schedule exactly;
- **until when?** — an absolute per-query deadline (``deadline_ms``
  argument, else ``config.deadline_ms``). Expired before an attempt, or
  a backoff that would overshoot it, raises the typed
  :class:`errors.DeadlineExceeded`; a running device dispatch is never
  interrupted (deadlines are honoured between attempts).

All wall-clock reads of the serve plane live here.
"""

from __future__ import annotations

import itertools
import random
import time
from typing import Callable, Optional

from matrel_tpu_torch.resilience.errors import (DeadlineExceeded,
                                          QueryAborted, classify)

#: Per-policy nonce source: concurrent queries on one seed must NOT
#: share a jitter stream (identical streams would retry in lockstep —
#: the thundering herd jitter exists to break). A fixed nonce pins the
#: stream for tests.
_POLICY_SEQ = itertools.count()


def now() -> float:
    """The resilience layer's one clock (monotonic seconds)."""
    return time.monotonic()


def deadline_left(t_end: Optional[float]) -> Optional[float]:
    """Time left until an absolute :func:`now`-based deadline (None =
    unbounded) — the shared-budget form multi-step drains use so one
    documented timeout bounds the WHOLE call, not each sub-wait."""
    return None if t_end is None else max(t_end - now(), 0.0)


class Deadline:
    """An absolute per-query deadline. ``None``-budget deadlines never
    expire (the common case costs two attribute reads)."""

    __slots__ = ("budget_ms", "t0", "t_abs")

    def __init__(self, budget_ms: Optional[float]):
        self.budget_ms = budget_ms
        self.t0 = now()
        self.t_abs = (self.t0 + budget_ms / 1e3
                      if budget_ms is not None else None)

    def remaining_s(self) -> Optional[float]:
        if self.t_abs is None:
            return None
        return self.t_abs - now()

    def expired(self) -> bool:
        return self.t_abs is not None and now() >= self.t_abs

    def elapsed_ms(self) -> float:
        return (now() - self.t0) * 1e3

    def raise_if_expired(self, context: str = "query") -> None:
        if self.expired():
            raise DeadlineExceeded(self.budget_ms, self.elapsed_ms(),
                                   context=context)


class RetryPolicy:
    """One query's retry/backoff/deadline discipline. Built per
    resilient query (never on the default fast path) from the session
    config plus the per-call ``deadline_ms`` override."""

    def __init__(self, max_attempts: int, backoff_ms: float,
                 backoff_mult: float, jitter: float, seed: int,
                 deadline_ms: Optional[float] = None,
                 nonce: Optional[int] = None):
        self.max_attempts = int(max_attempts)
        self.backoff_ms = float(backoff_ms)
        self.backoff_mult = float(backoff_mult)
        self.jitter = float(jitter)
        self.deadline_ms = deadline_ms
        # seed ⊕ per-policy nonce: reproducible per (seed, nonce), but
        # two concurrent queries never draw the same jitter sequence
        if nonce is None:
            nonce = next(_POLICY_SEQ)
        self._rng = random.Random(f"retry|{seed}|{nonce}")

    @staticmethod
    def from_config(config, deadline_ms: Optional[float] = None
                    ) -> Optional["RetryPolicy"]:
        """The session's gate: None when the config (and call) ask for
        no resilience at all — the fast-path bit-identity contract."""
        dl = deadline_ms if deadline_ms is not None else (
            config.deadline_ms if config.deadline_ms > 0 else None)
        if (not config.fault_inject and config.retry_max_attempts == 0
                and dl is None):
            return None
        return RetryPolicy(config.retry_max_attempts,
                           config.retry_backoff_ms,
                           config.retry_backoff_mult,
                           config.retry_jitter,
                           config.fault_inject_seed,
                           deadline_ms=dl)

    def deadline(self) -> Deadline:
        return Deadline(self.deadline_ms)

    def should_retry(self, exc: BaseException, attempt: int) -> bool:
        """attempt is 0-based (the attempt that just FAILED)."""
        return (attempt < self.max_attempts
                and classify(exc) == "transient")

    def backoff_delay_s(self, attempt: int) -> float:
        """Delay before attempt N (1-based retry index): exponential
        base with symmetric seeded jitter, never negative."""
        base = (self.backoff_ms / 1e3
                * self.backoff_mult ** max(attempt - 1, 0))
        if self.jitter > 0.0:
            base *= 1.0 + self.jitter * (2.0 * self._rng.random() - 1.0)
        return max(base, 0.0)

    def backoff_sleep(self, attempt: int, deadline: Deadline,
                      should_abort: Optional[Callable[[], bool]] = None
                      ) -> float:
        """Sleep the attempt's backoff, honoring deadline and
        cancellation: a sleep that would overshoot the deadline raises
        ``DeadlineExceeded`` NOW (don't burn the caller's budget
        sleeping toward certain failure), and an abort hook flipped
        while waiting raises ``QueryAborted`` — the between-attempts
        cancellation point. Returns the seconds actually slept."""
        delay = self.backoff_delay_s(attempt)
        rem = deadline.remaining_s()
        if rem is not None and delay >= rem:
            raise DeadlineExceeded(deadline.budget_ms,
                                   deadline.elapsed_ms(),
                                   context="retry backoff")
        if should_abort is not None and should_abort():
            raise QueryAborted(
                f"query aborted before retry attempt {attempt}")
        if delay > 0.0:
            time.sleep(delay)
        if should_abort is not None and should_abort():
            raise QueryAborted(
                f"query aborted before retry attempt {attempt}")
        return delay
