"""Resilience layer of the serve plane — the counterpart of
``matrel_tpu/resilience/`` for its typed error taxonomy
(:mod:`errors`) and its retry / deadline policy (:mod:`retry`).

The fault-injection harness, the plan-degradation ladder, the brownout
controller and the circuit breakers are not ported: their knobs stay
fenced (``config.UNPORTED_KNOBS``), so a retry here re-runs the same
plan (the ladder's rung 0) and no fault is ever injected.

Default config: retries nothing, no deadline — inert until asked.
"""

from matrel_tpu_torch.resilience.errors import (AdmissionShed,
                                                DeadlineExceeded,
                                                DrainTimeout,
                                                PipelineClosed,
                                                QueryAborted,
                                                ResilienceError,
                                                classify, is_transient)
from matrel_tpu_torch.resilience import retry
from matrel_tpu_torch.resilience.retry import Deadline, RetryPolicy

__all__ = [
    "AdmissionShed", "DeadlineExceeded", "DrainTimeout",
    "PipelineClosed", "QueryAborted", "ResilienceError", "classify",
    "is_transient", "Deadline", "RetryPolicy", "retry",
]
