"""Resilience layer — the counterpart of ``matrel_tpu/resilience/``:
seeded fault injection at the engine's choke points (:mod:`faults`), a
typed transient/deterministic error taxonomy (:mod:`errors`), retry
with exponential backoff + per-query deadlines (:mod:`retry`), the
plan-degradation ladder each retry climbs (:mod:`degrade`), the
adaptive brownout controller (:mod:`brownout`) and per-plan-class
circuit breakers (:mod:`breaker`).

Default config: injects nothing, retries nothing, degrades nothing —
every module here is inert until asked, and constructs no object.
"""

from matrel_tpu_torch.resilience.errors import (AdmissionShed,
                                                CircuitOpen,
                                                DeadlineExceeded,
                                                DrainTimeout,
                                                InjectedFault,
                                                PipelineClosed,
                                                QueryAborted,
                                                RankDivergence,
                                                ResilienceError,
                                                classify, is_transient)
from matrel_tpu_torch.resilience import (breaker, brownout, degrade,
                                         faults, retry)
from matrel_tpu_torch.resilience.breaker import BreakerRegistry
from matrel_tpu_torch.resilience.brownout import LoadController
from matrel_tpu_torch.resilience.retry import Deadline, RetryPolicy

__all__ = [
    "AdmissionShed", "CircuitOpen", "DeadlineExceeded", "DrainTimeout",
    "InjectedFault", "PipelineClosed", "QueryAborted", "RankDivergence",
    "ResilienceError",
    "classify", "is_transient", "Deadline", "RetryPolicy",
    "BreakerRegistry", "LoadController", "breaker", "brownout",
    "degrade", "faults", "retry",
]
