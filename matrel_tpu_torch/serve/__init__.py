"""The serving plane — the counterpart of ``matrel_tpu/serve/``.

  result_cache  cross-query materialized-result cache keyed by the
                structural plan key, byte-budgeted LRU, catalog-rebind
                invalidation (``config.result_cache_max_bytes``; 0 = off)
  pipeline      ``session.submit`` → future: micro-batched admission
                into one MultiPlan, dispatch overlapped with the next
                batch's planning, bounded by ``serve_max_inflight``
  admission     per-tenant weighted-fair admission queue with typed
                quota sheds
  mqo           cross-query CSE and plan templates (``cse_enable``)
  ivm           the delta plane behind ``session.register_delta``
  spill         host and disk tiers under the result cache, save_state
                and restore (``spill_enable``, ``state_dir``)
  replan        drift-triggered re-planning (``coeff_replan_enable``)
  fleet         the multi-slice serving fleet (``fleet_slices``) and
  placement     its placement model
  ranklog       the decision log the pipeline and the fleet run on a
                rank mesh: the lead rank decides, every rank applies

The pipeline also carries the brownout controller, the circuit
breakers and the SLO outcome feed (``resilience/``, ``obs/slo.py``).
"""

from matrel_tpu_torch.serve.admission import AdmissionQueue  # noqa: F401
from matrel_tpu_torch.serve.result_cache import (  # noqa: F401
    CacheEntry, ResultCache)
