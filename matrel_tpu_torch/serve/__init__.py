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

The pipeline also carries the brownout controller, the circuit
breakers and the SLO outcome feed (``resilience/``, ``obs/slo.py``).
The spill hierarchy (``spill.py``), the fleet (``fleet.py``,
``placement.py``) and the cost-model re-plan controller (``replan.py``)
are not ported: they need the checkpoint plane first (the drift table
and the learned coefficients they read are ported).
"""

from matrel_tpu_torch.serve.admission import AdmissionQueue  # noqa: F401
from matrel_tpu_torch.serve.result_cache import (  # noqa: F401
    CacheEntry, ResultCache)
