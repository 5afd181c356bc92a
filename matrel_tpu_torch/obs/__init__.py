"""Query-lifecycle observability — the counterpart of ``matrel_tpu/obs/``
(the Spark UI / SparkListener analogue).

- :mod:`~matrel_tpu_torch.obs.metrics` — the process-wide metrics
  registry (counters / gauges / sketch-backed timing histograms) and
  :func:`~matrel_tpu_torch.obs.metrics.percentile`, the one quantile
  definition.
- :mod:`~matrel_tpu_torch.obs.events` — the structured JSONL event log:
  one ``query`` record per run, ``serve`` records per admission, the
  resilience plane's records; readable by the JAX package's reader and
  vice versa.
- :mod:`~matrel_tpu_torch.obs.trace` — parent-linked tracing spans (host
  clock; no span synchronises the device) and the bounded flight
  recorder.
- :mod:`~matrel_tpu_torch.obs.analyze` — ``session.explain(expr,
  analyze=True)``: the physical tree with measured per-op milliseconds
  next to the planner's estimates, and one warm run of the normal plan.
- :mod:`~matrel_tpu_torch.obs.drift` — the cost-model drift auditor's
  calibration table, keyed by the port's own backend ("cuda"/"cpu").
- :mod:`~matrel_tpu_torch.obs.slo` — per-tenant burn-rate SLOs.
- :mod:`~matrel_tpu_torch.obs.export` — the loopback metrics endpoint.
- :mod:`~matrel_tpu_torch.obs.provenance` — the answer provenance ledger
  behind ``session.why``.

Instrumentation is off-hot-path by contract: with ``config.obs_level ==
"off"`` (the default) plus the flight recorder off, the query path takes
zero extra syncs, appends zero events and creates zero span objects.
"""

from matrel_tpu_torch.obs.events import EventLog, SCHEMA_VERSION, read_events
from matrel_tpu_torch.obs.metrics import MetricsRegistry, REGISTRY
from matrel_tpu_torch.obs.trace import (FlightRecorder, Span, Tracer,
                                        chrome_trace, span)

__all__ = [
    "EventLog", "FlightRecorder", "MetricsRegistry", "REGISTRY",
    "SCHEMA_VERSION", "Span", "Tracer", "chrome_trace", "read_events",
    "span",
]
