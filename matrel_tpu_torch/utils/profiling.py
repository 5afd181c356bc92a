"""Tracing / profiling — the counterpart of ``matrel_tpu/utils/profiling.py``.

The JAX package's three calls map to PyTorch's idiom:

- ``trace(dir)``: ``jax.profiler.start_trace``/``stop_trace`` becomes a
  ``torch.profiler.profile`` context (CPU activity, plus CUDA activity
  when a card is present) that writes a Chrome / Perfetto trace,
  ``<dir>/trace.json``, when it exits.
- ``annotate(name)``: ``jax.named_scope`` becomes
  ``torch.profiler.record_function``. The executor wraps every physical
  operator's evaluation in ``annotate(f"matrel.{label}")`` and every
  staged reshard step in ``annotate(f"matrel.reshard:{kind}")``, so a
  profile nests each kernel launch under the operator that made it.
  A JAX scope costs nothing at run time (it exists at trace time); the
  port evaluates its nodes on every run, so with no profiler active
  ``annotate`` returns a shared no-op context (one C call to ask) —
  the default query path opens no range.
- ``StepTimer.step(sync=...)``: ``block_until_ready`` becomes
  ``torch.cuda.synchronize`` on the given tensor's device (nothing on
  the CPU, where a result exists when its op returns).

``StepTimer`` is a view over a :class:`~matrel_tpu_torch.obs.metrics.
MetricsRegistry` (timings record as histograms, ``count`` as counters).
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch

from matrel_tpu_torch.obs.metrics import MetricsRegistry

_NULL = contextlib.nullcontext()


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator["torch.profiler.profile"]:
    """Profile the block and write ``<log_dir>/trace.json`` (Chrome /
    Perfetto trace format); yields the profiler, whose
    ``key_averages()`` the caller may read."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """A named profiler range around one operator — a
    ``torch.profiler.record_function`` while a profiler records, else
    the shared no-op context."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return torch.profiler.record_function(name)


def device_sync(t: Optional[torch.Tensor]) -> None:
    """Wait for the work that produces ``t`` (a CUDA tensor: its
    device's queue; anything else: nothing to wait for)."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        torch.cuda.synchronize(t.device)


class StepTimer:
    """Per-step wall-clock accounting with explicit device sync, backed
    by a metrics registry (private by default; pass
    :data:`matrel_tpu_torch.obs.metrics.REGISTRY` to aggregate with the
    session's query metrics).

    Usage:
        t = StepTimer()
        with t.step("matmul", sync=out.data):
            out = plan.run()
        print(t.table())
    """

    def __init__(self, registry: Optional[MetricsRegistry] = None):
        self.registry = registry or MetricsRegistry()
        self._steps: list = []      # insertion order for table()
        self._counts: list = []

    @contextlib.contextmanager
    def step(self, name: str, sync: Optional[torch.Tensor] = None):
        t0 = time.perf_counter()
        yield
        if sync is not None:
            device_sync(sync)
        if name not in self._steps:
            self._steps.append(name)
        self.registry.histogram(f"step.{name}").observe(
            time.perf_counter() - t0)

    def count(self, name: str, value: float = 1.0) -> None:
        """Accumulator-style counter."""
        if name not in self._counts:
            self._counts.append(name)
        self.registry.counter(name).inc(value)

    @property
    def counters(self) -> dict:
        """Name → accumulated value."""
        return {n: self.registry.counter(n).value for n in self._counts}

    def table(self) -> str:
        lines = [f"{'step':<28}{'count':>6}{'total_s':>10}{'mean_ms':>10}"]
        for name in self._steps:
            h = self.registry.histogram(f"step.{name}")
            lines.append(f"{name:<28}{h.count:>6}{h.total:>10.3f}"
                         f"{1e3 * h.mean:>10.2f}")
        for name in self._counts:
            v = self.registry.counter(name).value
            lines.append(f"{name:<28}{'-':>6}{v:>10.0f}{'':>10}")
        return "\n".join(lines)
