"""MatrelSession — the entry point, counterpart of ``matrel_tpu/session.py``.

The session owns the mesh (one device plus the virtual planning grid),
the config, a named-matrix catalog, the optimize → plan → lower
pipeline, and a compiled-plan cache keyed by expression structure so a
repeated query does not re-plan. The device defaults to "cuda"; without
a card that raises unless the caller asked for "cpu".

The resilience, observability, serving and result-cache planes are not
ported; their knobs are off by default (``NotPortedError`` otherwise),
so ``compute`` is the JAX package's production branch: compile (or hit
the plan cache) and run.
"""

from __future__ import annotations

import logging
from collections import OrderedDict
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from matrel_tpu_torch import executor as executor_lib
from matrel_tpu_torch.config import MatrelConfig, default_config, normalize_sla
from matrel_tpu_torch.core import mesh as mesh_lib
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import Mesh
from matrel_tpu_torch.ir.expr import MatExpr, as_expr

log = logging.getLogger("matrel_tpu_torch")

_active: Optional["MatrelSession"] = None

Device = Union[str, torch.device, None]


class MatrelSession:
    """Owns mesh + config + catalog; compiles and runs matrix queries."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 config: Optional[MatrelConfig] = None,
                 device: Device = None):
        self.config = config or default_config()
        if mesh is not None and device is not None \
                and mesh.device != mesh_lib.resolve_device(device):
            raise ValueError(f"mesh is on {mesh.device}, device={device!r}")
        self.mesh = mesh or mesh_lib.make_mesh(
            self.config.mesh_shape, self.config.mesh_axis_names, device)
        self.catalog: dict = {}
        # LRU plan cache, bounded by config.plan_cache_max_plans
        self._plan_cache: "OrderedDict[str, executor_lib.CompiledPlan]" \
            = OrderedDict()
        self._plan_cache_evicted = 0

    @property
    def device(self) -> torch.device:
        return self.mesh.device

    # -- builder (MatfastSession.builder().getOrCreate() analogue) ---------

    class Builder:
        def __init__(self):
            self._cfg = default_config()
            self._mesh = None
            self._device: Device = None
            self._explicit_cfg = False

        def config(self, **kw) -> "MatrelSession.Builder":
            self._cfg = self._cfg.replace(**kw)
            self._explicit_cfg = True
            return self

        def mesh(self, mesh: Mesh) -> "MatrelSession.Builder":
            self._mesh = mesh
            return self

        def device(self, device: Device) -> "MatrelSession.Builder":
            self._device = device
            return self

        def get_or_create(self) -> "MatrelSession":
            global _active
            if _active is None:
                _active = MatrelSession(self._mesh, self._cfg, self._device)
                return _active
            if self._explicit_cfg and self._cfg != _active.config:
                log.warning(
                    "MatrelSession.builder(): a session already exists; "
                    "ignoring the requested config (call reset_session() "
                    "first to rebuild with new settings)")
            if self._mesh is not None and self._mesh != _active.mesh:
                log.warning(
                    "MatrelSession.builder(): a session already exists; "
                    "ignoring the requested mesh (call reset_session() "
                    "first)")
            return _active

    @staticmethod
    def builder() -> "MatrelSession.Builder":
        return MatrelSession.Builder()

    # -- catalog ------------------------------------------------------------

    def register(self, name: str, matrix) -> None:
        self.catalog[name] = matrix

    def table(self, name: str):
        return self.catalog[name]

    # -- constructors bound to this session's mesh/config ------------------

    def from_numpy(self, arr: np.ndarray, **kw) -> BlockMatrix:
        return BlockMatrix.from_numpy(arr, mesh=self.mesh,
                                      config=self.config, **kw)

    def random(self, shape: Tuple[int, int], **kw) -> BlockMatrix:
        return BlockMatrix.random(shape, mesh=self.mesh, config=self.config,
                                  **kw)

    # -- actions ------------------------------------------------------------

    def compile(self, expr: MatExpr,
                precision: Optional[str] = None
                ) -> executor_lib.CompiledPlan:
        e = as_expr(expr)
        return self._compile_entry(e, sla=self._resolve_sla(precision))[0]

    def _resolve_sla(self, precision) -> str:
        """A query's precision SLA: the explicit ``precision=`` argument,
        else the session default (config.precision_sla)."""
        if precision is not None:
            return normalize_sla(precision)
        return self.config.precision_sla

    def _sla_config(self, sla: str) -> MatrelConfig:
        if sla == self.config.precision_sla:
            return self.config
        return self.config.replace(precision_sla=sla)

    def _compile_entry(self, e: MatExpr, sla: Optional[str] = None
                       ) -> Tuple[executor_lib.CompiledPlan, bool, str]:
        """(plan, cache_hit, key)."""
        sla = sla if sla is not None else self.config.precision_sla
        key, pins = _plan_key(e)
        key = self._axisw_prefix() + _prec_prefix(sla) + key
        plan = self._plan_cache.get(key)
        if plan is not None:
            self._plan_cache.move_to_end(key)
            return plan, True, key
        plan = executor_lib.compile_expr(e, self.mesh, self._sla_config(sla))
        # pin every id()-keyed object on the cached plan: a collected
        # object's address can be reused by a later, different object
        plan._cache_pin = (e, pins)
        self._plan_cache[key] = plan
        while len(self._plan_cache) > max(self.config.plan_cache_max_plans,
                                          1):
            self._plan_cache.popitem(last=False)
            self._plan_cache_evicted += 1
        return plan, False, key

    def _axisw_prefix(self) -> str:
        wts = mesh_lib.axis_weights(self.mesh, self.config)
        if wts == (1.0, 1.0):
            return ""
        return f"axisw:{wts[0]:g}x{wts[1]:g}|"

    def plan_cache_info(self) -> dict:
        return {"plans": len(self._plan_cache),
                "evicted": self._plan_cache_evicted}

    def compute(self, expr: MatExpr,
                precision: Optional[str] = None) -> BlockMatrix:
        """Execute one query. ``precision`` is the per-query accuracy SLA
        ("exact"/"high"/"fast"/explicit dtype); None defers to
        ``config.precision_sla``."""
        e = as_expr(expr)
        sla = self._resolve_sla(precision)
        return self._compile_entry(e, sla=sla)[0].run()

    def explain(self, expr: MatExpr, physical: bool = True,
                precision: Optional[str] = None) -> str:
        """Logical and optimized plan text; with ``physical`` the
        expression is compiled (cached), so the optimized section
        carries the chosen matmul strategies."""
        e = as_expr(expr)
        if not physical:
            return e.explain(self.config)
        from matrel_tpu_torch.ir.expr import pretty
        head = "== Logical plan ==\n" + pretty(e)
        return head + "\n" + self.compile(e, precision=precision).explain()


def _prec_prefix(sla: str) -> str:
    """Cache-key prefix isolating precision tiers ("default" keeps the
    plain key)."""
    return "" if sla == "default" else f"prec:{sla}|"


def _attr_token(v, pins: list) -> str:
    """Encode an attr value into the plan key. Scalars and containers
    key by value; anything else (callables included) by identity, pinned
    so its address cannot be recycled into a false hit."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return repr(v)
    if isinstance(v, (tuple, list)):
        return "[" + ",".join(_attr_token(x, pins) for x in v) + "]"
    pins.append(v)
    return f"obj:{type(v).__name__}:{id(v)}"


def _plan_key(e: MatExpr) -> Tuple[str, list]:
    """(key, pins): the structural key of an expression and every object
    it references by id()."""
    parts: List[str] = []
    pins: list = []

    def walk(n: MatExpr):
        if n.kind == "leaf":
            m = n.attrs["matrix"]
            pins.append(m)
            parts.append(f"leaf:{id(m)}:{m.shape}:{m.spec}")
        elif n.kind in ("sparse_leaf", "coo_leaf"):
            # the tile structure / SpMV plan is baked into the plan's
            # runners: the key carries the matrix identity
            m = n.attrs["matrix"]
            pins.append(m)
            parts.append(f"{n.kind}:{id(m)}:{m.shape}")
        else:
            attrs = {k: _attr_token(v, pins)
                     for k, v in sorted(n.attrs.items())}
            parts.append(f"{n.kind}:{n.shape}:{attrs}(")
            for c in n.children:
                walk(c)
            parts.append(")")

    walk(e)
    return "|".join(parts), pins


def get_or_create_session() -> MatrelSession:
    return MatrelSession.builder().get_or_create()


def reset_session() -> None:
    global _active
    _active = None
