"""MatrelSession — the entry point, counterpart of ``matrel_tpu/session.py``.

The session owns the mesh (one device plus the virtual planning grid),
the config, a named-matrix catalog, the optimize → plan → lower
pipeline, and a compiled-plan cache keyed by expression structure so a
repeated query does not re-plan. The device defaults to "cuda"; without
a card that raises unless the caller asked for "cpu".

The resilience, observability, serving and result-cache planes are not
ported; their knobs are off by default (``NotPortedError`` otherwise),
so ``compute`` is the JAX package's production branch: compile (or hit
the plan cache) and run. ``run_many`` runs a batch as one
:class:`~matrel_tpu_torch.executor.MultiPlan` from the same cache.
``sql``/``explain_sql`` compile the SQL surface (``sql.py``) into the
same IR.

Plan-cache keys are structural; a callable attr (a σ predicate, a ⋈
merge) keys by the ``__matrel_key__`` tag ``sql.py`` attaches (so the
same query text hits), else by a fingerprint of its code, closure,
referenced globals and defaults, and only as a last resort by its
pinned identity (``_fn_token``).
"""

from __future__ import annotations

import hashlib
import logging
import types
from collections import OrderedDict
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from matrel_tpu_torch import executor as executor_lib
from matrel_tpu_torch.config import (MatrelConfig, NotPortedError,
                                     default_config, normalize_sla)
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

    def zeros(self, shape: Tuple[int, int], **kw) -> BlockMatrix:
        return BlockMatrix.zeros(shape, mesh=self.mesh, config=self.config,
                                 **kw)

    def eye(self, n: int, **kw) -> BlockMatrix:
        return BlockMatrix.eye(n, mesh=self.mesh, config=self.config, **kw)

    # -- actions ------------------------------------------------------------

    def compile(self, expr: MatExpr,
                precision: Optional[str] = None
                ) -> executor_lib.CompiledPlan:
        e = as_expr(expr)
        return self._compile_entry(e, sla=self._resolve_sla(precision,
                                                            e))[0]

    def _resolve_sla(self, precision, e: Optional[MatExpr] = None) -> str:
        """A query's precision SLA: the explicit ``precision=`` argument
        beats a SQL ``PRECISION '...'`` clause (stamped out of band by
        ``sql.parse_sql``) beats the session default
        (config.precision_sla)."""
        if precision is not None:
            return normalize_sla(precision)
        sql_sla = getattr(e, "_sql_precision", None) if e is not None \
            else None
        if sql_sla is not None:
            return sql_sla            # parse_sql already normalised
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
        self._cache_insert(key, plan)
        return plan, False, key

    def _cache_insert(self, key: str, plan) -> None:
        """Add a plan, then drop the least-recently-used ones past
        ``config.plan_cache_max_plans`` (the new plan always stays)."""
        self._plan_cache[key] = plan
        while len(self._plan_cache) > max(self.config.plan_cache_max_plans,
                                          1):
            self._plan_cache.popitem(last=False)
            self._plan_cache_evicted += 1

    def _compile_multi_entry(self, roots: List[MatExpr],
                             sla: Optional[str] = None
                             ) -> Tuple[executor_lib.MultiPlan, bool,
                                        List[str]]:
        """(multiplan, cache_hit, per-root keys): the MultiPlan twin of
        :meth:`_compile_entry`, in the same cache. The key is the sorted
        unique root keys under the precision prefix, so a batch
        resubmitted in any order, or with duplicate roots, hits. The
        plan remembers its root-key order (``_root_keys``) so callers map
        outputs back to their own roots."""
        sla = sla if sla is not None else self.config.precision_sla
        keyed, pins = [], []
        for e in roots:
            k, p = _plan_key(e)
            keyed.append(k)
            pins.extend(p)
        uniq: "OrderedDict[str, MatExpr]" = OrderedDict()
        for k, e in zip(keyed, roots):
            uniq.setdefault(k, e)
        skeys = sorted(uniq)
        mkey = ("multi:" + self._axisw_prefix() + _prec_prefix(sla)
                + "||".join(skeys))
        plan = self._plan_cache.get(mkey)
        if plan is not None:
            self._plan_cache.move_to_end(mkey)
            return plan, True, keyed
        plan = executor_lib.compile_exprs([uniq[k] for k in skeys],
                                          self.mesh, self._sla_config(sla))
        plan._cache_pin = (tuple(uniq[k] for k in skeys), pins)
        plan._root_keys = tuple(skeys)
        self._cache_insert(mkey, plan)
        return plan, False, keyed

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
        sla = self._resolve_sla(precision, e)
        return self._compile_entry(e, sla=sla)[0].run()

    def run_many(self, exprs, precision: Optional[str] = None,
                 deadline_ms: Optional[float] = None,
                 tenant: Optional[str] = None,
                 _queue_wait_ms=None,
                 _inflight_depth: int = 0,
                 _tenants=None,
                 _brownout_rung: Optional[int] = None
                 ) -> List[BlockMatrix]:
        """Execute several queries as one batch: a single
        :class:`~matrel_tpu_torch.executor.MultiPlan` (one memo per call,
        so shared subexpressions run once; duplicate roots dedupe on
        their structural key) from the session's plan cache, so a
        recurring batch, in any order, compiles nothing. Results come
        back in input order. ``precision`` is the batch's accuracy SLA.

        ``deadline_ms``, ``tenant`` and the underscore parameters (the
        serve pipeline's channel) belong to the resilience, tenancy and
        serving planes, which are not ported: setting one raises
        ``NotPortedError``."""
        unported = {"deadline_ms": deadline_ms, "tenant": tenant,
                    "_queue_wait_ms": _queue_wait_ms,
                    "_inflight_depth": _inflight_depth or None,
                    "_tenants": _tenants, "_brownout_rung": _brownout_rung}
        for name, v in unported.items():
            if v is not None:
                raise NotPortedError(
                    f"run_many({name}=...): the plane behind this "
                    f"argument is not ported to matrel_tpu_torch yet")
        es = [as_expr(x) for x in exprs]
        if not es:
            return []
        plan, _, keys = self._compile_multi_entry(
            es, sla=self._resolve_sla(precision))
        outs = plan.run()
        pos = {k: j for j, k in enumerate(plan._root_keys)}
        return [outs[pos[k]] for k in keys]

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

    def sql(self, query: str) -> MatExpr:
        """SQL-ish entry point over the registered matrix tables (see
        ``sql.py`` for the grammar); malformed input raises
        ``SqlError``."""
        from matrel_tpu_torch.sql import parse_sql
        return parse_sql(query, self)

    def explain_sql(self, query: str, analyze: bool = False) -> str:
        """Plan text for a SQL query (strategies, join schemes and
        value-join kinds included). ``analyze=True`` (EXPLAIN ANALYZE's
        measured per-op tree) belongs to the observability plane, which
        is not ported: it raises ``NotPortedError``."""
        if analyze:
            raise NotPortedError("explain_sql(analyze=True): the "
                                 "observability plane is not ported to "
                                 "matrel_tpu_torch yet")
        return self.explain(self.sql(query))


def _prec_prefix(sla: str) -> str:
    """Cache-key prefix isolating precision tiers ("default" keeps the
    plain key)."""
    return "" if sla == "default" else f"prec:{sla}|"


def _fn_token(fn, pins: list, seen: frozenset = frozenset()) -> str:
    """Cache-key token for a callable attr. Distinct predicates/merges
    key differently; identical ones (re-created lambdas with the same
    behaviour, or the same SQL text) key alike. Preference order: the
    ``__matrel_key__`` tag sql.py attaches, then a fingerprint of code,
    bound instance, closure cells, referenced globals and defaults, then
    id(). Every object keyed by id() is appended to ``pins``, which the
    session keeps on the cached plan, so its address cannot be reused
    into a false hit."""
    key = getattr(fn, "__matrel_key__", None)
    if key is not None:
        return f"fnkey:{key}"
    code = getattr(fn, "__code__", None)
    if code is None:
        pins.append(fn)
        return f"fnid:{id(fn)}"
    if id(fn) in seen:
        # fn reachable from its own globals or closure: key the
        # back-edge by pinned id to terminate
        pins.append(fn)
        return f"fnrec:{id(fn)}"
    seen = seen | {id(fn)}
    parts = [code.co_code.hex(), repr(code.co_consts), repr(code.co_names)]
    # bound-method instance state is behaviour: Thresh(t).pred with
    # different t share code, closure and globals
    self_obj = getattr(fn, "__self__", None)
    if self_obj is not None:
        parts.append("self:" + _attr_token(self_obj, pins, seen))
    for cell in (getattr(fn, "__closure__", None) or ()):
        try:
            parts.append(_attr_token(cell.cell_contents, pins, seen))
        except ValueError:                 # an empty cell
            pins.append(cell)
            parts.append(f"cell:{id(cell)}")
    # referenced globals are behaviour too (`thr = 0.5; lambda v: v >
    # thr` after `thr = -0.5` must not key alike); names are collected
    # through nested code objects. Modules key by name, scalars and
    # small containers by value, anything else by pinned identity.
    g = getattr(fn, "__globals__", None) or {}
    for name in sorted(_code_names(code)):
        if name in g:
            v = g[name]
            if isinstance(v, types.ModuleType):
                parts.append(f"{name}=mod:{v.__name__}")
            else:
                parts.append(f"{name}=" + _attr_token(v, pins, seen))
    # positional and keyword-only defaults, through _attr_token (a bare
    # repr could collide for objects with a state-free __repr__)
    parts.append(_attr_token(tuple(getattr(fn, "__defaults__", None)
                                   or ()), pins, seen))
    parts.append(_attr_token(getattr(fn, "__kwdefaults__", None) or {},
                             pins, seen))
    digest = hashlib.sha1("|".join(parts).encode()).hexdigest()[:16]
    return f"fncode:{digest}"


def _code_names(code) -> set:
    """co_names of a code object and of every nested code object (inner
    lambdas and genexps share __globals__)."""
    names = set(code.co_names)
    for c in code.co_consts:
        if isinstance(c, types.CodeType):
            names |= _code_names(c)
    return names


#: Containers above this many elements key by identity + length instead
#: of by value, so a plan-cache lookup stays O(1) in their size.
_VALUE_KEY_MAX_ELEMS = 256


def _attr_token(v, pins: list, seen: frozenset = frozenset()) -> str:
    """Encode any attr value into the plan key. Scalars key by value,
    callables through :func:`_fn_token`, containers (tuple/list/dict/
    set) by value — so in-place mutation of a global threshold list is
    re-read at the next query — unless larger than
    ``_VALUE_KEY_MAX_ELEMS`` (pinned identity + length). A container met
    again inside its own walk keys the back-edge by pinned id. Anything
    else keys by pinned identity: it may miss the cache, never share a
    plan between distinct semantics."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return repr(v)
    if callable(v):
        return _fn_token(v, pins, seen)
    if isinstance(v, (tuple, list, dict, set, frozenset)):
        if len(v) > _VALUE_KEY_MAX_ELEMS:
            pins.append(v)
            return f"bigcont:{type(v).__name__}:{id(v)}:len{len(v)}"
        if id(v) in seen:
            pins.append(v)
            return f"cyc:{id(v)}"
        seen = seen | {id(v)}
    if isinstance(v, (tuple, list)):
        return "[" + ",".join(_attr_token(x, pins, seen) for x in v) + "]"
    if isinstance(v, dict):
        try:
            items = sorted(v.items())
        except TypeError:
            items = sorted(v.items(), key=lambda kv: repr(kv[0]))
        return "{" + ",".join(
            _attr_token(k, pins, seen) + ":" + _attr_token(x, pins, seen)
            for k, x in items) + "}"
    if isinstance(v, (set, frozenset)):
        return "{" + ",".join(
            sorted(_attr_token(x, pins, seen) for x in v)) + "}"
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
