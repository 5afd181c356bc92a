"""MatrelSession — the entry point, counterpart of ``matrel_tpu/session.py``.

The session owns the mesh (one device plus the virtual planning grid),
the config, a named-matrix catalog, the optimize → plan → lower
pipeline, and a compiled-plan cache keyed by expression structure so a
repeated query does not re-plan. The device defaults to "cuda"; without
a card that raises unless the caller asked for "cpu".

The serve plane (``serve/``) rides on top, each piece inert until its
knob asks for it, exactly where the JAX package's sits:

- the cross-query result cache (``result_cache_max_bytes`` > 0):
  ``compute``/``run``/``run_many`` answer a repeated query from it, and
  an interior hit enters planning as a ``result_cache``-stamped leaf; a
  catalog rebind (``register``) invalidates transitively;
- ``submit`` → a future, served by the admission pipeline
  (``serve/pipeline.py``: micro-batches, per-tenant weighted-fair
  admission, deadlines, bisection); ``serve_drain``/``serve_close``;
- per-query deadlines and retries (``deadline_ms``, ``retry_*``;
  ``resilience/``): a retry re-runs the same plan — the degradation
  ladder is not ported;
- cross-query CSE and plan templates (``cse_enable``; ``serve/mqo.py``);
- incremental view maintenance: ``register_delta`` patches dependent
  cached results (``serve/ivm.py``, ``ir/delta.py``).

With every knob at its default ``compute`` is the JAX package's
production branch: compile (or hit the plan cache) and run, plans and
results bit-identical to a session without the serve plane. The
observability, brownout, breaker, fault-injection, fleet and spill
planes are not ported: their knobs raise ``NotPortedError``, and so do
``save_state``/``restore``. ``sql``/``explain_sql`` compile the SQL
surface (``sql.py``) into the same IR.

Plan-cache keys are structural; a callable attr (a σ predicate, a ⋈
merge) keys by the ``__matrel_key__`` tag ``sql.py`` attaches (so the
same query text hits), else by a fingerprint of its code, closure,
referenced globals and defaults, and only as a last resort by its
pinned identity (``_fn_token``).
"""

from __future__ import annotations

import hashlib
import logging
import threading
import types
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from matrel_tpu_torch import executor as executor_lib
from matrel_tpu_torch.config import (MatrelConfig, NotPortedError,
                                     default_config, normalize_sla)
from matrel_tpu_torch.core import mesh as mesh_lib
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import Mesh
from matrel_tpu_torch.ir.expr import MatExpr, as_expr
from matrel_tpu_torch.resilience import retry as retry_lib
from matrel_tpu_torch.resilience.retry import RetryPolicy
from matrel_tpu_torch.serve import mqo as mqo_lib
from matrel_tpu_torch.serve.result_cache import (CacheEntry, ResultCache,
                                                 result_nbytes)

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
        # the serve plane: the result cache (inert until
        # config.result_cache_max_bytes > 0), the submit pipeline (built
        # on the first submit), the multi-query state (cse_enable) and
        # the delta plane (first register_delta; generation 0 = never
        # used, every key keeps its format). The lock ("session.compile")
        # keeps the plan cache consistent when the pipeline's worker and
        # the caller's thread compile concurrently.
        self._result_cache = ResultCache()
        self._serve = None
        self._compile_lock = threading.RLock()
        self._mqo: Optional["mqo_lib.MqoState"] = None
        self._delta_plane = None
        self._delta_gen = 0

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
        old = self.catalog.get(name)
        self.catalog[name] = matrix
        if old is not None and old is not matrix:
            # a catalog REBIND: every cached result computed from the
            # old binding is stale — drop it (dep sets are transitive,
            # so results built from cached intermediates drop too); a
            # no-op while the cache is off or empty
            self._result_cache.invalidate_deps(
                {id(old)}, keep_stale=False,
                stale_max=self.config.result_cache_max_entries,
                stale_max_bytes=self.config.result_cache_max_bytes)

    def table(self, name: str):
        return self.catalog[name]

    def register_delta(self, name: str, delta, kind: str = "auto"
                       ) -> dict:
        """Rebind a catalog name to ``A + ΔA`` and MAINTAIN the cached
        results that depend on it instead of invalidating them
        (incremental view maintenance — ``serve/ivm.py``,
        ``ir/delta.py``).

        ``delta`` is ``(rows, cols[, vals])`` edge arrays or a COOMatrix
        (``kind="coo"``), a ``(U, V)`` pair with ``ΔA = U·Vᵀ``
        (``kind="lowrank"``), or a same-shaped array (``kind="dense"``);
        ``kind="auto"`` disambiguates by shape. Each dependent entry is
        patched where a rule applies and the patch prices below
        recompute (``config.delta_patch_mode``; a measured autotune
        ``ivm|`` winner overrides the estimate); everything else falls
        back to the transitive kill. Patched entries key under
        ``delta:<gen>|``. Returns the maintenance summary."""
        old = self.catalog.get(name)
        if old is None:
            raise KeyError(
                f"register_delta: {name!r} is not a bound catalog "
                f"name — register() it first")
        from matrel_tpu_torch.ir import delta as delta_lib
        d = delta_lib.as_delta(delta, old, kind, self.config)
        with self._compile_lock:
            if self._delta_plane is None:
                from matrel_tpu_torch.serve.ivm import DeltaPlane
                self._delta_plane = DeltaPlane(self)
            return self._delta_plane.apply(name, old, d)

    def save_state(self, directory: Optional[str] = None) -> dict:
        """Snapshot of the session's durable state — the spill plane
        and the checkpoint format it needs are not ported."""
        raise NotPortedError(
            "save_state: the durable spill plane (serve/spill.py, "
            "utils/checkpoint.py) is not ported to matrel_tpu_torch yet")

    def restore(self, directory: Optional[str] = None) -> dict:
        """Warm restart from a :meth:`save_state` snapshot — not
        ported (see :meth:`save_state`)."""
        raise NotPortedError(
            "restore: the durable spill plane (serve/spill.py, "
            "utils/checkpoint.py) is not ported to matrel_tpu_torch yet")

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
        with self._compile_lock:
            plan = self._plan_cache.get(key)
            if plan is not None:
                self._plan_cache.move_to_end(key)
                return plan, True, key
            plan = executor_lib.compile_expr(e, self.mesh,
                                             self._sla_config(sla))
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
        with self._compile_lock:
            plan = self._plan_cache.get(mkey)
            if plan is not None:
                self._plan_cache.move_to_end(mkey)
                return plan, True, keyed
            plan = executor_lib.compile_exprs([uniq[k] for k in skeys],
                                              self.mesh,
                                              self._sla_config(sla))
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

    # -- cross-query result cache (serve/result_cache.py) -------------------

    def _rc_enabled(self) -> bool:
        return self.config.result_cache_max_bytes > 0

    def result_cache_info(self) -> dict:
        """``plan_cache_info``-style surface of the result cache:
        entries, pinned device bytes, hit/miss/interior-hit, eviction,
        invalidation, patch and re-key counts, and the bounds."""
        info = self._result_cache.info()
        info["max_bytes"] = self.config.result_cache_max_bytes
        info["max_entries"] = self.config.result_cache_max_entries
        return info

    def _rc_key_prefix(self, sla: str) -> str:
        """The result-cache key prefix of one query: the delta
        generation's ``delta:<gen>|`` (empty until ``register_delta`` is
        used) then the precision tier's ``prec:<sla>|``."""
        gen = self._delta_gen
        return (("" if not gen else f"delta:{gen}|")
                + _prec_prefix(sla))

    def _rc_admit(self, e: MatExpr, prefix: str = ""):
        """One result-cache admission: (entry-or-None, root key, pins,
        possibly-substituted expr). One structural walk serves the root
        consult and, on a miss, every interior probe. Every consult,
        probe and insertion keys under ``prefix``, so precision tiers
        and delta generations partition the cache."""
        parts, pins, spans = _plan_key_spans(e)
        key = prefix + "|".join(parts)
        ent = self._result_cache.lookup(key)
        if ent is not None:
            return ent, key, pins, e
        return None, key, pins, self._rc_substitute(e, parts, spans,
                                                    prefix)

    def _rc_leaf(self, ent: CacheEntry) -> MatExpr:
        """A cache entry lifted into planning as an already-laid-out
        leaf, stamped ``result_cache`` with what the cache promised
        (layout, dtype at insertion) and the transitive dep ids; a
        patched entry's stamp carries its ``delta`` provenance."""
        from matrel_tpu_torch.ir import expr as expr_mod
        stamp = {
            "key_hash": ent.key_hash,
            "layout": ent.layout,
            "dtype": ent.dtype,
            "deps": sorted(ent.dep_ids),
        }
        if ent.delta_gen:
            stamp["delta"] = {"gen": ent.delta_gen,
                              "rule": ent.delta_rule,
                              "err_bound": ent.err_bound}
        return expr_mod.leaf(ent.result).with_attrs(result_cache=stamp)

    def _rc_substitute(self, e: MatExpr, parts: Optional[list] = None,
                       spans: Optional[dict] = None,
                       prefix: str = "") -> MatExpr:
        """Replace every cached INTERIOR subexpression with its result
        leaf (top-down; a hit stops the descent). ``parts``/``spans``
        come from the admission's one ``_plan_key_spans`` walk, so each
        probe is a slice join."""
        if not e.children:
            return e
        if parts is None or spans is None:
            parts, _pins, spans = _plan_key_spans(e)
        new_children = []
        changed = False
        for c in e.children:
            if not c.children and c.kind in ("leaf", "sparse_leaf",
                                             "coo_leaf"):
                new_children.append(c)
                continue
            s, t = spans[c.uid]
            ent = self._result_cache.probe(prefix + "|".join(parts[s:t]))
            if ent is not None:
                new_children.append(self._rc_leaf(ent))
                changed = True
                continue
            nc = self._rc_substitute(c, parts, spans, prefix)
            changed = changed or (nc is not c)
            new_children.append(nc)
        return e.with_children(tuple(new_children)) if changed else e

    def _rc_deps(self, e: MatExpr) -> frozenset:
        """id() of every SOURCE matrix a query's result depends on:
        plain leaves their matrix, result-cache and CSE leaves their
        recorded transitive dep set."""
        deps: set = set()

        def walk(n: MatExpr):
            if n.kind == "leaf":
                rc = n.attrs.get("result_cache")
                if rc is not None:
                    deps.update(rc["deps"])
                    return
                cse = n.attrs.get("cse")
                if cse is not None:
                    deps.update(cse["deps"])
                    return
                deps.add(id(n.attrs["matrix"]))
                return
            if n.kind in ("sparse_leaf", "coo_leaf"):
                deps.add(id(n.attrs["matrix"]))
                return
            for c in n.children:
                walk(c)

        walk(e)
        return frozenset(deps)

    def _rc_stale_probe(self, e: MatExpr, sla: str,
                        staleness_ms: Optional[float]):
        """The STALE entry for this query iff it declared a
        ``staleness_ms`` tolerance its age fits (the brownout rung-2
        consult; nothing feeds the stale graveyard while brownout is
        not ported, so this finds nothing)."""
        if (not self._rc_enabled() or not staleness_ms
                or staleness_ms <= 0):
            return None
        parts, _pins, _spans = _plan_key_spans(e)
        key = self._rc_key_prefix(sla) + "|".join(parts)
        return self._result_cache.lookup_stale(key, staleness_ms)

    def _rc_insert(self, key: str, pins: list, executed: MatExpr,
                   out: BlockMatrix, orig: Optional[MatExpr] = None,
                   prec: str = "", plan=None) -> None:
        """Cache one executed result under its structural key.
        ``executed`` is the (possibly substituted) tree that ran — its
        leaves name the deps; ``pins`` keep the key's id()-referenced
        objects alive; ``orig`` is the pre-substitution tree the delta
        plane derives patches from; ``plan`` supplies the stamped tier's
        error bound."""
        from matrel_tpu_torch.ir import expr as expr_mod
        from matrel_tpu_torch.parallel import planner
        bound = 0.0
        if plan is not None:
            bound = float(((plan.meta or {}).get("precision") or {})
                          .get("est_rel_err_bound") or 0.0)
        ent = CacheEntry(
            key_hash=hashlib.sha1(key.encode()).hexdigest()[:16],
            result=out,
            pins=tuple(pins),
            dep_ids=self._rc_deps(executed),
            layout=planner._layout_of(expr_mod.leaf(out), self.mesh),
            dtype=_dtype_name(out.dtype),
            nbytes=result_nbytes(out),
            expr=orig if orig is not None else executed,
            prec=prec,
            err_bound=bound,
        )
        self._result_cache.put(key, ent,
                               self.config.result_cache_max_bytes,
                               self.config.result_cache_max_entries)

    # -- multi-query optimization (serve/mqo.py) ----------------------------

    def _cse_on(self) -> bool:
        return bool(self.config.cse_enable)

    def _mqo_state(self) -> "mqo_lib.MqoState":
        if self._mqo is None:
            self._mqo = mqo_lib.MqoState(self.config)
        return self._mqo

    def mqo_info(self) -> dict:
        """Template count, lifetime template hits/inserts and hoist
        counts — all zeros, and no state built, with ``cse_enable``
        off."""
        if self._mqo is None:
            return {"templates": 0, "template_hits": 0,
                    "template_inserts": 0, "cse_hoisted": 0,
                    "cse_batches": 0}
        return self._mqo.info()

    def _tpl_prefix(self, sla: str) -> str:
        """Template keys compose the concrete plan key's isolation
        prefixes, so a fast-SLA template never serves an exact query."""
        return self._axisw_prefix() + _prec_prefix(sla)

    def _template_probe(self, e: MatExpr, sla: str):
        """(plan, concrete key, bindings) when a cached template serves
        this query by rebinding its dense leaves; None when the concrete
        plan is cached, the tree is ineligible, no template matches, or
        one template leaf would face two distinct matrices."""
        prefix = self._tpl_prefix(sla)
        key, _pins = _plan_key(e)
        ckey = prefix + key
        with self._compile_lock:
            if ckey in self._plan_cache:
                return None
            try:
                akey, _tp, leaves = mqo_lib.template_key(e)
            except KeyError:
                return None
            st = self._mqo_state()
            ent = st.get_template(prefix + akey)
            if ent is None or not mqo_lib.rebindable(ent):
                return None
            (ak0, uids), = ent.slots
            if ak0 != akey or len(uids) != len(leaves):
                return None
            bindings: dict = {}
            for u, l in zip(uids, leaves):
                m = l.attrs["matrix"]
                prev = bindings.get(u)
                if prev is not None and prev is not m:
                    return None
                bindings[u] = m
            st.template_hits += 1
            return ent.plan, ckey, bindings

    def _template_insert(self, e: MatExpr, plan, sla: str) -> None:
        """Record a freshly compiled single plan as a rebindable
        template (only when every dense leaf of the program is one the
        abstract key recorded)."""
        try:
            akey, tp, leaves = mqo_lib.template_key(e)
        except KeyError:
            return
        ent = mqo_lib.TemplateEntry(
            plan=plan, slots=((akey, tuple(l.uid for l in leaves)),),
            pins=tuple(tp))
        if not mqo_lib.rebindable(ent):
            return
        with self._compile_lock:
            st = self._mqo_state()
            st.put_template(self._tpl_prefix(sla) + akey, ent)
            st.template_inserts += 1

    def _template_probe_multi(self, roots: List[MatExpr], sla: str):
        """(plan, per-root concrete keys, pos, bindings) when a cached
        MultiPlan template matches this batch modulo dense-leaf
        bindings (roots pair to slots by abstract key)."""
        prefix = self._tpl_prefix(sla)
        keyed = []
        for e in roots:
            k, _p = _plan_key(e)
            keyed.append(k)
        uniq: "OrderedDict[str, MatExpr]" = OrderedDict()
        for k, e in zip(keyed, roots):
            uniq.setdefault(k, e)
        skeys = sorted(uniq)
        mkey = "multi:" + prefix + "||".join(skeys)
        with self._compile_lock:
            if mkey in self._plan_cache:
                return None
            try:
                ab = {}
                for k in skeys:
                    ak, _tp, lv = mqo_lib.template_key(uniq[k])
                    ab[k] = (ak, lv)
            except KeyError:
                return None
            st = self._mqo_state()
            ent = st.get_template(
                "multi:" + prefix
                + "||".join(sorted(ak for ak, _lv in ab.values())))
            if ent is None or not mqo_lib.rebindable(ent):
                return None
            slot_pool: dict = {}
            for s, (ak, _uids) in enumerate(ent.slots):
                slot_pool.setdefault(ak, []).append(s)
            pos: dict = {}
            bindings: dict = {}
            for k in skeys:
                ak, lv = ab[k]
                pool = slot_pool.get(ak)
                if not pool:
                    return None
                s = pool.pop(0)
                uids = ent.slots[s][1]
                if len(uids) != len(lv):
                    return None
                for u, l in zip(uids, lv):
                    m = l.attrs["matrix"]
                    prev = bindings.get(u)
                    if prev is not None and prev is not m:
                        return None
                    bindings[u] = m
                pos[k] = s
            if any(slot_pool.values()):
                return None     # the template has roots this batch lacks
            st.template_hits += len(roots)
            return ent.plan, keyed, pos, bindings

    def _template_insert_multi(self, plan, sla: str) -> None:
        """Record a freshly compiled MultiPlan as a rebindable template
        (its pinned unique roots are in plan-root order)."""
        roots = plan._cache_pin[0]
        try:
            slots = []
            pins: list = []
            for e in roots:
                ak, tp, lv = mqo_lib.template_key(e)
                slots.append((ak, tuple(l.uid for l in lv)))
                pins.extend(tp)
        except KeyError:
            return
        ent = mqo_lib.TemplateEntry(plan=plan, slots=tuple(slots),
                                    pins=tuple(pins))
        if not mqo_lib.rebindable(ent):
            return
        with self._compile_lock:
            st = self._mqo_state()
            st.put_template(
                "multi:" + self._tpl_prefix(sla)
                + "||".join(sorted(ak for ak, _u in slots)), ent)
            st.template_inserts += 1

    def _cse_hoist_batch(self, pend: list, sla: str,
                         rc: bool) -> Tuple[list, int]:
        """Hoist the shared interiors of one pending batch into a
        compute-once MultiPlan, then substitute each result into its
        consumers as an already-laid-out ``cse``-stamped leaf. With the
        result cache on the hoisted results also insert under their
        interior structural keys, so later queries hit them and a
        rebind of any source under a hoist invalidates every consumer.
        Returns (substituted pend, hoist count)."""
        from matrel_tpu_torch.ir import expr as expr_mod
        from matrel_tpu_torch.parallel import planner
        entries = []
        for _i, e in pend:
            parts, _pins, spans = _plan_key_spans(e)
            entries.append((e, parts, spans))
        hoists = mqo_lib.choose_hoists(entries, self.config.cse_min_uses)
        if not hoists:
            return pend, 0
        st = self._mqo_state()
        hexprs = [h.expr for h in hoists]
        bindings = None
        tpl = self._template_probe_multi(hexprs, sla)
        if tpl is not None:
            plan, hkeys, pos, bindings = tpl
        else:
            plan, p_hit, hkeys = self._compile_multi_entry(hexprs, sla=sla)
            pos = {k: j for j, k in enumerate(plan._root_keys)}
            if not p_hit:
                self._template_insert_multi(plan, sla)
        outs = self._arbitrated_run(plan, bindings=bindings)
        rc_prefix = self._rc_key_prefix(sla)
        leaf_of: dict = {}
        for h, hk in zip(hoists, hkeys):
            out = outs[pos[hk]]
            full = rc_prefix + h.key
            stamp = {
                "key_hash": hashlib.sha1(full.encode()).hexdigest()[:16],
                "layout": planner._layout_of(expr_mod.leaf(out),
                                             self.mesh),
                "dtype": _dtype_name(out.dtype),
                "deps": sorted(self._rc_deps(h.expr)),
                "uses": h.uses,
            }
            node = expr_mod.leaf(out).with_attrs(cse=stamp)
            if rc:
                # the interior key is exactly what a later query's
                # _rc_substitute probe computes for a matching subtree
                _k2, p2 = _plan_key(h.expr)
                self._rc_insert(full, p2, h.expr, out, orig=h.expr,
                                prec=_prec_prefix(sla), plan=plan)
            for u in h.uids:
                leaf_of[u] = node
        new_pend = []
        for i, e in pend:
            se = mqo_lib.substitute(e, leaf_of)
            if se is not e:
                st.remember(e, se)
            new_pend.append((i, se))
        st.cse_hoisted += len(hoists)
        st.cse_batches += 1
        return new_pend, len(hoists)

    def _arbitrated_run(self, plan, bindings=None):
        """Run one compiled plan (``bindings`` rebinds dense leaves by
        uid — template hits). The JAX package serialises this under a
        fleet's execution lock; without a fleet it is ``plan.run``."""
        return plan.run(bindings=bindings)

    # -- actions ------------------------------------------------------------

    def compute(self, expr: MatExpr,
                precision: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                tenant: Optional[str] = None) -> BlockMatrix:
        """Execute one query. ``precision`` is the per-query accuracy SLA
        ("exact"/"high"/"fast"/explicit dtype); None defers to a SQL
        PRECISION clause, then ``config.precision_sla``. ``deadline_ms``
        is the per-query deadline (None defers to ``config.deadline_ms``;
        expiry raises the typed ``DeadlineExceeded``). ``tenant`` names
        the query's tenant (admission fairness lives in ``submit``)."""
        e = as_expr(expr)
        sla = self._resolve_sla(precision, e)
        pol = RetryPolicy.from_config(self.config, deadline_ms)
        rc = self._rc_enabled()
        if pol is not None:
            return self._compute_resilient(e, rc, sla, pol)
        if not rc and not self._cse_on():
            # the production path: no cache-key walks beyond the plan
            # cache's own
            return self._arbitrated_run(self._compile_entry(e, sla=sla)[0])
        return self._compute_observed(e, rc, sla)

    # the reference's Dataset actions read as "run the query"
    run = compute

    def _compute_observed(self, e: MatExpr, rc: bool,
                          sla: Optional[str] = None) -> BlockMatrix:
        """compute() past the fast-path gate: result-cache admission,
        the plan-template probe, compile, execute, insert."""
        sla = sla if sla is not None else self.config.precision_sla
        key = pins = None
        orig = e
        if rc:
            ent, key, pins, e = self._rc_admit(e, self._rc_key_prefix(sla))
            if ent is not None:
                return ent.result
        bindings = None
        tpl = self._template_probe(e, sla) if self._cse_on() else None
        if tpl is not None:
            plan, _pkey, bindings = tpl
        else:
            plan, hit, _pkey = self._compile_entry(e, sla=sla)
            if self._cse_on() and not hit:
                self._template_insert(e, plan, sla)
        out = self._arbitrated_run(plan, bindings=bindings)
        if rc:
            self._rc_insert(key, pins, e, out, orig=orig,
                            prec=_prec_prefix(sla), plan=plan)
        return out

    def _compute_resilient(self, e: MatExpr, rc: bool, sla: str,
                           pol: RetryPolicy,
                           should_abort=None) -> BlockMatrix:
        """The attempt loop: run the query; on a TRANSIENT failure
        retry with backoff (the same plan — the degradation ladder is
        not ported). Deterministic failures, exhausted attempts and
        expired deadlines propagate typed; a result delivered past the
        deadline raises too."""
        deadline = pol.deadline()
        attempt = 0
        while True:
            deadline.raise_if_expired()
            try:
                out = self._compute_observed(e, rc, sla)
                deadline.raise_if_expired()
                return out
            except Exception as ex:
                if not pol.should_retry(ex, attempt):
                    raise
                attempt += 1
                pol.backoff_sleep(attempt, deadline,
                                  should_abort=should_abort)

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
        recurring batch, in any order, compiles nothing. With the result
        cache on, whole-query hits never reach the batch and interior
        hits enter planning as leaves; with ``cse_enable`` the batch's
        shared interiors are hoisted and computed once. Results come
        back in input order. ``precision`` is the batch's accuracy SLA;
        ``deadline_ms`` the batch deadline (None defers to
        ``config.deadline_ms``); ``tenant`` tags the batch.

        ``_queue_wait_ms``, ``_inflight_depth`` and ``_tenants`` are the
        serve pipeline's channel into the JAX package's serve events
        (not ported: accepted, unused); ``_brownout_rung`` belongs to
        the brownout plane, which is not ported — setting it raises
        ``NotPortedError``."""
        if _brownout_rung is not None:
            raise NotPortedError(
                "run_many(_brownout_rung=...): the brownout plane is not "
                "ported to matrel_tpu_torch yet")
        es = [as_expr(x) for x in exprs]
        if not es:
            return []
        sla = self._resolve_sla(precision)
        pol = RetryPolicy.from_config(self.config, deadline_ms)
        if pol is not None:
            return self._run_many_resilient(es, sla, pol)
        return self._run_many_observed(es, self._rc_enabled(), sla)

    def _run_many_resilient(self, es, sla: str, pol: RetryPolicy,
                            should_abort=None) -> List[BlockMatrix]:
        """The batch twin of :meth:`_compute_resilient`: the whole
        MultiPlan retries as one unit."""
        deadline = pol.deadline()
        attempt = 0
        while True:
            deadline.raise_if_expired(context="batch")
            try:
                outs = self._run_many_observed(es, self._rc_enabled(), sla)
                deadline.raise_if_expired(context="batch")
                return outs
            except Exception as ex:
                if not pol.should_retry(ex, attempt):
                    raise
                attempt += 1
                pol.backoff_sleep(attempt, deadline,
                                  should_abort=should_abort)

    def _run_many_observed(self, es, rc: bool, sla: str
                           ) -> List[BlockMatrix]:
        results: Dict[int, BlockMatrix] = {}
        rc_meta: dict = {}
        pend: list = []
        for i, e in enumerate(es):
            orig = e
            if rc:
                ent, key, pins, e = self._rc_admit(
                    e, self._rc_key_prefix(sla))
                if ent is not None:
                    results[i] = ent.result
                    continue
                rc_meta[i] = (key, pins, orig)
            pend.append((i, e))
        if pend:
            if self._cse_on() and len(pend) > 1:
                pend, _n = self._cse_hoist_batch(pend, sla, rc)
            bindings = None
            tpl = (self._template_probe_multi([e for _, e in pend], sla)
                   if self._cse_on() else None)
            if tpl is not None:
                plan, keys, pos, bindings = tpl
            else:
                plan, plan_hit, keys = self._compile_multi_entry(
                    [e for _, e in pend], sla=sla)
                pos = {k: j for j, k in enumerate(plan._root_keys)}
                if self._cse_on() and not plan_hit:
                    self._template_insert_multi(plan, sla)
            outs = self._arbitrated_run(plan, bindings=bindings)
            for (i, e), k in zip(pend, keys):
                out = outs[pos[k]]
                results[i] = out
                if rc:
                    key, pins, orig = rc_meta[i]
                    self._rc_insert(key, pins, e, out, orig=orig,
                                    prec=_prec_prefix(sla), plan=plan)
        return [results[i] for i in range(len(es))]

    # -- asynchronous admission (serve/pipeline.py) -------------------------

    def submit(self, expr, precision: Optional[str] = None,
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               staleness_ms: Optional[float] = None):
        """Asynchronous query admission: a ``concurrent.futures.Future``
        resolving to the BlockMatrix once its micro-batch is dispatched
        (``future.ready_event`` is the batch's CUDA event, None on the
        CPU). Same-SLA submissions coalesce into batches of up to
        ``config.serve_max_batch``; ``config.serve_max_inflight`` bounds
        the dispatched-but-unfinished batches. ``deadline_ms`` (None
        defers to ``config.deadline_ms``) fails the future typed
        ``DeadlineExceeded`` when it expires queued or its batch ends
        past it; a closed pipeline raises ``PipelineClosed``, a full
        queue ``AdmissionShed`` (per-tenant quota first). ``tenant``
        names the tenant for weighted-fair admission
        (``config.serve_tenant_weights``). The multi-slice fleet is not
        ported: ``config.fleet_slices`` stays in ``UNPORTED_KNOBS``, so
        no session reaches here with ``fleet_slices >= 1``."""
        e = as_expr(expr)
        if deadline_ms is None and self.config.deadline_ms > 0:
            deadline_ms = self.config.deadline_ms
        sla = self._resolve_sla(precision, e)
        return self._submit_pipeline(e, sla, deadline_ms=deadline_ms,
                                     tenant=tenant,
                                     staleness_ms=staleness_ms)

    def _ensure_serve(self):
        """This session's (lazily built) admission pipeline — built under
        the lock, so two concurrent first submissions build one."""
        if self._serve is None:
            from matrel_tpu_torch.serve.pipeline import ServePipeline
            with self._compile_lock:
                if self._serve is None:
                    self._serve = ServePipeline(self)
        return self._serve

    def _submit_pipeline(self, e: MatExpr, sla: str,
                         deadline_ms: Optional[float] = None,
                         tenant: Optional[str] = None,
                         staleness_ms: Optional[float] = None):
        return self._ensure_serve().submit(e, sla,
                                           deadline_ms=deadline_ms,
                                           tenant=tenant,
                                           staleness_ms=staleness_ms)

    def serve_drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted query is dispatched and every
        dispatched batch has finished on the device. ``timeout``
        (seconds) bounds the wait: a wedged worker raises the typed
        ``DrainTimeout``, the queue untouched."""
        t_end = None if timeout is None else retry_lib.now() + timeout
        if self._serve is not None:
            self._serve.drain(timeout=retry_lib.deadline_left(t_end))

    def serve_close(self, timeout: Optional[float] = None) -> None:
        """Drain, then stop the admission worker; a later ``submit``
        raises the typed ``PipelineClosed``."""
        t_end = None if timeout is None else retry_lib.now() + timeout
        if self._serve is not None:
            self._serve.close(timeout=retry_lib.deadline_left(t_end))

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


def _plan_key_spans(e: MatExpr, leaf_token=None
                    ) -> Tuple[list, list, dict]:
    """(parts, pins, spans) in ONE walk. ``"|".join(parts)`` is the
    root's structural key; ``spans[uid] = (start, end)`` slices
    ``parts`` so that ``"|".join(parts[start:end])`` is exactly the
    standalone key of that subtree (pre-order emission with a closing
    part, so a subtree's parts are one contiguous run) — what lets the
    result cache probe every interior node without re-walking it.

    ``leaf_token(node) -> str or None`` replaces the id()-based leaf
    tokens (the plan templates' abstract key); None makes the whole key
    ineligible (:class:`KeyError` from the walk)."""
    parts: list = []
    pins: list = []
    spans: dict = {}

    def walk(n: MatExpr):
        start = len(parts)
        if n.kind in ("leaf", "sparse_leaf", "coo_leaf"):
            if leaf_token is not None:
                tok = leaf_token(n)
                if tok is None:
                    raise KeyError(n.kind)
                parts.append(tok)
                spans[n.uid] = (start, len(parts))
                return
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
        spans[n.uid] = (start, len(parts))

    walk(e)
    return parts, pins, spans


def _plan_key(e: MatExpr) -> Tuple[str, list]:
    """(key, pins): the structural key of an expression and every object
    it references by id()."""
    parts, pins, _spans = _plan_key_spans(e)
    return "|".join(parts), pins


def _dtype_name(dtype) -> str:
    """A dtype as the JAX package's stamps spell it (numpy's name:
    "float32", "bfloat16")."""
    return str(dtype).replace("torch.", "")


def get_or_create_session() -> MatrelSession:
    return MatrelSession.builder().get_or_create()


def reset_session() -> None:
    global _active
    _active = None
