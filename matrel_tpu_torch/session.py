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
  ``resilience/``): each retry of a transient failure climbs one rung
  of the degradation ladder (``resilience/degrade.py`` — rung 3 runs
  the composite paths instead of the hand-written kernels, by design;
  a kernel that fails to build or launch is not transient and is never
  laddered around); injected faults (``fault_inject``), per-plan-class
  circuit breakers (``breaker_threshold``) and the brownout controller
  (``brownout_enable``);
- cross-query CSE and plan templates (``cse_enable``; ``serve/mqo.py``);
- incremental view maintenance: ``register_delta`` patches dependent
  cached results (``serve/ivm.py``, ``ir/delta.py``);
- the durable half (``spill_enable``, ``state_dir``; ``serve/spill.py``):
  evicted results demote to host RAM and disk and promote back on a
  miss, ``save_state``/``restore`` snapshot and warm-restart the
  session, ``save_catalog``/``load_catalog`` persist the tables
  (``utils/checkpoint.py``);
- drift-triggered re-planning (``coeff_replan_enable``;
  ``serve/replan.py``).

The observability plane (``obs/``) rides the same seams: the JSONL
event log and metrics registry (``obs_level``), tracing spans and the
flight recorder (``obs_flight_recorder``), SLO monitors
(``slo_targets``), the loopback metrics endpoint (``obs_metrics_port``),
the answer provenance ledger behind :meth:`MatrelSession.why`
(``obs_provenance``), EXPLAIN ANALYZE (``explain(analyze=True)``), the
lock-order sanitizer (``lockdep_enable``) and the drift-fitted planner
coefficients (``coeff_planner_enable``). No span synchronises the
device; only analysis does, when asked for. The static plan verifier
(``analysis/``) runs at compile time under ``verify_plans``, on demand
through :meth:`MatrelSession.verify`, and in ``explain``.

With every knob at its default ``compute`` is the JAX package's
production branch: compile (or hit the plan cache) and run, plans and
results bit-identical to a session without the serve, obs and
resilience planes — no event is assembled, no span or plane object
built, no sync added.

The multi-slice serving fleet (``fleet_slices`` >= 1; ``serve/fleet.py``)
turns ``submit`` into a routing decision: per-slice sessions on the
same card (each its own queue, worker and result cache), a catalog-name
keyed directory that answers a repeat from any slice's cache, hot-entry
replication and failover; on a rank mesh a slice is a group of ranks.
``fleet_info`` reports it; with the default 0 no fleet object is built
and ``submit`` is the single-session pipeline.
``sql``/``explain_sql`` compile the SQL surface (``sql.py``) into the
same IR.

On a rank mesh ``submit`` runs on the decision log
(``serve/ranklog.py``): every rank submits the same queries in the same
order, the lead rank decides each admission cycle and every rank
applies it. The other collective entry points — ``compute``/``run``,
``run_many``, ``compile`` (a measured choice is agreed across the
ranks), ``register``/``register_delta``, ``explain`` (whose
``analyze=True`` runs the plan), ``save_state``/``restore``,
``save_catalog``/``load_catalog`` and ``fleet_info`` — DRAIN AND HOLD
(:func:`_in_turn`): each waits until every rank's worker has applied
every record, then runs holding the execution lock the worker takes
around a cycle, so no collective of theirs can meet a worker's batch
in a different order on another rank. A result's ``to_numpy`` /
``with_spec`` take the same turn.

Plan-cache keys are structural; a callable attr (a σ predicate, a ⋈
merge) keys by the ``__matrel_key__`` tag ``sql.py`` attaches (so the
same query text hits), else by a fingerprint of its code, closure,
referenced globals and defaults, and only as a last resort by its
pinned identity (``_fn_token``).
"""

from __future__ import annotations

import functools
import hashlib
import itertools
import logging
import os
import time
import types
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from matrel_tpu_torch import executor as executor_lib
from matrel_tpu_torch.config import (MatrelConfig, default_config,
                                     normalize_sla)
from matrel_tpu_torch.core import mesh as mesh_lib
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import Mesh
from matrel_tpu_torch.ir.expr import MatExpr, as_expr
from matrel_tpu_torch.obs import export as export_lib
from matrel_tpu_torch.obs import provenance as provenance_lib
from matrel_tpu_torch.obs import slo as slo_lib
from matrel_tpu_torch.obs import trace as trace_lib
from matrel_tpu_torch.resilience import breaker as breaker_lib
from matrel_tpu_torch.resilience import brownout as brownout_lib
from matrel_tpu_torch.resilience import degrade as degrade_lib
from matrel_tpu_torch.resilience import errors as rerrors
from matrel_tpu_torch.resilience import faults as faults_lib
from matrel_tpu_torch.resilience import retry as retry_lib
from matrel_tpu_torch.resilience.retry import RetryPolicy
from matrel_tpu_torch.serve import mqo as mqo_lib
from matrel_tpu_torch.serve import replan as replan_lib
from matrel_tpu_torch.serve.result_cache import (CacheEntry, ResultCache,
                                                 result_nbytes)
from matrel_tpu_torch.utils import lockdep

log = logging.getLogger("matrel_tpu_torch")

_active: Optional["MatrelSession"] = None

Device = Union[str, torch.device, None]

_query_seq = itertools.count()


def _in_turn(method):
    """A collective entry point on a rank mesh takes its turn against
    the serve workers: drain and hold. It waits until every live worker
    of the world has applied every decision record (so on every rank
    the same submissions are done), then runs holding the execution
    lock the workers take around a cycle (``RankGroups.held``). Off a
    rank mesh, and on a worker's own thread, the method runs as is."""

    @functools.wraps(method)
    def run(self, *args, **kw):
        if not self.mesh.ranked:
            return method(self, *args, **kw)
        with self.mesh.ranks.held():
            return method(self, *args, **kw)

    return run


class MatrelSession:
    """Owns mesh + config + catalog; compiles and runs matrix queries."""

    def __init__(self, mesh: Optional[Mesh] = None,
                 config: Optional[MatrelConfig] = None,
                 device: Device = None):
        self.config = config or default_config()
        # the lock-order sanitizer (utils/lockdep.py) is armed BEFORE
        # any of this session's locks is built, so they all come back
        # instrumented; off (the default) this is one false branch
        if self.config.lockdep_enable:
            lockdep.enable(raise_on_violation=self.config.lockdep_raise)
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
        self._compile_lock = lockdep.make_rlock("session.compile")
        self._mqo: Optional["mqo_lib.MqoState"] = None
        self._delta_plane = None
        self._delta_gen = 0
        # the durable spill hierarchy (serve/spill.py): host/disk tiers
        # under the result cache and the warm-restart snapshot index —
        # None for the default config (spill._CONSTRUCTED stays 0)
        self._spill = None
        if self.config.spill_enable:
            from matrel_tpu_torch.serve.spill import SpillManager
            self._spill = SpillManager(self)
            self._spill.emit = self._emit_spill_event
            self._result_cache.attach_spill(self._spill)
        self._event_log = None      # built lazily (obs_level != "off")
        # obs and resilience planes: each None for the default config
        # (nothing constructed, nothing consulted). The flight-recorder
        # ring is independent of obs_level; the tracer exists iff any
        # span consumer does — with neither, compute()'s fast path
        # never creates a span object at all.
        fr_cap = self.config.obs_flight_recorder
        self._flight = (trace_lib.FlightRecorder(fr_cap)
                        if fr_cap > 0 else None)
        self._tracer = (trace_lib.Tracer(self._obs_emit)
                        if (self._flight is not None
                            or self.config.obs_level != "off")
                        else None)
        self._brownout = brownout_lib.from_config(self.config)
        self._breakers = breaker_lib.BreakerRegistry.from_config(
            self.config)
        self._slo = slo_lib.from_config(self.config,
                                        emit=self._emit_alert_event)
        # the multi-slice serving fleet (serve/fleet.py): built lazily on
        # the first submit when config.fleet_slices >= 1 — None for the
        # default config (no slice sessions, no directory). _slice_tag
        # marks THIS session as slice N of a fleet (its obs events carry
        # the tag); _exec_lock is the fleet's execution lock, shared by
        # the parent and every slice session (None: plain plan.run)
        self._fleet = None
        self._slice_tag: Optional[int] = None
        self._exec_lock = None
        self._prov = provenance_lib.from_config(self.config)
        # the cost-model re-plan controller (serve/replan.py): turns a
        # firing drift rank-order flag into a re-calibration and a
        # background re-warm of the affected cached plans — None unless
        # coeff_replan_enable (replan._CONSTRUCTED stays 0)
        self._replan = replan_lib.from_config(self.config, self)
        # the metrics endpoint is built LAST: its handler snapshots the
        # planes above (a port that cannot bind raises here)
        self._exporter = export_lib.from_config(self)
        if self.config.lockdep_enable:
            # lockdep diagnostics ride the one obs funnel
            lockdep.set_emit(lambda rec: self._obs_emit("lockdep", rec))

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

    @_in_turn
    def register(self, name: str, matrix) -> None:
        old = self.catalog.get(name)
        self.catalog[name] = matrix
        if self._fleet is not None and old is not matrix:
            # fleet write-through: the table replicates into every
            # slice, slice caches invalidate through each slice
            # session's own rebind path, directory records naming it
            # drop; a re-register of the same object is a no-op here
            # as below
            self._fleet.on_register(name, matrix)
        if old is not None and old is not matrix:
            # a catalog REBIND: every cached result computed from the
            # old binding is stale — drop it (dep sets are transitive,
            # so results built from cached intermediates drop too); a
            # no-op while the cache is off or empty
            # with a brownout controller the invalidated entries move to
            # the bounded stale graveyard (rung 2 may serve them to
            # queries declaring a staleness_ms tolerance)
            self._result_cache.invalidate_deps(
                {id(old)}, keep_stale=self._brownout is not None,
                stale_max=self.config.result_cache_max_entries,
                stale_max_bytes=self.config.result_cache_max_bytes)
            if self._spill is not None:
                # restored snapshot entries carry dep NAMES, not ids:
                # the rebind kill reaches them by name (the id cascade
                # above already covered the live host/disk tiers)
                self._spill.invalidate_names({name})

    def table(self, name: str):
        return self.catalog[name]

    @_in_turn
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
            out = self._delta_plane.apply(name, old, d)
        if self._fleet is not None:
            # fleet slices hold REPLICAS of the old binding, which
            # cannot be patched remotely: re-replicate the new binding
            # (slice caches and directory records invalidate; a slice
            # repeat pays one recompute)
            self._fleet.on_register(name, self.catalog[name])
        # SLO feed: patch latency reports under the pseudo-tenant "ivm"
        # (a no-op without a declared ivm target)
        if self._slo is not None and isinstance(out.get("ms"),
                                                (int, float)):
            self._slo.observe_latency(slo_lib.IVM_TENANT,
                                      float(out["ms"]))
        return out

    @_in_turn
    def save_catalog(self, directory: str,
                     step: Optional[int] = None) -> str:
        """Persist every registered table (atomic step directory, specs
        included; ``utils/checkpoint.py``'s format, which the JAX
        package reads too). ``step`` defaults to the next step in the
        directory (a fixed default would be GC'd by keep-k the moment
        older saves carry higher steps). Dense tables save as matrices,
        block-sparse ones as the format's sparse entries; a COO table
        has no entry in the format and raises TypeError. Returns the
        step path."""
        from matrel_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                       split_catalog)
        dense, sparse, other = split_catalog(self.catalog)
        if other:
            raise TypeError(
                f"save_catalog: table(s) {other} are COO matrices, which "
                f"the checkpoint format has no entry for")
        mgr = CheckpointManager(directory, config=self.config)
        if step is None:
            step = mgr.next_step()
        return mgr.save(step, matrices=dense, sparse=sparse)

    @_in_turn
    def load_catalog(self, directory: str,
                     step: Optional[int] = None) -> list:
        """Restore tables saved by :meth:`save_catalog` (by either
        package) into this session's catalog, existing names
        overwritten. Returns the restored names; an empty directory
        gives an empty list."""
        from matrel_tpu_torch.utils.checkpoint import CheckpointManager
        got = CheckpointManager(directory,
                                config=self.config).restore_all(self.mesh,
                                                                step)
        if got is None:
            return []
        _step, mats, sparse, _arrays, _state = got
        mats = {**mats, **sparse}
        # through register(): an overwritten name is a catalog REBIND,
        # and cached results computed from the old binding invalidate
        for name in sorted(mats):
            self.register(name, mats[name])
        return sorted(mats)

    @_in_turn
    def save_state(self, directory: Optional[str] = None) -> dict:
        """Snapshot this session's durable state — catalog bindings
        (the checkpoint step format), the result-cache index (entries
        with catalog-name-computable keys, frozen as sha1-verified disk
        artifacts), the fleet directory's demand hints, MQO template
        keys and the autotune / drift tables —
        under ``directory`` (default ``config.state_dir``; neither set
        raises ValueError). A later :meth:`restore` in a new process
        comes back serving warm. Without ``spill_enable`` only the
        catalog and tables persist (cached results are skipped, counted
        in the summary). Returns the save summary, also emitted as a
        ``spill`` event (op ``save_state``)."""
        from matrel_tpu_torch.serve import spill as spill_lib
        with self._compile_lock:
            out = spill_lib.save_state(self, directory)
        self._emit_spill_event({"op": "save_state", **out})
        return out

    @_in_turn
    def restore(self, directory: Optional[str] = None) -> dict:
        """Warm-restart this session from a :meth:`save_state` snapshot:
        the catalog restored through :meth:`register`, tables written if
        absent, the result-cache index seeded into the spill hierarchy's
        restored tier (requires ``spill_enable``; entries thaw lazily on
        first consult, paying only the priced transfer), the fleet
        directory re-seeded as affinity hints (``fleet_slices`` >= 1),
        MQO template keys re-indexed. A corrupt or truncated snapshot
        warns and cold-starts — restore never crashes a restart; a
        disk-tier entry failing its sha1 later is a per-entry miss,
        never a wrong answer. Returns the restore summary, also emitted as a
        ``spill`` event (op ``restore``)."""
        from matrel_tpu_torch.serve import spill as spill_lib
        with self._compile_lock:
            out = spill_lib.load_snapshot(self, directory)
        self._emit_spill_event({"op": "restore", **out})
        return out

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

    @_in_turn
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

    def _compile_entry(self, e: MatExpr, sla: Optional[str] = None,
                       rung: int = 0
                       ) -> Tuple[executor_lib.CompiledPlan, bool, str]:
        """(plan, cache_hit, key). ``rung`` > 0 compiles a DEGRADED
        retry attempt (``resilience/degrade.py``): the config loses the
        rung's features and the key gains the ``degr:<rung>|`` prefix,
        so a degraded plan never shares the original's cache slot."""
        sla = sla if sla is not None else self.config.precision_sla
        # fault site "compile": one attribute read when injection is off
        faults_lib.check("compile", self.config)
        key, pins = _plan_key(e)
        key = (degrade_lib.key_prefix(rung) + self._axisw_prefix()
               + self._coeff_prefix() + _prec_prefix(sla) + key)
        with self._compile_lock:
            plan = self._plan_cache.get(key)
            if plan is not None:
                self._plan_cache.move_to_end(key)
                return plan, True, key
            try:
                plan = executor_lib.compile_expr(
                    e, self.mesh,
                    degrade_lib.apply_rung(self._sla_config(sla), rung))
            except Exception as ex:
                # the post-mortem trail BEFORE the error propagates
                # (no-op with the flight recorder off)
                self._flight_auto_dump(ex)
                raise
            # pin every id()-keyed object on the cached plan: a collected
            # object's address can be reused by a later, different object
            plan._cache_pin = (e, pins)
            if rung:
                plan.meta["degrade"] = degrade_lib.rung_meta(rung)
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
                             sla: Optional[str] = None,
                             rung: int = 0
                             ) -> Tuple[executor_lib.MultiPlan, bool,
                                        List[str]]:
        """(multiplan, cache_hit, per-root keys): the MultiPlan twin of
        :meth:`_compile_entry`, in the same cache. The key is the sorted
        unique root keys under the precision prefix, so a batch
        resubmitted in any order, or with duplicate roots, hits. The
        plan remembers its root-key order (``_root_keys``) so callers map
        outputs back to their own roots."""
        sla = sla if sla is not None else self.config.precision_sla
        faults_lib.check("compile", self.config)
        keyed, pins = [], []
        for e in roots:
            k, p = _plan_key(e)
            keyed.append(k)
            pins.extend(p)
        uniq: "OrderedDict[str, MatExpr]" = OrderedDict()
        for k, e in zip(keyed, roots):
            uniq.setdefault(k, e)
        skeys = sorted(uniq)
        mkey = ("multi:" + degrade_lib.key_prefix(rung)
                + self._axisw_prefix() + self._coeff_prefix()
                + _prec_prefix(sla) + "||".join(skeys))
        with self._compile_lock:
            plan = self._plan_cache.get(mkey)
            if plan is not None:
                self._plan_cache.move_to_end(mkey)
                return plan, True, keyed
            try:
                plan = executor_lib.compile_exprs(
                    [uniq[k] for k in skeys], self.mesh,
                    degrade_lib.apply_rung(self._sla_config(sla), rung))
            except Exception as ex:
                self._flight_auto_dump(ex)
                raise
            if rung:
                plan.meta["degrade"] = degrade_lib.rung_meta(rung)
            plan._cache_pin = (tuple(uniq[k] for k in skeys), pins)
            plan._root_keys = tuple(skeys)
            self._cache_insert(mkey, plan)
            return plan, False, keyed

    def _axisw_prefix(self) -> str:
        wts = mesh_lib.axis_weights(self.mesh, self.config)
        if wts == (1.0, 1.0):
            return ""
        return f"axisw:{wts[0]:g}x{wts[1]:g}|"

    def _coeff_epoch(self) -> Optional[str]:
        """The coefficient epoch in force (``parallel/coeffs.epoch`` — a
        digest of the drift table's blended ratios), or None with
        ``coeff_planner_enable`` off."""
        if not self.config.coeff_planner_enable:
            return None
        from matrel_tpu_torch.obs import drift as drift_lib
        from matrel_tpu_torch.parallel import coeffs as coeffs_lib
        return coeffs_lib.epoch(drift_lib.table_path(self.config))

    def _coeff_prefix(self) -> str:
        """Coefficient-epoch plan-key isolation: plans ranked under
        different learned coefficients never share a cache slot (a
        re-calibration bumps the epoch; old entries age out by LRU).
        Empty with ``coeff_planner_enable`` off."""
        ep = self._coeff_epoch()
        return "" if ep is None else f"coeffv:{ep}|"

    def plan_cache_info(self) -> dict:
        return {"plans": len(self._plan_cache),
                "evicted": self._plan_cache_evicted}

    def _replan_warm(self, classes) -> dict:
        """Proactively recompile cached plans whose matmul decisions
        touch the given shape classes, under the current coefficient
        epoch (``serve/replan.py``'s background thread calls this after
        a re-calibration). Correctness never depends on it — the
        ``coeffv:`` key prefix already makes every post-bump lookup miss
        and recompile lazily; this pass pays the compiles off the query
        path. Each entry re-warms from its pinned root expr(s) at the
        session's default SLA and rung 0. Old-epoch entries stay until
        LRU eviction: an in-flight query holding one is never
        invalidated under it."""
        from matrel_tpu_torch.obs import drift as drift_lib
        with self._compile_lock:
            snapshot = list(self._plan_cache.values())
        matched = warmed = 0
        for plan in snapshot:
            pin = getattr(plan, "_cache_pin", None)
            if pin is None:
                continue
            try:
                decs = executor_lib.plan_matmul_decisions(plan)
            except Exception:  # matlint: disable=ML007 best-effort re-plan census — an unreadable plan is skipped; the lazy coeffv: miss still re-plans it
                # best-effort census: an unreadable plan is skipped; the
                # lazy coeffv: miss still re-plans it
                continue
            if not any(drift_lib.shape_class(d.get("dims") or ())
                       in classes for d in decs):
                continue
            matched += 1
            roots = pin[0]
            try:
                if isinstance(roots, tuple):
                    self._compile_multi_entry(list(roots))
                else:
                    self._compile_entry(roots)
                warmed += 1
            except Exception:
                log.warning("replan: warm recompile failed",
                            exc_info=True)
        return {"matched": matched, "replanned": warmed}

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
        # fault site "rc_probe": a faulting consult is what the
        # ladder's rung-4 bypass routes around
        faults_lib.check("rc_probe", self.config)
        parts, pins, spans = _plan_key_spans(e)
        key = prefix + "|".join(parts)
        ent = self._result_cache.lookup(key)
        if ent is None and self._spill is not None \
                and self._spill.restored_count():
            # warm restart: a restored snapshot's name-keyed index may
            # hold this query's value frozen at the disk tier — thaw
            # it, and the repeat pays a priced transfer, not a recompute
            ent = self._rc_thaw_restored(e, prefix, key)
        if ent is not None:
            return ent, key, pins, e
        return None, key, pins, self._rc_substitute(e, parts, spans,
                                                    prefix)

    def _rc_thaw_restored(self, e: MatExpr, prefix: str, key: str):
        """Consult the restored-snapshot index on a cache miss: the
        session-independent NAME key (``placement.fleet_key`` — catalog
        names, not id()s) is the only key format that survives a process
        boundary. A thaw re-resolves dep names against the live catalog,
        re-inserts under the query's live structural key (so the next
        repeat is a plain device hit) and corrects the miss the lookup
        already counted. Precision tiers stay isolated: the entry thaws
        only for a query under the same ``prec:`` token it was cached
        under."""
        from matrel_tpu_torch.serve import placement as placement_lib
        nk = placement_lib.fleet_key(
            e, {id(m): n for n, m in self.catalog.items()})
        if nk is None:
            return None
        # the prec component of the admission prefix (the delta:<gen>|
        # part, when present, always precedes it and ends at its "|")
        prec = (prefix.split("|", 1)[1]
                if prefix.startswith("delta:") else prefix)
        ent = self._spill.thaw_restored(nk, prec, self.catalog.get)
        if ent is None:
            return None
        self._result_cache.note_restored_hit()
        self._result_cache.put(key, ent,
                               self.config.result_cache_max_bytes,
                               self.config.result_cache_max_entries)
        return ent

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
        if ent.fleet:
            stamp["fleet"] = dict(ent.fleet)
        if ent.spill:
            # the consumed value was thawed from a lower tier: MV117
            # re-checks the stamped legs against the step vocabulary and
            # the peak budget claim
            stamp["spill"] = dict(ent.spill)
        node = expr_mod.leaf(ent.result).with_attrs(result_cache=stamp)
        if self._prov is not None:
            # the consumed entry's lineage rides the substitution leaf
            node = self._prov.stamp_leaf(node, ent)
        return node

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
                        staleness_ms: Optional[float],
                        peek: bool = False, aged: bool = False):
        """The STALE entry for this query iff it declared a
        ``staleness_ms`` tolerance its age fits (the brownout rung-2
        consult: only a session with a brownout controller keeps the
        graveyard, so otherwise this finds nothing). ``peek`` / ``aged``
        as ``ResultCache.lookup_stale`` (the rank-mesh decision log)."""
        if (not self._rc_enabled() or not staleness_ms
                or staleness_ms <= 0):
            return None
        parts, _pins, _spans = _plan_key_spans(e)
        key = self._rc_key_prefix(sla) + "|".join(parts)
        return self._result_cache.lookup_stale(key, staleness_ms,
                                               peek=peek, aged=aged)

    def _rc_pattern(self, e: MatExpr, sla: str) -> str:
        """Which of ``e``'s subtrees the result cache holds now, as
        key-part spans ("H": the whole query): the same string on every
        rank whose cache agrees, whatever the id()s in the keys. What a
        rank reports to the decision log; touches nothing."""
        if not self._rc_enabled():
            return ""
        prefix = self._rc_key_prefix(self._resolve_sla(sla))
        parts, _pins, spans = _plan_key_spans(e)
        if self._result_cache.holds(prefix + "|".join(parts)):
            return "H"
        return ",".join(f"{a}:{b}" for a, b in sorted(spans.values())
                        if b - a > 1 and self._result_cache.holds(
                            prefix + "|".join(parts[a:b])))

    def _rc_insert(self, key: str, pins: list, executed: MatExpr,
                   out: BlockMatrix, orig: Optional[MatExpr] = None,
                   prec: str = "", plan=None,
                   prov: Optional[dict] = None) -> None:
        """Cache one executed result under its structural key.
        ``executed`` is the (possibly substituted) tree that ran — its
        leaves name the deps; ``pins`` keep the key's id()-referenced
        objects alive; ``orig`` is the pre-substitution tree the delta
        plane derives patches from; ``plan`` supplies the stamped tier's
        error bound; ``prov`` is the producing answer's lineage summary
        (the entry's provenance stamp names it)."""
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
        if prov is not None and self._prov is not None:
            self._prov.stamp_entry(ent, prov["path"], prov["query_id"])
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

    def _tpl_prefix(self, sla: str, rung: int = 0) -> str:
        """Template keys compose the concrete plan key's isolation
        prefixes (``degr:``/``axisw:``/``coeffv:``/``prec:``), so a
        degraded or fast-SLA template never serves a pristine exact
        query."""
        return (degrade_lib.key_prefix(rung) + self._axisw_prefix()
                + self._coeff_prefix() + _prec_prefix(sla))

    def _template_probe(self, e: MatExpr, sla: str, rung: int = 0):
        """(plan, concrete key, bindings) when a cached template serves
        this query by rebinding its dense leaves; None when the concrete
        plan is cached, the tree is ineligible, no template matches, or
        one template leaf would face two distinct matrices."""
        prefix = self._tpl_prefix(sla, rung)
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

    def _template_insert(self, e: MatExpr, plan, sla: str,
                         rung: int = 0) -> None:
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
            st.put_template(self._tpl_prefix(sla, rung) + akey, ent)
            st.template_inserts += 1

    def _template_probe_multi(self, roots: List[MatExpr], sla: str,
                              rung: int = 0):
        """(plan, per-root concrete keys, pos, bindings) when a cached
        MultiPlan template matches this batch modulo dense-leaf
        bindings (roots pair to slots by abstract key)."""
        prefix = self._tpl_prefix(sla, rung)
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

    def _template_insert_multi(self, plan, sla: str,
                               rung: int = 0) -> None:
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
                "multi:" + self._tpl_prefix(sla, rung)
                + "||".join(sorted(ak for ak, _u in slots)), ent)
            st.template_inserts += 1

    def _cse_hoist_batch(self, pend: list, sla: str, rung: int,
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
        with trace_lib.span("cse.hoist", shared=len(hoists)):
            hexprs = [h.expr for h in hoists]
            bindings = None
            tpl = self._template_probe_multi(hexprs, sla, rung)
            if tpl is not None:
                plan, hkeys, pos, bindings = tpl
            else:
                plan, p_hit, hkeys = self._compile_multi_entry(
                    hexprs, sla=sla, rung=rung)
                pos = {k: j for j, k in enumerate(plan._root_keys)}
                if not p_hit:
                    self._template_insert_multi(plan, sla, rung)
            faults_lib.check("execute", self.config)
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
            summary = None
            if self._prov is not None:
                summary = self._prov_capture(
                    "cse_hoist", full, sla, rung=rung, expr=h.expr,
                    result=out, executed=h.expr, plan=plan,
                    strategies=executor_lib.multiplan_root_decisions(
                        plan)[pos[hk]])
            if rc:
                # the interior key is exactly what a later query's
                # _rc_substitute probe computes for a matching subtree
                _k2, p2 = _plan_key(h.expr)
                self._rc_insert(full, p2, h.expr, out, orig=h.expr,
                                prec=_prec_prefix(sla), plan=plan,
                                prov=summary)
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

    # -- observability (obs/) ------------------------------------------------

    def _obs_enabled(self) -> bool:
        return self.config.obs_level != "off"

    def _obs_event_log(self):
        from matrel_tpu_torch.obs.events import EventLog, resolve_path
        path = resolve_path(self.config.obs_event_log)
        max_bytes = self.config.obs_event_log_max_bytes
        if (self._event_log is None or self._event_log.path != path
                or self._event_log.max_bytes != max_bytes):
            self._event_log = EventLog(path, max_bytes=max_bytes)
        return self._event_log

    def _obs_emit(self, kind: str, record: dict) -> None:
        """The one emission funnel for session events AND finished
        spans: the JSONL event log when obs is on, the flight-recorder
        ring when configured — each independently. A fleet slice's
        records carry its slice id."""
        if self._slice_tag is not None and "slice" not in record:
            record = {**record, "slice": self._slice_tag}
        full = None
        if self._obs_enabled():
            full = self._obs_event_log().emit(kind, record)
        if self._flight is not None:
            if full is None:
                from matrel_tpu_torch.obs.events import SCHEMA_VERSION
                full = {"schema": SCHEMA_VERSION,
                        "ts": round(time.time(), 3), "kind": kind}  # matlint: disable=ML006 record timestamp — the obs funnel's ts mirrors EventLog.emit's stamp
                full.update(record)
            self._flight.add(full)

    # -- answer provenance ledger (obs/provenance.py) -------------------------

    def _prov_capture(self, path: str, key: str, sla: str,
                      rung: int = 0, expr=None, result=None, ent=None,
                      executed=None, plan=None, strategies=None,
                      fleet=None, stale=None, mesh=None,
                      config=None) -> Optional[dict]:
        """One lineage record + ``provenance`` event per served answer.
        Callers guard on ``self._prov is not None`` (the off path
        assembles no arguments); a capture failure never fails the
        answer it describes. The record keeps the compile config the
        answer was produced under (SLA + degrade rung), so audit replay
        reconstructs it; a fleet directory hit passes the serving
        slice's ``mesh`` and ``config`` and its ``fleet`` hop."""
        try:
            cfg = config if config is not None else \
                degrade_lib.apply_rung(self._sla_config(sla), rung)
            summary = self._prov.capture(
                path, key, sla, rung=rung, expr=expr, result=result,
                ent=ent, executed=executed, plan=plan,
                strategies=strategies,
                mesh=mesh if mesh is not None else self.mesh,
                config=cfg, fleet=fleet, stale=stale,
                coeff_epoch=self._coeff_epoch())
            self._obs_emit("provenance", summary)
            return summary
        except Exception:
            log.warning("obs: provenance record dropped", exc_info=True)
            return None

    def _prov_capture_stale(self, e: MatExpr, ent, meta: dict) -> None:
        """Rung-2 stale-serve capture (serve/pipeline.py): the
        structural key recomputed (paid only with the ledger on) and
        the staleness grant the answer was served under."""
        sla = meta.get("sla") or self.config.precision_sla
        parts, _pins, _spans = _plan_key_spans(e)
        key = self._rc_key_prefix(sla) + "|".join(parts)
        stale = {"staleness_ms": float(meta.get("staleness_ms") or 0.0)}
        if meta.get("tenant"):
            stale["tenant"] = meta["tenant"]
        self._prov_capture("stale", key, sla, ent=ent, stale=stale)

    def why(self, query=None, last: int = 10) -> list:
        """Lineage of recently served answers: the JSON-safe summary
        dicts of the provenance ledger, newest last. ``query`` filters
        by key / key-hash substring or ledger query id, or by the
        answer itself (a BlockMatrix matches by identity). Empty when
        ``config.obs_provenance`` is 0."""
        if self._prov is None:
            return []
        if query is None:
            recs = self._prov.last(last)
        elif isinstance(query, BlockMatrix):
            recs = [r for r in self._prov.records() if r.result is query]
        else:
            recs = self._prov.find(str(query))
        return [r.summary for r in recs]

    def provenance_info(self) -> dict:
        """``plan_cache_info``-style surface of the ledger."""
        if self._prov is None:
            return {"records": 0, "cap": 0, "captured": 0, "chains": 0}
        return self._prov.info()

    # -- flight recorder (obs/trace.py) ---------------------------------------

    def dump_flight_recorder(self, path: Optional[str] = None,
                             reason: str = "explicit",
                             error: Optional[str] = None
                             ) -> Optional[str]:
        """Write the flight-recorder ring as a JSON artifact and return
        its path (None when the recorder is off)."""
        if self._flight is None:
            return None
        p = (path or self.config.obs_flight_recorder_path
             or trace_lib.DEFAULT_FLIGHT_PATH)
        return self._flight.dump(p, reason, error=error)

    def _flight_auto_dump(self, ex: BaseException,
                          reason: Optional[str] = None) -> None:
        """Best-effort dump on a failure path — a post-mortem artifact
        never masks the original exception."""
        if self._flight is None:
            return
        if reason is None:
            reason = ("verification_error"
                      if type(ex).__name__ == "VerificationError"
                      else "compile_failure")
        try:
            p = self.dump_flight_recorder(reason=reason,
                                          error=repr(ex)[:500])
            log.warning("flight recorder dumped to %s (%s)", p, reason)
        except Exception:
            log.warning("flight recorder dump failed", exc_info=True)

    # -- obs event emitters ---------------------------------------------------

    def _emit_query_event(self, e: MatExpr, plan, hit: bool, key: str,
                          execute_ms: float, first_execution: bool,
                          out: BlockMatrix, matmuls=None,
                          rule_hits=None, batch=None,
                          tenant: Optional[str] = None,
                          cache_label: Optional[str] = None) -> None:
        """One event-log record + metrics updates per query run, from
        data the compile path already produced (plan.meta). The JAX
        package's fields; ``backend`` is the result's device type and,
        on a CUDA result, ``execute_clock: "host"`` says ``execute_ms``
        timed the launch (no span syncs the device)."""
        from matrel_tpu_torch.obs.metrics import REGISTRY
        meta = plan.meta or {}
        if matmuls is None:
            matmuls = executor_lib.plan_matmul_decisions(plan)
        sql_hash = getattr(e, "_sql_hash", None)
        record = {
            "query_id": f"q{os.getpid()}-{next(_query_seq)}",
            "source": "sql" if sql_hash else "dsl",
            "source_hash": sql_hash
            or hashlib.sha1(key.encode()).hexdigest()[:16],
            "root_kind": e.kind,
            "cache": cache_label or ("hit" if hit else "miss"),
            "optimize_ms": (0.0 if cache_label == "template_hit"
                            else meta.get("optimize_ms")),
            "trace_ms": (0.0 if cache_label == "template_hit"
                         else meta.get("trace_ms")),
            # compile-scoped: a cache hit ran no rewrite rules
            "rule_hits": (rule_hits if rule_hits is not None
                          else ({} if hit else meta.get("rule_hits",
                                                        {}))),
            "matmuls": matmuls,
            "execute_ms": round(execute_ms, 3),
            "first_execution": first_execution,
            "out_shape": list(out.shape),
            "out_nnz": out.nnz,
            "plan_cache": self.plan_cache_info(),
        }
        if batch is not None:
            record["batch"] = batch
        if tenant:
            record["tenant"] = tenant
        if meta.get("fusion"):
            record["fusion"] = meta["fusion"]
        if self._rc_enabled():
            record["result_cache"] = self._result_cache.info()
        device = out.data.device
        record["backend"] = device.type
        if device.type == "cuda":
            record["execute_clock"] = "host"
        if self.config.coeff_planner_enable:
            record["coeff_epoch"] = self._coeff_epoch()
        self._obs_emit("query", record)
        if self._replan is not None:
            # feed the re-plan controller after emission: it sees the
            # record the log does, and its own failure can never drop
            # the query event
            self._replan.observe(record)
        REGISTRY.counter("query.count").inc()
        REGISTRY.counter("plan_cache.hit" if hit
                         else "plan_cache.miss").inc()
        if cache_label == "template_hit":
            REGISTRY.counter("mqo.template_hit").inc()
        REGISTRY.gauge("plan_cache.plans").set(len(self._plan_cache))
        REGISTRY.gauge("plan_cache.evicted").set(self._plan_cache_evicted)
        REGISTRY.histogram("query.execute_ms").observe(execute_ms)
        if not hit:
            if meta.get("optimize_ms") is not None:
                REGISTRY.histogram("query.optimize_ms").observe(
                    meta["optimize_ms"])
            for rule, n in meta.get("rule_hits", {}).items():
                REGISTRY.counter(f"optimizer.rule.{rule}").inc(n)
        for d in matmuls:
            REGISTRY.counter(f"planner.strategy.{d['strategy']}").inc()

    def _emit_verify_event(self, plan) -> None:
        """One ``verify`` record per observed run of a plan compiled with
        ``verify_plans`` on: the diagnostic codes the compile-time
        verifier produced for it (empty codes = verified clean). Cache
        hits re-report the compile-time findings; "cache" on the query
        record says no new verify happened."""
        diags = (plan.meta or {}).get("diagnostics")
        if diags is None:
            return
        from matrel_tpu_torch.obs.metrics import REGISTRY
        self._obs_emit("verify", {
            "mode": self.config.verify_plans,
            "count": len(diags),
            "errors": sum(1 for d in diags if d["severity"] == "error"),
            "codes": sorted({d["code"] for d in diags}),
        })
        REGISTRY.counter("verify.count").inc()
        if diags:
            REGISTRY.counter("verify.diagnostics").inc(len(diags))

    def verify(self, expr: MatExpr) -> list:
        """Run the static plan verifier (``analysis/``) on this
        expression's optimized, strategy-annotated plan and return the
        diagnostic list — whatever ``config.verify_plans`` says (that
        gate controls the compile path; this is the on-demand surface).
        Planning only: nothing is lowered or executed."""
        from matrel_tpu_torch import analysis
        from matrel_tpu_torch.ir import rules
        from matrel_tpu_torch.parallel import planner
        e = as_expr(expr)
        grid = mesh_lib.mesh_grid_shape(self.mesh)
        opt = planner.annotate_strategies(
            rules.optimize(e, self.config, grid=grid, mesh=self.mesh),
            self.mesh, self.config)
        return analysis.verify_plan(opt, self.mesh, self.config)

    def _emit_spill_event(self, record: dict) -> None:
        """One ``spill`` record per tier move (demote / promote / thaw —
        ``serve/spill.py``'s emit hook) and per save_state / restore: the
        measured transfer legs the drift auditor calibrates
        ``spill:<leg>`` rows from. Obs or flight recorder on; a no-op
        otherwise. Never fails the cache operation."""
        if not self._obs_enabled() and self._flight is None:
            return
        from matrel_tpu_torch.obs.metrics import REGISTRY
        try:
            self._obs_emit("spill", dict(record))
            REGISTRY.counter(
                f"spill.{record.get('op') or 'op'}").inc()
        except Exception:
            log.warning("obs: spill event dropped", exc_info=True)

    def _emit_rc_hit_event(self, e: MatExpr, key: str, out: BlockMatrix,
                           tenant: Optional[str] = None) -> None:
        """Query record of a WHOLE-query result-cache hit: nothing
        compiled, nothing run."""
        from matrel_tpu_torch.obs.metrics import REGISTRY
        sql_hash = getattr(e, "_sql_hash", None)
        self._obs_emit("query", {
            **({"tenant": tenant} if tenant else {}),
            "query_id": f"q{os.getpid()}-{next(_query_seq)}",
            "source": "sql" if sql_hash else "dsl",
            "source_hash": sql_hash
            or hashlib.sha1(key.encode()).hexdigest()[:16],
            "root_kind": e.kind,
            "cache": "rc_hit",
            "optimize_ms": None,
            "trace_ms": None,
            "rule_hits": {},
            "matmuls": [],
            "execute_ms": 0.0,
            "first_execution": False,
            "out_shape": list(out.shape),
            "out_nnz": out.nnz,
            "plan_cache": self.plan_cache_info(),
            "result_cache": self._result_cache.info(),
        })
        REGISTRY.counter("query.count").inc()
        REGISTRY.counter("result_cache.hit").inc()

    def _emit_delta_event(self, record: dict) -> None:
        """One ``delta`` record per ``register_delta`` (obs on or the
        flight recorder on; nothing otherwise): the maintenance
        summary. Never fails the register."""
        if not self._obs_enabled() and self._flight is None:
            return
        from matrel_tpu_torch.obs.metrics import REGISTRY
        try:
            rec = dict(record)
            if self._rc_enabled():
                rec["result_cache"] = self._result_cache.info()
            self._obs_emit("delta", rec)
            REGISTRY.counter("ivm.registered").inc()
            REGISTRY.counter("ivm.patched").inc(record.get("patched", 0))
            REGISTRY.counter("ivm.killed").inc(record.get("killed", 0))
        except Exception:
            log.warning("obs: delta event dropped", exc_info=True)

    def _emit_serve_event(self, record: dict) -> None:
        """One ``serve`` record per micro-batched admission (obs on):
        batch size, queue waits, result-cache state, in-flight depth."""
        from matrel_tpu_torch.obs.metrics import REGISTRY
        record = dict(record)
        record["result_cache"] = self._result_cache.info()
        self._obs_emit("serve", record)
        REGISTRY.counter("serve.batches").inc()
        REGISTRY.counter("serve.queries").inc(record.get("batch_size", 0))
        for w in record.get("queue_wait_ms") or ():
            REGISTRY.histogram("serve.queue_wait_ms").observe(w)
        REGISTRY.gauge("result_cache.entries").set(
            record["result_cache"]["entries"])
        REGISTRY.gauge("result_cache.bytes").set(
            record["result_cache"]["bytes"])

    def _emit_alert_event(self, record: dict) -> None:
        """One ``alert`` record per SLO alert TRANSITION (event log when
        obs is on, flight ring whenever it exists)."""
        from matrel_tpu_torch.obs.metrics import REGISTRY
        try:
            self._obs_emit("alert", record)
            REGISTRY.counter(
                "slo.alerts.fired" if record.get("state") == "firing"
                else "slo.alerts.cleared").inc()
            REGISTRY.gauge("slo.alerts.active").set(
                record.get("active", 0))
        except Exception:
            log.warning("obs: alert event dropped", exc_info=True)

    def _emit_overload_event(self, record: dict) -> None:
        """One ``overload`` record per admission cycle while the control
        plane is active (serve/pipeline.py assembles it)."""
        from matrel_tpu_torch.obs.metrics import REGISTRY
        try:
            self._obs_emit("overload", record)
            REGISTRY.gauge("overload.rung").set(record.get("rung", 0))
        except Exception:
            log.warning("obs: overload event dropped", exc_info=True)

    def _emit_fault_event(self, ex: BaseException, scope: str) -> None:
        """One ``fault`` record per failure the resilient path caught
        (obs on / flight recorder on); injected faults carry their
        site."""
        if not self._obs_enabled() and self._flight is None:
            return
        rec = {"scope": scope, "error": type(ex).__name__,
               "classification": rerrors.classify(ex),
               "message": str(ex)[:200]}
        if isinstance(ex, rerrors.InjectedFault):
            rec["site"] = ex.site
            rec["injected"] = True
        try:
            self._obs_emit("fault", rec)
        except Exception:
            log.warning("obs: fault event dropped", exc_info=True)

    def _emit_retry_event(self, ex: BaseException, attempt: int,
                          rung: int, scope: str) -> None:
        if not self._obs_enabled() and self._flight is None:
            return
        try:
            self._obs_emit("retry", {
                "scope": scope, "attempt": attempt, "rung": rung,
                "rung_label": degrade_lib.rung_label(rung),
                "error": type(ex).__name__})
        except Exception:
            log.warning("obs: retry event dropped", exc_info=True)

    def _emit_degrade_event(self, rung: int, ex: BaseException,
                            scope: str) -> None:
        if not self._obs_enabled() and self._flight is None:
            return
        try:
            self._obs_emit("degrade", {
                "scope": scope, "rung": rung,
                "rung_label": degrade_lib.rung_label(rung),
                "cause": type(ex).__name__})
        except Exception:
            log.warning("obs: degrade event dropped", exc_info=True)

    def _arbitrated_run(self, plan, bindings=None):
        """Run one compiled plan (``bindings`` rebinds dense leaves by
        uid — template hits). Without a fleet this IS ``plan.run``.
        Under a fleet the parent and every slice share one execution
        lock (``_exec_lock``) and the plan runs to COMPLETION under it:
        the card is synchronised before the lock drops, so two slices'
        programs are never in flight together. Cache hits, planning and
        admission never come here. A sanctioned dispatch point for the
        lock-order sanitizer (the fleet lock is declared dispatch_ok)."""
        lockdep.note_dispatch("session.dispatch")
        if self._exec_lock is None:
            return plan.run(bindings=bindings)
        with self._exec_lock:
            out = plan.run(bindings=bindings)
            if self.mesh.device.type == "cuda":
                torch.cuda.synchronize(self.mesh.device)
            return out

    def _emit_placement_event(self, record: dict) -> None:
        """One ``placement`` record per fleet-routed submission
        (serve/fleet.py assembles it: mode, routed target, directory
        outcome, coefficient provenance, the two cost estimates) — the
        feed for ``history --summary``'s fleet roll-up. Never fails a
        query."""
        from matrel_tpu_torch.obs.metrics import REGISTRY
        try:
            self._obs_emit("placement", record)
            REGISTRY.counter(
                f"fleet.placed.{record.get('routed', '?')}").inc()
        except Exception:
            log.warning("obs: placement event dropped", exc_info=True)

    def _emit_fleet_event(self, record: dict) -> None:
        """One ``fleet`` record per fleet lifecycle event (slice kill /
        failover, hot-entry migration, priced-out migration), carried
        with the fleet's census so offline replay can reconstruct its
        state transitions."""
        from matrel_tpu_torch.obs.metrics import REGISTRY
        try:
            rec = dict(record)
            if self._fleet is not None:
                rec["fleet"] = {
                    "placed": dict(self._fleet.placed),
                    "failovers": self._fleet.failovers,
                    "migrations": self._fleet.migrations,
                }
            self._obs_emit("fleet", rec)
            REGISTRY.counter(
                f"fleet.event.{record.get('event', '?')}").inc()
        except Exception:
            log.warning("obs: fleet event dropped", exc_info=True)

    def _run_observed(self, e: MatExpr, plan, hit: bool, key: str,
                      tenant: Optional[str] = None, bindings=None,
                      cache_label: Optional[str] = None) -> BlockMatrix:
        """Run one compiled plan under the ``query.execute`` span and
        emit its query record (the obs-on half of compute()). The span
        reads the host clock and adds no device sync: on the card
        ``execute_ms`` is the launch time."""
        first = not getattr(plan, "_obs_executed", False)
        with trace_lib.phase("query.execute",
                             cache=cache_label
                             or ("hit" if hit else "miss")) as sp:
            out = self._arbitrated_run(plan, bindings=bindings)
        plan._obs_executed = True
        try:
            self._emit_query_event(e, plan, hit, key, sp.dur_ms, first,
                                   out, tenant=tenant,
                                   cache_label=cache_label)
            self._emit_verify_event(plan)
        except Exception:   # the result exists: never fail the query
            log.warning("obs: query event dropped", exc_info=True)
        return out

    # -- actions ------------------------------------------------------------

    @_in_turn
    def compute(self, expr: MatExpr,
                precision: Optional[str] = None,
                deadline_ms: Optional[float] = None,
                tenant: Optional[str] = None) -> BlockMatrix:
        """Execute one query. ``precision`` is the per-query accuracy SLA
        ("exact"/"high"/"fast"/explicit dtype); None defers to a SQL
        PRECISION clause, then ``config.precision_sla``. ``deadline_ms``
        is the per-query deadline (None defers to ``config.deadline_ms``;
        expiry raises the typed ``DeadlineExceeded``). ``tenant`` tags
        the query's obs records (admission fairness lives in
        ``submit``). With breakers on, an open plan class fails fast
        typed (``CircuitOpen``)."""
        e = as_expr(expr)
        sla = self._resolve_sla(precision, e)
        pol = RetryPolicy.from_config(self.config, deadline_ms)
        rc = self._rc_enabled()
        if self._breakers is None:
            return self._compute_dispatch(e, sla, pol, rc, tenant)
        bclass = self._breakers.plan_class(e)
        self._breakers.admit(bclass)
        try:
            out = self._compute_dispatch(e, sla, pol, rc, tenant)
        except Exception as ex:
            self._breakers.record(
                bclass,
                False if breaker_lib.counts_as_failure(ex) else None)
            raise
        self._breakers.record(bclass, True)
        return out

    # the reference's Dataset actions read as "run the query"
    run = compute

    def _compute_dispatch(self, e: MatExpr, sla: str,
                          pol: Optional[RetryPolicy], rc: bool,
                          tenant: Optional[str]) -> BlockMatrix:
        """compute() behind the breaker gate: the resilient / fast /
        observed three-way."""
        if pol is not None:
            return self._compute_resilient(e, rc, sla, pol,
                                           tenant=tenant)
        if (not rc and not self._obs_enabled() and self._tracer is None
                and not self._cse_on() and self._prov is None):
            # the production path: no event assembly, no span, no
            # cache-key walks beyond the plan cache's own (with
            # fault_inject set the policy above is never None). A
            # provenance ledger takes the observed path: every answer
            # appends its record (the JAX package's gate omits the
            # ledger, so there a plain compute() records nothing)
            return self._arbitrated_run(self._compile_entry(e, sla=sla)[0])
        # per-thread tracer activation: the executor's compile phases
        # and every span below parent-link into this query's trail
        with trace_lib.activate(self._tracer), \
                trace_lib.span("query", root_kind=e.kind):
            return self._compute_observed(e, rc, sla, tenant=tenant)

    def _compute_observed(self, e: MatExpr, rc: bool,
                          sla: Optional[str] = None, rung: int = 0,
                          tenant: Optional[str] = None) -> BlockMatrix:
        """compute() past the fast-path gate: result-cache admission,
        the plan-template probe, compile, execute, insert — each scoped
        by a span. ``rung`` is the degradation ladder's step."""
        sla = sla if sla is not None else self.config.precision_sla
        key = pins = None
        orig = e
        if rc:
            with trace_lib.span("rc.probe") as sp:
                ent, key, pins, e = self._rc_admit(
                    e, self._rc_key_prefix(sla))
                sp.set(hit=ent is not None)
            if ent is not None:
                if self._obs_enabled():
                    try:
                        self._emit_rc_hit_event(e, key, ent.result,
                                                tenant=tenant)
                    except Exception:
                        log.warning("obs: query event dropped",
                                    exc_info=True)
                if self._prov is not None:
                    self._prov_capture("rc_hit", key, sla, rung=rung,
                                       ent=ent)
                return ent.result
        bindings = cache_label = None
        with trace_lib.span("plan"):
            tpl = (self._template_probe(e, sla, rung)
                   if self._cse_on() else None)
            if tpl is not None:
                plan, pkey, bindings = tpl
                hit, cache_label = True, "template_hit"
            else:
                plan, hit, pkey = self._compile_entry(e, sla=sla,
                                                      rung=rung)
                if self._cse_on() and not hit:
                    self._template_insert(e, plan, sla, rung)
        # fault site "execute": the host-side dispatch point — the main
        # retryable site
        faults_lib.check("execute", self.config)
        if self._obs_enabled():
            out = self._run_observed(e, plan, hit, pkey, tenant=tenant,
                                     bindings=bindings,
                                     cache_label=cache_label)
        else:
            with trace_lib.span("query.execute"):
                out = self._arbitrated_run(plan, bindings=bindings)
        summary = None
        if self._prov is not None:
            # captured BEFORE the cache insert, so the new entry's
            # stamp names this record's query id
            summary = self._prov_capture(
                "execute", key if key is not None else pkey, sla,
                rung=rung, expr=orig, result=out, executed=e, plan=plan)
        if rc:
            self._rc_insert(key, pins, e, out, orig=orig,
                            prec=_prec_prefix(sla), plan=plan,
                            prov=summary)
        return out

    def _compute_resilient(self, e: MatExpr, rc: bool, sla: str,
                           pol: RetryPolicy, should_abort=None,
                           tenant: Optional[str] = None) -> BlockMatrix:
        """The attempt loop: run the query; on a TRANSIENT failure
        retry with backoff, climbing one rung of the degradation ladder
        per retry (``resilience/degrade.py``; rung 4 also bypasses the
        result cache). Deterministic failures — a kernel that does not
        build or launch among them — exhausted attempts and expired
        deadlines propagate typed; a result delivered past the deadline
        raises too."""
        deadline = pol.deadline()
        attempt = 0
        rung = 0
        while True:
            deadline.raise_if_expired()
            try:
                with trace_lib.activate(self._tracer), \
                        trace_lib.span("query", root_kind=e.kind,
                                       attempt=attempt, rung=rung):
                    out = self._compute_observed(
                        e, rc and rung < degrade_lib.RC_BYPASS_RUNG,
                        sla, rung=rung, tenant=tenant)
                deadline.raise_if_expired()
                return out
            except Exception as ex:
                self._emit_fault_event(ex, scope="query")
                if not pol.should_retry(ex, attempt):
                    raise
                attempt += 1
                rung, escalated = degrade_lib.next_rung(rung)
                self._emit_retry_event(ex, attempt, rung, scope="query")
                if escalated:
                    self._emit_degrade_event(rung, ex, scope="query")
                pol.backoff_sleep(attempt, deadline,
                                  should_abort=should_abort)

    @_in_turn
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

        The underscore parameters are the serve pipeline's channel into
        the ``serve`` / ``query`` obs records: per-query queue waits,
        the in-flight depth, per-query tenants and the brownout rung the
        batch was admitted under."""
        es = [as_expr(x) for x in exprs]
        if not es:
            return []
        if _tenants is None and tenant:
            _tenants = [tenant] * len(es)
        sla = self._resolve_sla(precision)
        pol = RetryPolicy.from_config(self.config, deadline_ms)
        if pol is not None:
            return self._run_many_resilient(
                es, sla, pol, _queue_wait_ms, _inflight_depth,
                _tenants=_tenants, _brownout_rung=_brownout_rung)
        rc = self._rc_enabled()
        obs = self._obs_enabled()
        with trace_lib.activate(self._tracer), \
                trace_lib.span("serve.batch", size=len(es)) as sp_batch:
            return self._run_many_observed(
                es, rc, obs, sp_batch, _queue_wait_ms, _inflight_depth,
                sla, _tenants=_tenants, _brownout_rung=_brownout_rung)

    def _run_many_resilient(self, es, sla: str, pol: RetryPolicy,
                            _queue_wait_ms=None, _inflight_depth: int = 0,
                            should_abort=None, _tenants=None,
                            _brownout_rung: Optional[int] = None
                            ) -> List[BlockMatrix]:
        """The batch twin of :meth:`_compute_resilient`: the whole
        MultiPlan retries as one unit, climbing the same ladder."""
        deadline = pol.deadline()
        attempt = 0
        rung = 0
        while True:
            deadline.raise_if_expired(context="batch")
            rc = self._rc_enabled() and rung < degrade_lib.RC_BYPASS_RUNG
            obs = self._obs_enabled()
            try:
                with trace_lib.activate(self._tracer), \
                        trace_lib.span("serve.batch", size=len(es),
                                       attempt=attempt,
                                       rung=rung) as sp_batch:
                    outs = self._run_many_observed(
                        es, rc, obs, sp_batch, _queue_wait_ms,
                        _inflight_depth, sla, rung=rung,
                        _tenants=_tenants,
                        _brownout_rung=_brownout_rung)
                deadline.raise_if_expired(context="batch")
                return outs
            except Exception as ex:
                self._emit_fault_event(ex, scope="batch")
                if not pol.should_retry(ex, attempt):
                    raise
                attempt += 1
                rung, escalated = degrade_lib.next_rung(rung)
                self._emit_retry_event(ex, attempt, rung, scope="batch")
                if escalated:
                    self._emit_degrade_event(rung, ex, scope="batch")
                pol.backoff_sleep(attempt, deadline,
                                  should_abort=should_abort)

    def _run_many_observed(self, es, rc: bool, obs: bool, sp_batch,
                           _queue_wait_ms, _inflight_depth,
                           sla: Optional[str] = None, rung: int = 0,
                           _tenants=None,
                           _brownout_rung: Optional[int] = None
                           ) -> List[BlockMatrix]:
        sla = sla if sla is not None else self.config.precision_sla

        def _tenant_of(i):
            return (_tenants[i] if _tenants is not None
                    and i < len(_tenants) else None)
        results: Dict[int, BlockMatrix] = {}
        rc_meta: dict = {}
        pend: list = []
        for i, e in enumerate(es):
            orig = e
            if rc:
                with trace_lib.span("rc.probe", index=i) as sp:
                    ent, key, pins, e = self._rc_admit(
                        e, self._rc_key_prefix(sla))
                    sp.set(hit=ent is not None)
                if ent is not None:
                    results[i] = ent.result
                    if obs:
                        try:
                            self._emit_rc_hit_event(
                                e, key, ent.result, tenant=_tenant_of(i))
                        except Exception:
                            log.warning("obs: query event dropped",
                                        exc_info=True)
                    if self._prov is not None:
                        self._prov_capture("rc_hit", key, sla, rung=rung,
                                           ent=ent)
                    continue
                rc_meta[i] = (key, pins, orig)
            pend.append((i, e))
        execute_ms = 0.0
        plan_hit = None
        cse_hoisted = 0
        tpl_hit = False
        if pend:
            if self._cse_on() and len(pend) > 1:
                pend, cse_hoisted = self._cse_hoist_batch(pend, sla, rung,
                                                          rc)
            bindings = None
            with trace_lib.span("plan", roots=len(pend)):
                tpl = (self._template_probe_multi(
                    [e for _, e in pend], sla, rung)
                    if self._cse_on() else None)
                if tpl is not None:
                    plan, keys, pos, bindings = tpl
                    plan_hit = tpl_hit = True
                else:
                    plan, plan_hit, keys = self._compile_multi_entry(
                        [e for _, e in pend], sla=sla, rung=rung)
                    pos = {k: j for j, k in enumerate(plan._root_keys)}
                    if self._cse_on() and not plan_hit:
                        self._template_insert_multi(plan, sla, rung)
            # fault site "execute" — per batch attempt (host side)
            faults_lib.check("execute", self.config)
            # the batch's execute span: host clock, no device sync
            with trace_lib.span("serve.execute",
                                executed=len(pend)) as sp_ex:
                outs = self._arbitrated_run(plan, bindings=bindings)
            if obs:
                execute_ms = sp_ex.dur_ms or 0.0
            first = not getattr(plan, "_obs_executed", False)
            plan._obs_executed = True
            for j, ((i, e), k) in enumerate(zip(pend, keys)):
                out = outs[pos[k]]
                results[i] = out
                summary = None
                if self._prov is not None:
                    if rc:
                        p_key, _p, p_orig = rc_meta[i]
                    else:
                        p_key, p_orig = k, e
                    summary = self._prov_capture(
                        "execute", p_key, sla, rung=rung, expr=p_orig,
                        result=out, executed=e, plan=plan,
                        strategies=executor_lib.multiplan_root_decisions(
                            plan)[pos[k]])
                if rc:
                    key, pins, orig = rc_meta[i]
                    self._rc_insert(key, pins, e, out, orig=orig,
                                    prec=_prec_prefix(sla), plan=plan,
                                    prov=summary)
                if obs:
                    try:
                        per_root = executor_lib.multiplan_root_decisions(
                            plan)
                        self._emit_query_event(
                            e, plan, bool(plan_hit), k,
                            execute_ms / max(len(pend), 1), first, out,
                            matmuls=per_root[pos[k]],
                            # one root carries the batch's compile-time
                            # rule hits; the rest {}
                            rule_hits=({} if (j > 0 or plan_hit)
                                       else (plan.meta or {}).get(
                                           "rule_hits", {})),
                            batch={"size": len(es), "index": i},
                            tenant=_tenant_of(i),
                            cache_label=("template_hit" if tpl_hit
                                         else None))
                    except Exception:
                        log.warning("obs: query event dropped",
                                    exc_info=True)
            if obs:
                try:
                    self._emit_verify_event(plan)
                except Exception:
                    log.warning("obs: verify event dropped",
                                exc_info=True)
        if obs:
            try:
                record = {
                    "batch_size": len(es),
                    "executed": len(pend),
                    "rc_hits": len(es) - len(pend),
                    "plan_cache_hit": plan_hit,
                    "queue_wait_ms": _queue_wait_ms,
                    "inflight_depth": _inflight_depth,
                    "execute_ms": round(execute_ms, 3),
                    "wall_ms": round(sp_batch.elapsed_ms() or 0.0, 3),
                }
                if _tenants is not None:
                    census: dict = {}
                    for t in _tenants:
                        census[t or ""] = census.get(t or "", 0) + 1
                    record["tenants"] = census
                if _brownout_rung:
                    record["brownout_rung"] = _brownout_rung
                if self._cse_on():
                    record["cse_hoisted"] = cse_hoisted
                    record["template_hits"] = (len(pend) if tpl_hit
                                               else 0)
                self._emit_serve_event(record)
            except Exception:
                log.warning("obs: serve event dropped", exc_info=True)
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
        (``config.serve_tenant_weights``).

        With ``config.fleet_slices >= 1`` the submission routes through
        the multi-slice serving fleet (``serve/fleet.py``): placement
        decides slice-local vs spanning execution, the directory answers
        repeats from any slice's cache, and a dead slice's queue fails
        over. The default (0) runs the single-session pipeline.

        On a rank mesh every rank submits the same queries in the same
        order; the lead rank decides each admission cycle and every
        rank applies it (``serve/ranklog.py``), so a shed or a
        ``RankDivergence`` arrives on the future."""
        e = as_expr(expr)
        if deadline_ms is None and self.config.deadline_ms > 0:
            deadline_ms = self.config.deadline_ms
        sla = self._resolve_sla(precision, e)
        if self.config.fleet_slices >= 1:
            return self._ensure_fleet().submit(
                e, sla, deadline_ms=deadline_ms, tenant=tenant,
                staleness_ms=staleness_ms)
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

    def _ensure_fleet(self):
        """This session's (lazily built) fleet controller — built under
        the lock, as the pipeline is."""
        if self._fleet is None:
            from matrel_tpu_torch.serve.fleet import FleetController
            with self._compile_lock:
                if self._fleet is None:
                    self._fleet = FleetController(self)
        return self._fleet

    def _submit_pipeline(self, e: MatExpr, sla: str,
                         deadline_ms: Optional[float] = None,
                         tenant: Optional[str] = None,
                         staleness_ms: Optional[float] = None):
        """The single-session admission path — also the fleet's SPAN
        executor (a span-placed query is one program over the full
        mesh, i.e. exactly this pipeline)."""
        return self._ensure_serve().submit(e, sla,
                                           deadline_ms=deadline_ms,
                                           tenant=tenant,
                                           staleness_ms=staleness_ms)

    @_in_turn
    def fleet_info(self) -> Optional[dict]:
        """Fleet snapshot (None when the fleet is off or not yet built):
        per-slice state, directory counters, placement census,
        migration and failover counts."""
        return self._fleet.info() if self._fleet is not None else None

    def serve_drain(self, timeout: Optional[float] = None) -> None:
        """Block until every submitted query is dispatched and every
        dispatched batch has finished on the device. ``timeout``
        (seconds) bounds the wait: a wedged worker raises the typed
        ``DrainTimeout``, the queue untouched. ONE absolute deadline
        spans the fleet and the parent pipeline."""
        t_end = None if timeout is None else retry_lib.now() + timeout
        if self._fleet is not None:
            self._fleet.drain(timeout=retry_lib.deadline_left(t_end))
        if self._serve is not None:
            self._serve.drain(timeout=retry_lib.deadline_left(t_end))

    def serve_close(self, timeout: Optional[float] = None) -> None:
        """Drain, then stop the admission worker; a later ``submit``
        raises the typed ``PipelineClosed``. Also stops the metrics
        endpoint when one runs (a GC finalizer covers sessions that
        are simply dropped), even when the drain times out. ONE
        absolute deadline spans the fleet and the parent; every slice
        and the parent are closed before the first failure
        propagates."""
        t_end = None if timeout is None else retry_lib.now() + timeout
        try:
            if self._fleet is not None:
                self._fleet.close(timeout=retry_lib.deadline_left(t_end))
        finally:
            try:
                if self._serve is not None:
                    self._serve.close(
                        timeout=retry_lib.deadline_left(t_end))
            finally:
                if self._exporter is not None:
                    self._exporter.stop()

    @_in_turn
    def explain(self, expr: MatExpr, physical: bool = True,
                analyze: bool = False,
                precision: Optional[str] = None) -> str:
        """Logical and optimized plan text; with ``physical`` the
        expression is compiled (cached), so the optimized section
        carries the chosen matmul strategies.

        ``analyze=True`` (or ``config.obs_level == "analyze"``) RUNS the
        plan once per op — each node bracketed by device syncs and timed
        exclusive of its children — plus one warm run of the plan as the
        session runs it, and appends the measured tree beside the
        planner's estimates (``obs/analyze.py``). With obs on it also
        emits one ``analyze`` event (the drift auditor's feed). Off the
        hot path: nothing is measured, and nothing synced, unless
        asked."""
        e = as_expr(expr)
        if not physical:
            if analyze:
                raise ValueError(
                    "explain(analyze=True) requires physical=True")
            return e.explain(self.config)
        from matrel_tpu_torch.ir.expr import pretty
        head = "== Logical plan ==\n" + pretty(e)
        plan = self.compile(e, precision=precision)
        text = head + "\n" + plan.explain()
        # the static verifier's findings next to the physical plan they
        # describe: the compile-time diagnostics when the verify_plans
        # gate produced them, else the passes run here (off the hot
        # path) against the PLAN's config, so a per-query SLA is
        # verified against the SLA the plan compiled under (MV108)
        try:
            from matrel_tpu_torch import analysis
            diags = (plan.meta or {}).get("diagnostics")
            if diags is None:
                diags = analysis.verify_plan(plan.optimized, self.mesh,
                                             plan.config)
            else:
                diags = [analysis.Diagnostic(**d) for d in diags]
            text += "\n== Verifier ==\n" + analysis.render(diags)
        except Exception as ex:     # verification must not fail EXPLAIN
            text += f"\n== Verifier unavailable: {ex!r} =="
        if analyze or self.config.obs_level == "analyze":
            from matrel_tpu_torch.obs import analyze as analyze_mod
            try:
                per_op, _total = analyze_mod.measure_per_op(plan)
                fused = analyze_mod.measure_fused(plan)
                text += "\n" + analyze_mod.render(plan, per_op, fused)
                if self._obs_enabled():
                    try:
                        self._obs_emit("analyze",
                                       analyze_mod.analyze_record(
                                           plan, per_op, fused))
                    except Exception:
                        log.warning("obs: analyze event dropped",
                                    exc_info=True)
            except Exception as ex:   # analysis must not fail EXPLAIN
                text += f"\n== Analysis unavailable: {ex!r} =="
        return text

    def sql(self, query: str) -> MatExpr:
        """SQL-ish entry point over the registered matrix tables (see
        ``sql.py`` for the grammar); malformed input raises
        ``SqlError``."""
        from matrel_tpu_torch.sql import parse_sql
        return parse_sql(query, self)

    def explain_sql(self, query: str, analyze: bool = False) -> str:
        """Plan text for a SQL query (strategies, join schemes and
        value-join kinds included); ``analyze=True`` appends the
        measured per-op tree (EXPLAIN ANALYZE)."""
        return self.explain(self.sql(query), analyze=analyze)


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
