"""Multi-slice serving fleet — the counterpart of
``matrel_tpu/serve/fleet.py``, the scale-out tier over the serve plane.

One session, ``config.fleet_slices`` serving SLICES: the session mesh
partitions into slice meshes (``core/mesh.slice_meshes``) and each slice
owns a full serve plane of its own — admission queue, worker thread,
brownout state, SLO monitors and a slice-local result cache — carried by
a per-slice :class:`~matrel_tpu_torch.session.MatrelSession`. On one card
a slice is a session on the parent's device: ``"shared"`` on the 1x1
grid (every slice is the parent mesh, catalog tables shared), or a
near-square sub-grid of the virtual grid (``"virtual"``, the form the
CPU tests run on, tables rebuilt on the sub-grid through the host).
``session.submit`` becomes a ROUTING decision:

- **Placement** (``serve/placement.py``): whole query to one slice vs
  spanning the full mesh, decided by the topology weights; span-placed
  queries carry a ``placement`` stamp MV114 verifies.
- **Directory**: a catalog-NAME keyed map of each cached plan key to its
  owning slice — a hit anywhere in the fleet answers from the owner's
  slice-local cache without recompute (0 kernel launches). The
  directory is an affinity hint, never a correctness surface.
- **Hot-entry replication**: sustained remote demand
  (``config.fleet_replicate_hits``) copies an entry into the demanding
  slice through the host, priced through the reshard planner under
  ``reshard_peak_budget_bytes`` and stamped for MV114.
- **Catalog replication**: tables replicate per slice at construction
  and on every later ``register`` (a rebind re-replicates and
  invalidates slice caches and directory records).
- **Failover**: a dead or wedged slice's queued entries re-admit onto
  surviving slices — futures, deadlines and tenants intact — and every
  refusal is typed (``FleetSliceLost`` / ``AdmissionShed`` /
  ``DeadlineExceeded``).

The slices share one card and one execution lock (``fleet.exec``):
``session._arbitrated_run`` runs a plan to completion under it, so two
slices' programs are never in flight together. Off by default
(``fleet_slices=0``): ``submit`` runs the single-session pipeline and no
fleet object is built.

**On a rank mesh** a slice is a group of ranks: ``slice_meshes`` cuts
the world into contiguous row-major runs ("virtual", each with its own
world, x, y and control groups), or every slice is the whole world when
the count does not divide it ("shared"). Each rank holds every slice's
session; only the slice's own ranks hold its tables, its cache and its
pipeline. Every fleet choice rides the router's decision log
(``serve/ranklog.py``), one item a record in submission order: the
lead rank decides placement and the directory candidates, the ranks
report whether the candidate slices' ranks hold the cached entry, and
every rank applies the same hit, miss, route, migration and
``kill_slice``.

**Slices serve at the same time.** A slice-placed query is filed, at
its record, into its slice's own pipeline on the slice's ranks only,
under the sequence number the record assigned; that pipeline's worker
decides its cycles on the slice's control group, its first rank the
lead, so one slice computes while the others compute too and the
router goes on routing. Its answer keeps the one-card contracts (a
queued or late deadline fails typed, never a late answer; a transient
failure retries; an open breaker fails fast; the brownout rung
downshifts or serves stale; a failed batch raises the same typed error
on every rank of the slice), and is a :class:`SliceResult`: the value
lives on the slice, and ``to_numpy`` is a world collective (the slice
gathers it to its first rank, which broadcasts it). The slices agree
with the world at the router's next record: each slice's first rank
reports the outcomes finished since the last record and its queue
depth, so every rank outside the slice resolves its future (a
:class:`SliceResult` with no local value, or the same typed error,
rebuilt), a cached answer enters the directory, and placement reads
each slice's load as of that record. While an outcome is outstanding
the lead publishes an empty record every :data:`REPORT_EVERY_S`.
Counters (``placed``, ``pinned``, ``failovers``, ``requeued``, each
slice's ``submitted``, the directory) follow from the records, so
``fleet_info`` is the same on every rank. A span-placed query, a
migration and every collective entry point (``register``,
``to_numpy``) wait until every slice's pipeline on every rank has
drained (``RankGroups.held``), then run on the world. ``kill_slice``
closes the slice's pipeline at its record; the slice's lead takes the
entries it has not admitted and every rank re-admits them onto the
survivors by load, futures, deadlines and tenants intact (``requeued``
counts them), while entries already in a cycle complete normally.
Each slice's ranks probe their worker at every record, and a dead
worker with entries waiting and no stop asked fails the slice over
(``reason="wedged"``) on every rank at that record; ``check_health``
files an item so that a record happens. The queue bounds
(``serve_tenant_queue_max``, ``serve_queue_max``) apply to each slice's
admission queue, as one card's do, and to the router's store: the lead
sheds an item that finds its tenant's backlog, or the whole backlog, at
the bound, and the shed rides that item's record; every shed counts on
the parent's queue on every rank.

A "shared" slicing cannot overlap (every slice is the world), so there
the router drives the target pipeline's cycle itself, one item a
record (``ServePipeline.decide_routed`` / ``apply_routed``), with no
slice queue: placement sees every load as 0 and ``kill_slice``
re-admits nothing.

Tables reach a slice as a world gather of each rank's block
(``collectives.gather_full``) that the slice's ranks cut into their own
blocks, in the table's dtype (bf16 stays bf16); a block-sparse table
(its tile stack is whole on every rank already) and a COO table (a host
edge list) are taken as they are, so a slice-placed S·D runs B1 and a
slice-placed COO matvec B2 on the slice's ranks (on one card's grid
both stay pinned); a hot entry migrates as a dense table does, at its
record. ``register`` writes through in its turn (drain and hold).

Why the router is not the one-card routing on a one-rank log: on one
card ``submit`` routes in the caller's thread — a directory hit comes
back as an already-resolved future, a slice queue's ``AdmissionShed``
raises at the call, and every slice's worker batches its own queue
concurrently (``tests/test_torch_fleet.py`` holds these to the JAX
package). The router answers on its own thread, one item a record.
"""

from __future__ import annotations

import dataclasses
import hashlib
import itertools
import logging
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future
from typing import Dict, Optional

import torch

from matrel_tpu_torch.core import mesh as mesh_lib
from matrel_tpu_torch.resilience import retry as retry_lib
from matrel_tpu_torch.resilience.errors import (AdmissionShed,
                                                DeadlineExceeded,
                                                FleetSliceLost,
                                                PipelineClosed,
                                                RankDivergence)
from matrel_tpu_torch.serve import pipeline as pipeline_lib
from matrel_tpu_torch.serve import placement as placement_lib
from matrel_tpu_torch.serve import ranklog
from matrel_tpu_torch.serve.result_cache import CacheEntry, result_nbytes
from matrel_tpu_torch.utils import lockdep

log = logging.getLogger("matrel_tpu_torch.serve.fleet")


#: How often the rank mesh's router publishes an empty record while a
#: slice-placed item's outcome is outstanding (seconds).
REPORT_EVERY_S = 0.01
#: The most items the router decides in one record.
ROUTE_BATCH = 16


def _fail(fut: Future, ex: BaseException) -> None:
    if not fut.done() and (fut.running()
                           or fut.set_running_or_notify_cancel()):
        fut.set_exception(ex)


def _resolve(fut: Future, value, ready_event=None) -> None:
    if not fut.done() and (fut.running()
                           or fut.set_running_or_notify_cancel()):
        fut.ready_event = ready_event
        fut.set_result(value)


_remaining = retry_lib.deadline_left


class SliceResult:
    """A slice-placed answer on a rank mesh. Its value lives on the
    slice's ranks: ``local`` is the BlockMatrix there (None on a rank
    outside the slice). ``to_numpy`` is a world collective every rank
    calls, in its turn: the slice gathers the value and its first rank
    broadcasts it to the world."""

    def __init__(self, world_mesh, slice_mesh, local):
        self.world_mesh = world_mesh
        self.slice_mesh = slice_mesh
        self.local = local

    def to_numpy(self):
        from matrel_tpu_torch.parallel import collectives as coll
        with self.world_mesh.ranks.held():
            host = (self.local.to_numpy() if self.local is not None
                    else None)
            return coll.broadcast_object(
                host, self.world_mesh,
                src=self.slice_mesh.ranks.members[0])


class _SliceRoute:
    """A slice pipeline's hooks on a rank mesh
    (``ServePipeline.route``): its answers are :class:`SliceResult`
    values. ``keys`` maps a routed item's sequence number to the
    expression and SLA it was routed with (the slice's cache key at
    routing), ``infos`` to what the slice's ranks cached of its answer
    (cached?, bytes, layout, dtype), until the fleet reads it."""

    def __init__(self, fleet, sl):
        self.fleet = fleet
        self.sl = sl
        self.keys: Dict[int, tuple] = {}
        self.infos: Dict[int, tuple] = {}

    def wrap(self, out):
        return SliceResult(self.fleet.session.mesh, self.sl.session.mesh,
                           out)

    def info(self, batch, outs) -> list:
        return [self.fleet._entry_info(
            self.sl, *self.keys.get(it[pipeline_lib.SEQ], (it[0], it[3])),
            o) for it, o in zip(batch, outs)]

    def served(self, batch, info, late) -> None:
        """``info`` is the slice lead's; a late answer records none."""
        for it, inf in zip(batch, info or ()):
            if it[pipeline_lib.SEQ] not in late:
                self.infos[it[pipeline_lib.SEQ]] = inf


# ---------------------------------------------------------------------------
# Directory — plan key -> owning slice, hit-anywhere protocol
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class DirectoryRecord:
    """One fleet-keyed entry's ownership record. ``owner_key`` is the
    owning slice's LOCAL result-cache key (its session's id-based
    structural key + tier prefix) — what the fleet looks up in the
    owner's cache on a hit; ``replicas`` maps additional slice ids to
    their local keys after hot-entry replication; ``hits`` counts
    per-slice demand (the replication trigger); ``dep_names`` are the
    catalog names the entry depends on (the rebind-invalidation
    set)."""

    owner: int
    owner_key: str
    nbytes: int
    layout: str
    dtype: str
    dep_names: frozenset
    hits: Dict[int, int] = dataclasses.field(default_factory=dict)
    replicas: Dict[int, str] = dataclasses.field(default_factory=dict)
    #: slices whose migration of THIS record priced out of the reshard
    #: peak budget — memoized so the hottest keys don't re-run
    #: compile_reshard and emit one migrate_priced_out event per
    #: remote hit forever. Dies with the record (rebind, ownership
    #: move), so a changed entry re-prices.
    priced_out: set = dataclasses.field(default_factory=set)


class FleetDirectory:
    """Bounded LRU map of fleet structural keys to
    :class:`DirectoryRecord` — thread-safe; counters feed the
    ``fleet`` obs surface and ``history --summary``."""

    def __init__(self, max_entries: int):
        self.max_entries = max(int(max_entries), 1)
        self._lock = lockdep.make_lock("fleet.directory")
        self._records: "OrderedDict[str, DirectoryRecord]" = \
            OrderedDict()
        self.inserts = 0
        self.hits = 0
        self.remote_hits = 0
        self.misses = 0
        self.evicted = 0
        self.invalidated = 0
        self.stale_inserts = 0
        #: registration generation — bumped under the lock on every
        #: name invalidation / slice drop. An insert for a query that
        #: was ROUTED before the bump is stale (its result was
        #: computed from the old binding) and must not be recorded:
        #: the name-keyed fleet key would otherwise serve the old
        #: value to queries built from the new binding.
        self.reg_gen = 0
        #: restored demand hints (``seed_hits``): per-key historical
        #: hit counts carried across a restart by save_state/restore
        #: (serve/spill.py). NEVER inserted as records — a restored
        #: owner key points at a cache that no longer exists, and
        #: lookup would drop-and-recompute exactly the hot keys. The
        #: first fresh record_insert per key merges its history in,
        #: so the replication trigger (``fleet_replicate_hits``)
        #: re-arms at pre-restart demand instead of from zero. Pure
        #: affinity hint — never a correctness surface.
        self._seed_hits: Dict[str, Dict[int, int]] = {}

    def lookup(self, key: str) -> Optional[DirectoryRecord]:
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                self.misses += 1
                return None
            self._records.move_to_end(key)
            return rec

    def peek(self, key: str) -> Optional[DirectoryRecord]:
        """The record for ``key``, counting nothing (the lead rank's
        decision; every rank then applies the counted lookup)."""
        with self._lock:
            return self._records.get(key)

    def record_insert(self, key: str, rec: DirectoryRecord,
                      expected_gen: Optional[int] = None) -> None:
        with self._lock:
            if (expected_gen is not None
                    and expected_gen != self.reg_gen):
                # a catalog rebind (or slice drop) ran between this
                # query's routing and its completion: the result was
                # computed from the OLD binding, and recording it
                # under the name-keyed fleet key would serve it to
                # queries built from the NEW one — drop the record
                # (the entry itself is id-keyed dead weight in its
                # slice's LRU, unreachable through the fleet)
                self.stale_inserts += 1
                return
            seeded = self._seed_hits.pop(key, None)
            if seeded:
                # restored demand history ADDS to the fresh insert's
                # own counts — a hint re-arms the replication trigger
                # at pre-restart demand, it never erases a live hit
                for sid, n in seeded.items():
                    rec.hits[sid] = rec.hits.get(sid, 0) + n
            old = self._records.pop(key, None)
            if old is not None:
                # ownership moved (owner evicted its copy and another
                # slice recomputed): keep demand history, drop stale
                # replica claims on the new owner's slot
                rec.hits.update(old.hits)
            self._records[key] = rec
            self.inserts += 1
            while len(self._records) > self.max_entries:
                self._records.popitem(last=False)
                self.evicted += 1

    def record_hit(self, key: str, asking_slice: int,
                   remote: bool) -> None:
        with self._lock:
            rec = self._records.get(key)
            if rec is None:
                return
            rec.hits[asking_slice] = rec.hits.get(asking_slice, 0) + 1
            self.hits += 1
            if remote:
                self.remote_hits += 1

    def drop(self, key: str) -> None:
        with self._lock:
            if self._records.pop(key, None) is not None:
                self.invalidated += 1

    def invalidate_name(self, name: str) -> int:
        """Drop every record depending on a rebound catalog name —
        the directory face of the result cache's rebind
        invalidation."""
        with self._lock:
            self.reg_gen += 1
            stale = [k for k, r in self._records.items()
                     if name in r.dep_names]
            for k in stale:
                del self._records[k]
            self.invalidated += len(stale)
            return len(stale)

    def drop_slice(self, slice_id: int) -> int:
        """A dead slice owns nothing: drop its records, strip its
        replica claims."""
        with self._lock:
            self.reg_gen += 1
            stale = [k for k, r in self._records.items()
                     if r.owner == slice_id]
            for k in stale:
                del self._records[k]
            for r in self._records.values():
                r.replicas.pop(slice_id, None)
                r.hits.pop(slice_id, None)
            self.invalidated += len(stale)
            return len(stale)

    def mark_priced_out(self, key: str, slice_id: int) -> None:
        """Memoize one slice's priced-out migration verdict on the
        CURRENT record (under the lock — the record_hit mutation
        discipline). A later record under the same key starts
        clean."""
        with self._lock:
            rec = self._records.get(key)
            if rec is not None:
                rec.priced_out.add(slice_id)

    def drop_replica(self, key: str, slice_id: int) -> None:
        """Strip ONE slice's replica claim (its copy was evicted or
        its slice died) without touching the owner's record — the
        hit-anywhere protocol falls back to the owner."""
        with self._lock:
            rec = self._records.get(key)
            if rec is not None:
                rec.replicas.pop(slice_id, None)

    def claim_replica(self, key: str, slice_id: int,
                      local_key: str,
                      expected_gen: Optional[int] = None) -> bool:
        """Attach a replica claim to the CURRENT record for ``key`` —
        under the lock, so a claim staged against a record the
        directory replaced or evicted mid-migration lands nowhere
        (the caller then reclaims the orphaned cache entry) instead
        of on a discarded object the hit-anywhere protocol can never
        reach. ``expected_gen`` is the registration generation the
        migration was staged under (the ``record_insert`` idiom): a
        rebind between staging and claim means the copied value
        belongs to the OLD binding while the record now found under
        the key describes the NEW one — claiming would serve stale
        answers, so the claim refuses and the caller reclaims the
        replica."""
        with self._lock:
            if (expected_gen is not None
                    and expected_gen != self.reg_gen):
                self.stale_inserts += 1
                return False
            rec = self._records.get(key)
            if rec is None:
                return False
            rec.replicas[slice_id] = local_key
            return True

    def export_state(self) -> list:
        """JSON-safe demand snapshot for save_state (serve/spill.py):
        per-key total hit history plus the cosmetic record fields a
        restore summary reports. Local owner keys are deliberately
        NOT exported — they are id-based and die with the process."""
        with self._lock:
            out = []
            for key, rec in self._records.items():
                out.append({
                    "key": key,
                    "nbytes": int(rec.nbytes),
                    "layout": rec.layout,
                    "dtype": rec.dtype,
                    "dep_names": sorted(rec.dep_names),
                    "hits": {str(s): int(n)
                             for s, n in rec.hits.items()},
                })
            # not-yet-consumed hints from a previous restore carry
            # forward (restart-of-a-restart)
            for key, hits in self._seed_hits.items():
                out.append({"key": key, "hits": {str(s): int(n)
                                                 for s, n in
                                                 hits.items()}})
            return out

    def seed_hints(self, records) -> int:
        """Install restored demand hints (see ``_seed_hits``).
        Bounded by ``max_entries``; malformed rows are skipped — a
        snapshot is never a correctness surface."""
        installed = 0
        with self._lock:
            for rec in records:
                if len(self._seed_hits) >= self.max_entries:
                    break
                if not isinstance(rec, dict):
                    continue
                key = rec.get("key")
                hits = rec.get("hits")
                if not isinstance(key, str) or not isinstance(
                        hits, dict):
                    continue
                slot = self._seed_hits.setdefault(key, {})
                for sid, n in hits.items():
                    try:
                        slot[int(sid)] = (slot.get(int(sid), 0)
                                          + int(n))
                    except (TypeError, ValueError):
                        continue
                installed += 1
        return installed

    def info(self) -> dict:
        with self._lock:
            return {"entries": len(self._records),
                    "max_entries": self.max_entries,
                    "inserts": self.inserts,
                    "hits": self.hits,
                    "remote_hits": self.remote_hits,
                    "misses": self.misses,
                    "evicted": self.evicted,
                    "invalidated": self.invalidated,
                    "stale_inserts": self.stale_inserts,
                    "seed_hints": len(self._seed_hits)}


# ---------------------------------------------------------------------------
# Slices
# ---------------------------------------------------------------------------


class FleetSlice:
    """One serving slice: a full :class:`MatrelSession` on the
    slice's sub-mesh (its own plan cache, result cache, admission
    queue, worker, brownout/SLO state) plus fleet-side bookkeeping.
    ``names_by_id`` maps this slice's replica matrix ids back to
    catalog names — the failover rebind's source vocabulary."""

    def __init__(self, slice_id: int, session):
        self.slice_id = slice_id
        self.session = session
        self.alive = True
        self.submitted = 0
        self.names_by_id: Dict[int, str] = {}
        ranks = session.mesh.ranks
        #: does this process hold a cell of the slice? (always off a
        #: rank mesh)
        self.member = ranks is None or ranks.member

    @property
    def devices(self) -> int:
        """The slice's grid cells (the JAX package's device count)."""
        return self.session.mesh.size

    def queue_depth(self) -> int:
        """Entries waiting in the slice's admission queue (on a rank
        mesh, the slice's first rank holds it)."""
        pipe = self.session._serve
        return pipe._q.qsize() if pipe is not None else 0

    def snapshot(self) -> dict:
        sess = self.session
        out = {"id": self.slice_id,
               "alive": self.alive,
               "devices": self.devices,
               "submitted": self.submitted,
               "queued": self.queue_depth()}
        if sess._rc_enabled():
            out["result_cache"] = sess._result_cache.info()
        if sess._slo is not None:
            out["slo"] = sess._slo.snapshot()
        if sess._brownout is not None:
            out["brownout"] = sess._brownout.snapshot()
        return out


# ---------------------------------------------------------------------------
# The controller
# ---------------------------------------------------------------------------


class FleetController:
    """The fleet plane of one session (built lazily on the first
    ``submit`` when ``config.fleet_slices >= 1``). The parent session
    stays the SPAN executor — full-mesh programs run through its own
    pipeline — while slice-placed queries route to per-slice
    sessions."""

    def __init__(self, session):
        from matrel_tpu_torch.session import MatrelSession
        self.session = session
        self.config = session.config
        n = int(self.config.fleet_slices)
        meshes, source = mesh_lib.slice_meshes(session.mesh, n)
        self.source = source
        # per-slice sessions: same knobs as the parent except the
        # recursion/port hazards — a slice must never build its own
        # fleet, and two slices must never race one metrics port
        slice_cfg = self.config.replace(fleet_slices=0,
                                        obs_metrics_port=0,
                                        mesh_shape=None)
        # execution arbitration: the parent's span programs and every
        # slice's programs share one card. ONE RLock serializes
        # dispatch-to-completion across the fleet
        # (session._arbitrated_run), so one slice's program never runs
        # into another's memory peak or timing; cache/directory hits,
        # planning and admission never take it.
        self._exec_lock = lockdep.make_rlock("fleet.exec", dispatch_ok=True)
        session._exec_lock = self._exec_lock
        self.slices = []
        for i, m in enumerate(meshes):
            s = MatrelSession(mesh=m, config=slice_cfg)
            s._slice_tag = i
            s._exec_lock = self._exec_lock
            self.slices.append(FleetSlice(i, s))
        self.directory = FleetDirectory(self.config.fleet_directory_max)
        self._lock = lockdep.make_rlock("fleet.controller")
        # registration plane: serializes on_register end-to-end
        # (map surgery + directory invalidation + re-replication) so
        # two rebinds of one name cannot interleave, WITHOUT holding
        # the controller lock across _replicate's device->host
        # staging — that hold span stalled kill_slice/failover and
        # every controller-lock reader behind a host transfer (the
        # drain-wedge class). Never taken while _lock is held.
        # dispatch_ok: holding it across _replicate's transfers is
        # the lock's entire purpose — only rebinds contend on it.
        self._reg_lock = lockdep.make_lock("fleet.registration",
                                           dispatch_ok=True)
        self._repl_inflight: set = set()
        self._repl_threads: list = []
        self._rr = itertools.count()
        self._names: Dict[int, str] = {}     # parent matrix id -> name
        self.placed = {"slice": 0, "span": 0}
        self.pinned = 0
        self.migrations = 0
        self.migrations_priced_out = 0
        self.failovers = 0
        self.requeued = 0
        # the rank mesh's router: the decision log, one store of items
        # by sequence number, and the lead's sheds of items that found
        # the backlog at its bound (by sequence number)
        self._log = None
        if session.mesh.ranked:
            self._log = ranklog.DecisionLog(session.mesh)
            self.control = self._log.group
            self._seq = itertools.count()
            self._items = ranklog.EntryStore(pipeline_lib.SEQ)
            self._router: Optional[threading.Thread] = None
            self._stop = threading.Event()
            self._rr_count = 0
            self._sheds: Dict[int, tuple] = {}
            #: slices of their own ranks serve at the same time, each
            #: through its pipeline; "shared" slices are the world
            #: itself, and the router drives them one item a cycle
            self._concurrent = source != "shared"
            #: slice-placed items whose outcome is outstanding:
            #: sequence number -> (item, holding slice id, fleet key,
            #: the directory's registration generation at routing)
            self._routed: Dict[int, tuple] = {}
            #: each slice lead's (queued, busy) at the last record, and
            #: what the records since routed to each slice
            self._depth: Dict[int, tuple] = {}
            self._since: Dict[int, int] = {}
            #: outcomes of the slice this rank leads, not yet reported:
            #: (sequence number, error record or None, cached info)
            self._outbox: list = []
            self._outbox_lock = lockdep.make_lock("fleet.outbox")
        for name in sorted(session.catalog):
            self._replicate(name, session.catalog[name])

    # -- catalog replication ----------------------------------------------

    def _replicate(self, name: str, matrix) -> None:
        """Replicate one catalog table into every slice (the
        hot-read-only-table contract). Dense BlockMatrix tables
        rebuild on each slice's sub-mesh; anything else (sparse
        stacks, COO) is SHARED when the slice mesh is the parent mesh
        (degenerate/oversubscribed slices) and otherwise left
        unreplicated — queries touching it stay full-mesh ("pinned"
        placement), still correct."""
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix
        from matrel_tpu_torch.core.coo import COOMatrix
        from matrel_tpu_torch.core.sparse import BlockSparseMatrix
        self._names[id(matrix)] = name
        # host-stage lazily, on the first slice whose mesh differs
        # from the parent's: shared/solo partitions take the
        # share-the-object branch for every slice, and an eager
        # to_numpy() would bill a full device->host transfer per
        # table per register()/rebind for a copy nobody reads
        host = None
        host_failed = False
        replicated = False
        for sl in self.slices:
            if sl.session.mesh == self.session.mesh:
                replica = matrix
            elif self._log is not None and type(matrix) in (
                    BlockSparseMatrix, COOMatrix):
                # a tile stack is whole on every rank of a rank mesh, and
                # a COO edge list lives on the host: the slice's ranks
                # take them as they are
                replicated = True
                if not sl.member:
                    continue
                if type(matrix) is BlockSparseMatrix:
                    replica = dataclasses.replace(matrix,
                                                  mesh=sl.session.mesh)
                elif matrix._mesh is not None:
                    replica = matrix.shard(sl.session.mesh)
                else:
                    replica = matrix
            elif self._log is not None:
                if type(matrix) is not BlockMatrix:
                    continue           # pinned, as on one card
                if host is None:
                    # a world gather every rank joins; the slice's ranks
                    # cut their own blocks from it
                    host = matrix.to_numpy()
                replicated = True
                if not sl.member:
                    continue
                replica = BlockMatrix.from_numpy(
                    host, mesh=sl.session.mesh, config=sl.session.config,
                    dtype=matrix.dtype, integral=matrix.integral)
            else:
                if (host is None and not host_failed
                        and type(matrix) is BlockMatrix):
                    try:
                        host = matrix.to_numpy()
                    except Exception:
                        host_failed = True
                        log.warning(
                            "fleet: could not host-stage table %r; "
                            "queries over it pin to the full mesh",
                            name, exc_info=True)
                if host is None:
                    continue  # unreplicable on a real sub-mesh: pinned
                # the table's own dtype and integrality, not the slice
                # config's default dtype (the JAX package rebuilds a
                # bf16 table as f32)
                replica = BlockMatrix.from_numpy(
                    host, mesh=sl.session.mesh,
                    config=sl.session.config, dtype=matrix.dtype,
                    integral=matrix.integral)
            sl.session.register(name, replica)
            sl.names_by_id[id(replica)] = name
            replicated = True
        if not replicated:
            # NO slice holds a replica (sparse/COO table on real
            # sub-meshes, or a failed host stage): leaving the name
            # mapped would make every query over it fleet-eligible,
            # routed to a slice, and bounced through the KeyError
            # fallback — per submit, forever, recorded as the
            # transient "fallback" reason and never counted in the
            # pinned census. Unmapped, fleet_key returns None and the
            # query pins to the full mesh up front.
            del self._names[id(matrix)]

    def on_register(self, name: str, matrix) -> None:
        """Parent-catalog write-through: a (re)bound table
        re-replicates, slice caches invalidate through each slice
        session's own register() rebind path, and directory records
        depending on the name drop."""
        with self._reg_lock:
            with self._lock:
                stale = [i for i, nm in self._names.items()
                         if nm == name]
                for i in stale:
                    del self._names[i]
                for sl in self.slices:
                    # the per-slice reverse maps track the same
                    # binding: a rebind that leaves the old replica's
                    # id behind leaks one entry per slice per tick on
                    # a streaming host (the DeltaPlane._programs
                    # orphan class)
                    for i in [i for i, nm in sl.names_by_id.items()
                              if nm == name]:
                        del sl.names_by_id[i]
                # invalidate BEFORE replicating: _replicate's first
                # step maps the NEW matrix id to the name, so from
                # that moment a concurrent submit built from the new
                # binding resolves the same name-keyed fleet key as
                # the old record — a still-live record would answer
                # it with the OLD value (lookups don't take the
                # controller lock; the reg_gen bump here also drops
                # any old-binding insert in flight)
                self.directory.invalidate_name(name)
            # replicate OUTSIDE the controller lock: host staging is
            # a full device->host transfer per table — under _lock it
            # wedges every controller-lock reader (kill_slice,
            # failover, depth probes) behind the transfer. _reg_lock
            # still serializes rebinds of the same name end-to-end,
            # and _replicate's _names/names_by_id updates are single-
            # key dict ops (lock-free readers see either binding,
            # never a torn one).
            self._replicate(name, matrix)

    # -- helpers ------------------------------------------------------------

    def slice_by_id(self, slice_id: int) -> Optional[FleetSlice]:
        for sl in self.slices:
            if sl.slice_id == slice_id:
                return sl
        return None

    def live_slices(self):
        return [sl for sl in self.slices if sl.alive]

    def _rebind(self, e, target: FleetSlice,
                src_names: Optional[Dict[int, str]] = None):
        """Rebind a query's leaves onto ``target``'s catalog replicas
        (by name). ``src_names`` defaults to the parent-catalog map;
        failover passes the dead slice's own map. Raises KeyError on
        an unnamed/unreplicated leaf — callers treat that as
        placement-ineligible (or a typed failover refusal)."""
        names = src_names if src_names is not None else self._names

        def walk(n):
            if n.kind in ("leaf", "sparse_leaf", "coo_leaf"):
                m = n.attrs["matrix"]
                name = names.get(id(m))
                if name is None:
                    raise KeyError(n.kind)
                replica = target.session.catalog.get(name)
                if replica is None:
                    raise KeyError(name)
                return n if replica is m else n.with_attrs(
                    matrix=replica)
            if not n.children:
                return n
            new = tuple(walk(c) for c in n.children)
            return (n if all(a is b for a, b in zip(new, n.children))
                    else n.with_children(new))

        return walk(e)

    def _dep_names(self, e) -> frozenset:
        out = set()

        def walk(n):
            if n.kind in ("leaf", "sparse_leaf", "coo_leaf"):
                nm = self._names.get(id(n.attrs["matrix"]))
                if nm is not None:
                    out.add(nm)
                return
            for c in n.children:
                walk(c)

        walk(e)
        return frozenset(out)

    # -- submit routing ------------------------------------------------------

    def submit(self, e, sla: str = "default",
               deadline_ms: Optional[float] = None,
               tenant: Optional[str] = None,
               staleness_ms: Optional[float] = None) -> Future:
        from matrel_tpu_torch.session import _prec_prefix
        if self._log is not None:
            return self._enqueue(e, sla, deadline_ms, tenant,
                                 staleness_ms)
        self.check_health()
        live = self.live_slices()
        if not live:
            fut: Future = Future()
            fut.ready_event = None
            _fail(fut, FleetSliceLost(-1, "no live slices"))
            return fut
        # capture the registration generation BEFORE the key is built:
        # any rebind from here to completion makes this query's
        # eventual directory insert stale (record_insert drops it)
        reg_gen = self.directory.reg_gen
        fkey = placement_lib.fleet_key(e, self._names,
                                       _prec_prefix(sla))
        eligible = fkey is not None
        loads = {sl.slice_id: sl.queue_depth() for sl in live}
        rr = next(self._rr)
        preferred = placement_lib.pick_slice(loads, rr)
        # directory consult BEFORE the cost model: a hit anywhere in
        # the fleet answers without recompute, wherever placement
        # would have sent the query — the steady-state repeat path
        # pays the key walk and one lookup, never the FLOP/byte model
        if eligible:
            hit = self._directory_answer(e, fkey, sla, preferred,
                                         tenant=tenant)
            if hit is not None:
                return hit
        weights = mesh_lib.axis_weights(self.session.mesh, self.config)
        dec = placement_lib.decide(
            e, self.config, weights,
            total_devices=self.session.mesh.size,
            slice_devices=live[0].devices,
            slice_loads=loads,
            backend=self.session.mesh.device.type,
            sla=sla, eligible=eligible,
            rr_tick=rr)
        if dec.mode == "span":
            # census under the controller lock: submit runs
            # concurrently from many client threads and a bare
            # read-modify-write drops counts the artifacts report
            with self._lock:
                if dec.reason == "pinned":
                    self.pinned += 1
                self.placed["span"] += 1
            stamped = e.with_attrs(placement=dec.stamp())
            fut = self.session._submit_pipeline(
                stamped, sla, deadline_ms=deadline_ms, tenant=tenant,
                staleness_ms=staleness_ms)
            self._emit_placement(dec, fkey, "span", None)
            return fut
        sl = self.slice_by_id(dec.slice_id) or live[0]
        try:
            rebound = self._rebind(e, sl)
            fut = sl.session.submit(rebound, precision=sla,
                                    deadline_ms=deadline_ms,
                                    tenant=tenant,
                                    staleness_ms=staleness_ms)
        except (KeyError, PipelineClosed):
            # raced a rebind (KeyError: replica gone between
            # eligibility and routing) or a slice kill (PipelineClosed:
            # the slice's pipeline closed between the live check and
            # the enqueue — kill_slice flips it before stealing, so a
            # racing submit refuses typed here instead of stranding a
            # future in a stopped-worker queue): fall back to the
            # full-mesh session (always correct). NOT counted as
            # "pinned" (that is the un-rebindable-leaves census the
            # traffic artifact reports) and the record says what
            # happened: the cost model chose a slice, routing fell
            # back.
            with self._lock:
                self.placed["span"] += 1
            fut = self.session._submit_pipeline(
                e, sla, deadline_ms=deadline_ms, tenant=tenant,
                staleness_ms=staleness_ms)
            self._emit_placement(
                dataclasses.replace(dec, mode="span",
                                    reason="fallback"),
                fkey, "span", None)
            return fut
        with self._lock:
            sl.submitted += 1
            self.placed["slice"] += 1
        if eligible and sl.session._rc_enabled():
            self._track_insert(fkey, sl, e, rebound, sla, fut,
                               reg_gen)
        self._emit_placement(dec, fkey, "slice", sl.slice_id)
        return fut

    def _local_key(self, sl: FleetSlice, rebound, sla: str) -> str:
        from matrel_tpu_torch.session import _plan_key
        lk, _pins = _plan_key(rebound)
        return sl.session._rc_key_prefix(sla) + lk

    def _track_insert(self, fkey: str, sl: FleetSlice, orig, rebound,
                      sla: str, fut: Future,
                      reg_gen: Optional[int] = None) -> None:
        """Record directory ownership when the slice-placed query
        completes (and its slice cache therefore holds the result).
        ``reg_gen`` is the directory registration generation captured
        at routing — a rebind in flight bumps it and the insert drops
        (the completed result belongs to the OLD binding). The
        owner-key and dep-name walks run in the DONE callback (worker
        thread, at completion), not here: they are O(nodes) each and
        only needed on success — on the submit hot path they doubled
        the structural-walk count per admission. A rebind between
        routing and the late walks is covered by the same reg_gen
        drop (record_insert checks the gen before anything else)."""

        def _done(f: Future) -> None:
            try:
                if f.cancelled() or f.exception() is not None:
                    return
                out = f.result()
                owner_key = self._local_key(sl, rebound, sla)
                dep_names = self._dep_names(orig)
                if sl.session._result_cache.probe(owner_key) is None:
                    # the slice did NOT cache under the routing-time
                    # key — a brownout downshift re-keyed the entry
                    # (prec:fast| + stamp), or the insert was
                    # declined (byte budget). Recording ownership
                    # anyway would seed a dead record every later
                    # lookup drops and re-inserts (churn, and a
                    # cold-slice recompute per repeat under exactly
                    # the overload brownout exists for).
                    return
                from matrel_tpu_torch.ir import expr as expr_mod
                from matrel_tpu_torch.parallel import planner
                from matrel_tpu_torch.session import _dtype_name
                self.directory.record_insert(fkey, DirectoryRecord(
                    owner=sl.slice_id,
                    owner_key=owner_key,
                    nbytes=result_nbytes(out),
                    layout=planner._layout_of(expr_mod.leaf(out),
                                              sl.session.mesh),
                    dtype=_dtype_name(out.dtype),
                    dep_names=dep_names), expected_gen=reg_gen)
            except Exception:       # the never-fail obs/hint contract
                log.warning("fleet: directory insert dropped",
                            exc_info=True)

        fut.add_done_callback(_done)

    def _directory_answer(self, e, fkey: str, sla: str,
                          preferred: int,
                          tenant: Optional[str] = None
                          ) -> Optional[Future]:
        """The hit-anywhere protocol: when the directory knows an
        owning slice whose cache still holds the key, answer from it
        directly — zero compile, zero execute, wherever placement
        would have routed. ``preferred`` is the slice placement would
        pick (the shared :func:`placement.pick_slice` verdict — the
        cost model itself never runs on a hit): a replica there is
        preferred (that is what replication bought); sustained remote
        demand triggers :meth:`_maybe_replicate`. A served hit is an
        OK outcome for ``tenant``'s SLO objectives on the SERVING
        slice's plane — the steady-state repeat path is the fleet's
        best-performing one, and leaving it unaccounted would starve
        the availability windows of good events and read as burn."""
        t0 = time.perf_counter()  # matlint: disable=ML006 SLO resolution-latency sample — lands in the slo plane's sketches and alert records
        rec = self.directory.lookup(fkey)
        if rec is None:
            return None
        # serving-copy candidates, preference order: the replica on
        # the placement-preferred slice (what replication bought),
        # then the owner. A dead/evicted REPLICA only loses its own
        # claim — the owner's copy is still valid, and dropping the
        # whole record here would force a recompute of exactly the
        # entries hot enough to have been replicated (an
        # evict/recompute/re-replicate churn loop). Only a dead/
        # evicted OWNER copy invalidates the record.
        candidates = []
        if preferred in rec.replicas:
            candidates.append((preferred, rec.replicas[preferred]))
        candidates.append((rec.owner, rec.owner_key))
        ent, serving_id, key = None, rec.owner, rec.owner_key
        for sid, k in candidates:
            sl = self.slice_by_id(sid)
            alive = (sl is not None and sl.alive
                     and sl.session._rc_enabled())
            ent = sl.session._result_cache.lookup(k) if alive else None
            if ent is not None:
                serving_id, key = sid, k
                break
            if sid != rec.owner:
                self.directory.drop_replica(fkey, sid)
        if ent is None:
            # stale OWNER hint (evicted/invalidated/dead since) — one
            # recompute, never a wrong answer
            self.directory.drop(fkey)
            return None
        remote = serving_id != preferred
        self.directory.record_hit(fkey, preferred, remote)
        if self.session._prov is not None:
            # lineage on the PARENT ledger (the fleet-facing surface
            # the caller queries), with the SERVING slice's mesh and
            # SLA config — that is the configuration an audit replay
            # must reproduce the answer under
            sl = self.slice_by_id(serving_id)
            self.session._prov_capture(
                "fleet_replica" if ent.fleet is not None
                else "fleet_directory",
                key, sla, ent=ent,
                fleet={"owner": rec.owner, "serving": serving_id,
                       "remote": remote},
                mesh=sl.session.mesh,
                config=sl.session._sla_config(sla))
        fut: Future = Future()
        # the pipeline's future surface: the cached result finished on
        # the device when its own query did, so there is no event
        fut.ready_event = None
        fut.set_result(ent.result)
        slo = self.slice_by_id(serving_id).session._slo
        if slo is not None:
            slo.record_ok(tenant,
                          (time.perf_counter() - t0) * 1e3)  # matlint: disable=ML006 SLO resolution-latency sample — lands in the slo plane's sketches and alert records
        if remote:
            # AFTER the future resolves, and off-thread: replication
            # is a device->host->device copy of the whole entry — run
            # inline it would stall the hit fast path (whose entire
            # point is ~zero cost) for the duration of the migration
            self._maybe_replicate(e, fkey, rec, ent, sla,
                                  self.slice_by_id(preferred))
        self._emit_hit(fkey,
                       "directory_remote" if remote
                       else "directory", serving_id)
        return fut

    # -- hot-entry replication (priced through the reshard planner) --------

    def _maybe_replicate(self, e, fkey: str, rec: DirectoryRecord,
                         ent: CacheEntry, sla: str,
                         target: Optional[FleetSlice]) -> None:
        cfg = self.config
        if (cfg.fleet_replicate_hits <= 0 or target is None
                or not target.alive
                or not target.session._rc_enabled()
                or rec.hits.get(target.slice_id, 0)
                < cfg.fleet_replicate_hits
                or target.slice_id in rec.replicas
                or target.slice_id in rec.priced_out):
            return
        with self._lock:
            if fkey in self._repl_inflight:
                return
            self._repl_inflight.add(fkey)
            self._repl_threads = [t for t in self._repl_threads
                                  if t.is_alive()]
        # staged-generation capture (the record_insert idiom): a
        # rebind while the slow copy runs makes the staged value
        # stale — claim_replica refuses the claim under a bumped gen
        reg_gen = self.directory.reg_gen

        def _run() -> None:
            try:
                self._replicate_entry(e, fkey, rec, ent, sla, target,
                                      expected_gen=reg_gen)
            except Exception:   # replication is an optimization — a
                # failure must never fail the query it piggybacked on
                log.warning("fleet: entry replication failed",
                            exc_info=True)
            finally:
                with self._lock:
                    self._repl_inflight.discard(fkey)

        t = threading.Thread(target=_run, name="fleet-replicate",
                             daemon=True)
        with self._lock:
            self._repl_threads.append(t)
        t.start()

    def quiesce_replication(self,
                            timeout: Optional[float] = None) -> None:
        """Wait for in-flight hot-entry migrations (tests, drain):
        replication runs on background threads so the directory-hit
        fast path never pays the copy. ``timeout`` bounds the WHOLE
        wait (absolute deadline across the joins), matching the
        drain contract."""
        t_end = (None if timeout is None
                 else retry_lib.now() + timeout)
        with self._lock:
            threads = list(self._repl_threads)
        for t in threads:
            t.join(timeout=_remaining(t_end))

    def _replicate_entry(self, e, fkey: str, rec: DirectoryRecord,
                         ent: CacheEntry, sla: str,
                         target: FleetSlice,
                         expected_gen: Optional[int] = None) -> None:
        """Stage one hot entry into ``target``'s slice-local cache.
        Priced through the reshard planner: the owner-side
        gather of the entry's layout to replicated form compiles as a
        ReshardPlan whose peak must fit the existing
        ``reshard_peak_budget_bytes`` (the migration never gets a
        private budget), and the inter-slice hop bills
        nbytes x the DCN axis weight — both recorded on the ``fleet``
        obs event. The copy goes through the host into a new tensor on
        the target's grid (device to host, then host to device on one
        card), never an alias of the owner's."""
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix
        from matrel_tpu_torch.ir import expr as expr_mod
        from matrel_tpu_torch.parallel import planner, reshard
        from matrel_tpu_torch.session import (_dtype_name, _plan_key,
                                              _prec_prefix)
        cfg = self.config
        gx, gy = mesh_lib.mesh_grid_shape(self.session.mesh)
        weights = mesh_lib.axis_weights(self.session.mesh, cfg)
        src_layout = reshard.normalize_layout(rec.layout) or "rep"
        plan = reshard.compile_reshard(src_layout, "rep",
                                       float(rec.nbytes), gx, gy,
                                       weights,
                                       cfg.reshard_peak_budget_bytes)
        budget = cfg.reshard_peak_budget_bytes
        if budget > 0 and not plan.fits(budget):
            self.directory.mark_priced_out(fkey, target.slice_id)
            with self._lock:
                self.migrations_priced_out += 1
            self._emit_fleet({"event": "migrate_priced_out",
                              "key_hash": _khash(fkey),
                              "owner": rec.owner,
                              "to": target.slice_id,
                              "nbytes": rec.nbytes,
                              "peak_bytes": plan.peak_bytes,
                              "peak_budget": budget})
            return
        rebound = self._rebind(e, target)
        host = ent.result.to_numpy()
        # the entry's own dtype (the JAX package's replica of a bf16
        # entry is f32, which its own MV114 then flags against the
        # owner's recorded dtype)
        replica = BlockMatrix.from_numpy(host,
                                         mesh=target.session.mesh,
                                         config=target.session.config,
                                         dtype=ent.result.dtype,
                                         integral=ent.result.integral)
        lk, pins = _plan_key(rebound)
        key = target.session._rc_key_prefix(sla) + lk
        new_ent = CacheEntry(
            key_hash=_khash(key),
            result=replica,
            pins=tuple(pins),
            dep_ids=target.session._rc_deps(rebound),
            layout=planner._layout_of(expr_mod.leaf(replica),
                                      target.session.mesh),
            dtype=_dtype_name(replica.dtype),
            nbytes=result_nbytes(replica),
            expr=rebound,
            prec=_prec_prefix(sla),
            err_bound=ent.err_bound,
            fleet={"owner": rec.owner, "layout": rec.layout,
                   "dtype": rec.dtype})
        if self.session._prov is not None:
            # the replica inherits the owner entry's ancestry: its
            # stamp points back at the record that produced the
            # owner's answer (sanctioned seam — obs/provenance.py)
            self.session._prov.stamp_entry(
                new_ent, "fleet_replica",
                (ent.provenance or {}).get("query_id"))
        if target.session._result_cache.put(
                key, new_ent, cfg.result_cache_max_bytes,
                cfg.result_cache_max_entries):
            if not self.directory.claim_replica(
                    fkey, target.slice_id, key,
                    expected_gen=expected_gen):
                # the record this migration staged against was
                # replaced/evicted mid-flight: the fresh replica is
                # unreachable by the hit-anywhere protocol — reclaim
                # its cache budget instead of leaving LRU dead weight
                target.session._result_cache.drop(key)
                return
            with self._lock:
                self.migrations += 1
            self._emit_fleet({
                "event": "migrate",
                "key_hash": _khash(fkey),
                "owner": rec.owner,
                "to": target.slice_id,
                "nbytes": rec.nbytes,
                "est_dcn_cost": rec.nbytes
                * placement_lib.effective_dcn_weight(weights),
                "reshard_steps": [s.kind for s in plan.steps],
                "peak_bytes": plan.peak_bytes})

    # -- failover ------------------------------------------------------------

    def check_health(self) -> None:
        """Wedge detection on the submit path: a slice whose worker
        thread DIED while entries sit queued (and nobody asked it to
        stop) is failed over exactly like an explicit kill. The probe
        holds the slice pipeline's lock: a concurrent submit enqueues
        and then starts a new worker under that lock, and between the
        two the new thread is not alive yet — read without the lock,
        that window looked wedged and killed healthy slices (the JAX
        package reads without it).

        On a rank mesh each slice's ranks probe their own worker at
        every record of the router (``_report``) and a wedged verdict
        fails the slice over on every rank at that record; this call
        files an item so that a record happens, and returns after it."""
        if self._log is not None:
            self._enqueue(None, "", None, None, None,
                          ctl=("health",)).result()
            return
        for sl in self.slices:
            if not sl.alive:
                continue
            pipe = sl.session._serve
            if pipe is None:
                continue
            with pipe._lock:
                wedged = (pipe._worker is not None
                          and not pipe._worker.is_alive()
                          and not pipe._stop.is_set()
                          and pipe._q.qsize() > 0)
            if wedged:
                self.kill_slice(sl.slice_id, reason="wedged")

    def kill_slice(self, slice_id: int, reason: str = "kill") -> int:
        """Take one slice out of the fleet: mark it dead (placement
        stops considering it, its directory records drop), stop its
        worker, steal its queued entries and re-admit them onto
        surviving slices — futures, deadlines and tenant attribution
        intact. Entries the worker already pulled complete normally
        (their results are still correct — the slice session itself
        is healthy host-side). Returns the number re-admitted."""
        if self._log is not None:
            return self._enqueue(None, "", None, None, None,
                                 ctl=("kill", slice_id, reason)).result()
        with self._lock:
            sl = self.slice_by_id(slice_id)
            if sl is None or not sl.alive:
                return 0
            sl.alive = False
            stolen = []
            pipe = sl.session._serve
            if pipe is not None:
                # close FIRST, under the pipeline's own submit lock:
                # a racing submit that already passed the closed
                # check has its entry enqueued (the steal below
                # re-admits it); any later one refuses typed
                # (PipelineClosed — fleet.submit falls back to the
                # full-mesh session) instead of stranding a future
                # in a stopped-worker queue
                with pipe._lock:
                    pipe._closed = True
                pipe._stop.set()
                stolen = pipe._q.steal_entries()
            self.directory.drop_slice(slice_id)
            requeued = self._readmit(stolen, sl)
            self.failovers += 1
            self.requeued += requeued
            self._emit_fleet({"event": "slice_kill",
                              "slice": slice_id,
                              "reason": reason,
                              "stolen": len(stolen),
                              "requeued": requeued})
            return requeued

    def _readmit(self, stolen, dead: FleetSlice) -> int:
        """Re-admit stolen queue entries onto surviving slices — the
        pipeline's re-admission discipline across slices. Every
        refusal is typed; nothing is silently dropped."""
        from matrel_tpu_torch.serve.pipeline import _ENTRY_DEFAULTS
        live = self.live_slices()
        ok = 0
        for raw, tenant_key in stolen:
            it = ((*raw, *_ENTRY_DEFAULTS[len(raw) - 3:])
                  if len(raw) < 7 else raw)
            expr, fut, t_enq, sla, dl, tenant, stale = it
            if dl is not None and dl.expired():
                _fail(fut, DeadlineExceeded(
                    dl.budget_ms, dl.elapsed_ms(),
                    context="queued query (slice failover)"))
                continue
            if not self.config.fleet_failover or not live:
                _fail(fut, FleetSliceLost(
                    dead.slice_id,
                    "failover disabled" if live
                    else "no surviving slice"))
                continue
            target = min(live, key=lambda s: s.queue_depth())
            try:
                rebound = self._rebind(expr, target,
                                       src_names=dead.names_by_id)
            except KeyError:
                _fail(fut, FleetSliceLost(
                    dead.slice_id,
                    "query not rebindable onto a survivor"))
                continue
            entry = (rebound, fut, t_enq, sla, dl, tenant, stale)
            pipe = target.session._ensure_serve()
            try:
                # atomic closed-check + enqueue + worker-ensure (the
                # pipeline's own submit invariant): a survivor being
                # concurrently close()d refuses typed instead of
                # stranding the stolen future in a workerless queue
                pipe.readmit_entry(entry, tenant or "")
                target.submitted += 1
                ok += 1
            except AdmissionShed as ex:
                _fail(fut, ex)     # typed — the survivor's bounds hold
            except PipelineClosed:
                _fail(fut, FleetSliceLost(
                    dead.slice_id,
                    "surviving slice's pipeline closed during "
                    "re-admission"))
        return ok

    # -- the rank mesh's router (serve/ranklog.py) ---------------------------

    def _enqueue(self, e, sla, deadline_ms, tenant, staleness_ms,
                 ctl=None) -> Future:
        """File one item under the next sequence number on this rank (a
        query, or ``ctl``: ("kill", slice id, reason) or ("health",));
        the router applies it at its record. Every rank files the same
        items in the same order. The lead sheds a query that finds the
        backlog at a bound; the shed rides the item's record."""
        fut: Future = Future()
        fut.ready_event = None
        dl = (retry_lib.Deadline(deadline_ms) if deadline_ms is not None
              else None)
        key = (":".join(map(str, ctl)) if ctl is not None
               else ranklog.rank_key(e))
        with self._lock:
            if self._router is None:
                self.session.mesh.ranks.register_worker(self)
                self._router = threading.Thread(
                    target=self._run_router, name="matrel-fleet",
                    daemon=True)
                self._router.start()
            seq = next(self._seq)
            if self._log.lead and ctl is None:
                self._bound(seq, tenant or "")
            self._items.put((e, fut, time.perf_counter(), sla, dl,  # matlint: disable=ML006 queue-wait timestamp — lands in the serve event record
                             tenant or "", staleness_ms, seq, key, ctl))
        return fut

    def _bound(self, seq: int, tenant: str) -> None:
        """The lead's queue bounds on the router's backlog: per tenant
        first, then the whole store (the pipeline's order)."""
        cfg = self.config
        if cfg.serve_tenant_queue_max > 0 and self._items.count(
                lambda it: it[5] == tenant) >= cfg.serve_tenant_queue_max:
            self._sheds[seq] = ("tenant", cfg.serve_tenant_queue_max)
        elif (cfg.serve_queue_max > 0
              and self._items.count() >= cfg.serve_queue_max):
            self._sheds[seq] = ("queue", cfg.serve_queue_max)

    def owns_thread(self) -> bool:
        return threading.current_thread() is getattr(self, "_router",
                                                     None)

    @property
    def closed(self) -> bool:
        """Has ``close`` stopped the router (a rank mesh)?"""
        return self._stop.is_set()

    def _run_router(self) -> None:
        """One record at a time: the lead decides every item waiting in
        its store (up to :data:`ROUTE_BATCH`, a control item alone) and
        publishes, every rank reports and applies them in sequence
        order. While a slice-placed item's outcome is outstanding the
        lead publishes an empty record every :data:`REPORT_EVERY_S`, so
        that the outcome reaches every rank without waiting for the
        next submission."""
        dlog = self._log
        dev = self.session.mesh.device
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        while not self._stop.is_set():
            has = self._items.wait_any(REPORT_EVERY_S if self._routed
                                       else 0.05)
            if not has and not self._routed:
                continue
            if dlog.lead:
                rec = dlog.publish(self._decide_items() if has else
                                   {"cycle": dlog.cycles, "items": []})
            else:
                rec = dlog.publish()
            seqs = [r["seq"] for r in rec["items"]]
            got = (self._items.take(seqs, ranklog.RANK_WAIT_S)
                   if seqs else {})
            try:
                self._apply_record(rec, got)
            except Exception:  # the items' futures carry it; the router
                # lives on
                log.warning("fleet: record %s failed", rec["cycle"],
                            exc_info=True)

    def _pipeline(self, sl: Optional[FleetSlice]):
        """The pipeline a routed query runs through on a rank mesh: the
        parent's for a span, ``sl``'s for a slice (its answers wrapped
        as :class:`SliceResult`)."""
        if sl is None:
            return self.session._ensure_serve()
        pipe = sl.session._ensure_serve()
        if pipe.route is None:
            pipe.attach_route(_SliceRoute(self, sl))
        return pipe

    def _load(self, slice_id: int, since=None) -> int:
        """A slice's placement load as of the last record: the entries
        its lead reported queued plus those routed to it since
        (``since``, the records' count by default), less what an idle
        worker takes at once (the JAX package's queue depth once the
        worker has pulled)."""
        q, busy = self._depth.get(slice_id, (0, False))
        q += (self._since if since is None else since).get(slice_id, 0)
        return q if busy else max(q - self.config.serve_max_batch, 0)

    def _decide_items(self) -> dict:
        """The lead's record: a verdict for each waiting item in
        sequence order (a control item alone in its record), each
        placed as if the ones before it had been routed (the
        round-robin tick and the loads move with them)."""
        items = []
        for it in self._items.lowest(ROUTE_BATCH):
            if it[9] is not None and items:
                break
            items.append(it)
            if it[9] is not None:
                break
        rr, since, recs = self._rr_count, dict(self._since), []
        for it in items:
            rec = self._decide_item(it, rr, since)
            v = rec.get("verdict")
            if v is not None and v[0] == "route":
                rr += 1
                if v[4].mode == "slice" and not v[3]:
                    since[v[4].slice_id] = since.get(v[4].slice_id, 0) + 1
            recs.append(rec)
        return {"cycle": self._log.cycles, "items": recs}

    def _decide_item(self, it, rr: int, since) -> dict:
        """The lead's verdict on one item: a shed, placement (the
        slices' loads, ties broken by the round-robin tick ``rr``) and
        the directory's serving candidates. The target pipeline's own
        record (the deadline among its verdicts) follows once the ranks
        know that no candidate answers."""
        from matrel_tpu_torch.session import _prec_prefix
        e, _f, _t, sla, dl, _tenant, _st, seq, key, ctl = it
        rec = {"seq": seq, "key": key}
        if ctl is not None:
            return rec
        live = self.live_slices()
        shed = self._sheds.pop(seq, None)
        if shed is not None:
            rec["verdict"] = ("shed",) + shed
        elif not live:
            rec["verdict"] = ("lost",)
        else:
            fkey = placement_lib.fleet_key(e, self._names,
                                           _prec_prefix(sla))
            loads = {sl.slice_id: self._load(sl.slice_id, since)
                     for sl in live}
            preferred = placement_lib.pick_slice(loads, rr)
            cands = []
            drec = (self.directory.peek(fkey) if fkey is not None
                    else None)
            if drec is not None:
                if preferred in drec.replicas:
                    cands.append(preferred)
                cands.append(drec.owner)
            dec = placement_lib.decide(
                e, self.config,
                mesh_lib.axis_weights(self.session.mesh, self.config),
                total_devices=self.session.mesh.size,
                slice_devices=live[0].devices, slice_loads=loads,
                backend=self.session.mesh.device.type, sla=sla,
                eligible=fkey is not None, rr_tick=rr)
            rec["verdict"] = ("route", fkey, preferred, cands, dec)
        return rec

    def _holds(self, sid: int, fkey: str) -> Optional[bool]:
        """Does this rank hold slice ``sid``'s copy of the directory
        entry ``fkey``? None off the slice."""
        sl = self.slice_by_id(sid)
        rec = self.directory.peek(fkey)
        if sl is None or not sl.member or rec is None:
            return None
        k = rec.owner_key if sid == rec.owner else rec.replicas.get(sid)
        return (k is not None and sl.alive and sl.session._rc_enabled()
                and sl.session._result_cache.holds(k))

    def _report(self) -> dict:
        """What this rank tells a record about the slices it serves:
        each slice whose worker it finds wedged (a dead thread with
        entries waiting, no stop asked), and, for the slice it leads,
        the outcomes finished since the last record and its load."""
        rep = {"wedged": [], "slices": {}}
        for sl in self.slices:
            pipe = sl.session._serve if sl.member else None
            if not self._concurrent or pipe is None:
                continue
            if sl.alive and pipe.wedged():
                rep["wedged"].append(sl.slice_id)
            if sl.session.mesh.ranks.rank == 0:
                with self._outbox_lock:
                    outs, self._outbox = self._outbox, []
                rep["slices"][sl.slice_id] = (outs, pipe.load())
        return rep

    def _take_reports(self, facts) -> list:
        """Apply the ranks' reports, the same on every rank: settle the
        outcomes, note the loads; the live slices found wedged."""
        wedged = set()
        for f in facts:
            wedged.update(f["wedged"])
            for sid, (outs, load) in f["slices"].items():
                self._depth[sid] = load
                for seq, err, info in outs:
                    self._settle(seq, err, info)
        self._since = {}
        return sorted(s for s in wedged if self.slice_by_id(s).alive)

    def _apply_record(self, rec: dict, got: dict) -> None:
        """One record on this rank: the ranks report what they hold of
        each item and what their slices did (one gather), then the items
        apply in sequence order and a wedged slice fails over."""
        recs = rec["items"]
        mine, rebounds = [], []
        for r in recs:
            it = got.get(r["seq"])
            verdict = r.get("verdict")
            route = verdict is not None and verdict[0] == "route"
            rebound = None
            if route and verdict[4].mode == "slice" and it is not None:
                # a member rebinds onto its slice's replicas; one that
                # cannot sends the query to the span, on every rank
                sl = self.slice_by_id(verdict[4].slice_id)
                rebound = it[0]
                if sl.member:
                    try:
                        rebound = self._rebind(it[0], sl)
                    except KeyError:
                        rebound = None
            rebounds.append(rebound)
            mine.append((it is not None, it[8] if it is not None else None,
                         {sid: self._holds(sid, verdict[1])
                          for sid in (verdict[3] if route else ())},
                         rebound is not None))
        try:
            facts = self._log.gather((mine, self._report()))
        except Exception as ex:
            for it in got.values():
                _fail(it[1], ex)
                self._items.done(1)
            raise
        # a slice found wedged leaves before the items apply, as one
        # card's submit checks health before it places
        for sid in self._take_reports([f[1] for f in facts]):
            self._kill_ranked(sid, "wedged")
        try:
            for k, r in enumerate(recs):
                it = got.get(r["seq"])
                try:
                    self._apply_item(r, it, [f[0][k] for f in facts],
                                     rebounds[k])
                except Exception as ex:  # the item's future carries it
                    log.warning("fleet: item %s failed", r["seq"],
                                exc_info=True)
                    if it is not None:
                        _fail(it[1], ex)
                finally:
                    if it is not None and r["seq"] not in self._routed:
                        self._items.done(1)
        finally:
            for it in got.values():
                if it[9] == ("health",):
                    _resolve(it[1], None)

    def _apply_item(self, rec: dict, it, facts, rebound) -> None:
        """Apply one item on this rank, the ranks agreed (``facts`` each
        rank's report on it): kill / fail / serve from the directory /
        route to the target's pipeline."""
        why = ranklog.divergence(
            [{rec["seq"]: (f[0], f[1], None, None)} for f in facts],
            [rec["seq"]])
        if why is not None:
            ex = RankDivergence(self._log.cycles, why)
            if it is None:
                self._items.mark_dead(rec["seq"], ex)
            else:
                _fail(it[1], ex)
            return
        fut, ctl = it[1], it[9]
        if ctl is not None:
            if ctl[0] == "kill":
                _resolve(fut, self._kill_ranked(ctl[1], ctl[2]))
            return
        verdict = rec["verdict"]
        if verdict[0] == "shed":
            self.session._ensure_serve()._q.record_shed(it[5])
            _fail(fut, AdmissionShed(verdict[2], tenant=it[5] or None,
                                     scope=verdict[1]))
            return
        if verdict[0] == "lost":
            _fail(fut, FleetSliceLost(-1, "no live slices"))
            return
        _k, fkey, preferred, cands, dec = verdict
        self._rr_count += 1
        if fkey is not None and self._serve_hit(
                it, fut, fkey, preferred, cands, facts):
            return
        sl = None
        if dec.mode == "slice" and not all(f[3] for f in facts):
            # raced a rebind: the full mesh answers (always correct),
            # recorded as the fallback, not as pinned
            dec = dataclasses.replace(dec, mode="span", reason="fallback")
            expr = it[0]
        elif dec.mode == "span":
            expr = it[0].with_attrs(placement=dec.stamp())
        else:
            sl = self.slice_by_id(dec.slice_id)
            expr = rebound
            if not sl.alive:
                # failed over at this record after the lead placed it:
                # the least-loaded survivor takes it
                live = self.live_slices()
                if not live:
                    _fail(fut, FleetSliceLost(-1, "no live slices"))
                    return
                sl = min(live, key=lambda x: self._load(x.slice_id))
                expr = None
        with self._lock:
            if sl is None:
                if dec.reason == "pinned":
                    self.pinned += 1
                self.placed["span"] += 1
            else:
                sl.submitted += 1
                self.placed["slice"] += 1
        self._emit_placement(dec, fkey, "span" if sl is None else "slice",
                             None if sl is None else sl.slice_id)
        if sl is not None and self._concurrent:
            self._route_to(sl, it, fkey, expr)
            return
        # the world runs it: every slice's pipeline drains first
        # (``held``), then the target's cycle runs under the lock
        pipe = self._pipeline(sl)
        entry = (expr,) + it[1:pipeline_lib.KEY + 1]
        with self.session.mesh.ranks.held():
            prec = self._log.broadcast(
                pipe.decide_routed(entry) if self._log.lead else None)
            if sl is not None:
                pipe.route.keys[it[7]] = (expr, it[3])
            try:
                pipe.apply_routed(prec, entry)
            finally:
                if sl is not None:
                    pipe.route.keys.pop(it[7], None)
                    info = pipe.route.infos.pop(it[7], None)
                    if fut.done() and fut.exception() is None:
                        self._record_owner(sl, it, fkey, info, expr)

    def _route_to(self, sl: FleetSlice, it, fkey, expr=None) -> None:
        """File a slice-placed item into ``sl``'s pipeline, on every
        rank at the same record: the slice's ranks admit it (``expr``
        rebound onto their replicas, or rebound here), the others wait
        for its outcome at a later record. ``fkey`` None records no
        directory entry for the answer (a re-admitted one, as on one
        card)."""
        seq = it[7]
        self._routed[seq] = (it, sl.slice_id, fkey, self.directory.reg_gen)
        self._since[sl.slice_id] = self._since.get(sl.slice_id, 0) + 1
        if not sl.member:
            return
        inner: Future = Future()
        inner.ready_event = None
        inner.add_done_callback(
            lambda f: self._inner_done(sl, seq, it[1], f))
        try:
            if expr is None:
                expr = self._rebind(it[0], sl)
            pipe = self._pipeline(sl)
            pipe.route.keys[seq] = (expr, it[3])
            pipe.admit_routed((expr, inner) + it[2:pipeline_lib.KEY + 1])
        except (KeyError, PipelineClosed) as ex:
            _fail(inner, FleetSliceLost(sl.slice_id, f"not admitted: "
                                        f"{type(ex).__name__}"))

    def _inner_done(self, sl: FleetSlice, seq: int, fut: Future,
                    f: Future) -> None:
        """A slice rank's answer to a routed item: the caller's future
        takes it, and the slice's first rank keeps the outcome for the
        next record's report."""
        ex = f.exception()
        if ex is None:
            _resolve(fut, f.result(), f.ready_event)
        else:
            _fail(fut, ex)
        pipe = sl.session._serve
        info = pipe.route.infos.pop(seq, None) if pipe is not None else None
        if sl.session.mesh.ranks.rank == 0:
            with self._outbox_lock:
                self._outbox.append(
                    (seq, None if ex is None else ranklog.error_record(ex),
                     info))

    def _settle(self, seq: int, err, info) -> None:
        """A routed item's outcome, from its slice lead's report, on
        every rank: a rank outside the slice resolves the future (a
        :class:`SliceResult` with no local value, or the same typed
        error rebuilt), a cached answer enters the directory, a shed
        counts on the parent's queue."""
        it, sid, fkey, gen = self._routed.pop(seq)
        sl = self.slice_by_id(sid)
        if not sl.member:
            if err is None:
                _resolve(it[1], SliceResult(self.session.mesh,
                                            sl.session.mesh, None))
            else:
                _fail(it[1], ranklog.rebuild_error(err))
        expr = None
        if sl.member:
            pipe = sl.session._serve
            expr = pipe.route.keys.pop(seq, (None,))[0]
        if err is None:
            self._record_owner(sl, it, fkey, info, expr, gen)
        elif err["cls"][1] == AdmissionShed.__qualname__:
            self.session._ensure_serve()._q.record_shed(it[5])
        self._items.done(1)

    def _record_owner(self, sl: FleetSlice, it, fkey, info, expr,
                      gen: Optional[int] = None) -> None:
        """Record ``sl`` as the owner of a slice-placed answer its ranks
        cached under the routing-time key (``info`` the slice lead's
        (cached?, bytes, layout, dtype)); the owner key is this rank's
        own (a plan key holds this process's ids). A rebind or a slice
        kill since the routing (``gen``, the registration generation
        then) makes the insert stale, as on one card."""
        if fkey is None or info is None or not info[0]:
            return
        _cached, nbytes, layout, dtype = info
        self.directory.record_insert(fkey, DirectoryRecord(
            owner=sl.slice_id,
            owner_key=(self._local_key(sl, expr, it[3])
                       if sl.member and expr is not None else None),
            nbytes=nbytes, layout=layout, dtype=dtype,
            dep_names=self._dep_names(it[0])), expected_gen=gen)

    def _entry_info(self, sl, rebound, sla, out):
        """(cached?, nbytes, layout, dtype) of a slice-placed result on
        one of the slice's ranks."""
        from matrel_tpu_torch.ir import expr as expr_mod
        from matrel_tpu_torch.parallel import planner
        from matrel_tpu_torch.session import _dtype_name
        key = self._local_key(sl, rebound, sla)
        return (sl.session._rc_enabled()
                and sl.session._result_cache.holds(key),
                result_nbytes(out),
                planner._layout_of(expr_mod.leaf(out), sl.session.mesh),
                _dtype_name(out.dtype))

    def _serve_hit(self, it, fut, fkey, preferred, cands, facts) -> bool:
        """The hit-anywhere protocol on every rank: the first candidate
        whose every rank holds the entry serves it; a replica that does
        not loses its claim, an owner that does not its record."""
        drec = self.directory.lookup(fkey)
        if drec is None:
            return False
        serving = None
        for sid in cands:
            held = [f[2].get(sid) for f in facts]
            if all(h is not False for h in held) and any(held):
                serving = sid
                break
            if sid != drec.owner:
                self.directory.drop_replica(fkey, sid)
        if serving is None:
            self.directory.drop(fkey)
            return False
        remote = serving != preferred
        self.directory.record_hit(fkey, preferred, remote)
        sl = self.slice_by_id(serving)
        _resolve(fut, SliceResult(self.session.mesh, sl.session.mesh,
                                  self._cached(sl, drec, serving)))
        if sl.session._slo is not None:
            sl.session._slo.record_ok(it[5] or None, 0.0)
        if remote:
            self._migrate_ranked(it, fkey, drec, serving,
                                 self.slice_by_id(preferred))
        self._emit_hit(fkey, "directory_remote" if remote
                       else "directory", serving)
        return True

    @staticmethod
    def _cached(sl: FleetSlice, drec: DirectoryRecord, sid: int):
        """Slice ``sid``'s cached answer for ``drec`` on this rank (None
        off the slice)."""
        if not sl.member:
            return None
        ent = sl.session._result_cache.lookup(
            drec.owner_key if sid == drec.owner else drec.replicas[sid])
        return ent.result if ent is not None else None

    def _migrate_ranked(self, it, fkey, drec, serving, target) -> None:
        """Hot-entry replication at its record, on every rank: priced as
        on one card; the value crosses as a world collective (every
        slice's pipeline drained first) and the target slice's ranks cut
        their blocks from it."""
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix
        from matrel_tpu_torch.ir import expr as expr_mod
        from matrel_tpu_torch.parallel import planner, reshard
        from matrel_tpu_torch.session import (_dtype_name, _plan_key,
                                              _prec_prefix)
        cfg = self.config
        if (cfg.fleet_replicate_hits <= 0 or target is None
                or not target.alive
                or not target.session._rc_enabled()
                or drec.hits.get(target.slice_id, 0)
                < cfg.fleet_replicate_hits
                or target.slice_id in drec.replicas
                or target.slice_id in drec.priced_out):
            return
        gx, gy = mesh_lib.mesh_grid_shape(self.session.mesh)
        weights = mesh_lib.axis_weights(self.session.mesh, cfg)
        plan = reshard.compile_reshard(
            reshard.normalize_layout(drec.layout) or "rep", "rep",
            float(drec.nbytes), gx, gy, weights,
            cfg.reshard_peak_budget_bytes)
        budget = cfg.reshard_peak_budget_bytes
        if budget > 0 and not plan.fits(budget):
            self.directory.mark_priced_out(fkey, target.slice_id)
            with self._lock:
                self.migrations_priced_out += 1
            self._emit_fleet({"event": "migrate_priced_out",
                              "key_hash": _khash(fkey),
                              "owner": drec.owner, "to": target.slice_id,
                              "nbytes": drec.nbytes,
                              "peak_bytes": plan.peak_bytes,
                              "peak_budget": budget})
            return
        src = self.slice_by_id(serving)
        host = SliceResult(self.session.mesh, src.session.mesh,
                           self._cached(src, drec, serving)).to_numpy()
        key, put = None, False
        if target.member:
            rebound = self._rebind(it[0], target)
            replica = BlockMatrix.from_numpy(
                host, mesh=target.session.mesh,
                config=target.session.config,
                dtype=getattr(torch, drec.dtype),
                integral=not getattr(torch, drec.dtype).is_floating_point)
            lk, pins = _plan_key(rebound)
            key = target.session._rc_key_prefix(it[3]) + lk
            put = target.session._result_cache.put(key, CacheEntry(
                key_hash=_khash(key), result=replica, pins=tuple(pins),
                dep_ids=target.session._rc_deps(rebound),
                layout=planner._layout_of(expr_mod.leaf(replica),
                                          target.session.mesh),
                dtype=_dtype_name(replica.dtype),
                nbytes=result_nbytes(replica), expr=rebound,
                prec=_prec_prefix(it[3]),
                fleet={"owner": drec.owner, "layout": drec.layout,
                       "dtype": drec.dtype}),
                cfg.result_cache_max_bytes, cfg.result_cache_max_entries)
        if not any(p for p in self._log.gather(put)):
            return
        self.directory.claim_replica(fkey, target.slice_id, key)
        with self._lock:
            self.migrations += 1
        self._emit_fleet({"event": "migrate", "key_hash": _khash(fkey),
                          "owner": drec.owner, "to": target.slice_id,
                          "nbytes": drec.nbytes,
                          "est_dcn_cost": drec.nbytes
                          * placement_lib.effective_dcn_weight(weights),
                          "reshard_steps": [st.kind for st in plan.steps],
                          "peak_bytes": plan.peak_bytes})

    def _kill_ranked(self, slice_id: int, reason: str) -> int:
        """``kill_slice`` at its record, on every rank: the slice leaves
        and its directory records drop; its ranks close its pipeline,
        and its lead takes the entries it has not admitted and tells
        every rank their sequence numbers (with a verdict for a deadline
        that expired while they waited, on the lead's clock). Every rank
        re-admits them onto the survivors by load. Entries already in a
        cycle complete normally. Returns the number re-admitted."""
        sl = self.slice_by_id(slice_id)
        if sl is None or not sl.alive:
            return 0
        sl.alive = False
        stolen = []
        if self._concurrent:
            pipe = sl.session._serve if sl.member else None
            mine = pipe.abandon() if pipe is not None else []
            lead = sl.session.mesh.ranks.members[0]
            stolen = self._log.broadcast(
                [(e[pipeline_lib.SEQ], v) for e, v in mine]
                if self.session.mesh.ranks.global_rank == lead else None,
                src=lead)
            if pipe is not None:
                seqs = [seq for seq, _v in stolen]
                if pipe._store is not None:
                    pipe._store.drop(seqs)
                for seq in seqs:
                    pipe.route.keys.pop(seq, None)
        self.directory.drop_slice(slice_id)
        requeued = self._readmit_ranked(stolen, sl)
        with self._lock:
            self.failovers += 1
            self.requeued += requeued
        self._emit_fleet({"event": "slice_kill", "slice": slice_id,
                          "reason": reason, "stolen": len(stolen),
                          "requeued": requeued})
        return requeued

    def _readmit_ranked(self, stolen, dead: FleetSlice) -> int:
        """Re-admit a dead slice's waiting entries onto the survivors,
        on every rank alike: each to the least-loaded live slice (the
        loads as of the last record, plus what this failover has placed
        already), futures, deadlines and tenants intact. Every refusal
        is typed."""
        live = self.live_slices()
        ok = 0
        for seq, verdict in stolen:
            it = self._routed[seq][0]
            ex = None
            if verdict is not None and verdict[0] == "shed":
                ex = AdmissionShed(verdict[2], tenant=it[5] or None,
                                   scope=verdict[1])
            elif verdict is not None:
                ex = DeadlineExceeded(
                    verdict[1], verdict[2],
                    context="queued query (slice failover)"
                    if verdict[0] == "deadline"
                    else "queued query (purged)")
            elif not self.config.fleet_failover or not live:
                ex = FleetSliceLost(dead.slice_id,
                                    "failover disabled" if live
                                    else "no surviving slice")
            if ex is not None:
                del self._routed[seq]
                _fail(it[1], ex)
                self._items.done(1)
                continue
            target = min(live, key=lambda s: self._load(s.slice_id))
            self._route_to(target, it, None)
            with self._lock:
                target.submitted += 1
            ok += 1
        return ok

    # -- lifecycle / observability ------------------------------------------

    def drain(self, timeout: Optional[float] = None) -> None:
        """``timeout`` bounds the WHOLE fleet drain (one absolute
        deadline shared across the replication quiesce and every
        slice — the ServePipeline.drain t_abs pattern), not each
        sub-wait: the caller's documented bound must hold however
        many slices the fleet has."""
        t_end = (None if timeout is None
                 else retry_lib.now() + timeout)
        if self._log is not None:
            # every item's cycle, then each pipeline's dispatched
            # batches (the router ran them)
            self._items.join(timeout)
            for sl in self.slices:
                sl.session.serve_drain(timeout=_remaining(t_end))
            return
        self.quiesce_replication(timeout=_remaining(t_end))
        # live slices first, then killed ones: kill_slice steals only
        # QUEUED entries — a batch its worker had already pulled keeps
        # executing (by design), and the serve_drain contract ("every
        # in-flight batch has materialised") covers those futures too.
        # The stopped worker's finally task_done()s the pulled batch,
        # so a dead pipeline's drain terminates; a genuinely wedged
        # corpse raises the typed DrainTimeout, after the live fleet
        # has already drained within the shared budget.
        for sl in sorted(self.slices, key=lambda s: not s.alive):
            sl.session.serve_drain(timeout=_remaining(t_end))

    def close(self, timeout: Optional[float] = None) -> None:
        t_end = (None if timeout is None
                 else retry_lib.now() + timeout)
        if self._log is not None:
            try:
                self._items.join(timeout)
            finally:
                self._stop.set()
                self.session.mesh.ranks.unregister_worker(self)
                if self._router is not None and not self.owns_thread():
                    self._router.join(timeout=1.0)
        self.quiesce_replication(timeout=_remaining(t_end))
        # close EVERY slice before reporting failure: one wedged
        # slice's DrainTimeout aborting the loop would leave the
        # remaining slices' workers running for the life of the
        # parent. Dead slices (queue already stolen) only log; the
        # first LIVE slice's failure propagates after the sweep.
        first: Optional[BaseException] = None
        for sl in self.slices:
            try:
                sl.session.serve_close(timeout=_remaining(t_end))
            except Exception as ex:
                if sl.alive and first is None:
                    first = ex
                else:
                    log.warning("fleet: slice %d close failed",
                                sl.slice_id, exc_info=True)
        if first is not None:
            raise first

    def export_directory(self) -> list:
        """The directory's demand snapshot for ``save_state()``
        (serve/spill.py) — name-keyed hit histories, no local cache
        keys (those die with the process)."""
        return self.directory.export_state()

    def seed_directory(self, records) -> int:
        """Warm a restarted fleet's directory with a snapshot's
        demand hints (``restore()``'s seam) — see
        :meth:`FleetDirectory.seed_hints`."""
        return self.directory.seed_hints(records)

    def info(self) -> dict:
        snaps = [sl.snapshot() for sl in self.slices]
        if self._log is not None:
            # a slice's cache and planes live on its ranks: its first
            # rank's snapshot, on every rank
            from matrel_tpu_torch.parallel import collectives as coll
            snaps = [coll.broadcast_object(
                snap, self.session.mesh,
                src=sl.session.mesh.ranks.members[0])
                for sl, snap in zip(self.slices, snaps)]
        return {"slices": snaps,
                "source": self.source,
                "directory": self.directory.info(),
                "placed": dict(self.placed),
                "pinned": self.pinned,
                "migrations": self.migrations,
                "migrations_priced_out": self.migrations_priced_out,
                "failovers": self.failovers,
                "requeued": self.requeued}

    def _emit_placement(self, dec, fkey: Optional[str], routed: str,
                        slice_id: Optional[int]) -> None:
        sess = self.session
        if not (sess._obs_enabled() or sess._flight is not None):
            return
        try:
            sess._emit_placement_event({
                "key_hash": _khash(fkey) if fkey else None,
                "mode": dec.mode,
                "routed": routed,
                "slice": slice_id,
                "reason": dec.reason,
                "coeff_source": dec.coeff_source,
                "est_slice_ms": round(dec.est_slice_ms, 4),
                "est_span_ms": round(dec.est_span_ms, 4),
                "weights": list(dec.weights),
                "dcn_axis": dec.dcn_axis,
            })
        except Exception:    # the never-fail obs contract
            log.warning("obs: placement event dropped", exc_info=True)

    def _emit_hit(self, fkey: str, routed: str,
                  serving_id: int) -> None:
        """The directory-hit placement record: no cost model ran
        (the fast path's whole point), so the record carries the
        routing outcome only — ``mode: "hit"``, no estimates, no
        coefficient provenance."""
        sess = self.session
        if not (sess._obs_enabled() or sess._flight is not None):
            return
        try:
            sess._emit_placement_event({
                "key_hash": _khash(fkey),
                "mode": "hit",
                "routed": routed,
                "slice": serving_id,
                "reason": "directory",
            })
        except Exception:    # the never-fail obs contract
            log.warning("obs: placement event dropped", exc_info=True)

    def _emit_fleet(self, record: dict) -> None:
        sess = self.session
        if not (sess._obs_enabled() or sess._flight is not None):
            return
        try:
            sess._emit_fleet_event(record)
        except Exception:
            log.warning("obs: fleet event dropped", exc_info=True)


def _khash(key: Optional[str]) -> Optional[str]:
    if key is None:
        return None
    return hashlib.sha1(key.encode()).hexdigest()[:16]
