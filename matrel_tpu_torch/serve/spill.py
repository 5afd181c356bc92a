"""Result-cache spill hierarchy and durable-state snapshots — the
counterpart of ``matrel_tpu/serve/spill.py``.

Two jobs, one seam:

* **Tiering.** :class:`SpillManager` is the lower half of the result
  cache's memory hierarchy: entries the device LRU evicts DEMOTE here
  (host RAM as CPU tensors, then sha1-verified ``.npy`` artifacts as the
  disk tier) instead of being recomputed later, and a device miss falls
  through (``ResultCache._thaw``) to PROMOTE them back — a lower-tier hit
  recomputes nothing; it pays only the priced transfer legs
  (``parallel/reshard.spill_plan`` stages the move in the ``host`` /
  ``disk`` step vocabulary, ``parallel/coeffs.spill_cost_ms`` prices it
  from the drift-calibrated ``spill:<leg>`` rows). Everything evicted
  ages to host RAM; host entries past ``config.spill_host_max_bytes``
  age to disk only when their lifetime ``hits`` clear
  ``config.spill_disk_hits`` (cold entries drop — writing a never-reused
  result to disk buys nothing).

* **Durability.** :func:`save_state` / :func:`load_snapshot` persist the
  session's learned state — catalog bindings (the checkpoint step
  format, ``utils/checkpoint.py``), the result-cache index (every entry
  with a catalog-name computable key, written as disk-tier artifacts),
  the fleet directory's demand hints, the MQO template keys and the
  autotune / drift tables — so a restarted
  ``MatrelSession.restore()`` comes back serving warm: restored entries
  sit in a name-keyed index (``placement.fleet_key``'s
  session-independent token format — raw structural keys embed ``id()``s
  and mean nothing across processes) and thaw lazily on first consult,
  with dep NAMES re-resolved against the live catalog so invalidation
  keeps working. The fleet's records are name-keyed too, so one
  package's snapshot seeds the other's fleet directory.

Artifacts are the JAX package's ``.npy`` files; a bfloat16 result is
stored as its raw 16-bit patterns (``|V2``, what numpy writes for an
``ml_dtypes`` bfloat16 array) and read back bit for bit, with its dtype
in the tier metadata (``utils/checkpoint.tensor_to_host``).

Corruption discipline: a disk artifact failing its stored sha1 raises
the typed :class:`SnapshotCorruption` internally and is handled as a
cache miss (drop + count + warn — the query recomputes; the answer is
never wrong); a corrupt or truncated snapshot warns and cold-starts
(restore never crashes a restart).

Structural-zero contract: the default config (``spill_enable=False``)
constructs no SpillManager — ``_CONSTRUCTED`` stays 0.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from collections import OrderedDict
from typing import Callable, Dict, Optional

import numpy as np
import torch

from matrel_tpu_torch.resilience.errors import (SnapshotCorruption,
                                                SnapshotGridMismatch)
from matrel_tpu_torch.utils import lockdep

_log = logging.getLogger("matrel_tpu_torch.serve")

#: Structural-zero hook (the mqo/replan idiom): tests poison
#: SpillManager.__init__ bookkeeping by asserting this counter stays 0
#: under the default config.
_CONSTRUCTED = {"count": 0}

#: Snapshot state-dict schema (bump on reader-visible change — the
#: events.py versioning discipline; foreign schemas cold-start).
SNAPSHOT_SCHEMA = 1


def _now_ms() -> float:
    return time.perf_counter() * 1e3


@dataclasses.dataclass
class TierEntry:
    """One lower-tier resident. ``meta`` is the JSON-able record the
    snapshot persists (shape/spec/dtype/layout/prec/delta provenance/
    dep_names); the object-valued fields (expr, pins, dep_ids, …)
    exist only for SAME-PROCESS demotions — a restored entry has
    ``dep_names`` in meta instead and re-resolves them at thaw."""

    tier: str                        # "host" / "disk" / "restored"
    meta: dict
    nbytes: int
    hits: int = 0
    array: Optional[torch.Tensor] = None  # host tier only (a CPU tensor)
    file: Optional[str] = None           # disk/restored tiers
    sha1: Optional[str] = None
    dep_ids: frozenset = frozenset()
    pins: tuple = ()
    expr: Optional[object] = None
    fleet: Optional[dict] = None
    provenance: Optional[dict] = None
    ivm_id: Optional[int] = None


def to_host(t: torch.Tensor) -> torch.Tensor:
    """The host-tier copy of a tensor (the d2h leg): a CPU tensor holding
    the same bits, in page-locked (pinned) memory when the source is on
    a card, so the d2h and the later h2d run as direct DMA rather than
    through a staging buffer (on the H100, 98 MiB each way in ~2 ms
    pinned against 17–46 ms pageable: ``PERF.md`` §6, PR 16).
    Synchronous: the copy is complete when this returns."""
    t = t.detach()
    if not t.is_cuda:
        return t.clone()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out


def _world(mesh):
    """The rank grid whose blocks a result holds ([gx, gy]), or None on
    one device (whole values)."""
    return list(mesh.grid) if mesh.ranked else None


def _artifact_suffix(mesh) -> str:
    """What a rank's artifact names carry after the key hash: its rank
    and the world's grid (``.r3.2x2``), so two ranks never write one
    file; nothing on one device."""
    if not mesh.ranked:
        return ""
    return f".r{mesh.ranks.rank}.{mesh.grid[0]}x{mesh.grid[1]}"


def _entry_meta(ent) -> dict:
    """CacheEntry + its BlockMatrix → the JSON-able tier metadata (on a
    rank mesh also the grid whose block the entry holds)."""
    from matrel_tpu_torch.utils.checkpoint import _spec_to_json
    bm = ent.result
    meta = {
        "key_hash": ent.key_hash,
        "shape": list(bm.shape),
        "spec": _spec_to_json(bm.spec),
        "nnz": bm.nnz,
        "block_size": bm.block_size,
        "integral": bm.integral,
        "int_abs_max": bm.int_abs_max,
        "layout": ent.layout,
        "dtype": ent.dtype,
        "nbytes": ent.nbytes,
        "prec": ent.prec,
        "err_bound": ent.err_bound,
        "delta_gen": ent.delta_gen,
        "delta_rule": ent.delta_rule,
    }
    if bm.mesh.ranked:
        meta["world"] = _world(bm.mesh)
    return meta


class SpillManager:
    """The host/disk tiers under one session's ResultCache, plus the
    restored-entry index a snapshot load seeds. On a rank mesh every
    rank runs one, over its own blocks (every rank evicts, demotes and
    promotes the same entries: the ranks run the same queries), and its
    artifact names carry the rank and the grid. Lock order:
    ``serve.result_cache`` → ``serve.spill`` (demotions run inside the
    cache's eviction loop; promotions inside its miss path) — this
    manager never calls back into the cache."""

    def __init__(self, session):
        _CONSTRUCTED["count"] += 1
        self._session = session
        self.config = session.config
        self.mesh = session.mesh
        self._lock = lockdep.make_rlock("serve.spill")
        self._host: "OrderedDict[str, TierEntry]" = OrderedDict()
        self._host_bytes = 0
        self._disk: Dict[str, TierEntry] = {}
        self._disk_bytes = 0
        # name-keyed (fleet_key format) entries from a loaded
        # snapshot, thawed lazily by the session's restored consult
        self._restored: Dict[str, TierEntry] = {}
        self._dir = (os.path.join(self.config.state_dir, "spill")
                     if self.config.state_dir else None)
        # wired by the session to _emit_spill_event; never required
        self.emit: Optional[Callable[[dict], None]] = None
        self.demoted_host = 0
        self.demoted_disk = 0
        self.promoted = 0
        self.thawed_restored = 0
        self.dropped = 0          # cold host entries aged past budget
        self.corrupt = 0          # artifacts that failed their sha1

    # -- ResultCache-facing contract (attach_spill consumers) ---------------

    @property
    def hbm_max_bytes(self) -> int:
        return self.config.result_cache_max_bytes

    @property
    def hbm_max_entries(self) -> int:
        return self.config.result_cache_max_entries

    def demote(self, key: str, ent) -> None:
        """Age one HBM-evicted entry into the host tier (d2h — the
        ``spill_plan("hbm", "host")`` leg), then age host entries past
        ``spill_host_max_bytes`` to disk or drop them by the
        expected-reuse gate. Never raises into the eviction loop: a
        failed demotion degrades to exactly the historical drop."""
        try:
            self._demote(key, ent)
        except Exception:
            self.dropped += 1
            _log.warning("spill: demotion of %s failed; entry dropped "
                         "(the historical eviction)", ent.key_hash,
                         exc_info=True)

    def _demote(self, key: str, ent) -> None:
        t0 = _now_ms()
        arr = to_host(ent.result.data)        # the d2h leg
        d2h_ms = _now_ms() - t0
        te = TierEntry(
            tier="host", meta=_entry_meta(ent), nbytes=ent.nbytes,
            hits=ent.hits, array=arr, dep_ids=ent.dep_ids,
            pins=ent.pins, expr=ent.expr, fleet=ent.fleet,
            provenance=ent.provenance, ivm_id=ent.ivm_id)
        legs = [{"leg": "d2h", "bytes": float(ent.nbytes),
                 "ms": round(d2h_ms, 4)}]
        with self._lock:
            old = self._host.pop(key, None)
            if old is not None:
                self._host_bytes -= old.nbytes
            self._host[key] = te
            self._host_bytes += te.nbytes
            self.demoted_host += 1
            aged = self._age_host(legs)
        self._emit("demote", te.meta, "host", legs,
                   aged_to_disk=aged)

    def _age_host(self, legs: list) -> int:
        """Host-tier pressure (caller holds the lock): LRU entries
        past the host byte budget age to disk when a disk tier exists
        AND their lifetime hits clear the expected-reuse gate;
        otherwise they drop — the value was never re-used, so pushing
        it down a slower tier buys nothing."""
        aged = 0
        while (self._host
               and self._host_bytes > self.config.spill_host_max_bytes):
            k, te = self._host.popitem(last=False)
            self._host_bytes -= te.nbytes
            if (self._dir is not None
                    and te.hits >= self.config.spill_disk_hits):
                t0 = _now_ms()
                file, sha1 = self._write_artifact(
                    te.meta["key_hash"], te.array)
                ms = _now_ms() - t0
                legs.append({"leg": "disk_write",
                             "bytes": float(te.nbytes),
                             "ms": round(ms, 4)})
                self._disk[k] = dataclasses.replace(
                    te, tier="disk", array=None, file=file, sha1=sha1)
                self._disk_bytes += te.nbytes
                self.demoted_disk += 1
                aged += 1
            else:
                self.dropped += 1
        self._host_bytes = max(self._host_bytes, 0)
        return aged

    def promote(self, key: str):
        """Thaw one lower-tier entry back into a device-resident
        CacheEntry (the ``ResultCache._thaw`` consult), or None. The
        entry leaves its tier — the cache re-inserts it at HBM. A
        disk artifact failing its sha1 is a MISS (dropped + counted +
        warned), never a wrong answer, never an exception out."""
        with self._lock:
            te = self._host.pop(key, None)
            if te is not None:
                self._host_bytes = max(self._host_bytes - te.nbytes, 0)
                src = "host"
            else:
                te = self._disk.pop(key, None)
                if te is None:
                    return None
                self._disk_bytes = max(self._disk_bytes - te.nbytes, 0)
                src = "disk"
        # the entry has left its tier, so it is this caller's alone: the
        # read and the h2d leg (a device sync) run outside the lock
        return self._thaw(key, te, src_tier=src)

    def _thaw(self, key: str, te: TierEntry, src_tier: str):
        """TierEntry → CacheEntry: read (disk) + h2d, stamped with the
        priced legs so MV117 can re-check the move against the plan
        vocabulary. Called without the lock on an entry already taken
        out of its tier; the counters it bumps take the lock."""
        from matrel_tpu_torch.serve.result_cache import CacheEntry
        legs = []
        arr = te.array
        if arr is None:
            try:
                t0 = _now_ms()
                arr = self._read_artifact(te)
                legs.append({"leg": "disk_read",
                             "bytes": float(te.nbytes),
                             "ms": round(_now_ms() - t0, 4)})
            except SnapshotCorruption as e:
                with self._lock:
                    self.corrupt += 1
                _log.warning("spill: %s — treating as a cache miss "
                             "(the query recomputes)", e)
                return None
        t0 = _now_ms()
        bm = self._to_device(arr, te.meta)
        legs.append({"leg": "h2d", "bytes": float(te.nbytes),
                     "ms": round(_now_ms() - t0, 4)})
        stamp = self._price_stamp(src_tier, te, legs)
        ent = CacheEntry(
            key_hash=te.meta["key_hash"], result=bm, pins=te.pins,
            dep_ids=te.dep_ids, layout=te.meta["layout"],
            dtype=te.meta["dtype"], nbytes=te.nbytes, expr=te.expr,
            prec=te.meta.get("prec", ""),
            err_bound=te.meta.get("err_bound", 0.0),
            delta_gen=te.meta.get("delta_gen", 0),
            delta_rule=te.meta.get("delta_rule"),
            ivm_id=te.ivm_id, fleet=te.fleet,
            provenance=te.provenance, hits=te.hits, spill=stamp)
        with self._lock:
            self.promoted += 1
        self._emit("promote", te.meta, src_tier, legs,
                   est_ms=stamp["est_ms"], cost=stamp["cost"])
        return ent

    def _price_stamp(self, src_tier: str, te: TierEntry,
                     legs: list) -> dict:
        """The ``entry.spill`` provenance stamp: the staged plan's leg
        tokens (reshard vocabulary), its coefficient-priced bill, and
        whether the device transient fit the peak-HBM budget — what
        MV117 re-checks."""
        from matrel_tpu_torch.obs import drift
        from matrel_tpu_torch.parallel import coeffs, reshard
        # restored entries ARE disk-tier entries (the snapshot's index
        # just keys them by name); the plan prices the same legs
        plan = reshard.spill_plan(
            "disk" if src_tier == "restored" else src_tier,
            "hbm", te.nbytes)
        leg_names = [reshard.spill_leg(s) for s in plan.steps]
        est_ms, cost = coeffs.spill_cost_ms(
            leg_names, te.nbytes, drift.shape_class(te.meta["shape"]),
            self._backend(), drift.table_path(self.config))
        return {"tier": src_tier, "legs": leg_names,
                "est_ms": round(est_ms, 4), "cost": cost,
                "fits": plan.fits(
                    float(self.config.reshard_peak_budget_bytes)),
                "measured": legs}

    # -- restored-entry index (the warm-restart face) -----------------------

    def seed_restored(self, entries: Dict[str, TierEntry]) -> int:
        """Install a loaded snapshot's name-keyed disk-tier index
        (load_snapshot's seam). Returns the count installed."""
        with self._lock:
            self._restored.update(entries)
            return len(entries)

    def restored_count(self) -> int:
        with self._lock:
            return len(self._restored)

    def thaw_restored(self, name_key: str, prec: str, resolve):
        """Thaw one RESTORED entry by its session-independent name key
        iff its precision tier matches the asking query's and every
        dep NAME still resolves in the live catalog (``resolve: name
        -> matrix-or-None``). The thawed entry's dep ids/pins rebind
        to the LIVE catalog objects, so rebind invalidation works on
        it exactly like a locally-computed entry. None on any failure
        — a restored entry never answers a query it cannot prove it
        belongs to."""
        with self._lock:
            te = self._restored.get(name_key)
            if te is None or te.meta.get("prec", "") != prec:
                return None
            deps = []
            for nm in te.meta.get("dep_names") or ():
                m = resolve(nm)
                if m is None:
                    # the name is gone/unbound: the entry can never be
                    # proven current — drop it for good
                    self._restored.pop(name_key, None)
                    self.dropped += 1
                    return None
                deps.append(m)
            te = self._restored.pop(name_key)
        te = dataclasses.replace(
            te, dep_ids=frozenset(id(m) for m in deps),
            pins=tuple(deps))
        ent = self._thaw(name_key, te, src_tier="restored")
        if ent is not None:
            with self._lock:
                self.thawed_restored += 1
        return ent

    # -- invalidation cascades ---------------------------------------------

    def invalidate_deps(self, matrix_ids) -> int:
        """The rebind kill, cascaded: drop every host/disk entry whose
        dep ids intersect (ResultCache.invalidate_deps calls here)."""
        ids = frozenset(matrix_ids)
        n = 0
        with self._lock:
            for k in [k for k, te in self._host.items()
                      if te.dep_ids & ids]:
                te = self._host.pop(k)
                self._host_bytes = max(self._host_bytes - te.nbytes, 0)
                n += 1
            for k in [k for k, te in self._disk.items()
                      if te.dep_ids & ids]:
                te = self._disk.pop(k)
                self._disk_bytes = max(self._disk_bytes - te.nbytes, 0)
                self._remove_artifact(te)
                n += 1
        return n

    def invalidate_names(self, names) -> int:
        """The rebind kill for RESTORED entries, which carry dep NAMES
        instead of ids (session.register routes rebinds here when a
        restored index exists)."""
        names = frozenset(names)
        n = 0
        with self._lock:
            for k in [k for k, te in self._restored.items()
                      if names & frozenset(te.meta.get("dep_names")
                                           or ())]:
                self._restored.pop(k)
                n += 1
        return n

    def discard(self, key: str) -> bool:
        """Drop one entry from whichever tier holds it
        (ResultCache.drop's cascade)."""
        with self._lock:
            te = self._host.pop(key, None)
            if te is not None:
                self._host_bytes = max(self._host_bytes - te.nbytes, 0)
                return True
            te = self._disk.pop(key, None)
            if te is not None:
                self._disk_bytes = max(self._disk_bytes - te.nbytes, 0)
                self._remove_artifact(te)
                return True
            return self._restored.pop(key, None) is not None

    def clear(self) -> None:
        with self._lock:
            for te in self._disk.values():
                self._remove_artifact(te)
            self._host.clear()
            self._disk.clear()
            self._restored.clear()
            self._host_bytes = 0
            self._disk_bytes = 0

    def info(self) -> dict:
        with self._lock:
            return {"host_entries": len(self._host),
                    "host_bytes": self._host_bytes,
                    "disk_entries": len(self._disk),
                    "disk_bytes": self._disk_bytes,
                    "restored_entries": len(self._restored),
                    "demoted_host": self.demoted_host,
                    "demoted_disk": self.demoted_disk,
                    "promoted": self.promoted,
                    "thawed_restored": self.thawed_restored,
                    "dropped": self.dropped,
                    "corrupt": self.corrupt}

    def items_for_snapshot(self):
        """(key, TierEntry) pairs across host+disk tiers plus the
        still-frozen restored index — save_state's read surface (a
        list copy, the items_snapshot discipline)."""
        with self._lock:
            return (list(self._host.items()), list(self._disk.items()),
                    dict(self._restored))

    # -- IO primitives (the one place serve/ touches files) -----------------

    def _backend(self) -> str:
        return self.mesh.device.type

    def _to_device(self, arr: torch.Tensor, meta: dict):
        """Host tensor + tier metadata → the device-resident
        BlockMatrix a thawed CacheEntry serves (the h2d leg). Bit
        exact: every tier keeps the payload's bits, so int paths stay
        int and bf16 stays bf16."""
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix
        from matrel_tpu_torch.utils.checkpoint import _spec_from_json
        spec = _spec_from_json(meta["spec"])
        data = arr.to(self.mesh.device)
        if data.is_cuda:
            # the leg's clock stops when the bytes have landed
            torch.cuda.synchronize(data.device)
        return BlockMatrix(
            data=data, shape=tuple(meta["shape"]), mesh=self.mesh,
            spec=spec, nnz=meta.get("nnz"),
            block_size=meta.get("block_size") or 512,
            integral=bool(meta.get("integral")),
            int_abs_max=meta.get("int_abs_max"))

    def _write_artifact(self, key_hash: str, arr: torch.Tensor,
                        directory: Optional[str] = None):
        """One sha1-verified ``.npy`` artifact (the checkpoint
        format's atomic tmp+rename and streamed-checksum discipline,
        per entry). Returns (path, sha1)."""
        from matrel_tpu_torch.utils.checkpoint import (_check_name,
                                                       _file_sha1,
                                                       tensor_to_host)
        d = directory or self._dir
        if d is None:
            raise ValueError("spill: no disk tier (state_dir unset)")
        _check_name(key_hash)
        os.makedirs(d, exist_ok=True)
        final = os.path.join(d, f"{key_hash}{_artifact_suffix(self.mesh)}"
                                f".npy")
        tmp = f"{final}.tmp{os.getpid()}"
        # an open handle, not a path: np.save appends ".npy" to a bare
        # path, which would break the atomic tmp -> final rename
        with open(tmp, "wb") as f:
            np.save(f, tensor_to_host(arr))
        sha1 = _file_sha1(tmp)
        os.replace(tmp, final)
        return final, sha1

    def _read_artifact(self, te: TierEntry) -> torch.Tensor:
        """Read + sha1-verify one disk-tier artifact; raises the typed
        SnapshotCorruption on mismatch/unreadability (callers treat it
        as a miss — never a wrong answer)."""
        from matrel_tpu_torch.utils.checkpoint import (_file_sha1,
                                                       host_to_tensor)
        try:
            got = _file_sha1(te.file)
        except OSError as e:
            raise SnapshotCorruption(te.file or "?", str(e)) from e
        if te.sha1 is not None and got != te.sha1:
            raise SnapshotCorruption(
                te.file, f"sha1 mismatch (stored {te.sha1[:12]}…, "
                         f"computed {got[:12]}…)")
        try:
            return host_to_tensor(np.load(te.file))
        except (OSError, ValueError) as e:
            raise SnapshotCorruption(te.file, str(e)) from e

    def _remove_artifact(self, te: TierEntry) -> None:
        """Best-effort unlink of an invalidated disk-tier artifact —
        never let a bad disk fail an invalidation (the value is
        already unreachable through the index)."""
        if te.file:
            try:
                os.remove(te.file)
            except OSError:
                pass

    def _emit(self, op: str, meta: dict, tier: str, legs: list,
              **extra) -> None:
        """One ``spill`` obs record per demote/promote/thaw (the
        drift auditor ingests the measured legs as ``spill:<leg>``
        calibration samples — obs/drift.iter_samples). Never fails
        the cache operation."""
        if self.emit is None:
            return
        try:
            rec = {"op": op, "tier": tier,
                   "key_hash": meta.get("key_hash"),
                   "nbytes": meta.get("nbytes"),
                   "dims": list(meta.get("shape") or ()),
                   "legs": legs, "backend": self._backend()}
            rec.update(extra)
            self.emit(rec)
        except Exception:
            _log.warning("obs: spill event dropped", exc_info=True)


# ---------------------------------------------------------------------------
# Durable-state snapshots — save_state / load_snapshot
# ---------------------------------------------------------------------------


def _names_by_id(catalog: dict) -> Dict[int, str]:
    return {id(m): name for name, m in catalog.items()}


def _dep_names(dep_ids, names_by_id) -> Optional[list]:
    """dep id set → sorted catalog names, or None when any dep is an
    ad-hoc (unnamed) matrix — such an entry cannot be re-proven
    against a restored catalog and is skipped at save."""
    out = []
    for i in dep_ids:
        nm = names_by_id.get(i)
        if nm is None:
            return None
        out.append(nm)
    return sorted(out)


def save_state(session, directory: Optional[str] = None) -> dict:
    """Snapshot one session's durable state under ``directory``
    (default ``config.state_dir``): catalog matrices + the state dict
    via the checkpoint step format at ``<dir>/state``, result-cache
    entries as sha1-verified artifacts under ``<dir>/spill`` indexed
    by their session-independent NAME keys, the fleet directory, MQO
    template keys, and the autotune/drift tables. Returns the summary
    (also what the ``restart`` history line rolls up). Entries whose
    key or deps touch unnamed matrices are skipped (counted) — they
    cannot be re-proven against a restored catalog."""
    from matrel_tpu_torch.serve import placement as placement_lib
    from matrel_tpu_torch.utils.checkpoint import (CheckpointManager,
                                                   split_catalog)

    root = directory or session.config.state_dir
    if not root:
        raise ValueError(
            "save_state needs a directory: pass one or set "
            "config.state_dir")
    t0 = _now_ms()
    spill_dir = os.path.join(root, "spill")
    names = _names_by_id(session.catalog)
    index = []
    skipped = 0

    def _index_entry(nk, te: TierEntry, file: str, sha1: str,
                     dep_names: list) -> None:
        meta = dict(te.meta)
        meta["dep_names"] = dep_names
        index.append({"nk": nk, "file": os.path.relpath(file, root),
                      "sha1": sha1, "nbytes": te.nbytes,
                      "hits": te.hits, "meta": meta})

    mgr = None
    if session._spill is not None:
        mgr = session._spill

    def _freeze(nk, te: TierEntry, dep_names) -> None:
        nonlocal skipped
        if te.array is not None:
            writer = mgr._write_artifact if mgr is not None else None
            if writer is None:
                skipped += 1
                return
            file, sha1 = writer(te.meta["key_hash"], te.array,
                                directory=spill_dir)
            _index_entry(nk, te, file, sha1, dep_names)
        elif te.file:
            file = te.file
            inside = os.path.abspath(file).startswith(
                os.path.abspath(root) + os.sep)
            if not inside:
                # snapshot must be self-contained: a disk-tier
                # artifact living outside this snapshot root is
                # copied in (saving to the default state_dir never
                # takes this branch — the tiers already live there)
                import shutil
                os.makedirs(spill_dir, exist_ok=True)
                dst = os.path.join(spill_dir, os.path.basename(file))
                shutil.copy2(file, dst)
                file = dst
            _index_entry(nk, te, file, te.sha1, dep_names)
        else:
            skipped += 1

    # HBM entries: freeze through the same artifact writer
    for key, ent in session._result_cache.items_snapshot():
        nk = (placement_lib.fleet_key(ent.expr, names)
              if ent.expr is not None else None)
        dn = _dep_names(ent.dep_ids, names)
        if nk is None or dn is None or mgr is None:
            skipped += 1
            continue
        arr = to_host(ent.result.data)
        te = TierEntry(tier="host", meta=_entry_meta(ent),
                       nbytes=ent.nbytes, hits=ent.hits, array=arr)
        _freeze(nk, te, dn)
    if mgr is not None:
        host_items, disk_items, restored = mgr.items_for_snapshot()
        for _key, te in host_items:
            nk = (placement_lib.fleet_key(te.expr, names)
                  if te.expr is not None else None)
            dn = _dep_names(te.dep_ids, names)
            if nk is None or dn is None:
                skipped += 1
                continue
            _freeze(nk, te, dn)
        for _key, te in disk_items:
            nk = (placement_lib.fleet_key(te.expr, names)
                  if te.expr is not None else None)
            dn = _dep_names(te.dep_ids, names)
            if nk is None or dn is None:
                skipped += 1
                continue
            _freeze(nk, te, dn)
        # a not-yet-thawed restored index carries forward verbatim —
        # its entries already hold name keys + dep names
        for nk, te in restored.items():
            _freeze(nk, te, list(te.meta.get("dep_names") or ()))

    mesh = session.mesh
    if mesh.ranked:
        index = _merge_rank_indexes(index, mesh)
    state = {
        "spill_schema": SNAPSHOT_SCHEMA,
        "rc_index": index,
        "rc_skipped": skipped,
        "fleet": _export_fleet(session),
        "mqo_templates": _export_templates(session),
        "tables": _export_tables(session.config),
    }
    ckpt = CheckpointManager(os.path.join(root, "state"),
                             config=session.config)
    step = ckpt.next_step()
    if mesh.ranked:
        # rank 0 writes the step: every rank names the one it will
        from matrel_tpu_torch.parallel import collectives as coll
        step = coll.broadcast_object(step, mesh)
    dense, sparse, other = split_catalog(session.catalog)
    if other:
        _log.warning("save_state: catalog table(s) %s have no checkpoint "
                     "entry (COO) and are not saved", other)
    path = ckpt.save(step, matrices=dense, sparse=sparse, state=state,
                     mesh=mesh)
    if mesh.ranked:
        # no rank reads the snapshot before rank 0 has committed it
        coll.barrier(mesh)
    summary = {"path": path, "step": step,
               "catalog": len(dense) + len(sparse),
               "rc_entries": len(index), "rc_skipped": skipped,
               "ms": round(_now_ms() - t0, 3)}
    if other:
        summary["catalog_skipped"] = other
    return summary


def _merge_rank_indexes(index: list, mesh) -> list:
    """Every rank's index records, merged for the one snapshot rank 0
    writes: each record keeps its name key and metadata and carries the
    artifact of every rank (``files`` / ``sha1s``, in rank order). The
    ranks froze the same entries in the same order (they ran the same
    queries); a disagreement raises rather than index a wrong block."""
    from matrel_tpu_torch.parallel import collectives as coll
    per_rank = coll.gather_objects(
        [(r["nk"], r["file"], r["sha1"]) for r in index], mesh)
    out = []
    for i, rec in enumerate(index):
        got = [recs[i] if i < len(recs) else None for recs in per_rank]
        if any(g is None or g[0] != rec["nk"] for g in got):
            raise RuntimeError("save_state: the ranks froze different "
                               "result-cache entries")
        rec = dict(rec)
        del rec["file"], rec["sha1"]
        rec["files"] = [g[1] for g in got]
        rec["sha1s"] = [g[2] for g in got]
        out.append(rec)
    if any(len(recs) != len(index) for recs in per_rank):
        raise RuntimeError("save_state: the ranks froze different "
                           "result-cache entries")
    return out


def _export_fleet(session):
    """Name-keyed fleet-directory records, or None without a fleet.
    Affinity hints only: a restored directory warms routing, it proves
    nothing (``serve/fleet.py``)."""
    if session._fleet is None:
        return None
    try:
        return session._fleet.export_directory()
    except Exception:
        _log.warning("save_state: fleet directory not exported",
                     exc_info=True)
        return None


def _export_templates(session):
    """MQO template KEYS only: compiled programs hold device buffers
    and lowered closures no snapshot can carry — the restored index
    warms the template bookkeeping, programs recompile lazily on
    first rebind."""
    if session._mqo is None:
        return None
    try:
        return session._mqo.template_keys()
    except Exception:
        _log.warning("save_state: mqo templates not exported",
                     exc_info=True)
        return None


def _export_tables(config) -> dict:
    """The learned-state tables, embedded as parsed JSON (not paths:
    a snapshot must be self-contained across machines)."""
    out = {}
    from matrel_tpu_torch.obs import drift
    from matrel_tpu_torch.parallel import autotune
    for name, path in (("autotune", autotune._table_path(config)),
                       ("drift", drift.table_path(config))):
        try:
            with open(path) as f:
                out[name] = json.load(f)
        except (OSError, ValueError):
            out[name] = None
    return out


def load_snapshot(session, directory: Optional[str] = None) -> dict:
    """Restore a :func:`save_state` snapshot into a fresh session —
    the warm-restart path. EVERY component is robust-read: a corrupt/
    truncated snapshot (or any single bad component) warns and
    cold-starts that component, never crashes the restore (a
    disk-tier entry that later fails its
    sha1 surfaces as a per-entry miss via SnapshotCorruption
    handling). Returns the restore summary."""
    from matrel_tpu_torch.resilience.errors import CheckpointCorruption
    from matrel_tpu_torch.utils.checkpoint import CheckpointManager

    root = directory or session.config.state_dir
    if not root:
        raise ValueError(
            "restore needs a directory: pass one or set "
            "config.state_dir")
    t0 = _now_ms()
    out = {"restored": False, "catalog": 0, "rc_entries": 0,
           "fleet": 0, "mqo_templates": 0, "tables": []}
    try:
        got = CheckpointManager(
            os.path.join(root, "state"),
            config=session.config).restore_all(session.mesh)
    except (CheckpointCorruption, OSError, ValueError) as e:
        _log.warning("restore: snapshot at %s unreadable (%s); "
                     "cold-starting", root, e)
        out["reason"] = str(e)
        return out
    if got is None:
        out["reason"] = "no snapshot"
        return out
    step, mats, sparse, _arrays, state = got
    mats = {**mats, **sparse}
    if not isinstance(state, dict) \
            or state.get("spill_schema") != SNAPSHOT_SCHEMA:
        _log.warning("restore: snapshot at %s has foreign schema %r; "
                     "cold-starting", root,
                     (state or {}).get("spill_schema"))
        out["reason"] = "foreign schema"
        return out
    _check_world(state.get("rc_index") or (), session.mesh)
    out["restored"] = True
    out["step"] = step
    # catalog — through register(), the load_catalog discipline
    for name in sorted(mats):
        try:
            session.register(name, mats[name])
            out["catalog"] += 1
        except Exception:
            _log.warning("restore: catalog entry %r skipped", name,
                         exc_info=True)
    out["tables"] = _restore_tables(session.config,
                                    state.get("tables") or {})
    out["rc_entries"] = _restore_rc_index(session, root,
                                          state.get("rc_index") or ())
    out["fleet"] = _restore_fleet(session, state.get("fleet"))
    out["mqo_templates"] = _restore_templates(
        session, state.get("mqo_templates"))
    out["ms"] = round(_now_ms() - t0, 3)
    return out


def _check_world(rc_index, mesh) -> None:
    """Refuse (:class:`SnapshotGridMismatch`) a snapshot whose cached
    results are blocks of another grid than this mesh's, before
    anything is registered."""
    current = _world(mesh)
    for rec in rc_index:
        meta = rec.get("meta") if isinstance(rec, dict) else None
        if isinstance(meta, dict) and meta.get("world") != current:
            raise SnapshotGridMismatch(meta.get("world"), current)


def _restore_rc_index(session, root: str, rc_index) -> int:
    """Seed the spill manager's restored index from the snapshot's
    name-keyed entry records. Requires an attached spill hierarchy
    (``spill_enable``) — without one there is no thaw path, so the
    entries are skipped (the zero-object default stays zero)."""
    if session._spill is None:
        if rc_index:
            _log.warning(
                "restore: %d cached result(s) in the snapshot but "
                "spill_enable is off — skipped (repeats recompute)",
                len(rc_index))
        return 0
    entries = {}
    for rec in rc_index:
        try:
            meta = dict(rec["meta"])
            if "files" in rec:
                # a rank grid's snapshot: this rank's own block
                r = session.mesh.ranks.rank
                file, sha1 = rec["files"][r], rec["sha1s"][r]
            else:
                file, sha1 = rec["file"], rec.get("sha1")
            entries[rec["nk"]] = TierEntry(
                tier="restored", meta=meta,
                nbytes=int(rec["nbytes"]),
                hits=int(rec.get("hits") or 0),
                file=os.path.join(root, file), sha1=sha1)
        except (KeyError, TypeError, ValueError):
            _log.warning("restore: malformed rc index record skipped",
                         exc_info=True)
    return session._spill.seed_restored(entries)


def _restore_tables(config, tables: dict) -> list:
    """Write the embedded autotune/drift tables to their configured
    paths IF ABSENT — a live table on the restore host is newer truth
    than the snapshot; never clobber it. Returns the names written."""
    from matrel_tpu_torch.obs import drift
    from matrel_tpu_torch.parallel import autotune
    written = []
    for name, path in (("autotune", autotune._table_path(config)),
                       ("drift", drift.table_path(config))):
        payload = tables.get(name)
        if not isinstance(payload, dict) or os.path.exists(path):
            continue
        try:
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(payload, f, indent=1)
            os.replace(tmp, path)
            written.append(name)
        except OSError:
            _log.warning("restore: %s table not written", name,
                         exc_info=True)
    return written


def _restore_fleet(session, records) -> int:
    """Seed a fleet session's directory with a snapshot's demand hints
    (building the fleet if it is not yet); a session without
    ``fleet_slices`` seeds nothing."""
    if not records or session.config.fleet_slices < 1:
        return 0
    try:
        fleet = session._ensure_fleet()
    except Exception:
        _log.warning("restore: fleet not built", exc_info=True)
        return 0
    try:
        return fleet.seed_directory(records)
    except Exception:
        _log.warning("restore: fleet directory not seeded",
                     exc_info=True)
        return 0


def _restore_templates(session, keys) -> int:
    if not keys or not session._cse_on():
        return 0
    try:
        return session._mqo_state().seed_templates(keys)
    except Exception:
        _log.warning("restore: mqo templates not seeded",
                     exc_info=True)
        return 0
