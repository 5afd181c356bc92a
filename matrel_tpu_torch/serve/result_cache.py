"""Cross-query materialized-result cache — the counterpart of
``matrel_tpu/serve/result_cache.py`` (the MatFast persist/RDD-cache
analogue).

Entries map the canonical structural plan key of an executed expression
(``session._plan_key`` — the key the compiled-plan cache uses) to the
BlockMatrix it produced. Every object the key references by id() rides
the entry's ``pins`` tuple — the torch tensors' owners (BlockMatrix,
BlockSparseMatrix, COOMatrix) and id-keyed callables — so an address can
never be garbage-collected and reused into a false hit.

Invalidation: each entry records the id() set of every source matrix it
was computed from (``dep_ids``, transitively through entries it itself
consumed). A catalog rebind invalidates every entry whose deps intersect
the rebound matrix; dep ids are only ever compared against live catalog
objects, so a recycled address can at worst invalidate a valid entry.

Eviction: byte-budgeted LRU over the device bytes each cached result
pins (its padded tensor). A result larger than the whole budget is never
inserted. Thread-safe — the serve pipeline's worker and the caller's
thread share one cache (one RLock, ``"serve.result_cache"`` in the
lockdep inventory, ``utils/lockdep.py``).

With ``spill_enable`` a ``serve/spill.py`` SpillManager is attached:
evictions demote to host RAM (then disk) instead of dropping, and a miss
thaws from the lower tiers. Without it ``spill`` stays None and those
branches never run.
"""

from __future__ import annotations

import dataclasses
import hashlib
import logging
from collections import OrderedDict
from typing import FrozenSet, Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.resilience.retry import now as _now
from matrel_tpu_torch.utils import lockdep

_log = logging.getLogger("matrel_tpu_torch.serve")

#: warn-once latch for the result_nbytes fallback (list so tests can
#: reset it without a global statement)
_NBYTES_WARNED = [False]


def _itemsize(dtype) -> int:
    """Bytes an element of a torch or numpy dtype takes."""
    if isinstance(dtype, torch.dtype):
        return int(dtype.itemsize)
    return int(np.dtype(dtype).itemsize)


def result_nbytes(result: BlockMatrix) -> int:
    """Device bytes a cached result pins: its PADDED tensor,
    ``numel() * element_size()`` (bf16 sizes as 2 bytes — the JAX
    package's numpy-dtype sizing has no bf16 and would fall back); on a
    rank mesh the whole padded value's.

    A foreign array with a shape and dtype sizes the same way. One
    missing even those must NOT size as 0 — a 0-byte entry escapes the
    LRU byte budget entirely — so it falls back to the unpadded
    ``shape × itemsize`` estimate (itemsize 4 when the dtype is gone
    too), warning once."""
    data = getattr(result, "data", None)
    if isinstance(data, torch.Tensor):
        mesh = getattr(result, "mesh", None)
        if getattr(mesh, "ranked", False):
            # a rank holds one block: the entry is sized as the whole
            # padded value, as the JAX package sizes a sharded array,
            # so every rank's budget evicts what one card's would
            ps = result.padded_shape
            return int(ps[0]) * int(ps[1]) * int(data.element_size())
        return int(data.numel()) * int(data.element_size())
    try:
        return int(np.prod(data.shape)) * _itemsize(data.dtype)
    except (AttributeError, TypeError):
        pass
    try:
        itemsize = _itemsize(data.dtype)
    except (AttributeError, TypeError):
        itemsize = 4            # f32, the package-wide default dtype
    try:
        est = int(result.shape[0]) * int(result.shape[1]) * itemsize
    except (AttributeError, TypeError, IndexError):
        est = 0                 # not a BlockMatrix at all
    if not _NBYTES_WARNED[0]:
        _NBYTES_WARNED[0] = True
        _log.warning(
            "result_nbytes: cached result's array has no usable "
            "shape/dtype; falling back to the unpadded shape*itemsize "
            "estimate (%d bytes) for LRU accounting (warned once)", est)
    return est


@dataclasses.dataclass
class CacheEntry:
    """One cached query result (the JAX package's fields).

    key_hash: short digest of the structural key (the full key embeds
      id()s and means nothing across sessions).
    result: the executed BlockMatrix (on the session's device).
    pins: every object the structural key references by id() — held so
      no keyed address can be recycled into a false hit.
    dep_ids: id() of every source matrix this result depends on,
      transitively through consumed cache entries — the
      catalog-rebind invalidation set.
    layout: planner layout ("2d"/"row"/"col"/"rep"/"other") of the
      result's spec at insertion — what a substituted leaf claims.
    dtype: the result's dtype name at insertion ("float32",
      "bfloat16" — the JAX package's numpy names).
    nbytes: device bytes the entry pins (eviction accounting).
    expr: the query this result computed (pre-substitution, rebased
      onto the live binding when patched) — what the delta plane
      (``ir/delta.py``) derives patches from.
    prec: the precision-tier key prefix this entry keyed under.
    err_bound: composed error bound of the stored result (the stamped
      tier's bound at insertion plus each patch's); 0 = exact.
    delta_gen: delta generation of the last patch (0 = never patched).
    delta_rule: ``ir/delta.DELTA_RULES`` member of the last patch.
    ivm_id: stable identity across patch generations (the delta
      plane's patch-plan reuse key; None until first patched).
    provenance: compact lineage stamp written only through the
      provenance ledger's seams (``obs/provenance.py``); None while
      ``obs_provenance`` is off.
    fleet: multi-slice provenance of an entry replicated from another
      slice's cache (``serve/fleet.py``'s hot-entry replication writes
      ``{"owner", "layout", "dtype"}``; MV114 reads it). None for an
      entry computed where it lives.
    hits: lifetime consult count of this entry — the expected-reuse
      signal the spill policy's host→disk gate reads
      (``config.spill_disk_hits``).
    spill: tier provenance of an entry promoted back from a lower tier
      (``serve/spill.py``): ``{"tier": "host"/"disk"/"restored", "legs":
      [...], "est_ms": float, "cost": "measured"/"analytic", "fits":
      bool, "measured": [...]}`` — which tier it thawed from and the
      priced transfer legs it paid, which MV117 re-checks. None for an
      entry that has only ever lived on the device.
    """

    key_hash: str
    result: BlockMatrix
    pins: Tuple
    dep_ids: FrozenSet[int]
    layout: str
    dtype: str
    nbytes: int
    expr: Optional[object] = None
    prec: str = ""
    err_bound: float = 0.0
    delta_gen: int = 0
    delta_rule: Optional[str] = None
    ivm_id: Optional[int] = None
    fleet: Optional[dict] = None
    provenance: Optional[dict] = None
    hits: int = 0
    spill: Optional[dict] = None


class ResultCache:
    """Byte-budgeted LRU over :class:`CacheEntry`, structurally keyed.

    ``lookup`` is the ROOT-level consult (counts hit/miss — the ratio
    serve events and ``result_cache_info()`` report); ``probe`` is the
    interior-substitution consult (counts hits only — a miss there just
    means the walk recurses, not that a query missed the cache).
    """

    def __init__(self):
        self._lock = lockdep.make_rlock("serve.result_cache")
        self._entries: "OrderedDict[str, CacheEntry]" = OrderedDict()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.interior_hits = 0
        self.evicted = 0
        self.invalidated = 0
        # brownout stale graveyard: entries a
        # rebind invalidated, kept with their invalidation timestamp
        # so rung >= 2 can serve them to queries declaring a
        # staleness_ms tolerance. Populated ONLY when the session asks
        # (keep_stale=True — a brownout controller exists); the
        # default path drops invalidated entries exactly as before.
        # Bounded in ENTRIES and BYTES (stale results stay device-
        # pinned — an entry-only bound would let a few huge ghosts
        # retain device memory far past the live cache's byte budget).
        self._stale: "OrderedDict[str, tuple]" = OrderedDict()
        self._stale_bytes = 0
        self.stale_hits = 0
        # incremental view maintenance: lifetime counts
        # of entries PATCHED in place by a registered delta and of
        # entries renamed across a delta generation — both zero until
        # register_delta is ever used (the bit-identity contract)
        self.patched = 0
        self.rekeyed = 0
        # spill hierarchy (serve/spill.py): the
        # attached SpillManager, or None — the default, and the ONLY
        # state the default config ever sees (zero spill objects).
        # When attached, evictions DEMOTE instead of dropping and
        # lookup/probe fall through to the lower tiers on a miss.
        self.spill = None

    def attach_spill(self, spill) -> None:
        """Wire the tier hierarchy under this cache (session-build
        seam; ``config.spill_enable`` gates the one call site)."""
        with self._lock:
            self.spill = spill

    def _thaw(self, key: str) -> Optional[CacheEntry]:
        """Lower-tier consult on an HBM miss: promote the entry back
        (the spill manager prices + stages the move and stamps
        ``entry.spill``), re-insert it under the HBM budget, and hand
        it back — the caller counts the hit. The entry is served even
        when it no longer fits the HBM budget (a hit is a hit; it just
        isn't re-cached). Lock order: result_cache → spill, the same
        direction ``put``'s demotion takes."""
        if self.spill is None:
            return None
        ent = self.spill.promote(key)
        if ent is None:
            return None
        if not self.put(key, ent, self.spill.hbm_max_bytes,
                        self.spill.hbm_max_entries):
            # larger than the whole HBM budget: serve it, but park the
            # value back in the host tier instead of losing it
            self.spill.demote(key, ent)
        return ent

    def lookup(self, key: str) -> Optional[CacheEntry]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = self._thaw(key)
                if ent is None:
                    self.misses += 1
                    return None
                ent.hits += 1
                self.hits += 1
                return ent
            self._entries.move_to_end(key)
            ent.hits += 1
            self.hits += 1
            return ent

    def note_restored_hit(self) -> None:
        """Counter correction for the session's restored-snapshot
        consult: the first-level ``lookup`` already counted a miss
        before the name-keyed index thawed the value — a served answer
        must read as the hit it was."""
        with self._lock:
            self.misses = max(self.misses - 1, 0)
            self.hits += 1

    def probe(self, key: str) -> Optional[CacheEntry]:
        with self._lock:
            ent = self._entries.get(key)
            if ent is None:
                ent = self._thaw(key)
                if ent is None:
                    return None
                ent.hits += 1
                self.interior_hits += 1
                return ent
            self._entries.move_to_end(key)
            ent.hits += 1
            self.interior_hits += 1
            return ent

    def put(self, key: str, entry: CacheEntry, max_bytes: int,
            max_entries: int = 0) -> bool:
        """Insert (or refresh) an entry, evicting least-recently-used
        entries past ``max_bytes`` — and past ``max_entries`` when > 0:
        the byte budget counts each entry's RESULT, but the pins tuple
        also keeps the query's INPUT matrices alive, so tiny results
        over huge ad-hoc inputs could otherwise retain unbounded device
        memory while staying "within budget"; the count bound caps
        that. Returns False when the entry alone exceeds the whole byte
        budget (never inserted — it would evict everything and then
        itself be the next eviction)."""
        if entry.nbytes > max_bytes:
            return False
        with self._lock:
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
            # a fresh result supersedes any stale ghost of the key
            ghost = self._stale.pop(key, None)
            if ghost is not None:
                self._stale_bytes = max(
                    self._stale_bytes - ghost[0].nbytes, 0)
            self._entries[key] = entry
            self._bytes += entry.nbytes
            while self._entries and (
                    self._bytes > max_bytes
                    or (max_entries > 0
                        and len(self._entries) > max_entries)):
                k, dropped = self._entries.popitem(last=False)
                self._bytes -= dropped.nbytes
                self.evicted += 1
                # spill hierarchy: LRU pressure DEMOTES instead of
                # dropping — the value ages HBM → host (→ disk, the
                # manager's call) and a later consult thaws it back
                if self.spill is not None and k != key:
                    self.spill.demote(k, dropped)
            self._bytes = max(self._bytes, 0)
            return True

    def invalidate_deps(self, matrix_ids, keep_stale: bool = False,
                        stale_max: int = 0,
                        stale_max_bytes: int = 0) -> int:
        """Drop every entry whose dep set intersects ``matrix_ids``
        (id() values of LIVE matrices — see module docstring for why
        this comparison is safe). Returns the number dropped.

        ``keep_stale`` moves the invalidated entries into the stale
        graveyard (stamped with the invalidation clock) instead of
        discarding them — the brownout rung-2 substrate — bounded to
        the newest ``stale_max`` entries AND ``stale_max_bytes``
        device bytes (stale results stay device-pinned; the session
        passes the live cache's own byte budget, so ghosts can never
        retain more device memory than the cache itself is allowed).
        The default (False) is bit-identical to the historical drop."""
        ids = frozenset(matrix_ids)
        with self._lock:
            stale = [k for k, e in self._entries.items()
                     if e.dep_ids & ids]
            t = _now()
            for k in stale:
                ent = self._entries.pop(k)
                self._bytes -= ent.nbytes
                if keep_stale and stale_max > 0 \
                        and 0 < ent.nbytes <= stale_max_bytes:
                    old = self._stale.pop(k, None)
                    if old is not None:
                        self._stale_bytes -= old[0].nbytes
                    self._stale[k] = (ent, t)
                    self._stale_bytes += ent.nbytes
                    while self._stale and (
                            len(self._stale) > stale_max
                            or self._stale_bytes > stale_max_bytes):
                        _, (dropped, _t) = self._stale.popitem(
                            last=False)
                        self._stale_bytes -= dropped.nbytes
                    self._stale_bytes = max(self._stale_bytes, 0)
            dropped_n = len(stale)
            # the kill cascades into every tier: a host/disk copy of a
            # rebound-matrix result is exactly as wrong as an HBM one
            if self.spill is not None:
                dropped_n += self.spill.invalidate_deps(ids)
            self.invalidated += dropped_n
            self._bytes = max(self._bytes, 0)
            return dropped_n

    def holds(self, key: str) -> bool:
        """Is ``key`` resident? No LRU touch, no counter, no thaw: the
        side-effect-free view a rank reports to the decision log."""
        with self._lock:
            return key in self._entries

    def lookup_stale(self, key: str, max_age_ms: float,
                     peek: bool = False, aged: bool = False
                     ) -> Optional[CacheEntry]:
        """Brownout rung-2 consult: the STALE entry for ``key``, iff
        its age since invalidation fits the query's declared
        ``staleness_ms`` tolerance. Entries older than the asking
        query's tolerance stay (a later query may tolerate more);
        the graveyard stays bounded by the insert-side cap. ``peek``
        answers without touching the LRU or the counter (the lead
        rank's decision); ``aged`` skips the age test, which the lead
        already made on its own clock (every rank applying the
        decision)."""
        if max_age_ms is None or max_age_ms <= 0:
            return None
        with self._lock:
            got = self._stale.get(key)
            if got is None:
                return None
            ent, t_stale = got
            if not aged and (_now() - t_stale) * 1e3 > max_age_ms:
                return None
            if peek:
                return ent
            self._stale.move_to_end(key)
            self.stale_hits += 1
            return ent

    # -- incremental view maintenance — the ONE sanctioned patch/apply
    # -- seam: the only place entries are mutated ----------------------

    def items_snapshot(self):
        """(key, entry) pairs in LRU order — the delta plane's (and
        MV113's dynamic check's) read surface. A list copy: the plane
        mutates the cache through the seam while iterating."""
        with self._lock:
            return list(self._entries.items())

    def drop(self, key: str, keep_stale: bool = False,
             stale_max: int = 0, stale_max_bytes: int = 0) -> bool:
        """Invalidate ONE entry by key (the per-entry face of
        ``invalidate_deps`` — same counting, same brownout-graveyard
        semantics) — the delta plane's ineligible-entry fallback, so
        a kill here is indistinguishable from today's rebind kill."""
        with self._lock:
            if self.spill is not None and self.spill.discard(key):
                self.invalidated += 1
            ent = self._entries.pop(key, None)
            if ent is None:
                return False
            self._bytes = max(self._bytes - ent.nbytes, 0)
            self.invalidated += 1
            if keep_stale and stale_max > 0 \
                    and 0 < ent.nbytes <= stale_max_bytes:
                old = self._stale.pop(key, None)
                if old is not None:
                    self._stale_bytes -= old[0].nbytes
                self._stale[key] = (ent, _now())
                self._stale_bytes += ent.nbytes
                while self._stale and (
                        len(self._stale) > stale_max
                        or self._stale_bytes > stale_max_bytes):
                    _, (dropped, _t) = self._stale.popitem(last=False)
                    self._stale_bytes -= dropped.nbytes
                self._stale_bytes = max(self._stale_bytes, 0)
            return True

    def rekey(self, old_key: str, new_key: str) -> bool:
        """Rename a LIVE entry across a delta generation (payload
        untouched; key_hash re-derived so obs/MV107 stamps keep naming
        the key that actually maps to the entry). LRU position is
        preserved by insertion order of the rename pass."""
        with self._lock:
            ent = self._entries.pop(old_key, None)
            if ent is None:
                return False
            self._entries[new_key] = dataclasses.replace(
                ent, key_hash=hashlib.sha1(
                    new_key.encode()).hexdigest()[:16])
            self.rekeyed += 1
            return True

    def apply_patch(self, old_key: str, new_key: str,
                    entry: CacheEntry, max_bytes: int,
                    max_entries: int = 0) -> bool:
        """Replace a cached entry with its delta-PATCHED successor
        under the new generation's key — the in-place maintenance the
        transitive kill used to be. The old slot is removed without
        counting an invalidation (nothing was lost — the value was
        maintained); insertion goes through :meth:`put`, so byte/entry
        budgets and LRU eviction apply to patched entries exactly as
        to fresh ones. Returns False when the patched result no longer
        fits the budget — the OLD entry is then restored untouched, so
        the caller's fallback kill routes it through :meth:`drop` with
        the normal invalidation accounting and brownout-graveyard
        semantics (silently vanishing would undercount ``invalidated``
        and starve rung-2 stale serving of an entry it was owed)."""
        with self._lock:
            old = self._entries.pop(old_key, None)
            if old is not None:
                self._bytes = max(self._bytes - old.nbytes, 0)
            ok = self.put(new_key, entry, max_bytes, max_entries)
            if ok:
                self.patched += 1
            elif old is not None:
                self._entries[old_key] = old
                self._bytes += old.nbytes
            return ok

    def rebuild_stale(self, rename, dep_ids: FrozenSet[int]) -> None:
        """Carry the brownout graveyard across a delta generation:
        ghosts depending on the rebound matrix drop (their values are
        two bindings stale), the rest rename via ``rename(key) ->
        new_key`` so a later brownout can still serve them under the
        new generation's key format."""
        ids = frozenset(dep_ids)
        with self._lock:
            fresh: "OrderedDict[str, tuple]" = OrderedDict()
            for k, (ent, t) in self._stale.items():
                if ent.dep_ids & ids:
                    self._stale_bytes -= ent.nbytes
                    continue
                fresh[rename(k)] = (ent, t)
            self._stale = fresh
            self._stale_bytes = max(self._stale_bytes, 0)

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._stale.clear()
            self._bytes = 0
            self._stale_bytes = 0
            if self.spill is not None:
                self.spill.clear()

    def info(self) -> dict:
        """``plan_cache_info``-style observability snapshot. The
        ``spill`` sub-dict appears only when a hierarchy is attached —
        the default dict keeps its historical shape."""
        with self._lock:
            out = {"entries": len(self._entries),
                   "bytes": self._bytes,
                   "hits": self.hits,
                   "misses": self.misses,
                   "interior_hits": self.interior_hits,
                   "evicted": self.evicted,
                   "invalidated": self.invalidated,
                   "stale_entries": len(self._stale),
                   "stale_bytes": self._stale_bytes,
                   "stale_hits": self.stale_hits,
                   "patched": self.patched,
                   "rekeyed": self.rekeyed}
            if self.spill is not None:
                out["spill"] = self.spill.info()
            return out
