"""Measured choices — the counterpart of ``matrel_tpu/parallel/autotune.py``
for its matmul, SpMV, SpGEMM, fusion, reshard and IVM families.

The planner's cost model and the kernel registry's rules are estimates;
this module measures. For a shape class it times every admissible
candidate on the device through the real lowering path, records the
winner (or a tie), and persists it in a JSON table so that later
sessions inherit it:

* matmul strategies (``lookup_or_measure``): consulted by
  ``planner.choose_strategy_ex`` with ``config.autotune`` on, for dense
  operands of one known dtype laid out "2d" on a grid of more than one
  device (a 1 x 1 grid never asks);
* SpMV executor variants (``lookup_or_measure_spmv``): "compact" (the
  CSR-view kernels, B2/B3) against "expanded" (the one-hot tables),
  measured at compile time by ``executor._autotune_spmv_choices``;
* SpGEMM kernels (``lookup_or_measure_spgemm``): every registered
  kernel admissible on a structure class, over a synthetic operand pair
  of that class, consulted by ``kernel_registry.select_kernel``.
* fused regions (``lookup_or_measure_fusion``, the ``fuse|`` family):
  one region emitted both ways through the executor's unit-program
  seam — one unit for the region ("fused") against one per member op
  ("staged") — over synthetic probes; consulted by
  ``fusion.annotate_fusion``, where a measured "staged" winner
  suppresses the stamp;
* staged reshards (``lookup_or_measure_reshard``, the ``reshard|``
  family): a persisted row is honoured and single-step plans are never
  measured. On a rank mesh the step sequence is timed against one
  direct move; on one card both would time the same local copy, so
  ``measure_reshard_variant`` raises ``NotPortedError`` there, its
  candidates drop out and the model decides;
* IVM patch-vs-recompute (``lookup_or_measure_ivm``, the ``ivm|``
  family): the delta plane (``serve/ivm.py``) looks a winner up per
  (delta rule, side class); a measured "recompute" kills the entry
  instead of patching at a loss. Measured only when a caller hands both
  runners in.

On a rank mesh every rank takes rank 0's answer (``_agree``): whether a
row was found, and the medians measured, so all ranks pick one winner;
only rank 0 writes the table.

Keys and table format are the JAX package's, so both packages share one
table (default ``.matrel_autotune.json``); the backend field is the
type of the device measured on, "cuda" or "cpu". Loading prunes only
keys of no current format.
``config.strategy_override`` and
``config.spgemm_kernel_override`` still win over a measured winner.

Timing: matmul strategies by the JAX package's marginal method (the
median of three marginal estimates over chained dependent runs, each
chain ending in a scalar fetch); SpMV variants and SpGEMM kernels by the
host clock around one call that ends in a scalar fetch (so it includes
the synchronisation), the median of 5 after one warm call — the warm
call also builds a CUDA library at first use; fused regions by CUDA
events around each run on the card (the host clock on the CPU), the
median of 5 after one warm run. A winner within
``TIE_REL`` of the runner-up is recorded as a tie (None): the model
decides.
"""

from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import (MatrelConfig, NotPortedError,
                                     default_config)
from matrel_tpu_torch.core import mesh as mesh_lib, padding
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.parallel import planner, strategies

_log = logging.getLogger("matrel_tpu_torch.autotune")

# (best, times) per shape class; best is None when the measured winner
# was within TIE_REL of the runner-up (a tie: the byte model decides).
_CACHE: Dict[tuple, Tuple[Optional[str], Dict[str, float]]] = {}

TIE_REL = 0.10

_DEFAULT_TABLE = ".matrel_autotune.json"

#: ``ir/delta.py``'s rule vocabulary (not ported): the ``ivm|`` rows of
#: a shared table are current only for these rules.
DELTA_RULES = ("linear", "rank_k", "rank_k_both", "spgemm", "refine")


def backend_of(mesh) -> str:
    """The backend field of a key: the type of the device the mesh runs
    on ("cuda" or "cpu")."""
    return mesh.device.type


def dtype_name(dtype) -> str:
    """A dtype as the table keys spell it (numpy's name: "float32",
    "bfloat16")."""
    return str(dtype).replace("torch.", "")


def _weights_suffix(weights: Tuple[float, float]) -> str:
    return ("" if weights == (1.0, 1.0)
            else f"|w{weights[0]:g}x{weights[1]:g}")


def _table_path(config: Optional[MatrelConfig] = None) -> str:
    cfg = config or default_config()
    return cfg.autotune_table_path or _DEFAULT_TABLE


def _table_key(side: int, gx: int, gy: int, dtype: str, backend: str,
               weights: Tuple[float, float] = (1.0, 1.0)) -> str:
    """``side|gxXgy|dtype|backend[|w..]`` — a matmul row. The backend
    keeps one device's winner from serving another; non-uniform
    topology weights suffix the key."""
    return f"{side}|{gx}x{gy}|{dtype}|{backend}" + _weights_suffix(weights)


def load_table(path: str) -> Dict[str, dict]:
    """Persisted {key: {"best": choice, "times": {...}}}, or {}. An absent
    file is an empty table; a corrupt one is logged and read as empty.
    Keys of no current format (see :func:`_current_key_format`) are
    dropped, so the next :func:`_persist` rewrites a clean table."""
    try:
        with open(path) as f:
            t = json.load(f)
    except OSError:
        return {}
    except ValueError as e:
        _log.warning("autotune table %s is corrupt (%s); rebuilding from "
                     "empty", path, e)
        return {}
    if not isinstance(t, dict):
        _log.warning("autotune table %s has unexpected shape (%s); "
                     "rebuilding from empty", path, type(t).__name__)
        return {}
    return {k: v for k, v in t.items() if _current_key_format(k)}


def _current_key_format(key: str) -> bool:
    """Does a persisted key match a current key format of either
    package? Matmul ``side|gxXgy|dtype|backend`` (4 fields); SpMV
    ``spmv|backend|rows x cols|nb|cap|blk|grid`` (7); reshard
    ``reshard|src>dst|side|grid|backend`` (5); SpGEMM
    ``spgemm|<=side|structure|bs|grid|backend`` (6, the structure in the
    current classifier vocabulary); fusion ``fuse|sig|<=side|grid|backend``
    (5); IVM ``ivm|rule|side|grid|backend`` (5, the rule in
    :data:`DELTA_RULES`). Any may carry one trailing ``w<wx>x<wy>``
    field. The backend field's value is not checked: "tpu", "cpu" and
    "cuda" rows are all current."""
    if not isinstance(key, str):
        return False
    fields = key.split("|")
    n = len(fields)
    if key.startswith("spmv|"):
        base = 7
    elif key.startswith("reshard|"):
        base = 5
    elif key.startswith("spgemm|"):
        from matrel_tpu_torch.ir import stats
        base = 6
        if n >= 3 and fields[2] not in stats.STRUCTURE_CLASSES:
            return False
    elif key.startswith("fuse|"):
        base = 5
    elif key.startswith("ivm|"):
        base = 5
        if n >= 2 and fields[1] not in DELTA_RULES:
            return False
    else:
        base = 4
    if n == base:
        return True
    return n == base + 1 and fields[-1].startswith("w")


_TABLE_CACHE: Dict[str, Tuple[float, Dict[str, dict]]] = {}


def _load_table_cached(path: str) -> Dict[str, dict]:
    """:func:`load_table` memoised on (path, mtime): the planner consults
    the table on every matmul when ``config.autotune`` is on."""
    try:
        mtime = os.stat(path).st_mtime
    except OSError:
        mtime = -1.0
    hit = _TABLE_CACHE.get(path)
    if hit is not None and hit[0] == mtime:
        return hit[1]
    table = load_table(path)
    _TABLE_CACHE[path] = (mtime, table)
    return table


def _persist(path: str, key: str, best: Optional[str],
             times: Dict[str, float]) -> None:
    """Merge one measurement into the JSON table (atomic rename).

    An O_CREAT|O_EXCL lock file guards the read-merge-replace window; on
    contention the persist is skipped (the in-process cache still holds
    the measurement). A lock older than 60 s is presumed dead and
    broken; the breaker re-stats the lock and proceeds only when its
    inode is the one it created, so two breakers never both merge."""
    import torch.distributed as dist
    if dist.is_initialized() and dist.get_rank() != 0:
        return                  # ranks share one table: rank 0 writes it
    lock = f"{path}.lock"
    fd = None
    try:
        fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        try:
            st0 = os.stat(lock)
            if time.time() - st0.st_mtime <= 60.0:
                return
            # the inode changed since the staleness check: another
            # breaker got here first — never unlink its fresh lock
            if os.stat(lock).st_ino != st0.st_ino:
                return
            os.unlink(lock)
            fd = os.open(lock, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
            if os.stat(lock).st_ino != os.fstat(fd).st_ino:
                os.close(fd)   # a racing breaker re-created over ours;
                return         # it owns the window
        except OSError:
            if fd is not None:
                os.close(fd)
            return
    except OSError:
        fd = None    # lock unsupported (read-only FS): try unguarded
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        # (re-)load under the lock so a concurrent writer's entries
        # survive into this replace
        table = load_table(path)
        table[key] = {"best": best, "times": times}
        with open(tmp, "w") as f:
            json.dump(table, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
    finally:
        if fd is not None:
            try:
                # release only a lock this process still owns
                if os.stat(lock).st_ino == os.fstat(fd).st_ino:
                    os.unlink(lock)
            except OSError:
                pass
            os.close(fd)


def _pick_winner(results: Dict[str, float]) -> Optional[str]:
    """argmin with two guards: a one-variant comparison proves nothing
    (None), and a winner within TIE_REL of the runner-up is a tie
    (None) — the model decides."""
    if len(results) < 2:
        return None
    order = sorted(results, key=results.get)
    best, runner = order[0], order[1]
    if results[runner] <= results[best] * (1.0 + TIE_REL):
        return None
    return best


def _median_seconds(go, n_times: int) -> float:
    """One warm call, then the median host time of ``n_times`` calls
    (each ends in a scalar fetch, so it includes the synchronisation)."""
    go()
    ts = []
    for _ in range(max(n_times, 1)):
        t0 = time.perf_counter()
        go()
        ts.append(time.perf_counter() - t0)
    ts.sort()
    return ts[len(ts) // 2]


def _agree(value, mesh):
    """Rank 0's ``value`` on every rank of a rank mesh (``value`` itself
    elsewhere): every rank must take the same measured choice, and the
    same decision to measure, or their collectives stop matching."""
    if getattr(mesh, "ranked", False):
        from matrel_tpu_torch.parallel import collectives as coll
        return coll.broadcast_object(value, mesh)
    return value


def _measured(family: str, candidates, measure,
              mesh=None) -> Dict[str, float]:
    """{candidate: seconds} over ``candidates`` (rank 0's medians on
    every rank of a rank mesh). A candidate whose measurement raises
    drops out of the comparison, as in the JAX package, and is logged
    with its exception; a non-positive time is noise, not a time."""
    return _agree(_measured_here(family, candidates, measure), mesh)


def _measured_here(family: str, candidates, measure) -> Dict[str, float]:
    results: Dict[str, float] = {}
    for c in candidates:
        try:
            t = measure(c)
        except Exception as e:  # noqa: BLE001 — the JAX package's drop-out
            _log.warning("autotune %s: candidate %s dropped: %r", family,
                         c, e)
            continue
        if t > 0.0:
            results[c] = t
    return results


# -- matmul strategies --------------------------------------------------------


def measure_strategy(strategy: str, A: BlockMatrix, B: BlockMatrix,
                     config: MatrelConfig, reps: Tuple[int, int] = (2, 8),
                     n_estimates: int = 3, min_window_s: float = 0.05
                     ) -> float:
    """Marginal seconds per multiply for one strategy: the median of
    ``n_estimates`` marginal estimates (hi - lo chained dependent
    multiplies, each chain ending in a scalar fetch). When the long
    chain takes under ``min_window_s`` the reps are scaled up, to at
    most 48 multiplies. May return a non-positive value on a noisy host:
    callers treat that as no measurement."""
    mesh = A.mesh
    ranked = mesh.ranked
    a0, b0 = (A.as_shard(), B.as_shard()) if ranked else (A.data, B.data)

    def chained(n: int):
        # on a rank mesh each product is the recipe's re-lay and body,
        # the output fed back as the next left operand
        cur = a0
        for _ in range(n):
            cur = strategies.run_matmul(strategy, cur, b0, mesh, config,
                                        epilogue=lambda o: o.to(A.dtype))
        float((cur.local if ranked else cur).float().sum())

    def marginal(lo: int, hi: int) -> Tuple[float, float]:
        t0 = time.perf_counter()
        chained(lo)
        t_lo = time.perf_counter() - t0
        t0 = time.perf_counter()
        chained(hi)
        t_hi = time.perf_counter() - t0
        return (t_hi - t_lo) / (hi - lo), t_hi

    chained(2)  # warm
    lo, hi = reps
    est, t_hi = marginal(lo, hi)
    # the ranks of a rank mesh must run the same chains
    t_hi = _agree(t_hi, mesh)
    if t_hi < min_window_s:
        scale = min(max(2, round(min_window_s / max(t_hi, 1e-4))),
                    max(48 // hi, 1))
        if scale > 1:
            lo, hi = lo * scale, hi * scale
            est, t_hi = marginal(lo, hi)
    ests = [est]
    for _ in range(max(n_estimates, 1) - 1):
        ests.append(marginal(lo, hi)[0])
    ests.sort()
    return ests[len(ests) // 2]


def autotune_matmul(n: int, k: int, m: int, mesh=None, dtype="float32",
                    config: Optional[MatrelConfig] = None
                    ) -> Tuple[Optional[str], Dict[str, float]]:
    """Time every admissible strategy for an (n×k)·(k×m) multiply on this
    mesh's grid: (best or None, {strategy: seconds}), cached per (side,
    grid, dtype, backend, weights). Measured square at max(n, k, m) (the
    chain feeds each product back in). Persisted only with the closed
    loop on or a table named."""
    cfg = config or default_config()
    mesh = mesh or mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
    side = max(n, k, m)
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    wts = mesh_lib.axis_weights(mesh, cfg)
    key = (side, gx, gy, str(dtype), backend_of(mesh), wts)
    if key in _CACHE:
        _maybe_persist_cached(cfg, key)
        return _CACHE[key]
    A = BlockMatrix.random((side, side), mesh=mesh, seed=0, dtype=dtype)
    B = BlockMatrix.random((side, side), mesh=mesh, seed=1, dtype=dtype)
    pn, pk = padding.padded_shape((side, side), mesh)
    cands = [s for s in strategies.STRATEGIES
             if not (s == "summa" and gx != gy)
             and planner.admissible(s, pn, pk, pn, gx, gy)]
    results = _measured("matmul", cands,
                        lambda s: measure_strategy(s, A, B, cfg), mesh)
    best = _pick_winner(results)
    _CACHE[key] = (best, results)
    if results and (cfg.autotune or cfg.autotune_table_path):
        # an empty result set is never persisted: it would read as
        # "measured, no winner" and stop every later re-measurement
        _persist(_table_path(cfg),
                 _table_key(side, gx, gy, str(dtype), key[4], wts),
                 best, results)
    return best, results


def _maybe_persist_cached(config: Optional[MatrelConfig],
                          key: tuple) -> None:
    """A shape measured with persistence off still reaches the table
    when a later caller turns the closed loop on."""
    cfg = config or default_config()
    if not (cfg.autotune or cfg.autotune_table_path):
        return
    side, gx, gy, dtype, backend, wts = key
    best, results = _CACHE[key]
    if not results:
        return
    path = _table_path(cfg)
    tkey = _table_key(side, gx, gy, dtype, backend, wts)
    if tkey not in _load_table_cached(path):
        _persist(path, tkey, best, results)


def _cached_entry(cache: dict, key: str, cfg: MatrelConfig, mesh=None):
    """(found, best) from an in-process cache of {key: best}, else the
    persisted table (a persisted tie is a measurement too: it is cached,
    not re-measured), else (False, None) — rank 0's answer on a rank
    mesh."""
    if key in cache:
        return _agree((True, cache[key]), mesh)
    entry = _load_table_cached(_table_path(cfg)).get(key)
    if isinstance(entry, dict) and entry.get("times"):
        best = entry.get("best")
        return _agree((True, best if isinstance(best, str) else None), mesh)
    return _agree((False, None), mesh)


def lookup_or_measure(n: int, k: int, m: int, mesh, dtype: str = "float32",
                      config: Optional[MatrelConfig] = None
                      ) -> Optional[str]:
    """The planner's entry point (``config.autotune``): the measured
    winner for this shape class, or None when the cost model should
    decide. In-process cache, then the table, then one measurement —
    only for side ≤ ``autotune_max_dim`` (it allocates two side²
    operands) and not for strongly rectangular shapes (measured square,
    a winner would not carry over)."""
    cfg = config or default_config()
    side = max(n, k, m)
    if min(n, k, m) * 4 < side:
        return None
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    wts = mesh_lib.axis_weights(mesh, cfg)
    backend = backend_of(mesh)
    key = (side, gx, gy, str(dtype), backend, wts)
    if key in _CACHE:
        _maybe_persist_cached(cfg, key)
        return _CACHE[key][0]
    entry = _agree(_load_table_cached(_table_path(cfg)).get(
        _table_key(side, gx, gy, str(dtype), backend, wts)), mesh)
    if isinstance(entry, dict) and entry.get("times"):
        best = entry.get("best")
        best = best if isinstance(best, str) else None
        _CACHE[key] = (best, dict(entry.get("times", {})))
        return best
    if side > cfg.autotune_max_dim:
        return None
    best, _ = autotune_matmul(n, k, m, mesh=mesh, dtype=dtype, config=cfg)
    return best


# -- SpMV executor variants ---------------------------------------------------

_SPMV_CACHE: Dict[str, Optional[str]] = {}

#: The expanded one-hot tables cost ~224 bytes a padded slot; past this
#: budget the expanded variant is not even measured.
SPMV_EXPANDED_BUDGET_BYTES = 2 * 1024 ** 3

SPMV_VARIANTS = ("compact", "expanded")


def _spmv_key(plan, gx: int, gy: int, backend: str,
              weights: Tuple[float, float] = (1.0, 1.0)) -> str:
    """``spmv|backend|rows x cols|nb|cap|blk|grid[|w..]``."""
    nb, cap = plan.src8.shape
    return (f"spmv|{backend}|{plan.n_rows}x{plan.n_cols}|nb{nb}|cap{cap}"
            f"|blk{plan.block}|{gx}x{gy}" + _weights_suffix(weights))


def measure_spmv_variant(variant: str, plan, mesh,
                         config: Optional[MatrelConfig] = None,
                         n_times: int = 5) -> float:
    """Median seconds per matvec for one executor variant, through the
    lowering path (``Lowerer._coo_spmv_stack`` with the choice forced).
    The expanded probe builds and caches the one-hot tables on the plan
    (~224 B a slot); the plan's caches are restored afterwards, so a
    compact win pins none of them."""
    from matrel_tpu_torch import executor as executor_lib
    cfg = config or default_config()
    low = executor_lib.Lowerer(mesh, cfg)
    low.spmv_choice = {id(plan): (plan, variant)}
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        plan.n_cols).astype(np.float32), device=mesh.device)[:, None]
    saved = (dict(plan._tables), dict(plan._spmm_tables))
    try:
        return _median_seconds(
            lambda: float(low._coo_spmv_stack(plan, x).sum()), n_times)
    finally:
        if variant == "expanded":
            for cache, old in zip((plan._tables, plan._spmm_tables), saved):
                cache.clear()
                cache.update(old)


def _spmv_admissible(variant: str, plan, config: MatrelConfig) -> bool:
    from matrel_tpu_torch.config import pallas_enabled
    if variant == "compact":
        return pallas_enabled(config)
    nb, cap = plan.src8.shape
    return nb * cap * 224 <= SPMV_EXPANDED_BUDGET_BYTES


def lookup_or_measure_spmv(plan, mesh,
                           config: Optional[MatrelConfig] = None
                           ) -> Optional[str]:
    """The compile-time entry point (``config.autotune``): the measured
    executor variant for this plan's shape class, or None when the hand
    default stands. Which variants are admissible depends on the config
    (``use_pallas``, the expanded budget), which the key does not hold,
    so a one-variant result is neither a winner nor persisted."""
    cfg = config or default_config()
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    key = _spmv_key(plan, gx, gy, backend_of(mesh),
                    mesh_lib.axis_weights(mesh, cfg))
    found, best = _cached_entry(_SPMV_CACHE, key, cfg, mesh)
    if found:
        _SPMV_CACHE[key] = best
        return best
    results = _measured(
        "spmv", [v for v in SPMV_VARIANTS if _spmv_admissible(v, plan, cfg)],
        lambda v: measure_spmv_variant(v, plan, mesh, cfg), mesh)
    if len(results) < 2:
        _SPMV_CACHE[key] = None
        return None
    best = _pick_winner(results)
    _SPMV_CACHE[key] = best
    if cfg.autotune or cfg.autotune_table_path:
        _persist(_table_path(cfg), key, best, results)
    return best


# -- SpGEMM kernels -----------------------------------------------------------

_SPGEMM_CACHE: Dict[str, Optional[str]] = {}

#: Seeds of the synthetic probe pair, fixed so the measured population
#: is reproducible per key.
SPGEMM_PROBE_SEEDS = (0, 1)


def _spgemm_side_class(side: int) -> int:
    """Power-of-two side bucket: a 3800² and a 4096² S×S share a row."""
    return 1 << max(0, math.ceil(math.log2(max(int(side), 1))))


def _spgemm_key(side: int, structure: str, bs: int, gx: int, gy: int,
                backend: str,
                weights: Tuple[float, float] = (1.0, 1.0)) -> str:
    """``spgemm|<=side|structure|bs|grid|backend[|w..]``."""
    return (f"spgemm|<={_spgemm_side_class(side)}|{structure}|bs{bs}"
            f"|{gx}x{gy}|{backend}" + _weights_suffix(weights))


def spgemm_candidates(structure: str, bs: int,
                      config: Optional[MatrelConfig] = None) -> list:
    """The kernel ids measured for a structure class: the universal
    entries and the class's own specialisations, each admissible at
    ``bs`` under this config."""
    from matrel_tpu_torch.ops import kernel_registry as kr
    cfg = config or default_config()
    out = []
    for kid in kr.kernel_ids():
        spec = kr.get_kernel(kid)
        if not (spec.universal or structure in spec.structures):
            continue        # foreign specialisations are no candidates
        if kr.admissible(kid, bs, 1, cfg):   # eligibility, not size
            out.append(kid)
    return out


def measure_spgemm_kernel(kernel_id: str, A, B,
                          config: Optional[MatrelConfig] = None,
                          n_times: int = 5) -> float:
    """Median seconds for one forced-kernel SpGEMM over the probe pair,
    through ``spgemm_tiles(…, kernel=kernel_id)``."""
    from matrel_tpu_torch.ops import spgemm as spgemm_lib
    cfg = config or default_config()

    def go():
        tiles, _, _ = spgemm_lib.spgemm_tiles(A, B, cfg, kernel=kernel_id)
        float(tiles.sum(dtype=torch.float32))

    return _median_seconds(go, n_times)


def lookup_or_measure_spgemm(side: int, structure: str, bs: int, mesh,
                             config: Optional[MatrelConfig] = None
                             ) -> Optional[str]:
    """The registry's entry point (``config.autotune``): the measured
    kernel id for this (side class, structure class, block size, grid,
    backend), or None when the registry's rules decide. Sides above
    ``autotune_max_dim`` are never measured inline; ties and one-kernel
    results resolve to None and a one-kernel result is not persisted."""
    from matrel_tpu_torch.ops import kernel_registry as kr
    cfg = config or default_config()
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    key = _spgemm_key(side, structure, bs, gx, gy, backend_of(mesh),
                      mesh_lib.axis_weights(mesh, cfg))
    found, best = _cached_entry(_SPGEMM_CACHE, key, cfg, mesh)
    if found:
        _SPGEMM_CACHE[key] = best
        return best
    if side > cfg.autotune_max_dim:
        _SPGEMM_CACHE[key] = None
        return None
    A = kr.synthesize_structure(structure, int(side), bs, mesh,
                                seed=SPGEMM_PROBE_SEEDS[0])
    B = kr.synthesize_structure(structure, int(side), bs, mesh,
                                seed=SPGEMM_PROBE_SEEDS[1])
    results = _measured(
        "spgemm", spgemm_candidates(structure, bs, cfg),
        lambda kid: measure_spgemm_kernel(kid, A, B, cfg), mesh)
    if len(results) < 2:
        _SPGEMM_CACHE[key] = None
        return None
    best = _pick_winner(results)
    _SPGEMM_CACHE[key] = best
    if cfg.autotune or cfg.autotune_table_path:
        _persist(_table_path(cfg), key, best, results)
    return best


# -- fused regions: the fuse| family ------------------------------------------

_FUSION_CACHE: Dict[str, Optional[str]] = {}

FUSION_VARIANTS = ("fused", "staged")


def _fusion_key(sig: str, side: int, gx: int, gy: int, backend: str,
                weights: Tuple[float, float] = (1.0, 1.0)) -> str:
    """``fuse|<sig>|<=side|grid|backend[|w..]`` — the region signature
    is '|'-free by construction (``fusion.region_sig``); the side is
    bucketed to a power of two like every other row."""
    cls = 1 << max(0, math.ceil(math.log2(max(int(side), 1))))
    return (f"fuse|{sig}|<={cls}|{gx}x{gy}|{backend}"
            + _weights_suffix(weights))


def _median_device_seconds(go, device, n_times: int) -> float:
    """One warm run, then the median of ``n_times`` runs: CUDA events
    around each on the card, the host clock on the CPU (where a run
    ends when its ops do)."""
    if device.type != "cuda":
        return _median_seconds(go, n_times)
    go()
    torch.cuda.synchronize(device)
    ts = []
    for _ in range(max(n_times, 1)):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        go()
        end.record()
        end.synchronize()
        ts.append(start.elapsed_time(end) / 1e3)
    ts.sort()
    return ts[len(ts) // 2]


def measure_fusion_region(region, root_tree, mesh,
                          config: Optional[MatrelConfig] = None,
                          n_times: int = 5) -> Dict[str, float]:
    """{'fused': s, 'staged': s} medians for ONE region, both built by
    the executor's unit-program seam over synthetic padded probes
    (``executor.region_probe_programs``). Empty when the region is not
    probeable (sparse-payload inputs); a variant that fails drops
    out."""
    from matrel_tpu_torch import executor as executor_lib
    cfg = config or default_config()
    node = _find_region_root(root_tree, region.root_uid)
    if node is None:
        return {}
    probe = executor_lib.region_probe_programs(
        node, region.member_uids, mesh, cfg)
    if probe is None:
        return {}
    fused, staged, input_uids, arrays, root_uid = probe

    def run_fused():
        return fused(*(arrays[u] for u in input_uids))

    def run_staged():
        env = dict(arrays)
        for n, fn, ins in staged:
            env[n.uid] = fn(*(env[u] for u in ins))
        return env[root_uid]

    runs = {"fused": run_fused, "staged": run_staged}
    return _measured("fusion", FUSION_VARIANTS,
                     lambda v: _median_device_seconds(runs[v], mesh.device,
                                                      n_times), mesh)


def _find_region_root(root_tree, uid: int):
    from matrel_tpu_torch.ir import fusion as fusion_lib
    return fusion_lib._find_uid(root_tree, uid)


def _member_dims(root_tree, uid: int):
    n = _find_region_root(root_tree, uid)
    return tuple(n.shape) if n is not None else ()


def lookup_or_measure_fusion(region, root_tree, mesh,
                             config: Optional[MatrelConfig] = None
                             ) -> Optional[str]:
    """The fusion pass's boundary consult (``config.autotune``):
    "fused" / "staged" / None (no measured preference — the region
    stamps). In-process cache, then the persisted table, then one
    measurement (only for sides ≤ ``autotune_max_dim``); ties and
    one-variant results resolve to None."""
    cfg = config or default_config()
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    node = _find_region_root(root_tree, region.root_uid)
    side = max([1] + [d for u in (region.member_uids + (region.root_uid,))
                      for d in _member_dims(root_tree, u)])
    key = _fusion_key(region.sig, side, gx, gy, backend_of(mesh),
                      mesh_lib.axis_weights(mesh, cfg))
    found, best = _cached_entry(_FUSION_CACHE, key, cfg, mesh)
    if found:
        _FUSION_CACHE[key] = best
        return best
    if node is None or side > cfg.autotune_max_dim:
        _FUSION_CACHE[key] = None
        return None
    results = measure_fusion_region(region, root_tree, mesh, cfg)
    if len(results) < 2:
        _FUSION_CACHE[key] = None
        return None
    best = _pick_winner(results)
    _FUSION_CACHE[key] = best
    if cfg.autotune or cfg.autotune_table_path:
        _persist(_table_path(cfg), key, best, results)
    return best


# -- staged reshards: the reshard| family -------------------------------------

_RESHARD_CACHE: Dict[str, Optional[str]] = {}

RESHARD_VARIANTS = ("staged", "naive")


def _reshard_key(plan, gx: int, gy: int, backend: str,
                 weights: Tuple[float, float] = (1.0, 1.0)) -> str:
    """``reshard|src>dst|side|gxXgy|backend[|w..]`` — side bucketed to
    the power of two above sqrt(nbytes/4), so a 3800² and a 4096² move
    share a row."""
    side = math.sqrt(max(plan.nbytes / 4.0, 1.0))
    cls = 1 << max(0, math.ceil(math.log2(max(side, 1.0))))
    return (f"reshard|{plan.src}>{plan.dst}|{cls}|{gx}x{gy}|{backend}"
            + _weights_suffix(weights))


def measure_reshard_variant(variant: str, plan, mesh,
                            config: Optional[MatrelConfig] = None,
                            n_times: int = 5) -> float:
    """Median seconds of one lowering of the plan's move on a rank mesh:
    the compiled step sequence ("staged", ``reshard.apply_staged``)
    against one direct move to the destination ("naive",
    ``collectives.relay``), over a matrix of the plan's size laid out as
    its source, the ranks in step (a barrier ends every run). On one card
    both would be the same local copy, so there it raises
    :class:`NotPortedError` and :func:`lookup_or_measure_reshard` drops
    both candidates (the model decides)."""
    if not getattr(mesh, "ranked", False):
        raise NotPortedError(
            f"measuring the {variant!r} lowering of a {plan.src}->"
            f"{plan.dst} reshard needs a rank mesh; on one card every "
            f"step is a local copy")
    from matrel_tpu_torch.parallel import collectives as coll
    from matrel_tpu_torch.parallel import reshard as reshard_lib
    side = int(round(math.sqrt(plan.nbytes / 4.0)))
    pshape = padding.padded_shape((side, side), mesh)
    full = torch.ones(pshape, dtype=torch.float32, device=mesh.device)
    x = coll.shard_from_full(full, plan.src, mesh)
    del full

    def go():
        if variant == "staged":
            y = reshard_lib.apply_staged(x, plan, mesh)
        else:
            y = coll.relay(x, plan.dst, mesh)
        float(y.local[:1, :1].sum())
        coll.barrier(mesh)

    return _median_seconds(go, n_times)


def lookup_or_measure_reshard(plan, mesh,
                              config: Optional[MatrelConfig] = None
                              ) -> Optional[str]:
    """Measured lowering for this reshard's shape class ("staged" /
    "naive"), or None when the model's pick stands: single-step plans
    (staged is naive), sides above ``autotune_max_dim``, ties, or
    candidates that could not be measured. A persisted row is
    honoured."""
    cfg = config or default_config()
    if len(plan.steps) < 2:
        return None
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    key = _reshard_key(plan, gx, gy, backend_of(mesh),
                       mesh_lib.axis_weights(mesh, cfg))
    found, best = _cached_entry(_RESHARD_CACHE, key, cfg, mesh)
    if found:
        _RESHARD_CACHE[key] = best
        return best
    if math.sqrt(max(plan.nbytes / 4.0, 1.0)) > cfg.autotune_max_dim:
        _RESHARD_CACHE[key] = None
        return None
    results = _measured(
        "reshard", RESHARD_VARIANTS,
        lambda v: measure_reshard_variant(v, plan, mesh, cfg), mesh)
    if len(results) < 2:
        _RESHARD_CACHE[key] = None
        return None
    best = _pick_winner(results)
    _RESHARD_CACHE[key] = best
    if cfg.autotune or cfg.autotune_table_path:
        _persist(_table_path(cfg), key, best, results)
    return best


# -- IVM patch-vs-recompute: the ivm| family ----------------------------------

_IVM_CACHE: Dict[str, Optional[str]] = {}

IVM_VARIANTS = ("patch", "recompute")


def _ivm_key(rule: str, side: int, gx: int, gy: int, backend: str,
             weights: Tuple[float, float] = (1.0, 1.0)) -> str:
    """``ivm|<rule>|<side class>|gxXgy|backend[|w..]`` — the side
    bucketed to the power of two at or above it (no ``<=``: the JAX
    package's ivm row), the rule from :data:`DELTA_RULES`."""
    cls = 1 << max(0, math.ceil(math.log2(max(side, 1))))
    return (f"ivm|{rule}|{cls}|{gx}x{gy}|{backend}"
            + _weights_suffix(weights))


def lookup_or_measure_ivm(rule: str, side: int, mesh,
                          config: Optional[MatrelConfig] = None,
                          patch_s=None, full_s=None) -> Optional[str]:
    """The delta plane's patch-vs-recompute consult
    (``serve/ivm.py``): "patch" / "recompute" / None (no measured
    preference — the FLOP estimate decides). In-process cache, then the
    persisted table (rank 0's answer on a rank mesh); ``patch_s`` /
    ``full_s`` are zero-arg callables returning median seconds of the
    two forms, called at most once each — without them nothing is
    measured and no negative answer is cached. Ties and one-variant
    results resolve to None."""
    cfg = config or default_config()
    gx, gy = mesh_lib.mesh_grid_shape(mesh)
    key = _ivm_key(rule, side, gx, gy, backend_of(mesh),
                   mesh_lib.axis_weights(mesh, cfg))
    found, best = _cached_entry(_IVM_CACHE, key, cfg, mesh)
    if found:
        _IVM_CACHE[key] = best
        return best
    if patch_s is None or full_s is None or side > cfg.autotune_max_dim:
        return None
    runs = {"patch": patch_s, "recompute": full_s}
    results = _measured("ivm", IVM_VARIANTS, lambda v: float(runs[v]()),
                        mesh)
    if len(results) < 2:
        _IVM_CACHE[key] = None
        return None
    best = _pick_winner(results)
    _IVM_CACHE[key] = best
    if cfg.autotune or cfg.autotune_table_path:
        _persist(_table_path(cfg), key, best, results)
    return best


def clear_caches() -> None:
    """Forget every in-process measurement and table read (a fresh
    process, as far as this module knows); the table file stays."""
    for cache in (_CACHE, _SPMV_CACHE, _SPGEMM_CACHE, _FUSION_CACHE,
                  _RESHARD_CACHE, _IVM_CACHE, _TABLE_CACHE):
        cache.clear()
