"""Dispatchable sparse-kernel registry — the counterpart of
``matrel_tpu/ops/kernel_registry.py``, the one seam for SpGEMM kernels.

Each registered kernel computes the same tile-stack product of an S×S
multiply; they differ only in schedule, and each declares the sparsity
STRUCTURE classes (``ir/stats`` classifiers over the block edge lists)
it is the home kernel of:

  xla_gather       gather + batched f32 tile GEMM + ``index_add_`` (a
                   torch composite; admissible everywhere)
  pallas_generic   B4: the slot-sorted pair list, one pair at a time
  pallas_band      row_band home: B6, the per-row strip product over
                   the diagonal band; rows too wide for the budget fall
                   back to the grouped schedule (B5)
  pallas_cluster   clustered_tile home: B5, G pairs of one slot a step
  pallas_powerlaw  powerlaw_coo home: output slots bucketed by pair-run
                   length, B5 once per bucket (B7)

Selection order (``select_kernel``): config override > measured winner
(``config.autotune``: ``parallel/autotune.lookup_or_measure_spgemm``
over this side class, structure class and block size on the device) >
registry cost model (a specialized kernel only on its home structure
class) > legacy default. ``VMEM_PAIR_BUDGET_BYTES`` and every
feasibility rule are the JAX package's, byte for byte, so the same
inputs get the same stamp and the same schedule in both packages; the
budgets were sized for the TPU's VMEM, and re-deriving them for
Hopper's shared memory waits for a measured gain. The builders keep the JAX package's host tables but not its
pre-gathered payload copies: the kernels (``ops/pallas_spgemm.py``)
read the payload stacks through the tables. The fused-epilogue hooks
(``EPILOGUE_MODES``, ``register_epilogue_hook``) say where a fused
region's epilogue runs over a kernel's output: tile-wise over the
``[n_out, bs, bs]`` stack before the scatter, or over the dense output
after it.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import (MatrelConfig, default_config,
                                     pallas_enabled)
from matrel_tpu_torch.ir import stats
from matrel_tpu_torch.ops import pallas_spgemm as ps
from matrel_tpu_torch.ops.spgemm import pallas_eligible

# -- registry ---------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class KernelSpec:
    """One registered SpGEMM kernel (fields as in the JAX package):
    ``structures`` are its home classes, ``universal`` marks the legacy
    entries admissible on every class, ``group`` is the pair-group
    factor G (0 = the composite, 1 = one pair per step) and
    ``bucket_split`` the run length at which a powerlaw slot moves from
    the light bucket to the heavy one."""

    kernel_id: str
    structures: Tuple[str, ...]
    needs_pallas: bool
    group: int
    description: str
    universal: bool = False
    bucket_split: int = 0


REGISTRY: Dict[str, KernelSpec] = {}

#: How many kernel selections ran: zero when
#: ``spgemm_density_threshold = 0`` (nothing dispatches, so nothing may
#: consult the registry).
_LOOKUPS = {"count": 0}

#: The JAX package's per-pair VMEM budget; it bounds G and the band
#: chunk, so it is kept as is for identical schedules.
VMEM_PAIR_BUDGET_BYTES = 8 * 1024 * 1024


def register_kernel(spec: KernelSpec) -> None:
    REGISTRY[spec.kernel_id] = spec


def kernel_ids() -> Tuple[str, ...]:
    return tuple(REGISTRY)


def get_kernel(kernel_id: str) -> KernelSpec:
    return REGISTRY[kernel_id]


def grouped_factor(bs: int, requested: int) -> int:
    """Effective pair-group G at this block size: the request clamped so
    a double-buffered (bs, G·bs) + (G·bs, bs) f32 pair fits the budget."""
    cap = int(VMEM_PAIR_BUDGET_BYTES // max(2 * bs * bs * 4, 1))
    return max(1, min(requested, cap))


def admissible(kernel_id: str, bs: int, npairs: int,
               config: Optional[MatrelConfig] = None) -> bool:
    """Can this kernel run a (bs, npairs) SpGEMM under this config? The
    kernel entries need the kernel gate and the 8-sublane block rule;
    grouped entries also a G >= 2 within the budget. Whether a kernel
    built or launched is never consulted."""
    spec = REGISTRY.get(kernel_id)
    if spec is None:
        return False
    cfg = config or default_config()
    if spec.needs_pallas:
        if not pallas_enabled(cfg):
            return False
        if not pallas_eligible(bs, npairs):
            return False
        if spec.group > 1 and grouped_factor(bs, spec.group) < 2:
            return False
    return True


def legacy_default(bs: int, npairs: int,
                   config: Optional[MatrelConfig] = None) -> str:
    """The pre-registry two-way choice: the pair kernel where eligible,
    the composite otherwise."""
    cfg = config or default_config()
    if pallas_enabled(cfg) and pallas_eligible(bs, npairs):
        return "pallas_generic"
    return "xla_gather"


def select_kernel(structure: str, bs: int, npairs: int,
                  config: Optional[MatrelConfig] = None, side: int = 0,
                  mesh=None) -> Tuple[str, str]:
    """(kernel_id, source) for one SpGEMM: "override" (config forcing
    knob), "measured" (with ``config.autotune``, a ``mesh`` and a
    ``side``: the autotune table's admissible winner for this class),
    "model" (a specialized kernel on its home structure class) or
    "default" (the legacy two-way choice)."""
    cfg = config or default_config()
    _LOOKUPS["count"] += 1
    ov = cfg.spgemm_kernel_override
    if ov:
        if ov not in REGISTRY:
            raise ValueError(
                f"spgemm_kernel_override {ov!r} is not a registered "
                f"kernel (have {kernel_ids()})")
        if admissible(ov, bs, npairs, cfg):
            return ov, "override"
        return legacy_default(bs, npairs, cfg), "default"
    if cfg.autotune and mesh is not None and side:
        from matrel_tpu_torch.parallel import autotune
        best = autotune.lookup_or_measure_spgemm(side, structure, bs, mesh,
                                                 cfg)
        if best is not None and admissible(best, bs, npairs, cfg):
            return best, "measured"
    for kid, spec in REGISTRY.items():
        if (not spec.universal and structure in spec.structures
                and admissible(kid, bs, npairs, cfg)):
            return kid, "model"
    return legacy_default(bs, npairs, cfg), "default"


# -- fused epilogue hooks (whole-plan fusion, ir/fusion.py) -----------------
# When a fused region absorbs a consumer chain into its producer SpGEMM,
# the chain reaches the kernel's output here, per structure class,
# without forking a kernel body. Each hook names how the epilogue is
# applied:
#
#   "tilewise"  over the [n_out, bs, bs] OUTPUT TILE STACK before the
#               dense scatter — nnzb·bs² elements instead of n·m. Only
#               legal for zero-preserving, shape-polymorphic chains
#               (scalar mul / pow>0 — the executor's
#               epilogue_elementwise flag proves it); the untouched
#               tiles stay exact zeros.
#   "dense"     over the scattered padded dense output (always legal;
#               the conservative default).

EPILOGUE_MODES = ("tilewise", "dense")

_EPILOGUE_HOOKS: Dict[str, str] = {}


def register_epilogue_hook(structure: str, mode: str) -> None:
    if mode not in EPILOGUE_MODES:
        raise ValueError(
            f"epilogue mode must be one of {EPILOGUE_MODES}, "
            f"got {mode!r}")
    _EPILOGUE_HOOKS[structure] = mode


def epilogue_mode(structure: str, elementwise_ok: bool) -> str:
    """The application mode of one fused SpGEMM epilogue: the structure
    class's registered hook, demoted to "dense" whenever the chain is
    not provably zero-preserving and shape-polymorphic."""
    if not elementwise_ok:
        return "dense"
    return _EPILOGUE_HOOKS.get(structure, "dense")


def apply_tile_epilogue(tiles, epilogue):
    """Run a zero-preserving pointwise epilogue over the output tile
    stack (the "tilewise" hook body — one place, every kernel)."""
    return epilogue(tiles)


# -- structure classification (memoised per operand) ------------------------


def structure_of_matrix(S) -> str:
    """Structure class of one BlockSparseMatrix, memoised on the matrix."""
    memo = getattr(S, "_structure_memo", None)
    if memo is not None:
        return memo
    gr, gc = S.grid
    rows, cols = S.host_tiles()
    cls = stats.classify_block_structure(rows, cols, gr, gc)
    S._structure_memo = cls
    return cls


def structure_of_child(child, bs: int) -> str:
    """Structure class of an S×S matmul operand node (sparse_leaf or
    coo_leaf). COO leaves are classified at the dispatch block size from
    their bucketed tile keys, memoised per block size."""
    m = child.attrs["matrix"]
    if child.kind == "sparse_leaf":
        return structure_of_matrix(m)
    memo = getattr(m, "_structure_memo", None)
    if memo is not None and memo[0] == bs:
        return memo[1]
    gr = math.ceil(m.shape[0] / bs)
    gc = math.ceil(m.shape[1] / bs)
    keys = np.unique((np.asarray(m.rows, np.int64) // bs) * gc
                     + np.asarray(m.cols, np.int64) // bs)
    cls = stats.classify_block_structure(keys // gc, keys % gc, gr, gc)
    m._structure_memo = (bs, cls)
    return cls


def pair_class_of(A, B) -> str:
    """Structure class of a BlockSparseMatrix operand pair."""
    return stats.pair_structure_class(structure_of_matrix(A),
                                      structure_of_matrix(B))


# -- runners ----------------------------------------------------------------


@dataclasses.dataclass
class Runner:
    """The device runner of one kernel over one operand pair:
    ``run(a_blocks, b_blocks)`` → the [n_out, bs, bs] tile stack from
    the edge-masked payload stacks. ``schedule`` names what runs
    ("xla_gather", "pairs", "grouped", "band" or "bucketed") and
    ``tables`` holds the host tables it reads (numpy)."""

    kernel_id: str
    schedule: str
    tables: dict
    fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

    def __call__(self, a_blocks: torch.Tensor,
                 b_blocks: torch.Tensor) -> torch.Tensor:
        return self.fn(a_blocks, b_blocks)


def _dev_i32(x, dev) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(x, np.int32), device=dev)


def _cast(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t if t.dtype == dtype else t.to(dtype)


def _build_xla_gather(kid, pairs, n_out, out_dtype, cfg, dev) -> Runner:
    """The composite: ``index_select`` both stacks by the pair lists,
    one batched f32 tile GEMM (TF32 off; ``matmul_precision`` below
    "highest" runs its bf16 passes) and ``index_add_`` into an f32
    stack, cast to the output dtype."""
    from matrel_tpu_torch.ops.precision import tiered_matmul
    from matrel_tpu_torch.parallel.strategies import _PRECISION_TIER
    slot, pa, pb = (torch.as_tensor(np.asarray(x, np.int64), device=dev)
                    for x in pairs)

    def run(a_blocks, b_blocks):
        common = torch.promote_types(a_blocks.dtype, b_blocks.dtype)
        a, b = _cast(a_blocks, common), _cast(b_blocks, common)
        tier = _PRECISION_TIER.get(cfg.matmul_precision)
        mm = ps.f32_bmm
        if tier is not None and common == torch.float32:
            mm = lambda p, q: tiered_matmul(tier, p, q, ps.f32_bmm)
        bs = a.shape[1]
        acc = torch.zeros((n_out, bs, bs), dtype=torch.float32, device=dev)
        ps.accumulate_pairs(acc, a, b, pa, pb, slot, mm)
        return acc.to(out_dtype)

    return Runner(kid, "xla_gather",
                  {"slot": pairs[0], "pa": pairs[1], "pb": pairs[2]}, run)


def _build_pallas_generic(kid, pairs, n_out, out_dtype, dev) -> Runner:
    """B4 over the pair CSR: ``slot_ptr`` [n_out + 1] over the
    slot-sorted pair list, built once here and cached with the runner."""
    slot, pa, pb = (np.asarray(x, np.int64) for x in pairs)
    slot_ptr = np.zeros(n_out + 1, np.int64)
    np.cumsum(np.bincount(slot, minlength=n_out), out=slot_ptr[1:])
    t_ptr, t_pa, t_pb = (_dev_i32(x, dev) for x in (slot_ptr, pa, pb))

    def run(a_blocks, b_blocks):
        return ps.spgemm_pairs(_cast(a_blocks, out_dtype),
                               _cast(b_blocks, out_dtype), t_ptr, t_pa, t_pb)

    return Runner(kid, "pairs", {"slot_ptr": slot_ptr, "pa": pa, "pb": pb},
                  run)


def _grouped_tables(slot: np.ndarray, n_out: int, G: int,
                    npairs: int) -> Tuple[np.ndarray, np.ndarray]:
    """(src, group_slot) for the grouped schedule: each output slot's
    pair run padded to a multiple of G with sentinel positions (index
    ``npairs``), so every group holds exactly G positions of its one
    slot. ``src[j]`` is the pair at position j of the padded layout;
    ``group_slot[g]`` the output slot of group g. Pairs arrive
    slot-sorted (pair_structure's contract)."""
    counts = np.bincount(slot, minlength=n_out).astype(np.int64)
    gcounts = np.maximum(-(-counts // G), 1)
    offsets = np.zeros(n_out + 1, np.int64)
    np.cumsum(gcounts * G, out=offsets[1:])
    src = np.full(int(offsets[-1]), npairs, np.int64)
    starts = np.zeros(n_out + 1, np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = offsets[slot] + (np.arange(slot.size, dtype=np.int64)
                           - starts[slot])
    src[pos] = np.arange(slot.size, dtype=np.int64)
    group_slot = np.repeat(np.arange(n_out, dtype=np.int32),
                           gcounts.astype(np.int64))
    return src, group_slot


def _adaptive_group(counts: np.ndarray, requested: int, bs: int) -> int:
    """Effective G for one grouped schedule: the median slot-run length,
    clamped by the request and the budget; floor 2."""
    if counts.size == 0:
        return 2
    med = int(np.median(counts[counts > 0])) if np.any(counts > 0) else 1
    return max(2, min(requested, grouped_factor(bs, requested),
                      max(med, 2)))


def _build_grouped(kid, bs, pairs, n_out, out_dtype, dev, G) -> Runner:
    """Band/cluster builder: ONE grouped schedule over all slots (B5)."""
    slot, pa, pb = (np.asarray(x, np.int64) for x in pairs)
    counts = np.bincount(slot, minlength=n_out)
    G = _adaptive_group(counts, G, bs)
    src, group_slot = _grouped_tables(slot, n_out, G, int(pa.size))
    t_src, t_gs, t_pa, t_pb = (_dev_i32(x, dev)
                               for x in (src, group_slot, pa, pb))

    def run(a_blocks, b_blocks):
        return ps.spgemm_grouped(_cast(a_blocks, out_dtype),
                                 _cast(b_blocks, out_dtype), t_src, t_gs,
                                 t_pa, t_pb, G, n_out)

    return Runner(kid, "grouped", {"group": G, "src": src,
                                   "group_slot": group_slot, "pa": pa,
                                   "pb": pb}, run)


def band_tables(A, B, bs: int, wmax: int, out_rows, out_cols):
    """The band schedule's host tables, exactly as the JAX package's
    ``_build_band`` builds them: a dict with ``wa``, ``nchunks``,
    ``rc``, ``a_idx`` [gr·wa], ``b_idx`` [gr·wa·nchunks·rc] (index nnzb
    is the zero tile) and ``sel`` (output slot → band position) — or
    None where the band does not fit the budget and the grouped
    schedule runs instead."""
    out_rows = np.asarray(out_rows, np.int64)
    out_cols = np.asarray(out_cols, np.int64)
    a_rows, a_cols = A.host_tiles()
    b_rows, b_cols = B.host_tiles()
    gr = A.grid[0]
    gcb = B.grid[1]

    def _span(idx, vals, size):
        lo = np.full(size, np.iinfo(np.int64).max)
        hi = np.full(size, -1)
        np.minimum.at(lo, idx, vals)
        np.maximum.at(hi, idx, vals)
        return lo, hi

    kmin, kmax = _span(a_rows, a_cols, gr)
    cmin, cmax = _span(out_rows, out_cols, gr)
    live = kmax >= 0
    wa = int(max((kmax - kmin + 1)[live].max(initial=1), 1))
    rr = int(max((cmax - cmin + 1)[live &
                                   (cmax >= 0)].max(initial=1), 1))
    # the JAX package's feasibility rule: A strip + one B chunk + the out
    # chunk within the budget, else chunk the output band, else fall back
    budget = VMEM_PAIR_BUDGET_BYTES // 4
    rc = int(min(rr, max(budget // max(wa * bs * bs, 1) - 1, 0)))
    if rc < 1 or wa > grouped_factor(bs, max(wmax, 2)) * 2:
        return None
    nchunks = -(-rr // rc)

    def _lookup(rows, cols, gc_):
        keys = rows * gc_ + cols
        order = np.argsort(keys)
        return keys[order], order

    akeys, aorder = _lookup(a_rows, a_cols, A.grid[1])
    bkeys, border = _lookup(b_rows, b_cols, gcb)

    def _find(keys_sorted, order, want, nnzb):
        pos = np.searchsorted(keys_sorted, want)
        pos = np.clip(pos, 0, keys_sorted.size - 1)
        hit = keys_sorted[pos] == want
        return np.where(hit, order[pos], nnzb).astype(np.int64)

    rows_i = np.arange(gr)
    k_of = np.clip(kmin, 0, None)[:, None] + np.arange(wa)[None, :]
    k_valid = k_of <= np.where(live, kmax, -1)[:, None]
    a_want = rows_i[:, None] * A.grid[1] + np.clip(k_of, 0,
                                                   A.grid[1] - 1)
    a_idx = _find(akeys, aorder, a_want.ravel(), A.nnzb)
    a_idx = np.where(k_valid.ravel(), a_idx, A.nnzb)

    c_of = np.clip(cmin, 0, None)[:, None] \
        + np.arange(nchunks * rc)[None, :]
    c_valid = c_of <= np.where(cmax >= 0, cmax, -1)[:, None]
    b_want = (np.repeat(k_of[:, :, None], nchunks * rc, axis=2) * gcb
              + np.clip(c_of, 0, gcb - 1)[:, None, :])
    b_ok = k_valid[:, :, None] & c_valid[:, None, :]
    b_idx = _find(bkeys, border, b_want.ravel(), B.nnzb)
    b_idx = np.where(b_ok.ravel(), b_idx, B.nnzb)
    sel = (out_rows * nchunks * rc
           + (out_cols - np.clip(cmin, 0, None)[out_rows]))
    return {"wa": wa, "nchunks": nchunks, "rc": rc, "a_idx": a_idx,
            "b_idx": b_idx, "sel": sel}


def _build_band(kid, A, B, bs, pairs, n_out, out_dtype, dev, wmax,
                out_rows, out_cols) -> Runner:
    """Band builder (B6): per output slot the strip product of its A
    block row's band tiles with its band column, in slot order. Bands
    wider than the budget fall back to the grouped schedule (B5)."""
    tab = band_tables(A, B, bs, wmax, out_rows, out_cols)
    if tab is None:
        return _build_grouped(kid, bs, pairs, n_out, out_dtype, dev, wmax)
    wa, width = tab["wa"], tab["nchunks"] * tab["rc"]
    t_a, t_b, t_sel = (_dev_i32(tab[k], dev) for k in ("a_idx", "b_idx",
                                                        "sel"))

    def run(a_blocks, b_blocks):
        return ps.spgemm_band(_cast(a_blocks, out_dtype),
                              _cast(b_blocks, out_dtype), t_a, t_b, t_sel,
                              wa, width)

    return Runner(kid, "band", tab, run)


def _build_bucketed(kid, bs, pairs, n_out, out_dtype, dev, g_light,
                    g_heavy, split) -> Runner:
    """Powerlaw builder (B7): output slots bucketed by pair-run length —
    light slots (run <= split) pad only to g_light, hub slots run the
    wide g_heavy group — one B5 launch per non-empty bucket, each
    writing its slots of the one output stack."""
    slot, pa, pb = (np.asarray(x, np.int64) for x in pairs)
    counts = np.bincount(slot, minlength=n_out)
    heavy_slots = np.nonzero(counts > split)[0]
    light_slots = np.nonzero(counts <= split)[0]
    host, buckets = [], []
    for slots_sel, G in ((light_slots, g_light), (heavy_slots, g_heavy)):
        if slots_sel.size == 0:
            continue
        G = _adaptive_group(counts[slots_sel], G, bs)
        # this bucket's pairs on local slot ids (slot order is kept, so
        # the grouped tables stay run-coherent)
        local_of = np.full(n_out, -1, np.int64)
        local_of[slots_sel] = np.arange(slots_sel.size)
        mask = local_of[slot] >= 0
        bslot = local_of[slot[mask]]
        bpa, bpb = pa[mask], pb[mask]
        src, group_slot = _grouped_tables(bslot, int(slots_sel.size), G,
                                          int(bpa.size))
        host.append({"group": G, "src": src, "group_slot": group_slot,
                     "pa": bpa, "pb": bpb, "ids": slots_sel})
        buckets.append({"group": G, **{
            k: _dev_i32(host[-1][k], dev)
            for k in ("src", "group_slot", "pa", "pb", "ids")}})

    def run(a_blocks, b_blocks):
        return ps.spgemm_powerlaw(_cast(a_blocks, out_dtype),
                                  _cast(b_blocks, out_dtype), buckets, n_out)

    return Runner(kid, "bucketed", {"buckets": host}, run)


def build_runner(kernel_id: str, A, B, cfg: MatrelConfig, pairs,
                 n_out: int, out_dtype: torch.dtype) -> Runner:
    """The runner of one registered kernel over one operand pair — the
    single constructor ops/spgemm.py's runner cache calls. ``pairs`` is
    the host (slot, pa, pb, out_rows, out_cols) structure from
    pair_structure (slot-sorted). Tables go to A's device once, here."""
    spec = REGISTRY[kernel_id]
    bs = A.block_size
    dev = A.blocks.device
    slot, pa, pb, out_rows, out_cols = pairs
    pairs3 = (slot, pa, pb)
    if kernel_id == "xla_gather":
        return _build_xla_gather(kernel_id, pairs3, n_out, out_dtype, cfg,
                                 dev)
    if kernel_id == "pallas_generic":
        return _build_pallas_generic(kernel_id, pairs3, n_out, out_dtype,
                                     dev)
    G = grouped_factor(bs, spec.group)
    if spec.bucket_split > 0:
        return _build_bucketed(kernel_id, bs, pairs3, n_out, out_dtype, dev,
                               g_light=max(2, grouped_factor(bs, 2)),
                               g_heavy=G, split=spec.bucket_split)
    if kernel_id == "pallas_band":
        return _build_band(kernel_id, A, B, bs, pairs3, n_out, out_dtype,
                           dev, spec.group, out_rows, out_cols)
    return _build_grouped(kernel_id, bs, pairs3, n_out, out_dtype, dev, G)


# -- structure-shaped operand synthesis -------------------------------------

#: Minimum tiles a synthetic hub row carries.
POWERLAW_PROBE_HUB_MIN = 12


def synthesize_structure(structure: str, n: int, bs: int, mesh,
                         seed: int = 0, dtype="float32"):
    """A BlockSparseMatrix whose tile layout exhibits one structure
    class — the JAX package's generator: the same numpy draws give the
    same tiles and the same standard-normal payload (made on the host,
    in f32, then cast) for a seed."""
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix

    gr = gc = max(2, math.ceil(n / bs))
    rng = np.random.default_rng(seed)
    if structure == "row_band":
        bw = 5                     # tile offsets -2..2 (stencil-ish)
        r = np.repeat(np.arange(gr), bw)
        c = r + np.tile(np.arange(bw) - bw // 2, gr)
        keep = (c >= 0) & (c < gc)
        rows, cols = r[keep], c[keep]
    elif structure == "clustered_tile":
        ncl = max(2, gr // 8)
        cb = 4
        rows_l, cols_l = [], []
        for _ in range(ncl):
            cr = int(rng.integers(0, max(gr - cb, 1)))
            cc = int(rng.integers(0, max(gc - cb, 1)))
            ii, jj = np.meshgrid(np.arange(cb), np.arange(cb),
                                 indexing="ij")
            rows_l.append(cr + ii.ravel())
            cols_l.append(cc + jj.ravel())
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
    elif structure == "powerlaw_coo":
        hubs = max(2, gr // 16)
        hub_rows = rng.choice(gr, size=hubs, replace=False)
        rows_l = [np.repeat(hub_rows,
                            max(gc // 2, POWERLAW_PROBE_HUB_MIN))]
        cols_l = [rng.integers(0, gc, rows_l[0].size)]
        rows_l.append(np.arange(gr))
        cols_l.append(rng.integers(0, gc, gr))
        rows = np.concatenate(rows_l)
        cols = np.concatenate(cols_l)
    else:
        nnzb = max(4, 2 * gr)
        flat = rng.choice(gr * gc, size=min(nnzb, gr * gc),
                          replace=False)
        rows, cols = flat // gc, flat % gc
    keys = np.unique(rows.astype(np.int64) * gc
                     + cols.astype(np.int64))
    trows = keys // gc
    tcols = keys % gc
    payload = rng.standard_normal((keys.size, bs, bs)).astype(np.float32)
    return BlockSparseMatrix._from_host_tiles(
        payload, trows, tcols, (gr * bs, gc * bs), bs, mesh, dtype)


# -- vocabulary -------------------------------------------------------------

register_kernel(KernelSpec(
    kernel_id="xla_gather", structures=(), needs_pallas=False, group=0,
    universal=True,
    description="gather + batched f32 tile GEMM + index_add_ (torch "
                "composite; admissible everywhere)"))
register_kernel(KernelSpec(
    kernel_id="pallas_generic", structures=(), needs_pallas=True,
    group=1, universal=True,
    description="B4: one pair at a time over the slot-sorted pair list"))
register_kernel(KernelSpec(
    kernel_id="pallas_band", structures=("row_band",),
    needs_pallas=True, group=8,
    description="B6: per-row strip product over the diagonal band "
                "(grouped B5 where the band is too wide)"))
register_kernel(KernelSpec(
    kernel_id="pallas_cluster", structures=("clustered_tile",),
    needs_pallas=True, group=16,
    description="B5: G pairs of one slot a step over the cluster's long "
                "slot runs"))
register_kernel(KernelSpec(
    kernel_id="pallas_powerlaw", structures=("powerlaw_coo",),
    needs_pallas=True, group=8, bucket_split=4,
    description="B7: output slots bucketed by pair count, B5 per bucket"))

# fused-epilogue hooks per structure class: the home classes of the
# specialized kernels (B5-B7) apply zero-preserving epilogues tile-wise;
# "generic" (B4) keeps the dense post-scatter application
register_epilogue_hook("row_band", "tilewise")
register_epilogue_hook("clustered_tile", "tilewise")
register_epilogue_hook("powerlaw_coo", "tilewise")
register_epilogue_hook("generic", "dense")
