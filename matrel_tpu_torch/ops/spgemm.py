"""Block-sparse × block-sparse MatMul (SpGEMM) — the counterpart of
``matrel_tpu/ops/spgemm.py``: the product of two TILE MAPS, never of a
densified operand.

* Structure (host numpy, once per operand pair): pair (ia, ib) exists
  iff ``A.block_cols[ia] == B.block_rows[ib]``; the output tiles are the
  distinct (A row, B col) keys, and the pairs are sorted by output tile
  (slot). Read from the matrices' host tile memo
  (``BlockSparseMatrix.host_tiles``), never from the device per query.
* Compute (device): a registry kernel (``ops/kernel_registry.py``)
  turns the two payload stacks and the pair tables into the output tile
  stack — the hand-written kernels of ``ops/pallas_spgemm.py`` on the
  card, their plain versions on the CPU, or the ``xla_gather`` torch
  composite.

``apply_dense`` carries the fused-region ``epilogue`` slot
(``ir/fusion.py``). ``spgemm_sharded`` cuts the pair list over the ranks
of a rank mesh.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.core import padding
from matrel_tpu_torch.core.sparse import BlockSparseMatrix


# -- host structure ---------------------------------------------------------


def pair_structure(a_rows: np.ndarray, a_cols: np.ndarray,
                   b_rows: np.ndarray, b_cols: np.ndarray,
                   gc_out: int) -> Tuple[np.ndarray, np.ndarray,
                                         np.ndarray, np.ndarray,
                                         np.ndarray]:
    """Tile-intersection pair lists for C = A·B.

    Returns ``(pa, pb, slot, out_rows, out_cols)``: pair ``t``
    multiplies A tile ``pa[t]`` by B tile ``pb[t]`` into output tile
    ``slot[t]`` of the (out_rows, out_cols) tile set; pairs are sorted
    by slot (row-major output order). All int32, possibly empty.
    """
    a_rows = np.asarray(a_rows, np.int64)
    a_cols = np.asarray(a_cols, np.int64)
    b_rows = np.asarray(b_rows, np.int64)
    b_cols = np.asarray(b_cols, np.int64)
    # constructors keep stacks row-major sorted, but a hand-built B may
    # not be — sort (searchsorted needs sorted keys)
    if b_rows.size and np.any(np.diff(b_rows) < 0):
        border = np.argsort(b_rows, kind="stable")
    else:
        border = None
    brs = b_rows if border is None else b_rows[border]
    starts = np.searchsorted(brs, a_cols, side="left")
    ends = np.searchsorted(brs, a_cols, side="right")
    counts = ends - starts
    total = int(counts.sum())  # matlint: disable=ML001 host numpy counts of the pair plan, no device
    empty = (np.zeros(0, np.int32),) * 3 + (np.zeros(0, np.int32),) * 2
    if total == 0:
        return empty
    pa = np.repeat(np.arange(a_rows.size, dtype=np.int64), counts)
    cum = np.zeros(a_rows.size + 1, np.int64)
    np.cumsum(counts, out=cum[1:])
    pb = (np.arange(total, dtype=np.int64) - np.repeat(cum[:-1], counts)
          + np.repeat(starts, counts))
    if border is not None:
        pb = border[pb]
    key = a_rows[pa] * gc_out + b_cols[pb]
    uniq, slot = np.unique(key, return_inverse=True)
    order = np.argsort(slot, kind="stable")
    return (pa[order].astype(np.int32), pb[order].astype(np.int32),
            slot.ravel()[order].astype(np.int32),
            (uniq // gc_out).astype(np.int32),
            (uniq % gc_out).astype(np.int32))


def _out_dtype(A: BlockSparseMatrix, B: BlockSparseMatrix,
               cfg: MatrelConfig) -> torch.dtype:
    """The executor's dense-matmul dtype policy: f32 accumulate, cast
    back to the common input dtype under keep_input_dtype."""
    if cfg.keep_input_dtype and A.dtype == B.dtype:
        return A.dtype
    return torch.float32


def _check_shapes(A: BlockSparseMatrix, B: BlockSparseMatrix) -> None:
    if A.shape[1] != B.shape[0]:
        raise ValueError(f"spgemm shape mismatch: {A.shape} x {B.shape}")
    if A.block_size != B.block_size:
        raise ValueError(
            f"spgemm needs matching block sizes, got {A.block_size} "
            f"vs {B.block_size} — rebuild one operand on the other's "
            f"grid (BlockSparseMatrix.from_numpy/from_coo_arrays)")


# -- runner and structure caches: keyed on both operand ids, purged when
# EITHER matrix is collected so the device tables do not outlive it --------

_RUNNER_CACHE: dict = {}
_STRUCT_CACHE: dict = {}
_FINALIZER_IDS: set = set()


def _purge_runners(sid: int) -> None:
    _FINALIZER_IDS.discard(sid)
    for cache in (_RUNNER_CACHE, _STRUCT_CACHE):
        for k in [k for k in cache if sid in k[:2]]:
            del cache[k]


def _register_purge(S) -> None:
    if id(S) not in _FINALIZER_IDS:
        _FINALIZER_IDS.add(id(S))
        weakref.finalize(S, _purge_runners, id(S))


def _pair_structure_cached(A: BlockSparseMatrix, B: BlockSparseMatrix):
    """pair_structure of an (A, B) pair, cached on both identities: a
    repeated query re-runs only the device compute."""
    key = (id(A), id(B))
    hit = _STRUCT_CACHE.get(key)
    if hit is not None:
        return hit
    a_rows, a_cols = A.host_tiles()
    b_rows, b_cols = B.host_tiles()
    out = pair_structure(a_rows, a_cols, b_rows, b_cols, B.grid[1])
    _STRUCT_CACHE[key] = out
    _register_purge(A)
    _register_purge(B)
    return out


def pallas_eligible(bs: int, npairs: int) -> bool:
    """The JAX package's 8-sublane rule for its kernels, kept so both
    packages stamp the same kernel (the CUDA kernels take any bs)."""
    return bs % 8 == 0 and npairs > 0


def _tiles_runner(A, B, cfg, pairs, n_out, out_dtype, kernel=None):
    """The cached registry runner for one operand pair. ``kernel`` is the
    planner's stamp (an inadmissible stamp runs the legacy default);
    None lets the registry select from the pair's structure class."""
    from matrel_tpu_torch.ops import kernel_registry as kr
    npairs = int(np.asarray(pairs[1]).size)
    kid = kernel
    if kid is None:
        kid, _ = kr.select_kernel(kr.pair_class_of(A, B), A.block_size,
                                  npairs, cfg)
    elif not kr.admissible(kid, A.block_size, npairs, cfg):
        kid = kr.legacy_default(A.block_size, npairs, cfg)
    key = (id(A), id(B), npairs, n_out, str(out_dtype), kid,
           cfg.matmul_precision)
    run = _RUNNER_CACHE.get(key)
    if run is not None:
        return run
    run = kr.build_runner(kid, A, B, cfg, pairs, n_out, out_dtype)
    _RUNNER_CACHE[key] = run
    _register_purge(A)
    _register_purge(B)
    return run


def _edge_masked(S: BlockSparseMatrix) -> torch.Tensor:
    """Payload stack with the logical-edge overhang zeroed, memoised on
    the matrix (against its payload tensor).

    On ragged shapes the last block row/column overhangs the logical
    region and may carry nonzeros there (``BlockSparseMatrix.random``
    fills whole tiles). In S×S both operands carry it: contraction-edge
    overhang × overhang lands in kept output entries, and output-edge
    overhang would leak into the padded region the executor keeps zero.
    Masking both edges makes every product tile exactly the logical
    values."""
    bs = S.block_size
    rmod = S.shape[0] % bs
    cmod = S.shape[1] % bs
    if rmod == 0 and cmod == 0:
        return S.blocks
    memo = getattr(S, "_spgemm_edge_memo", None)
    if memo is not None and memo[0] is S.blocks:
        return memo[1]
    rows, cols = S.host_tiles()
    blocks = S.blocks.clone()
    dev = blocks.device
    if rmod:
        idx = np.nonzero(rows == S.shape[0] // bs)[0]
        if idx.size:
            blocks[torch.as_tensor(idx, device=dev), rmod:, :] = 0
    if cmod:
        idx = np.nonzero(cols == S.shape[1] // bs)[0]
        if idx.size:
            blocks[torch.as_tensor(idx, device=dev), :, cmod:] = 0
    S._spgemm_edge_memo = (S.blocks, blocks)
    return blocks


# -- public API -------------------------------------------------------------


def spgemm_tiles(A: BlockSparseMatrix, B: BlockSparseMatrix,
                 config: Optional[MatrelConfig] = None,
                 kernel: Optional[str] = None):
    """C = A·B as (tiles, out_rows, out_cols): the output tile stack
    [n_out, bs, bs] on A's device plus its host coordinates on the
    (gr_A, gc_B) grid. Neither operand is densified; an empty
    intersection yields one zero tile at (0, 0) and launches nothing.
    ``kernel`` forces one registered kernel id (None: the registry
    selects)."""
    cfg = config or default_config()
    _check_shapes(A, B)
    pa, pb, slot, out_rows, out_cols = _pair_structure_cached(A, B)
    out_dtype = _out_dtype(A, B, cfg)
    if pa.size == 0:
        bs = A.block_size
        tiles = torch.zeros((1, bs, bs), dtype=out_dtype,
                            device=A.blocks.device)
        return tiles, np.zeros(1, np.int32), np.zeros(1, np.int32)
    n_out = int(out_rows.size)
    run = _tiles_runner(A, B, cfg, (slot, pa, pb, out_rows, out_cols),
                        n_out, out_dtype, kernel=kernel)
    return run(_edge_masked(A), _edge_masked(B)), out_rows, out_cols


def spgemm(A: BlockSparseMatrix, B: BlockSparseMatrix,
           config: Optional[MatrelConfig] = None,
           kernel: Optional[str] = None) -> BlockSparseMatrix:
    """C = A·B with a SPARSE result: only the tile intersections are
    computed and only the nonzero output tiles are stored."""
    tiles, out_rows, out_cols = spgemm_tiles(A, B, config, kernel=kernel)
    dev = tiles.device
    C = BlockSparseMatrix(
        blocks=tiles,
        block_rows=torch.as_tensor(out_rows, device=dev),
        block_cols=torch.as_tensor(out_cols, device=dev),
        shape=(A.shape[0], B.shape[1]), block_size=A.block_size,
        mesh=A.mesh)
    C._seed_host_tiles(out_rows, out_cols)
    return C


def apply_dense(A: BlockSparseMatrix, B: BlockSparseMatrix,
                config: Optional[MatrelConfig] = None,
                kernel: Optional[str] = None,
                epilogue=None, epilogue_elementwise: bool = False
                ) -> torch.Tensor:
    """SpGEMM for the executor: the product as a PADDED dense tensor
    (``padding.padded_shape`` on A's mesh), what every other lowering
    hands its consumer. The tile stack is scattered straight into the
    zeroed output through a (gr, gc, bs, bs) view of it, so the dense
    result is materialised once.

    ``epilogue`` is the fused-region slot: the absorbed consumer chain
    reaches the kernel's output through the registry's per-structure
    hook (``kernel_registry.epilogue_mode``). A zero-preserving
    pointwise chain (``epilogue_elementwise`` True, the executor's
    proof) runs tile-wise over the output stack before the scatter on
    the classes registered "tilewise" (B5–B7's); everything else runs
    over the padded dense output after it. No kernel body is forked."""
    from matrel_tpu_torch.ops import kernel_registry as kr
    tiles, out_rows, out_cols = spgemm_tiles(A, B, config, kernel=kernel)
    if epilogue is not None and kr.epilogue_mode(
            kr.pair_class_of(A, B), epilogue_elementwise) == "tilewise":
        tiles = kr.apply_tile_epilogue(tiles, epilogue)
        epilogue = None               # consumed before the scatter
    n, m = A.shape[0], B.shape[1]
    bs = A.block_size
    gr, gc = math.ceil(n / bs), math.ceil(m / bs)
    pshape = padding.padded_shape((n, m), A.mesh)
    dense = torch.zeros((max(pshape[0], gr * bs), max(pshape[1], gc * bs)),
                        dtype=tiles.dtype, device=tiles.device)
    grid = dense[: gr * bs, : gc * bs].view(gr, bs, gc, bs).permute(0, 2, 1,
                                                                     3)
    # the output coordinates go to the device once per operand pair: a
    # pageable upload per query would also hold the host until the
    # zero fill above has run
    key = (id(A), id(B), "coords")
    coords = _STRUCT_CACHE.get(key)
    if coords is None:
        coords = tuple(torch.as_tensor(x, device=tiles.device).long()
                       for x in (out_rows, out_cols))
        _STRUCT_CACHE[key] = coords
    grid[coords] = tiles
    # tiles may overhang the logical edge on ragged shapes; the overhang
    # is exact zeros (_edge_masked scrubs both operands), and what lies
    # past the padded shape is cut off here
    dense = dense[: pshape[0], : pshape[1]]
    return dense if epilogue is None else epilogue(dense)


# -- rank-sharded (ops/spmm_sharded.py style) -------------------------------


def spgemm_sharded(A: BlockSparseMatrix, B: BlockSparseMatrix,
                   config: Optional[MatrelConfig] = None
                   ) -> BlockSparseMatrix:
    """Scale-out SpGEMM on a rank mesh: the PAIR list cut over the ranks.

    Output tile slots are cut into ``mesh.size`` equal contiguous
    ranges; each rank owns the pairs landing in its range and computes
    its local output sub-stack (gather / batched product / ``index_add_``
    — an XLA composite in the JAX package, not a Pallas kernel), then one
    ``all_gather`` assembles the stack on every rank. The operands are
    whole on every rank (the tile stacks are the broadcast side)."""
    from matrel_tpu_torch.ops.spmm_sharded import tile_bmm
    from matrel_tpu_torch.parallel import collectives as coll
    cfg = config or default_config()
    _check_shapes(A, B)
    mesh = A.mesh
    if not mesh.ranked:
        raise ValueError("spgemm_sharded needs a rank mesh "
                         "(core.mesh.init_distributed)")
    p, rank = mesh.size, mesh.ranks.rank
    bs = A.block_size
    pa, pb, slot, out_rows, out_cols = _pair_structure_cached(A, B)
    out_dtype = _out_dtype(A, B, cfg)
    dev = mesh.device
    if pa.size == 0:
        return BlockSparseMatrix(
            blocks=torch.zeros((1, bs, bs), dtype=out_dtype, device=dev),
            block_rows=torch.zeros(1, dtype=torch.int32, device=dev),
            block_cols=torch.zeros(1, dtype=torch.int32, device=dev),
            shape=(A.shape[0], B.shape[1]), block_size=bs, mesh=mesh)
    n_out = int(out_rows.size)
    spr = -(-n_out // p)                 # output slots per rank
    mine = np.nonzero(slot // spr == rank)[0]
    common = torch.promote_types(A.dtype, B.dtype)
    ab = torch.cat([_edge_masked(A).to(common),
                    torch.zeros((1, bs, bs), dtype=common, device=dev)])
    bb = torch.cat([_edge_masked(B).to(common),
                    torch.zeros((1, bs, bs), dtype=common, device=dev)])
    local = torch.zeros((spr, bs, bs), dtype=torch.float32, device=dev)
    # chunks of pairs bound the gathered (chunk, bs, bs) operands
    step = max(1, (256 << 20) // (bs * bs * 4))
    for c0 in range(0, mine.size, step):
        sel = mine[c0:c0 + step]
        ia = torch.as_tensor(pa[sel].astype(np.int64), device=dev)
        ib = torch.as_tensor(pb[sel].astype(np.int64), device=dev)
        sl = torch.as_tensor((slot[sel] % spr).astype(np.int64), device=dev)
        local.index_add_(0, sl, tile_bmm(ab[ia], bb[ib]))
    tiles = coll.all_gather(local, mesh, None, dim=0)[:n_out]
    return BlockSparseMatrix(
        blocks=tiles.to(out_dtype),
        block_rows=torch.as_tensor(np.asarray(out_rows, np.int32),
                                   device=dev),
        block_cols=torch.as_tensor(np.asarray(out_cols, np.int32),
                                   device=dev),
        shape=(A.shape[0], B.shape[1]), block_size=bs, mesh=mesh)
