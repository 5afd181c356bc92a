"""Rank-sharded block-sparse SpMM — the counterpart of
``matrel_tpu/ops/spmm_sharded.py``: the tile stack distributed over the
ranks of a rank mesh.

The one-card SpMM (``ops/spmm.py``) keeps the whole tile stack on the
device. Here the output block-row space is cut into ``mesh.size`` equal
contiguous ranges; each rank holds exactly the tiles whose block row
falls in its range, zero-padded to the largest rank's tile count (a
sentinel slot multiplies a zero tile). Per rank: a gather of the
replicated dense operand's row blocks, one batched product over the
local stack, an ``index_add_`` into the local row range, then ONE
``all_gather`` assembles the output rows. The JAX package writes the
same body in XLA (gather / batched dot / ``segment_sum``), not as a
Pallas kernel, so the stock torch ops are its faithful port; B1 per
rank would be a schedule the JAX package lacks.

Balance: contiguous equal row ranges balance tile counts for uniformly
scattered sparsity; row-clustered stacks pad toward the densest rank,
which ``padding_ratio`` shows.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core import padding
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.mesh import Mesh
from matrel_tpu_torch.core.sparse import BlockSparseMatrix

Tensor = torch.Tensor


def tile_bmm(a: Tensor, b: Tensor) -> Tensor:
    """Batched tile product accumulated in f32: bf16 tiles on the
    card's tensor cores with an f32 result, f32 tiles with TF32 off; on
    the CPU bf16 widens to f32 first (a bf16×bf16 product is exact in
    f32)."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    _highest_precision()
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


@dataclasses.dataclass
class ShardedBlockSparseMatrix:
    """One rank's share of a row-range-decomposed tile stack: ``blocks``
    (cap, bs, bs) with ``brow_loc`` each tile's block row LOCAL to the
    rank's range and ``bcols`` its block column; padded slots carry zero
    tiles at (0, 0)."""

    blocks: Tensor
    brow_loc: Tensor
    bcols: Tensor
    shape: Tuple[int, int]
    block_size: int
    rows_per_rank: int
    cap: int
    nnzb: int
    mesh: Mesh
    padding_ratio: float

    @property
    def grid(self) -> Tuple[int, int]:
        bs = self.block_size
        return (-(-self.shape[0] // bs), -(-self.shape[1] // bs))

    def multiply(self, other, config=None) -> BlockMatrix:
        """Eager sharded SpMM (the lazy IR keeps one-card plans; a
        sharded stack is an explicit scale-out choice)."""
        return spmm_sharded(self, other, config)

    def __repr__(self):
        return (f"ShardedBlockSparseMatrix(shape={self.shape}, "
                f"bs={self.block_size}, nnzb={self.nnzb}, "
                f"ranks={self.mesh.size}, cap/rank={self.cap})")


def shard_block_sparse(S: BlockSparseMatrix, mesh: Mesh = None
                       ) -> ShardedBlockSparseMatrix:
    """This rank's share of S's tile stack on the rank mesh (default:
    S.mesh)."""
    mesh = mesh or S.mesh
    if not mesh.ranked:
        raise ValueError("shard_block_sparse needs a rank mesh "
                         "(core.mesh.init_distributed)")
    p, rank = mesh.size, mesh.ranks.rank
    bs = S.block_size
    gr, _ = S.grid
    rows_per_rank = -(-gr // p)
    host_rows, host_cols = S.host_tiles()
    order = np.argsort(host_rows, kind="stable")
    owner = host_rows[order] // rows_per_rank
    counts = np.bincount(owner, minlength=p)
    cap = max(1, int(counts.max()))  # matlint: disable=ML001 host numpy tile counts, no device
    mine = order[owner == rank]
    dev = mesh.device
    src = np.full(cap, S.nnzb, np.int64)          # sentinel → zero tile
    src[:mine.size] = mine
    brow = np.zeros(cap, np.int64)
    bcol = np.zeros(cap, np.int64)
    brow[:mine.size] = host_rows[mine] % rows_per_rank
    bcol[:mine.size] = host_cols[mine]
    stack = torch.cat([S.blocks.to(dev),  # matlint: disable=ML008 the tile stack placed on this rank's device once, at shard build
                       S.blocks.new_zeros((1, bs, bs), device=dev)])
    return ShardedBlockSparseMatrix(
        blocks=stack[torch.as_tensor(src, device=dev)].contiguous(),
        brow_loc=torch.as_tensor(brow, device=dev),
        bcols=torch.as_tensor(bcol, device=dev),
        shape=tuple(S.shape), block_size=bs, rows_per_rank=rows_per_rank,
        cap=cap, nnzb=S.nnzb, mesh=mesh,
        padding_ratio=p * cap / max(S.nnzb, 1))


def spmm_sharded(S: ShardedBlockSparseMatrix, D,
                 config: MatrelConfig = None) -> BlockMatrix:
    """C = S @ D with the tile stack sharded over S.mesh, f32-accumulated
    and stored in the stack's dtype. ``D`` is a BlockMatrix on the same
    rank mesh (gathered whole first) or a tensor every rank holds;
    returns the rank's canonical block of C. Every rank calls it.
    ``config`` is accepted for the JAX package's signature (its
    precision is the port's fixed f32 accumulation)."""
    from matrel_tpu_torch.parallel import collectives as coll
    mesh = S.mesh
    if isinstance(D, BlockMatrix):
        dd, d_shape = coll.gather_full(D.as_shard(), mesh), D.shape
    else:
        dd = torch.as_tensor(D, device=mesh.device)
        d_shape = tuple(dd.shape)
    n, k = S.shape
    if d_shape[0] != k:
        raise ValueError(f"spmm shape mismatch: {S.shape} x {d_shape}")
    bs, (_, gc) = S.block_size, S.grid
    pm = dd.shape[1]
    want = gc * bs
    dd = dd[:want]
    if dd.shape[0] < want:
        dd = torch.nn.functional.pad(dd, (0, 0, 0, want - dd.shape[0]))
    common = torch.promote_types(S.blocks.dtype, dd.dtype)
    dblocks = dd.to(common).reshape(gc, bs, pm)
    local = torch.zeros((S.rows_per_rank, bs, pm), dtype=torch.float32,
                        device=dd.device)
    # chunks of tiles bound the gathered (chunk, bs, pm) operand
    step = max(1, (256 << 20) // max(bs * pm * 4, 1))
    for c0 in range(0, S.cap, step):
        sl = slice(c0, c0 + step)
        part = tile_bmm(S.blocks[sl].to(common), dblocks[S.bcols[sl]])
        local.index_add_(0, S.brow_loc[sl], part)
    out = coll.all_gather(local.reshape(S.rows_per_rank * bs, pm), mesh,
                          None, dim=0)
    pshape = padding.padded_shape((n, d_shape[1]), mesh)
    out = out[:pshape[0], :pshape[1]]
    if tuple(out.shape) != pshape:
        out = torch.nn.functional.pad(
            out, (0, pshape[1] - out.shape[1], 0, pshape[0] - out.shape[0]))
    out = out.to(S.blocks.dtype)
    spec = padding.canonical_spec(pshape, mesh)
    return BlockMatrix.from_array(coll.local_of(out, coll.layout_of(
        spec, mesh), mesh).contiguous(), (n, d_shape[1]), mesh, spec,
        block_size=bs)
