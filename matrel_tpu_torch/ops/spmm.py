"""Block-sparse × dense MatMul (SpMM) — the counterpart of
``matrel_tpu/ops/spmm.py``, the BASELINE row-4 op.

``use_pallas=True`` (the default) runs the kernel route of
``ops/pallas_spmm.py``: the Hopper kernel for CUDA tensors, its plain
version for CPU tensors. ``use_pallas=False`` runs the plain version
directly (the counterpart of ``_xla_spmm``), which honours a reassigned
``S.blocks`` where the kernel route's runner refuses it.
"""

from __future__ import annotations

import weakref
from typing import Optional, Tuple

import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.core import padding
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.sparse import BlockSparseMatrix
from matrel_tpu_torch.ops import pallas_spmm

# Runner cache keyed on the matrix (id) and the static pieces of the
# plan. Runner closures capture values from S, never S itself, and a
# weakref finalizer purges a matrix's entries when it is collected.
_RUNNER_CACHE: dict = {}
_FINALIZER_IDS: set = set()


def _purge_runners(sid: int) -> None:
    _FINALIZER_IDS.discard(sid)
    for k in [k for k in _RUNNER_CACHE if k[0] == sid]:
        del _RUNNER_CACHE[k]


def _cached_runner(S, pm, out_pshape, cfg):
    key = (id(S), pm, out_pshape, cfg.use_pallas)
    run = _RUNNER_CACHE.get(key)
    if run is None:
        if cfg.use_pallas:
            run = pallas_spmm.make_spmm(S, pm, out_pshape, cfg)
        else:
            run = _xla_spmm(S, pm, out_pshape, cfg)
        _RUNNER_CACHE[key] = run
        if id(S) not in _FINALIZER_IDS:
            _FINALIZER_IDS.add(id(S))
            weakref.finalize(S, _purge_runners, id(S))
    return run


def apply(S: BlockSparseMatrix, dd: torch.Tensor, d_shape: Tuple[int, int],
          config: Optional[MatrelConfig] = None,
          epilogue=None) -> torch.Tensor:
    """S (static tile metadata) × dense padded tensor ``dd`` of logical
    shape ``d_shape``; returns the padded product. ``dd`` is cast to the
    payload dtype (the output is in the payload dtype either way).

    ``epilogue`` is the fused-region slot: a callable applied to the
    padded product (B1's output) in the same call, so an absorbed
    consumer chain runs as the SpMM's epilogue. The runner is one per
    matrix, never forked per epilogue; None keeps the plain path."""
    cfg = config or default_config()
    n, k = S.shape
    k2, m = d_shape
    if k != k2:
        raise ValueError(f"spmm shape mismatch: {S.shape} x {d_shape}")
    out_pshape = padding.padded_shape((n, m), S.mesh)
    dd = dd.to(S.dtype).contiguous()
    pm = dd.shape[1]
    run = _cached_runner(S, pm, out_pshape, cfg)
    out = run(S.blocks, dd)
    if tuple(out.shape) != out_pshape:
        out = torch.nn.functional.pad(
            out[:, : out_pshape[1]], (0, max(out_pshape[1] - pm, 0)))
    return out if epilogue is None else epilogue(out)


def rank_split(S: BlockSparseMatrix, pm: int, mesh) -> str:
    """How B1 runs on a rank mesh against a dense operand of ``pm``
    padded columns: "col_slice" — each rank its slice of pm / size
    columns (the JAX package's ``P(None, (x, y))`` for D), where the
    width divides over the ranks and the slice runs on the tile body
    the whole width runs on (``ops/tile_body.py``: a narrower slice
    could fall to another body, whose sums round differently) — else
    "whole": every rank the whole product."""
    from matrel_tpu_torch.ops import tile_body
    p = mesh.size
    if pm % p or pm < p:
        return "whole"

    def body(w: int) -> str:
        if S.dtype == torch.float32:
            return tile_body.f32_body(w)
        return tile_body.bf16_body(S.block_size, w, True)

    return "col_slice" if body(pm // p) == body(pm) else "whole"


def apply_cols(S: BlockSparseMatrix, d, d_shape: Tuple[int, int], mesh,
               config: Optional[MatrelConfig] = None, epilogue=None):
    """S × D on a rank mesh, each rank running B1 on its column slice of
    D (``d`` a ``collectives.Shard``, re-laid by columns through one
    counted relay, or a whole tensor, cut with no collective) against
    the whole tile stack; returns this rank's columns of the product as
    a Shard laid out by columns. Columns are independent, so each slice
    is one card's columns of the product. ``epilogue`` gets that
    Shard."""
    from matrel_tpu_torch.parallel import collectives as coll
    cfg = config or default_config()
    n, k = S.shape
    if k != d_shape[0]:
        raise ValueError(f"spmm shape mismatch: {S.shape} x {d_shape}")
    col = coll.STATES["col"]
    if isinstance(d, torch.Tensor):
        local = coll.local_of(d, col, mesh)
    else:
        local = coll.relay(d, col, mesh).local
    local = local.to(S.dtype).contiguous()
    out_pshape = padding.padded_shape((n, d_shape[1]), mesh)
    w = local.shape[1]
    run = _cached_runner(S, w, (out_pshape[0], w), cfg)
    out = coll.Shard(run(S.blocks, local), col, out_pshape)
    return out if epilogue is None else epilogue(out)


def spmm(S: BlockSparseMatrix, D: BlockMatrix,
         config: Optional[MatrelConfig] = None) -> BlockMatrix:
    """C = S @ D with S block-sparse (n×k), D dense (k×m)."""
    cfg = config or default_config()
    n, _ = S.shape
    _, m = D.shape
    data = apply(S, D.data, D.shape, cfg)
    return BlockMatrix.from_array(
        data, (n, m), S.mesh,
        padding.canonical_spec(tuple(data.shape), S.mesh),
        nnz=None, block_size=S.block_size)


def _xla_spmm(S, pm, out_pshape, cfg):
    rows, cols = S.block_rows, S.block_cols

    def run(blocks: torch.Tensor, dd: torch.Tensor) -> torch.Tensor:
        return pallas_spmm.spmm_blocksparse_plain(blocks, rows, cols, dd,
                                                  out_pshape[0])

    return run



def spmv(S: BlockSparseMatrix, v: BlockMatrix,
         config: Optional[MatrelConfig] = None) -> BlockMatrix:
    """Sparse matrix × vector — the PageRank building block (``spmm``
    with a one-column ``v``)."""
    return spmm(S, v, config)
