"""Block-sparse × dense SpMM kernel — the counterpart of
``matrel_tpu/ops/pallas_spmm.py`` (TPU kernel B1, ``_make_kernel``).

The hot op of BASELINE row 4. On a CUDA tensor the wrapper
:func:`spmm_blocksparse` launches the hand-written Hopper kernel in
``csrc/spmm_blocksparse.cu`` (built at first use, loaded with ctypes)
through the tile body :mod:`tile_body` chooses by shape: for bf16 the
``wgmma`` body of ``csrc/bf16_tile_wgmma.cuh`` or the WMMA one; for f32
the row walk of the .cu file (``"f32_narrow"``, a dense operand of at
most ``tile_body.F32_NARROW_MAX`` columns, as block-sparse PageRank's
one) or the SIMT tile body of ``csrc/f32_tile_simt.cuh`` that B4–B7
share. On a CPU tensor it runs the plain PyTorch version
:func:`spmm_blocksparse_plain` beside it — the same function, gather →
batched matmul → ``index_add_``. There is no fallback from one to the
other: a CUDA tensor launches the kernel or raises.

The kernel walks each block row's tiles through a CSR ``row_ptr``
built once per matrix on the host and memoised on the matrix
(:func:`csr_payload` — the counterpart of ``_pallas_payload_memo``).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.ops import tile_body

#: Kernel launches made by :func:`spmm_blocksparse` (counted where the
#: kernel is launched and nowhere else), in all and by tile body.
LAUNCHES = 0
BODY_LAUNCHES = dict.fromkeys(tile_body.CODES, 0)

SOURCE = "spmm_blocksparse.cu"

_DTYPES = (torch.float32, torch.bfloat16)

#: Tiles per step of the plain version: bounds its f32 temporaries to
#: about 3 x 64 MiB at bs = pm = 512 (its f64 tiles, at narrow pm, to
#: 128 MiB).
_PLAIN_CHUNK_ELEMS = 1 << 24


def _library() -> ctypes.CDLL:
    from matrel_tpu_torch.utils import cuda_build
    lib = cuda_build.load(SOURCE)
    fn = lib.matrel_spmm_blocksparse
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p, p, p, p, p, i, i, i, ll, ll, ll, ll, i, i, i, p]
        fn.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def spmm_blocksparse_plain(blocks: torch.Tensor, block_rows: torch.Tensor,
                           block_cols: torch.Tensor, d: torch.Tensor,
                           out_rows: int) -> torch.Tensor:
    """Plain PyTorch Y = S·D: gather the dense row blocks each tile
    reads, one batched matmul (TF32 off), ``index_add_`` into the output
    row blocks, cast to the payload dtype. Rows of ``d`` past its end
    read as zero; rows of Y past the tile grid are zero.

    It sums as the kernel's body does: in f32, but for f32 payloads
    whose D the narrow body takes (``tile_body.f32_body``), which sum in
    f64 — every f32 × f32 product is exact there — and round once, so
    the kernel and this version agree bit for bit, and both sit closer
    to a float64 oracle than the JAX package's f32 sum (the CPU tests
    hold them to it at its own f32 tolerance)."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    nnzb, bs, _ = blocks.shape
    pm = d.shape[1]
    gr_out = math.ceil(out_rows / bs)
    want = max(-(-d.shape[0] // bs), 1) * bs     # d's last block padded
    if d.shape[0] < want:
        d = torch.nn.functional.pad(d, (0, 0, 0, want - d.shape[0]))
    dblocks = d.reshape(-1, bs, pm)
    nd = dblocks.shape[0]
    # a tile whose column block lies past d's end reads zeros: its product
    # goes to a spare output block that is dropped, chosen on the device
    # (no host read of the largest column)
    cols = block_cols.long()
    src = cols.clamp(max=nd - 1)
    dest = torch.where(cols < nd, block_rows.long(), gr_out)
    narrow = (blocks.dtype == torch.float32
              and tile_body.f32_body(pm) == "f32_narrow")
    acc_dtype = torch.float64 if narrow else torch.float32
    acc = torch.zeros((gr_out + 1, bs, pm), dtype=acc_dtype,
                      device=blocks.device)
    _highest_precision()
    step = max(1, _PLAIN_CHUNK_ELEMS // (bs * max(bs, pm)))
    for s in range(0, nnzb, step):
        tiles = blocks[s:s + step].to(acc_dtype)
        gathered = dblocks[src[s:s + step]].to(acc_dtype)
        acc.index_add_(0, dest[s:s + step], torch.bmm(tiles, gathered))
    return acc[:gr_out].reshape(gr_out * bs, pm)[:out_rows].to(blocks.dtype)


def _check(blocks, row_ptr, bcols, d, out_rows) -> None:
    if blocks.dim() != 3 or blocks.shape[1] != blocks.shape[2]:
        raise ValueError(f"blocks must be [nnzb, bs, bs], got {tuple(blocks.shape)}")
    if blocks.dtype not in _DTYPES:
        raise TypeError(f"payload dtype {blocks.dtype} not supported "
                        f"(float32 or bfloat16)")
    if d.dtype != blocks.dtype:
        raise TypeError(f"dense operand dtype {d.dtype} != payload dtype "
                        f"{blocks.dtype}")
    if d.dim() != 2 or d.shape[1] < 1:
        raise ValueError(f"dense operand must be 2D, got {tuple(d.shape)}")
    if row_ptr.dtype != torch.int32 or bcols.dtype != torch.int32:
        raise TypeError("row_ptr and bcols must be int32")
    if row_ptr.dim() != 1 or row_ptr.numel() < 2:
        raise ValueError("row_ptr must be a 1D [gr + 1] tensor")
    if bcols.shape != (blocks.shape[0],):
        raise ValueError(f"bcols must be [nnzb], got {tuple(bcols.shape)}")
    devs = {t.device for t in (blocks, row_ptr, bcols, d)}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: {sorted(map(str, devs))}")
    if not all(t.is_contiguous() for t in (blocks, row_ptr, bcols, d)):
        raise ValueError("spmm_blocksparse needs contiguous tensors")
    if out_rows < 1:
        raise ValueError(f"out_rows must be >= 1, got {out_rows}")


def body(blocks: torch.Tensor, d: torch.Tensor, out: torch.Tensor) -> str:
    """The tile body a launch over these operands runs: for f32 payloads
    :func:`tile_body.f32_body` by D's width, else
    :func:`tile_body.body_of` (the output's columns are D's)."""
    if blocks.dtype == torch.float32:
        return tile_body.f32_body(d.shape[1])
    return tile_body.body_of(blocks.dtype, blocks.shape[1], d.shape[1],
                             blocks, d, out)


def spmm_blocksparse(blocks: torch.Tensor, row_ptr: torch.Tensor,
                     bcols: torch.Tensor, d: torch.Tensor,
                     out_rows: int) -> torch.Tensor:
    """Y[out_rows, pm] = S·D for S in CSR tile order (``row_ptr`` [gr+1],
    ``bcols`` [nnzb] int32, ``blocks`` [nnzb, bs, bs]) in the payload
    dtype. CUDA tensors launch the Hopper kernel on the current stream,
    with the tile body :func:`body` chooses; CPU tensors run
    :func:`spmm_blocksparse_plain`."""
    global LAUNCHES
    _check(blocks, row_ptr, bcols, d, out_rows)
    dev = blocks.device
    if dev.type == "cpu":
        counts = row_ptr[1:] - row_ptr[:-1]
        rows = torch.repeat_interleave(
            torch.arange(counts.numel(), dtype=torch.int32), counts.long())
        return spmm_blocksparse_plain(blocks, rows, bcols, d, out_rows)
    if dev.type != "cuda":
        raise ValueError(f"spmm_blocksparse runs on CUDA or CPU tensors, "
                         f"got {dev}")
    nnzb, bs, _ = blocks.shape
    pm = d.shape[1]
    vec = 16 // blocks.element_size()          # elements per 16-byte load
    a_vec = int(bs % vec == 0 and blocks.data_ptr() % 16 == 0)
    d_vec = int(pm % vec == 0 and d.data_ptr() % 16 == 0)
    out = torch.empty((out_rows, pm), dtype=blocks.dtype, device=dev)
    chosen = body(blocks, d, out)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.matrel_spmm_blocksparse(
            blocks.data_ptr(), row_ptr.data_ptr(), bcols.data_ptr(),
            d.data_ptr(), out.data_ptr(), tile_body.CODES[chosen],
            row_ptr.numel() - 1, bs, nnzb, d.shape[0], pm, out_rows, a_vec,
            d_vec, dev.index, stream)
    tile_body.raise_on(rc, f"spmm_blocksparse ({chosen} body)")
    LAUNCHES += 1
    BODY_LAUNCHES[chosen] += 1
    return out


def csr_payload(S) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            torch.Tensor]:
    """(blocks the memo was built from, payload in CSR order, row_ptr,
    bcols) for a BlockSparseMatrix, memoised on S. Tiles are already
    row-major sorted by construction, so the payload is S.blocks itself
    (no copy); an unsorted stack is permuted once."""
    memo = getattr(S, "_spmm_csr_memo", None)
    if memo is not None and memo[0] is S.blocks:
        return memo
    rows = S.block_rows.cpu().numpy().astype(np.int64)  # matlint: disable=ML001 once-per-matrix CSR memo (csr_payload), never a warm query
    cols = S.block_cols.cpu().numpy().astype(np.int64)  # matlint: disable=ML001 once-per-matrix CSR memo (csr_payload), never a warm query
    order = np.lexsort((cols, rows))
    dev = S.blocks.device
    payload = S.blocks
    if not np.array_equal(order, np.arange(len(order))):
        payload = payload[torch.as_tensor(order, device=dev)]
    gr = S.grid[0]
    row_ptr = np.zeros(gr + 1, np.int32)
    np.cumsum(np.bincount(rows, minlength=gr), out=row_ptr[1:])
    memo = (S.blocks, payload.contiguous(),
            torch.as_tensor(row_ptr, device=dev),
            torch.as_tensor(cols[order].astype(np.int32), device=dev))
    S._spmm_csr_memo = memo
    return memo


def make_spmm(S, pm: int, out_pshape: Tuple[int, int],
              cfg: MatrelConfig):
    """An SpMM runner bound to S's tile structure (CSR memo built now).
    The runner refuses a reassigned ``S.blocks``: the baked payload
    cannot see it."""
    baked_blocks, payload, row_ptr, bcols = csr_payload(S)

    def run(blocks: torch.Tensor, dd: torch.Tensor) -> torch.Tensor:
        if blocks is not baked_blocks:
            raise ValueError(
                "S.blocks was reassigned after the SpMM runner was built; "
                "construct a new BlockSparseMatrix instead of mutating")
        return spmm_blocksparse(payload, row_ptr, bcols, dd, out_pshape[0])

    return run
