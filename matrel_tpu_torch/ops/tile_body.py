"""Which tile body a block-sparse kernel launch runs: the choice by shape,
made in Python before the launch and passed to the C entry point as a
code.

B1 (``ops/pallas_spmm.py``) and B4–B7 (``ops/pallas_spgemm.py``) run f32
payloads on ``"f32"``, the register-blocked SIMT body of
``csrc/f32_tile_simt.cuh`` (full-f32 FMA on the CUDA cores, a 128 × 128
sub-tile a CTA), which the five kernels share; B1 runs a dense operand
of at most :data:`F32_NARROW_MAX` columns on ``"f32_narrow"`` instead,
the row walk of ``csrc/spmm_blocksparse.cu`` (f64 sums, rounded once).
bf16 payloads run either ``"wgmma"`` — the Hopper body of
``csrc/bf16_tile_wgmma.cuh`` (TMA into a shared-memory ring, ``wgmma``
from shared memory, a 128 × 256 sub-tile a CTA) — or ``"wmma"``, the
64 × 64 WMMA body of each ``.cu`` file, for the shapes the first cannot
take. The C side refuses a ``"wgmma"`` or ``"f32_narrow"`` code for a
shape its body cannot take; nothing retries another body.
"""

from __future__ import annotations

import torch

#: The bodies, and the code each passes as the entry point's dtype code.
CODES = {"f32": 0, "wmma": 1, "wgmma": 2, "f32_narrow": 3}

#: The widest dense operand (columns) that B1's f32 launches run on the
#: narrow body: the largest width at which it beat the wide body on
#: block-sparse PageRank's tiles (588 f32 512² tiles) on an H100 80GB
#: HBM3 at 700 W — 0.50 against 0.58 ms at 8 columns, 1.02 against 0.58
#: at 16 (``chip_smoke.py``'s crossover sweep, PERF.md). The C side
#: takes at most 16.
F32_NARROW_MAX = 8


def f32_body(pm: int) -> str:
    """B1's f32 body for a dense operand of ``pm`` columns: ``"f32_narrow"``
    up to :data:`F32_NARROW_MAX`, else ``"f32"``."""
    return "f32_narrow" if pm <= F32_NARROW_MAX else "f32"


def bf16_body(bs: int, pm: int, aligned: bool) -> str:
    """``"wgmma"`` where the wgmma body takes the shape, else ``"wmma"``:
    ``bs`` a power of two >= 64 (the 64-deep k-chunks divide it, and the
    128-row and 256-column sub-tiles divide it or hold all of it), ``pm``
    (the output's columns: D's for B1, ``bs`` for B4–B7) a multiple of 8
    so that every row is a multiple of 16 bytes, as TMA needs, and
    ``aligned``: every operand non-empty and 16-byte aligned."""
    pow2 = bs >= 64 and bs & (bs - 1) == 0
    return "wgmma" if pow2 and pm % 8 == 0 and aligned else "wmma"


def body_of(dtype: torch.dtype, bs: int, pm: int, *operands) -> str:
    """The tile body a launch over ``operands`` runs: ``"f32"`` for f32
    payloads (B1 takes :func:`f32_body` instead: only it has a narrow
    body), else :func:`bf16_body` with ``aligned`` read from the
    operands' pointers."""
    if dtype == torch.float32:
        return "f32"
    aligned = all(t.numel() > 0 and t.data_ptr() % 16 == 0
                  for t in operands)
    return bf16_body(bs, pm, aligned)


#: Return codes of the C entry points from this value up: a tensor map
#: that could not be encoded (``tile_wgmma::ENCODE_FAILED`` + CUresult).
ENCODE_FAILED = 10000


def raise_on(rc: int, name: str) -> None:
    """Raise unless a C entry point returned 0."""
    if rc >= ENCODE_FAILED:
        raise RuntimeError(f"{name}: TMA tensor map encode failed: CUresult "
                           f"{rc - ENCODE_FAILED}")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
