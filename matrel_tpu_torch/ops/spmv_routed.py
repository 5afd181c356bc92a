"""The bf16 residual split — the one piece of
``matrel_tpu/ops/spmv_routed.py`` the compact SpMV kernels share.

The rest of that module (the routed SpMV, TPU kernel B8) is not ported
yet.
"""

from __future__ import annotations

from typing import List

import torch

#: int32 view of the mask 0xFFFF0000: keeps sign, exponent and the top
#: 7 mantissa bits of an f32 — a value on the bf16 grid.
_HI16 = -(1 << 16)


def _bf16_split(v: torch.Tensor, passes: int) -> List[torch.Tensor]:
    """Residual bf16 decomposition: Σ parts ≈ v with error ~2^(-8·passes).

    Parts are carved by masking the low 16 bits of the f32 pattern
    (truncation toward zero), not by dtype casts, and come back as f32
    tensors whose values sit exactly on the bf16 grid. Each part and
    each residual is exact, so the sum of the first two parts is ``v``
    truncated to its leading 16 significant bits and the sum of all
    three is ``v`` itself."""
    parts = []
    rem = v.float().contiguous()
    for _ in range(passes):
        hi = (rem.view(torch.int32) & _HI16).view(torch.float32)
        parts.append(hi)
        rem = rem - hi
    return parts


def split_sum(v: torch.Tensor, passes: int) -> torch.Tensor:
    """Σ of the first ``passes`` parts of :func:`_bf16_split` — the value
    each slot contributes to the compact SpMV kernels' sums."""
    parts = _bf16_split(v, passes)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out
