"""Precision-tiered matmul lowering — the counterpart of
``matrel_tpu/ops/precision.py``.

Each f32 operand splits into bf16 residual slices (hi = bf16(x),
lo = bf16(x − hi)) and the significant cross-products accumulate in
f32; keeping hi·hi + hi·lo + lo·hi drops only the ~2^-16-relative lo·lo
term. The split is run here explicitly: torch's "high" float32 matmul
precision means TF32, a different and looser algorithm. The int tiers
cast integer-valued operands to integers and keep the int32 result.
"""

from __future__ import annotations

from typing import Callable, List

import torch

MM = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def bf16_slices(x: torch.Tensor, k: int) -> List[torch.Tensor]:
    """f32 → k bf16 residual slices with Σ slices ≈ x (error ~2^(-8k)
    relative). k=2 is :func:`ops.gram.hi_lo_split`."""
    from matrel_tpu_torch.ops.gram import hi_lo_split
    if k == 2:
        return list(hi_lo_split(x))
    parts: List[torch.Tensor] = []
    r = x.float()
    for _ in range(k):
        p = r.to(torch.bfloat16)
        parts.append(p)
        r = r - p.float()
    return parts


def tiered_matmul(tier: str, a: torch.Tensor, b: torch.Tensor,
                  mm: MM) -> torch.Tensor:
    """One matmul at a stamped precision tier. ``mm(p, q)`` is the
    strategy's product and accumulates wide (bf16 → f32, int → int32)."""
    if tier == "bf16x1":
        return mm(a.to(torch.bfloat16), b.to(torch.bfloat16))
    if tier == "bf16x3":
        a_hi, a_lo = bf16_slices(a, 2)
        b_hi, b_lo = bf16_slices(b, 2)
        return mm(a_hi, b_hi) + mm(a_hi, b_lo) + mm(a_lo, b_hi)
    if tier in ("int32", "int8"):
        cast = torch.int8 if tier == "int8" else torch.int32
        return mm(a.to(cast), b.to(cast))
    if tier == "f32":
        return mm(a, b)
    raise ValueError(f"unknown precision tier {tier!r} "
                     f"(vocabulary: parallel/planner.PRECISION_TIERS)")
