"""Symmetric 2-pass bf16 Gram split — the counterpart of
``matrel_tpu/ops/gram.py``.

For f32 x split as x = hi + lo (bf16 each), the three products of the
bf16x3 scheme (hi·hi, hi·lo, lo·hi; lo·lo dropped) collapse in a Gram
to two passes plus a k×k transpose, because the cross terms are
transposes of each other: xᵀx ≈ hiᵀhi + hiᵀlo + (hiᵀlo)ᵀ.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch


def hi_lo_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 → (hi, lo) bf16 pair with x ≈ hi + lo."""
    hi = x.to(torch.bfloat16)
    lo = (x - hi.float()).to(torch.bfloat16)
    return hi, lo


def symmetric_gram(x: torch.Tensor,
                   mm: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
                   ) -> torch.Tensor:
    """The 2-pass symmetric Gram of f32 ``x``. ``mm(p, q)`` owns the
    orientation and must accumulate in f32; ``mm(hi, lo)`` must be the
    cross term whose transpose is the other cross term."""
    hi, lo = hi_lo_split(x)
    hihi = mm(hi, hi)
    hilo = mm(hi, lo)
    return hihi + hilo + hilo.T
