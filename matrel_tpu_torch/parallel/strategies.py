"""Physical matmul strategies — the counterpart of
``matrel_tpu/parallel/strategies.py``.

The JAX package runs each strategy (bmm_left/bmm_right/cpmm/rmm/summa/
xla) as a ``shard_map`` collective recipe over the TPU mesh. This
package executes on one card, where every strategy is the same local
product: the stamp is kept (it is what the planner chose on the grid),
the computation is one matmul. Multi-rank recipes over
``torch.distributed`` come in a later slice.

Numerics follow the JAX package's ``Precision.HIGHEST``: float32
products run in IEEE f32 with TF32 off, bf16 operands accumulate in
f32 (``_acc_dtype``), integers accumulate in at least int32.
"""

from __future__ import annotations

from typing import Optional

import torch

from matrel_tpu_torch.config import MatrelConfig, default_config

STRATEGIES = ("bmm_left", "bmm_right", "cpmm", "rmm", "summa", "xla")

_INTS = (torch.int8, torch.int16, torch.int32, torch.int64, torch.uint8)


def _acc_dtype(a: torch.Tensor, b: torch.Tensor) -> torch.dtype:
    # accumulate bf16 inputs in f32
    if a.dtype == torch.bfloat16 or b.dtype == torch.bfloat16:
        return torch.float32
    # integer inputs accumulate at least int32 (an int8 accumulator
    # would wrap on the first k>1 contraction)
    if a.dtype in _INTS and b.dtype in _INTS:
        return torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                                   torch.int32)
    return torch.promote_types(a.dtype, b.dtype)


def _highest_precision() -> None:
    """Full-f32 products: the counterpart of ``Precision.HIGHEST``. TF32
    keeps about three decimal digits, a different algorithm."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def local_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One local product accumulated at ``_acc_dtype``.

    bf16 operands are widened to f32 before the product: a bf16×bf16
    product is exact in f32, so this is the MXU's bf16-in / f32-acc
    contract. Integer products on a CUDA device (where torch has no
    integer GEMM) run in float64, exact while every partial sum stays
    below 2^53 — the int tiers' overflow proof bounds them by 2^31.
    """
    acc = _acc_dtype(a, b)
    if acc in _INTS:
        if a.is_cuda:
            return torch.matmul(a.double(), b.double()).round().to(acc)
        return torch.matmul(a.to(acc), b.to(acc))
    _highest_precision()
    return torch.matmul(a.to(acc), b.to(acc))


#: ``config.matmul_precision`` below "highest" keeps its TPU meaning:
#: the bf16 passes of XLA's DEFAULT / HIGH dot precision.
_PRECISION_TIER = {"default": "bf16x1", "high": "bf16x3"}


def run_matmul(strategy: str, a: torch.Tensor, b: torch.Tensor, mesh,
               config: Optional[MatrelConfig] = None,
               epilogue=None) -> torch.Tensor:
    """The stamped strategy's product on one device. ``epilogue`` is
    applied to the output (the JAX package's fused-region slot, used
    here for the ``keep_input_dtype`` storage cast)."""
    if strategy not in STRATEGIES:
        raise ValueError(f"unknown strategy {strategy!r}")
    cfg = config or default_config()
    tier = _PRECISION_TIER.get(cfg.matmul_precision)
    if tier is not None and a.dtype == b.dtype == torch.float32:
        from matrel_tpu_torch.ops.precision import tiered_matmul
        out = tiered_matmul(tier, a, b, local_dot)
    else:
        out = local_dot(a, b)
    return out if epilogue is None else epilogue(out)
