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
f32 (``_acc_dtype``; on a CUDA device on the tensor cores, as the MXU
runs them), integers accumulate in at least int32.
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
    # cuBLAS may otherwise reduce a split-K bf16 GEMM in bf16, which
    # breaks the f32-accumulate contract
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def local_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """One local product accumulated at ``_acc_dtype``.

    bf16 × bf16 on a CUDA device runs on the tensor cores with an f32
    result (bf16 in, f32 accumulate: the MXU's contract), the
    contraction in chunks summed in f32 (:func:`_tensor_core_dot`). On
    the CPU the bf16 operands are widened to f32 first, which computes
    the same function: a bf16×bf16 product is exact in f32. Integer
    products on a CUDA device (where torch has no integer GEMM) run in
    float64, exact while every partial sum stays below 2^53 — the int
    tiers' overflow proof bounds them by 2^31.
    """
    acc = _acc_dtype(a, b)
    if acc in _INTS:
        if a.is_cuda:
            return torch.matmul(a.double(), b.double()).round().to(acc)
        return torch.matmul(a.to(acc), b.to(acc))
    _highest_precision()
    if a.is_cuda and a.dtype == b.dtype == torch.bfloat16:
        return _tensor_core_dot(a, b)
    return torch.matmul(a.to(acc), b.to(acc))


#: Contraction length of one tensor-core product in ``local_dot``. The
#: bf16 MMA's f32 accumulation drifts toward zero over a long contraction
#: (each k-step's add truncates): row 3's Gram over 250,000-row panels
#: came out 2.9e-4 low and not positive definite in one GEMM on an H100,
#: against 3.8e-6 with chunks of 2048 summed in f32 (PERF.md).
TC_CHUNK = 2048
#: Most bytes of f32 chunk products held at once.
TC_PARTIAL_BYTES = 256 << 20


def _tensor_core_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """bf16 (m, K) × (K, n) → f32 on the tensor cores: the contraction in
    chunks of ``TC_CHUNK``, each a batch entry of one ``bmm`` over views
    of the operands, summed in f32."""
    m, k = a.shape
    n = b.shape[1]
    chunks = k // TC_CHUNK
    if chunks < 2:
        return torch.mm(a, b, out_dtype=torch.float32)
    group = max(1, TC_PARTIAL_BYTES // max(4 * m * n, 1))
    out = None
    for c0 in range(0, chunks, group):
        g = min(group, chunks - c0)
        s, e = c0 * TC_CHUNK, (c0 + g) * TC_CHUNK
        ac = a[:, s:e].reshape(m, g, TC_CHUNK).transpose(0, 1)
        bc = b[s:e].reshape(g, TC_CHUNK, n)
        p = torch.bmm(ac, bc, out_dtype=torch.float32).sum(0)
        out = p if out is None else out.add_(p)
    head = chunks * TC_CHUNK
    if head < k:
        out.add_(torch.mm(a[:, head:], b[head:], out_dtype=torch.float32))
    return out


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
