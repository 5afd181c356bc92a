"""Normal-equations linear regression — the counterpart of
``matrel_tpu/workloads/linreg.py`` (BASELINE row 3: tall-skinny
(XᵀX)⁻¹Xᵀy, 10M × 1k).

``fit`` builds the Gram matrix and the right-hand side through the IR
and :func:`executor.compile_exprs` (one plan, shared leaves), then solves
the k×k system by Cholesky on the device. ``fit_fused`` computes both
products and the solve directly (the JAX package's single-program form;
its sharding constraints have nothing to constrain on one card).
``fit_streaming`` sums XᵀX = Σ_p X_pᵀX_p over row panels that
``panel_fn(p)`` produces on the device, so X never exists whole; the
JAX package's jit cache has nothing to cache here and is not carried
over. :func:`hash_panel_fn` is ``bench_all.py``'s integer-hash panel
generator, bit for bit.

Precision follows ``matmul_precision``'s TPU meaning: "highest" is IEEE
f32 with TF32 off; "high" on f32 panels takes the symmetric 2-pass bf16
Gram (``ops/gram.py``) and the bf16x3 tier for the right-hand side;
"default" the one-pass bf16 tier.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.ir.expr import matmul, transpose

Tensor = torch.Tensor

_PRECISIONS = ("default", "high", "highest")


def normal_equations_expr(X: BlockMatrix, y: BlockMatrix):
    """The logical plan (XᵀX, Xᵀy) as IR expressions."""
    xe, ye = X.expr(), y.expr()
    return matmul(transpose(xe), xe), matmul(transpose(xe), ye)


def _cholesky_solve(gram: Tensor, rhs: Tensor, l2: float) -> Tensor:
    """Solve (gram + l2·I)·θ = rhs by Cholesky in f32, TF32 off. Gram
    matrices are SPD up to conditioning."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    _highest_precision()
    k = gram.shape[0]
    gl = gram.float() + l2 * torch.eye(k, dtype=torch.float32,
                                       device=gram.device)
    return torch.cholesky_solve(rhs.float(), torch.linalg.cholesky(gl))


def fit(X: BlockMatrix, y: BlockMatrix, l2: float = 0.0,
        config: Optional[MatrelConfig] = None) -> Tensor:
    """Solve argmin ‖Xθ - y‖² (+ l2‖θ‖²) by normal equations. Returns θ
    as a (k, 1) f32 tensor on X's device."""
    from matrel_tpu_torch.executor import compile_exprs
    cfg = config or default_config()
    gram_e, rhs_e = normal_equations_expr(X, y)
    gram, rhs = compile_exprs((gram_e, rhs_e), X.mesh, cfg).run()
    k = X.shape[1]
    return _cholesky_solve(gram.data[:k, :k], rhs.data[:k, :], l2)


def _gram_and_rhs(xp: Tensor, yp: Tensor,
                  precision: str) -> Tuple[Tensor, Tensor]:
    """(X_pᵀX_p, X_pᵀy_p) of one panel at ``precision``, f32."""
    from matrel_tpu_torch.ops.gram import symmetric_gram
    from matrel_tpu_torch.parallel import strategies
    cfg = default_config().replace(matmul_precision=precision)

    def mm(p, q):
        return strategies.run_matmul("xla", p, q, None, cfg).float()

    if precision == "high" and xp.dtype == torch.float32:
        # the cross terms of a Gram are transposes of each other: one
        # bf16 pass fewer than the generic 3-pass split (ops/gram.py)
        gram = symmetric_gram(
            xp, lambda p, q: strategies.local_dot(p.T, q).float())
    else:
        gram = mm(xp.T, xp)
    return gram, mm(xp.T, yp)


def fit_fused(X: BlockMatrix, y: BlockMatrix, l2: float = 0.0,
              config: Optional[MatrelConfig] = None) -> Tensor:
    """Gram, right-hand side and solve directly on the padded tensors at
    ``config.matmul_precision`` (no IR). Returns θ (k, 1)."""
    cfg = config or default_config()
    k = X.shape[1]
    gram, rhs = _gram_and_rhs(X.data, y.data, cfg.matmul_precision)
    return _cholesky_solve(gram[:k, :k], rhs[:k, :], l2)


def fit_streaming(n_rows: int, k: int, panel_fn: Callable,
                  panel_rows: int = 262_144, l2: float = 0.0, mesh=None,
                  dtype=None, precision: str = "highest",
                  config: Optional[MatrelConfig] = None) -> Tensor:
    """Tall-skinny normal equations when X exceeds device memory (BASELINE
    row 3: 10M×1k f32 = 40 GB).

    XᵀX = Σ_p X_pᵀX_p: panels come from ``panel_fn(p) -> (X_p, y_p)``
    for p in range(ceil(n_rows / panel_rows)) (a generator on the
    device, or slices of a resident X), and only the k×k and k×1 f32
    accumulators live across panels. ``precision`` is "highest" (IEEE
    f32, the safe default: cond(XᵀX) = cond(X)²), "high" (symmetric
    2-pass bf16 Gram) or "default". ``mesh``, ``dtype`` and ``config``
    are accepted for the JAX package's signature; one card needs none
    of them. Returns θ (k, 1)."""
    precision = precision.lower()
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be one of 'default', 'high', "
                         f"'highest'; got {precision!r}")
    n_panels = math.ceil(n_rows / panel_rows)
    gram = rhs = None
    for p in range(n_panels):
        xp, yp = panel_fn(p)
        g, r = _gram_and_rhs(xp, yp, precision)
        gram = g if gram is None else gram + g
        rhs = r if rhs is None else rhs + r
        del xp, yp, g, r
    if gram is None:
        raise ValueError(f"fit_streaming needs at least one panel, got "
                         f"n_rows={n_rows}")
    return _cholesky_solve(gram, rhs, l2)


def hash_panel_fn(panel_rows: int, k: int, device=None) -> Callable:
    """``bench_all.py``'s on-device panel generator (BASELINE row 3):
    panel p is X_p[r, c] = (s >> 8) · 2^-23 with s the int32 hash
    ``(r·1664525 + c·1013904223 + p·69069 + 12345)·1664525 + 1013904223``
    (wrapping), and y_p = X_p·1, so the planted θ is all ones. The hash
    runs in int64 masked to 32 bits and is reinterpreted as signed before
    the arithmetic shift, so it wraps as the JAX package's int32 does
    (signed overflow is undefined in C++). Values lie in [-1, 1)."""
    from matrel_tpu_torch.core.mesh import resolve_device
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    dev = resolve_device(device)
    mask = (1 << 32) - 1
    row = torch.arange(panel_rows, dtype=torch.int64, device=dev)[:, None]
    col = (torch.arange(k, dtype=torch.int64, device=dev)
           * 1013904223)[None, :]
    ones = torch.ones((k, 1), dtype=torch.float32, device=dev)

    def panel_fn(p: int) -> Tuple[Tensor, Tensor]:
        s = row * 1664525 + (p * 69069 + 12345) + col   # (panel, k) int64
        s.bitwise_and_(mask).mul_(1664525).add_(1013904223)
        s.bitwise_and_(mask).bitwise_xor_(1 << 31).sub_(1 << 31)
        xp = s.bitwise_right_shift_(8).to(torch.float32).mul_(2.0 ** -23)
        del s
        _highest_precision()
        return xp, xp @ ones

    return panel_fn


def predict(X: BlockMatrix, theta: Tensor) -> Tensor:
    """X·θ on the logical rows, (n, 1)."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    _highest_precision()
    xd = X.data
    t = torch.zeros((xd.shape[1], theta.shape[1]), dtype=xd.dtype,
                    device=xd.device)
    t[: theta.shape[0]] = theta.to(xd.dtype)
    return (xd @ t)[: X.shape[0]]
