"""Conjugate gradient — the counterpart of ``matrel_tpu/workloads/cg.py``.

The JAX package compiles the whole solve into one ``lax.while_loop``
whose condition runs on the device. Here the loop is Python over device
tensors: each iteration is one matvec (any closure — a dense product, a
routed SpMV, the never-materialised Gram operator v ↦ Aᵀ(Av)) and a few
vector ops, launched without waiting. The stopping test ‖r‖ ≤ tol·‖b‖
needs ``rs`` on the host, so every iteration ends with one
device-to-host read of a scalar: the host waits for the iteration to
finish before it launches the next one. That read is the price of
stopping at the same iteration as the JAX package; ``chip_smoke.py``
measures what it costs against the iteration's device time.

``cg_solve`` takes a dense BlockMatrix / expression; ``cg_solve_linop``
takes any matvec closure.
"""

from __future__ import annotations

from typing import Callable, Tuple, Union

import numpy as np
import torch

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.ir import expr as E

Tensor = torch.Tensor

_TINY = 1e-30


def cg_step(matvec: Callable, state: tuple) -> tuple:
    """One CG iteration on ``state`` = (x, r, p, rs): the loop body of
    :func:`cg_runner`, launched without a host read."""
    x, r, p, rs = state
    ap = matvec(p)
    alpha = rs / torch.clamp(torch.dot(p, ap), min=_TINY)
    x = x + alpha * p
    r = r - alpha * ap
    rs_new = torch.dot(r, r)
    p = r + (rs_new / torch.clamp(rs, min=_TINY)) * p
    return x, r, p, rs_new


def cg_runner(matvec: Callable, tol: float = 1e-6,
              maxiter: int = 1000) -> Callable:
    """Reusable solver ``run(b) -> (x, iterations)`` for one SPD operator.
    ``b`` may be any float tensor shaped (n,) or (n, 1); x0 = 0. Stops at
    ‖r‖ ≤ tol·‖b‖ or after ``maxiter`` iterations, as the JAX package's
    ``while_loop`` does."""

    def run(b) -> Tuple[Tensor, int]:
        b = torch.as_tensor(b).float().reshape(-1)
        bnorm = max(float(torch.linalg.vector_norm(b)), _TINY)
        state = (torch.zeros_like(b), b, b, torch.dot(b, b))
        it = 0
        while it < maxiter and float(state[3]) ** 0.5 > tol * bnorm:
            state = cg_step(matvec, state)
            it += 1
        return state[0], it

    return run


def cg_solve_linop(matvec: Callable, b, tol: float = 1e-6,
                   maxiter: int = 1000) -> Tuple[Tensor, int]:
    """Solve A·x = b for SPD operator ``matvec``. Returns (x,
    iterations). Stops at ‖r‖ ≤ tol·‖b‖ or maxiter."""
    return cg_runner(matvec, tol, maxiter)(b)


def _padded_vector(v, n_pad: int, device) -> Tensor:
    """A host array or tensor as an f32 (n_pad,) tensor on ``device``,
    zero past its length."""
    v = (v.detach().float() if torch.is_tensor(v)
         else torch.as_tensor(np.asarray(v, np.float32)))
    v = v.reshape(-1).to(device)  # matlint: disable=ML008 the solve's right-hand side, placed once a solve on its device
    out = torch.zeros(n_pad, dtype=torch.float32, device=device)
    out[: v.shape[0]] = v
    return out


def _dense_op(data: Tensor) -> Callable:
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    _highest_precision()
    return lambda v: data @ v


def cg_solve(A: Union[BlockMatrix, E.MatExpr], b, tol: float = 1e-6,
             maxiter: int = 1000) -> Tuple[Tensor, int]:
    """CG on a dense SPD matrix (padded region is exactly zero, so the
    padded system decouples: padded residual entries stay 0)."""
    from matrel_tpu_torch.workloads.eigen import _dense_data
    e = E.as_expr(A)
    n, m = e.shape
    if n != m:
        raise ValueError(f"CG needs a square (SPD) matrix, got {e.shape}")
    data = _dense_data(A, e).float()
    bb = _padded_vector(b, data.shape[0], data.device)
    x, it = cg_solve_linop(_dense_op(data), bb, tol=tol, maxiter=maxiter)
    return x[:n], it


def cg_least_squares(X: Union[BlockMatrix, E.MatExpr], y, l2: float = 0.0,
                     tol: float = 1e-6,
                     maxiter: int = 1000) -> Tuple[Tensor, int]:
    """argmin ‖Xθ − y‖² (+ l2‖θ‖²) by CG on the NORMAL EQUATIONS
    operator v ↦ Xᵀ(Xv) + l2·v — the Gram matrix never materialises
    (two matvecs per iteration; the iterative face of linreg.fit)."""
    from matrel_tpu_torch.workloads.eigen import _dense_data
    e = E.as_expr(X)
    k = e.shape[1]
    data = _dense_data(X, e).float()
    yy = _padded_vector(y, data.shape[0], data.device)
    op = _dense_op(data)
    rhs = data.T @ yy

    def gram_op(v):
        return data.T @ op(v) + l2 * v

    theta, it = cg_solve_linop(gram_op, rhs, tol=tol, maxiter=maxiter)
    return theta[:k], it
