"""Power iteration — dominant eigenpair and spectral norm; the
counterpart of ``matrel_tpu/workloads/eigen.py``.

The JAX package jits each loop as one ``fori_loop`` program. Here the
rounds are a Python loop of eager torch ops with no host read between
rounds (the round count is fixed), so the host only launches.

``spectral_norm`` iterates on AᵀA (‖A‖₂² = λ_max(AᵀA)) without forming
AᵀA: each step multiplies by A then Aᵀ. ``power_iteration_coo`` runs one
planned SpMV a round through the expanded-table executor
(``ops/spmv.spmv_apply``, as the JAX package does) and falls back to the
dense path when the plan build refuses the graph.

The start vector is drawn from a ``torch.Generator`` seeded with
``seed``; it is not the JAX package's ``jax.random`` vector, so the two
agree on the converged pair, not on the iterates.
"""

from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.ir import expr as E

Tensor = torch.Tensor

_TINY = 1e-30


def _start_vector(n: int, seed: int, device) -> Tensor:
    gen = torch.Generator(device=device).manual_seed(seed)
    v0 = torch.randn(n, generator=gen, device=device, dtype=torch.float32)
    return v0 / torch.linalg.vector_norm(v0)


def _normalised(w: Tensor) -> Tensor:
    return w / torch.clamp(torch.linalg.vector_norm(w), min=_TINY)


def power_iteration(A: Union[BlockMatrix, E.MatExpr], rounds: int = 50,
                    seed: int = 0) -> Tuple[float, Tensor]:
    """(dominant eigenvalue, eigenvector) of square A by power
    iteration: v ← A·v / ‖A·v‖, λ = vᵀ·A·v. Converges to the
    eigenvalue of largest MAGNITUDE (gap-dependent rate)."""
    e = E.as_expr(A)
    n, m = e.shape
    if n != m:
        raise ValueError(f"power iteration needs a square matrix, got "
                         f"{e.shape}")
    data = _dense_data(A, e).float()
    lam, v = power_runner(rounds, seed)(data)
    return float(lam), v[:n]


def power_runner(rounds: int = 50, seed: int = 0):
    """Reusable power iteration ``run(mat) -> (lam, v)`` over a square
    tensor."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision

    def run(mat: Tensor):
        _highest_precision()
        v = _start_vector(mat.shape[0], seed, mat.device)
        for _ in range(rounds):
            v = _normalised(mat @ v)
        return torch.dot(v, mat @ v), v

    return run


def spectral_norm(A: Union[BlockMatrix, E.MatExpr], rounds: int = 50,
                  seed: int = 0) -> float:
    """‖A‖₂ = sqrt(λ_max(AᵀA)) by power iteration on the Gram operator,
    applied as two matvecs per step (AᵀA never materialises)."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    _highest_precision()
    e = E.as_expr(A)
    mat = _dense_data(A, e).float()
    v = _start_vector(mat.shape[1], seed, mat.device)
    for _ in range(rounds):
        v = _normalised(mat.T @ (mat @ v))
    # padded rows/cols are exactly zero and do not affect σ_max
    return float(torch.linalg.vector_norm(mat @ v))


def _dense_data(A, e: E.MatExpr) -> Tensor:
    """Padded device tensor of a dense operand (leaf matrices directly;
    expressions via one compile+run)."""
    if isinstance(A, BlockMatrix):
        return A.data
    if e.kind == "leaf":
        return e.attrs["matrix"].data
    from matrel_tpu_torch.executor import execute
    return execute(e).data


def power_iteration_coo(A, rounds: int = 50, seed: int = 0,
                        device=None) -> Tuple[float, Tensor]:
    """Power iteration on an element-sparse ``COOMatrix`` via its SpMV
    plan: every round is one planned SpMV over the expanded tables on
    ``device`` (default: the card). Graphs the plan refuses (heavy
    tails) fall back to the dense path."""
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch.ops import spmv as spmv_lib

    if A.shape[0] != A.shape[1]:
        raise ValueError(f"power iteration needs a square matrix, got "
                         f"{A.shape}")
    mesh = make_mesh(device=device)
    plan = A._get_plan()
    if plan is None:          # heavy-tailed graph: plan refused
        return power_iteration(
            E.as_expr(BlockMatrix.from_numpy(A.to_dense(), mesh=mesh)),
            rounds, seed)
    static = (plan.n_rows, plan.n_cols, plan.block)
    arrays = plan.arrays(mesh.device)
    v = _start_vector(plan.n_cols, seed, mesh.device)
    for _ in range(rounds):
        v = _normalised(spmv_lib.spmv_apply(static, arrays, v))
    lam = torch.dot(v, spmv_lib.spmv_apply(static, arrays, v))
    return float(lam), v[: A.shape[0]]


def eig_numpy_oracle(a: np.ndarray) -> float:
    """|λ|_max for tests (dense numpy)."""
    return float(np.max(np.abs(np.linalg.eigvals(a))))
