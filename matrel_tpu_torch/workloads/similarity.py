"""Cosine-similarity matrix — the counterpart of
``matrel_tpu/workloads/similarity.py``, the all-pairs row-similarity
query:

    S = D⁻¹ · (X·Xᵀ) · D⁻¹,   D = diag(‖x_i‖₂)

The X·Xᵀ core is a Gram, so under ``matmul_precision="high"`` the
executor's symmetric two-pass bf16 split (``ops/gram.py``) applies. The
normalisation is masking-safe elementwise math on the query surface;
thresholded similarity joins compose via ``select_value`` on the result.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.ir import expr as E


def cosine_similarity_expr(X: Union[BlockMatrix, E.MatExpr]) -> E.MatExpr:
    """Lazy S[i,j] = cos(x_i, x_j) as G / (n·nᵀ), G = X·Xᵀ and
    n = sqrt(rowSum(X∘X)): one Gram multiply, one rank-1-shaped
    denominator, one elementwise divide."""
    x = E.as_expr(X)
    g = x.multiply(x.t())                        # X·Xᵀ — the Gram path
    sq = E.agg(E.elemwise("mul", x, x), "sum", "row")   # (n, 1) ‖x‖²
    norms = sq.power(0.5)
    denom = norms.multiply(norms.t())            # ‖x_i‖·‖x_j‖ outer
    return E.elemwise("div", g, denom)


def cosine_similarity(X: Union[BlockMatrix, E.MatExpr],
                      session=None) -> np.ndarray:
    return cosine_similarity_expr(X).compute(session).to_numpy()


def cosine_similarity_numpy_oracle(x: np.ndarray) -> np.ndarray:
    n = np.linalg.norm(x, axis=1, keepdims=True)
    return (x @ x.T) / (n @ n.T)
