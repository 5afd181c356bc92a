"""Triangle counting — the counterpart of
``matrel_tpu/workloads/triangles.py``: the number of triangles in an
undirected graph is trace(A³)/6, written through the query surface:

  - the chain A·A·A goes through the chain DP (all dims equal: a tie),
  - trace(·) is the γ(sum, diag) aggregate, which rule R3 pushes into
    the final multiply,
  - a sparse adjacency enters as a block-sparse or COO leaf and routes
    through its kernels (block-sparse × block-sparse: the S×S registry).

SQL computes the same plan: ``trace(A * A * A)`` over a registered
adjacency table.
"""

from __future__ import annotations

from typing import Union

import numpy as np

from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.ir import expr as E


def triangle_count_expr(A: Union[BlockMatrix, E.MatExpr]) -> E.MatExpr:
    """trace(A·A·A) as a lazy expression; divide by 6 on the scalar
    result for the triangle count of a simple undirected graph."""
    a = E.as_expr(A)
    if a.shape[0] != a.shape[1]:
        raise ValueError(f"adjacency must be square, got {a.shape}")
    return E.agg(a.multiply(a).multiply(a), "sum", "diag")


def triangle_count(A: Union[BlockMatrix, E.MatExpr], session=None) -> float:
    """Number of triangles in the simple undirected graph with 0/1
    symmetric adjacency ``A`` (zero diagonal)."""
    out = triangle_count_expr(A).compute(session).to_numpy()
    return float(out[0, 0]) / 6.0


def triangles_numpy_oracle(a: np.ndarray) -> float:
    """Dense numpy oracle for tests."""
    return float(np.trace(a @ a @ a)) / 6.0
