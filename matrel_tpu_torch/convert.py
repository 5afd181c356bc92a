"""Carry matrices across from the JAX package, as numpy arrays.

The JAX package's objects are handed over as plain arrays and metadata
(``np.asarray(M.data)``, ``M.shape``, ``M.block_size``, …), never as
JAX objects: this package imports neither ``jax`` nor ``matrel_tpu``.
The tests use these functions so both packages compute on identical
data; bfloat16 payloads arrive bit for bit.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np

from matrel_tpu_torch.core.blockmatrix import (
    BlockMatrix, as_torch_dtype, tensor_from_numpy)
from matrel_tpu_torch.core import padding
from matrel_tpu_torch.core.mesh import Mesh, P
from matrel_tpu_torch.core.sparse import BlockSparseMatrix


def block_matrix(data: np.ndarray, shape: Tuple[int, int], block_size: int,
                 mesh: Mesh, spec: Optional[Sequence] = None,
                 nnz: Optional[int] = None, integral: bool = False,
                 int_abs_max: Optional[float] = None,
                 dtype: Any = None) -> BlockMatrix:
    """A BlockMatrix from a JAX-side padded array and its metadata. The
    array is re-padded to this mesh's padded shape (zeros outside the
    logical region, as both packages keep them)."""
    data = np.asarray(data)
    dtype = as_torch_dtype(dtype if dtype is not None else data.dtype)
    n, m = shape
    pshape = padding.padded_shape((n, m), mesh)
    logical = tensor_from_numpy(data[:n, :m], dtype, mesh.device)
    t = logical.new_zeros(pshape)
    t[:n, :m] = logical
    spec = P(*spec) if spec is not None else padding.canonical_spec(pshape,
                                                                    mesh)
    return BlockMatrix(data=t, shape=(int(n), int(m)), mesh=mesh, spec=spec,
                       nnz=nnz, block_size=int(block_size),
                       integral=bool(integral), int_abs_max=int_abs_max)


def block_sparse(blocks: np.ndarray, block_rows: np.ndarray,
                 block_cols: np.ndarray, shape: Tuple[int, int],
                 block_size: int, mesh: Mesh,
                 dtype: Any = None) -> BlockSparseMatrix:
    """A BlockSparseMatrix from a JAX-side tile stack and its tile
    coordinates (kept in the order given)."""
    import torch
    blocks = np.asarray(blocks)
    dtype = as_torch_dtype(dtype if dtype is not None else blocks.dtype)
    dev = mesh.device
    S = BlockSparseMatrix(
        blocks=tensor_from_numpy(blocks, dtype, dev),
        block_rows=torch.as_tensor(np.array(block_rows, np.int32),
                                   device=dev),
        block_cols=torch.as_tensor(np.array(block_cols, np.int32),
                                   device=dev),
        shape=(int(shape[0]), int(shape[1])), block_size=int(block_size),
        mesh=mesh)
    S._seed_host_tiles(np.asarray(block_rows), np.asarray(block_cols))
    return S


def coo_from_arrays(rows: np.ndarray, cols: np.ndarray, vals: np.ndarray,
                    shape: Tuple[int, int]):
    """A COOMatrix from a JAX-side edge list (kept in the order given, so
    both packages build their plans from the same input order)."""
    from matrel_tpu_torch.core.coo import COOMatrix
    return COOMatrix.from_edges(np.asarray(rows), np.asarray(cols),
                                np.asarray(vals), shape=tuple(shape))


def spmv_plan_from_arrays(n_rows: int, n_cols: int, block: int,
                          capacity: int, src8: np.ndarray, lane: np.ndarray,
                          off: np.ndarray, val: np.ndarray,
                          ov_cols: Optional[np.ndarray] = None,
                          ov_rows: Optional[np.ndarray] = None,
                          ov_vals: Optional[np.ndarray] = None,
                          padding_ratio: float = 0.0):
    """An EdgeSpMVPlan from a JAX plan's compact tables and overflow COO
    as numpy arrays, so both packages run on identical tables."""
    from matrel_tpu_torch.ops.spmv import EdgeSpMVPlan

    def opt(a, dtype):
        return None if a is None else np.ascontiguousarray(a, dtype)

    return EdgeSpMVPlan(
        n_rows=int(n_rows), n_cols=int(n_cols), block=int(block),
        capacity=int(capacity),
        src8=np.ascontiguousarray(src8, np.int32),
        lane=np.ascontiguousarray(lane, np.int8),
        off=np.ascontiguousarray(off, np.int32),
        val=np.ascontiguousarray(val, np.float32),
        ov_cols=opt(ov_cols, np.int32), ov_rows=opt(ov_rows, np.int32),
        ov_vals=opt(ov_vals, np.float32),
        padding_ratio=float(padding_ratio))


def routed_plan_from_arrays(n_rows: int, n_cols: int, g_src: int,
                            g_dst: int, cap: int, loc_src: np.ndarray,
                            loc_dst: np.ndarray, val: np.ndarray,
                            ov_rows: Optional[np.ndarray] = None,
                            ov_cols: Optional[np.ndarray] = None,
                            ov_vals: Optional[np.ndarray] = None,
                            padding_ratio: float = 0.0):
    """A RoutedSpMVPlan from a JAX routed plan's tables (any layout that
    reshapes to (g_src, g_dst, cap), the TPU tile layout included) and
    overflow COO as numpy arrays, so both packages run on identical
    tables."""
    from matrel_tpu_torch.ops.spmv_routed import RoutedSpMVPlan
    shp = (int(g_src), int(g_dst), int(cap))

    def table(a, dtype):
        return np.array(a, dtype).reshape(shp)      # a writable copy

    def opt(a, dtype):
        return None if a is None else np.array(a, dtype)

    return RoutedSpMVPlan(
        n_rows=int(n_rows), n_cols=int(n_cols), g_src=shp[0], g_dst=shp[1],
        cap=shp[2], loc_src=table(loc_src, np.int32),
        loc_dst=table(loc_dst, np.int32), val=table(val, np.float32),
        ov_rows=opt(ov_rows, np.int32), ov_cols=opt(ov_cols, np.int32),
        ov_vals=opt(ov_vals, np.float32),
        padding_ratio=float(padding_ratio))


def from_reference(m, mesh: Mesh):
    """Duck-typed carry-over of one JAX-package matrix object: anything
    with ``blocks``/``block_rows``/``block_cols`` becomes a
    BlockSparseMatrix, an edge list (``rows``/``cols``/``vals``) a
    COOMatrix, anything with ``data``/``spec`` a BlockMatrix. Only
    attributes are read, through ``np.asarray``."""
    if hasattr(m, "vals") and hasattr(m, "rows"):
        return coo_from_arrays(m.rows, m.cols, m.vals, m.shape)
    if hasattr(m, "blocks"):
        return block_sparse(np.asarray(m.blocks), np.asarray(m.block_rows),
                            np.asarray(m.block_cols), m.shape,
                            m.block_size, mesh)
    spec = tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in m.spec)
    return block_matrix(np.asarray(m.data), m.shape, m.block_size, mesh,
                        spec=spec, nnz=m.nnz,
                        integral=getattr(m, "integral", False),
                        int_abs_max=getattr(m, "int_abs_max", None))
