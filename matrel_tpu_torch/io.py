"""Matrix IO — the counterpart of ``matrel_tpu/io.py``, the ingestion
layer.

Formats:
  - .npy            dense, single file (numpy)
  - .mtx            MatrixMarket → BlockSparseMatrix or COOMatrix
  - .csv            "i,j[,value]" coordinate triples → dense or
                    block-sparse
  - tiled directory a directory of ``tile_R_C.npy`` files + meta.json,
                    the multi-file layout of a matrix produced shard-wise
                    (written and read with a thread pool)

Text is parsed by the native readers (``native/mtx_reader.cc`` through
``utils/native.py``) when they build; the MatrixMarket formats they
decline (complex field, a parse error) fall back to scipy, and CSV to
numpy (a dense "array" MatrixMarket file, which scipy reads as an
ndarray, included). Matrices land on the mesh's device (the card unless
the caller's mesh says otherwise).
"""

from __future__ import annotations

import json
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Tuple

import numpy as np

from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.core.sparse import BlockSparseMatrix
from matrel_tpu_torch.utils import native


def load_npy(path: str, mesh=None, config: Optional[MatrelConfig] = None
             ) -> BlockMatrix:
    return BlockMatrix.from_numpy(np.load(path), mesh=mesh, config=config)


def save_npy(path: str, m: BlockMatrix) -> None:
    np.save(path, m.to_numpy())


def load_mtx(path: str, mesh=None, block_size: Optional[int] = None,
             config: Optional[MatrelConfig] = None) -> BlockSparseMatrix:
    """MatrixMarket file → block-sparse (only touched tiles are
    materialised). Native parse when built, scipy for the rest; both
    keep float64 until the configured dtype cast, so they give the same
    matrix."""
    parsed = native.mtx_read(path)
    if parsed is not None:
        shape, rows, cols, vals = parsed
        return BlockSparseMatrix.from_coo_arrays(
            rows, cols, vals, shape, block_size=block_size, mesh=mesh,
            config=config)
    import scipy.io
    import scipy.sparse as sps
    coo = sps.coo_matrix(scipy.io.mmread(path))  # an ndarray for "array"
    return BlockSparseMatrix.from_coo_arrays(
        coo.row, coo.col, coo.data, coo.shape, block_size=block_size,
        mesh=mesh, config=config)


def load_mtx_coo(path: str):
    """MatrixMarket file → element-sparse ``COOMatrix``: the loader for
    graph-shaped sparsity that would touch every tile."""
    from matrel_tpu_torch.core.coo import COOMatrix
    parsed = native.mtx_read(path)
    if parsed is not None:
        shape, rows, cols, vals = parsed
        return COOMatrix.from_edges(rows, cols, vals.astype(np.float32),
                                    shape=shape)
    import scipy.io
    import scipy.sparse as sps
    return COOMatrix.from_scipy(sps.coo_matrix(scipy.io.mmread(path)))


def read_edges_csv(path: str):
    """Raw 'i,j[,value]' triples → (rows, cols, vals) host arrays; the
    value column defaults to 1.0."""
    parsed = native.coo_csv_read(path)
    if parsed is not None:
        rows, cols, v64 = parsed
        return rows, cols, v64.astype(np.float32)
    data = np.loadtxt(path, delimiter=",", ndmin=2)
    rows = data[:, 0].astype(np.int64)
    cols = data[:, 1].astype(np.int64)
    vals = (data[:, 2].astype(np.float32) if data.shape[1] > 2
            else np.ones(len(rows), np.float32))
    return rows, cols, vals


def load_coo_csv(path: str, shape: Tuple[int, int], mesh=None,
                 block_size: Optional[int] = None, dense: bool = False,
                 config: Optional[MatrelConfig] = None):
    """'i,j,value' triples → a dense BlockMatrix (``dense=True``) or a
    BlockSparseMatrix; duplicate coordinates accumulate."""
    rows, cols, vals = read_edges_csv(path)
    if dense:
        out = np.zeros(shape, dtype=np.float32)
        np.add.at(out, (rows, cols), vals)
        return BlockMatrix.from_numpy(out, mesh=mesh, config=config,
                                      nnz=len(vals))
    return BlockSparseMatrix.from_coo_arrays(
        rows, cols, vals, shape, block_size=block_size, mesh=mesh,
        config=config)


# -- tiled directory format -------------------------------------------------


def save_tiled(directory: str, m: BlockMatrix, tile: int = 4096,
               workers: int = 8) -> None:
    """Write a matrix as tile_R_C.npy part-files + meta.json."""
    os.makedirs(directory, exist_ok=True)
    host = m.to_numpy()
    n, mm = host.shape
    gr, gc = math.ceil(n / tile), math.ceil(mm / tile)

    def write(rc):
        r, c = rc
        part = host[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile]
        np.save(os.path.join(directory, f"tile_{r}_{c}.npy"), part)

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(write, [(r, c) for r in range(gr) for c in range(gc)]))
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump({"shape": [n, mm], "tile": tile, "grid": [gr, gc],
                   "dtype": str(host.dtype)}, f)


def load_tiled(directory: str, mesh=None,
               config: Optional[MatrelConfig] = None,
               workers: int = 8) -> BlockMatrix:
    with open(os.path.join(directory, "meta.json")) as f:
        meta = json.load(f)
    n, mm = meta["shape"]
    tile = meta["tile"]
    gr, gc = meta["grid"]
    out = np.zeros((n, mm), dtype=meta.get("dtype", "float32"))

    def read(rc):
        r, c = rc
        part = np.load(os.path.join(directory, f"tile_{r}_{c}.npy"))
        out[r * tile:r * tile + part.shape[0],
            c * tile:c * tile + part.shape[1]] = part

    with ThreadPoolExecutor(max_workers=workers) as ex:
        list(ex.map(read, [(r, c) for r in range(gr) for c in range(gc)]))
    return BlockMatrix.from_numpy(out, mesh=mesh, config=config)
