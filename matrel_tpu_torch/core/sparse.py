"""BlockSparseMatrix — the counterpart of ``matrel_tpu/core/sparse.py``.

A block-sparse matrix keeps only its nonzero ``block_size × block_size``
tiles, as a dense stack on the device:

    blocks:     f32/bf16 [nnzb, bs, bs]   — the tile payloads
    block_rows: int32 [nnzb]              — tile row index  (sorted)
    block_cols: int32 [nnzb]              — tile col index

SpMM against a dense BlockMatrix runs through ``ops/spmm.py``: the
hand-written CUDA kernel (``ops/pallas_spmm.py``) for CUDA tensors, its
plain PyTorch version on the CPU.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.core import mesh as mesh_lib, padding
from matrel_tpu_torch.core.blockmatrix import (
    as_torch_dtype, tensor_from_numpy, tensor_to_numpy)
from matrel_tpu_torch.core.mesh import Mesh


@dataclasses.dataclass
class BlockSparseMatrix:
    """Block-sparse matrix with dense tile payloads (whole on the
    mesh's device — the broadcast operand of a BMM-style SpMM)."""

    blocks: torch.Tensor       # [nnzb, bs, bs]
    block_rows: torch.Tensor   # [nnzb] int32, sorted (row-major order)
    block_cols: torch.Tensor   # [nnzb] int32
    shape: Tuple[int, int]
    block_size: int
    mesh: Mesh

    @property
    def nnzb(self) -> int:
        return self.blocks.shape[0]

    @property
    def grid(self) -> Tuple[int, int]:
        bs = self.block_size
        return (math.ceil(self.shape[0] / bs), math.ceil(self.shape[1] / bs))

    @property
    def nnz(self) -> int:
        """Upper-bound structural nnz (block granular)."""
        return self.nnzb * self.block_size * self.block_size

    @property
    def density(self) -> float:
        gr, gc = self.grid
        return self.nnzb / (gr * gc) if gr * gc else 0.0

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks.dtype

    def host_tiles(self) -> Tuple[np.ndarray, np.ndarray]:
        """(block_rows, block_cols) as host int64 arrays, memoised on the
        matrix against the two index tensors: the S×S structure work
        (pair lists, classifiers) reads this, never a device copy per
        query. Constructors that start from host arrays seed it."""
        memo = getattr(self, "_host_tiles_memo", None)
        if (memo is None or memo[0] is not self.block_rows
                or memo[1] is not self.block_cols):
            memo = self._seed_host_tiles(self.block_rows.cpu().numpy(),
                                         self.block_cols.cpu().numpy())
        return memo[2], memo[3]

    def _seed_host_tiles(self, rows, cols):
        memo = (self.block_rows, self.block_cols,
                np.asarray(rows, np.int64), np.asarray(cols, np.int64))
        self._host_tiles_memo = memo
        return memo

    # -- construction -------------------------------------------------------

    @classmethod
    def _from_host_tiles(cls, payload, rows, cols, shape, bs, mesh,
                         dtype) -> "BlockSparseMatrix":
        dev = mesh.device
        S = cls(
            blocks=tensor_from_numpy(payload, dtype, dev),
            block_rows=torch.as_tensor(np.asarray(rows, np.int32),
                                       device=dev),
            block_cols=torch.as_tensor(np.asarray(cols, np.int32),
                                       device=dev),
            shape=(int(shape[0]), int(shape[1])), block_size=bs, mesh=mesh)
        S._seed_host_tiles(rows, cols)
        return S

    @classmethod
    def from_numpy(cls, arr: np.ndarray, block_size: Optional[int] = None,
                   mesh: Optional[Mesh] = None,
                   config: Optional[MatrelConfig] = None,
                   dtype: Any = None) -> "BlockSparseMatrix":
        """Keep only tiles containing at least one nonzero."""
        cfg = config or default_config()
        bs = block_size or cfg.block_size
        mesh = mesh or mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        dtype = as_torch_dtype(dtype or cfg.default_dtype)
        arr = np.asarray(arr)
        n, m = arr.shape
        gr, gc = math.ceil(n / bs), math.ceil(m / bs)
        padded = np.zeros((gr * bs, gc * bs), dtype=np.float64)
        padded[:n, :m] = arr
        tiles = padded.reshape(gr, bs, gc, bs).transpose(0, 2, 1, 3)
        nz = np.argwhere(np.abs(tiles).sum(axis=(2, 3)) > 0)
        if len(nz) == 0:
            nz = np.zeros((1, 2), dtype=np.int64)  # keep one zero tile
        order = np.lexsort((nz[:, 1], nz[:, 0]))   # row-major sort
        nz = nz[order]
        payload = tiles[nz[:, 0], nz[:, 1]]
        if arr.dtype.name == "bfloat16":
            payload = payload.astype(np.float32)
        return cls._from_host_tiles(payload, nz[:, 0], nz[:, 1], (n, m),
                                    bs, mesh, dtype)

    @classmethod
    def from_scipy(cls, sp, block_size: Optional[int] = None,
                   mesh: Optional[Mesh] = None,
                   config: Optional[MatrelConfig] = None,
                   dtype: Any = None) -> "BlockSparseMatrix":
        """From a scipy.sparse matrix: the element-sparse input is
        bucketed into block-granular payloads without densifying the
        whole matrix (only touched tiles are materialised)."""
        coo = sp.tocoo()
        return cls.from_coo_arrays(coo.row, coo.col, coo.data, coo.shape,
                                   block_size=block_size, mesh=mesh,
                                   config=config, dtype=dtype)

    @classmethod
    def from_coo_arrays(cls, rows, cols, vals, shape: Tuple[int, int],
                        block_size: Optional[int] = None,
                        mesh: Optional[Mesh] = None,
                        config: Optional[MatrelConfig] = None,
                        dtype: Any = None) -> "BlockSparseMatrix":
        """From raw COO coordinate arrays: only touched tiles are
        materialised, the full matrix never is. Duplicate coordinates
        accumulate (scipy COO semantics)."""
        cfg = config or default_config()
        bs = block_size or cfg.block_size
        mesh = mesh or mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        dtype = as_torch_dtype(dtype or cfg.default_dtype)
        rows = np.asarray(rows, np.int64).ravel()
        cols = np.asarray(cols, np.int64).ravel()
        vals = np.asarray(vals, np.float64).ravel()
        n, m = shape
        gc = math.ceil(m / bs)
        keys = (rows // bs) * gc + cols // bs
        uniq, tile_idx = np.unique(keys, return_inverse=True)
        payload = np.zeros((max(len(uniq), 1), bs, bs), dtype=np.float64)
        np.add.at(payload, (tile_idx.ravel(), rows % bs, cols % bs), vals)
        trows, tcols = uniq // gc, uniq % gc
        if len(uniq) == 0:
            trows = tcols = np.zeros(1, np.int64)
        return cls._from_host_tiles(payload, trows, tcols, (n, m), bs,
                                    mesh, dtype)

    @classmethod
    def random(cls, shape: Tuple[int, int], block_density: float,
               block_size: Optional[int] = None, mesh: Optional[Mesh] = None,
               seed: int = 0, config: Optional[MatrelConfig] = None,
               dtype: Any = None) -> "BlockSparseMatrix":
        """Random block-sparse matrix: a uniform sample of nonzero tiles
        (the same numpy tile sample as the JAX package for a seed)
        filled with uniform [0,1) values made on the device from a
        seeded ``torch.Generator``."""
        cfg = config or default_config()
        bs = block_size or cfg.block_size
        mesh = mesh or mesh_lib.make_mesh(cfg.mesh_shape, cfg.mesh_axis_names)
        dtype = as_torch_dtype(dtype or cfg.default_dtype)
        n, m = shape
        gr, gc = math.ceil(n / bs), math.ceil(m / bs)
        rng = np.random.default_rng(seed)
        total = gr * gc
        nnzb = max(1, int(round(total * block_density)))
        flat = rng.choice(total, size=nnzb, replace=False)
        flat.sort()
        dev = mesh.device
        gen = torch.Generator(device=dev).manual_seed(seed)
        vals = torch.rand((nnzb, bs, bs), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        rows, cols = flat // gc, flat % gc
        S = cls(blocks=vals,
                block_rows=torch.as_tensor(rows.astype(np.int32), device=dev),
                block_cols=torch.as_tensor(cols.astype(np.int32), device=dev),
                shape=(int(n), int(m)), block_size=bs, mesh=mesh)
        S._seed_host_tiles(rows, cols)
        return S

    # -- materialisation ----------------------------------------------------

    def _dense_tiles(self) -> torch.Tensor:
        """The (gr·bs, gc·bs) dense tile grid on the device."""
        gr, gc = self.grid
        bs = self.block_size
        full = torch.zeros((gr, gc, bs, bs), dtype=self.dtype,
                           device=self.blocks.device)
        full[self.block_rows.long(), self.block_cols.long()] = self.blocks
        return full.permute(0, 2, 1, 3).reshape(gr * bs, gc * bs)

    def to_numpy(self) -> np.ndarray:
        return tensor_to_numpy(
            self._dense_tiles()[: self.shape[0], : self.shape[1]])

    def to_dense(self, config: Optional[MatrelConfig] = None):
        """Scatter tiles into a dense BlockMatrix on the device."""
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix
        pshape = padding.padded_shape(self.shape, self.mesh)
        n, m = self.shape
        data = torch.zeros(pshape, dtype=self.dtype,
                           device=self.blocks.device)
        data[:n, :m] = self._dense_tiles()[:n, :m]
        spec = padding.canonical_spec(pshape, self.mesh)
        return BlockMatrix.from_array(
            BlockMatrix._place(data, self.mesh, spec), self.shape,
            self.mesh, spec,
            nnz=min(self.nnz, n * m), block_size=self.block_size)

    def transpose(self) -> "BlockSparseMatrix":
        """Sᵀ: swap tile coordinates and transpose payloads (one device
        copy); re-sorted row-major to keep the kernel invariants."""
        cols, rows = self.host_tiles()
        order = np.lexsort((cols, rows))
        dev = self.blocks.device
        idx = torch.as_tensor(order, device=dev)
        St = BlockSparseMatrix(
            blocks=self.blocks.transpose(1, 2)[idx].contiguous(),
            block_rows=torch.as_tensor(rows[order].astype(np.int32),
                                       device=dev),
            block_cols=torch.as_tensor(cols[order].astype(np.int32),
                                       device=dev),
            shape=(self.shape[1], self.shape[0]),
            block_size=self.block_size, mesh=self.mesh)
        St._seed_host_tiles(rows[order], cols[order])
        return St

    def norm(self, kind: str = "fro") -> float:
        """Matrix norm from the tile stack (tiles are unique by
        construction; zeros outside kept tiles contribute nothing),
        summed in float64 on the device."""
        b = self.blocks.double()
        if kind == "fro":
            return float(torch.sqrt((b * b).sum()))
        if kind == "l1":
            return float(b.abs().sum())
        if kind == "max":
            return float(b.abs().max()) if self.nnzb else 0.0
        raise ValueError(f"unknown norm kind {kind!r} "
                         "(expected 'fro', 'l1', or 'max')")

    # -- lazy DSL -----------------------------------------------------------

    def shard(self, mesh: Optional[Mesh] = None):
        """Distribute the tile stack over a rank mesh (each rank holds
        ~nnzb/P tiles in its output row range) — the scale-out SpMM
        plan; see ``ops/spmm_sharded.py``."""
        from matrel_tpu_torch.ops.spmm_sharded import shard_block_sparse
        return shard_block_sparse(self, mesh)

    def expr(self):
        from matrel_tpu_torch.ir import expr as E
        return E.MatExpr("sparse_leaf", (), tuple(self.shape),
                         min(self.nnz, self.shape[0] * self.shape[1]),
                         {"matrix": self})

    def multiply(self, other):
        from matrel_tpu_torch.ir import expr as E
        return E.matmul(self.expr(), E.as_expr(other))

    def __repr__(self):
        return (f"BlockSparseMatrix(shape={self.shape}, bs={self.block_size}, "
                f"nnzb={self.nnzb}/{self.grid[0] * self.grid[1]})")
