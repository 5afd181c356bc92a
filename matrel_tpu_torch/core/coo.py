"""Element-sparse COO matrix — the counterpart of
``matrel_tpu/core/coo.py``.

A fixed edge list (host numpy) compiled once into an
:class:`~matrel_tpu_torch.ops.spmv.EdgeSpMVPlan`; transpose plans are
built lazily, and a plain ``index_add_`` segment sum covers degree
distributions the plan build refuses. Matvec is the hot op
(PageRank-class workloads); ``matmat`` serves narrow dense right-hand
sides with one kernel launch for all columns.

With ``config.use_pallas`` (the default) ``matvec``/``matmat`` run the
compact-table kernels (``ops/pallas_spmv.py``: the CUDA kernels B2/B3 on
the card, their plain versions on the CPU); with it off, and always for
``rmatvec``, the expanded one-hot path (``ops/spmv.py``) runs. Every
product takes ``device=`` and runs on the card unless asked for another.

``shard`` and the relational σ/γ/⋈ methods are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from matrel_tpu_torch.core.mesh import resolve_device
from matrel_tpu_torch.ops import spmv as spmv_lib


@dataclasses.dataclass
class COOMatrix:
    """Immutable element-sparse matrix over a fixed coordinate list."""

    rows: np.ndarray          # host int64, unsorted as given
    cols: np.ndarray
    vals: np.ndarray          # float32
    shape: Tuple[int, int]
    _plan: Optional[spmv_lib.EdgeSpMVPlan] = dataclasses.field(
        default=None, repr=False)
    _plan_t: Optional[spmv_lib.EdgeSpMVPlan] = dataclasses.field(
        default=None, repr=False)
    _plan_tried: bool = dataclasses.field(default=False, repr=False)
    _plan_t_tried: bool = dataclasses.field(default=False, repr=False)
    # fallback-path caches per device: (out_ids, in_ids, vals) sorted by
    # out_ids — fixed per matrix, built once per direction and device
    _seg_fwd: Dict[str, tuple] = dataclasses.field(default_factory=dict,
                                                   repr=False)
    _seg_bwd: Dict[str, tuple] = dataclasses.field(default_factory=dict,
                                                   repr=False)

    # ---------------------------------------------------------- build
    @classmethod
    def from_edges(cls, rows, cols, vals=None,
                   shape: Optional[Tuple[int, int]] = None) -> "COOMatrix":
        rows = np.asarray(rows, dtype=np.int64).ravel()
        cols = np.asarray(cols, dtype=np.int64).ravel()
        if rows.shape != cols.shape:
            raise ValueError(f"rows/cols length mismatch: "
                             f"{rows.shape} vs {cols.shape}")
        if vals is None:
            vals = np.ones(rows.shape, np.float32)
        else:
            vals = np.asarray(vals, dtype=np.float32).ravel()
            if vals.shape != rows.shape:
                raise ValueError("vals length must match rows/cols")
        if shape is None:
            shape = (int(rows.max()) + 1 if rows.size else 1,
                     int(cols.max()) + 1 if cols.size else 1)
        if rows.size and (rows.min() < 0 or rows.max() >= shape[0]
                          or cols.min() < 0 or cols.max() >= shape[1]):
            raise ValueError("edge indices out of bounds for shape")
        return cls(rows=rows, cols=cols, vals=vals,
                   shape=(int(shape[0]), int(shape[1])))

    @classmethod
    def from_scipy(cls, mat) -> "COOMatrix":
        """From any scipy.sparse matrix (converted to COO)."""
        coo = mat.tocoo()
        return cls.from_edges(coo.row, coo.col, coo.data, shape=coo.shape)

    # ------------------------------------------------------ properties
    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def dtype(self) -> torch.dtype:
        """Payloads are f32 by construction and every product
        accumulates in f32."""
        return torch.float32

    @property
    def T(self) -> "COOMatrix":
        """Transpose view — shares this matrix's plan caches swapped."""
        return COOMatrix(rows=self.cols, cols=self.rows, vals=self.vals,
                         shape=(self.shape[1], self.shape[0]),
                         _plan=self._plan_t, _plan_t=self._plan,
                         _plan_tried=self._plan_t_tried,
                         _plan_t_tried=self._plan_tried,
                         _seg_fwd=self._seg_bwd, _seg_bwd=self._seg_fwd)

    # ----------------------------------------------------------- plans
    def _get_plan(self) -> Optional[spmv_lib.EdgeSpMVPlan]:
        if not self._plan_tried:
            self._plan = spmv_lib.build_spmv_plan(
                self.rows, self.cols, self.vals,
                n_rows=self.shape[0], n_cols=self.shape[1])
            self._plan_tried = True
        return self._plan

    def _get_plan_t(self) -> Optional[spmv_lib.EdgeSpMVPlan]:
        if not self._plan_t_tried:
            self._plan_t = spmv_lib.build_spmv_plan(
                self.cols, self.rows, self.vals,
                n_rows=self.shape[1], n_cols=self.shape[0])
            self._plan_t_tried = True
        return self._plan_t

    # ------------------------------------------------------------ ops
    @staticmethod
    def _compact_mode() -> bool:
        """The compact-table kernels run unless ``use_pallas`` is off."""
        from matrel_tpu_torch.ops.pallas_spmv import compact_enabled
        return compact_enabled()

    def matvec(self, x, device=None) -> torch.Tensor:
        """y = A·x, shape (n_rows,), on ``device`` (default: the card)."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
        if x.shape[0] != self.shape[1]:
            raise ValueError(f"x has {x.shape[0]} entries, A has "
                             f"{self.shape[1]} columns")
        plan = self._get_plan()
        if plan is not None:
            if self._compact_mode():
                from matrel_tpu_torch.ops import pallas_spmv as pc
                return pc.spmv_compact(plan, x, device=dev)
            return spmv_lib.spmv(plan, x)
        seg = self._seg_on(self._seg_fwd, self.rows, self.cols, dev)
        return self._segment_matvec(seg, x, self.shape[0])

    def rmatvec(self, y, device=None) -> torch.Tensor:
        """x = Aᵀ·y, shape (n_cols,) — the lazily-built transpose plan,
        through the expanded one-hot path."""
        dev = resolve_device(device)
        y = torch.as_tensor(y, dtype=torch.float32, device=dev).reshape(-1)
        if y.shape[0] != self.shape[0]:
            raise ValueError(f"y has {y.shape[0]} entries, A has "
                             f"{self.shape[0]} rows")
        plan = self._get_plan_t()
        if plan is not None:
            return spmv_lib.spmv(plan, y)
        seg = self._seg_on(self._seg_bwd, self.cols, self.rows, dev)
        return self._segment_matvec(seg, y, self.shape[1])

    def matmat(self, X, device=None) -> torch.Tensor:
        """Y = A·X for dense X (n_cols, k): one shared gather for all
        columns (one B3 launch on the card). Falls back to a per-column
        matvec loop only when the plan build refused the graph."""
        dev = resolve_device(device)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        if X.dim() != 2 or X.shape[0] != self.shape[1]:
            raise ValueError(f"X must be ({self.shape[1]}, k), "
                             f"got {tuple(X.shape)}")
        if X.shape[1] == 0:
            return X.new_zeros((self.shape[0], 0))
        plan = self._get_plan()
        if plan is not None:
            if self._compact_mode():
                from matrel_tpu_torch.ops import pallas_spmv as pc
                return pc.spmm_compact(plan, X, device=dev)
            return spmv_lib.spmm(plan, X)
        cols = [self.matvec(X[:, j], device=dev) for j in range(X.shape[1])]
        return torch.stack(cols, dim=1)

    def _seg_on(self, memo: Dict[str, tuple], out_ids, in_ids,
                device) -> tuple:
        key = str(device)
        if key not in memo:
            memo[key] = self._seg_arrays(out_ids, in_ids, device)
        return memo[key]

    def _seg_arrays(self, out_ids, in_ids, device) -> tuple:
        order = np.argsort(out_ids, kind="stable")
        return (torch.as_tensor(out_ids[order], device=device),
                torch.as_tensor(in_ids[order], device=device),
                torch.as_tensor(self.vals[order], device=device))

    @staticmethod
    def _segment_matvec(seg, x, n_out) -> torch.Tensor:
        out_s, in_s, val_s = seg
        w = val_s * spmv_lib.gather_1d(x, in_s)
        return torch.zeros(n_out, dtype=torch.float32,
                           device=x.device).index_add_(0, out_s, w)

    def to_dense(self) -> np.ndarray:
        """Host densification (small matrices / tests)."""
        out = np.zeros(self.shape, np.float32)
        np.add.at(out, (self.rows, self.cols), self.vals)
        return out

    def to_block(self, mesh=None, config=None):
        """Densify into a BlockMatrix — the fallback when a COO matrix is
        used where no SpMV lowering applies. O(n·m) memory."""
        from matrel_tpu_torch.core.blockmatrix import BlockMatrix
        return BlockMatrix.from_numpy(self.to_dense(), mesh=mesh,
                                      config=config, nnz=self.nnz)

    # ------------------------------------------------------------ DSL
    def expr(self):
        """Enter the lazy IR as an element-sparse leaf: matmuls against
        narrow dense operands lower to the SpMV plan; other uses densify
        (see executor)."""
        from matrel_tpu_torch.ir import expr as E
        return E.MatExpr("coo_leaf", (), tuple(self.shape),
                         min(self.nnz, self.shape[0] * self.shape[1]),
                         {"matrix": self})

    def multiply(self, other):
        from matrel_tpu_torch.ir import expr as E
        return E.matmul(self.expr(), E.as_expr(other))
