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

The relational σ/γ/⋈ methods (``coalesce``, ``select_value``,
``select_index``, the row/col aggregates, ``norm``, ``trace``,
``join_on_index``, ``join_on_value``) run on the host over the edge
list, O(nnz), as in the JAX package: predicates and merges are
vectorised callables over numpy arrays. A selected matrix is a new
``COOMatrix`` and goes on to the kernels through ``matvec``/``matmat``
and ``compute``. :meth:`COOMatrix.shard` binds the matrix to a rank mesh:
its ``matvec``/``matmat`` then run each rank's slice of block rows
(``pallas_spmv.compact_sharded_apply``: B2/B3 per rank; the expanded
one-hot slices with ``use_pallas`` off) and gather the rows.
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
    # True when coordinates are known-unique (outputs of coalesce /
    # select_value / joins): chained relational ops skip the re-sort
    _coalesced: bool = dataclasses.field(default=False, repr=False)
    # set by .shard(): the rank mesh the forward matvec/matmat run over
    _mesh: Optional[object] = dataclasses.field(default=None, repr=False)

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

    def shard(self, mesh) -> "COOMatrix":
        """A copy whose forward ``matvec``/``matmat`` run over the rank
        mesh: each rank contracts its slice of output blocks against the
        replicated x, one all_gather assembles the result (every rank
        gets it). ``rmatvec`` and the transpose keep the unsharded path.

        Raises when the planner refuses this graph: distribution was
        asked for, and a silent single-device segment sum would hide the
        cliff; catch it and use the unsharded matrix if that is
        acceptable."""
        if not getattr(mesh, "ranked", False):
            raise ValueError("COOMatrix.shard needs a rank mesh "
                             "(core.mesh.init_distributed)")
        plan = self._get_plan()
        if plan is None:
            raise ValueError(
                "degree distribution too heavy-tailed for the one-hot "
                "plan; sharded matvec unavailable for this graph")
        return dataclasses.replace(self, _mesh=mesh, _seg_fwd={},
                                   _seg_bwd={})

    # ------------------------------------------------------------ ops
    @staticmethod
    def _compact_mode() -> bool:
        """The compact-table kernels run unless ``use_pallas`` is off."""
        from matrel_tpu_torch.ops.pallas_spmv import compact_enabled
        return compact_enabled()

    def _device(self, device) -> torch.device:
        """The device a product runs on: the rank's on a sharded matrix,
        else ``device`` (default: the card)."""
        if self._mesh is not None:
            return self._mesh.device
        return resolve_device(device)

    def matvec(self, x, device=None) -> torch.Tensor:
        """y = A·x, shape (n_rows,), on ``device`` (default: the card;
        the rank's device on a sharded matrix)."""
        dev = self._device(device)
        x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
        if x.shape[0] != self.shape[1]:
            raise ValueError(f"x has {x.shape[0]} entries, A has "
                             f"{self.shape[1]} columns")
        if self._mesh is not None:
            from matrel_tpu_torch.ops import pallas_spmv as pc
            if self._compact_mode():
                return pc.compact_sharded_apply(self._plan, x, self._mesh)
            return spmv_lib.spmv_sharded(self._plan, x, self._mesh)
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
        dev = self._device(device)
        X = torch.as_tensor(X, dtype=torch.float32, device=dev)
        if X.dim() != 2 or X.shape[0] != self.shape[1]:
            raise ValueError(f"X must be ({self.shape[1]}, k), "
                             f"got {tuple(X.shape)}")
        if X.shape[1] == 0:
            return X.new_zeros((self.shape[0], 0))
        if self._mesh is not None:
            from matrel_tpu_torch.ops import pallas_spmv as pc
            if X.shape[1] == 1:
                return self.matvec(X[:, 0])[:, None]
            if self._compact_mode():
                return pc.compact_sharded_matmat_apply(self._plan, X,
                                                       self._mesh)
            return spmv_lib.spmm_sharded(self._plan, X, self._mesh)
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

    # ------------------------------------------------- relational (σ/γ/⋈)
    # Edge-list forms of the relational operators: O(nnz) host work over
    # the coordinates, with the dense masked semantics (0 = missing), so
    # results agree with the IR lowerings wherever both are feasible.

    def coalesce(self) -> "COOMatrix":
        """Collapse duplicate coordinates additively (entry-level view);
        returns self when coordinates are known-unique."""
        if self._coalesced:
            return self
        m = self.shape[1]
        keys, vals = _sum_dups(self.rows * m + self.cols, self.vals)
        out = COOMatrix.from_edges(keys // m, keys % m, vals,
                                   shape=self.shape)
        out._coalesced = True
        return out

    def select_value(self, predicate, fill: float = 0.0) -> "COOMatrix":
        """σ on ENTRY values (duplicates coalesced first: an entry's value
        is the sum of its edges). Only fill=0 keeps the result sparse."""
        if fill != 0.0:
            raise ValueError("COOMatrix.select_value supports fill=0 "
                             "only (a nonzero fill densifies; use "
                             "to_block(...).select_value)")
        A = self.coalesce()
        keep = np.asarray(predicate(A.vals), bool)
        out = COOMatrix.from_edges(A.rows[keep], A.cols[keep],
                                   A.vals[keep], shape=self.shape)
        out._coalesced = True
        return out

    def select_index(self, *, rows=None, cols=None) -> "COOMatrix":
        """σ on indices: keep edges whose row/col satisfy the predicates
        (vectorised callables over index arrays)."""
        keep = np.ones(self.rows.shape, bool)
        if rows is not None:
            keep &= np.asarray(rows(self.rows), bool)
        if cols is not None:
            keep &= np.asarray(cols(self.cols), bool)
        out = COOMatrix.from_edges(self.rows[keep], self.cols[keep],
                                   self.vals[keep], shape=self.shape)
        out._coalesced = self._coalesced   # subsets stay unique
        return out

    def _axis_agg(self, axis: str, kind: str) -> np.ndarray:
        # count/avg/max/min are entry-level (γ over nonzero TUPLES):
        # duplicates coalesce first; plain sums are additive anyway
        A = self if kind == "sum" else self.coalesce()
        ids = A.rows if axis == "row" else A.cols
        n = self.shape[0] if axis == "row" else self.shape[1]
        vals = A.vals
        nz = vals != 0
        if kind == "sum":
            out = np.bincount(ids, weights=vals,
                              minlength=n).astype(np.float32)
        elif kind == "count":
            out = np.bincount(ids[nz], minlength=n).astype(np.float32)
        elif kind == "avg":
            sv = np.bincount(ids, weights=vals, minlength=n)
            c = np.bincount(ids[nz], minlength=n)
            out = np.where(c > 0, sv / np.maximum(c, 1), 0.0)
        elif kind in ("max", "min"):
            fill = -np.inf if kind == "max" else np.inf
            out = np.full(n, fill, np.float64)
            op = np.maximum if kind == "max" else np.minimum
            op.at(out, ids[nz], vals[nz].astype(np.float64))
            out = np.where(np.isfinite(out), out, 0.0)
            # a row/col with any MISSING entry includes implicit zeros in
            # its max/min, as the dense lowering's full-region reduction
            width = self.shape[1] if axis == "row" else self.shape[0]
            cnt = np.bincount(ids[nz], minlength=n)
            out = np.where(cnt < width, op(out, 0.0), out)
        else:
            raise ValueError(f"unknown aggregate {kind!r}")
        return out.astype(np.float32)

    def row_sum(self) -> np.ndarray:
        """γ: per-row sums as (n, 1) — O(nnz), never densifies."""
        return self._axis_agg("row", "sum")[:, None]

    def col_sum(self) -> np.ndarray:
        return self._axis_agg("col", "sum")[None, :]

    def row_count(self) -> np.ndarray:
        return self._axis_agg("row", "count")[:, None]

    def col_count(self) -> np.ndarray:
        return self._axis_agg("col", "count")[None, :]

    def row_avg(self) -> np.ndarray:
        return self._axis_agg("row", "avg")[:, None]

    def col_avg(self) -> np.ndarray:
        return self._axis_agg("col", "avg")[None, :]

    def row_max(self) -> np.ndarray:
        return self._axis_agg("row", "max")[:, None]

    def row_min(self) -> np.ndarray:
        return self._axis_agg("row", "min")[:, None]

    def col_max(self) -> np.ndarray:
        return self._axis_agg("col", "max")[None, :]

    def col_min(self) -> np.ndarray:
        return self._axis_agg("col", "min")[None, :]

    def sum(self) -> float:
        return float(self.vals.sum())

    def norm(self, kind: str = "fro") -> float:
        """Matrix norm over ENTRIES (duplicates coalesced first)."""
        v = self.coalesce().vals.astype(np.float64)
        if kind == "fro":
            return float(np.sqrt((v * v).sum()))
        if kind == "l1":
            return float(np.abs(v).sum())
        if kind == "max":
            return float(np.abs(v).max()) if v.size else 0.0
        raise ValueError(f"unknown norm kind {kind!r} "
                         "(expected 'fro', 'l1', or 'max')")

    def trace(self) -> float:
        d = self.rows == self.cols
        return float(self.vals[d].sum())

    def join_on_index(self, other: "COOMatrix", merge) -> "COOMatrix":
        """⋈ on index equality: C[i,j] = merge(A[i,j], B[i,j]) over the
        UNION of both coordinate sets (absent entries read 0). merge is a
        vectorised callable with merge(0, 0) == 0; exact zeros of the
        result are dropped from the edge list."""
        if tuple(self.shape) != tuple(other.shape):
            raise ValueError(f"join_on_index shape mismatch: "
                             f"{self.shape} vs {other.shape}")
        if float(merge(np.float32(0.0), np.float32(0.0))) != 0.0:
            raise ValueError(
                "merge(0, 0) != 0: the result is dense (every absent "
                "coordinate becomes nonzero) — use the dense IR "
                "join_on_index for such merges")
        m = self.shape[1]
        ka_u, va = _sum_dups(self.rows * m + self.cols, self.vals)
        kb_u, vb = _sum_dups(other.rows * m + other.cols, other.vals)
        union = np.union1d(ka_u, kb_u)
        a_full = np.zeros(union.shape, np.float32)
        b_full = np.zeros(union.shape, np.float32)
        a_full[np.searchsorted(union, ka_u)] = va
        b_full[np.searchsorted(union, kb_u)] = vb
        merged = np.asarray(merge(a_full, b_full), np.float32)
        nz = merged != 0
        out = COOMatrix.from_edges(union[nz] // m, union[nz] % m,
                                   merged[nz], shape=self.shape)
        out._coalesced = True
        return out

    def join_on_value(self, other: "COOMatrix", merge="mul",
                      predicate="eq", max_pairs: int = 1 << 22):
        """⋈ on values over NONZERO entry tuples (the dense IR's pair
        matrix ranges over all logical entries; here only stored nonzero
        entries join).

        predicate: "eq"/"lt"/"le"/"gt"/"ge" (sort-based matching before
        any pair is materialised) or a vectorised callable over
        (va, vb) (brute force, capped). merge: "left"/"right"/"add"/
        "mul" or a vectorised callable. Returns the matched pairs as
        numpy arrays ``(ia, ja, ib, jb, value)``; refuses more than
        ``max_pairs`` pairs."""
        A = self.coalesce()
        B = other.coalesce()
        # zero-valued entries (duplicate cancellation) are absent
        nza = A.vals != 0
        nzb = B.vals != 0
        a_rows, a_cols = A.rows[nza], A.cols[nza]
        b_rows, b_cols = B.rows[nzb], B.cols[nzb]
        va = A.vals[nza].astype(np.float32)
        vb = B.vals[nzb].astype(np.float32)
        merge_np = {"left": lambda x, y: x, "right": lambda x, y: y,
                    "add": np.add, "mul": np.multiply}.get(merge, merge)
        if not callable(merge_np):
            raise ValueError(f"unknown merge {merge!r}")
        if callable(predicate):
            if va.size * vb.size > max_pairs:
                raise ValueError(
                    f"callable-predicate value join must enumerate "
                    f"{va.size}x{vb.size} pairs (> max_pairs = "
                    f"{max_pairs}); use a structured predicate "
                    f"('eq'/'lt'/'le'/'gt'/'ge') or raise max_pairs")
            mask = np.asarray(predicate(va[:, None], vb[None, :]), bool)
            pa, pb = np.nonzero(mask)
        else:
            # the streaming executor path's predicate→range semantics
            from matrel_tpu_torch.relational.value_join import match_range
            order = np.argsort(vb, kind="stable")   # NaNs sort last
            lo, hi = match_range(vb[order], va, predicate)
            cnt = hi - lo
            total = int(cnt.sum())
            if total > max_pairs:
                raise ValueError(
                    f"value join matches {total} pairs (> max_pairs = "
                    f"{max_pairs}); tighten the predicate or raise "
                    f"max_pairs")
            pa = np.repeat(np.arange(va.size), cnt)
            # pair k of entry i maps to sorted-B slot lo[i] + offset
            offs = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
            pb = order[np.repeat(lo, cnt) + offs]
        vals = np.asarray(merge_np(va[pa], vb[pb]), np.float32)
        return (a_rows[pa], a_cols[pa], b_rows[pb], b_cols[pb], vals)

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


def _sum_dups(keys: np.ndarray, vals: np.ndarray):
    """Collapse duplicate coordinates additively: unique keys + summed
    values (host, O(nnz log nnz))."""
    if keys.size == 0:
        return keys, vals.astype(np.float32)
    uniq, inv = np.unique(keys, return_inverse=True)
    return uniq, np.bincount(inv, weights=vals,
                             minlength=uniq.size).astype(np.float32)
