"""A per-plan CSR view of an SpMV plan's slots, and its plain walk.

The routed SpMV (B8, ``ops/spmv_routed.py``) and the k-wide compact SpMM
(B3, ``ops/pallas_spmv.py``) compute the same kind of function: for each
output row, the sum over its slots of ``split(split?(x[col]) · val)``.
Their plans lay the slots out for the TPU (by cell, by row block, with
padding). :func:`csr_view` orders the real slots by output row once per
plan, so that the Hopper kernels walk each row's slots in registers —
no atomics, no shared-memory accumulator, each output written once.

The view (:class:`CSRView`) is two tensors and the operand width:

- ``row_ptr`` int32 (n_rows + 1,): row ``r``'s slots are
  ``cv[row_ptr[r]:row_ptr[r + 1]]``;
- ``cv`` int32 (nnz, 2): per slot its column and the bits of its f32
  value, interleaved so that a slot is one 8-byte load;
- ``n_cols``: the length of the dense operand it multiplies.

Slots are ordered by row with a stable sort, so a row keeps its plan's
slot order. The caller passes only the slots its kernel would add (the
plan's padding and sentinels dropped), so no result changes. A view is
checked once where it is made (every column below ``n_cols``, ``row_ptr``
monotone from 0 to nnz), so the kernels read inside ``cv`` and the dense
operand; a wrapper then checks only the dense operand against it.
:func:`csr_walk_plain` is the plain PyTorch walk of the view: f32
products and split parts, f64 row sums rounded once.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

Tensor = torch.Tensor

#: Slot × column elements per step of the plain walk: bounds its
#: temporaries to a few hundred MB at BASELINE row-5 size.
_PLAIN_CHUNK_ELEMS = 1 << 23


@dataclasses.dataclass(frozen=True, eq=False)
class CSRView:
    """A plan's slots ordered by output row (see the module docstring);
    made by :func:`csr_view`, which checks it once."""
    row_ptr: Tensor
    cv: Tensor
    n_cols: int

    def __post_init__(self):
        row_ptr, cv = self.row_ptr, self.cv
        if row_ptr.dtype != torch.int32 or row_ptr.dim() != 1 \
                or row_ptr.numel() < 1:
            raise TypeError(f"row_ptr must be 1-D int32 with n_rows + 1 "
                            f"entries, got {row_ptr.dtype} "
                            f"{tuple(row_ptr.shape)}")
        if cv.dtype != torch.int32 or cv.dim() != 2 or cv.shape[1] != 2:
            raise TypeError(f"cv must be (nnz, 2) int32, got {cv.dtype} "
                            f"{tuple(cv.shape)}")
        if row_ptr.device != cv.device \
                or row_ptr.device.type not in ("cpu", "cuda"):
            raise ValueError(f"row_ptr and cv must lie on one CPU or CUDA "
                             f"device, got {row_ptr.device}, {cv.device}")
        if not (row_ptr.is_contiguous() and cv.is_contiguous()):
            raise ValueError("row_ptr and cv must be contiguous")
        if cv.data_ptr() % 8:
            raise ValueError("cv must be 8-byte aligned: a slot is one "
                             "8-byte load")
        if not 0 <= self.n_cols < 1 << 31:
            raise ValueError(f"n_cols {self.n_cols} outside [0, 2^31)")
        ends = torch.stack([row_ptr[0], row_ptr[-1]]).tolist()  # matlint: disable=ML001 a view's validation — once where the view is made, memoised on its plan
        if ends != [0, cv.shape[0]]:
            raise ValueError(f"row_ptr runs from {ends[0]} to {ends[1]}, "
                             f"want 0 to nnz = {cv.shape[0]}")
        if row_ptr.numel() > 1 and bool((row_ptr[1:] < row_ptr[:-1]).any()):  # matlint: disable=ML001 a view's validation — once where the view is made, memoised on its plan
            raise ValueError("row_ptr must not decrease")
        if cv.shape[0] and bool(((cv[:, 0] < 0)  # matlint: disable=ML001 a view's validation — once where the view is made, memoised on its plan
                                 | (cv[:, 0] >= self.n_cols)).any()):
            raise ValueError(f"a column of cv lies outside [0, "
                             f"{self.n_cols})")

    @property
    def n_rows(self) -> int:
        return self.row_ptr.numel() - 1

    @property
    def nnz(self) -> int:
        return self.cv.shape[0]


def csr_view(rows, cols, vals, n_rows: int, n_cols: int, device=None
             ) -> CSRView:
    """The view of the slots (rows[i], cols[i], vals[i]), ordered by row
    with a stable sort. Every row must lie in [0, n_rows) and every
    column in [0, n_cols); built on ``device`` (default: ``rows``')."""
    rows = torch.as_tensor(rows, device=device).long()
    dev = rows.device
    cols = torch.as_tensor(cols, device=dev).long()
    vals = torch.as_tensor(vals, device=dev).float()
    if not rows.shape == cols.shape == vals.shape or rows.dim() != 1:
        raise ValueError(f"rows, cols and vals must be 1-D of one length, "
                         f"got {tuple(rows.shape)}, {tuple(cols.shape)}, "
                         f"{tuple(vals.shape)}")
    if rows.numel() >= 1 << 31:
        raise ValueError(f"{rows.numel()} slots: the view's int32 row "
                         f"pointers hold fewer than 2^31")
    order = torch.sort(rows, stable=True).indices
    row_ptr = torch.zeros(n_rows + 1, dtype=torch.int32, device=dev)
    torch.cumsum(torch.bincount(rows, minlength=n_rows), 0,
                 out=row_ptr[1:])
    cv = torch.stack([cols[order].int(), vals[order].view(torch.int32)],
                     dim=1).contiguous()
    return CSRView(row_ptr, cv, n_cols)


def view_slots(view: CSRView) -> Tuple[Tensor, Tensor, Tensor]:
    """(rows int64, cols int64, vals f32) of the view's slots, in its
    order."""
    row_ptr, cv = view.row_ptr, view.cv
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    rows = torch.repeat_interleave(
        torch.arange(view.n_rows, device=row_ptr.device), counts,
        output_size=view.nnz)
    return rows, cv[:, 0].long(), cv[:, 1].contiguous().view(torch.float32)


def check_operands(view: CSRView, dense: Tensor, passes: int,
                   dense_dim: int) -> None:
    """Raise on operands the view kernels do not take: the dense operand
    must be a contiguous f32 tensor of ``dense_dim`` dimensions with
    ``view.n_cols`` rows, on the view's device."""
    if not isinstance(view, CSRView):
        raise TypeError(f"view must be a CSRView, got {type(view).__name__}")
    if dense.dtype != torch.float32:
        raise TypeError(f"dense operand must be float32, got {dense.dtype}")
    if dense.dim() != dense_dim:
        raise ValueError(f"dense operand must be {dense_dim}-D, got "
                         f"{tuple(dense.shape)}")
    if dense.shape[0] != view.n_cols:
        raise ValueError(f"dense operand has {dense.shape[0]} rows, the "
                         f"view's columns are {view.n_cols}")
    if dense.device != view.row_ptr.device:
        raise ValueError(f"operands on different devices: "
                         f"{view.row_ptr.device}, {dense.device}")
    if not dense.is_contiguous():
        raise ValueError("the view kernels need a contiguous dense operand")
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")


def csr_walk_plain(view: CSRView, X: Tensor, passes: int,
                   split_x: bool) -> Tensor:
    """Plain PyTorch walk of the view: out[r] = Σ over row r's slots of
    split(x'[col] · val), with x' = split(x) when ``split_x`` (B8) and x
    itself otherwise (B3); split keeps the first ``passes`` bf16-grid
    parts. X is (n_cols,) or (n_cols, k) f32; products and parts are
    f32, the sums f64 (in slot order on the CPU), rounded once. Returns
    (n_rows,) or (n_rows, k) f32."""
    from matrel_tpu_torch.ops.spmv_routed import split_sum
    n_rows = view.n_rows
    rows, cols, vals = view_slots(view)
    Xs = split_sum(X, passes) if split_x else X.float()
    wide = Xs.dim() == 2
    k = Xs.shape[1] if wide else 1
    out = torch.zeros((n_rows,) + tuple(Xs.shape[1:]), dtype=torch.float64,
                      device=X.device)
    step = max(1, _PLAIN_CHUNK_ELEMS // max(k, 1))
    for s0 in range(0, cols.numel(), step):
        sl = slice(s0, s0 + step)
        v = vals[sl, None] if wide else vals[sl]
        w = Xs[cols[sl]] * v
        out.index_add_(0, rows[sl], split_sum(w, passes).double())
    return out.float()
