"""Sparse matrix-vector product over edge lists (SpMV) — the counterpart
of ``matrel_tpu/ops/spmv.py``.

An :class:`EdgeSpMVPlan` is the compiled layout of a fixed edge list
``y[i] = Σ_{e: rows[e]=i} vals[e] · x[cols[e]]``: destination rows are
grouped into blocks of ``BLOCK`` = 512, each block's edges padded to a
fixed capacity of slots, and every slot stored as compact integers —
the width-8 row ``src8`` and ``lane`` of its source, its in-block
destination offset ``off`` and its value ``val`` (13 bytes a slot).
Edges past a block's capacity go to a small overflow COO summed with
``index_add_`` (the counterpart of ``segment_sum``).

Two executors read a plan:

* the compact one (``ops/pallas_spmv.py``: the hand-written CUDA kernels
  B2/B3 on the card, their plain versions on the CPU), the default;
* the expanded one-hot contraction below (``spmv``/``spmm``), which
  expands the slots into one-hot tables (~224 bytes a slot) once per
  device and sums with batched f32 products — the JAX package's XLA
  path, taken for ``use_pallas=False`` and by ``COOMatrix.rmatvec``.

The plan build is host numpy (``_numpy_fill``); the JAX package's
native counting-sort fill is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

WIDTH = 8        # gather row width of the compact layout
BLOCK = 512      # scatter block: destination rows per plan block
HI = 32          # off = hi*LO + lo one-hot factor sizes; HI*LO == BLOCK
LO = 16

Tensor = torch.Tensor


def _ext_table(x: Tensor, width: int = WIDTH) -> Tensor:
    """Pad a 1-D table to (rows, width) with ≥1 zero row so index ``n``
    (the sentinel) and any padded slot read 0."""
    n = x.shape[0]
    rows = n // width + 1
    return torch.cat([x, x.new_zeros(rows * width - n)]).reshape(rows, width)


def gather_1d(table: Tensor, idx: Tensor, width: int = WIDTH) -> Tensor:
    """``table[idx]`` for a 1-D table, via width-row gather + one-hot
    select (exact: the select multiplies by a 0/1 mask). ``idx ==
    table.shape[0]`` is a valid sentinel reading 0."""
    t2 = _ext_table(table, width)
    idx = idx.long()
    g = t2[idx // width]                                   # (..., width)
    sel = ((idx % width)[..., None] == torch.arange(
        width, device=idx.device)).to(table.dtype)
    return (g * sel).sum(-1)


def _key(device) -> str:
    return str(torch.device(device))


@dataclasses.dataclass
class EdgeSpMVPlan:
    """Compiled layout for ``y[i] = Σ_{e: rows[e]=i} vals[e] · x[cols[e]]``.

    Host tables (numpy; B = #row blocks, C = per-block capacity):
      src8 (B, C) int32 — width-row index of x per padded edge slot
      lane (B, C) int8  — cols[e] % WIDTH
      off  (B, C) int32 — rows[e] % block
      val  (B, C) f32   — vals[e] (0 in padded slots)
    Overflow: optional (cols, rows, vals) int32/int32/f32 COO for edges
    beyond capacity, rows sorted ascending. Device copies (the expanded
    one-hot tables, the compact tables, the overflow) are built lazily,
    once per device, and memoised on the plan.
    """
    n_rows: int
    n_cols: int
    block: int
    capacity: int
    src8: np.ndarray
    lane: np.ndarray
    off: np.ndarray
    val: np.ndarray
    ov_cols: Optional[np.ndarray]
    ov_rows: Optional[np.ndarray]
    ov_vals: Optional[np.ndarray]
    padding_ratio: float
    _tables: Dict[str, tuple] = dataclasses.field(default_factory=dict,
                                                  repr=False)
    _spmm_tables: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False)
    _overflow_dev: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False)
    _compact_dev: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def overflow(self):
        """Host overflow COO triple (cols, rows, vals), or () when none."""
        return (() if self.ov_cols is None
                else (self.ov_cols, self.ov_rows, self.ov_vals))

    def overflow_on(self, device) -> tuple:
        """The overflow COO on ``device`` (int64 ids, f32 values), or ()."""
        if self.ov_cols is None:
            return ()
        key = _key(device)
        ov = self._overflow_dev.get(key)
        if ov is None:
            ov = (torch.as_tensor(self.ov_cols, device=device).long(),
                  torch.as_tensor(self.ov_rows, device=device).long(),
                  torch.as_tensor(self.ov_vals, device=device))
            self._overflow_dev[key] = ov
        return ov

    def arrays(self, device) -> tuple:
        """(src8, sel, oh_hi, oh_lo) + overflow on ``device``: the
        expanded one-hot tables, built on first use there."""
        key = _key(device)
        tables = self._tables.get(key)
        if tables is None:
            src8 = torch.as_tensor(self.src8, device=device)
            tables = (src8,) + _expand_tables(
                torch.as_tensor(self.lane, device=device),
                torch.as_tensor(self.off, device=device),
                torch.as_tensor(self.val, device=device),
                self.block // LO)
            self._tables[key] = tables
        return tables + self.overflow_on(device)

    def spmm_extra(self, device) -> tuple:
        """(src_full, val) tables for the k-wide SpMM path, derived once
        per device from the expanded tables."""
        key = _key(device)
        if key not in self._spmm_tables:
            src8, sel = self.arrays(device)[:2]
            self._spmm_tables[key] = _derive_spmm_tables(src8, sel)
        return self._spmm_tables[key]


def _derive_spmm_tables(src8: Tensor, sel: Tensor) -> Tuple[Tensor, Tensor]:
    lane = torch.argmax((sel != 0.0).to(torch.uint8), dim=-1)
    src_full = src8.long() * WIDTH + lane
    return src_full, sel.sum(-1)


def _expand_tables(lane: Tensor, off: Tensor, val: Tensor,
                   hi_n: int) -> Tuple[Tensor, Tensor, Tensor]:
    dev = lane.device
    sel = torch.where(lane[..., None].long()
                      == torch.arange(WIDTH, device=dev),
                      val[..., None], torch.zeros((), device=dev))
    oh_hi = ((off // LO)[..., None].long()
             == torch.arange(hi_n, device=dev)).float()
    oh_lo = ((off % LO)[..., None].long()
             == torch.arange(LO, device=dev)).float()
    return sel, oh_hi, oh_lo


def build_spmv_plan(rows, cols, vals=None, n_rows: int = None,
                    n_cols: int = None, *, block: int = BLOCK,
                    capacity_quantile: float = 0.995,
                    max_padding: float = 4.0,
                    max_slots: Optional[int] = None
                    ) -> Optional[EdgeSpMVPlan]:
    """Host-side plan build (numpy, once per graph).

    Capacity is the ``capacity_quantile`` of per-block edge counts rounded
    up to a multiple of 128; edges past it go to the overflow COO. Returns
    None when even that layout pads worse than ``max_padding``× the edge
    count (and past 1M slots), or when the padded slot count exceeds
    ``max_slots`` — callers then use the plain segment-sum path.
    """
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    m = rows.shape[0]
    if n_rows is None:
        n_rows = int(rows.max()) + 1 if m else 1
    if n_cols is None:
        n_cols = int(cols.max()) + 1 if m else 1
    if vals is not None:
        vals = np.asarray(vals, dtype=np.float32)
    if block % LO:
        raise ValueError("block must be a multiple of LO")
    if m and (rows.min() < 0 or rows.max() >= n_rows
              or cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("edge indices out of bounds for "
                         f"({n_rows}, {n_cols})")

    nb = -(-n_rows // block)
    cnt = np.bincount(rows // block, minlength=nb)
    if m == 0:
        cap = 128
    else:
        cap_q = int(np.quantile(cnt[cnt > 0], capacity_quantile)) \
            if (cnt > 0).any() else 0
        cap = max(128, -(-cap_q // 128) * 128)
    if m and nb * cap > max_padding * m and nb * cap > (1 << 20):
        return None
    if max_slots is not None and nb * cap > max_slots:
        return None
    n_ov = int(np.maximum(cnt - cap, 0).sum())
    src8, lane, off, val, ov_r64, ov_c64, ov_v = _numpy_fill(
        rows, cols, vals, m, n_cols, block, nb, cap, cnt)
    if n_ov:
        ov_c = ov_c64.astype(np.int32)
        ov_r = ov_r64.astype(np.int32)
        ov_v = ov_v.astype(np.float32)
    else:
        ov_c = ov_r = ov_v = None
    return EdgeSpMVPlan(
        n_rows=n_rows, n_cols=n_cols, block=block, capacity=cap,
        src8=np.ascontiguousarray(src8, np.int32),
        lane=np.ascontiguousarray(lane, np.int8),
        off=np.ascontiguousarray(off, np.int32),
        val=np.ascontiguousarray(val, np.float32),
        ov_cols=ov_c, ov_rows=ov_r, ov_vals=ov_v,
        padding_ratio=(nb * cap + n_ov) / max(m, 1))


def _numpy_fill(rows, cols, vals, m, n_cols, block, nb, cap, cnt):
    """Pure-numpy plan fill: stable argsort by row, then fancy-indexed
    scatters. Within a block, slots are in row order (ties in input
    order); sentinel slots read column ``n_cols`` with value 0."""
    if vals is None:
        vals = np.ones((m,), np.float32)
    order = np.argsort(rows, kind="stable")
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    blk = rows_s // block
    starts = np.zeros(nb + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    slot = np.arange(m, dtype=np.int64) - starts[blk]
    in_main = slot < cap

    src_pad = np.full((nb, cap), n_cols, np.int64)   # sentinel -> reads 0
    val_pad = np.zeros((nb, cap), np.float32)
    off_pad = np.zeros((nb, cap), np.int64)
    b_main, s_main = blk[in_main], slot[in_main]
    src_pad[b_main, s_main] = cols_s[in_main]
    val_pad[b_main, s_main] = vals_s[in_main]
    off_pad[b_main, s_main] = rows_s[in_main] % block
    return ((src_pad // WIDTH).astype(np.int32),
            (src_pad % WIDTH).astype(np.int8),
            off_pad.astype(np.int32), val_pad,
            rows_s[~in_main], cols_s[~in_main], vals_s[~in_main])


def _onehot_contrib(src8, sel, oh_hi, oh_lo, x_ext) -> Tensor:
    """The core contraction: flat (B·block,) partial sums. ``x_ext`` is
    the width-padded 2-D table of x. The segment sum is one batched f32
    product of the two one-hot factors (TF32 off)."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    _highest_precision()
    g = x_ext[src8.long()]                              # (B, C, W)
    w = (g * sel).sum(-1)                               # exact select
    contrib = torch.bmm(oh_hi.transpose(1, 2), oh_lo * w[..., None])
    return contrib.reshape(-1)                          # (B·HI'·LO,)


def _overflow_add(y: Tensor, ov, x: Tensor, n_rows: int) -> Tensor:
    """Accumulate the overflow COO triple (cols, rows, vals) into ``y``
    (in place: ``y`` is a fresh result of the caller's)."""
    ov_c, ov_r, ov_v = ov
    w_ov = gather_1d(x.float(), ov_c) * ov_v
    return y.index_add_(0, ov_r, w_ov)


def spmv_apply(plan_static, arrays, x: Tensor) -> Tensor:
    """y = A·x over the expanded tables. ``plan_static`` is
    (n_rows, n_cols, block); ``arrays`` is plan.arrays(device)."""
    n_rows, n_cols, block = plan_static
    src8, sel, oh_hi, oh_lo = arrays[:4]
    y = _onehot_contrib(src8, sel, oh_hi, oh_lo,
                        _ext_table(x.float()))[:n_rows]
    if len(arrays) > 4:
        y = _overflow_add(y, arrays[4:], x, n_rows)
    return y


_SPMM_B_CHUNK = 128   # blocks per scatter chunk: bounds the (chunk, C,
                      # LO·k) one-hot⊗w intermediate


def spmm_apply(plan_static, arrays, extra, X: Tensor) -> Tensor:
    """k-wide SpMM over the expanded tables: Y = A·X for dense X
    (n_cols, k). One shared row gather serves every column; the scatter
    contracts oh_hi against (oh_lo ⊗ w) per chunk of blocks."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    _highest_precision()
    n_rows, n_cols, block = plan_static
    _, _, oh_hi, oh_lo = arrays[:4]
    src_full, val = extra
    k = X.shape[1]
    x_ext = torch.cat([X.float(), X.new_zeros((WIDTH, k), dtype=torch.float32)])
    w = x_ext[src_full] * val[..., None]                # (B, C, k)
    nb, cap = src_full.shape
    outs = []
    for b0 in range(0, nb, _SPMM_B_CHUNK):
        h = oh_hi[b0:b0 + _SPMM_B_CHUNK]
        l = oh_lo[b0:b0 + _SPMM_B_CHUNK]
        v = w[b0:b0 + _SPMM_B_CHUNK]
        rhs = (l[..., :, None] * v[..., None, :]).reshape(
            h.shape[0], cap, LO * k)
        outs.append(torch.bmm(h.transpose(1, 2), rhs))  # (ch, H', LO·k)
    y = torch.cat(outs).reshape(-1, k)[:n_rows]
    if len(arrays) > 4:
        y = _overflow_add_wide(y, arrays[4:], X, n_rows)
    return y


def _overflow_add_wide(y: Tensor, ov, X: Tensor, n_rows: int) -> Tensor:
    """k-wide overflow COO accumulation (in place into the fresh ``y``).
    Overflow ids are real columns (sentinels never overflow)."""
    ov_c, ov_r, ov_v = ov
    w_ov = X.float()[ov_c] * ov_v[:, None]
    return y.index_add_(0, ov_r, w_ov)


def spmm(plan: EdgeSpMVPlan, X: Tensor, col_chunk: int = 64) -> Tensor:
    """Y = A·X for a dense (n_cols, k) tensor, on X's device, ``col_chunk``
    columns at a time. k == 1 takes the matvec path."""
    X = X.float()
    if X.shape[1] == 0:
        return X.new_zeros((plan.n_rows, 0))
    if X.shape[1] == 1:
        return spmv(plan, X[:, 0])[:, None]
    static = (plan.n_rows, plan.n_cols, plan.block)
    arrays = plan.arrays(X.device)
    extra = plan.spmm_extra(X.device)
    outs = [spmm_apply(static, arrays, extra, X[:, j:j + col_chunk])
            for j in range(0, X.shape[1], col_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def spmv(plan: EdgeSpMVPlan, x: Tensor) -> Tensor:
    """y = A·x over the expanded tables, on x's device."""
    return spmv_apply((plan.n_rows, plan.n_cols, plan.block),
                      plan.arrays(x.device), x)
