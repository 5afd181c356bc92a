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

The plan build runs on the host: the native counting-sort fill
(``native/spmv_plan.cc`` through ``utils/native.py``, two O(m) passes)
where its library loads, else the numpy fill (``_numpy_fill``: a stable
argsort by row). Both give the same slots for a block; the native fill
keeps them in input order, the numpy fill in row order (ties in input
order), and each edge past a block's capacity goes to the overflow COO
(with the native fill, the block's last edges in input order; with the
numpy fill, its last edges in row order). :func:`save_plan` /
:func:`load_plan` persist a plan's compact layout as one ``.npz`` in the
JAX package's format, so a file saved by either package loads in the
other.

On a rank mesh (``core/mesh.init_distributed``) :func:`shard_plan` cuts a
plan's block rows over the ranks (:class:`PlanSlice`: the block axis
padded to the rank count with sentinel slots, this rank's run of blocks
a plan of its own), :func:`spmv_sharded` / :func:`spmm_sharded` contract
each rank's slice against the replicated x over the expanded tables, one
``all_gather`` assembles y and the overflow COO is added on every rank;
the compact executor's sharded form is ``pallas_spmv.compact_sharded_apply``.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Dict, Optional, Tuple

import numpy as np
import torch

WIDTH = 8        # gather row width of the compact layout
BLOCK = 512      # scatter block: destination rows per plan block
HI = 32          # off = hi*LO + lo one-hot factor sizes; HI*LO == BLOCK
LO = 16

Tensor = torch.Tensor

# The process umask, read once (os.umask can only be read by setting it):
# save_plan gives its file the mode a plain open() would.
_UMASK = os.umask(0)
os.umask(_UMASK)


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
    one-hot tables, the compact tables, the CSR view, the overflow) are
    built lazily, once per device, and memoised on the plan. ``fill``
    names the fill that laid the tables out ("native" or "numpy"; a
    loaded plan says "loaded").
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
    fill: str = "numpy"
    _tables: Dict[str, tuple] = dataclasses.field(default_factory=dict,
                                                  repr=False)
    _spmm_tables: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False)
    _overflow_dev: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False)
    _compact_dev: Dict[str, tuple] = dataclasses.field(
        default_factory=dict, repr=False)
    _csr_dev: Dict[str, object] = dataclasses.field(
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
    """Host-side plan build (once per graph): the native counting-sort
    fill where its library loads, else the numpy fill (``plan.fill``
    says which ran).

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
        n_rows = int(rows.max()) + 1 if m else 1  # matlint: disable=ML001 host numpy edge list of the plan build, no device
    if n_cols is None:
        n_cols = int(cols.max()) + 1 if m else 1  # matlint: disable=ML001 host numpy edge list of the plan build, no device
    if vals is not None:
        vals = np.asarray(vals, dtype=np.float32)
    if block % LO:
        raise ValueError("block must be a multiple of LO")
    if m and (rows.min() < 0 or rows.max() >= n_rows
              or cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("edge indices out of bounds for "
                         f"({n_rows}, {n_cols})")

    nb = -(-n_rows // block)
    from matrel_tpu_torch.utils import native as native_lib
    cnt = native_lib.spmv_counts(rows, block, nb)
    use_native = cnt is not None
    if not use_native:
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
    n_ov = int(np.maximum(cnt - cap, 0).sum())  # matlint: disable=ML001 host numpy block counts of the plan build, no device
    filled = native_lib.spmv_fill(rows, cols, vals, n_cols, block, nb, cap,
                                  WIDTH, n_ov) if use_native else None
    fill = "native" if filled is not None else "numpy"
    if filled is None:
        filled = _numpy_fill(rows, cols, vals, m, n_cols, block, nb, cap,
                             cnt)
    src8, lane, off, val, ov_r64, ov_c64, ov_v = filled
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
        padding_ratio=(nb * cap + n_ov) / max(m, 1),
        fill=fill)


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


def save_plan(path: str, plan: EdgeSpMVPlan) -> None:
    """Persist a plan's compact layout as one ``.npz`` (the JAX package's
    format): ``meta`` = [n_rows, n_cols, block, capacity, 1, WIDTH, LO]
    — the format version and the constants baked into src8/lane/off —
    then ``padding_ratio``, the four tables and the overflow COO when
    there is one. The file is written beside ``path`` and renamed over
    it, with the mode the process umask gives a new file."""
    payload = dict(
        meta=np.asarray([plan.n_rows, plan.n_cols, plan.block,
                         plan.capacity, 1, WIDTH, LO], np.int64),
        padding_ratio=np.asarray([plan.padding_ratio], np.float64),
        src8=np.asarray(plan.src8), lane=np.asarray(plan.lane),
        off=np.asarray(plan.off), val=np.asarray(plan.val))
    if plan.ov_rows is not None:
        payload.update(ov_rows=np.asarray(plan.ov_rows),
                       ov_cols=np.asarray(plan.ov_cols),
                       ov_vals=np.asarray(plan.ov_vals))
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(os.path.abspath(path)),
                               suffix=".tmp")
    try:
        os.fchmod(fd, 0o666 & ~_UMASK)  # mkstemp's 0600 ignores the umask
        with os.fdopen(fd, "wb") as f:
            np.savez_compressed(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_plan(path: str) -> EdgeSpMVPlan:
    """Load a plan saved by :func:`save_plan` (by either package). A file
    saved under another format version or other WIDTH / LO constants
    raises ``ValueError``."""
    with np.load(path) as z:
        meta = [int(v) for v in z["meta"]]
        n_rows, n_cols, block, cap = meta[:4]
        version, width, lo = (meta[4:7] if len(meta) >= 7 else (0, -1, -1))
        if version != 1 or width != WIDTH or lo != LO:
            raise ValueError(
                f"plan file {path!r} was saved with format v{version} "
                f"(WIDTH={width}, LO={lo}); this build expects v1 "
                f"(WIDTH={WIDTH}, LO={LO}) — rebuild the plan")
        has_ov = "ov_rows" in z.files
        return EdgeSpMVPlan(
            n_rows=n_rows, n_cols=n_cols, block=block, capacity=cap,
            src8=z["src8"], lane=z["lane"], off=z["off"], val=z["val"],
            ov_rows=z["ov_rows"] if has_ov else None,
            ov_cols=z["ov_cols"] if has_ov else None,
            ov_vals=z["ov_vals"] if has_ov else None,
            padding_ratio=float(z["padding_ratio"][0]), fill="loaded")


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


# -- rank-mesh sharded --------------------------------------------------------


def compact_pad_fills(n_cols: int) -> dict:
    """Sentinel fill values for padded slots/blocks of the compact
    layout, shared by every sharding path: src8·WIDTH + lane = n_cols
    points past x (reads 0 / is dropped from a CSR view), val 0 kills
    any contribution."""
    return {"src8": n_cols // WIDTH, "lane": n_cols % WIDTH,
            "off": 0, "val": 0.0}


@dataclasses.dataclass
class PlanSlice:
    """One rank's share of a plan's block rows: ``local`` is a plan of
    its own over blocks [rank·per, (rank + 1)·per) of the block axis
    padded to ``size``·per with sentinel slots (``n_rows`` = per·block,
    no overflow), so its device tables and CSR view are memoised on it
    and never confused with the whole plan's. ``plan`` keeps the whole
    plan's rows and overflow COO; ``lanes`` is the B2 sub-warp width of
    the whole plan's view, so each row is walked as on one card."""
    plan: EdgeSpMVPlan
    local: EdgeSpMVPlan
    rank: int
    size: int
    lanes: int


def shard_plan(plan: EdgeSpMVPlan, mesh) -> PlanSlice:
    """This rank's :class:`PlanSlice` of ``plan`` on the rank mesh,
    memoised on the plan per mesh."""
    from matrel_tpu_torch.ops.spmv_routed import lanes_per_row
    memo = plan.__dict__.setdefault("_slices", {})
    hit = memo.get(id(mesh))
    if hit is not None and hit[0] is mesh:
        return hit[1]
    p, rank = mesh.size, mesh.ranks.rank
    nb, cap = plan.src8.shape
    per = -(-nb // p)
    lo, hi = rank * per, min((rank + 1) * per, nb)
    fills = compact_pad_fills(plan.n_cols)

    def cut(a, fill):
        part = np.asarray(a)[lo:hi] if lo < nb else np.asarray(a)[:0]
        if part.shape[0] < per:
            part = np.concatenate(
                [part, np.full((per - part.shape[0], cap), fill,
                               np.asarray(a).dtype)])
        return np.ascontiguousarray(part)

    local = EdgeSpMVPlan(
        n_rows=per * plan.block, n_cols=plan.n_cols, block=plan.block,
        capacity=cap, src8=cut(plan.src8, fills["src8"]),
        lane=cut(plan.lane, fills["lane"]), off=cut(plan.off, fills["off"]),
        val=cut(plan.val, fills["val"]), ov_cols=None, ov_rows=None,
        ov_vals=None, padding_ratio=plan.padding_ratio, fill=plan.fill)
    cols = plan.src8.astype(np.int64) * WIDTH + plan.lane
    rows = (np.arange(nb)[:, None] * plan.block + plan.off)
    real = ((cols < plan.n_cols) & (plan.off < plan.block)
            & (rows < plan.n_rows))
    sl = PlanSlice(plan, local, rank, p,
                   lanes_per_row(int(real.sum()), plan.n_rows))  # matlint: disable=ML001 host numpy plan tables, once per plan and mesh (memoised)
    memo[id(mesh)] = (mesh, sl)
    return sl


def gather_rows(y_loc: Tensor, sl: PlanSlice, mesh) -> Tensor:
    """The ranks' row slices of y assembled in rank order (one
    ``all_gather`` over the world) and cut to the plan's rows."""
    from matrel_tpu_torch.parallel import collectives as coll
    return coll.all_gather(y_loc, mesh, None, dim=0)[:sl.plan.n_rows]


def spmv_sharded_apply(sl: PlanSlice, x: Tensor, mesh) -> Tensor:
    """y = A·x over a rank's slice of the expanded tables: the slice's
    contraction against the replicated x, one all_gather, then the
    overflow COO (every rank adds the same)."""
    loc = sl.local
    x = x.float()
    y_loc = spmv_apply((loc.n_rows, loc.n_cols, loc.block),
                       loc.arrays(x.device), x)
    y = gather_rows(y_loc, sl, mesh)
    ov = sl.plan.overflow_on(x.device)
    return _overflow_add(y, ov, x, sl.plan.n_rows) if ov else y


def spmm_sharded_apply(sl: PlanSlice, X: Tensor, mesh) -> Tensor:
    """The k-wide :func:`spmv_sharded_apply` (Y = A·X)."""
    loc = sl.local
    X = X.float()
    dev = X.device
    y_loc = spmm_apply((loc.n_rows, loc.n_cols, loc.block),
                       loc.arrays(dev), loc.spmm_extra(dev), X)
    y = gather_rows(y_loc, sl, mesh)
    ov = sl.plan.overflow_on(dev)
    return _overflow_add_wide(y, ov, X, sl.plan.n_rows) if ov else y


def spmv_sharded(plan: EdgeSpMVPlan, x: Tensor, mesh) -> Tensor:
    """y = A·x with the plan's block rows cut over the rank mesh
    (:func:`shard_plan`); every rank gets the whole y."""
    return spmv_sharded_apply(shard_plan(plan, mesh),
                              torch.as_tensor(x, device=mesh.device), mesh)


def spmm_sharded(plan: EdgeSpMVPlan, X: Tensor, mesh,
                 col_chunk: int = 64) -> Tensor:
    """Y = A·X over the rank mesh, ``col_chunk`` columns at a time."""
    X = torch.as_tensor(X, device=mesh.device).float()
    if X.shape[1] == 0:
        return X.new_zeros((plan.n_rows, 0))
    if X.shape[1] == 1:
        return spmv_sharded(plan, X[:, 0], mesh)[:, None]
    sl = shard_plan(plan, mesh)
    outs = [spmm_sharded_apply(sl, X[:, j:j + col_chunk], mesh)
            for j in range(0, X.shape[1], col_chunk)]
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
