"""Routed SpMV — the counterpart of ``matrel_tpu/ops/spmv_routed.py``
(TPU kernel B8: ``_make_gather_kernel`` and ``_make_scatter_kernel``).

The plan buckets a fixed edge list ``y[i] = Σ_{e: rows[e]=i} vals[e] ·
x[cols[e]]`` by (source group, destination group) cells, both groups
``SPAN`` = 16,384 wide, with one fixed capacity of slots a cell; each
slot holds its edge's offset inside the source group (``loc_src``),
inside the destination group (``loc_dst``) and its value (``val``, 0 in
padded slots). Edges past a cell's capacity go to an overflow COO. The
build is host numpy, line for line the JAX package's, so both packages
hold equal tables; here they are stored (g_s, g_d, cap) rather than in
the TPU's (…, cap/128, 128) tile layout.

The TPU kernels turn the gather and the scatter into one-hot matmuls,
because the TPU's gather engine is rate-limited per index and its matrix
unit is not. On Hopper a gather from x is an ordinary load (x, 4 MB at
BASELINE row 5, stays in the 50 MB L2), so the port computes the
FUNCTION and not that schedule. Once per plan and device the real slots
are ordered by output row into a CSR view (:meth:`RoutedSpMVPlan.csr_on`,
``ops/csr_view.py``); the kernel (``csrc/spmv_routed.cu``) walks each
row's slots with a sub-warp of :func:`lanes_per_row` lanes, gathers
``x[col]``, splits it into ``passes`` bf16-grid parts as the TPU kernel
does (:func:`_bf16_split`), multiplies by ``val``, splits the product the
same way and sums the parts in an f64 register; each output row is
rounded to f32 once and written once. No one-hot tensor, no atomics. The
overflow COO is added outside the kernel with an f64 ``index_add_``.

On a CUDA tensor :func:`routed_scatter` launches that kernel or raises;
on a CPU tensor it runs :func:`csr_scatter_plain`, the plain walk of the
same view. :func:`routed_scatter_plain` computes the function from the
plan's own tables (gather, split, product and f64 ``index_add_``) and is
the kernel's yardstick; ``use_pallas=False`` asks for it on any device.
The compact SpMV kernels share :func:`split_sum`.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from matrel_tpu_torch.ops import csr_view as csr_lib

Tensor = torch.Tensor

SPAN = 128 * 128          # source/destination group width
LANE = 128                # capacity granule (the TPU kernels' slot tile)

#: int32 view of the mask 0xFFFF0000: keeps sign, exponent and the top
#: 7 mantissa bits of an f32 — a value on the bf16 grid.
_HI16 = -(1 << 16)

#: Kernel launches made by :func:`routed_scatter` (B8), counted where
#: the kernel is launched and nowhere else.
LAUNCHES_ROUTED = 0

SOURCE = "spmv_routed.cu"

#: Slots per step of the plain version: bounds its temporaries to a few
#: hundred MB at BASELINE row-5 size.
_PLAIN_CHUNK_SLOTS = 1 << 23


def _bf16_split(v: torch.Tensor, passes: int) -> List[torch.Tensor]:
    """Residual bf16 decomposition: Σ parts ≈ v with error ~2^(-8·passes).

    Parts are carved by masking the low 16 bits of the f32 pattern
    (truncation toward zero), not by dtype casts, and come back as f32
    tensors whose values sit exactly on the bf16 grid. Each part and
    each residual is exact, so the sum of the first two parts is ``v``
    truncated to its leading 16 significant bits and the sum of all
    three is ``v`` itself."""
    parts = []
    rem = v.float().contiguous()
    for _ in range(passes):
        hi = (rem.view(torch.int32) & _HI16).view(torch.float32)
        parts.append(hi)
        rem = rem - hi
    return parts


def split_sum(v: torch.Tensor, passes: int) -> torch.Tensor:
    """Σ of the first ``passes`` parts of :func:`_bf16_split` — the value
    each slot contributes to the SpMV kernels' sums."""
    parts = _bf16_split(v, passes)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


# -- plan -----------------------------------------------------------------------


def _key(device) -> str:
    return str(torch.device(device))


@dataclasses.dataclass
class RoutedSpMVPlan:
    """Compiled routed layout for ``y[i] = Σ_{e: rows[e]=i} vals[e]·x[cols[e]]``.

    Host tables are (g_src, g_dst, cap) in source-major order:
    ``loc_src``/``loc_dst`` int32 offsets inside the edge's source/
    destination group (< SPAN), ``val`` f32 (0 in padded slots, which
    then add nothing). Overflow: optional (rows, cols, vals) int32/int32/
    f32 COO for edges past a cell's capacity, rows sorted ascending.
    Device copies and the CSR view are made once per device and memoised
    on the plan (:meth:`tables_on`, :meth:`csr_on`, :meth:`overflow_on`).
    """
    n_rows: int
    n_cols: int
    g_src: int
    g_dst: int
    cap: int
    loc_src: np.ndarray
    loc_dst: np.ndarray
    val: np.ndarray
    ov_rows: Optional[np.ndarray]
    ov_cols: Optional[np.ndarray]
    ov_vals: Optional[np.ndarray]
    padding_ratio: float
    _dev: Dict[str, tuple] = dataclasses.field(default_factory=dict,
                                               repr=False)
    _ov_dev: Dict[str, tuple] = dataclasses.field(default_factory=dict,
                                                  repr=False)
    _csr_dev: Dict[str, "csr_lib.CSRView"] = dataclasses.field(
        default_factory=dict, repr=False)

    @property
    def slots(self) -> int:
        return self.g_src * self.g_dst * self.cap

    def tables_on(self, device) -> tuple:
        """(loc_src, loc_dst, val) on ``device``, each (g_s, g_d, cap)
        contiguous; copied once per device."""
        key = _key(device)
        dev = self._dev.get(key)
        if dev is None:
            dev = tuple(torch.as_tensor(a, device=device).contiguous()
                        for a in (self.loc_src, self.loc_dst, self.val))
            self._dev[key] = dev
        return dev

    def overflow_on(self, device) -> tuple:
        """The overflow COO on ``device`` as (cols, rows, vals) — int64
        ids, f32 values — or ()."""
        if self.ov_rows is None:
            return ()
        key = _key(device)
        ov = self._ov_dev.get(key)
        if ov is None:
            ov = (torch.as_tensor(self.ov_cols, device=device).long(),
                  torch.as_tensor(self.ov_rows, device=device).long(),
                  torch.as_tensor(self.ov_vals, device=device))
            self._ov_dev[key] = ov
        return ov

    def csr_on(self, device) -> "csr_lib.CSRView":
        """The CSR view of the slots the kernel adds, on
        ``device``: real slots (val != 0, offsets inside their groups,
        row < n_rows, column < n_cols) ordered by output row, within a
        row by source group, then slot. Built there once (a stable
        ``torch.sort``) and memoised."""
        key = _key(device)
        view = self._csr_dev.get(key)
        if view is None:
            ls, ld, val = (torch.as_tensor(a, device=device)
                           for a in (self.loc_src, self.loc_dst, self.val))
            g_s, g_d, _ = ls.shape
            gs = torch.arange(g_s, device=ls.device).view(-1, 1, 1)
            gd = torch.arange(g_d, device=ls.device).view(1, -1, 1)
            rows = gd * SPAN + ld.long()
            cols = gs * SPAN + ls.long()
            keep = ((val != 0) & (ls >= 0) & (ls < SPAN) & (ld >= 0)
                    & (ld < SPAN) & (rows < self.n_rows)
                    & (cols < self.n_cols))
            view = csr_lib.csr_view(rows[keep], cols[keep], val[keep],
                                    self.n_rows, self.n_cols)
            self._csr_dev[key] = view
        return view


def build_routed_plan(rows, cols, vals=None, n_rows: int = None,
                      n_cols: int = None, *,
                      capacity_quantile: float = 0.997,
                      max_padding: float = 3.0,
                      max_slots: Optional[int] = None,
                      max_cap: int = 4096
                      ) -> Optional[RoutedSpMVPlan]:
    """Host-side plan build (numpy, once per graph).

    Cell capacity is the ``capacity_quantile`` of per-cell edge counts
    rounded up to a multiple of 128; edges past it go to the overflow
    COO. Returns None when the padded slot count exceeds
    ``max_padding``× the edge count, ``max_slots``, or when capacity
    exceeds ``max_cap`` — the JAX package's gates, kept so both packages
    accept and refuse the same graphs (the Hopper kernel itself takes any
    capacity)."""
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    m = rows.shape[0]
    if n_rows is None:
        n_rows = int(rows.max()) + 1 if m else 1  # matlint: disable=ML001 host numpy edge list of the plan build, no device
    if n_cols is None:
        n_cols = int(cols.max()) + 1 if m else 1  # matlint: disable=ML001 host numpy edge list of the plan build, no device
    if m and (rows.min() < 0 or rows.max() >= n_rows
              or cols.min() < 0 or cols.max() >= n_cols):
        raise ValueError("edge indices out of bounds for "
                         f"({n_rows}, {n_cols})")
    if vals is None:
        vals = np.ones((m,), np.float32)
    else:
        vals = np.asarray(vals, dtype=np.float32)

    g_s = max(1, -(-n_cols // SPAN))
    g_d = max(1, -(-n_rows // SPAN))
    n_cells = g_s * g_d
    cell = (cols // SPAN) * g_d + rows // SPAN
    cnt = np.bincount(cell, minlength=n_cells)
    if m == 0:
        cap = LANE
    else:
        pos = cnt[cnt > 0]
        cap_q = int(np.quantile(pos, capacity_quantile)) if pos.size else 0
        cap = max(LANE, -(-cap_q // LANE) * LANE)
    if cap > max_cap:
        return None
    if m and n_cells * cap > max_padding * m:
        return None
    if max_slots is not None and n_cells * cap > max_slots:
        return None

    order = np.argsort(cell, kind="stable")
    cell_s = cell[order]
    starts = np.zeros(n_cells + 1, np.int64)
    np.cumsum(cnt, out=starts[1:])
    slot = np.arange(m, dtype=np.int64) - starts[cell_s]
    in_main = slot < cap

    loc_src = np.zeros((n_cells, cap), np.int32)
    loc_dst = np.zeros((n_cells, cap), np.int32)
    val_t = np.zeros((n_cells, cap), np.float32)
    cm, sm = cell_s[in_main], slot[in_main]
    rows_s, cols_s, vals_s = rows[order], cols[order], vals[order]
    loc_src[cm, sm] = (cols_s % SPAN)[in_main]
    loc_dst[cm, sm] = (rows_s % SPAN)[in_main]
    val_t[cm, sm] = vals_s[in_main]

    n_ov = int(np.count_nonzero(~in_main))
    if n_ov:
        ov_r, ov_c, ov_v = (rows_s[~in_main], cols_s[~in_main],
                            vals_s[~in_main])
        o = np.argsort(ov_r, kind="stable")
        ov = (ov_r[o].astype(np.int32), ov_c[o].astype(np.int32),
              ov_v[o].astype(np.float32))
    else:
        ov = (None, None, None)

    shp = (g_s, g_d, cap)
    return RoutedSpMVPlan(
        n_rows=n_rows, n_cols=n_cols, g_src=g_s, g_dst=g_d, cap=cap,
        loc_src=loc_src.reshape(shp), loc_dst=loc_dst.reshape(shp),
        val=val_t.reshape(shp),
        ov_rows=ov[0], ov_cols=ov[1], ov_vals=ov[2],
        padding_ratio=(n_cells * cap + n_ov) / max(m, 1))


# -- kernel and plain versions ------------------------------------------------------


def _library() -> ctypes.CDLL:
    from matrel_tpu_torch.utils import cuda_build
    lib = cuda_build.load(SOURCE)
    if lib.matrel_spmv_routed.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.matrel_spmv_routed.argtypes = [p, p, p, p, ll, ll, i, i, i, p]
        lib.matrel_spmv_routed.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


def routed_scatter_plain(loc_src: Tensor, loc_dst: Tensor, val: Tensor,
                         x: Tensor, n_rows: int, passes: int = 2) -> Tensor:
    """Plain PyTorch B8 on the plan's own tables: y[gd·SPAN + loc_dst] +=
    split(split(x[gs·SPAN + loc_src]) · val) over every slot of cell
    (gs, gd), where split(v) is the sum of the first ``passes`` bf16-grid
    parts of v. Products and parts are f32, the sums f64 (as the
    kernel's), rounded once. Returns y (n_rows,) f32."""
    g_s, g_d, cap = loc_src.shape
    dev = x.device
    xs = torch.zeros(g_s * SPAN, dtype=torch.float32, device=dev)
    xs[: x.shape[0]] = split_sum(x, passes)
    y = torch.zeros(g_d * SPAN, dtype=torch.float64, device=dev)
    ls, ld, vv = (t.reshape(-1) for t in (loc_src, loc_dst, val))
    cell_slots = g_d * cap                  # slots of one source group
    step = max(cap, _PLAIN_CHUNK_SLOTS // cap * cap)
    for s0 in range(0, ls.numel(), step):
        pos = torch.arange(s0, min(s0 + step, ls.numel()), device=dev)
        gs = pos // cell_slots
        gd = (pos // cap) % g_d
        w = xs[gs * SPAN + ls[pos].long()] * vv[pos]
        y.index_add_(0, gd * SPAN + ld[pos].long(),
                     split_sum(w, passes).double())
    return y[:n_rows].float()


def csr_scatter_plain(view: csr_lib.CSRView, x: Tensor,
                      passes: int = 2) -> Tensor:
    """Plain PyTorch walk of the plan's CSR view (:meth:`RoutedSpMVPlan.
    csr_on`) — the kernel's schedule on the CPU: y[r] = Σ over row r's
    slots of split(split(x[col]) · val), f64 sums rounded once. Returns
    y (n_rows,) f32."""
    return csr_lib.csr_walk_plain(view, x, passes, split_x=True)


def lanes_per_row(nnz: int, n_rows: int) -> int:
    """Lanes of the sub-warp that walks one output row: the largest
    power of two at most the mean row length, within [1, 32] (8 at
    BASELINE row 5's ~10 slots a row)."""
    mean = nnz / max(n_rows, 1)
    lanes = 1
    while lanes < 32 and 2 * lanes <= mean:
        lanes *= 2
    return lanes


def launch_walk(entry, name: str, view: csr_lib.CSRView, x: Tensor,
                passes: int, lanes: Optional[int], rows=None,
                out: Optional[Tensor] = None) -> Tensor:
    """y (n_rows,) f32 from one launch of a row walk over ``view``
    (``csrc/csr_walk.cuh``) on x's CUDA device and current stream:
    ``entry`` is the ctypes function of B2 or B8, which share the walk's
    signature; ``lanes`` lanes a row (default :func:`lanes_per_row` of
    the whole view). ``rows`` = (r0, r1) walks only those rows, into
    ``out[r0:r1]`` of a given (n_rows,) f32 ``out``: the launch reads
    ``row_ptr`` and writes y from row r0 on, and ``row_ptr`` holds
    positions in the whole ``cv``. The operands are checked by the
    caller; an empty range launches nothing. Raises if the launch
    fails."""
    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {dev}")
    n_rows = view.n_rows
    r0, r1 = (0, n_rows) if rows is None else rows
    if lanes is None:
        lanes = lanes_per_row(view.nnz, n_rows)
    if lanes not in (1, 2, 4, 8, 16, 32):
        raise ValueError(f"lanes must be a power of two in [1, 32], got "
                         f"{lanes}")
    y = (torch.empty(n_rows, dtype=torch.float32, device=dev)
         if out is None else out)
    if r1 == r0:
        return y
    itemsize = 4                    # int32 row_ptr, f32 y
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = entry(view.row_ptr.data_ptr() + itemsize * r0,
                   view.cv.data_ptr(), x.data_ptr(),
                   y.data_ptr() + itemsize * r0, r1 - r0, view.n_cols,
                   passes, lanes, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    return y


def routed_scatter(view: csr_lib.CSRView, x: Tensor, passes: int = 2,
                   lanes: Optional[int] = None) -> Tensor:
    """B8: y (n_rows,) f32 from a plan's CSR view and a dense f32 x
    (view.n_cols,). CUDA tensors launch the Hopper
    kernel on the current stream, ``lanes`` lanes a row (default
    :func:`lanes_per_row`); CPU tensors run :func:`csr_scatter_plain`."""
    global LAUNCHES_ROUTED
    csr_lib.check_operands(view, x, passes, dense_dim=1)
    if x.device.type == "cpu":
        return csr_scatter_plain(view, x, passes)
    y = launch_walk(_library().matrel_spmv_routed, "spmv_routed", view, x,
                    passes, lanes)
    if view.n_rows:                 # an empty view launches nothing
        LAUNCHES_ROUTED += 1
    return y


# -- plan-level API --------------------------------------------------------------


def routed_spmv(plan: RoutedSpMVPlan, x, passes: int = 2, device=None,
                use_pallas: bool = True) -> Tensor:
    """y = A·x on ``device`` (default: the card). ``passes`` sets the
    bf16 residual-split depth on both value sides: 2 → ~2^-16 relative
    error (default), 3 → f32-faithful. The kernel walks the plan's CSR
    view; ``use_pallas=False`` runs :func:`routed_scatter_plain` on the
    plan's tables."""
    from matrel_tpu_torch.core.mesh import resolve_device
    dev = resolve_device(device)
    xf = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
    xf = xf.contiguous()
    if xf.shape != (plan.n_cols,):
        raise ValueError(f"x shape {tuple(xf.shape)} != ({plan.n_cols},)")
    if use_pallas:
        y = routed_scatter(plan.csr_on(dev), xf, passes)
    else:
        y = routed_scatter_plain(*plan.tables_on(dev), xf, plan.n_rows,
                                 passes)
    ov = plan.overflow_on(dev)
    if ov:
        # f32 products as the JAX package's, summed in f64 like the
        # kernel's: a hot row's overflow holds thousands of terms, whose
        # f32 sum alone would miss the f32-faithful bound of passes 3
        ov_c, ov_r, ov_v = ov
        w_ov = (xf[ov_c] * ov_v).double()
        y = y.double().index_add_(0, ov_r, w_ov).float()
    return y
