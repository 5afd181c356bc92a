"""Compact-table SpMV and SpMM — the counterpart of
``matrel_tpu/ops/pallas_spmv.py`` (TPU kernels B2, ``_make_scatter_kernel``,
and B3, ``_make_scatter_kernel_k``).

An EdgeSpMVPlan's compact tables (``src8``/``lane``/``off``/``val``,
13 bytes a slot) are copied to the device once and memoised on the plan
(:func:`compact_tables`). From them the plan's CSR view is built once
(:func:`csr_view_on`, ``ops/csr_view.py``: the real slots ordered by
output row, a stable ``torch.sort``), and both kernels walk it: B2 a
sub-warp of lanes a row (the walk ``csrc/csr_walk.cuh`` that the routed
SpMV B8 shares, with x not split), B3 a group of lanes a row and one
lane per column or four. Each adds split(x[col] · val) — the product
split into ``passes`` bf16 parts as the TPU kernel does
(``ops/spmv_routed.py``) — into f64 registers in the view's order and
rounds each row to f32 once. The overflow COO is added outside the
kernels with ``index_add_``.

On a CUDA tensor the wrappers :func:`spmv_scatter` (B2) and
:func:`spmm_scatter` (B3) launch the hand-written Hopper kernels in
``csrc/spmv_compact.cu`` (built at first use, loaded with ctypes); on a
CPU tensor they run the plain walk of the view. :func:`spmv_scatter_plain`
and :func:`spmm_scatter_plain` compute the same functions from the
tables and are the kernels' yardsticks. A CUDA tensor launches the
kernel or raises; ``use_pallas=False`` asks for the plain versions on the
tables on any device.

:func:`compact_apply_chunked` splits the plan's row blocks into
stripes and runs B2 once per stripe (:func:`spmv_scatter_rows`, the
walk over that row range of the view); each row is walked as in one
launch, so its result is bit-equal to :func:`compact_apply`'s.

On a rank mesh :func:`compact_sharded_apply` (B2) and
:func:`compact_sharded_matmat_apply` (B3) run the kernel on each rank's
slice of block rows (``spmv.shard_plan``: sentinel-padded, its tables and
CSR view memoised on the slice's own plan), then one ``all_gather`` of
the rows and the overflow COO on every rank. B2 walks each row with the
whole plan's sub-warp width, so every row comes out as on one card.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from matrel_tpu_torch.config import MatrelConfig, pallas_enabled
from matrel_tpu_torch.ops import csr_view as csr_lib
from matrel_tpu_torch.ops import spmv as spmv_lib
from matrel_tpu_torch.ops.spmv_routed import (launch_walk, lanes_per_row,
                                              split_sum)

Tensor = torch.Tensor

LANE = 128

#: Kernel launches made by :func:`spmv_scatter` (B2) and
#: :func:`spmm_scatter` (B3), counted where each kernel is launched and
#: nowhere else.
LAUNCHES_SPMV = 0
LAUNCHES_SPMM = 0

SOURCE = "spmv_compact.cu"

#: Slot × column elements per step of the plain versions: bounds their
#: temporaries to a few hundred MB at BASELINE row-5 size.
_PLAIN_CHUNK_ELEMS = 1 << 23


def compact_enabled(config: Optional[MatrelConfig] = None) -> bool:
    """Do the compact-table kernels run? The shared kernel gate
    :func:`config.pallas_enabled`."""
    return pallas_enabled(config)


def _library() -> ctypes.CDLL:
    from matrel_tpu_torch.utils import cuda_build
    lib = cuda_build.load(SOURCE)
    if lib.matrel_spmv_compact.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.matrel_spmv_compact.argtypes = [p, p, p, p, ll, ll, i, i, i, p]
        lib.matrel_spmv_compact.restype = ctypes.c_int
        lib.matrel_spmm_compact.argtypes = [p, p, p, p, ll, ll, i, i, i, i,
                                            i, p]
        lib.matrel_spmm_compact.restype = ctypes.c_int
    return lib


def build() -> None:
    """Compile (if needed) and load the kernel library."""
    _library()


# -- plain versions ------------------------------------------------------------


def _slot_chunks(nb: int, cap: int, k: int):
    step = max(1, _PLAIN_CHUNK_ELEMS // max(cap * k, 1))
    return range(0, nb, step), step


def spmv_scatter_plain(src8: Tensor, lane: Tensor, off: Tensor, val: Tensor,
                       x: Tensor, n_rows: int, block: int = spmv_lib.BLOCK,
                       passes: int = 3) -> Tensor:
    """Plain PyTorch B2: y[b·block + off] += Σ_{p<passes} split(x[src8·8 +
    lane] · val)_p over every slot of (nb, cap) tables; sentinel columns
    (≥ len(x)) read 0. Products and parts are f32, the sums f64 (as the
    kernel's), rounded once. Returns y (n_rows,) f32."""
    nb, cap = src8.shape
    n_cols = x.shape[0]
    x_ext = torch.cat([x.float(), x.new_zeros(1, dtype=torch.float32)])
    y = torch.zeros(nb * block, dtype=torch.float64, device=x.device)
    starts, step = _slot_chunks(nb, cap, 1)
    for b0 in starts:
        sl = slice(b0, b0 + step)
        idx = src8[sl].long() * spmv_lib.WIDTH + lane[sl].long()
        w = x_ext[idx.clamp(max=n_cols)] * val[sl]
        dest = (torch.arange(b0, b0 + idx.shape[0], device=x.device)
                * block)[:, None] + off[sl].long()
        y.index_add_(0, dest.reshape(-1),
                     split_sum(w, passes).reshape(-1).double())
    return y[:n_rows].float()


def spmm_scatter_plain(src8: Tensor, lane: Tensor, off: Tensor, val: Tensor,
                       X: Tensor, n_rows: int, block: int = spmv_lib.BLOCK,
                       passes: int = 3) -> Tensor:
    """Plain PyTorch B3: the k-wide :func:`spmv_scatter_plain`,
    Y = A·X for X (n_cols, k). Returns Y (n_rows, k) f32."""
    nb, cap = src8.shape
    n_cols, k = X.shape
    X_ext = torch.cat([X.float(), X.new_zeros((1, k), dtype=torch.float32)])
    Y = torch.zeros((nb * block, k), dtype=torch.float64, device=X.device)
    starts, step = _slot_chunks(nb, cap, k)
    for b0 in starts:
        sl = slice(b0, b0 + step)
        idx = src8[sl].long() * spmv_lib.WIDTH + lane[sl].long()
        w = X_ext[idx.clamp(max=n_cols)] * val[sl][..., None]
        dest = (torch.arange(b0, b0 + idx.shape[0], device=X.device)
                * block)[:, None] + off[sl].long()
        Y.index_add_(0, dest.reshape(-1),
                     split_sum(w, passes).reshape(-1, k).double())
    return Y[:n_rows].float()


# -- kernel wrappers -------------------------------------------------------------


def _launch_device(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {dev}")


def spmv_scatter(view: csr_lib.CSRView, x: Tensor, passes: int = 3,
                 lanes: Optional[int] = None) -> Tensor:
    """B2: y (n_rows,) f32 = A·x from a plan's CSR view
    (:func:`csr_view_on`) and a dense f32 x (view.n_cols,). CUDA tensors
    launch the Hopper kernel on the current stream, ``lanes`` lanes a row
    (default :func:`~matrel_tpu_torch.ops.spmv_routed.lanes_per_row`);
    CPU tensors run the plain walk of the view."""
    global LAUNCHES_SPMV
    csr_lib.check_operands(view, x, passes, dense_dim=1)
    if x.device.type == "cpu":
        return csr_lib.csr_walk_plain(view, x, passes, split_x=False)
    y = launch_walk(_library().matrel_spmv_compact, "spmv_scatter", view, x,
                    passes, lanes)
    if view.n_rows:                 # an empty view launches nothing
        LAUNCHES_SPMV += 1
    return y


def spmv_scatter_rows(view: csr_lib.CSRView, x: Tensor, r0: int, r1: int,
                      out: Tensor, passes: int = 3) -> Tensor:
    """B2 over rows [r0, r1) of the view: writes ``out[r0:r1]`` of a
    (view.n_rows,) f32 ``out`` and returns ``out``. The sub-warp width
    is :func:`~matrel_tpu_torch.ops.spmv_routed.lanes_per_row` of the
    whole view, so each row is walked as :func:`spmv_scatter` walks it.
    CUDA tensors launch the Hopper kernel on the current stream (one
    launch, counted); CPU tensors run the plain walk of that range."""
    global LAUNCHES_SPMV
    csr_lib.check_operands(view, x, passes, dense_dim=1)
    if not 0 <= r0 <= r1 <= view.n_rows:
        raise ValueError(f"row range [{r0}, {r1}) outside [0, "
                         f"{view.n_rows}]")
    if (out.dtype != torch.float32 or tuple(out.shape) != (view.n_rows,)
            or out.device != x.device or not out.is_contiguous()):
        raise ValueError(f"out must be a contiguous ({view.n_rows},) f32 "
                         f"tensor on {x.device}")
    if x.device.type == "cpu":
        a, b = view.row_ptr[[r0, r1]].tolist()
        part = csr_lib.CSRView((view.row_ptr[r0:r1 + 1] - a).contiguous(),
                               view.cv[a:b], view.n_cols)
        out[r0:r1] = csr_lib.csr_walk_plain(part, x, passes, split_x=False)
        return out
    launch_walk(_library().matrel_spmv_compact, "spmv_scatter", view, x,
                passes, lanes_per_row(view.nnz, view.n_rows), rows=(r0, r1),
                out=out)
    if r1 > r0:                     # an empty range launches nothing
        LAUNCHES_SPMV += 1
    return out


def column_chunk(k: int) -> int:
    """Columns of X one group of lanes of the B3 kernel walks for a row:
    the next power of two ≥ k, at most 32 (wider X is walked in further
    chunks). A lane takes 4 of them with 16-byte loads where X allows,
    else one."""
    g = 1
    while g < min(k, 32):
        g *= 2
    return g


def spmm_scatter(view: csr_lib.CSRView, X: Tensor,
                 passes: int = 3) -> Tensor:
    """B3: Y (n_rows, k) f32 = A·X from a plan's CSR view
    (:func:`csr_view_on`) and a row-major dense f32 X (view.n_cols, k).
    CUDA tensors launch the Hopper kernel on the current
    stream; CPU tensors run the plain walk of the view."""
    global LAUNCHES_SPMM
    csr_lib.check_operands(view, X, passes, dense_dim=2)
    dev = X.device
    if dev.type == "cpu":
        return csr_lib.csr_walk_plain(view, X, passes, split_x=False)
    _launch_device(dev, "spmm_scatter")
    n_rows = view.n_rows
    k = X.shape[1]
    Y = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    if n_rows == 0 or k == 0:
        return Y.zero_()
    # 4 columns a lane: every X and Y row starts on a 16-byte boundary
    vec = int(k % 4 == 0 and X.data_ptr() % 16 == 0
              and Y.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.matrel_spmm_compact(
            view.row_ptr.data_ptr(), view.cv.data_ptr(), X.data_ptr(),
            Y.data_ptr(), n_rows, view.n_cols, k, column_chunk(k), vec,
            passes, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"spmm_scatter kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES_SPMM += 1
    return Y


# -- plan-level API --------------------------------------------------------------


def compact_tables(plan: spmv_lib.EdgeSpMVPlan, device
                   ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Device copies of the plan's compact layout (src8 int32, lane int8,
    off int32, val f32, each (nb, cap) contiguous), memoised on the plan
    per device."""
    key = spmv_lib._key(device)
    dev = plan._compact_dev.get(key)
    if dev is None:
        if plan.capacity % LANE:
            raise ValueError(f"capacity {plan.capacity} not a multiple of "
                             f"{LANE}")
        dev = tuple(torch.as_tensor(a, device=device).contiguous()
                    for a in (plan.src8, plan.lane, plan.off, plan.val))
        plan._compact_dev[key] = dev
    return dev


def csr_view_on(plan: spmv_lib.EdgeSpMVPlan, device) -> csr_lib.CSRView:
    """The CSR view of the slots B2 and B3 add, on ``device``:
    every slot but the sentinels (column ≥ n_cols, or off ≥ block), in
    row order, within a row in the plan's slot order (whatever the fill
    that laid it out). Built there from :func:`compact_tables` once (a
    stable ``torch.sort``) and memoised on the plan."""
    key = spmv_lib._key(device)
    view = plan._csr_dev.get(key)
    if view is None:
        src8, lane, off, val = compact_tables(plan, device)
        nb = src8.shape[0]
        cols = src8.long() * spmv_lib.WIDTH + lane.long()
        rows = (torch.arange(nb, device=src8.device)[:, None] * plan.block
                + off.long())
        keep = ((cols >= 0) & (cols < plan.n_cols) & (off >= 0)
                & (off < plan.block) & (rows < plan.n_rows))
        view = csr_lib.csr_view(rows[keep], cols[keep], val[keep],
                                plan.n_rows, plan.n_cols)
        plan._csr_dev[key] = view
    return view


def compact_apply(plan: spmv_lib.EdgeSpMVPlan, x: Tensor, passes: int = 3,
                  use_pallas: bool = True) -> Tensor:
    """y = A·x on x's device: one B2 launch over the plan's CSR view, or
    with ``use_pallas=False`` the plain version on the compact tables;
    then the overflow COO."""
    dev = x.device
    x = x.float().contiguous()
    if use_pallas:
        y = spmv_scatter(csr_view_on(plan, dev), x, passes)
    else:
        y = spmv_scatter_plain(*compact_tables(plan, dev), x, plan.n_rows,
                               plan.block, passes)
    ov = plan.overflow_on(dev)
    if ov:
        y = spmv_lib._overflow_add(y, ov, x, plan.n_rows)
    return y


def compact_apply_chunked(plan: spmv_lib.EdgeSpMVPlan, x: Tensor,
                          passes: int = 3, chunks: int = 4,
                          use_pallas: bool = True) -> Tensor:
    """y = A·x as :func:`compact_apply`, with the plan's row blocks split
    into ``chunks`` stripes of ⌈nb / chunks⌉ blocks and B2 launched once
    per stripe, over rows [s·block, e·block) of the CSR view (with
    ``use_pallas=False`` the plain version on the stripe's tables); the
    overflow COO is added once, after the stripes. Bit-equal to
    :func:`compact_apply`: every row's f64 sum runs over the same slots
    in the same order and rounds once."""
    dev = x.device
    x = x.float().contiguous()
    nb, block, n_rows = plan.src8.shape[0], plan.block, plan.n_rows
    step = -(-nb // max(chunks, 1))
    if use_pallas:
        view = csr_view_on(plan, dev)
        y = torch.empty(n_rows, dtype=torch.float32, device=dev)
        for s in range(0, nb, step):
            spmv_scatter_rows(view, x, min(s * block, n_rows),
                              min((s + step) * block, n_rows), y, passes)
    else:
        tables = compact_tables(plan, dev)
        y = torch.cat([
            spmv_scatter_plain(*(t[s:s + step] for t in tables), x,
                               min(step * block, n_rows - s * block),
                               block, passes)
            for s in range(0, nb, step)])
    ov = plan.overflow_on(dev)
    if ov:
        y = spmv_lib._overflow_add(y, ov, x, n_rows)
    return y


def compact_matmat_apply(plan: spmv_lib.EdgeSpMVPlan, X: Tensor,
                         passes: int = 3, use_pallas: bool = True) -> Tensor:
    """Y = A·X for dense X (n_cols, k) on X's device: one B3 launch over
    the plan's CSR view for all k columns, or with ``use_pallas=False``
    the plain version on the compact tables; then the overflow COO."""
    dev = X.device
    X = X.float().contiguous()
    if use_pallas:
        Y = spmm_scatter(csr_view_on(plan, dev), X, passes)
    else:
        Y = spmm_scatter_plain(*compact_tables(plan, dev), X, plan.n_rows,
                               plan.block, passes)
    ov = plan.overflow_on(dev)
    if ov:
        Y = spmv_lib._overflow_add_wide(Y, ov, X, plan.n_rows)
    return Y


def spmm_compact(plan: spmv_lib.EdgeSpMVPlan, X, passes: int = 3,
                 device=None, use_pallas: bool = True) -> Tensor:
    """Y = A·X via the compact tables on ``device`` (default: the card).
    k == 1 takes the matvec kernel, k == 0 returns zeros. passes=3 is
    f32-faithful; 2 only where ranking-grade error is acceptable."""
    from matrel_tpu_torch.core.mesh import resolve_device
    dev = resolve_device(device)
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    if X.shape[1] == 0:
        return X.new_zeros((plan.n_rows, 0))
    if X.shape[1] == 1:
        return spmv_compact(plan, X[:, 0], passes=passes, device=dev,
                            use_pallas=use_pallas)[:, None]
    return compact_matmat_apply(plan, X, passes, use_pallas)


def spmv_compact(plan: spmv_lib.EdgeSpMVPlan, x, passes: int = 3,
                 device=None, use_pallas: bool = True) -> Tensor:
    """y = A·x via the compact tables on ``device`` (default: the card).
    Numerically ~f32 at passes=3."""
    from matrel_tpu_torch.core.mesh import resolve_device
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
    return compact_apply(plan, x, passes, use_pallas)


# -- rank-mesh sharded -----------------------------------------------------------


def shard_compact_tables(plan: spmv_lib.EdgeSpMVPlan, mesh):
    """This rank's compact tables on its device: the sentinel-padded slice
    of block rows (``spmv.shard_plan``), memoised per (plan, mesh)."""
    return compact_tables(spmv_lib.shard_plan(plan, mesh).local, mesh.device)


def compact_sharded_apply(plan: spmv_lib.EdgeSpMVPlan, x: Tensor, mesh,
                          passes: int = 3, use_pallas: bool = True) -> Tensor:
    """y = A·x on a rank mesh: B2 over this rank's slice (or its plain
    version with ``use_pallas=False``), one all_gather, the overflow COO.
    Every rank gets the whole y."""
    sl = spmv_lib.shard_plan(plan, mesh)
    loc, dev = sl.local, x.device
    x = x.float().contiguous()
    if use_pallas:
        y_loc = spmv_scatter(csr_view_on(loc, dev), x, passes, sl.lanes)
    else:
        y_loc = spmv_scatter_plain(*shard_compact_tables(plan, mesh), x,
                                   loc.n_rows, loc.block, passes)
    y = spmv_lib.gather_rows(y_loc, sl, mesh)
    ov = plan.overflow_on(dev)
    return spmv_lib._overflow_add(y, ov, x, plan.n_rows) if ov else y


def compact_sharded_matmat_apply(plan: spmv_lib.EdgeSpMVPlan, X: Tensor,
                                 mesh, passes: int = 3,
                                 use_pallas: bool = True) -> Tensor:
    """Y = A·X on a rank mesh: B3 over this rank's slice, one
    all_gather, the overflow COO."""
    sl = spmv_lib.shard_plan(plan, mesh)
    loc, dev = sl.local, X.device
    X = X.float().contiguous()
    if use_pallas:
        Y_loc = spmm_scatter(csr_view_on(loc, dev), X, passes)
    else:
        Y_loc = spmm_scatter_plain(*shard_compact_tables(plan, mesh), X,
                                   loc.n_rows, loc.block, passes)
    Y = spmv_lib.gather_rows(Y_loc, sl, mesh)
    ov = plan.overflow_on(dev)
    return spmv_lib._overflow_add_wide(Y, ov, X, plan.n_rows) if ov else Y


def spmv_compact_sharded(plan: spmv_lib.EdgeSpMVPlan, x, mesh,
                         passes: int = 3, use_pallas: bool = True) -> Tensor:
    """y = A·x with the compact tables cut over the rank mesh."""
    x = torch.as_tensor(x, dtype=torch.float32,
                        device=mesh.device).reshape(-1)
    return compact_sharded_apply(plan, x, mesh, passes, use_pallas)
