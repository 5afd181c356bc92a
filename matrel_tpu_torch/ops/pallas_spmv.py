"""Compact-table SpMV and SpMM — the counterpart of
``matrel_tpu/ops/pallas_spmv.py`` (TPU kernels B2, ``_make_scatter_kernel``,
and B3, ``_make_scatter_kernel_k``).

An EdgeSpMVPlan's compact tables (``src8``/``lane``/``off``/``val``,
13 bytes a slot) are copied to the device once and memoised on the plan
(:func:`compact_tables`). One kernel per product reads them and does the
whole slot pipeline: gather ``x[src8·8 + lane]`` (the sentinel column
reads 0), multiply by ``val``, split the product into ``passes`` bf16
parts as the TPU kernel does (``ops/spmv_routed.py``) and add the parts
into the slot's output row. Row sums are f64, rounded once to f32, so
the order of the additions (atomic on the card) does not show. The
overflow COO is added outside the kernel with ``index_add_``.

On a CUDA tensor the wrappers :func:`spmv_scatter` (B2) and
:func:`spmm_scatter` (B3) launch the hand-written Hopper kernels in
``csrc/spmv_compact.cu`` (built at first use, loaded with ctypes); on a
CPU tensor they run the plain PyTorch versions beside them —
:func:`spmv_scatter_plain` / :func:`spmm_scatter_plain`, the same
function as gather, split and ``index_add_``. A CUDA tensor launches the
kernel or raises; ``use_pallas=False`` asks for the plain version on any
device.

The sharded variants and ``compact_apply_chunked`` are not ported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from matrel_tpu_torch.config import MatrelConfig, default_config
from matrel_tpu_torch.ops import spmv as spmv_lib
from matrel_tpu_torch.ops.spmv_routed import split_sum

Tensor = torch.Tensor

LANE = 128

#: Kernel launches made by :func:`spmv_scatter` (B2) and
#: :func:`spmm_scatter` (B3), counted where each kernel is launched and
#: nowhere else.
LAUNCHES_SPMV = 0
LAUNCHES_SPMM = 0

SOURCE = "spmv_compact.cu"

#: Widest column chunk one B3 CTA accumulates (each lane holds its
#: slot's kc floats of X in registers), and the shared-memory budget of
#: its accumulator (block × kc f64).
_MAX_KC = 16
_MAX_SMEM = 64 * 1024

#: Slot × column elements per step of the plain versions: bounds their
#: temporaries to a few hundred MB at BASELINE row-5 size.
_PLAIN_CHUNK_ELEMS = 1 << 23


def compact_enabled(config: Optional[MatrelConfig] = None) -> bool:
    """Do the compact-table kernels run (the counterpart of
    ``config.pallas_enabled``)? The port's gate is ``use_pallas`` alone:
    on a CPU tensor the kernel route runs its plain version."""
    return (config or default_config()).use_pallas


def _library() -> ctypes.CDLL:
    from matrel_tpu_torch.utils import cuda_build
    lib = cuda_build.load(SOURCE)
    if lib.matrel_spmv_compact.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.matrel_spmv_compact.argtypes = [p, p, p, p, p, p, i, i, i, ll,
                                            ll, i, i, p]
        lib.matrel_spmv_compact.restype = ctypes.c_int
        lib.matrel_spmm_compact.argtypes = [p, p, p, p, p, p, i, i, i, ll,
                                            ll, i, i, i, i, i, p]
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


def _check(src8, lane, off, val, x, n_rows, block, passes, vector: bool):
    if src8.dim() != 2 or src8.shape[1] % 32:
        raise ValueError(f"tables must be (nb, cap) with cap a multiple of "
                         f"32, got {tuple(src8.shape)}")
    for name, t, dt in (("src8", src8, torch.int32), ("lane", lane, torch.int8),
                        ("off", off, torch.int32), ("val", val, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.shape != src8.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != src8 shape "
                             f"{tuple(src8.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"dense operand must be float32, got {x.dtype}")
    if x.dim() != (1 if vector else 2):
        raise ValueError(f"dense operand must be {'1' if vector else '2'}-D, "
                         f"got {tuple(x.shape)}")
    devs = {t.device for t in (src8, lane, off, val, x)}
    if len(devs) != 1:
        raise ValueError(f"operands on different devices: "
                         f"{sorted(map(str, devs))}")
    if not all(t.is_contiguous() for t in (src8, lane, off, val, x)):
        raise ValueError("compact SpMV needs contiguous tensors")
    if passes not in (1, 2, 3):
        raise ValueError(f"passes must be 1, 2 or 3, got {passes}")
    if block < 1 or block % spmv_lib.LO:
        raise ValueError(f"block must be a positive multiple of "
                         f"{spmv_lib.LO}, got {block}")
    if not 0 <= n_rows <= src8.shape[0] * block:
        raise ValueError(f"n_rows {n_rows} outside the tables' "
                         f"{src8.shape[0]} blocks of {block}")


def _launch_device(dev: torch.device, name: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on CUDA or CPU tensors, got {dev}")


def spmv_scatter(src8: Tensor, lane: Tensor, off: Tensor, val: Tensor,
                 x: Tensor, n_rows: int, block: int = spmv_lib.BLOCK,
                 passes: int = 3) -> Tensor:
    """B2: y (n_rows,) f32 from compact tables and a dense f32 vector x.
    CUDA tensors launch the Hopper kernel on the current stream; CPU
    tensors run :func:`spmv_scatter_plain`."""
    global LAUNCHES_SPMV
    _check(src8, lane, off, val, x, n_rows, block, passes, vector=True)
    dev = x.device
    if dev.type == "cpu":
        return spmv_scatter_plain(src8, lane, off, val, x, n_rows, block,
                                  passes)
    _launch_device(dev, "spmv_scatter")
    nb, cap = src8.shape
    if block * 8 > 48 * 1024:
        raise ValueError(f"block {block} too large for the B2 kernel")
    y = torch.empty(n_rows, dtype=torch.float32, device=dev)
    if n_rows == 0 or nb == 0 or cap == 0:
        return y.zero_()
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.matrel_spmv_compact(
            src8.data_ptr(), lane.data_ptr(), off.data_ptr(), val.data_ptr(),
            x.data_ptr(), y.data_ptr(), nb, cap, block, x.shape[0], n_rows,
            passes, dev.index, stream)
    if rc != 0:
        raise RuntimeError(f"spmv_scatter kernel launch failed: CUDA error "
                           f"{rc}")
    LAUNCHES_SPMV += 1
    return y


def column_chunk(k: int, block: int) -> int:
    """Columns one B3 CTA accumulates: the next power of two ≥ k, at
    most 16 and at most what a (block × kc) f64 accumulator fits in
    64 KB of shared memory."""
    kc = 1
    while kc < min(k, _MAX_KC):
        kc *= 2
    while kc > 1 and block * kc * 8 > _MAX_SMEM:
        kc //= 2
    return kc


def spmm_scatter(src8: Tensor, lane: Tensor, off: Tensor, val: Tensor,
                 X: Tensor, n_rows: int, block: int = spmv_lib.BLOCK,
                 passes: int = 3) -> Tensor:
    """B3: Y (n_rows, k) f32 = A·X from compact tables and a row-major
    dense f32 X (n_cols, k). CUDA tensors launch the Hopper kernel on the
    current stream; CPU tensors run :func:`spmm_scatter_plain`."""
    global LAUNCHES_SPMM
    _check(src8, lane, off, val, X, n_rows, block, passes, vector=False)
    dev = X.device
    if dev.type == "cpu":
        return spmm_scatter_plain(src8, lane, off, val, X, n_rows, block,
                                  passes)
    _launch_device(dev, "spmm_scatter")
    nb, cap = src8.shape
    k = X.shape[1]
    kc = column_chunk(k, block)
    if block * kc * 8 > _MAX_SMEM:
        raise ValueError(f"block {block} too large for the B3 kernel")
    Y = torch.empty((n_rows, k), dtype=torch.float32, device=dev)
    if n_rows == 0 or k == 0 or nb == 0 or cap == 0:
        return Y.zero_()
    # 16-byte loads of X rows: every row (and every 4-column chunk) starts
    # on a 16-byte boundary
    x_vec = int(k % 4 == 0 and X.data_ptr() % 16 == 0)
    lib = _library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.matrel_spmm_compact(
            src8.data_ptr(), lane.data_ptr(), off.data_ptr(), val.data_ptr(),
            X.data_ptr(), Y.data_ptr(), nb, cap, block, X.shape[0], n_rows,
            k, kc, x_vec, passes, dev.index, stream)
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


def compact_apply(plan_static, tables, ov, x: Tensor, passes: int = 3,
                  use_pallas: bool = True) -> Tensor:
    """y = A·x from compact tables. ``plan_static`` is (n_rows, n_cols,
    block); ``tables`` from :func:`compact_tables`; ``ov`` the overflow
    COO on the same device (possibly empty). ``use_pallas=False`` runs
    the plain version."""
    n_rows, n_cols, block = plan_static
    fn = spmv_scatter if use_pallas else spmv_scatter_plain
    y = fn(*tables, x.float().contiguous(), n_rows, block, passes)
    if ov:
        y = spmv_lib._overflow_add(y, ov, x, n_rows)
    return y


def compact_matmat_apply(plan_static, tables, ov, X: Tensor,
                         passes: int = 3, use_pallas: bool = True) -> Tensor:
    """Y = A·X for dense X (n_cols, k) from compact tables: one kernel
    launch for all k columns (the kernel walks them in chunks)."""
    n_rows, n_cols, block = plan_static
    fn = spmm_scatter if use_pallas else spmm_scatter_plain
    Y = fn(*tables, X.float().contiguous(), n_rows, block, passes)
    if ov:
        Y = spmv_lib._overflow_add_wide(Y, ov, X, n_rows)
    return Y


def _static(plan: spmv_lib.EdgeSpMVPlan):
    return (plan.n_rows, plan.n_cols, plan.block)


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
    return compact_matmat_apply(_static(plan), compact_tables(plan, dev),
                                plan.overflow_on(dev), X, passes, use_pallas)


def spmv_compact(plan: spmv_lib.EdgeSpMVPlan, x, passes: int = 3,
                 device=None, use_pallas: bool = True) -> Tensor:
    """y = A·x via the compact tables on ``device`` (default: the card).
    Numerically ~f32 at passes=3."""
    from matrel_tpu_torch.core.mesh import resolve_device
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(-1)
    return compact_apply(_static(plan), compact_tables(plan, dev),
                         plan.overflow_on(dev), x, passes, use_pallas)
