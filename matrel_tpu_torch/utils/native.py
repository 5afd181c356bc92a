"""ctypes bridges to the native chain DP (``native/chain_dp.cc``), the
native text readers (``native/mtx_reader.cc``) and the native SpMV plan
fill (``native/spmv_plan.cc``) — the counterpart of
``matrel_tpu/utils/native.py``.

The same plain C ABIs (``matrel_chain_dp``, ``_comm``, ``_layout``,
``_topo``; ``matrel_mtx_open``, ``matrel_coo_csv_open``,
``matrel_parse_fill``, ``matrel_parse_close``; ``matrel_spmv_counts``,
``matrel_spmv_fill``) built into this package's own libraries under
``build/native/`` at the repository root (``libmatrel_chain_dp.so``,
``libmatrel_ingest.so``, ``libmatrel_spmv_plan.so``), with ``g++ -O3
-fPIC -std=c++17 -shared`` at first use, and rebuilt when the source is
newer than the library. The JAX package's library under
``native/build/`` is never touched. Without a compiler (or a library)
:func:`chain_dp` returns None and ``ir/chain.py`` runs its Python DP,
:func:`mtx_read` / :func:`coo_csv_read` return None and ``io.py``
parses with scipy / numpy, and :func:`spmv_counts` / :func:`spmv_fill`
return None and ``ops/spmv.py`` fills its plan with numpy — as the JAX
package does.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

log = logging.getLogger("matrel_tpu_torch.native")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCE = os.path.join(_REPO_ROOT, "native", "chain_dp.cc")
LIB_PATH = os.path.join(_REPO_ROOT, "build", "native",
                        "libmatrel_chain_dp.so")
INGEST_SOURCE = os.path.join(_REPO_ROOT, "native", "mtx_reader.cc")
INGEST_LIB_PATH = os.path.join(_REPO_ROOT, "build", "native",
                               "libmatrel_ingest.so")
SPMV_SOURCE = os.path.join(_REPO_ROOT, "native", "spmv_plan.cc")
SPMV_LIB_PATH = os.path.join(_REPO_ROOT, "build", "native",
                             "libmatrel_spmv_plan.so")

_lock = threading.Lock()  # matlint: disable=ML017 import-time guard of the native library cache, never held across a query
_lib: Optional[ctypes.CDLL] = None
_tried = False
_ingest_lib: Optional[ctypes.CDLL] = None
_ingest_tried = False
_spmv_lib: Optional[ctypes.CDLL] = None
_spmv_tried = False


def _is_stale(source: str, target: str) -> bool:
    return os.path.exists(source) and (
        not os.path.exists(target)
        or os.path.getmtime(source) > os.path.getmtime(target))


def _compile(source: str, target: str, flags=()) -> bool:
    """Compile one library; False when g++ is missing or fails. The
    output is written beside the target and renamed over it, so a
    process loading the library never sees a half-written file."""
    os.makedirs(os.path.dirname(target), exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-std=c++17", *flags, "-shared", "-o",
           tmp, source]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.debug("native build of %s failed: %s", source, e)
        if os.path.exists(tmp):
            os.remove(tmp)
        return False


def _bind(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    cost = ctypes.POINTER(ctypes.c_double)
    i32, f64 = ctypes.c_int32, ctypes.c_double
    sigs = {
        "matrel_chain_dp": [i32, i64p, f64p, i32p, cost],
        "matrel_chain_dp_comm": [i32, i64p, f64p, i32, i32, f64, i32, i32p,
                                 cost],
        "matrel_chain_dp_layout": [i32, i64p, f64p, i8p, i32, i32, f64, i32,
                                   i32p, cost],
        "matrel_chain_dp_topo": [i32, i64p, f64p, i8p, i32, i32, f64, i32,
                                 f64, f64, i32p, cost],
    }
    for name, argtypes in sigs.items():
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = argtypes


def load() -> Optional[ctypes.CDLL]:
    """The native library, built if needed; None if unavailable."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if (_is_stale(SOURCE, LIB_PATH) and not _compile(SOURCE, LIB_PATH)
                and not os.path.exists(LIB_PATH)):
            return None
        try:
            lib = ctypes.CDLL(LIB_PATH)  # matlint: disable=ML009 host C++ library (g++), not a kernel — the JAX package's utils/native.py counterpart
            _bind(lib)
        except (OSError, AttributeError) as e:
            log.debug("native chain-dp load failed: %s", e)
            return None
        _lib = lib
        return _lib


def chain_dp(dims: Sequence[int], densities: Sequence[float],
             grid: Tuple[int, int] = (1, 1),
             comm_weight: Optional[float] = None,
             itemsize: int = 4,
             layouts: Optional[Sequence[int]] = None,
             weights: Optional[Tuple[float, float]] = None
             ) -> Optional[Tuple[np.ndarray, float]]:
    """Run the native interval DP. ``dims`` has n+1 entries, densities
    n. With grid != (1, 1) the step cost adds the comm term
    (``ir/stats.chain_step_cost`` semantics); non-trivial ``layouts``
    (``ir/stats.LAYOUT_CODES``) make it layout-aware, and non-uniform
    per-axis ``weights`` topology-aware. Returns (split table [n, n]
    int32, total cost), or None when the library is unavailable."""
    lib = load()
    if lib is None:
        return None
    n = len(densities)
    if len(dims) != n + 1:
        raise ValueError("dims must have len(densities)+1 entries")
    dims_arr = np.ascontiguousarray(dims, dtype=np.int64)
    dens_arr = np.ascontiguousarray(densities, dtype=np.float64)
    splits = np.zeros((n, n), dtype=np.int32)
    cost = ctypes.c_double(0.0)
    gx, gy = grid
    if gx * gy > 1:
        if comm_weight is None:
            from matrel_tpu_torch.ir.stats import COMM_FLOPS_PER_BYTE
            comm_weight = COMM_FLOPS_PER_BYTE
        cw = float(comm_weight)
        if layouts is not None and len(layouts) != n:
            raise ValueError("layouts must have one entry per operand")
        if weights is not None and tuple(weights) != (1.0, 1.0):
            # topology weights change the comm term of every layout
            lays_arr = np.ascontiguousarray(
                layouts if layouts is not None else [0] * n, dtype=np.int8)
            rc = lib.matrel_chain_dp_topo(
                n, dims_arr, dens_arr, lays_arr, int(gx), int(gy), cw,
                int(itemsize), float(weights[0]), float(weights[1]),
                splits.reshape(-1), ctypes.byref(cost))
        elif layouts is not None and any(layouts):
            lays_arr = np.ascontiguousarray(layouts, dtype=np.int8)
            rc = lib.matrel_chain_dp_layout(
                n, dims_arr, dens_arr, lays_arr, int(gx), int(gy), cw,
                int(itemsize), splits.reshape(-1), ctypes.byref(cost))
        else:
            rc = lib.matrel_chain_dp_comm(
                n, dims_arr, dens_arr, int(gx), int(gy), cw, int(itemsize),
                splits.reshape(-1), ctypes.byref(cost))
    else:
        rc = lib.matrel_chain_dp(n, dims_arr, dens_arr, splits.reshape(-1),
                                 ctypes.byref(cost))
    if rc != 0:
        return None
    return splits, float(cost.value)


# -- native text ingestion (mtx_reader.cc) ----------------------------------

_MTX_SYMMETRIC = 1
_MTX_SKEW = 4
_MTX_COMPLEX = 8


def _bind_ingest(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pi64 = ctypes.POINTER(ctypes.c_int64)
    lib.matrel_mtx_open.restype = ctypes.c_void_p
    lib.matrel_mtx_open.argtypes = [ctypes.c_char_p, pi64, pi64, pi64,
                                    ctypes.POINTER(ctypes.c_int32)]
    lib.matrel_coo_csv_open.restype = ctypes.c_void_p
    lib.matrel_coo_csv_open.argtypes = [ctypes.c_char_p, pi64]
    lib.matrel_parse_fill.restype = ctypes.c_int64
    lib.matrel_parse_fill.argtypes = [ctypes.c_void_p, i64p, i64p, f64p,
                                      ctypes.c_int64]
    lib.matrel_parse_close.restype = None
    lib.matrel_parse_close.argtypes = [ctypes.c_void_p]


def load_ingest() -> Optional[ctypes.CDLL]:
    """The native reader library, built if needed; None if unavailable."""
    global _ingest_lib, _ingest_tried
    with _lock:
        if _ingest_lib is not None or _ingest_tried:
            return _ingest_lib
        _ingest_tried = True
        if (_is_stale(INGEST_SOURCE, INGEST_LIB_PATH)
                and not _compile(INGEST_SOURCE, INGEST_LIB_PATH,
                                 ("-pthread",))
                and not os.path.exists(INGEST_LIB_PATH)):
            return None
        try:
            lib = ctypes.CDLL(INGEST_LIB_PATH)  # matlint: disable=ML009 host C++ library (g++), not a kernel — the JAX package's utils/native.py counterpart
            _bind_ingest(lib)
        except (OSError, AttributeError) as e:
            log.debug("native ingest load failed: %s", e)
            return None
        _ingest_lib = lib
        return _ingest_lib


def _fill(lib, h, cap: int):
    """Parse an opened handle's data section into fresh buffers of
    ``cap`` entries; (rows, cols, vals) trimmed, or None on a parse
    error. Closes the handle."""
    try:
        ri = np.empty(cap, dtype=np.int64)
        ci = np.empty(cap, dtype=np.int64)
        vals = np.empty(cap, dtype=np.float64)
        got = lib.matrel_parse_fill(h, ri, ci, vals, cap)
    finally:
        lib.matrel_parse_close(h)
    if got < 0:
        return None
    return ri[:got], ci[:got], vals[:got]


def mtx_read(path: str) -> Optional[Tuple[Tuple[int, int], np.ndarray,
                                          np.ndarray, np.ndarray]]:
    """Parse a MatrixMarket file natively: ((rows, cols), row_idx,
    col_idx, values) with symmetry expanded (mirror, or negated mirror
    for skew, of the off-diagonal entries); None when the library is
    unavailable or the file needs the scipy fallback (complex field,
    parse error)."""
    lib = load_ingest()
    if lib is None:
        return None
    r, c, nnz = ctypes.c_int64(0), ctypes.c_int64(0), ctypes.c_int64(0)
    flags = ctypes.c_int32(0)
    h = lib.matrel_mtx_open(path.encode(), ctypes.byref(r),
                            ctypes.byref(c), ctypes.byref(nnz),
                            ctypes.byref(flags))
    if not h:
        return None
    if flags.value & _MTX_COMPLEX:
        lib.matrel_parse_close(h)
        return None
    parsed = _fill(lib, h, max(1, nnz.value))
    if parsed is None:
        return None
    ri, ci, vals = parsed
    if flags.value & _MTX_SYMMETRIC:
        off = ri != ci
        mv = -vals[off] if flags.value & _MTX_SKEW else vals[off]
        ri, ci = (np.concatenate([ri, ci[off]]),
                  np.concatenate([ci, ri[off]]))
        vals = np.concatenate([vals, mv])
    return (r.value, c.value), ri, ci, vals


def coo_csv_read(path: str) -> Optional[Tuple[np.ndarray, np.ndarray,
                                              np.ndarray]]:
    """Parse 'i,j[,value]' coordinate text natively (0-based indices as
    stored): (row_idx, col_idx, values), or None if unavailable."""
    lib = load_ingest()
    if lib is None:
        return None
    n = ctypes.c_int64(0)
    h = lib.matrel_coo_csv_open(path.encode(), ctypes.byref(n))
    if not h:
        return None
    return _fill(lib, h, max(1, int(n.value)))


# -- native SpMV plan layout (spmv_plan.cc) ---------------------------------


def _bind_spmv(lib: ctypes.CDLL) -> None:
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64 = ctypes.c_int64
    lib.matrel_spmv_counts.restype = ctypes.c_int
    lib.matrel_spmv_counts.argtypes = [i64p, i64, i64, i64, i64p]
    lib.matrel_spmv_fill.restype = ctypes.c_int64
    lib.matrel_spmv_fill.argtypes = [
        i64p, i64p, ctypes.c_void_p, i64, i64, i64, i64, i64,
        ctypes.c_int32, i32p, i8p, i32p, f32p, i64p, i64p, f32p, i64]


def load_spmv() -> Optional[ctypes.CDLL]:
    """The native SpMV plan-fill library, built if needed; None if
    unavailable."""
    global _spmv_lib, _spmv_tried
    with _lock:
        if _spmv_lib is not None or _spmv_tried:
            return _spmv_lib
        _spmv_tried = True
        if (_is_stale(SPMV_SOURCE, SPMV_LIB_PATH)
                and not _compile(SPMV_SOURCE, SPMV_LIB_PATH)
                and not os.path.exists(SPMV_LIB_PATH)):
            return None
        try:
            lib = ctypes.CDLL(SPMV_LIB_PATH)  # matlint: disable=ML009 host C++ library (g++), not a kernel — the JAX package's utils/native.py counterpart
            _bind_spmv(lib)
        except (OSError, AttributeError) as e:
            log.debug("native spmv-plan load failed: %s", e)
            return None
        _spmv_lib = lib
        return _spmv_lib


def spmv_counts(rows: np.ndarray, block: int, nb: int
                ) -> Optional[np.ndarray]:
    """Per-block edge counts (pass 1 of the plan build); None if the
    native path is unavailable or a row lies outside [0, nb·block)."""
    lib = load_spmv()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    counts = np.zeros(nb, dtype=np.int64)
    rc = lib.matrel_spmv_counts(rows, rows.shape[0], block, nb, counts)
    return counts if rc == 0 else None


def spmv_fill(rows: np.ndarray, cols: np.ndarray,
              vals: Optional[np.ndarray], n_cols: int, block: int,
              nb: int, cap: int, width: int, n_overflow: int):
    """Pass 2: scatter edges into the padded (nb, cap) plan tables in
    input order. Returns (src8, lane, off, val, ov_rows, ov_cols,
    ov_vals), or None when unavailable or the fill disagrees with
    ``n_overflow``."""
    lib = load_spmv()
    if lib is None:
        return None
    rows = np.ascontiguousarray(rows, dtype=np.int64)
    cols = np.ascontiguousarray(cols, dtype=np.int64)
    m = rows.shape[0]
    src8 = np.empty((nb, cap), dtype=np.int32)
    lane = np.empty((nb, cap), dtype=np.int8)
    off = np.empty((nb, cap), dtype=np.int32)
    val = np.empty((nb, cap), dtype=np.float32)
    ov_cap = max(1, n_overflow)
    ov_r = np.empty(ov_cap, dtype=np.int64)
    ov_c = np.empty(ov_cap, dtype=np.int64)
    ov_v = np.empty(ov_cap, dtype=np.float32)
    vptr = None
    if vals is not None:
        vals = np.ascontiguousarray(vals, dtype=np.float32)
        vptr = vals.ctypes.data_as(ctypes.c_void_p)
    got = lib.matrel_spmv_fill(rows, cols, vptr, m, n_cols, block, nb,
                               cap, width, src8.reshape(-1),
                               lane.reshape(-1), off.reshape(-1),
                               val.reshape(-1), ov_r, ov_c, ov_v, ov_cap)
    if got < 0 or got != n_overflow:
        return None
    return (src8, lane, off, val, ov_r[:got], ov_c[:got], ov_v[:got])
