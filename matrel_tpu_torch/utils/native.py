"""ctypes bridge to the native chain DP (``native/chain_dp.cc``) — the
counterpart of the chain-DP half of ``matrel_tpu/utils/native.py``.

The same plain C ABI (``matrel_chain_dp``, ``_comm``, ``_layout``,
``_topo``) built into this package's own library,
``build/native/libmatrel_chain_dp.so`` under the repository root, with
``g++ -O3 -fPIC -std=c++17 -shared`` at first use, and rebuilt when the
source is newer than the library. The JAX package's library under
``native/build/`` is never touched. Without a compiler (or a library)
:func:`chain_dp` returns None and ``ir/chain.py`` runs its Python DP,
the reference implementation — as the JAX package does.
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

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _stale() -> bool:
    return os.path.exists(SOURCE) and (
        not os.path.exists(LIB_PATH)
        or os.path.getmtime(SOURCE) > os.path.getmtime(LIB_PATH))


def _build() -> bool:
    """Compile the library; False when g++ is missing or fails. The
    output is written beside the target and renamed over it, so a
    process loading the library never sees a half-written file."""
    os.makedirs(os.path.dirname(LIB_PATH), exist_ok=True)
    tmp = f"{LIB_PATH}.{os.getpid()}.tmp"
    cmd = ["g++", "-O3", "-fPIC", "-std=c++17", "-shared", "-o", tmp,
           SOURCE]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, LIB_PATH)
        return True
    except (OSError, subprocess.SubprocessError) as e:
        log.debug("native chain-dp build failed: %s", e)
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
        if _stale() and not _build() and not os.path.exists(LIB_PATH):
            return None
        try:
            lib = ctypes.CDLL(LIB_PATH)
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
