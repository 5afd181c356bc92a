#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (matrel_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port's main path from the sources in
   this checkout (nvcc, sm_90a) and prints nvcc's register report.
2. Kernel phase: holds each kernel against its plain PyTorch version on
   the card — block-sparse SpMM (ops/pallas_spmm.py) in f32 and bf16 at
   bs 4, 8, 16, 24, 64 and 512, with empty block rows, a single block
   row and a column count that is not a multiple of the column tile —
   and times it at the BASELINE row-4 shape with CUDA events beside the
   plain version, its bound and one PyTorch library call.
3. Path phases, through MatrelSession().compute on the default device,
   with every kernel's launch count set to 0 just before and read just
   after: BASELINE row 4 (block-sparse x dense, 100,352^2 at 1% of
   512-blocks, bf16, plus the D'·S form), row 2 (skewed A·B·C, 10,000 x
   100, f32, plan (A·(B·C))) and row 1 (4096^2 f32 multiply). Results
   are checked against the plain kernel version or a float64 numpy
   oracle.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when there is no CUDA device or a phase fails.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet, dense, 700 W).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

# Tolerances of a kernel against its plain version on the same inputs.
# Both accumulate in f32 in different orders: f32 outputs differ by
# f32 rounding of sums of up to a few thousand terms; bf16 outputs are
# rounded once from such sums, so they may differ by one bf16 ulp
# (2^-7 relative) more.
TOL = {"float32": (1e-4, 1e-3), "bfloat16": (1e-2, 1e-2)}   # (rtol, atol)


T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:7.1f} s] {msg}", flush=True)


def device_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, warmup: int = 3, runs: int = 15) -> float:
    """Median over ``runs`` single calls, each between two CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def check_close(name: str, got, want, dtype_name: str,
                rows_per_step: int = 8192) -> float:
    """Max |got - want|; raises unless every entry is within the dtype's
    tolerance and finite. Compared in f32, a slab of rows at a time so
    the check adds little device memory."""
    import torch
    rtol, atol = TOL[dtype_name]
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    max_err, n_bad = 0.0, 0
    for r in range(0, got.shape[0], rows_per_step):
        g = got[r:r + rows_per_step].float()
        w = want[r:r + rows_per_step].float()
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite output")
        err = (g - w).abs()
        n_bad += int((err > atol + rtol * w.abs()).sum())
        if err.numel():
            max_err = max(max_err, float(err.max()))
    if n_bad:
        raise AssertionError(f"{name}: {n_bad} entries outside rtol={rtol} "
                             f"atol={atol}, max abs err {max_err}")
    return max_err


def make_case(bs, n, k, density, dtype, seed, mesh):
    """A random block-sparse S (n x k) with ~1/4 of its block rows empty
    (when it has more than one) and random normal payloads."""
    import numpy as np
    import torch
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    rng = np.random.default_rng(seed)
    gr, gc = math.ceil(n / bs), math.ceil(k / bs)
    flat = np.sort(rng.choice(gr * gc, size=max(1, int(round(
        gr * gc * density))), replace=False))
    rows, cols = flat // gc, flat % gc
    if gr > 1:
        empty = rng.choice(gr, size=max(1, gr // 4), replace=False)
        keep = ~np.isin(rows, empty)
        if keep.any():
            rows, cols = rows[keep], cols[keep]
    gen = torch.Generator(device=mesh.device).manual_seed(seed)
    blocks = torch.randn((len(rows), bs, bs), generator=gen,
                         device=mesh.device).to(dtype)
    dev = mesh.device
    return BlockSparseMatrix(
        blocks=blocks,
        block_rows=torch.as_tensor(rows.astype(np.int32), device=dev),
        block_cols=torch.as_tensor(cols.astype(np.int32), device=dev),
        shape=(n, k), block_size=bs, mesh=mesh)


def spmm_bound(S, pm: int, out_rows: int, dtype_name: str):
    """(bound_ms, bound_by): bytes this run's data needs (each tile, each
    touched D row block and each output element once) over HBM
    bandwidth vs its FLOPs over the dtype's peak."""
    bs = S.block_size
    isz = S.blocks.element_size()
    touched = int(S.block_cols.unique().numel())
    nbytes = (S.nnzb * bs * bs + touched * bs * pm + out_rows * pm) * isz
    flops = 2.0 * S.nnzb * bs * bs * pm
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_phase(mesh):
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    cases = [  # (bs, n, k, pm, density, output rows)
        (4, 37, 29, 9, 0.4, 37),
        (8, 203, 150, 77, 0.3, 203),
        (16, 400, 320, 130, 0.2, 437),  # rows past the tile grid: zeros
        (24, 100, 96, 33, 0.5, 100),
        (64, 1000, 700, 200, 0.1, 1000),
        (64, 50, 1000, 64, 0.5, 50),    # a single block row
        (512, 4096, 4096, 520, 0.1, 4096),  # pm not a multiple of 64
    ]
    for dtype_name in ("float32", "bfloat16"):
        dtype = getattr(torch, dtype_name)
        for i, (bs, n, k, pm, dens, rows) in enumerate(cases):
            S = make_case(bs, n, k, dens, dtype, 100 + i, mesh)
            gen = torch.Generator(device=mesh.device).manual_seed(200 + i)
            d = torch.randn((k, pm), generator=gen,
                            device=mesh.device).to(dtype)
            _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
            got = pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d,
                                               rows)
            want = pallas_spmm.spmm_blocksparse_plain(
                S.blocks, S.block_rows, S.block_cols, d, rows)
            torch.cuda.synchronize()
            err = check_close(f"spmm {dtype_name} bs={bs} n={n} k={k} "
                              f"pm={pm} rows={rows}", got, want, dtype_name)
            log(f"kernel spmm_blocksparse {dtype_name} bs={bs} n={n} k={k} "
                f"pm={pm} rows={rows} nnzb={S.nnzb}: max_abs_err={err:.3e}"
                f" ok")


def row4_inputs(sess):
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    n, bs, pm = 100_352, 512, 512
    S = BlockSparseMatrix.random((n, n), 0.01, block_size=bs,
                                 mesh=sess.mesh, seed=1, dtype="bfloat16")
    D = sess.random((n, pm), dtype="bfloat16", seed=2)
    return S, D


def row4_timing(S, D, library):
    """Kernel vs plain at the row-4 shape (bf16), beside the bound and
    the library yardstick measured by :func:`library_yardstick`."""
    from matrel_tpu_torch.ops import pallas_spmm
    n = S.shape[0]
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
    d = D.data
    got = pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d, n)
    want = pallas_spmm.spmm_blocksparse_plain(S.blocks, S.block_rows,
                                              S.block_cols, d, n)
    err = check_close("spmm row-4 shape", got, want, "bfloat16")
    del got, want
    ms = time_ms(lambda: pallas_spmm.spmm_blocksparse(payload, row_ptr,
                                                      bcols, d, n))
    plain_ms = time_ms(lambda: pallas_spmm.spmm_blocksparse_plain(
        S.blocks, S.block_rows, S.block_cols, d, n), warmup=1, runs=10)
    bound_ms, bound_by = spmm_bound(S, d.shape[1], n, "bfloat16")
    log(f"row-4 shape (bf16, nnzb={S.nnzb}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), library "
        f"{library['library_ms']} ms ({library['note']}); kernel vs plain "
        f"max_abs_err {err:.3e}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library["library_ms"]}


def csr_form(S):
    """The element-CSR form of S (int32 indices), built on the device
    block row by block row — the input of the library yardstick."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
    bs = S.block_size
    gr, gc = S.grid
    dev = payload.device
    rp = row_ptr.cpu().tolist()
    per_row = torch.tensor([(rp[b + 1] - rp[b]) * bs for b in range(gr)],
                           device=dev).repeat_interleave(bs)
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev),
                      per_row.cumsum(0)]).to(torch.int32)
    lane = torch.arange(bs, device=dev, dtype=torch.int32)
    vals, cols = [], []
    for b in range(gr):
        t0, t1 = rp[b], rp[b + 1]
        if t1 > t0:
            vals.append(payload[t0:t1].permute(1, 0, 2).reshape(-1))
            cols.append((bcols[t0:t1, None] * bs + lane).reshape(-1)
                        .repeat(bs))
    return torch.sparse_csr_tensor(crow, torch.cat(cols), torch.cat(vals),
                                   size=(gr * bs, gc * bs))


def library_yardstick() -> int:
    """Child process: time one PyTorch call computing Y = S·D on the
    row-4 inputs (same seeds) — ``torch.sparse.mm`` on the element-CSR
    form (cuSPARSE). The bf16 BSR form is not used: its Triton path did
    not finish a call within the time limit at this shape. Prints one
    JSON line."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import pallas_spmm
    sess = MatrelSession()
    S, D = row4_inputs(sess)
    n = S.shape[0]
    out = {"library_ms": None, "note": ""}
    try:
        csr = csr_form(S)
        got = torch.sparse.mm(csr, D.data)
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as ex:
        out["note"] = (f"torch.sparse.mm on the bf16 CSR form failed: "
                       f"{type(ex).__name__}: {str(ex).splitlines()[0][:160]}")
        print(json.dumps(out))
        return 0
    want = pallas_spmm.spmm_blocksparse_plain(S.blocks, S.block_rows,
                                              S.block_cols, D.data, n)
    diff = float((got[:n].float() - want.float()).abs().max())
    del got, want
    out["library_ms"] = time_ms(lambda: torch.sparse.mm(csr, D.data),
                                warmup=1, runs=10)
    out["note"] = (f"torch.sparse.mm, bf16 CSR (cuSPARSE), max_abs_diff vs "
                   f"plain {diff:.3e}")
    out["peak_gib"] = round(torch.cuda.max_memory_allocated() / 2**30, 3)
    print(json.dumps(out))
    return 0


def run_library_yardstick(timeout_s: float = 300.0) -> dict:
    """The library yardstick in a child process, killed past
    ``timeout_s``: a library call that does not finish must not stall
    the run."""
    try:
        proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                               "--library-yardstick"], capture_output=True,
                              text=True, timeout=timeout_s)
    except subprocess.TimeoutExpired:
        return {"library_ms": None,
                "note": f"torch.sparse.mm did not finish in {timeout_s:.0f} s"}
    if proc.returncode != 0:
        tail = (proc.stderr.strip().splitlines() or ["?"])[-1][:200]
        return {"library_ms": None,
                "note": f"yardstick process failed: {tail}"}
    return json.loads(proc.stdout.strip().splitlines()[-1])


def path_row4(sess, S, D):
    """Row 4 through compute: S·D and D'·S (the transpose branch)."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    n = S.shape[0]
    e, et = S.multiply(D), D.expr().t().multiply(S)
    Y = sess.compute(e)
    Yt = sess.compute(et)
    torch.cuda.synchronize()
    launches = pallas_spmm.LAUNCHES
    if launches < 2:
        raise AssertionError(f"row 4 path launched the SpMM kernel "
                             f"{launches} times (want >= 2)")
    if Y.shape != (n, D.shape[1]) or Yt.shape != (D.shape[1], n):
        raise AssertionError(f"row 4: result shapes {Y.shape}, {Yt.shape}")
    want = pallas_spmm.spmm_blocksparse_plain(S.blocks, S.block_rows,
                                              S.block_cols, D.data, n)
    e1 = check_close("row 4 S·D", Y.data, want, "bfloat16")
    del Y, want
    # (D'·S)ᵀ = Sᵀ·D: the plain version on the transposed tiles (a view)
    want_t = pallas_spmm.spmm_blocksparse_plain(
        S.blocks.transpose(1, 2), S.block_cols, S.block_rows, D.data, n)
    e2 = check_close("row 4 D'·S", Yt.data.T, want_t, "bfloat16")
    del Yt, want_t
    log(f"path row 4: S·D and D'·S through compute, {launches} kernel "
        f"launches, max_abs_err {e1:.3e} / {e2:.3e}")
    return launches, {"row4 S·D": e, "row4 D'·S": et}


def path_row2(sess):
    import numpy as np
    import torch
    from matrel_tpu_torch.workloads import chain_bench
    mats = chain_bench.skewed_abc(sess.mesh, n=10_000, mid=100, seed=3)
    e = chain_bench.build_chain(mats)
    plan = sess.compile(e)
    paren = chain_bench.parenthesisation(plan.optimized)
    if paren != "(A·(B·C))":
        raise AssertionError(f"row 2: plan {paren}, want (A·(B·C))")
    out = sess.compute(e).to_numpy()
    A, B, C = (m.to_numpy().astype(np.float64) for m in mats)
    ref = A @ (B @ C)
    rel = float(np.abs(out - ref).max() / np.abs(ref).max())
    if out.shape != ref.shape or not np.isfinite(out).all() or rel > 1e-5:
        raise AssertionError(f"row 2: rel err {rel} vs float64 oracle")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    log(f"path row 2: plan {paren}, max err / max|ref| = {rel:.3e} "
        f"vs float64 oracle")
    return {"row2 A·B·C": e}


def path_row1(sess):
    import numpy as np
    import torch
    X = sess.random((4096, 4096), seed=4)
    Y = sess.random((4096, 4096), seed=5)
    e = X.multiply(Y)
    out = sess.compute(e).to_numpy()
    ref = X.to_numpy().astype(np.float64) @ Y.to_numpy().astype(np.float64)
    rel = float(np.abs(out - ref).max() / np.abs(ref).max())
    if out.shape != ref.shape or not np.isfinite(out).all() or rel > 1e-5:
        raise AssertionError(f"row 1: rel err {rel} vs float64 oracle")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on")
    log(f"path row 1: 4096^2 f32 multiply, max err / max|ref| = "
        f"{rel:.3e} vs float64 oracle, TF32 off")
    return {"row1 4096^2": e}


def path_latency(sess, queries: dict) -> None:
    """Warm compute() latency of each path query (plan cached): CUDA
    events around the whole call, median of 10 (host planning and
    launch gaps included); then where the device time of each goes,
    from torch.profiler over 5 warm calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for name, e in queries.items():
        ms = time_ms(lambda: sess.compute(e), warmup=2, runs=10)
        log(f"latency {name}: {ms:.4f} ms per warm compute()")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                sess.compute(e)
            torch.cuda.synchronize()
        rows = []
        for ev in prof.key_averages():
            # device-side events only: a CPU op such as aten::mm also
            # carries the time of the kernels it launched
            if "CUDA" not in str(getattr(ev, "device_type", "")):
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0.0)
            if dev_us > 0:
                rows.append((dev_us / 5 / 1e3, ev.key))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        log(f"  device time per call {total:.4f} ms"
            + ("" if rows else " (the profiler saw no device time)"))
        for t, key in rows[:5]:
            log(f"    {t:.4f} ms  {key[:90]}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs one CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:] == ["--library-yardstick"]:
        return library_yardstick()
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import pallas_spmm
    from matrel_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    card = device_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    pallas_spmm.build()
    lib = cuda_build.library_path(cuda_build.CSRC_DIR / pallas_spmm.SOURCE)
    report = [l.strip() for l in lib.with_suffix(".log").read_text()
              .splitlines() if "registers" in l or "spill" in l]
    log(f"build: {time.perf_counter() - t0:.1f} s -> {lib.name}")
    for line in report:
        log(f"  ptxas: {line}")

    sess = MatrelSession()            # the default device: cuda
    torch.cuda.reset_peak_memory_stats()
    kernel_phase(sess.mesh)
    torch.cuda.empty_cache()
    library = run_library_yardstick()
    S, D = row4_inputs(sess)
    row = row4_timing(S, D, library)
    torch.cuda.empty_cache()

    pallas_spmm.LAUNCHES = 0          # the main path starts here
    launches, queries = path_row4(sess, S, D)
    queries.update(path_row2(sess))
    queries.update(path_row1(sess))
    peak = torch.cuda.max_memory_allocated()
    path_latency(sess, queries)       # after the launch count was read
    log(f"peak device memory {peak / 2**30:.3f} GiB (this process; the "
        f"yardstick process: {library.get('peak_gib')} GiB); total "
        f"{time.perf_counter() - t_start:.1f} s")

    kern = {"name": "spmm_blocksparse", "route": "cuda",
            "source": "matrel_tpu_torch/csrc/spmm_blocksparse.cu",
            "replaces": "matrel_tpu/ops/pallas_spmm.py:31",
            "launches": launches, "max_abs_err": row["max_abs_err"],
            "ms": row["ms"], "kernel_ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}
    print(card)
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
