#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (matrel_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port's main paths from the sources in
   this checkout (one nvcc per source, all started together; sm_90a) and
   prints nvcc's register report.
2. Kernel phases: holds each kernel against its plain PyTorch version on
   the card — block-sparse SpMM B1 (ops/pallas_spmm.py) in f32 and bf16
   at bs 4, 8, 16, 24, 64 and 512, with empty block rows, a single block
   row and a column count that is not a multiple of the column tile; the
   compact SpMV B2 and SpMM B3 (ops/pallas_spmv.py) at passes 2 and 3
   with a block of zero slots, n_rows not a multiple of 512, an overflow
   hub row, sentinel slots, and B3 at k = 2, 5, 16 and 128 — and times
   each at its BASELINE shape with CUDA events beside the plain version,
   its bound and one PyTorch library call.
3. Path phases, through the entry points a user calls on the default
   device, with every kernel's launch count set to 0 just before each
   and read just after: BASELINE row 5 (PageRank, 30 rounds over
   1,000,000 nodes and 10,000,000 edges, impl="onehot", against a
   float64 scipy power iteration; then A·x, x'·A and A·X with X 1M x 16
   on the same graph as a COOMatrix through MatrelSession().compute),
   row 4 (block-sparse x dense, 100,352^2 at 1% of 512-blocks, bf16,
   plus the D'·S form), row 2 (skewed A·B·C, 10,000 x 100, f32, plan
   (A·(B·C))) and row 1 (4096^2 f32 multiply). Results are checked
   against the plain kernel versions or a float64 oracle.

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


def time_ms(fn, warmup: int = 3, runs: int = 15, batch: int = 1) -> float:
    """Median over ``runs`` samples of the time per call, each sample
    ``batch`` calls back to back between two CUDA events (a batch keeps
    the host's launch cost out of a short kernel's time)."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(batch):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / batch)
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


# B2/B3 against their plain versions, relative to max|plain|: both add
# the same split parts in f32, in different orders (shared-memory
# atomics vs index_add_). The passes=2 bound is the JAX package's own
# (tests/test_spmv.py).
SPMV_REL_TOL = {3: 1e-6, 2: 1e-4}
#: compact SpMV with its overflow COO vs a float64 oracle at passes=3
#: (the JAX package's overflow bound) and at passes=2 (truncated parts).
SPMV_ORACLE_TOL = {3: 1e-5, 2: 1e-4}
ROW5_N, ROW5_EDGES, ROW5_ROUNDS, ROW5_K = 1_000_000, 10_000_000, 30, 16


def rel_err(name: str, got, want, tol: float) -> float:
    """max|got - want| after checking shape, finiteness and
    max|got - want| <= tol * max|want|."""
    import torch
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = float((got.double() - want.double()).abs().max())
    scale = float(want.double().abs().max())
    if err > tol * scale:
        raise AssertionError(f"{name}: max abs err {err} > {tol} x "
                             f"max|want| {scale}")
    return err


def spmv_case(n_rows, n_cols, m, seed, hub=None, empty_blocks=()):
    """A random edge list and its plan; ``hub`` sends 30% of the edges
    to one row (overflow), ``empty_blocks`` get no edges at all."""
    import numpy as np
    from matrel_tpu_torch.ops import spmv as spmv_lib
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, m)
    if hub is not None:
        rows = np.where(rng.random(m) < 0.3, hub, rows)
    if empty_blocks:
        moved = np.isin(rows // spmv_lib.BLOCK, empty_blocks)
        rows = np.where(moved, (rows + spmv_lib.BLOCK) % n_rows, rows)
    cols = rng.integers(0, n_cols, m)
    vals = rng.standard_normal(m).astype(np.float32)
    plan = spmv_lib.build_spmv_plan(rows, cols, vals, n_rows=n_rows,
                                    n_cols=n_cols)
    return rows, cols, vals, plan


def spmv_kernel_phase(dev) -> None:
    """B2 and B3 against their plain versions on the card, and the whole
    compact product (overflow included) against a float64 oracle."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    cases = [  # (name, n_rows, n_cols, edges, hub, empty blocks)
        ("blocks 1 and 3 with zero slots, n_rows % 512 = 452",
         2500, 1999, 20_000, None, (1, 3)),
        ("overflow hub row", 4096, 512, 20_000, 7, ()),
        ("mostly sentinel slots, n_cols % 8 = 0", 1000, 4096, 3_000,
         None, ()),
        ("one block", 300, 77, 500, None, ()),
    ]
    for i, (name, n_rows, n_cols, m, hub, empty) in enumerate(cases):
        rows, cols, vals, plan = spmv_case(n_rows, n_cols, m, 300 + i, hub,
                                           empty)
        if (hub is not None) != (plan.ov_rows is not None):
            raise AssertionError(f"{name}: overflow {plan.ov_rows is not None}")
        tables = pc.compact_tables(plan, dev)
        ov = plan.overflow_on(dev)
        static = (plan.n_rows, plan.n_cols, plan.block)
        rng = np.random.default_rng(400 + i)
        x_np = rng.standard_normal(n_cols).astype(np.float32)
        X_np = rng.standard_normal((n_cols, 128)).astype(np.float32)
        x = torch.as_tensor(x_np, device=dev)
        X = torch.as_tensor(X_np, device=dev)
        want = np.zeros((n_rows, 128))
        np.add.at(want, rows, vals[:, None].astype(np.float64)
                  * X_np[cols].astype(np.float64))
        want_x = np.zeros(n_rows)
        np.add.at(want_x, rows, vals.astype(np.float64) * x_np[cols])
        for passes in (3, 2):
            tol = SPMV_REL_TOL[passes]
            y = pc.spmv_scatter(*tables, x, n_rows, plan.block, passes)
            yp = pc.spmv_scatter_plain(*tables, x, n_rows, plan.block,
                                       passes)
            torch.cuda.synchronize()
            err = rel_err(f"B2 {name} passes={passes}", y, yp, tol)
            for b in empty:
                if y[b * 512:(b + 1) * 512].abs().max() != 0:
                    raise AssertionError(f"B2 {name}: block {b} not zero")
            full = pc.compact_apply(static, tables, ov, x, passes)
            e_or = rel_err(f"B2+overflow {name} passes={passes} vs float64",
                           full.cpu(), torch.as_tensor(want_x),
                           SPMV_ORACLE_TOL[passes])
            log(f"kernel spmv_compact [{name}] passes={passes}: max_abs_err "
                f"{err:.3e} vs plain, {e_or:.3e} vs float64 oracle ok")
            for k in (2, 5, 16, 128):
                Xk = X[:, :k].contiguous()
                Y = pc.spmm_scatter(*tables, Xk, n_rows, plan.block, passes)
                Yp = pc.spmm_scatter_plain(*tables, Xk, n_rows, plan.block,
                                           passes)
                torch.cuda.synchronize()
                err = rel_err(f"B3 {name} k={k} passes={passes}", Y, Yp, tol)
                full = pc.compact_matmat_apply(static, tables, ov, Xk, passes)
                e_or = rel_err(f"B3+overflow {name} k={k} vs float64",
                               full.cpu(), torch.as_tensor(want[:, :k]),
                               SPMV_ORACLE_TOL[passes])
                log(f"kernel spmm_compact [{name}] k={k} passes={passes}: "
                    f"max_abs_err {err:.3e} vs plain, {e_or:.3e} vs "
                    f"float64 oracle ok")


def row5_graph():
    """BASELINE row 5: uniform random edges, as bench_all.py makes them."""
    import numpy as np
    rng = np.random.default_rng(0)
    src = rng.integers(0, ROW5_N, ROW5_EDGES, dtype=np.int32)
    dst = rng.integers(0, ROW5_N, ROW5_EDGES, dtype=np.int32)
    return src, dst


def pagerank_oracle(src, dst, n, rounds, alpha=0.85):
    """float64 power iteration over the scipy CSR form of Âᵀ with the
    package's dangling/teleport rule (workloads/pagerank.py
    _power_body)."""
    import numpy as np
    import scipy.sparse as sp
    outdeg = np.bincount(src, minlength=n).astype(np.float64)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1e-30), 0.0)
    M = sp.csr_matrix((inv[src], (dst, src)), shape=(n, n))
    dangling = outdeg == 0
    r = np.full(n, 1.0 / n)
    for _ in range(rounds):
        r = alpha * (M @ r + r[dangling].sum() / n) + (1 - alpha) / n
    return r


def path_row5_pagerank(src, dst):
    """Row 5 through pagerank_edges on the default device: 30 rounds,
    one B2 launch each. Then the plan build on the host and the warm
    per-round time, timed apart."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.workloads import pagerank as pr
    n = ROW5_N
    pc.LAUNCHES_SPMV = 0              # the row-5 PageRank path
    t0 = time.perf_counter()
    r = pr.pagerank_edges(src, dst, n, rounds=ROW5_ROUNDS, impl="onehot",
                          passes=3)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = pc.LAUNCHES_SPMV
    if launches != ROW5_ROUNDS:
        raise AssertionError(f"row 5 PageRank launched B2 {launches} times "
                             f"(want {ROW5_ROUNDS})")
    r64 = r.double().cpu().numpy()
    total = float(r64.sum())
    if r.shape != (n,) or not np.isfinite(r64).all() \
            or abs(total - 1.0) > 1e-3:
        raise AssertionError(f"row 5 PageRank: shape {tuple(r.shape)}, "
                             f"sum {total}")
    ref = pagerank_oracle(src, dst, n, ROW5_ROUNDS)
    rel = float(np.abs(r64 - ref).max() / np.abs(ref).max())
    if rel > 1e-4:
        raise AssertionError(f"row 5 PageRank: rel err {rel} vs float64")
    t0 = time.perf_counter()
    prepared = pr.prepare_pagerank_onehot(src, dst, n)
    build_s = time.perf_counter() - t0
    plan = prepared[0]
    round_ms = time_ms(lambda: pr.run_pagerank_compact(
        prepared, rounds=ROW5_ROUNDS, passes=3), warmup=2,
        runs=10) / ROW5_ROUNDS
    log(f"path row 5 PageRank: {launches} B2 launches, sum(r) = "
        f"{total:.7f}, max err / max|ref| = {rel:.3e} vs float64 scipy; "
        f"first call {first_s:.2f} s (plan build included); plan build on "
        f"the host {build_s:.2f} s (nb={plan.src8.shape[0]}, "
        f"cap={plan.capacity}, overflow "
        f"{0 if plan.ov_rows is None else len(plan.ov_rows)}); warm "
        f"{round_ms:.4f} ms per round (median of 10 x 30 rounds)")
    return launches, {"round_ms": round_ms, "build_s": build_s,
                      "rel_err": rel}


def row5_matrix():
    """Âᵀ of the row-5 graph as a COOMatrix: A[dst, src] = 1/outdeg[src],
    so A·x is one PageRank matvec."""
    import numpy as np
    from matrel_tpu_torch.core.coo import COOMatrix
    src, dst = row5_graph()
    outdeg = np.bincount(src, minlength=ROW5_N).astype(np.float32)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1e-30),
                   0.0).astype(np.float32)
    return src, dst, COOMatrix.from_edges(dst, src, inv[src],
                                          shape=(ROW5_N, ROW5_N))


def path_row5_compute(sess, A):
    """A·x (B2), x'·A (B2 over the transpose plan) and A·X with X 1M x 16
    (B3) through compute(), each against the plain route."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    n = ROW5_N
    x = sess.random((n, 1), seed=6)
    X = sess.random((n, ROW5_K), seed=7)
    e1, e2, e3 = A.multiply(x), x.expr().t().multiply(A), A.multiply(X)
    pc.LAUNCHES_SPMV = pc.LAUNCHES_SPMM = 0     # the row-5 compute path
    t0 = time.perf_counter()
    y1, y2, y3 = sess.compute(e1), sess.compute(e2), sess.compute(e3)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    l_spmv, l_spmm = pc.LAUNCHES_SPMV, pc.LAUNCHES_SPMM
    if l_spmv < 2 or l_spmm < 1:
        raise AssertionError(f"row 5 compute: B2 launched {l_spmv} times "
                             f"(want >= 2), B3 {l_spmm} (want >= 1)")
    tol = SPMV_REL_TOL[3]
    plan, plan_t = A._get_plan(), A._get_plan_t()
    e_1 = rel_err("row 5 A·x", y1.data[:, 0],
                  pc.spmv_compact(plan, x.data[:, 0], use_pallas=False), tol)
    e_2 = rel_err("row 5 x'·A", y2.data[0],
                  pc.spmv_compact(plan_t, x.data[:, 0], use_pallas=False),
                  tol)
    e_3 = rel_err("row 5 A·X", y3.data,
                  pc.spmm_compact(plan, X.data, use_pallas=False), tol)
    log(f"path row 5 compute: A·x, x'·A, A·X (k={ROW5_K}) with {l_spmv} B2 "
        f"and {l_spmm} B3 launches, max_abs_err vs the plain route "
        f"{e_1:.3e} / {e_2:.3e} / {e_3:.3e}; first calls {first_s:.2f} s "
        f"(two plan builds included)")
    return l_spmv, l_spmm, {"row5 A·x": e1, "row5 x'·A": e2,
                            "row5 A·X": e3}


def csr_of(A, dev):
    """The f32 CSR form of a COOMatrix on the device (duplicates summed)
    — the input of the library yardstick."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    m = sp.csr_matrix((A.vals, (A.rows, A.cols)), shape=A.shape)
    return torch.sparse_csr_tensor(
        torch.as_tensor(m.indptr.astype(np.int32), device=dev),
        torch.as_tensor(m.indices.astype(np.int32), device=dev),
        torch.as_tensor(m.data.astype(np.float32), device=dev),
        size=A.shape)


def library_time(name, fn, want):
    """Median time of one library call beside a kernel, or None with the
    reason when the call fails."""
    import torch
    try:
        got = fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as ex:
        log(f"library {name} failed: {type(ex).__name__}: "
            f"{str(ex).splitlines()[0][:160]}")
        return None
    diff = float((got.reshape(want.shape) - want).abs().max())
    ms = time_ms(fn, warmup=2, runs=10, batch=10)
    log(f"library {name}: {ms:.4f} ms, max_abs_diff vs kernel {diff:.3e}")
    return ms


def row5_timing(A, dev):
    """B2 and B3 at the row-5 shape: kernel vs plain (CUDA events,
    median), bound, and torch.sparse.mm on the CSR form (cuSPARSE)."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    plan = A._get_plan()
    tables = pc.compact_tables(plan, dev)
    n_rows, n_cols, block = plan.n_rows, plan.n_cols, plan.block
    src8, lane = tables[0], tables[1]
    real = int(((src8.long() * 8 + lane.long()) < n_cols).sum())
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.rand(n_cols, generator=gen, device=dev)
    X = torch.rand((n_cols, ROW5_K), generator=gen, device=dev)
    csr = csr_of(A, dev)
    out = {}
    for name, k in (("spmv_compact", 1), ("spmm_compact", ROW5_K)):
        if k == 1:
            run = lambda: pc.spmv_scatter(*tables, x, n_rows, block, 3)
            plain = lambda: pc.spmv_scatter_plain(*tables, x, n_rows, block, 3)
            lib = lambda: torch.sparse.mm(csr, x[:, None])
        else:
            run = lambda: pc.spmm_scatter(*tables, X, n_rows, block, 3)
            plain = lambda: pc.spmm_scatter_plain(*tables, X, n_rows, block, 3)
            lib = lambda: torch.sparse.mm(csr, X)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = rel_err(f"{name} row-5 shape", got, want, SPMV_REL_TOL[3])
        ms = time_ms(run, warmup=3, runs=20, batch=10)
        plain_ms = time_ms(plain, warmup=1, runs=10)
        # this run's data: each real slot's 13 table bytes, x (or X) and
        # y (or Y) once; per real slot one multiply, the 3-pass split
        # (6 ops) and one add, per column
        nbytes = real * 13 + (n_cols + n_rows) * 4 * k
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = real * k * 8 / PEAK_FLOPS["float32"] * 1e3
        bound = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                             "operations")
        lib_ms = library_time(f"torch.sparse.mm f32 CSR k={k}", lib, got)
        log(f"row-5 shape {name} (k={k}, {real} real slots of "
            f"{src8.numel()}): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound[0]:.4f} ms ({bound[1]}), library {lib_ms} ms; "
            f"kernel vs plain max_abs_err {err:.3e}")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib_ms}
        del got, want
    return out


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


def kernel_entry(name, source, replaces, launches, row) -> dict:
    return {"name": name, "route": "cuda",
            "source": f"matrel_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            "max_abs_err": row["max_abs_err"], "ms": row["ms"],
            "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


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
    from matrel_tpu_torch.ops import pallas_spmm, pallas_spmv
    from matrel_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    card = device_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    sources = [cuda_build.CSRC_DIR / m.SOURCE
               for m in (pallas_spmm, pallas_spmv)]
    libs = cuda_build.build(sources)          # one nvcc each, in parallel
    pallas_spmm.build()
    pallas_spmv.build()
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{', '.join(l.name for l in libs)}")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {lib.stem.split('-')[0]}: {line.strip()}")

    sess = MatrelSession()            # the default device: cuda
    dev = sess.device
    torch.cuda.reset_peak_memory_stats()
    kernel_phase(sess.mesh)
    spmv_kernel_phase(dev)
    torch.cuda.empty_cache()

    src, dst, A = row5_matrix()
    launches_pr, pr_row = path_row5_pagerank(src, dst)
    l_spmv, l_spmm, queries = path_row5_compute(sess, A)
    b23 = row5_timing(A, dev)
    del src, dst
    torch.cuda.empty_cache()

    library = run_library_yardstick()
    S, D = row4_inputs(sess)
    row = row4_timing(S, D, library)
    torch.cuda.empty_cache()

    pallas_spmm.LAUNCHES = 0          # the row-4 path starts here
    launches, q4 = path_row4(sess, S, D)
    queries.update(q4)
    queries.update(path_row2(sess))
    queries.update(path_row1(sess))
    peak = torch.cuda.max_memory_allocated()
    path_latency(sess, queries)       # after the launch counts were read
    log(f"peak device memory {peak / 2**30:.3f} GiB (this process; the "
        f"yardstick process: {library.get('peak_gib')} GiB); row-5 "
        f"PageRank {pr_row['round_ms']:.4f} ms per round; total "
        f"{time.perf_counter() - t_start:.1f} s")
    if peak > 4 * 2**30:
        raise AssertionError(f"peak device memory {peak / 2**30:.3f} GiB "
                             f"> 4 GiB")

    kernels = [
        kernel_entry("spmm_blocksparse", pallas_spmm.SOURCE,
                     "matrel_tpu/ops/pallas_spmm.py:31", launches, row),
        kernel_entry("spmv_compact", pallas_spmv.SOURCE,
                     "matrel_tpu/ops/pallas_spmv.py:50",
                     launches_pr + l_spmv, b23["spmv_compact"]),
        kernel_entry("spmm_compact", pallas_spmv.SOURCE,
                     "matrel_tpu/ops/pallas_spmv.py:334", l_spmm,
                     b23["spmm_compact"]),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
