"""Distributed sparse matrices: sharded tile stacks and sharded SpMV on a
rank world; the port of the JAX package's
``examples/distributed_sparse_demo.py``.

The one-card sparse paths replicate the sparse operand; at scale the
operand itself must shard. The JAX demo runs both scale-out plans on 8
simulated CPU devices; here ``--nproc`` ranks (default 4, on a 2 × 2
grid) join a gloo world over ``tcp://127.0.0.1:<free port>``, sharing the
card (or on the CPU with ``--device cpu``), each a process of its own:

  1. ``BlockSparseMatrix.shard()`` — the tile stack cut into per-rank
     output row ranges, one all_gather of the product rows; then the same
     S·D through the executor on the rank mesh, where each rank runs the
     block-sparse SpMM kernel B1 (``csrc/spmm_blocksparse.cu``) over its
     column slice of D;
  2. ``spmv.shard_plan`` + ``spmv_sharded`` — the one-hot SpMV plan's
     block rows cut over the ranks (the PageRank shape); then the same
     A·x through the compact tables, B2 (``csrc/spmv_compact.cu``) on
     each rank's slice.

The sharded plans of the JAX demo are XLA bodies there and stock torch
products here; the B1 / B2 lines are the port's kernels on the same data.
Each rank checks its results against numpy; the parent prints rank 0's
lines, the per-rank table shard rows and each rank's kernel launches.

Run: python -m matrel_tpu_torch.examples.distributed_sparse_demo
         [--device cpu] [--nproc 4]
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

from matrel_tpu_torch.examples import parse_args

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: The JAX demo's sizes: a 4096² tile stack of 128-blocks at 10% of the
#: tiles times D 4096 × 64; a 50,000-node, 400,000-edge weighted graph
#: (seed 0, drawn in that order on every rank).
SPMM_N, SPMM_BS, SPMM_COLS = 4096, 128, 64
SPMV_NODES, SPMV_EDGES = 50_000, 400_000
#: Max abs error against float64 numpy that each product must meet: f32
#: sums of ~410 unit-normal products (SpMM), of ~8 weighted terms (SpMV).
SPMM_TOL, SPMV_TOL = 1e-3, 1e-4
#: Seconds the world may take: a rank's rendezvous and collectives wait
#: this long, and ``run`` kills the ranks past it.
TIMEOUT_S = 300.0


def _data():
    """The demo's operands, the same on every rank."""
    rng = np.random.default_rng(0)
    n, bs = SPMM_N, SPMM_BS
    a = np.zeros((n, n), np.float32)
    g = n // bs
    for f in rng.choice(g * g, size=g * g // 10, replace=False):
        bi, bj = divmod(int(f), g)
        a[bi * bs:(bi + 1) * bs, bj * bs:(bj + 1) * bs] = \
            rng.standard_normal((bs, bs))
    d = rng.standard_normal((n, SPMM_COLS)).astype(np.float32)
    src = rng.integers(0, SPMV_NODES, SPMV_EDGES)
    dst = rng.integers(0, SPMV_NODES, SPMV_EDGES)
    w = rng.random(SPMV_EDGES).astype(np.float32)
    x = rng.standard_normal(SPMV_NODES).astype(np.float32)
    return a, d, src, dst, w, x


def rank_main(rank: int, world: int, port: str, device: str,
              out_dir: str) -> int:
    """One rank of the world: both plans, checked against numpy; writes
    ``rank<r>.json`` (its lines, errors, table rows, launches and, on
    the card, its peak device memory)."""
    import torch
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.executor import execute
    from matrel_tpu_torch.ops import pallas_spmm, pallas_spmv
    from matrel_tpu_torch.ops import spmv as spmv_lib
    mesh = mesh_lib.init_distributed(
        "gloo", f"tcp://127.0.0.1:{port}", world, rank,
        grid=mesh_lib.near_square_factors(world), device=device,
        timeout_s=TIMEOUT_S)
    lines = [f"mesh: {dict(zip(mesh.axis_names, mesh.grid))} over "
             f"{mesh.size} ranks (gloo on {mesh.device})", ""]
    a, d, src, dst, w, x = _data()
    b1_0, b2_0 = pallas_spmm.LAUNCHES, pallas_spmv.LAUNCHES_SPMV
    bodies_0 = dict(pallas_spmm.BODY_LAUNCHES)

    # -- 1. sharded tile-stack SpMM ----------------------------------------
    S = BlockSparseMatrix.from_numpy(a, block_size=SPMM_BS, mesh=mesh)
    Ssh = S.shard()
    lines.append(f"tile stack: {S.nnzb} tiles -> {Ssh.cap}/rank "
                 f"(padding {Ssh.padding_ratio:.2f}x)")
    want = a.astype(np.float64) @ d
    D = BlockMatrix.from_numpy(d, mesh=mesh)
    spmm_err = float(np.abs(Ssh.multiply(D).to_numpy() - want).max())
    lines.append(f"sharded SpMM max err vs numpy: {spmm_err:.2e}")
    b1_err = float(np.abs(execute(S.expr().multiply(D.expr()), mesh)
                          .to_numpy() - want).max())
    lines.append(f"rank-mesh S·D (B1 on each rank's slice) max err: "
                 f"{b1_err:.2e}")
    lines.append("")

    # -- 2. sharded one-hot SpMV (the PageRank shape) ----------------------
    plan = spmv_lib.build_spmv_plan(dst, src, w, SPMV_NODES, SPMV_NODES)
    y = spmv_lib.spmv_sharded(plan, x, mesh).cpu().numpy()
    oracle = np.zeros(SPMV_NODES)
    np.add.at(oracle, dst, w.astype(np.float64) * x[src])
    spmv_err = float(np.abs(y - oracle).max())
    lines.append(f"sharded SpMV ({SPMV_EDGES} edges over {mesh.size} "
                 f"ranks) max err: {spmv_err:.2e}")
    y2 = pallas_spmv.spmv_compact_sharded(plan, x, mesh).cpu().numpy()
    b2_err = float(np.abs(y2 - oracle).max())
    lines.append(f"sharded compact SpMV (B2 on each rank's slice) max err: "
                 f"{b2_err:.2e}")
    shard_rows = int(spmv_lib.shard_plan(plan, mesh).local.src8.shape[0])
    peak = 0.0
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
        peak = torch.cuda.max_memory_allocated(mesh.device) / 2 ** 30
    rec = {"rank": rank, "lines": lines, "spmm_err": spmm_err,
           "b1_err": b1_err, "spmv_err": spmv_err, "b2_err": b2_err,
           "nnzb": S.nnzb, "cap": Ssh.cap,
           "padding_ratio": Ssh.padding_ratio, "shard_rows": shard_rows,
           "peak_gib": peak,
           "launches": {"spmm_blocksparse": pallas_spmm.LAUNCHES - b1_0,
                        "spmv_compact":
                            pallas_spmv.LAUNCHES_SPMV - b2_0},
           "b1_bodies": {k: v - bodies_0[k]
                         for k, v in pallas_spmm.BODY_LAUNCHES.items()
                         if v > bodies_0[k]}}
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f)
    mesh_lib.shutdown_distributed()
    return 0


def run(device=None, emit=print, nproc: int = 4,
        timeout_s: float = TIMEOUT_S) -> dict:
    """Spawn the world on ``device``, wait for it (killing it past
    ``timeout_s``) and return rank 0's numbers with every rank's table
    rows, launches and peak device memory (``rank_peak_gib``, the
    largest)."""
    from matrel_tpu_torch.core.mesh import resolve_device
    from matrel_tpu_torch.tools.multihost_check import _free_port
    dev = resolve_device(device)
    if dev.type == "cuda":          # build once, before the ranks load it
        from matrel_tpu_torch.ops import pallas_spmm, pallas_spmv
        pallas_spmm.build()
        pallas_spmv.build()
    out_dir = tempfile.mkdtemp(prefix="matrel_torch_dsd_")
    port = _free_port()
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env.setdefault("OMP_NUM_THREADS", "1")   # ranks share the host's cores
    procs, logs = [], []
    try:
        for r in range(nproc):
            log = open(os.path.join(out_dir, f"rank{r}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m",
                 "matrel_tpu_torch.examples.distributed_sparse_demo",
                 "--rank", str(r), "--world", str(nproc), "--port", port,
                 "--out", out_dir, "--device", dev.type],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=REPO,
                start_new_session=True))
        deadline = time.monotonic() + timeout_s
        rcs = []
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(1.0,
                                              deadline - time.monotonic())))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    recs = []
    for r in range(nproc):
        path = os.path.join(out_dir, f"rank{r}.json")
        if rcs[r] != 0 or not os.path.exists(path):
            with open(os.path.join(out_dir, f"rank{r}.log")) as f:
                tail = f.read()[-3000:]
            raise RuntimeError(f"rank {r} of {nproc} failed (rc {rcs[r]}; "
                               f"logs under {out_dir}):\n{tail}")
        with open(path) as f:
            recs.append(json.load(f))
    shutil.rmtree(out_dir, ignore_errors=True)
    for line in recs[0]["lines"]:
        emit(line)
    rows = sorted({rec["shard_rows"] for rec in recs})
    launches = [rec["launches"] for rec in recs]
    emit(f"per-rank table shard rows: {set(rows)}")
    emit(f"kernel launches by rank: {launches}")
    errs = {k: max(rec[k] for rec in recs)
            for k in ("spmm_err", "b1_err", "spmv_err", "b2_err")}
    for k, tol in (("spmm_err", SPMM_TOL), ("b1_err", SPMM_TOL),
                   ("spmv_err", SPMV_TOL), ("b2_err", SPMV_TOL)):
        if not errs[k] <= tol:
            raise AssertionError(f"{k} {errs[k]:.3e} > {tol:.0e}")
    bodies: dict = {}
    for rec in recs:
        for k, v in rec["b1_bodies"].items():
            bodies[k] = bodies.get(k, 0) + v
    return dict(errs, nnzb=recs[0]["nnzb"], cap=recs[0]["cap"],
                padding_ratio=recs[0]["padding_ratio"], shard_rows=rows,
                launches=launches, b1_bodies=bodies, ranks=nproc,
                rank_peak_gib=max(rec["peak_gib"] for rec in recs))


def main(argv=None) -> int:
    def extra(ap):
        ap.add_argument("--nproc", type=int, default=4)
        # one rank of a world (the parent spawns these)
        ap.add_argument("--rank", type=int, default=None)
        ap.add_argument("--world", type=int, default=None)
        ap.add_argument("--port", default=None)
        ap.add_argument("--out", default=None)

    args = parse_args(argv, "distributed_sparse_demo", __doc__, extra)
    if args.rank is not None:
        return rank_main(args.rank, args.world, args.port, args.device,
                         args.out)
    run(args.device, nproc=args.nproc)
    return 0


if __name__ == "__main__":
    sys.exit(main())
