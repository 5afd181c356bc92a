"""Multi-process validation: the port's collectives over a real process
boundary — the port of the JAX package's ``tools/multihost_check.py``.

The in-process tests exercise one device; this tool runs the same code
over MULTIPLE PROCESSES, each one rank of a ``torch.distributed`` rank
mesh (``core/mesh.init_distributed``) — the control / data plane shape of
hosts joined over a network. Each worker checks, in order, against numpy:

  1. mesh bring-up across processes,
  2. a CPMM (reduce-scatter) matmul whose collective crosses the process
     boundary,
  3. an RMM (all-gather) matmul likewise (and the one-card recipe),
  4. result agreement on every process: every answer below is gathered
     whole onto every rank and checked there,
  5. the sharded one-hot SpMV (plan tables row-decomposed over the
     ranks),
  6. the sharded COMPACT-table SpMV (B2 on each rank's slice),
  7. the sharded tile-stack SpMM (``BlockSparseMatrix.shard()``, B1 on
     each rank's share),
  8. the streaming value-join aggregate with its query side sharded
     across processes (the sorted and the callable chunked path),
  9. the symmetric Gram lowering through the executor under
     precision="high",
 10. the "align" join scheme: both operands re-laid 1D along the join
     axis, the pairwise merge shard-local on every process.

Run:

    python -m matrel_tpu_torch.tools.multihost_check [--nproc 2]
        [--device cpu] [--backend gloo|nccl] [--timeout 240]

On the card (the default device) the ranks are gloo processes sharing it;
``--backend nccl`` wants one card a rank and raises with fewer. Exit code
0 on success; worker logs live in a fresh temp dir (path printed on
failure). The rendezvous port is ephemeral by default. Every wait has the
``--timeout``; processes that remain are killed.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

_WORKER = r"""
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
backend = sys.argv[4]; device = sys.argv[5]; timeout_s = float(sys.argv[6])
sys.path.insert(0, %(repo)r)
import numpy as np
import torch
import torch.distributed as dist
from matrel_tpu_torch.core import mesh as mesh_lib
mesh = mesh_lib.init_distributed(backend, f"tcp://127.0.0.1:{port}", nproc,
                                 pid, device=device, timeout_s=timeout_s)

from matrel_tpu_torch.config import MatrelConfig
from matrel_tpu_torch.core.blockmatrix import BlockMatrix
from matrel_tpu_torch.parallel import collectives as coll, strategies

print(f"[p{pid}] mesh {dict(zip(mesh.axis_names, mesh.grid))} over "
      f"{dist.get_world_size()} ranks ({backend} on {mesh.device})",
      flush=True)

rng = np.random.default_rng(0)          # same data on every process
a = rng.standard_normal((32, 32)).astype(np.float32)
b = rng.standard_normal((32, 32)).astype(np.float32)
A = BlockMatrix.from_numpy(a, mesh=mesh)
B = BlockMatrix.from_numpy(b, mesh=mesh)
cfg = MatrelConfig()
oracle = a @ b

for strat in ("cpmm", "rmm", "xla"):
    out = strategies.run_matmul(strat, A.as_shard(), B.as_shard(), mesh,
                                cfg)
    # every process receives the full value; collectives crossed the
    # process boundary to produce it
    full = coll.gather_full(out, mesh).cpu().numpy()[:32, :32]
    np.testing.assert_allclose(full, oracle, rtol=1e-3, atol=1e-3)
    print(f"[p{pid}] {strat} matches oracle", flush=True)

# sharded one-hot SpMV: plan tables row-decomposed over the ranks
from matrel_tpu_torch.ops import spmv as spmv_lib
n_r, n_c, m = 4096, 2048, 40_000
rows = rng.integers(0, n_r, m); cols = rng.integers(0, n_c, m)
vals = rng.standard_normal(m).astype(np.float32)
plan = spmv_lib.build_spmv_plan(rows, cols, vals, n_rows=n_r, n_cols=n_c)
x = rng.standard_normal(n_c).astype(np.float32)
y = spmv_lib.spmv_sharded(plan, x, mesh)
got = y.cpu().numpy().reshape(-1)[:n_r]
want = np.zeros(n_r); np.add.at(want, rows, vals * x[cols])
np.testing.assert_allclose(got, want, rtol=1e-4,
                           atol=1e-4 * max(abs(want).max(), 1.0))
print(f"[p{pid}] sharded one-hot SpMV matches oracle", flush=True)

# sharded COMPACT-table SpMV: the compact tables row-decomposed over the
# ranks, B2 on each rank's slice (its plain version on the CPU), one
# all_gather crossing the process boundary
from matrel_tpu_torch.ops import pallas_spmv as pc
y_c = pc.spmv_compact_sharded(plan, x, mesh)
got_c = y_c.cpu().numpy().reshape(-1)[:n_r]
np.testing.assert_allclose(got_c, want, rtol=1e-4,
                           atol=1e-4 * max(abs(want).max(), 1.0))
print(f"[p{pid}] sharded compact-table SpMV matches oracle", flush=True)

# sharded tile-stack SpMM
from matrel_tpu_torch.core.sparse import BlockSparseMatrix
sp = np.zeros((64, 64), np.float32)
sp[(rng.random((64, 64)) < 0.5)] = 1.5
d = rng.standard_normal((64, 8)).astype(np.float32)
S = BlockSparseMatrix.from_numpy(sp, block_size=8, mesh=mesh)
prod = S.shard().multiply(BlockMatrix.from_numpy(d, mesh=mesh))
full = prod.to_numpy()[:64, :8]
np.testing.assert_allclose(full, sp @ d, rtol=1e-3, atol=1e-3)
print(f"[p{pid}] sharded tile-stack SpMM matches oracle", flush=True)

# streaming value-join aggregate, query side sharded across processes
from matrel_tpu_torch.executor import execute as mat_execute
from matrel_tpu_torch.relational import ops as R
vj_a = rng.standard_normal((40, 32)).astype(np.float32)
vj_b = rng.standard_normal((8, 8)).astype(np.float32)
va_o = vj_a.T.reshape(-1); vb_o = vj_b.T.reshape(-1)
# sorted (structured) path
n_pairs_a = vj_a.size
jv = R.join_on_values(BlockMatrix.from_numpy(vj_a, mesh=mesh),
                      BlockMatrix.from_numpy(vj_b, mesh=mesh),
                      merge="mul", predicate="lt")
got_vj = mat_execute(R.aggregate(jv, "sum", "row"), mesh,
                     cfg).to_numpy()[:n_pairs_a, 0]
want_p = np.where(va_o[:, None] < vb_o[None, :],
                  va_o[:, None] * vb_o[None, :], 0.0)
np.testing.assert_allclose(got_vj, want_p.sum(1), rtol=1e-4, atol=1e-4)
# chunked (callable) path
jc = R.join_on_values(BlockMatrix.from_numpy(vj_a, mesh=mesh),
                      BlockMatrix.from_numpy(vj_b, mesh=mesh),
                      merge=lambda x, y: x * y + x,
                      predicate=lambda x, y: x < y)
got_jc = mat_execute(R.aggregate(jc, "sum", "row"), mesh,
                     cfg).to_numpy()[:n_pairs_a, 0]
want_c = np.where(va_o[:, None] < vb_o[None, :],
                  va_o[:, None] * vb_o[None, :] + va_o[:, None], 0.0)
np.testing.assert_allclose(got_jc, want_c.sum(1), rtol=1e-4, atol=1e-4)
print(f"[p{pid}] streaming value-joins (sorted + chunked) match oracle",
      flush=True)

# symmetric Gram through the executor across processes
gxm = rng.standard_normal((48, 24)).astype(np.float32)
GX = BlockMatrix.from_numpy(gxm, mesh=mesh)
got_g = mat_execute(GX.expr().t().multiply(GX.expr()), mesh,
                    MatrelConfig(matmul_precision="high")).to_numpy()[:24, :24]
np.testing.assert_allclose(got_g, gxm.T @ gxm, rtol=5e-3, atol=5e-3)
print(f"[p{pid}] symmetric gram matches oracle", flush=True)

# the "align" join scheme across process boundaries — both operands
# re-laid 1D along the join axis, the pairwise merge shard-local. The
# scheme is stamped: the JAX tool's global mesh is (2, 4) devices, where
# the planner picks align for this join by itself, but one rank a process
# gives a (1, 2) grid at two processes, where the planner (the JAX
# package's as well, on that grid) replicates the right operand instead.
from matrel_tpu_torch.parallel import planner as pl_mod
j_a = rng.standard_normal((8 * nproc, 10)).astype(np.float32)
j_b = rng.standard_normal((8 * nproc, 6)).astype(np.float32)
je = R.join_on_rows(BlockMatrix.from_numpy(j_a, mesh=mesh),
                    BlockMatrix.from_numpy(j_b, mesh=mesh),
                    "mul").with_attrs(replicate="align")
je_ann = pl_mod.annotate_strategies(je, mesh, cfg)
assert je_ann.attrs["replicate"] == "align", je_ann.attrs
got_j = mat_execute(je_ann, mesh, cfg).to_numpy()[:8 * nproc, :60]
want_j = (j_a[:, :, None] * j_b[:, None, :]).reshape(8 * nproc, 60)
np.testing.assert_allclose(got_j, want_j, rtol=1e-4, atol=1e-4)
print(f"[p{pid}] align row-join matches oracle", flush=True)

mesh_lib.shutdown_distributed()          # a barrier, then teardown
print(f"[p{pid}] DONE", flush=True)
"""


def _free_port() -> str:
    """Ask the kernel for an ephemeral loopback port (fixed ports collide
    with concurrent runs or orphans from earlier failures)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def main(argv=None) -> int:
    import tempfile
    import time

    ap = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.multihost_check")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--port", default=None,
                    help="rendezvous port (default: ephemeral)")
    ap.add_argument("--timeout", type=float, default=240.0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="nccl only with one card a rank")
    args = ap.parse_args(argv)
    from matrel_tpu_torch.core.mesh import resolve_device
    device = resolve_device(args.device)
    port = args.port or _free_port()

    tmpdir = tempfile.mkdtemp(prefix="matrel_torch_mh_")
    worker_path = os.path.join(tmpdir, "worker.py")
    with open(worker_path, "w") as f:
        f.write(_WORKER % {"repo": REPO})

    procs, logs = [], []
    log_paths = []
    env = dict(os.environ)
    env.setdefault("OMP_NUM_THREADS", "1")   # ranks share the host's cores
    rcs = [None] * args.nproc
    try:
        for pid in range(args.nproc):
            lp = os.path.join(tmpdir, f"p{pid}.log")
            log_paths.append(lp)
            log = open(lp, "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, worker_path, str(pid), str(args.nproc),
                 port, args.backend, device.type, str(args.timeout)],
                stdout=log, stderr=subprocess.STDOUT, env=env,
                start_new_session=True))
        deadline = time.monotonic() + args.timeout
        for i, p in enumerate(procs):
            rcs[i] = p.wait(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    ok = all(rc == 0 for rc in rcs)
    for pid, lp in enumerate(log_paths):
        with open(lp) as f:
            for ln in f.read().splitlines():
                if ln.startswith(f"[p{pid}]"):
                    print(ln)
    print("MULTIHOST CHECK:", "OK" if ok else f"FAILED (rcs={rcs})",
          f"(logs under {tmpdir})" if not ok else "")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
