"""Chunked-B2 schedule experiment for the PageRank SpMV — the port of the
JAX package's ``tools/pagerank_overlap.py``.

Question: does splitting the matvec's row blocks into ``k`` stripes, one
B2 launch a stripe (``pallas_spmv.compact_apply_chunked``), let one
stripe's gathers overlap the next one's accumulation and beat the single
launch (``compact_apply``)? The graph is the JAX tool's: n = 1,000,000
nodes and 10,000,000 uniform edges from ``default_rng(0)`` (``src`` then
``dst``), planned by ``build_spmv_plan(dst, src, None, n, n)`` through the
native fill.

Timing: the marginal time a matvec over chained y → x dependencies,
(t(8) − t(2)) / 6, the median of 3. On the card each chain is a CUDA
graph and t is CUDA events around its replay, so the experiment reads
the card's time and not the host's dispatch of k launches (the
question is whether stripes overlap on the card); on the CPU, the host
clock. The JAX tool meant to time it so but cannot run
(``measure`` is called without its ``x0``); here ``x0`` is its
``ones(n) / n``. Each chunked product is asserted bit-equal to
``compact_apply``'s (every row's f64 sum runs over the same slots in the
same order and rounds once), and on the card each chunked matvec is
asserted to launch B2 once a stripe (through the wrapper, before any
graph is captured).

STOP RULE (encoded): a gain of 10% or more over the baseline is
"IMPROVED", else "NEGATIVE". One JSON line with the JAX tool's keys
(``metric``, ``baseline_ms``, ``chunked_ms``, ``best_chunks``,
``gain_pct``, ``verdict``) plus the checks, ``timing`` (how t was
taken) and the card's name and power limit.

Run: python -m matrel_tpu_torch.tools.pagerank_overlap [--device cpu]
         [--n 1000000] [--edges 10000000]
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

#: The JAX tool's graph and chunk counts.
N_NODES, N_EDGES, CHUNKS = 1_000_000, 10_000_000, (2, 4, 8)
#: Chain lengths of the marginal estimate, and its trials (median).
REPS, TRIALS = (2, 8), 3
#: The stop rule: the smallest gain that adopts the chunked schedule.
ADOPT_GAIN = 0.10


def card_line(device) -> str:
    """``nvidia-smi``'s name and power limit of the card (the torch name
    where nvidia-smi cannot say), or "cpu"."""
    import torch
    if device.type != "cuda":
        return "cpu"
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", str(device.index or 0)],
            capture_output=True, text=True, check=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(device)


def graph(n: int = N_NODES, n_edges: int = N_EDGES):
    """The JAX tool's edges: ``src`` then ``dst`` from ``default_rng(0)``."""
    rng = np.random.default_rng(0)
    src = rng.integers(0, n, n_edges, dtype=np.int32)
    dst = rng.integers(0, n, n_edges, dtype=np.int32)
    return src, dst


def stripes(plan, chunks: int) -> int:
    """B2 launches of one chunked matvec: its non-empty stripes."""
    nb = plan.src8.shape[0]
    return len(range(0, nb, -(-nb // max(chunks, 1))))


def capture(apply_fn, x0, k: int):
    """A CUDA graph of ``k`` chained products from ``x0`` (the chain run
    once on a side stream first, as capture wants). Each product's B2
    wrapper counts its launch as it is captured; a replay launches the
    captured kernels without counting them."""
    import torch
    dev = x0.device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        cur = x0
        for _ in range(k):
            cur = apply_fn(cur)
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread_local: a worker thread of an earlier session that touches
    # the card meanwhile does not void the capture
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        cur = x0
        for _ in range(k):
            cur = apply_fn(cur)
    return graph


def measure(apply_fn, x0, device, reps=REPS, trials: int = TRIALS) -> float:
    """Marginal seconds a matvec over chained y → x dependencies,
    (t(hi) − t(lo)) / (hi − lo), the median of ``trials``. On the card
    each chain is captured once (:func:`capture`) and t is CUDA events
    around a replay of its graph: the host's dispatch of each launch
    (the wrapper's checks, the ctypes call) is out of the window, and
    the graph's own launch cancels in the difference, so what is left is
    the card's time a matvec. On the CPU t is the host clock around the
    chain, ended by a scalar fetch."""
    import torch
    lo, hi = reps
    if device.type == "cuda":
        graphs = {k: capture(apply_fn, x0, k) for k in reps}

        def chained(k: int) -> float:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graphs[k].replay()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / 1e3
    else:
        def chained(k: int) -> float:
            t0 = time.perf_counter()
            cur = x0
            for _ in range(k):
                cur = apply_fn(cur)
            float(cur.sum())
            return time.perf_counter() - t0

    chained(lo)                         # warm
    chained(hi)
    ts = sorted((chained(hi) - chained(lo)) / (hi - lo)
                for _ in range(trials))
    return ts[len(ts) // 2]


def experiment(plan, device, chunks=CHUNKS) -> dict:
    """The experiment on a built plan: checks, then times; returns the
    record (without the card line)."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    n = plan.n_cols
    x0 = torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)
    base_y = pc.compact_apply(plan, x0)
    launches, bit_equal = {}, {}
    for k in chunks:
        before = pc.LAUNCHES_SPMV
        y = pc.compact_apply_chunked(plan, x0, chunks=k)
        launches[k] = pc.LAUNCHES_SPMV - before
        bit_equal[k] = bool(torch.equal(y, base_y))
        if not bit_equal[k]:
            raise AssertionError(f"chunks={k}: the chunked product is not "
                                 f"bit-equal to compact_apply's")
        if device.type == "cuda" and launches[k] != stripes(plan, k):
            raise AssertionError(f"chunks={k}: {launches[k]} B2 launches, "
                                 f"want {stripes(plan, k)} (one a stripe)")
    base = measure(lambda v: pc.compact_apply(plan, v), x0, device)
    res = {"baseline_ms": round(base * 1e3, 4), "chunked_ms": {}}
    best = None
    for k in chunks:
        t = measure(lambda v, k=k: pc.compact_apply_chunked(plan, v,
                                                             chunks=k),
                    x0, device)
        res["chunked_ms"][k] = round(t * 1e3, 4)
        if best is None or t < best[1]:
            best = (k, t)
    gain = 1.0 - best[1] / base
    res["best_chunks"] = best[0]
    res["gain_pct"] = round(gain * 100, 1)
    res["verdict"] = ("IMPROVED — adopt chunked schedule"
                      if gain >= ADOPT_GAIN else
                      "NEGATIVE — <10% gain; the single-launch B2 schedule "
                      "stands")
    res["timing"] = ("cuda_graph_replay" if device.type == "cuda"
                     else "host_clock")
    res["bit_equal"] = bit_equal
    res["launches_per_matvec"] = launches
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m matrel_tpu_torch.tools.pagerank_overlap")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--n", type=int, default=N_NODES)
    ap.add_argument("--edges", type=int, default=N_EDGES)
    args = ap.parse_args(argv)
    from matrel_tpu_torch.core.mesh import resolve_device
    from matrel_tpu_torch.ops import spmv as spmv_lib
    device = resolve_device(args.device)
    src, dst = graph(args.n, args.edges)
    plan = spmv_lib.build_spmv_plan(dst, src, None, n_rows=args.n,
                                    n_cols=args.n)
    if plan is None:
        print(json.dumps({"metric": "pagerank_overlap_experiment",
                          "error": "planner refused graph"}))
        return 1
    res = experiment(plan, device)
    print(json.dumps({"metric": "pagerank_overlap_experiment", **res,
                      "n": args.n, "edges": args.edges, "fill": plan.fill,
                      "device": card_line(device)}))
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
