"""PageRank power iteration — the counterpart of
``matrel_tpu/workloads/pagerank.py`` (BASELINE row 5: 1M-node graph,
30 matvec rounds).

The JAX package runs each loop as one jitted ``fori_loop`` (the
block-sparse one from the host). Here the rounds are a Python loop of
eager torch ops around the product, with no host synchronisation
between rounds: over an edge list one SpMV launch a round (B2 on the
card), the overflow ``index_add_`` and a few elementwise ops.

Ported: ``pagerank`` (dense adjacency: one f32 Âᵀ·(r/deg) product a
round, TF32 off); ``pagerank_edges`` on one device with impls ``auto``,
``segment`` and ``onehot``; ``prepare_pagerank_onehot``,
``run_pagerank_onehot``, ``run_pagerank_compact``; the byte-aware plan
cache; ``pagerank_csr`` (a padded in-neighbour table, gathered and
summed a round; it falls back to ``pagerank_edges`` on loose degree
distributions); ``pagerank_block_sparse`` (degrees and every round
through the block-sparse SpMM, B1 on the card, against a dense operand
one column wide); and ``pagerank_numpy_oracle``. With ``mesh=`` a rank
mesh, ``pagerank_edges`` runs the sharded variants: each rank holds its
slice of the plan's block rows and every round is B2 on the slice (the
expanded one-hot slice with ``use_pallas`` off), one ``all_gather`` of r
and the overflow COO — the JAX package's one ``shard_map``'d loop as a
Python loop on every rank.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from matrel_tpu_torch.core.mesh import resolve_device

Tensor = torch.Tensor


def pagerank(A, rounds: int = 30, alpha: float = 0.85,
             config=None) -> Tensor:
    """r ← α·Âᵀ·r + (1-α)/N over a dense adjacency ``BlockMatrix`` (A[i, j]
    = 1 for an edge i→j, Â its row-normalised form), ``rounds`` times on
    A's device. Dangling nodes (zero out-degree) redistribute uniformly;
    padded rows stay 0. Each round is one f32 product Aᵀ·(r/deg) with
    TF32 off (``Precision.HIGHEST`` in the JAX package). Returns the
    rank vector as an (N, 1) tensor."""
    from matrel_tpu_torch.parallel.strategies import _highest_precision
    n = A.shape[0]
    if A.shape[0] != A.shape[1]:
        raise ValueError(f"adjacency must be square, got {A.shape}")
    ad = A.data
    pn = ad.shape[0]
    dev = ad.device
    _highest_precision()
    zero = torch.zeros((), dtype=ad.dtype, device=dev)
    valid_row = (torch.arange(pn, device=dev) < n)[:, None]
    deg = ad.sum(dim=1, keepdim=True)                    # out-degree
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1e-30), zero)
    dangling = (valid_row & (deg == 0)).to(ad.dtype)
    r = torch.where(valid_row, torch.full((), 1.0 / n, dtype=ad.dtype,
                                          device=dev), zero)
    teleport = (1.0 - alpha) / n
    at = ad.T
    for _ in range(int(rounds)):
        contrib = at @ (inv_deg * r)          # Âᵀ·r, Â = D⁻¹A
        dmass = torch.sum(dangling * r)
        r = torch.where(valid_row, alpha * (contrib + dmass / n) + teleport,
                        zero)
    return r[:n]


def pagerank_edges(src, dst, n: int, rounds: int = 30, alpha: float = 0.85,
                   impl: str = "auto", weights=None, passes: int = 3,
                   device=None, mesh=None) -> Tensor:
    """PageRank over an edge list (src[e] → dst[e]) on ``device``
    (default: the card); returns the (n,) rank vector.

    ``impl="onehot"`` builds the SpMV plan on the host and runs the
    compact-table kernel (its plain version on the CPU; the expanded
    one-hot path with ``use_pallas`` off). ``"segment"`` gathers and
    ``index_add_``s over the edge arrays each round. ``"auto"`` takes
    the one-hot path on a CUDA device (falling back when the plan build
    refuses the graph or exceeds the slot budget) and the segment path
    on the CPU, as the JAX package does off the TPU.

    ``mesh`` (a rank mesh; every rank calls with the same graph) runs the
    one-hot impls sharded over the ranks (the segment path runs whole on
    every rank); every rank gets the whole vector.
    """
    if impl not in ("auto", "segment", "onehot"):
        raise ValueError(f"unknown impl {impl!r}")
    if mesh is not None and not getattr(mesh, "ranked", False):
        raise ValueError("pagerank_edges(mesh=) needs a rank mesh "
                         "(core.mesh.init_distributed)")
    dev = mesh.device if mesh is not None else resolve_device(device)
    if mesh is not None and (impl == "onehot"
                             or (impl == "auto" and dev.type == "cuda")):
        out = _pagerank_sharded(
            src, dst, n, rounds, alpha, mesh,
            max_slots=None if impl == "onehot"
            else _auto_max_slots() * mesh.size,
            weights=weights, passes=passes)
        if out is not None:
            return out
        if impl == "onehot":
            raise ValueError("impl='onehot' requested but build_spmv_plan "
                             "refused the graph; use impl='segment'")
    elif impl == "onehot":
        out = _pagerank_onehot(src, dst, n, rounds, alpha, weights=weights,
                               passes=passes, device=dev)
        if out is None:
            raise ValueError(
                "impl='onehot' requested but the graph's degree "
                "distribution is too heavy-tailed for the one-hot "
                "plan (build_spmv_plan refused); use impl='segment' or "
                "'auto'")
        return out
    if impl == "auto" and dev.type == "cuda" and mesh is None:
        out = _pagerank_onehot(src, dst, n, rounds, alpha,
                               max_slots=_auto_max_slots(), weights=weights,
                               passes=passes, device=dev)
        if out is not None:
            return out
    return _pagerank_segment(src, dst, n, rounds, alpha, weights, dev)


def prepare_pagerank_onehot(src, dst, n: int, max_slots: int = None,
                            weights=None, device=None):
    """Build the SpMV plan for a graph, reusable across runs: the
    contribution matvec is Âᵀ·r with Â[i, j] = w_ij / outdeg_w[i] for
    each edge i→j, so the plan is rows=dst, cols=src, vals=w/outdeg_w[src].
    Returns (plan, dangling mask on ``device``), or None when the plan
    refuses the graph."""
    from matrel_tpu_torch.ops import spmv as spmv_lib
    dev = resolve_device(device)
    src_np = np.asarray(src, dtype=np.int64)
    dst_np = np.asarray(dst, dtype=np.int64)
    if weights is None:
        w = np.ones(src_np.shape, np.float32)
    else:
        w = np.asarray(weights, dtype=np.float32)
    outdeg = np.bincount(src_np, weights=w, minlength=n).astype(np.float32)
    # epsilon (not 1.0) floor: weighted out-masses below 1 must not be
    # clamped or the ranks skew
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1e-30), 0.0)
    plan = spmv_lib.build_spmv_plan(dst_np, src_np, vals=w * inv[src_np],
                                    n_rows=n, n_cols=n, max_slots=max_slots)
    if plan is None:
        return None
    dangling = torch.as_tensor((outdeg == 0).astype(np.float32), device=dev)
    return plan, dangling


def _prepared_device(prepared, device) -> torch.device:
    if prepared is None:
        raise ValueError(
            "prepare_pagerank_onehot returned None for this graph "
            "(degree distribution too heavy-tailed for the one-hot "
            "plan); use the segment-sum path instead")
    return (prepared[1].device if device is None
            else resolve_device(device))


def run_pagerank_onehot(prepared, rounds: int = 30, alpha: float = 0.85,
                        device=None) -> Tensor:
    """PageRank rounds over the expanded one-hot tables of a prepared
    plan (on the device its dangling mask lives on, unless given)."""
    from matrel_tpu_torch.ops import spmv as spmv_lib
    dev = _prepared_device(prepared, device)
    plan, dangling = prepared
    static = (plan.n_rows, plan.n_cols, plan.block)
    arrays = plan.arrays(dev)
    return _power_iterate(lambda r: spmv_lib.spmv_apply(static, arrays, r),
                          plan.n_rows, rounds, alpha, dangling.to(dev), dev)  # matlint: disable=ML008 the prepared plan's dangling mask — a no-op on the device it was prepared on


def run_pagerank_compact(prepared, rounds: int = 30, alpha: float = 0.85,
                         passes: int = 2, device=None) -> Tensor:
    """PageRank rounds over the compact SpMV (one B2 launch per round on
    the card, over the plan's CSR view). ``passes`` trades round fidelity
    for speed: 2 → ~2^-16 relative error per matvec (ranking-grade), 3 →
    ~f32."""
    from matrel_tpu_torch.ops import pallas_spmv as pc
    dev = _prepared_device(prepared, device)
    plan, dangling = prepared
    return _power_iterate(lambda r: pc.compact_apply(plan, r, passes),
                          plan.n_rows, rounds, alpha, dangling.to(dev), dev)  # matlint: disable=ML008 the prepared plan's dangling mask — a no-op on the device it was prepared on


# Prepared-plan cache for repeated calls on the same graph (alpha/round
# sweeps), keyed by a full content hash of the edge list plus the device.
# Eviction is byte-aware in padded slots (the expanded tables cost ~224 B
# a slot — the conservative worst case across both executors); plans
# above the budget run uncached.
_PLAN_CACHE: dict = {}
_PLAN_CACHE_MAX_SLOTS = 24_000_000


def _cache_get_or_insert(key, build: Callable, slots_of: Callable):
    """Byte-aware cache: values are (prepared, slots). ``build`` runs on
    a miss (may return None = refused); oversized results are returned
    uncached."""
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit[0]
    prepared = build()
    if prepared is None:
        return None
    cost = slots_of(prepared)
    if cost <= _PLAN_CACHE_MAX_SLOTS:
        total = sum(c for _, c in _PLAN_CACHE.values())
        while _PLAN_CACHE and total + cost > _PLAN_CACHE_MAX_SLOTS:
            total -= _PLAN_CACHE.pop(next(iter(_PLAN_CACHE)))[1]
        _PLAN_CACHE[key] = (prepared, cost)
    return prepared


def _graph_fingerprint(src, dst, n: int, weights=None) -> tuple:
    import hashlib
    h = hashlib.blake2b(digest_size=16)
    sizes = []
    for a in (src, dst):
        # canonical int32, so the same graph hashes identically whatever
        # index dtype it arrives in
        a = np.ascontiguousarray(np.asarray(a, dtype=np.int32))
        h.update(a.tobytes())
        sizes.append(a.shape[0])
    if weights is not None:
        h.update(np.ascontiguousarray(
            np.asarray(weights, dtype=np.float32)).tobytes())
    return (n, tuple(sizes), weights is not None, h.hexdigest())


def _plan_slots(prepared) -> int:
    plan, _ = prepared
    return plan.src8.shape[0] * plan.src8.shape[1]


def _auto_max_slots() -> int:
    """Plan-size gate for the auto path: the compact executor keeps
    13 B/slot on the device, so its budget is 8× the expanded path's."""
    from matrel_tpu_torch.ops.pallas_spmv import compact_enabled
    if compact_enabled():
        return _PLAN_CACHE_MAX_SLOTS * 8
    return _PLAN_CACHE_MAX_SLOTS


def _pagerank_onehot(src, dst, n: int, rounds: int, alpha: float,
                     max_slots: int = None, weights=None, passes: int = 3,
                     device=None) -> Optional[Tensor]:
    dev = resolve_device(device)
    prepared = _cache_get_or_insert(
        _graph_fingerprint(src, dst, n, weights) + (str(dev),),
        lambda: prepare_pagerank_onehot(src, dst, n, max_slots=max_slots,
                                        weights=weights, device=dev),
        _plan_slots)
    if prepared is None:
        return None
    from matrel_tpu_torch.ops.pallas_spmv import compact_enabled
    if compact_enabled():
        return run_pagerank_compact(prepared, rounds, alpha, passes=passes,
                                    device=dev)
    return run_pagerank_onehot(prepared, rounds, alpha, device=dev)


def _pagerank_sharded(src, dst, n: int, rounds: int, alpha: float, mesh,
                      max_slots: int = None, weights=None,
                      passes: int = 3) -> Optional[Tensor]:
    """PageRank over the plan's block rows cut over the rank mesh: each
    round B2 on this rank's slice (``pallas_spmv.compact_sharded_apply``;
    the expanded one-hot slice, ``spmv.spmv_sharded_apply``, with
    ``use_pallas`` off), one all_gather of r, the overflow COO. None
    when the plan build refuses the graph."""
    dev = mesh.device
    prepared = _cache_get_or_insert(
        _graph_fingerprint(src, dst, n, weights) + (str(dev), "sharded"),
        lambda: prepare_pagerank_onehot(src, dst, n, max_slots=max_slots,
                                        weights=weights, device=dev),
        lambda pr_: -(-_plan_slots(pr_) // mesh.size))
    if prepared is None:
        return None
    return run_pagerank_sharded(prepared, mesh, rounds, alpha, passes)


def run_pagerank_sharded(prepared, mesh, rounds: int = 30,
                         alpha: float = 0.85, passes: int = 3) -> Tensor:
    """PageRank rounds over a prepared plan cut over the rank mesh: B2 on
    this rank's slice of block rows a round (``use_pallas`` off: the
    expanded one-hot slice), one all_gather of r, the overflow COO.
    Every rank calls it and gets the whole vector."""
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.ops import spmv as spmv_lib
    dev = _prepared_device(prepared, mesh.device)
    plan, dangling = prepared
    if pc.compact_enabled():
        matvec = lambda r: pc.compact_sharded_apply(plan, r, mesh, passes)
    else:
        sl = spmv_lib.shard_plan(plan, mesh)
        matvec = lambda r: spmv_lib.spmv_sharded_apply(sl, r, mesh)
    return _power_iterate(matvec, plan.n_rows, rounds, alpha,
                          dangling.to(dev), dev)  # matlint: disable=ML008 the prepared plan's dangling mask — a no-op on the device it was prepared on


def _pagerank_segment(src, dst, n: int, rounds: int, alpha: float,
                      weights, dev: torch.device) -> Tensor:
    """Gather + ``index_add_`` over the edge arrays, sorted by
    destination once."""
    s = torch.as_tensor(np.asarray(src), device=dev).long()
    d = torch.as_tensor(np.asarray(dst), device=dev).long()
    w = (torch.ones(s.shape, dtype=torch.float32, device=dev)
         if weights is None
         else torch.as_tensor(np.asarray(weights, np.float32), device=dev))
    order = torch.argsort(d, stable=True)
    s, d, w = s[order], d[order], w[order]
    outdeg = torch.zeros(n, dtype=torch.float32,
                         device=dev).index_add_(0, s, w)
    inv_deg = torch.where(outdeg > 0, 1.0 / outdeg.clamp(min=1e-30),
                          torch.zeros((), device=dev))
    dangling = (outdeg == 0).float()

    def matvec(r: Tensor) -> Tensor:
        rn = r * inv_deg
        return torch.zeros(n, dtype=torch.float32,
                           device=dev).index_add_(0, d, rn[s] * w)

    return _power_iterate(matvec, n, rounds, alpha, dangling, dev)


def _power_body(matvec: Callable, n: int, alpha: float, dangling: Tensor):
    """The shared PageRank update, one body for every edge-based impl so
    the teleport/dangling semantics cannot drift apart."""
    teleport = (1.0 - alpha) / n

    def body(r: Tensor) -> Tensor:
        contrib = matvec(r)
        dmass = torch.sum(dangling * r)
        return alpha * (contrib + dmass / n) + teleport

    return body


def _r0(n: int, device) -> Tensor:
    return torch.full((n,), 1.0 / n, dtype=torch.float32, device=device)


def _power_iterate(matvec: Callable, n: int, rounds: int, alpha: float,
                   dangling: Tensor, dev) -> Tensor:
    body = _power_body(matvec, n, alpha, dangling)
    r = _r0(n, dev)
    for _ in range(int(rounds)):
        r = body(r)
    return r


def pagerank_csr(src, dst, n: int, rounds: int = 30, alpha: float = 0.85,
                 max_degree_factor: float = 2.0, device=None) -> Tensor:
    """PageRank through a padded in-neighbour table: a host-built (n, D)
    table of each node's in-neighbours (D the largest in-degree), padded
    with the sentinel ``n``, which reads 0; each round gathers r/outdeg
    through it and sums each row — no scatter. The table does D / mean
    degree times the gathers of the edge list, so it runs only where the
    in-degrees are tight (D ≤ ``max_degree_factor`` × mean); anything
    looser falls back to :func:`pagerank_edges`. Returns (n,)."""
    dev = resolve_device(device)
    src = np.asarray(src, dtype=np.int32)
    dst = np.asarray(dst, dtype=np.int32)
    indeg = np.bincount(dst, minlength=n)
    D = int(indeg.max()) if len(dst) else 0
    mean_deg = max(len(dst) / max(n, 1), 1.0)
    if D > max_degree_factor * mean_deg:
        return pagerank_edges(src, dst, n, rounds, alpha, device=dev)
    order = np.argsort(dst, kind="stable")
    dst_s, src_s = dst[order], src[order]
    offsets = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(indeg, out=offsets[1:])
    slot = np.arange(len(dst_s)) - offsets[dst_s]
    neighbors = np.full((n, max(D, 1)), n, dtype=np.int32)  # n = sentinel
    neighbors[dst_s, slot] = src_s
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    nbr = torch.as_tensor(neighbors, device=dev).long()
    deg = torch.as_tensor(outdeg, device=dev)
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0),
                          torch.zeros((), device=dev))
    dangling = (deg == 0).float()
    pad = torch.zeros(1, dtype=torch.float32, device=dev)

    def matvec(r: Tensor) -> Tensor:
        return torch.cat([r * inv_deg, pad])[nbr].sum(dim=1)

    return _power_iterate(matvec, n, rounds, alpha, dangling, dev)


def pagerank_block_sparse(S, rounds: int = 30, alpha: float = 0.85,
                          config=None) -> Tensor:
    """PageRank over a block-sparse adjacency (clustered graphs whose
    tiles are dense enough to pay). The out-degrees are S·1 and each
    round is Sᵀ·(r/deg) followed by the dangling / teleport step, both
    products through the block-sparse SpMM (``ops/spmm.py``: B1 on the
    card, f32 tiles against one dense column); the loop is driven from
    the host, as in the JAX package. Returns the (N, 1) rank vector."""
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.ops import spmm as spmm_lib

    n = S.shape[0]
    if S.shape[0] != S.shape[1]:
        raise ValueError(f"adjacency must be square, got {S.shape}")
    st = S.transpose()
    mesh = S.mesh
    deg = spmm_lib.spmm(
        S, BlockMatrix.from_numpy(np.ones((n, 1), np.float32), mesh=mesh),
        config).data
    dev = deg.device
    zero = torch.zeros((), dtype=deg.dtype, device=dev)
    # epsilon (not 1.0) floor: weighted adjacencies can have row sums
    # below 1, and clamping those would skew the ranks
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1e-30), zero)
    valid = (torch.arange(deg.shape[0], device=dev) < n)[:, None]
    dangling = ((deg == 0) & valid).float()
    teleport = (1.0 - alpha) / n
    r = BlockMatrix.from_numpy(np.full((n, 1), 1.0 / n, np.float32),
                               mesh=mesh)
    for _ in range(int(rounds)):
        weighted = BlockMatrix.from_array(r.data * inv_deg, (n, 1), mesh,
                                          r.spec)
        contrib = spmm_lib.spmm(st, weighted, config).data
        dmass = torch.sum(dangling * r.data)
        r_new = torch.where(valid, alpha * (contrib + dmass / n) + teleport,
                            zero)
        r = BlockMatrix.from_array(r_new, (n, 1), mesh, r.spec)
    return r.data[:n]


def pagerank_numpy_oracle(a, rounds=30, alpha=0.85):
    """Naive host oracle for tests (dense adjacency a[i, j] = edge i→j)."""
    n = a.shape[0]
    deg = a.sum(1, keepdims=True)
    inv = np.where(deg > 0, 1.0 / np.maximum(deg, 1e-30), 0.0)
    r = np.full((n, 1), 1.0 / n, dtype=np.float64)
    for _ in range(rounds):
        contrib = (a * inv).T @ r
        dmass = r[(deg == 0).ravel()].sum()
        r = alpha * (contrib + dmass / n) + (1 - alpha) / n
    return r
