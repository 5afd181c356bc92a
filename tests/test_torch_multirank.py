"""PyTorch port: multi-rank execution over ``torch.distributed`` (gloo on
the CPU), held against the JAX package on its CPU meshes.

One spawn per world runs the whole battery (``_battery``) on every rank
of a 2×2 world (the square grid SUMMA needs; the JAX side on the
conftest's 4-device ``mesh_square``) and of a 2×4 world (the JAX tests'
``mesh8``), and hands each rank's results back through a pickle file.
The ranks rendezvous through a ``file://`` store in the test's temporary
directory, so parallel test workers never share a port, and run with
``OMP_NUM_THREADS=1``. A world that has not finished within
``JOIN_TIMEOUT_S`` is killed and the test fails with the ranks' output.

This module is imported by the rank processes, so it imports neither
``jax`` nor ``matrel_tpu`` at the top: the JAX side is imported inside
the tests, and every rank reports that neither was loaded.

Checked: every strategy recipe's result (the JAX tests' tolerance
rtol = atol = 1e-4) and its collective tally (CPMM one reduce-scatter on
y, RMM gathers only, SUMMA point-to-point only, BMM nothing after its
input re-lay — the JAX tests' HLO assertions); SUMMA on 2×4 runs CPMM;
planner stamps equal the JAX package's on the same grid; staged reshard
moves bit-equal; a budgeted plan bit-equal to budget 0; the sharded
SpMV/SpMM (the plain B2/B3 versions on the CPU, and the expanded
slices), sharded PageRank, ``spgemm_sharded``, ``spmm_sharded`` and
``streaming_chain_sharded``; measured choices agreed from rank 0; a
checkpoint of a rank-laid matrix (every rank gathers, rank 0 writes,
every rank restores its own block under the saved spec).
"""

import os
import pickle
import sys
import time
import traceback

import numpy as np
import pytest
import torch

JOIN_TIMEOUT_S = 120.0
WORLDS = {"2x2": (2, 2), "2x4": (2, 4)}
STRATS = ("bmm_left", "bmm_right", "cpmm", "rmm", "summa", "xla")
#: strategy inputs per world: the shapes of tests/test_strategies.py
SHAPES = {"2x2": ((12, 20), (20, 8)), "2x4": ((16, 24), (24, 32))}
RESHARD_PAIRS = (("row", "2d"), ("2d", "row"), ("col", "2d"),
                 ("2d", "col"), ("row", "col"), ("col", "row"),
                 ("2d", "rep"), ("row", "rep"), ("col", "rep"),
                 ("rep", "row"), ("rep", "2d"))
CHAIN = ((64, 48), (48, 80), (80, 16))
GRAPH_N, GRAPH_E = 700, 6000
CHAIN_N, CHAIN_TILE = 64, 8


#: sharded-lowering inputs: ragged shapes, so block edges meet padding
LOW_N, LOW_M = 37, 29
#: index-join operands (row joins share LOW_N rows, col joins LOW_M
#: columns) and value-join operands: Va's 1,280 entries and Vb's 1,152
#: reach the query split (>= 128 entries a rank on 8 ranks); Vc's 20
#: keep the callable join's pairs few
JOIN_SHAPES = {"Ja": (LOW_N, 3), "Jb": (LOW_N, 4), "Ka": (3, LOW_M),
               "Kb": (2, LOW_M)}
VJ_SHAPES = {"Va": (32, 40), "Vb": (36, 32), "Vc": (4, 5)}
AGG_KINDS = ("sum", "count", "avg", "max", "min")
AGG_AXES = ("row", "col", "all", "diag")
#: lowerings that keep their one counted whole gather (``gather_rep``)
#: on a rank mesh: a broadcast vector, rank1's vectors, the replicated
#: operand of a "left" / "right" join, a value join's entry vectors
GATHERS = ("sub_col", "div_row", "rank1", "jrows_left", "jrows_right",
           "jcols_left", "jcols_right", "vj_row_sum", "vj_col_count",
           "vj_all_max", "vj_all_avg", "vj_callable_row", "vj_pairs")
#: elementwise, scalar, σ and index-join lowerings: bit-equal to one card
EXACT = ("add", "sub_col", "div_row", "mul", "max", "min_t", "scalar",
         "pow", "pow0", "sel_value", "sel_fill", "sel_index", "sel_block",
         "join_index", "rank1", "jrows_left", "jrows_right", "jrows_align",
         "jcols_left", "jcols_right", "jcols_align", "vj_pairs",
         "vj_row_sum", "vj_col_count", "vj_all_max", "vj_all_avg")
#: S·D widths: 72 columns cut into slices of 18 / 9 (the f32 wide body
#: either way), 16 into slices of 4 / 2 on 2 × 2 / 2 × 4 (the narrow
#: body: the whole product runs on every rank)
SPMM_WIDTHS = (72, 16)
#: the durable and delta scenarios' matrix side and one cached entry
DUR_N = 24
DUR_ENTRY = DUR_N * DUR_N * 4


def _lowering_arrays():
    rng = np.random.default_rng(21)
    f = lambda shape: rng.standard_normal(shape).astype(np.float32)
    out = {"X": f((LOW_N, LOW_M)), "Y": f((LOW_N, LOW_M)),
           "Z": f((LOW_M, LOW_N)), "Q": f((LOW_M, LOW_M)),
           "u": f((LOW_N, 1)), "w": f((1, LOW_M)), "v": f((LOW_M, 1)),
           "P": f((LOW_N, LOW_N)),
           "I": rng.integers(-50, 50, (LOW_N, LOW_M)).astype(np.int32),
           "Iq": rng.integers(-50, 50, (LOW_N, LOW_N)).astype(np.int32)}
    out.update({k: f(v) for k, v in JOIN_SHAPES.items()})
    # a few distinct values, so the equality predicates match
    out.update({k: np.round(f(v) * 4) / 4 for k, v in VJ_SHAPES.items()})
    return out


def _lowering_exprs(R, m):
    """name -> expression over one package's BlockMatrices ``m`` (``R``:
    its relational.ops)."""
    X, Y, Z, Q, u, w, v, P, I, Iq = (
        m[k].expr() for k in "X Y Z Q u w v P I Iq".split())
    ex = {
        "add": X.add(Y), "sub_col": X.subtract(u), "div_row": X.divide(w),
        "mul": X.elem_multiply(Y), "max": X.elem_max(Y),
        "min_t": X.elem_min(Z.t()),
        "scalar": X.multiply_scalar(0.5).add_scalar(1.0),
        "pow": Y.power(2.0), "pow0": X.power(0.0),
        "sel_value": X.select_value(lambda x: x > 0),
        "sel_fill": X.select_value(lambda x: x > 0, fill=7.0),
        "sel_index": X.select_index(rows=lambda i: i % 3 == 0,
                                    cols=lambda j: j < 10),
        "sel_block": R.select_blocks(X, lambda bi, bj: bi >= bj,
                                     block_size=8),
        "join_index": X.join_on_index(Y, lambda a, b: a + 2 * b),
        "rank1": X.rank_one_update(u, v),
        "norm": X.norm("fro"), "norm_l1": X.norm("l1"),
        "norm_max": X.norm("max"),
        "tail": X.multiply(Q).elem_multiply(Y).multiply_scalar(0.5)
        .add_scalar(1.0).row_sum(),
        "isum_row": R.aggregate(I, "sum", "row"),
        "imax_col": R.aggregate(I, "max", "col"),
        "imin_all": R.aggregate(I, "min", "all"),
        "isum_diag": R.aggregate(Iq, "sum", "diag"),
    }
    for kind in AGG_KINDS:
        for axis in AGG_AXES:
            ex[f"agg_{kind}_{axis}"] = R.aggregate(
                P if axis == "diag" else X, kind, axis)
    for scheme in ("left", "right", "align"):
        ex[f"jrows_{scheme}"] = R.join_on_rows(
            m["Ja"], m["Jb"], "mul").with_attrs(replicate=scheme)
        ex[f"jcols_{scheme}"] = R.join_on_cols(
            m["Ka"], m["Kb"], lambda a, b: a - b).with_attrs(
                replicate=scheme)
    Va, Vb, Vc = m["Va"], m["Vb"], m["Vc"]
    ex["vj_row_sum"] = R.aggregate(R.join_on_values(Va, Vb, "add", "lt"),
                                   "sum", "row")
    ex["vj_col_count"] = R.aggregate(
        R.join_on_values(Va, Vb, "mul", "eq"), "count", "col")
    ex["vj_all_max"] = R.aggregate(R.join_on_values(Va, Vb, "add", "ge"),
                                   "max", "all")
    ex["vj_all_avg"] = R.aggregate(R.join_on_values(Va, Vb, "mul", "gt"),
                                   "avg", "all")
    ex["vj_callable_row"] = R.aggregate(R.join_on_values(
        Va, Vc, lambda a, b: a * b + 1, lambda a, b: a > b), "max", "row")
    ex["vj_pairs"] = R.join_on_values(Va, Vc, lambda a, b: a - b)
    return ex


def _spmm_arrays(width):
    rng = np.random.default_rng(31)
    s = rng.standard_normal((48, 40)).astype(np.float32)
    s[rng.random((6, 5)).repeat(8, 0).repeat(8, 1) < 0.5] = 0.0
    return s, rng.standard_normal((40, width)).astype(np.float32)


def _dur_arrays():
    rng = np.random.default_rng(41)
    return {nm: rng.standard_normal((DUR_N, DUR_N)).astype(np.float32)
            for nm in ("a", "b", "c")}


def _spill_cfg(Config, root, **over):
    cfg = dict(spill_enable=True,
               result_cache_max_bytes=int(1.5 * DUR_ENTRY),
               result_cache_max_entries=8,
               spill_host_max_bytes=8 * DUR_ENTRY, spill_disk_hits=0,
               state_dir=root)
    cfg.update(over)
    return Config(**cfg)


def _spill_scenario(Session, Config, mesh, root):
    """The spill tiers and a save / restore, in either package: Gram
    queries that evict one another through the host tier (then, with a
    one-byte host budget, to disk), a snapshot, and a fresh session
    restored from it. Returns the counters and every answer."""
    arrs = _dur_arrays()
    gram = lambda s, nm: s.catalog[nm].expr().t().multiply(
        s.catalog[nm].expr())
    out = {"ans": [], "ans2": []}
    sess = Session(mesh=mesh, config=_spill_cfg(Config, root))
    for nm, a in arrs.items():
        sess.register(nm, sess.from_numpy(a))
    for nm in ("a", "b", "a", "c", "b"):
        out["ans"].append(sess.run(gram(sess, nm)).to_numpy())
    out["info1"] = dict(sess.result_cache_info()["spill"])
    disk = Session(mesh=mesh, config=_spill_cfg(
        Config, root, spill_host_max_bytes=1))
    for nm, a in arrs.items():
        disk.register(nm, disk.from_numpy(a))
    for nm in ("a", "b", "c", "a"):
        out["ans"].append(disk.run(gram(disk, nm)).to_numpy())
    out["info_disk"] = dict(disk.result_cache_info()["spill"])
    saved = sess.save_state()
    out["saved"] = {k: saved[k] for k in ("catalog", "rc_entries",
                                          "rc_skipped")}
    again = Session(mesh=mesh, config=_spill_cfg(Config, root))
    rest = again.restore()
    out["restored"] = {k: rest[k] for k in ("restored", "catalog",
                                            "rc_entries")}
    for nm in ("a", "b", "c"):
        out["ans2"].append(again.run(gram(again, nm)).to_numpy())
    out["info2"] = dict(again.result_cache_info()["spill"])
    return out


def _delta_scenario(Session, Config, BSM, mesh):
    """register_delta on a dense and on a block-sparse target, in either
    package: the cached product is patched, and answers the rebound
    product. Returns the summaries (less their wall clock), the cache
    counters and the answers."""
    rng = np.random.default_rng(51)
    a = rng.standard_normal((DUR_N, DUR_N)).astype(np.float32)
    b = rng.standard_normal((DUR_N, DUR_N)).astype(np.float32)
    s = a.copy()
    s[rng.random((3, 3)).repeat(8, 0).repeat(8, 1) < 0.5] = 0.0
    rows = rng.integers(0, DUR_N, 5)
    cols = rng.integers(0, DUR_N, 5)
    vals = rng.standard_normal(5).astype(np.float32)
    sess = Session(mesh=mesh, config=Config(
        result_cache_max_bytes=256 << 20))
    B = sess.from_numpy(b)
    sess.register("A", sess.from_numpy(a))
    sess.register("S", BSM.from_numpy(s, block_size=8, mesh=mesh))
    out = {}
    for name in ("A", "S"):
        q = lambda: sess.catalog[name].expr().multiply(B.expr())
        out[f"{name}_before"] = sess.run(q()).to_numpy()
        rec = sess.register_delta(name, (rows, cols, vals), kind="coo")
        out[f"{name}_summary"] = {k: v for k, v in rec.items() if k != "ms"}
        out[f"{name}_after"] = sess.run(q()).to_numpy()
    info = sess.result_cache_info()
    out["counters"] = {k: info[k] for k in ("hits", "patched")}
    upd = np.zeros((DUR_N, DUR_N), np.float32)
    np.add.at(upd, (rows, cols), vals)
    out["rebound"] = (a + upd, s + upd, b)
    return out


def _graph(seed=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, GRAPH_N, GRAPH_E)
    dst = (src * 7 + rng.integers(0, 40, GRAPH_E)) % GRAPH_N
    return src, dst


def _inputs(world):
    (n, k), (_, m) = SHAPES[world]
    rng = np.random.default_rng(0)
    return (rng.standard_normal((n, k)).astype(np.float32),
            rng.standard_normal((k, m)).astype(np.float32))


def _chain_inputs():
    rng = np.random.default_rng(1)
    return [rng.standard_normal(s).astype(np.float32) for s in CHAIN]


def _stamps(plan):
    """Matmul strategy stamps in post-order (uids differ across
    packages)."""
    out = []

    def walk(n):
        for c in n.children:
            walk(c)
        if n.kind == "matmul":
            out.append(n.attrs.get("strategy"))

    walk(plan.optimized)
    return out


# -- the rank side ----------------------------------------------------------


def _mark(stage: str) -> None:
    """A line in the rank's log, so a world killed at its timeout shows
    where each rank was."""
    print(f"{time.monotonic():.1f} battery: {stage}", flush=True)


def _battery(mesh, world, out_dir):
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.coo import COOMatrix
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.ops import pallas_spmv as pc, spgemm, spmv
    from matrel_tpu_torch.parallel import autotune, collectives as coll
    from matrel_tpu_torch.parallel import reshard, strategies
    from matrel_tpu_torch.session import MatrelSession
    from matrel_tpu_torch.workloads import big_chain, pagerank

    res = {"coords": mesh.ranks.coords, "grid": mesh.grid}
    full = lambda s: coll.gather_full(s, mesh).numpy()

    _mark("strategy recipes")
    # strategy recipes and their collective tallies
    a, b = _inputs(world)
    A, B = (BlockMatrix.from_numpy(x, mesh=mesh) for x in (a, b))
    for s in STRATS:
        coll.reset_tally()
        out = strategies.run_matmul(s, A.as_shard(), B.as_shard(), mesh)
        res[f"mm_tally_{s}"] = (coll.tally("relay"), coll.tally("exec"))
        res[f"mm_layout_{s}"] = out.layout
        res[f"mm_{s}"] = full(out)[: a.shape[0], : b.shape[1]]

    _mark("the session on the rank mesh")
    # the session on the rank mesh: stamps, results, staged reshards
    x, y, z = _chain_inputs()
    for budget in (0, 4096):
        sess = MatrelSession(mesh=mesh, config=MatrelConfig(
            reshard_peak_budget_bytes=budget))
        X, Y, Z = (sess.from_numpy(v) for v in (x, y, z))
        expr = X.multiply(Y).multiply(Z)
        plan = sess.compile(expr)
        res[f"chain_stamps_{budget}"] = _stamps(plan)
        res[f"chain_{budget}"] = sess.compute(expr).to_numpy()
        res[f"chain_add_{budget}"] = sess.compute(
            X.multiply(Y).add(X.multiply(Y))).to_numpy()
        # a transposed leaf flows into the recipe as a swapped layout
        res[f"gram_{budget}"] = sess.compute(X.t().multiply(X)).to_numpy()

    _mark("staged reshard moves")
    # staged reshard moves: bit-equal, one step at a time
    src_full = torch.arange(16 * 24, dtype=torch.float32).reshape(16, 24)
    moved = {}
    for src, dst in RESHARD_PAIRS:
        plan = reshard.compile_reshard(src, dst, 16 * 24 * 4.0, *mesh.grid,
                                       peak_budget=1.0)
        v = coll.shard_from_full(src_full, src, mesh)
        out = reshard.apply_staged(v, plan, mesh)
        moved[(src, dst)] = (plan.step_kinds, out.layout,
                             bool(torch.equal(coll.gather_full(out, mesh),
                                              src_full)))
    res["reshard_moves"] = moved
    plan2 = reshard.compile_reshard("row", "col", 4096 * 4.0, *mesh.grid,
                                    peak_budget=1.0)
    res["reshard_times"] = {v: autotune.measure_reshard_variant(
        v, plan2, mesh, n_times=1) for v in autotune.RESHARD_VARIANTS}
    res["reshard_choice"] = autotune.lookup_or_measure_reshard(plan2, mesh)

    _mark("sharded SpMV / SpMM")
    # sharded SpMV / SpMM over a COO graph: B2/B3 (plain on the CPU) per
    # rank, the expanded slices, and the executor's COO path
    src, dst = _graph()
    vals = np.random.default_rng(6).random(GRAPH_E).astype(np.float32)
    M = COOMatrix.from_edges(dst, src, vals, shape=(GRAPH_N, GRAPH_N))
    Ms = M.shard(mesh)
    xv = np.random.default_rng(7).standard_normal(GRAPH_N).astype(np.float32)
    Xk = np.random.default_rng(8).standard_normal(
        (GRAPH_N, 5)).astype(np.float32)
    res["coo_matvec"] = Ms.matvec(xv).numpy()
    res["coo_matmat"] = Ms.matmat(Xk).numpy()
    res["coo_one_card"] = (M.matvec(xv, device="cpu").numpy(),
                           M.matmat(Xk, device="cpu").numpy())
    plan = M._get_plan()
    res["spmv_expanded"] = spmv.spmv_sharded(plan, xv, mesh).numpy()
    res["spmm_expanded"] = spmv.spmm_sharded(plan, Xk, mesh).numpy()
    res["spmv_plain_tables"] = pc.spmv_compact_sharded(
        plan, xv, mesh, use_pallas=False).numpy()
    sl = spmv.shard_plan(plan, mesh)
    res["slice"] = (sl.local.n_rows, sl.local.src8.shape,
                    id(pc.csr_view_on(sl.local, mesh.device))
                    != id(pc.csr_view_on(plan, mesh.device)))
    sess = MatrelSession(mesh=mesh)
    Xb = sess.from_numpy(Xk)
    res["coo_compute"] = sess.compute(M.expr().multiply(Xb)).to_numpy()

    _mark("sharded PageRank")
    # sharded PageRank, both executors
    res["pagerank"] = pagerank.pagerank_edges(
        src, dst, GRAPH_N, rounds=20, impl="onehot", mesh=mesh).numpy()
    res["pagerank_one_card"] = pagerank.pagerank_edges(
        src, dst, GRAPH_N, rounds=20, impl="onehot", device="cpu").numpy()

    _mark("the sparse scale-out")
    # the sparse scale-out composites
    SA = BlockSparseMatrix.random((64, 64), 0.3, block_size=8, mesh=mesh,
                                  seed=2)
    SB = BlockSparseMatrix.random((64, 64), 0.3, block_size=8, mesh=mesh,
                                  seed=3)
    res["spgemm_in"] = (SA.to_numpy(), SB.to_numpy())
    res["spgemm"] = spgemm.spgemm_sharded(SA, SB).to_numpy()
    D = np.random.default_rng(9).standard_normal((64, 16)).astype(np.float32)
    res["spmm"] = SA.shard(mesh).multiply(
        BlockMatrix.from_numpy(D, mesh=mesh)).to_numpy()

    _mark("the north-star chain")
    # the north-star chain: panels over the ranks, one all_reduce
    gens = [big_chain.cheap_gen(s, CHAIN_TILE, torch.float32,
                                device=mesh.device) for s in (0, 1, 2)]
    panel = CHAIN_N // mesh.size
    res["chain_sharded"] = float(big_chain.streaming_chain_sharded(
        CHAIN_N, *gens, mesh, tile=CHAIN_TILE, panel=panel,
        dtype=torch.float32))
    res["chain_slab"] = float(big_chain.streaming_chain_slab(
        CHAIN_N, *gens, tile=CHAIN_TILE, panel=panel, dtype=torch.float32))

    _mark("a checkpoint on the ranks")
    # utils/checkpoint.py on a rank mesh: the save gathers (every rank),
    # rank 0 writes; each rank restores its own block under the spec
    import torch.distributed as dist
    from matrel_tpu_torch.utils.checkpoint import CheckpointManager
    cm = CheckpointManager(os.path.join(out_dir, "ckpt"))
    cm.save(0, matrices={"A": A}, state={"world": world})
    dist.barrier()
    step, mats, _arrs, state = cm.restore(mesh)
    got = mats["A"]
    res["ckpt"] = (step, state, tuple(got.spec) == tuple(A.spec),
                   got.shape == A.shape,
                   bool(torch.equal(got.data, A.data)),
                   bool(np.array_equal(got.to_numpy(), a)))

    _mark("sharded lowerings")
    res.update(_sharded_battery(mesh, out_dir))

    _mark("a measured matmul choice")
    # a measured matmul choice: rank 0's medians on every rank
    best, times = autotune.autotune_matmul(16, 16, 16, mesh=mesh)
    res["autotune"] = (best, times)

    res["loaded"] = sorted(m for m in sys.modules
                           if m.split(".")[0] in ("jax", "jaxlib",
                                                  "matrel_tpu"))
    return res


def _sharded_battery(mesh, out_dir):
    """The sharded lowerings, B1 on column slices, fused regions, unit
    programs, register_delta and the spill tiers on the ranks, each with
    the one-card answer beside it where the tests hold the two
    bit-equal."""
    from matrel_tpu_torch import executor
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.core import padding
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.parallel import autotune, collectives as coll
    from matrel_tpu_torch.relational import ops as R
    from matrel_tpu_torch.resilience.errors import SnapshotGridMismatch
    from matrel_tpu_torch.session import MatrelSession
    res = {}
    one_mesh = make_mesh(device="cpu")
    sess, one = MatrelSession(mesh=mesh), MatrelSession(mesh=one_mesh)
    arrs = _lowering_arrays()
    exprs = _lowering_exprs(R, {k: sess.from_numpy(a)
                                for k, a in arrs.items()})
    oexprs = _lowering_exprs(R, {k: one.from_numpy(a)
                                 for k, a in arrs.items()})
    low = {}
    for name, e in exprs.items():
        coll.reset_tally()
        got = sess.compute(e)
        tally = coll.tally()
        low[name] = (tally, got.to_numpy(), one.compute(oexprs[name])
                     .to_numpy())
    res["lowerings"] = low

    def whole(block, shape):
        ps = padding.padded_shape(shape, mesh)
        sh = coll.Shard(block, coll.layout_of(
            padding.canonical_spec(ps, mesh), mesh), ps)
        return coll.gather_full(sh, mesh)[: shape[0], : shape[1]].numpy()

    # B1 on each rank's column slice of D (its plain version here), a
    # sharded tail read in place, the choice in the plan's decisions
    spmm = {}
    for width in SPMM_WIDTHS:
        s, d = _spmm_arrays(width)
        S = BlockSparseMatrix.from_numpy(s, block_size=8, mesh=mesh)
        oS = BlockSparseMatrix.from_numpy(s, block_size=8, mesh=one_mesh)
        D, oD = sess.from_numpy(d), one.from_numpy(d)
        e = S.multiply(D)
        tail = S.multiply(D).multiply_scalar(0.5).add_scalar(1.0).row_sum()
        coll.reset_tally()
        prod = sess.compute(e)
        prod_tally = coll.tally()
        coll.reset_tally()
        tail_out = sess.compute(tail)
        tail_tally = coll.tally()
        fs = MatrelSession(mesh=mesh, config=MatrelConfig(
            fusion_enable=True))
        fused_tail = S.multiply(fs.from_numpy(d)).multiply_scalar(0.5)\
            .add_scalar(1.0)
        fplan = fs.compile(fused_tail)
        spmm[width] = {
            "split": [rec.get("spmm_ranks") for rec in
                      executor.plan_matmul_decisions(sess.compile(e))],
            "prod": prod.to_numpy(), "prod_tally": prod_tally,
            "one": one.compute(oS.multiply(oD)).to_numpy(),
            "tail": tail_out.to_numpy(), "tail_tally": tail_tally,
            "one_tail": one.compute(oS.multiply(oD).multiply_scalar(0.5)
                                    .add_scalar(1.0).row_sum()).to_numpy(),
            "fused_regions": fplan.meta["fusion"]["regions"],
            "fused": fs.compute(fused_tail).to_numpy(),
            "staged": sess.compute(S.multiply(D).multiply_scalar(0.5)
                                   .add_scalar(1.0)).to_numpy(),
        }
    res["spmm_cols"] = spmm

    # fused regions against staged ones, and the plan as unit programs
    x, q, y = (sess.from_numpy(arrs[k]) for k in "XQY")
    fcfg = MatrelConfig(fusion_enable=True)
    fs = MatrelSession(mesh=mesh, config=fcfg)
    fx, fq, fy = (fs.from_numpy(arrs[k]) for k in "XQY")
    chain = lambda a, b, c: a.multiply(b).elem_multiply(c)\
        .multiply_scalar(0.5).add_scalar(1.0)
    e = chain(fx, fq, fy)
    coll.reset_tally()
    fused = fs.compute(e).to_numpy()
    fused_tally = coll.tally()
    staged_u = executor.compile_staged_units(e, mesh, fcfg)
    region_u = executor.compile_region_units(e, mesh, fcfg)
    res["fusion"] = {
        "regions": fs.compile(e).meta["fusion"]["regions"],
        "fused": fused, "fused_tally": fused_tally,
        "staged": sess.compute(chain(x, q, y)).to_numpy(),
        "staged_units": whole(staged_u.run(), (LOW_N, LOW_M)),
        "region_units": whole(region_u.run(), (LOW_N, LOW_M)),
        "dispatches": (staged_u.dispatches, region_u.dispatches),
    }

    # the autotune fuse| probes on the ranks: the region measured over
    # each rank's Shards of the probe arrays, rank 0's medians agreed
    table = os.path.join(out_dir, "fuse_autotune.json")
    autotune.clear_caches()
    acfg = fcfg.replace(autotune=True, autotune_table_path=table)
    asess = MatrelSession(mesh=mesh, config=acfg)
    ae = chain(*(asess.from_numpy(arrs[k]) for k in "XQY"))
    aplan = asess.compile(ae)
    aout = asess.compute(ae).to_numpy()
    res["fuse_autotune"] = {
        "rows": {k: v for k, v in autotune.load_table(table).items()
                 if k.startswith("fuse|")},
        "regions": aplan.meta["fusion"]["regions"],
        "out": aout}

    res["delta"] = _delta_scenario(MatrelSession, MatrelConfig,
                                   BlockSparseMatrix, mesh)

    root = os.path.join(out_dir, "spill_state")
    res["spill"] = _spill_scenario(MatrelSession, MatrelConfig, mesh, root)
    suffix = f".r{mesh.ranks.rank}.{mesh.grid[0]}x{mesh.grid[1]}.npy"
    files = sorted(os.listdir(os.path.join(root, "spill")))
    res["spill_files"] = (len(files), sum(f.endswith(suffix) for f in files))
    other = MatrelSession(mesh=one_mesh, config=_spill_cfg(MatrelConfig,
                                                           root))
    try:
        other.restore()
        res["spill_other_grid"] = "restored"
    except SnapshotGridMismatch as e:
        res["spill_other_grid"] = (e.saved, e.current)
    # the fleet builds on a rank mesh: each slice a group of ranks
    fsess = MatrelSession(mesh=mesh, config=MatrelConfig(fleet_slices=2))
    res["fleet_source"] = fsess._ensure_fleet().source
    fsess.serve_close(timeout=60)
    return res


def _rank_main(rank, world_size, grid, store, out_dir):
    """One rank: its output into ``rank<r>.log``, its results into
    ``rank<r>.pkl``."""
    log = open(os.path.join(out_dir, f"rank{rank}.log"), "w")
    os.dup2(log.fileno(), 1)
    os.dup2(log.fileno(), 2)
    torch.set_num_threads(1)
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.parallel import autotune
    autotune._DEFAULT_TABLE = os.path.join(out_dir, "autotune.json")
    mesh = mesh_lib.init_distributed("gloo", "file://" + store, world_size,
                                     rank, grid=grid, device="cpu",
                                     timeout_s=JOIN_TIMEOUT_S)
    try:
        res = _battery(mesh, f"{grid[0]}x{grid[1]}", out_dir)
    except BaseException:
        traceback.print_exc()          # into the rank's log
        raise                          # the parent kills the world
    mesh_lib.shutdown_distributed()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(res, f)


def _run_world(grid, tmp_dir):
    import torch.multiprocessing as mp
    n = grid[0] * grid[1]
    store = os.path.join(tmp_dir, "store")
    os.environ["OMP_NUM_THREADS"] = "1"
    ctx = mp.start_processes(_rank_main, args=(n, grid, store, tmp_dir),
                             nprocs=n, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"world {grid} did not finish in "
                                   f"{JOIN_TIMEOUT_S} s")
    except Exception as e:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        logs = []
        for r in range(n):
            path = os.path.join(tmp_dir, f"rank{r}.log")
            if os.path.exists(path):
                logs.append(f"--- rank {r} ---\n"
                            + open(path).read()[-3000:])
        pytest.fail(f"{e!r}\n" + "\n".join(logs))
    out = []
    for r in range(n):
        with open(os.path.join(tmp_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    return {name: _run_world(grid, str(tmp_path_factory.mktemp(name)))
            for name, grid in WORLDS.items()}


# -- the test side ------------------------------------------------------------


def _jax_mesh(world):
    import jax
    from matrel_tpu.core import mesh as mesh_lib
    gx, gy = WORLDS[world]
    return mesh_lib.make_mesh((gx, gy), devices=jax.devices()[:gx * gy])


def _jax_matmul(strategy, a, b, mesh):
    import jax
    from matrel_tpu.core.blockmatrix import BlockMatrix
    from matrel_tpu.parallel import strategies
    A = BlockMatrix.from_numpy(a, mesh=mesh)
    B = BlockMatrix.from_numpy(b, mesh=mesh)
    f = jax.jit(lambda x, y: strategies.run_matmul(strategy, x, y, mesh,
                                                   None))
    return np.asarray(f(A.data, B.data))[: a.shape[0], : b.shape[1]]


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", STRATS)
def test_strategy_matches_jax(worlds, world, strategy):
    a, b = _inputs(world)
    want = _jax_matmul(strategy, a, b, _jax_mesh(world))
    for r in worlds[world]:
        np.testing.assert_allclose(r[f"mm_{strategy}"], want, rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_allclose(r[f"mm_{strategy}"], a @ b, rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_collective_tallies(worlds, world):
    """The JAX tests' HLO assertions, as counted collectives: CPMM one
    reduce-scatter on y; RMM and BMM nothing after their input re-lay
    (RMM's re-lay only gathers); SUMMA point-to-point only on a square
    grid and CPMM's reduce-scatter on 2×4."""
    t = worlds[world][0]
    relay = {s: t[f"mm_tally_{s}"][0] for s in STRATS}
    exe = {s: t[f"mm_tally_{s}"][1] for s in STRATS}
    assert exe["cpmm"] == {"reduce_scatter:y": 1}
    assert exe["rmm"] == {} and exe["bmm_left"] == {} \
        and exe["bmm_right"] == {} and exe["xla"] == {}
    assert all(k.startswith("all_gather") for k in relay["rmm"])
    if world == "2x2":
        assert set(exe["summa"]) == {"p2p:x", "p2p:y"}
        # g-1 skew shifts + g-1 ring shifts per axis at g = 2
        assert exe["summa"] == {"p2p:x": 2, "p2p:y": 2}
    else:
        assert exe["summa"] == {"reduce_scatter:y": 1}
    assert t["mm_layout_bmm_right"] == (("x", "y"), ())
    assert t["mm_layout_bmm_left"] == ((), ("x", "y"))


@pytest.mark.parametrize("world", WORLDS)
def test_chain_stamps_and_results(worlds, world):
    """Stamps equal the JAX planner's on the same grid, on every rank;
    results match numpy; a budgeted plan (staged reshards moving for
    real) is bit-equal to budget 0."""
    from matrel_tpu import executor as j_exec
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    x, y, z = _chain_inputs()
    mesh = _jax_mesh(world)
    X, Y, Z = (JBM.from_numpy(v, mesh=mesh) for v in (x, y, z))
    jplan = j_exec.compile_expr(X.multiply(Y).multiply(Z), mesh)
    want = _stamps(jplan)
    for r in worlds[world]:
        assert r["chain_stamps_0"] == want
        np.testing.assert_allclose(r["chain_0"], x @ y @ z, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(r["chain_4096"], r["chain_0"])
        np.testing.assert_array_equal(r["chain_add_4096"],
                                      r["chain_add_0"])
        np.testing.assert_allclose(r["chain_add_0"], 2 * (x @ y),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["gram_0"], x.T @ x, rtol=1e-4,
                                   atol=1e-3)
        np.testing.assert_array_equal(r["gram_4096"], r["gram_0"])


@pytest.mark.parametrize("world", WORLDS)
def test_reshard_moves_bit_equal(worlds, world):
    """Every staged plan moves the blocks to the plan's final state, and
    the gathered matrix is bit-equal to the input; the plans are the
    JAX package's step for step."""
    from matrel_tpu.parallel import reshard as j_reshard
    from matrel_tpu_torch.parallel import collectives as coll
    gx, gy = WORLDS[world]
    for r in worlds[world]:
        for (src, dst), (kinds, layout, equal) in r["reshard_moves"].items():
            jp = j_reshard.compile_reshard(src, dst, 16 * 24 * 4.0, gx, gy,
                                           peak_budget=1.0)
            assert kinds == jp.step_kinds, (src, dst)
            assert equal, (src, dst)
            assert layout == coll.STATES[dst], (src, dst)


@pytest.mark.parametrize("world", WORLDS)
def test_reshard_measured_on_ranks(worlds, world):
    for r in worlds[world]:
        assert set(r["reshard_times"]) == {"staged", "naive"}
        assert all(t > 0 for t in r["reshard_times"].values())
    choices = {r["reshard_choice"] for r in worlds[world]}
    assert len(choices) == 1


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_spmv_spmm(worlds, world):
    """B2/B3's plain versions on each rank's slice equal the one-card
    result bit for bit; the expanded slices and the JAX package's sharded
    matvec agree within f32 rounding."""
    from matrel_tpu.core.coo import COOMatrix as JCOO
    src, dst = _graph()
    vals = np.random.default_rng(6).random(GRAPH_E).astype(np.float32)
    xv = np.random.default_rng(7).standard_normal(GRAPH_N).astype(np.float32)
    Xk = np.random.default_rng(8).standard_normal(
        (GRAPH_N, 5)).astype(np.float32)
    JM = JCOO.from_edges(dst, src, vals, shape=(GRAPH_N, GRAPH_N)).shard(
        _jax_mesh(world))
    want_v = np.asarray(JM.matvec(xv))
    want_m = np.asarray(JM.matmat(Xk))
    for r in worlds[world]:
        one_v, one_m = r["coo_one_card"]
        np.testing.assert_array_equal(r["coo_matvec"], one_v)
        np.testing.assert_array_equal(r["coo_matmat"], one_m)
        np.testing.assert_array_equal(r["spmv_plain_tables"], one_v)
        np.testing.assert_array_equal(r["coo_compute"], one_m)
        for got, want in ((r["coo_matvec"], want_v),
                          (r["spmv_expanded"], want_v),
                          (r["coo_matmat"], want_m),
                          (r["spmm_expanded"], want_m)):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        n_rows, shape, own_view = r["slice"]
        p = WORLDS[world][0] * WORLDS[world][1]
        assert n_rows * p >= GRAPH_N and shape[0] * 512 == n_rows
        assert own_view


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pagerank(worlds, world):
    from matrel_tpu.workloads import pagerank as j_pr
    src, dst = _graph()
    want = np.asarray(j_pr.pagerank_edges(src, dst, GRAPH_N, rounds=20,
                                          impl="onehot",
                                          mesh=_jax_mesh(world)))
    a = np.zeros((GRAPH_N, GRAPH_N), np.float64)
    np.add.at(a, (src, dst), 1.0)
    ref = j_pr.pagerank_numpy_oracle(a, rounds=20)
    for r in worlds[world]:
        np.testing.assert_array_equal(r["pagerank"], r["pagerank_one_card"])
        np.testing.assert_allclose(r["pagerank"], want, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(r["pagerank"], np.ravel(ref), atol=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_spgemm_and_spmm_sharded(worlds, world):
    from matrel_tpu.core.sparse import BlockSparseMatrix as JBS
    from matrel_tpu.ops import spgemm as j_spgemm
    from matrel_tpu.ops.spmm_sharded import shard_block_sparse
    from matrel_tpu.ops.spmm_sharded import spmm_sharded as j_spmm
    mesh = _jax_mesh(world)
    r0 = worlds[world][0]
    a, b = r0["spgemm_in"]
    JA, JB = (JBS.from_numpy(v, block_size=8, mesh=mesh) for v in (a, b))
    want = np.asarray(j_spgemm.spgemm_sharded(JA, JB).to_numpy())
    D = np.random.default_rng(9).standard_normal((64, 16)).astype(np.float32)
    want_mm = np.asarray(j_spmm(shard_block_sparse(JA, mesh), D).to_numpy())
    for r in worlds[world]:
        np.testing.assert_allclose(r["spgemm"], want, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["spgemm"], a @ b, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["spmm"], want_mm, rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(r["spmm"], a @ D, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_streaming_chain_sharded(worlds, world):
    """One panel body a rank and one all_reduce: equal to the one-card
    slab schedule and to the JAX package's sharded chain within the
    reduction-order bound (f32 sums of ``mesh.size`` partials)."""
    import jax.numpy as jnp
    from matrel_tpu.workloads import big_chain as j_bc
    mesh = _jax_mesh(world)
    gens = [j_bc.cheap_gen(s, CHAIN_TILE, jnp.float32) for s in (0, 1, 2)]
    panel = CHAIN_N // mesh.size
    want = float(j_bc.streaming_chain_sharded(
        CHAIN_N, *gens, mesh, tile=CHAIN_TILE, panel=panel,
        dtype=jnp.float32))
    for r in worlds[world]:
        assert r["chain_sharded"] == pytest.approx(r["chain_slab"],
                                                   rel=1e-6)
        assert r["chain_sharded"] == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("world", WORLDS)
def test_measured_choice_agreed(worlds, world):
    """autotune_matmul on the rank grid: every rank holds rank 0's
    medians and winner."""
    outs = [r["autotune"] for r in worlds[world]]
    assert all(o == outs[0] for o in outs)
    assert outs[0][1], "no strategy was measured"


@pytest.mark.parametrize("world", WORLDS)
def test_checkpoint_on_ranks(worlds, world):
    """Every rank restores its own block of the rank-laid matrix, bit
    for bit, under the saved spec and state."""
    for r in worlds[world]:
        assert r["ckpt"] == (0, {"world": world}, True, True, True, True)


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_import_no_jax(worlds, world):
    for r in worlds[world]:
        assert r["loaded"] == []
    assert sorted(r["coords"] for r in worlds[world]) == [
        (i, j) for i in range(WORLDS[world][0])
        for j in range(WORLDS[world][1])]


def test_virtual_mesh_unchanged():
    """The one-card virtual grid holds whole tensors and runs every
    strategy as one local product, as before."""
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch.parallel import strategies
    from matrel_tpu_torch.core import mesh as mesh_lib
    from matrel_tpu_torch.parallel import collectives as coll
    mesh = make_mesh((2, 4), device="cpu")
    assert not mesh.ranked and mesh.ranks is None
    for spec, state in ((mesh_lib.replicated, "rep"),
                        (mesh_lib.sharding_2d, "2d"),
                        (mesh_lib.sharding_row, "row"),
                        (mesh_lib.sharding_col, "col")):
        assert coll.layout_of(spec(mesh), mesh) == coll.STATES[state]
    a, b = _inputs("2x4")
    A = BlockMatrix.from_numpy(a, mesh=mesh)
    assert A.data.shape == A.padded_shape
    for s in STRATS:
        out = strategies.run_matmul(s, A.data, BlockMatrix.from_numpy(
            b, mesh=mesh).data, mesh)
        assert isinstance(out, torch.Tensor)
        np.testing.assert_allclose(out.numpy()[:16, :32], a @ b,
                                   rtol=1e-5, atol=1e-5)


def test_backend_is_explicit():
    from matrel_tpu_torch.core import mesh as mesh_lib
    with pytest.raises(ValueError, match="backend"):
        mesh_lib.init_distributed("mpi", "file:///nonexistent", 1, 0)
    if torch.cuda.device_count() < 4:
        with pytest.raises(mesh_lib.DeviceUnavailableError, match="nccl"):
            mesh_lib.init_distributed("nccl", "file:///nonexistent", 4, 0)


# -- the sharded lowerings (``_sharded_battery``) -------------------------------

#: f32's unit roundoff
U32 = 2.0 ** -24


def _jax_lowerings(world):
    """The JAX package's answers to ``_lowering_exprs`` on the world's
    CPU mesh (``mesh_square`` / ``mesh8``)."""
    from matrel_tpu import executor as j_exec
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    from matrel_tpu.relational import ops as JR
    mesh = _jax_mesh(world)
    arrs = _lowering_arrays()
    ex = _lowering_exprs(JR, {k: JBM.from_numpy(a, mesh=mesh)
                              for k, a in arrs.items()})
    return {k: np.asarray(j_exec.execute(e, mesh).to_numpy())
            for k, e in ex.items()}


def _numpy_oracle(arrs):
    """name -> float64 numpy answer of every ``_lowering_exprs`` entry
    (logical shapes)."""
    a = {k: v.astype(np.float64) for k, v in arrs.items()}
    X, Y, Z, Q, u, w, v, P = (a[k] for k in "X Y Z Q u w v P".split())
    n, m = X.shape
    i, j = np.arange(n)[:, None], np.arange(m)[None, :]
    out = {
        "add": X + Y, "sub_col": X - u,
        "div_row": np.where(w == 0, 0.0, X / np.where(w == 0, 1.0, w)),
        "mul": X * Y, "max": np.maximum(X, Y), "min_t": np.minimum(X, Z.T),
        "scalar": X * 0.5 + 1.0, "pow": Y ** 2, "pow0": np.ones_like(X),
        "sel_value": np.where(X > 0, X, 0.0),
        "sel_fill": np.where(X > 0, X, 7.0),
        "sel_index": np.where((i % 3 == 0) & (j < 10), X, 0.0),
        "sel_block": np.where(i // 8 >= j // 8, X, 0.0),
        "join_index": X + 2 * Y, "rank1": X + u @ v.T,
        "norm": np.sqrt((X * X).sum()).reshape(1, 1),
        "norm_l1": np.abs(X).sum().reshape(1, 1),
        "norm_max": np.abs(X).max().reshape(1, 1),
        "tail": ((X @ Q) * Y * 0.5 + 1.0).sum(1, keepdims=True),
        "isum_row": a["I"].sum(1, keepdims=True),
        "imax_col": a["I"].max(0, keepdims=True),
        "imin_all": a["I"].min().reshape(1, 1),
        "isum_diag": np.trace(a["Iq"]).reshape(1, 1),
    }
    reds = {"sum": np.sum, "count": np.count_nonzero, "max": np.max,
            "min": np.min}
    for kind in AGG_KINDS:
        for axis in AGG_AXES:
            src = np.diag(P)[None, :] if axis == "diag" else X
            ax = {"row": 1, "col": 0}.get(axis)
            kw = {"axis": ax, "keepdims": True} if ax is not None else {}
            if kind == "avg":
                r = reds["sum"](src, **kw) / reds["count"](src, **kw)
            else:
                r = reds[kind](src, **kw)
            out[f"agg_{kind}_{axis}"] = np.asarray(
                r, np.float64).reshape(-1 if ax == 1 else 1,
                                       -1 if ax == 0 else 1)
    pr = (a["Ja"][:, :, None] * a["Jb"][:, None, :]).reshape(n, -1)
    pc = (a["Ka"][:, None, :] - a["Kb"][None, :, :]).reshape(-1, m)
    for scheme in ("left", "right", "align"):
        out[f"jrows_{scheme}"], out[f"jcols_{scheme}"] = pr, pc
    va, vb, vc = (a[k].T.reshape(-1) for k in ("Va", "Vb", "Vc"))
    A, B, C = va[:, None], vb[None, :], vc[None, :]
    rs = np.where(A < B, A + B, 0.0)
    out["vj_row_sum"] = rs.sum(1, keepdims=True)
    out["vj_col_count"] = np.count_nonzero(np.where(A == B, A * B, 0.0),
                                           axis=0, keepdims=True)
    out["vj_all_max"] = np.where(A >= B, A + B, 0.0).max().reshape(1, 1)
    g = np.where(A > B, A * B, 0.0)
    out["vj_all_avg"] = (g.sum() / np.count_nonzero(g)).reshape(1, 1)
    out["vj_callable_row"] = np.where(A > C, A * C + 1, 0.0).max(
        1, keepdims=True)
    out["vj_pairs"] = A - C
    return out


def _sum_bound(name, arrs):
    """For an aggregate that sums f32 terms: 2·K·u·Σ|x| over the K
    terms each output sums (the rank mesh's sum of ``mesh.size``
    partials and one card's running sum each lie within K·u·Σ|x| of the
    exact sum), divided by the count for an average; (K + 2)·u·‖X‖ for
    the Frobenius norm (the sum's bound through the square root, and
    its rounding). None for a lowering held by another rule."""
    parts = name.split("_")
    if name == "norm":
        x = arrs["X"].astype(np.float64)
        return (x.size + 2) * U32 * np.sqrt((x * x).sum())
    if name == "norm_l1":
        x = np.abs(arrs["X"].astype(np.float64))
        return 2 * x.size * U32 * x.sum()
    if parts[0] != "agg" or parts[1] not in ("sum", "avg"):
        return None
    axis = parts[2]
    x = np.abs(arrs["P" if axis == "diag" else "X"].astype(np.float64))
    if axis == "row":
        s, k = x.sum(1, keepdims=True), x.shape[1]
    elif axis == "col":
        s, k = x.sum(0, keepdims=True), x.shape[0]
    elif axis == "all":
        s, k = x.sum().reshape(1, 1), x.size
    else:
        s, k = np.diag(x).sum().reshape(1, 1), x.shape[0]
    if parts[1] == "avg":
        s = s / k             # gaussian entries: every term is nonzero
    return 2 * k * U32 * s


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lowerings_match(worlds, world):
    """Every lowering of items 2–4 on the ranks: elementwise, scalar, σ,
    index and row/col joins, rank1 and the value joins bit-equal to one
    card; integer aggregates, counts, max and min equal; f32 sums and
    averages within 2·K·u·Σ|x| of one card's (``_sum_bound``); all
    within the same bounds (or 1e-5, 1e-4 for the value joins' f32
    sums and the matmul tail) of the JAX package on the conftest's
    mesh, and of float64 numpy (``_numpy_oracle``; rtol 1e-5, atol 1e-4,
    1e-3 for the matmul tail, the sum bound for f32 sums)."""
    arrs = _lowering_arrays()
    jax_out = _jax_lowerings(world)
    oracle = _numpy_oracle(arrs)
    for r in worlds[world]:
        for name, (_tally, got, one) in r["lowerings"].items():
            want = jax_out[name]
            assert got.shape == one.shape == want.shape, name
            bound = _sum_bound(name, arrs)
            exact = oracle[name]
            if bound is not None:
                assert (np.abs(got - exact) <= bound).all(), name
            else:
                np.testing.assert_allclose(
                    got, exact, rtol=1e-5,
                    atol=1e-3 if name == "tail" else 1e-4, err_msg=name)
            if name in EXACT or name.startswith(("agg_count", "agg_max",
                                                 "agg_min", "i", "norm_max")):
                np.testing.assert_array_equal(got, one, err_msg=name)
            elif bound is not None:
                assert (np.abs(got.astype(np.float64) - one)
                        <= bound).all(), name
            if bound is not None:
                assert (np.abs(got.astype(np.float64) - want)
                        <= bound).all(), name
            elif name.startswith(("vj_", "tail")):
                np.testing.assert_allclose(got, want, rtol=1e-5,
                                           atol=1e-4, err_msg=name)
                np.testing.assert_allclose(got, one, rtol=1e-5,
                                           atol=1e-4, err_msg=name)
            else:
                np.testing.assert_allclose(got, want, rtol=1e-6,
                                           atol=1e-6, err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_lowering_tallies(worlds, world):
    """No whole gather (``gather_rep``) but where a lowering keeps one:
    a broadcast vector (one), rank1's two vectors, the replicated
    operand of a "left" / "right" join (exactly one), a value join's
    two entry vectors. The ((A·B) ⊙ C) * 0.5 + 1 → row_sum tail counts
    none; "align" moves no whole operand (no all-gather of any kind —
    the JAX package's ``test_align_hlo_avoids_full_operand_allgather``);
    aggregates reduce over their axis group only."""
    want = {"sub_col": 1, "div_row": 1, "rank1": 2, "jrows_left": 1,
            "jrows_right": 1, "jcols_left": 1, "jcols_right": 1}
    for r in worlds[world]:
        for name, (tally, _got, _one) in r["lowerings"].items():
            gathers = tally.get("gather_rep:world", 0)
            if name not in GATHERS:
                assert gathers == 0, (name, tally)
            elif name.startswith("vj_"):
                assert gathers == 2, (name, tally)
            else:
                assert gathers == want[name], (name, tally)
        for scheme in ("jrows_align", "jcols_align"):
            tally = r["lowerings"][scheme][0]
            assert not any(k.startswith(("all_gather", "gather_rep"))
                           for k in tally), (scheme, tally)
        assert r["lowerings"]["agg_sum_row"][0] == {"axis_reduce:y": 1}
        assert r["lowerings"]["agg_max_col"][0] == {"axis_reduce:x": 1}
        assert r["lowerings"]["agg_count_all"][0] == {
            "axis_reduce:world": 1}
        assert "gather_rep:world" not in r["lowerings"]["tail"][0]
        assert r["lowerings"]["vj_row_sum"][0]["share_gather:world"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_spmm_column_slices(worlds, world):
    """S·D on the ranks: 72 columns run B1 (its plain version here) on
    each rank's column slice, the product a Shard by columns that the
    sharded tail reads in place (no whole gather) and that fused and
    staged lowerings agree on; 16 columns (a slice of 4 / 2 would fall
    to the narrow body) run the whole product on every rank, recorded
    as such. Both bit-equal to one card, and within 1e-4 of the JAX
    package and float64 numpy."""
    from matrel_tpu import executor as j_exec
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    from matrel_tpu.core.sparse import BlockSparseMatrix as JBS
    mesh = _jax_mesh(world)
    for width in SPMM_WIDTHS:
        s, d = _spmm_arrays(width)
        jS = JBS.from_numpy(s, block_size=8, mesh=mesh)
        want = np.asarray(j_exec.execute(
            jS.multiply(JBM.from_numpy(d, mesh=mesh)), mesh).to_numpy())
        exact = s.astype(np.float64) @ d
        for r in worlds[world]:
            rec = r["spmm_cols"][width]
            assert rec["split"] == (["col_slice"] if width == 72
                                    else ["whole"])
            np.testing.assert_array_equal(rec["prod"], rec["one"])
            np.testing.assert_allclose(rec["prod"], want, rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(rec["prod"], exact, rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(rec["tail"], rec["one_tail"],
                                       rtol=1e-5, atol=1e-4)
            np.testing.assert_allclose(
                rec["tail"], (0.5 * exact + 1.0).sum(1, keepdims=True),
                rtol=1e-4, atol=1e-3)
            assert rec["fused_regions"] == 1
            np.testing.assert_array_equal(rec["fused"], rec["staged"])
            if width == 72:
                assert "gather_rep:world" not in rec["prod_tally"]
                assert "gather_rep:world" not in rec["tail_tally"]
            else:
                assert rec["prod_tally"]["gather_rep:world"] == 1


@pytest.mark.parametrize("world", WORLDS)
def test_fused_regions_and_unit_programs(worlds, world):
    """A fused region on the ranks (the epilogue on each rank's block of
    the anchor output) equals the staged lowering bit for bit; the plan
    as staged and as region unit programs equals both; region and
    dispatch counts are the JAX package's on its mesh, and the values
    within 1e-4 of its fused result."""
    from matrel_tpu import executor as j_exec
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    mesh = _jax_mesh(world)
    arrs = _lowering_arrays()
    cfg = JConfig(fusion_enable=True)
    x, q, y = (JBM.from_numpy(arrs[k], mesh=mesh) for k in "XQY")
    e = x.multiply(q).elem_multiply(y).multiply_scalar(0.5).add_scalar(1.0)
    plan = j_exec.compile_expr(e, mesh, cfg)
    want = np.asarray(plan.run().to_numpy())
    staged = j_exec.compile_staged_units(e, mesh, cfg)
    region = j_exec.compile_region_units(e, mesh, cfg)
    for r in worlds[world]:
        f = r["fusion"]
        assert f["regions"] == plan.meta["fusion"]["regions"] == 1
        assert f["dispatches"] == (staged.dispatches, region.dispatches)
        np.testing.assert_array_equal(f["fused"], f["staged"])
        np.testing.assert_array_equal(f["staged_units"], f["fused"])
        np.testing.assert_array_equal(f["region_units"], f["fused"])
        np.testing.assert_allclose(f["fused"], want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_register_delta_on_ranks(worlds, world):
    """register_delta on a dense target (each rank scatters the entries
    inside its block) and a block-sparse one (every rank rebuilds the
    touched tiles): the cached products are patched, the summaries and
    counters are the JAX package's on its mesh, and the patched answers
    equal the rebound product within 1e-4 of float64 numpy."""
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.core.sparse import BlockSparseMatrix as JBS
    from matrel_tpu.session import MatrelSession as JSession
    want = _delta_scenario(JSession, JConfig, JBS, _jax_mesh(world))
    for r in worlds[world]:
        got = r["delta"]
        a, s, b = got["rebound"]
        assert got["counters"] == want["counters"]
        assert got["counters"]["patched"] == 2
        for name, full in (("A", a @ b), ("S", s @ b)):
            assert got[f"{name}_summary"] == want[f"{name}_summary"]
            np.testing.assert_allclose(got[f"{name}_after"], full,
                                       rtol=1e-4, atol=1e-4)
            np.testing.assert_allclose(got[f"{name}_after"],
                                       want[f"{name}_after"], rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("world", WORLDS)
def test_spill_tiers_on_ranks(worlds, world, tmp_path):
    """The spill tiers on the ranks: each rank demotes, ages to disk and
    promotes its own block under artifact names that carry its rank and
    the grid; the tier counters, the snapshot's and the restore's are
    the JAX package's on its mesh; a restore on the same grid thaws
    every rank's block back bit for bit; a restore on one device refuses
    with ``SnapshotGridMismatch``. The fleet builds on a rank mesh, its
    two slices each a group of ranks."""
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.session import MatrelSession as JSession
    want = _spill_scenario(JSession, JConfig, _jax_mesh(world),
                           str(tmp_path))
    gx, gy = WORLDS[world]
    for r in worlds[world]:
        got = r["spill"]
        for key in ("info1", "info_disk", "saved", "restored", "info2"):
            assert got[key] == want[key], key
        assert got["info2"]["thawed_restored"] == 3
        for g, o in zip(got["ans2"], [got["ans"][i] for i in (0, 1, 3)]):
            np.testing.assert_array_equal(g, o)
        for g, w in zip(got["ans"], want["ans"]):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)
        total, mine = r["spill_files"]
        assert mine >= 1 and total == mine * gx * gy
        assert r["spill_other_grid"] == ([gx, gy], None)
        assert r["fleet_source"] == "virtual"


@pytest.mark.parametrize("world", WORLDS)
def test_fuse_probes_on_ranks(worlds, world, tmp_path, monkeypatch):
    """Autotune over a dense fused region on the ranks: one ``fuse|``
    row, under the JAX package's key for the same region on its mesh,
    the same region stamp on every rank, and the answer within 1e-4 of
    float64 numpy's."""
    from matrel_tpu.config import MatrelConfig as JConfig
    from matrel_tpu.core.blockmatrix import BlockMatrix as JBM
    from matrel_tpu.ir import fusion as j_fusion
    from matrel_tpu.ir.rules import optimize as j_optimize
    from matrel_tpu.parallel import autotune as j_at, planner as j_planner
    mesh = _jax_mesh(world)
    arrs = _lowering_arrays()
    jcfg = JConfig(fusion_enable=True, autotune=True,
                   autotune_table_path=str(tmp_path / "jax.json"))
    x, q, y = (JBM.from_numpy(arrs[k], mesh=mesh) for k in "XQY")
    je = x.multiply(q).elem_multiply(y).multiply_scalar(0.5).add_scalar(1.0)
    jopt = j_planner.annotate_strategies(j_optimize(je, jcfg), mesh, jcfg)
    (jreg,) = j_fusion.segment(jopt, jcfg, mesh=mesh)
    monkeypatch.setattr(j_at, "_FUSION_CACHE", {})
    monkeypatch.setattr(j_at, "measure_fusion_region",
                        lambda *a, **k: {"fused": 1.0, "staged": 2.0})
    j_at.lookup_or_measure_fusion(jreg, jopt, mesh, jcfg)
    (jkey,) = [k for k in j_at.load_table(jcfg.autotune_table_path)
               if k.startswith("fuse|")]
    a = {k: v.astype(np.float64) for k, v in arrs.items()}
    want = (a["X"] @ a["Q"]) * a["Y"] * 0.5 + 1.0
    got = [r["fuse_autotune"] for r in worlds[world]]
    for g in got:
        assert list(g["rows"]) == [jkey]
        assert set(g["rows"][jkey]["times"]) == {"fused", "staged"}
        assert g["regions"] == got[0]["regions"]
        assert g["regions"] == (
            1 if g["rows"][jkey]["best"] != "staged" else 0)
        np.testing.assert_allclose(g["out"], want, rtol=1e-4, atol=1e-4)
