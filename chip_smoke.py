#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (matrel_tpu_torch) on one card.

    python3 chip_smoke.py

1. Builds every CUDA kernel of the port's main paths from the sources in
   this checkout (one nvcc per source, all started together; sm_90a),
   prints nvcc's register report, and checks the build: no f32 SpGEMM
   instance spills (ptxas), B2/B3's library holds no shared-memory
   atomic, and every instance of the bf16 wgmma body
   (csrc/bf16_tile_wgmma.cuh: B1's and B4-B7's) holds HGMMA and UTMALDG
   and no HMMA in its SASS (cuobjdump -sass), spills nothing and has no
   wgmma that ptxas serialised; no instance of the f32 tile body
   (csrc/f32_tile_simt.cuh: B4-B7's 12, B1's 4) or of B1's narrow row
   walk (10) spills, and the narrow walk holds no atomic.
2. Kernel phases: holds each kernel against its plain PyTorch version on
   the card — block-sparse SpMM B1 (ops/pallas_spmm.py) in f32 and bf16
   at bs 4, 8, 16, 24, 64, 128 and 512, with empty block rows, a single
   block row, D shorter than the tile grid, output rows past it, a D off
   a 16-byte boundary and a column count that is not a multiple of the
   column tile, each case through the tile body ops/tile_body.py
   assigns it (bf16: wgmma at bs 64, 128 and 512; f32: the narrow row
   walk up to F32_NARROW_MAX = W columns, else the SIMT tile body of
   csrc/f32_tile_simt.cuh), plus f32 at pm = 1, 2, 3, W and W + 1 on bs
   4, 10, 24 and 512 (the narrow body held bit-equal to its plain
   version); the
   compact SpMV B2 and SpMM B3 (ops/pallas_spmv.py), both over the plan's
   CSR view, at passes 2 and 3 with a block of zero slots, n_rows not a
   multiple of 512, an overflow hub row, sentinel slots, a hub row of
   some 2,000 slots in the tables, B2 at every sub-warp width (1 to 32
   lanes a row), and B3 at k = 2, 5, 12, 16, 33 and 128 and at k = 16
   with X off a 16-byte boundary — and times
   each at its BASELINE shape with CUDA events beside the plain version,
   its bound and one PyTorch library call.
   The S×S tile kernels B4–B7 (ops/pallas_spgemm.py) are held against
   their plain versions every kernel id on every case, in f32 and bf16
   at bs 8, 10, 16, 24, 64, 128, 130, 192 and 512 (an empty
   intersection, single-pair and >= 64-pair hub slots, ragged edges,
   both f32 sub-tiles and both load paths, unsorted B tiles, runs that
   are not a multiple of G, both powerlaw buckets, a chunked band, a
   band with an empty block row, the bs-512 band's grouped fallback),
   every launch through the tile body ops/tile_body.py assigns it (bf16
   at bs 64, 128 and 512: the wgmma body, over slots of several pairs,
   grouped padding positions and band zero tiles), and timed at
   n = 100,352 on the repo's own S×S deployments (bench.py
   measure_spgemm / measure_sparse_kernels) beside the plain version,
   the bound and the xla_gather torch composite. At row 4 and at the
   bf16 S×S pair the wgmma body is timed against the WMMA body in turns
   (the C entry points called with each body's code; not counted as
   launches), with cuBLAS torch.bmm over the same pre-gathered tiles as
   a diagnostic of the card's bf16 rate. The routed SpMV B8
   (ops/spmv_routed.py) is held against its plain version and the plain
   walk of the plan's CSR view at passes 1, 2 and 3, at every sub-warp
   width (1 to 32 lanes a row), on the JAX tests' shapes (3 x 3 groups,
   5,000 x 33,000, an empty destination and source group, a hot cell in
   the overflow COO) and a hub row of some 2,000 slots over every source
   group, and each whole product against float64. B2, B3 and B8 walk
   each plan's CSR view (ops/csr_view.py, built on the card once per
   plan); the bounds of B2, B3 and B8 are the CSR minimum.
3. Path phases, through the entry points a user calls on the default
   device, with every kernel's launch count set to 0 just before each
   and read just after: BASELINE row 5 (PageRank, 30 rounds over
   1,000,000 nodes and 10,000,000 edges, impl="onehot", against a
   float64 scipy power iteration; then A·x, x'·A and A·X with X 1M x 16
   on the same graph as a COOMatrix through MatrelSession().compute),
   four S×S queries A·B at n = 32,768 (1% random bf16 512-blocks, and
   clustered, powerlaw and band structures in f32: B4, B5, B7 and B6 as
   stamped, the bf16 B4 launch through the wgmma body, against a
   use_pallas=False session and float64 tiles),
   routed_spmv on the row-5 graph at passes 2 and 3 (against the plain
   version, the compact B2 route and float64 scipy), CG over the routed
   Gram operator v -> A'(A v) + 0.1 v to 1e-5 (float64 residual; the same
   solve over B2), row 3 (normal-equations linreg, 10,000,000 x 1000 from
   bench_all.py's hash panels through fit_streaming at "high" and
   "highest", against a float64 solve; then fit via compile_exprs,
   fit_streaming and cg_least_squares on the first 1,000,000 rows held
   whole),
   row 4 (block-sparse x dense, 100,352^2 at 1% of 512-blocks, bf16,
   plus the D'·S form; both launches through the wgmma body; before it,
   the same shape in f32 through the wide f32 body against its plain
   version, its bound and torch.sparse.mm on the f32 CSR form), row 2
   (skewed A·B·C, 10,000 x 100, f32, plan (A·(B·C))) and row 1 (4096^2
   f32 multiply). Results are checked against the plain kernel versions
   or a float64 oracle.
4. After the run's peak device memory is read and held to its bound:
   MatrelSession.run_many over one batch of row 4's S·D, row 5's A·x on
   the cached COO A, row 2's chain and a duplicate (one MultiPlan, a
   cache hit on the reordered batch, each result bit-equal to its own
   compute(), B1 and B2 launched from inside the batch), one vec and one
   rank1 query against numpy, session.zeros and eye at 16,384 (eye·A
   bit-equal to A), row 4's S rebuilt by BlockMatrix.from_block_fn (its
   tile occupancy) and by BlockSparseMatrix.from_scipy (its entries),
   each holding its tiles, and rows 1 and 2 planned on the virtual
   (2, 4) grid under reshard_peak_budget_bytes > 0 (strategies, staged
   moves and root re-lays printed, results bit-equal to budget 0); then
   the north-star 65k chain
   (workloads/big_chain.py): both schedules at n = 8192 against a
   float64 oracle, streaming_chain_slab at bench_all.py's sizes (n =
   65,536, tile 8192, panel 16,384, bf16 cheap_gen seeds 1, 2, 3, "fro";
   one warm and two timed runs, seconds and TFLOP/s against 4n³, the
   generation / GEMM split from torch.profiler) held against the
   tile-assembly schedule, under the phase's own peak-memory bound.
5. path_relational: the relational σ/γ/⋈ surface and SQL, each
   sub-phase through a fresh MatrelSession with its time, its error
   against float64 and its own peak memory under REL_PEAK_LIMIT_GIB —
   every pred (eq, lt, ge) × merge (mul, add, right) × kind × axis
   (row, col, all) of agg(join_on_values(A, B)) over 8192² ⋈ 8192² f32
   (2^52 logical pairs, never materialised), sampled rows and columns
   against a float64 enumeration over the whole other side and "all"
   against a float64 grid of distinct values, each within a derived
   bound (vj_tol); a callable join at join_bruteforce_max_pairs; σ on
   values, rows and blocks and join_on_index(A, B)·W over 16,384² f32,
   join_on_rows at the 2^26-entry cap · V with its stamped scheme, the
   products within product_tol, which the same queries with TF32 and
   with bf16 products must miss; SQL
   trace(A * A * A) over bench_all.py's 8192² adjacency, exact against
   scipy.sparse, with explain_sql and a plan-cache hit on repeated
   text, a select/rowsum and a joinvalue query; triangles over a
   block-sparse adjacency of block-diagonal communities (n = 32,768, bs
   512; the S×S kernel the stamp picks, launches counted, exact against
   scipy, and that kernel held against its plain version on the same
   S·S); cosine similarity of 16,384 × 1024 at "high" and "highest"
   and σ(v > 0.9) on it; σ(v > median), matvec (B2 counted), row_count,
   row_max and an eq join on row 5's 10M-edge COOMatrix; a 1 GiB
   save_tiled / load_tiled, bit for bit.
6. path_coo_plane: row 5's plan built by the native counting-sort fill
   (native/spmv_plan.cc, asserted loaded and used) and by the numpy
   fill, host seconds each, B2 on both held to each other (rows with no
   overflow edge bit-equal); save_plan / load_plan of it (bytes,
   seconds; B2 on the loaded plan bit-equal); compact_apply_chunked(4)
   bit-equal to compact_apply, both timed; B2 on the native, loaded and
   chunked plans against its plain version; dense pagerank over a
   16,384² f32 adjacency with dangling rows (ms a round against one
   1 GiB read, float64 on the card); pagerank_csr on a near-regular 1M
   graph (the table path: no B2 launch) and on row 5's (the fallback:
   30 B2 launches), against float64; pagerank_block_sparse over 588 f32
   tiles of a community adjacency with dangling and light rows (31 B1
   launches, all through the narrow f32 body, one column), against
   float64, then B1 at that shape bit-equal to its plain version, under
   twice its byte bound, beside torch.sparse.mm on Sᵀ in CSR and in BSR
   over the same tiles, and the two f32 bodies timed in turns at pm =
   1, 2, 4, 8, 16 and 32 (the crossover that sets W).
7. path_autotune, its table in a temporary file under build/: the
   SpGEMM family for every structure class at sides 8192 and 32,768
   (bs 512; the band also at bs 128), every admissible kernel timed;
   the same winners replayed from the table with no measurement; the
   four S×S compute queries at n = 32,768 with autotune on (stamped
   "measured" exactly where the table has a winner, results bit-equal
   to the default session's where the kernel is the same); the SpMV
   family on a 1M-node, 3M-edge graph (both variants timed, the winner
   persisted, the result equal to the default's) and on row 5's plan
   (over the expanded budget: no winner, no row); no matmul strategy
   measured on the 1 x 1 card. Each of the two paths holds its own
   peak-memory bound (NEW_PEAK_LIMIT_GIB).
8. path_fusion (whole-plan fusion, under its own bound
   FUSION_PEAK_LIMIT_GIB): (a) bench.py's two fusion chains at full
   width — the PageRank step over a 16,384² f32 A and the linreg
   epilogue over X of 1,000,000 x 1000 f32 — through
   compile_staged_units (fusion off) and compile_region_units (fusion
   on): dispatch counts, outputs bit-equal and within 8·u·√K of
   float64, warm ms of both (CUDA events, in turns); (e) the
   autotune fuse| family on both chains (ms per variant and the winner;
   a "staged" winner leaves no stamp), run here and not in
   path_autotune so that path's bound stays; (b) the PageRank step with
   row 5's COOMatrix as Âᵀ through compute(), fusion on and off (the
   region anchored on A·(w∘r) with the w∘r prologue, B2 launched inside
   it, results bit-equal, within 1e-5 of float64 scipy); (c) the four
   S×S queries of path_spgemm at n = 32,768 under ((A·B)·0.5)^2 (the
   epilogue tile-wise over B5–B7's tile stacks, over the dense output
   for B4's generic class, the kernel launched inside the region,
   results bit-equal to fusion off); (d) row 4's S·D·0.5 through B1's
   wgmma body, its epilogue in spmm.apply's slot, bit-equal to fusion
   off. Warm compute() latency of both forms of (b)-(d), in turns
   (fused, unfused, unfused, fused; CUDA events, medians of 10).

9. path_serving (the serving plane: serve/, ir/delta.py; each
   sub-phase under its own bound SERVE_PEAK_LIMIT_GIB): (a) four client
   threads of two tenants (stride weights a:3, b:1) submit 48 queries
   — row 4's S·D (B1), row 5's A·x (B2), row 2's chain, row 1 — to
   session.submit (batches of 6, 2 in flight, an 8 GiB result cache):
   every answer bit-equal to compute() on a cache-off session, 44 cache
   hits for 4 distinct queries, B1 and B2 launched only for the first
   computations, per-tenant counts and submit-to-result p50 / p99 (host
   clock, synchronised), a 0.001 ms deadline failing typed; (b) the mix
   under a 160 MiB budget, the cache's entries after every answer those
   of a byte-budgeted LRU model; (c) six consumers of row 4's S·D in one
   run_many batch with cse_enable: B1 once, all six answers bit-equal
   to the un-hoisted batch, warm ms of both in turns;
   (d) the streaming dashboard (workloads/streaming.py) at n = 16,384,
   batch 64, window 8, k = 32 through register_delta and through plain
   register rebinds, in turns, one warm tick and 6 timed: integer
   queries bit-equal between the modes and to float64 on the card
   every tick, feature_product within its f32 bound, median ms a tick,
   patched / killed / reused-plan counts, and the dashboard's PageRank
   warm-restarted over each session's binding on the card, equal
   between the modes and within alpha^k·|r0 - r*|_1 of the float64
   fixed point every tick; (e) S·S at n = 32,768 (1%
   0/1 512-blocks, B4) patched for a 64-entry COO delta through the
   SpGEMM form (B4 launches counted; force mode: the estimate prices
   the patch out), within 1e-4 of a recompute, ms of both.
10. path_ops (the observability plane and the resilience ladder:
   obs/, resilience/, parallel/coeffs.py; each sub-phase under its own
   bound OPS_PEAK_LIMIT_GIB) over row 4's S·D (B1), row 5's Âᵀ·x through
   compute (B2) and S×S 1% random bf16 at n = 32,768 (B4): (a) obs on
   (event log, flight recorder, provenance, lockdep): every answer
   bit-equal to obs off, one query event a run, the span tree, why
   naming each plan, the registry's count, the log read back; with (h)
   one scrape of /metrics and /json on the loopback endpoint and no
   exporter thread after serve_close; (b) EXPLAIN ANALYZE of each: the
   kernel's launch counter moved over the profiled calls, its
   torch.profiler ms (a trace that saw it: up to OPS_PROFILE_TRIES
   traces, each retry logged) against its PERF.md kernel ms (within
   OPS_ANALYZE_FACTOR), every traced launch under a matrel.* range, the
   B1 / B2 / B4 node's synced ms between that kernel's and PERF.md's device
   time of the query plus OPS_NODE_HOST_MS, the plan-as-run line beside
   it; (c) warm
   ms obs off against obs on, in turns, off against path_latency's; (d)
   transient faults at execute 1, 2, 3 times on row 4's S·D: rungs 1-3
   climbed, stamped and evented, B1 launched only at rungs <= 2, answers
   within bf16 tolerance of rung 0's; (e) a fatal fault trips the
   breaker, CircuitOpen, the half-open probe closes it and runs B1; (f)
   a submit burst of two tenants under tight brownout watermarks: rungs
   up to 3 and back to 0, tenant b shed at rung 3, rung-2 answers
   served stale and stamped, overload events matching the rungs; (g)
   analyzed runs under every strategy on the (2, 4) virtual grid fill a
   drift table under backend "cuda"; coeff_planner_enable takes its
   epoch into the plan key, the stamps that change on row 2's chain and
   a 4096² product printed, the answers equal.
11. path_durable (the durable half of serving and the static plan
   verifier: serve/spill.py, utils/checkpoint.py, utils/resilience.py,
   serve/replan.py, analysis/; state in a directory under the
   gitignored build/chip_smoke/, removed at the end; each sub-phase
   under its own bound DURABLE_PEAK_LIMIT_GIB): (a) row 4's S·D (B1,
   bf16, 98 MiB) and two more S·D results through a result cache whose
   device budget holds one and a host tier that holds one: S·D ages to
   disk, answers its next consult bit-equal with no B1 launch, its entry
   stamped with its tier and priced legs; the measured d2h, disk-write,
   disk-read and h2d ms printed beside coeffs.spill_cost_ms's price, and
   the host copy pinned against pageable; a rebind of D kills the host
   and disk entries and unlinks the artifact; (b) save_state and restore
   in a fresh session: the first consult answers from the snapshot,
   bit-equal, no B1 launch; a flipped bit in the artifact is a miss (B1
   once, the right answer); a truncated snapshot cold-starts with a
   warning; (c) save_catalog / load_catalog of row 4's S and D, S·D
   recomputed bit-equal; run_resilient over block-sparse PageRank (B1's
   f32 narrow walk) with a checkpoint every 5 rounds and a transient
   fault at the checkpoint site, bit-equal to the clean run; (d)
   verify_plans="error" over B1, B2 and B4: no error diagnostic, one
   launch each, the Verifier section, the plan.verify span, the verify
   host ms a plan, warm queries against path_latency's; session.verify
   of a hand-tampered spill stamp fires MV117; (e) re-planning on the
   (2, 4) virtual grid: the controller checks, re-calibrates and
   re-warms, every answer bit-equal, only strategy / cost stamps
   changed.
12. path_fleet (the multi-slice serving fleet and the operator tools:
   serve/fleet.py, core/mesh slice views, obs/history.py, obs/top.py,
   the trace / why CLIs, bridge.py, __main__.py; each sub-phase under
   its own bound FLEET_PEAK_LIMIT_GIB): a fleet_slices=2 session on the
   1 x 1 grid ("shared" slices: two slice sessions on the card, the
   catalog shared), obs and provenance on, the mix's tables named in
   its catalog: (a) four client threads of two tenants submit row 4's
   S·D (B1), row 5's Âᵀ·x (B2), the 1% random bf16 S×S at 32,768 (B4)
   and row 2's chain, each placed on a slice, every answer bit-equal to
   one plain session; the warm latency of a slice-placed S·D beside one
   session's submit; (b) the repeats answer through the directory with
   0 launches; (c) S·D replicates into the other slice after 2 remote
   hits (fleet_replicate_hits): the copy's ms and the reshard plan's
   price, the replica bit-equal; (d) queued entries on slice 0 re-admit
   on slice 1 after kill_slice(0), bit-equal, an expired one fails
   DeadlineExceeded, and with no live slice a submit fails
   FleetSliceLost; (e) a rebind of D drops the directory's records and
   the cached S·D, the next answer right; (f) the (2, 4) virtual grid
   under verify_plans="error": two (2, 2) slices, the sparse tables
   pinned to the span, 0 diagnostics; (g) history --summary (its fleet
   roll-up), trace --export chrome, why and top --once --log over the
   run's own event log, the bridge on localhost, and the CLI's pagerank
   over row 5's edges (B2), the same top ten as path_row5_pagerank.
13. path_soak (the port's randomized oracle soak,
   matrel_tpu_torch/tools/soak.py, at --base 10000 with SOAK_TRIALS a
   battery, under its own bound SOAK_PEAK_LIMIT_GIB): the kernel
   batteries first — spmv (B2 over uniform, hub, banded and
   single-column graphs), routed (B8), sparse_kernels (B4-B7, every
   kernel id forced, the executor path with a poisoned to_dense), fuzz
   and deep (random expression trees: B1's f32 bodies through
   block-sparse leaves, B2 / B3 through COO leaves), precision (the SLA
   tiers; block-sparse bf16 S·D through B1's wgmma and WMMA bodies),
   fusion — then the serving batteries and sharded (four gloo ranks
   sharing the card); one line a battery (trials, failures, wall s,
   launches a kernel), zero failures, and every kernel but B3 launched
   during the phase (B1's wgmma, WMMA and f32 bodies apart); then the
   chaos drill (tools/chaos_drill.py) on the card, its JSON line
   printed and held to ok.
14. path_tools (the operator drills and the open-loop traffic harness,
   matrel_tpu_torch/tools/, each through its main on the card, under its
   own bound TOOLS_PEAK_LIMIT_GIB; artifacts under build/chip_smoke/tools/,
   removed at the end): plan_snapshot (the ten-case corpus planned on the
   virtual (2, 4) grid, every signature equal to
   tests/plan_snapshots.json), plan_verify (0 diagnostics), topology_flip
   (rmm flips to bmm_right under the (1, 8) axis weights, MV106, the
   weighted multiply against numpy), flight_drill (run_many, submit, a
   compile failure dumped by the flight recorder, the chrome export, the
   drift table), provenance_drill (every provenance path, the audit
   replay, MV115), traffic in its three modes (the overload run against
   the closed-loop capacity C measured on the card, --slo with the
   loopback metrics endpoint polled, --slices with a mid-stream
   kill_slice), multihost_check over two gloo ranks sharing the card, and
   the port's matlint over matrel_tpu_torch/ and this script (static,
   0 findings); each record printed, each held to ok / exit code 0;
   launches a kernel counted over the phase (launches_in_tools in the
   kernels line).
14b. path_examples (the eight worked examples, matrel_tpu_torch/examples/,
   each through its run on the card at the JAX demos' sizes, its lines
   and wall seconds printed, each under its bound in
   EXAMPLES_PEAK_LIMIT_GIB): graph_demo (degrees, two-hop mass, PageRank
   over 50,000 nodes / 400,000 edges against a float64 power iteration,
   B2 a round), linreg_demo (fit's relative error), chain_optimizer_demo
   (the planned FLOP ratio 64, both plans' checksums), relational_sql_demo
   (counts against numpy, SQL agrees, 419 nonzeros), analytics_demo
   (triangles and cosine pairs equal their oracles), the layout demo's
   stamps, autotune_demo (no measurement in the second session) and
   distributed_sparse_demo on four gloo ranks sharing the card (every
   error within the demo's bounds, B1 and B2 on every rank, the largest
   rank's peak under EXAMPLE_RANK_PEAK_LIMIT_GIB; the ranks' launches
   join the kernels line as launches_on_example_ranks). B1 and
   B2 launches are asserted where the examples reach them.
14c. path_overlap (tools/pagerank_overlap.py at the JAX tool's sizes: 1M
   nodes, 10M edges; compact_apply against compact_apply_chunked at
   k = 2, 4, 8, each bit-equal and k B2 launches a matvec, the marginal
   ms by CUDA events around replays of CUDA graphs of the chained
   products, so the host's dispatch is left out; the 10% stop rule's
   verdict), its JSON record
   printed, under OVERLAP_PEAK_LIMIT_GIB.
15. spgemm_library: torch.sparse.mm of each S×S pair's element-CSR
   forms in f32 (cuSPARSE SpGEMM) at n = 100,352, by CUDA events, as the
   library column of B4–B7 (xla_gather kept beside it); where cuSPARSE
   cannot hold its workspace, the failure and the operand sizes. Then
   path_multirank, last: four ranks spawned on a 2 x 2 grid (NCCL with a
   card a rank where there are four cards, else gloo with all four on
   this card; the backend, each rank's device and the collectives staged
   through host memory are printed), each running through
   MatrelSession(mesh=<rank mesh>): row 1 under each strategy forced in
   turn (the collective tally, ms a product by CUDA events between
   barriers, the error against the one-rank product within
   8·u·√K·‖X_i‖·‖Y_:j‖, bit-equality; BMM also under a 64 MiB reshard
   budget, its staged moves bit-equal to budget 0), row 2 under the
   planner's stamps (equal to the one-card planner's on a virtual
   (2, 2) grid) and under the budget, measure_reshard_variant staged
   against naive, row 5's A·x (bit-equal to one card) and A·X (k = 16)
   through COOMatrix.shard and compute (B2 / B3 on each rank's slice) and
   the 30-round sharded PageRank (ms a round, against float64 scipy),
   spgemm_sharded at n = 32,768, spmm_sharded at row 4's shape,
   streaming_chain_sharded at n = 65,536 (one panel a rank, within
   (p - 1)·u of the one-card slab) and autotune_matmul at 4096 (one
   winner on every rank), the sharded tail (its (e) the autotune fuse|
   probes of a fused region over each rank's Shards, one winner on
   every rank), then serving on the ranks
   (mr_serving: submit on the decision log, the reproducer's three
   queries at row 4's width in an even round and a round with rank 1
   staggered, each rank's blocks held to one card's answers, and a
   cycle's three control exchanges timed with the ranks lined up) and
   the fleet on 2 slices of 2 ranks (mr_fleet: S·D placed on a slice
   and run through the slice's pipeline, B1 on its ranks only and held
   to B1's plain version; row 2's chain on the span; a directory hit
   with no launch; kill_slice and S·D on the survivor; row 5's A·x
   placed on a slice, B2 on its ranks only; fleet_info equal on every
   rank; the router's record of one item timed lined up),
   then the slices serving at the same time (mr_fleet_concurrent, a
   fresh fleet: (g) two S·D submitted together, one a slice, against
   each alone, B1 on every rank; (h) S·D six times at once and
   kill_slice, the entries waiting in the dead slice's queue re-admitted
   on the survivor, requeued equal on every rank, every answer held to
   B1's plain version), each rank under its own
   peak bounds (MR_PEAK_LIMIT_GIB). The ranks' B1 / B2 / B3 launches
   join the kernels line (launches_on_ranks). The kernel phase also holds B2 / B3 on the
   sentinel-padded slices of four ranks (spmv_slice_phase).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line,
and last ``{"ok": true, "device": {...}}``. Exits non-zero, printing no
result, when there is no CUDA device or a phase fails.

    python3 chip_smoke.py --b1-f32

runs only B1's f32 crossover sweep and its wide body at row 4's shape,
and prints digests of B4–B7's f32 outputs: run from two checkouts in one
call, it compares two builds of the f32 bodies on one card.

    python3 chip_smoke.py --serving

runs only path_serving (after the build).

    python3 chip_smoke.py --ops

runs only path_ops (after the build).

    python3 chip_smoke.py --durable

runs only path_durable (after the build).

    python3 chip_smoke.py --fleet

runs only path_fleet (after the build).

    python3 chip_smoke.py --soak

runs only path_soak (after the build).

    python3 chip_smoke.py --tools

runs only path_tools (after the build).

    python3 chip_smoke.py --examples

runs only path_examples and path_overlap (after the build).

    python3 chip_smoke.py --multirank

runs only path_multirank (after the build and the one-card 65k slab it
is held against): on a host with four cards its ranks take NCCL, a card
a rank.
"""

from __future__ import annotations

import contextlib
import importlib
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

# Peak device memory of the whole run: the S×S phases set it, with the
# row-5 plans' CSR views still held (PERF.md section 5 gives the
# reckoning, ~12.0 GiB), plus about 25%.
PEAK_LIMIT_BYTES = 15 * 2**30


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
    """B1 against its plain version in f32 and bf16; every launch through
    the tile body the case names (bf16; f32 by width: the wide SIMT body
    here, the narrow row walk in f32_cases())."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm, tile_body
    cases = [  # (bs, n, k, pm, density, output rows, bf16 body, D offset)
        (4, 37, 29, 9, 0.4, 37, "wmma", 0),
        (8, 203, 150, 77, 0.3, 203, "wmma", 0),
        (16, 400, 320, 130, 0.2, 437, "wmma", 0),  # rows past the grid
        (24, 100, 96, 33, 0.5, 100, "wmma", 0),
        (64, 1000, 700, 200, 0.1, 1000, "wgmma", 0),  # D shorter than grid
        (64, 50, 1000, 64, 0.5, 50, "wgmma", 0),    # a single block row
        (64, 1000, 700, 200, 0.1, 1000, "wmma", 1),  # D off 16 bytes
        (128, 1000, 900, 136, 0.2, 1000, "wgmma", 0),  # D shorter than grid
        (512, 4096, 4096, 520, 0.1, 4096, "wgmma", 0),  # pm % 256 != 0
        (512, 2048, 1800, 256, 0.3, 2600, "wgmma", 0),  # both: rows, D
    ]
    for dtype_name in ("float32", "bfloat16"):
        for i, (bs, n, k, pm, dens, rows, body, off) in enumerate(cases):
            want_body = (body if dtype_name == "bfloat16"
                         else tile_body.f32_body(pm))
            b1_case(mesh, dtype_name, 100 + i, bs, n, k, pm, dens, rows,
                    want_body, off)
    for i, (bs, n, k, pm, dens, rows, off) in enumerate(f32_cases()):
        b1_case(mesh, "float32", 150 + i, bs, n, k, pm, dens, rows,
                tile_body.f32_body(pm), off)


def f32_cases():
    """B1's f32 cases at the widths around the narrow body's limit W =
    tile_body.F32_NARROW_MAX: (bs, n, k, pm, density, output rows, D
    offset in floats). make_case leaves ~1/4 of the block rows empty."""
    from matrel_tpu_torch.ops.tile_body import F32_NARROW_MAX as W
    return [
        (4, 37, 29, 1, 0.4, 45, 0),        # rows past the grid
        (24, 100, 90, 2, 0.5, 100, 1),     # D shorter than grid, 4 B off
        (10, 95, 83, 3, 0.4, 95, 0),       # bs % 4 != 0: scalar loads
        (512, 2048, 1800, 1, 0.3, 2600, 1),  # PageRank's bs; rows, D, off
        (24, 300, 280, W, 0.3, 330, 1),
        (512, 2048, 1800, W, 0.3, 2048, 0),
        (24, 300, 280, W + 1, 0.3, 330, 1),
        (512, 2048, 1800, W + 1, 0.3, 2600, 0),
    ]



def b1_case(mesh, dtype_name, seed, bs, n, k, pm, dens, rows, want_body,
            off):
    """One B1 launch through the wrapper, its body asserted, against the
    plain version: bit-equal on the narrow body (both sum in f64 and
    round once), within TOL elsewhere."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    dtype = getattr(torch, dtype_name)
    S = make_case(bs, n, k, dens, dtype, seed, mesh)
    gen = torch.Generator(device=mesh.device).manual_seed(seed + 100)
    d = torch.randn((k * pm + off,), generator=gen,
                    device=mesh.device).to(dtype)[off:].view(k, pm)
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
    before = dict(pallas_spmm.BODY_LAUNCHES)
    got = pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d, rows)
    launched = {b: v - before[b] for b, v in
                pallas_spmm.BODY_LAUNCHES.items() if v != before[b]}
    if launched != {want_body: 1}:
        raise AssertionError(f"spmm {dtype_name} bs={bs} pm={pm} "
                             f"offset={off}: bodies {launched}, want "
                             f"{want_body}")
    want = pallas_spmm.spmm_blocksparse_plain(
        S.blocks, S.block_rows, S.block_cols, d, rows)
    torch.cuda.synchronize()
    name = f"spmm {dtype_name} bs={bs} n={n} k={k} pm={pm} rows={rows}"
    err = check_close(name, got, want, dtype_name)
    if want_body == "f32_narrow" and not torch.equal(got, want):
        raise AssertionError(f"{name}: the narrow body is not bit-equal to "
                             f"its plain version (max abs err {err:.3e})")
    log(f"kernel spmm_blocksparse {dtype_name} bs={bs} n={n} k={k} "
        f"pm={pm} rows={rows} nnzb={S.nnzb} D offset {off} "
        f"({want_body} body): max_abs_err={err:.3e} ok")


def row4_inputs(sess):
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    n, bs, pm = 100_352, 512, 512
    S = BlockSparseMatrix.random((n, n), 0.01, block_size=bs,
                                 mesh=sess.mesh, seed=1, dtype="bfloat16")
    D = sess.random((n, pm), dtype="bfloat16", seed=2)
    return S, D


def b1_launcher(payload, row_ptr, bcols, d, out):
    """``launch(code)``: B1's C entry point on these operands with a
    body's code, past the wrapper, so these launches count nowhere;
    returns the entry point's code when ``check`` is False, else raises
    on any but 0."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    lib = pallas_spmm._library()
    bs, pm = payload.shape[1], d.shape[1]
    vec = 16 // payload.element_size()
    a_vec = int(bs % vec == 0 and payload.data_ptr() % 16 == 0)
    d_vec = int(pm % vec == 0 and d.data_ptr() % 16 == 0)

    def launch(code, check=True):
        rc = lib.matrel_spmm_blocksparse(
            payload.data_ptr(), row_ptr.data_ptr(), bcols.data_ptr(),
            d.data_ptr(), out.data_ptr(), code, row_ptr.numel() - 1, bs,
            payload.shape[0], d.shape[0], pm, out.shape[0], a_vec, d_vec,
            d.device.index, torch.cuda.current_stream().cuda_stream)
        if check and rc != 0:
            raise AssertionError(f"B1 body code {code} (bs={bs}, pm={pm}): "
                                 f"error {rc}")
        return rc

    return launch


def body_turns(name: str, launch, flops: float) -> dict:
    """The WMMA body against the wgmma body on the same inputs, in turns
    (wmma, wgmma, wgmma, wmma): ``launch(code)`` calls the C entry point
    with a body's code directly, so these launches count nowhere."""
    from matrel_tpu_torch.ops.tile_body import CODES
    turns = [(b, time_ms(lambda b=b: launch(CODES[b]), batch=10))
             for b in ("wmma", "wgmma", "wgmma", "wmma")]
    log(f"{name} bodies in turns: " + ", ".join(
        f"{b} {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)"
        for b, ms in turns))
    return {b: [ms for bb, ms in turns if bb == b] for b in ("wmma",
                                                             "wgmma")}


def bmm_yardstick(name: str, a, b) -> float:
    """Diagnostic: cuBLAS ``torch.bmm`` in bf16 over pre-gathered tile
    pairs (the gather not timed) — the card's rate on this arithmetic.
    The port never calls it."""
    import torch
    ms = time_ms(lambda: torch.bmm(a, b), warmup=2, runs=10)
    flops = 2.0 * a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    log(f"{name} diagnostic: cuBLAS torch.bmm bf16 over {a.shape[0]} "
        f"pre-gathered pairs {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s)")
    return ms


def row4_timing(S, D, library):
    """Kernel vs plain at the row-4 shape (bf16), beside the bound and
    the library yardstick measured by :func:`library_yardstick`; the
    WMMA body against the wgmma body in turns, and the bmm diagnostic."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    n = S.shape[0]
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
    d = D.data
    before = pallas_spmm.BODY_LAUNCHES["wgmma"]
    got = pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d, n)
    if pallas_spmm.BODY_LAUNCHES["wgmma"] != before + 1:
        raise AssertionError("row-4 shape: not the wgmma body")
    want = pallas_spmm.spmm_blocksparse_plain(S.blocks, S.block_rows,
                                              S.block_cols, d, n)
    err = check_close("spmm row-4 shape", got, want, "bfloat16")
    out = torch.empty_like(got)
    launch = b1_launcher(payload, row_ptr, bcols, d, out)
    launch(1)
    torch.cuda.synchronize()
    err_wmma = check_close("spmm row-4 shape, WMMA body", out, want,
                           "bfloat16")
    del got, want
    flops = 2.0 * S.nnzb * S.block_size ** 2 * d.shape[1]
    turns = body_turns("row-4 shape", launch, flops)
    bs = S.block_size
    dblocks = d[:S.grid[1] * bs].view(-1, bs, d.shape[1])
    bmm_yardstick("row-4 shape", payload,
                  dblocks.index_select(0, bcols.long()))
    del out, dblocks
    torch.cuda.empty_cache()
    # 10 calls a sample: the wrapper's ~0.08 ms of host work a call
    # would otherwise sit inside a 0.2 ms kernel's time
    ms = time_ms(lambda: pallas_spmm.spmm_blocksparse(payload, row_ptr,
                                                      bcols, d, n), batch=10)
    plain_ms = time_ms(lambda: pallas_spmm.spmm_blocksparse_plain(
        S.blocks, S.block_rows, S.block_cols, d, n), warmup=1, runs=10)
    bound_ms, bound_by = spmm_bound(S, d.shape[1], n, "bfloat16")
    log(f"row-4 shape (bf16, nnzb={S.nnzb}): kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), library "
        f"{library['library_ms']} ms ({library['note']}); kernel vs plain "
        f"max_abs_err {err:.3e} (WMMA body {err_wmma:.3e})")
    if max(turns["wgmma"]) > min(turns["wmma"]):
        raise AssertionError(f"row-4 shape: the wgmma body is slower than "
                             f"the WMMA body: {turns}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library["library_ms"]}


def row4_f32_inputs(sess):
    """Row 4's shape in f32: the same tile pattern and seeds as
    :func:`row4_inputs` (nnzb 384, bs 512, D 100,352 x 512)."""
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    n, bs, pm = 100_352, 512, 512
    S = BlockSparseMatrix.random((n, n), 0.01, block_size=bs,
                                 mesh=sess.mesh, seed=1, dtype="float32")
    D = sess.random((n, pm), dtype="float32", seed=2)
    return S, D


def row4_f32_timing(sess, with_library: bool = True) -> dict:
    """B1's wide f32 body (csrc/f32_tile_simt.cuh) at row 4's shape in
    f32: one launch through the wrapper (asserted on the "f32" body)
    against the plain version, its time (CUDA events), the plain
    version's, the bound (operations: 1.03e11 FLOP at 67 TFLOP/s) and
    torch.sparse.mm on the f32 CSR form of S, which the body must not
    lose to."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    S, D = row4_f32_inputs(sess)
    n = S.shape[0]
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(S)
    d = D.data
    before = pallas_spmm.BODY_LAUNCHES["f32"]
    got = pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d, n)
    if pallas_spmm.BODY_LAUNCHES["f32"] != before + 1:
        raise AssertionError("row-4 shape in f32: not the wide f32 body")
    want = pallas_spmm.spmm_blocksparse_plain(S.blocks, S.block_rows,
                                              S.block_cols, d, n)
    err = check_close("B1 f32 row-4 shape vs plain", got, want, "float32")
    del want
    run = lambda: pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols, d,
                                               n)
    ms = time_ms(run, warmup=2, runs=10, batch=3)
    plain_ms = time_ms(lambda: pallas_spmm.spmm_blocksparse_plain(
        S.blocks, S.block_rows, S.block_cols, d, n), warmup=1, runs=5)
    bound_ms, bound_by = spmm_bound(S, d.shape[1], n, "float32")
    flops = 2.0 * S.nnzb * S.block_size ** 2 * d.shape[1]
    lib_ms = None
    if with_library:
        csr = csr_form(S)
        lib_ms = library_time("torch.sparse.mm f32 CSR, row-4 shape",
                              lambda: torch.sparse.mm(csr, d), got)
        del csr
    log(f"B1 f32 at row 4's shape (nnzb={S.nnzb}, bs 512, pm 512, "
        f"{flops:.3e} FLOP): wide body {ms:.4f} ms "
        f"({flops / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.4f} ms, bound "
        f"{bound_ms:.4f} ms ({bound_by}), library {lib_ms} ms; max_abs_err "
        f"vs plain {err:.3e}")
    if lib_ms is not None and ms > lib_ms:
        raise AssertionError(f"B1 f32 at row 4's shape: the wide body "
                             f"({ms:.4f} ms) is slower than torch.sparse.mm "
                             f"({lib_ms:.4f} ms)")
    del got, S, D
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms}


#: Widths of the crossover sweep: B1's two f32 bodies on block-sparse
#: PageRank's tiles (the narrow body takes at most NARROW_MAX_C columns)
B1_SWEEP_PM = (1, 2, 4, 8, 16, 32)
NARROW_MAX_C = 16


def b1_crossover(payload, row_ptr, bcols, n, dev) -> list:
    """The narrow body (code 3) against the wide one (code 0) on the same
    tiles at every width of B1_SWEEP_PM, through the C entry point, in
    turns (wide, narrow, narrow, wide; CUDA events, 10 calls a sample).
    Each body is first held to the plain version: the narrow one bit for
    bit where the plain version sums in f64 too. A narrow code refused
    by the library (a build without the narrow body) is recorded as
    None. Returns one row a width."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm, tile_body
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    tile_rows = torch.repeat_interleave(
        torch.arange(counts.numel(), device=dev), counts)
    rows = []
    for pm in B1_SWEEP_PM:
        gen = torch.Generator(device=dev).manual_seed(40 + pm)
        d = torch.rand((n, pm), generator=gen, device=dev)
        want = pallas_spmm.spmm_blocksparse_plain(payload, tile_rows, bcols,
                                                  d, n)
        outs = {b: torch.empty((n, pm), device=dev)
                for b in ("f32", "f32_narrow")}
        launch = {b: b1_launcher(payload, row_ptr, bcols, d, o)
                  for b, o in outs.items()}
        bodies = ["f32"]
        if pm <= NARROW_MAX_C:
            rc = launch["f32_narrow"](tile_body.CODES["f32_narrow"],
                                      check=False)
            if rc == 0:
                bodies.append("f32_narrow")
            elif rc != 1:                  # 1: cudaErrorInvalidValue
                raise AssertionError(f"narrow body at pm={pm}: error {rc}")
        launch["f32"](tile_body.CODES["f32"])
        torch.cuda.synchronize()
        errs = {}
        for b in bodies:
            errs[b] = check_close(f"B1 {b} body, PageRank tiles, pm={pm}",
                                  outs[b], want, "float32")
        if ("f32_narrow" in bodies and tile_body.f32_body(pm) == "f32_narrow"
                and not torch.equal(outs["f32_narrow"], want)):
            raise AssertionError(f"narrow body at pm={pm}: not bit-equal to "
                                 f"the plain version")
        order = ["f32", "f32_narrow", "f32_narrow", "f32"]
        turns = {b: [] for b in bodies}
        for b in order:
            if b in bodies:
                code = tile_body.CODES[b]
                turns[b].append(time_ms(lambda: launch[b](code), warmup=3,
                                        runs=10, batch=10))
        row = {"pm": pm, "wide_ms": min(turns["f32"]),
               "narrow_ms": (min(turns["f32_narrow"])
                             if "f32_narrow" in turns else None),
               "turns": turns, "max_abs_err": errs}
        log(f"B1 f32 crossover, PageRank tiles, pm={pm}: wide "
            f"{row['wide_ms']:.4f} ms, narrow {row['narrow_ms']} ms "
            f"(turns {turns}); max_abs_err vs plain {errs}")
        rows.append(row)
        del d, want, outs, launch
    wins = [r["pm"] for r in rows
            if r["narrow_ms"] is not None and r["narrow_ms"] < r["wide_ms"]]
    log(f"B1 f32 crossover: the narrow body wins at pm {wins}; measured W = "
        f"{max(wins) if wins else None}, the rule's W = "
        f"{tile_body.F32_NARROW_MAX}")
    return rows


def spgemm_f32_digests(mesh) -> dict:
    """sha256 (16 hex digits) of every f32 output of spgemm_cases through
    every kernel id: two builds of the shared f32 body compared run
    against run."""
    import hashlib
    out = {}
    for name, A0, B0, _ in spgemm_cases(mesh):
        A, B = as_dtype(A0, "float32"), as_dtype(B0, "float32")
        for kid in PALLAS_IDS:
            run, a_m, b_m, _ = spgemm_runner(A, B, kid)
            got = run(a_m, b_m).contiguous().cpu().numpy()
            out[f"{name} {kid}"] = hashlib.sha256(got.tobytes()).hexdigest()[
                :16]
    return out


def b1_f32_only() -> int:
    """``python3 chip_smoke.py --b1-f32``: only B1's f32 measurements —
    the crossover sweep on block-sparse PageRank's tiles, the wide body at
    row 4's shape (no library call) — and the digests of B4–B7's f32
    outputs; one JSON line. Run from two checkouts in one call, it
    compares two builds of the f32 bodies on one card."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import pallas_spgemm, pallas_spmm
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE
                      for m in (pallas_spmm, pallas_spgemm)])
    sess = MatrelSession()
    S = community_graph(sess)
    St = S.transpose()
    _, payload, row_ptr, bcols = pallas_spmm.csr_payload(St)
    sweep = b1_crossover(payload, row_ptr, bcols, S.shape[0], sess.device)
    del S, St, payload
    torch.cuda.empty_cache()
    row4 = row4_f32_timing(sess, with_library=False)
    digests = spgemm_f32_digests(sess.mesh)
    print(card)
    print(json.dumps({"checkout": HERE, "sweep": sweep, "row4_f32": row4,
                      "spgemm_f32_sha256": digests}))
    return 0


def multirank_only() -> int:
    """``python3 chip_smoke.py --multirank``: only path_multirank (after
    building the kernels and one-card 65k slab it is held against), so
    that it can run alone on a host with four cards, where its ranks
    take NCCL. Prints the card line and the ranks' B2 / B3 launches."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    from matrel_tpu_torch.workloads import big_chain
    card = device_line()
    log(f"torch {torch.__version__}; {torch.cuda.device_count()} card(s);"
        f" {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    sess = MatrelSession()
    gens = north_star_gens(NS_TILE, sess.device)
    fro = float(big_chain.streaming_chain_slab(NS_N, *gens, tile=NS_TILE,
                                               panel=NS_PANEL))
    del gens
    torch.cuda.empty_cache()
    out = path_multirank(sess, fro)
    print(card)
    print(json.dumps({"multirank_launches": out["launches"]}))
    return 0


def serving_only() -> int:
    """``python3 chip_smoke.py --serving``: only path_serving (after
    building the kernels), printing the card line and its launches."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    log(f"torch {torch.__version__}; {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    out = path_serving(MatrelSession())
    print(card)
    print(json.dumps({"serving_launches": out["launches"]}))
    return 0


def lock_order_checked(name: str, fn):
    """``fn()`` with the lock-order sanitizer armed (utils/lockdep.py:
    every lock built meanwhile is instrumented — the sessions, pipelines,
    admission queues and caches of the phase); fails on a recorded
    inversion or self-deadlock, or a cycle in the order graph."""
    from matrel_tpu_torch.utils import lockdep
    lockdep.reset()
    lockdep.enable()
    try:
        out = fn()
        diags = lockdep.diagnostics()
        edges = sorted(lockdep.order_graph())
        acyclic = lockdep.is_acyclic()
    finally:
        lockdep.disable()
        lockdep.reset()
    bad = [d for d in diags if d["diag"] in ("inversion", "self_deadlock")]
    if bad or not acyclic:
        raise AssertionError(f"{name}: lockdep recorded {bad}, order "
                             f"graph {edges}")
    log(f"{name} under lockdep: {len(edges)} order edges "
        f"{[f'{a} -> {b}' for a, b in edges]}, no inversion; "
        f"{len(diags)} other diagnostic(s) "
        f"{sorted({d['diag'] for d in diags})}")
    return out


def ops_only() -> int:
    """``python3 chip_smoke.py --ops``: only path_ops (after building
    the kernels), printing the card line and its launches; (c) then
    compares obs off with PERF.md's warm latencies only by eye."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    log(f"torch {torch.__version__}; {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    out = path_ops(MatrelSession())
    print(card)
    print(json.dumps({"ops_launches": out["launches"]}))
    return 0


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
    """Row 4 through compute: S·D and D'·S (the transpose branch), both
    through the wgmma body (the caller zeroes the counts)."""
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
    if pallas_spmm.BODY_LAUNCHES["wgmma"] != launches:
        raise AssertionError(f"row 4 path: bodies "
                             f"{pallas_spmm.BODY_LAUNCHES}, want all "
                             f"{launches} launches through wgmma")
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
        f"launches (bodies {pallas_spmm.BODY_LAUNCHES}), max_abs_err "
        f"{e1:.3e} / {e2:.3e}")
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
#: every sub-warp width the row walk of B2 and B8 (csrc/csr_walk.cuh) is
#: built for (lanes_per_row's range)
WALK_LANES = (1, 2, 4, 8, 16, 32)
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


def spmv_case(n_rows, n_cols, m, seed, hub=None, empty_blocks=(),
              hub_share=0.3, capacity_quantile=None):
    """A random edge list and its plan; ``hub`` sends ``hub_share`` of the
    edges to one row (into the overflow, unless ``capacity_quantile`` =
    1.0 sizes the tables for it), ``empty_blocks`` get no edges at all."""
    import numpy as np
    from matrel_tpu_torch.ops import spmv as spmv_lib
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, n_rows, m)
    if hub is not None:
        rows = np.where(rng.random(m) < hub_share, hub, rows)
    if empty_blocks:
        moved = np.isin(rows // spmv_lib.BLOCK, empty_blocks)
        rows = np.where(moved, (rows + spmv_lib.BLOCK) % n_rows, rows)
    cols = rng.integers(0, n_cols, m)
    vals = rng.standard_normal(m).astype(np.float32)
    kw = {} if capacity_quantile is None else dict(
        capacity_quantile=capacity_quantile, max_padding=1000.0)
    plan = spmv_lib.build_spmv_plan(rows, cols, vals, n_rows=n_rows,
                                    n_cols=n_cols, **kw)
    return rows, cols, vals, plan


def spmv_kernel_phase(dev) -> None:
    """B2 and B3 over the plan's CSR view against their plain versions on
    the card: the compact tables' (spmv_scatter_plain,
    spmm_scatter_plain) and the view's plain walk; B2 at every sub-warp
    width in WALK_LANES. Then the whole compact product (overflow
    included) against a float64 oracle."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import csr_view as csr_lib
    from matrel_tpu_torch.ops import pallas_spmv as pc
    cases = [  # (name, n_rows, n_cols, edges, hub, empty blocks)
        ("blocks 1 and 3 with zero slots, n_rows % 512 = 452",
         2500, 1999, 20_000, None, (1, 3)),
        ("overflow hub row", 4096, 512, 20_000, 7, ()),
        ("mostly sentinel slots, n_cols % 8 = 0", 1000, 4096, 3_000,
         None, ()),
        ("one block", 300, 77, 500, None, ()),
        ("hub row 1,234 of some 2,000 slots in the tables", 40_000, 40_000,
         20_000, 1234, ()),
    ]
    for i, (name, n_rows, n_cols, m, hub, empty) in enumerate(cases):
        in_tables = name.startswith("hub row")
        rows, cols, vals, plan = spmv_case(
            n_rows, n_cols, m, 300 + i, hub, empty,
            hub_share=0.1 if in_tables else 0.3,
            capacity_quantile=1.0 if in_tables else None)
        if (hub is not None and not in_tables) != (plan.ov_rows is not None):
            raise AssertionError(f"{name}: overflow {plan.ov_rows is not None}")
        tables = pc.compact_tables(plan, dev)
        view = pc.csr_view_on(plan, dev)
        if in_tables:
            slots = view.row_ptr[hub:hub + 2].tolist()
            if slots[1] - slots[0] <= 1000:
                raise AssertionError(f"B2 {name}: {slots[1] - slots[0]} "
                                     f"slots")
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
            yp = pc.spmv_scatter_plain(*tables, x, n_rows, plan.block,
                                       passes)
            yw = csr_lib.csr_walk_plain(view, x, passes, split_x=False)
            for lanes in WALK_LANES:
                before = pc.LAUNCHES_SPMV
                y = pc.spmv_scatter(view, x, passes, lanes)
                torch.cuda.synchronize()
                if pc.LAUNCHES_SPMV != before + 1:
                    raise AssertionError(f"B2 {name}: "
                                         f"{pc.LAUNCHES_SPMV - before} "
                                         f"launches counted, want 1")
                err = rel_err(f"B2 {name} passes={passes} lanes={lanes}",
                              y, yp, tol)
                rel_err(f"B2 {name} passes={passes} lanes={lanes} vs the "
                        f"view's plain walk", y, yw, tol)
                for b in empty:
                    if y[b * 512:(b + 1) * 512].abs().max() != 0:
                        raise AssertionError(f"B2 {name}: block {b} not "
                                             f"zero")
                log(f"kernel spmv_compact [{name}] nnz={view.nnz} "
                    f"passes={passes} lanes={lanes}: max_abs_err {err:.3e} "
                    f"vs plain ok")
            full = pc.compact_apply(plan, x, passes)
            e_or = rel_err(f"B2+overflow {name} passes={passes} vs float64",
                           full.cpu(), torch.as_tensor(want_x),
                           SPMV_ORACLE_TOL[passes])
            log(f"  compact_apply [{name}] passes={passes}: {e_or:.3e} vs "
                f"float64 oracle ok")
            for k in (2, 5, 12, 16, 33, 128, "16 unaligned"):
                if k == "16 unaligned":     # k % 4 == 0, one column a lane
                    Xk = torch.empty(n_cols * 16 + 1, device=dev)[1:].view(
                        n_cols, 16)
                    Xk.copy_(X[:, :16])
                else:
                    Xk = X[:, :k].contiguous()
                kw = Xk.shape[1]
                before = pc.LAUNCHES_SPMM
                Y = pc.spmm_scatter(view, Xk, passes)
                Yp = pc.spmm_scatter_plain(*tables, Xk, n_rows, plan.block,
                                           passes)
                Yw = csr_lib.csr_walk_plain(view, Xk, passes, split_x=False)
                torch.cuda.synchronize()
                if pc.LAUNCHES_SPMM != before + 1:
                    raise AssertionError(f"B3 {name}: "
                                         f"{pc.LAUNCHES_SPMM - before} "
                                         f"launches counted, want 1")
                err = rel_err(f"B3 {name} k={k} passes={passes}", Y, Yp, tol)
                rel_err(f"B3 {name} k={k} passes={passes} vs the view's "
                        f"plain walk", Y, Yw, tol)
                full = pc.compact_matmat_apply(plan, Xk, passes)
                e_or = rel_err(f"B3+overflow {name} k={k} vs float64",
                               full.cpu(), torch.as_tensor(want[:, :kw]),
                               SPMV_ORACLE_TOL[passes])
                log(f"kernel spmm_compact [{name}] k={k} passes={passes}: "
                    f"max_abs_err {err:.3e} vs plain, {e_or:.3e} vs "
                    f"float64 oracle ok")
    spmv_slice_phase(dev)


def spmv_slice_phase(dev, ranks: int = 4) -> None:
    """B2 and B3 on the sentinel-padded slices a rank mesh of ``ranks``
    ranks gives each rank (spmv.shard_plan, each slice's own CSR view):
    a one-block plan (ranks 1-3 hold no real block row) and a plan of
    exactly one block a rank (a slice's n_rows = rows_per_rank · 512).
    Each launch against its plain version on the slice's tables; the
    slices' rows, concatenated, bit-equal to B2 over the whole plan (B2
    walks a slice with the whole view's sub-warp width)."""
    import types
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.ops import spmv as spmv_lib
    for name, n_rows, m in (("one block", 300, 500),
                            ("one block a rank", ranks * 512, 6000)):
        _, _, _, plan = spmv_case(n_rows, 700, m, 77)
        rng = np.random.default_rng(78)
        x = torch.as_tensor(rng.standard_normal(700).astype(np.float32),
                            device=dev)
        X = torch.as_tensor(rng.standard_normal((700, 16)).astype(
            np.float32), device=dev)
        whole = pc.spmv_scatter(pc.csr_view_on(plan, dev), x)
        ys, nnz = [], []
        for r in range(ranks):
            fake = types.SimpleNamespace(
                size=ranks, ranks=types.SimpleNamespace(rank=r))
            sl = spmv_lib.shard_plan(plan, fake)
            loc = sl.local
            view = pc.csr_view_on(loc, dev)
            tables = pc.compact_tables(loc, dev)
            y = pc.spmv_scatter(view, x, 3, sl.lanes)
            Y = pc.spmm_scatter(view, X, 3)
            rel_err(f"B2 slice [{name}] rank {r}", y,
                    pc.spmv_scatter_plain(*tables, x, loc.n_rows,
                                          loc.block, 3), SPMV_REL_TOL[3])
            rel_err(f"B3 slice [{name}] rank {r}", Y,
                    pc.spmm_scatter_plain(*tables, X, loc.n_rows,
                                          loc.block, 3), SPMV_REL_TOL[3])
            if view.nnz == 0 and (y.abs().max() != 0 or Y.abs().max() != 0):
                raise AssertionError(f"slice [{name}] rank {r}: a slice "
                                     f"with no real slot gave nonzeros")
            ys.append(y)
            nnz.append(view.nnz)
        got = torch.cat(ys)[:n_rows]
        if not torch.equal(got, whole):
            raise AssertionError(f"B2 slices [{name}]: not bit-equal to "
                                 f"the whole plan's B2")
        log(f"kernel spmv_compact / spmm_compact [{name}, {ranks} rank "
            f"slices of {loc.n_rows} rows, nnz {nnz}]: vs plain ok, "
            f"slices bit-equal to the whole plan")


def row5_graph():
    """BASELINE row 5: uniform random edges, as bench_all.py makes them."""
    import numpy as np
    rng = np.random.default_rng(0)
    src = rng.integers(0, ROW5_N, ROW5_EDGES, dtype=np.int32)
    dst = rng.integers(0, ROW5_N, ROW5_EDGES, dtype=np.int32)
    return src, dst


def pagerank_oracle(src, dst, n, rounds, alpha=0.85, weights=None):
    """float64 power iteration over the scipy CSR form of Âᵀ with the
    package's dangling/teleport rule (workloads/pagerank.py
    _power_body); ``weights`` per edge (default 1)."""
    import numpy as np
    import scipy.sparse as sp
    w = (np.ones(len(src)) if weights is None
         else np.asarray(weights, np.float64))
    outdeg = np.bincount(src, weights=w, minlength=n)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1e-30), 0.0)
    M = sp.csr_matrix((w * inv[src], (dst, src)), shape=(n, n))
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
    ROW5_PR_TOP[:] = [(int(i), float(r64[i]))
                      for i in np.argsort(r64)[::-1][:10]]
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


def csr_bound(real, n_rows, n_cols, k, ops_per_elem):
    """(bound_ms, bound_by) of one SpMV (k = 1) or SpMM on this run's
    data, the same work whatever implements it: the CSR minimum — each
    real slot's 8 bytes (column and value), n_rows + 1 row pointers of
    4 bytes, x (or X, k columns) read once and y (or Y) written once —
    against ``ops_per_elem`` f32 operations a real slot and column."""
    nbytes = real * 8 + (n_rows + 1) * 4 + (n_cols + n_rows) * 4 * k
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = real * k * ops_per_elem / PEAK_FLOPS["float32"] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def table_bound_ms(real, n_rows, n_cols, k, bytes_per_slot):
    """The byte bound of the plans' own table formats: each real slot's
    bytes there (13 compact, 12 routed), x (or X) and y (or Y) once —
    logged beside the CSR minimum for comparison."""
    nbytes = real * bytes_per_slot + (n_cols + n_rows) * 4 * k
    return nbytes / HBM_BYTES_PER_S * 1e3


def row5_timing(A, dev):
    """B2 and B3 at the row-5 shape, both over the plan's CSR view: kernel
    vs plain on the compact tables (CUDA events, median), bound, and
    torch.sparse.mm on the CSR form (cuSPARSE); B2 also at 4 and 8 lanes
    a row."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.ops.spmv_routed import lanes_per_row
    plan = A._get_plan()
    tables = pc.compact_tables(plan, dev)
    view = pc.csr_view_on(plan, dev)
    n_rows, n_cols, block = plan.n_rows, plan.n_cols, plan.block
    real = view.nnz
    gen = torch.Generator(device=dev).manual_seed(8)
    x = torch.rand(n_cols, generator=gen, device=dev)
    X = torch.rand((n_cols, ROW5_K), generator=gen, device=dev)
    csr = csr_of(A, dev)
    out = {}
    for name, k in (("spmv_compact", 1), ("spmm_compact", ROW5_K)):
        if k == 1:
            run = lambda: pc.spmv_scatter(view, x, 3)
            plain = lambda: pc.spmv_scatter_plain(*tables, x, n_rows, block, 3)
            lib = lambda: torch.sparse.mm(csr, x[:, None])
        else:
            run = lambda: pc.spmm_scatter(view, X, 3)
            plain = lambda: pc.spmm_scatter_plain(*tables, X, n_rows, block, 3)
            lib = lambda: torch.sparse.mm(csr, X)
        got, want = run(), plain()
        torch.cuda.synchronize()
        err = rel_err(f"{name} row-5 shape", got, want, SPMV_REL_TOL[3])
        ms = time_ms(run, warmup=3, runs=20, batch=10)
        plain_ms = time_ms(plain, warmup=1, runs=10)
        # per real slot and column: one multiply, the 3-pass split (6
        # ops) and one add
        bound = csr_bound(real, n_rows, n_cols, k, 8)
        old_bound = table_bound_ms(real, n_rows, n_cols, k, 13)
        lib_ms = library_time(f"torch.sparse.mm f32 CSR k={k}", lib, got)
        lanes = ""
        if k == 1:
            by_lanes = {n: time_ms(lambda n=n: pc.spmv_scatter(view, x, 3, n),
                                   warmup=3, runs=20, batch=10)
                        for n in (4, 8)}
            lanes = (f" ({lanes_per_row(real, n_rows)} lanes a row; "
                     + ", ".join(f"{n} lanes {t:.4f} ms"
                                 for n, t in by_lanes.items()) + ")")
        log(f"row-5 shape {name} (k={k}, {real} real slots of "
            f"{tables[0].numel()}): kernel {ms:.4f} ms{lanes}, plain "
            f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}, CSR "
            f"minimum; {old_bound:.4f} ms at 13 B a slot), library "
            f"{lib_ms} ms; kernel vs plain max_abs_err {err:.3e}")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound[0], "bound_by": bound[1],
                     "library_ms": lib_ms}
        del got, want
    return out


# -- routed SpMV: kernel B8 (ops/spmv_routed.py) ----------------------------

#: B8 against its plain version, relative to max|plain|: both add the same
#: split parts, in f64, rounded once (register sums in lane order vs
#: index_add_ order), so they differ by about one f32 rounding.
ROUTED_REL_TOL = 1e-6
#: the whole routed product (overflow included) vs a float64 oracle: the
#: JAX package's bounds (tests/test_spmv.py) at passes 2 and 3; passes 1
#: truncates both value sides to 8 bits (2^-7 relative each).
ROUTED_ORACLE_TOL = {1: 5e-2, 2: 5e-4, 3: 1e-6}
#: CG over the row-5 Gram operator: tolerance, iteration cap and the
#: ridge term that keeps AᵀA + l2·I well conditioned (AᵀA is singular:
#: ~45 dangling nodes give zero columns).
CG_TOL, CG_MAXITER, CG_L2 = 1e-5, 500, 0.1


#: the hub row of routed_case's "hub row" case
ROUTED_HUB_ROW = 33_333


def routed_case(name, seed):
    """(rows, cols, vals, n_rows, n_cols, build kwargs, empty (dst, src)
    groups) for the routed kernel phase: the JAX tests' shapes
    (tests/test_spmv.py TestRoutedSpMV), and a hub row of some 2,000
    slots spread over every source group (tests/test_torch_csr_view.py's
    hub_row), which one sub-warp walks whole."""
    import numpy as np
    from matrel_tpu_torch.ops.spmv_routed import SPAN
    rng = np.random.default_rng(seed)
    kw, empty = {}, (None, None)
    if name.startswith("3 x 3"):
        n_rows = n_cols = 40_000
        m = 20_000
    elif name.startswith("rectangular"):
        n_rows, n_cols, m = 5_000, 33_000, 8_000
    elif name.startswith("empty"):
        n_rows = n_cols = 40_000
        m, kw, empty = 6_000, dict(max_padding=10.0), (1, 2)
    elif name.startswith("hub"):
        n_rows = n_cols = 40_000
        m = 20_000
    else:                                   # hot cell into overflow
        n_rows = n_cols = 40_000
        m = 3_000
        kw = dict(capacity_quantile=0.0, max_padding=1000.0)
    rows = rng.integers(0, n_rows, m)
    cols = rng.integers(0, n_cols, m)
    vals = rng.standard_normal(m).astype(np.float32)
    if empty[0] is not None:
        rows = np.where(rows // SPAN == empty[0], rows - SPAN, rows)
        cols = np.where(cols // SPAN == empty[1], cols - SPAN, cols)
    if name.startswith("hot"):
        rows[:1500] = 7
        cols[:1500] = 11
    if name.startswith("hub"):
        rows[rng.random(m) < 0.1] = ROUTED_HUB_ROW
    return rows, cols, vals, n_rows, n_cols, kw, empty


def routed_kernel_phase(dev) -> None:
    """B8 against its plain version on the plan's tables and the plain
    walk of its CSR view on the card (passes 1, 2 and 3, at every sub-warp
    width in WALK_LANES), each call's launch checked, and the whole
    routed product (overflow included) against a float64 oracle."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import spmv_routed as rt
    names = ("3 x 3 groups, square", "rectangular 5,000 x 33,000",
             "empty destination group 1 and source group 2",
             "hot cell (0, 0) into the overflow COO",
             "hub row 33,333 over every source group")
    for i, name in enumerate(names):
        rows, cols, vals, n_rows, n_cols, kw, empty = routed_case(name,
                                                                  500 + i)
        plan = rt.build_routed_plan(rows, cols, vals, n_rows, n_cols, **kw)
        if plan is None:
            raise AssertionError(f"B8 {name}: plan refused")
        if name.startswith("hot") != (plan.ov_rows is not None):
            raise AssertionError(f"B8 {name}: overflow "
                                 f"{plan.ov_rows is not None}")
        tables = plan.tables_on(dev)
        view = plan.csr_on(dev)
        if name.startswith("hub"):
            hub = view.row_ptr[ROUTED_HUB_ROW:ROUTED_HUB_ROW + 2].tolist()
            groups = set(np.unique(cols[rows == ROUTED_HUB_ROW] // rt.SPAN))
            if hub[1] - hub[0] <= 1000 or groups != set(range(plan.g_src)):
                raise AssertionError(f"B8 {name}: {hub[1] - hub[0]} slots "
                                     f"from source groups {sorted(groups)}")
        x_np = np.random.default_rng(600 + i).standard_normal(
            n_cols).astype(np.float32)
        x = torch.as_tensor(x_np, device=dev)
        want = np.zeros(n_rows)
        np.add.at(want, rows, vals.astype(np.float64) * x_np[cols])
        for passes in (1, 2, 3):
            yp = rt.routed_scatter_plain(*tables, x, n_rows, passes)
            yw = rt.csr_scatter_plain(view, x, passes)
            for lanes in WALK_LANES:
                before = rt.LAUNCHES_ROUTED
                y = rt.routed_scatter(view, x, passes, lanes)
                torch.cuda.synchronize()
                if rt.LAUNCHES_ROUTED != before + 1:
                    raise AssertionError(f"B8 {name}: {rt.LAUNCHES_ROUTED - before}"
                                         f" launches counted, want 1")
                err = rel_err(f"B8 {name} passes={passes} lanes={lanes}",
                              y, yp, ROUTED_REL_TOL)
                rel_err(f"B8 {name} passes={passes} lanes={lanes} vs the "
                        f"view's plain walk", y, yw, ROUTED_REL_TOL)
                if empty[0] is not None and y[
                        empty[0] * rt.SPAN:(empty[0] + 1) * rt.SPAN].any():
                    raise AssertionError(f"B8 {name}: empty group not zero")
                log(f"kernel spmv_routed [{name}] g_s={plan.g_src} "
                    f"g_d={plan.g_dst} cap={plan.cap} nnz="
                    f"{view.nnz} passes={passes} lanes={lanes}: "
                    f"max_abs_err {err:.3e} vs plain ok")
            full = rt.routed_spmv(plan, x, passes, device=dev)
            e_or = rel_err(f"B8+overflow {name} passes={passes} vs float64",
                           full.cpu(), torch.as_tensor(want),
                           ROUTED_ORACLE_TOL[passes])
            log(f"  routed_spmv [{name}] passes={passes}: {e_or:.3e} vs "
                f"float64 oracle ok")


def row5_edges():
    """The row-5 matrix A = Âᵀ as an edge list: rows = dst, cols = src,
    vals = 1/outdeg[src] (as row5_matrix builds it)."""
    import numpy as np
    src, dst = row5_graph()
    outdeg = np.bincount(src, minlength=ROW5_N).astype(np.float32)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1e-30),
                   0.0).astype(np.float32)
    return dst, src, inv[src]


def scipy_csr(rows, cols, vals, n):
    import numpy as np
    import scipy.sparse as sp
    return sp.csr_matrix((vals.astype(np.float64), (rows, cols)),
                         shape=(n, n))


def routed_bound(plan, passes, dev):
    """(bound_ms, bound_by) of one routed matvec on this run's data (the
    CSR minimum, :func:`csr_bound`; per real slot two ``passes``-part
    splits of 3 ops a part, one multiply and one add), the bound at the
    routed tables' 12 bytes a real slot, and the real slots."""
    real = plan.csr_on(dev).nnz
    bound = csr_bound(real, plan.n_rows, plan.n_cols, 1, 6 * passes + 2)
    return bound, table_bound_ms(real, plan.n_rows, plan.n_cols, 1,
                                 12), real


def path_row5_routed(dev, A, library_ms):
    """routed_spmv at row 5: the plan build on the host, A·x at passes 2
    and 3 through routed_spmv against the plain version, the compact B2
    route (spmv_compact) and a float64 scipy oracle; then kernel and
    plain times (CUDA events)."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.ops import spmv_routed as rt
    rows, cols, vals = row5_edges()
    t0 = time.perf_counter()
    plan = rt.build_routed_plan(rows, cols, vals, ROW5_N, ROW5_N)
    build_s = time.perf_counter() - t0
    if plan is None:
        raise AssertionError("row 5: routed plan refused")
    n_ov = 0 if plan.ov_rows is None else len(plan.ov_rows)
    gen = torch.Generator(device=dev).manual_seed(9)
    x = torch.rand(ROW5_N, generator=gen, device=dev)
    M = scipy_csr(rows, cols, vals, ROW5_N)
    want = torch.as_tensor(M @ x.double().cpu().numpy())
    t0 = time.perf_counter()
    plan.csr_on(dev)
    torch.cuda.synchronize()
    view_s = time.perf_counter() - t0
    rt.LAUNCHES_ROUTED = 0                 # the row-5 routed path
    ys = {p: rt.routed_spmv(plan, x, passes=p, device=dev) for p in (2, 3)}
    torch.cuda.synchronize()
    launches = rt.LAUNCHES_ROUTED
    if launches != 2:
        raise AssertionError(f"row 5 routed: {launches} B8 launches, want 2")
    b2_plan = A._get_plan()
    out = {}
    for passes, y in ys.items():
        plain = rt.routed_spmv(plan, x, passes=passes, device=dev,
                               use_pallas=False)
        err = rel_err(f"row 5 routed passes={passes} vs plain", y, plain,
                      ROUTED_REL_TOL)
        b2 = pc.spmv_compact(b2_plan, x, passes=passes, device=dev)
        # passes 3: both exact per slot; passes 2: B8 also truncates x
        e_b2 = rel_err(f"row 5 routed passes={passes} vs B2", y, b2,
                       ROUTED_REL_TOL if passes == 3 else 1e-4)
        e_64 = rel_err(f"row 5 routed passes={passes} vs float64",
                       y.cpu(), want, ROUTED_ORACLE_TOL[passes])
        tables, view = plan.tables_on(dev), plan.csr_on(dev)
        ms = time_ms(lambda: rt.routed_scatter(view, x, passes),
                     warmup=3, runs=20, batch=10)
        plain_ms = time_ms(lambda: rt.routed_scatter_plain(
            *tables, x, ROW5_N, passes), warmup=1, runs=5)
        (bound_ms, bound_by), old_bound, real = routed_bound(plan, passes,
                                                             dev)
        log(f"path row 5 routed A·x passes={passes}: max_abs_err {err:.3e} vs"
            f" plain, {e_b2:.3e} vs B2, {e_64:.3e} vs float64 scipy; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}, CSR minimum; {old_bound:.4f} ms at 12 B a slot), "
            f"library {library_ms} ms (torch.sparse.mm f32 CSR, "
            f"row5_timing)")
        out[passes] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": bound_by,
                       "library_ms": library_ms}
    log(f"row 5 routed plan: build {build_s:.2f} s on the host, g_s = g_d ="
        f" {plan.g_src}, cap {plan.cap}, {plan.slots} slots ({real} real), "
        f"padding ratio {plan.padding_ratio:.4f}, overflow {n_ov}; CSR view "
        f"built on the card in {view_s:.3f} s, "
        f"{rt.lanes_per_row(real, ROW5_N)} lanes a row")
    return launches, out, plan


def path_row5_cg(dev, A, plan):
    """CG over the routed Gram operator v ↦ Aᵀ(A·v) + l2·v at row 5
    (passes 3), checked by a float64 residual, then the same solve over
    the compact B2 operator."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.ops import spmv_routed as rt
    from matrel_tpu_torch.workloads import cg
    rows, cols, vals = row5_edges()
    plan_t = rt.build_routed_plan(cols, rows, vals, ROW5_N, ROW5_N)
    if plan_t is None:
        raise AssertionError("row 5: routed transpose plan refused")
    # cond(AᵀA + l2·I) <= (‖A‖₁‖A‖∞ + l2) / l2
    norm1 = np.bincount(cols, weights=vals, minlength=ROW5_N).max()
    norm_inf = np.bincount(rows, weights=vals, minlength=ROW5_N).max()
    cond_bound = (norm1 * norm_inf + CG_L2) / CG_L2

    def op_routed(v):
        return rt.routed_spmv(plan_t, rt.routed_spmv(plan, v, 3, dev), 3,
                              dev) + CG_L2 * v

    b2, b2_t = A._get_plan(), A._get_plan_t()

    def op_compact(v):
        return pc.spmv_compact(b2_t, pc.spmv_compact(b2, v, 3, dev), 3,
                               dev) + CG_L2 * v

    gen = torch.Generator(device=dev).manual_seed(10)
    b = torch.rand(ROW5_N, generator=gen, device=dev)
    # warm: the transpose tables' upload and the first use of each
    # vector kernel (loaded lazily) stay out of the timed solve
    cg.cg_solve_linop(op_routed, b, tol=CG_TOL, maxiter=2)
    torch.cuda.synchronize()
    rt.LAUNCHES_ROUTED = 0                  # the row-5 CG path
    t0 = time.perf_counter()
    x, it = cg.cg_solve_linop(op_routed, b, tol=CG_TOL, maxiter=CG_MAXITER)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    launches = rt.LAUNCHES_ROUTED
    if it >= CG_MAXITER or launches != 2 * it:
        raise AssertionError(f"row 5 CG: {it} iterations, {launches} B8 "
                             f"launches")
    M = scipy_csr(rows, cols, vals, ROW5_N)
    x64, b64 = x.double().cpu().numpy(), b.double().cpu().numpy()
    res = np.linalg.norm(M.T @ (M @ x64) + CG_L2 * x64 - b64) \
        / np.linalg.norm(b64)
    if not np.isfinite(x64).all() or res > 10 * CG_TOL:
        raise AssertionError(f"row 5 CG: float64 relative residual {res}")
    xc, it_c = cg.cg_solve_linop(op_compact, b, tol=CG_TOL,
                                 maxiter=CG_MAXITER)
    dx = float((x - xc).double().norm() / xc.double().norm())
    if abs(it - it_c) > 2 or dx > 1e-4:
        raise AssertionError(f"row 5 CG: routed {it} iterations vs B2 "
                             f"{it_c}, relative difference {dx}")
    state = (torch.zeros_like(b), b, b, torch.dot(b, b))
    dev_ms = time_ms(lambda: cg.cg_step(op_routed, state), warmup=2,
                     runs=10, batch=10)
    # one iteration of the solver's loop split on the host clock: the
    # launches of cg_step, then the read of ‖r‖² that waits for them
    launch_s = wait_s = 0.0
    for _ in range(it):
        t0 = time.perf_counter()
        state = cg.cg_step(op_routed, state)
        t1 = time.perf_counter()
        float(state[3])
        launch_s += t1 - t0
        wait_s += time.perf_counter() - t1
    launch_ms, wait_ms = launch_s * 1e3 / it, wait_s * 1e3 / it
    it_ms = wall_s * 1e3 / it
    log(f"path row 5 CG (l2 = {CG_L2}, cond <= {cond_bound:.1f}, tol "
        f"{CG_TOL}): {it} iterations, {launches} B8 launches, float64 "
        f"relative residual {res:.3e}; B2 operator {it_c} iterations, "
        f"relative difference {dx:.3e}; {it_ms:.4f} ms per iteration "
        f"({wall_s:.3f} s), device-bound step {dev_ms:.4f} ms, host share "
        f"{max(0.0, 1 - dev_ms / it_ms):.3f}; split on the host clock: "
        f"launch {launch_ms:.4f} ms + wait for ‖r‖² {wait_ms:.4f} ms")
    return launches, {"iterations": it, "ms_per_iteration": it_ms,
                      "device_ms": dev_ms, "launch_ms": launch_ms,
                      "wait_ms": wait_ms}


# -- BASELINE row 3: normal-equations linreg ---------------------------------

ROW3_N, ROW3_K, ROW3_PANEL, ROW3_RESIDENT = 10_000_000, 1000, 250_000, \
    1_000_000
U32 = 2.0 ** -24                    # f32 unit roundoff


def row3_oracle(panel_fn, n_panels, snapshot):
    """float64 Gram and right-hand side over the same panels, on the card:
    (G, r) after ``snapshot`` panels and after all of them."""
    import torch
    G = r = None
    snap = None
    for p in range(n_panels):
        xp, yp = panel_fn(p)
        x64 = xp.double()
        del xp
        g, rr = x64.T @ x64, x64.T @ yp.double()
        G = g if G is None else G + g
        r = rr if r is None else r + rr
        del x64, g, rr, yp
        if p + 1 == snapshot:
            snap = (G.clone(), r.clone())
    torch.cuda.synchronize()
    return snap, (G, r)


def spectrum(G):
    import torch
    ev = torch.linalg.eigvalsh(G)
    return float(ev[0]), float(ev[-1])


#: Largest backward error ‖Gθ − r‖ / (‖G‖₂‖θ‖) a row-3 solve may show
#: against the float64 normal equations (G, r): the bf16 split's 2^-16
#: resolution, at which "high" works; f32 Grams summed over 10M rows
#: stay below it. Unlike the forward error it does not grow with
#: cond(XᵀX).
ROW3_ETA_MAX = 2e-5


def theta_check(name, theta, G, r, want):
    """(backward error η, forward error ‖θ − θ64‖/‖θ64‖, cond) of a θ
    against the float64 system (G, r) and its solution ``want``; raises
    unless θ is finite, η ≤ ROW3_ETA_MAX and the forward error stays
    within its first-order bound, 10·cond(G)·η."""
    import torch
    t = theta.double().reshape(-1, 1)
    w = want.double().reshape(-1, 1)
    if not torch.isfinite(t).all():
        raise AssertionError(f"{name}: non-finite θ")
    lo, hi = spectrum(G)
    eta = float((G @ t - r).norm() / (hi * t.norm()))
    fwd = float((t - w).norm() / w.norm())
    cond = hi / lo
    if eta > ROW3_ETA_MAX or fwd > 10 * cond * max(eta, U32):
        raise AssertionError(f"{name}: backward error {eta} (max "
                             f"{ROW3_ETA_MAX}), forward error {fwd} (cond "
                             f"{cond:.3e})")
    return eta, fwd, cond


def gram_drift(panel_fn, n_panels, G) -> dict:
    """Row 3's "high" Gram (the bf16 split of ops/gram.py) over every
    panel, its bf16 passes run two ways: one tensor-core GEMM over a
    panel's whole 250,000 rows, and ``strategies.local_dot``'s 2048-row
    chunks summed in f32 (what the port runs). For each: the relative
    Frobenius error and the mean relative drift of the diagonal against
    the float64 Gram ``G``, and whether Cholesky still factors it. Raises
    only if the chunked form does not factor."""
    import torch
    from matrel_tpu_torch.ops.gram import symmetric_gram
    from matrel_tpu_torch.parallel import strategies

    def one_gemm(a, b):
        return torch.mm(a, b, out_dtype=torch.float32)

    out = {}
    for label, dot in (("one GEMM", one_gemm),
                       ("2048-row chunks", strategies.local_dot)):
        acc = None
        for p in range(n_panels):
            xp, _ = panel_fn(p)
            g = symmetric_gram(xp, lambda a, b: dot(a.T, b))
            acc = g if acc is None else acc + g
            del xp, g
        d = acc.double()
        rel = float((d - G).norm() / G.norm())
        drift = float(((d.diagonal() - G.diagonal())
                       / G.diagonal()).mean())
        factors = int(torch.linalg.cholesky_ex(acc)[1]) == 0
        out[label] = {"rel": rel, "diag_drift": drift, "factors": factors}
        del acc, d
    if not out["2048-row chunks"]["factors"]:
        raise AssertionError("row 3: the chunked bf16 Gram does not factor")
    log("row 3 \"high\" Gram, bf16 passes on the tensor cores, vs float64: "
        + "; ".join(f"{k}: ‖ΔG‖/‖G‖ {v['rel']:.3e}, mean diagonal drift "
                    f"{v['diag_drift']:.3e}, Cholesky "
                    f"{'factors' if v['factors'] else 'fails'}"
                    for k, v in out.items()))
    return out


def path_row3_linreg(sess):
    """BASELINE row 3 at full size through fit_streaming (bench_all.py's
    hash panels, planted θ = 1) at precision "high" and "highest", held
    against a float64 normal-equations solve; then fit through
    compile_exprs on the first 1,000,000 rows held whole on the card,
    against fit_streaming and cg_least_squares on the same rows."""
    import torch
    from matrel_tpu_torch.core import padding
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.workloads import cg, linreg
    dev = sess.device
    n, k, panel = ROW3_N, ROW3_K, ROW3_PANEL
    panel_fn = linreg.hash_panel_fn(panel, k, dev)
    n_panels = n // panel
    n1 = ROW3_RESIDENT
    t0 = time.perf_counter()
    (G1, r1), (G, r) = row3_oracle(panel_fn, n_panels, n1 // panel)
    oracle_s = time.perf_counter() - t0
    lo, hi = spectrum(G)
    theta64 = torch.cholesky_solve(r, torch.linalg.cholesky(G))
    e64 = float((theta64 - 1).abs().max())
    if e64 > 1e-3:
        raise AssertionError(f"row 3: float64 θ is {e64} from the planted 1")
    log(f"row 3 oracle: float64 Gram over {n_panels} panels in "
        f"{oracle_s:.2f} s; XᵀX eigenvalues [{lo:.4e}, {hi:.4e}], cond "
        f"{hi / lo:.4e}; max|θ64 - 1| = {e64:.3e}")
    linreg.fit_streaming(panel, k, panel_fn, panel_rows=panel)   # warm
    flops = 2.0 * n * k * k + 2.0 * n * k
    out = {}
    for precision in ("high", "highest"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        theta = linreg.fit_streaming(n, k, panel_fn, panel_rows=panel,
                                     precision=precision)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        eta, fwd, cond = theta_check(f"row 3 fit_streaming {precision}",
                                     theta, G, r, theta64)
        e1 = float((theta.double() - 1).abs().max())
        log(f"path row 3 fit_streaming({n:,} x {k}, "
            f"precision={precision!r}): {secs:.3f} s, "
            f"{flops / secs / 1e12:.2f} TFLOP/s (2nk² + 2nk); vs float64: "
            f"backward error {eta:.3e} ({eta / U32:.1f} u), forward "
            f"{fwd:.3e} (cond·η = {cond * eta:.3e}), max|θ - 1| = "
            f"{e1:.3e}; peak {torch.cuda.max_memory_allocated() / 2**30:.3f}"
            f" GiB")
        out[precision] = {"s": secs, "tflops": flops / secs / 1e12,
                          "eta": eta, "fwd": fwd}
    out["gram_drift"] = gram_drift(panel_fn, n_panels, G)
    del G, r
    # the first n1 rows held whole: fit (compile_exprs), fit_streaming
    # and CG on the ridge system, l2 = 1e-3·λ_max, whose condition
    # (~1e3) CG can reach in a few hundred iterations (XᵀX alone has
    # cond ~1e5)
    X = torch.empty((n1, k), dtype=torch.float32, device=dev)
    Y = torch.empty((n1, 1), dtype=torch.float32, device=dev)
    for p in range(n1 // panel):
        X[p * panel:(p + 1) * panel], Y[p * panel:(p + 1) * panel] = \
            panel_fn(p)
    spec = padding.canonical_spec((n1, k), sess.mesh)
    Xb = BlockMatrix.from_array(X, (n1, k), sess.mesh, spec)
    Yb = BlockMatrix.from_array(Y, (n1, 1), sess.mesh,
                                padding.canonical_spec((n1, 1), sess.mesh))
    l2 = 1e-3 * spectrum(G1)[1]
    G1 = G1 + l2 * torch.eye(k, dtype=torch.float64, device=dev)
    want1 = torch.cholesky_solve(r1, torch.linalg.cholesky(G1))
    t0 = time.perf_counter()
    th_fit = linreg.fit(Xb, Yb, l2=l2)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    th_str = linreg.fit_streaming(n1, k, panel_fn, panel_rows=panel, l2=l2)
    t0 = time.perf_counter()
    th_cg, it = cg.cg_least_squares(Xb, Y, l2=l2, tol=1e-6, maxiter=2000)
    torch.cuda.synchronize()
    cg_s = time.perf_counter() - t0
    if it >= 2000:
        raise AssertionError(f"row 3 CG did not converge in {it}")
    errs = {name: theta_check(f"row 3 ({n1} rows) {name}", th, G1, r1,
                              want1)
            for name, th in (("fit", th_fit), ("fit_streaming", th_str),
                             ("cg_least_squares", th_cg))}
    cond1 = errs["fit"][2]
    d_fs = float((th_fit - th_str).double().norm() / th_str.double().norm())
    d_cg = float((th_cg.reshape(-1, 1) - th_fit).double().norm()
                 / th_fit.double().norm())
    if max(d_fs, d_cg) > 10 * cond1 * max(ROW3_ETA_MAX, 1e-6):
        raise AssertionError(f"row 3 ({n1} rows): fit vs fit_streaming "
                             f"{d_fs}, cg vs fit {d_cg}")
    log(f"path row 3 (first {n1} rows resident, l2 = {l2:.4e}, cond "
        f"{cond1:.3e}): fit via compile_exprs {fit_s:.3f} s, CG "
        f"{it} iterations {cg_s:.3f} s; vs float64 (backward / forward) "
        + ", ".join(f"{k_} {e[0]:.3e} / {e[1]:.3e}"
                    for k_, e in errs.items())
        + f"; fit vs fit_streaming {d_fs:.3e}, cg vs fit {d_cg:.3e}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    del X, Y, Xb, Yb
    torch.cuda.empty_cache()
    return out


# -- S×S SpGEMM: kernels B4–B7 (ops/pallas_spgemm.py) -----------------------

#: The JAX package's S×S deployments (bench.py measure_spgemm and
#: measure_sparse_kernels): full scale, and the compute comparison scale.
SPGEMM_N, SPGEMM_CMP_N = 100_352, 32_768
#: A registry runner's schedule → the kernel entry it launches.
SPGEMM_KERNEL_OF = {"pairs": "spgemm_pairs", "grouped": "spgemm_grouped",
                    "band": "spgemm_band", "bucketed": "spgemm_powerlaw"}
SPGEMM_REPLACES = {
    "spgemm_pairs": "matrel_tpu/ops/kernel_registry.py:297",
    "spgemm_grouped": "matrel_tpu/ops/kernel_registry.py:406",
    "spgemm_band": "matrel_tpu/ops/kernel_registry.py:659",
    "spgemm_powerlaw": "matrel_tpu/ops/kernel_registry.py:696",
}
PALLAS_IDS = ("pallas_generic", "pallas_cluster", "pallas_band",
              "pallas_powerlaw")


def spgemm_launches() -> dict:
    from matrel_tpu_torch.ops import pallas_spgemm as ps
    return {"spgemm_pairs": ps.LAUNCHES_PAIRS,
            "spgemm_grouped": ps.LAUNCHES_GROUPED,
            "spgemm_band": ps.LAUNCHES_BAND,
            "spgemm_powerlaw": ps.LAUNCHES_POWERLAW}


def zero_spgemm_launches() -> None:
    from matrel_tpu_torch.ops import pallas_spgemm as ps
    ps.LAUNCHES_PAIRS = ps.LAUNCHES_GROUPED = 0
    ps.LAUNCHES_BAND = ps.LAUNCHES_POWERLAW = 0
    ps.BODY_LAUNCHES.update(dict.fromkeys(ps.BODY_LAUNCHES, 0))


def spgemm_body(bs: int, dtype_name: str) -> str:
    """The tile body ops/tile_body.py assigns a launch over bs-tiles (the
    stacks the port allocates are 16-byte aligned)."""
    from matrel_tpu_torch.ops import tile_body
    if dtype_name == "float32":
        return "f32"
    return tile_body.bf16_body(bs, bs, True)


def check_bodies(name: str, launches: dict, bs: int, dtype_name: str) -> None:
    """Every launch counted since the counts were zeroed went through the
    body :func:`spgemm_body` names."""
    from matrel_tpu_torch.ops import pallas_spgemm as ps
    want = spgemm_body(bs, dtype_name)
    total = sum(launches.values())
    got = {b: v for b, v in ps.BODY_LAUNCHES.items() if v}
    if got != ({want: total} if total else {}):
        raise AssertionError(f"{name}: bodies {got}, want {total} x {want}")


def predicted_launches(run) -> dict:
    """The launches one call of a registry runner makes, from its host
    tables: one, or one per non-empty bucket."""
    name = SPGEMM_KERNEL_OF[run.schedule]
    n = len(run.tables["buckets"]) if run.schedule == "bucketed" else 1
    return {k: (n if k == name else 0) for k in SPGEMM_REPLACES}


def launch_ctas(run, n_out, bs, dtype_name) -> list:
    """The CTAs of each kernel launch of a registry runner: its slots
    times the sub-tiles of an output tile (f32: 128 x 128 for bs >= 128,
    else 64 x 64; bf16: the wgmma body's 128 x 256, the WMMA body's
    64 x 64)."""
    body = spgemm_body(bs, dtype_name)
    rows, cols = {"f32": (128, 128) if bs >= 128 else (64, 64),
                  "wgmma": (128, 256), "wmma": (64, 64)}[body]
    slots = ([len(bk["ids"]) for bk in run.tables["buckets"]]
             if run.schedule == "bucketed" else [n_out])
    return [n * math.ceil(bs / rows) * math.ceil(bs / cols) for n in slots]


def spgemm_runner(A, B, kid):
    """(runner, masked A payload, masked B payload, n_out) of one
    registry kernel over (A, B) under the default config."""
    from matrel_tpu_torch.config import MatrelConfig
    from matrel_tpu_torch.ops import kernel_registry as kr
    from matrel_tpu_torch.ops import spgemm as sg
    cfg = MatrelConfig()
    pa, pb, slot, out_rows, out_cols = sg._pair_structure_cached(A, B)
    out_dtype = sg._out_dtype(A, B, cfg)
    n_out = int(out_rows.size)
    run = kr.build_runner(kid, A, B, cfg, (slot, pa, pb, out_rows, out_cols),
                          n_out, out_dtype)
    return run, sg._edge_masked(A), sg._edge_masked(B), n_out


def spgemm_plain(run, a, b, n_out):
    """The plain version of a runner's kernel over the same host tables,
    on the card."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spgemm as ps
    t = run.tables

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32),
                               device=a.device)

    if run.schedule == "pairs":
        return ps.spgemm_pairs_plain(a, b, i32(t["slot_ptr"]), i32(t["pa"]),
                                     i32(t["pb"]))
    if run.schedule == "grouped":
        return ps.spgemm_grouped_plain(a, b, i32(t["src"]),
                                       i32(t["group_slot"]), i32(t["pa"]),
                                       i32(t["pb"]), t["group"], n_out)
    if run.schedule == "band":
        return ps.spgemm_band_plain(a, b, i32(t["a_idx"]), i32(t["b_idx"]),
                                    i32(t["sel"]), t["wa"],
                                    t["nchunks"] * t["rc"])
    bs = a.shape[1]
    out = torch.zeros((n_out, bs, bs), dtype=a.dtype, device=a.device)
    for bk in t["buckets"]:
        out[i32(bk["ids"]).long()] = ps.spgemm_grouped_plain(
            a, b, i32(bk["src"]), i32(bk["group_slot"]), i32(bk["pa"]),
            i32(bk["pb"]), bk["group"], len(bk["ids"]))
    return out


def tile_matrix(rows, cols, shape, bs, seed, mesh, dtype="float32"):
    """A BlockSparseMatrix with the given tile coordinates (kept in the
    order given) and standard-normal payloads made on the card."""
    import numpy as np
    import torch
    from matrel_tpu_torch.core.blockmatrix import as_torch_dtype
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    dev = mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    blocks = torch.randn((len(rows), bs, bs), generator=gen, device=dev)
    S = BlockSparseMatrix(
        blocks=blocks.to(as_torch_dtype(dtype)),
        block_rows=torch.as_tensor(np.asarray(rows, np.int32), device=dev),
        block_cols=torch.as_tensor(np.asarray(cols, np.int32), device=dev),
        shape=tuple(shape), block_size=bs, mesh=mesh)
    S._seed_host_tiles(rows, cols)
    return S


def band_tiles(gr, offsets, drop_row=None):
    import numpy as np
    r = np.repeat(np.arange(gr), len(offsets))
    c = r + np.tile(np.asarray(offsets), gr)
    keep = (c >= 0) & (c < gr) & (r != drop_row)
    return r[keep], c[keep]


def as_dtype(S, dtype):
    """S with its payload cast (tile lists shared)."""
    import torch
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    if S.dtype == getattr(torch, dtype):
        return S
    T = BlockSparseMatrix(blocks=S.blocks.to(getattr(torch, dtype)),
                          block_rows=S.block_rows, block_cols=S.block_cols,
                          shape=S.shape, block_size=S.block_size,
                          mesh=S.mesh)
    T._seed_host_tiles(*S.host_tiles())
    return T


def spgemm_cases(mesh):
    """(name, A, B, check) for the kernel phase; ``check(run_of)`` asserts
    what the case is for on the runners' host tables."""
    import numpy as np
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.ops import kernel_registry as kr
    cases = []
    A = kr.synthesize_structure("clustered_tile", 256, 8, mesh, seed=1)
    B = kr.synthesize_structure("clustered_tile", 256, 8, mesh, seed=2)

    def runs_not_multiple_of_g(run_of):
        t = run_of("pallas_cluster").tables
        live = t["src"] < len(t["pa"])
        counts = np.bincount(np.repeat(t["group_slot"], t["group"])[live])
        assert (counts % t["group"]).any(), "every run a multiple of G"
    cases.append(("bs=8 clustered, runs not a multiple of G", A, B,
                  runs_not_multiple_of_g))

    A = kr.synthesize_structure("powerlaw_coo", 3072, 16, mesh, seed=3)

    def hub_and_single(run_of):
        t = run_of("pallas_generic").tables
        runs = np.diff(t["slot_ptr"])
        assert runs.max() >= 64 and runs.min() == 1, (runs.min(), runs.max())
        assert len(run_of("pallas_powerlaw").tables["buckets"]) == 2
    cases.append(("bs=16 powerlaw A·Aᵀ: a hub slot of >= 64 pairs, "
                  "single-pair slots, both buckets", A, A.transpose(),
                  hub_and_single))

    A = BlockSparseMatrix.random((1000, 950), 0.05, block_size=24, mesh=mesh,
                                 seed=4)
    B = BlockSparseMatrix.random((950, 1001), 0.05, block_size=24,
                                 mesh=mesh, seed=5)
    cases.append(("bs=24 ragged random (overhang in the edge tiles)", A, B,
                  None))

    # the f32 body's other instances: the 128 x 128 sub-tile with its
    # ragged edge masked (bs 192), and the scalar loads of rows that are
    # not 16-byte aligned (bs % 4 != 0) under both sub-tiles
    for bs, n, k, m, dens, seed in ((192, 1500, 1400, 1300, 0.15, 20),
                                    (130, 1100, 900, 1000, 0.2, 22),
                                    (10, 300, 250, 310, 0.2, 24)):
        A = BlockSparseMatrix.random((n, k), dens, block_size=bs, mesh=mesh,
                                     seed=seed)
        B = BlockSparseMatrix.random((k, m), dens, block_size=bs, mesh=mesh,
                                     seed=seed + 1)
        sub = 128 if bs >= 128 else 64
        kind = ("rows 16-byte aligned" if bs % 4 == 0
                else "scalar loads, bs % 4 != 0")
        cases.append((f"bs={bs} ragged random, f32 sub-tile {sub} ({kind})",
                      A, B, None))

    def wgmma_coverage(run_of, A, B):
        """What the bf16 wgmma body must get right at this bs: slots of
        several pairs (B4), grouped padding positions (B5) and, where
        the band's own kernel runs, its zero tile (B6)."""
        assert np.diff(run_of("pallas_generic").tables["slot_ptr"]).max() > 1
        t = run_of("pallas_cluster").tables
        assert (t["src"] >= len(t["pa"])).any(), "no padding position"
        band = run_of("pallas_band")
        if band.schedule == "band":
            t = band.tables
            assert ((t["a_idx"] >= A.nnzb).any()
                    or (t["b_idx"] >= B.nnzb).any()), "no zero tile"

    gr = 40
    r, c = band_tiles(gr, range(-2, 3), drop_row=7)
    A = tile_matrix(r, c, (gr * 64, gr * 64), 64, 6, mesh)
    r, c = band_tiles(gr, range(-2, 3))
    perm = np.random.default_rng(7).permutation(len(r))
    B = tile_matrix(r[perm], c[perm], (gr * 64, gr * 64), 64, 7, mesh)

    def band_unsorted(run_of, A=A, B=B):
        assert run_of("pallas_band").schedule == "band"
        assert np.any(np.diff(B.host_tiles()[0]) < 0)
        wgmma_coverage(run_of, A, B)
    cases.append(("bs=64 band, B with unsorted block_rows, A block row 7 "
                  "empty", A, B, band_unsorted))

    gr = 24
    r, c = band_tiles(gr, range(-5, 6))
    A = tile_matrix(r, c, (gr * 128, gr * 128), 128, 8, mesh)
    B = tile_matrix(r, c, (gr * 128, gr * 128), 128, 9, mesh)

    def band_chunked(run_of, A=A, B=B):
        t = run_of("pallas_band").tables
        assert t["nchunks"] > 1 and t["wa"] == 11, (t["nchunks"], t["wa"])
        wgmma_coverage(run_of, A, B)
    cases.append(("bs=128 11-wide band, chunked (rc < rr)", A, B,
                  band_chunked))

    gr = 8
    r, c = band_tiles(gr, range(-2, 3))
    A = tile_matrix(r, c, (gr * 512, gr * 512), 512, 10, mesh)
    B = tile_matrix(r, c, (gr * 512, gr * 512), 512, 11, mesh)

    def band_fallback(run_of, A=A, B=B):
        assert run_of("pallas_band").schedule == "grouped"
        assert len(run_of("pallas_powerlaw").tables["buckets"]) == 2
        wgmma_coverage(run_of, A, B)
    cases.append(("bs=512 band: the grouped fallback (B5, not B6)", A, B,
                  band_fallback))
    return cases


def spgemm_kernel_phase(mesh) -> None:
    """B4–B7 against their plain versions on the card, every kernel id on
    every case, in f32 and bf16, with each call's launches checked
    against what its host tables predict; plus the empty intersection
    (one zero tile, no launch)."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import spgemm as sg
    a = np.zeros((64, 64), np.float32)
    a[:8, :8] = 1.0
    b = np.zeros((64, 64), np.float32)
    b[8:16, :] = 1.0
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    EA, EB = (BlockSparseMatrix.from_numpy(x, block_size=8, mesh=mesh)
              for x in (a, b))
    zero_spgemm_launches()
    empty = sg.apply_dense(EA, EB)
    torch.cuda.synchronize()
    if any(spgemm_launches().values()) or empty.abs().max() != 0:
        raise AssertionError("empty intersection: launched or nonzero")
    log("kernel spgemm: empty intersection -> one zero tile, no launch ok")
    for name, A0, B0, check in spgemm_cases(mesh):
        for dtype_name in ("float32", "bfloat16"):
            A, B = as_dtype(A0, dtype_name), as_dtype(B0, dtype_name)
            runs = {}
            for kid in PALLAS_IDS:
                run, a_m, b_m, n_out = spgemm_runner(A, B, kid)
                runs[kid] = run
                zero_spgemm_launches()
                got = run(a_m, b_m)
                torch.cuda.synchronize()
                launched = spgemm_launches()
                if launched != predicted_launches(run):
                    raise AssertionError(f"{name} {kid}: launches {launched}"
                                         f", want {predicted_launches(run)}")
                check_bodies(f"{name} {dtype_name} {kid}", launched,
                             A.block_size, dtype_name)
                want = spgemm_plain(run, a_m, b_m, n_out)
                err = check_close(f"{name} {dtype_name} {kid}",
                                  got.reshape(-1, got.shape[-1]),
                                  want.reshape(-1, want.shape[-1]),
                                  dtype_name)
                log(f"kernel {SPGEMM_KERNEL_OF[run.schedule]} [{name}] "
                    f"{dtype_name} via {kid} "
                    f"({spgemm_body(A.block_size, dtype_name)} body): "
                    f"n_out={n_out}, max_abs_err={err:.3e} ok")
            if check is not None:
                check(runs.__getitem__)
            if "ragged" in name:
                # the logical product, overhang scrubbed, vs float64
                n, m = A.shape[0], B.shape[1]
                dense = sg.apply_dense(A, B)[:n, :m]
                ref = torch.as_tensor(A.to_numpy().astype(np.float64)
                                      @ B.to_numpy().astype(np.float64),
                                      device=dense.device)
                err = check_close(f"{name} {dtype_name} vs float64",
                                  dense, ref, dtype_name)
                log(f"  logical product vs float64: max_abs_err={err:.3e}")


def spgemm_bound(run, A, B, npairs: int, dtype_name: str):
    """(bound_ms, bound_by): the A and B tiles this pair list touches and
    the output stack once, over HBM bandwidth, vs 2·bs³ per real pair
    over the dtype's peak."""
    import numpy as np
    from matrel_tpu_torch.ops import spgemm as sg
    pa, pb, _, out_rows, _ = sg._pair_structure_cached(A, B)
    bs = A.block_size
    isz = A.blocks.element_size()
    tiles = np.unique(pa).size + np.unique(pb).size + out_rows.size
    t_bytes = tiles * bs * bs * isz / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * npairs * bs ** 3 / PEAK_FLOPS[dtype_name] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def spgemm_pairs_at(mesh, n, random_seeds=(0, 1)):
    """The repo's own S×S deployments at side n, one pair at a time:
    (kernel entry, home kernel id, A, B, dtype name) — 1% random
    512-blocks in bf16 (bench.py measure_spgemm), then the registry's
    structure generators in f32 (measure_sparse_kernels, seeds 0 and 1;
    the band at bs = 128, where its own kernel runs)."""
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.ops import kernel_registry as kr
    A, B = (BlockSparseMatrix.random((n, n), 0.01, block_size=512,
                                     mesh=mesh, seed=s, dtype="bfloat16")
            for s in random_seeds)
    yield "spgemm_pairs", "pallas_generic", A, B, "bfloat16"
    for name, kid, structure, bs in (
            ("spgemm_grouped", "pallas_cluster", "clustered_tile", 512),
            ("spgemm_powerlaw", "pallas_powerlaw", "powerlaw_coo", 512),
            ("spgemm_band", "pallas_band", "row_band", 128)):
        A, B = (kr.synthesize_structure(structure, n, bs, mesh, seed=s)
                for s in (0, 1))
        yield name, kid, A, B, "float32"


def pair_bodies_in_turns(run, a, b, n_out, want) -> None:
    """The bf16 B4 pair list through the WMMA body and the wgmma body in
    turns (the C entry point called with each code), the WMMA body's
    result held against the plain version too; then cuBLAS torch.bmm over
    the same pairs, pre-gathered. The wgmma body must be the faster."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spgemm as ps
    t = run.tables

    def i32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.int32),
                               device=a.device)

    slot_ptr, pa, pb = i32(t["slot_ptr"]), i32(t["pa"]), i32(t["pb"])
    bs = a.shape[1]
    out = torch.empty((n_out, bs, bs), dtype=a.dtype, device=a.device)
    lib = ps._library()

    def launch(code):
        rc = lib.matrel_spgemm_pairs(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), slot_ptr.data_ptr(),
            pa.data_ptr(), pb.data_ptr(), n_out, a.shape[0], b.shape[0], bs,
            code, 1, 1, a.device.index,
            torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise AssertionError(f"S×S pair body code {code}: error {rc}")

    launch(1)
    torch.cuda.synchronize()
    err = check_close("S×S bf16 pairs, WMMA body",
                      out.reshape(-1, bs), want.reshape(-1, bs), "bfloat16")
    log(f"S×S bf16 pairs, WMMA body vs plain max_abs_err {err:.3e}")
    turns = body_turns(f"S×S bf16 pairs ({pa.numel()} pairs)", launch,
                       2.0 * pa.numel() * bs ** 3)
    del out
    bmm_yardstick("S×S bf16 pairs", a.index_select(0, pa.long()),
                  b.index_select(0, pb.long()))
    torch.cuda.empty_cache()
    if max(turns["wgmma"]) > min(turns["wmma"]):
        raise AssertionError(f"S×S bf16 pairs: the wgmma body is slower "
                             f"than the WMMA body: {turns}")


def spgemm_timing(mesh) -> dict:
    """bench.py's S×S sweep at n = 100,352: per pair every admissible
    registry kernel through spgemm_tiles(kernel=…) (CUDA events, median of
    10 samples of 5 calls, so that the host's work a call stays out of a
    short kernel's time), the home kernel's plain version, the bound, and
    the xla_gather torch composite as the library column (no single
    PyTorch call multiplies two block-sparse tile maps); at the bf16 pair
    list the two bf16 bodies in turns (:func:`pair_bodies_in_turns`)."""
    import torch
    from matrel_tpu_torch.ops import spgemm as sg
    rows = {}
    for name, kid, A, B, dtype_name in spgemm_pairs_at(mesh, SPGEMM_N):
        npairs = int(sg._pair_structure_cached(A, B)[0].size)
        run, a_m, b_m, n_out = spgemm_runner(A, B, kid)
        zero_spgemm_launches()
        got = run(a_m, b_m)
        check_bodies(f"{name} n={SPGEMM_N}", spgemm_launches(),
                     A.block_size, dtype_name)
        want = spgemm_plain(run, a_m, b_m, n_out)
        torch.cuda.synchronize()
        err = check_close(f"{name} n={SPGEMM_N}",
                          got.reshape(-1, got.shape[-1]),
                          want.reshape(-1, want.shape[-1]), dtype_name)
        if run.schedule == "pairs" and dtype_name == "bfloat16":
            pair_bodies_in_turns(run, a_m, b_m, n_out, want)
        del got, want
        times = {k: time_ms(lambda k=k: sg.spgemm_tiles(A, B, kernel=k),
                            warmup=2, runs=10, batch=5)
                 for k in ("xla_gather", "pallas_generic", kid)}
        plain_ms = time_ms(lambda: spgemm_plain(run, a_m, b_m, n_out),
                           warmup=1, runs=10)
        bound_ms, bound_by = spgemm_bound(run, A, B, npairs, dtype_name)
        detail = ""
        if run.schedule == "bucketed":
            detail = ", buckets " + " / ".join(
                f"G={bk['group']} over {len(bk['ids'])} slots"
                for bk in run.tables["buckets"])
        elif run.schedule == "band":
            t = run.tables
            detail = f", wa={t['wa']} rc={t['rc']} nchunks={t['nchunks']}"
        elif run.schedule == "grouped":
            detail = f", G={run.tables['group']}"
        log(f"S×S timing {name} ({dtype_name}, bs={A.block_size}, "
            f"nnzb {A.nnzb}/{B.nnzb}, {npairs} pairs, {n_out} out tiles"
            f"{detail}, CTAs a launch "
            f"{launch_ctas(run, n_out, A.block_size, dtype_name)}): "
            + ", ".join(f"{k} {v:.4f} ms" for k, v in times.items())
            + f"; plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); kernel vs plain max_abs_err {err:.3e}; peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
        rows[name] = {"max_abs_err": err, "ms": times[kid],
                      "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by,
                      "library_ms": times["xla_gather"]}
        del A, B, run, a_m, b_m
        torch.cuda.empty_cache()
    return rows


def spgemm_library(mesh, rows: dict) -> None:
    """One PyTorch call beside each of B4–B7: torch.sparse.mm of the two
    operands' element-CSR forms in f32 (cuSPARSE SpGEMM; f32 because its
    bf16 SpGEMM is not offered) at spgemm_timing's shapes, by CUDA
    events. It becomes the row's library_ms; where it runs out of device
    memory or workspace, library_ms is None and ``library_oom`` says at
    which operand sizes and how it failed. The xla_gather composite stays as xla_gather_ms.
    Run after the run's peak is read: cuSPARSE's workspace is not the
    port's memory."""
    import torch
    for name, _kid, A, B, _dtype in spgemm_pairs_at(mesh, SPGEMM_N):
        row = rows[name]
        row.setdefault("xla_gather_ms", row["library_ms"])
        a = b = None
        try:
            a, b = (torch.sparse_csr_tensor(
                c.crow_indices(), c.col_indices(), c.values().float(),
                size=c.shape) for c in (csr_form(A), csr_form(B)))
            del A, B
            c = torch.sparse.mm(a, b)
            nnz_out = int(c._nnz())
            del c
            ms = time_ms(lambda: torch.sparse.mm(a, b), warmup=1, runs=5)
            row["library_ms"] = ms
            row.pop("library_oom", None)
            log(f"library torch.sparse.mm (cuSPARSE SpGEMM, f32 CSR) "
                f"{name} n={SPGEMM_N:,}: {ms:.4f} ms, nnz {a._nnz():,} x "
                f"{b._nnz():,} -> {nnz_out:,}")
        except (torch.OutOfMemoryError, RuntimeError) as ex:
            # cuSPARSE reports a workspace it cannot hold as an error of
            # its own (CUSPARSE_STATUS_INSUFFICIENT_RESOURCES)
            sizes = ("" if a is None else
                     f"operand nnz {a._nnz():,} x {b._nnz():,}, ")
            row["library_ms"] = None
            row["library_oom"] = (f"{sizes}{type(ex).__name__}: "
                                  f"{str(ex).splitlines()[0][:200]}")
            log(f"library torch.sparse.mm {name} n={SPGEMM_N:,}: "
                f"{row['library_oom']}")
        finally:
            del a, b
            torch.cuda.empty_cache()


def sampled_tiles_err(name, A, B, dense, dtype_name, rnd) -> float:
    """Max abs error of 8 random output tiles of the dense product A·B
    against a float64 numpy sum over their pairs (tolerance TOL)."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import spgemm as sg
    pa, pb, slot, out_rows, out_cols = sg._pair_structure_cached(A, B)
    a_m = sg._edge_masked(A).float().cpu().numpy()
    b_m = sg._edge_masked(B).float().cpu().numpy()
    bs = A.block_size
    err = 0.0
    for s in rnd.choice(out_rows.size, size=min(8, out_rows.size),
                        replace=False):
        sel = slot == s
        want = sum(a_m[i].astype(np.float64) @ b_m[j].astype(np.float64)
                   for i, j in zip(pa[sel], pb[sel]))
        r, c = int(out_rows[s]), int(out_cols[s])
        got = dense[r * bs:(r + 1) * bs, c * bs:(c + 1) * bs]
        err = max(err, check_close(f"{name} tile ({r}, {c}) vs float64",
                                   got, torch.as_tensor(want,
                                                        device=got.device),
                                   dtype_name))
    return err


def path_spgemm(sess) -> tuple:
    """The four S×S queries through MatrelSession().compute at n =
    32,768: the stamp, the launch counts the host tables predict, the
    dense result against a use_pallas=False session (the xla_gather
    route) and 8 sampled output tiles against float64 numpy."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.ops import spgemm as sg
    plain_sess = MatrelSession(config=MatrelConfig(use_pallas=False),
                               device=sess.device)
    launches = dict.fromkeys(SPGEMM_REPLACES, 0)
    queries = {}
    rnd = np.random.default_rng(12)
    # bench.py's comparison seeds for the random pair
    for name, kid, A, B, dtype_name in spgemm_pairs_at(
            sess.mesh, SPGEMM_CMP_N, random_seeds=(2, 3)):
        e = A.multiply(B)
        stamp = sess.compile(e).optimized.attrs.get("spgemm_kernel")
        if stamp != kid:
            raise AssertionError(f"S×S {name}: stamped {stamp}, want {kid}")
        run, _, _, n_out = spgemm_runner(A, B, kid)
        want_launches = predicted_launches(run)
        zero_spgemm_launches()
        Y = sess.compute(e)
        torch.cuda.synchronize()
        peaks = [torch.cuda.max_memory_allocated()]
        got_launches = spgemm_launches()
        if got_launches != want_launches:
            raise AssertionError(f"S×S {name}: launches {got_launches}, "
                                 f"want {want_launches}")
        check_bodies(f"S×S {name}", got_launches, A.block_size, dtype_name)
        for k, v in got_launches.items():
            launches[k] += v
        n = A.shape[0]
        if Y.shape != (n, n) or Y.data.dtype != getattr(torch, dtype_name):
            raise AssertionError(f"S×S {name}: result {Y.shape} "
                                 f"{Y.data.dtype}")
        ref = plain_sess.compute(e)
        peaks.append(torch.cuda.max_memory_allocated())
        # slabs of 2048 rows keep the compare's f32 temporaries at ~1 GiB
        err = check_close(f"S×S {name} vs the xla_gather route", Y.data,
                          ref.data, dtype_name, rows_per_step=2048)
        peaks.append(torch.cuda.max_memory_allocated())
        del ref
        e64 = sampled_tiles_err(f"S×S {name}", A, B, Y.data, dtype_name,
                                rnd)
        log(f"path S×S {name}: compute(A·B) n={n} {dtype_name} "
            f"bs={A.block_size}, {n_out} output tiles, CTAs a launch "
            f"{launch_ctas(run, n_out, A.block_size, dtype_name)} (132 "
            f"SMs), stamp {stamp}, launches {got_launches} "
            f"({spgemm_body(A.block_size, dtype_name)} body), max_abs_err "
            f"{err:.3e} vs the xla_gather route, {e64:.3e} vs float64 on 8 "
            f"tiles; peak after compute / twin / compare "
            + " / ".join(f"{p / 2**30:.3f}" for p in peaks) + " GiB")
        del Y
        queries[f"S×S {name} ({kid})"] = e
        torch.cuda.empty_cache()
    return launches, queries


def path_latency(sess, queries: dict) -> dict:
    """Warm compute() latency of each path query (plan cached): CUDA
    events around the whole call, median of 10 (host planning and
    launch gaps included); then where the device time of each goes,
    from torch.profiler over 5 warm calls. Returns {name: ms}."""
    out = {}
    for name, e in queries.items():
        ms = time_ms(lambda: sess.compute(e), warmup=2, runs=10)
        log(f"latency {name}: {ms:.4f} ms per warm compute()")
        device_split(lambda: sess.compute(e))
        out[name] = ms
    return out


#: how long device_split's discarded warm-up step runs its function
PROFILER_WARMUP_S = 0.3


def device_split(fn, calls: int = 5, top: int = 5) -> float:
    """Device ms per call of ``fn`` from torch.profiler over ``calls``
    warm calls, logged with its ``top`` kernels (ms a call and launches
    a call); returns the total. A warm-up step of calls for at least
    ``PROFILER_WARMUP_S`` comes first and is discarded: the trace starts
    some time after the profiler does, and a shorter warm-up lost the
    first calls' kernels of a sub-ms query. Each call is synchronised
    inside its step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=calls,
                                   repeat=1)) as prof:
        t_end = time.perf_counter() + PROFILER_WARMUP_S
        while True:
            fn()
            torch.cuda.synchronize()
            if time.perf_counter() >= t_end:
                break
        prof.step()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
            prof.step()
    rows = []
    for ev in prof.key_averages():
        # device-side events only: a CPU op such as aten::mm also
        # carries the time of the kernels it launched, and the step
        # annotation that of its whole step, as the executor's
        # matrel.<label> ranges do that of their operator's kernels
        if ("CUDA" not in str(getattr(ev, "device_type", ""))
                or ev.key.startswith(("ProfilerStep", "matrel."))):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / calls / 1e3, ev.count / calls, ev.key))
    rows.sort(reverse=True)
    total = sum(r[0] for r in rows)
    log(f"  device time per call {total:.4f} ms"
        + ("" if rows else " (the profiler saw no device time)"))
    for t, n, key in rows[:top]:
        log(f"    {t:.4f} ms  x{n:g}  {key[:90]}")
    return total


# -- the rest of the core surface: run_many, vec, rank1 ---------------------


def multi_plans(sess) -> int:
    return sum(1 for k in sess._plan_cache if k.startswith("multi:"))


#: the reshard budget rows 1 and 2 are planned under on the virtual (2, 4)
#: grid in path_core_surface (any budget > 0 compiles the staged plans)
CORE_RESHARD_BUDGET = 64 << 20
CORE_EYE_N = 16384


def core_leftovers(sess, S) -> dict:
    """session.zeros and eye at 16,384 (eye·A bit-equal to A), and row
    4's S rebuilt twice — BlockMatrix.from_block_fn over its tile grid
    (the occupancy) and BlockSparseMatrix.from_scipy of its entries —
    each holding S's tiles."""
    import numpy as np
    import scipy.sparse as sps
    import torch
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    dev, n = sess.device, CORE_EYE_N
    Z, I = sess.zeros((n, n)), sess.eye(n)
    if (bool(Z.data.any()) or I.nnz != n or float(I.data.sum()) != n
            or not bool((torch.diagonal(I.data) == 1).all())):
        raise AssertionError("zeros/eye: wrong entries")
    A = sess.random((n, n), seed=33)
    Y, eye_s = synced(lambda: sess.compute(I.multiply(A)))
    if not torch.equal(Y.data, A.data):
        raise AssertionError("eye·A differs from A")
    del Z, I, A, Y
    gr, gc = S.grid
    rows, cols = S.host_tiles()
    occ = torch.zeros((gr, gc), dtype=torch.bool, device=dev)
    occ[S.block_rows.long(), S.block_cols.long()] = True
    M = BlockMatrix.from_block_fn((gr, gc),
                                  lambda r, c: occ[r.long(), c.long()],
                                  mesh=sess.mesh)
    nz = torch.nonzero(M.data).cpu().numpy()
    if not (np.array_equal(nz[:, 0], rows) and np.array_equal(nz[:, 1], cols)):
        raise AssertionError("from_block_fn: the occupancy differs from S's "
                             "tiles")
    bs = S.block_size
    vals = S.blocks.float().cpu().numpy()
    ii = np.arange(bs, dtype=np.int64)
    r_idx = np.broadcast_to(rows[:, None, None] * bs + ii[None, :, None],
                            vals.shape)
    c_idx = np.broadcast_to(cols[:, None, None] * bs + ii[None, None, :],
                            vals.shape)
    sp = sps.coo_matrix((vals.ravel(), (r_idx.ravel(), c_idx.ravel())),
                        shape=S.shape)
    del vals, r_idx, c_idx
    T, scipy_s = synced(lambda: BlockSparseMatrix.from_scipy(
        sp, block_size=bs, mesh=sess.mesh, dtype="bfloat16"))
    t_rows, t_cols = T.host_tiles()
    if not (np.array_equal(t_rows, rows) and np.array_equal(t_cols, cols)
            and torch.equal(T.blocks, S.blocks)):
        raise AssertionError("from_scipy: tiles differ from S's")
    log(f"path core surface: zeros/eye {n}², eye·A bit-equal to A "
        f"({eye_s:.3f} s); row 4's S ({S.nnzb} tiles of {bs}²): "
        f"from_block_fn over its {gr} x {gc} tile grid holds its tiles, "
        f"from_scipy of its {sp.nnz} entries holds its tiles bit for bit "
        f"({scipy_s:.2f} s host bucketing)")
    return {"eye_s": eye_s, "from_scipy_s": scipy_s}


def reshard_rows(dev) -> dict:
    """Rows 1 and 2 planned on the virtual (2, 4) grid with
    reshard_peak_budget_bytes > 0: strategies and staged-move records
    printed, the root re-lay plans printed, results bit-equal to the
    same grid at budget 0 (on one card every staged step is a local
    copy)."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession, executor
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch.parallel import reshard
    from matrel_tpu_torch.workloads import chain_bench
    mesh = make_mesh((2, 4), device=dev)
    cfg = MatrelConfig(reshard_peak_budget_bytes=CORE_RESHARD_BUDGET)
    s0 = MatrelSession(mesh=mesh)
    sb = MatrelSession(mesh=mesh, config=cfg)
    X, Y = s0.random((4096, 4096), seed=4), s0.random((4096, 4096), seed=5)
    mats = chain_bench.skewed_abc(mesh, n=10_000, mid=100, seed=3)
    out, moves = {}, 0
    for name, e in (("row 1", X.multiply(Y)),
                    ("row 2", chain_bench.build_chain(mats))):
        plan = sb.compile(e)
        recs = executor.plan_matmul_decisions(plan)
        relay = reshard.root_relay_plan(plan.optimized, mesh, cfg)
        y0, yb = s0.compute(e), sb.compute(e)
        if not torch.equal(y0.data, yb.data):
            raise AssertionError(f"reshard {name}: budgeted result differs "
                                 f"from budget 0")
        moves += sum(len(r["reshard"]["moves"]) for r in recs
                     if "reshard" in r) + (relay is not None)
        out[name] = {"strategies": [r["strategy"] for r in recs],
                     "reshard": [r.get("reshard") for r in recs],
                     "root_relay": relay.to_dict() if relay else None}
        log(f"path core surface, {name} on the (2, 4) grid under a "
            f"{CORE_RESHARD_BUDGET >> 20} MiB reshard budget: strategies "
            f"{out[name]['strategies']}, staged moves "
            f"{json.dumps(out[name]['reshard'])}, root re-lay "
            f"{json.dumps(out[name]['root_relay'])}; result bit-equal to "
            f"budget 0")
    if moves < 1:
        raise AssertionError("reshard rows: no staged move was planned")
    return out


def path_core_surface(sess, queries: dict) -> dict:
    """``run_many`` over one batch of row 4's S·D (B1), row 5's A·x on
    the cached COO A (B2), row 2's chain and a duplicate of S·D: one
    MultiPlan compile, a cache hit on the reordered batch, each result
    equal to its own ``compute``, and B1 and B2 launched from inside the
    batch (the caller reads nothing else in between). Then one ``vec``
    and one ``rank1`` query against numpy."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spmm, pallas_spmv as pc
    names = ("row4 S·D", "row5 A·x", "row2 A·B·C")
    batch = [queries[k] for k in names]
    S, D = (c.attrs["matrix"] for c in batch[0].children)
    batch.append(S.multiply(D))                # the duplicate root
    pallas_spmm.LAUNCHES = pc.LAUNCHES_SPMV = 0
    bodies0 = dict(pallas_spmm.BODY_LAUNCHES)
    multi0 = multi_plans(sess)
    t0 = time.perf_counter()
    outs = sess.run_many(batch)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"spmm_blocksparse": pallas_spmm.LAUNCHES,
                "spmv_compact": pc.LAUNCHES_SPMV}
    bodies = {b: v - bodies0[b] for b, v in
              pallas_spmm.BODY_LAUNCHES.items() if v != bodies0[b]}
    if multi_plans(sess) != multi0 + 1:
        raise AssertionError(f"run_many: {multi_plans(sess) - multi0} "
                             f"MultiPlan compiles, want 1")
    if min(launches.values()) < 1:
        raise AssertionError(f"run_many: kernel launches {launches}, want "
                             f"B1 and B2 from inside the batch")
    if outs[3] is not outs[0]:
        raise AssertionError("run_many: the duplicate root was not "
                             "deduplicated")
    rev = sess.run_many(list(reversed(batch)))
    torch.cuda.synchronize()
    if multi_plans(sess) != multi0 + 1:
        raise AssertionError("run_many: the reordered batch recompiled")
    for name, e, out, back in zip(names, batch, outs, reversed(rev)):
        single = sess.compute(e)
        if not (torch.equal(out.data, single.data)
                and torch.equal(back.data, single.data)):
            err = float((out.data.float() - single.data.float()).abs().max())
            raise AssertionError(f"run_many {name}: differs from its own "
                                 f"compute(), max abs {err}")
    ms = time_ms(lambda: sess.run_many(batch), warmup=2, runs=10)
    del outs, rev
    X = sess.random((1000, 300), seed=8)
    v = sess.compute(X.expr().vec()).to_numpy()
    x = X.to_numpy()
    if v.shape != (300_000, 1) or not np.array_equal(v[:, 0],
                                                     x.T.reshape(-1)):
        raise AssertionError("vec: differs from numpy's column-major vec")
    u, w = sess.random((1000, 1), seed=9), sess.random((300, 1), seed=10)
    e = X.expr().rank_one_update(u, w)
    if sess.compile(e).optimized.kind != "rank1":
        raise AssertionError("rank1: the plan's root is not rank1")
    r = sess.compute(e).to_numpy()
    want = x.astype(np.float64) + (u.to_numpy().astype(np.float64)
                                   @ w.to_numpy().astype(np.float64).T)
    rel = float(np.abs(r - want).max() / np.abs(want).max())
    if r.shape != want.shape or not np.isfinite(r).all() or rel > 1e-6:
        raise AssertionError(f"rank1: rel err {rel} vs float64")
    log(f"path core surface: run_many over {', '.join(names)} and a "
        f"duplicate: one MultiPlan, B1 {launches['spmm_blocksparse']} / B2 "
        f"{launches['spmv_compact']} launches inside the batch, first call "
        f"{first_s:.3f} s, warm {ms:.4f} ms a batch, reordered batch a "
        f"cache hit, each result bit-equal to its own compute(); vec "
        f"(1000 x 300) equal to numpy, rank1 rel err {rel:.3e} vs float64")
    core_leftovers(sess, S)
    reshard_rows(sess.device)
    return dict(launches, spmm_bodies=bodies)


def dp_timing(dev) -> dict:
    """Host ms of one chain DP (``ir/chain.optimal_order``), native
    (``utils/native.py``) against the Python DP, on the plan-snapshot
    corpus's three chains (tools/plan_snapshot.py: skewed, the
    col-sharded middle operand, the row-sharded first operand) on the
    (2, 4) planning grid, and on a 30-operand chain on one card; median
    of 20 calls each. Both DPs must reach the same cost (dense chains:
    no density estimate to round)."""
    import numpy as np
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.core.mesh import P, make_mesh
    from matrel_tpu_torch.ir import chain
    from matrel_tpu_torch.ir.expr import leaf
    from matrel_tpu_torch.utils import native
    if native.load() is None:
        raise AssertionError("the native chain DP did not build")
    grid = make_mesh((2, 4), device=dev)
    one = make_mesh(device=dev)
    xy = ("x", "y")

    def ops(mesh, dims, specs=None):
        specs = specs or [None] * (len(dims) - 1)
        return [leaf(BlockMatrix.from_numpy(
            np.zeros((dims[i], dims[i + 1]), np.float32), mesh=mesh,
            spec=specs[i])) for i in range(len(dims) - 1)]

    rng = np.random.default_rng(1)
    cases = {
        "chain_skewed": (ops(grid, [2048, 64, 2048, 64]), grid),
        "chain_layout_flip": (ops(grid, [16, 512, 512, 16],
                                  [None, P(None, xy), None]), grid),
        "chain_interior_credit": (ops(grid, [1600, 512, 512, 512],
                                      [P(xy, None), None, None]), grid),
        "30 operands": (ops(one, [int(d) for d in
                                  rng.integers(10, 2000, 31)]), one),
    }
    out = {}
    keep = native.chain_dp
    for name, (chain_ops, mesh) in cases.items():
        def run():
            return chain.optimal_order(chain_ops, grid=mesh.grid, mesh=mesh)

        times = {}
        for label in ("native", "python"):
            native.chain_dp = keep if label == "native" else (
                lambda *a, **k: None)
            try:
                cost = run()[1]
                samples = []
                for _ in range(20):
                    t0 = time.perf_counter()
                    run()
                    samples.append(time.perf_counter() - t0)
            finally:
                native.chain_dp = keep
            times[label] = (statistics.median(samples) * 1e3, cost)
        if times["native"][1] != times["python"][1]:
            raise AssertionError(f"chain DP {name}: native cost "
                                 f"{times['native'][1]} vs Python "
                                 f"{times['python'][1]}")
        out[name] = {k: v[0] for k, v in times.items()}
    log("chain DP host ms per optimal_order, native / Python: "
        + "; ".join(f"{k} {v['native']:.4f} / {v['python']:.4f}"
                    for k, v in out.items()))
    return out


# -- the north-star 65k chain (workloads/big_chain.py) -----------------------

#: bench_all.py bench_north_star's sizes: n, tile, panel.
NS_N, NS_TILE, NS_PANEL = 65_536, 8192, 16_384
#: The first correctness check's sizes (both schedules against float64).
NS_CHECK_N, NS_CHECK_TILE, NS_CHECK_PANEL = 8192, 1024, 2048


def ns_fro_rtol(k_first: int, k_second: int) -> float:
    """Relative bound on how far the chain's Frobenius² may move from
    the exactly accumulated value, on the model that the tensor cores'
    f32 accumulator rounds toward zero at each 16-deep k-step (what the
    sign and size of the measured drift show, PERF.md section 6): each
    step loses at most one f32 ulp (2^-23 relative) of a running sum no
    larger than the result, so a K-long product may shrink by
    K / 16 · 2^-23; the second product carries the first's loss, and
    squaring doubles both."""
    return 2.0 * (k_first + k_second) / 16 * 2.0 ** -23


#: A schedule at n = 8192 against the float64 oracle (T rounded to bf16
#: as the body rounds it): the slab's two 8192-long products, 2.4e-4.
NS_ORACLE_RTOL = ns_fro_rtol(NS_CHECK_N, NS_CHECK_N)
#: The two schedules against each other at n = 65,536: the slab's two
#: 65,536-long products plus the tile-assembly's 8192-long ones, 2.2e-3.
NS_SCHEDULE_RTOL = ns_fro_rtol(NS_N, NS_N) + ns_fro_rtol(NS_TILE, NS_TILE)
#: The north-star phase's own peak-memory bound, over what earlier phases
#: still hold: 1.25 × the measured 11.000 GiB, the tile-assembly
#: schedule's T·C step (PERF.md section 6 gives the reckoning).
NS_PEAK_LIMIT_BYTES = int(13.75 * 2**30)


def north_star_gens(tile: int, dev):
    """bench_all.py's operands: bf16 cheap_gen, seeds 1, 2, 3."""
    from matrel_tpu_torch.workloads import big_chain
    return tuple(big_chain.cheap_gen(s, tile, device=dev) for s in (1, 2, 3))


def north_star_oracle(n: int, tile: int, dev) -> float:
    """float64 Frobenius² of (A·B)·C on the card, with T = A·B rounded
    to f32 and then to bf16, as the slab body rounds its f32 product."""
    import torch
    A, B, C = (g.slab(0, 0, (n, n)) for g in north_star_gens(tile, dev))
    T = (A.double() @ B.double()).float().to(torch.bfloat16)
    del A, B
    O = T.double() @ C.double()
    return float((O * O).sum())


def north_star_split(prof, n_panels: int, kt: int) -> dict:
    """Device ms of one profiled run by stage: the A·B GEMMs, the T·C
    GEMMs (the first kt and the last kt ``aten::mm`` calls of each
    panel), the Frobenius reduction, and generation (every other
    top-level op: the slab generators and their bf16 casts); plus the
    copy kernels launched from inside a GEMM call (a strided ``out=``
    that cuBLAS could not write in place would show here)."""
    split = {"gemm_ab": 0.0, "gemm_tc": 0.0, "reduce": 0.0, "gen": 0.0}
    inner_copies = 0
    mm_seen = 0

    def walk_copies(ev) -> int:
        own = sum(1 for k in ev.kernels if "copy" in k.name.lower())
        return own + sum(walk_copies(c) for c in ev.cpu_children)

    tops = sorted((ev for ev in prof.events()
                   if ev.cpu_parent is None
                   and "CPU" in str(getattr(ev, "device_type", ""))),
                  key=lambda ev: ev.time_range.start)
    for ev in tops:
        ms = ev.device_time_total / 1e3
        if ev.name == "aten::mm":
            stage = "gemm_ab" if (mm_seen % (2 * kt)) < kt else "gemm_tc"
            mm_seen += 1
            inner_copies += walk_copies(ev)
        elif ev.name in ("aten::sum", "aten::square_"):
            stage = "reduce"
        else:
            stage = "gen"
        split[stage] += ms
    if mm_seen != 2 * kt * n_panels:
        raise AssertionError(f"north star profile: {mm_seen} aten::mm "
                             f"calls, want {2 * kt * n_panels}")
    split["inner_copies"] = inner_copies
    return split


def path_north_star(dev) -> dict:
    """The north-star 65k chain through workloads/big_chain.py: both
    schedules at n = 8192 against a float64 oracle; then
    streaming_chain_slab at bench_all.py's sizes (one warm run, two timed
    runs, host clock around synchronised runs), one profiled run for the
    stage split, and streaming_chain (the tile-assembly schedule) on the
    same generators against it. Holds its own peak device memory under
    NS_PEAK_LIMIT_BYTES."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from matrel_tpu_torch.workloads import big_chain
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()      # what earlier phases hold
    n, tile, panel = NS_CHECK_N, NS_CHECK_TILE, NS_CHECK_PANEL
    oracle = north_star_oracle(n, tile, dev)
    gens = north_star_gens(tile, dev)
    small = {"slab": float(big_chain.streaming_chain_slab(
                 n, *gens, tile=tile, panel=panel)),
             "tile-assembly": float(big_chain.streaming_chain(
                 n, *gens, tile=tile, panel=panel))}
    small_rel = {k: abs(v - oracle) / abs(oracle) for k, v in small.items()}
    for k, rel in small_rel.items():
        if not math.isfinite(small[k]) or rel > NS_ORACLE_RTOL:
            raise AssertionError(f"north star n={n} {k}: {small[k]!r} vs "
                                 f"float64 {oracle!r}, rel {rel:.3e} > "
                                 f"{NS_ORACLE_RTOL}")
    log(f"north star n={n:,} (tile {tile}, panel {panel}): Frobenius² "
        f"float64 {oracle:.9e}; slab rel {small_rel['slab']:.3e}, "
        f"tile-assembly rel {small_rel['tile-assembly']:.3e}")

    n, tile, panel = NS_N, NS_TILE, NS_PANEL
    gens = north_star_gens(tile, dev)

    def run():
        return big_chain.streaming_chain_slab(n, *gens, tile=tile,
                                              panel=panel)

    warm = float(run())
    secs, vals = [], []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        vals.append(float(run()))          # float() waits for the card
        secs.append(time.perf_counter() - t0)
    if not all(math.isfinite(v) and v == warm for v in vals):
        raise AssertionError(f"north star: runs gave {warm!r}, {vals}")
    flops = big_chain.north_star_flops(n)
    s_best = min(secs)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    split = north_star_split(prof, n // panel, n // tile)
    busy = sum(split[k] for k in ("gemm_ab", "gemm_tc", "reduce", "gen"))
    if busy <= 0.0:
        raise AssertionError("north star: the profiler saw no device time")
    if split["inner_copies"]:
        raise AssertionError(f"north star: {split['inner_copies']} copy "
                             f"kernels inside the GEMM calls")
    t0 = time.perf_counter()
    accum = float(big_chain.streaming_chain(n, *gens, tile=tile,
                                            panel=panel))
    accum_s = time.perf_counter() - t0
    rel = abs(accum - warm) / abs(warm)
    if not math.isfinite(accum) or rel > NS_SCHEDULE_RTOL:
        raise AssertionError(f"north star: slab {warm!r} vs tile-assembly "
                             f"{accum!r}, rel {rel:.3e} > {NS_SCHEDULE_RTOL}")
    peak = torch.cuda.max_memory_allocated() - base
    gemm_flops = flops / 2
    log(f"path north star: streaming_chain_slab n={n:,} tile {tile} panel "
        f"{panel} bf16 cheap_gen(1, 2, 3) 'fro': "
        + ", ".join(f"{s:.4f}" for s in secs)
        + f" s ({flops / s_best / 1e12:.1f} TFLOP/s against 4n³ = "
        f"{flops:.4e}; bound {flops / PEAK_FLOPS['bfloat16']:.3f} s at "
        f"989 TFLOP/s); Frobenius² {warm:.9e}; {device_line()}")
    log(f"  profiled run, device ms: A·B GEMMs {split['gemm_ab']:.1f} "
        f"({gemm_flops / split['gemm_ab'] / 1e9:.1f} TFLOP/s), T·C GEMMs "
        f"{split['gemm_tc']:.1f} ({gemm_flops / split['gemm_tc'] / 1e9:.1f}"
        f" TFLOP/s), generation {split['gen']:.1f} "
        f"({split['gen'] / busy:.1%} of device time), reduction "
        f"{split['reduce']:.1f}; device busy {busy:.1f} ms; 0 copy kernels "
        f"inside the GEMM calls")
    log(f"  tile-assembly schedule (streaming_chain) {accum_s:.3f} s, "
        f"Frobenius² {accum:.9e}, rel {rel:.3e} against the slab; the "
        f"phase's peak device memory {peak / 2**30:.3f} GiB over the "
        f"{base / 2**30:.3f} GiB earlier phases hold")
    if peak > NS_PEAK_LIMIT_BYTES:
        raise AssertionError(f"north star peak device memory "
                             f"{peak / 2**30:.3f} GiB > "
                             f"{NS_PEAK_LIMIT_BYTES / 2**30:.2f} GiB")
    return {"s": secs, "tflops": flops / s_best / 1e12, "split": split,
            "peak_gib": peak / 2**30, "accum_s": accum_s, "rel": rel,
            "small_rel": small_rel, "fro": warm}


# -- the relational and SQL surface -------------------------------------------

# Value joins: A, B dense REL_VJ_N² f32 (2^26 entries each at 8192), drawn
# as round(64·x)/64 of a standard normal, so values repeat and "eq"
# matches; REL_VJ_SAMPLES query entries per aggregate are held against a
# float64 enumeration over the whole other side.
REL_VJ_N, REL_VJ_SAMPLES = 8192, 48
REL_VJ_PREDS = ("eq", "lt", "ge")
REL_VJ_MERGES = ("mul", "add", "right")
# the black-box (callable) join at join_bruteforce_max_pairs: 2^14 × 2^14
REL_BB_N = 128
# selections / index join: 16,384² f32 operands, times a 16,384 × 512
# matrix; the row join L 8192 × 64 ⋈ R 8192 × 128 (2^26 entries, at the
# cap) times 8192 × 256
REL_SEL_N, REL_SEL_K = 16384, 512
REL_JR_N, REL_JR_L, REL_JR_R, REL_JR_K = 8192, 64, 128, 256
# SQL triangles over bench_all.py's adjacency (8192², 1%, seed 2)
REL_TRI_N, REL_TRI_P = 8192, 0.01
# block-sparse triangles: block-diagonal communities of REL_BS nodes
REL_BS_N, REL_BS, REL_BS_P = 32768, 512, 0.05
# cosine similarity of X REL_SIM_N × REL_SIM_D, clustered so that
# σ(v > 0.9) keeps pairs
REL_SIM_N, REL_SIM_D, REL_SIM_CLUSTERS = 16384, 1024, 256
REL_IO_N = 16384
REL_ROWS_CHECKED = 16
# Each sub-phase's own peak device memory (PeakMeter: over what was
# allocated when it started, its checks' own tensors left out) is held
# under its bound: 1.25 × its peak on an H100 (PERF.md section 5).
REL_PEAK_LIMIT_GIB = {k: 1.25 * v for k, v in {
    "value_join": 8.063, "blackbox": 0.055, "selections": 4.319,
    "sql": 0.750, "triangles_bs": 16.063, "similarity": 6.382,
    "coo": 0.404, "io": 3.000}.items()}

# An f32 product's entry against float64. Under the probabilistic model
# of rounding (independent, mean-zero errors of at most U32; Higham and
# Mary, SIAM J. Sci. Comput. 2019) a sum of K terms t_k of random sign
# errs by more than PROD_C·U32·√K·‖t‖₂ with probability at most about
# 2·exp(-PROD_C²/2), in any order of summation. The worst case,
# K·U32·Σ|t|, also lets a TF32 or a bf16 product through; this bound
# does not (lower_precision_ratios).
PROD_C = 8.0


def product_tol(x64, w64):
    """PROD_C·U32·√K·‖t‖₂ for every entry of x·w (t_k = x_ik·w_kj)."""
    return (PROD_C * U32 * math.sqrt(x64.shape[1])
            * ((x64 * x64) @ (w64 * w64)).sqrt())


class PeakMeter:
    """A relational sub-phase's own peak device memory: the most
    allocated over what was allocated when it started. Work inside
    ``aside()`` (a check's own tensors) is left out; what it keeps
    counts from then on."""

    def __init__(self, name: str, limits=None):
        import gc
        import torch
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        self.name, self.peak = name, 0
        self.limits = REL_PEAK_LIMIT_GIB if limits is None else limits
        self.base = torch.cuda.memory_allocated()

    def _read(self) -> None:
        import torch
        torch.cuda.synchronize()
        self.peak = max(self.peak,
                        torch.cuda.max_memory_allocated() - self.base)

    @contextlib.contextmanager
    def aside(self):
        import torch
        self._read()
        yield
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()

    def gib(self) -> float:
        """The peak so far in GiB, held under the sub-phase's bound."""
        self._read()
        limit = self.limits[self.name]
        if self.peak > limit * 2**30:
            raise AssertionError(f"{self.name}: peak device memory "
                                 f"{self.peak / 2**30:.3f} GiB > "
                                 f"{limit:.3f} GiB")
        return self.peak / 2**30


def synced(fn):
    """(result, seconds): host clock around fn and a synchronise."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def dense_leaf(sess, data):
    """A BlockMatrix over a tensor already on the card (no padding: the
    shapes here divide the 1x1 grid)."""
    from matrel_tpu_torch.core import padding
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    return BlockMatrix.from_array(
        data, tuple(data.shape), sess.mesh,
        padding.canonical_spec(tuple(data.shape), sess.mesh))


def need_launches(name: str, got: int) -> int:
    if got < 1:
        raise AssertionError(f"{name}: the kernel was not launched")
    return got


_VJ_PRED = {"eq": lambda x, y: x == y, "lt": lambda x, y: x < y,
            "ge": lambda x, y: x >= y}
_VJ_MERGE = {"mul": lambda x, y: x * y, "add": lambda x, y: x + y,
             "right": lambda x, y: y + 0.0 * x}


def vj_reference(q, other, pred, merge, axis):
    """float64 stats of one pair-matrix row (axis "row": query an A
    entry against all of B) or column ("col": a B entry against all of
    A), enumerated over the whole other side: sum, nonzero count, max,
    min of the row with its unmatched zeros, and Σ|merged| over the
    matches."""
    import torch
    x, y = (q, other) if axis == "row" else (other, q)
    p = torch.where(_VJ_PRED[pred](x, y), _VJ_MERGE[merge](x, y), 0.0)
    return (float(p.sum()), int((p != 0).sum()), float(p.max()),
            float(p.min()), float(p.abs().sum()))


def vj_grid_reference(va, vb, pred, merge):
    """float64 "all" aggregates over distinct values with multiplicities
    (torch.unique, sort-based): the whole pair relation of 2^52 pairs
    as a grid of distinct A values × distinct B values, weighted by
    their counts."""
    import torch
    ua, ca = torch.unique(va, return_counts=True)
    ub, cb = torch.unique(vb, return_counts=True)
    u, w = ua.double()[:, None], ub.double()[None, :]
    weight = ca.double()[:, None] * cb.double()[None, :]
    p = torch.where(_VJ_PRED[pred](u, w), _VJ_MERGE[merge](u, w), 0.0)
    s = float((p * weight).sum())
    c = int(((p != 0).double() * weight).sum())
    return {"sum": s, "count": c, "avg": s / c if c else 0.0,
            "max": float(p.max()), "min": float(p.min()),
            "abs": float((p.abs() * weight).sum())}


def vj_tol(kind: str, want: float, count: int, prefix_err: float,
           reduce_err: float = 0.0) -> float:
    """The derived error bound of one streamed result (value_join.py):
    the float64 prefix-table part (``prefix_err``: n·2^-53 per prefix,
    times Σ|sv - mean| of the sorted side, twice for a range, times the
    query's |va| for "mul"), the float64 reduction of an "all" axis
    (``reduce_err``), and one f32 rounding of the result. Counts are
    exact integers until that rounding; max/min are one f32 operation
    on exact values."""
    if kind in ("count", "max", "min"):
        return U32 * abs(want)
    if kind == "sum":
        return U32 * abs(want) + prefix_err + reduce_err
    return U32 * abs(want) + (prefix_err + reduce_err) / max(count, 1)


def rel_value_join(dev) -> dict:
    """agg(join_on_values(A, B, merge, pred)) for every pred × merge ×
    kind × axis over A, B of REL_VJ_N² entries (2^26 × 2^26 logical
    pairs, never materialised): every aggregate runs first, keeping its
    sampled entries, and its peak is read before the float64 oracles
    exist; then each result is checked. Then one black-box join at
    join_bruteforce_max_pairs on the chunked path."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.relational import ops as R
    meter = PeakMeter("value_join")
    sess = MatrelSession(device=dev)
    n = REL_VJ_N
    g = torch.Generator(device=dev).manual_seed(21)
    a = torch.randn(n, n, generator=g, device=dev).mul_(64).round_().div_(64)
    b = torch.randn(n, n, generator=g, device=dev).mul_(64).round_().div_(64)
    A, B = dense_leaf(sess, a), dense_leaf(sess, b)
    rng = torch.Generator(device="cpu").manual_seed(5)
    picks = {}
    with meter.aside():
        for axis, m in (("row", a), ("col", b)):
            v = m.T.reshape(-1)                 # the pair coordinates
            special = [int(v.argmax()), int(v.argmin()),
                       int((v == 0).nonzero()[0]), int(v.sort().indices[
                           v.numel() // 2])]
            rand = torch.randint(0, v.numel(),
                                 (REL_VJ_SAMPLES - len(special),),
                                 generator=rng).tolist()
            picks[axis] = torch.tensor(special + rand, device=dev)
            del v
    got, times = {}, {}
    for pred in REL_VJ_PREDS:
        for merge in REL_VJ_MERGES:
            j = R.join_on_values(A, B, merge, pred)
            for axis in ("row", "col", "all"):
                for kind in ("sum", "count", "avg", "max", "min"):
                    out, s = synced(lambda: sess.compute(
                        R.aggregate(j, kind, axis)))
                    times.setdefault(axis, []).append(s)
                    if axis == "all":
                        got[pred, merge, axis, kind] = [
                            float(out.data[0, 0])]
                        continue
                    flat = out.data[:, 0] if axis == "row" else out.data[0]
                    if flat.shape[0] != n * n or \
                            out.data.dtype != torch.float32:
                        raise AssertionError(
                            f"value join {pred}/{merge}/{kind}/{axis}: "
                            f"{tuple(out.data.shape)} {out.data.dtype}")
                    got[pred, merge, axis, kind] = flat[picks[axis]].tolist()
                    del out, flat
    peak = meter.gib()
    # the checks: float64 over the whole other side (sampled rows and
    # columns) and the distinct-value grid ("all")
    va, vb = a.T.reshape(-1), b.T.reshape(-1)
    va64, vb64 = va.double(), vb.double()
    # Σ|v - mean| of each side: the prefix-table error scale (vj_tol)
    c_a = float((va64 - va64.mean()).abs().sum())
    c_b = float((vb64 - vb64.mean()).abs().sum())
    eps_prefix = 2.0 * va.numel() * 2.0 ** -53
    worst, n_checked = 0.0, 0
    for pred in REL_VJ_PREDS:
        for merge in REL_VJ_MERGES:
            grid = vj_grid_reference(va, vb, pred, merge)
            refs = {}
            for axis, other, own in (("row", vb64, va64),
                                     ("col", va64, vb64)):
                refs[axis] = [vj_reference(float(own[i]), other, pred, merge,
                                           axis)
                              for i in picks[axis].tolist()]
            for axis in ("row", "col", "all"):
                for kind in ("sum", "count", "avg", "max", "min"):
                    if axis == "all":
                        c_side = (float(va64.abs().sum()) if merge == "mul"
                                  else float(va.numel()))
                        wants = [(grid[kind], grid["count"],
                                  eps_prefix * c_b * c_side,
                                  2.0 ** -27 * grid["abs"])]
                    else:
                        own = va64 if axis == "row" else vb64
                        c_other = c_b if axis == "row" else c_a
                        qs = own[picks[axis]].abs().tolist()
                        wants = []
                        for (s_, c_, mx, mn, _), q in zip(refs[axis], qs):
                            w = {"sum": s_, "count": c_,
                                 "avg": s_ / c_ if c_ else 0.0, "max": mx,
                                 "min": mn}[kind]
                            scale = q if merge == "mul" else 1.0
                            wants.append((w, c_, eps_prefix * c_other *
                                          scale, 0.0))
                    for gv, (w, c_, pe, re) in zip(
                            got[pred, merge, axis, kind], wants):
                        tol = vj_tol(kind, w, c_, pe, re)
                        err = abs(gv - w)
                        if not math.isfinite(gv) or err > tol:
                            raise AssertionError(
                                f"value join {pred}/{merge}/{kind}/{axis}: "
                                f"{gv!r} vs float64 {w!r}, |err| {err:.3e}"
                                f" > derived bound {tol:.3e}")
                        worst = max(worst, err / tol if tol else
                                    (0.0 if err == 0 else math.inf))
                        n_checked += 1
    med = {k: statistics.median(v) * 1e3 for k, v in times.items()}
    n_aggs = len(REL_VJ_PREDS) * len(REL_VJ_MERGES) * 15
    log(f"path relational, value join: {n_aggs} aggregates of join_on_values(A, B) over {n}² ⋈ {n}² f32 "
        f"(2^{int(math.log2(n * n)) * 2} logical pairs), preds "
        f"{REL_VJ_PREDS} × merges {REL_VJ_MERGES} × 5 kinds × row/col/"
        f"all; {n_checked} results held against float64 (sampled rows and "
        f"columns: enumeration over the whole other side; all: distinct-"
        f"value grid), worst |err| / derived bound {worst:.3e}; median ms "
        f"per aggregate (host clock, synchronised) row {med['row']:.1f} / "
        f"col {med['col']:.1f} / all {med['all']:.1f}; total "
        f"{sum(sum(v) for v in times.values()):.2f} s; peak {peak:.3f} GiB "
        f"(the operands and the aggregates; the pair matrix would hold "
        f"2^{int(math.log2(n * n)) * 2} entries)")
    del A, B, a, b, va, vb, va64, vb64, j, sess
    bb = rel_blackbox(dev)
    return {"ms": med, "worst": worst, "checked": n_checked,
            "peak_gib": peak, "blackbox": bb}


def rel_blackbox(dev) -> dict:
    """A callable merge and predicate over 2^14 × 2^14 entries (2^28
    pairs, join_bruteforce_max_pairs) through the chunked path, every
    row against float64 within the derived bound: each pair's f32
    merge rounds twice (U32·(2|x·y| + |y|)), the row sum runs in float64,
    the result rounds once. The peak is read before the check runs."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.relational import ops as R
    meter = PeakMeter("blackbox")
    sess = MatrelSession(device=dev)
    n = REL_BB_N
    g = torch.Generator(device=dev).manual_seed(22)
    a = torch.randn(n, n, generator=g, device=dev)
    b = torch.randn(n, n, generator=g, device=dev)
    merge = lambda x, y: x * y - y
    pred = lambda x, y: x + y > 0
    e = R.aggregate(R.join_on_values(dense_leaf(sess, a),
                                     dense_leaf(sess, b), merge, pred),
                    "sum", "row")
    cap = sess.config.join_bruteforce_max_pairs
    if (n * n) ** 2 > cap:
        raise AssertionError(f"black-box join: {(n * n) ** 2} pairs > {cap}")
    out, first = synced(lambda: sess.compute(e))
    _, warm = synced(lambda: sess.compute(e))
    peak = meter.gib()
    va, vb = a.T.reshape(-1).double(), b.T.reshape(-1).double()
    worst = 0.0
    for r in range(0, va.numel(), 2048):
        x = va[r:r + 2048, None]
        keep = (x + vb[None, :]) > 0
        p = torch.where(keep, x * vb[None, :] - vb[None, :], 0.0)
        want = p.sum(1)
        bound = U32 * torch.where(keep, 2 * (x * vb[None, :]).abs()
                                  + vb[None, :].abs(), 0.0).sum(1)
        tol = bound + U32 * want.abs()
        err = (out.data[r:r + 2048, 0].double() - want).abs()
        if bool((err > tol).any()):
            i = int((err - tol).argmax())
            raise AssertionError(f"black-box join row {r + i}: |err| "
                                 f"{float(err[i]):.3e} > {float(tol[i]):.3e}")
        worst = max(worst, float((err / tol.clamp(min=1e-300)).max()))
    log(f"path relational, black-box join: rowsum(join_on_values) with a "
        f"callable merge and predicate over {n * n} × {n * n} entries "
        f"({(n * n) ** 2} pairs = join_bruteforce_max_pairs), chunked "
        f"{sess.config.join_chunk_entries} pairs a tile; first call "
        f"{first * 1e3:.1f} ms, warm {warm * 1e3:.1f} ms; every row vs "
        f"float64, worst |err| / derived bound {worst:.3e}; peak "
        f"{peak:.3f} GiB")
    return {"first_ms": first * 1e3, "warm_ms": warm * 1e3, "worst": worst,
            "peak_gib": peak}


def rows_vs_f64(name, got, want64, tol) -> float:
    """max |got - want| over sampled rows, each entry within ``tol``
    (a tensor of per-entry bounds, or a number)."""
    err = (got.double() - want64).abs()
    bad = err > tol
    if bool(bad.any()):
        i = int(bad.flatten().nonzero()[0])
        raise AssertionError(f"{name}: |err| {float(err.flatten()[i]):.3e} "
                             f"over its bound at flat index {i}")
    return float(err.max())


@contextlib.contextmanager
def tf32_products():
    """The port's f32 products as TF32: local_dot's precision guard
    swapped for one that allows it (a lower precision for the product
    bound to catch)."""
    import torch
    from matrel_tpu_torch.parallel import strategies
    keep = strategies._highest_precision
    strategies._highest_precision = lambda: setattr(
        torch.backends.cuda.matmul, "allow_tf32", True)
    try:
        yield
    finally:
        strategies._highest_precision = keep
        keep()


def lower_precision_ratios(dev, name, make, rows, want, tol) -> dict:
    """The same product query with TF32 products and with bf16 products
    (matmul_precision "default"): max |err| / bound over the sampled
    rows, each of which must miss the bound, or the bound could not see
    the product path drop below f32."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    ratios = {}
    for label, prec, ctx in (("tf32", "highest", tf32_products),
                             ("bf16", "default", contextlib.nullcontext)):
        s = MatrelSession(config=MatrelConfig(matmul_precision=prec),
                          device=dev)
        with ctx():
            out = s.compute(make(s))
        ratios[label] = float(((out.data[rows].double() - want).abs()
                               / tol).max())
        del out
        if ratios[label] <= 1.0:
            raise AssertionError(f"{name} with {label} products: max |err|"
                                 f" / bound {ratios[label]:.3f} <= 1")
    return ratios


def rel_selections(dev) -> dict:
    """σ and the index join over dense REL_SEL_N² f32 operands, and the
    row join at the cap, each through compute(), sampled rows against
    float64: σ exact, a product's entries within product_tol, which the
    same product query with TF32 or bf16 products must miss."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.relational import ops as R
    meter = PeakMeter("selections")
    sess = MatrelSession(device=dev)
    n, k = REL_SEL_N, REL_SEL_K
    g = torch.Generator(device=dev).manual_seed(23)
    a = torch.randn(n, n, generator=g, device=dev)
    b = torch.randn(n, n, generator=g, device=dev)
    w = torch.randn(n, k, generator=g, device=dev)
    rows = torch.randint(0, n, (REL_ROWS_CHECKED,), generator=g,
                         device=dev)
    bs = 512
    idx_name = f"join_on_index(A, B, 'mul') · W ({n}×{k})"

    def index_join(s):
        return R.join_on_index(dense_leaf(s, a), dense_leaf(s, b),
                               "mul").multiply(dense_leaf(s, w))

    with meter.aside():
        idx = torch.arange(n, device=dev)
        ar = a[rows].double()
        x = (a[rows] * b[rows]).double()        # the join's rows, exact
        w64 = w.double()
        cases = {
            "select_value(v > 0)": (
                lambda s: R.select_entries(dense_leaf(s, a),
                                           lambda v: v > 0),
                torch.where(ar > 0, ar, 0.0), 0.0),
            "select_rows(i % 2 == 0)": (
                lambda s: R.select_rows(dense_leaf(s, a),
                                        lambda i: i % 2 == 0),
                ar * (rows % 2 == 0)[:, None], 0.0),
            f"select_blocks(bi == bj, {bs})": (
                lambda s: R.select_blocks(dense_leaf(s, a),
                                          lambda bi, bj: bi == bj,
                                          block_size=bs),
                torch.where((rows // bs)[:, None] == (idx // bs)[None, :],
                            ar, 0.0), 0.0),
            idx_name: (index_join, x @ w64, product_tol(x, w64)),
        }
        del idx, ar, x, w64
    stats = {}
    for name, (make, want, tol) in cases.items():
        e = make(sess)
        out, first = synced(lambda: sess.compute(e))
        warm = time_ms(lambda: sess.compute(e), warmup=1, runs=5)
        err = rows_vs_f64(name, out.data[rows], want, tol)
        stats[name] = {"first_ms": first * 1e3, "warm_ms": warm,
                       "err": err}
        if name == idx_name:
            stats[name]["ratio"] = float(
                ((out.data[rows].double() - want).abs() / tol).max())
        del out
    with meter.aside():
        stats[idx_name]["lower"] = lower_precision_ratios(
            dev, idx_name, index_join, rows, *cases[idx_name][1:])
    del a, b, w, cases, e
    sess = MatrelSession(device=dev)
    # the row join at the cap, times V: the join_under_matmul shape
    nr = REL_JR_N
    l_ = torch.randn(nr, REL_JR_L, generator=g, device=dev)
    r_ = torch.randn(nr, REL_JR_R, generator=g, device=dev)
    v = torch.randn(REL_JR_L * REL_JR_R, REL_JR_K, generator=g, device=dev)

    def row_join(s):
        return R.join_on_rows(dense_leaf(s, l_), dense_leaf(s, r_),
                              "mul").multiply(dense_leaf(s, v))

    e = row_join(sess)
    if nr * REL_JR_L * REL_JR_R > sess.config.join_pair_cap_entries:
        raise AssertionError("row join over the cap")
    scheme = sess.compile(e).optimized.children[0].attrs["replicate"]
    jr = rows % nr
    kk = REL_JR_L * REL_JR_R
    with meter.aside():
        pairs = (l_[jr][:, :, None] * r_[jr][:, None, :]).reshape(
            len(jr), -1).double()
        v64 = v.double()
        want, tol = pairs @ v64, product_tol(pairs, v64)
        del pairs, v64
    out, first = synced(lambda: sess.compute(e))
    warm = time_ms(lambda: sess.compute(e), warmup=1, runs=5)
    name = (f"join_on_rows(L {nr}×{REL_JR_L}, R {nr}×{REL_JR_R}, 'mul') · "
            f"V ({kk}×{REL_JR_K}), scheme {scheme}")
    err = rows_vs_f64(name, out.data[jr], want, tol)
    stats[name] = {"first_ms": first * 1e3, "warm_ms": warm, "err": err,
                   "scheme": scheme, "ratio": float(
                       ((out.data[jr].double() - want).abs() / tol).max())}
    del out
    with meter.aside():
        stats[name]["lower"] = lower_precision_ratios(
            dev, name, row_join, jr, want, tol)
    peak = meter.gib()
    for name, st in stats.items():
        line = (f"path relational, {name}: first call "
                f"{st['first_ms']:.2f} ms, warm {st['warm_ms']:.3f} ms "
                f"(CUDA events, median of 5), max |err| vs float64 on "
                f"{REL_ROWS_CHECKED} rows {st['err']:.3e}")
        if "ratio" in st:
            line += (f"; max |err| / bound {PROD_C:g}·u·√K·‖t‖₂: f32 "
                     f"{st['ratio']:.4f}, the same query with TF32 "
                     f"products {st['lower']['tf32']:.2f}, with bf16 "
                     f"products {st['lower']['bf16']:.2f} (both must "
                     f"exceed 1)")
        log(line)
    log(f"path relational, selections and index/row joins: peak "
        f"{peak:.3f} GiB")
    return {"queries": stats, "peak_gib": peak}


def tri_adjacency(n: int, p: float, seed: int):
    """bench_all.py bench_triangles' 0/1 symmetric adjacency."""
    import numpy as np
    rng = np.random.default_rng(seed)
    a = (rng.random((n, n)) < p).astype(np.float32)
    a = np.triu(a, 1)
    return a + a.T


def scipy_trace_a3(a_sp) -> int:
    """trace(A³) of a symmetric sparse adjacency: Σ (A·A) ∘ A, exact."""
    return int(round((a_sp @ a_sp).multiply(a_sp).sum()))


def rel_sql(dev) -> dict:
    """SQL on the card: SELECT trace(A * A * A) FROM A over bench_all's
    adjacency (exact against scipy.sparse), a select/rowsum query, a
    joinvalue query, explain_sql, and the same text twice (one
    plan-cache hit)."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from matrel_tpu_torch import MatrelSession
    meter = PeakMeter("sql")
    sess = MatrelSession(device=dev)
    n = REL_TRI_N
    a = tri_adjacency(n, REL_TRI_P, 2)
    want6 = scipy_trace_a3(sp.csr_matrix(a))
    sess.register("A", sess.from_numpy(a))
    q = "SELECT trace(A * A * A) FROM A"
    plans0 = sess.plan_cache_info()["plans"]
    out, first = synced(lambda: sess.compute(sess.sql(q)))
    plans1 = sess.plan_cache_info()["plans"]
    secs = []
    for _ in range(3):
        out, s = synced(lambda: sess.compute(sess.sql(q)))
        secs.append(s)
    hits_ok = sess.plan_cache_info()["plans"] == plans1 == plans0 + 1
    got6 = float(out.data[0, 0])
    if got6 != want6 or not hits_ok:
        raise AssertionError(f"SQL triangles: trace(A³) {got6!r} vs scipy "
                             f"{want6}; plans {plans0} → {plans1} → "
                             f"{sess.plan_cache_info()['plans']}")
    flops = 2.0 * n ** 3 + 2.0 * n ** 2
    s_med = statistics.median(secs)
    log(f"path relational, SQL {q!r} over {n}² f32 at {REL_TRI_P:.0%} "
        f"(seed 2): {int(got6) // 6} triangles, trace(A³) {int(got6)} = "
        f"scipy.sparse exactly; first call {first * 1e3:.1f} ms (parse, "
        f"plan, run), warm {s_med * 1e3:.2f} ms (median of 3, host clock, "
        f"synchronised; the same text re-parsed each time: "
        f"{sess.plan_cache_info()['plans'] - plans0} plan compiled, 3 "
        f"cache hits) = {flops / s_med / 1e12:.2f} TFLOP/s against "
        f"2n³ + 2n²")
    for line in sess.explain_sql(q).splitlines():
        log(f"  explain_sql | {line}")
    deg = sess.compute(sess.sql(
        "SELECT rowsum(select(A, 'v > 0')) FROM A")).to_numpy()[:, 0]
    if not np.array_equal(deg, a.sum(1)):
        raise AssertionError("SQL rowsum(select(A, 'v > 0')) != degrees")
    m = 512
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn(m, m, generator=g, device=dev).mul_(64).round_().div_(64)
    sess.register("X", dense_leaf(sess, x))
    jq = "SELECT rowsum(joinvalue(X, X, 'mul', 'lt')) FROM X"
    out, js = synced(lambda: sess.compute(sess.sql(jq)))
    vx = x.T.reshape(-1).double()
    picks = torch.randint(0, vx.numel(), (64,), generator=g, device=dev)
    c_x = float((vx - vx.mean()).abs().sum())
    worst = 0.0
    for i in picks.tolist():
        s_, c_, _, _, _ = vj_reference(float(vx[i]), vx, "lt", "mul", "row")
        gv = float(out.data[i, 0])
        tol = vj_tol("sum", s_, c_, 2.0 * vx.numel() * 2.0 ** -53 * c_x
                     * abs(float(vx[i])))
        if abs(gv - s_) > tol:
            raise AssertionError(f"SQL joinvalue row {i}: {gv!r} vs float64 "
                                 f"{s_!r} > {tol:.3e}")
        worst = max(worst, abs(gv - s_) / tol if tol else 0.0)
    peak = meter.gib()
    log(f"path relational, SQL {jq!r} ({m}² ⋈ {m}²): {js * 1e3:.1f} ms "
        f"first call; 64 rows vs float64, worst |err| / derived bound "
        f"{worst:.3e}; rowsum(select(A, 'v > 0')) = degrees exactly; peak "
        f"{peak:.3f} GiB")
    return {"tri": int(got6) // 6, "warm_ms": s_med * 1e3,
            "tflops": flops / s_med / 1e12, "first_ms": first * 1e3,
            "joinvalue_ms": js * 1e3, "peak_gib": peak}


def rel_triangles_block_sparse(dev) -> dict:
    """trace(S·S·S)/6 over a block-sparse adjacency of block-diagonal
    communities (bs REL_BS, f32, n = REL_BS_N): S·S reaches the S×S
    registry; the stamped kernel id, its launches and the exact count
    against scipy."""
    import numpy as np
    import scipy.sparse as sp
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.ops import pallas_spmm
    from matrel_tpu_torch.workloads import triangles
    meter = PeakMeter("triangles_bs")
    sess = MatrelSession(device=dev)
    n, bs = REL_BS_N, REL_BS
    rng = np.random.default_rng(25)
    rows, cols = [], []
    for k in range(0, n, bs):
        blk = np.triu(rng.random((bs, bs)) < REL_BS_P, 1)
        r, c = np.nonzero(blk)
        rows += [r + k, c + k]
        cols += [c + k, r + k]
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    S = BlockSparseMatrix.from_coo_arrays(rows, cols, np.ones(len(rows)),
                                          (n, n), block_size=bs,
                                          mesh=sess.mesh)
    want6 = scipy_trace_a3(sp.csr_matrix((np.ones(len(rows), np.float32),
                                          (rows, cols)), shape=(n, n)))
    e = triangles.triangle_count_expr(S)
    plan = sess.compile(e)

    def stamps(node):
        got = ([node.attrs["spgemm_kernel"]]
               if "spgemm_kernel" in node.attrs else [])
        return got + [k for c in node.children for k in stamps(c)]

    def nodes(node):
        yield node
        for c in node.children:
            yield from nodes(c)

    kids = stamps(plan.optimized)
    d_s = any(m.kind == "matmul" and sum(c.kind == "sparse_leaf"
                                         for c in m.children) == 1
              for m in nodes(plan.optimized))
    zero_spgemm_launches()
    pallas_spmm.LAUNCHES = 0
    out, first = synced(lambda: sess.compute(e))
    launches = spgemm_launches()
    l_b1 = pallas_spmm.LAUNCHES
    got6 = float(out.data[0, 0])
    _, warm = synced(lambda: sess.compute(e))
    if len(kids) != 1 or got6 != want6:
        raise AssertionError(f"block-sparse triangles: stamps {kids}, "
                             f"trace {got6!r} vs scipy {want6}")
    # the stamp names a schedule; the kernels it launches are counted
    # (pallas_band falls back to the grouped kernel at some shapes)
    launched = {k: v for k, v in launches.items() if v}
    need_launches(f"block-sparse triangles ({kids[0]})",
                  sum(launched.values()))
    peak = meter.gib()
    # the launched kernel against its plain version on the path's S·S
    run, a_m, b_m, n_out = spgemm_runner(S, S, kids[0])
    if predicted_launches(run) != launches:
        raise AssertionError(f"block-sparse triangles: the path launched "
                             f"{launched}, the {kids[0]} runner of S·S "
                             f"launches {predicted_launches(run)}")
    kname = SPGEMM_KERNEL_OF[run.schedule]
    dtype_name = str(a_m.dtype).removeprefix("torch.")
    got = run(a_m, b_m)
    want = spgemm_plain(run, a_m, b_m, n_out)
    k_err = check_close(f"{kname} on the triangles' S·S (bs {bs})",
                        got.reshape(-1, got.shape[-1]),
                        want.reshape(-1, want.shape[-1]), dtype_name)
    del got, want, a_m, b_m, run
    log(f"path relational, triangles over a block-sparse adjacency "
        f"(n={n:,}, {n // bs} communities of {bs}, p={REL_BS_P}, "
        f"S.nnzb={S.nnzb}): stamp {kids[0]}, launches {launched}, "
        f"{kname} vs its plain version on S·S ({n_out} {bs}² {dtype_name} "
        f"tiles) max_abs_err {k_err:.3e}; B1 "
        f"launches {l_b1} (the plan {'has a' if d_s else 'has no'} D·S "
        f"product; rule R3 turns trace((S·S)·S) into Σ (S·S) ∘ Sᵀ); "
        f"{int(got6) // 6} triangles = "
        f"scipy.sparse exactly; first call {first * 1e3:.1f} ms, warm "
        f"{warm * 1e3:.1f} ms; peak {peak:.3f} GiB")
    return {"launches": launches, "b1": l_b1, "stamp": kids[0],
            "max_abs_err": {kname: k_err},
            "warm_ms": warm * 1e3, "first_ms": first * 1e3,
            "peak_gib": peak, "tri": int(got6) // 6}


def rel_similarity(dev) -> dict:
    """cosine_similarity of a clustered X (REL_SIM_N × REL_SIM_D f32) at
    "high" and "highest", then σ(v > 0.9), sampled rows against float64.
    Bounds: K·U32 for the f32 Gram's entries over ‖x_i‖‖x_j‖ (Cauchy-
    Schwarz), plus 2^-15 for "high"'s dropped lo·lo term, plus 8·U32 for
    the norms and the divide."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.workloads import similarity
    meter = PeakMeter("similarity")
    n, d = REL_SIM_N, REL_SIM_D
    g = torch.Generator(device=dev).manual_seed(26)
    centers = torch.randn(REL_SIM_CLUSTERS, d, generator=g, device=dev)
    label = torch.randint(0, REL_SIM_CLUSTERS, (n,), generator=g,
                          device=dev)
    x = centers[label] + 0.25 * torch.randn(n, d, generator=g, device=dev)
    rows = torch.randint(0, n, (REL_ROWS_CHECKED,), generator=g, device=dev)
    with meter.aside():
        x64 = x.double()
        nrm = x64.norm(dim=1)
        want = (x64[rows] @ x64.T) / (nrm[rows, None] * nrm[None, :])
        del x64, nrm
    stats = {}
    for prec in ("highest", "high"):
        s = MatrelSession(config=MatrelConfig(matmul_precision=prec),
                          device=dev)
        X = dense_leaf(s, x)
        tol = d * U32 + 8 * U32 + (2.0 ** -15 if prec == "high" else 0.0)
        out, first = synced(lambda: similarity.cosine_similarity_expr(X)
                            .compute(s))
        warm = time_ms(lambda: similarity.cosine_similarity_expr(X)
                       .compute(s), warmup=1, runs=5)
        err = rows_vs_f64(f"cosine similarity ({prec})", out.data[rows],
                          want, tol)
        del out
        e = similarity.cosine_similarity_expr(X).select_value(
            lambda v: v > 0.9)
        sel, sel_s = synced(lambda: e.compute(s))
        got = sel.data[rows].double()
        clear = (want - 0.9).abs() > tol        # not within tol of 0.9
        want_sel = torch.where(want > 0.9, want, 0.0)
        err_sel = rows_vs_f64(f"σ(v > 0.9) of the similarity ({prec})",
                              torch.where(clear, got, want_sel), want_sel,
                              tol)
        kept = int((sel.data > 0).sum())
        stats[prec] = {"first_ms": first * 1e3, "warm_ms": warm,
                       "err": err, "sel_ms": sel_s * 1e3,
                       "err_sel": err_sel, "kept": kept}
        del sel, X, s
    peak = meter.gib()
    for prec, st in stats.items():
        log(f"path relational, cosine_similarity X {n}×{d} f32 "
            f"({REL_SIM_CLUSTERS} clusters) at {prec!r}: first call "
            f"{st['first_ms']:.1f} ms, warm {st['warm_ms']:.3f} ms (CUDA "
            f"events, median of 5), max |err| vs float64 on "
            f"{REL_ROWS_CHECKED} rows {st['err']:.3e}; σ(v > 0.9) "
            f"{st['sel_ms']:.1f} ms, {st['kept']:,} entries kept, "
            f"|err| {st['err_sel']:.3e}")
    log(f"path relational, similarity: peak {peak:.3f} GiB")
    return {"queries": stats, "peak_gib": peak}


def rel_coo(dev) -> dict:
    """COO relational on row 5's 10M-edge graph: σ(v > median) then
    matvec and compute (B2 counted), row_count and row_max against
    scipy, and one join_on_value(…, "eq") under max_pairs."""
    import numpy as np
    import scipy.sparse as sp
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import pallas_spmv as pc
    meter = PeakMeter("coo")
    sess = MatrelSession(device=dev)
    _, _, A = row5_matrix()
    n = A.shape[0]
    med = float(np.median(A.vals))
    sel, sel_s = synced(lambda: A.select_value(lambda v: v > med))
    csr = sp.csr_matrix((sel.vals.astype(np.float64), (sel.rows, sel.cols)),
                        shape=sel.shape)
    x = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(27),
                   device=dev)
    want = csr @ x.double().cpu().numpy()
    pc.LAUNCHES_SPMV = 0                 # the σ-filtered matvec path
    y, mv_first = synced(lambda: sel.matvec(x, device=dev))
    y2 = sess.compute(sel.multiply(dense_leaf(sess, x[:, None])))
    torch.cuda.synchronize()
    launches = need_launches("σ-filtered matvec (B2)", pc.LAUNCHES_SPMV)
    mv_warm = time_ms(lambda: sel.matvec(x, device=dev), warmup=1, runs=10)
    scale = float(np.abs(want).max())
    errs = [float(np.abs(t.double().cpu().numpy() - want).max()) / scale
            for t in (y, y2.data[:, 0])]
    if max(errs) > SPMV_ORACLE_TOL[3]:
        raise AssertionError(f"σ-filtered matvec: rel err {errs} > "
                             f"{SPMV_ORACLE_TOL[3]}")
    cnt, cnt_s = synced(lambda: sel.row_count())
    mx, mx_s = synced(lambda: sel.row_max())
    csr.eliminate_zeros()
    if not (np.array_equal(cnt[:, 0], np.diff(csr.indptr).astype(np.float32))
            and np.array_equal(mx, csr.max(axis=1).toarray().astype(
                np.float32))):
        raise AssertionError("COO row_count / row_max differ from scipy")
    # B: the selected graph's distinct values that occur at most 200,000
    # times (the rare high 1/outdeg values), so the pairs stay under
    # max_pairs
    vals, counts = np.unique(sel.vals, return_counts=True)
    pool = np.nonzero(counts <= 200_000)[0][:16]
    from matrel_tpu_torch.core.coo import COOMatrix
    Bq = COOMatrix.from_edges(np.arange(len(pool)),
                              np.zeros(len(pool), np.int64), vals[pool],
                              shape=(max(len(pool), 1), 1))
    pairs, j_s = synced(lambda: sel.join_on_value(Bq, "mul", "eq",
                                                  max_pairs=1 << 22))
    ia, ja, ib, jb, pv = pairs
    want_pairs = int(counts[pool].sum())
    if len(pool) == 0 or len(pv) != want_pairs or not np.array_equal(
            pv, (vals[pool][ib] ** 2).astype(np.float32)):
        raise AssertionError(f"COO join_on_value: {len(pv)} pairs vs "
                             f"{want_pairs}")
    peak = meter.gib()
    log(f"path relational, COO on row 5's graph ({A.nnz:,} edges): "
        f"select_value(v > median {med:.4g}) {sel_s:.2f} s (host) → "
        f"{sel.nnz:,} edges; matvec first call {mv_first:.2f} s (plan build"
        f" included), warm {mv_warm:.4f} ms (CUDA events), {launches} B2 "
        f"launches (matvec and compute), rel err vs float64 scipy "
        f"{max(errs):.3e}; row_count {cnt_s * 1e3:.0f} ms, row_max "
        f"{mx_s * 1e3:.0f} ms (host) = scipy; join_on_value(σA, "
        f"{len(pool)} values, 'mul', 'eq') {j_s:.2f} s (host) → {len(pv):,} pairs (max_pairs "
        f"{1 << 22:,}); peak {peak:.3f} GiB")
    return {"launches": launches, "select_s": sel_s, "mv_ms": mv_warm,
            "join_s": j_s, "pairs": len(pv), "peak_gib": peak,
            "row_count_ms": cnt_s * 1e3, "row_max_ms": mx_s * 1e3}


def rel_io(dev) -> dict:
    """save_tiled / load_tiled of a REL_IO_N² f32 matrix through a
    temporary directory under the checkout's build/, bit for bit."""
    import tempfile
    import torch
    from matrel_tpu_torch import MatrelSession, io
    meter = PeakMeter("io")
    sess = MatrelSession(device=dev)
    n = REL_IO_N
    m = dense_leaf(sess, torch.randn(
        n, n, generator=torch.Generator(device=dev).manual_seed(28),
        device=dev))
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    with tempfile.TemporaryDirectory(dir=os.path.join(HERE, "build")) as d:
        _, save_s = synced(lambda: io.save_tiled(d, m))
        back, load_s = synced(lambda: io.load_tiled(d, mesh=sess.mesh))
        n_files = len(os.listdir(d))
    if back.shape != m.shape or not torch.equal(back.data, m.data):
        raise AssertionError("save_tiled / load_tiled changed the matrix")
    peak = meter.gib()
    gib = n * n * 4 / 2**30
    log(f"path relational, io: save_tiled {n}² f32 ({gib:.0f} GiB, "
        f"{n_files - 1} tiles + meta.json) {save_s:.2f} s, load_tiled "
        f"{load_s:.2f} s, bit-equal; peak {peak:.3f} GiB")
    return {"save_s": save_s, "load_s": load_s, "peak_gib": peak}


def path_relational(dev) -> dict:
    """MatRel's relational σ/γ/⋈ surface and SQL on the card: the
    sub-phases above, each through a fresh session, with its time, its
    error against its oracle and its own peak device memory. Returns
    the launches it adds to B2 and the S×S kernels, and the error of
    the S×S kernel it launched against its plain version at its shape."""
    out = {"value_join": rel_value_join(dev),
           "selections": rel_selections(dev),
           "sql": rel_sql(dev),
           "triangles_bs": rel_triangles_block_sparse(dev),
           "similarity": rel_similarity(dev),
           "coo": rel_coo(dev),
           "io": rel_io(dev)}
    peaks = {k: round(v["peak_gib"], 3) for k, v in out.items()}
    peaks["blackbox"] = round(out["value_join"]["blackbox"]["peak_gib"], 3)
    log(f"path relational: peaks by sub-phase (GiB) {peaks}; bounds "
        f"{ {k: round(v, 3) for k, v in REL_PEAK_LIMIT_GIB.items()} }")
    launches = dict(out["triangles_bs"]["launches"])
    launches["spmv_compact"] = out["coo"]["launches"]
    out["launches"] = launches
    out["max_abs_err"] = out["triangles_bs"]["max_abs_err"]
    return out


# -- the rest of the COO plane: path_coo_plane ----------------------------------

#: dense PageRank: a 16,384² f32 adjacency (1 GiB), edges at 1%, every
#: DENSE_DANGLING-th row without out-edges
COO_DENSE_N, COO_DENSE_P, COO_DENSE_DANGLING = 16384, 0.01, 7
#: pagerank_csr's near-regular graph: every node's in-degree exactly this
COO_CSR_DEG = 10
#: block-sparse PageRank: block rows of COO_BS nodes, each with its
#: diagonal tile and its two neighbours (wrapping), edges at COO_BS_P;
#: every COO_BS_DANGLING-th row without out-edges, every
#: COO_BS_LIGHT-th row weighted COO_BS_WEIGHT
COO_BS_N, COO_BS, COO_BS_P = 100_352, 512, 0.05
COO_BS_DANGLING, COO_BS_LIGHT, COO_BS_WEIGHT = 11, 5, 0.3
COO_CHUNKS = 4
#: PageRank (30 f32 rounds) against float64, relative to max|r|: row 5's
#: bound (path_row5_pagerank)
PR_REL_TOL = 1e-4
#: the autotune path: SpGEMM probes at these (side, autotune_max_dim),
#: every structure class at bs 512 and the band also at bs 128; the SpMV
#: probe graph (about 3.3M slots, ~0.7 GB expanded)
AT_SIDES = ((8192, 8192), (32768, 32768))
AT_SPMV_N, AT_SPMV_EDGES = 1_000_000, 3_000_000
#: each new path's own peak device memory, held under 1.25 × its peak on
#: an H100 (PERF.md section 5)
NEW_PEAK_LIMIT_GIB = {k: 1.25 * v for k, v in {
    "coo_plane": 2.169, "autotune": 9.771}.items()}
#: where the path phases write their files: inside the checkout, under
#: the gitignored build/
SCRATCH = os.path.join(HERE, "build", "chip_smoke")


def coo_fills(dev, src, dst) -> dict:
    """Row 5's plan (Âᵀ of the 10M-edge graph) by the native counting-sort
    fill and by the numpy fill (host seconds each); B2 on both, held to
    each other; save_plan / load_plan of the native plan, B2 on the
    loaded plan bit-equal; compact_apply_chunked bit-equal to
    compact_apply. Every B2 launch here goes through compact_apply or
    compact_apply_chunked."""
    import tempfile
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.ops import spmv as spmv_lib
    from matrel_tpu_torch.utils import native
    n = ROW5_N
    outdeg = np.bincount(src, minlength=n).astype(np.float32)
    inv = np.where(outdeg > 0, 1.0 / np.maximum(outdeg, 1e-30),
                   0.0).astype(np.float32)
    t0 = time.perf_counter()
    if native.load_spmv() is None:      # built by g++ at first use
        raise AssertionError("the native plan-fill library did not load")
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    plan = spmv_lib.build_spmv_plan(dst, src, inv[src], n_rows=n, n_cols=n)
    native_s = time.perf_counter() - t0
    if plan.fill != "native":
        raise AssertionError(f"row-5 plan build took the {plan.fill} fill: "
                             f"the native library did not load")
    counts = native.spmv_counts
    native.spmv_counts = lambda *a, **k: None      # the numpy fill
    try:
        t0 = time.perf_counter()
        plan_np = spmv_lib.build_spmv_plan(dst, src, inv[src], n_rows=n,
                                           n_cols=n)
        numpy_s = time.perf_counter() - t0
    finally:
        native.spmv_counts = counts
    gen = torch.Generator(device=dev).manual_seed(21)
    x = torch.rand(n, generator=gen, device=dev)
    y_nat = pc.compact_apply(plan, x)
    y_np = pc.compact_apply(plan_np, x)
    fill_err = check_close("B2 on the native plan vs the numpy plan", y_nat,
                           y_np, "float32")
    ov_rows = np.union1d(*(np.zeros(0) if p.ov_rows is None else p.ov_rows
                           for p in (plan, plan_np)))
    differ = torch.nonzero(y_nat != y_np).flatten().cpu().numpy()
    outside = np.setdiff1d(differ, ov_rows)
    if outside.size:
        raise AssertionError(f"B2 native vs numpy plan: {outside.size} rows "
                             f"with no overflow edge differ (first "
                             f"{outside[:5]}): the CSR view's row order is "
                             f"not the fills' common input order")
    os.makedirs(SCRATCH, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=SCRATCH) as d:
        path = os.path.join(d, "row5_plan.npz")
        t0 = time.perf_counter()
        spmv_lib.save_plan(path, plan)
        save_s = time.perf_counter() - t0
        nbytes = os.path.getsize(path)
        t0 = time.perf_counter()
        loaded = spmv_lib.load_plan(path)
        load_s = time.perf_counter() - t0
    y_load = pc.compact_apply(loaded, x)
    if not torch.equal(y_load, y_nat):
        raise AssertionError("B2 on the loaded plan is not bit-equal to B2 "
                             "on the built one")
    y_chunk = pc.compact_apply_chunked(plan, x, chunks=COO_CHUNKS)
    if not torch.equal(y_chunk, y_nat):
        raise AssertionError(f"compact_apply_chunked(chunks={COO_CHUNKS}) "
                             f"is not bit-equal to compact_apply")
    torch.cuda.synchronize()
    launches = pc.LAUNCHES_SPMV
    # checks and timing: launches from here on are not the path's
    tol = SPMV_REL_TOL[3]
    errs = {name: rel_err(f"B2 on the {name} plan vs its plain version",
                          got, want, tol)
            for name, got, want in (
                ("native", y_nat, pc.compact_apply(plan, x,
                                                   use_pallas=False)),
                ("loaded", y_load, pc.compact_apply(loaded, x,
                                                    use_pallas=False)),
                ("chunked", y_chunk, pc.compact_apply_chunked(
                    plan, x, chunks=COO_CHUNKS, use_pallas=False)))}
    ms = time_ms(lambda: pc.compact_apply(plan, x), warmup=3, runs=20,
                 batch=10)
    chunk_ms = time_ms(lambda: pc.compact_apply_chunked(
        plan, x, chunks=COO_CHUNKS), warmup=3, runs=20, batch=10)
    n_ov = [0 if p.ov_rows is None else len(p.ov_rows)
            for p in (plan, plan_np)]
    log(f"path coo plane, fills: row-5 plan (nb={plan.src8.shape[0]}, "
        f"cap={plan.capacity}, overflow native / numpy {n_ov[0]} / "
        f"{n_ov[1]}) built in {native_s:.3f} s native (its library "
        f"loaded, built if need be, in {lib_s:.3f} s first), {numpy_s:.3f} "
        f"s numpy (host); B2 native vs numpy plan max_abs_err {fill_err:.3e}, "
        f"{differ.size} rows differ, all of them rows with overflow edges "
        f"({ov_rows.size}); save_plan {nbytes / 2**20:.1f} MiB in "
        f"{save_s:.2f} s, load_plan {load_s:.2f} s, B2 on it bit-equal; "
        f"compact_apply_chunked({COO_CHUNKS}) bit-equal, {chunk_ms:.4f} ms "
        f"vs compact_apply {ms:.4f} ms (CUDA events); B2 vs plain max_abs_err "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    del plan_np, loaded
    return {"launches": launches, "plan": plan, "lib_s": lib_s,
            "native_s": native_s,
            "numpy_s": numpy_s, "fill_err": fill_err,
            "rows_differ": int(differ.size), "save_s": save_s,
            "load_s": load_s, "file_mib": nbytes / 2**20, "ms": ms,
            "chunk_ms": chunk_ms, "max_abs_err": max(errs.values())}


def coo_dense_pagerank(sess, meter) -> dict:
    """pagerank on a 16,384² f32 BlockMatrix with dangling rows, 30
    rounds: ms per round (CUDA events, 30 rounds less 0) against the
    byte bound of one 1 GiB read a round, and the result against a
    float64 power iteration on the card."""
    import torch
    from matrel_tpu_torch.workloads import pagerank as pr
    n, dev = COO_DENSE_N, sess.device
    gen = torch.Generator(device=dev).manual_seed(22)
    a = (torch.rand((n, n), generator=gen, device=dev)
         < COO_DENSE_P).to(torch.float32)
    a.fill_diagonal_(0.0)
    a[::COO_DENSE_DANGLING] = 0.0
    A = dense_leaf(sess, a)
    r, first_s = synced(lambda: pr.pagerank(A, rounds=ROW5_ROUNDS))
    t30 = time_ms(lambda: pr.pagerank(A, rounds=ROW5_ROUNDS), warmup=1,
                  runs=5)
    t0 = time_ms(lambda: pr.pagerank(A, rounds=0), warmup=1, runs=5)
    round_ms = (t30 - t0) / ROW5_ROUNDS
    bound_ms = n * n * 4 / HBM_BYTES_PER_S * 1e3
    with meter.aside():
        a64 = a.double()
        deg = a64.sum(1, keepdim=True)
        inv = torch.where(deg > 0, 1.0 / deg.clamp(min=1e-30),
                          torch.zeros((), dtype=torch.float64, device=dev))
        dangling = deg[:, 0] == 0
        r64 = torch.full((n, 1), 1.0 / n, dtype=torch.float64, device=dev)
        for _ in range(ROW5_ROUNDS):
            r64 = 0.85 * (a64.T @ (inv * r64) + r64[dangling].sum() / n) \
                + 0.15 / n
        err = rel_err("dense PageRank vs float64", r, r64, PR_REL_TOL)
        del a64
    total = float(r.double().sum())
    if abs(total - 1.0) > 1e-3:
        raise AssertionError(f"dense PageRank: sum {total}")
    log(f"path coo plane, dense pagerank: {n}² f32 ({n * n * 4 / 2**30:.3f} "
        f"GiB), "
        f"{int((deg[:, 0] == 0).sum())} dangling rows, {ROW5_ROUNDS} rounds:"
        f" {round_ms:.4f} ms a round (CUDA events; the call with 0 rounds "
        f"{t0:.4f} ms), bound {bound_ms:.4f} ms (one read of A at 3.35 "
        f"TB/s); first call {first_s:.3f} s; max abs err {err:.3e} vs "
        f"float64, sum(r) {total:.7f}")
    return {"round_ms": round_ms, "bound_ms": bound_ms, "zero_round_ms": t0,
            "rel_err": err / float(r64.abs().max())}


def coo_pagerank_csr(dev) -> dict:
    """pagerank_csr on a near-regular graph (in-degree exactly
    COO_CSR_DEG everywhere: the table path, no B2 launch) and on row 5's
    graph (in-degrees too loose: the fallback to pagerank_edges, one B2
    launch a round), each against a float64 power iteration. Returns the
    B2 launches."""
    import numpy as np
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.workloads import pagerank as pr
    n = ROW5_N
    rng = np.random.default_rng(23)
    dst = np.repeat(np.arange(n, dtype=np.int32), COO_CSR_DEG)
    src = rng.integers(0, n, dst.size, dtype=np.int32)
    out = {}
    for name, (s, d), want_b2 in (("regular", (src, dst), 0),
                                  ("row 5", row5_graph(), ROW5_ROUNDS)):
        before = pc.LAUNCHES_SPMV
        r, secs = synced(lambda: pr.pagerank_csr(s, d, n, rounds=ROW5_ROUNDS,
                                                 device=dev))
        b2 = pc.LAUNCHES_SPMV - before
        if b2 != want_b2:
            raise AssertionError(f"pagerank_csr on the {name} graph launched "
                                 f"B2 {b2} times, want {want_b2} (the "
                                 f"{'table' if want_b2 == 0 else 'fallback'}"
                                 f" path)")
        ref = pagerank_oracle(s, d, n, ROW5_ROUNDS)
        r64 = r.double().cpu().numpy()
        rel = float(np.abs(r64 - ref).max() / np.abs(ref).max())
        if rel > PR_REL_TOL or not np.isfinite(r64).all():
            raise AssertionError(f"pagerank_csr {name}: rel err {rel}")
        indeg = np.bincount(d, minlength=n)
        log(f"path coo plane, pagerank_csr on the {name} graph: max "
            f"in-degree {indeg.max()} vs mean {len(d) / n:.1f} -> "
            f"{'table' if want_b2 == 0 else 'fallback to pagerank_edges'}"
            f" ({b2} B2 launches); {secs:.2f} s a call (host table or plan "
            f"included); max err / max|ref| {rel:.3e} vs float64")
        out[name] = {"s": secs, "rel_err": rel, "b2": b2}
    return out


def community_graph(sess):
    """The block-sparse community adjacency (COO_BS_* above) on the card,
    as a BlockSparseMatrix, and its tile coordinates."""
    import numpy as np
    import torch
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    n, bs, dev = COO_BS_N, COO_BS, sess.device
    gr = n // bs
    rows = np.repeat(np.arange(gr), 3)
    cols = (rows + np.tile([-1, 0, 1], gr)) % gr
    order = np.lexsort((cols, rows))
    rows, cols = rows[order], cols[order]
    gen = torch.Generator(device=dev).manual_seed(24)
    blocks = (torch.rand((len(rows), bs, bs), generator=gen, device=dev)
              < COO_BS_P).to(torch.float32)
    scale = torch.ones(n, device=dev)
    scale[::COO_BS_LIGHT] = COO_BS_WEIGHT
    scale[::COO_BS_DANGLING] = 0.0
    blocks *= scale.reshape(gr, bs)[torch.as_tensor(rows, device=dev)][
        :, :, None]
    S = BlockSparseMatrix(
        blocks=blocks,
        block_rows=torch.as_tensor(rows.astype(np.int32), device=dev),
        block_cols=torch.as_tensor(cols.astype(np.int32), device=dev),
        shape=(n, n), block_size=bs, mesh=sess.mesh)
    S._seed_host_tiles(rows, cols)
    return S


def coo_pagerank_block_sparse(sess, meter) -> dict:
    """pagerank_block_sparse on the community adjacency: B1 launches (the
    degree vector and one a round, all through the narrow f32 body), ms
    a round (CUDA events, 30 rounds less 0), the result against float64;
    then B1 at this shape (f32 tiles, one dense column) bit-equal to its
    plain version, its time (held under twice its byte bound), bound,
    torch.sparse.mm on the same Sᵀ in CSR (the library yardstick) and in
    BSR over the same tiles, and the crossover sweep of the two f32
    bodies (b1_crossover)."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    from matrel_tpu_torch.workloads import pagerank as pr
    n, bs, dev = COO_BS_N, COO_BS, sess.device
    S = community_graph(sess)
    before = pallas_spmm.LAUNCHES
    bodies_before = dict(pallas_spmm.BODY_LAUNCHES)
    r, first_s = synced(lambda: pr.pagerank_block_sparse(
        S, rounds=ROW5_ROUNDS))
    launches = pallas_spmm.LAUNCHES - before
    bodies = {b: v - bodies_before[b] for b, v in
              pallas_spmm.BODY_LAUNCHES.items() if v != bodies_before[b]}
    if launches != ROW5_ROUNDS + 1 or bodies != {"f32_narrow": launches}:
        raise AssertionError(f"block-sparse PageRank launched B1 {launches} "
                             f"times, bodies {bodies} (want "
                             f"{ROW5_ROUNDS + 1}, all f32_narrow)")
    t30 = time_ms(lambda: pr.pagerank_block_sparse(S, rounds=ROW5_ROUNDS),
                  warmup=1, runs=5)
    t0 = time_ms(lambda: pr.pagerank_block_sparse(S, rounds=0), warmup=1,
                 runs=5)
    round_ms = (t30 - t0) / ROW5_ROUNDS
    with meter.aside():
        nz = torch.nonzero(S.blocks)
        t, i, j = nz.T
        rows_d = S.block_rows.long()[t] * bs + i
        cols_d = S.block_cols.long()[t] * bs + j
        w = S.blocks[t, i, j]
        ref = pagerank_oracle(rows_d.cpu().numpy(), cols_d.cpu().numpy(), n,
                              ROW5_ROUNDS,
                              weights=w.double().cpu().numpy())
        # the library yardstick's operand: Sᵀ as an f32 CSR tensor
        csr = torch.sparse_coo_tensor(torch.stack([cols_d, rows_d]), w,
                                      (n, n)).coalesce().to_sparse_csr()
        del nz, t, i, j, rows_d, cols_d, w
    r64 = r.double().cpu().numpy()[:, 0]
    rel = float(np.abs(r64 - ref).max() / np.abs(ref).max())
    if rel > PR_REL_TOL or not np.isfinite(r64).all():
        raise AssertionError(f"block-sparse PageRank: rel err {rel}")
    with meter.aside():
        St = S.transpose()
        _, payload, row_ptr, bcols = pallas_spmm.csr_payload(St)
        gen = torch.Generator(device=dev).manual_seed(27)
        d = torch.rand((n, 1), generator=gen, device=dev)
        run = lambda: pallas_spmm.spmm_blocksparse(payload, row_ptr, bcols,
                                                   d, n)
        counts = (row_ptr[1:] - row_ptr[:-1]).long()
        tile_rows = torch.repeat_interleave(
            torch.arange(counts.numel(), device=dev), counts)
        plain = lambda: pallas_spmm.spmm_blocksparse_plain(
            payload, tile_rows, bcols, d, n)
        got = run()
        want = plain()
        err = check_close("B1 f32 m=1 (block-sparse PageRank's Sᵀ·w) vs "
                          "plain", got, want, "float32")
        if not torch.equal(got, want):
            raise AssertionError("B1 f32 m=1: the narrow body is not "
                                 "bit-equal to its plain version")
        ms = time_ms(run, warmup=3, runs=20, batch=10)
        plain_ms = time_ms(plain, warmup=1, runs=5)
        bound = spmm_bound(St, 1, n, "float32")
        lib_ms = library_time("torch.sparse.mm f32 CSR k=1 (Sᵀ of the "
                              "community graph)",
                              lambda: torch.sparse.mm(csr, d), got)
        # torch's block-sparse (BSR) product over the same dense tiles:
        # the fair yardstick for a kernel that reads every tile
        bsr = torch.sparse_bsr_tensor(row_ptr, bcols, payload, size=(n, n))
        bsr_ms = library_time("torch.sparse.mm f32 BSR 512² tiles k=1 (Sᵀ "
                              "of the community graph)",
                              lambda: torch.sparse.mm(bsr, d), got)
        if ms > bound[0] * 2:
            raise AssertionError(f"B1 f32 m=1: {ms:.4f} ms, past twice its "
                                 f"byte bound {bound[0]:.4f} ms")
        sweep = b1_crossover(payload, row_ptr, bcols, n, dev)
        del St, payload, got, want, csr, bsr
    log(f"path coo plane, block-sparse pagerank: n={n}, bs={bs}, "
        f"{S.nnzb} f32 tiles ({S.nnzb * bs * bs * 4 / 2**20:.0f} MiB), "
        f"{launches} B1 launches ({bodies}, one column); {round_ms:.4f} ms "
        f"a round (CUDA events; the call with 0 rounds {t0:.4f} ms); first "
        f"call {first_s:.3f} s; max err / max|ref| {rel:.3e} vs float64. B1 "
        f"at this shape (f32_narrow body): {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound[0]:.4f} ms ({bound[1]}), library "
        f"CSR {lib_ms} ms, BSR {bsr_ms} ms, max_abs_err vs plain {err:.3e}")
    return {"launches": launches, "bodies": bodies, "round_ms": round_ms,
            "rel_err": rel,
            "b1": {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                   "bound_ms": bound[0], "bound_by": bound[1],
                   "library_ms": lib_ms, "bsr_ms": bsr_ms,
                   "crossover": [{k: r[k] for k in ("pm", "narrow_ms",
                                                    "wide_ms")}
                                 for r in sweep]}}


def path_coo_plane(sess) -> dict:
    """The rest of the COO plane on the card (coo_fills, dense, CSR and
    block-sparse PageRank), launches counted from 0, under the path's
    own peak-memory bound. Returns the B2 and B1 launches, B1's row at
    the f32 one-column shape and row 5's native plan."""
    from matrel_tpu_torch.ops import pallas_spmm, pallas_spmv as pc
    meter = PeakMeter("coo_plane", NEW_PEAK_LIMIT_GIB)
    pc.LAUNCHES_SPMV = 0
    src, dst = row5_graph()
    fills = coo_fills(sess.device, src, dst)
    del src, dst
    l_b2 = fills["launches"]
    dense = coo_dense_pagerank(sess, meter)
    pc.LAUNCHES_SPMV = 0
    csr = coo_pagerank_csr(sess.device)
    l_b2 += pc.LAUNCHES_SPMV
    pallas_spmm.LAUNCHES = 0
    bsp = coo_pagerank_block_sparse(sess, meter)
    peak = meter.gib()
    log(f"path coo plane: {l_b2} B2 and {bsp['launches']} B1 launches; peak "
        f"{peak:.3f} GiB (bound {NEW_PEAK_LIMIT_GIB['coo_plane']:.3f})")
    return {"launches": {"spmv_compact": l_b2,
                         "spmm_blocksparse": bsp["launches"]},
            "b1_f32_m1": bsp["b1"], "plan": fills.pop("plan"),
            "fills": fills, "dense": dense, "csr": csr, "bsp": bsp,
            "peak_gib": peak}


# -- the measured-choice loop: path_autotune -----------------------------------


def autotune_spgemm_sweep(mesh, path, at, counts) -> dict:
    """lookup_or_measure_spgemm for every structure class at each
    AT_SIDES side (bs 512; the band also at bs 128): every admissible
    candidate must have a time in the table; then, with the in-process
    caches cleared, the same winners from the table and no measurement.
    Returns {key: (best, times, model pick)}."""
    from matrel_tpu_torch import MatrelConfig
    from matrel_tpu_torch.ir import stats
    from matrel_tpu_torch.ops import kernel_registry as kr
    probes = [(side, structure, 512, max_dim)
              for side, max_dim in AT_SIDES
              for structure in stats.STRUCTURE_CLASSES]
    probes += [(side, "row_band", 128, max_dim) for side, max_dim in AT_SIDES]
    out = {}
    for side, structure, bs, max_dim in probes:
        cfg = MatrelConfig(autotune=True, autotune_table_path=path,
                           autotune_max_dim=max_dim)
        t0 = time.perf_counter()
        best = at.lookup_or_measure_spgemm(side, structure, bs, mesh, cfg)
        secs = time.perf_counter() - t0
        key = at._spgemm_key(side, structure, bs, 1, 1, at.backend_of(mesh))
        entry = at.load_table(path).get(key)
        cands = at.spgemm_candidates(structure, bs, cfg)
        times = {} if entry is None else entry["times"]
        if sorted(times) != sorted(cands):
            raise AssertionError(f"autotune {key}: candidates {cands}, timed "
                                 f"{sorted(times)}: an admissible kernel got "
                                 f"no time")
        model = kr.select_kernel(structure, bs, 1, MatrelConfig())
        log(f"path autotune, S×S {structure} bs {bs} side {side}: "
            + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                        sorted(times.items(), key=lambda kv: kv[1]))
            + f" -> {best or 'tie'} (registry's model: {model[0]}, "
            f"{model[1]}); {secs:.1f} s with the probe pair")
        out[key] = (best, times, model[0])
    n0 = counts["spgemm"]
    at.clear_caches()
    for side, structure, bs, max_dim in probes:
        cfg = MatrelConfig(autotune=True, autotune_table_path=path,
                           autotune_max_dim=max_dim)
        key = at._spgemm_key(side, structure, bs, 1, 1, at.backend_of(mesh))
        again = at.lookup_or_measure_spgemm(side, structure, bs, mesh, cfg)
        if again != out[key][0]:
            raise AssertionError(f"autotune {key}: replay gave {again}, "
                                 f"measured {out[key][0]}")
    if counts["spgemm"] != n0:
        raise AssertionError(f"autotune replay measured "
                             f"{counts['spgemm'] - n0} kernels, want 0")
    log(f"path autotune: replay from the table, {len(probes)} classes, the "
        f"same winners, 0 measurements")
    return out


def autotune_spgemm_queries(sess, asess, at, path) -> dict:
    """The four S×S compute queries at n = 32,768 with autotune on: the
    stamp reads "measured" wherever the table has a winner for the
    pair's class; each result bit-equal to the default session's where
    the kernel is the same, within TOL where it differs."""
    import torch
    out = {}
    for name, kid, A, B, dtype_name in spgemm_pairs_at(
            sess.mesh, SPGEMM_CMP_N, random_seeds=(2, 3)):
        e = A.multiply(B)
        attrs = asess.compile(e).optimized.attrs
        stamp, src = attrs["spgemm_kernel"], attrs["spgemm_kernel_source"]
        key = at._spgemm_key(SPGEMM_CMP_N, attrs["spgemm_structure"],
                             A.block_size, 1, 1, at.backend_of(sess.mesh))
        entry = at.load_table(path).get(key)
        has_winner = bool(entry and entry.get("best"))
        if (src == "measured") != has_winner or (
                has_winner and stamp != entry["best"]):
            raise AssertionError(f"S×S {name} with autotune: stamp {stamp} "
                                 f"({src}), table {key}: {entry}")
        default = sess.compile(e).optimized.attrs["spgemm_kernel"]
        Y = asess.compute(e)
        Y0 = sess.compute(e)
        torch.cuda.synchronize()
        if stamp == default:
            if not torch.equal(Y.data, Y0.data):
                raise AssertionError(f"S×S {name}: same kernel {stamp}, "
                                     f"results differ")
            err = 0.0
        else:
            err = check_close(f"S×S {name} {stamp} vs {default}", Y.data,
                              Y0.data, dtype_name, rows_per_step=2048)
        log(f"path autotune, S×S {name} n={SPGEMM_CMP_N}: stamp {stamp} "
            f"({src}), default {default}; max_abs_err vs the default "
            f"{err:.3e}")
        out[name] = {"stamp": stamp, "source": src, "default": default,
                     "err": err}
        del Y, Y0
        torch.cuda.empty_cache()
    return out


def autotune_spmv(sess, asess, at, path, row5_plan, counts) -> dict:
    """The SpMV family: on a 1M-node, 3M-edge uniform graph both variants
    are measured (at compile time of an autotuned compute) and the
    winner persisted, and the result equals the default's within TOL;
    on row 5's plan the expanded tables exceed the budget, so no winner
    and no row."""
    import numpy as np
    import torch
    from matrel_tpu_torch.core.coo import COOMatrix
    n = AT_SPMV_N
    rng = np.random.default_rng(25)
    A = COOMatrix.from_edges(rng.integers(0, n, AT_SPMV_EDGES),
                             rng.integers(0, n, AT_SPMV_EDGES),
                             rng.standard_normal(AT_SPMV_EDGES).astype(
                                 np.float32), shape=(n, n))
    x = sess.random((n, 1), seed=26)
    plan = A._get_plan()
    nb, cap = plan.src8.shape
    Y, secs = synced(lambda: asess.compute(A.multiply(x)))
    backend = at.backend_of(sess.mesh)
    entry = at.load_table(path).get(at._spmv_key(plan, 1, 1, backend))
    if entry is None or sorted(entry["times"]) != ["compact", "expanded"]:
        raise AssertionError(f"SpMV autotune: row {entry}, want both "
                             f"variants timed")
    best = entry["best"]
    if best != "expanded" and plan._tables:
        raise AssertionError("the expanded probe left its one-hot tables on "
                             "the plan")
    Y0 = sess.compute(A.multiply(x))
    err = check_close("A·x with autotune vs the default", Y.data, Y0.data,
                      "float32")
    r5_nb, r5_cap = row5_plan.src8.shape
    before = counts["spmv"]
    got = at.lookup_or_measure_spmv(row5_plan, sess.mesh, asess.config)
    key5 = at._spmv_key(row5_plan, 1, 1, backend)
    if got is not None or key5 in at.load_table(path):
        raise AssertionError(f"row 5's plan ({r5_nb * r5_cap} slots) over "
                             f"the expanded budget: got {got}, row written "
                             f"{key5 in at.load_table(path)}")
    log(f"path autotune, SpMV: {n} nodes, {AT_SPMV_EDGES} edges, "
        f"nb·cap = {nb * cap} slots ({nb * cap * 224 / 1e9:.3f} GB "
        f"expanded): "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                    sorted(entry["times"].items()))
        + f" -> {best or 'tie'}; compute with autotune {secs:.2f} s (first "
        f"call, both probes included), max_abs_err vs the default "
        f"{err:.3e}. Row 5: nb·cap = {r5_nb * r5_cap} slots "
        f"({r5_nb * r5_cap * 224 / 1e9:.3f} GB expanded > "
        f"{at.SPMV_EXPANDED_BUDGET_BYTES / 1e9:.3f} GB): no winner, no row "
        f"({counts['spmv'] - before} variant measured)")
    del Y, Y0
    return {"best": best, "times": entry["times"], "err": err,
            "slots": nb * cap, "row5_slots": r5_nb * r5_cap}


def path_autotune(sess, row5_plan) -> dict:
    """The measured-choice loop on the card, its table in a temporary
    file under build/: the SpGEMM sweep and replay, the four S×S compute
    queries with autotune on, the SpMV family, and no matmul strategy
    measured on the 1 × 1 card. Launches counted from 0; the path's own
    peak-memory bound."""
    import shutil
    import tempfile
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.parallel import autotune as at
    meter = PeakMeter("autotune", NEW_PEAK_LIMIT_GIB)
    os.makedirs(SCRATCH, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=SCRATCH)
    path = os.path.join(tmp, "autotune.json")
    counts = dict.fromkeys(("matmul", "spmv", "spgemm"), 0)
    orig = {"matmul": at.measure_strategy, "spmv": at.measure_spmv_variant,
            "spgemm": at.measure_spgemm_kernel}

    def counted(family):
        def measure(*a, **k):
            counts[family] += 1
            return orig[family](*a, **k)
        return measure

    at.measure_strategy = counted("matmul")
    at.measure_spmv_variant = counted("spmv")
    at.measure_spgemm_kernel = counted("spgemm")
    at.clear_caches()
    zero_spgemm_launches()
    pc.LAUNCHES_SPMV = pc.LAUNCHES_SPMM = 0
    try:
        acfg = MatrelConfig(autotune=True, autotune_table_path=path,
                            autotune_max_dim=SPGEMM_CMP_N)
        asess = MatrelSession(config=acfg, device=sess.device)
        sweep = autotune_spgemm_sweep(sess.mesh, path, at, counts)
        queries = autotune_spgemm_queries(sess, asess, at, path)
        spmv = autotune_spmv(sess, asess, at, path, row5_plan, counts)
        X = sess.random((4096, 4096), seed=28)
        attrs = asess.compile(X.multiply(X)).optimized.attrs
        table = at.load_table(path)
        matmul_rows = [k for k in table if len(k.split("|")) == 4]
        if counts["matmul"] or at._CACHE or matmul_rows or (
                attrs["strategy"], attrs["strategy_source"]) != ("xla",
                                                                 "default"):
            raise AssertionError(f"matmul autotune on the 1 x 1 card: "
                                 f"{counts['matmul']} measured, rows "
                                 f"{matmul_rows}, stamp {attrs}")
        torch.cuda.synchronize()
        launches = dict(spgemm_launches(), spmv_compact=pc.LAUNCHES_SPMV,
                        spmm_compact=pc.LAUNCHES_SPMM)
    finally:
        at.measure_strategy = orig["matmul"]
        at.measure_spmv_variant = orig["spmv"]
        at.measure_spgemm_kernel = orig["spgemm"]
        at.clear_caches()
        shutil.rmtree(tmp, ignore_errors=True)
    peak = meter.gib()
    log(f"path autotune: {counts['spgemm']} SpGEMM kernels and "
        f"{counts['spmv']} SpMV variants measured, 0 matmul strategies "
        f"(1 x 1 card: {attrs['strategy']}, {attrs['strategy_source']}); "
        f"{len(table)} table rows; launches {launches}; peak {peak:.3f} GiB "
        f"(bound {NEW_PEAK_LIMIT_GIB['autotune']:.3f})")
    return {"launches": launches, "sweep": sweep, "queries": queries,
            "spmv": spmv, "counts": counts, "peak_gib": peak}



# -- whole-plan fusion: path_fusion -------------------------------------------

#: bench.py's two fusion chains at full width: the PageRank step over a
#: 16,384² f32 A (1 GiB, as path_coo_plane's dense adjacency) and the
#: linreg epilogue over X of 1,000,000 x 1000 f32 (row 3's fit rows)
FUSION_PR_N = 16384
FUSION_LR_ROWS, FUSION_LR_K = 1_000_000, 1000
#: path_fusion's own peak device memory, held under 1.25 × its peak on an
#: H100 (PERF.md section 5)
FUSION_PEAK_LIMIT_GIB = {"fusion": 1.25 * 16.988}


def in_turns(fa, fb, batch: int = 1) -> tuple:
    """(ms of fa, ms of fb), each the mean of two time_ms medians taken
    in the order a, b, b, a (warm, CUDA events, 10 samples a median,
    ``batch`` calls a sample)."""
    a1 = time_ms(fa, warmup=2, runs=10, batch=batch)
    b1 = time_ms(fb, warmup=2, runs=10, batch=batch)
    b2 = time_ms(fb, warmup=2, runs=10, batch=batch)
    a2 = time_ms(fa, warmup=2, runs=10, batch=batch)
    return (a1 + a2) / 2, (b1 + b2) / 2


def fusion_sessions(sess):
    """(a fresh session with ``sess``'s config, the same with
    fusion_enable) on its card."""
    from matrel_tpu_torch import MatrelSession
    return (MatrelSession(config=sess.config, device=sess.device),
            MatrelSession(config=sess.config.replace(fusion_enable=True),
                          device=sess.device))


def fused_region_of(fsess, e):
    """(stamp, members, anchor) of the one fused region of e's plan in
    the fusion session; raises unless there is exactly one, anchored on
    a matmul."""
    from matrel_tpu_torch.ir import fusion as fusion_lib
    stamps = fusion_lib.collect_stamps(fsess.compile(e).optimized)
    if len(stamps) != 1:
        raise AssertionError(f"fusion: {len(stamps)} stamped regions, "
                             f"want 1")
    s = stamps[0]
    members = fusion_lib.region_nodes(s)
    anchor = members.get(s.attrs["fused_anchor"])
    if anchor is None or anchor.kind != "matmul":
        raise AssertionError(f"fusion: region {s.attrs['fused_region']} "
                             f"has no matmul anchor")
    return s, members, anchor


def fusion_chains(sess) -> dict:
    """bench.py's measure_fusion chains at full width, leaves made on the
    card from a seed: {name: (expr, float64 reference, K of its
    product)}."""
    import torch
    dev, n = sess.device, FUSION_PR_N
    gen = torch.Generator(device=dev).manual_seed(31)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    a, r, w = rand(n, n), rand(n, 1), rand(n, 1)
    d = (rand(n, 1) < 0.05).float()
    A, R, W, D = (dense_leaf(sess, t) for t in (a, r, w, d))
    contrib = A.expr().t().multiply(W.expr().elem_multiply(R.expr()))
    dmass = D.expr().elem_multiply(R.expr()).sum().multiply_scalar(1.0 / n)
    pr = contrib.add(dmass).multiply_scalar(0.85).add_scalar(0.15 / n)
    pr_ref = 0.85 * (a.double().T @ (w.double() * r.double())
                     + float((d.double() * r.double()).sum()) / n) \
        + 0.15 / n
    rows, k = FUSION_LR_ROWS, FUSION_LR_K
    x = rand(rows, k)
    X = dense_leaf(sess, x)
    I = dense_leaf(sess, torch.eye(k, device=dev))
    lr = X.expr().t().multiply(X.expr()).multiply_scalar(1.0 / rows) \
        .add(I.expr().multiply_scalar(0.1)) \
        .row_sum().multiply_scalar(1.0 / k)
    g = torch.zeros((k, k), dtype=torch.float64, device=dev)
    for i in range(0, rows, 100_000):
        xc = x[i:i + 100_000].double()
        g += xc.T @ xc
    lr_ref = (g / rows + 0.1 * torch.eye(k, dtype=torch.float64,
                                         device=dev)).sum(1, keepdim=True) / k
    del g
    return {"pagerank_step": (pr, pr_ref, n),
            "linreg_epilogue": (lr, lr_ref, rows)}


def fusion_units(chains) -> dict:
    """(a): each chain through compile_staged_units (fusion off) and
    compile_region_units (fusion on): dispatch counts, outputs bit-equal
    and against float64, warm ms of both (CUDA events, median of 10)."""
    import torch
    from matrel_tpu_torch import executor
    from matrel_tpu_torch.config import default_config
    off = default_config()
    on = off.replace(fusion_enable=True)
    out = {}
    for name, (e, ref, k) in chains.items():
        staged = executor.compile_staged_units(e, None, off)
        fused = executor.compile_region_units(e, None, on)
        regions = sum(1 for u in fused.units if u[3] > 1)
        if regions != 1 or fused.dispatches >= staged.dispatches:
            raise AssertionError(f"fusion {name}: {regions} regions, "
                                 f"{fused.dispatches} fused vs "
                                 f"{staged.dispatches} staged dispatches")
        ys, first_s = synced(staged.run)
        yf, first_f = synced(fused.run)
        if not torch.equal(ys, yf):
            raise AssertionError(f"fusion {name}: region units differ from "
                                 f"staged units")
        err = rel_err(f"fusion {name} vs float64", yf, ref,
                      PROD_C * U32 * math.sqrt(k))
        del ys, yf
        ms_f, ms_s = in_turns(fused.run, staged.run)
        out[name] = {"staged_ms": ms_s, "fused_ms": ms_f,
                     "staged_dispatches": staged.dispatches,
                     "fused_dispatches": fused.dispatches,
                     "max_abs_err": err}
        log(f"path fusion (a) {name}: staged units {staged.dispatches} "
            f"dispatches {ms_s:.4f} ms, region units {fused.dispatches} "
            f"dispatches {ms_f:.4f} ms (warm, in turns; first runs "
            f"{first_s:.3f} / {first_f:.3f} s); outputs "
            f"bit-equal, max abs err {err:.3e} vs float64")
    return out


def fusion_autotune(sess, chains) -> dict:
    """(e): the autotune fuse| family on both chains of (a), its table in
    a temporary file under build/: ms per variant and the winner; the
    compile with autotune on stamps exactly when the winner is not
    "staged", and a persisted "staged" row suppresses the stamp."""
    import shutil
    import tempfile
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.ir import fusion as fusion_lib, rules
    from matrel_tpu_torch.parallel import autotune as at, planner
    os.makedirs(SCRATCH, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=SCRATCH)
    path = os.path.join(tmp, "autotune.json")
    cfg = MatrelConfig(fusion_enable=True, autotune=True,
                       autotune_table_path=path,
                       autotune_max_dim=FUSION_LR_ROWS)
    mesh = sess.mesh
    out = {}
    at.clear_caches()
    try:
        for name, (e, _ref, _k) in chains.items():
            opt = planner.annotate_strategies(
                rules.optimize(e, cfg, grid=mesh.grid, mesh=mesh), mesh, cfg)
            (region,) = fusion_lib.segment(opt, cfg, mesh=mesh)
            best = at.lookup_or_measure_fusion(region, opt, mesh, cfg)
            table = at.load_table(path)
            key = [k for k in table if k.startswith(f"fuse|{region.sig}|")]
            if len(key) != 1 or set(table[key[0]]["times"]) != set(
                    at.FUSION_VARIANTS):
                raise AssertionError(f"fuse| {name}: table rows {key}")
            times = table[key[0]]["times"]
            asess = MatrelSession(config=cfg, device=sess.device)
            stamped = len(fusion_lib.collect_stamps(
                asess.compile(e).optimized))
            if stamped != (0 if best == "staged" else 1):
                raise AssertionError(f"fuse| {name}: winner {best}, "
                                     f"{stamped} stamps")
            at._persist(path, key[0], "staged", times)
            at.clear_caches()
            forced = fusion_lib.collect_stamps(MatrelSession(
                config=cfg, device=sess.device).compile(e).optimized)
            if forced:
                raise AssertionError(f"fuse| {name}: a staged row left "
                                     f"{len(forced)} stamps")
            out[name] = {"key": key[0], "times_ms": {
                v: t * 1e3 for v, t in times.items()}, "winner": best}
            log(f"path fusion (e) {key[0]}: fused "
                f"{times['fused'] * 1e3:.4f} ms, staged "
                f"{times['staged'] * 1e3:.4f} ms (probes, CUDA events, "
                f"median of 5), winner {best}; {stamped} stamp with "
                f"autotune on, none once the row says staged")
    finally:
        at.clear_caches()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def fusion_coo_step(sess, fsess) -> dict:
    """(b): the PageRank step with Âᵀ as row 5's COOMatrix through
    compute, fusion on and off: the stamped region (anchor on the COO
    leaf, the w∘r prologue, the epilogue), B2 launched inside it,
    results bit-equal, against float64 scipy, warm latency of both."""
    import numpy as np
    import scipy.sparse as sps
    import torch
    from matrel_tpu_torch.ops import pallas_spmv as pc
    src, dst, A = row5_matrix()
    n, dev = ROW5_N, sess.device
    gen = torch.Generator(device=dev).manual_seed(32)
    r = torch.rand((n, 1), generator=gen, device=dev)
    r /= r.sum()
    w = torch.rand((n, 1), generator=gen, device=dev)
    d = (torch.rand((n, 1), generator=gen, device=dev) < 0.05).float()
    R, W, D = (dense_leaf(sess, t) for t in (r, w, d))
    dmass = D.expr().elem_multiply(R.expr()).sum().multiply_scalar(1.0 / n)
    e = A.multiply(W.expr().elem_multiply(R.expr())).add(dmass) \
        .multiply_scalar(0.85).add_scalar(0.15 / n)
    s, members, anchor = fused_region_of(fsess, e)
    pro = anchor.children[1]
    census = s.attrs["fused_census"]
    if (anchor.children[0].kind != "coo_leaf" or pro.uid not in members
            or pro.kind != "elemwise" or not {"scalar.mul", "scalar.add",
                                              "elemwise.add"} <= set(census)):
        raise AssertionError(f"fusion (b): region {s.attrs['fused_region']}"
                             f" anchor {[c.kind for c in anchor.children]}")
    pc.LAUNCHES_SPMV = 0
    yf = fsess.compute(e)
    torch.cuda.synchronize()
    l_fused = pc.LAUNCHES_SPMV
    ys = sess.compute(e)
    torch.cuda.synchronize()
    launches = pc.LAUNCHES_SPMV
    if l_fused < 1:
        raise AssertionError("fusion (b): B2 was not launched inside the "
                             "fused region")
    if not torch.equal(yf.data, ys.data):
        raise AssertionError("fusion (b): fused and unfused steps differ")
    a64 = sps.csr_matrix((A.vals.astype(np.float64), (A.rows, A.cols)),
                         shape=(n, n))
    r64, w64, d64 = (t.double().cpu().numpy() for t in (r, w, d))
    ref = 0.85 * (a64 @ (w64 * r64) + float((d64 * r64).sum()) / n) \
        + 0.15 / n
    err = rel_err("fusion (b) vs float64", yf.data,
                  torch.as_tensor(ref, device=dev), SPMV_ORACLE_TOL[3])
    del yf, ys, a64
    ms_f, ms_s = in_turns(lambda: fsess.compute(e), lambda: sess.compute(e))
    log(f"path fusion (b) COO PageRank step ({n} nodes, {A.nnz} edges): "
        f"region "
        f"{s.attrs['fused_region']} anchored on A·(w∘r), {l_fused} B2 "
        f"launches inside it ({launches} with the unfused twin), results "
        f"bit-equal, max abs err {err:.3e} vs float64; warm compute() "
        f"{ms_f:.4f} ms fused, {ms_s:.4f} ms unfused (in turns)")
    return {"launches": launches, "fused_ms": ms_f, "unfused_ms": ms_s,
            "region": s.attrs["fused_region"]}


def fusion_spgemm(sess, fsess) -> dict:
    """(c): path_spgemm's four S×S queries at n = 32,768 under the
    zero-preserving chain ((A·B)·0.5)^2, fusion on and off: the epilogue
    mode (tilewise on B5-B7's classes, dense on the generic one), the
    kernel launched inside the region, results bit-equal, warm latency
    of both."""
    import torch
    from matrel_tpu_torch.ir import fusion as fusion_lib
    from matrel_tpu_torch.ops import kernel_registry as kr
    launches = dict.fromkeys(SPGEMM_REPLACES, 0)
    rows = {}
    for name, kid, A, B, dtype_name in spgemm_pairs_at(
            sess.mesh, SPGEMM_CMP_N, random_seeds=(2, 3)):
        e = A.multiply(B).multiply_scalar(0.5).power(2.0)
        s, members, anchor = fused_region_of(fsess, e)
        ew = fusion_lib.epilogue_elementwise_chain(s, members, anchor.uid)
        mode = kr.epilogue_mode(kr.pair_class_of(A, B), ew)
        want = "dense" if name == "spgemm_pairs" else "tilewise"
        if anchor.attrs.get("spgemm_kernel") != kid or mode != want:
            raise AssertionError(f"fusion (c) {name}: kernel "
                                 f"{anchor.attrs.get('spgemm_kernel')}, "
                                 f"mode {mode} (want {kid}, {want})")
        zero_spgemm_launches()
        yf = fsess.compute(e)
        torch.cuda.synchronize()
        l_fused = spgemm_launches()[name]
        ys = sess.compute(e)
        torch.cuda.synchronize()
        got = spgemm_launches()
        if l_fused < 1:
            raise AssertionError(f"fusion (c) {name}: not launched inside "
                                 f"the region")
        for k, v in got.items():
            launches[k] += v
        n = A.shape[0]
        if (yf.shape != (n, n) or not torch.equal(yf.data, ys.data)
                or not bool(torch.isfinite(yf.data).all())):
            raise AssertionError(f"fusion (c) {name}: fused and unfused "
                                 f"results differ")
        del yf, ys
        ms_f, ms_s = in_turns(lambda: fsess.compute(e),
                              lambda: sess.compute(e))
        log(f"path fusion (c) S×S {name} ({kid}, {dtype_name}, bs "
            f"{A.block_size}) under ((A·B)·0.5)^2: epilogue {mode}, "
            f"launches {got}, results bit-equal; warm compute() "
            f"{ms_f:.4f} ms fused, {ms_s:.4f} ms unfused (in turns); "
            f"device time, fused then unfused:")
        rows[name] = {"mode": mode, "fused_ms": ms_f, "unfused_ms": ms_s,
                      "fused_device_ms": device_split(
                          lambda: fsess.compute(e), top=6),
                      "unfused_device_ms": device_split(
                          lambda: sess.compute(e), top=6)}
        torch.cuda.empty_cache()
    return {"launches": launches, "rows": rows}


def fusion_spmm(sess, fsess) -> dict:
    """(d): row 4's S·D (bf16, B1's wgmma body) under ·0.5, fusion on and
    off: the epilogue through spmm.apply's slot, results bit-equal, warm
    latency of both."""
    import torch
    from matrel_tpu_torch.ops import pallas_spmm
    S, D = row4_inputs(sess)
    e = S.multiply(D).multiply_scalar(0.5)
    s, _members, _anchor = fused_region_of(fsess, e)
    pallas_spmm.LAUNCHES = 0
    bodies0 = dict(pallas_spmm.BODY_LAUNCHES)
    yf = fsess.compute(e)
    torch.cuda.synchronize()
    l_fused = pallas_spmm.LAUNCHES
    ys = sess.compute(e)
    torch.cuda.synchronize()
    launches = pallas_spmm.LAUNCHES
    bodies = {b: v - bodies0[b] for b, v in
              pallas_spmm.BODY_LAUNCHES.items() if v != bodies0[b]}
    if l_fused < 1 or bodies != {"wgmma": launches}:
        raise AssertionError(f"fusion (d): B1 {l_fused} launches inside the "
                             f"region, bodies {bodies}")
    if not torch.equal(yf.data, ys.data):
        raise AssertionError("fusion (d): fused and unfused S·D·0.5 differ")
    del yf, ys
    ms_f, ms_s = in_turns(lambda: fsess.compute(e), lambda: sess.compute(e))
    log(f"path fusion (d) row 4 S·D·0.5 (bf16, wgmma): region "
        f"{s.attrs['fused_region']}, {launches} B1 launches, results "
        f"bit-equal; warm compute() {ms_f:.4f} ms fused, {ms_s:.4f} ms "
        f"unfused (in turns); device time, fused then unfused:")
    device_split(lambda: fsess.compute(e))
    device_split(lambda: sess.compute(e))
    return {"launches": launches, "bodies": bodies, "fused_ms": ms_f,
            "unfused_ms": ms_s}


def path_fusion(sess) -> dict:
    """Whole-plan fusion on the card, under the path's own peak-memory
    bound: (a) bench.py's two chains as staged and region units, (e) the
    autotune fuse| family on them, (b) the COO PageRank step, (c) the
    four S×S queries under an epilogue, (d) row 4's S·D under one.
    Launches counted from 0 in each."""
    import torch
    meter = PeakMeter("fusion", FUSION_PEAK_LIMIT_GIB)
    base, fsess = fusion_sessions(sess)
    chains = fusion_chains(sess)
    units = fusion_units(chains)
    peaks = {"a": meter.gib()}
    tuned = fusion_autotune(sess, chains)
    peaks["e"] = meter.gib()
    del chains
    torch.cuda.empty_cache()
    coo = fusion_coo_step(base, fsess)
    peaks["b"] = meter.gib()
    torch.cuda.empty_cache()
    sxs = fusion_spgemm(base, fsess)
    peaks["c"] = meter.gib()
    spmm = fusion_spmm(base, fsess)
    peak = meter.gib()
    log(f"path fusion: peak {peak:.3f} GiB (bound "
        f"{FUSION_PEAK_LIMIT_GIB['fusion']:.3f}); the peak so far after "
        + ", ".join(f"({k}) {v:.3f}" for k, v in peaks.items()) + " GiB")
    return {"launches": dict(sxs["launches"], spmv_compact=coo["launches"],
                             spmm_blocksparse=spmm["launches"]),
            "spmm_bodies": spmm["bodies"], "units": units, "autotune": tuned,
            "coo": coo, "spgemm": sxs["rows"], "spmm": spmm,
            "peak_gib": peak}


# -- the serving plane (path_serving) ------------------------------------------

#: (a) the tenants' stride weights, the admission width, the in-flight
#: bound, the cache budget; 4 threads x 12 submissions.
SERVE_WEIGHTS = "a:3,b:1"
SERVE_THREADS, SERVE_PER_THREAD = 4, 12
SERVE_BATCH, SERVE_INFLIGHT = 6, 2
SERVE_CACHE_BYTES = 8 << 30
#: (b) a budget below the mix's result bytes (row 4's 98 MiB bf16 and
#: row 1's 64 MiB cannot both stay) and the order the mix is run in.
SERVE_EVICT_BYTES = 160 << 20
SERVE_EVICT_ORDER = ("row4 S·D", "row1 4096^2", "row2 A·B·C", "row5 A·x",
                     "row4 S·D", "row2 A·B·C", "row1 4096^2", "row5 A·x",
                     "row4 S·D", "row1 4096^2")
#: (d) the streaming dashboard: n (a 1 GiB f32 0/1 adjacency), edges a
#: batch, window, feature width, and the ticks timed after one warm tick.
SERVE_IVM_N, SERVE_IVM_BATCH, SERVE_IVM_WINDOW, SERVE_IVM_K = \
    16_384, 64, 8, 32
SERVE_IVM_TICKS = 6
#: (e) S×S at path_spgemm's compute scale: 1% random 512-blocks of 0/1
#: f32 entries (integer products: the patch and the recompute are exact
#: in f32), and the COO delta's entry count.
SERVE_SPARSE_N, SERVE_SPARSE_BS, SERVE_SPARSE_DENS = 32_768, 512, 0.01
SERVE_SPARSE_EDGES = 64
#: The sub-phases' peak device memory over what was held when each
#: started, measured on the H100 (PERF.md, PR 14), plus 25%.
SERVE_PEAK_LIMIT_GIB = {k: 1.25 * v for k, v in {
    "serve_submit": 0.246, "serve_evict": 0.311, "serve_cse": 1.819,
    "serve_ivm_dense": 29.142, "serve_ivm_sparse": 20.372}.items()}


def serve_counts() -> dict:
    """The launch counts path_serving reads: B1 (with its bodies), B2
    and the four S×S kernels."""
    from matrel_tpu_torch.ops import pallas_spmm, pallas_spmv as pc
    return dict(spgemm_launches(), spmm_blocksparse=pallas_spmm.LAUNCHES,
                spmv_compact=pc.LAUNCHES_SPMV,
                **{f"b1_{b}": v for b, v in
                   pallas_spmm.BODY_LAUNCHES.items()})


def counts_since(c0: dict) -> dict:
    return {k: v - c0[k] for k, v in serve_counts().items()}


def serve_queries(sess) -> dict:
    """The mix: row 4's S·D (B1, bf16), row 5's A·x (B2, 1M nodes / 10M
    edges), row 2's chain and row 1's 4096² product — each a builder of
    a fresh expression tree, as independent clients would send them."""
    from matrel_tpu_torch.workloads import chain_bench
    S, D = row4_inputs(sess)
    _src, _dst, A = row5_matrix()
    x = sess.random((ROW5_N, 1), seed=6)
    mats = chain_bench.skewed_abc(sess.mesh, n=10_000, mid=100, seed=3)
    X = sess.random((4096, 4096), seed=4)
    Y = sess.random((4096, 4096), seed=5)
    return {"row4 S·D": lambda: S.multiply(D),
            "row5 A·x": lambda: A.multiply(x),
            "row2 A·B·C": lambda: chain_bench.build_chain(mats),
            "row1 4096^2": lambda: X.multiply(Y)}


def percentile(xs, q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(xs, np.float64), q))


def serving_submit(dev, qs: dict, want: dict) -> dict:
    """(a) Four threads (tenants a, a, b, b) submit 48 queries: each its
    first distinct query, then — once all four answered — 11 more of
    the mix. Every answer bit-equal to compute() on a cache-off session;
    hits = submissions − distinct queries; B1 and B2 launch only for the
    first computations; a 0.001 ms deadline fails typed."""
    import threading
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.resilience import DeadlineExceeded
    meter = PeakMeter("serve_submit", SERVE_PEAK_LIMIT_GIB)
    sess = MatrelSession(config=MatrelConfig(
        serve_tenant_weights=SERVE_WEIGHTS, serve_max_batch=SERVE_BATCH,
        serve_max_inflight=SERVE_INFLIGHT,
        result_cache_max_bytes=SERVE_CACHE_BYTES), device=dev)
    names = list(qs)
    lat = {"a": [], "b": []}
    answers, errors = [], []
    lock = threading.Lock()
    first_done = threading.Barrier(SERVE_THREADS + 1, timeout=900)
    go_on = threading.Barrier(SERVE_THREADS + 1, timeout=900)

    def one(name, tenant):
        t0 = time.perf_counter()
        fut = sess.submit(qs[name](), tenant=tenant)
        out = fut.result(timeout=900)
        if fut.ready_event is not None:
            fut.ready_event.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        with lock:
            lat[tenant].append(ms)
            answers.append((name, tenant, out))

    def client(i):
        tenant = "a" if i < SERVE_THREADS // 2 else "b"
        try:
            torch.cuda.set_device(dev)
            one(names[i % len(names)], tenant)
            first_done.wait()
            go_on.wait()
            for j in range(1, SERVE_PER_THREAD):
                one(names[(i + j) % len(names)], tenant)
        except BaseException as ex:      # noqa: BLE001 — re-raised below
            errors.append(ex)
            first_done.abort()
            go_on.abort()

    c0 = serve_counts()
    threads = [threading.Thread(target=client, args=(i,), daemon=True)
               for i in range(SERVE_THREADS)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    try:
        first_done.wait()
        torch.cuda.synchronize()
        first = counts_since(c0)
        go_on.wait()
    except threading.BrokenBarrierError:
        first = None
    for t in threads:
        t.join(timeout=900)
    wall_s = time.perf_counter() - t0
    if errors or first is None or any(t.is_alive() for t in threads):
        raise AssertionError(f"serve (a): clients failed: {errors!r}")
    torch.cuda.synchronize()
    total = counts_since(c0)
    info = sess.result_cache_info()
    n_sub = SERVE_THREADS * SERVE_PER_THREAD
    if len(answers) != n_sub:
        raise AssertionError(f"serve (a): {len(answers)} answers of "
                             f"{n_sub}")
    if info["hits"] != n_sub - len(names) or info["misses"] != len(names):
        raise AssertionError(f"serve (a): cache {info}, want "
                             f"{n_sub - len(names)} hits and "
                             f"{len(names)} misses")
    for k in ("spmm_blocksparse", "spmv_compact"):
        if first[k] < 1 or total[k] != first[k]:
            raise AssertionError(f"serve (a): {k} launches {first[k]} for "
                                 f"the first computations, {total[k]} in "
                                 f"all: want >= 1, and none after")
    for name, _tenant, out in answers:
        if not torch.equal(out.data, want[name].data):
            raise AssertionError(f"serve (a) {name}: not bit-equal to "
                                 f"compute() on a cache-off session")
    late = sess.submit(qs["row1 4096^2"](), deadline_ms=0.001)
    try:
        late.result(timeout=900)
    except DeadlineExceeded:
        pass
    else:
        raise AssertionError("serve (a): a 0.001 ms deadline was met")
    sess.serve_close(timeout=900)
    served = {t: len(v) for t, v in lat.items()}
    row = {"submissions": n_sub, "distinct": len(names),
           "served": served, "hits": info["hits"],
           "misses": info["misses"], "batches": sess._serve.batches,
           "wall_s": wall_s,
           "latency_ms": {t: {"p50": percentile(v, 50),
                              "p99": percentile(v, 99)}
                          for t, v in lat.items()},
           "launches_first": {k: first[k] for k in
                              ("spmm_blocksparse", "spmv_compact")},
           "cache_bytes": info["bytes"], "peak_gib": meter.gib()}
    log(f"serve (a): {n_sub} submissions by {SERVE_THREADS} threads "
        f"(weights {SERVE_WEIGHTS}) in {row['batches']} batches, "
        f"{wall_s:.3f} s; served {served}; cache hits {info['hits']} = "
        f"{n_sub} - {len(names)} distinct; B1 / B2 launched "
        f"{first['spmm_blocksparse']} / {first['spmv_compact']} times, all "
        f"for the first computations; submit-to-result ms (host clock, "
        f"synchronised) " + "; ".join(
            f"{t}: p50 {d['p50']:.3f} p99 {d['p99']:.3f}"
            for t, d in row["latency_ms"].items())
        + "; every answer bit-equal to compute(); the 0.001 ms deadline "
        f"failed typed; peak {row['peak_gib']:.3f} GiB")
    return row


def serving_evict(dev, qs: dict, want: dict) -> dict:
    """(b) The mix run one submission at a time under a 160 MiB budget:
    after every answer the cache's bytes stay within the budget and its
    entries, in LRU order, are those of a byte-budgeted LRU model over
    the same sizes; every answer bit-equal to compute()."""
    import torch
    from collections import OrderedDict
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.serve.result_cache import result_nbytes
    meter = PeakMeter("serve_evict", SERVE_PEAK_LIMIT_GIB)
    sess = MatrelSession(config=MatrelConfig(
        result_cache_max_bytes=SERVE_EVICT_BYTES,
        serve_max_batch=SERVE_BATCH), device=dev)
    sizes = {k: result_nbytes(v) for k, v in want.items()}
    model: "OrderedDict[str, int]" = OrderedDict()
    evicted = hits = 0
    latest = {}
    for name in SERVE_EVICT_ORDER:
        out = sess.submit(qs[name]()).result(timeout=900)
        if not torch.equal(out.data, want[name].data):
            raise AssertionError(f"serve (b) {name}: not bit-equal to "
                                 f"compute()")
        latest[name] = out
        if name in model:
            model.move_to_end(name)
            hits += 1
        elif sizes[name] <= SERVE_EVICT_BYTES:
            model[name] = sizes[name]
            while sum(model.values()) > SERVE_EVICT_BYTES:
                model.popitem(last=False)
                evicted += 1
        got = []
        for _k, ent in sess._result_cache.items_snapshot():
            got.append(next(n for n, o in latest.items()
                            if o is ent.result))
        info = sess.result_cache_info()
        if info["bytes"] > SERVE_EVICT_BYTES:
            raise AssertionError(f"serve (b): {info['bytes']} bytes cached "
                                 f"> budget {SERVE_EVICT_BYTES}")
        if got != list(model) or info["evicted"] != evicted \
                or info["hits"] != hits:
            raise AssertionError(f"serve (b) after {name}: entries {got}, "
                                 f"LRU model {list(model)}; info {info}")
    sess.serve_close(timeout=900)
    row = {"budget_bytes": SERVE_EVICT_BYTES, "sizes": sizes,
           "submissions": len(SERVE_EVICT_ORDER), "hits": hits,
           "evicted": evicted, "peak_gib": meter.gib()}
    log(f"serve (b): {len(SERVE_EVICT_ORDER)} submissions under a "
        f"{SERVE_EVICT_BYTES >> 20} MiB budget (result bytes "
        + ", ".join(f"{k} {v}" for k, v in sizes.items())
        + f"): {evicted} LRU evictions and {hits} hits, as the model "
        f"predicts after every answer, bytes never over the budget, every "
        f"answer bit-equal to compute(); peak {row['peak_gib']:.3f} GiB")
    return row


def cse_batch(S, D):
    """Six consumers of row 4's S·D, each with its own S·D subtree:
    scaled (×2, ×0.5), shifted (+1), transposed, and the row and column
    sums of its entries squared."""
    def sd():
        return S.multiply(D)
    return [sd().multiply_scalar(2.0), sd().multiply_scalar(0.5),
            sd().add_scalar(1.0), sd().t(),
            sd().elem_multiply(sd()).row_sum(),
            sd().elem_multiply(sd()).col_sum()]


def serving_cse(dev, qs: dict) -> dict:
    """(c) One batch of six queries sharing row 4's S·D as an interior:
    with cse_enable the interior is hoisted — B1 launches once for the
    batch — and every answer is bit-equal to the same batch un-hoisted
    (whose plan rewrites the transposed consumer t(S·D) into Dᵀ·Sᵀ, which
    the executor runs as B1's S·D on D, transposed); warm ms of both
    batches, in turns."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    meter = PeakMeter("serve_cse", SERVE_PEAK_LIMIT_GIB)
    S, D = (c.attrs["matrix"] for c in qs["row4 S·D"]().children)
    on = MatrelSession(config=MatrelConfig(cse_enable=True), device=dev)
    off = MatrelSession(device=dev)
    c0 = serve_counts()
    hoisted = on.run_many(cse_batch(S, D))
    torch.cuda.synchronize()
    l_on = counts_since(c0)
    c1 = serve_counts()
    plain = off.run_many(cse_batch(S, D))
    torch.cuda.synchronize()
    l_off = counts_since(c1)
    if l_on["spmm_blocksparse"] != 1:
        raise AssertionError(f"serve (c): B1 launched "
                             f"{l_on['spmm_blocksparse']} times for the "
                             f"hoisted batch, want 1")
    info = on.mqo_info()
    if info["cse_hoisted"] != 1 or info["cse_batches"] != 1:
        raise AssertionError(f"serve (c): mqo {info}")
    for k, (h, p) in enumerate(zip(hoisted, plain)):
        if not torch.equal(h.data, p.data):
            raise AssertionError(f"serve (c) consumer {k}: not bit-equal "
                                 f"to the un-hoisted batch")
    uses = [cse_uses(sub) for _orig, sub in on._mqo.recent]
    del hoisted, plain
    ms_on, ms_off = in_turns(lambda: on.run_many(cse_batch(S, D)),
                             lambda: off.run_many(cse_batch(S, D)))
    row = {"consumers": 6, "b1_hoisted": l_on["spmm_blocksparse"],
           "b1_unhoisted": l_off["spmm_blocksparse"], "mqo": info,
           "hoist_uses": uses,
           "warm_ms_hoisted": ms_on, "warm_ms_unhoisted": ms_off,
           "peak_gib": meter.gib()}
    log(f"serve (c): six consumers of row 4's S·D in one run_many batch: "
        f"hoisted, B1 launched {row['b1_hoisted']} time (un-hoisted: "
        f"{row['b1_unhoisted']}); all six answers bit-equal to the "
        f"un-hoisted batch; warm {ms_on:.3f} ms "
        f"hoisted vs {ms_off:.3f} ms un-hoisted a batch (CUDA events, in "
        f"turns); the hoist's cse stamp counts {uses[-1]} uses; mqo "
        f"{info}; peak {row['peak_gib']:.3f} GiB")
    return row


def cse_uses(e):
    """The ``uses`` of the first cse-stamped leaf under ``e``."""
    stamp = e.attrs.get("cse")
    if stamp is not None:
        return stamp["uses"]
    for c in e.children:
        got = cse_uses(c)
        if got is not None:
            return got
    return None


def ivm_tick(g, mode: str):
    """One dashboard tick: the update (register_delta or a plain
    register) then all five queries, synchronised; (record, answers,
    ms)."""
    import torch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rec = g.step_delta() if mode == "patch" else g.step_rebind()
    outs = {k: g.sess.run(q) for k, q in g.queries().items()}
    torch.cuda.synchronize()
    return rec, outs, (time.perf_counter() - t0) * 1e3


def serving_ivm_dense(dev) -> dict:
    """(d) The streaming dashboard at n = 16,384 through two sessions of
    the same seed, in turns: register_delta (patch mode) and a plain
    register (rebind mode). One warm tick, then 6 timed. Every tick the
    integer queries are bit-equal between the modes and to float64 on
    the card (torch.matmul of the adjacency, independent of the
    session); feature_product is within the f32 bound
    (γ_n + t·(γ_c + 2u))·(A_cum·F) of float64, A_cum the adjacency plus
    every |ΔA| so far."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.workloads.streaming import StreamingGraph
    meter = PeakMeter("serve_ivm_dense", SERVE_PEAK_LIMIT_GIB)
    cfg = MatrelConfig(result_cache_max_bytes=SERVE_CACHE_BYTES)
    n, c = SERVE_IVM_N, 4 * SERVE_IVM_BATCH
    graphs = {mode: StreamingGraph(
        MatrelSession(config=cfg, device=dev), n=n,
        batch_edges=SERVE_IVM_BATCH, window=SERVE_IVM_WINDOW,
        feature_k=SERVE_IVM_K, seed=0) for mode in ("patch", "rebind")}
    for g in graphs.values():
        for q in g.queries().values():
            g.sess.run(q)
    torch.cuda.synchronize()
    u = 2.0 ** -24
    gamma = lambda k: k * u / (1 - k * u)        # noqa: E731
    with meter.aside():
        feats64 = torch.from_numpy(graphs["patch"].feats).to(dev).double()
        a_prev = torch.from_numpy(graphs["patch"].adj).to(dev).double()
        a_cum = a_prev.clone()
    ms = {"patch": [], "rebind": []}
    pr_ms, pr_err = [], []
    recs = []
    worst = 0.0
    for tick in range(1 + SERVE_IVM_TICKS):
        outs = {}
        for mode, g in graphs.items():
            rec, outs[mode], t_ms = ivm_tick(g, mode)
            if tick:
                ms[mode].append(t_ms)
                if mode == "patch":
                    recs.append(rec)
        if not (graphs["patch"].adj == graphs["rebind"].adj).all():
            raise AssertionError("serve (d): the two streams diverged")
        # the dashboard's PageRank: warm-restarted over each session's
        # binding on the card (cold on the first tick)
        r0 = graphs["patch"]._pr
        prs = {}
        for mode, g in graphs.items():
            prs[mode], pr_s = synced(g.pagerank)
            if mode == "patch":
                pr_ms.append(pr_s * 1e3)
        if not torch.equal(prs["patch"], prs["rebind"]):
            raise AssertionError(f"serve (d) tick {tick}: PageRank differs "
                                 f"between the modes")
        with meter.aside():
            a64 = torch.from_numpy(graphs["patch"].adj).to(dev).double()
            a_cum += (a64 - a_prev).abs()
            a_prev = a64
            aa = a64 @ a64
            want = {"degrees": a64.sum(1, keepdim=True),
                    "label_counts": a64 @ torch.from_numpy(
                        graphs["patch"].onehot).to(dev).double(),
                    "common_neighbors": aa,
                    "triangles6": (aa * a64.T).sum().reshape(1, 1)}
            for k, w in want.items():
                p, r = outs["patch"][k], outs["rebind"][k]
                pv = p.data[:w.shape[0], :w.shape[1]]
                rv = r.data[:w.shape[0], :w.shape[1]]
                if not (torch.equal(pv, rv) and torch.equal(pv.double(), w)):
                    raise AssertionError(f"serve (d) tick {tick} {k}: "
                                         f"patch / rebind / float64 differ")
            del aa, want
            # PageRank against the float64 fixed point of the oracle's
            # adjacency: the iteration contracts by alpha in L1, so k
            # rounds from r0 land within alpha^k·|r0 - r*| (its early
            # stop at a step below 1e-10 within alpha/(1-alpha)·1e-10)
            star = pagerank_f64(a64)
            if r0 is None:
                r0 = torch.full_like(star, 1.0 / n)
                k = 60
            else:
                k = 8
            err = float((prs["patch"] - star).abs().sum())
            bound = (SERVE_PR_ALPHA ** k * float((r0 - star).abs().sum())
                     + 1e-9)
            if not (math.isfinite(err) and err <= bound):
                raise AssertionError(f"serve (d) tick {tick}: PageRank "
                                     f"|r - r*|_1 {err} > {bound}")
            pr_err.append({"rounds": k, "l1_err": err, "bound": bound})
            del star
            f64 = a64 @ feats64
            bound = ((gamma(n) + (tick + 1) * (gamma(c) + 2 * u))
                     * (a_cum @ feats64))
            for mode in ("patch", "rebind"):
                got = outs[mode]["feature_product"].data[:n, :]
                err = (got.double() - f64).abs()
                if bool((err > bound).any()):
                    raise AssertionError(f"serve (d) tick {tick} "
                                         f"feature_product ({mode}) outside "
                                         f"its f32 bound")
                worst = max(worst, float((err / bound.clamp_min(1e-300))
                                         .max()))
            del f64, bound, err, a64
        del outs
    med = {k: statistics.median(v) for k, v in ms.items()}
    row = {"n": n, "ticks": SERVE_IVM_TICKS, "median_ms": med,
           "speedup": med["rebind"] / med["patch"],
           "patched": sum(r["patched"] for r in recs),
           "killed": sum(r["killed"] for r in recs),
           "reused_plans": sum(r["reused_plans"] for r in recs),
           "priced_out": sum(r["priced_out"] for r in recs),
           "rules": recs[-1]["rules"],
           "feature_err_over_bound": worst,
           "pagerank_cold_ms": pr_ms[0],
           "pagerank_warm_median_ms": statistics.median(pr_ms[1:]),
           "pagerank": pr_err, "peak_gib": meter.gib()}
    log(f"serve (d): dashboard n={n} (batch {SERVE_IVM_BATCH} edges, "
        f"window {SERVE_IVM_WINDOW}, k={SERVE_IVM_K}), {SERVE_IVM_TICKS} "
        f"ticks after a warm one: median {med['patch']:.3f} ms a tick "
        f"patched vs {med['rebind']:.3f} ms rebound "
        f"({row['speedup']:.2f}x); patched {row['patched']}, killed "
        f"{row['killed']}, reused plans {row['reused_plans']}, priced out "
        f"{row['priced_out']}, rules {row['rules']}; integer queries "
        f"bit-equal between the modes and to float64 every tick; "
        f"feature_product worst err / bound {worst:.3e}; PageRank over "
        f"the binding {pr_ms[0]:.3f} ms cold (60 rounds), "
        f"{row['pagerank_warm_median_ms']:.3f} ms warm (8 rounds, median), "
        f"equal between the modes, within alpha^k·|r0 - r*| of float64 "
        f"every tick (last |r - r*|_1 {pr_err[-1]['l1_err']:.3e}); peak "
        f"{row['peak_gib']:.3f} GiB")
    return row


#: PageRank's damping in the dashboard (StreamingGraph.pagerank's).
SERVE_PR_ALPHA = 0.85


def pagerank_f64(a64, rounds: int = 400, tol: float = 1e-14):
    """The float64 oracle: power iteration from uniform over the
    adjacency ``a64`` to its fixed point (dangling mass spread
    uniformly), independent of the port."""
    import torch
    n = a64.shape[0]
    deg = a64.sum(1)
    w = torch.where(deg > 0, 1.0 / deg.clamp_min(1.0), 0.0)
    dangling = deg == 0
    r = torch.full((n,), 1.0 / n, dtype=torch.float64, device=a64.device)
    for _ in range(rounds):
        nxt = (SERVE_PR_ALPHA * (torch.mv(a64.T, w * r)
                                 + r[dangling].sum() / n)
               + (1.0 - SERVE_PR_ALPHA) / n)
        done = float((nxt - r).abs().sum()) < tol
        r = nxt
        if done:
            break
    return r


def serving_ivm_sparse(dev) -> dict:
    """(e) S×S at n = 32,768 cached (B4), then a 64-entry COO delta
    through register_delta in force mode — the estimate alone prices
    this patch out (two n² combines against a 1%-dense product), so the
    mode is forced as tests/test_delta.py forces it — through the
    SpGEMM form of _delta_product (ΔS·S and S'·ΔS; launches counted),
    within that test's atol 1e-4 of a full recompute; ms of the patch
    against the recompute."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.ir import delta as delta_lib
    meter = PeakMeter("serve_ivm_sparse", SERVE_PEAK_LIMIT_GIB)
    n, bs = SERVE_SPARSE_N, SERVE_SPARSE_BS
    sess = MatrelSession(config=MatrelConfig(
        result_cache_max_bytes=SERVE_CACHE_BYTES,
        delta_patch_mode="force"), device=dev)
    S = BlockSparseMatrix.random((n, n), SERVE_SPARSE_DENS, block_size=bs,
                                 mesh=sess.mesh, seed=21)
    S.blocks = (S.blocks < 0.2).float()       # 0/1 entries
    sess.register("S", S)

    def query():
        return sess.table("S").multiply(sess.table("S"))
    c_cold = serve_counts()
    Y0, cold_s = synced(lambda: sess.run(query()))
    l_cold = {k: v for k, v in counts_since(c_cold).items()
              if k in SPGEMM_REPLACES}
    stamp = sess.compile(query()).optimized.attrs.get("spgemm_kernel")
    del Y0
    rng = np.random.default_rng(22)
    rows = rng.integers(0, n, SERVE_SPARSE_EDGES)
    cols = rng.integers(0, n, SERVE_SPARSE_EDGES)
    vals = np.ones(SERVE_SPARSE_EDGES, np.float32)
    old = sess.table("S")
    d = delta_lib.as_delta((rows, cols, vals), old, "coo")
    (_k, ent), = sess._result_cache.items_snapshot()
    spec = delta_lib.derive_patch(ent.expr, old,
                                  d.apply_to(old, sess.mesh, sess.config),
                                  d, ent.result, sess.mesh, sess.config)
    del ent
    c0 = serve_counts()
    rec, patch_s = synced(lambda: sess.register_delta(
        "S", (rows, cols, vals), kind="coo"))
    l_patch = {k: v for k, v in counts_since(c0).items()
               if k in SPGEMM_REPLACES}
    if rec["patched"] != 1 or rec["rules"].get("spgemm", 0) < 1:
        raise AssertionError(f"serve (e): {rec}")
    if l_patch["spgemm_pairs"] < 1:
        raise AssertionError(f"serve (e): the patch launched {l_patch}, "
                             f"want B4 (spgemm_pairs)")
    hits0 = sess.result_cache_info()["hits"]
    got = sess.run(query())
    if sess.result_cache_info()["hits"] != hits0 + 1:
        raise AssertionError("serve (e): the re-run did not hit the "
                             "patched entry")
    fresh = MatrelSession(device=dev)
    S1 = sess.table("S")
    want, recompute_s = synced(lambda: fresh.compute(S1.multiply(S1)))
    warm_ms = time_ms(lambda: fresh.compute(S1.multiply(S1)), warmup=1,
                      runs=5)
    with meter.aside():
        err = 0.0
        for r in range(0, n, 4096):
            diff = (got.data[r:r + 4096] - want.data[r:r + 4096]).abs()
            err = max(err, float(diff.max()))
        if not err <= 1e-4:
            raise AssertionError(f"serve (e): patched S·S differs from the "
                                 f"recompute by {err} > 1e-4")
    del got, want
    row = {"n": n, "nnzb": S.nnzb, "delta_entries": SERVE_SPARSE_EDGES,
           "stamp": stamp, "cold_compute_s": cold_s,
           "cold_launches": l_cold, "patch_ms": patch_s * 1e3,
           "patch_launches": l_patch, "rules": rec["rules"],
           "recompute_ms": recompute_s * 1e3, "recompute_warm_ms": warm_ms,
           "est_patch_flops": spec.est_patch_flops,
           "est_full_flops": spec.est_full_flops, "max_abs_err": err,
           "peak_gib": meter.gib()}
    log(f"serve (e): S·S n={n} ({S.nnzb} tiles of {bs}, stamp {stamp}) "
        f"cached in {cold_s:.3f} s; a {SERVE_SPARSE_EDGES}-entry COO "
        f"delta patched in {row['patch_ms']:.3f} ms (register_delta, "
        f"synchronised; rules {rec['rules']}, S×S launches {l_patch}) vs "
        f"a recompute of {row['recompute_ms']:.3f} ms cold / "
        f"{warm_ms:.3f} ms warm; the estimate alone prices the patch at "
        f"{spec.est_patch_flops:.4g} FLOPs against "
        f"{spec.est_full_flops:.4g} (force mode); max |patched - "
        f"recompute| {err:.3e}; peak {row['peak_gib']:.3f} GiB")
    return row


def path_serving(sess) -> dict:
    """The serving plane on the card (serve/, ir/delta.py): (a)
    concurrent submit by two tenants, (b) LRU eviction under a budget,
    (c) cross-query CSE, (d) the streaming dashboard patched against
    rebound, (e) a sparse delta through the SpGEMM form. Each sub-phase
    its own peak bound (SERVE_PEAK_LIMIT_GIB)."""
    import torch
    from matrel_tpu_torch import MatrelSession
    dev = sess.device
    t0 = time.perf_counter()
    qs = serve_queries(sess)
    ref = MatrelSession(device=dev)            # the result cache off
    c0 = serve_counts()
    want = {k: ref.compute(f()) for k, f in qs.items()}
    torch.cuda.synchronize()
    l_ref = counts_since(c0)
    rows = {"submit": serving_submit(dev, qs, want)}
    torch.cuda.empty_cache()
    rows["evict"] = serving_evict(dev, qs, want)
    rows["cse"] = serving_cse(dev, qs)
    del qs, want, ref
    torch.cuda.empty_cache()
    rows["ivm_dense"] = serving_ivm_dense(dev)
    torch.cuda.empty_cache()
    rows["ivm_sparse"] = serving_ivm_sparse(dev)
    torch.cuda.empty_cache()
    total = counts_since(c0)           # every sub-phase's launches
    rows["reference_launches"] = {k: l_ref[k] for k in
                                  ("spmm_blocksparse", "spmv_compact")}
    log(f"path serving: {time.perf_counter() - t0:.1f} s; launches B1 "
        f"{total['spmm_blocksparse']}, B2 {total['spmv_compact']}, B4 "
        f"{total['spgemm_pairs']}")
    print(json.dumps({"serving": rows}, default=float))
    bodies = {k[3:]: v for k, v in total.items()
              if k.startswith("b1_") and v}
    return {"launches": total, "spmm_bodies": bodies, "rows": rows}


# -- the observability plane and the resilience ladder (path_ops) -------------

#: The sub-phases' peak device memory over what was held when each
#: started, measured on the H100 (PERF.md, PR 15), plus 25%.
OPS_PEAK_LIMIT_GIB = {k: 1.25 * v for k, v in {
    "ops_obs": 3.100, "ops_analyze": 2.014, "ops_overhead": 2.014,
    "ops_ladder": 0.539, "ops_breaker": 0.144, "ops_brownout": 0.756,
    "ops_drift": 1.284}.items()}
#: The kernel and whole-query device ms the analyze check holds each
#: query's node to (PERF.md §6's kernel table and §5's device time per
#: call; H100 80GB HBM3, 700 W): B1 at row 4's S·D, B2 at row 5's A·x,
#: B4 inside S×S 1% random bf16 at n = 32,768.
OPS_KERNEL_MS = {"B1": 0.2081, "B2": 0.1013, "B4": 0.0238}
OPS_QUERY_DEVICE_MS = {"B1": 0.2012, "B2": 0.0916, "B4": 0.7203}
#: The stated agreement: the kernel's profiled device ms (torch.profiler
#: over the analyzed runs) within [1/F, F] of its PERF.md kernel ms; the
#: node's synced ms at least that kernel's and at most PERF.md's device
#: ms of the query plus OPS_NODE_HOST_MS — a synced node is its kernels
#: plus host work (the launch, allocations, B2's padded x, the syncs'
#: round trip), which bounds a sub-0.1 ms node from below.
OPS_ANALYZE_FACTOR = 2.0
OPS_NODE_HOST_MS = 0.5
#: unprofiled analyzed runs a query; the node's ms is their median
OPS_ANALYZE_RUNS = 5
#: The device-event substring of each kernel's symbol (csrc/).
OPS_KERNEL_SYMBOL = {"B1": "bf16_wgmma_kernel", "B2": "csr_walk",
                     "B4": "bf16_wgmma_kernel"}
#: (b) traces of a query at most: a later profiler in a process can miss
#: the CUPTI record of one sub-ms call (the launch counter cannot).
OPS_PROFILE_TRIES = 3
#: (d) the ladder runs transient faults at execute 1, 2, 3 times.
OPS_LADDER_FIRES = (1, 2, 3)
#: (e) breaker threshold and cooldown.
OPS_BREAKER = dict(breaker_threshold=2, breaker_cooldown_ms=200.0)
#: (f) tight brownout watermarks: one rung a cycle while any signal is
#: hot (depth past 4 queued or queue-wait p95 past 20 ms), down one a
#: cycle once every signal is cold (empty queue, p95 under 2 ms).
OPS_BROWNOUT = dict(
    brownout_enable=True, brownout_window=4, brownout_dwell=1,
    brownout_wait_high_ms=20.0, brownout_wait_low_ms=2.0,
    brownout_depth_high=4, brownout_depth_low=1,
    serve_tenant_weights=SERVE_WEIGHTS, serve_max_batch=2,
    result_cache_max_bytes=SERVE_CACHE_BYTES, obs_provenance=256)
OPS_BURST = 64
#: (g) the strategies each query's analyzed runs are forced through
#: (every candidate of the (2, 4) virtual grid; SUMMA needs a square
#: one), and the runs a strategy.
OPS_GRID = (2, 4)
OPS_STRATEGIES = ("bmm_right", "bmm_left", "cpmm", "rmm", "xla")
OPS_SAMPLES = 2


def ops_counts() -> dict:
    """B1 (with its bodies), B2 and B4 launch counts."""
    c = serve_counts()
    return {k: v for k, v in c.items()
            if k in ("spmm_blocksparse", "spmv_compact", "spgemm_pairs")
            or k.startswith("b1_")}


def ops_since(c0: dict) -> dict:
    return {k: v - c0[k] for k, v in ops_counts().items()}


def ops_queries(sess) -> dict:
    """The three queries of path_ops on ``sess``'s mesh, each a builder
    of a fresh expression tree and the kernel it reaches: row 4's S·D
    (B1), row 5's Âᵀ·x (B2), S×S 1% random bf16 at n = 32,768 (B4)."""
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    S, D = row4_inputs(sess)
    _src, _dst, A = row5_matrix()
    x = sess.random((ROW5_N, 1), seed=6)
    P, Q = (BlockSparseMatrix.random((SPGEMM_CMP_N, SPGEMM_CMP_N), 0.01,
                                     block_size=512, mesh=sess.mesh,
                                     seed=s, dtype="bfloat16")
            for s in (2, 3))
    return {"B1": (lambda: S.multiply(D), "spmm_blocksparse"),
            "B2": (lambda: A.multiply(x), "spmv_compact"),
            "B4": (lambda: P.multiply(Q), "spgemm_pairs")}


def ops_free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def ops_scrape(url: str) -> str:
    import urllib.request
    with urllib.request.urlopen(url, timeout=60) as r:
        if r.status != 200:
            raise AssertionError(f"ops (h): {url} answered {r.status}")
        return r.read().decode()


def ops_nested(prof, symbol: str) -> tuple:
    """(launches of the kernel named ``symbol`` whose host launch call is
    in this torch.profiler trace, how many of those ran under a
    ``matrel.*`` range — the launch call's chain of enclosing host
    events reaches one — and their mean device µs, and the kernels of
    that name in the trace without their launch call). Device records
    of other windows (the discarded warm-up step, an earlier profiler)
    can reach a trace without the host call that made them; they are
    counted apart."""
    from torch.autograd import DeviceType
    events = list(prof.events())
    launches = {e.id: e for e in events
                if e.device_type == DeviceType.CPU and "aunch" in e.name}
    linked = under = unlinked = 0
    dev_us = 0.0
    for k in events:
        if k.device_type == DeviceType.CPU or symbol not in k.name:
            continue
        r = launches.get(k.id)
        if r is None:
            unlinked += 1
            continue
        linked += 1
        dev_us += k.time_range.end - k.time_range.start
        while r is not None and not r.name.startswith("matrel."):
            r = r.cpu_parent
        under += r is not None
    return linked, under, dev_us / max(linked, 1), unlinked


def ops_profiled(fn, calls: int = 10):
    """A torch.profiler trace of ``calls`` calls of ``fn``, after a
    discarded warm-up step of calls for at least PROFILER_WARMUP_S
    (device_split's schedule: the trace starts some time after the
    profiler does, and a later profiler in a process has seen no kernel
    of one sub-ms call even after the warm-up)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        t_end = time.perf_counter() + PROFILER_WARMUP_S
        while True:
            fn()
            torch.cuda.synchronize()
            if time.perf_counter() >= t_end:
                break
        prof.step()
        for _ in range(calls):
            fn()
            torch.cuda.synchronize()
        prof.step()
    return prof


def ops_obs(dev, qs: dict, want: dict, tmp: str) -> dict:
    """(a) obs on (event log, flight recorder, provenance, lockdep) and
    (h) the metrics endpoint: each query's answer bit-equal to the same
    query with obs off, one ``query`` event a run, the span tree
    query → plan / query.execute, ``why`` naming each plan, the
    registry counting the runs, the log read back through read_events;
    one scrape of /metrics and /json shows the counters; after
    serve_close no exporter thread survives."""
    import hashlib
    import threading
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.obs.events import read_events
    from matrel_tpu_torch.obs.metrics import REGISTRY
    from matrel_tpu_torch.utils import lockdep
    meter = PeakMeter("ops_obs", OPS_PEAK_LIMIT_GIB)
    log_path = os.path.join(tmp, "events.jsonl")
    REGISTRY.reset()
    lockdep.reset()
    sess = MatrelSession(config=MatrelConfig(
        obs_level="on", obs_event_log=log_path, obs_flight_recorder=512,
        obs_provenance=64, obs_metrics_port=ops_free_port(),
        lockdep_enable=True), device=dev)
    c0 = ops_counts()
    for name, (build, _k) in qs.items():
        out = sess.compute(build())
        if not torch.equal(out.data, want[name].data):
            raise AssertionError(f"ops (a) {name}: obs on is not "
                                 f"bit-equal to obs off")
    torch.cuda.synchronize()
    got = ops_since(c0)
    for name, (_b, k) in qs.items():
        if got[k] < 1:
            raise AssertionError(f"ops (a) {name}: {k} not launched")
    url = sess._exporter.url
    prom = ops_scrape(url + "/metrics")
    snap = json.loads(ops_scrape(url + "/json"))
    n = len(qs)
    if f"matrel_query_count {float(n)!r}" not in prom \
            or snap["metrics"]["counters"].get("query.count") != n:
        raise AssertionError(f"ops (h): the scrape does not count {n} "
                             f"queries")
    events = read_events(log_path)
    queries = [e for e in events if e["kind"] == "query"]
    spans = [e for e in events if e["kind"] == "span"]
    if len(queries) != n or REGISTRY.counter("query.count").value != n:
        raise AssertionError(f"ops (a): {len(queries)} query events, "
                             f"registry {REGISTRY.snapshot()['counters']}")
    by_id = {s["span_id"]: s for s in spans}
    roots = [s for s in spans if s["name"] == "query"]
    for want_name in ("plan", "query.execute"):
        kids = [s for s in spans if s["name"] == want_name
                and by_id.get(s["parent_id"], {}).get("name") == "query"]
        if len(kids) != n or len(roots) != n:
            raise AssertionError(f"ops (a): {len(kids)} {want_name} "
                                 f"spans under {len(roots)} query roots")
    plan_hashes = {hashlib.sha1(k.encode()).hexdigest()[:16]
                   for k in sess._plan_cache}
    why = sess.why(last=n)
    if {w["key_hash"] for w in why} != plan_hashes \
            or any(not w.get("strategies") for w in why):
        raise AssertionError(f"ops (a): why {why} does not name the "
                             f"plans")
    exec_ms = {q["root_kind"] + str(i): q["execute_ms"]
               for i, q in enumerate(queries)}
    sess.serve_close()
    alive = [t.name for t in threading.enumerate()
             if t.name == "matrel-metrics" and t.is_alive()]
    if alive or sess._flight is None or not len(sess._flight):
        raise AssertionError(f"ops (h): exporter threads {alive} after "
                             f"serve_close")
    diags = lockdep.diagnostics()
    if diags or not lockdep.is_acyclic():
        raise AssertionError(f"ops (a): lockdep recorded {diags}")
    lockdep.disable()
    row = {"query_events": len(queries), "span_events": len(spans),
           "events": len(events), "launches": got,
           "execute_ms_host": exec_ms, "scrape_bytes": len(prom),
           "lock_edges": len(lockdep.order_graph()),
           "peak_gib": meter.gib()}
    log(f"ops (a): obs on, {n} queries bit-equal to obs off, {len(events)} "
        f"events ({len(queries)} query, {len(spans)} span), why names "
        f"every plan, registry query.count {n}, launches {got}; (h) "
        f"/metrics {len(prom)} B and /json count the runs, no exporter "
        f"thread after serve_close; lockdep {row['lock_edges']} order "
        f"edges, no inversion; peak {row['peak_gib']:.3f} GiB")
    return row


def ops_analyze(dev, qs: dict, tmp: str) -> dict:
    """(b) EXPLAIN ANALYZE of each query: the tree names its B1 / B2 /
    B4 node; the kernel's launch counter moved over the profiled calls;
    its profiled device ms (a trace that saw the kernel; up to
    OPS_PROFILE_TRIES, each retry logged) against its PERF.md kernel ms
    (OPS_ANALYZE_FACTOR), every traced launch under a ``matrel.*``
    range, and the node's synced ms between that kernel's and PERF.md's
    device ms of the query plus OPS_NODE_HOST_MS; the plan-as-run line
    beside it."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.obs import analyze as analyze_mod
    meter = PeakMeter("ops_analyze", OPS_PEAK_LIMIT_GIB)
    sess = MatrelSession(config=MatrelConfig(
        obs_level="on", obs_event_log=os.path.join(tmp, "analyze.jsonl")),
        device=dev)
    f = OPS_ANALYZE_FACTOR
    rows = {}
    for name, (build, kernel) in qs.items():
        e = build()
        text = sess.explain(e, analyze=True)
        if "== Analyzed physical plan" not in text:
            raise AssertionError(f"ops (b) {name}: {text[-300:]}")
        plan = sess.compile(e)
        analyze_mod.measure_per_op(plan)               # warm
        # the node's ms: the median of OPS_ANALYZE_RUNS unprofiled runs;
        # the kernel's device ms a launch: more runs under torch.profiler
        runs = []
        for _ in range(OPS_ANALYZE_RUNS):
            per_op, total_s = analyze_mod.measure_per_op(plan)
            node = [(lbl, s) for lbl, s in per_op.values()
                    if lbl.startswith("matmul")]
            if len(node) != 1:
                raise AssertionError(f"ops (b) {name}: matmul nodes "
                                     f"{node}")
            runs.append((node[0][1], node[0][0], per_op, total_s))
        runs.sort(key=lambda r: r[0])
        node_s, label, per_op, total_s = runs[len(runs) // 2]
        # the launch proof: the kernel's own counter over the profiled
        # calls; the device time and the nesting: the trace, taken again
        # (OPS_PROFILE_TRIES in all) only when CUPTI delivered no record
        # of the kernel's symbol
        symbol = OPS_KERNEL_SYMBOL[name]
        for attempt in range(1, OPS_PROFILE_TRIES + 1):
            c0 = ops_counts()
            prof = ops_profiled(lambda: analyze_mod.measure_per_op(plan))
            counted = ops_since(c0)[kernel]
            if counted < 1:
                raise AssertionError(f"ops (b) {name}: no {kernel} launch "
                                     f"counted over the profiled calls")
            launched, nested, kern_us, unlinked = ops_nested(prof, symbol)
            if launched:
                break
            log(f"ops (b) {name}: trace {attempt} of {OPS_PROFILE_TRIES} "
                f"holds no record of {symbol} ({counted} launches "
                f"counted, {unlinked} records without their launch "
                f"call)" + ("; tracing again" if attempt < OPS_PROFILE_TRIES
                            else ""))
        else:
            raise AssertionError(f"ops (b) {name}: no trace of "
                                 f"{OPS_PROFILE_TRIES} saw {symbol}, "
                                 f"though {kernel} counted {counted} "
                                 f"launches")
        if nested != launched:
            raise AssertionError(f"ops (b) {name}: {nested} of {launched} "
                                 f"launches under a matrel.* range "
                                 f"({unlinked} without their launch call)")
        node_ms, kern_ms = node_s * 1e3, kern_us / 1e3
        plan_line = next(ln for ln in text.splitlines()
                         if "plan as run:" in ln)
        ratio_node = node_ms / OPS_QUERY_DEVICE_MS[name]
        ratio_kern = kern_ms / OPS_KERNEL_MS[name]
        if not (1 / f <= ratio_kern <= f and kern_ms <= node_ms
                <= OPS_QUERY_DEVICE_MS[name] + OPS_NODE_HOST_MS):
            raise AssertionError(
                f"ops (b) {name}: node {label} {node_ms:.4f} ms (PERF "
                f"device {OPS_QUERY_DEVICE_MS[name]} + {OPS_NODE_HOST_MS} "
                f"host), kernel {kern_ms:.4f} ms (PERF "
                f"{OPS_KERNEL_MS[name]}, factor {f})")
        rows[name] = {"node": label, "node_ms": node_ms,
                      "launches_counted": counted, "traces": attempt,
                      "launches_under_matrel_range": nested,
                      "profiled_kernel_ms": kern_ms,
                      "per_op_total_ms": sum(s for _, s in
                                             per_op.values()) * 1e3,
                      "run_ms": total_s * 1e3, "fused_line": plan_line,
                      "node_vs_perf": ratio_node,
                      "kernel_vs_perf": ratio_kern}
        log(f"ops (b) {name}: node {label} {node_ms:.4f} ms synced "
            f"({ratio_node:.2f}x PERF.md's {OPS_QUERY_DEVICE_MS[name]} "
            f"device ms), its kernel {kern_ms:.4f} ms by torch.profiler "
            f"({ratio_kern:.2f}x PERF.md's {OPS_KERNEL_MS[name]}), "
            f"{nested} of {launched} launches under a matrel.* range "
            f"({unlinked} more of other windows); "
            f"{plan_line.strip('= ')}")
    # EXPLAIN ANALYZE through the SQL surface, on the card
    sess.register("X", sess.random((4096, 4096), seed=4))
    text = sess.explain_sql("SELECT X * X FROM X", analyze=True)
    if "== Analyzed physical plan" not in text or " ms]" not in text:
        raise AssertionError(f"ops (b) SQL: {text[-300:]}")
    rows["sql_plan_line"] = next(ln for ln in text.splitlines()
                                 if "plan as run:" in ln)
    log(f"ops (b) explain_sql(SELECT X * X FROM X, analyze=True), "
        f"4096² f32: {rows['sql_plan_line'].strip('= ')}")
    rows["peak_gib"] = meter.gib()
    return rows


def ops_overhead(dev, qs: dict, latency) -> dict:
    """(c) warm ms a query with obs off against obs on (event log,
    spans, query records), CUDA events, in turns (off, on, on, off;
    medians of 10): the on-cost as measured, and off against
    path_latency's figure for the same query in this run."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    import tempfile
    meter = PeakMeter("ops_overhead", OPS_PEAK_LIMIT_GIB)
    off = MatrelSession(device=dev)
    tmp = tempfile.mkdtemp(dir=SCRATCH)
    on = MatrelSession(config=MatrelConfig(
        obs_level="on", obs_event_log=os.path.join(tmp, "e.jsonl")),
        device=dev)
    lat_name = {"B1": "row4 S·D", "B2": "row5 A·x",
                "B4": "S×S spgemm_pairs (pallas_generic)"}
    rows = {}
    for name, (build, _k) in qs.items():
        e_off, e_on = build(), build()
        off.compute(e_off)
        on.compute(e_on)
        ms_off, ms_on = in_turns(lambda: off.compute(e_off),
                                 lambda: on.compute(e_on))
        ref = (latency or {}).get(lat_name[name])
        rows[name] = {"off_ms": ms_off, "on_ms": ms_on,
                      "on_cost_ms": ms_on - ms_off,
                      "path_latency_ms": ref}
        if ref is not None and not 2 / 3 <= ms_off / ref <= 1.5:
            raise AssertionError(f"ops (c) {name}: obs off {ms_off:.4f} "
                                 f"ms against path_latency's {ref:.4f}")
        log(f"ops (c) {name}: warm compute() obs off {ms_off:.4f} ms, "
            f"obs on {ms_on:.4f} ms (on-cost {ms_on - ms_off:+.4f} ms); "
            f"path_latency {ref if ref is None else f'{ref:.4f}'} ms")
    rows["peak_gib"] = meter.gib()
    return rows


def ops_ladder(dev, qs: dict, want: dict, tmp: str) -> dict:
    """(d) a transient fault at execute on the B1 query, 1, 2 and 3
    times: the attempts climb rungs 1..k, the answer within the bf16
    tolerance of rung 0's, plan.meta["degrade"] and the fault / retry /
    degrade events right, B1 launched only when the answering rung is
    <= 2 (rung 3 runs the plain composite); ms of each degraded plan."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.obs.events import read_events
    from matrel_tpu_torch.resilience import degrade, faults
    meter = PeakMeter("ops_ladder", OPS_PEAK_LIMIT_GIB)
    build, _k = qs["B1"]
    rows = {}
    for k in OPS_LADDER_FIRES:
        faults.reset()
        log_path = os.path.join(tmp, f"ladder{k}.jsonl")
        sess = MatrelSession(config=MatrelConfig(
            fault_inject=f"execute:transient:p=1.0:max={k}",
            retry_max_attempts=len(OPS_LADDER_FIRES),
            retry_backoff_ms=0.0, obs_level="on",
            obs_event_log=log_path), device=dev)
        c0 = ops_counts()
        out = sess.compute(build())
        torch.cuda.synchronize()
        b1 = ops_since(c0)["spmm_blocksparse"]
        err = check_close(f"ops (d) rung {k}", out.data,
                          want["B1"].data, "bfloat16")
        keys = [key for key in sess._plan_cache
                if key.startswith(f"degr:{k}|")]
        if len(keys) != 1 or sess._plan_cache[keys[0]].meta.get(
                "degrade") != degrade.rung_meta(k):
            raise AssertionError(f"ops (d) rung {k}: plan keys "
                                 f"{list(sess._plan_cache)}")
        ev = read_events(log_path)
        seq = [(e["kind"], e.get("rung")) for e in ev
               if e["kind"] in ("retry", "degrade")]
        want_seq = [x for r in range(1, k + 1)
                    for x in (("retry", r), ("degrade", r))]
        faults_ev = [e for e in ev if e["kind"] == "fault"]
        if seq != want_seq or len(faults_ev) != k or any(
                e.get("site") != "execute" or e["error"] != "InjectedFault"
                for e in faults_ev):
            raise AssertionError(f"ops (d) rung {k}: events {seq}, "
                                 f"faults {faults_ev}")
        if b1 != (1 if k <= 2 else 0):
            raise AssertionError(f"ops (d) rung {k}: B1 launched {b1} "
                                 f"times")
        plan = sess._plan_cache[keys[0]]
        ms = time_ms(plan.run, warmup=2, runs=10)
        rows[k] = {"label": degrade.rung_label(k), "b1_launches": b1,
                   "max_abs_err": err, "plan_ms": ms}
        log(f"ops (d) rung {k} ({degrade.rung_label(k)}): {k} injected "
            f"transient faults, events retry/degrade 1..{k}, B1 {b1} "
            f"launch(es), max_abs_err {err:.3e} vs rung 0, the degraded "
            f"plan {ms:.4f} ms warm")
    faults.reset()
    rows["peak_gib"] = meter.gib()
    return rows


def ops_breaker(dev, qs: dict, want: dict) -> dict:
    """(e) a fatal injected fault at execute trips the B1 query's
    breaker after breaker_threshold failures; admission raises the
    typed CircuitOpen; after the cooldown the half-open probe runs B1
    and closes it."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.resilience import faults
    from matrel_tpu_torch.resilience.errors import (CircuitOpen,
                                                    InjectedFault)
    meter = PeakMeter("ops_breaker", OPS_PEAK_LIMIT_GIB)
    faults.reset()
    thr = OPS_BREAKER["breaker_threshold"]
    sess = MatrelSession(config=MatrelConfig(
        fault_inject=f"execute:fatal:p=1.0:max={thr}", **OPS_BREAKER),
        device=dev)
    build, _k = qs["B1"]
    e = build()
    cls = sess._breakers.plan_class(e)
    trail = []
    for _ in range(thr + 1):
        try:
            sess.compute(e)
            trail.append("ok")
        except InjectedFault:
            trail.append("InjectedFault")
        except CircuitOpen:
            trail.append("CircuitOpen")
    state_open = sess._breakers.state(cls)
    time.sleep(OPS_BREAKER["breaker_cooldown_ms"] / 1e3 * 1.5)
    c0 = ops_counts()
    out = sess.compute(e)
    torch.cuda.synchronize()
    b1 = ops_since(c0)["spmm_blocksparse"]
    if (trail != ["InjectedFault"] * thr + ["CircuitOpen"]
            or state_open != "open"
            or sess._breakers.state(cls) != "closed" or b1 != 1
            or not torch.equal(out.data, want["B1"].data)):
        raise AssertionError(f"ops (e): trail {trail}, {state_open} -> "
                             f"{sess._breakers.state(cls)}, B1 {b1}")
    faults.reset()
    snap = sess._breakers.snapshot()
    row = {"class": cls, "trail": trail, "transitions":
           snap["transitions"], "peak_gib": meter.gib()}
    log(f"ops (e): class {cls}: {trail} -> open; after "
        f"{OPS_BREAKER['breaker_cooldown_ms']:.0f} ms the probe ran B1 "
        f"once and closed it ({snap['transitions']}); the answer "
        f"bit-equal to obs off")
    return row


def ops_brownout(dev, qs: dict, want: dict, tmp: str) -> dict:
    """(f) a submit burst over two tenants (row 4's S·D and row 5's A·x,
    path_serving (a)'s sizes) under tight brownout watermarks: the rung
    climbs to 3 and falls back to 0; at rung 3 the low-weight tenant b
    is shed typed; stale-tolerant queries admitted at rung >= 2 are
    served the rebind-stale cached answer, stamped ``stale`` in the
    ledger; every overload event's rung is the controller's, and the
    events rise to 3 and fall to 0."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.obs.events import read_events
    from matrel_tpu_torch.resilience.errors import AdmissionShed
    from matrel_tpu_torch.utils import lockdep
    meter = PeakMeter("ops_brownout", OPS_PEAK_LIMIT_GIB)
    log_path = os.path.join(tmp, "brownout.jsonl")
    lockdep.reset()
    sess = MatrelSession(config=MatrelConfig(
        obs_level="on", obs_event_log=log_path, lockdep_enable=True,
        **OPS_BROWNOUT), device=dev)
    b1_build, _ = qs["B1"]
    b2_build, _ = qs["B2"]
    # the stale entry: cache S·D over D, then rebind D's catalog name;
    # the burst's S·D runs over the new binding, so it never re-caches
    # the stale query's key
    e_old = b1_build()
    S_ = e_old.children[0].attrs["matrix"]
    D_ = e_old.children[1].attrs["matrix"]
    sess.register("D", D_)
    old = sess.compute(e_old)
    D_new = sess.random(D_.shape, dtype="bfloat16", seed=9)
    sess.register("D", D_new)
    want_new = MatrelSession(device=dev).compute(S_.multiply(D_new))
    if sess.result_cache_info()["stale_entries"] != 1:
        raise AssertionError(f"ops (f): {sess.result_cache_info()}")
    ctl = sess._brownout
    futs, shed = [], 0
    for i in range(OPS_BURST):
        try:
            if i % 2 == 0:
                futs.append(("B1", sess.submit(S_.multiply(D_new),
                                               tenant="a")))
            else:
                futs.append(("B2", sess.submit(b2_build(), tenant="b")))
        except AdmissionShed as ex:          # tenant b at rung 3
            if ex.scope != "brownout":
                raise
            shed += 1
    t_end = time.perf_counter() + 120
    while ctl.rung() < 3 and time.perf_counter() < t_end:
        time.sleep(0.0005)
    rung_at_shed = ctl.rung()
    shed_after = 0
    for _ in range(4):
        try:
            futs.append(("B2", sess.submit(b2_build(), tenant="b")))
        except AdmissionShed as ex:
            if ex.scope != "brownout":
                raise
            shed_after += 1
    shed += shed_after
    sess.serve_drain(timeout=600)
    stale_futs = []
    for _ in range(30):              # the trickle: one cycle a query
        f = sess.submit(e_old, tenant="a", staleness_ms=3.6e6)
        f.result(timeout=600)
        stale_futs.append(f)
        if ctl.rung() == 0:
            break
    sess.serve_drain(timeout=600)
    for name, f in futs:
        out = f.result(timeout=600)
        if name == "B1":
            check_close("ops (f) S·D", out.data, want_new.data,
                        "bfloat16")
        else:
            scale = float(want["B2"].data.abs().max())
            err = float((out.data.float() - want["B2"].data.float())
                        .abs().max())
            if not err <= 1e-2 * scale:
                raise AssertionError(f"ops (f) A·x: err {err} at scale "
                                     f"{scale}")
    n_stale = 0
    for f in stale_futs:
        out = f.result()
        if out is old:              # the graveyard's entry, as cached
            n_stale += 1
        else:                       # computed (rung < 2): the same query
            check_close("ops (f) stale-tolerant S·D", out.data, old.data,
                        "bfloat16")
    t_end = time.perf_counter() + 10        # the last cycle's event
    while time.perf_counter() < t_end:
        ov = [e for e in read_events(log_path) if e["kind"] == "overload"]
        if ov and ov[-1]["rung"] == 0:
            break
        time.sleep(0.01)
    rungs = [e["rung"] for e in ov]
    stale_recs = [w for w in sess.why(last=0) if w["path"] == "stale"]
    shed_ev = sum(e["sheds"].get("b", 0) for e in ov)
    peak_at = rungs.index(3) if 3 in rungs else -1
    if (rung_at_shed < 3 or shed_after != 4 or shed_ev != shed
            or any(e["rung"] != e["brownout"]["rung"] for e in ov)
            or peak_at < 0 or rungs[-1] != 0
            or rungs[:peak_at + 1] != sorted(rungs[:peak_at + 1])
            or sess._serve.stale_served < 1
            or n_stale != sess._serve.stale_served
            or len(stale_recs) != sess._serve.stale_served):
        raise AssertionError(
            f"ops (f): rung at shed {rung_at_shed}, shed {shed} "
            f"(events {shed_ev}), rungs {rungs}, stale "
            f"{sess._serve.stale_served} / {len(stale_recs)} records")
    sess.serve_close(timeout=600)
    diags = lockdep.diagnostics()
    if diags or not lockdep.is_acyclic():
        raise AssertionError(f"ops (f): lockdep recorded {diags}")
    lockdep.disable()
    snap = ctl.snapshot()
    row = {"rungs": rungs, "max_rung": max(rungs), "shed_b": shed,
           "stale_served": sess._serve.stale_served,
           "overload_events": len(ov), "entered": snap["entered"],
           "exited": snap["exited"], "submitted": len(futs)
           + len(stale_futs), "peak_gib": meter.gib()}
    log(f"ops (f): {OPS_BURST} submissions by tenants a:3, b:1 then a "
        f"trickle of {len(stale_futs)}; overload rungs {rungs}; tenant b "
        f"shed {shed} times at rung 3 (typed, counted in the events); "
        f"{row['stale_served']} answers served stale at rung >= 2, each "
        f"stamped in the ledger and bit-equal to the cached one; "
        f"lockdep no inversion; peak {row['peak_gib']:.3f} GiB")
    return row


def ops_drift(dev, tmp: str) -> dict:
    """(g) analyzed runs of row 2's chain and a 4096² product, each
    strategy forced in turn on the (2, 4) virtual grid, fill a drift
    table under backend "cuda"; with coeff_planner_enable and
    coeff_min_samples met, the plan key takes the table's epoch and the
    stamps that change are printed; both plans compute the same
    answer."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.executor import plan_matmul_decisions
    from matrel_tpu_torch.obs import drift
    from matrel_tpu_torch.obs.events import read_events
    from matrel_tpu_torch.parallel import coeffs
    from matrel_tpu_torch.workloads import chain_bench
    meter = PeakMeter("ops_drift", OPS_PEAK_LIMIT_GIB)
    log_path = os.path.join(tmp, "drift.jsonl")
    table = os.path.join(tmp, "drift_table.json")
    base = MatrelConfig(mesh_shape=OPS_GRID, drift_table_path=table)

    def queries(s):
        mats = chain_bench.skewed_abc(s.mesh, n=10_000, mid=100, seed=3)
        X = s.random((4096, 4096), seed=4)
        Y = s.random((4096, 4096), seed=5)
        return {"row2 A·B·C": chain_bench.build_chain(mats),
                "4096^2": X.multiply(Y)}

    for strat in OPS_STRATEGIES:
        s = MatrelSession(config=base.replace(
            strategy_override=strat, obs_level="on",
            obs_event_log=log_path), device=dev)
        for e in queries(s).values():
            for _ in range(OPS_SAMPLES):
                s.explain(e, analyze=True)
    ev = read_events(log_path)
    samples = list(drift.iter_samples(ev))
    if not samples or any(x["backend"] != dev.type for x in samples):
        raise AssertionError(f"ops (g): samples {samples[:3]}")
    drift.update_table(table, drift.calibrate(samples))
    coeffs.reset_coefficient_cache()
    epoch = coeffs.epoch(table)
    analytic = MatrelSession(config=base, device=dev)
    learned = MatrelSession(config=base.replace(
        coeff_planner_enable=True, coeff_min_samples=OPS_SAMPLES),
        device=dev)
    if epoch == coeffs.COLD_EPOCH \
            or learned._coeff_prefix() != f"coeffv:{epoch}|":
        raise AssertionError(f"ops (g): epoch {epoch}, prefix "
                             f"{learned._coeff_prefix()}")
    rows = {"epoch": epoch, "samples": len(samples),
            "table_rows": len(drift.load_table(table)["entries"])}
    for name in ("row2 A·B·C", "4096^2"):
        stamps = []
        outs = []
        for s in (analytic, learned):
            e = queries(s)[name]
            plan = s.compile(e)
            stamps.append([(d["strategy"], d.get("cost"), tuple(d["dims"]))
                           for d in plan_matmul_decisions(plan)])
            outs.append(s.compute(e))
        if not all(k.startswith(f"coeffv:{epoch}|")
                   for k in learned._plan_cache):
            raise AssertionError(f"ops (g): keys {list(learned._plan_cache)}")
        err = check_close(f"ops (g) {name}", outs[1].data, outs[0].data,
                          "float32")
        changed = [(a, b) for a, b in zip(*stamps) if a != b]
        rows[name] = {"analytic": stamps[0], "learned": stamps[1],
                      "changed": changed, "max_abs_err": err}
        log(f"ops (g) {name}: stamps analytic {stamps[0]} -> learned "
            f"{stamps[1]}; changed {changed}; the same answer "
            f"(max_abs_err {err:.3e})")
        del outs
        torch.cuda.empty_cache()
    rows["peak_gib"] = meter.gib()
    log(f"ops (g): {len(samples)} analyze samples under backend "
        f"{dev.type}, "
        f"{rows['table_rows']} calibration rows, epoch {epoch}")
    return rows


def path_ops(sess, latency=None) -> dict:
    """The observability plane and the resilience ladder on the card
    (obs/, resilience/, parallel/coeffs.py), at BASELINE's shapes over
    B1 (row 4's S·D), B2 (row 5's Âᵀ·x through compute) and B4 (S×S 1%
    random bf16 at n = 32,768): (a) obs on with (h) the metrics endpoint,
    (b) EXPLAIN ANALYZE against torch.profiler, (c) the obs-off / on
    cost, (d) the degradation ladder, (e) the breaker, (f) brownout, (g)
    drift and learned coefficients. Each sub-phase its own peak bound
    (OPS_PEAK_LIMIT_GIB)."""
    import tempfile
    import torch
    from matrel_tpu_torch import MatrelSession
    dev = sess.device
    t0 = time.perf_counter()
    os.makedirs(SCRATCH, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=SCRATCH, prefix="ops-")
    qs = ops_queries(sess)
    ref = MatrelSession(device=dev)            # every knob at its default
    c0 = ops_counts()
    want = {k: ref.compute(b()) for k, (b, _kern) in qs.items()}
    torch.cuda.synchronize()
    rows = {"obs": ops_obs(dev, qs, want, tmp)}
    rows["analyze"] = ops_analyze(dev, qs, tmp)
    rows["overhead"] = ops_overhead(dev, qs, latency)
    rows["ladder"] = ops_ladder(dev, qs, want, tmp)
    rows["breaker"] = ops_breaker(dev, qs, want)
    rows["brownout"] = ops_brownout(dev, qs, want, tmp)
    del ref
    torch.cuda.empty_cache()
    rows["drift"] = ops_drift(dev, tmp)
    total = ops_since(c0)
    log(f"path ops: {time.perf_counter() - t0:.1f} s; launches B1 "
        f"{total['spmm_blocksparse']}, B2 {total['spmv_compact']}, B4 "
        f"{total['spgemm_pairs']}")
    print(json.dumps({"ops": rows}, default=str))
    bodies = {k[3:]: v for k, v in total.items()
              if k.startswith("b1_") and v}
    return {"launches": total, "spmm_bodies": bodies, "rows": rows}


# -- the durable half of serving and the plan verifier (path_durable) ---------

#: The sub-phases' peak device memory over what was held when each
#: started, measured on the H100 (PERF.md §6, PR 16), plus 25%.
DURABLE_PEAK_LIMIT_GIB = {k: 1.25 * v for k, v in {
    "durable_spill": 0.854, "durable_restart": 0.902,
    "durable_checkpoint": 2.300, "durable_verify": 6.548,
    "durable_replan": 0.344}.items()}
#: (a) the host-tier copies timed each way (pinned and pageable), turns
DURABLE_PIN_TURNS = 3
#: (c) block-sparse PageRank rounds under run_resilient, its checkpoint
#: interval, and the fault: the checkpoint site's third check (the save
#: after round 9) raises a transient InjectedFault
DURABLE_PR_ROUNDS = 20
DURABLE_CKPT_INTERVAL = 5
DURABLE_FAULT = "checkpoint:transient:n=3"
#: (e) the re-plan controller's interval, the seeded records a candidate
#: strategy and the warm queries streamed
DURABLE_REPLAN_INTERVAL = 32
DURABLE_REPLAN_SEED = 20
DURABLE_REPLAN_QUERIES = 32


def durable_root() -> str:
    """A fresh state directory under the gitignored build/chip_smoke/."""
    import tempfile
    os.makedirs(SCRATCH, exist_ok=True)
    return tempfile.mkdtemp(dir=SCRATCH, prefix="durable-")


def spill_legs_priced(legs: list, nbytes: int, dims) -> list:
    """Each measured leg beside coeffs.spill_cost_ms's price for it (the
    drift table is cold on this machine: the analytic ms/MiB)."""
    from matrel_tpu_torch.obs import drift
    from matrel_tpu_torch.parallel import coeffs
    out = []
    for leg in legs:
        est, src = coeffs.spill_cost_ms([leg["leg"]], nbytes,
                                        drift.shape_class(dims), "cuda",
                                        drift.table_path())
        out.append({"leg": leg["leg"], "ms": leg["ms"], "est_ms": est,
                    "cost": src,
                    "gb_per_s": leg["bytes"] / (leg["ms"] * 1e6)
                    if leg["ms"] > 0 else None})
    return out


def pinned_legs(t) -> dict:
    """d2h into pinned (serve/spill.to_host, the host tier's copy) and
    pageable host memory, and h2d back from each, in turns (pinned,
    pageable, pageable, pinned), host clock around a synchronised copy:
    the measurement the host tier's pinned copy rests on."""
    import torch
    from matrel_tpu_torch.serve import spill as spill_lib
    ms = {"pinned": {"d2h": [], "h2d": []},
          "pageable": {"d2h": [], "h2d": []}}
    order = ["pinned", "pageable", "pageable", "pinned"]
    for _ in range(DURABLE_PIN_TURNS):
        for kind in order:
            host, s = synced(lambda: spill_lib.to_host(t)
                             if kind == "pinned" else t.to("cpu"))
            ms[kind]["d2h"].append(s * 1e3)
            back, s = synced(lambda: host.to(t.device))
            ms[kind]["h2d"].append(s * 1e3)
            if not torch.equal(back, t):
                raise AssertionError(f"spill {kind} round trip differs")
            del host, back
    return {k: {leg: statistics.median(v) for leg, v in d.items()}
            for k, d in ms.items()}


def durable_spill(sess, S, D, root: str) -> dict:
    """(a) Row 4's S·D (B1 wgmma, bf16) and two more S·D results through
    a result cache whose device budget holds one, a host tier that holds
    one and a disk tier: the first result (given a hit, as the reuse
    gate asks) ages to disk; consulted again it answers bit-equal with
    no B1 launch, its entry stamped with its tier and priced legs; a
    rebind of D kills the host and disk entries and unlinks the
    artifact."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    meter = PeakMeter("durable_spill", DURABLE_PEAK_LIMIT_GIB)
    nbytes = D.data.numel() * D.data.element_size()
    cfg = MatrelConfig(result_cache_max_bytes=int(1.5 * nbytes),
                       spill_enable=True,
                       spill_host_max_bytes=int(1.5 * nbytes),
                       spill_disk_hits=1, state_dir=os.path.join(root, "a"))
    s = MatrelSession(config=cfg, device=sess.device)
    n = S.shape[0]
    S2, S3 = (BlockSparseMatrix.random((n, n), 0.01, block_size=512,
                                       mesh=sess.mesh, seed=seed,
                                       dtype="bfloat16")
              for seed in (11, 12))
    for name, m in (("S", S), ("S2", S2), ("S3", S3), ("D", D)):
        s.register(name, m)
    events = []
    wired = s._spill.emit
    s._spill.emit = lambda rec: (events.append(rec), wired(rec))

    def q(name):
        return s.table(name).multiply(s.table("D"))

    c0 = ops_counts()
    first = s.compute(q("S"))
    with meter.aside():
        first_bits = first.data.clone()
    s.compute(q("S"))                       # a hit: the reuse gate's
    s.compute(q("S2"))
    s.compute(q("S2"))
    s.compute(q("S3"))                      # S·D ages device→host→disk
    del first
    info = dict(s.result_cache_info()["spill"])
    launched = ops_since(c0)["spmm_blocksparse"]
    if (info["disk_entries"], info["host_entries"], launched) != (1, 1, 3):
        raise AssertionError(f"durable (a): tiers {info}, B1 {launched}")
    c1 = ops_counts()
    again, thaw_s = synced(lambda: s.compute(q("S")))
    if ops_since(c1)["spmm_blocksparse"] != 0:
        raise AssertionError("durable (a): the disk-tier hit launched B1")
    if not torch.equal(again.data, first_bits):
        raise AssertionError("durable (a): the thawed S·D differs")
    (ent,) = [e for _k, e in s._result_cache.items_snapshot()
              if e.spill is not None and e.spill["tier"] == "disk"]
    stamp = dict(ent.spill)
    if stamp["tier"] != "disk" or stamp["legs"] != ["disk_read", "h2d"]:
        raise AssertionError(f"durable (a): stamp {stamp}")
    demote = next(e for e in events if e["op"] == "demote"
                  and any(leg["leg"] == "disk_write" for leg in e["legs"]))
    first_demote = next(e for e in events if e["op"] == "demote")
    promote = next(e for e in events if e["op"] == "promote")
    legs = ([first_demote["legs"][0]]
            + [leg for leg in demote["legs"] if leg["leg"] == "disk_write"]
            + promote["legs"])
    priced = spill_legs_priced(legs, nbytes, D.shape)
    for p in priced:
        log(f"durable (a) leg {p['leg']}: {p['ms']:.3f} ms measured "
            f"({p['gb_per_s']:.2f} GB/s) against {p['est_ms']:.3f} ms "
            f"priced ({p['cost']}) for {nbytes / 2**20:.1f} MiB")
    log(f"durable (a): the disk-tier consult answered bit-equal in "
        f"{thaw_s * 1e3:.3f} ms (synced), no B1 launch; stamp tier "
        f"{stamp['tier']} legs {stamp['legs']} est {stamp['est_ms']} ms "
        f"({stamp['cost']}), fits {stamp['fits']}")
    with meter.aside():
        pins = pinned_legs(again.data)
    log(f"durable (a) host tier, {nbytes / 2**20:.1f} MiB: pinned d2h "
        f"{pins['pinned']['d2h']:.3f} / h2d {pins['pinned']['h2d']:.3f} ms, "
        f"pageable d2h {pins['pageable']['d2h']:.3f} / h2d "
        f"{pins['pageable']['h2d']:.3f} ms")
    del again
    # after the thaw: S·D on the card, S·D3 on host, S·D2 on disk
    before = dict(s.result_cache_info()["spill"])
    # (a promotion leaves its artifact in place, as the JAX package
    # does: a snapshot may index it; a later demotion rewrites it)
    arts = [te.file for _k, te in s._spill.items_for_snapshot()[1]]
    s.register("D", sess.random(D.shape, dtype="bfloat16", seed=9))
    after = dict(s.result_cache_info()["spill"])
    left = [f for f in arts if os.path.exists(f)]
    if (before["host_entries"] < 1 or before["disk_entries"] < 1
            or not arts or after["host_entries"] or after["disk_entries"]
            or left or s.result_cache_info()["entries"]):
        raise AssertionError(f"durable (a) rebind: before {before}, after "
                             f"{after}, artifacts {arts} -> {left}")
    log(f"durable (a) rebind of D: host {before['host_entries']} -> 0, "
        f"disk {before['disk_entries']} -> 0, its artifacts {len(arts)} "
        f"unlinked")
    launches = ops_since(c0)
    del s, S2, S3
    return {"launches": launches, "tiers": info, "stamp": stamp,
            "legs": priced, "thaw_ms": thaw_s * 1e3, "host_copy": pins,
            "rebind": {"before": before, "after": after},
            "peak_gib": meter.gib()}


def durable_restart(sess, S, D, root: str) -> dict:
    """(b) save_state, then restore in a fresh session (spill_enable,
    the same state_dir): its first consult of S·D answers from the
    snapshot, bit-equal, with no B1 launch. A sha1-tampered artifact is
    a miss (B1 launches once, the answer right); a truncated snapshot
    cold-starts with a warning."""
    import logging
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    meter = PeakMeter("durable_restart", DURABLE_PEAK_LIMIT_GIB)
    cfg = MatrelConfig(result_cache_max_bytes=8 << 30, spill_enable=True,
                       state_dir=os.path.join(root, "b"))

    def fresh():
        return MatrelSession(config=cfg, device=sess.device)

    def q(s):
        return s.table("S").multiply(s.table("D"))

    s1 = fresh()
    s1.register("S", S)
    s1.register("D", D)
    c0 = ops_counts()
    first = s1.compute(q(s1))
    save = s1.save_state()
    del s1
    s2 = fresh()
    rest, restore_s = synced(s2.restore)
    c1 = ops_counts()
    got, thaw_s = synced(lambda: s2.compute(q(s2)))
    thawed = s2.result_cache_info()["spill"]["thawed_restored"]
    if (not rest["restored"] or rest["rc_entries"] != 1 or thawed != 1
            or ops_since(c1)["spmm_blocksparse"] != 0
            or not torch.equal(got.data, first.data)):
        raise AssertionError(f"durable (b): restore {rest}, thawed "
                             f"{thawed}, B1 {ops_since(c1)}")
    del s2, got
    spill_dir = os.path.join(cfg.state_dir, "spill")
    (victim,) = [f for f in os.listdir(spill_dir) if f.endswith(".npy")]
    with open(os.path.join(spill_dir, victim), "r+b") as fh:
        fh.seek(-1, os.SEEK_END)
        last = fh.read(1)
        fh.seek(-1, os.SEEK_END)
        fh.write(bytes([last[0] ^ 0x01]))      # one flipped bit
    s3 = fresh()
    s3.restore()
    c2 = ops_counts()
    got3 = s3.compute(q(s3))
    corrupt = s3.result_cache_info()["spill"]["corrupt"]
    if (corrupt != 1 or ops_since(c2)["spmm_blocksparse"] != 1
            or not torch.equal(got3.data, first.data)):
        raise AssertionError(f"durable (b) tampered: corrupt {corrupt}, "
                             f"B1 {ops_since(c2)}")
    del s3, got3
    step_dir = save["path"]
    meta = os.path.join(step_dir, "meta.json")
    with open(meta, "r+b") as fh:
        fh.truncate(os.path.getsize(meta) // 2)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logging.getLogger("matrel_tpu_torch.serve").addHandler(handler)
    try:
        s4 = fresh()
        cold = s4.restore()
    finally:
        logging.getLogger("matrel_tpu_torch.serve").removeHandler(handler)
    warned = [r.getMessage() for r in records
              if r.levelno >= logging.WARNING]
    if cold["restored"] or not any("cold-starting" in w for w in warned):
        raise AssertionError(f"durable (b) truncated: {cold}, {warned}")
    del s4, first
    log(f"durable (b): save_state {save['ms']:.1f} ms ({save['catalog']} "
        f"tables, {save['rc_entries']} entry); restore "
        f"{restore_s * 1e3:.1f} ms; first consult from the snapshot "
        f"{thaw_s * 1e3:.3f} ms, bit-equal, no B1 launch; a flipped bit in "
        f"the artifact: a miss, B1 once, the right answer; a truncated "
        f"snapshot cold-starts ({warned[0][:80]})")
    return {"launches": ops_since(c0), "save_ms": save["ms"],
            "restore_ms": restore_s * 1e3, "thaw_ms": thaw_s * 1e3,
            "peak_gib": meter.gib()}


def durable_checkpoint(sess, S, D, root: str) -> dict:
    """(c) save_catalog / load_catalog of row 4's S and D and S·D
    recomputed bit-equal; run_resilient over block-sparse PageRank (B1's
    f32 narrow walk, one launch a round) with a checkpoint every 5
    rounds and one transient fault injected at the checkpoint site,
    ending bit-equal to an unfaulted run and to pagerank_block_sparse."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.core.blockmatrix import BlockMatrix
    from matrel_tpu_torch.ops import spmm as spmm_lib
    from matrel_tpu_torch.resilience import faults
    from matrel_tpu_torch.utils.checkpoint import CheckpointManager
    from matrel_tpu_torch.utils.resilience import run_resilient
    from matrel_tpu_torch.workloads import pagerank as pr
    meter = PeakMeter("durable_checkpoint", DURABLE_PEAK_LIMIT_GIB)
    c0 = ops_counts()
    s1 = MatrelSession(device=sess.device)
    s1.register("S", S)
    s1.register("D", D)
    want = s1.compute(S.multiply(D))
    _, save_s = synced(lambda: s1.save_catalog(os.path.join(root, "cat")))
    s2 = MatrelSession(device=sess.device)
    names, load_s = synced(lambda: s2.load_catalog(
        os.path.join(root, "cat")))
    c1 = ops_counts()
    got = s2.compute(s2.table("S").multiply(s2.table("D")))
    if (names != ["D", "S"] or ops_since(c1)["spmm_blocksparse"] != 1
            or not torch.equal(got.data, want.data)):
        raise AssertionError(f"durable (c) catalog: {names}, "
                             f"{ops_since(c1)}")
    del s1, s2, got, want
    G = community_graph(sess)
    n, mesh, alpha = G.shape[0], sess.mesh, 0.85
    st = G.transpose()
    deg = spmm_lib.spmm(G, BlockMatrix.from_numpy(
        np.ones((n, 1), np.float32), mesh=mesh)).data
    zero = torch.zeros((), dtype=deg.dtype, device=deg.device)
    inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1e-30), zero)
    valid = (torch.arange(deg.shape[0], device=deg.device) < n)[:, None]
    dangling = ((deg == 0) & valid).float()
    r0 = BlockMatrix.from_numpy(np.full((n, 1), 1.0 / n, np.float32),
                                mesh=mesh)

    def body(step, mats, state):
        r = mats["r"]
        w = BlockMatrix.from_array(r.data * inv_deg, (n, 1), mesh, r.spec)
        contrib = spmm_lib.spmm(st, w).data
        dmass = torch.sum(dangling * r.data)
        r_new = torch.where(valid, alpha * (contrib + dmass / n)
                            + (1.0 - alpha) / n, zero)
        return ({"r": BlockMatrix.from_array(r_new, (n, 1), mesh, r.spec)},
                dict(state, last=step, rounds=state.get("rounds", 0) + 1))

    def run(sub, spec):
        faults.reset()
        cm = CheckpointManager(os.path.join(root, sub),
                               config=MatrelConfig(fault_inject=spec))
        return run_resilient(body, cm, mesh, {"r": r0},
                             num_steps=DURABLE_PR_ROUNDS,
                             checkpoint_interval=DURABLE_CKPT_INTERVAL)

    c2 = ops_counts()
    (clean, cstate), clean_s = synced(lambda: run("clean", ""))
    (faulted, fstate), fault_s = synced(lambda: run("faulted",
                                                    DURABLE_FAULT))
    faults.reset()
    rounds = ops_since(c2)["spmm_blocksparse"]
    ref = pr.pagerank_block_sparse(G, rounds=DURABLE_PR_ROUNDS)
    redo = 2 * DURABLE_CKPT_INTERVAL - DURABLE_CKPT_INTERVAL
    if (not torch.equal(faulted["r"].data, clean["r"].data)
            or not torch.equal(clean["r"].data[:n], ref)
            or cstate["rounds"] != DURABLE_PR_ROUNDS
            or fstate["rounds"] != DURABLE_PR_ROUNDS
            or rounds != 2 * DURABLE_PR_ROUNDS + redo):
        raise AssertionError(f"durable (c) run_resilient: states "
                             f"{cstate} {fstate}, B1 {rounds}")
    log(f"durable (c): save_catalog {save_s * 1e3:.1f} ms, load_catalog "
        f"{load_s * 1e3:.1f} ms, S·D recomputed bit-equal; run_resilient "
        f"PageRank {DURABLE_PR_ROUNDS} rounds clean {clean_s * 1e3:.1f} ms, "
        f"with the checkpoint fault {fault_s * 1e3:.1f} ms ({redo} rounds "
        f"redone from the step-{DURABLE_CKPT_INTERVAL - 1} checkpoint), "
        f"bit-equal to the clean run and to pagerank_block_sparse")
    del G, st, clean, faulted, ref
    return {"launches": ops_since(c0), "save_catalog_ms": save_s * 1e3,
            "load_catalog_ms": load_s * 1e3, "clean_ms": clean_s * 1e3,
            "faulted_ms": fault_s * 1e3, "peak_gib": meter.gib()}


def durable_verify(sess, latency, root: str) -> dict:
    """(d) verify_plans="error" on row 4's S·D (B1), row 5's Âᵀ·x (B2)
    and the bf16 random S×S query (B4): no error diagnostic, one launch
    each, the Verifier section in each explain, the plan.verify span with
    obs on, the verifier's host ms a plan; warm queries against
    path_latency's figures; then session.verify on a hand-tampered spill
    stamp fires MV117."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession, analysis
    from matrel_tpu_torch.ir import expr as expr_mod
    from matrel_tpu_torch.obs.events import read_events
    meter = PeakMeter("durable_verify", DURABLE_PEAK_LIMIT_GIB)
    qs = ops_queries(sess)
    log_path = os.path.join(root, "verify.jsonl")
    on = MatrelSession(config=MatrelConfig(
        verify_plans="error", obs_level="on", obs_event_log=log_path),
        device=sess.device)
    warm = MatrelSession(config=MatrelConfig(verify_plans="error"),
                         device=sess.device)
    ref = MatrelSession(device=sess.device)
    lat_name = {"B1": "row4 S·D", "B2": "row5 A·x",
                "B4": "S×S spgemm_pairs (pallas_generic)"}
    c0 = ops_counts()
    rows = {}
    for name, (build, kern) in qs.items():
        e = build()
        c = ops_counts()
        out = on.compute(e)
        got = ops_since(c)[kern]
        plan = on.compile(e)
        diags = plan.meta["diagnostics"]
        errors = [d for d in diags if d["severity"] == "error"]
        text = on.explain(e)
        want = ref.compute(build())
        if (got != 1 or errors or "== Verifier ==" not in text
                or not torch.equal(out.data, want.data)):
            raise AssertionError(f"durable (d) {name}: launches {got}, "
                                 f"diagnostics {diags}")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            analysis.verify_plan(plan.optimized, on.mesh, plan.config)
            times.append((time.perf_counter() - t0) * 1e3)
        ew = build()
        warm.compute(ew)
        ms = time_ms(lambda: warm.compute(ew), warmup=2, runs=10)
        lat = (latency or {}).get(lat_name[name])
        if lat is not None and not 2 / 3 <= ms / lat <= 1.5:
            raise AssertionError(f"durable (d) {name}: warm {ms:.4f} ms "
                                 f"with the verifier on, path_latency "
                                 f"{lat:.4f}")
        rows[name] = {"diagnostics": [d["code"] for d in diags],
                      "verify_ms": statistics.median(times),
                      "warm_ms": ms, "path_latency_ms": lat}
        log(f"durable (d) {name}: {len(diags)} diagnostic(s) "
            f"{[d['code'] for d in diags]}, {kern} launched once, verify "
            f"{statistics.median(times):.3f} ms a plan (host); warm "
            f"compute() {ms:.4f} ms against path_latency "
            f"{lat if lat is None else f'{lat:.4f}'} ms")
        del out, want
    spans = [r for r in read_events(log_path)
             if r["kind"] == "span" and r["name"] == "plan.verify"]
    if len(spans) != len(qs):
        raise AssertionError(f"durable (d): {len(spans)} plan.verify spans")
    rows["span_ms"] = [s["dur_ms"] for s in spans]
    S, D = row4_inputs(sess)
    stale = expr_mod.leaf(D).with_attrs(result_cache={
        "key_hash": "tampered", "layout": "2d", "dtype": "bfloat16",
        "deps": [], "spill": {"tier": "hbm", "legs": [],
                              "cost": "measured"}})
    codes = [d.code for d in on.verify(S.multiply(stale))]
    if "MV117" not in codes:
        raise AssertionError(f"durable (d) tampered stamp: {codes}")
    rows["tampered"] = codes
    log(f"durable (d): plan.verify spans {rows['span_ms']} ms; a spill "
        f"stamp claiming the device tier: {codes}")
    rows["launches"] = ops_since(c0)
    del qs, on, warm, ref, S, D
    rows["peak_gib"] = meter.gib()
    return rows


def durable_replan(sess, root: str) -> dict:
    """(e) a (2, 4) virtual-grid session with coeff_replan_enable and an
    interval of DURABLE_REPLAN_INTERVAL records streams warm 4096²
    products. One card runs every strategy as the same local product, so
    its own timings hold no rank-order inversion: the window is seeded
    with one at this query's dims (cpmm, the fewest estimated bytes,
    measured 10x slower than each other candidate; DURABLE_REPLAN_SEED
    records a strategy, round robin). The controller checks on the
    records, re-calibrates, bumps the epoch and re-warms the plan; every
    answer is bit-equal to the first, and the re-planned decision differs
    from the first only in its strategy stamp (with that strategy's
    priced bytes) and cost provenance."""
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.executor import plan_matmul_decisions
    from matrel_tpu_torch.parallel import coeffs
    meter = PeakMeter("durable_replan", DURABLE_PEAK_LIMIT_GIB)
    table = os.path.join(root, "replan_drift.json")
    s = MatrelSession(config=MatrelConfig(
        mesh_shape=OPS_GRID, obs_level="on",
        obs_event_log=os.path.join(root, "replan.jsonl"),
        drift_table_path=table, coeff_planner_enable=True,
        coeff_replan_enable=True,
        coeff_replan_interval=DURABLE_REPLAN_INTERVAL,
        coeff_replan_cooldown=2), device=sess.device)
    ctl = s._replan
    X = s.random((4096, 4096), seed=4)
    Y = s.random((4096, 4096), seed=5)
    first = s.compute(X.multiply(Y))
    dec0 = [{k: v for k, v in d.items() if k != "uid"}
            for d in plan_matmul_decisions(s.compile(X.multiply(Y)))]
    dims = dec0[0]["dims"]
    for _ in range(DURABLE_REPLAN_SEED):
        for strat in OPS_STRATEGIES:
            ms, est = (10.0, 1000.0) if strat == "cpmm" else (1.0, 2000.0)
            ctl.observe({"kind": "query", "backend": sess.device.type,
                         "cache": "miss", "execute_ms": ms,
                         "matmuls": [{"strategy": strat, "dims": dims,
                                      "flops": 2.0 * dims[0] * dims[1]
                                      * dims[2], "est_ici_bytes": est}]})
    t0 = time.perf_counter()
    for _ in range(DURABLE_REPLAN_QUERIES):
        out = s.compute(X.multiply(Y))
        if not torch.equal(out.data, first.data):
            raise AssertionError("durable (e): a re-planned answer differs")
    ctl.drain(60.0)
    stream_s = time.perf_counter() - t0
    dec1 = [{k: v for k, v in d.items() if k != "uid"}
            for d in plan_matmul_decisions(s.compile(X.multiply(Y)))]
    changed = sorted({k for a, b in zip(dec0, dec1) for k in set(a) | set(b)
                      if a.get(k) != b.get(k)})
    info = ctl.info()
    rec = ctl.events[0] if ctl.events else {}
    if (info["replans"] < 1 or info["checks"] < 2
            or not set(changed) <= {"strategy", "source", "cost",
                                    "est_ici_bytes", "est_axis_bytes"}
            or s._coeff_prefix() != f"coeffv:{coeffs.epoch(table)}|"):
        raise AssertionError(f"durable (e): {info}, changed {changed}, "
                             f"round {rec}")
    log(f"durable (e): {DURABLE_REPLAN_QUERIES} warm queries in "
        f"{stream_s:.2f} s; controller {info}; round 1 {rec.get('classes')} "
        f"epoch {rec.get('old_epoch')} -> {rec.get('epoch')}, re-warmed "
        f"{rec.get('replanned')} of {rec.get('matched')}; decision "
        f"{[(d['strategy'], d.get('cost')) for d in dec0]} -> "
        f"{[(d['strategy'], d.get('cost')) for d in dec1]}; changed "
        f"{changed}; every answer bit-equal")
    del s, X, Y, first, out
    return {"controller": info, "round": {k: rec.get(k) for k in (
        "classes", "old_epoch", "epoch", "matched", "replanned")},
        "changed": changed, "stream_s": stream_s, "peak_gib": meter.gib()}


def path_durable(sess, latency=None) -> dict:
    """The durable half of serving and the static plan verifier on the
    card (serve/spill.py, utils/checkpoint.py, utils/resilience.py,
    serve/replan.py, analysis/): (a) the spill tiers at row 4's size,
    (b) warm restart, (c) the catalog checkpoint and run_resilient, (d)
    the verifier on the main path over B1, B2 and B4, (e) re-planning.
    All state goes to a directory under the gitignored build/, removed
    at the end; each sub-phase its own peak bound
    (DURABLE_PEAK_LIMIT_GIB)."""
    import shutil
    import torch
    t0 = time.perf_counter()
    root = durable_root()
    c0 = ops_counts()
    S, D = row4_inputs(sess)
    rows = {}
    try:
        rows["spill"] = durable_spill(sess, S, D, root)
        rows["restart"] = durable_restart(sess, S, D, root)
        rows["checkpoint"] = durable_checkpoint(sess, S, D, root)
        del S, D
        torch.cuda.empty_cache()
        rows["verify"] = durable_verify(sess, latency, root)
        torch.cuda.empty_cache()
        rows["replan"] = durable_replan(sess, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    total = ops_since(c0)
    log(f"path durable: {time.perf_counter() - t0:.1f} s; launches B1 "
        f"{total['spmm_blocksparse']}, B2 {total['spmv_compact']}, B4 "
        f"{total['spgemm_pairs']}")
    print(json.dumps({"durable": rows}, default=str))
    bodies = {k[3:]: v for k, v in total.items()
              if k.startswith("b1_") and v}
    return {"launches": total, "spmm_bodies": bodies, "rows": rows}


def durable_only() -> int:
    """``python3 chip_smoke.py --durable``: only path_durable (after
    building the kernels), printing the card line and its launches; (d)
    then compares the warm queries with PERF.md's latencies only by
    eye."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    log(f"torch {torch.__version__}; {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    out = path_durable(MatrelSession())
    print(card)
    print(json.dumps({"durable_launches": out["launches"]}))
    return 0


# -- the multi-slice serving fleet and the operator tools (path_fleet) ---------

#: Each sub-phase's peak device memory over what was held when it
#: started (the checks' own tensors left out), measured on the H100
#: (PERF.md §6, path_fleet), plus 25%. A directory hit allocates
#: nothing.
FLEET_PEAK_LIMIT_GIB = {k: 1.25 * v for k, v in {
    "fleet_submit": 2.805, "fleet_hit": 0.0, "fleet_replicate": 0.192,
    "fleet_failover": 2.150, "fleet_rebind": 0.288, "fleet_virtual": 2.881,
    "fleet_tools": 0.863}.items()}
#: (a) the mix's names, the kernel each reaches (None: cuBLAS only),
#: and the tenant of the client thread that submits it.
FLEET_MIX = (("row4 S·D", "spmm_blocksparse", "a"),
             ("row5 A·x", "spmv_compact", "a"),
             ("S×S 1% bf16", "spgemm_pairs", "b"),
             ("row2 A·B·C", None, "b"))
#: (a) warm slice-placed submits timed on a cache-off fleet, and (c)
#: the hot-entry threshold.
FLEET_WARM_RUNS = 10
FLEET_REPLICATE_HITS = 2
FLEET_DIR = os.path.join(HERE, "build", "chip_smoke", "fleet")
#: path_row5_pagerank's top ten (node, rank), which (g) holds the CLI's
#: PageRank to when the whole script runs.
ROW5_PR_TOP: list = []


def fleet_tables(sess) -> dict:
    """Register the fleet mix's tables in ``sess``'s catalog (a query is
    fleet-eligible only over named tables): row 4's S and D, row 5's Âᵀ
    and x, the 1% random bf16 pair at 32,768, row 2's A, B, C."""
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.workloads import chain_bench
    S, D = row4_inputs(sess)
    _src, _dst, A = row5_matrix()
    tables = {"S": S, "D": D, "A5": A,
              "x5": sess.random((ROW5_N, 1), seed=6)}
    for nm, s in (("P", 2), ("Q", 3)):
        tables[nm] = BlockSparseMatrix.random(
            (SPGEMM_CMP_N, SPGEMM_CMP_N), 0.01, block_size=512,
            mesh=sess.mesh, seed=s, dtype="bfloat16")
    for nm, m in zip(("R2A", "R2B", "R2C"), chain_bench.skewed_abc(
            sess.mesh, n=10_000, mid=100, seed=3)):
        tables[nm] = m
    for nm, m in tables.items():
        sess.register(nm, m)
    return tables


def fleet_queries(sess) -> dict:
    """The mix over ``sess``'s catalog, each a builder of a fresh tree."""
    from matrel_tpu_torch.workloads import chain_bench
    t = sess.table
    return {"row4 S·D": lambda: t("S").multiply(t("D")),
            "row5 A·x": lambda: t("A5").multiply(t("x5")),
            "S×S 1% bf16": lambda: t("P").multiply(t("Q")),
            "row2 A·B·C": lambda: chain_bench.build_chain(
                [t("R2A"), t("R2B"), t("R2C")])}


def fleet_plain(qs: dict, tables: dict, device) -> dict:
    """Each query through one plain session (cache off) over the same
    tables: the answers the fleet is held bit-equal to."""
    from matrel_tpu_torch import MatrelSession
    plain = MatrelSession(device=device)
    for nm, m in tables.items():
        plain.register(nm, m)
    pq = fleet_queries(plain)
    return {name: plain.compute(pq[name]()) for name in qs}


def fleet_session(dev, log_path: str, **over):
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    cfg = dict(fleet_slices=2, result_cache_max_bytes=8 << 30,
               obs_level="on", obs_event_log=log_path, obs_provenance=64,
               serve_tenant_weights="a:2,b:1")
    cfg.update(over)
    return MatrelSession(config=MatrelConfig(**cfg), device=dev)


def same_bits(name: str, got, want) -> None:
    import torch
    if got.shape != want.shape or got.dtype != want.dtype \
            or not torch.equal(got.data, want.data):
        raise AssertionError(f"fleet {name}: not bit-equal to one plain "
                             f"session ({got.dtype} {got.shape} vs "
                             f"{want.dtype} {want.shape})")


def submit_ms(sess, e, routed=None, **kw):
    """Submit-to-result on the host clock, the result synchronised;
    ``routed`` (a list) collects the time ``submit`` took to return."""
    import torch
    t0 = time.perf_counter()
    fut = sess.submit(e, **kw)
    if routed is not None:
        routed.append((time.perf_counter() - t0) * 1e3)
    out = fut.result(timeout=900)
    if getattr(fut, "ready_event", None) is not None:
        fut.ready_event.synchronize()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def fleet_submit(sess, qs, want, dev) -> dict:
    """(a) Four client threads of two tenants submit the four queries at
    once; every answer bit-equal to one plain session, each placed on a
    slice, B1, B2 and B4 launched through the slice sessions. Then the
    warm latency of a slice-placed S·D (a cache-off fleet, so every
    submit computes) beside one cache-off session's submit."""
    import threading
    import torch
    meter = PeakMeter("fleet_submit", FLEET_PEAK_LIMIT_GIB)
    got, errors, lock = {}, [], threading.Lock()
    go = threading.Barrier(len(FLEET_MIX), timeout=900)

    def client(name, tenant):
        try:
            torch.cuda.set_device(dev)
            go.wait()
            out, ms = submit_ms(sess, qs[name](), tenant=tenant)
            with lock:
                got[name] = (out, ms)
        except BaseException as ex:      # noqa: BLE001 — re-raised below
            errors.append(ex)
            go.abort()

    c0 = ops_counts()
    threads = [threading.Thread(target=client, args=(n, t), daemon=True)
               for n, _k, t in FLEET_MIX]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or len(got) != len(FLEET_MIX):
        raise AssertionError(f"fleet (a): clients failed: {errors!r}")
    sess.serve_drain(timeout=900)
    launched = ops_since(c0)
    for name, kern, _t in FLEET_MIX:
        with meter.aside():
            same_bits(f"(a) {name}", got[name][0], want[name])
        if kern is not None and launched[kern] < 1:
            raise AssertionError(f"fleet (a): {kern} never launched")
    info = sess.fleet_info()
    if info["source"] != "shared" or info["placed"] != {
            "slice": len(FLEET_MIX), "span": 0}:
        raise AssertionError(f"fleet (a): census {info['placed']} on "
                             f"{info['source']} slices")
    per_slice = {s["id"]: s["submitted"] for s in info["slices"]}
    # warm slice-placed latency: a cache-off fleet computes every submit
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    cold = MatrelSession(config=MatrelConfig(fleet_slices=2), device=dev)
    single = MatrelSession(device=dev)
    for s in (cold, single):
        s.register("S", sess.table("S"))
        s.register("D", sess.table("D"))
    warm, routed = {}, {}
    for label, s in (("fleet", cold), ("single", single), ("fleet", cold),
                     ("single", single)):
        q = s.table("S").multiply(s.table("D"))
        submit_ms(s, q)                                 # compile, warm
        ret = []
        times = [submit_ms(s, q, routed=ret)[1]
                 for _ in range(FLEET_WARM_RUNS)]
        warm.setdefault(label, []).append(statistics.median(times))
        routed.setdefault(label, []).append(statistics.median(ret))
    for s in (cold, single):
        s.serve_close(timeout=900)
    row = {"placed": info["placed"], "per_slice": per_slice,
           "first_ms": {n: got[n][1] for n in got},
           "launches": {k: launched[k] for k in
                        ("spmm_blocksparse", "spmv_compact",
                         "spgemm_pairs")},
           "warm_slice_ms": warm["fleet"], "warm_single_ms": warm["single"],
           "submit_return_ms": routed, "peak_gib": meter.gib()}
    log(f"fleet (a): {len(FLEET_MIX)} queries by {len(FLEET_MIX)} client "
        f"threads (tenants a, a, b, b) placed {info['placed']} on "
        f"{info['source']} slices {per_slice}; first submit-to-result ms "
        + ", ".join(f"{n} {ms:.1f}" for n, ms in row["first_ms"].items())
        + f"; launches {row['launches']}; every answer bit-equal to one "
        f"plain session; warm slice-placed S·D "
        f"{'/'.join(f'{v:.3f}' for v in warm['fleet'])} ms against one "
        f"session's submit {'/'.join(f'{v:.3f}' for v in warm['single'])}"
        f" ms (median of {FLEET_WARM_RUNS}, in turns; submit() itself "
        f"returned in {'/'.join(f'{v:.3f}' for v in routed['fleet'])} / "
        f"{'/'.join(f'{v:.3f}' for v in routed['single'])} ms); peak "
        f"{row['peak_gib']:.3f} GiB")
    return row


def fleet_hit(sess, qs, want) -> dict:
    """(b) The same four queries again: round robin prefers the other
    slice, and the directory answers each from its owner's cache with
    no launch."""
    meter = PeakMeter("fleet_hit", FLEET_PEAK_LIMIT_GIB)
    d0 = sess._fleet.directory.info()
    c0 = ops_counts()
    lat = {}
    for name, _k, tenant in FLEET_MIX:
        out, lat[name] = submit_ms(sess, qs[name](), tenant=tenant)
        with meter.aside():
            same_bits(f"(b) {name}", out, want[name])
    launched = ops_since(c0)
    d1 = sess._fleet.directory.info()
    hits = d1["hits"] - d0["hits"]
    if any(launched[k] for k in ("spmm_blocksparse", "spmv_compact",
                                 "spgemm_pairs")) or hits != len(FLEET_MIX):
        raise AssertionError(f"fleet (b): {hits} directory hits, launches "
                             f"{launched}")
    row = {"hit_ms": lat, "hits": hits,
           "remote": d1["remote_hits"] - d0["remote_hits"],
           "peak_gib": meter.gib()}
    log(f"fleet (b): {hits} directory hits ({row['remote']} remote), 0 "
        f"launches, bit-equal; submit-to-result ms "
        + ", ".join(f"{n} {ms:.3f}" for n, ms in lat.items())
        + " (path_serving's single-session cache hit: ~1.4 ms, PERF.md)")
    return row


def fleet_replicate(sess, qs, want) -> dict:
    """(c) Hot-entry replication of S·D (``fleet_replicate_hits`` = 2):
    remote hits until the entry migrates; the copy (device to host to
    device, timed around ``_replicate_entry``) and what the reshard plan
    priced (the ``migrate`` event); the replica answers bit-equal."""
    import torch
    from matrel_tpu_torch.obs.events import read_events
    from matrel_tpu_torch.serve import placement
    meter = PeakMeter("fleet_replicate", FLEET_PEAK_LIMIT_GIB)
    fleet = sess._fleet
    name = "row4 S·D"
    timed = []
    orig = fleet._replicate_entry

    def timed_copy(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(*a, **kw)
        torch.cuda.synchronize()
        timed.append((time.perf_counter() - t0) * 1e3)
        return out

    fleet._replicate_entry = timed_copy
    try:
        for _ in range(8):
            submit_ms(sess, qs[name]())
            fleet.quiesce_replication(timeout=900)
            if fleet.migrations:
                break
    finally:
        del fleet._replicate_entry
    fkey = placement.fleet_key(qs[name](), fleet._names)
    rec = fleet.directory.lookup(fkey)
    if fleet.migrations != 1 or not rec.replicas:
        raise AssertionError(f"fleet (c): {fleet.migrations} migrations, "
                             f"replicas {rec.replicas}")
    (rid, rkey), = rec.replicas.items()
    ent = fleet.slice_by_id(rid).session._result_cache.lookup(rkey)
    with meter.aside():
        same_bits("(c) replica", ent.result, want[name])
    c0 = ops_counts()
    hit_lat = [submit_ms(sess, qs[name]())[1] for _ in range(4)]
    if ops_since(c0)["spmm_blocksparse"]:
        raise AssertionError("fleet (c): a replica hit launched B1")
    ev = [e for e in read_events(sess.config.obs_event_log)
          if e.get("kind") == "fleet" and e.get("event") == "migrate"]
    mig = ev[-1]
    row = {"copy_ms": timed, "nbytes": mig["nbytes"],
           "reshard_steps": mig["reshard_steps"],
           "peak_bytes": mig["peak_bytes"],
           "est_dcn_cost": mig["est_dcn_cost"], "replica_slice": rid,
           "owner": rec.owner, "hits_ms": hit_lat, "peak_gib": meter.gib()}
    log(f"fleet (c): S·D ({mig['nbytes'] / 2**20:.1f} MiB, "
        f"{ent.dtype}) replicated slice {rec.owner} -> {rid} after "
        f"{FLEET_REPLICATE_HITS} remote hits: copy {timed[-1]:.3f} ms "
        f"(host clock, synchronised; through the host, pageable); the "
        f"reshard plan priced steps {mig['reshard_steps']}, peak "
        f"{mig['peak_bytes'] / 2**20:.1f} MiB, DCN bill "
        f"{mig['est_dcn_cost'] / 2**20:.1f} MiB-weighted; replica "
        f"bit-equal; then hits {'/'.join(f'{v:.3f}' for v in hit_lat)} ms"
        f", 0 launches; peak {row['peak_gib']:.3f} GiB")
    return row


def fleet_failover(sess, tables, qs, want, dev, log_path) -> dict:
    """(d) A fresh fleet over the same tables: the four queries and one
    already-expired entry queued on slice 0 before its worker starts,
    then ``kill_slice(0)``: the four re-admit on slice 1 (tenants kept)
    and answer bit-equal, the expired one fails typed; with no live
    slice a submit refuses typed (``FleetSliceLost``)."""
    from concurrent.futures import Future
    from matrel_tpu_torch.resilience.errors import (DeadlineExceeded,
                                                     FleetSliceLost)
    from matrel_tpu_torch.resilience.retry import Deadline
    meter = PeakMeter("fleet_failover", FLEET_PEAK_LIMIT_GIB)
    fs = fleet_session(dev, log_path)
    for nm, m in tables.items():
        fs.register(nm, m)
    fq = fleet_queries(fs)
    fleet = fs._ensure_fleet()
    sl = fleet.slices[0]
    pipe = sl.session._ensure_serve()
    futs = {}
    for name, _k, tenant in FLEET_MIX:
        fut = Future()
        fut.ready_event = None
        pipe._q.put((fleet._rebind(fq[name](), sl), fut,
                     time.perf_counter(), "default", Deadline(600_000.0),
                     tenant, None), tenant)
        futs[name] = fut
    late = Future()
    late.ready_event = None
    dl = Deadline(0.001)
    time.sleep(0.01)
    pipe._q.put((fleet._rebind(fq["row2 A·B·C"](), sl), late,
                 time.perf_counter(), "default", dl, "b", None), "b")
    depths = pipe._q.tenant_depths()
    c0 = ops_counts()
    t0 = time.perf_counter()
    requeued = fleet.kill_slice(0)
    kill_ms = (time.perf_counter() - t0) * 1e3
    for name, fut in futs.items():
        out = fut.result(timeout=900)
        with meter.aside():
            same_bits(f"(d) {name}", out, want[name])
    del out
    try:
        late.result(timeout=900)
    except DeadlineExceeded:
        pass
    else:
        raise AssertionError("fleet (d): an expired entry was served")
    fs.serve_drain(timeout=900)
    launched = ops_since(c0)
    survivor = fleet.slices[1].submitted
    fleet.kill_slice(1)
    try:
        fs.submit(fq["row4 S·D"]()).result(timeout=900)
    except FleetSliceLost:
        pass
    else:
        raise AssertionError("fleet (d): no live slice, yet answered")
    info = fs.fleet_info()
    fs.serve_close(timeout=900)
    if requeued != len(FLEET_MIX) or info["failovers"] != 2:
        raise AssertionError(f"fleet (d): requeued {requeued}, "
                             f"failovers {info['failovers']}")
    row = {"queued": depths, "requeued": requeued, "kill_ms": kill_ms,
           "survivor_submitted": survivor,
           "launches": {k: launched[k] for k in
                        ("spmm_blocksparse", "spmv_compact",
                         "spgemm_pairs")},
           "peak_gib": meter.gib()}
    log(f"fleet (d): queued {depths} on slice 0, kill_slice(0) in "
        f"{kill_ms:.3f} ms re-admitted {requeued} onto slice 1, every "
        f"answer bit-equal (launches {row['launches']}); the expired "
        f"entry failed DeadlineExceeded; with no live slice a submit "
        f"failed FleetSliceLost; peak {row['peak_gib']:.3f} GiB")
    return row


def fleet_rebind(sess, tables, qs) -> dict:
    """(e) Rebind D: the directory's records over D and the slices'
    cached S·D drop; the next S·D computes (B1) bit-equal to one plain
    session on the new D."""
    meter = PeakMeter("fleet_rebind", FLEET_PEAK_LIMIT_GIB)
    fleet = sess._fleet
    d0 = fleet.directory.info()
    D2 = sess.random(tables["D"].shape, dtype="bfloat16", seed=12)
    t0 = time.perf_counter()
    sess.register("D", D2)
    reg_ms = (time.perf_counter() - t0) * 1e3
    d1 = fleet.directory.info()
    new_tables = dict(tables, D=D2)
    want = fleet_plain({"row4 S·D": None}, new_tables, sess.device)
    c0 = ops_counts()
    out, ms = submit_ms(sess, qs["row4 S·D"]())
    with meter.aside():
        same_bits("(e) row4 S·D after rebind", out, want["row4 S·D"])
    launched = ops_since(c0)["spmm_blocksparse"]
    dropped = d1["invalidated"] - d0["invalidated"]
    if dropped < 1 or launched < 1:
        raise AssertionError(f"fleet (e): {dropped} records dropped, B1 "
                             f"launched {launched}")
    row = {"register_ms": reg_ms, "records_dropped": dropped,
           "answer_ms": ms, "b1": launched, "peak_gib": meter.gib()}
    log(f"fleet (e): register('D') in {reg_ms:.3f} ms dropped {dropped} "
        f"directory record(s) and the slices' cached S·D; the next S·D "
        f"launched B1 {launched} time(s) in {ms:.3f} ms, bit-equal to one "
        f"plain session on the new D; peak {row['peak_gib']:.3f} GiB")
    return row, new_tables


def fleet_virtual(dev, log_path) -> dict:
    """(f) The (2, 4) virtual grid with verify_plans="error": two (2, 2)
    slices; dense tables rebuilt on each sub-grid, the sparse ones
    (S, Âᵀ, P, Q) pinned to the span. 0 diagnostics on every plan, and
    each answer bit-equal to one plain session on the grid it ran on."""
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    meter = PeakMeter("fleet_virtual", FLEET_PEAK_LIMIT_GIB)
    fs = fleet_session(dev, log_path, mesh_shape=(2, 4),
                       verify_plans="error")
    tables = fleet_tables(fs)
    fq = fleet_queries(fs)
    c0 = ops_counts()
    got = {name: fs.submit(fq[name](), tenant=t).result(timeout=900)
           for name, _k, t in FLEET_MIX}
    fs.serve_drain(timeout=900)
    launched = ops_since(c0)
    fleet = fs._fleet
    pinned = sorted(nm for nm, m in tables.items()
                    if id(m) not in fleet._names)
    diags = []
    for s in [fs] + [sl.session for sl in fleet.slices]:
        for plan in list(s._plan_cache.values()):
            diags += (plan.meta or {}).get("diagnostics") or []
    info = fs.fleet_info()
    # the dense row-2 chain runs on a (2, 2) slice over its rebuilt
    # tables when placement keeps it there, else on the (2, 4) parent
    on_slice = info["placed"]["slice"] == 1
    with meter.aside():
        for grid, names in (((2, 4), [n for n, k, _t in FLEET_MIX
                                      if k or not on_slice]),
                            ((2, 2), ["row2 A·B·C"] if on_slice else [])):
            if not names:
                continue
            src = fs if grid == (2, 4) else fleet.slices[0].session
            plain = MatrelSession(config=MatrelConfig(mesh_shape=grid),
                                  device=dev)
            for nm in tables:
                if nm in src.catalog:
                    plain.register(nm, src.catalog[nm])
            pq = fleet_queries(plain)
            for name in names:
                same_bits(f"(f) {name}", got[name],
                          plain.compute(pq[name]()))
    fs.serve_close(timeout=900)
    if info["source"] != "virtual" or diags or info["pinned"] != 3 \
            or pinned != ["A5", "P", "Q", "S"]:
        raise AssertionError(f"fleet (f): source {info['source']}, "
                             f"diagnostics {diags}, pinned {pinned} "
                             f"({info['pinned']} queries)")
    row = {"source": info["source"], "placed": info["placed"],
           "pinned_queries": info["pinned"], "pinned_tables": pinned,
           "diagnostics": len(diags),
           "launches": {k: launched[k] for k in
                        ("spmm_blocksparse", "spmv_compact",
                         "spgemm_pairs")},
           "peak_gib": meter.gib()}
    log(f"fleet (f): (2, 4) grid, {info['source']} (2, 2) slices, "
        f"verify_plans='error': placed {info['placed']}, {info['pinned']} "
        f"pinned over sparse tables {pinned}; {len(diags)} diagnostics; "
        f"launches {row['launches']}; answers bit-equal to plain sessions "
        f"on (2, 4) and (2, 2); peak {row['peak_gib']:.3f} GiB")
    return row


def fleet_tools(log_path: str, dev) -> dict:
    """(g) The operator tools over the run's own event log — history
    --summary (its fleet roll-up), trace --export chrome, why, top
    --once --log — then the bridge on localhost, and ``python -m
    matrel_tpu_torch pagerank`` (in process) over row 5's edges: B2 for
    every round and the same top ten as path_row5_pagerank."""
    import argparse
    import io
    from contextlib import redirect_stdout
    import numpy as np
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.__main__ import main as cli
    from matrel_tpu_torch.bridge import BridgeClient, BridgeServer
    from matrel_tpu_torch.obs import history, provenance, top, trace
    from matrel_tpu_torch.ops import pallas_spmv as pc
    meter = PeakMeter("fleet_tools", FLEET_PEAK_LIMIT_GIB)

    def text(fn, **kw):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with redirect_stdout(buf):
            rc = fn(argparse.Namespace(**kw))
        return rc, buf.getvalue(), (time.perf_counter() - t0) * 1e3

    rc, hist, hist_ms = text(history.main, log=log_path, last=None,
                             summary=True, drift=False, drift_table=None,
                             coeffs=False, no_save=True, check=False)
    fleet_lines = [ln for ln in hist.splitlines()
                   if ln.startswith("fleet:")]
    chrome = log_path + ".chrome.json"
    rc2, tr, tr_ms = text(trace.main, export="chrome", log=log_path,
                          out=chrome, last=None)
    spans = json.loads(tr)["spans"]
    rc3, why, why_ms = text(provenance.main, log=log_path, last=10_000,
                            key=None, audit=False, sample=8, check=False,
                            device=str(dev))
    rc4, frame, top_ms = text(top.main, url=None, port=None, log=log_path,
                              interval=0.0, once=True, iterations=None)
    if rc or rc2 or rc3 or rc4 or not fleet_lines or spans < 1 \
            or "fleet: owner slice" not in why \
            or not frame.startswith("matrel_tpu_torch top"):
        raise AssertionError(f"fleet (g): tools rc {rc, rc2, rc3, rc4}, "
                             f"{len(fleet_lines)} fleet lines, {spans} "
                             f"spans")
    srv = BridgeServer(MatrelSession(device=dev))
    srv.serve_background()
    client = BridgeClient("127.0.0.1", srv.port)
    a = np.arange(64 * 64, dtype=np.float32).reshape(64, 64) % 7
    t0 = time.perf_counter()
    client.call("upload", name="M", data=a.tolist())
    client.call("sql", query="M * M", store="MM")
    got = np.asarray(client.call("fetch", name="MM")["data"])
    bridge_ms = (time.perf_counter() - t0) * 1e3
    client.call("shutdown")
    client.close()
    srv.server_close()
    if not np.array_equal(got, a @ a):
        raise AssertionError("fleet (g): the bridge's M * M is wrong")
    src, dst = row5_graph()
    os.makedirs(FLEET_DIR, exist_ok=True)
    csv = os.path.join(FLEET_DIR, "row5_edges.csv")
    t0 = time.perf_counter()
    with open(csv, "w") as f:
        f.write("\n".join(map("{},{}".format, src.tolist(),
                              dst.tolist())))
    write_s = time.perf_counter() - t0
    if not ROW5_PR_TOP:
        from matrel_tpu_torch.workloads import pagerank as pr
        r = pr.pagerank_edges(src, dst, ROW5_N, rounds=ROW5_ROUNDS,
                              impl="onehot", passes=3).cpu().numpy()
        ROW5_PR_TOP.extend((int(i), float(r[i]))
                           for i in np.argsort(r)[::-1][:10])
    n0 = pc.LAUNCHES_SPMV
    buf = io.StringIO()
    t0 = time.perf_counter()
    with redirect_stdout(buf):
        cli(["pagerank", csv, "--top", "10"])
    cli_s = time.perf_counter() - t0
    b2 = pc.LAUNCHES_SPMV - n0
    out = json.loads(buf.getvalue())
    top10 = [(t["node"], t["rank"]) for t in out["top"]]
    os.remove(csv)
    rank_err = max(abs(a[1] - b[1]) / b[1]
                   for a, b in zip(top10, ROW5_PR_TOP))
    if [a[0] for a in top10] != [b[0] for b in ROW5_PR_TOP] \
            or rank_err > 1e-6 or out["nodes"] != ROW5_N \
            or b2 != ROW5_ROUNDS:
        raise AssertionError(f"fleet (g): CLI PageRank top ten {top10} vs "
                             f"{ROW5_PR_TOP}, {out['nodes']} nodes, B2 "
                             f"{b2}")
    row = {"history_ms": hist_ms, "fleet_lines": fleet_lines,
           "trace_spans": spans, "trace_ms": tr_ms, "why_ms": why_ms,
           "top_ms": top_ms, "bridge_ms": bridge_ms,
           "csv_write_s": write_s, "cli_pagerank_s": cli_s, "b2": b2,
           "top10_rank_rel_err": rank_err,
           "peak_gib": meter.gib()}
    log(f"fleet (g): history --summary {hist_ms:.1f} ms ({fleet_lines}); "
        f"trace --export chrome {spans} spans in {tr_ms:.1f} ms; why "
        f"{why_ms:.1f} ms; top --once --log {top_ms:.1f} ms; bridge "
        f"upload / sql / fetch {bridge_ms:.1f} ms, exact; CLI pagerank "
        f"over 10M edges {cli_s:.2f} s (CSV written in {write_s:.2f} s), "
        f"B2 x {b2}, the same top ten as path_row5_pagerank (ranks "
        f"within {rank_err:.1e} relative); peak "
        f"{row['peak_gib']:.3f} GiB")
    return row


def path_fleet(sess) -> dict:
    """The multi-slice serving fleet and the operator tools on the card
    (serve/fleet.py, core/mesh slice views, obs/history.py, obs/top.py,
    the trace / why CLIs, bridge.py, __main__.py): on the 1 x 1 grid with
    fleet_slices=2 ("shared": both slice sessions on the card, tables
    shared) and obs on, (a) four client threads, (b) directory hits, (c)
    hot-entry replication, (d) failover, (e) a rebind, then (f) the
    (2, 4) virtual grid under verify_plans="error" and (g) the tools
    over the run's own log. Every answer bit-equal to one plain session;
    each sub-phase its own peak bound (FLEET_PEAK_LIMIT_GIB)."""
    import shutil
    import torch
    t0 = time.perf_counter()
    dev = sess.device
    shutil.rmtree(FLEET_DIR, ignore_errors=True)
    os.makedirs(FLEET_DIR)
    log_path = os.path.join(FLEET_DIR, "events.jsonl")
    c0 = ops_counts()
    fs = fleet_session(dev, log_path,
                       fleet_replicate_hits=FLEET_REPLICATE_HITS)
    tables = fleet_tables(fs)
    qs = fleet_queries(fs)
    want = fleet_plain(qs, tables, dev)
    rows = {}
    try:
        rows["submit"] = fleet_submit(fs, qs, want, dev)
        rows["hit"] = fleet_hit(fs, qs, want)
        rows["replicate"] = fleet_replicate(fs, qs, want)
        rows["failover"] = fleet_failover(fs, tables, qs, want, dev,
                                          log_path)
        rows["rebind"], tables = fleet_rebind(fs, tables, qs)
        fs.serve_close(timeout=900)
        del fs, qs, want, tables
        torch.cuda.empty_cache()
        rows["virtual"] = fleet_virtual(dev, log_path)
        torch.cuda.empty_cache()
        rows["tools"] = fleet_tools(log_path, dev)
    finally:
        shutil.rmtree(FLEET_DIR, ignore_errors=True)
    total = ops_since(c0)
    log(f"path fleet: {time.perf_counter() - t0:.1f} s; launches B1 "
        f"{total['spmm_blocksparse']}, B2 {total['spmv_compact']}, B4 "
        f"{total['spgemm_pairs']}")
    print(json.dumps({"fleet": rows}, default=str))
    bodies = {k[3:]: v for k, v in total.items()
              if k.startswith("b1_") and v}
    return {"launches": total, "spmm_bodies": bodies, "rows": rows}


def fleet_only() -> int:
    """``python3 chip_smoke.py --fleet``: only path_fleet (after building
    the kernels), printing the card line and its launches."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    log(f"torch {torch.__version__}; {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    out = path_fleet(MatrelSession())
    print(card)
    print(json.dumps({"fleet_launches": out["launches"]}))
    return 0


# -- the randomized soak and the chaos drill on the card (path_soak) ----------

#: path_soak's seed base and tolerance: the soak's own (tools/soak.py; each
#: battery's tolerance from it by soak.tol_of).
SOAK_BASE, SOAK_TOL = 10_000, 3e-3
#: Trials a battery, the kernel batteries first; chosen so the phase stays
#: within its share of the script's time (PERF.md §6, the soak table).
SOAK_TRIALS = {"spmv": 60, "routed": 30, "sparse_kernels": 16,
               "fuzz": 150, "deep": 25, "precision": 40, "fusion": 24,
               "serve": 10, "cse": 4, "chaos": 8, "overload": 5,
               "stream": 4, "fleet": 4, "race": 3, "coeffs": 8, "ckpt": 5,
               "durable": 3, "sharded": 5}
#: sharded's world on the card: four gloo ranks sharing it.
SOAK_SHARDED_GRID = (2, 2)
#: The phase's peak device memory over what was held when it started, the
#: largest of three runs on the H100 (PERF.md §6, the soak table), plus
#: 25%.
SOAK_PEAK_LIMIT_GIB = {"soak": 1.25 * 0.378}
#: The kernels path_soak must launch, each as the counters of which one
#: must move: B1's wgmma and WMMA bodies, either f32 body, B2, B4-B7, B8
#: (B3 is reported, launched only where a tree reaches it).
SOAK_MUST_LAUNCH = (("b1_wgmma",), ("b1_wmma",), ("b1_f32", "b1_f32_narrow"),
                    ("spmv_compact",), ("spgemm_pairs",), ("spgemm_grouped",),
                    ("spgemm_band",), ("spgemm_powerlaw",), ("spmv_routed",))
SOAK_DIR = os.path.join(HERE, "build", "chip_smoke", "soak")


def soak_counts() -> dict:
    """Every kernel's launch count: serve_counts' B1 (in all and by
    body), B2 and B4-B7, with B3 and B8."""
    from matrel_tpu_torch.ops import pallas_spmv as pc, spmv_routed
    return dict(serve_counts(), spmm_compact=pc.LAUNCHES_SPMM,
                spmv_routed=spmv_routed.LAUNCHES_ROUTED)


def path_soak(dev) -> dict:
    """The port's randomized oracle soak on the card
    (matrel_tpu_torch/tools/soak.py at SOAK_BASE, SOAK_TRIALS a battery,
    the kernel batteries first): one line a battery (trials, failures,
    wall s, launches a kernel), zero failures; every kernel of
    SOAK_MUST_LAUNCH launched during the phase (B1's wgmma, WMMA and f32
    bodies counted apart); then the chaos drill on the card, its JSON
    line printed and held to ``ok``. The durable battery's restoring
    process and sharded's ranks count their launches in their own
    processes, not here. Peak under SOAK_PEAK_LIMIT_GIB, each battery's
    own peak printed (the garbage of the one before collected first)."""
    import gc
    import shutil
    import torch
    from matrel_tpu_torch.tools import chaos_drill, soak
    t_start = time.perf_counter()
    meter = PeakMeter("soak", SOAK_PEAK_LIMIT_GIB)
    c_start = soak_counts()
    rows, failed = {}, []
    for name, trials in SOAK_TRIALS.items():
        gc.collect()      # twice: finalizers of the first pass free the rest
        gc.collect()
        meter._read()
        torch.cuda.reset_peak_memory_stats()
        c0 = soak_counts()
        t0 = time.perf_counter()
        if name == "sharded":
            fails = soak.soak_sharded(trials, SOAK_BASE,
                                      soak.tol_of(name, SOAK_TOL), dev,
                                      grid=SOAK_SHARDED_GRID)
        else:
            fails, _ = soak.run_battery(name, trials, SOAK_BASE, SOAK_TOL,
                                        dev)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - meter.base) / 2**30
        launched = {k: v - c0[k] for k, v in soak_counts().items()
                    if v > c0[k]}
        rows[name] = {"trials": trials, "failures": len(fails),
                      "wall_s": wall, "launches": launched,
                      "peak_gib": peak,
                      "fail_heads": [str(f) for f in fails[:5]]}
        log(f"soak {name}: {trials} trials, {len(fails)} failures, "
            f"{wall:.1f} s, launches {launched}, peak {peak:.3f} GiB")
        for f in fails[:5]:
            log(f"  FAIL {f}")
        if fails:
            failed.append(name)
    total = {k: v - c_start[k] for k, v in soak_counts().items()}
    print(json.dumps({"soak": rows}, default=str))
    if failed:
        raise AssertionError(f"soak: failures in {failed}")
    missing = [k for k in SOAK_MUST_LAUNCH if sum(total[c] for c in k) < 1]
    if missing:
        raise AssertionError(f"soak: no launch of {missing} ({total})")
    shutil.rmtree(SOAK_DIR, ignore_errors=True)
    os.makedirs(SOAK_DIR)
    prior = os.environ.get("MATREL_OBS_EVENT_LOG")
    os.environ["MATREL_OBS_EVENT_LOG"] = os.path.join(SOAK_DIR,
                                                      "chaos.jsonl")
    c0 = soak_counts()
    t0 = time.perf_counter()
    try:
        drill = chaos_drill.drill(dev)
    finally:
        if prior is None:
            os.environ.pop("MATREL_OBS_EVENT_LOG")
        else:
            os.environ["MATREL_OBS_EVENT_LOG"] = prior
        shutil.rmtree(SOAK_DIR, ignore_errors=True)
    drill_s = time.perf_counter() - t0
    print(json.dumps(drill))
    if not drill["ok"]:
        raise AssertionError("soak: the chaos drill failed on the card")
    peak = meter.gib()
    total = {k: v - c_start[k] for k, v in soak_counts().items()}
    log(f"path soak: {time.perf_counter() - t_start:.1f} s (chaos drill "
        f"{drill_s:.1f} s, launches "
        f"{ {k: v - c0[k] for k, v in soak_counts().items() if v > c0[k]} }"
        f"); launches {total}; peak {peak:.3f} GiB")
    return {"launches": total, "rows": rows, "peak_gib": peak,
            "spmm_bodies": {k[3:]: v for k, v in total.items()
                            if k.startswith("b1_") and v}}


def soak_only() -> int:
    """``python3 chip_smoke.py --soak``: only path_soak (after building
    the kernels), printing the card line and its launches."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    log(f"torch {torch.__version__}; {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    out = path_soak(MatrelSession().device)
    print(card)
    print(json.dumps({"soak_launches": out["launches"]}))
    return 0


# -- the operator drills and the open-loop traffic harness (path_tools) -------

#: The phase's peak device memory over what was held when it started, the
#: largest of three runs on the H100 (PERF.md §6, PR 23), plus 25%: the
#: traffic harness holds every answer on the card until it checks it.
TOOLS_PEAK_LIMIT_GIB = {"tools": 1.25 * 0.388}
#: multihost_check's world: gloo ranks sharing the card.
TOOLS_MH_NPROC = 2
TOOLS_DIR = os.path.join(HERE, "build", "chip_smoke", "tools")


def tools_runs(device: str) -> list:
    """(name, callable) of every device-facing tool of
    matrel_tpu_torch/tools/, each returning its exit code."""
    from matrel_tpu_torch.tools import (flight_drill, matlint,
                                        multihost_check, plan_snapshot,
                                        plan_verify, provenance_drill,
                                        topology_flip, traffic)
    dev = ["--device", device]
    return [
        ("plan_snapshot", lambda: plan_snapshot.main(dev)),
        ("plan_verify", lambda: plan_verify.main(dev)),
        ("topology_flip", lambda: topology_flip.main(dev)),
        ("flight_drill", lambda: flight_drill.main(dev)),
        ("provenance_drill", lambda: provenance_drill.main(dev)),
        ("traffic", lambda: traffic.main(slo=False, device=device)),
        ("traffic --slo", lambda: traffic.main(slo=True, device=device)),
        ("traffic --slices", lambda: traffic.main_slices(device)),
        ("multihost_check", lambda: multihost_check.main(
            ["--nproc", str(TOOLS_MH_NPROC)] + dev)),
        ("matlint", lambda: matlint.main([])),
    ]


def path_tools(dev) -> dict:
    """The operator drills and the open-loop traffic harness of
    matrel_tpu_torch/tools/ on the card, each through its ``main``:
    plan_snapshot and plan_verify (the corpus on the virtual (2, 4) grid,
    leaves on the card), topology_flip, flight_drill, provenance_drill,
    traffic in its three modes (overload, --slo, --slices) and
    multihost_check over TOOLS_MH_NPROC gloo ranks sharing the card. Each
    tool's record or verdict is printed on its own line; the phase fails
    unless every exit code is 0 and every record's ``ok`` is true. The
    artifacts (event log, flight dump, drift table) go under TOOLS_DIR,
    removed at the end. Launches of every kernel are counted over the
    phase (the multihost ranks count theirs in their own processes);
    peak under TOOLS_PEAK_LIMIT_GIB, each tool's own peak printed."""
    import gc
    import io
    import shutil
    import torch
    t_start = time.perf_counter()
    shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    os.makedirs(TOOLS_DIR)
    env = {"MATREL_OBS_EVENT_LOG": os.path.join(TOOLS_DIR, "events.jsonl"),
           "MATREL_OBS_FLIGHT_RECORDER_PATH": os.path.join(TOOLS_DIR,
                                                           "flight.json"),
           "MATREL_DRIFT_TABLE_PATH": os.path.join(TOOLS_DIR, "drift.json")}
    prior = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    meter = PeakMeter("tools", TOOLS_PEAK_LIMIT_GIB)
    c_start = soak_counts()
    rows, failed = {}, []
    try:
        for name, fn in tools_runs(str(dev)):
            gc.collect()
            gc.collect()
            meter._read()
            torch.cuda.reset_peak_memory_stats()
            c0 = soak_counts()
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = fn()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            peak = (torch.cuda.max_memory_allocated() - meter.base) / 2**30
            launched = {k: v - c0[k] for k, v in soak_counts().items()
                        if v > c0[k]}
            record = None
            for line in buf.getvalue().splitlines():
                if line.startswith("{"):
                    print(line, flush=True)       # the tool's record
                    record = json.loads(line)
                else:
                    log(f"  {name}: {line}")      # its verdict lines
            ok = rc == 0 and (record is None or bool(record.get("ok")))
            rows[name] = {"rc": rc, "ok": ok, "wall_s": wall,
                          "launches": launched, "peak_gib": peak}
            log(f"tools {name}: rc {rc}, ok {ok}, {wall:.1f} s, launches "
                f"{launched}, peak {peak:.3f} GiB")
            if not ok:
                failed.append(name)
    finally:
        for k, v in prior.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        shutil.rmtree(TOOLS_DIR, ignore_errors=True)
    print(json.dumps({"tools": rows}, default=str))
    if failed:
        raise AssertionError(f"tools: {failed} failed on the card")
    peak = meter.gib()
    total = {k: v - c_start[k] for k, v in soak_counts().items()}
    log(f"path tools: {time.perf_counter() - t_start:.1f} s; launches "
        f"{ {k: v for k, v in total.items() if v} }; peak {peak:.3f} GiB")
    return {"launches": total, "rows": rows, "peak_gib": peak,
            "spmm_bodies": {k[3:]: v for k, v in total.items()
                            if k.startswith("b1_") and v}}


def tools_only() -> int:
    """``python3 chip_smoke.py --tools``: only path_tools (after building
    the kernels), printing the card line and its launches."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    log(f"torch {torch.__version__}; {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    out = path_tools(MatrelSession().device)
    print(card)
    print(json.dumps({"tools_launches": out["launches"]}))
    return 0


# -- the worked examples (path_examples) and the overlap experiment -----------

#: Each example's peak device memory over what was held when it started,
#: and the overlap experiment's, on the H100 (PERF.md §6), plus
#: 25%; an example's at least 1/16 GiB before the 25% (a few of them
#: allocate under a MiB, and the caching allocator's blocks and a cuBLAS
#: workspace are larger than that).
EXAMPLES_PEAK_LIMIT_GIB = {k: 1.25 * max(v, 1 / 16) for k, v in {
    "graph_demo": 0.172, "linreg_demo": 0.048, "chain_optimizer_demo": 0.066,
    "relational_sql_demo": 0.001, "analytics_demo": 0.007,
    "layout_aware_planning_demo": 0.013, "autotune_demo": 0.001}.items()}
#: distributed_sparse_demo's device memory is all in its rank processes:
#: the largest rank's own peak (torch.cuda.max_memory_allocated in the
#: rank; 0.074 GiB on the H100, PERF.md §6), plus 25%.
EXAMPLE_RANK_PEAK_LIMIT_GIB = 1.25 * 0.074
OVERLAP_PEAK_LIMIT_GIB = {"overlap": 1.25 * 0.858}
#: The examples B1 / B2 must launch in (distributed_sparse_demo: on
#: every rank).
EXAMPLES_MUST_LAUNCH = {"graph_demo": ("spmv_compact",)}


def example_checks(name: str, out: dict) -> None:
    """Each example's own checks on the card: its numbers against its
    oracle, within the demo's bounds."""
    import numpy as np
    import torch
    from matrel_tpu_torch.examples import (distributed_sparse_demo,
                                           graph_demo)
    if name == "graph_demo":
        n, m = graph_demo.N_NODES, graph_demo.N_EDGES
        rng = np.random.default_rng(0)
        src, dst = rng.integers(0, n, m), rng.integers(0, n, m)
        want = pagerank_oracle(src, dst, n, graph_demo.ROUNDS)
        rel_err(f"{name} PageRank vs float64",
                torch.as_tensor(out["ranks"]), torch.as_tensor(want),
                PR_REL_TOL)
        if (out["deg_out"].sum(), out["deg_in"].sum()) != (m, m):
            raise AssertionError(f"{name}: degrees do not sum to {m}")
        if abs(out["rank_mass"] - 1.0) > 1e-3:
            raise AssertionError(f"{name}: rank mass {out['rank_mass']}")
    elif name == "linreg_demo":
        if not out["rel_err"] < 1e-3:
            raise AssertionError(f"{name}: relative error {out['rel_err']}")
    elif name == "chain_optimizer_demo":
        if out["flop_ratio"] != 64:
            raise AssertionError(f"{name}: FLOP ratio {out['flop_ratio']}")
        if abs(out["raw_checksum"] - out["opt_checksum"]) > 1e-3:
            raise AssertionError(f"{name}: the plans disagree")
    elif name == "relational_sql_demo":
        rng = np.random.default_rng(1)
        a, b = (rng.standard_normal((64, 64)).astype(np.float32)
                for _ in range(2))
        want = ((a * b) > 0).sum(1)
        if not (np.array_equal(out["counts"].ravel(), want)
                and out["sql_agrees"] and out["where_nonzeros"]
                == int(((a * b) > 1).sum())):
            raise AssertionError(f"{name}: counts / SQL / WHERE disagree")
    elif name == "analytics_demo":
        if not (out["triangles"] == out["triangles_oracle"]
                == out["triangles_sql"]
                and out["pairs"] == out["pairs_oracle"]):
            raise AssertionError(f"{name}: {out}")
    elif name == "layout_aware_planning_demo":
        got = (out["canonical"], out["col_sharded"], out["interior"],
               out["root"])
        if got != ("A*(B*C)", "(A*B)*C", "bmm_right", "cpmm"):
            raise AssertionError(f"{name}: stamps {got}")
    elif name == "autotune_demo":
        if out["second_measurements"] or out["first_measurements"] < 2:
            raise AssertionError(f"{name}: {out['first_measurements']} / "
                                 f"{out['second_measurements']} "
                                 f"measurements")
    elif name == "distributed_sparse_demo":
        ex = distributed_sparse_demo
        for k, tol in (("spmm_err", ex.SPMM_TOL), ("b1_err", ex.SPMM_TOL),
                       ("spmv_err", ex.SPMV_TOL), ("b2_err", ex.SPMV_TOL)):
            if not out[k] <= tol:
                raise AssertionError(f"{name}: {k} {out[k]} > {tol}")
        idle = [r for r, ln in enumerate(out["launches"])
                if min(ln.values()) < 1]
        if idle:
            raise AssertionError(f"{name}: ranks {idle} launched no B1 or "
                                 f"no B2 ({out['launches']})")


def path_examples(dev) -> dict:
    """The eight worked examples of matrel_tpu_torch/examples/ on the
    card, each through its ``run`` at the JAX demo's sizes: its lines
    printed, its own checks (example_checks), its wall seconds, launches
    and peak (EXAMPLES_PEAK_LIMIT_GIB). distributed_sparse_demo spawns
    four gloo ranks sharing the card under MR_TIMEOUT_S; their B1 / B2
    launches and their peaks come back in its record, the largest peak
    held under EXAMPLE_RANK_PEAK_LIMIT_GIB."""
    import gc
    import torch
    from matrel_tpu_torch.examples import distributed_sparse_demo
    from matrel_tpu_torch.tools.batch import EXAMPLES
    t_start = time.perf_counter()
    c_start = soak_counts()
    rows, ranks = {}, {}
    for name in EXAMPLES:
        mod = importlib.import_module(f"matrel_tpu_torch.examples.{name}")
        gc.collect()
        gc.collect()
        meter = (None if mod is distributed_sparse_demo else
                 PeakMeter(name, EXAMPLES_PEAK_LIMIT_GIB))
        c0 = soak_counts()
        kw = ({"nproc": 4, "timeout_s": MR_TIMEOUT_S}
              if mod is distributed_sparse_demo else {})
        t0 = time.perf_counter()
        out = mod.run(dev, emit=lambda ln, name=name: log(f"  {name}: {ln}"),
                      **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if meter is None:
            peak = out["rank_peak_gib"]
            if peak > EXAMPLE_RANK_PEAK_LIMIT_GIB:
                raise AssertionError(
                    f"{name}: a rank's peak device memory {peak:.3f} GiB > "
                    f"{EXAMPLE_RANK_PEAK_LIMIT_GIB:.3f} GiB")
        else:
            peak = meter.gib()
        example_checks(name, out)
        launched = {k: v - c0[k] for k, v in soak_counts().items()
                    if v > c0[k]}
        for k in EXAMPLES_MUST_LAUNCH.get(name, ()):
            if not launched.get(k):
                raise AssertionError(f"{name}: no {k} launch ({launched})")
        if mod is distributed_sparse_demo:
            ranks = {"spmm_blocksparse": sum(
                r["spmm_blocksparse"] for r in out["launches"]),
                "spmv_compact": sum(r["spmv_compact"]
                                    for r in out["launches"]),
                "b1_bodies": out["b1_bodies"]}
        rows[name] = {"wall_s": wall, "launches": launched,
                      "peak_gib": peak}
        log(f"example {name}: {wall:.2f} s, launches {launched}, peak "
            f"{peak:.3f} GiB")
    print(json.dumps({"examples": rows, "example_ranks": ranks},
                     default=str))
    total = {k: v - c_start[k] for k, v in soak_counts().items()}
    log(f"path examples: {time.perf_counter() - t_start:.1f} s; launches "
        f"{ {k: v for k, v in total.items() if v} }; on the ranks {ranks}")
    return {"launches": total, "rows": rows, "ranks": ranks,
            "spmm_bodies": {k[3:]: v for k, v in total.items()
                            if k.startswith("b1_") and v}}


def path_overlap(dev) -> dict:
    """tools/pagerank_overlap.py at the JAX tool's sizes on the card:
    the plan through the native fill, then ``experiment`` (every chunked
    product bit-equal to compact_apply's, one B2 launch a stripe, the
    marginal ms by CUDA events around CUDA-graph replays, the stop rule's
    verdict); the record
    printed with the card line, under OVERLAP_PEAK_LIMIT_GIB."""
    from matrel_tpu_torch.ops import spmv as spmv_lib
    from matrel_tpu_torch.tools import pagerank_overlap as overlap
    t0 = time.perf_counter()
    c0 = soak_counts()
    meter = PeakMeter("overlap", OVERLAP_PEAK_LIMIT_GIB)
    src, dst = overlap.graph(overlap.N_NODES, overlap.N_EDGES)
    plan = spmv_lib.build_spmv_plan(dst, src, None, n_rows=overlap.N_NODES,
                                    n_cols=overlap.N_NODES)
    t_plan = time.perf_counter() - t0
    rec = overlap.experiment(plan, dev)
    peak = meter.gib()
    rec = {"metric": "pagerank_overlap_experiment", **rec,
           "n": overlap.N_NODES, "edges": overlap.N_EDGES,
           "fill": plan.fill, "device": device_line(), "peak_gib": peak}
    print(json.dumps(rec))
    total = {k: v - c0[k] for k, v in soak_counts().items()}
    log(f"path overlap: {time.perf_counter() - t0:.1f} s (plan "
        f"{t_plan:.1f} s), verdict {rec['verdict'].split()[0]}, launches "
        f"{ {k: v for k, v in total.items() if v} }, peak {peak:.3f} GiB")
    return {"launches": total, "record": rec}


def examples_only() -> int:
    """``python3 chip_smoke.py --examples``: only path_examples and
    path_overlap (after building the kernels), printing the card line and
    their launches."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    log(f"torch {torch.__version__}; {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    dev = MatrelSession().device
    ex = path_examples(dev)
    ov = path_overlap(dev)
    print(card)
    print(json.dumps({"examples_launches": ex["launches"],
                      "example_ranks": ex["ranks"],
                      "overlap_launches": ov["launches"]}))
    return 0


# -- the compiled plan's iteration path (path_bound_runner) -------------------

#: The JAX headline's chained step (bench.py's bf16_safe_chain_step,
#: (C·B)·(2/N), at N = 4096 in bf16, 40 repeats).
BOUND_N, BOUND_STEPS = 4096, 40
#: Rows of the chain held against float64 numpy: a row of C·B·s depends
#: only on the same row of C, so the sampled rows' float64 chain is exact.
BOUND_ROWS = 32
#: The chain against float64: max |err| <= BOUND_CHAIN_RTOL x mean|C| of
#: the float64 rows. Each step rounds C to bf16 (2^-9 relative) and the
#: next step averages those errors over the 4096-long contraction, so
#: what stays is about one rounding of an entry (<= ~2 x the mean): 2^-8
#: of the mean, allowed 4 times.
BOUND_CHAIN_RTOL = 2.0 ** -6
#: bench.py's check_chain_canary band for mean|C|.
BOUND_CANARY = (1e-3, 1e3)
#: The donated chain's peak device memory over what was held when it
#: started, on the H100 (PERF.md §6), plus 25%.
BOUND_PEAK_LIMIT_GIB = {"bound_runner": 1.25 * 0.219}
#: Steps of (a) run before its turns are timed (~0.2 s on the H100).
BOUND_WARM_STEPS = 400
#: x <- A·x steps through the bound runner over row 5's COO matrix (the
#: PageRank iteration through a compiled plan).
BOUND_PR_STEPS = 10


def path_bound_runner(sess) -> dict:
    """CompiledPlan.bound_runner on the card, the counts read from its
    start: (a) the JAX headline's chain through ``bound_runner
    (rebind_uids=(a,))``, bit-equal to the same chain through
    ``run(bindings=…)``, within BOUND_CHAIN_RTOL of float64 numpy on
    BOUND_ROWS rows, mean|C| in BOUND_CANARY; again with ``donate=True``
    (bit-equal) under BOUND_PEAK_LIMIT_GIB; (b) row 4's S·D with D
    rebound (B1, against its plain version); (c) row 5's COO matvec,
    x <- A·x with x rebound (B2, the last step against its plain
    version); (d) ms a step through the runner and through run(), in
    turns (CUDA events around BOUND_STEPS or BOUND_PR_STEPS steps a
    sample), with the card line."""
    import numpy as np
    import torch
    from matrel_tpu_torch.executor import compile_expr
    from matrel_tpu_torch.ops import pallas_spmm, pallas_spmv as pc
    from matrel_tpu_torch.parallel import strategies
    t_start = time.perf_counter()
    c_start = soak_counts()
    card = device_line()
    n, rec = BOUND_N, {"device": card}

    # (a) the chained step at the JAX headline's shape
    A = sess.random((n, n), seed=0, dtype="bfloat16")
    B = sess.random((n, n), seed=1, dtype="bfloat16")
    plan = compile_expr(A.expr().multiply(B.expr()).multiply_scalar(
        2.0 / n), sess.mesh)
    uid = plan.leaf_order[0].uid
    step = plan.bound_runner(rebind_uids=(uid,))
    cur = step(A.data)
    for _ in range(BOUND_STEPS - 1):
        cur = step(cur)
    via = A
    for _ in range(BOUND_STEPS):
        via = plan.run(bindings={uid: via})
    if not torch.equal(cur, via.data):
        raise AssertionError("bound runner chain: not bit-equal to run()'s")
    del via
    rows = np.linspace(0, n - 1, BOUND_ROWS).astype(np.int64)
    b64 = B.data.double().cpu().numpy()
    want = A.data[rows].double().cpu().numpy()
    for _ in range(BOUND_STEPS):
        want = want @ b64 * (2.0 / n)
    scale = float(np.abs(want).mean())
    canary = float(cur.float().abs().mean())
    if not (math.isfinite(canary) and BOUND_CANARY[0] < canary
            < BOUND_CANARY[1]):
        raise AssertionError(f"bound runner chain: mean|C| {canary!r}")
    err = rows_vs_f64("bound runner chain vs float64 numpy",
                      cur[rows].cpu(), torch.from_numpy(want),
                      BOUND_CHAIN_RTOL * scale)
    del b64
    meter = PeakMeter("bound_runner", BOUND_PEAK_LIMIT_GIB)
    dstep = plan.bound_runner(rebind_uids=(uid,), donate=True)
    dcur = dstep(A.data.clone())         # the caller keeps no reference
    for _ in range(BOUND_STEPS - 1):
        dcur = dstep(dcur)
    peak = meter.gib()
    if not torch.equal(dcur, cur):
        raise AssertionError("donated chain: not bit-equal to the kept one")
    del dcur
    # where that peak comes from: one bf16 local product alone
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    strategies.local_dot(A.data, B.data)
    torch.cuda.synchronize()
    dot_peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    cbm = dense_leaf(sess, cur)
    # BOUND_WARM_STEPS steps before the turns, so the first of them
    # (the runner's) starts on a card as warm as the others do
    time_ms(lambda: step(cur), warmup=0, runs=1, batch=BOUND_WARM_STEPS)
    ms_a = in_turns(lambda: step(cur),
                    lambda: plan.run(bindings={uid: cbm}),
                    batch=BOUND_STEPS)
    rec["chain"] = {"n": n, "steps": BOUND_STEPS, "dtype": "bfloat16",
                    "mean_abs_c": canary, "max_abs_err_f64_rows": err,
                    "bound_f64": BOUND_CHAIN_RTOL * scale,
                    "donated_peak_gib": peak, "local_dot_peak_gib": dot_peak,
                    "ms_bound_runner": ms_a[0],
                    "ms_run": ms_a[1]}
    log(f"bound runner (a): (C·B)·(2/N) at N = {n} bf16, {BOUND_STEPS} "
        f"steps bit-equal to run()'s chain; mean|C| {canary:.4f}; max err "
        f"on {BOUND_ROWS} rows vs float64 numpy {err:.3e} (bound "
        f"{BOUND_CHAIN_RTOL * scale:.3e}); donated chain bit-equal, peak "
        f"{peak:.3f} GiB (one local_dot alone {dot_peak:.3f}); ms a step "
        f"{ms_a[0]:.4f} (bound runner) / "
        f"{ms_a[1]:.4f} (run), {card}")
    del A, B, plan, step, dstep, cur, cbm
    torch.cuda.empty_cache()

    # (b) B1: row 4's S·D with D rebound
    S, D = row4_inputs(sess)
    D2 = sess.random(D.shape, dtype="bfloat16", seed=3)
    bplan = compile_expr(S.multiply(D), sess.mesh)
    d_uid = bplan.leaf_order[0].uid
    bstep = bplan.bound_runner(rebind_uids=(d_uid,))
    l0 = pallas_spmm.LAUNCHES
    y = bstep(D2.data)
    torch.cuda.synchronize()
    l_b1 = need_launches("bound runner S·D (B1)", pallas_spmm.LAUNCHES - l0)
    want1 = pallas_spmm.spmm_blocksparse_plain(
        S.blocks, S.block_rows, S.block_cols, D2.data, S.shape[0])
    e_b1 = check_close("bound runner S·D (B1)", y, want1, "bfloat16")
    del y, want1
    ms_b = in_turns(lambda: bstep(D2.data),
                    lambda: bplan.run(bindings={d_uid: D2}),
                    batch=BOUND_PR_STEPS)
    rec["b1"] = {"launches": l_b1, "max_abs_err": e_b1,
                 "ms_bound_runner": ms_b[0], "ms_run": ms_b[1]}
    log(f"bound runner (b): row 4 S·D with D rebound, {l_b1} B1 launch, "
        f"max_abs_err vs plain {e_b1:.3e}; ms a step {ms_b[0]:.4f} / "
        f"{ms_b[1]:.4f} (run)")
    del S, D, D2, bplan, bstep
    torch.cuda.empty_cache()

    # (c) B2: x <- A·x through row 5's compiled COO matvec
    _, _, Ac = row5_matrix()
    x = sess.random((ROW5_N, 1), seed=6)
    cplan = compile_expr(Ac.multiply(x), sess.mesh)
    x_uid = cplan.leaf_order[0].uid
    cstep = cplan.bound_runner(rebind_uids=(x_uid,))
    l0 = pc.LAUNCHES_SPMV
    prev, xk = None, x.data
    for _ in range(BOUND_PR_STEPS):
        prev, xk = xk, cstep(xk)
    torch.cuda.synchronize()
    l_b2 = pc.LAUNCHES_SPMV - l0
    if l_b2 < BOUND_PR_STEPS:
        raise AssertionError(f"bound runner x <- A·x: {l_b2} B2 launches "
                             f"in {BOUND_PR_STEPS} steps")
    e_b2 = rel_err("bound runner x <- A·x (B2)", xk[:, 0],
                   pc.spmv_compact(Ac._get_plan(), prev[:, 0],
                                   device=prev.device, use_pallas=False),
                   SPMV_REL_TOL[3])
    ms_c = in_turns(lambda: cstep(x.data),
                    lambda: cplan.run(bindings={x_uid: x}),
                    batch=BOUND_PR_STEPS)
    rec["b2"] = {"launches": l_b2, "steps": BOUND_PR_STEPS,
                 "max_abs_err": e_b2, "ms_bound_runner": ms_c[0],
                 "ms_run": ms_c[1]}
    log(f"bound runner (c): row 5 x <- A·x, {BOUND_PR_STEPS} steps, {l_b2} "
        f"B2 launches, max_abs_err vs plain {e_b2:.3e}; ms a step "
        f"{ms_c[0]:.4f} / {ms_c[1]:.4f} (run)")
    del Ac, x, cplan, cstep, prev, xk
    torch.cuda.empty_cache()

    total = {k: v - c_start[k] for k, v in soak_counts().items()}
    print(json.dumps({"bound_runner": rec}))
    log(f"path bound runner: {time.perf_counter() - t_start:.1f} s; "
        f"launches {({k: v for k, v in total.items() if v})}")
    return {"launches": total, "record": rec,
            "spmm_bodies": {k[3:]: v for k, v in total.items()
                            if k.startswith("b1_") and v}}


def bound_runner_only() -> int:
    """``python3 chip_smoke.py --bound-runner``: only path_bound_runner
    (after building the kernels), printing the card line and its
    launches."""
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build
    card = device_line()
    log(f"torch {torch.__version__}; {card}")
    modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    cuda_build.build([cuda_build.CSRC_DIR / m.SOURCE for m in modules])
    out = path_bound_runner(MatrelSession())
    print(card)
    print(json.dumps({"bound_runner_launches": out["launches"]}))
    return 0


# -- multi-rank execution over torch.distributed (path_multirank) --------------

#: The rank grid: 4 ranks, 2 × 2 (the square grid SUMMA needs).
MR_GRID = (2, 2)
#: Row 1's side (4096² f32) and row 2's (n, mid).
MR_ROW1_N, MR_ROW2 = 4096, (10_000, 100)
#: A rank that has not finished in this time fails the phase.
MR_TIMEOUT_S = 600.0
#: Row 1's product under each strategy forced in turn.
MR_STRATEGIES = ("bmm_left", "bmm_right", "cpmm", "rmm", "summa", "xla")
#: Row 2 planned again under this staged-reshard peak budget.
MR_RESHARD_BUDGET = 64 << 20
#: spgemm_sharded's side (1% random bf16 512-blocks, path_spgemm's pair).
MR_SPGEMM_N = 32_768
#: autotune_matmul's side on the rank grid.
MR_AT_SIDE = 4096
#: Each rank's own peak device memory bound (GiB), per sub-phase:
#: 1.25 × the largest peak a rank read on the card (four ranks on one
#: H100 80GB HBM3 over gloo, a `--multirank` run in PERF.md §6; the
#: chain's is one 16,384-row panel; "tail" the largest of
#: sharded_tail's four, row 4's S·D with the tile stack whole on every
#: rank; "serving" row 4's S·D and its three queries' answers, "fleet"
#: S·D on a slice of two ranks, "fleet_concurrent" its overlap and
#: failover phases, "fuse" sharded_tail (e)'s fuse| probes).
MR_PEAK_LIMIT_GIB = {k: 1.25 * v for k, v in {
    "row1": 0.422, "row2": 0.129, "row5": 0.438, "spgemm": 0.166,
    "spmm": 0.920, "chain": 7.000, "autotune": 0.297,
    "tail": 0.562, "serving": 0.793, "fleet": 0.747,
    "fleet_concurrent": 0.716, "fuse": 0.254}.items()}
#: sharded_tail (d): register_delta's matrix side and edge count, and
#: the align join's rows and operand widths
MR_DELTA_N, MR_DELTA_EDGES = 4096, 64
MR_JOIN_ROWS, MR_JOIN_COLS = 65_536, 16
#: The single-rank answers the ranks compare with, written by the parent.
MR_DIR = os.path.join(HERE, "build", "chip_smoke", "multirank")
#: mr_serving: rank 1 sleeps this long after each submit (the staggered
#: round), and the two 512² bf16 right-hand sides' seeds
MR_SERVE_STAGGER_S = 0.5
MR_SERVE_W_SEEDS = (7, 8)
#: mr_fleet: its slices (2 × 2 ranks) and the span margin that places
#: row 4's S·D on a slice (a margin under 1 biases toward slices)
MR_FLEET_SLICES = 2
MR_FLEET_SPAN_MARGIN = 0.01
#: mr_fleet_concurrent (h): the S·D submitted at once before kill_slice
MR_FLEET_BURST = 6


def mr_stamps(plan) -> list:
    """Matmul strategy stamps of a plan, in post-order."""
    out = []

    def walk(n):
        for c in n.children:
            walk(c)
        if n.kind == "matmul":
            out.append(n.attrs.get("strategy"))

    walk(plan.optimized)
    return out


def mr_free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


class MrRank:
    """One rank's side of path_multirank: its mesh, a timer that reads
    CUDA events on rank 0 between barriers, and its own peak meter."""

    def __init__(self, mesh, limits: dict):
        self.mesh = mesh
        self.rank = mesh.ranks.rank
        self.limits = limits
        self.out = {"peaks": {}}

    def timed(self, fn, runs: int = 3):
        """(result, ms): the median of ``runs`` runs of ``fn``, each
        between two barriers, timed by CUDA events on this rank."""
        import torch
        from matrel_tpu_torch.parallel import collectives as coll
        times, res = [], None
        for _ in range(runs):
            coll.barrier(self.mesh)
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            res = fn()
            stop.record()
            stop.synchronize()
            coll.barrier(self.mesh)
            times.append(start.elapsed_time(stop))
        return res, statistics.median(times)

    @contextlib.contextmanager
    def meter(self, name: str):
        import gc
        import torch
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        yield
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        self.out["peaks"][name] = peak
        if peak > self.limits[name]:
            raise AssertionError(f"rank {self.rank} {name}: peak device "
                                 f"memory {peak:.3f} GiB > "
                                 f"{self.limits[name]:.3f} GiB")

    def block_of(self, full, spec):
        """This rank's block of a whole host array under ``spec``."""
        from matrel_tpu_torch.parallel import collectives as coll
        r0, r1, c0, c1 = coll.rect(coll.layout_of(spec, self.mesh),
                                   self.mesh.ranks.coords, self.mesh.grid,
                                   full.shape)
        return full[r0:r1, c0:c1]


def mr_row1(me: MrRank) -> dict:
    """Row 1 (4096² f32) under each strategy forced in turn: tally, ms a
    product, max error against the single-rank product within
    8·u·√K·‖X_i‖·‖Y_:j‖, and whether it is bit-equal to it."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.parallel import collectives as coll
    ref = np.load(os.path.join(MR_DIR, "row1_ref.npy"), mmap_mode="r")
    xr, yc = np.load(os.path.join(MR_DIR, "row1_norms.npy"))
    # 8·u·√K·‖X_i‖₂·‖Y_:j‖₂ (Cauchy-Schwarz over Σ_k |x_ik·y_kj|, which
    # bounds every partial sum of the row's dot product: uniform [0, 1)
    # entries make the partial sums, not the terms, set the rounding)
    tol = (PROD_C * U32 * math.sqrt(MR_ROW1_N)
           * np.outer(xr, yc)).astype(np.float32)
    out = {}
    for s in MR_STRATEGIES:
        sess = MatrelSession(mesh=me.mesh,
                             config=MatrelConfig(strategy_override=s))
        X = sess.random((MR_ROW1_N, MR_ROW1_N), seed=4)
        Y = sess.random((MR_ROW1_N, MR_ROW1_N), seed=5)
        e = X.multiply(Y)
        plan = sess.compile(e)
        stamps = mr_stamps(plan)
        # CompiledPlan.collectives() / explain() on the ranks: one run
        # of the plan, every rank together (path_bound_runner (e))
        cols, text = plan.collectives(), plan.explain()
        if not text.endswith("\n== Collectives ==\n" + str(cols)):
            raise AssertionError(f"row 1 {s}: explain has no Collectives "
                                 f"section ({text[-200:]!r})")
        if s == "cpmm" and (cols.get("reduce-scatter", 0) < 1
                            or "strategy=cpmm" not in text):
            raise AssertionError(f"row 1 cpmm: collectives {cols}, "
                                 f"explain {text!r}")
        sess.compute(e)                       # warm
        coll.reset_tally()
        res, ms = me.timed(lambda: sess.compute(e), runs=1)
        tally = coll.tally()
        _, ms = me.timed(lambda: sess.compute(e), runs=3)
        got = res.data.cpu().numpy()
        want = me.block_of(ref, res.spec)
        bound = me.block_of(tol, res.spec)
        err = np.abs(got - want)
        if not np.isfinite(got).all() or (err > bound).any():
            raise AssertionError(f"row 1 {s}: {int((err > bound).sum())} "
                                 f"entries past 8·u·√K·‖X_i‖·‖Y_:j‖ (max "
                                 f"err {float(err.max()):.3e})")
        out[s] = {"stamps": stamps, "tally": tally, "ms": ms,
                  "collectives": cols,
                  "max_abs_err": float(err.max()),
                  "err_over_bound": float((err / bound).max()),
                  "bit_equal": bool(np.array_equal(got, want))}
        if s.startswith("bmm"):
            # the BMM operand re-lay (2d -> row / col) and the root's
            # re-lay staged under a budget: apply_staged moves the blocks
            out[s]["staged"] = mr_staged(me, s, X, Y, got)
        del sess, X, Y, e, res, plan
    return out


def mr_staged(me: MrRank, strategy: str, X, Y, want) -> dict:
    """Row 1 under ``strategy`` and MR_RESHARD_BUDGET: the staged moves
    the plan records and their collectives, bit-equal to budget 0."""
    import numpy as np
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.executor import plan_matmul_decisions
    from matrel_tpu_torch.parallel import collectives as coll
    sess = MatrelSession(mesh=me.mesh, config=MatrelConfig(
        strategy_override=strategy,
        reshard_peak_budget_bytes=MR_RESHARD_BUDGET))
    e = X.multiply(Y)
    plan = sess.compile(e)
    coll.reset_tally()
    got = plan.run().data.cpu().numpy()
    tally = coll.tally()
    if not np.array_equal(got, want):
        raise AssertionError(f"row 1 {strategy} under a reshard budget: "
                             f"not bit-equal to budget 0")
    moves = [d.get("reshard") for d in plan_matmul_decisions(plan)]
    return {"moves": moves, "tally": tally}


def mr_row2(me: MrRank) -> dict:
    """Row 2's skewed A·B·C under the planner's own stamps, then under a
    staged-reshard budget (apply_staged moving for real), bit-equal to
    budget 0; measure_reshard_variant, staged against naive."""
    import numpy as np
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.parallel import autotune, reshard
    from matrel_tpu_torch.executor import plan_matmul_decisions
    from matrel_tpu_torch.workloads import chain_bench
    ref = np.load(os.path.join(MR_DIR, "row2_ref.npy"), mmap_mode="r")
    outs, rec = {}, {}
    for budget in (0, MR_RESHARD_BUDGET):
        sess = MatrelSession(mesh=me.mesh, config=MatrelConfig(
            reshard_peak_budget_bytes=budget))
        mats = chain_bench.skewed_abc(me.mesh, *MR_ROW2, seed=3)
        e = chain_bench.build_chain(mats)
        plan = sess.compile(e)
        res, ms = me.timed(lambda: sess.compute(e), runs=3)
        outs[budget] = res.data.cpu().numpy()
        rec[budget] = {"stamps": mr_stamps(plan), "ms": ms,
                       "paren": chain_bench.parenthesisation(plan.optimized),
                       "moves": [d.get("reshard") for d in
                                 plan_matmul_decisions(plan)]}
    want = me.block_of(ref, res.spec)
    rel = float(np.abs(outs[0] - want).max() / np.abs(ref).max())
    if rel > 1e-5:
        raise AssertionError(f"row 2: rel err {rel} vs float64")
    if not np.array_equal(outs[0], outs[MR_RESHARD_BUDGET]):
        raise AssertionError("row 2: budgeted result not bit-equal to "
                             "budget 0")
    plan = reshard.compile_reshard("row", "col", MR_ROW1_N ** 2 * 4.0,
                                   *me.mesh.grid, peak_budget=1.0)
    times = {v: autotune.measure_reshard_variant(v, plan, me.mesh)
             for v in autotune.RESHARD_VARIANTS}
    return {"plans": rec, "rel_err": rel,
            "reshard_ms": {k: v * 1e3 for k, v in times.items()},
            "reshard_steps": plan.step_kinds}


def mr_row5(me: MrRank) -> dict:
    """Row 5: A·x and A·X (k = 16) through COOMatrix.shard and compute
    (B2, B3 on each rank's slice), then the 30-round sharded PageRank.
    Launches of B2 and B3 counted from here to the end."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import pallas_spmv as pc
    from matrel_tpu_torch.workloads import pagerank as pr
    src, dst, A = row5_matrix()
    dev = me.mesh.device
    rng = np.random.default_rng(11)
    x = rng.standard_normal(ROW5_N).astype(np.float32)
    X = rng.standard_normal((ROW5_N, ROW5_K)).astype(np.float32)
    pc.LAUNCHES_SPMV = pc.LAUNCHES_SPMM = 0
    t0 = time.perf_counter()
    As = A.shard(me.mesh)
    y = As.matvec(x).cpu().numpy()
    Y = As.matmat(X).cpu().numpy()
    first_s = time.perf_counter() - t0
    sess = MatrelSession(mesh=me.mesh)
    Xb = sess.from_numpy(X)
    Yc = sess.compute(A.expr().multiply(Xb))
    xb = sess.from_numpy(x[:, None])
    yc = sess.compute(A.expr().multiply(xb))
    y1 = np.load(os.path.join(MR_DIR, "row5_y.npy"))
    Y1 = np.load(os.path.join(MR_DIR, "row5_Y.npy"), mmap_mode="r")
    if not np.array_equal(y, y1):
        raise AssertionError(f"row 5 A·x sharded: not bit-equal to one "
                             f"card ({int((y != y1).sum())} rows differ)")
    rel_Y = float(np.abs(Y - Y1).max() / np.abs(Y1).max())
    if rel_Y > SPMV_REL_TOL[3]:
        raise AssertionError(f"row 5 A·X sharded: rel err {rel_Y}")
    gotc = Yc.data.cpu().numpy()
    if not np.array_equal(gotc, me.block_of(np.asarray(Y), Yc.spec)):
        raise AssertionError("row 5 compute(A·X) differs from matmat")
    if not np.array_equal(yc.data.cpu().numpy(),
                          me.block_of(y[:, None], yc.spec)):
        raise AssertionError("row 5 compute(A·x) differs from matvec")
    xd = torch.as_tensor(x, device=dev)
    Xd = torch.as_tensor(X, device=dev)
    spmv_ms = me.timed(lambda: As.matvec(xd), runs=5)[1]
    spmm_ms = me.timed(lambda: As.matmat(Xd), runs=5)[1]
    r = pr.pagerank_edges(src, dst, ROW5_N, rounds=ROW5_ROUNDS,
                          impl="onehot", passes=3, mesh=me.mesh)
    prepared = pr.prepare_pagerank_onehot(src, dst, ROW5_N, device=dev)
    pr_ms = me.timed(lambda: pr.run_pagerank_sharded(
        prepared, me.mesh, ROW5_ROUNDS, passes=3), runs=3)[1]
    r = r.double().cpu().numpy()
    ref = np.load(os.path.join(MR_DIR, "row5_pr64.npy"))
    r1 = np.load(os.path.join(MR_DIR, "row5_pr.npy"))
    err64 = float(np.abs(r - ref).max())
    if not np.isfinite(r).all() or err64 > 1e-5:
        raise AssertionError(f"row 5 sharded PageRank: max err {err64} vs "
                             f"float64 scipy")
    return {"launches": {"spmv_compact": pc.LAUNCHES_SPMV,
                         "spmm_compact": pc.LAUNCHES_SPMM},
            "first_s": first_s, "spmv_ms": spmv_ms, "spmm_ms": spmm_ms,
            "pagerank_round_ms": pr_ms / ROW5_ROUNDS,
            "pagerank_err_f64": err64,
            "pagerank_vs_one_card": float(np.abs(r - r1).max()),
            "rel_err_Y": rel_Y}


def mr_sparse(me: MrRank) -> dict:
    """spgemm_sharded on path_spgemm's 1% random bf16 pair at n = 32,768
    and spmm_sharded at row 4's shape, against the single-rank results."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    from matrel_tpu_torch.ops import spgemm as sg
    sess = MatrelSession(mesh=me.mesh)
    out = {}
    with me.meter("spgemm"):
        A, B = (BlockSparseMatrix.random(
            (MR_SPGEMM_N, MR_SPGEMM_N), 0.01, block_size=512, mesh=me.mesh,
            seed=s, dtype="bfloat16") for s in (2, 3))
        C, ms = me.timed(lambda: sg.spgemm_sharded(A, B), runs=3)
        want = torch.as_tensor(np.load(os.path.join(MR_DIR,
                                                    "spgemm_tiles.npy")))
        got = C.blocks.float().cpu()
        err = check_close("spgemm_sharded", got.reshape(-1, 512),
                          want.reshape(-1, 512), "bfloat16")
        out["spgemm"] = {"ms": ms, "max_abs_err": err,
                         "tiles": int(C.nnzb)}
        del A, B, C
    with me.meter("spmm"):
        # row 4's S and D from their seeds; D whole on every rank, as
        # the one-card session makes it
        S, _ = row4_inputs(sess)
        one = MatrelSession(mesh=make_mesh(device=me.mesh.device))
        Dt = one.random((S.shape[1], 512), dtype="bfloat16", seed=2).data
        Ss = S.shard(me.mesh)
        R, ms = me.timed(lambda: Ss.multiply(Dt), runs=3)
        want = me.block_of(np.load(os.path.join(MR_DIR, "spmm_ref.npy"),
                                   mmap_mode="r"), R.spec)
        err = check_close("spmm_sharded", R.data.float().cpu(),
                          torch.as_tensor(np.array(want)), "bfloat16")
        out["spmm"] = {"ms": ms, "max_abs_err": err, "cap": Ss.cap,
                       "padding_ratio": Ss.padding_ratio}
        del S, Ss, Dt, R, one
    return out


def mr_chain(me: MrRank) -> dict:
    """streaming_chain_sharded at bench_all.py's sizes: one 16,384-row
    panel a rank, one all_reduce of the scalar."""
    import torch
    from matrel_tpu_torch.workloads import big_chain
    gens = north_star_gens(NS_TILE, me.mesh.device)
    run = lambda: big_chain.streaming_chain_sharded(
        NS_N, *gens, me.mesh, tile=NS_TILE, panel=NS_PANEL)
    float(run())                                    # warm
    secs = []
    vals = []
    for _ in range(2):
        from matrel_tpu_torch.parallel import collectives as coll
        coll.barrier(me.mesh)
        t0 = time.perf_counter()
        vals.append(float(run()))
        secs.append(time.perf_counter() - t0)
    return {"s": secs, "fro": vals[0], "same": vals[0] == vals[1]}


def mr_autotune(me: MrRank) -> dict:
    from matrel_tpu_torch.parallel import autotune
    autotune._DEFAULT_TABLE = os.path.join(MR_DIR, "autotune.json")
    best, times = autotune.autotune_matmul(MR_AT_SIDE, MR_AT_SIDE,
                                           MR_AT_SIDE, mesh=me.mesh)
    return {"best": best, "ms": {k: v * 1e3 for k, v in times.items()}}


def mr_sharded_tail(me: MrRank) -> dict:
    """The sharded lowerings on the ranks, each sub-phase's peak read
    apart (the largest bounded by MR_PEAK_LIMIT_GIB["tail"]): (a) row
    1's 4096² product, then ⊙ C · 0.5 + 1 and row_sum — no whole gather
    (``gather_rep``) — against the one-rank answer; (b) row 4's S·D in
    bf16, B1 on each rank's 128-column slice of D, against the one-card
    product; (c) row 5's A·x through compute with the damping tail
    (A·x) · 0.85 + c (B2 on each rank's slice of block rows); (d) one
    register_delta on a 4096² dense table and one "align" row join; (e)
    (a)'s tail with fusion and autotune on: the ``fuse|`` probes of its
    fused region on the ranks (bounded apart, MR_PEAK_LIMIT_GIB["fuse"]),
    the winner and the answer held as (a)'s."""
    import gc
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.executor import plan_matmul_decisions
    from matrel_tpu_torch.ops import pallas_spmm, pallas_spmv as pc
    from matrel_tpu_torch.parallel import collectives as coll
    from matrel_tpu_torch.relational import ops as R
    out = {"peaks": {}, "ms": {}}

    def sub(name, fn):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out[name] = fn()
        torch.cuda.synchronize()
        out["peaks"][name] = (torch.cuda.max_memory_allocated()
                              - base) / 2**30

    sess = MatrelSession(mesh=me.mesh)

    def row1_tail():
        X, Y, C = (sess.random((MR_ROW1_N, MR_ROW1_N), seed=s)
                   for s in (4, 5, 6))
        e = (X.multiply(Y).elem_multiply(C).multiply_scalar(0.5)
             .add_scalar(1.0).row_sum())
        sess.compute(e)                                   # warm
        coll.reset_tally()
        res = sess.compute(e)
        tally = coll.tally()
        if tally.get("gather_rep:world"):
            raise AssertionError(f"sharded tail (a) gathered whole: {tally}")
        _, ms = me.timed(lambda: sess.compute(e), runs=3)
        want = me.block_of(np.load(os.path.join(MR_DIR, "tail_ref.npy"))
                           [:, None], res.spec)
        bound = me.block_of(np.load(os.path.join(MR_DIR, "tail_bound.npy"))
                            [:, None], res.spec)
        got = res.data.cpu().numpy()
        err = np.abs(got.astype(np.float64) - want)
        if not np.isfinite(got).all() or (err > bound).any():
            raise AssertionError(f"sharded tail (a): {int((err > bound).sum())}"
                                 f" rows past their bound (max err "
                                 f"{float(err.max()):.3e})")
        return {"tally": tally, "ms": ms, "max_abs_err": float(err.max()),
                "err_over_bound": float((err / bound).max()),
                "bit_equal": bool(np.array_equal(got, want))}

    def row4_cols():
        S, D = row4_inputs(sess)
        e = S.multiply(D)
        split = [d.get("spmm_ranks") for d in
                 plan_matmul_decisions(sess.compile(e))]
        if split != ["col_slice"]:
            raise AssertionError(f"sharded tail (b): B1 split {split}")
        pallas_spmm.LAUNCHES = 0
        pallas_spmm.BODY_LAUNCHES.update(dict.fromkeys(
            pallas_spmm.BODY_LAUNCHES, 0))
        coll.reset_tally()
        res = sess.compute(e)
        tally = coll.tally()
        first = pallas_spmm.LAUNCHES
        _, ms = me.timed(lambda: sess.compute(e), runs=3)
        got = res.data.float()
        want = torch.as_tensor(np.array(me.block_of(np.load(
            os.path.join(MR_DIR, "spmm_ref.npy"), mmap_mode="r"),
            res.spec)), device=got.device)
        err = check_close("sharded tail (b) S·D", got, want, "bfloat16")
        bodies = {b: v for b, v in pallas_spmm.BODY_LAUNCHES.items() if v}
        if first < 1 or set(bodies) != {"wgmma"}:
            raise AssertionError(f"sharded tail (b): B1 launches {first}, "
                                 f"bodies {bodies}")
        return {"split": split, "tally": tally, "ms": ms,
                "launches": pallas_spmm.LAUNCHES, "first_launches": first,
                "bodies": bodies, "max_abs_err": err,
                "bit_equal": bool(torch.equal(got, want)),
                "slice_cols": D.padded_shape[1] // me.mesh.size}

    def row5_damping():
        _src, _dst, A = row5_matrix()
        rng = np.random.default_rng(11)
        x = rng.standard_normal(ROW5_N).astype(np.float32)
        c = (np.random.default_rng(12).random((ROW5_N, 1)) * 0.15
             / ROW5_N).astype(np.float32)
        xb, cb = sess.from_numpy(x[:, None]), sess.from_numpy(c)
        e = A.expr().multiply(xb).multiply_scalar(0.85).add(cb)
        pc.LAUNCHES_SPMV = 0
        res = sess.compute(e)
        launches = pc.LAUNCHES_SPMV
        _, ms = me.timed(lambda: sess.compute(e), runs=3)
        y1 = np.load(os.path.join(MR_DIR, "row5_y.npy"))[:, None]
        want = me.block_of(y1 * np.float32(0.85) + c, res.spec)
        got = res.data.cpu().numpy()
        err = np.abs(got - want)
        # the damping's two f32 roundings, as numpy rounds them
        if not np.isfinite(got).all() or (
                err > 2 * U32 * np.abs(want) + 1e-30).any():
            raise AssertionError(f"sharded tail (c): max err "
                                 f"{float(err.max()):.3e}")
        if launches < 1:
            raise AssertionError("sharded tail (c): no B2 launch")
        return {"ms": ms, "launches": launches,
                "max_abs_err": float(err.max()),
                "bit_equal": bool(np.array_equal(got, want))}

    def delta_and_join():
        dsess = MatrelSession(mesh=me.mesh, config=MatrelConfig(
            result_cache_max_bytes=1 << 30))
        A = dsess.random((MR_DELTA_N, MR_DELTA_N), seed=7)
        B = dsess.random((MR_DELTA_N, MR_DELTA_N), seed=8)
        dsess.register("A", A)
        q = lambda: dsess.catalog["A"].expr().multiply(B.expr())
        dsess.run(q())
        rng = np.random.default_rng(13)
        edges = (rng.integers(0, MR_DELTA_N, MR_DELTA_EDGES),
                 rng.integers(0, MR_DELTA_N, MR_DELTA_EDGES),
                 rng.standard_normal(MR_DELTA_EDGES).astype(np.float32))
        t0 = time.perf_counter()
        rec = dsess.register_delta("A", edges, kind="coo")
        torch.cuda.synchronize()
        delta_s = time.perf_counter() - t0
        patched = dsess.run(q()).data
        full = MatrelSession(mesh=me.mesh).compute(
            dsess.catalog["A"].multiply(B)).data
        # both within the product bound 8·u·√K of the exact answer
        rel = float((patched - full).abs().max() / full.abs().max())
        bound = 2 * PROD_C * U32 * math.sqrt(MR_DELTA_N)
        if rec["patched"] != 1 or rel > bound:
            raise AssertionError(f"sharded tail (d) register_delta: "
                                 f"{rec}, rel {rel:.3e} > {bound:.3e}")
        jr = np.random.default_rng(14)
        a = jr.standard_normal((MR_JOIN_ROWS, MR_JOIN_COLS)).astype(
            np.float32)
        b = jr.standard_normal((MR_JOIN_ROWS, MR_JOIN_COLS)).astype(
            np.float32)
        je = R.join_on_rows(sess.from_numpy(a), sess.from_numpy(b),
                            "mul").with_attrs(replicate="align")
        coll.reset_tally()
        jres = sess.compute(je)
        jtally = coll.tally()
        if any(k.startswith(("all_gather", "gather_rep")) for k in jtally):
            raise AssertionError(f"sharded tail (d) align join moved a "
                                 f"whole operand: {jtally}")
        _, join_ms = me.timed(lambda: sess.compute(je), runs=3)
        want = me.block_of((a[:, :, None] * b[:, None, :]).reshape(
            MR_JOIN_ROWS, -1), jres.spec)
        if not np.array_equal(jres.data.cpu().numpy(), want):
            raise AssertionError("sharded tail (d) align join differs "
                                 "from numpy")
        return {"delta": {k: rec[k] for k in ("patched", "rules",
                                              "est_saved_flops")},
                "delta_s": delta_s, "delta_rel_err": rel,
                "join_tally": jtally, "join_ms": join_ms}

    def fuse_probe():
        """(e) row 1's tail with fusion and autotune on: the fused
        region's ``fuse|`` probes run over each rank's Shards, rank 0's
        medians decide on every rank; the table is under MR_DIR."""
        from matrel_tpu_torch.parallel import autotune
        table = os.path.join(MR_DIR, "fuse_autotune.json")
        if me.rank == 0 and os.path.exists(table):
            os.remove(table)
        autotune._FUSION_CACHE.clear()
        fsess = MatrelSession(mesh=me.mesh, config=MatrelConfig(
            fusion_enable=True, autotune=True, autotune_table_path=table))
        X, Y, C = (fsess.random((MR_ROW1_N, MR_ROW1_N), seed=s)
                   for s in (4, 5, 6))
        e = (X.multiply(Y).elem_multiply(C).multiply_scalar(0.5)
             .add_scalar(1.0).row_sum())
        t = time.perf_counter()
        plan = fsess.compile(e)
        compile_s = time.perf_counter() - t
        res = fsess.compute(e)
        got = res.data.cpu().numpy()
        want = me.block_of(np.load(os.path.join(MR_DIR, "tail_ref.npy"))
                           [:, None], res.spec)
        bound = me.block_of(np.load(os.path.join(MR_DIR, "tail_bound.npy"))
                            [:, None], res.spec)
        err = np.abs(got.astype(np.float64) - want)
        if not np.isfinite(got).all() or (err > bound).any():
            raise AssertionError(f"sharded tail (e) fused: "
                                 f"{int((err > bound).sum())} rows past "
                                 f"their bound")
        rows = {k: v for k, v in autotune.load_table(table).items()
                if k.startswith("fuse|")}
        return {"rows": rows, "compile_s": compile_s,
                "winners": {k: v for k, v in autotune._FUSION_CACHE.items()
                            if k.startswith("fuse|")},
                "regions": plan.meta["fusion"]["regions"],
                "max_abs_err": float(err.max())}

    for name, fn in (("row1", row1_tail), ("row4", row4_cols),
                     ("row5", row5_damping), ("delta_join", delta_and_join),
                     ("fuse", fuse_probe)):
        log(f"rank {me.rank}: sharded_tail {name}")
        sub(name, fn)
    peak = max(v for k, v in out["peaks"].items() if k != "fuse")
    if peak > me.limits["tail"]:
        raise AssertionError(f"rank {me.rank} sharded_tail: peak device "
                             f"memory {peak:.3f} GiB > "
                             f"{me.limits['tail']:.3f} GiB ({out['peaks']})")
    if out["peaks"]["fuse"] > me.limits["fuse"]:
        raise AssertionError(f"rank {me.rank} sharded_tail (e): peak "
                             f"device memory {out['peaks']['fuse']:.3f} GiB"
                             f" > {me.limits['fuse']:.3f} GiB")
    return out


def mr_serve_queries(sess):
    """The serving reproducer at row 4's width: one shared S·D (bf16)
    and three queries over it — two chains S·D·W (W square, D's width)
    and a sum."""
    S, D = row4_inputs(sess)
    k = D.shape[1]
    W1, W2 = (sess.random((k, k), dtype="bfloat16", seed=s)
              for s in MR_SERVE_W_SEEDS)
    sh = S.multiply(D)
    return [sh.multiply(W1), sh.multiply(W2).multiply_scalar(2.0),
            sh.add(D)]


def mr_sync(mesh) -> None:
    import torch
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)


def mr_serving(me: MrRank) -> dict:
    """``submit`` on the decision log: the reproducer's three queries at
    row 4's width, one warm round, then a round with every rank
    submitting at once and one with rank 1 sleeping MR_SERVE_STAGGER_S
    after each submit. Each rank's blocks of the three answers are held
    to the one-card answers (bf16 tolerance); submit-to-result (rank 0's
    clock, from its first submit to its last result on the device), B1
    launches and the records' cost are reported a round."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.ops import pallas_spmm
    sess = MatrelSession(mesh=me.mesh, config=MatrelConfig(
        serve_max_batch=8, cse_enable=True))
    qs = mr_serve_queries(sess)
    refs = [np.load(os.path.join(MR_DIR, f"serve_ref{i}.npy"),
                    mmap_mode="r") for i in range(len(qs))]
    out = {}
    for name, stagger in (("warm", 0.0), ("even", 0.0),
                          ("staggered", MR_SERVE_STAGGER_S)):
        pipe = sess._serve
        before = pipe._log.info() if pipe is not None else {
            "cycles": 0, "exchanges": 0, "control_ms": 0.0}
        with me.mesh.ranks.held():
            from matrel_tpu_torch.parallel import collectives as coll
            coll.barrier(me.mesh)
        pallas_spmm.LAUNCHES = 0
        t0 = time.perf_counter()
        futs = []
        for q in qs:
            futs.append(sess.submit(q))
            if stagger and me.rank == 1:
                time.sleep(stagger)
        res = [f.result(timeout=MR_TIMEOUT_S) for f in futs]
        mr_sync(me.mesh)
        ms = (time.perf_counter() - t0) * 1e3
        sess.serve_drain()
        after = sess._serve._log.info()
        errs = []
        for i, (r, ref) in enumerate(zip(res, refs)):
            want = torch.as_tensor(np.array(me.block_of(ref, r.spec)),
                                   device=r.data.device)
            errs.append(check_close(f"serving {name} q{i}", r.data.float(),
                                    want, "bfloat16"))
        cycles = after["cycles"] - before["cycles"]
        out[name] = {
            "ms": ms, "launches": pallas_spmm.LAUNCHES,
            "max_abs_err": max(errs), "cycles": cycles,
            "exchanges": after["exchanges"] - before["exchanges"],
            "control_ms": after["control_ms"] - before["control_ms"],
            "batches": sess._serve.batches}
        del res, futs
    pipe = sess._serve
    out["counters"] = {"deadline_misses": pipe.deadline_misses,
                       "divergences": pipe.divergences,
                       "batches": pipe.batches}
    out["record_ms"] = mr_record_cost(me, pipe._log, len(qs))
    sess.serve_close(timeout=MR_TIMEOUT_S)
    return out


def mr_record_cost(me: MrRank, dlog, n: int, cycles: int = 20,
                   routed: bool = False) -> float:
    """The agreement's own cost a cycle, the ranks lined up (a barrier
    first, the worker idle): a record of ``n`` entries published, the
    ranks' reports gathered, one group's outcome gathered — the three
    exchanges of a pipeline's cycle — median ms on this rank's clock.
    ``routed``: the fleet router's record of one item instead, its two
    exchanges (the record, the ranks' reports on the item and their
    slices); a slice's own cycle then runs on the slice's ranks."""
    from matrel_tpu_torch.parallel import collectives as coll
    rec = {"cycle": 0, "seqs": list(range(n)), "fail": {}, "admit": [],
           "sample": None, "rung": 0, "stale": [],
           "waits": dict.fromkeys(range(n), 0.1), "depth": 0,
           "tenant_depths": {}}
    facts = {s: (True, "0" * 16, "", None) for s in range(n)}
    outcome = {"ok": True, "err": None, "late": [],
               "lat": dict.fromkeys(range(n), 1.0)}
    times = []
    item = {"seq": 0, "key": "0" * 16,
            "verdict": ("route", "k", 0, [], None)}
    with me.mesh.ranks.held():
        coll.barrier(me.mesh)
        for _ in range(cycles):
            t = time.perf_counter()
            if routed:
                dlog.publish({"cycle": 0, "items": [item]} if dlog.lead
                             else None)
                dlog.gather(([(True, "0" * 16, {}, True)],
                             {"wedged": [], "slices": {}}))
            else:
                dlog.broadcast(rec if dlog.lead else None)
                dlog.gather(facts)
                dlog.gather(outcome)
            times.append((time.perf_counter() - t) * 1e3)
    return statistics.median(times)


def mr_slice_block(full, local, mesh):
    """The block of a whole host array that ``local`` (a BlockMatrix on
    a slice's mesh) holds on this rank."""
    from matrel_tpu_torch.parallel import collectives as coll
    r0, r1, c0, c1 = coll.rect(coll.layout_of(local.spec, mesh),
                               mesh.ranks.coords, mesh.grid, full.shape)
    return full[r0:r1, c0:c1]


def mr_fleet(me: MrRank) -> dict:
    """The fleet on groups of ranks: 2 slices of 2 ranks. Row 4's S·D
    (bf16, registered) placed on a slice — B1 launches on that slice's
    ranks only, its blocks held to B1's plain version on one card; row
    2's chain over unregistered leaves placed on the span; the same
    S·D again, answered by the directory (no launch); then kill_slice
    of its owner and S·D once more, recomputed on the survivor, its
    to_numpy (a world collective) held to the plain version on every
    rank; last, row 5's A·x (a COO table) placed on a slice, B2 on its
    ranks only, held to one card's B2 answer. fleet_info is returned for
    the parent to compare across ranks."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.ops import pallas_spmm
    from matrel_tpu_torch.workloads import chain_bench
    plain = np.load(os.path.join(MR_DIR, "fleet_plain.npy"), mmap_mode="r")
    sess = MatrelSession(mesh=me.mesh, config=MatrelConfig(
        fleet_slices=MR_FLEET_SLICES, result_cache_max_bytes=8 << 30,
        fleet_span_margin=MR_FLEET_SPAN_MARGIN))
    S, D = row4_inputs(sess)
    sess.register("S", S)
    sess.register("D", D)
    t0 = time.perf_counter()
    fleet = sess._ensure_fleet()
    out = {"replicate_s": time.perf_counter() - t0,
           "source": fleet.source}

    def run(e, name):
        pallas_spmm.LAUNCHES = 0
        t = time.perf_counter()
        r = sess.submit(e).result(timeout=MR_TIMEOUT_S)
        mr_sync(me.mesh)
        ms = (time.perf_counter() - t) * 1e3
        sess.serve_drain()
        out[name] = {"ms": ms, "launches": pallas_spmm.LAUNCHES}
        return r

    def held_to_plain(r, name):
        sl = next(s for s in fleet.slices
                  if s.session.mesh is r.slice_mesh)
        out[name]["slice"] = sl.slice_id
        out[name]["member"] = sl.member
        if r.local is None:
            if out[name]["launches"]:
                raise AssertionError(f"fleet {name}: B1 launched on a "
                                     f"rank outside slice {sl.slice_id}")
            return
        want = torch.as_tensor(np.array(mr_slice_block(
            plain, r.local, r.slice_mesh)), device=r.local.data.device)
        out[name]["max_abs_err"] = check_close(
            f"fleet {name}", r.local.data.float(), want, "bfloat16")
        return r.local.data

    q = S.multiply(D)
    first = run(q, "slice_sd")
    got1 = held_to_plain(first, "slice_sd")
    if out["slice_sd"]["member"] and out["slice_sd"]["launches"] < 1:
        raise AssertionError("fleet: no B1 launch on the slice's ranks")
    mats = chain_bench.skewed_abc(me.mesh, *MR_ROW2, seed=3)
    chain = run(chain_bench.build_chain(mats), "span_chain")
    ref = np.load(os.path.join(MR_DIR, "row2_ref.npy"), mmap_mode="r")
    rel = float(np.abs(chain.data.cpu().numpy() - me.block_of(
        ref, chain.spec)).max() / np.abs(ref).max())
    if rel > 1e-5:
        raise AssertionError(f"fleet span chain: rel err {rel}")
    out["span_chain"]["rel_err"] = rel
    hit = run(q, "directory_hit")
    if out["directory_hit"]["launches"]:
        raise AssertionError("fleet: the directory hit launched B1")
    if hit.local is not None and got1 is not None and not torch.equal(
            hit.local.data, got1):
        raise AssertionError("fleet: the directory hit differs")
    owner = out["slice_sd"]["slice"]
    t = time.perf_counter()
    requeued = fleet.kill_slice(owner)
    out["kill_ms"] = (time.perf_counter() - t) * 1e3
    out["requeued"] = requeued
    again = run(q, "failover_sd")
    held_to_plain(again, "failover_sd")
    if out["failover_sd"]["slice"] == owner:
        raise AssertionError("fleet: the killed slice served S·D")
    t = time.perf_counter()
    host = again.to_numpy()
    out["to_numpy_ms"] = (time.perf_counter() - t) * 1e3
    check_close("fleet to_numpy", torch.from_numpy(host),
                torch.from_numpy(np.array(plain)), "bfloat16")
    del host
    # row 5's A·x placed on a slice: B2 on that slice's ranks only, held
    # to one card's B2 answer (the COO table is a host edge list the
    # slice's ranks take as it is)
    from matrel_tpu_torch.ops import pallas_spmv as pc
    _src, _dst, A5 = row5_matrix()
    x5 = np.random.default_rng(11).standard_normal(ROW5_N).astype(
        np.float32)
    sess.register("A5", A5)
    sess.register("x5", sess.from_numpy(x5[:, None]))
    pc.LAUNCHES_SPMV = 0
    t = time.perf_counter()
    y5 = sess.submit(A5.expr().multiply(sess.table("x5").expr())).result(
        timeout=MR_TIMEOUT_S)
    mr_sync(me.mesh)
    sess.serve_drain()
    out["slice_coo"] = {"ms": (time.perf_counter() - t) * 1e3,
                        "launches": pc.LAUNCHES_SPMV,
                        "member": y5.local is not None}
    if y5.local is not None:
        if out["slice_coo"]["launches"] < 1:
            raise AssertionError("fleet: no B2 launch on the slice's ranks")
        want = mr_slice_block(np.load(os.path.join(MR_DIR, "row5_y.npy"))
                              [:, None], y5.local, y5.slice_mesh)
        got = y5.local.data.cpu().numpy()
        out["slice_coo"]["max_abs_err"] = float(np.abs(got - want).max())
        out["slice_coo"]["bit_equal"] = bool(np.array_equal(got, want))
        check_close("fleet COO A·x", torch.from_numpy(got),
                    torch.from_numpy(np.array(want)), "float32")
    elif out["slice_coo"]["launches"]:
        raise AssertionError("fleet: B2 launched outside its slice")
    info = sess.fleet_info()
    out["info"] = {k: info[k] for k in (
        "source", "directory", "placed", "pinned", "migrations",
        "failovers", "requeued")}
    out["info"]["slices"] = [{k: sl[k] for k in ("id", "alive", "devices",
                                                 "submitted")}
                             for sl in info["slices"]]
    out["router"] = fleet._log.info()
    out["record_ms"] = mr_record_cost(me, fleet._log, 1, routed=True)
    sess.serve_close(timeout=MR_TIMEOUT_S)
    return out


def mr_fleet_concurrent(me: MrRank) -> dict:
    """A fresh fleet of 2 slices of 2 ranks, one query a batch, no
    result cache (no directory hit): (g) row 4's S·D once on each slice
    alone, then twice at once, one on each slice — the pair's
    submit-to-result against each alone, B1 launched on every rank;
    (h) S·D MR_FLEET_BURST times at once, slice 0's first run held
    until kill_slice(0) returns: the entries still waiting in slice 0's
    queue re-admit onto slice 1, the one in a cycle finishes on slice
    0. Every answer's blocks are held to B1's plain version on the
    slice's ranks."""
    import numpy as np
    import torch
    from matrel_tpu_torch import MatrelConfig, MatrelSession
    from matrel_tpu_torch.ops import pallas_spmm
    plain = np.load(os.path.join(MR_DIR, "fleet_plain.npy"), mmap_mode="r")
    sess = MatrelSession(mesh=me.mesh, config=MatrelConfig(
        fleet_slices=MR_FLEET_SLICES, result_cache_max_bytes=0,
        serve_max_batch=1, fleet_span_margin=MR_FLEET_SPAN_MARGIN))
    S, D = row4_inputs(sess)
    sess.register("S", S)
    sess.register("D", D)
    fleet = sess._ensure_fleet()
    q = S.multiply(D)
    out = {}

    def held(results, name):
        errs = []
        for r in results:
            if r.local is None:
                continue
            want = torch.as_tensor(np.array(mr_slice_block(
                plain, r.local, r.slice_mesh)), device=r.local.data.device)
            errs.append(check_close(f"fleet {name}", r.local.data.float(),
                                    want, "bfloat16"))
        return max(errs, default=0.0)

    def burst(n, name):
        """n S·D at once: this rank's submit-to-result (every answer
        here) and to its own slice's answers (resolved by its slice's
        worker, synchronised), its B1 launches, the answers."""
        with me.mesh.ranks.held():
            from matrel_tpu_torch.parallel import collectives as coll
            coll.barrier(me.mesh)
        pallas_spmm.LAUNCHES = 0
        done = {}
        t = time.perf_counter()
        futs = [sess.submit(q) for _ in range(n)]
        for i, f in enumerate(futs):
            f.add_done_callback(
                lambda f, i=i: done.setdefault(i, time.perf_counter()))
        res = [f.result(timeout=MR_TIMEOUT_S) for f in futs]
        mr_sync(me.mesh)
        ms = (time.perf_counter() - t) * 1e3
        own = [done[i] for i, r in enumerate(res) if r.local is not None]
        sess.serve_drain()
        out[name] = {"ms": ms, "launches": pallas_spmm.LAUNCHES,
                     "own_ms": (max(own) - t) * 1e3 if own else None,
                     "slices": [next(sl.slice_id for sl in fleet.slices
                                     if sl.session.mesh is r.slice_mesh)
                                for r in res]}
        out[name]["max_abs_err"] = held(res, name)
        return res

    burst(2, "warm")                # each slice builds its plan
    for k in range(2):
        burst(1, f"alone{k}")
    pair = burst(2, "pair")
    if sorted(out["pair"]["slices"]) != [0, 1]:
        raise AssertionError(f"fleet (g): the pair ran on slices "
                             f"{out['pair']['slices']}")
    if out["pair"]["launches"] < 1:
        raise AssertionError(f"fleet (g): no B1 launch on rank {me.rank}")
    del pair
    # (h) the burst with slice 0's first run held until the kill, so
    # that its queue still holds the rest
    import threading
    gate = threading.Event()
    s0 = fleet.slices[0]
    run = s0.session.run_many

    def gated(*a, **k):
        gate.wait(MR_TIMEOUT_S)
        return run(*a, **k)

    s0.session.run_many = gated
    pallas_spmm.LAUNCHES = 0
    t = time.perf_counter()
    futs = [sess.submit(q) for _ in range(MR_FLEET_BURST)]
    out["requeued"] = fleet.kill_slice(0)
    gate.set()
    res = [f.result(timeout=MR_TIMEOUT_S) for f in futs]
    mr_sync(me.mesh)
    sess.serve_drain()
    del s0.session.run_many
    out["burst"] = {"ms": (time.perf_counter() - t) * 1e3,
                    "launches": pallas_spmm.LAUNCHES,
                    "max_abs_err": held(res, "burst")}
    if out["requeued"] < 1:
        raise AssertionError("fleet (h): kill_slice re-admitted nothing")
    info = sess.fleet_info()
    out["info"] = {k: info[k] for k in ("placed", "failovers", "requeued")}
    out["info"]["slices"] = [{k: sl[k] for k in ("id", "alive",
                                                  "submitted")}
                             for sl in info["slices"]]
    if out["info"]["requeued"] != out["requeued"]:
        raise AssertionError(f"fleet (h): requeued {out['requeued']} vs "
                             f"fleet_info {out['info']}")
    out["router"] = fleet._log.info()
    del res, futs
    sess.serve_close(timeout=MR_TIMEOUT_S)
    return out


def mr_rank(rank: int, world: int, backend: str, init: str,
            limits: dict) -> None:
    """One rank of path_multirank: its log to ``rank<r>.log``, its
    results to ``rank<r>.json`` under MR_DIR; ``limits`` the sub-phases'
    peak-memory bounds (GiB)."""
    import torch
    log_f = open(os.path.join(MR_DIR, f"rank{rank}.log"), "w")
    os.dup2(log_f.fileno(), 1)
    os.dup2(log_f.fileno(), 2)
    sys.path.insert(0, HERE)
    from matrel_tpu_torch.core import mesh as mesh_lib
    device = f"cuda:{rank}" if backend == "nccl" else "cuda:0"
    mesh = mesh_lib.init_distributed(backend, init, world, rank,
                                     grid=MR_GRID, device=device,
                                     timeout_s=MR_TIMEOUT_S)
    me = MrRank(mesh, limits)
    me.out.update(backend=backend, world=world, device=str(mesh.device),
                  coords=mesh.ranks.coords,
                  host_staged=sorted(mesh.ranks.host_staged))
    log(f"rank {rank}: backend {backend}, world {world}, device "
        f"{mesh.device}, cell {mesh.ranks.coords}, host-staged "
        f"{sorted(mesh.ranks.host_staged)}")
    for name, fn in (("row1", mr_row1), ("row2", mr_row2),
                     ("row5", mr_row5), ("sparse", mr_sparse),
                     ("chain", mr_chain), ("autotune", mr_autotune),
                     ("sharded_tail", mr_sharded_tail),
                     ("serving", mr_serving), ("fleet", mr_fleet),
                     ("fleet_concurrent", mr_fleet_concurrent)):
        log(f"rank {rank}: {name}")
        if name in limits:
            with me.meter(name):
                me.out[name] = fn(me)
        else:
            me.out[name] = fn(me)
    # a failing rank raises before this: the parent kills the others
    mesh_lib.shutdown_distributed()
    with open(os.path.join(MR_DIR, f"rank{rank}.json"), "w") as f:
        json.dump(me.out, f)


def mr_references(sess, ns_fro: float) -> None:
    """The single-rank answers, from the same seeds, on this card: row
    1's product and its 8·u·√K·‖row‖ bound, row 2's float64 chain, row
    5's A·x, A·X and PageRank (and float64 scipy's), spgemm's tiles and
    row 4's product."""
    import numpy as np
    import torch
    from matrel_tpu_torch.ops import spgemm as sg
    from matrel_tpu_torch.parallel import strategies
    from matrel_tpu_torch.workloads import chain_bench, pagerank as pr
    from matrel_tpu_torch.core.sparse import BlockSparseMatrix
    os.makedirs(MR_DIR, exist_ok=True)
    save = lambda name, a: np.save(os.path.join(MR_DIR, name), a)
    X = sess.random((MR_ROW1_N, MR_ROW1_N), seed=4).data
    Y = sess.random((MR_ROW1_N, MR_ROW1_N), seed=5).data
    XY = strategies.local_dot(X, Y)
    save("row1_ref.npy", XY.cpu().numpy())
    # the bound's row norms of X and column norms of Y (mr_row1)
    xr, yc = X.double().norm(dim=1), Y.double().norm(dim=0)
    save("row1_norms.npy", np.stack([xr.cpu().numpy(), yc.cpu().numpy()]))
    # sharded_tail (a): ((X·Y) ⊙ C · 0.5 + 1) summed by rows, and its
    # bound: each product entry within 8·u·√K·‖X_i‖·‖Y_:j‖ on both
    # sides, scaled by 0.5·|C_ij| and summed over j, plus both row sums'
    # rounding (2·m·u·Σ_j |t_ij|)
    C = sess.random((MR_ROW1_N, MR_ROW1_N), seed=6).data
    t = XY * C * 0.5 + 1.0
    save("tail_ref.npy", t.sum(dim=1).cpu().numpy())
    save("tail_bound.npy", (
        PROD_C * U32 * math.sqrt(MR_ROW1_N) * xr
        * (C.double().abs() @ yc)
        + 2 * MR_ROW1_N * U32 * t.double().abs().sum(dim=1)).cpu().numpy())
    del X, Y, XY, C, t, xr, yc
    mats = chain_bench.skewed_abc(sess.mesh, *MR_ROW2, seed=3)
    A, B, C = (m.data.double() for m in mats)
    save("row2_ref.npy", (A @ (B @ C)).cpu().numpy())
    del A, B, C, mats
    src, dst, M = row5_matrix()
    rng = np.random.default_rng(11)
    x = rng.standard_normal(ROW5_N).astype(np.float32)
    X = rng.standard_normal((ROW5_N, ROW5_K)).astype(np.float32)
    dev = sess.device
    save("row5_y.npy", M.matvec(x, device=dev).cpu().numpy())
    save("row5_Y.npy", M.matmat(X, device=dev).cpu().numpy())
    save("row5_pr.npy", pr.pagerank_edges(
        src, dst, ROW5_N, rounds=ROW5_ROUNDS, impl="onehot", passes=3,
        device=dev).double().cpu().numpy())
    save("row5_pr64.npy", pagerank_oracle(src, dst, ROW5_N, ROW5_ROUNDS))
    del M, src, dst
    SA, SB = (BlockSparseMatrix.random(
        (MR_SPGEMM_N, MR_SPGEMM_N), 0.01, block_size=512, mesh=sess.mesh,
        seed=s, dtype="bfloat16") for s in (2, 3))
    save("spgemm_tiles.npy", sg.spgemm(SA, SB).blocks.float().cpu().numpy())
    del SA, SB
    S, D = row4_inputs(sess)
    save("spmm_ref.npy", sess.compute(S.multiply(D)).data.float()
         .cpu().numpy())
    from matrel_tpu_torch.ops import pallas_spmm
    save("fleet_plain.npy", pallas_spmm.spmm_blocksparse_plain(
        S.blocks, S.block_rows, S.block_cols, D.data, S.shape[0])
        .float().cpu().numpy())
    del S, D
    for i, q in enumerate(mr_serve_queries(sess)):
        save(f"serve_ref{i}.npy", sess.compute(q).data.float()
             .cpu().numpy())
    with open(os.path.join(MR_DIR, "one_card.json"), "w") as f:
        json.dump({"ns_fro": ns_fro}, f)
    torch.cuda.empty_cache()


def path_multirank(sess, ns_fro: float) -> dict:
    """Four ranks on a 2 × 2 grid through MatrelSession(mesh=<rank
    mesh>), each held against the single-rank answers: row 1 under every
    strategy, row 2 under the planner's stamps (equal to the one-card
    planner's on a virtual (2, 2) grid) and under a staged-reshard
    budget, row 5's products and PageRank, spgemm_sharded, spmm_sharded,
    streaming_chain_sharded and autotune_matmul. NCCL with a card a rank
    where there are four cards, else gloo with the four ranks on this
    card. Returns the ranks' B2 / B3 launches, summed."""
    import numpy as np
    import torch
    import torch.multiprocessing as mp
    from matrel_tpu_torch.core.mesh import make_mesh
    from matrel_tpu_torch import MatrelSession as Session
    from matrel_tpu_torch.workloads import chain_bench
    t0 = time.perf_counter()
    mr_references(sess, ns_fro)
    ref_s = time.perf_counter() - t0
    vsess = Session(mesh=make_mesh(MR_GRID, device=sess.device))
    want_row2 = mr_stamps(vsess.compile(chain_bench.build_chain(
        chain_bench.skewed_abc(vsess.mesh, *MR_ROW2, seed=3))))
    del vsess
    torch.cuda.empty_cache()
    world = MR_GRID[0] * MR_GRID[1]
    backend = "nccl" if torch.cuda.device_count() >= world else "gloo"
    init = f"tcp://localhost:{mr_free_port()}"
    for r in range(world):
        for ext in ("json", "log"):
            p = os.path.join(MR_DIR, f"rank{r}.{ext}")
            if os.path.exists(p):
                os.remove(p)
    log(f"path multirank: {world} ranks on a {MR_GRID} grid, backend "
        f"{backend} ({torch.cuda.device_count()} card(s)); single-rank "
        f"answers {ref_s:.1f} s")
    t0 = time.perf_counter()
    ctx = mp.start_processes(mr_rank, args=(world, backend, init,
                                            dict(MR_PEAK_LIMIT_GIB)),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + MR_TIMEOUT_S
    failure = None
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"ranks did not finish in "
                                   f"{MR_TIMEOUT_S} s")
    except Exception as ex:        # noqa: BLE001 — reported with the logs
        failure = ex
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(5)
    wall_s = time.perf_counter() - t0
    for r in range(world):
        p = os.path.join(MR_DIR, f"rank{r}.log")
        if os.path.exists(p):
            for line in open(p).read().splitlines()[-(40 if failure
                                                      else 12):]:
                log(f"  rank {r} | {line}")
    if failure is not None:
        raise AssertionError(f"path multirank: {failure!r}")
    ranks = [json.load(open(os.path.join(MR_DIR, f"rank{r}.json")))
             for r in range(world)]
    r0 = ranks[0]
    log(f"path multirank: ranks done in {wall_s:.1f} s; backend "
        f"{r0['backend']}, world {r0['world']}, devices "
        + ", ".join(f"rank {r}: {o['device']}" for r, o in enumerate(ranks))
        + f"; collectives staged through host memory: "
        f"{r0['host_staged'] or 'none'}; {device_line()}")
    for s in MR_STRATEGIES:
        row = r0["row1"][s]
        errs = [o["row1"][s]["max_abs_err"] for o in ranks]
        if any(o["row1"][s]["collectives"] != row["collectives"]
               for o in ranks):
            raise AssertionError(f"row 1 {s}: collectives() differ by "
                                 f"rank")
        log(f"  row 1 {s}: stamps {row['stamps']}, {row['ms']:.3f} ms a "
            f"product (rank 0, CUDA events between barriers, median of "
            f"3), tally {row['tally']}, collectives() "
            f"{row['collectives']}, max err {max(errs):.3e} ("
            f"{max(o['row1'][s]['err_over_bound'] for o in ranks):.3f} of "
            f"8·u·√K·‖X_i‖·‖Y_:j‖), bit-equal to one rank on "
            f"{sum(o['row1'][s]['bit_equal'] for o in ranks)}/{world} "
            f"ranks")
        if "staged" in row:
            log(f"    under a {MR_RESHARD_BUDGET >> 20} MiB reshard budget: "
                f"moves {row['staged']['moves']}, tally "
                f"{row['staged']['tally']}, bit-equal to budget 0")
    plans = r0["row2"]["plans"]
    for o in ranks:
        if o["row2"]["plans"]["0"]["stamps"] != want_row2:
            raise AssertionError(f"row 2 stamps {o['row2']['plans']} vs "
                                 f"the virtual (2, 2) grid's {want_row2}")
    log(f"  row 2: plan {plans['0']['paren']}, stamps "
        f"{plans['0']['stamps']} (the virtual (2, 2) grid's: {want_row2}),"
        f" {plans['0']['ms']:.3f} ms; under a "
        f"{MR_RESHARD_BUDGET >> 20} MiB budget {plans[str(MR_RESHARD_BUDGET)]['ms']:.3f} "
        f"ms, moves {plans[str(MR_RESHARD_BUDGET)]['moves']}, bit-equal "
        f"to budget 0; rel err {r0['row2']['rel_err']:.3e} vs float64; "
        f"measure_reshard_variant row->col {MR_ROW1_N}² "
        f"({r0['row2']['reshard_steps']}): "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in
                    r0["row2"]["reshard_ms"].items()))
    row5 = r0["row5"]
    launches = {k: sum(o["row5"]["launches"][k] for o in ranks)
                for k in ("spmv_compact", "spmm_compact")}
    log(f"  row 5: A·x {row5['spmv_ms']:.3f} ms, A·X (k = {ROW5_K}) "
        f"{row5['spmm_ms']:.3f} ms (sharded, B2/B3 on each rank's slice, "
        f"bit-equal / rel {row5['rel_err_Y']:.2e} vs one card; plan "
        f"build and first call {row5['first_s']:.2f} s); PageRank "
        f"{row5['pagerank_round_ms']:.4f} ms per round, max err "
        f"{max(o['row5']['pagerank_err_f64'] for o in ranks):.2e} vs "
        f"float64 scipy, {row5['pagerank_vs_one_card']:.2e} vs one card;"
        f" B2 launches {launches['spmv_compact']}, B3 "
        f"{launches['spmm_compact']} (summed over ranks)")
    sp = r0["sparse"]
    log(f"  spgemm_sharded n={MR_SPGEMM_N:,}: {sp['spgemm']['ms']:.3f} ms "
        f"({sp['spgemm']['tiles']} tiles, max err "
        f"{sp['spgemm']['max_abs_err']:.2e}); spmm_sharded at row 4: "
        f"{sp['spmm']['ms']:.3f} ms (cap {sp['spmm']['cap']} tiles a "
        f"rank, padding {sp['spmm']['padding_ratio']:.3f}, max err "
        f"{sp['spmm']['max_abs_err']:.2e})")
    ch = r0["chain"]
    flops = 4.0 * NS_N ** 3
    rel = abs(ch["fro"] - ns_fro) / abs(ns_fro)
    # four panel partials summed in f32 in another order than one card's
    # running sum: at most (p - 1) roundings of a sum no larger than it
    bound = (world - 1) * U32
    if not all(o["chain"]["same"] and o["chain"]["fro"] == ch["fro"]
               for o in ranks) or rel > bound:
        raise AssertionError(f"streaming_chain_sharded {ch} vs one card "
                             f"{ns_fro!r}: rel {rel:.3e} > {bound:.3e}")
    log(f"  streaming_chain_sharded n={NS_N:,} (one panel a rank): "
        + ", ".join(f"{s:.3f}" for s in ch["s"])
        + f" s ({flops / min(ch['s']) / 1e12:.1f} TFLOP/s against 4n³), "
        f"Frobenius² {ch['fro']:.9e}, rel {rel:.2e} vs one card's "
        f"streaming_chain_slab (bound {bound:.2e})")
    at = [o["autotune"] for o in ranks]
    if any(a != at[0] for a in at):
        raise AssertionError(f"autotune winners differ across ranks: {at}")
    log(f"  autotune_matmul {MR_AT_SIDE}² on the rank grid: winner "
        f"{at[0]['best']} on every rank; "
        + ", ".join(f"{k} {v:.3f} ms" for k, v in at[0]["ms"].items()))
    log("  per-rank peak device memory (GiB): " + "; ".join(
        f"rank {r} " + ", ".join(f"{k} {v:.3f}" for k, v in
                                 o["peaks"].items())
        for r, o in enumerate(ranks)))
    tails = [o["sharded_tail"] for o in ranks]
    t0r = tails[0]
    a, b, c, d = (t0r[k] for k in ("row1", "row4", "row5", "delta_join"))
    log(f"  sharded_tail (a) row 1 ((X·Y) ⊙ C · 0.5 + 1 → row_sum, "
        f"{MR_ROW1_N}²): {a['ms']:.3f} ms (rank 0, CUDA events between "
        f"barriers, median of 3), tally {a['tally']}, max err "
        f"{max(t['row1']['max_abs_err'] for t in tails):.3e} ("
        f"{max(t['row1']['err_over_bound'] for t in tails):.3f} of its "
        f"bound), bit-equal to one rank on "
        f"{sum(t['row1']['bit_equal'] for t in tails)}/{world} ranks")
    log(f"  sharded_tail (b) row 4 S·D bf16, B1 on {b['slice_cols']}-column"
        f" slices ({b['split']}): {b['ms']:.3f} ms, tally {b['tally']}, "
        f"B1 launches {sum(t['row4']['launches'] for t in tails)} over "
        f"the ranks (bodies {b['bodies']} on rank 0), max err "
        f"{max(t['row4']['max_abs_err'] for t in tails):.3e} vs one card,"
        f" bit-equal on {sum(t['row4']['bit_equal'] for t in tails)}/"
        f"{world} ranks")
    log(f"  sharded_tail (c) row 5 (A·x) · 0.85 + c: {c['ms']:.3f} ms, B2 "
        f"launches {sum(t['row5']['launches'] for t in tails)}, max err "
        f"{max(t['row5']['max_abs_err'] for t in tails):.3e}, bit-equal "
        f"on {sum(t['row5']['bit_equal'] for t in tails)}/{world} ranks")
    log(f"  sharded_tail (d) register_delta {MR_DELTA_N}² + "
        f"{MR_DELTA_EDGES} edges: {d['delta']}, {d['delta_s']:.3f} s, rel "
        f"{max(t['delta_join']['delta_rel_err'] for t in tails):.3e} vs "
        f"recompute; align join {MR_JOIN_ROWS}×{MR_JOIN_COLS}²: "
        f"{d['join_ms']:.3f} ms, tally {d['join_tally']}")
    fz = [t["fuse"] for t in tails]
    if any(f["winners"] != fz[0]["winners"] or f["regions"]
           != fz[0]["regions"] for f in fz) or len(fz[0]["rows"]) != 1:
        raise AssertionError(f"sharded tail (e): the ranks' fuse| winners "
                             f"differ or no single row: "
                             f"{[(f['winners'], f['regions']) for f in fz]}")
    (fkey, frow), = fz[0]["rows"].items()
    log(f"  sharded_tail (e) fuse| probes of (a)'s fused region on the "
        f"ranks: {fkey}: "
        + ", ".join(f"{k} {v * 1e3:.3f} ms" for k, v in
                    frow["times"].items())
        + f" (rank 0's medians of 5, CUDA events), winner "
        f"{frow['best']} on every rank, {fz[0]['regions']} fused "
        f"region(s) stamped, compile with the probes "
        f"{fz[0]['compile_s']:.2f} s, max err "
        f"{max(f['max_abs_err'] for f in fz):.3e} within (a)'s bound")
    log(f"  sharded_tail per-rank peaks (GiB; the whole {MR_ROW1_N}² f32 "
        f"product is {MR_ROW1_N ** 2 * 4 / 2**30:.4f} GiB): " + "; ".join(
            f"rank {r} " + ", ".join(f"{k} {v:.3f}" for k, v in
                                     t["peaks"].items())
            for r, t in enumerate(tails)))
    sv = [o["serving"] for o in ranks]
    log(f"  serving: a decision cycle's three exchanges (record, reports,"
        f" outcome), ranks lined up: "
        + ", ".join(f"{o['record_ms']:.3f}" for o in sv)
        + " ms by rank (median of 20)")
    for name in ("warm", "even", "staggered"):
        r0s = sv[0][name]
        log(f"  serving {name}: submit-to-result {r0s['ms']:.1f} ms "
            f"(rank 0's clock; ranks: "
            + ", ".join(f"{o[name]['ms']:.1f}" for o in sv)
            + f"), {r0s['cycles']} decision cycle(s), "
            f"{r0s['exchanges']} control exchanges, "
            f"{r0s['control_ms'] / max(r0s['exchanges'], 1):.3f} ms an "
            f"exchange on rank 0, B1 launches "
            f"{sum(o[name]['launches'] for o in sv)} over the ranks, max "
            f"err {max(o[name]['max_abs_err'] for o in sv):.3e} vs one "
            f"card")
    if any(o["counters"] != sv[0]["counters"] for o in sv) \
            or sv[0]["counters"]["divergences"]:
        raise AssertionError(f"serving counters differ: "
                             f"{[o['counters'] for o in sv]}")
    fl = [o["fleet"] for o in ranks]
    if any(o["info"] != fl[0]["info"] for o in fl):
        raise AssertionError(f"fleet_info differs across ranks: "
                             f"{[o['info'] for o in fl]}")
    f0 = fl[0]
    fleet_b1 = sum(o[k]["launches"] for o in fl
                   for k in ("slice_sd", "failover_sd"))
    members = [r for r, o in enumerate(fl) if o["slice_sd"]["member"]]
    log(f"  fleet ({f0['source']}, {MR_FLEET_SLICES} slices of "
        f"{world // MR_FLEET_SLICES} ranks; tables replicated in "
        f"{f0['replicate_s']:.2f} s): S·D on slice "
        f"{f0['slice_sd']['slice']} (ranks {members}) "
        f"{f0['slice_sd']['ms']:.1f} ms submit-to-result, B1 launches "
        + ", ".join(str(o["slice_sd"]["launches"]) for o in fl)
        + " by rank, max err "
        f"{max(o['slice_sd'].get('max_abs_err', 0.0) for o in fl):.3e} vs"
        f" B1's plain version; span chain {f0['span_chain']['ms']:.1f} ms "
        f"(rel {f0['span_chain']['rel_err']:.2e}); directory hit "
        f"{f0['directory_hit']['ms']:.2f} ms, 0 launches; kill_slice "
        f"{f0['kill_ms']:.2f} ms (requeued {f0['requeued']}), then S·D on "
        f"slice {f0['failover_sd']['slice']} "
        f"{f0['failover_sd']['ms']:.1f} ms, to_numpy (world) "
        f"{f0['to_numpy_ms']:.1f} ms; row 5's A·x on a slice "
        f"{f0['slice_coo']['ms']:.1f} ms, B2 launches "
        + ", ".join(str(o["slice_coo"]["launches"]) for o in fl)
        + " by rank, bit-equal to one card on "
        f"{sum(o['slice_coo'].get('bit_equal', False) for o in fl)} of "
        f"{sum(o['slice_coo']['member'] for o in fl)} slice ranks; router "
        f"{f0['router']}; the router's record of one item (two "
        f"exchanges), ranks lined up: "
        + ", ".join(f"{o['record_ms']:.3f}" for o in fl)
        + f" ms by rank (median of 20); fleet_info equal on every rank: "
        f"{f0['info']}")
    fc = [o["fleet_concurrent"] for o in ranks]
    if any(o["requeued"] != fc[0]["requeued"] or o["info"] != fc[0]["info"]
           for o in fc):
        raise AssertionError(f"fleet (h): requeued / fleet_info differ "
                             f"across ranks: "
                             f"{[(o['requeued'], o['info']) for o in fc]}")
    if any(o["pair"]["launches"] < 1 for o in fc):
        raise AssertionError(f"fleet (g): B1 launches by rank "
                             f"{[o['pair']['launches'] for o in fc]}")
    for name in ("alone0", "alone1", "pair"):
        log(f"  fleet (g) {name} (slices {fc[0][name]['slices']}): "
            f"submit-to-result "
            + ", ".join(f"{o[name]['ms']:.2f}" for o in fc)
            + " ms by rank's clock (its own slice's answer: "
            + ", ".join("—" if o[name]["own_ms"] is None
                        else f"{o[name]['own_ms']:.2f}" for o in fc)
            + " ms, unsynchronised), B1 launches "
            + ", ".join(str(o[name]["launches"]) for o in fc)
            + f" by rank, max err "
            f"{max(o[name]['max_abs_err'] for o in fc):.3e} vs B1's plain "
            f"version")
    log(f"  fleet (h) {MR_FLEET_BURST} S·D at once, slice 0's first run "
        f"held until kill_slice(0) returned: requeued "
        f"{fc[0]['requeued']} on every rank, B1 "
        f"launches " + ", ".join(str(o["burst"]["launches"]) for o in fc)
        + f" by rank, max err "
        f"{max(o['burst']['max_abs_err'] for o in fc):.3e}; fleet_info "
        f"{fc[0]['info']}; router {fc[0]['router']}")
    fleet_b1 += sum(o[k]["launches"] for o in fc
                    for k in ("warm", "alone0", "alone1", "pair", "burst"))
    if fleet_b1 < 1:
        raise AssertionError("path multirank: no B1 launch in the fleet")
    launches["spmv_compact"] += sum(o["slice_coo"]["launches"] for o in fl)
    if min(launches.values()) < 1:
        raise AssertionError(f"path multirank: B2/B3 launches {launches}")
    serve_b1 = sum(o[name]["launches"] for o in sv
                   for name in ("warm", "even", "staggered"))
    b1 = sum(t["row4"]["launches"] for t in tails) + fleet_b1 + serve_b1
    if b1 < world:
        raise AssertionError(f"path multirank: B1 launches {b1} on the "
                             f"ranks")
    launches["spmv_compact"] += sum(t["row5"]["launches"] for t in tails)
    launches["spmm_blocksparse"] = b1
    return {"launches": launches, "ranks": ranks}


def ptxas_functions(log_text: str) -> dict:
    """{mangled function: (registers, stack, spill stores, spill loads)}
    from an ``nvcc -Xptxas=-v`` log."""
    import re
    out, fn, props = {}, None, None
    for line in log_text.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and fn:
            props = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and fn and props is not None:
            out[fn] = (int(m.group(1)),) + props
            fn = props = None
    return out


def sass_counts(lib, opcodes) -> dict:
    """{function: {opcode: count}} of a built library's SASS
    (``cuobjdump -sass``); an opcode counts every instruction whose
    mnemonic starts with it (``ATOMS`` counts ``ATOMS.CAST.SPIN.64``)."""
    import re
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    out, fn = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = dict.fromkeys(opcodes, 0)
            continue
        m = re.search(r"\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            op = m.group(1)
            for want in opcodes:
                if op == want or op.startswith(want + "."):
                    out[fn][want] += 1
    return out


def build_checks(libs) -> None:
    """What the kernels' designs promise, read from the build: no f32 tile
    instance (csrc/f32_tile_simt.cuh: B4–B7's 12, B1's 4) and no instance
    of B1's narrow row walk spills (ptxas), the narrow walk and B2/B3's
    library hold no atomic (SASS), and each bf16 wgmma instance holds
    HGMMA and UTMALDG and no HMMA (SASS), spills nothing and has no wgmma
    that ptxas serialised; logs the f32 instances' LDS.128 : FFMA mix and
    the narrow walk's DFMA : LDG mix."""
    by_name = {lib.stem.split("-")[0]: lib for lib in libs}
    for lib_name, kernel, want in (
            ("libspgemm_registry", "f32_tile_kernel", 12),
            ("libspmm_blocksparse", "f32_tile_kernel", 4),
            ("libspmm_blocksparse", "spmm_narrow_kernel", 10)):
        lib = by_name[lib_name]
        props = {fn: v for fn, v in ptxas_functions(
            lib.with_suffix(".log").read_text()).items() if kernel in fn}
        if len(props) != want:
            raise AssertionError(f"ptxas reported {len(props)} {kernel} "
                                 f"instances in {lib_name}, want {want}")
        spills = {fn: v for fn, v in props.items() if v[2] or v[3]}
        if spills:
            raise AssertionError(f"{lib_name}: {kernel} instances spill: "
                                 f"{spills}")
        ops = ("FFMA", "LDS", "LDS.128", "LDGSTS", "BAR", "DFMA", "LDG",
               "F2F", "SHFL", "ATOM", "ATOMG", "ATOMS", "RED")
        mix = sass_counts(lib, ops)
        for fn, (regs, stack, _, _) in sorted(props.items()):
            c = mix.get(fn, {})
            atomics = {o: c.get(o) for o in ("ATOM", "ATOMG", "ATOMS", "RED")
                       if c.get(o)}
            if kernel == "spmm_narrow_kernel" and atomics:
                raise AssertionError(f"{lib_name} {fn}: atomics {atomics}")
            log(f"  {kernel} {lib_name[3:]} {fn[-60:]}: {regs} registers, "
                f"{stack} B stack, 0 spills; SASS " + ", ".join(
                    f"{o} {c.get(o)}" for o in ops if c.get(o)))
    atoms = {fn: c["ATOMS"] for fn, c in sass_counts(
        by_name["libspmv_compact"], ("ATOMS", "ATOM", "RED")).items()
        if c["ATOMS"]}
    if atoms:
        raise AssertionError(f"shared-memory atomics in spmv_compact: "
                             f"{atoms}")
    log("  spmv_compact SASS: no ATOMS")
    # the bf16 wgmma body (csrc/bf16_tile_wgmma.cuh): B1's instance and
    # B4-B7's three (one per pair list)
    for lib_name, want in (("libspmm_blocksparse", 1),
                           ("libspgemm_registry", 3)):
        lib = by_name[lib_name]
        log_text = lib.with_suffix(".log").read_text()
        props = {fn: v for fn, v in ptxas_functions(log_text).items()
                 if "bf16_wgmma_kernel" in fn}
        sass = {fn: c for fn, c in sass_counts(
            lib, ("HGMMA", "UTMALDG", "HMMA", "WARPGROUP")).items()
            if "bf16_wgmma_kernel" in fn}
        if len(props) != want or set(sass) != set(props):
            raise AssertionError(f"{lib_name}: {len(props)} wgmma instances "
                                 f"in the ptxas log, {len(sass)} in the "
                                 f"SASS, want {want}")
        for fn, (regs, stack, st, ld) in sorted(props.items()):
            c = sass[fn]
            if st or ld or not c["HGMMA"] or not c["UTMALDG"] or c["HMMA"]:
                raise AssertionError(f"{lib_name} {fn}: spill stores {st}, "
                                     f"loads {ld}, SASS {c}: want no spill, "
                                     f"HGMMA and UTMALDG, no HMMA")
            log(f"  bf16 wgmma {lib_name[3:]} {fn[-60:]}: {regs} registers,"
                f" {stack} B stack, 0 spills; SASS HGMMA {c['HGMMA']}, "
                f"UTMALDG {c['UTMALDG']}, WARPGROUP {c['WARPGROUP']}, HMMA 0")
        serial = [line for line in log_text.splitlines()
                  if "wgmma.mma_async instructions are serialized" in line]
        if serial:
            raise AssertionError(f"{lib_name}: ptxas serialised wgmma: "
                                 f"{serial[0][:300]}")


def kernel_entry(name, source, replaces, launches, row) -> dict:
    entry = {"name": name, "route": "cuda",
             "source": f"matrel_tpu_torch/csrc/{source}",
             "replaces": replaces, "launches": launches,
             "max_abs_err": row["max_abs_err"], "ms": row["ms"],
             "kernel_ms": row["ms"], "plain_ms": row["plain_ms"],
             "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
             "library_ms": row["library_ms"]}
    for extra in ("xla_gather_ms", "library_oom"):
        if extra in row:
            entry[extra] = row[extra]
    return entry


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this "
              "script needs one CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    if sys.argv[1:] == ["--library-yardstick"]:
        return library_yardstick()
    if sys.argv[1:] == ["--b1-f32"]:
        return b1_f32_only()
    if sys.argv[1:] == ["--multirank"]:
        return multirank_only()
    if sys.argv[1:] == ["--serving"]:
        return serving_only()
    if sys.argv[1:] == ["--ops"]:
        return ops_only()
    if sys.argv[1:] == ["--durable"]:
        return durable_only()
    if sys.argv[1:] == ["--fleet"]:
        return fleet_only()
    if sys.argv[1:] == ["--soak"]:
        return soak_only()
    if sys.argv[1:] == ["--tools"]:
        return tools_only()
    if sys.argv[1:] == ["--examples"]:
        return examples_only()
    if sys.argv[1:] == ["--bound-runner"]:
        return bound_runner_only()
    from matrel_tpu_torch import MatrelSession
    from matrel_tpu_torch.ops import (pallas_spgemm, pallas_spmm,
                                      pallas_spmv, spmv_routed)
    from matrel_tpu_torch.utils import cuda_build

    t_start = time.perf_counter()
    card = device_line()
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; {card}")

    t0 = time.perf_counter()
    kernel_modules = (pallas_spmm, pallas_spmv, pallas_spgemm, spmv_routed)
    sources = [cuda_build.CSRC_DIR / m.SOURCE for m in kernel_modules]
    libs = cuda_build.build(sources)          # one nvcc each, in parallel
    for m in kernel_modules:
        m.build()
    log(f"build: {time.perf_counter() - t0:.1f} s -> "
        f"{', '.join(l.name for l in libs)}")
    for lib in libs:
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {lib.stem.split('-')[0]}: {line.strip()}")
    build_checks(libs)

    sess = MatrelSession()            # the default device: cuda
    dev = sess.device
    torch.cuda.reset_peak_memory_stats()
    kernel_phase(sess.mesh)
    spmv_kernel_phase(dev)
    routed_kernel_phase(dev)
    torch.cuda.empty_cache()

    src, dst, A = row5_matrix()
    launches_pr, pr_row = path_row5_pagerank(src, dst)
    l_spmv, l_spmm, queries = path_row5_compute(sess, A)
    b23 = row5_timing(A, dev)
    del src, dst
    l_routed, b8, rplan = path_row5_routed(
        dev, A, b23["spmv_compact"]["library_ms"])
    l_cg, cg_row = path_row5_cg(dev, A, rplan)
    del A, rplan
    torch.cuda.empty_cache()

    spgemm_kernel_phase(sess.mesh)
    torch.cuda.empty_cache()
    b47 = spgemm_timing(sess.mesh)
    l_spgemm, q_spgemm = path_spgemm(sess)
    queries.update(q_spgemm)
    torch.cuda.empty_cache()

    library = run_library_yardstick()
    S, D = row4_inputs(sess)
    row = row4_timing(S, D, library)
    torch.cuda.empty_cache()
    row4_f32 = row4_f32_timing(sess)

    pallas_spmm.LAUNCHES = 0          # the row-4 path starts here
    pallas_spmm.BODY_LAUNCHES.update(dict.fromkeys(
        pallas_spmm.BODY_LAUNCHES, 0))
    launches, q4 = path_row4(sess, S, D)
    b1_bodies = {b: v for b, v in pallas_spmm.BODY_LAUNCHES.items() if v}
    queries.update(q4)
    queries.update(path_row2(sess))
    queries.update(path_row1(sess))
    row3 = path_row3_linreg(sess)
    peak = torch.cuda.max_memory_allocated()
    latency = path_latency(sess, queries)   # after the launch counts
    log(f"peak device memory {peak / 2**30:.3f} GiB (this process; the "
        f"yardstick process: {library.get('peak_gib')} GiB); row-5 "
        f"PageRank {pr_row['round_ms']:.4f} ms per round; row-5 CG "
        f"{cg_row['ms_per_iteration']:.4f} ms per iteration; row 3 "
        f"{row3['high']['s']:.3f} s (high) / {row3['highest']['s']:.3f} s "
        f"(highest); total {time.perf_counter() - t_start:.1f} s")
    if peak > PEAK_LIMIT_BYTES:
        raise AssertionError(f"peak device memory {peak / 2**30:.3f} GiB "
                             f"> {PEAK_LIMIT_BYTES / 2**30:.0f} GiB")
    l_batch = path_core_surface(sess, queries)
    dp_timing(dev)
    del queries, S, D
    ns = path_north_star(dev)         # holds its own peak-memory bound
    rel = path_relational(dev)        # each sub-phase its bound
    l_rel = rel["launches"]
    coo = path_coo_plane(sess)        # each new path its bound
    tuned = path_autotune(sess, coo.pop("plan"))
    l_at = tuned["launches"]
    fused = path_fusion(sess)         # its own bound
    l_fu = fused["launches"]
    torch.cuda.empty_cache()
    served = lock_order_checked("path_serving", lambda: path_serving(sess))
    l_sv = served["launches"]
    torch.cuda.empty_cache()
    ops = path_ops(sess, latency)     # each sub-phase its bound
    l_ops = ops["launches"]
    torch.cuda.empty_cache()
    durable = path_durable(sess, latency)   # each sub-phase its bound
    l_du = durable["launches"]
    torch.cuda.empty_cache()
    fleet = path_fleet(sess)          # each sub-phase its bound
    l_fl = fleet["launches"]
    torch.cuda.empty_cache()
    soaked = path_soak(dev)           # its own bound
    l_sk = soaked["launches"]
    torch.cuda.empty_cache()
    tooled = path_tools(dev)          # its own bound
    l_tl = tooled["launches"]
    torch.cuda.empty_cache()
    exampled = path_examples(dev)     # each example its bound
    l_ex, l_exr = exampled["launches"], exampled["ranks"]
    torch.cuda.empty_cache()
    l_ov = path_overlap(dev)["launches"]    # its own bound
    torch.cuda.empty_cache()
    bound = path_bound_runner(sess)   # its own bound
    l_br = bound["launches"]
    torch.cuda.empty_cache()
    spgemm_library(sess.mesh, b47)    # cuSPARSE SpGEMM beside B4-B7
    torch.cuda.empty_cache()
    l_mr = path_multirank(sess, ns["fro"])["launches"]   # four ranks
    for name, err in rel["max_abs_err"].items():   # the worst of both shapes
        b47[name] = dict(b47[name], max_abs_err=max(
            b47[name]["max_abs_err"], err))

    l_coo = coo["launches"]
    for part in (l_batch["spmm_bodies"], coo["bsp"]["bodies"],
                 fused["spmm_bodies"], served["spmm_bodies"],
                 ops["spmm_bodies"], durable["spmm_bodies"],
                 fleet["spmm_bodies"], soaked["spmm_bodies"],
                 tooled["spmm_bodies"], exampled["spmm_bodies"],
                 l_exr["b1_bodies"], bound["spmm_bodies"],
                 {"wgmma": l_mr["spmm_blocksparse"]}):
        for b, v in part.items():
            b1_bodies[b] = b1_bodies.get(b, 0) + v
    kernels = [
        dict(kernel_entry("spmm_blocksparse", pallas_spmm.SOURCE,
                          "matrel_tpu/ops/pallas_spmm.py:31",
                          launches + l_batch["spmm_blocksparse"]
                          + l_coo["spmm_blocksparse"]
                          + l_fu["spmm_blocksparse"]
                          + l_sv["spmm_blocksparse"]
                          + l_ops["spmm_blocksparse"]
                          + l_du["spmm_blocksparse"]
                          + l_fl["spmm_blocksparse"]
                          + l_sk["spmm_blocksparse"]
                          + l_tl["spmm_blocksparse"]
                          + l_ex["spmm_blocksparse"]
                          + l_exr["spmm_blocksparse"]
                          + l_ov["spmm_blocksparse"]
                          + l_br["spmm_blocksparse"]
                          + l_mr["spmm_blocksparse"], row),
             launches_by_body=b1_bodies, f32_one_column=coo["b1_f32_m1"],
             f32_row4=row4_f32,
             launches_on_ranks=l_mr["spmm_blocksparse"],
             launches_in_soak=l_sk["spmm_blocksparse"],
             launches_in_tools=l_tl["spmm_blocksparse"],
             launches_in_examples=l_ex["spmm_blocksparse"],
             launches_on_example_ranks=l_exr["spmm_blocksparse"],
             launches_in_overlap=l_ov["spmm_blocksparse"],
             launches_through_bound_runner=l_br["spmm_blocksparse"]),
        dict(kernel_entry("spmv_compact", pallas_spmv.SOURCE,
                          "matrel_tpu/ops/pallas_spmv.py:50",
                          launches_pr + l_spmv + l_batch["spmv_compact"]
                          + l_rel["spmv_compact"] + l_coo["spmv_compact"]
                          + l_at["spmv_compact"] + l_fu["spmv_compact"]
                          + l_sv["spmv_compact"] + l_ops["spmv_compact"]
                          + l_du["spmv_compact"] + l_fl["spmv_compact"]
                          + l_sk["spmv_compact"] + l_tl["spmv_compact"]
                          + l_ex["spmv_compact"] + l_exr["spmv_compact"]
                          + l_ov["spmv_compact"] + l_br["spmv_compact"]
                          + l_mr["spmv_compact"],
                          b23["spmv_compact"]),
             launches_on_ranks=l_mr["spmv_compact"],
             launches_in_soak=l_sk["spmv_compact"],
             launches_in_tools=l_tl["spmv_compact"],
             launches_in_examples=l_ex["spmv_compact"],
             launches_on_example_ranks=l_exr["spmv_compact"],
             launches_in_overlap=l_ov["spmv_compact"],
             launches_through_bound_runner=l_br["spmv_compact"]),
        dict(kernel_entry("spmm_compact", pallas_spmv.SOURCE,
                          "matrel_tpu/ops/pallas_spmv.py:334",
                          l_spmm + l_at["spmm_compact"]
                          + l_sk["spmm_compact"] + l_tl["spmm_compact"]
                          + l_ex["spmm_compact"] + l_ov["spmm_compact"]
                          + l_br["spmm_compact"] + l_mr["spmm_compact"],
                          b23["spmm_compact"]),
             launches_on_ranks=l_mr["spmm_compact"],
             launches_in_soak=l_sk["spmm_compact"],
             launches_in_tools=l_tl["spmm_compact"],
             launches_in_examples=l_ex["spmm_compact"]),
    ] + [dict(kernel_entry(name, pallas_spgemm.SOURCE, SPGEMM_REPLACES[name],
                           l_spgemm[name] + l_rel[name] + l_at[name]
                           + l_fu[name] + l_sv[name] + l_ops.get(name, 0)
                           + l_du.get(name, 0) + l_fl.get(name, 0)
                           + l_sk[name] + l_tl[name] + l_ex[name]
                           + l_ov[name] + l_br[name], b47[name]),
              launches_in_soak=l_sk[name], launches_in_tools=l_tl[name],
              launches_in_examples=l_ex[name])
         for name in SPGEMM_REPLACES]
    kernels.append(dict(
        kernel_entry("spmv_routed", spmv_routed.SOURCE,
                     "matrel_tpu/ops/spmv_routed.py:232",
                     l_routed + l_cg + l_sk["spmv_routed"]
                     + l_tl["spmv_routed"] + l_ex["spmv_routed"]
                     + l_ov["spmv_routed"] + l_br["spmv_routed"], b8[3]),
        also_replaces="matrel_tpu/ops/spmv_routed.py:261",
        launches_in_soak=l_sk["spmv_routed"],
        launches_in_tools=l_tl["spmv_routed"],
        launches_in_examples=l_ex["spmv_routed"]))
    if sum(b1_bodies.values()) != kernels[0]["launches"]:
        raise AssertionError(f"B1 launches by body {b1_bodies} do not add "
                             f"up to its {kernels[0]['launches']} launches")
    missing = [k["name"] for k in kernels if k["launches"] < 1]
    if missing:
        raise AssertionError(f"no launch on a path for {missing}")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
