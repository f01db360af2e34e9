#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one CUDA GPU: fused BFS, then
SpMV (fused and windowed) with PageRank and HITS on it, then SSSP (fused
and windowed) and k-core, then the operator layer with BFS and SSSP
adaptive and SpMV pull and push on a directed graph, then triangle
counting, the intersection operator and PageRank fused, then graph
coloring (jp and spec) with PageRank and HITS generic on a directed graph,
then BFS hybrid, phased and the timed auto with k-core adaptive, then
betweenness centrality and personalized PageRank, then the minimum
spanning forest, geolocation and SpGEMM, then the single-chip harness: the
leftover graph, io, runtime and operator modules and the
essentials-tpu-torch command line (cli.main), then the parallel layer
(dist_bfs, dist_sssp, dist_pagerank) on a one-rank NCCL group.

Run from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py                   # every phase
    python3 chip_smoke.py --only color,tc   # phases 1-2 and these groups
    python3 chip_smoke.py --only harness    # the harness and the CLI
    python3 chip_smoke.py --only parallel   # the dist_* supersteps

The groups are bfs (phases 3-5), spmv (6-8), sssp (9-11), operators
(12-14), tc (15-17), color (18-20), variants (21-23), bcppr (24-25), mst
(26-27), geo (28-29), spgemm (30-31), harness (32-33) and parallel
(34-35); phases 1-2 always run, and the groups run in this order.
variants, bcppr, mst, geo, spgemm, harness and parallel add no kernel:
they run the kernels of the groups before them on new paths, so
with --only they add no entry to the JSON line, and their launches count
in the entries of the groups chosen with them. Each graph is built by the first group that
needs it and kept for the others. With --only, the JSON line lists the
chosen groups' kernels and their launches on the chosen groups' paths.

Phases, each printing its own lines and its seconds; the first failure
raises and exits non-zero:

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: compile every csrc/*.cu with nvcc for sm_90a (one nvcc per
   source, in parallel) into one library and load it;
3. kernels: every level of a BFS, in the int32 and the int8 form, on rmat12,
   rmat18 and a degree-balanced directed graph (balanced_coo), each kernel
   against its plain PyTorch version on the same tensors, which must agree
   exactly; bfs_level under the card's choice of push or pull per level,
   under each forced (push, pull) and in the pull's global tier (BFS_CHECKS);
   bfs_predecessors (its first walk and its range walk, csrc/first_hit.cuh)
   at the int32 distances of a fused search from each of the 16
   highest-degree sources of rmat18, against plain exactly and a second
   launch bitwise, with PRED_SPLIT and what each search's first walk lists
   printed; both predecessor kernels (pred_cases) on a graph
   whose hub has its only qualifying in-edge in the last range of its
   segment, with multi-edges and zero-weight self-loops (pred_stress_coo),
   on kcore_stress_coo's hub, multi-edges and self-loops and on the
   degree-balanced directed graph, each at n_edges E, E - 1 and E -
   PRED_CUT (and, for SSSP, with the padding vertex given distance 1,
   whose zero-weight padding self-loops the cut must drop); the range walk
   once a call, and the first walk and the range walk one device kernel
   each per call (torch.profiler);
4. main path: bfs.run(variant="fused") and bfs.run(variant="fused8",
   max_iterations=64) from the 16 highest-degree sources of the undirected
   RMAT graph of bench.py (scale 18, edge factor 16, seed 1), held against
   the host cpu_reference and a host check of the predecessors; the launch
   counters must show that every kernel ran on this path, each predecessor
   wrapper's range walk once a call (check_range_walks, on every main path);
5. times on CUDA events: BFS MTEPS per variant, and each kernel against its
   plain version at rmat18 shapes: bfs_predecessors at each of the 16
   searches (wall, device, plain; mean and max; the first-hit bound and the
   dense bound of pred_work), the fused bfs.run with and without
   predecessors (wall and device per search); collapse_levels in both
   forms at the search's last levels: wall (back to back), device, plain,
   bound, and index_select at the non-empty starts (the gather alone);
   bfs_level level by level
   from its saved state, wall and device time (its four device kernels),
   the form the card took, the device time of each form forced, and the
   level's bound
   (bfs_level_work: the work the level must do) beside the dense bound
   (every csc_src slot); then torch.profiler's device time by kernel over
   the main path, beside its wall time;
6. SpMV kernels: on bench.py's SpMV graph (directed, weighted RMAT, scale
   18, edge factor 16, seed 3) and on its scale-12 sibling, every instance
   of spmv_rows (messages mul, none; replaces fused_spmv._pallas_spmv_chain)
   and spmv_slabs (mul, add, none by sum, min, one launch per product;
   replaces windowed_spmv.windowed_pipeline) against its plain version on
   the same tensors: exact under min, |k - p| <= 1e-5 |p| + 1e-6 under
   sum; a second launch must give the same bits; and spmv_rows likewise,
   and within a relative error of 1e-4, at the inputs PageRank and HITS
   give it on the undirected BFS graph, and on a scale-15 graph with hub
   rows of 82K and 6K edges and a run of 6,144 empty rows (ROWS_HUBS,
   ROWS_EMPTY_RUN); every spmv_rows result also within the sum tolerance
   of the float64 host product;
7. SpMV main path, four paths, each with the launch counters set to 0
   just before it and read just after, which must show exactly the
   launches the path makes: spmv.run(variant="fused") and spmv.run(
   variant="windowed") on the scale-18 SpMV graph, held against the
   float64 cpu_reference and each other to the sum tolerance; pr.run and
   hits.run (variant "spmv") on the undirected BFS graph, held against
   their host references to tests/test_spmv_ports.py's tolerances and to
   tighter ones (HOST_TOLS);
8. SpMV times on CUDA events: ms and GB/s (bench.py's 12 B/edge model) per
   variant at scales 18 and 20 (rmat20, seed 3), each SpMV kernel against
   its plain version at scale 18, PageRank and HITS ms per iteration
   (median and spread of CYCLES runs); then
   torch.profiler's device-busy share over ten spmv.run calls of each
   variant at each scale (after a warm-up step inside the profiler, and
   with the launches the trace saw against those made); spmv_slabs in all
   six forms against its plain version at scale 20 (spmv_rows too, and
   against the host), and the device time per launch of spmv_rows<mul>
   and spmv_slabs<mul,sum> from torch.profiler at scales 18 and 20 beside
   torch.mv's (spmv_rows also at PageRank's product on the undirected BFS
   graph), spmv_slabs also with every column 0 (the time without the
   scattered x gathers);
9. SSSP and k-core kernels: on the weighted undirected RMAT graphs of
   scales 12 and 18 (edge factor 16, seed 1), every sweep of one SSSP
   search (sssp_sweep; replaces fused_sssp.fused_sssp_superstep; each
   sweep's output buffer holding the sweep before's distances, as in a
   search), the collapse (collapse_starts), the predecessors
   (sssp_predecessors) and one k-core run (expand_segments for the initial
   degrees, every wave's kcore_level_wave or kcore_cascade_wave with its
   scalars and candidate set, then collapse_starts), each kernel
   against its plain version from the same input, exactly, and against a
   second launch, bitwise; all of it also on a graph with a hub,
   multi-edges and self-loops (kcore_stress_coo) and on a degree-balanced
   directed graph (balanced_coo: every in-degree equal to its out-degree,
   the edges not symmetric, a hub on 3,000 directed triangles), whose
   kcore.run is held against the host peeling and sssp.run (auto: fused)
   against a float64 Dijkstra; sssp_predecessors at the distances of a
   fused search from each of the 8 highest-degree sources of weighted
   rmat18, as in phase 3;
10. SSSP and k-core main path on the suite's graph gen:rmat20x16 (scale
   20, edge factor 16, seed 1, undirected, weighted). First its kernels at
   that graph's shapes, each against its plain version and a second launch
   as in phase 9: the whole of phase 9's search and peeling, every sweep
   of a windowed search (spmv_slabs<add,min> from states holding +inf),
   each sweep's wall and device time beside its bound, and every level of
   a BFS in both forms, from the
   highest-degree vertex; expand_segments and collapse_starts on
   starts_cases (a hub of 3.5 expand tiles, an empty run across a tile
   edge, segment ends on a tile's last and first places, n and Vp not
   multiples of 4, offsets at a 4-byte offset, n = 0; the collapse at no
   source, an empty segment's, the hub's and the last vertex's);
   sssp_sweep three device kernels a call (the
   dense pass, the push and the update) on a search's first and heaviest
   sweep, as torch.profiler sees them. Then sssp.run(variant=
   "fused") and sssp.run(variant="windowed") from the 8 highest-degree
   sources and one kcore.run (a level wave three device kernels a call,
   the minimum, the peel and the push, a cascade two, the mark and the
   push, as torch.profiler sees them on the first and the last wave of
   each kind: a wave with no whole profiler window is not measured, a
   kind measured on none fails), each run with the launch counters set to 0
   just before it and read just after, which must show exactly the
   launches it makes; fused and windowed bitwise equal with equal sweep
   counts; 2 sources against a float64 host Dijkstra (rtol 1e-5, the reach
   set exact); every predecessor checked on the host; the core numbers
   against the host peeling; and one bfs.run(variant="fused") on the same
   graph against cpu_reference. Sweep and level counts are printed beside
   the TPU history (TPU_HISTORY), which is not a gate;
11. SSSP and k-core times on CUDA events: ms per search and relaxations
   per second per variant, k-core ms and waves at scale 20, and each
   wave's time (kcore_level_wave or kcore_cascade_wave) beside the
   vertices alive before it, the vertices it peels and their edges; over
   the run's waves of each kind the median and spread of the wall time,
   the plain version's, the device time per wave (torch.profiler, each
   wave's kernels), the per-wave and per-run bounds; sssp_sweep sweep
   by sweep over one fused search from the highest-degree vertex at scale
   20 (each call from its saved state): wall, device (its three kernels)
   and plain time, the slots it pushes and its bound (sssp_sweep_bytes),
   per sweep and per search; the same summed over a search at scale 18;
   the other SSSP and k-core kernels against their plain versions at scale
   18 (sssp_predecessors as bfs_predecessors in phase 5); collapse_starts
   at a fused search's final state and expand_segments at init_deg_exp's
   input, at weighted rmat18 and gen:rmat20x16: wall (back to back),
   device (torch.profiler), plain, bound, and the PyTorch call beside
   (index_select at the non-empty starts, the gather alone;
   torch.repeat_interleave); both predecessor
   kernels at gen:rmat20x16 from its highest-degree vertex; sssp.run
   (auto), its fused search alone, and bfs.run fused with and without
   predecessors, wall and device per search from the 8 sources, at
   weighted rmat18 and gen:rmat20x16;
   torch.profiler's device-busy share over each of the three paths (after
   a warm-up step);
12. operator kernels (scan, gather_payloads, segment_reduce,
   advance_count; replace scan_kernels.scan_1d/segmented_scan_1d, the
   cube_router/permute routes, segment.combine_by_offsets and
   cube_router.apply_cube_chain_n) against their plain versions on the
   directed weighted RMAT graphs of seed 3 at scales 12, 18 and 20 (the
   graph of phase 8): scan under every op on int32 and float32, plain and
   segmented; gather_payloads with 1-4 payloads of unequal lengths,
   packed and unpacked, through the whole index, a ragged count and a view
   at an odd offset; segment_reduce under its
   five ops on both dtypes over the CSC and the CSR offsets, and (once)
   over the offsets of the spmv_rows stress graph (hubs of 82,001 and 6,139
   slots, 6,144 empty segments), over offsets that start past 0 and with
   the values a view at a 4-byte offset (check_reduce_shapes);
   advance_count in both tiers (shared, and global under a cap of
   COUNT_GLOBAL_CAP bytes) under empty, full and seeded frontiers; integers
   exact, floats within SCAN_RTOL / SUM_RTOL, and every kernel bitwise
   equal to a second launch; then scan alone at n = 1, a tile - 1, a
   tile, a tile + 1 and SCAN_MANY tiles with flags absent, sparse, at every
   position and only at position 0, every op on both types (floats adds
   the same bits over three calls, everything else bitwise equal to
   plain), an unsegmented float add at SCAN_BIG = 2^26 elements, and one
   device launch (scan_kernel) per call under every op, seen by
   torch.profiler (a form whose every profiler window lost device
   activities is reported as not measured; none measured fails);
13. the adaptive main path on that rmat20 graph, which has no symmetric
   layout: bfs.run and sssp.run (variant "adaptive") from its 8 highest
   out-degree sources, each with the launch counters set to 0 just before
   it and read just after, which must show exactly the launches its tiers
   make; BFS distances equal cpu_reference and predecessors the host's
   smallest-id rule; SSSP within rtol 1e-5 of a float64 Dijkstra for 2
   sources (reach set exact) and predecessors the host's; spmv.run(variant
   "pull") and ("push") once each, held against float64; the steps each
   tier took; both predecessor kernels at the distances of every adaptive
   search (the CSC offsets are not the CSR offsets) and at pred_cases'
   cuts, against plain and a second launch;
14. adaptive times on CUDA events: ms per search, MTEPS and relaxations
   per second, torch.profiler's device idle share over each path, and each
   operator kernel's time per launch at the path's shapes beside its plain
   version, its bound and a PyTorch call computing the same function, and
   advance_count's and torch.mv's device time per call from torch.profiler
   (both tiers of advance_count), scan's and torch.cumsum's at
   compact_frontier's cumsum, gather_payloads' packed and unpacked
   beside torch.index_select's of the payloads side by side, and
   segment_reduce's beside torch.segment_reduce's: MIN at the dense SSSP
   round, a float SUM at PageRank generic's shape (the CSC offsets);
15. the triangle-counting and fill kernels against their plain versions,
   integers exact and a second launch bitwise equal: bitmap_intersect_counts
   (replaces bitmap_intersect.bitmap_intersect_counts), witness on and off,
   over every oriented edge of undirected rmat12 and of the suite's
   gen:rmat17x16, and over unsorted pairs with a hub u and pads among them
   (hub_pairs_inputs); segment_broadcast_total (int32 and float32 S),
   suffix_fill_update and fused_route_or (replace fused_bfs.py's) at every
   level of one search on the BFS graphs rmat12 and rmat18 and on
   gen:rmat20x16, with the 5-pass level they make (route OR, segmented sum
   scan, fill and update) equal to bfs_level<int32> at segment starts,
   level by level; then the fills and the route OR alone at n = 1, a tile
   - 1, a tile, a tile + 1, FILL_LONG + 3 tiles and SCAN_MANY scan tiles
   with flags sparse, at every position, only at position 0 and with one
   segment across FILL_LONG = 42 tiles (the route OR under an `it` with
   some hits, none, every position hit and the INT32_MAX sentinel), and
   one device launch per call of each under those four flag sets
   (torch.profiler; as in phase 12, a kernel with no form measured
   fails);
16. their main paths, each with the launch counters set to 0 just before it
   and read just after, which must show exactly the launches it makes:
   tc.run (auto, which must choose bitmap) on gen:rmat17x16 against
   cpu_reference_total and a row-blocked scipy count of each vertex's
   triangles, and tc.run(variant="shift") there; shift on gen:rmat20x16
   (phase 10's graph), whose total must be 424,267,437
   (benchmarks/PARITY.md:58); dense, bitmap and sorted on rmat13 (V =
   8192) against each other and cpu_reference; intersection_counts with
   witnesses and jaccard on 4,096 seeded pairs (endpoints of random edges)
   on gen:rmat17x16 (all rows) and gen:rmat20x16 (chunked), against host
   sets; one BFS on five_pass_superstep from rmat18's top source against
   bfs.run; pr.run(variant="fused") on the undirected rmat18 graph against
   the host (HOST_TOLS) and variant "spmv";
17. their times on CUDA events: TC ms per run and triangles per second for
   bitmap at rmat17, shift at rmat20 and dense at rmat13; PageRank fused and
   spmv ms per iteration; torch.profiler's device idle share over TC bitmap
   and shift runs at rmat17 and a PageRank fused run (taken again until
   it sees all of its launches, at most three times); each new kernel per
   launch beside its plain version (bitmap_intersect_counts also with its
   device time, witness on and off, and beside three bounds),
   its bound and a PyTorch call computing the same function where one
   exists, wall and device time; scan with flags (segmented float add),
   segment_broadcast_total (beside torch.repeat_interleave) and
   gather_payloads (beside torch.index_select) at PageRank fused's shape;
   scan without flags as a float add at 2^26 elements (beside
   torch.cumsum) and as the int32 running max of TC shift's largest chunk
   at gen:rmat20x16 (beside torch.cummax);
18. segment_minmax (replaces scan_kernels.segmented_minmax_1d) against its
   plain version exactly and a second launch bitwise, over JP's per-edge
   priorities for 1, 3 and 8 payloads under three active masks (all true,
   a seeded 30%, the uncolored mask after one JP round) on rmat12 and
   rmat18 (the BFS graphs) and gen:rmat20x16 (phase 10's graph); then on
   its stress case (minmax_stress_inputs: one segment across more than
   MINMAX_LONG_TILES tiles, segment ends at every offset of a tile, a run
   of MINMAX_EMPTY_RUN empty segments, all-inactive segments, offsets
   from 37, payloads and flags as views at odd element offsets), and two
   device launches per call (segment_split_kernel, then
   segment_minmax_kernel) for 1, 3 and 8 payloads (as in phase 12, a
   kernel with no form measured fails); and
   bitmap_intersect_counts at 12,288-word rows (48 KiB, whose non-zero
   words the kernel lists in many passes), witness on and off;
19. their main path, each run with the launch counters set to 0 just
   before it and read just after, which must show exactly the launches
   its rounds' tiers make: color.run jp, spec and auto (which must be
   spec, the spray being on) on gen:rmat20x16, each a proper coloring
   (validate 0); jp and spec on rmat12 (auto jp, the spray off) bitwise
   equal in colors and rounds to a run on a CPU copy of the graph; pr.run
   and hits.run auto (generic) on the directed rmat20 of phase 8, held
   against the host references (HOST_TOLS);
20. times on CUDA events: color jp and spec ms per run at gen:rmat20x16
   with rounds and distinct colors, torch.profiler's idle share over one
   run of each, beside the TPU's history (TPU_COLOR_HISTORY, not a gate);
   PageRank and HITS generic ms per iteration; segment_minmax per launch
   at m = 8, wall and device, under the first round's mask (every real
   edge active) and the uncolored mask after one round, beside its plain
   version, its bound, two torch.segment_reduce calls (max and min)
   computing the same function and the 16 segment_reduce launches it
   replaces, and on the largest segment alone;
21. BFS hybrid and phased (bfs_level<int32>, collapse_levels<int32>,
   expand_segments, scan, bfs_predecessors on new paths) from the 16
   highest-degree sources of rmat18 at MAX_IT = 64 (the spray on by
   itself: E > 2^21) and from the top vertex of gen:rmat20x16, each with
   the launch counters set to 0 just before it and read just after, which
   must show exactly the launches its spray and dense levels, expands,
   collapses and compactions make (expect_bfs_variant); distances,
   predecessors and levels equal to fused's, fused's from CHECKED_SOURCES
   equal to cpu_reference; once with the spray gate closed on each graph
   (spray_gate); the levels each search ran as spray and as dense; then the timed auto: each
   candidate's probed time and the choice, and a second call that probes
   nothing and launches exactly what its choice makes;
22. k-core adaptive (advance_count, scan) on the directed rmat20 seed 3
   (auto: no symmetric layout), the core numbers equal to cpu_reference,
   and on gen:rmat20x16, equal to fused's; each with spray_override left
   at None and once False; the waves per branch; launches exact;
23. times on CUDA events: BFS fused, fused8, hybrid and phased ms per
   search and MTEPS over the 16 rmat18 sources (median of CYCLES cycles),
   k-core fused and adaptive ms per run and waves at gen:rmat20x16,
   each with torch.profiler's busy and idle share;
24. BC spmv (spmv_rows) from BC_SOURCES of rmat18's highest-degree
   vertices and BC generic (gather_payloads, segment_reduce) from the top
   vertex of the directed rmat20, each within bc_bound() of the largest
   value of the float64 host Brandes; run_all over rmat18's BC_ALL_SOURCES
   highest-degree vertices against the sum of the single-source runs, and
   over the first BC_ALL_HOST against the host, within bc_bound of the
   sources summed; PPR run from rmat18's top vertex and run_batch over
   PPR_SEEDS seeds (gather_payloads, segment_reduce) within ppr_bound of
   the float64 host; each with launches exact;
25. times on CUDA events: ms per BC source (spmv, generic), per run_all of
   32 sources and per PPR seed, each with torch.profiler's busy and idle
   share;
26. mst.run (expand_segments, gather_payloads, segment_reduce: 3, 1 and 4
   a round) on gen:rmat20x16, kron_s16 and road_512x512, launches exact:
   each a spanning forest (V - c edges, as many components as the graph)
   whose chosen weights, summed in float64, lie within MST_FOREST_RTOL
   (1e-9) of the float64 host forest's (the minimum forest's weight is
   unique) and whose float32 total lies within mst_bound (ceil(log2 k)
   2^-24 of the total for k edges, a tree sum's rounding) of it,
   kron_s16's host total 631,663.8 (benchmarks/PARITY.md); on kron_s16 and road_512x512 in_mst and the
   rounds bit for bit equal to a run on a CPU copy of the graph;
27. mst ms per run and per round (median of KCORE_CYCLES), rounds beside
   the TPU history (TPU_MST_ROUNDS, not a gate), torch.profiler's busy and
   idle share;
28. geo.run (gather_payloads once and segment_reduce three times an
   iteration) on gen:rmat20x16 and chesapeake from the suite's input
   (seed 7, 20% located, 10 iterations), every located vertex within
   GEO_DEG (1.5e-3 degrees, longitudes around the circle) of the float64
   host or, where larger, of the host's own bound on float32 rounding
   (geo.cpu_reference's error_bound), NaN patterns equal; then
   spatial_median (twice and four times a sweep) for 1 and
   MEDIAN_ITERATIONS sweeps from its positions, each vertex's Weiszfeld
   objective within MEDIAN_RTOL of the float64 host's and their sum
   within MEDIAN_SUM_RTOL, NaN patterns equal; launches exact;
29. geo and spatial_median ms per run (median of KCORE_CYCLES) with
   torch.profiler's busy and idle share;
30. spgemm.run, the static plan (gather_payloads twice, segment_reduce
   once), of A @ A on uniform_65536 and road_512x512; run_chunked on
   uniform_65536 (CHUNK_PRODUCTS products and CHUNK_EDGES A edges a chunk,
   which splits its longest rows: the merge spans are not empty),
   resident and streamed (per device batch: expand_segments 3,
   gather_payloads 2, scan 1, segment_reduce 1); launches exact; C's
   structure equal to the vectorised host Gustavson's (the chunked C's to
   the static C's) and values within SPGEMM_RTOL of float64; the host
   symbolic phases' seconds;
31. the static numeric phase's ms and products per second (CUDA events)
   beside its bound, the chunked numeric phase's resident and streamed
   (host clock, with the host merge), each with torch.profiler's busy and
   idle share;
32. the harness's modules on the card (harness_checks): the native .mtx
   parser (built with the host C++ compiler) against the NumPy parser on
   the seven datasets, the same entries; graph.convert.offsets_to_indices
   at gen:rmat20x16's row offsets (and at OFFSET_CASES) against its plain
   version on a CPU copy, exactly, one expand_segments launch a call;
   ops.advance_edges (three gather_payloads launches: the route into CSC
   order, the destination values, the route back through csc_rank),
   filter_frontier, for_each_vertex / for_each_edge and uniquify at
   weighted rmat18, each equal to the same call on a CPU copy; the
   degree analytics against NumPy (the histogram exactly, by bit
   lengths; the mean and standard deviation within ANALYTICS_RTOL of
   float64); runtime.trace around one fused BFS, whose Chrome trace must
   hold a bfs_level kernel event;
33. the command-line driver in process (cli.main), each call with the
   launch counters set to 0 just before it and read just after (some
   kernel must have launched): the 12 algorithms other than SpGEMM on
   datasets/kron_s16.mtx --undirected --validate --json --runs
   CLI_RUNS (bfs, sssp, ppr and bc from its highest-degree vertex:
   vertex 0 is isolated) and spgemm on datasets/uniform_65536.mtx
   (kron_s16's A @ A is 1.25e9 products), each exiting 0 (validated
   against its host reference) with backend "cuda"; their mean ms and
   MTEPS beside the card's name and power limit; then the run_all
   example on datasets/chesapeake.mtx;
34. the parallel layer on a one-rank NCCL group (multihost.initialize,
   num_processes 1; NCCL refuses two ranks on one card, so P > 1 is held
   on the CPU over gloo by tests/test_torch_parallel.py): one partition of
   gen:rmat20x16 per exchange mode (all_gather, boundary), each built with
   overlap=True, then dist_bfs, dist_sssp and dist_pagerank (tol 0,
   PR_ITERATIONS iterations) in both modes, with and without overlap, from
   the highest-degree vertex, each gathered by multihost.gather_global and
   run with the launch counters set to 0 just before it and read just
   after: expand_segments, gather_payloads and segment_reduce once a
   superstep (gather_payloads once more where SSSP moves its weights
   without overlap), nothing else, BFS levels + 1 supersteps and PageRank
   PR_ITERATIONS; BFS equal to cpu_reference and to the fused single-chip
   BFS, SSSP within rtol 1e-5 of a float64 Dijkstra (the reach set exact)
   and bit for bit equal across the four runs, PageRank within PR_RTOL /
   PR_ATOL_V / V of a float64 power iteration with the JAX package's
   formula (host_pagerank) and summing to 1 within PR_SUM_TOL; pads
   unreached (0 for PageRank); then a planted fault, two route_idx
   entries swapped between low-ranked vertices (plant_route_swap), which
   the PageRank check must refuse;
35. per run and per superstep on CUDA events (median of CYCLES): ms,
   supersteps and MTEPS (E x supersteps, and E over the run) for each of
   phase 34's twelve paths, each with torch.profiler's busy and idle
   share; per mode the host partition seconds and comm_values_per_step.

Every kernel's bound is the least time an H100 could take for its work:
the larger of the bytes it must move (each input element it needs read
once, each output written once) over the memory rate and its float
operations over 67 TFLOP/s, computed from the shapes of the timed call.
The memory rate is 3.35 TB/s (HBM) where one launch's bytes exceed the
50 MiB L2, and the L2 rate where they fit, since the timed calls run back
to back on the same operands. The L2 rate is measured in phase 1 of the
same run (l2_rate): the extra bytes of a device-to-device copy of 12 MiB
over one of 4 MiB, each repeated on the same buffers, over its extra time
(never below 3.35 TB/s). bitmap_intersect_counts' bound reads each
distinct u row once and each 32-byte sector of B[v] under a non-zero word
of B[u] once (bitmap_work), and counts an AND and a popcount per such
word and pair at the float32 rate; its JSON entry also gives
bound_per_pair_sectors_ms (a sector per such word and pair),
bound_named_rows_ms (each named row once, every word of each pair ANDed:
the earlier work model) and bound_streaming_ms (B[v] read once per pair:
the TPU kernel's model). sssp_sweep's bound reads each non-empty start's
sector once per buffer, writes the sectors of the starts that change, and
reads the CSR column and weight of each slot that the sweep must relax
(the rows of the vertices that changed in the sweep before).
bfs_level's bound, per level of the timed search (bfs_level_work), reads
the offsets and each non-empty start's sector once, writes and reads the
two bitmaps once, reads the smaller of the push's col words (the
frontier's out-slots) and the pull's csc_src words (each unreached
segment up to its first frontier source), and writes the sectors of the
starts it reaches; its JSON entry also gives bound_dense_ms, the model
of the earlier pull-only kernel (every csc_src slot every level). The
predecessor kernels' bound (pred_work) reads the offsets, dist and pred
once each and csc_src (and, for SSSP, w) up to each reached vertex's
first qualifying slot; their bound_dense_ms reads every real slot.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import subprocess
import time

import numpy as np
import torch

SCALE, EDGE_FACTOR, SEED = 18, 16, 1
INT32_MAX = 2**31 - 1  # BFS: unreached; the predecessors kernels take it
RUNS = 16              # sources: the highest-degree vertices
MAX_IT = 64            # as bench.py
CYCLES = 7             # timed cycles; the median is reported
CHECKED_SOURCES = 4    # sources whose distances are held against cpu_reference

SPMV_SEED = 3          # bench.py's SpMV graph: directed, weighted, seed 3
SPMV_SCALES = (12, 18)  # kernel checks; 18 is the main path
SPMV_TIME_SCALE = 20   # times only
SPMV_REPS = 20         # products per timed cycle
# spmv_rows' stress graph: rmat15 seed 3 with a run of empty rows and hub
# rows of (row, spmv_rows tiles) appended
ROWS_STRESS_SCALE = 15
ROWS_EMPTY_FROM, ROWS_EMPTY_RUN = 10_000, 6_144   # 3 tiles of row ends
ROWS_HUBS = ((7, 40.04), (20_000, 2.998))
PROFILED_RUNS = 10     # spmv.run calls per variant under the profiler
# rows; slabs; gather + segment reduce
KERNELS_PER_PRODUCT = {"fused": 1, "windowed": 1, "pull": 2, "push": 2}
SUM_RTOL, SUM_ATOL = 1e-5, 1e-6   # |k - p| <= SUM_RTOL |p| + SUM_ATOL
PR_HITS_MAX_REL = 1e-4  # spmv_rows at PageRank's and HITS's inputs
BYTES_PER_EDGE = 12.0  # bench.py's SpMV model: value + column + x gather
# (atol, rtol) against the host references: tests/test_spmv_ports.py's,
# then tighter ones (PageRank's mean rank at rmat18 is 1/V = 3.8e-6, so
# atol 1e-6 alone would let most ranks be off by a quarter)
HOST_TOLS = {"pr": ((1e-6, 1e-4), (1e-9, 1e-4)),
             "hits": ((1e-4, 1e-3), (1e-7, 1e-4))}

SSSP_SCALES = (12, 18)  # kernel checks: weighted undirected, seed 1
MAIN_SCALE = 20        # gen:rmat20x16, benchmarks/run_benchmarks.py:36-39
SSSP_RUNS = 8          # sources: the highest-degree vertices
DIJKSTRA_SOURCES = 2   # sources held against the float64 host Dijkstra
SSSP_RTOL = 1e-5
KCORE_CYCLES = 3       # timed k-core runs; the median is reported
# sweep and level counts at rmat20 recorded on the TPU (ROADMAP queue 1):
# printed beside the port's, not a gate
TPU_HISTORY = {"sssp": 9, "kcore": 814, "bfs": 6}

OP_SCALES = (12, 18)   # operator kernel checks, besides the rmat20 graph
ADAPTIVE_RUNS = 8      # sources: the highest out-degree vertices
SCAN_RTOL = 1e-4       # float add over a whole array: a float32 running sum
SCAN_MANY = 300        # tiles of the scan sweep's largest size (> a group)
SCAN_BIG = 1 << 26     # an unsegmented float add: the longest look-back
FILL_LONG = 42         # fill tiles one segment spans in the fill sweep
PROFILED_CALLS = 4     # calls a launch check records
COUNT_GLOBAL_CAP = 0   # advance_count's shared-tier cap that forces "global"
GATHER_EXTRA = (0, 5, 9, 130)   # gather_payloads' payloads: Vp + these words
REDUCE_CUT = 1000      # segment_reduce over offsets[REDUCE_CUT:], from past 0
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
L2_BYTES = 50 * 2 ** 20     # H100 SXM L2 cache
# bytes per second by where a launch's operands live: HBM is the data
# sheet's; L2 is measured in phase 1 (l2_rate)
MEMORY_RATE = {"HBM": 3.35e12, "L2": None}
L2_PROBE_MIB = (4, 12)  # the sizes of the two copies that l2_rate compares
L2_COPIES = 50

# bfs_level's checks: (form, shared-memory cap of the pull): the card's
# choice per level, push and pull forced, and the pull's global tier
BFS_CHECKS = (("device", None), ("push", None), ("pull", None),
              ("device", COUNT_GLOBAL_CAP))
BFS_FORMS_TIMED = ("device", "push", "pull")   # kernels.BFS_FORMS
TC_SCALE = 17          # gen:rmat17x16: the bitmap path's graph
TC_DENSE_SCALE = 13    # V = 8192, the dense path's largest
TC_RMAT20_TOTAL = 424_267_437   # benchmarks/PARITY.md:58, scipy masked A^2
TC_RMAT17_TOTAL = 36_033_712    # gen:rmat17x16, tc.cpu_reference_total
PAIRS = 4096           # intersection queries per graph
PAIR_SEED = 5
TC_CYCLES = 3          # timed runs of the larger TC paths; median reported
COLOR_SEED = 6         # the seeded active mask and the wide bitmap
COLOR_PAYLOADS = (1, 3, 8)   # segment_minmax payload counts checked
# segment_minmax's stress case (minmax_stress_inputs)
MINMAX_LONG_TILES = 42       # tiles its longest segment spans, at least
MINMAX_EMPTY_RUN = 6_144     # consecutive empty segments: 3 tiles of ends
MINMAX_SHORT = 40_000        # segments of 0-4 slots: ends at every offset
BITMAP_WIDE_WORDS = 12288    # 48 KiB rows, listed in many passes
# unsorted pairs: bitmap rows, words a row, pairs, pairs of the hub u, pads
HUB_PAIRS = (512, 512, 4000, 1200, 40)
# color at rmat20 recorded on the TPU (essentials_tpu/algorithms/color.py
# :191, :295): printed beside the port's, not a gate
BC_SOURCES = 4         # BC spmv sources held against the host Brandes
BC_ALL_SOURCES = 32    # run_all's sources: rmat18's highest-degree vertices
BC_ALL_HOST = 4        # run_all's sources also summed on the host
# BC and PPR against the float64 host: benchmarks/PARITY.md's bounds of
# the JAX package against its host references (BC 2.3e-7 of the largest
# value for one source, PPR 4.5e-8 absolute) plus the float32 rounding of
# the result, as tests/test_torch_bc_ppr.py holds the CPU: one ulp of the
# largest BC value a source summed (bc_bound), half an ulp of the largest
# mass a PPR iteration, since p takes one float32 add an iteration
# (ppr_bound). A PPR vertex whose residual the card's float32 compare
# r >= eps * deg put on the other side of its threshold from the host's
# would break the bound: none did in PR 16's runs
BC_REL = 2.3e-7
PPR_ABS = 4.5e-8
F32_ULP = 2.0 ** -23   # float32's relative spacing at 1
PPR_SEEDS = 8          # run_batch's seeds: rmat18's highest-degree vertices
TPU_COLOR_HISTORY = {"jp": "8.3 s per run, about 100 rounds",
                     "spec": "206 ms per run"}


def bc_bound(n_sources: int = 1) -> float:
    """BC's bound against the float64 host, over the largest value."""
    return BC_REL + n_sources * F32_ULP


def ppr_bound(iterations: int, ref: np.ndarray) -> float:
    """PPR's absolute bound against the float64 host ``ref``."""
    return PPR_ABS + iterations * F32_ULP / 2 * float(np.abs(ref).max())


@contextlib.contextmanager
def spray_gate(min_edges: int):
    """sparse_advance._MIN_EDGES bound to ``min_edges`` while the block
    runs: 0 opens the spray on any graph, a count past the graph's edges
    closes it."""
    from essentials_tpu_torch.ops import sparse_advance as SA
    saved = SA._MIN_EDGES
    SA._MIN_EDGES = min_edges
    try:
        yield
    finally:
        SA._MIN_EDGES = saved


def device_row(e) -> bool:
    """Whether a ``key_averages()`` row is work on the card: not the step
    span (ProfilerStep*, which carries its window's device time) nor a
    span of the program (``runtime.span``: torch.profiler lists a user
    annotation on the device's timeline too, over the kernels inside it;
    its name is dotted words, a kernel's its signature)."""
    from torch.autograd import DeviceType
    return bool(e.device_type == DeviceType.CUDA and e.self_device_time_total
                and not e.key.startswith("ProfilerStep")
                and not getattr(e, "is_user_annotation", False)
                and not re.fullmatch(r"[a-z_]+(\.[a-z_]+)+", e.key))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: FAILED: {what}")


def rmat_graph(scale: int, device: str):
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    csr = Csr.from_coo(generate.rmat(scale, EDGE_FACTOR, seed=SEED,
                                     undirected=True, weighted=False))
    return csr, build_graph(csr, directed=False, weighted=False,
                            device=device)


def l2_rate() -> tuple:
    """The L2's bytes per second: a device-to-device copy of each size in
    L2_PROBE_MIB, L2_COPIES times back to back on the same two buffers (so
    that both stay in the L2), replayed from a CUDA graph (so that the
    host's launch rate does not set the pace; median of CYCLES replays on
    CUDA events); the larger copy's extra bytes (read and written) over its
    extra time, which cancels the fixed cost of each launch. Returns (that
    rate, each copy's own rate)."""
    ms, own = [], []
    for mib in L2_PROBE_MIB:
        a = torch.arange(mib * 2 ** 18, dtype=torch.int32, device="cuda")
        b = torch.empty_like(a)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):           # warm-up outside the capture
            b.copy_(a)
        torch.cuda.current_stream().wait_stream(side)
        copies = torch.cuda.CUDAGraph()
        with torch.cuda.graph(copies):
            for _ in range(L2_COPIES):
                b.copy_(a)
        ms.append(median_ms(lambda _: copies.replay()) / L2_COPIES)
        check(torch.equal(a, b), "the L2 probe's copy differs")
        own.append(2 * mib * 2 ** 20 / (ms[-1] * 1e-3))
    extra = 2 * (L2_PROBE_MIB[1] - L2_PROBE_MIB[0]) * 2 ** 20
    check(ms[1] > ms[0], f"the L2 probe's larger copy took no longer: {ms}")
    return extra / ((ms[1] - ms[0]) * 1e-3), own


def bound(nbytes: float, ops: float = 0.0, launches: int = 1) -> tuple:
    """(least ms, "bytes" or "operations", "L2" or "HBM"): the larger of
    ``nbytes`` over the memory rate and ``ops`` over the float32 rate, for
    ``launches`` launches that share the work evenly. The memory rate is
    L2's where one launch's bytes fit the L2, else HBM's."""
    memory = "L2" if nbytes / launches <= L2_BYTES else "HBM"
    tb = nbytes / MEMORY_RATE[memory] * 1e3
    to = ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes", memory) if tb >= to else (to, "operations", memory)


def library_ms(label: str, fn, reps: int = 1) -> float | None:
    """Per-call time of one PyTorch call that computes a kernel's function,
    a yardstick the port never calls; None, with the reason printed, where
    this PyTorch refuses the call on the card."""
    try:
        fn()
        torch.cuda.synchronize()
    except (RuntimeError, NotImplementedError, TypeError) as e:
        print(f"time: library call for {label}: not measured "
              f"({type(e).__name__}: {str(e)[:160]})")
        return None
    return median_ms(lambda _: [fn() for _ in range(reps)]) / reps


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


# ------------------------------------------------------------- phase 3 --

@contextlib.contextmanager
def bfs_form(form: str):
    """bfs_level made to take one form while the block runs ("device", the
    card's choice per level, or "push" or "pull" throughout):
    kernels.bfs.bfs_level_form bound to a constant."""
    from essentials_tpu_torch.kernels import bfs as KB
    saved = KB.bfs_level_form
    KB.bfs_level_form = lambda: form
    try:
        yield
    finally:
        KB.bfs_level_form = saved


def level_args(g) -> tuple:
    """bfs_level's graph arguments: offsets, csc_src, col."""
    return g.row_offsets, g.csc_src_indices, g.col_indices


def check_kernels(g, source: int, errs: dict) -> bool:
    """Every level of one BFS in both forms, kernel against plain, under
    each of BFS_CHECKS; then the collapse and the predecessors; then one
    of each of bfs_level's device kernels per call, as torch.profiler sees
    it (False where every profiler window lost device activities)."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    args = level_args(g)
    for unreached in (FB.UNREACHED, FB.UNREACHED_E):
        form = "int8" if unreached == FB.UNREACHED_E else "int32"
        took = {}
        for how, cap in BFS_CHECKS:
            lev_k = FB.init_lev_exp(g, source, unreached)
            lev_p = lev_k.clone()
            it, forms = 0, []
            with bfs_form(how):
                while True:
                    if how == "device":
                        forms.append("pull" if bfs_level_work(
                            g, lev_k, it, unreached)["pulls"] else "push")
                    cnt_k = K.bfs_level(lev_k, *args, it, unreached, cap)
                    cnt_p = K.bfs_level_plain(lev_p, *args, it, unreached)
                    torch.cuda.synchronize()
                    e = max(max_err(lev_k, lev_p), max_err(cnt_k, cnt_p))
                    errs[f"bfs_level<{form}>"] = max(
                        errs[f"bfs_level<{form}>"], e)
                    check(e == 0, f"bfs_level<{form}> ({how}, cap {cap}) "
                                  f"level {it} differs from plain")
                    it += 1
                    if cnt_k.item() == 0 or it >= MAX_IT:
                        break
            tier = K.advance_count_tier(g.n_vertices_padded, g.device, cap)
            took[f"{how}, pull tier {tier}"] = ",".join(forms) or it
        dist_k = K.collapse_levels(lev_k, g.row_offsets, source, unreached)
        dist_p = K.collapse_levels_plain(lev_p, g.row_offsets, source,
                                         unreached)
        e = max_err(dist_k, dist_p)
        errs[f"collapse_levels<{form}>"] = max(
            errs[f"collapse_levels<{form}>"], e)
        check(e == 0, f"collapse_levels<{form}> differs from plain")
        pred_k = K.bfs_predecessors(dist_k, g.csc_offsets, g.csc_src_indices,
                                    g.n_edges)
        pred_p = K.bfs_predecessors_plain(dist_k, g.csc_offsets,
                                          g.csc_src_indices, g.n_edges)
        e = max_err(pred_k, pred_p)
        errs["bfs_predecessors"] = max(errs["bfs_predecessors"], e)
        check(e == 0, "bfs_predecessors differs from plain")
        print(f"kernels: V={g.n_vertices} E={g.n_edges} source {source} "
              f"{form}: {it} levels, {int((dist_k < FB.UNREACHED).sum())} "
              f"reached, exact against plain under each form "
              f"({'; '.join(f'{k}: {v}' for k, v in took.items())})")
    state = FB.init_lev_exp(g, source)
    buf = state.clone()
    return check_one_launch(
        "bfs_level", lambda: K.bfs_level(buf.copy_(state), *args, 0,
                                         FB.UNREACHED),
        f"V={g.n_vertices} level 0", K.device_kernels("bfs_level<int32>"))


# ------------------------------------------------------------- phase 4 --

def host_predecessors(csr, dist: np.ndarray) -> np.ndarray:
    """Smallest-id in-neighbour one level up, on the host, from the CSC
    order (sorted by dst, then src): the first qualifying slot of each
    destination holds the smallest source."""
    n = csr.n_rows
    src = np.repeat(np.arange(n), np.diff(csr.row_offsets))
    dst = csr.col_indices
    order = np.lexsort((src, dst))
    s, d = src[order], dst[order]
    ds = dist[s].astype(np.int64)
    ok = (dist[s] != np.iinfo(np.int32).max) & (ds + 1 == dist[d])
    pred = np.full(n, -1, np.int64)
    v, first = np.unique(d[ok], return_index=True)
    pred[v] = s[ok][first]
    pred[dist == 0] = -1
    return pred


# expand_segments' and collapse_starts' stress offsets (starts_stress_offsets)
STARTS_EMPTY_RUN = 700       # empty segments in a run across a tile edge
STARTS_HUB_TILES = 3.5       # tiles of slots the hub spans
PRED_HUB_RANGES = 3    # ranges of the stress hub's segment past its first walk
PRED_CHAIN = 6         # vertices of the stress chain, the source to the hub
PRED_CUT = 40          # real CSC slots the stress graph's last cut drops


def pred_stress_coo(split: int, seed: int = SEED) -> tuple:
    """An undirected multigraph whose hub's only qualifying in-edge, for BFS
    and SSSP from ``source``, lies in the last range of its segment: (n,
    src, dst, weights, source). Leaves 0..k-1 (k = (PRED_HUB_RANGES + 1)
    * split + 7) hang on the hub n - 1, a tenth of them twice, and are
    joined among themselves at random; a chain from ``source`` = k through
    k + PRED_CHAIN - 1 = n - 2 ends at the hub, which is the hub's largest
    in-neighbour and the only one a level (or a path) before it: the leaves
    hang below. Zero-weight self-loops at leaf 3 and at chain vertex k + 2
    (SSSP's predicate takes them, BFS's never); other weights in [0.5,
    1.5) from the seed."""
    rng = np.random.default_rng(seed)
    k = (PRED_HUB_RANGES + 1) * split + 7
    n = k + PRED_CHAIN + 1
    hub = n - 1
    twice = rng.choice(k, k // 10, replace=False)
    a, b = rng.integers(0, k, (2, k))
    chain = np.arange(k, n)                 # k .. n - 2, then the hub
    src = np.concatenate([np.arange(k), twice, a[a != b], chain[:-1]])
    dst = np.concatenate([np.full(k + twice.size, hub), b[a != b],
                          chain[1:]])
    w = rng.random(src.size).astype(np.float32) + 0.5
    loops = np.array([3, k + 2])
    return (n, np.concatenate([src, dst, loops]).astype(np.int32),
            np.concatenate([dst, src, loops]).astype(np.int32),
            np.concatenate([w, w, np.zeros(2, np.float32)]), k)


def pred_stress_graph(device: str, split: int) -> tuple:
    """pred_stress_coo's graph, undirected and weighted: (csr, graph,
    source)."""
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    n, src, dst, w, source = pred_stress_coo(split)
    csr = Csr.from_coo(Coo(n, n, src, dst, w))
    return (csr, build_graph(csr, directed=False, weighted=True,
                             device=device), source)


def padded_dist(g, dist: torch.Tensor, empty) -> torch.Tensor:
    """A [V] distance vector as the [Vp] one the predecessor kernels take,
    ``empty`` at the padding vertices."""
    out = torch.full((g.n_vertices_padded,), empty, dtype=dist.dtype,
                     device=dist.device)
    out[:dist.numel()] = dist
    return out


def pred_cases(g, source: int) -> dict:
    """The predecessor kernels' arguments of one BFS and one SSSP search
    from ``source`` on ``g`` (fused where the layout is symmetric, else
    adaptive), each with n_edges = E, E - 1 and E - PRED_CUT (the last real
    segments cut) and, for SSSP, the padding vertex given distance 1: its
    zero-weight padding self-loops would qualify were the slots from E on
    not cut. {"bfs": [args], "sssp": [args]}."""
    from essentials_tpu_torch.algorithms import bfs, sssp
    from essentials_tpu_torch.ops import fused_sssp as FS
    variant = "fused" if g.symmetric_layout else "adaptive"
    d_b = padded_dist(g, bfs.run(g, source, variant=variant, warmup=False,
                                 compute_predecessors=False).distances,
                      INT32_MAX)
    d_s = padded_dist(g, sssp.run(g, source, variant=variant,
                                  warmup=False).distances, float("inf"))
    d_pad = d_s.clone()
    d_pad[g.pad_vertex] = 1.0
    off, src, e = g.csc_offsets, g.csc_src_indices, g.n_edges
    w = FS.csc_weights(g)
    cuts = (e, max(e - 1, 0), max(e - PRED_CUT, 0))
    return {"bfs": [(d_b, off, src, n) for n in cuts],
            "sssp": [(d, off, src, w, n) for n in cuts
                     for d in (d_s, d_pad)]}


def pred_work(dist, offsets, csc_src, n_edges: int, w=None,
              split: int | None = None) -> dict:
    """What a predecessor search must do on ``dist`` (int32 BFS levels; or
    float32 SSSP distances with ``w``, the CSC weights), on its device:
    each reached vertex's walk to its first qualifying slot (its whole
    segment below n_edges where none qualifies), and what the first walk
    lists at ``split`` (kernels.bfs.PRED_SPLIT by default). Keys: reached,
    hits, slots (csc_src slots up to each first hit), sectors (distinct
    32-byte sectors of dist under those slots' sources), listed (vertices),
    ranges, listed_slots, bytes (the first-hit bound's: the offsets, dist
    and pred once each, csc_src and w up to each first hit; every sector of
    dist is read, by its own vertex at least) and dense_bytes (the dense
    model's: every real csc_src slot, and w)."""
    from essentials_tpu_torch import kernels as K
    split = K.bfs.PRED_SPLIT if split is None else split
    vp = offsets.numel() - 1
    seg = K._segment_ids(offsets, csc_src.numel())[:n_edges]
    src = csc_src[:n_edges].long()
    if w is None:
        reached = (dist != INT32_MAX) & (dist > 0)
        ds = dist[src].long()
        ok = (ds != INT32_MAX) & (ds + 1 == dist[seg].long())
    else:
        reached = torch.isfinite(dist) & (dist > 0)
        ok = dist[src] + w[:n_edges] == dist[seg]
    ok &= reached[seg]
    q = torch.arange(n_edges, device=dist.device)
    big = torch.iinfo(torch.int64).max
    first = torch.full((vp,), big, dtype=torch.int64, device=dist.device)
    first.scatter_reduce_(0, seg, torch.where(ok, q, big), "amin")
    hit = first < big
    b = offsets[:-1].long()
    length = (offsets[1:].long().clamp(max=n_edges) - b).clamp(min=0)
    walk = torch.where(reached, torch.where(hit, first - b + 1, length), 0)
    read = (q - b[seg]) < walk[seg]
    listed = reached & (length > split) & (~hit | (first - b >= split))
    words = 2 if w is not None else 1
    slots = int(walk.sum())
    return {"reached": int(reached.sum()), "hits": int(hit.sum()),
            "slots": slots,
            "sectors": int(torch.unique(src[read] // 8).numel()),
            "listed": int(listed.sum()),
            "ranges": int(torch.where(listed, (length - 1) // split,
                                      0).sum()),
            "listed_slots": int(torch.where(listed, length - split,
                                            0).sum()),
            "bytes": 4 * (vp + 1) + 8 * vp + 4 * words * slots,
            "dense_bytes": 4 * (vp + 1) + 8 * vp + 4 * words * n_edges}


def pred_work_args(args: tuple) -> tuple:
    """A predecessor kernel's arguments (BFS's four, SSSP's five) in
    pred_work's order: dist, offsets, csc_src, n_edges, w."""
    return (*args[:3], args[-1], args[3] if len(args) == 5 else None)


def hold_pred_cases(g, source: int, where: str, errs: dict) -> str:
    """pred_cases' arguments through both predecessor kernels, each against
    a second launch and its plain version, bitwise; the range walk launched
    once a call. Returns a summary of what the first walk listed."""
    from essentials_tpu_torch import kernels as K
    cases, said = pred_cases(g, source), []
    for name, kernel, plain in (
            ("bfs_predecessors", K.bfs_predecessors,
             K.bfs_predecessors_plain),
            ("sssp_predecessors", K.sssp_predecessors,
             K.sssp_predecessors_plain)):
        for args in cases[name.split("_")[0]]:
            ranges = K.pass_launches[name + "_ranges"]
            hold_exact(name, (kernel(*args),), (kernel(*args),),
                       (plain(*args),), errs,
                       f"{where}, n_edges {args[-1]}")
            check(K.pass_launches[name + "_ranges"] == ranges + 2,
                  f"{name}: the range walk is not launched once a call")
        work = pred_work(*pred_work_args(cases[name.split("_")[0]][0]))
        said.append(f"{name.split('_')[0]}: {work['reached']} reached, "
                    f"{work['listed']} listed in {work['ranges']} ranges")
    return "; ".join(said)


# ------------------------------------------------------------- phase 5 --

def median_ms(fn, reps: int = CYCLES, setup=None) -> float:
    """Median over ``reps`` of fn's time on CUDA events, after one warm-up;
    ``setup`` runs outside the timed region before each call."""
    times = []
    for r in range(reps + 1):
        arg = setup() if setup else None
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn(arg)
        e1.record()
        e1.synchronize()
        if r:
            times.append(e0.elapsed_time(e1))
    return float(np.median(times))


def bfs_level_states(g, source: int, unreached: int) -> tuple:
    """The level array before each level of one search from ``source``,
    and after its last."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    states, lev, it = [], FB.init_lev_exp(g, source, unreached), 0
    while True:
        states.append(lev.clone())
        cnt = K.bfs_level(lev, *level_args(g), it, unreached)
        it += 1
        if cnt.item() == 0 or it >= MAX_IT:
            return states, lev


def bfs_level_work(g, lev, it: int, unreached: int) -> dict:
    """What the level from ``lev`` must do, on the card's tensors: the
    frontier's vertices n_f and out-slots m_f and the unreached vertices'
    in-slots m_u, the form the card takes (kernels.bfs_level_pulls), the vertices it reaches,
    and the bytes of its bound: the offsets and each non-empty start's
    32-byte sector read once, the two bitmaps written and read once, the
    smaller of the push's col words (m_f) and the pull's csc_src words (each
    unreached segment up to its first slot from the frontier), and the
    sectors of the starts reached written; beside them the dense bound's
    bytes (the earlier pull-only kernel's model: every start read and
    written, the offsets, every csc_src slot)."""
    from essentials_tpu_torch import kernels as K
    off, src = g.row_offsets, g.csc_src_indices
    vp, ep = g.n_vertices_padded, g.n_edges_padded
    elt = lev.element_size()
    nonempty = off[1:] > off[:-1]
    starts = torch.where(nonempty, off[:-1], 0).long()
    lens = (off[1:] - off[:-1]).long()
    lv = torch.where(nonempty, lev[starts].int(), unreached)
    front = nonempty & (lv == it)
    opened = nonempty & (lv == unreached)
    m_f, m_u = int(lens[front].sum()), int(lens[opened].sum())
    n_f = int(front.sum())
    seg = K._segment_ids(off, ep)
    hit = front[src.long()] & opened[seg]
    pos = torch.arange(ep, device=lev.device)
    first = torch.full((vp,), ep, dtype=torch.int64, device=lev.device)
    first.scatter_reduce_(0, seg[hit], pos[hit], "amin")
    reached = opened & (first < ep)
    scanned = int(torch.where(reached, first - starts + 1, lens)[opened].sum())
    per = 32 // elt                  # starts of one 32-byte sector
    sectors = int(torch.unique(starts[nonempty] // per).numel())
    written = int(torch.unique(starts[reached] // per).numel())
    bits = 4 * 4 * K.bitmap_words(vp)
    return {"m_f": m_f, "m_u": m_u, "n_f": n_f,
            "pulls": K.bfs_level_pulls(m_f, m_u, n_f, vp),
            "reached": int(reached.sum()), "pull_slots": scanned,
            "bytes": 4 * (vp + 1) + 32 * (sectors + written) + bits
            + 4 * min(m_f, scanned),
            "dense_bytes": 2 * elt * vp + 4 * (vp + 1) + 4 * ep + 4}


def bfs_level_ms(g, states, unreached: int, kernels: tuple,
                 forms=BFS_FORMS_TIMED, reps: int = CYCLES) -> dict:
    """bfs_level over the levels of ``states`` (bfs_level_states), each call
    from its saved state (restored outside the timed region): each level's
    wall time (median of ``reps`` on CUDA events) and, under each of
    ``forms``, its device time (torch.profiler, the device kernels
    ``kernels`` a call launches)."""
    from essentials_tpu_torch import kernels as K
    args = level_args(g)
    buf = torch.empty_like(states[0])

    def restored(lev):
        return buf.copy_(lev)
    wall = [median_ms(lambda x, i=i: K.bfs_level(x, *args, i, unreached),
                      reps, lambda s=s: restored(s))
            for i, s in enumerate(states)]

    def search():
        for i, s in enumerate(states):
            K.bfs_level(restored(s), *args, i, unreached)
    dev = {}
    for form in forms:
        with bfs_form(form):
            dev[form] = per_call_device_ms(search, kernels, len(states))
    return {"walls": wall, "devices": dev}


def ms_by_form(dev: dict) -> str:
    """bfs_level's device ms by form, as bfs_level_ms gives them."""
    label = {"device": "as chosen", "push": "push forced",
             "pull": "pull forced"}
    return ", ".join(f"{label[f]} " + ("not measured" if v is None
                                       else f"{v:.4f} ms")
                     for f, v in dev.items())


def time_bfs_levels(g, source: int, card: str, where: str) -> dict:
    """bfs_level level by level over one search from ``source`` in both
    forms: wall and device time (bfs_level_ms), the form the card took,
    the device time of each form forced, the plain version's wall time,
    the level's bound and the dense bound (bfs_level_work), per level and
    summed per search. Returns chip_smoke's keys for bfs_level<int32> and
    <int8>."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    out = {}
    args = level_args(g)
    for unreached in (FB.UNREACHED, FB.UNREACHED_E):
        form = "int8" if unreached == FB.UNREACHED_E else "int32"
        name = f"bfs_level<{form}>"
        states = bfs_level_states(g, source, unreached)[0]
        work = [bfs_level_work(g, s, i, unreached)
                for i, s in enumerate(states)]
        t = bfs_level_ms(g, states, unreached,
                         K.device_kernels("bfs_level<int32>"))
        buf = torch.empty_like(states[0])
        plain = [median_ms(lambda x, i=i: K.bfs_level_plain(
            x, *args, i, unreached), setup=lambda s=s: buf.copy_(s))
            for i, s in enumerate(states)]
        bounds = [bound(w["bytes"]) for w in work]
        dense = [bound(w["dense_bytes"]) for w in work]
        levels = []
        for i, w in enumerate(work):
            dev = {f: None if d is None else d[i]
                   for f, d in t["devices"].items()}
            levels.append({
                "level": i, "form": "pull" if w["pulls"] else "push",
                "n_f": w["n_f"], "m_f": w["m_f"], "m_u": w["m_u"],
                "reached": w["reached"],
                "ms": t["walls"][i], "device_ms": dev["device"],
                "push_device_ms": dev["push"], "pull_device_ms": dev["pull"],
                "plain_ms": plain[i], "bound_ms": bounds[i][0],
                "bound_memory": bounds[i][2], "dense_bound_ms": dense[i][0]})
            print(f"time [{card}]: {name} {where} from {source} level {i}: "
                  f"{levels[-1]['form']} (n_f {w['n_f']}, m_f {w['m_f']}, "
                  f"m_u {w['m_u']}, "
                  f"reaches {w['reached']}, pull slots to the first hit "
                  f"{w['pull_slots']}): {t['walls'][i]:.4f} ms wall; "
                  f"device {ms_by_form(dev)}; plain {plain[i]:.4f} ms; "
                  f"bound "
                  f"{bounds[i][0]:.4f} ms ({bounds[i][2]}), dense bound "
                  f"{dense[i][0]:.4f}")
        search = {f: None if d is None else sum(d)
                  for f, d in t["devices"].items()}
        mems = "/".join(sorted({b[2] for b in bounds}))
        print(f"time [{card}]: {name} {where} from {source}, a search of "
              f"{len(states)} levels ({','.join(lv['form'] for lv in levels)}"
              f"): {sum(t['walls']):.4f} ms wall; device "
              f"{ms_by_form(search)}; plain {sum(plain):.4f} ms; bound "
              f"{sum(b[0] for b in bounds):.4f} ms ({mems}), dense bound "
              f"{sum(b[0] for b in dense):.4f}")
        out[name] = sum(t["walls"])
        out[name + "/plain"] = sum(plain)
        out[name + "/device"] = search["device"]
        out[name + "/bound"] = (sum(b[0] for b in bounds), "bytes", mems)
        out[name + "/bound_dense"] = (sum(b[0] for b in dense), "bytes",
                                      "/".join(sorted({b[2] for b in dense})))
        out[name + "/levels"] = levels
        out[name + "/forced"] = {"push_device_ms": search["push"],
                                 "pull_device_ms": search["pull"]}
    return out


PRED_DEVICE_REPS = 10   # calls a predecessor device time is taken over


def time_predecessors(name: str, cases: list, card: str, where: str,
                      key: str | None = None) -> dict:
    """``name``'s wrapper at each of ``cases`` (its arguments: one search's
    distances each), one call at a time: wall (median of CYCLES), device
    (torch.profiler over PRED_DEVICE_REPS calls, the memset included), the
    plain version's wall, and the first-hit and dense bounds of pred_work;
    mean and max over the cases. Keys (under ``key``, by default ``name``): "", /max, /device,
    /device_max, /plain, /bound, /bound_dense, /work (pred_work's counts,
    mean over the cases), /walls and /devices (by case)."""
    from essentials_tpu_torch import kernels as K
    kernel, plain = getattr(K, name), getattr(K, name + "_plain")
    walls, devs, plains, bounds, dense, works = [], [], [], [], [], []
    for args in cases:
        walls.append(median_ms(lambda _: kernel(*args)))
        devs.append(device_ms(lambda: kernel(*args), PRED_DEVICE_REPS)[0])
        plains.append(median_ms(lambda _: plain(*args)))
        works.append(pred_work(*pred_work_args(args)))
        bounds.append(bound(works[-1]["bytes"]))
        dense.append(bound(works[-1]["dense_bytes"]))
    seen = [d for d in devs if d is not None]
    key = key or name
    out = {name: float(np.mean(walls)), name + "/max": max(walls),
           name + "/device": float(np.mean(seen)) if seen else None,
           name + "/device_max": max(seen) if seen else None,
           name + "/plain": float(np.mean(plains)),
           name + "/bound": (float(np.mean([b[0] for b in bounds])),
                             "bytes", "/".join(sorted({b[2]
                                                       for b in bounds}))),
           name + "/bound_dense": (float(np.mean([b[0] for b in dense])),
                                   "bytes",
                                   "/".join(sorted({b[2] for b in dense}))),
           name + "/work": {k: float(np.mean([w[k] for w in works]))
                            for k in works[0]},
           name + "/walls": walls, name + "/devices": devs}
    out = {key + k[len(name):]: v for k, v in out.items()}
    b, d, wk = out[key + "/bound"], out[key + "/bound_dense"], \
        out[key + "/work"]
    dev = out[key + "/device"]
    print(f"time [{card}]: {name} {where}, {len(cases)} searches: wall "
          f"{out[key]:.4f} ms mean, {out[key + '/max']:.4f} max; device "
          + ("not measured" if dev is None else
             f"{dev:.4f} ms mean, {out[key + '/device_max']:.4f} max")
          + f" (by search: wall {fmt_ms(walls)}; device {fmt_ms(devs)})"
          f"; plain {out[key + '/plain']:.4f}"
          f" ms; first-hit bound {b[0]:.4f} ms ({b[2]}), dense bound "
          f"{d[0]:.4f} ms ({d[2]}); per search {wk['reached']:.0f} reached, "
          f"{wk['slots']:.0f} slots to the first hits, {wk['listed']:.1f} "
          f"vertices listed in {wk['ranges']:.1f} ranges of PRED_SPLIT "
          f"{K.bfs.PRED_SPLIT} ({wk['listed_slots']:.0f} slots)")
    return out


def fmt_ms(values) -> str:
    return ", ".join("not measured" if v is None else f"{v:.4f}"
                     for v in values)


def bfs_pred_cases(g, sources) -> list:
    """bfs_predecessors' arguments after a fused int32 search from each
    source (bfs_level, then collapse_levels)."""
    from essentials_tpu_torch.algorithms import bfs
    return [(bfs._search(g, int(s), MAX_IT, False)[0], g.csc_offsets,
             g.csc_src_indices, g.n_edges) for s in sources]


def sssp_pred_cases(g, sources) -> list:
    """sssp_predecessors' arguments after a fused search from each
    source."""
    from essentials_tpu_torch.algorithms import sssp
    from essentials_tpu_torch.ops import fused_sssp as FS
    w = FS.csc_weights(g)
    return [(sssp.VARIANTS["fused"](g, int(s), g.n_vertices + 1)[0],
             g.csc_offsets, g.csc_src_indices, w, g.n_edges)
            for s in sources]


def pred_stress_inputs(run) -> list:
    """[(where, graph, source)]: pred_stress_graph at kernels.bfs.PRED_SPLIT
    (its hub's only hit in its last range), kcore_stress_graph (a hub,
    multi-edges and self-loops) from its highest-degree vertex and the
    degree-balanced directed graph from its hub."""
    from essentials_tpu_torch import kernels as K
    _, g_h, s_h = pred_stress_graph("cuda", K.bfs.PRED_SPLIT)
    csr_k, g_k = kcore_stress_graph("cuda")
    csr_b, g_b = run.balanced_graph()
    return [(f"the last-range hub graph (V={g_h.n_vertices}, hub of "
             f"{g_h.max_degree})", g_h, s_h),
            ("a hub, multi-edges and self-loops", g_k,
             int(np.argmax(np.diff(csr_k.row_offsets)))),
            ("the degree-balanced directed graph", g_b,
             int(np.argmax(np.diff(csr_b.row_offsets))))]


def time_searches(label: str, card: str, search, sources) -> dict:
    """search(source) over ``sources``: wall ms per search (median of
    CYCLES cycles) and device ms per search (torch.profiler over two
    cycles, so that a window that lost activities shows), printed."""
    def cycle(_=None):
        for s in sources:
            search(int(s))
    wall = median_ms(cycle) / len(sources)
    dev = device_ms(cycle, 2)[0]
    dev = None if dev is None else dev / len(sources)
    print(f"time [{card}]: {label}: {wall:.4f} ms per search wall (median "
          f"of {CYCLES} cycles of {len(sources)} sources), "
          + ("device not measured" if dev is None else
             f"{dev:.4f} ms of device time per search (two cycles)"))
    return {"wall": wall, "device": dev}


def check_pred_sources(name: str, cases: list, where: str,
                       errs: dict) -> None:
    """``name``'s kernel at each of ``cases`` against a second launch and
    its plain version, bitwise; prints what the first walks listed and the
    range walk's launches."""
    from essentials_tpu_torch import kernels as K
    kernel, plain = getattr(K, name), getattr(K, name + "_plain")
    ranges = K.pass_launches[name + "_ranges"]
    works = []
    for i, args in enumerate(cases):
        hold_exact(name, (kernel(*args),), (kernel(*args),), (plain(*args),),
                   errs, f"{where}, search {i}")
        works.append(pred_work(*pred_work_args(args)))
    launched = K.pass_launches[name + "_ranges"] - ranges
    check(launched == 2 * len(cases),
          f"{name}: {launched} range walks over {2 * len(cases)} calls")
    listed = [w["listed"] for w in works]
    print(f"kernels: {name} {where} from {len(cases)} sources: PRED_SPLIT "
          f"{K.bfs.PRED_SPLIT}; vertices listed per "
          f"search {listed}, ranges "
          f"{[w['ranges'] for w in works]}; the range walk launched "
          f"{launched} times in {2 * len(cases)} calls; exact against plain "
          f"and repeatable")


def time_kernels(g, sources, card: str) -> dict:
    """Each kernel and its plain version at rmat18 shapes, one call at a
    time through its wrapper (so a short kernel's time is mostly the
    wrapper's host time): bfs_level level by level over one search from
    the first source (time_bfs_levels); collapse_levels once per search;
    bfs_predecessors once per search from each source (time_predecessors:
    the mean is what a search pays) and from the first alone."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    source = int(sources[0])
    out = time_bfs_levels(g, source, card, f"rmat{SCALE}")
    off, vp = g.row_offsets, g.n_vertices_padded
    starts = segment_starts(off)
    for unreached in (FB.UNREACHED, FB.UNREACHED_E):
        form = "int8" if unreached == FB.UNREACHED_E else "int32"
        lev = bfs_level_states(g, source, unreached)[1]
        elt = 1 if form == "int8" else 4
        name = f"collapse_levels<{form}>"
        t = against_library(
            lambda: K.collapse_levels(lev, off, source, unreached),
            elt * vp + 4 * (vp + 1) + 4 * vp,
            plain=lambda: K.collapse_levels_plain(lev, off, source,
                                                  unreached),
            lib=lambda: torch.index_select(lev, 0, starts),
            label=f"{name} (index_select at the starts)")
        t["/bound_sectors"] = bound(32 * starts.numel() + 4 * (vp + 1)
                                    + 4 * vp)
        print_against(card, f"{name} rmat{SCALE} from {source}", t,
                      "index_select at the starts (the gather alone)")
        out.update(prefixed(name, t))
    out.update(time_predecessors("bfs_predecessors",
                                 bfs_pred_cases(g, sources), card,
                                 f"rmat{SCALE}"))
    return out


def profile(label: str, fn, expect: int | None = None) -> dict:
    """Device time by kernel over ``fn()`` from torch.profiler, beside the
    wall time of the same call (with the profiler on). ``fn`` runs twice:
    once in the profiler's warm-up step, so that the device tracing is
    running when the recorded call begins, and once recorded. ``expect``
    is the number of our kernels' launches the recorded call makes
    (K.launches' counts); the second kernels that the call makes (the
    pack passes of gather_payloads, the k-core waves' peels and pushes
    and the splits of segment_minmax: K.pass_launches) are added to it, since each
    is a device kernel of its own. A trace that saw fewer is reported, its
    busy share as a lower bound. Returns {kernel name: (total ms,
    launches)}; empty when the profiler saw no device time."""
    from essentials_tpu_torch import kernels as K
    from torch.profiler import (ProfilerActivity, profile as torch_profile,
                                schedule)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA],
                       schedule=schedule(wait=0, warmup=1, active=1,
                                         repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()
        packs = second_passes()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        prof.step()
        packs = second_passes() - packs
    rows = {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages() if device_row(e)}
    busy = sum(ms for ms, _ in rows.values())
    seen = launches_seen(rows)
    if expect is not None:
        expect += packs
    print(f"profile: {label}: wall "
          f"{wall_ms:.3f} ms with the profiler on, device busy "
          f"{busy:.3f} ms" + (f" ({100 * busy / wall_ms:.1f}%, idle "
                              f"{100 - 100 * busy / wall_ms:.1f}%)"
                              if rows else " (not measured: no device time)")
          + ("" if expect is None else
             f"; saw all {expect} launches" if seen == expect else
             f"; saw {seen} of {expect} launches: busy is a lower bound, "
             f"idle an upper bound"))
    for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0]):
        print(f"profile:   {ms:9.4f} ms  {n:5d} launches  {name[:90]}")
    return rows


def second_passes() -> int:
    """The second device kernels our wrappers have launched so far."""
    from essentials_tpu_torch import kernels as K
    return sum(K.pass_launches.values())


def launches_seen(rows: dict) -> int:
    """Launches of our device kernels among profile()'s rows: each is named
    <key>_kernel for a key of K.launches (without its type) or of
    K.pass_launches."""
    from essentials_tpu_torch import kernels as K
    ours = [f"{k.split('<')[0]}_kernel" for k in (*K.launches,
                                                  *K.pass_launches)]
    return sum(n for name, (_, n) in rows.items()
               if any(k in name for k in ours))


def device_ms(fn, reps: int = 20) -> tuple:
    """Device time per call of ``fn()`` from torch.profiler: ``reps`` calls
    in a warm-up step, then ``reps`` calls recorded, and every device
    activity of the recorded window over ``reps``. Returns (that ms, {name:
    ms per call}); (None, {}) where the profiler saw no device time. A
    window that came back empty, or that lost activities (a count that is
    not a whole number of calls), is retaken."""
    from torch.profiler import (ProfilerActivity, profile as torch_profile,
                                schedule)
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as prof:
            for _ in range(2):
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
                prof.step()
        events = [e for e in prof.key_averages() if device_row(e)]
        if events and all(e.count % reps == 0 for e in events):
            rows = {e.key: e.self_device_time_total / 1e3 / reps
                    for e in events}
            return sum(rows.values()), rows
    return None, {}


def print_device(card: str, label: str, ms, rows: dict) -> None:
    split = ", ".join(f"{name[:48]} {t:.4f}" for name, t in
                      sorted(rows.items(), key=lambda r: -r[1]))
    print(f"time [{card}]: {label}: "
          + ("not measured (no device time in the trace)" if ms is None
             else f"{ms:.4f} ms of device time per call ({split})"))


def against_library(fn, nbytes: float, plain=None, lib=None,
                    label: str = "", reps: int = SPMV_REPS) -> dict:
    """fn()'s wall time per call (``reps`` calls back to back on CUDA
    events) and device time per call (torch.profiler, memsets included),
    with the bound of ``nbytes``; beside, where given, its plain version's
    wall time and the wall and device time of ``lib``, one PyTorch call
    computing the same function (``label`` names it). Keys: "" (the wall
    ms), /device, /device_rows, /bound, /plain, /library,
    /library_device."""
    t = {"": median_ms(lambda _: [fn() for _ in range(reps)]) / reps}
    t["/device"], t["/device_rows"] = device_ms(fn, reps)
    t["/bound"] = bound(nbytes)
    t["/plain"] = None if plain is None else median_ms(lambda _: plain())
    t["/library"] = None if lib is None else library_ms(label, lib, reps)
    t["/library_device"] = (None if t["/library"] is None
                            else device_ms(lib, reps)[0])
    return t


def prefixed(name: str, t: dict) -> dict:
    """against_library's keys under ``name``."""
    return {name + k: v for k, v in t.items()}


def print_against(card: str, label: str, t: dict, lib: str = "") -> None:
    """One line of against_library's numbers."""
    def ms(v) -> str:
        return "not measured" if v is None else f"{v:.4f} ms"
    b = t["/bound"]
    print(f"time [{card}]: {label}: {ms(t[''])} per call (wall), "
          f"{ms(t['/device'])} of device time, bound {b[0]:.4f} ms ({b[1]} "
          f"at {b[2]} rate)"
          + ("" if t["/plain"] is None else f", plain {ms(t['/plain'])}")
          + ("" if not lib else f"; {lib} {ms(t['/library'])} wall, "
                                f"{ms(t['/library_device'])} device"))


def profile_searches(g, sources, variant: str, kw: dict) -> dict:
    """Device time by kernel over one bfs.run from each source,
    predecessors included."""
    from essentials_tpu_torch.algorithms import bfs

    def searches():
        for s in sources:
            bfs.run(g, int(s), variant=variant, warmup=False, **kw)
    return profile(f"bfs {variant}, {len(sources)} runs", searches)


# ------------------------------------------------------------- phase 6 --

def spmv_graph(scale: int, device: str):
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    csr = Csr.from_coo(generate.rmat(scale, EDGE_FACTOR, seed=SPMV_SEED,
                                     undirected=False, weighted=True))
    return csr, build_graph(csr, directed=True, weighted=True, device=device)


def sum_errors(k: torch.Tensor, p: torch.Tensor) -> tuple:
    """(max |k - p|, max |k - p| / |p| where p != 0, whether every element
    is within SUM_RTOL |p| + SUM_ATOL), in float64."""
    k, p = k.double(), p.double()
    d = (k - p).abs()
    rel = (d / p.abs())[p != 0]
    return (float(d.max()) if d.numel() else 0.0,
            float(rel.max()) if rel.numel() else 0.0,
            bool((d <= SUM_RTOL * p.abs() + SUM_ATOL).all()))


def hold(name: str, form: str, reduce: str, k, again, p, errs: dict,
         where: str, max_rel: float | None = None) -> None:
    """Kernel output k against the plain version's p (exact under min, to
    the sum tolerance under sum, and to ``max_rel`` relative error where
    p != 0 when given) and against a second launch (bitwise)."""
    check(torch.equal(k, again), f"{name}{form} gives other bits on a "
                                 f"second launch ({where})")
    if reduce == "min":
        check(torch.equal(k, p), f"{name}{form} differs from plain ({where})")
        print(f"kernels: {where} {name}{form}: exact against plain, "
              f"repeatable")
        return
    if k.dtype == torch.int32:
        k, p = k.view(torch.float32), p.view(torch.float32)
    abs_err, rel_err, ok = sum_errors(k, p)
    errs[name] = max(errs[name], abs_err)
    errs[name + "/rel"] = max(errs[name + "/rel"], rel_err)
    check(ok, f"{name}{form} outside |k - p| <= {SUM_RTOL} |p| + {SUM_ATOL} "
              f"of plain ({where}): max abs {abs_err}, max rel {rel_err}")
    check(max_rel is None or rel_err <= max_rel,
          f"{name}{form} max rel err {rel_err} against plain above "
          f"{max_rel} ({where})")
    print(f"kernels: {where} {name}{form}: max abs err {abs_err:.6g}, max "
          f"rel err {rel_err:.6g} against plain (within tolerance), "
          f"repeatable")


def host_product(g, w, x) -> torch.Tensor:
    """[Vp] float64 y = A x on the host from ``g``'s CSR arrays (w None:
    every weight 1)."""
    off, col = g.row_offsets.cpu(), g.col_indices.cpu().long()
    row = torch.repeat_interleave(torch.arange(off.numel() - 1),
                                  (off[1:] - off[:-1]).long())
    msg = x.cpu().double()[col]
    if w is not None:
        msg = msg * w.cpu().double()
    return torch.zeros(off.numel() - 1, dtype=torch.float64).index_add_(
        0, row, msg)


def check_spmv_rows(g, cases, where: str, errs: dict,
                    max_rel: float | None = None) -> None:
    """spmv_rows against its plain version and a second launch for each
    (w, x, form) case, and within the sum tolerance of the float64 host
    product."""
    from essentials_tpu_torch import kernels as K
    off, col = g.row_offsets, g.col_indices
    for w, x, form in cases:
        k = K.spmv_rows(off, col, w, x)
        again = K.spmv_rows(off, col, w, x)
        p = K.spmv_rows_plain(off, col, w, x)
        torch.cuda.synchronize()
        hold("spmv_rows", form, "sum", k, again, p, errs, where, max_rel)
        err, rel, ok = sum_errors(k.cpu(), host_product(g, w, x))
        check(ok, f"spmv_rows{form} outside {SUM_RTOL} |ref| + {SUM_ATOL} "
                  f"of the float64 host product ({where}): max abs {err}")
        print(f"kernels: {where} spmv_rows{form}: max abs err {err:.6g}, "
              f"max rel err {rel:.6g} against the float64 host product")


def rows_stress_graph(device: str) -> tuple:
    """bench.py's SpMV graph at scale ROWS_STRESS_SCALE with the rows from
    ROWS_EMPTY_FROM on, ROWS_EMPTY_RUN of them, emptied, and a hub row of
    each length in ROWS_HUBS (in spmv_rows tiles) appended: a row that
    spans many tiles (more than the 32 that one look-back step reads) and
    a run of tiles that hold row ends only. Returns (csr, graph)."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    coo = generate.rmat(ROWS_STRESS_SCALE, EDGE_FACTOR, seed=SPMV_SEED,
                        undirected=False, weighted=True)
    keep = ((coo.row_indices < ROWS_EMPTY_FROM)
            | (coo.row_indices >= ROWS_EMPTY_FROM + ROWS_EMPTY_RUN))
    rows, cols, vals = ([coo.row_indices[keep]], [coo.col_indices[keep]],
                        [coo.values[keep]])
    for r, tiles in ROWS_HUBS:
        n = int(tiles * K.ROW_TILE)
        rows.append(np.full(n, r, np.int32))
        cols.append((np.arange(n) * 13 % coo.n_cols).astype(np.int32))
        vals.append(np.linspace(0.5, 1.5, n, dtype=np.float32))
    csr = Csr.from_coo(Coo(coo.n_rows, coo.n_cols, np.concatenate(rows),
                           np.concatenate(cols), np.concatenate(vals)))
    return csr, build_graph(csr, directed=True, weighted=True, device=device)


def check_pr_hits_rows(g, where: str, errs: dict) -> None:
    """spmv_rows at the inputs PageRank and HITS give it on ``g``: <mul>
    on PageRank's first spread, x = r * iweights with r = 1/V on the real
    vertices, and <none> on HITS' first half-step, x = the vertex mask.
    PageRank's sums are about 1e-6, where SUM_ATOL alone would pass any
    error, so these are also held to PR_HITS_MAX_REL."""
    from essentials_tpu_torch.algorithms import pr
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    mask = g.vertex_mask()
    r = torch.where(mask, 1.0 / g.n_vertices, 0.0).float()
    check_spmv_rows(g, ((edge_weights(g), r * pr.inverse_weights(g), "<mul>"),
                        (None, mask.float(), "<none>")), where, errs,
                    PR_HITS_MAX_REL)


def check_spmv_kernels(g, where: str, errs: dict) -> None:
    """Every SpMV kernel instance against its plain version on the same
    tensors, and against a second launch."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import spmv
    off, col, fl, w = g.row_offsets, g.col_indices, g.csr_seg_flags, g.values
    x = spmv.random_x(g, 1)
    check_spmv_rows(g, ((w, x, "<mul>"), (None, x, "<none>")), where, errs)
    for message in K.MESSAGES:
        wk = None if message == "none" else w
        for reduce in K.REDUCES:
            args = (off, col, wk, fl, x, message, reduce)
            y, again = K.spmv_slabs(*args), K.spmv_slabs(*args)
            plain = K.spmv_slabs_plain(*args)
            torch.cuda.synchronize()
            hold("spmv_slabs", f"<{message},{reduce}>", reduce, y, again,
                 plain, errs, where)


# ------------------------------------------------------------- phase 7 --

def counted(fn):
    """fn() with every launch count set to 0 just before it and read just
    after; each predecessor wrapper's range walk must have launched once
    per call of it. Returns (fn's result, the counts)."""
    from essentials_tpu_torch import kernels as K
    K.reset_launches()
    out = fn()
    torch.cuda.synchronize()
    check_range_walks()
    return out, dict(K.launches)


def check_range_walks() -> None:
    """Since the counts were last set to 0, each predecessor wrapper
    launched its range walk once a call."""
    from essentials_tpu_torch import kernels as K
    for name in ("bfs_predecessors", "sssp_predecessors"):
        check(K.pass_launches[name + "_ranges"] == K.launches[name],
              f"{name}: {K.pass_launches[name + '_ranges']} range walks "
              f"in {K.launches[name]} calls")


def hold_host(vec: np.ndarray, ref: np.ndarray, what: str, n: int) -> None:
    """A float32 result against its host reference, to the JAX package's
    test tolerances and to the tighter ones of HOST_TOLS."""
    check(vec.shape == (n,) and bool(np.all(np.isfinite(vec))),
          f"{what}: shape or non-finite values")
    for atol, rtol in HOST_TOLS[what.split()[0]]:
        check(np.allclose(vec, ref, atol=atol, rtol=rtol),
              f"{what} outside atol {atol}, rtol {rtol} of cpu_reference")
    print(f"main path: {what}: max abs err {np.abs(vec - ref).max():.6g} "
          f"against cpu_reference (within "
          + " and ".join(f"atol {a}, rtol {r}"
                         for a, r in HOST_TOLS[what.split()[0]]) + ")")


def spmv_main_path(csr_s, gs, csr_u, gu) -> dict:
    """spmv.run per variant on the SpMV graph, PageRank and HITS on the
    undirected graph: each path with the launch counts set to 0 just
    before it and read just after, which must be exactly the launches the
    path makes. Returns {path: {kernel: launches}}."""
    from essentials_tpu_torch.algorithms import hits, pr, spmv
    x = spmv.random_x(gs, 0)
    ys, by_path = {}, {}
    for v in ("fused", "windowed"):
        r, by_path[f"spmv {v}"] = counted(
            lambda v=v: spmv.run(gs, x, variant=v, warmup=False))
        ys[v] = r.y
    r_pr, by_path["pr"] = counted(
        lambda: pr.run(gu, variant="spmv", warmup=False))
    r_hits, by_path["hits"] = counted(
        lambda: hits.run(gu, variant="spmv", warmup=False))
    expect = {
        "spmv fused": {"spmv_rows": 1},
        "spmv windowed": {"spmv_slabs": 1},
        # one product per iteration, and one for the weight sums
        "pr": {"spmv_rows": r_pr.iterations + 1},
        "hits": {"spmv_rows": 2 * r_hits.iterations},
    }
    for path, launches in by_path.items():
        ran = {k: n for k, n in launches.items() if n}
        print(f"main path: {path} launches {ran}")
        check(ran == expect[path], f"{path} launched {ran}, expected "
                                   f"{expect[path]}")

    ref = torch.from_numpy(spmv.cpu_reference(csr_s, x.cpu().numpy()))
    for v, y in ys.items():
        y = y.cpu()
        check(y.shape == (gs.n_vertices,) and bool(y.isfinite().all()),
              f"spmv {v}: shape or non-finite values")
        err, _, ok = sum_errors(y, ref)
        check(ok, f"spmv {v} outside the sum tolerance of cpu_reference "
                  f"(max abs {err})")
        print(f"main path: spmv {v} rmat{SCALE} seed {SPMV_SEED}: max abs "
              f"err {err:.6g} against the float64 cpu_reference (within "
              f"{SUM_RTOL} |ref| + {SUM_ATOL})")
    err, _, ok = sum_errors(ys["fused"], ys["windowed"])
    check(ok, f"spmv fused and windowed disagree (max abs {err})")
    print(f"main path: spmv fused against windowed: max abs err {err:.6g}")

    ref_pr, it_pr = pr.cpu_run(csr_u)
    hold_host(r_pr.ranks.cpu().numpy(), ref_pr,
              f"pr spmv undirected rmat{SCALE}", gu.n_vertices)
    print(f"main path: pr spmv undirected rmat{SCALE}: {r_pr.iterations} "
          f"iterations (host float64: {it_pr})")
    ref_a, ref_h, it_h = hits.cpu_run(csr_u)
    hold_host(r_hits.auth.cpu().numpy(), ref_a, "hits spmv auth",
              gu.n_vertices)
    hold_host(r_hits.hub.cpu().numpy(), ref_h, "hits spmv hub",
              gu.n_vertices)
    print(f"main path: hits spmv undirected rmat{SCALE}: "
          f"{r_hits.iterations} iterations (host float64: {it_h})")
    return by_path


# ------------------------------------------------------------- phase 8 --

def time_spmv(g, card: str, label: str) -> None:
    """Each SpMV variant's product, SPMV_REPS back to back per cycle."""
    from essentials_tpu_torch.algorithms import spmv
    x = spmv.random_x(g, 0)
    for v, fn in spmv.VARIANTS.items():
        ms = median_ms(lambda _: [fn(g, x) for _ in range(SPMV_REPS)]) \
            / SPMV_REPS
        print(f"time [{card}]: spmv {v} {label}: {ms:.4f} ms per product, "
              f"{g.n_edges * BYTES_PER_EDGE / ms / 1e6:.2f} GB/s under "
              f"bench.py's {BYTES_PER_EDGE:.0f} B/edge model (median of "
              f"{CYCLES} cycles of {SPMV_REPS})")


def time_spmv_kernels(g) -> dict:
    """Every SpMV kernel instance and its plain version at the shapes of
    the scale-18 SpMV graph, SPMV_REPS calls back to back per cycle."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import spmv
    off, col, fl, w = g.row_offsets, g.col_indices, g.csr_seg_flags, g.values
    x = spmv.random_x(g, 1)

    def per_call(fn) -> float:
        return median_ms(lambda _: [fn() for _ in range(SPMV_REPS)]) \
            / SPMV_REPS

    out = {}
    for wk, form in ((w, "<mul>"), (None, "<none>")):
        out["spmv_rows" + form] = per_call(
            lambda: K.spmv_rows(off, col, wk, x))
        out["spmv_rows" + form + "/plain"] = per_call(
            lambda: K.spmv_rows_plain(off, col, wk, x))
    for message in K.MESSAGES:
        wk = None if message == "none" else w
        for reduce in K.REDUCES:
            form = f"<{message},{reduce}>"
            args = (off, col, wk, fl, x, message, reduce)
            out["spmv_slabs" + form] = per_call(lambda: K.spmv_slabs(*args))
            out["spmv_slabs" + form + "/plain"] = per_call(
                lambda: K.spmv_slabs_plain(*args))
    for k, v in rows_against_mv(g, w, x).items():
        if k:                        # its wall time is measured above
            out["spmv_rows<mul>" + k] = v
    for k, v in slabs_against_mv(g, x).items():
        out["spmv_slabs<mul,sum>" + k] = v
    return out


def rows_against_mv(g, w, x) -> dict:
    """spmv_rows on ``g`` (<none> where ``w`` is None) beside torch.mv on
    the same sparse CSR matrix (every weight 1 under <none>), which
    computes the same product: each one's wall time per call (SPMV_REPS
    calls back to back) and device time per call (torch.profiler, the
    zeroing of the kernel's status words included), and the kernel's
    bound. Keys: "" (the wall ms), /device, /device_rows, /library,
    /library_device, /bound."""
    from essentials_tpu_torch import kernels as K
    off, col = g.row_offsets, g.col_indices
    vp, ep, e = g.n_vertices_padded, g.n_edges_padded, g.n_edges
    out = {"": median_ms(lambda _: [K.spmv_rows(off, col, w, x)
                                    for _ in range(SPMV_REPS)]) / SPMV_REPS}
    out["/device"], out["/device_rows"] = device_ms(
        lambda: K.spmv_rows(off, col, w, x), SPMV_REPS)
    a = torch.sparse_csr_tensor(off, col, torch.ones(ep, device=x.device)
                                if w is None else w, size=(vp, vp))
    out["/library"] = library_ms("spmv_rows (torch.mv on a sparse CSR "
                                 "tensor)", lambda: torch.mv(a, x), SPMV_REPS)
    out["/library_device"] = (None if out["/library"] is None else
                              device_ms(lambda: torch.mv(a, x), SPMV_REPS)[0])
    # offsets, columns, weights, x read; y written; a product and a sum
    # per edge (a sum without weights)
    weighted = w is not None
    out["/bound"] = bound(4 * (vp + 1) + (8 if weighted else 4) * ep
                          + 8 * vp, (2 if weighted else 1) * e)
    return out


def slabs_against_mv(g, x) -> dict:
    """spmv_slabs<mul,sum> on ``g`` beside torch.mv on the same sparse CSR
    matrix, which computes the same product: each one's wall time per call
    (SPMV_REPS calls back to back) and device time per call (torch.profiler,
    the zeroing of the kernel's hand-off words included), and the kernel's
    bound; and the device time of both with every column 0, where each x
    gather hits one address: the time without the cost of the scattered
    gathers. Keys: "" (the wall ms), /device, /device_rows, /library,
    /library_device, /bound, /one_column_device,
    /library_one_column_device."""
    from essentials_tpu_torch import kernels as K
    off, col, fl, w = g.row_offsets, g.col_indices, g.csr_seg_flags, g.values
    vp, ep, e = g.n_vertices_padded, g.n_edges_padded, g.n_edges
    args = (off, col, w, fl, x, "mul", "sum")
    out = {"": median_ms(lambda _: [K.spmv_slabs(*args)
                                    for _ in range(SPMV_REPS)]) / SPMV_REPS}
    out["/device"], out["/device_rows"] = device_ms(
        lambda: K.spmv_slabs(*args), SPMV_REPS)
    a = torch.sparse_csr_tensor(off, col, w, size=(vp, vp))
    out["/library"] = library_ms("spmv_slabs (torch.mv on a sparse CSR "
                                 "tensor)", lambda: torch.mv(a, x), SPMV_REPS)
    out["/library_device"] = (None if out["/library"] is None else
                              device_ms(lambda: torch.mv(a, x), SPMV_REPS)[0])
    # offsets, columns, weights, flags, x read; y written; 2 flops per edge
    out["/bound"] = bound(4 * (vp + 1) + 9 * ep + 8 * vp, 2 * e)
    zero = torch.zeros_like(col)
    out["/one_column_device"] = device_ms(
        lambda: K.spmv_slabs(off, zero, w, fl, x, "mul", "sum"),
        SPMV_REPS)[0]
    a0 = torch.sparse_csr_tensor(off, zero, w, size=(vp, vp))
    out["/library_one_column_device"] = (
        None if out["/library"] is None else
        device_ms(lambda: torch.mv(a0, x), SPMV_REPS)[0])
    return out


def print_against_mv(card: str, where: str, t: dict, key: str) -> None:
    """A kernel's wall and device time per call beside torch.mv's, from
    the keys of rows_against_mv or slabs_against_mv under ``key``."""
    b, lib, lib_dev = t[key + "/bound"], t[key + "/library"], \
        t[key + "/library_device"]
    print(f"time [{card}]: {key} {where}: {t[key]:.4f} ms per call (wall, "
          f"{SPMV_REPS} back to back); bound {b[0]:.4f} ms ({b[1]} at "
          f"{b[2]} rate); torch.mv "
          + ("not measured" if lib is None else
             f"{lib:.4f} ms per call, device "
             + ("not measured" if lib_dev is None else f"{lib_dev:.4f} ms")))
    print_device(card, f"{key} {where}", t[key + "/device"],
                 t[key + "/device_rows"])
    if key + "/one_column_device" not in t:
        return
    one, lib_one = (t[key + "/one_column_device"],
                    t[key + "/library_one_column_device"])
    print(f"time [{card}]: {key} {where} with every column 0 (each x gather "
          f"from one address): "
          + ("not measured" if one is None else f"{one:.4f} ms")
          + " of device time per call; torch.mv "
          + ("not measured" if lib_one is None else f"{lib_one:.4f} ms"))


def pr_hits_ms(g) -> dict:
    """PageRank's and HITS' ms per iteration on ``g`` (variant "spmv"), one
    run each, each after its warm-up run: {"pr": ms, "hits": ms}."""
    from essentials_tpu_torch.algorithms import hits, pr
    out = {}
    for name, fn in (("pr", pr.run), ("hits", hits.run)):
        r = fn(g, variant="spmv")
        out[name] = r.elapsed_ms / r.iterations
    return out


def time_pr_hits(g, card: str) -> None:
    """PageRank's and HITS' ms per iteration over CYCLES runs each: host
    paced, so they spread from run to run."""
    runs = [pr_hits_ms(g) for _ in range(CYCLES)]
    for name in ("pr", "hits"):
        ms = sorted(r[name] for r in runs)
        print(f"time [{card}]: {name} spmv undirected rmat{SCALE}: "
              f"{ms[len(ms) // 2]:.4f} ms per iteration (median of "
              f"{CYCLES} runs, each after its warm-up run; spread "
              f"{ms[0]:.4f}-{ms[-1]:.4f})")


# ------------------------------------------------------------- phase 9 --

def weighted_graph(scale: int, device: str):
    """The weighted undirected RMAT graph of ``scale`` (edge factor 16,
    seed 1); at scale 20 the suite's gen:rmat20x16."""
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    t0 = time.perf_counter()
    csr = Csr.from_coo(generate.rmat(scale, EDGE_FACTOR, seed=SEED,
                                     undirected=True, weighted=True))
    g = build_graph(csr, directed=False, weighted=True, device=device)
    deg = np.diff(csr.row_offsets)
    print(f"graph: rmat{scale} ef{EDGE_FACTOR} seed {SEED} undirected "
          f"weighted: V={g.n_vertices} E={g.n_edges} Vp={g.n_vertices_padded} "
          f"Ep={g.n_edges_padded}, max degree {int(deg.max())}, "
          f"{int((deg == 0).sum())} isolated, built in "
          f"{time.perf_counter() - t0:.1f} s")
    return csr, g


KCORE_STRESS = (3000, 16, 1200, 300)   # vertices, edges a vertex, hub, doubled


def kcore_stress_coo(seed: int = SEED) -> tuple:
    """A symmetric multigraph: (n, src, dst, weights). Random pairs among
    n vertices, vertex 0 joined to a hub's worth of others, some pairs
    twice, self-loops at 5 and 17; every edge with its reverse (a self-loop
    once), weights from the seed."""
    rng = np.random.default_rng(seed)
    n, per, hub, doubled = KCORE_STRESS
    a = rng.integers(0, n, n * per // 2)
    b = rng.integers(0, n, n * per // 2)
    a, b = a[a != b], b[a != b]
    twice = rng.integers(0, a.size, doubled)
    a = np.concatenate([a, np.zeros(hub, np.int64), a[twice]])
    b = np.concatenate([b, rng.choice(np.arange(1, n), hub, replace=False),
                        b[twice]])
    loops = np.array([5, 17])
    src = np.concatenate([a, b, loops]).astype(np.int32)
    dst = np.concatenate([b, a, loops]).astype(np.int32)
    return n, src, dst, rng.random(src.size).astype(np.float32) + 0.5


BALANCED = (200_000, 8, 3000)   # vertices, cycles through all, hub triangles


def cycles_coo(n: int, lengths, seed: int, hub: int = 0) -> tuple:
    """A degree-balanced directed graph on n vertices: (n, src, dst,
    weights). One directed cycle over a seeded choice of vertices for each
    of ``lengths``, and vertex 0 a hub on ``hub`` directed triangles 0 -> a
    -> b -> 0; every in-degree equals its out-degree (a symmetric layout),
    but the edges are not symmetric, so a push along the CSC sources
    instead of the CSR columns goes wrong here. Weights in [1, 64) from
    the seed."""
    rng = np.random.default_rng(seed)
    src, dst = [], []
    for m in lengths:
        c = rng.permutation(n)[:m]
        src.append(c)
        dst.append(np.roll(c, -1))
    a, b = rng.choice(np.arange(1, n), (2, hub), replace=False)
    src += [np.zeros(hub, np.int64), a, b]
    dst += [a, b, np.zeros(hub, np.int64)]
    src, dst = np.concatenate(src), np.concatenate(dst)
    return (n, src.astype(np.int32), dst.astype(np.int32),
            (rng.random(src.size) * 63 + 1).astype(np.float32))


def balanced_coo(n: int = BALANCED[0]) -> tuple:
    """cycles_coo with BALANCED[1] cycles through all n vertices and a hub
    on BALANCED[2] triangles."""
    _, cycles, hub = BALANCED
    return cycles_coo(n, (n,) * cycles, SEED, hub)


def balanced_graph(device: str) -> tuple:
    """balanced_coo's graph: (csr, graph), directed and weighted."""
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    n, src, dst, w = balanced_coo()
    csr = Csr.from_coo(Coo(n, n, src, dst, w))
    g = build_graph(csr, directed=True, weighted=True, device=device)
    check(g.symmetric_layout and not torch.equal(g.col_indices,
                                                 g.csc_src_indices),
          "the degree-balanced graph must have a symmetric layout and an "
          "asymmetric adjacency")
    return csr, g


def kcore_stress_graph(device: str) -> tuple:
    """kcore_stress_coo's graph: (csr, graph), undirected and weighted."""
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    n, src, dst, w = kcore_stress_coo()
    csr = Csr.from_coo(Coo(n, n, src, dst, w))
    return csr, build_graph(csr, directed=False, weighted=True, device=device)


def hold_exact(name: str, ks, agains, plains, errs: dict, where: str) -> None:
    """Each kernel output (int32) against a second launch's and the plain
    version's, bitwise."""
    torch.cuda.synchronize()
    for k, again, p in zip(ks, agains, plains):
        check(torch.equal(k, again), f"{name} gives other bits on a second "
                                     f"launch ({where})")
        e = max_err(k, p)
        errs[name] = max(errs[name], e)
        check(e == 0, f"{name} differs from plain ({where})")


def sssp_sweep_states(g, source: int) -> list:
    """The inputs of every sweep of one fused search from ``source``:
    [(dist_in, the output buffer's distances before the sweep)], the
    search going on from the kernel's outputs; the last sweep improves
    nothing."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_sssp as FS
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    args = (g.row_offsets, g.col_indices, edge_weights(g))
    d, prev, states = FS.init_dist_exp(g, source), FS.init_spare(g), []
    while True:
        states.append((d, prev))
        out = prev.clone()
        if K.sssp_sweep(d, out, *args).item() == 0:
            return states
        d, prev = out, d


def kcore_wave(g, state, k: int, n_in: int, cand_in, cand_out, scratch,
               plain: bool = False):
    """One k-core wave in place on ``state`` (deg, core): a cascade at k
    from the ``n_in`` vertices of ``cand_in`` where n_in > 0, else a level
    wave; the kernel, or its plain version. Returns its scalars tensor
    (peeled, candidates listed, ranges listed, k)."""
    from essentials_tpu_torch import kernels as K
    adj = (g.row_offsets, g.csc_src_indices, g.col_indices)
    if n_in:
        fn = K.kcore_cascade_wave_plain if plain else K.kcore_cascade_wave
        return fn(*state, *adj, k, cand_in, n_in, cand_out, scratch)
    fn = K.kcore_level_wave_plain if plain else K.kcore_level_wave
    return fn(*state, *adj, cand_out, scratch)


def kcore_run_waves(g):
    """Every wave of one fused k-core run on the kernels, yielded before it
    runs as (wrapper name, (deg, core), k, n_in, cand_in), all copies the
    caller may keep or run on; the run then goes on from the kernels'
    outputs (kcore_wave)."""
    from essentials_tpu_torch.ops import fused_kcore as FK
    deg = FK.init_deg_exp(g)
    core = torch.zeros_like(deg)
    cand_in, cand_out, scratch = FK.wave_buffers(g)
    n_in, k, alive = 0, 0, FK.alive_vertices(g)
    while alive:
        name = "kcore_cascade_wave" if n_in else "kcore_level_wave"
        yield name, (deg.clone(), core.clone()), k, n_in, cand_in.clone()
        peeled, n_out, _, k = kcore_wave(g, (deg, core), k, n_in, cand_in,
                                         cand_out, scratch).tolist()
        cand_in, cand_out, n_in = cand_out, cand_in, n_out
        alive -= peeled


def hold_kcore_waves(g, errs: dict, where: str) -> tuple:
    """Every wave of one fused k-core run (kcore_run_waves): the kernel
    twice and its plain version once, each from the wave's state; the
    state, the scalars and the candidate set (sorted: the card lists in
    any order) bitwise. Returns (waves, levels, the core numbers on the
    edge axis after the last wave)."""
    from essentials_tpu_torch.ops import fused_kcore as FK
    waves = levels = 0
    core = None
    for name, state, k, n_in, cand in kcore_run_waves(g):
        got = []
        for plain in (False, False, True):
            st = tuple(t.clone() for t in state)
            out, _, scratch = FK.wave_buffers(g)
            s = kcore_wave(g, st, k, n_in, cand, out, scratch, plain)
            got.append((*st, s, out[:int(s[1])].sort().values))
        hold_exact(name, *got, errs, f"{where} wave {waves}, k {k}")
        waves, levels, core = waves + 1, levels + (not n_in), got[0][1]
    return waves, levels, core


def check_sssp_kcore_kernels(csr, g, where: str, errs: dict) -> None:
    """Every sweep of one SSSP search from the highest-degree vertex and
    every wave of one k-core run (its initial expansion included), each
    kernel launched twice and its plain version once on the same input
    (each sweep's output buffer holding the sweep before's distances, as
    in a search); the search goes on from the kernel's output."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_kcore as FK
    from essentials_tpu_torch.ops import fused_sssp as FS
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    off, src, col = g.row_offsets, g.csc_src_indices, g.col_indices
    w = edge_weights(g)
    source = int(np.argmax(np.diff(csr.row_offsets)))
    d, prev, sweeps = FS.init_dist_exp(g, source), FS.init_spare(g), 0
    while True:
        outs = [prev.clone() for _ in range(3)]
        cnt = [K.sssp_sweep(d, o, off, col, w) for o in outs[:2]]
        cnt_p = K.sssp_sweep_plain(d, outs[2], off, col, w)
        hold_exact("sssp_sweep", (outs[0], cnt[0]), (outs[1], cnt[1]),
                   (outs[2], cnt_p), errs, f"{where} sweep {sweeps}")
        d, prev, sweeps = outs[0], d, sweeps + 1
        if cnt[0].item() == 0:
            break
    args = (d, off, FS.INF_BITS, source)
    dist = K.collapse_starts(*args)
    hold_exact("collapse_starts", (dist,), (K.collapse_starts(*args),),
               (K.collapse_starts_plain(*args),), errs, f"{where} sssp")
    args = (dist.view(torch.float32), g.csc_offsets, src, FS.csc_weights(g),
            g.n_edges)
    pred = K.sssp_predecessors(*args)
    hold_exact("sssp_predecessors", (pred,), (K.sssp_predecessors(*args),),
               (K.sssp_predecessors_plain(*args),), errs, where)
    args = (torch.where(g.vertex_mask(), g.out_degrees(), -1).int(), off,
            g.n_edges_padded)
    deg = FK.init_deg_exp(g)
    hold_exact("expand_segments", (deg,), (K.expand_segments(*args),),
               (K.expand_segments_plain(*args),), errs, f"{where} kcore")
    waves, _, core = hold_kcore_waves(g, errs, where)
    args = (core, off, 0)
    hold_exact("collapse_starts", (K.collapse_starts(*args),),
               (K.collapse_starts(*args),), (K.collapse_starts_plain(*args),),
               errs, f"{where} kcore")
    print(f"kernels: {where}: sssp from {source}: {sweeps} sweeps, "
          f"{int(torch.isfinite(dist.view(torch.float32)).sum())} reached, "
          f"{int((pred >= 0).sum())} predecessors; kcore: {waves} waves; "
          f"every kernel exact against plain and repeatable")


def starts_stress_offsets(tile: int, seed: int = SEED) -> np.ndarray:
    """expand_segments' and collapse_starts' stress offsets ([Vp+1] int32
    from 0), cut for tiles of ``tile`` merge places (segment v's end at
    place offsets[v+1] + v). The segments in order: 300 of 0-40 slots; a
    run of STARTS_EMPTY_RUN empty ones across a tile edge (from 300 places
    before it); a hub of STARTS_HUB_TILES tiles of slots; 200 short; one
    whose end is the last place of a tile; 50 short; one whose end is the
    first place of a tile; 101 of 0-9 slots; then short ones until Vp % 8
    is 5, the last one cut so that n % 4 is 3."""
    rng = np.random.default_rng(seed)
    lens: list[int] = []

    def place() -> int:                     # places the segments take
        return sum(lens) + len(lens)

    def end_at(d: int) -> None:             # one segment, its end at d
        lens.append(d - place())

    def edge_past(margin: int) -> int:      # the first tile edge past
        return (place() + margin) // tile * tile + tile   # place() + margin

    lens += rng.integers(0, 41, 300).tolist()
    end_at(edge_past(STARTS_EMPTY_RUN) - 301)
    lens += [0] * STARTS_EMPTY_RUN
    lens.append(int(STARTS_HUB_TILES * tile))
    lens += rng.integers(0, 41, 200).tolist()
    end_at(edge_past(10) - 1)
    lens += rng.integers(0, 41, 50).tolist()
    end_at(edge_past(10))
    lens += rng.integers(0, 10, 101).tolist()
    while len(lens) % 8 != 5:
        lens.append(int(rng.integers(4, 41)))
    lens[-1] += (3 - sum(lens)) % 4
    return np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)


def starts_cases(device, tile: int, seed: int = SEED) -> list:
    """(what, vals [Vp] int32, offsets [Vp+1] int32, exp [n + 5] int32,
    collapse sources) for expand_segments (n = offsets[-1]) and
    collapse_starts, values from ``seed``: the stress offsets
    (starts_stress_offsets), also as a view from element 1 of a longer
    array (4-byte aligned only), n = 0 over 1,000 empty segments, and n =
    0 over no segment. The sources: none (-1), the first empty segment,
    the hub, the last vertex."""
    rng = np.random.default_rng(seed)
    off = starts_stress_offsets(tile, seed)
    shifted = torch.from_numpy(np.concatenate([[7], off]).astype(
        np.int32)).to(device)[1:]
    cases = []
    for what, o in (("the stress offsets", torch.from_numpy(off)),
                    ("the stress offsets from a 4-byte offset", shifted),
                    ("n = 0, 1000 empty segments",
                     torch.zeros(1001, dtype=torch.int32)),
                    ("n = 0, no segment", torch.zeros(1, dtype=torch.int32))):
        o = o.to(device)
        lens = np.diff(o.cpu().numpy())
        vp, n = lens.size, int(o[-1])
        empty = np.flatnonzero(lens == 0)
        sources = list(dict.fromkeys([-1] + (
            [int(empty[0])] if empty.size else []) + (
            [int(np.argmax(lens)), vp - 1] if vp else [])))
        vals, exp = (torch.from_numpy(rng.integers(
            -2**31, 2**31, k, dtype=np.int64).astype(np.int32)).to(device)
            for k in (vp, n + 5))
        cases.append((what, vals, o, exp, sources))
    return cases


def starts_levels(exp: torch.Tensor) -> dict:
    """collapse_levels' level arrays made from a starts case's seeded
    ``exp``, by form: (levels, unreached), the sentinel at about a quarter
    of the slots (int32: 0-65,535 and INT32_MAX; int8: 0-63 and 127)."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    gone = exp % 4 == 0
    return {"int32": (torch.where(gone, K.INT32_MAX, exp & 0xFFFF),
                      FB.UNREACHED),
            "int8": (torch.where(gone, FB.UNREACHED_E, exp & 63).to(
                torch.int8), FB.UNREACHED_E)}


def check_starts_shapes(errs: dict) -> None:
    """expand_segments, collapse_starts and collapse_levels (int32, int8)
    on starts_cases (a hub of more than three tiles, an empty run across a
    tile edge, segments ending at a tile's last and first places, n and Vp
    not multiples of 4, offsets at a 4-byte offset, n = 0), each against
    its plain version exactly and a second launch bitwise; collapse_starts
    at every source of each, collapse_levels at every source in [0, Vp)."""
    from essentials_tpu_torch import kernels as K
    for what, vals, off, exp, sources in starts_cases("cuda", K.EXPAND_TILE):
        n = int(off[-1])
        args = (vals, off, n)
        hold_exact("expand_segments", (K.expand_segments(*args),),
                   (K.expand_segments(*args),),
                   (K.expand_segments_plain(*args),), errs, what)
        for source in sources:
            args = (exp, off, K.INF_BITS, source)
            hold_exact("collapse_starts", (K.collapse_starts(*args),),
                       (K.collapse_starts(*args),),
                       (K.collapse_starts_plain(*args),), errs,
                       f"{what}, source {source}")
        vp = off.numel() - 1
        for form, (lev, unreached) in starts_levels(exp).items():
            for source in (v for v in sources if 0 <= v < vp):
                args = (lev, off, source, unreached)
                hold_exact(f"collapse_levels<{form}>",
                           (K.collapse_levels(*args),),
                           (K.collapse_levels(*args),),
                           (K.collapse_levels_plain(*args),), errs,
                           f"{what}, source {source}")
        print(f"kernels: expand_segments, collapse_starts and "
              f"collapse_levels (int32, int8) on {what} (Vp {vp}, n {n}, "
              f"sources {sources}): exact against plain and repeatable")


def check_kcore_launches(g, where: str) -> None:
    """A level wave is three device kernels (the minimum, the peel and the
    push) and a cascade two (the mark and the push), on the run's first
    and last wave of each kind, each call from a copy of the wave's state,
    as torch.profiler sees them; fails where a kind was measured on no
    wave."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_kcore as FK
    first, last = {}, {}
    for i, wave in enumerate(kcore_run_waves(g)):
        first.setdefault(wave[0], (i, *wave[1:]))
        last[wave[0]] = (i, *wave[1:])
    out, _, scratch = FK.wave_buffers(g)
    for name in ("kcore_level_wave", "kcore_cascade_wave"):
        want = K.device_kernels(name)
        waves = {w[0]: w for w in (first[name], last[name])}
        measured = sum(check_one_launch(
            name, lambda w=w: kcore_wave(
                g, tuple(t.clone() for t in w[1]), *w[2:], out, scratch),
            f"{where} wave {i}", want) for i, w in waves.items())
        check(measured > 0, f"{name} {where}: launches per call measured "
                            f"on no wave")
        print(f"kernels: {name} {where}: {len(want)} device kernels a call "
              f"on {measured} of {len(waves)} waves measured")


def check_sssp_launches(g, source: int, where: str) -> None:
    """One sssp_sweep call is three device kernels, its dense pass, its
    push and its update, on the first sweep of a search from ``source`` and
    on its heaviest (the most vertices changed), as torch.profiler sees
    them; fails where neither form was measured."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    args = (g.row_offsets, g.col_indices, edge_weights(g))
    states = sssp_sweep_states(g, source)
    off = g.row_offsets
    starts = off[:-1][off[1:] > off[:-1]].long()
    heavy = max(range(len(states)), key=lambda i: int(
        (states[i][0][starts] != states[i][1][starts]).sum()))
    out = torch.empty_like(states[0][0])

    def sweep(d, prev):
        out.copy_(prev)
        K.sssp_sweep(d, out, *args)
    measured = sum(check_one_launch(
        "sssp_sweep", lambda st=states[i]: sweep(*st), f"{where} sweep {i}",
        K.device_kernels("sssp_sweep")) for i in sorted({0, heavy}))
    check(measured > 0, f"sssp_sweep {where}: launches per call measured "
                        f"on no sweep")
    print(f"kernels: sssp_sweep {where}: three device kernels a call (dense "
          f"pass, push, update) on {measured} of {len({0, heavy})} sweeps "
          f"measured")


# ------------------------------------------------------------ phase 10 --

def check_windowed_sssp_kernels(g, source: int, where: str,
                                errs: dict) -> list:
    """spmv_slabs<add,min> at every sweep of one windowed SSSP search from
    ``source``, on the inputs the search gives it (distances that are +inf
    but for those reached), launched twice and its plain version once,
    exactly; the search goes on from the kernel's output. Returns each
    sweep's input distances."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    off, col, fl, w = (g.row_offsets, g.col_indices, g.csr_seg_flags,
                       edge_weights(g))
    dist = torch.full((g.n_vertices_padded,), K.INF_BITS, dtype=torch.int32,
                      device=g.device)
    dist[source] = 0
    states = []
    while True:
        states.append(dist)
        args = (off, col, w, fl, dist.view(torch.float32), "add", "min")
        cand = K.spmv_slabs(*args)
        hold_exact("spmv_slabs", (cand,), (K.spmv_slabs(*args),),
                   (K.spmv_slabs_plain(*args),), errs,
                   f"{where} windowed sweep {len(states) - 1}")
        improved = cand < dist
        dist = torch.where(improved, cand, dist)
        if not bool(improved.any()):
            return states


def time_windowed_sweeps(g, states, card: str) -> dict:
    """spmv_slabs<add,min> per sweep of the windowed search whose input
    distances are ``states``: the wall time per call summed over the sweeps
    (each SPMV_REPS calls back to back), the device time of one pass over
    the sweeps (torch.profiler), each over the sweeps, beside one sweep's
    bound."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    off, col, fl, w = (g.row_offsets, g.col_indices, g.csr_seg_flags,
                       edge_weights(g))
    calls = [(off, col, w, fl, d.view(torch.float32), "add", "min")
             for d in states]
    n = len(calls)
    wall = sum(median_ms(lambda _, a=a: [K.spmv_slabs(*a)
                                         for _ in range(SPMV_REPS)])
               for a in calls) / SPMV_REPS / n
    dev, rows = device_ms(lambda: [K.spmv_slabs(*a) for a in calls], 1)
    vp, ep, e = g.n_vertices_padded, g.n_edges_padded, g.n_edges
    # offsets, columns, weights, flags, distances read; candidates
    # written; one float addition per edge
    b = bound(4 * (vp + 1) + 9 * ep + 8 * vp, e)
    print(f"time [{card}]: spmv_slabs<add,min> gen:rmat{MAIN_SCALE}x16: "
          f"{wall:.4f} ms per sweep (wall, mean over the {n} sweeps of one "
          f"search, {SPMV_REPS} calls back to back each); bound {b[0]:.4f} "
          f"ms ({b[1]} at {b[2]} rate)")
    print_device(card, f"spmv_slabs<add,min> gen:rmat{MAIN_SCALE}x16, the "
                       f"{n} sweeps of one search", dev, rows)
    return {"spmv_slabs<add,min>/sweep": wall,
            "spmv_slabs<add,min>/sweep_device": None if dev is None
            else dev / n, "spmv_slabs<add,min>/sweep_bound": b}


def host_dijkstra(csr, source: int) -> np.ndarray:
    """float64 host Dijkstra (scipy.sparse.csgraph)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import dijkstra
    n = csr.n_rows
    a = csr_matrix((np.asarray(csr.values, np.float64), csr.col_indices,
                    csr.row_offsets), shape=(n, n))
    return dijkstra(a, directed=True, indices=source)


class HostCsc:
    """The CSC order of ``csr`` (sorted by dst, then src), built on the
    host, for checking predecessors."""

    def __init__(self, csr):
        n = csr.n_rows
        src = np.repeat(np.arange(n), np.diff(csr.row_offsets))
        order = np.lexsort((src, csr.col_indices))
        self.s, self.d = src[order], csr.col_indices[order]
        self.w = np.asarray(csr.values, np.float32)[order]

    def sssp_predecessors(self, dist: np.ndarray) -> np.ndarray:
        """Smallest-id in-neighbour whose float32 distance plus the edge's
        weight is the vertex's distance; -1 unless that is finite and above
        0."""
        ok = (dist[self.s] + self.w) == dist[self.d]
        pred = np.full(dist.size, -1, np.int64)
        v, first = np.unique(self.d[ok], return_index=True)
        pred[v] = self.s[ok][first]
        pred[~(np.isfinite(dist) & (dist > 0))] = -1
        return pred


def sssp_kcore_main_path(csr, g) -> tuple:
    """SSSP (both variants, SSSP_RUNS sources), k-core and one BFS on the
    rmat20 graph, each run with the launch counts set to 0 just before it
    and read just after, which must be exactly the launches it makes.
    Returns ({path: {kernel: launches summed over its runs}}, the sources,
    {variant: the SSSP results})."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import bfs, kcore, sssp
    sources = np.argsort(-np.diff(csr.row_offsets))[:SSSP_RUNS].astype(int)
    by_path, runs = {}, {}

    def run_counted(path: str, fn, expect):
        r, launches = counted(fn)
        ran = {k: n for k, n in launches.items() if n}
        check(ran == expect(r), f"{path} launched {ran}, expected "
                                f"{expect(r)}")
        total = by_path.setdefault(path, dict.fromkeys(K.launches, 0))
        for k, n in launches.items():
            total[k] += n
        return r

    expect = {
        "fused": lambda r: {"sssp_sweep": r.iterations, "collapse_starts": 1,
                            "sssp_predecessors": 1},
        "windowed": lambda r: {"spmv_slabs": r.iterations,
                               "sssp_predecessors": 1},
    }
    for v in sssp.VARIANTS:
        runs[v] = [run_counted(f"sssp {v}", lambda s=s, v=v: sssp.run(
            g, int(s), variant=v, warmup=False), expect[v]) for s in sources]
        ran = {k: n for k, n in by_path[f"sssp {v}"].items() if n}
        print(f"main path: sssp {v} rmat{MAIN_SCALE}: sweeps per source "
              f"{[r.iterations for r in runs[v]]} (TPU history: "
              f"{TPU_HISTORY['sssp']}); launches over {SSSP_RUNS} runs {ran}, "
              f"exact per run")
    host_csc = HostCsc(csr)
    for i, s in enumerate(sources):
        rf, rw = runs["fused"][i], runs["windowed"][i]
        d = rf.distances.cpu().numpy()
        p = rf.predecessors.cpu().numpy()
        check(d.shape == p.shape == (g.n_vertices,), "result shapes")
        check(np.array_equal(d.view(np.int32),
                             rw.distances.cpu().numpy().view(np.int32))
              and np.array_equal(p, rw.predecessors.cpu().numpy())
              and rf.iterations == rw.iterations,
              f"sssp fused and windowed disagree from source {s}")
        check(d[s] == 0 and bool(np.all(d >= 0)),
              f"sssp distances from source {s}: source not 0 or negative")
        check(np.array_equal(p, host_csc.sssp_predecessors(d)),
              f"sssp predecessors from source {s} are not the smallest-id "
              f"in-neighbours that achieve the distance")
        if i < DIJKSTRA_SOURCES:
            ref = host_dijkstra(csr, int(s))
            reach = np.isfinite(ref)
            check(np.array_equal(np.isfinite(d), reach),
                  f"sssp reach set from source {s} differs from Dijkstra")
            rel = float(np.max(np.abs(d[reach] - ref[reach])
                               / np.maximum(ref[reach], 1e-300)))
            check(rel <= SSSP_RTOL, f"sssp from source {s}: max rel err "
                                    f"{rel} against Dijkstra")
            print(f"main path: sssp from source {s}: {int(reach.sum())} "
                  f"reached, max rel err {rel:.3g} against the float64 host "
                  f"Dijkstra (rtol {SSSP_RTOL}), reach set exact")
    print(f"main path: sssp fused == windowed bitwise with equal sweeps, "
          f"predecessors of all {SSSP_RUNS} sources valid and smallest-id")

    rk = run_counted("kcore", lambda: kcore.run(g, warmup=False),
                     lambda r: {"expand_segments": 1,
                                "kcore_level_wave": K.counters[
                                    "kcore.levels"],
                                "kcore_cascade_wave": K.counters[
                                    "kcore.waves"] - K.counters[
                                    "kcore.levels"],
                                "collapse_starts": 1})
    check(K.counters["kcore.waves"] == rk.iterations
          > K.counters["kcore.levels"] > 0,
          f"kcore: {rk.iterations} waves, {K.counters['kcore.waves']} "
          f"counted, {K.counters['kcore.levels']} levels")
    core = rk.core.cpu().numpy()
    check(np.array_equal(core, kcore.cpu_reference(csr)),
          "kcore core numbers differ from the host peeling")
    print(f"main path: kcore rmat{MAIN_SCALE}: {rk.iterations} waves (TPU "
          f"history: {TPU_HISTORY['kcore']}), max core {int(core.max())}, "
          f"equal to the host peeling; launches exact")

    s = int(sources[0])
    rb = run_counted(f"bfs rmat{MAIN_SCALE}",
                     lambda: bfs.run(g, s, variant="fused", warmup=False),
                     lambda r: {"bfs_level<int32>": r.iterations,
                                "collapse_levels<int32>": 1,
                                "bfs_predecessors": 1})
    check(np.array_equal(rb.distances.cpu().numpy(),
                         bfs.cpu_reference(csr, s)),
          f"bfs distances at rmat{MAIN_SCALE} differ from cpu_reference")
    print(f"main path: bfs fused rmat{MAIN_SCALE} from {s}: "
          f"{rb.iterations} levels (TPU history: {TPU_HISTORY['bfs']}), "
          f"distances equal cpu_reference; launches exact")
    return by_path, sources, runs


# ------------------------------------------------------------ phase 11 --

def time_sssp_kcore(g, sources, runs, card: str) -> None:
    """ms per search per SSSP variant over the sources (what sssp.run's
    elapsed_ms covers: sweeps and collapse), and ms per k-core run."""
    from essentials_tpu_torch.algorithms import sssp
    from essentials_tpu_torch.ops import fused_kcore as FK
    max_it = g.n_vertices + 1
    for v, search in sssp.VARIANTS.items():
        ms = median_ms(lambda _: [search(g, int(s), max_it)
                                  for s in sources]) / len(sources)
        sweeps = sum(r.iterations for r in runs[v]) / len(sources)
        print(f"time [{card}]: sssp {v} rmat{MAIN_SCALE}: {ms:.4f} ms per "
              f"search (median of {CYCLES} cycles of {len(sources)} "
              f"sources), {sweeps:.2f} sweeps per search, "
              f"{ms / sweeps:.4f} ms per sweep, "
              f"{g.n_edges * sweeps / ms / 1e6:.3f} G relaxations/s")
    max_it = 4 * g.n_vertices + 8
    waves = FK.run_fused_kcore(g, max_it)[1]
    ms = median_ms(lambda _: FK.run_fused_kcore(g, max_it), KCORE_CYCLES)
    print(f"time [{card}]: kcore fused rmat{MAIN_SCALE}: {ms:.4f} ms per run "
          f"(median of {KCORE_CYCLES}), {waves} waves, "
          f"{ms / waves:.4f} ms per wave")


def per_call_device_ms(fn, names: tuple, calls: int) -> list | None:
    """Each call's device time over fn() (``calls`` calls of a wrapper
    that launches one of each device kernel ``names``) from torch.profiler's
    events, its kernels summed; fn runs twice, the first time in a warm-up
    step. None where the profiler lost device activities (not ``calls`` of
    each) in three windows."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile as torch_profile,
                                schedule)
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as prof:
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                prof.step()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        each = [[e for e in ev if n in e.name] for n in names]
        if all(len(x) == calls for x in each):
            return [sum(e.time_range.elapsed_us() for e in call) / 1e3
                    for call in zip(*each)]
    return None


def kcore_peel_set(g, state, n_in: int, cand) -> torch.Tensor:
    """[Vp] bool: the vertices a wave from ``state`` (deg, core) peels: the
    ``n_in`` listed in ``cand`` for a cascade, else the alive vertices of
    the smallest alive degree (k = it + 1)."""
    off = g.row_offsets
    peel = torch.zeros(off.numel() - 1, dtype=torch.bool, device=off.device)
    if n_in:
        peel[cand[:n_in].long()] = True
        return peel
    nonempty = off[1:] > off[:-1]
    d = torch.where(nonempty, state[0][torch.where(nonempty, off[:-1], 0)
                                       .long()], -1)
    alive = d >= 0
    if bool(alive.any()):
        peel = alive & (d == d[alive].min())
    return peel


def kcore_wave_bytes(g, peel, level: bool) -> tuple:
    """(the pass's bytes, the push's bytes) of a wave that peels ``peel``:
    a level wave's minimum reads the offsets and each non-empty start's
    32-byte sector, and its peel writes a sector of the degrees and of the
    core numbers at each peeled start; a cascade reads each listed word
    and the sector of its offsets and writes the same two sectors; then
    per slot of each peeled segment its col word and two scattered
    32-byte sectors (off[v], and the degree at v's start that the atomic
    takes one from)."""
    off = g.row_offsets
    lens = (off[1:] - off[:-1]).long()
    n = int(peel.sum())
    if level:
        starts = off[:-1][lens > 0].long()
        sectors = int(torch.unique(starts // 8).numel())
        dense = 4 * (g.n_vertices_padded + 1) + 32 * sectors + 64 * n
    else:
        dense = 100 * n
    return dense, 68 * int(lens[peel].sum())


def kcore_wave_device_ms(g) -> dict | None:
    """Each wave's device time over one k-core run (FK.run_fused_kcore),
    by kind: {wrapper name: [ms a wave]}, a level wave's minimum, peel and
    push summed, a cascade's mark and push, from torch.profiler's events
    in order; the run runs twice, the first time in a warm-up step. None
    where the profiler lost device activities in three windows."""
    from torch.autograd import DeviceType
    from torch.profiler import (ProfilerActivity, profile as torch_profile,
                                schedule)
    from essentials_tpu_torch.ops import fused_kcore as FK
    max_it = 4 * g.n_vertices + 8
    waves = FK.run_fused_kcore(g, max_it)[1]
    for _ in range(3):
        with torch_profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA],
                           schedule=schedule(wait=0, warmup=1, active=1,
                                             repeat=1)) as prof:
            for _ in range(2):
                FK.run_fused_kcore(g, max_it)
                torch.cuda.synchronize()
                prof.step()
        ev = sorted((e for e in prof.events()
                     if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
        out = {"kcore_level_wave": [], "kcore_cascade_wave": []}
        cur, pushes = None, 0
        for e in ev:
            ms = e.time_range.elapsed_us() / 1e3
            first = [n for n in out if n + "_kernel" in e.name]
            if first:
                cur = out[first[0]]
                cur.append(ms)
            elif cur is not None and ("kcore_level_peel_kernel" in e.name
                                      or "kcore_wave_push_kernel" in e.name):
                cur[-1] += ms
                pushes += "kcore_wave_push_kernel" in e.name
        if sum(map(len, out.values())) == waves == pushes:
            return out
    return None


def time_kcore_waves(g, card: str) -> dict:
    """The k-core waves wave by wave over one fused run
    (kcore_run_waves): each wave's wall time on CUDA events and its plain
    version's, each from a copy of its state, beside the vertices alive
    before it and the vertices and edges it peels; each wave's device time
    (kcore_wave_device_ms); the bounds per wave and per run
    (kcore_wave_bytes), all by kind. Returns chip_smoke's keys for
    kcore_level_wave and kcore_cascade_wave: the times and bound per wave
    averaged over the run's waves of that kind, and the run's totals."""
    from essentials_tpu_torch.ops import fused_kcore as FK
    off = g.row_offsets
    lens = (off[1:] - off[:-1]).long()
    starts = torch.where(lens > 0, off[:-1], 0).long()
    out, _, scratch = FK.wave_buffers(g)
    rows = {"kcore_level_wave": [], "kcore_cascade_wave": []}
    for i, (name, state, k, n_in, cand) in enumerate(kcore_run_waves(g)):
        peel = kcore_peel_set(g, state, n_in, cand)
        alive = int(((lens > 0) & (state[0][starts] >= 0)).sum())

        def copy(state=state):
            return tuple(t.clone() for t in state)
        wall = median_ms(lambda st: kcore_wave(
            g, st, k, n_in, cand, out, scratch), 1, copy)
        plain = median_ms(lambda st: kcore_wave(
            g, st, k, n_in, cand, out, scratch, plain=True), 1, copy)
        rows[name].append((i, wall, plain, alive, int(peel.sum()),
                           int(lens[peel].sum()),
                           kcore_wave_bytes(g, peel, not n_in)))
    dev = kcore_wave_device_ms(g)
    t = {}
    for name, r in rows.items():
        ms = np.array([x[1] for x in r])
        for j in sorted({0, len(r) // 2, len(r) - 1}):
            i, w, p, alive, npeel, epeel, _ = r[j]
            print(f"time [{card}]: {name} rmat{MAIN_SCALE} wave {i}: {w:.4f} "
                  f"ms (plain {p:.4f}); {alive} vertices alive; peels "
                  f"{npeel} vertices, {epeel} edges")
        d = None if dev is None else dev[name]
        per = [(bound(a), bound(b)) for a, b in (x[6] for x in r)]
        mems = "/".join(sorted({x[2] for pair in per for x in pair}))
        run_bound = (sum(a[0] + b[0] for a, b in per), "bytes", mems)
        print(f"time [{card}]: {name} rmat{MAIN_SCALE}: {len(r)} waves; wall "
              f"{ms.sum():.3f} ms in all, median {np.median(ms):.4f}, min "
              f"{ms.min():.4f}, max {ms.max():.4f} a wave; plain "
              f"{sum(x[2] for x in r):.1f} ms in all; device "
              + ("not measured" if d is None else
                 f"{sum(d):.3f} ms in all, median {np.median(d):.4f}, min "
                 f"{min(d):.4f}, max {max(d):.4f} a wave")
              + f"; bound {run_bound[0]:.4f} ms ({mems}), "
              f"{run_bound[0] / len(r):.4f} a wave")
        t.update({name: ms.mean(),
                  name + "/plain": float(np.mean([x[2] for x in r])),
                  name + "/device": None if d is None else float(np.mean(d)),
                  name + "/bound": (run_bound[0] / len(r), *run_bound[1:]),
                  name + "/run": {
                      "waves": len(r), "ms": float(ms.sum()),
                      "device_ms": None if d is None else float(sum(d)),
                      "bound_ms": run_bound[0], "bound_memory": mems,
                      "wave_ms_median": float(np.median(ms)),
                      "wave_device_ms_median":
                          None if d is None else float(np.median(d))}})
    return t


def sssp_sweep_bytes(g, d, prev, out) -> tuple:
    """(the dense pass's bytes, the push's bytes, slots pushed) of a sweep
    from ``d`` into a buffer holding ``prev`` that gave ``out``: the
    offsets read, and the 32-byte sectors of the non-empty starts read in
    each buffer and of those whose value the sweep changes written; then
    the col and w words of each changed vertex's row (the targets' starts
    lie in sectors the dense pass reads)."""
    off = g.row_offsets
    nonempty = off[1:] > off[:-1]
    starts = off[:-1][nonempty].long()
    lens = (off[1:] - off[:-1])[nonempty].long()
    changed = d[starts] != prev[starts]
    written = int(torch.unique(starts[out[starts] != prev[starts]]
                               // 8).numel())
    sectors = int(torch.unique(starts // 8).numel())
    slots = int(lens[changed].sum())
    return (4 * (g.n_vertices_padded + 1) + 32 * (2 * sectors + written),
            8 * slots, slots)


def sssp_sweep_bound(g, states) -> tuple:
    """Per sweep of ``states`` (sssp_sweep_states) the bound of each launch
    at the rate of where its own bytes fit, and the slots pushed: ([ms],
    memories, [slots])."""
    per, mems, slots = [], set(), []
    for i, (d, prev) in enumerate(states):
        out = states[i + 1][0] if i + 1 < len(states) else d
        dense, push, n = sssp_sweep_bytes(g, d, prev, out)
        a, b = bound(dense), bound(push, n)   # one float add a pushed slot
        per.append(a[0] + b[0])
        mems |= {a[2], b[2]}
        slots.append(n)
    return per, "/".join(sorted(mems)), slots


def sssp_sweep_ms(g, states, kernels: tuple, reps: int = CYCLES) -> dict:
    """sssp_sweep over the sweeps of ``states``, each call from its state
    (its output buffer restored outside the timed region): the wall time of
    each (median of ``reps`` on CUDA events) and the device time of each
    (torch.profiler, the device kernels ``kernels`` a call launches), per
    sweep and per search."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    args = (g.row_offsets, g.col_indices, edge_weights(g))
    out = torch.empty_like(states[0][0])

    def restored(prev):
        out.copy_(prev)
        return out
    wall = [median_ms(lambda o, d=d: K.sssp_sweep(d, o, *args), reps,
                      lambda prev=prev: restored(prev))
            for d, prev in states]

    def search():
        for d, prev in states:
            K.sssp_sweep(d, restored(prev), *args)
    n = len(states)
    dev = per_call_device_ms(search, kernels, n)
    total = None if dev is None else sum(dev)
    return {"wall per sweep": sum(wall) / n, "wall per search": sum(wall),
            "device per sweep": None if dev is None else total / n,
            "device per search": total, "sweeps": n, "walls": wall,
            "devices": dev}


def time_sssp_sweeps(g, card: str) -> dict:
    """sssp_sweep sweep by sweep over one fused search from the
    highest-degree vertex at gen:rmat20x16: each sweep's wall and device
    time (sssp_sweep_ms) beside the vertices whose distance changed before
    it and the slots it pushes, its plain version's wall time, and the
    bounds per sweep and per search (sssp_sweep_bound). Returns chip_smoke's
    keys for sssp_sweep: per sweep, averaged over the search's sweeps, and
    the search's totals."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    args = (g.row_offsets, g.col_indices, edge_weights(g))
    source = int(torch.argmax(g.out_degrees()[:g.n_vertices]))
    states = sssp_sweep_states(g, source)
    t = sssp_sweep_ms(g, states, K.device_kernels("sssp_sweep"))
    per, mems, slots = sssp_sweep_bound(g, states)
    out = torch.empty_like(states[0][0])
    plain = [median_ms(lambda o, d=d: K.sssp_sweep_plain(d, o, *args), 1,
                       lambda prev=prev: out.copy_(prev))
             for d, prev in states]
    n = t["sweeps"]
    for i in range(n):
        dev = "not measured" if t["devices"] is None else \
            f"{t['devices'][i]:.4f} ms device"
        print(f"time [{card}]: sssp_sweep gen:rmat{MAIN_SCALE}x16 sweep {i}: "
              f"{t['walls'][i]:.4f} ms wall, {dev}, plain {plain[i]:.4f}; "
              f"pushes {slots[i]} slots; bound {per[i]:.4f} ms")
    dev = "not measured" if t["device per search"] is None else \
        f"{t['device per search']:.4f} ms a search, " \
        f"{t['device per sweep']:.4f} per sweep"
    print(f"time [{card}]: sssp_sweep gen:rmat{MAIN_SCALE}x16 from {source}: "
          f"{n} sweeps; wall {t['wall per search']:.4f} ms a search, "
          f"{t['wall per sweep']:.4f} per sweep; device {dev}; plain "
          f"{sum(plain):.3f} ms a search; {sum(slots)} slots pushed "
          f"({sum(slots) / g.n_edges:.3f} E); bound {sum(per):.4f} ms a "
          f"search, {sum(per) / n:.4f} per sweep (bytes at {mems} rate)")
    return {"sssp_sweep": t["wall per sweep"],
            "sssp_sweep/plain": sum(plain) / n,
            "sssp_sweep/device": t["device per sweep"],
            "sssp_sweep/bound": (sum(per) / n, "bytes", mems),
            "sssp_sweep/search": {
                "sweeps": n, "source": source, "ms": t["wall per search"],
                "device_ms": t["device per search"], "plain_ms": sum(plain),
                "bound_ms": sum(per), "bound_memory": mems,
                "slots_pushed": sum(slots)}}


def time_sssp_kcore_kernels(csr, g, card: str) -> dict:
    """Each new kernel and its plain version, one call at a time through
    its wrapper: sssp_sweep summed over the sweeps of one search from the
    highest-degree vertex, each from its saved state (its output buffer
    restored outside the timed region), with its bound summed the same way
    (sssp_sweep_bound); collapse_starts once per search; sssp_predecessors
    once per search (time_predecessors); expand_segments once per k-core
    run (the k-core waves are timed wave by wave at gen:rmat20x16:
    time_kcore_waves, and sssp_sweep sweep by sweep: time_sssp_sweeps).
    sssp_sweep's keys here are per search."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_sssp as FS
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    off, src = g.row_offsets, g.csc_src_indices
    args = (off, g.col_indices, edge_weights(g))
    source = int(np.argmax(np.diff(csr.row_offsets)))
    states = sssp_sweep_states(g, source)
    out = torch.empty_like(states[0][0])
    ts = sssp_sweep_ms(g, states, K.device_kernels("sssp_sweep"))
    t = {"sssp_sweep@search": ts["wall per search"],
         "sssp_sweep@search/device": ts["device per search"]}
    t["sssp_sweep@search/plain"] = sum(
        median_ms(lambda o, d=d: K.sssp_sweep_plain(d, o, *args),
                  setup=lambda prev=prev: out.copy_(prev))
        for d, prev in states)
    per, mems, _ = sssp_sweep_bound(g, states)
    t["sssp_sweep@search/bound"] = (sum(per), "bytes", mems)
    d = states[-1][0]
    t.update(time_starts(g, d, source, card, f"weighted rmat{SCALE}"))
    t.update(time_predecessors(
        "sssp_predecessors", [(K.collapse_starts(
            d, off, FS.INF_BITS, source).view(torch.float32), g.csc_offsets,
            src, FS.csc_weights(g), g.n_edges)], card,
        f"weighted rmat{SCALE} from {source}"))
    t["sweeps"] = len(states)
    return t


def segment_starts(off: torch.Tensor) -> torch.Tensor:
    """[the non-empty segments] int64: each one's start, in order."""
    return off[:-1][off[1:] > off[:-1]].long()


def time_starts(g, d, source: int, card: str, where: str,
                tag: str = "") -> dict:
    """collapse_starts at ``d`` (a fused search's final state from
    ``source``) and expand_segments at init_deg_exp's input, each through
    against_library: wall (back to back), device, bound, plain, and the
    PyTorch call: index_select at the graph's non-empty starts (the gather
    alone, without the empty segments or the source) and
    torch.repeat_interleave. Keys are the kernel's name, then ``tag``,
    then against_library's; /bound_sectors counts a 32-byte sector for
    each start's gather, what a gather costs on the card."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_sssp as FS
    off, vp, ep = g.row_offsets, g.n_vertices_padded, g.n_edges_padded
    starts = segment_starts(off)
    cargs = (d, off, FS.INF_BITS, source)
    tc = against_library(
        lambda: K.collapse_starts(*cargs), 4 * (vp + 1) + 8 * vp,
        plain=lambda: K.collapse_starts_plain(*cargs),
        lib=lambda: torch.index_select(d, 0, starts),
        label="collapse_starts (index_select at the starts)")
    tc["/bound_sectors"] = bound(32 * starts.numel() + 4 * (vp + 1)
                                 + 4 * vp)
    print_against(card, f"collapse_starts {where} from {source}", tc,
                  "index_select at the starts (the gather alone)")
    vals = torch.where(g.vertex_mask(), g.out_degrees(), -1).int()
    counts = (off[1:] - off[:-1]).long()
    te = against_library(
        lambda: K.expand_segments(vals, off, ep),
        4 * vp + 4 * (vp + 1) + 4 * ep,
        plain=lambda: K.expand_segments_plain(vals, off, ep),
        lib=lambda: torch.repeat_interleave(vals, counts, output_size=ep),
        label="expand_segments (torch.repeat_interleave)")
    print_against(card, f"expand_segments {where} (init_deg_exp)", te,
                  "torch.repeat_interleave")
    return {**prefixed("collapse_starts" + tag, tc),
            **prefixed("expand_segments" + tag, te)}

# ------------------------------------------------------------ phase 12 --

def hold_close(name: str, form: str, k, again, p, rtol: float, errs: dict,
               where: str) -> None:
    """A float kernel output against a second launch (bitwise) and its
    plain version (|k - p| <= rtol |p| + SUM_ATOL)."""
    torch.cuda.synchronize()
    check(torch.equal(k, again), f"{name}{form} gives other bits on a "
                                 f"second launch ({where})")
    d = (k.double() - p.double()).abs()
    err = float(d.max()) if d.numel() else 0.0
    errs[name] = max(errs[name], err)
    check(bool((d <= rtol * p.double().abs() + SUM_ATOL).all()),
          f"{name}{form} outside |k - p| <= {rtol} |p| + {SUM_ATOL} of "
          f"plain ({where}): max abs {err}")


def float64_sum(x: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """segment_reduce's float SUM of ``x`` over ``off`` in float64 on the
    host, in a fixed order: the reference of the float sum checks
    (segment_reduce_plain's CUDA index_add_ adds in another order on every
    call)."""
    from essentials_tpu_torch import kernels as K
    return K.segment_reduce_plain(x.cpu().double(), off.cpu(),
                                  "sum").to(x.device)


def exact_bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def check_operator_kernels(g, where: str, errs: dict) -> None:
    """Every instance of the four operator kernels against its plain
    version and a second launch, on inputs made from a seed at ``g``'s
    shapes; segment_reduce's float sums against a float64 sum on the host
    (float64_sum) instead of the plain version."""
    from essentials_tpu_torch import kernels as K
    rng = np.random.default_rng(12)
    vp, ep, dev = g.n_vertices_padded, g.n_edges_padded, g.device
    xs = (torch.from_numpy(rng.integers(-2**30, 2**30, ep).astype(
        np.int32)).to(dev), torch.from_numpy(rng.random(ep).astype(
            np.float32)).to(dev))
    cases = 0
    for x in xs:
        ty = str(x.dtype).split(".")[-1]
        for op in K.SCAN_OPS:
            for flags, seg in ((None, "plain"), (g.csc_seg_flags,
                                                 "segmented")):
                form = f"<{ty},{op},{seg}>"
                k, again = K.scan(x, flags, op), K.scan(x, flags, op)
                p = K.scan_plain(x, flags, op)
                if op == "add" and x.is_floating_point():
                    hold_close("scan", form, k, again, p,
                               SCAN_RTOL if flags is None else SUM_RTOL,
                               errs, where)
                else:
                    hold_exact("scan", (exact_bits(k),),
                               (exact_bits(again),), (exact_bits(p),), errs,
                               f"{where} {form}")
                cases += 1
        for order, off in (("csc", g.csc_offsets), ("csr", g.row_offsets)):
            for op in K.REDUCE_OPS:
                form = f"<{ty},{op},{order}>"
                k = K.segment_reduce(x, off, op)
                again = K.segment_reduce(x, off, op)
                if op == "sum" and x.is_floating_point():
                    hold_close("segment_reduce", form, k, again,
                               float64_sum(x, off), SUM_RTOL, errs, where)
                else:
                    p = K.segment_reduce_plain(x, off, op)
                    hold_exact("segment_reduce", (exact_bits(k),),
                               (exact_bits(again),), (exact_bits(p),), errs,
                               f"{where} {form}")
                cases += 1
    # vertex payloads of unequal lengths, every index below the shortest
    vert = [torch.from_numpy(rng.random(vp + extra).astype(np.float32)).to(
        dev) if extra % 2 else torch.from_numpy(rng.integers(
            -9, 9, vp + extra).astype(np.int32)).to(dev)
        for extra in GATHER_EXTRA]
    edge = [xs[1], xs[0]] * 2
    for idx, pays in ((g.csc_src_indices, vert), (g.csc_rank, edge)):
        # the whole index, a ragged count (n % 4 = 1) and a view at an odd
        # offset (4 bytes past a 16-byte boundary): the scalar paths
        views = {"whole": idx, "ragged": idx[:-3], "offset": idx[1:]}
        for m in range(1, 5):
            for pack in (False, True) if m > 1 else (False,):
                for cut, ix in views.items():
                    with gather_path(pack):
                        k = K.gather_payloads(ix, *pays[:m])
                        again = K.gather_payloads(ix, *pays[:m])
                    p = K.gather_payloads_plain(ix, *pays[:m])
                    hold_exact("gather_payloads", [exact_bits(a) for a in k],
                               [exact_bits(a) for a in again],
                               [exact_bits(a) for a in p], errs,
                               f"{where} {m} payloads, "
                               f"{'packed' if pack else 'unpacked'}, {cut} "
                               f"index")
                    cases += 1
    fronts = {"empty": torch.zeros(vp, dtype=torch.bool, device=dev),
              "full": torch.ones(vp, dtype=torch.bool, device=dev)}
    for density in (0.01, 0.3):
        fronts[f"density {density}"] = torch.from_numpy(
            rng.random(vp) < density).to(dev) & g.vertex_mask()
    for label, f in fronts.items():
        args = (f, g.csc_offsets, g.csc_src_indices)
        want = K.advance_count_plain(*args)
        for cap in (None, COUNT_GLOBAL_CAP):
            tier = K.advance_count_tier(vp, dev, cap)
            check(tier == ("global" if cap is not None else "shared"),
                  f"advance_count at Vp = {vp} under cap {cap} runs the "
                  f"{tier} tier")
            hold_exact("advance_count", (K.advance_count(*args, cap),),
                       (K.advance_count(*args, cap),), (want,), errs,
                       f"{where} {label} {tier} tier")
            cases += 1
    print(f"kernels: {where}: {cases} operator kernel instances, integers, "
          f"minima, maxima and gathers exact against plain, float sums "
          f"within tolerance (max abs err scan {errs['scan']:.6g}, "
          f"segment_reduce {errs['segment_reduce']:.6g}), all repeatable")


def check_reduce_shapes(errs: dict) -> None:
    """segment_reduce under its five ops on int32 and float32 values (seeded;
    the int32 ones from -3 to 3, so that or and and see values other than 0
    and 1; the float32 ones in [0, 1), as in check_operator_kernels) over
    the CSR and the CSC offsets of the spmv_rows stress graph
    (rows_stress_graph: hubs of 82,001 and 6,139 slots, a run of 6,144
    empty segments), over offsets[REDUCE_CUT:] (from past 0) and with the
    values a view at a 4-byte offset: integers, minima, maxima, ORs and
    ANDs bitwise equal to plain, float sums within SUM_RTOL of a float64
    sum on the host (float64_sum), every result the same bits over three
    calls; then one segment_split_kernel and one segment_reduce_kernel a
    call, by torch.profiler."""
    from essentials_tpu_torch import kernels as K
    _, g = rows_stress_graph("cuda")
    rng = np.random.default_rng(SPMV_SEED)
    n = g.n_edges_padded
    whole = (torch.from_numpy(rng.integers(-3, 4, n + 1).astype(
        np.int32)).cuda(), torch.from_numpy(rng.random(n + 1).astype(
            np.float32)).cuda())
    cases = 0
    for x1 in whole:
        for label, x in (("aligned", x1[:n]), ("a view at a 4-byte offset",
                                               x1[1:])):
            for order, off in (("csr", g.row_offsets),
                               ("csc", g.csc_offsets),
                               (f"csc[{REDUCE_CUT}:]",
                                g.csc_offsets[REDUCE_CUT:])):
                where = f"rows stress graph {order}, {x.dtype}, {label}"
                for op in K.REDUCE_OPS:
                    k = K.segment_reduce(x, off, op)
                    again = K.segment_reduce(x, off, op)
                    third = K.segment_reduce(x, off, op)
                    if op == "sum" and x.is_floating_point():
                        hold_close("segment_reduce", f"<{op}>", k, again,
                                   float64_sum(x, off), SUM_RTOL, errs, where)
                        check(torch.equal(exact_bits(k), exact_bits(third)),
                              f"segment_reduce <sum> {where}: other bits on "
                              f"a third call")
                    else:
                        p = K.segment_reduce_plain(x, off, op)
                        hold_exact("segment_reduce", (exact_bits(k),
                                                      exact_bits(third)),
                                   (exact_bits(again), exact_bits(k)),
                                   (exact_bits(p), exact_bits(p)), errs,
                                   f"{where} <{op}>")
                    cases += 1
    x, off = whole[1][1:], g.csc_offsets
    seg = (g.row_offsets[1:] - g.row_offsets[:-1]).long()
    measured = sum(check_one_launch(
        "segment_reduce", lambda op=op: K.segment_reduce(x, off, op),
        f"rows stress graph <{op}>", ("segment_split_kernel",
                                      "segment_reduce_kernel"))
        for op in ("sum", "or"))
    check(measured > 0, "segment_reduce: launches per call measured for no "
                        "op")
    print(f"kernels: segment_reduce on the rows stress graph (longest CSR "
          f"segment {int(seg.max())} slots = "
          f"{int(seg.max()) / K.REDUCE_TILE:.1f} tiles, "
          f"{int((seg == 0).sum())} empty), CSC offsets from "
          f"{int(off[REDUCE_CUT])}, a view at a 4-byte offset: {cases} "
          f"cases exact against plain (float sums within {SUM_RTOL}), the "
          f"same bits over three calls; two device launches a call (split, "
          f"tiles) for {measured} of 2 ops measured")


def kernels_seen(fn, calls: int = PROFILED_CALLS) -> dict | None:
    """{device kernel name: launches per call} over ``calls`` calls of fn()
    recorded by torch.profiler, memsets and copies left out: in a window
    after a warm-up step, or (where that window lost activities: a count
    that is not a whole number of calls) in a profiler of its own after a
    warm-up call; three tries each. None where every window lost some."""
    from torch.profiler import (ProfilerActivity, profile as torch_profile,
                                schedule)
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for scheduled in (True, False) * 3:
        fn()
        torch.cuda.synchronize()
        with torch_profile(activities=activities, schedule=schedule(
                wait=0, warmup=1, active=1, repeat=1) if scheduled
                else None) as prof:
            for _ in range(2 if scheduled else 1):
                for _ in range(calls):
                    fn()
                torch.cuda.synchronize()
                if scheduled:
                    prof.step()
        rows = {e.key: e.count for e in prof.key_averages()
                if device_row(e)
                and not e.key.startswith(("Memset", "Memcpy"))}
        if rows and all(n % calls == 0 for n in rows.values()):
            return {k: n // calls for k, n in rows.items()}
    return None


def check_one_launch(name: str, fn, where: str,
                     kernels: tuple = ()) -> bool:
    """One call of the wrapper ``name`` (fn()) launches one of each device
    kernel ``kernels`` (by default <name>_kernel alone) and nothing else,
    as torch.profiler sees it. False (printed) where the profiler lost
    device activities in every window; the caller fails where that leaves
    a kernel with no form measured."""
    want = kernels or (f"{name}_kernel",)
    seen = kernels_seen(fn)
    if seen is None:
        print(f"kernels: {name} {where}: launches per call not measured "
              f"(every profiler window lost device activities)")
        return False
    matched = sorted(w for key in seen for w in want if w in key)
    check(len(seen) == len(want) and matched == sorted(want)
          and all(n == 1 for n in seen.values()),
          f"{name} {where}: the profiler saw {seen} per call, not one "
          f"each of {want}")
    return True


def check_scan_shapes(errs: dict) -> None:
    """scan at n = 1, a tile - 1, a tile, a tile + 1 and SCAN_MANY tiles,
    with flags absent, sparse (1%), at every position and only at position
    0, under every op on int32 and float32: float add within tolerance of
    plain (SCAN_RTOL where a segment spans tiles, else SUM_RTOL) and
    bitwise equal over three calls, every other case bitwise equal to plain
    on each call; then an unsegmented float add at SCAN_BIG elements; then
    one device launch per call under every op, with and without flags."""
    from essentials_tpu_torch import kernels as K
    rng = np.random.default_rng(13)
    tile = K.SCAN_TILE
    cases = 0
    for n in (1, tile - 1, tile, tile + 1, SCAN_MANY * tile + 5):
        only0 = torch.zeros(n, dtype=torch.bool, device="cuda")
        only0[0] = True
        flag_sets = {"none": None,
                     "sparse": torch.from_numpy(rng.random(n) < 0.01).cuda(),
                     "every": torch.ones(n, dtype=torch.uint8, device="cuda"),
                     "only 0": only0}
        xs = (torch.from_numpy(rng.integers(-2**30, 2**30, n).astype(
            np.int32)).cuda(), torch.from_numpy(rng.random(n).astype(
                np.float32)).cuda())
        for x in xs:
            ty = str(x.dtype).split(".")[-1]
            for label, fl in flag_sets.items():
                for op in K.SCAN_OPS:
                    form = f"<{ty},{op},{label}>"
                    where = f"n = {n}"
                    k = K.scan(x, fl, op)
                    agains = [K.scan(x, fl, op) for _ in range(2)]
                    p = K.scan_plain(x, fl, op)
                    if op == "add" and x.is_floating_point():
                        rtol = SUM_RTOL if label in ("sparse", "every") \
                            else SCAN_RTOL
                        for a in agains:
                            hold_close("scan", form, k, a, p, rtol, errs,
                                       where)
                    else:
                        hold_exact("scan", (exact_bits(k),) * 2,
                                   [exact_bits(a) for a in agains],
                                   (exact_bits(p),) * 2, errs,
                                   f"{where} {form}")
                    cases += 1
    big = torch.rand(SCAN_BIG, generator=torch.Generator(
        device="cuda").manual_seed(SEED), device="cuda")
    k = K.scan(big)
    hold_close("scan", "<float32,add,none>", k, K.scan(big), K.scan_plain(big),
               SCAN_RTOL, errs, f"n = {SCAN_BIG}")
    del big, k
    forms = [(x, op, label) for x in xs for op in K.SCAN_OPS
             for label in ("none", "sparse")]
    seen = sum(check_one_launch(
        "scan", lambda x=x, op=op, fl=flag_sets[label]: K.scan(x, fl, op),
        f"<{x.dtype},{op},{label}>") for x, op, label in forms)
    check(seen > 0, f"scan: launches per call measured in none of the "
                    f"{len(forms)} forms profiled")
    print(f"kernels: scan at n = 1 to {SCAN_MANY} tiles of {tile}: {cases} "
          f"cases (4 flag sets, every op, int32 and float32) bitwise equal "
          f"to plain on three calls, float adds within tolerance and the "
          f"same bits on three calls (max abs err {errs['scan']:.6g}); an "
          f"unsegmented float add at n = {SCAN_BIG} too; one device launch "
          f"(scan_kernel) per call in {seen} of {len(forms)} forms profiled "
          f"(the others not measured)")


# ------------------------------------------------------------ phase 13 --

def expect_bfs_adaptive(r) -> dict:
    """Launches of one adaptive BFS from its tiers: a spray level scans
    twice (the members' prefix, the edge ids); a dense level counts
    (advance_count) and compacts (one scan); then the predecessors."""
    tiny, spray, dense = r.tiers
    return {"scan": 2 * (tiny + spray) + dense, "advance_count": dense,
            "bfs_predecessors": 1}


def expect_sssp_adaptive(r) -> dict:
    """Launches of one adaptive SSSP from its tiers: a spray round scans
    four times (the members' prefix, the edge ids, the distances, the
    sources); a dense round gathers distances and frontier by source, MIN
    reduces, gathers the new distances by destination, MIN reduces the
    predecessors, and compacts (one scan)."""
    tiny, spray, dense = r.tiers
    return {"scan": 4 * (tiny + spray) + dense,
            "gather_payloads": 2 * dense, "segment_reduce": 2 * dense}


def adaptive_main_path(csr, g) -> tuple:
    """BFS and SSSP adaptive from the ADAPTIVE_RUNS highest out-degree
    sources, then spmv pull and push, each run with the launch counts set
    to 0 just before it and read just after, which must be exactly the
    launches it makes. Returns ({path: {kernel: launches summed over its
    runs}}, the sources, {"bfs": results, "sssp": results})."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import bfs, spmv, sssp
    sources = np.argsort(-np.diff(csr.row_offsets))[:ADAPTIVE_RUNS].astype(
        int)
    by_path, runs = {}, {"bfs": [], "sssp": []}

    def run_counted(path: str, fn, expect: dict | None = None):
        r, launches = counted(fn)
        ran = {k: n for k, n in launches.items() if n}
        want = {k: n for k, n in (expect or expect_of[path](r)).items() if n}
        check(ran == want, f"{path} launched {ran}, expected {want}")
        total = by_path.setdefault(path, dict.fromkeys(K.launches, 0))
        for k, n in launches.items():
            total[k] += n
        return r

    expect_of = {"bfs adaptive": expect_bfs_adaptive,
                 "sssp adaptive": expect_sssp_adaptive}
    for s in sources:
        runs["bfs"].append(run_counted("bfs adaptive", lambda s=s: bfs.run(
            g, int(s), variant="adaptive", warmup=False)))
        runs["sssp"].append(run_counted("sssp adaptive", lambda s=s: sssp.run(
            g, int(s), variant="adaptive", warmup=False)))
    for name in ("bfs", "sssp"):
        tiers = np.sum([r.tiers for r in runs[name]], axis=0)
        print(f"main path: {name} adaptive rmat{SPMV_TIME_SCALE} seed "
              f"{SPMV_SEED}: steps per source "
              f"{[r.iterations for r in runs[name]]}; tiers per source "
              f"{[r.tiers for r in runs[name]]}; over {len(sources)} runs "
              f"tiny spray {tiers[0]}, spray {tiers[1]}, dense {tiers[2]}; "
              f"launches {({k: n for k, n in by_path[name + ' adaptive'].items() if n})}, "
              f"exact per run")
    host_csc = HostCsc(csr)
    for i, s in enumerate(sources):
        rb, rs = runs["bfs"][i], runs["sssp"][i]
        d = rb.distances.cpu().numpy()
        check(np.array_equal(d, bfs.cpu_reference(csr, int(s))),
              f"adaptive bfs distances from {s} differ from cpu_reference")
        check(rb.iterations == int(d[d != bfs.UNREACHED].max()) + 1,
              f"adaptive bfs from {s}: levels != eccentricity + 1")
        check(np.array_equal(rb.predecessors.cpu().numpy(),
                             host_predecessors(csr, d)),
              f"adaptive bfs predecessors from {s} are not the smallest-id "
              f"in-neighbours one level up")
        ds = rs.distances.cpu().numpy()
        check(ds.shape == (g.n_vertices,) and ds[s] == 0
              and bool(np.all(ds >= 0)), f"adaptive sssp from {s}: shape, "
                                         f"source or sign")
        check(np.array_equal(rs.predecessors.cpu().numpy(),
                             host_csc.sssp_predecessors(ds)),
              f"adaptive sssp predecessors from {s} are not the smallest-id "
              f"in-neighbours that achieve the distance")
        if i < DIJKSTRA_SOURCES:
            ref = host_dijkstra(csr, int(s))
            reach = np.isfinite(ref)
            check(np.array_equal(np.isfinite(ds), reach),
                  f"adaptive sssp reach set from {s} differs from Dijkstra")
            rel = float(np.max(np.abs(ds[reach] - ref[reach])
                               / np.maximum(ref[reach], 1e-300)))
            check(rel <= SSSP_RTOL, f"adaptive sssp from {s}: max rel err "
                                    f"{rel} against Dijkstra")
            print(f"main path: adaptive sssp from {s}: {int(reach.sum())} "
                  f"reached, max rel err {rel:.3g} against the float64 host "
                  f"Dijkstra (rtol {SSSP_RTOL}), reach set exact")
    print(f"main path: adaptive bfs distances equal cpu_reference from all "
          f"{len(sources)} sources; bfs and sssp predecessors equal the "
          f"host's smallest-id rule")

    x = spmv.random_x(g, 0)
    xh = x.cpu().numpy().astype(np.float64)
    src = np.repeat(np.arange(csr.n_rows), np.diff(csr.row_offsets))
    wx = {"pull": (src, np.asarray(csr.values, np.float64)
                   * xh[csr.col_indices]),
          "push": (csr.col_indices, np.asarray(csr.values, np.float64)
                   * xh[src])}
    for v in ("pull", "push"):
        r = run_counted(f"spmv {v}", lambda v=v: spmv.run(
            g, x, variant=v, warmup=False),
            {"gather_payloads": 1, "segment_reduce": 1})
        ref = torch.from_numpy(np.bincount(wx[v][0], weights=wx[v][1],
                                           minlength=csr.n_rows))
        err, _, ok = sum_errors(r.y.cpu(), ref)
        check(ok and bool(r.y.isfinite().all()),
              f"spmv {v} outside the sum tolerance of float64 (max abs "
              f"{err})")
        print(f"main path: spmv {v} rmat{SPMV_TIME_SCALE} seed {SPMV_SEED}: "
              f"max abs err {err:.6g} against float64 "
              f"({'A' if v == 'pull' else 'A^T'} x; within {SUM_RTOL} |ref| "
              f"+ {SUM_ATOL}); launches exact")
    return by_path, sources, runs


def check_adaptive_predecessors(g, sources, runs, where: str,
                                errs: dict) -> None:
    """Both predecessor kernels at the distances of every adaptive search
    of the main path (a graph whose CSC offsets are not its CSR offsets),
    against a second launch and their plain versions, and at pred_cases'
    cuts from the first source."""
    from essentials_tpu_torch.ops import fused_sssp as FS
    check(not torch.equal(g.csc_offsets, g.row_offsets),
          f"{where}: CSC offsets equal to the CSR offsets")
    off, src, e = g.csc_offsets, g.csc_src_indices, g.n_edges
    check_pred_sources("bfs_predecessors", [
        (padded_dist(g, r.distances, INT32_MAX), off, src, e)
        for r in runs["bfs"]], f"{where} adaptive", errs)
    w = FS.csc_weights(g)
    check_pred_sources("sssp_predecessors", [
        (padded_dist(g, r.distances, float("inf")), off, src, w, e)
        for r in runs["sssp"]], f"{where} adaptive", errs)
    print(f"kernels: predecessors on {where} adaptive from {sources[0]}: "
          f"{hold_pred_cases(g, int(sources[0]), where, errs)}; both exact "
          f"against plain and repeatable at n_edges E, E - 1 and E - "
          f"{PRED_CUT}")


# ------------------------------------------------------------ phase 14 --

def largest_dense_state(g, source: int, algo):
    """The state that ``algo`` (bfs or sssp) hands the dense step of its
    search from ``source`` with the largest frontier."""
    from essentials_tpu_torch.ops import sparse_advance as SA
    st, it, best = algo.init(g, source), 0, None
    while st.live > 0:
        if SA.tier(st) == 2 and (best is None or st.live > best.live):
            best = st
        st, it = algo.step(g, st, it), it + 1
    check(best is not None, f"{algo.__name__} from {source} took no dense "
                            f"step")
    return best


def time_adaptive(g, sources, runs, card: str) -> None:
    """ms per search of each adaptive path over the sources (what a user's
    bfs.run, without predecessors, and sssp.run take), with the device's
    idle share from torch.profiler."""
    from essentials_tpu_torch.algorithms import bfs, sssp
    fns = {"bfs": lambda s: bfs.run(g, s, variant="adaptive", warmup=False,
                                    compute_predecessors=False),
           "sssp": lambda s: sssp.run(g, s, variant="adaptive",
                                      warmup=False)}
    for name, fn in fns.items():
        ms = median_ms(lambda _: [fn(int(s)) for s in sources]) / len(sources)
        steps = float(np.mean([r.iterations for r in runs[name]]))
        rate = (f"{g.n_edges / 1e3 / ms:.2f} MTEPS" if name == "bfs" else
                f"{g.n_edges * steps / ms / 1e6:.3f} G relaxations/s under "
                f"the E x rounds model of phase 11")
        print(f"time [{card}]: {name} adaptive rmat{SPMV_TIME_SCALE} seed "
              f"{SPMV_SEED}: {ms:.4f} ms per search (median of {CYCLES} "
              f"cycles of {len(sources)} sources), {steps:.2f} steps per "
              f"search, {ms / steps:.4f} ms per step, {rate}")
        profile(f"{name} adaptive rmat{SPMV_TIME_SCALE}, {len(sources)} "
                f"{name}.run calls",
                lambda fn=fn: [fn(int(s)) for s in sources])


def time_operator_kernels(g, source: int) -> dict:
    """Each operator kernel, its plain version and a PyTorch call computing
    the same function, per call at the shapes of the adaptive path on ``g``
    (the frontiers of the dense BFS level and the dense SSSP round of the
    search from ``source`` that hold the most vertices),
    SPMV_REPS calls back to back per cycle; with each kernel's bound."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import bfs, sssp
    vp, ep = g.n_vertices_padded, g.n_edges_padded
    f = largest_dense_state(g, source, bfs).frontier
    st = largest_dense_state(g, source, sssp)
    dist, sf = st.distances, st.frontier
    csrc = g.csc_src_indices

    def per_call(fn) -> float:
        return median_ms(lambda _: [fn() for _ in range(SPMV_REPS)]) \
            / SPMV_REPS

    fi = f.int()                     # compact_frontier's cumsum input
    t = prefixed("scan", against_library(
        lambda: K.scan(fi), 8 * vp, lambda: K.scan_plain(fi),
        lambda: torch.cumsum(fi, 0, dtype=torch.int32),
        "scan (torch.cumsum)"))
    pays = (sf.int(), dist)          # the dense SSSP advance's gather
    t["gather_payloads"] = per_call(lambda: K.gather_payloads(csrc, *pays))
    t["gather_payloads/plain"] = per_call(
        lambda: K.gather_payloads_plain(csrc, *pays))
    t["gather_payloads/bound"] = bound(4 * ep + 8 * vp + 8 * ep)
    both = torch.stack([pays[0], dist.view(torch.int32)], 1)
    t["gather_payloads/library"] = library_ms(
        "gather_payloads (torch.index_select)",
        lambda: torch.index_select(both, 0, csrc), SPMV_REPS)
    t.update(gather_against_index_select(csrc, pays, both, "packed"))
    with gather_path(False):
        t["gather_payloads/unpacked"] = per_call(
            lambda: K.gather_payloads(csrc, *pays))
        t["gather_payloads/unpacked_device"] = device_ms(
            lambda: K.gather_payloads(csrc, *pays), SPMV_REPS)[0]
    cl = csrc.long()
    msg = torch.where(sf[cl], dist[cl] + g.csc_values, float("inf"))
    off = g.csc_offsets
    off64 = off.long()
    t.update(prefixed("segment_reduce", against_library(
        lambda: K.segment_reduce(msg, off, "min"),
        4 * ep + 4 * (vp + 1) + 4 * vp,
        lambda: K.segment_reduce_plain(msg, off, "min"),
        lambda: torch.segment_reduce(msg, "min", offsets=off64, unsafe=True),
        "segment_reduce (torch.segment_reduce)")))
    # PageRank generic's SUM: the [Ep] float messages over the CSC offsets
    contrib = torch.rand(ep, generator=torch.Generator(
        device=csrc.device).manual_seed(SPMV_SEED), device=csrc.device) \
        / g.n_vertices
    t.update(prefixed("segment_reduce@sum", against_library(
        lambda: K.segment_reduce(contrib, off, "sum"),
        4 * ep + 4 * (vp + 1) + 4 * vp,
        lambda: K.segment_reduce_plain(contrib, off, "sum"),
        lambda: torch.segment_reduce(contrib, "sum", offsets=off64,
                                     unsafe=True),
        "segment_reduce sum (torch.segment_reduce)")))
    # the counts as a product: the CSC as a CSR matrix of ones times the
    # frontier
    ones = torch.sparse_csr_tensor(off, csrc, torch.ones(
        ep, device=csrc.device), size=(vp, vp))
    ff = f.float()
    t.update(prefixed("advance_count", against_library(
        lambda: K.advance_count(f, off, csrc),
        4 * ep + 4 * (vp + 1) + vp + 4 * vp,
        lambda: K.advance_count_plain(f, off, csrc),
        lambda: torch.mv(ones, ff),
        "advance_count (torch.mv on the CSC as a sparse CSR matrix of "
        "ones)")))
    t["advance_count/tier"] = K.advance_count_tier(vp, f.device)
    glob = (f, off, csrc, COUNT_GLOBAL_CAP)
    t["advance_count/global"] = per_call(lambda: K.advance_count(*glob))
    t["advance_count/global_device"], t["advance_count/global_rows"] = \
        device_ms(lambda: K.advance_count(*glob), SPMV_REPS)
    t["frontiers"] = (int(f.sum()), int(sf.sum()))
    return t


@contextlib.contextmanager
def gather_path(packed: bool):
    """gather_payloads made to take one path, packed (2-4 payloads) or
    unpacked, whatever its rule (kernels.operators.gather_packs) would
    choose at the shape, while the block runs."""
    from essentials_tpu_torch.kernels import operators as KO
    rule = KO.gather_packs
    KO.gather_packs = lambda n, lengths: packed and len(lengths) > 1
    try:
        yield
    finally:
        KO.gather_packs = rule


def gather_against_index_select(idx, pays, stacked, auto: str) -> dict:
    """gather_payloads' device time per call through ``idx`` (the wrapper's
    own choice, which must be to pack where ``auto`` is "packed") beside
    torch.index_select's of ``stacked`` (the payloads side by side, one
    row per index, built outside the timed call). Keys under
    gather_payloads: /device, /device_rows, /library_device, /packs."""
    from essentials_tpu_torch import kernels as K
    packs = K.operators.gather_packs(idx.numel(),
                                     [p.numel() for p in pays])
    check(packs == (auto == "packed"), f"gather_payloads at n = "
                                       f"{idx.numel()} packs: {packs}")
    t = {"gather_payloads/packs": packs}
    t["gather_payloads/device"], t["gather_payloads/device_rows"] = \
        device_ms(lambda: K.gather_payloads(idx, *pays), SPMV_REPS)
    t["gather_payloads/library_device"] = device_ms(
        lambda: torch.index_select(stacked, 0, idx), SPMV_REPS)[0]
    return t


def print_gather(card: str, where: str, t: dict, key: str) -> None:
    lib_dev = t[key + "/library_device"]
    path = "packed" if t[key + "/packs"] else "unpacked"
    print_device(card, f"{key} {where} ({path}; torch.index_select: "
                       + ("not measured" if lib_dev is None
                          else f"{lib_dev:.4f} ms of device time") + ")",
                 t[key + "/device"], t[key + "/device_rows"])


# ------------------------------------------------------------ phase 15 --

def tc_graph(scale: int, weighted: bool = True):
    """The undirected RMAT graph of ``scale`` (edge factor 16, seed 1); at
    scale 17 the suite's gen:rmat17x16 (benchmarks/run_benchmarks.py:34-38,
    weighted; TC reads no weights)."""
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.io import generate
    t0 = time.perf_counter()
    csr = Csr.from_coo(generate.rmat(scale, EDGE_FACTOR, seed=SEED,
                                     undirected=True, weighted=weighted))
    print(f"graph: rmat{scale} ef{EDGE_FACTOR} seed {SEED} undirected: "
          f"V={csr.n_rows} E={csr.nnz}, built in "
          f"{time.perf_counter() - t0:.1f} s")
    return csr


def bitmap_inputs(csr) -> tuple:
    """(eu, ev, bitmap) on the card: TC's oriented edges and packed rows."""
    from essentials_tpu_torch.algorithms import tc
    from essentials_tpu_torch.ops import bitmap_intersect as BI
    _, es, ec = tc._oriented_csr(csr)
    bitmap = torch.from_numpy(BI.pack_bitmap_rows(csr.n_rows, es, ec)).cuda()
    return (torch.from_numpy(es.astype(np.int32)).cuda(),
            torch.from_numpy(ec.astype(np.int32)).cuda(), bitmap)


def check_bitmap_kernel(csr, where: str, errs: dict) -> tuple:
    """bitmap_intersect_counts over every oriented edge, witness on and
    off, against its plain version and a second launch. Returns its
    inputs."""
    from essentials_tpu_torch import kernels as K
    args = bitmap_inputs(csr)
    for witness in (True, False):
        outs = [f(*args, witness) for f in (K.bitmap_intersect_counts,
                                            K.bitmap_intersect_counts,
                                            K.bitmap_intersect_counts_plain)]
        check(witness == (outs[0][1] is not None), "witness output")
        hold_exact("bitmap_intersect_counts",
                   *[[t for t in o if t is not None] for o in outs], errs,
                   f"{where} witness {witness}")
    cnt = outs[0][0]
    print(f"kernels: {where}: bitmap_intersect_counts over "
          f"{cnt.numel()} oriented edges ({args[2].shape[1] * 4} B rows, "
          f"{args[2].numel() * 4 / 1e9:.3f} GB bitmap), "
          f"{int(cnt.sum(dtype=torch.int64))} triangles, witness on and "
          f"off: exact against plain, repeatable")
    return args


def hub_pairs_inputs(seed: int = COLOR_SEED) -> tuple:
    """NumPy (eu, ev, bitmap) of unsorted query pairs: a bitmap of
    HUB_PAIRS rows and words, the last row all zero, the others with 0.5%
    of their bits set but a hub u (row 7) with 20% (every word non-zero);
    random pairs, the hub as u in HUB_PAIRS[3] of them scattered among the
    rest, and pads (both ends the zero row) among them."""
    rng = np.random.default_rng(seed)
    rows, words, npairs, nhub, npads = HUB_PAIRS
    bits = rng.random((rows, words * 32)) < 0.005
    bits[7] = rng.random(words * 32) < 0.2
    bits[-1] = False
    bitmap = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    eu = rng.integers(0, rows - 1, npairs)
    ev = rng.integers(0, rows - 1, npairs)
    eu[rng.choice(npairs, nhub, replace=False)] = 7
    pads = rng.choice(npairs, npads, replace=False)
    eu[pads] = ev[pads] = rows - 1
    return eu.astype(np.int32), ev.astype(np.int32), bitmap


def check_hub_pairs(errs: dict) -> None:
    """bitmap_intersect_counts on hub_pairs_inputs, witness on and off,
    against its plain version and a second launch."""
    from essentials_tpu_torch import kernels as K
    args = [torch.from_numpy(a).cuda() for a in hub_pairs_inputs()]
    for witness in (True, False):
        outs = [f(*args, witness) for f in (K.bitmap_intersect_counts,
                                            K.bitmap_intersect_counts,
                                            K.bitmap_intersect_counts_plain)]
        hold_exact("bitmap_intersect_counts",
                   *[[t for t in o if t is not None] for o in outs], errs,
                   f"unsorted pairs with a hub, witness {witness}")
    rows, words, npairs, nhub, npads = HUB_PAIRS
    print(f"kernels: bitmap_intersect_counts on {npairs} unsorted pairs "
          f"({nhub} of a hub u with every word non-zero, {npads} pads) over "
          f"{rows} rows of {words} words, {int(outs[0][0].sum())} common "
          f"bits, witness on and off: exact against plain, repeatable")


def check_fill_kernels(g, source: int, where: str, errs: dict) -> dict:
    """The three fill/route kernels at every level of one search from
    ``source`` on whole-segment levels, each against its plain version and
    a second launch, and the 5-pass level they make against bfs_level at
    segment starts. Returns the inputs of the level with the most new
    vertices (for timing)."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    flags, eid, off = g.csc_seg_flags, g.csc_edge_ids, g.row_offsets
    starts = off[:-1][off[1:] > off[:-1]].long()
    lev = FB.init_lev_exp(g, source)
    full = lev.clone()               # init_lev_exp fills whole segments
    w = torch.linspace(0.5, 2.0, g.n_edges_padded, device=g.device)
    best, it = None, 0
    while True:
        args = (full, eid, flags, it)
        z = K.fused_route_or(*args)
        hold_exact("fused_route_or", (z,), (K.fused_route_or(*args),),
                   (K.fused_route_or_plain(*args),), errs,
                   f"{where} level {it}")
        s = K.scan(z, flags, "add")
        sf = K.scan(z.float() * w, flags, "add")   # a float32 S
        for x in (s, sf):
            k = K.segment_broadcast_total(x, flags)
            hold_exact("segment_broadcast_total", (exact_bits(k),),
                       (exact_bits(K.segment_broadcast_total(x, flags)),),
                       (exact_bits(K.segment_broadcast_total_plain(x,
                                                                   flags)),),
                       errs, f"{where} level {it} {x.dtype}")
        args = (s, flags, full, it + 1)
        new = K.suffix_fill_update(*args)
        hold_exact("suffix_fill_update", new, K.suffix_fill_update(*args),
                   K.suffix_fill_update_plain(*args), errs,
                   f"{where} level {it}")
        cnt = K.bfs_level(lev, *level_args(g), it, FB.UNREACHED)
        check(torch.equal(new[0][starts], lev[starts])
              and int(new[1]) == int(cnt > 0),
              f"{where} level {it}: the 5-pass level differs from bfs_level")
        n_new = int(cnt)
        if best is None or n_new > best[0]:
            best = (n_new, {"route": (full, eid, flags, it),
                            "fill": args, "broadcast": (sf, flags)})
        full, it = new[0], it + 1
        if n_new == 0:
            break
    print(f"kernels: {where} from {source}: {it} levels; fused_route_or, "
          f"segment_broadcast_total (int32, float32) and suffix_fill_update "
          f"exact against plain and repeatable at every level; the 5-pass "
          f"level equals bfs_level<int32> at segment starts")
    return best[1]


def route_inputs(n: int, rng) -> dict:
    """fused_route_or's (lev, eid, it) over [n] by what the compare sees:
    seeded levels 0-3 with INT32_MAX (unreached) at about a third, eid a
    seeded permutation, and `it` 1 (some hits), 9 (none) and INT32_MAX
    (the sentinel); and levels all 2 under `it` 2 (every position hits)."""
    from essentials_tpu_torch import kernels as K
    lev = torch.from_numpy(np.where(rng.random(n) < 0.3, K.INT32_MAX,
                                    rng.integers(0, 4, n)).astype(
                                        np.int32)).cuda()
    eid = torch.from_numpy(rng.permutation(n).astype(np.int32)).cuda()
    return {"some hits": (lev, eid, 1), "no hit": (lev, eid, 9),
            "the sentinel": (lev, eid, K.INT32_MAX),
            "every hit": (torch.full_like(lev, 2), eid, 2)}


def check_fill_shapes(errs: dict) -> None:
    """segment_broadcast_total (int32 and float32 S), suffix_fill_update and
    fused_route_or (under each of route_inputs) at n = 1, a tile - 1, a
    tile, a tile + 1, FILL_LONG + 3 tiles and SCAN_MANY scan tiles (a
    route OR carry across scan groups), with flags sparse (1%), at every
    position, only at position 0, and with one segment across FILL_LONG
    tiles, each against its plain version and a second launch, bitwise;
    then one device launch per call of each under the largest n's four
    flag sets."""
    from essentials_tpu_torch import kernels as K
    rng = np.random.default_rng(15)
    tile = K.FILL_TILE
    cases = 0
    for n in (1, tile - 1, tile, tile + 1, (FILL_LONG + 3) * tile + 77,
              SCAN_MANY * K.SCAN_TILE + 5):
        pos = torch.arange(n, device="cuda")
        flag_sets = {
            "sparse": torch.from_numpy(rng.random(n) < 0.01).cuda(),
            "every": torch.ones(n, dtype=torch.uint8, device="cuda"),
            "only 0": pos == 0,
            f"{FILL_LONG} tiles": (pos == 0) | (pos == min(100, n - 1))
            | (pos == min(100 + FILL_LONG * tile, n - 1))}
        si = torch.from_numpy(rng.integers(-3, 3, n).astype(np.int32)).cuda()
        sf = torch.from_numpy(rng.random(n).astype(np.float32)).cuda()
        lev = torch.where(torch.from_numpy(rng.random(n) < 0.5).cuda(),
                          K.INT32_MAX, si)
        routes = route_inputs(n, rng)
        for label, fl in flag_sets.items():
            where = f"n = {n}, flags {label}"
            for x in (si, sf):
                k = K.segment_broadcast_total(x, fl)
                hold_exact("segment_broadcast_total", (exact_bits(k),),
                           (exact_bits(K.segment_broadcast_total(x, fl)),),
                           (exact_bits(K.segment_broadcast_total_plain(x,
                                                                       fl)),),
                           errs, f"{where} {x.dtype}")
            args = (si, fl, lev, 7)
            hold_exact("suffix_fill_update", K.suffix_fill_update(*args),
                       K.suffix_fill_update(*args),
                       K.suffix_fill_update_plain(*args), errs, where)
            for what, (rl, eid, it) in routes.items():
                args = (rl, eid, fl, it)
                hold_exact("fused_route_or", (K.fused_route_or(*args),),
                           (K.fused_route_or(*args),),
                           (K.fused_route_or_plain(*args),), errs,
                           f"{where}, {what}")
            cases += 1
    rl, eid, it = routes["some hits"]
    seen = {}
    for name, call in (
            ("segment_broadcast_total",
             lambda fl: K.segment_broadcast_total(sf, fl)),
            ("suffix_fill_update",
             lambda fl: K.suffix_fill_update(si, fl, lev, 7)),
            ("fused_route_or", lambda fl: K.fused_route_or(rl, eid, fl, it))):
        seen[name] = sum(check_one_launch(
            name, lambda fl=fl: call(fl), f"n = {n}, flags {label}")
            for label, fl in flag_sets.items())
        check(seen[name] > 0, f"{name}: launches per call measured in none "
                              f"of the {len(flag_sets)} forms profiled")
    print(f"kernels: fills and route OR at n = 1 to {SCAN_MANY} scan tiles: "
          f"{cases} flag sets, segment_broadcast_total (int32, float32), "
          f"suffix_fill_update and fused_route_or ({len(routes)} level sets) "
          f"exact against plain and repeatable, a segment across "
          f"{FILL_LONG} fill tiles included; one device launch per call in "
          f"{seen} of {len(flag_sets)} forms profiled each (the others not "
          f"measured)")


# ------------------------------------------------------------ phase 16 --

def host_vertex_triangles(csr) -> tuple:
    """(total, each vertex's triangles int64) on the host: a vectorised,
    row-blocked scipy form of tc.cpu_reference over the oriented adjacency
    A: lowest role = rowsum((A A) * A), highest = its colsum, middle =
    rowsum((A^T A) * A)."""
    import scipy.sparse as sp
    from essentials_tpu_torch.algorithms import tc
    n = csr.n_rows
    _, es, ec = tc._oriented_csr(csr)
    a = sp.csr_matrix((np.ones(len(es), np.int64), (es, ec)), shape=(n, n))
    at = a.T.tocsr()
    lo, hi, mid = (np.zeros(n, np.int64) for _ in range(3))
    step = 1 << 14
    for r in range(0, n, step):
        blk = a[r:r + step]
        m = (blk @ a).multiply(blk)
        lo[r:r + step] = np.asarray(m.sum(1)).ravel()
        hi += np.asarray(m.sum(0)).ravel()
        mid[r:r + step] = np.asarray(
            (at[r:r + step] @ a).multiply(blk).sum(1)).ravel()
    return int(lo.sum()), lo + hi + mid


def seeded_pairs(csr) -> tuple:
    """PAIRS query pairs: the endpoints of edges drawn from a seed, so that
    hubs appear as they do in a graph's edges."""
    rng = np.random.default_rng(PAIR_SEED)
    src = np.repeat(np.arange(csr.n_rows), np.diff(csr.row_offsets))
    e1, e2 = rng.integers(0, csr.nnz, (2, PAIRS))
    return src[e1].astype(np.int32), csr.col_indices[e2].astype(np.int32)


def host_intersections(csr, u, v) -> tuple:
    """(counts, witness histogram, jaccard) from host sets."""
    off, cols = csr.row_offsets, csr.col_indices
    nb = {q: set(cols[off[q]:off[q + 1]].tolist())
          for q in np.unique(np.concatenate([u, v])).tolist()}
    counts = np.zeros(len(u), np.int64)
    wit = np.zeros(csr.n_rows, np.int64)
    jac = np.zeros(len(u))
    for i, (a, b) in enumerate(zip(u.tolist(), v.tolist())):
        common = nb[a] & nb[b]
        counts[i] = len(common)
        wit[list(common)] += 1
        jac[i] = len(common) / max(len(nb[a] | nb[b]), 1)
    return counts, wit, jac


def tc_main_path(csr17, csr20, csr13, g_u, csr_u) -> dict:
    """Phase 16's paths, each with the launch counts set to 0 just before
    it and read just after, which must be exactly the launches it makes.
    Returns ({path: {kernel: launches}}, the TC results by path)."""
    from essentials_tpu_torch.algorithms import bfs, pr, tc
    from essentials_tpu_torch.ops import fused_bfs as FB
    from essentials_tpu_torch.ops import intersect
    by_path, results = {}, {}

    def run_counted(path: str, fn, expect):
        r, launches = counted(fn)
        ran = {k: n for k, n in launches.items() if n}
        want = {k: n for k, n in expect(r).items() if n}
        check(ran == want, f"{path} launched {ran}, expected {want}")
        by_path[path] = launches
        return r

    # TC auto on gen:rmat17x16: the bitmap path
    check(tc.auto_variant(csr17.n_rows, "cuda") == "bitmap",
          "tc auto does not choose bitmap at rmat17")
    r = run_counted(f"tc auto rmat{TC_SCALE}",
                    lambda: tc.run(csr17, warmup=False),
                    lambda r: {"bitmap_intersect_counts": 1})
    t0 = time.perf_counter()
    total17 = tc.cpu_reference_total(csr17)
    t_total = time.perf_counter() - t0
    t0 = time.perf_counter()
    host_total, host_vt = host_vertex_triangles(csr17)
    t_vt = time.perf_counter() - t0
    vt = r.vertex_triangles.cpu().numpy()
    check(r.total == total17 == host_total == TC_RMAT17_TOTAL,
          f"tc bitmap rmat{TC_SCALE} total {r.total}, host {total17} / "
          f"{host_total}")
    check(vt.shape == (csr17.n_rows,) and np.array_equal(vt, host_vt),
          f"tc bitmap rmat{TC_SCALE} vertex_triangles differ from the host")
    print(f"main path: tc auto (bitmap) rmat{TC_SCALE}: {r.total} "
          f"triangles, equal to cpu_reference_total ({t_total:.1f} s on the "
          f"host) and per vertex to the row-blocked scipy count "
          f"({t_vt:.1f} s); launches exact")
    results["bitmap"] = r
    for csr, scale in ((csr17, TC_SCALE), (csr20, MAIN_SCALE)):
        # one sort and one scan per chunk of passes
        chunks = len(tc.shift_chunks(np.diff(tc._oriented_csr(csr)[0])))
        r = run_counted(f"tc shift rmat{scale}",
                        lambda csr=csr: tc.run(csr, variant="shift",
                                               warmup=False),
                        lambda r, chunks=chunks: {"scan": chunks})
        want = total17 if csr is csr17 else TC_RMAT20_TOTAL
        check(r.total == want, f"tc shift rmat{scale} total {r.total}, "
                               f"expected {want}")
        print(f"main path: tc shift gen:rmat{scale}x16: {r.total} "
              f"triangles in {chunks} chunk(s), equal to "
              + ("cpu_reference_total" if csr is csr17 else
                 "benchmarks/PARITY.md:58's count") + "; launches exact")
    results["shift"] = r

    # dense, bitmap and sorted on rmat13 (V = 8192)
    ref_total, ref_vt = tc.cpu_reference(csr13)
    noff, es, _ = tc._oriented_csr(csr13)
    chunks = len(tc.wedge_bounds(np.diff(noff)[es])) - 1
    expect = {"dense": {}, "bitmap": {"bitmap_intersect_counts": 1},
              "sorted": {"scan": chunks}}
    for v, launches in expect.items():
        r = run_counted(f"tc {v} rmat{TC_DENSE_SCALE}",
                        lambda v=v: tc.run(csr13, variant=v, warmup=False),
                        lambda r, launches=launches: launches)
        check(r.total == ref_total and np.array_equal(
            r.vertex_triangles.cpu().numpy(), ref_vt),
            f"tc {v} rmat{TC_DENSE_SCALE} differs from cpu_reference")
        results[v] = r
    print(f"main path: tc dense, bitmap and sorted rmat{TC_DENSE_SCALE} "
          f"(V={csr13.n_rows}): {ref_total} triangles, each equal to "
          f"cpu_reference in total and per vertex; launches exact")

    # the intersection operator, all rows (rmat17) and chunked (rmat20)
    for csr in (csr17, csr20):
        u, v = seeded_pairs(csr)
        ref, wref, jref = host_intersections(csr, u, v)
        chunked = csr.n_rows > intersect._DENSE_V_MAX
        nq = np.unique(np.concatenate([u, v])).size
        n_launch = (-(-csr.n_rows // intersect.chunk_bits(nq)) if chunked
                    else 1)
        where = f"rmat{csr.n_rows.bit_length() - 1}"
        got, wit = run_counted(
            f"intersect {where}",
            lambda: intersect.intersection_counts(csr, u, v, witnesses=True),
            lambda r: {"bitmap_intersect_counts": n_launch})
        jac = run_counted(f"jaccard {where}",
                          lambda: intersect.jaccard(csr, u, v),
                          lambda r: {"bitmap_intersect_counts": n_launch})
        check(np.array_equal(got.cpu().numpy(), ref)
              and np.array_equal(wit.cpu().numpy(), wref),
              f"intersection_counts {where} differ from host sets")
        check(np.allclose(jac.cpu().numpy(), jref, rtol=1e-12, atol=0),
              f"jaccard {where} outside rtol 1e-12 of host sets")
        engine = "chunked" if chunked else "all rows"
        print(f"main path: intersect {where} ({engine}, {n_launch} "
              f"launch(es)): {PAIRS} pairs, {int(ref.sum())} "
              f"common neighbours, {int((ref > 0).sum())} pairs with one; "
              f"counts and witnesses equal host sets, jaccard within rtol "
              f"1e-12; launches exact")

    # one BFS on the 5-pass level, against bfs.run
    s = int(np.argmax(np.diff(csr_u.row_offsets)))

    def five_pass_bfs():
        lev, it = FB.init_lev_exp(g_u, s), 0
        while True:
            lev, any_ = FB.five_pass_superstep(g_u, lev, it)
            it += 1
            if not int(any_):
                return FB.collapse_lev_exp(g_u, lev, s), it
    (dist, levels) = run_counted(
        f"bfs 5-pass rmat{SCALE}", five_pass_bfs,
        lambda r: {"fused_route_or": r[1], "scan": r[1],
                   "suffix_fill_update": r[1], "collapse_levels<int32>": 1})
    ref = bfs.run(g_u, s, variant="fused", warmup=False,
                  compute_predecessors=False)
    check(torch.equal(dist[:g_u.n_vertices], ref.distances)
          and levels == ref.iterations,
          f"the 5-pass BFS from {s} differs from bfs.run")
    print(f"main path: bfs on five_pass_superstep rmat{SCALE} from {s}: "
          f"{levels} levels, distances equal bfs.run fused; launches exact")

    # PageRank fused on the undirected BFS graph
    r_f = run_counted(
        "pr fused", lambda: pr.run(g_u, variant="fused", warmup=False),
        lambda r: {"spmv_rows": 1, "expand_segments": 1,
                   "gather_payloads": r.iterations, "scan": r.iterations,
                   "segment_broadcast_total": r.iterations,
                   "collapse_starts": 1})
    r_s = pr.run(g_u, variant="spmv", warmup=False)
    ref_pr, it_pr = pr.cpu_run(csr_u)
    hold_host(r_f.ranks.cpu().numpy(), ref_pr,
              f"pr fused undirected rmat{SCALE}", g_u.n_vertices)
    err, rel, ok = sum_errors(r_f.ranks, r_s.ranks)
    check(ok and rel <= PR_HITS_MAX_REL,
          f"pr fused and spmv disagree (max abs {err}, max rel {rel})")
    print(f"main path: pr fused undirected rmat{SCALE}: {r_f.iterations} "
          f"iterations (spmv {r_s.iterations}, host float64 {it_pr}); max "
          f"abs err {err:.6g}, max rel {rel:.3g} against spmv; launches "
          f"exact")
    return by_path, results


# ------------------------------------------------------------ phase 17 --

def time_tc(csr17, csr20, csr13, g_u, card: str, pr_launches: int) -> None:
    """TC ms per run (what tc.run's elapsed_ms covers: the device work
    after the packing and copy, one warm-up run first) and triangles per
    second; PageRank ms per iteration per variant; the profiler's idle
    share over one TC bitmap run (host packing included), one TC shift run
    at rmat17 (host planning included) and one PageRank fused run, taken
    again (up to three times) until it shows all its ``pr_launches``
    launches of our kernels."""
    from essentials_tpu_torch.algorithms import pr, tc
    for v, csr, label, runs in (("bitmap", csr17, f"rmat{TC_SCALE}",
                                 TC_CYCLES),
                                ("shift", csr20, f"rmat{MAIN_SCALE}", 1),
                                ("dense", csr13, f"rmat{TC_DENSE_SCALE}",
                                 CYCLES)):
        rs = [tc.run(csr, variant=v) for _ in range(runs)]
        ms = float(np.median([r.elapsed_ms for r in rs]))
        print(f"time [{card}]: tc {v} {label}: {ms:.4f} ms per run "
              f"(median of {runs}, each after a warm-up run), "
              f"{rs[0].total / ms * 1e3:.4g} triangles/s")
    for v in pr.SYMMETRIC_VARIANTS:
        r = pr.run(g_u, variant=v)
        print(f"time [{card}]: pr {v} undirected rmat{SCALE}: "
              f"{r.elapsed_ms / r.iterations:.4f} ms per iteration, "
              f"{r.iterations} iterations, {r.elapsed_ms:.3f} ms in all "
              f"(after one warm-up run)")
    profile(f"tc bitmap rmat{TC_SCALE}, one tc.run (packing included)",
            lambda: tc.run(csr17, variant="bitmap", warmup=False), 1)
    profile(f"tc shift rmat{TC_SCALE}, one tc.run (planning included)",
            lambda: tc.run(csr17, variant="shift", warmup=False))
    for _ in range(3):             # a window that lost activities is retaken
        rows = profile(f"pr fused undirected rmat{SCALE}, one pr.run",
                       lambda: pr.run(g_u, variant="fused", warmup=False),
                       pr_launches)
        if launches_seen(rows) == pr_launches:
            break


def tc_shift_largest_chunk(csr, device) -> torch.Tensor:
    """The int32 records whose running max TC shift takes over its largest
    chunk of ``csr`` (the most records of one scan)."""
    from essentials_tpu_torch.algorithms import tc
    wec_pad, pos_end, edge_keys, chunks = tc._shift_prep(csr, device)
    parts = max(chunks, key=lambda c: sum(b for _, b in c))
    return tc._shift_runs(wec_pad, pos_end, edge_keys, parts)[0]


def time_scan_shapes(g, csr_m, card: str, launches: int) -> dict:
    """scan beside its plain version, its bound (each input read once, the
    scan written) and a PyTorch call computing the same function, wall and
    device time per call: with flags as PageRank fused runs it (a float32
    add segmented by the CSC segment starts of ``g``; no PyTorch call) under
    scan<seg>; an unsegmented float32 add at SCAN_BIG elements, beside
    torch.cumsum, under scan<f32>@big; and the int32 running max of TC
    shift's largest chunk on ``csr_m`` (gen:rmat20x16), beside
    torch.cummax, under scan<max>@tc."""
    from essentials_tpu_torch import kernels as K
    ep = g.n_edges_padded
    gen = torch.Generator(device=g.device).manual_seed(SEED)
    x = torch.rand(ep, generator=gen, device=g.device)
    fl = g.csc_seg_flags
    out = {}
    t = against_library(lambda: K.scan(x, fl, "add"), 9 * ep,
                        lambda: K.scan_plain(x, fl, "add"))
    print_against(card, f"scan with flags (float32 add, PageRank fused's "
                        f"shape, undirected rmat{SCALE}, Ep = {ep}; "
                        f"{launches} launches in one PageRank fused run)", t)
    out.update(prefixed("scan<seg>", t))
    big = torch.rand(SCAN_BIG, generator=gen, device=g.device)
    t = against_library(lambda: K.scan(big), 8 * SCAN_BIG,
                        lambda: K.scan_plain(big),
                        lambda: torch.cumsum(big, 0), "scan (torch.cumsum)")
    print_against(card, f"scan without flags (float32 add, n = {SCAN_BIG}: "
                        f"the longest look-back: each tile folds its group's "
                        f"tiles and the groups before it)", t,
                  "torch.cumsum")
    out.update(prefixed("scan<f32>@big", t))
    del big
    enc = tc_shift_largest_chunk(csr_m, g.device)
    n = enc.numel()
    t = against_library(lambda: K.scan(enc, None, "max"), 8 * n,
                        lambda: K.scan_plain(enc, None, "max"),
                        lambda: torch.cummax(enc, 0),
                        "scan (torch.cummax)", reps=2)
    print_against(card, f"scan without flags (int32 max, TC shift's largest "
                        f"chunk of gen:rmat{MAIN_SCALE}x16, n = {n})", t,
                  "torch.cummax (values and indices)")
    out.update(prefixed("scan<max>@tc", t))
    out["scan<max>@tc/n"] = n
    return out


def time_pr_gather(g, card: str, launches: int) -> dict:
    """gather_payloads as PageRank fused runs it (one [Ep] float32 payload
    through csc_edge_ids, unpacked) at ``g``'s shape: wall per call,
    SPMV_REPS back to back, and device time per call, beside
    torch.index_select of the same payload and the bound (the index, the
    payload and the output each moved once). Keys under
    gather_payloads@pr."""
    from essentials_tpu_torch import kernels as K
    ep = g.n_edges_padded
    z = torch.rand(ep, generator=torch.Generator(device=g.device)
                   .manual_seed(SEED), device=g.device)
    ids = g.csc_edge_ids
    t = gather_against_index_select(ids, (z,), z, "unpacked")
    t["gather_payloads"] = median_ms(lambda _: [
        K.gather_payloads(ids, z) for _ in range(SPMV_REPS)]) / SPMV_REPS
    t["gather_payloads/library"] = library_ms(
        "gather_payloads (torch.index_select)",
        lambda: torch.index_select(z, 0, ids), SPMV_REPS)
    t["gather_payloads/bound"] = bound(12 * ep)
    b, lib = t["gather_payloads/bound"], t["gather_payloads/library"]
    print(f"time [{card}]: gather_payloads as PageRank fused runs it (1 x "
          f"[Ep] through csc_edge_ids, undirected rmat{SCALE}, Ep = {ep}): "
          f"{t['gather_payloads']:.4f} ms per call, bound {b[0]:.4f} ms "
          f"({b[1]} at {b[2]} rate), torch.index_select "
          + ("not measured" if lib is None else f"{lib:.4f} ms")
          + f"; {launches} launches in one PageRank fused run")
    print_gather(card, f"undirected rmat{SCALE} (PageRank fused)", t,
                 "gather_payloads")
    return {k.replace("gather_payloads", "gather_payloads@pr", 1): v
            for k, v in t.items()}


def time_tc_fill_kernels(bitmap_args, fill_args) -> dict:
    """Each new kernel and its plain version per call through its wrapper:
    bitmap_intersect_counts (witness on, as TC runs it) over gen:rmat17x16's
    oriented edges, one call at a time; the fills and the route at rmat18
    at the inputs of the level with the most new vertices (the broadcast on
    float32 S) through against_library, the broadcast beside
    torch.repeat_interleave."""
    from essentials_tpu_torch import kernels as K
    t = {}
    eu, ev, bitmap = bitmap_args
    t["bitmap_intersect_counts"] = median_ms(
        lambda _: K.bitmap_intersect_counts(eu, ev, bitmap))
    t["bitmap_intersect_counts/plain"] = median_ms(
        lambda _: K.bitmap_intersect_counts_plain(eu, ev, bitmap), TC_CYCLES)
    # without the witness: what its atomics (one per common element) cost
    t["bitmap_intersect_counts/no_witness"] = median_ms(
        lambda _: K.bitmap_intersect_counts(eu, ev, bitmap, False))
    for suffix, witness in (("/device", True), ("/no_witness_device", False)):
        t["bitmap_intersect_counts" + suffix] = device_ms(
            lambda w=witness: K.bitmap_intersect_counts(eu, ev, bitmap, w),
            TC_CYCLES)[0]
    ne, row = eu.numel(), bitmap.shape[1] * 4
    us, listed, sectors = bitmap_work(eu, ev, bitmap)
    # each distinct u row read once, each 32-byte sector of B[v] that holds
    # a word under a non-zero word of B[u] read once (those of u rows are
    # already read), eu/ev read and cnt written, the witness array
    # written; an AND and a popcount per such word and pair
    t["bitmap_intersect_counts/bound"] = bound(
        us * row + 32 * sectors + 12 * ne + 32 * row, 2 * listed)
    # the same, but one sector read for each such word and pair
    t["bitmap_intersect_counts/bound_per_pair"] = bound(
        us * row + 32 * listed + 12 * ne + 32 * row, 2 * listed)
    t["bitmap_intersect_counts/work"] = {"u_rows": us,
                                         "listed_words": listed,
                                         "other_sectors": sectors}
    # each row the pairs name read once (every word of B[v], not only those
    # under B[u]'s non-zero words), and an AND and a popcount per word of
    # each pair: the earlier work model
    named = torch.unique(torch.cat([eu, ev])).numel()
    t["bitmap_intersect_counts/bound_named_rows"] = bound(
        named * row + 12 * ne + 32 * row, 2 * ne * row / 4)
    # the same, but B[v] read per pair: the TPU kernel's streaming model
    t["bitmap_intersect_counts/bound_streaming"] = bound(
        ne * row + us * row + 12 * ne + 32 * row, 2 * ne * row / 4)
    t["bitmap_intersect_counts/library"] = None
    route, fill, (s, flags) = (fill_args[k] for k in ("route", "fill",
                                                       "broadcast"))
    n = route[0].numel()
    # lev (gathered, each read once), ids and flags read, z written
    t.update(prefixed("fused_route_or", against_library(
        lambda: K.fused_route_or(*route), 13 * n,
        lambda: K.fused_route_or_plain(*route))))
    t["fused_route_or/bound_sectors"] = route_sector_bound(n)
    t.update(prefixed("suffix_fill_update", against_library(
        lambda: K.suffix_fill_update(*fill), fill_bytes(fill[1], True),
        lambda: K.suffix_fill_update_plain(*fill))))
    t.update(prefixed("segment_broadcast_total", against_library(
        lambda: K.segment_broadcast_total(s, flags), fill_bytes(flags),
        lambda: K.segment_broadcast_total_plain(s, flags),
        repeat_interleave_of(s, flags),
        "segment_broadcast_total (torch.repeat_interleave of the "
        "segment-end values)")))
    return t


def route_sector_bound(n: int) -> tuple:
    """fused_route_or's bound over n positions with each lev gather a
    32-byte sector at the run's L2 rate, beside the streamed ids, flags and
    output (9 bytes a position at bound()'s rate for them)."""
    ms, _, memory = bound(9 * n)
    return (ms + 32 * n / MEMORY_RATE["L2"] * 1e3, "bytes",
            f"L2 sectors + {memory}")


def bitmap_work(eu: torch.Tensor, ev: torch.Tensor, bitmap: torch.Tensor,
                rows_at_once: int = 4096, pairs_at_once: int = 1 << 16
                ) -> tuple:
    """What bitmap_intersect_counts must read: (the distinct u rows, the
    sum over pairs of B[u]'s non-zero words (the B[v] words under them),
    the distinct 32-byte sectors of B[v] holding such words in rows that
    are no u row)."""
    us = torch.unique(eu)
    rows, words = bitmap.shape
    rr, ww = [], []
    for lo in range(0, us.numel(), rows_at_once):
        r = us[lo:lo + rows_at_once].long()
        i, w = (bitmap[r] != 0).nonzero(as_tuple=True)
        rr.append(r[i])
        ww.append(w)
    nz_row, nz_word = torch.cat(rr), torch.cat(ww)   # sorted by row
    cnt = torch.bincount(nz_row, minlength=rows)
    first = torch.cumsum(cnt, 0) - cnt
    listed = int(cnt[eu.long()].sum())
    is_u = torch.zeros(rows, dtype=torch.bool, device=eu.device)
    is_u[us.long()] = True
    keys = []
    for lo in range(0, eu.numel(), pairs_at_once):
        u, v = eu[lo:lo + pairs_at_once].long(), ev[lo:lo + pairs_at_once]
        keep = ~is_u[v.long()]
        u, v = u[keep], v[keep].long()
        n = cnt[u]
        total = int(n.sum())
        if total == 0:
            continue
        own = torch.repeat_interleave(torch.arange(u.numel(),
                                                   device=u.device), n,
                                      output_size=total)
        at = first[u][own] + torch.arange(total, device=u.device) \
            - (torch.cumsum(n, 0) - n)[own]
        keys.append(torch.unique(v[own] * (words // 8) + nz_word[at] // 8))
    sectors = int(torch.unique(torch.cat(keys)).numel()) if keys else 0
    return us.numel(), listed, sectors


def segment_ends(flags: torch.Tensor) -> torch.Tensor:
    """[n] bool: the last position of each segment that the start
    ``flags`` mark (position 0 always starts one)."""
    return torch.cat([flags[1:].bool(), torch.ones(1, dtype=torch.bool,
                                                   device=flags.device)])


def fill_bytes(flags: torch.Tensor, update: bool = False) -> int:
    """The bytes a segment fill over ``flags`` must move: the flags read
    once, S read only at the segment ends (each 32-byte sector of S that
    holds an end once), the output written once; the update
    (suffix_fill_update) also reads lev."""
    n = flags.numel()
    sectors = torch.unique(torch.nonzero(segment_ends(flags))[:, 0] // 8)
    return n + 32 * sectors.numel() + 4 * n + (4 * n if update else 0)


def repeat_interleave_of(s: torch.Tensor, flags: torch.Tensor):
    """A call of torch.repeat_interleave of S's segment-end values by the
    segments' lengths: one PyTorch call computing segment_broadcast_total
    (a yardstick the port never calls)."""
    ends = segment_ends(flags)
    vals, n = s[ends], s.numel()
    lens = torch.diff(torch.nonzero(ends)[:, 0], prepend=torch.tensor(
        [-1], device=flags.device))
    return lambda: torch.repeat_interleave(vals, lens, output_size=n)


def time_pr_broadcast(g, card: str, launches: int) -> dict:
    """segment_broadcast_total as PageRank fused runs it (float32 S, the
    segmented sum of a random [Ep] over the CSC segment starts of ``g``)
    beside its plain version, its bound and torch.repeat_interleave of the
    segment-end values, wall and device time per call. Keys under
    segment_broadcast_total@pr."""
    from essentials_tpu_torch import kernels as K
    ep, fl = g.n_edges_padded, g.csc_seg_flags
    m = torch.rand(ep, generator=torch.Generator(device=g.device)
                   .manual_seed(SEED), device=g.device)
    S = K.scan(m, fl, "add")
    t = against_library(
        lambda: K.segment_broadcast_total(S, fl), fill_bytes(fl),
        lambda: K.segment_broadcast_total_plain(S, fl),
        repeat_interleave_of(S, fl),
        "segment_broadcast_total (torch.repeat_interleave)")
    print_against(card, f"segment_broadcast_total as PageRank fused runs it "
                        f"(float32 S, undirected rmat{SCALE}, Ep = {ep}; "
                        f"{launches} launches in one PageRank fused run)", t,
                  "torch.repeat_interleave")
    return {"segment_broadcast_total@pr" + k: v for k, v in t.items()}


# ------------------------------------------------------------ phase 18 --

def check_minmax_kernel(g, where: str, errs: dict) -> None:
    """segment_minmax over JP's per-edge priorities (m of its WAVES rows)
    under three active masks: all true, a seeded 30%, and the uncolored
    mask after one JP round; against its plain version exactly and a
    second launch bitwise."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import color
    from essentials_tpu_torch.ops.advance import _expand_and_route
    state = color.init(g)
    after = color.step(g, state, 0)
    uncolored, _ = _expand_and_route(g, after.frontier, "vertices", ())
    ep, dev = g.n_edges_padded, g.device
    gen = torch.Generator(device=dev).manual_seed(COLOR_SEED)
    masks = {"all true": torch.ones(ep, dtype=torch.bool, device=dev),
             "30%": torch.rand(ep, generator=gen, device=dev) < 0.3,
             "uncolored after one JP round": uncolored}
    for label, active in masks.items():
        for m in COLOR_PAYLOADS:
            args = (list(state.pri_csc[:m]), active, g.csc_offsets)
            hold_exact("segment_minmax", K.segment_minmax(*args),
                       K.segment_minmax(*args),
                       K.segment_minmax_plain(*args), errs,
                       f"{where} m={m} {label}")
    print(f"kernels: {where}: segment_minmax at m = {COLOR_PAYLOADS} over "
          f"JP's priorities, masks {list(masks)} ("
          f"{int(uncolored.sum())} of {ep} edges uncolored after one round, "
          f"{after.live} vertices): exact against plain, repeatable")


def minmax_stress_inputs(device, m: int = 8, seed: int = COLOR_SEED,
                         short: int = MINMAX_SHORT,
                         long_tiles: int = MINMAX_LONG_TILES,
                         tile: int = 2048, tail: int = 2000) -> tuple:
    """segment_minmax's stress case: (m payload views, active view,
    offsets). Its segments in order: ``short`` of 0-4 slots (at the
    defaults their ends fall at every offset of a tile of ``tile``
    places), MINMAX_EMPTY_RUN empty ones, one of (long_tiles + 1) * tile
    slots, and ``tail`` of 0-63 slots, the first quarter of them all
    inactive.
    The offsets start at 37 and end 11 slots before n; the payloads are the
    rows of an [m, n + 1] array from element 1 on, the flags a view from
    element 3 (60% set)."""
    rng = np.random.default_rng(seed)
    lens = np.concatenate([rng.integers(0, 5, short),
                           np.zeros(MINMAX_EMPTY_RUN, np.int64),
                           [(long_tiles + 1) * tile],
                           rng.integers(0, 64, tail)])
    off = 37 + np.concatenate([[0], np.cumsum(lens)])
    n = int(off[-1]) + 11
    pays = torch.from_numpy(rng.integers(-2**31, 2**31, (m, n + 1),
                                         dtype=np.int64).astype(np.int32))
    act = rng.random(n + 3) < 0.6
    quiet = short + MINMAX_EMPTY_RUN + 1      # the first of the tail
    act[3 + off[quiet]:3 + off[quiet + tail // 4]] = False
    return ([pays.to(device)[k, 1:] for k in range(m)],
            torch.from_numpy(act).to(device)[3:],
            torch.from_numpy(off.astype(np.int32)).to(device))


def check_minmax_shapes(errs: dict) -> None:
    """segment_minmax on its stress case (minmax_stress_inputs) for 1, 3
    and 8 payloads, against its plain version exactly and a second launch
    bitwise; then one segment_split_kernel and one
    segment_minmax_kernel per call for each, by torch.profiler (fails
    where no form was measured)."""
    from essentials_tpu_torch import kernels as K
    pays, active, off = minmax_stress_inputs("cuda")
    ends = (off[1:] - off[0]).long() + torch.arange(off.numel() - 1,
                                                    device="cuda")
    check(torch.unique(ends % K.MINMAX_TILE).numel() == K.MINMAX_TILE,
          "segment_minmax's stress case misses a tile offset")
    check(pays[0].data_ptr() % 16 != 0 and active.data_ptr() % 16 != 0,
          "segment_minmax's stress views are aligned")
    seg = off[1:] - off[:-1]
    for m in COLOR_PAYLOADS:
        args = (pays[:m], active, off)
        hold_exact("segment_minmax", K.segment_minmax(*args),
                   K.segment_minmax(*args), K.segment_minmax_plain(*args),
                   errs, f"stress case m={m}")
    measured = sum(check_one_launch(
        "segment_minmax", lambda m=m: K.segment_minmax(pays[:m], active, off),
        f"stress case m={m}", ("segment_split_kernel",
                               "segment_minmax_kernel"))
        for m in COLOR_PAYLOADS)
    check(measured > 0, "segment_minmax: launches per call measured for no "
                        "payload count")
    print(f"kernels: segment_minmax stress case ({off.numel() - 1} "
          f"segments over {int(off[-1] - off[0])} slots from offset "
          f"{int(off[0])}, longest {int(seg.max())} slots = "
          f"{int(seg.max()) / K.MINMAX_TILE:.1f} tiles, "
          f"{int((seg == 0).sum())} empty, ends at all {K.MINMAX_TILE} "
          f"offsets of a tile, views at odd offsets) at m = "
          f"{COLOR_PAYLOADS}: exact against plain, repeatable; two device "
          f"launches a call (split, tiles) for {measured} of "
          f"{len(COLOR_PAYLOADS)} counts measured")


def check_wide_bitmap(errs: dict) -> None:
    """bitmap_intersect_counts on rows of BITMAP_WIDE_WORDS words, where
    the shared row and the kernel's static shared memory would pass the 48
    KiB a launch holds without opting in: witness on and off, against its
    plain version and a second launch."""
    from essentials_tpu_torch import kernels as K
    rng = np.random.default_rng(COLOR_SEED)
    rows, words = 65, BITMAP_WIDE_WORDS
    bits = rng.random((rows, words * 32)) < 0.01
    bitmap = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    bitmap[-1] = 0
    eu = np.sort(rng.integers(0, rows, 512)).astype(np.int32)
    ev = rng.integers(0, rows, 512).astype(np.int32)
    args = [torch.from_numpy(a).cuda() for a in (eu, ev, bitmap)]
    for witness in (True, False):
        outs = [f(*args, witness) for f in (K.bitmap_intersect_counts,
                                            K.bitmap_intersect_counts,
                                            K.bitmap_intersect_counts_plain)]
        hold_exact("bitmap_intersect_counts",
                   *[[t for t in o if t is not None] for o in outs], errs,
                   f"{words}-word rows witness {witness}")
    print(f"kernels: bitmap_intersect_counts at {words}-word "
          f"({words * 4} B) rows, 512 pairs, "
          f"{int(outs[0][0].sum())} common bits, witness on and off: exact "
          f"against plain, repeatable")


# ------------------------------------------------------------ phase 19 --

def expect_color(g, variant: str, r) -> dict:
    """Launches of one color.run from its tiers (spray, dense). JP: two
    gathers of the priorities at init; a dense round gathers the uncolored
    mask and takes segment_minmax once; a spray round scans three times
    (the members' prefix, the edge ids, the sources) and gathers the
    priorities through the sources (two launches). Spec: a dense round
    gathers colors and ranks by source and by destination and MAX-reduces;
    a spray round scans three times. With the spray on, every dense round
    compacts the next index list (one scan), and so does every spec
    round."""
    from essentials_tpu_torch.ops import sparse_advance as SA
    spray, dense = r.tiers
    on = SA.spray_enabled(g)
    if variant == "jp":
        return {"gather_payloads": 2 + dense + 2 * spray,
                "segment_minmax": dense, "scan": on * dense + 3 * spray}
    return {"gather_payloads": 2 * dense, "segment_reduce": dense,
            "scan": on * (dense + spray) + 3 * spray}


def color_main_path(csr_m, g_m, csr12, g12, csr_d, g_d) -> tuple:
    """color.run jp, spec and auto on gen:rmat20x16; both variants on rmat12
    against a run on a CPU copy of the graph; PageRank and HITS auto
    (generic) on the directed rmat20. Each run with the launch counts set
    to 0 just before it and read just after, which must be exactly the
    launches it makes. Returns ({path: {kernel: launches}}, the rmat20
    color results by variant)."""
    from essentials_tpu_torch.algorithms import color, hits, pr
    by_path, results = {}, {}

    def run_counted(path: str, fn, expect):
        r, launches = counted(fn)
        ran = {k: n for k, n in launches.items() if n}
        want = {k: n for k, n in expect(r).items() if n}
        check(ran == want, f"{path} launched {ran}, expected {want}")
        by_path[path] = launches
        return r

    where = f"gen:rmat{MAIN_SCALE}x16"
    check(color.auto_variant(g_m) == "spec",
          f"color auto does not choose spec on {where}")
    for v in ("jp", "spec", "auto"):
        want = color.auto_variant(g_m) if v == "auto" else v
        r = run_counted(f"color {v} rmat{MAIN_SCALE}",
                        lambda v=v: color.run(g_m, variant=v, warmup=False),
                        lambda r, want=want: expect_color(g_m, want, r))
        c = r.colors.cpu().numpy()
        check(c.shape == (g_m.n_vertices,) and color.validate(csr_m, c) == 0,
              f"color {v} on {where} is not a proper coloring")
        results[v] = r
        print(f"main path: color {v} {where}: {r.iterations} rounds (spray "
              f"{r.tiers[0]}, dense {r.tiers[1]}), {int(c.max()) + 1} colors "
              f"used, {np.unique(c).size} distinct; validate 0; launches "
              f"exact")
    check(torch.equal(results["auto"].colors, results["spec"].colors)
          and results["auto"].iterations == results["spec"].iterations,
          "color auto differs from spec")

    g_cpu = g12.to("cpu")
    check(color.auto_variant(g12) == "jp", "color auto is not jp at rmat12")
    for v in color.VARIANTS:
        r = run_counted(f"color {v} rmat12",
                        lambda v=v: color.run(g12, variant=v, warmup=False),
                        lambda r, v=v: expect_color(g12, v, r))
        r_cpu = color.run(g_cpu, variant=v, warmup=False)
        check(r.iterations == r_cpu.iterations
              and torch.equal(r.colors.cpu(), r_cpu.colors),
              f"color {v} rmat12 on the card differs from the CPU copy")
        check(color.validate(csr12, r_cpu.colors.numpy()) == 0,
              f"color {v} rmat12 is not a proper coloring")
        print(f"main path: color {v} rmat12: {r.iterations} rounds, colors "
              f"bitwise equal to the run on a CPU copy of the graph (plain "
              f"versions); launches exact")

    where_d = f"directed rmat{SPMV_TIME_SCALE} seed {SPMV_SEED}"
    check(not g_d.symmetric_layout, f"{where_d} has a symmetric layout")
    r_pr = run_counted("pr generic", lambda: pr.run(g_d, warmup=False),
                       lambda r: {"gather_payloads": r.iterations,
                                  "segment_reduce": r.iterations + 1})
    ref_pr, it_pr = pr.cpu_run(csr_d)
    hold_host(r_pr.ranks.cpu().numpy(), ref_pr, f"pr auto (generic) "
              f"{where_d}", g_d.n_vertices)
    print(f"main path: pr auto (generic) {where_d}: {r_pr.iterations} "
          f"iterations (host float64: {it_pr}); launches exact")
    r_h = run_counted("hits generic", lambda: hits.run(g_d, warmup=False),
                      lambda r: {"gather_payloads": 2 * r.iterations,
                                 "segment_reduce": 2 * r.iterations})
    ref_a, ref_h, it_h = hits.cpu_run(csr_d)
    hold_host(r_h.auth.cpu().numpy(), ref_a, "hits generic auth",
              g_d.n_vertices)
    hold_host(r_h.hub.cpu().numpy(), ref_h, "hits generic hub",
              g_d.n_vertices)
    print(f"main path: hits auto (generic) {where_d}: {r_h.iterations} "
          f"iterations (host float64: {it_h}); launches exact")
    return by_path, results


# ------------------------------------------------------------ phase 20 --

def time_color(g_m, results, g_d, card: str) -> None:
    """Color ms per run (what color.run's elapsed_ms covers, after its
    warm-up run) with rounds and distinct colors, and the device's idle
    share over one run of each variant; PageRank and HITS generic ms per
    iteration; the TPU's history beside them."""
    from essentials_tpu_torch.algorithms import color, hits, pr
    for v in color.VARIANTS:
        r = color.run(g_m, variant=v)
        check(torch.equal(r.colors, results[v].colors),
              f"color {v} differs between runs")
        print(f"time [{card}]: color {v} gen:rmat{MAIN_SCALE}x16: "
              f"{r.elapsed_ms:.3f} ms per run, {r.iterations} rounds, "
              f"{r.elapsed_ms / r.iterations:.4f} ms per round, "
              f"{torch.unique(r.colors).numel()} distinct colors (after one "
              f"warm-up run); TPU history (not a gate): "
              f"{TPU_COLOR_HISTORY[v]}")
        profile(f"color {v} gen:rmat{MAIN_SCALE}x16, one color.run",
                lambda v=v: color.run(g_m, variant=v, warmup=False))
    for name, fn in (("pr", pr.run), ("hits", hits.run)):
        r = fn(g_d, variant="generic")
        print(f"time [{card}]: {name} generic directed rmat{SPMV_TIME_SCALE} "
              f"seed {SPMV_SEED}: {r.elapsed_ms / r.iterations:.4f} ms per "
              f"iteration, {r.iterations} iterations, {r.elapsed_ms:.3f} ms "
              f"in all (after one warm-up run)")


def time_minmax_kernel(g_m) -> dict:
    """segment_minmax per launch with m = WAVES at gen:rmat20x16 under the
    first JP round's mask (every real edge active) and the uncolored mask
    after one round, wall and device time, beside its plain version, its
    bound, the library calls computing the same function and the 16
    segment_reduce launches (a MAX and a MIN per wave over masked values)
    that it replaces; and on the largest segment alone."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import color
    from essentials_tpu_torch.ops.advance import _expand_and_route
    state = color.init(g_m)
    pays, off = list(state.pri_csc), g_m.csc_offsets
    m, s, ep = len(pays), off.numel() - 1, g_m.n_edges_padded
    masks = {"": _expand_and_route(g_m, state.frontier, "vertices", ())[0],
             "@round1": _expand_and_route(g_m, color.step(
                 g_m, state, 0).frontier, "vertices", ())[0]}
    t = {}
    for tag, active in masks.items():
        n_active = int(active.sum())
        # active groups of 4 slots: the payload vectors the kernel reads
        groups = int(active[:ep // 4 * 4].view(-1, 4).any(1).sum())
        # flags read; the payloads at active positions read; offsets read;
        # max and min written
        k = against_library(
            lambda active=active: K.segment_minmax(pays, active, off),
            ep + 4 * m * n_active + 4 * (s + 1) + 8 * m * s,
            lambda active=active: K.segment_minmax_plain(pays, active, off))
        t.update(prefixed("segment_minmax" + tag, k))
        t[f"segment_minmax{tag}/active"] = (n_active, groups)
        t[f"segment_minmax{tag}/bound_groups"] = bound(
            ep + 16 * m * groups + 4 * (s + 1) + 8 * m * s)
    active = masks[""]
    # priorities are below 2^24, exact in float32; torch.segment_reduce
    # takes floating types: one amax and one amin call over [Ep, m]
    x = state.pri_csc.t().float()
    hi = torch.where(active[:, None], x, float("-inf")).contiguous()
    lo = torch.where(active[:, None], x, float("inf")).contiguous()
    off64 = off.long()
    t["segment_minmax/library"] = library_ms(
        "segment_minmax (torch.segment_reduce max, then min, on the masked "
        "[Ep, 8] float32 values: two calls)",
        lambda: (torch.segment_reduce(hi, "max", offsets=off64, unsafe=True),
                 torch.segment_reduce(lo, "min", offsets=off64,
                                      unsafe=True)), SPMV_REPS)
    imax = K.INT32_MAX
    masked = [(torch.where(active, p, -imax - 1), torch.where(active, p, imax))
              for p in pays]
    t["segment_minmax/segment_reduce_x16"] = median_ms(
        lambda _: [(K.segment_reduce(a, off, "max"),
                    K.segment_reduce(b, off, "min")) for a, b in masked])
    # the largest segment alone (a warp-per-segment design ran it on one warp)
    hub = int(torch.argmax(off[1:] - off[:-1]))
    hub_off = off[hub:hub + 2].clone()
    t["segment_minmax/hub"] = (
        hub, int(hub_off[1] - hub_off[0]),
        median_ms(lambda _: [K.segment_minmax(pays, active, hub_off)
                             for _ in range(SPMV_REPS)]) / SPMV_REPS,
        median_ms(lambda _: [K.segment_reduce(masked[0][0], hub_off, "max")
                             for _ in range(SPMV_REPS)]) / SPMV_REPS)
    return t


# ------------------------------------------------------- phases 21-23 --

def run_counted(by_path: dict, path: str, fn, expect):
    """fn() under counted(): its launches must be exactly expect(result)
    (zeros left out); they are added to by_path[path]. Returns fn's
    result."""
    from essentials_tpu_torch import kernels as K
    r, launches = counted(fn)
    ran = {k: n for k, n in launches.items() if n}
    want = {k: n for k, n in expect(r).items() if n}
    check(ran == want, f"{path} launched {ran}, expected {want}")
    total = by_path.setdefault(path, dict.fromkeys(K.launches, 0))
    for k, n in launches.items():
        total[k] += n
    return r


def expect_bfs_variant(variant: str, r) -> dict:
    """Launches of one bfs.run of ``variant`` from its result. fused and
    fused8: a bfs_level a level, one collapse. hybrid and phased, from
    their LevelCounts: a spray level scans twice (the members' prefix, the
    edge ids), a dense level is one bfs_level<int32>, a compaction one
    scan, each expand and collapse one launch. Then the predecessors."""
    if variant in ("fused", "fused8"):
        ty = "int8" if variant == "fused8" else "int32"
        return {f"bfs_level<{ty}>": r.iterations,
                f"collapse_levels<{ty}>": 1, "bfs_predecessors": 1}
    n = r.modes
    return {"scan": 2 * n.spray + n.compactions,
            "bfs_level<int32>": n.dense, "expand_segments": n.expands,
            "collapse_levels<int32>": n.collapses, "bfs_predecessors": 1}


def expect_kcore_adaptive(r) -> dict:
    """Launches of one adaptive k-core run from its waves: a spray wave
    scans twice (the members' prefix, the edge ids) and once more where
    it compacts the peel set; a dense wave is one advance_count."""
    _, tiny, spray, dense = r.tiers
    return {"scan": 2 * (tiny + spray) + r.compactions,
            "advance_count": dense}


def variant_main_path(run) -> tuple:
    """Phase 21: bfs.run hybrid and phased from the RUNS highest-degree
    sources of rmat18 at MAX_IT levels and from the top vertex of
    gen:rmat20x16, each with its launches exact and its distances,
    predecessors and levels equal to fused's (and fused's from
    CHECKED_SOURCES equal to cpu_reference); once with the spray gate
    closed on each graph; then the timed auto on rmat18: the candidates'
    probed times and the choice, and calls that probe nothing.
    Returns ({path: launches}, the rmat18 sources)."""
    from essentials_tpu_torch.algorithms import bfs
    from essentials_tpu_torch.ops import sparse_advance as SA
    by_path = {}
    csr, g = run.bfs_graph(SCALE)
    sources = np.argsort(-np.diff(csr.row_offsets))[:RUNS].astype(int)
    csr_m, g_m = run.weighted_graph(MAIN_SCALE)
    top_m = int(np.argmax(np.diff(csr_m.row_offsets)))
    for where, c, gx, srcs, max_it in (
            (f"rmat{SCALE}", csr, g, sources, MAX_IT),
            (f"gen:rmat{MAIN_SCALE}x16", csr_m, g_m, [top_m], None)):
        check(SA.spray_enabled(gx), f"{where}: the spray is not on")
        fused = [bfs.run(gx, int(s), variant="fused", max_iterations=max_it,
                         warmup=False) for s in srcs]
        for s, f in zip(srcs[:CHECKED_SOURCES], fused):
            check(np.array_equal(f.distances.cpu().numpy(),
                                 bfs.cpu_reference(c, int(s))),
                  f"bfs fused from {s} on {where} differs from "
                  f"cpu_reference")
        for v in ("hybrid", "phased"):
            for spray in (True, False):
                path = f"bfs {v}" + ("" if spray else " spray off")
                with (contextlib.nullcontext() if spray
                      else spray_gate(1 << 62)):
                    rs = [run_counted(by_path, path, lambda s=s: bfs.run(
                        gx, int(s), variant=v, max_iterations=max_it,
                        warmup=False),
                        lambda r, v=v: expect_bfs_variant(v, r))
                        for s in (srcs if spray else srcs[:1])]
                for s, r, f in zip(srcs, rs, fused):
                    check(torch.equal(r.distances, f.distances)
                          and torch.equal(r.predecessors, f.predecessors)
                          and r.iterations == f.iterations,
                          f"bfs {v} (spray {'on' if spray else 'off'}) "
                          f"from {s} on {where} differs from fused")
                check(spray or rs[0].modes.spray == 0,
                      f"bfs {v} sprayed with the spray off")
                print(f"main path: bfs {v} {where} (spray "
                      f"{'on' if spray else 'off'}): levels spray/dense "
                      f"per source ["
                      + ", ".join(f"{r.modes.spray}/{r.modes.dense}"
                                  for r in rs)
                      + f"], expands {sum(r.modes.expands for r in rs)}, "
                        f"collapses {sum(r.modes.collapses for r in rs)}, "
                        f"compactions "
                        f"{sum(r.modes.compactions for r in rs)} in all; "
                        f"distances, predecessors and levels equal fused's "
                        f"from {len(rs)} sources; launches exact")
    # the timed auto: one probe of each candidate (bfs.run's own probe,
    # called first to read its times), then the cached choice
    bfs._auto_cache.clear()
    probed, real = [], bfs._variant_fn
    bfs._variant_fn = lambda cand: (probed.append(cand), real(cand))[1]
    try:
        chosen, times = bfs._auto_variant(g, int(sources[0]), MAX_IT)
        check(probed == list(bfs.auto_candidates(MAX_IT))
              and list(times) == probed, f"bfs auto probed {probed}")
        probed.clear()
        first = bfs.run(g, int(sources[0]), variant="auto",
                        max_iterations=MAX_IT, warmup=False)
        again = run_counted(by_path, "bfs auto", lambda: bfs.run(
            g, int(sources[1]), variant="auto", max_iterations=MAX_IT,
            warmup=False), lambda r: expect_bfs_variant(chosen, r))
        check(probed == [], f"bfs auto probed {probed} after its probe")
    finally:
        bfs._variant_fn = real
    check(torch.equal(first.distances, bfs.run(
        g, int(sources[0]), variant="fused", max_iterations=MAX_IT,
        warmup=False).distances), "bfs auto differs from fused")
    print(f"main path: bfs auto rmat{SCALE}: probed (one warm search each, "
          f"ms on CUDA events) "
          + ", ".join(f"{v} {ms:.4f}" for v, ms in times.items())
          + f"; chose {chosen}; bfs.run auto then probed nothing and ran "
            f"{chosen} ({again.iterations} levels); launches exact")
    return by_path, sources


def kcore_adaptive_main_path(run) -> tuple:
    """Phase 22: kcore.run adaptive on the directed rmat20 seed 3 (auto:
    no symmetric layout), core numbers equal to cpu_reference, and on
    gen:rmat20x16, equal to fused's; each with spray_override left at None
    and once False; launches exact. Returns ({path: launches}, {where:
    result})."""
    from essentials_tpu_torch.algorithms import kcore
    by_path, results = {}, {}
    csr_d, g_d = run.spmv_graph(SPMV_TIME_SCALE)
    csr_m, g_m = run.weighted_graph(MAIN_SCALE)
    where_d = f"directed rmat{SPMV_TIME_SCALE} seed {SPMV_SEED}"
    where_m = f"gen:rmat{MAIN_SCALE}x16"
    check(not kcore.fused_supported(g_d), f"{where_d}: fused supported")
    want = {where_d: kcore.cpu_reference(csr_d),
            where_m: kcore.run(g_m, variant="fused",
                               warmup=False).core.cpu().numpy()}
    for where, gx in ((where_d, g_d), (where_m, g_m)):
        for override in (None, False):
            path = "kcore adaptive" + (" spray off" if override is False
                                       else "")
            r = run_counted(by_path, path, lambda: kcore.run(
                gx, variant="adaptive" if gx is g_m else "auto",
                spray_override=override, warmup=False),
                expect_kcore_adaptive)
            check(np.array_equal(r.core.cpu().numpy(), want[where]),
                  f"kcore adaptive (spray_override {override}) on {where} "
                  f"differs from "
                  + ("cpu_reference" if gx is g_d else "fused"))
            check(override is None or r.tiers[1] + r.tiers[2] == 0,
                  "kcore adaptive sprayed with the spray off")
            results[(where, override)] = r
            print(f"main path: kcore adaptive {where} (spray_override "
                  f"{override}): {r.iterations} waves: "
                  + ", ".join(f"{t} {n}" for t, n in zip(kcore.TIERS,
                                                          r.tiers))
                  + f"; {r.compactions} spray waves compacted the peel "
                    f"set; core numbers equal "
                  + ("cpu_reference" if gx is g_d else "fused's")
                  + "; launches exact")
    return by_path, results


def time_variants(run, sources) -> None:
    """Phase 23: BFS MTEPS per variant (fused, fused8, hybrid, phased) over
    the RUNS sources of rmat18 at MAX_IT (median of CYCLES cycles, no
    predecessors), k-core adaptive ms per run on gen:rmat20x16 beside
    fused, each with torch.profiler's busy and idle share."""
    from essentials_tpu_torch.algorithms import bfs, kcore
    card = run.card
    csr, g = run.bfs_graph(SCALE)
    for v in ("fused", "fused8", "hybrid", "phased"):
        def cycle(_=None, v=v):
            for s in sources:
                bfs.run(g, int(s), variant=v, max_iterations=MAX_IT,
                        warmup=False, compute_predecessors=False)
        ms = median_ms(cycle) / RUNS
        print(f"time [{card}]: bfs {v} rmat{SCALE} ef{EDGE_FACTOR}: "
              f"{ms:.4f} ms per search (median of {CYCLES} cycles of "
              f"{RUNS} sources, no predecessors), "
              f"{g.n_edges / 1e3 / ms:.2f} MTEPS")
        profile(f"bfs {v} rmat{SCALE}, {RUNS} searches", cycle)
    _, g_m = run.weighted_graph(MAIN_SCALE)
    where = f"gen:rmat{MAIN_SCALE}x16"
    for v in ("fused", "adaptive"):
        waves = kcore.run(g_m, variant=v, warmup=False).iterations
        ms = median_ms(lambda _: kcore.run(g_m, variant=v, warmup=False),
                       KCORE_CYCLES)
        print(f"time [{card}]: kcore {v} {where}: {ms:.3f} ms per run "
              f"(median of {KCORE_CYCLES}, kcore.run with its collapse), "
              f"{waves} waves, {ms / waves:.4f} ms per wave")
        profile(f"kcore {v} {where}, one kcore.run",
                lambda: kcore.run(g_m, variant=v, warmup=False))


# ------------------------------------------------------- phases 24-25 --

def bc_rel_err(a: torch.Tensor, ref: np.ndarray) -> float:
    """max |a - ref| over the largest |ref|."""
    a = a.cpu().numpy().astype(np.float64)
    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def hold_bc(what: str, vals: torch.Tensor, ref: np.ndarray, n: int,
            n_sources: int = 1) -> float:
    check(vals.shape == (n,) and bool(vals.isfinite().all()),
          f"{what}: shape or non-finite values")
    err, bound = bc_rel_err(vals, ref), bc_bound(n_sources)
    check(err <= bound, f"{what}: {err} of the largest value from the "
                        f"float64 host Brandes (bound {bound:.3g})")
    return err


def bc_levels(g, sources) -> list:
    """Each source's BC levels: its BFS eccentricity + 1 (the forward
    loop's last level finds nothing), from fused searches."""
    from essentials_tpu_torch.algorithms import bfs
    out = []
    for s in sources:
        d = bfs.run(g, int(s), variant="fused", compute_predecessors=False,
                    warmup=False).distances
        out.append(int(d[d != bfs.UNREACHED].max()) + 1)
    return out


def bcppr_main_path(run) -> tuple:
    """Phase 24: BC spmv from BC_SOURCES of rmat18's highest-degree
    vertices and BC generic from the top vertex of the directed rmat20
    seed 3, against the float64 host Brandes (bc_bound() of the largest
    value); run_all over rmat18's BC_ALL_SOURCES highest-degree vertices
    against the sum of the single-source generic runs and, for the first
    BC_ALL_HOST of them, the host (bc_bound of the sources summed); PPR run
    from rmat18's top vertex and run_batch over PPR_SEEDS seeds against the
    float64 host (ppr_bound); launches exact. Returns ({path: launches}, sources)."""
    from essentials_tpu_torch.algorithms import bc, ppr
    by_path = {}
    csr, g = run.bfs_graph(SCALE)
    sources = np.argsort(-np.diff(csr.row_offsets))[:BC_ALL_SOURCES].astype(
        int)
    where = f"rmat{SCALE}"
    for s in sources[:BC_SOURCES]:
        r = run_counted(by_path, "bc spmv", lambda s=s: bc.run(
            g, int(s), variant="spmv", warmup=False),
            lambda r: {"spmv_rows": 2 * r.iterations})
        err = hold_bc(f"bc spmv {where} from {s}", r.bc_values,
                      bc.cpu_reference(csr, [int(s)],
                                       normalize_undirected=False),
                      g.n_vertices)
        print(f"main path: bc spmv {where} from {s}: {r.iterations} "
              f"levels, {err:.3g} of the largest value from the float64 "
              f"host Brandes (bound {bc_bound():.3g}); launches exact")
    csr_d, g_d = run.spmv_graph(SPMV_TIME_SCALE)
    where_d = f"directed rmat{SPMV_TIME_SCALE} seed {SPMV_SEED}"
    top_d = int(np.argmax(np.diff(csr_d.row_offsets)))
    r = run_counted(by_path, "bc generic", lambda: bc.run(
        g_d, top_d, warmup=False), lambda r: {
            "gather_payloads": 3 * r.iterations,
            "segment_reduce": 2 * r.iterations})
    err = hold_bc(f"bc auto (generic) {where_d} from {top_d}", r.bc_values,
                  bc.cpu_reference(csr_d, [top_d],
                                   normalize_undirected=False),
                  g_d.n_vertices)
    print(f"main path: bc auto (generic) {where_d} from {top_d}: "
          f"{r.iterations} levels, {err:.3g} of the largest value from the "
          f"float64 host Brandes (bound {bc_bound():.3g}); launches exact")
    levels = sum(bc_levels(g, sources))
    ra = run_counted(by_path, "bc run_all", lambda: bc.run_all(
        g, sources=sources, warmup=False), lambda r: {
            "gather_payloads": 3 * levels, "segment_reduce": 2 * levels})
    singles = sum(bc.run(g, int(s), variant="generic",
                         warmup=False).bc_values for s in sources) * 0.5
    err_sum = bc_rel_err(ra.bc_values, singles.cpu().numpy().astype(
        np.float64))
    check(err_sum <= bc_bound(len(sources)),
          f"bc run_all differs from its single-source sum by {err_sum} "
          f"(bound {bc_bound(len(sources)):.3g})")
    part = bc.run_all(g, sources=sources[:BC_ALL_HOST], warmup=False)
    err = hold_bc(f"bc run_all {where} ({BC_ALL_HOST} sources)",
                  part.bc_values, bc.cpu_reference(csr, sources[:BC_ALL_HOST]),
                  g.n_vertices, BC_ALL_HOST)
    print(f"main path: bc run_all {where} over {len(sources)} sources: "
          f"{levels} levels in all, {err_sum:.3g} of the largest value from "
          f"the sum of the single-source generic runs; over the first "
          f"{BC_ALL_HOST}, {err:.3g} from the float64 host; launches exact")
    seeds = sources[:PPR_SEEDS]
    rp = run_counted(by_path, "ppr", lambda: ppr.run(
        g, int(seeds[0]), warmup=False), lambda r: {
            "gather_payloads": r.iterations,
            "segment_reduce": r.iterations})
    iters = [rp.iterations] + [ppr.run(g, int(s), warmup=False).iterations
                               for s in seeds[1:]]
    rb = run_counted(by_path, "ppr run_batch", lambda: ppr.run_batch(
        g, seeds), lambda r: {"gather_payloads": sum(iters),
                              "segment_reduce": sum(iters)})
    check(tuple(rb.shape) == (len(seeds), g.n_vertices)
          and torch.equal(rb[0], rp.p), "ppr run_batch's first row differs "
                                        "from ppr.run")
    errs, bounds = [], []
    for s, row, it in zip(seeds, rb, iters):
        ref = ppr.cpu_reference(csr, int(s))
        p = row.cpu().numpy()
        errs.append(float(np.abs(p - ref).max()))
        bounds.append(ppr_bound(it, ref))
        check(bool(np.isfinite(p).all()) and errs[-1] <= bounds[-1],
              f"ppr from {s}: max abs err {errs[-1]} against the float64 "
              f"host (bound {bounds[-1]:.3g})")
    print(f"main path: ppr {where} from {seeds[0]}: {rp.iterations} "
          f"iterations; run_batch over {len(seeds)} seeds, iterations "
          f"{iters}: max abs err against the float64 host per seed "
          + ", ".join(f"{e:.3g} (bound {b:.3g})"
                      for e, b in zip(errs, bounds))
          + "; launches exact")
    return by_path, sources


def time_bcppr(run, sources) -> None:
    """Phase 25: ms per BC source (spmv on rmat18, generic on the directed
    rmat20), per run_all of BC_ALL_SOURCES and per PPR seed on rmat18,
    median of CYCLES (KCORE_CYCLES for run_all), each with torch.profiler's
    busy and idle share."""
    from essentials_tpu_torch.algorithms import bc, ppr
    card = run.card
    _, g = run.bfs_graph(SCALE)
    csr_d, g_d = run.spmv_graph(SPMV_TIME_SCALE)
    top_d = int(np.argmax(np.diff(csr_d.row_offsets)))
    cases = (
        (f"bc spmv rmat{SCALE}, per source ({BC_SOURCES} sources)",
         lambda: [bc.run(g, int(s), variant="spmv", warmup=False)
                  for s in sources[:BC_SOURCES]], BC_SOURCES, CYCLES),
        (f"bc generic directed rmat{SPMV_TIME_SCALE} seed {SPMV_SEED}, per "
         f"source (from {top_d})",
         lambda: [bc.run(g_d, top_d, warmup=False)], 1, CYCLES),
        (f"bc run_all rmat{SCALE}, per run of {len(sources)} sources",
         lambda: [bc.run_all(g, sources=sources, warmup=False)], 1,
         KCORE_CYCLES),
        (f"ppr rmat{SCALE}, per seed ({PPR_SEEDS} seeds)",
         lambda: [ppr.run(g, int(s), warmup=False)
                  for s in sources[:PPR_SEEDS]], PPR_SEEDS, CYCLES))
    for label, fn, per, reps in cases:
        ms = median_ms(lambda _: fn(), reps) / per
        print(f"time [{card}]: {label}: {ms:.3f} ms (median of {reps})")
        profile(label, fn)


# ------------------------------------------------------- phases 26-31 --

MST_DATASETS = ("kron_s16", "road_512x512")
KRON_S16_MST = 631_663.8      # benchmarks/PARITY.md: the host Kruskal total
TPU_MST_ROUNDS = 7            # benchmarks/PARITY.md: Borůvka rounds at rmat20
# geo's input, benchmarks/run_benchmarks.py:262-270: seed 7, lat U(-60, 60),
# lon U(-180, 180), 20% located, 10 iterations
GEO_SEED, GEO_LOCATED, GEO_ITERATIONS = 7, 0.2, 10
GEO_DEG = 1.5e-3              # benchmarks/PARITY.md: geo, degrees
MEDIAN_ITERATIONS = 5
# spatial_median's gate: each vertex's Weiszfeld objective (its summed
# chord distance to its located neighbours) within MEDIAN_RTOL[sweeps] of
# the float64 host's, past what a move of GEO_DEG can change, and the
# objective summed over the vertices within MEDIAN_SUM_RTOL. After a few
# sweeps float32 rounding decides which of two near-equal points an
# estimate heads for, so estimates part by degrees where objectives do not.
# The largest gaps seen (H100, gen:rmat20x16): 0 for one sweep, 0.161 for
# five, summed 7.5e-6
MEDIAN_RTOL = {1: 1e-3, MEDIAN_ITERATIONS: 0.5}
MEDIAN_SUM_RTOL = 1e-4
SPGEMM_DATASETS = ("uniform_65536", "road_512x512")
SPGEMM_RTOL = 1e-5
CHUNK_PRODUCTS = 1 << 22
# A edges a chunk: below uniform_65536's longest rows (36 edges), so that
# those rows split across chunks and the merge spans are not empty
CHUNK_EDGES = 24


MST_FOREST_RTOL = 1e-9         # the chosen weights in float64 against the host


def mst_bound(k: int, total: float) -> float:
    """The float32 rounding of a tree sum of k positive weights (each
    rounded at most once a level): ceil(log2 k) 2^-24 of the total."""
    return (max(int(np.ceil(np.log2(max(k, 2)))), 1) * F32_ULP / 2
            * abs(total))


def mst_launches(r) -> dict:
    """Launches of one mst.run: a round expands three times (comp and the
    two minima), gathers once (comp at each edge's destination) and takes
    four MINs."""
    return {"expand_segments": 3 * r.iterations,
            "gather_payloads": r.iterations,
            "segment_reduce": 4 * r.iterations}


def mst_main_path(run) -> tuple:
    """Phase 26: mst.run on gen:rmat20x16, kron_s16 and road_512x512, each
    with its launches exact; each a spanning forest (V - c edges, as many
    components as the graph) whose chosen weights, summed in float64,
    lie within MST_FOREST_RTOL of the float64 host forest's and whose
    float32 total lies within mst_bound of it (kron_s16's host total
    PARITY.md's
    631,663.8); on kron_s16 and road_512x512 in_mst and the rounds equal
    to a run on a CPU copy of the graph (plain versions), bit for bit.
    Returns ({path: launches}, [(where, graph)])."""
    from essentials_tpu_torch.algorithms import mst
    by_path, cases = {}, []
    graphs = [(f"gen:rmat{MAIN_SCALE}x16", *run.weighted_graph(MAIN_SCALE))]
    graphs += [(n, *run.dataset_graph(n)) for n in MST_DATASETS]
    for where, csr, g in graphs:
        r = run_counted(by_path, "mst", lambda: mst.run(g, warmup=False),
                        mst_launches)
        in_mst = r.in_mst.cpu().numpy()
        t0 = time.perf_counter()
        host = mst.cpu_reference(csr)
        chosen, c_graph, c_tree = mst.forest_check(csr, in_mst)
        host_s = time.perf_counter() - t0
        check(chosen == csr.n_rows - c_graph and c_tree == c_graph,
              f"mst on {where}: {chosen} edges in {c_tree} components, the "
              f"graph has {c_graph}: not a spanning forest")
        # the minimum spanning forest's weight is unique: the chosen
        # edges' weights, summed in float64, are the host forest's
        exact = float(np.sum(np.asarray(csr.values, np.float64)[in_mst]))
        check(abs(exact - host) <= MST_FOREST_RTOL * host,
              f"mst on {where}: the chosen edges weigh {exact!r} in "
              f"float64, the host forest {host!r}: not a minimum forest")
        err, b = abs(r.total_weight - host), mst_bound(chosen, host)
        check(err <= b, f"mst on {where}: total {r.total_weight} against "
                        f"the float64 host's {host} (bound {b:.4g})")
        if where == "kron_s16":
            check(abs(host - KRON_S16_MST) < 0.05,
                  f"kron_s16's host forest {host}, not {KRON_S16_MST}")
        same = ""
        if where in MST_DATASETS:
            rc = mst.run(g.to("cpu"), warmup=False)
            check(np.array_equal(rc.in_mst.numpy(), in_mst)
                  and rc.iterations == r.iterations,
                  f"mst on {where}: the card's forest differs from a CPU "
                  f"copy's")
            same = "; in_mst and rounds equal a CPU copy's"
        print(f"main path: mst {where}: {r.iterations} rounds"
              + (f" (TPU history: {TPU_MST_ROUNDS})"
                 if where.startswith("gen:") else "")
              + f", {chosen} edges, {c_graph} components, total "
                f"{r.total_weight:.6f} against the float64 host's "
                f"{host:.6f} (|d| {err:.4g}, bound {b:.4g}; chosen "
                f"weights in float64 {exact:.6f}, relative "
                f"{abs(exact - host) / max(host, 1e-300):.3g}; host "
                f"{host_s:.1f} s){same}; launches exact")
        cases.append((where, g))
    return by_path, cases


def time_mst(run, cases) -> None:
    """Phase 27: mst.run ms per run and per round (median of
    KCORE_CYCLES), with torch.profiler's busy and idle share."""
    from essentials_tpu_torch.algorithms import mst
    for where, g in cases:
        rounds = mst.run(g, warmup=False).iterations
        ms = median_ms(lambda _: mst.run(g, warmup=False), KCORE_CYCLES)
        print(f"time [{run.card}]: mst {where}: {ms:.3f} ms per run "
              f"(median of {KCORE_CYCLES}), {rounds} rounds, "
              f"{ms / rounds:.3f} ms per round")
        profile(f"mst {where}, one mst.run",
                lambda: mst.run(g, warmup=False))


def geo_inputs(n: int) -> tuple:
    """The suite's geo input for n vertices (GEO_SEED, GEO_LOCATED)."""
    rng = np.random.default_rng(GEO_SEED)
    lat = rng.uniform(-60, 60, n).astype(np.float32)
    lon = rng.uniform(-180, 180, n).astype(np.float32)
    unknown = rng.random(n) > GEO_LOCATED
    lat[unknown] = np.nan
    lon[unknown] = np.nan
    return lat, lon


def geo_errors(what: str, lat, lon, ref_lat, ref_lon) -> tuple:
    """(|d lat|, |d lon|, located) [n] against the reference, in degrees,
    0 where it is unlocated; longitudes around the circle (min(|d|, 360 -
    |d|): a centroid near +-180 degrees may land on either side in
    float32). The NaN patterns must be equal."""
    ref_lat = np.asarray(ref_lat, np.float64)
    ref_lon = np.asarray(ref_lon, np.float64)
    n = ref_lat.size
    lat = np.asarray(lat, np.float64)[:n]
    lon = np.asarray(lon, np.float64)[:n]
    check(np.array_equal(np.isnan(lat), np.isnan(ref_lat))
          and np.array_equal(np.isnan(lon), np.isnan(ref_lon)),
          f"{what}: the NaN pattern differs from the float64 host's")
    ok = ~np.isnan(ref_lat)
    d = np.where(ok, np.abs(lon - ref_lon), 0.0)
    return (np.where(ok, np.abs(lat - ref_lat), 0.0),
            np.minimum(d, 360.0 - d), ok)


def hold_geo(what: str, lat, lon, ref) -> str:
    """geo.run's gate: every located vertex within GEO_DEG of the float64
    host or, where larger, of the host's own error bound
    (geo.cpu_reference's ``error_bound``: float32 rounding carried through
    the iterations, from the host's data alone; a longitude's over
    cos(lat)). Returns what it saw."""
    ref_lat, ref_lon, bound = ref
    dlat, dlon, ok = geo_errors(what, lat, lon, ref_lat, ref_lon)
    cos = np.cos(np.deg2rad(np.nan_to_num(ref_lat.astype(np.float64))))
    lim = np.maximum(GEO_DEG, bound)
    bad = (dlat > lim) | (dlon > np.maximum(GEO_DEG, bound / cos))
    check(not bad.any(), f"{what}: {int(bad.sum())} vertices past GEO_DEG "
                         f"and the host's error bound, the first "
                         f"{np.flatnonzero(bad)[:5].tolist()}")
    dev = np.maximum(dlat, dlon)
    wide = ok & (bound > GEO_DEG)
    return (f"{int(ok.sum())} located, {int((ok & (dev <= GEO_DEG)).sum())}"
            f" within {GEO_DEG} degrees of the float64 host and the rest "
            f"within the host's error bound ({int(wide.sum())} bounds past "
            f"{GEO_DEG}, the largest {bound.max(initial=0.0):.3g}); largest "
            f"|d| {dev.max(initial=0.0):.3g}, NaN pattern equal")


def hold_median(what: str, csr, start, out, ref, sweeps: int) -> str:
    """spatial_median's gate from the positions ``start`` (host (lat,
    lon)): equal NaN patterns; each vertex's Weiszfeld objective
    (geo.spatial_median_objective) at ``out`` within MEDIAN_RTOL[sweeps]
    of the float64 host's at ``ref``, past GEO_DEG in radians a located
    neighbour (what a move of GEO_DEG can change); their sum within
    MEDIAN_SUM_RTOL. Returns what it saw."""
    from essentials_tpu_torch.algorithms import geo
    dlat, dlon, ok = geo_errors(what, *out, *ref)
    f, m = geo.spatial_median_objective(csr, *start, *out)
    fh, _ = geo.spatial_median_objective(csr, *start, *ref)
    excess = np.maximum(np.abs(f - fh) - np.deg2rad(GEO_DEG) * m, 0.0) \
        / np.maximum(fh, 1e-300)
    rtol = MEDIAN_RTOL[sweeps]
    check(bool((excess <= rtol).all()),
          f"{what}: {int((excess > rtol).sum())} vertices' objective past "
          f"rtol {rtol} of the float64 host's (worst {excess.max():.3g})")
    total = abs(f.sum() - fh.sum()) / max(fh.sum(), 1e-300)
    check(total <= MEDIAN_SUM_RTOL,
          f"{what}: the summed objective {f.sum()!r} against the float64 "
          f"host's {fh.sum()!r} (rtol {MEDIAN_SUM_RTOL})")
    near = int((ok & (np.maximum(dlat, dlon) <= GEO_DEG)).sum())
    q = np.quantile(excess[m > 0], [0.99, 0.9999]) if (m > 0).any() \
        else (0.0, 0.0)
    return (f"objective within {excess.max(initial=0.0):.3g} of the "
            f"host's (rtol {rtol}; 99% within {q[0]:.3g}, 99.99% within "
            f"{q[1]:.3g}), summed within {total:.3g} (rtol "
            f"{MEDIAN_SUM_RTOL}); {near} of {int(ok.sum())} within "
            f"{GEO_DEG} degrees, NaN pattern equal")


def geo_main_path(run) -> tuple:
    """Phase 28: geo.run (the suite's input) on gen:rmat20x16 and
    chesapeake, held by hold_geo against the float64 host
    (geo.cpu_reference), then spatial_median for 1 and MEDIAN_ITERATIONS
    sweeps from its positions, held by hold_median against the float64
    host's sweeps (geo.spatial_median_reference); each with its launches
    exact. Returns ({path: launches}, [(where, graph, lat, lon)])."""
    from essentials_tpu_torch.algorithms import geo
    by_path, cases = {}, []
    graphs = [(f"gen:rmat{MAIN_SCALE}x16", *run.weighted_graph(MAIN_SCALE)),
              ("chesapeake", *run.dataset_graph("chesapeake"))]
    for where, csr, g in graphs:
        lat, lon = geo_inputs(csr.n_rows)
        r = run_counted(by_path, "geo", lambda: geo.run(
            g, lat, lon, total_iterations=GEO_ITERATIONS, warmup=False),
            lambda r: {"gather_payloads": r.iterations,
                       "segment_reduce": 3 * r.iterations})
        t0 = time.perf_counter()
        ref = geo.cpu_reference(csr, lat, lon, GEO_ITERATIONS,
                                error_bound=True)
        host_s = time.perf_counter() - t0
        said = [f"{r.iterations} iterations, "
                + hold_geo(f"geo on {where}", r.lat.cpu(), r.lon.cpu(), ref)
                + f" (host {host_s:.1f} s); spatial_median from its "
                  f"positions:"]
        s = geo.init(g, r.lat, r.lon)
        n = csr.n_rows
        start = (s.lat[:n].cpu().numpy(), s.lon[:n].cpu().numpy())
        for sweeps in (1, MEDIAN_ITERATIONS):
            m = run_counted(
                by_path, "geo spatial_median", lambda: geo.spatial_median(
                    g, s.lat, s.lon, iterations=sweeps),
                lambda _: {"gather_payloads": 2 * sweeps,
                           "segment_reduce": 4 * sweeps})
            mref = geo.spatial_median_reference(csr, *start, sweeps)
            said.append(f"{sweeps} sweep(s): " + hold_median(
                f"spatial_median ({sweeps} sweeps) on {where}", csr, start,
                (m[0][:n].cpu().numpy(), m[1][:n].cpu().numpy()), mref,
                sweeps))
        print(f"main path: geo {where}: {said[0]} " + "; ".join(said[1:])
              + "; launches exact")
        cases.append((where, g, lat, lon))
    return by_path, cases


def time_geo(run, cases) -> None:
    """Phase 29: geo.run and spatial_median ms per run (median of
    KCORE_CYCLES), with torch.profiler's busy and idle share."""
    from essentials_tpu_torch.algorithms import geo
    for where, g, lat, lon in cases:
        r = geo.run(g, lat, lon, total_iterations=GEO_ITERATIONS,
                    warmup=False)
        s = geo.init(g, r.lat, r.lon)
        for label, fn in (
                (f"geo {where}, one geo.run ({r.iterations} iterations)",
                 lambda: geo.run(g, lat, lon, total_iterations=GEO_ITERATIONS,
                                 warmup=False)),
                (f"geo spatial_median {where}, {MEDIAN_ITERATIONS} sweeps",
                 lambda: geo.spatial_median(g, s.lat, s.lon,
                                            iterations=MEDIAN_ITERATIONS))):
            ms = median_ms(lambda _: fn(), KCORE_CYCLES)
            print(f"time [{run.card}]: {label}: {ms:.3f} ms per run (median "
                  f"of {KCORE_CYCLES})")
            profile(label, fn)


def hold_spgemm(what: str, c, ref) -> float:
    """C's structure equal to ref's; its values within SPGEMM_RTOL of
    ref's. Returns the largest relative error."""
    check(np.array_equal(np.asarray(c.row_offsets), ref.row_offsets)
          and np.array_equal(np.asarray(c.col_indices), ref.col_indices),
          f"{what}: C's structure differs from the host's")
    v = np.asarray(c.values, np.float64)
    rv = np.asarray(ref.values, np.float64)
    check(bool(np.isfinite(v).all()), f"{what}: non-finite values")
    err = float((np.abs(v - rv) / np.maximum(np.abs(rv), 1e-30)).max(
        initial=0.0))
    check(err <= SPGEMM_RTOL, f"{what}: values {err} from the float64 host "
                              f"(rtol {SPGEMM_RTOL})")
    return err


def chunked_launches(plan) -> dict:
    """Launches of one numeric_chunked: a device batch expands three
    times, gathers twice (B's values and columns; the products into key
    order), scans once (the runs) and sums once."""
    from essentials_tpu_torch.algorithms import spgemm
    n = len(spgemm.device_batches(plan))
    return {"expand_segments": 3 * n, "gather_payloads": 2 * n, "scan": n,
            "segment_reduce": n}


def spgemm_main_path(run) -> tuple:
    """Phase 30: spgemm.run (the static plan) of A @ A on uniform_65536 and
    road_512x512, then run_chunked on uniform_65536 (CHUNK_PRODUCTS
    products and CHUNK_EDGES edges a chunk, which splits its longest
    rows), resident and streamed, each with its launches exact; C's
    structure equal to the host Gustavson's (and the chunked C's to the
    static C's), values within SPGEMM_RTOL of the float64 host. Returns
    ({path: launches}, {what: value})."""
    from essentials_tpu_torch.algorithms import spgemm
    from essentials_tpu_torch.formats import Csr
    by_path, t = {}, {}
    for name in SPGEMM_DATASETS:
        csr = run.dataset_csr(name)
        t0 = time.perf_counter()
        plan = spgemm.make_plan(csr, csr, device="cuda")
        t[name + "/symbolic_s"] = time.perf_counter() - t0
        r = run_counted(by_path, "spgemm", lambda: spgemm.run(
            csr, csr, plan=plan, warmup=False),
            lambda _: {"gather_payloads": 2, "segment_reduce": 1})
        t0 = time.perf_counter()
        ref = spgemm.cpu_reference(csr, csr)
        host_s = time.perf_counter() - t0
        err = hold_spgemm(f"spgemm {name}", r.c, ref)
        t[name] = (csr, plan, ref)
        print(f"main path: spgemm {name} A @ A: {plan.n_products} "
              f"products, C {plan.c_nnz} entries; symbolic phase (host) "
              f"{t[name + '/symbolic_s']:.2f} s; structure equal to the "
              f"host Gustavson's, values within {err:.3g} of float64 "
              f"(rtol {SPGEMM_RTOL}; host {host_s:.1f} s); launches exact")
    name = SPGEMM_DATASETS[0]
    csr, _, ref = t[name]
    t0 = time.perf_counter()
    plan = spgemm.make_chunked_plan(csr, csr, chunk_products=CHUNK_PRODUCTS,
                                    chunk_edges=CHUNK_EDGES)
    t["chunked/symbolic_s"] = time.perf_counter() - t0
    check(plan.merge_spans.shape[0] > 0,
          f"spgemm chunked {name}: no row split across chunks")
    for stream in (False, True):
        mode = "streamed" if stream else "resident"
        vals = run_counted(by_path, f"spgemm chunked {mode}",
                           lambda: spgemm.numeric_chunked(
                               plan, csr, csr, stream_to_host=stream),
                           lambda _: chunked_launches(plan))
        err = hold_spgemm(f"spgemm chunked {mode} {name}", Csr(
            csr.n_rows, csr.n_cols, plan.c_row_offsets, plan.c_col_indices,
            vals), ref)
        print(f"main path: spgemm chunked {mode} {name}: "
              f"{len(plan.chunks)} chunks of at most {CHUNK_PRODUCTS} "
              f"products and {CHUNK_EDGES} edges in "
              f"{len(spgemm.device_batches(plan))} device batches, "
              f"{plan.merge_spans.shape[0]} merge spans; symbolic phase "
              f"(host) {t['chunked/symbolic_s']:.2f} s; structure equal to "
              f"the static C's and the host's, values within {err:.3g}; "
              f"launches exact")
    t["chunked"] = plan
    return by_path, t


def time_spgemm(run, t: dict) -> None:
    """Phase 31: the static numeric phase's ms (CUDA events, median of
    CYCLES) and products per second beside its bound (the plan's ids and
    C's offsets read once, C's values written once), and the
    chunked numeric phase's, resident and streamed (host clock, with the
    host merge; median of KCORE_CYCLES), each with torch.profiler's busy
    and idle share."""
    from essentials_tpu_torch.algorithms import spgemm
    card = run.card
    for name in SPGEMM_DATASETS:
        csr, plan, _ = t[name]
        av = torch.as_tensor(csr.values, dtype=torch.float32).cuda()
        w, c = plan.n_products, plan.c_nnz
        # each input read once, each output written once: per product its
        # A and B edge ids, per entry its offset and its value (A's and B's
        # values are gathered from the L2 and not counted)
        b = bound(w * 8 + c * 8)
        ms = median_ms(lambda _: spgemm.numeric(plan, av, av))
        print(f"time [{card}]: spgemm numeric {name}: {ms:.4f} ms "
              f"(median of {CYCLES}), {w / ms / 1e6:.3f} G products/s; "
              f"bound {b[0]:.4f} ms ({b[2]}); symbolic phase (host) "
              f"{t[name + '/symbolic_s']:.2f} s")
        profile(f"spgemm numeric {name}",
                lambda: spgemm.numeric(plan, av, av))
    name = SPGEMM_DATASETS[0]
    csr, _, _ = t[name]
    plan = t["chunked"]
    for stream in (False, True):
        mode = "streamed" if stream else "resident"

        def fn(stream=stream):
            return spgemm.numeric_chunked(plan, csr, csr,
                                          stream_to_host=stream)
        times = []
        for _ in range(KCORE_CYCLES + 1):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        ms = float(np.median(times[1:]))
        print(f"time [{card}]: spgemm numeric_chunked {mode} {name}: "
              f"{ms:.3f} ms (host clock with the merge, median of "
              f"{KCORE_CYCLES}), {plan.n_products / ms / 1e6:.3f} G "
              f"products/s; symbolic phase (host) "
              f"{t['chunked/symbolic_s']:.2f} s")
        profile(f"spgemm numeric_chunked {mode} {name}", fn)


# ---------------------------------------------------------------- harness --

DATASETS = ("chesapeake", "kron_s12", "kron_s16", "road_64x64",
            "road_512x512", "uniform_4096", "uniform_65536")
# offsets_to_indices' edge cases (JAX's scatter-add and cumsum semantics):
# empty leading, middle and trailing segments, repeated offsets, and
# offsets[-1] below and above n
OFFSET_CASES = (([0, 0, 2, 4], 4), ([0, 2, 2, 2, 5, 5], 5), ([0, 1, 1], 4),
                ([0, 2, 9], 5), ([2, 3, 5], 6), ([0, 5, 5, 5], 5))
ANALYTICS_RTOL = 1e-5          # float32 sums over the vertices
HARNESS_OP_SCALE = 18
CLI_GRAPH = "kron_s16"
CLI_SPGEMM_GRAPH = "uniform_65536"
CLI_RUNS = 3
CLI_SOURCE_ALGOS = ("bfs", "sssp", "ppr", "bc")


def canonical_entries(coo) -> tuple:
    """A Coo's entries in (row, col, value) order."""
    o = np.lexsort((coo.values, coo.col_indices, coo.row_indices))
    return (coo.n_rows, coo.n_cols, coo.row_indices[o], coo.col_indices[o],
            coo.values[o])


def check_parser(names=DATASETS) -> None:
    """The native parser against the NumPy parser: the same entries."""
    from essentials_tpu_torch.io import load_mtx
    from essentials_tpu_torch.native import mmio_native
    t0 = time.perf_counter()
    lib = mmio_native.build()
    print(f"harness: native parser {lib.name} ready in "
          f"{time.perf_counter() - t0:.2f} s ({mmio_native.compiler()})")
    for name in names:
        path = f"datasets/{name}.mtx"
        t0 = time.perf_counter()
        native = load_mtx(path)
        t1 = time.perf_counter()
        plain = load_mtx(path, use_native=False)
        t2 = time.perf_counter()
        same = all(np.array_equal(a, b) for a, b in zip(
            canonical_entries(native), canonical_entries(plain)))
        check(same, f"native parser on {name}: entries differ from NumPy's")
        print(f"harness: parser {name}: {native.nnz} entries equal to the "
              f"NumPy parser's; native {t1 - t0:.3f} s, NumPy "
              f"{t2 - t1:.3f} s")


def check_offsets_to_indices(g, where: str) -> None:
    """offsets_to_indices over g's row offsets and OFFSET_CASES on the card
    against the plain version on the CPU, one expand_segments launch a
    call (none where there is no element)."""
    from essentials_tpu_torch.graph import convert
    cases = [(g.row_offsets, g.n_edges_padded)] + [
        (torch.tensor(o, dtype=torch.int32, device=g.device), n)
        for o, n in OFFSET_CASES]
    for off, n in cases:
        ids, launches = counted(lambda: convert.offsets_to_indices(off, n))
        check(launches["expand_segments"] == 1
              and sum(launches.values()) == 1,
              f"offsets_to_indices at {where}: launches {launches}")
        plain = convert.offsets_to_indices(off.cpu(), n)
        check(torch.equal(ids.cpu(), plain),
              f"offsets_to_indices at {where}: differs from plain")
    ids = convert.offsets_to_indices(g.row_offsets, g.n_edges_padded)
    check(torch.equal(ids, g.src_indices),
          f"offsets_to_indices at {where}: not the CSR sources")
    print(f"harness: offsets_to_indices at {where} (Ep = "
          f"{g.n_edges_padded}) and {len(OFFSET_CASES)} edge cases equal "
          f"to plain, one expand_segments launch each")


def check_operators(g, where: str, seed: int = SEED) -> dict:
    """advance_edges (vertex frontier, one source and one destination
    value), filter_frontier, for_each_vertex / for_each_edge and uniquify
    on the card against the same calls on a CPU copy, exactly. Returns
    advance_edges' launches."""
    from essentials_tpu_torch import ops
    from essentials_tpu_torch.frontier import frontier_from_indices
    gc = g.to("cpu")
    rng = np.random.default_rng(seed)
    sv = torch.from_numpy(rng.random(g.n_vertices_padded, np.float32))
    dv = torch.from_numpy(rng.random(g.n_vertices_padded, np.float32))
    ids = torch.from_numpy(rng.choice(g.n_vertices, max(g.n_vertices // 16,
                                                        1), replace=False))

    def edges(gr, dev):
        def msg(e):
            return (e.src_vals[0] + e.weight * 1e-3 > e.dst_vals[0]) & \
                (e.eid % 3 != 0)
        return ops.advance_edges(gr, msg, frontier_from_indices(gr, ids.to(
            dev)), src_values=(sv.to(dev),), dst_values=(dv.to(dev),))
    out, launches = counted(lambda: edges(g, g.device))
    ran = {k: n for k, n in launches.items() if n}
    check(ran == {"gather_payloads": 3},
          f"advance_edges at {where}: launched {ran}")
    check(torch.equal(out.cpu(), edges(gc, "cpu")),
          f"advance_edges at {where}: differs from the CPU")
    fired = int(out.sum())
    calls = {
        "filter_frontier": lambda gr, fe: ops.filter_frontier(
            gr, fe, lambda e: e % 5 != 2, "edge"),
        "for_each_vertex": lambda gr, fe: ops.for_each_vertex(
            gr, lambda v: v * 7 - 3, default=-1),
        "for_each_edge": lambda gr, fe: ops.for_each_edge(
            gr, lambda s, d, e, w: w * 2 + (s - d), frontier=fe),
        "uniquify": lambda gr, fe: ops.uniquify(
            gr.col_indices[:4096].flip(0), capacity=gr.n_vertices_padded),
    }
    for name, fn in calls.items():
        check(torch.equal(fn(g, out).cpu(), fn(gc, out.cpu())),
              f"{name} at {where}: differs from the CPU")
    print(f"harness: advance_edges at {where}: {fired} of {g.n_edges} "
          f"edges fired, equal to the CPU's, gather_payloads x3 (route in, "
          f"destination values, route back through csc_rank); "
          f"{', '.join(calls)} equal to the CPU's")
    return launches


def check_analytics(csr, g, where: str) -> None:
    """The degree analytics against NumPy: the histogram exactly (bins by
    bit length), the mean and standard deviation within ANALYTICS_RTOL of
    float64."""
    from essentials_tpu_torch.graph import analytics
    deg = np.diff(np.asarray(csr.row_offsets, np.int64))
    hist = np.bincount(np.minimum(np.frexp(deg.astype(np.float64))[1], 31)
                       * (deg > 0), minlength=32)
    got = analytics.degree_histogram(g)
    check(got.device.type == "cuda" and got.dtype == torch.int32
          and np.array_equal(got.cpu().numpy(), hist),
          f"degree_histogram at {where}: differs from NumPy")
    for name, fn, ref in (("average_degree", analytics.average_degree,
                           deg.mean()),
                          ("degree_standard_deviation",
                           analytics.degree_standard_deviation, deg.std())):
        val = fn(g)
        check(abs(val - ref) <= ANALYTICS_RTOL * ref,
              f"{name} at {where}: {val} against NumPy's {ref}")
    print(f"harness: analytics at {where}: histogram equal to NumPy's, "
          f"mean {analytics.average_degree(g):.6f} (NumPy {deg.mean():.6f}),"
          f" std {analytics.degree_standard_deviation(g):.6f} (NumPy "
          f"{deg.std():.6f})")


def check_trace(g, source: int, log_dir: str, attempts: int = 3) -> str:
    """runtime.trace around one fused BFS: its Chrome trace must hold a
    bfs_level kernel event. A trace whose device activity came back empty
    (the profiler's windows sometimes do on this card, see device_ms) is
    taken again, at most ``attempts`` times. Returns the trace's path."""
    from essentials_tpu_torch import runtime
    from essentials_tpu_torch.algorithms import bfs
    bfs.run(g, source, variant="fused", warmup=False)
    for attempt in range(1, attempts + 1):
        with runtime.trace(log_dir) as t:
            bfs.run(g, source, variant="fused", warmup=False)
            torch.cuda.synchronize()
        with open(t.path) as f:
            events = json.load(f)["traceEvents"]
        on_card = [e for e in events if e.get("cat") == "kernel"]
        kernels = [e for e in on_card
                   if "bfs_level_kernel" in e.get("name", "")]
        if kernels or on_card:
            break
        print(f"harness: runtime.trace attempt {attempt}: no device "
              f"activity in {len(events)} events, taken again")
    check(bool(kernels), f"runtime.trace: no bfs_level kernel event in "
          f"{t.path} ({len(events)} events, {len(on_card)} kernel events, "
          f"attempt {attempt})")
    print(f"harness: runtime.trace of one fused BFS (attempt {attempt}): "
          f"{len(events)} events, {len(kernels)} bfs_level kernel events, "
          f"{t.path}")
    return t.path


def harness_checks(csr_o, g_o, csr_ops, g_ops, where_o: str,
                   where_ops: str, log_dir: str,
                   datasets=DATASETS) -> dict:
    """Phase 32's checks (also the card test's, at smaller graphs): the
    parser, offsets_to_indices at g_o, the operators and analytics at g_ops
    (which needs a symmetric layout for the fused BFS of the trace).
    Returns {path: launches}."""
    check_parser(datasets)
    check_offsets_to_indices(g_o, where_o)
    launches = check_operators(g_ops, where_ops)
    check_analytics(csr_o, g_o, where_o)
    check_analytics(csr_ops, g_ops, where_ops)
    source = int(np.argmax(np.diff(csr_ops.row_offsets)))
    check_trace(g_ops, source, log_dir)
    return {"advance_edges": launches}


def cli_call(argv: list) -> tuple:
    """cli.main(argv) with its standard output captured and the launch
    counts set to 0 just before it and read just after. Returns (exit
    code, the JSON stats or None, the output, the counts)."""
    from essentials_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc, launches = counted(lambda: cli.main(argv))
    out = buf.getvalue()
    lines = [x for x in out.splitlines() if x.startswith("{")]
    return rc, json.loads(lines[-1]) if lines else None, out, launches


def cli_main_path(run) -> dict:
    """Phase 33: the CLI on the card (see the module docstring). Returns
    {path: launches}."""
    from essentials_tpu_torch import cli
    from essentials_tpu_torch.examples import run_all
    hub = int(np.argmax(np.diff(run.dataset_csr(CLI_GRAPH).row_offsets)))
    by_path, rows = {}, []
    cases = [(a, CLI_GRAPH) for a in cli.ALGORITHMS if a != "spgemm"]
    cases.append(("spgemm", CLI_SPGEMM_GRAPH))
    for algo, graph in cases:
        argv = [algo, f"datasets/{graph}.mtx", "--undirected", "--validate",
                "--json", "--runs", str(CLI_RUNS), "--no-cache"]
        if algo in CLI_SOURCE_ALGOS:
            argv += ["--source", str(hub)]
        t0 = time.perf_counter()
        rc, stats, out, launches = cli_call(argv)
        wall = time.perf_counter() - t0
        check(rc == 0 and stats is not None,
              f"cli {' '.join(argv)}: exit {rc}, output {out[-2000:]}")
        check(stats["backend"] == "cuda",
              f"cli {algo}: backend {stats['backend']!r}")
        ran = {k: n for k, n in launches.items() if n}
        check(bool(ran), f"cli {algo}: launched no kernel")
        by_path[f"cli {algo}"] = launches
        rows.append((algo, graph, stats, wall, ran))
        print(f"cli [{run.card}]: {algo} {graph}: mean {stats['elapsed_ms']:.3f}"
              f" ms of {CLI_RUNS} runs {stats['cycles_ms']}, "
              f"{stats['iterations']} iterations, {stats['mteps']:.1f} MTEPS,"
              f" {stats['pct_hbm_roofline'] * 100:.2f}% of the HBM rate by "
              f"the useful-bytes model; validated; {wall:.1f} s with the "
              f"load, the runs and the host reference; launches {ran}")
    print(f"cli [{run.card}]: summary (mean ms, MTEPS): " + "; ".join(
        f"{a} {s['elapsed_ms']:.3f} ms {s['mteps']:.1f}" for a, _, s, _, _
        in rows))
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = run_all.main(["datasets/chesapeake.mtx"])
    summary = [x for x in buf.getvalue().splitlines() if "validated" in x]
    check(rc == 0, f"run_all chesapeake: exit {rc}: {buf.getvalue()[-2000:]}")
    print(f"cli: run_all chesapeake on the card: {summary[-1]} in "
          f"{time.perf_counter() - t0:.1f} s")
    return by_path


# -------------------------------------------------------- phases 34-35 --

PARALLEL_MODES = ("all_gather", "boundary")
PARALLEL_ALGOS = ("bfs", "sssp", "pagerank")
PR_ITERATIONS = 20      # dist_pagerank's fixed count (tol 0), the host's too
# PageRank against the float64 host power iteration: |got - ref| <=
# PR_ATOL_V / V + PR_RTOL |ref|, the absolute term a ten-thousandth of the
# mean rank 1 / V (ranks are at least the teleport 0.15 / V)
PR_RTOL, PR_ATOL_V = 1e-4, 1e-4
PR_SUM_TOL = 1e-5       # |sum of the ranks - 1|


def pr_worst(got: np.ndarray, ref: np.ndarray) -> float:
    """The largest |got - ref| over its allowance PR_ATOL_V / V + PR_RTOL
    |ref| (at most 1 where the check holds)."""
    allow = PR_ATOL_V / ref.shape[0] + PR_RTOL * np.abs(ref)
    return float((np.abs(got.astype(np.float64) - ref) / allow).max())


def plant_route_swap(part, ref_pr: np.ndarray):
    """A planted fault for phase 34's PageRank check, on a one-rank
    all_gather partition: its route_idx with the slots of two in-degree-1
    destinations swapped, so each takes the other's one contribution. The
    two are those whose contributions (rank / out-degree of the source, on
    the host's ranks) are the least and the median among such vertices:
    mass moved between two low-ranked vertices, where the sum check sees
    nothing. Returns the faulty partition and the contribution moved."""
    import dataclasses
    n = ref_pr.shape[0]
    soff = part.src_offsets.cpu().numpy().astype(np.int64)
    doff = part.dst_offsets.cpu().numpy().astype(np.int64)
    route = part.route_idx.cpu().numpy()
    slot = doff[np.flatnonzero(np.diff(doff[:n + 1]) == 1)]
    check(slot.shape[0] >= 2, "plant_route_swap: fewer than two "
          "in-degree-1 vertices")
    src = np.searchsorted(soff, route[slot], side="right") - 1
    contrib = ref_pr[src] / np.diff(soff)[src]
    order = np.argsort(contrib, kind="stable")
    lo, mid = order[0], order[order.shape[0] // 2]
    bad = route.copy()
    bad[[slot[lo], slot[mid]]] = route[[slot[mid], slot[lo]]]
    return (dataclasses.replace(part, route_idx=torch.from_numpy(bad).to(
        part.device)), float(contrib[mid] - contrib[lo]))


def host_pagerank(csr, iterations: int, alpha: float = 0.85) -> np.ndarray:
    """float64 power iteration with the JAX package's distributed formula
    (essentials_tpu/parallel/distributed.py:359-362): the dangling mass
    spread evenly, the teleport (1 - alpha) / V."""
    n = csr.n_rows
    deg = np.diff(csr.row_offsets).astype(np.int64)
    src = np.repeat(np.arange(n), deg)
    p = np.full(n, 1.0 / n)
    for _ in range(iterations):
        contrib = np.where(deg > 0, p / np.maximum(deg, 1), 0.0)
        pulled = np.bincount(csr.col_indices, weights=contrib[src],
                             minlength=n)
        p = (1 - alpha) / n + alpha * p[deg == 0].sum() / n + alpha * pulled
    return p


def dist_call(D, part, mesh, algo: str, source: int, overlap: bool):
    """One dist_* run on a rank's partition, as a user calls it."""
    if algo == "bfs":
        return D.dist_bfs(part, mesh, source, overlap=overlap)
    if algo == "sssp":
        return D.dist_sssp(part, mesh, source, overlap=overlap)
    return D.dist_pagerank(part, mesh, tol=0.0,
                           max_iterations=PR_ITERATIONS, overlap=overlap)


def parallel_main_path(csr, g, where: str) -> tuple:
    """Phase 34 (also the card test's, at rmat12): a one-rank NCCL group
    (made here where none exists), one partition per exchange mode built
    with overlap=True, then dist_bfs, dist_sssp and dist_pagerank in both
    modes, with and without overlap, from the highest-degree vertex, each
    with the launch counts set to 0 just before it and read just after.
    Returns ({path: launches}, {path: supersteps}, the local partitions,
    the host partition seconds by mode, the source)."""
    import torch.distributed as tdist
    from essentials_tpu_torch.algorithms import bfs
    from essentials_tpu_torch.parallel import distributed as D, multihost
    from essentials_tpu_torch.parallel.partition import partition_graph
    if not tdist.is_initialized():
        multihost.initialize(num_processes=1, device="cuda")
    mesh = multihost.global_mesh()
    check(mesh.size == 1 and mesh.device.type == "cuda"
          and tdist.get_backend() == "nccl",
          f"parallel: mesh {mesh} on {tdist.get_backend()}")
    n = csr.n_rows
    source = int(np.argmax(np.diff(csr.row_offsets)))
    t0 = time.perf_counter()
    ref_bfs = bfs.cpu_reference(csr, source)
    fused = bfs.run(g, source, variant="fused").distances.cpu().numpy()
    check(np.array_equal(fused, ref_bfs),
          f"parallel {where}: fused BFS differs from cpu_reference")
    ref_sssp = host_dijkstra(csr, source)
    ref_pr = host_pagerank(csr, PR_ITERATIONS)
    levels = int(ref_bfs[ref_bfs != INT32_MAX].max())
    print(f"parallel {where}: host references (BFS, Dijkstra, PageRank "
          f"float64 x{PR_ITERATIONS}) in {time.perf_counter() - t0:.1f} s; "
          f"source {source}, {levels} BFS levels")
    parts, seconds = {}, {}
    for mode in PARALLEL_MODES:
        t0 = time.perf_counter()
        dg = partition_graph(csr, 1, exchange=mode, overlap=True)
        seconds[mode] = time.perf_counter() - t0
        check((dg.boundary_size > 0) == (mode == "boundary"),
              f"parallel {where}: {mode} partition has boundary size "
              f"{dg.boundary_size}")
        parts[mode] = dg.local(mesh.rank, mesh.device)
        print(f"parallel {where}: partition {mode} (overlap built): "
              f"{seconds[mode]:.2f} s on the host; Vs {dg.block_size}, Es "
              f"{dg.edges_per_device}, Eq {dg.peer_edges}, Smax "
              f"{dg.boundary_size}, {dg.comm_values_per_step} values "
              f"exchanged a superstep")
    by_path, steps, sssp_bits = {}, {}, {}
    for mode in PARALLEL_MODES:
        for overlap in (False, True):
            for algo in PARALLEL_ALGOS:
                path = f"dist_{algo} {mode}" + (" overlap" if overlap else "")
                out, launches = counted(lambda: multihost.gather_global(
                    mesh, dist_call(D, parts[mode], mesh, algo, source,
                                    overlap)))
                ran = {k: c for k, c in launches.items() if c}
                s = launches["expand_segments"]
                extra = algo == "sssp" and not overlap  # the weights' move
                want = {"expand_segments": s, "gather_payloads": s + extra,
                        "segment_reduce": s}
                check(s > 0 and ran == want,
                      f"{path}: launched {ran}, expected {want}")
                check(algo != "bfs" or s == levels + 1,
                      f"{path}: {s} supersteps for {levels} levels")
                check(algo != "pagerank" or s == PR_ITERATIONS,
                      f"{path}: {s} iterations, not {PR_ITERATIONS}")
                by_path[path], steps[path] = launches, s
                vec = out.cpu().numpy()
                check(vec.shape == (parts[mode].graph.n_vertices_global,),
                      f"{path}: shape {vec.shape}")
                got, pad = vec[:n], vec[n:]
                if algo == "bfs":
                    check(np.array_equal(got, ref_bfs)
                          and np.all(pad == INT32_MAX),
                          f"{path}: distances differ from cpu_reference "
                          f"and the fused BFS")
                    what = "equal to cpu_reference and fused"
                elif algo == "sssp":
                    fin = np.isfinite(ref_sssp)
                    check(np.array_equal(np.isfinite(got), fin)
                          and np.all(np.isinf(pad))
                          and np.allclose(got[fin], ref_sssp[fin],
                                          rtol=SSSP_RTOL, atol=0),
                          f"{path}: outside rtol {SSSP_RTOL} of Dijkstra "
                          f"or reach set differs")
                    sssp_bits[path] = got.view(np.int32)
                    rel = np.abs(got[fin] - ref_sssp[fin]) / np.maximum(
                        ref_sssp[fin], np.finfo(np.float32).tiny)
                    what = (f"max rel err {rel.max():.3g} against Dijkstra, "
                            f"reach set exact")
                else:
                    total = float(got.astype(np.float64).sum())
                    worst = pr_worst(got, ref_pr)
                    check(np.all(np.isfinite(got)) and np.all(pad == 0)
                          and worst <= 1.0
                          and abs(total - 1.0) <= PR_SUM_TOL,
                          f"{path}: {worst:.3g} of its allowance (rtol "
                          f"{PR_RTOL}, atol {PR_ATOL_V} / V) of the float64 "
                          f"host, or sum {total}")
                    what = (f"max abs err {np.abs(got - ref_pr).max():.3g} "
                            f"against float64, {worst:.3g} of the allowance"
                            f", sum {total:.9f}")
                print(f"main path: {path} {where}: {s} supersteps, {what}; "
                      f"launches {ran}")
    first = next(iter(sssp_bits.values()))
    check(all(np.array_equal(b, first) for b in sssp_bits.values()),
          f"parallel {where}: dist_sssp differs bitwise across modes")
    print(f"main path: dist_sssp {where}: bit-equal across "
          f"{len(sssp_bits)} mode/overlap runs")
    bad, moved = plant_route_swap(parts["all_gather"], ref_pr)
    got = multihost.gather_global(mesh, dist_call(
        D, bad, mesh, "pagerank", source, False)).cpu().numpy()[:n]
    worst = pr_worst(got, ref_pr)
    check(worst > 1.0, f"parallel {where}: the planted route swap "
          f"({moved:.3g} moved) passed the PageRank check ({worst:.3g} of "
          f"the allowance)")
    print(f"control: dist_pagerank all_gather {where}, two route_idx slots "
          f"swapped ({moved:.3g} of contribution moved): max abs err "
          f"{np.abs(got - ref_pr).max():.3g}, {worst:.3g} of the allowance "
          f"(atol {PR_ATOL_V / n:.3g}), refused; sum "
          f"{float(got.astype(np.float64).sum()):.9f}")
    return by_path, steps, parts, seconds, source


def time_parallel(run, csr, steps: dict, parts: dict, seconds: dict,
                  source: int, where: str) -> None:
    """Phase 35: ms per run and per superstep on CUDA events (median of
    CYCLES), supersteps and MTEPS for each path of phase 34, its device
    busy and idle share under torch.profiler, and per mode the host
    partition seconds and the values exchanged a superstep."""
    from essentials_tpu_torch.parallel import distributed as D, multihost
    card, e = run.card, csr.nnz
    mesh = multihost.global_mesh()
    for mode in PARALLEL_MODES:
        dg = parts[mode].graph
        print(f"time [{card}]: parallel partition {mode} {where}: "
              f"{seconds[mode]:.2f} s on the host (overlap built), "
              f"comm_values_per_step {dg.comm_values_per_step}")
    for path, s in steps.items():
        algo, mode = path.split()[0][5:], path.split()[1]
        overlap = path.endswith("overlap")

        def fn(_=None, algo=algo, mode=mode, overlap=overlap):
            return dist_call(D, parts[mode], mesh, algo, source, overlap)
        ms = median_ms(fn)
        print(f"time [{card}]: {path} {where}: {ms:.4f} ms per run "
              f"(median of {CYCLES}), {s} supersteps, {ms / s:.4f} ms per "
              f"superstep, {e * s / 1e3 / ms:.1f} MTEPS (E x supersteps), "
              f"{e / 1e3 / ms:.1f} MTEPS (E over the run)")
        profile(f"{path} {where}, one run", fn)


class Phases:
    """Prints each phase's seconds as it ends."""

    def __init__(self):
        self.t0 = time.perf_counter()

    def done(self, what: str) -> None:
        t = time.perf_counter()
        print(f"phase {what}: {t - self.t0:.1f} s")
        self.t0 = t


class Run:
    """What the groups share: the card, each kernel's largest error against
    its plain version, the times, the launches by path, and the graphs,
    each built on first use and kept for the groups after it."""

    def __init__(self, card: str):
        self.card = card
        self.phases = Phases()
        self.errs = {k: 0 for ks in KERNEL_TABLE.values() for k in ks}
        self.errs.update({k: 0.0 for k in KERNEL_TABLE["spmv"]})
        self.errs.update({k + "/rel": 0.0 for k in KERNEL_TABLE["spmv"]})
        self.t = {}
        self.by_path = {}
        self._graphs = {}

    def _get(self, key, make):
        if key not in self._graphs:
            self._graphs[key] = make()
        return self._graphs[key]

    def bfs_graph(self, scale: int) -> tuple:
        """The undirected unweighted RMAT graph of bench.py's BFS (edge
        factor 16, seed 1): (csr, graph)."""
        def make():
            t0 = time.perf_counter()
            csr, g = rmat_graph(scale, "cuda")
            print(f"graph: rmat{scale} ef{EDGE_FACTOR}: V={g.n_vertices} "
                  f"E={g.n_edges} Vp={g.n_vertices_padded} "
                  f"Ep={g.n_edges_padded}, built in "
                  f"{time.perf_counter() - t0:.1f} s")
            check(g.symmetric_layout, "rmat graph has no symmetric layout")
            return csr, g
        return self._get(("bfs", scale), make)

    def spmv_graph(self, scale: int) -> tuple:
        """bench.py's SpMV graph of ``scale`` (directed, weighted, seed 3):
        (csr, graph)."""
        def make():
            from essentials_tpu_torch import kernels as K
            t0 = time.perf_counter()
            csr, g = spmv_graph(scale, "cuda")
            print(f"graph: rmat{scale} ef{EDGE_FACTOR} seed {SPMV_SEED} "
                  f"directed weighted: V={g.n_vertices} E={g.n_edges} "
                  f"Vp={g.n_vertices_padded} Ep={g.n_edges_padded}, max "
                  f"out-degree {g.max_degree}, "
                  f"{int((g.out_degrees()[:g.n_vertices] == 0).sum())} empty "
                  f"rows, {K.slab_count(g.n_edges_padded)} slabs of "
                  f"{K.SLAB_EDGES} edges, built in "
                  f"{time.perf_counter() - t0:.1f} s")
            return csr, g
        return self._get(("spmv", scale), make)

    def weighted_graph(self, scale: int) -> tuple:
        return self._get(("weighted", scale),
                         lambda: weighted_graph(scale, "cuda"))

    def balanced_graph(self) -> tuple:
        return self._get(("balanced",), lambda: balanced_graph("cuda"))

    def tc_graph(self, scale: int, weighted: bool = True):
        return self._get(("tc", scale, weighted),
                         lambda: tc_graph(scale, weighted))

    def dataset_csr(self, name: str):
        """datasets/<name>.mtx as a host Csr (not cached on disk)."""
        def make():
            from essentials_tpu_torch.io import load_graph_file
            t0 = time.perf_counter()
            csr = load_graph_file(f"datasets/{name}.mtx", cache=False)
            print(f"graph: {name}: V={csr.n_rows} E={csr.nnz}, max degree "
                  f"{int(np.diff(csr.row_offsets).max())}, loaded in "
                  f"{time.perf_counter() - t0:.1f} s")
            return csr
        return self._get(("csr", name), make)

    def dataset_graph(self, name: str) -> tuple:
        """datasets/<name>.mtx, undirected and weighted: (csr, graph)."""
        def make():
            from essentials_tpu_torch.graph import build_graph
            csr = self.dataset_csr(name)
            return csr, build_graph(csr, directed=False, weighted=True,
                                    device="cuda")
        return self._get(("dataset", name), make)


def group_bfs(run: Run) -> None:
    """Phases 3-5: the fused BFS."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import bfs
    card, errs = run.card, run.errs

    # 3. kernels against their plain versions
    measured = sum(check_kernels(g, int(np.argmax(np.diff(csr.row_offsets))),
                                 errs)
                   for csr, g in (run.bfs_graph(12), run.bfs_graph(SCALE),
                                  run.balanced_graph()))
    check(measured > 0, "bfs_level: launches per call measured on no graph")
    print(f"kernels: bfs_level four device kernels a call (pass, list, "
          f"push, pull) on {measured} of 3 graphs measured")
    csr, g = run.bfs_graph(SCALE)
    sources = np.argsort(-np.diff(csr.row_offsets))[:RUNS].astype(int)
    cases = bfs_pred_cases(g, sources)
    check_pred_sources("bfs_predecessors", cases, f"rmat{SCALE}", errs)
    for where, g_x, s_x in pred_stress_inputs(run):
        print(f"kernels: predecessors on {where} from {s_x}: "
              f"{hold_pred_cases(g_x, s_x, where, errs)}; both exact "
              f"against plain and repeatable at n_edges E, E - 1 and E - "
              f"{PRED_CUT}")
    check(any(check_one_launch("bfs_predecessors",
                               lambda a=a: K.bfs_predecessors(*a),
                               f"rmat{SCALE}",
                               K.device_kernels("bfs_predecessors"))
              for a in cases[:2]),
          "bfs_predecessors: launches per call measured nowhere")
    run.phases.done("3 bfs kernels")

    # 4. the main path
    csr, g = run.bfs_graph(SCALE)
    sources = np.argsort(-np.diff(csr.row_offsets))[:RUNS].astype(int)
    variants = {"fused": {}, "fused8": {"max_iterations": MAX_IT}}
    K.reset_launches()
    results = {v: [bfs.run(g, int(s), variant=v, warmup=False, **kw)
                   for s in sources] for v, kw in variants.items()}
    torch.cuda.synchronize()
    launches = dict(K.launches)
    passes = {k: K.pass_launches[k] for k in (
        "bfs_level_list", "bfs_level_push", "bfs_level_pull")}
    run.by_path[f"bfs rmat{SCALE}"] = launches
    iters = {v: [r.iterations for r in rs] for v, rs in results.items()}
    print(f"main path: launches {launches}; bfs_level's list, push and "
          f"pull kernels {passes}; bfs_predecessors' range walk "
          f"{K.pass_launches['bfs_predecessors_ranges']}")
    for v in variants:
        print(f"main path: {v} iterations per source {iters[v]}")
    check(launches["bfs_level<int32>"] == sum(iters["fused"]),
          "bfs_level<int32> launches != fused iterations")
    check(launches["bfs_level<int8>"] == sum(iters["fused8"]),
          "bfs_level<int8> launches != fused8 iterations")
    for name, n in passes.items():
        check(n == sum(iters["fused"]) + sum(iters["fused8"]),
              f"{name} launches != bfs_level's")
    for name in ("collapse_levels<int32>", "collapse_levels<int8>"):
        check(launches[name] == RUNS, f"{name} launches != {RUNS}")
    check(launches["bfs_predecessors"] == 2 * RUNS,
          f"bfs_predecessors launches != {2 * RUNS}")
    check_range_walks()
    for i, s in enumerate(sources):
        rf, r8 = results["fused"][i], results["fused8"][i]
        d = rf.distances.cpu().numpy()
        p = rf.predecessors.cpu().numpy()
        check(d.shape == (g.n_vertices,) and p.shape == (g.n_vertices,),
              "result shapes")
        check(np.array_equal(d, r8.distances.cpu().numpy())
              and np.array_equal(p, r8.predecessors.cpu().numpy())
              and rf.iterations == r8.iterations,
              f"fused and fused8 disagree from source {s}")
        reached = d[d != bfs.UNREACHED]
        check(rf.iterations == int(reached.max()) + 1,
              f"iterations from source {s} != eccentricity + 1")
        check(np.array_equal(p, host_predecessors(csr, d)),
              f"predecessors from source {s} are not the smallest-id "
              f"in-neighbours one level up")
        if i < CHECKED_SOURCES:
            check(np.array_equal(d, bfs.cpu_reference(csr, int(s))),
                  f"distances from source {s} differ from cpu_reference")
    print(f"main path: distances from {CHECKED_SOURCES} sources equal "
          f"cpu_reference; predecessors of all {RUNS} sources valid and "
          f"smallest-id; fused == fused8")
    run.phases.done("4 bfs main path")

    # 5. times
    for v, kw in variants.items():
        def cycle(_, v=v, kw=kw):
            for s in sources:
                bfs.run(g, int(s), variant=v, warmup=False,
                        compute_predecessors=False, **kw)
        ms = median_ms(cycle) / RUNS
        print(f"time [{card}]: bfs {v} rmat{SCALE} ef{EDGE_FACTOR}: "
              f"{ms:.4f} ms per search (median of {CYCLES} cycles of "
              f"{RUNS} sources), {g.n_edges / 1e3 / ms:.2f} MTEPS")
    t = time_kernels(g, sources, card)
    run.t.update(t)
    for name in KERNEL_TABLE["bfs"]:
        print(f"time [{card}]: {name} {t[name]:.4f} ms, plain "
              f"{t[name + '/plain']:.4f} ms (rmat{SCALE}, "
              + (f"mean of {RUNS} sources)" if name == "bfs_predecessors"
                 else f"source {sources[0]})"))
    for pred in (False, True):
        time_searches(f"bfs fused rmat{SCALE}" + (
            ", with predecessors" if pred else ""), card, lambda s, p=pred:
            bfs.run(g, s, variant="fused", warmup=False,
                    compute_predecessors=p), sources)
    for v, kw in variants.items():
        profile_searches(g, sources, v, kw)
    run.phases.done("5 bfs times")


def group_spmv(run: Run) -> None:
    """Phases 6-8: SpMV, with PageRank and HITS spmv on it."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import pr, spmv
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    card, errs = run.card, run.errs

    # 6. SpMV kernels against their plain versions
    csr_u, g_u = run.bfs_graph(SCALE)       # the undirected BFS graph
    for scale in SPMV_SCALES:
        check_spmv_kernels(run.spmv_graph(scale)[1], f"rmat{scale}", errs)
    check_pr_hits_rows(g_u, f"undirected rmat{SCALE} (pr/hits inputs)",
                       errs)
    g_st = rows_stress_graph("cuda")[1]
    x_st = spmv.random_x(g_st, 1)
    check_spmv_rows(g_st, ((g_st.values, x_st, "<mul>"), (None, x_st,
                                                          "<none>")),
                    f"rmat{ROWS_STRESS_SCALE} with hub rows of "
                    f"{[int(t * K.ROW_TILE) for _, t in ROWS_HUBS]} edges "
                    f"and {ROWS_EMPTY_RUN} empty rows in a run", errs)
    run.phases.done("6 spmv kernels")

    # 7. the SpMV main path
    csr_s, g_s = run.spmv_graph(SCALE)
    run.by_path.update(spmv_main_path(csr_s, g_s, csr_u, g_u))
    run.phases.done("7 spmv/pr/hits main path")

    # 8. SpMV times
    time_spmv(g_s, card, f"rmat{SCALE} seed {SPMV_SEED}")
    t = time_spmv_kernels(g_s)
    run.t.update(t)
    for name in sorted(k for k in t if "/" not in k):
        print(f"time [{card}]: {name} {t[name]:.4f} ms, plain "
              f"{t[name + '/plain']:.4f} ms (rmat{SCALE} seed {SPMV_SEED}, "
              f"{SPMV_REPS} calls back to back)")
    time_pr_hits(g_u, card)
    mask = g_u.vertex_mask()
    r = torch.where(mask, 1.0 / g_u.n_vertices, 0.0).float()
    t_pr = {"spmv_rows<mul>" + k: v for k, v in rows_against_mv(
        g_u, edge_weights(g_u), r * pr.inverse_weights(g_u)).items()}
    print_against_mv(card, f"undirected rmat{SCALE} (PageRank's product)",
                     t_pr, "spmv_rows<mul>")
    run.t.update({k.replace(">", ">@pr", 1): v for k, v in t_pr.items()})
    x = spmv.random_x(g_s, 0)
    for v in spmv.VARIANTS:
        profile(f"spmv {v} rmat{SCALE} seed {SPMV_SEED}, {PROFILED_RUNS} "
                f"spmv.run calls",
                lambda v=v: [spmv.run(g_s, x, variant=v, warmup=False)
                             for _ in range(PROFILED_RUNS)],
                PROFILED_RUNS * KERNELS_PER_PRODUCT[v])
    for key in ("spmv_rows<mul>", "spmv_slabs<mul,sum>"):
        print_against_mv(card, f"rmat{SCALE} seed {SPMV_SEED}", t, key)
    g20 = run.spmv_graph(SPMV_TIME_SCALE)[1]
    where20 = f"rmat{SPMV_TIME_SCALE} seed {SPMV_SEED}"
    check_spmv_kernels(g20, where20, errs)
    x20 = spmv.random_x(g20, 1)
    t20 = {"spmv_slabs<mul,sum>" + k: v
           for k, v in slabs_against_mv(g20, x20).items()}
    t20.update({"spmv_rows<mul>" + k: v
                for k, v in rows_against_mv(g20, g20.values, x20).items()})
    for key in ("spmv_rows<mul>", "spmv_slabs<mul,sum>"):
        print_against_mv(card, where20, t20, key)
    run.t.update({k.replace(">", ">@rmat20", 1): v for k, v in t20.items()})
    time_spmv(g20, card, where20)
    x20 = spmv.random_x(g20, 0)
    for v in spmv.VARIANTS:
        profile(f"spmv {v} rmat{SPMV_TIME_SCALE} seed {SPMV_SEED}, "
                f"{PROFILED_RUNS} spmv.run calls",
                lambda v=v: [spmv.run(g20, x20, variant=v, warmup=False)
                             for _ in range(PROFILED_RUNS)],
                PROFILED_RUNS * KERNELS_PER_PRODUCT[v])
    run.phases.done("8 spmv times")


def group_sssp(run: Run) -> None:
    """Phases 9-11: SSSP (fused, windowed) and k-core."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import bfs, kcore, sssp
    card, errs = run.card, run.errs

    # 9. SSSP and k-core kernels against their plain versions
    for scale in SSSP_SCALES:
        check_sssp_kcore_kernels(*run.weighted_graph(scale), f"rmat{scale}",
                                 errs)
    check_sssp_kcore_kernels(*kcore_stress_graph("cuda"),
                             "a hub, multi-edges and self-loops", errs)
    csr_b, g_b = run.balanced_graph()
    where = (f"a degree-balanced directed graph (V={g_b.n_vertices}, "
             f"E={g_b.n_edges}, a hub of {g_b.max_degree})")
    check_sssp_kcore_kernels(csr_b, g_b, where, errs)
    rb = kcore.run(g_b, warmup=False)
    check(np.array_equal(rb.core.cpu().numpy(), kcore.cpu_reference(csr_b)),
          "kcore on the degree-balanced directed graph differs from the "
          "host peeling")
    s = int(np.argmax(np.diff(csr_b.row_offsets)))
    d = sssp.run(g_b, s, warmup=False).distances.cpu().numpy()
    ref = host_dijkstra(csr_b, s)
    reach = np.isfinite(ref)
    check(np.array_equal(np.isfinite(d), reach)
          and bool(np.all(np.abs(d[reach] - ref[reach])
                          <= SSSP_RTOL * ref[reach])),
          "sssp on the degree-balanced directed graph outside rtol "
          f"{SSSP_RTOL} of Dijkstra")
    print(f"main path: {where}: kcore.run ({rb.iterations} waves) equal to "
          f"the host peeling; sssp.run auto (fused) from {s} within rtol "
          f"{SSSP_RTOL} of the float64 Dijkstra, reach set exact")
    csr18, g18 = run.weighted_graph(SCALE)
    cases = sssp_pred_cases(g18, np.argsort(-np.diff(csr18.row_offsets))[
        :SSSP_RUNS])
    check_pred_sources("sssp_predecessors", cases, f"weighted rmat{SCALE}",
                       errs)
    check(any(check_one_launch("sssp_predecessors",
                               lambda a=a: K.sssp_predecessors(*a),
                               f"weighted rmat{SCALE}",
                               K.device_kernels("sssp_predecessors"))
              for a in cases[:2]),
          "sssp_predecessors: launches per call measured nowhere")
    run.phases.done("9 sssp/kcore kernels")

    # 10. the SSSP and k-core main path at rmat20
    csr_m, g_m = run.weighted_graph(MAIN_SCALE)
    check(g_m.symmetric_layout, "rmat20 graph has no symmetric layout")
    where = f"rmat{MAIN_SCALE}"
    check_sssp_kcore_kernels(csr_m, g_m, where, errs)
    top = int(np.argmax(np.diff(csr_m.row_offsets)))
    states = check_windowed_sssp_kernels(g_m, top, where, errs)
    print(f"kernels: {where}: windowed sssp from {top}: {len(states)} "
          f"sweeps, spmv_slabs<add,min> exact against plain and repeatable")
    check_kernels(g_m, top, errs)
    check_starts_shapes(errs)
    check_kcore_launches(g_m, where)
    check_sssp_launches(g_m, top, where)
    run.phases.done("10a kernels at the main path's shapes")
    sssp_launches, sssp_sources, sssp_runs = sssp_kcore_main_path(csr_m, g_m)
    run.by_path.update(sssp_launches)
    run.phases.done("10b sssp/kcore main path")

    # 11. SSSP and k-core times
    time_sssp_kcore(g_m, sssp_sources, sssp_runs, card)
    run.t.update(time_windowed_sweeps(g_m, states, card))
    run.t.update(time_kcore_waves(g_m, card))
    run.t.update(time_sssp_sweeps(g_m, card))
    top = int(torch.argmax(g_m.out_degrees()[:g_m.n_vertices]))
    run.t.update(time_starts(g_m, sssp_sweep_states(g_m, top)[-1][0], top,
                             card, f"gen:rmat{MAIN_SCALE}x16", "@rmat20"))
    csr18, g18 = run.weighted_graph(SCALE)
    t = time_sssp_kcore_kernels(csr18, g18, card)
    run.t.update(t)
    dev = t["sssp_sweep@search/device"]
    print(f"time [{card}]: sssp_sweep per search (weighted rmat{SCALE}, the "
          f"{t['sweeps']} sweeps of one search summed): "
          f"{t['sssp_sweep@search']:.4f} ms wall, "
          + ("not measured" if dev is None else f"{dev:.4f} ms device")
          + f", plain {t['sssp_sweep@search/plain']:.4f} ms, bound "
          f"{t['sssp_sweep@search/bound'][0]:.4f} ms")
    for name in KERNEL_TABLE["sssp"]:
        if name not in ("kcore_level_wave", "kcore_cascade_wave",
                        "sssp_sweep"):
            print(f"time [{card}]: {name} {t[name]:.4f} ms, plain "
                  f"{t[name + '/plain']:.4f} ms (weighted rmat{SCALE})")
    top = [int(sssp_sources[0])]
    where = f"gen:rmat{MAIN_SCALE}x16 from {top[0]}"
    run.t.update(time_predecessors("bfs_predecessors", bfs_pred_cases(
        g_m, top), card, where, key="bfs_predecessors@rmat20"))
    run.t.update(time_predecessors("sssp_predecessors", sssp_pred_cases(
        g_m, top), card, where, key="sssp_predecessors@rmat20"))
    top18 = np.argsort(-np.diff(csr18.row_offsets))[:SSSP_RUNS].astype(int)
    for where, g_x, srcs in ((f"weighted rmat{SCALE}", g18, top18),
                             (f"gen:rmat{MAIN_SCALE}x16", g_m,
                              sssp_sources)):
        max_it = g_x.n_vertices + 1
        searches = {
            "sssp auto, with predecessors": lambda s, g_x=g_x: sssp.run(
                g_x, s, warmup=False),
            "sssp fused search alone (auto's)":
                lambda s, g_x=g_x, m=max_it: sssp.VARIANTS["fused"](
                    g_x, s, m),
            "bfs fused, with predecessors": lambda s, g_x=g_x: bfs.run(
                g_x, s, variant="fused", warmup=False),
            "bfs fused, without": lambda s, g_x=g_x: bfs.run(
                g_x, s, variant="fused", warmup=False,
                compute_predecessors=False)}
        for label, search in searches.items():
            run.t[f"e2e {label} {where}"] = time_searches(
                f"{label} {where}", card, search, srcs)
    for v in sssp.VARIANTS:
        profile(f"sssp {v} rmat{MAIN_SCALE}, {SSSP_RUNS} sssp.run calls",
                lambda v=v: [sssp.run(g_m, int(s), variant=v, warmup=False)
                             for s in sssp_sources],
                sum(sssp_launches[f"sssp {v}"].values()))
    profile(f"kcore rmat{MAIN_SCALE}, one kcore.run",
            lambda: kcore.run(g_m, warmup=False),
            sum(sssp_launches["kcore"].values()))
    run.phases.done("11 sssp/kcore times")


def group_operators(run: Run) -> None:
    """Phases 12-14: the operator layer, with BFS and SSSP adaptive and
    SpMV pull and push on a directed graph."""
    card, errs = run.card, run.errs

    # 12. operator kernels against their plain versions
    for scale in OP_SCALES:
        check_operator_kernels(run.spmv_graph(scale)[1],
                               f"rmat{scale} seed {SPMV_SEED}", errs)
    csr20, g20 = run.spmv_graph(SPMV_TIME_SCALE)
    where20 = f"rmat{SPMV_TIME_SCALE} seed {SPMV_SEED}"
    check(not g20.symmetric_layout, f"{where20} has a symmetric layout")
    check_operator_kernels(g20, where20, errs)
    check_scan_shapes(errs)
    check_reduce_shapes(errs)
    run.phases.done("12 operator kernels")

    # 13. the adaptive main path on the directed rmat20 graph
    op_launches, op_sources, op_runs = adaptive_main_path(csr20, g20)
    run.by_path.update(op_launches)
    check_adaptive_predecessors(g20, op_sources, op_runs, where20, errs)
    run.phases.done("13 adaptive main path")

    # 14. adaptive times
    time_adaptive(g20, op_sources, op_runs, card)
    t = time_operator_kernels(g20, int(op_sources[0]))
    run.t.update(t)
    for name in KERNEL_TABLE["operators"]:
        per_search = {p: c[name] / ADAPTIVE_RUNS for p, c in
                      op_launches.items() if c[name] and "adaptive" in p}
        lib = t.get(name + "/library")
        print(f"time [{card}]: {name} {t[name]:.4f} ms per launch, plain "
              f"{t[name + '/plain']:.4f} ms, bound "
              f"{t[name + '/bound'][0]:.4f} ms ({t[name + '/bound'][1]} "
              f"at {t[name + '/bound'][2]} rate), "
              f"library call "
              f"{'not measured' if lib is None else f'{lib:.4f} ms'}; "
              f"launches per search {per_search} ({where20}, the largest "
              f"dense frontiers from {op_sources[0]}: bfs, sssp "
              f"{t['frontiers']})")
    print_device(card, f"scan {where20}, compact_frontier's cumsum "
                       f"(torch.cumsum: "
                       + ("not measured" if t["scan/library_device"] is None
                          else f"{t['scan/library_device']:.4f} ms of device "
                               f"time") + ")",
                 t["scan/device"], t["scan/device_rows"])
    lib_dev = t["advance_count/library_device"]
    print_device(card, f"advance_count {where20}, {t['advance_count/tier']} "
                       f"tier (torch.mv: "
                       + ("not measured" if lib_dev is None
                          else f"{lib_dev:.4f} ms of device time") + ")",
                 t["advance_count/device"], t["advance_count/device_rows"])
    print_gather(card, f"{where20}, the dense SSSP gather (2 x [Vp] through "
                       f"csc_src)", t, "gather_payloads")
    print(f"time [{card}]: gather_payloads {where20}, unpacked: "
          f"{t['gather_payloads/unpacked']:.4f} ms per launch (wall), "
          + ("device not measured" if t["gather_payloads/unpacked_device"]
             is None else f"{t['gather_payloads/unpacked_device']:.4f} ms of "
                          f"device time"))
    for key, label in (("segment_reduce", "<min>, the dense SSSP round"),
                       ("segment_reduce@sum", "<sum>, PageRank generic's "
                                              "shape (float32, CSC offsets)")):
        print_against(card, f"segment_reduce {label}, {where20}",
                      {k[len(key):]: v for k, v in t.items()
                       if k == key or k.startswith(key + "/")},
                      "torch.segment_reduce")
    print(f"time [{card}]: advance_count {where20}, global tier: "
          f"{t['advance_count/global']:.4f} ms per launch (wall)")
    print_device(card, f"advance_count {where20}, global tier",
                 t["advance_count/global_device"],
                 t["advance_count/global_rows"])
    run.phases.done("14 adaptive times")


def group_tc(run: Run) -> None:
    """Phases 15-17: triangle counting, the intersection operator, the
    fill kernels and PageRank fused."""
    card, errs = run.card, run.errs

    # 15. the TC and fill kernels against their plain versions
    check_bitmap_kernel(run.bfs_graph(12)[0], "rmat12", errs)
    csr17 = run.tc_graph(TC_SCALE)
    bitmap_args = check_bitmap_kernel(csr17, f"gen:rmat{TC_SCALE}x16", errs)
    check_hub_pairs(errs)
    for scale in (12, SCALE):
        csr_b, g_b = run.bfs_graph(scale)
        fill_args = check_fill_kernels(
            g_b, int(np.argmax(np.diff(csr_b.row_offsets))),
            f"rmat{scale}", errs)
    csr_m, g_m = run.weighted_graph(MAIN_SCALE)
    check_fill_kernels(g_m, int(np.argmax(np.diff(csr_m.row_offsets))),
                       f"gen:rmat{MAIN_SCALE}x16", errs)
    check_fill_shapes(errs)
    run.phases.done("15 tc/fill kernels")

    # 16. the TC, intersection and PageRank fused main path
    csr13 = run.tc_graph(TC_DENSE_SCALE, weighted=False)
    csr_m = run.weighted_graph(MAIN_SCALE)[0]
    csr_u, g_u = run.bfs_graph(SCALE)
    tc_launches, _ = tc_main_path(csr17, csr_m, csr13, g_u, csr_u)
    run.by_path.update(tc_launches)
    run.phases.done("16 tc/intersect/pr fused main path")

    # 17. their times
    pr_counts = tc_launches["pr fused"]
    time_tc(csr17, csr_m, csr13, g_u, card, sum(pr_counts.values()))
    t = time_tc_fill_kernels(bitmap_args, fill_args)
    run.t.update(t)
    run.t.update(time_scan_shapes(g_u, csr_m, card, pr_counts["scan"]))
    run.t.update(time_pr_broadcast(g_u, card,
                                   pr_counts["segment_broadcast_total"]))
    run.t.update(time_pr_gather(g_u, card, pr_counts["gather_payloads"]))
    for name in KERNEL_TABLE["tc"]:
        lib = t[name + "/library"]
        lib_dev = t.get(name + "/library_device")
        dev = t.get(name + "/device")
        print(f"time [{card}]: {name} {t[name]:.4f} ms per launch"
              + ("" if dev is None else f" ({dev:.4f} ms of device time)")
              + f", plain "
              f"{t[name + '/plain']:.4f} ms, bound "
              f"{t[name + '/bound'][0]:.4f} ms ({t[name + '/bound'][1]} at "
              f"{t[name + '/bound'][2]} rate), library call "
              f"{'none' if lib is None else f'{lib:.4f} ms'}"
              + ("" if lib_dev is None else f" ({lib_dev:.4f} ms of device "
                                            f"time)"))
    b = t["fused_route_or/bound_sectors"]
    print(f"time [{card}]: fused_route_or bound with a 32-byte sector a lev "
          f"gather: {b[0]:.4f} ms ({b[2]})")
    dev = t["bitmap_intersect_counts/no_witness_device"]
    work = t["bitmap_intersect_counts/work"]
    print(f"time [{card}]: bitmap_intersect_counts without the witness "
          f"{t['bitmap_intersect_counts/no_witness']:.4f} ms per launch"
          + ("" if dev is None else f" ({dev:.4f} ms of device time)")
          + f" (gen:rmat{TC_SCALE}x16); the bound reads each of "
          f"{work['u_rows']} distinct u rows once and "
          f"{work['other_sectors']} more sectors of B[v] under "
          f"{work['listed_words']} listed words (a word of B[v] under each "
          f"non-zero word of B[u], per pair)")
    for key, what in (("bound_per_pair", "a sector of B[v] read per listed "
                       "word and pair"),
                      ("bound_named_rows", "each named row once, every "
                       "word of each pair ANDed (the earlier model)"),
                      ("bound_streaming", "B[v] read per pair (the TPU "
                       "kernel's streaming model)")):
        b = t["bitmap_intersect_counts/" + key]
        print(f"time [{card}]: bitmap_intersect_counts bound with {what}: "
              f"{b[0]:.4f} ms ({b[1]} at {b[2]} rate)")
    run.phases.done("17 tc/fill times")


def group_color(run: Run) -> None:
    """Phases 18-20: graph coloring (jp, spec, auto), and PageRank and
    HITS generic on a directed graph."""
    card, errs = run.card, run.errs

    # 18. segment_minmax and the wide bitmap against their plain versions
    for scale in (12, SCALE):
        check_minmax_kernel(run.bfs_graph(scale)[1], f"rmat{scale}", errs)
    csr_m, g_m = run.weighted_graph(MAIN_SCALE)
    check_minmax_kernel(g_m, f"gen:rmat{MAIN_SCALE}x16", errs)
    check_minmax_shapes(errs)
    check_wide_bitmap(errs)
    run.phases.done("18 color kernels")

    # 19. the color, PageRank and HITS generic main path
    csr_d, g_d = run.spmv_graph(SPMV_TIME_SCALE)
    csr12, g12 = run.bfs_graph(12)
    color_launches, results = color_main_path(csr_m, g_m, csr12, g12,
                                              csr_d, g_d)
    run.by_path.update(color_launches)
    run.phases.done("19 color/pr/hits generic main path")

    # 20. their times
    time_color(g_m, results, g_d, card)
    t = time_minmax_kernel(g_m)
    run.t.update(t)
    per_run = {p: c["segment_minmax"] for p, c in color_launches.items()
               if c["segment_minmax"]}
    for tag, label in (("", "every real edge active"),
                       ("@round1", "the uncolored mask after one round")):
        key = "segment_minmax" + tag
        n_active, groups = t[key + "/active"]
        bg = t[key + "/bound_groups"]
        print_against(card, f"segment_minmax m = 8, gen:rmat{MAIN_SCALE}x16,"
                            f" {label} ({n_active} active slots, {groups} "
                            f"active groups of 4)", {
                                k[len(key):]: v for k, v in t.items()
                                if k.startswith(key + "/") or k == key})
        print(f"time [{card}]: {key}: bound counting the payloads of the "
              f"active groups of 4 (what the kernel reads) {bg[0]:.4f} ms "
              f"({bg[2]} rate)")
    lib = t["segment_minmax/library"]
    print(f"time [{card}]: segment_minmax: library calls "
          f"{'not measured' if lib is None else f'{lib:.4f} ms'}, the 16 "
          f"segment_reduce launches it replaces "
          f"{t['segment_minmax/segment_reduce_x16']:.4f} ms; launches per "
          f"run {per_run}")
    hub, n, ms, ms_reduce = t["segment_minmax/hub"]
    print(f"time [{card}]: segment_minmax on the largest segment alone "
          f"(vertex {hub}, {n} in-edges): {ms:.4f} ms per launch "
          f"(segment_reduce max on it {ms_reduce:.4f} ms)")
    run.phases.done("20 color times")


def group_variants(run: Run) -> None:
    """Phases 21-23: BFS hybrid, phased and the timed auto, and k-core
    adaptive."""
    by_path, sources = variant_main_path(run)
    run.by_path.update(by_path)
    run.phases.done("21 bfs hybrid/phased/auto main path")
    by_path, _ = kcore_adaptive_main_path(run)
    run.by_path.update(by_path)
    run.phases.done("22 kcore adaptive main path")
    time_variants(run, sources)
    run.phases.done("23 variant times")


def group_bcppr(run: Run) -> None:
    """Phases 24-25: betweenness centrality and personalized PageRank."""
    by_path, sources = bcppr_main_path(run)
    run.by_path.update(by_path)
    run.phases.done("24 bc/ppr main path")
    time_bcppr(run, sources)
    run.phases.done("25 bc/ppr times")


def group_mst(run: Run) -> None:
    """Phases 26-27: the minimum spanning forest (Borůvka)."""
    by_path, cases = mst_main_path(run)
    run.by_path.update(by_path)
    run.phases.done("26 mst main path")
    time_mst(run, cases)
    run.phases.done("27 mst times")


def group_geo(run: Run) -> None:
    """Phases 28-29: geolocation and its spatial median."""
    by_path, cases = geo_main_path(run)
    run.by_path.update(by_path)
    run.phases.done("28 geo main path")
    time_geo(run, cases)
    run.phases.done("29 geo times")


def group_spgemm(run: Run) -> None:
    """Phases 30-31: SpGEMM, the static plan and the chunked path."""
    by_path, t = spgemm_main_path(run)
    run.by_path.update(by_path)
    run.phases.done("30 spgemm main path")
    time_spgemm(run, t)
    run.phases.done("31 spgemm times")


def group_harness(run: Run) -> None:
    """Phases 32-33: the harness's modules, then the CLI."""
    t0 = time.perf_counter()
    csr_o, g_o = run.weighted_graph(MAIN_SCALE)
    csr_ops, g_ops = run.weighted_graph(HARNESS_OP_SCALE)
    by_path = harness_checks(
        csr_o, g_o, csr_ops, g_ops, f"gen:rmat{MAIN_SCALE}x16",
        f"weighted rmat{HARNESS_OP_SCALE}", "chiprun_out/harness_trace")
    run.by_path.update({f"harness {k}": v for k, v in by_path.items()})
    run.phases.done("32 harness modules")
    run.by_path.update(cli_main_path(run))
    run.phases.done("33 cli")
    print(f"harness group: {time.perf_counter() - t0:.1f} s")


def group_parallel(run: Run) -> None:
    """Phases 34-35: the parallel layer on a one-rank NCCL group."""
    import torch.distributed as tdist
    t0 = time.perf_counter()
    csr, g = run.weighted_graph(MAIN_SCALE)
    where = f"gen:rmat{MAIN_SCALE}x16"
    by_path, steps, parts, seconds, source = parallel_main_path(csr, g,
                                                                where)
    run.by_path.update(by_path)
    run.phases.done("34 parallel main path")
    time_parallel(run, csr, steps, parts, seconds, source, where)
    tdist.destroy_process_group()
    run.phases.done("35 parallel times")
    print(f"parallel group: {time.perf_counter() - t0:.1f} s")


GROUPS = {"bfs": group_bfs, "spmv": group_spmv, "sssp": group_sssp,
          "operators": group_operators, "tc": group_tc,
          "color": group_color, "variants": group_variants,
          "bcppr": group_bcppr, "mst": group_mst, "geo": group_geo,
          "spgemm": group_spgemm, "harness": group_harness,
          "parallel": group_parallel}
# the kernels each group checks (keys of kernels.launches), in the order of
# the JSON line; each one's source and the JAX function it replaces are its
# declaration's (kernels.declared)
KERNEL_TABLE = {"bfs": ("bfs_level<int32>", "bfs_level<int8>",
                        "collapse_levels<int32>", "collapse_levels<int8>",
                        "bfs_predecessors"),
                "spmv": ("spmv_rows", "spmv_slabs"),
                "sssp": ("sssp_sweep", "sssp_predecessors",
                         "kcore_level_wave", "kcore_cascade_wave",
                         "collapse_starts", "expand_segments"),
                "operators": ("scan", "gather_payloads", "segment_reduce",
                              "advance_count"),
                "tc": ("bitmap_intersect_counts", "segment_broadcast_total",
                       "suffix_fill_update", "fused_route_or"),
                "color": ("segment_minmax",)}


def kernel_entry(run: Run, name: str) -> dict:
    from essentials_tpu_torch import kernels as K
    timed = {"spmv_rows": "spmv_rows<mul>",
             "spmv_slabs": "spmv_slabs<mul,sum>"}
    t, key = run.t, timed.get(name, name)
    source, row = K.declared(name)
    out = {"name": name, "route": "cuda",
           "source": f"essentials_tpu_torch/csrc/{source}",
           "replaces": f"essentials_tpu/ops/{row.launches[name]}",
           "launches": sum(c[name] for c in run.by_path.values()),
           "launches_by_path": {p: c[name] for p, c in run.by_path.items()
                                if c[name]},
           "max_abs_err": run.errs[name], "ms": t[key],
           "plain_ms": t[key + "/plain"],
           "bound_ms": t[key + "/bound"][0],
           "bound_by": t[key + "/bound"][1],
           "bound_memory": t[key + "/bound"][2],
           "library_ms": t.get(key + "/library")}
    if name in KERNEL_TABLE["spmv"]:
        out.update(max_rel_err=run.errs[name + "/rel"], timed=key)
    if name == "bitmap_intersect_counts":
        out["bound_counts"] = "each distinct u row once, each 32-byte " \
            "sector of B[v] under a non-zero word of B[u] once, eu/ev/cnt " \
            "and the witness array"
        out["work"] = t[key + "/work"]
        out["bound_per_pair_sectors_ms"] = t[key + "/bound_per_pair"][0]
        out["bound_named_rows_ms"] = t[key + "/bound_named_rows"][0]
        out["bound_streaming_ms"] = t[key + "/bound_streaming"][0]
        out["ms_no_witness"] = t[key + "/no_witness"]
        out["device_ms"] = t[key + "/device"]
        out["device_ms_no_witness"] = t[key + "/no_witness_device"]
    if name.startswith("bfs_level<"):
        out["per"] = "search: summed over the levels of one search from " \
            "the highest-degree vertex at rmat18, each from its saved state"
        out["bound_counts"] = "per level: the offsets and each non-empty " \
            "start's 32-byte sector read once, the frontier and unreached " \
            "bitmaps written and read once, the smaller of the push's col " \
            "words and the pull's csc_src words up to each unreached " \
            "segment's first frontier source, the reached starts' sectors"
        out["device_ms"] = t.get(key + "/device")
        out["bound_dense_ms"] = t[key + "/bound_dense"][0]
        out["bound_dense_counts"] = "per level: every start read and " \
            "written, the offsets, every csc_src slot (the earlier " \
            "pull-only kernel's model)"
        out["forced"] = t[key + "/forced"]
        out["levels"] = t[key + "/levels"]
    if name in ("bfs_predecessors", "sssp_predecessors"):
        out["per"] = ("search: the mean over the 16 highest-degree sources "
                      "of rmat18" if name == "bfs_predecessors" else
                      "search from the highest-degree vertex of weighted "
                      "rmat18")
        out["device_ms"] = t.get(key + "/device")
        out["ms_max"] = t[key + "/max"]
        out["device_ms_max"] = t[key + "/device_max"]
        out["ms_by_search"] = t[key + "/walls"]
        out["device_ms_by_search"] = t[key + "/devices"]
        out["bound_counts"] = "per search: the offsets, dist and pred once " \
            "each, csc_src (and w) up to each reached vertex's first hit"
        out["bound_dense_ms"] = t[key + "/bound_dense"][0]
        out["bound_dense_counts"] = "the offsets, dist and pred once each, " \
            "every real csc_src slot (and w)"
        out["work"] = t[key + "/work"]
        out["pred_split"] = K.bfs.PRED_SPLIT
        out["range_walk_launches"] = out["launches"]
        k = key + "@rmat20"
        if k in t:
            out["rmat20x16_top_vertex"] = {
                "ms": t[k], "device_ms": t[k + "/device"],
                "plain_ms": t[k + "/plain"], "bound_ms": t[k + "/bound"][0],
                "bound_memory": t[k + "/bound"][2],
                "bound_dense_ms": t[k + "/bound_dense"][0],
                "work": t[k + "/work"]}
    if name == "segment_reduce":
        out["library_of"] = "torch.segment_reduce (min) of the dense SSSP " \
                            "round's messages over the CSC offsets"
        k = "segment_reduce@sum"
        if k in t:
            out["float_sum_pagerank_generic"] = {
                "ms": t[k], "device_ms": t[k + "/device"],
                "plain_ms": t[k + "/plain"], "bound_ms": t[k + "/bound"][0],
                "bound_memory": t[k + "/bound"][2],
                "library_ms": t[k + "/library"],
                "library_device_ms": t[k + "/library_device"]}
    if name in ("spmv_rows", "spmv_slabs", "gather_payloads",
                "advance_count", "scan", "segment_broadcast_total",
                "suffix_fill_update", "segment_minmax", "kcore_level_wave",
                "kcore_cascade_wave",
                "segment_reduce", "fused_route_or"):
        # device times per call (torch.profiler) beside the wall times
        out["device_ms"] = t.get(key + "/device")
        out["library_device_ms"] = t.get(key + "/library_device")
    if name == "spmv_rows":
        out["library_of"] = "torch.mv: the product spmv_rows<mul> computes"
        for shape, tag in (("rmat20", "@rmat20"),
                           ("pagerank_undirected_rmat18", "@pr")):
            k = key.replace(">", ">" + tag, 1)
            if k in t:
                out[shape] = {"ms": t[k], "device_ms": t[k + "/device"],
                              "bound_ms": t[k + "/bound"][0],
                              "bound_memory": t[k + "/bound"][2],
                              "library_ms": t[k + "/library"],
                              "library_device_ms": t[k + "/library_device"]}
    if name == "gather_payloads":
        out["library_of"] = "torch.index_select of the payloads side by " \
                            "side, one row per index"
        out["packed"] = t.get(key + "/packs")
        out["unpacked"] = {"ms": t.get(key + "/unpacked"),
                           "device_ms": t.get(key + "/unpacked_device")}
        k = "gather_payloads@pr"
        if k in t:
            out["pagerank_fused_undirected_rmat18"] = {
                "ms": t[k], "device_ms": t[k + "/device"],
                "bound_ms": t[k + "/bound"][0],
                "bound_memory": t[k + "/bound"][2],
                "library_ms": t[k + "/library"],
                "library_device_ms": t[k + "/library_device"]}
    if name == "spmv_slabs":
        out["library_of"] = "torch.mv: the product spmv_slabs<mul,sum> " \
                            "computes"
        k20 = key.replace(">", ">@rmat20", 1)
        if k20 in t:
            out["rmat20"] = {"ms": t[k20], "device_ms": t[k20 + "/device"],
                             "one_column_device_ms":
                                 t[k20 + "/one_column_device"],
                             "bound_ms": t[k20 + "/bound"][0],
                             "bound_memory": t[k20 + "/bound"][2],
                             "library_ms": t[k20 + "/library"],
                             "library_device_ms": t[k20 + "/library_device"]}
        if "spmv_slabs<add,min>/sweep" in t:
            b = t["spmv_slabs<add,min>/sweep_bound"]
            out["add_min_sweep_rmat20x16"] = {
                "ms": t["spmv_slabs<add,min>/sweep"],
                "device_ms": t["spmv_slabs<add,min>/sweep_device"],
                "bound_ms": b[0], "bound_memory": b[2]}
    if name == "scan":
        out["library_of"] = "torch.cumsum (int32) of compact_frontier's input"
        for shape, k, lib in (
                ("segmented_float_add_pagerank_fused", "scan<seg>", None),
                ("unsegmented_float_add_2^26", "scan<f32>@big",
                 "torch.cumsum"),
                ("int32_max_tc_shift_rmat20x16", "scan<max>@tc",
                 "torch.cummax")):
            if k in t:
                out[shape] = {"ms": t[k], "device_ms": t[k + "/device"],
                              "plain_ms": t[k + "/plain"],
                              "bound_ms": t[k + "/bound"][0],
                              "bound_memory": t[k + "/bound"][2],
                              "library_of": lib,
                              "library_ms": t[k + "/library"],
                              "library_device_ms": t[k + "/library_device"]}
    if name == "segment_broadcast_total":
        out["library_of"] = "torch.repeat_interleave of the segment-end values"
        k = "segment_broadcast_total@pr"
        if k in t:
            out["pagerank_fused_undirected_rmat18"] = {
                "ms": t[k], "device_ms": t[k + "/device"],
                "plain_ms": t[k + "/plain"], "bound_ms": t[k + "/bound"][0],
                "bound_memory": t[k + "/bound"][2],
                "library_ms": t[k + "/library"],
                "library_device_ms": t[k + "/library_device"]}
    if name == "fused_route_or":
        out["per"] = f"call at the inputs of rmat{SCALE}'s BFS level with " \
                     "the most new vertices"
        out["bound_sectors_ms"] = t[key + "/bound_sectors"][0]
        out["bound_sectors_counts"] = "a 32-byte L2 sector for each lev " \
            "gather, the ids, flags and output streamed"
    if name == "advance_count":
        out["tier"] = t.get(key + "/tier")
        out["global_tier"] = {"ms": t.get(key + "/global"),
                              "device_ms": t.get(key + "/global_device")}
    if name == "segment_minmax":
        out["library_of"] = "two torch.segment_reduce calls (max, min) on " \
                            "float32 copies of the masked payloads"
        out["ms_segment_reduce_x16"] = t[key + "/segment_reduce_x16"]
        k = key + "@round1"
        out["after_one_round"] = {
            "ms": t[k], "device_ms": t[k + "/device"],
            "plain_ms": t[k + "/plain"], "bound_ms": t[k + "/bound"][0],
            "bound_memory": t[k + "/bound"][2],
            "active_slots": t[k + "/active"][0],
            "active_groups_of_4": t[k + "/active"][1],
            "bound_active_groups_ms": t[k + "/bound_groups"][0]}
    if name.startswith("collapse_levels<") or name in ("collapse_starts",
                                                       "expand_segments"):
        # wall per call (back to back), device per call, the PyTorch call
        out["device_ms"] = t.get(key + "/device")
        out["library_device_ms"] = t.get(key + "/library_device")
        out["per"] = {
            "collapse_starts": "call at the final state of a fused search "
                               "from the highest-degree vertex of weighted "
                               f"rmat{SCALE}",
            "expand_segments": "call at init_deg_exp's input, weighted "
                               f"rmat{SCALE}"}.get(
            name, f"call at the levels of a fused search from the "
                  f"highest-degree vertex of rmat{SCALE}")
        if name == "expand_segments":
            out["library_of"] = "torch.repeat_interleave of vals by the " \
                                "segment lengths"
        else:
            out["library_of"] = "torch.index_select at the non-empty " \
                                "segment starts: the gather alone"
            out["bound_sectors_ms"] = t[key + "/bound_sectors"][0]
            out["bound_sectors_counts"] = "a 32-byte sector for each " \
                "non-empty start's gather, the offsets, the output"
        k = key + "@rmat20"
        if k in t:
            out["rmat20x16"] = {
                "ms": t[k], "device_ms": t[k + "/device"],
                "plain_ms": t[k + "/plain"], "bound_ms": t[k + "/bound"][0],
                "bound_memory": t[k + "/bound"][2],
                "library_ms": t[k + "/library"],
                "library_device_ms": t[k + "/library_device"]}
            if k + "/bound_sectors" in t:
                out["rmat20x16"]["bound_sectors_ms"] = \
                    t[k + "/bound_sectors"][0]
    if name in ("kcore_level_wave", "kcore_cascade_wave"):
        out["per_wave"] = "mean over the waves of this kind of one run at " \
                          "gen:rmat20x16"
        out["per_run"] = t[key + "/run"]
    if name == "sssp_sweep":
        out["device_ms"] = t.get(key + "/device")
        out["per_sweep"] = "mean over the sweeps of one search at " \
                           "gen:rmat20x16"
        out["per_search"] = t[key + "/search"]
        k = key + "@search"
        if k in t:
            out["per_search_weighted_rmat18"] = {
                "ms": t[k], "device_ms": t[k + "/device"],
                "plain_ms": t[k + "/plain"], "bound_ms": t[k + "/bound"][0],
                "bound_memory": t[k + "/bound"][2], "sweeps": t["sweeps"]}
    return out


def main(argv=None) -> None:
    import argparse
    parser = argparse.ArgumentParser(
        description="Drive the port's main paths on one CUDA GPU.")
    parser.add_argument(
        "--only", metavar="GROUP[,GROUP]", default=",".join(GROUPS),
        help=f"run only these groups of phases (of {', '.join(GROUPS)}; "
             f"phases 1-2 always run); default: all")
    args = parser.parse_args(argv)
    chosen = [x for x in args.only.split(",") if x]
    unknown = sorted(set(chosen) - set(GROUPS))
    if unknown or not chosen:
        parser.error(f"--only takes groups of {list(GROUPS)}, not {unknown}")
    from essentials_tpu_torch import kernels as K, runtime
    runtime.require_cuda()          # raises: this script runs only on a GPU

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    run = Run(card)
    kind = torch.cuda.get_device_name(0)
    props = runtime.device_properties("cuda:0")
    print(card)
    print(f"device: torch sees {kind!r}, {runtime.num_devices()} card(s), "
          f"capability {props.capability}, {props.sm_count} SMs, "
          f"{props.memory_gib:.1f} GiB; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}; groups {chosen}")
    rate, own = l2_rate()
    MEMORY_RATE["L2"] = max(rate, MEMORY_RATE["HBM"])
    print(f"device [{card}]: L2 rate {rate / 1e12:.4f} TB/s (the extra "
          f"bytes of a {L2_PROBE_MIB[1]} MiB device-to-device copy over a "
          f"{L2_PROBE_MIB[0]} MiB one, over its extra time; each copy "
          f"{L2_COPIES} times back to back in a CUDA graph, median of "
          f"{CYCLES}; the copies "
          f"alone {own[0] / 1e12:.4f} / {own[1] / 1e12:.4f} TB/s); bounds "
          f"use {MEMORY_RATE['L2'] / 1e12:.4f} TB/s where one launch's bytes "
          f"fit {L2_BYTES // 2 ** 20} MiB, else HBM's "
          f"{MEMORY_RATE['HBM'] / 1e12:.2f} TB/s")
    run.phases.done("1 device")

    # 2. build
    t0 = time.perf_counter()
    path, log = K.build()
    K._library()
    print(f"build: {path.name} ready in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "built" in line or "spill" in line:
            print(f"  {line.strip()}")
    run.phases.done("2 build")

    for name, group in GROUPS.items():
        if name in chosen:
            group(run)

    print(json.dumps({"kernels": [
        kernel_entry(run, n)
        for group, ks in KERNEL_TABLE.items() if group in chosen
        for n in ks]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
