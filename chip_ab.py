#!/usr/bin/env python3
"""Time a parent checkout's kernels against this tree's on one CUDA card.

The parent's library is built from its own csrc/ and loaded beside this
tree's. For each measurement the package's wrappers (``wrappers``) are
taken from one side, then the other, in turns (parent, this tree, this
tree, parent), and chip_smoke's own timings run through them, on the
same inputs; both sides' results must agree first. Where one PyTorch call
computes the same function it takes its turn as a third side. The groups
(--only; all by default) and their shapes, those of the port's main paths:

scan: ``scan`` (wall and device time per call, beside the PyTorch call):
* int32 add without flags at n = Vp of directed rmat20 seed 3 (the
  adaptive path's compact_frontier cumsum, on its largest dense BFS
  frontier), beside torch.cumsum;
* float32 add with the CSC segment flags at PageRank fused's shape
  (undirected rmat18);
* int32 max without flags over TC shift's largest chunk at gen:rmat20x16,
  beside torch.cummax.

fill: ``segment_broadcast_total`` (float32 S) at PageRank fused's shape and
at the fill shape of chip_smoke's kernel table (the rmat18 BFS level with
the most new vertices), beside torch.repeat_interleave of the segment-end
values; ``suffix_fill_update`` at that level; ``fused_route_or`` at that
level and at gen:rmat20x16's level with the most new vertices from its
top vertex (also in each --side checkout); one BFS search on
five_pass_superstep (the path fused_route_or runs on) at rmat18 from the
top vertex, wall (median of CYCLES) and device time (over 3 searches).

minmax: ``segment_minmax`` at m = 8 over JP's per-edge priorities at
gen:rmat20x16, under the first round's mask (every real edge active) and
the uncolored mask after one round, beside two torch.segment_reduce calls
(max, min) on float32 copies of the masked payloads.

kcore: one fused k-core run at gen:rmat20x16 (``run_fused_kcore``:
``kcore_level_wave`` and ``kcore_cascade_wave``) on the parent's wrappers
against this tree's: wall time a run (CUDA events) and device time a run
(torch.profiler), and both over the run's waves; this tree's device time
also by kernel: the level passes a level, the cascade's mark a cascade,
the push a wave.

sssp: ``sssp_sweep`` over the sweeps of one fused search from the
highest-degree vertex at gen:rmat20x16, each call from its state (its
output buffer holding the sweep before's distances, restored outside the
timed region): wall and device time per sweep and per search
(chip_smoke.sssp_sweep_ms).

bitmap: ``bitmap_intersect_counts`` over gen:rmat17x16's oriented edges
(TC bitmap's one launch), witness on and off: wall and device time per
call.

reduce: ``segment_reduce`` at the dense SSSP round of directed rmat20 seed
3 (the MIN of its messages over the CSC offsets, the search from the
highest out-degree vertex) and a float SUM at PageRank generic's shape
(seeded float32 messages over the same offsets), wall and device time per
call, beside torch.segment_reduce.

bfs: ``bfs_level`` level by level over one search from the highest-degree
vertex, each call from its saved state, int32 and int8, at undirected
rmat18 and gen:rmat20x16: wall per level (median of CYCLES), device per
level and per search (torch.profiler over a whole search: the pass, the
list, the push and the pull, on both sides); both under the card's
choice of form.

starts: ``expand_segments`` at init_deg_exp's input (k-core's initial
degrees) and ``collapse_starts`` at the final state of a fused SSSP
search from the highest-degree vertex, at weighted rmat18 and
gen:rmat20x16: wall per call (SPMV_REPS calls back to back on CUDA
events) and device per call (torch.profiler), beside
torch.repeat_interleave and index_select at the graph's non-empty starts
(the gather alone), and the kernels of each checkout named by --side;
``collapse_levels`` int32 and int8 at the levels of a fused BFS from the
same vertex on the same graphs (on ``collapse_starts``' body since the
redesign); and the host's read of ``offsets[-1]`` that
expand_segments' wrapper makes each call, alone on an idle stream.

pred: ``bfs_predecessors`` at the distances of a fused search from each
of the 16 highest-degree sources of undirected rmat18 (the mean is what a
search pays) and from the highest-degree vertex of gen:rmat20x16,
``sssp_predecessors`` from the highest-degree vertex of weighted rmat18
and of gen:rmat20x16: wall per call (median of CYCLES) and device per call
(torch.profiler, memsets included), mean and max over the searches, and
the range walk's device time (mean); beside
the parent and this tree, this tree at each PRED_SPLIT of PRED_SPLITS,
and the kernels of each checkout named by --side (a copy of
the package whose csrc/ was edited: a variant that is only timed).

e2e (end to end, in E2E_ROUNDS rounds of turns: 8 runs a side): BFS fused
MTEPS at undirected rmat18 (the median search of the 16 highest-degree
sources, as chip_smoke's phase 5) with the device time of the 16 searches;
PageRank and HITS generic ms per run on directed rmat20 seed 3; PageRank
fused ms per iteration at undirected rmat18; BFS and SSSP adaptive from the
8 highest out-degree sources of directed rmat20 seed 3, the device time of
all 8 searches (torch.profiler) and the wall ms per search; color JP and
k-core ms per run at gen:rmat20x16 with the device time of a run; TC shift
ms per run at gen:rmat20x16 (424,267,437 triangles), in one round; SSSP
fused ms per search from the 8 highest-degree sources of gen:rmat20x16 with
the device time of the 8 searches; TC bitmap ms per run at gen:rmat17x16
(36,033,712 triangles).

spmv, gather, neighbours, pack (the measurements of the previous slice):

* spmv_rows (chip_smoke.rows_against_mv, beside torch.mv on the sparse CSR
  matrix): <mul> at directed rmat18 and rmat20 seed 3 (the fused SpMV),
  <mul> and <none> at undirected rmat18 (PageRank's and HITS's products);
* PageRank and HITS (variant "spmv") ms per iteration at undirected rmat18
  (chip_smoke.pr_hits_ms), in PR_HITS_ROUNDS rounds of turns: host paced,
  so each side gets a spread;
* gather_payloads (chip_smoke.gather_against_index_select, beside
  index_select) at the dense adaptive SSSP step's gather (2 payloads of
  [Vp] through csc_src, directed rmat20 seed 3; this tree packed and
  unpacked, index_select on the payloads stacked per vertex) and at
  PageRank fused's (1 payload of [Ep] through csc_edge_ids, undirected
  rmat18);
* spmv_slabs <mul,sum> and advance_count at rmat20 seed 3 (they share
  csrc/warp_search.cuh with spmv_rows).

Then gather_payloads packed against unpacked over n slots of random indices
into payloads of L words (this tree only, each path forced by
chip_smoke.gather_path): the evidence for
kernels.operators.PACK_MIN_SLOTS and the rule n >= L. Wall: ms per call,
SPMV_REPS calls back to back on CUDA events, median of CYCLES; device:
torch.profiler's device time per call.

    mkdir -p build/parent
    git archive HEAD essentials_tpu_torch chip_smoke.py | tar -x -C build/parent
    python3 chip_ab.py --parent build/parent [--only scan,fill,e2e] \
        [--out ab.json]

(HEAD: the commit an uncommitted change sits on.) Prints one line per side
of each measurement, and writes them all as JSON to the file --out names.
Needs one card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib.util
import inspect
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as CS

PR_HITS_ROUNDS = 4             # rounds of turns: 8 runs on each side
PRED_SPLITS = (512, 1024)      # kernels.bfs.PRED_SPLIT's other values timed
SIDES = {}                     # --side: name -> kernels module
E2E_ROUNDS = 4                 # rounds of turns: 8 runs on each side
PACK_PAYLOADS = (2, 4)
PACK_LENGTH = 1 << 20          # L: a [Vp] payload at RMAT scale 20
PACK_RATIOS = (1 / 16, 1 / 8, 1 / 4, 1 / 2, 1, 2, 4, 16)   # n / L
PACK_SMALL = ((1 << 12, 1 << 14), (1 << 12, 1 << 16), (1 << 16, 1 << 16),
              (1 << 16, 1 << 18))                            # (L, n)


def build(mod, name: str) -> None:
    """Builds ``mod``'s library and prints the ptxas lines of the kernels
    timed here."""
    t0 = time.perf_counter()
    log = mod.build()[1].splitlines()
    mod._library()
    print(f"build: {name} in {time.perf_counter() - t0:.1f} s")
    for i, line in enumerate(log):
        if "Compiling entry" in line and any(
                k in line for k in ("bfs_level_kernel",
                                    "bfs_level_push_kernel",
                                    "bfs_level_pull_kernel",
                                    "segment_reduce_kernel",
                                    "expand_segments_kernel",
                                    "collapse_starts_kernel",
                                    "collapse_levels_kernel",
                                    "fused_route_or_kernel",
                                    "scan_kernel")):
            print(f"  {line.strip()}")
            for nxt in log[i + 1:i + 4]:
                if "Used" in nxt or "spill" in nxt:
                    print(f"    {nxt.strip()}")


def load_kernels(root: Path):
    """The kernels of the checkout at ``root``: its kernels/ package, or its
    single kernels.py where it has no package, imported under a name of its
    own, so that the package's relative imports stay in that checkout."""
    path = root / "essentials_tpu_torch" / "kernels"
    name = "kernels_of_" + re.sub(r"\W", "_", str(root))
    if path.is_dir():
        spec = importlib.util.spec_from_file_location(
            name, path / "__init__.py", submodule_search_locations=[str(path)])
    else:
        spec = importlib.util.spec_from_file_location(name, f"{path}.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_parent(root: Path):
    """The kernels of the checkout at ``root`` (``load_kernels``), built
    from that checkout's csrc/."""
    mod = load_kernels(root)
    build(mod, f"parent from {root}")
    if "col" not in inspect.signature(mod.bfs_level).parameters:
        # the parent's level pulls over csc_src alone
        old_level = mod.bfs_level

        def bfs_level(lev, off, csc_src, col, it, unreached,
                      max_shared_bytes=None):
            return old_level(lev, off, csc_src, it, unreached)
        mod.bfs_level = bfs_level
    return mod


def wrappers() -> list:
    """The names of this tree's wrappers: its keys of kernels.launches
    without their element types."""
    from essentials_tpu_torch import kernels as K
    return list(dict.fromkeys(k.split("<")[0] for k in K.launches))


@contextlib.contextmanager
def bound_to(mod):
    """The package's wrappers taken from ``mod`` while the block runs,
    those that ``mod`` has; chip_smoke and the algorithms call them through
    the package."""
    from essentials_tpu_torch import kernels as K
    saved = {k: getattr(K, k) for k in wrappers() if hasattr(mod, k)}
    for k in saved:
        setattr(K, k, getattr(mod, k))
    try:
        yield
    finally:
        for k, fn in saved.items():
            setattr(K, k, fn)


def on(mod, fn):
    with bound_to(mod):
        return fn()


def per_call(fn) -> float:
    return CS.median_ms(lambda _: [fn() for _ in range(CS.SPMV_REPS)]) \
        / CS.SPMV_REPS


def kernel_ms(fn, reps: int = CS.SPMV_REPS) -> dict:
    return {"wall": CS.median_ms(lambda _: [fn() for _ in range(reps)])
            / reps, "device": CS.device_ms(fn, reps)[0]}


def turns(card: str, label: str, sides: dict, out: dict,
          rounds: int = 1) -> None:
    """Each side's measure() ({metric: ms}) in turns, the sides in order
    and then in reverse, ``rounds`` times; prints every metric's readings
    by side."""
    names = list(sides)
    got = {s: [] for s in names}
    for s in (names + names[::-1]) * rounds:
        got[s].append(sides[s]())
    for s in names:
        print(f"ab [{card}]: {label}: {s}: " + "; ".join(
            f"{m} {CS.fmt_ms([r[m] for r in got[s]])}" for m in got[s][0])
            + " ms")
    out[label] = got


def same_bits(a, b) -> bool:
    return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
               for x, y in zip(a, b))


def spmv_shapes(card: str, run, K0, out: dict) -> None:
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import pr, spmv
    from essentials_tpu_torch.ops.fused_spmv import edge_weights

    def rows_ms(g, w, x) -> dict:
        t = CS.rows_against_mv(g, w, x)
        return {"wall": t[""], "device": t["/device"],
                "torch.mv wall": t["/library"],
                "torch.mv device": t["/library_device"]}

    cases = []
    for scale in (CS.SCALE, CS.SPMV_TIME_SCALE):
        g = run.spmv_graph(scale)[1]
        cases.append((f"spmv_rows<mul> rmat{scale} seed {CS.SPMV_SEED}", g,
                      g.values, spmv.random_x(g, 1)))
    gu = run.bfs_graph(CS.SCALE)[1]
    mask = gu.vertex_mask()
    r = torch.where(mask, 1.0 / gu.n_vertices, 0.0).float()
    cases.append((f"spmv_rows<mul> undirected rmat{CS.SCALE} (PageRank)", gu,
                  edge_weights(gu), r * pr.inverse_weights(gu)))
    cases.append((f"spmv_rows<none> undirected rmat{CS.SCALE} (HITS)", gu,
                  None, mask.float()))
    for label, g, w, x in cases:
        args = (g.row_offsets, g.col_indices, w, x)
        a, b = K0.spmv_rows(*args).double(), K.spmv_rows(*args).double()
        CS.check(bool(((a - b).abs() <= CS.SUM_RTOL * a.abs()
                       + CS.SUM_ATOL).all()),
                 f"{label}: parent and this tree disagree")
        turns(card, label,
              {"parent": lambda: on(K0, lambda: rows_ms(g, w, x)),
               "this": lambda: rows_ms(g, w, x)}, out)
    turns(card, f"pr and hits spmv undirected rmat{CS.SCALE}, ms per "
                f"iteration",
          {"parent": lambda: on(K0, lambda: CS.pr_hits_ms(gu)),
           "this": lambda: CS.pr_hits_ms(gu)}, out, PR_HITS_ROUNDS)


def gather_shapes(card: str, run, K0, out: dict) -> None:
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import sssp

    def gather_ms(idx, pays, stacked, auto: str) -> dict:
        t = CS.gather_against_index_select(idx, pays, stacked, auto)
        return {"wall": per_call(lambda: K.gather_payloads(idx, *pays)),
                "device": t["gather_payloads/device"],
                "index_select device": t["gather_payloads/library_device"]}

    def unpacked(idx, pays, stacked) -> dict:
        with CS.gather_path(False):
            return gather_ms(idx, pays, stacked, "unpacked")

    csr, g = run.spmv_graph(CS.SPMV_TIME_SCALE)
    source = int(np.argmax(np.diff(csr.row_offsets)))
    st = CS.largest_dense_state(g, source, sssp)
    csrc = g.csc_src_indices
    pays = (st.frontier.int(), st.distances)
    both = torch.stack([pays[0], st.distances.view(torch.int32)], 1)
    CS.check(same_bits(K0.gather_payloads(csrc, *pays),
                       K.gather_payloads(csrc, *pays)),
             "dense SSSP gather: parent and this tree disagree")
    turns(card, f"gather_payloads 2 x [Vp] through csc_src (dense SSSP, "
                f"rmat{CS.SPMV_TIME_SCALE} seed {CS.SPMV_SEED})",
          {"parent": lambda: on(K0, lambda: gather_ms(csrc, pays, both,
                                                      "packed")),
           "this": lambda: gather_ms(csrc, pays, both, "packed"),
           "this, unpacked": lambda: unpacked(csrc, pays, both)}, out)
    gu = run.bfs_graph(CS.SCALE)[1]
    ids = gu.csc_edge_ids
    z = torch.from_numpy(np.random.default_rng(3).random(
        gu.n_edges_padded).astype(np.float32)).cuda()
    CS.check(same_bits(K0.gather_payloads(ids, z), K.gather_payloads(ids, z)),
             "PageRank fused gather: parent and this tree disagree")
    turns(card, f"gather_payloads 1 x [Ep] through csc_edge_ids (PageRank "
                f"fused, undirected rmat{CS.SCALE})",
          {"parent": lambda: on(K0, lambda: gather_ms(ids, (z,), z,
                                                      "unpacked")),
           "this": lambda: gather_ms(ids, (z,), z, "unpacked")}, out)


def neighbours(card: str, run, K0, out: dict) -> None:
    """spmv_slabs and advance_count, which share warp_search.cuh."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import bfs, spmv
    csr, g = run.spmv_graph(CS.SPMV_TIME_SCALE)
    x = spmv.random_x(g, 1)
    args = (g.row_offsets, g.col_indices, g.values, g.csr_seg_flags, x,
            "mul", "sum")
    source = int(np.argmax(np.diff(csr.row_offsets)))
    f = CS.largest_dense_state(g, source, bfs).frontier
    cargs = (f, g.csc_offsets, g.csc_src_indices)
    for name, a in (("spmv_slabs", args), ("advance_count", cargs)):
        CS.check(torch.equal(getattr(K0, name)(*a), getattr(K, name)(*a)),
                 f"{name}: parent and this tree disagree")

        def measure(name=name, a=a) -> dict:
            return kernel_ms(lambda: getattr(K, name)(*a))
        turns(card, f"{name} rmat{CS.SPMV_TIME_SCALE} seed {CS.SPMV_SEED}",
              {"parent": lambda m=measure: on(K0, m), "this": measure}, out)


def with_library(K0, measure, lib, name: str, reps: int) -> dict:
    """The sides of a turn: the parent's wrappers (those of ``K0``), this
    tree's, and (where ``lib`` is given) one PyTorch call computing the
    same function, each timed over ``reps`` calls."""
    sides = {"parent": lambda: on(K0, measure), "this": measure}
    if lib is not None:
        sides[name] = lambda: kernel_ms(lib, reps)
    return sides


def scan_shapes(card: str, run, K0, out: dict) -> None:
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import bfs
    csr20, g20 = run.spmv_graph(CS.SPMV_TIME_SCALE)
    source = int(np.argmax(np.diff(csr20.row_offsets)))
    fi = CS.largest_dense_state(g20, source, bfs).frontier.int()
    gu = run.bfs_graph(CS.SCALE)[1]
    x = torch.rand(gu.n_edges_padded, generator=torch.Generator(
        device="cuda").manual_seed(CS.SEED), device="cuda")
    fl = gu.csc_seg_flags
    enc = CS.tc_shift_largest_chunk(run.tc_graph(CS.MAIN_SCALE), "cuda")
    cases = (   # torch.cummax takes about 0.75 s at the chunk: 2 calls
        (f"scan int32 add, n = Vp = {fi.numel()} (compact_frontier, "
         f"rmat{CS.SPMV_TIME_SCALE} seed {CS.SPMV_SEED})", (fi, None, "add"),
         lambda: torch.cumsum(fi, 0, dtype=torch.int32), "torch.cumsum",
         CS.SPMV_REPS),
        (f"scan float32 add with flags, Ep = {x.numel()} (PageRank fused, "
         f"undirected rmat{CS.SCALE})", (x, fl, "add"), None, "",
         CS.SPMV_REPS),
        (f"scan int32 max, n = {enc.numel()} (TC shift's largest chunk, "
         f"gen:rmat{CS.MAIN_SCALE}x16)", (enc, None, "max"),
         lambda: torch.cummax(enc, 0), "torch.cummax", 2))
    for label, args, lib, lib_name, reps in cases:
        a, b = K0.scan(*args), K.scan(*args)
        CS.check(same_bits((a,), (b,)) if args[2] != "add" or
                 not args[0].is_floating_point() else bool(
                     ((a.double() - b.double()).abs() <= CS.SUM_RTOL
                      * a.double().abs() + CS.SUM_ATOL).all()),
                 f"{label}: parent and this tree disagree")
        turns(card, label, with_library(
            K0, lambda args=args, reps=reps: kernel_ms(
                lambda: K.scan(*args), reps), lib, lib_name, reps), out)


def five_pass_search(g, source: int) -> int:
    """One BFS search from ``source`` on five_pass_superstep, the path
    fused_route_or runs on; returns its levels."""
    from essentials_tpu_torch.ops import fused_bfs as FB
    lev, it = FB.init_lev_exp(g, source), 0
    while True:
        lev, any_ = FB.five_pass_superstep(g, lev, it)
        it += 1
        if not int(any_):
            return it


def fill_shapes(card: str, run, K0, out: dict) -> None:
    from essentials_tpu_torch import kernels as K
    csr_u, gu = run.bfs_graph(CS.SCALE)
    fl = gu.csc_seg_flags
    m = torch.rand(gu.n_edges_padded, generator=torch.Generator(
        device="cuda").manual_seed(CS.SEED), device="cuda")
    S = K.scan(m, fl, "add")
    errs = dict.fromkeys(("segment_broadcast_total", "suffix_fill_update",
                          "fused_route_or"), 0)
    top = int(np.argmax(np.diff(csr_u.row_offsets)))
    level = CS.check_fill_kernels(gu, top, f"rmat{CS.SCALE}", errs)
    csr_m, g_m = run.weighted_graph(CS.MAIN_SCALE)
    top_m = int(np.argmax(np.diff(csr_m.row_offsets)))
    level_m = CS.check_fill_kernels(g_m, top_m, f"gen:rmat{CS.MAIN_SCALE}x16",
                                    errs)

    cases = (
        (f"segment_broadcast_total float32, PageRank fused (undirected "
         f"rmat{CS.SCALE})", "segment_broadcast_total", (S, fl)),
        (f"segment_broadcast_total float32, the table's fill shape "
         f"(rmat{CS.SCALE}'s largest level)", "segment_broadcast_total",
         level["broadcast"]),
        (f"suffix_fill_update, rmat{CS.SCALE}'s largest level",
         "suffix_fill_update", level["fill"]),
        (f"fused_route_or, rmat{CS.SCALE}'s largest level from {top}",
         "fused_route_or", level["route"]),
        (f"fused_route_or, gen:rmat{CS.MAIN_SCALE}x16's largest level from "
         f"{top_m}", "fused_route_or", level_m["route"]))
    for label, name, args in cases:
        a, b = getattr(K0, name)(*args), getattr(K, name)(*args)
        a, b = (a, b) if name != "suffix_fill_update" else (a[0], b[0])
        CS.check(same_bits((a,), (b,)), f"{label}: parent and this tree "
                                        f"disagree")
        lib = CS.repeat_interleave_of(*args) \
            if name == "segment_broadcast_total" else None
        sides = with_library(
            K0, lambda name=name, args=args: kernel_ms(
                lambda: getattr(K, name)(*args)), lib,
            "torch.repeat_interleave", CS.SPMV_REPS)
        if name == "fused_route_or":
            for side, mod in SIDES.items():
                CS.check(torch.equal(mod.fused_route_or(*args), b),
                         f"{label}: {side} and this tree disagree")
                sides[side] = lambda m=sides["this"], mod=mod: on(mod, m)
        turns(card, label, sides, out)

    def search() -> dict:
        # 3 searches a window: a window that lost a kernel's activity is
        # retaken (device_ms wants whole multiples of the calls)
        wall = CS.median_ms(lambda _: five_pass_search(gu, top))
        return {"wall": wall, "device": CS.device_ms(
            lambda: five_pass_search(gu, top), 3)[0]}
    levels = five_pass_search(gu, top)
    CS.check(on(K0, lambda: five_pass_search(gu, top)) == levels,
             "the 5-pass search: parent and this tree disagree")
    turns(card, f"5-pass BFS search (five_pass_superstep, {levels} levels) "
                f"rmat{CS.SCALE} from {top}",
          {"parent": lambda: on(K0, search), "this": search}, out)


def minmax_shapes(card: str, run, K0, out: dict) -> None:
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import color
    from essentials_tpu_torch.ops.advance import _expand_and_route
    g = run.weighted_graph(CS.MAIN_SCALE)[1]
    state = color.init(g)
    pays, off = list(state.pri_csc), g.csc_offsets
    for label, frontier in (
            ("every real edge active", state.frontier),
            ("the uncolored mask after one round",
             color.step(g, state, 0).frontier)):
        active = _expand_and_route(g, frontier, "vertices", ())[0]
        args = (pays, active, off)
        CS.check(same_bits(K0.segment_minmax(*args),
                           K.segment_minmax(*args)),
                 f"segment_minmax ({label}): parent and this tree disagree")
        x = state.pri_csc.t().float()
        hi = torch.where(active[:, None], x, float("-inf")).contiguous()
        lo = torch.where(active[:, None], x, float("inf")).contiguous()
        off64 = off.long()
        turns(card, f"segment_minmax m = 8, gen:rmat{CS.MAIN_SCALE}x16, "
                    f"{label} ({int(active.sum())} active slots)",
              with_library(
                  K0, lambda args=args: kernel_ms(
                      lambda: K.segment_minmax(*args)),
                  lambda hi=hi, lo=lo: (
                      torch.segment_reduce(hi, "max", offsets=off64,
                                           unsafe=True),
                      torch.segment_reduce(lo, "min", offsets=off64,
                                           unsafe=True)),
                  "two torch.segment_reduce", CS.SPMV_REPS), out)


def kcore_run_ms(run) -> dict:
    """One k-core run (``run()`` -> (core numbers, waves)): its wall time
    on CUDA events and its device time from torch.profiler, a run and
    over its waves."""
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    waves = run()[1]
    e1.record()
    e1.synchronize()
    wall = e0.elapsed_time(e1)
    dev = CS.device_ms(run, 1)[0]
    return {"wall per run": wall, "device per run": dev,
            "wall per wave": wall / waves,
            "device per wave": None if dev is None else dev / waves}


def kcore_shapes(card: str, run, K0, out: dict) -> None:
    """One fused k-core run at gen:rmat20x16, on the parent's wave wrappers
    and on this tree's in turns, after their core numbers agree; then this
    tree's device time by kernel."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_kcore as FK
    g = run.weighted_graph(CS.MAIN_SCALE)[1]
    max_it = 4 * g.n_vertices + 8

    def parent_run():
        return on(K0, lambda: FK.run_fused_kcore(g, max_it))
    a, waves_a = parent_run()
    K.reset_launches()
    b, waves_b = FK.run_fused_kcore(g, max_it)
    levels = K.counters["kcore.levels"]
    CS.check(torch.equal(a, b) and waves_a == waves_b,
             f"k-core: the parent ({waves_a} waves) and this tree "
             f"({waves_b}) disagree")
    turns(card, f"kcore fused, one run at gen:rmat{CS.MAIN_SCALE}x16 "
                f"({waves_b} waves, {levels} levels)",
          {"parent": lambda: kcore_run_ms(parent_run),
           "this": lambda: kcore_run_ms(
              lambda: FK.run_fused_kcore(g, max_it))}, out, 2)
    rows = CS.device_ms(lambda: FK.run_fused_kcore(g, max_it), 1)[1]

    def total(*names):
        return sum(ms for key, ms in rows.items()
                   if any(n in key for n in names))
    cascades = waves_b - levels
    split = {"level passes a level": total("kcore_level_wave_kernel",
                                           "kcore_level_peel_kernel")
             / levels,
             "cascade mark a cascade": total("kcore_cascade_wave_kernel")
             / max(cascades, 1),
             "push a wave": total("kcore_wave_push_kernel") / waves_b}
    print(f"ab [{card}]: kcore fused gen:rmat{CS.MAIN_SCALE}x16, this "
          f"tree's device time: " + "; ".join(
              f"{k} {v:.4f} ms" for k, v in split.items()))
    out["kcore this tree's device split"] = split


def sssp_shapes(card: str, run, K0, out: dict) -> None:
    """sssp_sweep over one fused search at gen:rmat20x16, the parent's and
    this tree's, after their outputs agree."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    g = run.weighted_graph(CS.MAIN_SCALE)[1]
    source = int(torch.argmax(g.out_degrees()[:g.n_vertices]))
    states = CS.sssp_sweep_states(g, source)
    args = (g.row_offsets, g.col_indices, edge_weights(g))
    for d, prev in states:
        a, b = prev.clone(), prev.clone()
        CS.check(torch.equal(K0.sssp_sweep(d, a, *args),
                             K.sssp_sweep(d, b, *args))
                 and torch.equal(a, b),
                 "sssp_sweep: parent and this tree disagree")

    def measure() -> dict:
        t = CS.sssp_sweep_ms(g, states, K.device_kernels("sssp_sweep"), 3)
        return {k: t[k] for k in ("wall per sweep", "device per sweep",
                                  "wall per search", "device per search")}
    turns(card, f"sssp_sweep over the {len(states)} sweeps of one fused "
                f"search from {source}, gen:rmat{CS.MAIN_SCALE}x16",
          {"parent": lambda: on(K0, measure), "this": measure}, out)


def bitmap_shapes(card: str, run, K0, out: dict) -> None:
    """bitmap_intersect_counts over gen:rmat17x16's oriented edges, witness
    on and off."""
    from essentials_tpu_torch import kernels as K
    eu, ev, bitmap = CS.bitmap_inputs(run.tc_graph(CS.TC_SCALE))
    for witness in (True, False):
        a = K0.bitmap_intersect_counts(eu, ev, bitmap, witness)
        b = K.bitmap_intersect_counts(eu, ev, bitmap, witness)
        CS.check(all((x is None and y is None) or torch.equal(x, y)
                     for x, y in zip(a, b)),
                 f"bitmap_intersect_counts witness {witness}: parent and "
                 f"this tree disagree")
        del a, b

        def measure(witness=witness) -> dict:
            return kernel_ms(lambda: K.bitmap_intersect_counts(
                eu, ev, bitmap, witness), CS.TC_CYCLES)
        turns(card, f"bitmap_intersect_counts gen:rmat{CS.TC_SCALE}x16 "
                    f"({eu.numel()} pairs), witness {witness}",
              {"parent": lambda m=measure: on(K0, m), "this": measure}, out)


def reduce_shapes(card: str, run, K0, out: dict) -> None:
    """segment_reduce: MIN at the dense SSSP round, a float SUM at PageRank
    generic's shape (directed rmat20 seed 3), beside
    torch.segment_reduce."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.algorithms import sssp
    csr, g = run.spmv_graph(CS.SPMV_TIME_SCALE)
    source = int(np.argmax(np.diff(csr.row_offsets)))
    st = CS.largest_dense_state(g, source, sssp)
    cl = g.csc_src_indices.long()
    msg = torch.where(st.frontier[cl], st.distances[cl] + g.csc_values,
                      float("inf"))
    contrib = torch.rand(g.n_edges_padded, generator=torch.Generator(
        device=g.device).manual_seed(CS.SPMV_SEED), device=g.device) \
        / g.n_vertices
    off = g.csc_offsets
    off64 = off.long()
    for op, x, label in (
            ("min", msg, "the dense SSSP round's MIN"),
            ("sum", contrib, "a float SUM at PageRank generic's shape")):
        a, b = K0.segment_reduce(x, off, op), K.segment_reduce(x, off, op)
        CS.check(same_bits((a,), (b,)) if op == "min" else bool(
            ((a.double() - b.double()).abs() <= CS.SUM_RTOL
             * a.double().abs() + CS.SUM_ATOL).all()),
            f"segment_reduce {op}: parent and this tree disagree")
        turns(card, f"segment_reduce <{op}>, {label}, rmat"
                    f"{CS.SPMV_TIME_SCALE} seed {CS.SPMV_SEED}",
              with_library(
                  K0, lambda x=x, op=op: kernel_ms(
                      lambda: K.segment_reduce(x, off, op)),
                  lambda x=x, op=op: torch.segment_reduce(
                      x, op, offsets=off64, unsafe=True),
                  "torch.segment_reduce", CS.SPMV_REPS), out)


def bfs_shapes(card: str, run, K0, out: dict) -> None:
    """bfs_level level by level over one search, int32 and int8, at
    undirected rmat18 and gen:rmat20x16."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    for where, (csr, g) in ((f"rmat{CS.SCALE}", run.bfs_graph(CS.SCALE)),
                            (f"gen:rmat{CS.MAIN_SCALE}x16",
                             run.weighted_graph(CS.MAIN_SCALE))):
        source = int(np.argmax(np.diff(csr.row_offsets)))
        args = CS.level_args(g)
        for unreached in (FB.UNREACHED, FB.UNREACHED_E):
            states = CS.bfs_level_states(g, source, unreached)[0]
            for i, st in enumerate(states):
                a, b = st.clone(), st.clone()
                CS.check(torch.equal(K0.bfs_level(a, *args, i, unreached),
                                     K.bfs_level(b, *args, i, unreached))
                         and torch.equal(a, b),
                         f"bfs_level {where} level {i}: parent and this tree "
                         f"disagree")

            def measure(states=states, unreached=unreached) -> dict:
                t = CS.bfs_level_ms(g, states, unreached,
                                    K.device_kernels("bfs_level<int32>"),
                                    ("device",))
                dev = t["devices"]["device"]
                r = {f"wall level {i}": w for i, w in enumerate(t["walls"])}
                r.update({f"device level {i}": None if dev is None else d
                          for i, d in enumerate(dev or [None] * len(states))})
                r["wall per search"] = sum(t["walls"])
                r["device per search"] = None if dev is None else sum(dev)
                return r
            form = "int8" if unreached == FB.UNREACHED_E else "int32"
            turns(card, f"bfs_level<{form}> over the {len(states)} levels of "
                        f"one search from {source}, {where}",
                  {"parent": lambda m=measure: on(K0, m), "this": measure},
                  out)


@contextlib.contextmanager
def pred_split(split: int):
    """This tree's predecessor kernels at another PRED_SPLIT while the
    block runs."""
    from essentials_tpu_torch.kernels import bfs as KB
    saved, KB.PRED_SPLIT = KB.PRED_SPLIT, split
    try:
        yield
    finally:
        KB.PRED_SPLIT = saved


def pred_shapes(card: str, run, K0, out: dict) -> None:
    """Both predecessor kernels at the shapes of the module docstring."""
    from essentials_tpu_torch import kernels as K
    csr, g = run.bfs_graph(CS.SCALE)
    top16 = np.argsort(-np.diff(csr.row_offsets))[:CS.RUNS]
    csr18, g18 = run.weighted_graph(CS.SCALE)
    csr_m, g_m = run.weighted_graph(CS.MAIN_SCALE)
    top18, top_m = ([int(np.argmax(np.diff(c.row_offsets)))]
                    for c in (csr18, csr_m))
    shapes = {
        f"bfs_predecessors rmat{CS.SCALE}, {CS.RUNS} sources":
            ("bfs_predecessors", CS.bfs_pred_cases(g, top16)),
        f"sssp_predecessors weighted rmat{CS.SCALE} from {top18[0]}":
            ("sssp_predecessors", CS.sssp_pred_cases(g18, top18)),
        f"bfs_predecessors gen:rmat{CS.MAIN_SCALE}x16 from {top_m[0]}":
            ("bfs_predecessors", CS.bfs_pred_cases(g_m, top_m)),
        f"sssp_predecessors gen:rmat{CS.MAIN_SCALE}x16 from {top_m[0]}":
            ("sssp_predecessors", CS.sssp_pred_cases(g_m, top_m))}
    for label, (name, cases) in shapes.items():
        for args in cases:
            CS.check(torch.equal(getattr(K0, name)(*args),
                                 getattr(K, name)(*args)),
                     f"{label}: parent and this tree disagree")

        def measure(name=name, cases=cases) -> dict:
            walls, devs, ranges = [], [], []
            for args in cases:
                kernel = getattr(K, name)       # the side's wrapper
                walls.append(CS.median_ms(lambda _: kernel(*args)))
                ms, rows = CS.device_ms(lambda: kernel(*args),
                                        CS.PRED_DEVICE_REPS)
                devs.append(ms)
                ranges.append(sum(t for k, t in rows.items()
                                  if "_ranges_kernel" in k))
            seen = [d for d in devs if d is not None]
            return {"wall mean": float(np.mean(walls)),
                    "device mean": float(np.mean(seen)) if seen else None,
                    "device max": max(seen) if seen else None,
                    "range walk mean": float(np.mean(ranges))}
        sides = {"parent": lambda m=measure: on(K0, m), "this": measure}
        for split in PRED_SPLITS:
            def variant(m=measure, split=split):
                with pred_split(split):
                    return m()
            sides[f"this, split {split}"] = variant
        for side, mod in SIDES.items():
            sides[side] = lambda m=measure, mod=mod: on(mod, m)
        turns(card, label, sides, out)


def starts_shapes(card: str, run, K0, out: dict) -> None:
    """expand_segments, collapse_starts and collapse_levels at the shapes
    of the module docstring."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    for scale in (CS.SCALE, CS.MAIN_SCALE):
        csr, g = run.weighted_graph(scale)
        where = (f"weighted rmat{scale}" if scale == CS.SCALE
                 else f"gen:rmat{scale}x16")
        off, ep = g.row_offsets, g.n_edges_padded
        top = int(np.argmax(np.diff(csr.row_offsets)))
        starts = CS.segment_starts(off)
        vals = torch.where(g.vertex_mask(), g.out_degrees(), -1).int()
        counts = (off[1:] - off[:-1]).long()
        d = CS.sssp_sweep_states(g, top)[-1][0]
        cases = {
            f"expand_segments {where} (init_deg_exp)": (
                "expand_segments", (vals, off, ep),
                lambda vals=vals, counts=counts, ep=ep:
                    torch.repeat_interleave(vals, counts, output_size=ep),
                "torch.repeat_interleave"),
            f"collapse_starts {where}, fused SSSP's final state from {top}":
                ("collapse_starts", (d, off, K.INF_BITS, top),
                 lambda d=d, starts=starts: torch.index_select(d, 0, starts),
                 "index_select at the starts")}
        for form, unreached in (("int32", FB.UNREACHED),
                                ("int8", FB.UNREACHED_E)):
            lev = CS.bfs_level_states(g, top, unreached)[1]
            cases[f"collapse_levels<{form}> {where} from {top}"] = (
                "collapse_levels", (lev, off, top, unreached),
                lambda lev=lev, starts=starts: torch.index_select(
                    lev, 0, starts), "index_select at the starts")
        for label, (name, args, lib, lib_name) in cases.items():
            for side, mod in {"parent": K0, **SIDES}.items():
                CS.check(torch.equal(getattr(mod, name)(*args),
                                     getattr(K, name)(*args)),
                         f"{label}: {side} and this tree disagree")

            def measure(name=name, args=args) -> dict:
                return kernel_ms(lambda: getattr(K, name)(*args))
            sides = with_library(K0, measure, lib, lib_name, CS.SPMV_REPS)
            for side, mod in SIDES.items():
                sides[side] = lambda m=measure, mod=mod: on(mod, m)
            if name == "expand_segments":       # the write alone
                buf = torch.empty(ep, dtype=torch.int32, device="cuda")
                sides["fill_ of [Ep] int32"] = lambda buf=buf: kernel_ms(
                    lambda: buf.fill_(7))
            turns(card, label, sides, out)
        turns(card, f"host read of offsets[-1] alone, {where}",
              {"this": lambda off=off: {"wall": CS.median_ms(
                  lambda _: int(off[-1]))}}, out)


def end_to_end(card: str, run, K0, out: dict) -> None:
    from essentials_tpu_torch.algorithms import bfs, color, hits, kcore, pr
    from essentials_tpu_torch.algorithms import sssp, tc
    csr_u, gu = run.bfs_graph(CS.SCALE)
    top16 = np.argsort(-np.diff(csr_u.row_offsets))[:CS.RUNS].astype(int)

    def bfs_fused() -> dict:
        def searches():
            return [bfs.run(gu, int(s), variant="fused", warmup=False,
                            compute_predecessors=False) for s in top16]
        ms = float(np.median([r.elapsed_ms for r in searches()]))
        return {"MTEPS": gu.n_edges / 1e3 / ms, "ms per search": ms,
                f"device ms over {len(top16)} searches":
                    CS.device_ms(searches, 1)[0]}
    turns(card, f"bfs fused undirected rmat{CS.SCALE}, {len(top16)} "
                f"highest-degree sources", {
                    "parent": lambda: on(K0, bfs_fused), "this": bfs_fused},
          out, E2E_ROUNDS)
    g20 = run.spmv_graph(CS.SPMV_TIME_SCALE)[1]
    for name, fn in (("pr", pr.run), ("hits", hits.run)):
        def generic(fn=fn) -> dict:
            r = fn(g20, variant="generic", warmup=False)
            return {"ms per run": r.elapsed_ms, "iterations": r.iterations}
        turns(card, f"{name} generic directed rmat{CS.SPMV_TIME_SCALE} seed "
                    f"{CS.SPMV_SEED}", {
                        "parent": lambda m=generic: on(K0, m),
                        "this": generic}, out, E2E_ROUNDS)

    def pr_fused() -> dict:
        r = pr.run(gu, variant="fused")
        return {"ms per iteration": r.elapsed_ms / r.iterations}
    turns(card, f"pr fused undirected rmat{CS.SCALE}", {
        "parent": lambda: on(K0, pr_fused), "this": pr_fused}, out,
        E2E_ROUNDS)
    csr20, g20 = run.spmv_graph(CS.SPMV_TIME_SCALE)
    sources = np.argsort(-np.diff(csr20.row_offsets))[
        :CS.ADAPTIVE_RUNS].astype(int)
    for name, fn in (
            ("bfs", lambda s: bfs.run(g20, s, variant="adaptive",
                                      warmup=False,
                                      compute_predecessors=False)),
            ("sssp", lambda s: sssp.run(g20, s, variant="adaptive",
                                        warmup=False))):
        def searches(fn=fn) -> dict:
            def all_sources():
                for s in sources:
                    fn(int(s))
            wall = CS.median_ms(lambda _: all_sources(), 3) / len(sources)
            return {f"device ms over {len(sources)} searches":
                    CS.device_ms(all_sources, 1)[0],
                    "wall ms per search": wall}
        turns(card, f"{name} adaptive rmat{CS.SPMV_TIME_SCALE} seed "
                    f"{CS.SPMV_SEED}", {
                        "parent": lambda m=searches: on(K0, m),
                        "this": searches}, out, E2E_ROUNDS)
    g_m = run.weighted_graph(CS.MAIN_SCALE)[1]
    def per_run(fn) -> dict:
        return {"ms per run": fn().elapsed_ms,
                "device ms of a run": CS.device_ms(fn, 1)[0]}

    def jp() -> dict:
        return per_run(lambda: color.run(g_m, variant="jp", warmup=False))
    turns(card, f"color jp gen:rmat{CS.MAIN_SCALE}x16",
          {"parent": lambda: on(K0, jp), "this": jp}, out, E2E_ROUNDS)

    def kcore_run() -> dict:
        return kcore_run_ms(lambda: (None, kcore.run(
            g_m, warmup=False).iterations))
    turns(card, f"kcore gen:rmat{CS.MAIN_SCALE}x16",
          {"parent": lambda: on(K0, kcore_run), "this": kcore_run}, out,
          E2E_ROUNDS)
    csr_m = run.tc_graph(CS.MAIN_SCALE)

    def shift() -> dict:
        r = tc.run(csr_m, variant="shift")
        CS.check(r.total == CS.TC_RMAT20_TOTAL, f"tc shift: {r.total}")
        return {"ms per run": r.elapsed_ms}
    turns(card, f"tc shift gen:rmat{CS.MAIN_SCALE}x16", {
        "parent": lambda: on(K0, shift), "this": shift}, out)
    top = np.argsort(-g_m.out_degrees()[:g_m.n_vertices].cpu().numpy())[
        :CS.SSSP_RUNS].astype(int)

    def sssp_fused() -> dict:
        def searches():
            return [sssp.run(g_m, int(s), variant="fused", warmup=False)
                    for s in top]
        wall = float(np.mean([r.elapsed_ms for r in searches()]))
        return {"ms per search": wall,
                f"device ms over {len(top)} searches":
                    CS.device_ms(searches, 1)[0]}
    turns(card, f"sssp fused gen:rmat{CS.MAIN_SCALE}x16, {len(top)} "
                f"highest-degree sources", {
                    "parent": lambda: on(K0, sssp_fused),
                    "this": sssp_fused}, out, E2E_ROUNDS)
    csr17 = run.tc_graph(CS.TC_SCALE)

    def tc_bitmap() -> dict:
        r = tc.run(csr17, variant="bitmap")
        CS.check(r.total == CS.TC_RMAT17_TOTAL, f"tc bitmap: {r.total}")
        return {"ms per run": r.elapsed_ms}
    turns(card, f"tc bitmap gen:rmat{CS.TC_SCALE}x16", {
        "parent": lambda: on(K0, tc_bitmap), "this": tc_bitmap}, out)


def pack_sweep(card: str, out: dict) -> None:
    """Device ms of gather_payloads packed and unpacked over n slots of
    uniform random indices below L, for 2 and 4 payloads of L words."""
    from essentials_tpu_torch import kernels as K
    gen = torch.Generator().manual_seed(4)
    shapes = [(PACK_LENGTH, int(PACK_LENGTH * q)) for q in PACK_RATIOS]
    rows = []
    for length, n in shapes + list(PACK_SMALL):
        idx = torch.randint(0, length, (n,), generator=gen,
                            dtype=torch.int32).cuda()
        pays = [torch.randint(-2**30, 2**30, (length,), generator=gen,
                              dtype=torch.int32).cuda() for _ in range(4)]
        for m in PACK_PAYLOADS:
            ms, res = {}, {}
            for pack in (False, True, True, False):
                with CS.gather_path(pack):
                    before = K.pass_launches["gather_payloads_pack"]
                    res[pack] = K.gather_payloads(idx, *pays[:m])
                    CS.check(K.pass_launches["gather_payloads_pack"] - before
                             == pack, f"gather_payloads packed: {pack}")
                    ms.setdefault(pack, []).append(CS.device_ms(
                        lambda: K.gather_payloads(idx, *pays[:m]),
                        CS.SPMV_REPS)[0])
            CS.check(same_bits(res[True], res[False]),
                     f"packed and unpacked gathers differ (L={length}, n={n})")
            rows.append({"L": length, "n": n, "payloads": m,
                         "unpacked_device_ms": ms[False],
                         "packed_device_ms": ms[True],
                         "rule_packs": K.operators.gather_packs(
                             n, [length] * m)})
            print(f"ab [{card}]: gather_payloads {m} payloads, L={length}, "
                  f"n={n} (n/L {n / length:g}): unpacked "
                  f"{CS.fmt_ms(ms[False])} ms, packed {CS.fmt_ms(ms[True])} "
                  f"ms of device time per call; "
                  f"the rule packs: {rows[-1]['rule_packs']}")
    out["pack_sweep"] = rows


GROUPS = {"starts": starts_shapes, "pred": pred_shapes,
          "reduce": reduce_shapes, "bfs": bfs_shapes,
          "sssp": sssp_shapes, "bitmap": bitmap_shapes,
          "minmax": minmax_shapes, "kcore": kcore_shapes,
          "scan": scan_shapes, "fill": fill_shapes, "e2e": end_to_end,
          "spmv": spmv_shapes, "gather": gather_shapes,
          "neighbours": neighbours,
          "pack": lambda card, run, K0, out: pack_sweep(card, out)}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", type=Path, required=True,
                        help="root of the parent checkout")
    parser.add_argument("--side", action="append", default=[],
                        metavar="NAME=ROOT",
                        help="time the kernels of the checkout at ROOT as "
                             "one more side named NAME (groups starts, "
                             "pred, and fill's fused_route_or)")
    parser.add_argument("--out", type=Path,
                        help="write the measurements as JSON here")
    parser.add_argument("--only", metavar="GROUP[,GROUP]",
                        default=",".join(GROUPS),
                        help=f"run only these groups (of {', '.join(GROUPS)})"
                             f"; default: all")
    args = parser.parse_args(argv)
    chosen = [x for x in args.only.split(",") if x]
    unknown = sorted(set(chosen) - set(GROUPS))
    if unknown or not chosen:
        parser.error(f"--only takes groups of {list(GROUPS)}, not {unknown}")
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch import runtime
    runtime.require_cuda()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    rate, _ = CS.l2_rate()               # the rate chip_smoke.bound uses
    CS.MEMORY_RATE["L2"] = max(rate, CS.MEMORY_RATE["HBM"])
    t0 = time.perf_counter()
    K0 = load_parent(args.parent.resolve())
    for side in args.side:
        name, root = side.split("=", 1)
        SIDES[name] = load_parent(Path(root).resolve())
    build(K, "this tree")
    run = CS.Run(card)
    out = {"card": card}
    for name, group in GROUPS.items():
        if name in chosen:
            group(card, run, K0, out)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(f"ab: done in {time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main()
