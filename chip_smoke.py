#!/usr/bin/env python3
"""Drive the PyTorch port's fused BFS main path once on one CUDA GPU.

Run from the repository root, on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py

Phases, each printing its own lines; the first failure raises and exits
non-zero:

1. device: the card's name and power limit as nvidia-smi reports them;
2. build: compile csrc/bfs_kernels.cu with nvcc for sm_90a and load it;
3. kernels: every level of a BFS, in the int32 and the int8 form, on rmat12
   and rmat18, each kernel against its plain PyTorch version on the same
   tensors, which must agree exactly;
4. main path: bfs.run(variant="fused") and bfs.run(variant="fused8",
   max_iterations=64) from the 16 highest-degree sources of the undirected
   RMAT graph of bench.py (scale 18, edge factor 16, seed 1), held against
   the host cpu_reference and a host check of the predecessors; the launch
   counters must show that every kernel ran on this path;
5. times on CUDA events: BFS MTEPS per variant, and each kernel against its
   plain version at rmat18 shapes; then torch.profiler's device time by
   kernel over the main path, beside its wall time.

The line before the last is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch

SCALE, EDGE_FACTOR, SEED = 18, 16, 1
RUNS = 16              # sources: the highest-degree vertices
MAX_IT = 64            # as bench.py
CYCLES = 7             # timed cycles; the median is reported
CHECKED_SOURCES = 4    # sources whose distances are held against cpu_reference

SOURCE = "essentials_tpu_torch/csrc/bfs_kernels.cu"
REPLACES = {
    "bfs_level<int32>": "essentials_tpu/ops/fused_bfs.py:327",
    "bfs_level<int8>": "essentials_tpu/ops/fused_bfs.py:425",
    "collapse_levels<int32>": "essentials_tpu/ops/cube_router.py:305",
    "collapse_levels<int8>": "essentials_tpu/ops/cube_router.py:305",
    "bfs_predecessors": "essentials_tpu/ops/cube_router.py:586",
}


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


def max_err(a: torch.Tensor, b: torch.Tensor) -> int:
    return int((a.long() - b.long()).abs().max().item()) if a.numel() else 0


# ------------------------------------------------------------- phase 3 --

def check_kernels(g, source: int, errs: dict) -> None:
    """Every level of one BFS in both forms, kernel against plain."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    for unreached in (FB.UNREACHED, FB.UNREACHED_E):
        form = "int8" if unreached == FB.UNREACHED_E else "int32"
        lev_k = FB.init_lev_exp(g, source, unreached)
        lev_p = lev_k.clone()
        it = 0
        while True:
            cnt_k = K.bfs_level(lev_k, g.row_offsets, g.csc_src_indices, it,
                                unreached)
            cnt_p = K.bfs_level_plain(lev_p, g.row_offsets,
                                      g.csc_src_indices, it, unreached)
            torch.cuda.synchronize()
            e = max(max_err(lev_k, lev_p), max_err(cnt_k, cnt_p))
            errs[f"bfs_level<{form}>"] = max(errs[f"bfs_level<{form}>"], e)
            check(e == 0, f"bfs_level<{form}> level {it} differs from plain")
            it += 1
            if cnt_k.item() == 0 or it >= MAX_IT:
                break
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
        print(f"kernels: rmat V={g.n_vertices} source {source} {form}: "
              f"{it} levels, {int((dist_k < FB.UNREACHED).sum())} reached, "
              f"exact against plain")


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


def time_kernels(g, source: int) -> dict:
    """Each kernel and its plain version at rmat18 shapes, one call at a
    time through its wrapper (so a short kernel's time is mostly the
    wrapper's host time): bfs_level summed over the levels of one search,
    each level from its saved state; collapse_levels and bfs_predecessors
    once per search."""
    from essentials_tpu_torch import kernels as K
    from essentials_tpu_torch.ops import fused_bfs as FB
    out = {}
    off, csrc = g.row_offsets, g.csc_src_indices
    for unreached in (FB.UNREACHED, FB.UNREACHED_E):
        form = "int8" if unreached == FB.UNREACHED_E else "int32"
        states, lev, it = [], FB.init_lev_exp(g, source, unreached), 0
        while True:
            states.append(lev.clone())
            cnt = K.bfs_level(lev, off, csrc, it, unreached)
            it += 1
            if cnt.item() == 0 or it >= MAX_IT:
                break
        for name, fn in ((f"bfs_level<{form}>", K.bfs_level),
                         (f"bfs_level<{form}>/plain", K.bfs_level_plain)):
            out[name] = sum(
                median_ms(lambda x, i=i: fn(x, off, csrc, i, unreached),
                          setup=lambda s=s: s.clone())
                for i, s in enumerate(states))
        out[f"collapse_levels<{form}>"] = median_ms(
            lambda _: K.collapse_levels(lev, off, source, unreached))
        out[f"collapse_levels<{form}>/plain"] = median_ms(
            lambda _: K.collapse_levels_plain(lev, off, source, unreached))
    dist = K.collapse_levels(lev, off, source, unreached)
    args = (dist, g.csc_offsets, csrc, g.n_edges)
    out["bfs_predecessors"] = median_ms(lambda _: K.bfs_predecessors(*args))
    out["bfs_predecessors/plain"] = median_ms(
        lambda _: K.bfs_predecessors_plain(*args))
    return out


def profile_searches(g, sources, variant: str, kw: dict) -> dict:
    """Device time by kernel over one bfs.run from each source,
    predecessors included, from torch.profiler, beside the wall time of
    the same run (with the profiler on). Returns {kernel name: (total ms,
    launches)}; empty when the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from essentials_tpu_torch.algorithms import bfs
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for s in sources:
            bfs.run(g, int(s), variant=variant, warmup=False, **kw)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = {e.key: (e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}
    busy = sum(ms for ms, _ in rows.values())
    print(f"profile: bfs {variant}, {len(sources)} runs: wall "
          f"{wall_ms:.3f} ms with the profiler on, device busy "
          f"{busy:.3f} ms" + (f" ({100 * busy / wall_ms:.1f}%, idle "
                              f"{100 - 100 * busy / wall_ms:.1f}%)"
                              if rows else " (not measured: no device time)"))
    for name, (ms, n) in sorted(rows.items(), key=lambda r: -r[1][0]):
        print(f"profile:   {ms:9.4f} ms  {n:5d} launches  {name[:90]}")
    return rows


def main() -> None:
    from essentials_tpu_torch import kernels as K, runtime
    from essentials_tpu_torch.algorithms import bfs
    runtime.require_cuda()          # raises: this script runs only on a GPU

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    props = runtime.device_properties("cuda:0")
    print(card)
    print(f"device: torch sees {kind!r}, {runtime.num_devices()} card(s), "
          f"capability {props.capability}, {props.sm_count} SMs, "
          f"{props.memory_gib:.1f} GiB; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    path, log = K.build()
    K._library()
    print(f"build: {path.name} ready in {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "built" in line or "spill" in line:
            print(f"  {line.strip()}")

    # 3. kernels against their plain versions
    errs = {k: 0 for k in K.launches}
    graphs = {}
    for scale in (12, SCALE):
        t0 = time.perf_counter()
        csr, g = rmat_graph(scale, "cuda")
        graphs[scale] = (csr, g)
        print(f"graph: rmat{scale} ef{EDGE_FACTOR}: V={g.n_vertices} "
              f"E={g.n_edges} Vp={g.n_vertices_padded} "
              f"Ep={g.n_edges_padded}, built in "
              f"{time.perf_counter() - t0:.1f} s")
        check(bfs.fused_supported(g), "rmat graph has no symmetric layout")
        check_kernels(g, int(np.argmax(np.diff(csr.row_offsets))), errs)

    # 4. the main path
    csr, g = graphs[SCALE]
    sources = np.argsort(-np.diff(csr.row_offsets))[:RUNS].astype(int)
    variants = {"fused": {}, "fused8": {"max_iterations": MAX_IT}}
    K.reset_launches()
    results = {v: [bfs.run(g, int(s), variant=v, warmup=False, **kw)
                   for s in sources] for v, kw in variants.items()}
    torch.cuda.synchronize()
    launches = dict(K.launches)
    iters = {v: [r.iterations for r in rs] for v, rs in results.items()}
    print(f"main path: launches {launches}")
    for v in variants:
        print(f"main path: {v} iterations per source {iters[v]}")
    check(launches["bfs_level<int32>"] == sum(iters["fused"]),
          "bfs_level<int32> launches != fused iterations")
    check(launches["bfs_level<int8>"] == sum(iters["fused8"]),
          "bfs_level<int8> launches != fused8 iterations")
    for name in ("collapse_levels<int32>", "collapse_levels<int8>"):
        check(launches[name] == RUNS, f"{name} launches != {RUNS}")
    check(launches["bfs_predecessors"] == 2 * RUNS,
          f"bfs_predecessors launches != {2 * RUNS}")
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
    t = time_kernels(g, int(sources[0]))
    for name in K.launches:
        print(f"time [{card}]: {name} {t[name]:.4f} ms, plain "
              f"{t[name + '/plain']:.4f} ms (rmat{SCALE}, source "
              f"{sources[0]})")
    for v, kw in variants.items():
        profile_searches(g, sources, v, kw)

    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": errs[name], "ms": t[name],
         "plain_ms": t[name + "/plain"]} for name in K.launches]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
