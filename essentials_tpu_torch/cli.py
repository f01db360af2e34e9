"""Command-line driver: run any algorithm on a graph file.

Counterpart of ``essentials_tpu/cli.py`` (reference parity: the
per-algorithm example binaries, examples/algorithms/*/*.cu, and their
protocol: load the graph, run (mean of N), diff against the CPU reference,
report time and MTEPS) as one ``essentials-tpu-torch <algo> <graph>
[options]`` entry point. It runs on the CUDA card, and raises where there is
none, unless ``--cpu`` builds the graph on the CPU, where every kernel's
plain version runs.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

ALGORITHMS = ("bfs", "sssp", "pr", "ppr", "bc", "color", "kcore", "hits",
              "spmv", "tc", "mst", "spgemm", "geo")


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="essentials-tpu-torch",
                                description="Graph analytics on a CUDA GPU")
    p.add_argument("algorithm", choices=ALGORITHMS)
    p.add_argument("graph", help=".mtx/.smtx/.csr.npz graph file")
    p.add_argument("--source", type=int, default=0,
                   help="source vertex (bfs/sssp/ppr/bc)")
    p.add_argument("--labels", default=None,
                   help="geo: labels file of 'vertex lat lon' lines "
                        "(default: synthetic 10%% seeded locations)")
    p.add_argument("--runs", type=int, default=5, help="timed runs (mean of)")
    p.add_argument("--undirected", action="store_true",
                   help="treat graph as undirected/symmetric")
    p.add_argument("--no-cache", action="store_true",
                   help="skip the .csr.npz parse cache")
    p.add_argument("--validate", action="store_true",
                   help="diff against the CPU reference")
    p.add_argument("--json", action="store_true", help="JSON stats output")
    p.add_argument("--cpu", action="store_true",
                   help="run on the CPU (the kernels' plain versions)")
    p.add_argument("--variant", default=None,
                   help="algorithm variant: bfs 'fused'/'adaptive', "
                        "pr 'fused'/'generic', tc 'dense'/'bitmap'/'sorted'")
    return p


def geo_labels(args, n_vertices: int, n_padded: int) -> tuple:
    """geo's known locations as [Vp] float32 lat and lon, NaN elsewhere:
    from ``--labels`` (reference parity: the geo example's labels file,
    examples/algorithms/geo/geo.cu:32-90, "<vertex> <lat> <lon>" lines), or
    10% of the vertices drawn with ``default_rng(0)``, as the JAX CLI."""
    lat = np.full(n_padded, np.nan, np.float32)
    lon = np.full(n_padded, np.nan, np.float32)
    if args.labels:
        data = np.loadtxt(args.labels, ndmin=2)
        ids = data[:, 0].astype(np.int64)
        lat[ids], lon[ids] = data[:, 1], data[:, 2]
    else:
        rng = np.random.default_rng(0)
        n_seed = max(n_vertices // 10, 1)
        ids = rng.choice(n_vertices, n_seed, replace=False)
        lat[ids] = rng.uniform(-60, 60, n_seed)
        lon[ids] = rng.uniform(-180, 180, n_seed)
    return lat, lon


class _GraphShim:
    """The counts, properties and device that ``collect_stats`` reads, for
    the algorithms that run on the host Csr (tc)."""

    def __init__(self, csr, device):
        from essentials_tpu_torch.graph.graph import GraphProperties
        self.n_vertices = csr.n_rows
        self.n_edges = csr.nnz
        self.properties = GraphProperties(directed=False, weighted=False)
        self.device = device


def main(argv=None) -> int:
    args = _parser().parse_args(argv)

    from essentials_tpu_torch import algorithms as A, runtime
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import load_graph_file
    from essentials_tpu_torch.io.loader import extract_dataset
    from essentials_tpu_torch.utils import compare
    from essentials_tpu_torch.utils.stats import collect_stats

    if args.cpu:
        device = "cpu"
    else:
        runtime.require_cuda()          # raises: no silent move to the CPU
        device = "cuda"
    csr = load_graph_file(args.graph, cache=not args.no_cache)
    g = build_graph(csr, directed=not args.undirected, weighted=True,
                    device=device)
    name = args.algorithm
    kw = {"variant": args.variant} if args.variant else {}
    errors = None
    times = []

    def timed(run_fn, *a, **kw):
        res = run_fn(*a, warmup=True, **kw)
        times.append(res.elapsed_ms)
        for _ in range(args.runs - 1):
            times.append(run_fn(*a, warmup=False, **kw).elapsed_ms)
        return res, float(np.mean(times))

    if name == "bfs":
        res, ms = timed(A.bfs.run, g, args.source, **kw)
        if args.validate:
            errors = compare(res.distances,
                             A.bfs.cpu_reference(csr, args.source))
    elif name == "sssp":
        res, ms = timed(A.sssp.run, g, args.source, **kw)
        if args.validate:
            errors = compare(res.distances,
                             A.sssp.cpu_reference(csr, args.source))
    elif name == "pr":
        res, ms = timed(A.pr.run, g, **kw)
        if args.validate:
            errors = compare(res.ranks, A.pr.cpu_reference(csr),
                             atol=1e-5, rtol=1e-3)
    elif name == "ppr":
        res, ms = timed(A.ppr.run, g, args.source)
        if args.validate:
            errors = compare(res.p, A.ppr.cpu_reference(csr, args.source),
                             atol=1e-5, rtol=1e-3)
    elif name == "bc":
        res, ms = timed(A.bc.run, g, args.source)
        if args.validate:
            errors = compare(res.bc_values,
                             A.bc.cpu_reference(csr, sources=[args.source],
                                                normalize_undirected=False),
                             atol=1e-3, rtol=1e-3)
    elif name == "color":
        res, ms = timed(A.color.run, g, **kw)
        if args.validate:
            errors = A.color.validate(csr, res.colors.cpu().numpy())
    elif name == "kcore":
        res, ms = timed(A.kcore.run, g, **kw)
        if args.validate:
            errors = compare(res.core, A.kcore.cpu_reference(csr))
    elif name == "hits":
        res, ms = timed(A.hits.run, g)
        if args.validate:
            ra, rh = A.hits.cpu_reference(csr)
            errors = compare(res.auth, ra, atol=1e-4, rtol=1e-3) + \
                compare(res.hub, rh, atol=1e-4, rtol=1e-3)
    elif name == "spmv":
        res, ms = timed(A.spmv.run, g)
        if args.validate:
            # the JAX CLI draws x with jax.random.uniform; the port's x is
            # spmv.random_x's torch draw, 0 past the real vertices
            x = A.spmv.random_x(g, 0)
            r2 = A.spmv.run(g, x, warmup=False)
            errors = compare(r2.y, A.spmv.cpu_reference(
                csr, x[:g.n_vertices].cpu().numpy()), atol=1e-4, rtol=1e-4)
    elif name == "tc":
        res, ms = timed(A.tc.run, csr, device=device, **kw)
        if args.validate:
            total, vt = A.tc.cpu_reference(csr)
            errors = int(res.total != total) + int(not np.array_equal(
                res.vertex_triangles.cpu().numpy(), vt))
    elif name == "mst":
        res, ms = timed(A.mst.run, g)
        if args.validate:
            ref = A.mst.cpu_reference(csr)
            errors = int(abs(res.total_weight - ref)
                         > 1e-4 * max(abs(ref), 1))
    elif name == "spgemm":
        res, ms = timed(A.spgemm.run, csr, csr, device=device)
        if args.validate:
            ref = A.spgemm.cpu_reference(csr, csr)
            errors = int(not np.array_equal(res.c.col_indices,
                                            ref.col_indices))
    elif name == "geo":
        lat, lon = geo_labels(args, g.n_vertices, g.n_vertices_padded)
        res, ms = timed(A.geo.run, g, lat, lon)
        if args.validate:
            rl, ro = A.geo.cpu_reference(csr, lat[:g.n_vertices],
                                         lon[:g.n_vertices])
            errors = compare(res.lat, rl, atol=1e-2, rtol=1e-3) + \
                compare(res.lon, ro, atol=1e-2, rtol=1e-3)

    iters = getattr(res, "iterations", 1)
    stats = collect_stats(name, extract_dataset(args.graph),
                          g if name != "tc" else _GraphShim(csr, g.device),
                          ms, iters, cycles_ms=times)
    if args.json:
        print(stats.to_json())
    else:
        print(f"{name} on {stats.dataset}: {ms:.3f} ms "
              f"({iters} iterations, {stats.mteps:.1f} MTEPS)")
        if errors is not None:
            print(f"validation: {'PASS' if errors == 0 else 'FAIL'} "
                  f"({errors} errors)")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
