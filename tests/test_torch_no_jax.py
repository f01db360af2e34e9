"""essentials_tpu_torch without JAX: the port and chip_smoke.py import
neither jax nor the JAX package, its main paths (BFS, SpMV, PageRank
``spmv`` and ``fused``, HITS, SSSP, k-core, BFS and SSSP ``adaptive`` on a
directed graph, triangle counting and the intersection operator, coloring
``jp`` and ``spec``, PageRank and HITS ``generic`` on a directed graph, BFS
``hybrid`` and ``phased``, k-core ``adaptive``, BC and PPR, MST, geo,
SpGEMM static and chunked, the helpers, the native parser, the CLI and the
parallel layer on a one-rank gloo group)
run where importing jax fails, and, on a CUDA card, its kernels agree with their
plain versions (the BFS, SSSP, k-core, operator, segment min/max, fill,
route and bitmap kernels exactly, k-core also on a graph with a hub,
multi-edges and self-loops, SSSP and k-core also on a degree-balanced
directed graph, the SSSP sweep's counts (improved, slots pushed) against
the plain route's, the expansion and the collapse of segment starts also on
chip_smoke's stress cases (a hub of 3.5 tiles, empty runs across tile
edges, n = 0), the bitmap kernel also on unsorted pairs with a hub u,
segment min/max on chip_smoke's stress case, advance_count in both its
tiers, the BFS and SSSP predecessors under four splits on a hub whose only
qualifying in-edge lies in its last range and with n_edges cutting it,
spmv_slabs on a row of six slabs, spmv_rows on a row of 40 merge-path
tiles and a run of empty rows, gather_payloads packed and unpacked through
ragged and unaligned indices, but float sums: the SpMV kernels,
``scan`` and ``segment_reduce`` under ``sum``, to |k - p| <= 1e-5 |p| +
1e-6, and a float ``scan`` ``add`` also against a float64 running sum).

This file imports no jax, so its card test runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_no_jax.py
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "essentials_tpu")


def _chip_smoke():
    """chip_smoke.py as a module (its stress inputs), by its path."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


OPERATOR_LAYER = ("frontier/__init__.py", "frontier/boolmap.py",
                  "framework/__init__.py", "framework/enactor.py",
                  "ops/configs.py", "ops/scan_kernels.py", "ops/segment.py",
                  "ops/advance.py", "ops/neighborreduce.py",
                  "ops/sparse_advance.py")
TC_AND_FILLS = ("algorithms/tc.py", "algorithms/pr.py", "ops/intersect.py",
                "ops/bitmap_intersect.py", "ops/fused_bfs.py",
                "csrc/tc_kernels.cu")
COLOR = ("algorithms/color.py", "algorithms/hits.py", "kernels/operators.py")
BC_PPR = ("algorithms/bc.py", "algorithms/ppr.py", "ops/batch.py")
MST_GEO_SPGEMM = ("algorithms/mst.py", "algorithms/geo.py",
                  "algorithms/spgemm.py", "algorithms/helpers.py")
HARNESS = ("cli.py", "examples/run_all.py", "native/mmio_native.py",
           "native/__init__.py", "graph/convert.py", "graph/analytics.py",
           "graph/validate.py", "io/points.py", "ops/filter.py",
           "ops/uniquify.py", "ops/parallel_for.py", "framework/problem.py",
           "utils/printing.py", "utils/stats.py", "utils/checkpoint.py",
           "runtime.py", "dtypes.py")
PARALLEL = ("parallel/__init__.py", "parallel/partition.py",
            "parallel/mesh.py", "parallel/multihost.py",
            "parallel/distributed.py")


def test_sources_import_no_jax():
    files = sorted((ROOT / "essentials_tpu_torch").rglob("*.py"))
    files += [ROOT / "chip_smoke.py", ROOT / "chip_ab.py"]
    assert len(files) > 15
    assert {ROOT / "essentials_tpu_torch" / m
            for m in OPERATOR_LAYER + TC_AND_FILLS[:-1] + COLOR + BC_PPR
            + MST_GEO_SPGEMM + HARNESS + PARALLEL} \
        <= set(files)
    assert (ROOT / "essentials_tpu_torch" / TC_AND_FILLS[-1]).exists()
    for f in files:
        assert not _imported_roots(f) & set(_FORBIDDEN), f


_MAIN_PATH = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in {forbidden!r}:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, _NoJax())
    import numpy as np
    import torch
    from essentials_tpu_torch.algorithms import bfs
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate

    csr = Csr.from_coo(generate.rmat(9, 8, seed=2, weighted=False))
    g = build_graph(csr, directed=False, weighted=False, device="cpu")
    for variant, max_it in (("fused", None), ("fused8", 64)):
        r = bfs.run(g, 1, variant=variant, max_iterations=max_it)
        assert np.array_equal(r.distances.numpy(), bfs.cpu_reference(csr, 1))
    from essentials_tpu_torch.algorithms import hits, pr, spmv
    x = spmv.random_x(g, 3)
    for variant in ("fused", "windowed"):
        y = spmv.run(g, x, variant=variant).y.numpy()
        assert np.allclose(y, spmv.cpu_reference(csr, x.numpy()),
                           rtol=1e-5, atol=1e-6)
    assert np.allclose(pr.run(g).ranks.numpy(), pr.cpu_reference(csr),
                       rtol=1e-4, atol=1e-6)
    assert np.allclose(hits.run(g, max_iterations=8).auth.numpy(),
                       hits.cpu_reference(csr, 8)[0], rtol=1e-3, atol=1e-4)
    from essentials_tpu_torch.algorithms import kcore, sssp
    cw = Csr.from_coo(generate.rmat(9, 8, seed=2, weighted=True))
    gw = build_graph(cw, directed=False, weighted=True, device="cpu")
    ref = sssp.cpu_reference(cw, 1)
    for variant in ("fused", "windowed"):
        d = sssp.run(gw, 1, variant=variant).distances.numpy()
        assert np.array_equal(np.isfinite(d), np.isfinite(ref))
        assert np.allclose(d[np.isfinite(ref)], ref[np.isfinite(ref)],
                           rtol=1e-5, atol=0)
    assert np.array_equal(kcore.run(gw).core.numpy(), kcore.cpu_reference(cw))
    from essentials_tpu_torch import framework, frontier, ops
    cd = Csr.from_coo(generate.rmat(9, 8, seed=2, undirected=False,
                                    weighted=True))
    gd = build_graph(cd, directed=True, weighted=True, device="cpu")
    assert not gd.symmetric_layout
    rb = bfs.run(gd, 1, variant="adaptive")
    assert np.array_equal(rb.distances.numpy(), bfs.cpu_reference(cd, 1))
    ref = sssp.cpu_reference(cd, 1)
    d = sssp.run(gd, 1).distances.numpy()
    assert np.array_equal(np.isfinite(d), np.isfinite(ref))
    x = spmv.random_x(gd, 3)
    for variant in ("pull", "push"):
        assert spmv.run(gd, x, variant=variant).y.isfinite().all()
    assert np.allclose(pr.run(g, variant="fused").ranks.numpy(),
                       pr.cpu_reference(csr), rtol=1e-4, atol=1e-6)
    from essentials_tpu_torch.algorithms import tc
    from essentials_tpu_torch.ops import intersect
    total, vt = tc.cpu_reference(csr)
    for variant in tc.VARIANTS:
        assert tc.run(csr, device="cpu", variant=variant).total == total
    assert np.array_equal(tc.run(csr, device="cpu").vertex_triangles.numpy(),
                          vt)
    u, v = np.arange(0, 50), np.arange(50, 100)
    assert intersect.intersection_counts(csr, u, v, device="cpu").shape \
        == (50,)
    from essentials_tpu_torch.algorithms import color
    for variant in color.VARIANTS:
        rc = color.run(g, variant=variant, warmup=False)
        assert color.validate(csr, rc.colors.numpy()) == 0
    assert np.allclose(pr.run(gd).ranks.numpy(), pr.cpu_reference(cd),
                       rtol=1e-4, atol=1e-6)
    assert np.allclose(hits.run(gd, max_iterations=8).auth.numpy(),
                       hits.cpu_reference(cd, 8)[0], rtol=1e-3, atol=1e-4)
    from essentials_tpu_torch.ops import sparse_advance as SA
    gate = SA._MIN_EDGES
    for variant in ("hybrid", "phased"):
        for spray in (True, False):      # the gate opened, then as it was
            SA._MIN_EDGES = 0 if spray else gate
            rv = bfs.run(g, 1, variant=variant)
            assert np.array_equal(rv.distances.numpy(),
                                  bfs.cpu_reference(csr, 1))
            assert (rv.modes.spray > 0) == spray
    SA._MIN_EDGES = gate
    for override in (None, True):
        rk = kcore.run(gd, spray_override=override)
        assert np.array_equal(rk.core.numpy(), kcore.cpu_reference(cd))
    from essentials_tpu_torch.algorithms import bc, ppr
    # benchmarks/PARITY.md's bounds plus the float32 rounding of the
    # result, as tests/test_torch_bc_ppr.py: BC 2.3e-7 of the largest value
    # and an ulp of it a source, PPR 4.5e-8 and half an ulp of the largest
    # mass an iteration
    def bc_err(a, b):
        return np.abs(a - b).max() / np.abs(b).max()
    for variant in ("spmv", "generic"):
        rc = bc.run(g, 1, variant=variant)
        assert bc_err(rc.bc_values.numpy(), bc.cpu_reference(
            csr, [1], normalize_undirected=False)) <= 2.3e-7 + 2.0 ** -23
    assert bc_err(bc.run_all(gd, sources=[1, 2, 3]).bc_values.numpy(),
                  bc.cpu_reference(cd, [1, 2, 3])) <= 2.3e-7 + 3 * 2.0 ** -23
    rp, ref = ppr.run(gd, 1), ppr.cpu_reference(cd, 1)
    assert np.abs(rp.p.numpy() - ref).max() <= \
        4.5e-8 + rp.iterations * 2.0 ** -24 * np.abs(ref).max()
    assert ppr.run_batch(g, [1, 2]).shape == (2, g.n_vertices)
    from essentials_tpu_torch.algorithms import geo, helpers, mst, spgemm
    rm = mst.run(gw)
    host = mst.cpu_reference(cw)
    assert abs(rm.total_weight - host) <= rm.in_mst.sum().item() * \
        2.0 ** -24 * host
    chosen, c_graph, c_tree = mst.forest_check(cw, rm.in_mst.numpy())
    assert chosen == cw.n_rows - c_graph and c_tree == c_graph
    rng = np.random.default_rng(7)
    lat = rng.uniform(-60, 60, g.n_vertices).astype(np.float32)
    lon = rng.uniform(-180, 180, g.n_vertices).astype(np.float32)
    lat[rng.random(g.n_vertices) > 0.2] = np.nan
    lon[np.isnan(lat)] = np.nan
    rg = geo.run(g, lat, lon)
    ref_lat, _ = geo.cpu_reference(csr, lat, lon)
    assert np.array_equal(np.isnan(rg.lat.numpy()), np.isnan(ref_lat))
    assert np.nanmax(np.abs(rg.lat.numpy() - ref_lat)) <= 1.5e-3
    assert geo.spatial_median(g, *geo.init(g, rg.lat, rg.lon),
                              iterations=2)[0].shape == (g.n_vertices_padded,)
    ref = spgemm.cpu_reference(cd, cd)
    for c in (spgemm.run(cd, cd, device="cpu").c,
              spgemm.run_chunked(cd, cd, chunk_products=1 << 10,
                                 chunk_edges=7, device="cpu").c):
        assert np.array_equal(c.col_indices, ref.col_indices)
        assert np.allclose(c.values, ref.values, rtol=1e-5)
    assert int(helpers.rightmost(torch.tensor([1, 3, 3]), 2)) == 0
    from essentials_tpu_torch import cli
    from essentials_tpu_torch.io import load_mtx
    assert load_mtx("datasets/kron_s12.mtx").nnz == 97112    # native parser
    import contextlib, io
    for algo in ("bfs", "geo", "tc"):
        with contextlib.redirect_stdout(io.StringIO()) as out:
            rc = cli.main([algo, "datasets/chesapeake.mtx", "--cpu",
                           "--validate", "--runs", "1", "--no-cache"])
        assert rc == 0 and "PASS" in out.getvalue()
    import torch.distributed as tdist
    from essentials_tpu_torch.parallel import distributed as D, multihost
    from essentials_tpu_torch.parallel.partition import partition_graph
    multihost.initialize(num_processes=1, device="cpu")
    mesh = multihost.global_mesh()
    for mode in ("all_gather", "boundary"):
        dg = partition_graph(cw, 1, exchange=mode, overlap=True)
        for ov in (False, True):
            d = D.dist_bfs(dg, mesh, 1, overlap=ov).numpy()[:cw.n_rows]
            assert np.array_equal(d, bfs.cpu_reference(cw, 1))
            s = D.dist_sssp(dg, mesh, 1, overlap=ov).numpy()[:cw.n_rows]
            assert np.allclose(s, sssp.cpu_reference(cw, 1), rtol=1e-5)
            assert D.dist_pagerank(dg, mesh, overlap=ov).isfinite().all()
    tdist.destroy_process_group()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in {forbidden!r})
    assert not loaded, loaded
    print("iterations", r.iterations)
""").format(forbidden=_FORBIDDEN)


def test_main_path_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _MAIN_PATH], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("iterations ")


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card(monkeypatch):
    """bfs_level against its plain version at every level, int32 and int8,
    in each form (the card's choice, push and pull forced) and both tiers
    of the pull, on rmat12 and on a degree-balanced directed graph (where a
    push along csc_src would go wrong); bfs.run fused/fused8 against
    cpu_reference there; then the collapse and the predecessors."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import bfs
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    from essentials_tpu_torch.ops import fused_bfs as FB

    csr = Csr.from_coo(generate.rmat(12, 16, seed=4, weighted=False))
    n, src, dst, w = _chip_smoke().balanced_coo(n=20_000)
    csr_b = Csr.from_coo(Coo(n, n, src, dst, w))
    graphs = [(csr, build_graph(csr, directed=False, weighted=False,
                                device="cuda")),
              (csr_b, build_graph(csr_b, directed=True, weighted=False,
                                  device="cuda"))]
    assert graphs[1][1].symmetric_layout
    assert not torch.equal(graphs[1][1].col_indices,
                           graphs[1][1].csc_src_indices)
    kernels.reset_launches()
    levels = {"int32": 0, "int8": 0}
    for c, g in graphs:
        source = int(np.argmax(np.diff(c.row_offsets)))
        args = (g.row_offsets, g.csc_src_indices, g.col_indices)
        for form in kernels.BFS_FORMS:
            monkeypatch.setattr(kernels.bfs, "bfs_level_form",
                                lambda form=form: form)
            for cap in (None, 0):           # the shared and the global tier
                for unreached in (FB.UNREACHED, FB.UNREACHED_E):
                    lev = FB.init_lev_exp(g, source, unreached)
                    ref = lev.clone()
                    for it in range(64):
                        cnt = kernels.bfs_level(lev, *args, it, unreached,
                                                cap)
                        cnt_p = kernels.bfs_level_plain(ref, *args, it,
                                                        unreached)
                        assert torch.equal(lev, ref), (form, cap, it)
                        assert torch.equal(cnt, cnt_p), (form, cap, it)
                        levels["int8" if unreached == FB.UNREACHED_E
                               else "int32"] += 1
                        if cnt.item() == 0:
                            break
                    assert it > 2
            for variant in ("fused", "fused8"):
                r = bfs.run(g, source, variant=variant, max_iterations=64,
                            warmup=False)
                assert np.array_equal(r.distances.cpu().numpy(),
                                      bfs.cpu_reference(c, source)), form
    monkeypatch.undo()
    g = graphs[0][1]
    for unreached in (FB.UNREACHED, FB.UNREACHED_E):
        lev = bfs.run_fused_levels(g, 0, 64,
                                   int8=unreached == FB.UNREACHED_E)[0]
        dist = kernels.collapse_levels(lev, g.row_offsets, 0, unreached)
        assert torch.equal(dist, kernels.collapse_levels_plain(
            lev, g.row_offsets, 0, unreached))
        args = (dist, g.csc_offsets, g.csc_src_indices, g.n_edges)
        assert torch.equal(kernels.bfs_predecessors(*args),
                           kernels.bfs_predecessors_plain(*args))
    bfs_kernels = ("bfs_level<int32>", "bfs_level<int8>",
                   "collapse_levels<int32>", "collapse_levels<int8>",
                   "bfs_predecessors")
    assert all(kernels.launches[k] > 0 for k in bfs_kernels), \
        kernels.launches
    calls = kernels.launches["bfs_level<int32>"] + \
        kernels.launches["bfs_level<int8>"]
    assert calls > sum(levels.values())     # the runs' levels besides
    assert kernels.pass_launches["bfs_level_list"] == calls
    assert kernels.pass_launches["bfs_level_push"] == calls
    assert kernels.pass_launches["bfs_level_pull"] == calls
    assert np.array_equal(dist[:g.n_vertices].cpu().numpy(),
                          bfs.cpu_reference(csr, 0))
    _predecessor_walks_on_the_card("bfs", monkeypatch)


def _predecessor_walks_on_the_card(algo: str, monkeypatch) -> None:
    """``algo``'s predecessor kernel (bfs or sssp) against its plain
    version and a second launch under four splits (at 1 every slot past a
    segment's first is a range of its own), on chip_smoke's graph whose hub
    has its only qualifying in-edge in its last range (with n_edges cutting
    that in-edge and the padding), on the degree-balanced directed graph
    and on directed rmat12 (CSC offsets unlike the CSR's, adaptive
    searches); the range walk launches once a call."""
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    cs = _chip_smoke()
    name = f"{algo}_predecessors"
    kernel, plain = getattr(kernels, name), getattr(kernels, name + "_plain")
    n, src, dst, w = cs.balanced_coo(n=20_000)
    csr_b = Csr.from_coo(Coo(n, n, src, dst, w))
    csr_d = Csr.from_coo(generate.rmat(12, 16, seed=3, undirected=False,
                                       weighted=True))
    others = [(build_graph(c, directed=True, weighted=True, device="cuda"),
               int(np.argmax(np.diff(c.row_offsets)))) for c in (csr_b,
                                                                 csr_d)]
    assert not torch.equal(others[1][0].csc_offsets,
                           others[1][0].row_offsets)
    listed = 0
    for split in (1, 32, 100, kernels.bfs.PRED_SPLIT):
        _, g_h, s_h = cs.pred_stress_graph("cuda", split)
        cases = [a for g, s in ((g_h, s_h), *others)
                 for a in cs.pred_cases(g, s)[algo]]
        listed += cs.pred_work(*cs.pred_work_args(cases[0]), split)["ranges"]
        monkeypatch.setattr(kernels.bfs, "PRED_SPLIT", split)
        ep = cases[0][2].numel()
        assert kernels.pred_scratch(ep, "cuda").numel() == \
            4 + 4 * (ep // split + 1)
        calls = kernels.launches[name]
        ranges = kernels.pass_launches[name + "_ranges"]
        for args in cases:
            pred = kernel(*args)
            assert torch.equal(pred, plain(*args)), (split, args[-1])
            assert torch.equal(pred, kernel(*args)), split
        assert kernels.launches[name] - calls == 2 * len(cases)
        assert kernels.pass_launches[name + "_ranges"] - ranges == \
            2 * len(cases)
    assert listed >= 4 * cs.PRED_HUB_RANGES


@pytest.mark.cuda
def test_spmv_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import spmv
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate

    def close(k, p):
        k, p = k.double(), p.double()
        return bool(((k - p).abs() <= 1e-5 * p.abs() + 1e-6).all())

    # rmat15 and a hub row of 5 slabs and more, which spans six
    coo = generate.rmat(15, 16, seed=3, undirected=False, weighted=True)
    n_hub = 5 * kernels.SLAB_EDGES + 77
    hub_cols = (np.arange(n_hub) * 13 % coo.n_cols).astype(np.int32)
    csr = Csr.from_coo(Coo(
        coo.n_rows, coo.n_cols,
        np.r_[coo.row_indices, np.full(n_hub, 7, np.int32)],
        np.r_[coo.col_indices, hub_cols],
        np.r_[coo.values, np.linspace(0.5, 1.5, n_hub, dtype=np.float32)]))
    g = build_graph(csr, directed=True, weighted=True, device="cuda")
    assert g.max_degree > 5 * kernels.SLAB_EDGES
    off, col, fl = g.row_offsets, g.col_indices, g.csr_seg_flags
    x, w = spmv.random_x(g, 1), g.values
    kernels.reset_launches()
    for wk in (w, None):
        y = kernels.spmv_rows(off, col, wk, x)
        assert torch.equal(y, kernels.spmv_rows(off, col, wk, x))
        assert close(y, kernels.spmv_rows_plain(off, col, wk, x))
    for message in kernels.MESSAGES:
        wk = None if message == "none" else w
        for reduce in kernels.REDUCES:
            y = kernels.spmv_slabs(off, col, wk, fl, x, message, reduce)
            y_p = kernels.spmv_slabs_plain(off, col, wk, fl, x, message,
                                           reduce)
            again = kernels.spmv_slabs(off, col, wk, fl, x, message, reduce)
            assert torch.equal(y, again), (message, reduce)
            if reduce == "min":
                assert torch.equal(y, y_p), message
            else:
                assert close(y.view(torch.float32),
                             y_p.view(torch.float32)), message
    assert kernels.launches["spmv_rows"] == 4
    assert kernels.launches["spmv_slabs"] == 12
    y = spmv.run(g, x, variant="windowed").y.cpu().numpy()
    assert np.allclose(y, spmv.cpu_reference(csr, x.cpu().numpy()),
                       rtol=1e-5, atol=1e-6)

    # spmv_rows on a hub row of 40 merge-path tiles and more (its
    # completion reads the partials of more than 32 tiles) and a run of
    # three tiles of empty rows; against plain, a second launch and the
    # float64 host product
    t = kernels.ROW_TILE
    keep = (coo.row_indices < 9000) | (coo.row_indices >= 9000 + 3 * t)
    n_hub = 40 * t + 99
    csr2 = Csr.from_coo(Coo(
        coo.n_rows, coo.n_cols,
        np.r_[coo.row_indices[keep], np.full(n_hub, 300, np.int32)],
        np.r_[coo.col_indices[keep],
              (np.arange(n_hub) * 29 % coo.n_cols).astype(np.int32)],
        np.r_[coo.values[keep], np.linspace(0.25, 2.0, n_hub,
                                            dtype=np.float32)]))
    g2 = build_graph(csr2, directed=True, weighted=True, device="cuda")
    assert g2.max_degree > 40 * t
    assert int((g2.out_degrees()[9000:9000 + 3 * t] == 0).sum()) == 3 * t
    x2 = spmv.random_x(g2, 2)
    kernels.reset_launches()
    for wk in (g2.values, None):
        y = kernels.spmv_rows(g2.row_offsets, g2.col_indices, wk, x2)
        assert torch.equal(y, kernels.spmv_rows(g2.row_offsets,
                                                g2.col_indices, wk, x2))
        assert close(y, kernels.spmv_rows_plain(g2.row_offsets,
                                                g2.col_indices, wk, x2))
        w64 = 1.0 if wk is None else csr2.values.astype(np.float64)
        ref = np.bincount(
            np.repeat(np.arange(csr2.n_rows), np.diff(csr2.row_offsets)),
            weights=w64 * x2.cpu().numpy().astype(np.float64)[
                csr2.col_indices], minlength=csr2.n_rows)
        assert close(y[:g2.n_vertices].cpu(), torch.from_numpy(ref))
    assert kernels.launches["spmv_rows"] == 4


def _kcore_waves_on_the_card(g) -> int:
    """Every wave of one k-core run on the card, launched twice, each
    launch from its own copy of the wave's state, and also run by the
    plain route from that state: the scalars (peeled, candidates listed,
    ranges listed, k), the candidate set (the plain route lists it in
    vertex order) and every start's degree and core bits, wave by wave,
    the run going on from the first launch's outputs. Returns the waves."""
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.ops import fused_kcore as FK
    adj = (g.row_offsets, g.csc_src_indices, g.col_indices)
    deg = FK.init_deg_exp(g)
    core = torch.zeros_like(deg)
    cand_in, cand_out, scratch = FK.wave_buffers(g)
    _, cand_r, scratch_r = FK.wave_buffers(g)
    _, cand_p, scratch_p = FK.wave_buffers(g)
    n_in, k, waves, alive = 0, 0, 0, FK.alive_vertices(g)
    while alive:
        if n_in:
            fn, fn_p = (kernels.kcore_cascade_wave,
                        kernels.kcore_cascade_wave_plain)
            args = (*adj, k, cand_in, n_in)
        else:
            fn, fn_p = kernels.kcore_level_wave, kernels.kcore_level_wave_plain
            args = adj
        deg_r, core_r = deg.clone(), core.clone()
        deg_p, core_p = deg.clone(), core.clone()
        s = fn(deg, core, *args, cand_out, scratch)
        s_r = fn(deg_r, core_r, *args, cand_r, scratch_r)
        s_p = fn_p(deg_p, core_p, *args, cand_p, scratch_p)
        peeled, n_out, _, k = s_p.tolist()
        for got in ((s, deg, core, cand_out), (s_r, deg_r, core_r, cand_r)):
            assert torch.equal(got[0], s_p), waves
            assert torch.equal(got[1], deg_p), waves
            assert torch.equal(got[2], core_p), waves
            assert torch.equal(got[3][:n_out].sort().values,
                               cand_p[:n_out]), waves
        cand_in, cand_out, n_in = cand_out, cand_in, n_out
        alive, waves = alive - peeled, waves + 1
    return waves


def _sweeps_on_the_card(csr, g):
    """Every sweep of one SSSP search from the highest-degree vertex (each
    output buffer holding the sweep before's distances) and every wave of
    one k-core run, kernel against plain; then the collapse, the
    predecessors and the expansion. Returns the source."""
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.ops import fused_kcore as FK
    from essentials_tpu_torch.ops import fused_sssp as FS
    from essentials_tpu_torch.ops.fused_spmv import edge_weights
    off, src, col = g.row_offsets, g.csc_src_indices, g.col_indices
    w = edge_weights(g)
    source = int(np.argmax(np.diff(csr.row_offsets)))
    d, prev, sweeps = FS.init_dist_exp(g, source), FS.init_spare(g), 0
    while True:
        d_k, d_p = prev.clone(), prev.clone()
        cnt = kernels.sssp_sweep(d, d_k, off, col, w)
        cnt_p = kernels.sssp_sweep_plain(d, d_p, off, col, w)
        assert torch.equal(d_k, d_p) and torch.equal(cnt, cnt_p), sweeps
        d, prev, sweeps = d_k, d, sweeps + 1
        if cnt.item() == 0:
            break
    assert sweeps > 2
    dist = kernels.collapse_starts(d, off, FS.INF_BITS, source)
    assert torch.equal(dist, kernels.collapse_starts_plain(
        d, off, FS.INF_BITS, source))
    args = (dist.view(torch.float32), g.csc_offsets, src, FS.csc_weights(g),
            g.n_edges)
    assert torch.equal(kernels.sssp_predecessors(*args),
                       kernels.sssp_predecessors_plain(*args))
    deg = FK.init_deg_exp(g)
    vals = torch.where(g.vertex_mask(), g.out_degrees(), -1).int()
    assert torch.equal(deg, kernels.expand_segments_plain(
        vals, off, g.n_edges_padded))
    assert _kcore_waves_on_the_card(g) > 1
    return source


@pytest.mark.cuda
def test_sweep_counts_match_plain_route_on_the_card():
    """Every sweep of one fused search from the highest-degree vertex, on
    rmat12 and on a degree-balanced directed graph with a hub: the
    kernel's improved count and the CSR slots its push read
    (``sssp_sweep_count``) equal the plain route's, run on the CPU from
    the same state; a fused sssp.run counts their sums."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import sssp
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    from essentials_tpu_torch.ops import fused_sssp as FS
    from essentials_tpu_torch.ops.fused_spmv import edge_weights

    n, src, dst, w = _chip_smoke().balanced_coo(n=20_000)
    cases = [(Csr.from_coo(generate.rmat(12, 16, seed=1, weighted=True)),
              False), (Csr.from_coo(Coo(n, n, src, dst, w)), True)]
    for csr, directed in cases:
        g = build_graph(csr, directed=directed, weighted=True, device="cuda")
        adj = (g.row_offsets, g.col_indices, edge_weights(g))
        adj_h = tuple(t.cpu() for t in adj)
        source = int(np.argmax(np.diff(csr.row_offsets)))
        d, prev = FS.init_dist_exp(g, source), FS.init_spare(g)
        improved = slots = sweeps = 0
        while True:
            d_k, d_p = prev.clone(), prev.cpu()
            got = kernels.sssp_sweep_count(kernels.sssp_sweep(d, d_k, *adj))
            want = kernels.sssp_sweep_count(kernels.sssp_sweep(
                d.cpu(), d_p, *adj_h))
            assert got == want and torch.equal(d_k.cpu(), d_p), sweeps
            improved, slots = improved + got[0], slots + got[1]
            d, prev, sweeps = d_k, d, sweeps + 1
            if got[0] == 0:
                break
        assert sweeps > 2 and 0 < slots < sweeps * g.n_edges
        kernels.reset_launches()
        r = sssp.run(g, source, variant="fused", warmup=False)
        assert r.iterations == sweeps
        assert kernels.counters["sssp.push_slots"] == slots
        assert kernels.counters["sssp.improved"] == improved


@pytest.mark.cuda
def test_sssp_kcore_kernels_match_plain_versions_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import kcore, sssp
    from essentials_tpu_torch.formats import Coo, Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate

    csr = Csr.from_coo(generate.rmat(12, 16, seed=1, weighted=True))
    g = build_graph(csr, directed=False, weighted=True, device="cuda")
    kernels.reset_launches()
    source = _sweeps_on_the_card(csr, g)
    assert all(kernels.launches[n] > 0 for n in (
        "sssp_sweep", "sssp_predecessors", "kcore_level_wave",
        "kcore_cascade_wave", "collapse_starts", "expand_segments"))
    assert kernels.pass_launches["sssp_sweep_push"] == \
        kernels.launches["sssp_sweep"]
    # a degree-balanced directed graph (a symmetric layout, an asymmetric
    # adjacency: the pushes must walk the CSR columns), every sweep and
    # wave, then its runs against the host
    n, src_b, dst_b, w_b = _chip_smoke().balanced_coo(n=20_000)
    csr_b = Csr.from_coo(Coo(n, n, src_b, dst_b, w_b))
    g_b = build_graph(csr_b, directed=True, weighted=True, device="cuda")
    assert g_b.symmetric_layout and g_b.max_degree > 3000
    assert not torch.equal(g_b.col_indices, g_b.csc_src_indices)
    s_b = _sweeps_on_the_card(csr_b, g_b)
    assert np.array_equal(kcore.run(g_b).core.cpu().numpy(),
                          kcore.cpu_reference(csr_b))
    ref = sssp.cpu_reference(csr_b, s_b)
    got = sssp.run(g_b, s_b).distances.cpu().numpy()
    reach = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), reach)
    assert np.allclose(got[reach], ref[reach], rtol=1e-5, atol=0)
    # every wave on a graph with a hub, multi-edges and self-loops, then
    # its whole run against the host peeling
    csr_s, g_s = _chip_smoke().kcore_stress_graph("cuda")
    assert csr_s.degrees().max() > 1000 and kcore.fused_supported(g_s)
    assert _kcore_waves_on_the_card(g_s) > 3
    assert kernels.pass_launches["kcore_level_peel"] == \
        kernels.launches["kcore_level_wave"] > 0
    assert kernels.pass_launches["kcore_wave_push"] == \
        kernels.launches["kcore_level_wave"] + \
        kernels.launches["kcore_cascade_wave"]
    assert kernels.launches["kcore_cascade_wave"] > 0
    assert np.array_equal(kcore.run(g_s).core.cpu().numpy(),
                          kcore.cpu_reference(csr_s))
    # the expansion and the collapse on chip_smoke's stress cases (a hub of
    # 3.5 tiles, an empty run across a tile edge, ends on a tile's last
    # and first places, n and Vp not multiples of 4, n = 0, every source)
    errs = dict.fromkeys(("expand_segments", "collapse_starts",
                          "collapse_levels<int32>", "collapse_levels<int8>"),
                         0)
    before = dict(kernels.launches)
    _chip_smoke().check_starts_shapes(errs)
    assert set(errs.values()) == {0}
    assert all(kernels.launches[k] > before[k] for k in errs)
    ref = sssp.cpu_reference(csr, source)
    got = sssp.run(g, source).distances.cpu().numpy()
    reach = np.isfinite(ref)
    assert np.array_equal(np.isfinite(got), reach)
    assert np.allclose(got[reach], ref[reach], rtol=1e-5, atol=0)
    assert np.array_equal(kcore.run(g).core.cpu().numpy(),
                          kcore.cpu_reference(csr))
    _predecessor_walks_on_the_card("sssp", monkeypatch)


@pytest.mark.cuda
def test_operator_kernels_match_plain_versions_on_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import bfs, sssp
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate

    def close(k, p):
        k, p = k.double(), p.double()
        return bool(((k - p).abs() <= 1e-5 * p.abs() + 1e-6).all())

    def bits(t):
        return t.view(torch.int32)

    def exact(t):
        return bits(t) if t.is_floating_point() else t

    csr = Csr.from_coo(generate.rmat(12, 16, seed=3, undirected=False,
                                     weighted=True))
    g = build_graph(csr, directed=True, weighted=True, device="cuda")
    rng = np.random.default_rng(0)
    n = g.n_edges_padded
    kernels.reset_launches()
    # scan: 1, a tile -1, a tile, a tile +1, many tiles and the graph's Ep;
    # flags absent, sparse, at every position, only at position 0; every
    # op on both types; float add within tolerance and the same bits over
    # three calls, every other case the plain version's bits
    tile = kernels.SCAN_TILE
    calls = 0
    for m in (1, tile - 1, tile, tile + 1, 300 * tile + 5, n):
        only0 = torch.zeros(m, dtype=torch.bool, device="cuda")
        only0[0] = True
        for fl in (None, torch.from_numpy(rng.random(m) < 0.01).cuda(),
                   torch.ones(m, dtype=torch.uint8, device="cuda"), only0):
            for x in (torch.from_numpy(rng.integers(-2**30, 2**30, m).astype(
                    np.int32)).cuda(), torch.from_numpy(rng.random(m).astype(
                        np.float32)).cuda()):
                for op in kernels.SCAN_OPS:
                    k = kernels.scan(x, fl, op)
                    p = kernels.scan_plain(x, fl, op)
                    again = [kernels.scan(x, fl, op) for _ in range(2)]
                    calls += 3
                    assert all(torch.equal(bits(k), bits(a)) for a in again)
                    if op == "add" and x.is_floating_point():
                        assert close(k, p), (m, op, fl is None)
                    else:
                        assert torch.equal(bits(k), bits(p)), (
                            m, x.dtype, op, None if fl is None else
                            int(fl.sum()))
    big = torch.rand(1 << 26, generator=torch.Generator(
        device="cuda").manual_seed(0), device="cuda")
    k = kernels.scan(big)                 # unsegmented float add: g^2/2 reads
    assert torch.equal(bits(k), bits(kernels.scan(big)))
    assert close(k, kernels.scan_plain(big))
    calls += 2
    assert kernels.launches["scan"] == calls
    del big, k
    # segment_reduce over the graph's offsets, and across tile boundaries:
    # a hub over 40 tiles, a run of empty segments longer than a tile,
    # offsets from 37, values as a view at a 4-byte offset; values other
    # than 0 and 1 for or/and; the float sum the same bits over 3 calls
    tile = kernels.REDUCE_TILE
    lengths = rng.integers(0, 6, 30_000)
    lengths[7] = 40 * tile + 37
    lengths[20_000:20_000 + tile + 300] = 0
    off_s = torch.from_numpy(np.concatenate([[37], 37 + np.cumsum(
        lengths)]).astype(np.int32)).cuda()
    m = int(off_s[-1]) + 50
    for x in (torch.from_numpy(rng.integers(-2**30, 2**30, n).astype(
            np.int32)).cuda(), torch.from_numpy(rng.random(n).astype(
                np.float32)).cuda(),
            torch.from_numpy(rng.integers(-3, 4, m + 1).astype(
                np.int32)).cuda()[1:],
            torch.from_numpy(rng.random(m + 1).astype(
                np.float32)).cuda()[1:]):
        offs = (g.csc_offsets, g.row_offsets) if x.numel() == n else (off_s,)
        for off in offs:
            for op in kernels.REDUCE_OPS:
                k = kernels.segment_reduce(x, off, op)
                again = [kernels.segment_reduce(x, off, op)
                         for _ in range(2)]
                assert all(torch.equal(k, a) for a in again), (x.dtype, op)
                if op == "sum" and x.is_floating_point():
                    # a float64 sum on the host: the plain version's CUDA
                    # index_add_ adds in another order on every call
                    p = kernels.segment_reduce_plain(x.cpu().double(),
                                                     off.cpu(), op)
                    ok = close(k.cpu(), p)
                else:
                    p = kernels.segment_reduce_plain(x, off, op)
                    ok = torch.equal(exact(k), exact(p))
                assert ok, (x.dtype, op, off.numel())
    vp = g.n_vertices_padded
    # payloads of unequal lengths; the whole index, a ragged count and a
    # view at an odd offset; packed and unpacked, bit for bit
    pays = [torch.from_numpy(rng.random(vp).astype(np.float32)).cuda(),
            torch.arange(vp + 3, dtype=torch.int32, device="cuda"),
            torch.from_numpy(rng.random(vp + 70).astype(np.float32)).cuda(),
            -torch.arange(vp + 1, dtype=torch.int32, device="cuda")]
    src = g.csc_src_indices
    calls = packs = 0
    for idx in (src, src[:-3], src[1:], src[3:-2]):
        for m in range(1, 5):
            for pack in (False, True) if m > 1 else (False,):
                # each path whatever the rule would choose at this shape
                monkeypatch.setattr(kernels.operators, "gather_packs",
                                    lambda n, lengths, pack=pack: pack)
                k = kernels.gather_payloads(idx, *pays[:m])
                p = kernels.gather_payloads_plain(idx, *pays[:m])
                assert all(a.dtype == b.dtype and torch.equal(
                    a.view(torch.int32), b.view(torch.int32))
                    for a, b in zip(k, p)), (idx.numel(), m, pack)
                calls, packs = calls + 1, packs + pack
    assert kernels.launches["gather_payloads"] == calls
    assert kernels.pass_launches["gather_payloads_pack"] == packs
    monkeypatch.undo()
    f = torch.from_numpy(rng.random(vp) < 0.3).cuda() & g.vertex_mask()
    args = (g.csc_offsets, g.csc_src_indices)
    assert kernels.advance_count_tier(vp, "cuda") == "shared"
    assert kernels.advance_count_tier(vp, "cuda", 0) == "global"
    for front in (f, torch.zeros_like(f), torch.ones_like(f)):
        want = kernels.advance_count_plain(front, *args)
        for cap in (None, 0):             # the shared and the global tier
            assert torch.equal(kernels.advance_count(front, *args, cap), want)
    assert all(kernels.launches[k] > 0 for k in (
        "scan", "gather_payloads", "segment_reduce", "advance_count"))
    s = int(np.argmax(np.diff(csr.row_offsets)))
    r = bfs.run(g, s, variant="adaptive", warmup=False)
    assert np.array_equal(r.distances.cpu().numpy(),
                          bfs.cpu_reference(csr, s))
    d = sssp.run(g, s, variant="adaptive", warmup=False).distances
    ref = sssp.cpu_reference(csr, s)
    reach = np.isfinite(ref)
    d = d.cpu().numpy()
    assert np.array_equal(np.isfinite(d), reach)
    assert np.allclose(d[reach], ref[reach], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_tc_and_fill_kernels_match_plain_versions_on_the_card():
    """bitmap_intersect_counts, segment_broadcast_total, suffix_fill_update
    and fused_route_or against their plain versions at rmat12 (the bitmap
    kernel also on unsorted pairs with a hub u and pads), exactly and
    bitwise on a second launch, then the main paths that run them; the
    fills, the route OR and the collapses of segment starts on chip_smoke's
    stress shapes (check_fill_shapes, check_starts_shapes), one device
    launch a call of each fill and of the route OR."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import pr, tc
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    from essentials_tpu_torch.ops import bitmap_intersect as bi
    from essentials_tpu_torch.ops import fused_bfs as FB

    csr = Csr.from_coo(generate.rmat(12, 16, seed=1, weighted=False))
    g = build_graph(csr, directed=False, weighted=False, device="cuda")
    kernels.reset_launches()
    _, es, ec = tc._oriented_csr(csr)
    bitmap = torch.from_numpy(bi.pack_bitmap_rows(csr.n_rows, es,
                                                  ec)).cuda()
    eu = torch.from_numpy(es.astype(np.int32)).cuda()
    ev = torch.from_numpy(ec.astype(np.int32)).cuda()
    # TC's oriented edges (sorted by u), then unsorted pairs with a hub u
    # whose every word is non-zero, and pads among them
    hub = [torch.from_numpy(a).cuda()
           for a in _chip_smoke().hub_pairs_inputs()]
    for args in ((eu, ev, bitmap), hub):
        for witness in (True, False):
            k = kernels.bitmap_intersect_counts(*args, witness)
            again = kernels.bitmap_intersect_counts(*args, witness)
            p = kernels.bitmap_intersect_counts_plain(*args, witness)
            for a, b, c in zip(k, again, p):
                assert (a is None and c is None) or (torch.equal(a, b)
                                                     and torch.equal(a, c))
            assert int(k[0].sum()) > 0
    flags = g.csc_seg_flags
    s_i = kernels.scan(torch.ones(g.n_edges_padded, dtype=torch.int32,
                                  device="cuda"), flags, "add")
    for s in (s_i, s_i.float() / 3):
        k = FB.segment_broadcast_total(s, flags)
        assert torch.equal(k, FB.segment_broadcast_total(s, flags))
        assert torch.equal(k, kernels.segment_broadcast_total_plain(s, flags))
    src = int(np.argmax(np.diff(csr.row_offsets)))
    lev = FB.init_lev_exp(g, src)
    off = g.row_offsets
    full = torch.repeat_interleave(
        lev[off[:-1].clamp(max=g.n_edges_padded - 1).long()],
        (off[1:] - off[:-1]).long())
    for it in range(64):
        cnt = kernels.bfs_level(lev, off, g.csc_src_indices, g.col_indices,
                                it, FB.UNREACHED)
        z = FB.fused_route_or(g, full, it)
        assert torch.equal(z, FB.fused_route_or(g, full, it))
        assert torch.equal(z, kernels.fused_route_or_plain(
            full, g.csc_edge_ids, flags, it))
        s = kernels.scan(z, flags, "add")
        new, any_ = FB.suffix_fill_update(s, flags, full, it + 1)
        new_p, any_p = kernels.suffix_fill_update_plain(s, flags, full, it + 1)
        assert torch.equal(new, new_p) and torch.equal(any_, any_p)
        full = new
        assert torch.equal(full[off[:-1][off[1:] > off[:-1]].long()],
                           lev[off[:-1][off[1:] > off[:-1]].long()])
        assert int(any_) == int(cnt > 0)
        if int(cnt) == 0:
            break
    assert all(kernels.launches[n] > 0 for n in (
        "bitmap_intersect_counts", "segment_broadcast_total",
        "suffix_fill_update", "fused_route_or"))
    # the fills and the route OR at 1 to 45 fill tiles and 300 scan tiles
    # under four flag sets (sparse, at every position, only at 0, one
    # segment across 42 tiles) and four level sets, bit for bit against
    # plain, one launch a call; the collapses (collapse_levels int32 and
    # int8 too) on the starts cases
    errs = dict.fromkeys(("segment_broadcast_total", "suffix_fill_update",
                          "fused_route_or", "expand_segments",
                          "collapse_starts", "collapse_levels<int32>",
                          "collapse_levels<int8>"), 0)
    _chip_smoke().check_fill_shapes(errs)
    _chip_smoke().check_starts_shapes(errs)
    assert set(errs.values()) == {0}
    total, vt = tc.cpu_reference(csr)
    for variant in tc.VARIANTS:
        r = tc.run(csr, variant=variant, warmup=False)
        assert r.total == total
        if variant != "shift":
            assert np.array_equal(r.vertex_triangles.cpu().numpy(), vt)
    ranks = pr.run(g, variant="fused", warmup=False).ranks.cpu().numpy()
    assert np.allclose(ranks, pr.cpu_reference(csr), rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_color_kernel_matches_plain_version_on_the_card():
    """segment_minmax against its plain version exactly and against a
    second launch bitwise, for 1, 3, 8 and 11 payloads under full, seeded
    and JP-uncolored masks at rmat12, and on chip_smoke's stress case (a
    segment across 43 tiles, ends at every offset of a tile, a run of
    empty segments, all-inactive segments, offsets from 37, views at odd
    element offsets); then both color variants on the card equal to a run
    on a CPU copy of the graph, bitwise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import color
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    from essentials_tpu_torch.ops.advance import _expand_and_route

    csr = Csr.from_coo(generate.rmat(12, 16, seed=1, weighted=False))
    g = build_graph(csr, directed=False, weighted=False, device="cuda")
    rng = np.random.default_rng(0)
    ep = g.n_edges_padded
    pays = [torch.from_numpy(rng.integers(-2**31, 2**31, ep).astype(
        np.int32)).cuda() for _ in range(11)]
    state = color.step(g, color.init(g), 0)
    uncolored, _ = _expand_and_route(g, state.frontier, "vertices", ())
    masks = (g.edge_mask(), torch.from_numpy(rng.random(ep) < 0.3).cuda(),
             uncolored)
    kernels.reset_launches()
    for active in masks:
        for m in (1, 3, 8, 11):
            args = (pays[:m], active, g.csc_offsets)
            k, again = kernels.segment_minmax(*args), \
                kernels.segment_minmax(*args)
            p = kernels.segment_minmax_plain(*args)
            for a, b, c in zip(k, again, p):
                assert torch.equal(a, b) and torch.equal(a, c)
    assert kernels.launches["segment_minmax"] == 2 * 3 * (1 + 1 + 1 + 2)
    assert kernels.pass_launches["segment_split"] == \
        kernels.launches["segment_minmax"]
    pays, active, off = _chip_smoke().minmax_stress_inputs("cuda", m=11)
    assert int(off[0]) == 37 and pays[0].data_ptr() % 16 != 0
    for m in (1, 3, 8, 11):
        args = (pays[:m], active, off)
        k, again = kernels.segment_minmax(*args), \
            kernels.segment_minmax(*args)
        p = kernels.segment_minmax_plain(*args)
        for a, b, c in zip(k, again, p):
            assert torch.equal(a, b) and torch.equal(a, c)
    g_cpu = g.to("cpu")
    for variant in color.VARIANTS:
        r = color.run(g, variant=variant, warmup=False)
        r_cpu = color.run(g_cpu, variant=variant, warmup=False)
        assert r.iterations == r_cpu.iterations
        assert torch.equal(r.colors.cpu(), r_cpu.colors)
        assert color.validate(csr, r.colors.cpu().numpy()) == 0


@pytest.mark.cuda
def test_bitmap_kernel_at_12288_word_rows_on_the_card():
    """A bitmap of 12,288-word (48 KiB) rows, whose non-zero words the
    kernel lists in many passes: one launch with and one without the
    witness, each equal to the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    rng = np.random.default_rng(1)
    rows, words = 65, 12288
    bits = rng.random((rows, words * 32)) < 0.01
    bitmap = np.packbits(bits, axis=1, bitorder="little").view(np.int32)
    bitmap[-1] = 0
    eu = np.sort(rng.integers(0, rows, 500)).astype(np.int32)
    ev = rng.integers(0, rows, 500).astype(np.int32)
    args = [torch.from_numpy(a).cuda() for a in (eu, ev, bitmap)]
    for witness in (True, False):
        k = kernels.bitmap_intersect_counts(*args, witness)
        p = kernels.bitmap_intersect_counts_plain(*args, witness)
        assert torch.equal(k[0], p[0])
        assert (k[1] is None and p[1] is None) or torch.equal(k[1], p[1])
        assert int(k[0].sum()) > 0


@pytest.mark.cuda
def test_variants_and_bc_ppr_on_the_card():
    """BFS hybrid and phased (the spray forced on and off), k-core adaptive
    on a directed graph (every branch, the spray gate opened), BC spmv and
    generic, run_all and PPR run and run_batch on the card: BFS and k-core
    exactly equal to the host and to a run on a CPU copy of the graph, BC
    and PPR within chip_smoke's bc_bound and ppr_bound of the float64 host
    (benchmarks/PARITY.md's bounds plus the float32 rounding of the
    result), each path's kernels launched."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import bc, bfs, kcore, ppr
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate

    csr = Csr.from_coo(generate.rmat(12, 16, seed=1, weighted=False))
    g = build_graph(csr, directed=False, weighted=False, device="cuda")
    gc = g.to("cpu")
    s = int(np.argmax(np.diff(csr.row_offsets)))
    ref = bfs.cpu_reference(csr, s)
    cs = _chip_smoke()
    for variant in ("hybrid", "phased"):
        for min_edges in (0, 1 << 62):         # the spray on, then off
            with cs.spray_gate(min_edges):
                kernels.reset_launches()
                r = bfs.run(g, s, variant=variant, warmup=False)
                rc = bfs.run(gc, s, variant=variant, warmup=False)
            assert np.array_equal(r.distances.cpu().numpy(), ref)
            assert (r.modes.spray > 0) == (min_edges == 0)
            assert torch.equal(r.predecessors.cpu(), rc.predecessors)
            assert r.modes == rc.modes and r.iterations == rc.iterations
            assert kernels.launches["bfs_predecessors"] == 1
            assert kernels.launches["bfs_level<int32>"] == r.modes.dense
            assert kernels.launches["scan"] == \
                2 * r.modes.spray + r.modes.compactions
    cd = Csr.from_coo(generate.rmat(13, 16, seed=2, undirected=False,
                                    weighted=True))
    gd = build_graph(cd, directed=True, weighted=True, device="cuda")
    with cs.spray_gate(0):
        kernels.reset_launches()
        rk = kcore.run(gd, warmup=False)
        rkc = kcore.run(gd.to("cpu"), warmup=False)
    assert np.array_equal(rk.core.cpu().numpy(), kcore.cpu_reference(cd))
    assert rk.tiers == rkc.tiers and rk.iterations == rkc.iterations
    assert kernels.launches["advance_count"] == rk.tiers[3]
    for variant, gb in (("spmv", g), ("generic", gd)):
        cb = csr if gb is g else cd
        rb = bc.run(gb, s, variant=variant, warmup=False)
        assert cs.bc_rel_err(rb.bc_values, bc.cpu_reference(
            cb, [s], normalize_undirected=False)) <= cs.bc_bound()
    sources = np.argsort(-np.diff(csr.row_offsets))[:8]
    assert cs.bc_rel_err(bc.run_all(g, sources=sources).bc_values,
                         bc.cpu_reference(csr, sources)) \
        <= cs.bc_bound(len(sources))
    for seed, row in zip(sources[:3], ppr.run_batch(g, sources[:3]).cpu()):
        ref = ppr.cpu_reference(csr, int(seed))
        it = ppr.run(g, int(seed), warmup=False).iterations
        assert np.abs(row.numpy() - ref).max() <= cs.ppr_bound(it, ref)


@pytest.mark.cuda
def test_mst_geo_spgemm_on_the_card():
    """MST on weighted rmat12 (in_mst and rounds equal to a run on a CPU
    copy, a spanning forest whose weights sum in float64 to the host
    forest's and whose float32 total is within chip_smoke's mst_bound of
    it), geo and spatial_median (chip_smoke's hold_geo and hold_median
    against the float64 host), SpGEMM static and chunked, resident and streamed, on
    uniform_4096 with chunks that split rows (structure equal to the host
    Gustavson's, values within rtol 1e-5 of float64), each path's
    launches exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import geo, mst, spgemm
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate, load_graph_file

    cs = _chip_smoke()
    csr = Csr.from_coo(generate.rmat(12, 16, seed=1, weighted=True))
    g = build_graph(csr, directed=False, weighted=True, device="cuda")
    kernels.reset_launches()
    r = mst.run(g, warmup=False)
    assert {k: v for k, v in kernels.launches.items() if v} == \
        cs.mst_launches(r)
    rc = mst.run(g.to("cpu"), warmup=False)
    assert torch.equal(r.in_mst.cpu(), rc.in_mst)
    assert r.iterations == rc.iterations
    chosen, c_graph, c_tree = mst.forest_check(csr, r.in_mst.cpu().numpy())
    assert chosen == csr.n_rows - c_graph and c_tree == c_graph
    host = mst.cpu_reference(csr)
    chosen_w = np.asarray(csr.values, np.float64)[r.in_mst.cpu().numpy()]
    assert abs(chosen_w.sum() - host) <= cs.MST_FOREST_RTOL * host
    assert abs(r.total_weight - host) <= cs.mst_bound(chosen, host)

    lat, lon = cs.geo_inputs(csr.n_rows)
    rg = geo.run(g, lat, lon, warmup=False)
    cs.hold_geo("geo", rg.lat.cpu(), rg.lon.cpu(),
                geo.cpu_reference(csr, lat, lon, error_bound=True))
    s = geo.init(g, rg.lat, rg.lon)
    n = csr.n_rows
    start = (s.lat[:n].cpu().numpy(), s.lon[:n].cpu().numpy())
    m = geo.spatial_median(g, s.lat, s.lon, iterations=1)
    cs.hold_median("spatial_median", csr, start,
                   (m[0][:n].cpu().numpy(), m[1][:n].cpu().numpy()),
                   geo.spatial_median_reference(csr, *start, 1), 1)

    a = load_graph_file(str(ROOT / "datasets" / "uniform_4096.mtx"),
                        cache=False)
    ref = spgemm.cpu_reference(a, a)
    kernels.reset_launches()
    c = spgemm.run(a, a, warmup=False).c
    assert {k: v for k, v in kernels.launches.items() if v} == \
        {"gather_payloads": 2, "segment_reduce": 1}
    plan = spgemm.make_chunked_plan(a, a, chunk_products=1 << 16,
                                    chunk_edges=24)
    assert plan.merge_spans.shape[0] > 0
    results = [c]
    for stream in (False, True):
        kernels.reset_launches()
        vals = spgemm.numeric_chunked(plan, a, a, stream_to_host=stream)
        assert {k: v for k, v in kernels.launches.items() if v} == \
            cs.chunked_launches(plan)
        results.append(Csr(a.n_rows, a.n_cols, plan.c_row_offsets,
                           plan.c_col_indices, vals))
    for c in results:
        assert np.array_equal(c.row_offsets, ref.row_offsets)
        assert np.array_equal(c.col_indices, ref.col_indices)
        assert np.allclose(c.values, ref.values, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_harness_modules_on_the_card(tmp_path):
    """chip_smoke's phase 32 checks (harness_checks) at weighted rmat12 and
    rmat10 and four datasets: the native parser against NumPy's,
    offsets_to_indices against its plain version (one expand_segments
    launch), advance_edges (three gather_payloads launches), filter,
    for_each and uniquify against a CPU copy, the analytics against NumPy
    and a trace of one fused BFS holding a bfs_level kernel event; then the
    CLI on the card (bfs and geo on chesapeake, validated, backend cuda)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cs = _chip_smoke()
    csr_o, g_o = cs.weighted_graph(12, "cuda")
    csr_ops, g_ops = cs.weighted_graph(10, "cuda")
    paths = cs.harness_checks(csr_o, g_o, csr_ops, g_ops, "rmat12",
                              "rmat10", str(tmp_path),
                              ("chesapeake", "kron_s12", "road_64x64",
                               "uniform_4096"))
    assert paths["advance_edges"]["gather_payloads"] == 3
    for algo in ("bfs", "geo"):
        rc, stats, out, launches = cs.cli_call(
            [algo, "datasets/chesapeake.mtx", "--validate", "--json",
             "--runs", "1", "--no-cache"])
        assert rc == 0 and stats["backend"] == "cuda", out
        assert any(launches.values())


@pytest.mark.cuda
def test_parallel_layer_on_the_card():
    """chip_smoke's phase 34 checks (parallel_main_path) at weighted rmat12
    on a one-rank NCCL group: in both exchange modes, with and without
    overlap, dist_bfs equal to cpu_reference and the fused BFS, dist_sssp
    within rtol 1e-5 of a float64 Dijkstra (the reach set exact) and bit
    for bit equal across the four runs, dist_pagerank within rtol 1e-4 /
    atol 1e-4 / V of the float64 host and summing to 1 within 1e-5 (a
    planted route swap refused by that check), each run
    launching expand_segments, gather_payloads and segment_reduce once a
    superstep (gather_payloads once more where SSSP moves its weights)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as tdist
    cs = _chip_smoke()
    csr, g = cs.weighted_graph(12, "cuda")
    try:
        by_path, steps, _, _, _ = cs.parallel_main_path(csr, g, "rmat12")
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    assert len(by_path) == 12
    assert all(steps[p] == by_path[p]["segment_reduce"] > 0 for p in steps)
