"""Port parity: essentials_tpu_torch's SSSP (ops.fused_sssp, ops.windowed_sssp,
algorithms.sssp and the kernel wrappers' plain versions) against
essentials_tpu's, on the CPU.

Both packages compute every distance as one float32 addition per edge and
take exact minima of the results, so distances are compared bitwise and
sweep counts exactly; predecessors and launch counts are integers. Sweeps
are compared at segment starts: the port writes only starts, the JAX CPU
fallback whole segments. Against the float64 host Dijkstra, distances are
held to rtol 1e-5 (the float32 rounding of a path of a few dozen edges) and
the reach set exactly. The JAX graphs are built with router plans and
carried into the port with graph_from_arrays, so both packages compute on
the same arrays."""

import jax
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import sssp as jsssp
from essentials_tpu.formats import Coo as JCoo
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.ops import cube_router
from essentials_tpu.ops import fused_sssp as jfs
from essentials_tpu.ops import windowed_spmv as jws
from essentials_tpu.ops import windowed_sssp as jwss

from essentials_tpu_torch import kernels
from essentials_tpu_torch.algorithms import sssp as tsssp
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.formats import Coo, Csr
from essentials_tpu_torch.graph import build_graph, graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import fused_sssp as tfs
from essentials_tpu_torch.ops import windowed_sssp as twss
from essentials_tpu_torch.ops.fused_spmv import edge_weights

RTOL = 1e-5
_jax_sweep = jax.jit(jfs.fused_sssp_superstep_ref)
_jax_run = jax.jit(jfs.run_fused_sssp, static_argnums=(2,))
_jax_pred = jax.jit(jsssp.predecessors_from_distances)


def carried(csr, directed=False):
    """The JAX graph (with router plans) and the port's graph made from its
    fields."""
    gj = jbuild(csr, directed=directed, weighted=True, build_router=True)
    fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return csr, gj, graph_from_arrays(fields, meta, "cpu")


def isolated_coo():
    """12 vertices; 0, 5 and 9 have no edges; two components."""
    pairs = [(1, 2, 2.5), (2, 3, 1.0), (1, 3, 4.0), (3, 4, 0.5), (6, 7, 3.0),
             (7, 8, 1.5), (8, 10, 2.0), (10, 11, 1.0), (6, 11, 9.0)]
    a, b, w = (np.array(x) for x in zip(*pairs))
    return JCoo(12, 12, np.concatenate([a, b]).astype(np.int32),
                np.concatenate([b, a]).astype(np.int32),
                np.concatenate([w, w]).astype(np.float32))


def clique_tail_coo():
    """The 4-clique with a pendant path of tests/test_algorithms.py."""
    edges = [(a, b) for a in range(4) for b in range(4) if a != b]
    edges += [(3, 4), (4, 3), (4, 5), (5, 4)]
    src = np.array([e[0] for e in edges], np.int32)
    dst = np.array([e[1] for e in edges], np.int32)
    return JCoo(6, 6, src, dst, np.ones(len(edges), np.float32))


def cycles_coo(n: int, lengths, seed: int):
    """chip_smoke.cycles_coo as a JAX Coo: a union of directed cycles over
    random vertices of n, one per length, with seeded weights; every
    in-degree equals its out-degree (a symmetric layout), but the edges are
    not symmetric."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    n, src, dst, w = mod.cycles_coo(n, lengths, seed)
    return JCoo(n, n, src, dst, w)


CYCLES300 = (300, 300, 220, 150, 90, 40)    # degrees 2-6


@pytest.fixture(scope="module")
def graphs():
    return {
        "rmat10": carried(JCsr.from_coo(jgen.rmat(10, 16, seed=4,
                                                  undirected=True,
                                                  weighted=True))),
        "grid16": carried(JCsr.from_coo(jgen.grid_2d(16, weighted=True))),
        "isolated": carried(JCsr.from_coo(isolated_coo())),
        "clique_tail": carried(JCsr.from_coo(clique_tail_coo())),
        # degree-balanced directed graphs: a sweep that pushed along the
        # CSC sources instead of the CSR columns would go wrong here
        "cycle5": carried(JCsr.from_coo(JCoo(5, 5, *directed_cycle_edges())),
                          directed=True),
        "cycles300": carried(JCsr.from_coo(cycles_coo(300, CYCLES300, 8)),
                             directed=True),
    }


SOURCES = {"rmat10": (0, 37), "grid16": (3, 200), "isolated": (1, 0),
           "clique_tail": (5, 0)}
NAMES = sorted(SOURCES)
DIRECTED_SOURCES = {"cycle5": (0, 3), "cycles300": (0, 171)}
SWEEP_NAMES = NAMES + sorted(DIRECTED_SOURCES)


def starts_of(g):
    off = g.row_offsets.numpy()
    return off[:-1][off[1:] > off[:-1]]


def bits(t) -> np.ndarray:
    return np.asarray(t).view(np.int32)


@pytest.mark.parametrize("name", SWEEP_NAMES)
def test_sweeps_match_jax_fallback(graphs, name):
    """Every sweep of a search, bits at the starts and count, against the
    JAX fallback's full relaxation: the port relaxes only the edges out of
    the vertices that changed in the sweep before."""
    _, gj, g = graphs[name]
    source = {**SOURCES, **DIRECTED_SOURCES}[name][0]
    starts = starts_of(g)
    dj = jfs.init_dist_exp(gj, source)
    d = tfs.init_dist_exp(g, source)
    assert np.array_equal(d.numpy(), np.asarray(dj))
    spare = tfs.init_spare(g)
    for it in range(g.n_vertices + 1):
        dj, cnt_j = _jax_sweep(gj, dj)
        cnt = tfs.fused_sssp_superstep(g, d, spare)
        d, spare = spare, d
        assert cnt.dtype == torch.int32 and cnt.shape == (1,)
        assert int(cnt) == int(cnt_j[0, 0]), it
        assert np.array_equal(d.numpy()[starts], np.asarray(dj)[starts]), it
        if int(cnt) == 0:
            break
    assert int(cnt) == 0 and it > 1


def test_sweep_matches_pallas_pipeline(graphs):
    """One sweep against the three Pallas kernels, run in interpret mode
    off the TPU, from a state two fallback sweeps into the search."""
    _, gj, g = graphs["rmat10"]
    assert isinstance(gj.route_fwd, cube_router.CubePlan)
    dj = jfs.init_dist_exp(gj, 0)
    for _ in range(2):
        prev, dj = dj, _jax_sweep(gj, dj)[0]
    out_j, cnt_j = jfs.fused_sssp_superstep(gj, dj)
    d = torch.from_numpy(np.array(dj))
    spare = torch.from_numpy(np.array(prev))    # the sweep before d's
    cnt = tfs.fused_sssp_superstep(g, d, spare)
    starts = starts_of(g)
    assert int(cnt) == int(cnt_j[0, 0]) > 0
    assert np.array_equal(spare.numpy()[starts], np.asarray(out_j)[starts])


@pytest.mark.parametrize("variant", ["fused", "windowed", "auto"])
@pytest.mark.parametrize("name", NAMES)
def test_run_matches_jax_fused(graphs, name, variant):
    _, gj, g = graphs[name]
    v = g.n_vertices
    for source in SOURCES[name]:
        r = tsssp.run(g, source, variant=variant, warmup=False)
        assert r.distances.dtype == torch.float32
        assert r.distances.shape == r.predecessors.shape == (v,)
        d_j, it_j = _jax_run(gj, source, g.n_vertices + 1)
        assert np.array_equal(bits(r.distances), bits(d_j)[:v]), source
        assert r.iterations == int(it_j), source


@pytest.mark.parametrize("variant", ["fused", "auto"])
@pytest.mark.parametrize("name", sorted(DIRECTED_SOURCES))
def test_degree_balanced_directed_run_matches_jax_fused(graphs, name,
                                                        variant):
    """A directed graph with a symmetric layout runs fused (auto's choice):
    distances bitwise and sweeps equal to JAX's run_fused_sssp, and within
    rtol 1e-5 of the host Dijkstra with the reach set exact."""
    csr, gj, g = graphs[name]
    assert g.symmetric_layout and g.properties.directed
    assert not torch.equal(g.col_indices, g.csc_src_indices)
    v = g.n_vertices
    for source in DIRECTED_SOURCES[name]:
        r = tsssp.run(g, source, variant=variant, warmup=False)
        d_j, it_j = _jax_run(gj, source, g.n_vertices + 1)
        assert np.array_equal(bits(r.distances), bits(d_j)[:v]), source
        assert r.iterations == int(it_j) > 1, source
        ref = jsssp.cpu_reference(csr, source)
        reach = np.isfinite(ref)
        d = r.distances.numpy()
        assert np.array_equal(np.isfinite(d), reach), source
        np.testing.assert_allclose(d[reach], ref[reach], rtol=RTOL, atol=0)


def test_auto_picks_fused_where_supported(graphs, monkeypatch):
    calls = []
    for v, search in tsssp.VARIANTS.items():
        monkeypatch.setitem(tsssp.VARIANTS, v, lambda *a, v=v, f=search: (
            calls.append(v), f(*a))[1])
    tsssp.run(graphs["grid16"][2], 0, warmup=False)
    tsssp.run(directed_cycle()[1], 0, warmup=False)
    assert calls == ["fused", "fused"]


@pytest.mark.parametrize("name", NAMES)
def test_auto_fused_and_windowed_agree(graphs, name):
    """auto, fused and windowed: the same distance bits, predecessors and
    sweeps from every source."""
    g = graphs[name][2]
    for source in SOURCES[name]:
        auto, *others = (tsssp.run(g, source, variant=v, warmup=False)
                         for v in ("auto", "fused", "windowed"))
        for r in others:
            assert np.array_equal(bits(r.distances), bits(auto.distances))
            assert torch.equal(r.predecessors, auto.predecessors), source
            assert r.iterations == auto.iterations, source


def changed_row_slots(g, source: int) -> tuple:
    """(Sweeps, the sum over sweeps of the CSR row lengths of the vertices
    whose distance changed in the sweep before), from float32 Jacobi
    Bellman-Ford sweeps in numpy over the graph's CSR arrays."""
    v = g.n_vertices
    off = g.row_offsets.numpy()[:v + 1]
    lengths = np.diff(off)
    rows = np.repeat(np.arange(v), lengths)
    col = g.col_indices.numpy()[:off[-1]]
    w = edge_weights(g).numpy()[:off[-1]]
    prev = np.full(v, np.inf, np.float32)
    d = prev.copy()
    d[source] = 0
    sweeps, slots = 0, 0
    while True:
        slots += int(lengths[d != prev].sum())
        new = d.copy()
        np.minimum.at(new, col, d[rows] + w)
        prev, d, sweeps = d, new, sweeps + 1
        if np.array_equal(prev, d):
            return sweeps, slots


@pytest.mark.parametrize("name", ["grid16", "rmat10"])
def test_fused_counts_the_changed_rows_slots(graphs, name):
    """sssp.push_slots over a fused search (the plain route) is the sum
    over its sweeps of the changed vertices' row lengths."""
    g = graphs[name][2]
    for source in SOURCES[name]:
        kernels.reset_launches()
        r = tsssp.run(g, source, variant="fused", warmup=False)
        sweeps, slots = changed_row_slots(g, source)
        assert r.iterations == sweeps > 2, source
        assert kernels.counters["sssp.push_slots"] == slots, source
        assert 0 < slots < sweeps * g.n_edges, source


def test_windowed_counts_every_slot_each_sweep(graphs):
    g = graphs["rmat10"][2]
    kernels.reset_launches()
    r = tsssp.run(g, 0, variant="windowed", warmup=False)
    assert r.iterations > 2
    assert kernels.counters["sssp.push_slots"] == r.iterations * g.n_edges


@pytest.mark.parametrize("name", NAMES)
def test_predecessors_match_jax(graphs, name):
    _, gj, g = graphs[name]
    for source in SOURCES[name]:
        d_j, _ = _jax_run(gj, source, g.n_vertices + 1)
        pred = tsssp.predecessors_from_distances(
            g, torch.from_numpy(np.array(d_j)))
        assert np.array_equal(pred.numpy(), np.asarray(_jax_pred(gj, d_j)))
        r = tsssp.run(g, source, warmup=False)
        assert np.array_equal(r.predecessors.numpy(),
                              pred.numpy()[:g.n_vertices])


@pytest.mark.parametrize("name", NAMES)
def test_run_matches_cpu_reference(graphs, name):
    csr, _, g = graphs[name]
    for source in SOURCES[name]:
        ref = jsssp.cpu_reference(csr, source)
        assert np.array_equal(tsssp.cpu_reference(csr, source), ref)
        d = tsssp.run(g, source, warmup=False).distances.numpy()
        reach = np.isfinite(ref)
        assert np.array_equal(np.isfinite(d), reach), source
        np.testing.assert_allclose(d[reach], ref[reach], rtol=RTOL, atol=0)
        assert d[source] == 0


@pytest.mark.parametrize("seed", [4, 7])
def test_windowed_matches_jax_windowed_ref(seed):
    """Against the JAX windowed sweeps (their stage-exact reference) from
    the highest-degree vertex, on graphs where that reference's output fits
    its state (vp <= n_rseg + SLAB; ROADMAP queue 3)."""
    csr, gj, g = carried(JCsr.from_coo(jgen.rmat(12, 8, seed=seed,
                                                 undirected=True,
                                                 weighted=True)))
    source = int(np.argmax(np.diff(csr.row_offsets)))
    plan = jws.build_windowed_plan(gj)
    assert plan is not None and plan.vp <= plan.n_rseg + jws.SLAB
    d_j, it_j = jwss.run_windowed_sssp(gj, plan, source, g.n_vertices + 1,
                                       use_pallas=False)
    d, it = twss.run_windowed_sssp(g, source, g.n_vertices + 1)
    v = g.n_vertices
    assert it == int(it_j) > 2
    assert np.array_equal(bits(d)[:v], bits(d_j)[:v])
    d_f, it_f = tfs.run_fused_sssp(g, source, g.n_vertices + 1)
    assert it_f == it and np.array_equal(bits(d_f), bits(d))


def test_carried_weighted_graph_gives_jax_sssp():
    """A JAX-built weighted graph carried over (graph_from_arrays) and the
    port's own build of the same edges give JAX's SSSP, bit for bit."""
    coo = jgen.rmat(10, 8, seed=9, undirected=True, weighted=True)
    csr, gj, g = carried(JCsr.from_coo(coo))
    own = build_graph(Csr.from_coo(Coo(coo.n_rows, coo.n_cols, coo.row_indices,
                                       coo.col_indices, coo.values)),
                      directed=False, weighted=True, device="cpu")
    assert torch.equal(own.csc_values, g.csc_values)
    rj = jsssp.run(gj, 1, warmup=False, variant="fused")
    for graph in (g, own):
        r = tsssp.run(graph, 1, warmup=False)
        assert np.array_equal(bits(r.distances), bits(rj.distances))
        assert np.array_equal(r.predecessors.numpy(),
                              np.asarray(rj.predecessors))
        assert r.iterations == rj.iterations


# -------------------------------------------------------------- refusals --

def directed_cycle_edges():
    """(src, dst, weights) of the directed 5-cycle i -> i + 1 with weight
    i + 1."""
    n = 5
    return (np.arange(n, dtype=np.int32),
            ((np.arange(n) + 1) % n).astype(np.int32),
            np.arange(1, n + 1, dtype=np.float32))


def directed_cycle():
    """A directed 5-cycle: in-degree == out-degree, so its layout is
    symmetric, but its edges are not."""
    csr = Csr.from_coo(Coo(5, 5, *directed_cycle_edges()))
    return csr, build_graph(csr, directed=True, weighted=True, device="cpu")


def test_unported_and_unsupported_runs_raise(graphs):
    """adaptive, once unported, runs (and equals fused); unknown variants,
    bad sources and the sweep engines on a graph without a symmetric layout
    raise."""
    csr, _, g = graphs["grid16"]
    a = tsssp.run(g, 0, variant="adaptive", warmup=False)
    f = tsssp.run(g, 0, variant="fused", warmup=False)
    assert np.array_equal(bits(a.distances), bits(f.distances))
    assert torch.equal(a.predecessors, f.predecessors)
    with pytest.raises(EssentialsError):
        tsssp.run(g, 0, variant="delta")
    with pytest.raises(EssentialsError):
        tsssp.run(g, g.n_vertices)
    coo = jgen.rmat(8, 8, seed=2, undirected=False, weighted=True)
    gd = carried(JCsr.from_coo(coo), directed=True)[2]
    assert not gd.symmetric_layout
    for variant in ("fused", "windowed"):
        with pytest.raises(EssentialsError, match="symmetric layout"):
            tsssp.run(gd, 0, variant=variant)
    dj = JCsr.from_coo(coo)
    for variant in ("adaptive", "auto"):
        d = tsssp.run(gd, 0, variant=variant).distances.numpy()
        ref = tsssp.cpu_reference(dj, 0)
        assert np.array_equal(np.isfinite(d), np.isfinite(ref))


def test_directed_symmetric_layout_runs_fused_only():
    csr, g = directed_cycle()
    assert g.symmetric_layout and g.properties.directed
    assert tsssp.fused_supported(g) and not tsssp.windowed_supported(g)
    with pytest.raises(EssentialsError, match="undirected"):
        tsssp.run(g, 0, variant="windowed")
    r = tsssp.run(g, 0, warmup=False)
    assert np.array_equal(r.distances.numpy(), tsssp.cpu_reference(csr, 0))
    assert r.predecessors.tolist() == [-1, 0, 1, 2, 3]


# -------------------------------------------------------------- wrappers --

def test_wrappers_take_plain_version_on_cpu(graphs):
    _, _, g = graphs["grid16"]
    kernels.reset_launches()
    d = tfs.init_dist_exp(g, 0)
    out = tfs.init_spare(g)
    ref = tfs.init_spare(g)
    w = edge_weights(g)
    cnt = kernels.sssp_sweep(d, out, g.row_offsets, g.col_indices, w)
    cnt_p = kernels.sssp_sweep_plain(d, ref, g.row_offsets, g.col_indices,
                                     w)
    assert torch.equal(out, ref) and torch.equal(cnt, cnt_p)
    assert int(cnt) == 2                      # the source's two neighbours
    dist = tfs.collapse_dist_exp(g, out, 0)
    tsssp.predecessors_from_distances(g, dist)
    twss.sweep(g, dist.view(torch.int32))
    assert all(n == 0 for n in kernels.launches.values())


@pytest.mark.parametrize("call", ["sweep", "pred", "collapse"])
def test_wrappers_raise_on_other_devices(graphs, call):
    g = graphs["clique_tail"][2].to("meta")
    d = torch.empty(g.n_edges_padded, dtype=torch.int32, device="meta")
    w = torch.empty(g.n_edges_padded, device="meta")
    with pytest.raises(EssentialsError):
        if call == "sweep":
            kernels.sssp_sweep(d, d.clone(), g.row_offsets, g.col_indices,
                               w)
        elif call == "pred":
            kernels.sssp_predecessors(
                torch.empty(g.n_vertices_padded, device="meta"),
                g.csc_offsets, g.csc_src_indices, w, g.n_edges)
        else:
            kernels.collapse_starts(d, g.row_offsets, tfs.INF_BITS, 0)


def test_wrappers_reject_bad_arguments(graphs):
    _, _, g = graphs["clique_tail"]
    off, src, col = g.row_offsets, g.csc_src_indices, g.col_indices
    d = tfs.init_dist_exp(g, 0)
    w = edge_weights(g)
    wc = tfs.csc_weights(g)
    dist = torch.zeros(g.n_vertices_padded)
    bad = [
        lambda: kernels.sssp_sweep(d, d, off, col, w),          # in place
        lambda: kernels.sssp_sweep(d, d[1:], off, col, w),      # short out
        lambda: kernels.sssp_sweep(d, d.clone(), off, col, w.double()),
        lambda: kernels.sssp_sweep(d.float(), d.clone(), off, col, w),
        lambda: kernels.sssp_sweep(d, d.clone(), off, col.long(), w),
        lambda: kernels.sssp_predecessors(dist.double(), off, src, wc, 1),
        lambda: kernels.sssp_predecessors(dist, off, src, wc,
                                          g.n_edges_padded + 1),
        lambda: kernels.collapse_starts(d, off, tfs.INF_BITS,
                                        g.n_vertices_padded),
        lambda: kernels.collapse_starts(d.long(), off, tfs.INF_BITS, 0),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(EssentialsError):
            call()
            pytest.fail(f"case {i} did not raise")
