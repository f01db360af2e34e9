"""Port parity: essentials_tpu_torch's BFS ``hybrid`` and ``phased``
(run_hybrid_levels, run_phased_levels) and the timed ``auto`` against
essentials_tpu's, on the CPU.

The JAX level functions are jitted once per (graph, max_it,
spray_override) and called with each source. Both packages run on the same
arrays (the JAX graph with router plans, carried into the port with
graph_from_arrays). Distances and level counts are integers: the tolerance
is exact equality. At test sizes (E < 2^21) the spray is on only where
spray_override forces it. kron_s12's largest frontiers outgrow
HYBRID_BUDGET; every handover between spray and dense levels (hybrid's
dense -> spray transition, phased's B -> C handoff and its phase D) fires
with HYBRID_BUDGET and HYBRID_K patched small in both packages."""

import os

import jax
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import bfs as jbfs
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen, load_graph_file as jload

from essentials_tpu_torch.algorithms import bfs as tbfs
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.graph import build_graph, graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.io.sample import sample_csr
from essentials_tpu_torch.ops import sparse_advance as SA

KRON = os.path.join(os.path.dirname(__file__), "..", "datasets",
                    "kron_s12.mtx")
MAX_IT = 64
LEVELS = {"hybrid": (jbfs.run_hybrid_levels, tbfs.run_hybrid_levels),
          "phased": (jbfs.run_phased_levels, tbfs.run_phased_levels)}
GRAPHS = {
    "rmat10": lambda: JCsr.from_coo(jgen.rmat(10, 8, seed=4, undirected=True,
                                              weighted=False)),
    "grid24": lambda: JCsr.from_coo(jgen.grid_2d(24)),     # diameter 46
    "kron_s12": lambda: jload(KRON, cache=False),
}
_cache = {}


def graphs(name):
    """(host csr, JAX graph with router plans, the port's graph from its
    fields, sources: the two highest-degree vertices and a vertex of the
    smallest positive degree)."""
    if name not in _cache:
        csr = GRAPHS[name]()
        gj = jbuild(csr, directed=False, weighted=False, build_router=True)
        assert jbfs.fused_supported(gj)
        fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
        meta = {f: getattr(gj, f) for f in META_FIELDS}
        g = graph_from_arrays(fields, meta, "cpu")
        deg = np.diff(np.asarray(csr.row_offsets))
        low = int(np.argmin(np.where(deg > 0, deg, deg.max() + 1)))
        _cache[name] = (csr, gj, g, [*map(int, np.argsort(-deg)[:2]), low])
    return _cache[name]


def jitted(variant):
    return jax.jit(LEVELS[variant][0], static_argnums=(2, 3))


def hold_levels(variant, name, max_it, override, jfn=None):
    """Each source's distances and level count from both packages, exactly;
    returns the port's LevelCounts."""
    csr, gj, g, sources = graphs(name)
    jfn = jfn or jitted(variant)
    counts = []
    for s in sources:
        dj, itj = jfn(gj, s, max_it, override)
        d, it, n = LEVELS[variant][1](g, s, max_it, override)
        v = g.n_vertices
        assert d.dtype == torch.int32 and d.shape == (g.n_vertices_padded,)
        assert np.array_equal(d.numpy()[:v], np.asarray(dj)[:v]), (s, n)
        assert it == int(itj), (s, n)
        assert n.spray + n.dense == it
        ref = tbfs.cpu_reference(csr, s)
        cut = np.where(ref <= it, ref, tbfs.UNREACHED)
        assert np.array_equal(d.numpy()[:v], cut)
        counts.append(n)
    return counts


@pytest.mark.parametrize("override", [True, False, None])
@pytest.mark.parametrize("variant", list(LEVELS))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_levels_match_jax(name, variant, override):
    counts = hold_levels(variant, name, MAX_IT, override)
    for n in counts:
        if override:                  # the source's level is a spray level
            assert n.spray > 0
        else:                         # the spray is off: all dense
            assert n.spray == 0 and n.collapses == 1
            assert n.expands == (variant == "phased")


@pytest.mark.parametrize("max_it", [2, 3])
@pytest.mark.parametrize("variant", list(LEVELS))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_levels_cut_match_jax(name, variant, max_it):
    for n in hold_levels(variant, name, max_it, True):
        assert n.spray + n.dense <= max_it


@pytest.mark.parametrize("budget", [64, 1024])
@pytest.mark.parametrize("variant", list(LEVELS))
@pytest.mark.parametrize("name", ["rmat10", "kron_s12"])
def test_handovers_match_jax_under_a_small_budget(monkeypatch, name,
                                                  variant, budget):
    """HYBRID_BUDGET and HYBRID_K patched to ``budget`` in both packages
    (JAX reads them when it traces): the spray hands over to dense levels
    and back, and the results stay exact."""
    for mod in (jbfs, tbfs):
        monkeypatch.setattr(mod, "HYBRID_BUDGET", budget)
        monkeypatch.setattr(mod, "HYBRID_K", budget)
    counts = hold_levels(variant, name, MAX_IT, True, jitted(variant))
    assert sum(n.spray for n in counts) > 0
    assert sum(n.dense for n in counts) > 0
    # hybrid's dense -> spray transitions, phased's B -> C handoffs
    assert sum(n.compactions for n in counts) > 0
    if variant == "phased" and budget == 64:    # the tail regrew: D ran
        assert any(n.expands == 2 for n in counts)


@pytest.mark.parametrize("override", [True, False])
@pytest.mark.parametrize("variant", list(LEVELS))
@pytest.mark.parametrize("name", list(GRAPHS))
def test_run_gives_fused_distances_and_predecessors(monkeypatch, name,
                                                    variant, override):
    """bfs.run with the spray gate (sparse_advance._MIN_EDGES) opened or
    closed, as a graph past 2^21 edges or under it would have it."""
    monkeypatch.setattr(SA, "_MIN_EDGES", 0 if override else 1 << 62)
    _, _, g, sources = graphs(name)
    for s in sources:
        r = tbfs.run(g, s, variant=variant, max_iterations=MAX_IT,
                     warmup=False)
        f = tbfs.run(g, s, variant="fused", max_iterations=MAX_IT,
                     warmup=False)
        assert torch.equal(r.distances, f.distances)
        assert torch.equal(r.predecessors, f.predecessors)
        assert r.iterations == f.iterations
        assert r.modes.spray + r.modes.dense == r.iterations
        assert (r.modes.spray > 0) == override
        assert r.elapsed_ms >= 0


def test_touch_up_drops_pad_entries():
    """The touch-up writes the level at each listed vertex's segment start
    and sends the list's pad entries to the slot past the edge axis: the
    pad vertex's own segment (the pad edges [E, Ep)) keeps its level."""
    _, _, g, _ = graphs("rmat10")
    ep, pad = g.n_edges_padded, g.pad_vertex
    assert g.n_edges < ep                      # the pad vertex owns slots
    lev_buf = torch.full((ep + 1,), 99, dtype=torch.int32)
    fidx = torch.full((tbfs.HYBRID_K,), pad, dtype=torch.int32)
    fidx[:3] = torch.tensor([5, 17, 300])
    offs, _ = SA.frontier_out_degree(g, fidx)
    tbfs.touch_up(g, lev_buf, fidx, offs, 7)
    starts = g.row_offsets[fidx[:3].long()].long()
    assert lev_buf[starts].tolist() == [7, 7, 7]
    assert lev_buf[ep] == 7 and int(g.row_offsets[pad]) == g.n_edges
    keep = torch.ones(ep, dtype=torch.bool)
    keep[starts] = False
    assert bool((lev_buf[:ep][keep] == 99).all())


@pytest.mark.parametrize("variant", list(LEVELS))
def test_refused_without_symmetric_layout(variant):
    """As fused: no quiet fallback to adaptive (the JAX package's run takes
    adaptive there)."""
    g = build_graph(sample_csr(), directed=True, weighted=True, device="cpu")
    assert not tbfs.fused_supported(g)
    with pytest.raises(EssentialsError, match="symmetric layout"):
        tbfs.run(g, 2, variant=variant)


def test_timed_auto_probes_once_and_caches(monkeypatch):
    """auto times one warm search of each candidate (a warm-up call and a
    timed call each), caches the winner by graph shape, probes nothing on a
    second call, and gives fused's distances and predecessors."""
    _, _, g, sources = graphs("rmat10")
    calls = []
    real = tbfs._variant_fn

    def counting(cand):
        fn = real(cand)
        return lambda *a: calls.append(cand) or fn(*a)

    monkeypatch.setattr(tbfs, "_variant_fn", counting)
    monkeypatch.setattr(tbfs, "_auto_cache", {})
    cands = tbfs.auto_candidates(MAX_IT)
    assert cands == ("fused8", "fused", "phased", "hybrid")
    assert tbfs.auto_candidates(127) == ("fused", "phased", "hybrid")
    r = tbfs.run(g, sources[0], variant="auto", max_iterations=MAX_IT,
                 warmup=False)
    assert sorted(calls) == sorted(cands * 2)
    key = ("bfs",) + tbfs._graph_key(g)
    assert tbfs._auto_cache[key] in cands and key[-1] == "cpu"
    # the probe's times come back from the call that timed them
    monkeypatch.setattr(tbfs, "_auto_cache", {})
    calls.clear()
    chosen, times = tbfs._auto_variant(g, sources[0], MAX_IT)
    assert list(times) == list(cands) and chosen == min(times, key=times.get)
    assert all(ms >= 0 for ms in times.values())
    assert tbfs._auto_variant(g, sources[0], MAX_IT) == (chosen, {})
    f = tbfs.run(g, sources[0], variant="fused", max_iterations=MAX_IT,
                 warmup=False)
    assert torch.equal(r.distances, f.distances)
    assert torch.equal(r.predecessors, f.predecessors)
    calls.clear()
    r2 = tbfs.run(g, sources[1], variant="auto", max_iterations=MAX_IT,
                  warmup=False)
    assert calls == []
    assert torch.equal(r2.distances, tbfs.run(
        g, sources[1], variant="fused", max_iterations=MAX_IT,
        warmup=False).distances)
    # without a symmetric layout auto is adaptive, nothing timed
    gd = build_graph(sample_csr(), directed=True, weighted=True,
                     device="cpu")
    rd = tbfs.run(gd, 2, variant="auto")
    assert calls == [] and sum(rd.tiers) == rd.iterations
