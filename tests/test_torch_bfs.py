"""Port parity: essentials_tpu_torch.algorithms.bfs.run end to end against
essentials_tpu's bfs.run(variant="fused") and the host cpu_reference, on
the CPU. Distances, predecessors and iteration counts are integers: the
tolerance is exact equality.

The JAX predecessors are computed by its predecessors_from_distances under
jax.jit: called eagerly, as bfs.run calls it, each op of its CPU path
compiles on its own, which costs tens of seconds per graph."""

import os

import jax
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import bfs as jbfs
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.formats.coo import Coo as JCoo
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen, load_graph_file as jload

from essentials_tpu_torch.algorithms import bfs as tbfs
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.formats import Csr as TCsr
from essentials_tpu_torch.formats.coo import Coo as TCoo
from essentials_tpu_torch.graph import build_graph
from essentials_tpu_torch.io import generate as tgen, load_graph_file as tload
from essentials_tpu_torch.io.sample import sample_csr

CHESAPEAKE = os.path.join(os.path.dirname(__file__), "..", "datasets",
                          "chesapeake.mtx")
_jax_pred = jax.jit(jbfs.predecessors_from_distances)

# mirrored edge list with vertex 0 isolated
_ISO = (8, np.array([1, 2, 2, 3, 3, 4], np.int32),
        np.array([2, 1, 3, 2, 4, 3], np.int32))

GRAPHS = {
    "rmat10": (lambda m: m.Csr.from_coo(m.gen.rmat(
        10, 8, seed=4, undirected=True, weighted=False))),
    "grid24": lambda m: m.Csr.from_coo(m.gen.grid_2d(24)),
    "chesapeake": lambda m: m.load(CHESAPEAKE, cache=False),
    "isolated": lambda m: m.Csr.from_coo(m.Coo(
        _ISO[0], _ISO[0], _ISO[1], _ISO[2], np.ones(6, np.float32))),
    "chain300": lambda m: m.Csr.from_coo(m.gen.chain(300)),
}


class _Pkg:
    def __init__(self, Csr, Coo, gen, load):
        self.Csr, self.Coo, self.gen, self.load = Csr, Coo, gen, load


_T = _Pkg(TCsr, TCoo, tgen, tload)
_J = _Pkg(JCsr, JCoo, jgen, jload)
_cache = {}


def graphs(name):
    """(port csr, port graph, JAX graph), built once per module."""
    if name not in _cache:
        tcsr, jcsr = GRAPHS[name](_T), GRAPHS[name](_J)
        g = build_graph(tcsr, directed=False, weighted=False, device="cpu")
        gj = jbuild(jcsr, directed=False, weighted=False, build_router=True)
        assert jbfs.fused_supported(gj) and tbfs.fused_supported(g)
        _cache[name] = (tcsr, g, gj)
    return _cache[name]


def jax_run(gj, source, max_it):
    r = jbfs.run(gj, source, max_iterations=max_it, warmup=False,
                 variant="fused", compute_predecessors=False)
    dist = np.full(gj.n_vertices_padded, jbfs.UNREACHED, np.int32)
    dist[:gj.n_vertices] = np.asarray(r.distances)
    pred = np.asarray(_jax_pred(gj, dist))[:gj.n_vertices]
    return np.asarray(r.distances), pred, r.iterations


@pytest.mark.parametrize("variant", ["fused", "fused8"])
@pytest.mark.parametrize("name,source,max_it", [
    ("rmat10", 0, 64), ("rmat10", 5, 64), ("rmat10", 100, 64),
    ("grid24", 0, None), ("chesapeake", 0, None), ("isolated", 0, None),
    ("chain300", 0, None), ("rmat10", 0, 2), ("grid24", 30, 10),
])
def test_run_matches_jax_and_reference(name, source, max_it, variant):
    csr, g, gj = graphs(name)
    r = tbfs.run(g, source, max_iterations=max_it, variant=variant)
    d_j, p_j, it_j = jax_run(gj, source, max_it)
    assert r.distances.dtype == torch.int32
    assert r.predecessors.dtype == torch.int32
    assert np.array_equal(r.distances.numpy(), d_j)
    assert np.array_equal(r.predecessors.numpy(), p_j)
    assert r.iterations == it_j
    assert r.elapsed_ms >= 0
    ref = tbfs.cpu_reference(csr, source)
    if max_it is None or r.iterations < max_it:
        assert np.array_equal(r.distances.numpy(), ref)
    else:                       # cut: exactly the levels below the cut
        cut = np.where(ref <= max_it, ref, tbfs.UNREACHED)
        assert np.array_equal(r.distances.numpy(), cut)


def test_chain_runs_past_the_int8_gate():
    """fused8 with the default max_iterations (V + 1 = 301 > 126) runs the
    int32 form, and runs all 300 levels."""
    csr, g, _ = graphs("chain300")
    r = tbfs.run(g, 0, variant="fused8", warmup=False)
    assert r.iterations == 300
    assert r.distances[-1] == 299
    with pytest.raises(EssentialsError):
        tbfs.run_fused_levels(g, 0, 300, int8=True)
    lev, it, unreached = tbfs.run_fused_levels(g, 0, 126, int8=True)
    assert lev.dtype == torch.int8 and it == 126 and unreached == 127


def test_isolated_source_one_iteration():
    _, g, _ = graphs("isolated")
    r = tbfs.run(g, 0, variant="fused8", max_iterations=64)
    assert r.iterations == 1
    assert r.distances[0] == 0 and torch.all(r.distances[1:] == tbfs.UNREACHED)
    assert torch.all(r.predecessors == -1)


def test_auto_is_fused():
    """auto (a timed choice among the edge-axis variants) gives fused's
    distances and predecessors."""
    csr, g, _ = graphs("chesapeake")
    a = tbfs.run(g, 3, variant="auto", warmup=False)
    f = tbfs.run(g, 3, variant="fused", warmup=False)
    assert torch.equal(a.distances, f.distances)
    assert torch.equal(a.predecessors, f.predecessors)


@pytest.mark.parametrize("variant", ["hybrid", "phased", "nope"])
def test_unported_variants_raise(variant):
    """hybrid and phased (no longer unported) run and give fused's
    distances, predecessors and levels; an unknown variant raises."""
    _, g, _ = graphs("chesapeake")
    if variant == "nope":
        with pytest.raises(EssentialsError, match="unknown"):
            tbfs.run(g, 0, variant=variant)
        return
    r = tbfs.run(g, 0, variant=variant, warmup=False)
    f = tbfs.run(g, 0, variant="fused", warmup=False)
    assert torch.equal(r.distances, f.distances)
    assert torch.equal(r.predecessors, f.predecessors)
    assert r.iterations == f.iterations
    assert r.modes.spray + r.modes.dense == r.iterations


@pytest.mark.parametrize("name", ["chesapeake", "grid24"])
def test_adaptive_runs_like_fused(name):
    """adaptive (no longer unported) gives fused's distances, predecessors
    and levels on a graph with a symmetric layout."""
    _, g, _ = graphs(name)
    a = tbfs.run(g, 3, variant="adaptive", warmup=False)
    f = tbfs.run(g, 3, variant="fused", warmup=False)
    assert torch.equal(a.distances, f.distances)
    assert torch.equal(a.predecessors, f.predecessors)
    assert a.iterations == f.iterations and a.tiers == (0, 0, a.iterations)


def test_non_symmetric_graph_raises():
    """fused still needs a symmetric layout; adaptive and auto run."""
    csr = sample_csr()
    g = build_graph(csr, directed=True, weighted=True, device="cpu")
    assert not tbfs.fused_supported(g)
    with pytest.raises(EssentialsError, match="symmetric layout"):
        tbfs.run(g, 2, variant="fused")
    for variant in ("adaptive", "auto"):
        r = tbfs.run(g, 2, variant=variant)
        assert np.array_equal(r.distances.numpy(), tbfs.cpu_reference(csr, 2))


def test_compute_predecessors_off():
    _, g, _ = graphs("grid24")
    r = tbfs.run(g, 0, compute_predecessors=False, warmup=False)
    assert torch.all(r.predecessors == -1)


@pytest.mark.parametrize("name", ["rmat10", "grid24", "chesapeake"])
def test_cpu_reference_matches_jax(name):
    csr = GRAPHS[name](_T)
    jcsr = GRAPHS[name](_J)
    for s in (0, 7, 33):
        assert np.array_equal(tbfs.cpu_reference(csr, s),
                              jbfs.cpu_reference(jcsr, s))
