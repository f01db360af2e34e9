"""Port parity: BFS and SSSP ``adaptive`` (algorithms.bfs/sssp step and run,
framework.enactor) and SpMV ``pull``/``push`` against
essentials_tpu's, on the CPU.

Distances (float32 compared as bits), predecessors and iteration counts must
be equal: both packages pick the same tier each step and compute the same
float32 additions and exact minima. The tiers fire only on graphs above
sparse_advance._MIN_EDGES (2^21 edges); the tests that cover them patch it
to 0 in both packages and clear JAX's compile cache, whose entries were
traced with the gate closed. Against the float64 host Dijkstra, SSSP is held
to rtol 1e-5 with the reach set exact; SpMV to |y - ref| <= 1e-5 |ref| +
1e-6 (benchmarks/PARITY.md). The JAX graphs are built without router plans,
as on any device but the TPU, and carried into the port with
graph_from_arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import bfs as jbfs
from essentials_tpu.algorithms import spmv as jspmv
from essentials_tpu.algorithms import sssp as jsssp
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.ops import sparse_advance as jsa

from essentials_tpu_torch import kernels
from essentials_tpu_torch.algorithms import bfs as tbfs
from essentials_tpu_torch.algorithms import spmv as tspmv
from essentials_tpu_torch.algorithms import sssp as tsssp
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.framework import default_converged, enact
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import sparse_advance as tsa

RTOL = 1e-5
_jax_bfs_pred = jax.jit(jbfs.predecessors_from_distances)


def carried(csr, directed):
    gj = jbuild(csr, directed=directed, weighted=True, build_router=False)
    fields = {f: None if getattr(gj, f) is None else np.asarray(getattr(gj, f))
              for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return csr, gj, graph_from_arrays(fields, meta, "cpu")


@pytest.fixture(scope="module")
def graphs():
    # rmat12 ef16 seed 3, directed: with the tier gate open, every tier
    # fires from its highest out-degree sources (asserted below)
    return {
        "rmat12d": carried(JCsr.from_coo(jgen.rmat(
            12, 16, seed=3, undirected=False, weighted=True)), True),
        "rmat9u": carried(JCsr.from_coo(jgen.rmat(
            9, 8, seed=5, undirected=True, weighted=True)), False),
    }


def sources(csr, n=3):
    """The n highest out-degree vertices and one without out-edges."""
    deg = np.diff(csr.row_offsets)
    top = [int(s) for s in np.argsort(-deg, kind="stable")[:n]]
    return top + [int(np.flatnonzero(deg == 0)[0])]


def bits(a) -> np.ndarray:
    return np.asarray(a).view(np.int32)


def jax_bfs(gj, source, max_it=None):
    r = jjbfs_run(gj, source, max_it)
    dist = np.full(gj.n_vertices_padded, jbfs.UNREACHED, np.int32)
    dist[:gj.n_vertices] = np.asarray(r.distances)
    pred = np.asarray(_jax_bfs_pred(gj, dist))[:gj.n_vertices]
    return np.asarray(r.distances), pred, r.iterations


def jjbfs_run(gj, source, max_it):
    return jbfs.run(gj, source, max_iterations=max_it, warmup=False,
                    variant="adaptive", compute_predecessors=False)


def check_bfs(csr, gj, g, source, max_it=None):
    r = tbfs.run(g, source, max_iterations=max_it, variant="adaptive",
                 warmup=False)
    d_j, p_j, it_j = jax_bfs(gj, source, max_it)
    assert r.distances.dtype == r.predecessors.dtype == torch.int32
    assert np.array_equal(r.distances.numpy(), d_j), source
    assert np.array_equal(r.predecessors.numpy(), p_j), source
    assert r.iterations == it_j, source
    if max_it is None:
        assert np.array_equal(r.distances.numpy(),
                              tbfs.cpu_reference(csr, source))
    return r


def check_sssp(csr, gj, g, source):
    r = tsssp.run(g, source, variant="adaptive", warmup=False)
    rj = jsssp.run(gj, source, variant="adaptive", warmup=False)
    assert r.distances.dtype == torch.float32
    assert np.array_equal(bits(r.distances), bits(rj.distances)), source
    assert np.array_equal(r.predecessors.numpy(),
                          np.asarray(rj.predecessors)), source
    assert r.iterations == rj.iterations, source
    ref = tsssp.cpu_reference(csr, source)
    d = r.distances.numpy()
    reach = np.isfinite(ref)
    assert np.array_equal(np.isfinite(d), reach)
    np.testing.assert_allclose(d[reach], ref[reach], rtol=RTOL, atol=0)
    return r


@pytest.mark.parametrize("name", ["rmat12d", "rmat9u"])
def test_adaptive_dense_matches_jax(graphs, name):
    """With the gate closed (test-size graphs) every step is dense: the
    advance_count kernel for BFS, two MIN advances for SSSP."""
    csr, gj, g = graphs[name]
    assert not tsa.spray_enabled(g) and not jsa.spray_enabled(gj)
    for s in sources(csr):
        rb = check_bfs(csr, gj, g, s)
        rs = check_sssp(csr, gj, g, s)
        assert rb.tiers == (0, 0, rb.iterations)
        assert rs.tiers == (0, 0, rs.iterations)


def test_adaptive_every_tier_matches_jax(graphs, monkeypatch):
    csr, gj, g = graphs["rmat12d"]
    monkeypatch.setattr(tsa, "_MIN_EDGES", 0)
    monkeypatch.setattr(jsa, "_MIN_EDGES", 0)
    jax.clear_caches()
    try:
        tiers = np.zeros((2, 3), int)
        for s in sources(csr):
            tiers[0] += check_bfs(csr, gj, g, s).tiers
            tiers[1] += check_sssp(csr, gj, g, s).tiers
        assert (tiers > 0).all(), tiers
    finally:
        jax.clear_caches()


@pytest.mark.parametrize("max_it", [1, 2, 3])
def test_adaptive_cut_by_max_iterations(graphs, max_it):
    csr, gj, g = graphs["rmat9u"]
    s = sources(csr)[0]
    r = check_bfs(csr, gj, g, s, max_it)
    assert r.iterations == max_it
    ref = tbfs.cpu_reference(csr, s)
    cut = np.where(ref <= max_it, ref, tbfs.UNREACHED)
    assert np.array_equal(r.distances.numpy(), cut)


def test_auto_takes_adaptive_without_symmetric_layout(graphs):
    csr, _, g = graphs["rmat12d"]
    assert not g.symmetric_layout and not tbfs.fused_supported(g)
    s = sources(csr)[0]
    a = tbfs.run(g, s, warmup=False)
    assert a.tiers[2] == a.iterations > 0
    assert np.array_equal(a.distances.numpy(), tbfs.cpu_reference(csr, s))
    b = tsssp.run(g, s, warmup=False)
    assert sum(b.tiers) == b.iterations > 0
    # a symmetric layout keeps the fused engines
    _, _, gu = graphs["rmat9u"]
    assert tbfs.run(gu, 0, warmup=False).tiers == (0, 0, 0)
    assert tsssp.run(gu, 0, warmup=False).tiers == (0, 0, 0)


def test_fused_variants_refuse_graphs_without_symmetric_layout(graphs):
    _, _, g = graphs["rmat12d"]
    for run, variant in ((tbfs.run, "fused"), (tbfs.run, "fused8"),
                         (tsssp.run, "fused"), (tsssp.run, "windowed")):
        with pytest.raises(EssentialsError, match="symmetric layout"):
            run(g, 0, variant=variant)


def test_enactor_semantics(graphs):
    csr, _, g = graphs["rmat9u"]
    s = sources(csr)[0]
    res = enact(tbfs.step, default_converged, g, tbfs.init(g, s),
                warmup=False)
    r = tbfs.run(g, s, variant="adaptive", warmup=False,
                 compute_predecessors=False)
    assert res.iterations == r.iterations
    assert torch.equal(res.state.distances[:g.n_vertices], r.distances)
    res = enact(tsssp.step, None, g, tsssp.init(g, s), max_iterations=2,
                warmup=False)
    assert res.iterations == 2 and res.elapsed_ms >= 0
    # the convergence test runs before every iteration after the first
    calls = []

    def step(graph, state, it):
        calls.append(it)
        return state

    out = enact(step, lambda *a: True, g, None, max_iterations=5,
                warmup=False)
    assert out.iterations == 1 and calls == [0]
    out = enact(step, None, g, (torch.zeros(3, dtype=torch.bool),),
                max_iterations=5, warmup=True)
    assert out.iterations == 1
    assert enact(step, None, g, None, max_iterations=0).iterations == 0
    assert default_converged(g, (torch.ones(2, dtype=torch.bool),), 1) \
        is False


def test_adaptive_launches_nothing_on_cpu(graphs):
    csr, _, g = graphs["rmat9u"]
    kernels.reset_launches()
    tbfs.run(g, 1, variant="adaptive", warmup=False)
    tsssp.run(g, 1, variant="adaptive", warmup=False)
    assert all(n == 0 for n in kernels.launches.values())


# ----------------------------------------------------------- spmv pull/push --

_jax_pull = jax.jit(jspmv.spmv_pull)
_jax_push = jax.jit(jspmv.spmv_push)


@pytest.mark.parametrize("name", ["rmat12d", "rmat9u"])
@pytest.mark.parametrize("variant", ["pull", "push"])
def test_spmv_pull_push_match_jax_and_host(graphs, name, variant):
    csr, gj, g = graphs[name]
    x = tspmv.random_x(g, 4)
    y = tspmv.run(g, x, variant=variant, warmup=False).y.numpy()
    fn = _jax_pull if variant == "pull" else _jax_push
    want = np.asarray(fn(gj, jnp.asarray(x.numpy())))[:g.n_vertices]
    if variant == "pull":
        ref = tspmv.cpu_reference(csr, x.numpy())
    else:                                   # A^T x
        off = np.asarray(csr.row_offsets)
        src = np.repeat(np.arange(csr.n_rows), np.diff(off))
        ref = np.zeros(csr.n_rows)
        np.add.at(ref, np.asarray(csr.col_indices),
                  np.asarray(csr.values, np.float64)
                  * x.numpy().astype(np.float64)[src])
    for other in (want, ref):
        other = np.asarray(other, np.float64)
        assert (np.abs(y - other) <= 1e-5 * np.abs(other) + 1e-6).all()
