"""Port parity: essentials_tpu_torch's betweenness centrality (bc: spmv,
generic, run_all), personalized PageRank (ppr: run, run_batch) and
ops.batch.batch_execute against essentials_tpu's and the float64 host
references, on the CPU.

Both packages run on the same arrays (the JAX graph, with router plans on
the undirected graphs so that JAX's bc spmv runs its SpMV engine, carried
into the port with graph_from_arrays). Level and iteration counts are
exact. The float32 values are held to benchmarks/PARITY.md's bounds
against the JAX package: BC within BC_REL = 2.3e-7 of the largest value,
PPR within PPR_ABS = 4.5e-8. Against the float64 host each package adds
its own float32 rounding to those bounds: BC one float32 ulp of the largest
value (2^-23 of it), PPR half an ulp of the largest mass per iteration (p
takes one float32 add an iteration); the JAX package is held to the same
host bound, so the bound asks no less of the port than of the
reference. run_all's sum over S sources takes one float32 add a source in
each package, so it is held to BC_REL + S ulps (run_all_bound)."""

import os

import jax
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import bc as jbc, ppr as jppr
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen, load_graph_file as jload

from essentials_tpu_torch.algorithms import bc as tbc, ppr as tppr
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops.batch import batch_execute

DATA = os.path.join(os.path.dirname(__file__), "..", "datasets")
BC_REL = 2.3e-7          # PARITY.md: bc (single source), max rel
PPR_ABS = 4.5e-8         # PARITY.md: ppr, max abs
ULP = 2.0 ** -23         # float32's relative spacing at 1

GRAPHS = {   # name: (host csr, directed)
    "chesapeake": lambda: (jload(os.path.join(DATA, "chesapeake.mtx"),
                                 cache=False), False),
    "rmat10": lambda: (JCsr.from_coo(jgen.rmat(10, 8, seed=4,
                                               undirected=True,
                                               weighted=False)), False),
    "kron_s12": lambda: (jload(os.path.join(DATA, "kron_s12.mtx"),
                               cache=False), False),
    "rmat10d": lambda: (JCsr.from_coo(jgen.rmat(10, 8, seed=3,
                                                undirected=False,
                                                weighted=True)), True),
}
_cache = {}


def graphs(name):
    """(csr, JAX graph, port graph, the three highest-degree vertices)."""
    if name not in _cache:
        csr, directed = GRAPHS[name]()
        gj = jbuild(csr, directed=directed, weighted=True,
                    build_router=not directed)
        fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
        meta = {f: getattr(gj, f) for f in META_FIELDS}
        top = np.argsort(-np.diff(np.asarray(csr.row_offsets)))[:3]
        _cache[name] = (csr, gj, graph_from_arrays(fields, meta, "cpu"),
                        [int(s) for s in top])
    return _cache[name]


def bc_err(a, b) -> float:
    """max |a - b| over the largest |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def run_all_bound(n_sources: int) -> float:
    """BC_REL plus an ulp of the largest value per source summed."""
    return BC_REL + n_sources * ULP


def abs_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


BC_CASES = [(n, v) for n in GRAPHS for v in ("spmv", "generic")
            if not (n == "rmat10d" and v == "spmv")]


@pytest.mark.parametrize("name,variant", BC_CASES)
def test_bc_run_matches_jax_and_host(name, variant):
    csr, gj, g, sources = graphs(name)
    for s in sources:
        r = tbc.run(g, s, variant=variant, warmup=False)
        rj = jbc.run(gj, s, variant=variant, warmup=False)
        ref = tbc.cpu_reference(csr, [s], normalize_undirected=False)
        assert r.bc_values.dtype == torch.float32
        assert r.bc_values.shape == (g.n_vertices,)
        assert r.iterations == rj.iterations
        assert bool(torch.isfinite(r.bc_values).all())
        assert bc_err(r.bc_values, rj.bc_values) <= BC_REL, s
        assert bc_err(r.bc_values, ref) <= BC_REL + ULP, s
        assert bc_err(rj.bc_values, ref) <= BC_REL + ULP, s


def test_bc_auto_and_refusal():
    """auto is spmv on a symmetric layout and generic elsewhere; spmv
    refuses a graph without a symmetric layout (the JAX package quietly
    runs generic there)."""
    _, _, gu, (s, *_) = graphs("rmat10")
    a = tbc.run(gu, s, warmup=False)
    assert torch.equal(a.bc_values,
                       tbc.run(gu, s, variant="spmv", warmup=False).bc_values)
    _, _, gd, (sd, *_) = graphs("rmat10d")
    assert not tbc.spmv_supported(gd)
    a = tbc.run(gd, sd, warmup=False)
    assert torch.equal(a.bc_values, tbc.run(gd, sd, variant="generic",
                                            warmup=False).bc_values)
    with pytest.raises(EssentialsError, match="symmetric layout"):
        tbc.run(gd, sd, variant="spmv")
    with pytest.raises(EssentialsError, match="unknown"):
        tbc.run(gu, s, variant="brandes")


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("name", ["chesapeake", "rmat10", "rmat10d"])
def test_bc_run_all_matches_jax_and_host(name, normalize):
    """A chunk of 4 over 9 sources: JAX pads the last chunk with repeats of
    the first source and subtracts them; the port does not pad."""
    csr, gj, g, top = graphs(name)
    sources = top + [0, 1, 2, 5, 8, 13]
    r = tbc.run_all(g, sources=sources, chunk=4, warmup=False,
                    normalize_undirected=normalize)
    rj = jbc.run_all(gj, sources=sources, chunk=4, warmup=False,
                     normalize_undirected=normalize)
    ref = tbc.cpu_reference(csr, sources, normalize_undirected=normalize)
    assert r.iterations == rj.iterations == len(sources)
    bound = run_all_bound(len(sources))
    assert bc_err(r.bc_values, rj.bc_values) <= bound
    assert bc_err(r.bc_values, ref) <= bound
    assert bc_err(rj.bc_values, ref) <= bound


def test_bc_run_all_every_source():
    csr, gj, g, _ = graphs("chesapeake")
    r = tbc.run_all(g, warmup=False)
    rj = jbc.run_all(gj, warmup=False)
    ref = tbc.cpu_reference(csr)
    assert r.iterations == rj.iterations == g.n_vertices
    bound = run_all_bound(g.n_vertices)
    assert bc_err(r.bc_values, rj.bc_values) <= bound
    assert bc_err(r.bc_values, ref) <= bound
    assert bc_err(rj.bc_values, ref) <= bound


@pytest.mark.parametrize("name", ["chesapeake", "rmat10d"])
def test_bc_cpu_reference_matches_jax(name):
    """The vectorised host Brandes against the JAX package's vertex by
    vertex loops, both float64 cast to float32: within one float32 ulp."""
    csr, _, _, top = graphs(name)
    for sources in ([top[0]], top):
        a = tbc.cpu_reference(csr, sources)
        b = jbc.cpu_reference(csr, sources)
        assert np.allclose(a, b, rtol=ULP, atol=0)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_ppr_run_matches_jax_and_host(name):
    csr, gj, g, seeds = graphs(name)
    for s in seeds:
        r = tppr.run(g, s, warmup=False)
        rj = jppr.run(gj, s, warmup=False)
        ref = tppr.cpu_reference(csr, s)
        assert r.p.dtype == torch.float32 and r.p.shape == (g.n_vertices,)
        assert r.iterations == rj.iterations
        assert abs_err(r.p, rj.p) <= PPR_ABS, s
        host = PPR_ABS + r.iterations * ULP / 2 * float(np.abs(ref).max())
        assert abs_err(r.p, ref) <= host, s
        assert abs_err(rj.p, ref) <= host, s


@pytest.mark.parametrize("name", ["chesapeake", "rmat10d"])
def test_ppr_run_batch_matches_runs_and_jax(name):
    """Each row of run_batch is run's result from that seed, bit for bit
    (the same kernels in the same order), and within PPR_ABS of JAX's
    vmapped batch."""
    _, gj, g, seeds = graphs(name)
    out = tppr.run_batch(g, seeds)
    assert out.shape == (len(seeds), g.n_vertices)
    for i, s in enumerate(seeds):
        assert torch.equal(out[i], tppr.run(g, s, warmup=False).p)
    assert abs_err(out, np.asarray(jppr.run_batch(gj, seeds))) <= PPR_ABS


@pytest.mark.parametrize("name", ["chesapeake", "rmat10d"])
def test_ppr_cpu_reference_matches_jax(name):
    """The vectorised host push against the JAX package's loops, both
    float64 cast to float32 (the graphs hold no multi-edges, which the
    JAX loop's fancy-index add would count once): within one ulp."""
    csr, _, _, seeds = graphs(name)
    for s in seeds:
        assert np.allclose(tppr.cpu_reference(csr, s),
                           jppr.cpu_reference(csr, s), rtol=ULP, atol=0)


def test_batch_execute_stacks_each_seed():
    seeds = torch.tensor([3, 1, 2])
    out = batch_execute(lambda s, k: torch.full((2,), s * k), seeds, 10)
    assert out.tolist() == [[30, 30], [10, 10], [20, 20]]
    a, b = batch_execute(lambda s: (torch.tensor([s, -s]), s + 1), [4, 5])
    assert a.tolist() == [[4, -4], [5, -5]] and b.tolist() == [5, 6]
