"""Port parity: essentials_tpu_torch's geolocation (geo.run and
spatial_median) against essentials_tpu's and the float64 host reference,
on the CPU.

Both packages run on the same arrays (the JAX graph carried into the port
with graph_from_arrays) from the same seeded positions. Iteration counts
and the NaN pattern (which vertices are located) are exact; latitudes and
longitudes are held within benchmarks/PARITY.md's 1.5e-3 degrees of the
JAX package's and of the host's, longitudes compared around the circle
(min(|d|, 360 - |d|): a centroid near +-180 degrees may land on either side
in float32, the same point). Where five Weiszfeld sweeps are chaotic in
float32 (test_spatial_median_conditioning), each vertex's Weiszfeld
objective is held instead of its position.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import geo as jgeo
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen, load_graph_file as jload

from essentials_tpu_torch.algorithms import geo
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS

DATA = os.path.join(os.path.dirname(__file__), "..", "datasets")
DEG = 1.5e-3            # PARITY.md: geo, max lat diff (float32 trig)
# spatial_median's objective after 5 sweeps on rmat10: per vertex (about
# 4x the largest gap seen, 2.3e-3) and summed over the vertices (3.7x the
# largest, 2.7e-5, a JAX run from its own step's positions)
MEDIAN_RTOL, MEDIAN_SUM_RTOL = 1e-2, 1e-4

GRAPHS = {
    "chesapeake": lambda: jload(os.path.join(DATA, "chesapeake.mtx"),
                                cache=False),
    "rmat10": lambda: JCsr.from_coo(jgen.rmat(10, 8, seed=4, undirected=True,
                                              weighted=False)),
}
# (seed, share unknown, longitude range): tests/test_algorithms2.py's input
# (40% unknown) and the suite's (benchmarks/run_benchmarks.py: 20% located)
INPUTS = {"chesapeake": (0, 0.4, 170.0), "rmat10": (7, 0.8, 180.0)}
_cache = {}


def positions(n: int, seed: int, unknown: float, lon_max: float) -> tuple:
    rng = np.random.default_rng(seed)
    lat = rng.uniform(-60, 60, n).astype(np.float32)
    lon = rng.uniform(-lon_max, lon_max, n).astype(np.float32)
    unk = rng.random(n) < unknown
    lat[unk] = np.nan
    lon[unk] = np.nan
    return lat, lon


def graphs(name):
    """(csr, JAX graph, port graph, lat, lon), each built once."""
    if name not in _cache:
        csr = GRAPHS[name]()
        gj = jbuild(csr, directed=False, weighted=False)
        fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
        meta = {f: getattr(gj, f) for f in META_FIELDS}
        _cache[name] = (csr, gj, graph_from_arrays(fields, meta, "cpu"),
                        *positions(csr.n_rows, *INPUTS[name]))
    return _cache[name]


def hold(lat, lon, ref_lat, ref_lon, deg: float = DEG) -> None:
    """Equal NaN patterns; lat within deg, lon within deg around the
    circle."""
    lat, lon = np.asarray(lat, np.float64), np.asarray(lon, np.float64)
    ref_lat = np.asarray(ref_lat, np.float64)
    ref_lon = np.asarray(ref_lon, np.float64)
    assert np.array_equal(np.isnan(lat), np.isnan(ref_lat))
    assert np.array_equal(np.isnan(lon), np.isnan(ref_lon))
    ok = ~np.isnan(ref_lat)
    assert np.abs(lat[ok] - ref_lat[ok]).max(initial=0.0) <= deg
    d = np.abs(lon[ok] - ref_lon[ok])
    assert np.minimum(d, 360.0 - d).max(initial=0.0) <= deg


@pytest.mark.parametrize("name", list(GRAPHS))
def test_geo_matches_jax_and_host(name):
    csr, gj, g, lat, lon = graphs(name)
    r = geo.run(g, lat, lon, total_iterations=10, warmup=False)
    rj = jgeo.run(gj, lat, lon, total_iterations=10, warmup=False)
    assert r.lat.dtype == torch.float32 and r.lat.shape == (g.n_vertices,)
    assert r.iterations == rj.iterations
    hold(r.lat, r.lon, rj.lat, rj.lon)
    ref = geo.cpu_reference(csr, lat, lon, total_iterations=10)
    hold(r.lat, r.lon, *ref)
    hold(rj.lat, rj.lon, *ref)
    # previously-known positions unchanged
    known = ~np.isnan(lat)
    assert np.array_equal(r.lat.numpy()[known], lat[known])
    assert np.array_equal(r.lon.numpy()[known], lon[known])
    assert np.isnan(r.lat.numpy()).sum() < np.isnan(lat).sum()


@pytest.mark.parametrize("iterations", [1, 3])
def test_geo_iteration_cap(iterations):
    """A capped run stops at the cap with JAX's positions; the capped
    host reference agrees."""
    csr, gj, g, lat, lon = graphs("rmat10")
    r = geo.run(g, lat, lon, total_iterations=iterations, warmup=False)
    rj = jgeo.run(gj, lat, lon, total_iterations=iterations, warmup=False)
    assert r.iterations == rj.iterations == iterations
    hold(r.lat, r.lon, rj.lat, rj.lon)
    hold(r.lat, r.lon, *geo.cpu_reference(csr, lat, lon, iterations))


def one_step(name):
    """Both packages' states after one geo.step from the same input."""
    _, gj, g, lat, lon = graphs(name)
    s = geo.step(g, geo.init(g, lat, lon), 0)
    sj = jgeo.step(gj, jgeo.init(gj, lat, lon), 0)
    hold(s.lat, s.lon, sj.lat, sj.lon)
    return s, sj


@pytest.mark.parametrize("name,iterations", [("chesapeake", 5),
                                             ("rmat10", 2)])
def test_spatial_median_matches_jax_and_host(name, iterations):
    """Weiszfeld iterations from the located positions after one geo.step,
    in both packages from the same state, against each other and the
    float64 host sweeps (geo.spatial_median_reference). rmat10 is held at
    2 iterations: test_spatial_median_conditioning shows why not 5."""
    csr, gj, g, _, _ = graphs(name)
    s, sj = one_step(name)
    ml, mn = geo.spatial_median(g, s.lat, s.lon, iterations=iterations)
    jl, jn = jgeo.spatial_median(gj, sj.lat, sj.lon, iterations=iterations)
    assert ml.shape == (g.n_vertices_padded,)
    hold(ml, mn, jl, jn)
    n = g.n_vertices
    ref = geo.spatial_median_reference(csr, s.lat.numpy(), s.lon.numpy(),
                                       iterations)
    hold(ml[:n], mn[:n], *ref)
    hold(np.asarray(jl)[:n], np.asarray(jn)[:n], *ref)


def test_spatial_median_conditioning():
    """5 iterations on rmat10: a vertex of degree 81 whose estimate nears a
    located neighbour amplifies float32 rounding about tenfold a sweep
    (the weight is 1/(d + 1e-6)). The JAX package moves by more than
    PARITY.md's 1.5e-3 degrees when its own input moves by one float32
    ulp, so no float32 run can be held to that bound there. What is held
    is each vertex's Weiszfeld objective (geo.spatial_median_objective:
    the summed chord distance to its located neighbours), within
    MEDIAN_RTOL past what a move of DEG can change, and its sum over the
    vertices within MEDIAN_SUM_RTOL: the port's against the JAX package's
    from the same positions and against the float64 host's, with equal
    NaN patterns."""
    csr, gj, g, _, _ = graphs("rmat10")
    s, sj = one_step("rmat10")
    jl, jn = (np.asarray(x) for x in jgeo.spatial_median(
        gj, sj.lat, sj.lon, iterations=5))
    nudged = np.asarray(sj.lat).copy()
    ok = ~np.isnan(nudged)
    nudged[ok] = np.nextafter(nudged[ok], np.float32(90))
    jl2, _ = (np.asarray(x) for x in jgeo.spatial_median(
        gj, jnp.asarray(nudged), sj.lon, iterations=5))
    assert np.nanmax(np.abs(jl2 - jl)) > DEG
    n = g.n_vertices
    start = (s.lat.numpy()[:n], s.lon.numpy()[:n])
    ml, mn = geo.spatial_median(g, s.lat, s.lon, iterations=5)
    jl, jn = (np.asarray(x)[:n] for x in jgeo.spatial_median(
        gj, jnp.asarray(s.lat.numpy()), jnp.asarray(s.lon.numpy()),
        iterations=5))
    ref = geo.spatial_median_reference(csr, *start, 5)
    port = (ml.numpy()[:n], mn.numpy()[:n])
    for got, want in ((port, (jl, jn)), (port, ref), ((jl, jn), ref)):
        assert np.array_equal(np.isnan(got[0]), np.isnan(want[0]))
        f, m = geo.spatial_median_objective(csr, *start, *got)
        fw, _ = geo.spatial_median_objective(csr, *start, *want)
        assert (np.abs(f - fw) <= MEDIAN_RTOL * fw + np.deg2rad(DEG) * m
                ).all()
        assert abs(f.sum() - fw.sum()) <= MEDIAN_SUM_RTOL * fw.sum()


def test_cpu_reference_matches_jax():
    """The vectorised host iterations against the JAX package's vertex
    loop, both float64 cast to float32: within a float32 ulp of 180."""
    csr, _, _, lat, lon = graphs("chesapeake")
    for it in (1, 10):
        hold(*geo.cpu_reference(csr, lat, lon, it),
             *jgeo.cpu_reference(csr, lat, lon, it), deg=2e-5)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_cpu_reference_error_bound(name):
    """geo.cpu_reference's error bound (float32 rounding carried through
    the iterations, from the host's data alone): 0 at the given positions,
    positive where an iteration located a vertex, and the port's and the
    JAX package's float32 runs lie within it where it passes DEG."""
    csr, gj, g, lat, lon = graphs(name)
    ref_lat, ref_lon, bound = geo.cpu_reference(csr, lat, lon, 10,
                                                error_bound=True)
    given = ~np.isnan(lat)
    found = ~given & ~np.isnan(ref_lat)
    assert (bound[given] == 0).all() and found.any()
    assert (bound[found] > 0).all()
    cos = np.cos(np.deg2rad(np.nan_to_num(ref_lat.astype(np.float64))))
    for r in (geo.run(g, lat, lon, total_iterations=10, warmup=False),
              jgeo.run(gj, lat, lon, total_iterations=10, warmup=False)):
        d_lat = np.abs(np.asarray(r.lat, np.float64) - ref_lat)
        d_lon = np.abs(np.asarray(r.lon, np.float64) - ref_lon)
        d_lon = np.minimum(d_lon, 360.0 - d_lon)
        assert (d_lat[found] <= np.maximum(DEG, bound[found])).all()
        assert (d_lon[found] <= np.maximum(DEG, bound[found] / cos[found])
                ).all()


def test_converged_reads_every_real_vertex():
    _, _, g, lat, lon = graphs("chesapeake")
    s = geo.init(g, lat, lon)
    assert not geo.converged(g, s, 1)
    full = geo.init(g, np.zeros(g.n_vertices, np.float32),
                    np.zeros(g.n_vertices, np.float32))
    assert torch.isnan(full.lat[g.n_vertices:]).all()   # the pad stays NaN
    assert geo.converged(g, full, 1)
