"""Port parity: essentials_tpu_torch's minimum spanning forest (mst) and the
keyed segment operators it came with (ops.segment.segment_combine and
apply_permutation) against essentials_tpu's, on the CPU.

Both packages run on the same arrays (the JAX graph carried into the port
with graph_from_arrays). MST's combines are integer MINs and its moves
exact gathers, so ``in_mst`` and the round count are held exactly equal to
the JAX package's. The minimum spanning forest's weight is unique, so the
chosen weights summed in float64 are held within 1e-9 relative of the
float64 host total. ``total_weight`` is a float32 sum
of the chosen weights in each package, in its own tree order: each is held
within total_bound of the float64 host total (the pairwise-summation
bound, ceil(log2 k) 2^-24 of the total for k terms), and the two within
twice that of each other. The host references (the port's scipy forest,
the JAX package's Kruskal) sum float32 weights in float64, which is exact
for these graphs, so they are held equal.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import mst as jmst
from essentials_tpu.formats import Coo as JCoo, Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.ops import segment as jseg
from essentials_tpu.ops.configs import Combine as JCombine

from essentials_tpu_torch.algorithms import mst
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import segment
from essentials_tpu_torch.ops.configs import Combine

HALF_ULP = 2.0 ** -24    # float32's unit roundoff


def _undirected(edges, n, weights):
    src = np.array([e[0] for e in edges] + [e[1] for e in edges])
    dst = np.array([e[1] for e in edges] + [e[0] for e in edges])
    w = np.array(list(weights) + list(weights), np.float32)
    return JCsr.from_coo(JCoo(n, n, src, dst, w))


K6 = [(i, j) for i in range(6) for j in range(i + 1, 6)]
CYCLE = [(i, (i + 1) % 10) for i in range(10)]
# tests/test_algorithms2.py's MST graphs, and an equal-weight cycle
GRAPHS = {
    "square": lambda: _undirected([(0, 1), (1, 2), (2, 3), (3, 0), (0, 2)],
                                  4, [1.0, 2.0, 3.0, 4.0, 5.0]),
    "uniform120": lambda: JCsr.from_coo(jgen.uniform_random(
        120, 4, seed=9, undirected=True, weighted=True)),
    "k6_equal": lambda: _undirected(K6, 6, [1.0] * len(K6)),
    "disconnected": lambda: _undirected([(0, 1), (2, 3)], 4, [2.0, 7.0]),
    "rmat9": lambda: JCsr.from_coo(jgen.rmat(9, 8, seed=11, undirected=True,
                                             weighted=True)),
    "grid40": lambda: JCsr.from_coo(jgen.grid_2d(40, weighted=True)),
    "cycle_equal": lambda: _undirected(CYCLE, 10, [3.0] * len(CYCLE)),
}
_cache = {}


def graphs(name):
    """(csr, JAX graph, port graph, JAX result), each built once."""
    if name not in _cache:
        csr = GRAPHS[name]()
        gj = jbuild(csr, directed=False, weighted=True)
        fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
        meta = {f: getattr(gj, f) for f in META_FIELDS}
        _cache[name] = (csr, gj, graph_from_arrays(fields, meta, "cpu"),
                        jmst.run(gj, warmup=False))
    return _cache[name]


def total_bound(k: int, total: float) -> float:
    """The float32 rounding of a tree sum of k positive terms (each term
    rounded at most once a level): ceil(log2 k) 2^-24 of it."""
    return max(math.ceil(math.log2(max(k, 2))), 1) * HALF_ULP * abs(total)


@pytest.mark.parametrize("name", list(GRAPHS))
def test_mst_matches_jax_and_host(name):
    csr, _, g, rj = graphs(name)
    r = mst.run(g, warmup=False)
    assert r.in_mst.dtype == torch.bool and r.in_mst.shape == (g.n_edges,)
    assert np.array_equal(r.in_mst.numpy(), np.asarray(rj.in_mst))
    assert r.iterations == rj.iterations
    host = mst.cpu_reference(csr)
    assert host == jmst.cpu_reference(csr)
    chosen = np.asarray(csr.values, np.float64)[r.in_mst.numpy()]
    assert abs(chosen.sum() - host) <= 1e-9 * host
    k = int(r.in_mst.sum())
    assert abs(r.total_weight - host) <= total_bound(k, host)
    assert abs(rj.total_weight - host) <= total_bound(k, host)
    assert abs(r.total_weight - rj.total_weight) <= 2 * total_bound(k, host)
    chosen, c_graph, c_tree = mst.forest_check(csr, r.in_mst.numpy())
    assert (chosen, c_tree) == (csr.n_rows - c_graph, c_graph)


def test_mst_known_totals():
    """tests/test_algorithms2.py's exact totals: the square's three
    cheapest non-cycle edges, K6's n - 1 equal weights, the disconnected
    pair's forest, the equal cycle's n - 1."""
    for name, want in (("square", 6.0), ("k6_equal", 5.0),
                       ("disconnected", 9.0), ("cycle_equal", 27.0)):
        assert mst.run(graphs(name)[2], warmup=False).total_weight == want


@pytest.mark.parametrize("name", ["k6_equal", "cycle_equal"])
def test_mst_equal_weights_deterministic(name):
    """All weights equal: the (cu, cv) tie-break decides every round; two
    runs give the same bits, and JAX's edges."""
    _, _, g, rj = graphs(name)
    r1, r2 = mst.run(g, warmup=False), mst.run(g, warmup=False)
    assert torch.equal(r1.in_mst, r2.in_mst)
    assert np.array_equal(r1.in_mst.numpy(), np.asarray(rj.in_mst))


def test_mst_step_state_matches_jax():
    """Round by round on rmat9: components and chosen edges equal JAX's
    step's, and the changed flag."""
    _, gj, g, rj = graphs("rmat9")
    sj, s = jmst.init(gj), mst.init(g)
    step = jax.jit(jmst.step)
    for it in range(rj.iterations):
        sj, s = step(gj, sj, it), mst.step(g, s, it)
        assert np.array_equal(s.comp.numpy(), np.asarray(sj.comp))
        assert np.array_equal(s.in_mst.numpy(), np.asarray(sj.in_mst))
        assert bool(s.changed) == bool(sj.changed)
    assert mst.converged(g, s, rj.iterations)


def test_mst_max_iterations_caps_rounds():
    _, _, g, rj = graphs("grid40")
    assert rj.iterations > 2
    assert mst.run(g, max_iterations=2, warmup=False).iterations == 2


def test_float_order_key_matches_jax():
    w = np.array([-3.5, -0.0, 0.0, 1e-30, 1.0, 2.5, 63.9, -1e9, np.inf],
                 np.float32)
    k = mst._float_order_key(torch.from_numpy(w))
    assert np.array_equal(k.numpy(),
                          np.asarray(jmst._float_order_key(jnp.asarray(w))))
    assert np.array_equal(np.argsort(k.numpy(), kind="stable"),
                          np.argsort(w, kind="stable"))


COMBINE_CASES = [(c, dt) for c in Combine
                 for dt in ((np.float32, np.int32) if c in (
                     Combine.SUM, Combine.MIN, Combine.MAX) else (np.bool_,))]


@pytest.mark.parametrize("combine,dtype", COMBINE_CASES)
def test_segment_combine_matches_jax(combine, dtype):
    """Unsorted keys with empty segments and dropped (negative and too
    large) ids, seeded."""
    rng = np.random.default_rng(17)
    n, s = 500, 40
    ids = rng.integers(-3, s + 3, n).astype(np.int32)
    ids[ids == 7] = 8                                   # an empty segment
    if dtype == np.bool_:
        data = rng.random(n) < 0.3
    elif dtype == np.int32:
        data = rng.integers(-1000, 1000, n).astype(np.int32)
    else:
        data = rng.standard_normal(n).astype(np.float32)
    got = segment.segment_combine(torch.from_numpy(data),
                                  torch.from_numpy(ids), s, combine)
    want = np.asarray(jseg.segment_combine(
        jnp.asarray(data), jnp.asarray(ids), s, JCombine(combine.value),
        indices_are_sorted=False))
    assert got.shape == (s,)
    if dtype == np.float32 and combine == Combine.SUM:
        assert np.allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)
    else:
        assert np.array_equal(got.numpy(), want)


def test_apply_permutation_matches_jax():
    rng = np.random.default_rng(23)
    rank = rng.permutation(1000).astype(np.int32)
    a = rng.integers(0, 1 << 30, 1000).astype(np.int32)
    b = rng.standard_normal(1000).astype(np.float32)
    ra, rb = segment.apply_permutation(torch.from_numpy(rank),
                                       torch.from_numpy(a),
                                       torch.from_numpy(b))
    ja, jb = jseg.apply_permutation(jnp.asarray(rank), jnp.asarray(a),
                                    jnp.asarray(b))
    assert np.array_equal(ra.numpy(), np.asarray(ja))
    assert np.array_equal(rb.numpy(), np.asarray(jb))
    one = segment.apply_permutation(torch.from_numpy(rank),
                                    torch.from_numpy(a))
    assert torch.equal(one, ra)
    assert np.array_equal(one.numpy()[rank], a)
