"""The benchmark's generators and device layout, on the CPU."""

import numpy as np
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from essentials_tpu_torch.graph.graph import ARRAY_FIELDS
from graphbench import graphs
from graphbench.tests.helpers import small_cell

CONFIGS = ("kron24", "urand24")


def _make(name, seed, scale=9):
    return graphs.make(small_cell(f"{name}.bfs", scale).config, seed, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_generation_repeats_by_seed(name):
    f1, m1 = _make(name, 2**33 + 7)
    f2, m2 = _make(name, 2**33 + 7)
    f3, _ = _make(name, 2**33 + 8)
    assert m1 == m2
    assert all(torch.equal(f1[k], f2[k]) for k in ARRAY_FIELDS)
    assert not torch.equal(f1["col_indices"], f3["col_indices"])


@pytest.mark.parametrize("name", CONFIGS)
@pytest.mark.parametrize("seed", [1, 2**31 + 5])
def test_layout_equals_build_graph(name, seed):
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    fields, meta = _make(name, seed)
    c = graphs.csr_of(fields, meta)
    host = Csr(c.n, c.n, c.row_offsets.numpy(), c.col.numpy(),
               c.values.numpy())
    ref = build_graph(host, directed=False, weighted=True, device="cpu")
    for k in ARRAY_FIELDS:
        mine, theirs = fields[k], getattr(ref, k)
        assert mine.dtype == theirs.dtype, k
        assert torch.equal(mine, theirs), k
    for k, v in meta.items():
        assert getattr(ref, k) == v, k
    g = graphs.program_graph(fields, meta)
    assert g.symmetric_layout and not g.properties.directed


@pytest.mark.parametrize("name", CONFIGS)
def test_graph_is_simple_and_symmetric(name):
    fields, meta = _make(name, 3)
    c = graphs.csr_of(fields, meta)
    src = graphs.rows_of(c).long()
    col = c.col.long()
    assert bool((src != col).all())                     # no self-loops
    keys = src * c.n + col
    assert bool((keys[1:] > keys[:-1]).all())           # sorted, distinct
    rev = torch.sort(col * c.n + src).values
    assert torch.equal(rev, keys)                       # symmetric
    w = dict(zip(keys.tolist(), c.values.tolist()))
    assert all(w[int(v) * c.n + int(u)] == x for u, v, x in
               zip(src.tolist(), col.tolist(), c.values.tolist()))
    assert bool((c.values >= 0).all() and (c.values < 1).all())


def test_kronecker_quadrant_shares():
    """Graph500's probabilities: at scale 1 each pair lands in quadrant
    (0,0) with A, (0,1) with B, (1,0) with C, (1,1) with D."""
    cfg = dict(small_cell("kron24.bfs").config, scale=1, edge_factor=100000)
    gen = graphs.generator(5, "graph", "cpu")
    u, v = graphs.kronecker_bits(cfg, gen, "cpu")
    m = u.numel()
    shares = [float(((u == i) & (v == j)).sum()) / m
              for i, j in ((0, 0), (0, 1), (1, 0), (1, 1))]
    assert np.allclose(shares, [0.57, 0.19, 0.19, 0.05], atol=0.01)


@pytest.mark.parametrize("name", CONFIGS)
def test_component_edge_counts(name):
    """Graph500's count for a query: the undirected edges of the source's
    component, against scipy's components."""
    fields, meta = _make(name, 11, scale=8)
    c = graphs.csr_of(fields, meta)
    label, per_root = graphs.components(c)
    a = csr_matrix((np.ones(c.n_edges), c.col.numpy(), c.row_offsets.numpy()),
                   shape=(c.n, c.n))
    _, lab = connected_components(a, directed=False)
    deg = np.diff(c.row_offsets.numpy())
    want = np.bincount(lab, weights=deg) / 2
    got = per_root[label].numpy()
    assert np.array_equal(got, want[lab])
    assert int(per_root.sum()) * 2 == c.n_edges


def test_fingerprint_sees_a_write():
    fields, meta = _make("kron24", 4)
    c = graphs.csr_of(fields, meta)
    before = graphs.fingerprint(c)
    c.col[5] += 1
    assert graphs.fingerprint(c) != before
