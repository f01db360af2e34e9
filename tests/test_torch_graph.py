"""Port parity: essentials_tpu_torch's build_graph and graph_from_arrays
against essentials_tpu's build_graph(..., build_router=True), field by
field, with exact equality (every field is an index, a flag or a copied
weight)."""

import os

import numpy as np
import pytest
import torch

from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen, load_graph_file as jload
from essentials_tpu.io.sample import sample_csr as jsample

from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.formats import Csr as TCsr
from essentials_tpu_torch.graph import build_graph, graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.io import generate as tgen, load_graph_file as tload
from essentials_tpu_torch.io.sample import sample_csr as tsample

CHESAPEAKE = os.path.join(os.path.dirname(__file__), "..", "datasets",
                          "chesapeake.mtx")

CASES = {
    "sample": (lambda: tsample(), lambda: jsample(), True, True),
    "chesapeake": (lambda: tload(CHESAPEAKE, cache=False),
                   lambda: jload(CHESAPEAKE, cache=False), False, False),
    "rmat10": (lambda: TCsr.from_coo(tgen.rmat(10, 8, seed=4)),
               lambda: JCsr.from_coo(jgen.rmat(10, 8, seed=4)), False, True),
    "grid24": (lambda: TCsr.from_coo(tgen.grid_2d(24)),
               lambda: JCsr.from_coo(jgen.grid_2d(24)), False, False),
    "directed": (lambda: TCsr.from_coo(tgen.uniform_random(
                     300, 4, seed=9, undirected=False)),
                 lambda: JCsr.from_coo(jgen.uniform_random(
                     300, 4, seed=9, undirected=False)), True, True),
}


def jax_fields(gj):
    return ({f: None if getattr(gj, f) is None else np.asarray(getattr(gj, f))
             for f in ARRAY_FIELDS},
            {f: getattr(gj, f) for f in META_FIELDS})


def assert_graph_equals(g, fields, meta):
    for f in ARRAY_FIELDS:
        a, b = getattr(g, f), fields[f]
        if b is None:
            assert a is None, f
            continue
        a = a.cpu().numpy()
        assert a.dtype == b.dtype, f
        assert np.array_equal(a, b), f
    for f in META_FIELDS:
        a, b = getattr(g, f), meta[f]
        if f == "properties":
            a, b = (a.directed, a.weighted), (b.directed, b.weighted)
        assert a == b, f


@pytest.mark.parametrize("case", sorted(CASES))
def test_build_graph_matches_jax(case):
    tcsr, jcsr, directed, weighted = CASES[case]
    g = build_graph(tcsr(), directed=directed, weighted=weighted,
                    device="cpu")
    gj = jbuild(jcsr(), directed=directed, weighted=weighted,
                build_router=True)
    fields, meta = jax_fields(gj)
    assert_graph_equals(g, fields, meta)
    # the JAX graph's fields carried into the port give the same graph
    assert_graph_equals(graph_from_arrays(fields, meta, "cpu"), fields, meta)


def test_build_graph_without_csc():
    g = build_graph(tsample(), build_csc=False, device="cpu")
    gj = jbuild(jsample(), build_csc=False)
    fields, meta = jax_fields(gj)
    assert_graph_equals(g, fields, meta)
    assert not g.has_csc and not g.symmetric_layout


def test_padding_contract():
    g = build_graph(TCsr.from_coo(tgen.chain(10)), directed=False,
                    weighted=False, device="cpu")
    v, e, ep = g.n_vertices, g.n_edges, g.n_edges_padded
    assert g.pad_vertex == v and g.n_vertices_padded >= v + 1
    assert torch.all(g.row_offsets[v + 1:] == ep)
    assert torch.all(g.src_indices[e:] == v)
    assert torch.all(g.col_indices[e:] == v)
    assert torch.all(g.values[e:] == 0)
    assert g.symmetric_layout
    assert torch.equal(g.out_degrees(), g.in_degrees())


def test_graph_to_and_frozen():
    g = build_graph(tsample(), device="cpu")
    h = g.to("cpu")
    for f in ARRAY_FIELDS:
        assert torch.equal(getattr(g, f), getattr(h, f))
    assert h.device == torch.device("cpu")
    with pytest.raises(Exception):
        g.n_vertices = 3


def test_build_graph_rejects_non_square():
    csr = TCsr(2, 3, np.array([0, 1, 1]), np.array([2]), np.array([1.0]))
    with pytest.raises(EssentialsError):
        build_graph(csr, device="cpu")


def test_graph_from_arrays_rejects_missing_fields():
    g = build_graph(tsample(), device="cpu")
    fields = {f: getattr(g, f).numpy() for f in ARRAY_FIELDS}
    meta = {f: getattr(g, f) for f in META_FIELDS}
    del fields["csc_rank"]
    with pytest.raises(EssentialsError):
        graph_from_arrays(fields, meta, "cpu")
