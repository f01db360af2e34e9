"""Port parity: essentials_tpu_torch's k-core (ops.fused_kcore,
algorithms.kcore and the kernel wrappers' plain versions) against
essentials_tpu's, on the CPU.

Every value is an integer, so the tolerance is exact equality: degrees and
core numbers at segment starts after each wave (the port writes only
starts, the JAX CPU fallback whole segments), both scalars of each wave,
the core numbers and the wave count of a whole run, and the host
references. The JAX graphs are built with router plans and carried into
the port with graph_from_arrays, so both packages compute on the same
arrays. "stress" is chip_smoke's graph with a hub, multi-edges and
self-loops; "chord_cycle" and "cycles300" are directed graphs whose every
in-degree equals its out-degree (a symmetric layout without a symmetric
adjacency). On these the card's push wave is also modelled here.

The adaptive variant is held against the JAX package's run(variant=
"adaptive") on graphs built without router plans (its CPU path): core
numbers, wave counts and the host reference exactly, with the spray forced
on, forced off and left to the graph's size, and once with the spray gate
opened in both packages so that every branch fires."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import kcore as jkcore
from essentials_tpu.formats import Coo as JCoo
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.ops import cube_router
from essentials_tpu.ops import fused_kcore as jfk
from essentials_tpu.ops import sparse_advance as jsa

from essentials_tpu_torch import kernels
from essentials_tpu_torch.algorithms import kcore as tkcore
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import fused_kcore as tfk
from essentials_tpu_torch.ops import sparse_advance as tsa

IMAX = np.iinfo(np.int32).max
_jax_sweep = jax.jit(jfk.fused_kcore_sweep_ref)


def chip_smoke():
    """chip_smoke.py as a module (its graphs), by its path."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def stress_coo():
    """chip_smoke.kcore_stress_coo's graph as a JAX Coo."""
    n, src, dst, w = chip_smoke().kcore_stress_coo()
    return JCoo(n, n, src, dst, w)


def carried(csr, directed=False):
    """The JAX graph (with router plans) and the port's graph made from its
    fields."""
    gj = jbuild(csr, directed=directed, weighted=True, build_router=True)
    fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return csr, gj, graph_from_arrays(fields, meta, "cpu")


def isolated_coo():
    """12 vertices; 0, 5 and 9 have no edges; a triangle with a tail and a
    4-cycle with a chord."""
    pairs = [(1, 2), (2, 3), (1, 3), (3, 4), (6, 7), (7, 8), (8, 10),
             (10, 6), (6, 8), (10, 11)]
    a, b = (np.array(x, np.int32) for x in zip(*pairs))
    return JCoo(12, 12, np.concatenate([a, b]), np.concatenate([b, a]),
                np.ones(2 * a.size, np.float32))


def chord_cycle_coo():
    """A directed 5-cycle with a chord both ways (0 -> 2, 2 -> 0): every
    in-degree equals its out-degree (a symmetric layout) but the adjacency
    is not symmetric."""
    src = np.array([0, 1, 2, 3, 4, 0, 2], np.int32)
    dst = np.array([1, 2, 3, 4, 0, 2, 0], np.int32)
    return JCoo(5, 5, src, dst, np.ones(7, np.float32))


def cycles_coo():
    """chip_smoke.cycles_coo: a union of directed cycles over random
    vertices of 300, degree-balanced, not symmetric (cores 1 and 2, 9
    waves)."""
    n, src, dst, w = chip_smoke().cycles_coo(300, (300, 200, 150, 100, 80,
                                                    40), 3)
    return JCoo(n, n, src, dst, w)


def clique_tail_coo():
    """The 4-clique with a pendant path of tests/test_algorithms.py."""
    edges = [(a, b) for a in range(4) for b in range(4) if a != b]
    edges += [(3, 4), (4, 3), (4, 5), (5, 4)]
    src = np.array([e[0] for e in edges], np.int32)
    dst = np.array([e[1] for e in edges], np.int32)
    return JCoo(6, 6, src, dst, np.ones(len(edges), np.float32))


@pytest.fixture(scope="module")
def graphs():
    return {
        "rmat10": carried(JCsr.from_coo(jgen.rmat(10, 16, seed=4,
                                                  undirected=True,
                                                  weighted=True))),
        "rmat11": carried(JCsr.from_coo(jgen.rmat(11, 8, seed=2,
                                                  undirected=True,
                                                  weighted=True))),
        "grid16": carried(JCsr.from_coo(jgen.grid_2d(16, weighted=True))),
        "isolated": carried(JCsr.from_coo(isolated_coo())),
        "clique_tail": carried(JCsr.from_coo(clique_tail_coo())),
        "stress": carried(JCsr.from_coo(stress_coo())),
        # degree-balanced directed: a push along the CSC sources instead of
        # the CSR columns would subtract from the wrong neighbours
        "chord_cycle": carried(JCsr.from_coo(chord_cycle_coo()),
                               directed=True),
        "cycles300": carried(JCsr.from_coo(cycles_coo()), directed=True),
    }


NAMES = ["chord_cycle", "clique_tail", "cycles300", "grid16", "isolated",
         "rmat10", "rmat11", "stress"]


def starts_of(g):
    off = g.row_offsets.numpy()
    return off[:-1][off[1:] > off[:-1]]


@pytest.mark.parametrize("name", NAMES)
def test_sweeps_match_jax_fallback(graphs, name):
    _, gj, g = graphs[name]
    starts = starts_of(g)
    dj = jfk.init_deg_exp(gj)
    cj = jax.numpy.zeros_like(dj)
    d = tfk.init_deg_exp(g)
    assert np.array_equal(d.numpy(), np.asarray(dj))
    c = torch.zeros_like(d)
    d2, c2 = d.clone(), c.clone()
    k = tfk.first_level(g)
    sweeps = 0
    while k < IMAX:
        dj, cj, cnt_j, ma_j = _jax_sweep(gj, dj, cj, k)
        scalars = tfk.fused_kcore_sweep(g, d, c, k, d2, c2)
        d, d2, c, c2 = d2, d, c2, c
        assert scalars.dtype == torch.int32 and scalars.shape == (2,)
        peeled, min_alive = scalars.tolist()
        assert (peeled, min_alive) == (int(cnt_j[0, 0]), int(ma_j[0, 0]))
        assert peeled > 0, sweeps                # every wave peels
        assert np.array_equal(d.numpy()[starts], np.asarray(dj)[starts])
        assert np.array_equal(c.numpy()[starts], np.asarray(cj)[starts])
        k = tfk.next_level(k, min_alive)
        sweeps += 1
    assert sweeps >= 2


def push_wave(off, col, deg, core, k):
    """The card's kcore_sweep in NumPy, in its order of work: the dense
    pass writes every start as if nothing fell and lists the peeled
    vertices' CSR rows; the push takes one from each surviving
    out-neighbour's start, in a shuffled order, folding each result into
    the minimum. Returns (deg_out, core_out, peeled, smallest surviving
    degree)."""
    deg_out, core_out = deg.copy(), core.copy()
    starts = off[:-1][off[1:] > off[:-1]]
    d = deg[starts]
    peel = (d >= 0) & (d < k)
    deg_out[starts[peel]] = -1
    core_out[starts[peel]] = k - 1
    least = int(d[(d >= 0) & ~peel].min()) if ((d >= 0) & ~peel).any() \
        else IMAX
    v = np.nonzero(off[1:] > off[:-1])[0][peel]
    slots = np.concatenate([np.arange(off[x], off[x + 1]) for x in v]) \
        if v.size else np.zeros(0, np.int64)
    for q in np.random.default_rng(k).permutation(slots):
        at = off[col[q]]
        if deg[at] >= k:
            deg_out[at] -= 1
            least = min(least, int(deg_out[at]))
    return deg_out, core_out, int(peel.sum()), least


@pytest.mark.parametrize("name", ["chord_cycle", "clique_tail", "cycles300",
                                  "isolated", "stress"])
def test_push_wave_model_matches_plain_version(graphs, name):
    """On a symmetric layout the push (each peeled vertex takes one from
    its surviving out-neighbours along its CSR row, the minimum folded from
    the subtractions' results) gives the pull's bits at every wave of a
    run, on undirected and on degree-balanced directed graphs."""
    _, _, g = graphs[name]
    off, col = g.row_offsets.numpy(), g.col_indices.numpy()
    assert g.symmetric_layout
    d, c = tfk.init_deg_exp(g), torch.zeros_like(tfk.init_deg_exp(g))
    k, waves = tfk.first_level(g), 0
    while k < IMAX:
        d2, c2 = torch.empty_like(d), torch.empty_like(c)
        peeled, least = kernels.kcore_sweep_plain(
            d, c, d2, c2, g.row_offsets, g.csc_src_indices, g.col_indices,
            k).tolist()
        md, mc, mp, ml = push_wave(off, col, d.numpy(), c.numpy(), k)
        starts = starts_of(g)
        assert (mp, ml) == (peeled, least)
        assert np.array_equal(md[starts], d2.numpy()[starts])
        assert np.array_equal(mc[starts], c2.numpy()[starts])
        d, c, waves = d2, c2, waves + 1
        k = tfk.next_level(k, least)
    assert waves >= 2


@pytest.mark.parametrize("name", NAMES)
def test_expand_segments_matches_jax_expand(graphs, name):
    """The expansion under init_deg_exp against JAX's
    expand_vertex_to_edges, on values from a seed, bitwise."""
    from essentials_tpu.ops.segment import expand_vertex_to_edges
    _, gj, g = graphs[name]
    vals = np.random.default_rng(5).integers(
        -2**31, 2**31, g.n_vertices_padded, dtype=np.int64).astype(np.int32)
    ref = expand_vertex_to_edges(jax.numpy.asarray(vals), gj.row_offsets,
                                 gj.n_edges_padded)
    out = kernels.expand_segments(torch.from_numpy(vals), g.row_offsets,
                                  g.n_edges_padded)
    assert out.dtype == torch.int32
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("k_step", [0, 1])
def test_sweep_matches_pallas_pipeline(graphs, k_step):
    """One wave against the three Pallas kernels, run in interpret mode off
    the TPU: the first wave, and one from a state two fallback waves in."""
    _, gj, g = graphs["rmat10"]
    assert isinstance(gj.route_fwd, cube_router.CubePlan)
    dj = jfk.init_deg_exp(gj)
    cj = jax.numpy.zeros_like(dj)
    k = tfk.first_level(g)
    for _ in range(2 * k_step):
        dj, cj, _, ma = _jax_sweep(gj, dj, cj, k)
        k = tfk.next_level(k, int(ma[0, 0]))
    od, oc, cnt_j, ma_j = jfk.fused_kcore_sweep(gj, dj, cj, k)
    d, c = torch.from_numpy(np.array(dj)), torch.from_numpy(np.array(cj))
    d2, c2 = d.clone(), c.clone()
    peeled, min_alive = tfk.fused_kcore_sweep(g, d, c, k, d2, c2).tolist()
    starts = starts_of(g)
    assert peeled == int(cnt_j[0, 0]) > 0
    assert min_alive == int(ma_j[0, 0])
    assert np.array_equal(d2.numpy()[starts], np.asarray(od)[starts])
    assert np.array_equal(c2.numpy()[starts], np.asarray(oc)[starts])


@pytest.mark.parametrize("variant", ["fused", "auto"])
@pytest.mark.parametrize("name", NAMES)
def test_run_matches_jax_and_cpu_reference(graphs, name, variant):
    csr, gj, g = graphs[name]
    r = tkcore.run(g, variant=variant, warmup=False)
    assert r.core.dtype == torch.int32 and r.core.shape == (g.n_vertices,)
    rj = jkcore.run(gj, variant="fused", warmup=False)
    assert np.array_equal(r.core.numpy(), np.asarray(rj.core))
    assert r.iterations == rj.iterations
    assert np.array_equal(r.core.numpy(), jkcore.cpu_reference(csr))


@pytest.mark.parametrize("name", NAMES)
def test_vectorised_cpu_reference_matches_jax(graphs, name):
    csr = graphs[name][0]
    ref = jkcore.cpu_reference(csr)
    assert np.array_equal(tkcore.cpu_reference(csr), ref)


def test_known_core_numbers(graphs):
    assert tkcore.run(graphs["clique_tail"][2]).core.tolist() == \
        [3, 3, 3, 3, 1, 1]
    assert tkcore.run(graphs["isolated"][2]).core.tolist() == \
        [0, 2, 2, 2, 1, 0, 2, 2, 2, 0, 2, 1]


def test_edgeless_graph_runs_no_wave():
    """With no edges the JAX package's k0 = IMAX + 1 wraps in int32, so it
    runs one empty wave (ROADMAP queue 3); the port runs none. Both give
    core 0 everywhere."""
    e = np.zeros(0, np.int32)
    _, gj, g = carried(JCsr.from_coo(JCoo(5, 5, e, e,
                                          np.zeros(0, np.float32))))
    assert jkcore.run(gj, variant="fused", warmup=False).iterations == 1
    r = tkcore.run(g, warmup=False)
    assert r.iterations == 0 and r.core.tolist() == [0] * 5


# -------------------------------------------------------------- refusals --

def test_unported_and_unsupported_runs_raise(graphs):
    """adaptive, and a graph without a symmetric layout (auto: adaptive),
    no longer raise: they run and give the host's core numbers; fused on
    such a graph and an unknown variant raise."""
    csr, _, g = graphs["grid16"]
    r = tkcore.run(g, variant="adaptive")
    assert r.core.tolist() == tkcore.cpu_reference(csr).tolist()
    assert sum(r.tiers) == r.iterations
    with pytest.raises(EssentialsError):
        tkcore.run(g, variant="onion")
    coo = jgen.rmat(8, 8, seed=2, undirected=False, weighted=True)
    csr_d, _, gd = carried(JCsr.from_coo(coo), directed=True)
    assert not gd.symmetric_layout
    assert tkcore.run(gd).core.tolist() == \
        tkcore.cpu_reference(csr_d).tolist()
    with pytest.raises(EssentialsError, match="symmetric layout"):
        tkcore.run(gd, variant="fused")
    # a directed 5-cycle with a chord both ways: every in-degree equals its
    # out-degree (a symmetric layout) but the adjacency is not symmetric;
    # it runs, as the JAX package runs it
    csr, gj, gc = graphs["chord_cycle"]
    assert gc.symmetric_layout and tkcore.fused_supported(gc)
    assert not torch.equal(gc.col_indices, gc.csc_src_indices)
    r = tkcore.run(gc)
    assert r.core.tolist() == jkcore.cpu_reference(csr).tolist() \
        == np.asarray(jkcore.run(gj, variant="fused").core).tolist()


# -------------------------------------------------------------- adaptive --

def carried_plain(coo, directed):
    """The host csr, the JAX graph without router plans (its CPU path) and
    the port's graph made from its fields."""
    csr = JCsr.from_coo(coo)
    gj = jbuild(csr, directed=directed, weighted=True, build_router=False)
    fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return csr, gj, graph_from_arrays(fields, meta, "cpu")


def directed_hubs_coo():
    """stress_coo's pairs one way only (src < dst): a directed graph with
    a hub, multi-edges and no symmetric layout."""
    c = stress_coo()
    keep = c.row_indices < c.col_indices
    return JCoo(c.n_rows, c.n_cols, c.row_indices[keep], c.col_indices[keep],
                c.values[keep])


ADAPTIVE = {
    "rmat8d": lambda: carried_plain(jgen.rmat(8, 8, seed=2, undirected=False,
                                              weighted=True), True),
    "rmat9u": lambda: carried_plain(jgen.rmat(9, 8, seed=2, undirected=True,
                                              weighted=True), False),
    "rmat10d": lambda: carried_plain(jgen.rmat(10, 16, seed=3,
                                               undirected=False,
                                               weighted=True), True),
    "stress": lambda: carried_plain(stress_coo(), False),
    "hubs_d": lambda: carried_plain(directed_hubs_coo(), True),
}


@pytest.fixture(scope="module")
def adaptive_graphs():
    return {name: make() for name, make in ADAPTIVE.items()}


@pytest.mark.parametrize("override", [None, True, False])
@pytest.mark.parametrize("name", list(ADAPTIVE))
def test_adaptive_matches_jax_and_cpu_reference(adaptive_graphs, name,
                                                override):
    csr, gj, g = adaptive_graphs[name]
    r = tkcore.run(g, variant="adaptive", warmup=False,
                   spray_override=override)
    rj = jkcore.run(gj, variant="adaptive", warmup=False,
                    spray_override=override)
    assert r.core.dtype == torch.int32 and r.core.shape == (g.n_vertices,)
    assert np.array_equal(r.core.numpy(), np.asarray(rj.core))
    assert r.iterations == rj.iterations == sum(r.tiers)
    assert np.array_equal(r.core.numpy(), tkcore.cpu_reference(csr))
    skip, tiny, spray, dense = r.tiers
    if override:                 # the spray takes every small peel set
        assert tiny + spray > 0 and r.compactions <= spray + tiny
    else:                        # E < 2^21: the spray gate is closed
        assert tiny == spray == r.compactions == 0 and dense > 0


def test_adaptive_auto_on_a_directed_graph(adaptive_graphs):
    """auto is adaptive where fused is unsupported, as in the JAX package."""
    _, gj, g = adaptive_graphs["rmat10d"]
    assert not tkcore.fused_supported(g)
    r = tkcore.run(g, warmup=False)
    rj = jkcore.run(gj, warmup=False)
    assert np.array_equal(r.core.numpy(), np.asarray(rj.core))
    assert r.iterations == rj.iterations and sum(r.tiers) == r.iterations


def test_adaptive_every_branch_with_the_spray_gate_open(monkeypatch):
    """With _MIN_EDGES at 0 in both packages (and JAX's traced enactor
    dropped), undirected rmat13 ef16 takes every branch: skip, tiny spray,
    spray (filtering the candidate list and compacting the peel set) and
    dense; core numbers and waves exact."""
    monkeypatch.setattr(jsa, "_MIN_EDGES", 0)
    monkeypatch.setattr(tsa, "_MIN_EDGES", 0)
    jax.clear_caches()
    try:
        csr, gj, g = carried_plain(jgen.rmat(13, 16, seed=2, undirected=True,
                                             weighted=True), False)
        r = tkcore.run(g, variant="adaptive", warmup=False)
        rj = jkcore.run(gj, variant="adaptive", warmup=False)
    finally:
        jax.clear_caches()
    assert np.array_equal(r.core.numpy(), np.asarray(rj.core))
    assert r.iterations == rj.iterations
    assert np.array_equal(r.core.numpy(), tkcore.cpu_reference(csr))
    assert all(n > 0 for n in r.tiers), r.tiers
    assert 0 < r.compactions < r.tiers[1] + r.tiers[2]


def test_adaptive_wave_choice():
    """branch_of follows the JAX package's switch at its edges."""
    b = tkcore.branch_of
    tk, tb, sk, sb = tsa.TINY_K, tsa.TINY_BUDGET, tsa.SPRAY_K, tsa.SPRAY_BUDGET
    assert b(0, 0, True, True, True) == b(0, 0, True, True, False) == 0
    assert b(tk, tb, True, True, True) == 1
    assert b(tk, tb, False, True, True) == 2          # list tail not pad
    assert b(tk, tb, True, False, True) == 2          # list not current
    assert b(tk + 1, tb, True, True, True) == 2
    assert b(tk, tb + 1, True, True, True) == 2
    assert b(sk, sb, True, False, True) == 2
    assert b(sk + 1, sb, True, True, True) == 3
    assert b(sk, sb + 1, True, True, True) == 3
    assert b(1, 1, True, True, False) == 3            # spray off: dense


# -------------------------------------------------------------- wrappers --

def test_wrappers_take_plain_version_on_cpu(graphs):
    _, _, g = graphs["rmat10"]
    kernels.reset_launches()
    d = tfk.init_deg_exp(g)
    c = torch.zeros_like(d)
    k = tfk.first_level(g)
    outs = [t.clone() for t in (d, c, d, c)]
    adj = (g.row_offsets, g.csc_src_indices, g.col_indices, k)
    s = kernels.kcore_sweep(d, c, outs[0], outs[1], *adj)
    s_p = kernels.kcore_sweep_plain(d, c, outs[2], outs[3], *adj)
    assert torch.equal(s, s_p) and torch.equal(outs[0], outs[2])
    assert torch.equal(outs[1], outs[3])
    tfk.collapse_core_exp(g, outs[1])
    assert all(n == 0 for n in kernels.launches.values())


def test_wrapper_raises_on_other_devices(graphs):
    g = graphs["clique_tail"][2].to("meta")
    d = torch.empty(g.n_edges_padded, dtype=torch.int32, device="meta")
    with pytest.raises(EssentialsError):
        kernels.kcore_sweep(d, d.clone(), d.clone(), d.clone(),
                            g.row_offsets, g.csc_src_indices, g.col_indices,
                            1)
    vals = torch.empty(g.n_vertices_padded, dtype=torch.int32, device="meta")
    with pytest.raises(EssentialsError):
        kernels.expand_segments(vals, g.row_offsets, g.n_edges_padded)


def test_wrapper_rejects_bad_arguments(graphs):
    _, _, g = graphs["clique_tail"]
    off, src, col = g.row_offsets, g.csc_src_indices, g.col_indices
    d = tfk.init_deg_exp(g)
    c = torch.zeros_like(d)
    vals = g.out_degrees().int()
    ep = g.n_edges_padded
    bad = [
        lambda: kernels.expand_segments(vals.long(), off, ep),
        lambda: kernels.expand_segments(vals[1:], off, ep),
        lambda: kernels.expand_segments(vals, off.long(), ep),
        lambda: kernels.expand_segments(vals, off, ep + 1),   # not covered
        lambda: kernels.expand_segments(vals, off, -1),
        lambda: kernels.kcore_sweep(d, c, d, c.clone(), off, src, col, 2),
        lambda: kernels.kcore_sweep(d, c, c.clone(), c, off, src, col, 2),
        lambda: kernels.kcore_sweep(d, c, d.clone()[1:], c.clone(), off,
                                    src, col, 2),
        lambda: kernels.kcore_sweep(d.long(), c, d.clone(), c.clone(), off,
                                    src, col, 2),
        lambda: kernels.kcore_sweep(d, c, d.clone(), c.clone(), off,
                                    src[:-1], col, 2),
        lambda: kernels.kcore_sweep(d, c, d.clone(), c.clone(), off, src,
                                    col[:-1], 2),
        lambda: kernels.kcore_sweep(d, c, d.clone(), c.clone(), off, src,
                                    col, 2**31),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(EssentialsError):
            call()
            pytest.fail(f"case {i} did not raise")
