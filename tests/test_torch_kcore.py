"""Port parity: essentials_tpu_torch's k-core (ops.fused_kcore,
algorithms.kcore and the kernel wrappers' plain versions) against
essentials_tpu's, on the CPU.

Every value is an integer, so the tolerance is exact equality: degrees and
core numbers at segment starts after each wave (the port writes only
starts, the JAX CPU fallback whole segments), each wave's k and peeled
count against JAX's, its candidate list against the survivors left below
k (the next wave's peel set, each listed once), the core numbers and the
wave count of a whole run, and the host references. The JAX graphs are built with router plans and carried into
the port with graph_from_arrays, so both packages compute on the same
arrays. "stress" is chip_smoke's graph with a hub, multi-edges and
self-loops; "chord_cycle" and "cycles300" are directed graphs whose every
in-degree equals its out-degree (a symmetric layout without a symmetric
adjacency). On these, on Kronecker graphs of the benchmark's generator and
on a directed graph with a hub, the card's waves are also modelled here in
their order of work.

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
from graphbench import graphs as bgraphs

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


def jax_first_level(deg, starts) -> int:
    """The JAX package's k0 (run_fused_kcore): the smallest alive start
    degree + 1, IMAX when none."""
    d = deg[starts]
    return min(int(d[d >= 0].min()) + 1, IMAX) if (d >= 0).any() else IMAX


def jax_next_level(k: int, min_alive: int) -> int:
    """The JAX package's k after a wave at k whose smallest surviving
    degree is ``min_alive`` (run_fused_kcore's body)."""
    if min_alive < k:
        return k
    return IMAX if min_alive == IMAX else min_alive + 1


def alive_below(g, deg, k: int) -> set:
    """The vertices alive at their start with degree below k: the next
    wave's peel set."""
    off = g.row_offsets.numpy()
    v = np.nonzero(off[1:] > off[:-1])[0]
    d = np.asarray(deg)[off[v]]
    return set(v[(d >= 0) & (d < k)].tolist())


@pytest.mark.parametrize("name", NAMES)
def test_sweeps_match_jax_fallback(graphs, name):
    """Every wave of a run against the JAX fallback's wave at the same k:
    the k (JAX's schedule), the peeled count, every start's degree and
    core bits, and the candidate list: the survivors below k, listed
    where and only where JAX's smallest survivor is below k."""
    _, gj, g = graphs[name]
    starts = starts_of(g)
    dj = jfk.init_deg_exp(gj)
    cj = jax.numpy.zeros_like(dj)
    d = tfk.init_deg_exp(g)
    assert np.array_equal(d.numpy(), np.asarray(dj))
    c = torch.zeros_like(d)
    cand_in, cand_out, scratch = tfk.wave_buffers(g)
    k, n_in, sweeps = jax_first_level(d.numpy(), starts), 0, 0
    while k < IMAX:
        dj, cj, cnt_j, ma_j = _jax_sweep(gj, dj, cj, k)
        scalars = tfk.fused_kcore_sweep(g, d, c, k, n_in, cand_in, cand_out,
                                        scratch)
        assert scalars.dtype == torch.int32 and scalars.shape == (4,)
        peeled, n_out, _, k_wave = scalars.tolist()
        assert k_wave == k, sweeps               # JAX's k schedule
        assert peeled == int(cnt_j[0, 0]) > 0, sweeps
        assert np.array_equal(d.numpy()[starts], np.asarray(dj)[starts])
        assert np.array_equal(c.numpy()[starts], np.asarray(cj)[starts])
        min_alive = int(ma_j[0, 0])
        assert (n_out > 0) == (min_alive < k)
        got = cand_out[:n_out].tolist()
        assert len(set(got)) == n_out and set(got) == alive_below(g, d, k)
        cand_in, cand_out, n_in = cand_out, cand_in, n_out
        k = jax_next_level(k, min_alive)
        sweeps += 1
    assert sweeps >= 2 and n_in == 0


def push_wave(off, col, deg, core, k, cand, seed):
    """The card's wave in NumPy, in its order of work. The pass: a level
    wave (``cand`` None) takes k = the smallest alive start degree + 1 and
    marks the alive starts below it; a cascade marks the listed vertices.
    The push then takes each marked vertex's CSR slots in a shuffled order:
    an alive target (start >= 0) loses one, and the subtraction that
    returns exactly k appends it to the next list. Returns (deg, core,
    peeled, ranges listed, next list, k)."""
    deg, core = deg.copy(), core.copy()
    v = np.nonzero(off[1:] > off[:-1])[0]
    if cand is None:
        d = deg[off[v]]
        alive = d >= 0
        k = int(d[alive].min()) + 1 if alive.any() else IMAX
        cand = v[alive & (d < k)]
    deg[off[cand]] = -1
    core[off[cand]] = k - 1
    lens = off[cand + 1] - off[cand]
    slots = np.concatenate([np.arange(off[x], off[x + 1]) for x in cand]) \
        if cand.size else np.zeros(0, np.int64)
    out = []
    for q in np.random.default_rng(seed).permutation(slots):
        at = off[col[q]]
        if deg[at] >= 0:
            deg[at] -= 1
            if deg[at] == k - 1:
                out.append(int(col[q]))
    ranges = int(((lens + kernels.PUSH_SPLIT - 1) // kernels.PUSH_SPLIT).sum())
    return deg, core, int(cand.size), ranges, out, k


@pytest.mark.parametrize("name", ["chord_cycle", "clique_tail", "cycles300",
                                  "isolated", "stress"])
def test_push_wave_model_matches_plain_version(graphs, name):
    """On a symmetric layout the card's order of work (the pass marks the
    peel set, each peeled vertex takes one from its alive out-neighbours
    along its CSR row, and the subtraction that takes a degree from k to
    k - 1 lists its vertex) gives the pull's bits, scalars and candidate
    set at every wave of a run, each vertex listed once, on undirected and
    on degree-balanced directed graphs."""
    _, _, g = graphs[name]
    off, col = g.row_offsets.numpy(), g.col_indices.numpy()
    assert g.symmetric_layout
    starts = starts_of(g)
    d, c = tfk.init_deg_exp(g), torch.zeros_like(tfk.init_deg_exp(g))
    cand_in, cand_out, scratch = tfk.wave_buffers(g)
    n_in, k, waves, alive = 0, IMAX, 0, tfk.alive_vertices(g)
    while alive:
        model = push_wave(off, col, d.numpy(), c.numpy(), k,
                          cand_in[:n_in].numpy().astype(np.int64)
                          if n_in else None, waves)
        peeled, n_out, ranges, k = tfk.fused_kcore_sweep(
            g, d, c, k, n_in, cand_in, cand_out, scratch).tolist()
        md, mc, mp, mr, mlist, mk = model
        assert (mp, mr, len(mlist), mk) == (peeled, ranges, n_out, k)
        assert len(set(mlist)) == len(mlist)
        assert set(mlist) == set(cand_out[:n_out].tolist())
        assert np.array_equal(md[starts], d.numpy()[starts])
        assert np.array_equal(mc[starts], c.numpy()[starts])
        cand_in, cand_out, n_in = cand_out, cand_in, n_out
        alive, waves = alive - peeled, waves + 1
    assert waves >= 2


CASCADES = ["chord_cycle", "clique_tail", "cycles300", "stress", "kron10",
            "kron12", "hub"]


@pytest.fixture(scope="module")
def cascade_graphs(graphs):
    """Graphs with long cascades: four of ``graphs``, benchmark Kronecker
    graphs at scales 10 and 12, and a degree-balanced directed graph with a
    hub on 300 triangles."""
    out = {name: graphs[name][2] for name in CASCADES[:4]}
    for scale in (10, 12):
        cfg = {"generator": "kronecker", "edge_factor": 16, "a": 0.57,
               "b": 0.19, "c": 0.19, "scale": scale}
        out[f"kron{scale}"] = bgraphs.program_graph(*bgraphs.make(cfg, 3,
                                                                  "cpu"))
    n, src, dst, w = chip_smoke().cycles_coo(2000, (2000,) * 3, 5, 300)
    out["hub"] = carried(JCsr.from_coo(JCoo(n, n, src, dst, w)),
                         directed=True)[2]
    return out


@pytest.mark.parametrize("name", CASCADES)
def test_candidate_list_is_the_next_peel_set(cascade_graphs, name):
    """After every wave of a run, on the plain route and in the card's
    order of work (``push_wave``, from its own state and lists), the
    candidate list holds each alive vertex of degree below k once and
    nothing else; a run counts its waves, and as levels the waves that
    ran from no list."""
    g = cascade_graphs[name]
    assert g.symmetric_layout
    off, col = g.row_offsets.numpy(), g.col_indices.numpy()
    starts = starts_of(g)
    d = tfk.init_deg_exp(g)
    c = torch.zeros_like(d)
    cand_in, cand_out, scratch = tfk.wave_buffers(g)
    md, mc, mlist = d.numpy().copy(), c.numpy().copy(), []
    n_in, k, waves, cascades = 0, IMAX, 0, 0
    alive = tfk.alive_vertices(g)
    while alive:
        peeled, n_out, _, k = tfk.fused_kcore_sweep(
            g, d, c, k, n_in, cand_in, cand_out, scratch).tolist()
        md, mc, _, _, mlist, _ = push_wave(
            off, col, md, mc, k, np.array(mlist, np.int64) if n_in else None,
            waves)
        assert np.array_equal(md[starts], d.numpy()[starts])
        want = alive_below(g, d, k)
        got = cand_out[:n_out].tolist()
        assert len(got) == len(set(got)) == n_out and set(got) == want
        assert len(mlist) == len(set(mlist)) and set(mlist) == want
        cascades += n_in > 0
        cand_in, cand_out, n_in = cand_out, cand_in, n_out
        alive, waves = alive - peeled, waves + 1
    assert n_in == 0 and cascades > 0
    kernels.reset_launches()
    r = tkcore.run(g, variant="fused", warmup=False)
    counted = kernels.counters
    assert r.iterations == waves == counted["kcore.waves"]
    assert counted["kcore.waves"] - counted["kcore.levels"] == cascades


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
    the TPU: the first wave (a level wave), and a cascade from a state two
    fallback waves in, whose candidate list is the survivors below k."""
    _, gj, g = graphs["rmat10"]
    assert isinstance(gj.route_fwd, cube_router.CubePlan)
    starts = starts_of(g)
    dj = jfk.init_deg_exp(gj)
    cj = jax.numpy.zeros_like(dj)
    k = jax_first_level(np.asarray(dj), starts)
    cascade = False
    for _ in range(2 * k_step):
        dj, cj, _, ma = _jax_sweep(gj, dj, cj, k)
        cascade = int(ma[0, 0]) < k
        k = jax_next_level(k, int(ma[0, 0]))
    assert cascade == bool(k_step)
    od, oc, cnt_j, ma_j = jfk.fused_kcore_sweep(gj, dj, cj, k)
    d, c = torch.from_numpy(np.array(dj)), torch.from_numpy(np.array(cj))
    cand_in, cand_out, scratch = tfk.wave_buffers(g)
    below = sorted(alive_below(g, d, k)) if cascade else []
    cand_in[:len(below)] = torch.tensor(below, dtype=torch.int32)
    peeled, n_out, _, k_wave = tfk.fused_kcore_sweep(
        g, d, c, k, len(below), cand_in, cand_out, scratch).tolist()
    assert k_wave == k
    assert peeled == int(cnt_j[0, 0]) > 0
    assert (n_out > 0) == (int(ma_j[0, 0]) < k)
    assert np.array_equal(d.numpy()[starts], np.asarray(od)[starts])
    assert np.array_equal(c.numpy()[starts], np.asarray(oc)[starts])


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

def wave_args(g):
    """A run's level waves on the plain route up to the first that lists
    candidates, leaving a state and a list from which a cascade runs:
    (deg, core, k, n_in, cand_in)."""
    d = tfk.init_deg_exp(g)
    c = torch.zeros_like(d)
    cand_in, cand_out, scratch = tfk.wave_buffers(g)
    n = 0
    while not n:
        _, n, _, k = tfk.fused_kcore_sweep(g, d, c, 0, 0, cand_out, cand_in,
                                           scratch).tolist()
    return d, c, k, n, cand_in


def test_wrappers_take_plain_version_on_cpu(graphs):
    """Both waves' wrappers on CPU tensors are their plain versions: the
    same scalars, state and candidates, and no launch counted."""
    _, _, g = graphs["rmat10"]
    adj = (g.row_offsets, g.csc_src_indices, g.col_indices)
    d, c, k, n, cand = wave_args(g)
    kernels.reset_launches()
    pairs = ((kernels.kcore_level_wave, kernels.kcore_level_wave_plain, ()),
             (kernels.kcore_cascade_wave, kernels.kcore_cascade_wave_plain,
              (k, cand, n)))
    for wrapper, plain, extra in pairs:
        runs = []
        for wave in (wrapper, plain):
            state = [d.clone(), c.clone()]
            out = torch.empty_like(cand)
            scratch = kernels.kcore_wave_scratch(g.n_vertices_padded,
                                                 g.n_edges_padded, "cpu")
            s = wave(*state, *adj, *extra, out, scratch).clone()
            runs.append((s, state, out[:int(s[1])]))
        (s, state, out), (s_p, state_p, out_p) = runs
        assert torch.equal(s, s_p) and torch.equal(out, out_p)
        assert all(torch.equal(a, b) for a, b in zip(state, state_p))
    tfk.collapse_core_exp(g, d)
    assert all(n == 0 for n in kernels.launches.values())
    assert all(n == 0 for n in kernels.pass_launches.values())


def test_wrapper_raises_on_other_devices(graphs):
    g = graphs["clique_tail"][2].to("meta")
    vp, ep = g.n_vertices_padded, g.n_edges_padded
    d = torch.empty(ep, dtype=torch.int32, device="meta")
    lists = [torch.empty(vp, dtype=torch.int32, device="meta")
             for _ in range(2)]
    scratch = kernels.kcore_wave_scratch(vp, ep, "meta")
    adj = (g.row_offsets, g.csc_src_indices, g.col_indices)
    with pytest.raises(EssentialsError):
        kernels.kcore_level_wave(d, d.clone(), *adj, lists[0], scratch)
    with pytest.raises(EssentialsError):
        kernels.kcore_cascade_wave(d, d.clone(), *adj, 2, lists[0], 1,
                                   lists[1], scratch)
    vals = torch.empty(g.n_vertices_padded, dtype=torch.int32, device="meta")
    with pytest.raises(EssentialsError):
        kernels.expand_segments(vals, g.row_offsets, g.n_edges_padded)


def test_wrapper_rejects_bad_arguments(graphs):
    _, _, g = graphs["clique_tail"]
    off, src, col = g.row_offsets, g.csc_src_indices, g.col_indices
    d, c, k, n, cand = wave_args(g)
    out = torch.empty_like(cand)
    s = kernels.kcore_wave_scratch(g.n_vertices_padded, g.n_edges_padded,
                                   "cpu")
    vals = g.out_degrees().int()
    ep = g.n_edges_padded

    def level(**kw):
        args = dict(deg=d, core=c, offsets=off, csc_src=src, col=col,
                    cand_out=out, scratch=s)
        args.update(kw)
        return lambda: kernels.kcore_level_wave(**args)

    def cascade(**kw):
        args = dict(deg=d, core=c, offsets=off, csc_src=src, col=col, k=k,
                    cand_in=cand, n_in=n, cand_out=out, scratch=s)
        args.update(kw)
        return lambda: kernels.kcore_cascade_wave(**args)

    bad = [
        lambda: kernels.expand_segments(vals.long(), off, ep),
        lambda: kernels.expand_segments(vals[1:], off, ep),
        lambda: kernels.expand_segments(vals, off.long(), ep),
        lambda: kernels.expand_segments(vals, off, ep + 1),   # not covered
        lambda: kernels.expand_segments(vals, off, -1),
        level(core=d),                                 # shares the degrees
        level(cand_out=s[:out.numel()]),               # inside the scratch
        level(deg=d.clone()[1:]),
        level(deg=d.long()),
        level(csc_src=src[:-1]),
        level(col=col[:-1]),
        level(cand_out=out[1:]),
        level(scratch=s[:-1]),                         # too short
        level(scratch=s.long()),
        cascade(k=0),
        cascade(k=2**31),
        cascade(n_in=0),
        cascade(n_in=out.numel() + 1),
        cascade(cand_in=out),                          # the output list
        cascade(cand_in=cand.long()),
        cascade(deg=d.clone(), core=c[:-1]),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(EssentialsError):
            call()
            pytest.fail(f"case {i} did not raise")
