"""Port parity of ``expand_segments``, ``collapse_starts`` and
``collapse_levels``, on the CPU.

``expand_segments(vals, offsets, n)`` writes ``vals[v]`` into every slot of
segment v; ``collapse_starts(exp, offsets, empty, source)`` reads each
non-empty segment's first slot (``empty`` at an empty one, 0 at
``source``); ``collapse_levels(lev, offsets, source, unreached)`` is the
same collapse over int32 or int8 levels on the card (one body,
``csrc/segment_starts.cuh``), a level at or above ``unreached`` read as
INT32_MAX. On the CPU the wrappers take their plain versions, which
define the kernels, so these are held against the JAX package:
``expand_vertex_to_edges`` for the expansion, a NumPy gather at the starts
and the routed ``collapse_dist_exp`` / ``collapse_core_exp`` /
``collapse_lev_exp`` for the collapses. The inputs are chip_smoke's ``starts_cases`` (the card test's: a
hub of 3.5 tiles, an empty run across a tile edge, segments ending at a
tile's last and first places, n and Vp not multiples of 4, n = 0), RMAT
and small graphs, all from a seed with numpy. NumPy models of the card's
decompositions are held against the plain versions too: the expansion's
merge-path tiles (each tile's own split, the marks of the segment starts
among its slots, each warp's rounds of 16-byte vectors from the owner of
its first slot) and the collapse's runs of consecutive segments a
thread. Every value is an integer: the tolerance is exact equality."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from essentials_tpu.formats import Coo as JCoo
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.ops import fused_bfs as jfb
from essentials_tpu.ops import fused_kcore as jfk
from essentials_tpu.ops import fused_sssp as jfs
from essentials_tpu.ops.segment import expand_vertex_to_edges

from essentials_tpu_torch import kernels
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import fused_bfs as tfb


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()
CASES = [c[0] for c in CS.starts_cases("cpu", kernels.EXPAND_TILE)]
TILES = (kernels.EXPAND_TILE, 128)     # the card's tile and a small one
RUNS = (4, 8)                          # segments a thread of the collapse
FORMS = ("int32", "int8")              # collapse_levels' level types
INT32_MAX = np.iinfo(np.int32).max

_jax_collapse_lev = jax.jit(jfb.collapse_lev_exp,
                            static_argnames=("unreached",))


def case(what: str) -> tuple:
    return next(c for c in CS.starts_cases("cpu", kernels.EXPAND_TILE)
                if c[0] == what)


def stress_coo() -> JCoo:
    """A directed graph whose out-degrees are the stress offsets' segment
    lengths (edges to seeded random vertices), so that its CSR holds the
    hub and the empty runs."""
    lens = np.diff(CS.starts_stress_offsets(kernels.EXPAND_TILE))
    n = lens.size
    src = np.repeat(np.arange(n), lens).astype(np.int32)
    dst = np.random.default_rng(2).integers(0, n, src.size).astype(np.int32)
    return JCoo(n, n, src, dst, np.ones(src.size, np.float32))


def carried(coo: JCoo, directed: bool) -> tuple:
    """The JAX graph (with router plans) and the port's graph made from its
    fields."""
    gj = jbuild(JCsr.from_coo(coo), directed=directed, weighted=True,
                build_router=True)
    fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return gj, graph_from_arrays(fields, meta, "cpu")


def isolated_coo() -> JCoo:
    """12 vertices; 0, 5 and 9 have no edges."""
    pairs = [(1, 2), (2, 3), (1, 3), (3, 4), (6, 7), (7, 8), (8, 10),
             (10, 6), (6, 8), (10, 11)]
    a, b = (np.array(x, np.int32) for x in zip(*pairs))
    return JCoo(12, 12, np.concatenate([a, b]), np.concatenate([b, a]),
                np.ones(2 * a.size, np.float32))


@pytest.fixture(scope="module")
def graphs():
    return {
        "rmat10": carried(jgen.rmat(10, 16, seed=4, undirected=True,
                                    weighted=True), False),
        "isolated": carried(isolated_coo(), False),
        "stress": carried(stress_coo(), True),
    }


GRAPHS = ["isolated", "rmat10", "stress"]


def seeded_i32(size: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        -2**31, 2**31, size, dtype=np.int64).astype(np.int32)


def expand_tiles_model(vals: np.ndarray, off: np.ndarray, n: int,
                       tile: int, block: int = 256) -> np.ndarray:
    """expand_segments_kernel's decomposition: tile b owns places [b tile,
    (b+1) tile) of the merged segment ends (v's at off[v+1] + v) and
    slots, finds its two splits by a lower bound, and marks the start slot
    of each non-empty segment that starts among its slots [p0, p1) with
    the segment's index from the first split; warp w takes whole rounds of
    32 of the tile's 16-byte vectors, starts from the owner of its first
    slot (a lower bound over the offsets) and carries the last mark it has
    seen; a slot's owner is the last mark at or before it. Asserts that
    the tiles' slots cover [0, n) once, in order, that the marks fit the
    tile's shared array and that every owner read lies in vals."""
    vp = off.size - 1
    out = np.full(n, 0x5EED, np.int64)          # no slot left unwritten
    written = np.zeros(n, np.int64)
    places = vp + n
    key = off[1:].astype(np.int64) + np.arange(vp)     # each segment's end
    prev_p1 = 0
    for d0 in range(0, places, tile):
        d1 = min(d0 + tile, places)
        r0, r1 = np.searchsorted(key, [d0, d1], side="left")
        nr = r1 - r0
        p0, p1 = max(d0 - r0, 0), min(d1 - r1, n)
        assert p0 == prev_p1 and p1 - p0 <= tile and r0 < vp
        prev_p1 = p1
        qb = p0 & ~3
        nvec = (p1 - qb + 3) // 4 if p1 > p0 else 0
        assert nvec <= tile // 4 + 1
        marks = np.zeros(4 * nvec, np.int64)
        for i in range(1, nr + 1):
            b = off[r0 + i]
            if p0 <= b < p1 and (i == nr or b < off[r0 + i + 1]):
                marks[b - qb] = i
        per_warp = 32 * -(-nvec // block)
        for c0 in range(0, block // 32 * per_warp, max(per_warp, 1)):
            c1 = min(c0 + per_warp, nvec)
            if c0 >= c1:
                continue
            first = max(qb + 4 * c0, p0)
            carry = np.searchsorted(off[r0 + 1:r0 + 1 + nr], first + 1,
                                    side="left")
            owner = np.maximum.accumulate(np.concatenate(
                [[carry], marks[4 * c0:4 * c1]]))[1:]
            q = qb + np.arange(4 * c0, 4 * c1)
            inside = (q >= p0) & (q < p1)
            assert owner[inside].max(initial=0) <= min(nr, vp - 1 - r0)
            out[q[inside]] = vals[r0 + owner[inside]]
            written[q[inside]] += 1
    assert prev_p1 == n and (written == 1).all()
    return out.astype(np.int32)


def collapse_runs_model(exp: np.ndarray, off: np.ndarray, empty: int,
                        source: int, run: int, at=None) -> np.ndarray:
    """collapse_segment_starts' decomposition: thread t takes segments
    [run t, run (t+1)) cut at vp, reads their run + 1 offsets and gathers
    each non-empty one's first slot, which ``at`` (the functor; None: the
    value itself) maps to the output; the threads' runs cover [0, vp)
    once."""
    vp = off.size - 1
    out = np.full(vp, 0x5EED, np.int64)
    seen = np.zeros(vp, np.int64)
    for v0 in range(0, vp, run):
        v = np.arange(v0, min(v0 + run, vp))
        b, e = off[v], off[v + 1]
        y = exp[np.where(b < e, b, 0)]
        got = np.where(b < e, y if at is None else at(y), empty)
        out[v] = np.where(v == source, 0, got)
        seen[v] += 1
    assert (seen == 1).all()
    return out.astype(np.int32)


def collapse_numpy(exp: np.ndarray, off: np.ndarray, empty: int,
                   source: int) -> np.ndarray:
    b, e = off[:-1], off[1:]
    out = np.full(b.size, empty, np.int32)
    out[b < e] = exp[b[b < e]]
    if source >= 0:
        out[source] = 0
    return out


@pytest.mark.parametrize("what", CASES)
def test_expand_plain_matches_jax_expand_on_stress_cases(what):
    _, vals, off, _, _ = case(what)
    n = int(off[-1])
    ref = expand_vertex_to_edges(jax.numpy.asarray(vals.numpy()),
                                 jax.numpy.asarray(off.numpy()), n)
    out = kernels.expand_segments(vals, off, n)
    assert out.dtype == torch.int32 and out.shape == (n,)
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("what", CASES)
def test_expand_tiles_model_matches_plain(what, tile):
    _, vals, off, _, _ = case(what)
    n = int(off[-1])
    got = expand_tiles_model(vals.numpy(), off.numpy(), n, tile)
    assert np.array_equal(got, kernels.expand_segments_plain(
        vals, off, n).numpy())


@pytest.mark.parametrize("what", CASES)
def test_collapse_plain_matches_numpy_gather(what):
    _, _, off, exp, sources = case(what)
    for source in sources:
        out = kernels.collapse_starts(exp, off, kernels.INF_BITS, source)
        ref = collapse_numpy(exp.numpy(), off.numpy(), kernels.INF_BITS,
                             source)
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), ref), source


@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("what", CASES)
def test_collapse_runs_model_matches_plain(what, run):
    _, _, off, exp, sources = case(what)
    for source in sources:
        got = collapse_runs_model(exp.numpy(), off.numpy(), -5, source, run)
        assert np.array_equal(got, kernels.collapse_starts_plain(
            exp, off, -5, source).numpy()), source


def test_stress_cases_cut_the_tiles_as_stated():
    """The stress offsets hold what the card test relies on, at the card's
    tile: a hub of more than three tiles, empty segments whose ends cross
    a tile edge, ends on a tile's last and first places, n % 4 == 3 and
    Vp % 8 == 5."""
    tile = kernels.EXPAND_TILE
    off = CS.starts_stress_offsets(tile).astype(np.int64)
    lens = np.diff(off)
    ends = off[1:] + np.arange(lens.size)
    empty_ends = ends[lens == 0]
    assert lens.max() > 3 * tile
    assert np.any(empty_ends // tile != empty_ends[0] // tile)
    assert np.any(ends % tile == tile - 1) and np.any(ends % tile == 0)
    assert off[-1] % 4 == 3 and lens.size % 8 == 5


def test_expand_plain_matches_jax_on_the_stress_graph(graphs):
    """On the stress graph's padded layout (test_torch_kcore.py holds the
    other graphs)."""
    gj, g = graphs["stress"]
    vals = seeded_i32(g.n_vertices_padded, 11)
    ref = expand_vertex_to_edges(jax.numpy.asarray(vals), gj.row_offsets,
                                 gj.n_edges_padded)
    out = kernels.expand_segments(torch.from_numpy(vals), g.row_offsets,
                                  g.n_edges_padded)
    assert np.array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("name", GRAPHS)
def test_collapse_plain_matches_jax_routed_collapses(graphs, name):
    """Seeded edge-axis states through the routed collapses: SSSP's
    distances (non-negative float bits, +inf in a quarter of the slots)
    from the hub and from an empty segment's vertex where there is one,
    k-core's core numbers (empty segments 0)."""
    gj, g = graphs[name]
    ep = g.n_edges_padded
    rng = np.random.default_rng(12)
    dist = rng.random(ep).astype(np.float32) * 100
    dist[rng.random(ep) < 0.25] = np.inf
    bits = dist.view(np.int32)
    lens = np.diff(g.row_offsets.numpy())[:g.n_vertices]
    sources = [int(np.argmax(lens))] + [int(v) for v in
                                        np.flatnonzero(lens == 0)[:1]]
    for source in sources:
        ref = jfs.collapse_dist_exp(gj, jax.numpy.asarray(bits), source)
        out = kernels.collapse_starts(torch.from_numpy(bits), g.row_offsets,
                                      kernels.INF_BITS, source)
        assert np.array_equal(out.numpy(),
                              np.asarray(ref).view(np.int32)), source
    core = rng.integers(0, 1000, ep).astype(np.int32)
    ref = jfk.collapse_core_exp(gj, jax.numpy.asarray(core))
    out = kernels.collapse_starts(torch.from_numpy(core), g.row_offsets, 0)
    assert np.array_equal(out.numpy(), np.asarray(ref))


# ------------------------------------------------------- collapse_levels --

def levels_of(exp: torch.Tensor, form: str) -> tuple:
    """A starts case's seeded levels of ``form`` and their sentinel
    (tfb.UNREACHED or tfb.UNREACHED_E), as the card test makes them."""
    lev, unreached = CS.starts_levels(exp)[form]
    assert unreached == {"int32": tfb.UNREACHED,
                         "int8": tfb.UNREACHED_E}[form]
    assert lev.dtype == getattr(torch, form)
    return lev, unreached


def level_at(unreached: int):
    """LevelAt: a level below ``unreached`` is the distance, else
    INT32_MAX."""
    def at(y: np.ndarray) -> np.ndarray:
        y = y.astype(np.int64)
        return np.where(y < unreached, y, INT32_MAX)
    return at


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("what", CASES)
def test_collapse_levels_plain_matches_numpy_gather(what, form):
    _, _, off, exp, _ = case(what)
    lev, unreached = levels_of(exp, form)
    o, lv = off.numpy(), lev.numpy()
    vp = o.size - 1
    b, e = o[:-1], o[1:]
    gathered = level_at(unreached)(lv[np.where(b < e, b, 0)])
    for source in range(vp) if vp < 8 else (0, 1, vp // 2, vp - 1):
        ref = np.where(b < e, gathered, INT32_MAX)
        ref[source] = 0
        out = kernels.collapse_levels(lev, off, source, unreached)
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), ref), source


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("run", RUNS)
@pytest.mark.parametrize("what", CASES)
def test_collapse_levels_runs_model_matches_plain(what, run, form):
    """collapse_segment_starts' runs under LevelAt, at every source of the
    case in [0, Vp)."""
    _, _, off, exp, sources = case(what)
    lev, unreached = levels_of(exp, form)
    vp = off.numel() - 1
    for source in (v for v in sources if 0 <= v < vp):
        got = collapse_runs_model(lev.numpy(), off.numpy(), INT32_MAX,
                                  source, run, level_at(unreached))
        assert np.array_equal(got, kernels.collapse_levels_plain(
            lev, off, source, unreached).numpy()), source


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("name", GRAPHS)
def test_collapse_levels_plain_matches_jax_routed_collapse(graphs, name,
                                                           form):
    """Seeded edge-axis levels (0-126, a quarter unreached) through JAX's
    routed collapse_lev_exp on int32 levels, from the hub and from an
    empty segment's vertex where there is one; the port's int8 form holds
    the same levels with its sentinel 127."""
    gj, g = graphs[name]
    ep = g.n_edges_padded
    rng = np.random.default_rng(13)
    lev = rng.integers(0, 127, ep).astype(np.int32)
    lev[rng.random(ep) < 0.25] = INT32_MAX
    unreached = tfb.UNREACHED if form == "int32" else tfb.UNREACHED_E
    mine = torch.from_numpy(np.where(lev == INT32_MAX, unreached, lev).astype(
        getattr(np, form)))
    lens = np.diff(g.row_offsets.numpy())[:g.n_vertices]
    sources = [int(np.argmax(lens))] + [int(v) for v in
                                        np.flatnonzero(lens == 0)[:1]]
    for source in sources:
        ref = np.asarray(_jax_collapse_lev(gj, jax.numpy.asarray(lev),
                                           source))
        out = kernels.collapse_levels(mine, g.row_offsets, source, unreached)
        assert np.array_equal(out.numpy(), ref), source
