"""Port parity: essentials_tpu_torch's graph coloring (algorithms.color, both
variants), segment.combine_minmax_multi, scan_kernels.segmented_minmax and
the ``segment_minmax`` wrapper's plain version against essentials_tpu's,
on the CPU.

Every value is an integer, so the tolerance is exact equality: colors and
round counts of whole runs, the per-segment and inclusive MAX/MIN, and the
hash. JP runs with the JAX package's own priorities injected
(``color.init(g, seed).pris``): the port's default priorities come from a
torch generator, which cannot reproduce ``jax.random.permutation``. The
spray branches fire only above sparse_advance._MIN_EDGES (2^21 edges); the
tests that cover them patch it to 0 in both packages and clear JAX's
compile cache. JAX graphs are built with router plans (rmat10, which runs
JAX's routed combine) and without (the others, its CPU fallback), and
carried into the port with graph_from_arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import color as jcolor
from essentials_tpu.formats import Coo as JCoo
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.io import load_graph_file as jload
from essentials_tpu.ops import Combine as JCombine
from essentials_tpu.ops import scan_kernels as jsk
from essentials_tpu.ops import segment as jseg
from essentials_tpu.ops import sparse_advance as jsa

from essentials_tpu_torch import kernels
from essentials_tpu_torch.algorithms import color as tcolor
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import combine_minmax_multi
from essentials_tpu_torch.ops import scan_kernels as tsk
from essentials_tpu_torch.ops import sparse_advance as tsa

IMAX = np.iinfo(np.int32).max


def carried(csr, router):
    gj = jbuild(csr, directed=False, weighted=False, build_router=router)
    fields = {f: None if getattr(gj, f) is None else np.asarray(getattr(gj, f))
              for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return csr, gj, graph_from_arrays(fields, meta, "cpu")


def isolated_coo():
    """12 vertices; 0, 5 and 9 have no edges."""
    pairs = [(1, 2), (2, 3), (1, 3), (3, 4), (6, 7), (7, 8), (8, 10),
             (10, 6), (6, 8), (10, 11)]
    a, b = (np.array(x, np.int32) for x in zip(*pairs))
    return JCoo(12, 12, np.concatenate([a, b]), np.concatenate([b, a]),
                np.ones(2 * a.size, np.float32))


def rmat(scale, edge_factor, seed):
    return JCsr.from_coo(jgen.rmat(scale, edge_factor, seed=seed,
                                   undirected=True, weighted=False))


@pytest.fixture(scope="module")
def graphs():
    return {
        "rmat10": carried(rmat(10, 16, 4), True),
        "rmat12": carried(rmat(12, 16, 1), False),
        "grid16": carried(JCsr.from_coo(jgen.grid_2d(16)), False),
        "chesapeake": carried(jload("datasets/chesapeake.mtx", cache=False),
                              False),
        "isolated": carried(JCsr.from_coo(isolated_coo()), False),
    }


NAMES = ["chesapeake", "grid16", "isolated", "rmat10", "rmat12"]


def colors_of(r) -> np.ndarray:
    c = r.colors
    return c.numpy() if isinstance(c, torch.Tensor) else np.asarray(c)


def assert_same_coloring(rt, rj, csr):
    assert rt.colors.dtype == torch.int32
    assert rt.colors.shape == (csr.n_rows,)
    assert rt.iterations == rj.iterations
    assert np.array_equal(colors_of(rt), colors_of(rj))
    assert tcolor.validate(csr, colors_of(rt)) == 0
    assert jcolor.validate(csr, colors_of(rj)) == 0


# ---------------------------------------------------------------- minmax --

@pytest.mark.parametrize("n", [5000, 130_000])
def test_segmented_minmax_matches_pallas_in_interpret_mode(monkeypatch, n):
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    rng = np.random.default_rng(n)
    x = rng.integers(-2**31, 2**31, n, dtype=np.int64).astype(np.int32)
    flags = rng.random(n) < 0.05
    active = rng.random(n) < 0.7
    jmax, jmin = jsk.segmented_minmax_1d(jnp.asarray(x), jnp.asarray(flags),
                                         jnp.asarray(active))
    tmax, tmin = tsk.segmented_minmax(torch.from_numpy(x),
                                      torch.from_numpy(flags),
                                      torch.from_numpy(active))
    assert tmax.dtype == tmin.dtype == torch.int32
    assert np.array_equal(tmax.numpy(), np.asarray(jmax))
    assert np.array_equal(tmin.numpy(), np.asarray(jmin))


def edge_payloads(g, m, seed):
    rng = np.random.default_rng(seed)
    ep = g.n_edges_padded
    vals = rng.integers(-2**31, 2**31, (m, ep), dtype=np.int64).astype(
        np.int32)
    active = rng.random(ep) < 0.3
    active[g.n_edges:] = False
    return vals, active


@pytest.mark.parametrize("m", [1, 8])
def test_combine_minmax_multi_matches_jax_routed(graphs, m):
    _, gj, g = graphs["rmat10"]
    assert gj.off_route_csc is not None
    vals, active = edge_payloads(g, m, m)
    jit = jax.jit(lambda v, a: jseg.combine_minmax_multi(
        list(v), a, gj.off_route_csc, gj.csc_seg_flags))
    want = jit(jnp.asarray(vals), jnp.asarray(active))
    got = combine_minmax_multi(list(torch.from_numpy(vals)),
                               torch.from_numpy(active), g.csc_offsets)
    assert len(got) == len(want) == m
    vp = g.n_vertices_padded
    for (tmx, tmn), (jmx, jmn) in zip(got, want):
        assert tmx.shape == tmn.shape == (vp,)
        assert np.array_equal(tmx.numpy(), np.asarray(jmx)[:vp])
        assert np.array_equal(tmn.numpy(), np.asarray(jmn)[:vp])


@pytest.mark.parametrize("m", [1, 8])
def test_combine_minmax_multi_matches_colors_fallback(graphs, m):
    """JAX color's non-routed sweep (color.py:118-129): per-wave masked
    combine_by_offsets MAX and MIN."""
    _, gj, g = graphs["rmat12"]
    assert gj.off_route_csc is None
    vals, active = edge_payloads(g, m, 10 + m)

    @jax.jit
    def fallback(v, a):
        return [(jseg.combine_by_offsets(jnp.where(a, pe, -IMAX - 1),
                                         gj.csc_offsets, JCombine.MAX,
                                         gj.csc_seg_flags),
                 jseg.combine_by_offsets(jnp.where(a, pe, IMAX),
                                         gj.csc_offsets, JCombine.MIN,
                                         gj.csc_seg_flags)) for pe in v]

    want = fallback(jnp.asarray(vals), jnp.asarray(active))
    got = combine_minmax_multi(list(torch.from_numpy(vals)),
                               torch.from_numpy(active), g.csc_offsets)
    for (tmx, tmn), (jmx, jmn) in zip(got, want, strict=True):
        assert np.array_equal(tmx.numpy(), np.asarray(jmx))
        assert np.array_equal(tmn.numpy(), np.asarray(jmn))


def _stress_inputs(m):
    """chip_smoke.minmax_stress_inputs at a CPU test's size: one segment of
    3 tiles of 2,048 places, a run of empty segments, all-inactive ones,
    offsets from 37, views at odd element offsets."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.minmax_stress_inputs("cpu", m=m, short=3000, long_tiles=2,
                                    tail=400)


@pytest.mark.parametrize("m", [1, 3])
def test_segment_minmax_plain_matches_pallas_on_stress_shapes(monkeypatch,
                                                              m):
    """The plain version against the JAX package's segmented_minmax_1d (in
    interpret mode) and the pick of each segment's last slot, on the
    kernel's stress shapes; empty segments get the identities."""
    monkeypatch.setattr(jsk, "_INTERPRET", True)
    pays, active, off = _stress_inputs(m)
    o = off.numpy().astype(np.int64)
    lo, hi = int(o[0]), int(o[-1])
    seg = np.diff(o)
    assert seg.max() > 2 * 2048 and (seg == 0).sum() > 6000 and lo == 37
    flags = np.zeros(hi - lo, bool)
    flags[o[:-1][seg > 0] - lo] = True
    act = active.numpy()[lo:hi]
    last = o[1:][seg > 0] - 1 - lo
    quiet = np.add.reduceat(act.astype(np.int64), o[:-1][seg > 0] - lo) == 0
    assert quiet.sum() > 90                # all-inactive segments
    mx, mn = kernels.segment_minmax_plain(pays, active, off)
    for k, p in enumerate(pays):
        jmax, jmin = jsk.segmented_minmax_1d(jnp.asarray(p.numpy()[lo:hi]),
                                             jnp.asarray(flags),
                                             jnp.asarray(act))
        want_mx = np.full(seg.size, -IMAX - 1, np.int32)
        want_mn = np.full(seg.size, IMAX, np.int32)
        want_mx[seg > 0] = np.asarray(jmax)[last]
        want_mn[seg > 0] = np.asarray(jmin)[last]
        assert np.array_equal(mx[k].numpy(), want_mx)
        assert np.array_equal(mn[k].numpy(), want_mn)


def test_segment_minmax_wrapper_on_the_cpu():
    """Any number of payloads, offsets that start past 0, identities at
    empty and all-inactive segments; the plain version counts nothing."""
    rng = np.random.default_rng(7)
    n = 300
    pays = [torch.from_numpy(rng.integers(-50, 50, n).astype(np.int32))
            for _ in range(11)]
    active = torch.from_numpy(rng.random(n) < 0.5)
    active[40:60] = False
    off = torch.tensor([10, 10, 40, 60, 200, 290], dtype=torch.int32)
    kernels.reset_launches()
    mx, mn = kernels.segment_minmax(pays, active, off)
    assert mx.shape == mn.shape == (11, 5)
    assert kernels.launches["segment_minmax"] == 0
    for k, p in enumerate(pays):
        for s in range(5):
            lo, hi = int(off[s]), int(off[s + 1])
            seg = p[lo:hi][active[lo:hi]]
            assert int(mx[k, s]) == (int(seg.max()) if seg.numel()
                                     else -IMAX - 1)
            assert int(mn[k, s]) == (int(seg.min()) if seg.numel() else IMAX)
    assert mx[:, 0].eq(-IMAX - 1).all() and mn[:, 2].eq(IMAX).all()
    with pytest.raises(EssentialsError):
        kernels.segment_minmax([], active, off)
    with pytest.raises(EssentialsError):
        kernels.segment_minmax([pays[0].long()], active, off)
    with pytest.raises(EssentialsError):
        kernels.segment_minmax(pays[:2], active.int(), off)
    with pytest.raises(EssentialsError):
        kernels.segment_minmax(pays[:2], active, off.long())
    with pytest.raises(EssentialsError, match="no kernel for device meta"):
        kernels.segment_minmax([p.to("meta") for p in pays[:2]],
                               active.to("meta"), off.to("meta"))


# ------------------------------------------------------------------ hash --

def test_hash_color_matches_jax():
    rng = np.random.default_rng(0)
    v = rng.integers(-2**31, 2**31, 4096, dtype=np.int64).astype(np.int32)
    deg = rng.integers(0, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    deg[:64] = rng.integers(0, 4, 64)
    for it in (0, 1, 7, 2**31 - 1, -1, -2**31):
        for seed in (0, 1):
            want = jcolor._hash_color(jnp.asarray(v), jnp.asarray(deg),
                                      jnp.int32(it), seed)
            got = tcolor._hash_color(torch.from_numpy(v),
                                     torch.from_numpy(deg), it, seed)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), np.asarray(want)), (it, seed)
    assert (got >= 0).all() and (got.long() <= torch.from_numpy(deg)).all()


def test_spec_wraps_seeds_the_reference_refuses(graphs):
    """JAX's uint32(seed * 0x9E3779B9) overflows for seed >= 2; the port
    wraps it mod 2^32 and colors properly."""
    csr, gj, g = graphs["rmat12"]
    with pytest.raises(OverflowError):
        jcolor.init_spec(gj, 2)
    r = tcolor.run(g, variant="spec", seed=2, warmup=False)
    assert tcolor.validate(csr, r.colors.numpy()) == 0
    assert 1 < r.iterations < csr.n_rows
    r3 = tcolor.run(g, variant="spec", seed=3, warmup=False)
    assert not torch.equal(r.colors, r3.colors)


# ------------------------------------------------------------ whole runs --

@pytest.mark.parametrize("name", NAMES)
def test_jp_matches_jax_with_its_priorities(graphs, name):
    csr, gj, g = graphs[name]
    rj = jcolor.run(gj, variant="jp", warmup=False)
    pris = np.asarray(jcolor.init(gj, 0).pris)
    rt = tcolor.run(g, variant="jp", warmup=False, pris=pris)
    assert_same_coloring(rt, rj, csr)
    assert rt.tiers == (0, rt.iterations)          # no spray below 2^21


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", NAMES)
def test_spec_matches_jax(graphs, name, seed):
    csr, gj, g = graphs[name]
    rj = jcolor.run(gj, variant="spec", seed=seed, warmup=False)
    rt = tcolor.run(g, variant="spec", seed=seed, warmup=False)
    assert_same_coloring(rt, rj, csr)


@pytest.fixture
def spray_forced(monkeypatch):
    monkeypatch.setattr(tsa, "_MIN_EDGES", 0)
    monkeypatch.setattr(jsa, "_MIN_EDGES", 0)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.mark.parametrize("variant", ["jp", "spec", "auto"])
def test_spray_matches_jax(graphs, spray_forced, variant):
    csr, gj, g = graphs["rmat12"]
    assert tsa.spray_enabled(g) and jsa.spray_enabled(gj)
    assert tcolor.auto_variant(g) == "spec"
    rj = jcolor.run(gj, variant=variant, seed=1, warmup=False)
    pris = (np.asarray(jcolor.init(gj, 1).pris) if variant == "jp"
            else None)
    rt = tcolor.run(g, variant=variant, seed=1, warmup=False, pris=pris)
    assert_same_coloring(rt, rj, csr)
    assert rt.tiers[0] > 0 and rt.tiers[1] > 0      # both branches ran
    assert sum(rt.tiers) == rt.iterations


def test_auto_is_jp_without_the_spray(graphs):
    csr, gj, g = graphs["grid16"]
    assert tcolor.auto_variant(g) == "jp"
    rj = jcolor.run(gj, warmup=False)
    rt = tcolor.run(g, warmup=False, pris=np.asarray(jcolor.init(gj).pris))
    assert_same_coloring(rt, rj, csr)


# ---------------------------------------------------- the port's own API --

def test_default_priorities_and_arguments(graphs):
    csr, _, g = graphs["rmat12"]
    p = tcolor.default_priorities(g.n_vertices_padded, 5)
    assert p.dtype == torch.int32 and p.shape == (tcolor.WAVES,
                                                  g.n_vertices_padded)
    ids = torch.arange(g.n_vertices_padded, dtype=torch.int32)
    assert all(torch.equal(torch.sort(row).values, ids) for row in p)
    assert torch.equal(p, tcolor.default_priorities(g.n_vertices_padded, 5))
    r = tcolor.run(g, variant="jp", seed=5, warmup=False)
    assert torch.equal(r.colors, tcolor.run(g, variant="jp", warmup=False,
                                            pris=p).colors)
    assert tcolor.validate(csr, r.colors.numpy()) == 0
    assert 1 < r.iterations < 40
    state = tcolor.init(g, pris=p.numpy())
    assert torch.equal(state.pri_csc, p[:, g.csc_src_indices.long()])
    with pytest.raises(EssentialsError):
        tcolor.init(g, pris=p[:, :-1])
    with pytest.raises(EssentialsError):
        tcolor.run(g, variant="spec", pris=p)
    with pytest.raises(EssentialsError):
        tcolor.run(g, variant="greedy")
    cut = tcolor.run(g, variant="jp", max_iterations=1, warmup=False)
    assert cut.iterations == 1 and (cut.colors < 0).any()
    assert tcolor.validate(csr, cut.colors.numpy()) > 0


def test_validate_matches_jax(graphs):
    csr = graphs["chesapeake"][0]
    rng = np.random.default_rng(3)
    for _ in range(4):
        colors = rng.integers(-1, 4, csr.n_rows).astype(np.int32)
        assert tcolor.validate(csr, colors) == jcolor.validate(csr, colors)
