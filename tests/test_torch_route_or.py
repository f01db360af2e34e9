"""Port parity of ``fused_route_or``, on the CPU.

``fused_route_or(lev, edge_ids, start_flags, it)`` gives z[q] = 1 iff some
q' <= q in q's segment has lev[edge_ids[q']] == it (position 0 always
starts a segment). On the card it is one launch of ``scan``'s tiles: each
tile computes the compare as it loads, publishes its aggregate pair
(value, "holds a start"), and takes its carry from the tiles before it by
a look-back over their words and their groups' words, back to the nearest
complete one. A NumPy model of that decomposition is held against the
plain version at the card's tile (2,048 positions) and at 4,096 (the
alternative that was timed), at the card's groups (256 tiles) and at 4 so
that the group words carry, with inclusive prefixes published and
without. The plain version is held against JAX's
``fused_route_or`` (its Pallas kernels in interpret mode) at every level
of a BFS search on rmat12, ``datasets/kron_s12.mtx`` and
``datasets/road_64x64.mtx``. Every value is an integer: the tolerance is
exact equality."""

import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import essentials_tpu.ops.fused_bfs as jfb
from essentials_tpu.algorithms import bfs as jbfs
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.io import load_graph_file as jload
from essentials_tpu.ops import cube_router
from essentials_tpu.ops.permute import route_permutation

from essentials_tpu_torch import kernels
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import fused_bfs as tfb

ROOT = Path(__file__).resolve().parent.parent
INT32_MAX = np.iinfo(np.int32).max
TILES = (kernels.SCAN_TILE, 2 * kernels.SCAN_TILE)   # 8 and 16 a thread
LONG = 42                      # tiles one segment spans
SHAPES = ("1", "tile - 1", "tile", "tile + 1", "45 tiles + 77")

_jax_route = jax.jit(jfb.fused_route_or)


def size(shape: str, tile: int) -> int:
    return {"1": 1, "tile - 1": tile - 1, "tile": tile, "tile + 1": tile + 1,
            "45 tiles + 77": 45 * tile + 77}[shape]


def flag_sets(n: int, tile: int, seed: int) -> dict:
    """Start flags: sparse (1%), at every position, only at 0, and one
    segment across LONG tiles (from position 100, cut at n)."""
    pos = np.arange(n)
    return {"sparse": np.random.default_rng(seed).random(n) < 0.01,
            "every": np.ones(n, bool),
            "only 0": pos == 0,
            f"{LONG} tiles": (pos == 0) | (pos == min(100, n - 1))
            | (pos == min(100 + LONG * tile, n - 1))}


def level_sets(n: int, seed: int) -> dict:
    """(lev, eid, it) by what the compare sees: seeded levels 0-3 with
    INT32_MAX at about a third, eid a seeded permutation, `it` with some
    hits, with none and at the sentinel; and every position a hit."""
    rng = np.random.default_rng(seed)
    lev = np.where(rng.random(n) < 0.3, INT32_MAX,
                   rng.integers(0, 4, n)).astype(np.int32)
    eid = rng.permutation(n).astype(np.int32)
    return {"some hits": (lev, eid, 1), "no hit": (lev, eid, 9),
            "the sentinel": (lev, eid, INT32_MAX),
            "every hit": (np.full(n, 2, np.int32), eid, 2)}


def fold(older: tuple, newer: tuple) -> tuple:
    """(v, f) pairs under the segmented max: a newer start hides the
    older value."""
    return (newer[0] if newer[1] else max(older[0], newer[0]),
            older[1] or newer[1])


def route_or_model(lev, eid, flags, it: int, tile: int, group: int,
                   prefix: bool) -> np.ndarray:
    """fused_route_or_kernel's decomposition. Every tile loads (lev[eid] ==
    it) and publishes its aggregate pair at once: a word is complete where
    the tile holds a start; the last tile of each group of ``group`` tiles
    publishes the fold of its tiles' words the same way. Then each tile in
    ticket order (the words of the tiles after it may be unresolved) folds
    the words before it, newest first, within its group, then its group's
    predecessors' words, back to the nearest complete one, as its carry;
    with ``prefix`` it then publishes carry . aggregate as complete (the
    look-back of an exact op). The carry completes the tile's positions
    before its first start."""
    n = lev.size
    z = (lev[eid] == it).astype(np.int64)           # the compare at load
    start = flags.astype(bool).copy()
    start[0] = True
    g = -(-n // tile)
    words = []                                       # (value, complete)
    for b in range(g):
        v, f = z[b * tile:(b + 1) * tile], start[b * tile:(b + 1) * tile]
        last = np.flatnonzero(f)[-1] if f.any() else 0
        words.append((int(v[last:].max()), bool(f.any())))
    groups = []
    for k in range(g // group):
        agg = words[k * group]
        for w in words[k * group + 1:(k + 1) * group]:
            agg = fold(agg, w)
        groups.append(agg)
    out = np.empty(n, np.int64)
    for b in range(g):
        lo, hi = b * tile, min(n, (b + 1) * tile)
        seg = np.cumsum(start[lo:hi])                # 0 before the first
        # the tile's own segmented running max: a later segment's keys lie
        # above every earlier one's
        inc = np.maximum.accumulate(seg * 2 + z[lo:hi]) - seg * 2
        if b > 0 and not start[lo]:
            first = b // group * group
            carry = None
            for w in [words[p] for p in range(b - 1, first - 1, -1)] + \
                    [groups[k] for k in range(b // group - 1, -1, -1)]:
                carry = w if carry is None else fold(w, carry)
                if w[1]:
                    break
            assert carry[1], "the look-back ends at a complete word"
            inc[seg == 0] = np.maximum(inc[seg == 0], carry[0])
            if prefix and not words[b][1]:
                words[b] = (max(carry[0], words[b][0]), True)
        out[lo:hi] = inc
    return out.astype(np.int32)


def plain(lev, eid, flags, it: int) -> np.ndarray:
    out = kernels.fused_route_or(torch.from_numpy(lev),
                                 torch.from_numpy(eid),
                                 torch.from_numpy(flags), it)
    assert out.dtype == torch.int32
    return out.numpy()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("tile", TILES)
def test_route_or_tile_model_matches_plain(tile, shape):
    """The one-launch decomposition against the plain version, under each
    flag set and level set, groups of 256 and 4 tiles, with and without
    published prefixes."""
    n = size(shape, tile)
    kernels.reset_launches()
    for label, flags in flag_sets(n, tile, n).items():
        for what, (lev, eid, it) in level_sets(n, n + 1).items():
            want = plain(lev, eid, flags, it)
            for group in (kernels.SCAN_GROUP, 4):
                for prefix in (True, False):
                    got = route_or_model(lev, eid, flags, it, tile, group,
                                         prefix)
                    assert np.array_equal(got, want), (label, what, group,
                                                       prefix)
            if what == "every hit":
                assert want.all()
            if what == "no hit":
                assert not want.any()
    assert kernels.launches["fused_route_or"] == 0      # plain on the CPU


def test_route_or_model_carries_across_groups():
    """A segment from position 0 across more tiles than a group holds, the
    only hit at position 0: every position's carry comes from group
    words."""
    tile, n = 64, 64 * 70 + 5
    lev = np.zeros(n, np.int32)
    lev[1:] = 3
    eid = np.arange(n, dtype=np.int32)
    flags = np.zeros(n, bool)
    want = plain(lev, eid, flags, 0)
    assert want.all()
    for prefix in (True, False):
        assert np.array_equal(route_or_model(lev, eid, flags, 0, tile, 4,
                                             prefix), want)


def carried(gj) -> tuple:
    fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return gj, graph_from_arrays(fields, meta, "cpu")


def with_cube_plan(gj):
    """JAX's graph with a cube route plan. A graph of at most
    cube_router._SEG (16,384) edge slots gets a PermutePlan, which
    fused_route_or does not take; the edge ids extended by the identity
    past Ep make route_permutation build a cube plan of the same moves on
    Ep, and fused_route_or pads lev and the flags to its length."""
    if isinstance(gj.route_fwd, cube_router.CubePlan):
        return gj
    ep = gj.n_edges_padded
    ids = np.concatenate([np.asarray(gj.csc_edge_ids, np.int64),
                          np.arange(ep, cube_router._SEG + 1)])
    plan = route_permutation(ids, cache=False)
    assert isinstance(plan, cube_router.CubePlan)
    return dataclasses.replace(gj, route_fwd=plan)


@pytest.fixture(scope="module")
def graphs():
    def build(csr):
        gj = jbuild(csr, directed=False, weighted=False, build_router=True)
        assert jbfs.fused_supported(gj)
        return carried(gj)

    return {
        "rmat12": build(JCsr.from_coo(jgen.rmat(12, 10, seed=6,
                                                undirected=True,
                                                weighted=False))),
        "kron_s12": build(jload(str(ROOT / "datasets" / "kron_s12.mtx"),
                                cache=False)),
        "road_64x64": build(jload(str(ROOT / "datasets" / "road_64x64.mtx"),
                                  cache=False)),
    }


@pytest.mark.parametrize("name", ["rmat12", "kron_s12", "road_64x64"])
def test_route_or_plain_matches_jax_at_every_level(graphs, name):
    """Every level of a 5-pass BFS search from the highest-degree vertex
    (road_64x64: from the grid's centre): the plain route OR against JAX's
    fused_route_or on the whole-segment levels, then the port's level."""
    gj, g = graphs[name]
    gj = with_cube_plan(gj)
    lens = np.diff(g.row_offsets.numpy())[:g.n_vertices]
    source = 64 * 32 + 32 if name == "road_64x64" else int(np.argmax(lens))
    lev = tfb.init_lev_exp(g, source)
    it = 0
    while True:
        ref = np.asarray(_jax_route(gj, lev.numpy(), it))
        out = tfb.fused_route_or(g, lev, it)
        assert out.dtype == torch.int32 and out.shape == ref.shape
        assert np.array_equal(out.numpy(), ref), it
        lev, any_ = tfb.five_pass_superstep(g, lev, it)
        it += 1
        if not int(any_):
            break
    assert it > (30 if name == "road_64x64" else 2)
