"""Port parity of the predecessor kernels' function, on the CPU.

``bfs_predecessors`` and ``sssp_predecessors`` walk each reached vertex's
CSC segment to its first qualifying in-edge: a first walk over at most
``PRED_SPLIT`` slots, then the rest of a segment without a hit there as
ranges of ``PRED_SPLIT`` slots, each walked on its own and folded into the
vertex's word by an unsigned min (``csrc/first_hit.cuh``). On the CPU the
wrappers take their plain versions, so a NumPy model of the two walks (the
ranges in a seeded order, each stopping where the word already holds no
more than its step's first source) is held against the plain versions and
against the JAX package's ``predecessors_from_distances``, on graphs made
from a seed with numpy: chip_smoke's hub whose only qualifying in-edge lies
in the last range of its segment (with multi-edges and zero-weight
self-loops, which SSSP's predicate takes), RMAT graphs, and directed graphs
without a symmetric layout on the adaptive path; each also with n_edges
cutting the last real segments. Every value is an integer: the tolerance is
exact equality."""

import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import bfs as jbfs
from essentials_tpu.algorithms import sssp as jsssp
from essentials_tpu.formats import Coo as JCoo
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen

from essentials_tpu_torch import kernels
from essentials_tpu_torch.algorithms import bfs as tbfs
from essentials_tpu_torch.algorithms import sssp as tsssp
from essentials_tpu_torch.graph import graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS

INT32_MAX = np.iinfo(np.int32).max
NONE = 0xFFFFFFFF              # the kernels' "none": -1 as unsigned
STEP = 32 * 4                  # slots a warp walks a step (kHitChunks 4)
SPLITS = (32, 100)             # splits of the model's walks
_jax_pred = {"bfs": jax.jit(jbfs.predecessors_from_distances),
             "sssp": jax.jit(jsssp.predecessors_from_distances)}


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CS = _chip_smoke()


def carried(coo, directed: bool):
    """The JAX graph and the port's graph made from its fields, so that
    both packages compute on the same arrays."""
    gj = jbuild(JCsr.from_coo(coo), directed=directed, weighted=True,
                build_router=False)
    fields = {f: None if getattr(gj, f) is None else np.asarray(getattr(gj, f))
              for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return gj, graph_from_arrays(fields, meta, "cpu")


def hub_coo(split: int, directed: bool = False):
    """chip_smoke.pred_stress_coo's multigraph (its hub's only qualifying
    in-edge in its last range), or, directed, without the hub's edges to
    its odd leaves (no symmetric layout). (JAX Coo, source)."""
    n, src, dst, w, source = CS.pred_stress_coo(split)
    if directed:
        keep = ~((src == n - 1) & (dst % 2 == 1) & (dst < source))
        src, dst, w = src[keep], dst[keep], w[keep]
    return JCoo(n, n, src, dst, w), source


def walk_model(dist, off, src, w, n_edges: int, split: int, seed: int = 0):
    """The two walks of csrc/first_hit.cuh in NumPy: (pred [Vp] int32,
    vertices listed, ranges listed). ``w`` None: BFS's predicate on int32
    levels; else SSSP's on float32 distances, a float32 add."""
    dist, off, src = np.asarray(dist), np.asarray(off), np.asarray(src)
    if w is None:
        reached = (dist != INT32_MAX) & (dist > 0)

        def ok(q, v):
            ds = int(dist[src[q]])
            return ds != INT32_MAX and ds + 1 == int(dist[v])
    else:
        w = np.asarray(w, np.float32)
        reached = np.isfinite(dist) & (dist > 0)

        def ok(q, v):
            return np.float32(dist[src[q]]) + w[q] == dist[v]

    def first(b, e, v):
        return next((int(src[q]) for q in range(b, e) if ok(q, v)), -1)

    word = np.full(off.size - 1, NONE, np.uint64)
    ranges, listed = [], 0
    for v in np.flatnonzero(reached):
        b, e = int(off[v]), min(int(off[v + 1]), n_edges)
        hit = first(b, b + max(0, min(e - b, split)), v)
        if hit >= 0:
            word[v] = hit
        elif e - b > split:
            listed += 1
            ranges += [(q, min(q + split, e), v)
                       for q in range(b + split, e, split)]
    for i in np.random.default_rng(seed).permutation(len(ranges)):
        q0, q1, v = ranges[i]
        for base in range(q0, q1, STEP):
            if word[v] <= src[base]:
                break                       # nothing here can lower it
            hit = first(base, min(base + STEP, q1), v)
            if hit >= 0:
                word[v] = min(word[v], hit)
                break
    return word.astype(np.uint32).view(np.int32), listed, len(ranges)


def graph_cases():
    """{name: (JAX graph, port graph, source)}."""
    out = {}
    for split in SPLITS:
        coo, s = hub_coo(split)
        out[f"hub{split}"] = (*carried(coo, False), s)
        coo, s = hub_coo(split, directed=True)
        out[f"hub{split}d"] = (*carried(coo, True), s)
    rmat = jgen.rmat(10, 16, seed=4, undirected=True, weighted=True)
    out["rmat10"] = (*carried(rmat, False), 0)
    rmat_d = jgen.rmat(11, 16, seed=3, undirected=False, weighted=True)
    gj, g = carried(rmat_d, True)
    out["rmat11d"] = (gj, g, int(np.argmax(np.asarray(g.out_degrees()))))
    return out


@pytest.fixture(scope="module")
def graphs():
    return graph_cases()


@pytest.mark.parametrize("algo", ["bfs", "sssp"])
@pytest.mark.parametrize("split", SPLITS)
@pytest.mark.parametrize("name", ["hub", "hubd", "rmat10", "rmat11d"])
def test_walk_model_matches_plain_and_jax(graphs, name, split, algo):
    """The model at ``split`` equals the plain version at n_edges E, E - 1
    and E - PRED_CUT (and with the padding vertex reached, for SSSP), and
    JAX's predecessors at n_edges E; chip_smoke.pred_work counts what the
    model lists, within the scratch kernels.pred_ranges sizes."""
    key = f"{name[:3]}{split}{name[3:]}" if name.startswith("hub") else name
    gj, g, source = graphs[key]
    assert g.symmetric_layout == (name in ("hub", "rmat10"))
    cases = CS.pred_cases(g, source)[algo]
    plain = (kernels.bfs_predecessors_plain if algo == "bfs"
             else kernels.sssp_predecessors_plain)
    ranges = 0
    for args in cases:
        dist, off, src, n_edges = CS.pred_work_args(args)[:4]
        w = args[3] if algo == "sssp" else None
        pred, listed, nr = walk_model(dist, off, src, w, n_edges, split)
        assert np.array_equal(pred, plain(*args).numpy()), n_edges
        work = CS.pred_work(*CS.pred_work_args(args), split)
        assert (work["listed"], work["ranges"]) == (listed, nr), n_edges
        assert nr <= kernels.pred_ranges(src.numel(), split)
        ranges += nr
    want = np.asarray(_jax_pred[algo](gj, cases[0][0].numpy()))
    assert np.array_equal(plain(*cases[0]).numpy(), want)
    if name.startswith("hub"):
        # the hub lists PRED_HUB_RANGES ranges or more, and its only hit
        # is its segment's last real slot; cut, it has none
        assert ranges >= CS.PRED_HUB_RANGES
        hub = g.n_vertices - 1
        off = g.csc_offsets.numpy()
        assert want[hub] == g.csc_src_indices.numpy()[off[hub + 1] - 1]
        cut = next(a for a in cases if a[-1] == g.n_edges - 1)
        assert plain(*cut).numpy()[hub] == -1


@pytest.mark.parametrize("algo", ["bfs", "sssp"])
@pytest.mark.parametrize("name", ["hub32", "hub32d"])
def test_runs_give_jax_predecessors(graphs, name, algo):
    """bfs.run (fused on the symmetric layout, adaptive on the directed
    graph) returns JAX's predecessors of its distances, and reaches the hub
    from the chain's last vertex, n - 2; sssp.predecessors_from_distances
    of sssp.run's distances gives JAX's, and is what fused sssp.run returns
    (adaptive SSSP takes its predecessors from its own rounds, held against
    JAX's adaptive run in test_torch_adaptive.py)."""
    gj, g, source = graphs[name]
    variant = "fused" if g.symmetric_layout else "adaptive"
    v = g.n_vertices
    if algo == "bfs":
        r = tbfs.run(g, source, variant=variant, warmup=False)
        dist = CS.padded_dist(g, r.distances, INT32_MAX)
        pred = r.predecessors.numpy()
        assert pred[v - 1] == v - 2
    else:
        r = tsssp.run(g, source, variant=variant, warmup=False)
        dist = CS.padded_dist(g, r.distances, float("inf"))
        pred = tsssp.predecessors_from_distances(g, dist).numpy()[:v]
        if variant == "fused":
            assert np.array_equal(r.predecessors.numpy(), pred)
    want = np.asarray(_jax_pred[algo](gj, dist.numpy()))[:v]
    assert np.array_equal(pred, want)
    assert (want >= 0).sum() > v // 3
