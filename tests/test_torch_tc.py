"""Port parity: essentials_tpu_torch's triangle counting, bitmap engine and
intersection operator against essentials_tpu's, on the CPU.

The JAX package runs as its own tests run it (tests/test_bitmap_tc.py): its
Pallas bitmap kernel in interpret mode (``bi._INTERPRET = True``). Every
value compared here is an integer, so the tolerance is exact equality;
Jaccard similarities are float64 quotients of those integers, held to rtol
1e-12 as the JAX package's own test holds them."""

import gc

import numpy as np
import pytest
import torch

import essentials_tpu.ops.bitmap_intersect as jbi

jbi._INTERPRET = True

from essentials_tpu.algorithms import tc as jtc  # noqa: E402
from essentials_tpu.formats import Csr as JCsr  # noqa: E402
from essentials_tpu.formats.coo import Coo as JCoo  # noqa: E402
from essentials_tpu.io import generate as jgen  # noqa: E402
from essentials_tpu.ops import intersect as jintersect  # noqa: E402

from essentials_tpu_torch import kernels  # noqa: E402
from essentials_tpu_torch.algorithms import tc  # noqa: E402
from essentials_tpu_torch.errors import EssentialsError  # noqa: E402
from essentials_tpu_torch.formats import Coo, Csr  # noqa: E402
from essentials_tpu_torch.io import generate  # noqa: E402
from essentials_tpu_torch.ops import bitmap_intersect as bi  # noqa: E402
from essentials_tpu_torch.ops import intersect  # noqa: E402

# tests/test_bitmap_tc.py's graphs: (scale, edge factor, seed), undirected
GRAPHS = [(8, 8, 2), (10, 4, 7), (9, 8, 5), (9, 12, 3), (9, 12, 11)]


@pytest.fixture(autouse=True)
def fresh_jax_caches():
    """The JAX package caches by id(csr), and a graph of an earlier test can
    leave its entry at an id that this test's graph reuses (ROADMAP.md queue
    3): clear the caches so that JAX's results are its own."""
    for cache in (jtc._bitmap_cache, jtc._shift_cache,
                  jintersect._bitmap_cache):
        cache.clear()


def both_csrs(coo_args, gen=generate.rmat, jgen_fn=jgen.rmat, **kw):
    """The same graph as the port's Csr and the JAX package's."""
    kw = dict(undirected=True, weighted=False, **kw)
    csr = Csr.from_coo(gen(*coo_args, **kw))
    jcsr = JCsr.from_coo(jgen_fn(*coo_args, **kw))
    assert np.array_equal(csr.row_offsets, jcsr.row_offsets)
    assert np.array_equal(csr.col_indices, jcsr.col_indices)
    return csr, jcsr


def csr_from_edges(n: int, rows, cols):
    """Both packages' Csr of the undirected edge list (rows, cols)."""
    rows = np.asarray(rows, np.int32)
    cols = np.asarray(cols, np.int32)
    r, c = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    vals = np.ones(r.shape[0], np.float32)
    return (Csr.from_coo(Coo(n, n, r, c, vals)),
            JCsr.from_coo(JCoo(n, n, r, c, vals)))


# ----------------------------------------------------------- the engine --

@pytest.mark.parametrize("case", ["rmat8", "rmat10", "random300"])
def test_pack_bitmap_rows_bytes_match_jax(case):
    if case == "random300":
        rng = np.random.default_rng(0)
        n = 300
        src = rng.integers(0, n, 500).astype(np.int64)
        dst = rng.integers(0, n, 500).astype(np.int64)
    else:
        scale, ef, seed = {"rmat8": GRAPHS[0], "rmat10": GRAPHS[1]}[case]
        csr = both_csrs((scale, ef), seed=seed)[0]
        n = csr.n_rows
        src = np.repeat(np.arange(n), np.diff(csr.row_offsets))
        dst = csr.col_indices
    b = bi.pack_bitmap_rows(n, src, dst)
    jb = jbi.pack_bitmap_rows(n, src, dst)
    assert b.dtype == np.int32 and b.shape == (n + 1, jb.shape[1] * 128)
    assert b.tobytes() == np.asarray(jb).tobytes()
    assert not b[n].any()                      # the pad row stays zero


@pytest.mark.parametrize("witness", [True, False])
@pytest.mark.parametrize("graph", [GRAPHS[0], GRAPHS[1]])
def test_plain_bitmap_counts_match_interpret_kernel(graph, witness):
    scale, ef, seed = graph
    csr = both_csrs((scale, ef), seed=seed)[0]
    n = csr.n_rows
    _, es, ec = tc._oriented_csr(csr)
    bitmap = bi.pack_bitmap_rows(n, es, ec)
    ne = es.shape[0]
    e2 = -(-ne // jbi._EDGE_BLOCK) * jbi._EDGE_BLOCK
    eu = np.full(e2, n, np.int32)               # JAX pads to its edge block
    ev = np.full(e2, n, np.int32)
    eu[:ne], ev[:ne] = es, ec
    cnt_j, crole = jbi.bitmap_intersect_counts(
        eu, ev, bitmap.reshape(n + 1, -1, 128), witness=witness)
    kernels.reset_launches()
    cnt, wit = bi.bitmap_intersect_counts(
        torch.from_numpy(eu), torch.from_numpy(ev), torch.from_numpy(bitmap),
        witness=witness)
    assert kernels.launches["bitmap_intersect_counts"] == 0   # plain on CPU
    assert cnt.dtype == torch.int32
    assert np.array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert int(cnt[:ne].sum()) > 0 and not cnt[ne:].any()
    if witness:
        assert wit.shape == (bitmap.shape[1] * 32,)
        assert np.array_equal(bi.unpack_witness_counts(wit, n).numpy(),
                              jbi.unpack_witness_counts(np.asarray(crole), n))
    else:
        assert wit is None


def hub_pairs_inputs():
    """chip_smoke.hub_pairs_inputs: unsorted pairs with a hub u and pads."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.hub_pairs_inputs()


@pytest.mark.parametrize("witness", [True, False])
def test_plain_bitmap_counts_match_interpret_kernel_on_unsorted_pairs(
        witness):
    """Pairs in no order (a hub u with every word non-zero scattered among
    random pairs) and pads at the zero row among them, the card's grouping
    by u in any order: the plain version against JAX's kernel."""
    eu, ev, bitmap = hub_pairs_inputs()
    rows = bitmap.shape[0]
    assert not (np.diff(eu) >= 0).all() and (eu == rows - 1).any()
    e2 = -(-eu.size // jbi._EDGE_BLOCK) * jbi._EDGE_BLOCK
    eu = np.concatenate([eu, np.full(e2 - eu.size, rows - 1, np.int32)])
    ev = np.concatenate([ev, np.full(e2 - ev.size, rows - 1, np.int32)])
    cnt_j, crole = jbi.bitmap_intersect_counts(
        eu, ev, bitmap.reshape(rows, -1, 128), witness=witness)
    cnt, wit = bi.bitmap_intersect_counts(
        torch.from_numpy(eu), torch.from_numpy(ev), torch.from_numpy(bitmap),
        witness=witness)
    assert np.array_equal(cnt.numpy(), np.asarray(cnt_j))
    assert int(cnt[eu == 7].min()) > 0 and not cnt[eu == rows - 1].any()
    if witness:
        assert np.array_equal(
            bi.unpack_witness_counts(wit, bitmap.shape[1] * 32).numpy(),
            jbi.unpack_witness_counts(np.asarray(crole),
                                      bitmap.shape[1] * 32))
    else:
        assert wit is None


# ---------------------------------------------------------------- tc.run --

@pytest.mark.parametrize("variant", tc.VARIANTS)
@pytest.mark.parametrize("graph", GRAPHS)
def test_tc_variants_match_jax(graph, variant):
    scale, ef, seed = graph
    csr, jcsr = both_csrs((scale, ef), seed=seed)
    r_j = jtc.run(jcsr, warmup=False, variant=variant)
    r = tc.run(csr, device="cpu", warmup=False, variant=variant)
    assert r.total == r_j.total > 0
    assert r.vertex_triangles.dtype == torch.int32
    assert np.array_equal(r.vertex_triangles.numpy(),
                          np.asarray(r_j.vertex_triangles))
    if variant != "shift":
        total, vt = tc.cpu_reference(csr)
        assert r.total == total
        assert np.array_equal(r.vertex_triangles.numpy(), vt)


@pytest.mark.parametrize("variant", tc.VARIANTS)
@pytest.mark.parametrize("case", ["edgeless", "no_wedges"])
def test_tc_without_triangles_matches_jax(case, variant):
    n = 40
    if case == "edgeless":
        csr, jcsr = csr_from_edges(n, [], [])
    else:                                       # a perfect matching
        csr, jcsr = csr_from_edges(n, np.arange(0, n, 2), np.arange(1, n, 2))
    r_j = jtc.run(jcsr, warmup=False, variant=variant)
    r = tc.run(csr, device="cpu", warmup=False, variant=variant)
    assert r.total == r_j.total == 0
    assert r.vertex_triangles.shape == (n,)
    assert np.array_equal(r.vertex_triangles.numpy(),
                          np.asarray(r_j.vertex_triangles))


@pytest.mark.parametrize("seed", [3, 11])
def test_tc_shift_in_many_chunks_matches_jax(monkeypatch, seed):
    """The shift path with a small chunk budget in both packages, so that
    its passes split over several sorts: the same chunk plan and total."""
    csr, jcsr = both_csrs((9, 12), seed=seed)
    for mod in (tc, jtc):
        monkeypatch.setattr(mod, "_SHIFT_CHUNK", 1 << 14)
    chunks = jtc._shift_prep(jcsr)[3]
    assert len(chunks) > 3
    assert tc.shift_chunks(np.diff(tc._oriented_csr(csr)[0])) == list(chunks)
    assert tc._shift_prep(csr, "cpu")[3] == list(chunks)
    r = tc.run(csr, device="cpu", warmup=False, variant="shift")
    assert r.total == jtc.run(jcsr, warmup=False, variant="shift").total \
        == tc.cpu_reference_total(csr)


def test_tc_auto_follows_the_device(monkeypatch):
    assert tc.auto_variant(8192, "cuda") == tc.auto_variant(8192, "cpu") \
        == "dense"
    assert tc.auto_variant(8193, "cpu") == "sorted"
    assert tc.auto_variant(131072, "cuda") == "bitmap"       # rmat17: 2.1 GB
    assert tc.auto_variant(1 << 20, "cuda") == "shift"       # rmat20: 128 GB
    assert tc.auto_variant(100, "cuda", dense=False) == "bitmap"
    assert tc.auto_variant(1 << 20, "cpu", dense=True) == "dense"
    csr, jcsr = both_csrs((9, 8), seed=5)
    monkeypatch.setattr(tc, "_DENSE_MAX_V", 64)
    r = tc.run(csr, device="cpu", warmup=False)                # sorted
    assert r.total == jtc.run(jcsr, warmup=False, variant="sorted").total


def test_tc_bitmap_keeps_no_stale_graph():
    """The JAX package's id(csr)-keyed bitmap cache can serve a dropped
    graph's bitmap to a new graph at the same id (ROADMAP.md queue 3); the
    port keeps no cache."""
    first = both_csrs((9, 8), seed=5)[0]
    assert tc.run(first, device="cpu", variant="bitmap").total \
        == tc.cpu_reference(first)[0]
    del first
    gc.collect()
    second = both_csrs((9, 12), seed=3)[0]
    r = tc.run(second, device="cpu", variant="bitmap")
    total, vt = tc.cpu_reference(second)
    assert r.total == total
    assert np.array_equal(r.vertex_triangles.numpy(), vt)
    for name in ("_bitmap_cache", "_shift_cache"):
        assert not hasattr(tc, name) and not hasattr(intersect, name)


def test_tc_unknown_variant_raises():
    with pytest.raises(EssentialsError):
        tc.run(both_csrs((8, 8), seed=2)[0], device="cpu", variant="hash")


# ------------------------------------------------------ the intersection --

def host_sets(csr, u, v):
    off, cols = csr.row_offsets, csr.col_indices
    adj = [set(cols[off[i]:off[i + 1]].tolist()) for i in range(csr.n_rows)]
    ref = np.array([len(adj[a] & adj[b]) for a, b in zip(u, v)])
    wref = np.zeros(csr.n_rows, np.int64)
    for a, b in zip(u, v):
        for c in adj[a] & adj[b]:
            wref[c] += 1
    jac = np.array([len(adj[a] & adj[b]) / max(len(adj[a] | adj[b]), 1)
                    for a, b in zip(u, v)])
    return ref, wref, jac


@pytest.mark.parametrize("queries", ["numpy", "tensor"])
def test_intersection_counts_and_jaccard_match_jax(queries):
    csr, jcsr = both_csrs((8, 8), seed=9)
    rng = np.random.default_rng(0)
    u = rng.integers(0, csr.n_rows, 64)
    v = rng.integers(0, csr.n_rows, 64)
    got_j, wit_j = jintersect.intersection_counts(jcsr, u, v, witnesses=True)
    if queries == "tensor":       # CPU tensors: the results stay on the CPU
        got, wit = intersect.intersection_counts(
            csr, torch.from_numpy(u), torch.from_numpy(v), witnesses=True)
        jac = intersect.jaccard(csr, torch.from_numpy(u), torch.from_numpy(v))
    else:
        got, wit = intersect.intersection_counts(csr, u, v, witnesses=True,
                                                 device="cpu")
        jac = intersect.jaccard(csr, u, v, device="cpu")
    assert got.device.type == wit.device.type == jac.device.type == "cpu"
    assert got.dtype == torch.int32 and wit.dtype == torch.int64
    assert np.array_equal(got.numpy(), np.asarray(got_j))
    assert np.array_equal(wit.numpy(), np.asarray(wit_j))
    ref, wref, jref = host_sets(csr, u, v)
    assert np.array_equal(got.numpy(), ref) and np.array_equal(wit.numpy(),
                                                               wref)
    assert jac.dtype == torch.float64
    np.testing.assert_allclose(jac.numpy(), jintersect.jaccard(jcsr, u, v),
                               rtol=1e-12)
    np.testing.assert_allclose(jac.numpy(), jref, rtol=1e-12)
    assert np.array_equal(
        intersect.intersection_counts(csr, u, v, device="cpu").numpy(), ref)


@pytest.mark.parametrize("witnesses", [True, False])
def test_chunked_intersection_matches_jax(monkeypatch, witnesses):
    """The chunked engine, forced with a small dense cap and chunk budget in
    both packages (as tests/test_bitmap_tc.py does): 3 column chunks."""
    csr, jcsr = both_csrs((10000, 4), gen=generate.uniform_random,
                          jgen_fn=jgen.uniform_random, seed=4)
    rng = np.random.default_rng(1)
    u = rng.integers(0, csr.n_rows, 48)
    v = rng.integers(0, csr.n_rows, 48)
    ref, wref, _ = host_sets(csr, u, v)
    for mod in (intersect, jintersect):
        monkeypatch.setattr(mod, "_DENSE_V_MAX", 64)
        monkeypatch.setattr(mod, "_CHUNK_BYTES", 1 << 12)
    out_j = jintersect.intersection_counts(jcsr, u, v, witnesses=witnesses)
    out = intersect.intersection_counts(csr, u, v, witnesses=witnesses,
                                        device="cpu")
    if witnesses:
        (got, wit), (got_j, wit_j) = out, out_j
        assert np.array_equal(wit.numpy(), np.asarray(wit_j))
        assert np.array_equal(wit.numpy(), wref)
    else:
        got, got_j = out, out_j
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(got_j))
    assert np.array_equal(got.numpy(), ref)


def test_intersection_keeps_no_stale_graph():
    first = both_csrs((8, 8), seed=9)[0]
    u, v = np.arange(0, 40), np.arange(40, 80)
    assert np.array_equal(intersect.intersection_counts(
        first, u, v, device="cpu").numpy(), host_sets(first, u, v)[0])
    del first
    gc.collect()
    second = both_csrs((8, 8), seed=2)[0]
    assert np.array_equal(intersect.intersection_counts(
        second, u, v, device="cpu").numpy(), host_sets(second, u, v)[0])


# -------------------------------------------------------------- wrappers --

def test_bitmap_wrapper_refuses_bad_arguments():
    b = torch.zeros((5, 128), dtype=torch.int32)
    e = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(EssentialsError):           # words not a multiple of 4
        kernels.bitmap_intersect_counts(e, e, b[:, :6].contiguous())
    with pytest.raises(EssentialsError):           # int64 ids
        kernels.bitmap_intersect_counts(e.long(), e.long(), b)
    with pytest.raises(EssentialsError):           # no kernel for this device
        kernels.bitmap_intersect_counts(e.to("meta"), e.to("meta"),
                                        b.to("meta"))
