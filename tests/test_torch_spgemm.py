"""Port parity: essentials_tpu_torch's SpGEMM (the static plan and the
chunked path, resident and streamed) and the algorithm helpers against
essentials_tpu's and the float64 host Gustavson, on the CPU.

Both packages multiply the same host CSRs. C's structure (row offsets,
column indices) is exact; values are held within rtol 1e-5 (atol 1e-5 for
entries near 0) of the JAX package's and of the float64 host: each value
is a float32 sum of float32 products, rounded in each package in its own
order. The host Gustavson keeps every structural entry, also where values
cancel, as the JAX package's does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import helpers as jhelpers, spgemm as jsp
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.io import generate as jgen
from essentials_tpu.io.sample import sample_csr as jsample

from essentials_tpu_torch.algorithms import helpers, spgemm
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.formats import Csr

RTOL, ATOL = 1e-5, 1e-5


def port_csr(c) -> Csr:
    return Csr(c.n_rows, c.n_cols, np.asarray(c.row_offsets),
               np.asarray(c.col_indices), np.asarray(c.values))


def uniform(n, deg, seed):
    return JCsr.from_coo(jgen.uniform_random(n, deg, seed=seed,
                                             undirected=False))


EYE = JCsr(4, 4, np.arange(5, dtype=np.int32), np.arange(4, dtype=np.int32),
           np.ones(4, np.float32))
PAIRS = {   # tests/test_algorithms2.py's products
    "identity": lambda: (jsample(), EYE),
    "random30": lambda: (uniform(30, 3, 2), uniform(30, 3, 3)),
    "dense20": lambda: (uniform(20, 4, 5), uniform(20, 4, 6)),
    "reuse40": lambda: (uniform(40, 4, 9), uniform(40, 4, 10)),
    "chunk60": lambda: (uniform(60, 5, 12), uniform(60, 4, 13)),
    "square80": lambda: (uniform(80, 5, 22),) * 2,
}
_cache = {}


def pair(name):
    """(JAX a, JAX b, port a, port b, JAX's static result)."""
    if name not in _cache:
        a, b = PAIRS[name]()
        _cache[name] = (a, b, port_csr(a), port_csr(b),
                        jsp.run(a, b, warmup=False).c)
    return _cache[name]


def hold(c, ref) -> None:
    assert np.array_equal(np.asarray(c.row_offsets),
                          np.asarray(ref.row_offsets))
    assert np.array_equal(np.asarray(c.col_indices),
                          np.asarray(ref.col_indices))
    assert np.allclose(np.asarray(c.values, np.float64),
                       np.asarray(ref.values, np.float64),
                       rtol=RTOL, atol=ATOL)


def dense(csr, r, c):
    d = np.zeros((r, c))
    src = np.repeat(np.arange(r), np.diff(csr.row_offsets))
    d[src, np.asarray(csr.col_indices)] = np.asarray(csr.values)
    return d


@pytest.mark.parametrize("name", list(PAIRS))
def test_spgemm_static_matches_jax_and_host(name):
    a, b, pa, pb, cj = pair(name)
    r = spgemm.run(pa, pb, warmup=False, device="cpu")
    assert np.asarray(r.c.values).dtype == np.float32
    hold(r.c, cj)
    ref = spgemm.cpu_reference(pa, pb)
    hold(r.c, ref)
    hold(cj, ref)
    assert np.allclose(dense(r.c, pa.n_rows, pb.n_cols),
                       dense(pa, pa.n_rows, pa.n_cols)
                       @ dense(pb, pb.n_rows, pb.n_cols), rtol=1e-4)


def test_spgemm_identity_values():
    """tests/test_algorithms2.py's sample CSR times the identity."""
    _, _, pa, pb, _ = pair("identity")
    c = spgemm.run(pa, pb, warmup=False, device="cpu").c
    assert np.array_equal(c.row_offsets, [0, 0, 0, 2, 4])
    assert np.array_equal(c.col_indices, [1, 3, 2, 3])
    assert np.array_equal(c.values, np.float32([8, 5, 3, 6]))


def test_spgemm_plan_reuse_across_values():
    """The symbolic plan is value-independent: new values, same
    structure."""
    _, _, pa, pb, _ = pair("reuse40")
    plan = spgemm.make_plan(pa, pb, device="cpu")
    r1 = spgemm.run(pa, pb, warmup=False, plan=plan)
    rng = np.random.default_rng(7)
    a2 = Csr(pa.n_rows, pa.n_cols, pa.row_offsets, pa.col_indices,
             rng.random(pa.nnz).astype(np.float32))
    b2 = Csr(pb.n_rows, pb.n_cols, pb.row_offsets, pb.col_indices,
             rng.random(pb.nnz).astype(np.float32))
    r2 = spgemm.run(a2, b2, warmup=False, plan=plan)
    hold(r2.c, spgemm.cpu_reference(a2, b2))
    hold(r2.c, jsp.run(JCsr(a2.n_rows, a2.n_cols, a2.row_offsets,
                            a2.col_indices, a2.values),
                       JCsr(b2.n_rows, b2.n_cols, b2.row_offsets,
                            b2.col_indices, b2.values), warmup=False).c)
    assert not np.allclose(r1.c.values, r2.c.values)
    assert plan.n_products == int(plan.c_offsets[-1])
    assert plan.c_nnz == r1.c.nnz


def test_spgemm_empty_and_mismatch():
    a = Csr(3, 3, np.zeros(4, np.int32), np.empty(0, np.int32),
            np.empty(0, np.float32))
    assert spgemm.make_plan(a, a, device="cpu") is None
    assert spgemm.make_chunked_plan(a, a) is None
    for c in (spgemm.run(a, a, device="cpu").c,
              spgemm.run_chunked(a, a, device="cpu").c,
              spgemm.cpu_reference(a, a)):
        assert c.nnz == 0 and np.array_equal(c.row_offsets, [0, 0, 0, 0])
    _, _, pa, _, _ = pair("random30")
    with pytest.raises(EssentialsError, match="inner dimensions"):
        spgemm.make_plan(pa, port_csr(jsample()), device="cpu")


CHUNKS = [(1 << 7, 1 << 5), (1 << 9, 1 << 12), (1 << 22, 1 << 22),
          (1 << 8, 3)]


@pytest.mark.parametrize("wc,ec", CHUNKS)
def test_spgemm_chunked_matches_jax_and_host(wc, ec):
    """Chunks of tests/test_algorithms2.py's sizes, down to rows split
    across chunks (the merge map folds their runs), resident and streamed:
    the same chunk boundaries, layout and merge map as the JAX package's
    plan, the values equal in both modes, and against JAX's and the
    host's."""
    a, b, pa, pb, cj = pair("chunk60")
    plan = spgemm.make_chunked_plan(pa, pb, chunk_products=wc,
                                    chunk_edges=ec)
    jplan = jsp.make_chunked_plan(a, b, chunk_products=wc, chunk_edges=ec)
    assert plan.chunks == jplan.chunks
    assert plan.c_dev_total == jplan.c_dev_total
    for f in ("merge_spans", "merge_order", "merge_offsets",
              "c_row_offsets", "c_col_indices"):
        assert np.array_equal(getattr(plan, f), getattr(jplan, f)), f
    assert sum(n for _, _, n in spgemm.device_batches(plan)) \
        == plan.n_products
    ref = spgemm.cpu_reference(pa, pb)
    vals = {}
    for stream in (False, True):
        vals[stream] = spgemm.numeric_chunked(plan, pa, pb,
                                              stream_to_host=stream,
                                              device="cpu")
        hold(Csr(pa.n_rows, pb.n_cols, plan.c_row_offsets,
                 plan.c_col_indices, vals[stream]), ref)
    assert np.array_equal(vals[False], vals[True])
    hold(spgemm.run_chunked(pa, pb, chunk_products=wc, chunk_edges=ec,
                            warmup=False, device="cpu").c, cj)
    jc = jsp.run_chunked(a, b, chunk_products=wc, chunk_edges=ec,
                         warmup=False).c
    hold(jc, ref)


def test_spgemm_chunked_split_rows_streamed():
    """tests/test_algorithms2.py's streamed-mode case (A @ A, chunks of
    256 products and 64 edges), and chunks of 3 edges that split rows:
    merge spans, streamed values equal resident ones and JAX's."""
    a, _, pa, _, _ = pair("square80")
    ref = spgemm.cpu_reference(pa, pa)
    for wc, ec in ((1 << 8, 1 << 6), (1 << 12, 3)):
        plan = spgemm.make_chunked_plan(pa, pa, chunk_products=wc,
                                        chunk_edges=ec)
        jplan = jsp.make_chunked_plan(a, a, chunk_products=wc,
                                      chunk_edges=ec)
        v_res = spgemm.numeric_chunked(plan, pa, pa, stream_to_host=False,
                                       device="cpu")
        v_str = spgemm.numeric_chunked(plan, pa, pa, stream_to_host=True,
                                       device="cpu")
        assert np.array_equal(v_res, v_str)
        assert np.array_equal(plan.c_col_indices, ref.col_indices)
        assert np.allclose(v_str, ref.values, rtol=RTOL, atol=ATOL)
        v_jax = jsp.numeric_chunked(jplan, a, a, stream_to_host=True)
        assert np.allclose(v_str, v_jax, rtol=RTOL, atol=ATOL)
        assert (plan.merge_spans.shape[0] > 0) == (ec == 3)


def test_spgemm_chunked_plan_cache(tmp_path):
    """The plan's cache file has a name of the port's own and gives back
    the same plan."""
    _, _, pa, pb, _ = pair("chunk60")
    kw = dict(chunk_products=1 << 8, chunk_edges=3, cache_dir=str(tmp_path))
    plan = spgemm.make_chunked_plan(pa, pb, **kw)
    files = [p.name for p in tmp_path.iterdir()]
    assert len(files) == 1 and files[0].startswith("spgemm_chunked_torch_")
    again = spgemm.make_chunked_plan(pa, pb, **kw)
    assert again.chunks == plan.chunks
    for f in ("merge_spans", "merge_order", "merge_offsets",
              "c_row_offsets", "c_col_indices"):
        assert np.array_equal(getattr(again, f), getattr(plan, f)), f


@pytest.mark.parametrize("name", ["random30", "chunk60"])
def test_spgemm_cpu_reference_matches_jax(name):
    """The vectorised host Gustavson against the JAX package's dict
    Gustavson, both float64 cast to float32: structure exact, values
    within a float32 ulp."""
    _, _, pa, pb, _ = pair(name)
    a, b = PAIRS[name]()
    mine, theirs = spgemm.cpu_reference(pa, pb), jsp.cpu_reference(a, b)
    assert np.array_equal(mine.row_offsets, theirs.row_offsets)
    assert np.array_equal(mine.col_indices, theirs.col_indices)
    assert np.allclose(mine.values, theirs.values, rtol=2.0 ** -23, atol=0)


def test_cpu_reference_keeps_cancelled_entries():
    """A value that cancels to 0 stays in C's structure."""
    a = Csr(1, 2, np.int32([0, 2]), np.int32([0, 1]), np.float32([1, -1]))
    b = Csr(2, 1, np.int32([0, 1, 2]), np.int32([0, 0]), np.float32([1, 1]))
    c = spgemm.cpu_reference(a, b)
    assert c.nnz == 1 and c.values[0] == 0.0
    r = spgemm.run(a, b, warmup=False, device="cpu").c
    assert r.nnz == 1 and r.values[0] == 0.0


def test_helpers_search_sort():
    """tests/test_algorithms2.py's helper cases, against the JAX
    package's."""
    keys = torch.tensor([1, 3, 3, 7, 9])
    jkeys = jnp.asarray([1, 3, 3, 7, 9])
    for fn, arg in (("lower_bound", 3), ("upper_bound", 3),
                    ("rightmost", 4), ("rightmost", 0)):
        assert int(getattr(helpers, fn)(keys, arg)) \
            == int(getattr(jhelpers, fn)(jkeys, arg))
    assert int(helpers.lower_bound(keys, 3)) == 1
    assert int(helpers.upper_bound(keys, 3)) == 3
    assert int(helpers.rightmost(keys, 4)) == 2
    assert int(helpers.rightmost(keys, 0)) == -1
    needles = [0, 3, 8, 10]
    assert np.array_equal(helpers.lower_bound(keys, needles).numpy(),
                          np.asarray(jhelpers.lower_bound(jkeys,
                                                          jnp.asarray(
                                                              needles))))
    sk = helpers.sort_keys(torch.tensor([3, 1, 2]), descending=True)
    assert sk.tolist() == [3, 2, 1]
    assert np.array_equal(sk.numpy(), np.asarray(jhelpers.sort_keys(
        jnp.asarray([3, 1, 2]), descending=True)))
    k, v = helpers.sort_pairs(torch.tensor([3, 1, 2]),
                              torch.tensor([30, 10, 20]))
    assert v.tolist() == [10, 20, 30] and k.tolist() == [1, 2, 3]
    k, v = helpers.sort_pairs(torch.tensor([3, 1, 2]),
                              torch.tensor([30, 10, 20]), descending=True)
    assert v.tolist() == [30, 20, 10]


def test_helpers_uniform_distribution():
    """A torch.Generator takes the place of JAX's key: the same seed gives
    the same draws, within [low, high)."""
    a = helpers.uniform_distribution(torch.Generator().manual_seed(5),
                                     (1000,), -2.0, 3.0)
    b = helpers.uniform_distribution(torch.Generator().manual_seed(5),
                                     (1000,), -2.0, 3.0)
    assert a.dtype == torch.float32 and torch.equal(a, b)
    assert float(a.min()) >= -2.0 and float(a.max()) < 3.0
