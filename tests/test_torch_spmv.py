"""Port parity: essentials_tpu_torch's SpMV (ops.fused_spmv,
ops.windowed_spmv, algorithms.spmv and the kernel wrappers' plain versions)
against essentials_tpu's, on the CPU.

Both packages compute the same float32 products and sum them in different
orders, so sums are held to |y - ref| <= 1e-5 |ref| + 1e-6 (x is uniform in
[0, 1) and the weights are positive, so no sum cancels); ``min`` reductions
and ``add`` messages under ``min`` compare int32 bits exactly. The JAX
graphs are built with router plans and carried into the port with
graph_from_arrays, so both packages compute on the same arrays."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from essentials_tpu.algorithms import spmv as jspmv
from essentials_tpu.formats import Coo as JCoo
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.graph import build_graph as jbuild
from essentials_tpu.io import generate as jgen
from essentials_tpu.io import load_graph_file as jload
from essentials_tpu.ops import fused_spmv as jfs
from essentials_tpu.ops import windowed_spmv as jws

from essentials_tpu_torch import kernels
from essentials_tpu_torch.algorithms import spmv as tspmv
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.formats import Coo, Csr
from essentials_tpu_torch.graph import build_graph, graph_from_arrays
from essentials_tpu_torch.graph.graph import ARRAY_FIELDS, META_FIELDS
from essentials_tpu_torch.ops import fused_spmv as tfs
from essentials_tpu_torch.ops import windowed_spmv as tws

RTOL, ATOL = 1e-5, 1e-6
_jax_pull = jax.jit(jspmv.spmv_pull)
_jax_fused = jax.jit(jfs.spmv_fused, static_argnames=("use_pallas", "unit"))


def both_graphs(csr, directed=True):
    gj = jbuild(csr, directed=directed, weighted=True, build_router=True)
    fields = {f: np.asarray(getattr(gj, f)) for f in ARRAY_FIELDS}
    meta = {f: getattr(gj, f) for f in META_FIELDS}
    return csr, gj, graph_from_arrays(fields, meta, "cpu")


@pytest.fixture(scope="module")
def graphs():
    rmat = {s: JCsr.from_coo(jgen.rmat(s, 16, seed=3, undirected=False,
                                       weighted=True)) for s in (12, 14)}
    return {"rmat12": both_graphs(rmat[12]), "rmat14": both_graphs(rmat[14]),
            "chesapeake": both_graphs(
                jload("datasets/chesapeake.mtx", cache=False),
                directed=False)}


@pytest.fixture(scope="module")
def plans(graphs):
    """The JAX windowed plans; rmat14's has two 131,072-edge slabs."""
    out = {name: jws.build_windowed_plan(graphs[name][1])
           for name in ("rmat12", "rmat14")}
    assert out["rmat12"].G == 1 and out["rmat14"].G == 2
    return out


def vector(g, seed=1):
    x = np.random.default_rng(seed).random(g.n_vertices_padded) \
        .astype(np.float32)
    x[g.n_vertices:] = 0
    return x


def close(y, ref):
    np.testing.assert_allclose(np.asarray(y, np.float64),
                               np.asarray(ref, np.float64),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("name", ["rmat12", "rmat14"])
def test_spmv_fused_matches_jax_chain(graphs, name, unit):
    _, gj, g = graphs[name]
    assert jfs.fused_spmv_supported(gj) and tfs.fused_spmv_supported(g)
    x = vector(g)
    y = tfs.spmv_fused(g, torch.from_numpy(x), unit=unit)
    assert y.dtype == torch.float32 and y.shape == (g.n_vertices_padded,)
    ref = _jax_fused(gj, jnp.asarray(x), use_pallas=False, unit=unit)
    close(y.numpy()[:g.n_vertices], np.asarray(ref)[:g.n_vertices])


@pytest.mark.parametrize("unit", [False, True])
@pytest.mark.parametrize("name", ["rmat12", "rmat14"])
def test_spmv_windowed_matches_jax_ref(graphs, plans, name, unit):
    _, gj, g = graphs[name]
    x = vector(g, 2)
    y = tws.spmv_windowed(g, torch.from_numpy(x), unit=unit)
    assert y.dtype == torch.float32 and y.shape == (g.n_vertices_padded,)
    ref = jws.spmv_windowed_ref(gj, plans[name], jnp.asarray(x), unit=unit)
    close(y.numpy()[:g.n_vertices], np.asarray(ref)[:g.n_vertices])


@pytest.mark.parametrize("variant", ["fused", "windowed", "auto"])
@pytest.mark.parametrize("name", ["rmat12", "rmat14", "chesapeake"])
def test_spmv_run_matches_pull_and_host(graphs, name, variant):
    csr, gj, g = graphs[name]
    x = vector(g, 3)
    r = tspmv.run(g, torch.from_numpy(x), variant=variant, warmup=False)
    assert r.y.shape == (g.n_vertices,) and r.elapsed_ms >= 0
    pull = np.asarray(_jax_pull(gj, jnp.asarray(x)))[:g.n_vertices]
    host = jspmv.cpu_reference(csr, x[:g.n_vertices])
    close(r.y.numpy(), pull)
    close(r.y.numpy(), host)
    close(tspmv.cpu_reference(csr, x[:g.n_vertices]), host)


def test_spmv_run_default_x_is_seeded(graphs):
    _, _, g = graphs["rmat12"]
    a = tspmv.run(g, variant="fused", seed=5, warmup=False).y
    b = tspmv.run(g, variant="windowed", seed=5, warmup=False).y
    close(a.numpy(), b.numpy())
    x = tspmv.random_x(g, 5)
    assert torch.all(x[g.n_vertices:] == 0) and torch.all(x[:g.n_vertices] < 1)
    assert torch.equal(x, tspmv.random_x(g, 5))
    assert not torch.equal(x, tspmv.random_x(g, 6))


# ---------------------------------------------------- windowed_pipeline --

def jax_pipeline(gj, plan, x, w_csr, message, reduce):
    """JAX's windowed_pipeline_ref on the vertex axis: x is compacted
    through plan.xc_perm, the CSR-order weights are carried to CSC order,
    and the compact output is spread back by y_src_rank / y_mask."""
    w_l = np.zeros(plan.L, np.float32)
    w_l[:gj.n_edges_padded] = w_csr[np.asarray(gj.csc_edge_ids)]
    xc = jnp.asarray(x)[plan.xc_perm]
    yc = np.asarray(jws.windowed_pipeline_ref(gj, plan, xc, message, reduce,
                                              w_l=jnp.asarray(w_l)))
    ident = jws.INF_BITS if reduce == "min" else 0
    return np.where(np.asarray(plan.y_mask), yc[np.asarray(plan.y_src_rank)],
                    ident).astype(np.int32)


@pytest.mark.parametrize("reduce", ["sum", "min"])
@pytest.mark.parametrize("message", ["mul", "add", "none"])
@pytest.mark.parametrize("name", ["rmat12", "rmat14"])
def test_windowed_pipeline_matches_jax_ref(graphs, plans, name, message,
                                           reduce):
    _, gj, g = graphs[name]
    x = vector(g, 4)
    w = np.random.default_rng(5).random(g.n_edges_padded).astype(np.float32)
    w = w * 63 + 1
    w[g.n_edges:] = 0
    y = tws.windowed_pipeline(g, torch.from_numpy(x), message=message,
                              reduce=reduce, w=torch.from_numpy(w))
    assert y.dtype == torch.int32 and y.shape == (g.n_vertices_padded,)
    ref = jax_pipeline(gj, plans[name], x, w, message, reduce)
    v = g.n_vertices
    if reduce == "min":
        assert np.array_equal(y.numpy()[:v], ref[:v])
    else:
        close(y.numpy()[:v].view(np.float32), ref[:v].view(np.float32))
    empty = (g.row_offsets[1:] == g.row_offsets[:-1]).numpy()
    assert np.all(y.numpy()[empty] == (tws.INF_BITS if reduce == "min"
                                       else 0))


def rows_graph(n, lengths):
    """A directed weighted graph on ``n`` vertices whose row r has
    lengths[r] edges (rows past the list are empty)."""
    rows = np.repeat(np.arange(len(lengths)), lengths)
    cols = (np.arange(rows.size) * 7 + rows) % n
    vals = np.random.default_rng(0).random(rows.size).astype(np.float32) + 1
    csr = Csr.from_coo(Coo(n, n, rows.astype(np.int32),
                           cols.astype(np.int32), vals))
    return csr, build_graph(csr, directed=True, weighted=True, device="cpu")


def hub_graph():
    """With s = SLAB_EDGES: a row of 100 edges, a hub row of 3s + 104 that
    starts in slab 0 and ends in slab 3, rows of one edge, a row of s + 52,
    and empty rows between them."""
    s = kernels.SLAB_EDGES
    return rows_graph(40, [0, 100, 0, 3 * s + 104, 0] + [1] * 25
                      + [0, s + 52])


def boundary_graph():
    """Rows that meet the slab boundaries (s = SLAB_EDGES): a row of s edges
    that ends on one, empty rows at it, a row of 2s that starts on one, holds
    slab 1 whole and ends on the next, a row of one edge, a row of 2s - 1
    that crosses into slab 4, rows of one edge and an empty row."""
    s = kernels.SLAB_EDGES
    return rows_graph(24, [s, 0, 0, 2 * s, 1, 2 * s - 1, 0, 1, 1, 0, 1])


def reference_bits(g, x, message, reduce):
    """The pipeline's [Vp] result from float64 sums or int32-bit minima over
    the CSR rows, with the identity at empty rows."""
    src, col = g.src_indices.long(), g.col_indices.long()
    msg = {"mul": x[col] * g.values, "add": x[col] + g.values,
           "none": x[col]}[message]
    if reduce == "min":
        ref = torch.full((g.n_vertices_padded,), tws.INF_BITS,
                         dtype=torch.int32)
        return ref.scatter_reduce_(0, src, msg.view(torch.int32), "amin")
    ref = torch.zeros(g.n_vertices_padded, dtype=torch.float64)
    return ref.index_add_(0, src, msg.double())


@pytest.mark.parametrize("reduce", ["sum", "min"])
@pytest.mark.parametrize("message", ["mul", "add", "none"])
def test_windowed_pipeline_rows_across_slabs(message, reduce):
    csr, g = hub_graph()
    s = kernels.SLAB_EDGES
    hub_start, hub_end = int(g.row_offsets[3]), int(g.row_offsets[4])
    assert 0 < hub_start < s and 3 * s < hub_end < 4 * s   # slabs 0-3
    assert g.max_degree > 2 * s
    x = torch.from_numpy(vector(g, 6))
    y = tws.windowed_pipeline(g, x, message=message, reduce=reduce)
    ref = reference_bits(g, x, message, reduce)
    if reduce == "min":
        assert torch.equal(y, ref)
    else:
        close(y.view(torch.float32).numpy(), ref.numpy())


@pytest.mark.parametrize("reduce", ["sum", "min"])
def test_windowed_pipeline_at_slab_boundaries(reduce):
    """Rows that end on a slab boundary, start on one, hold a slab whole,
    and empty rows at a boundary: every row's result, in each message."""
    _, g = boundary_graph()
    off, s = g.row_offsets, kernels.SLAB_EDGES
    assert int(off[1]) == s and int(off[4]) == 3 * s     # on the boundaries
    assert int(off[6]) > 4 * s > int(off[5])              # crosses into 4
    x = torch.from_numpy(vector(g, 7))
    for message in kernels.MESSAGES:
        y = tws.windowed_pipeline(g, x, message=message, reduce=reduce)
        ref = reference_bits(g, x, message, reduce)
        if reduce == "min":
            assert torch.equal(y, ref), message
        else:
            close(y.view(torch.float32).numpy(), ref.numpy())


def host_fold(add, parts):
    """The parts folded in order by ``add``."""
    acc = None
    for p in parts:
        acc = p if acc is None else add(acc, p)
    return acc


def host_over(add, lo, hi, step, inner):
    """inner(a, b) over the pieces [a, b) of [lo, hi) cut at multiples of
    step, folded in order."""
    return host_fold(add, (inner(a, min(hi, (a // step + 1) * step))
                           for a in [lo] + list(range((lo // step + 1) * step,
                                                      hi, step))))


@pytest.mark.parametrize("reduce", ["sum", "min"])
def test_spmv_slabs_plain_folds_partials_in_slab_order(reduce):
    """The plain version's arithmetic is the kernel's: a row's edges within
    each SLAB_ITEMS group (a thread's) in edge order, the groups within
    each slab, then the slab partials in slab order, each a float32 sum.
    Held bitwise against that computed on the host."""
    _, g = hub_graph()
    off = g.row_offsets.numpy()
    x = torch.from_numpy(vector(g, 8))
    msg = (x[g.col_indices.long()] * g.values).numpy()
    add = (lambda a, b: np.float32(a + b)) if reduce == "sum" else min
    want = np.full(g.n_vertices_padded,
                   0 if reduce == "sum" else np.inf, np.float32)
    for r in range(g.n_vertices_padded):
        if off[r + 1] > off[r]:
            want[r] = host_over(
                add, off[r], off[r + 1], kernels.SLAB_EDGES,
                lambda a, b: host_over(add, a, b, kernels.SLAB_ITEMS,
                                       lambda c, d: host_fold(add,
                                                              msg[c:d])))
    y = kernels.spmv_slabs_plain(g.row_offsets, g.col_indices, g.values,
                                 g.csr_seg_flags, x, "mul", reduce)
    assert np.array_equal(y.numpy(), want.view(np.int32))


@pytest.mark.parametrize("unit", [False, True])
def test_spmv_rows_plain_folds_in_merge_path_order(unit):
    """spmv_rows' plain version groups as the kernel does: edge p of row r
    sits at place p + r of the merged row ends and edges; a row's edges
    within one ROW_ITEMS run of places (a thread's) in edge order, the runs
    within each ROW_TILE tile, then the tile partials in tile order, each
    a float32 sum. Held bitwise against that computed on the host, on rows
    of up to six tiles and empty rows between them."""
    _, g = hub_graph()
    off = g.row_offsets.numpy()
    x = torch.from_numpy(vector(g, 10))
    msg = x[g.col_indices.long()]
    msg = (msg if unit else msg * g.values).numpy()
    assert g.max_degree > 5 * kernels.ROW_TILE
    add = lambda a, b: np.float32(a + b)              # noqa: E731
    want = np.zeros(g.n_vertices_padded, np.float32)
    for r in range(g.n_vertices_padded):
        if off[r + 1] > off[r]:
            want[r] = host_over(
                add, off[r] + r, off[r + 1] + r, kernels.ROW_TILE,
                lambda a, b: host_over(
                    add, a, b, kernels.ROW_ITEMS,
                    lambda c, d, r=r: host_fold(add, msg[c - r:d - r])))
    y = kernels.spmv_rows_plain(g.row_offsets, g.col_indices,
                                None if unit else g.values, x)
    assert np.array_equal(y.numpy().view(np.int32), want.view(np.int32))


@pytest.fixture(scope="module")
def hub_rows():
    """rmat12 seed 3 with the rows 1000-1599 emptied and a hub row of
    3 * ROW_TILE + 41 edges appended at row 5, in both packages."""
    coo = jgen.rmat(12, 16, seed=3, undirected=False, weighted=True)
    keep = (coo.row_indices < 1000) | (coo.row_indices >= 1600)
    n = 3 * kernels.ROW_TILE + 41
    return both_graphs(JCsr.from_coo(JCoo(
        coo.n_rows, coo.n_cols,
        np.r_[coo.row_indices[keep], np.full(n, 5, np.int32)],
        np.r_[coo.col_indices[keep],
              (np.arange(n) * 11 % coo.n_cols).astype(np.int32)],
        np.r_[coo.values[keep], np.linspace(0.5, 2.0, n,
                                            dtype=np.float32)])))


@pytest.mark.parametrize("unit", [False, True])
def test_spmv_rows_plain_on_a_hub_matches_jax_chain_and_float64(hub_rows,
                                                                 unit):
    """The fused product (spmv_rows' plain version on the CPU) on a hub row
    of several thousand edges and a run of 600 empty rows, against JAX's
    chain and a float64 host product, each within 1e-5 |ref| + 1e-6."""
    csr, gj, g = hub_rows
    off = g.row_offsets.numpy()
    assert g.max_degree > 3 * kernels.ROW_TILE
    assert np.all(off[1001:1601] == off[1000:1600])
    x = vector(g, 9)
    y = tfs.spmv_fused(g, torch.from_numpy(x), unit=unit).numpy()
    v = g.n_vertices
    ref = _jax_fused(gj, jnp.asarray(x), use_pallas=False, unit=unit)
    close(y[:v], np.asarray(ref)[:v])
    w = np.ones(csr.nnz) if unit else np.asarray(csr.values, np.float64)
    host = np.bincount(np.repeat(np.arange(csr.n_rows),
                                 np.diff(csr.row_offsets)),
                       weights=w * x.astype(np.float64)[csr.col_indices],
                       minlength=csr.n_rows)
    close(y[:v], host)
    assert np.all(y[1000:1600] == 0)


# ------------------------------------------------------------- wrappers --

def test_wrappers_take_plain_version_on_cpu(graphs):
    _, _, g = graphs["rmat12"]
    kernels.reset_launches()
    x = torch.from_numpy(vector(g))
    for unit in (False, True):
        tfs.spmv_fused(g, x, unit=unit)
        tws.spmv_windowed(g, x, unit=unit)
    assert all(n == 0 for n in kernels.launches.values())


@pytest.mark.parametrize("call", ["rows", "slabs"])
def test_spmv_wrappers_raise_on_other_devices(call):
    _, g = hub_graph()
    g = g.to("meta")
    x = torch.empty(g.n_vertices_padded, device="meta")
    with pytest.raises(EssentialsError):
        if call == "rows":
            kernels.spmv_rows(g.row_offsets, g.col_indices, None, x)
        else:
            kernels.spmv_slabs(g.row_offsets, g.col_indices, None,
                               g.csr_seg_flags, x, "none", "sum")


def test_spmv_wrappers_reject_bad_arguments():
    _, g = hub_graph()
    off, col, fl = g.row_offsets, g.col_indices, g.csr_seg_flags
    x = torch.zeros(g.n_vertices_padded)
    w = g.values.float()
    bad = [
        lambda: kernels.spmv_rows(off, col, w, x.double()),      # f64 x
        lambda: kernels.spmv_rows(off, col, w[:-1], x),          # short w
        lambda: kernels.spmv_rows(off.long(), col, w, x),        # int64 off
        lambda: kernels.spmv_slabs(off, col, w, fl, x, "max", "sum"),
        lambda: kernels.spmv_slabs(off, col, w, fl, x, "mul", "max"),
        lambda: kernels.spmv_slabs(off, col, None, fl, x, "mul", "sum"),
        lambda: kernels.spmv_slabs(off, col, w, fl[:-1], x, "mul", "sum"),
        lambda: tws.windowed_pipeline(g, x, message="sub", reduce="sum"),
        lambda: tfs.spmv_fused(g, torch.zeros(g.n_vertices_padded + 1)),
    ]
    for i, call in enumerate(bad):
        with pytest.raises(EssentialsError):
            call()
            pytest.fail(f"case {i} did not raise")


@pytest.mark.parametrize("variant", ["pull", "push"])
def test_unported_spmv_variants_raise(variant):
    """pull and push, once unported, now run on the operator layer (rows of
    6,200 edges included); an unknown variant still raises."""
    csr, g = hub_graph()
    x = tspmv.random_x(g, 2)
    y = tspmv.run(g, x, variant=variant).y.numpy().astype(np.float64)
    a = np.zeros((g.n_vertices, g.n_vertices))
    np.add.at(a, (np.repeat(np.arange(csr.n_rows), np.diff(csr.row_offsets)),
                  csr.col_indices), csr.values)
    xv = x.numpy()[:g.n_vertices].astype(np.float64)
    ref = a @ xv if variant == "pull" else a.T @ xv
    assert (np.abs(y - ref) <= 1e-5 * np.abs(ref) + 1e-6).all()
    with pytest.raises(EssentialsError, match="unknown"):
        tspmv.run(g, variant=variant + "x")
