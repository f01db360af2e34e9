"""Port parity: the single-chip harness's modules of essentials_tpu_torch
against essentials_tpu on the CPU: ``dtypes.is_valid``, ``io.points``,
``write_mtx`` and the native ``.mtx`` parser, ``graph.validate``,
``graph.convert``, ``graph.analytics``, ``runtime.backend`` and the traces,
the operators ``filter_frontier``, ``uniquify``, ``for_each_vertex`` /
``for_each_edge`` and ``advance_edges``, the ``Problem`` wrapper,
``print_head``, ``RunStats`` / ``collect_stats`` and the checkpoints.

Inputs come from a seed; every integer output is held exactly and so are
the copied floats; the float32 degree statistics within float32 rounding
(benchmarks/PARITY.md holds no tolerance for them); SSSP's distances within
PARITY.md's rtol 1e-5."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from essentials_tpu import dtypes as jdtypes
from essentials_tpu.errors import EssentialsError as JError
from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.framework.problem import (BfsProblem as JBfsProblem,
                                              SsspProblem as JSsspProblem)
from essentials_tpu.frontier import (frontier_from_indices as jfrom_indices,
                                     full_frontier as jfull)
from essentials_tpu.graph import analytics as janalytics, build_graph as jbuild
from essentials_tpu.graph import convert as jconvert
from essentials_tpu.graph.validate import validate_csr as jvalidate
from essentials_tpu.io import generate as jgen, points as jpoints
from essentials_tpu.io.matrix_market import load_mtx as jload_mtx
from essentials_tpu.io.matrix_market import write_mtx as jwrite_mtx
from essentials_tpu.native import mmio_native as jmmio
from essentials_tpu.ops import (advance_edges as jadvance_edges,
                                filter_frontier as jfilter,
                                for_each_edge as jfor_edge,
                                for_each_vertex as jfor_vertex,
                                uniquify as juniquify)
from essentials_tpu.utils import checkpoint as jcheckpoint
from essentials_tpu.utils import printing as jprinting, stats as jstats

from essentials_tpu_torch import dtypes as tdtypes, kernels, runtime
from essentials_tpu_torch.algorithms import bfs as tbfs, sssp as tsssp
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.formats import Coo as TCoo, Csr as TCsr
from essentials_tpu_torch.framework import BfsProblem, SsspProblem
from essentials_tpu_torch.frontier import (frontier_from_indices,
                                           full_frontier)
from essentials_tpu_torch.graph import analytics, build_graph
from essentials_tpu_torch.graph import convert
from essentials_tpu_torch.graph.validate import validate_csr
from essentials_tpu_torch.io import load_mtx, points, write_mtx
from essentials_tpu_torch.native import mmio_native
from essentials_tpu_torch.ops import (advance_edges, filter_frontier,
                                      for_each_edge, for_each_vertex,
                                      uniquify)
from essentials_tpu_torch.utils import checkpoint, printing, stats

ROOT = os.path.join(os.path.dirname(__file__), "..")
DATASETS = sorted(glob.glob(os.path.join(ROOT, "datasets", "*.mtx")))
# datasets whose NumPy parse is also held against the JAX package's (the
# three largest take seconds each and run through the same code)
SMALL = ("chesapeake", "kron_s12", "road_64x64", "uniform_4096")
COO_FIELDS = ("n_rows", "n_cols", "row_indices", "col_indices", "values")


def same_coo(a, b):
    for f in COO_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y), f
        else:
            assert x == y, f


def canonical(coo):
    """The entries in (row, col, value) order: the parsers' orders differ."""
    o = np.lexsort((coo.values, coo.col_indices, coo.row_indices))
    return (coo.n_rows, coo.n_cols, coo.row_indices[o], coo.col_indices[o],
            coo.values[o])


def same_entries(a, b):
    for x, y in zip(canonical(a), canonical(b)):
        assert np.array_equal(x, y)


def both_csr(coo_args, **kw):
    """(port Csr, JAX Csr) of the same generated graph."""
    from essentials_tpu_torch.io import generate as tgen
    name, args = coo_args
    c = getattr(tgen, name)(*args, **kw)
    return TCsr.from_coo(c), JCsr.from_coo(getattr(jgen, name)(*args, **kw))


@pytest.fixture(scope="module")
def graphs():
    """Directed weighted rmat9 in both packages (CSR from one seed)."""
    tc, jc = both_csr(("rmat", (9, 8)), seed=4, undirected=False,
                      weighted=True)
    return (tc, build_graph(tc, directed=True, weighted=True, device="cpu"),
            jc, jbuild(jc, directed=True, weighted=True))


# ------------------------------------------------------------- dtypes --

@pytest.mark.parametrize("dtype,vals", [
    ("float32", [1.0, np.nan, -2.0, np.inf]),
    ("int32", [-1, 0, 7, -5]),
    ("int64", [3, -1, 0, 2**40]),
    ("uint8", [255, 0, 3, 254]),
    ("bool", [True, False, True, False]),
])
def test_is_valid(dtype, vals):
    x = np.array(vals, dtype=dtype)
    got = tdtypes.is_valid(torch.from_numpy(x)).numpy()
    want = np.asarray(jdtypes.is_valid(jnp.asarray(x)))
    assert got.dtype == np.bool_ and np.array_equal(got, want)


# ------------------------------------------------------------- points --

@pytest.mark.parametrize("kw", [dict(), dict(seed=3, low=-2.0, high=5.0)])
def test_random_points(kw):
    for n, dim in ((100, 2), (17, 3)):
        a = points.random_points(n, dim, **kw)
        b = jpoints.random_points(n, dim, **kw)
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_star_points():
    a = points.star_points(4, 25, 3, seed=9, spread=0.1)
    b = jpoints.star_points(4, 25, 3, seed=9, spread=0.1)
    assert a.shape == (100, 3) and np.array_equal(a, b)


# ------------------------------------------------------------- parser --

@pytest.mark.parametrize("path", DATASETS,
                         ids=[os.path.basename(p) for p in DATASETS])
def test_native_parser_on_datasets(path):
    native = load_mtx(path)
    same_coo(native, jload_mtx(path))           # JAX's native parser
    numpy = load_mtx(path, use_native=False)
    same_entries(native, numpy)
    if os.path.basename(path)[:-4] in SMALL:
        same_coo(numpy, jload_mtx(path, use_native=False))


CRAFTED = {
    "pattern": "%%MatrixMarket matrix coordinate pattern general\n"
               "% a comment\n4 4 3\n1 2\n3 4\n4 1\n",
    "integer": "%%MatrixMarket matrix coordinate integer general\n"
               "3 3 3\n1 2 5\n2 3 -7\n3 1 12\n",
    "symmetric": "%%MatrixMarket matrix coordinate real symmetric\n"
                 "3 3 3\n1 1 2.5\n2 1 -1.25e-3\n3 2 4E+2\n",
    "skew": "%%MatrixMarket matrix coordinate real skew-symmetric\n"
            "3 3 2\n2 1 1.5\n3 1 -0.5\n",
    "hermitian": "%%MatrixMarket matrix coordinate complex hermitian\n"
                 "2 2 2\n1 1 3.0 0.0\n2 1 1.0 -2.0\n",
    "comments": "%%MatrixMarket matrix coordinate real general\n%\n"
                "%%more\n2 2 2\n1 1 1.0\n% between entries\n2 2 2.0\n",
    "empty": "%%MatrixMarket matrix coordinate real general\n5 5 0\n",
}


def random_real_text(n: int = 2000, seed: int = 5) -> str:
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal(n) * 10.0 ** rng.integers(-20, 20, n)
    rows = rng.integers(1, 300, n)
    cols = rng.integers(1, 300, n)
    body = "".join(f"{r} {c} {v:.17g}\n" for r, c, v in zip(rows, cols, vals))
    return ("%%MatrixMarket matrix coordinate real general\n"
            f"300 300 {n}\n" + body)


@pytest.mark.parametrize("name", [*CRAFTED, "random_reals"])
def test_native_parser_crafted(tmp_path, name):
    text = random_real_text() if name == "random_reals" else CRAFTED[name]
    path = tmp_path / f"{name}.mtx"
    path.write_text(text)
    for expand in (True, False):
        native = load_mtx(str(path), expand_symmetric=expand)
        same_coo(native, jload_mtx(str(path), expand_symmetric=expand))
        numpy = load_mtx(str(path), expand_symmetric=expand,
                         use_native=False)
        same_coo(numpy, jload_mtx(str(path), expand_symmetric=expand,
                                  use_native=False))
        same_entries(native, numpy)


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix array real general\n2 2\n1\n0\n3\n4\n",
    "%%MatrixMarket matrix array real symmetric\n2 2\n1\n2\n3\n",
])
def test_array_format_goes_to_numpy(tmp_path, text):
    path = tmp_path / "a.mtx"
    path.write_text(text)
    assert mmio_native.load_mtx(str(path)) is None
    same_coo(load_mtx(str(path)), jload_mtx(str(path)))


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n2 x 2\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 2\n1 1 1.0\n",
    "%%MatrixMarket matrix coordinate real general\n2 2\n",
    "%%MatrixMarket matrix coordinate real general\n2 2 1\n1 1 .\n",
    "%%NotMatrixMarket matrix coordinate real general\n1 1 0\n",
])
def test_native_parser_errors_as_jax(tmp_path, text):
    path = tmp_path / "bad.mtx"
    path.write_text(text)
    with pytest.raises(EssentialsError) as ours:
        load_mtx(str(path))
    with pytest.raises(JError) as theirs:
        jmmio.load_mtx(str(path))
    assert str(ours.value) == str(theirs.value)


def test_write_mtx_round_trip(tmp_path):
    from essentials_tpu_torch.io import generate as tgen
    coo = tgen.rmat(7, 4, seed=2, weighted=True)
    jcoo = jgen.rmat(7, 4, seed=2, weighted=True)
    for field in ("real", "pattern"):
        ours, theirs = tmp_path / f"t_{field}.mtx", tmp_path / f"j_{field}.mtx"
        write_mtx(str(ours), coo, field=field)
        jwrite_mtx(str(theirs), jcoo, field=field)
        assert ours.read_bytes() == theirs.read_bytes()
        back = load_mtx(str(ours))
        assert np.array_equal(back.row_indices, coo.row_indices)
        assert np.array_equal(back.col_indices, coo.col_indices)
        want = coo.values if field == "real" else np.ones_like(coo.values)
        assert np.array_equal(back.values, want)


def test_native_build_raises_without_compiler(monkeypatch, tmp_path):
    monkeypatch.setattr(mmio_native, "_lib", None)
    monkeypatch.setattr(mmio_native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(mmio_native.shutil, "which", lambda name: None)
    with pytest.raises(EssentialsError, match="c\\+\\+"):
        load_mtx(os.path.join(ROOT, "datasets", "chesapeake.mtx"))
    assert not list(tmp_path.iterdir())


def test_native_build_raises_on_compile_error(monkeypatch, tmp_path):
    bad = tmp_path / "mmio.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(mmio_native, "_lib", None)
    monkeypatch.setattr(mmio_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(mmio_native, "SOURCE", bad)
    with pytest.raises(EssentialsError, match="failed on mmio.cpp"):
        mmio_native.build()
    assert not list((tmp_path / "build").iterdir())


def test_native_library_in_build_dir():
    path = mmio_native.build()
    assert path.parent == kernels.BUILD_DIR
    assert path.name.startswith("libetpu_mmio_") and path.exists()


# ----------------------------------------------------------- validate --

VALIDATE_CASES = {
    "good": (lambda: TCsr.from_coo(TCoo(4, 4, np.array([0, 0, 1, 2]),
                                        np.array([1, 2, 2, 3]),
                                        np.array([5., 8., 3., 6.], np.float32))),
             {}),
    "bad_offsets": (lambda: TCsr(2, 2, np.array([0, 3, 2]),
                                 np.array([0, 1], np.int32),
                                 np.ones(2, np.float32)), {}),
    "bad_column": (lambda: TCsr(2, 2, np.array([0, 1, 2]),
                                np.array([0, 5], np.int32),
                                np.ones(2, np.float32)), {}),
    "nonfinite": (lambda: TCsr(2, 2, np.array([0, 1, 2]),
                               np.array([0, 1], np.int32),
                               np.array([1.0, np.nan], np.float32)), {}),
    "first_offset": (lambda: TCsr(2, 2, np.array([1, 1, 2]),
                                  np.array([0, 1], np.int32),
                                  np.ones(2, np.float32)), {}),
    "asymmetric": (lambda: TCsr(3, 3, np.array([0, 1, 2, 2]),
                                np.array([1, 2], np.int32),
                                np.ones(2, np.float32)),
                   dict(require_symmetric=True)),
    "symmetric": (lambda: TCsr(3, 3, np.array([0, 1, 3, 4]),
                               np.array([1, 0, 2, 1], np.int32),
                               np.ones(4, np.float32)),
                  dict(require_symmetric=True, require_sorted_columns=True)),
    "not_square": (lambda: TCsr(2, 3, np.array([0, 1, 1]),
                                np.array([2], np.int32),
                                np.ones(1, np.float32)),
                   dict(require_symmetric=True)),
    "unsorted": (lambda: TCsr(3, 3, np.array([0, 2, 3, 3]),
                              np.array([2, 1, 0], np.int32),
                              np.ones(3, np.float32)),
                 dict(require_sorted_columns=True)),
    "unsorted_allowed": (lambda: TCsr(3, 3, np.array([0, 2, 3, 3]),
                                      np.array([2, 1, 0], np.int32),
                                      np.ones(3, np.float32)), {}),
}


@pytest.mark.parametrize("name", VALIDATE_CASES)
def test_validate_csr_as_jax(name):
    make, kw = VALIDATE_CASES[name]
    csr = make()
    jcsr = JCsr(csr.n_rows, csr.n_cols, csr.row_offsets, csr.col_indices,
                csr.values)
    try:
        jvalidate(jcsr, **kw)
        want = None
    except JError as e:
        want = str(e)
    if want is None:
        validate_csr(csr, **kw)
    else:
        with pytest.raises(EssentialsError) as e:
            validate_csr(csr, **kw)
        assert str(e.value) == want
    assert (want is None) == (name in ("good", "symmetric",
                                       "unsorted_allowed"))


@pytest.mark.parametrize("seed,undirected", [(1, True), (2, False)])
def test_validate_symmetric_rmat(seed, undirected):
    tc, jc = both_csr(("rmat", (9, 8)), seed=seed, undirected=undirected,
                      weighted=False)
    try:
        jvalidate(jc, require_symmetric=True, require_sorted_columns=True)
        ok = True
    except JError:
        ok = False
    assert ok == undirected
    if ok:
        validate_csr(tc, require_symmetric=True, require_sorted_columns=True)
    else:
        with pytest.raises(EssentialsError, match="not symmetric"):
            validate_csr(tc, require_symmetric=True)


# ------------------------------------------------------------ convert --

@pytest.mark.parametrize("offsets,n", [
    ([0, 0, 2, 4], 4),              # an empty leading segment
    ([0, 2, 2, 2, 5, 5], 5),        # empty middle and trailing segments
    ([0, 3, 3, 3, 3], 3),           # repeated offsets at the end
    ([0, 1, 1], 4),                 # offsets[-1] < n: the tail is S-1's
    ([0, 2, 9], 5),                 # offsets[-1] > n
    ([2, 3, 5], 6),                 # offsets[0] > 0
    ([0, 0, 0], 3),
    ([0, 5, 5, 5], 5),
    ([0], 3),                       # no segment
    ([0, 0], 0),                    # no element
    ([0, 7], 7),
])
def test_offsets_to_indices(offsets, n):
    off = np.array(offsets, np.int32)
    got = convert.offsets_to_indices(torch.from_numpy(off), n)
    want = np.asarray(jconvert.offsets_to_indices(jnp.asarray(off), n))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_offsets_to_indices_graph(graphs):
    tc, g, jc, gj = graphs
    got = convert.offsets_to_indices(g.row_offsets, g.n_edges_padded)
    want = jconvert.offsets_to_indices(gj.row_offsets, gj.n_edges_padded)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert np.array_equal(got.numpy(), g.src_indices.numpy())


@pytest.mark.parametrize("idx,s", [([0, 0, 1, 3, 3, 3], 5), ([], 3),
                                   ([2, 2, 2], 3), ([0, 1, 2], 2)])
def test_indices_to_offsets(idx, s):
    x = np.array(idx, np.int32)
    got = convert.indices_to_offsets(torch.from_numpy(x), s)
    want = np.asarray(jconvert.indices_to_offsets(jnp.asarray(x), s))
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


# ---------------------------------------------------------- analytics --

def sample_graphs():
    from essentials_tpu.io.sample import sample_csr as jsample
    from essentials_tpu_torch.io.sample import sample_csr
    return (build_graph(sample_csr(), device="cpu"), jbuild(jsample()))


def test_analytics_sample():
    g, gj = sample_graphs()
    assert analytics.average_degree(g) == 1.0
    assert abs(analytics.degree_standard_deviation(g) - 1.0) < 1e-6
    hist = analytics.degree_histogram(g)
    assert hist.dtype == torch.int32 and hist.shape == (32,)
    assert hist[0] == 2 and hist[2] == 2
    assert np.array_equal(hist.numpy(),
                          np.asarray(janalytics.degree_histogram(gj)))


@pytest.mark.parametrize("n_bins", [32, 4])
def test_analytics_rmat(graphs, n_bins):
    tc, g, jc, gj = graphs
    assert analytics.average_degree(g) == janalytics.average_degree(gj)
    a = analytics.degree_standard_deviation(g)
    b = janalytics.degree_standard_deviation(gj)
    assert abs(a - b) <= 4 * np.finfo(np.float32).eps * b
    assert np.array_equal(analytics.degree_histogram(g, n_bins).numpy(),
                          np.asarray(janalytics.degree_histogram(gj, n_bins)))


# ------------------------------------------------------------ runtime --

def test_backend():
    assert runtime.backend("cpu") == "cpu"
    assert runtime.backend(torch.device("cuda", 0)) == "cuda"
    assert runtime.backend() == ("cuda" if torch.cuda.is_available()
                                 else "cpu")


def test_hbm_rate_table():
    assert runtime.HBM_GBPS["NVIDIA H100 80GB HBM3"] == 3350.0
    assert runtime.HBM_GBPS.get("an unknown card", 0.0) == 0.0
    fields = [f.name for f in dataclasses.fields(runtime.DeviceProperties)]
    assert fields[-1] == "hbm_gbps"


def test_trace_writes_events(tmp_path, graphs):
    tc, g, jc, gj = graphs
    with runtime.trace(str(tmp_path / "tr")) as t:
        tbfs.run(g, 0, variant="adaptive", warmup=False)
    assert os.path.dirname(t.path) == str(tmp_path / "tr")
    with open(t.path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("ph") == "X" for e in events)
    runtime.start_trace(str(tmp_path / "tr2"))
    with pytest.raises(EssentialsError):
        runtime.start_trace(str(tmp_path / "tr3"))
    path = runtime.stop_trace()
    assert os.path.exists(path)
    with pytest.raises(EssentialsError):
        runtime.stop_trace()


# ---------------------------------------------------------- operators --

def jnp_of(x: torch.Tensor):
    return jnp.asarray(x.numpy())


def test_filter_frontier(graphs):
    tc, g, jc, gj = graphs
    for kind in ("vertex", "edge"):
        f, fj = full_frontier(g, kind), jfull(gj, kind)
        got = filter_frontier(g, f, lambda v: v % 3 != 1, kind)
        want = jfilter(gj, fj, lambda v: v % 3 != 1, kind)
        assert got.dtype == torch.bool
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_uniquify(graphs):
    tc, g, jc, gj = graphs
    f = full_frontier(g)
    assert uniquify(f) is f
    vp = g.n_vertices_padded
    rng = np.random.default_rng(3)
    idx = rng.integers(-3, vp + 4, 400).astype(np.int32)
    idx[:5] = [3, 1, 3, -1, g.pad_vertex]
    got = uniquify(torch.from_numpy(idx), capacity=vp)
    want = juniquify(jnp.asarray(idx), capacity=vp)
    assert got.shape == (vp,) and got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(EssentialsError):
        uniquify(torch.from_numpy(idx))


def test_for_each(graphs):
    tc, g, jc, gj = graphs
    rng = np.random.default_rng(5)
    fv = rng.random(g.n_vertices_padded) < 0.4
    fe = rng.random(g.n_edges_padded) < 0.4
    for frontier, fj, default in ((None, None, None),
                                  (torch.from_numpy(fv), jnp.asarray(fv), -7)):
        got = for_each_vertex(g, lambda v: v * 10 + 1, frontier=frontier,
                              default=default)
        want = jfor_vertex(gj, lambda v: v * 10 + 1, frontier=fj,
                           default=default)
        assert np.array_equal(got.numpy(), np.asarray(want))
    for frontier, fj in ((None, None), (torch.from_numpy(fe), jnp.asarray(fe))):
        got = for_each_edge(g, lambda s, d, e, w: w * 2 + s - d,
                            frontier=frontier)
        want = jfor_edge(gj, lambda s, d, e, w: w * 2 + s - d, frontier=fj)
        assert np.array_equal(got.numpy(), np.asarray(want))


def test_advance_edges_sample():
    g, gj = sample_graphs()
    out = advance_edges(g, lambda e: e.weight > 4, full_frontier(g))
    # CSR edge order [5, 8, 3, 6] -> fires at 0, 1, 3 (tests/test_ops.py)
    assert out.dtype == torch.bool
    assert out[:4].tolist() == [True, True, False, True]
    assert not out[4:].any()


@pytest.mark.parametrize("kind", ["vertices", "graph", "edges"])
def test_advance_edges(graphs, kind):
    from essentials_tpu.ops.configs import AdvanceIO as JIO
    from essentials_tpu_torch.ops.configs import AdvanceIO as TIO
    tc, g, jc, gj = graphs
    rng = np.random.default_rng(11)
    sv = rng.random(g.n_vertices_padded).astype(np.float32)
    dv = rng.random(g.n_vertices_padded).astype(np.float32)

    def msg(e):
        return (e.src_vals[0] + e.weight * 0.01 > e.dst_vals[0]) & \
            (e.eid % 2 == 0)

    if kind == "vertices":
        ids = rng.choice(g.n_vertices, 60, replace=False)
        f = frontier_from_indices(g, torch.from_numpy(ids))
        fj = jfrom_indices(gj, jnp.asarray(ids))
    elif kind == "edges":
        fe = rng.random(g.n_edges_padded) < 0.5
        f, fj = torch.from_numpy(fe), jnp.asarray(fe)
    else:
        f = fj = None
    io = {"vertices": "VERTICES", "graph": "GRAPH", "edges": "EDGES"}[kind]
    got = advance_edges(g, msg, f, src_values=(torch.from_numpy(sv),),
                        dst_values=(torch.from_numpy(dv),),
                        input_kind=getattr(TIO, io))
    want = jadvance_edges(gj, msg, fj, src_values=(jnp.asarray(sv),),
                          dst_values=(jnp.asarray(dv),),
                          input_kind=getattr(JIO, io))
    assert got.shape == (g.n_edges_padded,) and got.dtype == torch.bool
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert got.any()


# ------------------------------------------------------------ Problem --

def test_problem_api_bfs_sssp():
    tc, jc = both_csr(("rmat", (8, 8)), seed=2, undirected=True,
                      weighted=True)
    g = build_graph(tc, directed=False, weighted=True, device="cpu")
    gj = jbuild(jc, directed=False, weighted=True)
    v = g.n_vertices
    res = BfsProblem(g, source=3).enact(warmup=False)
    resj = JBfsProblem(gj, source=3).enact(warmup=False)
    d = res.state.distances[:v].numpy()
    assert np.array_equal(d, np.asarray(resj.state.distances[:v]))
    assert np.array_equal(d, tbfs.cpu_reference(tc, 3))
    assert res.iterations == resj.iterations
    res2 = SsspProblem(g, source=3).enact(warmup=False)
    res2j = JSsspProblem(gj, source=3).enact(warmup=False)
    got = res2.state.distances[:v].numpy()
    want = np.asarray(res2j.state.distances[:v])
    fin = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), fin)
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=0)
    ref = tsssp.cpu_reference(tc, 3)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=1e-5, atol=1e-5)
    p = BfsProblem(g, source=3)
    assert torch.equal(p.reset().distances, p.init().distances)


# ---------------------------------------------------- print and stats --

def test_print_head(capsys, graphs):
    tc, g, jc, gj = graphs
    for k in (4, 10_000):
        printing.print_head(g.col_indices, k, name="cols")
        ours = capsys.readouterr().out
        jprinting.print_head(gj.col_indices, k, name="cols")
        assert ours == capsys.readouterr().out


def test_run_stats_fields():
    ours = [(f.name, f.type) for f in dataclasses.fields(stats.RunStats)]
    theirs = [(f.name, f.type) for f in dataclasses.fields(jstats.RunStats)]
    assert ours == theirs


@pytest.mark.parametrize("weighted,edges_visited", [(True, None),
                                                    (False, 12345)])
def test_collect_stats(weighted, edges_visited):
    tc, jc = both_csr(("rmat", (8, 4)), seed=1, undirected=True,
                      weighted=True)
    g = build_graph(tc, weighted=weighted, device="cpu")
    gj = jbuild(jc, weighted=weighted)
    kw = dict(edges_visited=edges_visited, vertices_visited=7,
              cycles_ms=[1.23456, 2.5])
    a = dataclasses.asdict(stats.collect_stats("bfs", "rmat8", g, 1.75, 6,
                                               **kw))
    b = dataclasses.asdict(jstats.collect_stats("bfs", "rmat8", gj, 1.75, 6,
                                                **kw))
    assert a.pop("backend") == "cpu" and a.pop("hbm_gbps") == 0.0
    assert a.pop("pct_hbm_roofline") == 0.0
    for k in ("backend", "hbm_gbps", "pct_hbm_roofline"):
        b.pop(k)
    assert a == b
    assert json.loads(stats.collect_stats("x", "y", g, 0.0, 0).to_json())[
        "mteps"] == 0.0


# -------------------------------------------------------- checkpoints --

def test_checkpoint_round_trip(tmp_path, graphs):
    tc, g, jc, gj = graphs
    st = tsssp.init(g, 2)
    p = tmp_path / "ckpt.npz"
    checkpoint.save_state(str(p), st, step=7, meta={"algo": "sssp"})
    loaded, step = checkpoint.load_state(str(p), st)
    assert step == 7 and type(loaded) is type(st)
    for a, b in zip(loaded, st):
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.device == b.device
            assert torch.equal(a, b)
        else:
            assert a == b and type(a) is type(b)
    with np.load(str(p)) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
    assert meta["version"] == 1 and meta["user"] == {"algo": "sssp"}
    assert meta["n_leaves"] == len(z.files) - 1


def test_checkpoint_resume_equivalence(tmp_path):
    """Run 2 levels, checkpoint, resume: the same result as uninterrupted."""
    from essentials_tpu_torch.io import load_graph_file
    csr = load_graph_file(os.path.join(ROOT, "datasets", "chesapeake.mtx"),
                          cache=False)
    g = build_graph(csr, directed=False, weighted=False, device="cpu")
    st = tbfs.init(g, 0)
    for it in range(2):
        st = tbfs.step(g, st, it)
    p = tmp_path / "bfs.npz"
    checkpoint.save_state(str(p), st, step=2)
    resumed, step = checkpoint.load_state(str(p), tbfs.init(g, 0))
    a, b = tbfs.step(g, resumed, step), tbfs.step(g, st, 2)
    assert torch.equal(a.distances, b.distances)
    assert a.tiers == b.tiers and a.live == b.live


def test_checkpoint_structure_mismatch(tmp_path, graphs):
    tc, g, jc, gj = graphs
    st = tbfs.init(g, 0)
    p = tmp_path / "x.npz"
    checkpoint.save_state(str(p), st)
    with pytest.raises(ValueError):
        checkpoint.load_state(str(p), (st.distances,))


def test_checkpoint_across_packages(tmp_path, graphs):
    """A JAX-written tuple of arrays loads into the port and back."""
    tc, g, jc, gj = graphs
    rng = np.random.default_rng(2)
    arrays = (rng.integers(0, 9, 50).astype(np.int32),
              rng.random(30).astype(np.float32), rng.random(8) < 0.5)
    p = tmp_path / "jax.npz"
    jcheckpoint.save_state(str(p), tuple(jnp.asarray(a) for a in arrays),
                           step=3)
    like = (torch.zeros(1, dtype=torch.int32), torch.zeros(1),
            {"m": torch.zeros(1, dtype=torch.bool)})
    loaded, step = checkpoint.load_state(str(p), like)
    assert step == 3 and isinstance(loaded[2], dict)
    for a, b in zip((loaded[0], loaded[1], loaded[2]["m"]), arrays):
        assert np.array_equal(a.numpy(), b)
    q = tmp_path / "torch.npz"
    checkpoint.save_state(str(q), loaded, step=4)
    back, step = jcheckpoint.load_state(str(q), tuple(jnp.asarray(a)
                                                     for a in arrays))
    assert step == 4
    for a, b in zip(back, arrays):
        assert np.array_equal(np.asarray(a), b)


# ------------------------------------------------------------ compare --

def test_compare_nan_against_nan():
    """NaN against NaN agrees in the port's compare (geo's unlocated
    vertices); the JAX package's counts it as a mismatch."""
    from essentials_tpu.utils import compare as jcompare
    from essentials_tpu_torch.utils import compare
    a = np.array([np.nan, 1.0, np.inf, -np.inf, np.nan], np.float32)
    b = np.array([np.nan, 1.0, np.inf, np.inf, 0.0], np.float32)
    assert compare(torch.from_numpy(a), b) == 2
    assert jcompare(a, b) == 3
