"""Port parity: host inputs (formats, io, dtypes, runtime) of
essentials_tpu_torch against essentials_tpu. Every output is an integer or
a value copied bit for bit, so the tolerance is exact equality."""

import os

import numpy as np
import pytest
import torch

from essentials_tpu import dtypes as jdtypes
from essentials_tpu.formats import Csc as JCsc, Csr as JCsr
from essentials_tpu.io import generate as jgen, sample as jsample
from essentials_tpu.io import load_graph_file as jload_graph_file
from essentials_tpu.io.matrix_market import load_mtx as jload_mtx
from essentials_tpu.io.matrix_market import parse_mtx_bytes as jparse
from essentials_tpu.io.smtx import load_smtx as jload_smtx

from essentials_tpu_torch import dtypes as tdtypes, runtime
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.formats import Csc as TCsc, Csr as TCsr
from essentials_tpu_torch.io import generate as tgen, sample as tsample
from essentials_tpu_torch.io import load_graph_file as tload_graph_file
from essentials_tpu_torch.io.matrix_market import load_mtx as tload_mtx
from essentials_tpu_torch.io.matrix_market import parse_mtx_bytes as tparse
from essentials_tpu_torch.io.smtx import load_smtx as tload_smtx

CHESAPEAKE = os.path.join(os.path.dirname(__file__), "..", "datasets",
                          "chesapeake.mtx")


def assert_same(a, b, fields):
    for f in fields:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            assert np.array_equal(x, y), f
        else:
            assert x == y, f


COO_FIELDS = ("n_rows", "n_cols", "row_indices", "col_indices", "values")
CSR_FIELDS = ("n_rows", "n_cols", "row_offsets", "col_indices", "values")


@pytest.mark.parametrize("name,args,kw", [
    ("rmat", (10, 8), dict(seed=3, undirected=True, weighted=False)),
    ("rmat", (9, 4), dict(seed=5, undirected=False, weighted=True)),
    ("uniform_random", (200, 5), dict(seed=7, undirected=True,
                                      weighted=True)),
    ("uniform_random", (100, 3), dict(seed=2, undirected=False,
                                      weighted=False)),
    ("grid_2d", (24,), dict(weighted=False)),
    ("grid_2d", (12,), dict(weighted=True, seed=4)),
    ("chain", (300,), {}),
])
def test_generators_byte_identical(name, args, kw):
    a = getattr(tgen, name)(*args, **kw)
    b = getattr(jgen, name)(*args, **kw)
    assert_same(a, b, COO_FIELDS)


def test_load_mtx_chesapeake():
    # each package's native parser keeps a mirrored entry beside its
    # original, and each NumPy parser appends the mirrors: compare like with
    # like; Csr.from_coo sorts the orders away
    assert_same(tload_mtx(CHESAPEAKE), jload_mtx(CHESAPEAKE), COO_FIELDS)
    assert_same(tload_mtx(CHESAPEAKE, use_native=False),
                jload_mtx(CHESAPEAKE, use_native=False), COO_FIELDS)
    assert_same(tload_graph_file(CHESAPEAKE, cache=False),
                jload_graph_file(CHESAPEAKE, cache=False), CSR_FIELDS)


@pytest.mark.parametrize("text", [
    "%%MatrixMarket matrix coordinate real general\n% c\n3 3 3\n"
    "1 2 1.5\n2 3 -2\n3 1 4\n",
    "%%MatrixMarket matrix coordinate pattern symmetric\n3 3 2\n2 1\n3 3\n",
    "%%MatrixMarket matrix coordinate integer skew-symmetric\n3 3 2\n"
    "2 1 5\n3 2 7\n",
    "%%MatrixMarket matrix array real general\n2 2\n1\n0\n3\n4\n",
    "%%MatrixMarket matrix array real symmetric\n2 2\n1\n2\n3\n",
])
def test_parse_mtx_bytes(text):
    data = text.encode()
    assert_same(tparse(data), jparse(data), COO_FIELDS)


def test_parse_mtx_rejects_bad_banner():
    with pytest.raises(EssentialsError):
        tparse(b"%%NotMatrixMarket matrix coordinate real general\n1 1 0\n")


def test_sample_csr():
    assert_same(tsample.sample_csr(), jsample.sample_csr(), CSR_FIELDS)
    assert_same(tsample.sample_coo(), jsample.sample_coo(), COO_FIELDS)


def test_csr_csc_from_coo():
    kw = dict(seed=11, undirected=False, weighted=True)
    tc, jc = tgen.uniform_random(150, 4, **kw), jgen.uniform_random(150, 4, **kw)
    assert_same(TCsr.from_coo(tc), JCsr.from_coo(jc), CSR_FIELDS)
    assert_same(TCsr.from_coo(tc, sort_columns=False),
                JCsr.from_coo(jc, sort_columns=False), CSR_FIELDS)
    assert_same(TCsc.from_coo(tc), JCsc.from_coo(jc),
                ("n_rows", "n_cols", "col_offsets", "row_indices", "values"))
    assert_same(TCsr.from_coo(tc).to_coo(), JCsr.from_coo(jc).to_coo(),
                COO_FIELDS)


def test_csr_binary_cache_round_trip(tmp_path):
    csr = TCsr.from_coo(tgen.grid_2d(6))
    path = str(tmp_path / "g.csr.npz")
    csr.write_binary(path)
    assert_same(TCsr.read_binary(path), JCsr.read_binary(path), CSR_FIELDS)


def test_load_smtx(tmp_path):
    path = tmp_path / "m.smtx"
    path.write_text("% pruned\n3, 4, 5\n0 2 3 5\n0 3 1 0 2\n")
    assert_same(tload_smtx(str(path)), jload_smtx(str(path)), CSR_FIELDS)
    assert_same(tload_graph_file(str(path)), jload_graph_file(str(path)),
                CSR_FIELDS)


def test_dtypes_sentinels():
    for dt in (np.int32, np.int64, np.uint32, np.float32):
        a, b = tdtypes.invalid(dt), jdtypes.invalid(dt)
        assert (np.isnan(a) and np.isnan(b)) or a == b
        assert tdtypes.infinity(dt) == jdtypes.infinity(dt)
    assert (tdtypes.vertex_dtype, tdtypes.edge_dtype, tdtypes.weight_dtype) \
        == (jdtypes.vertex_dtype, jdtypes.edge_dtype, jdtypes.weight_dtype)


def test_require_cuda_raises_on_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(EssentialsError):
        runtime.require_cuda()
    with pytest.raises(EssentialsError):
        runtime.device_properties()


@pytest.mark.parametrize("a,b", [
    (np.array([1, 2, 3], np.int32), np.array([1, 5, 3, 9], np.int32)),
    (np.array([1.0, np.inf, np.nan], np.float32),
     np.array([1.0 + 1e-7, np.inf, 2.0])),
])
def test_compare_counts_mismatches(a, b):
    from essentials_tpu.utils import compare as jcompare
    from essentials_tpu_torch.utils import compare as tcompare
    assert tcompare(torch.from_numpy(a), b) == jcompare(a, b) == 1
