"""Graph input validation (fail-fast, host-side).

Counterpart of ``essentials_tpu/graph/validate.py``: the same checks with
the same messages. The reference throws mid-run from device flag read-backs
on malformed input (mst.hxx:242-247); here malformed structure is rejected
before a graph is built. The symmetry check compares the sorted (row, col)
keys with the sorted (col, row) keys where the JAX package builds a Python
set of pairs: the same answer, in a sort's time.
"""

from __future__ import annotations

import numpy as np

from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.csr import Csr


def validate_csr(csr: Csr, *, require_sorted_columns: bool = False,
                 require_symmetric: bool = False) -> None:
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    throw_if(off[0] != 0, "csr: row_offsets[0] must be 0")
    throw_if(off[-1] != csr.nnz,
             f"csr: row_offsets[-1]={off[-1]} != nnz={csr.nnz}")
    throw_if(bool(np.any(np.diff(off) < 0)),
             "csr: row_offsets must be non-decreasing")
    if csr.nnz:
        throw_if(bool(cols.min() < 0) or bool(cols.max() >= csr.n_cols),
                 "csr: column index out of range")
    throw_if(not np.isfinite(np.asarray(csr.values, np.float64)).all(),
             "csr: non-finite edge weight")
    src = np.repeat(np.arange(csr.n_rows, dtype=np.int64), np.diff(off))
    if require_sorted_columns:
        key = src * csr.n_cols + cols
        throw_if(bool(np.any(np.diff(key) < 0)),
                 "csr: columns not sorted within rows")
    if require_symmetric:
        throw_if(csr.n_rows != csr.n_cols, "csr: not square")
        n = csr.n_rows
        throw_if(not np.array_equal(np.unique(src * n + cols),
                                    np.unique(cols * n + src)),
                 "csr: structure not symmetric")
