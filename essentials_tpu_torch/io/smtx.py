"""SMTX sparse-matrix reader (DNN-pruning matrix format).

Counterpart of ``essentials_tpu/io/smtx.py`` (reference parity:
io::smtx_t::load, gunrock ``io/smtx.hxx:41-80``): header line
"nrows, ncols, nnz", then a row_offsets line and a column_indices line;
values are absent in the file and filled with uniform randoms from ``seed``.
"""

from __future__ import annotations

import numpy as np

from essentials_tpu_torch import dtypes
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.csr import Csr


def load_smtx(path, *, seed: int = 0, random_values: bool = True) -> Csr:
    with open(path) as f:
        header = f.readline()
        while header.lstrip().startswith(("%", "#")):   # comment banner
            header = f.readline()
        parts = header.replace(",", " ").split()
        throw_if(len(parts) != 3, f"smtx: bad header {header!r}")
        n_rows, n_cols, nnz = (int(x) for x in parts)
        offsets = np.array(f.readline().split(), dtype=dtypes.edge_dtype)
        indices = np.array(f.readline().split(), dtype=dtypes.vertex_dtype)
    throw_if(offsets.size != n_rows + 1, "smtx: row_offsets length mismatch")
    throw_if(indices.size != nnz, "smtx: column_indices length mismatch")
    if random_values:
        rng = np.random.default_rng(seed)
        values = rng.random(nnz, dtype=np.float32)
    else:
        values = np.ones(nnz, dtype=dtypes.weight_dtype)
    return Csr(n_rows, n_cols, offsets, indices, values)
