"""Built-in tiny graph fixture.

Counterpart of ``essentials_tpu/io/sample.py`` (reference parity:
io::sample::csr(), gunrock ``io/sample.hxx:23-96``): the same 4-vertex,
4-nonzero CSR used throughout the reference unit tests:

    row_offsets   = [0, 0, 0, 2, 4]
    column_indices= [3, 1, 2, 3]
    values        = [5, 8, 3, 6]

i.e. edges 2->3 (5), 2->1 (8), 3->2 (3), 3->3 (6).
"""

from __future__ import annotations

import numpy as np

from essentials_tpu_torch import dtypes
from essentials_tpu_torch.formats.coo import Coo
from essentials_tpu_torch.formats.csr import Csr


def sample_csr() -> Csr:
    return Csr(
        4, 4,
        np.array([0, 0, 0, 2, 4], dtype=dtypes.edge_dtype),
        np.array([3, 1, 2, 3], dtype=dtypes.vertex_dtype),
        np.array([5.0, 8.0, 3.0, 6.0], dtype=dtypes.weight_dtype),
    )


def sample_coo() -> Coo:
    return sample_csr().to_coo()
