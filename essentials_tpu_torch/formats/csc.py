"""CSC (compressed sparse column) host container.

Counterpart of ``essentials_tpu/formats/csc.py`` (reference parity:
format::csc_t, gunrock ``formats/csc.hxx``).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from essentials_tpu_torch import dtypes
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.coo import Coo


@dataclass
class Csc:
    n_rows: int
    n_cols: int
    col_offsets: np.ndarray = field(default_factory=lambda: np.zeros(1, dtypes.edge_dtype))
    row_indices: np.ndarray = field(default_factory=lambda: np.empty(0, dtypes.vertex_dtype))
    values: np.ndarray = field(default_factory=lambda: np.empty(0, dtypes.weight_dtype))

    @property
    def nnz(self) -> int:
        return int(self.row_indices.shape[0])

    def __post_init__(self):
        self.col_offsets = np.asarray(self.col_offsets, dtype=dtypes.edge_dtype)
        self.row_indices = np.asarray(self.row_indices, dtype=dtypes.vertex_dtype)
        self.values = np.asarray(self.values)
        throw_if(self.col_offsets.shape[0] != self.n_cols + 1,
                 "csc: col_offsets must have n_cols+1 entries")

    @classmethod
    def from_coo(cls, coo: Coo) -> "Csc":
        order = np.lexsort((coo.row_indices, coo.col_indices))
        cols = coo.col_indices[order]
        degrees = np.bincount(cols, minlength=coo.n_cols).astype(dtypes.edge_dtype)
        offsets = np.zeros(coo.n_cols + 1, dtype=dtypes.edge_dtype)
        np.cumsum(degrees, out=offsets[1:])
        return cls(coo.n_rows, coo.n_cols, offsets, coo.row_indices[order], coo.values[order])

    def to_coo(self) -> Coo:
        cols = np.repeat(
            np.arange(self.n_cols, dtype=dtypes.vertex_dtype),
            np.diff(self.col_offsets).astype(np.int64),
        )
        return Coo(self.n_rows, self.n_cols, self.row_indices, cols, self.values)
