"""COO (coordinate) host container.

Counterpart of ``essentials_tpu/formats/coo.py`` (reference parity:
format::coo_t, gunrock ``formats/coo.hxx``). A NumPy copy, so that the port
builds the same graphs without importing the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from essentials_tpu_torch import dtypes
from essentials_tpu_torch.errors import throw_if


@dataclass
class Coo:
    """Coordinate-format sparse matrix / edge list on the host."""

    n_rows: int
    n_cols: int
    row_indices: np.ndarray = field(default_factory=lambda: np.empty(0, dtypes.vertex_dtype))
    col_indices: np.ndarray = field(default_factory=lambda: np.empty(0, dtypes.vertex_dtype))
    values: np.ndarray = field(default_factory=lambda: np.empty(0, dtypes.weight_dtype))

    @property
    def nnz(self) -> int:
        return int(self.row_indices.shape[0])

    def __post_init__(self):
        self.row_indices = np.asarray(self.row_indices, dtype=dtypes.vertex_dtype)
        self.col_indices = np.asarray(self.col_indices, dtype=dtypes.vertex_dtype)
        self.values = np.asarray(self.values)
        throw_if(
            self.row_indices.shape != self.col_indices.shape
            or self.values.shape != self.row_indices.shape,
            "coo: row/col/values length mismatch",
        )

    def sorted_by_row(self) -> "Coo":
        """Stable sort edges by (row, col)."""
        order = np.lexsort((self.col_indices, self.row_indices))
        return Coo(self.n_rows, self.n_cols,
                   self.row_indices[order], self.col_indices[order], self.values[order])

    def sorted_by_col(self) -> "Coo":
        """Stable sort edges by (col, row)."""
        order = np.lexsort((self.row_indices, self.col_indices))
        return Coo(self.n_rows, self.n_cols,
                   self.row_indices[order], self.col_indices[order], self.values[order])

    def transposed(self) -> "Coo":
        return Coo(self.n_cols, self.n_rows, self.col_indices, self.row_indices, self.values)

    def deduplicated(self) -> "Coo":
        """Drop duplicate (row, col) pairs keeping the first occurrence."""
        keys = self.row_indices.astype(np.int64) * self.n_cols + self.col_indices
        _, first = np.unique(keys, return_index=True)
        first.sort()
        return Coo(self.n_rows, self.n_cols,
                   self.row_indices[first], self.col_indices[first], self.values[first])

    def without_self_loops(self) -> "Coo":
        keep = self.row_indices != self.col_indices
        return Coo(self.n_rows, self.n_cols,
                   self.row_indices[keep], self.col_indices[keep], self.values[keep])
