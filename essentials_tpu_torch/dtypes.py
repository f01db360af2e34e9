"""Numeric limits, sentinels and the graph's index / value dtypes.

Counterpart of ``essentials_tpu/dtypes.py``. The reference centers on an
"invalid" sentinel per type (gunrock ``util/type_limits.hxx:16-50``): -1 for
signed ints, max for unsigned, NaN for floats. The host containers are NumPy,
so the dtypes here are NumPy dtypes; ``build_graph`` turns the arrays into
tensors of the matching torch dtype.
"""

from __future__ import annotations

import numpy as np
import torch


def invalid(dtype) -> np.generic:
    """The invalid sentinel for ``dtype``.

    Reference parity: gunrock::numeric_limits<T>::invalid().
    """
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.nan)
    if np.issubdtype(dt, np.unsignedinteger):
        return np.iinfo(dt).max
    if np.issubdtype(dt, np.signedinteger):
        return dt.type(-1)
    raise TypeError(f"no invalid sentinel for dtype {dt}")


def is_valid(x: torch.Tensor) -> torch.Tensor:
    """Elementwise validity test against the sentinel convention: not NaN
    for floats, not the maximum for unsigned integers, >= 0 for signed ones
    (reference parity: util::limits::is_valid, type_limits.hxx:57-71)."""
    if x.is_floating_point():
        return ~torch.isnan(x)
    if x.dtype == torch.bool:
        return x >= 0
    if not x.dtype.is_signed:
        return x != torch.iinfo(x.dtype).max
    return x >= 0


def infinity(dtype) -> np.generic:
    """Largest finite/"unreached" value for distances of ``dtype``."""
    dt = np.dtype(dtype)
    if np.issubdtype(dt, np.floating):
        return dt.type(np.inf)
    return np.iinfo(dt).max


# Default index / value dtypes for graphs: 32-bit indices halve the bytes a
# kernel moves per edge against int64 (PyTorch's default index dtype).
vertex_dtype = np.int32
edge_dtype = np.int32
weight_dtype = np.float32
