"""Validation primitive: device result vs host reference.

Counterpart of ``essentials_tpu/utils/compare.py`` (reference parity:
util::compare, gunrock ``util/compare.hxx:37-56``): returns the number of
mismatching elements; float comparisons take an absolute/relative tolerance.
Two non-finite values agree where both are NaN or both the same infinity.
The JAX package's compare counts NaN against NaN as a mismatch, so its CLI
fails geo's validation wherever a vertex stays unlocated (NaN in the
result and in the host reference alike).
"""

from __future__ import annotations

import numpy as np
import torch


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def compare(result, reference, *, atol: float = 1e-5, rtol: float = 1e-5,
            verbose: bool = False, name: str = "array") -> int:
    """Count mismatches between ``result`` (tensor or array) and ``reference``."""
    a = _host(result)
    b = _host(reference)
    n = min(a.shape[0], b.shape[0])
    a, b = a[:n], b[:n]
    if np.issubdtype(a.dtype, np.floating) or np.issubdtype(b.dtype, np.floating):
        af = a.astype(np.float64)
        bf = b.astype(np.float64)
        both_nan = np.isnan(af) & np.isnan(bf)
        both_nonfinite = both_nan | (~np.isfinite(af) & ~np.isfinite(bf)
                                     & (np.sign(af) == np.sign(bf)))
        mismatch = ~(np.isclose(af, bf, atol=atol, rtol=rtol) | both_nonfinite)
    else:
        mismatch = a != b
    errors = int(np.sum(mismatch))
    if verbose and errors:
        for i in np.nonzero(mismatch)[0][:16]:
            print(f"  {name}[{i}]: got {a[i]} expected {b[i]}")
    return errors
