"""Array printing helpers.

Counterpart of ``essentials_tpu/utils/printing.py`` (reference parity:
print::head, util/print.hxx:31-42).
"""

from __future__ import annotations

from essentials_tpu_torch.utils.compare import _host


def print_head(array, k: int = 10, name: str = "array") -> None:
    """Print the first ``k`` entries of a tensor (any device) or array."""
    a = _host(array)
    k = min(k, a.shape[0])
    print(f"{name} (first {k} of {a.shape[0]}): {a[:k]}")
