"""Error handling.

Counterpart of ``essentials_tpu/errors.py`` (reference parity: gunrock's
``error.hxx`` error_t / exception_t / throw_if_exception). Errors are host-side
Python exceptions; a CUDA kernel's launch status is turned into one by the
wrapper that launched it (``essentials_tpu_torch/kernels/``).
"""

from __future__ import annotations


class EssentialsError(RuntimeError):
    """Framework-level error (reference: gunrock::error::exception_t)."""


def throw_if(condition: bool, message: str = "") -> None:
    """Raise EssentialsError when ``condition`` is truthy.

    Reference parity: error::throw_if_exception(bool, str) (error.hxx:37-45).
    """
    if condition:
        raise EssentialsError(message)
