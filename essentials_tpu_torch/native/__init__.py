"""Native (C++) components, loaded with ctypes.

Counterpart of ``essentials_tpu/native`` (reference parity: gunrock's
vendored mmio.c): the ``.mtx`` parser ``mmio.cpp``, built at first use by
``mmio_native.build``. The JAX package's router library (``route.cpp``)
serves its TPU permutation plans and is not carried.
"""

from essentials_tpu_torch.native import mmio_native

__all__ = ["mmio_native"]
