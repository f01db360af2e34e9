"""Inclusive scans: cumsum and segmented scans on the ``scan`` kernel.

Counterpart of ``essentials_tpu/ops/scan_kernels.py:255-263, 328-353``.
The JAX package runs its Pallas ``scan_1d`` / ``segmented_scan_1d`` /
``segmented_minmax_1d`` on the TPU and ``jnp.cumsum`` /
``lax.associative_scan`` elsewhere; here every function runs the ``scan``
kernel (``csrc/operator_kernels.cu``) on a CUDA tensor and its
plain version on a CPU tensor. int32 sums wrap around (exact, as the
telescoping expansions need) and float32 scans are deterministic.

Segmented scans take (value, start flag) pairs under the operator
(v1,f1)·(v2,f2) = (f2 ? v2 : op(v1,v2), f1|f2); ``first`` keeps the older
value, so with the start flags it fills each segment with its first value.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if

OPS = kernels.SCAN_OPS


def _carrier(x: torch.Tensor) -> torch.Tensor:
    """int32 or float32: narrower integers and bools widen to int32."""
    throw_if(x.dim() != 1, "scans take 1-D tensors")
    if x.dtype in (torch.int32, torch.float32):
        return x.contiguous()
    throw_if(x.is_floating_point() or x.is_complex() or x.dtype == torch.int64,
             f"scans take int32, float32 or narrower integers, not {x.dtype}")
    return x.int()


def cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum of a 1-D tensor (int32 wraps around)."""
    return kernels.scan(_carrier(x), None, "add")


def segmented_scan(x: torch.Tensor, flags: torch.Tensor,
                   op: str) -> torch.Tensor:
    """Inclusive per-segment scan under ``op`` (add, min, max, first);
    ``flags`` marks segment starts, and position 0 always starts one."""
    if flags.dtype not in (torch.bool, torch.uint8):
        flags = flags != 0
    return kernels.scan(_carrier(x), flags.contiguous(), op)


def segmented_minmax(x: torch.Tensor, flags: torch.Tensor,
                     active: torch.Tensor) -> tuple:
    """(inclusive segmented MAX, inclusive segmented MIN) of the int32 ``x``
    over its ``active`` elements: inactive ones count as INT32_MIN in the
    MAX and INT32_MAX in the MIN. Two masked segmented scans, as the JAX
    package runs it off the TPU; a per-segment reduction is
    ``segment.combine_minmax_multi``."""
    x = _carrier(x)
    imax = kernels.INT32_MAX
    return (segmented_scan(torch.where(active, x, -imax - 1), flags, "max"),
            segmented_scan(torch.where(active, x, imax), flags, "min"))
