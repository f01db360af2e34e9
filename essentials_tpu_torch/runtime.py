"""Device discovery.

Counterpart of ``essentials_tpu/runtime.py`` (reference parity: gunrock's
``cuda/device_properties.hxx`` and ``context.hxx``). The JAX package keeps
per-generation hardware tables because its devices cannot be asked; here
``torch.cuda.get_device_properties`` answers. Nothing in the package picks
CUDA by itself: callers name the device, and ``require_cuda`` is how a caller
that needs the card refuses to go on without one.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from essentials_tpu_torch.errors import throw_if


@dataclass(frozen=True)
class DeviceProperties:
    name: str
    capability: tuple           # (major, minor); Hopper is (9, 0)
    sm_count: int               # streaming multiprocessors
    memory_gib: float           # device memory
    warp_size: int


def require_cuda() -> None:
    """Raise EssentialsError when PyTorch sees no CUDA device."""
    throw_if(not torch.cuda.is_available(),
             "no CUDA device: this path runs only on the GPU")


def device_properties(device: str | torch.device = "cuda") -> DeviceProperties:
    """Properties of a CUDA device (reference parity: gcuda
    device_properties + standard_context_t::props)."""
    require_cuda()
    p = torch.cuda.get_device_properties(torch.device(device))
    return DeviceProperties(name=p.name, capability=(p.major, p.minor),
                            sm_count=p.multi_processor_count,
                            memory_gib=p.total_memory / 2**30,
                            warp_size=getattr(p, "warp_size", 32))


def num_devices() -> int:
    return torch.cuda.device_count()
