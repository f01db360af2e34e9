"""Mesh construction helpers.

Counterpart of ``essentials_tpu/parallel/mesh.py``. The JAX package runs one
controller over a ``jax.sharding.Mesh`` of every device; the port runs one
process per device (``torch.distributed``), and its mesh is the small record
that each rank's supersteps need: the group, this rank, the group's size and
this rank's device. The JAX mesh's axis name has no counterpart: no
collective of the port names an axis.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from essentials_tpu_torch.errors import throw_if


@dataclass(frozen=True)
class Mesh:
    """1-D vertex-partition mesh over a process group: rank ``rank`` of
    ``size`` holds partition ``rank`` on ``device``."""
    group: object
    rank: int
    size: int
    device: torch.device


def _require_group() -> None:
    throw_if(not dist.is_available() or not dist.is_initialized(),
             "no process group: call parallel.multihost.initialize first")


def device_count() -> int:
    """Devices (ranks) of the initialized default group."""
    _require_group()
    return dist.get_world_size()


def make_mesh(n_devices: int | None = None) -> Mesh:
    """1-D mesh over the initialized default group, whose size must be
    ``n_devices`` where given. A rank's device is the current CUDA device
    under NCCL and the CPU under gloo."""
    _require_group()
    size = dist.get_world_size()
    throw_if(n_devices is not None and n_devices != size,
             f"make_mesh: {n_devices} devices asked, the group has {size} "
             f"ranks (one per device)")
    backend = dist.get_backend()
    throw_if(backend not in ("nccl", "gloo"),
             f"make_mesh: no device rule for backend {backend!r}")
    device = torch.device("cuda", torch.cuda.current_device()) \
        if backend == "nccl" else torch.device("cpu")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size,
                device=device)
