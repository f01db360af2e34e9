"""Multi-process orchestration.

Counterpart of ``essentials_tpu/parallel/multihost.py``: thin wrappers over
``torch.distributed`` so that the same supersteps run with one process per
device, on one host or several. NCCL carries the collectives between cards;
gloo carries them between CPU processes (the tests). Nothing falls back: a
failed rendezvous or collective raises.

The JAX package's ``to_global`` (a host array placed as a global array) has
no counterpart: each rank holds only its own slice (``DistGraph.local``),
and ``gather_global`` assembles a global vector where a caller needs one.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from essentials_tpu_torch import runtime
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.parallel.mesh import Mesh, device_count, make_mesh


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, *,
               device: str | torch.device = "cuda") -> None:
    """Join (or make) the default process group: NCCL for a CUDA device,
    gloo for ``device="cpu"``. A CUDA rank takes card ``process_id % the
    cards this host has``. ``coordinator_address`` is "host:port" of rank
    0's store. With ``num_processes`` 1 (or None) this makes a one-rank
    group on a TCP store of this process (the JAX package's is a no-op
    there, but the port's collectives need a group)."""
    dev = torch.device(device)
    throw_if(dev.type not in ("cuda", "cpu"),
             f"initialize: no backend for device {dev}")
    throw_if(dist.is_initialized(), "initialize: a process group exists")
    n = 1 if num_processes is None else int(num_processes)
    rank = 0 if process_id is None else int(process_id)
    throw_if(n < 1 or not 0 <= rank < n,
             f"initialize: process {rank} of {n}")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl":
        runtime.require_cuda()
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if n == 1 and coordinator_address is None:
        store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
        dist.init_process_group(backend, store=store, rank=0, world_size=1)
        return
    throw_if(coordinator_address is None,
             "initialize: several processes need coordinator_address")
    dist.init_process_group(backend, init_method=f"tcp://"
                            f"{coordinator_address}", rank=rank,
                            world_size=n)


def global_mesh() -> Mesh:
    """1-D mesh over every rank of every process."""
    return make_mesh()


def is_coordinator() -> bool:
    """Rank 0 of the initialized group (raises without one)."""
    device_count()
    return dist.get_rank() == 0


def gather_global(mesh: Mesh, shard: torch.Tensor) -> torch.Tensor:
    """Every rank's [Vs] ``shard`` side by side: the [P * Vs] global vector
    (one all_gather_into_tensor)."""
    throw_if(shard.dim() != 1 or shard.device != mesh.device,
             f"gather_global: a 1-D shard on {mesh.device}")
    out = shard.new_empty(mesh.size * shard.numel())
    dist.all_gather_into_tensor(out, shard.contiguous(), group=mesh.group)
    return out
