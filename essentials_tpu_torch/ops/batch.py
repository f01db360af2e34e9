"""batch: run one algorithm over many seeds or sources.

Counterpart of ``essentials_tpu/ops/batch.py:18-21`` (reference parity:
operators::batch::execute, batch/batch.hxx:61-81, a CPU thread per job;
used by BC and PPR). The JAX package vmaps the function over the seed axis
into one program. Here it is a loop on the host: each seed runs to its own
end through the same kernels, and the results are stacked along a new
first axis. Batched kernels are later speed work.
"""

from __future__ import annotations

from typing import Callable

import torch


def batch_execute(fn: Callable, seeds, *args):
    """``fn(seed, *args)`` for each seed (a sequence or a 1-D tensor of
    ints), the args shared; the results stacked along a new first axis: a
    tensor for a tensor result, a tuple of stacked tensors for a tuple."""
    seeds = seeds.tolist() if isinstance(seeds, torch.Tensor) else seeds
    outs = [fn(int(s), *args) for s in seeds]
    if isinstance(outs[0], tuple):
        return tuple(_stack(list(col)) for col in zip(*outs))
    return _stack(outs)


def _stack(vals: list) -> torch.Tensor:
    if isinstance(vals[0], torch.Tensor):
        return torch.stack(vals)
    return torch.tensor(vals)
