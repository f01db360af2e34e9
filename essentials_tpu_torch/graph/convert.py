"""Offsets <-> indices conversions on the graph's device.

Counterpart of ``essentials_tpu/graph/convert.py`` (reference parity:
graph/conversions/convert.hxx:18-66). ``offsets_to_indices`` is one
``expand_segments`` launch on a CUDA tensor (its plain version on the CPU);
``indices_to_offsets`` is a vectorised lower bound.
"""

from __future__ import annotations

import torch

from essentials_tpu_torch import kernels


def offsets_to_indices(offsets: torch.Tensor, n_elements: int) -> torch.Tensor:
    """[S+1] non-decreasing offsets -> [n_elements] int32 segment id per
    element: element i belongs to the last segment s >= 1 with
    offsets[s] <= i, else to segment 0.

    This is the JAX package's scatter-add and cumsum: ``offsets[0]`` and
    ``offsets[S]`` are not read, so the elements before ``offsets[1]`` are
    segment 0's and those from ``offsets[S-1]`` on, past ``offsets[S]`` too,
    segment S-1's. The segments handed to ``expand_segments`` are these:
    offsets[1:S] clamped to [0, n_elements], between 0 and n_elements."""
    s = offsets.numel() - 1
    dev = offsets.device
    if s <= 0:
        return torch.zeros(n_elements, dtype=torch.int32, device=dev)
    cover = torch.empty(s + 1, dtype=torch.int32, device=dev)
    cover[0] = 0
    cover[1:s] = offsets[1:s].clamp(0, n_elements)
    cover[s] = n_elements
    ids = torch.arange(s, dtype=torch.int32, device=dev)
    return kernels.expand_segments(ids, cover, n_elements)


def indices_to_offsets(indices: torch.Tensor, n_segments: int) -> torch.Tensor:
    """Sorted [N] segment ids -> [n_segments+1] int32 offsets (a vectorised
    lower bound, reference parity with the thrust lower_bound version)."""
    seg = torch.arange(n_segments + 1, dtype=indices.dtype,
                       device=indices.device)
    return torch.searchsorted(indices.contiguous(), seg,
                              right=False).to(torch.int32)
