"""Algorithm helper primitives: search, sort, random fill.

Counterpart of ``essentials_tpu/algorithms/helpers.py`` (reference parity:
search::binary lower_bound/upper_bound/rightmost, binary_search.hxx:38-136;
sort::radix sort_keys/sort_pairs, radix_sort.hxx:40-52;
generate::random::uniform_distribution, random.hxx:22-34), on
``torch.searchsorted``, ``torch.sort`` and ``torch.rand``.
"""

from __future__ import annotations

import torch


def _needles(keys: torch.Tensor, needles) -> torch.Tensor:
    return torch.as_tensor(needles, dtype=keys.dtype, device=keys.device)


def lower_bound(keys: torch.Tensor, needles, *,
                sorted: bool = True) -> torch.Tensor:
    """First index where needle could be inserted keeping order."""
    return torch.searchsorted(keys, _needles(keys, needles), side="left")


def upper_bound(keys: torch.Tensor, needles) -> torch.Tensor:
    return torch.searchsorted(keys, _needles(keys, needles), side="right")


def rightmost(keys: torch.Tensor, needles) -> torch.Tensor:
    """Index of the rightmost element <= needle (-1 if none) — the variant
    block_mapped advance uses (binary_search.hxx:120-136)."""
    return upper_bound(keys, needles) - 1


def sort_keys(keys: torch.Tensor, *, descending: bool = False) -> torch.Tensor:
    out = torch.sort(keys, stable=True).values
    return out.flip(0) if descending else out


def sort_pairs(keys: torch.Tensor, values: torch.Tensor, *,
               descending: bool = False):
    order = torch.sort(keys, stable=True).indices
    if descending:
        order = order.flip(0)
    return keys[order], values[order]


def uniform_distribution(generator: torch.Generator, shape, low=0.0,
                         high=1.0, dtype=torch.float32) -> torch.Tensor:
    """Fill with uniform randoms in [low, high) from ``generator``, on the
    generator's device (the JAX package takes a counter-based key; the
    draws differ between packages)."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return u * (high - low) + low
