"""The kernel of ``csrc/tc_kernels.cu``: the bitmap intersections of
triangle counting and of the intersection operator."""

from __future__ import annotations

import torch

from essentials_tpu_torch.errors import throw_if

from ._lib import (Kernel, P, I, _check, _launch, _route, _spanned, declare,
                   launches)

__all__ = ["PLAIN_WORDS", "bitmap_intersect_counts",
           "bitmap_intersect_counts_plain"]

PLAIN_WORDS = 1 << 25   # bitmap words the plain version gathers at a time

declare(
    "tc_kernels.cu",
    Kernel(launches={"bitmap_intersect_counts": "bitmap_intersect.py:118"},
           entries={"etpu_bitmap_intersect": (P, P, P, I, I, P, P, P)}))


def bitmap_intersect_counts_plain(eu, ev, bitmap, witness: bool = True):
    """Plain version of ``bitmap_intersect_counts``, over chunks of pairs
    (so that the card holds it at rmat17 shapes)."""
    dev, ne, words = eu.device, eu.numel(), bitmap.shape[1]
    cnt = torch.zeros(ne, dtype=torch.int32, device=dev)
    wit = (torch.zeros(words * 32, dtype=torch.int32, device=dev)
           if witness else None)
    bits = torch.arange(32, dtype=torch.int32, device=dev)
    step = max(1, PLAIN_WORDS // words)
    for lo in range(0, ne, step):
        w = bitmap[eu[lo:lo + step].long()] & bitmap[ev[lo:lo + step].long()]
        e, k = w.nonzero(as_tuple=True)
        on = (w[e, k].unsqueeze(1) >> bits) & 1          # [nonzero, 32]
        cnt.index_add_(0, e + lo, on.sum(1, dtype=torch.int32))
        if witness:
            wit.index_add_(0, (k.unsqueeze(1) * 32 + bits).flatten(),
                           on.flatten())
    return cnt, wit


@_spanned
def bitmap_intersect_counts(eu: torch.Tensor, ev: torch.Tensor,
                            bitmap: torch.Tensor,
                            witness: bool = True) -> tuple:
    """Per pair e: cnt[e] = popcount(bitmap[eu[e]] & bitmap[ev[e]]), and
    with ``witness`` the per-vertex histogram wit[c] = the pairs whose AND
    holds bit c (bit c & 31 of word c >> 5). ``eu``, ``ev`` are [E] int32
    row ids in range; ``bitmap`` is [rows, words] int32, words a multiple
    of 4. Returns (cnt [E] int32, wit [words * 32] int32 or None)."""
    name = "bitmap_intersect_counts"
    throw_if(eu.dtype != torch.int32 or eu.dim() != 1
             or ev.dtype != torch.int32 or ev.shape != eu.shape,
             f"{name}: eu and ev must be [E] int32")
    throw_if(bitmap.dtype != torch.int32 or bitmap.dim() != 2
             or bitmap.shape[1] % 4 or bitmap.shape[1] == 0,
             f"{name}: bitmap must be [rows, words] int32, words a positive "
             f"multiple of 4")
    if not _route(name, eu):
        return bitmap_intersect_counts_plain(eu, ev, bitmap, witness)
    dev = eu.device
    _check(name, dev, eu=eu, ev=ev, bitmap=bitmap)
    throw_if(bitmap.data_ptr() % 16 != 0,
             f"{name}: bitmap must be 16-byte aligned")
    words = bitmap.shape[1]
    cnt = torch.empty(eu.numel(), dtype=torch.int32, device=dev)
    wit = (torch.zeros(words * 32, dtype=torch.int32, device=dev)
           if witness else None)
    _launch("etpu_bitmap_intersect", dev, eu.data_ptr(), ev.data_ptr(),
            bitmap.data_ptr(), words, eu.numel(), cnt.data_ptr(),
            None if wit is None else wit.data_ptr())
    launches[name] += 1
    return cnt, wit
