"""The plain reference of k-core decomposition: level-synchronous peeling in
PyTorch over the benchmark's own CSR.

It imports nothing but torch: not JAX, not the JAX package and nothing of
the program under test (not its kernels' plain versions, not its
``cpu_reference``). It reads the benchmark's CSR (``graphs.Csr``) and runs
after the measured window, beside the graph's offsets and columns.

At each level k, every alive vertex of remaining degree below k is peeled
with core number k - 1, and each slot of its CSR row takes one from its
target's degree; this repeats at the same k until no alive vertex is below
it (the cascade), then k jumps to the smallest alive degree + 1. A vertex
of degree 0 is never alive and gets 0. The core number is unique (Matula
and Beck 1983), so every correct peeling gives the same [V] int32 bits.

The control is the same loop with the cascade broken: one wave a level,
then k moves on, so a vertex whose degree fell below k in that wave is
peeled a level late.
"""

from __future__ import annotations

import torch

INT32_MAX = 2**31 - 1
CHUNK = 1 << 26          # row slots expanded at once


def _lower_targets(csr, rows: torch.Tensor, deg: torch.Tensor) -> None:
    """Take one from ``deg`` at the target of every CSR slot of ``rows``
    (int64 vertex ids), CHUNK slots at a time."""
    off = csr.row_offsets
    starts = off[rows].long()
    lens = off[rows + 1].long() - starts
    ends = torch.cumsum(lens, 0)
    total = int(ends[-1]) if ends.numel() else 0
    for lo in range(0, total, CHUNK):
        place = torch.arange(lo, min(lo + CHUNK, total), dtype=torch.int64,
                             device=deg.device)
        row = torch.searchsorted(ends, place, right=True)
        slot = starts[row] + place - (ends[row] - lens[row])
        deg.index_add_(0, csr.col[slot].long(), torch.full_like(slot, -1))


def kcore(csr, *, cascade: bool = True) -> torch.Tensor:
    """Core numbers [V] int32 of the undirected graph ``csr`` (each edge in
    both rows). ``cascade=False`` is the control: one wave a level."""
    off = csr.row_offsets
    deg = (off[1:] - off[:-1]).long()
    alive = deg > 0
    core = torch.zeros(csr.n, dtype=torch.int32, device=deg.device)
    k = 1
    while True:
        peel = alive & (deg < k)
        cnt, least = torch.stack([
            peel.sum(), torch.where(alive, deg, INT32_MAX).min()]).tolist()
        if cnt == 0:
            if least == INT32_MAX:
                return core
            k = least + 1
            continue
        core = torch.where(peel, k - 1, core)
        alive &= ~peel
        _lower_targets(csr, torch.nonzero(peel).flatten(), deg)
        if not cascade:
            k += 1
