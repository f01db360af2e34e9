"""Bitmap-row intersection: the hot kernel of triangle counting and of the
intersection operator.

Counterpart of ``essentials_tpu/ops/bitmap_intersect.py`` (reference parity:
graph::get_intersection_count, gunrock ``graph/csr.hxx:110-167``). Each
vertex's neighbourhood is packed on the host into a row of V bits; a pair
(u, v) counts ``popcount(B[u] & B[v])`` on the ``bitmap_intersect_counts``
kernel (``csrc/tc_kernels.cu``), which can also histogram the common
elements (the witnesses) per vertex.

Deliberate signature difference: the witness output is per vertex, int32
[words * 32] indexed by vertex id, where JAX's kernel returns its TPU lane
layout [32, R, 128]; so ``unpack_witness_counts`` is a slice. The bitmap is
[V+1, words] int32 (JAX's [V+1, R, 128] has the same bytes), and pairs need
no padding to a block of edges.
"""

from __future__ import annotations

import numpy as np
import torch

from essentials_tpu_torch import kernels

LANES = 128                 # words per row are a multiple of this


def pack_bitmap_rows(n_rows: int, src: np.ndarray, dst: np.ndarray
                     ) -> np.ndarray:
    """Host: pack edges (src -> dst) into [n_rows+1, R*128] int32 bit rows,
    bit ``dst & 31`` of word ``dst >> 5`` (row n_rows left all-zero for pad
    pairs). The bytes equal the JAX package's [n_rows+1, R, 128]."""
    words = -(-n_rows // 32)
    r = max(-(-words // LANES), 1)
    b = np.zeros((n_rows + 1, r * LANES), np.uint32)
    np.bitwise_or.at(b, (src, dst >> 5), np.uint32(1) << (dst & 31))
    return b.view(np.int32)


def bitmap_intersect_counts(eu: torch.Tensor, ev: torch.Tensor,
                            bitmap: torch.Tensor, *,
                            witness: bool = True) -> tuple:
    """Per pair e: |B[eu[e]] ∩ B[ev[e]]|, and with ``witness`` the number of
    pairs whose intersection holds each vertex. eu, ev: [E] int32 row ids
    (a pad pair points at the all-zero last row); bitmap: [rows, words]
    int32 from ``pack_bitmap_rows``. Returns (cnt [E] int32, wit [words*32]
    int32 or None), on the tensors' device."""
    return kernels.bitmap_intersect_counts(eu, ev, bitmap, witness)


def unpack_witness_counts(wit: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Per-vertex witness counts [n_rows] int64."""
    return wit[:n_rows].long()
