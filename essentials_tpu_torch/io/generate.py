"""Synthetic graph generators: RMAT/Kronecker, uniform random, grids, chains.

Counterpart of ``essentials_tpu/io/generate.py``, draw for draw: the same
``np.random.default_rng(seed)`` calls in the same order, so that both
packages build byte-identical graphs from one seed. RMAT with
(a,b,c,d)=(.57,.19,.19,.05) is the Graph500 kron_g500 generator family.
"""

from __future__ import annotations

import numpy as np

from essentials_tpu_torch import dtypes
from essentials_tpu_torch.formats.coo import Coo


def _finalize(n, rows, cols, rng, undirected: bool, weighted: bool) -> Coo:
    """Dedup/clean an edge sample; for undirected graphs, canonicalize to
    u<v before mirroring so weights are exactly symmetric."""
    keep = rows != cols
    rows, cols = rows[keep], cols[keep]
    if undirected:
        lo = np.minimum(rows, cols)
        hi = np.maximum(rows, cols)
        keys = lo * n + hi
        _, first = np.unique(keys, return_index=True)
        lo, hi = lo[first], hi[first]
        vals = (rng.random(lo.size, dtype=np.float32) * 63 + 1).astype(
            dtypes.weight_dtype) if weighted else np.ones(lo.size, dtypes.weight_dtype)
        rows = np.concatenate([lo, hi])
        cols = np.concatenate([hi, lo])
        vals = np.concatenate([vals, vals])
        return Coo(n, n, rows.astype(dtypes.vertex_dtype),
                   cols.astype(dtypes.vertex_dtype), vals)
    keys = rows * n + cols
    _, first = np.unique(keys, return_index=True)
    rows, cols = rows[first], cols[first]
    vals = (rng.random(rows.size, dtype=np.float32) * 63 + 1).astype(
        dtypes.weight_dtype) if weighted else np.ones(rows.size, dtypes.weight_dtype)
    return Coo(n, n, rows.astype(dtypes.vertex_dtype),
               cols.astype(dtypes.vertex_dtype), vals)


def rmat(scale: int, edge_factor: int = 16, *, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 1, undirected: bool = True,
         weighted: bool = True) -> Coo:
    """RMAT/Kronecker power-law graph: 2**scale vertices, V*edge_factor edges."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    rows = np.zeros(m, dtype=np.int64)
    cols = np.zeros(m, dtype=np.int64)
    ab = a + b
    for _ in range(scale):
        r = rng.random(m)
        bit_r = (r >= ab).astype(np.int64)           # lands in lower half?
        r2 = rng.random(m)
        # Column bit depends on which row half we're in.
        thresh = np.where(bit_r == 0, a / ab, c / (1.0 - ab))
        bit_c = (r2 >= thresh).astype(np.int64)
        rows = (rows << 1) | bit_r
        cols = (cols << 1) | bit_c
    # Permute vertex ids to break the kron locality artifact.
    perm = rng.permutation(n)
    rows, cols = perm[rows], perm[cols]
    return _finalize(n, rows, cols, rng, undirected, weighted)


def uniform_random(n: int, avg_degree: int, *, seed: int = 1,
                   undirected: bool = True, weighted: bool = True) -> Coo:
    """Erdős–Rényi-style random graph with ~n*avg_degree edges."""
    rng = np.random.default_rng(seed)
    m = n * avg_degree
    rows = rng.integers(0, n, m, dtype=np.int64)
    cols = rng.integers(0, n, m, dtype=np.int64)
    return _finalize(n, rows, cols, rng, undirected, weighted)


def grid_2d(side: int, *, weighted: bool = False, seed: int = 1) -> Coo:
    """side x side 4-neighbor mesh — the high-diameter (road-network-like) case."""
    n = side * side
    idx = np.arange(n).reshape(side, side)
    pairs = [(idx[:, :-1].ravel(), idx[:, 1:].ravel()),
             (idx[:-1, :].ravel(), idx[1:, :].ravel())]
    rows = np.concatenate([p[0] for p in pairs])
    cols = np.concatenate([p[1] for p in pairs])
    if weighted:
        # one weight per undirected edge, mirrored exactly
        rng = np.random.default_rng(seed)
        half = (rng.random(rows.size, dtype=np.float32) * 9 + 1).astype(
            dtypes.weight_dtype)
        vals = np.concatenate([half, half])
    else:
        vals = np.ones(2 * rows.size, dtype=dtypes.weight_dtype)
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    return Coo(n, n, rows.astype(dtypes.vertex_dtype),
               cols.astype(dtypes.vertex_dtype), vals)


def chain(n: int, *, weighted: bool = False) -> Coo:
    """Path graph 0-1-...-(n-1): worst-case diameter for BFS supersteps.
    ``weighted`` is accepted for signature parity; every weight is 1."""
    rows = np.arange(n - 1, dtype=np.int64)
    cols = rows + 1
    rows, cols = np.concatenate([rows, cols]), np.concatenate([cols, rows])
    vals = np.ones(rows.size, dtype=dtypes.weight_dtype)
    return Coo(n, n, rows.astype(dtypes.vertex_dtype),
               cols.astype(dtypes.vertex_dtype), vals)
