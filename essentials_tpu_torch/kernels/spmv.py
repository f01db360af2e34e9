"""The kernels of ``csrc/spmv_kernels.cu``: the edge-balanced SpMV of SpMV,
PageRank and HITS (``spmv_rows``) and the slab sweeps of the windowed SpMV
and SSSP (``spmv_slabs``). Both are bound by the bytes they stream and the
scattered x gathers."""

from __future__ import annotations

import torch

from essentials_tpu_torch.errors import EssentialsError, throw_if

from ._lib import (INF_BITS, INT32_MAX, Kernel, P, I, _check, _launch,
                   _route, _segment_ids, _spanned, declare, launches)

__all__ = ["MESSAGES", "REDUCES", "ROW_ITEMS", "ROW_TILE", "SLAB_EDGES",
           "SLAB_ITEMS", "slab_count", "spmv_rows", "spmv_rows_plain",
           "spmv_slabs", "spmv_slabs_plain"]

SLAB_EDGES = 4096              # edges per spmv_slabs block (kSlab in the .cu)
SLAB_ITEMS = 16                # consecutive edges per spmv_slabs thread (kItems)
ROW_ITEMS = 8                  # merge places per spmv_rows thread (kRowItems)
ROW_TILE = 2048                # merge places per spmv_rows block (kRowTile)
MESSAGES = ("mul", "add", "none")
REDUCES = ("sum", "min")

declare(
    "spmv_kernels.cu",
    Kernel(launches={"spmv_rows": "fused_spmv.py:179"},
           entries={"etpu_spmv_rows_mul": (P, P, P, P, I, I, P, P, P),
                    "etpu_spmv_rows_none": (P, P, P, P, I, I, P, P, P)},
           constants={"etpu_spmv_row_tile": ("ROW_TILE", ROW_TILE)}),
    Kernel(launches={"spmv_slabs": "windowed_spmv.py:454"},
           entries={f"etpu_spmv_slabs_{m}_{r}": (P, P, P, P, P, I, I, P, P,
                                                 P)
                    for m in MESSAGES for r in REDUCES},
           constants={"etpu_spmv_slab_edges": ("SLAB_EDGES", SLAB_EDGES)}))


def _check_spmv(name: str, off, col, w, x, flags=None) -> None:
    """Types and shapes of the CSR arrays and vectors an SpMV kernel takes:
    off [Vp+1] int32, col [Ep] int32, w [Ep] float32 or None, x [Vp]
    float32, flags [Ep] bool or uint8."""
    if off.dtype != torch.int32 or off.dim() != 1 or off.numel() < 2:
        raise EssentialsError(f"{name}: off must be [Vp+1] int32")
    vp, ep = off.numel() - 1, col.numel()
    if col.dtype != torch.int32 or col.dim() != 1:
        raise EssentialsError(f"{name}: col must be [Ep] int32")
    if x.dtype != torch.float32 or x.shape != (vp,):
        raise EssentialsError(f"{name}: x must be [Vp] = [{vp}] float32")
    if w is not None and (w.dtype != torch.float32 or w.shape != (ep,)):
        raise EssentialsError(f"{name}: w must be [Ep] = [{ep}] float32")
    if flags is not None and (flags.dtype not in (torch.bool, torch.uint8)
                              or flags.shape != (ep,)):
        raise EssentialsError(f"{name}: flags must be [Ep] = [{ep}] bool "
                              f"or uint8")


def _message(x, col, w, message: str) -> torch.Tensor:
    """[Ep] float32: x[col] * w, x[col] + w or x[col]."""
    xc = x[col.long()]
    if message == "mul":
        return xc * w
    if message == "add":
        return xc + w
    return xc


def _reduce_into(n: int, index, vals, reduce: str) -> torch.Tensor:
    """[n] int32 bits: the f32 sum (``sum``) or the int32 minimum (``min``,
    from INF_BITS) of the float32 ``vals`` grouped by ``index``."""
    if reduce == "sum":
        out = torch.zeros(n, dtype=torch.float32, device=vals.device)
        return out.index_add_(0, index, vals).view(torch.int32)
    out = torch.full((n,), INF_BITS, dtype=torch.int32, device=vals.device)
    return out.scatter_reduce_(0, index, vals.view(torch.int32), "amin")


def slab_count(ep: int) -> int:
    """Blocks of ``spmv_slabs`` over ``ep`` edges."""
    return (ep + SLAB_EDGES - 1) // SLAB_EDGES


def _partials(vals, key, reduce: str):
    """Reduce the float32 ``vals`` over runs of equal ``key`` (sorted):
    (one float32 partial per run, as int32 bits; the first index of each
    run)."""
    n = key.numel()
    new = torch.ones(n, dtype=torch.bool, device=vals.device)
    new[1:] = key[1:] != key[:-1]
    run = torch.cumsum(new.long(), 0) - 1
    return _reduce_into(int(run[-1]) + 1 if n else 0, run, vals, reduce), new


def _grouped_reduce(vals, row, place, vp: int, items: int, tile: int,
                    reduce: str):
    """[vp] int32 bits: each row's ``vals`` reduced as the edge-balanced
    kernels group them. ``place`` (non-decreasing, like ``row``) is each
    value's place in the kernel's order; a row's values within one run of
    ``items`` places are reduced in order, then those runs within each
    ``tile`` of places, then the tile partials folded in tile order."""
    span = int(place[-1]) + 1 if place.numel() else 1
    part, new = _partials(vals, row * span + place // items, reduce)
    row, place = row[new], place[new]
    part, new = _partials(part.view(torch.float32), row * span + place //
                          tile, reduce)
    row = row[new]
    first = torch.ones_like(row, dtype=torch.bool)
    first[1:] = row[1:] != row[:-1]
    ident = 0 if reduce == "sum" else INF_BITS
    y = torch.full((vp,), ident, dtype=torch.int32, device=vals.device)
    y[row[first]] = part[first]
    # the k-th tile partial of every row, k = 1, 2, ..., folded in turn
    at = torch.arange(row.numel(), device=vals.device)
    k = at - torch.cummax(torch.where(first, at, 0), 0).values
    for j in range(1, int(k.max()) + 1 if k.numel() else 1):
        r, v = row[k == j], part[k == j]
        if reduce == "sum":
            y[r] = (y[r].view(torch.float32)
                    + v.view(torch.float32)).view(torch.int32)
        else:
            y[r] = torch.minimum(y[r], v)
    return y


def spmv_rows_plain(off, col, w, x):
    """Plain version of ``spmv_rows``, with the kernel's grouping: edge p of
    row r sits at place p + r of the sequence that merges the row ends with
    the edges; a row's edges within one ROW_ITEMS run of places (a
    thread's) are summed in edge order, then those runs within each
    ROW_TILE tile (the kernel joins them by a scan, in another order), then
    the tile partials in tile order (the kernel by a fixed tree)."""
    ep = col.numel()
    row = _segment_ids(off, ep)
    place = torch.arange(ep, device=x.device) + row
    return _grouped_reduce(_message(x, col, w, "none" if w is None else "mul"),
                           row, place, off.numel() - 1, ROW_ITEMS, ROW_TILE,
                           "sum").view(torch.float32)


@_spanned
def spmv_rows(off: torch.Tensor, col: torch.Tensor, w: torch.Tensor | None,
              x: torch.Tensor) -> torch.Tensor:
    """y = A x on the CSR rows in one launch, balanced by rows and edges
    (a merge-path partition of the row ends and edges into tiles of
    ROW_TILE places): [Vp] float32 with y[r] = sum over r's edges p of
    w[p] * x[col[p]], or of x[col[p]] when ``w`` is None; 0 at empty rows.
    A row that crosses tiles is completed from the partials of the tiles
    before it in a fixed order, so two launches give the same bits.
    ``col`` and ``w`` must be 16-byte aligned."""
    name = "spmv_rows"
    _check_spmv(name, off, col, w, x)
    if not _route(name, x):
        return spmv_rows_plain(off, col, w, x)
    dev = x.device
    _check(name, dev, off=off, col=col, x=x,
           **({} if w is None else {"w": w}))
    wp = 0 if w is None else w.data_ptr()
    if (col.data_ptr() | wp) & 15:
        raise EssentialsError(f"{name}: col and w must be 16-byte aligned")
    vp, ep = off.numel() - 1, col.numel()
    throw_if(vp + ep + ROW_TILE > INT32_MAX,
             f"{name}: Vp + Ep must stay below 2^31 - {ROW_TILE}")
    y = torch.empty(vp, dtype=torch.float32, device=dev)
    tiles = -(-(vp + ep) // ROW_TILE)      # a status word each, the ticket
    scratch = torch.empty(2 * tiles + 1, dtype=torch.int32, device=dev)
    _launch("etpu_spmv_rows_none" if w is None else "etpu_spmv_rows_mul",
            dev, off.data_ptr(), col.data_ptr(), wp or None, x.data_ptr(),
            vp, ep, y.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    return y


def spmv_slabs_plain(off, col, w, flags, x, message: str, reduce: str):
    """Plain version of ``spmv_slabs``, with the kernel's grouping: each run
    of a row's edges within one SLAB_ITEMS group (a thread's) in edge
    order, then the groups within each slab (the kernel joins them by a
    scan, in another order), then the slab partials folded in slab order.
    It finds the rows from ``off`` and does not read ``flags``, which mark
    the same row starts."""
    ep = col.numel()
    return _grouped_reduce(_message(x, col, w, message),
                           _segment_ids(off, ep),
                           torch.arange(ep, device=x.device),
                           off.numel() - 1, SLAB_ITEMS, SLAB_EDGES, reduce)


@_spanned
def spmv_slabs(off: torch.Tensor, col: torch.Tensor, w: torch.Tensor | None,
               flags: torch.Tensor, x: torch.Tensor, message: str,
               reduce: str) -> torch.Tensor:
    """y = reduce over each CSR row of its messages, in one launch of one
    block per slab of SLAB_EDGES edges: messages ``mul`` x[col]*w, ``add``
    x[col]+w, ``none`` x[col] (``w`` None only for ``none``), reduced by a
    segmented ``sum`` (float32) or ``min`` (int32 bits) over ``flags``
    (the [Ep] row-start flags, bool or uint8). Returns [Vp] int32: sums as
    float32 bits, the identity (0 or INF_BITS) at an empty row. A row that
    crosses slabs is folded in slab order, so two launches give the same
    bits. ``col``, ``w`` and ``flags`` must be 16-byte aligned."""
    name = "spmv_slabs"
    if message not in MESSAGES or reduce not in REDUCES:
        raise EssentialsError(f"{name}: message must be one of {MESSAGES} "
                              f"and reduce one of {REDUCES}")
    if (w is None) != (message == "none"):
        raise EssentialsError(f"{name}: w is needed exactly for messages "
                              f"'mul' and 'add'")
    _check_spmv(name, off, col, w, x, flags)
    if not _route(name, x):
        return spmv_slabs_plain(off, col, w, flags, x, message, reduce)
    dev = x.device
    _check(name, dev, off=off, col=col, flags=flags, x=x,
           **({} if w is None else {"w": w}))
    wp = 0 if w is None else w.data_ptr()
    if (col.data_ptr() | wp | flags.data_ptr()) & 15:
        raise EssentialsError(f"{name}: col, w and flags must be 16-byte "
                              f"aligned")
    vp, ep = off.numel() - 1, col.numel()
    y = torch.empty(vp, dtype=torch.int32, device=dev)
    if ep == 0:
        return y.fill_(0 if reduce == "sum" else INF_BITS)
    scratch = torch.empty(2 * slab_count(ep) + 1, dtype=torch.int32,
                          device=dev)
    _launch(f"etpu_spmv_slabs_{message}_{reduce}", dev, off.data_ptr(),
            col.data_ptr(), wp or None, flags.data_ptr(), x.data_ptr(), vp,
            ep, y.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    return y
