"""Graph coloring: Jones-Plassmann with WAVES priority waves (``jp``) and the
speculative recolor (``spec``).

Counterpart of ``essentials_tpu/algorithms/color.py``; reference parity:
gunrock::color, ``color.hxx:63-141``.

* ``jp``: every vertex holds WAVES random priority permutations. Per round,
  each uncolored vertex whose wave-j priority is above (below) that of
  every uncolored in-neighbour takes color 2(it WAVES + j) (+1). The
  per-edge priorities ``pri_csc`` are gathered into CSC order once at init
  (``gather_payloads``); a dense round gathers the uncolored mask the same
  way and takes every wave's neighbour MAX and MIN in one ``segment_minmax``
  launch. Where the spray is on and the uncolored set's out-edges fit its
  budget, the round enumerates them instead (``sparse_advance``).
* ``spec``: every vertex picks a hashed color in [0, deg]; per round the
  higher-(deg, id)-rank endpoint of every conflicting edge rehashes. The
  dense conflict test is ``advance`` (``segment_reduce`` MAX); the spray
  covers the vertices recolored last round.

The JAX package picks each round's branch on the device (``lax.cond``);
here the state carries the uncolored (or recolored) set's size, its total
out-degree and whether the index list is current, read in one transfer at
the end of each round (``sparse_advance.read_control``), and the host picks
the branch. The default priorities are 8 ``torch.randperm`` of a CPU
generator seeded from ``seed`` (``jax.random.permutation`` cannot be
reproduced), so a CPU run and a card run color alike; ``init`` and ``run``
take other priorities as ``pris``.

Arithmetic is the JAX package's bit for bit: ``_hash_color`` is uint32
arithmetic (computed in int64 and masked to 32 bits), and the spec rank
deg * (Vp + 1) + id wraps around in int32 as there. Two of the
reference's faults are handled so: its ``seed * 0x9E3779B9`` overflows
uint32 for seed >= 2 and raises, which the port wraps instead; and its
``run`` passes ``seed`` only to ``init_spec``, so every recolor hashes with
seed 0, which the port keeps (ROADMAP.md queue 3).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch import kernels
from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.framework.enactor import default_converged, enact
from essentials_tpu_torch.frontier import full_frontier
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import sparse_advance as SA
from essentials_tpu_torch.ops.advance import _expand_and_route, advance
from essentials_tpu_torch.ops.configs import AdvanceIO, Combine
from essentials_tpu_torch.ops.segment import combine_minmax_multi, gather

# independent priority waves per round (the round count divides by ~WAVES)
WAVES = 8
IMAX = kernels.INT32_MAX
VARIANTS = ("jp", "spec")
TIERS = ("spray", "dense")
_M32 = 0xFFFFFFFF


class ColorState(NamedTuple):
    """The uncolored set only shrinks, so once it fits the index list the
    spray keeps the list current by filtering it. fcount, fvalid, degsum
    and live are host values."""
    colors: torch.Tensor      # int32[Vp], -1 = uncolored
    pris: torch.Tensor        # int32[WAVES, Vp] priority permutations
    pri_csc: torch.Tensor     # int32[WAVES, Ep]: pris[j][csc_src[q]]
    frontier: torch.Tensor    # bool[Vp] uncolored vertices
    fidx: torch.Tensor        # int32[K] the uncolored set when fvalid
    fcount: int               # |frontier| as the last round counted it
    fvalid: bool              # fidx is in sync with frontier
    degsum: int               # total out-degree of the frontier
    live: int                 # |frontier| (the convergence test)
    tiers: tuple              # rounds run per tier (TIERS)


class ColorResult(NamedTuple):
    colors: torch.Tensor      # [V] int32
    iterations: int
    elapsed_ms: float
    tiers: tuple = (0, 0)     # rounds per tier (TIERS)


def default_priorities(n_vertices_padded: int, seed: int = 0) -> torch.Tensor:
    """[WAVES, Vp] int32 on the CPU: WAVES ``torch.randperm`` of a
    generator seeded from ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    return torch.stack([torch.randperm(n_vertices_padded, generator=gen)
                        for _ in range(WAVES)]).int()


def init(g: Graph, seed: int = 0, pris=None) -> ColorState:
    """The JP state: ``pris`` ([WAVES, Vp] int32, NumPy or tensor; by
    default ``default_priorities(Vp, seed)``) and its per-edge copy in CSC
    order, two ``gather_payloads`` launches."""
    vp = g.n_vertices_padded
    if pris is None:
        pris = default_priorities(vp, seed)
    elif not isinstance(pris, torch.Tensor):
        pris = torch.from_numpy(np.array(pris, dtype=np.int32))
    throw_if(tuple(pris.shape) != (WAVES, vp),
             f"color: pris must be [{WAVES}, {vp}]")
    pris = pris.to(device=g.device, dtype=torch.int32).contiguous()
    pri_csc = torch.stack(gather(g.csc_src_indices, *pris))
    fidx = torch.full((SA.spray_k(g),), g.pad_vertex, dtype=torch.int32,
                      device=g.device)
    return ColorState(torch.full((vp,), -1, dtype=torch.int32,
                                 device=g.device),
                      pris, pri_csc, full_frontier(g), fidx, g.n_vertices,
                      False, 0, g.n_vertices, (0, 0))


def _finish(state: ColorState, it: int, minmax_per_wave):
    """Colors for every wave's (max, min) test: wave j of round ``it`` uses
    colors 2(it WAVES + j) and 2(it WAVES + j) + 1. Returns (colors, the
    vertices still uncolored)."""
    nc, frontier = state.colors, state.frontier
    newly = torch.zeros_like(frontier)
    for j, (nbr_max, nbr_min) in enumerate(minmax_per_wave):
        p = state.pris[j]
        is_max = frontier & ~newly & (p > nbr_max)
        is_min = frontier & ~newly & (p < nbr_min) & ~is_max
        base = 2 * (it * WAVES + j)
        nc = torch.where(is_max, base, nc)
        nc = torch.where(is_min, base + 1, nc)
        newly = newly | is_max | is_min
    return nc, frontier & ~newly


def _dense_sweep(g: Graph, state: ColorState) -> list:
    """One gather of the uncolored mask into CSC order, then every wave's
    in-neighbour MAX and MIN over it in one ``segment_minmax`` launch."""
    active, _ = _expand_and_route(g, state.frontier, AdvanceIO.VERTICES, ())
    return combine_minmax_multi(list(state.pri_csc), active, g.csc_offsets)


def _spray_sweep(g: Graph, state: ColorState) -> list:
    """The same MAX and MIN over the uncolored set's out-edges only: each
    slot's source priority is gathered through ``spray_sources`` and
    scattered to its destination."""
    budget, vp = SA.SPRAY_BUDGET, g.n_vertices_padded
    offs, deg = SA.frontier_out_degree(g, state.fidx)
    _, nb, valid, pfx = SA.spray_candidates(g, state.fidx, offs, deg, budget)
    src = SA.spray_sources(state.fidx, pfx, budget)
    pri_e = torch.stack(gather(src, *state.pris))         # [WAVES, budget]
    idx = nb.long().expand(WAVES, -1)
    mx = torch.full((WAVES, vp), -IMAX - 1, dtype=torch.int32,
                    device=g.device)
    mn = torch.full_like(mx, IMAX)
    mx.scatter_reduce_(1, idx, torch.where(valid, pri_e, -IMAX - 1), "amax")
    mn.scatter_reduce_(1, idx, torch.where(valid, pri_e, IMAX), "amin")
    return list(zip(mx, mn))


def _take_spray(g: Graph, state) -> bool:
    return (SA.spray_enabled(g) and state.fvalid
            and state.degsum <= SA.SPRAY_BUDGET)


def step(g: Graph, state: ColorState, it: int) -> ColorState:
    """One JP round: the spray when the index list is current and its
    out-degree fits SPRAY_BUDGET, else the dense sweep."""
    spray = _take_spray(g, state)
    nc, nf = _finish(state, it,
                     _spray_sweep(g, state) if spray
                     else _dense_sweep(g, state))
    tiers = (state.tiers[0] + spray, state.tiers[1] + (not spray))
    if not SA.spray_enabled(g):
        live = SA.read_control(g, nf, None)[0]
        return state._replace(colors=nc, frontier=nf, live=live, tiers=tiers)
    pad = g.pad_vertex
    if spray:
        # the uncolored set shrinks: filter the index list it sprayed (O(K))
        keep = nf[state.fidx.long()] & (state.fidx != pad)
        fi2 = torch.sort(torch.where(keep, state.fidx, SA._BIG)).values
        fi2 = torch.where(fi2 < SA._BIG, fi2, pad)
        cnt = keep.sum(dtype=torch.int32)
    else:
        # the same list as the JAX package's filter where fvalid held: the
        # list was then the whole uncolored set
        cnt = nf.sum(dtype=torch.int32)
        fi2 = SA.compact_if_fits(g, nf, cnt)
    live, degsum, fcount = SA.read_control(g, nf, cnt)
    return ColorState(nc, state.pris, state.pri_csc, nf, fi2, fcount,
                      fcount <= SA.spray_k(g), degsum, live, tiers)


# ------------------------------------------------------------------ spec --

class SpecState(NamedTuple):
    colors: torch.Tensor      # int32[Vp] current speculative colors
    frontier: torch.Tensor    # bool[Vp] recolored last round
    fidx: torch.Tensor        # int32[K] the frontier when fvalid
    fcount: int
    fvalid: bool
    degsum: int
    live: int
    tiers: tuple


def _mulmod32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2^32 for int64 x in [0, 2^32) and 0 <= c < 2^32, by 16-bit
    halves so that no product leaves int64."""
    return ((((x >> 16) * c & _M32) << 16) + (x & 0xFFFF) * c) & _M32


def _hash_color(v: torch.Tensor, deg: torch.Tensor, it: int,
                seed: int) -> torch.Tensor:
    """The JAX package's avalanching uint32 hash of (v, it, seed), in
    [0, deg]; int32."""
    x = _mulmod32(v.long() & _M32, 2654435761)
    salt = ((seed * 0x9E3779B9 & _M32)
            + ((it & _M32) * 0x85EBCA6B & _M32)) & _M32
    x = x ^ salt
    x = _mulmod32(x ^ (x >> 16), 0x45D9F3B)
    x = x ^ (x >> 16)
    return (x % ((deg.long() & _M32) + 1)).int()


def _degrees(g: Graph) -> torch.Tensor:
    return torch.where(g.vertex_mask(), g.out_degrees(), 0).int()


def init_spec(g: Graph, seed: int = 0) -> SpecState:
    vp = g.n_vertices_padded
    v = torch.arange(vp, dtype=torch.int32, device=g.device)
    colors = torch.where(g.vertex_mask(),
                         _hash_color(v, _degrees(g), 0, seed), -1)
    fidx = torch.full((SA.spray_k(g),), g.pad_vertex, dtype=torch.int32,
                      device=g.device)
    return SpecState(colors, full_frontier(g), fidx, g.n_vertices, False, 0,
                     g.n_vertices, (0, 0))


def _spec_dense(g: Graph, colors, rank) -> torch.Tensor:
    """conflicted[d]: an in-edge (s -> d) with the same color whose source
    keeps it (the lower rank), by ``advance`` with a MAX combine."""
    def msg(e):
        return ((e.src_vals[0] == e.dst_vals[0])
                & (e.src_vals[1] < e.dst_vals[1])).int()

    c = advance(g, msg, None, src_values=(colors, rank),
                dst_values=(colors, rank), input_kind=AdvanceIO.GRAPH,
                combine=Combine.MAX, with_frontier=False)
    return (c > 0) & g.vertex_mask()


def _spec_spray(g: Graph, state: SpecState, rank) -> torch.Tensor:
    """Conflicts only involve a vertex recolored last round: spray its
    out-edges and mark the higher-rank endpoint of every same-color pair
    (the source through ``spray_sources``, the destination through the
    candidates)."""
    budget, colors = SA.SPRAY_BUDGET, state.colors
    offs, deg = SA.frontier_out_degree(g, state.fidx)
    _, nb, valid, pfx = SA.spray_candidates(g, state.fidx, offs, deg, budget)
    src = SA.spray_sources(state.fidx, pfx, budget)
    nbl, srcl = nb.long(), src.long()
    same = valid & (colors[srcl] == colors[nbl]) & (nb != src)
    s_keeps = rank[srcl] < rank[nbl]
    hit = torch.zeros(g.n_vertices_padded, dtype=torch.bool, device=g.device)
    hit[nbl[same & s_keeps]] = True
    hit[srcl[same & ~s_keeps]] = True
    return hit & g.vertex_mask()


def step_spec(g: Graph, state: SpecState, it: int,
              seed: int = 0) -> SpecState:
    """One speculative round: find the conflicts (spray or dense), rehash
    their higher-rank endpoints with round ``it + 1``."""
    vp = g.n_vertices_padded
    deg = _degrees(g)
    v = torch.arange(vp, dtype=torch.int32, device=g.device)
    # rank = (deg, id): hubs keep their colors, leaves rehash (int32 wrap)
    rank = kernels._wrap_i32(deg.long() * (vp + 1) + v)
    spray = _take_spray(g, state)
    conflicted = (_spec_spray(g, state, rank) if spray
                  else _spec_dense(g, state.colors, rank))
    nc = torch.where(conflicted, _hash_color(v, deg, it + 1, seed),
                     state.colors)
    tiers = (state.tiers[0] + spray, state.tiers[1] + (not spray))
    if SA.spray_enabled(g):
        fc = conflicted.sum(dtype=torch.int32)
        nidx = SA.compact_if_fits(g, conflicted, fc)
    else:
        fc, nidx = None, state.fidx
    live, degsum, fcount = SA.read_control(g, conflicted, fc)
    return SpecState(nc, conflicted, nidx, fcount,
                     SA.spray_enabled(g) and fcount <= SA.spray_k(g),
                     degsum, live, tiers)


def auto_variant(g: Graph) -> str:
    """'spec' where the spray is on (JP's round count times an O(E) dense
    sweep is what explodes there), else 'jp' (fewer colors)."""
    return "spec" if SA.spray_enabled(g) else "jp"


def run(g: Graph, *, seed: int = 0, max_iterations: int | None = None,
        warmup: bool = True, variant: str = "auto",
        pris=None) -> ColorResult:
    """Color ``g`` on its device. variant: 'jp' (Jones-Plassmann with WAVES
    waves, the reference's formulation), 'spec' (speculative recolor: about
    log-many rounds, more colors) or 'auto' (``auto_variant``). ``pris``
    replaces JP's default priorities (see ``init``). ``elapsed_ms`` covers
    the rounds, on the device's clock (CUDA events) or the host's (CPU)."""
    max_it = max_iterations if max_iterations is not None \
        else g.n_vertices + 1
    if variant == "auto":
        variant = auto_variant(g)
    throw_if(variant not in VARIANTS, f"unknown color variant {variant!r}")
    throw_if(not g.has_csc, "color needs the CSC view")
    if variant == "spec":
        throw_if(pris is not None, "color: pris are JP's priorities")
        res = enact(step_spec, default_converged, g, init_spec(g, seed),
                    max_iterations=max_it, warmup=warmup)
    else:
        res = enact(step, default_converged, g, init(g, seed, pris),
                    max_iterations=max_it, warmup=warmup)
    return ColorResult(res.state.colors[:g.n_vertices], res.iterations,
                       res.elapsed_ms, res.state.tiers)


def validate(csr, colors) -> int:
    """Conflicting edges (endpoints sharing a color) plus uncolored
    vertices (reference parity: examples/algorithms/color validation)."""
    colors = np.asarray(colors)
    off = np.asarray(csr.row_offsets)
    cols = np.asarray(csr.col_indices)
    src = np.repeat(np.arange(csr.n_rows), np.diff(off))
    conflicts = int(np.sum((colors[src] == colors[cols]) & (src != cols)))
    return conflicts + int(np.sum(colors < 0))
