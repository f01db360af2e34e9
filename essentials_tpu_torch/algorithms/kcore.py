"""k-core decomposition by peeling waves.

Counterpart of ``essentials_tpu/algorithms/kcore.py`` for the variants
``fused`` (edge-axis waves, ``ops/fused_kcore.py``) and ``adaptive``
(vertex-axis waves on the operator layer); reference parity: gunrock
``kcore.hxx:148-199``. A vertex's core number is k - 1 for the level k at
which it is peeled; levels at which nothing can peel are jumped.

``adaptive`` runs on any graph, on the host's loop (``framework.enactor``).
Each wave peels every alive vertex of remaining degree below k and takes
one of four branches, as the JAX package's ``lax.switch``: a skip (nothing
peels: k jumps to the smallest alive degree + 1), the tiny spray, the
spray (the peeled vertices' out-edges enumerated into a budget of slots,
their targets' degrees lowered by an ``index_add_``) or the dense wave
(the ``advance_count`` kernel). A spray wave keeps its touched neighbours
as the next wave's candidate list, which is a superset of the next peel
set within one k. The JAX package's two toggles that default off,
``_KJUMP_FOLD`` and ``_TINY_CASCADE``, are not carried: no entry point
sets them.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.framework.enactor import enact
from essentials_tpu_torch.graph.graph import Graph
from essentials_tpu_torch.ops import fused_kcore as FK
from essentials_tpu_torch.ops import sparse_advance as SA
from essentials_tpu_torch.ops.advance import advance_count
from essentials_tpu_torch.runtime import span, spanned
from essentials_tpu_torch.utils.timer import Timer

VARIANTS = ("fused", "adaptive")
TIERS = ("skip", "tiny spray", "spray", "dense")
IMAX = FK.IMAX


class KcoreResult(NamedTuple):
    core: torch.Tensor           # [V] int32
    iterations: int              # peel waves
    elapsed_ms: float
    tiers: tuple = (0, 0, 0, 0)  # adaptive waves per branch (TIERS)
    compactions: int = 0         # adaptive spray waves without a list


class KcoreState(NamedTuple):
    """The adaptive peeling state. fidx is the candidate list of the next
    wave, a superset of its peel set when ``fvalid`` (a device bool, read
    with the wave's other host values). live, tiers, compactions and
    peel_k are host values."""
    core: torch.Tensor      # int32[Vp] assigned core numbers
    degrees: torch.Tensor   # int32[Vp] remaining degree
    alive: torch.Tensor     # bool[Vp]
    k: int                  # current peeling level
    fidx: torch.Tensor      # int32[SPRAY_K] candidate list
    fvalid: torch.Tensor    # bool [] fidx holds every next peel
    live: int               # alive vertices after the wave
    tiers: tuple            # waves run per branch (TIERS)
    compactions: int        # spray waves that compacted the peel set
    peel_k: int = 0         # the level of the last wave that peeled


def init(g: Graph) -> KcoreState:
    mask = g.vertex_mask()
    deg = torch.where(mask, g.out_degrees(), 0).int()
    return KcoreState(torch.zeros(g.n_vertices_padded, dtype=torch.int32,
                                  device=g.device), deg, mask, 1,
                      torch.full((SA.SPRAY_K,), g.pad_vertex,
                                 dtype=torch.int32, device=g.device),
                      torch.zeros((), dtype=torch.bool, device=g.device),
                      g.n_vertices, (0, 0, 0, 0), 0)


def read_wave(g: Graph, state: KcoreState, peel: torch.Tensor) -> tuple:
    """The wave's host values in one transfer: (peeled count, the peeled
    vertices' ORIGINAL out-degree sum, the candidate list's tail past
    TINY_K all pad, the smallest alive degree (the k jump), alive count,
    fvalid)."""
    pad_ok = (state.fidx[SA.TINY_K:] == g.pad_vertex).all()
    vals = torch.stack([
        peel.sum(dtype=torch.int64),
        torch.where(peel, g.out_degrees(), 0).sum(dtype=torch.int64),
        pad_ok.long(),
        torch.where(state.alive, state.degrees, IMAX).min().long(),
        state.alive.sum(dtype=torch.int64), state.fvalid.long()])
    cnt, sumdeg, pad_ok, min_deg, n_alive, fvalid = vals.tolist()
    return cnt, sumdeg, bool(pad_ok), min_deg, n_alive, bool(fvalid)


def branch_of(cnt: int, sumdeg: int, pad_ok: bool, fvalid: bool,
              use_spray: bool) -> int:
    """The wave's branch (TIERS), as the JAX package's switch: skip when
    nothing peels; the tiny spray when the candidate list is current and
    fits TINY_K, the peel set holds at most TINY_K vertices and their
    original out-degrees sum to at most TINY_BUDGET; the spray when at most
    SPRAY_K vertices peel within SPRAY_BUDGET; dense otherwise."""
    if cnt == 0:
        return 0
    if not use_spray:
        return 3
    if fvalid and cnt <= SA.TINY_K and sumdeg <= SA.TINY_BUDGET and pad_ok:
        return 1
    return 2 if cnt <= SA.SPRAY_K and sumdeg <= SA.SPRAY_BUDGET else 3


def _spray_wave(g: Graph, state: KcoreState, peel: torch.Tensor,
                fvalid: bool, budget: int, kk: int) -> tuple:
    """(degrees, next candidate list [SPRAY_K], its fvalid [] bool): the
    peeled vertices (the candidate list filtered, or the peel set
    compacted) spray their out-edges, each lowering its target's degree
    by one."""
    pad = g.pad_vertex
    if fvalid:
        cand = state.fidx[:kk]
        idx = SA.spray_dedup(cand, peel[cand.long()], kk, pad)[1]
    else:
        idx = SA.compact_frontier(peel, kk, pad)
    offs, d0 = SA.frontier_out_degree(g, idx)
    _, nb, valid, _ = SA.spray_candidates(g, idx, offs, d0, budget)
    deg = state.degrees.index_add(0, nb.long(), -valid.int())
    _, nidx, ncnt = SA.spray_dedup(nb, valid, kk, pad)
    return deg, SA.pad_index_list(g, nidx, SA.SPRAY_K), ncnt <= kk


@spanned("kcore.wave")
def step(g: Graph, state: KcoreState, it: int,
         spray_override: bool | None = None) -> KcoreState:
    """One peeling wave (JAX ``kcore.step`` at its default toggles)."""
    k = state.k
    peel = state.alive & (state.degrees < k)
    with span("kcore.wave.read"):
        cnt, sumdeg, pad_ok, min_deg, n_alive, fvalid = read_wave(g, state,
                                                                  peel)
    FK.count_wave(cnt, cnt > 0 and k != state.peel_k)
    use_spray = (SA.spray_enabled(g) if spray_override is None
                 else spray_override)
    branch = branch_of(cnt, sumdeg, pad_ok, fvalid, use_spray)
    core = torch.where(peel, k - 1, state.core)
    alive = state.alive & ~peel
    fidx = torch.full_like(state.fidx, g.pad_vertex)
    fv = torch.zeros_like(state.fvalid)
    deg = state.degrees
    compactions = state.compactions
    if branch == 3:
        deg = deg - advance_count(g, peel)
    elif branch in (1, 2):
        budget, kk = ((SA.TINY_BUDGET, SA.TINY_K) if branch == 1
                      else (SA.SPRAY_BUDGET, SA.SPRAY_K))
        deg, fidx, fv = _spray_wave(g, state, peel, fvalid, budget, kk)
        compactions += not fvalid
    else:
        k = max(k + 1, min_deg + 1)       # nothing peels: jump k
    tiers = tuple(n + (i == branch) for i, n in enumerate(state.tiers))
    return KcoreState(core, deg, alive, k, fidx, fv, n_alive - cnt, tiers,
                      compactions, state.k if cnt else state.peel_k)


def converged(g: Graph, state: KcoreState, it: int) -> bool:
    return state.live == 0


def fused_supported(g: Graph) -> bool:
    """The edge-axis wave needs the symmetric layout: each in-neighbour's
    degree sits at the start of its own segment, and a vertex's CSR row
    lies at the positions of its segment, so that its push along the CSR
    columns reaches the vertices whose pull counts it (directed graphs
    with in-degree equal to out-degree included)."""
    return bool(g.symmetric_layout)


@spanned("kcore.run")
def run(g: Graph, *, max_iterations: int | None = None, warmup: bool = True,
        variant: str = "auto", spray_override: bool | None = None
        ) -> KcoreResult:
    """Core numbers of every vertex on ``g``'s device. variant: 'fused'
    (needs a symmetric layout), 'adaptive', or 'auto', which is 'fused'
    where it is supported and 'adaptive' elsewhere, as the JAX package's.
    ``spray_override`` forces the adaptive waves' spray branches on or off
    whatever the graph's size. ``elapsed_ms`` covers the waves (and, for
    'fused', the collapse), on the device's clock (CUDA events) or the
    host's (CPU).

    Under a torch.profiler the call is the span ``kcore.run``, each wave a
    ``kcore.wave`` (``adaptive``'s decorated ``step``) holding its
    kernels' ``kernel.*`` spans and its host read ``kcore.wave.read``
    (``runtime.span``); ``kernels.counters`` counts the waves
    (``kcore.waves``), the vertices they peeled (``kcore.peeled``) and the
    levels k peeled at (``kcore.levels``), by ``fused_kcore.count_wave``."""
    if variant == "auto":
        variant = "fused" if fused_supported(g) else "adaptive"
    throw_if(variant not in VARIANTS, f"unknown kcore variant {variant!r}")
    throw_if(variant == "fused" and not fused_supported(g),
             "kcore variant 'fused' needs a graph with a symmetric layout; "
             "use 'adaptive' or 'auto'")
    max_it = (max_iterations if max_iterations is not None
              else 4 * g.n_vertices + 8)

    if variant == "adaptive":
        res = enact(lambda g_, st, it: step(g_, st, it, spray_override),
                    converged, g, init(g), max_iterations=max_it,
                    warmup=warmup)
        st = res.state
        return KcoreResult(st.core[:g.n_vertices], res.iterations,
                           res.elapsed_ms, st.tiers, st.compactions)
    if warmup:
        FK.run_fused_kcore(g, max_it)
    timer = Timer(g.device).begin()
    core, it = FK.run_fused_kcore(g, max_it)
    elapsed = timer.end()
    return KcoreResult(core[:g.n_vertices], it, elapsed)


def cpu_reference(csr) -> np.ndarray:
    """Host peeling (Matula-Beck style), vectorised over NumPy arrays: at
    each level k, every alive vertex of remaining degree below k is peeled
    at once (core k - 1) and each of its out-edges takes one from its
    target's degree, until none is left below k; a level where nothing
    peels is jumped to the smallest alive degree + 1. The same waves as the
    JAX package's edge-by-edge loop."""
    n = csr.n_rows
    off = np.asarray(csr.row_offsets, np.int64)
    cols = np.asarray(csr.col_indices, np.int64)
    deg = np.diff(off)
    alive = np.ones(n, bool)
    core = np.zeros(n, np.int32)
    k = 1
    while alive.any():
        peel = alive & (deg < k)
        if not peel.any():
            k = int(deg[alive].min()) + 1
            continue
        core[peel] = k - 1
        alive &= ~peel
        u = np.nonzero(peel)[0]
        starts, lens = off[u], off[u + 1] - off[u]
        # positions of every out-edge of the peeled vertices
        pos = (np.repeat(starts - np.cumsum(lens) + lens, lens)
               + np.arange(int(lens.sum()), dtype=np.int64))
        deg -= np.bincount(cols[pos], minlength=n)
    return core
