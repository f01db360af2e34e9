"""The port's CUDA kernels: build, binding, wrappers, plain versions.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library with a
plain C interface, at first use, into ``build/essentials_tpu_torch/`` beside
the package. The library's name carries a hash of the sources and flags, so
an edited source builds anew. It is loaded with ``ctypes``.

The kernels and the TPU kernels they replace (``essentials_tpu/ops/``):

* ``csrc/bfs_kernels.cu`` (the fused BFS path): ``bfs_level`` (int32 and
  int8) for ``fused_bfs.fused_superstep2`` :502, a pass over the vertices
  that packs the frontier and the unreached vertices into bitmaps, then a
  push from the frontier's CSR rows or a pull into the unreached vertices
  over ``csc_src``, chosen on the card from the pass's sums
  (``bfs_level_pulls``, or forced by ``bfs_level_form``);
  ``collapse_levels`` for the
  ``cube_router._pallas_apply`` route :385 and "first" fill of the collapse,
  several segment starts a thread (``csrc/segment_starts.cuh``, shared with
  ``collapse_starts``);
  ``bfs_predecessors`` for the ``cube_router.apply_cube_chain`` :586 advance:
  a walk to each vertex's first qualifying in-edge over at most the first
  ``PRED_SPLIT`` slots, then a range walk that spreads the rest of the long
  segments without a hit over many warps (``csrc/first_hit.cuh``, shared
  with ``sssp_predecessors``).
* ``csrc/spmv_kernels.cu`` (SpMV, PageRank and HITS): ``spmv_rows`` (``mul``
  and ``none`` messages), one block per tile of ``ROW_TILE`` places of the
  merged sequence of row ends and edges (a merge-path partition), a row
  that crosses tiles completed from the partials the tiles before it
  publish, for the 7-kernel chain ``fused_spmv._pallas_spmv_chain`` :179;
  ``spmv_slabs`` (messages ``mul``, ``add``, ``none`` by reductions
  ``sum``, ``min``), one block per slab of ``SLAB_EDGES`` edges in one
  launch, a row that crosses slabs completed by
  a hand-off from slab to slab in slab order, for
  ``windowed_spmv.windowed_pipeline`` :454. It is bound by the bytes it
  streams and the scattered x gathers.
* ``csrc/sssp_kcore_kernels.cu`` (SSSP and k-core): ``sssp_sweep`` for
  ``fused_sssp.fused_sssp_superstep`` :132, a dense pass over the vertices
  and a push along the CSR rows of those whose distance changed in the
  sweep before (only they can lower a distance) into a [Vp] copy of the
  distances, then an update of the starts; ``sssp_predecessors`` for
  the MIN advance of ``sssp.predecessors_from_distances`` (the two walks
  of ``bfs_predecessors``); ``kcore_level_wave`` and
  ``kcore_cascade_wave`` for ``fused_kcore.fused_kcore_sweep`` :144, the
  state updated in place: the first wave of a level finds k on the card
  and marks its peel set in passes over the vertices, a cascade marks the
  candidate list the wave before gave, and both push along the rows of the
  vertices they peel (each edge read in the wave that peels its vertex),
  listing the survivors that fall below k as the next wave's peel set; the
  pushes walk ranges of ``PUSH_SPLIT`` slots; ``collapse_starts`` for the routed
  collapses ``collapse_dist_exp`` and ``collapse_core_exp``, several
  segment starts a thread, their gathers in flight together
  (``csrc/segment_starts.cuh``); ``expand_segments`` for the expansion of
  k-core's ``init_deg_exp`` (``segment.expand_vertex_to_edges``, whose
  cumsum is ``scan_kernels.scan_1d`` :274), one launch over tiles of
  ``EXPAND_TILE`` places of the merged segment ends and slots, each tile
  finding its own split. The SSSP sweep reads one state buffer and writes
  another.
* ``csrc/bfs_kernels.cu`` also holds the segment fills of ``fused_bfs.py``:
  ``segment_broadcast_total`` for ``fused_bfs.segment_broadcast_total``
  :262 (PageRank ``fused``) and ``suffix_fill_update`` for
  ``fused_bfs.suffix_fill_update`` :137, one launch over tiles of
  ``FILL_TILE`` positions whose carry comes from the segment ends the tiles
  after them publish (a look-forward).
* ``csrc/tc_kernels.cu`` (triangle counting and the intersection operator):
  ``bitmap_intersect_counts`` for ``bitmap_intersect.bitmap_intersect_counts``
  :118: a warp per 32 pairs, grouped by u in any order; each group lists
  B[u]'s non-zero words once and reads only those words of each B[v].
* ``csrc/operator_kernels.cu`` (the operator layer: advance,
  neighbor_reduce, the spray tiers): ``scan`` for ``scan_kernels.scan_1d``
  :274 and ``segmented_scan_1d`` :296, one launch over tiles of
  ``SCAN_TILE`` elements whose carry comes from the aggregates the tiles
  before them publish (a look-back); ``fused_route_or`` for
  ``fused_bfs.fused_route_or`` :603, the same tile scan (int32 max of 0/1
  values) whose load gathers ``lev`` through the edge ids and compares;
  ``gather_payloads`` for the
  permutation routes (``cube_router._pallas_apply`` :385,
  ``apply_cube_chain`` :586, ``permute._pallas_rowgather`` :364), four
  slots per thread, 2-4 payloads packed into 8- or 16-byte records by a
  first pass where the slots outnumber the records (``gather_packs``);
  ``segment_reduce`` for ``segment.combine_by_offsets`` :97 and its routed
  form :287, and ``segment_minmax`` for ``scan_kernels.segmented_minmax_1d``
  :224 with the routed pick of ``segment.combine_minmax_multi`` :351: both
  one launch over tiles of ``REDUCE_TILE`` and ``MINMAX_TILE`` places of
  the merged segment ends and slots, after a launch that finds the tiles'
  splits, a segment across tiles completed from the partials the tiles
  before it publish;
  ``advance_count`` for ``advance.advance_count`` :175
  (``cube_router.apply_cube_chain_n`` :754): chunks of ``ADVANCE_CHUNK``
  CSC slots per block, the frontier packed to bits and, in its "shared"
  tier, held in shared memory; bound by the bytes of ``csc_src``.

Each kernel has a wrapper and a plain PyTorch version with the same
arithmetic. The wrapper dispatches on the device of the tensors it is given:
a CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
and anything the kernel does not take raises. There is no fallback from the
kernel to the plain version. ``launches`` counts each kernel's launches,
keyed by kernel (and, for the BFS kernels, element type); the plain versions
count nothing. ``counters`` holds the program's other counts (the form of
each ``bfs_level`` on the card and its slots, the SSSP sweeps' work, the
k-core waves, their peeled vertices and their levels).
Under a torch.profiler each wrapper call is the span ``kernel.<name>``
(``runtime.span``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.runtime import spanned

INT32_MAX = 2**31 - 1
INF_BITS = 0x7F800000          # float32 +inf as int32 bits: the min identity
SLAB_EDGES = 4096              # edges per spmv_slabs block (kSlab in the .cu)
SLAB_ITEMS = 16                # consecutive edges per spmv_slabs thread (kItems)
ROW_ITEMS = 8                  # merge places per spmv_rows thread (kRowItems)
ROW_TILE = 2048                # merge places per spmv_rows block (kRowTile)
ADVANCE_CHUNK = 16384          # CSC slots per advance_count chunk (kCountChunk)
MESSAGES = ("mul", "add", "none")
REDUCES = ("sum", "min")
SCAN_OPS = ("add", "min", "max", "first")          # codes 0-3 in the .cu
REDUCE_OPS = ("sum", "min", "max", "or", "and")    # codes 0-4 in the .cu
SCAN_TILE = 2048               # elements per scan tile (kScanTile)
SCAN_GROUP = 256               # scan tiles per group word (kScanGroup)
FILL_TILE = 4096               # positions per fill tile (kFillTile)
MINMAX_TILE = 2048             # merge places per segment_minmax tile (kMmTile)
REDUCE_TILE = 4096             # merge places per segment_reduce tile (kRdTile)
# merge places per expand_segments tile (kExpandTile). Measured by
# chip_ab.py's starts group (NVIDIA H100 80GB HBM3, 700 W): tiles of 2,048
# and 8,192 places took 3-21% more device time at weighted rmat18 and
# gen:rmat20x16
EXPAND_TILE = 4096
PUSH_SPLIT = 32                # slots per range of the push lists
# The predecessor kernels (csrc/first_hit.cuh): the first walk gives each
# reached vertex 8 lanes over at most the first PRED_SPLIT slots of its
# segment and lists the rest of a segment without a hit there as ranges of
# PRED_SPLIT slots, which the range walk spreads over the card, a warp a
# range. Measured by chip_ab.py's pred group (NVIDIA H100 80GB HBM3,
# 700 W): at rmat18 a split of 256 was 3% ahead of 512 for BFS and 10%
# for SSSP, and 1,024 19-37% behind; at gen:rmat20x16 all three were
# within 5% of one another
PRED_SPLIT = 256
BFS_FORMS = ("device", "push", "pull")             # codes 0-2 in the .cu
# bfs_level pulls where the frontier's out-slots m_f times BFS_PULL_ALPHA
# pass the unreached vertices' in-slots m_u and its vertices n_f times
# BFS_PULL_BETA reach Vp (Beamer's direction-optimizing rules, with his
# alpha and beta): the push reads m_f slots, the pull at most m_u, and a
# small frontier is pushed, since the pull's fixed cost is a pass over
# every word of the unreached bitmap
BFS_PULL_ALPHA = 14
BFS_PULL_BETA = 24
BFS_LEVEL_SCALARS = 8          # words before bfs_level's bitmaps (the .cu's)
# gather_payloads packs 2-4 payloads from PACK_MIN_SLOTS slots and from
# one slot per record of the shortest payload. Measured by chip_ab.py's
# sweep (uniform random indices, NVIDIA H100 80GB HBM3, 700 W): at
# L = 2^20 words packing breaks even at n = L/2 and is 16% (2 payloads)
# and 27% (4) faster at n = L, 43% and 65% at n = 16 L; below 2^18 slots
# the pack's own launch costs more than it saves.
PACK_MIN_SLOTS = 1 << 18

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
_HEADERS = tuple(sorted(_CSRC.glob("*.cuh")))
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "essentials_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

launches = {"bfs_level<int32>": 0, "bfs_level<int8>": 0,
            "collapse_levels<int32>": 0, "collapse_levels<int8>": 0,
            "bfs_predecessors": 0,
            "spmv_rows": 0, "spmv_slabs": 0,
            "sssp_sweep": 0, "sssp_predecessors": 0,
            "kcore_level_wave": 0, "kcore_cascade_wave": 0,
            "collapse_starts": 0, "expand_segments": 0,
            "scan": 0, "gather_payloads": 0, "segment_reduce": 0,
            "segment_minmax": 0, "advance_count": 0,
            "bitmap_intersect_counts": 0,
            "segment_broadcast_total": 0, "suffix_fill_update": 0,
            "fused_route_or": 0}

# launches of a wrapper's other device kernels, beside its count in
# ``launches``, by each kernel's name without "_kernel": gather_payloads'
# pack pass (where it packs), sssp_sweep's push and update, the k-core
# level wave's peel and both waves' push, bfs_level's list, push and pull (in every call, the list and the push or
# the pull returning at once), the split of segment_reduce and
# segment_minmax (in every call) and the predecessors' range walks (in
# every call, returning at once where nothing was listed)
pass_launches = {"gather_payloads_pack": 0, "sssp_sweep_push": 0,
                 "sssp_sweep_update": 0, "kcore_level_peel": 0,
                 "kcore_wave_push": 0,
                 "bfs_level_list": 0, "bfs_level_push": 0,
                 "bfs_level_pull": 0, "segment_split": 0,
                 "bfs_predecessors_ranges": 0,
                 "sssp_predecessors_ranges": 0}

# the program's counts beside the launches, by name: the form each
# bfs_level took on the card and the slots that form may read (counted by
# ``bfs_level_count`` from the form the card wrote), the vertices the
# SSSP sweeps relaxed and the ones they improved, the CSR slots the
# sweeps read (``sssp_sweep_count``), and the k-core waves, the vertices
# they peeled and the levels k they peeled at
# (``fused_kcore.count_wave``)
counters = dict.fromkeys(("bfs_level.push", "bfs_level.pull",
                          "bfs_level.push_slots", "bfs_level.pull_slots",
                          "sssp.swept", "sssp.improved", "sssp.push_slots",
                          "kcore.waves", "kcore.peeled", "kcore.levels"), 0)

_lib = None


def reset_launches() -> None:
    """Zero ``launches``, ``pass_launches`` and ``counters``."""
    for counts in (launches, pass_launches, counters):
        for k in counts:
            counts[k] = 0


def _spanned(fn):
    """``fn``, a wrapper counted in ``launches``, inside the span
    ``kernel.<its name>`` (``runtime.span``): its checks, its allocations
    and its launch, or its plain version."""
    return spanned("kernel." + fn.__name__)(fn)


# ---------------------------------------------------------------- build --

def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for src in _SOURCES + _HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libetpu_kernels_{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = [str(Path(CUDA_HOME) / "bin" / "nvcc")] if CUDA_HOME else []
    cand.append(shutil.which("nvcc") or "")
    for path in cand:
        if path and os.access(path, os.X_OK):
            return path
    raise EssentialsError("nvcc not found: the CUDA kernels build only "
                          "where the CUDA toolkit is installed")


def build() -> tuple[Path, str]:
    """Compile the kernels unless a library of the same sources exists.
    Returns (library path, compiler output; empty when nothing was built)."""
    path = library_path()
    if path.exists():
        return path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    objs = [path.with_name(f"{path.stem}.{os.getpid()}.{src.stem}.o")
            for src in _SOURCES]
    t0 = time.perf_counter()
    log = []
    try:
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(_SOURCES, objs)]
        outs = [(src, p.communicate()[0], p.returncode)
                for src, p in zip(_SOURCES, procs)]
        for src, out, rc in outs:
            throw_if(rc != 0, f"nvcc failed on {src.name} ({rc}):\n{out}")
            log.append(out)
        r = subprocess.run([nvcc, *LINK_FLAGS, "-o", str(tmp),
                            *map(str, objs)], capture_output=True, text=True)
        throw_if(r.returncode != 0,
                 f"nvcc link failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, path)           # atomic: a reader sees all or nothing
    return path, (f"built {path.name} from {len(_SOURCES)} sources in "
                  f"{time.perf_counter() - t0:.1f} s\n" + "".join(log))


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        argtypes = {
            "etpu_bfs_level_i32": (p, p, p, p, i, i, i, i, i, i, i, p, p),
            "etpu_bfs_level_i8": (p, p, p, p, i, i, i, i, i, i, i, p, p),
            "etpu_bfs_level_scalars": (),
            "etpu_read_level_scalars": (p, p, i, p),
            "etpu_collapse_levels_i32": (p, p, i, i, i, p, p),
            "etpu_collapse_levels_i8": (p, p, i, i, i, p, p),
            "etpu_bfs_predecessors": (p, p, p, i, i, i, p, p, p),
            "etpu_spmv_rows_mul": (p, p, p, p, i, i, p, p, p),
            "etpu_spmv_rows_none": (p, p, p, p, i, i, p, p, p),
            "etpu_spmv_row_tile": (),
            "etpu_spmv_slab_edges": (),
            "etpu_sssp_sweep": (p, p, p, p, p, i, p, p),
            "etpu_sssp_predecessors": (p, p, p, p, i, i, i, p, p, p),
            "etpu_kcore_level_wave": (p, p, p, p, i, p, p, p),
            "etpu_kcore_cascade_wave": (p, p, p, p, i, i, p, i, p, p, p),
            "etpu_push_split": (),
            "etpu_collapse_starts": (p, p, i, i, i, p, p),
            "etpu_expand_segments": (p, p, i, i, p, p),
            "etpu_expand_tile": (),
            "etpu_scan_i32": (p, p, p, p, ll, i, p),
            "etpu_scan_f32": (p, p, p, p, ll, i, p),
            "etpu_scan_tile": (),
            "etpu_scan_group": (),
            "etpu_gather_payloads": (p, ll, p, p, p, p, p, p, p, p, i, p, i,
                                     p),
            "etpu_segment_reduce_i32": (p, ll, p, i, i, i, p, p, p),
            "etpu_segment_reduce_f32": (p, ll, p, i, i, ctypes.c_float, p, p,
                                        p),
            "etpu_segment_minmax": (p, p, p, p, p, p, p, p, i, p, ll, p, i,
                                    p, p, p, p),
            "etpu_minmax_tile": (),
            "etpu_reduce_tile": (),
            "etpu_advance_count": (p, p, p, i, i, p, i, p, p),
            "etpu_advance_count_chunk": (),
            "etpu_advance_count_shared_bytes": (),
            "etpu_fill_tile": (),
            "etpu_segment_fill": (p, p, i, p, i, p, p, p),
            "etpu_route_or": (p, p, p, i, i, p, p, p),
            "etpu_bitmap_intersect": (p, p, p, i, i, p, p, p),
        }
        for m in MESSAGES:
            for r in REDUCES:
                argtypes[f"etpu_spmv_slabs_{m}_{r}"] = (p, p, p, p, p, i, i,
                                                         p, p, p)
        for name, types in argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = i
        throw_if(lib.etpu_spmv_slab_edges() != SLAB_EDGES,
                 f"spmv_slabs: the library's slab is "
                 f"{lib.etpu_spmv_slab_edges()} edges, SLAB_EDGES is "
                 f"{SLAB_EDGES}")
        throw_if(lib.etpu_spmv_row_tile() != ROW_TILE,
                 f"spmv_rows: the library's tile is "
                 f"{lib.etpu_spmv_row_tile()} places, ROW_TILE is "
                 f"{ROW_TILE}")
        throw_if(lib.etpu_advance_count_chunk() != ADVANCE_CHUNK,
                 f"advance_count: the library's chunk is "
                 f"{lib.etpu_advance_count_chunk()} slots, ADVANCE_CHUNK is "
                 f"{ADVANCE_CHUNK}")
        throw_if(lib.etpu_scan_tile() != SCAN_TILE
                 or lib.etpu_scan_group() != SCAN_GROUP,
                 f"scan: the library's tile is {lib.etpu_scan_tile()} "
                 f"elements and its group {lib.etpu_scan_group()} tiles, "
                 f"SCAN_TILE is {SCAN_TILE} and SCAN_GROUP {SCAN_GROUP}")
        throw_if(lib.etpu_fill_tile() != FILL_TILE,
                 f"segment fills: the library's tile is "
                 f"{lib.etpu_fill_tile()} positions, FILL_TILE is "
                 f"{FILL_TILE}")
        throw_if(lib.etpu_minmax_tile() != MINMAX_TILE,
                 f"segment_minmax: the library's tile is "
                 f"{lib.etpu_minmax_tile()} places, MINMAX_TILE is "
                 f"{MINMAX_TILE}")
        throw_if(lib.etpu_reduce_tile() != REDUCE_TILE,
                 f"segment_reduce: the library's tile is "
                 f"{lib.etpu_reduce_tile()} places, REDUCE_TILE is "
                 f"{REDUCE_TILE}")
        throw_if(lib.etpu_expand_tile() != EXPAND_TILE,
                 f"expand_segments: the library's tile is "
                 f"{lib.etpu_expand_tile()} places, EXPAND_TILE is "
                 f"{EXPAND_TILE}")
        throw_if(lib.etpu_push_split() != PUSH_SPLIT,
                 f"sweeps: the library's push ranges are "
                 f"{lib.etpu_push_split()} slots, PUSH_SPLIT is "
                 f"{PUSH_SPLIT}")
        throw_if(lib.etpu_bfs_level_scalars() != BFS_LEVEL_SCALARS,
                 f"bfs_level: the library's scratch begins with "
                 f"{lib.etpu_bfs_level_scalars()} scalars, BFS_LEVEL_SCALARS "
                 f"is {BFS_LEVEL_SCALARS}")
        _lib = lib
    return _lib


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current CUDA stream (the private call
    that torch's own compiler uses: no Stream object is made)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise on
    a non-zero CUDA status. ``device`` is made the current device only
    where it is not already: the switch costs more host time than a
    launch."""
    fn = getattr(_library(), name)
    if device.index == torch.cuda.current_device():
        err = fn(*args, _stream(device))
    else:
        with torch.cuda.device(device):
            err = fn(*args, _stream(device))
    if err != 0:
        raise EssentialsError(f"{name}: CUDA error {err}")


def _check(name: str, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        if t.device != device:
            raise EssentialsError(f"{name}: {arg} is on {t.device}, "
                                  f"expected {device}")
        if not t.is_contiguous():
            raise EssentialsError(f"{name}: {arg} must be contiguous")


def _route(name: str, t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cpu":
        return False
    throw_if(t.device.type != "cuda",
             f"{name}: no kernel for device {t.device}")
    return True


def _check_graph(name: str, ep: int, offsets, csc_src=None,
                 arg: str = "csc_src") -> None:
    throw_if(offsets.dtype != torch.int32 or offsets.dim() != 1,
             f"{name}: offsets must be [Vp+1] int32")
    throw_if(csc_src is not None and (csc_src.dtype != torch.int32
                                      or csc_src.shape != (ep,)),
             f"{name}: {arg} must be [Ep] int32")


def _segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int64: the segment (vertex) that owns each position."""
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=offsets.device), counts,
        output_size=n)


# ------------------------------------------------------------ bfs_level --

def bfs_level_plain(lev, offsets, csc_src, col, it: int, unreached: int):
    """Plain version of ``bfs_level`` (same contract, same in-place write):
    the pull over ``csc_src``, the definition; ``col`` is only the
    kernel's."""
    nonempty = offsets[1:] > offsets[:-1]
    starts = torch.where(nonempty, offsets[:-1], 0).long()
    lev_v = torch.where(nonempty, lev[starts].int(), unreached)
    hit = torch.zeros(lev_v.numel(), dtype=torch.int32, device=lev.device)
    hit.index_add_(0, _segment_ids(offsets, lev.numel()),
                   (lev_v[csc_src.long()] == it).int())
    newly = nonempty & (lev_v == unreached) & (hit > 0)
    lev[starts[newly]] = it + 1
    return newly.sum(dtype=torch.int32).reshape(1)


def bfs_level_form() -> str:
    """The form every ``bfs_level`` launch takes, one of BFS_FORMS:
    "device", the card's choice per level from the pass's sums
    (``bfs_level_pulls``), or "push" or "pull" throughout. Tests and
    chip_smoke bind it to a constant to force a form (chip_smoke.bfs_form);
    the result is the same in every form."""
    return "device"


def bfs_level_pulls(m_f: int, m_u: int, n_f: int, vp: int) -> bool:
    """The card's choice under form "device": pull where the frontier's
    out-slots ``m_f`` times BFS_PULL_ALPHA pass the unreached vertices'
    in-slots ``m_u`` and its ``n_f`` vertices times BFS_PULL_BETA reach
    ``vp``, else push."""
    return m_f * BFS_PULL_ALPHA > m_u and n_f * BFS_PULL_BETA >= vp


_level_host = None


def _level_words() -> tuple:
    """The pinned host words that ``bfs_level_count``,
    ``sssp_sweep_count`` and ``kcore_wave_read`` read into, made at the first such call on the
    card, and their ctypes view; one read at a time."""
    global _level_host
    if _level_host is None:
        host = torch.empty(6, dtype=torch.int32, pin_memory=True)
        _level_host = host, (ctypes.c_int * 6).from_address(host.data_ptr())
    return _level_host


def bfs_level_count(cnt: torch.Tensor) -> int:
    """The vertices a ``bfs_level`` call reached, read to the host from its
    count ``cnt``: the level's one wait on the device. On the kernel's
    route one copy into pinned memory (a C call: ``.item()``'s transfer
    without its dispatch) brings the words that follow the count in the
    call's scratch (0-5: the count, the ranges listed, m_f, m_u, n_f, the
    form the card took, 1 push or 2 pull as in BFS_FORMS), and ``counters``
    takes that form: ``bfs_level.push`` with m_f in ``.push_slots``, or
    ``bfs_level.pull`` with m_u in ``.pull_slots``. The plain version's
    count is read alone."""
    if not _route("bfs_level", cnt):
        return int(cnt.item())
    host, words = _level_words()
    _launch("etpu_read_level_scalars", cnt.device, host.data_ptr(),
            cnt.data_ptr(), 6)
    reached, _, m_f, m_u, _, form = words
    pulls = BFS_FORMS[form] == "pull"
    tag = "bfs_level.pull" if pulls else "bfs_level.push"
    counters[tag] += 1
    counters[tag + "_slots"] += m_u if pulls else m_f
    return reached


def bitmap_words(vp: int) -> int:
    """32-bit words of a packed [vp] bitmap in whole 16-byte words (the
    frontiers of ``advance_count`` and ``bfs_level``)."""
    return 4 * -(-vp // 128)


@_spanned
def bfs_level(lev: torch.Tensor, offsets: torch.Tensor,
              csc_src: torch.Tensor, col: torch.Tensor, it: int,
              unreached: int,
              max_shared_bytes: int | None = None) -> torch.Tensor:
    """One BFS level on the edge axis of a symmetric-layout graph.

    ``lev`` ([Ep] int32 or int8) holds each segment's level at its start
    position ``offsets[v]``; other positions are neither read nor written.
    Every vertex whose start holds ``unreached`` and that has an in-neighbour
    at level ``it`` gets ``it + 1``, IN PLACE. Returns the number of vertices
    reached, int32 [1], on ``lev``'s device.

    The plain version pulls over ``csc_src`` ([Ep] int32, the source of each
    CSC slot). The kernel is four device launches: a pass over the vertices
    (counted in ``launches``) that packs the frontier and the unreached
    vertices into bitmaps and sums them, then a list of the frontier's CSR
    rows and a push along them (``col``, [Ep] int32: on a symmetric layout
    a vertex's row lies at its segment, and its columns are the vertices
    whose pull finds it, directed or not), and a pull into the unreached
    vertices; the kernels of one form return at once (``pass_launches``):
    the card chooses by ``bfs_level_pulls`` unless ``bfs_level_form``
    forces one.
    The pull holds the frontier's bits in shared memory where
    ``advance_count_tier`` says "shared" (under ``max_shared_bytes`` when
    given; 0 forces "global")."""
    name = f"bfs_level<{'int8' if lev.dtype == torch.int8 else 'int32'}>"
    throw_if(lev.dtype not in (torch.int8, torch.int32) or lev.dim() != 1,
             f"{name}: lev must be [Ep] int8 or int32")
    throw_if(not (0 <= it and it + 1 < unreached
                  <= torch.iinfo(lev.dtype).max),
             f"{name}: need 0 <= it and it + 1 < unreached <= dtype max")
    ep = lev.numel()
    _check_graph(name, ep, offsets, csc_src)
    _check_graph(name, ep, offsets, col, "col")
    form = bfs_level_form()
    throw_if(form not in BFS_FORMS, f"{name}: form must be one of {BFS_FORMS}")
    if not _route(name, lev):
        return bfs_level_plain(lev, offsets, csc_src, col, it, unreached)
    dev = lev.device
    _check(name, dev, lev=lev, offsets=offsets, csc_src=csc_src, col=col)
    vp = offsets.numel() - 1
    shared = advance_count_tier(vp, dev, max_shared_bytes) == "shared"
    # the scalars (the count first), the frontier's and the unreached
    # vertices' bitmaps, then room for the listed ranges (int4) where the
    # push may run
    buf = torch.empty(BFS_LEVEL_SCALARS + 2 * bitmap_words(vp) + (
        4 * push_ranges(vp, ep) if form != "pull" else 0),
        dtype=torch.int32, device=dev)
    _launch("etpu_bfs_level_i8" if lev.dtype == torch.int8
            else "etpu_bfs_level_i32", dev, lev.data_ptr(),
            offsets.data_ptr(), csc_src.data_ptr(), col.data_ptr(), vp, it,
            unreached, BFS_FORMS.index(form), BFS_PULL_ALPHA, BFS_PULL_BETA,
            int(shared), buf.data_ptr())
    launches[name] += 1
    pass_launches["bfs_level_list"] += 1
    pass_launches["bfs_level_push"] += 1
    pass_launches["bfs_level_pull"] += 1
    return buf[:1]


# ------------------------------------------------------ collapse_levels --

def collapse_levels_plain(lev, offsets, source: int, unreached: int):
    """Plain version of ``collapse_levels``."""
    nonempty = offsets[1:] > offsets[:-1]
    lv = lev[torch.where(nonempty, offsets[:-1], 0).long()].int()
    dist = torch.where(nonempty & (lv < unreached), lv, INT32_MAX)
    dist[source] = 0
    return dist


@_spanned
def collapse_levels(lev: torch.Tensor, offsets: torch.Tensor, source: int,
                    unreached: int) -> torch.Tensor:
    """Edge-axis levels -> [Vp] int32 distances: the level at each non-empty
    segment's start when below ``unreached``, else INT32_MAX; 0 at
    ``source``."""
    name = f"collapse_levels<{'int8' if lev.dtype == torch.int8 else 'int32'}>"
    throw_if(lev.dtype not in (torch.int8, torch.int32) or lev.dim() != 1,
             f"{name}: lev must be [Ep] int8 or int32")
    _check_graph(name, lev.numel(), offsets)
    vp = offsets.numel() - 1
    throw_if(not 0 <= source < vp, f"{name}: source {source} out of range")
    if not _route(name, lev):
        return collapse_levels_plain(lev, offsets, source, unreached)
    _check(name, lev.device, lev=lev, offsets=offsets)
    dist = torch.empty(vp, dtype=torch.int32, device=lev.device)
    fn = ("etpu_collapse_levels_i8" if lev.dtype == torch.int8
          else "etpu_collapse_levels_i32")
    _launch(fn, lev.device, lev.data_ptr(), offsets.data_ptr(), vp, source,
            unreached, dist.data_ptr())
    launches[name] += 1
    return dist


# ----------------------------------------------------- bfs_predecessors --

def bfs_predecessors_plain(dist, offsets, csc_src, n_edges: int):
    """Plain version of ``bfs_predecessors``."""
    seg = _segment_ids(offsets, csc_src.numel())[:n_edges]
    src = csc_src[:n_edges].long()
    ds = dist[src].long()
    ok = (ds != INT32_MAX) & (ds + 1 == dist[seg].long())
    cand = torch.where(ok, src, INT32_MAX)
    best = torch.full((dist.numel(),), INT32_MAX, dtype=torch.int64,
                      device=dist.device)
    best.scatter_reduce_(0, seg, cand, "amin")
    valid = (dist != INT32_MAX) & (dist > 0) & (best < INT32_MAX)
    return torch.where(valid, best, -1).int()


@_spanned
def bfs_predecessors(dist: torch.Tensor, offsets: torch.Tensor,
                     csc_src: torch.Tensor, n_edges: int) -> torch.Tensor:
    """[Vp] int32: the smallest-id in-neighbour one level up over the real
    in-edges (CSC slots below ``n_edges``); -1 at the source, at unreached
    vertices and where there is none. ``offsets`` are the CSC offsets.

    Two device launches (``csrc/first_hit.cuh``): the first walk, counted
    in ``launches``, and the range walk, in ``pass_launches``."""
    name = "bfs_predecessors"
    vp = offsets.numel() - 1
    throw_if(dist.dtype != torch.int32 or dist.shape != (vp,),
             f"{name}: dist must be [Vp] int32")
    _check_graph(name, csc_src.numel(), offsets, csc_src)
    throw_if(not 0 <= n_edges <= csc_src.numel(),
             f"{name}: n_edges out of range")
    if not _route(name, dist):
        return bfs_predecessors_plain(dist, offsets, csc_src, n_edges)
    _check(name, dist.device, dist=dist, offsets=offsets, csc_src=csc_src)
    pred = torch.empty(vp, dtype=torch.int32, device=dist.device)
    scratch = pred_scratch(csc_src.numel(), dist.device)
    _launch("etpu_bfs_predecessors", dist.device, dist.data_ptr(),
            offsets.data_ptr(), csc_src.data_ptr(), vp, n_edges, PRED_SPLIT,
            pred.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    pass_launches["bfs_predecessors_ranges"] += 1
    return pred


def pred_ranges(ep: int, split: int) -> int:
    """The most ranges the predecessors' first walk can list: a segment of
    L > split slots lists ceil((L - split) / split) <= L // split."""
    return ep // split + 1


def pred_scratch(ep: int, device: torch.device) -> torch.Tensor:
    """The predecessor kernels' scratch: the count of listed ranges and 3
    unused words, then room for every range (int4); the C call zeroes the
    count."""
    throw_if(PRED_SPLIT < 1,
             f"predecessors: PRED_SPLIT {PRED_SPLIT} must be positive")
    return torch.empty(4 + 4 * pred_ranges(ep, PRED_SPLIT),
                       dtype=torch.int32, device=device)


# ------------------------------------------------------------------ spmv --

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


# ------------------------------------------------------------ spmv_rows --

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


# ----------------------------------------------------------- spmv_slabs --

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


# ------------------------------------------------------ sssp and k-core --

def _check_state(name: str, ep: int, **tensors) -> None:
    for arg, t in tensors.items():
        throw_if(t.dtype != torch.int32 or t.shape != (ep,),
                 f"{name}: {arg} must be [Ep] = [{ep}] int32")


def _check_weights(name: str, ep: int, w) -> None:
    throw_if(w.dtype != torch.float32 or w.shape != (ep,),
             f"{name}: w must be [Ep] = [{ep}] float32")


def _check_disjoint(name: str, **tensors) -> None:
    """The kernels read their inputs through __restrict__ pointers while
    they write their outputs: no two of ``tensors`` may share memory."""
    spans = [(t.data_ptr(), t.data_ptr() + t.numel() * t.element_size(), a)
             for a, t in tensors.items()]
    for i, (lo, hi, a) in enumerate(spans):
        for lo2, hi2, b in spans[i + 1:]:
            throw_if(lo < hi2 and lo2 < hi,
                     f"{name}: {a} and {b} must not share memory")


def _start_values(state, offsets, empty: int):
    """(non-empty mask [Vp], start positions [Vp] int64, state at each start
    with ``empty`` at empty segments [Vp])."""
    nonempty = offsets[1:] > offsets[:-1]
    starts = torch.where(nonempty, offsets[:-1], 0).long()
    return nonempty, starts, torch.where(nonempty, state[starts], empty)


# ----------------------------------------------------------- sssp_sweep --

def sssp_sweep_plain(dist_in, dist_out, offsets, col, w):
    """Plain version of ``sssp_sweep`` (same contract, same writes): the
    messages of the changed vertices' rows, min-reduced per column. The
    count is the first of the kernel's scalar words, which follow it."""
    nonempty, starts, dv = _start_values(dist_in, offsets, INF_BITS)
    changed = nonempty & (dv != _start_values(dist_out, offsets,
                                              INF_BITS)[2])
    row = _segment_ids(offsets, w.numel())
    msg = (dv.view(torch.float32)[row] + w).view(torch.int32)
    s = torch.full_like(dv, INF_BITS).scatter_reduce_(
        0, col.long(), torch.where(changed[row], msg, INF_BITS), "amin")
    dist_out[starts[nonempty]] = torch.minimum(s, dv)[nonempty]
    lengths = torch.where(changed, offsets[1:] - offsets[:-1], 0)
    words = torch.stack((
        (nonempty & (s < dv)).sum(dtype=torch.int32),
        ((lengths + PUSH_SPLIT - 1) // PUSH_SPLIT).sum(dtype=torch.int32),
        lengths.sum(dtype=torch.int32),
        torch.zeros((), dtype=torch.int32, device=dv.device)))
    return words[:1]


@_spanned
def sssp_sweep(dist_in: torch.Tensor, dist_out: torch.Tensor,
               offsets: torch.Tensor, col: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """One Bellman-Ford sweep on the edge axis of a symmetric-layout graph.

    ``dist_in`` and ``dist_out`` ([Ep] int32, distinct buffers) hold float32
    distance bits at segment starts: ``dist_in`` the distances d_t after
    sweep t, ``dist_out`` those of the sweep before, d_{t-1} (+inf bits
    before the first sweep; the ping-pong buffers of a search hold just
    that). For each vertex v with a non-empty segment, ``dist_out[offsets[
    v]]`` becomes the smaller of d_t[v] and the bits of min f32(d_t[u] +
    w[q]) over the CSR slots q of the vertices u whose distance changed
    (d_t[u] != d_{t-1}[u]) with ``col[q]`` == v; ``col`` and ``w`` ([Ep]
    int32 and float32) are the CSR columns and weights. That is the full
    sweep's result (an unchanged u's messages were folded in sweep t). No
    other position is read or written. Returns the number of vertices
    whose distance fell, int32 [1], on the state's device, followed in
    memory by the ranges listed and the CSR slots the push read
    (``sssp_sweep_count``).

    The kernel is three device launches: the dense pass, counted in
    ``launches``, then the push from the changed rows into a [Vp] copy of
    the distances and the update of the starts from it, in
    ``pass_launches``."""
    name = "sssp_sweep"
    ep = col.numel()
    _check_state(name, ep, dist_in=dist_in, dist_out=dist_out)
    _check_weights(name, ep, w)
    _check_graph(name, ep, offsets, col, "col")
    kernel = _route(name, dist_in)
    _check_disjoint(name, dist_in=dist_in, dist_out=dist_out)
    if not kernel:
        return sssp_sweep_plain(dist_in, dist_out, offsets, col, w)
    dev = dist_in.device
    _check(name, dev, dist_in=dist_in, dist_out=dist_out, offsets=offsets,
           col=col, w=w)
    vp = offsets.numel() - 1
    vp4 = -(-vp // 4) * 4
    # the scalars (improved, ranges listed, slots listed, 1 unused), two
    # [Vp] copies of the distances, then room for every listed range
    # (int4)
    buf = torch.empty(4 + 2 * vp4 + 4 * push_ranges(vp, ep),
                      dtype=torch.int32, device=dev)
    _launch("etpu_sssp_sweep", dev, dist_in.data_ptr(), dist_out.data_ptr(),
            offsets.data_ptr(), col.data_ptr(), w.data_ptr(), vp,
            buf.data_ptr())
    launches[name] += 1
    pass_launches["sssp_sweep_push"] += 1
    pass_launches["sssp_sweep_update"] += 1
    return buf[:1]


def sssp_sweep_count(cnt: torch.Tensor) -> tuple:
    """(The vertices an ``sssp_sweep`` call improved, the CSR slots its
    push read: the changed vertices' row lengths), read to the host from
    its count ``cnt`` and the words that follow it: the sweep's one wait
    on the device. On the kernel's route one copy into pinned memory (a C
    call, as ``bfs_level_count``'s) brings the scratch's first three words
    (the count, the ranges listed, the slots listed)."""
    if not _route("sssp_sweep", cnt):
        improved, _, slots = cnt.as_strided((3,), (1,)).tolist()
        return improved, slots
    host, words = _level_words()
    _launch("etpu_read_level_scalars", cnt.device, host.data_ptr(),
            cnt.data_ptr(), 3)
    return words[0], words[2]


# ---------------------------------------------------- sssp_predecessors --

def sssp_predecessors_plain(dist, offsets, csc_src, w, n_edges: int):
    """Plain version of ``sssp_predecessors``."""
    seg = _segment_ids(offsets, csc_src.numel())[:n_edges]
    src = csc_src[:n_edges].long()
    ok = dist[src] + w[:n_edges] == dist[seg]
    cand = torch.where(ok, src, INT32_MAX)
    best = torch.full((dist.numel(),), INT32_MAX, dtype=torch.int64,
                      device=dist.device)
    best.scatter_reduce_(0, seg, cand, "amin")
    valid = torch.isfinite(dist) & (dist > 0) & (best < INT32_MAX)
    return torch.where(valid, best, -1).int()


@_spanned
def sssp_predecessors(dist: torch.Tensor, offsets: torch.Tensor,
                      csc_src: torch.Tensor, w: torch.Tensor,
                      n_edges: int) -> torch.Tensor:
    """[Vp] int32: the smallest-id in-neighbour u over the real in-edges q
    (CSC slots below ``n_edges``) with f32(dist[u] + w[q]) == dist[v]; -1
    unless dist[v] is finite and above 0 and such an edge exists. ``dist``
    is [Vp] float32, ``offsets`` the CSC offsets, ``w`` [Ep] float32 in CSC
    order. Two device launches, as ``bfs_predecessors``: the first walk in
    ``launches``, the range walk in ``pass_launches``."""
    name = "sssp_predecessors"
    vp, ep = offsets.numel() - 1, csc_src.numel()
    throw_if(dist.dtype != torch.float32 or dist.shape != (vp,),
             f"{name}: dist must be [Vp] float32")
    _check_weights(name, ep, w)
    _check_graph(name, ep, offsets, csc_src)
    throw_if(not 0 <= n_edges <= ep, f"{name}: n_edges out of range")
    if not _route(name, dist):
        return sssp_predecessors_plain(dist, offsets, csc_src, w, n_edges)
    _check(name, dist.device, dist=dist, offsets=offsets, csc_src=csc_src,
           w=w)
    pred = torch.empty(vp, dtype=torch.int32, device=dist.device)
    scratch = pred_scratch(ep, dist.device)
    _launch("etpu_sssp_predecessors", dist.device, dist.data_ptr(),
            offsets.data_ptr(), csc_src.data_ptr(), w.data_ptr(), vp,
            n_edges, PRED_SPLIT, pred.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    pass_launches["sssp_predecessors_ranges"] += 1
    return pred


# ----------------------------------------------------------- kcore waves --

def kcore_wave_words(vp: int, ep: int) -> int:
    """The int32 words of the k-core waves' scratch: 8 scalar words
    (peeled, candidates listed, ranges listed, k, then the card's own) and
    room for every listed range (int4)."""
    return 8 + 4 * push_ranges(vp, ep)


def kcore_wave_scratch(vp: int, ep: int, device) -> torch.Tensor:
    """The k-core waves' scratch (``kcore_wave_words``), kept across the
    waves of a run."""
    return torch.empty(kcore_wave_words(vp, ep), dtype=torch.int32,
                       device=device)


def _kcore_peel_plain(deg, core, offsets, csc_src, peel, k: int, cand_out,
                      scratch):
    """The plain waves' common part: the vertices of ``peel`` ([Vp] bool)
    marked peeled at k, every survivor's degree lowered by its peeled
    in-neighbours (the pull over ``csc_src``), the alive vertices left
    below k written to ``cand_out`` in vertex order, and the kernel's four
    scalar words written to ``scratch``."""
    nonempty, starts, d = _start_values(deg, offsets, -1)
    survivor = nonempty & (d >= 0) & ~peel
    cnt = torch.zeros_like(d).index_add_(
        0, _segment_ids(offsets, csc_src.numel()),
        peel.int()[csc_src.long()])
    d2 = d - cnt
    deg[starts[peel]] = -1
    core[starts[peel]] = k - 1
    deg[starts[survivor]] = d2[survivor]
    cand = torch.nonzero(survivor & (d2 < k)).flatten().int()
    cand_out[:cand.numel()] = cand
    lengths = torch.where(peel, offsets[1:] - offsets[:-1], 0)
    ranges = int(((lengths + PUSH_SPLIT - 1) // PUSH_SPLIT).sum())
    scratch[:4] = torch.tensor([int(peel.sum()), cand.numel(), ranges, k],
                               dtype=torch.int32, device=scratch.device)
    return scratch[:4]


def kcore_level_wave_plain(deg, core, offsets, csc_src, col, cand_out,
                           scratch):
    """Plain version of ``kcore_level_wave`` (same contract, same writes;
    the candidates in vertex order): the pull over ``csc_src``; ``col`` is
    only the kernel's."""
    nonempty, _, d = _start_values(deg, offsets, -1)
    alive = nonempty & (d >= 0)
    least = int(torch.where(alive, d, INT32_MAX).min()) if d.numel() \
        else INT32_MAX
    k = INT32_MAX if least == INT32_MAX else least + 1
    return _kcore_peel_plain(deg, core, offsets, csc_src, alive & (d < k), k,
                             cand_out, scratch)


def kcore_cascade_wave_plain(deg, core, offsets, csc_src, col, k: int,
                             cand_in, n_in: int, cand_out, scratch):
    """Plain version of ``kcore_cascade_wave`` (same contract, same
    writes; the candidates in vertex order)."""
    peel = torch.zeros(offsets.numel() - 1, dtype=torch.bool,
                       device=deg.device)
    peel[cand_in[:n_in].long()] = True
    return _kcore_peel_plain(deg, core, offsets, csc_src, peel, k, cand_out,
                             scratch)


def _check_kcore_wave(name: str, deg, core, offsets, csc_src, col,
                      scratch, **lists) -> bool:
    """The waves' checks; True for the kernel, False for the plain
    version."""
    ep, vp = csc_src.numel(), offsets.numel() - 1
    _check_state(name, ep, deg=deg, core=core)
    _check_graph(name, ep, offsets, csc_src)
    _check_graph(name, ep, offsets, col, "col")
    for arg, t in lists.items():
        throw_if(t.dtype != torch.int32 or t.shape != (vp,),
                 f"{name}: {arg} must be [Vp] = [{vp}] int32")
    need = kcore_wave_words(vp, ep)
    throw_if(scratch.dtype != torch.int32 or scratch.dim() != 1
             or scratch.numel() < need,
             f"{name}: scratch must be int32 of at least {need} words "
             f"(kcore_wave_words)")
    kernel = _route(name, deg)
    _check_disjoint(name, deg=deg, core=core, scratch=scratch, **lists)
    if kernel:
        _check(name, deg.device, deg=deg, core=core, offsets=offsets,
               col=col, scratch=scratch, **lists)
    return kernel


@_spanned
def kcore_level_wave(deg: torch.Tensor, core: torch.Tensor,
                     offsets: torch.Tensor, csc_src: torch.Tensor,
                     col: torch.Tensor, cand_out: torch.Tensor,
                     scratch: torch.Tensor) -> torch.Tensor:
    """The first k-core peel wave at a new level, in place, on the edge
    axis of a symmetric-layout graph.

    ``deg`` and ``core`` ([Ep] int32, distinct buffers) hold each segment's
    remaining degree (-1 once peeled) and core number at its start. The
    wave finds k = the smallest alive degree + 1 (INT32_MAX when nothing
    is alive); each vertex v with a non-empty segment and 0 <= deg < k is
    peeled (deg -1, core k - 1), and each alive survivor's degree falls by
    its in-neighbours peeled. No other position of the state is written.
    ``cand_out`` ([Vp] int32) receives the survivors whose degree fell
    below k, each once, in any order: the next wave's peel set (the kernel
    leaves its block minima in the words after them). Returns the
    first four words of ``scratch`` (``kcore_wave_scratch``), int32 on the
    state's device: (vertices peeled, candidates listed, ranges listed, k);
    ``kcore_wave_read`` reads them.

    The plain version pulls over ``csc_src`` ([Ep] int32, the source of
    each CSC slot). The kernel pushes: each peeled vertex u takes one from
    the degree of every alive out-neighbour, ``col`` ([Ep] int32, the CSR
    column indices) over u's row. On a symmetric layout u's row sits at
    the positions of its segment, and the vertices it reaches are those
    whose pull counts it, directed or not. Three device launches: the
    minimum, counted in ``launches``, then the peel and the push, in
    ``pass_launches``."""
    name = "kcore_level_wave"
    if not _check_kcore_wave(name, deg, core, offsets, csc_src, col, scratch,
                             cand_out=cand_out):
        return kcore_level_wave_plain(deg, core, offsets, csc_src, col,
                                      cand_out, scratch)
    _launch("etpu_kcore_level_wave", deg.device, deg.data_ptr(),
            core.data_ptr(), offsets.data_ptr(), col.data_ptr(),
            offsets.numel() - 1, cand_out.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    pass_launches["kcore_level_peel"] += 1
    pass_launches["kcore_wave_push"] += 1
    return scratch[:4]


@_spanned
def kcore_cascade_wave(deg: torch.Tensor, core: torch.Tensor,
                       offsets: torch.Tensor, csc_src: torch.Tensor,
                       col: torch.Tensor, k: int, cand_in: torch.Tensor,
                       n_in: int, cand_out: torch.Tensor,
                       scratch: torch.Tensor) -> torch.Tensor:
    """A k-core peel wave at level ``k`` from a candidate list, in place:
    the ``n_in`` (>= 1) vertices of ``cand_in`` ([Vp] int32), which the
    caller holds to be alive with degree below k (the list the wave before
    gave), are peeled (deg -1, core k - 1), and the rest is
    ``kcore_level_wave``'s: the survivors' degrees fall, ``cand_out`` lists
    those that fell below k, and the first four words of ``scratch`` are
    returned (peeled, candidates listed, ranges listed, k). Two device
    launches: the mark, counted in ``launches``, and the push, in
    ``pass_launches``."""
    name = "kcore_cascade_wave"
    throw_if(not 1 <= k <= INT32_MAX, f"{name}: k out of range")
    throw_if(not 1 <= n_in <= offsets.numel() - 1,
             f"{name}: n_in out of range")
    if not _check_kcore_wave(name, deg, core, offsets, csc_src, col, scratch,
                             cand_in=cand_in, cand_out=cand_out):
        return kcore_cascade_wave_plain(deg, core, offsets, csc_src, col, k,
                                        cand_in, n_in, cand_out, scratch)
    _launch("etpu_kcore_cascade_wave", deg.device, deg.data_ptr(),
            core.data_ptr(), offsets.data_ptr(), col.data_ptr(),
            offsets.numel() - 1, k, cand_in.data_ptr(), n_in,
            cand_out.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    pass_launches["kcore_wave_push"] += 1
    return scratch[:4]


def kcore_wave_read(scalars: torch.Tensor) -> list:
    """A wave's four scalars (peeled, candidates listed, ranges listed, k)
    read to the host: the wave's one wait on the device. On the kernel's
    route one copy into pinned memory (a C call, as ``bfs_level_count``'s)."""
    if not _route("kcore_level_wave", scalars):
        return scalars.tolist()
    host, words = _level_words()
    _launch("etpu_read_level_scalars", scalars.device, host.data_ptr(),
            scalars.data_ptr(), 4)
    return words[:4]


def push_ranges(vp: int, ep: int) -> int:
    """The most ranges a sweep's push list can hold: a row of L slots is
    ceil(L / PUSH_SPLIT) ranges."""
    return vp + -(-ep // PUSH_SPLIT)


# ------------------------------------------------------ collapse_starts --

def collapse_starts_plain(exp, offsets, empty: int, source: int = -1):
    """Plain version of ``collapse_starts``."""
    out = _start_values(exp, offsets, empty)[2]
    if source >= 0:
        out[source] = 0
    return out


@_spanned
def collapse_starts(exp: torch.Tensor, offsets: torch.Tensor, empty: int,
                    source: int = -1) -> torch.Tensor:
    """Edge-axis state -> [Vp] int32: the value at each non-empty segment's
    start, ``empty`` at empty segments, and 0 at ``source`` unless it is
    -1."""
    name = "collapse_starts"
    _check_graph(name, exp.numel(), offsets)
    _check_state(name, exp.numel(), exp=exp)
    vp = offsets.numel() - 1
    throw_if(not -1 <= source < vp, f"{name}: source {source} out of range")
    if not _route(name, exp):
        return collapse_starts_plain(exp, offsets, empty, source)
    _check(name, exp.device, exp=exp, offsets=offsets)
    out = torch.empty(vp, dtype=torch.int32, device=exp.device)
    if vp == 0:
        return out
    _launch("etpu_collapse_starts", exp.device, exp.data_ptr(),
            offsets.data_ptr(), vp, empty, source, out.data_ptr())
    launches[name] += 1
    return out


# ------------------------------------------------------ expand_segments --

def expand_segments_plain(vals, offsets, n: int):
    """Plain version of ``expand_segments``."""
    return vals[_segment_ids(offsets, n)]


@_spanned
def expand_segments(vals: torch.Tensor, offsets: torch.Tensor,
                    n: int) -> torch.Tensor:
    """Per-vertex values -> [n] int32 on the edge axis: every position of
    segment v, [offsets[v], offsets[v+1]), holds ``vals[v]`` ([Vp] int32).
    The segments must cover [0, n): offsets[-1] == n."""
    name = "expand_segments"
    _check_graph(name, n, offsets)
    vp = offsets.numel() - 1
    throw_if(vals.dtype != torch.int32 or vals.shape != (vp,),
             f"{name}: vals must be [Vp] = [{vp}] int32")
    kernel = _route(name, vals)
    # the tiles' places (segment ends and slots) are int32 on the card
    throw_if(not 0 <= n <= INT32_MAX - EXPAND_TILE - vp
             or int(offsets[-1]) != n,
             f"{name}: the segments must cover [0, n), n = {n}")
    if not kernel:
        return expand_segments_plain(vals, offsets, n)
    _check(name, vals.device, vals=vals, offsets=offsets)
    out = torch.empty(n, dtype=torch.int32, device=vals.device)
    if n == 0:
        return out
    _launch("etpu_expand_segments", vals.device, vals.data_ptr(),
            offsets.data_ptr(), vp, n, out.data_ptr())
    launches[name] += 1
    return out


# ------------------------------------------------------------------ scan --

def _wrap_i32(x64: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wrap-around."""
    return (torch.remainder(x64 + 2**31, 2**32) - 2**31).int()


def _ordered(x: torch.Tensor) -> torch.Tensor:
    """[n] int64 keys that order as x does (int32, or float32 by its bits:
    negative floats have all but the sign bit flipped)."""
    if x.dtype == torch.float32:
        b = x.view(torch.int32)
        x = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    return x.long()


def _unordered(k: torch.Tensor, dtype) -> torch.Tensor:
    k = k.int()
    if dtype == torch.float32:
        return torch.where(k < 0, k ^ 0x7FFFFFFF, k).view(torch.float32)
    return k


def scan_plain(x, flags=None, op: str = "add"):
    """Plain version of ``scan``. A float ``add`` is summed in float64 and
    rounded once, so it differs from the kernel's float32 order within a
    tolerance; every other case is exact."""
    n = x.numel()
    if n == 0:
        return x.clone()
    dev = x.device
    start = (torch.zeros(n, dtype=torch.bool, device=dev) if flags is None
             else flags.bool().clone())
    start[0] = True
    pos = torch.arange(n, device=dev)
    first = torch.cummax(torch.where(start, pos, 0), 0).values
    if op == "first":
        return x[first]
    if op == "add":
        wide = x.double() if x.dtype == torch.float32 else x.long()
        c = torch.cumsum(wide, 0)
        c = c - (c[first] - wide[first])
        return c.float() if x.dtype == torch.float32 else _wrap_i32(c)
    seg = torch.cumsum(start.long(), 0) - 1
    k = _ordered(x)
    # later segments carry larger keys, so a running max stays in its segment
    u = k + 2**31 if op == "max" else 2**31 - 1 - k
    m = torch.cummax(seg * 2**32 + u, 0).values - seg * 2**32
    return _unordered(m - 2**31 if op == "max" else 2**31 - 1 - m, x.dtype)


def scan_tiles(n: int) -> int:
    """Tiles of one ``scan`` launch over ``n`` elements, one block each."""
    return -(-n // SCAN_TILE)


def scan_scratch_words(n: int) -> int:
    """The 64-bit words of one ``scan`` launch's scratch over ``n``
    elements: the tiles' status words, the groups' (one per SCAN_GROUP
    tiles), then the 32-bit ticket."""
    g = scan_tiles(n)
    return g + -(-g // SCAN_GROUP) + 1


@_spanned
def scan(x: torch.Tensor, flags: torch.Tensor | None = None,
         op: str = "add") -> torch.Tensor:
    """Inclusive scan of a 1-D int32 (add wraps around) or float32 tensor
    under ``op`` (add, min, max, first), segmented where ``flags`` ([n] bool
    or uint8) marks segment starts; position 0 always starts one. A float
    add is deterministic: its order depends on n and the flags alone. One
    launch: each tile's carry comes from the aggregates its predecessors
    publish (a look-back)."""
    name = "scan"
    throw_if(op not in SCAN_OPS, f"{name}: op must be one of {SCAN_OPS}")
    throw_if(x.dtype not in (torch.int32, torch.float32) or x.dim() != 1,
             f"{name}: x must be 1-D int32 or float32")
    throw_if(flags is not None and (flags.dtype not in (torch.bool,
                                                        torch.uint8)
                                    or flags.shape != x.shape),
             f"{name}: flags must be [n] bool or uint8")
    if not _route(name, x):
        return scan_plain(x, flags, op)
    dev = x.device
    _check(name, dev, x=x, **({} if flags is None else {"flags": flags}))
    n = x.numel()
    out = torch.empty_like(x)
    scratch = torch.empty(scan_scratch_words(n), dtype=torch.int64,
                          device=dev)          # the C call zeroes it
    _launch("etpu_scan_f32" if x.dtype == torch.float32 else "etpu_scan_i32",
            dev, x.data_ptr(), None if flags is None else flags.data_ptr(),
            out.data_ptr(), scratch.data_ptr(), n, SCAN_OPS.index(op))
    launches[name] += 1
    return out


# ------------------------------------------------------- gather_payloads --

def gather_packs(n: int, lengths) -> bool:
    """Whether ``gather_payloads`` packs payloads of these ``lengths`` before
    it gathers ``n`` slots: for 2-4 payloads when n >= PACK_MIN_SLOTS and
    n >= the shortest length, where the sectors it saves (NP - 1 per slot)
    outweigh the pack pass (a launch that streams the payloads once)."""
    return (len(lengths) >= 2 and n >= PACK_MIN_SLOTS
            and n >= min(lengths))


def gather_payloads_plain(idx, *payloads):
    """Plain version of ``gather_payloads``."""
    i = idx.long()
    return tuple(p[i] for p in payloads)


@_spanned
def gather_payloads(idx: torch.Tensor, *payloads: torch.Tensor) -> tuple:
    """out_k[p] = payloads[k][idx[p]] for 1-4 payloads of 32-bit elements
    (int32 or float32, moved as bits), through one [n] int32 index array
    whose entries must lie in every payload's range. Returns a tuple of [n]
    tensors of the payloads' dtypes. Where ``gather_packs`` says so, the
    payloads are first interleaved into records and one record is gathered
    per slot."""
    name = "gather_payloads"
    throw_if(not 1 <= len(payloads) <= 4, f"{name}: 1-4 payloads")
    throw_if(idx.dtype != torch.int32 or idx.dim() != 1,
             f"{name}: idx must be 1-D int32")
    for p in payloads:
        throw_if(p.dtype not in (torch.int32, torch.float32) or p.dim() != 1,
                 f"{name}: payloads must be 1-D int32 or float32")
    if not _route(name, idx):
        return gather_payloads_plain(idx, *payloads)
    dev = idx.device
    _check(name, dev, idx=idx, **{f"payload{k}": p
                                  for k, p in enumerate(payloads)})
    n = idx.numel()
    lengths = [p.numel() for p in payloads]
    pack = gather_packs(n, lengths)
    outs = tuple(torch.empty(n, dtype=p.dtype, device=dev) for p in payloads)
    ins = [p.data_ptr() for p in payloads] + [None] * (4 - len(payloads))
    ptrs = [o.data_ptr() for o in outs] + [None] * (4 - len(outs))
    rec, length = None, 0
    if pack:
        length = min(lengths)
        rec = torch.empty(length * (2 if len(payloads) == 2 else 4),
                          dtype=torch.int32, device=dev)
        # the C call packs only where there is a slot and a record
        pass_launches["gather_payloads_pack"] += bool(n and length)
    _launch("etpu_gather_payloads", dev, idx.data_ptr(), n, *ins, *ptrs,
            len(payloads), None if rec is None else rec.data_ptr(), length)
    launches[name] += 1
    return outs


# -------------------------------------------------------- segment_reduce --

def reduce_identity(op: str, dtype):
    """The identity of ``op`` on ``dtype``: what an empty segment gets."""
    if op in ("sum", "or"):
        return 0
    if op == "and":
        return 1
    if dtype == torch.float32:
        return float("inf") if op == "min" else float("-inf")
    return INT32_MAX if op == "min" else -INT32_MAX - 1


def segment_reduce_plain(vals, offsets, op: str):
    """Plain version of ``segment_reduce`` (float sums in another order)."""
    s = offsets.numel() - 1
    lo = int(offsets[0])
    hi = int(offsets[-1])
    seg = _segment_ids(offsets - lo, hi - lo)
    v = vals[lo:hi]
    if op in ("or", "and"):
        hit = torch.zeros(s, dtype=torch.int64, device=vals.device)
        hit.index_add_(0, seg, (v != 0).long())
        if op == "or":
            return hit > 0
        return hit == (offsets[1:] - offsets[:-1]).long()
    if op == "sum" and vals.dtype == torch.int32:
        out = torch.zeros(s, dtype=torch.int64, device=vals.device)
        return _wrap_i32(out.index_add_(0, seg, v.long()))
    if op == "sum" and vals.dtype == torch.float32:
        # accumulated in float64 and rounded once: a sequential float32 sum
        # drifts with the segment's length
        out = torch.zeros(s, dtype=torch.float64, device=vals.device)
        return out.index_add_(0, seg, v.double()).float()
    if op == "sum":
        out = torch.zeros(s, dtype=vals.dtype, device=vals.device)
        return out.index_add_(0, seg, v)
    out = torch.full((s,), reduce_identity(op, vals.dtype), dtype=vals.dtype,
                     device=vals.device)
    return out.scatter_reduce_(0, seg, v, "amin" if op == "min" else "amax")


@_spanned
def segment_reduce(vals: torch.Tensor, offsets: torch.Tensor,
                   op: str) -> torch.Tensor:
    """Per-segment ``op`` (sum, min, max, or, and) of ``vals`` ([n] int32,
    whose sum wraps around, or float32) over the sorted [S+1] int32
    ``offsets`` (within [0, n]; offsets[0] need not be 0), with the identity
    at empty segments. sum/min/max give ``vals``' dtype, or/and bool (each
    value read as a truth value). ``vals`` may be a view at any element
    offset. One C call: a launch finds the splits of the merged segment ends
    and slots into tiles of REDUCE_TILE places (counted in
    ``pass_launches``), a launch reduces the tiles; a segment across tiles
    is completed from the partials the tiles before it publish. A float sum
    is deterministic: its order depends on the offsets alone."""
    name = "segment_reduce"
    throw_if(op not in REDUCE_OPS, f"{name}: op must be one of {REDUCE_OPS}")
    throw_if(vals.dtype not in (torch.int32, torch.float32)
             or vals.dim() != 1, f"{name}: vals must be 1-D int32 or float32")
    throw_if(offsets.dtype != torch.int32 or offsets.dim() != 1
             or offsets.numel() < 1, f"{name}: offsets must be [S+1] int32")
    if not _route(name, vals):
        return segment_reduce_plain(vals, offsets, op)
    dev = vals.device
    _check(name, dev, vals=vals, offsets=offsets)
    s, n = offsets.numel() - 1, vals.numel()
    throw_if(s + n > INT32_MAX, f"{name}: S + n must stay below 2^31")
    out = torch.empty(s, dtype=torch.bool if op in ("or", "and")
                      else vals.dtype, device=dev)
    if s == 0:
        return out
    # the tiles' status words, the ticket, the splits (one more than the
    # tiles): 2 64-bit words a tile and two
    scratch = torch.empty(2 * -(-(s + n) // REDUCE_TILE) + 2,
                          dtype=torch.int64, device=dev)
    _launch("etpu_segment_reduce_f32" if vals.dtype == torch.float32
            else "etpu_segment_reduce_i32", dev, vals.data_ptr(), n,
            offsets.data_ptr(), s, REDUCE_OPS.index(op),
            reduce_identity(op, vals.dtype), out.data_ptr(),
            scratch.data_ptr())
    launches[name] += 1
    pass_launches["segment_split"] += 1
    return out


# -------------------------------------------------------- segment_minmax --

MINMAX_PAYLOADS = 8            # payloads per segment_minmax launch


def segment_minmax_plain(payloads, active, offsets):
    """Plain version of ``segment_minmax``."""
    s = offsets.numel() - 1
    lo, hi = int(offsets[0]), int(offsets[-1])
    seg = _segment_ids(offsets - lo, hi - lo)
    act = active[lo:hi]
    x = torch.stack([p[lo:hi] for p in payloads])
    idx = seg.expand(len(payloads), -1)
    mx = torch.full((len(payloads), s), -INT32_MAX - 1, dtype=torch.int32,
                    device=active.device)
    mn = torch.full_like(mx, INT32_MAX)
    mx.scatter_reduce_(1, idx, torch.where(act, x, -INT32_MAX - 1), "amax")
    mn.scatter_reduce_(1, idx, torch.where(act, x, INT32_MAX), "amin")
    return mx, mn


def minmax_tiles(s: int, n: int) -> int:
    """segment_minmax's tiles over S segments and [n] payloads: the merged
    ends and slots, MINMAX_TILE places each (the offsets' span taken as n,
    its most)."""
    return -(-(s + n) // MINMAX_TILE)


@_spanned
def segment_minmax(payloads, active: torch.Tensor,
                   offsets: torch.Tensor) -> tuple:
    """Per segment s of the sorted [S+1] int32 ``offsets`` (within [0, n])
    and per [n] int32 payload k: the MAX and the MIN of payloads[k] over the
    positions of s where the [n] bool ``active`` is set, INT32_MIN and
    INT32_MAX where there is none. One C call per MINMAX_PAYLOADS payloads:
    a launch finds the splits of the merged segment ends and slots into
    tiles of MINMAX_TILE places (counted in ``pass_launches``), a launch
    reduces the tiles.
    Payloads and ``active`` may be views at any element offset. Returns
    (max [m, S], min [m, S]) int32, m = len(payloads)."""
    name = "segment_minmax"
    payloads = tuple(payloads)
    throw_if(not payloads, f"{name}: needs at least one payload")
    throw_if(active.dtype != torch.bool or active.dim() != 1,
             f"{name}: active must be [n] bool")
    n = active.numel()
    for p in payloads:
        throw_if(p.dtype != torch.int32 or p.shape != (n,),
                 f"{name}: payloads must be [n] = [{n}] int32")
    throw_if(offsets.dtype != torch.int32 or offsets.dim() != 1
             or offsets.numel() < 1, f"{name}: offsets must be [S+1] int32")
    if not _route(name, active):
        return segment_minmax_plain(payloads, active, offsets)
    dev = active.device
    _check(name, dev, active=active, offsets=offsets,
           **{f"payload{k}": p for k, p in enumerate(payloads)})
    s, m = offsets.numel() - 1, len(payloads)
    throw_if(s + n > INT32_MAX, f"{name}: S + n must stay below 2^31")
    mx = torch.empty((m, s), dtype=torch.int32, device=dev)
    mn = torch.empty_like(mx)
    if s == 0:
        return mx, mn
    # 16 partial words a tile, the ticket, the splits (one more than the
    # tiles): 17 64-bit words a tile and two; the launches reuse it in
    # stream order
    scratch = torch.empty(17 * minmax_tiles(s, n) + 2, dtype=torch.int64,
                          device=dev)
    for lo in range(0, m, MINMAX_PAYLOADS):
        chunk = payloads[lo:lo + MINMAX_PAYLOADS]
        ptrs = ([p.data_ptr() for p in chunk]
                + [None] * (MINMAX_PAYLOADS - len(chunk)))
        _launch("etpu_segment_minmax", dev, *ptrs, len(chunk),
                active.data_ptr(), n, offsets.data_ptr(), s,
                mx[lo].data_ptr(), mn[lo].data_ptr(), scratch.data_ptr())
        launches[name] += 1
        pass_launches["segment_split"] += 1
    return mx, mn


# --------------------------------------------------------- advance_count --

def advance_count_plain(frontier, offsets, csc_src):
    """Plain version of ``advance_count``."""
    cnt = torch.zeros(offsets.numel() - 1, dtype=torch.int32,
                      device=frontier.device)
    return cnt.index_add_(0, _segment_ids(offsets, csc_src.numel()),
                          frontier[csc_src.long()].int())


def advance_count_bitmap_bytes(vp: int) -> int:
    """Bytes of the packed frontier that ``advance_count`` (and
    ``bfs_level``'s pull) builds for a [vp] frontier: one bit per vertex, in
    whole 16-byte words."""
    return 4 * bitmap_words(vp)


_shared_bytes = {}


def advance_count_tier(vp: int, device, max_shared_bytes: int | None = None
                       ) -> str:
    """The tier ``advance_count`` runs for a [vp] frontier on the CUDA
    ``device``: "shared" where the packed frontier fits the block's shared
    memory (the opt-in limit less the kernel's static shared memory, about
    225 KiB on an H100, so up to about 1.8M vertices) and, when given,
    ``max_shared_bytes``; else "global"."""
    device = torch.device(device)
    if device not in _shared_bytes:
        with torch.cuda.device(device):
            _shared_bytes[device] = _library().etpu_advance_count_shared_bytes()
        throw_if(_shared_bytes[device] < 0, "advance_count: could not read "
                                            "the device's shared memory")
    cap = _shared_bytes[device]
    if max_shared_bytes is not None:
        cap = min(cap, max_shared_bytes)
    return "shared" if advance_count_bitmap_bytes(vp) <= cap else "global"


@_spanned
def advance_count(frontier: torch.Tensor, offsets: torch.Tensor,
                  csc_src: torch.Tensor,
                  max_shared_bytes: int | None = None) -> torch.Tensor:
    """[Vp] int32: for each destination v, the in-edges q in
    [offsets[v], offsets[v+1]) whose source csc_src[q] is set in the [Vp]
    bool ``frontier``. ``offsets`` are the CSC offsets, covering [0, Ep).

    On the card one call zeroes the counts, packs the frontier into bits
    and counts over chunks of ADVANCE_CHUNK slots. Two size tiers, chosen
    by ``advance_count_tier``: "shared" holds the packed frontier in each
    block's shared memory, "global" (a frontier too large for it, or
    larger than ``max_shared_bytes``) reads the packed bits from device
    memory. The result is the same in both."""
    name = "advance_count"
    vp = offsets.numel() - 1
    if frontier.dtype != torch.bool or frontier.shape != (vp,):
        raise EssentialsError(f"{name}: frontier must be [Vp] bool")
    _check_graph(name, csc_src.numel(), offsets, csc_src)
    if not _route(name, frontier):
        return advance_count_plain(frontier, offsets, csc_src)
    dev = frontier.device
    _check(name, dev, frontier=frontier, offsets=offsets, csc_src=csc_src)
    shared = advance_count_tier(vp, dev, max_shared_bytes) == "shared"
    # the packed bits (16-byte aligned at the start), each chunk's first
    # row, then the counts
    skip = (advance_count_bitmap_bytes(vp) // 4
            + -(-csc_src.numel() // ADVANCE_CHUNK) + 1)
    buf = torch.empty(skip + vp, dtype=torch.int32, device=dev)
    out = buf[skip:]
    _launch("etpu_advance_count", dev, frontier.data_ptr(),
            offsets.data_ptr(), csc_src.data_ptr(), vp, csc_src.numel(),
            buf.data_ptr(), int(shared), out.data_ptr())
    launches[name] += 1
    return out


# ---------------------------------------------- segment fills, route OR --

def _check_flags(name: str, flags, n: int) -> None:
    throw_if(flags.dtype not in (torch.bool, torch.uint8)
             or flags.shape != (n,),
             f"{name}: start_flags must be [{n}] bool or uint8")


def _segment_ends(flags: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int64: the END of each position's segment, the first p' >= p
    with p' = n - 1 or flags[p' + 1] set."""
    end = torch.ones(n, dtype=torch.bool, device=flags.device)
    end[:-1] = flags[1:].bool()
    pos = torch.where(end, torch.arange(n, device=flags.device), n)
    return torch.flip(torch.cummin(torch.flip(pos, (0,)), 0).values, (0,))


def fill_tiles(n: int) -> int:
    """Tiles of one segment fill launch over ``n`` positions, one block
    each."""
    return -(-n // FILL_TILE)


def fill_scratch(n: int, device) -> torch.Tensor:
    """The int32 scratch of one segment fill launch over ``n`` positions:
    the tiles' 64-bit status words, the ticket, and (last) the update's
    any-flag; the C call zeroes all of it."""
    return torch.empty(2 * fill_tiles(n) + 2, dtype=torch.int32,
                       device=device)


def _fill(name: str, S, flags, lev=None, it: int = 0):
    """Launch etpu_segment_fill: the broadcast (lev None) or the update,
    whose any-flag is returned as a view of the scratch."""
    dev, n = S.device, S.numel()
    _check(name, dev, S=S, start_flags=flags,
           **({} if lev is None else {"lev": lev}))
    out = torch.empty_like(S)
    scratch = fill_scratch(n, dev)
    any_ = None if lev is None else scratch[-1:]
    _launch("etpu_segment_fill", dev, S.data_ptr(), flags.data_ptr(), n,
            None if lev is None else lev.data_ptr(), it, out.data_ptr(),
            scratch.data_ptr())
    launches[name] += 1
    return out, any_


def segment_broadcast_total_plain(S, start_flags):
    """Plain version of ``segment_broadcast_total``."""
    if S.numel() == 0:
        return S.clone()
    return S[_segment_ends(start_flags, S.numel())]


@_spanned
def segment_broadcast_total(S: torch.Tensor,
                            start_flags: torch.Tensor) -> torch.Tensor:
    """[n] of S's dtype: every position takes S at its segment's END (the
    slot before the next start flag; the last position always ends one).
    S is [n] int32 or float32, moved as bits; ``start_flags`` [n] bool or
    uint8 mark segment starts (flags[0] is not read)."""
    name = "segment_broadcast_total"
    throw_if(S.dtype not in (torch.int32, torch.float32) or S.dim() != 1,
             f"{name}: S must be 1-D int32 or float32")
    _check_flags(name, start_flags, S.numel())
    if not _route(name, S):
        return segment_broadcast_total_plain(S, start_flags)
    return _fill(name, S, start_flags)[0]


def suffix_fill_update_plain(S, start_flags, lev, it: int):
    """Plain version of ``suffix_fill_update``."""
    fill = segment_broadcast_total_plain(S, start_flags)
    newly = (fill > 0) & (lev == INT32_MAX)
    return (torch.where(newly, it, lev).int(),
            newly.any().int().reshape(1))


@_spanned
def suffix_fill_update(S: torch.Tensor, start_flags: torch.Tensor,
                       lev: torch.Tensor, it: int) -> tuple:
    """The segment-end fill of the int32 ``S``, then a BFS level update:
    every position whose fill is above 0 and whose ``lev`` is INT32_MAX
    (unreached) takes ``it``. Returns (the new lev [n] int32, whether any
    position changed as int32 [1]); ``lev`` is not written."""
    name = "suffix_fill_update"
    throw_if(S.dtype != torch.int32 or S.dim() != 1,
             f"{name}: S must be 1-D int32")
    throw_if(lev.dtype != torch.int32 or lev.shape != S.shape,
             f"{name}: lev must be [n] int32 like S")
    _check_flags(name, start_flags, S.numel())
    throw_if(not -INT32_MAX - 1 <= it <= INT32_MAX, f"{name}: it out of range")
    if not _route(name, S):
        return suffix_fill_update_plain(S, start_flags, lev, it)
    return _fill(name, S, start_flags, lev, it)


def fused_route_or_plain(lev, edge_ids, start_flags, it: int):
    """Plain version of ``fused_route_or``."""
    n = lev.numel()
    pos = torch.arange(n, device=lev.device)
    start = start_flags.bool().clone()
    if n:
        start[0] = True
    hit = lev[edge_ids.long()] == it
    last_hit = torch.cummax(torch.where(hit, pos, -1), 0).values
    last_start = torch.cummax(torch.where(start, pos, 0), 0).values
    return (last_hit >= last_start).int()


@_spanned
def fused_route_or(lev: torch.Tensor, edge_ids: torch.Tensor,
                   start_flags: torch.Tensor, it: int) -> torch.Tensor:
    """[n] int32: y[q] = (lev[edge_ids[q]] == it), routed through the
    gather, then an inclusive segmented OR over ``start_flags`` (position 0
    always starts a segment). ``lev`` and ``edge_ids`` are [n] int32, the
    ids in [0, n). One launch: ``scan``'s tiles and look-back, the compare
    made as each tile loads."""
    name = "fused_route_or"
    throw_if(lev.dtype != torch.int32 or lev.dim() != 1,
             f"{name}: lev must be 1-D int32")
    n = lev.numel()
    throw_if(edge_ids.dtype != torch.int32 or edge_ids.shape != (n,),
             f"{name}: edge_ids must be [{n}] int32")
    _check_flags(name, start_flags, n)
    throw_if(not -INT32_MAX - 1 <= it <= INT32_MAX, f"{name}: it out of range")
    if not _route(name, lev):
        return fused_route_or_plain(lev, edge_ids, start_flags, it)
    dev = lev.device
    _check(name, dev, lev=lev, edge_ids=edge_ids, start_flags=start_flags)
    out = torch.empty(n, dtype=torch.int32, device=dev)
    scratch = torch.empty(scan_scratch_words(n), dtype=torch.int64,
                          device=dev)          # the C call zeroes it
    _launch("etpu_route_or", dev, lev.data_ptr(), edge_ids.data_ptr(),
            start_flags.data_ptr(), n, it, out.data_ptr(), scratch.data_ptr())
    launches[name] += 1
    return out


# ----------------------------------------------- bitmap_intersect_counts --

PLAIN_WORDS = 1 << 25   # bitmap words the plain version gathers at a time


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
