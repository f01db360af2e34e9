"""The fused BFS path's CUDA kernels: build, binding, wrappers, plain versions.

``csrc/bfs_kernels.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``build/essentials_tpu_torch/`` beside the package. The library's name
carries a hash of the sources and flags, so an edited source builds anew.
It is loaded with ``ctypes``.

Each kernel has a wrapper and a plain PyTorch version with the same
arithmetic. The wrapper dispatches on the device of the tensors it is given:
a CPU tensor goes to the plain version; a CUDA tensor goes to the kernel,
and anything the kernel does not take raises. There is no fallback from the
kernel to the plain version. ``launches`` counts each kernel's launches,
keyed by kernel and element type; the plain versions count nothing.
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

INT32_MAX = 2**31 - 1

_CSRC = Path(__file__).resolve().parent / "csrc"
_SOURCES = (_CSRC / "bfs_kernels.cu",)
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "essentials_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

launches = {"bfs_level<int32>": 0, "bfs_level<int8>": 0,
            "collapse_levels<int32>": 0, "collapse_levels<int8>": 0,
            "bfs_predecessors": 0}

_lib = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


# ---------------------------------------------------------------- build --

def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libetpu_bfs_kernels_{h.hexdigest()[:16]}.so"


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
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _SOURCES)]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True)
    throw_if(r.returncode != 0,
             f"nvcc failed ({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)           # atomic: a reader sees all or nothing
    return path, (f"built {path.name} in {time.perf_counter() - t0:.1f} s\n"
                  + r.stdout + r.stderr)


def _library():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        p, i = ctypes.c_void_p, ctypes.c_int
        argtypes = {
            "etpu_bfs_level_i32": (p, p, p, i, i, i, p, p),
            "etpu_bfs_level_i8": (p, p, p, i, i, i, p, p),
            "etpu_collapse_levels_i32": (p, p, i, i, i, p, p),
            "etpu_collapse_levels_i8": (p, p, i, i, i, p, p),
            "etpu_bfs_predecessors": (p, p, p, i, i, p, p),
        }
        for name, types in argtypes.items():
            fn = getattr(lib, name)
            fn.argtypes = types
            fn.restype = i
        _lib = lib
    return _lib


def _launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point ``name`` on ``device``'s current stream; raise on
    a non-zero CUDA status."""
    fn = getattr(_library(), name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise EssentialsError(f"{name}: CUDA error {err}")


def _check(name: str, device: torch.device, **tensors) -> None:
    for arg, t in tensors.items():
        throw_if(t.device != device,
                 f"{name}: {arg} is on {t.device}, expected {device}")
        throw_if(not t.is_contiguous(), f"{name}: {arg} must be contiguous")


def _route(name: str, t: torch.Tensor) -> bool:
    """True for the kernel (CUDA), False for the plain version (CPU)."""
    if t.device.type == "cpu":
        return False
    throw_if(t.device.type != "cuda",
             f"{name}: no kernel for device {t.device}")
    return True


def _check_graph(name: str, ep: int, offsets, csc_src=None) -> None:
    throw_if(offsets.dtype != torch.int32 or offsets.dim() != 1,
             f"{name}: offsets must be [Vp+1] int32")
    throw_if(csc_src is not None and (csc_src.dtype != torch.int32
                                      or csc_src.shape != (ep,)),
             f"{name}: csc_src must be [Ep] int32")


def _segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int64: the segment (vertex) that owns each position."""
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=offsets.device), counts,
        output_size=n)


# ------------------------------------------------------------ bfs_level --

def bfs_level_plain(lev, offsets, csc_src, it: int, unreached: int):
    """Plain version of ``bfs_level`` (same contract, same in-place write)."""
    nonempty = offsets[1:] > offsets[:-1]
    starts = torch.where(nonempty, offsets[:-1], 0).long()
    lev_v = torch.where(nonempty, lev[starts].int(), unreached)
    hit = torch.zeros(lev_v.numel(), dtype=torch.int32, device=lev.device)
    hit.index_add_(0, _segment_ids(offsets, lev.numel()),
                   (lev_v[csc_src.long()] == it).int())
    newly = nonempty & (lev_v == unreached) & (hit > 0)
    lev[starts[newly]] = it + 1
    return newly.sum(dtype=torch.int32).reshape(1)


def bfs_level(lev: torch.Tensor, offsets: torch.Tensor,
              csc_src: torch.Tensor, it: int, unreached: int) -> torch.Tensor:
    """One BFS level on the edge axis of a symmetric-layout graph.

    ``lev`` ([Ep] int32 or int8) holds each segment's level at its start
    position ``offsets[v]``; other positions are neither read nor written.
    Every vertex whose start holds ``unreached`` and that has an in-neighbour
    at level ``it`` gets ``it + 1``, IN PLACE. Returns the number of vertices
    reached, int32 [1], on ``lev``'s device."""
    name = f"bfs_level<{'int8' if lev.dtype == torch.int8 else 'int32'}>"
    throw_if(lev.dtype not in (torch.int8, torch.int32) or lev.dim() != 1,
             f"{name}: lev must be [Ep] int8 or int32")
    throw_if(not (0 <= it and it + 1 < unreached
                  <= torch.iinfo(lev.dtype).max),
             f"{name}: need 0 <= it and it + 1 < unreached <= dtype max")
    _check_graph(name, lev.numel(), offsets, csc_src)
    if not _route(name, lev):
        return bfs_level_plain(lev, offsets, csc_src, it, unreached)
    _check(name, lev.device, lev=lev, offsets=offsets, csc_src=csc_src)
    count = torch.zeros(1, dtype=torch.int32, device=lev.device)
    fn = "etpu_bfs_level_i8" if lev.dtype == torch.int8 else "etpu_bfs_level_i32"
    _launch(fn, lev.device, lev.data_ptr(), offsets.data_ptr(),
            csc_src.data_ptr(), offsets.numel() - 1, it, unreached,
            count.data_ptr())
    launches[name] += 1
    return count


# ------------------------------------------------------ collapse_levels --

def collapse_levels_plain(lev, offsets, source: int, unreached: int):
    """Plain version of ``collapse_levels``."""
    nonempty = offsets[1:] > offsets[:-1]
    lv = lev[torch.where(nonempty, offsets[:-1], 0).long()].int()
    dist = torch.where(nonempty & (lv < unreached), lv, INT32_MAX)
    dist[source] = 0
    return dist


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


def bfs_predecessors(dist: torch.Tensor, offsets: torch.Tensor,
                     csc_src: torch.Tensor, n_edges: int) -> torch.Tensor:
    """[Vp] int32: the smallest-id in-neighbour one level up over the real
    in-edges (CSC slots below ``n_edges``); -1 at the source, at unreached
    vertices and where there is none. ``offsets`` are the CSC offsets."""
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
    _launch("etpu_bfs_predecessors", dist.device, dist.data_ptr(),
            offsets.data_ptr(), csc_src.data_ptr(), vp, n_edges,
            pred.data_ptr())
    launches[name] += 1
    return pred
