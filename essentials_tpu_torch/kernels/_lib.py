"""The library of the port's CUDA kernels: its build, its load, the
declarations of what it holds, and the helpers every wrapper shares.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` (one ``nvcc``
per source, all started together) and linked into one shared library with a
plain C interface, at first use, into ``build/essentials_tpu_torch/`` at the
repository's root. The library's name carries a hash of the sources and
flags, so an edited source builds anew. It is loaded with ``ctypes``, and
the load binds every entry point the modules declare (``declare``) and
checks every constant they declare against the library's."""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import NamedTuple

import torch

from essentials_tpu_torch.errors import EssentialsError, throw_if
from essentials_tpu_torch.runtime import spanned

__all__ = ["BUILD_DIR", "DECLARED", "INF_BITS", "INT32_MAX", "LINK_FLAGS",
           "NVCC_FLAGS", "build", "counters", "declared", "device_kernels",
           "launches", "library_path", "pass_launches", "reset_launches"]

INT32_MAX = 2**31 - 1
INF_BITS = 0x7F800000          # float32 +inf as int32 bits: the min identity

_PACKAGE = Path(__file__).resolve().parent.parent
_CSRC = _PACKAGE / "csrc"
_SOURCES = tuple(sorted(_CSRC.glob("*.cu")))
_HEADERS = tuple(sorted(_CSRC.glob("*.cuh")))
BUILD_DIR = _PACKAGE.parent / "build" / "essentials_tpu_torch"
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")
LINK_FLAGS = (*_ARCH, "-shared")

# the kinds of a C entry point's parameters: pointer (a device pointer, the
# trailing cudaStream_t, or a host pointer), int, long long, float
P, I, LL, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


class Kernel(NamedTuple):
    """One wrapper's declaration, or that of wrappers sharing C entry
    points. ``launches``: each key it counts in
    ``launches`` (its name, with the element type where it has two; a key
    counts device kernel ``<key without <type>>_kernel``) and the JAX
    function that kernel stands for (``file:line`` in
    ``essentials_tpu/ops/``). ``passes``: its other device kernels, counted
    in ``pass_launches`` by name without ``_kernel``; ``uncounted``: those
    it counts nowhere. ``entries``: its C entry points and their parameters'
    kinds, the trailing stream included. ``constants``: each getter of a
    constant the library reports, and the wrapper's (name, value)."""
    launches: dict
    entries: dict
    passes: tuple = ()
    uncounted: tuple = ()
    constants: dict = {}


DECLARED: dict[str, tuple] = {}     # by csrc/ source: its Kernels, in order

# launches by ``Kernel.launches`` key and ``Kernel.passes`` name; the plain
# versions count nothing
launches: dict[str, int] = {}
pass_launches: dict[str, int] = {}

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


def declare(source: str, *kernels: Kernel) -> None:
    """Declare the kernels of ``csrc/<source>``: their counts join
    ``launches`` and ``pass_launches``."""
    DECLARED[source] = kernels
    for k in kernels:
        for key in k.launches:
            launches[key] = 0
        for name in k.passes:
            pass_launches[name.removesuffix("_kernel")] = 0


def declared(key: str) -> tuple[str, Kernel]:
    """(source, declaration) of launches key ``key``."""
    return next((source, k) for source, ks in DECLARED.items() for k in ks
                if key in k.launches)


def device_kernels(key: str) -> tuple:
    """The device kernels of launches key ``key``: its own, then its
    declaration's ``passes`` and ``uncounted``."""
    k = declared(key)[1]
    return (f"{key.split('<')[0]}_kernel", *k.passes, *k.uncounted)


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
    """The loaded library: every declared entry point bound, every declared
    constant checked against the getter that reports it."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()[0]))
        for k in (k for ks in DECLARED.values() for k in ks):
            for name, kinds in (*k.entries.items(),
                                *((g, ()) for g in k.constants)):
                fn = getattr(lib, name)
                fn.argtypes = kinds
                fn.restype = I
            for getter, (const, value) in k.constants.items():
                got = getattr(lib, getter)()
                throw_if(got != value,
                         f"{next(iter(k.launches)).split('<')[0]}: the "
                         f"library's {getter}() is {got}, {const} is {value}")
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


_level_host = None


def _read_scalars(t: torch.Tensor, n: int):
    """The first ``n`` (at most 6) int32 words of ``t``, on the card, read
    to the host by one copy into pinned memory (a C call: ``.item()``'s
    transfer without its dispatch): the ctypes view of the pinned words,
    made at the first read (``bfs_level_count``, ``sssp_sweep_count``,
    ``kcore_wave_read``) and valid until the next."""
    global _level_host
    if _level_host is None:
        host = torch.empty(6, dtype=torch.int32, pin_memory=True)
        _level_host = host, (ctypes.c_int * 6).from_address(host.data_ptr())
    host, words = _level_host
    _launch("etpu_read_level_scalars", t.device, host.data_ptr(),
            t.data_ptr(), n)
    return words


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


def _check_flags(name: str, flags, n: int) -> None:
    throw_if(flags.dtype not in (torch.bool, torch.uint8)
             or flags.shape != (n,),
             f"{name}: start_flags must be [{n}] bool or uint8")


def _start_values(state, offsets, empty: int):
    """(non-empty mask [Vp], start positions [Vp] int64, state at each start
    with ``empty`` at empty segments [Vp]): what ``csrc/segment_starts.cuh``
    reads on the card."""
    nonempty = offsets[1:] > offsets[:-1]
    starts = torch.where(nonempty, offsets[:-1], 0).long()
    return nonempty, starts, torch.where(nonempty, state[starts], empty)


def _segment_ids(offsets: torch.Tensor, n: int) -> torch.Tensor:
    """[n] int64: the segment (vertex) that owns each position."""
    counts = (offsets[1:] - offsets[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(counts.numel(), device=offsets.device), counts,
        output_size=n)
