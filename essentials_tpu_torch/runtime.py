"""Device discovery and profiling.

Counterpart of ``essentials_tpu/runtime.py`` (reference parity: gunrock's
``cuda/device_properties.hxx`` and ``context.hxx``). The JAX package keeps
per-generation hardware tables because its devices cannot be asked; here
``torch.cuda.get_device_properties`` answers, and only the memory rate,
which no API reports, comes from a table of data-sheet rates by card name.
Nothing in the package picks CUDA by itself: callers name the device, and
``require_cuda`` is how a caller that needs the card refuses to go on
without one. ``start_trace`` / ``stop_trace`` / ``trace`` record a
``torch.profiler`` trace (the JAX package's XLA profiler traces), and
``span`` names a stretch of the program's host work in it.
"""

from __future__ import annotations

import contextlib
import functools
import os
import time
from dataclasses import dataclass

import torch

from essentials_tpu_torch.errors import throw_if

# Data-sheet HBM rates in GB/s by the name torch.cuda reports (NVIDIA's H100
# SXM data sheet: 3.35 TB/s); a card not listed reads 0.0.
HBM_GBPS = {"NVIDIA H100 80GB HBM3": 3350.0}


@dataclass(frozen=True)
class DeviceProperties:
    name: str
    capability: tuple           # (major, minor); Hopper is (9, 0)
    sm_count: int               # streaming multiprocessors
    memory_gib: float           # device memory
    warp_size: int
    hbm_gbps: float             # peak memory rate (roofline denominator)


def require_cuda() -> None:
    """Raise EssentialsError when PyTorch sees no CUDA device."""
    throw_if(not torch.cuda.is_available(),
             "no CUDA device: this path runs only on the GPU")


def device_properties(device: str | torch.device = "cuda") -> DeviceProperties:
    """Properties of a CUDA device (reference parity: gcuda
    device_properties + standard_context_t::props)."""
    require_cuda()
    p = torch.cuda.get_device_properties(torch.device(device))
    return DeviceProperties(name=p.name, capability=(p.major, p.minor),
                            sm_count=p.multi_processor_count,
                            memory_gib=p.total_memory / 2**30,
                            warp_size=getattr(p, "warp_size", 32),
                            hbm_gbps=HBM_GBPS.get(p.name, 0.0))


def num_devices() -> int:
    return torch.cuda.device_count()


def backend(device: str | torch.device | None = None) -> str:
    """The device type a run uses: ``device``'s ("cuda" or "cpu"), or
    without one "cuda" where PyTorch sees a card, else "cpu"."""
    if device is not None:
        return torch.device(device).type
    return "cuda" if torch.cuda.is_available() else "cpu"


# --- profiling: a torch.profiler trace of the CPU and, where there is a card,
# the CUDA activity, exported as one Chrome trace (reference parity: the
# NVBench/CUPTI counters of benchmarks/sssp_bench.cu:60-66).

_active = None          # (profiler, log_dir) between start_trace and stop_trace
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context manager that names the host work inside it ``name`` in the
    trace of whatever torch.profiler is recording (``trace``, a
    benchmark's window, a user's own): a ``record_function``, kept by the
    profiler with the kernels, on their clock, and nested in the spans
    open around it on the thread. Where no profiler records it is one
    shared null context, and costs the check of the profiler's flag."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """A decorator: each call of the function inside ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def start_trace(log_dir: str) -> None:
    global _active
    throw_if(_active is not None, "a trace is already running")
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    _active = (prof, log_dir)


def stop_trace() -> str:
    """Stop the trace and write it to ``<log_dir>/trace_<pid>_<ns>.json``;
    returns that path."""
    global _active
    throw_if(_active is None, "no trace is running")
    prof, log_dir = _active
    _active = None
    prof.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir,
                        f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    return path


class trace:
    """Context manager: ``with runtime.trace("/tmp/trace") as t: run()``;
    ``t.path`` is the trace file once the block has ended."""

    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        self.path = None

    def __enter__(self):
        start_trace(self.log_dir)
        return self

    def __exit__(self, *exc):
        self.path = stop_trace()
        return False
