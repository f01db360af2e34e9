"""Elapsed-time measurement on the device's own clock.

Counterpart of ``essentials_tpu/utils/timer.py`` (reference parity:
util::timer_t, gunrock ``util/timer.hxx:17-49``, which is cudaEvent-based).
On a CUDA device the timer records a ``torch.cuda.Event`` pair on the
current stream; on the CPU it reads ``time.perf_counter``.
"""

from __future__ import annotations

import time

import torch


class Timer:
    def __init__(self, device: str | torch.device):
        self._cuda = torch.device(device).type == "cuda"

    def begin(self) -> "Timer":
        if self._cuda:
            self._e0 = torch.cuda.Event(enable_timing=True)
            self._e1 = torch.cuda.Event(enable_timing=True)
            self._e0.record()
        else:
            self._t0 = time.perf_counter()
        return self

    def end(self) -> float:
        """Stop and return elapsed milliseconds. On CUDA this waits for the
        work queued between begin and end."""
        if self._cuda:
            self._e1.record()
            self._e1.synchronize()
            return self._e0.elapsed_time(self._e1)
        return (time.perf_counter() - self._t0) * 1e3
