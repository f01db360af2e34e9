"""Reading the traced window: torch.profiler's Chrome trace, reduced to the
numbers the per-layer metrics read.

Everything here works on the list of trace events (dicts with ``cat``,
``name``, ``ts`` and ``dur`` in microseconds), so its arithmetic is tested
on synthetic traces on the CPU.

* Device activity: events of the categories in ``DEVICE_CATS`` (kernels,
  memsets, copies), merged into disjoint busy intervals.
* Queries: the ``QUERY_SPAN`` annotations the harness wraps around each
  query (the call and its ``torch.cuda.synchronize()``), on the same clock.
* Completeness: the profiler has been seen to lose device activity. The
  trace's count of each of the program's kernels must equal the change of
  the program's launch counters (``kernels.launches`` and
  ``kernels.pass_launches``, keyed by a kernel's name without ``_kernel``)
  over the same queries; otherwise the window is taken again.
"""

from __future__ import annotations

import bisect
import json
import re
from collections import Counter
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
QUERY_SPAN = "graphbench.query"
_KERNEL = re.compile(r"([A-Za-z_]\w*?_kernel)\b")
_SCAN_BACK = 64          # host events looked at behind an idle gap's middle


def load(path) -> list:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def kernel_name(name: str) -> str | None:
    """The function name of a kernel event (``void (anonymous
    namespace)::bfs_level_kernel<int>(...)`` -> ``bfs_level_kernel``), or
    None where it has no ``*_kernel`` name."""
    m = _KERNEL.search(name)
    return m.group(1) if m else None


def _device_events(events) -> list:
    return sorted(((e["ts"], e["ts"] + e.get("dur", 0), e)
                   for e in events if e.get("cat") in DEVICE_CATS
                   and e.get("ph", "X") == "X"), key=lambda x: x[0])


def merge(intervals) -> list:
    """Disjoint, sorted [start, end] covering the given intervals."""
    out = []
    for a, b in sorted((a, b) for a, b, *_ in intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def covered(merged: list, lo: float, hi: float, starts=None) -> float:
    """The length of [lo, hi] that the disjoint sorted intervals cover
    (``starts``: their starts, where the caller has them)."""
    if starts is None:
        starts = [a for a, _ in merged]
    i = max(bisect.bisect_right(starts, lo) - 1, 0)
    total = 0.0
    while i < len(merged) and merged[i][0] < hi:
        a, b = merged[i]
        total += max(0.0, min(b, hi) - max(a, lo))
        i += 1
    return total


def complete(events, counter_delta: dict, known: set) -> tuple:
    """(whole, detail): whether, for every counter key whose kernel
    (``<key without <...>>_kernel``) is in ``known`` (the program's kernel
    names), the trace holds as many launches of it as the counter moved,
    and a text naming each that differs. Kernels that no counter counts
    are not compared."""
    seen = Counter(kernel_name(e.get("name", "")) for e in events
                   if e.get("cat") == "kernel")
    expect = {}
    for key, n in counter_delta.items():
        kname = key.split("<")[0] + "_kernel"
        if kname in known:
            expect[kname] = expect.get(kname, 0) + n
    diff = {k: (seen.get(k, 0), n) for k, n in expect.items()
            if seen.get(k, 0) != n}
    detail = ", ".join(f"{k}: traced {a} of {b}" for k, (a, b) in
                       sorted(diff.items()))
    return not diff, detail


@dataclass
class Summary:
    """What one traced window read: the window's length and its device
    busy time (s), each query's span, busy time and device operations, the
    device operations by name and the idle gaps by what the host was
    doing (s)."""
    window_s: float
    busy_s: float
    query_span_s: list = field(default_factory=list)
    query_busy_s: list = field(default_factory=list)
    query_ops: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def summarize(events, known=frozenset(), top: int = 10) -> Summary | None:
    """The traced window's Summary, or None where it holds no query span.
    Device operations are named by their kernel where it is one of the
    program's (``known``), else by their first 80 characters."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e.get("name") == QUERY_SPAN)
    if not spans:
        return None
    lo, hi = spans[0][0], spans[-1][1]
    dev = [d for d in _device_events(events) if d[1] > lo and d[0] < hi]
    merged = merge(dev)
    starts = [a for a, _, _ in dev]
    mstarts = [a for a, _ in merged]
    s = Summary(window_s=(hi - lo) * 1e-6,
                busy_s=covered(merged, lo, hi, mstarts) * 1e-6)
    for a, b in spans:
        s.query_span_s.append((b - a) * 1e-6)
        s.query_busy_s.append(covered(merged, a, b, mstarts) * 1e-6)
        s.query_ops.append(bisect.bisect_left(starts, b)
                           - bisect.bisect_left(starts, a))
    by_name = Counter()
    for a, b, e in dev:
        name = e.get("name", "")
        k = kernel_name(name)
        by_name[k if k in known else name[:80]] += min(b, hi) - max(a, lo)
    s.device_ops = [[k, v * 1e-6] for k, v in by_name.most_common(top)]
    s.idle_gaps = _idle_gaps(events, merged, spans, lo, hi, top)
    return s


def _idle_gaps(events, merged, spans, lo, hi, top) -> list:
    """The idle time of [lo, hi] summed by what the host was doing in the
    middle of each gap: '<benchmark span>: <innermost host operation>'."""
    host = sorted((e["ts"], e["ts"] + e.get("dur", 0), e.get("name", ""))
                  for e in events if e.get("cat") in HOST_CATS
                  and e.get("name") != QUERY_SPAN
                  and not e.get("name", "").startswith("ProfilerStep"))
    host_starts = [h[0] for h in host]
    span_starts = [a for a, _ in spans]
    gaps, prev = [], lo
    for a, b in merged + [[hi, hi]]:
        if a > prev:
            gaps.append((prev, min(a, hi)))
        prev = max(prev, b)
    by_label = Counter()
    for a, b in gaps:
        t = (a + b) / 2
        j = bisect.bisect_right(span_starts, t) - 1
        where = ("query" if j >= 0 and spans[j][1] >= t
                 else "between queries")
        i = bisect.bisect_right(host_starts, t)
        inner = None
        for h in host[max(0, i - _SCAN_BACK):i]:
            if h[1] >= t and (inner is None
                              or h[1] - h[0] < inner[1] - inner[0]):
                inner = h
        what = inner[2] if inner else "python"
        by_label[f"{where}: {what}"] += b - a
    return [[k, v * 1e-6] for k, v in by_label.most_common(top)]
