"""One run of one cell: set-up, the measured window, the check, the result.

A cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration (``configs/<name>.json``: a graph generator and its sizes)
and a traffic mix (``traffic/<name>.json``: which algorithm's queries, how
sources are drawn, how many answers are checked). The algorithm's module
(``algos/<name>.py``) holds its entry into the program, the bytes a query
must move and its reference. Each metric is read by ``metrics/<name>.py``.
So a new graph, mix or metric is new files and new entries, found by name.

Set-up makes the graph on the device from the seed, then the query sources
from the seed, then warms the program with the cell's own query. The window
is one closed-loop client: each query is timed on the host's clock from
just before the call to just after ``torch.cuda.synchronize()``. After the
window the program's state is freed, and a sample of the answers, drawn
from the seed, is held against the reference.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import random
import re
import subprocess
import sys
import tempfile
import time
import traceback
from contextlib import contextmanager
from dataclasses import dataclass
from pathlib import Path

import torch

from graphbench import graphs, trace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
PROGRAM = "essentials_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "essentials_tpu")
TRACE_TAKES = 3
# the check's numbers and their limits: a run is correct where each holds
LIMITS = {"answer_mismatch": 0, "inputs_changed": 0, "failed": 0,
          "unchecked": 0}
# which vertices a mix draws its sources from, uniformly, by their degrees
SOURCE_RULES = {"degree_at_least_1": lambda deg: deg > 0}   # Graph500's


# ----------------------------------------------------------------- cells --

@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: list
    per_layer: list

    @property
    def algo(self):
        return importlib.import_module(
            f"graphbench.algos.{self.traffic['algorithm']}")


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell named ``workload`` in ``root``'s BENCHMARK.json, with its
    configuration, traffic mix (``graphbench/traffic/<name>.json`` under
    ``root``) and the benchmark's metrics. A metric whose reader finds
    nothing to read in a cell is left out of its result."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; "
                         f"known: {', '.join(sorted(cells))}")
    w = cells[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((root / configs[w["config"]]["file"]).read_text())
    mix = json.loads((root / BENCH_DIR.name / "traffic"
                      / f"{w['traffic']}.json").read_text())
    return Cell(workload, cfg, mix, w["chips"], bench["end_to_end"],
                bench["per_layer"])


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """``metrics/<name>.py``'s ``read``, loaded by its path (a metric's name
    may hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    module = "graphbench_metric_" + re.sub(r"\W", "_", name)
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ----------------------------------------------------------------- spans --

class Spans:
    """The benchmark's own spans (set-up phases), kept in memory and
    written once at the end."""

    def __init__(self, t0: float):
        self.t0 = t0
        self.items = []

    @contextmanager
    def span(self, name: str, sync=lambda: None):
        start = time.perf_counter()
        yield
        sync()
        self.items.append([name, start - self.t0,
                           time.perf_counter() - self.t0])

    def line(self) -> str:
        return ", ".join(f"{n} {b - a:.3f} s" for n, a, b in self.items)


@dataclass
class Query:
    """One query: its source, host wall time, levels or sweeps, the
    undirected edges of its component, the bytes it must move, and, in a
    whole traced window, its span, device-busy time and device operations
    from the trace."""
    source: int
    wall_s: float
    levels: int
    edges: int
    bytes: int
    span_s: float | None = None
    busy_s: float | None = None
    ops: int | None = None


@dataclass
class Run:
    """What the metric readers read."""
    cell: Cell
    setup_s: float
    window_s: float
    queries: list
    device_kind: str = ""
    trace: trace.Summary | None = None     # None: not traced or not whole


class Reservoir:
    """A sample of ``k`` answers from a stream of unknown length, drawn
    from the seed (Algorithm R); each kept answer is a copy."""

    def __init__(self, k: int, seed: int):
        self.k, self.seen, self.items = k, 0, []
        self.rng = random.Random(graphs.sub_seed(seed, "check sample"))

    def offer(self, source: int, answer: tuple) -> None:
        i, self.seen = self.seen, self.seen + 1
        if i < self.k:
            self.items.append((source, tuple(t.clone() for t in answer)))
            return
        j = self.rng.randrange(i + 1)
        if j < self.k:
            self.items[j] = (source, tuple(t.clone() for t in answer))


# ------------------------------------------------------------ the window --

def _sync_fn(device):
    return (torch.cuda.synchronize if torch.device(device).type == "cuda"
            else (lambda: None))


def _query_once(cell, g, src, info, sync, queries, sample, failed) -> int:
    """One query, timed from just before the call to just after the
    device's synchronize. Returns failures so far."""
    t0 = time.perf_counter()
    try:
        result = cell.algo.query(g, src, cell.traffic["variant"])
        sync()
    except Exception:                       # a failed query is counted
        traceback.print_exc(file=sys.stderr)
        return failed + 1
    wall = time.perf_counter() - t0
    edges = info[src]
    queries.append(Query(src, wall, cell.algo.levels(result), edges,
                         cell.algo.query_bytes(g.n_vertices, edges)))
    sample.offer(src, cell.algo.answer(result))
    return failed


def window(cell, g, sources, info, seconds, sync, sample) -> tuple:
    """The closed loop: queries back to back until ``seconds`` have
    passed. Returns (queries, failed, window seconds to the last query's
    end)."""
    queries, failed, i = [], 0, 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        failed = _query_once(cell, g, sources[i % len(sources)], info,
                             sync, queries, sample, failed)
        i += 1
    return queries, failed, time.perf_counter() - t0


def program_kernels() -> set:
    """The names of the program's device kernels, from its CUDA sources."""
    names = set()
    for path in (ROOT / PROGRAM / "csrc").glob("*.cu*"):
        names.update(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(",
                                path.read_text()))
    return names


def _counters() -> dict:
    from essentials_tpu_torch import kernels
    return {**kernels.launches, **kernels.pass_launches}


def traced_window(cell, g, sources, info, seconds, sync, sample) -> tuple:
    """The window under torch.profiler, taken again (at most TRACE_TAKES
    times in all) where the trace lost any of the program's launches.
    Returns (the whole take's queries, the count of answered queries in
    all takes, failed, window seconds, Summary or None, a note)."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)
    known = program_kernels()
    all_q, failed, note, i = [], 0, "", 0
    for take in range(TRACE_TAKES):
        queries, warm = [], []
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1,
                                       repeat=1)) as prof:
            # a step that starts the device tracing before the window
            failed = _query_once(cell, g, sources[i % len(sources)], info,
                                 sync, warm, sample, failed)
            i += 1
            prof.step()
            before = _counters()
            t0 = time.perf_counter()
            while time.perf_counter() - t0 < seconds:
                with record_function(trace.QUERY_SPAN):
                    failed = _query_once(cell, g,
                                         sources[i % len(sources)], info,
                                         sync, queries, sample, failed)
                i += 1
            wall = time.perf_counter() - t0
            delta = {k: v - before.get(k, 0) for k, v in _counters().items()}
            prof.step()
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            events = trace.load(path)
        finally:
            os.unlink(path)
        all_q += warm + queries
        whole, detail = trace.complete(events, delta, known)
        summary = trace.summarize(events, known)
        if (whole and summary is not None
                and len(summary.query_span_s) == len(queries)):
            for q, span, busy, ops in zip(queries, summary.query_span_s,
                                          summary.query_busy_s,
                                          summary.query_ops):
                q.span_s, q.busy_s, q.ops = span, busy, ops
            return (queries, len(all_q), failed, wall, summary,
                    f"take {take + 1}")
        note += f"take {take + 1} not whole ({detail or 'no query spans'}); "
    return (queries, len(all_q), failed, wall, None,
            note + "trace metrics not measured")


# ------------------------------------------------------------- the check --

def differs(got: torch.Tensor, want: torch.Tensor) -> torch.Tensor:
    """[n] bool: the entries that differ, floats by their bits; all of
    them where the shapes or types differ."""
    if got.shape != want.shape or got.dtype != want.dtype:
        return torch.ones(want.shape, dtype=torch.bool, device=want.device)
    if want.is_floating_point():
        got, want = got.view(torch.int32), want.view(torch.int32)
    return got.to(want.device) != want


def answer_mismatch(got: tuple, want: tuple) -> tuple:
    """(the vertices whose answer differs in any part, [each part's
    count of differing entries])."""
    masks = [differs(a, b) for a, b in zip(got, want)]
    return int(torch.stack(masks).any(0).sum()), [int(m.sum()) for m in masks]


def holds(name: str, value: int) -> bool:
    """Whether the check's number ``name`` reads within its limit."""
    return value <= LIMITS[name]


def check(cell, csr, items) -> int:
    """The worst count, over the sampled queries, of vertices whose answer
    (every part: BFS and SSSP distance and predecessor) differs from the
    reference's."""
    src = graphs.rows_of(csr)
    worst = 0
    for source, got in items:
        n, parts = answer_mismatch(got, cell.algo.expected(csr, src, source))
        if n:
            log(f"check: source {source}: {n} vertices differ ("
                + ", ".join(f"{k} {c}" for k, c in zip(cell.algo.ANSWER,
                                                        parts)) + ")")
        worst = max(worst, n)
    return worst


# -------------------------------------------------------------- the run --

@dataclass
class Prepared:
    """A cell's graph and query sources, made from the seed: the program's
    Graph fields and metadata, the benchmark's CSR view of them, the pool
    of sources, each source's component edges (undirected), the warm
    query's source (the first of the pool in the largest component) and
    that component's edges."""
    fields: dict
    meta: dict
    csr: graphs.Csr
    sources: list
    info: dict
    warm_source: int
    giant_edges: int


def prepare(cell: Cell, seed: int, device, spans: Spans | None = None,
            sync=lambda: None) -> Prepared:
    spans = spans or Spans(time.perf_counter())
    with spans.span("graph", sync):
        fields, meta = graphs.make(cell.config, seed, device)
    csr = graphs.csr_of(fields, meta)
    with spans.span("components", sync):
        label, per_root = graphs.components(csr)
    with spans.span("sources", sync):
        gen = graphs.generator(seed, "sources", device)
        deg = csr.row_offsets[1:] - csr.row_offsets[:-1]
        cand = torch.nonzero(SOURCE_RULES[cell.traffic["sources"]](deg))
        cand = cand.flatten()
        pick = torch.randint(0, cand.numel(), (cell.traffic["source_pool"],),
                             generator=gen, device=device)
        pool = cand[pick]
        roots = label[pool]
        sources = pool.tolist()
        info = dict(zip(sources, per_root[roots].tolist()))
        giant = int(torch.argmax(per_root))
        warm = next((s for s, r in zip(sources, roots.tolist())
                     if r == giant), sources[0])
        giant_edges = int(per_root[giant])
    return Prepared(fields, meta, csr, sources, info, warm, giant_edges)


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as err:
        return f"nvidia-smi: {err!r}"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool,
             device: str = "cuda", t0: float | None = None) -> dict:
    """One run of ``cell``; returns the result line's object. ``device``
    is "cuda" on the chip; the CPU tests pass "cpu" and small cells."""
    t0 = time.perf_counter() if t0 is None else t0
    spans = Spans(t0)
    # the interpreter, torch's import and the look for a card
    spans.items.append(["start", 0.0, time.perf_counter() - t0])
    sync = _sync_fn(device)
    cuda = torch.device(device).type == "cuda"
    with spans.span("program import"):
        program = importlib.import_module(PROGRAM)
    if Path(program.__file__).resolve().parent != ROOT / PROGRAM:
        raise SystemExit(f"the program was imported from {program.__file__},"
                         f" not from this checkout")
    mix, algo = cell.traffic, cell.algo
    st = prepare(cell, seed, device, spans, sync)
    fields, meta, csr, sources, info = (st.fields, st.meta, st.csr,
                                        st.sources, st.info)
    with spans.span("fingerprint"):
        fingerprint = graphs.fingerprint(csr)
    g = graphs.program_graph(fields, meta)
    if cuda:
        torch.cuda.empty_cache()
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    with spans.span("warm", sync):
        _, note = algo.warm(g, st.warm_source, mix["variant"])
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    log(f"setup: {cell.name} seed {seed}: V {meta['n_vertices']}, E "
        f"{meta['n_edges']} directed, max degree {meta['max_degree']}, "
        f"giant component {st.giant_edges} undirected edges; {note}; "
        f"{spans.line()}; set-up peak {setup_peak} bytes; "
        f"{power_limit() if cuda else 'cpu'}")

    sample = Reservoir(mix["check_sample"], seed)
    setup_s = time.perf_counter() - t0
    if traced:
        queries, answered, failed, window_s, summary, tnote = traced_window(
            cell, g, sources, info, min(seconds, mix["trace_seconds"]),
            sync, sample)
        log(f"trace: {tnote}")
    else:
        queries, failed, window_s = window(cell, g, sources, info, seconds,
                                           sync, sample)
        answered, summary = len(queries), None
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    kind = torch.cuda.get_device_name(0) if cuda else "cpu"
    walls = sorted(q.wall_s for q in queries)
    if walls:
        log(f"window: {len(queries)} queries, {failed} failed, "
            f"{window_s:.3f} s; query ms median "
            f"{1e3 * walls[len(walls) // 2]:.4f}, max {1e3 * walls[-1]:.4f}; "
            f"levels mean {sum(q.levels for q in queries) / len(queries):.2f}")

    # the program's state goes before the reference runs
    del g
    keep = {"row_offsets", "col_indices", "values"}
    for k in [k for k in fields if k not in keep]:
        del fields[k]
    if cuda:
        torch.cuda.empty_cache()
    with spans.span("check", sync):
        worst = check(cell, csr, sample.items)
        changed = int(graphs.fingerprint(csr) != fingerprint)
    readings = {"answer_mismatch": worst, "inputs_changed": changed,
                "failed": failed, "unchecked": int(not sample.items)}
    checks = {k: {"value": v, "limit": LIMITS[k]} for k, v in readings.items()}
    correct = all(holds(k, v) for k, v in readings.items())

    run = Run(cell, setup_s, window_s, queries, kind, summary)
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = metric_reader(m["name"])(run) if queries else None
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": kind, "count": 1,
           "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": answered + failed,
           "failed": failed, "metrics": metrics, "device": dev}
    if traced and summary is not None:
        dev["busy_s"], dev["window_s"] = summary.busy_s, summary.window_s
        out["breakdown"] = {"device_ops": summary.device_ops,
                            "idle_gaps": summary.idle_gaps}
    out["checks"] = checks
    _write_spans(cell, seed, traced, spans, queries)
    for name, c in checks.items():
        log(f"check {name} {c['value']} limit {c['limit']}")
    return out


def _write_spans(cell, seed, traced, spans, queries) -> None:
    """The benchmark's spans, written once, inside the checkout."""
    out = ROOT / "build" / "graphbench"
    out.mkdir(parents=True, exist_ok=True)
    path = out / f"{cell.name}.{seed}.trace{int(traced)}.spans.json"
    path.write_text(json.dumps({"setup": spans.items,
                                "query_wall_s": [q.wall_s for q in queries]}))


def forbidden_modules() -> list:
    """Top-level names in sys.modules that the run must not load, compared
    whole (``essentials_tpu_torch`` is not ``essentials_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))
