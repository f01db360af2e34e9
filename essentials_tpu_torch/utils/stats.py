"""Run statistics: MTEPS, workload, JSON export.

Counterpart of ``essentials_tpu/utils/stats.py``: the same fields in the
same order, and the same useful-bytes model. The reference declared this
collector and never implemented it (util::stats::log stub,
util/info.hxx:33-96).
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
from dataclasses import dataclass, field
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent.parent


def _git_sha() -> str:
    """The checkout's commit (reference parity: the gitsha1 embed of
    CMakeLists.txt:133-136), "unknown" outside a git checkout."""
    try:
        return subprocess.run(["git", "rev-parse", "--short", "HEAD"],
                              capture_output=True, text=True, cwd=_ROOT,
                              timeout=5).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


@dataclass
class RunStats:
    algorithm: str
    dataset: str
    n_vertices: int
    n_edges: int
    elapsed_ms: float
    iterations: int = 0
    edges_visited: int = 0           # total relaxations across supersteps
    vertices_visited: int = 0
    search_depth: int = 0
    mteps: float = 0.0               # millions of traversed edges per second
    redundance: float = 0.0          # edges_visited / n_edges
    gbps_effective: float = 0.0      # useful bytes / s (see collect_stats)
    hbm_gbps: float = 0.0            # device HBM roofline
    pct_hbm_roofline: float = 0.0    # gbps_effective / hbm_gbps
    cycles_ms: list = field(default_factory=list)  # every measured run
    backend: str = ""
    git_sha: str = field(default_factory=_git_sha)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def collect_stats(algorithm: str, dataset: str, graph, elapsed_ms: float,
                  iterations: int, edges_visited: int | None = None,
                  vertices_visited: int = 0,
                  cycles_ms: list | None = None) -> RunStats:
    """gbps_effective uses a USEFUL-bytes model, the bytes an ideal
    gather-capable machine would have to move: 12 B per visited edge of a
    weighted graph (index + weight + one gathered value), 8 B unweighted.
    pct_hbm_roofline divides it by the card's data-sheet memory rate
    (``runtime.DeviceProperties.hbm_gbps``; 0 on the CPU, where both read
    0). ``graph`` gives the counts, ``properties.weighted`` and the device
    (``graph.device``)."""
    from essentials_tpu_torch import runtime
    backend = runtime.backend(graph.device)
    ev = (int(edges_visited) if edges_visited is not None
          else graph.n_edges * max(iterations, 1))
    mteps = (ev / 1e6) / (elapsed_ms / 1e3) if elapsed_ms > 0 else 0.0
    bpe = 12.0 if graph.properties.weighted else 8.0
    gbps = (ev * bpe / 1e9) / (elapsed_ms / 1e3) if elapsed_ms > 0 else 0.0
    hbm = (runtime.device_properties(graph.device).hbm_gbps
           if backend == "cuda" else 0.0)
    return RunStats(
        algorithm=algorithm, dataset=dataset,
        n_vertices=graph.n_vertices, n_edges=graph.n_edges,
        elapsed_ms=elapsed_ms, iterations=iterations,
        edges_visited=ev, vertices_visited=int(vertices_visited),
        search_depth=iterations, mteps=mteps,
        redundance=ev / max(graph.n_edges, 1),
        gbps_effective=round(gbps, 3), hbm_gbps=hbm,
        pct_hbm_roofline=round(gbps / hbm, 4) if hbm else 0.0,
        cycles_ms=[round(c, 3) for c in (cycles_ms or [elapsed_ms])],
        backend=backend,
    )
