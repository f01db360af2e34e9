"""k-core on the benchmark's graphs, on the CPU: ``kcore.run`` (``fused``
and ``adaptive``, on the plain route) against the benchmark's plain
reference (``graphbench/reference_kcore.py``) and the port's NumPy
``cpu_reference``, bit for bit, on Kronecker and uniform graphs from
``graphbench.graphs.make``; and the spans and counters a run leaves under
torch.profiler (``kcore.run`` over one ``kcore.wave`` a wave, each holding
its read ``kcore.wave.read``; ``kernels.counters``' ``kcore.waves``,
``kcore.peeled`` and ``kcore.levels``).

This file imports no jax."""

import json

import numpy as np
import pytest
import torch

from essentials_tpu_torch import kernels, runtime
from essentials_tpu_torch.algorithms import kcore
from essentials_tpu_torch.formats import Csr
from graphbench import graphs, reference_kcore

KRON = {"generator": "kronecker", "edge_factor": 16, "a": 0.57, "b": 0.19,
        "c": 0.19}
URAND = {"generator": "uniform", "edge_factor": 16}
SEEDS = (1, 2, 2**31 + 5)
GRAPHS = [("kron", s, seed) for s in (8, 10, 12) for seed in SEEDS] + \
    [("urand", 10, seed) for seed in SEEDS]
_cache = {}


def _graph(kind: str, scale: int, seed: int) -> tuple:
    """(the program's Graph, the benchmark's Csr, the port's host Csr) of a
    configuration's graph, made once a module."""
    key = (kind, scale, seed)
    if key not in _cache:
        cfg = dict(KRON if kind == "kron" else URAND, scale=scale)
        fields, meta = graphs.make(cfg, seed, "cpu")
        c = graphs.csr_of(fields, meta)
        host = Csr(c.n, c.n, c.row_offsets.numpy(), c.col.numpy(),
                   c.values.numpy())
        _cache[key] = (graphs.program_graph(fields, meta), c, host)
    return _cache[key]


def _degrees(csr) -> torch.Tensor:
    return csr.row_offsets[1:] - csr.row_offsets[:-1]


@pytest.mark.parametrize("variant", kcore.VARIANTS)
@pytest.mark.parametrize("kind,scale,seed", GRAPHS)
def test_run_equals_the_plain_reference(kind, scale, seed, variant):
    g, csr, host = _graph(kind, scale, seed)
    want = reference_kcore.kcore(csr)
    got = kcore.run(g, variant=variant, warmup=False).core
    assert got.dtype == want.dtype == torch.int32
    assert torch.equal(got, want)
    assert np.array_equal(want.numpy(), kcore.cpu_reference(host))
    assert int(want[_degrees(csr) == 0].abs().sum()) == 0


@pytest.mark.parametrize("kind,scale,seed", GRAPHS[:3] + GRAPHS[-1:])
def test_control_peels_a_level_late(kind, scale, seed):
    """One wave a level: every answer it gets wrong is too high (a vertex
    peeled late keeps its neighbours' degrees up), and it gets some
    wrong."""
    _, csr, _ = _graph(kind, scale, seed)
    want = reference_kcore.kcore(csr)
    diff = reference_kcore.kcore(csr, cascade=False) - want
    assert int((diff != 0).sum()) > 0
    assert int(diff.min()) == 0


def test_reference_on_a_triangle_with_a_tail():
    """A triangle 0-1-2 with a path 2-3-4 and vertex 5 alone: the tail
    peels at k = 2 in two waves (4, then 3), the triangle at k = 3. The
    control peels 3 a level late with 0 and 1, which leaves 2 for k = 4."""
    pairs = [(0, 1), (0, 2), (1, 2), (2, 3), (3, 4)]
    edges = sorted(pairs + [(v, u) for u, v in pairs])
    off = torch.tensor([0, 2, 4, 7, 9, 10, 10], dtype=torch.int32)
    csr = graphs.Csr(6, off, torch.tensor([v for _, v in edges],
                                          dtype=torch.int32),
                     torch.ones(len(edges)))
    assert reference_kcore.kcore(csr).tolist() == [2, 2, 2, 1, 1, 0]
    assert reference_kcore.kcore(csr, cascade=False).tolist() == \
        [2, 2, 3, 2, 1, 0]


def _spans(path) -> list:
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("variant", kcore.VARIANTS)
@pytest.mark.parametrize("kind,scale,seed", [("kron", 10, 2),
                                             ("urand", 10, 1)])
def test_spans_and_counters(kind, scale, seed, variant, tmp_path):
    g, csr, _ = _graph(kind, scale, seed)
    want = reference_kcore.kcore(csr)
    kernels.reset_launches()
    with runtime.trace(str(tmp_path)) as t:
        r = kcore.run(g, variant=variant, warmup=False)
    spans = _spans(t.path)
    runs = [s for s in spans if s[0] == "kcore.run"]
    waves = [s for s in spans if s[0] == "kcore.wave"]
    reads = [s for s in spans if s[0] == "kcore.wave.read"]
    assert len(runs) == 1
    assert len(waves) == len(reads) == r.iterations > 0
    assert all(_inside(s, runs[0]) for s in spans)
    for a, b in zip(waves, waves[1:]):
        assert a[2] <= b[1]                     # one after another
    for s in reads:                             # each read in one wave
        assert sum(_inside(s, w) for w in waves) == 1
    c = kernels.counters
    peels = _degrees(csr) > 0
    if variant == "adaptive":                   # degree 0 peels at k = 1
        peels = torch.ones_like(peels)
    assert c["kcore.peeled"] == int(peels.sum())
    assert c["kcore.waves"] == r.iterations
    assert c["kcore.levels"] == int(want[peels].unique().numel())


def test_counters_add_up_over_runs():
    """The counters hold every run since ``reset_launches``: a run with its
    warm-up counts twice."""
    g, _, _ = _graph("kron", 8, 1)
    kernels.reset_launches()
    r = kcore.run(g, warmup=False)
    once = {k: kernels.counters[k] for k in ("kcore.waves", "kcore.peeled",
                                             "kcore.levels")}
    kernels.reset_launches()
    kcore.run(g, warmup=True)
    assert all(kernels.counters[k] == 2 * v for k, v in once.items())
    assert once["kcore.waves"] == r.iterations
    kernels.reset_launches()
    assert not any(kernels.counters.values())
