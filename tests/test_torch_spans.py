"""The port's spans and counters: ``runtime.span`` under a torch.profiler
and without one, the spans each BFS and SSSP variant nests in the trace
(``*.run`` over one ``bfs.level`` / ``sssp.sweep`` a level or sweep, over
its kernels' ``kernel.*`` spans and its host read ``*.read``), and the
counters ``kernels.counters`` keeps beside the launches: the form and
slots of each ``bfs_level`` on the card, and the vertices each SSSP sweep
relaxed and improved.

This file imports no jax; its card test runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from essentials_tpu_torch import kernels, runtime
from essentials_tpu_torch.algorithms import bfs, sssp
from essentials_tpu_torch.formats import Csr
from essentials_tpu_torch.graph import build_graph
from essentials_tpu_torch.io import generate, load_graph_file
from essentials_tpu_torch.ops import sparse_advance as SA

ROOT = Path(__file__).resolve().parent.parent
FORM_COUNTERS = ("bfs_level.push", "bfs_level.pull", "bfs_level.push_slots",
                 "bfs_level.pull_slots")
# (algorithm, variant, spray tiers open on the small graph)
CASES = [("bfs", v, False) for v in bfs.VARIANTS] + \
    [("bfs", v, True) for v in ("hybrid", "phased", "adaptive")] + \
    [("sssp", v, False) for v in ("windowed", "fused", "adaptive")] + \
    [("sssp", "adaptive", True)]
LEVEL = {"bfs": "bfs.level", "sssp": "sssp.sweep"}


@pytest.fixture(scope="module")
def graphs():
    csr = load_graph_file(str(ROOT / "datasets" / "chesapeake.mtx"),
                          cache=False)
    return {"bfs": build_graph(csr, directed=False, weighted=False,
                               device="cpu"),
            "sssp": build_graph(csr, directed=False, weighted=True,
                                device="cpu")}


def _run(graphs, algo, variant):
    mod = bfs if algo == "bfs" else sssp
    return mod.run(graphs[algo], 0, variant=variant, warmup=False)


def _spans(path) -> list:
    """The trace's user spans as (name, start, end), by start."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == "user_annotation"),
                  key=lambda s: (s[1], -s[2]))


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("name", ["bfs.level", "kernel.spmv_slabs",
                                  "sssp.sweep.read"])
def test_span_without_a_profiler_is_the_shared_null(name, monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function built without a profiler")
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    s = runtime.span(name)
    assert s is runtime.span("another")
    with s as inside:
        assert inside is None
    with s:                         # the one object serves again
        pass


@pytest.mark.parametrize("algo,variant,spray", CASES)
def test_spans_nest_by_level(algo, variant, spray, graphs, tmp_path,
                             monkeypatch):
    if spray:
        monkeypatch.setattr(SA, "_MIN_EDGES", 0)
    with runtime.trace(str(tmp_path)) as t:
        r = _run(graphs, algo, variant)
    spans = _spans(t.path)
    runs = [s for s in spans if s[0] == f"{algo}.run"]
    assert len(runs) == 1
    level = LEVEL[algo]
    levels = [s for s in spans if s[0] == level]
    assert len(levels) == r.iterations > 0
    assert all(_inside(s, runs[0]) for s in spans)
    for a, b in zip(levels, levels[1:]):
        assert a[2] <= b[1]                     # one after another
    reads = [s for s in spans if s[0] == level + ".read"]
    for s in reads:                             # each read in one level
        assert sum(_inside(s, lv) for lv in levels) == 1
    for lv in levels:
        held = [s for s in spans if s is not lv and _inside(s, lv)]
        assert any(s[0] == level + ".read" for s in held)
        assert all(s[0] in (level + ".read",) or s[0].startswith("kernel.")
                   for s in held), held
        if variant in ("fused", "fused8", "windowed") or (
                variant in ("hybrid", "phased") and not spray):
            # a dense level or full sweep: its one wrapper and its read
            kernel = {"bfs": "kernel.bfs_level", "sssp": {
                "windowed": "kernel.spmv_slabs",
                "fused": "kernel.sssp_sweep"}.get(variant)}[algo]
            assert [s[0] for s in held] == [kernel, level + ".read"]
    if variant != "adaptive":
        # every level holds a kernel span (the spray's operators too)
        assert all(any(s[0].startswith("kernel.") and _inside(s, lv)
                       for s in spans) for lv in levels)


@pytest.mark.parametrize("algo,variant", [("pr", "generic"),
                                          ("kcore", "adaptive"),
                                          ("hits", "generic")])
def test_other_enactor_loops_emit_no_level_span(algo, variant, graphs,
                                                tmp_path):
    """The shared enactor names no step: BFS's, SSSP's and k-core's steps
    are spans of their own, so another algorithm on it leaves only its
    wrappers' spans, and k-core only those and its own."""
    import importlib
    mod = importlib.import_module(f"essentials_tpu_torch.algorithms.{algo}")
    with runtime.trace(str(tmp_path)) as t:
        r = mod.run(graphs["bfs"], variant=variant, warmup=False)
    assert r.iterations > 0
    names = {s[0] for s in _spans(t.path)}
    own = ({"kcore.run", "kcore.wave", "kcore.wave.read"} if algo == "kcore"
           else set())
    assert own <= names
    assert all(n.startswith("kernel.") or n in own for n in names), names


@pytest.mark.parametrize("variant", ["windowed", "fused", "adaptive"])
def test_sweep_counters(variant, graphs):
    g = graphs["sssp"]
    kernels.reset_launches()
    r = sssp.run(g, 0, variant=variant, warmup=False)
    improved, swept = (kernels.counters["sssp.improved"],
                       kernels.counters["sssp.swept"])
    reached = int(torch.isfinite(r.distances).sum())
    assert reached - 1 <= improved <= swept
    if variant == "adaptive":
        # each round relaxes the frontier the round before improved
        assert swept == 1 + improved
    else:
        assert swept == r.iterations * g.n_vertices


@pytest.mark.parametrize("variant", bfs.VARIANTS)
def test_form_counters_stay_at_zero_on_the_plain_route(variant, graphs):
    kernels.reset_launches()
    r = bfs.run(graphs["bfs"], 0, variant=variant, warmup=False)
    assert r.iterations > 0
    assert all(kernels.counters[k] == 0 for k in FORM_COUNTERS)
    assert all(n == 0 for n in kernels.launches.values())


@pytest.mark.parametrize("algo,variant", [("bfs", "fused"),
                                          ("sssp", "windowed")])
def test_reset_launches_clears_every_counter(algo, variant, graphs):
    _run(graphs, algo, variant)
    kernels.counters["bfs_level.push"] += 3
    assert any(kernels.counters.values())
    kernels.reset_launches()
    assert not any(kernels.counters.values())


def test_plain_level_count_reads_the_count():
    cnt = torch.tensor([5], dtype=torch.int32)
    assert kernels.bfs_level_count(cnt) == 5


# ------------------------------------------------------------ the card --

def _level_sums(g, source: int, unreached: int) -> list:
    """(m_f, m_u, n_f) of each level of a fused search, on the host from
    the level arrays (chip_smoke's model of the pass)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    states, _ = cs.bfs_level_states(g, source, unreached)   # one a level
    return [cs.bfs_level_work(g, lev, it, unreached)
            for it, lev in enumerate(states)]


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(), reason="needs a CUDA card")
def test_level_forms_on_the_card(monkeypatch, tmp_path):
    """Under form "device" each bfs_level of a search counts the form the
    card wrote, the one chip_smoke's host model of the pass chooses, push
    + pull equal to the launches and the slots to the pass's sums;
    a forced form moves only its own counters; the distances are the
    same bits with a profiler on and off, and equal the host BFS's."""
    from essentials_tpu_torch.ops import fused_bfs as FB
    csr = Csr.from_coo(generate.rmat(14, 16, seed=5, undirected=True))
    g = build_graph(csr, directed=False, weighted=False, device="cuda")
    source = int(np.argmax(np.diff(csr.row_offsets)))
    want = bfs.cpu_reference(csr, source)
    for variant, unreached in (("fused", FB.UNREACHED),
                               ("fused8", FB.UNREACHED_E)):
        work = _level_sums(g, source, unreached)
        for form in kernels.BFS_FORMS:
            monkeypatch.setattr(kernels.bfs, "bfs_level_form",
                                lambda form=form: form)
            kernels.reset_launches()
            r = bfs.run(g, source, variant=variant, warmup=False)
            c = kernels.counters
            launched = sum(n for k, n in kernels.launches.items()
                           if k.startswith("bfs_level<"))
            assert c["bfs_level.push"] + c["bfs_level.pull"] == launched \
                == r.iterations, (variant, form)
            pulls = [form == "pull" or form == "device" and w["pulls"]
                     for w in work]
            assert c["bfs_level.pull"] == sum(pulls), (variant, form)
            assert c["bfs_level.push_slots"] == sum(
                w["m_f"] for w, p in zip(work, pulls) if not p)
            assert c["bfs_level.pull_slots"] == sum(
                w["m_u"] for w, p in zip(work, pulls) if p)
            if form != "device":
                other = "push" if form == "pull" else "pull"
                assert c[f"bfs_level.{other}"] == 0
                assert c[f"bfs_level.{other}_slots"] == 0
            assert np.array_equal(r.distances.cpu().numpy(), want)
        monkeypatch.undo()
        off = bfs.run(g, source, variant=variant, warmup=False)
        with runtime.trace(str(tmp_path / variant)) as t:
            on = bfs.run(g, source, variant=variant, warmup=False)
        assert torch.equal(off.distances, on.distances)
        assert torch.equal(off.predecessors, on.predecessors)
        levels = [s for s in _spans(t.path) if s[0] == "bfs.level"]
        assert len(levels) == on.iterations
    assert sum(w["pulls"] for w in work) > 0     # both forms ran
    assert sum(not w["pulls"] for w in work) > 0
