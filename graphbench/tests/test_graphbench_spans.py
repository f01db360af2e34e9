"""The program's spans and counters as the benchmark sees them, on the CPU:
program spans in a trace leave what the current readers read unchanged
and name the idle gaps they hold, the completeness check passes over the
program's counters, and ``sweep_improved_share`` and
``level_slots_per_edge`` read them."""

import pytest

from graphbench import harness, trace
from graphbench.harness import Query, Run
from graphbench.tests.helpers import small_cell

KNOWN = {"bfs_level_kernel", "spmv_slabs_kernel"}
READERS = ("levels_per_query", "host_ms_per_level", "device_ops_per_query",
           "query_roofline", "device_idle_share")
SEED = 2**32 + 11


def _x(name, ts, dur, cat):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _base() -> list:
    """Two queries of two BFS levels each: a kernel a level, the host's
    read at the end of each level, a gap at each level's start."""
    ev = []
    for q in (0, 200):
        ev.append(_x(trace.QUERY_SPAN, q, 150, "user_annotation"))
        for lv in (q + 10, q + 80):
            ev.append(_x("void (anonymous namespace)::bfs_level_kernel<int>"
                         "(int)", lv + 20, 30, "kernel"))
            ev.append(_x("aten::item", lv + 45, 15, "cpu_op"))
    return ev


def _program_spans() -> list:
    """The program's spans over ``_base``'s queries, on the host and, as
    torch.profiler writes them too, on the device's timeline."""
    ev = []
    for q in (0, 200):
        ev.append(_x("bfs.run", q + 2, 140, "user_annotation"))
        for lv in (q + 10, q + 80):
            ev.append(_x("bfs.level", lv, 62, "user_annotation"))
            ev.append(_x("kernel.bfs_level", lv + 2, 18, "user_annotation"))
            ev.append(_x("bfs.level.read", lv + 40, 21, "user_annotation"))
            ev.append(_x("bfs.level", lv + 20, 30, "gpu_user_annotation"))
    return ev


def _readings(events) -> dict:
    s = trace.summarize(events, KNOWN)
    qs = [Query(0, span, 2, 1000, 8000, span, busy, ops)
          for span, busy, ops in zip(s.query_span_s, s.query_busy_s,
                                     s.query_ops)]
    run = Run(cell=None, setup_s=1.0, window_s=s.window_s, queries=qs,
              device_kind="NVIDIA H100 80GB HBM3", trace=s)
    return s, {n: harness.metric_reader(n)(run) for n in READERS}


@pytest.mark.parametrize("field", ["window_s", "busy_s", "query_span_s",
                                   "query_busy_s", "query_ops",
                                   "device_ops"])
def test_program_spans_leave_the_summary_unchanged(field):
    before, _ = _readings(_base())
    after, _ = _readings(_base() + _program_spans())
    assert getattr(after, field) == getattr(before, field)


@pytest.mark.parametrize("name", READERS)
def test_program_spans_leave_the_readers_unchanged(name):
    _, before = _readings(_base())
    _, after = _readings(_base() + _program_spans())
    assert before[name] is not None
    assert after[name] == before[name]


def test_idle_gaps_name_the_program_spans():
    before, _ = _readings(_base())
    after, _ = _readings(_base() + _program_spans())
    gaps = dict(after.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(sum(dict(before.idle_gaps)
                                                   .values()))
    # the first level's start, before its kernel: the wrapper's span; the
    # gaps between levels: the level's own
    assert gaps["query: kernel.bfs_level"] == pytest.approx(30e-6)
    assert gaps["query: bfs.level"] == pytest.approx(80e-6)
    assert "query: python" not in gaps
    assert dict(before.idle_gaps)["query: python"] == pytest.approx(110e-6)


@pytest.mark.parametrize("key", ["bfs_level.push", "bfs_level.pull",
                                 "bfs_level.push_slots",
                                 "bfs_level.pull_slots", "sssp.swept",
                                 "sssp.improved"])
def test_complete_passes_over_the_program_counters(key):
    events = _base()
    delta = {"bfs_level<int32>": 4, key: 7}
    assert trace.complete(events, delta, KNOWN) == (True, "")
    whole, detail = trace.complete(events, dict(delta, spmv_slabs=1), KNOWN)
    assert not whole and detail == "spmv_slabs_kernel: traced 0 of 1"


@pytest.mark.parametrize("improved,swept,want", [(3, 40, 7.5), (0, 40, 0.0),
                                                 (5, 0, None)])
def test_sweep_improved_share(improved, swept, want, monkeypatch):
    from essentials_tpu_torch import kernels
    monkeypatch.setattr(kernels, "counters",
                        {"sssp.improved": improved, "sssp.swept": swept})
    got = harness.metric_reader("sweep_improved_share")(None)
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("push,pull,edges,want", [(30, 10, (5, 15), 1.0),
                                                 (0, 8, (4,), 1.0),
                                                 (7, 0, (2, 3, 5), 0.35),
                                                 (0, 0, (5,), None),
                                                 (9, 3, (), None)])
def test_level_slots_per_edge(push, pull, edges, want, monkeypatch):
    from essentials_tpu_torch import kernels
    monkeypatch.setattr(kernels, "counters",
                        {"bfs_level.push_slots": push,
                         "bfs_level.pull_slots": pull})
    run = Run(cell=None, setup_s=1.0, window_s=1.0,
              queries=[Query(0, 0.01, 3, e, 8 * e) for e in edges])
    got = harness.metric_reader("level_slots_per_edge")(run)
    assert got == (pytest.approx(want) if want is not None else None)


@pytest.mark.parametrize("name", ["sweep_improved_share",
                                  "level_slots_per_edge"])
def test_counter_readers_without_the_counters(name, monkeypatch):
    from essentials_tpu_torch import kernels
    monkeypatch.delattr(kernels, "counters")
    run = Run(cell=None, setup_s=1.0, window_s=1.0,
              queries=[Query(0, 0.01, 3, 10, 80)])
    assert harness.metric_reader(name)(run) is None


@pytest.mark.parametrize("name,reads", [("urand24.sssp", True),
                                        ("kron24.bfs", False)])
def test_counter_readers_in_a_traced_run(name, reads, fresh_auto):
    """A traced run on the CPU reads the sweep share in an SSSP cell, where
    the program's sweeps counted, and leaves out the level slots, which
    count only on the card, in either cell."""
    from essentials_tpu_torch import kernels
    kernels.reset_launches()
    out = harness.run_cell(small_cell(name, scale=8), SEED, 0.3, True, "cpu")
    assert out["correct"], out["checks"]
    assert ("sweep_improved_share" in out["metrics"]) == reads
    assert "level_slots_per_edge" not in out["metrics"]
    if reads:
        assert 0 < out["metrics"]["sweep_improved_share"]["value"] < 100
