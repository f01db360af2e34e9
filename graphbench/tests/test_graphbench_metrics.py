"""The metric readers, the byte models and the cell registry, on the CPU."""

import json

import pytest

from graphbench import harness, trace
from graphbench.algos import bfs, sssp
from graphbench.harness import Query, Run


def _run(queries, window_s=1.0, summary=None, kind="NVIDIA H100 80GB HBM3"):
    return Run(cell=None, setup_s=12.5, window_s=window_s, queries=queries,
               device_kind=kind, trace=summary)


def _q(wall, edges=10, levels=2, nbytes=100, span=None, busy=None, ops=None):
    return Query(0, wall, levels, edges, nbytes, span, busy, ops)


def test_byte_models():
    assert bfs.query_bytes(1000, 5000) == 4 * 5000 + 8 * 1000
    assert sssp.query_bytes(1000, 5000) == 8 * 5000 + 8 * 1000


def test_gteps_is_total_over_total():
    """All edges over all the window's time, not a mean of the queries'
    rates: a slow query weighs by its time."""
    qs = [_q(0.001, edges=1_000_000), _q(0.1, edges=1_000_000)]
    got = harness.metric_reader("gteps")(_run(qs, window_s=0.2))
    assert got == pytest.approx(2_000_000 / 0.2 / 1e9)


def test_p95_over_all_queries():
    qs = [_q(ms / 1e3) for ms in range(100, 0, -1)]
    assert harness.metric_reader("query_p95_ms")(_run(qs)) == pytest.approx(95)
    qs = [_q(0.001)] * 19 + [_q(0.5)]
    assert harness.metric_reader("query_p95_ms")(_run(qs)) == pytest.approx(1)
    assert harness.metric_reader("query_p95_ms")(_run([])) is None


def test_setup_and_levels():
    qs = [_q(0.1, levels=3), _q(0.1, levels=6)]
    assert harness.metric_reader("setup_s")(_run(qs)) == 12.5
    assert harness.metric_reader("levels_per_query")(_run(qs)) == 4.5


TRACED = ("host_ms_per_level", "device_ops_per_query", "query_roofline",
          "device_idle_share")


@pytest.mark.parametrize("name", TRACED)
def test_trace_metrics_need_a_whole_trace(name):
    qs = [_q(0.01, span=0.01, busy=0.005, ops=4)]
    assert harness.metric_reader(name)(_run(qs)) is None


def test_trace_metrics():
    summary = trace.Summary(window_s=0.03, busy_s=0.012)
    qs = [_q(0.01, levels=4, nbytes=3.35e12 * 0.001, span=0.01, busy=0.004,
             ops=10),
          _q(0.02, levels=6, nbytes=3.35e12 * 0.002, span=0.02, busy=0.008,
             ops=20)]
    run = _run(qs, summary=summary)
    read = {n: harness.metric_reader(n)(run) for n in TRACED}
    assert read["host_ms_per_level"] == pytest.approx(1e3 * 0.018 / 10)
    assert read["device_ops_per_query"] == 15
    assert read["query_roofline"] == pytest.approx(100 * 0.003 / 0.012)
    assert read["device_idle_share"] == pytest.approx(60)
    other = _run(qs, summary=summary, kind="some other card")
    assert harness.metric_reader("query_roofline")(other) is None


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a mix and a metric added as files, with their
    entries in BENCHMARK.json, are found by name: no code changes."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    (tmp_path / "graphbench" / "configs").mkdir(parents=True)
    (tmp_path / "graphbench" / "traffic").mkdir()
    (tmp_path / "graphbench" / "metrics").mkdir()
    cfg = dict(json.loads((harness.BENCH_DIR / "configs" / "kron24.json")
                          .read_text()), name="kron9", scale=9)
    (tmp_path / "graphbench" / "configs" / "kron9.json").write_text(
        json.dumps(cfg))
    mix = dict(json.loads((harness.BENCH_DIR / "traffic" / "bfs.json")
                          .read_text()), check_sample=2)
    (tmp_path / "graphbench" / "traffic" / "bfs_two.json").write_text(
        json.dumps(mix))
    (tmp_path / "graphbench" / "metrics" / "mean_levels.x.py").write_text(
        "def read(run):\n    return 41.5\n")
    bench["configs"].append({"name": "kron9", "source": "test",
                             "file": "graphbench/configs/kron9.json",
                             "reduced": ["scale"], "why": "test"})
    bench["workloads"].append({"name": "kron9.bfs_two", "config": "kron9",
                               "traffic": "bfs_two", "chips": 1,
                               "why": "test"})
    bench["per_layer"].append({"name": "mean_levels.x", "unit": "levels",
                               "better": "lower", "source": "program_counter",
                               "layer": "entry", "moves": "gteps"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = harness.load_cell("kron9.bfs_two", root=tmp_path)
    assert cell.config["scale"] == 9 and cell.traffic["check_sample"] == 2
    assert cell.algo is bfs
    assert "mean_levels.x" in [m["name"] for m in cell.per_layer]
    read = harness.metric_reader("mean_levels.x", tmp_path / "graphbench")
    assert read(None) == 41.5


def test_benchmark_names_its_files():
    """Every cell's configuration, mix, algorithm and every metric's reader
    exists under the benchmark's folder."""
    bench = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    for w in bench["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell.algo.ANSWER
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(harness.metric_reader(m["name"]))
