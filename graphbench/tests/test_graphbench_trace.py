"""The traced window's arithmetic on synthetic Chrome traces."""

import pytest

from graphbench import trace

KNOWN = {"bfs_level_kernel", "bfs_level_push_kernel", "scan_kernel",
         "gather_payloads_pack_kernel", "advance_count_pack_kernel"}


def _k(name, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def _span(ts, dur):
    return _k(trace.QUERY_SPAN, ts, dur, "user_annotation")


def test_kernel_name():
    assert trace.kernel_name("void (anonymous namespace)::bfs_level_kernel"
                             "<int>(int const*, int)") == "bfs_level_kernel"
    assert trace.kernel_name("void (anonymous namespace)::"
                             "bfs_level_push_kernel<signed char>(...)") == \
        "bfs_level_push_kernel"
    assert trace.kernel_name("Memset (Device)") is None


def _events():
    return [
        _span(0, 100), _span(150, 100),
        _k("void (anonymous namespace)::bfs_level_kernel<int>(int)", 10, 20),
        _k("void (anonymous namespace)::bfs_level_kernel<int>(int)", 25, 20),
        _k("void (anonymous namespace)::bfs_level_push_kernel<int>(int)",
           160, 40),
        _k("Memset (Device)", 210, 10, "gpu_memset"),
        _k("void at::native::elementwise_kernel<128, 2>(...)", 60, 10),
        _k("void (anonymous namespace)::advance_count_pack_kernel(int)",
           300, 5),                               # after the last query
        {"ph": "X", "cat": "cpu_op", "name": "aten::item", "ts": 45,
         "dur": 30},
        {"ph": "X", "cat": "gpu_user_annotation", "name": trace.QUERY_SPAN,
         "ts": 0, "dur": 250},
    ]


def test_complete_against_counters():
    ev = _events()
    delta = {"bfs_level<int32>": 2, "bfs_level_push": 1, "scan": 0,
             "no_such": 3}
    assert trace.complete(ev, delta, KNOWN) == (True, "")
    lost = [e for e in ev if "push" not in e["name"]]
    whole, detail = trace.complete(lost, delta, KNOWN)
    assert not whole and "bfs_level_push_kernel: traced 0 of 1" in detail
    whole, detail = trace.complete(ev, dict(delta, scan=2), KNOWN)
    assert not whole and "scan_kernel: traced 0 of 2" in detail
    # a kernel that no counter counts is not compared
    assert trace.complete(ev + [_k("advance_count_pack_kernel", 5, 1)],
                          delta, KNOWN)[0]


def test_summary():
    s = trace.summarize(_events(), KNOWN)
    assert s.window_s == pytest.approx(250e-6)
    # busy: [10, 45] + [60, 70] + [160, 200] + [210, 220]
    assert s.busy_s == pytest.approx(95e-6)
    assert s.query_span_s == pytest.approx([100e-6, 100e-6])
    assert s.query_busy_s == pytest.approx([45e-6, 50e-6])
    assert s.query_ops == [3, 2]
    names = dict(s.device_ops)
    assert names["bfs_level_kernel"] == pytest.approx(40e-6)
    assert names["bfs_level_push_kernel"] == pytest.approx(40e-6)
    assert "advance_count_pack_kernel" not in names
    gaps = dict(s.idle_gaps)
    assert sum(gaps.values()) == pytest.approx(250e-6 - 95e-6)
    # each gap goes whole to what the host did at its middle
    assert gaps["between queries: python"] == pytest.approx(90e-6)
    assert gaps["query: aten::item"] == pytest.approx(15e-6)
    assert gaps["query: python"] == pytest.approx(50e-6)


def test_merge_and_cover():
    m = trace.merge([(0, 10), (5, 20), (30, 40), (40, 41)])
    assert m == [[0, 20], [30, 41]]
    assert trace.covered(m, 15, 35) == 10
    assert trace.covered(m, 50, 60) == 0


def test_no_query_spans():
    assert trace.summarize([_k("x_kernel", 0, 1)]) is None
