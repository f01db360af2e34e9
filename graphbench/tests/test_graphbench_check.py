"""The check that decides ``correct``: the reference against the program
on the CPU, the control, and runs with the timed path broken underneath,
each driven through the harness as a run on the chip is (the CPU tests
skip only its look for a card)."""

import pytest
import torch

from graphbench import control, graphs, harness, reference
from graphbench.tests.helpers import small_cell

CELLS = ("kron24.bfs", "urand24.sssp", "kron24.sssp", "urand24.bfs")
SEED = 2**31 + 977


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("seed", [3, SEED])
def test_reference_agrees_with_the_program(name, seed, fresh_auto):
    """Every source of a small pool, distances and predecessors exact."""
    cell = small_cell(name, scale=8)
    st = harness.prepare(cell, seed, "cpu")
    g = graphs.program_graph(st.fields, st.meta)
    src = graphs.rows_of(st.csr)
    for source in st.sources[:12]:
        got = cell.algo.answer(cell.algo.query(g, source, "auto"))
        want = cell.algo.expected(st.csr, src, source)
        assert harness.answer_mismatch(got, want) == (0, [0, 0])


def test_reference_on_a_path():
    """0 - 1 - 2 - 3 with weights .5, .25, .125 and a chord 0 - 3 of 1."""
    n, edges = 4, {(0, 1): .5, (1, 2): .25, (2, 3): .125, (0, 3): 1.0}
    pairs = sorted(list(edges) + [(v, u) for u, v in edges])
    w = [edges.get((u, v), edges.get((v, u))) for u, v in pairs]
    off = torch.tensor([0, 2, 4, 6, 8], dtype=torch.int32)
    csr = graphs.Csr(n, off, torch.tensor([v for _, v in pairs],
                                          dtype=torch.int32),
                     torch.tensor(w, dtype=torch.float32))
    src = graphs.rows_of(csr)
    dist, pred = reference.bfs(csr, src, 0)
    assert dist.tolist() == [0, 1, 2, 1] and pred.tolist() == [-1, 0, 1, 0]
    dist, pred = reference.bfs(csr, src, 0, largest_parent=True)
    assert pred.tolist() == [-1, 0, 3, 0]
    dist, pred = reference.bellman_ford(csr, src, 0)
    assert dist.tolist() == [0, .5, .75, .875]
    assert pred.tolist() == [-1, 0, 1, 2]


@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_check(name):
    """The control (BFS: largest-id parents; SSSP: bfloat16) differs from
    the reference in at least one part of the answer on every seed."""
    cell = small_cell(name, scale=9)
    for seed in (1, 2, SEED):
        got = control.control_readings(cell, seed, "cpu")
        assert not harness.holds("answer_mismatch", got["answer_mismatch"]), got


def _run(name, seconds=0.3):
    return harness.run_cell(small_cell(name, scale=9, check_sample=3), SEED,
                            seconds, False, "cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, fresh_auto):
    out = _run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"gteps", "query_p95_ms", "setup_s"}


def _unchanged_bfs_level(lev, *args, **kwargs):
    return torch.zeros(1, dtype=torch.int32)


def _unchanged_sweep(row_offsets, col, w, flags, x, *args, **kwargs):
    return x.clone()


@pytest.mark.parametrize("name,target,fake", [
    ("kron24.bfs", "bfs_level", _unchanged_bfs_level),
    ("urand24.bfs", "bfs_level", _unchanged_bfs_level),
    ("urand24.sssp", "spmv_slabs", _unchanged_sweep),
    ("kron24.sssp", "spmv_slabs", _unchanged_sweep)])
def test_a_step_that_returns_its_state_unchanged(name, target, fake,
                                                 monkeypatch, fresh_auto):
    from essentials_tpu_torch import kernels
    monkeypatch.setattr(kernels, target, fake)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["answer_mismatch"]["value"] > 1


def _alter_one(out):
    """Raise the answer of the first real vertex with a finite positive
    one (distances as int32 levels or float32 bits, or predecessors)."""
    bits = out.view(torch.int32) if out.is_floating_point() else out
    v = int(torch.nonzero((bits > 0) & (bits < 0x7F800000))[0])
    bits[v] += 1


@pytest.mark.parametrize("name,target", [
    ("kron24.bfs", "collapse_levels"), ("urand24.bfs", "bfs_predecessors"),
    ("urand24.sssp", "sssp_predecessors"), ("kron24.sssp", "windowed")])
def test_an_answer_altered_where_it_is_produced(name, target, monkeypatch,
                                                fresh_auto):
    """BFS levels in their collapse, a predecessor in its kernel, SSSP
    distances where the windowed sweeps hand them back."""
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import sssp
    if target == "windowed":
        real = sssp.VARIANTS["windowed"]

        def altered(*args):
            dist, it = real(*args)
            _alter_one(dist)
            return dist, it
        monkeypatch.setitem(sssp.VARIANTS, "windowed", altered)
    else:
        real = getattr(kernels, target)

        def altered(*args, **kwargs):
            out = real(*args, **kwargs)
            _alter_one(out)
            return out
        monkeypatch.setattr(kernels, target, altered)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["answer_mismatch"]["value"] > 0


def test_a_program_that_writes_its_inputs(monkeypatch, fresh_auto):
    from essentials_tpu_torch.algorithms import sssp
    real = sssp.run

    def writes(g, source, **kwargs):
        g.values[0] = 0.5
        return real(g, source, **kwargs)
    monkeypatch.setattr(sssp, "run", writes)
    out = _run("urand24.sssp")
    assert not out["correct"]
    assert out["checks"]["inputs_changed"]["value"] == 1


def test_failed_queries_are_counted(monkeypatch, fresh_auto):
    from essentials_tpu_torch.algorithms import bfs
    real = bfs.run

    def fails(g, source, warmup=True, **kwargs):
        if not warmup:
            raise RuntimeError("planted failure")
        return real(g, source, warmup=warmup, **kwargs)
    monkeypatch.setattr(bfs, "run", fails)
    out = _run("kron24.bfs", seconds=0.05)
    assert not out["correct"] and out["failed"] == out["attempted"] > 0


def test_traced_run(fresh_auto):
    """A traced run on the CPU: correct, its trace whole (no device
    launches to lose), the per-layer metrics it can read, and no
    end-to-end ones."""
    out = harness.run_cell(small_cell("kron24.bfs", scale=8), SEED, 0.3,
                           True, "cpu")
    assert out["correct"], out["checks"]
    assert {"levels_per_query", "host_ms_per_level",
            "device_ops_per_query"} <= set(out["metrics"])
    assert "gteps" not in out["metrics"]
    assert out["device"]["window_s"] > 0 and "breakdown" in out
