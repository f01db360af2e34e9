"""``sweep_slots_per_edge`` on the CPU: the program's ``sssp.push_slots``
over the directed edges of the queries' components, read in an SSSP cell
and nowhere the counter is missing or zero."""

import pytest

from graphbench import harness
from graphbench.harness import Query, Run
from graphbench.tests.helpers import small_cell

SEED = 2**32 + 23


def _run(edges) -> Run:
    return Run(cell=None, setup_s=1.0, window_s=1.0,
               queries=[Query(0, 0.01, 3, e, 8 * e) for e in edges])


@pytest.mark.parametrize("slots,edges,want", [(60, (5, 15), 1.5),
                                              (7, (2, 3, 5), 0.35),
                                              (0, (5,), None),
                                              (9, (), None)])
def test_sweep_slots_per_edge(slots, edges, want, monkeypatch):
    from essentials_tpu_torch import kernels
    monkeypatch.setattr(kernels, "counters", {"sssp.push_slots": slots})
    got = harness.metric_reader("sweep_slots_per_edge")(_run(edges))
    assert got == (pytest.approx(want) if want is not None else None)


def test_without_the_counter(monkeypatch):
    from essentials_tpu_torch import kernels
    monkeypatch.setattr(kernels, "counters", {"sssp.swept": 40})
    assert harness.metric_reader("sweep_slots_per_edge")(_run((10,))) is None
    monkeypatch.delattr(kernels, "counters")
    assert harness.metric_reader("sweep_slots_per_edge")(_run((10,))) is None


@pytest.mark.parametrize("name,reads", [("urand24.sssp", True),
                                        ("kron24.bfs", False)])
def test_in_a_traced_run(name, reads, fresh_auto):
    """A traced run on the CPU reads the slots in an SSSP cell, where the
    plain route counts them, below the sweeps a query makes (what
    windowed sweeps would read), and leaves the metric out of a BFS
    cell."""
    from essentials_tpu_torch import kernels
    kernels.reset_launches()
    out = harness.run_cell(small_cell(name, scale=8), SEED, 0.3, True, "cpu")
    assert out["correct"], out["checks"]
    metrics = out["metrics"]
    assert ("sweep_slots_per_edge" in metrics) == reads
    if reads:
        assert 0 < metrics["sweep_slots_per_edge"]["value"] \
            < metrics["levels_per_query"]["value"]
