"""The check that decides ``correct`` against SSSP runs broken in the
engine that ``auto`` runs on the benchmark's graphs (``fused``: the
``sssp_sweep`` kernel and the search around it), as
``test_graphbench_check`` breaks the windowed engine."""

import pytest
import torch

from graphbench.tests.test_graphbench_check import _alter_one, _run

SSSP_CELLS = ("urand24.sssp", "kron24.sssp")


def _unchanged_sweep(dist_in, dist_out, *args, **kwargs):
    """A sweep that writes nothing and reports no improvement (the count
    followed by the kernel's other scalar words)."""
    return torch.zeros(4, dtype=torch.int32)[:1]


@pytest.mark.parametrize("name", SSSP_CELLS)
def test_a_sweep_that_leaves_its_state_unchanged(name, monkeypatch,
                                                 fresh_auto):
    from essentials_tpu_torch import kernels
    monkeypatch.setattr(kernels, "sssp_sweep", _unchanged_sweep)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["answer_mismatch"]["value"] > 1


@pytest.mark.parametrize("name", SSSP_CELLS)
def test_a_distance_altered_where_the_search_returns_it(name, monkeypatch,
                                                        fresh_auto):
    from essentials_tpu_torch.algorithms import sssp
    real = sssp.VARIANTS["fused"]

    def altered(*args):
        dist, it = real(*args)
        _alter_one(dist)
        return dist, it
    monkeypatch.setitem(sssp.VARIANTS, "fused", altered)
    out = _run(name)
    assert not out["correct"]
    assert out["checks"]["answer_mismatch"]["value"] > 0
