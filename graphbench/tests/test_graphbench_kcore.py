"""The k-core cell (``kron24.kcore``) at a small size on the CPU: a sound
run is correct, the control fails the check, the cell's files import no
JAX, and its two readers read only where k-core ran."""

import pytest
import torch

from graphbench import control, graphs, harness
from graphbench.algos import kcore as algo
from graphbench.harness import Query, Run
from graphbench.tests.helpers import small_cell
from graphbench.tests.test_graphbench_isolation import _imports

SEED = 2**31 + 977
READERS = ("wave_peeled_share", "waves_per_level")


@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(traced):
    from essentials_tpu_torch import kernels
    kernels.reset_launches()
    out = harness.run_cell(small_cell("kron24.kcore", scale=9,
                                      check_sample=3), SEED, 0.3, traced,
                           "cpu")
    assert out["correct"], out["checks"]
    assert out["checks"]["answer_mismatch"]["value"] == 0
    assert out["attempted"] >= 1 and out["failed"] == 0
    if traced:
        assert set(READERS) <= set(out["metrics"])
        assert 0 < out["metrics"]["wave_peeled_share"]["value"] < 100
        assert out["metrics"]["waves_per_level"]["value"] >= 1
    else:
        assert set(out["metrics"]) == {"gteps", "query_p95_ms", "setup_s"}


def test_control_fails_the_check():
    """One wave a level differs from the reference in many vertices on
    every seed."""
    cell = small_cell("kron24.kcore", scale=10)
    for seed in (1, 2, SEED):
        got = control.control_readings(cell, seed, "cpu")
        assert not harness.holds("answer_mismatch", got["answer_mismatch"])
        assert got["answer_mismatch"] >= 50, got


def test_expected_is_computed_once_a_graph(monkeypatch):
    cell = small_cell("kron24.kcore", scale=8)
    calls = []
    real = algo.reference_kcore.kcore

    def counted(csr, **kwargs):
        calls.append(csr)
        return real(csr, **kwargs)
    monkeypatch.setattr(algo.reference_kcore, "kcore", counted)
    csrs = [harness.prepare(cell, seed, "cpu").csr for seed in (4, 5)]
    first = [algo.expected(csrs[0], None, s)[0] for s in (0, 1, 2)]
    assert len(calls) == 1 and all(x is first[0] for x in first)
    assert algo.expected(csrs[1], None, 0)[0] is not first[0]
    assert len(calls) == 2


def test_byte_model():
    assert algo.query_bytes(1000, 5000) == 8 * 5000 + 8 * 1000


@pytest.mark.parametrize("path", ["algos/kcore.py", "reference_kcore.py"])
def test_cell_files_import_no_jax(path):
    names = _imports(harness.BENCH_DIR / path)
    assert not names & set(harness.FORBIDDEN)
    if path == "reference_kcore.py":
        assert names <= {"__future__", "torch"}


@pytest.mark.parametrize("name", ["kron24.bfs", "urand24.sssp"])
def test_readers_leave_other_cells_out(name, fresh_auto):
    from essentials_tpu_torch import kernels
    kernels.reset_launches()
    out = harness.run_cell(small_cell(name, scale=8), SEED, 0.3, True, "cpu")
    assert out["correct"], out["checks"]
    assert not set(READERS) & set(out["metrics"])


@pytest.mark.parametrize("peeled,waves,levels,share,per_level", [
    (32, 16, 4, 0.78125, 4.0), (0, 2, 0, 0.0, None),
    (0, 0, 0, None, None)])
def test_readers(peeled, waves, levels, share, per_level, monkeypatch):
    """At scale 8 a wave scans 256 vertices: 16 waves scan 4,096, 4 a
    level."""
    from essentials_tpu_torch import kernels
    monkeypatch.setattr(kernels, "counters",
                        {"kcore.peeled": peeled, "kcore.waves": waves,
                         "kcore.levels": levels})
    run = Run(cell=small_cell("kron24.kcore", scale=8), setup_s=1.0,
              window_s=1.0, queries=[Query(0, 0.01, 3, 10, 80)])
    got = harness.metric_reader("wave_peeled_share")(run)
    assert got == (pytest.approx(share) if share is not None else None)
    got = harness.metric_reader("waves_per_level")(run)
    assert got == (pytest.approx(per_level) if per_level is not None
                   else None)


@pytest.mark.parametrize("name", READERS)
def test_readers_without_the_counters(name, monkeypatch):
    from essentials_tpu_torch import kernels
    monkeypatch.delattr(kernels, "counters")
    run = Run(cell=None, setup_s=1.0, window_s=1.0,
              queries=[Query(0, 0.01, 3, 10, 80)])
    assert harness.metric_reader(name)(run) is None


def test_reference_reads_offsets_and_columns_only():
    """The reference reads only what ``run_cell`` keeps: offsets and
    columns."""
    cell = small_cell("kron24.kcore", scale=8)
    st = harness.prepare(cell, 6, "cpu")
    kept = graphs.Csr(st.csr.n, st.csr.row_offsets.clone(),
                      st.csr.col.clone(), st.csr.values[:0])
    assert algo.reference_kcore.kcore(kept).equal(
        algo.reference_kcore.kcore(st.csr))


@pytest.mark.parametrize("seed", [3, SEED])
def test_config_builds_kron24s_graph(seed):
    """The k-core deployment's configuration is its own entry, with its own
    source, but its generator and sizes are ``kron24``'s: the same seed
    gives the same graph."""
    ours, theirs = (small_cell(name, scale=9).config
                    for name in ("kron24.kcore", "kron24.bfs"))
    assert ours["name"] == "kron24_kcore" and theirs["name"] == "kron24"
    got, got_meta = graphs.make(ours, seed, "cpu")
    want, want_meta = graphs.make(theirs, seed, "cpu")
    assert got_meta == want_meta
    assert all(torch.equal(got[k], want[k]) for k in want)
