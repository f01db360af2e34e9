"""Port parity: the ``essentials-tpu-torch`` command-line driver and the
``run_all`` example on the CPU (``--cpu``: every kernel's plain version).

Every one of the 13 algorithms validates on ``datasets/chesapeake.mtx``
against its host reference with the JAX CLI's tolerances; ``--json`` prints
``RunStats``' keys, and the same vertex, edge and iteration counts as the
JAX CLI's ``--cpu --json``; without ``--cpu`` and without a card the driver
raises before it loads anything."""

import inspect
import json
import os

import numpy as np
import pytest
import torch

from essentials_tpu import cli as jcli

from essentials_tpu_torch import cli
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.examples import run_all
from essentials_tpu_torch.utils.stats import RunStats

ROOT = os.path.join(os.path.dirname(__file__), "..")
CHESAPEAKE = os.path.join(ROOT, "datasets", "chesapeake.mtx")
ARGS = ["--cpu", "--runs", "1", "--no-cache"]


@pytest.mark.parametrize("algo", cli.ALGORITHMS)
def test_cli_validates_every_algorithm(algo, capsys):
    assert cli.main([algo, CHESAPEAKE, "--validate", *ARGS]) == 0
    out = capsys.readouterr().out
    assert f"{algo} on chesapeake:" in out
    assert "validation: PASS (0 errors)" in out


def test_cli_has_the_jax_choices():
    source = inspect.getsource(jcli.main)
    assert all(f'"{a}"' in source for a in cli.ALGORITHMS)
    ours = {a.dest for a in cli._parser()._actions}
    assert ours >= {"algorithm", "graph", "source", "labels", "runs",
                    "undirected", "no_cache", "validate", "json", "cpu",
                    "variant"}


# JAX's CLI builds its graph without the router plans on the CPU, so its
# k-core 'auto' runs 'adaptive' there; the port's 'auto' runs 'fused' on a
# symmetric layout (13 waves against 17): compare the same variant
@pytest.mark.parametrize("algo,extra", [("bfs", []), ("sssp", []),
                                        ("kcore", ["--variant", "adaptive"]),
                                        ("bfs", ["--undirected",
                                                 "--source", "5"])])
def test_cli_json_matches_jax(algo, extra, capsys):
    assert cli.main([algo, CHESAPEAKE, "--json", *ARGS, *extra]) == 0
    ours = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert jcli.main([algo, CHESAPEAKE, "--json", *ARGS, *extra]) == 0
    theirs = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(ours) == list(RunStats.__dataclass_fields__) == list(theirs)
    for k in ("algorithm", "dataset", "n_vertices", "n_edges", "iterations",
              "edges_visited", "search_depth", "redundance"):
        assert ours[k] == theirs[k], k
    assert ours["backend"] == "cpu" and ours["hbm_gbps"] == 0.0
    assert len(ours["cycles_ms"]) == 1


def test_cli_runs_and_mean(capsys):
    assert cli.main(["pr", CHESAPEAKE, "--json", "--cpu", "--runs", "3",
                     "--no-cache"]) == 0
    s = json.loads(capsys.readouterr().out)
    assert len(s["cycles_ms"]) == 3
    assert abs(s["elapsed_ms"] - np.mean(s["cycles_ms"])) < 1e-2


def test_cli_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    from essentials_tpu_torch import io

    def no_load(*a, **kw):
        raise AssertionError("loaded a graph without a card")
    monkeypatch.setattr(io, "load_graph_file", no_load)
    with pytest.raises(EssentialsError, match="no CUDA device"):
        cli.main(["bfs", CHESAPEAKE, "--runs", "1"])


def test_cli_geo_labels_file(tmp_path, capsys):
    labels = tmp_path / "labels.txt"
    labels.write_text("0 10.5 20.25\n3 -5.0 100.0\n17 44.0 -70.5\n")
    assert cli.main(["geo", CHESAPEAKE, "--labels", str(labels),
                     "--validate", *ARGS]) == 0
    assert "validation: PASS" in capsys.readouterr().out


def test_cli_geo_validates_with_unlocated_vertices(capsys):
    """kron_s12 has isolated vertices that stay NaN in geo and in its host
    reference alike; the JAX CLI's compare counts each as an error (1370)."""
    kron = os.path.join(ROOT, "datasets", "kron_s12.mtx")
    assert cli.main(["geo", kron, "--undirected", "--validate", *ARGS]) == 0
    assert "validation: PASS (0 errors)" in capsys.readouterr().out


def test_geo_labels_as_jax():
    """The seeded 10% of labels: the JAX CLI's default_rng(0) draws."""
    class A:
        labels = None
    lat, lon = cli.geo_labels(A, 39, 40)
    rng = np.random.default_rng(0)
    ids = rng.choice(39, 3, replace=False)
    assert np.array_equal(np.flatnonzero(~np.isnan(lat)), np.sort(ids))
    assert np.array_equal(lat[ids], rng.uniform(-60, 60, 3).astype(np.float32))
    assert np.array_equal(lon[ids],
                          rng.uniform(-180, 180, 3).astype(np.float32))


def test_cli_validation_fails_loudly(monkeypatch, capsys):
    from essentials_tpu_torch.algorithms import bfs
    ref = bfs.cpu_reference
    monkeypatch.setattr(bfs, "cpu_reference",
                        lambda csr, s: ref(csr, s) + 1)
    assert cli.main(["bfs", CHESAPEAKE, "--validate", *ARGS]) == 1
    assert "validation: FAIL" in capsys.readouterr().out


def test_run_all(capsys):
    assert run_all.main([CHESAPEAKE, "--cpu"]) == 0
    out = capsys.readouterr().out
    assert "12/12 algorithms validated" in out
    assert out.count("validation: PASS") == len(run_all.ALGOS) == 12
