"""What the benchmark may import and where it runs: no JAX and no JAX
package (by whole top-level name), a reference that imports nothing of the
program, and no result without a card."""

import ast
import subprocess
import sys

import pytest

from graphbench import harness

PY = sorted(p for p in harness.BENCH_DIR.rglob("*.py")
            if "tests" not in p.parts)


def _imports(path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", PY, ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    assert _imports(harness.BENCH_DIR / "reference.py") <= {"__future__",
                                                             "torch"}


def test_forbidden_names_compare_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "essentials_tpu_torch.fake", object())
    monkeypatch.setitem(sys.modules, "jaxtyping_like", object())
    assert "essentials_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "essentials_tpu.sub", object())
    assert harness.forbidden_modules() == ["essentials_tpu"]


_RUN = """
import sys
from graphbench import harness
from graphbench.tests.helpers import small_cell
for name in ("kron24.bfs", "urand24.sssp"):
    out = harness.run_cell(small_cell(name, scale=8), 5, 0.2, False, "cpu")
    assert out["correct"], out
print(harness.forbidden_modules())
"""


def test_a_run_loads_no_jax():
    """A whole run in a fresh interpreter leaves no module of JAX or the
    JAX package in sys.modules."""
    r = subprocess.run([sys.executable, "-c", _RUN], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_a_card():
    """Where torch sees no CUDA device (this CPU build), the command exits
    3 and prints nothing on standard output."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, "-m", "graphbench.run", "--workload",
                        "kron24.bfs", "--seed", str(2**33), "--seconds", "1",
                        "--trace", "0"], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 3 and r.stdout == ""


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kron24.bfs", "urand24.sssp"])
def test_small_cells_on_the_card(name):
    """On the card: the layout equals build_graph's at scale 12, and a
    short run of a small cell is correct, traced and not."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.graph.graph import ARRAY_FIELDS
    from graphbench import graphs
    from graphbench.tests.helpers import small_cell
    cell = small_cell(name, scale=12)
    fields, meta = graphs.make(cell.config, 9, "cuda")
    c = graphs.csr_of(fields, meta)
    ref = build_graph(Csr(c.n, c.n, c.row_offsets.cpu().numpy(),
                          c.col.cpu().numpy(), c.values.cpu().numpy()),
                      directed=False, weighted=True, device="cuda")
    for k in ARRAY_FIELDS:
        assert torch.equal(fields[k], getattr(ref, k)), k
    for traced in (False, True):
        out = harness.run_cell(cell, 2**32 + 3, 0.5, traced, "cuda")
        assert out["correct"], out["checks"]
