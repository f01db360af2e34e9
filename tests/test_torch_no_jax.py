"""essentials_tpu_torch without JAX: the port and chip_smoke.py import
neither jax nor the JAX package, its main path runs where importing jax
fails, and, on a CUDA card, its kernels agree exactly with their plain
versions.

This file imports no jax, so its card test runs on a machine without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_no_jax.py
"""

import ast
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "essentials_tpu")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def test_sources_import_no_jax():
    files = sorted((ROOT / "essentials_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 15
    for f in files:
        assert not _imported_roots(f) & set(_FORBIDDEN), f


_MAIN_PATH = textwrap.dedent("""
    import sys

    class _NoJax:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in {forbidden!r}:
                raise ImportError("blocked: " + name)
            return None

    sys.meta_path.insert(0, _NoJax())
    import numpy as np
    from essentials_tpu_torch.algorithms import bfs
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate

    csr = Csr.from_coo(generate.rmat(9, 8, seed=2, weighted=False))
    g = build_graph(csr, directed=False, weighted=False, device="cpu")
    for variant, max_it in (("fused", None), ("fused8", 64)):
        r = bfs.run(g, 1, variant=variant, max_iterations=max_it)
        assert np.array_equal(r.distances.numpy(), bfs.cpu_reference(csr, 1))
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in {forbidden!r})
    assert not loaded, loaded
    print("iterations", r.iterations)
""").format(forbidden=_FORBIDDEN)


def test_main_path_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    r = subprocess.run([sys.executable, "-c", _MAIN_PATH], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("iterations ")


def test_chip_smoke_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.cuda
def test_kernels_match_plain_versions_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from essentials_tpu_torch import kernels
    from essentials_tpu_torch.algorithms import bfs
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.graph import build_graph
    from essentials_tpu_torch.io import generate
    from essentials_tpu_torch.ops import fused_bfs as FB

    csr = Csr.from_coo(generate.rmat(10, 8, seed=4, weighted=False))
    g = build_graph(csr, directed=False, weighted=False, device="cuda")
    kernels.reset_launches()
    for unreached in (FB.UNREACHED, FB.UNREACHED_E):
        lev = FB.init_lev_exp(g, 0, unreached)
        ref = lev.clone()
        for it in range(64):
            cnt = kernels.bfs_level(lev, g.row_offsets, g.csc_src_indices,
                                    it, unreached)
            cnt_p = kernels.bfs_level_plain(ref, g.row_offsets,
                                            g.csc_src_indices, it, unreached)
            assert torch.equal(lev, ref) and torch.equal(cnt, cnt_p), it
            if cnt.item() == 0:
                break
        dist = kernels.collapse_levels(lev, g.row_offsets, 0, unreached)
        assert torch.equal(dist, kernels.collapse_levels_plain(
            lev, g.row_offsets, 0, unreached))
        args = (dist, g.csc_offsets, g.csc_src_indices, g.n_edges)
        assert torch.equal(kernels.bfs_predecessors(*args),
                           kernels.bfs_predecessors_plain(*args))
    assert all(n > 0 for n in kernels.launches.values()), kernels.launches
    assert np.array_equal(dist[:g.n_vertices].cpu().numpy(),
                          bfs.cpu_reference(csr, 0))
