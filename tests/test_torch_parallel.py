"""Port parity: the parallel layer of essentials_tpu_torch (``partition``,
``mesh``, ``multihost``, ``distributed``) against essentials_tpu on the CPU.

``partition_graph`` must give the JAX package's arrays field by field on
four graphs, in every exchange mode, with and without the overlap split, at
P = 1, 2, 4 and 8; the routes (Beneš plans in the JAX package) must be the
gather indices the plans apply. The port's P ranks run as P processes on
gloo (``python -c`` children, which import neither jax nor this directory's
conftest), one launch per P running every case and writing each rank's
shards; the JAX package runs the same cases on the 8-device virtual mesh of
conftest.py. ``dist_bfs`` and ``dist_sssp`` must be bit-equal to the JAX
package's in the all_gather and boundary modes, with and without overlap;
``dist_pagerank``, whose float sums run in another order, within rtol 1e-4
/ atol 1e-7 of it and of a float64 host power iteration. The one-rank
tests run in this process on a gloo group."""

import os
import socket
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor
from functools import lru_cache, partial

import numpy as np
import pytest
import torch
import torch.distributed as tdist

import jax
import jax.numpy as jnp

from essentials_tpu.formats import Csr as JCsr
from essentials_tpu.io import generate as jgen
from essentials_tpu.ops.permute import apply_plan
from essentials_tpu.parallel import make_mesh as jmake_mesh
from essentials_tpu.parallel import distributed as jdistributed
from essentials_tpu.parallel.partition import partition_graph as jpartition

from essentials_tpu_torch.algorithms import bfs as tbfs, sssp as tsssp
from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.formats import Csr
from essentials_tpu_torch.io import generate, load_graph_file
from essentials_tpu_torch.parallel import (device_count, distributed,
                                           make_mesh, multihost)
from essentials_tpu_torch.parallel.partition import partition_graph

ROOT = os.path.join(os.path.dirname(__file__), "..")
CHESAPEAKE = os.path.join(ROOT, "datasets", "chesapeake.mtx")
GRAPHS = ("chesapeake", "chain40", "rmat8w", "uniform101")
MODES = ("all_gather", "boundary")
ALGOS = ("bfs", "sssp", "pagerank")
DIST_GRAPH, DIST_SOURCE = "rmat8w", 3
PR_RTOL, PR_ATOL = 1e-4, 1e-7
ARRAYS = ("src_offsets", "dst_offsets", "weights", "vertex_valid",
          "out_degrees", "send_idx", "csrc_offsets", "peer_dst_offsets",
          "peer_edge_starts")
META = ("n_devices", "block_size", "edges_per_device", "n_vertices",
        "n_edges", "boundary_size", "peer_edges", "n_vertices_global",
        "comm_values_per_step")


@lru_cache(maxsize=None)
def _graph(name: str) -> tuple:
    """(the JAX package's Csr, the port's Csr) of one test graph; uniform101
    has V = 101, a multiple of no P."""
    if name == "chesapeake":
        from essentials_tpu.io import load_graph_file as jload
        return jload(CHESAPEAKE, cache=False), load_graph_file(CHESAPEAKE,
                                                               cache=False)
    make = {"chain40": lambda g: g.chain(40),
            "rmat8w": lambda g: g.rmat(8, 8, seed=6, weighted=True),
            "uniform101": lambda g: g.uniform_random(101, 4, seed=3,
                                                     weighted=True)}[name]
    return JCsr.from_coo(make(jgen)), Csr.from_coo(make(generate))


# every plan of a stack applied to arange: the gather index it routes
_ROUTED = jax.jit(jax.vmap(apply_plan, in_axes=(None, 0)))


@pytest.mark.parametrize("overlap", (False, True), ids=("mono", "overlap"))
@pytest.mark.parametrize("exchange", MODES + ("auto",))
@pytest.mark.parametrize("p", (1, 2, 4, 8))
@pytest.mark.parametrize("name", GRAPHS)
def test_partition_equals_jax(name, p, exchange, overlap):
    jcsr, csr = _graph(name)
    a = jpartition(jcsr, p, exchange=exchange, overlap=overlap)
    b = partition_graph(csr, p, exchange=exchange, overlap=overlap)
    for f in META:
        assert getattr(b, f) == getattr(a, f), f
    for f in ARRAYS:
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            x = np.asarray(x)
            assert y.dtype == x.dtype and y.shape == x.shape, f
            assert np.array_equal(y, x), f
    assert np.array_equal(b.route_idx, np.asarray(
        _ROUTED(jnp.arange(a.edges_per_device), a.route)))
    if overlap:
        flat = jax.tree_util.tree_map(
            lambda z: z.reshape((-1,) + z.shape[2:]), a.peer_route)
        want = np.asarray(_ROUTED(jnp.arange(a.peer_edges), flat))
        assert np.array_equal(b.peer_route_idx,
                              want.reshape(p, p, a.peer_edges))
    else:
        assert b.peer_route_idx is None


_CHILD = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    torch.set_num_threads(1)
    port, n, pid, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \\
        sys.argv[4]
    from essentials_tpu_torch.formats import Csr
    from essentials_tpu_torch.io import generate
    from essentials_tpu_torch.parallel import distributed as D, multihost
    from essentials_tpu_torch.parallel.partition import partition_graph
    multihost.initialize(f"127.0.0.1:{port}", n, pid, device="cpu")
    mesh = multihost.global_mesh()
    assert mesh.size == n and mesh.rank == pid
    assert multihost.is_coordinator() == (pid == 0)
    csr = Csr.from_coo(generate.rmat(8, 8, seed=6, weighted=True))
    res = {}
    for mode in %(modes)r:
        dg = partition_graph(csr, n, exchange=mode, overlap=True)
        part = dg.local(pid, "cpu")
        for ov in (False, True):
            key = f"{mode}_{ov}_"
            res[key + "bfs"] = D.dist_bfs(part, mesh, %(src)d, overlap=ov)
            res[key + "sssp"] = D.dist_sssp(dg, mesh, %(src)d, overlap=ov)
            res[key + "pagerank"] = D.dist_pagerank(part, mesh, overlap=ov)
    full = multihost.gather_global(mesh, res[key + "bfs"])
    assert torch.equal(full[pid * dg.block_size:][:dg.block_size],
                       res[key + "bfs"])
    np.savez(f"{out}/rank{pid}.npz", **{k: v.numpy() for k, v in res.items()})
    torch.distributed.destroy_process_group()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "essentials_tpu"))
    assert not loaded, loaded
    print(f"proc {pid} ok", flush=True)
""") % {"modes": MODES, "src": DIST_SOURCE}


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _jax_runs(p: int) -> dict:
    """The JAX package's cases at P devices, compiled on a few threads (each
    call traces and compiles a shard_map of its own)."""
    jcsr, _ = _graph(DIST_GRAPH)
    mesh = jmake_mesh(p)
    calls = {}
    for mode in MODES:
        dg = jpartition(jcsr, p, exchange=mode, overlap=True)
        for ov in (False, True):
            key = f"{mode}_{ov}_"
            calls[key + "bfs"] = partial(jdistributed.dist_bfs, dg, mesh,
                                         DIST_SOURCE, overlap=ov)
            calls[key + "sssp"] = partial(jdistributed.dist_sssp, dg, mesh,
                                          DIST_SOURCE, overlap=ov)
            calls[key + "pagerank"] = partial(jdistributed.dist_pagerank, dg,
                                              mesh, overlap=ov)
    with ThreadPoolExecutor(4) as ex:
        out = ex.map(lambda f: np.asarray(f()), calls.values())
        return dict(zip(calls, out))


@pytest.fixture(scope="module", params=(2, 4), ids=("P2", "P4"))
def dist_runs(request, tmp_path_factory):
    """{case: (the port's global vector from its P ranks' shards, the JAX
    package's)} for every mode x overlap x algorithm at P ranks; the JAX
    runs go while the children run."""
    p = request.param
    out = tmp_path_factory.mktemp(f"ranks{p}")
    env = dict(os.environ, PYTHONPATH=os.path.abspath(ROOT))
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHILD, str(port), str(p), str(pid),
         str(out)], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(p)]
    try:
        ref = _jax_runs(p)
    finally:
        outs = []
        try:
            for proc in procs:
                outs.append(proc.communicate(timeout=240)[0])
        except subprocess.TimeoutExpired:
            for proc in procs:
                proc.kill()
            pytest.fail("rank processes timed out:\n" + "\n".join(outs))
    for pid, (proc, text) in enumerate(zip(procs, outs)):
        assert proc.returncode == 0 and f"proc {pid} ok" in text, \
            f"rank {pid} failed:\n{text[-3000:]}"
    shards = [np.load(out / f"rank{pid}.npz") for pid in range(p)]
    return {k: (np.concatenate([s[k] for s in shards]), v)
            for k, v in ref.items()}


@lru_cache(maxsize=None)
def _host_pagerank(name: str) -> np.ndarray:
    """The float64 power iteration of tests/test_distributed.py:58-76."""
    _, csr = _graph(name)
    n = csr.n_rows
    off, cols = csr.row_offsets, csr.col_indices
    deg = np.diff(off)
    pr = np.full(n, 1.0 / n)
    for _ in range(100):
        contrib = np.where(deg > 0, pr / np.maximum(deg, 1), 0.0)
        nxt = np.zeros(n)
        for u in range(n):
            nxt[cols[off[u]:off[u + 1]]] += contrib[u]
        dangling = pr[deg == 0].sum()
        new = (1 - 0.85) / n + 0.85 * (nxt + dangling / n)
        if np.abs(new - pr).sum() < 1e-6:
            pr = new
            break
        pr = new
    return pr


@pytest.mark.parametrize("algo", ALGOS)
@pytest.mark.parametrize("overlap", (False, True), ids=("mono", "overlap"))
@pytest.mark.parametrize("mode", MODES)
def test_dist_matches_jax(dist_runs, mode, overlap, algo):
    got, want = dist_runs[f"{mode}_{overlap}_{algo}"]
    assert got.shape == want.shape and got.dtype == want.dtype
    _, csr = _graph(DIST_GRAPH)
    n = csr.n_rows
    if algo == "pagerank":
        # float sums in another order: rtol 1e-4 / atol 1e-7, against the
        # JAX package and against the float64 host
        assert np.allclose(got, want, rtol=PR_RTOL, atol=PR_ATOL)
        assert np.allclose(got[:n], _host_pagerank(DIST_GRAPH),
                           rtol=PR_RTOL, atol=PR_ATOL)
        assert np.all(got[n:] == 0)
        return
    # bit for bit
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if algo == "bfs":
        assert np.array_equal(got[:n], tbfs.cpu_reference(csr, DIST_SOURCE))
    else:
        ref = tsssp.cpu_reference(csr, DIST_SOURCE)
        fin = np.isfinite(ref)
        assert np.array_equal(np.isfinite(got[:n]), fin)
        # PARITY.md's SSSP tolerance against the float64 host
        assert np.allclose(got[:n][fin], ref[fin], rtol=1e-5, atol=0)


# ---------------------------------------------------------- one rank --

@pytest.fixture
def one_rank():
    """A one-rank gloo group in this process, gone after the test."""
    assert not tdist.is_initialized()
    multihost.initialize(num_processes=1, device="cpu")
    try:
        yield multihost.global_mesh()
    finally:
        tdist.destroy_process_group()


def test_no_group_is_refused():
    assert not tdist.is_initialized()
    for call in (make_mesh, device_count, multihost.global_mesh,
                 multihost.is_coordinator):
        with pytest.raises(EssentialsError, match="no process group"):
            call()


def test_cuda_rank_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(EssentialsError, match="no CUDA device"):
        multihost.initialize(num_processes=1)      # device="cuda"
    assert not tdist.is_initialized()              # no gloo in its place


def test_initialize_one_rank(one_rank):
    mesh = one_rank
    assert (mesh.rank, mesh.size) == (0, 1)
    assert mesh.device == torch.device("cpu")
    assert tdist.get_backend() == "gloo"
    assert device_count() == 1 and multihost.is_coordinator()
    assert make_mesh(1) == mesh
    with pytest.raises(EssentialsError, match="2 devices asked"):
        make_mesh(2)
    with pytest.raises(EssentialsError, match="a process group exists"):
        multihost.initialize(num_processes=1, device="cpu")


@pytest.mark.parametrize("dtype", (torch.int32, torch.int8, torch.float32))
def test_gather_global(one_rank, dtype):
    shard = (torch.arange(16) % 3).to(dtype)
    out = multihost.gather_global(one_rank, shard)
    assert out.dtype == dtype and torch.equal(out, shard)


def test_overlap_needs_its_partition(one_rank):
    jcsr, csr = _graph("chesapeake")
    with pytest.raises(ValueError, match="overlap=True"):
        jdistributed.dist_bfs(jpartition(jcsr, 1), jmake_mesh(1), 0,
                              overlap=True)
    dg = partition_graph(csr, 1)
    for call in (lambda: distributed.dist_bfs(dg, one_rank, 0, overlap=True),
                 lambda: distributed.dist_sssp(dg, one_rank, 0,
                                               overlap=True),
                 lambda: distributed.dist_pagerank(dg, one_rank,
                                                   overlap=True)):
        with pytest.raises(ValueError, match="overlap=True"):
            call()


def test_partition_of_another_mesh_is_refused(one_rank):
    _, csr = _graph("chesapeake")
    with pytest.raises(EssentialsError, match="on a mesh of 1"):
        distributed.dist_bfs(partition_graph(csr, 2), one_rank, 0)
    with pytest.raises(EssentialsError, match="rank 2 outside"):
        partition_graph(csr, 2).local(2, "cpu")
    with pytest.raises(EssentialsError, match="exchange must be"):
        partition_graph(csr, 2, exchange="ring")


@pytest.mark.parametrize("mode", MODES)
def test_one_rank_matches_jax_and_host(one_rank, mode):
    """P = 1 in this process: BFS bit-equal to the JAX package's (boundary
    with overlap, the longest path) and every algorithm against its host
    reference in both overlap settings."""
    jcsr, csr = _graph("chesapeake")
    dg = partition_graph(csr, 1, exchange=mode, overlap=True)
    part = dg.local(0, "cpu")
    n = csr.n_rows
    ref = tbfs.cpu_reference(csr, 0)
    sref = tsssp.cpu_reference(csr, 0)
    for ov in (False, True):
        d = distributed.dist_bfs(part, one_rank, 0, overlap=ov).numpy()
        assert np.array_equal(d[:n], ref)
        s = distributed.dist_sssp(part, one_rank, 0, overlap=ov).numpy()
        assert np.allclose(s[:n], sref, rtol=1e-5, atol=0)
        p = distributed.dist_pagerank(part, one_rank, overlap=ov).numpy()
        assert np.allclose(p[:n], _host_pagerank("chesapeake"),
                           rtol=PR_RTOL, atol=PR_ATOL)
        assert abs(float(p.astype(np.float64).sum()) - 1.0) <= 1e-5
    if mode == "boundary":
        jdg = jpartition(jcsr, 1, exchange=mode, overlap=True)
        want = np.asarray(jdistributed.dist_bfs(jdg, jmake_mesh(1), 0,
                                                overlap=True))
        assert np.array_equal(d, want)
