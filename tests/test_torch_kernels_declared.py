"""The kernels package's declarations against the CUDA sources, on the CPU.

Each module of ``essentials_tpu_torch/kernels/`` declares its kernels
(``_lib.Kernel``): the C entry points with their parameters, the device
kernels each wrapper launches and the counts it keeps. The library binds and
counts by these declarations alone, so a declaration that drifts from
``csrc/`` would show only on the card; these tests read the sources instead.
"""

import importlib.util
import re
import sys
from pathlib import Path

import pytest

from essentials_tpu_torch import kernels

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "essentials_tpu_torch" / "csrc"
P, I, LL, F = kernels._lib.P, kernels._lib.I, kernels._lib.LL, kernels._lib.F

# the counts' keys before the package declared them, as its single module
# listed them by hand
LAUNCHES = ("bfs_level<int32>", "bfs_level<int8>", "collapse_levels<int32>",
            "collapse_levels<int8>", "bfs_predecessors", "spmv_rows",
            "spmv_slabs", "sssp_sweep", "sssp_predecessors",
            "kcore_level_wave", "kcore_cascade_wave", "collapse_starts",
            "expand_segments", "scan", "gather_payloads", "segment_reduce",
            "segment_minmax", "advance_count", "bitmap_intersect_counts",
            "segment_broadcast_total", "suffix_fill_update", "fused_route_or")
PASS_LAUNCHES = ("gather_payloads_pack", "sssp_sweep_push",
                 "sssp_sweep_update", "kcore_level_peel", "kcore_wave_push",
                 "bfs_level_list", "bfs_level_push", "bfs_level_pull",
                 "segment_split", "bfs_predecessors_ranges",
                 "sssp_predecessors_ranges")


def _kind(param: str):
    """The ctypes kind of one C parameter."""
    if "*" in param:
        return P
    if "long long" in param:
        return LL
    if "float" in param:
        return F
    assert re.fullmatch(r"(const )?int \w+", param.strip()), param
    return I


def _c_entries() -> dict:
    """Every ``int etpu_*(...)`` the sources define, directly or through a
    macro, with its parameters' kinds."""
    out = {}
    for path in CSRC.glob("*.cu"):
        text = path.read_text()
        for name, params in re.findall(r"\bint\s+(etpu_\w+)\s*\(([^)]*)\)\s*"
                                       r"\{", text):
            out[name] = tuple(_kind(p) for p in params.split(",")
                              if p.strip())
        for macro, arg, params in re.findall(
                r"#define\s+(\w+)\((\w+)[^)]*\)\s*\\\s*int\s+\2\s*\(([^)]*)\)",
                text):
            kinds = tuple(_kind(p.replace("\\", ""))
                          for p in params.split(",") if p.strip())
            for name in re.findall(rf"^{macro}\((etpu_\w+)", text, re.M):
                out[name] = kinds
    return out


def _device_kernels() -> set:
    """Every ``__global__`` kernel of the sources (graphbench.harness's
    program_kernels)."""
    names = set()
    for path in CSRC.glob("*.cu*"):
        names.update(re.findall(r"__global__[^;{]*?\b(\w+_kernel)\s*\(",
                                path.read_text()))
    return names


def test_declared_entry_points_match_their_c_definitions():
    defined = _c_entries()
    assert "etpu_spmv_slabs_none_min" in defined       # made by ETPU_SLABS
    declared = {}
    for source, ks in kernels.DECLARED.items():
        text = (CSRC / source).read_text()
        for name, kinds in (*(e for k in ks for e in k.entries.items()),
                            *((g, ()) for k in ks for g in k.constants)):
            assert name not in declared, f"{name} declared twice"
            assert re.search(rf"\b{name}\b", text), (name, source)
            declared[name] = kinds
    assert declared == defined


def test_every_device_kernel_is_declared_once_per_wrapper():
    named = set()
    for key in kernels.launches:
        launched = kernels.device_kernels(key)
        assert len(set(launched)) == len(launched), key
        named.update(launched)
    assert named == _device_kernels()


def test_counts_keep_their_keys():
    assert set(kernels.launches) == set(LAUNCHES)
    assert len(kernels.launches) == len(LAUNCHES)
    assert set(kernels.pass_launches) == set(PASS_LAUNCHES)
    assert len(kernels.pass_launches) == len(PASS_LAUNCHES)


@pytest.mark.parametrize("module,source", [
    ("bfs", "bfs_kernels.cu"), ("spmv", "spmv_kernels.cu"),
    ("sssp_kcore", "sssp_kcore_kernels.cu"),
    ("operators", "operator_kernels.cu"), ("tc", "tc_kernels.cu")])
def test_wrappers_count_in_the_package_counts(module, source):
    """Every module writes the very dicts the package offers, and each
    launches key of its source names a wrapper of it that the package
    offers."""
    mod = getattr(kernels, module)
    assert mod.launches is kernels.launches
    for name in ("pass_launches", "counters"):
        if hasattr(mod, name):
            assert getattr(mod, name) is getattr(kernels, name)
    keys = [key for k in kernels.DECLARED[source] for key in k.launches]
    assert keys
    for key in keys:
        wrapper = key.split("<")[0]
        assert getattr(kernels, wrapper) is getattr(mod, wrapper)
        assert kernels.declared(key)[0] == source
        assert re.fullmatch(r"\w+\.py:\d+",
                            kernels.declared(key)[1].launches[key])


MODULES = ("_lib", "operators", "bfs", "spmv", "sssp_kcore", "tc")


@pytest.mark.parametrize("module", MODULES)
def test_package_offers_each_module_all(module):
    """The package's names are its modules' ``__all__``, the very objects."""
    mod = getattr(kernels, module)
    for name in mod.__all__:
        assert getattr(kernels, name) is getattr(mod, name), name


def test_package_offers_nothing_else():
    offered = {n for n in vars(kernels) if not n.startswith("_")}
    assert offered - set(MODULES) == {n for m in MODULES
                                      for n in getattr(kernels, m).__all__}


@pytest.mark.parametrize("module,name", [
    ("bfs", "PRED_SPLIT"), ("bfs", "bfs_level_form"),
    ("operators", "PACK_MIN_SLOTS"), ("operators", "gather_packs"),
    ("_lib", "P"), ("_lib", "I"), ("_lib", "LL"), ("_lib", "F"),
    ("_lib", "Kernel"), ("_lib", "declare"), ("_lib", "ctypes")])
def test_package_leaves_out(module, name):
    """A value a wrapper reads at call time lives in its module alone, so a
    patch of it on the package raises instead of changing nothing; the
    ctypes kinds and the declaring helpers stay in ``_lib``."""
    assert hasattr(getattr(kernels, module), name)
    assert not hasattr(kernels, name)


def test_pred_split_rebound_in_bfs_sizes_the_scratch(monkeypatch):
    """Both predecessor wrappers size their scratch and pass their split
    from ``kernels.bfs``: rebinding PRED_SPLIT there takes effect."""
    ep = 10_000
    before = kernels.pred_scratch(ep, "cpu").numel()
    assert before == 4 + 4 * (ep // kernels.bfs.PRED_SPLIT + 1)
    monkeypatch.setattr(kernels.bfs, "PRED_SPLIT", 1)
    assert kernels.pred_scratch(ep, "cpu").numel() == 4 + 4 * (ep + 1)
    assert kernels.sssp_kcore._predecessors is kernels.bfs._predecessors


def test_load_kernels_takes_either_layout(monkeypatch, tmp_path):
    """chip_ab.load_kernels imports a checkout's kernels/ package with its
    own modules, or a single kernels.py where the checkout has one."""
    monkeypatch.syspath_prepend(str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_ab",
                                                  ROOT / "chip_ab.py")
    ab = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ab)
    before = set(sys.modules)
    try:
        copy = ab.load_kernels(ROOT)
        assert copy is not kernels and copy.launches is not kernels.launches
        assert list(copy.launches) == list(kernels.launches)
        assert copy.bfs.launches is copy.launches
        assert copy.library_path() == kernels.library_path()
        single = tmp_path / "essentials_tpu_torch"
        single.mkdir()
        (single / "kernels.py").write_text("launches = {'scan': 0}\n")
        old = ab.load_kernels(tmp_path)
        assert old.launches == {"scan": 0} and not hasattr(old, "bfs")
        assert sorted(ab.wrappers()) == sorted({k.split("<")[0]
                                                for k in LAUNCHES})
    finally:
        for name in set(sys.modules) - before:
            del sys.modules[name]
