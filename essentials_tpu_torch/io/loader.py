"""Unified dataset loader with binary caching.

Counterpart of ``essentials_tpu/io/loader.py`` (reference parity: gunrock
``util/filepath.hxx:8-27`` is_market/is_binary_csr, and the examples'
load-or-cache pattern): expensive .mtx parses are cached as .csr.npz next to
the source file.
"""

from __future__ import annotations

import os

from essentials_tpu_torch.errors import throw_if
from essentials_tpu_torch.formats.csr import Csr
from essentials_tpu_torch.io.matrix_market import load_mtx
from essentials_tpu_torch.io.smtx import load_smtx


def extract_filename(path: str) -> str:
    return os.path.basename(path)


def extract_dataset(path: str) -> str:
    name = extract_filename(path)
    return name.rsplit(".", 1)[0] if "." in name else name


def is_market(path: str) -> bool:
    return path.endswith(".mtx") or path.endswith(".mmio")


def is_smtx(path: str) -> bool:
    return path.endswith(".smtx")


def is_binary_csr(path: str) -> bool:
    return path.endswith(".csr") or path.endswith(".csr.npz")


def load_graph_file(path: str, *, cache: bool = True,
                    expand_symmetric: bool = True) -> Csr:
    """Load .mtx/.smtx/.csr(.npz) into a host Csr; cache .mtx parses."""
    if is_binary_csr(path):
        return Csr.read_binary(path if path.endswith(".npz") else path + ".npz")
    if is_smtx(path):
        return load_smtx(path)
    throw_if(not is_market(path), f"unrecognized graph file extension: {path}")
    cache_path = path + ".csr.npz"
    if cache and os.path.exists(cache_path) and (
            os.path.getmtime(cache_path) >= os.path.getmtime(path)):
        return Csr.read_binary(cache_path)
    coo = load_mtx(path, expand_symmetric=expand_symmetric)
    csr = Csr.from_coo(coo)
    if cache:
        try:
            csr.write_binary(cache_path)
        except OSError:
            pass        # a read-only dataset directory only loses the cache
    return csr
