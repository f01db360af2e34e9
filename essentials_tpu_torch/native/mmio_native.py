"""ctypes binding for the native .mtx parser (``mmio.cpp``).

Counterpart of ``essentials_tpu/native/mmio_native.py``. The library is
built at first use with the host C++ compiler (``c++``) into
``build/essentials_tpu_torch/libetpu_mmio_<hash>.so`` beside the package,
named by a hash of the source and the flags, as ``kernels.build`` names the
CUDA library; it is written to a temporary file and moved into place, so
several processes may build it at once. A compiler that is missing or fails
raises EssentialsError: nothing falls back to the NumPy parser.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from essentials_tpu_torch.errors import EssentialsError
from essentials_tpu_torch.kernels import BUILD_DIR

SOURCE = Path(__file__).resolve().parent / "mmio.cpp"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lib = None


class _EtpuCoo(ctypes.Structure):
    _fields_ = [
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("nnz", ctypes.c_int64),
        ("rows", ctypes.POINTER(ctypes.c_int32)),
        ("cols", ctypes.POINTER(ctypes.c_int32)),
        ("vals", ctypes.POINTER(ctypes.c_float)),
        ("err", ctypes.c_char * 256),
    ]


def compiler() -> str:
    """The host C++ compiler, ``c++`` on the PATH."""
    path = shutil.which("c++")
    if path is None:
        raise EssentialsError("C++ compiler 'c++' not found: the native "
                              ".mtx parser builds with it")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libetpu_mmio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``mmio.cpp`` unless a library of the same source exists."""
    path = library_path()
    if path.exists():
        return path
    cxx = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.tmp")
    r = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise EssentialsError(f"{cxx} failed on {SOURCE.name} "
                              f"({r.returncode}):\n{r.stdout}{r.stderr}")
    os.replace(tmp, path)           # atomic: a reader sees all or nothing
    return path


def _load_lib():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.etpu_load_mtx.restype = ctypes.POINTER(_EtpuCoo)
        lib.etpu_load_mtx.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.etpu_coo_free.restype = None
        lib.etpu_coo_free.argtypes = [ctypes.POINTER(_EtpuCoo)]
        _lib = lib
    return _lib


def load_mtx(path: str, expand_symmetric: bool = True):
    """Returns (n_rows, n_cols, rows, cols, vals), or None for a file in
    array format, which the NumPy parser reads. Raises EssentialsError on a
    file that does not parse."""
    lib = _load_lib()
    ptr = lib.etpu_load_mtx(os.fsencode(path), int(expand_symmetric))
    if not ptr:
        raise MemoryError("etpu_load_mtx allocation failure")
    c = ptr.contents
    try:
        err = bytes(c.err).split(b"\0", 1)[0].decode()
        if err:
            if "coordinate format only" in err:
                return None
            raise EssentialsError(f"mtx parse error ({path}): {err}")
        n = int(c.nnz)
        rows = np.ctypeslib.as_array(c.rows, shape=(n,)).copy()
        cols = np.ctypeslib.as_array(c.cols, shape=(n,)).copy()
        vals = np.ctypeslib.as_array(c.vals, shape=(n,)).copy()
        return int(c.n_rows), int(c.n_cols), rows, cols, vals
    finally:
        lib.etpu_coo_free(ptr)
