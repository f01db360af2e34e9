"""Graph IO: Matrix Market (.mtx), .smtx, binary cache, fixtures, generators.

Counterpart of ``essentials_tpu/io`` (reference parity: gunrock
``include/gunrock/io/``). Host-side NumPy, and the native C++ ``.mtx``
parser of ``essentials_tpu_torch/native``; ``points`` makes point clouds.
"""

from essentials_tpu_torch.io.matrix_market import load_mtx, write_mtx
from essentials_tpu_torch.io.points import random_points, star_points
from essentials_tpu_torch.io.smtx import load_smtx
from essentials_tpu_torch.io.sample import sample_csr, sample_coo
from essentials_tpu_torch.io.loader import load_graph_file, is_market, is_binary_csr
from essentials_tpu_torch.io import generate

__all__ = [
    "load_mtx", "write_mtx", "random_points", "star_points", "load_smtx", "sample_csr", "sample_coo",
    "load_graph_file", "is_market", "is_binary_csr", "generate",
]
