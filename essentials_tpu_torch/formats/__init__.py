"""Host-side sparse format containers (COO/CSR/CSC) and conversions.

Counterpart of ``essentials_tpu/formats`` (reference parity: gunrock
``include/gunrock/formats/``): NumPy-backed host containers. The device
representation is the padded ``essentials_tpu_torch.graph.Graph`` of
tensors, built from these.
"""

from essentials_tpu_torch.formats.coo import Coo
from essentials_tpu_torch.formats.csr import Csr
from essentials_tpu_torch.formats.csc import Csc

__all__ = ["Coo", "Csr", "Csc"]
