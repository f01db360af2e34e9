"""Utilities: compare and timer.

Counterpart of ``essentials_tpu/utils`` (``printing``, ``stats`` and
``checkpoint`` are not ported yet).
"""

from essentials_tpu_torch.utils.compare import compare
from essentials_tpu_torch.utils.timer import Timer

__all__ = ["compare", "Timer"]
