"""Graph algorithms. Counterpart of ``essentials_tpu/algorithms``; only
``bfs`` (variants ``fused`` and ``fused8``) is ported so far."""

from essentials_tpu_torch.algorithms import bfs

__all__ = ["bfs"]
