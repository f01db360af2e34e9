"""Graph algorithms. Counterpart of ``essentials_tpu/algorithms``; ported so
far: ``bfs`` (variants ``fused`` and ``fused8``), ``spmv`` (``fused`` and
``windowed``), and ``pr`` and ``hits`` (``spmv``)."""

from essentials_tpu_torch.algorithms import bfs, hits, pr, spmv

__all__ = ["bfs", "hits", "pr", "spmv"]
