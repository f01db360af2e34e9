"""Graph algorithms. Counterpart of ``essentials_tpu/algorithms``; ported so
far: ``bfs`` (variants ``fused`` and ``fused8``), ``spmv`` (``fused`` and
``windowed``), ``pr`` and ``hits`` (``spmv``), ``sssp`` (``fused`` and
``windowed``) and ``kcore`` (``fused``)."""

from essentials_tpu_torch.algorithms import bfs, hits, kcore, pr, spmv, sssp

__all__ = ["bfs", "hits", "kcore", "pr", "spmv", "sssp"]
