"""Graph algorithms. Counterpart of ``essentials_tpu/algorithms``; ported so
far: ``bfs`` (variants ``fused``, ``fused8`` and ``adaptive``), ``spmv``
(``fused``, ``windowed``, ``pull`` and ``push``), ``pr`` and ``hits``
(``spmv``), ``sssp`` (``fused``, ``windowed`` and ``adaptive``) and
``kcore`` (``fused``)."""

from essentials_tpu_torch.algorithms import bfs, hits, kcore, pr, spmv, sssp

__all__ = ["bfs", "hits", "kcore", "pr", "spmv", "sssp"]
