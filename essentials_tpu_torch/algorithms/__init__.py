"""Graph algorithms. Counterpart of ``essentials_tpu/algorithms``; ported so
far: ``bfs`` (variants ``fused``, ``fused8`` and ``adaptive``), ``spmv``
(``fused``, ``windowed``, ``pull`` and ``push``), ``pr`` (``spmv`` and
``fused``), ``hits`` (``spmv``), ``sssp`` (``fused``, ``windowed`` and
``adaptive``), ``kcore`` (``fused``) and ``tc`` (``dense``, ``bitmap``,
``sorted`` and ``shift``)."""

from essentials_tpu_torch.algorithms import bfs, hits, kcore, pr, spmv, sssp, tc

__all__ = ["bfs", "hits", "kcore", "pr", "spmv", "sssp", "tc"]
