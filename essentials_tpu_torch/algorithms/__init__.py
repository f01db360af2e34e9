"""Graph algorithms. Counterpart of ``essentials_tpu/algorithms``; ported so
far: ``bfs`` (variants ``fused``, ``fused8`` and ``adaptive``), ``spmv``
(``fused``, ``windowed``, ``pull`` and ``push``), ``pr`` (``spmv``,
``fused`` and ``generic``), ``hits`` (``spmv`` and ``generic``), ``sssp``
(``fused``, ``windowed`` and ``adaptive``), ``kcore`` (``fused``), ``tc``
(``dense``, ``bitmap``, ``sorted`` and ``shift``) and ``color`` (``jp``
and ``spec``)."""

from essentials_tpu_torch.algorithms import (bfs, color, hits, kcore, pr,
                                             spmv, sssp, tc)

__all__ = ["bfs", "color", "hits", "kcore", "pr", "spmv", "sssp", "tc"]
