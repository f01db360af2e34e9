"""Graph algorithms. Counterpart of ``essentials_tpu/algorithms``; ported so
far: ``bfs`` (variants ``fused``, ``fused8``, ``hybrid``, ``phased``,
``adaptive`` and the timed ``auto``), ``spmv`` (``fused``, ``windowed``,
``pull`` and ``push``), ``pr`` (``spmv``, ``fused`` and ``generic``),
``hits`` (``spmv`` and ``generic``), ``sssp`` (``fused``, ``windowed`` and
``adaptive``), ``kcore`` (``fused`` and ``adaptive``), ``tc`` (``dense``,
``bitmap``, ``sorted`` and ``shift``), ``color`` (``jp`` and ``spec``),
``bc`` (``spmv``, ``generic`` and ``run_all``), ``ppr`` (``run`` and
``run_batch``), ``mst`` (Borůvka), ``geo`` (``run`` and
``spatial_median``), ``spgemm`` (the static plan and the chunked path) and
``helpers`` (search, sort, random fill): all thirteen algorithms of the JAX
package."""

from essentials_tpu_torch.algorithms import (bc, bfs, color, geo, helpers,
                                             hits, kcore, mst, pr, ppr,
                                             spgemm, spmv, sssp, tc)

__all__ = ["bc", "bfs", "color", "geo", "helpers", "hits", "kcore", "mst",
           "pr", "ppr", "spgemm", "spmv", "sssp", "tc"]
