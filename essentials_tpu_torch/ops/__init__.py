"""Operators. Counterpart of ``essentials_tpu/ops``; ported so far:
``fused_bfs``, ``fused_spmv``, ``windowed_spmv``, ``fused_sssp``,
``windowed_sssp`` and ``fused_kcore`` (see ROADMAP.md, queue 1)."""

from essentials_tpu_torch.ops import (fused_bfs, fused_kcore, fused_sssp,
                                      fused_spmv, windowed_spmv,
                                      windowed_sssp)

__all__ = ["fused_bfs", "fused_kcore", "fused_sssp", "fused_spmv",
           "windowed_spmv", "windowed_sssp"]
