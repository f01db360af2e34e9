"""Operators. Counterpart of ``essentials_tpu/ops``; ported so far:
``fused_bfs``, ``fused_spmv`` and ``windowed_spmv`` (see ROADMAP.md,
queue 1)."""
