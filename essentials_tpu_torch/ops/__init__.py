"""Operators. Counterpart of ``essentials_tpu/ops``; only ``fused_bfs`` is
ported so far (see ROADMAP.md, queue 1)."""
