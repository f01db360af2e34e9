"""sweep_improved_share: of the vertices the SSSP sweeps relaxed, the share
whose distance improved, in %: 100 x the program's ``sssp.improved`` over
its ``sssp.swept`` (``essentials_tpu_torch.kernels.counters``). A windowed
or fused sweep relaxes all V vertices, so the rest is work that found
nothing. The counters hold every sweep of the run's process: the set-up's
warm call and each traced take besides the traced queries (``Run`` holds
no counter delta). Nothing where the program keeps no such counters or
ran no sweep."""


def read(run):
    from essentials_tpu_torch import kernels
    counters = getattr(kernels, "counters", {})
    swept = counters.get("sssp.swept", 0)
    if not swept:
        return None
    return 100.0 * counters.get("sssp.improved", 0) / swept
