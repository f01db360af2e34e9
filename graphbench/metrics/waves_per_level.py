"""waves_per_level: the k-core waves a level k takes, each a host round
trip: the program's ``kcore.waves`` (a query's waves are its
``iterations``, as ``levels_per_query`` reads them) over the levels they
peeled at, its ``kcore.levels`` (``essentials_tpu_torch.kernels.counters``).
A level takes one wave and one more for each cascade inside it. The
counters hold every run of the run's process (the set-up's warm call, each
traced take's warm query) and count waves and levels over the same runs;
every run peels the same graph, so the ratio is each query's own. Nothing
where the program keeps no such counters or ran no wave."""


def read(run):
    from essentials_tpu_torch import kernels
    counters = getattr(kernels, "counters", {})
    waves = counters.get("kcore.waves", 0)
    levels = counters.get("kcore.levels", 0)
    if not waves or not levels:
        return None
    return waves / levels
