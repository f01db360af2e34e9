"""wave_peeled_share: of the vertices the k-core waves' dense passes read,
the share they peeled, in %: 100 x the program's ``kcore.peeled`` over its
``kcore.waves`` times the graph's 2^scale vertices
(``essentials_tpu_torch.kernels.counters``). A wave of ``fused``, the
cell's variant, reads all V vertices, so the rest is work that found
nothing. The counters hold every wave of the run's process: the set-up's
warm call and each traced take's warm query besides the traced queries
(``Run`` holds no counter delta); every query peels the same graph, so the
share is the queries' own. Nothing where the program keeps no such
counters or ran no wave."""


def read(run):
    from essentials_tpu_torch import kernels
    counters = getattr(kernels, "counters", {})
    waves = counters.get("kcore.waves", 0)
    if not waves or run.cell is None:
        return None
    scanned = waves * (1 << run.cell.config["scale"])
    return 100.0 * counters.get("kcore.peeled", 0) / scanned
