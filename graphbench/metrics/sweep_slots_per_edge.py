"""sweep_slots_per_edge: the CSR slots the SSSP sweeps read, over the
directed edges of the queries' components: the program's
``sssp.push_slots`` / (2 x the sum of the queries' undirected component
edges), from ``essentials_tpu_torch.kernels.counters``. A fused sweep reads
the rows of the vertices whose distance changed in the sweep before, a
windowed sweep every slot; so a search of windowed sweeps reads its sweep
count. The counters hold every sweep of the run's process: the set-up's
warm call and each traced take's warm query besides the traced queries
(``Run`` holds no counter delta), so the ratio reads above the queries'
own. Nothing where the program keeps no such counter or ran no sweep."""


def read(run):
    from essentials_tpu_torch import kernels
    slots = getattr(kernels, "counters", {}).get("sssp.push_slots", 0)
    edges = 2 * sum(q.edges for q in run.queries)
    if not slots or not edges:
        return None
    return slots / edges
