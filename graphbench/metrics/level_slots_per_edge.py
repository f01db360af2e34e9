"""level_slots_per_edge: the edge slots the BFS levels' chosen forms may
read, over the directed edges of the queries' components: (the program's
``bfs_level.push_slots`` + ``bfs_level.pull_slots``) / (2 x the sum of the
queries' undirected component edges), from
``essentials_tpu_torch.kernels.counters``. A push level may read its
frontier's out-slots, a pull level its unreached vertices' in-slots; 1 is a
top-down search that reads each edge once. The counters hold every level
of the run's process: the set-up's warm call and ``auto``'s probe and each
traced take's warm query besides the traced queries (``Run`` holds no
counter delta), so the share reads above the queries' own. Nothing where
the program keeps no such counters or no level ran on the card."""


def read(run):
    from essentials_tpu_torch import kernels
    counters = getattr(kernels, "counters", {})
    slots = (counters.get("bfs_level.push_slots", 0)
             + counters.get("bfs_level.pull_slots", 0))
    edges = 2 * sum(q.edges for q in run.queries)
    if not slots or not edges:
        return None
    return slots / edges
