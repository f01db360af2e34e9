"""levels_per_query: the mean of the queries' own ``iterations`` (BFS
levels or SSSP sweeps, each one host read in the entry's loop)."""


def read(run):
    q = run.queries
    return sum(x.levels for x in q) / len(q) if q else None
