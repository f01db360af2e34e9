"""query_p95_ms: the 95th percentile of every query's host wall time in
the window, from just before the call to just after the device's
synchronize (nearest rank, over all queries)."""

import math


def read(run):
    walls = sorted(q.wall_s for q in run.queries)
    if not walls:
        return None
    return 1e3 * walls[math.ceil(0.95 * len(walls)) - 1]
