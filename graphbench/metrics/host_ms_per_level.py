"""host_ms_per_level: the queries' traced time not covered by device
activity, over their levels: (sum of query spans - sum of device-busy time
inside them) / sum of levels, in ms. Nothing where the trace was not
whole."""


def read(run):
    if run.trace is None:
        return None
    q = run.queries
    levels = sum(x.levels for x in q)
    if not levels:
        return None
    return 1e3 * sum(x.span_s - x.busy_s for x in q) / levels
