"""device_ops_per_query: the device's kernels, memsets and copies inside
the traced queries, over the queries. Nothing where the trace was not
whole."""


def read(run):
    if run.trace is None or not run.queries:
        return None
    return sum(x.ops for x in run.queries) / len(run.queries)
