"""query_roofline: the traced queries' share of the device's memory
roofline, in %: the bytes each must move (its algorithm's byte model:
its component's edges read once, the distances and predecessors written
once) at the card's published HBM rate, over the device-busy time inside
the queries. Nothing where the trace was not whole, no device time was
seen, or the card is not in the table of peaks."""

from graphbench.peaks import HBM_BYTES_PER_S


def read(run):
    rate = HBM_BYTES_PER_S.get(run.device_kind)
    if run.trace is None or rate is None:
        return None
    busy = sum(x.busy_s for x in run.queries)
    if busy <= 0:
        return None
    return 100.0 * sum(x.bytes for x in run.queries) / rate / busy
