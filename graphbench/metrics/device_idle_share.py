"""device_idle_share: the share of the traced window, from the first
query's start to the last one's end, in which no kernel, memset or copy
ran on the device, in %. Nothing where the trace was not whole."""


def read(run):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
