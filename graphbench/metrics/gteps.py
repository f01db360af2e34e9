"""gteps: the undirected edges of the sources' components, summed over
every query of the window, over the window's wall time, in 1e9 a second
(Graph500's and GAP's TEPS, taken over all the work and all the time)."""


def read(run):
    if run.window_s <= 0:
        return None
    return sum(q.edges for q in run.queries) / run.window_s / 1e9
