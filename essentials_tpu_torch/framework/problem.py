"""Problem: the reference's object-oriented wrapper over the functional core.

Counterpart of ``essentials_tpu/framework/problem.py`` (reference parity:
problem_t, framework/problem.hxx:29-59): a graph plus an algorithm's
parameters, with ``init()`` / ``reset()`` building its state and ``enact()``
running the enactor's loop over the algorithm's ``step``:

    problem = BfsProblem(graph, source=0)
    result = problem.enact()          # EnactResult; state in result.state
"""

from __future__ import annotations

from essentials_tpu_torch.graph.graph import Graph


class Problem:
    """Subclass, implement init()/step_fn()/converged_fn(); ``enact()``
    drives the loop."""

    def __init__(self, graph: Graph, **params):
        self.graph = graph
        self.params = params

    def init(self):
        raise NotImplementedError

    def step_fn(self):
        """(graph, state, iteration) -> state."""
        raise NotImplementedError

    def converged_fn(self):
        """(graph, state, iteration) -> bool; None = default (empty
        frontier, enactor.hxx:294-296)."""
        return None

    def reset(self):
        """Reference problem_t::reset(): a fresh state (reset == init)."""
        return self.init()

    def enact(self, *, max_iterations: int | None = None,
              warmup: bool = True):
        from essentials_tpu_torch.framework.enactor import enact
        max_it = (max_iterations if max_iterations is not None
                  else self.graph.n_vertices + 1)
        return enact(self.step_fn(), self.converged_fn(), self.graph,
                     self.init(), max_iterations=max_it, warmup=warmup)


class BfsProblem(Problem):
    """BFS through the Problem API (the reference's bfs::problem_t shape,
    algorithms/bfs.hxx:29-108): the adaptive frontier's ``bfs.step``."""

    def init(self):
        from essentials_tpu_torch.algorithms import bfs
        return bfs.init(self.graph, self.params["source"])

    def step_fn(self):
        from essentials_tpu_torch.algorithms import bfs
        return bfs.step


class SsspProblem(Problem):
    """SSSP through the Problem API (sssp.hxx:29-108 shape)."""

    def init(self):
        from essentials_tpu_torch.algorithms import sssp
        return sssp.init(self.graph, self.params["source"])

    def step_fn(self):
        from essentials_tpu_torch.algorithms import sssp
        return sssp.step
