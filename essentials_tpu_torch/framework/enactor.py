"""Enactor: the superstep loop.

Counterpart of ``essentials_tpu/framework/enactor.py:28-88`` (reference
parity: enactor_t::enact(), enactor.hxx:243-310: prepare, a timed
``while (!converged)`` loop, finalize). The JAX package runs the loop as one
``lax.while_loop``; here it is a loop on the host with the same semantics:
convergence is checked before every iteration after the first, and the loop
stops after ``max_iterations`` iterations.

Each check costs a read of the device. A state may carry the size of its
frontier already read to the host (a ``live`` field, as the adaptive BFS and
SSSP states do, which read it in the same transfer as their tier inputs);
``default_converged`` then reads nothing more, and a step costs one host
sync.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable

from essentials_tpu_torch.utils.timer import Timer


@dataclass
class EnactResult:
    state: Any
    iterations: int
    elapsed_ms: float


def default_converged(graph, state, iteration) -> bool:
    """Reference default: stop when the frontier is empty
    (enactor.hxx:294-296). Reads ``state.live`` where the state has it,
    else ``state.frontier`` (or ``state[-1]``)."""
    live = getattr(state, "live", None)
    if live is not None:
        return live == 0
    frontier = getattr(state, "frontier", None)
    if frontier is None:
        frontier = state[-1]
    return not bool(frontier.any())


def _loop(step_fn, converged_fn, graph, state, max_iterations):
    it = 0
    while it < max_iterations:
        if it > 0 and converged_fn(graph, state, it):
            break
        state = step_fn(graph, state, it)
        it += 1
    return state, it


def enact(step_fn: Callable, converged_fn: Callable | None, graph,
          init_state, *, max_iterations: int = 1 << 30,
          warmup: bool = True) -> EnactResult:
    """Run ``state = step_fn(graph, state, it)`` until ``converged_fn(graph,
    state, it)`` (checked before every iteration after the first) or
    ``max_iterations``. ``elapsed_ms`` covers the loop only, on the device's
    clock (CUDA events) or the host's (CPU), after one untimed run when
    ``warmup``."""
    if converged_fn is None:
        converged_fn = default_converged
    if warmup:
        _loop(step_fn, converged_fn, graph, init_state, max_iterations)
    timer = Timer(graph.device).begin()
    state, it = _loop(step_fn, converged_fn, graph, init_state,
                      max_iterations)
    return EnactResult(state=state, iterations=it, elapsed_ms=timer.end())
