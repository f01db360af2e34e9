import pytest


@pytest.fixture
def fresh_auto():
    """BFS's auto keeps its probe's choice per graph shape in the process:
    each test probes anew."""
    from essentials_tpu_torch.algorithms import bfs
    bfs._auto_cache.clear()
    yield
    bfs._auto_cache.clear()
