"""Point-cloud generators for nearest-neighbor style examples.

Counterpart of ``essentials_tpu/io/points.py`` (reference parity: gunrock
``io/points.hxx:26-49``): uniform random points and "star" clusters around
randomly placed centers. Host NumPy with the same ``default_rng`` draws, so
the points are the JAX package's bit for bit.
"""

from __future__ import annotations

import numpy as np


def random_points(n: int, dim: int = 2, *, seed: int = 0,
                  low: float = 0.0, high: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.uniform(low, high, size=(n, dim)).astype(np.float32)


def star_points(n_stars: int, points_per_star: int, dim: int = 2, *,
                seed: int = 0, spread: float = 0.02) -> np.ndarray:
    """Clustered points: ``n_stars`` centers, gaussian blobs around each."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.0, 1.0, size=(n_stars, dim))
    blobs = centers[:, None, :] + rng.normal(
        0.0, spread, size=(n_stars, points_per_star, dim))
    return blobs.reshape(-1, dim).astype(np.float32)
