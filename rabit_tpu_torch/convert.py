"""Carry trained parameters from the JAX package into the port.

The JAX package hands its parameters over as numpy arrays (a
``rabit_tpu.learn.kmeans.KMeansModel`` keeps its centroids as one), so
conversion checks shape and dtype and copies; nothing here imports the
JAX package.
"""
from __future__ import annotations

import numpy as np

from rabit_tpu_torch.learn.kmeans import KMeansModel


def kmeans_from_jax(centroids: np.ndarray,
                    hash_dim: int | None = None) -> KMeansModel:
    """A port :class:`KMeansModel` from the JAX package's (k, d)
    centroid matrix and its ``hash_dim``.

    Raises ``TypeError`` for a non-floating matrix and ``ValueError``
    for a shape that is not (k >= 1, d >= 1), or a ``hash_dim`` that is
    not a power of two equal to d.
    """
    if not isinstance(centroids, np.ndarray):
        raise TypeError(f"centroids must be a numpy array, got "
                        f"{type(centroids).__name__}")
    if not np.issubdtype(centroids.dtype, np.floating):
        raise TypeError(f"centroids must be floating point, got "
                        f"{centroids.dtype}")
    if centroids.ndim != 2 or 0 in centroids.shape:
        raise ValueError(f"centroids must be (k, d) with k, d >= 1, got "
                         f"shape {centroids.shape}")
    if hash_dim is not None:
        if hash_dim <= 0 or hash_dim & (hash_dim - 1):
            raise ValueError(f"hash_dim must be a power of two, got "
                             f"{hash_dim}")
        if centroids.shape[1] != hash_dim:
            raise ValueError(f"centroids width {centroids.shape[1]} != "
                             f"hash_dim {hash_dim}")
    return KMeansModel(np.array(centroids, dtype=np.float32, copy=True),
                       hash_dim)
