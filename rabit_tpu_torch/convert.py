"""Carry trained parameters from the JAX package into the port.

The JAX package hands its parameters over as numpy arrays (a
``rabit_tpu.learn.kmeans.KMeansModel`` keeps its centroids as one; a
``BoostedModel``'s trees unpack into one array per tree, a
``LinearModel`` keeps its weights as one), so conversion checks shape
and dtype and copies; nothing here imports the JAX package.
"""
from __future__ import annotations

import numpy as np

from rabit_tpu_torch.learn.boosting import BoostedModel, TreeNode
from rabit_tpu_torch.learn.kmeans import KMeansModel
from rabit_tpu_torch.learn.linear import (LOSS_LINEAR, LOSS_LOGISTIC,
                                          LinearModel)

# columns of one tree's (m, 6) array in boosted_from_jax
TREE_COLUMNS = ("feature", "bin_threshold", "value", "left", "right",
                "default_left")


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


def _tree_from_array(i: int, a: np.ndarray) -> list[TreeNode]:
    if not isinstance(a, np.ndarray) or not np.issubdtype(a.dtype,
                                                          np.floating):
        raise TypeError(f"tree {i} must be a floating numpy array")
    if a.ndim != 2 or a.shape[0] < 1 or a.shape[1] != len(TREE_COLUMNS):
        raise ValueError(f"tree {i} must be (m >= 1, {len(TREE_COLUMNS)}), "
                         f"got shape {a.shape}")
    ints = a[:, [0, 1, 3, 4, 5]]
    if not np.isfinite(a).all() or (ints != np.round(ints)).any():
        raise ValueError(f"tree {i}: non-finite values, or non-integral "
                         "feature/threshold/child/direction entries")
    m = a.shape[0]
    nodes = []
    for row in a:
        node = TreeNode(int(row[0]), int(row[1]), float(row[2]), int(row[3]),
                        int(row[4]), bool(row[5]))
        if node.feature >= 0 and not (0 < node.left < m
                                      and 0 < node.right < m):
            raise ValueError(f"tree {i}: a split's children lie outside "
                             f"its {m} nodes")
        nodes.append(node)
    return nodes


def boosted_from_jax(cuts: np.ndarray, trees: list[np.ndarray],
                     base_score: float, learning_rate: float, loss: str,
                     has_missing: bool) -> BoostedModel:
    """A port :class:`BoostedModel` from a JAX package model's parts:
    ``cuts`` its (f, nbin-1) float32 cut matrix, ``trees`` one (m, 6)
    floating array per tree with the columns of ``TREE_COLUMNS`` (node i
    in row i; ``default_left`` 1 or 0).

    Raises ``TypeError`` for a cut matrix that is not float32 or a tree
    that is not floating, and ``ValueError`` for a wrong shape, an
    unknown loss, a split feature or child out of range.
    """
    if not isinstance(cuts, np.ndarray) or cuts.dtype != np.float32:
        raise TypeError(f"cuts must be a float32 numpy array, got "
                        f"{getattr(cuts, 'dtype', type(cuts).__name__)}")
    if cuts.ndim != 2 or cuts.shape[0] < 1:
        raise ValueError(f"cuts must be (f >= 1, nbin - 1), got shape "
                         f"{cuts.shape}")
    if loss not in ("logistic", "squared"):
        raise ValueError(f"loss must be logistic or squared, got {loss!r}")
    forest = [_tree_from_array(i, a) for i, a in enumerate(trees)]
    for i, tree in enumerate(forest):
        if any(node.feature >= cuts.shape[0] for node in tree):
            raise ValueError(f"tree {i} splits on a feature >= f = "
                             f"{cuts.shape[0]}")
    return BoostedModel(cuts=np.array(cuts, copy=True), trees=forest,
                        base_score=float(base_score),
                        learning_rate=float(learning_rate), loss=loss,
                        has_missing=bool(has_missing))


def linear_from_jax(weight: np.ndarray, base_score: float, num_feature: int,
                    loss_type: int) -> LinearModel:
    """A port :class:`LinearModel` from a JAX package ``LinearModel``'s
    parts: ``weight`` its (num_feature + 1,) floating vector (the bias
    last), ``base_score`` (already through the logit once trained),
    ``num_feature`` and ``loss_type`` (0 linear, 1 logistic).

    Raises ``TypeError`` for a weight vector that is not floating, and
    ``ValueError`` for a shape other than (num_feature + 1,), a negative
    ``num_feature``, an unknown loss type or a non-finite value.
    """
    if not isinstance(weight, np.ndarray) or not np.issubdtype(
            weight.dtype, np.floating):
        raise TypeError(f"weight must be a floating numpy array, got "
                        f"{getattr(weight, 'dtype', type(weight).__name__)}")
    if int(num_feature) != num_feature or num_feature < 0:
        raise ValueError(f"num_feature must be an integer >= 0, got "
                         f"{num_feature!r}")
    if weight.shape != (int(num_feature) + 1,):
        raise ValueError(f"weight must have shape ({int(num_feature) + 1},) "
                         f"(num_feature + 1), got {weight.shape}")
    if loss_type not in (LOSS_LINEAR, LOSS_LOGISTIC):
        raise ValueError(f"loss_type must be {LOSS_LINEAR} (linear) or "
                         f"{LOSS_LOGISTIC} (logistic), got {loss_type!r}")
    if not (np.isfinite(weight).all() and np.isfinite(base_score)):
        raise ValueError("weight and base_score must be finite")
    model = LinearModel()
    model.weight = np.array(weight, dtype=np.float64, copy=True)
    model.base_score = float(base_score)
    model.num_feature = int(num_feature)
    model.loss_type = int(loss_type)
    return model
