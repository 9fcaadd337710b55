"""Gradient-boosted trees over the histogram allreduce, on PyTorch
(counterpart of :mod:`rabit_tpu.learn.boosting`).

Workers hold row shards, build per-node gradient histograms and
Allreduce<Sum> them so that every worker picks the same split: logistic
or squared loss, level-wise trees, split gain from second-order
statistics, one checkpoint per boosting round.  The features are
quantile-binned once on the host; the transposed (f, n) int32 bins go up
to the device once and stay there across levels and rounds, and every
level's histograms come from one pass of the CUDA kernel of
:mod:`rabit_tpu_torch.ops.histogram_kernel` (the node masks folded into
its weight channels).  The trees, the split search and the margins stay
numpy, as in the JAX package.

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); a missing card is an error, not a fallback.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

import rabit_tpu_torch
from rabit_tpu_torch.learn import histogram
from rabit_tpu_torch.ops import MAX, SUM
from rabit_tpu_torch.utils.checks import check
from rabit_tpu_torch.utils.device import resolve_device


@dataclass
class TreeNode:
    feature: int = -1          # -1 = leaf
    bin_threshold: int = 0     # go left if bin <= threshold
    value: float = 0.0         # leaf weight
    left: int = -1
    right: int = -1
    # learned default direction for missing values (rows whose bin is
    # the missing bin go this way)
    default_left: bool = True


@dataclass
class BoostedModel:
    """A forest of binned trees and the quantile cuts that define bins."""

    cuts: np.ndarray = field(
        default_factory=lambda: np.zeros((0, 0), np.float32))
    trees: list[list[TreeNode]] = field(default_factory=list)
    base_score: float = 0.0
    learning_rate: float = 0.3
    loss: str = "logistic"
    # does ANY rank's shard carry NaN features?  Decided once at round 0
    # (a collective) and carried in the model, so that a resumed rank
    # does not issue that collective again.
    has_missing: bool = False

    def _tree_margin(self, tree: list[TreeNode], bins: np.ndarray
                     ) -> np.ndarray:
        missing_bin = self.cuts.shape[1] + 1
        node = np.zeros(bins.shape[0], np.int32)
        out = np.zeros(bins.shape[0], np.float32)
        live = np.ones(bins.shape[0], bool)
        # level-wise walk: every row sits at some node; descend until leaf
        for _ in range(64):  # depth bound
            if not live.any():
                break
            for nid in np.unique(node[live]):
                n = tree[nid]
                rows = live & (node == nid)
                if n.feature < 0:
                    out[rows] = n.value
                    live[rows] = False
                else:
                    b = bins[rows, n.feature]
                    go_left = np.where(b == missing_bin, n.default_left,
                                       b <= n.bin_threshold)
                    idx = np.flatnonzero(rows)
                    node[idx[go_left]] = n.left
                    node[idx[~go_left]] = n.right
        return out

    def margin(self, bins: np.ndarray) -> np.ndarray:
        out = np.full(bins.shape[0], self.base_score, np.float32)
        for tree in self.trees:
            out += self.learning_rate * self._tree_margin(tree, bins)
        return out

    def predict(self, values: np.ndarray) -> np.ndarray:
        bins = apply_cuts(values, self.cuts)
        m = self.margin(bins)
        if self.loss == "logistic":
            return 1.0 / (1.0 + np.exp(-m))
        return m


# re-exported for callers binning prediction-time data
apply_cuts = histogram.apply_cuts


def _grad_hess(margin: np.ndarray, labels: np.ndarray, loss: str):
    if loss == "logistic":
        p = 1.0 / (1.0 + np.exp(-margin))
        return (p - labels).astype(np.float32), (p * (1 - p)).astype(
            np.float32)
    return (margin - labels).astype(np.float32), np.ones_like(margin)


def train(values: np.ndarray, labels: np.ndarray, num_round: int = 10,
          max_depth: int = 3, nbin: int = 32, learning_rate: float = 0.3,
          reg_lambda: float = 1.0, loss: str = "logistic",
          min_child_weight: float = 1e-3,
          subsample: float = 1.0, seed: int = 0,
          device=None, use_kernel: bool | None = None,
          compute_dtype: str | None = None) -> BoostedModel:
    """Train a booster on this rank's row shard; the JAX package's
    ``train`` on PyTorch.

    Cuts come from rank 0 and every split is taken on the allreduced
    histogram; training resumes from the last committed round.
    ``subsample < 1`` draws a fresh row sample per round, seeded by
    ``(seed, round, rank)`` so that a resumed run replays it.  NaN
    feature values are missing: they bin into a dedicated slot and every
    split learns a default direction for them.

    ``device`` (default: the card) is where the bins live and the
    histograms are built.  ``use_kernel`` (default: on a CUDA device)
    takes the CUDA histogram kernel, whose weights are rounded to
    ``compute_dtype`` (default bfloat16, as on the TPU; ``"float32"``
    keeps them exact); ``use_kernel=False`` takes the plain version,
    exact float32 unless ``compute_dtype`` says otherwise.
    """
    check(0.0 < subsample <= 1.0, "subsample must be in (0, 1], got %s",
          subsample)
    dev = resolve_device(device, "boosting")
    n, f = values.shape
    version, restored = rabit_tpu_torch.load_checkpoint()
    nan_handle = None
    if version == 0:
        # rank 0's shard defines the cuts; other ranks just receive them
        cuts = rabit_tpu_torch.broadcast(
            histogram.quantile_cuts(values, nbin)
            if rabit_tpu_torch.get_rank() == 0 else None, 0)
        # missing handling is global and decided at round 0 only (a
        # resume must not repeat the collective); the vote is issued
        # async so that it can ride the wire during the binning below
        nan_handle = rabit_tpu_torch.allreduce_async(
            np.array([np.isnan(values).any()], np.int32), MAX, fuse=False)
        model = BoostedModel(cuts=cuts, base_score=0.0,
                             learning_rate=learning_rate, loss=loss,
                             has_missing=False)
    else:
        model = restored
    bins = apply_cuts(values, model.cuts)
    if nan_handle is not None:
        model.has_missing = bool(nan_handle.wait()[0])
    has_missing = model.has_missing
    missing_bin = model.cuts.shape[1] + 1
    margin = model.margin(bins)  # recomputed once on (re)start
    # resident transposed bins: uploaded once, reused by every level and
    # round
    bins_t = torch.from_numpy(np.ascontiguousarray(bins.T)).to(dev)

    for round_idx in range(version, num_round):
        grad, hess = _grad_hess(margin, labels, model.loss)
        if subsample < 1.0:
            # zeroed grad/hess: the row adds nothing anywhere this round
            rng = np.random.default_rng(
                (seed, round_idx, rabit_tpu_torch.get_rank()))
            keep = rng.random(n) < subsample
            grad = np.where(keep, grad, 0.0).astype(np.float32)
            hess = np.where(keep, hess, 0.0).astype(np.float32)

        tree: list[TreeNode] = [TreeNode()]
        node_of_row = np.zeros(n, np.int32)
        frontier = [0]
        for depth in range(max_depth):
            next_frontier: list[int] = []
            # every live node's histogram in one bins pass and ONE
            # allreduce for the level
            hists = histogram.build_level_allreduce(
                bins, grad, hess, node_of_row, frontier,
                missing_bin + 1 if has_missing else missing_bin,
                bins_t=bins_t, use_kernel=use_kernel,
                compute_dtype=compute_dtype)
            for pos, nid in enumerate(frontier):
                hist = hists[pos]
                g_tot = hist[:, :, 0].sum(axis=1)[0]
                h_tot = hist[:, :, 1].sum(axis=1)[0]
                leaf_value = -g_tot / (h_tot + reg_lambda)
                if has_missing:
                    gain, default_left = histogram.split_gain_missing(
                        hist, reg_lambda)
                else:
                    gain = histogram.split_gain(hist, reg_lambda)
                    default_left = None
                j, t = np.unravel_index(int(gain.argmax()), gain.shape)
                dl = bool(default_left[j, t]) if has_missing else True
                hl = hist[j, :t + 1, 1].sum()
                if has_missing and dl:
                    hl += hist[j, -1, 1]
                hr = h_tot - hl
                if (gain[j, t] <= 1e-12 or hl < min_child_weight
                        or hr < min_child_weight):
                    tree[nid].value = float(leaf_value)
                    continue
                node = tree[nid]
                node.feature = int(j)
                node.bin_threshold = int(t)
                node.default_left = dl
                node.left = len(tree)
                tree.append(TreeNode())
                node.right = len(tree)
                tree.append(TreeNode())
                rows = node_of_row == nid
                b = bins[:, j]
                go_left = np.where(b == missing_bin, dl, b <= t)
                node_of_row[rows & go_left] = node.left
                node_of_row[rows & ~go_left] = node.right
                next_frontier += [node.left, node.right]
            frontier = next_frontier
            if not frontier:
                break
        # frontier nodes at max depth become leaves: one batched
        # allreduce of all their (g, h) sums
        if frontier:
            gh = np.empty((len(frontier), 2), np.float64)
            for i, nid in enumerate(frontier):
                mask = node_of_row == nid
                gh[i] = (grad[mask].sum(), hess[mask].sum())
            gh = rabit_tpu_torch.allreduce(gh.reshape(-1), SUM).reshape(-1, 2)
            for i, nid in enumerate(frontier):
                tree[nid].value = float(-gh[i, 0] / (gh[i, 1] + reg_lambda))
        model.trees.append(tree)
        margin += model.learning_rate * model._tree_margin(tree, bins)
        rabit_tpu_torch.checkpoint(model)
    return model
