"""The port's gradient-boosted trees against the JAX package's, on the CPU.

The same seeded numpy data trains ``rabit_tpu.learn.boosting`` and
``rabit_tpu_torch.learn.boosting`` (``device="cpu"``, so the histogram
kernel's plain version runs).  The data comes from a planted tree, and
``_min_decision_gap`` checks on the JAX model that every split wins
clearly over every candidate that splits the node's rows differently,
so float32 sums taken in another order cannot flip a decision.  Trees
must then be identical node for node, and leaf values and predictions
agree within 1e-5.
"""
import numpy as np
import pytest
import torch

import rabit_tpu
import rabit_tpu_torch
from rabit_tpu.learn import boosting as jb
from rabit_tpu.learn import histogram as jhist
from rabit_tpu_torch.convert import TREE_COLUMNS, boosted_from_jax
from rabit_tpu_torch.learn import boosting as tb

ATOL = 1e-5
ROUNDS, DEPTH, NBIN = 4, 3, 16


@pytest.fixture
def engines():
    for pkg in (rabit_tpu, rabit_tpu_torch):
        if pkg.initialized():
            pkg.finalize()
        pkg.init(rabit_engine="empty")
    yield
    for pkg in (rabit_tpu, rabit_tpu_torch):
        pkg.finalize()


def _restart(*pkgs):
    """A fresh world of one: no checkpoint to resume from."""
    for pkg in pkgs:
        pkg.finalize()
        pkg.init(rabit_engine="empty")


def _planted(loss="logistic", missing=False, n=2000, f=5, seed=1):
    """Rows under a depth-2 planted tree on features 0-2 with leaf
    outcomes far apart.  With ``missing``, feature 0 is NaN in 15% of
    the rows on its right side, so the root learns to send NaN right."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, (n, f)).astype(np.float32)
    leaf = np.where(X[:, 0] < 0.1, np.where(X[:, 1] < -0.3, 0, 1),
                    np.where(X[:, 2] < 0.4, 2, 3))
    if loss == "logistic":
        p = np.array([0.08, 0.7, 0.35, 0.95])[leaf]
        y = (rng.random(n) < p).astype(np.float32)
    else:
        y = (np.array([-2.0, 1.0, 0.5, 3.0])[leaf]
             + 0.3 * rng.standard_normal(n)).astype(np.float32)
    if missing:
        X[(rng.random(n) < 0.15) & (X[:, 0] >= 0.1), 0] = np.nan
    return X, y


def _min_decision_gap(model, X, y, subsample=1.0, seed=0, reg_lambda=1.0):
    """Replay the JAX model's training in float64 and return the smallest
    margin by which a split's gain beat the best candidate that splits
    the node's rows another way (the same feature with only empty bins
    in between splits them the same way).  The margin is relative to the
    size of the terms the gain is a difference of (the parent score plus
    the gain), whose float32 rounding is what the order of the sums
    moves."""
    bins = jhist.apply_cuts(X, model.cuts)
    missing_bin = model.cuts.shape[1] + 1
    nbin = missing_bin + 1 if model.has_missing else missing_bin
    gain_fn = (jhist.split_gain_missing if model.has_missing
               else jhist.split_gain)
    gaps = []
    for r, tree in enumerate(model.trees):
        part = jb.BoostedModel(cuts=model.cuts, trees=model.trees[:r],
                               base_score=model.base_score,
                               learning_rate=model.learning_rate,
                               loss=model.loss, has_missing=model.has_missing)
        grad, hess = jb._grad_hess(part.margin(bins), y, model.loss)
        if subsample < 1.0:
            keep = np.random.default_rng((seed, r, 0)).random(len(y)) \
                < subsample
            grad, hess = grad * keep, hess * keep
        node_of_row = np.zeros(len(y), np.int64)
        for nid, node in enumerate(tree):           # parents come first
            if node.feature < 0:
                continue
            rows = node_of_row == nid
            hist = np.zeros((bins.shape[1], nbin, 2))
            count = np.zeros((bins.shape[1], nbin))
            for j in range(bins.shape[1]):
                b = bins[rows, j]
                hist[j, :, 0] = np.bincount(b, grad[rows], nbin)
                hist[j, :, 1] = np.bincount(b, hess[rows], nbin)
                count[j] = np.bincount(b, minlength=nbin)
            out = gain_fn(hist, reg_lambda)
            gain = out[0] if model.has_missing else out
            j, t = node.feature, node.bin_threshold
            best = gain[j, t]
            assert best == gain.max()
            rivals = gain.copy()
            same = np.zeros(gain.shape[1], bool)
            for t2 in range(gain.shape[1]):
                a, b2 = sorted((t, t2))
                same[t2] = count[j, a + 1:b2 + 1].sum() == 0
            rivals[j, same] = -np.inf
            gt, ht = hist[0, :, 0].sum(), hist[0, :, 1].sum()
            scale = gt * gt / (ht + reg_lambda) + best
            gaps.append((best - rivals.max()) / scale)
            b = bins[:, j]
            go_left = np.where(b == missing_bin, node.default_left, b <= t)
            node_of_row[rows & go_left] = node.left
            node_of_row[rows & ~go_left] = node.right
    return min(gaps)


def _assert_same_trees(got, want):
    assert len(got.trees) == len(want.trees)
    for tg, tw in zip(got.trees, want.trees):
        assert [(n.feature, n.bin_threshold, n.left, n.right, n.default_left)
                for n in tg] == [
               (n.feature, n.bin_threshold, n.left, n.right, n.default_left)
               for n in tw]
        np.testing.assert_allclose([n.value for n in tg],
                                   [n.value for n in tw], rtol=0, atol=ATOL)


@pytest.mark.parametrize("case", ["logistic", "squared", "missing",
                                  "subsample"])
def test_train_matches_jax(engines, case):
    loss = "squared" if case == "squared" else "logistic"
    X, y = _planted(loss, missing=case == "missing")
    kw = dict(num_round=ROUNDS, max_depth=DEPTH, nbin=NBIN, loss=loss,
              subsample=0.7 if case == "subsample" else 1.0, seed=3)
    want = jb.train(X, y, use_pallas=False, **kw)
    got = tb.train(X, y, device="cpu", **kw)
    assert _min_decision_gap(want, X, y, kw["subsample"], 3) > 1e-4
    _assert_same_trees(got, want)
    assert got.has_missing == want.has_missing == (case == "missing")
    np.testing.assert_allclose(got.predict(X), want.predict(X), rtol=0,
                               atol=ATOL)
    if case == "missing":          # a split learned to send NaN right
        assert {n.default_left for t in got.trees for n in t
                if n.feature >= 0} == {True, False}


def test_bfloat16_plain_path_matches_jax_kernel(engines):
    """Weights rounded to bfloat16: the port's plain path against the
    JAX package's Pallas kernel (interpret mode)."""
    X, y = _planted(seed=4)
    kw = dict(num_round=2, max_depth=2, nbin=NBIN)
    want = jb.train(X, y, use_pallas=True, **kw)
    got = tb.train(X, y, device="cpu", compute_dtype="bfloat16", **kw)
    _assert_same_trees(got, want)
    np.testing.assert_allclose(got.predict(X), want.predict(X), rtol=0,
                               atol=ATOL)


def test_resume_equals_straight_run(engines):
    """10 rounds straight == 5 rounds, a restart, and a resume to 10."""
    X, y = _planted(seed=2)
    kw = dict(max_depth=2, nbin=NBIN, device="cpu")
    ref = tb.train(X, y, num_round=10, **kw)
    _restart(rabit_tpu_torch)
    tb.train(X, y, num_round=5, **kw)
    assert rabit_tpu_torch.version_number() == 5
    resumed = tb.train(X, y, num_round=10, **kw)
    assert len(resumed.trees) == 10
    np.testing.assert_array_equal(resumed.predict(X), ref.predict(X))


def _unpack(model):
    """A JAX model's trees as the (m, 6) arrays of boosted_from_jax."""
    return [np.array([[getattr(n, c) for c in TREE_COLUMNS] for n in tree],
                     np.float64) for tree in model.trees]


def test_boosted_from_jax_predicts_bit_equal(engines):
    X, y = _planted(missing=True, seed=6)
    jm = jb.train(X, y, num_round=3, max_depth=3, nbin=NBIN, use_pallas=False)
    pm = boosted_from_jax(jm.cuts, _unpack(jm), jm.base_score,
                          jm.learning_rate, jm.loss, jm.has_missing)
    assert isinstance(pm, tb.BoostedModel) and pm.cuts is not jm.cuts
    np.testing.assert_array_equal(pm.predict(X), jm.predict(X))
    with pytest.raises(TypeError, match="float32"):
        boosted_from_jax(jm.cuts.astype(np.float64), _unpack(jm), 0.0, 0.3,
                         "logistic", True)
    with pytest.raises(ValueError, match="shape"):
        boosted_from_jax(jm.cuts, [np.zeros((3, 5))], 0.0, 0.3, "logistic",
                         True)
    bad = _unpack(jm)
    bad[0][0, 0] = jm.cuts.shape[0]
    with pytest.raises(ValueError, match="feature"):
        boosted_from_jax(jm.cuts, bad, 0.0, 0.3, "logistic", True)


def test_train_defaults_to_cuda_and_raises_without_it(engines, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, y = _planted(n=100)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.train(X, y, num_round=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tb.train(X, y, num_round=1, device="cuda")
    assert rabit_tpu_torch.version_number() == 0
