"""The port's gradient-histogram kernel wrapper, builders and host helpers
against the JAX package's, on the CPU.

The same seeded numpy inputs go through ``rabit_tpu`` (the Pallas kernel
in interpret mode, or its XLA builder) and ``rabit_tpu_torch`` (CPU
tensors, so the kernel's plain version runs).  The CUDA kernel itself is
held against that plain version on the card by ``chip_smoke.py``.

Tolerance: ``rtol=1e-4, atol=1e-3``, the JAX histogram tests' own bar.
Both packages round the weights to the compute dtype by
round-to-nearest-even and sum in float32, so only the order of the sums
differs, in bfloat16 as in float32.  The host helpers are copies and
must agree bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabit_tpu
import rabit_tpu_torch
from rabit_tpu.learn import histogram as jhist
from rabit_tpu.ops import histogram_kernel as jk
from rabit_tpu_torch.learn import histogram as thist
from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.ops import histogram_kernel as tk

TOL = dict(rtol=1e-4, atol=1e-3)


@pytest.fixture
def engines():
    for pkg in (rabit_tpu, rabit_tpu_torch):
        if pkg.initialized():
            pkg.finalize()
        pkg.init(rabit_engine="empty")
    yield
    for pkg in (rabit_tpu, rabit_tpu_torch):
        pkg.finalize()


def _inputs(n, f, nbin, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nbin, (n, f)).astype(np.int32)
    grad = rng.standard_normal(n).astype(np.float32)
    hess = rng.random(n).astype(np.float32)
    return bins, grad, hess


# ------------------------------------------------------------- kernel
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,f,nbin,nw", [(1000, 5, 16, 2), (513, 3, 7, 3),
                                         (300, 9, 256, 2), (700, 4, 257, 6),
                                         (600, 3, 1024, 5)])
def test_hist_fused_multi_matches_jax(n, f, nbin, nw, dtype):
    rng = np.random.default_rng(n + nw)
    bins_t = rng.integers(0, nbin, (f, n)).astype(np.int32)
    w = rng.standard_normal((nw, n)).astype(np.float32)
    want = np.asarray(jk.hist_fused_multi(bins_t, w, nbin, interpret=True,
                                          compute_dtype=dtype))
    launches = tk.LAUNCHES["gbdt_hist"]
    got = tk.hist_fused_multi(torch.from_numpy(bins_t), torch.from_numpy(w),
                              nbin, compute_dtype=dtype)
    assert got.dtype == torch.float32 and got.shape == (nw, f, nbin)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert tk.LAUNCHES["gbdt_hist"] == launches    # no kernel on the CPU


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_hist_fused_matches_jax(dtype):
    bins, grad, hess = _inputs(600, 4, 16, 1)
    want = np.asarray(jk.hist_fused(bins, grad, hess, 16, interpret=True,
                                    compute_dtype=dtype))
    got = tk.hist_fused(torch.from_numpy(bins), torch.from_numpy(grad),
                        torch.from_numpy(hess), 16, compute_dtype=dtype)
    assert got.shape == (4, 16, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_out_of_range_bins_add_nothing():
    """Bins -1, nbin and 1000 match no slot, in both packages."""
    rng = np.random.default_rng(2)
    n, f, nbin = 400, 3, 8
    bins_t = rng.integers(0, nbin, (f, n)).astype(np.int32)
    bad = rng.random((f, n)) < 0.3
    bins_t[bad] = rng.choice(np.array([-1, nbin, 1000], np.int32),
                             int(bad.sum()))
    w = rng.standard_normal((2, n)).astype(np.float32)
    want = np.asarray(jk.hist_fused_multi(bins_t, w, nbin, interpret=True,
                                          compute_dtype="float32"))
    got = tk.hist_fused_multi(torch.from_numpy(bins_t), torch.from_numpy(w),
                              nbin, compute_dtype="float32").numpy()
    np.testing.assert_allclose(got, want, **TOL)
    kept = np.where(bad, 0.0, 1.0)
    np.testing.assert_allclose(got.sum(axis=2), w @ kept.T, **TOL)


@pytest.mark.parametrize("nw", [0, 65])
def test_channel_count_checked(nw):
    bins_t = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(ValueError, match=r"out of range \[1, 64\]"):
        tk.hist_fused_multi(bins_t, torch.zeros((nw, 10)), 8)


def test_max_channels_from_shared_memory():
    """The port's channel budget: the kernel splits channels and features
    over blocks, so it takes 64 channels at any f, up to the nbin whose
    one-column histogram and narrowest staging ring still fit a block's
    shared memory (``_hist_plan``'s limit, ``MAX_NBIN``)."""
    assert tk.max_channels(257, 64) == tk.max_channels(4096, 1) == 64
    top = 58045                 # the top nbin of the first kernel's layout
    assert top <= tk.MAX_NBIN
    assert tk.max_channels(top, 1) == tk.max_channels(tk.MAX_NBIN, 1) == 64
    with pytest.raises(ValueError, match="shared memory of a block"):
        tk.max_channels(tk.MAX_NBIN + 1, 1)
    with pytest.raises(ValueError, match="shared memory of a block"):
        tk.hist_fused_multi(torch.zeros((1, 10), dtype=torch.int32),
                            torch.zeros((2, 10)), tk.MAX_NBIN + 1)


def test_no_kernel_for_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises:
    nothing quietly runs the plain version in its place."""
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.hist_fused_multi(torch.empty((2, 8), dtype=torch.int32,
                                        device="meta"),
                            torch.empty((2, 8), device="meta"), 4)


def test_cuda_route_raises_without_the_toolkit(monkeypatch, tmp_path):
    """The CUDA route builds and launches the kernel or raises; without
    nvcc it raises and counts no launch."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tk, "_LIB", None)
    monkeypatch.setattr("shutil.which", lambda _name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    launches = tk.LAUNCHES["gbdt_hist"]
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tk._hist_cuda(torch.zeros((2, 8), dtype=torch.int32),
                      torch.ones((2, 8)), 4, torch.float32)
    assert tk.LAUNCHES["gbdt_hist"] == launches


# ----------------------------------------------------------- builders
@pytest.mark.parametrize("n,f,nbin", [(1000, 5, 16), (513, 3, 7)])
def test_build_local_matches_jax(n, f, nbin):
    bins, grad, hess = _inputs(n, f, nbin, 3)
    want = np.asarray(jhist.build_local(bins, grad, hess, nbin,
                                        use_pallas=False))
    got = thist.build_local(bins, grad, hess, nbin)
    assert isinstance(got, torch.Tensor) and got.shape == (f, nbin, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the kernel route (its plain version here) in bfloat16
    want16 = np.asarray(jhist.build_local(bins, grad, hess, nbin,
                                          use_pallas=True))
    got16 = thist.build_local(bins, grad, hess, nbin, use_kernel=True)
    np.testing.assert_allclose(got16.numpy(), want16, **TOL)


def test_build_level_local_chunks_channels():
    """40 nodes are 80 weight channels, over the 64 of one launch: both
    packages chunk, and the chunks agree with the node-by-node build."""
    bins, grad, hess = _inputs(300, 2, 8, 7)
    m = 40
    node = np.random.default_rng(8).integers(0, m, 300).astype(np.int32)
    ids = list(range(m))
    want = np.asarray(jhist.build_level_local(bins, grad, hess, node, ids, 8,
                                              use_pallas=False))
    got = thist.build_level_local(bins, grad, hess, node, ids, 8)
    assert got.shape == (m, 2, 8, 2)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    want_k = np.asarray(jhist.build_level_local(
        bins, grad, hess, node, ids, 8, use_pallas=True,
        compute_dtype="float32"))
    got_k = thist.build_level_local(
        bins, grad, hess, node, ids, 8, use_kernel=True,
        bins_t=torch.from_numpy(bins.T.copy()), compute_dtype="float32")
    np.testing.assert_allclose(got_k.numpy(), want_k, **TOL)


def test_build_level_allreduce_matches_jax(engines):
    bins, grad, hess = _inputs(200, 3, 8, 6)
    node = np.random.default_rng(9).integers(1, 4, 200).astype(np.int32)
    want = np.asarray(jhist.build_level_allreduce(bins, grad, hess, node,
                                                  [1, 2, 3], 8))
    got = thist.build_level_allreduce(bins, grad, hess, node, [1, 2, 3], 8)
    assert isinstance(got, np.ndarray) and got.shape == (3, 3, 8, 2)
    np.testing.assert_allclose(got, want, **TOL)


def test_build_allreduce_and_async_match_jax(engines):
    bins, grad, hess = _inputs(300, 4, 8, 2)
    want = np.asarray(jhist.build_allreduce(bins, grad, hess, 8))
    got = thist.build_allreduce(bins, grad, hess, 8)
    assert isinstance(got, np.ndarray) and got.shape == (4, 8, 2)
    np.testing.assert_allclose(got, want, **TOL)
    assert got[:, :, 1].sum() == pytest.approx(hess.sum() * 4, rel=1e-5)
    handle = thist.build_allreduce_async(bins, grad, hess, 8)
    want_a = jhist.build_allreduce_async(bins, grad, hess, 8).wait()
    np.testing.assert_allclose(handle.wait(), want_a, **TOL)


# ----------------------------------------------------------- host side
def _values_with_nan(seed):
    rng = np.random.default_rng(seed)
    vals = rng.standard_normal((500, 4)).astype(np.float32)
    vals[rng.random((500, 4)) < 0.1] = np.nan
    vals[:, 3] = np.nan                      # an all-missing column
    return vals


@pytest.mark.parametrize("nbin", [2, 16, 256])
def test_cuts_and_bins_bit_equal(nbin):
    vals = _values_with_nan(nbin)
    cuts = thist.quantile_cuts(vals, nbin)
    want = jhist.quantile_cuts(vals, nbin)
    assert cuts.dtype == want.dtype and np.array_equal(cuts, want)
    np.testing.assert_array_equal(thist.apply_cuts(vals, cuts),
                                  jhist.apply_cuts(vals, want))
    tb, tc = thist.quantize(vals, nbin)
    jb, jc = jhist.quantize(vals, nbin)
    assert np.array_equal(tb, jb) and np.array_equal(tc, jc)
    assert tb.max() == nbin                  # NaN -> the missing bin


def test_split_gains_bit_equal():
    rng = np.random.default_rng(5)
    hist = rng.standard_normal((3, 9, 2)).astype(np.float32)
    hist[..., 1] = np.abs(hist[..., 1])
    hist[1, 4] = np.nan
    np.testing.assert_array_equal(thist.split_gain(hist, 0.5),
                                  jhist.split_gain(hist, 0.5))
    tg, tl = thist.split_gain_missing(hist, 1.0)
    jg, jl = jhist.split_gain_missing(hist, 1.0)
    np.testing.assert_array_equal(tg, jg)
    np.testing.assert_array_equal(tl, jl)
    assert np.isnan(tg[1]).any()
