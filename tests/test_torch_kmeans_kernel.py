"""The port's k-means stats functions against the JAX package's Pallas
kernels.

The same numpy inputs (seeded) go through ``rabit_tpu.ops.kmeans_kernel``
(Pallas, interpret mode on the CPU) and ``rabit_tpu_torch.ops.kmeans_kernel``
(CPU tensors, so the plain PyTorch versions run).  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.

Tolerances: counts (hence argmax assignments) exact; float32 sums
``rtol=1e-4, atol=1e-3``, the JAX kernel tests' own bar; bfloat16 paths
against the JAX bfloat16 path at ``rtol=2e-2, atol=2e-1``, the bar of
``tests/test_pallas_ops.py`` for its bf16 ELL path.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu.ops import kmeans_kernel as jk
from rabit_tpu_torch.ops import kmeans_kernel as tk

F32_TOL = dict(rtol=1e-4, atol=1e-3)
BF16_TOL = dict(rtol=2e-2, atol=2e-1)

_JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
_TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _assert_stats(got, want, dtype):
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got, want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


def _dense_pair(cent, x, valid, dtype, block):
    want = np.asarray(jk.kmeans_stats_fused(
        jnp.asarray(cent), jnp.asarray(x, _JNP[dtype]), jnp.asarray(valid),
        block=block))
    got = tk.kmeans_stats_fused(
        torch.from_numpy(cent), torch.from_numpy(x).to(_TORCH[dtype]),
        torch.from_numpy(valid)).numpy()
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,d,k", [(512, 256, 64), (300, 100, 10),
                                   (256, 2048, 64), (130, 2050, 100)])
def test_dense_stats_match_jax(n, d, k, dtype):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cent = rng.standard_normal((k, d)).astype(np.float32)
    valid = (rng.random(n) > 0.1).astype(np.float32)
    got, want = _dense_pair(cent, x, valid, dtype, block=256)
    assert got.shape == (k, d + 1) and got.dtype == np.float32
    _assert_stats(got, want, dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_stats_all_negative_similarity(dtype):
    """Every similarity negative: every row still lands in a real
    cluster, as in the JAX kernel (its padded centroids are masked)."""
    rng = np.random.default_rng(1)
    d, k, n = 100, 3, 64
    cent = np.abs(rng.standard_normal((k, d))).astype(np.float32)
    x = -np.abs(rng.standard_normal((n, d))).astype(np.float32)
    valid = np.ones(n, np.float32)
    got, want = _dense_pair(cent, x, valid, dtype, block=64)
    _assert_stats(got, want, dtype)
    assert got[:, -1].sum() == n


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_stats_tie_across_centroid_chunks(dtype):
    """Centroid 67 copies centroid 3 (k=100: the CUDA kernel scores them
    in different 64-centroid chunks): every row of that pair goes to 3,
    the first index of the maximum, in both packages."""
    rng = np.random.default_rng(6)
    n, d, k = 400, 256, 100
    basis = rng.standard_normal((k, d)).astype(np.float32)
    label = rng.integers(0, k, n)
    label[label == 67] = 3
    label[:8] = 3
    x = (basis[label] + 0.02 * rng.standard_normal((n, d))).astype(
        np.float32)
    cent = basis.copy()
    cent[67] = cent[3]
    valid = np.ones(n, np.float32)
    got, want = _dense_pair(cent, x, valid, dtype, block=256)
    _assert_stats(got, want, dtype)
    assert got[67, -1] == 0 and got[3, -1] == (label == 3).sum()


def _ell_inputs(n, d, k, nnz, seed):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, d, (n, nnz)).astype(np.int32)
    idx[:, 1] = idx[:, 0]                   # a duplicate in every row
    val = rng.standard_normal((n, nnz)).astype(np.float32)
    pad = rng.random((n, nnz)) < 0.2        # pad slots, as to_ell emits
    idx[pad] = d
    val[pad] = 0.0
    valid = (rng.random(n) > 0.1).astype(np.float32)
    d_pad = -(-(d + 1) // 128) * 128        # as prepare_shard pads
    cent = np.pad(rng.standard_normal((k, d)).astype(np.float32),
                  ((0, 0), (0, d_pad - d)))
    return cent, idx, val, valid, d_pad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["flat", "grouped"])
@pytest.mark.parametrize("n,d,k,nnz,group", [(2048, 250, 16, 16, 4),
                                             (1024, 384, 10, 8, 8)])
def test_ell_stats_match_jax(n, d, k, nnz, group, layout, dtype):
    cent, idx, val, valid, d_pad = _ell_inputs(n, d, k, nnz, seed=2)
    kw = dict(group=group, hi=128, block=512)
    if layout == "grouped":
        idx = idx.reshape(n // group, group * nnz)
        val = val.reshape(n // group, group * nnz)
        kw["nnz"] = nnz
    want = np.asarray(jk.kmeans_ell_stats_fused(
        jnp.asarray(cent), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(valid), d_pad, compute_dtype=_JNP[dtype], **kw))
    got = tk.kmeans_ell_stats_fused(
        torch.from_numpy(cent), torch.from_numpy(idx), torch.from_numpy(val),
        torch.from_numpy(valid), d_pad, compute_dtype=_TORCH[dtype],
        **kw).numpy()
    assert got.shape == (k, d_pad + 1)
    _assert_stats(got, want, dtype)


def test_ell_compute_dtype_by_name():
    """``compute_dtype`` may be named, as the JAX package's dtypes are."""
    cent, idx, val, valid, d_pad = _ell_inputs(512, 100, 4, 8, seed=3)
    args = (torch.from_numpy(cent), torch.from_numpy(idx),
            torch.from_numpy(val), torch.from_numpy(valid), d_pad)
    by_name = tk.kmeans_ell_stats_fused(*args, block=512,
                                        compute_dtype="bfloat16")
    by_dtype = tk.kmeans_ell_stats_fused(*args, block=512)
    assert torch.equal(by_name, by_dtype)


@pytest.mark.parametrize("case,match", [
    ("nnz", "powers of two"),
    ("hi", "not divisible"),
    ("dim", "centroids dim"),
    ("width", "grouped idx width"),
    ("block", "must divide into block"),
])
def test_ell_validation_errors_match_jax(case, match):
    """The same bad arguments raise the same ValueError in both
    packages."""
    d, n, nnz = 256, 512, 8
    kw = dict(hi=128, block=512)
    cent = np.zeros((8, d), np.float32)
    idx = np.zeros((n, nnz), np.int32)
    if case == "nnz":
        idx = np.zeros((n, 24), np.int32)
    elif case == "hi":
        kw["hi"] = 96
    elif case == "dim":
        cent = np.zeros((8, d + 1), np.float32)
    elif case == "width":
        idx = np.zeros((n // 4, 3 * nnz), np.int32)
        kw["nnz"] = nnz
    elif case == "block":
        kw["block"] = 384
    val = np.zeros(idx.shape, np.float32)
    valid = np.ones(n, np.float32)
    with pytest.raises(ValueError, match=match) as jax_err:
        jk.kmeans_ell_stats_fused(jnp.asarray(cent), jnp.asarray(idx),
                                  jnp.asarray(val), jnp.asarray(valid), d,
                                  **kw)
    with pytest.raises(ValueError, match=match) as port_err:
        tk.kmeans_ell_stats_fused(torch.from_numpy(cent),
                                  torch.from_numpy(idx),
                                  torch.from_numpy(val),
                                  torch.from_numpy(valid), d, **kw)
    assert str(port_err.value) == str(jax_err.value)


def test_cpu_tensors_never_count_launches():
    before = dict(tk.LAUNCHES)
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((64, 32)).astype(np.float32))
    cent = torch.from_numpy(rng.standard_normal((4, 32)).astype(np.float32))
    tk.kmeans_stats_fused(cent, x, torch.ones(64))
    cent_e, idx, val, valid, d_pad = _ell_inputs(512, 100, 4, 8, seed=5)
    tk.kmeans_ell_stats_fused(torch.from_numpy(cent_e), torch.from_numpy(idx),
                              torch.from_numpy(val), torch.from_numpy(valid),
                              d_pad, block=512)
    assert tk.LAUNCHES == before


def test_no_kernel_for_other_devices():
    """A tensor that is neither on the CPU nor on a CUDA device raises:
    nothing quietly runs the plain version in its place."""
    x = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.kmeans_stats_fused(torch.empty((2, 4), device="meta"), x,
                              torch.empty(8, device="meta"))
