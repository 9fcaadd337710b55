"""The ELL stats kernel's sparse arithmetic against the JAX package.

The CUDA kernel ``csrc/kmeans_ell_stats.cu`` never densifies a row: it
merges each row's duplicate indices, scores every centroid over the merged
nonzeros alone, takes the first index of the maximum and adds the
nonzeros into the assigned cluster.  ``_ell_stats_sparse_plain`` is that
arithmetic in plain PyTorch.  Here it is held, on the CPU, against the JAX
package's ``kmeans_ell_stats_fused`` (Pallas in interpret mode) at shapes
its validation takes (d a multiple of ``hi``, n a multiple of ``block``,
pad slots ``(d, 0.0)`` as the JAX package writes them), with the kernel's
edge cases in the data: rows with 2-4 duplicates of one index, all-pad
rows and rows of validity 0.  Where the JAX kernel defines nothing (an
index below 0 or at/above d carrying a value, which its densify would
fold into another row), it is held against the port's dense plain version
``_ell_stats_plain``, which drops such slots as the kernel does.  The
kernel itself is held against ``_ell_stats_plain`` on the card by
``chip_smoke.py`` phase 4.

Bars: counts exact (rows are clustered, so every argmax wins by a wide
margin); float32 sums ``rtol=1e-4, atol=1e-3``, the JAX kernel tests'
own bar; bfloat16 sums against the JAX bfloat16 path at ``rtol=2e-2,
atol=2e-1``, the bar of ``tests/test_pallas_ops.py`` for its bf16 ELL
path.  Against the port's dense plain version, where both sides round the
same values and only the order of float32 sums differs, float32's bar in
both dtypes.
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
N, D, BLOCK, GROUP, HI = 512, 256, 256, 4, 128


def _ell_case(n, d, nnz, k, seed):
    """Clustered ELL rows: each row puts 3/4 of its slots on its
    cluster's 8 signature features (values 1-2) and the rest on random
    features (values up to 0.2); centroids are the signatures plus
    noise.  Then the edge cases: a quarter of the rows repeat slot 0 in
    slots 1-3 (2-4 duplicates), every 37th row is all pad slots, a tenth
    of the rows have validity 0, and a fifth of the other slots are pad
    slots ``(d, 0.0)``."""
    rng = np.random.default_rng(seed)
    sig = np.stack([rng.choice(d, 8, replace=False) for _ in range(k)])
    label = rng.integers(0, k, n)
    n_sig = nnz * 3 // 4
    idx = np.empty((n, nnz), np.int32)
    val = np.empty((n, nnz), np.float32)
    idx[:, :n_sig] = sig[label[:, None], rng.integers(0, 8, (n, n_sig))]
    idx[:, n_sig:] = rng.integers(0, d, (n, nnz - n_sig))
    val[:, :n_sig] = 1.0 + rng.random((n, n_sig), np.float32)
    val[:, n_sig:] = 0.2 * rng.random((n, nnz - n_sig), np.float32)
    dup = rng.random(n)
    for j, frac in ((1, 0.25), (2, 0.15), (3, 0.05)):
        idx[dup < frac, j] = idx[dup < frac, 0]
    pad = rng.random((n, nnz)) < 0.2
    pad[:, 0] = False
    pad[np.arange(n) % 37 == 0] = True
    idx[pad] = d
    val[pad] = 0.0
    valid = (rng.random(n) > 0.1).astype(np.float32)
    cent = 0.05 * rng.random((k, d)).astype(np.float32)
    for c in range(k):
        cent[c, sig[c]] += 1.0
    return cent, idx, val, valid


def _sparse_plain(cent, idx, val, valid, d, dtype):
    cn = tk._normalized(torch.from_numpy(cent), _TORCH[dtype])
    return tk._ell_stats_sparse_plain(
        cn, torch.from_numpy(idx), torch.from_numpy(val),
        torch.from_numpy(valid), d).numpy()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k", [10, 64, 100])
@pytest.mark.parametrize("nnz", [16, 32, 64, 512])
def test_sparse_plain_matches_jax(nnz, k, dtype):
    cent, idx, val, valid = _ell_case(N, D, nnz, k, seed=nnz + k)
    want = np.asarray(jk.kmeans_ell_stats_fused(
        jnp.asarray(cent), jnp.asarray(idx), jnp.asarray(val),
        jnp.asarray(valid), D, group=GROUP, hi=HI, block=BLOCK,
        compute_dtype=_JNP[dtype], interpret=True))
    got = _sparse_plain(cent, idx, val, valid, D, dtype)
    assert got.shape == (k, D + 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    assert got[:, -1].sum() == valid.sum()
    np.testing.assert_allclose(got, want,
                               **(F32_TOL if dtype == "float32" else BF16_TOL))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("nnz", [16, 32, 64, 512])
def test_out_of_range_slots_drop_as_in_the_dense_plain(nnz, dtype):
    """Indices below 0 or at/above d that carry values add nothing, in
    the sparse and the dense plain versions alike."""
    k = 64
    cent, idx, val, valid = _ell_case(N, D, nnz, k, seed=3 * nnz)
    rng = np.random.default_rng(nnz)
    bad = rng.random(idx.shape) < 0.05
    idx[bad] = rng.choice(np.array([-1, -7, D, D + 3, 10 * D], np.int32),
                          int(bad.sum()))
    val[bad] = 5.0
    got = _sparse_plain(cent, idx, val, valid, D, dtype)
    cn = tk._normalized(torch.from_numpy(cent), _TORCH[dtype])
    want = tk._ell_stats_plain(cn, torch.from_numpy(idx),
                               torch.from_numpy(val),
                               torch.from_numpy(valid), D).numpy()
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got, want, **F32_TOL)
    keep = (idx >= 0) & (idx < D)
    mass = (val * keep * valid[:, None]).astype(np.float64).sum()
    np.testing.assert_allclose(got[:, :-1].sum(), mass, rtol=1e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_keeps_first_slots_in_slot_order(dtype):
    """Index 3 at slots 0, 2 and 4 merges into slot 0 as the float32 sum,
    in slot order, of the three values rounded to the compute dtype,
    rounded again; pad and out-of-range slots and the later duplicates
    get index -1 and value 0."""
    d = 8
    idx = torch.tensor([[3, 5, 3, d, 3, -1, 5, 9]], dtype=torch.int32)
    val = torch.tensor([[0.1, 1.3, 0.7, 0.0, 1.0 / 3.0, 2.0, 0.2, 4.0]])
    cols, vals = tk._ell_merge(idx, val, d, _TORCH[dtype])
    r = _TORCH[dtype]
    v = val.to(r).float()[0]
    three = ((v[0] + v[2]) + v[4]).to(r).float()
    five = (v[1] + v[6]).to(r).float()
    assert cols.tolist() == [[3, 5, -1, -1, -1, -1, -1, -1]]
    assert torch.equal(vals[0], torch.tensor([float(three), float(five)]
                                             + [0.0] * 6))
