"""The port's k-means app (``rabit_tpu_torch.learn.kmeans``) against the
JAX package's (``rabit_tpu.learn.kmeans``), on the CPU.

Inputs are made with seeded numpy and handed to both packages.  Data for
whole runs is clustered so that each row's best centroid wins by a wide
margin and each cluster is seeded by exactly one init row: summation
order then cannot flip an assignment, and results agree to float32
rounding.  Tolerances are stated beside each comparison.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rabit_tpu
import rabit_tpu_torch
from rabit_tpu.learn import kmeans as jkm
from rabit_tpu.learn.data import SparseMat as JSparseMat
from rabit_tpu.learn.data import hash_features as jhash
from rabit_tpu_torch.convert import kmeans_from_jax
from rabit_tpu_torch.learn import kmeans as tkm
from rabit_tpu_torch.learn.data import SparseMat
from rabit_tpu_torch.learn.data import hash_features as thash
from rabit_tpu_torch.utils import RabitError

# float32 paths: the JAX tests' bar for float32 sums
F32_TOL = dict(rtol=1e-4, atol=1e-3)
# unit-norm centroids after whole runs on margin-separated data: only
# float32 summation order differs between the packages
CENT_TOL = dict(rtol=1e-4, atol=1e-5)
# bfloat16 paths against the JAX bfloat16 path
BF16_TOL = dict(rtol=2e-2, atol=2e-1)


@pytest.fixture
def engines():
    """Fresh world-of-one engines in both packages."""
    for pkg in (rabit_tpu, rabit_tpu_torch):
        if pkg.initialized():
            pkg.finalize()
        pkg.init(rabit_engine="empty")
    yield
    for pkg in (rabit_tpu, rabit_tpu_torch):
        pkg.finalize()


def _restart(pkg):
    pkg.finalize()
    pkg.init(rabit_engine="empty")


def clustered(n=3000, d=64, nnz=8, k=4, seed=0):
    """ELL rows of k clusters (3/4 of each row's slots on its cluster's
    8 signature features), with the rows that init_centroids(seed=0)
    draws given one cluster each.  Returns the ELL arrays and the CSR
    form for both packages."""
    rng = np.random.default_rng(seed)
    sig = rng.permutation(d)[:8 * k].reshape(k, 8)   # disjoint: no ties
    label = rng.integers(0, k, n)
    draw = np.random.default_rng(0)
    picks = [int(draw.integers(n)) for _ in range(k)]
    assert len(set(picks)) == k
    label[picks] = np.arange(k)
    n_sig = nnz * 3 // 4
    idx = np.empty((n, nnz), np.int32)
    idx[:, :n_sig] = sig[label[:, None], rng.integers(0, 8, (n, n_sig))]
    idx[:, n_sig:] = rng.integers(0, d, (n, nnz - n_sig))
    val = np.empty((n, nnz), np.float32)
    val[:, :n_sig] = 1.0 + rng.random((n, n_sig))
    val[:, n_sig:] = 0.2 * rng.random((n, nnz - n_sig))
    csr = dict(indptr=np.arange(n + 1, dtype=np.int64) * nnz,
               findex=idx.reshape(-1), fvalue=val.reshape(-1),
               labels=np.zeros(n, np.float32), feat_dim=d)
    return idx, val, JSparseMat(**csr), SparseMat(**csr)


def _band_model(d, k):
    """Unit centroids on the clustered() signature features."""
    rng = np.random.default_rng(0)
    sig = rng.permutation(d)[:8 * k].reshape(k, 8)
    cent = np.full((k, d), 0.01, np.float32)
    for c in range(k):
        cent[c, sig[c]] = 1.0
    return cent / np.linalg.norm(cent, axis=1, keepdims=True)


# ------------------------------------------------------------- pieces
def test_centroid_update_matches_jax():
    rng = np.random.default_rng(1)
    cent = rng.standard_normal((6, 16)).astype(np.float32)
    stats = rng.standard_normal((6, 17)).astype(np.float32) * 10
    stats[:, -1] = np.abs(stats[:, -1]) + 1
    stats[2, -1] = 0.0                      # empty cluster keeps centroid
    stats[4, :-1] = 0.0                     # zero row stays unscaled
    want = np.asarray(jkm.centroid_update(jnp.asarray(cent),
                                          jnp.asarray(stats)))
    got = tkm.centroid_update(torch.from_numpy(cent),
                              torch.from_numpy(stats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


def test_model_normalize_matches_jax():
    rng = np.random.default_rng(2)
    cent = rng.standard_normal((5, 12)).astype(np.float32)
    cent[3] = 1e-8                          # ~zero row left unscaled
    a, b = jkm.KMeansModel(cent.copy()), tkm.KMeansModel(cent.copy())
    a.normalize()
    b.normalize()
    np.testing.assert_array_equal(b.centroids, a.centroids)
    assert b.centroids.dtype == np.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_device_iterations_plain_matches_jax(dtype):
    """The plain device loop against the JAX loop with
    ``use_pallas=False``; both run their similarity in ``dtype``."""
    rng = np.random.default_rng(3)
    n, d, k = 512, 64, 4
    basis = rng.standard_normal((k, d)).astype(np.float32)
    x = (basis[rng.integers(0, k, n)]
         + 0.05 * rng.standard_normal((n, d))).astype(np.float32)
    valid = (rng.random(n) > 0.1).astype(np.float32)
    cent = (basis + 0.3 * rng.standard_normal((k, d))).astype(np.float32)
    want = np.asarray(jkm.device_iterations(
        jnp.asarray(cent), jnp.asarray(x), jnp.asarray(valid), 5,
        use_pallas=False, compute_dtype=dtype))
    got = tkm.device_iterations(
        torch.from_numpy(cent), torch.from_numpy(x), torch.from_numpy(valid),
        5, compute_dtype=dtype).numpy()
    # same assignments on separated data; sums of identical (bf16-exact)
    # values differ only by float32 summation order
    np.testing.assert_allclose(got, want, **CENT_TOL)


def test_device_iterations_kernel_path_matches_plain():
    """``use_kernel=True`` on CPU tensors goes through the public stats
    function (its plain version here) and agrees with the plain loop."""
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((256, 32)).astype(np.float32))
    cent = torch.from_numpy(rng.standard_normal((3, 32)).astype(np.float32))
    valid = torch.ones(256)
    a = tkm.device_iterations(cent, x, valid, 3, use_kernel=True)
    b = tkm.device_iterations(cent, x, valid, 3, use_kernel=False)
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------- tiers
@pytest.mark.parametrize("tier", ["dense", "dense16", "ell", "ell_fused"])
def test_prepare_shard_tiers_match_jax(tier, monkeypatch):
    """Each staging tier, forced by budgets (and, for ell_fused, by
    pretending the backend is the accelerator in both packages), gives
    the JAX package's per-iteration stats."""
    import jax as _jax

    idx, val, _j, _t = clustered(n=2048, d=64, nnz=6, k=4)
    valid = np.ones(2048, np.float32)
    valid[-100:] = 0.0
    cent = _band_model(64, 4)
    kw = {"dense": {}, "dense16": dict(budget=0, compute_dtype="bfloat16"),
          "ell": dict(budget=0), "ell_fused": dict(budget=0)}[tier]
    if tier == "ell_fused":
        monkeypatch.setattr(_jax, "default_backend", lambda: "tpu")
        monkeypatch.setattr(tkm, "_on_card", lambda device: True)
        import rabit_tpu.ops.kmeans_kernel as jk

        orig = jk.kmeans_ell_stats_fused

        def interp(*a, **k):
            k["interpret"] = True
            return orig(*a, **k)

        monkeypatch.setattr(jk, "kmeans_ell_stats_fused", interp)
    jshard = jkm.prepare_shard(idx, val, valid, 64, row_block=256, **kw)
    tshard = tkm.prepare_shard(idx, val, valid, 64, row_block=256,
                               device="cpu", **kw)
    assert jshard[0] == tshard[0] == tier
    if tier == "ell_fused":
        jp, tp = jshard[2], tshard[2]
        assert tp[3:] == tuple(jp[3:])                     # d_pad, nnz_p
        np.testing.assert_array_equal(tp[0].numpy(), np.asarray(jp[0]))
    want = np.asarray(jkm.shard_stats_device(jkm.KMeansModel(cent), jshard))
    got = tkm.shard_stats(tkm.KMeansModel(cent), tshard)
    assert got.shape == want.shape == (4, 65)
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    bf16 = tier in ("dense16", "ell_fused")
    np.testing.assert_allclose(got, want, **(BF16_TOL if bf16 else F32_TOL))


def test_compute_stats_matches_jax():
    idx, val, _j, _t = clustered(n=1024, d=32, nnz=4, k=3)
    valid = np.ones(1024, np.float32)
    cent = np.random.default_rng(5).standard_normal((3, 32)).astype(
        np.float32)
    want = jkm.compute_stats(jkm.KMeansModel(cent), idx, val, valid,
                             row_block=256)
    got = tkm.compute_stats(tkm.KMeansModel(cent), idx, val, valid,
                            row_block=256, device="cpu")
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got, want, **F32_TOL)


# ------------------------------------------------------------ run()
@pytest.mark.parametrize("chain,dtype,hash_dim", [
    (0, "float32", None), (4, "float32", None),
    (0, "bfloat16", None), (4, "bfloat16", None),
    (0, "float32", 32), (3, "float32", 32),
])
def test_run_matches_jax(engines, chain, dtype, hash_dim):
    _i, _v, jdata, tdata = clustered()
    want = jkm.run(jdata, 4, 7, device_chain=chain, compute_dtype=dtype,
                   hash_dim=hash_dim)
    got = tkm.run(tdata, 4, 7, device_chain=chain, compute_dtype=dtype,
                  hash_dim=hash_dim, device="cpu")
    assert got.hash_dim == want.hash_dim == hash_dim
    assert got.centroids.shape == want.centroids.shape
    assert got.centroids.dtype == np.float32
    np.testing.assert_allclose(got.centroids, want.centroids, **CENT_TOL)
    assert rabit_tpu_torch.version_number() == rabit_tpu.version_number()


@pytest.mark.parametrize("chain", [0, 2])
def test_run_checkpoint_resume(engines, chain):
    """A run interrupted after iteration 3 and resumed from the engine's
    checkpoint ends where an uninterrupted run does."""
    _i, _v, _j, data = clustered()
    full = tkm.run(data, 4, 6, device_chain=chain, device="cpu")
    _restart(rabit_tpu_torch)
    tkm.run(data, 4, 3, device_chain=chain, device="cpu")
    assert rabit_tpu_torch.version_number() == (3 if chain == 0 else 2)
    resumed = tkm.run(data, 4, 6, device_chain=chain, device="cpu")
    np.testing.assert_allclose(resumed.centroids, full.centroids,
                               rtol=1e-6, atol=1e-7)


def test_run_resume_rejects_other_hash_dim(engines):
    _i, _v, _j, data = clustered()
    tkm.run(data, 4, 2, hash_dim=32, device="cpu")
    with pytest.raises(RabitError, match="hash_dim"):
        tkm.run(data, 4, 4, device="cpu")


def test_run_defaults_to_cuda_and_raises_without_it(engines, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _i, _v, _j, data = clustered(n=64)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkm.run(data, 2, 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        tkm.device_ell(np.zeros((4, 2), np.int32), np.zeros((4, 2)),
                       np.ones(4), row_block=4)


# ------------------------------------------------ models across packages
def test_kmeans_from_jax_round_trip(engines):
    idx, val, jdata, _t = clustered()
    jmodel = jkm.run(jdata, 4, 3, hash_dim=32)
    model = kmeans_from_jax(jmodel.centroids, jmodel.hash_dim)
    assert isinstance(model, tkm.KMeansModel)
    assert model.hash_dim == 32 and model.centroids.dtype == np.float32
    np.testing.assert_array_equal(model.centroids, jmodel.centroids)
    assert model.centroids is not jmodel.centroids
    # the converted model scores a hashed shard as the JAX model does
    valid = np.ones(idx.shape[0], np.float32)
    hidx, hval = thash(idx, val, 32)
    want = jkm.compute_stats(jmodel, *jhash(idx, val, 32), valid,
                             row_block=1000)
    got = tkm.compute_stats(model, hidx, hval, valid, row_block=1000,
                            device="cpu")
    np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got, want, **F32_TOL)


@pytest.mark.parametrize("bad,err", [
    (np.zeros((3, 4), np.int32), TypeError),
    (np.zeros(4, np.float32), ValueError),
    (np.zeros((0, 4), np.float32), ValueError),
    ([[1.0, 2.0]], TypeError),
])
def test_kmeans_from_jax_rejects_bad_parameters(bad, err):
    with pytest.raises(err):
        kmeans_from_jax(bad)


@pytest.mark.parametrize("hash_dim", [32, 12])
def test_kmeans_from_jax_checks_hash_dim(hash_dim):
    with pytest.raises(ValueError, match="hash_dim"):
        kmeans_from_jax(np.zeros((2, 16), np.float32), hash_dim=hash_dim)


@pytest.mark.parametrize("hash_dim", [None, 16])
def test_saved_models_load_in_both_packages(tmp_path, hash_dim):
    cent = np.random.default_rng(6).standard_normal((3, 16)).astype(
        np.float32)
    jpath, tpath = tmp_path / "jax.txt", tmp_path / "torch.txt"
    jkm.save_model(jkm.KMeansModel(cent, hash_dim), str(jpath))
    tkm.save_model(tkm.KMeansModel(cent, hash_dim), str(tpath))
    assert tpath.read_text() == jpath.read_text()
    np.testing.assert_allclose(np.loadtxt(tpath), cent, rtol=1e-5)


def test_cli_main_on_cpu(engines, tmp_path):
    """``python -m rabit_tpu_torch.learn.kmeans`` (its ``main``) with
    ``kmeans_device=cpu`` writes the model the JAX CLI writes."""
    for pkg in (rabit_tpu, rabit_tpu_torch):
        pkg.finalize()
    _i, _v, _j, data = clustered(n=600, d=32, nnz=4, k=3)
    path = tmp_path / "train.libsvm"
    with open(path, "w") as f:
        for r in range(data.num_row):
            fi, fv = data.row(r)
            f.write("1 " + " ".join(f"{i}:{v:.5f}" for i, v in zip(fi, fv))
                    + "\n")
    tout, jout = tmp_path / "t.txt", tmp_path / "j.txt"
    args = [str(path), "3", "4"]
    assert tkm.main(["kmeans", *args, str(tout), "kmeans_device_chain=2",
                     "kmeans_device=cpu"]) == 0
    assert jkm.main(["kmeans", *args, str(jout),
                     "kmeans_device_chain=2"]) == 0
    np.testing.assert_allclose(np.loadtxt(tout), np.loadtxt(jout),
                               rtol=1e-4, atol=2e-5)
    with pytest.raises(RabitError, match="kmeans_device"):
        tkm.main(["kmeans", *args, str(tout), "kmeans_device=tpu"])
    for pkg in (rabit_tpu, rabit_tpu_torch):
        pkg.init(rabit_engine="empty")
