"""The B1 variant study: the port's classify stages against the JAX
tool's kernel bodies.

``tools/kernel_experiments.py`` builds each variant's Pallas body with
``build_kernel(mode)`` and wraps it in ``build_loop``, whose
``pallas_call`` has no interpret flag.  The test wraps the same bodies
with ``build_loop``'s BlockSpecs (its lines 138-174) at a small size
and runs them in interpret mode on the CPU; the same seeded numpy inputs
go through ``rabit_tpu_torch.ops.kmeans_kernel.kmeans_stats_variant``
on CPU tensors (the plain version).  The CUDA kernels are held against
the plain version on the card by ``chip_smoke.py``.

Bars: counts exact where they are counts of rows (argmax, maxcmp,
novalid, argmaxT); where a count is a float sum (simonly's clipped
similarities, the keep-alive anchor of simonlyT and cheapassignT) it is
held to the sum bar, ``rtol=1e-4, atol=1e-3``, the JAX kernel tests'
own, as are all sums, in float32 and bfloat16 inputs alike.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.ops import kmeans_kernel as tk
from rabit_tpu_torch.tools import kernel_experiments as tke
from rabit_tpu_torch.tools import stats_ab

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUM_TOL = dict(rtol=1e-4, atol=1e-3)
N, D, K, BLOCK = 512, 64, 16, 128
_ROW_COUNTS = ("argmax", "maxcmp", "novalid", "argmaxT")
_TRANSPOSED = ("argmaxT", "simonlyT", "cheapassignT")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_experiments", os.path.join(ROOT, "tools",
                                               "kernel_experiments.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_stats(tool, mode, cn, x, valid, block):
    """One stats pass of ``build_kernel(mode)`` with build_loop's specs,
    in interpret mode; the (k, d+1) matrix."""
    n, d = x.shape
    k = cn.shape[0]
    kernel = tool.build_kernel(mode)
    if mode in _TRANSPOSED:
        sums, counts = pl.pallas_call(
            kernel, grid=(n // block,),
            in_specs=[pl.BlockSpec((block, d), lambda i: (i, 0)),
                      pl.BlockSpec((k, d), lambda i: (0, 0)),
                      pl.BlockSpec((1, block), lambda i: (0, i))],
            out_specs=(pl.BlockSpec((k, d), lambda i: (0, 0)),
                       pl.BlockSpec((k, 1), lambda i: (0, 0))),
            out_shape=(jax.ShapeDtypeStruct((k, d), jnp.float32),
                       jax.ShapeDtypeStruct((k, 1), jnp.float32)),
            interpret=True)(x, cn, valid.reshape(1, n))
        counts = counts.T
    else:
        sums, counts = pl.pallas_call(
            kernel, grid=(n // block,),
            in_specs=[pl.BlockSpec((block, d), lambda i: (i, 0)),
                      pl.BlockSpec((k, d), lambda i: (0, 0)),
                      pl.BlockSpec((block, 1), lambda i: (i, 0))],
            out_specs=(pl.BlockSpec((k, d), lambda i: (0, 0)),
                       pl.BlockSpec((1, k), lambda i: (0, 0))),
            out_shape=(jax.ShapeDtypeStruct((k, d), jnp.float32),
                       jax.ShapeDtypeStruct((1, k), jnp.float32)),
            interpret=True)(x, cn, valid.reshape(n, 1))
    return np.concatenate([np.asarray(sums), np.asarray(counts).T], axis=1)


def _inputs(seed, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D)).astype(np.float32)
    cent = rng.standard_normal((K, D)).astype(np.float32)
    if dup:
        cent[5] = cent[2]          # every row near 2 ties 2 and 5 exactly
    valid = (rng.random(N) > 0.1).astype(np.float32)
    return cent, x, valid


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", tk.VARIANTS)
def test_variant_matches_jax_body(mode, dtype):
    cent, x, valid = _inputs(0, dup=mode == "maxcmp")
    jdt = jnp.dtype(dtype)
    cn = cent / (np.linalg.norm(cent, axis=1, keepdims=True) + 1e-12)
    want = _jax_stats(_jax_tool(), mode, jnp.asarray(cn).astype(jdt),
                      jnp.asarray(x).astype(jdt), jnp.asarray(valid), BLOCK)
    got = tk.kmeans_stats_variant(
        torch.from_numpy(cent), torch.from_numpy(x).to(getattr(torch, dtype)),
        torch.from_numpy(valid), mode, block=BLOCK).numpy()
    assert got.shape == (K, D + 1)
    if mode in _ROW_COUNTS:
        np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got, want, **SUM_TOL)
    if mode == "maxcmp":           # the tied rows count twice
        assert got[:, -1].sum() > valid.sum()
        assert got[2, -1] == got[5, -1] > 0


def test_argmax_variants_are_the_production_pass():
    cent, x, valid = _inputs(1)
    args = (torch.from_numpy(cent), torch.from_numpy(x),
            torch.from_numpy(valid))
    prod = tk.kmeans_stats_fused(*args)
    for mode in ("argmax", "argmaxT"):
        assert torch.equal(tk.kmeans_stats_variant(*args, mode), prod)


def test_variant_rejects_bad_arguments():
    cent, x, valid = _inputs(2)
    args = (torch.from_numpy(cent), torch.from_numpy(x),
            torch.from_numpy(valid))
    with pytest.raises(ValueError, match="unknown classify stage"):
        tk.kmeans_stats_variant(*args, "argmin")
    with pytest.raises(ValueError, match="must be positive"):
        tk.kmeans_stats_variant(*args, "cheapassignT", block=0)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tk.kmeans_stats_variant(torch.empty((2, 4), device="meta"),
                                torch.empty((8, 4), device="meta"),
                                torch.empty(8, device="meta"), "maxcmp")


def test_variant_cpu_tensors_never_count_launches():
    before = dict(tk.LAUNCHES)
    cent, x, valid = _inputs(3)
    for mode in tk.VARIANTS:
        tk.kmeans_stats_variant(torch.from_numpy(cent), torch.from_numpy(x),
                                torch.from_numpy(valid), mode)
    assert tk.LAUNCHES == before


def test_tool_specs_and_loop_on_the_cpu(capsys):
    """The tool's spec strings parse as the JAX tool's do, and its
    chained loop with centroid feedback runs on CPU tensors: its plain
    check passes and the final centroids are finite."""
    assert tke.parse_spec("simonly:8192:bfloat16:64") == (
        "simonly", 8192, torch.bfloat16)
    with pytest.raises(ValueError, match="mode:block:dtype:vmem"):
        tke.parse_spec("argmax:2048")
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    c = torch.from_numpy(rng.standard_normal((K, D)).astype(np.float32))
    v = torch.ones(N)
    for mode in tk.VARIANTS:
        err = tke.check_variant(mode, BLOCK, torch.float32, c, x, v)
        assert err <= 1e-3
        out = tke.chained(mode, BLOCK, torch.float32, c, x, v, iters=3)
        assert out.shape == (K, D) and torch.isfinite(out).all()


def test_tool_refuses_to_time_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tke.main(["argmax:128:float32:16"])


def test_cuda_route_raises_without_the_toolkit(monkeypatch, tmp_path):
    """The variants' CUDA route builds and launches the kernel or raises;
    without nvcc it raises and counts no launch."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tk, "_LIB", None)
    monkeypatch.setattr("shutil.which", lambda _name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    before = dict(tk.LAUNCHES)
    cent, x, valid = (torch.from_numpy(a) for a in _inputs(5))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tk._dense_cuda(tk._normalized(cent, x.dtype), x, valid, "simonly",
                       BLOCK)
    assert tk.LAUNCHES == before


@pytest.mark.parametrize("argv,says", [
    ([], "kmeans_stats.cu"),
    (["a.cu", "b.cu"], "stats_ab [OTHER.cu]"),
])
def test_stats_ab_default_source_and_usage(monkeypatch, capsys, argv, says):
    """Without a source ``stats_ab`` holds B1 against the in-tree
    ``kmeans_stats.cu`` (on the card only: here it says so and stops);
    with two it prints its usage."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert stats_ab.main(argv) == 2
    assert says in capsys.readouterr().err
