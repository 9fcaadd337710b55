"""The B1 variant study's one-pass kernel: its launch plan
(``_variant_plan``) and its grouping of the sums, on the CPU.

The kernel (``csrc/kmeans_stats_variant.cu``) walks tiles of 64 rows in
chunks of 64 features and holds a (kp, ds) float32 accumulator in
registers, kp being k padded to a power of two in [32, 128].  The plan
is Python, so these cases pin what the card takes without a card: every
shape's shared memory stays within a block's 227 KB, the column slices
cover d and appear where the accumulator or shared memory no longer
holds d, the plan raises past each limit with the limit in its message,
and the study's shape is planned exactly.  ``chip_smoke.py`` checks on
the card that the plan's shared memory is what the kernel's source
states.

The kernel deals tiles to blocks and sums per-block partials, with each
tile's keep-alive sum (``simonlyT``, ``cheapassignT``) inside its
block's: ``_variant_blocked_plain`` mirrors that grouping, and is held
here against the JAX tool's kernel bodies in interpret mode (as
``tests/test_torch_kernel_experiments.py`` holds the plain version) and
against ``_variant_plain``.  Bars: counts exact where they count rows,
everything else within ``rtol=1e-4, atol=1e-3``, the JAX kernel tests'.
"""
import importlib.util
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.ops import kmeans_kernel as tk

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMS = 132                          # an H100 SXM
MAX_SMEM = 232448                  # 227 KB a block on sm_90
SUM_TOL = dict(rtol=1e-4, atol=1e-3)
_ROW_COUNTS = ("argmax", "maxcmp", "novalid", "argmaxT")
_TRANSPOSED = ("argmaxT", "simonlyT", "cheapassignT")
DTYPES = [torch.float32, torch.bfloat16]


def check_plan(plan, n, d, k, dtype):
    es = 2 if dtype == torch.bfloat16 else 4
    assert plan.smem <= MAX_SMEM
    assert plan.smem == tk._variant_smem(es, plan.kp, d, plan.ds,
                                         plan.slices, plan.resident,
                                         plan.prefetch)
    assert plan.kp in (32, 64, 128) and plan.kp >= k
    assert plan.kp == 32 or plan.kp // 2 < k
    assert plan.ds % 64 == 0 and plan.kp * plan.ds <= 16384
    assert plan.slices * plan.ds >= d > (plan.slices - 1) * plan.ds
    # a load lands in the slice buffer of the tile two back: at most a
    # tile's chunks ahead
    assert 1 <= plan.prefetch <= min(4, -(-d // 64))
    assert 1 <= plan.grid <= max(1, -(-n // 64))
    assert plan.grid * plan.slices <= max(SMS, plan.slices)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("k", [1, 10, 64, 100])
@pytest.mark.parametrize("d", [1, 64, 250, 256, 257, 2048, 32768])
def test_plan_fits_every_shape(d, k, dtype):
    n = 100_003
    plan = tk._variant_plan(n, d, k, dtype, SMS)
    check_plan(plan, n, d, k, dtype)


@pytest.mark.parametrize("d,k,dtype,ds,slices", [
    # bf16: the accumulator (kp * ds <= 16384) sets the width
    (256, 64, torch.bfloat16, 256, 1),
    (257, 64, torch.bfloat16, 256, 2),
    (2048, 64, torch.bfloat16, 256, 8),
    (256, 100, torch.bfloat16, 128, 2),
    (512, 10, torch.bfloat16, 512, 1),
    (1024, 10, torch.bfloat16, 512, 2),
    # float32: shared memory narrows it further once x needs a ring
    (256, 64, torch.float32, 256, 1),
    (257, 64, torch.float32, 192, 2),
    (2048, 64, torch.float32, 192, 11),
    (256, 100, torch.float32, 64, 4),
])
def test_slices_appear_where_the_accumulator_no_longer_fits(d, k, dtype, ds,
                                                            slices):
    plan = tk._variant_plan(1 << 16, d, k, dtype, SMS)
    assert (plan.ds, plan.slices) == (ds, slices)
    # the next wider slice would not fit the registers or shared memory
    wider = plan.ds + 64
    es = 2 if dtype == torch.bfloat16 else 4
    if plan.slices > 1 and plan.kp * wider <= 16384:
        assert all(
            tk._variant_smem(es, plan.kp, d, wider, -(-d // wider), res,
                             pf) > MAX_SMEM
            for res in (True, False) for pf in (1, 2, 3, 4)
            if -(-d // wider) < plan.slices)


@pytest.mark.parametrize("dtype", DTYPES)
def test_past_the_k_limit_the_plan_raises_with_the_limit(dtype):
    limit = tk.VARIANT_MAX_K
    tk._variant_plan(1000, 256, limit, dtype, SMS)
    for k in (0, limit + 1):
        with pytest.raises(ValueError, match=f"k <= {limit}") as err:
            tk._variant_plan(1000, 256, k, dtype, SMS)
        assert f"k={k}" in str(err.value)


@pytest.mark.parametrize("dtype,widest", [(torch.bfloat16, 256),
                                          (torch.float32, 192)])
def test_past_the_slice_limit_the_plan_raises_with_the_limit(dtype, widest):
    """The grid's y axis holds 65,535 slices, of the widest ds that fits
    with several slices (float32: 192, shared memory)."""
    limit = tk.VARIANT_MAX_SLICES * widest
    plan = tk._variant_plan(1000, limit, 64, dtype, SMS)
    assert (plan.slices, plan.ds) == (tk.VARIANT_MAX_SLICES, widest)
    check_plan(plan, 1000, limit, 64, dtype)
    with pytest.raises(ValueError,
                       match=f"at most {tk.VARIANT_MAX_SLICES} column") as e:
        tk._variant_plan(1000, limit + 1, 64, dtype, SMS)
    assert f"d <= {limit}" in str(e.value)


def test_study_shape_plan():
    """The study's shape (524,288 x 256, k=64).  bf16: one slice, the
    centroids resident, 4 chunks (a tile) in flight, one block an SM; its
    shared memory region by region.  float32: the centroids no longer fit
    beside two slice buffers of 256 columns, so they stream, 2 chunks
    ahead."""
    plan = tk._variant_plan(1 << 19, 256, 64, torch.bfloat16, SMS)
    assert plan == tk.VariantPlan(kp=64, ds=256, slices=1, resident=True,
                                  prefetch=4, grid=132, smem=132992)
    regions = (256 * 72 * 2           # centroids, (d, kp + 8) bf16
               + 2 * 64 * 264 * 2     # two slice buffers, (64, ds + 8)
               + 64 * 68 * 4          # similarity, (64, kp + 4) float32
               + 64 * 72 * 2          # weights, (64, kp + 8) bf16
               + 3 * 64 * 4           # per-row scalars
               + 1152)                # 257 counts, to 128 bytes
    assert plan.smem == regions
    plan = tk._variant_plan(1 << 19, 256, 64, torch.float32, SMS)
    assert (plan.kp, plan.ds, plan.slices, plan.resident, plan.prefetch,
            plan.grid) == (64, 256, 1, False, 2, 132)
    assert plan.smem == 222080


@pytest.mark.parametrize("n", [1, 63, 64, 3001, 1 << 19])
def test_grid_takes_one_block_a_tile_up_to_one_an_sm(n):
    plan = tk._variant_plan(n, 256, 64, torch.bfloat16, SMS)
    assert plan.grid == min(-(-n // 64), SMS)


def test_plan_restates_the_kernel_source():
    """The plan's constants are the ones ``kmeans_stats_variant.cu``
    compiles with (the card checks the resulting byte counts)."""
    src = (_build.CSRC_DIR / "kmeans_stats_variant.cu").read_text()
    const = {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (k\w+) = ([^;]+);", src)}
    assert const["kRows"] == str(tk._VAR_ROWS)
    assert const["kChunk"] == str(tk._VAR_CHUNK)
    assert const["kThreads"] == str(tk._VAR_THREADS)
    assert const["kMinKp"] == str(tk._VAR_MIN_KP)
    assert const["kMaxKp"] == str(tk.VARIANT_MAX_K)
    assert const["kAccElems"] == str(tk._VAR_ACC)
    assert const["kMaxPrefetch"] == str(tk._VAR_MAX_PREFETCH)
    assert const["kSimPad"] == str(tk._VAR_SIM_PAD)
    assert const["kAlign"] == str(tk._VAR_ALIGN)
    assert const["kMaxSmemBytes"] == str(tk._DENSE_MAX_SMEM)
    assert "return 16 / es;" in src               # the stage rows' pad
    assert "ny > 65535" in src and tk.VARIANT_MAX_SLICES == 65535


def _jax_stats(mode, cn, x, valid, block):
    """One stats pass of the JAX tool's ``build_kernel(mode)`` body with
    ``build_loop``'s BlockSpecs, in interpret mode: the (k, d+1)
    matrix."""
    spec = importlib.util.spec_from_file_location(
        "jax_kernel_experiments", os.path.join(ROOT, "tools",
                                               "kernel_experiments.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    n, d = x.shape
    k = cn.shape[0]
    t = mode in _TRANSPOSED
    vspec = (pl.BlockSpec((1, block), lambda i: (0, i)) if t else
             pl.BlockSpec((block, 1), lambda i: (i, 0)))
    cshape = (k, 1) if t else (1, k)
    sums, counts = pl.pallas_call(
        tool.build_kernel(mode), grid=(n // block,),
        in_specs=[pl.BlockSpec((block, d), lambda i: (i, 0)),
                  pl.BlockSpec((k, d), lambda i: (0, 0)), vspec],
        out_specs=(pl.BlockSpec((k, d), lambda i: (0, 0)),
                   pl.BlockSpec(cshape, lambda i: (0, 0))),
        out_shape=(jax.ShapeDtypeStruct((k, d), jnp.float32),
                   jax.ShapeDtypeStruct(cshape, jnp.float32)),
        interpret=True)(x, cn, valid.reshape((1, n) if t else (n, 1)))
    counts = np.asarray(counts).reshape(-1)
    return np.concatenate([np.asarray(sums), counts[:, None]], axis=1)


def _inputs(seed, n, d, k, dup=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    cent = rng.standard_normal((k, d)).astype(np.float32)
    if dup:
        cent[5] = cent[2]          # every row near 2 ties 2 and 5 exactly
    valid = (rng.random(n) > 0.1).astype(np.float32)
    return cent, x, valid


def _check(got, want, mode):
    if mode in _ROW_COUNTS:
        np.testing.assert_array_equal(got[:, -1], want[:, -1])
    np.testing.assert_allclose(got, want, **SUM_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", tk.VARIANTS)
def test_blocked_mirror_matches_jax_body(mode, dtype):
    """512 rows in 8 tiles dealt to 3 blocks (3, 3, 2 tiles)."""
    n, d, k, block = 512, 64, 16, 128
    cent, x, valid = _inputs(6, n, d, k, dup=mode == "maxcmp")
    jdt = jnp.dtype(dtype)
    cn = cent / (np.linalg.norm(cent, axis=1, keepdims=True) + 1e-12)
    want = _jax_stats(mode, jnp.asarray(cn).astype(jdt),
                      jnp.asarray(x).astype(jdt), jnp.asarray(valid), block)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(x).to(tdt)
    got = tk._variant_blocked_plain(tk._normalized(torch.from_numpy(cent),
                                                   tdt), tx,
                                    torch.from_numpy(valid), mode, block,
                                    grid=3).numpy()
    assert got.shape == (k, d + 1)
    _check(got, want, mode)
    if mode == "maxcmp":           # the tied rows count twice
        assert got[2, -1] == got[5, -1] > 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", tk.VARIANTS)
def test_blocked_mirror_matches_the_plain_version(mode, dtype):
    """A ragged shape (3,001 rows: a last tile of 57) over the grid its
    plan takes, and cheapassignT's block not a multiple of the tiles."""
    n, d, k = 3001, 250, 10
    cent, x, valid = _inputs(7, n, d, k)
    plan = tk._variant_plan(n, d, k, dtype, SMS)
    assert plan.grid == 47
    cn = tk._normalized(torch.from_numpy(cent), dtype)
    tx = torch.from_numpy(x).to(dtype)
    tv = torch.from_numpy(valid)
    got = tk._variant_blocked_plain(cn, tx, tv, mode, 100, plan.grid)
    want = tk._variant_plain(cn, tx, tv, mode, 100)
    _check(got.numpy(), want.numpy(), mode)


def test_cuda_route_builds_or_raises(monkeypatch, tmp_path):
    """The variants' CUDA route builds its own library and launches it or
    raises: without nvcc it raises, counts no launch, and never runs the
    plain version in its place."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tk, "_VARIANT_LIB", None)
    monkeypatch.setattr("shutil.which", lambda _name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(tk, "_variant_plain", None)
    monkeypatch.setattr(tk, "_variant_blocked_plain", None)
    before = dict(tk.LAUNCHES)
    cent, x, valid = (torch.from_numpy(a) for a in _inputs(8, 256, 64, 16))
    for mode in tk.VARIANTS:
        with pytest.raises(RuntimeError, match="nvcc not found"):
            tk._variant_cuda(tk._normalized(cent, x.dtype), x, valid, mode,
                             128)
    assert tk.LAUNCHES == before
    assert not list(Path(tmp_path).glob("*.so"))
