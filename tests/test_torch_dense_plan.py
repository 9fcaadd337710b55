"""The dense k-means stats kernel's launch plan (``_dense_plan``), on the
CPU.

The kernel (``csrc/kmeans_stats_dense.cu``) stages nothing whole-row, so
any row width fits; the fold's (k, dt) float32 accumulator in shared
memory bounds k.  The plan is Python, so these cases pin what the card
takes without a card: no width raises, shared memory and workspaces stay
within their limits, k reaches at least what the previous kernel took at
every width it took, and past the stated limit the plan raises with the
limit in its message.  ``chip_smoke.py`` checks on the card that the
plan's shared memory is what the kernel's source states.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.ops import kmeans_kernel as tk

SMS = 132                          # an H100 SXM
MAX_SMEM = 232448                  # 227 KB a block on sm_90
PARTIAL_CAP = 256 << 20


def old_kernel_max_k(d: int) -> int:
    """The largest k the previous dense kernel took at width d: its
    ``smem_floats(d, k, dslice=1)`` (``kmeans_stats.cu:93-99``) --
    32 (d+1) row-tile floats, a 32 x 65 centroid stage, k x 1
    accumulator, k counts, 64 row scalars -- within 232,448 bytes."""
    fixed = 32 * (d + 1) + 32 * 65 + 2 * 32
    return (MAX_SMEM // 4 - fixed) // 2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k", [1, 10, 64, 100, 1000])
@pytest.mark.parametrize("d", [1, 100, 1744, 1745, 2048, 2050, 32768,
                               65536])
def test_plan_takes_every_width(d, k, dtype):
    n = 100_003
    plan = tk._dense_plan(n, d, k, dtype, SMS)
    assert plan.classify_smem <= MAX_SMEM and plan.fold_smem <= MAX_SMEM
    assert plan.fold_smem == 4 * (k * plan.dt + k) + 8 * 256
    assert 1 <= plan.dt <= 256 and plan.tiles * plan.dt >= d
    assert (plan.tiles - 1) * plan.dt < d
    vec = 4 if plan.dt % 4 == 0 else 1       # columns a fold thread owns
    assert vec == 4 or plan.dt < 4
    groups = -(-plan.dt // vec)
    assert plan.fold_threads == -(-groups // 32) * 32 + 32
    assert plan.chunks * plan.chunk_rows >= n
    assert (plan.chunks - 1) * plan.chunk_rows < n
    assert plan.partial_bytes <= PARTIAL_CAP
    assert plan.partial_bytes == (0 if plan.chunks == 1 else
                                  plan.chunks * k * (d + 1) * 4)
    assert plan.assign_bytes == 4 * n


def test_k_limit_covers_the_old_kernel_at_every_width_it_took():
    assert old_kernel_max_k(1744) >= 64 > old_kernel_max_k(1745)
    for d in range(1, 1745):
        k = old_kernel_max_k(d)
        assert tk.DENSE_MAX_K >= k
        for dtype in (torch.float32, torch.bfloat16):
            plan = tk._dense_plan(1 << 20, d, k, dtype, SMS)
            assert plan.fold_smem <= MAX_SMEM


@pytest.mark.parametrize("d", [1, 256, 2048, 65536])
def test_past_the_k_limit_the_plan_raises_with_the_limit(d):
    limit = tk.DENSE_MAX_K
    tk._dense_plan(1000, d, limit, torch.bfloat16, SMS)
    with pytest.raises(ValueError, match=f"k <= {limit}") as err:
        tk._dense_plan(1000, d, limit + 1, torch.bfloat16, SMS)
    assert f"k={limit + 1}" in str(err.value)


@pytest.mark.parametrize("n", [1, 127, 128, 3001, 1 << 22])
def test_plan_row_chunks_cover_the_rows(n):
    plan = tk._dense_plan(n, 256, 64, torch.bfloat16, SMS)
    assert plan.chunk_rows % 256 == 0
    assert plan.chunks * plan.chunk_rows >= n > (plan.chunks - 1) * \
        plan.chunk_rows
    assert plan.chunks <= 65535


def test_main_shape_plan():
    """The dense16 main path (4,194,304 x 256 bf16, k=64): one column
    tile of 256 (64 threads of 4 columns and the counts warp), two waves
    of resident fold blocks (three an SM)."""
    plan = tk._dense_plan(1 << 22, 256, 64, torch.bfloat16, SMS)
    assert (plan.dt, plan.tiles, plan.fold_threads) == (256, 1, 96)
    assert plan.chunks == -(-(1 << 22) // plan.chunk_rows)
    assert plan.chunks >= 2 * 3 * SMS * 0.95
    assert plan.classify_smem == 2 * (128 + 64) * 72 * 2


def test_plan_restates_the_kernel_source():
    """The plan's constants are the ones ``kmeans_stats_dense.cu``
    compiles with (the card checks the resulting byte counts)."""
    src = (_build.CSRC_DIR / "kmeans_stats_dense.cu").read_text()
    const = {m.group(1): m.group(2) for m in re.finditer(
        r"constexpr int (k\w+) = ([^;]+);", src)}
    assert const["kBlockRows"] == str(tk._DENSE_BLOCK_ROWS)
    assert const["kCentChunk"] == const["kFeatChunk"] == str(tk._DENSE_CHUNK)
    assert const["kFoldCols"] == str(tk._DENSE_FOLD_VEC)
    assert const["kFoldMaxCols"] == str(tk._DENSE_FOLD_MAX_COLS)
    assert const["kFoldBatch"] == str(tk._DENSE_FOLD_BATCH)
    assert const["kMaxSmemBytes"] == str(tk._DENSE_MAX_SMEM)
    assert const["kLd16"] == "kFeatChunk + 8"
    assert const["kLd32"] == "kFeatChunk + 4"
    assert const["kSimLd"] == "kCentChunk + 4"


def test_cuda_route_builds_or_raises(monkeypatch, tmp_path):
    """The dense CUDA route builds its own library and launches it or
    raises: without nvcc it raises, counts no launch, and never runs the
    plain version in its place."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_LIBS", {})
    monkeypatch.setattr(tk, "_DENSE_LIB", None)
    monkeypatch.setattr("shutil.which", lambda _name: None)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    monkeypatch.setattr(tk, "_stats_plain", None)
    before = dict(tk.LAUNCHES)
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((64, 2048)).astype(np.float32))
    cent = torch.from_numpy(rng.standard_normal((4, 2048)).astype(np.float32))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        tk._dense_cuda(tk._normalized(cent, x.dtype), x, torch.ones(64))
    assert tk.LAUNCHES == before
    assert not list(Path(tmp_path).glob("*.so"))
