"""The GBDT histogram kernel's launch plan (``_hist_plan``), on the CPU.

The plan is Python, so its limits are checked here, over the nbin, channel
and feature counts the port takes, without the card: the shared memory a
block asks for, the partial buffer, the owner mapping the kernel applies
(``csrc/histogram.cu``: pair p = feature * channels + channel is warp
p // cols, lane p % cols, in the rectangle of block (x, y)), and the row
chunks.  The kernel itself is held against its plain version on the card
by ``chip_smoke.py``, which also holds the plan's shared memory against
the source's ``gbdt_hist_smem_bytes``.
"""
import numpy as np
import pytest
import torch

from rabit_tpu_torch.ops import histogram_kernel as hk

SMS = 132                       # an H100 SXM
NBINS = [2, 7, 16, 256, 257, 1024, 2048, 4096, 58045]
CHANNELS = [1, 2, 3, 16, 33, 64]
FEATURES = [1, 3, 64, 1000]
ROWS = [5, 100003, 1 << 21]


def owners(plan, f, nw):
    """(feature, channel) of every owner lane over the grid of blocks,
    as the kernel maps them, and for every warp of every block its owner
    lanes and the features they hold (grid x, grid y, warp, lane)."""
    fg, cg = -(-f // plan.features), -(-nw // plan.channels)
    bx, by, warp, lane = np.meshgrid(np.arange(fg), np.arange(cg),
                                     np.arange(plan.warps), np.arange(32),
                                     indexing="ij")
    j0, c0 = bx * plan.features, by * plan.channels
    fb_here = np.minimum(plan.features, f - j0)
    cb_here = np.minimum(plan.channels, nw - c0)
    p = warp * plan.cols + lane
    owner = (lane < plan.cols) & (p < fb_here * cb_here)
    jl, c = p // cb_here, p % cb_here
    return (j0 + jl)[owner], (c0 + c)[owner], owner, np.where(owner, jl, -1)


def check_plan(plan, n, f, nw, nbin, dtype):
    wsz = 2 if dtype == torch.bfloat16 else 4
    assert 1 <= plan.warps <= hk._MAX_WARPS
    assert plan.cols in (1, 2, 4, 8, 16, 32)
    assert 1 <= plan.channels <= min(nw, 32) and 1 <= plan.features <= f
    assert plan.features * plan.channels <= plan.warps * plan.cols
    # no warp is left without an owner lane in a full rectangle
    assert (plan.warps - 1) * plan.cols < plan.features * plan.channels
    # tiles of a power of two rows, 8 at least, at most 32 groups of the
    # add path's rows (8 on the one-feature-warp path, else 4)
    t = plan.tile_rows
    unroll = 8 if plan.uniform else 4
    assert t >= 8 and t & (t - 1) == 0 and t % unroll == 0
    assert t <= 32 * unroll
    assert plan.smem == hk._smem_bytes(wsz, nbin, plan.warps, plan.cols,
                                       plan.features, plan.channels,
                                       plan.tile_rows)
    assert plan.smem <= 232448
    assert plan.partial_bytes <= hk._PARTIAL_CAP
    assert plan.partial_bytes == (0 if plan.chunks == 1 else
                                  plan.chunks * nw * f * nbin * 4)
    # the row chunks cover [0, n) once, in whole tiles, none empty
    assert plan.chunk_rows % plan.tile_rows == 0
    assert 1 <= plan.chunks <= 65535
    assert (plan.chunks - 1) * plan.chunk_rows < n <= \
        plan.chunks * plan.chunk_rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("nbin", NBINS)
def test_plan_covers_every_pair_and_row(nbin, dtype):
    for nw in CHANNELS:
        for f in FEATURES:
            for n in ROWS:
                plan = hk._hist_plan(n, f, nw, nbin, dtype, SMS)
                check_plan(plan, n, f, nw, nbin, dtype)
            feat, chan, owner, jl = owners(plan, f, nw)
            key = np.sort(feat * nw + chan)
            assert np.array_equal(key, np.arange(f * nw)), (nw, f)
            # the one-feature-warp path: every warp that owns anything owns
            # 32 channels of one feature, in every block
            busy = owner.any(axis=3)
            whole = owner.all(axis=3) & (jl.min(axis=3) == jl.max(axis=3))
            assert plan.uniform == bool((whole | ~busy).all()
                                        and plan.cols == 32), (nw, f)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("f", [1, 3, 64, 1000])
def test_no_idle_owner_at_the_main_width(f, dtype):
    """At 257 slots and 64 channels a warp keeps 32 columns, one feature
    of 32 channels, and every lane of a full rectangle owns a histogram."""
    plan = hk._hist_plan(1 << 21, f, 64, 257, dtype, SMS)
    assert plan.cols == 32 and plan.channels == 32
    assert plan.features * plan.channels == plan.warps * plan.cols


def test_main_shape_plan():
    """The main path's widest level: 6 owner warps of 32 channels, one
    block an SM, the row chunks filling the 132 SMs once."""
    plan = hk._hist_plan(1 << 21, 64, 64, 257, torch.bfloat16, SMS)
    assert (plan.warps, plan.features, plan.channels) == (6, 6, 32)
    blocks = -(-64 // plan.features) * 2 * plan.chunks
    assert SMS <= blocks < SMS + 2 * -(-64 // plan.features)
    assert plan.smem > 233472 // 2 - 1024


@pytest.mark.parametrize("nbin,cols", [(257, 32), (1024, 32), (2048, 16),
                                       (4096, 8), (58045, 1)])
def test_columns_narrow_with_nbin(nbin, cols):
    for dtype in (torch.bfloat16, torch.float32):
        assert hk._hist_plan(1 << 21, 64, 64, nbin, dtype, SMS).cols == cols


def test_limit_raises_past_it():
    assert hk.MAX_NBIN >= 58045
    for dtype in (torch.bfloat16, torch.float32):
        plan = hk._hist_plan(1000, 1, 64, hk.MAX_NBIN, dtype, SMS)
        assert plan.smem <= 232448
        with pytest.raises(ValueError, match=f"nbin <= {hk.MAX_NBIN}"):
            hk._hist_plan(1000, 1, 64, hk.MAX_NBIN + 1, dtype, SMS)
