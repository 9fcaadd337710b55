"""GBDT gradient-histogram pass: a CUDA kernel for Hopper and its plain
PyTorch version.

Counterpart of :mod:`rabit_tpu.ops.histogram_kernel`.
:func:`hist_fused_multi` returns the (nw, f, nbin) float32 histograms

    out[c, j, b] = sum_r w[c, r] * [bins_t[j, r] == b]

of ``nw <= 64`` weight channels over the transposed (f, n) bins, in one
pass.  The weights are rounded to the compute dtype (default bfloat16,
as on the TPU) and summed in float32; a bin outside [0, nbin) adds
nothing.  It replaces the Pallas kernel
``rabit_tpu/ops/histogram_kernel.py:_hist_kernel``.

On a CUDA tensor it launches the kernel of ``csrc/histogram.cu`` (built
at first use) or raises; on a CPU tensor it runs the plain version
(:func:`_hist_plain`, ``index_add_``), which is also what the card's
kernel is checked against.  ``LAUNCHES`` counts kernel launches.
:func:`_hist_plan` sizes the kernel's launches in Python, so the CPU
tests reach its limits.  The TPU kernel's two-level one-hot plan
(``plan``, ``plan_override``, ``default_block``) fed its matrix unit and
has no counterpart here; what bounds the CUDA kernel, and what its design
does about it, is set out at the top of its source.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from rabit_tpu_torch.ops.reduce_ops import as_torch_dtype

LAUNCHES = {"gbdt_hist": 0}

_MAX_CHANNELS = 64
# The CUDA kernel's limits and shared-memory layout (csrc/histogram.cu:
# kMaxWarps, kRowPad, kMinTileRows, smem_bytes), restated for planning on
# the host.
_MAX_WARPS = 8                    # a block
_ROW_PAD = 16                     # bytes after each staged row
_TILE_ROWS = (128, 64, 32)        # rows a staged tile, widest first
_NARROW_TILE_ROWS = (16, 8)       # only where no wider tile fits
_STAGES = 2                       # tiles in the cp.async ring (kStages)
_BLOCK_SMEM_BYTES = 232448        # 227 KB a block can use on an H100
_SM_SMEM_BYTES = 233472           # shared memory of one H100 SM
_SMEM_PER_BLOCK_RESERVED = 1024
_MAX_SM_THREADS = 2048
_MAX_RESIDENT_BLOCKS = 32
_OWNERS_ENOUGH = 1024             # owner lanes an SM: past this, wider tiles
_PARTIAL_CAP = 256 << 20          # bytes of per-chunk partial histograms
_PLAIN_CHUNK_ELEMS = 1 << 26


def _round16(nbytes: int) -> int:
    return -(-nbytes // 16) * 16


def _smem_bytes(wsz: int, nbin: int, warps: int, cols: int, fb: int,
                cb: int, t_rows: int) -> int:
    """Shared memory of a block (csrc/histogram.cu ``smem_bytes``):
    ``warps`` (nbin x cols) float matrices, rounded up to 16 bytes, and a
    ring of :data:`_STAGES` tiles of ``t_rows`` rows of fb features' int32
    bins and cb channels' weights of ``wsz`` bytes, each row padded."""
    hist = _round16(warps * nbin * cols * 4)
    stage = fb * (4 * t_rows + _ROW_PAD) + cb * (wsz * t_rows + _ROW_PAD)
    return hist + _STAGES * stage


# The widest histogram: one warp of one column, one feature and one float32
# channel staged 8 rows at a time.
MAX_NBIN = (_BLOCK_SMEM_BYTES - _smem_bytes(4, 0, 1, 1, 1, 1, 8)) // 4


@dataclass(frozen=True)
class HistPlan:
    """Launch plan of the histogram kernel: blocks of ``warps`` warps own
    ``features`` x ``channels`` (feature, channel) pairs, ``cols`` a warp
    (pair p = feature * channels + channel is warp p // cols, lane
    p % cols); rows in ``chunks`` chunks of ``chunk_rows``, staged
    ``tile_rows`` at a time through the kernel's ring of :data:`_STAGES`
    tiles; ``uniform`` where every warp is one feature's 32 channels, so
    that the kernel takes its one-feature-warp add path (8 rows a group,
    the tile's bins prepared once for the warp; else 4 rows a group); the
    block's shared memory and the chunk partials' bytes (0 where one chunk
    writes the output itself)."""

    warps: int
    cols: int
    features: int
    channels: int
    tile_rows: int
    uniform: bool
    chunks: int
    chunk_rows: int
    smem: int
    partial_bytes: int


def _balanced(total: int, most: int) -> int:
    """The group size that cuts ``total`` into as few groups of at most
    ``most`` as possible, evenly."""
    groups = -(-total // most)
    return -(-total // groups)


@functools.lru_cache(maxsize=256)
def _hist_plan(n: int, f: int, nw: int, nbin: int, dtype,
               sms: int) -> HistPlan:
    """Plan the kernel for (f, n) bins, nw channels of ``dtype`` weights
    and nbin slots on a card of ``sms`` SMs.  Each warp takes the widest
    column count (32, then 16, ... 1) whose matrices fit; among the block
    shapes of that width, the one with the most owner lanes resident on
    an SM (up to :data:`_OWNERS_ENOUGH`), then the widest tile, then the
    most warps.  The row chunks fill the card about once, within the
    partial cap.  Raises ``ValueError`` past :data:`MAX_NBIN`.  Cached:
    the wrapper plans every call."""
    if nbin > MAX_NBIN:
        raise ValueError(f"nbin={nbin}: the histogram kernel takes "
                         f"nbin <= {MAX_NBIN} (one {MAX_NBIN}-slot float32 "
                         f"histogram in the {_BLOCK_SMEM_BYTES} bytes of "
                         "shared memory of a block)")
    wsz = 2 if as_torch_dtype(dtype) == torch.bfloat16 else 4
    best = None
    for tiles in (_TILE_ROWS, _NARROW_TILE_ROWS):
        for cols in (32, 16, 8, 4, 2, 1):
            for most in range(1, _MAX_WARPS + 1):
                cb = _balanced(nw, min(32, most * cols))
                fb = _balanced(f, max(1, most * cols // cb))
                warps = -(-fb * cb // cols)
                for t in tiles:
                    smem = _smem_bytes(wsz, nbin, warps, cols, fb, cb, t)
                    if smem > _BLOCK_SMEM_BYTES:
                        continue
                    per_sm = min(_MAX_RESIDENT_BLOCKS,
                                 _MAX_SM_THREADS // (32 * warps),
                                 _SM_SMEM_BYTES
                                 // (smem + _SMEM_PER_BLOCK_RESERVED))
                    key = (min(fb * cb * per_sm, _OWNERS_ENOUGH), t, warps)
                    if best is None or key > best[0]:
                        best = key, (warps, cols, fb, cb, t, smem, per_sm)
            if best is not None:
                break
        if best is not None:
            break
    warps, cols, fb, cb, t, smem, per_sm = best[1]
    blocks = -(-f // fb) * -(-nw // cb)
    per_chunk = nw * f * nbin * 4
    chunks = max(1, min(-(-sms * per_sm // blocks), -(-n // t), 65535,
                        _PARTIAL_CAP // per_chunk))
    chunk_rows = -(-(-(-n // chunks)) // t) * t
    chunks = -(-n // chunk_rows)
    return HistPlan(warps, cols, fb, cb, t, cols == cb == 32 and nw % 32 == 0,
                    chunks, chunk_rows, smem,
                    0 if chunks == 1 else chunks * per_chunk)


def max_channels(nbin: int, f: int) -> int:
    """Most weight channels one launch takes.  The kernel splits both
    channels and features over blocks, so this is 64 for every nbin its
    plan takes (up to :data:`MAX_NBIN`), and ``f`` does not enter (it is
    kept for the JAX package's signature); a larger ``nbin`` raises
    ``ValueError``."""
    _hist_plan(1, max(1, f), _MAX_CHANNELS, nbin, torch.float32, 1)
    return _MAX_CHANNELS


# ---------------------------------------------------------------- plain
def _hist_plain(bins_t: torch.Tensor, w: torch.Tensor, nbin: int,
                compute_dtype) -> torch.Tensor:
    """Plain version: the weights rounded to ``compute_dtype`` as the
    kernel rounds them, then added into (nw, f*nbin) float32 slots with
    ``index_add_``, chunked over rows; out-of-range bins land in a trash
    slot that is dropped."""
    f, n = bins_t.shape
    nw = w.shape[0]
    wf = w.to(as_torch_dtype(compute_dtype)).float()
    out = torch.zeros((nw, f * nbin + 1), dtype=torch.float32,
                      device=w.device)
    base = torch.arange(f, device=w.device)[:, None] * nbin
    rows = max(1, _PLAIN_CHUNK_ELEMS // max(1, nw * f))
    for s in range(0, n, rows):
        b = bins_t[:, s:s + rows].long()
        idx = torch.where((b >= 0) & (b < nbin), b + base, f * nbin)
        src = wf[:, None, s:s + rows].expand(nw, f, b.shape[1])
        out.index_add_(1, idx.reshape(-1), src.reshape(nw, -1))
    return out[:, :-1].reshape(nw, f, nbin)


# ----------------------------------------------------------------- CUDA
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from rabit_tpu_torch.ops import _build

        lib = _build.load("histogram")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.gbdt_hist.argtypes = [p, ll, i, p, i, i, i, i, i, i, i, i, i,
                                  ll, i, p, p, p]
        lib.gbdt_hist.restype = i
        lib.gbdt_hist_smem_bytes.argtypes = [i] * 7
        lib.gbdt_hist_smem_bytes.restype = ll
        lib.gbdt_hist_error_string.argtypes = [i]
        lib.gbdt_hist_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _hist_cuda(bins_t: torch.Tensor, w: torch.Tensor, nbin: int,
               cdt: torch.dtype, plan: HistPlan | None = None) -> torch.Tensor:
    """The kernel on ``plan``, by default :func:`_hist_plan`'s (a
    measurement may pass another, such as the general add path's)."""
    if cdt not in (torch.float32, torch.bfloat16):
        raise TypeError(f"hist_fused_multi on CUDA computes in float32 or "
                        f"bfloat16, got {cdt}")
    bins_t = bins_t.to(torch.int32).contiguous()
    w = w.to(cdt).contiguous()
    f, n = bins_t.shape
    nw = w.shape[0]
    out = torch.empty((nw, f, nbin), dtype=torch.float32, device=w.device)
    if n == 0 or f == 0:
        return out.zero_()
    lib = _lib()
    if plan is None:
        sms = torch.cuda.get_device_properties(w.device).multi_processor_count
        plan = _hist_plan(n, f, nw, nbin, cdt, sms)
    partial = torch.empty(plan.partial_bytes // 4, dtype=torch.float32,
                          device=w.device)
    with torch.cuda.device(w.device):
        err = lib.gbdt_hist(
            bins_t.data_ptr(), n, f, w.data_ptr(), int(cdt == torch.bfloat16),
            nw, nbin, plan.warps, plan.cols, plan.features, plan.channels,
            plan.tile_rows, int(plan.uniform), plan.chunk_rows, plan.chunks,
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gbdt_hist launch failed: CUDA error {err} "
                           f"({lib.gbdt_hist_error_string(err).decode()})")
    LAUNCHES["gbdt_hist"] += 1
    return out


# --------------------------------------------------------------- public
def hist_fused_multi(bins_t, weights, nbin: int,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(nw, f, nbin) float32 histograms of ``nw`` weight channels in one
    pass over the TRANSPOSED (f, n) integer bins.

    ``weights`` is (nw, n) on the bins' device; each row gets its own
    (f, nbin) histogram.  Boosting keeps ``bins_t`` resident on the
    device and folds a level's node masks into the channels.  Raises
    ``ValueError`` for ``nw`` outside [1, 64] and for an ``nbin`` that
    :func:`max_channels` refuses.
    """
    bins_t = torch.as_tensor(bins_t)
    weights = torch.as_tensor(weights)
    if bins_t.ndim != 2 or weights.ndim != 2 \
            or weights.shape[1] != bins_t.shape[1]:
        raise ValueError(f"bins_t {tuple(bins_t.shape)} and weights "
                         f"{tuple(weights.shape)} are not (f, n) and (nw, n)")
    if bins_t.is_floating_point() or bins_t.is_complex():
        raise TypeError(f"bins must be integers, got {bins_t.dtype}")
    if bins_t.device != weights.device:
        raise ValueError(f"bins on {bins_t.device}, weights on "
                         f"{weights.device}")
    nw = weights.shape[0]
    if not 1 <= nw <= _MAX_CHANNELS:
        raise ValueError(f"nw={nw} out of range [1, {_MAX_CHANNELS}]")
    max_channels(nbin, bins_t.shape[0])
    cdt = as_torch_dtype(compute_dtype)
    if bins_t.device.type == "cuda":
        return _hist_cuda(bins_t, weights, nbin, cdt)
    if bins_t.device.type != "cpu":
        raise ValueError(f"hist_fused_multi: no kernel for device "
                         f"{bins_t.device}")
    return _hist_plain(bins_t, weights, nbin, cdt)


def hist_fused(bins, grad, hess, nbin: int,
               compute_dtype=torch.bfloat16) -> torch.Tensor:
    """(f, nbin, 2) gradient/hessian histogram of (n, f) bins and (n,)
    ``grad``/``hess``: :func:`hist_fused_multi` with two channels (it
    transposes ``bins``; callers holding the (f, n) layout call the multi
    version directly)."""
    bins = torch.as_tensor(bins)
    w = torch.stack([torch.as_tensor(grad), torch.as_tensor(hess)])
    out = hist_fused_multi(bins.T, w, nbin, compute_dtype=compute_dtype)
    return out.permute(1, 2, 0)
