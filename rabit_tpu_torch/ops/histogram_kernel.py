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
kernel is checked against.  ``LAUNCHES`` counts kernel launches.  The
TPU kernel's two-level one-hot plan (``plan``, ``plan_override``,
``default_block``) fed its matrix unit and has no counterpart here; what
bounds the CUDA kernel, and what its design does about it, is set out at
the top of its source.
"""
from __future__ import annotations

import ctypes
import math

import torch

from rabit_tpu_torch.ops.reduce_ops import as_torch_dtype

LAUNCHES = {"gbdt_hist": 0}

_MAX_CHANNELS = 64
# The CUDA kernel's shared-memory layout (csrc/histogram.cu: kThreads,
# kTileRows, hist_stride, smem_words), mirrored for planning on the host.
_THREADS = 256
_TILE_ROWS = 32
_BLOCK_SMEM_BYTES = 232448        # 227 KB a block can use on an H100
_SM_SMEM_BYTES = 233472           # shared memory of one H100 SM
_SMEM_PER_BLOCK_RESERVED = 1024
_HIST_BYTES_PER_BLOCK = 72 << 10  # about three blocks per SM
_PLAIN_CHUNK_ELEMS = 1 << 26


def _stride(nbin: int) -> int:
    """Floats of one (feature, channel) histogram in shared memory: the
    nbin slots and a trash slot, rounded up to an odd count."""
    return (nbin + 1) | 1


def _smem_bytes(fb: int, cb: int, nbin: int) -> int:
    """Shared memory of a block that owns fb features x cb channels."""
    return 4 * (fb * cb * _stride(nbin) + fb * (_TILE_ROWS + 1)
                + _TILE_ROWS * (cb | 1))


def max_channels(nbin: int, f: int) -> int:
    """Most weight channels one launch takes.  The kernel splits both
    channels and features over blocks, so this is 64 whenever one
    (feature, channel) histogram of ``nbin`` slots fits a block's shared
    memory, and ``f`` does not enter (it is kept for the JAX package's
    signature); a larger ``nbin`` raises ``ValueError``."""
    if _smem_bytes(1, 1, nbin) > _BLOCK_SMEM_BYTES:
        raise ValueError(f"nbin={nbin}: one histogram does not fit the "
                         f"{_BLOCK_SMEM_BYTES} bytes of shared memory of a "
                         "block")
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
        lib.gbdt_hist.argtypes = [p, ll, i, p, i, i, i, i, i, ll, i, p, p,
                                  p]
        lib.gbdt_hist.restype = i
        lib.gbdt_hist_error_string.argtypes = [i]
        lib.gbdt_hist_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _balanced(total: int, most: int) -> int:
    """The group size that cuts ``total`` into as few groups of at most
    ``most`` as possible, evenly."""
    groups = -(-total // most)
    return -(-total // groups)


def _plan(device: torch.device, n: int, f: int, nw: int, nbin: int):
    """(fb, cb, chunk_rows, n_chunks): a block owns fb features x cb
    channels, about square within the block's histogram budget, so that
    each staged bin and weight feeds several adds; the rows are cut into
    chunks so that the grid fills every SM about once."""
    pairs = max(1, min(_THREADS,
                       _HIST_BYTES_PER_BLOCK // (_stride(nbin) * 4)))
    cb = _balanced(nw, max(1, math.isqrt(pairs)))
    fb = _balanced(f, max(1, pairs // cb))
    smem = _smem_bytes(fb, cb, nbin)
    per_sm = max(1, min(2048 // _THREADS,
                        _SM_SMEM_BYTES // (smem + _SMEM_PER_BLOCK_RESERVED)))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    blocks = -(-f // fb) * -(-nw // cb)
    n_chunks = max(1, min(-(-n // _TILE_ROWS), sms * per_sm // blocks))
    chunk_rows = -(-n // n_chunks)
    chunk_rows = -(-chunk_rows // _TILE_ROWS) * _TILE_ROWS
    return fb, cb, chunk_rows, -(-n // chunk_rows)


def _hist_cuda(bins_t: torch.Tensor, w: torch.Tensor, nbin: int,
               cdt: torch.dtype) -> torch.Tensor:
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
    fb, cb, chunk_rows, n_chunks = _plan(w.device, n, f, nw, nbin)
    partial = torch.empty((n_chunks, nw, f, nbin), dtype=torch.float32,
                          device=w.device)
    with torch.cuda.device(w.device):
        err = lib.gbdt_hist(
            bins_t.data_ptr(), n, f, w.data_ptr(), int(cdt == torch.bfloat16),
            nw, nbin, fb, cb, chunk_rows, n_chunks, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
