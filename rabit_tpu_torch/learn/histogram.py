"""XGBoost-style gradient-histogram building and allreduce (counterpart
of :mod:`rabit_tpu.learn.histogram`).

Each worker bins its feature shard, sums (grad, hess) per (feature, bin)
for the tree nodes being split, and Allreduce<Sum>s the flat histogram so
that every worker sees the global statistics.  The builders run
:func:`rabit_tpu_torch.ops.histogram_kernel.hist_fused_multi`: the CUDA
kernel when the bins are a CUDA tensor (``use_kernel``, default True
exactly then), else its plain version in float32 -- the counterpart of
the JAX package's XLA one-hot builder off the TPU.  The host helpers
(cuts, binning, split gains) are numpy copies of the JAX package's, bit
for bit.
"""
from __future__ import annotations

import warnings

import numpy as np
import torch

import rabit_tpu_torch
from rabit_tpu_torch import engine as _engine_mod
from rabit_tpu_torch.ops import SUM
from rabit_tpu_torch.ops import histogram_kernel as hk

# ------------------------------------------------------------ host side
def quantile_cuts(values: np.ndarray, nbin: int) -> np.ndarray:
    """Per-column quantile cut points, shape (f, nbin - 1).  NaN entries
    are missing values: cuts come from the present entries only; an
    all-NaN column gets zero cuts."""
    qs = np.linspace(0, 1, nbin + 1)[1:-1]
    with np.errstate(all="ignore"), warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        cuts = np.nanquantile(values, qs, axis=0).T
    return np.nan_to_num(cuts, nan=0.0).astype(np.float32)


def apply_cuts(values: np.ndarray, cuts: np.ndarray) -> np.ndarray:
    """Bin raw feature values with quantile cuts: int32 in [0, nbin),
    and NaN (missing) to the dedicated bin ``nbin`` one past the regular
    range."""
    n, f = values.shape
    bins = np.empty((n, f), np.int32)
    for j in range(f):
        bins[:, j] = np.searchsorted(cuts[j], values[:, j], side="right")
    nan = np.isnan(values)
    if nan.any():
        bins[nan] = cuts.shape[1] + 1
    return bins


def quantize(values: np.ndarray, nbin: int):
    """Quantile-bin each feature column; returns (bins, cuts)."""
    cuts = quantile_cuts(values, nbin)
    return apply_cuts(values, cuts), cuts


def split_gain(hist: np.ndarray, reg_lambda: float = 1.0) -> np.ndarray:
    """Per (feature, cut) split gain from an (f, nbin, 2) histogram: the
    XGBoost structure score, vectorized over all cuts."""
    g = hist[:, :, 0]
    h = hist[:, :, 1]
    gl = np.cumsum(g, axis=1)[:, :-1]
    hl = np.cumsum(h, axis=1)[:, :-1]
    gt = g.sum(axis=1, keepdims=True)
    ht = h.sum(axis=1, keepdims=True)
    gr, hr = gt - gl, ht - hl
    parent = gt * gt / (ht + reg_lambda)
    return (gl * gl / (hl + reg_lambda)
            + gr * gr / (hr + reg_lambda) - parent)


def split_gain_missing(hist: np.ndarray, reg_lambda: float = 1.0):
    """Sparsity-aware split gain: the LAST bin of ``hist`` (f, nbin, 2)
    holds the missing rows.  Returns ``(gain, default_left)``: the better
    gain of sending the missing mass left or right, and which won."""
    g, h = hist[:, :-1, 0], hist[:, :-1, 1]
    gm = hist[:, -1:, 0]
    hm = hist[:, -1:, 1]
    gl = np.cumsum(g, axis=1)[:, :-1]
    hl = np.cumsum(h, axis=1)[:, :-1]
    gt = g.sum(axis=1, keepdims=True) + gm
    ht = h.sum(axis=1, keepdims=True) + hm
    parent = gt * gt / (ht + reg_lambda)

    def score(gl_, hl_):
        gr_, hr_ = gt - gl_, ht - hl_
        return (gl_ * gl_ / (hl_ + reg_lambda)
                + gr_ * gr_ / (hr_ + reg_lambda) - parent)

    gain_left = score(gl + gm, hl + hm)    # missing goes left
    gain_right = score(gl, hl)             # missing goes right
    return np.maximum(gain_left, gain_right), gain_left >= gain_right


# ------------------------------------------------------------- builders
def _as_tensor(a, device=None) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t if device is None else t.to(device)


def _plain_dtype(compute_dtype):
    """The plain builder sums exact float32 weights unless a compute dtype
    is asked for."""
    return torch.float32 if compute_dtype is None else compute_dtype


def build_local(bins, grad, hess, nbin: int, use_kernel: bool | None = None,
                compute_dtype=None) -> torch.Tensor:
    """Local (f, nbin, 2) histogram of (grad, hess) sums, on the device of
    ``bins`` ((n, f) integers; numpy means the CPU).

    ``use_kernel`` (default: the bins are a CUDA tensor) takes
    :func:`~rabit_tpu_torch.ops.histogram_kernel.hist_fused` with
    ``compute_dtype`` (default bfloat16); otherwise the plain version sums
    float32 weights (or ``compute_dtype``-rounded ones).  The JAX
    package's ``row_block``/``feat_block`` tuned its XLA builder and
    have no counterpart.
    """
    bins = _as_tensor(bins)
    grad = _as_tensor(grad, bins.device)
    hess = _as_tensor(hess, bins.device)
    if use_kernel is None:
        use_kernel = bins.is_cuda
    if use_kernel:
        kw = {} if compute_dtype is None else {"compute_dtype": compute_dtype}
        return hk.hist_fused(bins, grad, hess, nbin, **kw)
    out = hk._hist_plain(bins.T, torch.stack([grad, hess]), nbin,
                         _plain_dtype(compute_dtype))
    return out.permute(1, 2, 0)


def build_level_local(bins, grad, hess, node_of_row, node_ids,
                      nbin: int, bins_t=None, use_kernel: bool | None = None,
                      compute_dtype=None) -> torch.Tensor:
    """(m, f, nbin, 2) per-node histograms for one tree level.

    Every node of the level goes through one bins pass: the node masks
    are folded into a (2m, n) weight matrix on the device (grad channels,
    then hess channels), chunked by the kernel's channel budget
    (:func:`~rabit_tpu_torch.ops.histogram_kernel.max_channels`).
    ``bins_t`` supplies the resident transposed (f, n) device tensor (its
    device is where the level runs); without it ``bins`` is transposed
    here.  ``grad``, ``hess`` and ``node_of_row`` go up once per call.
    """
    if bins_t is None:
        bins_t = _as_tensor(bins).T
    dev = bins_t.device
    if use_kernel is None:
        use_kernel = bins_t.is_cuda
    g = _as_tensor(grad, dev)
    h = _as_tensor(hess, dev)
    nor = _as_tensor(np.asarray(node_of_row, np.int32), dev)
    nid = torch.as_tensor(np.asarray(node_ids, np.int32), device=dev)
    m = len(node_ids)
    chunk = max(1, hk.max_channels(nbin, bins_t.shape[0]) // 2)
    outs = []
    for lo in range(0, m, chunk):
        nids = nid[lo:lo + chunk]
        mc = len(nids)
        mask = (nor[None, :] == nids[:, None]).to(g.dtype)
        w = torch.cat([mask * g[None, :], mask * h[None, :]])
        if use_kernel:
            kw = ({} if compute_dtype is None
                  else {"compute_dtype": compute_dtype})
            out = hk.hist_fused_multi(bins_t, w, nbin, **kw)
        else:
            out = hk._hist_plain(bins_t, w, nbin,
                                 _plain_dtype(compute_dtype))
        outs.append(torch.stack([out[:mc], out[mc:]], dim=-1))
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def _host(t: torch.Tensor) -> np.ndarray:
    """The tensor as a C-contiguous numpy array on the host, for the
    in-place host allreduce."""
    return np.ascontiguousarray(t.detach().cpu().numpy())


def build_level_allreduce(bins, grad, hess, node_of_row, node_ids,
                          nbin: int, **kw) -> np.ndarray:
    """Global per-node level histograms: one local pass and ONE
    Allreduce<Sum> for the whole level.  Under the xla engine the
    level's tensor stays on its device and rides the device plane, as
    the k-means stats do; host engines take the fault-tolerant numpy
    path."""
    local = build_level_local(bins, grad, hess, node_of_row, node_ids,
                              nbin, **kw)
    if _engine_mod.is_device_plane():
        out = rabit_tpu_torch.allreduce(local.reshape(-1), SUM)
        return out.reshape(local.shape).cpu().numpy()
    local = _host(local)
    return rabit_tpu_torch.allreduce(local.reshape(-1), SUM).reshape(
        local.shape)


def build_allreduce(bins, grad, hess, nbin: int, **kw) -> np.ndarray:
    """Global histogram: local build and an Allreduce<Sum> of the flat
    payload (the XGBoost per-split wire pattern)."""
    local = _host(build_local(bins, grad, hess, nbin, **kw))
    return rabit_tpu_torch.allreduce(local.reshape(-1), SUM).reshape(
        local.shape)


class HistogramHandle:
    """Waitable result of :func:`build_allreduce_async`; ``wait()``
    returns the reduced (f, nbin, 2) histogram."""

    def __init__(self, handle, shape):
        self._handle = handle
        self._shape = shape

    def wait(self) -> np.ndarray:
        return np.asarray(self._handle.wait()).reshape(self._shape)


def build_allreduce_async(bins, grad, hess, nbin: int, fuse: bool = False,
                          **kw) -> HistogramHandle:
    """Async :func:`build_allreduce`: the flat histogram rides an engine
    handle so the caller can overlap other work with the wire (``fuse``
    as in :func:`rabit_tpu_torch.allreduce_async`)."""
    local = _host(build_local(bins, grad, hess, nbin, **kw))
    handle = rabit_tpu_torch.allreduce_async(local.reshape(-1), SUM,
                                             fuse=fuse)
    return HistogramHandle(handle, local.shape)
