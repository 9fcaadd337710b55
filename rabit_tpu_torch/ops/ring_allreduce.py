"""Ring allreduce over logical ranks: a CUDA kernel for Hopper and its
plain PyTorch version.

Counterpart of :mod:`rabit_tpu.ops.ring_allreduce`, whose Pallas kernel
``_ring_kernel`` (wrapper ``ring_allreduce_pallas``) runs ``ndev - 1``
reduce-scatter hops and ``ndev - 1`` all-gather hops by remote DMA
between chips.  Here a rank is one tensor of a list: every rank's tensor
lies on one device, and :func:`ring_allreduce_p2p` returns each rank's
reduced tensor.  The name says that it is not Pallas: the kernel in
``csrc/ring_allreduce.cu`` reads its neighbour's buffer through a table
of peer pointers, one cooperative launch holding every rank.

Both versions lay the payload out as ``ring_allreduce_pallas`` does
(:func:`pallas_chunk`) and combine ``combine(mine, incoming)`` in hop
order, so they give its bits: an element's combine order depends only on
the chunk it falls in.  On a CUDA tensor the wrapper launches the kernel
or raises; on a CPU tensor it runs :func:`_ring_plain`, which is also
what the card's kernel is checked against.  ``LAUNCHES`` counts kernel
launches.

Ranks on more than one device (several cards) are not ported yet
(ROADMAP.md): they raise ``NotImplementedError``.
"""
from __future__ import annotations

import ctypes

import torch

from rabit_tpu_torch.ops.reduce_ops import ReduceOp, apply_op_pairwise

LAUNCHES = {"ring_allreduce": 0}

_SUPPORTED = frozenset({ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN,
                        ReduceOp.PROD})
# ring_allreduce_pallas segments its payload to fit this VMEM budget; the
# segmenting moves elements between chunks, so it is kept for the layout
_VMEM_BUDGET_BYTES = 8 << 20
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
# a wait in the kernel gives up after this many SM clock cycles (~1 s)
_SPIN_BUDGET_CYCLES = 1 << 31
_LAUNCH_STRIDE = 128              # > the 2(ndev-1) hops of any launch


def supported_ops():
    """Ops the ring can combine."""
    return _SUPPORTED


def pallas_chunk(size: int, ndev: int, itemsize: int) -> int:
    """Elements of one ring chunk as ``ring_allreduce_pallas`` lays out a
    flat payload of ``size`` elements: 128-aligned chunks of
    ``ceil(size / ndev)``, rounded up by its 8 MB segmenting.  Element
    ``p`` of the padded ``(ndev * chunk,)`` payload falls in chunk
    ``p // chunk``."""
    chunk = max(128, -(-size // ndev))
    chunk = -(-chunk // 128) * 128
    bytes_per = ndev * chunk * itemsize
    nseg = max(1, -(-2 * bytes_per // _VMEM_BUDGET_BYTES))
    seg_chunk = -(-chunk // (128 * nseg)) * 128
    nseg = -(-chunk // seg_chunk)
    return nseg * seg_chunk


def ring_hops(chunks: torch.Tensor, op) -> torch.Tensor:
    """The ring on ``chunks`` (ndev ranks, ndev chunks, chunk), in place:
    at reduce-scatter hop ``s`` rank ``r`` folds its left neighbour's
    chunk ``r - 1 - s`` into its own with ``combine(mine, incoming)``,
    then at all-gather hop ``s`` copies the left's chunk ``r - s``."""
    n = chunks.shape[0]
    ranks = torch.arange(n, device=chunks.device)
    left = (ranks - 1) % n
    for s in range(n - 1):
        recv = (ranks - s - 1) % n
        chunks[ranks, recv] = apply_op_pairwise(op, chunks[ranks, recv],
                                                chunks[left, recv])
    for s in range(n - 1):
        recv = (ranks - s) % n
        chunks[ranks, recv] = chunks[left, recv]
    return chunks


def stage(xs, chunk: int) -> torch.Tensor:
    """(ndev, ndev * chunk) buffer: rank r's flat payload, zero padded."""
    n, size = len(xs), xs[0].numel()
    bufs = torch.empty((n, n * chunk), dtype=xs[0].dtype,
                       device=xs[0].device)
    bufs[:, size:].zero_()
    for r, x in enumerate(xs):
        bufs[r, :size].copy_(x.reshape(-1))
    return bufs


def _check_ranks(xs, op) -> None:
    if op not in _SUPPORTED:
        raise ValueError(f"ring_allreduce_p2p: unsupported op {op}")
    if not xs:
        raise ValueError("ring_allreduce_p2p: no ranks")
    x0 = xs[0]
    for x in xs[1:]:
        if x.shape != x0.shape or x.dtype != x0.dtype:
            raise ValueError(f"ring_allreduce_p2p: rank tensors differ: "
                             f"{tuple(x.shape)} {x.dtype} vs "
                             f"{tuple(x0.shape)} {x0.dtype}")
    devices = {x.device for x in xs}
    if len(devices) > 1:
        raise NotImplementedError(
            f"ring_allreduce_p2p: ranks on {len(devices)} devices "
            f"({sorted(map(str, devices))}); ranks on more than one device "
            "are not ported yet (ROADMAP.md A)")


def _ring_plain(xs, op=ReduceOp.SUM):
    """Plain version: the layout of :func:`pallas_chunk` and the hops of
    :func:`ring_hops`; a list of each rank's result in the input's
    shape."""
    n, shape, size = len(xs), xs[0].shape, xs[0].numel()
    chunk = pallas_chunk(size, n, xs[0].element_size())
    bufs = stage(xs, chunk)
    ring_hops(bufs.view(n, n, chunk), op)
    return [bufs[r, :size].view(shape) for r in range(n)]


# ----------------------------------------------------------------- CUDA
_LIB = None


class _CardState:
    """One card's progress words (a row of columns per rank), error word
    and launch count.  A launch's words run from ``launches * stride``
    up, so words left by an earlier launch never satisfy a later wait and
    are never reset."""

    def __init__(self, lib, device: torch.device):
        words = lib.ring_allreduce_max_ranks() * lib.ring_allreduce_max_cols()
        self.flags = torch.zeros(words, dtype=torch.int64, device=device)
        self.err = torch.zeros(1, dtype=torch.int32, device=device)
        self.launches = 0


_STATE: dict[int, _CardState] = {}     # by CUDA device index


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from rabit_tpu_torch.ops import _build

        lib = _build.load("ring_allreduce")
        p, i, ll, ull = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                         ctypes.c_ulonglong)
        lib.ring_allreduce.argtypes = [ctypes.POINTER(ll),
                                       ctypes.POINTER(ll), i, ll, i, i, ull,
                                       ll, p, p]
        lib.ring_allreduce.restype = i
        lib.ring_allreduce_max_ranks.restype = i
        lib.ring_allreduce_max_cols.restype = i
        lib.ring_allreduce_error_string.argtypes = [i]
        lib.ring_allreduce_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _state(lib, device: torch.device) -> _CardState:
    key = device.index if device.index is not None \
        else torch.cuda.current_device()
    if key not in _STATE:
        _STATE[key] = _CardState(lib, device)
    return _STATE[key]


def _ring_cuda(xs, op):
    dtype = xs[0].dtype
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"ring_allreduce_p2p on CUDA takes float32, "
                        f"bfloat16 or int32, got {dtype}")
    lib = _lib()
    n, shape, size = len(xs), xs[0].shape, xs[0].numel()
    if n > lib.ring_allreduce_max_ranks():
        raise ValueError(f"ring_allreduce_p2p: {n} ranks, the kernel takes "
                         f"at most {lib.ring_allreduce_max_ranks()}")
    device = xs[0].device
    chunk = pallas_chunk(size, n, xs[0].element_size())
    bufs = stage(xs, chunk)
    st = _state(lib, device)
    st.launches += 1
    cols = lib.ring_allreduce_max_cols()
    bases = (ctypes.c_longlong * n)(*[bufs[r].data_ptr() for r in range(n)])
    words = (ctypes.c_longlong * n)(
        *[st.flags.data_ptr() + 8 * r * cols for r in range(n)])
    with torch.cuda.device(device):
        code = lib.ring_allreduce(
            bases, words, n, chunk, _DTYPE_CODES[dtype], int(op),
            st.launches * _LAUNCH_STRIDE, _SPIN_BUDGET_CYCLES,
            st.err.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"ring_allreduce launch failed: CUDA error {code} "
                           f"({lib.ring_allreduce_error_string(code).decode()})")
    LAUNCHES["ring_allreduce"] += 1
    if int(st.err.item()) != 0:       # waits for the kernel
        st.err.zero_()
        raise RuntimeError("ring_allreduce: a rank waited past its spin "
                           "budget for its left neighbour; the result is "
                           "undefined")
    return [bufs[r, :size].view(shape) for r in range(n)]


# --------------------------------------------------------------- public
def ring_allreduce_p2p(xs, op=ReduceOp.SUM):
    """Allreduce a list of per-rank tensors (same shape and dtype, one
    device) along the ring; returns each rank's result in the input's
    shape, or ``xs`` itself for one rank.

    The counterpart of ``ring_allreduce_pallas``, bit for bit: the same
    128-aligned, segment-rounded chunks and the same combine order.  On
    the card the call waits for the kernel, so that a rank that never
    hears from its neighbour raises here.
    """
    xs = list(xs)
    op = ReduceOp(op)
    _check_ranks(xs, op)
    if len(xs) == 1:
        return xs
    if xs[0].device.type == "cuda":
        return _ring_cuda(xs, op)
    if xs[0].device.type != "cpu":
        raise ValueError(f"ring_allreduce_p2p: no kernel for device "
                         f"{xs[0].device}")
    return _ring_plain(xs, op)
