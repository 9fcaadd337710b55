"""Ring allreduce over logical ranks: a CUDA kernel for Hopper and its
plain PyTorch versions.

Counterpart of :mod:`rabit_tpu.ops.ring_allreduce`, whose Pallas kernel
``_ring_kernel`` (wrapper ``ring_allreduce_pallas``) runs ``ndev - 1``
reduce-scatter hops and ``ndev - 1`` all-gather hops by remote DMA
between chips.  Here a rank is one tensor of a list: every rank's tensor
lies on one device, and :func:`ring_allreduce_p2p` returns each rank's
reduced tensor.  The name says that it is not Pallas.

On one card the ring's hops are pure overhead: its result is fixed by
the chunk each element falls in (:func:`pallas_chunk`), and the kernel in
``csrc/ring_allreduce.cu`` computes it in one pass that reads every
rank's element once, folds in the ring's order and writes the result to
every rank (:func:`_ring_fold_plain` is that order in PyTorch).  Both
give ``ring_allreduce_pallas``'s bits.  On a CUDA tensor the wrapper
launches the kernel or raises; on a CPU tensor it runs :func:`_ring_plain`
(the hops themselves), which is also what the card's kernel is checked
against.  ``LAUNCHES`` counts kernel launches.

Ranks that are processes (on one card or several) go through
:mod:`rabit_tpu_torch.parallel.peer_ring`, which calls this module's
entry for one rank, :func:`ring_allreduce_peer`: the same fold over a
table of raw pointers (the rank's own inbox and its peers', opened from
their CUDA IPC handles) into that rank's one output row.  The inboxes
and their handles are this module's too (:func:`inbox_alloc`,
:func:`ipc_get`, :func:`ipc_open`, ...), each a call into the same
library that raises when CUDA refuses it, naming the call: a
:class:`PeerError` where a peer's handle cannot be opened or closed (a
gone peer's doing), a plain ``RuntimeError`` for every other call (an
allocation, this rank's own handle, a copy), which no caller may take
for a peer's failure.  A list of tensors on several devices still
raises ``NotImplementedError`` in :func:`ring_allreduce_p2p`.
"""
from __future__ import annotations

import ctypes

import torch

from rabit_tpu_torch.ops.reduce_ops import ReduceOp, apply_op_pairwise

LAUNCHES = {"ring_allreduce": 0}


class PeerError(RuntimeError):
    """A failure of ranks in several processes that a peer caused: the
    start barrier given up on a late or gone peer, or a peer's IPC handle
    that cannot be opened or closed.  The device-plane engine degrades on
    it; on nothing else that this module raises."""


_SUPPORTED = frozenset({ReduceOp.SUM, ReduceOp.MAX, ReduceOp.MIN,
                        ReduceOp.PROD})
# ring_allreduce_pallas segments its payload to fit this VMEM budget; the
# segmenting moves elements between chunks, so it is kept for the layout
_VMEM_BUDGET_BYTES = 8 << 20
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int32: 2}
_VECTOR_BYTES = 16                # the kernel's loads and stores


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
            "are processes of their own and go through "
            "rabit_tpu_torch.parallel.peer_ring (ROADMAP.md A7)")


def _ring_plain(xs, op=ReduceOp.SUM):
    """Plain version: the layout of :func:`pallas_chunk` and the hops of
    :func:`ring_hops`; a list of each rank's result in the input's
    shape."""
    n, shape, size = len(xs), xs[0].shape, xs[0].numel()
    chunk = pallas_chunk(size, n, xs[0].element_size())
    bufs = torch.zeros((n, n * chunk), dtype=xs[0].dtype,
                       device=xs[0].device)     # each rank's payload, padded
    for r, x in enumerate(xs):
        bufs[r, :size].copy_(x.reshape(-1))
    ring_hops(bufs.view(n, n, chunk), op)
    return [bufs[r, :size].view(shape) for r in range(n)]


def _ring_fold_plain(xs, op=ReduceOp.SUM):
    """The kernel's order in plain PyTorch: element ``p`` of chunk
    ``c = p // chunk`` is ``x_c``, then ``combine(x_{(c+j) % n}, acc)``
    for ``j = 1 .. n-1``; a list of each rank's result in the input's
    shape.  It gives :func:`_ring_plain`'s bits (the CPU tests hold the
    two together)."""
    n, shape, size = len(xs), xs[0].shape, xs[0].numel()
    out = ring_fold_one(xs, op).expand(n, size).clone()
    return [out[r].view(shape) for r in range(n)]


def ring_fold_one(xs, op=ReduceOp.SUM) -> torch.Tensor:
    """:func:`_ring_fold_plain`'s result for one rank: a new flat tensor
    of ``xs[0].numel()`` elements (the CPU version of
    :func:`ring_allreduce_peer`)."""
    n, size = len(xs), xs[0].numel()
    chunk = pallas_chunk(size, n, xs[0].element_size())
    flat = torch.stack([x.reshape(-1) for x in xs])
    p = torch.arange(size, device=flat.device)
    c = p // chunk
    acc = flat[c, p]
    for j in range(1, n):
        acc = apply_op_pairwise(op, flat[(c + j) % n, p], acc)
    return acc


# ----------------------------------------------------------------- CUDA
_LIB = None
_MAX_RANKS = 0                         # the kernel's table, read from _LIB
_SMS: dict[int, int] = {}              # SM count by CUDA device index


def _lib() -> ctypes.CDLL:
    global _LIB, _MAX_RANKS
    if _LIB is None:
        from rabit_tpu_torch.ops import _build

        lib = _build.load("ring_allreduce")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.ring_allreduce.argtypes = [ctypes.POINTER(ll), i, ll, ll, i, i,
                                       i, p, ll, i, p]
        lib.ring_allreduce.restype = i
        lib.ring_allreduce_peer.argtypes = [ctypes.POINTER(ll), i, ll, ll, i,
                                            i, i, p, i, p]
        lib.ring_allreduce_peer.restype = i
        lib.ring_allreduce_max_ranks.restype = i
        lib.ring_ipc_handle_bytes.restype = i
        for name, args in (("ring_inbox_alloc", [ll, ctypes.POINTER(ll)]),
                           ("ring_inbox_free", [ll]),
                           ("ring_ipc_get", [ll, ctypes.c_char_p]),
                           ("ring_ipc_open", [ctypes.c_char_p,
                                              ctypes.POINTER(ll)]),
                           ("ring_ipc_close", [ll]),
                           ("ring_copy", [ll, ll, ll, p])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        _MAX_RANKS = lib.ring_allreduce_max_ranks()
        lib.ring_allreduce_error_string.argtypes = [i]
        lib.ring_allreduce_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _sms(device: int) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _ring_cuda(xs, op):
    """Launch the fold kernel.  At the data plane's payloads the host's
    work per call, not the kernel, is the cost, so this path does little
    besides one allocation and one ctypes call."""
    x0 = xs[0]
    dtype = x0.dtype
    code = _DTYPE_CODES.get(dtype)
    if code is None:
        raise TypeError(f"ring_allreduce_p2p on CUDA takes float32, "
                        f"bfloat16 or int32, got {dtype}")
    lib = _lib()
    n, shape, size = len(xs), x0.shape, x0.numel()
    if n > _MAX_RANKS:
        raise ValueError(f"ring_allreduce_p2p: {n} ranks, the kernel takes "
                         f"at most {_MAX_RANKS}")
    xs = [x if x.is_contiguous() else x.contiguous() for x in xs]
    ptrs = [x.data_ptr() for x in xs]
    itemsize = x0.element_size()
    per_vec = _VECTOR_BYTES // itemsize
    ld = -(-size // per_vec) * per_vec    # 16-byte aligned output rows
    out = torch.empty((n, ld), dtype=dtype, device=x0.device)
    device = out.device.index
    with torch.cuda.device(device):
        err = lib.ring_allreduce(
            (ctypes.c_longlong * n)(*ptrs), n, size,
            pallas_chunk(size, n, itemsize),
            not any(q % _VECTOR_BYTES for q in ptrs), code, int(op),
            out.data_ptr(), ld, _sms(device),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_allreduce launch failed: CUDA error {err} "
                           f"({lib.ring_allreduce_error_string(err).decode()})")
    LAUNCHES["ring_allreduce"] += 1
    rows = (out if ld == size else out.narrow(1, 0, size)).unbind(0)
    return list(rows) if len(shape) == 1 else [r.view(shape) for r in rows]


def _cuda_call(call: str, err: int, peer: bool = False) -> None:
    """Raise for a CUDA error ``err`` of ``call``: a :class:`PeerError`
    where ``peer`` (the call was on a peer's handle), else a plain
    ``RuntimeError``."""
    if err != 0:
        raise (PeerError if peer else RuntimeError)(
            f"{call} failed: CUDA error {err} "
            f"({_lib().ring_allreduce_error_string(err).decode()})")


def inbox_alloc(nbytes: int) -> int:
    """A new inbox of ``nbytes`` on the current CUDA device, by
    ``cudaMalloc`` (never a block of PyTorch's caching allocator, whose
    IPC handle would name the block's base); its device pointer."""
    ptr = ctypes.c_longlong(0)
    _cuda_call("cudaMalloc", _lib().ring_inbox_alloc(nbytes,
                                                     ctypes.byref(ptr)))
    return ptr.value


def inbox_free(ptr: int) -> None:
    _cuda_call("cudaFree", _lib().ring_inbox_free(ptr))


def ipc_get(ptr: int) -> bytes:
    """The CUDA IPC handle of the inbox at ``ptr``."""
    buf = ctypes.create_string_buffer(_lib().ring_ipc_handle_bytes())
    _cuda_call("cudaIpcGetMemHandle", _lib().ring_ipc_get(ptr, buf))
    return buf.raw


def ipc_open(handle: bytes) -> int:
    """A peer's inbox in this process, from its IPC handle (with lazy
    peer access, for a peer on another card)."""
    ptr = ctypes.c_longlong(0)
    _cuda_call("cudaIpcOpenMemHandle",
               _lib().ring_ipc_open(handle, ctypes.byref(ptr)), peer=True)
    return ptr.value


def ipc_close(ptr: int) -> None:
    _cuda_call("cudaIpcCloseMemHandle", _lib().ring_ipc_close(ptr),
               peer=True)


def inbox_copy(dst: int, src: torch.Tensor) -> None:
    """Copy the contiguous CUDA tensor ``src`` into the inbox at ``dst``
    on the current stream (the caller waits for it)."""
    stream = torch.cuda.current_stream(src.device).cuda_stream
    _cuda_call("cudaMemcpyAsync", _lib().ring_copy(
        dst, src.data_ptr(), src.numel() * src.element_size(), stream))


def ring_allreduce_peer(ptrs, size: int, op, out: torch.Tensor) -> None:
    """One rank of ranks in several processes: fold the ``size`` elements
    at each of ``ptrs`` (every rank's inbox in rank order, raw device
    pointers readable from this process) in the ring's order into
    ``out``, a contiguous CUDA tensor of ``size`` elements whose dtype is
    the inputs'.  Launches on the current stream and returns without
    waiting; raises before any launch for what the kernel cannot take."""
    op = ReduceOp(op)
    if op not in _SUPPORTED:
        raise ValueError(f"ring_allreduce_peer: unsupported op {op}")
    code = _DTYPE_CODES.get(out.dtype)
    if code is None:
        raise TypeError(f"ring_allreduce_peer takes float32, bfloat16 or "
                        f"int32, got {out.dtype}")
    if out.device.type != "cuda" or not out.is_contiguous() or \
            out.numel() != size or size < 1:
        raise ValueError(f"ring_allreduce_peer: out must be a contiguous "
                         f"CUDA tensor of {size} elements, got "
                         f"{tuple(out.shape)} on {out.device}")
    lib = _lib()
    n = len(ptrs)
    if not 2 <= n <= _MAX_RANKS:
        raise ValueError(f"ring_allreduce_peer: {n} ranks, the kernel takes "
                         f"2 to {_MAX_RANKS}")
    device = out.device.index
    vectors = not any(q % _VECTOR_BYTES for q in (*ptrs, out.data_ptr()))
    with torch.cuda.device(device):
        err = lib.ring_allreduce_peer(
            (ctypes.c_longlong * n)(*ptrs), n, size,
            pallas_chunk(size, n, out.element_size()), vectors, code,
            int(op), out.data_ptr(), _sms(device),
            torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ring_allreduce_peer launch failed: CUDA error "
                           f"{err} ({lib.ring_allreduce_error_string(err).decode()})")
    LAUNCHES["ring_allreduce"] += 1


# --------------------------------------------------------------- public
def ring_allreduce_p2p(xs, op=ReduceOp.SUM):
    """Allreduce a list of per-rank tensors (same shape and dtype, one
    device) along the ring; returns each rank's result in the input's
    shape, or ``xs`` itself for one rank.

    The counterpart of ``ring_allreduce_pallas``, bit for bit: the same
    128-aligned, segment-rounded chunks and the same combine order.  On
    the card the results are views of one new ``(ndev, size)`` buffer
    (rows padded to 16 bytes), the inputs are left as they are, and the
    call returns without waiting for the kernel.
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
