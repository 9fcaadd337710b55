"""K-means cluster-statistics pass: CUDA kernels for Hopper and their
plain PyTorch versions.

Counterpart of :mod:`rabit_tpu.ops.kmeans_kernel`.  Both public
functions return the (k, d+1) float32 matrix of per-cluster row sums
with the counts in the last column, for cosine k-means: centroids are
L2-normalised (``+1e-12``) in float32 and rounded to the compute dtype,
each row goes to the first centroid of highest similarity, and sums and
counts accumulate in float32, weighted by the row's validity.

* :func:`kmeans_stats_fused` (dense rows) replaces the Pallas kernel
  ``rabit_tpu/ops/kmeans_kernel.py:_stats_kernel``;
* :func:`kmeans_ell_stats_fused` (padded-ELL rows) replaces
  ``rabit_tpu/ops/kmeans_kernel.py:_ell_stats_kernel``.

On a CUDA tensor each launches its kernel from ``csrc/kmeans_stats.cu``
(built at first use) or raises; on a CPU tensor it runs the plain
version (``_stats_plain``, ``_ell_stats_plain``), which is also what the
card's kernels are checked against.  ``LAUNCHES`` counts kernel launches.

What bounds the kernels on an H100, and what the design does about it,
is set out at the top of the CUDA source: the similarity runs as float32
FMAs on the CUDA cores, so they are bound by operations (and shared
memory bandwidth), while each input byte is read from device memory
once.  The TPU's layout padding (128-lane features, 16384-row tiles) is
not needed: the kernels mask their own ragged edges.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

LAUNCHES = {"kmeans_stats_dense": 0, "kmeans_stats_ell": 0}

_PLAIN_CHUNK_ROWS = 1 << 18
_TILE_ROWS = 32                   # rows per tile in the CUDA kernels
_SM_SMEM_BYTES = 233472           # shared memory of one H100 SM
_SMEM_PER_BLOCK_RESERVED = 1024
_MAX_BLOCKS_PER_SM = 8            # 2048 threads / 256 per block


def _as_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str) and isinstance(getattr(torch, dtype, None),
                                             torch.dtype):
        return getattr(torch, dtype)
    raise TypeError(f"not a torch dtype: {dtype!r}")


def _normalized(centroids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    c = centroids.float()
    return (c / (torch.linalg.norm(c, dim=1, keepdim=True) + 1e-12)).to(dtype)


# ---------------------------------------------------------------- plain
def _stats_core(cn: torch.Tensor, x: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    """float32 similarity → first-index argmax → masked one-hot → sums
    and counts, for one chunk of rows (all operands float32)."""
    assign = (x @ cn.T).argmax(dim=1)
    onehot = F.one_hot(assign, cn.shape[0]).float() * valid[:, None]
    return torch.cat([onehot.T @ x, onehot.sum(dim=0)[:, None]], dim=1)


def _stats_plain(cn: torch.Tensor, x: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Plain version of the dense kernel: ``cn`` (k, d) normalised and
    rounded to x's dtype; x's values enter exactly as float32."""
    k, d = cn.shape
    out = torch.zeros((k, d + 1), dtype=torch.float32, device=x.device)
    cnf = cn.float()
    for s in range(0, x.shape[0], _PLAIN_CHUNK_ROWS):
        e = s + _PLAIN_CHUNK_ROWS
        out += _stats_core(cnf, x[s:e].float(), valid[s:e].float())
    return out


def _ell_densify(idx: torch.Tensor, val: torch.Tensor, d: int,
                 dtype: torch.dtype) -> torch.Tensor:
    """(rows, d) float32 rows from ELL slots, rounded as the TPU kernel
    rounds them: each slot value to ``dtype``, then duplicates add in
    float32, then each sum to ``dtype``.  Indices outside [0, d) are
    pad slots and drop."""
    i = idx.long()
    i = torch.where((i >= 0) & (i < d), i, d)
    dense = torch.zeros((idx.shape[0], d + 1), dtype=torch.float32,
                        device=idx.device)
    dense.scatter_add_(1, i, val.to(dtype).float())
    return dense[:, :d].to(dtype).float()


def _ell_stats_plain(cn: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
                     valid: torch.Tensor, d: int) -> torch.Tensor:
    """Plain version of the ELL kernel: ``idx``/``val`` flat (n, nnz),
    ``cn`` (k, d) normalised and rounded to the compute dtype, to which
    every densified row is rounded too."""
    k = cn.shape[0]
    out = torch.zeros((k, d + 1), dtype=torch.float32, device=idx.device)
    cnf = cn.float()
    for s in range(0, idx.shape[0], _PLAIN_CHUNK_ROWS):
        e = s + _PLAIN_CHUNK_ROWS
        dense = _ell_densify(idx[s:e], val[s:e], d, cn.dtype)
        out += _stats_core(cnf, dense, valid[s:e].float())
    return out


# ----------------------------------------------------------------- CUDA
_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        from rabit_tpu_torch.ops import _build

        lib = _build.load("kmeans_stats")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kmeans_stats_dense.argtypes = [p, ll, i, p, ll, p, i, i, i, i,
                                           i, i, p, p, p]
        lib.kmeans_stats_dense.restype = i
        lib.kmeans_stats_ell.argtypes = [p, p, i, p, p, i, i, i, i, i, i,
                                         i, p, p, p]
        lib.kmeans_stats_ell.restype = i
        lib.kmeans_stats_smem_bytes.argtypes = [i, i, i]
        lib.kmeans_stats_smem_bytes.restype = i
        lib.kmeans_stats_max_dslice.argtypes = [i, i]
        lib.kmeans_stats_max_dslice.restype = i
        lib.kmeans_stats_error_string.argtypes = [i]
        lib.kmeans_stats_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def _plan(lib, device: torch.device, n: int, d: int, k: int):
    """(grid_x, ny, dslice): a persistent grid of a few blocks per SM,
    and the accumulator's column split when (k, d) does not fit beside
    the row tile in shared memory."""
    widest = lib.kmeans_stats_max_dslice(d, k)
    if widest < 1:
        raise ValueError(f"kmeans stats kernel: d={d}, k={k} does not fit "
                         "the 227 KB of shared memory of one block")
    ny = -(-d // widest)
    dslice = -(-d // ny)
    smem = lib.kmeans_stats_smem_bytes(d, k, dslice)
    per_sm = max(1, min(_MAX_BLOCKS_PER_SM,
                        _SM_SMEM_BYTES // (smem + _SMEM_PER_BLOCK_RESERVED)))
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid_x = max(1, min(-(-n // _TILE_ROWS), sms * per_sm))
    return grid_x, ny, dslice


def _check_launch(lib, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.kmeans_stats_error_string(err).decode()})")


def _dense_cuda(cn: torch.Tensor, x: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kmeans_stats_fused on CUDA takes float32 or "
                        f"bfloat16 rows, got {x.dtype}")
    if x.stride(1) != 1:
        x = x.contiguous()
    valid = valid.to(device=x.device, dtype=torch.float32)
    n, d = x.shape
    k = cn.shape[0]
    out = torch.empty((k, d + 1), dtype=torch.float32, device=x.device)
    if n == 0:
        return out.zero_()
    lib = _lib()
    grid_x, ny, dslice = _plan(lib, x.device, n, d, k)
    partial = torch.empty((grid_x, k, d + 1), dtype=torch.float32,
                          device=x.device)
    with torch.cuda.device(x.device):
        err = lib.kmeans_stats_dense(
            x.data_ptr(), x.stride(0), int(x.dtype == torch.bfloat16),
            valid.data_ptr(), valid.stride(0), cn.contiguous().data_ptr(),
            n, d, k, grid_x, ny, dslice, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, "kmeans_stats_dense")
    LAUNCHES["kmeans_stats_dense"] += 1
    return out


def _ell_cuda(cn: torch.Tensor, idx: torch.Tensor, val: torch.Tensor,
              valid: torch.Tensor, d: int) -> torch.Tensor:
    if cn.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kmeans_ell_stats_fused on CUDA computes in "
                        f"float32 or bfloat16, got {cn.dtype}")
    idx = idx.to(torch.int32).contiguous()
    val = val.contiguous()
    valid = valid.to(device=idx.device, dtype=torch.float32).contiguous()
    n, nnz = idx.shape
    k = cn.shape[0]
    out = torch.empty((k, d + 1), dtype=torch.float32, device=idx.device)
    if n == 0:
        return out.zero_()
    lib = _lib()
    grid_x, ny, dslice = _plan(lib, idx.device, n, d, k)
    partial = torch.empty((grid_x, k, d + 1), dtype=torch.float32,
                          device=idx.device)
    with torch.cuda.device(idx.device):
        err = lib.kmeans_stats_ell(
            idx.data_ptr(), val.data_ptr(), nnz, valid.data_ptr(),
            cn.contiguous().data_ptr(), int(cn.dtype == torch.bfloat16),
            n, d, k, grid_x, ny, dslice, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    _check_launch(lib, err, "kmeans_stats_ell")
    LAUNCHES["kmeans_stats_ell"] += 1
    return out


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kmeans stats: no kernel for device {t.device}")
    return t.device.type


# --------------------------------------------------------------- public
def kmeans_stats_fused(centroids: torch.Tensor, x: torch.Tensor,
                       valid: torch.Tensor,
                       block: int | None = None) -> torch.Tensor:
    """(k, d+1) stats matrix (counts in the last column) for dense rows.

    ``x`` is (n, d), rows with validity 0 arbitrary; ``valid`` (n,) 1/0.
    The similarity runs on x's values in x's dtype (float32 or bfloat16)
    against centroids rounded to it, accumulating in float32.  ``block``
    is accepted for the JAX package's signature; the kernel picks its
    own tiles.
    """
    k, d = centroids.shape
    if x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"x shape {tuple(x.shape)} does not match "
                         f"centroids dim {d}")
    if valid.shape != (x.shape[0],):
        raise ValueError(f"valid shape {tuple(valid.shape)} != "
                         f"({x.shape[0]},)")
    cdt = x.dtype if x.is_floating_point() else torch.float32
    x = x.to(cdt)
    cn = _normalized(centroids.to(x.device), cdt)
    if _route(x) == "cuda":
        return _dense_cuda(cn, x, valid)
    return _stats_plain(cn, x, valid)


def kmeans_ell_stats_fused(centroids: torch.Tensor, idx: torch.Tensor,
                           val: torch.Tensor, valid: torch.Tensor, d: int,
                           group: int = 4, hi: int = 128,
                           block: int = 2048,
                           compute_dtype=torch.bfloat16,
                           nnz: int | None = None) -> torch.Tensor:
    """(k, d+1) stats matrix straight from padded-ELL rows.

    ``idx``/``val`` are flat (n, nnz) ELL arrays (pad slots carry an
    index >= d, or value 0), or — when ``nnz`` is passed — grouped
    (n/G, G·nnz) arrays, which are the same memory.  Each row is
    densified in float32 (duplicate indices add), rounded to
    ``compute_dtype`` and put through the dense core.  ``group``, ``hi``
    and ``block`` keep the JAX package's signature and validation (the
    CUDA kernel needs neither the hi/lo split nor the row blocks).
    """
    k, dc = centroids.shape
    if dc != d:
        raise ValueError(f"centroids dim {dc} != d {d}")
    if nnz is None:
        n, nnz = idx.shape
    else:
        if idx.shape[1] != group * nnz:
            raise ValueError(f"grouped idx width {idx.shape[1]} != "
                             f"group*nnz = {group * nnz}")
        n = idx.shape[0] * group
    lo = d // hi
    if lo * hi != d:
        raise ValueError(f"d={d} not divisible by hi={hi}")
    if nnz & (nnz - 1) or hi & (hi - 1):
        raise ValueError(f"nnz={nnz} and hi={hi} must be powers of two "
                         "(the kernel splits indices with shifts)")
    if n % block or block % group:
        raise ValueError(f"n={n} must divide into block={block} "
                         f"(multiple of group={group})")
    if valid.shape != (n,):
        raise ValueError(f"valid shape {tuple(valid.shape)} != ({n},)")
    cdt = _as_dtype(compute_dtype)
    cn = _normalized(centroids.to(idx.device), cdt)
    idx = idx.reshape(n, nnz)
    val = val.reshape(n, nnz).float()
    if _route(idx) == "cuda":
        return _ell_cuda(cn, idx, val, valid, d)
    return _ell_stats_plain(cn, idx, val, valid, d)
