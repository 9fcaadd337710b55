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
  ``rabit_tpu/ops/kmeans_kernel.py:_ell_stats_kernel``;
* :func:`kmeans_stats_variant` runs the dense pass with another
  classify stage, one of :data:`VARIANTS`: the B1 variant study of
  ``tools/kernel_experiments.py`` (its ``pl.pallas_call`` at :138 and
  :157), whose modes replace that kernel's argmax stage and keep every
  other line.

On a CUDA tensor each launches its kernel (the dense one from
``csrc/kmeans_stats_dense.cu``, the variants from
``csrc/kmeans_stats_variant.cu``, the ELL one from
``csrc/kmeans_ell_stats.cu``, built at first use) or raises; on a CPU
tensor it runs the plain version (``_stats_plain``, ``_variant_plain``,
``_ell_stats_plain``), which is also what the card's kernels are checked
against.  :func:`_dense_plan` and :func:`_variant_plan` size the dense
and variant kernels' launches in Python, so the CPU tests reach their
limits.  ``_ell_stats_sparse_plain`` mirrors the ELL kernel's sparse
arithmetic (merge, gather-similarity, argmax, ``index_add_``) and
``_variant_blocked_plain`` the variant kernel's grouping (tiles dealt to
blocks, per-block partials and keep-alive sums) for the CPU tests;
nothing on the CUDA route calls them.  ``LAUNCHES`` counts kernel
launches.  ``_lib`` and ``_plan`` load and plan the previous dense kernel
(``csrc/kmeans_stats.cu``), which only ``tools/stats_ab.py`` runs.

What bounds the kernels on an H100, and what the design does about it,
is set out at the top of each CUDA source: the dense kernel classifies
(bf16 similarity on the tensor cores, float32 on the CUDA cores) and
then folds in a second pass, so it is bound by two reads of x; the
variants' kernel reads each row tile once and runs both of its products
on it from shared memory (bf16 on the tensor cores), bound by that one
read; the ELL kernel works on each row's nonzeros alone and is bound by
the single read of its slots.  The TPU's layout padding (128-lane
features, 16384-row tiles) is not needed: the kernels mask their own
ragged edges.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from rabit_tpu_torch.ops.reduce_ops import as_torch_dtype

# the classify stages of the variant study, in the CUDA source's order
VARIANTS = ("argmax", "maxcmp", "simonly", "novalid", "argmaxT", "simonlyT",
            "cheapassignT")
_KEEP_ALIVE = ("simonlyT", "cheapassignT")

LAUNCHES = {"kmeans_stats_dense": 0, "kmeans_stats_ell": 0,
            **{f"p1_{m}": 0 for m in VARIANTS}}

_PLAIN_CHUNK_ROWS = 1 << 18
_SPARSE_PLAIN_CHUNK_ROWS = 1 << 12
_TILE_ROWS = 32                   # rows a tile in the previous dense kernel
_SM_SMEM_BYTES = 233472           # shared memory of one H100 SM
_SMEM_PER_BLOCK_RESERVED = 1024
_MAX_BLOCKS_PER_SM = 8            # 2048 threads / its 256 a block
_MAX_SM_THREADS = 2048
_MAX_RESIDENT_BLOCKS = 32         # blocks resident on one SM
_ELL_WARPS = 32                   # warps in the ELL kernel's block
_ELL_ROWS_PER_WARP = (4, 2, 1)    # rows a warp takes per row group
_ELL_CLUSTER_CHUNK = 64           # its centroid columns pad to this
# the dense kernel (csrc/kmeans_stats_dense.cu), whose constants these
# restate: classify blocks of 128 rows against chunks of 64 centroids and
# 64 features; fold blocks of column tiles up to 256 wide, 4 columns a
# thread (1 where k leaves tiles narrower than 4), + the counts warp, that
# stage 256 rows' assignments at a time
_DENSE_BLOCK_ROWS = 128
_DENSE_CHUNK = 64
_DENSE_FOLD_MAX_COLS = 256        # widest column tile
_DENSE_FOLD_VEC = 4               # columns a fold thread owns, dt % 4 == 0
_DENSE_FOLD_BATCH = 256
_DENSE_MAX_SMEM = 232448          # 227 KB a block on sm_90
_DENSE_PARTIAL_CAP = 256 << 20    # bytes of per-chunk partial sums
_DENSE_FOLD_WAVES = 2             # fold blocks: this many per resident slot
# the fold holds k*dt + k floats and 256 (assign, valid) pairs: dt=1 gives
# the largest k
DENSE_MAX_K = (_DENSE_MAX_SMEM - 8 * _DENSE_FOLD_BATCH) // 8
# the variant kernel (csrc/kmeans_stats_variant.cu), whose constants these
# restate: 256 threads walk tiles of 64 rows in chunks of 64 features, up
# to 4 chunks in flight; centroid columns pad to a power of two in [32,
# 128]; the (kp, ds) sums accumulator is 16384 float32 registers a block;
# shared-memory regions start on 128 bytes; column slices lie on the
# grid's y axis
_VAR_ROWS = 64
_VAR_CHUNK = 64
_VAR_THREADS = 256
_VAR_MIN_KP = 32
VARIANT_MAX_K = 128
_VAR_ACC = 16384
_VAR_MAX_PREFETCH = 4
_VAR_SIM_PAD = 4
_VAR_ALIGN = 128
VARIANT_MAX_SLICES = 65535


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


def _ell_merge(idx: torch.Tensor, val: torch.Tensor, d: int,
               dtype: torch.dtype):
    """Each row's nonzeros as the ELL kernel merges them: ``(cols,
    vals)``, both (rows, nnz).  The first slot of each index in [0, d)
    keeps its index and the float32 sum, in slot order, of its
    duplicates' values rounded to ``dtype``, itself rounded to
    ``dtype``; every other slot gets index -1 and value 0."""
    i = idx.long()
    live = (i >= 0) & (i < d)
    v = val.to(dtype).float()
    nnz = idx.shape[1]
    same = (i[:, :, None] == i[:, None, :]) & live[:, :, None]
    earlier = torch.ones(nnz, nnz, dtype=torch.bool,
                         device=idx.device).tril(-1)
    first = live & ~(same & earlier).any(dim=2)
    later = ~earlier                        # slot j >= slot s
    merged = torch.zeros_like(v)
    for j in range(nnz):
        take = same[:, :, j] & later[:, j]
        merged = torch.where(take, merged + v[:, j:j + 1], merged)
    merged = torch.where(first, merged.to(dtype).float(), 0.0)
    return torch.where(first, i, -1), merged


def _ell_stats_sparse_plain(cn: torch.Tensor, idx: torch.Tensor,
                            val: torch.Tensor, valid: torch.Tensor,
                            d: int) -> torch.Tensor:
    """Plain mirror of the ELL kernel's sparse arithmetic: merge each
    row's slots (:func:`_ell_merge`), score every centroid over the
    merged nonzeros alone, take the first index of the maximum, and
    ``index_add_`` the nonzeros (times validity) and the validity into
    the assigned cluster.  ``cn`` (k, d) normalised and rounded to the
    compute dtype, as for :func:`_ell_stats_plain`."""
    k = cn.shape[0]
    cnt = cn.float().T.contiguous()          # (d, k): one row per feature
    sums = torch.zeros(k * d, dtype=torch.float32, device=idx.device)
    counts = torch.zeros(k, dtype=torch.float32, device=idx.device)
    for s in range(0, idx.shape[0], _SPARSE_PLAIN_CHUNK_ROWS):
        e = s + _SPARSE_PLAIN_CHUNK_ROWS
        cols, vals = _ell_merge(idx[s:e], val[s:e], d, cn.dtype)
        keep = cols >= 0
        sim = torch.zeros((cols.shape[0], k), dtype=torch.float32,
                          device=idx.device)
        for j in range(cols.shape[1]):
            sim += vals[:, j:j + 1] * cnt[cols[:, j].clamp(min=0)]
        assign = sim.argmax(dim=1)
        w = valid[s:e].float()
        flat = (assign[:, None] * d + cols)[keep]
        sums.index_add_(0, flat, (w[:, None] * vals)[keep])
        counts.index_add_(0, assign, w)
    return torch.cat([sums.view(k, d), counts[:, None]], dim=1)


def _variant_core(cnf: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                  mode: str, block: int, row0: int,
                  cdt: torch.dtype) -> torch.Tensor:
    """One chunk of rows (starting at row ``row0``) through classify
    stage ``mode``, as the JAX tool's kernel bodies compute it: the
    one-hot (or weights) rounded to the compute dtype for the sums
    product, unrounded for the counts, and the keep-alive anchor
    ``sum sim[:, 0]`` added to every count."""
    k = cnf.shape[0]
    sim = x @ cnf.T
    if mode == "maxcmp":
        w = (sim >= sim.amax(dim=1, keepdim=True)).float()
    elif mode == "simonly":
        w = sim.clamp(0.0, 1.0)
    elif mode == "simonlyT":
        w = valid[:, None].expand(-1, k)
    else:
        if mode == "cheapassignT":
            rows = torch.arange(row0, row0 + x.shape[0], device=x.device)
            assign = (rows % block) % k
        else:
            assign = sim.argmax(dim=1)
        w = F.one_hot(assign, k).float()
    if mode not in ("novalid", "simonlyT"):
        w = w * valid[:, None]
    counts = w.sum(dim=0)
    if mode in _KEEP_ALIVE:
        counts = counts + sim[:, 0].sum()
    sums = w.to(cdt).float().T @ x
    return torch.cat([sums, counts[:, None]], dim=1)


def _variant_plain(cn: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                   mode: str, block: int) -> torch.Tensor:
    """Plain version of :func:`kmeans_stats_variant`: ``cn`` normalised
    and rounded to x's dtype, as for :func:`_stats_plain`."""
    k, d = cn.shape
    out = torch.zeros((k, d + 1), dtype=torch.float32, device=x.device)
    cnf = cn.float()
    for s in range(0, x.shape[0], _PLAIN_CHUNK_ROWS):
        e = s + _PLAIN_CHUNK_ROWS
        out += _variant_core(cnf, x[s:e].float(), valid[s:e].float(), mode,
                             block, s, cn.dtype)
    return out


def _variant_blocked_plain(cn: torch.Tensor, x: torch.Tensor,
                           valid: torch.Tensor, mode: str, block: int,
                           grid: int) -> torch.Tensor:
    """Plain mirror of the variant kernel's grouping, for the CPU tests:
    tiles of 64 rows dealt to ``grid`` blocks in turn; a block adds up its
    tiles' stats in order, each tile with its own keep-alive sum for
    ``simonlyT`` and ``cheapassignT``; the block partials are summed in
    block order.  Arguments as for :func:`_variant_plain`."""
    k, d = cn.shape
    cnf = cn.float()
    out = torch.zeros((k, d + 1), dtype=torch.float32, device=x.device)
    for b in range(grid):
        part = torch.zeros_like(out)
        for s in range(b * _VAR_ROWS, x.shape[0], grid * _VAR_ROWS):
            e = s + _VAR_ROWS
            part += _variant_core(cnf, x[s:e].float(), valid[s:e].float(),
                                  mode, block, s, cn.dtype)
        out += part
    return out


# ----------------------------------------------------------------- CUDA
_LIB = None


def _bind_previous(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the exports of the previous dense kernel's library
    (``csrc/kmeans_stats.cu``, or another source with its interface)."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.kmeans_stats_dense.argtypes = [p, ll, i, p, ll, p, i, i, i, i, i, i,
                                       p, p, p]
    lib.kmeans_stats_dense.restype = i
    lib.kmeans_stats_smem_bytes.argtypes = [i, i, i]
    lib.kmeans_stats_smem_bytes.restype = i
    lib.kmeans_stats_max_dslice.argtypes = [i, i]
    lib.kmeans_stats_max_dslice.restype = i
    return lib


def _lib() -> ctypes.CDLL:
    """The previous dense kernel, ``csrc/kmeans_stats.cu``: what
    ``tools/stats_ab.py`` holds B1 against by default."""
    global _LIB
    if _LIB is None:
        from rabit_tpu_torch.ops import _build

        _LIB = _bind_previous(_build.load("kmeans_stats"))
    return _LIB


def _plan(lib, device: torch.device, n: int, d: int, k: int):
    """(grid_x, ny, dslice) for the previous dense kernel: a persistent
    grid of a few blocks per SM, and the accumulator's column split when
    (k, d) does not fit beside the row tile in shared memory."""
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


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def _dense_classify_smem(bf16: bool) -> int:
    """The classify block's shared memory: a ring of buffers of the x and
    centroid stages (two, of stride 72 in bf16 or 68 in float32), aliased
    with the (128, 68) float32 similarity tile."""
    rows = _DENSE_BLOCK_ROWS + _DENSE_CHUNK
    stage = rows * (_DENSE_CHUNK + 8) * 2 if bf16 else rows * (
        _DENSE_CHUNK + 4) * 4
    return max(2 * stage, _DENSE_BLOCK_ROWS * (_DENSE_CHUNK + 4) * 4)


def _dense_fold_smem(k: int, dt: int) -> int:
    """The fold block's shared memory: a (k, dt) accumulator, k counts,
    one batch of assignments and validities."""
    return 4 * (k * dt + k) + 8 * _DENSE_FOLD_BATCH


@dataclass(frozen=True)
class DensePlan:
    """Launch plan of the dense kernel: classify blocks of ``block_rows``
    rows; a fold grid of ``tiles`` column tiles of width ``dt`` by
    ``chunks`` row chunks of ``chunk_rows`` rows, ``fold_threads`` threads
    a block; each stage's shared memory a block; the assignment and
    partial-sum workspaces in bytes (no partial buffer when one chunk
    writes the output itself)."""

    block_rows: int
    dt: int
    tiles: int
    fold_threads: int
    chunks: int
    chunk_rows: int
    classify_smem: int
    fold_smem: int
    assign_bytes: int
    partial_bytes: int


def _dense_plan(n: int, d: int, k: int, dtype, sms: int) -> DensePlan:
    """Plan the dense kernel for (n, d) rows of ``dtype`` and k clusters
    on a card of ``sms`` SMs.  Nothing stages a whole row, so any d
    fits; the fold's (k, dt) accumulator bounds k at
    :data:`DENSE_MAX_K` (dt=1).  dt is the widest tile that fits shared
    memory, at most 256 columns (64 fold threads of 4 columns; a multiple
    of 4 unless k leaves less), balanced over the tiles; the row chunks
    fill two waves of resident fold blocks, within the partial-sum cap."""
    if not 1 <= k <= DENSE_MAX_K:
        raise ValueError(f"kmeans_stats_fused on CUDA takes 1 <= k <= "
                         f"{DENSE_MAX_K} (the fold's accumulator of k "
                         f"float32 columns and k counts in 227 KB of shared "
                         f"memory); got k={k}, d={d}")
    widest = (_DENSE_MAX_SMEM - 8 * _DENSE_FOLD_BATCH) // (4 * k) - 1
    vec = _DENSE_FOLD_VEC if widest >= _DENSE_FOLD_VEC else 1
    dt = min(_ceil(d, vec) * vec, _DENSE_FOLD_MAX_COLS, widest // vec * vec)
    tiles = _ceil(d, dt)
    dt = _ceil(_ceil(d, tiles), vec) * vec       # balanced, no more tiles
    threads = _ceil(_ceil(dt, vec), 32) * 32 + 32   # + the counts warp
    fold = _dense_fold_smem(k, dt)
    per_sm = max(1, min(_MAX_RESIDENT_BLOCKS, _MAX_SM_THREADS // threads,
                        _SM_SMEM_BYTES // (fold + _SMEM_PER_BLOCK_RESERVED)))
    per_chunk = k * (d + 1) * 4
    chunks = max(1, min(_ceil(sms * per_sm * _DENSE_FOLD_WAVES, tiles),
                        _ceil(n, _DENSE_FOLD_BATCH),
                        _DENSE_PARTIAL_CAP // per_chunk, 65535))
    chunk_rows = _ceil(_ceil(max(n, 1), chunks), _DENSE_FOLD_BATCH) * \
        _DENSE_FOLD_BATCH
    chunks = max(1, _ceil(n, chunk_rows))
    bf16 = as_torch_dtype(dtype) == torch.bfloat16
    return DensePlan(_DENSE_BLOCK_ROWS, dt, tiles, threads, chunks,
                     chunk_rows, _dense_classify_smem(bf16), fold, 4 * n,
                     0 if chunks == 1 else chunks * per_chunk)


def _variant_smem(es: int, kp: int, d: int, ds: int, ny: int,
                  resident: bool, prefetch: int) -> int:
    """The variant block's shared memory, region by region as the
    kernel's ``layout`` lays it out, each region starting on 128 bytes:
    the resident (d, kp) centroids, two slice buffers of (64, ds), the x
    ring (several slices only) and the centroid ring (centroids not
    resident only) of ``prefetch + 1`` chunks, the (64, kp) float32
    similarity, the weight tile in either layout, per-row scalars and
    per-thread counts.  Staged rows pad by 16 bytes, the similarity's by
    4 floats."""
    pad = 16 // es

    def up(v: int) -> int:
        return _ceil(v, _VAR_ALIGN) * _VAR_ALIGN

    dp = _ceil(d, _VAR_CHUNK) * _VAR_CHUNK
    ring = prefetch + 1
    o = up(dp * (kp + pad) * es) if resident else 0
    o = up(o + 2 * _VAR_ROWS * (ds + pad) * es)
    if ny > 1:
        o = up(o + ring * _VAR_ROWS * (_VAR_CHUNK + pad) * es)
    if not resident:
        o = up(o + ring * _VAR_CHUNK * (kp + pad) * es)
    o = up(o + _VAR_ROWS * (kp + _VAR_SIM_PAD) * 4)
    o = up(o + max(_VAR_ROWS * (kp + pad), kp * (_VAR_ROWS + pad)) * es)
    o = up(o + 3 * _VAR_ROWS * 4)
    return up(o + (_VAR_THREADS + 1) * 4)


@dataclass(frozen=True)
class VariantPlan:
    """Launch plan of the variant kernel: centroid columns padded to
    ``kp``; ``slices`` column slices of ``ds`` columns on the grid's y
    axis; the centroids ``resident`` in shared memory or streamed with
    each chunk of x; ``prefetch`` chunks in flight; ``grid`` blocks on the
    x axis; a block's shared memory."""

    kp: int
    ds: int
    slices: int
    resident: bool
    prefetch: int
    grid: int
    smem: int


def _variant_plan(n: int, d: int, k: int, dtype, sms: int) -> VariantPlan:
    """Plan the variant kernel for (n, d) rows of ``dtype`` and k clusters
    on a card of ``sms`` SMs.  kp is k padded to a power of two in [32,
    128], which bounds k at :data:`VARIANT_MAX_K`.  The fewest column
    slices win, since each re-reads every row: ds is a multiple of 64
    with kp * ds within the block's register accumulator; then the
    deepest prefetch (at most a tile's chunks), then the centroids
    resident in shared memory.  The slices share one block an SM on the
    grid's x axis, at most one a tile.  A d that needs more than
    :data:`VARIANT_MAX_SLICES` slices raises."""
    if not 1 <= k <= VARIANT_MAX_K:
        raise ValueError(f"kmeans_stats_variant on CUDA takes 1 <= k <= "
                         f"{VARIANT_MAX_K} (centroid columns padded to a "
                         f"power of two up to {VARIANT_MAX_K} in the "
                         f"block's similarity tile); got k={k}, d={d}")
    es = 2 if as_torch_dtype(dtype) == torch.bfloat16 else 4
    kp = max(_VAR_MIN_KP, 1 << (k - 1).bit_length())
    nj = _ceil(d, _VAR_CHUNK)
    for ds in range(min(_VAR_ACC // kp, nj * _VAR_CHUNK), 0, -_VAR_CHUNK):
        ny = _ceil(d, ds)
        for prefetch in range(min(_VAR_MAX_PREFETCH, nj), 0, -1):
            for resident in (True, False):
                smem = _variant_smem(es, kp, d, ds, ny, resident, prefetch)
                if smem > _DENSE_MAX_SMEM:
                    continue
                if ny > VARIANT_MAX_SLICES:
                    raise ValueError(
                        f"kmeans_stats_variant on CUDA takes at most "
                        f"{VARIANT_MAX_SLICES} column slices (the grid's y "
                        f"axis) of at most {ds} columns at k={k} in "
                        f"{dtype}, so d <= {VARIANT_MAX_SLICES * ds}; got "
                        f"d={d}")
                grid = max(1, min(_ceil(n, _VAR_ROWS), sms // ny))
                return VariantPlan(kp, ds, ny, resident, prefetch, grid,
                                   smem)
    raise ValueError(f"kmeans_stats_variant on CUDA: no column slice of "
                     f"d={d} at k={k} fits the 227 KB of shared memory of "
                     "one block")


_VARIANT_LIB = None


def _variant_lib() -> ctypes.CDLL:
    global _VARIANT_LIB
    if _VARIANT_LIB is None:
        from rabit_tpu_torch.ops import _build

        lib = _build.load("kmeans_stats_variant")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kmeans_stats_variant.argtypes = [i, p, ll, i, p, ll, p,
                                             *[i] * 10, p, p, p]
        lib.kmeans_stats_variant.restype = i
        lib.kmeans_stats_variant_smem_bytes.argtypes = [i] * 7
        lib.kmeans_stats_variant_smem_bytes.restype = ll
        lib.kmeans_stats_variant_error_string.argtypes = [i]
        lib.kmeans_stats_variant_error_string.restype = ctypes.c_char_p
        _VARIANT_LIB = lib
    return _VARIANT_LIB


_DENSE_LIB = None


def _dense_lib() -> ctypes.CDLL:
    global _DENSE_LIB
    if _DENSE_LIB is None:
        from rabit_tpu_torch.ops import _build

        lib = _build.load("kmeans_stats_dense")
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.kmeans_stats_dense.argtypes = [p, ll, i, p, ll, p, i, i, i, i,
                                           i, i, i, i, p, p, p, p]
        lib.kmeans_stats_dense.restype = i
        lib.kmeans_stats_dense_smem_bytes.argtypes = [i, i, i, i]
        lib.kmeans_stats_dense_smem_bytes.restype = ll
        lib.kmeans_stats_dense_error_string.argtypes = [i]
        lib.kmeans_stats_dense_error_string.restype = ctypes.c_char_p
        _DENSE_LIB = lib
    return _DENSE_LIB


_ELL_LIB = None


def _ell_lib() -> ctypes.CDLL:
    global _ELL_LIB
    if _ELL_LIB is None:
        from rabit_tpu_torch.ops import _build

        lib = _build.load("kmeans_ell_stats")
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.kmeans_stats_ell.argtypes = [p, p, i, p, p, i, i, i, i, i, i, i,
                                         i, i, i, i, p, p, p, p]
        lib.kmeans_stats_ell.restype = i
        lib.kmeans_ell_max_dslice.argtypes = [i] * 5
        lib.kmeans_ell_max_dslice.restype = i
        lib.kmeans_ell_scratch_bytes.argtypes = [i, i]
        lib.kmeans_ell_scratch_bytes.restype = ctypes.c_longlong
        lib.kmeans_ell_error_string.argtypes = [i]
        lib.kmeans_ell_error_string.restype = ctypes.c_char_p
        _ELL_LIB = lib
    return _ELL_LIB


def _ell_plan(lib, device: torch.device, n: int, d: int, k: int, nnz: int):
    """(grid_x, grid_y, nslices, dslice, rows_per_warp, global_stage) for
    the ELL kernel.  The row-group buffers lie in shared memory beside a
    column slice of the accumulator, or (``global_stage``) in device
    memory, which leaves all of the shared memory to the accumulator and
    takes rows of any width.  The fewest column slices win, since every
    slice re-reads, re-merges and re-classifies every row, while staging
    in device memory costs one more write and read of the slots; then
    shared memory; then the most rows per warp.  The grid holds one block
    per SM (the kernel's 1024 threads fill its registers): ``grid_y`` of
    them take the slices in turn, ``grid_x`` stride over the row
    groups."""
    best = None
    for global_stage in (False, True):
        for rpw in (1,) if global_stage else _ELL_ROWS_PER_WARP:
            widest = lib.kmeans_ell_max_dslice(d, k, nnz, rpw,
                                               int(global_stage))
            if widest >= 1:
                plan = (-(-d // widest), global_stage, -rpw)
                best = plan if best is None else min(best, plan)
    if best is None:
        raise ValueError(f"kmeans ELL stats kernel: k={k} does not fit the "
                         "227 KB of shared memory of one block")
    nslices, global_stage, rpw = best[0], best[1], -best[2]
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    grid_y = min(nslices, sms)
    groups = -(-n // (_ELL_WARPS * rpw))
    grid_x = max(1, min(groups, sms // grid_y))
    return grid_x, grid_y, nslices, -(-d // nslices), rpw, global_stage


def _dense_launch(cn: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                  stages: int = 7, ws=None):
    """Launch stages of the dense kernel (bit 0 classify, bit 1 fold,
    bit 2 reduce; 7 is the whole pass) and return ``(out, ws)``, where
    ``ws`` holds the workspaces, to hand back for a later stage.  Counts
    no launch: :func:`_dense_cuda` does, for whole passes."""
    lib = _dense_lib()
    n, d = x.shape
    k = cn.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = _dense_plan(n, d, k, x.dtype, sms)
    if ws is None:
        # centroids transposed, (d, kp), columns past k zero
        ct = torch.zeros((d, _ceil(k, _DENSE_CHUNK) * _DENSE_CHUNK),
                         dtype=x.dtype, device=x.device)
        ct[:, :k] = cn.T
        out = torch.empty((k, d + 1), dtype=torch.float32, device=x.device)
        ws = dict(ct=ct, out=out,
                  assign=torch.empty(n, dtype=torch.int32, device=x.device),
                  partial=(out if plan.chunks == 1 else torch.empty(
                      (plan.chunks, k, d + 1), dtype=torch.float32,
                      device=x.device)))
    ct = ws["ct"]
    with torch.cuda.device(x.device):
        err = lib.kmeans_stats_dense(
            x.data_ptr(), x.stride(0), int(x.dtype == torch.bfloat16),
            valid.data_ptr(), valid.stride(0), ct.data_ptr(), ct.shape[1],
            n, d, k, plan.dt, plan.chunks, plan.chunk_rows, stages,
            ws["assign"].data_ptr(), ws["partial"].data_ptr(),
            ws["out"].data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"kmeans_stats_dense launch failed: CUDA error {err} "
            f"({lib.kmeans_stats_dense_error_string(err).decode()})")
    return ws["out"], ws


def _dense_cuda(cn: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                mode: str | None = None, block: int = 1) -> torch.Tensor:
    """The dense kernel (``kmeans_stats_dense``) when ``mode`` is None,
    else classify stage ``mode`` of the variant study
    (``kmeans_stats_variant``)."""
    name = "kmeans_stats_fused" if mode is None else "kmeans_stats_variant"
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name} on CUDA takes float32 or bfloat16 rows, "
                        f"got {x.dtype}")
    if x.stride(1) != 1:
        x = x.contiguous()
    valid = valid.to(device=x.device, dtype=torch.float32)
    n, d = x.shape
    if n == 0:
        return torch.zeros((cn.shape[0], d + 1), dtype=torch.float32,
                           device=x.device)
    if mode is not None:
        return _variant_cuda(cn, x, valid, mode, block)
    out, _ws = _dense_launch(cn, x, valid)
    LAUNCHES["kmeans_stats_dense"] += 1
    return out


def _variant_cuda(cn: torch.Tensor, x: torch.Tensor, valid: torch.Tensor,
                  mode: str, block: int) -> torch.Tensor:
    """Classify stage ``mode`` of the variant kernel on n >= 1 rows."""
    lib = _variant_lib()
    n, d = x.shape
    k = cn.shape[0]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = _variant_plan(n, d, k, x.dtype, sms)
    # centroids transposed, (d, kp), columns past k zero
    ct = torch.zeros((d, plan.kp), dtype=x.dtype, device=x.device)
    ct[:, :k] = cn.T
    partial = torch.empty((plan.grid, k, d + 1), dtype=torch.float32,
                          device=x.device)
    out = torch.empty((k, d + 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.kmeans_stats_variant(
            VARIANTS.index(mode), x.data_ptr(), x.stride(0),
            int(x.dtype == torch.bfloat16), valid.data_ptr(), valid.stride(0),
            ct.data_ptr(), n, d, k, plan.kp, block, plan.grid, plan.slices,
            plan.ds, int(plan.resident), plan.prefetch, partial.data_ptr(),
            out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"kmeans_stats_variant {mode} launch failed: CUDA error {err} "
            f"({lib.kmeans_stats_variant_error_string(err).decode()})")
    LAUNCHES[f"p1_{mode}"] += 1
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
    lib = _ell_lib()
    bf16 = cn.dtype == torch.bfloat16
    grid_x, grid_y, nslices, dslice, rpw, global_stage = _ell_plan(
        lib, idx.device, n, d, k, nnz)
    kp = -(-k // _ELL_CLUSTER_CHUNK) * _ELL_CLUSTER_CHUNK
    ct = torch.zeros((d, kp), dtype=cn.dtype, device=idx.device)
    ct[:, :k] = cn.T
    partial = torch.empty((grid_x, k, d + 1), dtype=torch.float32,
                          device=idx.device)
    scratch = None
    if global_stage:
        scratch = torch.empty(
            grid_x * grid_y * lib.kmeans_ell_scratch_bytes(nnz, rpw),
            dtype=torch.uint8, device=idx.device)
    with torch.cuda.device(idx.device):
        err = lib.kmeans_stats_ell(
            idx.data_ptr(), val.data_ptr(), nnz, valid.data_ptr(),
            ct.data_ptr(), int(bf16), int(global_stage), n, d, k, kp, grid_x,
            grid_y, nslices, dslice, rpw,
            None if scratch is None else scratch.data_ptr(),
            partial.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"kmeans_stats_ell launch failed: CUDA error {err}"
                           f" ({lib.kmeans_ell_error_string(err).decode()})")
    LAUNCHES["kmeans_stats_ell"] += 1
    return out


def _route(t: torch.Tensor) -> str:
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"kmeans stats: no kernel for device {t.device}")
    return t.device.type


def _dense_inputs(centroids: torch.Tensor, x: torch.Tensor,
                  valid: torch.Tensor):
    """Checked dense inputs: (centroids normalised and rounded to the
    compute dtype, x in it); the compute dtype is x's, or float32."""
    k, d = centroids.shape
    if x.ndim != 2 or x.shape[1] != d:
        raise ValueError(f"x shape {tuple(x.shape)} does not match "
                         f"centroids dim {d}")
    if valid.shape != (x.shape[0],):
        raise ValueError(f"valid shape {tuple(valid.shape)} != "
                         f"({x.shape[0]},)")
    cdt = x.dtype if x.is_floating_point() else torch.float32
    x = x.to(cdt)
    return _normalized(centroids.to(x.device), cdt), x


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
    cn, x = _dense_inputs(centroids, x, valid)
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
    (n/G, G·nnz) arrays, which are the same memory.  Each slot's value is
    rounded to ``compute_dtype``, duplicate indices add in float32, the
    sum is rounded to ``compute_dtype`` again, and the row is scored
    against the centroids over its nonzeros.  ``group``, ``hi`` and
    ``block`` keep the JAX package's signature and validation (the CUDA
    kernel needs neither the hi/lo split nor the row blocks).
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
    cdt = as_torch_dtype(compute_dtype)
    cn = _normalized(centroids.to(idx.device), cdt)
    idx = idx.reshape(n, nnz)
    val = val.reshape(n, nnz).float()
    if _route(idx) == "cuda":
        return _ell_cuda(cn, idx, val, valid, d)
    return _ell_stats_plain(cn, idx, val, valid, d)


def kmeans_stats_variant(centroids: torch.Tensor, x: torch.Tensor,
                         valid: torch.Tensor, mode: str,
                         block: int = 2048) -> torch.Tensor:
    """(k, d+1) output of the dense stats pass with classify stage
    ``mode`` (one of :data:`VARIANTS`), for the variant study.

    ``argmax`` and ``argmaxT`` give :func:`kmeans_stats_fused`'s result;
    ``maxcmp`` adds a row into every cluster tied at its maximum;
    ``simonly`` weights every cluster by ``clip(sim, 0, 1)``; ``novalid``
    ignores ``valid``; ``simonlyT`` adds every row into every cluster
    with its validity; ``cheapassignT`` assigns row ``r`` to cluster
    ``(r % block) % k``.  ``simonlyT`` and ``cheapassignT`` add
    ``sum_r sim[r, 0]`` to every count (the JAX bodies' keep-alive
    anchor).  Only ``cheapassignT`` reads ``block``.
    """
    if mode not in VARIANTS:
        raise ValueError(f"unknown classify stage {mode!r}; one of "
                         f"{VARIANTS}")
    if block < 1:
        raise ValueError(f"block={block} must be positive")
    cn, x = _dense_inputs(centroids, x, valid)
    if _route(x) == "cuda":
        return _dense_cuda(cn, x, valid, mode, block)
    return _variant_plain(cn, x, valid, mode, block)
