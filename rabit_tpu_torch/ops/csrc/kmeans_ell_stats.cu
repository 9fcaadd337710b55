// Cosine k-means statistics pass over padded-ELL rows for Hopper (sm_90a):
// the (k, d+1) matrix of per-cluster row sums with the counts in the last
// column, computed from each row's nonzeros alone.
//
// Replaces the Pallas TPU kernel
// rabit_tpu/ops/kmeans_kernel.py:_ell_stats_kernel (kmeans_ell_stats_fused),
// which densifies each row group with a one-hot matrix product and runs the
// dense stats core on it.  The arithmetic kept from it: each slot's value is
// rounded to the compute dtype, duplicate indices of a row add in float32
// (slot order) and the sum is rounded to the compute dtype again; pad slots
// (an index outside [0, d)) drop; the similarity to the normalised
// centroids accumulates in float32; the first index of the maximum wins;
// sums and counts add in float32, weighted by the row's validity.
//
// What bounds it on an H100: bytes.  A row of nnz (index, value) slots is
// read once (8 * nnz bytes); its similarity costs 2 * k operations per
// distinct nonzero and its sums one FMA each, far below the 67 TFLOP/s
// float32 rate.  Work scales with the nonzeros, never with d.
//
// Design:
//  * one block per SM of 32 warps, holding the block's (k, dslice) float32
//    partial sums and its counts in shared memory.  The normalised
//    centroids, transposed to (d, kp) in the compute dtype (kp = k rounded
//    up to 64), are read through L1/L2: at d=512, k=64 on an H100 staging
//    them in shared memory was no faster in bfloat16 and slower in float32,
//    where it splits the accumulator into two column slices (PERF.md).
//    Where the partial does not fit, its columns split into slices; the
//    blocks of gridDim.y take the slices in turn and each slice recomputes
//    the (cheap) similarity;
//  * the grid strides over groups of 32 * rows_per_warp rows.  Each warp
//    copies its rows' slots and validities into a row-group buffer, two
//    groups ahead (three buffers): in shared memory with cp.async, or,
//    where three buffers do not fit beside the partial (wide rows), in
//    the block's own stretch of device memory with plain loads and stores;
//  * one warp per row.  Lane s holds slot s (and s + 32, ... when nnz > 32).
//    __match_any_sync on the indices groups the duplicates when nnz <= 32,
//    a scan over the row's other slots otherwise; the first slot of each
//    index keeps the merged value, and the kept slots are packed, in slot
//    order, into the row's first entries, in place;
//  * similarity over the kept slots only, in slot order: every lane reads
//    an entry (a broadcast), four entries' loads in flight at once, and
//    lane l accumulates clusters 64q + 2l and 64q + 2l + 1 from one 4- or
//    8-byte load of the entry's row of the transposed centroids:
//    consecutive lanes read consecutive words.  A shuffle reduction keeps
//    the first index on ties; clusters >= k are excluded.  An all-pad row
//    scores 0 everywhere and goes to cluster 0, as in the reference;
//  * deterministic accumulation without float atomics: once the group's
//    rows are classified, warp w adds the rows assigned to clusters
//    c = w (mod 32), in row order, each lane one kept entry of the row (the
//    entries of a row have distinct indices).  No two warps touch one
//    cluster row, so every address of the partial sees a fixed order; each
//    row is read once.  One barrier a group: between two, a warp folds one
//    group and classifies the next, so the fold's uneven load (rows per
//    cluster) evens out against the classification.  The per-block
//    partials are folded in block order by reduce_partials, so two launches
//    give the same bits.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kClusterChunk = 64;              // clusters a warp scores at once
constexpr int kMaxSmemBytes = 232448;          // 227 KB per block on sm_90
constexpr int kBuffers = 3;                    // row-group buffers
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
};

__device__ __forceinline__ float2 to_f2(float2 v) { return v; }
__device__ __forceinline__ float2 to_f2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

// Byte offsets of the block's shared memory, and the size of one row-group
// buffer (the group's indices, values, validities, assignments and
// kept-slot counts), which lies in shared memory unless kGlobal.
struct Layout {
  size_t acc, cnt, stage, stage_bytes, total;
};

__host__ __device__ inline Layout layout(int k, int nnz, int dslice, int rows,
                                         bool global) {
  Layout L;
  L.acc = 0;
  L.cnt = align16((size_t)k * dslice * sizeof(float));
  L.stage = L.cnt + align16((size_t)k * sizeof(float));
  L.stage_bytes = align16((size_t)rows * nnz * 8 + (size_t)rows * 12);
  L.total = L.stage + (global ? 0 : kBuffers * L.stage_bytes);
  return L;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

// One warp copies `count` 4-byte words, 16 bytes a copy where both sides
// allow: with cp.async into shared memory, or (kGlobal) with loads and
// stores into device memory.
template <bool kGlobal>
__device__ __forceinline__ void copy_words(void* dst, const void* src,
                                           int count, bool vec, int lane) {
  uint32_t* d = static_cast<uint32_t*>(dst);
  const uint32_t* s = static_cast<const uint32_t*>(src);
  int done = 0;
  if (vec) {
    const int nv = count / 4;
    for (int i = lane; i < nv; i += 32) {
      if constexpr (kGlobal)
        reinterpret_cast<uint4*>(d)[i] =
            __ldg(reinterpret_cast<const uint4*>(s) + i);
      else
        cp_async16(d + 4 * i, s + 4 * i);
    }
    done = nv * 4;
  }
  for (int i = done + lane; i < count; i += 32) {
    if constexpr (kGlobal)
      d[i] = __ldg(s + i);
    else
      cp_async4(d + i, s + i);
  }
}

// Merge one row's slots in place and return how many are kept.  The first
// slot of each index in [0, d) takes the float32 sum, in slot order, of its
// duplicates' values rounded to T, itself rounded to T; the kept slots are
// then packed, in slot order, into the row's first entries.
template <typename T>
__device__ __forceinline__ int merge_row(int* ri, float* rv, int nnz,
                                         int groups, int d, int lane) {
  const unsigned below = (1u << lane) - 1;
  if (groups == 1) {
    const int col = lane < nnz ? ri[lane] : -1;
    const bool live = col >= 0 && col < d;
    const unsigned same = __match_any_sync(kFull, live ? col : -1 - lane);
    const bool keep = live && (same & below) == 0;
    float sum = 0.f;
    if (keep) {
      sum = round_to<T>(rv[lane]);
      for (unsigned m = same & (same - 1); m; m &= m - 1)
        sum += round_to<T>(rv[__ffs(m) - 1]);
    }
    const unsigned kept = __ballot_sync(kFull, keep);
    __syncwarp();                      // every duplicate read before packing
    if (keep) {
      const int at = __popc(kept & below);
      ri[at] = col;
      rv[at] = round_to<T>(sum);
    }
    __syncwarp();
    return __popc(kept);
  }
  // One 32-slot group at a time: scan the row for an earlier slot of the
  // same index and sum the later ones, then pack.  Packing writes only
  // entries below the current group, and the indices found there are the
  // first slots of earlier groups: an index is still found before slot s
  // exactly when it was there before, and the later slots the sums read
  // are untouched.
  int m = 0;
  for (int g = 0; g < groups; ++g) {
    const int s = lane + 32 * g;
    const int col = s < nnz ? ri[s] : -1;
    bool keep = col >= 0 && col < d;
    for (int j = 0; j < s && keep; ++j) keep = ri[j] != col;
    float sum = 0.f;
    if (keep) {
      sum = round_to<T>(rv[s]);
      for (int j = s + 1; j < nnz; ++j)
        if (ri[j] == col) sum += round_to<T>(rv[j]);
    }
    const unsigned kept = __ballot_sync(kFull, keep);
    __syncwarp();                      // the group read before packing
    if (keep) {
      const int at = m + __popc(kept & below);
      ri[at] = col;
      rv[at] = round_to<T>(sum);
    }
    m += __popc(kept);
    __syncwarp();
  }
  return m;
}

// The first cluster of highest similarity for a merged row of m entries;
// aligned: ri and rv are 16-byte aligned.
template <typename T>
__device__ __forceinline__ int classify(const int* ri, const float* rv, int m,
                                        bool aligned, const T* cent, int k,
                                        int kp, int lane) {
  using Pair = typename PairOf<T>::type;
  constexpr int kUnroll = 4;           // entries per 16-byte load
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int q = 0; q < kp; q += kClusterChunk) {
    float s0 = 0.f, s1 = 0.f;
    const T* base = cent + q + 2 * lane;
    auto load = [&](int col) {
      return __ldg(reinterpret_cast<const Pair*>(base + (size_t)col * kp));
    };
    auto add = [&](float v, Pair pair) {
      const float2 c = to_f2(pair);
      s0 = fmaf(v, c.x, s0);
      s1 = fmaf(v, c.y, s1);
    };
    int j = 0;
    if (aligned && m >= kUnroll) {
      // four entries a step, in slot order; the next step's loads are
      // issued before this step's FMAs
      float4 v = *reinterpret_cast<const float4*>(rv);
      int4 cols = *reinterpret_cast<const int4*>(ri);
      Pair p0 = load(cols.x), p1 = load(cols.y), p2 = load(cols.z),
           p3 = load(cols.w);
      for (j = kUnroll; j + kUnroll <= m; j += kUnroll) {
        const float4 nv = *reinterpret_cast<const float4*>(rv + j);
        cols = *reinterpret_cast<const int4*>(ri + j);
        const Pair n0 = load(cols.x), n1 = load(cols.y), n2 = load(cols.z),
                   n3 = load(cols.w);
        add(v.x, p0);
        add(v.y, p1);
        add(v.z, p2);
        add(v.w, p3);
        v = nv;
        p0 = n0;
        p1 = n1;
        p2 = n2;
        p3 = n3;
      }
      add(v.x, p0);
      add(v.y, p1);
      add(v.z, p2);
      add(v.w, p3);
    }
    for (; j < m; ++j) add(rv[j], load(ri[j]));
    const int c0 = q + 2 * lane;
    if (c0 < k && (s0 > bv || (s0 == bv && c0 < bi))) {
      bv = s0;
      bi = c0;
    }
    if (c0 + 1 < k && (s1 > bv || (s1 == bv && c0 + 1 < bi))) {
      bv = s1;
      bi = c0 + 1;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_xor_sync(kFull, bv, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
  }
  return bi == INT_MAX ? 0 : bi;
}

// T is the compute dtype.  ct: (d, kp) normalised centroids, transposed,
// rounded to T, zero beyond column k.  nslices column slices of dslice
// columns each.  scratch (kGlobal): kBuffers row-group buffers for each
// block of the grid.  partial: (gridDim.x, k, d+1).
template <typename T, bool kGlobal>
__global__ void __launch_bounds__(kThreads, 1)
ell_stats_kernel(const int* __restrict__ idx, const float* __restrict__ val,
                 int nnz, const float* __restrict__ valid,
                 const T* __restrict__ ct, int n, int d, int k, int kp,
                 int nslices, int dslice, int rows_per_warp, bool vec,
                 unsigned char* __restrict__ scratch,
                 float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = kWarps * rows_per_warp;
  const Layout L = layout(k, nnz, dslice, rows, kGlobal);
  float* acc = reinterpret_cast<float*>(smem + L.acc);
  float* cnt = reinterpret_cast<float*>(smem + L.cnt);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int groups = (nnz + 31) / 32;
  unsigned char* stage =
      kGlobal ? scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) *
                              kBuffers * L.stage_bytes
              : smem + L.stage;

  // buffer b of a row group: indices, values, validities, assignments,
  // kept-slot counts.  Warp w owns rows [w * R, (w + 1) * R) of a group
  // (R = rows_per_warp): it copies them in, merges and classifies them.
  auto slots = [&](int b) { return stage + b * L.stage_bytes; };
  const size_t vals_at = (size_t)rows * nnz * 4;
  const size_t valid_at = 2 * vals_at, assign_at = valid_at + rows * 4;
  const size_t count_at = assign_at + rows * 4;
  const int w0 = warp * rows_per_warp;
  const bool wvec = vec && (rows_per_warp * nnz) % 4 == 0;
  const int ngroups = (n + rows - 1) / rows;
  auto fetch = [&](int grp, int b) {   // a group's rows of this warp
    if (grp < ngroups) {
      unsigned char* buf = slots(b);
      const long long row0 = (long long)grp * rows + w0;
      const int nrw = (int)max(0LL, min((long long)rows_per_warp, n - row0));
      const long long at = row0 * nnz;
      copy_words<kGlobal>(buf + (size_t)w0 * nnz * 4, idx + at, nrw * nnz,
                          wvec, lane);
      copy_words<kGlobal>(buf + vals_at + (size_t)w0 * nnz * 4, val + at,
                          nrw * nnz, wvec, lane);
      copy_words<kGlobal>(buf + valid_at + 4 * w0, valid + row0, nrw, false,
                          lane);
    }
    cp_async_commit();   // empty past the end: wait_one stays right
  };
  // 1. merge and classify this warp's rows of a group
  auto classify_rows = [&](int grp, int b) {
    unsigned char* buf = slots(b);
    int* sassign = reinterpret_cast<int*>(buf + assign_at);
    int* scount = reinterpret_cast<int*>(buf + count_at);
    cp_async_wait_one();               // this group landed, the next may fly
    __syncwarp();
    const int nr = min(rows, n - grp * rows);
    for (int rr = 0; rr < rows_per_warp; ++rr) {
      const int r = w0 + rr;
      int a = -1, m = 0;
      if (r < nr) {
        int* ri = reinterpret_cast<int*>(buf) + (size_t)r * nnz;
        float* rv = reinterpret_cast<float*>(buf + vals_at) + (size_t)r * nnz;
        m = merge_row<T>(ri, rv, nnz, groups, d, lane);
        a = classify<T>(ri, rv, m, nnz % 4 == 0, ct, k, kp, lane);
      }
      if (lane == 0) {
        sassign[r] = a;
        scount[r] = m;
      }
    }
  };

  for (int slice = blockIdx.y; slice < nslices; slice += gridDim.y) {
    const int js = slice * dslice;     // this slice's columns
    const int jw = min(dslice, d - js);
    const bool own_counts = slice == 0;
    // 2. warp w folds a group's rows of clusters w, w + kWarps, ..., in
    // row order
    auto fold_rows = [&](int b) {
      unsigned char* buf = slots(b);
      const int* sidx = reinterpret_cast<const int*>(buf);
      const float* sval = reinterpret_cast<const float*>(buf + vals_at);
      const float* svalid = reinterpret_cast<const float*>(buf + valid_at);
      const int* sassign = reinterpret_cast<const int*>(buf + assign_at);
      const int* scount = reinterpret_cast<const int*>(buf + count_at);
      for (int base = 0; base < rows; base += 32) {
        const int a = base + lane < rows ? sassign[base + lane] : -1;
        unsigned mine = __ballot_sync(kFull, a >= 0 && a % kWarps == warp);
        while (mine) {
          const int r = base + __ffs(mine) - 1;
          mine &= mine - 1;
          const int c = sassign[r], m = scount[r];
          const float w = svalid[r];
          const int* ri = sidx + (size_t)r * nnz;
          const float* rv = sval + (size_t)r * nnz;
          float* arow = acc + (size_t)c * dslice;
          for (int s = lane; s < m; s += 32) {
            const int col = ri[s];
            if (col >= js && col < js + jw)
              arow[col - js] = fmaf(w, rv[s], arow[col - js]);
          }
          if (own_counts && lane == 0) cnt[c] += w;
          __syncwarp();
        }
      }
    };

    for (int e = tid; e < k * dslice; e += kThreads) acc[e] = 0.f;
    for (int e = tid; e < k; e += kThreads) cnt[e] = 0.f;
    // Between two barriers a warp folds group t and classifies group t + 1,
    // while group t + 2 is in flight: every warp's list of group t is
    // complete at the barrier, and group t - 1's buffer, which group t + 2
    // reuses, has been folded by every warp.
    const int step = gridDim.x;
    int grp = blockIdx.x, b = 0;
    fetch(grp, 0);
    fetch(grp + step, 1);
    __syncthreads();                   // the partial zeroed
    if (grp < ngroups) classify_rows(grp, 0);
    for (; grp < ngroups; grp += step, b = b == kBuffers - 1 ? 0 : b + 1) {
      const int b1 = b == kBuffers - 1 ? 0 : b + 1;
      const int b2 = b1 == kBuffers - 1 ? 0 : b1 + 1;
      __syncthreads();
      fetch(grp + 2 * step, b2);
      fold_rows(b);
      if (grp + step < ngroups) classify_rows(grp + step, b1);
    }
    cp_async_wait_all();
    __syncthreads();

    float* out = partial + (size_t)blockIdx.x * k * (d + 1);
    for (int e = tid; e < k * jw; e += kThreads) {
      const int c = e / jw, jj = e - c * jw;
      out[(size_t)c * (d + 1) + js + jj] = acc[(size_t)c * dslice + jj];
    }
    if (own_counts)
      for (int c = tid; c < k; c += kThreads)
        out[(size_t)c * (d + 1) + d] = cnt[c];
    __syncthreads();                   // the partial read before the next
  }
}

// out[e] = sum of the per-block partials, in block order.
__global__ void reduce_partials(const float* __restrict__ partial,
                                int nparts, int m, float* __restrict__ out) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[(size_t)p * m + e];
  out[e] = s;
}

template <typename T, bool kGlobal>
int launch(const int* idx, const float* val, int nnz, const float* valid,
           const T* ct, int n, int d, int k, int kp, int grid_x, int grid_y,
           int nslices, int dslice, int rows_per_warp, void* scratch,
           float* partial, float* out, cudaStream_t stream) {
  const size_t smem =
      layout(k, nnz, dslice, kWarps * rows_per_warp, kGlobal).total;
  if (n < 1 || d < 1 || k < 1 || nnz < 1 || kp < k ||
      kp % kClusterChunk != 0 || grid_x < 1 || grid_y < 1 || nslices < 1 ||
      dslice < 1 || (long long)nslices * dslice < d || rows_per_warp < 1 ||
      smem > (size_t)kMaxSmemBytes || (kGlobal && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ell_stats_kernel<T, kGlobal>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const bool vec = ((reinterpret_cast<uintptr_t>(idx) |
                     reinterpret_cast<uintptr_t>(val) |
                     reinterpret_cast<uintptr_t>(scratch)) & 15) == 0;
  ell_stats_kernel<T, kGlobal>
      <<<dim3(grid_x, grid_y), kThreads, smem, stream>>>(
          idx, val, nnz, valid, ct, n, d, k, kp, nslices, dslice,
          rows_per_warp, vec, static_cast<unsigned char*>(scratch), partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int m = k * (d + 1);
  reduce_partials<<<(m + 255) / 256, 256, 0, stream>>>(partial, grid_x, m,
                                                       out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_stage(int global, const int* idx, const float* val, int nnz,
                 const float* valid, const void* ct, int n, int d, int k,
                 int kp, int grid_x, int grid_y, int nslices, int dslice,
                 int rows_per_warp, void* scratch, float* partial, float* out,
                 cudaStream_t s) {
  const T* c = static_cast<const T*>(ct);
  if (global)
    return launch<T, true>(idx, val, nnz, valid, c, n, d, k, kp, grid_x,
                           grid_y, nslices, dslice, rows_per_warp, scratch,
                           partial, out, s);
  return launch<T, false>(idx, val, nnz, valid, c, n, d, k, kp, grid_x,
                          grid_y, nslices, dslice, rows_per_warp, scratch,
                          partial, out, s);
}

}  // namespace

extern "C" {

const char* kmeans_ell_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Widest accumulator column slice that fits beside the row-group buffers
// (global: none in shared memory); 0 if none.
int kmeans_ell_max_dslice(int d, int k, int nnz, int rows_per_warp,
                          int global) {
  const long long fixed =
      (long long)layout(k, nnz, 0, kWarps * rows_per_warp, global != 0)
          .total;
  const long long avail = kMaxSmemBytes - fixed - 16;   // alignment slack
  if (avail < 4LL * k) return 0;
  const long long w = avail / (4LL * k);
  return (int)(w < d ? w : d);
}

// Bytes of device memory one block's row-group buffers take when they
// are not in shared memory.
long long kmeans_ell_scratch_bytes(int nnz, int rows_per_warp) {
  return (long long)kBuffers *
         (long long)layout(1, nnz, 1, kWarps * rows_per_warp, true)
             .stage_bytes;
}

// idx: (n, nnz) int32, val: (n, nnz) f32 (the grouped (n/G, G*nnz) layout
// is the same memory); valid: (n,) f32; ct: (d, kp) normalised centroids,
// transposed, in the compute dtype (bf16 when bf16), zero beyond column k,
// kp a multiple of 64; global: the row-group buffers lie in scratch,
// grid_x * grid_y * kmeans_ell_scratch_bytes bytes, not in shared memory;
// nslices column slices of dslice columns, taken in turn by the grid_y
// blocks of a column of the grid; partial: (grid_x, k, d+1) f32 scratch;
// out: (k, d+1) f32.
int kmeans_stats_ell(const void* idx, const void* val, int nnz,
                     const void* valid, const void* ct, int bf16, int global,
                     int n, int d, int k, int kp, int grid_x, int grid_y,
                     int nslices, int dslice, int rows_per_warp,
                     void* scratch, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* vp = static_cast<const float*>(val);
  const float* valp = static_cast<const float*>(valid);
  float* pp = static_cast<float*>(partial);
  float* op = static_cast<float*>(out);
  if (bf16)
    return launch_stage<__nv_bfloat16>(global, ip, vp, nnz, valp, ct, n, d,
                                       k, kp, grid_x, grid_y, nslices, dslice,
                                       rows_per_warp, scratch, pp, op, s);
  return launch_stage<float>(global, ip, vp, nnz, valp, ct, n, d, k, kp,
                             grid_x, grid_y, nslices, dslice, rows_per_warp,
                             scratch, pp, op, s);
}

}  // extern "C"
