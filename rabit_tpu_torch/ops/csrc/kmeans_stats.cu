// Cosine k-means statistics pass for Hopper (sm_90a): the (k, d+1) matrix
// of per-cluster row sums with the counts in the last column.
//
// Replaces the two Pallas TPU kernels of rabit_tpu/ops/kmeans_kernel.py:
//   _stats_kernel      (dense rows, kmeans_stats_fused)      -> kmeans_stats_dense
//   _ell_stats_kernel  (padded-ELL rows, kmeans_ell_stats_fused) -> kmeans_stats_ell
//
// Per row: similarity to every normalised centroid (f32 FMA over d), the
// first index of the maximum, then the row (times its validity) added into
// that cluster's sum and the validity into its count.
//
// What bounds it on an H100: the similarity is 2*n*k*d operations on the
// CUDA cores' float32 FMA units (no tensor cores in this first version), so
// at the main path's shapes the kernel is bound by operations and by shared
// memory bandwidth, not by the single read of x.  The design keeps x out of
// a second pass: each row tile is staged once in shared memory and used for
// both the similarity and the sums, so device memory is read exactly once.
//
// Design:
//  * a persistent grid (a few blocks per SM) strides over 32-row tiles; the
//    TPU kernel's sequential grid, which carried the sums across steps, has
//    no counterpart -- each block keeps its own (k, dslice) partial sums and
//    (k,) counts in shared memory;
//  * every thread owns fixed accumulator columns and folds the tile's rows
//    in row order, and a second kernel sums the per-block partials in block
//    order, so two runs on the same input give the same bits (no float
//    atomics);
//  * the similarity is a 16x16 thread grid, each thread a 2-row x 4-centroid
//    register tile, with centroid chunks staged transposed in shared memory;
//  * the ELL variant rounds each slot's value to the compute dtype, adds
//    it into the zeroed f32 tile in slot order (duplicates add, indices >= d
//    are pad slots and are dropped) and rounds the tile to the compute dtype
//    again -- the TPU kernel's two roundings (before and after its densify
//    product) -- then runs the same core;
//  * when the (k, d) accumulator does not fit beside the tile, the columns
//    split over gridDim.y and each column slice recomputes the similarity.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 32;                      // rows per tile
constexpr int kCentChunk = 64;                 // centroids per similarity pass
constexpr int kDimChunk = 32;                  // features per staged chunk
constexpr int kStageLd = kCentChunk + 1;       // padded: conflict-free stores
constexpr int kTx = 16, kTy = 16;
constexpr int kRowsPerThread = kRows / kTy;        // 2
constexpr int kCentPerThread = kCentChunk / kTx;   // 4
constexpr int kMaxSmemBytes = 232448;          // 227 KB per block on sm_90

static_assert(kTx * kTy == kThreads, "thread grid");

__host__ __device__ inline size_t smem_floats(int d, int k, int dslice) {
  return (size_t)kRows * (d + 1) + (size_t)kDimChunk * kStageLd +
         (size_t)k * dslice + (size_t)k + 2 * kRows;
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// T is the compute dtype: x's dtype for dense rows, compute_dtype for ELL.
template <typename T, bool kEll>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, long long ldx,
             const int* __restrict__ idx, const float* __restrict__ val,
             int nnz, const float* __restrict__ valid, long long ldv,
             const T* __restrict__ cn, int n, int d, int k, int dslice,
             float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int ldt = d + 1;                         // odd stride: fewer conflicts
  float* tile = smem;                            // kRows x ldt
  float* cstage = tile + (size_t)kRows * ldt;    // kDimChunk x kStageLd
  float* acc = cstage + kDimChunk * kStageLd;    // k x dslice
  float* cnt = acc + (size_t)k * dslice;         // k
  float* vrow = cnt + k;                         // kRows
  int* assign = reinterpret_cast<int*>(vrow + kRows);  // kRows

  const int tid = threadIdx.x;
  const int tx = tid % kTx, ty = tid / kTx;
  const int js = blockIdx.y * dslice;            // this block's column slice
  const int jw = min(dslice, d - js);
  const bool own_counts = blockIdx.y == 0;

  for (int e = tid; e < k * dslice; e += kThreads) acc[e] = 0.f;
  for (int e = tid; e < k; e += kThreads) cnt[e] = 0.f;

  const int ntiles = (n + kRows - 1) / kRows;
  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int row0 = t * kRows;
    __syncthreads();                             // previous tile consumed

    // 1. stage the row tile in f32
    if constexpr (kEll) {
      for (int e = tid; e < kRows * ldt; e += kThreads) tile[e] = 0.f;
      __syncthreads();
      if (tid < kRows && row0 + tid < n) {
        const long long base = (long long)(row0 + tid) * nnz;
        float* tr = tile + tid * ldt;
        for (int s = 0; s < nnz; ++s) {          // slot order: deterministic
          const int i = idx[base + s];
          if (i >= 0 && i < d) tr[i] += round_to<T>(val[base + s]);
        }
      }
      __syncthreads();
      for (int e = tid; e < kRows * ldt; e += kThreads)
        tile[e] = round_to<T>(tile[e]);
    } else {
      for (int e = tid; e < kRows * d; e += kThreads) {
        const int r = e / d, j = e - r * d;
        const int row = row0 + r;
        tile[r * ldt + j] =
            row < n ? to_f(x[(long long)row * ldx + j]) : 0.f;
      }
    }
    if (tid < kRows) {
      const int row = row0 + tid;
      vrow[tid] = row < n ? valid[(long long)row * ldv] : 0.f;
    }
    __syncthreads();

    // 2. similarity and first-index argmax
    float best[kRowsPerThread];
    int bidx[kRowsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      best[i] = -INFINITY;
      bidx[i] = INT_MAX;
    }
    for (int c0 = 0; c0 < k; c0 += kCentChunk) {
      float s[kRowsPerThread][kCentPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int q = 0; q < kCentPerThread; ++q) s[i][q] = 0.f;

      for (int j0 = 0; j0 < d; j0 += kDimChunk) {
        for (int e = tid; e < kDimChunk * kCentChunk; e += kThreads) {
          const int cc = e / kDimChunk, jj = e - cc * kDimChunk;
          const int c = c0 + cc, j = j0 + jj;
          cstage[jj * kStageLd + cc] =
              (c < k && j < d) ? to_f(cn[(long long)c * d + j]) : 0.f;
        }
        __syncthreads();
        const int jn = min(kDimChunk, d - j0);
        for (int jj = 0; jj < jn; ++jj) {
          float xv[kRowsPerThread], cv[kCentPerThread];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            xv[i] = tile[(ty + kTy * i) * ldt + j0 + jj];
#pragma unroll
          for (int q = 0; q < kCentPerThread; ++q)
            cv[q] = cstage[jj * kStageLd + tx + kTx * q];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
            for (int q = 0; q < kCentPerThread; ++q)
              s[i][q] = fmaf(xv[i], cv[q], s[i][q]);
        }
        __syncthreads();
      }

#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i) {
        float bv = best[i];
        int bi = bidx[i];
#pragma unroll
        for (int q = 0; q < kCentPerThread; ++q) {
          const int c = c0 + tx + kTx * q;
          const float v = s[i][q];
          if (c < k && (v > bv || (v == bv && c < bi))) {
            bv = v;
            bi = c;
          }
        }
        // the 16 lanes of one row sit in one half-warp
#pragma unroll
        for (int off = kTx / 2; off > 0; off >>= 1) {
          const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
          const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
          if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
          }
        }
        best[i] = bv;
        bidx[i] = bi;
      }
    }
    if (tx == 0) {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        assign[ty + kTy * i] = bidx[i] == INT_MAX ? 0 : bidx[i];
    }
    __syncthreads();

    // 3. fold the tile into the block's partials, rows in order
    for (int jj = tid; jj < jw; jj += kThreads) {
      const int j = js + jj;
      for (int r = 0; r < kRows; ++r) {
        float* a = acc + (size_t)assign[r] * dslice + jj;
        *a = fmaf(vrow[r], tile[r * ldt + j], *a);
      }
    }
    if (own_counts) {
      for (int c = tid; c < k; c += kThreads) {
        float s = cnt[c];
        for (int r = 0; r < kRows; ++r)
          if (assign[r] == c) s += vrow[r];
        cnt[c] = s;
      }
    }
  }
  __syncthreads();

  float* out = partial + (size_t)blockIdx.x * k * (d + 1);
  for (int e = tid; e < k * jw; e += kThreads) {
    const int c = e / jw, jj = e - c * jw;
    out[(size_t)c * (d + 1) + js + jj] = acc[(size_t)c * dslice + jj];
  }
  if (own_counts)
    for (int c = tid; c < k; c += kThreads)
      out[(size_t)c * (d + 1) + d] = cnt[c];
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

template <typename T, bool kEll>
int launch(const T* x, long long ldx, const int* idx, const float* val,
           int nnz, const float* valid, long long ldv, const T* cn, int n,
           int d, int k, int grid_x, int ny, int dslice, float* partial,
           float* out, cudaStream_t stream) {
  const size_t smem = smem_floats(d, k, dslice) * sizeof(float);
  if (n < 1 || d < 1 || k < 1 || grid_x < 1 || ny < 1 || dslice < 1 ||
      (long long)ny * dslice < d || smem > (size_t)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<T, kEll>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<T, kEll><<<dim3(grid_x, ny), kThreads, smem, stream>>>(
      x, ldx, idx, val, nnz, valid, ldv, cn, n, d, k, dslice, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int m = k * (d + 1);
  reduce_partials<<<(m + 255) / 256, 256, 0, stream>>>(partial, grid_x, m,
                                                       out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* kmeans_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory one block takes.
int kmeans_stats_smem_bytes(int d, int k, int dslice) {
  return (int)(smem_floats(d, k, dslice) * sizeof(float));
}

// Widest accumulator column slice that fits beside the tile; 0 if none.
int kmeans_stats_max_dslice(int d, int k) {
  const long long fixed = (long long)smem_floats(d, k, 0);
  const long long avail = kMaxSmemBytes / (long long)sizeof(float) - fixed;
  if (avail < k) return 0;
  const long long w = avail / k;
  return (int)(w < d ? w : d);
}

// x: (n, d) rows with row stride ldx (f32, or bf16 when x_bf16); valid: f32
// with stride ldv; cn: (k, d) normalised centroids in x's dtype; partial:
// (grid_x, k, d+1) f32 scratch; out: (k, d+1) f32.
int kmeans_stats_dense(const void* x, long long ldx, int x_bf16,
                       const void* valid, long long ldv, const void* cn,
                       int n, int d, int k, int grid_x, int ny, int dslice,
                       void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return launch<__nv_bfloat16, false>(
        static_cast<const __nv_bfloat16*>(x), ldx, nullptr, nullptr, 0,
        static_cast<const float*>(valid), ldv,
        static_cast<const __nv_bfloat16*>(cn), n, d, k, grid_x, ny, dslice,
        static_cast<float*>(partial), static_cast<float*>(out), s);
  return launch<float, false>(
      static_cast<const float*>(x), ldx, nullptr, nullptr, 0,
      static_cast<const float*>(valid), ldv, static_cast<const float*>(cn), n,
      d, k, grid_x, ny, dslice, static_cast<float*>(partial),
      static_cast<float*>(out), s);
}

// idx: (n, nnz) int32, val: (n, nnz) f32 (the grouped (n/G, G*nnz) layout
// is the same memory); valid: (n,) f32; cn: (k, d) normalised centroids in
// the compute dtype (bf16 when cn_bf16), to which each densified row is
// rounded.
int kmeans_stats_ell(const void* idx, const void* val, int nnz,
                     const void* valid, const void* cn, int cn_bf16, int n,
                     int d, int k, int grid_x, int ny, int dslice,
                     void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* ip = static_cast<const int*>(idx);
  const float* vp = static_cast<const float*>(val);
  const float* valp = static_cast<const float*>(valid);
  if (cn_bf16)
    return launch<__nv_bfloat16, true>(
        nullptr, 0, ip, vp, nnz, valp, 1,
        static_cast<const __nv_bfloat16*>(cn), n, d, k, grid_x, ny, dslice,
        static_cast<float*>(partial), static_cast<float*>(out), s);
  return launch<float, true>(nullptr, 0, ip, vp, nnz, valp, 1,
                             static_cast<const float*>(cn), n, d, k, grid_x,
                             ny, dslice, static_cast<float*>(partial),
                             static_cast<float*>(out), s);
}

}  // extern "C"
