// Cosine k-means statistics pass over dense rows for Hopper (sm_90a): the
// (k, d+1) matrix of per-cluster row sums with the counts in the last
// column.
//
// Replaces the Pallas TPU kernel rabit_tpu/ops/kmeans_kernel.py:_stats_kernel
// (dense rows, kmeans_stats_fused) -> kmeans_stats_dense.  The padded-ELL
// kernel (_ell_stats_kernel) has a sparse design of its own, in
// kmeans_ell_stats.cu.
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
//  * when the (k, d) accumulator does not fit beside the tile, the columns
//    split over gridDim.y and each column slice recomputes the similarity.
//
// The B1 variant study (tools/kernel_experiments.py, kernels from
// build_kernel, calls at :138 and :157) swaps the classify stage of the
// dense kernel and keeps every other line; here the stage is the template
// parameter kMode of stats_kernel, and the production kernels are its
// kArgmax instantiations, whose code the other modes do not touch.  The
// modes and what they add into the (k, d+1) output:
//   kArgmax    the production stage: the row (times validity) into the
//              first cluster of highest similarity;
//   kMaxcmp    into every cluster whose similarity equals the row maximum;
//   kSimonly   into every cluster with weight clip(sim, 0, 1) * validity;
//   kNovalid   kArgmax without the validity weight;
//   kArgmaxT   kArgmax (on the TPU only the one-hot's layout differs);
//   kSimonlyT  into every cluster with weight validity;
//   kCheapT    into cluster (row % block) % k, no argmax.
// Where the JAX body casts its one-hot to the input dtype before the sums
// product, the weighted modes round each weight to T for the sums and keep
// it unrounded for the counts.  The ...T modes with a keep-alive anchor
// (kSimonlyT, kCheapT) add sum_rows sim[row, 0] to every count: the TPU
// adds one such sum per block of rows, which is the same sum regrouped.
// The weighted modes (kMaxcmp, kSimonly, kSimonlyT) keep a (kRows, k)
// weight tile beside the row tile and do k FMAs per element of the tile,
// as the TPU did its full (k, block) x (block, d) product.
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

enum Mode {
  kArgmax = 0, kMaxcmp, kSimonly, kNovalid, kArgmaxT, kSimonlyT, kCheapT,
  kModes
};

__host__ __device__ constexpr bool weighted(int m) {
  return m == kMaxcmp || m == kSimonly || m == kSimonlyT;
}
__host__ __device__ constexpr bool keeps(int m) {
  return m == kSimonlyT || m == kCheapT;
}
__host__ __device__ constexpr bool argmaxes(int m) {
  return m == kArgmax || m == kMaxcmp || m == kNovalid || m == kArgmaxT;
}

__host__ __device__ inline size_t smem_floats(int d, int k, int dslice,
                                              int mode) {
  return (size_t)kRows * (d + 1) + (size_t)kDimChunk * kStageLd +
         (size_t)k * dslice + (size_t)k + 2 * kRows +
         (weighted(mode) ? (size_t)kRows * (k + 1) : 0) +
         (keeps(mode) ? (size_t)kTy : 0);
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

// T is x's dtype, the compute dtype.  kMode is the classify stage (kArgmax
// in production); block is the row block of kCheapT's assignment.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
stats_kernel(const T* __restrict__ x, long long ldx,
             const float* __restrict__ valid, long long ldv,
             const T* __restrict__ cn, int n, int d, int k, int dslice,
             int block, float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int ldt = d + 1;                         // odd stride: fewer conflicts
  float* tile = smem;                            // kRows x ldt
  float* cstage = tile + (size_t)kRows * ldt;    // kDimChunk x kStageLd
  float* acc = cstage + kDimChunk * kStageLd;    // k x dslice
  float* cnt = acc + (size_t)k * dslice;         // k
  float* vrow = cnt + k;                         // kRows
  int* assign = reinterpret_cast<int*>(vrow + kRows);  // kRows
  // weighted modes: (kRows, k) weights, then kRows row maxima
  float* wt = reinterpret_cast<float*>(assign + kRows);
  float* rowmax = wt + kRows * k;
  // keep-alive modes: one partial of sum sim[row, 0] per thread row
  float* keepbuf = wt + (weighted(kMode) ? kRows * (k + 1) : 0);
  float keep = 0.f;

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
    for (int e = tid; e < kRows * d; e += kThreads) {
      const int r = e / d, j = e - r * d;
      const int row = row0 + r;
      tile[r * ldt + j] = row < n ? to_f(x[(long long)row * ldx + j]) : 0.f;
    }
    if (tid < kRows) {
      const int row = row0 + tid;
      if constexpr (kMode == kNovalid)
        vrow[tid] = row < n ? 1.f : 0.f;
      else
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

      if constexpr (weighted(kMode)) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int q = 0; q < kCentPerThread; ++q) {
            const int c = c0 + tx + kTx * q;
            if (c < k) wt[(ty + kTy * i) * k + c] = s[i][q];
          }
      }
      if constexpr (keeps(kMode)) {
        if (c0 == 0 && tx == 0) {
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            if (row0 + ty + kTy * i < n) keep += s[i][0];
        }
      }
      if constexpr (!argmaxes(kMode)) continue;
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
    if constexpr (kMode == kCheapT) {
      if (tid < kRows) assign[tid] = ((row0 + tid) % block) % k;
    } else if constexpr (kMode == kMaxcmp) {
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          rowmax[ty + kTy * i] = best[i];
      }
    } else if constexpr (!weighted(kMode)) {
      if (tx == 0) {
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          assign[ty + kTy * i] = bidx[i] == INT_MAX ? 0 : bidx[i];
      }
    }
    __syncthreads();

    if constexpr (weighted(kMode)) {
      // 3'. weights from the similarities, counts from the unrounded
      // weights, then the sums from the weights rounded to T
      for (int e = tid; e < kRows * k; e += kThreads) {
        const int r = e / k;
        float w;
        if constexpr (kMode == kMaxcmp)
          w = wt[e] >= rowmax[r] ? 1.f : 0.f;
        else if constexpr (kMode == kSimonly)
          w = fminf(fmaxf(wt[e], 0.f), 1.f);
        else
          w = 1.f;
        wt[e] = w * vrow[r];
      }
      __syncthreads();
      if (own_counts) {
        for (int c = tid; c < k; c += kThreads) {
          float s = cnt[c];
          for (int r = 0; r < kRows; ++r) s += wt[r * k + c];
          cnt[c] = s;
        }
      }
      __syncthreads();
      for (int e = tid; e < kRows * k; e += kThreads)
        wt[e] = round_to<T>(wt[e]);
      __syncthreads();
      for (int jj = tid; jj < jw; jj += kThreads) {
        const int j = js + jj;
        for (int r = 0; r < kRows; ++r) {
          const float xv = tile[r * ldt + j];
          const float* wr = wt + r * k;
          for (int c = 0; c < k; ++c) {
            float* a = acc + (size_t)c * dslice + jj;
            *a = fmaf(wr[c], xv, *a);
          }
        }
      }
      continue;
    }

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
  if constexpr (keeps(kMode)) {
    if (tx == 0) keepbuf[ty] = keep;
  }
  __syncthreads();

  float* out = partial + (size_t)blockIdx.x * k * (d + 1);
  for (int e = tid; e < k * jw; e += kThreads) {
    const int c = e / jw, jj = e - c * jw;
    out[(size_t)c * (d + 1) + js + jj] = acc[(size_t)c * dslice + jj];
  }
  if (own_counts) {
    if constexpr (keeps(kMode)) {
      float kept = 0.f;
      for (int i = 0; i < kTy; ++i) kept += keepbuf[i];
      for (int c = tid; c < k; c += kThreads)
        out[(size_t)c * (d + 1) + d] = cnt[c] + kept;
    } else {
      for (int c = tid; c < k; c += kThreads)
        out[(size_t)c * (d + 1) + d] = cnt[c];
    }
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

template <typename T, int kMode = kArgmax>
int launch(const T* x, long long ldx, const float* valid, long long ldv,
           const T* cn, int n, int d, int k, int grid_x, int ny, int dslice,
           float* partial, float* out, cudaStream_t stream, int block = 1) {
  const size_t smem = smem_floats(d, k, dslice, kMode) * sizeof(float);
  if (n < 1 || d < 1 || k < 1 || grid_x < 1 || ny < 1 || dslice < 1 ||
      (long long)ny * dslice < d || smem > (size_t)kMaxSmemBytes ||
      block < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      stats_kernel<T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  stats_kernel<T, kMode><<<dim3(grid_x, ny), kThreads, smem, stream>>>(
      x, ldx, valid, ldv, cn, n, d, k, dslice, block, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int m = k * (d + 1);
  reduce_partials<<<(m + 255) / 256, 256, 0, stream>>>(partial, grid_x, m,
                                                       out);
  return (int)cudaGetLastError();
}

template <typename T, int kMode>
int launch_variant(const void* x, long long ldx, const void* valid,
                   long long ldv, const void* cn, int n, int d, int k,
                   int block, int grid_x, int ny, int dslice, void* partial,
                   void* out, cudaStream_t s) {
  return launch<T, kMode>(
      static_cast<const T*>(x), ldx, static_cast<const float*>(valid), ldv,
      static_cast<const T*>(cn), n, d, k, grid_x, ny, dslice,
      static_cast<float*>(partial), static_cast<float*>(out), s, block);
}

template <typename T>
int dispatch_variant(int mode, const void* x, long long ldx,
                     const void* valid, long long ldv, const void* cn, int n,
                     int d, int k, int block, int grid_x, int ny, int dslice,
                     void* partial, void* out, cudaStream_t s) {
#define RABIT_VARIANT(M)                                                   \
  case M:                                                                  \
    return launch_variant<T, M>(x, ldx, valid, ldv, cn, n, d, k, block,    \
                                grid_x, ny, dslice, partial, out, s);
  switch (mode) {
    RABIT_VARIANT(kArgmax)
    RABIT_VARIANT(kMaxcmp)
    RABIT_VARIANT(kSimonly)
    RABIT_VARIANT(kNovalid)
    RABIT_VARIANT(kArgmaxT)
    RABIT_VARIANT(kSimonlyT)
    RABIT_VARIANT(kCheapT)
  }
#undef RABIT_VARIANT
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* kmeans_stats_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory one block of classify stage `mode` takes
// (0 is the production stage).
int kmeans_stats_smem_bytes(int d, int k, int dslice, int mode) {
  return (int)(smem_floats(d, k, dslice, mode) * sizeof(float));
}

// Widest accumulator column slice that fits beside the tile; 0 if none.
int kmeans_stats_max_dslice(int d, int k, int mode) {
  const long long fixed = (long long)smem_floats(d, k, 0, mode);
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
    return launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), ldx,
        static_cast<const float*>(valid), ldv,
        static_cast<const __nv_bfloat16*>(cn), n, d, k, grid_x, ny, dslice,
        static_cast<float*>(partial), static_cast<float*>(out), s);
  return launch<float>(
      static_cast<const float*>(x), ldx, static_cast<const float*>(valid), ldv,
      static_cast<const float*>(cn), n, d, k, grid_x, ny, dslice,
      static_cast<float*>(partial), static_cast<float*>(out), s);
}

// The dense kernel with classify stage `mode` (Mode above; 0 is the
// production kmeans_stats_dense); block is kCheapT's row block.  Other
// arguments as kmeans_stats_dense.
int kmeans_stats_variant(int mode, const void* x, long long ldx, int x_bf16,
                         const void* valid, long long ldv, const void* cn,
                         int n, int d, int k, int block, int grid_x, int ny,
                         int dslice, void* partial, void* out,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_bf16)
    return dispatch_variant<__nv_bfloat16>(mode, x, ldx, valid, ldv, cn, n,
                                           d, k, block, grid_x, ny, dslice,
                                           partial, out, s);
  return dispatch_variant<float>(mode, x, ldx, valid, ldv, cn, n, d, k,
                                 block, grid_x, ny, dslice, partial, out, s);
}

}  // extern "C"
