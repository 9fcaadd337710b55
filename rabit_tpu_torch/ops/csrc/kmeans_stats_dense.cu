// Cosine k-means statistics pass over dense rows for Hopper (sm_90a): the
// (k, d+1) matrix of per-cluster row sums with the counts in the last
// column.
//
// Replaces the Pallas TPU kernel rabit_tpu/ops/kmeans_kernel.py:_stats_kernel
// (dense rows, kmeans_stats_fused) -> kmeans_stats_dense.  The B1 variant
// study (tools/kernel_experiments.py) has a one-pass kernel of its own,
// kmeans_stats_variant.cu; kmeans_stats.cu keeps the previous B1.
//
// Per row: similarity to every normalised centroid, the first index of the
// maximum, then the row (times its validity) added into that cluster's sum
// and the validity into its count.
//
// What bounds it on an H100: bytes.  At the main path's shape (4,194,304 x
// 256 bf16, k=64) the similarity is 137 GFLOP, 0.14 ms on the bf16 tensor
// cores, while one read of x takes 0.646 ms.  This design reads x twice
// (classify, then fold), so its own floor is twice that; in exchange
// nothing holds a whole row in shared memory and d has no limit.
//
// Three launches on one stream, no host sync:
//  (a) classify_kernel: a block takes 128 rows.  For each chunk of 64
//      centroids it loops over d in chunks of 64 features, staging x's chunk
//      and the centroids' chunk in shared memory (two buffers: cp.async
//      fills the next chunk while this one is used), and accumulates the
//      (128, 64) similarity in float32: for bf16 x on the tensor cores
//      (WMMA m16n16k16, bf16 in, float32 accumulate; bf16 products are
//      exact in float32), for float32 x on the CUDA cores with an 8-row x
//      4-centroid register tile per thread.  Padded features stage as 0;
//      padded centroids (the columns past k) are skipped.  A running (max,
//      index) per row, strict > in increasing centroid order, gives the
//      first index of the maximum across chunks.  Output: int32 assign[n].
//  (b) fold_kernel: a (column tile, row chunk) grid.  A block keeps a
//      (k, dt) float32 accumulator in shared memory; each column thread
//      owns 4 adjacent columns of the tile (1 where k leaves tiles narrower
//      than 4) and folds the chunk's rows into them in row order, one
//      vector load of x and one float4 update of the accumulator a row, with
//      the next rows' loads in flight; in column tile 0 the last warp folds
//      the counts in row order, lane l those of the clusters = l (mod 32).
//      No float atomics.  Each block writes its columns of its chunk's
//      (k, d+1) partial.
//  (c) reduce_partials: the partials summed in chunk order.  Two launches on
//      the same input give the same bits.
// x arrives with a row stride (ldx): the chained float32 dense tier passes a
// view into rows of d+1 floats.  Vector loads (and cp.async) are taken only
// where x's base and ldx allow them; other rows load element by element.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;                 // classify
constexpr int kWarps = kThreads / 32;
constexpr int kBlockRows = 128;               // rows per classify block
constexpr int kCentChunk = 64;                // centroids per similarity pass
constexpr int kFeatChunk = 64;                // features per staged chunk
constexpr int kLd16 = kFeatChunk + 8;         // bf16 stage stride (elements)
constexpr int kLd32 = kFeatChunk + 4;         // f32 stage stride (floats)
constexpr int kSimLd = kCentChunk + 4;        // similarity tile stride
constexpr int kFoldBatch = 256;               // rows staged per fold step
constexpr int kFoldCols = 4;                  // columns a fold thread owns
constexpr int kFoldMaxCols = 256;             // widest column tile
// column threads for the widest tile, + the counts warp
constexpr int kFoldMaxThreads = kFoldMaxCols / kFoldCols + 32;
constexpr int kMaxSmemBytes = 232448;         // 227 KB per block on sm_90

static_assert(kWarps * 16 == kBlockRows, "one 16-row WMMA strip a warp");
static_assert(kCentChunk == 64 && kFeatChunk == 64, "tile shapes");

constexpr int kSimBytes = kBlockRows * kSimLd * 4;
constexpr int kStage16Bytes = (kBlockRows + kFeatChunk) * kLd16 * 2;
constexpr int kStage32Bytes = (kBlockRows + kFeatChunk) * kLd32 * 4;
// stage buffers in the classify ring: chunks in flight + the one in use
constexpr int kStages = 2;

// Dynamic shared memory of the classify block: a ring of buffers of the x
// and centroid stages (later chunks fill while one is used), aliased with
// the similarity tile (they are never live together).
__host__ __device__ constexpr int classify_smem(bool bf16) {
  return kStages * (bf16 ? kStage16Bytes : kStage32Bytes) > kSimBytes
             ? kStages * (bf16 ? kStage16Bytes : kStage32Bytes)
             : kSimBytes;
}

// Dynamic shared memory of the fold block: one batch of assignments and
// validities, the (k, dt) accumulator, k counts.
__host__ __device__ inline long long fold_smem(int k, int dt) {
  return 4LL * ((long long)k * dt + k) + 8LL * kFoldBatch;
}

// Columns a fold thread owns (vector loads and accumulator updates), and
// threads a fold block: a whole warp of column threads for each 32 groups
// of the tile, then the counts warp.
__host__ __device__ inline int fold_cols(int dt) {
  return dt % kFoldCols == 0 ? kFoldCols : 1;
}
__host__ __device__ inline int fold_threads(int dt) {
  const int groups = (dt + fold_cols(dt) - 1) / fold_cols(dt);
  return (groups + 31) / 32 * 32 + 32;
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

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Stage rows [row0, row0+rows) x features [j0, j0+64) of src (row stride
// ld, rows below nrows, features below ncols) into dst (row stride dld),
// zero outside.  vec: 16-byte loads are aligned for every row; those go
// through cp.async (the caller commits and waits), the rest are loaded
// element by element and stored directly.
template <typename T, int kRowsStaged>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ld,
                                      int row0, int nrows, int j0, int ncols,
                                      bool vec, T* dst, int dld) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kSegs = kFeatChunk / kVec;
  constexpr int kPer = kRowsStaged * kSegs / kThreads;
  static_assert(kPer * kThreads == kRowsStaged * kSegs, "stage split");
  uint4 v[kPer];
  bool direct[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int r = e / kSegs, seg = e - r * kSegs;
    const int row = row0 + r, j = j0 + seg * kVec;
    v[p] = make_uint4(0u, 0u, 0u, 0u);
    direct[p] = true;
    if (row < nrows) {
      const T* s = src + (long long)row * ld + j;
      if (vec && j + kVec <= ncols) {
        cp_async16(dst + r * dld + seg * kVec, s);
        direct[p] = false;
      } else {
        // element by element, as raw bits (0 bits are +0 in both dtypes)
        unsigned int w[4] = {0u, 0u, 0u, 0u};
        if constexpr (sizeof(T) == 4) {
          const unsigned int* b = reinterpret_cast<const unsigned int*>(s);
#pragma unroll
          for (int u = 0; u < 4; ++u) w[u] = j + u < ncols ? b[u] : 0u;
        } else {
          const unsigned short* b = reinterpret_cast<const unsigned short*>(s);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            w[u / 2] |= (j + u < ncols ? (unsigned int)b[u] : 0u)
                        << (16 * (u & 1));
        }
        v[p] = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int e = threadIdx.x + p * kThreads;
    const int r = e / kSegs, seg = e - r * kSegs;
    if (direct[p])
      *reinterpret_cast<uint4*>(dst + r * dld + seg * kVec) = v[p];
  }
}

// The (128, 64) similarity of one centroid chunk into sim (row stride
// kSimLd), float32 accumulation over every feature chunk.
__device__ __forceinline__ void similarity(
    const __nv_bfloat16* __restrict__ x, long long ldx, bool xvec,
    const __nv_bfloat16* __restrict__ ct, int kp, int row0, int n, int d,
    int c0, unsigned char* smem) {
  using T = __nv_bfloat16;
  constexpr int kBuf = kStage16Bytes / 2;        // elements a buffer
  T* base = reinterpret_cast<T*>(smem);
  float* sim = reinterpret_cast<float*>(smem);
  const int warp = threadIdx.x / 32;
  // buffer b: x rows at base + b*kBuf, then the centroid chunk, transposed
  // ((d, kp) in device memory: the chunk's feature rows, columns c0 ..
  // c0+63; kp is a multiple of 64, so every load is in bounds)
  auto fill = [&](int j0, int b) {
    T* xs = base + b * kBuf;
    stage<T, kBlockRows>(x, ldx, row0, n, j0, d, xvec, xs, kLd16);
    stage<T, kFeatChunk>(ct + c0, kp, j0, d, 0, kCentChunk, true,
                         xs + kBlockRows * kLd16, kLd16);
  };
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[kCentChunk / 16];
#pragma unroll
  for (int f = 0; f < kCentChunk / 16; ++f) wmma::fill_fragment(acc[f], 0.f);
  const int nj = (d + kFeatChunk - 1) / kFeatChunk;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nj) fill(t * kFeatChunk, t);
    cp_async_commit();
  }
  for (int t = 0; t < nj; ++t) {
    // refill the buffer the previous chunk used; groups past the end are
    // empty, so once at most kStages - 1 groups are in flight, chunk t
    // has landed
    const int ahead = t + kStages - 1;
    if (ahead < nj) fill(ahead * kFeatChunk, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();
    const T* xs = base + (t % kStages) * kBuf;
    const T* cs = xs + kBlockRows * kLd16;
#pragma unroll
    for (int kk = 0; kk < kFeatChunk / 16; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::load_matrix_sync(a, xs + warp * 16 * kLd16 + kk * 16, kLd16);
#pragma unroll
      for (int f = 0; f < kCentChunk / 16; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> b;
        wmma::load_matrix_sync(b, cs + kk * 16 * kLd16 + f * 16, kLd16);
        wmma::mma_sync(acc[f], a, b, acc[f]);
      }
    }
    __syncthreads();                             // stages consumed
  }
#pragma unroll
  for (int f = 0; f < kCentChunk / 16; ++f)
    wmma::store_matrix_sync(sim + warp * 16 * kSimLd + f * 16, acc[f],
                            kSimLd, wmma::mem_row_major);
}

__device__ __forceinline__ void similarity(
    const float* __restrict__ x, long long ldx, bool xvec,
    const float* __restrict__ ct, int kp, int row0, int n, int d, int c0,
    unsigned char* smem) {
  constexpr int kBuf = kStage32Bytes / 4;        // floats a buffer
  float* base = reinterpret_cast<float*>(smem);
  float* sim = base;
  constexpr int kTx = 16, kTy = 16;
  constexpr int kRowsPer = kBlockRows / kTy;    // 8
  constexpr int kCentPer = kCentChunk / kTx;    // 4
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  float s[kRowsPer][kCentPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int q = 0; q < kCentPer; ++q) s[i][q] = 0.f;
  auto fill = [&](int j0, int b) {
    float* xs = base + b * kBuf;
    stage<float, kBlockRows>(x, ldx, row0, n, j0, d, xvec, xs, kLd32);
    stage<float, kFeatChunk>(ct + c0, kp, j0, d, 0, kCentChunk, true,
                             xs + kBlockRows * kLd32, kLd32);
  };
  const int nj = (d + kFeatChunk - 1) / kFeatChunk;
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < nj) fill(t * kFeatChunk, t);
    cp_async_commit();
  }
  for (int t = 0; t < nj; ++t) {
    const int ahead = t + kStages - 1;
    if (ahead < nj) fill(ahead * kFeatChunk, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();              // chunk t has landed
    __syncthreads();
    const float* xs = base + (t % kStages) * kBuf;
    const float* cs = xs + kBlockRows * kLd32;
#pragma unroll 2
    for (int jj = 0; jj < kFeatChunk; jj += 4) {
      float4 xv[kRowsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
        xv[i] = *reinterpret_cast<const float4*>(
            xs + (ty + kTy * i) * kLd32 + jj);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 cv = *reinterpret_cast<const float4*>(
            cs + (jj + u) * kLd32 + tx * kCentPer);
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          const float xu = u == 0 ? xv[i].x : u == 1 ? xv[i].y
                         : u == 2 ? xv[i].z : xv[i].w;
          s[i][0] = fmaf(xu, cv.x, s[i][0]);
          s[i][1] = fmaf(xu, cv.y, s[i][1]);
          s[i][2] = fmaf(xu, cv.z, s[i][2]);
          s[i][3] = fmaf(xu, cv.w, s[i][3]);
        }
      }
    }
    __syncthreads();                             // stages consumed
  }
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
    *reinterpret_cast<float4*>(sim + (ty + kTy * i) * kSimLd +
                               tx * kCentPer) =
        make_float4(s[i][0], s[i][1], s[i][2], s[i][3]);
}

// (a) assign[row] = first index of the highest similarity.
template <typename T>
__global__ void __launch_bounds__(kThreads)
classify_kernel(const T* __restrict__ x, long long ldx, int xvec,
                const T* __restrict__ ct, int kp, int n, int d, int k,
                int* __restrict__ assign) {
  extern __shared__ __align__(128) unsigned char smem[];
  const float* sim = reinterpret_cast<const float*>(smem);
  const int row0 = blockIdx.x * kBlockRows;
  // two threads a row: thread t scans centroids 2i + (t & 1) of row t / 2
  const int r = threadIdx.x >> 1, h = threadIdx.x & 1;
  float best = -INFINITY;
  int bidx = INT_MAX;
  for (int c0 = 0; c0 < k; c0 += kCentChunk) {
    similarity(x, ldx, xvec != 0, ct, kp, row0, n, d, c0, smem);
    __syncthreads();
    float bv = -INFINITY;
    int bi = INT_MAX;
#pragma unroll 8
    for (int i = 0; i < kCentChunk / 2; ++i) {
      const int c = c0 + 2 * i + h;
      const float v = sim[r * kSimLd + 2 * i + h];
      if (c < k && (v > bv || (v == bv && c < bi))) {
        bv = v;
        bi = c;
      }
    }
    const float ov = __shfl_xor_sync(0xffffffffu, bv, 1);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, 1);
    if (ov > bv || (ov == bv && oi < bi)) {
      bv = ov;
      bi = oi;
    }
    if (bv > best || (bv == best && bi < bidx)) {
      best = bv;
      bidx = bi;
    }
    __syncthreads();                             // similarity consumed
  }
  const int row = row0 + r;
  if (h == 0 && row < n) assign[row] = bidx == INT_MAX ? 0 : bidx;
}

// C adjacent elements of T as raw bits, and their float32 values.
template <typename T, int C>
struct Cols;
template <>
struct Cols<float, 4> {
  using Raw = float4;
};
template <>
struct Cols<__nv_bfloat16, 4> {
  using Raw = uint2;
};
template <>
struct Cols<float, 1> {
  using Raw = float;
};
template <>
struct Cols<__nv_bfloat16, 1> {
  using Raw = unsigned short;
};

__device__ __forceinline__ void widen(float4 v, float (&f)[4]) {
  f[0] = v.x, f[1] = v.y, f[2] = v.z, f[3] = v.w;
}
__device__ __forceinline__ void widen(uint2 v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x << 16), f[1] = __uint_as_float(v.x & 0xffff0000u);
  f[2] = __uint_as_float(v.y << 16), f[3] = __uint_as_float(v.y & 0xffff0000u);
}
__device__ __forceinline__ void widen(float v, float (&f)[1]) { f[0] = v; }
__device__ __forceinline__ void widen(unsigned short v, float (&f)[1]) {
  f[0] = __uint_as_float((unsigned int)v << 16);
}

// Columns [0, nc) of the C at p (zero past nc): one load where vec (the
// group is aligned) and nc == C, else element by element.
template <typename T, int C>
__device__ __forceinline__ typename Cols<T, C>::Raw load_cols(const T* p,
                                                              bool vec,
                                                              int nc) {
  using Raw = typename Cols<T, C>::Raw;
  if constexpr (C == 1) {
    return *reinterpret_cast<const Raw*>(p);
  } else {
    if (vec && nc == C) return *reinterpret_cast<const Raw*>(p);
    if constexpr (sizeof(T) == 4) {
      const float* q = reinterpret_cast<const float*>(p);
      return make_float4(nc > 0 ? q[0] : 0.f, nc > 1 ? q[1] : 0.f,
                         nc > 2 ? q[2] : 0.f, nc > 3 ? q[3] : 0.f);
    } else {
      const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
      const unsigned int b0 = nc > 0 ? q[0] : 0u, b1 = nc > 1 ? q[1] : 0u;
      const unsigned int b2 = nc > 2 ? q[2] : 0u, b3 = nc > 3 ? q[3] : 0u;
      return make_uint2(b0 | b1 << 16, b2 | b3 << 16);
    }
  }
}

// acc[0..C) += w * f, as one shared-memory load and store.
template <int C>
__device__ __forceinline__ void fma_cols(float* a, float w,
                                          const float (&f)[C]) {
  if constexpr (C == 4) {
    float4 v = *reinterpret_cast<float4*>(a);
    v.x = fmaf(w, f[0], v.x);
    v.y = fmaf(w, f[1], v.y);
    v.z = fmaf(w, f[2], v.z);
    v.w = fmaf(w, f[3], v.w);
    *reinterpret_cast<float4*>(a) = v;
  } else {
    *a = fmaf(w, f[0], *a);
  }
}

// (b) partial[chunk] (k, d+1): columns [js, js+jw) of this block's tile and,
// in tile 0, the counts, over rows [chunk * chunk_rows, ...).  Column thread
// t owns the C adjacent columns [C t, C t + C) of the tile; the last warp
// folds the counts, lane l those of the clusters = l (mod 32).
template <typename T, int C>
__global__ void __launch_bounds__(kFoldMaxThreads)
fold_kernel(const T* __restrict__ x, long long ldx, int xvec,
            const float* __restrict__ valid, long long ldv,
            const int* __restrict__ assign, int n, int d, int k, int dt,
            int chunk_rows, float* __restrict__ partial) {
  using Raw = typename Cols<T, C>::Raw;
  constexpr int kU = 128 / sizeof(Raw) < 16 ? 128 / sizeof(Raw) : 16;
  static_assert(kU % 4 == 0, "rows in flight come in fours");
  extern __shared__ __align__(16) float fsm[];
  int* sa = reinterpret_cast<int*>(fsm);         // kFoldBatch
  float* sv = fsm + kFoldBatch;                  // kFoldBatch
  float* acc = sv + kFoldBatch;                  // k x dt
  float* cnt = acc + (size_t)k * dt;             // k
  const int tid = threadIdx.x;
  const int col_threads = blockDim.x - 32;
  const int js = blockIdx.x * dt;
  const int jw = min(dt, d - js);
  const int j0 = tid * C;                        // this thread's columns
  const int nc = tid < col_threads ? max(0, min(C, jw - j0)) : 0;
  const bool own_counts = blockIdx.x == 0;
  const int rbeg = blockIdx.y * chunk_rows;
  const int rend = min(n, rbeg + chunk_rows);

  for (long long e = tid; e < (long long)k * dt + k; e += blockDim.x)
    acc[e] = 0.f;                                // acc, then cnt
  for (int b0 = rbeg; b0 < rend; b0 += kFoldBatch) {
    const int nb = min(kFoldBatch, rend - b0);
    __syncthreads();                             // previous batch consumed
    for (int r = tid; r < nb; r += blockDim.x) {
      sa[r] = assign[b0 + r];
      sv[r] = valid[(long long)(b0 + r) * ldv];
    }
    __syncthreads();
    if (nc > 0) {
      // kU rows at a time: the next group's loads are in flight while
      // this group folds, each row in order into its cluster's columns
      const T* xc = x + (long long)b0 * ldx + js + j0;
      Raw cur[kU], nxt[kU];
#pragma unroll
      for (int u = 0; u < kU; ++u)
        if (u < nb) cur[u] = load_cols<T, C>(xc + u * ldx, xvec != 0, nc);
      for (int r = 0; r < nb; r += kU) {
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (r + kU + u < nb)
            nxt[u] = load_cols<T, C>(xc + (long long)(r + kU + u) * ldx,
                                     xvec != 0, nc);
#pragma unroll
        for (int u = 0; u < kU; u += 4) {
          const int4 a4 = *reinterpret_cast<const int4*>(sa + r + u);
          const float4 w4 = *reinterpret_cast<const float4*>(sv + r + u);
          const int a[4] = {a4.x, a4.y, a4.z, a4.w};
          const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            if (r + u + q < nb) {
              float f[C];
              widen(cur[u + q], f);
              fma_cols<C>(acc + (size_t)a[q] * dt + j0, w[q], f);
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) cur[u] = nxt[u];
      }
    } else if (own_counts && tid >= col_threads) {
      const int lane = tid - col_threads;
      for (int r = 0; r < nb; r += 4) {
        const int4 a4 = *reinterpret_cast<const int4*>(sa + r);
        const float4 w4 = *reinterpret_cast<const float4*>(sv + r);
        const int a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float w[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (r + q < nb && (a[q] & 31) == lane) cnt[a[q]] += w[q];
      }
    }
  }
  __syncthreads();

  float* out = partial + (size_t)blockIdx.y * k * (d + 1);
  for (long long e = tid; e < (long long)k * jw; e += blockDim.x) {
    const int c = (int)(e / jw), jj = (int)(e - (long long)c * jw);
    out[(size_t)c * (d + 1) + js + jj] = acc[(size_t)c * dt + jj];
  }
  if (own_counts)
    for (int c = tid; c < k; c += blockDim.x)
      out[(size_t)c * (d + 1) + d] = cnt[c];
}

// (c) out[e] = sum of the per-chunk partials, in chunk order.
__global__ void reduce_partials(const float* __restrict__ partial,
                                int nparts, long long m,
                                float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[(size_t)p * m + e];
  out[e] = s;
}

template <typename T>
int launch(const T* x, long long ldx, const float* valid, long long ldv,
           const T* ct, int kp, int n, int d, int k, int dt, int chunks,
           int chunk_rows, int stages, int* assign, float* partial,
           float* out, cudaStream_t stream) {
  const bool bf16 = sizeof(T) == 2;
  const int tiles = dt > 0 ? (d + dt - 1) / dt : 0;
  const long long fsmem = fold_smem(k, dt);
  if (n < 1 || d < 1 || k < 1 || kp < k || kp % kCentChunk || dt < 1 ||
      dt > kFoldMaxCols ||
      chunks < 1 || chunks > 65535 || chunk_rows < 1 ||
      (long long)chunks * chunk_rows < n || fsmem > kMaxSmemBytes ||
      reinterpret_cast<uintptr_t>(ct) % 16 || (stages & ~7) ||
      (chunks == 1 && partial != out))
    return (int)cudaErrorInvalidValue;
  const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   ldx % (16 / (long long)sizeof(T)) == 0;
  cudaError_t err;
  if (stages & 1) {
    const int smem = classify_smem(bf16);
    err = cudaFuncSetAttribute(classify_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    classify_kernel<T><<<(n + kBlockRows - 1) / kBlockRows, kThreads, smem,
                         stream>>>(x, ldx, xvec, ct, kp, n, d, k, assign);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if (stages & 2) {
    // 4-column groups load as one vector where x's base and ldx align them
    const int xvec4 =
        reinterpret_cast<uintptr_t>(x) % (kFoldCols * sizeof(T)) == 0 &&
        ldx % kFoldCols == 0;
    auto fold = fold_cols(dt) == kFoldCols ? fold_kernel<T, kFoldCols>
                                           : fold_kernel<T, 1>;
    err = cudaFuncSetAttribute(fold,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)fsmem);
    if (err != cudaSuccess) return (int)err;
    fold<<<dim3(tiles, chunks), fold_threads(dt), (size_t)fsmem, stream>>>(
        x, ldx, xvec4, valid, ldv, assign, n, d, k, dt, chunk_rows,
        partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  if ((stages & 4) && chunks > 1) {
    const long long m = (long long)k * (d + 1);
    reduce_partials<<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(
        partial, chunks, m, out);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

const char* kmeans_stats_dense_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block of `stage` takes: 0 the classify
// stage (x in bf16 when x_bf16, else float32), 1 the fold stage at k
// clusters and column tile width dt.  -1 for another stage.
long long kmeans_stats_dense_smem_bytes(int stage, int x_bf16, int k,
                                        int dt) {
  if (stage == 0) return classify_smem(x_bf16 != 0);
  if (stage == 1) return fold_smem(k, dt);
  return -1;
}

// x: (n, d) rows with row stride ldx (f32, or bf16 when x_bf16); valid: f32
// with stride ldv; ct: (d, kp) normalised centroids, transposed, in x's
// dtype, columns past k zero (kp a multiple of 64, 16-byte aligned);
// assign: n int32 scratch; partial: (chunks, k, d+1) f32 scratch, or out
// itself when chunks == 1; out: (k, d+1) f32.  The fold runs on a (tiles of
// dt columns) x (chunks of chunk_rows rows) grid.  stages: bit 0 classify,
// bit 1 fold, bit 2 reduce (7 for the whole pass).
int kmeans_stats_dense(const void* x, long long ldx, int x_bf16,
                       const void* valid, long long ldv, const void* ct,
                       int kp, int n, int d, int k, int dt, int chunks,
                       int chunk_rows, int stages, void* assign,
                       void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(valid);
  int* a = static_cast<int*>(assign);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (x_bf16)
    return launch<__nv_bfloat16>(
        static_cast<const __nv_bfloat16*>(x), ldx, v, ldv,
        static_cast<const __nv_bfloat16*>(ct), kp, n, d, k, dt, chunks,
        chunk_rows, stages, a, p, o, s);
  return launch<float>(static_cast<const float*>(x), ldx, v, ldv,
                       static_cast<const float*>(ct), kp, n, d, k, dt,
                       chunks, chunk_rows, stages, a, p, o, s);
}

}  // extern "C"
