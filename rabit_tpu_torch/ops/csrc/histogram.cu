// GBDT gradient histograms for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rabit_tpu/ops/histogram_kernel.py
// _hist_kernel (launched by _hist_multi, public hist_fused_multi):
//
//   out[c, j, b] = sum_r w[c, r] * [bins_t[j, r] == b]
//
// for nw <= 64 weight channels c, f features j and nbin slots b, from the
// transposed (f, n) int32 bins and the (nw, n) weights (f32, or bf16 that
// the wrapper rounded), summed in f32.  A bin outside [0, nbin) adds
// nothing and is never written.
//
// What bounds it on an H100: one f32 add per (channel, feature, row), so at
// 64 channels the 8.6e9 adds of a 2^21-row, 64-feature level outweigh the
// 0.8 GB of bins and weights; at 2 channels the bytes dominate.  This first
// version is bound by neither: every add is a read-modify-write of a
// shared-memory histogram, and since a histogram has one owner thread (no
// atomics), the card holds only as many owners as histograms fit in shared
// memory (about 220 at 257 slots), so latency bounds it.
//
// Design:
//  * the TPU kernel's hi x lo one-hot matmuls (a plan to feed the MXU) have
//    no counterpart: this is a scatter into small histograms;
//  * grid (feature groups, channel groups, row chunks); a block owns fb
//    features x cb channels (about square, so that each staged bin and
//    weight feeds several adds), one thread per (feature, channel) pair
//    with the channel fastest, and one f32 histogram per pair in shared
//    memory whose stride is odd, so the channels of a warp at one bin hit
//    distinct banks; slot nbin is a trash slot where out-of-range bins and
//    padded rows land;
//  * a tile of kTileRows rows of the block's bins and of its channels'
//    weights (transposed, odd row stride) is staged in shared memory with
//    coalesced reads, then each owner walks it in row order;
//  * each owner loads kUnroll histogram slots at once and forwards the sum
//    of an earlier row of the group that hit the same slot, so the adds of
//    a slot still happen in row order while distinct slots overlap;
//  * each block writes its partial (chunk) histograms to scratch, and a
//    second kernel sums the partials in chunk order: no float atomics, the
//    same bits on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;              // owners and stagers
constexpr int kTileRows = 32;              // rows per staged tile
constexpr int kUnroll = 8;                 // rows per read-modify-write group
constexpr int kMaxSmemBytes = 232448;      // 227 KB per block on sm_90

static_assert(kTileRows % kUnroll == 0, "tile rows");

// Floats of one (feature, channel) histogram: nbin slots and the trash
// slot, rounded up to an odd count.
__host__ __device__ inline int hist_stride(int nbin) { return (nbin + 1) | 1; }

__host__ __device__ inline size_t smem_words(int fb, int cb, int nbin) {
  return (size_t)fb * cb * hist_stride(nbin)      // histograms
         + (size_t)fb * (kTileRows + 1)          // bins tile, padded rows
         + (size_t)kTileRows * (cb | 1);          // weights tile, transposed
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
hist_partial(const int32_t* __restrict__ bins_t, long long n,
             const T* __restrict__ w, int f, int nw, int nbin, int fb, int cb,
             long long chunk_rows, float* __restrict__ partial) {
  extern __shared__ float smem[];
  const int stride = hist_stride(nbin);
  const int ws = cb | 1;
  const int bs = kTileRows + 1;
  float* hist = smem;
  int* s_bins = reinterpret_cast<int*>(hist + (size_t)fb * cb * stride);
  float* s_w = reinterpret_cast<float*>(s_bins + (size_t)fb * bs);

  const int j0 = blockIdx.x * fb;
  const int fb_here = min(fb, f - j0);
  const int c0 = blockIdx.y * cb;
  const int cb_here = min(cb, nw - c0);
  const int pairs = fb_here * cb_here;
  const long long r_begin = (long long)blockIdx.z * chunk_rows;
  const long long r_end = min(n, r_begin + chunk_rows);

  for (int i = threadIdx.x; i < fb * cb * stride; i += blockDim.x)
    hist[i] = 0.f;

  const int t = threadIdx.x;
  const int jl = t / cb_here;
  const int c = t - jl * cb_here;
  float* own = hist + (size_t)t * stride;
  const int* own_bins = s_bins + jl * bs;

  for (long long r0 = r_begin; r0 < r_end; r0 += kTileRows) {
    const int rows = (int)min((long long)kTileRows, r_end - r0);
    __syncthreads();                 // the last tile is consumed
    for (int i = threadIdx.x; i < fb_here * kTileRows; i += blockDim.x) {
      const int jj = i / kTileRows, rr = i - jj * kTileRows;
      s_bins[jj * bs + rr] =
          rr < rows ? bins_t[(long long)(j0 + jj) * n + r0 + rr] : nbin;
    }
    for (int i = threadIdx.x; i < cb_here * kTileRows; i += blockDim.x) {
      const int cc = i / kTileRows, rr = i - cc * kTileRows;
      s_w[rr * ws + cc] =
          rr < rows ? to_f(w[(long long)(c0 + cc) * n + r0 + rr]) : 0.f;
    }
    __syncthreads();
    if (t < pairs) {
      for (int r = 0; r < kTileRows; r += kUnroll) {
        int b[kUnroll];
        float v[kUnroll], h[kUnroll], s[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int x = own_bins[r + u];
          b[u] = (unsigned)x < (unsigned)nbin ? x : nbin;
          v[u] = s_w[(r + u) * ws + c];
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) h[u] = own[b[u]];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float acc = h[u];
#pragma unroll
          for (int p = 0; p < u; ++p)
            if (b[p] == b[u]) acc = s[p];       // the latest earlier hit
          s[u] = acc + v[u];
        }
        // in row order: where two rows hit one slot the later sum lands last
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) own[b[u]] = s[u];
      }
    }
  }
  __syncthreads();
  // partial[chunk][c][j][b], written along b
  float* dst = partial + (size_t)blockIdx.z * nw * f * nbin;
  for (int i = threadIdx.x; i < pairs * nbin; i += blockDim.x) {
    const int pair = i / nbin, bb = i - pair * nbin;
    const int jj = pair / cb_here, cc = pair - jj * cb_here;
    dst[((size_t)(c0 + cc) * f + j0 + jj) * nbin + bb] =
        hist[(size_t)pair * stride + bb];
  }
}

// out[e] = sum of the chunk partials, in chunk order.
__global__ void fold_partials(const float* __restrict__ partial, int nparts,
                              long long m, float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float s = 0.f;
  for (int p = 0; p < nparts; ++p) s += partial[(size_t)p * m + e];
  out[e] = s;
}

template <typename T>
int launch(const int32_t* bins_t, long long n, int f, const T* w, int nw,
           int nbin, int fb, int cb, long long chunk_rows, int n_chunks,
           float* partial, float* out, cudaStream_t stream) {
  const size_t smem = smem_words(fb, cb, nbin) * sizeof(float);
  if (n < 1 || f < 1 || nw < 1 || nbin < 1 || fb < 1 || cb < 1 ||
      cb > nw || chunk_rows < 1 || n_chunks < 1 || n_chunks > 65535 ||
      (long long)n_chunks * chunk_rows < n || fb * cb > kThreads ||
      smem > (size_t)kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      hist_partial<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((f + fb - 1) / fb, (nw + cb - 1) / cb, n_chunks);
  hist_partial<T><<<grid, kThreads, smem, stream>>>(
      bins_t, n, w, f, nw, nbin, fb, cb, chunk_rows, partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)nw * f * nbin;
  fold_partials<<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(
      partial, n_chunks, m, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

const char* gbdt_hist_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// bins_t: (f, n) int32; w: (nw, n) f32, or bf16 when w_bf16; a block
// owns fb features x cb channels (fb * cb <= 256) and chunk_rows rows;
// partial: (n_chunks, nw, f, nbin) f32 scratch; out: (nw, f, nbin) f32.
int gbdt_hist(const void* bins_t, long long n, int f, const void* w,
              int w_bf16, int nw, int nbin, int fb, int cb,
              long long chunk_rows, int n_chunks, void* partial, void* out,
              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* b = static_cast<const int32_t*>(bins_t);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (w_bf16)
    return launch<__nv_bfloat16>(b, n, f, static_cast<const __nv_bfloat16*>(w),
                                 nw, nbin, fb, cb, chunk_rows, n_chunks, p,
                                 o, s);
  return launch<float>(b, n, f, static_cast<const float*>(w), nw, nbin, fb,
                       cb, chunk_rows, n_chunks, p, o, s);
}

}  // extern "C"
