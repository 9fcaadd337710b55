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
// nothing.
//
// What bounds it on an H100: every add is a read-modify-write of a
// shared-memory histogram, one 4-byte load and one 4-byte store.  A warp
// access that hits 32 distinct banks moves 128 B a clock per SM, so no
// shared-memory scatter does better than 16 adds a clock per SM (about
// 4.2e12 adds/s on 132 SMs at 1.98 GHz): at 64 channels the 8.6e9 adds of
// a 2^21-row, 64-feature level take at least about 2 ms that way.  At a
// few channels the bytes of the bins (0.5 GB a level at 2^21 x 64) bound
// it instead.  The TPU kernel's one-hot products (a plan for its matrix
// unit) would spend 16-257x their multiply-adds on zeros: no tensor cores.
// Shared memory holds about 220 histograms of 257 slots an SM, so an SM
// has at most 6-7 warps of owners and the instructions around each add
// (reading the bin and weight, the slot's address, the range check)
// weigh as much as the add itself: the design keeps them few.
//
// Design:
//  * every lane owns one (feature, channel) histogram.  A block owns a
//    rectangle of fb features x cb channels (cb <= 32); pair
//    p = jl * cb + c (channel fastest) belongs to warp p / cols, lane
//    p % cols, so at 32 channels a warp is one feature and the bin a row
//    brings is the same for all its lanes (one broadcast read);
//  * one (nbin x cols) float matrix per warp: lane l's histogram is
//    column l, slot b at word b * cols + l, so a warp's access hits cols
//    distinct banks whatever the bins.  Where nbin x 32 floats do not fit,
//    the plan narrows cols (16, 8, ... 1) and the lanes past it idle;
//  * the block's rows come in tiles of t_rows: the int32 bins of its
//    features and the weights of its channels, each staged row padded by
//    16 bytes so that lanes reading neighbouring channels' 16-byte groups
//    hit distinct banks.  Tiles go through a ring of kStages buffers
//    filled with cp.async by all the block's threads (16-byte copies where
//    the base and n allow, element copies on the ragged edge), so the next
//    tile's reads are in flight while the current one is added;
//  * each lane walks a tile in row order, U rows a group, the next
//    group's bins and weights read before this group's slots: the slot
//    loads first, then the adds, then the stores in row order, so a slot's
//    adds happen in row order within a chunk.  A group where two rows hit
//    one slot takes the path that forwards the sum of the latest earlier
//    row.  Where the plan says that every warp is one feature's 32
//    channels (kUniform, U = 8), lane g first rewrites group g of the tile
//    in place as slot byte offsets and tests it for a repeated slot once
//    for the whole warp (a ballot), so the add loop spends no instruction
//    on either (at 32 and 64 bf16 channels 12-17% faster than the general
//    path on an NVIDIA H100 80GB HBM3 at 700 W; chip_smoke.py phase 11
//    times both).  Elsewhere U = 4: lanes of several features take the
//    repeats' path when any of them needs it;
//  * each block writes its row chunk's partial histograms and a second
//    kernel sums the partials in chunk order (one chunk writes the output
//    itself): no float atomics, the same bits on every launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxSmemBytes = 232448;      // 227 KB per block on sm_90
constexpr int kMaxWarps = 8;               // warps a block
constexpr int kRowPad = 16;                // bytes after each staged row
constexpr int kMinTileRows = 8;
constexpr int kStages = 2;                 // tiles in the cp.async ring

__host__ __device__ inline long long round16(long long b) {
  return (b + 15) / 16 * 16;
}

// Bytes of the warps' histogram matrices, and of one staged row of a
// feature's bins or a channel's weights (wsz bytes an element).
__host__ __device__ inline long long hist_bytes(int warps, int nbin,
                                                int cols) {
  return round16((long long)warps * nbin * cols * 4);
}
__host__ __device__ inline int row_bytes(int t_rows, int esz) {
  return t_rows * esz + kRowPad;
}
__host__ __device__ inline long long stage_bytes(int fb, int cb, int t_rows,
                                                 int wsz) {
  return (long long)fb * row_bytes(t_rows, 4) +
         (long long)cb * row_bytes(t_rows, wsz);
}
__host__ __device__ inline long long smem_bytes(int wsz, int nbin, int warps,
                                                int cols, int fb, int cb,
                                                int t_rows) {
  return hist_bytes(warps, nbin, cols) +
         kStages * stage_bytes(fb, cb, t_rows, wsz);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(s), "l"(src)
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

// Copy elements [0, rows) of `count` rows of src (row stride n elements)
// into dst (row stride drow bytes).  vec: every source row is 16-byte
// aligned at element 0; those 16-byte groups go through cp.async.cg, the
// rest element by element (cp.async.ca for 4-byte elements, a plain load
// and store for 2-byte ones).  The caller commits and waits.
template <typename E>
__device__ __forceinline__ void stage_rows(const E* __restrict__ src,
                                           long long n, int count, int rows,
                                           int log_t, bool vec,
                                           unsigned char* dst, int drow) {
  constexpr int kVec = 16 / sizeof(E);
  constexpr int kLogVec = sizeof(E) == 4 ? 2 : 3;
  const int log_segs = log_t - kLogVec;       // t_rows is a power of two
  for (int i = threadIdx.x; i < count << log_segs; i += blockDim.x) {
    const int k = i >> log_segs;
    const int e = (i & ((1 << log_segs) - 1)) * kVec;
    if (e >= rows) continue;
    const E* s = src + (long long)k * n + e;
    E* d = reinterpret_cast<E*>(dst + (size_t)k * drow) + e;
    if (vec && e + kVec <= rows) {
      cp_async16(d, s);
    } else {
      for (int u = 0; u < kVec && e + u < rows; ++u) {
        if constexpr (sizeof(E) == 4)
          cp_async4(d + u, s + u);
        else
          d[u] = s[u];
      }
    }
  }
}

// kUnroll consecutive staged bins.
template <int kUnroll>
__device__ __forceinline__ void load_bins(const int* p, int* b) {
#pragma unroll
  for (int q = 0; q < kUnroll; q += 4) {
    const int4 x = *reinterpret_cast<const int4*>(p + q);
    b[q] = x.x;
    b[q + 1] = x.y;
    b[q + 2] = x.z;
    b[q + 3] = x.w;
  }
}

// A histogram slot's load and store.  Volatile, so that they stay in
// program order: a group's loads come after the last group's stores.
__device__ __forceinline__ float lds(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// Whether two of kUnroll bins are equal.
template <int kUnroll>
__device__ __forceinline__ bool has_dup(const int* b) {
  bool dup = false;
#pragma unroll
  for (int u = 1; u < kUnroll; ++u)
#pragma unroll
    for (int q = 0; q < u; ++q) dup |= b[q] == b[u];
  return dup;
}

// kUnroll consecutive staged weights of one channel as floats.
template <int kUnroll>
__device__ __forceinline__ void load_weights(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < kUnroll; q += 4) {
    const float4 x = *reinterpret_cast<const float4*>(p + q);
    v[q] = x.x;
    v[q + 1] = x.y;
    v[q + 2] = x.z;
    v[q + 3] = x.w;
  }
}
template <int kUnroll>
__device__ __forceinline__ void load_weights(const __nv_bfloat16* p,
                                             float* v) {
  // bf16 -> f32 is exact: the bf16 bits are the f32's high half
  if constexpr (kUnroll == 8) {
    const uint4 x = *reinterpret_cast<const uint4*>(p);
    const unsigned int w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[2 * q] = __uint_as_float(w[q] << 16);
      v[2 * q + 1] = __uint_as_float(w[q] & 0xffff0000u);
    }
  } else {
    const uint2 x = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(x.x << 16);
    v[1] = __uint_as_float(x.x & 0xffff0000u);
    v[2] = __uint_as_float(x.y << 16);
    v[3] = __uint_as_float(x.y & 0xffff0000u);
  }
}

template <typename T, bool kUniform>
__global__ void __launch_bounds__(kMaxWarps * 32)
hist_partial(const int32_t* __restrict__ bins_t, long long n,
             const T* __restrict__ w, int f, int nw, int nbin, int cols,
             int fb, int cb, int t_rows, long long chunk_rows, int vec_bins,
             int vec_w, float* __restrict__ partial) {
  constexpr int kUnroll = kUniform ? 8 : 4;   // rows a group
  extern __shared__ __align__(16) unsigned char smem[];
  const int warps = blockDim.x / 32;
  float* hist = reinterpret_cast<float*>(smem);
  unsigned char* ring = smem + hist_bytes(warps, nbin, cols);
  const int brow = row_bytes(t_rows, 4);
  const int wrow = row_bytes(t_rows, sizeof(T));
  const long long sbytes = stage_bytes(fb, cb, t_rows, sizeof(T));

  const int j0 = blockIdx.x * fb;
  const int fb_here = min(fb, f - j0);
  const int c0 = blockIdx.y * cb;
  const int cb_here = min(cb, nw - c0);
  const long long r_begin = (long long)blockIdx.z * chunk_rows;
  const long long r_end = min(n, r_begin + chunk_rows);
  const int ntiles = (int)((r_end - r_begin + t_rows - 1) / t_rows);
  const int log_t = __ffs(t_rows) - 1;

  float4* h4 = reinterpret_cast<float4*>(hist);
  const int words = (int)(hist_bytes(warps, nbin, cols) / 16);
  for (int i = threadIdx.x; i < words; i += blockDim.x)
    h4[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p = warp * cols + lane;
  const bool owner = lane < cols && p < fb_here * cb_here;
  const int jl = owner ? p / cb_here : 0;
  const int c = owner ? p - jl * cb_here : 0;
  float* own = hist + (size_t)warp * nbin * cols + lane;
  // the lane's column as a shared-memory address, its slots stride apart
  const unsigned own_s = (unsigned)__cvta_generic_to_shared(own);
  const unsigned stride = 4u * cols;
  const unsigned top = (unsigned)(nbin - 1);

  const int32_t* bsrc = bins_t + (long long)j0 * n;
  const T* wsrc = w + (long long)c0 * n;
  auto issue = [&](int t) {
    const long long r0 = r_begin + (long long)t * t_rows;
    const int rows = (int)min((long long)t_rows, r_end - r0);
    unsigned char* slot = ring + (t % kStages) * sbytes;
    stage_rows(bsrc + r0, n, fb_here, rows, log_t, vec_bins != 0, slot,
               brow);
    stage_rows(wsrc + r0, n, cb_here, rows, log_t, vec_w != 0,
               slot + (size_t)fb * brow, wrow);
    // rows past the chunk's end: bin -1, which adds nothing
    const int tail = t_rows - rows;
    for (int i = threadIdx.x; i < fb_here * tail; i += blockDim.x) {
      const int k = i / tail;
      reinterpret_cast<int*>(slot + (size_t)k * brow)[rows + i - k * tail] =
          -1;
    }
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < ntiles) issue(s);
    cp_async_commit();
  }
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<kStages - 2>();   // tile t has landed (this thread's part)
    __syncthreads();                // ... every thread's; tile t-1 consumed
    if (t + kStages - 1 < ntiles) issue(t + kStages - 1);
    cp_async_commit();              // empty groups keep the count uniform
    if (!owner) continue;
    const unsigned char* slot = ring + (t % kStages) * sbytes;
    const int* sb = reinterpret_cast<const int*>(slot + (size_t)jl * brow);
    const T* sw = reinterpret_cast<const T*>(slot + (size_t)fb * brow +
                                             (size_t)c * wrow);
    const int rows =
        (int)min((long long)t_rows, r_end - r_begin - (long long)t * t_rows);
    // kUniform: the warp's lanes share one feature, so lane g prepares
    // group g of the tile once for all of them: each bin becomes its slot's
    // byte offset in a lane's column (an out-of-range bin: the last slot's
    // offset + 4, a load address that no in-range bin shares), and the
    // group is flagged where two of its rows share a slot
    unsigned dups = 0;
    if constexpr (kUniform) {
      bool dup = false;
      if (lane * kUnroll < t_rows) {
        int* gb = const_cast<int*>(sb) + lane * kUnroll;
        int bb[kUnroll];
        load_bins<kUnroll>(gb, bb);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          bb[u] = (unsigned)bb[u] <= top ? bb[u] * 128 : top * 128 + 4;
        dup = has_dup<kUnroll>(bb);
#pragma unroll
        for (int q = 0; q < kUnroll; q += 4)
          *reinterpret_cast<int4*>(gb + q) =
              make_int4(bb[q], bb[q + 1], bb[q + 2], bb[q + 3]);
      }
      dups = __ballot_sync(0xffffffffu, dup);
      __syncwarp();
    }
    // one group of kUnroll rows: every slot loaded (an out-of-range bin
    // loads a slot it does not store), added, then the in-range ones
    // stored in row order; where two rows of the group hit one slot the
    // later row adds to the earlier one's sum
    auto add = [&](const int* b, const float* v, bool dup) {
      unsigned at[kUnroll];
      float h[kUnroll], s[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        at[u] = own_s + (kUniform ? b[u] : min((unsigned)b[u], top) * stride);
        h[u] = lds(at[u]);
      }
      if (!dup) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) s[u] = h[u] + v[u];
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          float acc = h[u];
#pragma unroll
          for (int q = 0; q < u; ++q)
            if (b[q] == b[u]) acc = s[q];     // the latest earlier hit
          s[u] = acc + v[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (kUniform ? (b[u] & 127) == 0 : (unsigned)b[u] <= top)
          sts(at[u], s[u]);
    };
    auto group_dup = [&](const int* b, int g) {
      return kUniform ? ((dups >> g) & 1u) != 0 : has_dup<kUnroll>(b);
    };
    // two groups in flight: the next group's bins and weights are read
    // before this one's slots (past the tile's end: its last group again)
    const int groups = (rows + kUnroll - 1) / kUnroll;
    const int last = t_rows - kUnroll;
    int b0[kUnroll], b1[kUnroll];
    float v0[kUnroll], v1[kUnroll];
    load_bins<kUnroll>(sb, b0);
    load_weights<kUnroll>(sw, v0);
    for (int g = 0; g < groups; g += 2) {
      const int r1 = min((g + 1) * kUnroll, last);
      load_bins<kUnroll>(sb + r1, b1);
      load_weights<kUnroll>(sw + r1, v1);
      add(b0, v0, group_dup(b0, g));
      if (g + 1 == groups) break;
      const int r2 = min((g + 2) * kUnroll, last);
      load_bins<kUnroll>(sb + r2, b0);
      load_weights<kUnroll>(sw + r2, v0);
      add(b1, v1, group_dup(b1, g + 1));
    }
  }
  cp_async_wait<0>();
  if (!owner) return;
  // each lane writes its own column: partial[chunk][c][j][b]
  float* dst = partial + (size_t)blockIdx.z * nw * f * nbin +
               ((size_t)(c0 + c) * f + j0 + jl) * nbin;
  for (int bb = 0; bb < nbin; ++bb) dst[bb] = own[(size_t)bb * cols];
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

template <typename T, bool kUniform>
cudaError_t start(dim3 grid, int warps, size_t smem, cudaStream_t stream,
                  const int32_t* bins_t, long long n, const T* w, int f,
                  int nw, int nbin, int cols, int fb, int cb, int t_rows,
                  long long chunk_rows, int vec_bins, int vec_w,
                  float* partial) {
  auto kernel = hist_partial<T, kUniform>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, warps * 32, smem, stream>>>(bins_t, n, w, f, nw, nbin, cols,
                                             fb, cb, t_rows, chunk_rows,
                                             vec_bins, vec_w, partial);
  return cudaGetLastError();
}

template <typename T>
int launch(const int32_t* bins_t, long long n, int f, const T* w, int nw,
           int nbin, int warps, int cols, int fb, int cb, int t_rows,
           bool uniform, long long chunk_rows, int n_chunks, float* partial,
           float* out, cudaStream_t stream) {
  const long long smem =
      smem_bytes(sizeof(T), nbin, warps, cols, fb, cb, t_rows);
  const int groups_c = (nw + cb - 1) / cb;
  const int unroll = uniform ? 8 : 4;
  if (n < 1 || f < 1 || nw < 1 || nbin < 1 || warps < 1 ||
      warps > kMaxWarps || cols < 1 || cols > 32 || (cols & (cols - 1)) ||
      fb < 1 || fb > f || cb < 1 || cb > nw || cb > 32 ||
      fb * cb > warps * cols || t_rows < kMinTileRows ||
      (t_rows & (t_rows - 1)) || t_rows % unroll || t_rows > 32 * unroll ||
      // the uniform path needs every owner warp to be one feature's 32
      // channels in every block
      (uniform && (cols != 32 || cb != 32 || nw % 32)) || chunk_rows < 1 || chunk_rows % t_rows || n_chunks < 1 ||
      n_chunks > 65535 || groups_c > 65535 ||
      (long long)n_chunks * chunk_rows < n ||
      (long long)(n_chunks - 1) * chunk_rows >= n || smem > kMaxSmemBytes)
    return (int)cudaErrorInvalidValue;
  // 16-byte copies need every staged row 16-byte aligned at its start
  const bool vec_bins = n % 4 == 0 && (uintptr_t)bins_t % 16 == 0;
  const bool vec_w = n % (16 / sizeof(T)) == 0 && (uintptr_t)w % 16 == 0;
  const dim3 grid((f + fb - 1) / fb, groups_c, n_chunks);
  float* dst = n_chunks == 1 ? out : partial;
#define HIST_START(UNI)                                                  \
  start<T, UNI>(grid, warps, smem, stream, bins_t, n, w, f, nw, nbin, cols, \
                fb, cb, t_rows, chunk_rows, vec_bins, vec_w, dst)
  cudaError_t err = uniform ? HIST_START(true) : HIST_START(false);
#undef HIST_START
  if (err != cudaSuccess || n_chunks == 1) return (int)err;
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

// Bytes of dynamic shared memory a block takes: `warps` histogram
// matrices of nbin x cols floats, and kStages tiles of t_rows rows of fb
// features' int32 bins and cb channels' weights (bf16 when w_bf16, else
// f32), each staged row padded by 16 bytes.
long long gbdt_hist_smem_bytes(int w_bf16, int nbin, int warps, int cols,
                               int fb, int cb, int t_rows) {
  return smem_bytes(w_bf16 ? 2 : 4, nbin, warps, cols, fb, cb, t_rows);
}

// bins_t: (f, n) int32; w: (nw, n) f32, or bf16 when w_bf16.  A block of
// `warps` warps owns fb features x cb channels (fb * cb <= warps * cols,
// cb <= 32), cols histograms a warp, and chunk_rows rows, staged t_rows (a
// power of two, at most 32 groups) at a time through a ring of kStages
// tiles.  uniform: every owner warp is one feature's 32 channels (cols ==
// cb == 32, nw a multiple of 32), added 8 rows a group with the tile's bins
// prepared once for the warp; else 4 rows a group.  partial: (n_chunks,
// nw, f, nbin) f32 scratch (unused when n_chunks == 1); out: (nw, f, nbin)
// f32.
int gbdt_hist(const void* bins_t, long long n, int f, const void* w,
              int w_bf16, int nw, int nbin, int warps, int cols, int fb,
              int cb, int t_rows, int uniform, long long chunk_rows,
              int n_chunks, void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* b = static_cast<const int32_t*>(bins_t);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (w_bf16)
    return launch<__nv_bfloat16>(b, n, f, static_cast<const __nv_bfloat16*>(w),
                                 nw, nbin, warps, cols, fb, cb, t_rows,
                                 uniform != 0, chunk_rows, n_chunks, p, o, s);
  return launch<float>(b, n, f, static_cast<const float*>(w), nw, nbin, warps,
                       cols, fb, cb, t_rows, uniform != 0, chunk_rows,
                       n_chunks, p, o, s);
}

}  // extern "C"
