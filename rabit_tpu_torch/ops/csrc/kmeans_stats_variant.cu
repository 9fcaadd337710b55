// The B1 variant study on Hopper (sm_90a): one pass over dense rows that
// computes the (k, d+1) matrix of weighted per-cluster row sums, with the
// weight sums in the last column, for one of seven classify stages.
//
// Replaces the Pallas TPU kernels of tools/kernel_experiments.py: the
// transposed-one-hot bodies of make_kernel_t (pl.pallas_call at :138) and
// the bodies of build_kernel (pl.pallas_call at :157).  Each runs two
// matrix products on one staged row tile, sim = x . cn^T and then
// sums += w^T . x, and the study swaps only the classify stage between
// them; here that stage is the template parameter kMode and every other
// line is shared.  The stages, and the weight w[r, c] each gives a row r:
//   kArgmax    valid[r] on the first index of the row's maximum;
//   kMaxcmp    valid[r] on every cluster with sim >= the row maximum;
//   kSimonly   clip(sim, 0, 1) * valid[r] on every cluster;
//   kNovalid   kArgmax without the validity weight;
//   kArgmaxT   kArgmax, with w stored transposed (below);
//   kSimonlyT  valid[r] on every cluster;
//   kCheapT    valid[r] on cluster (row % block) % k, no argmax.
// The sums product takes w rounded to x's dtype, as the JAX bodies cast it;
// the counts take w unrounded.  kSimonlyT and kCheapT add the block's
// sum of sim[:, 0] (the JAX bodies' keep-alive anchor) to every count: the
// TPU adds one such sum per row block, which is the same sum regrouped.
// The TPU's transposed one-hot becomes the layout of the sums product's A
// operand: the non-T stages store w as (rows x k) and load it column-major,
// the T stages store w^T as (k x rows) and load it row-major.
//
// What bounds it on an H100: bytes.  At the study's shape (524,288 x 256
// bf16, k=64) one read of x is 0.081 ms at 3.35 TB/s, while the two
// products are 4 n k d = 34 GFLOP, 0.035 ms on the bf16 tensor cores.  So
// x is read from device memory once and each row tile feeds both products
// from shared memory.
//
// Design:
//  * a persistent grid of one block per SM (256 threads) walks tiles of 64
//    rows; the (d, kp) centroids, transposed, padded to kp in {32, 64, 128}
//    columns, sit in shared memory for the whole block where they fit, else
//    come with each chunk of x;
//  * each tile arrives as chunks of 64 features through a cp.async ring,
//    `prefetch` (up to 4) chunks ahead across tile boundaries.  Chunks in
//    the block's column slice land in one of two slice buffers (one per
//    tile parity) and stay there for the sums product; the other chunks
//    use a ring;
//  * product 1, the (64, kp) float32 similarity, accumulates over the
//    chunks: for bf16 x on the tensor cores (mma.sync m16n8k16, bf16 in,
//    float32 accumulate, operands by ldmatrix; bf16 products are exact in
//    float32), each warp 16 rows x kp / 2 clusters; for float32 x, and
//    for kSimonly in bf16, on the CUDA cores, one sequential FMA chain a
//    (row, cluster), features in order (the plain version's bits).
//    kSimonly's weights round clip(sim) to bf16, so a similarity one
//    float32 ulp away from the plain version's (the tensor cores sum in
//    another order) moves a weight by a bf16 ulp, and enough of those
//    move the sums past the bar.  The other stages decide on order and
//    ties only, which the tensor cores' similarity keeps;
//  * the classify stage reads the similarity from shared memory: row
//    maxima and first indices (4 threads a row), then each thread weights
//    one cluster column over a quarter (kp=64) of the rows and keeps its
//    counts in a register;
//  * product 2, sums += w^T . slice, goes into a (kp, ds) float32
//    accumulator held in registers over all of the block's tiles (64 a
//    thread: kp * ds <= 16384): for bf16 on the tensor cores, each warp a
//    32 x 64 block, each tile's product summed from 0 in the tensor cores
//    and then added in float32 (the tensor cores' own accumulation over a
//    block's thousands of rows drifts well past float32's); for float32
//    on the CUDA cores, each thread 8
//    clusters x 8 columns, each tile's product summed from 0 and then
//    added, as on the tensor cores;
//  * where (kp, d) does not fit, d splits into column slices on gridDim.y,
//    each recomputing the similarity, as the previous kernel did;
//  * each block writes its (k, d+1) partial and a second launch sums the
//    partials in block order, 8 at a time: no float atomics, so two
//    launches on the same input give the same bits.
// Ragged n, d and k are masked here: rows past n and features past d stage
// as 0, centroid columns past k are 0 and never win.  x may be a strided
// view (ldx); 16-byte copies are taken only where its base and ldx allow.
// Launch plan: rabit_tpu_torch/ops/kmeans_kernel.py:_variant_plan, which
// restates the layout below.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;                     // rows a tile
constexpr int kChunk = 64;                    // features a staged chunk
constexpr int kMinKp = 32;                    // centroid columns, padded
constexpr int kMaxKp = 128;
constexpr int kAccElems = 16384;              // kp * ds: 64 floats a thread
constexpr int kMaxPrefetch = 4;               // chunks in flight
constexpr int kSimPad = 4;                    // similarity tile stride pad
constexpr int kAlign = 128;                   // shared-memory region start
constexpr int kMaxSmemBytes = 232448;         // 227 KB a block on sm_90

static_assert(kRows == 64 && kThreads == 256, "warp and thread layouts");

enum Mode {
  kArgmax = 0, kMaxcmp, kSimonly, kNovalid, kArgmaxT, kSimonlyT, kCheapT
};

__host__ __device__ constexpr bool transposed(int m) { return m >= kArgmaxT; }
__host__ __device__ constexpr bool keeps(int m) {
  return m == kSimonlyT || m == kCheapT;
}
__host__ __device__ constexpr bool argmaxes(int m) {
  return m == kArgmax || m == kMaxcmp || m == kNovalid || m == kArgmaxT;
}

// Row stride pad of the staged x and centroid buffers: 16 bytes, so that
// rows start on other banks and every row stays 16-byte aligned.
__host__ __device__ constexpr int stage_pad(int es) { return 16 / es; }

__host__ __device__ inline long long align_up(long long v) {
  return (v + kAlign - 1) / kAlign * kAlign;
}

// Byte offsets of the shared-memory regions, in order: resident
// centroids, the two slice buffers, the x ring (several slices only), the
// centroid ring (centroids not resident only), the similarity tile, the
// weight tile (either layout), per-row scalars, per-thread counts.
struct Layout {
  long long ct, slice, xring, cring, sim, w, rows, cnt, total;
};

__host__ __device__ inline Layout layout(int es, int kp, int d, int ds,
                                         int ny, int resident, int prefetch) {
  const int pad = stage_pad(es);
  const long long dp = (d + kChunk - 1) / kChunk * kChunk;
  const long long nr = prefetch + 1;
  const long long wn = (long long)kRows * (kp + pad) > (long long)kp *
                       (kRows + pad) ? (long long)kRows * (kp + pad)
                                     : (long long)kp * (kRows + pad);
  Layout L;
  long long o = 0;
  L.ct = o;
  if (resident) o = align_up(o + dp * (kp + pad) * es);
  L.slice = o;
  o = align_up(o + 2LL * kRows * (ds + pad) * es);
  L.xring = o;
  if (ny > 1) o = align_up(o + nr * kRows * (kChunk + pad) * es);
  L.cring = o;
  if (!resident) o = align_up(o + nr * kChunk * (kp + pad) * es);
  L.sim = o;
  o = align_up(o + (long long)kRows * (kp + kSimPad) * 4);
  L.w = o;
  o = align_up(o + wn * es);
  L.rows = o;
  o = align_up(o + 3LL * kRows * 4);          // validity, row max, assignment
  L.cnt = o;
  o = align_up(o + (kThreads + 1) * 4LL);     // per-thread counts, keep
  L.total = o;
  return L;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   smem_u32(dst)),
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

__device__ __forceinline__ void cp_async_wait_dyn(int n) {
  if (n >= 4)
    cp_async_wait<4>();
  else if (n == 3)
    cp_async_wait<3>();
  else if (n == 2)
    cp_async_wait<2>();
  else if (n == 1)
    cp_async_wait<1>();
  else
    cp_async_wait<0>();
}

// Stage rows [row0, row0 + rows) x columns [col0, col0 + cols) of src (row
// stride ld; rows from nrows on and columns from ncols on are 0) into dst
// (row stride dld).  cols / (16-byte vector) is the power of two 1 << sh.
// vec: the rows' 16-byte segments are aligned, so whole segments in range
// go through cp.async (the caller commits and waits); the rest are read
// element by element, as raw bits, and stored directly.
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ src, long long ld,
                                      int row0, int nrows, int rows, int col0,
                                      int ncols, int sh, bool vec, T* dst,
                                      int dld) {
  constexpr int kVec = 16 / sizeof(T);
  for (int e = threadIdx.x; e < rows << sh; e += kThreads) {
    const int r = e >> sh, sg = e & ((1 << sh) - 1);
    const int row = row0 + r, j = col0 + sg * kVec;
    T* to = dst + r * dld + sg * kVec;
    const T* s = src + (long long)row * ld + j;
    if (row < nrows && vec && j + kVec <= ncols) {
      cp_async16(to, s);
      continue;
    }
    unsigned int w[4] = {0u, 0u, 0u, 0u};
    if (row < nrows) {
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
    }
    *reinterpret_cast<uint4*>(to) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The Q (2, 4 or 8) elements at p, aligned to Q elements (float32: at
// most 16 bytes), as float32 (exact) in f[0, Q).
template <int Q>
__device__ __forceinline__ void loadq(const float* p, float* f) {
  if constexpr (Q == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    f[0] = v.x, f[1] = v.y;
  } else {
#pragma unroll
    for (int u = 0; u < Q; u += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + u);
      f[u] = v.x, f[u + 1] = v.y, f[u + 2] = v.z, f[u + 3] = v.w;
    }
  }
}
template <int Q>
__device__ __forceinline__ void loadq(const __nv_bfloat16* p, float* f) {
  unsigned int w[4];
  if constexpr (Q == 2) {
    w[0] = *reinterpret_cast<const unsigned int*>(p);
  } else if constexpr (Q == 4) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
  }
#pragma unroll
  for (int u = 0; u < Q / 2; ++u) {
    f[2 * u] = __uint_as_float(w[u] << 16);
    f[2 * u + 1] = __uint_as_float(w[u] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Four 8x8 b16 matrices from shared memory into r[0..3]: lane l gives a
// row address of matrix l / 8; kTrans transposes each matrix.
template <bool kTrans>
__device__ __forceinline__ void ldsm4(unsigned (&r)[4], const void* p) {
  if constexpr (kTrans)
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
        "[%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
  else
    asm volatile(
        "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
        : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
        : "r"(smem_u32(p))
        : "memory");
}

// d += a (16 x 16 bf16) . b (16 x 8 bf16), float32: lane l holds d at rows
// l / 4 (d[0..1]) and l / 4 + 8 (d[2..3]), columns 2 (l % 4) + {0, 1}.
__device__ __forceinline__ void mma16816(float (&d)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The 16 x 16 A operand at (m0, k0) of a row-major (m, k) matrix, stride ld.
__device__ __forceinline__ void load_a_rows(unsigned (&a)[4],
                                            const __nv_bfloat16* p, int ld,
                                            int m0, int k0) {
  const int l = threadIdx.x % 32;
  ldsm4<false>(a, p + (m0 + l % 16) * ld + k0 + (l / 16) * 8);
}

// The same from a (k, m) matrix stored row-major (A column-major).
__device__ __forceinline__ void load_a_cols(unsigned (&a)[4],
                                            const __nv_bfloat16* p, int ld,
                                            int m0, int k0) {
  const int l = threadIdx.x % 32, mat = l / 8;
  ldsm4<true>(a, p + (k0 + l % 8 + (mat / 2) * 8) * ld + m0 + (mat % 2) * 8);
}

// Two 16 x 8 B operands at (k0, n0) and (k0, n0 + 8) of a row-major (k, n)
// matrix, stride ld: b[0..1] and b[2..3].
__device__ __forceinline__ void load_b(unsigned (&b)[4],
                                       const __nv_bfloat16* p, int ld, int k0,
                                       int n0) {
  const int l = threadIdx.x % 32;
  ldsm4<true>(b, p + (k0 + l % 16) * ld + n0 + (l / 16) * 8);
}

// Per-thread state of product 1 on the tensor cores (bf16 x): mma.sync
// m16n8k16 fragments fed by ldmatrix.  Warp w takes rows 16 (w % 4) .. +16
// and clusters (w / 4) kp / 2 .. +kp / 2, as kp / 16 tiles of 8 columns.
struct MmaSim {
  using T = __nv_bfloat16;
  float sim[8][4];

  __device__ void sim_zero() {
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sim[n][e] = 0.f;
  }

  // sim += xs (64 x 64 chunk, stride ldx) . cs (64 x kp chunk, stride ldc)
  __device__ void sim_step(const T* xs, int ldx, const T* cs, int ldc,
                           int kp) {
    const int warp = threadIdx.x / 32;
    const int r0 = (warp % 4) * 16, c0 = (warp / 4) * (kp / 2);
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      unsigned a[4];
      load_a_rows(a, xs, ldx, r0, kk * 16);
#pragma unroll
      for (int pr = 0; pr < 4; ++pr) {
        if (pr < kp / 32) {
          unsigned b[4];
          load_b(b, cs, ldc, kk * 16, c0 + pr * 16);
          mma16816(sim[2 * pr], a, b[0], b[1]);
          mma16816(sim[2 * pr + 1], a, b[2], b[3]);
        }
      }
    }
  }

  __device__ void sim_store(float* s, int lds, int kp) {
    const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
    const int r = (warp % 4) * 16 + l / 4;
    const int c0 = (warp / 4) * (kp / 2) + (l % 4) * 2;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      if (n < kp / 16) {
        *reinterpret_cast<float2*>(s + r * lds + c0 + n * 8) =
            make_float2(sim[n][0], sim[n][1]);
        *reinterpret_cast<float2*>(s + (r + 8) * lds + c0 + n * 8) =
            make_float2(sim[n][2], sim[n][3]);
      }
    }
  }
};

// Per-thread state of product 1 on the CUDA cores, x staged as T (float32,
// or bf16 taken exactly as float32): one fmaf chain a (row, cluster), the
// features in order over the chunks.  Thread (ty, tx) = (tid / 16, tid %
// 16) takes rows 4 ty .. +4 and clusters NQ tx .. +NQ (NQ = kp / 16), so
// that a row's 4 features and a feature's NQ clusters are one load each.
template <typename T>
struct FmaSim {
  float sim[4][8];

  __device__ void sim_zero() {
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q) sim[i][q] = 0.f;
  }

  // sim += xs (64 x 64 chunk, stride ldx) . cs (64 x kp chunk, stride ldc)
  template <int NQ>
  __device__ void sim_chunk(const T* xs, int ldx, const T* cs, int ldc) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    const T* xb = xs + 4 * ty * ldx;
    const T* cb = cs + NQ * tx;
#pragma unroll 2
    for (int f = 0; f < kChunk; f += 4) {
      float xv[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) loadq<4>(xb + i * ldx + f, xv[i]);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float cv[NQ];
        loadq<NQ>(cb + (f + u) * ldc, cv);
#pragma unroll
        for (int q = 0; q < NQ; ++q)
#pragma unroll
          for (int i = 0; i < 4; ++i)
            sim[i][q] = fmaf(xv[i][u], cv[q], sim[i][q]);
      }
    }
  }

  __device__ void sim_step(const T* xs, int ldx, const T* cs, int ldc,
                           int kp) {
    if (kp == 32)
      sim_chunk<2>(xs, ldx, cs, ldc);
    else if (kp == 64)
      sim_chunk<4>(xs, ldx, cs, ldc);
    else
      sim_chunk<8>(xs, ldx, cs, ldc);
  }

  __device__ void sim_store(float* s, int lds, int kp) {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16, nq = kp / 16;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (q < nq) s[(4 * ty + i) * lds + nq * tx + q] = sim[i][q];
  }
};

// Per-thread state of product 2, sums += w^T . slice.  bf16: mma.sync
// m16n8k16 fragments fed by ldmatrix; float32: register tiles on the CUDA
// cores.
template <typename T>
struct Sums;

template <>
struct Sums<__nv_bfloat16> {
  using T = __nv_bfloat16;
  // warp w < (kp / 32) * (ds / 64) takes clusters 32 bi .. +32 (two
  // 16-row tiles) and columns 64 bj .. +64 (eight 8-column tiles)
  float acc[2][8][4];

  __device__ void init() {
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][n][e] = 0.f;
  }

  // acc += w^T (kp x 64) . xsl (64 x ds, stride ldsl); w as stored by the
  // classify stage: (rows x kp) when !kT, (kp x rows) when kT, stride ldw.
  // Each tile's product is summed from 0 and then added in float32.
  template <bool kT>
  __device__ void sums_step(const T* w, int ldw, const T* xsl, int ldsl,
                            int kp, int ds) {
    const int warp = threadIdx.x / 32;
    const int nbi = kp / 32;
    if (warp >= nbi * (ds / 64)) return;
    const int bi = warp % nbi, bj = warp / nbi;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int m0 = bi * 32 + u * 16;
      float t[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) t[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kRows / 16; ++kk) {
        unsigned a[4];
        if constexpr (kT)
          load_a_rows(a, w, ldw, m0, kk * 16);
        else
          load_a_cols(a, w, ldw, m0, kk * 16);
#pragma unroll
        for (int pr = 0; pr < 4; ++pr) {
          unsigned b[4];
          load_b(b, xsl, ldsl, kk * 16, bj * 64 + pr * 16);
          mma16816(t[2 * pr], a, b[0], b[1]);
          mma16816(t[2 * pr + 1], a, b[2], b[3]);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[u][n][e] += t[n][e];
    }
  }

  // out[c, js + j] = acc for c < k, j < jw (row stride ldo)
  __device__ void store(float* out, long long ldo, int js, int jw, int k,
                        int kp, int ds) {
    const int warp = threadIdx.x / 32, l = threadIdx.x % 32;
    const int nbi = kp / 32;
    if (warp >= nbi * (ds / 64)) return;
    const int bi = warp % nbi, bj = warp / nbi;
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = bi * 32 + u * 16 + l / 4 + (e / 2) * 8;
          const int j = bj * 64 + n * 8 + (l % 4) * 2 + e % 2;
          if (c < k && j < jw) out[c * ldo + js + j] = acc[u][n][e];
        }
  }
};

template <>
struct Sums<float> {
  using T = float;
  // thread (cy, cx) = (tid / cx_n, tid % cx_n), cy_n = kp / 8 threads
  // along the clusters, cx_n = 256 / cy_n along the columns, takes clusters
  // cy + cy_n a (a < 8) and columns 4 cx + u, 4 cx + 4 cx_n + u
  float acc[8][8];

  __device__ void init() {
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  }

  // acc += w^T . xsl, the tile's product summed from 0 and then added
  template <bool kT>
  __device__ void sums_step(const T* w, int ldw, const T* xsl, int ldsl,
                            int kp, int ds) {
    const int cyn = kp / 8, cxn = kThreads / cyn;
    const int cx = threadIdx.x % cxn, cy = threadIdx.x / cxn;
    float t[8][8];
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) t[a][b] = 0.f;
#pragma unroll 4
    for (int r = 0; r < kRows; ++r) {
      float wv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) {
        const int c = cy + cyn * a;
        wv[a] = kT ? w[c * ldw + r] : w[r * ldw + c];
      }
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int j0 = 4 * cx + 4 * cxn * b;
        if (j0 < ds) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xsl + r * ldsl + j0);
#pragma unroll
          for (int a = 0; a < 8; ++a) {
            t[a][4 * b + 0] = fmaf(wv[a], xv.x, t[a][4 * b + 0]);
            t[a][4 * b + 1] = fmaf(wv[a], xv.y, t[a][4 * b + 1]);
            t[a][4 * b + 2] = fmaf(wv[a], xv.z, t[a][4 * b + 2]);
            t[a][4 * b + 3] = fmaf(wv[a], xv.w, t[a][4 * b + 3]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < 8; ++a)
#pragma unroll
      for (int b = 0; b < 8; ++b) acc[a][b] += t[a][b];
  }

  __device__ void store(float* out, long long ldo, int js, int jw, int k,
                        int kp, int ds) {
    const int cyn = kp / 8, cxn = kThreads / cyn;
    const int cx = threadIdx.x % cxn, cy = threadIdx.x / cxn;
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      const int c = cy + cyn * a;
#pragma unroll
      for (int b = 0; b < 8; ++b) {
        const int j = 4 * cx + 4 * cxn * (b / 4) + b % 4;
        if (c < k && j < jw) out[c * ldo + js + j] = acc[a][b];
      }
    }
  }
};

// partial[blockIdx.x] (k, d+1): columns [js, js + ds) of the block's rows'
// weighted sums, and (blockIdx.y == 0) their weight sums in column d.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads, 1)
variant_kernel(const T* __restrict__ x, long long ldx, int xvec,
               const float* __restrict__ valid, long long ldv,
               const T* __restrict__ ct, int n, int d, int k, int kp,
               int ds, int resident, int prefetch, int block,
               float* __restrict__ partial) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int es = sizeof(T);
  constexpr int pad = stage_pad(es);
  constexpr bool kT = transposed(kMode);
  const int ny = gridDim.y;
  const Layout L = layout(es, kp, d, ds, ny, resident, prefetch);
  T* ct_s = reinterpret_cast<T*>(smem + L.ct);
  T* slice = reinterpret_cast<T*>(smem + L.slice);
  T* xring = reinterpret_cast<T*>(smem + L.xring);
  T* cring = reinterpret_cast<T*>(smem + L.cring);
  float* sim = reinterpret_cast<float*>(smem + L.sim);
  T* wt = reinterpret_cast<T*>(smem + L.w);
  float* vrow = reinterpret_cast<float*>(smem + L.rows);
  float* rmax = vrow + kRows;
  int* assign = reinterpret_cast<int*>(rmax + kRows);
  float* cnt_s = reinterpret_cast<float*>(smem + L.cnt);

  const int tid = threadIdx.x, lane = tid % 32;
  const int lsl = ds + pad;                     // slice buffer stride
  const int lxr = kChunk + pad;                 // x ring stride
  const int ldc = kp + pad;                     // centroid stride
  const int lsim = kp + kSimPad;
  const int ldw = kT ? kRows + pad : kp + pad;
  const int nr = prefetch + 1;
  const int nj = (d + kChunk - 1) / kChunk;     // chunks a row
  const int js = blockIdx.y * ds;               // this block's column slice
  const int jw = min(ds, d - js);
  const int jc0 = js / kChunk, jc1 = jc0 + ds / kChunk;
  const int ntiles = (n + kRows - 1) / kRows;
  const int bx = blockIdx.x, gx = gridDim.x;
  const int mytiles = bx < ntiles ? (ntiles - 1 - bx) / gx + 1 : 0;
  const int steps = mytiles * nj;

  // slice columns no chunk of this slice reaches stay 0
  {
    unsigned int* z = reinterpret_cast<unsigned int*>(slice);
    const int words = 2 * kRows * lsl * es / 4;
    for (int e = tid; e < words; e += kThreads) z[e] = 0u;
  }
  __syncthreads();

  // 16-byte segments a row of an x chunk and of the centroids, as shifts
  const int xsh = __ffs(kChunk * es / 16) - 1, csh = __ffs(kp * es / 16) - 1;
  // chunk j of the block's tile i, in ring slot `slot`
  auto chunk_x = [&](int i, int j, int slot, int& ld) -> T* {
    if (j >= jc0 && j < jc1) {
      ld = lsl;
      return slice + (i & 1) * kRows * lsl + (j - jc0) * kChunk;
    }
    ld = lxr;
    return xring + slot * kRows * lxr;
  };
  int li = 0, lj = 0, lslot = 0;                // the next load's position
  auto load_next = [&]() {
    if (li < mytiles) {
      int ld;
      T* dst = chunk_x(li, lj, lslot, ld);
      stage<T>(x, ldx, (bx + li * gx) * kRows, n, kRows, lj * kChunk, d, xsh,
               xvec != 0, dst, ld);
      if (!resident)
        stage<T>(ct, kp, lj * kChunk, d, kChunk, 0, kp, csh, true,
                 cring + lslot * kChunk * ldc, ldc);
    }
    cp_async_commit();
    if (++lj == nj) lj = 0, ++li;
    if (++lslot == nr) lslot = 0;
  };

  if (resident)                                 // in load 0's group
    stage<T>(ct, kp, 0, d, nj * kChunk, 0, kp, csh, true, ct_s, ldc);
  for (int q = 0; q < prefetch; ++q) load_next();

  // product 1 on the tensor cores for bf16 x, except kSimonly's (above)
  using Sim = std::conditional_t<es == 2 && kMode != kSimonly, MmaSim,
                                 FmaSim<T>>;
  Sim ps;
  Sums<T> p;
  p.init();
  float cnt = 0.f, keep = 0.f, vnext = 0.f;
  int i = 0, j = 0, slot = 0;                   // this step's position
  for (int q = 0; q < steps; ++q) {
    const int row0 = (bx + i * gx) * kRows;
    __syncthreads();                            // step q-1's buffers read
    load_next();
    cp_async_wait_dyn(prefetch);                // chunk q has landed
    __syncthreads();
    if (j == 0) {
      ps.sim_zero();
      if (tid < kRows) {
        const int row = row0 + tid;
        vnext = row >= n ? 0.f
                : kMode == kNovalid ? 1.f
                                    : valid[(long long)row * ldv];
      }
    }
    int ldxs;
    const T* xs = chunk_x(i, j, slot, ldxs);
    const T* cs = resident ? ct_s + (size_t)j * kChunk * ldc
                           : cring + slot * kChunk * ldc;
    ps.sim_step(xs, ldxs, cs, ldc, kp);
    if (++slot == nr) slot = 0;
    if (++j < nj) continue;
    j = 0;

    // the tile's similarity is complete: classify, then the sums product
    ps.sim_store(sim, lsim, kp);
    if (tid < kRows) vrow[tid] = vnext;
    __syncthreads();
    if constexpr (argmaxes(kMode)) {
      // 4 threads a row: the first index of the maximum over c < k
      const int r = tid / 4, h = tid % 4;
      float bv = -INFINITY;
      int bi = INT_MAX;
#pragma unroll 8
      for (int t = 0; t < kp / 4; ++t) {
        const int c = h + 4 * t;
        const float v = sim[r * lsim + c];
        if (c < k && v > bv) {
          bv = v;
          bi = c;
        }
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
          bv = ov;
          bi = oi;
        }
      }
      if (h == 0) {
        rmax[r] = bv;
        assign[r] = bi == INT_MAX ? 0 : bi;
      }
    } else if constexpr (kMode == kCheapT) {
      if (tid < kRows) assign[tid] = ((row0 + tid) % block) % k;
    }
    if constexpr (keeps(kMode)) {
      if (tid < 32) {                           // sum of sim[:, 0], a tree
        float s = sim[lane * lsim] + sim[(lane + 32) * lsim];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          s += __shfl_xor_sync(0xffffffffu, s, off);
        keep += s;                              // rows past n add +0
      }
    }
    __syncthreads();
    {
      // thread: cluster c = tid % kp, rows g, g + 256/kp, ...
      const int c = tid % kp, g = tid / kp, step = kThreads / kp;
#pragma unroll 8
      for (int t = 0; t < kRows / step; ++t) {
        const int r = g + step * t;
        const float v = sim[r * lsim + c];
        float w;
        if constexpr (kMode == kMaxcmp)
          w = c < k && v >= rmax[r] ? vrow[r] : 0.f;
        else if constexpr (kMode == kSimonly)
          w = c < k ? fminf(fmaxf(v, 0.f), 1.f) * vrow[r] : 0.f;
        else if constexpr (kMode == kSimonlyT)
          w = c < k ? vrow[r] : 0.f;
        else
          w = c == assign[r] ? vrow[r] : 0.f;
        cnt += w;
        wt[kT ? c * ldw + r : r * ldw + c] = from_f<T>(w);
      }
    }
    __syncthreads();
    p.template sums_step<kT>(wt, ldw, slice + (i & 1) * kRows * lsl, lsl,
                             kp, ds);
    ++i;
  }
  cp_async_wait<0>();
  __syncthreads();

  float* out = partial + (size_t)blockIdx.x * k * (d + 1);
  p.store(out, d + 1, js, jw, k, kp, ds);
  cnt_s[tid] = cnt;
  if (tid == 0) cnt_s[kThreads] = keep;
  __syncthreads();
  if (blockIdx.y == 0) {
    for (int c = tid; c < k; c += kThreads) {
      float s = 0.f;
      for (int g = 0; g < kThreads / kp; ++g) s += cnt_s[g * kp + c];
      if constexpr (keeps(kMode)) s += cnt_s[kThreads];
      out[(size_t)c * (d + 1) + d] = s;
    }
  }
}

// out[e] = sum of the per-block partials, in block order, 8 at a time.
__global__ void reduce_partials(const float* __restrict__ partial,
                                int nparts, long long m,
                                float* __restrict__ out) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= m) return;
  float s = 0.f;
  for (int p0 = 0; p0 < nparts; p0 += 8) {
    float g = 0.f;
#pragma unroll
    for (int p = p0; p < p0 + 8; ++p)
      if (p < nparts) g += partial[(size_t)p * m + e];
    s += g;
  }
  out[e] = s;
}

template <typename T, int kMode>
int launch(const void* xv, long long ldx, const float* valid, long long ldv,
           const void* ctv, int n, int d, int k, int kp, int block,
           int grid_x, int ny, int ds, int resident, int prefetch,
           float* partial, float* out, cudaStream_t stream) {
  const T* x = static_cast<const T*>(xv);
  const T* ct = static_cast<const T*>(ctv);
  const int nj = (d + kChunk - 1) / kChunk;
  const int ntiles = (n + kRows - 1) / kRows;
  if (n < 1 || d < 1 || k < 1 || k > kp || kp < kMinKp || kp > kMaxKp ||
      (kp & (kp - 1)) || ds < kChunk || ds % kChunk ||
      (long long)kp * ds > kAccElems || ny < 1 || ny > 65535 ||
      (long long)ny * ds < d || (long long)(ny - 1) * ds >= d ||
      prefetch < 1 || prefetch > kMaxPrefetch || prefetch > nj ||
      grid_x < 1 || grid_x > ntiles || block < 1 ||
      reinterpret_cast<uintptr_t>(ct) % 16)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      layout(sizeof(T), kp, d, ds, ny, resident, prefetch).total;
  if (smem > kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  const int xvec = reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   ldx % (16 / (long long)sizeof(T)) == 0;
  cudaError_t err = cudaFuncSetAttribute(
      variant_kernel<T, kMode>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  variant_kernel<T, kMode><<<dim3(grid_x, ny), kThreads, (size_t)smem,
                             stream>>>(x, ldx, xvec, valid, ldv, ct, n, d, k,
                                       kp, ds, resident, prefetch, block,
                                       partial);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long m = (long long)k * (d + 1);
  reduce_partials<<<(unsigned)((m + 255) / 256), 256, 0, stream>>>(
      partial, grid_x, m, out);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int mode, const void* x, long long ldx, const float* valid,
             long long ldv, const void* ct, int n, int d, int k, int kp,
             int block, int grid_x, int ny, int ds, int resident,
             int prefetch, float* partial, float* out, cudaStream_t s) {
#define RABIT_VARIANT(M)                                                    \
  case M:                                                                   \
    return launch<T, M>(x, ldx, valid, ldv, ct, n, d, k, kp, block, grid_x, \
                        ny, ds, resident, prefetch, partial, out, s);
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

const char* kmeans_stats_variant_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block takes: x in bf16 when x_bf16,
// else float32; kp padded centroid columns; column slices of ds over ny;
// centroids resident or streamed; prefetch chunks in flight.
long long kmeans_stats_variant_smem_bytes(int x_bf16, int kp, int d, int ds,
                                          int ny, int resident,
                                          int prefetch) {
  return layout(x_bf16 ? 2 : 4, kp, d, ds, ny, resident, prefetch).total;
}

// mode: the classify stage (Mode above, the order of
// kmeans_kernel.py:VARIANTS); x: (n, d) rows with row stride ldx (f32, or
// bf16 when x_bf16); valid: f32 with stride ldv; ct: (d, kp) normalised
// centroids, transposed, in x's dtype, columns past k zero, 16-byte
// aligned; block: kCheapT's row block; a (grid_x, ny) grid of column
// slices ds wide; resident, prefetch as for the shared memory above;
// partial: (grid_x, k, d+1) f32 scratch; out: (k, d+1) f32.
int kmeans_stats_variant(int mode, const void* x, long long ldx, int x_bf16,
                         const void* valid, long long ldv, const void* ct,
                         int n, int d, int k, int kp, int block, int grid_x,
                         int ny, int ds, int resident, int prefetch,
                         void* partial, void* out, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* v = static_cast<const float*>(valid);
  float* p = static_cast<float*>(partial);
  float* o = static_cast<float*>(out);
  if (x_bf16)
    return dispatch<__nv_bfloat16>(mode, x, ldx, v, ldv, ct, n, d, k, kp,
                                   block, grid_x, ny, ds, resident, prefetch,
                                   p, o, s);
  return dispatch<float>(mode, x, ldx, v, ldv, ct, n, d, k, kp, block,
                         grid_x, ny, ds, resident, prefetch, p, o, s);
}

}  // extern "C"
