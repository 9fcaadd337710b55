// Ring allreduce over logical ranks on one card, for Hopper (sm_90a), as
// one pass that folds every rank's element in the ring's order.
//
// Replaces the Pallas TPU kernel rabit_tpu/ops/ring_allreduce.py:_ring_kernel
// (wrapper ring_allreduce_pallas): ndev-1 reduce-scatter hops, then ndev-1
// all-gather hops, SUM/MAX/MIN/PROD, on a payload laid out in ndev chunks of
// `chunk` elements (128-aligned, rounded by the wrapper's segmenting).
//
// Why no hops: on one card every rank's buffer lies in the same device
// memory, so the ring's hops, flags and waits buy nothing.  Its result is
// fixed by arithmetic: element p falls in chunk c = p / chunk, whose
// reduce-scatter starts at rank c and folds rank c+1, c+2, ... in turn, each
// hop computing combine(mine, incoming).  So
//     acc = x_c[p];  for j in 1..ndev-1:  acc = combine(x_{(c+j) % ndev}[p], acc)
// is every rank's final element, bit for bit (bfloat16 rounded at every
// step, as each hop rounds), and the all-gather only copies it out.
//
// What bounds it on an H100: bytes.  Each input element is read once and
// each result written once to every rank's output row: 2 * ndev * size
// elements, the least any allreduce that leaves a copy on every rank can
// move.  No arithmetic is worth counting.
//
// Design:
//  * inputs are read in place through a __grid_constant__ table of the
//    ranks' pointers; the output is one (ndev, ld_out) buffer whose rows
//    are 16-byte aligned;
//  * a 1-D grid strides over 16-byte vectors of the `size` real elements;
//    chunks are multiples of 128 elements, so a vector never straddles two
//    chunks.  Padding is never touched.  A scalar loop covers the tail and,
//    when any rank's pointer is not 16-byte aligned, everything;
//  * a thread loads the vectors of up to 8 ranks before folding them, so
//    loads are in flight together rather than one per combine;
//  * NaN: MAX and MIN propagate NaN as jnp.maximum/jnp.minimum do (fmaxf and
//    fminf would drop it).  bfloat16 combines in float32 and rounds each
//    step to bfloat16, as jnp.add on bfloat16 does.  int32 SUM and PROD wrap.
//
// Across cards the same fold reads its peers over NVLink; it then needs
// one start barrier on system-scope flags so that every rank's input is
// ready (ROADMAP.md A6).  Here the stream orders the inputs' writers before
// the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;            // 2048 threads an SM
constexpr int kMaxRanks = 64;
constexpr int kBatch = 8;                  // ranks loaded before folding

enum Op { kMax = 0, kMin = 1, kSum = 2, kProd = 3 };   // ReduceOp codes
enum Dtype { kF32 = 0, kBf16 = 1, kI32 = 2 };

struct Ranks {
  const void* x[kMaxRanks];                // rank r's flat input
};

template <int kOp>
__device__ __forceinline__ float combine_f(float a, float b) {
  if constexpr (kOp == kSum) return __fadd_rn(a, b);
  if constexpr (kOp == kProd) return __fmul_rn(a, b);
  if (a != a) return a;
  if (b != b) return b;
  if constexpr (kOp == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

template <int kOp>
struct Combine {
  __device__ static float f(float a, float b) { return combine_f<kOp>(a, b); }
  __device__ static __nv_bfloat16 f(__nv_bfloat16 a, __nv_bfloat16 b) {
    return __float2bfloat16_rn(
        combine_f<kOp>(__bfloat162float(a), __bfloat162float(b)));
  }
  __device__ static int f(int a, int b) {
    const unsigned ua = (unsigned)a, ub = (unsigned)b;
    if constexpr (kOp == kSum) return (int)(ua + ub);
    if constexpr (kOp == kProd) return (int)(ua * ub);
    if constexpr (kOp == kMax) return a > b ? a : b;
    return a < b ? a : b;
  }
};

// The chunk of element p; 32-bit division where the payload allows.
__device__ __forceinline__ int chunk_of(long long p, long long chunk,
                                        bool narrow) {
  return narrow ? (int)((unsigned)p / (unsigned)chunk) : (int)(p / chunk);
}

// The fold of element (or vector) V at offset p of chunk c, over ranks
// c, c+1, ..., in the ring's order.
template <typename V, typename F>
__device__ __forceinline__ V fold(const Ranks& in, int ndev, int c,
                                  long long p, F combine) {
  V acc = __ldg(reinterpret_cast<const V*>(in.x[c]) + p);
  for (int j0 = 1; j0 < ndev; j0 += kBatch) {
    V buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      int r = c + j0 + u;
      r = r >= ndev ? r - ndev : r;
      if (j0 + u < ndev)
        buf[u] = __ldg(reinterpret_cast<const V*>(in.x[r]) + p);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u)
      if (j0 + u < ndev) acc = combine(buf[u], acc);
  }
  return acc;
}

template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads)
fold_kernel(const __grid_constant__ Ranks in, int ndev, long long size,
            long long chunk, bool vectors, T* __restrict__ out,
            long long ld_out) {
  constexpr int kVec = 16 / sizeof(T);
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool narrow = size <= 0x7fffffffLL;
  const long long nvec = vectors ? size / kVec : 0;
  for (long long v = first; v < nvec; v += stride) {
    const long long p = v * kVec;
    const int c = chunk_of(p, chunk, narrow);
    const uint4 acc = fold<uint4>(in, ndev, c, v, [](uint4 a, uint4 b) {
      T* av = reinterpret_cast<T*>(&a);
      const T* bv = reinterpret_cast<const T*>(&b);
#pragma unroll
      for (int i = 0; i < kVec; ++i) av[i] = Combine<kOp>::f(av[i], bv[i]);
      return a;
    });
    for (int r = 0; r < ndev; ++r)
      *reinterpret_cast<uint4*>(out + r * ld_out + p) = acc;
  }
  for (long long p = nvec * kVec + first; p < size; p += stride) {
    const int c = chunk_of(p, chunk, narrow);
    const T acc = fold<T>(in, ndev, c, p, [](T a, T b) {
      return Combine<kOp>::f(a, b);
    });
    for (int r = 0; r < ndev; ++r) out[r * ld_out + p] = acc;
  }
}

template <typename T, int kOp>
int launch_typed(const Ranks& in, int ndev, long long size, long long chunk,
                 bool vectors, void* out, long long ld_out, int sms,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long units = vectors ? size / kVec + size % kVec : size;
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  if (blocks > most) blocks = most;
  fold_kernel<T, kOp><<<(unsigned)blocks, kThreads, 0, stream>>>(
      in, ndev, size, chunk, vectors, static_cast<T*>(out), ld_out);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const Ranks& in, int ndev, long long size,
              long long chunk, bool vectors, void* out, long long ld_out,
              int sms, cudaStream_t s) {
  switch (op) {
    case kMax:
      return launch_typed<T, kMax>(in, ndev, size, chunk, vectors, out,
                                   ld_out, sms, s);
    case kMin:
      return launch_typed<T, kMin>(in, ndev, size, chunk, vectors, out,
                                   ld_out, sms, s);
    case kSum:
      return launch_typed<T, kSum>(in, ndev, size, chunk, vectors, out,
                                   ld_out, sms, s);
    case kProd:
      return launch_typed<T, kProd>(in, ndev, size, chunk, vectors, out,
                                    ld_out, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* ring_allreduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ring_allreduce_max_ranks() { return kMaxRanks; }

// xs[r]: rank r's flat input of `size` elements; out: (ndev, ld_out), each
// row 16-byte aligned, row r receiving the result; chunk: the ring's chunk
// (a multiple of 128 elements, ndev * chunk >= size); vectors: every xs[r]
// is 16-byte aligned; sms: the card's SM count.
int ring_allreduce(const long long* xs, int ndev, long long size,
                   long long chunk, int vectors, int dtype, int op, void* out,
                   long long ld_out, int sms, void* stream) {
  if (ndev < 2 || ndev > kMaxRanks || size < 1 || chunk < 1 ||
      chunk % 128 != 0 || (long long)ndev * chunk < size || ld_out < size ||
      sms < 1)
    return (int)cudaErrorInvalidValue;
  Ranks in = {};
  for (int r = 0; r < ndev; ++r) in.x[r] = reinterpret_cast<const void*>(xs[r]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vectors != 0;
  switch (dtype) {
    case kF32:
      return launch_op<float>(op, in, ndev, size, chunk, v, out, ld_out, sms,
                              s);
    case kBf16:
      return launch_op<__nv_bfloat16>(op, in, ndev, size, chunk, v, out,
                                      ld_out, sms, s);
    case kI32:
      return launch_op<int>(op, in, ndev, size, chunk, v, out, ld_out, sms,
                            s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
