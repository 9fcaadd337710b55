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
// move.  No arithmetic is worth counting.  One rank of several processes
// reads ndev * size elements and writes size: each rank folds the whole
// payload itself, so that no end barrier is needed.
//
// Design:
//  * inputs are read in place through a __grid_constant__ table of the
//    ranks' pointers; the output is one (ndev, ld_out) buffer whose rows
//    are 16-byte aligned, or one row, the calling rank's, when the ranks
//    are processes;
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
// Across rank processes (rabit_tpu_torch/parallel/peer_ring.py) the same
// fold reads its peers' inputs in place: each rank copies its input into an
// inbox of its own (cudaMalloc'd here, shared by a CUDA IPC handle), the
// ranks meet at a start barrier on the host, and ring_allreduce_peer folds
// every inbox into the calling rank's one output row.  No rank writes into
// another's memory, so no flag lives on the device.  Within one process the
// stream orders the inputs' writers before the launch.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstring>

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
            long long ld_out, int nout) {
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
    for (int r = 0; r < nout; ++r)
      *reinterpret_cast<uint4*>(out + r * ld_out + p) = acc;
  }
  for (long long p = nvec * kVec + first; p < size; p += stride) {
    const int c = chunk_of(p, chunk, narrow);
    const T acc = fold<T>(in, ndev, c, p, [](T a, T b) {
      return Combine<kOp>::f(a, b);
    });
    for (int r = 0; r < nout; ++r) out[r * ld_out + p] = acc;
  }
}

template <typename T, int kOp>
int launch_typed(const Ranks& in, int ndev, long long size, long long chunk,
                 bool vectors, void* out, long long ld_out, int nout, int sms,
                 cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const long long units = vectors ? size / kVec + size % kVec : size;
  long long blocks = (units + kThreads - 1) / kThreads;
  const long long most = (long long)sms * kBlocksPerSm;
  if (blocks > most) blocks = most;
  fold_kernel<T, kOp><<<(unsigned)blocks, kThreads, 0, stream>>>(
      in, ndev, size, chunk, vectors, static_cast<T*>(out), ld_out, nout);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const Ranks& in, int ndev, long long size,
              long long chunk, bool vectors, void* out, long long ld_out,
              int nout, int sms, cudaStream_t s) {
  switch (op) {
    case kMax:
      return launch_typed<T, kMax>(in, ndev, size, chunk, vectors, out,
                                   ld_out, nout, sms, s);
    case kMin:
      return launch_typed<T, kMin>(in, ndev, size, chunk, vectors, out,
                                   ld_out, nout, sms, s);
    case kSum:
      return launch_typed<T, kSum>(in, ndev, size, chunk, vectors, out,
                                   ld_out, nout, sms, s);
    case kProd:
      return launch_typed<T, kProd>(in, ndev, size, chunk, vectors, out,
                                    ld_out, nout, sms, s);
  }
  return (int)cudaErrorInvalidValue;
}

// The fold of xs[0..ndev) into `nout` rows of out (row stride ld_out).
int launch(const long long* xs, int ndev, long long size, long long chunk,
           int vectors, int dtype, int op, void* out, long long ld_out,
           int nout, int sms, void* stream) {
  if (ndev < 2 || ndev > kMaxRanks || size < 1 || chunk < 1 ||
      chunk % 128 != 0 || (long long)ndev * chunk < size || sms < 1 ||
      nout < 1 || (nout > 1 && ld_out < size))
    return (int)cudaErrorInvalidValue;
  Ranks in = {};
  for (int r = 0; r < ndev; ++r) in.x[r] = reinterpret_cast<const void*>(xs[r]);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool v = vectors != 0;
  switch (dtype) {
    case kF32:
      return launch_op<float>(op, in, ndev, size, chunk, v, out, ld_out, nout,
                              sms, s);
    case kBf16:
      return launch_op<__nv_bfloat16>(op, in, ndev, size, chunk, v, out,
                                      ld_out, nout, sms, s);
    case kI32:
      return launch_op<int>(op, in, ndev, size, chunk, v, out, ld_out, nout,
                            sms, s);
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
  if (ld_out < size) return (int)cudaErrorInvalidValue;
  return launch(xs, ndev, size, chunk, vectors, dtype, op, out, ld_out, ndev,
                sms, stream);
}

// One rank of ranks in several processes: xs[r] is rank r's inbox (this
// rank's own, or a peer's opened from its IPC handle), every one holding
// its `size` input elements; out: this rank's result, one row.  vectors:
// every xs[r] and out are 16-byte aligned.
int ring_allreduce_peer(const long long* xs, int ndev, long long size,
                        long long chunk, int vectors, int dtype, int op,
                        void* out, int sms, void* stream) {
  return launch(xs, ndev, size, chunk, vectors, dtype, op, out, size, 1, sms,
                stream);
}

// The inboxes and their handles.  Each returns a cudaError_t.  An inbox is
// a cudaMalloc of its own, never a block of PyTorch's caching allocator:
// cudaIpcGetMemHandle on a pointer inside a cached block would name the
// block's base, and under expandable segments it is refused.
int ring_ipc_handle_bytes() { return (int)sizeof(cudaIpcMemHandle_t); }

int ring_inbox_alloc(long long nbytes, long long* ptr) {
  void* p = nullptr;
  const cudaError_t err = cudaMalloc(&p, (size_t)nbytes);
  *ptr = reinterpret_cast<long long>(p);
  return (int)err;
}

int ring_inbox_free(long long ptr) {
  return (int)cudaFree(reinterpret_cast<void*>(ptr));
}

int ring_ipc_get(long long ptr, unsigned char* handle) {
  cudaIpcMemHandle_t h;
  const cudaError_t err = cudaIpcGetMemHandle(&h, reinterpret_cast<void*>(ptr));
  if (err == cudaSuccess) memcpy(handle, &h, sizeof(h));
  return (int)err;
}

int ring_ipc_open(const unsigned char* handle, long long* ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  void* p = nullptr;
  const cudaError_t err =
      cudaIpcOpenMemHandle(&p, h, cudaIpcMemLazyEnablePeerAccess);
  *ptr = reinterpret_cast<long long>(p);
  return (int)err;
}

int ring_ipc_close(long long ptr) {
  return (int)cudaIpcCloseMemHandle(reinterpret_cast<void*>(ptr));
}

// A rank's input into its inbox, on the caller's stream.
int ring_copy(long long dst, long long src, long long nbytes, void* stream) {
  return (int)cudaMemcpyAsync(reinterpret_cast<void*>(dst),
                              reinterpret_cast<const void*>(src),
                              (size_t)nbytes, cudaMemcpyDeviceToDevice,
                              static_cast<cudaStream_t>(stream));
}

}  // extern "C"
