// Ring allreduce over logical ranks for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel rabit_tpu/ops/ring_allreduce.py:_ring_kernel
// (wrapper ring_allreduce_pallas): ndev-1 reduce-scatter hops, then ndev-1
// all-gather hops, SUM/MAX/MIN/PROD, on a payload laid out as (ndev, chunk)
// per rank.  Every rank's buffer and progress words are reached through a
// table of peer pointers, so the same code serves ranks on one card (this
// build) and, later, ranks on several cards (peer access or CUDA IPC).
//
// What bounds it on an H100: bytes.  A reduce-scatter hop reads two chunk
// slices and writes one, an all-gather hop reads one and writes one, so the
// kernel moves 5(ndev-1) chunks a rank; the least the card could take is
// one read of every input and one write of every output.
// No arithmetic is worth counting.  Plain 16-byte loads and stores; TMA, the
// copy engine and NVLink come later.
//
// Design:
//  * one cooperative launch holds every rank: gridDim.y = ndev, and block
//    (r, b) owns columns [b*cols, (b+1)*cols) of every chunk of rank r.  It
//    talks only to block (r-1, b).  cudaLaunchCooperativeKernel refuses a
//    grid whose blocks cannot all be resident, so no waiting block can be
//    resident while the block it waits for is not;
//  * pull, not push: at hop t rank r reads its left neighbour's chunk c
//    (the chunk the TPU kernel's left rank would send) straight from the
//    left's buffer and folds it into its own: out_r[c] = combine(out_r[c],
//    out_left[c]) during reduce-scatter, out_r[c] = out_left[c] during the
//    all-gather, in hop order, so every element is combined in the TPU
//    kernel's order and the bits match its wrapper's;
//  * signalling: after hop t each block stores launch_base + t + 1 to its
//    progress word (__threadfence, then a release store); hop t > 0 of
//    block (r, b) first waits, with acquire loads, until (r-1, b) has
//    stored launch_base + t.  launch_base grows by 128 every launch, so a
//    word left by an earlier launch never satisfies a later wait and the
//    words are never reset;
//  * why pull needs no credit: rank r at reduce-scatter hop s reads chunk
//    c = r-1-s of its left neighbour, which the left rewrites only at
//    all-gather hop s (global hop ndev-1+s).  Every hop waits for the left
//    neighbour's previous hop, so hop ndev-1+s of the left rank depends,
//    through ndev-1 links around the ring, on hop s of rank r having
//    finished: r's read comes first.  In the all-gather, r reads chunks the
//    left has finished and never writes again.  The TPU kernel needed two
//    landing slots and acknowledgements because its sender wrote into the
//    receiver; here nothing lands;
//  * peer loads bypass L1 (__ldcg): a chunk read in the reduce-scatter is
//    read again, changed, in the all-gather;
//  * scope: ranks share one card, so fences and flags are gpu scope.  Ranks
//    on separate cards need __threadfence_system and .sys loads and stores;
//  * a wait that outlasts its clock64 budget (about a second) sets the error
//    word and every block leaves; the wrapper raises.  A block also leaves
//    as soon as it sees the error word set by another;
//  * NaN: MAX and MIN propagate NaN as jnp.maximum/jnp.minimum do (fmaxf and
//    fminf would drop it).  bfloat16 combines in float32 and rounds each hop
//    to bfloat16, as jnp.add on bfloat16 does.  int32 SUM and PROD wrap.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRanks = 64;
constexpr int kMaxCols = 1024;             // progress words per rank

enum Op { kMax = 0, kMin = 1, kSum = 2, kProd = 3 };   // ReduceOp codes
enum Dtype { kF32 = 0, kBf16 = 1, kI32 = 2 };

struct Peers {
  void* buf[kMaxRanks];                    // rank r's (ndev, chunk) payload
  unsigned long long* flag[kMaxRanks];     // rank r's kMaxCols progress words
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

__device__ __forceinline__ unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned long long* p,
                                              unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Spin until *flag >= target; false if the budget ran out or another
// block reported a failure.
__device__ bool wait_for(const unsigned long long* flag,
                         unsigned long long target, long long budget,
                         volatile int* err) {
  const long long t0 = clock64();
  while (load_acquire(flag) < target) {
    if (*err != 0) return false;
    if (clock64() - t0 > budget) {
      atomicExch(const_cast<int*>(err), 1);
      return false;
    }
    __nanosleep(64);
  }
  return true;
}

template <typename T, int kOp>
__global__ void __launch_bounds__(kThreads)
ring_kernel(const __grid_constant__ Peers peers, int ndev, long long chunk,
            long long cols, unsigned long long base, long long budget,
            int* err) {
  constexpr int kVec = 16 / sizeof(T);
  __shared__ int abort_flag;
  const int r = blockIdx.y, b = blockIdx.x, tid = threadIdx.x;
  const int left = (r + ndev - 1) % ndev;
  T* mine = static_cast<T*>(peers.buf[r]);
  const T* theirs = static_cast<const T*>(peers.buf[left]);
  unsigned long long* my_flag = peers.flag[r] + b;
  const unsigned long long* left_flag = peers.flag[left] + b;
  const long long lo = (long long)b * cols;
  const long long hi = lo + cols < chunk ? lo + cols : chunk;
  const int nphase = ndev - 1;

  for (int t = 0; t < 2 * nphase; ++t) {
    if (t > 0) {                 // hop 0 reads the staged inputs
      if (tid == 0)
        abort_flag = !wait_for(left_flag, base + t, budget, err);
      __syncthreads();
      if (abort_flag) return;
    }
    const bool rs = t < nphase;
    const int c = rs ? (r - t - 1 + 2 * ndev) % ndev
                     : (r - (t - nphase) + 2 * ndev) % ndev;
    T* dst = mine + (long long)c * chunk;
    const T* src = theirs + (long long)c * chunk;
    for (long long e = lo + (long long)tid * kVec; e < hi;
         e += (long long)kThreads * kVec) {
      const uint4 in = __ldcg(reinterpret_cast<const uint4*>(src + e));
      if (rs) {
        uint4 cur = *reinterpret_cast<const uint4*>(dst + e);
        T* cv = reinterpret_cast<T*>(&cur);
        const T* iv = reinterpret_cast<const T*>(&in);
#pragma unroll
        for (int i = 0; i < kVec; ++i) cv[i] = Combine<kOp>::f(cv[i], iv[i]);
        *reinterpret_cast<uint4*>(dst + e) = cur;
      } else {
        *reinterpret_cast<uint4*>(dst + e) = in;
      }
    }
    __syncthreads();             // every thread's stores precede the flag
    if (tid == 0) {
      __threadfence();
      store_release(my_flag, base + t + 1);
    }
  }
}

template <typename T, int kOp>
int launch_typed(const Peers& peers, int ndev, long long chunk,
                 unsigned long long base, long long budget, int* err,
                 cudaStream_t stream) {
  auto kernel = ring_kernel<T, kOp>;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  constexpr int kVec = 16 / sizeof(T);
  const long long step = (long long)kThreads * kVec;
  long long bx = (long long)per_sm * sms / ndev;
  const long long need = (chunk + step - 1) / step;
  if (bx > need) bx = need;
  if (bx > kMaxCols) bx = kMaxCols;
  if (bx < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  long long cols = (chunk + bx - 1) / bx;
  cols = (cols + kVec - 1) / kVec * kVec;
  bx = (chunk + cols - 1) / cols;
  void* args[] = {const_cast<Peers*>(&peers), &ndev, &chunk, &cols,
                  &base, &budget, &err};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel),
                                  dim3((unsigned)bx, ndev), dim3(kThreads),
                                  args, 0, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename T>
int launch_op(int op, const Peers& peers, int ndev, long long chunk,
              unsigned long long base, long long budget, int* err,
              cudaStream_t s) {
  switch (op) {
    case kMax:
      return launch_typed<T, kMax>(peers, ndev, chunk, base, budget, err, s);
    case kMin:
      return launch_typed<T, kMin>(peers, ndev, chunk, base, budget, err, s);
    case kSum:
      return launch_typed<T, kSum>(peers, ndev, chunk, base, budget, err, s);
    case kProd:
      return launch_typed<T, kProd>(peers, ndev, chunk, base, budget, err, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* ring_allreduce_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int ring_allreduce_max_ranks() { return kMaxRanks; }
int ring_allreduce_max_cols() { return kMaxCols; }

// bufs[r]: rank r's (ndev, chunk) payload (16-byte aligned, chunk a
// multiple of 128 elements), reduced in place; flags[r]: rank r's kMaxCols
// progress words, each below base; err: one int32 on the card, 0 on entry.
int ring_allreduce(const long long* bufs, const long long* flags, int ndev,
                   long long chunk, int dtype, int op,
                   unsigned long long base, long long budget, void* err,
                   void* stream) {
  if (ndev < 2 || ndev > kMaxRanks || chunk < 1 || chunk % 128 != 0)
    return (int)cudaErrorInvalidValue;
  Peers peers = {};
  for (int r = 0; r < ndev; ++r) {
    peers.buf[r] = reinterpret_cast<void*>(bufs[r]);
    peers.flag[r] = reinterpret_cast<unsigned long long*>(flags[r]);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* e = static_cast<int*>(err);
  switch (dtype) {
    case kF32:
      return launch_op<float>(op, peers, ndev, chunk, base, budget, e, s);
    case kBf16:
      return launch_op<__nv_bfloat16>(op, peers, ndev, chunk, base, budget,
                                      e, s);
    case kI32:
      return launch_op<int>(op, peers, ndev, chunk, base, budget, e, s);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
