// COO scatter-add: out[idx[r]] += vals[r], in place, EMPTY / negative /
// out-of-range indices dropped, duplicates accumulated in stream order.
//
// Replaces the Pallas kernel repro/kernels/scatter_add.py ::
// coo_scatter_add (reached through repro/kernels/ops.py ::
// coo_scatter_add_op and :: batched_coo_reduce_op).  Plain version:
// repro_torch/kernels/ref.py :: coo_scatter_add_ref.
//
// out [M, d], idx int32 [C], vals [C, d], f32 or bf16.  The TPU kernel is a
// read-modify-write loop over the stream on the TPU's sequential grid,
// which makes each target's sum stream-ordered.  Blocks on the H100 run in
// no order, and float atomics would make the sum order-free (and bf16 sums
// not reproducible), so the rows are grouped by target with integer
// atomics, whose order does not matter, and each target's rows are summed
// in stream order by one warp.
//
// Design: one cooperative launch of the blocks that fit on the card at
// once, in two phases around one grid-wide barrier (grid_sync):
//   1. every live row takes a rank among its target's rows (atomicAdd on
//      the target's count) and files its row id in the target's table of
//      kTab slots; a target's first row appends it to the touched list
//      (warp-aggregated atomics);
//   2. a few warps per touched target (as many as the grid has for the
//      touched targets, up to one 16-byte chunk of the row a lane): read
//      the count and the table in one access and sort the row ids (=
//      stream order: a bitonic network in registers); a run longer than
//      kTab instead takes its rows from one pass over idx, 32 positions at
//      a time.  Then start from out's row and add the rows in order, one
//      rounding per add in bf16, with eight rows' loads in flight.
// No stage runs on one block, and the scratch is left zero for the next
// call (each count by its target's last reader; the list length comes in
// two copies, and each call zeroes the copy the previous call used and the
// next call takes; the barrier's own counter returns to 0), so the wrapper
// keeps it across calls and launches no memset.  Untouched rows of out are
// neither read nor written.  Runs of at most kTab rows (the Zen commit's:
// one row per worker) take the table alone.
//
// Bound on the H100: bytes.  The function must read idx, the live rows of
// vals and the touched rows of out, and write the touched rows back
// (about 1.25 MB for server 0's pushed stream at the qwen2-0.5b slice:
// 0.4 us at 3.35 TB/s).  At that size the launch, the barrier and the
// dependent memory latencies of each phase dominate.
#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "csr_by_target.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTab = 16;          // table slots a target
constexpr int kMaxParts = 8;      // warps a target
constexpr int kReaderShift = 28;  // a count's bits above it tally readers
constexpr int kMaxDevices = 64;
constexpr int kEmptyRow = 0x7FFFFFFF;

// Zeroed scratch, kept zero across calls: the touched list's length in
// words 0 and 1 (a call counts in word `parity`), the barrier's words on
// cache lines of their own, then cnt [M].
enum { kBarCount = 32, kBarGen = 64, kCtr = 96 };

struct Scratch {
  unsigned* zero;  // [kCtr + M], zero between calls
  int* touched;    // [min(C, M)] touched targets
  int* tab;        // [M * kTab] row ids by target and rank
  int parity;      // the word of the list length this call uses
};

// Grid-wide barrier of a cooperative launch: every block arrives on
// bar[kBarCount]; the last one resets it and bumps bar[kBarGen], which the
// others wait on.  Release/acquire at device scope make every write before
// the barrier visible to every read after it.  A wait that cannot end
// (never, with every block resident) traps instead of hanging the card.
__device__ __forceinline__ void grid_sync(unsigned* bar) {
  __syncthreads();
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> count(
        bar[kBarCount]);
    cuda::atomic_ref<unsigned, cuda::thread_scope_device> gen(bar[kBarGen]);
    const unsigned g = gen.load(cuda::memory_order_relaxed);
    if (count.fetch_add(1u, cuda::memory_order_acq_rel) == gridDim.x - 1) {
      count.store(0u, cuda::memory_order_relaxed);
      gen.store(g + 1u, cuda::memory_order_release);
    } else {
      for (long long spins = 0; gen.load(cuda::memory_order_acquire) == g;)
        if (++spins > (1LL << 26)) __trap();  // seconds
    }
  }
  __syncthreads();
}

// VEC consecutive elements of a row: one 16-byte access when VEC > 1.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Ascending bitonic sort over the 32 lanes' registers.
__device__ __forceinline__ int warp_sort32(int key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(zen::kFull, key, j);
      const bool up = (lane & k) == 0;
      const bool low = (lane & j) == 0;
      key = (low == up) ? min(key, other) : max(key, other);
    }
  return key;
}

// Phase 1: rank, file and count every live row; list the touched targets.
__device__ void file_rows(const int* __restrict__ idx, int C, int M,
                          const Scratch& s) {
  int* ntouched = reinterpret_cast<int*>(s.zero) + s.parity;
  int* cnt = reinterpret_cast<int*>(s.zero) + kCtr;
  const int lane = threadIdx.x & 31;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  // the word the previous call used is the next call's: zero it
  if (gtid == 0) reinterpret_cast<int*>(s.zero)[1 - s.parity] = 0;
  const int span = (C + 31) & ~31;  // warp-uniform trip counts
  for (int r = gtid; r < span; r += gridDim.x * kThreads) {
    const int t = r < C ? idx[r] : -1;
    int k = -1;
    if (zen::live_target(t, M)) {
      k = atomicAdd(&cnt[t], 1);
      if (k < kTab) s.tab[(size_t)t * kTab + k] = r;
    }
    const unsigned b = __ballot_sync(zen::kFull, k == 0);
    if (b) {
      const int leader = __ffs(b) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(ntouched, __popc(b));
      base = __shfl_sync(zen::kFull, base, leader);
      if (k == 0)
        s.touched[base + __popc(b & ((1u << lane) - 1u))] = t;
    }
  }
}

// Adds rows ws[0, n) of vals, in that order, to acc (column chunk c).
template <typename T, int VEC>
__device__ __forceinline__ void add_rows(const T* __restrict__ vals, int d,
                                         int c, const int* ws, int n,
                                         float (&acc)[VEC]) {
  constexpr int kAhead = 8;  // rows loaded ahead of the ordered adds
  for (int e0 = 0; e0 < n; e0 += kAhead) {
    Pack<T, VEC> v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (e0 + u < n)
        v[u] = reinterpret_cast<const Pack<T, VEC>*>(
            vals + (size_t)ws[e0 + u] * d)[c];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (e0 + u < n)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          acc[k] = zen::Acc<T>::add(acc[k], to_f32(v[u].v[k]));
  }
}

// Phase 2: a few warps per touched target (as many as the grid's warps
// allow, up to one 16-byte chunk of the row a lane), each summing the
// target's rows in stream order over its slice of the columns.
template <typename T, int VEC>
__device__ void sum_targets(const int* __restrict__ idx, int C, int tmax,
                            const T* __restrict__ vals, int d,
                            T* out, const Scratch& s) {
  __shared__ int wseg[kWarps][32];
  int* cnt = reinterpret_cast<int*>(s.zero) + kCtr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int nchunks = d / VEC;
  const int nwarps = gridDim.x * kWarps, w0 = blockIdx.x * kWarps + warp;
  int pmax = (nchunks + 31) / 32;
  pmax = pmax < kMaxParts ? pmax : kMaxParts;
  // the first entry at pmax warps a target loads with the list's length
  const int t0 = w0 / pmax < tmax ? __ldcg(s.touched + w0 / pmax) : 0;
  const int ntouched = __ldcg(reinterpret_cast<int*>(s.zero) + s.parity);
  int parts = ntouched ? nwarps / ntouched : 1;
  parts = parts < 1 ? 1 : parts < pmax ? parts : pmax;
  int* ws = wseg[warp];
  for (int item = w0;; item += nwarps) {
    const int i = item / parts, part = item - i * parts;
    if (i >= ntouched) break;
    const int t = item == w0 && parts == pmax ? t0 : __ldcg(s.touched + i);
    // lanes 0..kTab-1 read the table; lane kTab reads the count and tallies
    // its readers in the top bits, and the target's last reader zeroes it
    int got = 0;
    if (lane < kTab) {
      got = __ldcg(s.tab + (size_t)t * kTab + lane);
    } else if (lane == kTab) {
      const unsigned old = atomicAdd(
          reinterpret_cast<unsigned*>(cnt + t), 1u << kReaderShift);
      got = (int)(old & ((1u << kReaderShift) - 1u));
      if ((int)(old >> kReaderShift) == parts - 1) atomicExch(cnt + t, 0);
    }
    const int m = __shfl_sync(zen::kFull, got, kTab);
    if (m <= kTab) ws[lane] = warp_sort32(lane < m ? got : kEmptyRow, lane);
    __syncwarp();
    T* row = out + (size_t)t * d;
    for (int c0 = part * 32; c0 < nchunks; c0 += parts * 32) {
      const int c = c0 + lane;
      const bool on = c < nchunks;
      Pack<T, VEC> o;
      float acc[VEC];
      if (on) {
        o = reinterpret_cast<const Pack<T, VEC>*>(row)[c];
#pragma unroll
        for (int k = 0; k < VEC; ++k) acc[k] = to_f32(o.v[k]);
      }
      if (m <= kTab) {
        if (on) add_rows<T, VEC>(vals, d, c, ws, m, acc);
      } else {  // a longer run: its rows 32 stream positions at a time
        for (int r0 = 0; r0 < C; r0 += 4 * 32) {
          int v[4];  // four windows' indices in flight
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int r = r0 + 32 * u + lane;
            v[u] = r < C ? __ldg(idx + r) : -1;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const unsigned b = __ballot_sync(zen::kFull, v[u] == t);
            if (b == 0u) continue;
            if (v[u] == t) ws[__popc(b & below)] = r0 + 32 * u + lane;
            __syncwarp();
            if (on) add_rows<T, VEC>(vals, d, c, ws, __popc(b), acc);
            __syncwarp();
          }
        }
      }
      if (on) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) o.v[k] = zen::Acc<T>::store(acc[k]);
        reinterpret_cast<Pack<T, VEC>*>(row)[c] = o;
      }
    }
    __syncwarp();  // ws is rewritten by the warp's next target
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                   int C, int d, int M, T* out, Scratch s) {
  file_rows(idx, C, M, s);
  grid_sync(s.zero);
  sum_targets<T, VEC>(idx, C, C < M ? C : M, vals, d, out, s);
}

// Blocks of scatter_add_kernel<T, VEC> that fit on the device at once,
// per device (queried once).
template <typename T, int VEC>
int resident_blocks(int dev) {
  static int cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, scatter_add_kernel<T, VEC>, kThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cache[dev] = per_sm * sms;
  }
  return cache[dev];
}

template <typename T, int VEC>
int launch(const int* idx, const T* vals, int C, int d, int M, T* out,
           unsigned* zero, int* scratch, int parity, cudaStream_t st) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  const int fit = resident_blocks<T, VEC>(dev);
  if (fit <= 0) return (int)cudaErrorInvalidConfiguration;
  // no more blocks than give each thread a row and each warp its part of
  // a target
  const int chunks = d / VEC;
  int parts = (chunks + 31) / 32;
  parts = parts < kMaxParts ? parts : kMaxParts;
  const int tmax = C < M ? C : M;
  const int by_rows = (C + kThreads - 1) / kThreads;
  const int by_targets =
      (int)(((long long)tmax * parts + kWarps - 1) / kWarps);
  const int want = by_rows > by_targets ? by_rows : by_targets;
  const int grid = want < fit ? want : fit;
  Scratch s;
  s.zero = zero;
  s.touched = scratch;
  s.tab = s.touched + tmax;
  s.parity = parity & 1;
  void* args[] = {&idx, &vals, &C, &d, &M, &out, &s};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)scatter_add_kernel<T, VEC>, dim3(grid), dim3(kThreads),
      args, 0, st);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

template <typename T>
int scatter_add(const int* idx, const T* vals, int C, int d, int M, T* out,
                unsigned* zero, int* scratch, int parity, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (d % kVec == 0 && aligned16(vals) && aligned16(out))
    return launch<T, kVec>(idx, vals, C, d, M, out, zero, scratch, parity,
                           st);
  return launch<T, 1>(idx, vals, C, d, M, out, zero, scratch, parity, st);
}

}  // namespace

extern "C" {

// The zeroed scratch the scatter-add needs, in 32-bit words: it must be
// zero before the first call and the kernel leaves it zero.
long long scatter_add_zscratch(int M) { return (long long)kCtr + M; }

// The other int32 scratch it needs (no initial value), in elements.
long long scatter_add_iscratch(int C, int M) {
  const long long tmax = C < M ? C : M;
  return tmax + (long long)M * kTab;
}

// dtype: 0 = float32, 1 = bfloat16 (out and vals alike).  out is updated
// in place.  zscratch: scatter_add_zscratch(M) words, zero; iscratch:
// scatter_add_iscratch(C, M) ints.  Calls that share a zscratch must run
// in stream order, with parity 0, 1, 0, 1, ...  Returns the cudaError_t
// of the launch (0 = success).
int scatter_add_launch(const int* idx, const void* vals, int C, int d,
                       int dtype, int M, void* out, void* zscratch,
                       int* iscratch, int parity, void* stream) {
  if (C < 0 || M < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* zero = (unsigned*)zscratch;
  if (dtype == 0)
    return scatter_add<float>(idx, (const float*)vals, C, d, M, (float*)out,
                              zero, iscratch, parity, st);
  if (dtype == 1)
    return scatter_add<__nv_bfloat16>(idx, (const __nv_bfloat16*)vals, C, d,
                                      M, (__nv_bfloat16*)out, zero, iscratch,
                                      parity, st);
  return (int)cudaErrorInvalidValue;
}

// Blocks of the launch for this dtype and row width that fit on the
// current device at once (its grid, before the cap by C and M).
int scatter_add_resident_blocks(int dtype, int d, void* vals, void* out) {
  const bool vec = ((size_t)vals & 15) == 0 && ((size_t)out & 15) == 0;
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (dtype == 0)
    return vec && d % 4 == 0 ? resident_blocks<float, 4>(dev)
                             : resident_blocks<float, 1>(dev);
  if (dtype == 1)
    return vec && d % 8 == 0 ? resident_blocks<__nv_bfloat16, 8>(dev)
                             : resident_blocks<__nv_bfloat16, 1>(dev);
  return -1;
}

const char* scatter_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
