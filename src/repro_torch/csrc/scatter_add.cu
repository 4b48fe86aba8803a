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
// in stream order by a few warps.
//
// Design: one cooperative launch of the blocks that fit on the card at
// once, in two phases around one grid-wide barrier: file_rows, then
// sum_targets, each target's rows added to its own row of out in stream
// order (csrc/stream_order.cuh has both and the scratch they keep zero).
// Untouched rows of out are neither read nor written.  Runs of at most
// kTab rows (the Zen commit's: one row per worker) take the table alone.
//
// Bound on the H100: bytes.  The function must read idx, the live rows of
// vals and the touched rows of out, and write the touched rows back
// (about 1.25 MB for server 0's pushed stream at the qwen2-0.5b slice:
// 0.4 us at 3.35 TB/s).  At that size the launch, the barrier and the
// dependent memory latencies of each phase dominate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "stream_order.cuh"

namespace {

using zen::kCtr;
using zen::kTab;
using zen::kThreads;
using zen::kWarps;
constexpr int kMaxDevices = 64;

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
scatter_add_kernel(const int* __restrict__ idx, const T* __restrict__ vals,
                   int C, int d, int M, T* out, zen::Scratch s) {
  zen::file_rows(idx, C, M, s);
  zen::grid_sync(s.zero);
  zen::sum_targets<T, VEC, false>(idx, C, C < M ? C : M, vals, d, out, s,
                                  nullptr);
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
  const int parts = zen::max_parts(d / VEC);
  const int tmax = C < M ? C : M;
  const int by_rows = (C + kThreads - 1) / kThreads;
  const int by_targets =
      (int)(((long long)tmax * parts + kWarps - 1) / kWarps);
  const int want = by_rows > by_targets ? by_rows : by_targets;
  const int grid = want < fit ? want : fit;
  zen::Scratch s;
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
