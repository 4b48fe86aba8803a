// Zen commit kernels: the server-side push (aggregate + mask + compact +
// gather + bitmap) and the pull decode (bitmap -> compacted positions).
//
// Replace the Pallas megakernels repro/kernels/zen_commit.py ::
// zen_commit_push_fused and :: zen_commit_pull_fused (reached through
// repro/kernels/ops.py :: zen_commit_push_fused_op and
// :: zen_commit_pull_fused_op).  Plain versions: repro_torch/kernels/ref.py
// :: zen_commit_push_ref and :: zen_commit_pull_ref.
//
// PUSH.  lp int32 [C] server-local positions of the pushed rows (EMPTY or
// >= cap_server dropped), vals [C, d] (f32 or bf16).  Bit-exactness needs
// every slot's adds in stream order, in the values' dtype (bf16: add in
// f32, round once per add, as the reference's scatter-add does).  Instead
// of float atomics (order-free, so not reproducible) the push builds a CSR
// of the live rows by slot and lets one CTA own each slot:
//   1. count live rows per slot (int atomics: counts are order-free);
//   2. exclusive scan of the counts (one CTA) -> segment starts;
//   3. scatter row ids into their slot's segment (int atomics);
//   4. per slot: sort its few row ids ascending (= stream order), sum the
//      rows column by column in that order, write the slot's buffer row and
//      its mask any(row != 0) (-0.0 counts as zero);
//   5. one CTA: ascending compaction of the mask to cap_pull (block scan),
//      the LSB-first bitmap words (__ballot_sync) and the overflow count;
//   6. gather the kept slots' rows into the pull payload, zero the rest.
// Bound on the H100: bytes.  It must read the live rows' values once and
// write cap_pull x d values; step 4 writes and step 6 re-reads only live
// slots' rows.  Slots with no pushed row cost one CTA that exits at once.
//
// PULL.  words int32 [n, W] (uint32 bits) -> lpos int32 [n, cap_pull]: per
// row, the set-bit positions below cap_server, ascending, first cap_pull,
// EMPTY-padded.  One CTA per row; each thread takes one word, a block scan
// of the words' popcounts gives its output offset.  Bound: latency (the
// bitmaps are a few KB).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kRowThreads = 128;
constexpr int kStreamThreads = 256;

__device__ __forceinline__ bool live_slot(int v, int cap_server) {
  return (unsigned)v < (unsigned)cap_server;  // EMPTY and negatives drop
}

__global__ void zen_count_kernel(const int* __restrict__ lp, int C,
                                 int cap_server, int* __restrict__ cnt) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < C && live_slot(lp[r], cap_server)) atomicAdd(&cnt[lp[r]], 1);
}

__global__ void __launch_bounds__(kScanThreads)
zen_scan_kernel(const int* __restrict__ cnt, int cap_server,
                int* __restrict__ start) {
  __shared__ int warp_sums[32];
  int base = 0;
  for (int s0 = 0; s0 < cap_server; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const int v = s < cap_server ? cnt[s] : 0;
    int tile = 0;
    const int e = zen::block_excl_scan(v, warp_sums, tile);
    if (s < cap_server) start[s] = base + e;
    base += tile;
  }
}

__global__ void zen_fill_kernel(const int* __restrict__ lp, int C,
                                int cap_server, const int* __restrict__ start,
                                int* __restrict__ cursor,
                                int* __restrict__ list) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < C && live_slot(lp[r], cap_server)) {
    const int s = lp[r];
    list[start[s] + atomicAdd(&cursor[s], 1)] = r;
  }
}

template <typename T>
struct Acc;

template <>
struct Acc<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float add(float a, float v) {
    return __fadd_rn(a, v);
  }
  static __device__ __forceinline__ float store(float a) { return a; }
};

template <>
struct Acc<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // one rounding to bf16 per add, exactly as a bf16 scatter-add
  static __device__ __forceinline__ float add(float a, float v) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, v)));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float a) {
    return __float2bfloat16_rn(a);
  }
};

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
zen_aggregate_kernel(const T* __restrict__ vals, int d,
                     const int* __restrict__ cnt, const int* __restrict__ start,
                     int* __restrict__ list, T* __restrict__ buf,
                     int* __restrict__ mask) {
  const int s = blockIdx.x;
  const int m = cnt[s];
  if (m == 0) {
    if (threadIdx.x == 0) mask[s] = 0;
    return;
  }
  int* seg = list + start[s];
  if (threadIdx.x == 0) {  // segments hold a few rows: insertion sort
    for (int a = 1; a < m; ++a) {
      const int key = seg[a];
      int b = a - 1;
      while (b >= 0 && seg[b] > key) {
        seg[b + 1] = seg[b];
        --b;
      }
      seg[b + 1] = key;
    }
  }
  __syncthreads();
  int nz = 0;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.0f;
    for (int e = 0; e < m; ++e)
      acc = Acc<T>::add(acc, Acc<T>::load(vals + (size_t)seg[e] * d + c));
    buf[(size_t)s * d + c] = Acc<T>::store(acc);
    nz |= acc != 0.0f;
  }
  nz = __syncthreads_or(nz);
  if (threadIdx.x == 0) mask[s] = nz;
}

__global__ void __launch_bounds__(kScanThreads)
zen_compact_kernel(const int* __restrict__ mask, int cap_server,
                   int cap_pull, int* __restrict__ lpos, int* __restrict__ bm,
                   int* __restrict__ ovf) {
  __shared__ int warp_sums[32];
  const int Wb = (cap_server + 31) / 32;
  int base = 0;
  for (int s0 = 0; s0 < Wb * 32; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const bool on = s < cap_server && mask[s] != 0;
    const unsigned word = __ballot_sync(zen::kFull, on);
    if ((threadIdx.x & 31) == 0 && (s >> 5) < Wb) bm[s >> 5] = (int)word;
    int tile = 0;
    const int pos = base + zen::block_excl_scan(on ? 1 : 0, warp_sums, tile);
    if (on && pos < cap_pull) lpos[pos] = s;
    base += tile;
  }
  const int kept = base < cap_pull ? base : cap_pull;
  for (int j = kept + threadIdx.x; j < cap_pull; j += blockDim.x)
    lpos[j] = ZEN_EMPTY;
  if (threadIdx.x == 0) ovf[0] = base > cap_pull ? base - cap_pull : 0;
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
zen_gather_kernel(const int* __restrict__ lpos, const T* __restrict__ buf,
                  int d, T* __restrict__ out) {
  const int j = blockIdx.x;
  const int s = lpos[j];
  T* dst = out + (size_t)j * d;
  if (s == ZEN_EMPTY) {
    for (int c = threadIdx.x; c < d; c += blockDim.x)
      dst[c] = Acc<T>::store(0.0f);
    return;
  }
  const T* src = buf + (size_t)s * d;
  for (int c = threadIdx.x; c < d; c += blockDim.x) dst[c] = src[c];
}

__global__ void __launch_bounds__(kScanThreads)
zen_pull_kernel(const int* __restrict__ words, int W, int cap_server,
                int cap_pull, int* __restrict__ lpos) {
  __shared__ int warp_sums[32];
  const int row = blockIdx.x;
  const int* wr = words + (size_t)row * W;
  int* out = lpos + (size_t)row * cap_pull;
  int base = 0;
  for (int w0 = 0; w0 < W; w0 += blockDim.x) {
    const int w = w0 + threadIdx.x;
    unsigned word = w < W ? (unsigned)wr[w] : 0u;
    const int lo = w * 32;
    if (lo >= cap_server) word = 0u;  // trim bits at or above cap_server
    else if (cap_server - lo < 32) word &= (1u << (cap_server - lo)) - 1u;
    int tile = 0;
    int pos = base + zen::block_excl_scan(__popc(word), warp_sums, tile);
    while (word != 0u && pos < cap_pull) {
      out[pos++] = lo + __ffs(word) - 1;
      word &= word - 1u;
    }
    base += tile;
  }
  const int kept = base < cap_pull ? base : cap_pull;
  for (int j = kept + threadIdx.x; j < cap_pull; j += blockDim.x)
    out[j] = ZEN_EMPTY;
}

template <typename T>
int push(const int* lp, const T* vals, int C, int d, int cap_server,
         int cap_pull, int* lpos, T* out, int* bm, int* ovf, int* iscratch,
         T* buf, cudaStream_t st) {
  int* cnt = iscratch;                 // [cap_server]
  int* cursor = cnt + cap_server;      // [cap_server]
  int* start = cursor + cap_server;    // [cap_server]
  int* mask = start + cap_server;      // [cap_server]
  int* list = mask + cap_server;       // [C]
  cudaError_t err =
      cudaMemsetAsync(cnt, 0, 2 * (size_t)cap_server * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int gs = (C + kStreamThreads - 1) / kStreamThreads;
  if (C > 0)
    zen_count_kernel<<<gs, kStreamThreads, 0, st>>>(lp, C, cap_server, cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  zen_scan_kernel<<<1, kScanThreads, 0, st>>>(cnt, cap_server, start);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (C > 0)
    zen_fill_kernel<<<gs, kStreamThreads, 0, st>>>(lp, C, cap_server, start,
                                                   cursor, list);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  zen_aggregate_kernel<T><<<cap_server, kRowThreads, 0, st>>>(
      vals, d, cnt, start, list, buf, mask);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  zen_compact_kernel<<<1, kScanThreads, 0, st>>>(mask, cap_server, cap_pull,
                                                 lpos, bm, ovf);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  zen_gather_kernel<T><<<cap_pull, kRowThreads, 0, st>>>(lpos, buf, d, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Int32 scratch the push needs, in elements.
long long zen_commit_push_iscratch(int C, int cap_server) {
  return 4LL * cap_server + C;
}

// dtype: 0 = float32, 1 = bfloat16.  buf is [cap_server, d] scratch of the
// values' dtype (only rows of slots that received a live row are written).
// Returns the cudaError_t of the launches (0 = success).
int zen_commit_push_launch(const int* lp, const void* vals, int C, int d,
                           int dtype, int cap_server, int cap_pull, int* lpos,
                           void* out, int* bm, int* ovf, int* iscratch,
                           void* buf, void* stream) {
  if (cap_server <= 0 || cap_pull <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return push<float>(lp, (const float*)vals, C, d, cap_server, cap_pull,
                       lpos, (float*)out, bm, ovf, iscratch, (float*)buf, st);
  if (dtype == 1)
    return push<__nv_bfloat16>(lp, (const __nv_bfloat16*)vals, C, d,
                               cap_server, cap_pull, lpos, (__nv_bfloat16*)out,
                               bm, ovf, iscratch, (__nv_bfloat16*)buf, st);
  return (int)cudaErrorInvalidValue;
}

// words int32 [n, W] -> lpos int32 [n, cap_pull].
int zen_commit_pull_launch(const int* words, int n, int W, int cap_server,
                           int cap_pull, int* lpos, void* stream) {
  if (n <= 0 || cap_pull <= 0) return (int)cudaErrorInvalidValue;
  zen_pull_kernel<<<n, kScanThreads, 0, (cudaStream_t)stream>>>(
      words, W, cap_server, cap_pull, lpos);
  return (int)cudaGetLastError();
}

const char* zen_commit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
