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
//      (steps 1, 3 and 4's sort and sum are csr_by_target.cuh's);
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
#include "csr_by_target.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kRowThreads = 128;
constexpr int kStreamThreads = 256;

// start[s] = cursor[s] = exclusive prefix sum of cnt over the slots.
__global__ void __launch_bounds__(kScanThreads)
zen_scan_kernel(const int* __restrict__ cnt, int cap_server,
                int* __restrict__ start, int* __restrict__ cursor) {
  __shared__ int warp_sums[32];
  int base = 0;
  for (int s0 = 0; s0 < cap_server; s0 += blockDim.x) {
    const int s = s0 + threadIdx.x;
    const int v = s < cap_server ? cnt[s] : 0;
    int tile = 0;
    const int e = zen::block_excl_scan(v, warp_sums, tile);
    if (s < cap_server) start[s] = cursor[s] = base + e;
    base += tile;
  }
}

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
  zen::sort_segment(seg, m);
  const int nz = __syncthreads_or(zen::ordered_row_sum<T>(
      vals, d, seg, m, buf + (size_t)s * d));
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
      dst[c] = zen::Acc<T>::store(0.0f);
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
      cudaMemsetAsync(cnt, 0, (size_t)cap_server * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int gs = (C + kStreamThreads - 1) / kStreamThreads;
  if (C > 0)
    zen::csr_count_kernel<<<gs, kStreamThreads, 0, st>>>(
        lp, C, cap_server, cnt);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  zen_scan_kernel<<<1, kScanThreads, 0, st>>>(cnt, cap_server, start,
                                              cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (C > 0)
    zen::csr_fill_kernel<<<gs, kStreamThreads, 0, st>>>(lp, C, cap_server,
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
