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
// not reproducible), so this kernel keeps the order with the CSR-by-target
// stages of csr_by_target.cuh, which the commit push (csrc/zen_commit.cu)
// shares:
//   1. count the live rows of each target; the first row of a target
//      appends it to the touched list (integer atomics);
//   2. one CTA: exclusive scan of the touched targets' counts -> each
//      target's segment start;
//   3. scatter row ids into their target's segment;
//   4. per touched target: sort the segment (= stream order, any length:
//      a bitonic network past 16 rows), then start from out's row and add
//      the rows in order, one rounding per add in bf16; write the row back.
// It differs from the push in that the sum starts from out's row, a target
// may take any number of rows, and step 4's grid walks the touched targets
// only (a grid-stride loop over a list whose length is on the device), not
// every row of out.  Untouched rows are neither read nor written.
//
// Bound on the H100: bytes.  The function must read idx, the live rows of
// vals and the touched rows of out, and write the touched rows back
// (about 4 MB for a bf16 server of the qwen2-0.5b slice's realistic
// stream: 1.2 us at 3.35 TB/s).  Steps 1-3 touch only int32 arrays of
// size C and M; at that size the five launches and step 2's single CTA
// dominate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "csr_by_target.cuh"

namespace {

constexpr int kScanThreads = 1024;
constexpr int kRowThreads = 128;
constexpr int kStreamThreads = 256;
constexpr int kMaxRowBlocks = 2048;

// seg0[i] = cursor[touched[i]] = exclusive prefix sum of the touched
// targets' counts, in touched-list order.
__global__ void __launch_bounds__(kScanThreads)
scatter_scan_kernel(const int* __restrict__ cnt,
                    const int* __restrict__ touched,
                    const int* __restrict__ ntouched, int* __restrict__ seg0,
                    int* __restrict__ cursor) {
  __shared__ int warp_sums[32];
  const int T = *ntouched;
  int base = 0;
  for (int i0 = 0; i0 < T; i0 += blockDim.x) {
    const int i = i0 + threadIdx.x;
    const int t = i < T ? touched[i] : 0;
    const int v = i < T ? cnt[t] : 0;
    int tile = 0;
    const int e = zen::block_excl_scan(v, warp_sums, tile);
    if (i < T) seg0[i] = cursor[t] = base + e;
    base += tile;
  }
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
scatter_rows_kernel(const T* __restrict__ vals, int d,
                    const int* __restrict__ cnt,
                    const int* __restrict__ touched,
                    const int* __restrict__ ntouched,
                    const int* __restrict__ seg0, int* __restrict__ list,
                    T* out) {
  const int n_t = *ntouched;
  for (int i = blockIdx.x; i < n_t; i += gridDim.x) {
    const int t = touched[i];
    const int m = cnt[t];
    int* seg = list + seg0[i];
    zen::sort_segment(seg, m);
    T* row = out + (size_t)t * d;
    zen::ordered_row_sum<T>(vals, d, seg, m, row, row);
  }
}

template <typename T>
int scatter_add(const int* idx, const T* vals, int C, int d, int M, T* out,
                int* iscratch, cudaStream_t st) {
  const int tmax = C < M ? C : M;
  int* cnt = iscratch;              // [M]
  int* ntouched = cnt + M;          // [1]
  int* cursor = ntouched + 1;       // [M]
  int* touched = cursor + M;        // [tmax]
  int* seg0 = touched + tmax;       // [tmax]
  int* list = seg0 + tmax;          // [C]
  cudaError_t err =
      cudaMemsetAsync(cnt, 0, ((size_t)M + 1) * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int gs = (C + kStreamThreads - 1) / kStreamThreads;
  zen::csr_count_kernel<<<gs, kStreamThreads, 0, st>>>(idx, C, M, cnt,
                                                       touched, ntouched);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  scatter_scan_kernel<<<1, kScanThreads, 0, st>>>(cnt, touched, ntouched,
                                                  seg0, cursor);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  zen::csr_fill_kernel<<<gs, kStreamThreads, 0, st>>>(idx, C, M, cursor,
                                                      list);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int blocks = tmax < kMaxRowBlocks ? tmax : kMaxRowBlocks;
  scatter_rows_kernel<T><<<blocks, kRowThreads, 0, st>>>(
      vals, d, cnt, touched, ntouched, seg0, list, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Int32 scratch the scatter-add needs, in elements.
long long scatter_add_iscratch(int C, int M) {
  const long long tmax = C < M ? C : M;
  return 2LL * M + 1 + 2 * tmax + C;
}

// dtype: 0 = float32, 1 = bfloat16 (out and vals alike).  out is updated
// in place.  Returns the cudaError_t of the launches (0 = success).
int scatter_add_launch(const int* idx, const void* vals, int C, int d,
                       int dtype, int M, void* out, int* iscratch,
                       void* stream) {
  if (C < 0 || M < 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (C == 0 || M == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return scatter_add<float>(idx, (const float*)vals, C, d, M, (float*)out,
                              iscratch, st);
  if (dtype == 1)
    return scatter_add<__nv_bfloat16>(idx, (const __nv_bfloat16*)vals, C, d,
                                      M, (__nv_bfloat16*)out, iscratch, st);
  return (int)cudaErrorInvalidValue;
}

const char* scatter_add_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
