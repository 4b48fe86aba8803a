// Row compaction: each row's live (non-EMPTY) entries moved to the front
// in slot order, the tail filled with EMPTY (Alg. 1's extraction).
//
// Replaces the Pallas kernel repro/kernels/compact.py :: row_compact
// (reached through repro/kernels/ops.py :: row_compact_op).  Plain
// version: repro_torch/kernels/ref.py :: row_compact_ref
// (= core/hashing.py :: row_compact).
//
// mem int32 [R, L] -> out int32 [R, L].  One CTA per row walks the row in
// tiles of 1024 slots; a block scan of the live flags (block_scan.cuh)
// gives each live entry its output column, and the columns past the row's
// count get EMPTY.  The TPU kernel's O(L^2) hit matrix existed only to
// keep the TPU's vector unit busy without a scan; a block scan is O(L).
//
// Bound on the H100: bytes in principle (each entry read and written
// once: 668 KB at R = 8, L = 10446, 0.2 us at 3.35 TB/s), latency in fact:
// R CTAs each walk ceil(L / 1024) tiles, a few barriers per tile, on 8 of
// the 132 SMs.  Splitting a row over several CTAs would need a second
// pass for the carries; at these sizes the launch dominates anyway.
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
row_compact_kernel(const int* __restrict__ mem, int L, int* __restrict__ out) {
  __shared__ int warp_sums[32];
  const int* in = mem + (size_t)blockIdx.x * L;
  int* dst = out + (size_t)blockIdx.x * L;
  int base = 0;
  for (int j0 = 0; j0 < L; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const int v = j < L ? in[j] : ZEN_EMPTY;
    const bool live = v != ZEN_EMPTY;
    int tile = 0;
    const int e = zen::block_excl_scan(live ? 1 : 0, warp_sums, tile);
    if (live) dst[base + e] = v;
    base += tile;
  }
  for (int j = base + threadIdx.x; j < L; j += blockDim.x) dst[j] = ZEN_EMPTY;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = success).
int row_compact_launch(const int* mem, int R, int L, int* out, void* stream) {
  if (R < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (R == 0 || L == 0) return 0;
  row_compact_kernel<<<R, kThreads, 0, (cudaStream_t)stream>>>(mem, L, out);
  return (int)cudaGetLastError();
}

const char* row_compact_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
