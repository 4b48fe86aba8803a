// Row compaction: each row's live (non-EMPTY) entries moved to the front
// in slot order, the tail filled with EMPTY (Alg. 1's extraction).
//
// Replaces the Pallas kernel repro/kernels/compact.py :: row_compact
// (reached through repro/kernels/ops.py :: row_compact_op).  Plain
// version: repro_torch/kernels/ref.py :: row_compact_ref
// (= core/hashing.py :: row_compact).
//
// mem int32 [R, L] -> out int32 [R, L].  The TPU kernel's O(L^2) hit
// matrix existed only to keep the TPU's vector unit busy without a scan; a
// scan is O(L).
//
// Bound on the H100: bytes in principle (each entry read and written
// once: 668 KB at R = 8, L = 10446, 0.2 us at 3.35 TB/s), latency in fact.
// One block a row with the whole row in flight and one block scan still
// took about 4 us on an H100: one SM moves a 41.8 KB row each way far
// slower than the card's rate.  So each row is spread over a cluster of
// kParts = 8 blocks (64 SMs at n = 8), which agree on their offsets
// through distributed shared memory:
//   * block p takes 1/8 of the 16-byte groups that the row spans in the
//     address space (an odd row of 10446 ints starts 8 bytes into one),
//     kPasses 16-byte loads a thread, all in flight at once (scalar for
//     the row's partial first and last group);
//   * ballots and popcounts give each group its offset within its warp,
//     and one barrier and a warp scan of the kPasses x kWarps warp counts
//     its offset within the block's span, in slot order (pass by pass,
//     thread by thread);
//   * each block writes its span's count into the shared memory of every
//     block of its cluster; after one cluster barrier each block reads the
//     counts before its own and the row's total locally, with no remote
//     read;
//   * live entries are stored at their columns, and each block writes
//     EMPTY over its eighth of the output slots past the row's total.
// A span past one tile (rows over 8 x 1536 slots) is counted tile by tile
// before the barrier and loaded again after it.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kParts = 8;                   // blocks a row: one cluster
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kPasses = 3;                  // 16-byte groups a thread loads
constexpr int kTile = kThreads * kPasses;   // groups a tile
constexpr int kMaxRows = 0x7FFFFFFF / kParts;   // rows a grid holds

// slots s .. s + 3 of a row of L, one 16-byte group (`row + s` aligned);
// slots outside [0, L) read as EMPTY
__device__ __forceinline__ int4 load_group(const int* row, int s, int L) {
  if (s >= 0 && s + 4 <= L)
    return __ldg(reinterpret_cast<const int4*>(row + s));
  int v[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    v[e] = s + e >= 0 && s + e < L ? __ldg(row + s + e) : ZEN_EMPTY;
  return make_int4(v[0], v[1], v[2], v[3]);
}

// groups g0 + j * kThreads + t (t this thread, j < kPasses) below gb of a
// row whose slot 0 lies hi ints into its 16-byte group
__device__ __forceinline__ void load_tile(const int* row, int hi, int L,
                                          int g0, int gb,
                                          int4 (&v)[kPasses]) {
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const int g = g0 + j * kThreads + threadIdx.x;
    v[j] = g < gb ? load_group(row, 4 * g - hi, L)
                  : make_int4(ZEN_EMPTY, ZEN_EMPTY, ZEN_EMPTY, ZEN_EMPTY);
  }
}

// pos[j]: live entries of the tile before this thread's group j; returns
// the tile's live count.  Every thread calls it; a barrier must separate
// two calls (s_cnt is rewritten).
__device__ __forceinline__ int tile_scan(const int4 (&v)[kPasses],
                                         int (&pos)[kPasses], int* s_cnt) {
  static_assert(kPasses * kWarps <= 32, "one warp scans the warp counts");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    const unsigned b0 = __ballot_sync(zen::kFull, v[j].x != ZEN_EMPTY);
    const unsigned b1 = __ballot_sync(zen::kFull, v[j].y != ZEN_EMPTY);
    const unsigned b2 = __ballot_sync(zen::kFull, v[j].z != ZEN_EMPTY);
    const unsigned b3 = __ballot_sync(zen::kFull, v[j].w != ZEN_EMPTY);
    pos[j] = __popc(b0 & below) + __popc(b1 & below) + __popc(b2 & below) +
             __popc(b3 & below);
    if (lane == 0)
      s_cnt[j * kWarps + warp] =
          __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
  }
  __syncthreads();
  // lane i holds the count of (pass, warp) = (i / kWarps, i % kWarps)
  const int c = lane < kPasses * kWarps ? s_cnt[lane] : 0;
  int x = c;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(zen::kFull, x, o);
    if (lane >= o) x += t;
  }
#pragma unroll
  for (int j = 0; j < kPasses; ++j)
    pos[j] += __shfl_sync(zen::kFull, x - c, j * kWarps + warp);
  return __shfl_sync(zen::kFull, x, 31);
}

__device__ __forceinline__ void put_live(int* dst, int& pos, int v) {
  if (v != ZEN_EMPTY) dst[pos++] = v;
}

__device__ __forceinline__ void place(int* dst, int base,
                                      const int4 (&v)[kPasses],
                                      const int (&pos)[kPasses]) {
#pragma unroll
  for (int j = 0; j < kPasses; ++j) {
    int p = base + pos[j];
    put_live(dst, p, v[j].x);
    put_live(dst, p, v[j].y);
    put_live(dst, p, v[j].z);
    put_live(dst, p, v[j].w);
  }
}

// Block p of cluster r: part p of row r.
__global__ void __cluster_dims__(kParts, 1, 1) __launch_bounds__(kThreads)
row_compact_kernel(const int* __restrict__ mem, int L,
                   int* __restrict__ out) {
  __shared__ int s_cnt[kPasses * kWarps];
  __shared__ int s_span[kParts];   // the live count of each part's span
  // no block writes into another's shared memory before all have started:
  // arrive now, wait just before the writes
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int part = (int)cluster.block_rank();
  const size_t row = blockIdx.x / kParts;
  const int* in = mem + row * L;
  int* dst = out + row * L;
  const int hi = (int)((reinterpret_cast<uintptr_t>(in) >> 2) & 3);
  const int ngroups = (int)(((long long)hi + L + 3) >> 2);
  const int per = (ngroups - 1) / kParts + 1;
  const int ga = min(part * per, ngroups), gb = min(ga + per, ngroups);

  int4 v[kPasses];
  int pos[kPasses];
  load_tile(in, hi, L, ga, gb, v);
  const int first = tile_scan(v, pos, s_cnt);
  int mine = first;
  for (int g0 = ga + kTile; g0 < gb; g0 += kTile) {   // a span past a tile
    int4 w[kPasses];
    int wp[kPasses];
    load_tile(in, hi, L, g0, gb, w);
    __syncthreads();
    mine += tile_scan(w, wp, s_cnt);
  }
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if ((int)threadIdx.x < kParts)
    *cluster.map_shared_rank(&s_span[part], threadIdx.x) = mine;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  const int lane = threadIdx.x & 31;
  int total = lane < kParts ? s_span[lane] : 0;
  int before = lane < part ? total : 0;
#pragma unroll
  for (int o = 16; o; o >>= 1) {
    total += __shfl_xor_sync(zen::kFull, total, o);
    before += __shfl_xor_sync(zen::kFull, before, o);
  }

  place(dst, before, v, pos);
  int base = before + first;
  for (int g0 = ga + kTile; g0 < gb; g0 += kTile) {
    load_tile(in, hi, L, g0, gb, v);
    __syncthreads();
    const int t = tile_scan(v, pos, s_cnt);
    place(dst, base, v, pos);
    base += t;
  }
  // EMPTY over this part's eighth of the output slots past the total
  const int share = (L - 1) / kParts + 1;
  const int s0 = max(part * share, total);
  const int s1 = (int)min((long long)(part + 1) * share, (long long)L);
  for (int s = s0 + threadIdx.x; s < s1; s += kThreads) dst[s] = ZEN_EMPTY;
}

}  // namespace

extern "C" {

// Returns the cudaError_t of the launch (0 = success).
int row_compact_launch(const int* mem, int R, int L, int* out, void* stream) {
  if (R < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (L == 0) return 0;
  for (long long r0 = 0; r0 < R; r0 += kMaxRows) {
    const int rows = (int)(R - r0 < kMaxRows ? R - r0 : kMaxRows);
    row_compact_kernel<<<rows * kParts, kThreads, 0, (cudaStream_t)stream>>>(
        mem + r0 * L, L, out + r0 * L);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

const char* row_compact_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
