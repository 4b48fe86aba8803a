// Zen encode kernel: Alg. 1 hierarchical hashing + partition extraction +
// occupancy bitmap, one launch for all partitions.
//
// Replaces the Pallas megakernel repro/kernels/zen_encode.py ::
// zen_encode_fused (reached through repro/kernels/ops.py ::
// zen_encode_fused_op).  Plain version: repro_torch/kernels/ref.py ::
// zen_encode_ref.
//
// What it computes, per partition p (one CTA each, grid = n):
//   * candidates: live indices with h0(idx) mod n == p, in index order;
//   * k round-synchronous insertion rounds: every pending candidate whose
//     slot h_i(idx) mod r1 is still EMPTY proposes; the minimum proposer
//     wins (shared-memory atomicMin), checked by an exact winner test
//     (indices are unique, so no ties);
//   * serial memory: survivors take rank r in candidate order (a block scan,
//     NOT an atomicAdd counter, which would permute the ranks); r < r2 lands
//     at slot r1 + r, the rest is overflow;
//   * the row is compacted in slot order (block scan) and the occupancy
//     bitmap is the prefix of nnz ones, LSB first.
//
// What bounds it on the H100: latency, not bytes.  The row (r1+r2 int32,
// ~42 KB at the qwen2-0.5b slice) and two candidate bit arrays live in
// shared memory; each phase streams the index vector ([C] int32, ~150 KB)
// from L2 and recomputes the hashes instead of storing them.  Every
// round is a few block-wide barriers.  One CTA per partition leaves most
// of the 132 SMs idle at n = 8 -- a known under-use for later work (split
// each partition's candidate scan over a cluster).
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kMaxSeeds = 16;
constexpr int kThreads = 1024;

struct Seeds {
  unsigned s[kMaxSeeds];
};

__global__ void __launch_bounds__(kThreads)
zen_encode_kernel(const int* __restrict__ idx, int C, Seeds seeds, int k,
                  int n, int r1, int r2, int* __restrict__ pidx,
                  int* __restrict__ occ, int* __restrict__ ovf) {
  extern __shared__ int smem[];
  const int L = r1 + r2;
  const int Wc = (C + 31) / 32;
  int* row = smem;                                      // [L]
  unsigned* pend = reinterpret_cast<unsigned*>(row + L);  // [Wc] bits
  unsigned* prop = pend + Wc;                           // [Wc] bits
  int* warp_sums = reinterpret_cast<int*>(prop + Wc);   // [32]

  const int part = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;

  for (int j = threadIdx.x; j < L; j += blockDim.x) row[j] = ZEN_EMPTY;
  // each warp owns whole 32-candidate words of the bit arrays
  for (int w = warp; w < Wc; w += nwarps) {
    const int c = w * 32 + lane;
    const int x = c < C ? idx[c] : ZEN_EMPTY;
    const bool mine = x != ZEN_EMPTY &&
        (int)(zen::hash_u32((unsigned)x, seeds.s[0]) % (unsigned)n) == part;
    const unsigned word = __ballot_sync(zen::kFull, mine);
    if (lane == 0) {
      pend[w] = word;
      prop[w] = 0u;
    }
  }
  __syncthreads();

  // --- k insertion rounds --------------------------------------------------
  for (int i = 1; i <= k; ++i) {
    const unsigned seed = seeds.s[i];
    // propose: pending candidates whose slot is empty BEFORE this round
    for (int w = warp; w < Wc; w += nwarps) {
      const int c = w * 32 + lane;
      bool propose = false;
      if ((pend[w] >> lane) & 1u) {
        const int q = (int)(zen::hash_u32((unsigned)idx[c], seed) %
                            (unsigned)r1);
        propose = row[q] == ZEN_EMPTY;
      }
      const unsigned word = __ballot_sync(zen::kFull, propose);
      if (lane == 0) prop[w] = word;
    }
    __syncthreads();
    // race: the minimum proposer takes each slot
    for (int w = warp; w < Wc; w += nwarps) {
      if ((prop[w] >> lane) & 1u) {
        const int x = idx[w * 32 + lane];
        const int q = (int)(zen::hash_u32((unsigned)x, seed) % (unsigned)r1);
        atomicMin(&row[q], x);
      }
    }
    __syncthreads();
    // exact winner test: the slot holds this candidate
    for (int w = warp; w < Wc; w += nwarps) {
      bool won = false;
      if ((prop[w] >> lane) & 1u) {
        const int x = idx[w * 32 + lane];
        const int q = (int)(zen::hash_u32((unsigned)x, seed) % (unsigned)r1);
        won = row[q] == x;
      }
      const unsigned word = __ballot_sync(zen::kFull, won);
      if (lane == 0) pend[w] &= ~word;
    }
    __syncthreads();
  }

  // --- serial memory: ranks in candidate order (block scan) ----------------
  int base = 0;
  for (int t0 = 0; t0 < Wc * 32; t0 += blockDim.x) {
    const int c = t0 + threadIdx.x;
    const bool surv = c < Wc * 32 && ((pend[c >> 5] >> (c & 31)) & 1u);
    int tile = 0;
    const int rank = base + zen::block_excl_scan(surv ? 1 : 0, warp_sums, tile);
    if (surv && rank < r2) row[r1 + rank] = idx[c];
    base += tile;
  }
  if (threadIdx.x == 0) ovf[part] = base > r2 ? base - r2 : 0;
  __syncthreads();

  // --- extraction: order-preserving compaction of the row ------------------
  int* out = pidx + (size_t)part * L;
  int nnz = 0;
  for (int j0 = 0; j0 < L; j0 += blockDim.x) {
    const int j = j0 + threadIdx.x;
    const int v = j < L ? row[j] : ZEN_EMPTY;
    const bool live = v != ZEN_EMPTY;
    int tile = 0;
    const int pos = nnz + zen::block_excl_scan(live ? 1 : 0, warp_sums, tile);
    if (live) out[pos] = v;
    nnz += tile;
  }
  for (int j = nnz + threadIdx.x; j < L; j += blockDim.x) out[j] = ZEN_EMPTY;

  // --- occupancy bitmap of the compacted row: a prefix of nnz ones ---------
  const int W = (L + 31) / 32;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    const int lo = w * 32;
    unsigned word;
    if (nnz >= lo + 32) word = zen::kFull;
    else if (nnz <= lo) word = 0u;
    else word = (1u << (nnz - lo)) - 1u;
    occ[(size_t)part * W + w] = (int)word;
  }
}

}  // namespace

extern "C" {

// Shared memory the encode kernel needs for one partition row, in bytes.
int zen_encode_smem_bytes(int C, int r1, int r2) {
  return (r1 + r2 + 2 * ((C + 31) / 32) + 32) * (int)sizeof(int);
}

// idx int32 [C] (unique, EMPTY-padded) -> pidx int32 [n, r1+r2],
// occ int32 words [n, ceil((r1+r2)/32)], ovf int32 [n] (per partition).
// Returns the cudaError_t of the launch (0 = success).
int zen_encode_launch(const int* idx, int C, const unsigned* seeds_host,
                      int n_seeds, int n, int r1, int r2, int* pidx, int* occ,
                      int* ovf, void* stream) {
  if (n_seeds < 2 || n_seeds > kMaxSeeds) return (int)cudaErrorInvalidValue;
  Seeds s = {};
  for (int i = 0; i < n_seeds; ++i) s.s[i] = seeds_host[i];
  const int smem = zen_encode_smem_bytes(C, r1, r2);
  cudaError_t err = cudaFuncSetAttribute(
      zen_encode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  zen_encode_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(
      idx, C, s, n_seeds - 1, n, r1, r2, pidx, occ, ovf);
  return (int)cudaGetLastError();
}

const char* zen_encode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
