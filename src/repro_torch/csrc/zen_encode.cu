// Zen encode kernel: Alg. 1 hierarchical hashing + partition extraction +
// occupancy bitmap, one launch for all partitions.
//
// Replaces the Pallas megakernel repro/kernels/zen_encode.py ::
// zen_encode_fused (reached through repro/kernels/ops.py ::
// zen_encode_fused_op).  Plain version: repro_torch/kernels/ref.py ::
// zen_encode_ref.
//
// What it computes, per partition p (one block each, grid = n):
//   * candidates: live indices with h0(idx) mod n == p, in index order;
//   * k round-synchronous insertion rounds: every pending candidate whose
//     slot h_i(idx) mod r1 is still EMPTY before the round proposes; the
//     minimum proposer wins (shared-memory atomicMin), checked by an exact
//     winner test (indices are unique, so no ties);
//   * serial memory: survivors take rank r in candidate order (a block scan,
//     NOT an atomicAdd counter, which would permute the ranks); r < r2 lands
//     at slot r1 + r, the rest is overflow;
//   * the row is compacted in slot order and the occupancy bitmap is the
//     prefix of nnz ones, LSB first;
//   * the overflow of all partitions, summed by the last block to finish.
//
// What bounds it on the H100: latency, not bytes (the function moves about
// 0.5 MB at the qwen2-0.5b slice, 0.15 us at 3.35 TB/s).  A partition has
// about C / n candidates (28 of C = 37984 at the realistic stream), so the
// design touches the index vector once and all later work scales with the
// candidates, with few block barriers:
//   1. filter: each warp owns a contiguous run of 128-index chunks (4
//      indices a lane, one 16-byte load), keeps 4 chunks' loads in flight,
//      hashes only the chunks that hold a live index, and keeps 4 ballots
//      per chunk in shared memory; one scan of the 32 warp counts gives
//      each warp its offset, and a second walk reads 32 chunks' ballots at
//      once, visits only the chunks with a candidate, reloads only the
//      lanes that hold one, and writes the candidates in index order into
//      a list -- in shared memory when they fit (``list_cap``), else in
//      the per-partition slice of a
//      global scratch of n x 2C ints that the wrapper keeps (the worst
//      case is every index in one partition);
//   2. rounds: each thread owns a contiguous run of the list and keeps each
//      candidate's state beside it (pending, proposing to slot q, placed):
//      two barriers a round;
//   3. rank: one block scan of the per-thread survivor counts;
//   4. extraction: each thread owns a contiguous run of ceil(L / threads)
//      row slots: a local count, one block scan, then the writes;
//   5. overflow: before its extraction each block adds (1 << 32) + its
//      partition's overflow to one 64-bit word (kept zero by the wrapper
//      and by the last block); the block that finds n - 1 blocks filed
//      writes the total, so the wrapper launches nothing else.
// One block per partition leaves most of the 132 SMs idle at n = 8; the
// filter pass could be split over a cluster (later work).
//
// Wide rows.  Where the row and the ballots do not fit in a block's shared
// memory (an EF-compressed bucket: r1 + r2 up to 1.5M slots, C up to 5.4M
// at qwen2-0.5b's lm_head/w), the same kernel keeps them in a per-partition
// slice of the wrapper's global scratch instead (L + 4 ceil(C / 128) ints a
// partition, 6.7 MB at lm_head/w, which the 50 MB L2 holds), with the
// candidate list beside them; shared memory keeps the warp sums and a
// list of up to 4096 candidates.  The phases, barriers and bits are the
// same: __syncthreads orders a block's global writes for its own threads,
// and the slot race is a global atomicMin.
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "smem.cuh"

namespace {

using zen::FastMod;
using zen::fast_mod;
using zen::mod;

constexpr int kMaxSeeds = 16;
constexpr int kThreads = 1024;
constexpr int kListCap = 4096;        // candidates a shared-memory list holds
constexpr int kMaxSmemInts = 232448 / 4;  // one H100 block's shared memory
constexpr int kChunk = 128;           // indices a warp loads at once, 4 a lane
constexpr int kUnroll = 4;            // chunks a warp has in flight
constexpr int kPending = -1, kPlaced = -2;

struct Seeds {
  unsigned s[kMaxSeeds];
};

__host__ __device__ inline int fixed_ints(int C, int r1, int r2) {
  // row, 4 ballots a 128-index chunk, warp sums
  return r1 + r2 + 4 * ((C + kChunk - 1) / kChunk) + 32;
}

// indices c .. c + 3, EMPTY past C; one 16-byte load when `vec`
__device__ __forceinline__ int4 load4(const int* __restrict__ idx, int C,
                                      int c, bool vec) {
  if (vec) return __ldg(reinterpret_cast<const int4*>(idx + c));
  int4 v;
  v.x = c < C ? __ldg(idx + c) : ZEN_EMPTY;
  v.y = c + 1 < C ? __ldg(idx + c + 1) : ZEN_EMPTY;
  v.z = c + 2 < C ? __ldg(idx + c + 2) : ZEN_EMPTY;
  v.w = c + 3 < C ? __ldg(idx + c + 3) : ZEN_EMPTY;
  return v;
}

__device__ __forceinline__ bool live4(int4 v) {
  return v.x != ZEN_EMPTY || v.y != ZEN_EMPTY || v.z != ZEN_EMPTY ||
         v.w != ZEN_EMPTY;
}

// whether the row and the ballots live in global scratch
__host__ __device__ inline bool wide_row(int C, int r1, int r2) {
  return fixed_ints(C, r1, r2) > kMaxSmemInts;
}

// the ints of shared memory besides the list: all of fixed_ints, or only
// the warp sums when the row is wide
__host__ __device__ inline int smem_fixed(int C, int r1, int r2) {
  return wide_row(C, r1, r2) ? 32 : fixed_ints(C, r1, r2);
}

__host__ __device__ inline int list_cap(int C, int r1, int r2) {
  const int room = (kMaxSmemInts - smem_fixed(C, r1, r2)) / 2;
  const int want = C < kListCap ? C : kListCap;
  return room <= 0 ? 0 : (want < room ? want : room);
}

template <bool WIDE>
__global__ void __launch_bounds__(kThreads)
zen_encode_kernel(const int* __restrict__ idx, int C, Seeds seeds, int k,
                  int n, int r1, int r2, FastMod mod_n, FastMod mod_r1,
                  int lcap, int* __restrict__ pidx,
                  int* __restrict__ occ, int* __restrict__ ovf_total,
                  int* __restrict__ zscr, int* __restrict__ gscr,
                  int* __restrict__ gwide) {
  extern __shared__ int smem[];
  const int L = r1 + r2;
  const int Wq = (C + kChunk - 1) / kChunk;
  const int part = blockIdx.x;
  // the row [L] and the ballots [4 Wq]: in shared memory, or (WIDE) in
  // this partition's slice of gwide
  int* row = WIDE ? gwide + (size_t)part * (L + 4 * (size_t)Wq) : smem;
  unsigned* ballot = reinterpret_cast<unsigned*>(row + L);
  int* warp_sums = WIDE ? smem : reinterpret_cast<int*>(ballot + 4 * Wq);
  int* slist = warp_sums + 32;                            // [2 lcap]

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;

  // --- 1. filter: ballots of this partition's candidates, per chunk ------
  // Lane l of a warp holds indices 4l .. 4l + 3 of a 128-index chunk, so a
  // chunk's candidates are 4 ballots, b_e bit l for index 4l + e.
  const int cpw = (Wq + nwarps - 1) / nwarps;
  const int q_begin = min(warp * cpw, Wq), q_end = min(q_begin + cpw, Wq);
  const bool aligned = (reinterpret_cast<size_t>(idx) & 15) == 0;
  const int4 none = make_int4(ZEN_EMPTY, ZEN_EMPTY, ZEN_EMPTY, ZEN_EMPTY);
  const unsigned s0 = seeds.s[0];
  auto mine = [&](int x) {
    return x != ZEN_EMPTY &&
           (int)mod(mod_n, zen::hash_u32((unsigned)x, s0)) == part;
  };
  int cnt = 0;
  for (int q0 = q_begin; q0 < q_end; q0 += kUnroll) {
    int4 xs[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int c = (q0 + u) * kChunk + 4 * lane;
      xs[u] = q0 + u < q_end ? load4(idx, C, c, aligned && c + 3 < C) : none;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // a chunk of EMPTY only (most of a sparse stream's padded tail)
      // skips the hashes
      unsigned b0 = 0u, b1 = 0u, b2 = 0u, b3 = 0u;
      if (__any_sync(zen::kFull, live4(xs[u]))) {
        b0 = __ballot_sync(zen::kFull, mine(xs[u].x));
        b1 = __ballot_sync(zen::kFull, mine(xs[u].y));
        b2 = __ballot_sync(zen::kFull, mine(xs[u].z));
        b3 = __ballot_sync(zen::kFull, mine(xs[u].w));
      }
      if (q0 + u < q_end) {
        if (lane < 4)
          ballot[4 * (q0 + u) + lane] =
              lane == 0 ? b0 : lane == 1 ? b1 : lane == 2 ? b2 : b3;
        cnt += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
      }
    }
  }
  if (lane == 0) warp_sums[warp] = cnt;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(zen::kFull, s, o);
      if (lane >= o) s += t;
    }
    if (lane < nwarps) warp_sums[lane] = s;   // inclusive warp offsets
  }
  __syncthreads();
  const int ncand = warp_sums[nwarps - 1];
  int off = warp ? warp_sums[warp - 1] : 0;
  // the candidate list and each candidate's state, beside it
  int* list = ncand <= lcap ? slist : gscr + (size_t)part * 2 * (size_t)C;
  int* state = list + (ncand <= lcap ? lcap : C);
  // the candidates in index order: 32 chunks' ballots at a time, one chunk
  // a lane; a warp scan of their popcounts gives each chunk's offset, and
  // only the chunks with a candidate are visited, 4 at a time with their
  // loads in flight (a lane reloads its 4 indices only when one is a
  // candidate)
  const unsigned below = (1u << lane) - 1u;
  for (int g0 = q_begin; g0 < q_end; g0 += 32) {
    const int q = g0 + lane;
    unsigned b[4] = {0u, 0u, 0u, 0u};
    if (q < q_end)
#pragma unroll
      for (int e = 0; e < 4; ++e) b[e] = ballot[4 * q + e];
    const int own = __popc(b[0]) + __popc(b[1]) + __popc(b[2]) + __popc(b[3]);
    int incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(zen::kFull, incl, o);
      if (lane >= o) incl += t;
    }
    const int qoff = off + incl - own;   // this lane's chunk's offset
    unsigned todo = __ballot_sync(zen::kFull, own != 0);
    while (todo) {
      int src[kUnroll];
      unsigned bb[kUnroll][4];
      int4 xs[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        src[u] = todo ? __ffs(todo) - 1 : -1;   // warp-uniform
        todo &= todo - 1u;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          bb[u][e] = __shfl_sync(zen::kFull, b[e], src[u] < 0 ? 0 : src[u]);
        const int c = (g0 + src[u]) * kChunk + 4 * lane;
        const unsigned any = bb[u][0] | bb[u][1] | bb[u][2] | bb[u][3];
        xs[u] = src[u] >= 0 && ((any >> lane) & 1u)
                    ? load4(idx, C, c, aligned && c + 3 < C)
                    : none;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (src[u] < 0) break;
        int pos = __shfl_sync(zen::kFull, qoff, src[u]) +
                  __popc(bb[u][0] & below) + __popc(bb[u][1] & below) +
                  __popc(bb[u][2] & below) + __popc(bb[u][3] & below);
        if ((bb[u][0] >> lane) & 1u) list[pos++] = xs[u].x;
        if ((bb[u][1] >> lane) & 1u) list[pos++] = xs[u].y;
        if ((bb[u][2] >> lane) & 1u) list[pos++] = xs[u].z;
        if ((bb[u][3] >> lane) & 1u) list[pos++] = xs[u].w;
      }
    }
    off += __shfl_sync(zen::kFull, incl, 31);
  }
  // the row starts EMPTY (here, where most warps would wait at the barrier)
  for (int j = tid; j < L; j += blockDim.x) row[j] = ZEN_EMPTY;
  __syncthreads();   // the list (and the EMPTY row) is complete

  // --- 2. k insertion rounds over this thread's run of candidates --------
  const int per = (ncand + blockDim.x - 1) / blockDim.x;
  const int m0 = min(tid * per, ncand), m1 = min(m0 + per, ncand);
  for (int m = m0; m < m1; ++m) state[m] = kPending;
  for (int i = 1; i <= k; ++i) {
    const unsigned seed = seeds.s[i];
    // propose: pending candidates whose slot is EMPTY before this round
    for (int m = m0; m < m1; ++m) {
      if (state[m] != kPending) continue;
      const int q = (int)mod(mod_r1, zen::hash_u32((unsigned)list[m], seed));
      if (row[q] == ZEN_EMPTY) state[m] = q;
    }
    __syncthreads();
    // race: the minimum proposer takes each slot
    for (int m = m0; m < m1; ++m)
      if (state[m] >= 0) atomicMin(&row[state[m]], list[m]);
    __syncthreads();
    // exact winner test; the row is not written again until after the
    // next round's first barrier
    for (int m = m0; m < m1; ++m) {
      const int q = state[m];
      if (q >= 0) state[m] = row[q] == list[m] ? kPlaced : kPending;
    }
  }

  // --- 3. serial memory: ranks in candidate order (one block scan) -------
  int surv = 0;
  for (int m = m0; m < m1; ++m) surv += state[m] == kPending;
  int total = 0;
  int rank = zen::block_excl_scan(surv, warp_sums, total);
  for (int m = m0; m < m1; ++m) {
    if (state[m] != kPending) continue;
    if (rank < r2) row[r1 + rank] = list[m];
    ++rank;
  }
  // file this partition's overflow and take a finishing ticket in one
  // 64-bit atomic (blocks filed in the high word, their overflows summed
  // in the low one), issued now so its round trip overlaps the extraction
  unsigned long long* tally = reinterpret_cast<unsigned long long*>(zscr);
  const unsigned long long mine_ovf = total > r2 ? total - r2 : 0;
  unsigned long long before = 0;
  if (tid == 0) before = atomicAdd(tally, (1ull << 32) | mine_ovf);
  __syncthreads();

  // --- 4. extraction: order-preserving compaction (one block scan) -------
  int* out = pidx + (size_t)part * L;
  const int pl = (L + blockDim.x - 1) / blockDim.x;
  const int j0 = min(tid * pl, L), j1 = min(j0 + pl, L);
  int live = 0;
  for (int j = j0; j < j1; ++j) live += row[j] != ZEN_EMPTY;
  int nnz = 0;
  int pos = zen::block_excl_scan(live, warp_sums, nnz);
  for (int j = j0; j < j1; ++j) {
    const int v = row[j];
    if (v != ZEN_EMPTY) out[pos++] = v;
  }
  for (int j = nnz + tid; j < L; j += blockDim.x) out[j] = ZEN_EMPTY;

  // occupancy bitmap of the compacted row: a prefix of nnz ones
  const int W = (L + 31) / 32;
  for (int w = tid; w < W; w += blockDim.x) {
    const int lo = w * 32;
    unsigned word;
    if (nnz >= lo + 32) word = zen::kFull;
    else if (nnz <= lo) word = 0u;
    else word = (1u << (nnz - lo)) - 1u;
    occ[(size_t)part * W + w] = (int)word;
  }

  // --- 5. the overflow total: the last block to file writes it ----------
  if (tid == 0 && (before >> 32) == gridDim.x - 1) {
    *ovf_total = (int)((before & 0xFFFFFFFFull) + mine_ovf);
    *tally = 0ull;   // zero for the next call on this stream
  }
}

}  // namespace

extern "C" {

// Shared memory the encode kernel asks for, in bytes: the row and the
// candidate ballots (unless the row is wide), the warp sums and a
// candidate list of list_cap entries (with their states).
int zen_encode_smem_bytes(int C, int r1, int r2) {
  return (smem_fixed(C, r1, r2) + 2 * list_cap(C, r1, r2)) * (int)sizeof(int);
}

// Whether the encode keeps its rows and ballots in global scratch.
int zen_encode_wide(int C, int r1, int r2) { return wide_row(C, r1, r2); }

// Ints of global scratch for the candidate lists that do not fit in
// shared memory (n x 2C, or 0 when every list fits), then for wide rows
// each partition's row and ballots (n x (r1 + r2 + 4 ceil(C / 128))).
long long zen_encode_gscratch(int C, int r1, int r2, int n) {
  const long long lists = C > list_cap(C, r1, r2) ? 2LL * n * C : 0LL;
  const long long rows =
      wide_row(C, r1, r2)
          ? (long long)n * (r1 + r2 + 4LL * ((C + kChunk - 1) / kChunk))
          : 0LL;
  return lists + rows;
}

// idx int32 [C] (unique, EMPTY-padded) -> pidx int32 [n, r1+r2],
// occ int32 words [n, ceil((r1+r2)/32)], ovf int32 [1] (the total).
// zscr: 2 ints, zero, left zero (the 64-bit tally of filed blocks and
// overflows); gscr: zen_encode_gscratch ints (no initial value).
// Returns the cudaError_t of the launch (0 = success).
int zen_encode_launch(const int* idx, int C, const unsigned* seeds_host,
                      int n_seeds, int n, int r1, int r2, int* pidx, int* occ,
                      int* ovf, int* zscr, int* gscr, void* stream) {
  if (n_seeds < 2 || n_seeds > kMaxSeeds || n <= 0 || r1 <= 0 || r2 < 0 ||
      C < 0)
    return (int)cudaErrorInvalidValue;
  Seeds s = {};
  for (int i = 0; i < n_seeds; ++i) s.s[i] = seeds_host[i];
  const int smem = zen_encode_smem_bytes(C, r1, r2);
  const int lcap = list_cap(C, r1, r2);
  if (wide_row(C, r1, r2)) {
    int* gwide = gscr + (C > lcap ? 2LL * n * C : 0LL);
    zen_encode_kernel<true><<<n, kThreads, smem, (cudaStream_t)stream>>>(
        idx, C, s, n_seeds - 1, n, r1, r2, fast_mod((unsigned)n),
        fast_mod((unsigned)r1), lcap, pidx, occ, ovf, zscr, gscr, gwide);
  } else {
    // the attribute once per device, at the most any launch may ask for
    static int smem_set[kMaxDevices];
    const cudaError_t err =
        allow_smem(zen_encode_kernel<false>, kMaxSmemInts * (int)sizeof(int),
                   smem_set);
    if (err != cudaSuccess) return (int)err;
    zen_encode_kernel<false><<<n, kThreads, smem, (cudaStream_t)stream>>>(
        idx, C, s, n_seeds - 1, n, r1, r2, fast_mod((unsigned)n),
        fast_mod((unsigned)r1), lcap, pidx, occ, ovf, zscr, gscr, nullptr);
  }
  return (int)cudaGetLastError();
}

const char* zen_encode_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
