// Stream-order sums by target, shared by the COO scatter-add
// (csrc/scatter_add.cu) and the Zen commit push (csrc/zen_commit.cu).
//
// Both add rows vals[r] into target idx[r] and must be bit-exact against a
// sequential scatter-add: each target's rows are summed in stream order,
// in the values' dtype (bf16: add in f32, round once per add).  Blocks on
// the H100 run in no order, and float atomics would make each sum
// order-free (and bf16 sums not reproducible), so the rows are grouped by
// target with integer atomics, whose order does not matter, and each
// target's rows are summed in stream order by a few warps.
//
// Both kernels are one cooperative launch of the blocks that fit on the
// card at once, with grid-wide barriers (grid_sync) between phases:
//   file_rows: every live row takes a rank among its target's rows
//     (atomicAdd on the target's count) and files its row id in the
//     target's table of kTab slots; a target's first row appends it to the
//     touched list (warp-aggregated atomics);
//   -- grid_sync --
//   sum_targets: a few warps per touched target (as many as the grid has
//     for the touched targets, up to one 16-byte chunk of the row a lane)
//     read the count and the table in one access and sort the row ids (=
//     stream order: a bitonic network in registers); a run longer than
//     kTab instead takes its rows from one pass over idx, 32 positions at
//     a time.  Then they add the rows in order, one rounding per add in
//     bf16, with eight rows' loads in flight: into the target's own row
//     (the scatter-add) or from +0.0 into the touched entry's staging row,
//     setting the target's bit in a bitmap if any sum is non-zero (the
//     push).
// The zeroed scratch is left zero for the next call: each count by its
// target's last reader; the touched list's length comes in two copies, and
// each call zeroes the copy the previous call used and the next call
// takes; the barrier's own counter returns to 0.  So the wrappers keep it
// across calls and launch no memset.
#pragma once

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace zen {

constexpr int kThreads = 256;     // block size of both kernels
constexpr int kWarps = kThreads / 32;
constexpr int kTab = 16;          // table slots a target
constexpr int kMaxParts = 8;      // warps a target
constexpr int kReaderShift = 28;  // a count's bits above it tally readers
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

// Live target: in [0, rows).  EMPTY (int32 max) and negatives drop.
__device__ __forceinline__ bool live_target(int v, int rows) {
  return (unsigned)v < (unsigned)rows;
}

template <typename T>
struct Acc;

template <>
struct Acc<float> {
  static __device__ __forceinline__ float add(float a, float v) {
    return __fadd_rn(a, v);
  }
  static __device__ __forceinline__ float store(float a) { return a; }
};

template <>
struct Acc<__nv_bfloat16> {
  // one rounding to bf16 per add, exactly as a bf16 scatter-add
  static __device__ __forceinline__ float add(float a, float v) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, v)));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float a) {
    return __float2bfloat16_rn(a);
  }
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

// Warps a target's row takes: one 32-lane pass over its chunks each, at
// most kMaxParts.
__host__ __device__ __forceinline__ int max_parts(int nchunks) {
  const int p = (nchunks + 31) / 32;
  return p < kMaxParts ? p : kMaxParts;
}

// Ascending bitonic sort over the 32 lanes' registers.
__device__ __forceinline__ int warp_sort32(int key, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const int other = __shfl_xor_sync(kFull, key, j);
      const bool up = (lane & k) == 0;
      const bool low = (lane & j) == 0;
      key = (low == up) ? min(key, other) : max(key, other);
    }
  return key;
}

// Rank, file and count every live row; list the touched targets.
__device__ __forceinline__ void file_rows(const int* __restrict__ idx, int C,
                                          int M, const Scratch& s) {
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
    if (live_target(t, M)) {
      k = atomicAdd(&cnt[t], 1);
      if (k < kTab) s.tab[(size_t)t * kTab + k] = r;
    }
    const unsigned b = __ballot_sync(kFull, k == 0);
    if (b) {
      const int leader = __ffs(b) - 1;
      int base = 0;
      if (lane == leader) base = atomicAdd(ntouched, __popc(b));
      base = __shfl_sync(kFull, base, leader);
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
          acc[k] = Acc<T>::add(acc[k], to_f32(v[u].v[k]));
  }
}

// A few warps per touched target (as many as the grid's warps allow, up
// to one 16-byte chunk of the row a lane), each summing the target's rows
// in stream order over its slice of the columns.  PUSH = false: into
// dst's row t, starting from it.  PUSH = true: from +0.0 into dst's row i
// (the touched entry), and bit t of bm is set if any column of the sum is
// non-zero (-0.0 counts as zero).
template <typename T, int VEC, bool PUSH>
__device__ __forceinline__ void sum_targets(const int* __restrict__ idx,
                                            int C, int tmax,
                                            const T* __restrict__ vals, int d,
                                            T* dst, const Scratch& s,
                                            unsigned* bm) {
  __shared__ int wseg[kWarps][32];
  int* cnt = reinterpret_cast<int*>(s.zero) + kCtr;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int nchunks = d / VEC;
  const int nwarps = gridDim.x * kWarps, w0 = blockIdx.x * kWarps + warp;
  const int pmax = max_parts(nchunks);
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
    const int m = __shfl_sync(kFull, got, kTab);
    if (m <= kTab) ws[lane] = warp_sort32(lane < m ? got : kEmptyRow, lane);
    __syncwarp();
    T* row = dst + (size_t)(PUSH ? i : t) * d;
    bool nz = false;
    for (int c0 = part * 32; c0 < nchunks; c0 += parts * 32) {
      const int c = c0 + lane;
      const bool on = c < nchunks;
      Pack<T, VEC> o;
      float acc[VEC];
      if (on) {
        if (PUSH) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = 0.0f;
        } else {
          o = reinterpret_cast<const Pack<T, VEC>*>(row)[c];
#pragma unroll
          for (int k = 0; k < VEC; ++k) acc[k] = to_f32(o.v[k]);
        }
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
            const unsigned b = __ballot_sync(kFull, v[u] == t);
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
        for (int k = 0; k < VEC; ++k) {
          o.v[k] = Acc<T>::store(acc[k]);
          if (PUSH) nz |= acc[k] != 0.0f;
        }
        reinterpret_cast<Pack<T, VEC>*>(row)[c] = o;
      }
    }
    if (PUSH && __any_sync(kFull, nz) && lane == 0)
      atomicOr(bm + (t >> 5), 1u << (t & 31));
    __syncwarp();  // ws is rewritten by the warp's next target
  }
}

}  // namespace zen
