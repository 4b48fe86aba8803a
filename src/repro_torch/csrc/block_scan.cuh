// Helpers shared by the Zen kernels (csrc/zen_encode.cu, csrc/zen_commit.cu,
// csrc/hash_stage.cu, csrc/row_compact.cu): EMPTY, the block scan, which
// every thread of the block must call (it synchronises the block), the
// seeded hash and the multiply-only modulo.
#pragma once

#include <cuda_runtime.h>

#define ZEN_EMPTY 0x7FFFFFFF  // int32 max: "no index in this slot"

namespace zen {

constexpr unsigned kFull = 0xFFFFFFFFu;

// Exclusive prefix sum of `v` over the block in thread order; `total` gets
// the block's sum.  `warp_sums` is shared memory of at least 32 ints.  The
// block size must be a multiple of 32.
__device__ __forceinline__ int block_excl_scan(int v, int* warp_sums,
                                               int& total) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    int t = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += t;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nw ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      int t = __shfl_up_sync(kFull, s, o);
      if (lane >= o) s += t;
    }
    if (lane < nw) warp_sums[lane] = s;  // inclusive per-warp offsets
  }
  __syncthreads();
  const int excl = x - v + (warp ? warp_sums[warp - 1] : 0);
  total = warp_sums[nw - 1];
  __syncthreads();  // warp_sums may be reused by the next call
  return excl;
}

// MurmurHash3 finalizer and the seeded two-round hash of
// repro.core.hashing.hash_u32, in native uint32.
__device__ __forceinline__ unsigned fmix32(unsigned h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

__device__ __forceinline__ unsigned hash_u32(unsigned x, unsigned seed) {
  unsigned h = fmix32(x ^ seed);
  return fmix32(h ^ (seed * 0x9E3779B9u) ^ 0x5BD1E995u);
}

// x mod d for a 32-bit x by multiplies (Lemire's fastmod), with
// m = floor((2^64 - 1) / d) + 1 computed on the host; exact for every x and
// 0 < d < 2^32
struct FastMod {
  unsigned long long m;
  unsigned d;
};

inline FastMod fast_mod(unsigned d) { return {~0ull / d + 1, d}; }

__device__ __forceinline__ unsigned mod(const FastMod& f, unsigned x) {
  return (unsigned)__umul64hi(f.m * x, f.d);
}

}  // namespace zen
