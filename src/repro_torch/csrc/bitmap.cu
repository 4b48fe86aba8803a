// Hash-bitmap pack and unpack (Alg. 2) by rows: 32 occupancy bits <-> one
// word, LSB first (bit j of a row is bit j mod 32 of its word j / 32).
//
// Replace the Pallas kernels repro/kernels/bitmap.py :: bitmap_pack (:38)
// and :: bitmap_unpack (:54), reached through repro/kernels/ops.py ::
// bitmap_pack_op / bitmap_pack_rows_op / bitmap_unpack_op and
// repro/core/formats.py :: bitmap_encode / bitmap_decode_batch.  Plain
// versions: repro_torch/kernels/ref.py :: bitmap_pack_rows_ref and
// :: bitmap_unpack_rows_ref.  Words are int32 carrying the reference's
// uint32 bits.  The 1-D forms are n = 1.
//
// PACK.  mask bool [n, L] (row pitch L bytes, no alignment assumed) ->
// words [n, W], W = ceil(L / 32); bits past L in a row are zero.  A thread
// takes four mask bytes through aligned 4-byte loads (a funnel shift for
// the row's offset; a second load only where the four cross a boundary),
// makes a nibble by a multiply, and 8 lanes OR theirs into a word.
// UNPACK.  words [n, W] -> bool [n, length], length <= 32 W, contiguous.
// A thread writes one aligned 4-byte word of the output (four bits spread
// to four bytes by a multiply); the word a row shares with its neighbour
// takes byte stores.
//
// Bound on the H100: bytes in principle (the unfused commit's [8, 19107]
// server masks, 152,856 B in + 19,136 B out, or the pull's unpack of the
// same sizes the other way: 0.05 us at 3.35 TB/s; the encode's [8, 10446]
// occupancy, 94,032 B: 0.03 us), a launch's latency in fact: a zero_() of
// the output bytes alone takes 1.06-1.24 us under the profiler.  So each
// call is one launch with one dependent load a thread and no barrier, and
// its callers pack all n server masks at once and unpack straight into
// [n, length].  Four bytes a thread beat one (a ballot a word: 600 blocks),
// eight and sixteen (fewer threads, more loads each) at these shapes;
// 4-byte stores beat one byte and 8 bytes a thread, and one input word a
// thread (32 bytes of stores each, 40 blocks).
#include <cuda_runtime.h>

#include <stdint.h>

#include "block_scan.cuh"

namespace {

constexpr int kMaxRowsInGrid = 65535;  // gridDim.y; more rows loop
constexpr int kPackThreads = 256;      // measured: 128 and 512 slower
constexpr int kUnpackThreads = 128;

// 1 in the low bit of each byte of x that is not zero
__device__ __forceinline__ unsigned nonzero_bytes(unsigned x) {
  return ((((x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu) | x) & 0x80808080u) >> 7;
}

__global__ void __launch_bounds__(kPackThreads)
bitmap_pack_kernel(const unsigned char* __restrict__ mask, int n, int L,
                   int W, int* __restrict__ words) {
  const int t = blockIdx.x * kPackThreads + threadIdx.x;  // nibble of row
  const int j = 4 * t;
  for (int r = blockIdx.y; r < n; r += gridDim.y) {
    unsigned nib = 0;
    if (j < L) {
      const uintptr_t a = (uintptr_t)(mask + (size_t)r * L + j);
      const unsigned* q = (const unsigned*)(a & ~(uintptr_t)3);
      const int off = (int)(a & 3), have = min(4, L - j);
      const unsigned lo = __ldg(q);
      const unsigned hi = off + have > 4 ? __ldg(q + 1) : 0u;
      unsigned x = __funnelshift_r(lo, hi, 8 * off);
      if (have < 4) x &= (1u << (8 * have)) - 1u;
      nib = (nonzero_bytes(x) * 0x01020408u) >> 24;  // byte i -> bit i
    }
    unsigned v = nib << (4 * (threadIdx.x & 7));
    v |= __shfl_xor_sync(zen::kFull, v, 1);
    v |= __shfl_xor_sync(zen::kFull, v, 2);
    v |= __shfl_xor_sync(zen::kFull, v, 4);
    if ((threadIdx.x & 7) == 0 && (t >> 3) < W)
      words[(size_t)r * W + (t >> 3)] = (int)v;
  }
}

// bits 0..3 of x to the low bit of bytes 0..3
__device__ __forceinline__ unsigned spread4(unsigned x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

__global__ void __launch_bounds__(kUnpackThreads)
bitmap_unpack_kernel(const int* __restrict__ words, int n, int W, int length,
                     unsigned char* __restrict__ bits) {
  const int k = blockIdx.x * kUnpackThreads + threadIdx.x;
  for (int r = blockIdx.y; r < n; r += gridDim.y) {
    const size_t r0 = (size_t)r * length, r1 = r0 + length;
    const size_t a = (r0 & ~(size_t)3) + 4 * (size_t)k;  // aligned byte
    if (a >= r1) continue;
    const int* row = words + (size_t)r * W;
    if (a >= r0 && a + 4 <= r1) {
      const int j = (int)(a - r0), w = j >> 5, s = j & 31;
      const unsigned lo = (unsigned)__ldg(row + w);
      const unsigned hi = s > 28 ? (unsigned)__ldg(row + w + 1) : 0u;
      *(unsigned*)(bits + a) = spread4(__funnelshift_r(lo, hi, s));
    } else {  // the row's first or last word, shared with a neighbour
      for (size_t b = a; b < a + 4; ++b)
        if (b >= r0 && b < r1) {
          const int j = (int)(b - r0);
          bits[b] = (unsigned char)(((unsigned)__ldg(row + (j >> 5))
                                     >> (j & 31)) & 1u);
        }
    }
  }
}

dim3 row_grid(long long per_row, int threads, int n) {
  return dim3((unsigned)((per_row + threads - 1) / threads),
              (unsigned)min(n, kMaxRowsInGrid));
}

}  // namespace

extern "C" {

// mask: n rows of L bytes of 0/1 (torch.bool) -> words int32 [n, ceil(L/32)]
int bitmap_pack_launch(const unsigned char* mask, int n, int L, int* words,
                       void* stream) {
  if (n < 0 || L < 0) return (int)cudaErrorInvalidValue;
  if (n == 0 || L == 0) return 0;
  const int W = (L + 31) / 32;
  bitmap_pack_kernel<<<row_grid(8LL * W, kPackThreads, n), kPackThreads, 0,
                       (cudaStream_t)stream>>>(mask, n, L, W, words);
  return (int)cudaGetLastError();
}

// words int32 [n, W] -> bits: n rows of `length` bytes of 0/1 (torch.bool);
// the output must be 4-byte aligned
int bitmap_unpack_launch(const int* words, int n, int W, int length,
                         unsigned char* bits, void* stream) {
  if (n < 0 || W < 0 || length < 0 || length > 32LL * W ||
      (uintptr_t)bits % 4)
    return (int)cudaErrorInvalidValue;
  if (n == 0 || length == 0) return 0;
  // the aligned words that overlap a row: at most length / 4 + 2
  bitmap_unpack_kernel<<<row_grid(length / 4 + 2, kUnpackThreads, n),
                         kUnpackThreads, 0, (cudaStream_t)stream>>>(
      words, n, W, length, bits);
  return (int)cudaGetLastError();
}

const char* bitmap_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
