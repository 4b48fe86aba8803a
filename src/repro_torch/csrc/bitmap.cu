// Hash-bitmap pack and unpack (Alg. 2): 32 occupancy bits <-> one word,
// LSB first (bit i of word w is position 32 w + i).
//
// Replace the Pallas kernels repro/kernels/bitmap.py :: bitmap_pack and
// :: bitmap_unpack (reached through repro/kernels/ops.py :: bitmap_pack_op
// and :: bitmap_unpack_op).  Plain versions: repro_torch/kernels/ref.py
// :: bitmap_pack_ref and :: bitmap_unpack_ref.  Words are int32 carrying
// the reference's uint32 bits.
//
// PACK.  mask bool [M] -> words [ceil(M/32)].  One thread per bit: word w
// is the __ballot_sync of the warp that holds bits 32w..32w+31, so the
// warp's lane 0 writes it; bits past M are zero.
// UNPACK.  words [W] -> bool [length <= 32 W].  One thread per output bit:
// (word >> (i & 31)) & 1.
//
// Bound on the H100: bytes in principle (M + M/8 bytes: about 22 KB for a
// 19107-slot server mask, 0.2 MB for the 8 gathered bitmaps of the pull;
// nanoseconds at 3.35 TB/s), launch latency in fact.  Both are single
// coalesced passes with no shared memory and no barrier.
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kThreads = 256;  // a multiple of 32: each warp owns one word

__global__ void __launch_bounds__(kThreads)
bitmap_pack_kernel(const unsigned char* __restrict__ mask, int M, int W,
                   int* __restrict__ words) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool on = i < M && mask[i] != 0;
  const unsigned word = __ballot_sync(zen::kFull, on);
  if ((threadIdx.x & 31) == 0 && (i >> 5) < W) words[i >> 5] = (int)word;
}

__global__ void __launch_bounds__(kThreads)
bitmap_unpack_kernel(const int* __restrict__ words, int length,
                     unsigned char* __restrict__ bits) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < length)
    bits[i] = (unsigned char)(((unsigned)words[i >> 5] >> (i & 31)) & 1u);
}

}  // namespace

extern "C" {

// mask: M bytes of 0/1 (torch.bool) -> words int32 [ceil(M/32)].
int bitmap_pack_launch(const unsigned char* mask, int M, int* words,
                       void* stream) {
  if (M < 0) return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  const int W = (M + 31) / 32;
  const int blocks = (W * 32 + kThreads - 1) / kThreads;
  bitmap_pack_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(mask, M,
                                                                   W, words);
  return (int)cudaGetLastError();
}

// words int32 [ceil(length/32)] -> bits: length bytes of 0/1 (torch.bool).
int bitmap_unpack_launch(const int* words, int length, unsigned char* bits,
                         void* stream) {
  if (length < 0) return (int)cudaErrorInvalidValue;
  if (length == 0) return 0;
  bitmap_unpack_kernel<<<(length + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(words, length, bits);
  return (int)cudaGetLastError();
}

const char* bitmap_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
