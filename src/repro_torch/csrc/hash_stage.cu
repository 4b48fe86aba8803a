// Hash stage of Alg. 1: p = h0(idx) mod n and q_i = h_i(idx) mod r1 for
// every index, with EMPTY mapped to the (n, r1) sentinels.
//
// Replaces the Pallas kernel repro/kernels/hash_stage.py :: hash_stage
// (reached through repro/kernels/ops.py :: hash_stage_op).  Plain version:
// repro_torch/kernels/ref.py :: hash_stage_ref.
//
// indices int32 [C] -> p int32 [C], q int32 [k, C] (the reference's
// layout).  The hash and the modulo are the device functions of
// block_scan.cuh that csrc/zen_encode.cu uses, so the two kernels cannot
// drift apart.  The TPU kernel baked the seeds in as compile-time
// constants; here they are a kernel argument.
//
// Bound on the H100: bytes.  Each index is read once and k+1 ints are
// written (760 KB at C = 37984, k = 3: 0.23 us at 3.35 TB/s), but at that
// size the time is how fast the (k+1) C stores drain, and that grows with
// the stores each warp must send one after another, not with the bytes:
// on an H100, four indices a thread with one 16-byte load and k+1 16-byte
// stores ran about 1 us longer than one index a thread with k+1 4-byte
// stores.  So:
//   * one thread a (row, index) pair of the output: block (x, i) writes
//     row i (p for i = 0, q's row i - 1 after it) at indices
//     x * 256 + [0, 256), one load and one coalesced 4-byte store a
//     thread, (k+1) x as many warps in flight as indices need;
//   * an EMPTY index (nearly all of them at the realistic stream: the
//     index vector is compacted, its live entries at the front) takes its
//     sentinel without hashing;
//   * x mod n and x mod r1 take the multiply-only FastMod, its constant
//     computed once per divisor on the host, where a 32-bit `%` by a
//     runtime divisor is a ~20-instruction sequence.
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kMaxSeeds = 16;
constexpr int kThreads = 256;

struct Seeds {
  unsigned s[kMaxSeeds];
};

__global__ void __launch_bounds__(kThreads)
hash_stage_kernel(const int* __restrict__ idx, int C, Seeds seeds, int n,
                  int r1, zen::FastMod mod_n, zen::FastMod mod_r1,
                  int* __restrict__ p, int* __restrict__ q) {
  const unsigned c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= (unsigned)C) return;
  const int i = blockIdx.y;
  const int x = __ldg(idx + c);
  int o = i == 0 ? n : r1;
  if (x != ZEN_EMPTY)
    o = (int)zen::mod(i == 0 ? mod_n : mod_r1,
                      zen::hash_u32((unsigned)x, seeds.s[i]));
  (i == 0 ? p : q + (size_t)(i - 1) * C)[c] = o;
}

}  // namespace

extern "C" {

// seeds: k+1 uint32 values (h0, h1..hk).  Returns the cudaError_t of the
// launch (0 = success).
int hash_stage_launch(const int* idx, int C, const unsigned* seeds,
                      int n_seeds, int n, int r1, int* p, int* q,
                      void* stream) {
  if (n_seeds < 1 || n_seeds > kMaxSeeds || n <= 0 || r1 <= 0)
    return (int)cudaErrorInvalidValue;
  if (C <= 0) return 0;
  Seeds sd{};
  for (int i = 0; i < n_seeds; ++i) sd.s[i] = seeds[i];
  const dim3 grid((unsigned)((C - 1) / kThreads + 1), (unsigned)n_seeds);
  hash_stage_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      idx, C, sd, n, r1, zen::fast_mod((unsigned)n),
      zen::fast_mod((unsigned)r1), p, q);
  return (int)cudaGetLastError();
}

const char* hash_stage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
