// Hash stage of Alg. 1: p = h0(idx) mod n and q_i = h_i(idx) mod r1 for
// every index, with EMPTY mapped to the (n, r1) sentinels.
//
// Replaces the Pallas kernel repro/kernels/hash_stage.py :: hash_stage
// (reached through repro/kernels/ops.py :: hash_stage_op).  Plain version:
// repro_torch/kernels/ref.py :: hash_stage_ref.
//
// indices int32 [C] -> p int32 [C], q int32 [k, C] (the reference's
// layout).  One thread per index evaluates the k+1 seeded hashes with the
// device functions of block_scan.cuh, the ones csrc/zen_encode.cu uses, so
// the two kernels cannot drift apart.  The TPU kernel baked the seeds in
// as compile-time constants; here they are a kernel argument.
//
// Bound on the H100: bytes, barely.  Each index is read once and k+1 ints
// are written (760 KB at C = 37984, k = 3: 0.23 us at 3.35 TB/s); the
// 2(k+1) fmix32 rounds and k+1 modulos are ~160 integer operations per
// index, about as long again at the card's integer rate.  At this size
// the launch itself dominates; the design does nothing more than keep the
// loads and stores coalesced (neighbouring threads, neighbouring indices).
#include <cuda_runtime.h>

#include "block_scan.cuh"

namespace {

constexpr int kMaxSeeds = 16;
constexpr int kThreads = 256;

struct Seeds {
  unsigned s[kMaxSeeds];
};

__global__ void __launch_bounds__(kThreads)
hash_stage_kernel(const int* __restrict__ idx, int C, Seeds seeds, int k,
                  int n, int r1, int* __restrict__ p, int* __restrict__ q) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  const int x = idx[c];
  const bool valid = x != ZEN_EMPTY;
  p[c] = valid ? (int)(zen::hash_u32((unsigned)x, seeds.s[0]) % (unsigned)n)
               : n;
  for (int i = 0; i < k; ++i)
    q[(size_t)i * C + c] =
        valid ? (int)(zen::hash_u32((unsigned)x, seeds.s[i + 1]) %
                      (unsigned)r1)
              : r1;
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
  hash_stage_kernel<<<(C + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(idx, C, sd, n_seeds - 1, n, r1,
                                              p, q);
  return (int)cudaGetLastError();
}

const char* hash_stage_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
