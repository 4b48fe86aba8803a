// Mamba2 SSD chunk scan, forward (state-space duality, arXiv:2405.21060).
//
// Replaces the Pallas kernel repro/kernels/ssd.py :: ssd_fwd, which
// computes the scan of repro/models/ssm.py :: _ssd_chunked (the prefill
// of every Mamba2 layer).  Plain version: repro_torch/kernels/ref.py ::
// ssd_fwd_ref.
//
// Layout (the model's, no transposes): x [Bt, S, H, hd] f32 with dt folded
// in; dA [Bt, S, H] f32 log-decays; B and C [Bt, S, N] f32, shared by all
// heads (ngroups = 1: read with a head stride of 0, never broadcast).
// Outputs y [Bt, S, H, hd] f32 and the final state [Bt, H, hd, N] f32.
// Per chunk of Q steps, with cs = cumsum(dA), L_ij = exp(cs_i - cs_j) for
// j <= i (else 0) and w = exp(cs_Q - cs):
//     y = ((C B^T) o L) x + exp(cs) o (C S^T)
//     S <- S exp(cs_Q) + (x o w)^T B
//
// Design: the TPU's sequential chunk axis becomes a loop inside one block
// per (sequence, head); the [hd, N] state (32 KB at hd 64, N 128) stays in
// shared memory across chunks, stored transposed.  Each chunk stages x, B
// (both ways round), C^T and the masked decay matrix in shared memory, and
// every product is a loop over 4x4 register tiles fed by float4 reads;
// tiles above the causal diagonal are skipped.  All arithmetic is f32 on
// the FMA units: TF32 tensor cores would break the 2e-4 tolerance.
//
// What bounds it on the H100: at the mamba2-370m prefill shape (Bt 8,
// S 512, 32 heads, hd 64, N 128, Q 64) the function moves about 80 MB
// (24 us at 3.35 TB/s) and does about 7.5 GFLOP in f32 (112 us at
// 67 TFLOP/s): operations bound it.  A block takes 161 KB of shared
// memory, so one fits an SM and 256 blocks run in two waves on 132 SMs;
// the per-head recomputation of C B^T (shared by the heads) is a later
// saving.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

// acc[a][b] += x[a] * y[b]
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 x,
                                       float4 y) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
  const float ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = fmaf(xs[a], ys[b], acc[a][b]);
}

__device__ __forceinline__ void zero4(float (&acc)[4][4]) {
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
}

__global__ void __launch_bounds__(kThreads)
ssd_fwd_kernel(const float* __restrict__ x, const float* __restrict__ dA,
               const float* __restrict__ Bm, const float* __restrict__ Cm,
               float* __restrict__ y, float* __restrict__ state, int S,
               int H, int hd, int N, int Q) {
  extern __shared__ float4 smem4[];
  float* sT = reinterpret_cast<float*>(smem4);  // [N][hd]  state, transposed
  float* cT = sT + N * hd;                      // [N][Q]   C^T
  float* bT = cT + N * Q;                       // [N][Q]   B^T
  float* bn = bT + N * Q;                       // [Q][N]   B
  float* xs = bn + Q * N;                       // [Q][hd]  x
  float* mT = xs + Q * hd;                      // [Q][Q]   ((C B^T) o L)^T
  float* cs = mT + Q * Q;                       // [Q]      cumsum(dA)
  float* ecs = cs + Q;                          // [Q]      exp(cs)
  float* w = ecs + Q;                           // [Q]      exp(cs_Q - cs)

  const int bt = blockIdx.x / H, h = blockIdx.x - bt * H;
  const int tid = threadIdx.x;
  const int Q4 = Q / 4, N4 = N / 4, D4 = hd / 4;

  for (int e = tid; e < N * hd; e += kThreads) sT[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const size_t t0 = (size_t)bt * S + c0;  // first time step of the chunk
    // ---- stage the chunk ------------------------------------------------
    if (tid < Q) cs[tid] = dA[(t0 + tid) * H + h];
    for (int e = tid; e < Q * D4; e += kThreads) {
      const int i = e / D4, d4 = e - i * D4;
      st4(xs + i * hd + 4 * d4, ld4(x + ((t0 + i) * H + h) * hd + 4 * d4));
    }
    for (int e = tid; e < Q * N4; e += kThreads) {  // B row-major, coalesced
      const int i = e / N4, n4 = e - i * N4;
      st4(bn + i * N + 4 * n4, ld4(Bm + (t0 + i) * N + 4 * n4));
    }
    for (int e = tid; e < Q * N4; e += kThreads) {  // B^T, C^T: lanes on i
      const int i = e % Q, n = 4 * (e / Q);
      const float4 b4 = ld4(Bm + (t0 + i) * N + n);
      const float4 c4 = ld4(Cm + (t0 + i) * N + n);
      bT[n * Q + i] = b4.x;
      bT[(n + 1) * Q + i] = b4.y;
      bT[(n + 2) * Q + i] = b4.z;
      bT[(n + 3) * Q + i] = b4.w;
      cT[n * Q + i] = c4.x;
      cT[(n + 1) * Q + i] = c4.y;
      cT[(n + 2) * Q + i] = c4.z;
      cT[(n + 3) * Q + i] = c4.w;
    }
    __syncthreads();
    if (tid == 0) {  // sequential cumsum, as the plain version's order
      float run = 0.f;
      for (int i = 0; i < Q; ++i) {
        run += cs[i];
        cs[i] = run;
      }
    }
    __syncthreads();
    if (tid < Q) {
      ecs[tid] = expf(cs[tid]);
      w[tid] = expf(cs[Q - 1] - cs[tid]);
    }
    // ---- M^T[j][i] = (C_i . B_j) exp(cs_i - cs_j) for j <= i --------------
    for (int t = tid; t < Q4 * Q4; t += kThreads) {
      const int i0 = 4 * (t / Q4), j0 = 4 * (t % Q4);
      float acc[4][4];
      zero4(acc);
      if (j0 <= i0 + 3) {
        for (int n = 0; n < N; ++n)
          outer4(acc, ld4(cT + n * Q + i0), ld4(bT + n * Q + j0));
      }
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = j0 + b;
        float col[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          const int i = i0 + a;
          col[a] = j <= i ? acc[a][b] * expf(cs[i] - cs[j]) : 0.f;
        }
        st4(mT + j * Q + i0, make_float4(col[0], col[1], col[2], col[3]));
      }
    }
    __syncthreads();
    // ---- y = M x + exp(cs) o (C S^T), before the state moves -------------
    for (int t = tid; t < Q4 * D4; t += kThreads) {
      const int i0 = 4 * (t / D4), d0 = 4 * (t % D4);
      float yin[4][4], yst[4][4];
      zero4(yin);
      zero4(yst);
      const int jn = min(i0 + 4, Q);
      for (int j = 0; j < jn; ++j)
        outer4(yin, ld4(mT + j * Q + i0), ld4(xs + j * hd + d0));
      for (int n = 0; n < N; ++n)
        outer4(yst, ld4(cT + n * Q + i0), ld4(sT + n * hd + d0));
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float e = ecs[i0 + a];
        st4(y + ((t0 + i0 + a) * H + h) * hd + d0,
            make_float4(yin[a][0] + e * yst[a][0], yin[a][1] + e * yst[a][1],
                        yin[a][2] + e * yst[a][2],
                        yin[a][3] + e * yst[a][3]));
      }
    }
    __syncthreads();
    // ---- S^T[n][d] <- S^T[n][d] exp(cs_Q) + sum_q B[q][n] x[q][d] w[q] ----
    const float etot = expf(cs[Q - 1]);
    for (int t = tid; t < N4 * D4; t += kThreads) {
      const int n0 = 4 * (t / D4), d0 = 4 * (t % D4);
      float acc[4][4];
      zero4(acc);
      for (int qq = 0; qq < Q; ++qq) {
        const float4 x4 = ld4(xs + qq * hd + d0);
        const float wq = w[qq];
        outer4(acc, ld4(bn + qq * N + n0),
               make_float4(x4.x * wq, x4.y * wq, x4.z * wq, x4.w * wq));
      }
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        float* sp = sT + (n0 + a) * hd + d0;
        const float4 s4 = ld4(sp);
        st4(sp, make_float4(fmaf(s4.x, etot, acc[a][0]),
                            fmaf(s4.y, etot, acc[a][1]),
                            fmaf(s4.z, etot, acc[a][2]),
                            fmaf(s4.w, etot, acc[a][3])));
      }
    }
    __syncthreads();
  }
  // final state [Bt, H, hd, N]
  float* out = state + ((size_t)bt * H + h) * hd * N;
  for (int e = tid; e < hd * N; e += kThreads) {
    const int d = e / N, n = e - d * N;
    out[e] = sT[n * hd + d];
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs, in bytes.
int ssd_fwd_smem_bytes(int hd, int N, int Q) {
  return (N * hd + 3 * N * Q + Q * hd + Q * Q + 3 * Q) * (int)sizeof(float);
}

// x [Bt, S, H, hd], dA [Bt, S, H], B/C [Bt, S, N] (all f32, contiguous,
// 16-byte aligned) -> y [Bt, S, H, hd], state [Bt, H, hd, N].  S % Q == 0;
// hd, N and Q multiples of 4 with Q <= 256.  Returns the cudaError_t of
// the launch (0 = success).
int ssd_fwd_launch(const float* x, const float* dA, const float* Bm,
                   const float* Cm, float* y, float* state, int Bt, int S,
                   int H, int hd, int N, int Q, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kThreads || S % Q ||
      hd % 4 || N % 4 || Q % 4)
    return (int)cudaErrorInvalidValue;
  const int smem = ssd_fwd_smem_bytes(hd, N, Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_kernel<<<Bt * H, kThreads, smem, (cudaStream_t)stream>>>(
      x, dA, Bm, Cm, y, state, S, H, hd, N, Q);
  return (int)cudaGetLastError();
}

const char* ssd_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
