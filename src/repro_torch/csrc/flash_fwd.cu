// GQA flash attention, forward: causal or sliding-window attention with an
// online softmax in f32, output in q's dtype.
//
// Replaces the Pallas kernel repro/kernels/flash.py :: flash_fwd, which
// computes the function of repro/models/layers.py :: flash_attention (the
// prefill attention of every attention layer).  Plain version:
// repro_torch/kernels/ref.py :: flash_fwd_ref.
//
// Layout: q [B, Sq, H, HD], k and v [B, Sk, KV, HD], o like q; H = g * KV.
// Query row i sits at position q_offset + i, key j at j; a row keeps the
// keys lo <= j <= hi with hi = min(pos, Sk - 1) when causal (else Sk - 1)
// and lo = pos - window + 1 when window > 0 (else 0).  A row with no key
// in range writes zeros (the causal diagonal always is in range).
//
// Design: one block per (batch, KV head, tile of 128 / g query positions),
// one thread per query row (position, head) -- the g query heads of one
// KV head share the block, so each K/V tile is read from memory once for
// all of them (the Pallas kernel broadcasts k/v to every q head first).
// K/V tiles of 64 keys are converted to f32 in shared memory; each thread
// keeps its scaled q row and its output row in registers and updates its
// (m, l, o) online-softmax state every 16 keys.  Tiles wholly above the
// causal diagonal or before the window are never loaded; 16-key steps
// outside a row's range are skipped.
//
// What bounds it on the H100: at the qwen2-0.5b prefill shape (B 8, S 512,
// 14 q heads on 2 KV heads, HD 64, causal) the function moves about 17 MB
// (5 us at 3.35 TB/s) and does about 3.8 GFLOP of QK^T and PV.  Scores and
// P.V are computed in f32 on the FMA units, as the plain version does --
// bf16 tensor cores would round P -- so the floor is the f32 rate (about
// 56 us at 67 TFLOP/s); this simple kernel is FMA- and latency-bound well
// above it.  wgmma/TMA tiles are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;   // one query row per thread
constexpr int kBK = 64;         // keys per shared-memory tile
constexpr int kSub = 16;        // keys per online-softmax update
constexpr float kNeg = -1e30f;  // the reference's mask value

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store1(float* p, float x) { *p = x; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk,
                 int H, int KV, int causal, int window, int q_offset,
                 float scale) {
  constexpr int C4 = HD / 4;
  __shared__ float4 ks[kBK][C4];
  __shared__ float4 vs[kBK][C4];

  const int g = H / KV;
  const int bq = kThreads / g;  // query positions per block
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int pi = threadIdx.x / g, hh = threadIdx.x - pi * g;
  const int i = q0 + pi;
  const bool active = pi < bq && i < Sq;
  const int pos = q_offset + i;
  const int hi = causal ? min(pos, Sk - 1) : Sk - 1;
  const int lo = window > 0 ? pos - window + 1 : 0;

  // the keys any row of this block needs
  const int q_last = q_offset + min(q0 + bq, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin =
      window > 0 ? max(0, q_offset + q0 - window + 1) / kBK * kBK : 0;

  float qr[HD], acc[HD];
  float m = kNeg, l = 0.f;
  const size_t row = ((size_t)b * Sq + i) * H + (size_t)kvh * g + hh;
#pragma unroll
  for (int c = 0; c < C4; ++c) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) x = load4(q + row * HD + 4 * c);
    qr[4 * c] = x.x * scale;
    qr[4 * c + 1] = x.y * scale;
    qr[4 * c + 2] = x.z * scale;
    qr[4 * c + 3] = x.w * scale;
  }
#pragma unroll
  for (int d = 0; d < HD; ++d) acc[d] = 0.f;

  for (int t0 = kv_begin; t0 < kv_end; t0 += kBK) {
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < kBK * C4; e += kThreads) {
      const int j = e / C4, c = e - j * C4;
      const int key = t0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f), vv = kk;
      if (key < Sk) {
        const size_t off = (((size_t)b * Sk + key) * KV + kvh) * HD + 4 * c;
        kk = load4(k + off);
        vv = load4(v + off);
      }
      ks[j][c] = kk;
      vs[j][c] = vv;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 1
    for (int s0 = 0; s0 < kBK; s0 += kSub) {
      const int j0 = t0 + s0;
      if (j0 > hi || j0 + kSub - 1 < lo) continue;
      float p[kSub];
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        float dot = 0.f;
#pragma unroll
        for (int c = 0; c < C4; ++c) {
          const float4 kk = ks[s0 + jj][c];
          dot = fmaf(qr[4 * c], kk.x, dot);
          dot = fmaf(qr[4 * c + 1], kk.y, dot);
          dot = fmaf(qr[4 * c + 2], kk.z, dot);
          dot = fmaf(qr[4 * c + 3], kk.w, dot);
        }
        const int j = j0 + jj;
        p[jj] = (j >= lo && j <= hi) ? dot : kNeg;
        mx = fmaxf(mx, p[jj]);
      }
      const float m_new = fmaxf(m, mx);
      const float corr = expf(m - m_new);
      float ps = 0.f;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        p[jj] = expf(p[jj] - m_new);
        ps += p[jj];
      }
      l = l * corr + ps;
#pragma unroll
      for (int c = 0; c < C4; ++c) {
        float a0 = acc[4 * c] * corr, a1 = acc[4 * c + 1] * corr;
        float a2 = acc[4 * c + 2] * corr, a3 = acc[4 * c + 3] * corr;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float4 vv = vs[s0 + jj][c];
          a0 = fmaf(p[jj], vv.x, a0);
          a1 = fmaf(p[jj], vv.y, a1);
          a2 = fmaf(p[jj], vv.z, a2);
          a3 = fmaf(p[jj], vv.w, a3);
        }
        acc[4 * c] = a0;
        acc[4 * c + 1] = a1;
        acc[4 * c + 2] = a2;
        acc[4 * c + 3] = a3;
      }
      m = m_new;
    }
  }
  if (active) {
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int d = 0; d < HD; ++d) store1(o + row * HD + d, acc[d] / den);
  }
}

template <int HD, typename T>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Sk, int H, int KV, int causal, int window,
           int q_offset, cudaStream_t stream) {
  const int g = H / KV;
  const int bq = kThreads / g;
  const dim3 grid((Sq + bq - 1) / bq, KV, B);
  flash_fwd_kernel<HD, T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Sk, H, KV, causal,
      window, q_offset, 1.0f / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k/v [B, Sk, KV, hd] -> o [B, Sq, H, hd], all of one
// dtype (0 = float32, 1 = bfloat16), contiguous, 16-byte aligned.
// hd in {32, 64}; H % KV == 0 with H / KV <= 128.  Returns the
// cudaError_t of the launch (0 = success).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     int B, int Sq, int Sk, int H, int KV, int hd, int dtype,
                     int causal, int window, int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kThreads || B > 65535 || KV > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0 && hd == 64)
    return launch<64, float>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                             q_offset, s);
  if (dtype == 1 && hd == 64)
    return launch<64, __nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                     window, q_offset, s);
  if (dtype == 0 && hd == 32)
    return launch<32, float>(q, k, v, o, B, Sq, Sk, H, KV, causal, window,
                             q_offset, s);
  if (dtype == 1 && hd == 32)
    return launch<32, __nv_bfloat16>(q, k, v, o, B, Sq, Sk, H, KV, causal,
                                     window, q_offset, s);
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
