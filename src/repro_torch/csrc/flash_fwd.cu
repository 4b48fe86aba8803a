// GQA flash attention, forward: causal or sliding-window attention with an
// online softmax in f32, output in q's dtype.
//
// Replaces the Pallas kernel repro/kernels/flash.py :: flash_fwd, which
// computes the function of repro/models/layers.py :: flash_attention (the
// prefill attention of every attention layer).  Plain version:
// repro_torch/kernels/ref.py :: flash_fwd_ref.
//
// Layout: q [B, Sq, H, HD_QK], k [B, Sk, KV, HD_QK], v [B, Sk, KV, HD_V],
// o [B, Sq, H, HD_V]; H = g * KV.  HD_QK = HD_V at hd 32 / 64 / 128 / 160;
// MLA (minicpm3) has q/k of 96 (64 + rope 32) and v of 64.
// Query row i sits at position q_offset + i, key j at j; a row keeps the
// keys lo <= j <= hi with hi = min(pos, Sk - 1) when causal (else Sk - 1)
// and lo = pos - window + 1 when window > 0 (else 0).  A row with no key
// in range writes zeros (the causal diagonal always is in range).
//
// Optionally (lse != nullptr, the trainer's FlashAttn) each row's
// log-sum-exp of its scaled scores, lse [B, Sq, H] f32 = m / sqrt(HD_QK) +
// log l from the kernel's own running max and sum, +inf for a row with no
// key; the plain backward (ref.py :: flash_bwd_ref) takes P = exp(s - lse)
// from it.  One store a row by the lane that holds it after the row sums;
// o is computed by the same instructions with or without it.
//
// Two kernels, chosen by dtype (never by a failure):
//
// bf16 (the served dtype): tensor cores.  The rows of a (batch, KV head)
// are its Sq x g (query, q head) pairs, query-major; one block of 8 warps
// takes 128 of them, 16 a warp, so each K/V tile is read once for the g
// heads of about 128 / g queries and a warp's rows span only 16 / g + 1
// queries (its work follows the causal diagonal closely).  Blocks are
// numbered heaviest row tile first, so the long causal rows do not trail
// the grid.  Q goes straight from memory into mma.sync A fragments and
// stays in registers.  64-key K/V tiles (bf16, rows padded by 16 B so
// ldmatrix is free of bank conflicts) fill a 2-stage shared-memory ring by
// cp.async, 16 B a thread, zero-filled past Sk; the next tile's copy
// overlaps this tile's math.  16-key groups outside all of a warp's rows'
// ranges are skipped.
//   S = Q K^T: mma.sync m16n8k16 bf16 -> f32 (exact products, f32 sums),
//   K by ldmatrix.  The online softmax runs in registers on unscaled
//   scores: each thread holds rows lane/4 and lane/4 + 8 of its warp's C
//   fragment, the row max is a __shfl_xor over the 4 threads of a row,
//   (m, l) stay in f32, and p = 2^(s c - m c) with c = log2(e) /
//   sqrt(HD_QK) on the special-function unit.  On diagonal, window-edge and
//   tail tiles the keys out of a row's range (past Sk, above the diagonal,
//   before the window) score kNeg and give p = 0 -- also in a row that has
//   kept no key yet, which exponentiates against 0 instead of kNeg.
//   P.V: P is split exactly into three bf16 parts, P = P_hi + P_mid +
//   P_lo (split3_bf16), and O += P_hi V + P_mid V + P_lo V on mma.sync
//   (V by ldmatrix.trans), so P.V is exact products with f32 sums, as in
//   the plain version.  Rounding P to bf16 alone puts 10.9 % of the serve
//   shape's 3.67 M outputs more than one bf16 ulp (+1e-6) from the plain
//   version, and a rounded two-part split (error up to 2^-18 of P) still
//   puts 5 there, near-zero outputs whose gate is about 1e-6 (the tile
//   emulation in tests/test_torch_flash.py, run as a script).  l sums the
//   f32 P.
//
// The K/V ring is dynamic shared memory at every width (86,016 B at hd
// 160), K's rows HD_QK + 8 and V's HD_V + 8 elements apart, and V is read
// one 16-column tile at a time inside the P.V loop, so only 4 of its
// registers are live.  Q K^T takes HD_QK / 16 k-steps (6 at MLA's 96), O
// has HD_V / 8 column tiles (8 at its 64).  hd 128 and 160 (qwen2.5-3b,
// phi4-mini, the MoE configs; pixtral-12b) and MLA's (96, 64) run one
// block an SM: Q's fragments and O's accumulators take HD_QK / 4 + HD_V /
// 2 registers a thread, past what two blocks of 8 warps leave.
//
// f32: the FMA units.  One block per (batch, KV head, 128 / g query
// positions) holds the g q heads of a KV head, so each K/V tile (f32 in
// shared memory) is read once for all of them; q and o rows live in
// registers and (m, l, o) are updated every 16 keys.  It stays off the
// tensor cores: TF32 keeps about 3 decimal digits, too few for the f32
// gate of 2e-5.  A query row is one thread at hd 32 / 64; at hd 128 / 160
// and MLA's (96, 64) four adjacent lanes share it, each holding a quarter
// of q and of o, and the dot products are summed across the four by
// __shfl_xor, an order the 2e-5 gate allows.
//
// Both skip tiles wholly above the causal diagonal or before the window.
//
// What bounds it on the H100: at the qwen2-0.5b prefill shape (B 8, S 512,
// 14 q heads on 2 KV heads, HD 64, causal) the function moves about 17 MB
// (5 us at 3.35 TB/s) and does about 3.8 GFLOP of QK^T and PV (4 us at
// 989 TFLOP/s bf16).  Per 16 rows x 16 keys at HD 64 the bf16 kernel
// issues 8 mma.sync for Q K^T and 24 for the split P.V, twice the count of
// an unsplit P.V, and mma.sync runs at about half of Hopper's wgmma rate;
// with the softmax between the two products and 16 warps an SM (128
// registers a thread) it is bound by the mma.sync issue rate and latency,
// not by either figure above.  wgmma over 64-row warpgroup tiles is the
// next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "smem.cuh"

namespace {

constexpr float kNeg = -1e30f;  // the reference's mask value

// ---------------------------------------------------------------------------
// bf16: mma.sync tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kMmaThreads = 32 * kWarps;
constexpr int kBM = 16 * kWarps;  // query rows per block, 16 per warp
constexpr int kBN = 64;           // keys per K/V tile
constexpr int kPad = 8;           // bf16 of padding per shared-memory row

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// four 8x8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// c += a b, a 16x16 row-major, b 16x8 col-major, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit (relative error about 2^-22)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Splits x and y exactly into three bf16 parts each, x = hi + mid + lo:
// the top 16 bits of an f32 are its value truncated to bf16, so hi keeps
// x's 8 leading significant bits, x - hi is exact and has at most 16, mid
// keeps 8 of those, and lo = x - hi - mid (exact) has at most 8 -- a bf16
// value.  p[i] packs part i of (x, y), x in the lower 16 bits (the lower
// column of an A fragment).
__device__ __forceinline__ void split3_bf16(float x, float y,
                                            uint32_t (&p)[3]) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint32_t bx = __float_as_uint(x), by = __float_as_uint(y);
    p[i] = __byte_perm(bx, by, 0x7632);
    x -= __uint_as_float(bx & 0xffff0000u);
    y -= __uint_as_float(by & 0xffff0000u);
  }
  p[2] = __byte_perm(__float_as_uint(x), __float_as_uint(y), 0x7632);
}

// The K/V ring (2 stages of K and V) in dynamic shared memory: 20,480 /
// 36,864 / 69,632 / 86,016 B at hd 32 / 64 / 128 / 160, past the 48 KB a
// static array may take at the last two; 45,056 B at (96, 64).
template <int HDQ, int HDV>
constexpr int bf16_smem_bytes() {
  return 2 * kBN * (HDQ + kPad + HDV + kPad) * (int)sizeof(__nv_bfloat16);
}

// Q's fragments and O's accumulators take HDQ / 4 + HDV / 2 registers a
// thread: two blocks of 8 warps an SM up to 48 of them (hd 32, 64), one
// block past that (hd 128, 160; MLA's 24 + 32).
template <int HDQ, int HDV>
constexpr int bf16_blocks_per_sm() {
  return HDQ / 4 + HDV / 2 > 48 ? 1 : 2;
}

template <int HDQ, int HDV>
__global__ void __launch_bounds__(kMmaThreads, bf16_blocks_per_sm<HDQ, HDV>())
flash_fwd_bf16_mma_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int B, int Sq, int Sk,
                          int H, int KV, int causal, int window,
                          int q_offset, float scale_log2e) {
  constexpr int LDK = HDQ + kPad;  // shared-memory row strides, elements
  constexpr int LDV = HDV + kPad;
  constexpr int KS = HDQ / 16;     // k-steps of Q K^T
  constexpr int ND = HDV / 8;      // 8-column tiles of O
  constexpr int NK = kBN / 16;     // 16-key groups of a tile
  constexpr int CPK = HDQ / 8;     // 16-byte chunks per key row of K
  constexpr int CPV = HDV / 8;     // and of V
  constexpr int KSTAGE = kBN * LDK;  // elements of one ring stage of K
  constexpr int VSTAGE = kBN * LDV;  // and of V
  static_assert(kBN * CPK % kMmaThreads == 0 && kBN * CPV % kMmaThreads == 0,
                "a tile's 16-byte chunks must split over the block");
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* vs = ks + 2 * KSTAGE;  // [2][kBN * LDK], [2][kBN * LDV]

  // block -> (row tile, heaviest first; KV head; batch).  The rows of a
  // (batch, KV head) are its Sq x g (query, q head) pairs, query-major, so
  // one K/V tile serves the g heads of kBM / g queries and a warp's 16 rows
  // span about 16 / g + 1 queries (little work above the causal diagonal)
  const int g = H / KV;
  const int n_rows = Sq * g;
  const int n_rt = (n_rows + kBM - 1) / kBM;
  const int per_rt = KV * B;
  const int rt = n_rt - 1 - (int)(blockIdx.x / per_rt);
  const int kvh = (int)(blockIdx.x % KV);
  const int b = (int)(blockIdx.x % per_rt) / KV;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gr = lane >> 2, tq = lane & 3;
  const int r0 = rt * kBM;

  // the keys any row of the block keeps, from a tile boundary
  const int kv_end =
      causal ? min(Sk, q_offset + (min(r0 + kBM, n_rows) - 1) / g + 1) : Sk;
  const int kv_begin =
      window > 0 ? max(0, q_offset + r0 / g - window + 1) / kBN * kBN : 0;
  const int n_tiles =
      kv_end > kv_begin ? (kv_end - kv_begin + kBN - 1) / kBN : 0;

  // this warp's rows: the keys some row keeps and the keys every row keeps
  const int w0 = r0 + 16 * warp;
  const bool warp_live = w0 < n_rows;
  const int wpos_lo = q_offset + w0 / g;
  const int wpos_hi = q_offset + min(w0 + 15, n_rows - 1) / g;
  const int any_hi = causal ? min(wpos_hi, Sk - 1) : Sk - 1;
  const int any_lo = window > 0 ? wpos_lo - window + 1 : 0;
  const int all_hi = causal ? min(wpos_lo, Sk - 1) : Sk - 1;
  const int all_lo = window > 0 ? wpos_hi - window + 1 : 0;

  // this thread's two rows (C-fragment rows lane/4 and lane/4 + 8): their
  // row index in q and o (rows of HDQ and of HDV) and the keys each keeps
  bool live_row[2];
  size_t qrow[2];
  int lo[2], hi[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int rr = w0 + gr + 8 * r;
    const int i = rr / g, hh = rr - i * g;
    live_row[r] = rr < n_rows;
    qrow[r] = ((size_t)b * Sq + i) * H + (size_t)kvh * g + hh;
    const int pos = q_offset + i;
    hi[r] = causal ? min(pos, Sk - 1) : Sk - 1;
    lo[r] = window > 0 ? pos - window + 1 : 0;
  }

  // Q as A fragments: a0/a1 rows gr/gr+8 at columns 2tq, a2/a3 at 8 + 2tq
  uint32_t qf[KS][4];
#pragma unroll
  for (int s = 0; s < KS; ++s)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        uint32_t x = 0u;
        if (live_row[r])
          x = *reinterpret_cast<const uint32_t*>(q + qrow[r] * HDQ + 16 * s +
                                                 8 * half + 2 * tq);
        qf[s][r + 2 * half] = x;
      }

  auto load_tile = [&](int stage, int t0) {
#pragma unroll
    for (int i = 0; i < kBN * CPK / kMmaThreads; ++i) {
      const int c = tid + i * kMmaThreads;
      const int j = c / CPK, part = c - j * CPK;
      const int key = t0 + j;
      const bool ok = key < Sk;
      const size_t off =
          (((size_t)b * Sk + (ok ? key : 0)) * KV + kvh) * HDQ + 8 * part;
      cp_async16(ks + stage * KSTAGE + j * LDK + 8 * part, k + off, ok);
    }
#pragma unroll
    for (int i = 0; i < kBN * CPV / kMmaThreads; ++i) {
      const int c = tid + i * kMmaThreads;
      const int j = c / CPV, part = c - j * CPV;
      const int key = t0 + j;
      const bool ok = key < Sk;
      const size_t off =
          (((size_t)b * Sk + (ok ? key : 0)) * KV + kvh) * HDV + 8 * part;
      cp_async16(vs + stage * VSTAGE + j * LDV + 8 * part, v + off, ok);
    }
    cp_async_commit();
  };

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // running max of the unscaled scores, and the row sums
  float m[2] = {kNeg, kNeg}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) load_tile(0, kv_begin);
  for (int it = 0; it < n_tiles; ++it) {
    const int t0 = kv_begin + it * kBN, st = it & 1;
    if (it + 1 < n_tiles) {
      load_tile(st ^ 1, t0 + kBN);  // overlaps this tile's math
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile it is in shared memory for every warp
    if (warp_live && t0 <= any_hi && t0 + kBN - 1 >= any_lo) {
      const bool edge = !(t0 + kBN - 1 <= all_hi && t0 >= all_lo);
      const __nv_bfloat16* kt = ks + st * KSTAGE;
      const __nv_bfloat16* vt = vs + st * VSTAGE;
      // 16-key groups that hold a key some row of the warp keeps
      bool live[NK];
#pragma unroll
      for (int j = 0; j < NK; ++j)
        live[j] = t0 + 16 * j <= any_hi && t0 + 16 * j + 15 >= any_lo;

      // S = Q K^T; group j's 8-key tiles are sc[2j], sc[2j + 1]
      float sc[2 * NK][4];
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll
      for (int s = 0; s < KS; ++s) {
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          if (!live[j]) continue;
          uint32_t r[4];  // b0/b1 of key tiles 2j and 2j + 1
          ldsm_x4(r, kt + (16 * j + (lane >> 4) * 8 + (lane & 7)) * LDK +
                         16 * s + ((lane >> 3) & 1) * 8);
          mma_bf16(sc[2 * j], qf[s], r[0], r[1]);
          mma_bf16(sc[2 * j + 1], qf[s], r[2], r[3]);
        }
      }

      // online softmax; element e of tile n is row e / 2 at key
      // t0 + 8n + 2tq + (e & 1).  On edge tiles the keys out of a row's
      // range score kNeg: they drop out of the max and give p = 0.
      if (edge) {
#pragma unroll
        for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1, key = t0 + 8 * n + 2 * tq + (e & 1);
            if (key < lo[r] || key > hi[r]) sc[n][e] = kNeg;
          }
      }
      float mx[2] = {kNeg, kNeg};
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], sc[n][e]);
      float corr[2], mc[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        corr[r] = exp2_approx((m[r] - m_new) * scale_log2e);
        m[r] = m_new;
        // a row that has kept no key yet (m = kNeg) exponentiates against 0,
        // so its kNeg scores give p = 0, never exp(kNeg - kNeg) = 1
        mc[r] = (m_new == kNeg ? 0.f : m_new) * scale_log2e;
      }
#pragma unroll
      for (int n = 0; n < ND; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e >> 1];
      float ls[2] = {0.f, 0.f};
#pragma unroll
      for (int n = 0; n < 2 * NK; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          const float p =
              live[n / 2]
                  ? exp2_approx(fmaf(sc[n][e], scale_log2e, -mc[r]))
                  : 0.f;
          sc[n][e] = p;
          ls[r] += p;
        }
      l[0] = l[0] * corr[0] + ls[0];
      l[1] = l[1] * corr[1] + ls[1];

      // O += (P_hi + P_mid + P_lo) V, 16 keys a step
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        if (!live[j]) continue;
        uint32_t a[3][4];
        {
          uint32_t p[3];
          split3_bf16(sc[2 * j][0], sc[2 * j][1], p);
          a[0][0] = p[0], a[1][0] = p[1], a[2][0] = p[2];
          split3_bf16(sc[2 * j][2], sc[2 * j][3], p);
          a[0][1] = p[0], a[1][1] = p[1], a[2][1] = p[2];
          split3_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], p);
          a[0][2] = p[0], a[1][2] = p[1], a[2][2] = p[2];
          split3_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], p);
          a[0][3] = p[0], a[1][3] = p[1], a[2][3] = p[2];
        }
        // one 16-column V tile at a time (4 registers, not HDV / 2); each
        // accumulator takes P_hi, P_mid, P_lo in that order
        const __nv_bfloat16* vrow =
            vt + (16 * j + ((lane >> 3) & 1) * 8 + (lane & 7)) * LDV +
            (lane >> 4) * 8;
#pragma unroll
        for (int dp = 0; dp < ND / 2; ++dp) {
          uint32_t r[4];
          ldsm_x4_trans(r, vrow + 16 * dp);
#pragma unroll
          for (int part = 0; part < 3; ++part) {
            mma_bf16(acc[2 * dp], a[part], r[0], r[1]);
            mma_bf16(acc[2 * dp + 1], a[part], r[2], r[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with stage st before it refills
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (!live_row[r]) continue;
    if (lse != nullptr && tq == 0)   // m holds unscaled scores
      lse[qrow[r]] = l[r] > 0.f ? m[r] * (scale_log2e * 0.6931471805599453f) +
                                      logf(l[r])
                                : __int_as_float(0x7f800000);  // +inf
    const float den = fmaxf(l[r], 1e-30f);
    __nv_bfloat16* out = o + qrow[r] * HDV + 2 * tq;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * n) = __floats2bfloat162_rn(
          acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

template <int HDQ, int HDV>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
                int window, int q_offset, cudaStream_t stream) {
  const long long rows = (long long)Sq * (H / KV);
  const long long blocks = (rows + kBM - 1) / kBM * KV * B;
  if (rows > 0x7fffffffLL || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  constexpr int smem = bf16_smem_bytes<HDQ, HDV>();
  static int smem_set[kMaxDevices];
  const cudaError_t err =
      allow_smem(flash_fwd_bf16_mma_kernel<HDQ, HDV>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_bf16_mma_kernel<HDQ, HDV><<<(unsigned)blocks, kMmaThreads, smem,
                                        stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, B, Sq, Sk, H, KV, causal, window, q_offset,
      1.4426950408889634f / sqrtf((float)HDQ));
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// f32: SPLIT threads per query row, FMA units
// ---------------------------------------------------------------------------

constexpr int kRows = 128;      // query rows per block
constexpr int kSub = 16;        // keys per online-softmax update
constexpr int kKeys = 64;       // keys per shared-memory tile

// Lanes a query row is split over: at hd 128 / 160 (and q/k 96) a row's q
// and o do not fit one thread's registers.  With one lane (hd 32 / 64) the
// shuffle loop is empty and the row's sums run in column order.
template <int HDQ, int HDV>
constexpr int kSplit = HDQ > 64 || HDV > 64 ? 4 : 1;

// The K/V tile (64 keys of K and V, f32) in dynamic shared memory: 16 / 32
// / 64 / 80 KB at hd 32 / 64 / 128 / 160, 40 KB at (96, 64).
template <int HDQ, int HDV>
constexpr int f32_smem_bytes() {
  return kKeys * (HDQ + HDV) * (int)sizeof(float);
}

// SPLIT adjacent lanes share a row, each owning the float4 chunks
// c = sub + SPLIT u of its q (and k) and of its o (and v); the q.k dot
// product is summed over the lanes by __shfl_xor (the row's lanes only),
// after which every lane holds the same scores and runs the same online
// softmax on its own columns of o.
template <int HDQ, int HDV, int SPLIT = kSplit<HDQ, HDV>>
__global__ void __launch_bounds__(kRows * SPLIT, 1)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                     int causal, int window, int q_offset, float scale) {
  constexpr int CQ = HDQ / 4;       // float4 chunks of a q / k row
  constexpr int CV = HDV / 4;       // and of a v / o row
  constexpr int TQ = CQ / SPLIT;    // chunks a lane owns
  constexpr int TV = CV / SPLIT;
  static_assert(CQ % SPLIT == 0 && CV % SPLIT == 0,
                "HD / 4 must split over the lanes");
  extern __shared__ __align__(16) unsigned char flash_smem[];
  float4* ks = reinterpret_cast<float4*>(flash_smem);   // [kKeys][CQ]
  float4* vs = ks + kKeys * CQ;                         // [kKeys][CV]

  const int g = H / KV;
  const int bq = kRows / g;  // query positions per block
  const int b = blockIdx.z, kvh = blockIdx.y;
  const int q0 = blockIdx.x * bq;
  const int rr = threadIdx.x / SPLIT, sub = threadIdx.x % SPLIT;
  const int pi = rr / g, hh = rr - pi * g;
  const int i = q0 + pi;
  const bool active = pi < bq && i < Sq;
  const int pos = q_offset + i;
  const int hi = causal ? min(pos, Sk - 1) : Sk - 1;
  const int lo = window > 0 ? pos - window + 1 : 0;
  // the lanes of this row (all active or all not)
  const unsigned rmask = ((1u << SPLIT) - 1u)
                         << ((threadIdx.x & 31) & ~(SPLIT - 1));

  // the keys any row of this block needs
  const int q_last = q_offset + min(q0 + bq, Sq) - 1;
  const int kv_end = causal ? min(Sk, q_last + 1) : Sk;
  const int kv_begin =
      window > 0 ? max(0, q_offset + q0 - window + 1) / kKeys * kKeys : 0;

  float qr[4 * TQ], acc[4 * TV];
  float m = kNeg, l = 0.f;
  const size_t row = ((size_t)b * Sq + i) * H + (size_t)kvh * g + hh;
#pragma unroll
  for (int u = 0; u < TQ; ++u) {
    const int c = sub + SPLIT * u;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (active) x = *reinterpret_cast<const float4*>(q + row * HDQ + 4 * c);
    qr[4 * u] = x.x * scale;
    qr[4 * u + 1] = x.y * scale;
    qr[4 * u + 2] = x.z * scale;
    qr[4 * u + 3] = x.w * scale;
  }
#pragma unroll
  for (int d = 0; d < 4 * TV; ++d) acc[d] = 0.f;

  for (int t0 = kv_begin; t0 < kv_end; t0 += kKeys) {
    __syncthreads();  // every row is done with the previous tile
    for (int e = threadIdx.x; e < kKeys * CQ; e += kRows * SPLIT) {
      const int j = e / CQ, c = e - j * CQ;
      const int key = t0 + j;
      float4 kk = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key < Sk)
        kk = *reinterpret_cast<const float4*>(
            k + (((size_t)b * Sk + key) * KV + kvh) * HDQ + 4 * c);
      ks[e] = kk;
    }
    for (int e = threadIdx.x; e < kKeys * CV; e += kRows * SPLIT) {
      const int j = e / CV, c = e - j * CV;
      const int key = t0 + j;
      float4 vv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (key < Sk)
        vv = *reinterpret_cast<const float4*>(
            v + (((size_t)b * Sk + key) * KV + kvh) * HDV + 4 * c);
      vs[e] = vv;
    }
    __syncthreads();
    if (!active) continue;
#pragma unroll 1
    for (int s0 = 0; s0 < kKeys; s0 += kSub) {
      const int j0 = t0 + s0;
      if (j0 > hi || j0 + kSub - 1 < lo) continue;
      float p[kSub];
      float mx = kNeg;
#pragma unroll
      for (int jj = 0; jj < kSub; ++jj) {
        const float4* kr = ks + (s0 + jj) * CQ + sub;
        float dot = 0.f;
#pragma unroll
        for (int u = 0; u < TQ; ++u) {
          const float4 kk = kr[SPLIT * u];
          dot = fmaf(qr[4 * u], kk.x, dot);
          dot = fmaf(qr[4 * u + 1], kk.y, dot);
          dot = fmaf(qr[4 * u + 2], kk.z, dot);
          dot = fmaf(qr[4 * u + 3], kk.w, dot);
        }
#pragma unroll
        for (int w = 1; w < SPLIT; w <<= 1)
          dot += __shfl_xor_sync(rmask, dot, w);
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
      for (int u = 0; u < TV; ++u) {
        float a0 = acc[4 * u] * corr, a1 = acc[4 * u + 1] * corr;
        float a2 = acc[4 * u + 2] * corr, a3 = acc[4 * u + 3] * corr;
#pragma unroll
        for (int jj = 0; jj < kSub; ++jj) {
          const float4 vv = vs[(s0 + jj) * CV + sub + SPLIT * u];
          a0 = fmaf(p[jj], vv.x, a0);
          a1 = fmaf(p[jj], vv.y, a1);
          a2 = fmaf(p[jj], vv.z, a2);
          a3 = fmaf(p[jj], vv.w, a3);
        }
        acc[4 * u] = a0;
        acc[4 * u + 1] = a1;
        acc[4 * u + 2] = a2;
        acc[4 * u + 3] = a3;
      }
      m = m_new;
    }
  }
  if (active) {
    if (lse != nullptr && sub == 0)   // m holds scaled scores
      lse[row] = l > 0.f ? m + logf(l) : __int_as_float(0x7f800000);  // +inf
    const float den = fmaxf(l, 1e-30f);
#pragma unroll
    for (int u = 0; u < TV; ++u)
      *reinterpret_cast<float4*>(o + row * HDV + 4 * (sub + SPLIT * u)) =
          make_float4(acc[4 * u] / den, acc[4 * u + 1] / den,
                      acc[4 * u + 2] / den, acc[4 * u + 3] / den);
  }
}

template <int HDQ, int HDV>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Sk, int H, int KV, int causal,
               int window, int q_offset, cudaStream_t stream) {
  const int g = H / KV;
  const int bq = kRows / g;
  const dim3 grid((Sq + bq - 1) / bq, KV, B);
  constexpr int smem = f32_smem_bytes<HDQ, HDV>();
  static int smem_set[kMaxDevices];
  const cudaError_t err =
      allow_smem(flash_fwd_f32_kernel<HDQ, HDV>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  flash_fwd_f32_kernel<HDQ, HDV>
      <<<grid, kRows * kSplit<HDQ, HDV>, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Sk,
          H, KV, causal, window, q_offset, 1.0f / sqrtf((float)HDQ));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [B, Sq, H, hd], k [B, Sk, KV, hd], v [B, Sk, KV, hd_v] -> o [B, Sq, H,
// hd_v], all of one dtype (0 = float32: the FMA kernel; 1 = bfloat16: the
// tensor-core kernel), contiguous, 16-byte aligned; lse [B, Sq, H] f32 or
// null (not written).  (hd, hd_v) in {(32, 32), (64, 64), (128, 128),
// (160, 160), (96, 64)}; H % KV == 0 with H / KV <= 128.  Returns the
// cudaError_t of the launch (0 = success).
int flash_fwd_launch(const void* q, const void* k, const void* v, void* o,
                     void* lse, int B, int Sq, int Sk, int H, int KV, int hd,
                     int hd_v, int dtype, int causal, int window,
                     int q_offset, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      H / KV > kRows || B > 65535 || KV > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  float* ls = static_cast<float*>(lse);
#define FLASH_CASE(HDQ, HDV)                                                \
  if (hd == HDQ && hd_v == HDV)                                             \
    return dtype == 0                                                       \
               ? launch_f32<HDQ, HDV>(q, k, v, o, ls, B, Sq, Sk, H, KV,     \
                                      causal, window, q_offset, s)          \
               : launch_bf16<HDQ, HDV>(q, k, v, o, ls, B, Sq, Sk, H, KV,    \
                                       causal, window, q_offset, s);
  FLASH_CASE(64, 64)
  FLASH_CASE(32, 32)
  FLASH_CASE(128, 128)
  FLASH_CASE(160, 160)
  FLASH_CASE(96, 64)
#undef FLASH_CASE
  return (int)cudaErrorInvalidValue;
}

const char* flash_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
