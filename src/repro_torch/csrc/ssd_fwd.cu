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
// Design.  Two launches, the second a programmatic dependent launch that
// starts while the first runs.  ssd_fwd_cbt_kernel computes G = C B^T
// once per (sequence, chunk) for all heads (ngroups = 1), in f32 FMA, one
// block per 16-row query tile and only the keys up to its diagonal,
// stored in the order the tensor cores read it (1 MB at the serve shape:
// it stays in L2).  ssd_fwd_scan_kernel keeps one block per
// (sequence, head) with the chunk loop inside it, as the TPU's sequential
// chunk axis; parallelising over chunks would write every chunk's state
// out.  Its three products run on the tensor cores, mma.sync m16n8k8
// TF32, each operand split a = hi + lo (hi = tf32(a) rounded, lo = a - hi,
// which the tensor cores truncate to TF32) and multiplied as hi.hi +
// hi.lo + lo.hi with f32 sums: one TF32 term would miss the 2e-4
// tolerance, three keep f32 accuracy.  Products go in pairs on two
// accumulators (mma3x2), so none waits on the one before it, and each
// step's product joins its running sum by an f32 add (round to nearest).
//   - The [hd, N] state lives in the warps' accumulator fragments (warp w:
//     16 rows of hd, N / NH columns), never in shared memory: the state
//     update (x o w)^T B accumulates into it, and C S^T reads it back as
//     its B operand, permuting k inside each 8-wide step (accumulator
//     columns 2t, 2t+1 are B rows t, t+4; C's A fragment permutes alike).
//   - C S^T is split over the NH warps that share 16 rows of hd; each
//     query tile's partial sums meet in one warp (shared memory), which
//     adds exp(cs) o (C S^T) and accumulates ((C B^T) o L) x on top.
//   - Shared memory (rows padded by 8 floats: fragment reads are free of
//     bank conflicts) holds x and dA twice, so the next chunk's land while
//     this one computes, and B and C once; once C S^T has read C, its
//     place takes the chunk's G (cp.async, landing during the state
//     update), turned into M = G o L in place by all the block's threads,
//     and the partial sums.  105 KB at the serve shape, so two
//     blocks share an SM.  B and C of the next chunk, shared by all heads
//     and so in L2, load once their buffer's last reader is done: B during
//     ((C B^T) o L) x, C after it.
//   - cumsum(dA) runs on one lane in the plain version's order (a warp
//     scan rounds its partial sums another way, which exp(cs) amplifies;
//     the f32 mamba2 serve check then fails).
//
// What bounds it on the H100: at the mamba2-370m prefill shape (Bt 8,
// S 512, 32 heads, hd 64, N 128, Q 64) the function moves about 80 MB
// (24 us at 3.35 TB/s) and does 4.87 GFLOP counting C B^T once per
// sequence: 73 us at the f32 FMA rate of 67 TFLOP/s, 30 us at a third of
// the 495 TFLOP/s TF32 tensor-core rate (three products per split
// product).  Operations bound it.
#include <cuda_runtime.h>

#include "smem.cuh"

namespace {

constexpr int kMaxQ = 64;            // largest chunk the kernels take
constexpr int kMaxQT = kMaxQ / 16;   // query tiles of 16 rows
constexpr int kCbtThreads = 256;  // 16 rows x 64 key columns

// Work split of the scan kernel for head dim HD and state dim N.
template <int HD, int N>
struct Cfg {
  static constexpr int kHD = HD, kN = N;
  static constexpr int DT = HD / 16;                     // 16-row hd tiles
  static constexpr int NW = DT * (N / 8) < 8 ? DT * (N / 8) : 8;  // warps
  static constexpr int NH = NW / DT;                     // warps per hd tile
  static constexpr int NN = N / NH;                      // state cols a warp
  static constexpr int NT = NN / 8;                      // ... in 8-col tiles
  static constexpr int XS = HD + 8;                      // x row stride
  static constexpr int BS = N + 8;                       // B, C row stride
  static_assert(NN % 8 == 0, "a warp owns whole 8-column state tiles");
  // floats of the region that holds C, then G and the partial sums
  __host__ __device__ static constexpr int region(int Qp) {
    return Qp * BS > Qp * (Qp + (NH - 1) * XS) ? Qp * BS
                                               : Qp * (Qp + (NH - 1) * XS);
  }
};

int pad16(int q) { return (q + 15) & ~15; }

// ---- TF32 split products ---------------------------------------------------

struct Split {
  unsigned hi, lo;
};

// hi = x rounded to TF32, to nearest with ties away from zero (as
// cvt.rna.tf32.f32, in two integer operations: the conversion unit issues
// at a fraction of their rate); lo = x - hi, exact, passed as it is: the
// tensor cores read the top 19 bits of a TF32 operand and drop the rest,
// which truncates lo to TF32, an error below 2^-21 of x.
__device__ __forceinline__ Split split(float x) {
  const unsigned hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  return {hi, __float_as_uint(x - __uint_as_float(hi))};
}

__device__ __forceinline__ void mma(float (&d)[4], unsigned a0, unsigned a1,
                                    unsigned a2, unsigned a3, unsigned b0,
                                    unsigned b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d = a.lo b.hi, from zero (C = 0 costs no register)
__device__ __forceinline__ void mma_lohi0(float (&d)[4], const Split (&a)[4],
                                          const Split (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0].lo), "r"(a[1].lo), "r"(a[2].lo), "r"(a[3].lo),
        "r"(b[0].hi), "r"(b[1].hi), "f"(0.f));
}
__device__ __forceinline__ void mma_hilo(float (&d)[4], const Split (&a)[4],
                                         const Split (&b)[2]) {
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].lo, b[1].lo);
}
__device__ __forceinline__ void mma_hihi(float (&d)[4], const Split (&a)[4],
                                         const Split (&b)[2]) {
  mma(d, a[0].hi, a[1].hi, a[2].hi, a[3].hi, b[0].hi, b[1].hi);
}

// d += a b alone, as one of mma3x2's pair.
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     const Split (&b)[2]) {
  float t[4];
  mma_lohi0(t, a, b);
  mma_hilo(t, a, b);
  mma_hihi(t, a, b);
#pragma unroll
  for (int r = 0; r < 4; ++r) d[r] += t[r];
}

// d0 += a0 b0 and d1 += a1 b1, with the operands split: lo.hi + hi.lo +
// hi.hi each, smallest first, the two sums interleaved so that no product
// waits on the one before it.  Each 8-deep step's product is summed on
// the tensor cores from zero and added to d with an f32 add: the running
// sums round to nearest, as the plain version's do, not in the tensor
// cores' own accumulation (which the f32 mamba2 serve check's greedy
// tokens, at a near-tie, tell apart).
__device__ __forceinline__ void mma3x2(float (&d0)[4], float (&d1)[4],
                                       const Split (&a0)[4],
                                       const Split (&a1)[4],
                                       const Split (&b0)[2],
                                       const Split (&b1)[2]) {
  float t0[4], t1[4];
  mma_lohi0(t0, a0, b0);
  mma_lohi0(t1, a1, b1);
  mma_hilo(t0, a0, b0);
  mma_hilo(t1, a1, b1);
  mma_hihi(t0, a0, b0);
  mma_hihi(t1, a1, b1);
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    d0[r] += t0[r];
    d1[r] += t1[r];
  }
}

// ---- cp.async ---------------------------------------------------------------

// 16 (or 4) bytes from global to shared memory; zeros when !valid.
__device__ __forceinline__ void cp16(float* s, const float* g, bool valid) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sa),
               "l"(g), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp4(float* s, const float* g, bool valid) {
  const unsigned sa = (unsigned)__cvta_generic_to_shared(s);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sa),
               "l"(g), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// rows [0, n) of a [.., W]-float row array (W a multiple of 4, rows
// `rstride` floats apart) into shared rows of stride `ss`; rows at or
// past `valid` are zeros
__device__ __forceinline__ void load_rows(float* dst, int ss,
                                          const float* src, size_t rstride,
                                          int W, int valid, int n, int nthr) {
  for (int e = threadIdx.x; e < n * (W / 4); e += nthr) {
    const int i = e / (W / 4), c = 4 * (e - i * (W / 4));
    cp16(dst + i * ss + c, i < valid ? src + i * rstride + c : src,
         i < valid);
  }
}

// ---- G = C B^T per (sequence, chunk), in fragment order --------------------

// G entry (i, j) of a chunk lives at frag_index(i, j): query tile i / 16,
// key step j / 8, then the lane and register of mma.sync's A fragment.
__device__ __forceinline__ int frag_index(int i, int j, int KT) {
  const int ii = i & 15, jj = j & 7;
  const int lane = (ii & 7) * 4 + (jj & 3);
  const int r = (ii >> 3) + 2 * (jj >> 2);
  return (((i >> 4) * KT + (j >> 3)) * 32 + lane) * 4 + r;
}

__global__ void __launch_bounds__(kCbtThreads)
ssd_fwd_cbt_kernel(const float* __restrict__ Bm,
                   const float* __restrict__ Cm, float* __restrict__ G, int S,
                   int N, int Q, int Qp) {
  extern __shared__ float4 smem4[];
  // the scan kernel may start now; it waits for G before it reads it
  asm volatile("griddepcontrol.launch_dependents;\n" ::);
  const int QT = Qp / 16, KT = Qp / 8, nc = S / Q;
  const int mi = blockIdx.x % QT, seq_chunk = blockIdx.x / QT;
  const int bt = seq_chunk / nc, ci = seq_chunk - bt * nc;
  const int JW = 16 * (mi + 1);  // the key columns up to the diagonal
  const int NS = N + 4;          // row stride: float4 reads by row spread
  float* cr = reinterpret_cast<float*>(smem4);  // [16][NS]  its C rows
  float* br = cr + 16 * NS;                     // [JW][NS]  B rows
  const size_t t0 = (size_t)bt * S + (size_t)ci * Q;
  load_rows(cr, NS, Cm + (t0 + 16 * mi) * N, N, N, Q - 16 * mi, 16,
            kCbtThreads);
  load_rows(br, NS, Bm + t0 * N, N, N, Q, JW, kCbtThreads);
  cp_commit();
  cp_wait_all();
  __syncthreads();
  // thread (i, jg): row 16 mi + i, key columns 4 jg .. 4 jg + 3
  const int i = threadIdx.x & 15, j0 = 4 * (threadIdx.x >> 4);
  if (j0 >= JW) return;
  float acc[4] = {};
  for (int n = 0; n < N; n += 4) {
    const float4 c = *reinterpret_cast<const float4*>(cr + i * NS + n);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float4 b =
          *reinterpret_cast<const float4*>(br + (j0 + u) * NS + n);
      acc[u] = fmaf(c.x, b.x, acc[u]);
      acc[u] = fmaf(c.y, b.y, acc[u]);
      acc[u] = fmaf(c.z, b.z, acc[u]);
      acc[u] = fmaf(c.w, b.w, acc[u]);
    }
  }
  float* g = G + (size_t)seq_chunk * Qp * Qp;
#pragma unroll
  for (int u = 0; u < 4; ++u)
    g[frag_index(16 * mi + i, j0 + u, KT)] = acc[u];
}

// ---- the chunk scan ---------------------------------------------------------

// Which of the NH warps of an hd tile finishes query tile mi: a snake over
// the tiles, so the causal work ((C B^T) o L) x, which grows with mi,
// spreads evenly.
template <int NH>
__device__ __forceinline__ int owner(int mi) {
  return ((mi / NH) & 1) ? NH - 1 - mi % NH : mi % NH;
}

template <int HD, int N>
__global__ void __launch_bounds__(Cfg<HD, N>::NW * 32, 2)
ssd_fwd_scan_kernel(const float* __restrict__ x, const float* __restrict__ dA,
                    const float* __restrict__ Bm, const float* __restrict__ Cm,
                    const float* __restrict__ G, float* __restrict__ y,
                    float* __restrict__ state, int S, int H, int Q, int Qp) {
  using K = Cfg<HD, N>;
  constexpr int NTHR = K::NW * 32, XS = K::XS, BS = K::BS;
  extern __shared__ float4 smem4[];
  float* xs0 = reinterpret_cast<float*>(smem4);  // [2][Qp][XS]  x
  float* bs = xs0 + 2 * Qp * XS;                 // [Qp][BS]  B
  float* cs = bs + Qp * BS;                      // [Qp][BS]  C, then G
  float* ex = cs + Qp * Qp;                      // ... and partial sums
  float* da0 = cs + K::region(Qp);               // [2][Qp]  dA
  float* cum = da0 + 2 * Qp;                     // [Qp]  cumsum(dA)
  float* ecs = cum + Qp;                         // [Qp]  exp(cum)
  float* wq = ecs + Qp;                          // [Qp]  exp(cum_Q - cum)

  const int bt = blockIdx.x / H, h = blockIdx.x - bt * H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int d0 = (warp % K::DT) * 16;   // this warp's 16 rows of hd
  const int grp = warp / K::DT;         // ... and its group of state cols
  const int nb = grp * K::NN;
  const int QT = Qp / 16, KT = Qp / 8, nc = S / Q;
  const size_t xrow = (size_t)H * HD;   // x / y stride between time steps

  auto load_x = [&](int ci) {           // x and dA into buffer ci & 1
    const size_t s0 = (size_t)bt * S + (size_t)ci * Q;
    float* da = da0 + (ci & 1) * Qp;
    load_rows(xs0 + (ci & 1) * Qp * XS, XS, x + (s0 * H + h) * HD, xrow, HD,
              Q, Qp, NTHR);
    for (int i = threadIdx.x; i < Qp; i += NTHR)
      cp4(da + i, i < Q ? dA + (s0 + i) * H + h : dA, i < Q);
  };
  auto load_bc = [&](float* dst, const float* src, int ci) {
    const size_t s0 = (size_t)bt * S + (size_t)ci * Q;
    load_rows(dst, BS, src + s0 * N, N, N, Q, Qp, NTHR);
  };

  // state S[d0 + g (+8)][nb + 8j + 2t (+1)] in accumulator layout
  float st[K::NT][4];
#pragma unroll
  for (int j = 0; j < K::NT; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) st[j][r] = 0.f;

  load_bc(bs, Bm, 0);
  load_bc(cs, Cm, 0);
  load_x(0);
  cp_commit();

  for (int ci = 0; ci < nc; ++ci) {
    const int c0 = ci * Q;
    const bool more = ci + 1 < nc;
    const float* xs = xs0 + (ci & 1) * Qp * XS;
    cp_wait_all();
    __syncthreads();  // chunk ci is in shared memory
    if (more) {       // the next x and dA land while this chunk computes
      load_x(ci + 1);
      cp_commit();
    }
    // ---- cumsum(dA), sequential as the plain version's: a scan tree
    // rounds its partial sums (|cs| up to ~50) another way, and exp(cs)
    // carries that into y, enough to move mamba2's 48-layer logits by
    // 1.5e-2 (sequential: 3e-3)
    if (warp == 0) {
      const float* da = da0 + (ci & 1) * Qp;
      if (lane == 0) {
        float run = 0.f;
        for (int i = 0; i < Qp; i += 4) {
          const float4 d4 = *reinterpret_cast<const float4*>(da + i);
          cum[i] = run += d4.x;
          cum[i + 1] = run += d4.y;
          cum[i + 2] = run += d4.z;
          cum[i + 3] = run += d4.w;
        }
      }
      __syncwarp();
      const float last = cum[Q - 1];
      for (int i = lane; i < Qp; i += 32) {
        ecs[i] = expf(cum[i]);
        wq[i] = expf(last - cum[i]);
      }
    }
    // ---- partial C S^T over this warp's state columns ----------------------
    float yac[kMaxQT][2][4];
#pragma unroll
    for (int mi = 0; mi < kMaxQT; ++mi)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int r = 0; r < 4; ++r) yac[mi][hf][r] = 0.f;
#pragma unroll
    for (int j = 0; j < K::NT; ++j) {
      if (ci == 0) break;  // the state starts at 0
      Split b0[2], b1[2];  // S^T as B: k = state col (permuted), n = hd row
      b0[0] = split(st[j][0]);
      b0[1] = split(st[j][1]);
      b1[0] = split(st[j][2]);
      b1[1] = split(st[j][3]);
      const int n = nb + 8 * j + 2 * t;
#pragma unroll
      for (int mi = 0; mi < kMaxQT; ++mi) {
        if (mi < QT) {
          const float2 lo = *reinterpret_cast<const float2*>(
              cs + (16 * mi + g) * BS + n);
          const float2 hi = *reinterpret_cast<const float2*>(
              cs + (16 * mi + 8 + g) * BS + n);
          const Split a[4] = {split(lo.x), split(hi.x), split(lo.y),
                              split(hi.y)};
          mma3x2(yac[mi][0], yac[mi][1], a, a, b0, b1);
        }
      }
    }
    __syncthreads();  // C is read; the cumsum is visible
    // G of this chunk into C's place, landing during the state update
    if (ci == 0)  // the C B^T kernel, launched before, has finished
      asm volatile("griddepcontrol.wait;\n" ::: "memory");
    {
      const float* gsrc = G + (size_t)(bt * nc + ci) * Qp * Qp;
      for (int e = threadIdx.x; e < Qp * Qp / 4; e += NTHR)
        cp16(cs + 4 * e, gsrc + 4 * e, true);
      cp_commit();
    }
    // partial sums of the tiles another warp finishes, beside G
#pragma unroll
    for (int mi = 0; mi < kMaxQT; ++mi) {
      const int o = owner<K::NH>(mi);
      if (mi < QT && o != grp) {
        float* e = ex + (grp < o ? grp : grp - 1) * Qp * XS;
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const int col = d0 + 8 * hf + 2 * t;
          *reinterpret_cast<float2*>(e + (16 * mi + g) * XS + col) =
              make_float2(yac[mi][hf][0], yac[mi][hf][1]);
          *reinterpret_cast<float2*>(e + (16 * mi + 8 + g) * XS + col) =
              make_float2(yac[mi][hf][2], yac[mi][hf][3]);
        }
      }
    }
    // ---- state: S <- S exp(cum_Q) + (x o w)^T B ---------------------------
    const float etot = expf(cum[Q - 1]);
#pragma unroll
    for (int j = 0; j < K::NT; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) st[j][r] *= etot;
    for (int q0 = 0; q0 < Qp; q0 += 8) {
      const float w0 = wq[q0 + t], w1 = wq[q0 + t + 4];
      const float* x0 = xs + (q0 + t) * XS + d0 + g;
      const float* x1 = xs + (q0 + t + 4) * XS + d0 + g;
      const Split a[4] = {split(x0[0] * w0), split(x0[8] * w0),
                          split(x1[0] * w1), split(x1[8] * w1)};
#pragma unroll
      for (int j = 0; j < K::NT; j += 2) {  // NT is 1 or even
        const float* b = bs + (q0 + t) * BS + nb + 8 * j + g;
        const Split b0[2] = {split(b[0]), split(b[4 * BS])};
        if (j + 1 < K::NT) {
          const Split b1[2] = {split(b[8]), split(b[4 * BS + 8])};
          mma3x2(st[j], st[j + 1], a, a, b0, b1);
        } else {
          mma3(st[j], a, b0);
        }
      }
    }
    cp_wait_all();
    __syncthreads();  // B is read; G and the partial sums are in place
    if (more) {
      load_bc(bs, Bm, ci + 1);
      cp_commit();
    }
    // M = G o L in place, once for the block's warps: entry r of lane l of
    // key step kk of query tile mi is (16 mi + l/4 + 8 (r & 1),
    // 8 kk + l%4 + 4 (r >> 1))
    for (int e = threadIdx.x; e < QT * KT * 32; e += NTHR) {
      const int tile = e >> 5, l = e & 31;
      const int mi = tile / KT, kk = tile - mi * KT;
      if (kk > 2 * mi + 1) continue;  // above the diagonal: never read
      const int ia = 16 * mi + (l >> 2), ja = 8 * kk + (l & 3);
      const int ib = ia + 8, jb = ja + 4;
      float4 v = reinterpret_cast<float4*>(cs)[e];
      const float ca = cum[ia], cb = cum[ib], cja = cum[ja], cjb = cum[jb];
      v.x = ja <= ia ? v.x * expf(ca - cja) : 0.f;
      v.y = ja <= ib ? v.y * expf(cb - cja) : 0.f;
      v.z = jb <= ia ? v.z * expf(ca - cjb) : 0.f;
      v.w = jb <= ib ? v.w * expf(cb - cjb) : 0.f;
      reinterpret_cast<float4*>(cs)[e] = v;
    }
    __syncthreads();  // M is in place
    // ---- finish this warp's query tiles: y = exp(cs) o (C S^T) + M x ------
#pragma unroll
    for (int mi = 0; mi < kMaxQT; ++mi) {
      if (mi >= QT || owner<K::NH>(mi) != grp) continue;
      const int ia = 16 * mi + g, ib = ia + 8;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = d0 + 8 * hf + 2 * t;
        float* acc = yac[mi][hf];
        for (int o = 0; o < K::NH - 1; ++o) {
          const float* e = ex + o * Qp * XS;
          const float2 u = *reinterpret_cast<const float2*>(e + ia * XS + col);
          const float2 v = *reinterpret_cast<const float2*>(e + ib * XS + col);
          acc[0] += u.x;
          acc[1] += u.y;
          acc[2] += v.x;
          acc[3] += v.y;
        }
        acc[0] *= ecs[ia];
        acc[1] *= ecs[ia];
        acc[2] *= ecs[ib];
        acc[3] *= ecs[ib];
      }
      // M x over the key steps that reach the diagonal
      const float4* mf =
          reinterpret_cast<const float4*>(cs) + mi * KT * 32 + lane;
      for (int kk = 0; kk < 2 * mi + 2; ++kk) {
        const float4 mv = mf[kk * 32];
        const Split a[4] = {split(mv.x), split(mv.y), split(mv.z),
                            split(mv.w)};
        const float* xb = xs + (8 * kk + t) * XS + d0 + g;
        const Split b0[2] = {split(xb[0]), split(xb[4 * XS])};
        const Split b1[2] = {split(xb[8]), split(xb[4 * XS + 8])};
        mma3x2(yac[mi][0], yac[mi][1], a, a, b0, b1);
      }
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int col = d0 + 8 * hf + 2 * t;
        float* yo = y + (((size_t)bt * S + c0) * H + h) * HD + col;
        if (ia < Q)
          *reinterpret_cast<float2*>(yo + ia * xrow) =
              make_float2(yac[mi][hf][0], yac[mi][hf][1]);
        if (ib < Q)
          *reinterpret_cast<float2*>(yo + ib * xrow) =
              make_float2(yac[mi][hf][2], yac[mi][hf][3]);
      }
    }
    __syncthreads();  // G, the partial sums and the cumsum are read
    if (more) {
      load_bc(cs, Cm, ci + 1);
      cp_commit();
    }
  }
  // final state [Bt, H, hd, N]
  float* so = state + ((size_t)bt * H + h) * HD * N;
#pragma unroll
  for (int j = 0; j < K::NT; ++j) {
    const int n = nb + 8 * j + 2 * t;
    *reinterpret_cast<float2*>(so + (d0 + g) * N + n) =
        make_float2(st[j][0], st[j][1]);
    *reinterpret_cast<float2*>(so + (d0 + 8 + g) * N + n) =
        make_float2(st[j][2], st[j][3]);
  }
}

template <int HD, int N>
int scan_smem_bytes(int Qp) {
  using K = Cfg<HD, N>;
  return (2 * Qp * K::XS + Qp * K::BS + K::region(Qp) + 5 * Qp) *
         (int)sizeof(float);
}

template <int HD, int N>
int launch_scan(const float* x, const float* dA, const float* Bm,
                const float* Cm, const float* G, float* y, float* state,
                int Bt, int S, int H, int Q, cudaStream_t st) {
  static int smem_set[kMaxDevices];
  const int Qp = pad16(Q), smem = scan_smem_bytes<HD, N>(Qp);
  cudaError_t err = allow_smem(ssd_fwd_scan_kernel<HD, N>, smem, smem_set);
  if (err != cudaSuccess) return (int)err;
  // launched dependent on the C B^T kernel: its blocks start while that
  // one runs (programmatic dependent launch) and wait before reading G
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(Bt * H);
  cfg.blockDim = dim3(Cfg<HD, N>::NW * 32);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, ssd_fwd_scan_kernel<HD, N>, x, dA, Bm,
                                 Cm, G, y, state, S, H, Q, Qp);
}

// f(Cfg<hd, N>{}) for the shapes the scan kernel is built for; -1 for
// another.
template <typename F>
int dispatch(int hd, int N, F f) {
#define SSD_CASE(H_, N_)                        \
  if (hd == H_ && N == N_) return f(Cfg<H_, N_>{});
  SSD_CASE(32, 16)
  SSD_CASE(32, 32)
  SSD_CASE(32, 64)
  SSD_CASE(32, 128)
  SSD_CASE(64, 16)
  SSD_CASE(64, 32)
  SSD_CASE(64, 64)
  SSD_CASE(64, 128)
#undef SSD_CASE
  return -1;
}

}  // namespace

extern "C" {

// Shared memory one scan block needs, in bytes (-1: shape not taken).
int ssd_fwd_smem_bytes(int hd, int N, int Q) {
  if (Q <= 0 || Q > kMaxQ) return -1;
  return dispatch(hd, N, [&](auto c) {
    using K = decltype(c);
    return scan_smem_bytes<K::kHD, K::kN>(pad16(Q));
  });
}

// Floats of the C B^T scratch: [Bt, S / Q, Qp, Qp], Qp = Q rounded up to 16.
long long ssd_fwd_gscratch(int Bt, int S, int Q) {
  const long long Qp = pad16(Q);
  return (long long)Bt * (S / Q) * Qp * Qp;
}

// x [Bt, S, H, hd], dA [Bt, S, H], B/C [Bt, S, N] (all f32, contiguous,
// 16-byte aligned) -> y [Bt, S, H, hd], state [Bt, H, hd, N]; G is
// ssd_fwd_gscratch floats.  hd in {32, 64}, N in {16, 32, 64, 128},
// 0 < Q <= 64 and S % Q == 0.  Returns the cudaError_t of the launches
// (0 = success).
int ssd_fwd_launch(const float* x, const float* dA, const float* Bm,
                   const float* Cm, float* y, float* state, float* G, int Bt,
                   int S, int H, int hd, int N, int Q, void* stream) {
  if (Bt <= 0 || S <= 0 || H <= 0 || Q <= 0 || Q > kMaxQ || S % Q ||
      ssd_fwd_smem_bytes(hd, N, Q) < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  static int cbt_smem_set[kMaxDevices];
  const int Qp = pad16(Q);
  const int cbt_smem = (16 + Qp) * (N + 4) * (int)sizeof(float);
  cudaError_t err = allow_smem(ssd_fwd_cbt_kernel, cbt_smem, cbt_smem_set);
  if (err != cudaSuccess) return (int)err;
  ssd_fwd_cbt_kernel<<<Bt * (S / Q) * (Qp / 16), kCbtThreads, cbt_smem,
                       st>>>(Bm, Cm, G, S, N, Q, Qp);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return dispatch(hd, N, [&](auto c) {
    using K = decltype(c);
    return launch_scan<K::kHD, K::kN>(x, dA, Bm, Cm, G, y, state, Bt, S, H,
                                       Q, st);
  });
}

const char* ssd_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
