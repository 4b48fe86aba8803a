// Zen commit kernels: the server-side push (aggregate + mask + compact +
// gather + bitmap) and the pull decode (bitmap -> compacted positions).
//
// Replace the Pallas megakernels repro/kernels/zen_commit.py ::
// zen_commit_push_fused and :: zen_commit_pull_fused (reached through
// repro/kernels/ops.py :: zen_commit_push_fused_op and
// :: zen_commit_pull_fused_op).  Plain versions: repro_torch/kernels/ref.py
// :: zen_commit_push_ref and :: zen_commit_pull_ref.
//
// PUSH.  lp int32 [C] server-local positions of the pushed rows (EMPTY,
// negative or >= cap_server dropped), vals [C, d] (f32 or bf16) -> lpos
// [cap_pull] the slots whose sum has a non-zero column, ascending,
// EMPTY-padded; out [cap_pull, d] their sums, zero rows after them; bm the
// LSB-first words of that mask over cap_server; ovf = max(nnz - cap_pull,
// 0).  Bit-exactness needs each slot's adds in stream order, in the values'
// dtype, from +0.0 (bf16: add in f32, round once per add, as the
// reference's scatter-add does), and -0.0 counting as zero: an occupied
// slot whose rows cancel is dropped.
//
// Design: one cooperative launch of the blocks that fit on the card at
// once, three phases around two grid-wide barriers, on the scatter-add's
// stream-order machinery (csrc/stream_order.cuh):
//   1. file_rows: rank and file every live row by slot, list the touched
//      slots; zero bm;
//   2. sum_targets: each touched slot's rows in stream order, from +0.0,
//      into the slot's staging row, its bit of bm set if the sum is
//      non-zero.  With the touched count T known, every thread of the grid
//      zeroes its share of out rows [T, cap_pull) (16-byte stores) and
//      fills lpos's EMPTY tail there, beside the few warps that sum;
//   3. each block scans the popcounts of bm's words into shared memory, so
//      a kept slot s at touched entry i has its position pos = the prefix
//      of its word + the popcount of the word's lower bits; for pos <
//      cap_pull its staging row goes to out[pos] and lpos[pos] = s.  Rows
//      [nnz, T) are zeroed and ovf written.
// No stage runs on one block.  The scratch (the zeroed words, left zero
// as stream_order.cuh says; the slot tables; the staging rows) is the
// wrapper's, kept across calls: no memset, no per-call buffer.
// Wide servers: where the prefix of the bitmap words does not fit in the
// 46 KB of shared memory (cap_server > 376,832: an EF-compressed bucket's
// element-sparse payload, up to 17M slots at qwen2-0.5b's lm_head/w), phase
// 3 scans grid-wide instead: each block scans its own range of words into
// a global prefix and files its total; after a third grid barrier every
// block scans the blocks' totals into shared memory, and a word's prefix
// is its block's base plus its entry.
// Bound on the H100: bytes.  It must read lp and the live rows of vals and
// write cap_pull (d + 1) values and the bitmap; at the qwen2-0.5b slice the
// [cap_pull, d] bf16 payload (18.7 MB) is nearly all of it, and the wire
// format makes the push write it whatever the stream holds.
//
// PULL.  words int32 [n, W] (uint32 bits) -> lpos int32 [n, cap_pull]: per
// row, the set-bit positions below cap_server, ascending, first cap_pull,
// EMPTY-padded.  n x P blocks, P chosen so the grid fills the SMs; each
// reads its row's W words (a few KB, four a thread) and scans their
// popcounts (warp shuffles, one barrier), which gives its own range of
// words their offsets and the row's total, writes its words' bits (one
// warp a word, one lane a bit) and its share of the EMPTY tail with
// 16-byte stores.  Bound: latency (the bitmaps are a few KB): a launch,
// one load of the words and two block barriers.
// Wide rows: where a row needs more blocks than the SMs give it (more than
// SMs / n x 1024 words: an EF-compressed bucket, W up to 532k words at
// lm_head/w), the pre-scan of the whole row by every block would read the
// row about W / 1024 times.  There one cooperative launch runs each
// (row, block) item twice around a grid barrier: first its words'
// popcount total, filed; then its offset, the sum of the earlier items'
// totals of its row, its words' bits and its share of the tail.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "block_scan.cuh"
#include "stream_order.cuh"

namespace {

using zen::kThreads;
using zen::kWarps;
using zen::Pack;

constexpr int kPullThreads = 256;
constexpr int kPullPer = 4;  // words a pull thread holds
constexpr int kPullSpan = kPullThreads * kPullPer;  // a block's most words
// dynamic shared memory the push may take: the 48 KB a launch gets by
// default less a margin for its static arrays (cap_server up to 376,832)
constexpr int kMaxSmem = 48 * 1024 - 2048;
constexpr int kMaxDevices = 64;
// blocks a wide push may launch: the block bases of its prefix sit in
// shared memory
constexpr int kWideGrid = 2048;

// A Pack read through L2: it was written by another block of this launch.
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_cg(const Pack<T, VEC>* p) {
  Pack<T, VEC> v;
  if constexpr (sizeof(v) == 16)
    *reinterpret_cast<int4*>(&v) = __ldcg(reinterpret_cast<const int4*>(p));
  else if constexpr (sizeof(v) == 4)
    *reinterpret_cast<int*>(&v) = __ldcg(reinterpret_cast<const int*>(p));
  else
    *reinterpret_cast<unsigned short*>(&v) =
        __ldcg(reinterpret_cast<const unsigned short*>(p));
  return v;
}

// Zeroes out rows [r0, r1) and sets lpos[r0, r1) to EMPTY, spread over the
// grid's threads.
template <typename T, int VEC>
__device__ __forceinline__ void clear_rows(T* out, int* lpos, int d, int r0,
                                           int r1) {
  if (r0 >= r1) return;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int nthreads = gridDim.x * kThreads;
  Pack<T, VEC> z;
#pragma unroll
  for (int k = 0; k < VEC; ++k) z.v[k] = zen::Acc<T>::store(0.0f);
  const long long nchunks = d / VEC;
  Pack<T, VEC>* p = reinterpret_cast<Pack<T, VEC>*>(out);
  for (long long c = r0 * nchunks + gtid; c < r1 * nchunks; c += nthreads)
    p[c] = z;
  for (int j = r0 + gtid; j < r1; j += nthreads) lpos[j] = ZEN_EMPTY;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
zen_push_kernel(const int* __restrict__ lp, const T* __restrict__ vals,
                int C, int d, int M, int L, int* __restrict__ lpos,
                T* __restrict__ out, unsigned* __restrict__ bm,
                int* __restrict__ ovf, T* stage, zen::Scratch s,
                int* __restrict__ gpre, int* __restrict__ btot) {
  // narrow: [Wb] popcounts of bm's earlier words; wide (gpre set): the
  // [gridDim.x] bases of the blocks' ranges of words
  extern __shared__ int wpre[];
  __shared__ int warp_sums[32];
  const int Wb = (M + 31) / 32;
  const int gtid = blockIdx.x * kThreads + threadIdx.x;
  const int tmax = C < M ? C : M;
  // 1. every live row filed by slot; the bitmap zeroed
  for (int w = gtid; w < Wb; w += gridDim.x * kThreads) bm[w] = 0u;
  zen::file_rows(lp, C, M, s);
  zen::grid_sync(s.zero);
  // 2. each touched slot's sum into its staging row and its bit; rows past
  // every touched slot are zero whatever the mask
  zen::sum_targets<T, VEC, true>(lp, C, tmax, vals, d, stage, s, bm);
  const int ntouched = __ldcg(reinterpret_cast<int*>(s.zero) + s.parity);
  const int tl = ntouched < L ? ntouched : L;
  clear_rows<T, VEC>(out, lpos, d, tl, L);
  zen::grid_sync(s.zero);
  // 3. the exclusive prefix of the bitmap words' popcounts: in this
  // block's shared memory (narrow), or grid-wide (wide)
  int nnz = 0;
  const int wpb = (Wb + gridDim.x - 1) / gridDim.x;  // wide: words a block
  if (gpre == nullptr) {
    // the words read in one pass, then each thread scans a run of them
#pragma unroll 4
    for (int w = threadIdx.x; w < Wb; w += kThreads)
      wpre[w] = __popc(__ldcg(bm + w));
    __syncthreads();
    const int per = (Wb + kThreads - 1) / kThreads;
    const int a = threadIdx.x * per, b = a + per < Wb ? a + per : Wb;
    int own = 0;
    for (int w = a; w < b; ++w) own += wpre[w];
    int off = zen::block_excl_scan(own, warp_sums, nnz);
    for (int w = a; w < b; ++w) {
      const int p = wpre[w];
      wpre[w] = off;
      off += p;
    }
    __syncthreads();
  } else {
    // this block's range of words, each thread a run: prefixes within the
    // block into gpre, the block's total into btot
    const int ba = min((int)blockIdx.x * wpb, Wb), bb = min(ba + wpb, Wb);
    const int per = (bb - ba + kThreads - 1) / kThreads;
    const int a = min(ba + (int)threadIdx.x * per, bb), b = min(a + per, bb);
    int own = 0;
    for (int w = a; w < b; ++w) own += __popc(__ldcg(bm + w));
    int btotal = 0;
    int off = zen::block_excl_scan(own, warp_sums, btotal);
    for (int w = a; w < b; ++w) {
      gpre[w] = off;
      off += __popc(__ldcg(bm + w));
    }
    if (threadIdx.x == 0) btot[blockIdx.x] = btotal;
    zen::grid_sync(s.zero);
    // every block: the exclusive prefix of the blocks' totals
    const int pb = (gridDim.x + kThreads - 1) / kThreads;
    const int c0 = min((int)threadIdx.x * pb, (int)gridDim.x);
    const int c1 = min(c0 + pb, (int)gridDim.x);
    int mine = 0;
    for (int c = c0; c < c1; ++c) mine += __ldcg(btot + c);
    int boff = zen::block_excl_scan(mine, warp_sums, nnz);
    for (int c = c0; c < c1; ++c) {
      const int t = __ldcg(btot + c);
      wpre[c] = boff;
      boff += t;
    }
    __syncthreads();
  }
  // the prefix of bitmap word w
  auto prefix = [&](int w) {
    return gpre == nullptr ? wpre[w] : wpre[w / wpb] + __ldcg(gpre + w);
  };
  // each kept slot's staging row to its position, a few warps a row
  const int lane = threadIdx.x & 31;
  const int nchunks = d / VEC;
  const int nwarps = gridDim.x * kWarps;
  const int pmax = zen::max_parts(nchunks);
  int parts = ntouched ? nwarps / ntouched : 1;
  parts = parts < 1 ? 1 : parts < pmax ? parts : pmax;
  for (int item = blockIdx.x * kWarps + (threadIdx.x >> 5);; item += nwarps) {
    const int i = item / parts, part = item - i * parts;
    if (i >= ntouched) break;
    const int t = __ldcg(s.touched + i);
    const unsigned word = __ldcg(bm + (t >> 5));
    if (!((word >> (t & 31)) & 1u)) continue;
    const int pos = prefix(t >> 5) + __popc(word & ((1u << (t & 31)) - 1u));
    if (pos >= L) continue;
    if (part == 0 && lane == 0) lpos[pos] = t;
    const Pack<T, VEC>* src =
        reinterpret_cast<const Pack<T, VEC>*>(stage + (size_t)i * d);
    Pack<T, VEC>* dst = reinterpret_cast<Pack<T, VEC>*>(out + (size_t)pos * d);
    for (int c = part * 32 + lane; c < nchunks; c += parts * 32)
      dst[c] = load_cg(src + c);
  }
  clear_rows<T, VEC>(out, lpos, d, nnz < L ? nnz : L, tl);
  if (gtid == 0) ovf[0] = nnz > L ? nnz - L : 0;
}

// Whether the push's prefix of the bitmap words leaves shared memory.
bool push_wide(int M) {
  return (long long)(M + 31) / 32 * (long long)sizeof(int) > kMaxSmem;
}

// Dynamic shared memory of the push: the prefix of each bitmap word, or
// (wide) the base of each block's range of words.
int push_smem(int M) {
  return push_wide(M) ? kWideGrid * (int)sizeof(int)
                      : (M + 31) / 32 * (int)sizeof(int);
}

// Blocks of zen_push_kernel<T, VEC> that fit on the device at once with
// smem bytes of dynamic shared memory, per device (queried again when
// smem changes).
template <typename T, int VEC>
int push_resident_blocks(int dev, int smem) {
  static int cache[kMaxDevices][2];  // {smem, blocks}
  if (dev < 0 || dev >= kMaxDevices || smem > kMaxSmem) return 0;
  if (cache[dev][1] == 0 || cache[dev][0] != smem) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, zen_push_kernel<T, VEC>, kThreads, smem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess)
      return 0;
    cache[dev][0] = smem;
    cache[dev][1] = per_sm * sms;
  }
  return cache[dev][1];
}

// The push's grid: the blocks that fit, no more than give each thread a
// row of the stream, each warp its part of a touched slot, or each thread
// eight 16-byte stores of the payload.  0 if the device cannot take it.
template <typename T, int VEC>
int push_grid(int C, int d, int M, int L) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  const long long fit = push_resident_blocks<T, VEC>(dev, push_smem(M));
  const long long tmax = C < M ? C : M;
  const long long by_rows = (C + kThreads - 1) / kThreads;
  const long long by_targets =
      (tmax * zen::max_parts(d / VEC) + kWarps - 1) / kWarps;
  const long long by_out =
      ((long long)L * (d / VEC) + 8 * kThreads - 1) / (8 * kThreads);
  long long want = by_rows > by_targets ? by_rows : by_targets;
  want = want > by_out ? want : by_out;
  want = want > 1 ? want : 1;
  if (push_wide(M) && want > kWideGrid) want = kWideGrid;
  return (int)(want < fit ? want : fit);
}

template <typename T, int VEC>
int push_launch(const int* lp, const T* vals, int C, int d, int M, int L,
                int* lpos, T* out, int* bm, int* ovf, unsigned* zero,
                int* iscratch, T* stage, int parity, cudaStream_t st) {
  const int grid = push_grid<T, VEC>(C, d, M, L);
  if (grid <= 0) return (int)cudaErrorInvalidConfiguration;
  zen::Scratch s;
  s.zero = zero;
  s.touched = iscratch;
  s.tab = iscratch + (C < M ? C : M);
  s.parity = parity & 1;
  // wide: the words' prefixes and the blocks' totals after the tables
  int* gpre = nullptr;
  int* btot = nullptr;
  if (push_wide(M)) {
    gpre = s.tab + (size_t)M * zen::kTab;
    btot = gpre + (M + 31) / 32;
  }
  unsigned* bmu = reinterpret_cast<unsigned*>(bm);
  void* args[] = {&lp, &vals, &C, &d, &M, &L, &lpos, &out, &bmu, &ovf,
                  &stage, &s, &gpre, &btot};
  return (int)cudaLaunchCooperativeKernel(
      (const void*)zen_push_kernel<T, VEC>, dim3(grid), dim3(kThreads), args,
      push_smem(M), st);
}

bool aligned16(const void* p) { return ((size_t)p & 15) == 0; }

// 16 bytes a lane where d and the rows' alignment allow it, else one
// element.
template <typename T>
bool vec16(int d, const void* vals, const void* out, const void* stage) {
  return d % (16 / sizeof(T)) == 0 && aligned16(vals) && aligned16(out) &&
         aligned16(stage);
}

template <typename T>
int push(const int* lp, const T* vals, int C, int d, int M, int L, int* lpos,
         T* out, int* bm, int* ovf, unsigned* zero, int* iscratch, T* stage,
         int parity, cudaStream_t st) {
  constexpr int kVec = 16 / sizeof(T);
  if (vec16<T>(d, vals, out, stage))
    return push_launch<T, kVec>(lp, vals, C, d, M, L, lpos, out, bm, ovf,
                                zero, iscratch, stage, parity, st);
  return push_launch<T, 1>(lp, vals, C, d, M, L, lpos, out, bm, ovf, zero,
                           iscratch, stage, parity, st);
}

// Bits of word w at or above cap_server cleared.
__device__ __forceinline__ unsigned trimmed(unsigned word, int w,
                                            int cap_server) {
  const int lo = w * 32;
  if (lo >= cap_server) return 0u;
  return cap_server - lo < 32 ? word & ((1u << (cap_server - lo)) - 1u)
                              : word;
}

// p[0, n) = EMPTY by the block, 16 bytes a store where aligned.
__device__ __forceinline__ void fill_empty(int* p, int n) {
  if (n <= 0) return;
  int head = (int)((16 - ((size_t)p & 15)) & 15) / 4;
  head = head < n ? head : n;
  if ((int)threadIdx.x < head) p[threadIdx.x] = ZEN_EMPTY;
  int4* q = reinterpret_cast<int4*>(p + head);
  const int nq = (n - head) / 4;
  const int4 e = make_int4(ZEN_EMPTY, ZEN_EMPTY, ZEN_EMPTY, ZEN_EMPTY);
  for (int k = threadIdx.x; k < nq; k += blockDim.x) q[k] = e;
  const int done = head + 4 * nq;
  if ((int)threadIdx.x < n - done) p[done + threadIdx.x] = ZEN_EMPTY;
}

// Block (part, row): words [part * span, (part + 1) * span) of the row and
// its share of the row's EMPTY tail; gridDim.x is the row's P blocks.
// Thread t holds words t * kPullPer + [0, kPullPer) of each pass over the
// row, so warp scans and one barrier give every word its offset.
__global__ void __launch_bounds__(kPullThreads)
zen_pull_kernel(const int* __restrict__ words, int W, int cap_server,
                int cap_pull, int span, int* __restrict__ lpos) {
  __shared__ int wsum[kPullThreads / 32];
  __shared__ unsigned s_word[kPullSpan];  // this block's words
  __shared__ int s_off[kPullSpan];        // and their offsets in the row
  const int* wr = words + (size_t)blockIdx.y * W;
  int* out = lpos + (size_t)blockIdx.y * cap_pull;
  const int a = blockIdx.x * span, b = a + span < W ? a + span : W;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int total = 0;
  for (int w0 = 0; w0 < W; w0 += kPullSpan) {
    unsigned wd[kPullPer];
    int c = 0;
#pragma unroll
    for (int u = 0; u < kPullPer; ++u) {
      const int w = w0 + threadIdx.x * kPullPer + u;
      wd[u] = w < W ? trimmed((unsigned)__ldg(wr + w), w, cap_server) : 0u;
      c += __popc(wd[u]);
    }
    int x = c;  // inclusive scan of the popcounts over the warp
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(zen::kFull, x, o);
      if (lane >= o) x += t;
    }
    if (lane == 31) wsum[warp] = x;
    __syncthreads();
    int before = 0, tile = 0;
#pragma unroll
    for (int k = 0; k < kPullThreads / 32; ++k) {
      const int v = wsum[k];
      tile += v;
      before += k < warp ? v : 0;
    }
    int off = total + before + x - c;
#pragma unroll
    for (int u = 0; u < kPullPer; ++u) {
      const int w = w0 + threadIdx.x * kPullPer + u;
      if (w >= a && w < b) {
        s_word[w - a] = wd[u];
        s_off[w - a] = off;
      }
      off += __popc(wd[u]);
    }
    total += tile;
    __syncthreads();  // wsum is rewritten by the next pass
  }
  for (int j = warp; j < b - a; j += kPullThreads / 32) {
    const unsigned word = s_word[j];
    if ((word >> lane) & 1u) {
      const int pos = s_off[j] + __popc(word & ((1u << lane) - 1u));
      if (pos < cap_pull) out[pos] = (a + j) * 32 + lane;
    }
  }
  const int kept = total < cap_pull ? total : cap_pull;
  const int share = (cap_pull - kept + gridDim.x - 1) / gridDim.x;
  const int t0 = kept + blockIdx.x * share;
  const int t1 = t0 + share < cap_pull ? t0 + share : cap_pull;
  fill_empty(out + t0, t1 - t0);
}

// The popcount total of words [a, b) of a row, over the block.
__device__ __forceinline__ int span_total(const int* __restrict__ wr, int a,
                                          int b, int cap_server, int* ws) {
  int c = 0;
  for (int w = a + threadIdx.x; w < b; w += blockDim.x)
    c += __popc(trimmed((unsigned)__ldg(wr + w), w, cap_server));
  int total = 0;
  zen::block_excl_scan(c, ws, total);
  return total;
}

// Wide rows: item it = (row, part) of n x parts, each block taking items
// gridDim.x apart.  Pass 1 files each item's popcount total in tot; after
// the grid barrier, pass 2 gives each item its offset (the row's earlier
// totals), writes its words' bits and fills its share of the EMPTY tail.
__global__ void __launch_bounds__(kPullThreads)
zen_pull_wide_kernel(const int* __restrict__ words, int n, int W,
                     int cap_server, int cap_pull, int parts, int span,
                     int* __restrict__ lpos, int* __restrict__ tot,
                     unsigned* bar) {
  __shared__ int ws[32];
  __shared__ unsigned s_word[kPullSpan];  // this item's words
  __shared__ int s_off[kPullSpan];        // and their offsets in the row
  const int items = n * parts;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int row = it / parts, part = it - row * parts;
    const int a = part * span, b = a + span < W ? a + span : W;
    const int t = span_total(words + (size_t)row * W, a, b, cap_server, ws);
    if (threadIdx.x == 0) tot[it] = t;
  }
  zen::grid_sync(bar);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int it = blockIdx.x; it < items; it += gridDim.x) {
    const int row = it / parts, part = it - row * parts;
    const int* wr = words + (size_t)row * W;
    int* out = lpos + (size_t)row * cap_pull;
    const int a = part * span, b = a + span < W ? a + span : W;
    // the row's total and this item's base, from the filed totals
    int before = 0, all = 0;
    for (int k = threadIdx.x; k < parts; k += blockDim.x) {
      const int v = __ldcg(tot + (size_t)row * parts + k);
      all += v;
      before += k < part ? v : 0;
    }
    int total = 0, base = 0;
    zen::block_excl_scan(all, ws, total);
    zen::block_excl_scan(before, ws, base);
    // this item's words, kPullPer a thread: warp scans and one barrier
    unsigned wd[kPullPer];
    int c = 0;
#pragma unroll
    for (int u = 0; u < kPullPer; ++u) {
      const int w = a + threadIdx.x * kPullPer + u;
      wd[u] = w < b ? trimmed((unsigned)__ldg(wr + w), w, cap_server) : 0u;
      c += __popc(wd[u]);
    }
    int x = c;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(zen::kFull, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) ws[warp] = x;
    __syncthreads();
    int off = base + x - c;
    for (int k = 0; k < warp; ++k) off += ws[k];
#pragma unroll
    for (int u = 0; u < kPullPer; ++u) {
      const int j = threadIdx.x * kPullPer + u;
      if (a + j < b) {
        s_word[j] = wd[u];
        s_off[j] = off;
      }
      off += __popc(wd[u]);
    }
    __syncthreads();
    for (int j = warp; j < b - a; j += kPullThreads / 32) {
      const unsigned word = s_word[j];
      if ((word >> lane) & 1u) {
        const int pos = s_off[j] + __popc(word & ((1u << lane) - 1u));
        if (pos < cap_pull) out[pos] = (a + j) * 32 + lane;
      }
    }
    const int kept = total < cap_pull ? total : cap_pull;
    const int share = (cap_pull - kept + parts - 1) / parts;
    const int t0 = kept + part * share;
    const int t1 = t0 + share < cap_pull ? t0 + share : cap_pull;
    fill_empty(out + t0, t1 - t0);
    __syncthreads();  // ws, s_word and s_off are rewritten by the next item
  }
}

int sm_count(int dev) {
  static int cache[kMaxDevices];
  if (dev < 0 || dev >= kMaxDevices) return 0;
  if (cache[dev] == 0 &&
      cudaDeviceGetAttribute(&cache[dev], cudaDevAttrMultiProcessorCount,
                             dev) != cudaSuccess)
    return 0;
  return cache[dev];
}

// Blocks of the pull a row takes: enough that each block's words fit its
// shared arrays, and at least SMs / n; wide when that is more than SMs / n.
int pull_parts(int dev, int n, int W, bool* wide) {
  const int per_row = sm_count(dev) / n;
  const int least = (W + kPullSpan - 1) / kPullSpan;
  *wide = least > per_row;
  int parts = per_row > least ? per_row : least;
  parts = parts < W ? parts : W;
  return parts > 1 ? parts : 1;
}

}  // namespace

extern "C" {

// The zeroed scratch the push needs, in 32-bit words: it must be zero
// before the first call and the kernel leaves it zero.
long long zen_commit_push_zscratch(int cap_server) {
  return (long long)zen::kCtr + cap_server;
}

// The other int32 scratch it needs (no initial value), in elements: the
// touched list and the slot tables, and for a wide server the words'
// prefixes and the blocks' totals.  The staging rows are min(C,
// cap_server) x d more, of the values' dtype.
long long zen_commit_push_iscratch(int C, int cap_server) {
  const long long tmax = C < cap_server ? C : cap_server;
  const long long wide =
      push_wide(cap_server) ? (cap_server + 31LL) / 32 + kWideGrid : 0LL;
  return tmax + (long long)cap_server * zen::kTab + wide;
}

// Whether a push of cap_server slots scans its bitmap's prefix grid-wide.
int zen_commit_push_wide(int cap_server) { return push_wide(cap_server); }

// dtype: 0 = float32, 1 = bfloat16.  zscratch: zen_commit_push_zscratch
// words, zero; iscratch: zen_commit_push_iscratch ints; stage: min(C,
// cap_server) x d values.  Calls that share a zscratch must run in stream
// order, with parity 0, 1, 0, 1, ...  Returns the cudaError_t of the
// launch (0 = success).
int zen_commit_push_launch(const int* lp, const void* vals, int C, int d,
                           int dtype, int cap_server, int cap_pull, int* lpos,
                           void* out, int* bm, int* ovf, void* zscratch,
                           int* iscratch, void* stage, int parity,
                           void* stream) {
  if (C < 0 || cap_server <= 0 || cap_pull <= 0 || d <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  unsigned* zero = (unsigned*)zscratch;
  if (dtype == 0)
    return push<float>(lp, (const float*)vals, C, d, cap_server, cap_pull,
                       lpos, (float*)out, bm, ovf, zero, iscratch,
                       (float*)stage, parity, st);
  if (dtype == 1)
    return push<__nv_bfloat16>(
        lp, (const __nv_bfloat16*)vals, C, d, cap_server, cap_pull, lpos,
        (__nv_bfloat16*)out, bm, ovf, zero, iscratch, (__nv_bfloat16*)stage,
        parity, st);
  return (int)cudaErrorInvalidValue;
}

// The grid the push would launch for these arguments (blocks of 256
// threads), or -1.
int zen_commit_push_grid(int dtype, int C, int d, int cap_server,
                         int cap_pull, void* vals, void* out, void* stage) {
  if (dtype == 0)
    return vec16<float>(d, vals, out, stage)
               ? push_grid<float, 4>(C, d, cap_server, cap_pull)
               : push_grid<float, 1>(C, d, cap_server, cap_pull);
  if (dtype == 1)
    return vec16<__nv_bfloat16>(d, vals, out, stage)
               ? push_grid<__nv_bfloat16, 8>(C, d, cap_server, cap_pull)
               : push_grid<__nv_bfloat16, 1>(C, d, cap_server, cap_pull);
  return -1;
}

// The zeroed scratch the pull needs, in 32-bit words (its grid barrier's,
// left zero), and its other int32 scratch (the items' totals; 0 unless
// the rows are wide).
long long zen_commit_pull_zscratch() { return zen::kCtr; }

long long zen_commit_pull_iscratch(int n, int W) {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  bool wide = false;
  const int parts = pull_parts(dev, n, W, &wide);
  return wide ? (long long)n * parts : 0LL;
}

// words int32 [n, W] -> lpos int32 [n, cap_pull].  zscratch:
// zen_commit_pull_zscratch words, zero, left zero; iscratch:
// zen_commit_pull_iscratch ints.  Calls that share the scratch must run in
// stream order.
int zen_commit_pull_launch(const int* words, int n, int W, int cap_server,
                           int cap_pull, int* lpos, void* zscratch,
                           int* iscratch, void* stream) {
  if (n <= 0 || n > 65535 || W < 0 || cap_pull <= 0)
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  bool wide = false;
  const int parts = pull_parts(dev, n, W, &wide);
  const int span = (W + parts - 1) / parts;
  if (!wide) {
    // n x P blocks fill the SMs; each block's range fits its shared arrays
    zen_pull_kernel<<<dim3(parts, n), kPullThreads, 0,
                      (cudaStream_t)stream>>>(words, W, cap_server, cap_pull,
                                              span, lpos);
    return (int)cudaGetLastError();
  }
  static int resident[kMaxDevices];
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, zen_pull_wide_kernel, kPullThreads, 0);
    if (err != cudaSuccess) return (int)err;
    resident[dev] = per_sm * sm_count(dev);
  }
  const long long items = (long long)n * parts;
  int grid = (int)(items < resident[dev] ? items : resident[dev]);
  unsigned* bar = (unsigned*)zscratch;
  void* args[] = {&words, &n, &W, &cap_server, &cap_pull, (void*)&parts,
                  (void*)&span, &lpos, &iscratch, &bar};
  return (int)cudaLaunchCooperativeKernel((const void*)zen_pull_wide_kernel,
                                          dim3(grid), dim3(kPullThreads),
                                          args, 0, (cudaStream_t)stream);
}

const char* zen_commit_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
