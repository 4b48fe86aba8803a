// Stream-order aggregation by target for the commit push
// (csrc/zen_commit.cu); the COO scatter-add (csrc/scatter_add.cu) shares
// live_target and Acc.
//
// Both add rows vals[r] into out[idx[r]] and must be bit-exact against a
// sequential scatter-add: each target's rows are summed in stream order,
// in the values' dtype (bf16: add in f32, round once per add).  Float
// atomics cannot keep an order, so the push groups the rows by target
// into a CSR list with integer atomics (whose order does not matter):
//   1. count the live rows of each target (csr_count_kernel);
//   2. an exclusive scan of the counts gives each target's segment;
//   3. scatter row ids into their segment (csr_fill_kernel);
//   4. per target: sort the segment's row ids ascending, which is stream
//      order (sort_segment), and sum the rows in that order
//      (ordered_row_sum).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace zen {

// Live target: in [0, rows).  EMPTY (int32 max) and negatives drop.
__device__ __forceinline__ bool live_target(int v, int rows) {
  return (unsigned)v < (unsigned)rows;
}

// cnt[t] += 1 for every live idx[r].
__global__ void csr_count_kernel(const int* __restrict__ idx, int C, int rows,
                                 int* __restrict__ cnt) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < C && live_target(idx[r], rows)) atomicAdd(&cnt[idx[r]], 1);
}

// list[cursor[t]++] = r for every live row r of target t; cursor[t] starts
// at the target's segment start.
__global__ void csr_fill_kernel(const int* __restrict__ idx, int C, int rows,
                                int* __restrict__ cursor,
                                int* __restrict__ list) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r < C && live_target(idx[r], rows)) list[atomicAdd(&cursor[idx[r]], 1)] = r;
}

template <typename T>
struct Acc;

template <>
struct Acc<float> {
  static __device__ __forceinline__ float load(const float* p) { return *p; }
  static __device__ __forceinline__ float add(float a, float v) {
    return __fadd_rn(a, v);
  }
  static __device__ __forceinline__ float store(float a) { return a; }
};

template <>
struct Acc<__nv_bfloat16> {
  static __device__ __forceinline__ float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  // one rounding to bf16 per add, exactly as a bf16 scatter-add
  static __device__ __forceinline__ float add(float a, float v) {
    return __bfloat162float(__float2bfloat16_rn(__fadd_rn(a, v)));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float a) {
    return __float2bfloat16_rn(a);
  }
};

constexpr int kInsertionMax = 16;

// Sorts the distinct row ids seg[0, m) ascending, in place.  Every thread
// of the block must call it; it synchronises the block.  Short segments
// (the push's at most n rows) take one thread's insertion sort.  Longer
// ones take a block-wide bitonic network in the form whose comparators all
// put the minimum first (the first stage of each merge compares mirrored
// positions), so positions past m act as +inf and are never touched: no
// padding, O(m log^2 m) work, log2(m) (log2(m) + 1) / 2 barriers.
__device__ __forceinline__ void sort_segment(int* seg, int m) {
  if (m <= kInsertionMax) {
    if (threadIdx.x == 0) {
      for (int a = 1; a < m; ++a) {
        const int key = seg[a];
        int b = a - 1;
        while (b >= 0 && seg[b] > key) {
          seg[b + 1] = seg[b];
          --b;
        }
        seg[b + 1] = key;
      }
    }
    __syncthreads();
    return;
  }
  for (int k = 2; k < 2 * m; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < m; i += blockDim.x) {
        const int l = j == (k >> 1) ? (i ^ (k - 1)) : (i ^ j);
        if (l > i && l < m) {
          const int a = seg[i], b = seg[l];
          if (a > b) {
            seg[i] = b;
            seg[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

// dst[c] = vals[seg[0]][c] + ... + vals[seg[m-1]][c], added left to right
// in the values' dtype, for the columns c this thread owns.  Returns
// whether any of them is non-zero (-0.0 counts as zero).
template <typename T>
__device__ __forceinline__ int ordered_row_sum(const T* __restrict__ vals,
                                               int d, const int* seg, int m,
                                               T* dst) {
  int nz = 0;
  for (int c = threadIdx.x; c < d; c += blockDim.x) {
    float acc = 0.0f;
    for (int e = 0; e < m; ++e)
      acc = Acc<T>::add(acc, Acc<T>::load(vals + (size_t)seg[e] * d + c));
    dst[c] = Acc<T>::store(acc);
    nz |= acc != 0.0f;
  }
  return nz;
}

}  // namespace zen
