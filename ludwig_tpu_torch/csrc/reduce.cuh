// Deterministic reductions shared by the kernels that return sums.
//
// A block sum is a warp-shuffle tree followed by a fixed-order sum of the
// warps' results; a sum over per-block partials walks them in one fixed
// order.  No float atomics: the same inputs give the same bits on every
// run, and every block of a grid that reduces the same partials gets the
// same value (the SOR kernel's stop decision relies on that).
#pragma once

#include <cuda_runtime.h>

constexpr int kReduceThreads = 256;

// Sum of v over a block of nw whole warps, in every thread.  sh holds
// nw + 1 values.
template <typename T>
__device__ __forceinline__ T block_sum_warps(T v, T* sh, int nw) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // sh may still be read from the previous call
  if (lane == 0) sh[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    T s = sh[0];
    for (int w = 1; w < nw; ++w) s += sh[w];
    sh[nw] = s;
  }
  __syncthreads();
  return sh[nw];
}

// Sum of v over the block (blockDim.x == NT), in every thread.  sh holds
// NT / 32 + 1 values.
template <typename T, int NT = kReduceThreads>
__device__ __forceinline__ T block_sum_all(T v, T* sh) {
  return block_sum_warps(v, sh, NT / 32);
}

// Sum of part[0..n) in a fixed order, in every thread of the block
// (blockDim.x == NT).
template <typename T, int NT = kReduceThreads>
__device__ __forceinline__ T sum_partials(const T* part, int n, T* sh) {
  T v = T(0);
  for (int i = threadIdx.x; i < n; i += NT) v += part[i];
  return block_sum_all<T, NT>(v, sh);
}

// out[c] = scale * sum_b part[c * n + b] for c < ncomp: one block of
// kReduceThreads threads.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
reduce_partials_kernel(const T* __restrict__ part, int n, int ncomp,
                       T scale, T* __restrict__ out) {
  __shared__ T sh[kReduceThreads / 32 + 1];
  for (int c = 0; c < ncomp; ++c) {
    const T s = sum_partials(part + static_cast<long long>(c) * n, n, sh);
    if (threadIdx.x == 0) out[c] = scale * s;
  }
}
