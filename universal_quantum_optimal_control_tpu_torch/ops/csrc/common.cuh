// What the sources share: the error-string export, the deterministic
// per-target mean over Monte-Carlo samples of the fidelity kernels B1
// (propagate_su2.cu), B6 and B4 (propagate_su4.cu), and the deterministic
// per-target sum of the reverse sweeps' pulse cotangents, B2
// (propagate_su2.cu) and B5 (propagate_su4_bwd.cu).
//
// Mean, pass 1 (inside the fidelity kernel): block_sum adds each block's
// samples in a fixed order (warp shuffles, then the warps' sums), and thread
// 0 writes one partial per block.  Pass 2: reduce_partials_kernel sums a
// target's partials in double, in a fixed order, and divides by M.
//
// Pulse cotangents, pass 1 (inside the sweep): warp_sum per segment and
// channel into the warp's slot of a shared [warps][L * P] buffer, then a
// fixed-order sum over the warps into one partial per block.  Pass 2:
// reduce_columns_kernel sums a target's block partials in double, in block
// order.  No atomics anywhere, so every result is the same from run to run.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Each source is its own library, loaded with RTLD_LOCAL, so each exports
// its own copy.
extern "C" const char* uqoc_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

namespace uqoc {

// The streaming multiprocessors of the current device, 0 where it cannot be
// read; read once per device (it does not change), since every launch asks.
inline int sm_count() {
  static int known[64] = {};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) {
    cudaGetLastError();  // clear it, so no later launch reports it
    return 0;
  }
  if (dev >= 0 && dev < 64 && known[dev] > 0) return known[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  if (dev >= 0 && dev < 64) known[dev] = n;
  return n;
}

// The SU(4) kernels B4, B6, B5 and B8 run one thread per sample where a
// launch of `blocks` blocks of 4 warps gives the card's warp schedulers (4
// an SM) at least 1.5 warps each on average, and a lane group per sample
// where it would give fewer (su4.cuh).  One thread's sample is a serial
// chain that one warp per scheduler cannot keep busy; a lane group runs it
// on G lanes at a cost of ~20 % more instructions.  On an H100 (132 SMs,
// 700 W) B5 on one thread per sample took 0.99 ms at 1.2 warps a scheduler
// (5 x 4096 samples) and 0.96 ms at 1.9 (32 x 1024); on lane groups 0.72 and
// 1.11 ms (PERF.md).
inline bool lane_groups_pay(int64_t blocks) {
  return 2 * blocks < 3 * static_cast<int64_t>(sm_count());
}

// Sum of f over the block; the result is valid in thread 0.
template <int kThreads>
__device__ __forceinline__ float block_sum(float f) {
  static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps");
  __shared__ float warp_sums[kThreads / 32];
  for (int off = 16; off > 0; off >>= 1)
    f += __shfl_down_sync(0xffffffffu, f, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = f;
  __syncthreads();
  if (threadIdx.x < 32) {
    f = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      f += __shfl_down_sync(0xffffffffu, f, off);
  }
  return f;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Pass 2 of the mean: grid (B); out[b] = sum of partials[b, :n] / M, summed
// in double.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
reduce_partials_kernel(const float* __restrict__ partials, int n,
                       float* __restrict__ out, int64_t M) {
  __shared__ double sums[kThreads];
  const int b = blockIdx.x;
  double s = 0.0;
  for (int j = threadIdx.x; j < n; j += kThreads)
    s += partials[static_cast<int64_t>(b) * n + j];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) sums[threadIdx.x] += sums[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[b] = static_cast<float>(sums[0] / M);
}

// Pass 2 of the pulse cotangents: grid (ceil(lp / kThreads), B);
// out[b, j] = the sum of partials[b, :, j] over the nblocks blocks, in
// double, in block order.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
reduce_columns_kernel(const float* __restrict__ partials, int nblocks, int lp,
                      float* __restrict__ out) {
  const int b = blockIdx.y;
  const int j = blockIdx.x * kThreads + threadIdx.x;
  if (j >= lp) return;
  const float* src = partials + static_cast<int64_t>(b) * nblocks * lp + j;
  double s = 0.0;
  for (int x = 0; x < nblocks; ++x) s += src[static_cast<int64_t>(x) * lp];
  out[static_cast<int64_t>(b) * lp + j] = static_cast<float>(s);
}

}  // namespace uqoc
