// SU(4) Monte-Carlo propagation kernels for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   B7  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py:_prop_kernel
//       -> propagate_su4_kernel: per-sample product U_L ... U_1 as (re, im),
//          each (B, M, 4, 4).
//   B6  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py:_fid_kernel
//       -> mean_fid_su4_kernel<P, false> + reduce_partials_kernel: per-target
//          mean entanglement fidelity F = (|Tr(U^H T)|^2 + 4) / 20, (B,).
//   B4  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py:_fid_prod_kernel
//       -> mean_fid_su4_kernel<P, true> + reduce_partials_kernel: B6 that also
//          writes each sample's product, the residual of the reverse sweep B5
//          (propagate_su4_bwd.cu), as (B, 32, M): 16 re, then 16 im, the
//          sample index fastest, so that the threads of a warp write 32
//          neighbouring floats per entry.
//
// The per-sample math (su4.cuh): compose() runs the L segments, each the
// sparse A = -i H tau / 2^s, the order-8 Paterson-Stockmeyer T8(A) and s
// squarings, then W <- exp(A) W, with exp(A) carried as exp(A) - I so that
// f32 keeps its small part's precision (see t8m1).
//
// What bounds them on an H100: arithmetic.  Each (target b, sample m) is an
// independent chain of L dependent segments of 3661 flops at s = 4 (see
// compose(): A's zeros and the (anti-)Hermitian powers A^2, A^3, A^4 are
// taken as such; the s squarings, A^4 Q and the W update are dense complex
// 4x4 products, 448-544 flops each); a sample reads 12 bytes (d1, d2, eps) and
// writes 128 bytes (B7, B4) or nothing but a block partial (B6).  That is
// thousands of flops per byte, far right of the ridge point, so the f32
// CUDA-core rate (67 TFLOP/s) is the bound, not the 3.35 TB/s of HBM.
//
// What the design does about it:
//   * one thread per sample; the running product W and the segment's series
//     live in registers for the whole L loop, nothing per segment touches
//     device memory;
//   * the per-segment scalars depend on the target and the segment only, not
//     on the sample: each block stages them once into shared memory (the
//     envelopes' cos and sin with the accurate sincosf, max(Omega, 0) and
//     tau / 2^s: 6 floats per segment), so no sample evaluates a
//     transcendental; the per-sample energies and (1 + eps)/2 are hoisted out
//     of the L loop;
//   * register pressure (the trap of one sample per thread): A, A^2, A^3
//     and A^4 are held as upper triangles (16 floats each; A's 8 scalars),
//     so besides W the widest point is P, Q and A^4 (80 floats);
//   * no TPU padding: M need not be a multiple of anything, threads past M
//     are masked by a bounds check.
//
// Reduction (B6, B4): common.cuh's deterministic two passes.  No atomics.
//
// Interface: extern "C" launchers returning cudaError_t (the launch status
// from cudaGetLastError), loaded with ctypes.  The caller owns every buffer
// and passes PyTorch's current stream; nothing here allocates or syncs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "common.cuh"
#include "su4.cuh"

namespace {

using su4::Mat;

constexpr int kThreads = 128;
constexpr int kRowFloats = 6;  // e1r, e1i, e2r, e2i, max(Omega, 0), tau / 2^s

// B7: grid (ceil(M / kThreads), B); out_re and out_im are (B, M, 16).
template <int P>
__global__ void __launch_bounds__(kThreads)
propagate_su4_kernel(const float* __restrict__ pulses,
                     const float* __restrict__ d1,
                     const float* __restrict__ d2,
                     const float* __restrict__ eps, float* __restrict__ out_re,
                     float* __restrict__ out_im, int L, int64_t M, float xtalk,
                     float coupling, int scaling, float tau_scale) {
  extern __shared__ float row[];
  const int b = blockIdx.y;
  su4::stage_row<P>(pulses, b, L, xtalk, tau_scale, row);
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  const Mat W = su4::compose(row, L, d1[i], d2[i], eps[i], coupling, scaling);
  float4* re = reinterpret_cast<float4*>(out_re) + 4 * i;
  float4* im = reinterpret_cast<float4*>(out_im) + 4 * i;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    re[r] = make_float4(W.re[4 * r], W.re[4 * r + 1], W.re[4 * r + 2], W.re[4 * r + 3]);
    im[r] = make_float4(W.im[4 * r], W.im[4 * r + 1], W.im[4 * r + 2], W.im[4 * r + 3]);
  }
}

// B6 (kProduct false) and B4 (kProduct true), pass 1: grid
// (ceil(M / kThreads), B); partials is (B, gridDim.x), each entry the sum of
// F over one block's samples; B4 also writes prod (B, 32, M).  F per
// sample: Tr(U^H T) in 64 FMAs, then (|Tr|^2 + 4) / 20: 134 flops.
template <int P, bool kProduct>
__global__ void __launch_bounds__(kThreads)
mean_fid_su4_kernel(const float* __restrict__ pulses,
                    const float* __restrict__ t_re,
                    const float* __restrict__ t_im,
                    const float* __restrict__ d1, const float* __restrict__ d2,
                    const float* __restrict__ eps,
                    float* __restrict__ partials, float* __restrict__ prod,
                    int L, int64_t M, float xtalk, float coupling, int scaling,
                    float tau_scale) {
  extern __shared__ float row[];
  __shared__ float target[32];
  const int b = blockIdx.y;
  su4::stage_row<P>(pulses, b, L, xtalk, tau_scale, row);
  if (threadIdx.x < 16) {
    target[threadIdx.x] = t_re[16 * b + threadIdx.x];
    target[16 + threadIdx.x] = t_im[16 * b + threadIdx.x];
  }
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float f = 0.0f;
  if (m < M) {
    const int64_t i = static_cast<int64_t>(b) * M + m;
    const Mat W = su4::compose(row, L, d1[i], d2[i], eps[i], coupling, scaling);
    if (kProduct) {
      float* out = prod + static_cast<int64_t>(b) * 32 * M + m;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        out[e * M] = W.re[e];
        out[(16 + e) * M] = W.im[e];
      }
    }
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float tr = target[e], ti = target[16 + e];
      re = fmaf(W.re[e], tr, re);
      re = fmaf(W.im[e], ti, re);
      im = fmaf(W.re[e], ti, im);
      im = fmaf(-W.im[e], tr, im);
    }
    f = (fmaf(re, re, im * im) + 4.0f) / 20.0f;
  }
  f = uqoc::block_sum<kThreads>(f);
  if (threadIdx.x == 0)
    partials[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] = f;
}

inline unsigned int num_blocks(int64_t M) {
  return static_cast<unsigned int>((M + kThreads - 1) / kThreads);
}

inline size_t row_bytes(int L) { return sizeof(float) * kRowFloats * L; }

// B6 (prod null) or B4: both passes.
template <bool kProduct>
cudaError_t launch_mean_fidelity(const float* pulses, const float* t_re,
                                 const float* t_im, const float* d1,
                                 const float* d2, const float* eps,
                                 float* partials, float* out, float* prod, int B,
                                 int L, int P, int64_t M, float xtalk,
                                 float coupling, int scaling, cudaStream_t s) {
  const dim3 grid(num_blocks(M), B);
  const size_t smem = row_bytes(L);
  const float tau_scale = std::ldexp(1.0f, -scaling);
  switch (P) {
    case 2:
      mean_fid_su4_kernel<2, kProduct><<<grid, kThreads, smem, s>>>(
          pulses, t_re, t_im, d1, d2, eps, partials, prod, L, M, xtalk, coupling,
          scaling, tau_scale);
      break;
    case 3:
      mean_fid_su4_kernel<3, kProduct><<<grid, kThreads, smem, s>>>(
          pulses, t_re, t_im, d1, d2, eps, partials, prod, L, M, xtalk, coupling,
          scaling, tau_scale);
      break;
    case 4:
      mean_fid_su4_kernel<4, kProduct><<<grid, kThreads, smem, s>>>(
          pulses, t_re, t_im, d1, d2, eps, partials, prod, L, M, xtalk, coupling,
          scaling, tau_scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  uqoc::reduce_partials_kernel<kThreads><<<B, kThreads, 0, s>>>(
      partials, static_cast<int>(grid.x), out, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int uqoc_su4_num_blocks(int64_t M) { return static_cast<int>(num_blocks(M)); }

// P = 4 is the drive2 system (the wrapper checks it).
cudaError_t uqoc_su4_propagate_mc(const float* pulses, const float* d1,
                                  const float* d2, const float* eps,
                                  float* out_re, float* out_im, int B, int L,
                                  int P, int64_t M, float xtalk, float coupling,
                                  int scaling, void* stream) {
  const dim3 grid(num_blocks(M), B);
  const size_t smem = row_bytes(L);
  const float tau_scale = std::ldexp(1.0f, -scaling);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2:
      propagate_su4_kernel<2><<<grid, kThreads, smem, s>>>(
          pulses, d1, d2, eps, out_re, out_im, L, M, xtalk, coupling, scaling, tau_scale);
      break;
    case 3:
      propagate_su4_kernel<3><<<grid, kThreads, smem, s>>>(
          pulses, d1, d2, eps, out_re, out_im, L, M, xtalk, coupling, scaling, tau_scale);
      break;
    case 4:
      propagate_su4_kernel<4><<<grid, kThreads, smem, s>>>(
          pulses, d1, d2, eps, out_re, out_im, L, M, xtalk, coupling, scaling, tau_scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// B6: partials (B, uqoc_su4_num_blocks(M)) scratch, out (B,).
cudaError_t uqoc_su4_mean_fidelity(const float* pulses, const float* t_re,
                                   const float* t_im, const float* d1,
                                   const float* d2, const float* eps,
                                   float* partials, float* out, int B, int L,
                                   int P, int64_t M, float xtalk,
                                   float coupling, int scaling, void* stream) {
  return launch_mean_fidelity<false>(pulses, t_re, t_im, d1, d2, eps, partials, out,
                                     nullptr, B, L, P, M, xtalk, coupling, scaling,
                                     static_cast<cudaStream_t>(stream));
}

// B4: as B6, and prod (B, 32, M) receives each sample's product.
cudaError_t uqoc_su4_mean_fidelity_with_product(
    const float* pulses, const float* t_re, const float* t_im, const float* d1,
    const float* d2, const float* eps, float* partials, float* out, float* prod,
    int B, int L, int P, int64_t M, float xtalk, float coupling, int scaling,
    void* stream) {
  return launch_mean_fidelity<true>(pulses, t_re, t_im, d1, d2, eps, partials, out,
                                    prod, B, L, P, M, xtalk, coupling, scaling,
                                    static_cast<cudaStream_t>(stream));
}

}  // extern "C"
