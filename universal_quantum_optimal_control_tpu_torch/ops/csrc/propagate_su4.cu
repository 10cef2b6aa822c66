// SU(4) Monte-Carlo propagation kernels for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   B7  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py:_prop_kernel
//       -> propagate_su4_kernel (one thread per sample) or
//          propagate_su4_chunks_kernel (a sample's segments in chunks):
//          per-sample product U_L ... U_1 as (re, im), each (B, M, 4, 4).
//   B6  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py:_fid_kernel
//       -> mean_fid_su4_kernel<P, false, G> + reduce_partials_kernel: per-target
//          mean entanglement fidelity F = (|Tr(U^H T)|^2 + 4) / 20, (B,).
//   B4  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py:_fid_prod_kernel
//       -> mean_fid_su4_kernel<P, true, G> + reduce_partials_kernel: B6 that also
//          writes each sample's product, the residual of the reverse sweep B5
//          (propagate_su4_bwd.cu), as (B, 32, M): 16 re, then 16 im, the
//          sample index fastest.
//
// The per-sample math (su4.cuh): L segments, each the sparse
// A = -i H tau / 2^s, the order-8 Paterson-Stockmeyer T8(A) and s
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
// What holds one thread per sample back (B4, B6): at the per-gate polish's
// 5 x 4096 samples a launch is 160 blocks of 4 warps, about one warp per
// warp scheduler, too few to hide a thread's dependent FMAs: B4 took 0.2815
// ms against a bound of 0.1120 ms (40 %), and no less than at the training
// shape with 1.6 times the samples (0.2761 ms; NVIDIA H100 80GB HBM3,
// 700 W).
//
// What the design does about it:
//   * each launch of B4 or B6 picks how to run a sample
//     (uqoc::lane_groups_pay): one thread per sample (compose()) where that
//     gives the card's warp schedulers at least 1.5 warps each, as the
//     two-qubit training batch does, and a lane group of kLanes = 2 lanes
//     of a warp per sample (su4.cuh, compose_lane) where it would not, as
//     at the per-gate polish: a lane holds two columns of W and of each
//     segment's exp(A) - I, builds A's powers, P and Q itself (repeated,
//     not part of the bound; one segment ahead, so that they fill the wait
//     of the segment's first exchange) and takes the other lane's columns
//     from the warp's exchange area in shared memory before each dense
//     product (s + 1 per segment, compile-time slots).  A block of 128
//     threads is 64 samples on lane groups.  Executed flops per
//     sample-segment, summed over the 2 lanes: 4186 in the source against
//     the bound's 3661 (tests/test_torch_su4_host.py counts both on a host
//     build; the card drops P's, Q's and A^3's entries no lane reads);
//   * 2 lanes, not 4: the segment build every lane repeats costs 4 x 525
//     flops at 4 lanes, 40 % over the bound's 3661 (PERF.md);
//   * lanes past M compose with zero disorder, so the group's exchanges
//     stay whole; their product is not written and their F counts 0;
//   * Tr(U^H T) is summed over the lane's columns, then over the group in a
//     fixed order (su4::group_sum); the group's first lane adds F to the
//     block;
//   * B7 runs each launch under a plan, K chunks a sample (su4.cuh,
//     prop_plan): a sample's L segments split into K chunks, one thread
//     each, then log2 K combines through shared memory (su4.cuh, "B7 on
//     chunks").  One thread per sample left the GRAPE robustness curve (1 x
//     4096 samples, L = 20) 32 blocks, one warp a scheduler on a quarter of
//     the SMs, each thread's 20 segments the launch, and put 3 blocks on 49
//     SMs and 2 on the rest at serving's sweep (1 x 40 000, L = 100).  The
//     plan gives the busiest SM the least work: K = 4 and K = 2 there; the
//     sweeps of many waves keep K = 1, the one-thread kernel.  The chunked
//     kernel stages each block's products in shared memory and stores them
//     as contiguous float4 runs;
//   * the per-segment scalars depend on the target and the segment only, not
//     on the sample: each block stages them once into shared memory (the
//     envelopes' cos and sin with the accurate sincosf, max(Omega, 0) and
//     tau / 2^s: 6 floats per segment), so no sample evaluates a
//     transcendental;
//   * no TPU padding: M need not be a multiple of anything, samples past M
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
constexpr int kWarps = kThreads / 32;
constexpr int kLanes = su4::kComposeLanes;  // B4, B6: lanes per sample on lane groups
constexpr int kFwdSlots = 4;   // compose_lane's exchange slots
// B4, B6 on lane groups: at most 168 registers a thread, 3 blocks an SM
constexpr int kMinBlocks = 3;
constexpr int kRowFloats = 6;  // e1r, e1i, e2r, e2i, max(Omega, 0), tau / 2^s

// Samples per block, and the exchange area's floats, at G lanes per sample.
template <int G>
constexpr int kSamples = kThreads / G;
template <int G>
constexpr int kXchFloats = G == 1 ? 0 : kWarps * kFwdSlots * su4::slot_stride<G>;

// B7's chunked launches: the chunks' exchange, a column of 32 floats a
// thread, then the block's products staged for the store (32 floats a
// sample).
constexpr int kChunkXchFloats = kThreads * su4::kSlotFloats;

// B7 on one thread per sample (plan K = 1): grid (ceil(M / kThreads), B);
// out_re and out_im are (B, M, 16).
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

// B7 on chunks (plan K > 1): grid (ceil(M / S), B) with S = kThreads / K
// samples a block; sample m on the K threads K (m mod S) .. of block m / S,
// one warp's (K divides 32), chunk j on thread K (m mod S) + j (su4.cuh,
// compose_chunk and the tree).  Chunk 0 stages the sample's W in shared
// memory and the block stores its samples' (S, 16) re and im as contiguous
// float4 runs.
template <int P>
__global__ void __launch_bounds__(kThreads)
propagate_su4_chunks_kernel(const float* __restrict__ pulses, const float* __restrict__ d1,
                            const float* __restrict__ d2, const float* __restrict__ eps,
                            float* __restrict__ out_re, float* __restrict__ out_im, int L,
                            int64_t M, int K, float xtalk, float coupling, int scaling,
                            float tau_scale) {
  extern __shared__ float4 smem4[];
  float* xch = reinterpret_cast<float*>(smem4);
  float* row = xch + kChunkXchFloats;
  const int b = blockIdx.y;
  const int S = kThreads / K;
  const int t = threadIdx.x, s = t / K, j = t % K;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * S, m = m0 + s;
  const bool active = m < M;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  // samples past M compose with zero disorder and are not stored; the
  // loads are issued before the row is staged, so that their wait overlaps it
  const float v1 = active ? d1[i] : 0.0f, v2 = active ? d2[i] : 0.0f;
  const float ve = active ? eps[i] : 0.0f;
  su4::stage_row<P>(pulses, b, L, xtalk, tau_scale, row);
  __syncthreads();
  Mat W = su4::compose_chunk(row, L, K, j, v1, v2, ve, coupling, scaling);
  su4::combine_chunks(K, j, xch + t, kThreads, W);
  __syncthreads();
  if (j == 0) su4::stash_store(xch + 32 * s, 1, W);  // 16 re, then 16 im
  __syncthreads();
  const int64_t n = M - m0 < S ? M - m0 : S;
  float4* re = reinterpret_cast<float4*>(out_re) + 4 * (static_cast<int64_t>(b) * M + m0);
  float4* im = reinterpret_cast<float4*>(out_im) + 4 * (static_cast<int64_t>(b) * M + m0);
  for (int q = t; q < 4 * n; q += kThreads) {
    re[q] = smem4[8 * (q / 4) + q % 4];
    im[q] = smem4[8 * (q / 4) + 4 + q % 4];
  }
}

// B6 (kProduct false) and B4 (kProduct true), pass 1: grid
// (ceil(M / kSamples<G>), B); partials is (B, gridDim.x), each entry the
// sum of F over one block's samples; B4 also writes prod (B, 32, M).  G = 1:
// one thread per sample (compose()); G = kLanes: sample m on the G lanes
// G (m mod kSamples<G>) .. of block m / kSamples<G> (compose_lane()), each
// writing its columns.  F per sample: Tr(U^H T) in 64 FMAs, then
// (|Tr|^2 + 4) / 20: 134 flops.
template <int P, bool kProduct, int G>
__global__ void __launch_bounds__(kThreads, G == 1 ? 1 : kMinBlocks)
mean_fid_su4_kernel(const float* __restrict__ pulses,
                    const float* __restrict__ t_re,
                    const float* __restrict__ t_im,
                    const float* __restrict__ d1, const float* __restrict__ d2,
                    const float* __restrict__ eps,
                    float* __restrict__ partials, float* __restrict__ prod,
                    int L, int64_t M, float xtalk, float coupling, int scaling,
                    float tau_scale) {
  extern __shared__ float4 smem4[];
  float* xch = reinterpret_cast<float*>(smem4);  // 16-byte aligned parts first
  float* row = xch + kXchFloats<G>;
  __shared__ float target[32];
  const int b = blockIdx.y;
  su4::stage_row<P>(pulses, b, L, xtalk, tau_scale, row);
  if (threadIdx.x < 16) {
    target[threadIdx.x] = t_re[16 * b + threadIdx.x];
    target[16 + threadIdx.x] = t_im[16 * b + threadIdx.x];
  }
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kSamples<G> + threadIdx.x / G;
  const bool active = m < M;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  float* out = kProduct ? prod + static_cast<int64_t>(b) * 32 * M + m : nullptr;
  float f = 0.0f;
  if constexpr (G == 1) {
    if (active) {
      const Mat W = su4::compose(row, L, d1[i], d2[i], eps[i], coupling, scaling);
      if (kProduct) {
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
  } else {
    const int g = (threadIdx.x & 31) / G;  // the sample's index in the warp
    const su4::Lane ln{xch + (threadIdx.x >> 5) * kFwdSlots * su4::slot_stride<G> +
                           su4::kSlotFloats * g,
                       static_cast<int>(threadIdx.x % G) * (4 / G), g & (8 / G - 1)};
    // lanes past M compose with zero disorder: the group's exchanges stay whole
    su4::Col W[4 / G];
    su4::compose_lane<G>(row, L, active ? d1[i] : 0.0f, active ? d2[i] : 0.0f,
                         active ? eps[i] : 0.0f, coupling, scaling, ln, W);
    // the lane's column j: W(r ^ c, j ^ c) at entry (4 r + j) ^ 5c
    float re = 0.0f, im = 0.0f;
#pragma unroll
    for (int j = 0; j < 4 / G; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = (4 * r + j) ^ (5 * ln.c);
        if (kProduct && active) {
          out[e * M] = W[j].re[r];
          out[(16 + e) * M] = W[j].im[r];
        }
        const float tr = target[e], ti = target[16 + e];
        re = fmaf(W[j].re[r], tr, re);
        re = fmaf(W[j].im[r], ti, re);
        im = fmaf(W[j].re[r], ti, im);
        im = fmaf(-W[j].im[r], tr, im);
      }
    re = su4::group_sum<G>(re);
    im = su4::group_sum<G>(im);
    if (active && ln.c == 0) f = (fmaf(re, re, im * im) + 4.0f) / 20.0f;
  }
  f = uqoc::block_sum<kThreads>(f);
  if (threadIdx.x == 0)
    partials[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] = f;
}

inline size_t row_bytes(int L) { return sizeof(float) * kRowFloats * L; }

// B4, B6: lanes per sample for B targets of M samples (1: one thread each).
inline int lanes(int B, int64_t M) {
  return uqoc::lane_groups_pay(B * ((M + kThreads - 1) / kThreads)) ? kLanes : 1;
}

// B4, B6: blocks of pass 1 per target.
inline unsigned int num_blocks(int B, int64_t M) {
  const int per_block = kThreads / lanes(B, M);
  return static_cast<unsigned int>((M + per_block - 1) / per_block);
}

template <int G>
size_t fid_smem(int L) {
  return sizeof(float) * kXchFloats<G> + row_bytes(L);
}

template <int P, bool kProduct, int G>
cudaError_t launch_fid(int B, cudaStream_t s, const float* pulses, const float* t_re,
                       const float* t_im, const float* d1, const float* d2, const float* eps,
                       float* partials, float* prod, int L, int64_t M, float xtalk,
                       float coupling, int scaling, float tau_scale) {
  const size_t smem = fid_smem<G>(L);
  if (smem > 47 * 1024) {
    // beside the static target and block-sum rows; refused past the card's
    // opt-in limit (227 KB on sm_90)
    const cudaError_t err = cudaFuncSetAttribute(
        mean_fid_su4_kernel<P, kProduct, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so no later launch reports it
      return err;
    }
  }
  const dim3 grid(static_cast<unsigned int>((M + kSamples<G> - 1) / kSamples<G>), B);
  mean_fid_su4_kernel<P, kProduct, G><<<grid, kThreads, smem, s>>>(
      pulses, t_re, t_im, d1, d2, eps, partials, prod, L, M, xtalk, coupling, scaling,
      tau_scale);
  return cudaGetLastError();
}

template <int P, bool kProduct>
cudaError_t launch_fid_p(int B, cudaStream_t s, const float* pulses, const float* t_re,
                         const float* t_im, const float* d1, const float* d2, const float* eps,
                         float* partials, float* prod, int L, int64_t M, float xtalk,
                         float coupling, int scaling, float tau_scale) {
  if (lanes(B, M) == 1)
    return launch_fid<P, kProduct, 1>(B, s, pulses, t_re, t_im, d1, d2, eps, partials, prod, L,
                                      M, xtalk, coupling, scaling, tau_scale);
  return launch_fid<P, kProduct, kLanes>(B, s, pulses, t_re, t_im, d1, d2, eps, partials, prod,
                                         L, M, xtalk, coupling, scaling, tau_scale);
}

// B6 (prod null) or B4: both passes.
template <bool kProduct>
cudaError_t launch_mean_fidelity(const float* pulses, const float* t_re,
                                 const float* t_im, const float* d1,
                                 const float* d2, const float* eps,
                                 float* partials, float* out, float* prod, int B,
                                 int L, int P, int64_t M, float xtalk,
                                 float coupling, int scaling, cudaStream_t s) {
  const float tau_scale = std::ldexp(1.0f, -scaling);
  cudaError_t err;
  switch (P) {
    case 2:
      err = launch_fid_p<2, kProduct>(B, s, pulses, t_re, t_im, d1, d2, eps, partials, prod, L,
                                      M, xtalk, coupling, scaling, tau_scale);
      break;
    case 3:
      err = launch_fid_p<3, kProduct>(B, s, pulses, t_re, t_im, d1, d2, eps, partials, prod, L,
                                      M, xtalk, coupling, scaling, tau_scale);
      break;
    case 4:
      err = launch_fid_p<4, kProduct>(B, s, pulses, t_re, t_im, d1, d2, eps, partials, prod, L,
                                      M, xtalk, coupling, scaling, tau_scale);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  uqoc::reduce_partials_kernel<kThreads><<<B, kThreads, 0, s>>>(
      partials, static_cast<int>(num_blocks(B, M)), out, M);
  return cudaGetLastError();
}

// Resident blocks of `kernel` on one SM with smem bytes of dynamic shared
// memory, or minus the CUDA error.
template <class Kernel>
int blocks_per_sm(Kernel kernel, size_t smem) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

template <int P, bool kProduct>
int fid_blocks_per_sm(int B, int64_t M, int L) {
  if (lanes(B, M) == 1) return blocks_per_sm(mean_fid_su4_kernel<P, kProduct, 1>, fid_smem<1>(L));
  return blocks_per_sm(mean_fid_su4_kernel<P, kProduct, kLanes>, fid_smem<kLanes>(L));
}

// B7's plan for B targets of M samples of L segments on this card.
inline int prop_plan(int B, int64_t M, int L) {
  return su4::prop_plan(B, M, L, uqoc::sm_count(), kThreads);
}

// A plan the chunked kernel runs: K a power of two within a warp.
inline bool valid_plan(int K) { return K >= 1 && K <= 32 && (K & (K - 1)) == 0; }

inline size_t chunk_smem(int L) { return sizeof(float) * kChunkXchFloats + row_bytes(L); }

// B7 under plan K: 1 one thread per sample, else chunked.
template <int P>
cudaError_t launch_propagate(cudaStream_t s, const float* pulses, const float* d1,
                             const float* d2, const float* eps, float* out_re, float* out_im,
                             int B, int L, int64_t M, int K, float xtalk, float coupling,
                             int scaling) {
  const float tau_scale = std::ldexp(1.0f, -scaling);
  if (K == 1) {
    const dim3 grid(static_cast<unsigned int>((M + kThreads - 1) / kThreads), B);
    propagate_su4_kernel<P><<<grid, kThreads, row_bytes(L), s>>>(
        pulses, d1, d2, eps, out_re, out_im, L, M, xtalk, coupling, scaling, tau_scale);
    return cudaGetLastError();
  }
  const size_t smem = chunk_smem(L);
  if (smem > 48 * 1024) {  // refused past the card's opt-in limit (227 KB on sm_90)
    const cudaError_t err = cudaFuncSetAttribute(
        propagate_su4_chunks_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();
      return err;
    }
  }
  const int64_t per_block = kThreads / K;
  const dim3 grid(static_cast<unsigned int>((M + per_block - 1) / per_block), B);
  propagate_su4_chunks_kernel<P><<<grid, kThreads, smem, s>>>(
      pulses, d1, d2, eps, out_re, out_im, L, M, K, xtalk, coupling, scaling, tau_scale);
  return cudaGetLastError();
}

template <int P>
int prop_blocks_per_sm(int K, int L) {
  if (K == 1) return blocks_per_sm(propagate_su4_kernel<P>, row_bytes(L));
  return blocks_per_sm(propagate_su4_chunks_kernel<P>, chunk_smem(L));
}

}  // namespace

extern "C" {

// Blocks of B4's and B6's pass 1 per target for B targets of M samples; the
// caller sizes the partials buffer (B, n).
int uqoc_su4_num_blocks(int B, int64_t M) { return static_cast<int>(num_blocks(B, M)); }

// Lanes per sample that B4 and B6 take for B targets of M samples (1: one
// thread per sample).
int uqoc_su4_lanes(int B, int64_t M) { return lanes(B, M); }

// Resident blocks per SM of B4's (product != 0) or B6's pass 1 for B targets
// of M samples at pulse width P and L segments
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
int uqoc_su4_blocks_per_sm(int B, int64_t M, int P, int product, int L) {
  switch (P) {
    case 2:
      return product ? fid_blocks_per_sm<2, true>(B, M, L) : fid_blocks_per_sm<2, false>(B, M, L);
    case 3:
      return product ? fid_blocks_per_sm<3, true>(B, M, L) : fid_blocks_per_sm<3, false>(B, M, L);
    case 4:
      return product ? fid_blocks_per_sm<4, true>(B, M, L) : fid_blocks_per_sm<4, false>(B, M, L);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// B7's plan for B targets of M samples of L segments on this card: chunks
// per sample (K); 1 is one thread per sample.
int uqoc_su4_prop_chunks(int B, int64_t M, int L) { return prop_plan(B, M, L); }

// Resident blocks per SM of B7's kernel under plan K at pulse width P and L
// segments, or minus the CUDA error.
int uqoc_su4_prop_blocks_per_sm(int K, int P, int L) {
  if (!valid_plan(K)) return -static_cast<int>(cudaErrorInvalidValue);
  switch (P) {
    case 2:
      return prop_blocks_per_sm<2>(K, L);
    case 3:
      return prop_blocks_per_sm<3>(K, L);
    case 4:
      return prop_blocks_per_sm<4>(K, L);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// B7 under the plan K the caller names (uqoc_su4_propagate_mc takes the
// card's).  P = 4 is the drive2 system (the wrapper checks it).
cudaError_t uqoc_su4_propagate_mc_plan(const float* pulses, const float* d1, const float* d2,
                                       const float* eps, float* out_re, float* out_im, int B,
                                       int L, int P, int64_t M, int K, float xtalk,
                                       float coupling, int scaling, void* stream) {
  if (!valid_plan(K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2:
      return launch_propagate<2>(s, pulses, d1, d2, eps, out_re, out_im, B, L, M, K, xtalk,
                                 coupling, scaling);
    case 3:
      return launch_propagate<3>(s, pulses, d1, d2, eps, out_re, out_im, B, L, M, K, xtalk,
                                 coupling, scaling);
    case 4:
      return launch_propagate<4>(s, pulses, d1, d2, eps, out_re, out_im, B, L, M, K, xtalk,
                                 coupling, scaling);
    default:
      return cudaErrorInvalidValue;
  }
}

// B7 under the card's plan.
cudaError_t uqoc_su4_propagate_mc(const float* pulses, const float* d1,
                                  const float* d2, const float* eps,
                                  float* out_re, float* out_im, int B, int L,
                                  int P, int64_t M, float xtalk, float coupling,
                                  int scaling, void* stream) {
  return uqoc_su4_propagate_mc_plan(pulses, d1, d2, eps, out_re, out_im, B, L, P, M,
                                    prop_plan(B, M, L), xtalk, coupling, scaling, stream);
}

// B6: partials (B, uqoc_su4_num_blocks(B, M)) scratch, out (B,).
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
