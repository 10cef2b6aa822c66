// SU(4) reverse-sweep VJP kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B5  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas_bwd.py:_bwd_prod_kernel
//       -> su4_vjp_kernel<P, false> + reduce_columns_kernel: the VJP of the
//          per-target mean fidelity (B4 / B6, propagate_su4.cu) under a
//          per-target cotangent gbar (B,), seeded with B4's saved per-sample
//          product (B, 32, M) -> dpulses (B, L, P), dd1, dd2, deps (B, M).
//   B8  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas_bwd.py:_bwd_kernel
//       -> su4_vjp_kernel<P, true> + reduce_columns_kernel: the same VJP
//          without a saved product: each thread first forms its sample's
//          product P = U_L ... U_1 with compose() (B4's code, in registers),
//          then runs B5's seed and sweep.
//
// Math (su4.cuh, reverse_sweep): per sample, the fidelity's cotangent G at
// the product P gives the seed V = G P^H; for k = L-1 .. 0 the segment
// is rebuilt (A, its powers, T8(A), the squarings), its cotangent
// D = dL/dA is formed, chained to (phi1, [phi2,] [Omega,] tau) and to
// (d1, d2, eps), and V <- U_k^H V U_k.  The TPU kernel applies the expm
// adjoint to C_k = V U_k, squarings backward first; here D = Adj(V) U_k with
// the squarings' adjoints taken in forward order beside the squarings
// themselves, which is the same sum (every term commutes, see
// reverse_sweep), so no S_j is stored or rebuilt.
//
// What bounds them on an H100: arithmetic, as B4.  Per (sample, segment) B5
// rebuilds the segment (973 flops before the squarings), runs the T8
// adjoint (3552 flops of products with A, A^2, A^4 and Q^H), four
// squarings (544 each) beside four squaring adjoints (1056 each), 20
// entries of D = E U_k (316), the chain rule (57-65) and V <- U_k^H V U_k
// (960): 12264-12274 flops, 3.4 times B4's 3661, against 140 bytes per
// sample read (the product, d1, d2, eps) and 12 written.  B8 adds B4's 3661
// per segment for the product and reads 12 bytes per sample instead of 140.
//
// What the design does about it:
//   * one thread per (b, m) sample, as B4; the per-segment scalars (the
//     envelopes, max(Omega, 0), tau / 2^s and the phases' cos and sin) are
//     staged once per block into shared memory, so the sweep evaluates no
//     transcendental;
//   * registers: V and S_0 = T8(A) are set aside in a per-thread column of
//     shared memory while a segment's other matrices are live (each phase
//     holds at most four dense matrices besides A, A^2, A^4), and D is
//     formed only at the 20 entries the chain rule reads.  B8's product
//     phase is B4's (128 registers there); its registers are free again
//     once the seed is in shared memory, so the sweep's pressure is B5's;
//   * dphi, dOmega, dtau are sums over the M samples of one target: a
//     warp-shuffle sum per segment into this warp's slot of a shared
//     [warps][L * P] buffer, a fixed-order sum over warps into one partial
//     per block, and common.cuh's reduce_columns_kernel over the blocks in
//     double.  No atomics, so the result is the same from run to run;
//   * threads past M carry a zero seed, which adds exactly 0 to every sum,
//     and stay in the shuffles;
//   * shared memory: the row (10 L floats), the reduction buffer
//     (4 L P floats) and the stash (64 floats a thread, 32 KB a block);
//     above 48 KB the launcher opts in with cudaFuncSetAttribute and reports
//     the card's refusal past its limit.
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
constexpr int kRowFloats = 10;  // stage_row<P, true>
constexpr int kStashFloats = 64;  // V, S_0

// Writes one segment's pulse cotangents, summed over the warp, into the
// warp's slot of the block's reduction buffer.
template <int P>
struct WarpSink {
  float* red_w;
  bool lane0;
  __device__ __forceinline__ void operator()(int k, const float (&v)[P]) const {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float t = uqoc::warp_sum(v[p]);
      if (lane0) red_w[k * P + p] = t;
    }
  }
};

// B5 (kRebuild false: reads prod) and B8 (kRebuild true: prod is unused and
// may be null), pass 1: grid (ceil(M / kThreads), B); partials is
// (B, gridDim.x, L * P), each entry one block's sum over its samples.
template <int P, bool kRebuild>
__global__ void __launch_bounds__(kThreads)
su4_vjp_kernel(const float* __restrict__ pulses, const float* __restrict__ t_re,
               const float* __restrict__ t_im, const float* __restrict__ gbar,
               const float* __restrict__ d1, const float* __restrict__ d2,
               const float* __restrict__ eps, const float* __restrict__ prod,
               float* __restrict__ partials, float* __restrict__ dd1_out,
               float* __restrict__ dd2_out, float* __restrict__ deps_out, int L,
               int64_t M, float xtalk, float coupling, int scaling, float tau_scale,
               float inv_m) {
  extern __shared__ float smem[];
  float* row = smem;
  float* red = row + kRowFloats * L;          // [kWarps][L * P]
  float* stash = red + kWarps * L * P;        // [kStashFloats][kThreads]
  __shared__ float target[32];
  const int b = blockIdx.y;
  su4::stage_row<P, true>(pulses, b, L, xtalk, tau_scale, row);
  if (threadIdx.x < 16) {
    target[threadIdx.x] = t_re[16 * b + threadIdx.x];
    target[16 + threadIdx.x] = t_im[16 * b + threadIdx.x];
  }
  __syncthreads();

  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = m < M;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  Mat Pp;
  if constexpr (kRebuild) {
    // the row's first 6 L floats are compose()'s (stage_row's layout)
    Pp = su4::compose(row, L, active ? d1[i] : 0.0f, active ? d2[i] : 0.0f,
                      active ? eps[i] : 0.0f, coupling, scaling);
  } else {
    const float* src = prod + static_cast<int64_t>(b) * 32 * M + m;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      Pp.re[e] = active ? src[e * M] : 0.0f;
      Pp.im[e] = active ? src[(16 + e) * M] : 0.0f;
    }
  }
  // g = gbar / M * 2 / 20; 0 past M, so those threads add exactly 0
  const float g = active ? gbar[b] * inv_m * 0.1f : 0.0f;
  float* col = stash + threadIdx.x;
  su4::stash_store(col, kThreads, su4::seed(Pp, target, target + 16, g));

  const int lp = L * P;
  WarpSink<P> sink{red + (threadIdx.x >> 5) * lp, (threadIdx.x & 31) == 0};
  float dd1 = 0.0f, dd2 = 0.0f, de = 0.0f;
  su4::reverse_sweep<P>(row, L, active ? d1[i] : 0.0f, active ? d2[i] : 0.0f,
                        active ? eps[i] : 0.0f, coupling, xtalk, scaling, tau_scale,
                        col, kThreads, dd1, dd2, de, sink);
  if (active) {
    dd1_out[i] = dd1;
    dd2_out[i] = dd2;
    deps_out[i] = de;
  }

  __syncthreads();
  float* out = partials + (static_cast<int64_t>(b) * gridDim.x + blockIdx.x) * lp;
  for (int j = threadIdx.x; j < lp; j += kThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += red[w * lp + j];
    out[j] = s;
  }
}

inline unsigned int num_blocks(int64_t M) {
  return static_cast<unsigned int>((M + kThreads - 1) / kThreads);
}

inline size_t smem_bytes(int L, int P) {
  return sizeof(float) * (static_cast<size_t>(kRowFloats) * L +
                          static_cast<size_t>(kWarps) * L * P +
                          static_cast<size_t>(kStashFloats) * kThreads);
}

template <int P, bool kRebuild>
cudaError_t launch_vjp(dim3 grid, size_t smem, cudaStream_t s, const float* pulses,
                       const float* t_re, const float* t_im, const float* gbar,
                       const float* d1, const float* d2, const float* eps,
                       const float* prod, float* partials, float* dd1, float* dd2,
                       float* deps, int L, int64_t M, float xtalk, float coupling,
                       int scaling, float tau_scale, float inv_m) {
  if (smem > 47 * 1024) {
    // beside the static target row; refused past the card's opt-in limit
    // (227 KB on sm_90)
    const cudaError_t err = cudaFuncSetAttribute(
        su4_vjp_kernel<P, kRebuild>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so no later launch reports it
      return err;
    }
  }
  su4_vjp_kernel<P, kRebuild><<<grid, kThreads, smem, s>>>(
      pulses, t_re, t_im, gbar, d1, d2, eps, prod, partials, dd1, dd2, deps, L, M,
      xtalk, coupling, scaling, tau_scale, inv_m);
  return cudaGetLastError();
}

// B5 (kRebuild false) or B8: both passes.
template <bool kRebuild>
cudaError_t objective_vjp(const float* pulses, const float* t_re, const float* t_im,
                          const float* gbar, const float* d1, const float* d2,
                          const float* eps, const float* prod, float* partials,
                          float* dpulses, float* dd1, float* dd2, float* deps, int B,
                          int L, int P, int64_t M, float xtalk, float coupling,
                          int scaling, cudaStream_t s) {
  const dim3 grid(num_blocks(M), B);
  const size_t smem = smem_bytes(L, P);
  const float tau_scale = std::ldexp(1.0f, -scaling);
  const float inv_m = 1.0f / static_cast<float>(M);
  cudaError_t err;
  switch (P) {
    case 2:
      err = launch_vjp<2, kRebuild>(grid, smem, s, pulses, t_re, t_im, gbar, d1, d2, eps,
                                    prod, partials, dd1, dd2, deps, L, M, xtalk, coupling,
                                    scaling, tau_scale, inv_m);
      break;
    case 3:
      err = launch_vjp<3, kRebuild>(grid, smem, s, pulses, t_re, t_im, gbar, d1, d2, eps,
                                    prod, partials, dd1, dd2, deps, L, M, xtalk, coupling,
                                    scaling, tau_scale, inv_m);
      break;
    case 4:
      err = launch_vjp<4, kRebuild>(grid, smem, s, pulses, t_re, t_im, gbar, d1, d2, eps,
                                    prod, partials, dd1, dd2, deps, L, M, xtalk, coupling,
                                    scaling, tau_scale, inv_m);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int lp = L * P;
  const dim3 grid2((lp + kThreads - 1) / kThreads, B);
  uqoc::reduce_columns_kernel<kThreads><<<grid2, kThreads, 0, s>>>(
      partials, static_cast<int>(grid.x), lp, dpulses);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of pass 1 per target, B5 and B8; the caller sizes the partials
// buffer (B, n, L * P).
int uqoc_su4_vjp_num_blocks(int64_t M) { return static_cast<int>(num_blocks(M)); }

// B5: pulses (B, L, P), t_re / t_im (B, 4, 4), gbar (B,), d1 / d2 / eps
// (B, M), prod (B, 32, M) from B4 on the same inputs, partials scratch,
// dpulses (B, L, P), dd1 / dd2 / deps (B, M); all f32, contiguous.  P = 4 is
// the drive2 system (the wrapper checks it).
cudaError_t uqoc_su4_objective_vjp(const float* pulses, const float* t_re,
                                   const float* t_im, const float* gbar,
                                   const float* d1, const float* d2,
                                   const float* eps, const float* prod,
                                   float* partials, float* dpulses, float* dd1,
                                   float* dd2, float* deps, int B, int L, int P,
                                   int64_t M, float xtalk, float coupling,
                                   int scaling, void* stream) {
  return objective_vjp<false>(pulses, t_re, t_im, gbar, d1, d2, eps, prod, partials,
                              dpulses, dd1, dd2, deps, B, L, P, M, xtalk, coupling,
                              scaling, static_cast<cudaStream_t>(stream));
}

// B8: as B5 without prod; each sample's product is formed in the kernel.
cudaError_t uqoc_su4_objective_vjp_rebuild(const float* pulses, const float* t_re,
                                           const float* t_im, const float* gbar,
                                           const float* d1, const float* d2,
                                           const float* eps, float* partials,
                                           float* dpulses, float* dd1, float* dd2,
                                           float* deps, int B, int L, int P, int64_t M,
                                           float xtalk, float coupling, int scaling,
                                           void* stream) {
  return objective_vjp<true>(pulses, t_re, t_im, gbar, d1, d2, eps, nullptr, partials,
                             dpulses, dd1, dd2, deps, B, L, P, M, xtalk, coupling,
                             scaling, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
