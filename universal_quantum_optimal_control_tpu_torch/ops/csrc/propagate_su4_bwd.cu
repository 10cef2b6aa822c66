// SU(4) reverse-sweep VJP kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B5  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas_bwd.py:_bwd_prod_kernel
//       -> su4_vjp_kernel<P, false, G> + reduce_columns_kernel: the VJP of the
//          per-target mean fidelity (B4 / B6, propagate_su4.cu) under a
//          per-target cotangent gbar (B,), seeded with B4's saved per-sample
//          product (B, 32, M) -> dpulses (B, L, P), dd1, dd2, deps (B, M).
//   B8  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas_bwd.py:_bwd_kernel
//       -> su4_vjp_kernel<P, true, G> + reduce_columns_kernel: the same VJP
//          without a saved product: each sample first forms its product
//          P = U_L ... U_1 with B4's code, then runs B5's seed and sweep.
//
// Math (su4.cuh, reverse_sweep): per sample, the fidelity's cotangent G
// at the product P gives the seed V = G P^H; for k = L-1 .. 0 the segment
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
// What holds one thread per sample back: 255 registers, so at most two
// 128-thread blocks an SM; at the per-gate polish's 5 x 4096 samples a
// launch is 640 warps for the card's 528 warp schedulers, and a thread's
// segment a serial chain through V and S_0 set aside in shared memory (64
// floats a thread).  B5 took 1.0020 ms against a bound of 0.3754 ms (37 %)
// there, and no less than at the training shape with 1.6 times the samples
// (0.9601 ms; NVIDIA H100 80GB HBM3, 700 W).
//
// What the design does about it:
//   * each launch picks how to run a sample (uqoc::lane_groups_pay): one
//     thread per sample (seed(), reverse_sweep(): the design above) where
//     that gives the card's warp schedulers at least 1.5 warps each, as the
//     two-qubit training batch does, and a lane group per sample
//     (seed_lane(), reverse_sweep_lane()) where it would not, as at the
//     per-gate polish.  B5 takes 4 lanes: a lane holds one column of V, E,
//     S and of the T8 adjoint's matrices (su4.cuh, Lane), so 128 threads
//     are 32 samples, four times the warps at a quarter of the dense work,
//     126 registers and no stash.  A lane takes the other lanes' columns
//     from its warp's exchange area (7 compile-time slots of 1 KB a warp)
//     before each right or dense product: s + 5 exchanges per segment.
//     Executed flops per (sample, segment), summed over the 4 lanes: 14076
//     in the source against the bound's 12274 at P = 4
//     (tests/test_torch_su4_host.py counts both);
//   * B8 on lane groups forms its product on both pairs of the group's 4
//     lanes as B4's 2-lane groups form it (su4::product_rows_as_b4), then
//     runs B5's seed and sweep on the 4 lanes, so that it is B5 seeded by
//     B4 value for value, as on one thread per sample;
//   * the per-segment scalars (the envelopes, max(Omega, 0), tau / 2^s and
//     the phases' cos and sin) are staged once per block into shared memory,
//     so the sweep evaluates no transcendental;
//   * dphi, dOmega, dtau are sums over the M samples of one target: a
//     warp-shuffle sum per segment over the warp's samples (every G-th
//     lane: a group's lanes hold the same values) into this warp's slot of
//     a shared [warps][L * P] buffer, a fixed-order sum over warps into one
//     partial per block, and common.cuh's reduce_columns_kernel over the
//     blocks in double.  No atomics, so the result is the same from run to
//     run;
//   * samples past M carry a zero seed, which adds exactly 0 to every sum,
//     and their lanes take part in every exchange and shuffle;
//   * shared memory: the exchange area (B5 28 KB a block on lane groups,
//     B8 40 KB; the stash, 32 KB, on one thread), the row (10 L floats) and
//     the reduction buffer (4 L P floats); above 48 KB the launcher opts in
//     with cudaFuncSetAttribute and reports the card's refusal past its
//     limit.
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
// Lanes per sample where a lane group runs (B8 forms its product on pairs
// of them, as B4 does: su4::product_rows_as_b4)
constexpr int kLanes = su4::kSweepLanes;
// on lane groups: at most 128 registers a thread, 4 blocks an SM
template <int G>
constexpr int kMinBlocks = G == 1 ? 1 : 4;
constexpr int kRowFloats = 10;   // stage_row<P, true>
constexpr int kStashFloats = 64;  // one thread per sample: V, S_0
// B8 on lane groups: its product's slot in the 2-lane layout, after
// compose_lane's 4
constexpr int kProductSlot = 4;

// Samples per block, and the exchange area's floats (one thread per sample:
// the stash; B8 on lane groups: the larger of the sweep's slots and the
// product's 2-lane layout), at G lanes per sample.
template <int G>
constexpr int kSamples = kThreads / G;
constexpr int kWarpXch = su4::kSweepSlots * su4::slot_stride<kLanes>;
constexpr int kWarpXchB8 = (kProductSlot + 1) * su4::slot_stride<su4::kComposeLanes>;
template <int G, bool kRebuild>
constexpr int kXchFloats = G == 1 ? kStashFloats * kThreads
                                  : kWarps * (kRebuild && kWarpXchB8 > kWarpXch ? kWarpXchB8
                                                                                 : kWarpXch);

// Writes one segment's pulse cotangents, summed over the warp's samples,
// into the warp's slot of the block's reduction buffer.  The G lanes of a
// sample hold the same values, so the sum takes every G-th lane.
template <int P, int G>
struct WarpSink {
  float* red_w;
  bool lane0;
  __device__ __forceinline__ void operator()(int k, const float (&v)[P], bool = true) const {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      float t = v[p];
#pragma unroll
      for (int off = 16; off >= G; off >>= 1) t += __shfl_down_sync(0xffffffffu, t, off);
      if (lane0) red_w[k * P + p] = t;
    }
  }
};

// B5 (kRebuild false: reads prod) and B8 (kRebuild true: prod is unused and
// may be null), pass 1: grid (ceil(M / kSamples<G>), B); partials is
// (B, gridDim.x, L * P), each entry one block's sum over its samples.
// G = 1: one thread per sample (seed(), reverse_sweep()); G = kLanes:
// sample m on the G lanes G (m mod kSamples<G>) .. of block m / kSamples<G>
// (seed_lane(), reverse_sweep_lane()), B8's product formed on their pairs
// as B4 forms it (su4::product_rows_as_b4).
template <int P, bool kRebuild, int G>
__global__ void __launch_bounds__(kThreads, kMinBlocks<G>)
su4_vjp_kernel(const float* __restrict__ pulses, const float* __restrict__ t_re,
               const float* __restrict__ t_im, const float* __restrict__ gbar,
               const float* __restrict__ d1, const float* __restrict__ d2,
               const float* __restrict__ eps, const float* __restrict__ prod,
               float* __restrict__ partials, float* __restrict__ dd1_out,
               float* __restrict__ dd2_out, float* __restrict__ deps_out, int L,
               int64_t M, float xtalk, float coupling, int scaling, float tau_scale,
               float inv_m) {
  extern __shared__ float4 smem4[];
  float* xch = reinterpret_cast<float*>(smem4);  // 16-byte aligned parts first
  float* row = xch + kXchFloats<G, kRebuild>;
  float* red = row + kRowFloats * L;  // [kWarps][L * P]
  __shared__ float target[32];
  const int b = blockIdx.y;
  su4::stage_row<P, true>(pulses, b, L, xtalk, tau_scale, row);
  if (threadIdx.x < 16) {
    target[threadIdx.x] = t_re[16 * b + threadIdx.x];
    target[16 + threadIdx.x] = t_im[16 * b + threadIdx.x];
  }
  __syncthreads();

  const int64_t m = static_cast<int64_t>(blockIdx.x) * kSamples<G> + threadIdx.x / G;
  const bool active = m < M;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  const float d1v = active ? d1[i] : 0.0f, d2v = active ? d2[i] : 0.0f;
  const float ev = active ? eps[i] : 0.0f;
  const float* src = prod + static_cast<int64_t>(b) * 32 * M + m;
  // g = gbar / M * 2 / 20; 0 past M, so those samples add exactly 0
  const float gs = active ? gbar[b] * inv_m * 0.1f : 0.0f;
  const int lp = L * P;
  WarpSink<P, G> sink{red + (threadIdx.x >> 5) * lp, (threadIdx.x & 31) == 0};
  float dd1 = 0.0f, dd2 = 0.0f, de = 0.0f;
  bool lead = true;  // the thread that writes the sample's dd1, dd2, deps
  if constexpr (G == 1) {
    Mat Pp;
    if constexpr (kRebuild) {
      // the row's first 6 L floats are compose()'s (stage_row's layout)
      Pp = su4::compose(row, L, d1v, d2v, ev, coupling, scaling);
    } else {
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        Pp.re[e] = active ? src[e * M] : 0.0f;
        Pp.im[e] = active ? src[(16 + e) * M] : 0.0f;
      }
    }
    float* col = xch + threadIdx.x;
    su4::stash_store(col, kThreads, su4::seed(Pp, target, target + 16, gs));
    su4::reverse_sweep<P>(row, L, d1v, d2v, ev, coupling, xtalk, scaling, tau_scale, col,
                          kThreads, dd1, dd2, de, sink);
  } else {
    constexpr int NC = 4 / G;
    const int g = (threadIdx.x & 31) / G;  // the sample's index in the warp
    float* warp = xch + (threadIdx.x >> 5) * (kXchFloats<G, kRebuild> / kWarps);
    const su4::Lane ln{warp + su4::kSlotFloats * g, static_cast<int>(threadIdx.x % G) * NC,
                       g & (8 / G - 1)};
    lead = ln.c == 0;
    // the frame's rows j of the product, P(j ^ c, k ^ c) at [j][k]
    float pr[NC][4], pi[NC][4];
    if constexpr (kRebuild) {
      static_assert(G == 4, "B8's product is formed on pairs of 4 lanes");
      su4::product_rows_as_b4<kProductSlot>(row, L, d1v, d2v, ev, coupling, scaling, warp, g,
                                            ln.c, pr, pi);
      su4::group_sync();  // the area is the sweep's from here
    } else {
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int e = (4 * j + k) ^ (5 * ln.c);
          pr[j][k] = active ? src[e * M] : 0.0f;
          pi[j][k] = active ? src[(16 + e) * M] : 0.0f;
        }
    }
    su4::Col V[NC];
    su4::seed_lane<G>(pr, pi, target, target + 16, gs, ln, V);
    su4::reverse_sweep_lane<G, P>(row, L, d1v, d2v, ev, coupling, xtalk, scaling, tau_scale, ln,
                                  V, dd1, dd2, de, sink);
  }
  if (active && lead) {
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

// Lanes per sample for B targets of M samples (1: one thread each).
inline int lanes(int B, int64_t M) {
  return uqoc::lane_groups_pay(B * ((M + kThreads - 1) / kThreads)) ? kLanes : 1;
}

// Blocks of pass 1 per target.
inline unsigned int num_blocks(int B, int64_t M) {
  const int per_block = kThreads / lanes(B, M);
  return static_cast<unsigned int>((M + per_block - 1) / per_block);
}

template <int G, bool kRebuild>
size_t vjp_smem(int L, int P) {
  return sizeof(float) * (static_cast<size_t>(kXchFloats<G, kRebuild>) +
                          static_cast<size_t>(kRowFloats) * L +
                          static_cast<size_t>(kWarps) * L * P);
}

template <int P, bool kRebuild, int G>
cudaError_t launch_vjp(int B, cudaStream_t s, const float* pulses, const float* t_re,
                       const float* t_im, const float* gbar, const float* d1, const float* d2,
                       const float* eps, const float* prod, float* partials, float* dd1,
                       float* dd2, float* deps, int L, int64_t M, float xtalk, float coupling,
                       int scaling, float tau_scale, float inv_m) {
  const size_t smem = vjp_smem<G, kRebuild>(L, P);
  if (smem > 47 * 1024) {
    // beside the static target row; refused past the card's opt-in limit
    // (227 KB on sm_90)
    const cudaError_t err = cudaFuncSetAttribute(
        su4_vjp_kernel<P, kRebuild, G>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so no later launch reports it
      return err;
    }
  }
  const dim3 grid(static_cast<unsigned int>((M + kSamples<G> - 1) / kSamples<G>), B);
  su4_vjp_kernel<P, kRebuild, G><<<grid, kThreads, smem, s>>>(
      pulses, t_re, t_im, gbar, d1, d2, eps, prod, partials, dd1, dd2, deps, L, M, xtalk,
      coupling, scaling, tau_scale, inv_m);
  return cudaGetLastError();
}

template <int P, bool kRebuild>
cudaError_t launch_vjp_p(int B, cudaStream_t s, const float* pulses, const float* t_re,
                         const float* t_im, const float* gbar, const float* d1,
                         const float* d2, const float* eps, const float* prod,
                         float* partials, float* dd1, float* dd2, float* deps, int L,
                         int64_t M, float xtalk, float coupling, int scaling, float tau_scale,
                         float inv_m) {
  if (lanes(B, M) == 1)
    return launch_vjp<P, kRebuild, 1>(B, s, pulses, t_re, t_im, gbar, d1, d2, eps, prod,
                                      partials, dd1, dd2, deps, L, M, xtalk, coupling, scaling,
                                      tau_scale, inv_m);
  return launch_vjp<P, kRebuild, kLanes>(B, s, pulses, t_re, t_im, gbar, d1, d2, eps, prod,
                                         partials, dd1, dd2, deps, L, M, xtalk, coupling,
                                         scaling, tau_scale, inv_m);
}

// B5 (kRebuild false) or B8: both passes.
template <bool kRebuild>
cudaError_t objective_vjp(const float* pulses, const float* t_re, const float* t_im,
                          const float* gbar, const float* d1, const float* d2,
                          const float* eps, const float* prod, float* partials,
                          float* dpulses, float* dd1, float* dd2, float* deps, int B,
                          int L, int P, int64_t M, float xtalk, float coupling,
                          int scaling, cudaStream_t s) {
  const float tau_scale = std::ldexp(1.0f, -scaling);
  const float inv_m = 1.0f / static_cast<float>(M);
  cudaError_t err;
  switch (P) {
    case 2:
      err = launch_vjp_p<2, kRebuild>(B, s, pulses, t_re, t_im, gbar, d1, d2, eps, prod,
                                      partials, dd1, dd2, deps, L, M, xtalk, coupling, scaling,
                                      tau_scale, inv_m);
      break;
    case 3:
      err = launch_vjp_p<3, kRebuild>(B, s, pulses, t_re, t_im, gbar, d1, d2, eps, prod,
                                      partials, dd1, dd2, deps, L, M, xtalk, coupling, scaling,
                                      tau_scale, inv_m);
      break;
    case 4:
      err = launch_vjp_p<4, kRebuild>(B, s, pulses, t_re, t_im, gbar, d1, d2, eps, prod,
                                      partials, dd1, dd2, deps, L, M, xtalk, coupling, scaling,
                                      tau_scale, inv_m);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return err;
  const int lp = L * P;
  const dim3 grid2((lp + kThreads - 1) / kThreads, B);
  uqoc::reduce_columns_kernel<kThreads><<<grid2, kThreads, 0, s>>>(
      partials, static_cast<int>(num_blocks(B, M)), lp, dpulses);
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

template <int P, bool kRebuild>
int vjp_blocks_per_sm(int B, int64_t M, int L) {
  if (lanes(B, M) == 1)
    return blocks_per_sm(su4_vjp_kernel<P, kRebuild, 1>, vjp_smem<1, kRebuild>(L, P));
  return blocks_per_sm(su4_vjp_kernel<P, kRebuild, kLanes>, vjp_smem<kLanes, kRebuild>(L, P));
}

}  // namespace

extern "C" {

// Blocks of pass 1 per target, B5 and B8, for B targets of M samples; the
// caller sizes the partials buffer (B, n, L * P).
int uqoc_su4_vjp_num_blocks(int B, int64_t M) { return static_cast<int>(num_blocks(B, M)); }

// Lanes per sample that B5 and B8 take for B targets of M samples (1: one
// thread per sample).
int uqoc_su4_vjp_lanes(int B, int64_t M) { return lanes(B, M); }

// Resident blocks per SM of B8's (rebuild != 0) or B5's pass 1 for B targets
// of M samples at pulse width P and L segments
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
int uqoc_su4_vjp_blocks_per_sm(int B, int64_t M, int P, int rebuild, int L) {
  switch (P) {
    case 2:
      return rebuild ? vjp_blocks_per_sm<2, true>(B, M, L) : vjp_blocks_per_sm<2, false>(B, M, L);
    case 3:
      return rebuild ? vjp_blocks_per_sm<3, true>(B, M, L) : vjp_blocks_per_sm<3, false>(B, M, L);
    case 4:
      return rebuild ? vjp_blocks_per_sm<4, true>(B, M, L) : vjp_blocks_per_sm<4, false>(B, M, L);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

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
