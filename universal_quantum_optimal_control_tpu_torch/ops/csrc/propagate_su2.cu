// SU(2) Monte-Carlo propagation kernels for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   B3  universal_quantum_optimal_control_tpu/ops/propagate_pallas.py:_prop_kernel
//       -> propagate_mc_kernel: per-sample product quaternion, (B, M, 4).
//   B1  universal_quantum_optimal_control_tpu/ops/propagate_pallas.py:_fid_kernel
//       -> mean_fid_kernel + reduce_partials_kernel: per-target mean
//          entanglement fidelity F = (4<q, q_t>^2 + 2) / 6, (B,).
//   B2  universal_quantum_optimal_control_tpu/ops/propagate_pallas_bwd.py:_bwd_kernel
//       -> propagate_mc_vjp_kernel + reduce_columns_kernel: the VJP of
//          B3 with O(1) residuals (see the B2 section below).
//
// What bounds them on an H100: arithmetic.  Each (target b, sample m) is an
// independent chain of L dependent steps: build the closed-form segment
// quaternion (one sincos plus a few multiplies), then one Hamilton product
// (28 flops) into the running product.  Per sample the kernels read 8 bytes
// (delta, epsilon) and write 16 bytes (B3) or nothing but a block partial
// (B1), against about 55-65 flops per segment times L; at L = 100 that is
// hundreds of flops per byte, far right of the ridge point, so the f32
// CUDA-core rate (67 TFLOP/s) is the bound, not the 3.35 TB/s of HBM.
//
// What the design does about it:
//   * one thread per (b, m) sample; the running product lives in registers
//     for the whole L loop, nothing per segment touches device memory;
//   * the target's pulse row is staged once per block into shared memory,
//     with cos(phi) and sin(phi) precomputed there (they do not depend on
//     the sample), so the loop does one sincos per segment, not three;
//   * P = 2 hoists the per-sample axis norm sqrt(1 + delta^2) out of the
//     loop (the axis (cos phi, sin phi, delta) has that norm at every
//     segment); P = 3 / 4 clamp Omega at 0 once when staging and form the
//     axis (Omega cos phi, Omega sin phi, Delta + delta) norm per segment;
//   * no TPU padding: M need not be a multiple of anything, threads past M
//     are masked by a bounds check.
//
// Sincos: all kernels use CUDA's accurate sincosf (compiled without
// --use_fast_math), which resolves the sign of sin and cos.  B3's quaternions
// leave the kernel, so a sign-free variant would flip them; B1 and B2 use the
// same sign-resolved sincosf, so the sign trap cannot arise in any of them.
//
// Reduction (B1): common.cuh's deterministic two passes, one partial per
// block, then a target's partials summed in double.  No atomics, so the
// result is the same from run to run.
//
// Interface: extern "C" launchers returning cudaError_t (the launch status
// from cudaGetLastError), loaded with ctypes.  The caller owns every buffer
// and passes PyTorch's current stream; nothing here allocates or syncs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Quat {
  float w, x, y, z;
};

// p ∘ q (maps to U(p) @ U(q)).
__device__ __forceinline__ Quat hamilton(const Quat& p, const Quat& q) {
  Quat r;
  r.w = p.w * q.w - p.x * q.x - p.y * q.y - p.z * q.z;
  r.x = p.w * q.x + p.x * q.w + p.y * q.z - p.z * q.y;
  r.y = p.w * q.y + p.y * q.w + p.z * q.x - p.x * q.z;
  r.z = p.w * q.z + p.z * q.w + p.x * q.y - p.y * q.x;
  return r;
}

// Shared-memory row of the block's target, structure of arrays over L:
//   [0, L) cos phi   [L, 2L) sin phi   [2L, 3L) tau
//   [3L, 4L) max(Omega, 0)  (P >= 3)   [4L, 5L) Delta  (P == 4)
// Pulse channels are (phi, tau), (phi, Omega, tau) or (phi, Omega, Delta, tau).
template <int P>
__device__ __forceinline__ void stage_row(const float* __restrict__ pulses,
                                          int b, int L, float* row) {
  const float* src = pulses + static_cast<int64_t>(b) * L * P;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    const float phi = src[k * P];
    float s, c;
    sincosf(phi, &s, &c);
    row[k] = c;
    row[L + k] = s;
    row[2 * L + k] = src[k * P + P - 1];
    if (P >= 3) row[3 * L + k] = fmaxf(src[k * P + 1], 0.0f);
    if (P == 4) row[4 * L + k] = src[k * P + 2];
  }
}

// Compose the L segments of one sample, left to right: q <- q_k ∘ q.
template <int P>
__device__ __forceinline__ Quat compose(const float* row, int L, float delta,
                                        float eps) {
  Quat q = {1.0f, 0.0f, 0.0f, 0.0f};
  if (P == 2) {
    const float anorm = sqrtf(1.0f + delta * delta);
    const float inv_anorm = 1.0f / anorm;
    const float scale = 0.5f * (1.0f + eps) * anorm;
    for (int k = 0; k < L; ++k) {
      float sh, w;
      sincosf(row[2 * L + k] * scale, &sh, &w);
      const float s = sh * inv_anorm;
      const Quat seg = {w, s * row[k], s * row[L + k], s * delta};
      q = hamilton(seg, q);
    }
  } else {
    const float scale = 0.5f * (1.0f + eps);
    for (int k = 0; k < L; ++k) {
      const float om = row[3 * L + k];
      const float zax = (P == 4) ? row[4 * L + k] + delta : delta;
      const float anorm = sqrtf(om * om + zax * zax);
      float sh, w;
      sincosf(row[2 * L + k] * scale * anorm, &sh, &w);
      const float s = sh / fmaxf(anorm, 1e-12f);
      const float so = s * om;
      const Quat seg = {w, so * row[k], so * row[L + k], s * zax};
      q = hamilton(seg, q);
    }
  }
  return q;
}

// B3: grid (ceil(M / kThreads), B); out is (B, M, 4).
template <int P>
__global__ void __launch_bounds__(kThreads)
propagate_mc_kernel(const float* __restrict__ pulses,
                    const float* __restrict__ delta,
                    const float* __restrict__ eps, float* __restrict__ out,
                    int L, int64_t M) {
  extern __shared__ float row[];
  const int b = blockIdx.y;
  stage_row<P>(pulses, b, L, row);
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  const Quat q = compose<P>(row, L, delta[i], eps[i]);
  reinterpret_cast<float4*>(out)[i] = make_float4(q.w, q.x, q.y, q.z);
}

// B1, pass 1: grid (ceil(M / kThreads), B); partials is (B, gridDim.x),
// each entry the sum of F over one block's samples.
template <int P>
__global__ void __launch_bounds__(kThreads)
mean_fid_kernel(const float* __restrict__ pulses,
                const float* __restrict__ q_target,
                const float* __restrict__ delta,
                const float* __restrict__ eps, float* __restrict__ partials,
                int L, int64_t M) {
  extern __shared__ float row[];
  const int b = blockIdx.y;
  stage_row<P>(pulses, b, L, row);
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float f = 0.0f;
  if (m < M) {
    const int64_t i = static_cast<int64_t>(b) * M + m;
    const Quat q = compose<P>(row, L, delta[i], eps[i]);
    const float* t = q_target + 4 * b;
    const float inner = t[0] * q.w + t[1] * q.x + t[2] * q.y + t[3] * q.z;
    f = (4.0f * inner * inner + 2.0f) / 6.0f;
  }
  f = uqoc::block_sum<kThreads>(f);
  if (threadIdx.x == 0)
    partials[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] = f;
}

// ---------------------------------------------------------------------------
// B2: the VJP of the MC propagator, cotangent g (B, M, 4) ->
// dpulses (B, L, P), ddelta (B, M), deps (B, M).
//
// Math (as the TPU kernel): with Q = L_k o q_k o R_k the product split at
// segment k, the cotangent of q_k is A_k = conj(L_k) o g o conj(R_k).  The
// kernel rebuilds Q, then sweeps k = L-1 .. 0 recovering R_k = conj(q_k) o
// R_{k+1} by inverse products (unit quaternions) and carrying G_k =
// conj(L_k) o g, updated as G_{k-1} = conj(q_k) o G_k, so it stores no
// per-segment residual and A_k = G_k o conj(R_k) takes one product.  A_k
// is chained through the closed-form segment quaternion into the pulse,
// delta and epsilon cotangents.  The prefix comes from inverse products of
// the full product, so f32 error grows about linearly in L.
//
// What bounds it: arithmetic, as B1.  Per (sample, segment) it does the
// forward rebuild (one segment and one Hamilton product) and the sweep (the
// segment again, three Hamilton products: R_k, A_k and the G update, and the
// chain rule), about four times B1's work, against 24 bytes per sample of
// input and 8 of output.
//
// What the design does about it:
//   * one thread per (b, m), everything in registers; the pulse row is
//     staged once per block exactly as B1 stages it;
//   * dphi, dOmega, dDelta, dtau are sums over the M samples of one target.
//     Blocks run in no order, so instead of the TPU's sequential SMEM
//     accumulation: a warp-shuffle sum per segment into this warp's slot of
//     a shared [warps][L * P] buffer (no __syncthreads inside the L loop), a
//     fixed-order sum over warps into one partial per block, and a second
//     kernel that sums a target's block partials in double.  No atomics, so
//     the result is the same from run to run;
//   * threads past M carry g = 0, which adds exactly 0 to every sum, and
//     stay in the shuffles;
//   * shared memory is the row plus warps * L * P floats (6.4 KB of buffer
//     at L = 100, P = 2; 51 KB at L = 400, P = 4); above 48 KB the launcher
//     opts in with cudaFuncSetAttribute.
//
// The Omega cotangent is gated on Omega_raw > 0 as the TPU kernel gates it;
// the staged max(Omega_raw, 0) is > 0 exactly when Omega_raw is.  The axis
// norm's square is floored at 1e-24, as the plain version floors it
// (core/su2.py::_axis_norm): where Omega <= 0 and Delta + delta = 0 exactly,
// which f32 draws do reach, the derivative along z is then the finite limit
// tau (1 + eps) / 2 of the closed form.  The TPU kernel floors the square at
// 1e-12, which gives the same limit; B1 and B3 floor the norm at 1e-12 after
// the square root, which changes no value by more than 1e-12.

constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ Quat conj(const Quat& q) {
  return {q.w, -q.x, -q.y, -q.z};
}

// One segment and the intermediates its chain rule reuses.
struct Segment {
  Quat q;
  float tau, om, zax, n, inv, sn, c, s, cphi, sphi;
};

// n2 / inv2: the P = 2 axis norm sqrt(1 + delta^2) and its inverse, hoisted
// by the caller (unused at P = 3 / 4).
template <int P>
__device__ __forceinline__ Segment segment(const float* row, int L, int k,
                                           float delta, float eps, float n2,
                                           float inv2) {
  Segment g;
  g.cphi = row[k];
  g.sphi = row[L + k];
  g.tau = row[2 * L + k];
  if (P == 2) {
    g.om = 1.0f;
    g.zax = delta;
    g.n = n2;
    g.inv = inv2;
  } else {
    g.om = row[3 * L + k];
    g.zax = (P == 4) ? row[4 * L + k] + delta : delta;
    g.n = sqrtf(fmaxf(g.om * g.om + g.zax * g.zax, 1e-24f));
    g.inv = 1.0f / g.n;
  }
  sincosf(g.tau * (0.5f * (1.0f + eps) * g.n), &g.sn, &g.c);
  g.s = g.sn * g.inv;
  const float so = g.s * g.om;
  g.q = {g.c, so * g.cphi, so * g.sphi, g.s * g.zax};
  return g;
}

// Floats of the staged pulse row (see stage_row).
__host__ __device__ inline size_t row_floats(int L, int P) {
  return static_cast<size_t>(L) * (P == 2 ? 3 : P + 1);
}

// B2, pass 1: grid (ceil(M / kThreads), B); partials is
// (B, gridDim.x, L * P), each entry one block's sum over its samples.
template <int P>
__global__ void __launch_bounds__(kThreads)
propagate_mc_vjp_kernel(const float* __restrict__ pulses,
                        const float* __restrict__ delta,
                        const float* __restrict__ eps,
                        const float* __restrict__ g,
                        float* __restrict__ partials,
                        float* __restrict__ ddelta,
                        float* __restrict__ deps, int L, int64_t M) {
  extern __shared__ float smem[];
  float* row = smem;
  float* red = smem + row_floats(L, P);  // [kWarps][L * P]
  const int b = blockIdx.y;
  stage_row<P>(pulses, b, L, row);
  __syncthreads();

  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const bool active = m < M;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  const float d = active ? delta[i] : 0.0f;
  const float e = active ? eps[i] : 0.0f;
  // G_k = conj(L_k) o g, starting from g: L_{L-1} is the identity
  Quat gl = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active) gl = {g[4 * i], g[4 * i + 1], g[4 * i + 2], g[4 * i + 3]};
  const float n2 = sqrtf(1.0f + d * d);
  const float inv2 = 1.0f / n2;

  // forward rebuild of the full product Q = q_L o ... o q_1
  Quat prod = {1.0f, 0.0f, 0.0f, 0.0f};
  for (int k = 0; k < L; ++k)
    prod = hamilton(segment<P>(row, L, k, d, e, n2, inv2).q, prod);

  // reverse sweep
  const int lp = L * P;
  float* red_w = red + (threadIdx.x >> 5) * lp;
  const bool lane0 = (threadIdx.x & 31) == 0;
  float dd = 0.0f, de = 0.0f;
  for (int k = L - 1; k >= 0; --k) {
    const Segment sg = segment<P>(row, L, k, d, e, n2, inv2);
    const Quat cq = conj(sg.q);
    const Quat r = hamilton(cq, prod);     // R_k
    const Quat a = hamilton(gl, conj(r));  // A_k
    // axy = <A_xy, (cos phi, sin phi)>, proj = <A_vec, axis>
    const float axy = a.x * sg.cphi + a.y * sg.sphi;
    const float proj = sg.om * axy + a.z * sg.zax;
    const float h_tau = 0.5f * (1.0f + e) * sg.n;
    const float h_eps = 0.5f * sg.tau * sg.n;
    const float h_del = 0.5f * sg.tau * (1.0f + e) * sg.zax * sg.inv;
    // dq/dphi = (0, -s Omega sin phi, s Omega cos phi, 0)
    const float dphi = (sg.s * sg.om) * (a.y * sg.cphi - a.x * sg.sphi);
    // dq/dtau = (-sin(half) h_tau, cos(half) h_tau / n * axis); eps alike
    const float dtau = -sg.sn * h_tau * a.w + sg.c * h_tau * sg.inv * proj;
    de += -sg.sn * h_eps * a.w + sg.c * h_eps * sg.inv * proj;
    // z axis (z = Delta + delta): shared by delta and, at P = 4, Delta
    const float ds_del = sg.c * h_del * sg.inv - sg.s * sg.zax * (sg.inv * sg.inv);
    const float ddel = -sg.sn * h_del * a.w + ds_del * proj + sg.s * a.z;
    dd += ddel;

    float v[P];
    v[0] = dphi;
    v[P - 1] = dtau;
    if constexpr (P >= 3) {
      const float h_om = 0.5f * sg.tau * (1.0f + e) * sg.om * sg.inv;
      const float ds_om = sg.c * h_om * sg.inv - sg.s * sg.om * (sg.inv * sg.inv);
      const float dom = -sg.sn * h_om * a.w + ds_om * proj + sg.s * axy;
      v[1] = sg.om > 0.0f ? dom : 0.0f;
    }
    if constexpr (P == 4) v[2] = ddel;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const float t = uqoc::warp_sum(v[p]);
      if (lane0) red_w[k * P + p] = t;
    }
    gl = hamilton(cq, gl);
    prod = r;
  }
  if (active) {
    ddelta[i] = dd;
    deps[i] = de;
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

inline size_t row_bytes(int L, int P) { return sizeof(float) * row_floats(L, P); }

// Shared memory B2's pass 1 takes: the pulse row and the [warps][L * P]
// reduction buffer.
inline size_t vjp_smem_bytes(int L, int P) {
  return sizeof(float) * (row_floats(L, P) + static_cast<size_t>(kWarps) * L * P);
}

template <int P>
cudaError_t launch_vjp(dim3 grid, size_t smem, cudaStream_t s,
                       const float* pulses, const float* delta,
                       const float* eps, const float* g, float* partials,
                       float* ddelta, float* deps, int L, int64_t M) {
  if (smem > 48 * 1024) {
    // refused past the card's opt-in limit (227 KB on sm_90)
    const cudaError_t err = cudaFuncSetAttribute(
        propagate_mc_vjp_kernel<P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, so no later launch reports it
      return err;
    }
  }
  propagate_mc_vjp_kernel<P><<<grid, kThreads, smem, s>>>(
      pulses, delta, eps, g, partials, ddelta, deps, L, M);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of pass 1 per target; the caller sizes the partials buffer (B, n).
int uqoc_su2_num_blocks(int64_t M) { return static_cast<int>(num_blocks(M)); }

// pulses (B, L, P), delta / eps (B, M), out (B, M, 4); all f32, contiguous.
cudaError_t uqoc_su2_propagate_mc(const float* pulses, const float* delta,
                                  const float* eps, float* out, int B, int L,
                                  int P, int64_t M, void* stream) {
  const dim3 grid(num_blocks(M), B);
  const size_t smem = row_bytes(L, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2:
      propagate_mc_kernel<2><<<grid, kThreads, smem, s>>>(pulses, delta, eps,
                                                          out, L, M);
      break;
    case 3:
      propagate_mc_kernel<3><<<grid, kThreads, smem, s>>>(pulses, delta, eps,
                                                          out, L, M);
      break;
    case 4:
      propagate_mc_kernel<4><<<grid, kThreads, smem, s>>>(pulses, delta, eps,
                                                          out, L, M);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// pulses (B, L, P), q_target (B, 4), delta / eps (B, M),
// partials (B, uqoc_su2_num_blocks(M)) scratch, out (B,); all f32, contiguous.
cudaError_t uqoc_su2_mean_fidelity(const float* pulses, const float* q_target,
                                   const float* delta, const float* eps,
                                   float* partials, float* out, int B, int L,
                                   int P, int64_t M, void* stream) {
  const dim3 grid(num_blocks(M), B);
  const size_t smem = row_bytes(L, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2:
      mean_fid_kernel<2><<<grid, kThreads, smem, s>>>(pulses, q_target, delta,
                                                      eps, partials, L, M);
      break;
    case 3:
      mean_fid_kernel<3><<<grid, kThreads, smem, s>>>(pulses, q_target, delta,
                                                      eps, partials, L, M);
      break;
    case 4:
      mean_fid_kernel<4><<<grid, kThreads, smem, s>>>(pulses, q_target, delta,
                                                      eps, partials, L, M);
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

// pulses (B, L, P), delta / eps (B, M), g (B, M, 4),
// partials (B, uqoc_su2_num_blocks(M), L * P) scratch, dpulses (B, L, P),
// ddelta / deps (B, M); all f32, contiguous.
cudaError_t uqoc_su2_propagate_mc_vjp(const float* pulses, const float* delta,
                                      const float* eps, const float* g,
                                      float* partials, float* dpulses,
                                      float* ddelta, float* deps, int B, int L,
                                      int P, int64_t M, void* stream) {
  const dim3 grid(num_blocks(M), B);
  const size_t smem = vjp_smem_bytes(L, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (P) {
    case 2:
      err = launch_vjp<2>(grid, smem, s, pulses, delta, eps, g, partials,
                          ddelta, deps, L, M);
      break;
    case 3:
      err = launch_vjp<3>(grid, smem, s, pulses, delta, eps, g, partials,
                          ddelta, deps, L, M);
      break;
    case 4:
      err = launch_vjp<4>(grid, smem, s, pulses, delta, eps, g, partials,
                          ddelta, deps, L, M);
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

}  // extern "C"
