// SU(2) Monte-Carlo propagation kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B3  universal_quantum_optimal_control_tpu/ops/propagate_pallas.py:_prop_kernel
//       -> propagate_mc_kernel: per-sample product quaternion, (B, M, 4).
//   B1  universal_quantum_optimal_control_tpu/ops/propagate_pallas.py:_fid_kernel
//       -> mean_fid_kernel + reduce_partials_kernel: per-target mean
//          entanglement fidelity F = (4<q, q_t>^2 + 2) / 6, (B,).
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
// Sincos: both kernels use CUDA's accurate sincosf (compiled without
// --use_fast_math), which resolves the sign of sin and cos.  B3's quaternions
// leave the kernel, so a sign-free variant would flip them; B1 uses the same
// sign-resolved sincosf, so the sign trap cannot arise in either.
//
// Reduction (B1): a fixed-order tree inside each block writes one partial
// per block; a second small kernel sums a target's partials in double, in a
// fixed order, and divides by M.  No atomics, so the result is the same from
// run to run.
//
// Interface: extern "C" launchers returning cudaError_t (the launch status
// from cudaGetLastError), loaded with ctypes.  The caller owns every buffer
// and passes PyTorch's current stream; nothing here allocates or syncs.

#include <cuda_runtime.h>
#include <stdint.h>

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
  __shared__ float warp_sums[kThreads / 32];
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
  for (int off = 16; off > 0; off >>= 1)
    f += __shfl_down_sync(0xffffffffu, f, off);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = f;
  __syncthreads();
  if (threadIdx.x < 32) {
    f = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0.0f;
    for (int off = 16; off > 0; off >>= 1)
      f += __shfl_down_sync(0xffffffffu, f, off);
    if (threadIdx.x == 0)
      partials[static_cast<int64_t>(b) * gridDim.x + blockIdx.x] = f;
  }
}

// B1, pass 2: grid (B); out[b] = sum of partials[b, :] / M, summed in double.
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

inline unsigned int num_blocks(int64_t M) {
  return static_cast<unsigned int>((M + kThreads - 1) / kThreads);
}

inline size_t row_bytes(int L, int P) {
  return sizeof(float) * static_cast<size_t>(L) * (P == 2 ? 3 : P + 1);
}

}  // namespace

extern "C" {

const char* uqoc_su2_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

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
  reduce_partials_kernel<<<B, kThreads, 0, s>>>(
      partials, static_cast<int>(grid.x), out, M);
  return cudaGetLastError();
}

}  // extern "C"
