// SU(2) Monte-Carlo propagation kernels for Hopper (sm_90a).
//
// Replaces three Pallas TPU kernels of the JAX package:
//   B3  universal_quantum_optimal_control_tpu/ops/propagate_pallas.py:_prop_kernel
//       -> propagate_mc_kernel: per-sample product quaternion, (B, M, 4).
//   B1  universal_quantum_optimal_control_tpu/ops/propagate_pallas.py:_fid_kernel
//       -> mean_fid_kernel: per-target mean entanglement fidelity
//          F = (4<q, q_t>^2 + 2) / 6, (B,).
//   B2  universal_quantum_optimal_control_tpu/ops/propagate_pallas_bwd.py:_bwd_kernel
//       -> propagate_mc_vjp_kernel: the VJP of B3, from B3's product.
//
// What bounds them on an H100: issued instructions.  Each (target b, sample
// m) is an independent chain of L dependent segments; per sample the kernels
// read 8 to 40 bytes and write 0 to 16, against ~55 (B1, B3) or ~110 (B2)
// flops per segment times L, far right of the ridge point.  The f32 rate
// (67 TFLOP/s) counts an FMA per lane and clock; the kernels' segment is
// not all FMAs, so the instructions per segment set the pace, not the flops.
//
// What the design does about it (the per-sample math, its instruction
// budget and the sign of a segment are in su2.cuh):
//   * one thread per (b, m) sample, the running product in registers for
//     the whole loop; the target's pulse row staged once per block into
//     shared memory as 16-byte records (one broadcast LDS.128 a segment),
//     with cos phi, sin phi there, padded to a multiple of su2::kChunk; at
//     P = 2 B1 and B3 take two segments a product (su2::pair2);
//   * the polynomial sincos where every angle of the sample is within its
//     range, |x| <= pi / 2 (a bound from the row's max |tau|, read once per
//     sample), libm's sincosf otherwise: no per-segment branch;
//   * B2 reads B3's product instead of rebuilding it, sweeps with two
//     Hamilton products a segment, and sums its pulse cotangents over a
//     warp a chunk of segments at a time (su2::reduce_scatter: no shuffle
//     chain per segment) into the warp's slot of a shared [warps][Lp * P]
//     buffer, in blocks of 64 threads;
//   * B1's sum over blocks runs inside its launch: the block that draws a
//     target's last ticket sums the target's block partials in double, in
//     block order (common.cuh), so it stays the same from run to run.  B2
//     keeps its second kernel: inside the launch (the last block summing 16
//     rows of L P columns on 64 threads) it ran 3 % slower (PERF.md);
//   * no TPU padding: M need not be a multiple of anything; threads past M
//     are masked (B2: they carry g = 0, which adds exactly 0 to every sum,
//     and stay in the warp's exchanges);
//   * a row longer than 48 KB of shared memory allows: every launcher opts
//     in to more (up to the card's limit, uqoc_su2_max_len), and reports
//     the card's refusal past it.
//
// The Omega cotangent is gated on Omega_raw > 0 as the TPU kernel gates it;
// the staged max(Omega_raw, 0) is > 0 exactly when Omega_raw is.  The axis
// norm's square is floored at 1e-24, as the plain version floors it
// (core/su2.py::_axis_norm): where Omega <= 0 and Delta + delta = 0 exactly,
// which f32 draws do reach, the derivative along z is then the finite limit
// tau (1 + eps) / 2 of the closed form.
//
// Interface: extern "C" launchers returning cudaError_t (the launch status
// from cudaGetLastError), loaded with ctypes.  The caller owns every buffer
// (the block partials, and B1's per-target ticket counters, which it zeroes
// once and each launch leaves at zero) and passes PyTorch's current stream;
// nothing here allocates or syncs.

#include <cuda_runtime.h>
#include <stdint.h>

#include "common.cuh"
#include "su2.cuh"

namespace {

using su2::Quat;

constexpr int kThreads = 128;    // B1, B3
constexpr int kVjpThreads = 64;  // B2
constexpr int kVjpWarps = kVjpThreads / 32;
// B2 asks ptxas for 1 block an SM, so it takes the registers it wants (63;
// 16 blocks an SM, the training shape's 3200 blocks in 1.5 waves).  Left to
// its default, ptxas chose 48 (20 blocks, 1.2 waves) and B2 ran ~2 %
// slower; capped to one wave (24 blocks, 40 registers), 12 % (PERF.md).
constexpr int kVjpMinBlocks = 1;

// Whether every angle of the sample is within the polynomial sincos's range
// (su2::PolyTrig); else it takes libm's (su2::LibmTrig).
template <int P>
__device__ __forceinline__ bool poly_ok(float t0, float t1, float d, float e) {
  return su2::angle_bound<P>(t0, t1, d, e) <= su2::kPolyMax;
}

inline int padded(int L) { return (L + su2::kChunk - 1) / su2::kChunk * su2::kChunk; }

// Stage the block's target row (su2::stage_unit, padded to Lp) and return
// in every thread the row's max |tau| (t0) and max |tau| sqrt(Omega^2 +
// Delta^2) (t1).  Ends with __syncthreads.
template <int P>
__device__ __forceinline__ void stage_row(const float* __restrict__ pulses, int b, int L,
                                          int Lp, float4* row, float& t0, float& t1) {
  __shared__ unsigned int wmax[kThreads / 32][2];
  const float* src = pulses + static_cast<int64_t>(b) * L * P;
  t0 = 0.0f;
  t1 = 0.0f;
  for (int u = threadIdx.x; u < su2::stage_units<P>(Lp); u += blockDim.x)
    su2::stage_unit<P>(src, L, Lp, u, row, t0, t1);
  // non-negative floats order as their bits
  const unsigned int m0 = __reduce_max_sync(0xffffffffu, __float_as_uint(t0));
  const unsigned int m1 = __reduce_max_sync(0xffffffffu, __float_as_uint(t1));
  if ((threadIdx.x & 31) == 0) {
    wmax[threadIdx.x >> 5][0] = m0;
    wmax[threadIdx.x >> 5][1] = m1;
  }
  __syncthreads();
  for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
    t0 = fmaxf(t0, __uint_as_float(wmax[w][0]));
    t1 = fmaxf(t1, __uint_as_float(wmax[w][1]));
  }
}

template <int P>
__device__ __forceinline__ Quat compose(const float4* row, int Lp, float t0, float t1, float d,
                                        float e) {
  if (poly_ok<P>(t0, t1, d, e)) return su2::compose<P, su2::PolyTrig>(row, Lp, d, e);
  return su2::compose<P, su2::LibmTrig>(row, Lp, d, e);
}

// B3: grid (ceil(M / kThreads), B); out is (B, M, 4).
template <int P>
__global__ void __launch_bounds__(kThreads)
propagate_mc_kernel(const float* __restrict__ pulses, const float* __restrict__ delta,
                    const float* __restrict__ eps, float* __restrict__ out, int L, int Lp,
                    int64_t M) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  float t0, t1;
  stage_row<P>(pulses, b, L, Lp, smem4, t0, t1);
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  const Quat q = compose<P>(smem4, Lp, t0, t1, delta[i], eps[i]);
  reinterpret_cast<float4*>(out)[i] = make_float4(q.w, q.x, q.y, q.z);
}

// B1: grid (ceil(M / kThreads), B); partials is (B, gridDim.x), each entry
// the sum of F over one block's samples; the target's last block writes
// out[b], the mean.
template <int P>
__global__ void __launch_bounds__(kThreads)
mean_fid_kernel(const float* __restrict__ pulses, const float* __restrict__ q_target,
                const float* __restrict__ delta, const float* __restrict__ eps,
                float* __restrict__ partials, unsigned int* __restrict__ tickets,
                float* __restrict__ out, int L, int Lp, int64_t M) {
  extern __shared__ float4 smem4[];
  const int b = blockIdx.y;
  float t0, t1;
  stage_row<P>(pulses, b, L, Lp, smem4, t0, t1);
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float f = 0.0f;
  if (m < M) {
    const int64_t i = static_cast<int64_t>(b) * M + m;
    const Quat q = compose<P>(smem4, Lp, t0, t1, delta[i], eps[i]);
    const float* t = q_target + 4 * b;
    const float inner = fmaf(t[0], q.w, fmaf(t[1], q.x, fmaf(t[2], q.y, t[3] * q.z)));
    f = fmaf(4.0f * inner, inner, 2.0f) / 6.0f;
  }
  f = uqoc::block_sum<kThreads>(f);
  const int64_t row0 = static_cast<int64_t>(b) * gridDim.x;
  if (threadIdx.x == 0) partials[row0 + blockIdx.x] = f;
  if (uqoc::last_block(tickets + b))
    uqoc::mean_of_partials<kThreads>(partials + row0, gridDim.x, out + b, M);
}

// B2, pass 1: grid (ceil(M / kVjpThreads), B); q is B3's product (B, M, 4),
// g its cotangent; partials is (B, gridDim.x, L * P), each entry one
// block's sum over its samples; pass 2 (reduce_columns_kernel) sums them
// into dpulses.
template <int P>
__global__ void __launch_bounds__(kVjpThreads, kVjpMinBlocks)
propagate_mc_vjp_kernel(const float* __restrict__ pulses, const float* __restrict__ delta,
                        const float* __restrict__ eps, const float* __restrict__ g,
                        const float* __restrict__ q, float* __restrict__ partials,
                        float* __restrict__ dpulses,
                        float* __restrict__ ddelta, float* __restrict__ deps, int L, int Lp,
                        int64_t M) {
  extern __shared__ float4 smem4[];
  float* red = reinterpret_cast<float*>(smem4 + su2::row_records<P>(Lp));  // [kVjpWarps][Lp P]
  const int b = blockIdx.y;
  float t0, t1;
  stage_row<P>(pulses, b, L, Lp, smem4, t0, t1);

  const int64_t m = static_cast<int64_t>(blockIdx.x) * kVjpThreads + threadIdx.x;
  const bool active = m < M;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  float d = 0.0f, e = 0.0f;
  Quat Q = {1.0f, 0.0f, 0.0f, 0.0f}, G = {0.0f, 0.0f, 0.0f, 0.0f};
  if (active) {
    d = delta[i];
    e = eps[i];
    const float4 qi = reinterpret_cast<const float4*>(q)[i];
    const float4 gi = reinterpret_cast<const float4*>(g)[i];
    Q = {qi.x, qi.y, qi.z, qi.w};
    G = {gi.x, gi.y, gi.z, gi.w};
  }
  const int lp = Lp * P;
  const su2::WarpSink<P> sink{red + (threadIdx.x >> 5) * lp};
  float dd, de;
  // the sincos is chosen per warp, libm's where any lane needs it: the
  // sweep's exchanges need the whole warp
  if (__all_sync(0xffffffffu, poly_ok<P>(t0, t1, d, e)))
    su2::sweep<P, su2::PolyTrig>(smem4, Lp, d, e, Q, G, dd, de, sink);
  else
    su2::sweep<P, su2::LibmTrig>(smem4, Lp, d, e, Q, G, dd, de, sink);
  if (active) {
    ddelta[i] = dd;
    deps[i] = de;
  }

  __syncthreads();
  const int n_out = L * P;
  float* target = partials + static_cast<int64_t>(b) * gridDim.x * n_out;
  float* mine = target + static_cast<int64_t>(blockIdx.x) * n_out;
  for (int j = threadIdx.x; j < n_out; j += kVjpThreads) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kVjpWarps; ++w) s += red[w * lp + j];
    mine[j] = s;
  }
}

inline unsigned int num_blocks(int64_t M, int threads) {
  return static_cast<unsigned int>((M + threads - 1) / threads);
}

// Shared memory a segment of the padded row takes: the staged records (B1,
// B3: 16 bytes each, su2::row_records), and B2's [warps][Lp * P] buffer.
inline size_t segment_bytes(int kernel, int P) {
  const size_t rec = sizeof(float4) * (P == 2 ? 3 : 4) / 2;
  return rec + (kernel == 2 ? sizeof(float) * kVjpWarps * P : 0);
}
inline size_t row_bytes(int L, int P) { return segment_bytes(1, P) * padded(L); }
inline size_t vjp_smem_bytes(int L, int P) { return segment_bytes(2, P) * padded(L); }

// Past the 48 KB a launch gets by default, ask for smem (refused past the
// card's opt-in limit, 227 KB on sm_90, less the kernel's static buffers).
template <class K>
cudaError_t opt_in(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) cudaGetLastError();  // clear it, so no later launch reports it
  return err;
}

template <int P>
cudaError_t launch_propagate_mc(dim3 grid, size_t smem, cudaStream_t s, const float* pulses,
                                const float* delta, const float* eps, float* out, int L,
                                int64_t M) {
  const cudaError_t err = opt_in(propagate_mc_kernel<P>, smem);
  if (err != cudaSuccess) return err;
  propagate_mc_kernel<P><<<grid, kThreads, smem, s>>>(pulses, delta, eps, out, L, padded(L), M);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_mean_fid(dim3 grid, size_t smem, cudaStream_t s, const float* pulses,
                            const float* q_target, const float* delta, const float* eps,
                            float* partials, unsigned int* tickets, float* out, int L,
                            int64_t M) {
  const cudaError_t err = opt_in(mean_fid_kernel<P>, smem);
  if (err != cudaSuccess) return err;
  mean_fid_kernel<P><<<grid, kThreads, smem, s>>>(pulses, q_target, delta, eps, partials,
                                                  tickets, out, L, padded(L), M);
  return cudaGetLastError();
}

template <int P>
cudaError_t launch_vjp(dim3 grid, size_t smem, cudaStream_t s, const float* pulses,
                       const float* delta, const float* eps, const float* g, const float* q,
                       float* partials, float* dpulses, float* ddelta,
                       float* deps, int L, int64_t M) {
  {
    const cudaError_t err = opt_in(propagate_mc_vjp_kernel<P>, smem);
    if (err != cudaSuccess) return err;
  }
  propagate_mc_vjp_kernel<P><<<grid, kVjpThreads, smem, s>>>(
      pulses, delta, eps, g, q, partials, dpulses, ddelta, deps, L, padded(L), M);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int lp = L * P;
  const dim3 grid2((lp + kThreads - 1) / kThreads, grid.y);
  uqoc::reduce_columns_kernel<kThreads><<<grid2, kThreads, 0, s>>>(partials, grid.x, lp, dpulses);
  return cudaGetLastError();
}

template <class K>
int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

// The longest L whose launch of kernel 1 (B1), 2 (B2) or 3 (B3) the current
// card takes: its opt-in shared memory per block less the kernel's static
// buffers, over segment_bytes, in whole chunks; or minus the CUDA error.
template <class K>
int max_len(K kernel, int which, int P) {
  int dev = 0, optin = 0;
  cudaFuncAttributes attr;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const size_t avail = static_cast<size_t>(optin) - attr.sharedSizeBytes;
  return static_cast<int>(avail / segment_bytes(which, P)) / su2::kChunk * su2::kChunk;
}

template <int P>
int max_len_p(int kernel) {
  switch (kernel) {
    case 1:
      return max_len(mean_fid_kernel<P>, 1, P);
    case 2:
      return max_len(propagate_mc_vjp_kernel<P>, 2, P);
    case 3:
      return max_len(propagate_mc_kernel<P>, 3, P);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

template <int P>
int blocks_per_sm_p(int kernel, int L) {
  switch (kernel) {
    case 1:
      return blocks_per_sm(mean_fid_kernel<P>, kThreads, row_bytes(L, P));
    case 2:
      return blocks_per_sm(propagate_mc_vjp_kernel<P>, kVjpThreads, vjp_smem_bytes(L, P));
    case 3:
      return blocks_per_sm(propagate_mc_kernel<P>, kThreads, row_bytes(L, P));
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Blocks per target of B1 and B3, and of B2; the caller sizes the partials
// (B, n) and (B, n, L * P).
int uqoc_su2_num_blocks(int64_t M) { return static_cast<int>(num_blocks(M, kThreads)); }
int uqoc_su2_vjp_num_blocks(int64_t M) { return static_cast<int>(num_blocks(M, kVjpThreads)); }

// Threads per block of kernel 1 (B1), 2 (B2) or 3 (B3).
int uqoc_su2_threads(int kernel) { return kernel == 2 ? kVjpThreads : kThreads; }

// Resident blocks per SM of kernel 1 (B1), 2 (B2) or 3 (B3) at (P, L)
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), or minus the CUDA error.
int uqoc_su2_blocks_per_sm(int kernel, int P, int L) {
  switch (P) {
    case 2:
      return blocks_per_sm_p<2>(kernel, L);
    case 3:
      return blocks_per_sm_p<3>(kernel, L);
    case 4:
      return blocks_per_sm_p<4>(kernel, L);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shared memory of B2's launch at (L, P); above 48 KB the launcher opts in.
int64_t uqoc_su2_vjp_smem_bytes(int L, int P) {
  return static_cast<int64_t>(vjp_smem_bytes(L, P));
}

// The longest L of kernel 1 (B1), 2 (B2) or 3 (B3) at P that the current
// card takes, or minus the CUDA error.
int uqoc_su2_max_len(int kernel, int P) {
  switch (P) {
    case 2:
      return max_len_p<2>(kernel);
    case 3:
      return max_len_p<3>(kernel);
    case 4:
      return max_len_p<4>(kernel);
    default:
      return -static_cast<int>(cudaErrorInvalidValue);
  }
}

// The largest |x| the polynomial sincos takes; past it, libm's sincosf.
float uqoc_su2_poly_max() { return su2::kPolyMax; }

// pulses (B, L, P), delta / eps (B, M), out (B, M, 4); all f32, contiguous.
cudaError_t uqoc_su2_propagate_mc(const float* pulses, const float* delta,
                                  const float* eps, float* out, int B, int L,
                                  int P, int64_t M, void* stream) {
  const dim3 grid(num_blocks(M, kThreads), B);
  const size_t smem = row_bytes(L, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2:
      return launch_propagate_mc<2>(grid, smem, s, pulses, delta, eps, out, L, M);
    case 3:
      return launch_propagate_mc<3>(grid, smem, s, pulses, delta, eps, out, L, M);
    case 4:
      return launch_propagate_mc<4>(grid, smem, s, pulses, delta, eps, out, L, M);
    default:
      return cudaErrorInvalidValue;
  }
}

// pulses (B, L, P), q_target (B, 4), delta / eps (B, M), partials
// (B, uqoc_su2_num_blocks(M)) scratch, tickets (B) zero, out (B,); all f32
// but tickets (u32), contiguous.
cudaError_t uqoc_su2_mean_fidelity(const float* pulses, const float* q_target,
                                   const float* delta, const float* eps, float* partials,
                                   unsigned int* tickets, float* out, int B, int L, int P,
                                   int64_t M, void* stream) {
  const dim3 grid(num_blocks(M, kThreads), B);
  const size_t smem = row_bytes(L, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2:
      return launch_mean_fid<2>(grid, smem, s, pulses, q_target, delta, eps, partials, tickets,
                                out, L, M);
    case 3:
      return launch_mean_fid<3>(grid, smem, s, pulses, q_target, delta, eps, partials, tickets,
                                out, L, M);
    case 4:
      return launch_mean_fid<4>(grid, smem, s, pulses, q_target, delta, eps, partials, tickets,
                                out, L, M);
    default:
      return cudaErrorInvalidValue;
  }
}

// pulses (B, L, P), delta / eps (B, M), g and q (B, M, 4), partials
// (B, uqoc_su2_vjp_num_blocks(M), L * P) scratch, dpulses (B, L, P), ddelta /
// deps (B, M); all f32, contiguous.
cudaError_t uqoc_su2_propagate_mc_vjp(const float* pulses, const float* delta,
                                      const float* eps, const float* g, const float* q,
                                      float* partials, float* dpulses,
                                      float* ddelta, float* deps, int B, int L, int P,
                                      int64_t M, void* stream) {
  const dim3 grid(num_blocks(M, kVjpThreads), B);
  const size_t smem = vjp_smem_bytes(L, P);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2:
      return launch_vjp<2>(grid, smem, s, pulses, delta, eps, g, q, partials, dpulses,
                           ddelta, deps, L, M);
    case 3:
      return launch_vjp<3>(grid, smem, s, pulses, delta, eps, g, q, partials, dpulses,
                           ddelta, deps, L, M);
    case 4:
      return launch_vjp<4>(grid, smem, s, pulses, delta, eps, g, q, partials, dpulses,
                           ddelta, deps, L, M);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
