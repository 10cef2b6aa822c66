// SU(4) Monte-Carlo propagation kernels for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of the JAX package:
//   B7  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py:_prop_kernel
//       -> propagate_su4_kernel: per-sample product U_L ... U_1 as (re, im),
//          each (B, M, 4, 4).
//   B6  universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py:_fid_kernel
//       -> mean_fid_su4_kernel + reduce_partials_kernel: per-target mean
//          entanglement fidelity F = (|Tr(U^H T)|^2 + 4) / 20, (B,).
//
// Math (as core/su4.py and the TPU kernel's _segment_body): per segment,
// A = -i H tau / 2^s is built from the sparse H (four real diagonal energies
// +-(d1 +- d2)/2 +- J and the couplings G1 = amp e1, G2 = amp e2, with
// amp = (1 + eps)/2 * max(Omega, 0) and the drive envelopes
// e1 = e^{-i phi1} + chi e^{-i phi2}, e2 = chi e^{-i phi1} + e^{-i phi2}
// (drive2), or e1 = e^{-i phi}, e2 = chi e^{-i phi}); then
// exp(A) = P + A^4 Q with the order-8 Paterson-Stockmeyer cubics P and Q in
// A, A^2, A^3, then s squarings, then W <- exp(A) W.
//
// What bounds them on an H100: arithmetic.  Each (target b, sample m) is an
// independent chain of L dependent segments of 3377 flops at s = 4 (see
// compose(): A's zeros and the (anti-)Hermitian powers A^2, A^3, A^4 are
// taken as such; the s squarings, A^4 Q and the W update are dense complex
// 4x4 products, 480 flops each); a sample reads 12 bytes (d1, d2, eps) and
// writes 128 bytes (B7) or nothing but a block partial (B6).  That is
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
// Reduction (B6): common.cuh's deterministic two passes.  No atomics.
//
// Interface: extern "C" launchers returning cudaError_t (the launch status
// from cudaGetLastError), loaded with ctypes.  The caller owns every buffer
// and passes PyTorch's current stream; nothing here allocates or syncs.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kRowFloats = 6;  // e1r, e1i, e2r, e2i, max(Omega, 0), tau / 2^s

// Taylor coefficients 1/k!, k = 0..8 (c1 = 1 is not multiplied)
constexpr float kC0 = 1.0f, kC2 = 0.5f, kC3 = 1.0f / 6.0f,
                kC4 = 1.0f / 24.0f, kC5 = 1.0f / 120.0f, kC6 = 1.0f / 720.0f,
                kC7 = 1.0f / 5040.0f, kC8 = 1.0f / 40320.0f;

// A complex 4x4 matrix, row-major: entry (i, j) at 4 i + j.
struct Mat {
  float re[16], im[16];
};

// A Hermitian or anti-Hermitian 4x4 matrix by its upper triangle: d[i] is
// the diagonal's real part (Hermitian) or imaginary part (anti-Hermitian),
// the other part being zero; re[p], im[p] is entry (i, j), i < j, at
// p = pair_index(i, j) in the order (0,1) (0,2) (0,3) (1,2) (1,3) (2,3).
struct Tri {
  float d[4], re[6], im[6];
};

__host__ __device__ constexpr int pair_index(int i, int j) {
  return i * (7 - i) / 2 + j - i - 1;
}

// The inverse of pair_index: row and column of pair p.
__host__ __device__ constexpr int pair_i(int p) { return p < 3 ? 0 : (p < 5 ? 1 : 2); }
__host__ __device__ constexpr int pair_j(int p) { return p < 3 ? p + 1 : (p < 5 ? p - 1 : 3); }

// Entry (i, k), i != k, of a Hermitian (kHerm) or anti-Hermitian Tri: the
// lower triangle is conj(upper) or -conj(upper).
template <bool kHerm>
__device__ __forceinline__ void off(const Tri& t, int i, int k, float& re, float& im) {
  if (i < k) {
    re = t.re[pair_index(i, k)];
    im = t.im[pair_index(i, k)];
  } else if (kHerm) {
    re = t.re[pair_index(k, i)];
    im = -t.im[pair_index(k, i)];
  } else {
    re = -t.re[pair_index(k, i)];
    im = t.im[pair_index(k, i)];
  }
}

// (re, im) += (ar + i ai)(br + i bi): 8 flops.
__device__ __forceinline__ void cmac(float ar, float ai, float br, float bi,
                                     float& re, float& im) {
  re = fmaf(ar, br, re);
  re = fmaf(-ai, bi, re);
  im = fmaf(ar, bi, im);
  im = fmaf(ai, br, im);
}

__device__ __forceinline__ Mat identity() {
  Mat m;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    m.re[e] = (e % 5 == 0) ? 1.0f : 0.0f;
    m.im[e] = 0.0f;
  }
  return m;
}

// a b, dense: 480 flops (each entry 2 products, 14 FMAs).
__device__ __forceinline__ Mat matmul(const Mat& a, const Mat& b) {
  Mat c;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float re = a.re[4 * i] * b.re[j];
      re = fmaf(-a.im[4 * i], b.im[j], re);
      float im = a.re[4 * i] * b.im[j];
      im = fmaf(a.im[4 * i], b.re[j], im);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        cmac(a.re[4 * i + k], a.im[4 * i + k], b.re[4 * k + j], b.im[4 * k + j], re, im);
      c.re[4 * i + j] = re;
      c.im[4 * i + j] = im;
    }
  return c;
}

// Shared-memory row of the block's target, structure of arrays over L:
//   [0, L) e1r  [L, 2L) e1i  [2L, 3L) e2r  [3L, 4L) e2i
//   [4L, 5L) max(Omega, 0) (1 at P = 2)  [5L, 6L) tau / 2^s
// Pulse channels are (phi, tau), (phi, Omega, tau) or, drive2,
// (phi1, phi2, Omega, tau).
template <int P>
__device__ __forceinline__ void stage_row(const float* __restrict__ pulses,
                                          int b, int L, float xtalk,
                                          float tau_scale, float* row) {
  const float* src = pulses + static_cast<int64_t>(b) * L * P;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    float s1, c1;
    sincosf(src[k * P], &s1, &c1);
    float e1r, e1i, e2r, e2i, om;
    if (P == 4) {
      float s2, c2;
      sincosf(src[k * P + 1], &s2, &c2);
      e1r = c1 + xtalk * c2;
      e1i = -(s1 + xtalk * s2);
      e2r = xtalk * c1 + c2;
      e2i = -(xtalk * s1 + s2);
      om = fmaxf(src[k * P + 2], 0.0f);
    } else {
      e1r = c1;
      e1i = -s1;
      e2r = xtalk * c1;
      e2i = -(xtalk * s1);
      om = (P == 3) ? fmaxf(src[k * P + 1], 0.0f) : 1.0f;
    }
    row[k] = e1r;
    row[L + k] = e1i;
    row[2 * L + k] = e2r;
    row[3 * L + k] = e2i;
    row[4 * L + k] = om;
    row[5 * L + k] = src[k * P + P - 1] * tau_scale;
  }
}

// Compose the L segments of one sample, left to right: W <- exp(A_k) W.
// A = -i H t is anti-Hermitian and sparse: imaginary diagonal a = -h t, the
// coupling x2 = -i G2 t on the qubit-2 pairs (0,1), (2,3), x1 = -i G1 t on
// the qubit-1 pairs (0,2), (1,3), zero on (0,3), (1,2); column j is non-zero
// in rows j, j^1 (x2) and j^2 (x1).  A^2 and A^4 are Hermitian and A^3
// anti-Hermitian, so each is formed as an upper triangle and only the
// products that are not zero are taken.  Flops per segment (FMA = 2):
// 10 (A), 37 (A^2, closed form), 128 (A^3 = A^2 A), 166 (A^4 = A^2 A^2),
// 188 (P and Q, dense), 448 (P + A^4 Q), 480 per squaring and 480 (W):
// 3377 at s = 4.  Per sample 10 (the energies and (1 + eps)/2).
__device__ __forceinline__ Mat compose(const float* row, int L, float d1,
                                       float d2, float eps, float coupling,
                                       int scaling) {
  const float sum = 0.5f * (d1 + d2), diff = 0.5f * (d1 - d2);
  // diagonal of H: (d1 z1 + d2 z2)/2 + J z1 z2 on |00>, |01>, |10>, |11>
  const float h[4] = {sum + coupling, diff - coupling, -diff - coupling,
                      -sum + coupling};
  const float half = 0.5f * (1.0f + eps);
  Mat W = identity();
  for (int k = 0; k < L; ++k) {
    const float t = row[5 * L + k];
    const float amp_t = half * row[4 * L + k] * t;
    // G t: G2 on the qubit-2 pairs, G1 on the qubit-1 pairs (H's upper
    // couplings; the lower ones are conj(G))
    const float g1r = row[k] * amp_t, g1i = row[L + k] * amp_t;
    const float g2r = row[2 * L + k] * amp_t, g2i = row[3 * L + k] * amp_t;
    Tri A;  // entries (0,3) and (1,2) are zero and never read
#pragma unroll
    for (int d = 0; d < 4; ++d) A.d[d] = -h[d] * t;
    A.re[pair_index(0, 1)] = A.re[pair_index(2, 3)] = g2i;
    A.im[pair_index(0, 1)] = A.im[pair_index(2, 3)] = -g2r;
    A.re[pair_index(0, 2)] = A.re[pair_index(1, 3)] = g1i;
    A.im[pair_index(0, 2)] = A.im[pair_index(1, 3)] = -g1r;

    // A^2 = -(H t)^2: diagonal -(a_d^2 + |x1|^2 + |x2|^2); on a coupled
    // pair (i, j), i (a_i + a_j) x; (0,3) = 2 x1 x2, (1,2) = -2 conj(x2) x1
    Tri A2;
    const float nn = fmaf(-g1r, g1r, fmaf(-g1i, g1i, fmaf(-g2r, g2r, -g2i * g2i)));
#pragma unroll
    for (int d = 0; d < 4; ++d) A2.d[d] = fmaf(-A.d[d], A.d[d], nn);
    {
      const float s01 = A.d[0] + A.d[1], s23 = A.d[2] + A.d[3];
      const float s02 = A.d[0] + A.d[2], s13 = A.d[1] + A.d[3];
      A2.re[pair_index(0, 1)] = s01 * g2r;
      A2.im[pair_index(0, 1)] = s01 * g2i;
      A2.re[pair_index(2, 3)] = s23 * g2r;
      A2.im[pair_index(2, 3)] = s23 * g2i;
      A2.re[pair_index(0, 2)] = s02 * g1r;
      A2.im[pair_index(0, 2)] = s02 * g1i;
      A2.re[pair_index(1, 3)] = s13 * g1r;
      A2.im[pair_index(1, 3)] = s13 * g1i;
      const float u1r = 2.0f * g1r, u1i = 2.0f * g1i;
      const float rr = u1r * g2r, ii = u1i * g2i, ri = u1r * g2i, ir = u1i * g2r;
      A2.re[pair_index(0, 3)] = ii - rr;
      A2.im[pair_index(0, 3)] = -(ir + ri);
      A2.re[pair_index(1, 2)] = -(ii + rr);
      A2.im[pair_index(1, 2)] = ri - ir;
    }

    // A^3 = A^2 A (anti-Hermitian): sum over the rows k of A's column j
    Tri A3;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // diagonal: imaginary part only
      float im = A2.d[j] * A.d[j];
#pragma unroll
      for (int q = 1; q <= 2; ++q) {
        float ar, ai, br, bi;
        off<true>(A2, j, j ^ q, ar, ai);
        off<false>(A, j ^ q, j, br, bi);
        im = fmaf(ar, bi, im);
        im = fmaf(ai, br, im);
      }
      A3.d[j] = im;
    }
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int i = pair_i(p), j = pair_j(p);
      float wr, wi;
      off<true>(A2, i, j, wr, wi);
      float re = -A.d[j] * wi, im = A.d[j] * wr;  // A^2(i, j) (i a_j)
#pragma unroll
      for (int q = 1; q <= 2; ++q) {
        const int k = j ^ q;
        float br, bi;
        off<false>(A, k, j, br, bi);
        if (k == i) {  // A^2(i, i) is real
          re = fmaf(A2.d[i], br, re);
          im = fmaf(A2.d[i], bi, im);
        } else {
          float ar, ai;
          off<true>(A2, i, k, ar, ai);
          cmac(ar, ai, br, bi, re, im);
        }
      }
      A3.re[p] = re;
      A3.im[p] = im;
    }

    // A^4 = A^2 A^2 (Hermitian)
    Tri A4;
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // diagonal: sum of |A^2(j, k)|^2
      float d = A2.d[j] * A2.d[j];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k == j) continue;
        float ar, ai;
        off<true>(A2, j, k, ar, ai);
        d = fmaf(ar, ar, d);
        d = fmaf(ai, ai, d);
      }
      A4.d[j] = d;
    }
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int i = pair_i(p), j = pair_j(p);
      float wr, wi;
      off<true>(A2, i, j, wr, wi);
      const float s = A2.d[i] + A2.d[j];
      float re = s * wr, im = s * wi;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k == i || k == j) continue;
        float ar, ai, br, bi;
        off<true>(A2, i, k, ar, ai);
        off<true>(A2, k, j, br, bi);
        cmac(ar, ai, br, bi, re, im);
      }
      A4.re[p] = re;
      A4.im[p] = im;
    }

    // P = c0 I + c1 A + c2 A^2 + c3 A^3 and Q = c4 I + ... + c8 A^4, each
    // a Hermitian part h plus an anti-Hermitian part s: (i, j) = h + s,
    // (j, i) = conj(h - s); c1 = 1
    Mat Pm, Qm;
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      Pm.re[5 * d] = fmaf(kC2, A2.d[d], kC0);
      Pm.im[5 * d] = fmaf(kC3, A3.d[d], A.d[d]);
      Qm.re[5 * d] = fmaf(kC8, A4.d[d], fmaf(kC6, A2.d[d], kC4));
      Qm.im[5 * d] = fmaf(kC7, A3.d[d], kC5 * A.d[d]);
    }
#pragma unroll
    for (int p = 0; p < 6; ++p) {
      const int i = pair_i(p), j = pair_j(p);
      const bool coupled = p != pair_index(0, 3) && p != pair_index(1, 2);
      const float hpr = kC2 * A2.re[p], hpi = kC2 * A2.im[p];
      const float spr = coupled ? fmaf(kC3, A3.re[p], A.re[p]) : kC3 * A3.re[p];
      const float spi = coupled ? fmaf(kC3, A3.im[p], A.im[p]) : kC3 * A3.im[p];
      const float hqr = fmaf(kC8, A4.re[p], kC6 * A2.re[p]);
      const float hqi = fmaf(kC8, A4.im[p], kC6 * A2.im[p]);
      const float sqr = coupled ? fmaf(kC7, A3.re[p], kC5 * A.re[p]) : kC7 * A3.re[p];
      const float sqi = coupled ? fmaf(kC7, A3.im[p], kC5 * A.im[p]) : kC7 * A3.im[p];
      Pm.re[4 * i + j] = hpr + spr;
      Pm.im[4 * i + j] = hpi + spi;
      Pm.re[4 * j + i] = hpr - spr;
      Pm.im[4 * j + i] = spi - hpi;
      Qm.re[4 * i + j] = hqr + sqr;
      Qm.im[4 * i + j] = hqi + sqi;
      Qm.re[4 * j + i] = hqr - sqr;
      Qm.im[4 * j + i] = sqi - hqi;
    }

    // exp(A) ~ P + A^4 Q (A^4's diagonal is real)
    Mat U;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float re = fmaf(A4.d[i], Qm.re[4 * i + j], Pm.re[4 * i + j]);
        float im = fmaf(A4.d[i], Qm.im[4 * i + j], Pm.im[4 * i + j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (k == i) continue;
          float ar, ai;
          off<true>(A4, i, k, ar, ai);
          cmac(ar, ai, Qm.re[4 * k + j], Qm.im[4 * k + j], re, im);
        }
        U.re[4 * i + j] = re;
        U.im[4 * i + j] = im;
      }
    for (int s = 0; s < scaling; ++s) U = matmul(U, U);
    W = matmul(U, W);
  }
  return W;
}

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
  stage_row<P>(pulses, b, L, xtalk, tau_scale, row);
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (m >= M) return;
  const int64_t i = static_cast<int64_t>(b) * M + m;
  const Mat W = compose(row, L, d1[i], d2[i], eps[i], coupling, scaling);
  float4* re = reinterpret_cast<float4*>(out_re) + 4 * i;
  float4* im = reinterpret_cast<float4*>(out_im) + 4 * i;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    re[r] = make_float4(W.re[4 * r], W.re[4 * r + 1], W.re[4 * r + 2], W.re[4 * r + 3]);
    im[r] = make_float4(W.im[4 * r], W.im[4 * r + 1], W.im[4 * r + 2], W.im[4 * r + 3]);
  }
}

// B6, pass 1: grid (ceil(M / kThreads), B); partials is (B, gridDim.x), each
// entry the sum of F over one block's samples.  F per sample: Tr(U^H T) in
// 64 FMAs, then (|Tr|^2 + 4) / 20: 134 flops.
template <int P>
__global__ void __launch_bounds__(kThreads)
mean_fid_su4_kernel(const float* __restrict__ pulses,
                    const float* __restrict__ t_re,
                    const float* __restrict__ t_im,
                    const float* __restrict__ d1, const float* __restrict__ d2,
                    const float* __restrict__ eps,
                    float* __restrict__ partials, int L, int64_t M, float xtalk,
                    float coupling, int scaling, float tau_scale) {
  extern __shared__ float row[];
  __shared__ float target[32];
  const int b = blockIdx.y;
  stage_row<P>(pulses, b, L, xtalk, tau_scale, row);
  if (threadIdx.x < 16) {
    target[threadIdx.x] = t_re[16 * b + threadIdx.x];
    target[16 + threadIdx.x] = t_im[16 * b + threadIdx.x];
  }
  __syncthreads();
  const int64_t m = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  float f = 0.0f;
  if (m < M) {
    const int64_t i = static_cast<int64_t>(b) * M + m;
    const Mat W = compose(row, L, d1[i], d2[i], eps[i], coupling, scaling);
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

cudaError_t uqoc_su4_mean_fidelity(const float* pulses, const float* t_re,
                                   const float* t_im, const float* d1,
                                   const float* d2, const float* eps,
                                   float* partials, float* out, int B, int L,
                                   int P, int64_t M, float xtalk,
                                   float coupling, int scaling, void* stream) {
  const dim3 grid(num_blocks(M), B);
  const size_t smem = row_bytes(L);
  const float tau_scale = std::ldexp(1.0f, -scaling);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (P) {
    case 2:
      mean_fid_su4_kernel<2><<<grid, kThreads, smem, s>>>(
          pulses, t_re, t_im, d1, d2, eps, partials, L, M, xtalk, coupling,
          scaling, tau_scale);
      break;
    case 3:
      mean_fid_su4_kernel<3><<<grid, kThreads, smem, s>>>(
          pulses, t_re, t_im, d1, d2, eps, partials, L, M, xtalk, coupling,
          scaling, tau_scale);
      break;
    case 4:
      mean_fid_su4_kernel<4><<<grid, kThreads, smem, s>>>(
          pulses, t_re, t_im, d1, d2, eps, partials, L, M, xtalk, coupling,
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

}  // extern "C"
