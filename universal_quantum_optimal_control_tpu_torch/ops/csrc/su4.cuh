// SU(4) per-sample math shared by propagate_su4.cu (B4, B6, B7) and
// propagate_su4_bwd.cu (B5, B8).  The kernels replace the Pallas TPU kernels
// of universal_quantum_optimal_control_tpu/ops/propagate_su4_pallas.py
// (_prop_kernel: B7, _fid_kernel: B6, _fid_prod_kernel: B4) and
// propagate_su4_pallas_bwd.py (_bwd_prod_kernel: B5, _bwd_kernel: B8).
//
// Math (as core/su4.py and the TPU kernels' _segment_body): per segment,
// A = -i H tau / 2^s is built from the sparse H (four real diagonal energies
// +-(d1 +- d2)/2 +- J and the couplings G1 = amp e1, G2 = amp e2, with
// amp = (1 + eps)/2 * max(Omega, 0) and the drive envelopes
// e1 = e^{-i phi1} + chi e^{-i phi2}, e2 = chi e^{-i phi1} + e^{-i phi2}
// (drive2), or e1 = e^{-i phi}, e2 = chi e^{-i phi}); then
// exp(A) = P + A^4 Q with the order-8 Paterson-Stockmeyer cubics P and Q in
// A, A^2, A^3, then s squarings, all carried as exp(A) - I (see t8m1).
//
// What bounds the kernels on an H100: f32 arithmetic.  A sample is a chain
// of L dependent segments of 3661 flops (B4, B6, B7) or 12264-12274 (B5)
// against 12-140 bytes read; thousands of flops per byte.
//
// Ways to run a sample:
//   * one thread per sample (compose(), seed(), reverse_sweep()): B4, B6,
//     B5, B8 and B7 where a launch fills the card;
//   * a lane group (compose_lane(), seed_lane(), reverse_sweep_lane()): G
//     lanes of one warp per sample, B4, B6, B5 and B8 where a launch of one
//     thread per sample would leave the card's warp schedulers under 1.5
//     warps each (common.cuh, lane_groups_pay);
//   * B7 only: a sample's segments split into K chunks, one thread each,
//     combined in a tree (compose_chunk(), combine_chunks()), under a plan
//     per launch (prop_plan).
//
// What held one thread per sample back.  B5 takes 255 registers, so at
// most two 128-thread blocks fit on an SM; at the per-gate polish's shape
// (5 targets x 4096 samples) that is 640 warps on the card's 528 warp
// schedulers, about one warp per scheduler, and a warp cannot hide its own
// dependent FMAs nor the per-segment stash of V and S_0 in shared memory.
// Both kernels took the same time at the training shape (32 x 1024 samples,
// 1.9 warps per scheduler) as at the polish shape with 62 % of the samples
// (B5 0.9601 / 1.0020 ms, B4 0.2761 / 0.2815 ms; NVIDIA H100 80GB HBM3,
// 700 W): 37 % (B5) and 40 % (B4) of the arithmetic bound at the polish
// shape.  G lanes per sample give G times the warps at 1/G of the dense
// work and fewer registers per lane.  They cost instructions: the segment's
// powers, P and Q are built by every lane (marked Repeated, not part of the
// bound), and every exchange is a put and gets through shared memory, so
// where one thread per sample already fills the schedulers it stays ahead.
//
// A lane holds 4 / G columns of each dense 4x4 complex matrix, in its own
// frame (see Lane): a left product by a sparse (anti-)Hermitian power, which
// every lane builds from the staged row, is lane-local; a right product,
// and a dense x dense one, takes the other lanes' columns from an exchange
// area in shared memory (put, group_sync, get): 128-bit stores and loads,
// conflict-free (see part).  tests/test_torch_su4_host.py counts the flops
// of both ways on a host build of this file: the lanes' shares plus the
// repeated work once are the bound's counts.
//
// The host build (tests/test_torch_su4_host.py, g++ -std=c++20 -pthread)
// defines the CUDA qualifiers away and supplies the group hook itself: the
// G lanes run as std::threads that meet at a std::barrier.

#pragma once

namespace su4 {

// Taylor coefficients 1/k!, k = 2..8 (c0 = c1 = 1 are not multiplied)
constexpr float kC2 = 0.5f, kC3 = 1.0f / 6.0f,
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

// x times kSign = +-1 (a negation, free in an FMA).
template <int kSign>
__device__ __forceinline__ float sgn(float x) {
  if constexpr (kSign > 0) {
    return x;
  } else {
    return -x;
  }
}

// (re, im) += kSign (ar + i ai)(br + i bi): 8 flops.
template <int kSign>
__device__ __forceinline__ void cmac_s(float ar, float ai, float br, float bi,
                                       float& re, float& im) {
  cmac(sgn<kSign>(ar), sgn<kSign>(ai), br, bi, re, im);
}

// (re, im) += conj(ar + i ai)(br + i bi): 8 flops.
__device__ __forceinline__ void cmac_ca(float ar, float ai, float br, float bi,
                                        float& re, float& im) {
  re = fmaf(ar, br, re);
  re = fmaf(ai, bi, re);
  im = fmaf(ar, bi, im);
  im = fmaf(-ai, br, im);
}

// (re, im) += (ar + i ai) conj(br + i bi): 8 flops.
__device__ __forceinline__ void cmac_cb(float ar, float ai, float br, float bi,
                                        float& re, float& im) {
  re = fmaf(ar, br, re);
  re = fmaf(ai, bi, re);
  im = fmaf(ai, br, im);
  im = fmaf(-ar, bi, im);
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

// Shared-memory row of the block's target, structure of arrays over L:
//   [0, L) e1r  [L, 2L) e1i  [2L, 3L) e2r  [3L, 4L) e2i
//   [4L, 5L) max(Omega, 0) (1 at P = 2)  [5L, 6L) tau / 2^s
// and, with kAngles (B5's chain rule to the phases),
//   [6L, 7L) cos phi1  [7L, 8L) sin phi1  [8L, 9L) cos phi2  [9L, 10L) sin phi2
// (phi2's pair is 0 unless P = 4).  Pulse channels are (phi, tau),
// (phi, Omega, tau) or, drive2, (phi1, phi2, Omega, tau).
template <int P, bool kAngles = false>
__device__ __forceinline__ void stage_row(const float* __restrict__ pulses,
                                          int b, int L, float xtalk,
                                          float tau_scale, float* row) {
  const float* src = pulses + static_cast<int64_t>(b) * L * P;
  for (int k = threadIdx.x; k < L; k += blockDim.x) {
    float s1, c1, s2 = 0.0f, c2 = 0.0f;
    sincosf(src[k * P], &s1, &c1);
    float e1r, e1i, e2r, e2i, om;
    if (P == 4) {
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
    if (kAngles) {
      row[6 * L + k] = c1;
      row[7 * L + k] = s1;
      row[8 * L + k] = c2;
      row[9 * L + k] = s2;
    }
  }
}

// The diagonal of H, (d1 z1 + d2 z2)/2 + J z1 z2 on |00>, |01>, |10>, |11>:
// 8 flops per sample.
__device__ __forceinline__ void energies(float d1, float d2, float coupling, float h[4]) {
  const float sum = 0.5f * (d1 + d2), diff = 0.5f * (d1 - d2);
  h[0] = sum + coupling;
  h[1] = diff - coupling;
  h[2] = -diff - coupling;
  h[3] = -sum + coupling;
}

// A = -i H t of segment k and its powers A^2, A^3, A^4.  A is anti-Hermitian
// and sparse: imaginary diagonal a = -h t, the coupling x2 = -i G2 t on the
// qubit-2 pairs (0,1), (2,3), x1 = -i G1 t on the qubit-1 pairs (0,2),
// (1,3), zero on (0,3), (1,2); column j is non-zero in rows j, j^1 (x2) and
// j^2 (x1).  A^2 and A^4 are Hermitian and A^3 anti-Hermitian, so each is
// formed as an upper triangle and only the products that are not zero are
// taken.  Flops (FMA = 2): 10 (A), 37 (A^2, closed form), 128 (A^3 = A^2 A),
// 166 (A^4 = A^2 A^2).  `half` is (1 + eps) / 2; conj1 / conj2 conjugate G1 /
// G2, as a lane's frame needs them (see Lane).
__device__ __forceinline__ void powers(const float* row, int L, int k, const float h[4],
                                       float half, Tri& A, Tri& A2, Tri& A3, Tri& A4,
                                       bool conj1 = false, bool conj2 = false) {
  const float t = row[5 * L + k];
  const float amp_t = half * row[4 * L + k] * t;
  // G t: G2 on the qubit-2 pairs, G1 on the qubit-1 pairs (H's upper
  // couplings; the lower ones are conj(G))
  const float g1r = row[k] * amp_t, g2r = row[2 * L + k] * amp_t;
  float g1i = row[L + k] * amp_t, g2i = row[3 * L + k] * amp_t;
  // a lane's frame (see Lane) may take conj(G1), conj(G2): a negation
  if (conj1) g1i = -g1i;
  if (conj2) g2i = -g2i;
  // entries (0,3) and (1,2) of A are zero and never read
#pragma unroll
  for (int d = 0; d < 4; ++d) A.d[d] = -h[d] * t;
  A.re[pair_index(0, 1)] = A.re[pair_index(2, 3)] = g2i;
  A.im[pair_index(0, 1)] = A.im[pair_index(2, 3)] = -g2r;
  A.re[pair_index(0, 2)] = A.re[pair_index(1, 3)] = g1i;
  A.im[pair_index(0, 2)] = A.im[pair_index(1, 3)] = -g1r;

  // A^2 = -(H t)^2: diagonal -(a_d^2 + |x1|^2 + |x2|^2); on a coupled
  // pair (i, j), i (a_i + a_j) x; (0,3) = 2 x1 x2, (1,2) = -2 conj(x2) x1
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
}

// Pm = P - I = c1 A + c2 A^2 + c3 A^3 (the identity c0 I is carried apart:
// see t8m1) and Q = c4 I + ... + c8 A^4, each a Hermitian part h plus an
// anti-Hermitian part s: (i, j) = h + s, (j, i) = conj(h - s); c1 = 1.
// 184 flops.
__device__ __forceinline__ void pq(const Tri& A, const Tri& A2, const Tri& A3,
                                   const Tri& A4, Mat& Pm, Mat& Qm) {
#pragma unroll
  for (int d = 0; d < 4; ++d) {
    Pm.re[5 * d] = kC2 * A2.d[d];
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
}

// T8(A) - I = (P - I) + A^4 Q (A^4's diagonal is real): 448 flops.
//
// Why the identity is carried apart: T8(A) = I + X with |X| ~ |A| ~ 0.03
// at tau = 0.5 / 2^4.  Stored as I + X in f32, X keeps only the bits below
// 1's ulp (2e-6 of X), and each squaring doubles that error: about 1e-6
// per segment, 2e-5 over L = 100 (on an H100, B4's product was 2.2e-5 from
// f64, and B5's gradient, seeded with it, 10x further from f64 than the
// plain version's).  Squaring X as (I + X)^2 - I = 2X + X^2 and updating
// W <- W + X W keeps X's full f32 precision.
__device__ __forceinline__ Mat t8m1(const Tri& A4, const Mat& Pm, const Mat& Qm) {
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
  return U;
}

// One squaring of I + X, minus I: 2X + X^2, dense, 544 flops.
__device__ __forceinline__ Mat square_m1(const Mat& X) {
  Mat c;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float re = 2.0f * X.re[4 * i + j], im = 2.0f * X.im[4 * i + j];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cmac(X.re[4 * i + k], X.im[4 * i + k], X.re[4 * k + j], X.im[4 * k + j], re, im);
      c.re[4 * i + j] = re;
      c.im[4 * i + j] = im;
    }
  return c;
}

// (I + X) W = W + X W, dense, 512 flops.
__device__ __forceinline__ Mat add_mul(const Mat& X, const Mat& W) {
  Mat c;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float re = W.re[4 * i + j], im = W.im[4 * i + j];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        cmac(X.re[4 * i + k], X.im[4 * i + k], W.re[4 * k + j], W.im[4 * k + j], re, im);
      c.re[4 * i + j] = re;
      c.im[4 * i + j] = im;
    }
  return c;
}

// The segment's exp(A) - I: T8(A) - I, then s squarings of I + X.
__device__ __forceinline__ Mat expm_m1(const Tri& A, const Tri& A2, const Tri& A3,
                                       const Tri& A4, int scaling) {
  Mat Pm, Qm;
  pq(A, A2, A3, A4, Pm, Qm);
  Mat X = t8m1(A4, Pm, Qm);
  for (int s = 0; s < scaling; ++s) X = square_m1(X);
  return X;
}

// The product of segments k0 .. k1 - 1 of one sample in one thread, left to
// right: W <- exp(A_k) W.
__device__ __forceinline__ Mat compose_span(const float* row, int L, int k0, int k1,
                                            const float h[4], float half, int scaling) {
  Mat W = identity();
  for (int k = k0; k < k1; ++k) {
    Tri A, A2, A3, A4;
    powers(row, L, k, h, half, A, A2, A3, A4);
    W = add_mul(expm_m1(A, A2, A3, A4, scaling), W);
  }
  return W;
}

// Compose the L segments of one sample in one thread (B7 on full launches,
// B4, B6, B8), left to right.
// Flops per segment: 10 + 37 + 128 + 166 (powers), 184 (P - I and Q), 448
// (P - I + A^4 Q), 544 per squaring and 512 (W): 3661 at s = 4.  Per sample
// 10 (the energies and (1 + eps)/2).
__device__ __forceinline__ Mat compose(const float* row, int L, float d1,
                                       float d2, float eps, float coupling,
                                       int scaling) {
  float h[4];
  energies(d1, d2, coupling, h);
  return compose_span(row, L, 0, L, h, 0.5f * (1.0f + eps), scaling);
}

// ---------------------------------------------------------------------------
// B5 and B8 in one thread per sample: the reverse sweep
// ---------------------------------------------------------------------------

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


// out += kSign H X, H a Hermitian Tri (real diagonal), X dense: 448 flops.
template <int kSign>
__device__ __forceinline__ void acc_herm_mul(Mat& out, const Tri& H, const Mat& X) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float re = out.re[4 * i + j], im = out.im[4 * i + j];
      re = fmaf(sgn<kSign>(H.d[i]), X.re[4 * i + j], re);
      im = fmaf(sgn<kSign>(H.d[i]), X.im[4 * i + j], im);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k == i) continue;
        float hr, hi;
        off<true>(H, i, k, hr, hi);
        cmac_s<kSign>(hr, hi, X.re[4 * k + j], X.im[4 * k + j], re, im);
      }
      out.re[4 * i + j] = re;
      out.im[4 * i + j] = im;
    }
}

// out += kSign X H, H a Hermitian Tri, X dense: 448 flops.
template <int kSign>
__device__ __forceinline__ void acc_mul_herm(Mat& out, const Mat& X, const Tri& H) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float re = out.re[4 * i + j], im = out.im[4 * i + j];
      re = fmaf(sgn<kSign>(H.d[j]), X.re[4 * i + j], re);
      im = fmaf(sgn<kSign>(H.d[j]), X.im[4 * i + j], im);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k == j) continue;
        float hr, hi;
        off<true>(H, k, j, hr, hi);
        cmac_s<kSign>(X.re[4 * i + k], X.im[4 * i + k], hr, hi, re, im);
      }
      out.re[4 * i + j] = re;
      out.im[4 * i + j] = im;
    }
}

// out += kSign A X with A as built by powers() (anti-Hermitian, imaginary
// diagonal, non-zero off the diagonal only on the coupled pairs: row i in
// columns i^1 and i^2): 320 flops.
template <int kSign>
__device__ __forceinline__ void acc_a_mul(Mat& out, const Tri& A, const Mat& X) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float re = out.re[4 * i + j], im = out.im[4 * i + j];
      // (i a_i) X(i, j)
      re = fmaf(sgn<-kSign>(A.d[i]), X.im[4 * i + j], re);
      im = fmaf(sgn<kSign>(A.d[i]), X.re[4 * i + j], im);
#pragma unroll
      for (int q = 1; q <= 2; ++q) {
        const int k = i ^ q;
        float ar, ai;
        off<false>(A, i, k, ar, ai);
        cmac_s<kSign>(ar, ai, X.re[4 * k + j], X.im[4 * k + j], re, im);
      }
      out.re[4 * i + j] = re;
      out.im[4 * i + j] = im;
    }
}

// out += kSign X A, A as in acc_a_mul (column j non-zero in rows j^1, j^2):
// 320 flops.
template <int kSign>
__device__ __forceinline__ void acc_mul_a(Mat& out, const Mat& X, const Tri& A) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float re = out.re[4 * i + j], im = out.im[4 * i + j];
      // X(i, j) (i a_j)
      re = fmaf(sgn<-kSign>(A.d[j]), X.im[4 * i + j], re);
      im = fmaf(sgn<kSign>(A.d[j]), X.re[4 * i + j], im);
#pragma unroll
      for (int q = 1; q <= 2; ++q) {
        const int k = j ^ q;
        float ar, ai;
        off<false>(A, k, j, ar, ai);
        cmac_s<kSign>(X.re[4 * i + k], X.im[4 * i + k], ar, ai, re, im);
      }
      out.re[4 * i + j] = re;
      out.im[4 * i + j] = im;
    }
}

// a b^H, dense: 480 flops.
__device__ __forceinline__ Mat matmul_nh(const Mat& a, const Mat& b) {
  Mat c;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // a(i, 0) conj(b(j, 0))
      float re = a.re[4 * i] * b.re[4 * j];
      re = fmaf(a.im[4 * i], b.im[4 * j], re);
      float im = a.im[4 * i] * b.re[4 * j];
      im = fmaf(-a.re[4 * i], b.im[4 * j], im);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        cmac_cb(a.re[4 * i + k], a.im[4 * i + k], b.re[4 * j + k], b.im[4 * j + k], re, im);
      c.re[4 * i + j] = re;
      c.im[4 * i + j] = im;
    }
  return c;
}

// a^H b, dense: 480 flops.
__device__ __forceinline__ Mat matmul_hn(const Mat& a, const Mat& b) {
  Mat c;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      // conj(a(0, i)) b(0, j)
      float re = a.re[i] * b.re[j];
      re = fmaf(a.im[i], b.im[j], re);
      float im = a.re[i] * b.im[j];
      im = fmaf(-a.im[i], b.re[j], im);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        cmac_ca(a.re[4 * k + i], a.im[4 * k + i], b.re[4 * k + j], b.im[4 * k + j], re, im);
      c.re[4 * i + j] = re;
      c.im[4 * i + j] = im;
    }
  return c;
}

// The adjoint of one squaring S -> S^2 applied to E, with S = I + X:
// S^H E + E S^H = 2E + X^H E + E X^H, dense, 1056 flops.
__device__ __forceinline__ Mat square_adjoint_m1(const Mat& X, const Mat& E) {
  Mat c;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float re = 2.0f * E.re[4 * i + j], im = 2.0f * E.im[4 * i + j];
#pragma unroll
      for (int k = 0; k < 4; ++k)  // conj(X(k, i)) E(k, j)
        cmac_ca(X.re[4 * k + i], X.im[4 * k + i], E.re[4 * k + j], E.im[4 * k + j], re, im);
#pragma unroll
      for (int k = 0; k < 4; ++k)  // E(i, k) conj(X(j, k))
        cmac_cb(E.re[4 * i + k], E.im[4 * i + k], X.re[4 * j + k], X.im[4 * j + k], re, im);
      c.re[4 * i + j] = re;
      c.im[4 * i + j] = im;
    }
  return c;
}

// A per-thread column of shared memory (`stride` floats between entries),
// which holds a Mat between phases of a segment so that it takes no
// registers meanwhile.
__device__ __forceinline__ void stash_store(float* col, int stride, const Mat& m) {
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    col[e * stride] = m.re[e];
    col[(16 + e) * stride] = m.im[e];
  }
}

__device__ __forceinline__ Mat stash_load(const float* col, int stride) {
  Mat m;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    m.re[e] = col[e * stride];
    m.im[e] = col[(16 + e) * stride];
  }
  return m;
}

// The seed of the sweep, V = G P^H: G is the cotangent of the sample's final
// product P under F = (|Tr(P^H T)|^2 + 4) / 20 times g_f = gbar / M
// (_fid_cotangent of the TPU kernel): with re + i im = Tr(P^H T) and
// g = g_f 2 / 20, G = g (re T_r + im T_i) + i g (re T_i - im T_r).
// 128 (trace) + 2 + 96 (G) + 480 flops per sample.
__device__ __forceinline__ Mat seed(const Mat& Pp, const float* t_re, const float* t_im,
                                    float g) {
  float re = 0.0f, im = 0.0f;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    re = fmaf(Pp.re[e], t_re[e], re);
    re = fmaf(Pp.im[e], t_im[e], re);
    im = fmaf(Pp.re[e], t_im[e], im);
    im = fmaf(-Pp.im[e], t_re[e], im);
  }
  const float gr = g * re, gi = g * im;
  Mat G;
#pragma unroll
  for (int e = 0; e < 16; ++e) {
    G.re[e] = fmaf(gr, t_re[e], gi * t_im[e]);
    G.im[e] = fmaf(gr, t_im[e], -gi * t_re[e]);
  }
  return matmul_nh(G, Pp);
}

// One sample's reverse sweep in one thread, seeded with V = G P^H in
// stash[0, 32) (stash[32, 64) is scratch), for k = L-1 .. 0; the lane group's
// reverse_sweep_lane below runs the same math.
//
// The TPU kernel's recurrence: the cotangent of segment k's unitary U_k is
// C_k = V U_k, then V <- U_k^H C_k.  Its expm adjoint maps C_k back through
// the s squarings (C <- S_j^H C + C S_j^H, j = s-1 .. 0, where S_0 = T8(A)
// and S_{j+1} = S_j^2) and through T8 = P + A^4 Q by the product rule, to
// D = dL/dA.  Every map in that chain is a sum of terms X -> M1 X M2 with
// M1, M2 polynomials in A^H = -A, and U_k is a polynomial in A, so they all
// commute with each other and with multiplication by U_k:
//     D = Adj(V U_k) = Adj(V) U_k,
// and the squarings' adjoints may be applied in forward order.  So each
// segment runs the T8 adjoint on V, then the squarings forward, S_j and the
// adjoint side by side (no S_j is stored, none rebuilt), then D = E U_k
// (only the 20 entries the chain rule reads), then V <- U_k^H V U_k.
//
// D to the parameters (_param_grads_from_D of the TPU kernel): A = t K with
// K = -i H, so dt = sum(Dr Kr + Di Ki), d tau = dt / 2^s; the diagonal
// energies take -t Di(d, d); a coupling G = amp e (upper entries of H; the
// lower are conj(G)) takes dG_r = -t (Di over its pairs, both triangles),
// dG_i = t (Dr upper - Dr lower); then amp = (1 + eps)/2 max(Omega, 0), the
// envelopes and the phases.  dOmega is gated on Omega > 0 as the TPU kernel
// gates it (the staged max(Omega, 0) > 0 exactly when Omega > 0).
//
// sink(k, v) receives the P pulse cotangents of segment k, in the pulses'
// channel order; dd1, dd2 and de accumulate the per-sample ones.
template <int P, class Sink>
__device__ __forceinline__ void reverse_sweep(const float* row, int L, float d1, float d2,
                                              float eps, float coupling, float xtalk,
                                              int scaling, float tau_scale, float* stash,
                                              int stride, float& dd1, float& dd2,
                                              float& de, Sink& sink) {
  float h[4];
  energies(d1, d2, coupling, h);
  const float half = 0.5f * (1.0f + eps);
  for (int k = L - 1; k >= 0; --k) {
    // forward: A, its powers, P, Q, S_0 = T8(A) (set aside in the stash)
    Tri A, A2, A3, A4;
    powers(row, L, k, h, half, A, A2, A3, A4);
    Mat E;
    {
      Mat Pm, Qm;
      pq(A, A2, A3, A4, Pm, Qm);
      stash_store(stash + 32 * stride, stride, t8m1(A4, Pm, Qm));
      // the T8 adjoint of X = V:
      //   Y = A^4 X (the cotangent of Q)
      //   dA4 = X Q^H + c8 Y,  dA3 = c3 X + c7 Y
      //   dA2 = c2 X + c6 Y + dA4 A^2 + A^2 dA4 - dA3 A
      //   E = dA = X + c5 Y + A^2 dA3 - dA2 A - A dA2
      // (A^H = -A, (A^2)^H = A^2, (A^4)^H = A^4)
      const Mat X = stash_load(stash, stride);
      Mat Y;
#pragma unroll
      for (int e = 0; e < 16; ++e) Y.re[e] = Y.im[e] = 0.0f;
      acc_herm_mul<1>(Y, A4, X);
      Mat dA4 = matmul_nh(X, Qm);
      Mat dA2, dA3;
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        dA4.re[e] = fmaf(kC8, Y.re[e], dA4.re[e]);
        dA4.im[e] = fmaf(kC8, Y.im[e], dA4.im[e]);
        dA2.re[e] = fmaf(kC6, Y.re[e], kC2 * X.re[e]);
        dA2.im[e] = fmaf(kC6, Y.im[e], kC2 * X.im[e]);
        dA3.re[e] = fmaf(kC7, Y.re[e], kC3 * X.re[e]);
        dA3.im[e] = fmaf(kC7, Y.im[e], kC3 * X.im[e]);
        E.re[e] = fmaf(kC5, Y.re[e], X.re[e]);
        E.im[e] = fmaf(kC5, Y.im[e], X.im[e]);
      }
      acc_mul_herm<1>(dA2, dA4, A2);
      acc_herm_mul<1>(dA2, A2, dA4);
      acc_mul_a<-1>(dA2, dA3, A);
      acc_herm_mul<1>(E, A2, dA3);
      acc_mul_a<-1>(E, dA2, A);
      acc_a_mul<-1>(E, A, dA2);
    }
    // the squarings, forward: S_{j+1} = S_j^2 beside E <- S_j^H E + E S_j^H,
    // with S_j = I + X_j carried as X_j (see t8m1)
    Mat S = stash_load(stash + 32 * stride, stride);
    for (int j = 0; j < scaling; ++j) {
      E = square_adjoint_m1(S, E);
      S = square_m1(S);
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) S.re[5 * d] = S.re[5 * d] + 1.0f;
    // S = U_k.  D = E U_k at the entries the chain rule reads: the imaginary
    // diagonal and the eight coupled entries
    float ddiag[4];
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float im = E.re[4 * d] * S.im[d];
      im = fmaf(E.im[4 * d], S.re[d], im);
#pragma unroll
      for (int q = 1; q < 4; ++q) {
        im = fmaf(E.re[4 * d + q], S.im[4 * q + d], im);
        im = fmaf(E.im[4 * d + q], S.re[4 * q + d], im);
      }
      ddiag[d] = im;
    }
    // X1 / X2: over the qubit-1 pairs (0,2), (1,3) and qubit-2 pairs (0,1),
    // (2,3), xr = sum of Di over both triangles, xi = Dr upper - Dr lower
    float x1r = 0.0f, x1i = 0.0f, x2r = 0.0f, x2i = 0.0f;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      // pair c / 2: (0,1) (2,3) on qubit 2, (0,2) (1,3) on qubit 1; c odd
      // is its lower entry
      const int pair = c >> 1;
      const bool qubit1 = pair >= 2;
      const int lo = pair == 1 ? 2 : (pair == 3 ? 1 : 0);
      const int hi = lo + (qubit1 ? 2 : 1);
      const bool upper = (c & 1) == 0;
      const int r = upper ? lo : hi, col = upper ? hi : lo;
      float re = E.re[4 * r] * S.re[col];
      re = fmaf(-E.im[4 * r], S.im[col], re);
      float im = E.re[4 * r] * S.im[col];
      im = fmaf(E.im[4 * r], S.re[col], im);
#pragma unroll
      for (int q = 1; q < 4; ++q)
        cmac(E.re[4 * r + q], E.im[4 * r + q], S.re[4 * q + col], S.im[4 * q + col], re, im);
      if (qubit1) {
        x1r = x1r + im;
        x1i = upper ? x1i + re : x1i - re;
      } else {
        x2r = x2r + im;
        x2i = upper ? x2i + re : x2i - re;
      }
    }
    const float t = row[5 * L + k], om = row[4 * L + k], amp = half * om;
    const float e1r = row[k], e1i = row[L + k], e2r = row[2 * L + k], e2i = row[3 * L + k];
    // dt = -sum_d h_d Di(d, d) + sum over couplings of (Dr Kr + Di Ki)
    float dt = -h[0] * ddiag[0];
    dt = fmaf(-h[1], ddiag[1], dt);
    dt = fmaf(-h[2], ddiag[2], dt);
    dt = fmaf(-h[3], ddiag[3], dt);
    const float g1r = amp * e1r, g1i = amp * e1i, g2r = amp * e2r, g2i = amp * e2i;
    dt = fmaf(g1i, x1i, dt);
    dt = fmaf(-g1r, x1r, dt);
    dt = fmaf(g2i, x2i, dt);
    dt = fmaf(-g2r, x2r, dt);
    const float ht = 0.5f * t;
    dd1 = fmaf(-ht, (ddiag[0] + ddiag[1]) - (ddiag[2] + ddiag[3]), dd1);
    dd2 = fmaf(-ht, (ddiag[0] - ddiag[1]) + (ddiag[2] - ddiag[3]), dd2);
    const float dh1r = -t * x1r, dh1i = t * x1i, dh2r = -t * x2r, dh2i = t * x2i;
    float damp = e1r * dh1r;
    damp = fmaf(e1i, dh1i, damp);
    damp = fmaf(e2r, dh2r, damp);
    damp = fmaf(e2i, dh2i, damp);
    de = fmaf(0.5f * om, damp, de);
    const float de1r = amp * dh1r, de1i = amp * dh1i, de2r = amp * dh2r, de2i = amp * dh2i;
    float v[P];
    v[P - 1] = dt * tau_scale;
    const float c1 = row[6 * L + k], s1 = row[7 * L + k];
    if constexpr (P == 4) {
      const float c2 = row[8 * L + k], s2 = row[9 * L + k];
      const float dc1 = fmaf(xtalk, de2r, de1r), ds1 = -fmaf(xtalk, de2i, de1i);
      const float dc2 = fmaf(xtalk, de1r, de2r), ds2 = -fmaf(xtalk, de1i, de2i);
      v[0] = fmaf(c1, ds1, -s1 * dc1);
      v[1] = fmaf(c2, ds2, -s2 * dc2);
    } else {
      const float dc = fmaf(xtalk, de2r, de1r), ds = -fmaf(xtalk, de2i, de1i);
      v[0] = fmaf(c1, ds, -s1 * dc);
    }
    if constexpr (P >= 3) v[P - 2] = om > 0.0f ? half * damp : 0.0f;
    sink(k, v);

    // V <- U_k^H V U_k
    const Mat C = matmul(stash_load(stash, stride), S);
    stash_store(stash, stride, matmul_hn(S, C));
  }
}

// ---------------------------------------------------------------------------
// The lane group: G lanes of one warp per sample (B4, B6, B5, B8)
// ---------------------------------------------------------------------------

constexpr int kSlotFloats = 32;  // one sample's dense matrix

// A lane's frame.  With G lanes per sample, a lane holds NC = 4 / G
// columns; lane h of its group takes c = h NC and works in the basis
// permuted by r -> r ^ c: a matrix M reads M'(r, k) = M(r ^ c, k ^ c) there,
// and the lane holds the frame's columns 0 .. NC-1, which are M's columns
// c .. c + NC - 1 (Col).  Products keep their form (P_c P_c = I).  H' is H
// with d1 -> -d1 where c flips qubit 1 (bit 1), d2 -> -d2 where it flips
// qubit 2 (bit 0), J -> -J where it flips one of them, and G1 -> conj(G1),
// G2 -> conj(G2) likewise: every lane runs the same code on its own
// parameters, and every register index is known at compile time.
struct Col {
  float re[4], im[4];  // entry r of frame column j is M(r ^ c, j ^ c)
};

// The lane's place: its first column c and its sample's matrix in slot 0 of
// the warp's exchange area (slots slot_stride<G> floats apart: one matrix for
// each of the warp's 32 / G samples).
struct Lane {
  float* area;
  int c;
  int swz;  // the sample's index in the warp modulo its quarter warp's samples
};

template <int G>
constexpr int slot_stride = 32 / G * kSlotFloats;

#ifdef __CUDACC__
// The group hook on the card: the group is G neighbouring lanes of a warp,
// and every lane of the warp takes part in every call.
__device__ __forceinline__ void group_sync() { __syncwarp(); }

// The sum over the group, in the same order in every lane.
template <int G>
__device__ __forceinline__ float group_sum(float v) {
  if constexpr (G >= 2) v += __shfl_xor_sync(0xffffffffu, v, 1);
  if constexpr (G >= 4) v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// out[d] = the group's value d, where lane h holds values h NC .. h NC + NC-1
// in v.
template <int G>
__device__ __forceinline__ void group_gather(const float (&v)[4 / G], float (&out)[4]) {
  constexpr int NC = 4 / G;
  const int base = threadIdx.x & 31 & ~(G - 1);
#pragma unroll
  for (int d = 0; d < 4; ++d) out[d] = __shfl_sync(0xffffffffu, v[d % NC], base + d / NC);
}

__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void ld4(const float* p, float (&v)[4]) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// Marks work that every lane of a group does alike; the host's flop count
// takes it once per sample.
struct Repeated {
  __device__ __forceinline__ Repeated() {}
};

// Marks work that a lane does again beside another where `again` (B8's
// second lane pair); the host's flop count leaves it out of the needed.
struct Duplicate {
  __device__ __forceinline__ explicit Duplicate(bool again) {}
};

// Marks work of B7's chunks that the function does not need (their
// combine); the host's flop count reports it apart.
struct Overhead {
  __device__ __forceinline__ Overhead() {}
};
#endif

// The 16 bytes of slot SLOT holding half q (0: re, 1: im) of column col.  A
// sample's matrix is 8 such parts; the part index is XORed with the
// sample's index modulo the samples of a quarter warp (8 / G), so that the 8
// lanes of a quarter warp touch 8 different 16-byte bank groups in every put
// and get: a 128-bit access by a warp is then 4 wavefronts, the least for
// 512 bytes.  Slots are compile-time constants, so that a slot is an
// immediate offset from a per-lane address the loop does not change.
template <int G, int SLOT>
__device__ __forceinline__ float* part(const Lane& ln, int col, int q) {
  return ln.area + SLOT * slot_stride<G> + 4 * ((2 * col + q) ^ ln.swz);
}

// The lane's columns into slot SLOT.
template <int G, int SLOT>
__device__ __forceinline__ void put(const Lane& ln, const Col (&x)[4 / G]) {
#pragma unroll
  for (int j = 0; j < 4 / G; ++j) {
    st4(part<G, SLOT>(ln, ln.c + j, 0), x[j].re);
    st4(part<G, SLOT>(ln, ln.c + j, 1), x[j].im);
  }
}

// Frame column K (K >= NC: another lane's): M'(r, K) = M(r ^ c, K ^ c),
// which the lane whose first column is c ^ Kh (Kh = K without its low bits)
// put as its entry r ^ Kh of column K ^ c.
template <int G, int SLOT, int K>
__device__ __forceinline__ Col get(const Lane& ln) {
  constexpr int Kh = K & ~(4 / G - 1);
  float re[4], im[4];
  ld4(part<G, SLOT>(ln, K ^ ln.c, 0), re);
  ld4(part<G, SLOT>(ln, K ^ ln.c, 1), im);
  Col v;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    v.re[r] = re[r ^ Kh];
    v.im[r] = im[r ^ Kh];
  }
  return v;
}

// Frame column K: the lane's own x[K], or another lane's from slot SLOT.
template <int G, int SLOT, int K>
__device__ __forceinline__ Col column(const Lane& ln, const Col (&x)[4 / G]) {
  if constexpr (K < 4 / G) {
    return x[K];
  } else {
    return get<G, SLOT, K>(ln);
  }
}

template <int K>
struct Int {
  static constexpr int value = K;
};

// f(Int<K>{}) for K = 0 .. 3.
template <class F>
__device__ __forceinline__ void for_k(F&& f) {
  f(Int<0>{});
  f(Int<1>{});
  f(Int<2>{});
  f(Int<3>{});
}

__device__ __forceinline__ Col zero_col() {
  Col v;
#pragma unroll
  for (int r = 0; r < 4; ++r) v.re[r] = v.im[r] = 0.0f;
  return v;
}

// The lane's frame energies (8 flops) and whether it conjugates G1, G2.
struct Frame {
  float h[4];
  bool conj1, conj2;
};

__device__ __forceinline__ Frame frame(const Lane& ln, float d1, float d2, float coupling) {
  Frame f;
  f.conj1 = (ln.c & 2) != 0;
  f.conj2 = (ln.c & 1) != 0;
  energies(f.conj1 ? -d1 : d1, f.conj2 ? -d2 : d2, f.conj1 != f.conj2 ? -coupling : coupling,
           f.h);
  return f;
}

// The lane's columns of T8(A) - I = (P - I) + A^4 Q: 112 flops each.
template <int G>
__device__ __forceinline__ void t8m1_cols(const Tri& A4, const Mat& Pm, const Mat& Qm,
                                          Col (&U)[4 / G]) {
#pragma unroll
  for (int j = 0; j < 4 / G; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float re = fmaf(A4.d[i], Qm.re[4 * i + j], Pm.re[4 * i + j]);
      float im = fmaf(A4.d[i], Qm.im[4 * i + j], Pm.im[4 * i + j]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k == i) continue;
        float ar, ai;
        off<true>(A4, i, k, ar, ai);
        cmac(ar, ai, Qm.re[4 * k + j], Qm.im[4 * k + j], re, im);
      }
      U[j].re[i] = re;
      U[j].im[i] = im;
    }
}

// One squaring of I + X, minus I: 2X + X X, 136 flops a column.  X's other
// columns are in slot.
template <int G, int SLOT>
__device__ __forceinline__ void square_m1_cols(const Lane& ln, Col (&x)[4 / G]) {
  constexpr int NC = 4 / G;
  Col c[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      c[j].re[i] = 2.0f * x[j].re[i];
      c[j].im[i] = 2.0f * x[j].im[i];
    }
  for_k([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    const Col xk = column<G, SLOT, K>(ln, x);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cmac(xk.re[i], xk.im[i], x[j].re[K], x[j].im[K], c[j].re[i], c[j].im[i]);
  });
#pragma unroll
  for (int j = 0; j < NC; ++j) x[j] = c[j];
}

// W <- (I + X) W = W + X W: 128 flops a column.
template <int G, int SLOT>
__device__ __forceinline__ void add_mul_cols(const Lane& ln, const Col (&x)[4 / G],
                                             Col (&w)[4 / G]) {
  constexpr int NC = 4 / G;
  Col c[NC];
#pragma unroll
  for (int j = 0; j < NC; ++j) c[j] = w[j];
  for_k([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    const Col xk = column<G, SLOT, K>(ln, x);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cmac(xk.re[i], xk.im[i], w[j].re[K], w[j].im[K], c[j].re[i], c[j].im[i]);
  });
#pragma unroll
  for (int j = 0; j < NC; ++j) w[j] = c[j];
}

// One segment of compose_lane: X = T8(A) - I from (A4, Pm, Qm), its s
// squarings (squaring j through slot j & 1) and W <- W + X W (through slot
// 2, or at s = 0 slot 2 + (k & 1)), each dense product after one exchange.
// kNext: right after the segment's first exchange, build segment k + 1's
// powers, P and Q into (A4, Pm, Qm); they do not depend on this segment's
// chain, so they fill that exchange's wait.
template <int G, bool kNext>
__device__ __forceinline__ void compose_segment(const float* row, int L, int k, const Frame& f,
                                                float half, int scaling, const Lane& ln,
                                                Tri& A4, Mat& Pm, Mat& Qm, Col (&w)[4 / G]) {
  Col X[4 / G];
  t8m1_cols<G>(A4, Pm, Qm, X);
  const auto next = [&] {
    if constexpr (kNext) {
      const Repeated rep;
      Tri A, A2, A3;
      powers(row, L, k + 1, f.h, half, A, A2, A3, A4, f.conj1, f.conj2);
      pq(A, A2, A3, A4, Pm, Qm);
    }
  };
  if (scaling == 0) {
    if (k & 1) {
      put<G, 3>(ln, X);
      group_sync();
      next();
      add_mul_cols<G, 3>(ln, X, w);
    } else {
      put<G, 2>(ln, X);
      group_sync();
      next();
      add_mul_cols<G, 2>(ln, X, w);
    }
    return;
  }
  put<G, 0>(ln, X);
  group_sync();
  next();
  square_m1_cols<G, 0>(ln, X);
  for (int s = 1; s < scaling; ++s) {
    if (s & 1) {
      put<G, 1>(ln, X);
      group_sync();
      square_m1_cols<G, 1>(ln, X);
    } else {
      put<G, 0>(ln, X);
      group_sync();
      square_m1_cols<G, 0>(ln, X);
    }
  }
  put<G, 2>(ln, X);
  group_sync();
  add_mul_cols<G, 2>(ln, X, w);
}

// B4, B6 (and B8's product): compose the L segments of one sample, the
// lane's columns of the product in its frame, into w.  Per segment: A's
// powers, P and Q (repeated by every lane, built one segment ahead; see
// compose_segment), then the lane's columns of T8(A) - I, of each squaring
// and of W <- W + X W, each dense product after one exchange.  A lane never
// writes a slot another may still read: consecutive exchanges use
// different slots.  Per lane and segment: 341 + 184 repeated,
// (112 + 136 s + 128) NC of the product's 3661 flops.
template <int G>
__device__ __forceinline__ void compose_lane(const float* row, int L, float d1, float d2,
                                             float eps, float coupling, int scaling,
                                             const Lane& ln, Col (&w)[4 / G]) {
  constexpr int NC = 4 / G;
  Frame f;
  float half;
  Tri A4;
  Mat Pm, Qm;
  {
    const Repeated rep;
    f = frame(ln, d1, d2, coupling);
    half = 0.5f * (1.0f + eps);
    Tri A, A2, A3;
    powers(row, L, 0, f.h, half, A, A2, A3, A4, f.conj1, f.conj2);
    pq(A, A2, A3, A4, Pm, Qm);
  }
#pragma unroll
  for (int j = 0; j < NC; ++j) {  // the frame's columns of I
    w[j] = zero_col();
    w[j].re[j] = 1.0f;
  }
  for (int k = 0; k + 1 < L; ++k)
    compose_segment<G, true>(row, L, k, f, half, scaling, ln, A4, Pm, Qm, w);
  compose_segment<G, false>(row, L, L - 1, f, half, scaling, ln, A4, Pm, Qm, w);
}

// The lanes per sample of B4's and B6's lane groups; B8's lane groups form
// their product the same way (product_rows_as_b4), so that it is B4's
// product value for value.
constexpr int kComposeLanes = 2;
// The lanes per sample of B5's and B8's lane groups in the sweep.
constexpr int kSweepLanes = 4;

// ---------------------------------------------------------------------------
// B7 on chunks: a sample's segments split over K threads
// ---------------------------------------------------------------------------
//
// Where one thread per sample leaves the warp schedulers short (the GRAPE
// robustness curve, 1 x 4096 samples of 20 segments: 32 blocks on 132 SMs,
// one warp a scheduler, each thread's 20 dependent segments the whole
// launch), a sample's L segments split into K contiguous chunks, whose
// lengths differ by at most one (the longer first), one thread each, the K
// threads of a sample in one warp.  Chunk j forms W_j, the product of its
// segments, as compose() does.  The chunks then combine in a fixed tree: at
// distance d = 1, 2, 4, ..., chunk j (a multiple of 2d) takes W_{j+d}
// (later segments: the left factor) from the chunks' exchange and forms
// W_{j+d} W_j.  So W = W_{K-1} ... W_0 in chunk 0, the same bits from run to
// run.  The combine is the design's overhead beside the bound's count,
// marked Overhead: K - 1 dense products (matmul, 480 flops) a sample; every
// chunk past the first forms the energies and (1 + eps) / 2 again (10
// flops, marked Duplicate).

// The segments k0 .. k1 - 1 of chunk j of K over L.
struct Span {
  int k0, k1;
};

__host__ __device__ constexpr Span chunk_span(int L, int K, int j) {
  const int q = L / K, r = L % K;
  const int k0 = j * q + (j < r ? j : r);
  return {k0, k0 + q + (j < r ? 1 : 0)};
}

// B7, chunk j of K of one sample on one thread: W_j.
__device__ __forceinline__ Mat compose_chunk(const float* row, int L, int K, int j, float d1,
                                             float d2, float eps, float coupling, int scaling) {
  float h[4], half;
  {
    const Duplicate again(j > 0);
    energies(d1, d2, coupling, h);
    half = 0.5f * (1.0f + eps);
  }
  const Span sp = chunk_span(L, K, j);
  return compose_span(row, L, sp.k0, sp.k1, h, half, scaling);
}

// The tree over the K chunks of one sample, one thread a chunk: W holds
// chunk j's W_j, and ends with the sample's product in chunk 0.  `col` is
// chunk j's column of the chunks' exchange (entries `stride` apart), chunk
// j + d's is col + d.  A chunk writes its column once, at the level where it
// hands over its W and stops, and the column is read after that level's
// sync: one sync a level.
__device__ __forceinline__ void combine_chunks(int K, int j, float* col, int stride, Mat& W) {
  const Overhead extra;
  for (int d = 1; d < K; d *= 2) {
    if ((j & (2 * d - 1)) == d) stash_store(col, stride, W);
    group_sync();
    if ((j & (2 * d - 1)) == 0 && j + d < K) W = matmul(stash_load(col + d, stride), W);
  }
}

// Blocks of a launch of B targets of M samples, threads / K samples a
// block.
inline int64_t prop_blocks(int B, int64_t M, int threads, int K) {
  const int64_t per_block = threads / K;
  return B * ((M + per_block - 1) / per_block);
}

// A combine's flops (matmul) over a segment's (compose): what a level of the
// tree adds to a chunk's chain.
constexpr double kCombineShare = 480.0 / 3661.0;

// B7's plan for B targets of M samples of L segments in blocks of `threads`
// (4 warps, one on each of an SM's 4 warp schedulers) on n_sm SMs: the
// chunks per sample K whose busiest SM has the least work, ceil(blocks /
// n_sm) blocks of chunks of ceil(L / K) segments and log2 K combines; K a
// power of two <= min(L, 32); the least K of equal work.  It weighs SMs a
// launch leaves idle, or loads one block more than the rest, against the
// combines.  K = 1, one thread per sample, is no candidate where it gives
// the schedulers under 1.5 warps each (blocks < 1.5 n_sm, the threshold of
// B4's and B6's lane groups, common.cuh's lane_groups_pay) and L > 1.  On an
// H100 (132 SMs), the GRAPE curve (1 x 4096, L = 20) takes K = 4: 128
// blocks, one a SM; serving's sweep (1 x 40 000, L = 100) K = 2, where K = 1
// puts 3 blocks on 49 SMs and 2 on the rest; the variants' sweep (2 000 000
// samples, L = 20: 119 blocks a SM) K = 1.
inline int prop_plan(int B, int64_t M, int L, int n_sm, int threads) {
  if (n_sm < 1 || L < 2) return 1;
  const bool short_at_one = 2 * prop_blocks(B, M, threads, 1) < 3 * static_cast<int64_t>(n_sm);
  int best = 0;
  double least = 0.0;
  for (int K = short_at_one ? 2 : 1, levels = K - 1; K <= L && K <= 32; K *= 2, ++levels) {
    const int64_t busiest = (prop_blocks(B, M, threads, K) + n_sm - 1) / n_sm;
    const double cost = busiest * ((L + K - 1) / K + levels * kCombineShare);
    if (best == 0 || cost < least) {
      best = K;
      least = cost;
    }
  }
  return best;
}

// B8 on lane groups of 4 lanes: the group's two pairs each form the sample's
// product as B4's lane groups do (compose_lane<kComposeLanes>, pair q of the
// warp's sample g in the exchange area as sample 2 g + q of a 2-lane
// layout, slots 0 .. SLOT), then lane c reads row c of it, P'(0, K) =
// P(c, K ^ c), as B5 reads B4's product.  `warp` is the warp's exchange
// area (5 slots of the 2-lane layout); the caller syncs the group before
// it puts the area to other use.
template <int SLOT>
__device__ __forceinline__ void product_rows_as_b4(const float* row, int L, float d1, float d2,
                                                   float eps, float coupling, int scaling,
                                                   float* warp, int g, int c, float (&pr)[1][4],
                                                   float (&pi)[1][4]) {
  constexpr int G = kComposeLanes;
  const int g2 = 2 * g + (c >> 1);
  const Lane ln{warp + kSlotFloats * g2, (c & 1) * (4 / G), g2 & (8 / G - 1)};
  Col W[4 / G];
  {
    const Duplicate dup(c >= 2);  // the second pair forms the same product
    compose_lane<G>(row, L, d1, d2, eps, coupling, scaling, ln, W);
  }
  put<G, SLOT>(ln, W);
  group_sync();
  // P(c, k) is entry c ^ (k & 2) of column k, which the pair's lane with
  // first column k & 2 put in its frame
#pragma unroll
  for (int K = 0; K < 4; ++K) {
    const int k = K ^ c, e = c ^ (k & 2);
    pr[0][K] = part<G, SLOT>(ln, k, 0)[e];
    pi[0][K] = part<G, SLOT>(ln, k, 1)[e];
  }
}

// The seed of the sweep, V = G P^H, the lane's columns in the frame: G is
// the cotangent of the sample's product P under F = (|Tr(P^H T)|^2 + 4) / 20
// times g_f = gbar / M (_fid_cotangent of the TPU kernel): with
// re + i im = Tr(P^H T) and g = g_f 2 / 20,
// G = g (re T_r + im T_i) + i g (re T_i - im T_r).  (pr, pi) are the frame's
// rows of P the lane holds (product_rows_as_b4, or B4's product in device
// memory); T is the block's target, row-major.  The trace takes 32 flops a
// row and a sum over the group, G (98) is repeated, V 120 a column: 706 per
// sample.
template <int G>
__device__ __forceinline__ void seed_lane(const float (&pr)[4 / G][4],
                                          const float (&pi)[4 / G][4], const float* t_re,
                                          const float* t_im, float g, const Lane& ln,
                                          Col (&V)[4 / G]) {
  constexpr int NC = 4 / G;
  // T'(r, k) = T(r ^ c, k ^ c) sits at (4 r + k) ^ 5c
  const int perm = 5 * ln.c;
  float re = 0.0f, im = 0.0f;
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int e = (4 * j + k) ^ perm;
      re = fmaf(pr[j][k], t_re[e], re);
      re = fmaf(pi[j][k], t_im[e], re);
      im = fmaf(pr[j][k], t_im[e], im);
      im = fmaf(-pi[j][k], t_re[e], im);
    }
  re = group_sum<G>(re);
  im = group_sum<G>(im);
  Mat Gm;
  {
    const Repeated rep;
    const float gr = g * re, gi = g * im;
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int t = e ^ perm;
      Gm.re[e] = fmaf(gr, t_re[t], gi * t_im[t]);
      Gm.im[e] = fmaf(gr, t_im[t], -gi * t_re[t]);
    }
  }
  // V'(i, j) = sum_k G'(i, k) conj(P'(j, k))
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float vr = Gm.re[4 * i] * pr[j][0];
      vr = fmaf(Gm.im[4 * i], pi[j][0], vr);
      float vi = Gm.im[4 * i] * pr[j][0];
      vi = fmaf(-Gm.re[4 * i], pi[j][0], vi);
#pragma unroll
      for (int k = 1; k < 4; ++k)
        cmac_cb(Gm.re[4 * i + k], Gm.im[4 * i + k], pr[j][k], pi[j][k], vr, vi);
      V[j].re[i] = vr;
      V[j].im[i] = vi;
    }
}

// out += kSign H x, H a Hermitian Tri (real diagonal), lane-local: 112 flops
// a column.
template <int G, int kSign>
__device__ __forceinline__ void herm_mul(Col (&out)[4 / G], const Tri& H,
                                         const Col (&x)[4 / G]) {
#pragma unroll
  for (int j = 0; j < 4 / G; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float re = out[j].re[i], im = out[j].im[i];
      re = fmaf(sgn<kSign>(H.d[i]), x[j].re[i], re);
      im = fmaf(sgn<kSign>(H.d[i]), x[j].im[i], im);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (k == i) continue;
        float hr, hi;
        off<true>(H, i, k, hr, hi);
        cmac_s<kSign>(hr, hi, x[j].re[k], x[j].im[k], re, im);
      }
      out[j].re[i] = re;
      out[j].im[i] = im;
    }
}

// out += kSign A x with A as built by powers() (anti-Hermitian, imaginary
// diagonal, row i non-zero off the diagonal in columns i^1 and i^2),
// lane-local: 80 flops a column.
template <int G, int kSign>
__device__ __forceinline__ void a_mul(Col (&out)[4 / G], const Tri& A, const Col (&x)[4 / G]) {
#pragma unroll
  for (int j = 0; j < 4 / G; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float re = out[j].re[i], im = out[j].im[i];
      re = fmaf(sgn<-kSign>(A.d[i]), x[j].im[i], re);  // (i a_i) x(i)
      im = fmaf(sgn<kSign>(A.d[i]), x[j].re[i], im);
#pragma unroll
      for (int q = 1; q <= 2; ++q) {
        const int k = i ^ q;
        float ar, ai;
        off<false>(A, i, k, ar, ai);
        cmac_s<kSign>(ar, ai, x[j].re[k], x[j].im[k], re, im);
      }
      out[j].re[i] = re;
      out[j].im[i] = im;
    }
}

// out += kSign X H, H a Hermitian Tri; X's own columns x, the others in
// slot: 112 flops a column.
template <int G, int kSign, int SLOT>
__device__ __forceinline__ void mul_herm(Col (&out)[4 / G], const Lane& ln,
                                         const Col (&x)[4 / G], const Tri& H) {
  for_k([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    const Col xk = column<G, SLOT, K>(ln, x);
#pragma unroll
    for (int j = 0; j < 4 / G; ++j) {
      if (K == j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          out[j].re[i] = fmaf(sgn<kSign>(H.d[j]), xk.re[i], out[j].re[i]);
          out[j].im[i] = fmaf(sgn<kSign>(H.d[j]), xk.im[i], out[j].im[i]);
        }
      } else {
        float hr, hi;
        off<true>(H, K, j, hr, hi);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cmac_s<kSign>(xk.re[i], xk.im[i], hr, hi, out[j].re[i], out[j].im[i]);
      }
    }
  });
}

// out += kSign X A, A as in a_mul (column j non-zero in rows j, j^1, j^2):
// 80 flops a column.
template <int G, int kSign, int SLOT>
__device__ __forceinline__ void mul_a(Col (&out)[4 / G], const Lane& ln,
                                      const Col (&x)[4 / G], const Tri& A) {
  constexpr int NC = 4 / G;
  for_k([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    // columns K that some own column j reads: K = j, j^1, j^2
    bool read = false;
#pragma unroll
    for (int j = 0; j < NC; ++j) read = read || (K ^ j) != 3;
    if (!read) return;
    const Col xk = column<G, SLOT, K>(ln, x);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      if (K == j) {  // x(i) (i a_j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          out[j].re[i] = fmaf(sgn<-kSign>(A.d[j]), xk.im[i], out[j].re[i]);
          out[j].im[i] = fmaf(sgn<kSign>(A.d[j]), xk.re[i], out[j].im[i]);
        }
      } else if ((K ^ j) != 3) {
        float ar, ai;
        off<false>(A, K, j, ar, ai);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cmac_s<kSign>(xk.re[i], xk.im[i], ar, ai, out[j].re[i], out[j].im[i]);
      }
    }
  });
}

// X Q^H: column j is sum_k X[:, k] conj(Q(j, k)): 120 flops a column.
template <int G, int SLOT>
__device__ __forceinline__ void mul_nh(Col (&out)[4 / G], const Lane& ln,
                                       const Col (&x)[4 / G], const Mat& Q) {
  for_k([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    const Col xk = column<G, SLOT, K>(ln, x);
#pragma unroll
    for (int j = 0; j < 4 / G; ++j) {
      const float qr = Q.re[4 * j + K], qi = Q.im[4 * j + K];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (K == 0) {
          float re = xk.re[i] * qr;
          re = fmaf(xk.im[i], qi, re);
          float im = xk.im[i] * qr;
          im = fmaf(-xk.re[i], qi, im);
          out[j].re[i] = re;
          out[j].im[i] = im;
        } else {
          cmac_cb(xk.re[i], xk.im[i], qr, qi, out[j].re[i], out[j].im[i]);
        }
      }
    }
  });
}

// One forward squaring of S = I + X beside the adjoint of S -> S^2 on E, the
// lane's columns (X's and E's others in slots SLOT and SLOT + 1):
//   X <- 2X + X X (136 flops a column),  E <- 2E + X^H E + E X^H (264).
template <int G, int SLOT>
__device__ __forceinline__ void square_pair(const Lane& ln, Col (&x)[4 / G], Col (&e)[4 / G]) {
  constexpr int NC = 4 / G;
  Col xn[NC], en[NC];
  float xr[NC][4], xi[NC][4];  // X'(j, K)
#pragma unroll
  for (int j = 0; j < NC; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      xn[j].re[i] = 2.0f * x[j].re[i];
      xn[j].im[i] = 2.0f * x[j].im[i];
      en[j].re[i] = 2.0f * e[j].re[i];
      en[j].im[i] = 2.0f * e[j].im[i];
    }
  // X's column K gives X X's term K, row K of X^H E and X(j, K)
  for_k([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    const Col xk = column<G, SLOT, K>(ln, x);
#pragma unroll
    for (int j = 0; j < NC; ++j) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cmac(xk.re[i], xk.im[i], x[j].re[K], x[j].im[K], xn[j].re[i], xn[j].im[i]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        cmac_ca(xk.re[r], xk.im[r], e[j].re[r], e[j].im[r], en[j].re[K], en[j].im[K]);
      xr[j][K] = xk.re[j];
      xi[j][K] = xk.im[j];
    }
  });
  for_k([&](auto kk) {
    constexpr int K = decltype(kk)::value;
    const Col ek = column<G, SLOT + 1, K>(ln, e);
#pragma unroll
    for (int j = 0; j < NC; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        cmac_cb(ek.re[i], ek.im[i], xr[j][K], xi[j][K], en[j].re[i], en[j].im[i]);
  });
#pragma unroll
  for (int j = 0; j < NC; ++j) {
    x[j] = xn[j];
    e[j] = en[j];
  }
}

// The exchange slots of the sweep: 0-3 (two pairs for the squarings), V's,
// and the pair of U_k and E_s.
constexpr int kSweepSlots = 7;
constexpr int kSlotV = 4;
constexpr int kSlotFinal = 5;

// B5 and B8: one sample's reverse sweep from V = G P^H (the lane's columns,
// from seed_lane), for k = L-1 .. 0.
//
// The TPU kernel's recurrence: the cotangent of segment k's unitary U_k is
// C_k = V U_k, then V <- U_k^H C_k.  Its expm adjoint maps C_k back through
// the s squarings (C <- S_j^H C + C S_j^H, j = s-1 .. 0, where S_0 = T8(A)
// and S_{j+1} = S_j^2) and through T8 = P + A^4 Q by the product rule, to
// D = dL/dA.  Every map in that chain is a sum of terms X -> M1 X M2 with
// M1, M2 polynomials in A^H = -A, and U_k is a polynomial in A, so they all
// commute with each other and with multiplication by U_k:
//     D = Adj(V U_k) = Adj(V) U_k,
// and the squarings' adjoints may be applied in forward order.  So each
// segment runs the T8 adjoint on V, then the squarings forward, S_j and the
// adjoint side by side (no S_j is stored, none rebuilt), then D = E U_k
// (only the 20 entries the chain rule reads), then V <- U_k^H V U_k.
//
// In the lane group, per segment (s + 5 exchanges, each a put of the lane's
// columns of one or two matrices, group_sync, and gets of the others'):
//   V -> slot 4 and S_0 -> slot 0; the T8 adjoint of X = V:
//     Y = A^4 X (the cotangent of Q)
//     dA4 = X Q^H + c8 Y,  dA3 = c3 X + c7 Y
//     dA2 = c2 X + c6 Y + dA4 A^2 + A^2 dA4 - dA3 A   (dA4 -> 1, dA3 -> 2)
//     E = dA = X + c5 Y + A^2 dA3 - dA2 A - A dA2     (dA2 -> 3)
//   (A^H = -A, (A^2)^H = A^2, (A^4)^H = A^4); E_0 -> 1; squaring j reads
//   pair j & 1 (S_j, E_j in slots 2 (j & 1) and 2 (j & 1) + 1) and puts
//   S_{j+1}, E_{j+1} into the other pair; U_k = I + S_s and E_s go to slots
//   5 and 6; then D's entries of the lane's columns (their diagonal and
//   coupled entries) and V's columns of U_k^H (V U_k); a last group_sync
//   frees the slots for the next segment.
//
// D to the parameters (_param_grads_from_D of the TPU kernel): A = t K with
// K = -i H, so dt = sum(Dr Kr + Di Ki), d tau = dt / 2^s; the diagonal
// energies take -t Di(d, d); a coupling G = amp e (upper entries of H; the
// lower are conj(G)) takes dG_r = -t (Di over its pairs, both triangles),
// dG_i = t (Dr upper - Dr lower); then amp = (1 + eps)/2 max(Omega, 0), the
// envelopes and the phases.  dOmega is gated on Omega > 0 as the TPU kernel
// gates it (the staged max(Omega, 0) > 0 exactly when Omega > 0).  The group
// gathers D's diagonal and sums its coupled entries, then every lane runs the
// chain rule alike.
//
// sink(k, v, lead) receives the P pulse cotangents of segment k, in the
// pulses' channel order (lead: this lane is its group's first); dd1, dd2
// and de accumulate the per-sample ones, alike in every lane.
template <int G, int P, class Sink>
__device__ __forceinline__ void reverse_sweep_lane(const float* row, int L, float d1, float d2,
                                                   float eps, float coupling, float xtalk,
                                                   int scaling, float tau_scale, const Lane& ln,
                                                   Col (&V)[4 / G], float& dd1, float& dd2,
                                                   float& de, Sink& sink) {
  constexpr int NC = 4 / G;
  Frame f;
  float half;
  {
    const Repeated rep;
    f = frame(ln, d1, d2, coupling);
    half = 0.5f * (1.0f + eps);
  }
  float h[4];  // H's diagonal: h_d is lane (d / NC)'s frame energy d mod NC
  {
    float own[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) own[j] = f.h[j];
    group_gather<G>(own, h);
  }
  for (int k = L - 1; k >= 0; --k) {
    // forward: A, its powers, P, Q; S_0 = T8(A) - I to slot 0
    Tri A, A2, A3, A4;
    Mat Pm, Qm;
    {
      const Repeated rep;
      powers(row, L, k, f.h, half, A, A2, A3, A4, f.conj1, f.conj2);
      pq(A, A2, A3, A4, Pm, Qm);
    }
    {
      Col S0[NC];
      t8m1_cols<G>(A4, Pm, Qm, S0);
      put<G, 0>(ln, S0);
    }
    put<G, kSlotV>(ln, V);
    group_sync();
    // the T8 adjoint of X = V
    Col E[NC], dA2[NC];
    {
      Col Y[NC], dA4[NC], dA3[NC];
#pragma unroll
      for (int j = 0; j < NC; ++j) Y[j] = zero_col();
      herm_mul<G, 1>(Y, A4, V);
      mul_nh<G, kSlotV>(dA4, ln, V, Qm);
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          dA4[j].re[r] = fmaf(kC8, Y[j].re[r], dA4[j].re[r]);
          dA4[j].im[r] = fmaf(kC8, Y[j].im[r], dA4[j].im[r]);
          dA2[j].re[r] = fmaf(kC6, Y[j].re[r], kC2 * V[j].re[r]);
          dA2[j].im[r] = fmaf(kC6, Y[j].im[r], kC2 * V[j].im[r]);
          dA3[j].re[r] = fmaf(kC7, Y[j].re[r], kC3 * V[j].re[r]);
          dA3[j].im[r] = fmaf(kC7, Y[j].im[r], kC3 * V[j].im[r]);
          E[j].re[r] = fmaf(kC5, Y[j].re[r], V[j].re[r]);
          E[j].im[r] = fmaf(kC5, Y[j].im[r], V[j].im[r]);
        }
      put<G, 1>(ln, dA4);
      put<G, 2>(ln, dA3);
      group_sync();
      mul_herm<G, 1, 1>(dA2, ln, dA4, A2);
      herm_mul<G, 1>(dA2, A2, dA4);
      mul_a<G, -1, 2>(dA2, ln, dA3, A);
      herm_mul<G, 1>(E, A2, dA3);
    }
    put<G, 3>(ln, dA2);
    group_sync();
    mul_a<G, -1, 3>(E, ln, dA2, A);
    a_mul<G, -1>(E, A, dA2);
    // the squarings, forward: S_{j+1} = S_j^2 beside E <- S_j^H E + E S_j^H,
    // with S_j = I + X_j carried as X_j (see t8m1)
    Col S[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j) {  // the lane's own columns of S_0, put above
      ld4(part<G, 0>(ln, ln.c + j, 0), S[j].re);
      ld4(part<G, 0>(ln, ln.c + j, 1), S[j].im);
    }
    put<G, 1>(ln, E);
    for (int j = 0; j < scaling; ++j) {
      group_sync();
      const bool more = j + 1 < scaling;
      if (j & 1) {
        square_pair<G, 2>(ln, S, E);
        if (more) {
          put<G, 0>(ln, S);
          put<G, 1>(ln, E);
        }
      } else {
        square_pair<G, 0>(ln, S, E);
        if (more) {
          put<G, 2>(ln, S);
          put<G, 3>(ln, E);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NC; ++j) S[j].re[j] = S[j].re[j] + 1.0f;  // S = U_k
    put<G, kSlotFinal>(ln, S);
    put<G, kSlotFinal + 1>(ln, E);
    group_sync();
    // D = E U_k at the lane's entries: in each own column j, the imaginary
    // diagonal (j, j) and the coupled (j^1, j) (qubit 2) and (j^2, j)
    // (qubit 1) of the frame
    float dg[NC], q2r[NC], q2i[NC], q1r[NC], q1i[NC];
    for_k([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const Col ek = column<G, kSlotFinal + 1, K>(ln, E);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        const float ur = S[j].re[K], ui = S[j].im[K];
        if (K == 0) {
          dg[j] = ek.re[j] * ui;
          dg[j] = fmaf(ek.im[j], ur, dg[j]);
          q2r[j] = ek.re[j ^ 1] * ur;
          q2r[j] = fmaf(-ek.im[j ^ 1], ui, q2r[j]);
          q2i[j] = ek.re[j ^ 1] * ui;
          q2i[j] = fmaf(ek.im[j ^ 1], ur, q2i[j]);
          q1r[j] = ek.re[j ^ 2] * ur;
          q1r[j] = fmaf(-ek.im[j ^ 2], ui, q1r[j]);
          q1i[j] = ek.re[j ^ 2] * ui;
          q1i[j] = fmaf(ek.im[j ^ 2], ur, q1i[j]);
        } else {
          dg[j] = fmaf(ek.re[j], ui, dg[j]);
          dg[j] = fmaf(ek.im[j], ur, dg[j]);
          cmac(ek.re[j ^ 1], ek.im[j ^ 1], ur, ui, q2r[j], q2i[j]);
          cmac(ek.re[j ^ 2], ek.im[j ^ 2], ur, ui, q1r[j], q1i[j]);
        }
      }
    });
    // X1 / X2 over the qubit-1 and qubit-2 pairs: xr = sum of Di over both
    // triangles, xi = Dr upper - Dr lower; the lane's share, then the group's.
    // Frame entry (r, j) is (r ^ c, j ^ c), upper where r ^ c < j ^ c.
    float x1r = 0.0f, x1i = 0.0f, x2r = 0.0f, x2i = 0.0f;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      const int col = j ^ ln.c;
      x2r = x2r + q2i[j];
      x2i = (col ^ 1) < col ? x2i + q2r[j] : x2i - q2r[j];
      x1r = x1r + q1i[j];
      x1i = (col ^ 2) < col ? x1i + q1r[j] : x1i - q1r[j];
    }
    x1r = group_sum<G>(x1r);
    x1i = group_sum<G>(x1i);
    x2r = group_sum<G>(x2r);
    x2i = group_sum<G>(x2i);
    float ddiag[4];
    group_gather<G>(dg, ddiag);
    float v[P];
    {
      const Repeated rep;
      const float t = row[5 * L + k], om = row[4 * L + k], amp = half * om;
      const float e1r = row[k], e1i = row[L + k], e2r = row[2 * L + k], e2i = row[3 * L + k];
      // dt = -sum_d h_d Di(d, d) + sum over couplings of (Dr Kr + Di Ki)
      float dt = -h[0] * ddiag[0];
      dt = fmaf(-h[1], ddiag[1], dt);
      dt = fmaf(-h[2], ddiag[2], dt);
      dt = fmaf(-h[3], ddiag[3], dt);
      const float g1r = amp * e1r, g1i = amp * e1i, g2r = amp * e2r, g2i = amp * e2i;
      dt = fmaf(g1i, x1i, dt);
      dt = fmaf(-g1r, x1r, dt);
      dt = fmaf(g2i, x2i, dt);
      dt = fmaf(-g2r, x2r, dt);
      const float ht = 0.5f * t;
      dd1 = fmaf(-ht, (ddiag[0] + ddiag[1]) - (ddiag[2] + ddiag[3]), dd1);
      dd2 = fmaf(-ht, (ddiag[0] - ddiag[1]) + (ddiag[2] - ddiag[3]), dd2);
      const float dh1r = -t * x1r, dh1i = t * x1i, dh2r = -t * x2r, dh2i = t * x2i;
      float damp = e1r * dh1r;
      damp = fmaf(e1i, dh1i, damp);
      damp = fmaf(e2r, dh2r, damp);
      damp = fmaf(e2i, dh2i, damp);
      de = fmaf(0.5f * om, damp, de);
      const float de1r = amp * dh1r, de1i = amp * dh1i, de2r = amp * dh2r, de2i = amp * dh2i;
      v[P - 1] = dt * tau_scale;
      const float c1 = row[6 * L + k], s1 = row[7 * L + k];
      if constexpr (P == 4) {
        const float c2 = row[8 * L + k], s2 = row[9 * L + k];
        const float dc1 = fmaf(xtalk, de2r, de1r), ds1 = -fmaf(xtalk, de2i, de1i);
        const float dc2 = fmaf(xtalk, de1r, de2r), ds2 = -fmaf(xtalk, de1i, de2i);
        v[0] = fmaf(c1, ds1, -s1 * dc1);
        v[1] = fmaf(c2, ds2, -s2 * dc2);
      } else {
        const float dc = fmaf(xtalk, de2r, de1r), ds = -fmaf(xtalk, de2i, de1i);
        v[0] = fmaf(c1, ds, -s1 * dc);
      }
      if constexpr (P >= 3) v[P - 2] = om > 0.0f ? half * damp : 0.0f;
    }
    sink(k, v, ln.c == 0);

    // V <- U_k^H (V U_k): C = V U_k from V's columns in slot 4; then
    // U_k^H C, row K from U_k's column K
    Col C[NC];
    for_k([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const Col vk = column<G, kSlotV, K>(ln, V);
#pragma unroll
      for (int j = 0; j < NC; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (K == 0) {
            float re = vk.re[i] * S[j].re[0];
            re = fmaf(-vk.im[i], S[j].im[0], re);
            float im = vk.re[i] * S[j].im[0];
            im = fmaf(vk.im[i], S[j].re[0], im);
            C[j].re[i] = re;
            C[j].im[i] = im;
          } else {
            cmac(vk.re[i], vk.im[i], S[j].re[K], S[j].im[K], C[j].re[i], C[j].im[i]);
          }
        }
    });
    for_k([&](auto kk) {
      constexpr int K = decltype(kk)::value;
      const Col uk = column<G, kSlotFinal, K>(ln, S);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        float re = uk.re[0] * C[j].re[0];
        re = fmaf(uk.im[0], C[j].im[0], re);
        float im = uk.re[0] * C[j].im[0];
        im = fmaf(-uk.im[0], C[j].re[0], im);
#pragma unroll
        for (int r = 1; r < 4; ++r) cmac_ca(uk.re[r], uk.im[r], C[j].re[r], C[j].im[r], re, im);
        V[j].re[K] = re;
        V[j].im[K] = im;
      }
    });
    group_sync();
  }
}

}  // namespace su4
