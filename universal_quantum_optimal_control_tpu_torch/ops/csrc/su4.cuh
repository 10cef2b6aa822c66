// SU(4) per-sample math shared by propagate_su4.cu (B4, B6, B7) and
// propagate_su4_bwd.cu (B5).  Nothing here is CUDA-specific beyond the
// qualifiers, fmaf, fmaxf, sincosf and threadIdx / blockDim, so the host
// tests build it with a C++ compiler and the qualifiers defined away
// (tests/test_torch_su4_host.py).
//
// Math (as core/su4.py and the TPU kernels' _segment_body): per segment,
// A = -i H tau / 2^s is built from the sparse H (four real diagonal energies
// +-(d1 +- d2)/2 +- J and the couplings G1 = amp e1, G2 = amp e2, with
// amp = (1 + eps)/2 * max(Omega, 0) and the drive envelopes
// e1 = e^{-i phi1} + chi e^{-i phi2}, e2 = chi e^{-i phi1} + e^{-i phi2}
// (drive2), or e1 = e^{-i phi}, e2 = chi e^{-i phi}); then
// exp(A) = P + A^4 Q with the order-8 Paterson-Stockmeyer cubics P and Q in
// A, A^2, A^3, then s squarings, all carried as exp(A) - I (see t8m1).

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
// 166 (A^4 = A^2 A^2).  `half` is (1 + eps) / 2.
__device__ __forceinline__ void powers(const float* row, int L, int k, const float h[4],
                                       float half, Tri& A, Tri& A2, Tri& A3, Tri& A4) {
  const float t = row[5 * L + k];
  const float amp_t = half * row[4 * L + k] * t;
  // G t: G2 on the qubit-2 pairs, G1 on the qubit-1 pairs (H's upper
  // couplings; the lower ones are conj(G))
  const float g1r = row[k] * amp_t, g1i = row[L + k] * amp_t;
  const float g2r = row[2 * L + k] * amp_t, g2i = row[3 * L + k] * amp_t;
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

// Compose the L segments of one sample, left to right: W <- exp(A_k) W.
// Flops per segment: 10 + 37 + 128 + 166 (powers), 184 (P - I and Q), 448
// (P - I + A^4 Q), 544 per squaring and 512 (W): 3661 at s = 4.  Per sample
// 10 (the energies and (1 + eps)/2).
__device__ __forceinline__ Mat compose(const float* row, int L, float d1,
                                       float d2, float eps, float coupling,
                                       int scaling) {
  float h[4];
  energies(d1, d2, coupling, h);
  const float half = 0.5f * (1.0f + eps);
  Mat W = identity();
  for (int k = 0; k < L; ++k) {
    Tri A, A2, A3, A4;
    powers(row, L, k, h, half, A, A2, A3, A4);
    W = add_mul(expm_m1(A, A2, A3, A4, scaling), W);
  }
  return W;
}

// ---------------------------------------------------------------------------
// B5: the reverse sweep
// ---------------------------------------------------------------------------

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

// One sample's reverse sweep, seeded with V = G P^H in stash[0, 32)
// (stash[32, 64) is scratch), for k = L-1 .. 0.
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

}  // namespace su4
