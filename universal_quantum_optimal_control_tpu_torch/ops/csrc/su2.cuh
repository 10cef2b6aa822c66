// SU(2) per-sample math shared by the kernels of propagate_su2.cu: B3
// (propagate_mc_kernel), B1 (mean_fid_kernel) and B2
// (propagate_mc_vjp_kernel), which replace the Pallas TPU kernels
// _prop_kernel, _fid_kernel (universal_quantum_optimal_control_tpu/ops/
// propagate_pallas.py) and _bwd_kernel (ops/propagate_pallas_bwd.py).
//
// A sample is one (target, disorder draw): delta, eps and the target's
// staged pulse row; segment k is the unit quaternion
//   q_k = (cos x, sin x / n * (Omega cos phi, Omega sin phi, z)),
//   x = tau (1 + eps) / 2 * n,  n = |(Omega cos phi, Omega sin phi, z)|,
// z = delta (+ Delta at P = 4), Omega = 1 at P = 2 (as core/su2.py), and the
// sample's product is Q = q_{L-1} o ... o q_0.
//
// What the code is shaped by: on an H100 these kernels are bound by issued
// instructions, one warp instruction per scheduler per clock, and the
// arithmetic bound credits every one of them with an FMA.  So a segment is
// written for few instructions:
//   * the staged row holds one 16-byte record per segment (two at P >= 3),
//     read by one broadcast LDS.128: (cos phi, sin phi, tau, 0) at P = 2;
//     (Omega cos phi, Omega sin phi, tau, Delta) and (cos phi, sin phi,
//     Omega, Omega^2) at P >= 3, Omega clamped at 0, Delta = 0 at P = 3;
//   * the half angle's sin and cos come from the JAX kernel's default
//     polynomial (propagate_pallas.py:_sincos_poly), a minimax pair, sin
//     degree 9, cos degree 10 (see kC1): 11 instructions for both, where
//     libm's sincosf spends about three times that and a branch.  It is
//     taken where every angle of the sample is within |x| <= kPolyMax =
//     pi / 2, where the JAX kernel's Cody-Waite step by pi is the identity
//     (every shipped pulse space's are: tau <= 0.5); a sample whose angles
//     may pass that (angle_bound) runs the same loop with libm's sincosf
//     instead, so every input stays right.  Both give sin x and cos x with
//     their signs, so B3's quaternions, which leave the kernel, are right
//     as they are;
//   * the per-sample factors are hoisted (at P = 2 the axis norm
//     sqrt(1 + delta^2) does not depend on the segment);
//   * the staged row is padded with identity segments (tau = 0) to a
//     multiple of kChunk, and the loops run kChunk segments a turn, so the
//     loop's bookkeeping and the record addresses leave the loop body.
//
// The drive phase phi is staged with libm's sincosf, once per segment.
//
// B2's reverse sweep reads B3's product Q instead of rebuilding it.  With
// Q = L_k o q_k o R_k split at segment k, the cotangent of q_k is
// A_k = conj(L_k) o g o conj(R_k), and
//   A_{L-1} = g o conj(Q) o q_{L-1},  A_{k-1} = conj(q_k) o A_k o q_{k-1},
// two Hamilton products a segment (a sweep that rebuilds Q and carries
// R_k and conj(L_k) o g takes four).  The sum of the pulse cotangents over the
// samples is B2's: each lane keeps its kChunk * P values of a chunk in
// registers and a butterfly reduce-scatter over the warp (reduce_scatter)
// leaves lane j with the warp's sum of value j, in a fixed order.
//
// The host build (tests/test_torch_su2_host.py, g++ -std=c++20 -pthread)
// defines the CUDA qualifiers away and supplies the hook itself: the warp's
// lanes as std::threads meeting at a std::barrier for lane_xor (lane_index:
// the thread's lane).  The code uses nothing else of CUDA but fmaf, fmaxf,
// sqrtf and sincosf.

#pragma once

namespace su2 {

#ifdef __CUDACC__
// The hook on the card: a warp's lanes exchanging values (every lane of the
// warp takes part in every call).
__device__ __forceinline__ int lane_index() { return threadIdx.x & 31; }
__device__ __forceinline__ float lane_xor(float v, int m) {
  return __shfl_xor_sync(0xffffffffu, v, m);
}
#endif

// Minimax polynomials on [-pi/2, pi/2], leading terms pinned: sin degree 9,
// the JAX kernel's (propagate_pallas.py:_sincos_core, the "poly" default);
// cos degree 10, one term past the JAX kernel's degree 8, whose error (up
// to 7e-8) is one-sided where the half angles lie: it grew |q| by ~2e-8 a segment, and at L = 100
// took the mean fidelity 9x as far from f64 as libm's sincosf (8.8e-7
// against 7.4e-9 on 4 x 20 000 samples, host build).  Degree 10 (Lawson
// fit, f32 coefficients: max error 5e-9) matches libm there.
constexpr float kS1 = -1.66666567e-01f, kS2 = 8.33301032e-03f, kS3 = -1.98062014e-04f,
                kS4 = 2.59927677e-06f;
constexpr float kC1 = -5.0e-01f, kC2 = 4.166664183e-02f, kC3 = -1.388840377e-03f,
                kC4 = 2.476188638e-05f, kC5 = -2.607710599e-07f;
// The polynomials' range, pi / 2 (the f32 number just under it): within it
// tests/test_torch_su2_host.py holds sin and cos to f64 within 2e-7; past
// it, libm's sincosf
constexpr float kPolyMax = 1.5707963f;

// Segments a loop turn: the row is padded to a multiple (identity segments)
constexpr int kChunk = 4;

// Staged records per segment
template <int P>
constexpr int kRecs = P == 2 ? 1 : 2;

// Records of a staged row of Lp segments: at P = 2 one a segment, then one
// a pair of segments (stage_unit); at P >= 3 two a segment.
template <int P>
__device__ __forceinline__ int row_records(int Lp) {
  return P == 2 ? Lp + Lp / 2 : 2 * Lp;
}

// Units the staging loop runs over: pairs of segments at P = 2, segments
// at P >= 3.
template <int P>
__device__ __forceinline__ int stage_units(int Lp) {
  return P == 2 ? Lp / 2 : Lp;
}

struct Quat {
  float w, x, y, z;
};

__device__ __forceinline__ Quat conj(const Quat& q) { return {q.w, -q.x, -q.y, -q.z}; }

// p o q (maps to U(p) U(q)): 4 products and 12 FMAs.
__device__ __forceinline__ Quat hamilton(const Quat& p, const Quat& q) {
  Quat r;
  r.w = fmaf(p.w, q.w, -fmaf(p.x, q.x, fmaf(p.y, q.y, p.z * q.z)));
  r.x = fmaf(p.w, q.x, fmaf(p.x, q.w, fmaf(p.y, q.z, -(p.z * q.y))));
  r.y = fmaf(p.w, q.y, fmaf(p.y, q.w, fmaf(p.z, q.x, -(p.x * q.z))));
  r.z = fmaf(p.w, q.z, fmaf(p.z, q.w, fmaf(p.x, q.y, -(p.y * q.x))));
  return r;
}

__device__ __forceinline__ float absf(float x) { return fmaxf(x, -x); }

// sin x and cos x by the polynomials, |x| <= kPolyMax.  The flagship's half
// angles, tau (1 + eps) / 2 sqrt(1 + delta^2) with tau <= 0.5 and |delta| <=
// 5, all lie there.
struct PolyTrig {
  __device__ static __forceinline__ void eval(float x, float& s, float& c) {
    const float x2 = x * x;
    float p = fmaf(x2, kS4, kS3);
    p = fmaf(x2, p, kS2);
    p = fmaf(x2, p, kS1);
    s = fmaf(x * x2, p, x);
    float u = fmaf(x2, kC5, kC4);
    u = fmaf(x2, u, kC3);
    u = fmaf(x2, u, kC2);
    u = fmaf(x2, u, kC1);
    c = fmaf(x2, u, 1.0f);
  }
};

// libm's sincosf, for samples whose angles may pass kPolyMax.
struct LibmTrig {
  __device__ static __forceinline__ void eval(float x, float& s, float& c) {
    sincosf(x, &s, &c);
  }
};

// The records of segment k from its P pulse values p (phi, [Omega, [Delta,]]
// tau), or an identity segment where p is null (the padding); t0 / t1 take
// the max of |tau| and |tau| sqrt(Omega^2 + Delta^2) for angle_bound.
template <int P>
__device__ inline void stage_segment(const float* p, float4* rec, float& t0, float& t1) {
  if (p == nullptr) {
    rec[0] = {P == 2 ? 1.0f : 0.0f, 0.0f, 0.0f, 0.0f};
    if constexpr (P >= 3) rec[1] = {1.0f, 0.0f, 0.0f, 0.0f};
    return;
  }
  float s, c;
  sincosf(p[0], &s, &c);
  const float tau = p[P - 1];
  t0 = fmaxf(t0, absf(tau));
  if constexpr (P == 2) {
    rec[0] = {c, s, tau, 0.0f};
  } else {
    const float om = fmaxf(p[1], 0.0f);
    const float det = P == 4 ? p[2] : 0.0f;
    rec[0] = {om * c, om * s, tau, det};
    rec[1] = {c, s, om, om * om};
    t1 = fmaxf(t1, absf(tau) * sqrtf(fmaf(det, det, om * om)));
  }
}

// Unit u of the staged row of the target's L segments of pulses p (Lp
// padded): at P >= 3 segment u; at P = 2 segments a = 2u, b = 2u + 1 and
// what their product q_b o q_a takes besides each one's record (pair2):
// a.w = cos(phi_b - phi_a), b.w = sin(phi_a - phi_b) and the pair's record
// (sin phi_b - sin phi_a, cos phi_a - cos phi_b, 0, 0) after the Lp
// segments' records.
template <int P>
__device__ inline void stage_unit(const float* p, int L, int Lp, int u, float4* row, float& t0,
                                  float& t1) {
  if constexpr (P == 2) {
    const int k = 2 * u;
    float4* a = row + k;
    float4* b = a + 1;
    stage_segment<2>(k < L ? p + 2 * k : nullptr, a, t0, t1);
    stage_segment<2>(k + 1 < L ? p + 2 * k + 2 : nullptr, b, t0, t1);
    const float c = fmaf(a->x, b->x, a->y * b->y);
    const float s = fmaf(a->y, b->x, -(a->x * b->y));
    a->w = c;
    b->w = s;
    row[Lp + u] = {b->y - a->y, a->x - b->x, 0.0f, 0.0f};
  } else {
    stage_segment<P>(u < L ? p + P * u : nullptr, row + kRecs<P> * u, t0, t1);
  }
}

// A bound on the sample's |x| over the row: |tau| sqrt(1 + delta^2) (1 + eps)
// / 2 at P = 2 (exact: the loop forms x from the same factors), and
// (max |tau| sqrt(Omega^2 + Delta^2) + max |tau| |delta|) |1 + eps| / 2 at
// P >= 3 (the triangle inequality).  A NaN bound fails <= kPolyMax.
template <int P>
__device__ __forceinline__ float angle_bound(float t0, float t1, float d, float e) {
  const float h = absf(0.5f * (1.0f + e));
  if constexpr (P == 2) return t0 * (h * sqrtf(fmaf(d, d, 1.0f)));
  return h * fmaf(t0, absf(d), t1);
}

// Segment k of a sample and the factors its chain rule reuses.
struct Segment {
  Quat q;
  float4 r, r1;              // the staged records (r1 at P >= 3 only)
  float sn, c, s, n, inv, z;  // sin x, cos x, sin x / n; at P >= 3 n, 1 / n, z
};

// The sample's factors that no segment changes.
template <int P>
struct Sample {
  float d, h, n, inv, scale;  // n, inv, scale = h n: the P = 2 axis norm
  __device__ __forceinline__ Sample(float delta, float eps) : d(delta) {
    h = 0.5f * (1.0f + eps);
    n = inv = scale = 0.0f;
    if constexpr (P == 2) {
      n = sqrtf(fmaf(delta, delta, 1.0f));
      inv = 1.0f / n;
      scale = h * n;
    }
  }
};

// Segment k: at P = 2 from its record (cos phi, sin phi, tau, 0); at P >= 3
// also the axis norm n = |(Omega cos phi, Omega sin phi, z)|, its square
// floored at 1e-24 as core/su2.py::_axis_norm floors it.
template <int P, class Trig>
__device__ __forceinline__ Segment segment(const float4* row, int k, const Sample<P>& sm) {
  Segment g;
  g.r = row[kRecs<P> * k];
  const float tau = g.r.z;
  if constexpr (P == 2) {
    Trig::eval(tau * sm.scale, g.sn, g.c);
    g.s = g.sn * sm.inv;
    g.q = {g.c, g.s * g.r.x, g.s * g.r.y, g.s * sm.d};
  } else {
    g.r1 = row[kRecs<P> * k + 1];
    g.z = P == 4 ? g.r.w + sm.d : sm.d;
    g.n = sqrtf(fmaxf(fmaf(g.z, g.z, g.r1.w), 1e-24f));
    g.inv = 1.0f / g.n;
    Trig::eval(tau * (sm.h * g.n), g.sn, g.c);
    g.s = g.sn * g.inv;
    g.q = {g.c, g.s * g.r.x, g.s * g.r.y, g.s * g.z};
  }
  return g;
}

// P = 2: the product q_b o q_a of segments a = k and b = k + 1 (k even)
// from the pair's staged terms (stage_unit), with q = (cos x, s u),
// u = (cos phi, sin phi, delta), s = sin x / n:
//   q_b o q_a = (c_b c_a - s_b s_a (u_b . u_a),
//                c_b s_a u_a + c_a s_b u_b + s_b s_a (u_b x u_a)),
// u_b . u_a = cos(phi_b - phi_a) + delta^2,
// u_b x u_a = (delta (sin phi_b - sin phi_a), delta (cos phi_a - cos phi_b),
//              sin(phi_a - phi_b)):
// 16 instructions where two segment builds (8) and a Hamilton product (16)
// would take 24.
template <class Trig>
__device__ __forceinline__ Quat pair2(const float4* row, int Lp, int k, const Sample<2>& sm,
                                      float d2) {
  const float4 a = row[k], b = row[k + 1], x = row[Lp + k / 2];
  float sna, ca, snb, cb;
  Trig::eval(a.z * sm.scale, sna, ca);
  Trig::eval(b.z * sm.scale, snb, cb);
  const float sa = sna * sm.inv, sb = snb * sm.inv;
  const float ss = sb * sa, al = cb * sa, be = ca * sb, ga = ss * sm.d;
  Quat p;
  p.w = fmaf(-ss, a.w + d2, cb * ca);
  p.x = fmaf(al, a.x, fmaf(be, b.x, ga * x.x));
  p.y = fmaf(al, a.y, fmaf(be, b.y, ga * x.y));
  p.z = fmaf(sm.d, al + be, ss * b.w);
  return p;
}

// The product Q = q_{Lp-1} o ... o q_0 of one sample over the staged row of
// Lp segments (a multiple of kChunk): at P = 2 a pair of segments at a time
// (pair2).
template <int P, class Trig>
__device__ inline Quat compose(const float4* row, int Lp, float delta, float eps) {
  const Sample<P> sm(delta, eps);
  Quat q = {1.0f, 0.0f, 0.0f, 0.0f};
  if constexpr (P == 2) {
    const float d2 = delta * delta;
    for (int k0 = 0; k0 < Lp; k0 += kChunk) {
#pragma unroll
      for (int j = 0; j < kChunk; j += 2)
        q = hamilton(pair2<Trig>(row, Lp, k0 + j, sm, d2), q);
    }
  } else {
    for (int k0 = 0; k0 < Lp; k0 += kChunk) {
#pragma unroll
      for (int j = 0; j < kChunk; ++j) q = hamilton(segment<P, Trig>(row, k0 + j, sm).q, q);
    }
  }
  return q;
}

// The warp's sum of value lane / (32 / N) of v, N a power of 2 up to 32,
// left in every lane that shares that value: at each of log2(N) levels a
// lane keeps half of its values and adds the half its partner lane ^ m kept
// (m = 16, 8, ...), then the 32 / N lanes that share a value add theirs.
// One lane_xor per level and pair: N - 1 plus 5 - log2(N) exchanges for N
// values.  The order of the additions is fixed, so is the result.
template <int N>
__device__ __forceinline__ float reduce_scatter(float (&v)[N]) {
  static_assert(N >= 1 && N <= 32 && (N & (N - 1)) == 0, "a power of 2 up to 32");
  int m = 16;
#pragma unroll
  for (int n = N; n > 1; n >>= 1, m >>= 1) {
    const bool upper = (lane_index() & m) != 0;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float send = upper ? v[i] : v[n / 2 + i];
      const float keep = upper ? v[n / 2 + i] : v[i];
      v[i] = keep + lane_xor(send, m);
    }
  }
  float s = v[0];
#pragma unroll
  for (; m >= 1; m >>= 1) s = s + lane_xor(s, m);
  return s;
}

// Values a chunk's reduce-scatter takes: kChunk * P rounded up to a power of 2
template <int P>
constexpr int kChunkValues = P == 2 ? 8 : 16;

// B2's sink: a chunk's values summed over the warp into the warp's slot
// red[Lp * P] (value (k, p) at k P + p), by the first lane that holds each.
template <int P>
struct WarpSink {
  float* red;
  __device__ __forceinline__ void operator()(int k0, float (&v)[kChunkValues<P>]) const {
    constexpr int NV = kChunkValues<P>;
    const float s = reduce_scatter<NV>(v);
    const int lane = lane_index();
    const int j = lane / (32 / NV);
    if (lane % (32 / NV) == 0 && j < kChunk * P) red[k0 * P + j] = s;
  }
};

// B2's reverse sweep of one sample over the staged row of Lp segments: from
// B3's product Q and the cotangent g of Q, the cotangents of the sample's
// delta and eps into dd, de, and each segment's P pulse cotangents handed
// to sink(k0, v) a chunk at a time: v[j P + p] is channel p of segment
// k0 + j (phi, [Omega, [Delta,]] tau), the rest of v zero.
//
// A_k = X o (Y o q_k) with (X, Y) = (g, conj(Q)) at k = Lp - 1 and
// (conj(q_{k+1}), A_{k+1}) below.
//
// Chain rule at segment k, with T = <A_k, dq_k/dx> = c inv proj - sn A_w,
// proj = <A_vec, (Omega cos phi, Omega sin phi, z)> and dx = x / tau dtau +
// tau n / 2 deps + ...:
//   dphi = s <A, (0, -Omega sin phi, Omega cos phi, 0)>,  dtau = h n T,
//   deps += tau n T / 2,  dz = tau h z inv T + s (A_z - z inv^2 proj),
//   dOmega = tau h Omega inv T + s (A_xy - Omega inv^2 proj)  (Omega > 0),
// z shared by delta and, at P = 4, Delta.  At P = 2 the per-sample factors
// go outside the sum: deps = n / 2 S1 and ddelta = h delta inv S1 + S2 with
// S1 = sum tau T and S2 = sum s (A_z - delta inv^2 proj).
template <int P, class Trig, class Sink>
__device__ inline void sweep(const float4* row, int Lp, float delta, float eps,
                                      const Quat& Q, const Quat& g, float& dd, float& de,
                                      Sink& sink) {
  constexpr int NV = kChunkValues<P>;
  const Sample<P> sm(delta, eps);
  Quat X = g, Y = conj(Q);
  float s1 = 0.0f, s2 = 0.0f;
  float dinv2 = 0.0f;
  if constexpr (P == 2) dinv2 = delta * (sm.inv * sm.inv);
  dd = 0.0f;
  for (int k0 = Lp - kChunk; k0 >= 0; k0 -= kChunk) {
    float v[NV];
#pragma unroll
    for (int i = kChunk * P; i < NV; ++i) v[i] = 0.0f;
#pragma unroll
    for (int j = kChunk - 1; j >= 0; --j) {
      const Segment sg = segment<P, Trig>(row, k0 + j, sm);
      const Quat a = hamilton(X, hamilton(Y, sg.q));
      // (r.x, r.y) = Omega (cos phi, sin phi); Omega = 1 at P = 2
      const float oaxy = fmaf(a.x, sg.r.x, a.y * sg.r.y);
      const float dphi = sg.s * fmaf(a.y, sg.r.x, -(a.x * sg.r.y));
      const float tau = sg.r.z;
      if constexpr (P == 2) {
        const float proj = fmaf(a.z, delta, oaxy);
        const float t = fmaf(sg.c * sm.inv, proj, -(sg.sn * a.w));
        v[j * P] = dphi;
        v[j * P + 1] = sm.scale * t;
        s1 = fmaf(tau, t, s1);
        s2 = fmaf(sg.s, fmaf(-dinv2, proj, a.z), s2);
      } else {
        // r1 = (cos phi, sin phi, Omega, Omega^2)
        const float proj = fmaf(a.z, sg.z, oaxy);
        const float t = fmaf(sg.c * sg.inv, proj, -(sg.sn * a.w));
        const float inv2 = sg.inv * sg.inv;
        const float th = tau * sm.h * sg.inv * t;
        const float dz = fmaf(th, sg.z, sg.s * fmaf(-sg.z * inv2, proj, a.z));
        const float axy = fmaf(a.x, sg.r1.x, a.y * sg.r1.y);
        const float dom = fmaf(th, sg.r1.z, sg.s * fmaf(-sg.r1.z * inv2, proj, axy));
        v[j * P] = dphi;
        v[j * P + 1] = sg.r1.z > 0.0f ? dom : 0.0f;
        if constexpr (P == 4) v[j * P + 2] = dz;
        v[j * P + P - 1] = (sm.h * sg.n) * t;
        s1 = fmaf(tau * sg.n, t, s1);
        dd = dd + dz;
      }
      X = conj(sg.q);
      Y = a;
    }
    sink(k0, v);
  }
  if constexpr (P == 2) {
    dd = fmaf(sm.h * delta * sm.inv, s1, s2);
    de = (0.5f * sm.n) * s1;
  } else {
    de = 0.5f * s1;
  }
}

}  // namespace su2
