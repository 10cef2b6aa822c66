"""PyTorch port, SU(2) kernels B1, B2 and B3: their per-sample math,
compiled for the host.

``ops/csrc/su2.cuh`` holds the per-sample math of the three SU(2) kernels:
the staged records (``stage_segment()``), the polynomial sincos
(``PolyTrig``) and the libm one it hands angles past π/2 to (``LibmTrig``,
chosen per sample by ``angle_bound()``), the product (``compose()``: B3 and
B1), B2's reverse sweep from the product (``sweep()``) and its sum over a
warp (``reduce_scatter()``, ``WarpSink``).  They use nothing of CUDA but
``fmaf``, ``fmaxf``, ``sqrtf``, ``sincosf`` and the hook
(``lane_index()``, ``lane_xor()``), so a C++ compiler builds them for the
CPU with the CUDA qualifiers defined away and the hook defined here: a
warp's 32 lanes run as ``std::thread``\\ s that meet at a ``std::barrier``
(``g++ -std=c++20 -pthread``), and a target's samples run as the kernel
runs them (B2: blocks of two warps, the block's warps summed in order, the
blocks' partials summed in double in block order, samples past M with
zero cotangent).  Two builds:

* plain floats: the polynomial sincos against f64 over its range, and the
  libm one past it; ``compose()`` against the port's plain version in f64
  at B3's tolerance (``chip_smoke.quat_tol``), L ∈ {1, 7, 100}; the sweep,
  seeded with the host's product, against autograd through the plain
  version in f64 (the JAX suite's gradient tolerances, at L = 100 widened
  to twice the plain f32 version's own error as ``chip_smoke.grads_close``
  widens them), and the same bits on two runs; the reduce-scatter against
  a fixed-order sum, with a ragged M;
* a float that counts its operations (an FMA counts 2, a negation 0): the
  flops per segment and per sample of ``compose()`` and of ``sweep()`` with
  one add per pulse cotangent for the sum over samples must be the counts
  ``chip_smoke.py`` takes its B1, B3 and B2 bounds from.

Skipped where no ``g++`` is on the PATH.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su2 as tk

HEADER = Path(tk.__file__).parent / "csrc" / "su2.cuh"
POLY_MAX = 1.5707963  # su2.cuh::kPolyMax
SINCOS_TOL = 2e-7  # su2.cuh's claim for the polynomial within |x| <= kPolyMax

PRELUDE = r"""
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <thread>
#include <vector>
#ifdef COUNT_FLOPS
static long long nflops = 0;
struct CF {
  float v;
  constexpr CF() : v(0) {}
  constexpr CF(double x) : v(static_cast<float>(x)) {}
};
inline CF operator+(CF a, CF b) { ++nflops; return CF(a.v + b.v); }
inline CF operator-(CF a, CF b) { ++nflops; return CF(a.v - b.v); }
inline CF operator*(CF a, CF b) { ++nflops; return CF(a.v * b.v); }
inline CF operator/(CF a, CF b) { ++nflops; return CF(a.v / b.v); }
inline CF operator-(CF a) { return CF(-a.v); }
inline bool operator>(CF a, CF b) { return a.v > b.v; }
inline CF fmaf(CF a, CF b, CF c) { nflops += 2; return CF(std::fma(a.v, b.v, c.v)); }
inline CF fmaxf(CF a, CF b) { return CF(std::fmax(a.v, b.v)); }
inline CF sqrtf(CF a) { ++nflops; return CF(std::sqrt(a.v)); }
inline void sincosf(CF x, CF* s, CF* c) { s->v = std::sin(x.v); c->v = std::cos(x.v); }
#define float CF
#endif
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
struct alignas(16) float4 { float x, y, z, w; };

// The hook: a warp's lanes are threads meeting at one barrier, as a warp's
// lanes meet at a shuffle.
static std::barrier<>* warp_barrier = nullptr;
static thread_local int lane_id = 0;
static float xch[32];
inline int lane_index() { return lane_id; }
inline float lane_xor(float v, int m) {
  xch[lane_id] = v;
  warp_barrier->arrive_and_wait();
  const float r = xch[lane_id ^ m];
  warp_barrier->arrive_and_wait();
  return r;
}
"""

MAIN = r"""
using su2::Quat;

// The staged row of one target, as the kernels' stage_row stages it.
template <int P>
struct Row {
  std::vector<float4> rec;
  int Lp;
  float t0 = 0.0f, t1 = 0.0f;
};

template <int P>
Row<P> stage(const float* pulses, int L) {
  Row<P> r;
  r.Lp = (L + su2::kChunk - 1) / su2::kChunk * su2::kChunk;
  r.rec.resize(su2::row_records<P>(r.Lp));
  for (int u = 0; u < su2::stage_units<P>(r.Lp); ++u)
    su2::stage_unit<P>(pulses, L, r.Lp, u, r.rec.data(), r.t0, r.t1);
  return r;
}

#ifdef COUNT_FLOPS
#undef float
struct CountSink {
  CF acc;
  void operator()(int, CF (&v)[16]) { for (int i = 0; i < 16; ++i) acc = acc + v[i]; }
  void operator()(int, CF (&v)[8]) { for (int i = 0; i < 8; ++i) acc = acc + v[i]; }
};

// flops of one sample over L = 4 and L = 8 segments: compose(), then the
// sweep with one add per pulse cotangent (the sum over samples); per P.
template <int P>
void count(const CF* pulses) {
  for (int L = 4; L <= 8; L += 4) {
    const Row<P> r = stage<P>(pulses, L);
    nflops = 0;
    su2::compose<P, su2::PolyTrig>(r.rec.data(), r.Lp, CF(0.3), CF(0.02));
    printf("%lld\n", nflops);
  }
  for (int L = 4; L <= 8; L += 4) {
    const Row<P> r = stage<P>(pulses, L);
    CountSink sink{CF(0.0)};
    CF dd, de;
    nflops = 0;
    su2::sweep<P, su2::PolyTrig>(r.rec.data(), r.Lp, CF(0.3), CF(0.02),
                                 Quat{CF(0.5), CF(0.5), CF(0.5), CF(0.5)},
                                 Quat{CF(0.1), CF(0.2), CF(0.3), CF(0.4)}, dd, de, sink);
    // the sink's adds take kChunk P values a chunk (the rest are padding)
    printf("%lld\n", nflops - (su2::kChunkValues<P> - su2::kChunk * P) * (L / su2::kChunk));
  }
}

// Lines: for P = 2, 3, 4: compose() at L = 4, 8, then the sweep at L = 4, 8.
int main() {
  CF pulses[32];
  for (int i = 0; i < 32; ++i) pulses[i] = CF(0.1 + 0.37 * i - 0.011 * i * i);
  count<2>(pulses);
  count<3>(pulses);
  count<4>(pulses);
}
#else
// The kernels' choice per sample: 0 the polynomial, 1 libm.
template <int P>
int trig_path(const Row<P>& r, float d, float e) {
  return su2::angle_bound<P>(r.t0, r.t1, d, e) <= su2::kPolyMax ? 0 : 1;
}

template <int P>
Quat compose(const Row<P>& r, int path, float d, float e) {
  if (path == 0) return su2::compose<P, su2::PolyTrig>(r.rec.data(), r.Lp, d, e);
  return su2::compose<P, su2::LibmTrig>(r.rec.data(), r.Lp, d, e);
}

// B2's sum over samples as the kernel forms it: the chunk's values summed
// into a warp's slot by reduce_scatter (WarpSink), the block's two warps in
// order, then the blocks' partials in double in block order; libm's sincos
// where any of the warp's samples needs it.
template <int P>
void sweep_target(const Row<P>& r, int L, long M, const float* d, const float* e,
                  const float* g, const float* q, double* dpulses, float* dd, float* de) {
  constexpr int kBlock = 64, kWarps = 2;
  const int lp = r.Lp * P;
  const long nblk = (M + kBlock - 1) / kBlock;
  std::vector<double> col(L * P, 0.0);
  std::vector<float> red(kWarps * lp);
  for (long x = 0; x < nblk; ++x) {
    for (int w = 0; w < kWarps; ++w) {
      int path = 0;
      for (int l = 0; l < 32; ++l) {
        const long m = x * kBlock + w * 32 + l;
        path = std::max(path, trig_path<P>(r, m < M ? d[m] : 0.0f, m < M ? e[m] : 0.0f));
      }
      std::barrier<> bar(32);
      warp_barrier = &bar;
      std::vector<std::thread> lanes;
      for (int l = 0; l < 32; ++l)
        lanes.emplace_back([&, l] {
          lane_id = l;
          const long m = x * kBlock + w * 32 + l;
          const bool active = m < M;
          const float dm = active ? d[m] : 0.0f, em = active ? e[m] : 0.0f;
          Quat Q = {1.0f, 0.0f, 0.0f, 0.0f}, G = {0.0f, 0.0f, 0.0f, 0.0f};
          if (active) {
            Q = {q[4 * m], q[4 * m + 1], q[4 * m + 2], q[4 * m + 3]};
            G = {g[4 * m], g[4 * m + 1], g[4 * m + 2], g[4 * m + 3]};
          }
          const su2::WarpSink<P> sink{red.data() + w * lp};
          float a, b;
          if (path == 0)
            su2::sweep<P, su2::PolyTrig>(r.rec.data(), r.Lp, dm, em, Q, G, a, b, sink);
          else
            su2::sweep<P, su2::LibmTrig>(r.rec.data(), r.Lp, dm, em, Q, G, a, b, sink);
          if (active) {
            dd[m] = a;
            de[m] = b;
          }
        });
      for (auto& t : lanes) t.join();
    }
    for (int j = 0; j < L * P; ++j) {
      float s = 0.0f;
      for (int w = 0; w < kWarps; ++w) s += red[w * lp + j];
      col[j] += s;
    }
  }
  for (int j = 0; j < L * P; ++j) dpulses[j] = static_cast<float>(col[j]);
}

template <int P>
void run(int mode, int B, int L, long M, const std::vector<float>& pulses,
         const std::vector<float>& d, const std::vector<float>& e, const std::vector<float>& g,
         const std::vector<float>& q) {
  for (int b = 0; b < B; ++b) {
    const Row<P> r = stage<P>(&pulses[b * L * P], L);
    const float *db = &d[b * M], *eb = &e[b * M];
    if (mode == 1) {
      // per sample: the path and the product (compose)
      for (long m = 0; m < M; ++m) {
        const int path = trig_path<P>(r, db[m], eb[m]);
        const Quat s = compose<P>(r, path, db[m], eb[m]);
        printf("%d %.9g %.9g %.9g %.9g\n", path, s.w, s.x, s.y, s.z);
      }
    } else {
      // dpulses (L P), dd (M), de (M), in the kernel's order
      std::vector<double> dp(L * P);
      std::vector<float> dd(M), de(M);
      const float *gb = &g[4 * b * M], *qb = &q[4 * b * M];
      sweep_target<P>(r, L, M, db, eb, gb, qb, dp.data(), dd.data(), de.data());
      for (double x : dp) printf("%.9g\n", x);
      for (long m = 0; m < M; ++m) printf("%.9g %.9g\n", dd[m], de[m]);
    }
  }
}

// The warp's reduce-scatter of N values a lane, lanes >= active holding 0:
// per lane its result, twice (two runs).
template <int N>
void reduce(int active, const std::vector<float>& vals) {
  for (int run = 0; run < 2; ++run) {
    float out[32];
    std::barrier<> bar(32);
    warp_barrier = &bar;
    std::vector<std::thread> lanes;
    for (int l = 0; l < 32; ++l)
      lanes.emplace_back([&, l] {
        lane_id = l;
        float v[N];
        for (int i = 0; i < N; ++i) v[i] = l < active ? vals[l * N + i] : 0.0f;
        out[l] = su2::reduce_scatter<N>(v);
      });
    for (auto& t : lanes) t.join();
    for (int l = 0; l < 32; ++l) printf("%.9g\n", out[l]);
  }
}

// stdin: mode, then
//   mode 0: n, x (n): per x the polynomial's sin, cos, then libm's;
//   mode 1: B L P M, pulses (B L P), delta, eps (B M): per sample the path
//           and the product (compose);
//   mode 2: B L P M, pulses, delta, eps, g (B M 4), q (B M 4): per target
//           the sweep's outputs;
//   mode 3: N active, values (32 N): the reduce-scatter, twice.
int main() {
  int mode;
  if (scanf("%d", &mode) != 1) return 1;
  auto read = [](std::vector<float>& v) {
    for (auto& x : v)
      if (scanf("%f", &x) != 1) return false;
    return true;
  };
  if (mode == 0) {
    long n;
    if (scanf("%ld", &n) != 1) return 1;
    std::vector<float> xs(n);
    if (!read(xs)) return 1;
    for (float x : xs) {
      float s, c, ls, lc;
      su2::PolyTrig::eval(x, s, c);
      su2::LibmTrig::eval(x, ls, lc);
      printf("%.9g %.9g %.9g %.9g\n", s, c, ls, lc);
    }
    return 0;
  }
  if (mode == 3) {
    int N, active;
    if (scanf("%d %d", &N, &active) != 2) return 1;
    std::vector<float> vals(32 * N);
    if (!read(vals)) return 1;
    if (N == 8) reduce<8>(active, vals);
    if (N == 16) reduce<16>(active, vals);
    return 0;
  }
  int B, L, P;
  long M;
  if (scanf("%d %d %d %ld", &B, &L, &P, &M) != 4) return 1;
  std::vector<float> pulses(B * L * P), d(B * M), e(B * M), g(mode == 2 ? 4 * B * M : 0),
      q(mode == 2 ? 4 * B * M : 0);
  if (!(read(pulses) && read(d) && read(e) && read(g) && read(q))) return 1;
  if (P == 2) run<2>(mode, B, L, M, pulses, d, e, g, q);
  if (P == 3) run<3>(mode, B, L, M, pulses, d, e, g, q);
  if (P == 4) run<4>(mode, B, L, M, pulses, d, e, g, q);
  return 0;
}
#endif
"""


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    """``{"math": exe, "count": exe}`` built from the kernels' header."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH to build the SU(2) math for the host")
    out = tmp_path_factory.mktemp("su2_host")
    cpp = out / "su2_host.cpp"
    cpp.write_text(PRELUDE + HEADER.read_text().replace("#pragma once", "") + MAIN)
    exes = {}
    for name, flags in (("math", []), ("count", ["-DCOUNT_FLOPS"])):
        exes[name] = out / name
        subprocess.run(["g++", "-std=c++20", "-pthread", "-O1", "-ffp-contract=off",
                        "-Wno-unknown-pragmas", *flags, "-o", str(exes[name]), str(cpp)],
                       check=True, capture_output=True, text=True)
    return exes


def run_host(exe, *header, arrays=()):
    flat = [np.asarray(a, np.float32).ravel() for a in arrays]
    body = " ".join(f"{x:.9g}" for x in np.concatenate(flat)) if flat else ""
    stdin = " ".join(str(h) for h in header) + "\n" + body
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, text=True,
                         check=True).stdout
    return np.array(out.split(), dtype=np.float64)


def pulse_case(P, B, L, M, seed, tau=(0.05, 0.5)):
    """Pulses as the kernel tests draw them (some Ω < 0 for the clamp), δ at
    σ = 1 and ε at 0.05."""
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(-np.pi, np.pi, (B, L))]
    if P >= 3:
        cols.append(rng.uniform(-0.3, 1.5, (B, L)))
    if P == 4:
        cols.append(rng.uniform(-1.0, 1.0, (B, L)))
    cols.append(rng.uniform(*tau, (B, L)))
    pulses = np.stack(cols, -1).astype(np.float32)
    delta = rng.standard_normal((B, M)).astype(np.float32)
    eps = (0.05 * rng.standard_normal((B, M))).astype(np.float32)
    return rng, pulses, delta, eps


def host_compose(host_builds, pulses, delta, eps):
    B, L, P = pulses.shape
    M = delta.shape[1]
    out = run_host(host_builds["math"], 1, B, L, P, M, arrays=(pulses, delta, eps))
    out = out.reshape(B, M, 5)
    return out[..., 0], out[..., 1:]


def test_poly_sincos_against_f64_and_libm_past_its_range(host_builds):
    """The polynomial within 2e-7 of f64 over |x| ≤ kPolyMax = π/2 (slightly
    past it, for the rounding of the per-sample bound), and libm's sincosf,
    the path past it, within 2e-7 there too, where the polynomial is off by
    more than ten times that."""
    rng = np.random.default_rng(0)
    inside = np.concatenate([np.linspace(-1.001 * POLY_MAX, 1.001 * POLY_MAX, 200_001),
                             rng.uniform(-POLY_MAX, POLY_MAX, 50_000),
                             [-POLY_MAX, 0.0, POLY_MAX]]).astype(np.float32)
    outside = np.asarray([2.5, -3.0, 10.0, 1.1e3, -5e3, 3.3e4, 1e5, -2.5e6, 1e7, 3e7],
                         np.float32)
    xs = np.concatenate([inside, outside])
    out = run_host(host_builds["math"], 0, len(xs), arrays=(xs,)).reshape(-1, 4)
    x64 = xs.astype(np.float64)
    ref = np.stack([np.sin(x64), np.cos(x64)], -1)
    n = len(inside)
    poly_err = np.abs(out[:n, :2] - ref[:n]).max()
    libm_err = np.abs(out[n:, 2:4] - ref[n:]).max()
    print(f"polynomial |x| <= {1.001 * POLY_MAX}: max error {poly_err:.3e}; libm past it "
          f"{libm_err:.3e}")
    assert poly_err <= SINCOS_TOL
    assert libm_err <= SINCOS_TOL
    assert np.abs(out[n:, :2] - ref[n:]).max() > 10 * SINCOS_TOL


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("L", [1, 7, 100])
def test_compose_against_plain_f64(host_builds, P, L):
    """``compose()`` (B3's and B1's product) against the plain version in
    f64 at B3's tolerance; M = 37."""
    _, pulses, delta, eps = pulse_case(P, 2, L, 37, 10 * P + L)
    path, q = host_compose(host_builds, pulses, delta, eps)
    assert (path == 0).all()  # every angle below π/2: the polynomial
    ref = tk.propagate_mc_plain(*(torch.from_numpy(a).double() for a in (pulses, delta, eps)))
    np.testing.assert_allclose(q, ref.numpy(), atol=chip_smoke.quat_tol(L), rtol=0)


@pytest.mark.parametrize("P", [2, 4])
def test_compose_takes_libm_for_a_sample_past_the_polynomials_range(host_builds, P):
    """A row with a long segment (τ = 2400): samples whose angles may pass
    kPolyMax take libm's sincosf, and are right; with τ = 0.5 there the
    polynomial."""
    _, pulses, delta, eps = pulse_case(P, 1, 7, 64, 5 + P)
    pulses[0, 3, -1] = 2400.0
    if P == 4:
        pulses[0, 3, 1:3] = (1.0, 0.0)  # Ω = 1, Δ = 0: the axis norm √(1 + δ²) as at P = 2
    delta[0, :32] = 0.0  # angle 1200 (1 + ε): past kPolyMax
    eps[0, :32] = 0.0
    delta[0, 32:] *= 1e-3
    pulses2 = pulses.copy()
    pulses2[0, 3, -1] = 0.5  # the polynomial throughout
    path, signed = host_compose(host_builds, pulses, delta, eps)
    path2, _ = host_compose(host_builds, pulses2, delta, eps)
    assert (path == 1).all() and (path2 == 0).all()
    ref = tk.propagate_mc_plain(*(torch.from_numpy(a).double() for a in (pulses, delta, eps)))
    # δ = ε = 0: the angle τ / 2 is the same f32 number in every order of
    # evaluation; elsewhere |x| ~ 1e3 carries its own f32 rounding of 1e3 · 6e-8
    np.testing.assert_allclose(signed[0, :32], ref.numpy()[0, :32], atol=2e-5, rtol=0)
    np.testing.assert_allclose(signed[0, 32:], ref.numpy()[0, 32:], atol=3e-4, rtol=0)


def host_sweep(host_builds, pulses, delta, eps, g, q):
    """Per target the kernel-order sweep: dpulses (B, L, P), dδ, dε (B, M)."""
    B, L, P = pulses.shape
    M = delta.shape[1]
    out = run_host(host_builds["math"], 2, B, L, P, M,
                   arrays=(pulses, delta, eps, g, q)).reshape(B, -1)
    dd_de = out[:, L * P:].reshape(B, M, 2)
    return out[:, :L * P].reshape(B, L, P), dd_de[..., 0], dd_de[..., 1]


def plain_grads(pulses, delta, eps, g, dtype):
    return tk.propagate_mc_vjp_plain(*(torch.from_numpy(a).to(dtype) for a in
                                       (pulses, delta, eps, g)))


def assert_sweep_close(got, pulses, delta, eps, g):
    """Against autograd through the plain version in f64: the JAX suite's
    atol (1e-4 pulses, 1e-5 δ, ε) or twice the plain f32 version's own
    error, whichever is larger (``chip_smoke.grads_close``), rtol 1e-4."""
    want = plain_grads(pulses, delta, eps, g, torch.float64)
    plain32 = plain_grads(pulses, delta, eps, g, torch.float32)
    for name, atol, a, w, p32 in zip(("pulses", "delta", "eps"), (1e-4, 1e-5, 1e-5), got,
                                     want, plain32):
        e32 = float((p32.double() - w).abs().max())
        np.testing.assert_allclose(a, w.numpy(), rtol=1e-4, atol=max(atol, 2 * e32),
                                   err_msg=name)
    assert np.abs(got[0]).max() > 1e-3 and np.abs(got[1]).max() > 1e-4  # not vacuous


@pytest.mark.parametrize("P,L,M", [(2, 3, 64), (2, 7, 100), (3, 7, 100), (4, 7, 45),
                                   (2, 100, 64), (4, 100, 64)])
def test_sweep_from_the_product_against_autograd_f64(host_builds, P, L, M):
    """B2's sweep from the host's product (B3's ``compose()``), summed over
    samples as the kernel sums them, against autograd through the plain
    version in f64; M ragged against the block of 64 where M = 100 or 45."""
    rng, pulses, delta, eps = pulse_case(P, 2, L, M, 100 + 10 * P + L)
    g = rng.standard_normal((2, M, 4)).astype(np.float32)
    _, q = host_compose(host_builds, pulses, delta, eps)
    got = host_sweep(host_builds, pulses, delta, eps, g, q.astype(np.float32))
    assert_sweep_close(got, pulses, delta, eps, g)


def test_sweep_at_zero_axis_norm_against_autograd_f64(host_builds):
    """Ω ≤ 0 with Δ + δ = 0 exactly in the first segment (the case of
    ``test_b2_plain_at_zero_axis_norm_matches_pallas_bwd_kernel``): the
    floored axis norm gives the finite limit, as the plain version does."""
    pulses = np.asarray([[[0.3, -0.1, 0.3, 0.4], [1.0, 0.8, -0.2, 0.3]]], np.float32)
    delta = np.asarray([[-0.3, 0.5]], np.float32)
    eps = np.asarray([[0.01, 0.02]], np.float32)
    g = np.random.default_rng(0).standard_normal((1, 2, 4)).astype(np.float32)
    _, q = host_compose(host_builds, pulses, delta, eps)
    got = host_sweep(host_builds, pulses, delta, eps, g, q.astype(np.float32))
    assert all(np.isfinite(x).all() for x in got)
    want = plain_grads(pulses, delta, eps, g, torch.float64)
    for name, atol, a, w in zip(("pulses", "delta", "eps"), (1e-4, 1e-5, 1e-5), got, want):
        np.testing.assert_allclose(a, w.numpy(), rtol=1e-4, atol=atol, err_msg=name)


def test_sweep_is_the_same_bits_on_two_runs(host_builds):
    """The warp's exchanges and the sums over warps and blocks in a fixed
    order: two runs give the same bits (the lanes' threads interleave
    differently on each)."""
    rng, pulses, delta, eps = pulse_case(2, 2, 20, 150, 7)
    g = rng.standard_normal((2, 150, 4)).astype(np.float32)
    _, q = host_compose(host_builds, pulses, delta, eps)
    first = host_sweep(host_builds, pulses, delta, eps, g, q.astype(np.float32))
    second = host_sweep(host_builds, pulses, delta, eps, g, q.astype(np.float32))
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("N,active", [(8, 32), (8, 13), (16, 32), (16, 1)])
def test_reduce_scatter_against_a_fixed_order_sum(host_builds, N, active):
    """Lane l ends with the warp's sum of value l / (32 / N), the lanes that
    share it with the same bits, on two runs the same bits; lanes past
    ``active`` (a ragged M) hold 0 and add nothing."""
    vals = np.random.default_rng(N + active).standard_normal((32, N)).astype(np.float32)
    out = run_host(host_builds["math"], 3, N, active, arrays=(vals,)).reshape(2, 32)
    np.testing.assert_array_equal(out[0], out[1])
    sums = np.zeros(N)
    for lane in range(active):  # a plain sum in lane order
        sums += vals[lane].astype(np.float64)
    idx = np.arange(32) // (32 // N)
    np.testing.assert_allclose(out[0], sums[idx], rtol=0, atol=4e-6 * np.abs(vals).sum(0).max())
    for j in range(N):
        assert len(set(out[0][idx == j])) == 1


def host_counts(host_builds):
    """{P: (compose per segment, per sample, sweep per segment, per sample)}
    from the count build (L = 4 and 8)."""
    lines = [int(x) for x in subprocess.run([str(host_builds["count"])], capture_output=True,
                                            text=True, check=True).stdout.split()]
    counts = {}
    for i, P in enumerate((2, 3, 4)):
        c4, c8, s4, s8 = lines[4 * i:4 * i + 4]
        seg, sseg = (c8 - c4) // 4, (s8 - s4) // 4
        assert c8 - c4 == 4 * seg and s8 - s4 == 4 * sseg
        counts[P] = (seg, c4 - 4 * seg, sseg, s4 - 4 * sseg)
    return counts


def test_compose_flops_on_the_host_are_the_bound_counts(host_builds):
    """B1's and B3's segment and per-sample factors as ``chip_smoke.py``
    counts them for their bounds."""
    for P, (seg, sample, _, _) in host_counts(host_builds).items():
        assert seg == chip_smoke.FLOPS_PER_SEGMENT[P], P
        assert sample == chip_smoke.FLOPS_PER_SAMPLE[P], P


def test_sweep_flops_on_the_host_are_the_bound_counts(host_builds):
    """B2's segment (with one add per pulse cotangent for the sum over
    samples) and per-sample work as ``chip_smoke.py`` counts them."""
    for P, (_, _, seg, sample) in host_counts(host_builds).items():
        assert seg == chip_smoke.VJP_FLOPS_PER_SEGMENT[P], P
        assert sample == chip_smoke.VJP_FLOPS_PER_SAMPLE[P], P
