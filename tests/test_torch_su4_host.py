"""PyTorch port, SU(4) kernels B4, B5, B6 and B7: their per-sample math,
compiled for the host.

``ops/csrc/su4.cuh`` holds the per-sample math of every SU(4) kernel:
``compose()`` (the L-segment product B4, B6 and B7 run per sample),
``stage_row()`` (the per-segment scalars), and ``seed()`` with
``reverse_sweep()`` (B5's per-sample reverse sweep).  They use nothing of
CUDA but ``fmaf``, ``fmaxf`` and ``sincosf``, so a C++ compiler builds them
for the CPU with the CUDA qualifiers defined away.  Two builds:

* plain floats: the product against the port's plain version in f64, at
  the JAX suite's product tolerance 2e-5 (``tests/test_su4_pallas.py``),
  L ≤ 7; B5's sweep (summed over samples in double, as the kernel's two
  passes do) against autograd through the plain version in f64, at the JAX
  suite's gradient tolerance 1e-5 abs (``tests/test_su4_pallas_bwd.py``),
  L ∈ {3, 7}, with a non-uniform per-target cotangent;
* a float that counts its operations (an FMA counts 2, a negation 0): the
  flops per segment and per sample must be the counts ``chip_smoke.py``
  takes its B4/B6/B7, B5 and B8 bounds from.

The sweep test's sample is B8's per-sample code as it stands in the kernel
(``compose()``, ``seed()``, ``reverse_sweep()``), which is B5's seeded with
B4's product.

Skipped where no ``g++`` is on the PATH.
"""

import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from universal_quantum_optimal_control_tpu_torch.core import su4 as tsu4
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as tk

HEADER = Path(tk.__file__).parent / "csrc" / "su4.cuh"
PROD_TOL = 2e-5
GRAD_TOL = 1e-5

PRELUDE = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <initializer_list>
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
inline CF operator-(CF a) { return CF(-a.v); }
inline bool operator>(CF a, CF b) { return a.v > b.v; }
inline CF fmaf(CF a, CF b, CF c) { nflops += 2; return CF(std::fma(a.v, b.v, c.v)); }
inline CF fmaxf(CF a, CF b) { return CF(std::fmax(a.v, b.v)); }
inline void sincosf(CF x, CF* s, CF* c) { s->v = std::sin(x.v); c->v = std::cos(x.v); }
// the sum over samples: one add per value
inline double acc_add(double a, CF x) { ++nflops; return a + x.v; }
#define float CF
#else
inline double acc_add(double a, float x) { return a + x; }
#endif
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
struct Idx { int x; };
static Idx threadIdx{0}, blockDim{1};
"""

MAIN = r"""
using namespace su4;

// The kernel's per-segment sum over samples (WarpSink), in double.
template <int P>
struct HostSink {
  double* acc;
  void operator()(int k, const float (&v)[P]) const {
    for (int p = 0; p < P; ++p) acc[k * P + p] = acc_add(acc[k * P + p], v[p]);
  }
};

#undef float
#ifdef COUNT_FLOPS
// flops at s = 4 for L = 1 and L = 2 (drive2 pulses): compose(), then
// seed() and the P = 2, 3, 4 reverse sweeps
template <int P>
void count_sweep(CF* row, int L) {
  CF stash[64];
  std::vector<double> acc(L * P, 0.0);
  HostSink<P> sink{acc.data()};
  CF dd1 = 0.0, dd2 = 0.0, de = 0.0;
  nflops = 0;
  reverse_sweep<P>(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), CF(0.1), 4, CF(1.0 / 16),
                   stash, 1, dd1, dd2, de, sink);
  printf("%lld\n", nflops);
}

// B8's sample: the product (compose()), the seed, then the same sweep
template <int P>
void count_rebuild(CF* row, int L) {
  CF stash[64], t[32];
  for (int e = 0; e < 32; ++e) t[e] = CF(0.1 * e);
  std::vector<double> acc(L * P, 0.0);
  HostSink<P> sink{acc.data()};
  CF dd1 = 0.0, dd2 = 0.0, de = 0.0;
  nflops = 0;
  const Mat W = compose(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), 4);
  stash_store(stash, 1, seed(W, t, t + 16, CF(0.01)));
  reverse_sweep<P>(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), CF(0.1), 4, CF(1.0 / 16),
                   stash, 1, dd1, dd2, de, sink);
  printf("%lld\n", nflops);
}

int main() {
  CF pulses[8] = {0.3, -0.2, 0.7, 0.1, 1.2, 0.4, 0.6, 0.2};
  for (int L = 1; L <= 2; ++L) {
    CF row[12];
    stage_row<4>(pulses, 0, L, CF(0.1), CF(1.0 / 16), row);
    nflops = 0;
    compose(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), 4);
    printf("%lld\n", nflops);
  }
  Mat W = identity();
  CF t[32];
  for (int e = 0; e < 32; ++e) t[e] = CF(0.1 * e);
  nflops = 0;
  seed(W, t, t + 16, CF(0.01));
  printf("%lld\n", nflops);
  for (int L = 1; L <= 2; ++L) {
    CF row[20];
    stage_row<4, true>(pulses, 0, L, CF(0.1), CF(1.0 / 16), row);
    count_sweep<2>(row, L);
    count_sweep<3>(row, L);
    count_sweep<4>(row, L);
  }
  for (int L = 1; L <= 2; ++L) {
    CF row[20];
    stage_row<4, true>(pulses, 0, L, CF(0.1), CF(1.0 / 16), row);
    count_rebuild<2>(row, L);
    count_rebuild<3>(row, L);
    count_rebuild<4>(row, L);
  }
}
#else
// stdin: mode B L P M xtalk coupling scaling, pulses (B L P), d1, d2, eps
// (B M), and for mode 1 the targets' re and im (B 16 each) and gbar (B).
// stdout, mode 0: per sample the 16 entries of W, re and im; mode 1:
// dpulses (B L P), then dd1, dd2, deps (B M).
template <int P>
void sweep_target(const std::vector<float>& pulses, int b, int L, long M, float xt,
                  float J, int scaling, const float* d1, const float* d2,
                  const float* ep, const float* t, float gbar, std::vector<double>& acc,
                  std::vector<float>& per_sample) {
  const float ts = std::ldexp(1.0f, -scaling);
  std::vector<float> row(6 * L), row10(10 * L);
  stage_row<P>(pulses.data(), b, L, xt, ts, row.data());
  stage_row<P, true>(pulses.data(), b, L, xt, ts, row10.data());
  HostSink<P> sink{acc.data()};
  for (long m = 0; m < M; ++m) {
    const Mat W = compose(row.data(), L, d1[m], d2[m], ep[m], J, scaling);
    float stash[64];
    stash_store(stash, 1, seed(W, t, t + 16, gbar * (1.0f / static_cast<float>(M)) * 0.1f));
    float dd1 = 0.0f, dd2 = 0.0f, de = 0.0f;
    reverse_sweep<P>(row10.data(), L, d1[m], d2[m], ep[m], J, xt, scaling, ts, stash, 1,
                     dd1, dd2, de, sink);
    per_sample[m] = dd1;
    per_sample[M + m] = dd2;
    per_sample[2 * M + m] = de;
  }
}

int main() {
  int mode, B, L, P, scaling;
  long M;
  float xt, J;
  if (scanf("%d %d %d %d %ld %f %f %d", &mode, &B, &L, &P, &M, &xt, &J, &scaling) != 8)
    return 1;
  std::vector<float> pulses(B * L * P), d1(B * M), d2(B * M), ep(B * M);
  std::vector<float> t(mode ? 32 * B : 0), gbar(mode ? B : 0);
  for (auto* v : {&pulses, &d1, &d2, &ep, &t, &gbar})
    for (auto& x : *v)
      if (scanf("%f", &x) != 1) return 1;
  if (mode == 0) {
    std::vector<float> row(6 * L);
    for (int b = 0; b < B; ++b) {
      const float ts = std::ldexp(1.0f, -scaling);
      if (P == 2) stage_row<2>(pulses.data(), b, L, xt, ts, row.data());
      if (P == 3) stage_row<3>(pulses.data(), b, L, xt, ts, row.data());
      if (P == 4) stage_row<4>(pulses.data(), b, L, xt, ts, row.data());
      for (long m = 0; m < M; ++m) {
        const long i = b * M + m;
        const Mat W = compose(row.data(), L, d1[i], d2[i], ep[i], J, scaling);
        for (int e = 0; e < 16; ++e) printf("%.9g %.9g\n", W.re[e], W.im[e]);
      }
    }
    return 0;
  }
  std::vector<double> dpulses;
  std::vector<float> per_sample(3 * B * M);
  for (int b = 0; b < B; ++b) {
    std::vector<double> acc(L * P, 0.0);
    std::vector<float> ps(3 * M);
    // targets: B re rows of 16, then B im rows of 16
    std::vector<float> tb(32);
    std::memcpy(tb.data(), &t[16 * b], 16 * sizeof(float));
    std::memcpy(tb.data() + 16, &t[16 * (B + b)], 16 * sizeof(float));
    const long o = b * M;
    if (P == 2)
      sweep_target<2>(pulses, b, L, M, xt, J, scaling, &d1[o], &d2[o], &ep[o], tb.data(),
                      gbar[b], acc, ps);
    if (P == 3)
      sweep_target<3>(pulses, b, L, M, xt, J, scaling, &d1[o], &d2[o], &ep[o], tb.data(),
                      gbar[b], acc, ps);
    if (P == 4)
      sweep_target<4>(pulses, b, L, M, xt, J, scaling, &d1[o], &d2[o], &ep[o], tb.data(),
                      gbar[b], acc, ps);
    dpulses.insert(dpulses.end(), acc.begin(), acc.end());
    for (int c = 0; c < 3; ++c)
      std::memcpy(&per_sample[(c * B + b) * M], &ps[c * M], M * sizeof(float));
  }
  for (double x : dpulses) printf("%.9g\n", x);
  for (float x : per_sample) printf("%.9g\n", x);
  return 0;
}
#endif
"""


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    """``{"math": exe, "count": exe}`` built from the kernels' header."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH to build the SU(4) math for the host")
    out = tmp_path_factory.mktemp("su4_host")
    cpp = out / "su4_host.cpp"
    cpp.write_text(PRELUDE + HEADER.read_text().replace("#pragma once", "") + MAIN)
    exes = {}
    for name, flags in (("math", []), ("count", ["-DCOUNT_FLOPS"])):
        exes[name] = out / name
        subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                        "-Wno-unknown-pragmas", *flags, "-o", str(exes[name]), str(cpp)],
                       check=True, capture_output=True, text=True)
    return exes


def pulse_case(P, B, L, M, seed):
    """Pulses with some Ω < 0 (the clamp) and disorder at σ 0.3 / 0.3 / 0.05."""
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(-3.1, 3.1, (B, L))]
    if P == 4:
        cols.append(rng.uniform(-3.1, 3.1, (B, L)))
    if P >= 3:
        cols.append(rng.uniform(-0.3, 2.0, (B, L)))  # some Ω < 0: the clamp
    cols.append(rng.uniform(0.05, 0.6, (B, L)))
    pulses = np.stack(cols, -1).astype(np.float32)
    d1, d2, ep = (sd * rng.standard_normal((B, M)).astype(np.float32) for sd in (0.3, 0.3, 0.05))
    return rng, pulses, d1, d2, ep


def run_host(exe, *header, arrays):
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    stdin = " ".join(str(h) for h in header) + "\n" + " ".join(f"{x:.9g}" for x in flat)
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, text=True,
                         check=True).stdout
    return np.array(out.split(), dtype=np.float64)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_compose_math_on_the_host(host_builds, P):
    B, L, M, xt, J, s = 2, 7, 24, 0.1, 0.5, 4
    _, pulses, d1, d2, ep = pulse_case(P, B, L, M, 40 + P)
    W = run_host(host_builds["math"], 0, B, L, P, M, xt, J, s,
                 arrays=(pulses, d1, d2, ep)).reshape(B, M, 4, 4, 2)
    system = tsu4.TwoQubitSystem(xtalk=xt, coupling=J, drive2=P == 4, expm_scaling=s)
    Ur, Ui = tsu4.propagate_su4_mc(*(torch.from_numpy(a).double() for a in (pulses, d1, d2, ep)),
                                   system)
    np.testing.assert_allclose(W[..., 0], Ur.numpy(), atol=PROD_TOL, rtol=0)
    np.testing.assert_allclose(W[..., 1], Ui.numpy(), atol=PROD_TOL, rtol=0)


@pytest.mark.parametrize("P,L", [(2, 3), (3, 7), (4, 7)])
def test_reverse_sweep_math_on_the_host(host_builds, P, L):
    """B5's per-sample sweep, seeded with B4's product (``compose()``) and a
    non-uniform per-target cotangent, against autograd through the plain
    version in f64."""
    B, M, xt, J, s = 2, 40, 0.1, 0.5, 4
    rng, pulses, d1, d2, ep = pulse_case(P, B, L, M, 60 + P)
    z = rng.standard_normal((B, 4, 4)) + 1j * rng.standard_normal((B, 4, 4))
    T = np.linalg.qr(z)[0]
    tr, ti = T.real.astype(np.float32), T.imag.astype(np.float32)
    gbar = np.array([0.3, 1.7], np.float32)
    out = run_host(host_builds["math"], 1, B, L, P, M, xt, J, s,
                   arrays=(pulses, d1, d2, ep, tr, ti, gbar))
    dpulses = out[:B * L * P].reshape(B, L, P)
    dd1, dd2, de = out[B * L * P:].reshape(3, B, M)
    system = tsu4.TwoQubitSystem(xtalk=xt, coupling=J, drive2=P == 4, expm_scaling=s)
    want = tk.su4_objective_vjp_from_product_plain(
        *(torch.from_numpy(a).double() for a in (pulses, tr, ti, d1, d2, ep, gbar)), None,
        system)
    for name, got, ref in zip(("pulses", "delta1", "delta2", "eps"), (dpulses, dd1, dd2, de),
                              want):
        np.testing.assert_allclose(got, ref.numpy(), atol=GRAD_TOL, rtol=0, err_msg=name)
    assert np.abs(dpulses).max() > 1e-3 and np.abs(dd1).max() > 1e-6  # not vacuous


def test_compose_flops_on_the_host_are_the_bound_counts(host_builds):
    one, two = (int(v) for v in subprocess.run(
        [str(host_builds["count"])], capture_output=True, text=True,
        check=True).stdout.split()[:2])
    assert two - one == chip_smoke.SU4_FLOPS_PER_SEGMENT
    assert one - chip_smoke.SU4_FLOPS_PER_SEGMENT == chip_smoke.SU4_FLOPS_PER_SAMPLE


def test_reverse_sweep_flops_on_the_host_are_the_bound_counts(host_builds):
    """B5 per segment (the sweep and one add per channel for the sum over
    samples) and per sample (the energies, (1 + ε)/2 and the seed)."""
    counts = [int(v) for v in subprocess.run(
        [str(host_builds["count"])], capture_output=True, text=True,
        check=True).stdout.split()[2:]]
    seed, one, two = counts[0], counts[1:4], counts[4:7]
    for P, c1, c2 in zip((2, 3, 4), one, two):
        assert c2 - c1 == chip_smoke.SU4_VJP_FLOPS_PER_SEGMENT[P], P
        assert seed + c1 - (c2 - c1) == chip_smoke.SU4_VJP_FLOPS_PER_SAMPLE, P


def test_rebuild_sweep_flops_on_the_host_are_the_bound_counts(host_builds):
    """B8 per segment (the product's segment and B5's) and per sample (the
    product's energies and (1 + ε)/2, then B5's per-sample work)."""
    counts = [int(v) for v in subprocess.run(
        [str(host_builds["count"])], capture_output=True, text=True,
        check=True).stdout.split()[9:]]
    one, two = counts[0:3], counts[3:6]
    for P, c1, c2 in zip((2, 3, 4), one, two):
        assert c2 - c1 == chip_smoke.SU4_B8_FLOPS_PER_SEGMENT[P] \
            == chip_smoke.SU4_FLOPS_PER_SEGMENT + chip_smoke.SU4_VJP_FLOPS_PER_SEGMENT[P], P
        assert c1 - (c2 - c1) == chip_smoke.SU4_B8_FLOPS_PER_SAMPLE, P
