"""PyTorch port, SU(4) kernels B6 and B7: their per-sample math, compiled
for the host.

``compose()`` in ``ops/csrc/propagate_su4.cu`` (the L-segment product both
kernels run per sample) and ``stage_row()`` (the per-segment scalars) use
nothing of CUDA but ``fmaf``, ``fmaxf`` and ``sincosf``, so a C++ compiler
builds them for the CPU with the CUDA qualifiers defined away.  Two builds:

* plain floats: the product against the port's plain version in f64, at the
  JAX suite's product tolerance 2e-5 (``tests/test_su4_pallas.py``), L ≤ 7;
* a float that counts its operations (an FMA counts 2, a negation 0): the
  flops per segment and per sample must be the counts ``chip_smoke.py``
  takes its B6/B7 bound from.

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

SOURCE = Path(tk.__file__).parent / "csrc" / "propagate_su4.cu"
PROD_TOL = 2e-5

PRELUDE = r"""
#include <cmath>
#include <cstdint>
#include <cstdio>
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
inline CF fmaf(CF a, CF b, CF c) { nflops += 2; return CF(std::fma(a.v, b.v, c.v)); }
inline CF fmaxf(CF a, CF b) { return CF(std::fmax(a.v, b.v)); }
inline void sincosf(CF x, CF* s, CF* c) { s->v = std::sin(x.v); c->v = std::cos(x.v); }
#define float CF
#endif
#define __device__
#define __host__
#define __forceinline__ inline
struct Idx { int x; };
static Idx threadIdx{0}, blockDim{1};
namespace {
"""

MAIN = r"""
}  // namespace
#undef float
#ifdef COUNT_FLOPS
// flops of compose() at s = 4 for L = 1 and L = 2 (drive2 pulses)
int main() {
  for (int L = 1; L <= 2; ++L) {
    CF pulses[8] = {0.3, -0.2, 0.7, 0.1, 1.2, 0.4, 0.6, 0.2};
    CF row[12];
    stage_row<4>(pulses, 0, L, CF(0.1), CF(1.0 / 16), row);
    nflops = 0;
    compose(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), 4);
    printf("%lld\n", nflops);
  }
}
#else
// stdin: B L P M xtalk coupling scaling, pulses (B L P), d1, d2, eps (B M);
// stdout: per sample the 16 entries of W, re and im
int main() {
  int B, L, P, scaling;
  long M;
  float xt, J;
  if (scanf("%d %d %d %ld %f %f %d", &B, &L, &P, &M, &xt, &J, &scaling) != 7) return 1;
  std::vector<float> pulses(B * L * P), d1(B * M), d2(B * M), ep(B * M);
  for (auto* v : {&pulses, &d1, &d2, &ep})
    for (auto& x : *v)
      if (scanf("%f", &x) != 1) return 1;
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
#endif
"""


@pytest.fixture(scope="module")
def host_builds(tmp_path_factory):
    """``{"math": exe, "count": exe}`` built from the kernels' source."""
    if shutil.which("g++") is None:
        pytest.skip("no g++ on the PATH to build compose() for the host")
    src = SOURCE.read_text()
    body = src[src.index("constexpr int kThreads"):src.index("// B7: grid")]
    out = tmp_path_factory.mktemp("su4_host")
    cpp = out / "compose_host.cpp"
    cpp.write_text(PRELUDE + body.replace("__restrict__", "") + MAIN)
    exes = {}
    for name, flags in (("math", []), ("count", ["-DCOUNT_FLOPS"])):
        exes[name] = out / name
        subprocess.run(["g++", "-std=c++17", "-O1", "-ffp-contract=off",
                        "-Wno-unknown-pragmas", *flags, "-o", str(exes[name]), str(cpp)],
                       check=True, capture_output=True, text=True)
    return exes


@pytest.mark.parametrize("P", [2, 3, 4])
def test_compose_math_on_the_host(host_builds, P):
    B, L, M, xt, J, s = 2, 7, 24, 0.1, 0.5, 4
    rng = np.random.default_rng(40 + P)
    cols = [rng.uniform(-3.1, 3.1, (B, L))]
    if P == 4:
        cols.append(rng.uniform(-3.1, 3.1, (B, L)))
    if P >= 3:
        cols.append(rng.uniform(-0.3, 2.0, (B, L)))  # some Ω < 0: the clamp
    cols.append(rng.uniform(0.05, 0.6, (B, L)))
    pulses = np.stack(cols, -1).astype(np.float32)
    d1, d2, ep = (sd * rng.standard_normal((B, M)).astype(np.float32) for sd in (0.3, 0.3, 0.05))
    flat = np.concatenate([a.ravel() for a in (pulses, d1, d2, ep)])
    stdin = f"{B} {L} {P} {M} {xt} {J} {s}\n" + " ".join(f"{x:.9g}" for x in flat)
    out = subprocess.run([str(host_builds["math"])], input=stdin, capture_output=True,
                         text=True, check=True).stdout
    W = np.array(out.split(), dtype=np.float64).reshape(B, M, 4, 4, 2)
    system = tsu4.TwoQubitSystem(xtalk=xt, coupling=J, drive2=P == 4, expm_scaling=s)
    Ur, Ui = tsu4.propagate_su4_mc(*(torch.from_numpy(a).double() for a in (pulses, d1, d2, ep)),
                                   system)
    np.testing.assert_allclose(W[..., 0], Ur.numpy(), atol=PROD_TOL, rtol=0)
    np.testing.assert_allclose(W[..., 1], Ui.numpy(), atol=PROD_TOL, rtol=0)


def test_compose_flops_on_the_host_are_the_bound_counts(host_builds):
    one, two = (int(v) for v in subprocess.run(
        [str(host_builds["count"])], capture_output=True, text=True, check=True).stdout.split())
    assert two - one == chip_smoke.SU4_FLOPS_PER_SEGMENT
    assert one - chip_smoke.SU4_FLOPS_PER_SEGMENT == chip_smoke.SU4_FLOPS_PER_SAMPLE
