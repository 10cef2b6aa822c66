"""PyTorch port, SU(4) kernels B4, B5, B6, B7 and B8: their per-sample
math, compiled for the host.

``ops/csrc/su4.cuh`` holds the per-sample math of every SU(4) kernel, both
ways a kernel runs a sample: one thread per sample (``compose()``,
``seed()``, ``reverse_sweep()``: B7 always, B4, B6, B5 and B8 where a launch
fills the card) and a lane group of G lanes per sample (``compose_lane()``,
``product_rows_as_b4()``, ``seed_lane()``, ``reverse_sweep_lane()``: B4, B6, B5
and B8 where it would not), with ``stage_row()`` (the per-segment scalars).
They use nothing of CUDA but ``fmaf``, ``fmaxf``, ``sincosf`` and the group
hook (``group_sync()``, ``group_sum()``, ``group_gather()``, ``ld4()`` /
``st4()`` on the exchange area), so a C++ compiler builds them for the CPU
with the CUDA qualifiers defined away and the hook defined here: the G
lanes of a sample run as ``std::thread``s that meet at a ``std::barrier``
(``g++ -std=c++20 -pthread``), a quarter warp's samples side by side (so
every sample's swizzle of the exchange area is exercised), and every sample
runs as in a kernel's block of 128 / G, those past M masked as the kernels
mask them.  Two builds:

* plain floats: the product of one thread and of B4's lane groups against
  the port's plain version in f64, at the JAX suite's product
  tolerance 2e-5 (``tests/test_su4_pallas.py``), L ≤ 7, with B4's mean F at
  the fidelity tolerance; B5's sweep seeded with B4's product, and B8's,
  summed over samples in double as the kernels' two passes do, against
  autograd through the plain version in f64, at the JAX suite's gradient
  tolerance 1e-5 abs (``tests/test_su4_pallas_bwd.py``), L ∈ {3, 7}, with a
  non-uniform per-target cotangent; the lane cases with M a multiple of the
  block's samples and with a ragged tail;
* a float that counts its operations (an FMA counts 2, a negation 0), per
  lane and apart for work every lane repeats (marked ``Repeated``) and for
  the group's sums: the flops of one sample in one thread, and the lanes'
  shares with the repeated work taken once, must be the counts
  ``chip_smoke.py`` takes its B4/B6/B7, B5 and B8 bounds from; the flops
  the lanes execute are printed beside them.

B7 also runs a sample's segments in K chunks, one thread each, combined in
a tree (``compose_chunk()``, ``combine_chunks()``): the plain build holds
the chunked product to the plain version in f64 for K > L too, the
counting build holds the chunks' needed flops to the bound's counts with
the combine (marked ``Overhead``) apart, and ``prop_plan()``, each launch's
choice of K, is checked as a pure function of the shape and the SM count.

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
FID_TOL = {2: 1e-5, 3: 1e-5, 4: 2e-5}  # tests/test_su4_pallas.py (2e-5 on drive2)
GRAD_TOL = 1e-5

PRELUDE = r"""
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <initializer_list>
#include <thread>
#include <vector>
// the class of the operation being counted: 0 split over the lanes, 1
// repeated by every lane, 2 a sum over the group, 3 done again by a second
// lane pair (B8's product) or a chunk past the first (B7's), 4 B7's combine
static thread_local int count_class = 0;
#ifdef COUNT_FLOPS
static thread_local long long nflops[5];
struct CF {
  float v;
  constexpr CF() : v(0) {}
  constexpr CF(double x) : v(static_cast<float>(x)) {}
};
inline CF operator+(CF a, CF b) { ++nflops[count_class]; return CF(a.v + b.v); }
inline CF operator-(CF a, CF b) { ++nflops[count_class]; return CF(a.v - b.v); }
inline CF operator*(CF a, CF b) { ++nflops[count_class]; return CF(a.v * b.v); }
inline CF operator-(CF a) { return CF(-a.v); }
inline bool operator>(CF a, CF b) { return a.v > b.v; }
inline CF fmaf(CF a, CF b, CF c) { nflops[count_class] += 2; return CF(std::fma(a.v, b.v, c.v)); }
inline CF fmaxf(CF a, CF b) { return CF(std::fmax(a.v, b.v)); }
inline void sincosf(CF x, CF* s, CF* c) { s->v = std::sin(x.v); c->v = std::cos(x.v); }
// the sum over samples: one add per value
inline double acc_add(double a, CF x) { ++nflops[count_class]; return a + x.v; }
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

// The group hook: the G lanes of a sample are threads; the lanes of all
// samples run side by side (a quarter warp's: 8 / G samples) meet at one
// barrier, as a warp's lanes meet at __syncwarp.  lane_c and lane_g are the
// thread's lane in its group and its sample.
static std::barrier<>* group_barrier = nullptr;
static thread_local int lane_c = 0, lane_g = 0;
static float group_bufs[8][4];
inline void group_sync() { group_barrier->arrive_and_wait(); }
// the card's butterfly: v + v^1, then + (v^2 + v^3)
template <int G>
inline float group_sum(float v) {
  const int saved = count_class;
  count_class = 2;
  float* buf = group_bufs[lane_g];
  for (int x = 1; x < G; x <<= 1) {
    buf[lane_c] = v;
    group_sync();
    v = v + buf[lane_c ^ x];
    group_sync();
  }
  count_class = saved;
  return v;
}
template <int G>
inline void group_gather(const float (&v)[4 / G], float (&out)[4]) {
  float* buf = group_bufs[lane_g];
  for (int j = 0; j < 4 / G; ++j) buf[lane_c * (4 / G) + j] = v[j];
  group_sync();
  for (int d = 0; d < 4; ++d) out[d] = buf[d];
  group_sync();
}
inline void st4(float* p, const float (&v)[4]) { for (int i = 0; i < 4; ++i) p[i] = v[i]; }
inline void ld4(const float* p, float (&v)[4]) { for (int i = 0; i < 4; ++i) v[i] = p[i]; }
struct Repeated {
  int saved;
  Repeated() : saved(count_class) { count_class = saved == 0 ? 1 : saved; }
  ~Repeated() { count_class = saved; }
};
struct Duplicate {
  int saved;
  explicit Duplicate(bool again) : saved(count_class) { count_class = again ? 3 : saved; }
  ~Duplicate() { count_class = saved; }
};
struct Overhead {
  int saved;
  Overhead() : saved(count_class) { count_class = 4; }
  ~Overhead() { count_class = saved; }
};
"""

MAIN = r"""
using namespace su4;

constexpr int kBlockThreads = 128;  // the kernels' threads per block

// The kernels' per-segment sum over samples (WarpSink), in double: one
// thread's values, or the group's first lane's.
template <int P>
struct HostSink {
  double* acc;
  void operator()(int k, const float (&v)[P], bool lead = true) const {
    if (!lead) return;
    for (int p = 0; p < P; ++p) acc[k * P + p] = acc_add(acc[k * P + p], v[p]);
  }
};

// the exchange area of a quarter warp's samples: kSweepSlots slots of the
// widest stride
alignas(16) static float xch[kSweepSlots * slot_stride<2>];

// fn(lane) on the G lanes of `samples` samples side by side, each lane a
// thread, all meeting at one barrier; sample g's lanes as the kernels place
// them (first column h 4 / G, swizzle g mod 8 / G).
template <int G, class F>
void run_lanes(F fn, int samples) {
  std::barrier<> bar(G * samples);
  group_barrier = &bar;
  std::vector<std::thread> lanes;
  for (int g = 0; g < samples; ++g)
    for (int h = 0; h < G; ++h)
      lanes.emplace_back([&fn, g, h] {
        lane_c = h;
        lane_g = g;
        fn(Lane{xch + kSlotFloats * g, h * (4 / G), g & (8 / G - 1)});
      });
  for (auto& t : lanes) t.join();
}

#undef float
#ifdef COUNT_FLOPS
// One thread per sample: flops at s = 4 for L = 1 and L = 2 (drive2
// pulses) of compose(), then seed() and the P = 2, 3, 4 reverse sweeps
template <int P>
void count_sweep(CF* row, int L) {
  CF stash[64];
  std::vector<double> acc(L * P, 0.0);
  HostSink<P> sink{acc.data()};
  CF dd1 = 0.0, dd2 = 0.0, de = 0.0;
  nflops[0] = 0;
  reverse_sweep<P>(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), CF(0.1), 4, CF(1.0 / 16),
                   stash, 1, dd1, dd2, de, sink);
  printf("%lld\n", nflops[0]);
}

// B8's sample: the product (compose()), the seed, then the same sweep
template <int P>
void count_rebuild(CF* row, int L) {
  CF stash[64], t[32];
  for (int e = 0; e < 32; ++e) t[e] = CF(0.1 * e);
  std::vector<double> acc(L * P, 0.0);
  HostSink<P> sink{acc.data()};
  CF dd1 = 0.0, dd2 = 0.0, de = 0.0;
  nflops[0] = 0;
  const Mat W = compose(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), 4);
  stash_store(stash, 1, seed(W, t, t + 16, CF(0.01)));
  reverse_sweep<P>(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), CF(0.1), 4, CF(1.0 / 16),
                   stash, 1, dd1, dd2, de, sink);
  printf("%lld\n", nflops[0]);
}

// The lane group: flops of one sample over the lanes, "needed executed
// alike", with the repeated work taken once in the first and by every lane
// in the second; alike is 1 when every lane repeated the same count (among
// the lanes that did the same work again beside another pair)
template <int G, class F>
void tally(F fn) {
  long long lane[G][4] = {};
  run_lanes<G>([&](const Lane& ln) {
    for (auto& n : nflops) n = 0;
    fn(ln);
    for (int j = 0; j < 4; ++j) lane[ln.c / (4 / G)][j] = nflops[j];
  }, 1);
  long long split = 0, executed = 0;
  int alike = 1;
  for (int h = 0; h < G; ++h) {
    split += lane[h][0];
    executed += lane[h][0] + lane[h][1] + lane[h][2] + lane[h][3];
    for (int o = 0; o < h; ++o)
      if (lane[o][3] == lane[h][3]) alike &= lane[o][1] == lane[h][1];
  }
  printf("%lld %lld %d\n", split + lane[0][1], executed, alike);
}

const CF kT[32] = {0.0, 0.1, 0.2, 0.3, 0.4, 0.5, 0.6, 0.7, 0.8, 0.9, 1.0, 1.1, 1.2, 1.3, 1.4, 1.5,
                   1.6, 1.7, 1.8, 1.9, 2.0, 2.1, 2.2, 2.3, 2.4, 2.5, 2.6, 2.7, 2.8, 2.9, 3.0, 3.1};

// B5's sample on its lane group (a product row, the seed, the sweep), or
// B8's (rebuild: the product formed as B4 forms it first)
template <int P>
void count_lane_sweep(CF* row, int L, bool rebuild) {
  constexpr int G = kSweepLanes;
  std::vector<double> acc(L * P, 0.0);
  tally<G>([&](const Lane& ln) {
    HostSink<P> sink{acc.data()};
    CF dd1 = 0.0, dd2 = 0.0, de = 0.0, pr[1][4], pi[1][4];
    if (rebuild) {
      product_rows_as_b4<4>(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), 4, xch, 0, ln.c, pr,
                            pi);
      group_sync();
    } else {
      for (int k = 0; k < 4; ++k) {
        pr[0][k] = CF(0.1 * (k + ln.c) - 0.2);
        pi[0][k] = CF(0.05 * k * ln.c + 0.1);
      }
    }
    Col V[1];
    seed_lane<G>(pr, pi, kT, kT + 16, CF(0.01), ln, V);
    reverse_sweep_lane<G, P>(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), CF(0.1), 4,
                             CF(1.0 / 16), ln, V, dd1, dd2, de, sink);
  });
}

void count_lanes(const CF* pulses) {
  for (int L = 1; L <= 2; ++L) {
    CF row[12];
    stage_row<4>(pulses, 0, L, CF(0.1), CF(1.0 / 16), row);
    tally<kComposeLanes>([&](const Lane& ln) {
      Col W[4 / kComposeLanes];
      compose_lane<kComposeLanes>(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), 4, ln, W);
    });
  }
  for (int rebuild = 0; rebuild < 2; ++rebuild)
    for (int L = 1; L <= 2; ++L) {
      CF row[20];
      stage_row<4, true>(pulses, 0, L, CF(0.1), CF(1.0 / 16), row);
      count_lane_sweep<2>(row, L, rebuild);
      count_lane_sweep<3>(row, L, rebuild);
      count_lane_sweep<4>(row, L, rebuild);
    }
}

// B7's chunks: one sample on K chunks, every chunk a thread, all at one
// barrier.  Prints "needed combine executed": the threads' own work, the
// combine's (Overhead) apart, and all the threads executed.
void tally_chunks(const CF* pulses, int L, int K) {
  std::vector<CF> row(6 * L);
  stage_row<4>(pulses, 0, L, CF(0.1), CF(1.0 / 16), row.data());
  long long lane[16][5] = {};
  CF stash[32 * 16];
  std::barrier<> bar(K);
  group_barrier = &bar;
  std::vector<std::thread> threads;
  for (int j = 0; j < K; ++j)
    threads.emplace_back([&, j] {
      for (auto& n : nflops) n = 0;
      Mat W = compose_chunk(row.data(), L, K, j, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), 4);
      combine_chunks(K, j, stash + j, K, W);
      for (int c = 0; c < 5; ++c) lane[j][c] = nflops[c];
    });
  for (auto& t : threads) t.join();
  long long needed = 0, combine = 0, executed = 0;
  for (int q = 0; q < K; ++q) {
    needed += lane[q][0];
    combine += lane[q][4];
    for (long long n : lane[q]) executed += n;
  }
  printf("%lld %lld %lld\n", needed, combine, executed);
}

// Lines, one thread per sample (one count each): compose() at L = 1, 2;
// seed(); the sweep at P = 2, 3, 4 for L = 1, then L = 2; B8's sample
// likewise.  Then the lane groups ("needed executed alike" each): B4's
// compose_lane() at L = 1, 2; B5 at P = 2, 3, 4 for L = 1, then L = 2; B8
// likewise.  Then B7's chunks ("needed combine executed" each): K = 2 at
// L = 2, 4, then K = 4 at L = 4, 8.
int main() {
  CF pulses[16] = {0.3, -0.2, 0.7, 0.1, 1.2, 0.4, 0.6, 0.2,
                   -0.9, 0.5, 1.1, 0.3, 2.0, -1.3, 0.8, 0.45};
  for (int L = 1; L <= 2; ++L) {
    CF row[12];
    stage_row<4>(pulses, 0, L, CF(0.1), CF(1.0 / 16), row);
    nflops[0] = 0;
    compose(row, L, CF(0.1), CF(-0.2), CF(0.03), CF(0.5), 4);
    printf("%lld\n", nflops[0]);
  }
  Mat W = identity();
  CF t[32];
  for (int e = 0; e < 32; ++e) t[e] = CF(0.1 * e);
  nflops[0] = 0;
  seed(W, t, t + 16, CF(0.01));
  printf("%lld\n", nflops[0]);
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
  count_lanes(pulses);
  for (int L = 2; L <= 4; L += 2) tally_chunks(pulses, L, 2);
  for (int L = 4; L <= 8; L += 4) tally_chunks(pulses, L, 4);
}
#else
// One target's samples as the kernels run them: in one thread each, or in
// blocks of 128 / G samples on lane groups, those past M with zero disorder
// (and, in the sweep, a zero seed), a quarter warp's samples side by side.
struct Target {
  int L, scaling;
  long M;
  float xt, J, ts;
  std::vector<float> row6, row10;
  const float *d1, *d2, *ep;
};

template <int P>
Target stage(const std::vector<float>& pulses, int b, int L, long M, float xt, float J,
             int scaling, const float* d1, const float* d2, const float* ep) {
  Target t{L, scaling, M, xt, J, std::ldexp(1.0f, -scaling), std::vector<float>(6 * L),
           std::vector<float>(10 * L), d1, d2, ep};
  stage_row<P>(pulses.data(), b, L, xt, t.ts, t.row6.data());
  stage_row<P, true>(pulses.data(), b, L, xt, t.ts, t.row10.data());
  return t;
}

template <int G>
long padded(long M) {
  constexpr long S = kBlockThreads / G;
  return (M + S - 1) / S * S;
}

// B4 on one target on lane groups: each lane's columns of each active
// sample's product into prod (32, M), 16 re then 16 im, row-major, as the
// kernel writes them; the return value is the sum of F over the samples.
template <int G>
double b4_target(const Target& t, const float* tr, const float* ti, float* prod) {
  constexpr int NC = 4 / G, S = 8 / G;
  double fsum[S] = {};
  run_lanes<G>([&](const Lane& ln) {
    const int c = ln.c, g = lane_g;
    for (long m = g; m < padded<G>(t.M); m += S) {
      const bool active = m < t.M;
      Col W[NC];
      compose_lane<G>(t.row6.data(), t.L, active ? t.d1[m] : 0.0f, active ? t.d2[m] : 0.0f,
                      active ? t.ep[m] : 0.0f, t.J, t.scaling, ln, W);
      float re = 0.0f, im = 0.0f;
      for (int j = 0; j < NC; ++j)
        for (int r = 0; r < 4; ++r) {
          const int e = (4 * r + j) ^ (5 * c);
          if (active) {
            prod[e * t.M + m] = W[j].re[r];
            prod[(16 + e) * t.M + m] = W[j].im[r];
          }
          re = fmaf(W[j].re[r], tr[e], re);
          re = fmaf(W[j].im[r], ti[e], re);
          im = fmaf(W[j].re[r], ti[e], im);
          im = fmaf(-W[j].im[r], tr[e], im);
        }
      re = group_sum<G>(re);
      im = group_sum<G>(im);
      if (active && c == 0) fsum[g] += (fmaf(re, re, im * im) + 4.0f) / 20.0f;
    }
  }, S);
  double f = 0.0;
  for (double x : fsum) f += x;
  return f;
}

// B5 (prod given: B4's) or B8 (prod null) on one target on their lane
// groups: the sum of the pulse cotangents over samples into acc (L P),
// per-sample ones into per_sample (3, M).
template <int P>
void sweep_target(const Target& t, const float* target, float gbar, const float* prod,
                  std::vector<double>& acc, std::vector<float>& per_sample) {
  constexpr int G = kSweepLanes, S = 8 / G;
  std::vector<std::vector<double>> accs(S, acc);
  run_lanes<G>([&](const Lane& ln) {
    const int c = ln.c, g = lane_g;
    HostSink<P> sink{accs[g].data()};
    for (long m = g; m < padded<G>(t.M); m += S) {
      const bool active = m < t.M;
      const float d1 = active ? t.d1[m] : 0.0f, d2 = active ? t.d2[m] : 0.0f;
      const float ep = active ? t.ep[m] : 0.0f;
      float pr[1][4], pi[1][4];
      if (prod == nullptr) {
        product_rows_as_b4<4>(t.row10.data(), t.L, d1, d2, ep, t.J, t.scaling, xch, g, c, pr,
                              pi);
        group_sync();
      } else {
        for (int k = 0; k < 4; ++k) {
          const int e = k ^ (5 * c);
          pr[0][k] = active ? prod[e * t.M + m] : 0.0f;
          pi[0][k] = active ? prod[(16 + e) * t.M + m] : 0.0f;
        }
      }
      const float gs = active ? gbar * (1.0f / static_cast<float>(t.M)) * 0.1f : 0.0f;
      Col V[1];
      seed_lane<G>(pr, pi, target, target + 16, gs, ln, V);
      float dd1 = 0.0f, dd2 = 0.0f, de = 0.0f;
      reverse_sweep_lane<G, P>(t.row10.data(), t.L, d1, d2, ep, t.J, t.xt, t.scaling, t.ts, ln,
                               V, dd1, dd2, de, sink);
      if (active && c == 0) {
        per_sample[m] = dd1;
        per_sample[t.M + m] = dd2;
        per_sample[2 * t.M + m] = de;
      }
    }
  }, S);
  for (size_t j = 0; j < acc.size(); ++j)
    for (int g = 0; g < S; ++g) acc[j] += accs[g][j];
}

// B7 on chunks, one target: 4 samples side by side, each on K chunks, every
// chunk a thread, all meeting at one barrier as a warp's lanes meet; the
// chunks' exchange laid out as the kernel lays it out (a column each, a
// sample's consecutive); samples past M with zero disorder.  W of each
// sample into out (M, 32): 16 re, 16 im.
void chunk_target(const Target& t, int K, float* out) {
  const int side = 4;
  std::vector<float> stash(32 * side * K);
  for (long m0 = 0; m0 < t.M; m0 += side) {
    std::barrier<> bar(side * K);
    group_barrier = &bar;
    std::vector<std::thread> lanes;
    for (int q = 0; q < side; ++q)
      for (int j = 0; j < K; ++j)
        lanes.emplace_back([&, q, j] {
          const long m = m0 + q;
          const bool active = m < t.M;
          const float d1 = active ? t.d1[m] : 0.0f, d2 = active ? t.d2[m] : 0.0f;
          const float ep = active ? t.ep[m] : 0.0f;
          Mat W = compose_chunk(t.row6.data(), t.L, K, j, d1, d2, ep, t.J, t.scaling);
          combine_chunks(K, j, stash.data() + q * K + j, side * K, W);
          if (j == 0 && active) stash_store(out + 32 * m, 1, W);
        });
    for (auto& th : lanes) th.join();
  }
}

// B8's sample in one thread: compose(), seed(), reverse_sweep().
template <int P>
void sweep_thread(const Target& t, const float* target, float gbar, std::vector<double>& acc,
                  std::vector<float>& per_sample) {
  HostSink<P> sink{acc.data()};
  for (long m = 0; m < t.M; ++m) {
    const Mat W = compose(t.row6.data(), t.L, t.d1[m], t.d2[m], t.ep[m], t.J, t.scaling);
    float stash[64];
    stash_store(stash, 1, seed(W, target, target + 16,
                               gbar * (1.0f / static_cast<float>(t.M)) * 0.1f));
    float dd1 = 0.0f, dd2 = 0.0f, de = 0.0f;
    reverse_sweep<P>(t.row10.data(), t.L, t.d1[m], t.d2[m], t.ep[m], t.J, t.xt, t.scaling, t.ts,
                     stash, 1, dd1, dd2, de, sink);
    per_sample[m] = dd1;
    per_sample[t.M + m] = dd2;
    per_sample[2 * t.M + m] = de;
  }
}

template <int P>
void sweep(int mode, const Target& t, const float* target, float gbar, const float* prod,
           std::vector<double>& acc, std::vector<float>& ps) {
  if (mode == 4)
    sweep_thread<P>(t, target, gbar, acc, ps);
  else
    sweep_target<P>(t, target, gbar, prod, acc, ps);
}

// stdin: mode B L P M xtalk coupling scaling (mode 5: then K), pulses
// (B L P), d1, d2, eps (B M), and for modes 1-4 the targets' re and im (B 16
// each) and gbar (B); mode 6: n, then n lines B M L n_sm.
// stdout, mode 0 (compose(), one thread a sample) and mode 5 (B7 on K
// chunks): per sample the 16 entries of W, re and im; mode 2 (B4
// on its lane groups): the same, then the B mean F; mode 1 (B5 on its lane
// groups, seeded with mode 2's product), mode 3 (B8 on its lane groups) and
// mode 4 (B8's sample in one thread): dpulses (B L P), then dd1, dd2, deps
// (B M); mode 6: B7's plan K a line.
int main() {
  int mode, B, L, P, scaling, K = 1;
  long M;
  float xt, J;
  if (scanf("%d", &mode) != 1) return 1;
  if (mode == 6) {
    int n, nsm;
    if (scanf("%d", &n) != 1) return 1;
    for (int q = 0; q < n; ++q) {
      if (scanf("%d %ld %d %d", &B, &M, &L, &nsm) != 4) return 1;
      printf("%d\n", prop_plan(B, M, L, nsm, kBlockThreads));
    }
    return 0;
  }
  if (scanf("%d %d %d %ld %f %f %d", &B, &L, &P, &M, &xt, &J, &scaling) != 7) return 1;
  if (mode == 5 && scanf("%d", &K) != 1) return 1;
  const bool targeted = mode >= 1 && mode <= 4;
  std::vector<float> pulses(B * L * P), d1(B * M), d2(B * M), ep(B * M);
  std::vector<float> t(targeted ? 32 * B : 0), gbar(targeted ? B : 0);
  for (auto* v : {&pulses, &d1, &d2, &ep, &t, &gbar})
    for (auto& x : *v)
      if (scanf("%f", &x) != 1) return 1;
  std::vector<Target> targets;
  for (int b = 0; b < B; ++b) {
    const long o = b * M;
    if (P == 2) targets.push_back(stage<2>(pulses, b, L, M, xt, J, scaling, &d1[o], &d2[o], &ep[o]));
    if (P == 3) targets.push_back(stage<3>(pulses, b, L, M, xt, J, scaling, &d1[o], &d2[o], &ep[o]));
    if (P == 4) targets.push_back(stage<4>(pulses, b, L, M, xt, J, scaling, &d1[o], &d2[o], &ep[o]));
  }
  if (mode == 0) {
    for (int b = 0; b < B; ++b)
      for (long m = 0; m < M; ++m) {
        const long i = b * M + m;
        const Mat W = compose(targets[b].row6.data(), L, d1[i], d2[i], ep[i], J, scaling);
        for (int e = 0; e < 16; ++e) printf("%.9g %.9g\n", W.re[e], W.im[e]);
      }
    return 0;
  }
  if (mode == 5) {
    for (int b = 0; b < B; ++b) {
      std::vector<float> out(32 * M);
      chunk_target(targets[b], K, out.data());
      for (long m = 0; m < M; ++m)
        for (int e = 0; e < 16; ++e) printf("%.9g %.9g\n", out[32 * m + e], out[32 * m + 16 + e]);
    }
    return 0;
  }
  // targets: B re rows of 16, then B im rows of 16
  std::vector<std::vector<float>> tgt(B, std::vector<float>(32));
  for (int b = 0; b < B; ++b) {
    std::memcpy(tgt[b].data(), &t[16 * b], 16 * sizeof(float));
    std::memcpy(tgt[b].data() + 16, &t[16 * (B + b)], 16 * sizeof(float));
  }
  std::vector<std::vector<float>> prods;
  std::vector<double> means;
  if (mode == 1 || mode == 2)
    for (int b = 0; b < B; ++b) {
      prods.emplace_back(32 * M);
      const float *tr = tgt[b].data(), *ti = tr + 16;
      const double f = b4_target<kComposeLanes>(targets[b], tr, ti, prods[b].data());
      means.push_back(f / M);
    }
  if (mode == 2) {
    for (int b = 0; b < B; ++b)
      for (long m = 0; m < M; ++m)
        for (int e = 0; e < 16; ++e)
          printf("%.9g %.9g\n", prods[b][e * M + m], prods[b][(16 + e) * M + m]);
    for (double f : means) printf("%.9g\n", f);
    return 0;
  }
  std::vector<double> dpulses;
  std::vector<float> per_sample(3 * B * M);
  for (int b = 0; b < B; ++b) {
    std::vector<double> acc(L * P, 0.0);
    std::vector<float> ps(3 * M);
    const float* prod = mode == 1 ? prods[b].data() : nullptr;
    if (P == 2) sweep<2>(mode, targets[b], tgt[b].data(), gbar[b], prod, acc, ps);
    if (P == 3) sweep<3>(mode, targets[b], tgt[b].data(), gbar[b], prod, acc, ps);
    if (P == 4) sweep<4>(mode, targets[b], tgt[b].data(), gbar[b], prod, acc, ps);
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
        subprocess.run(["g++", "-std=c++20", "-pthread", "-O1", "-ffp-contract=off",
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


def targets_case(rng, B):
    """Random unitary targets (re, im) and a non-uniform per-target ḡ."""
    z = rng.standard_normal((B, 4, 4)) + 1j * rng.standard_normal((B, 4, 4))
    T = np.linalg.qr(z)[0]
    return T.real.astype(np.float32), T.imag.astype(np.float32), \
        np.linspace(0.3, 1.7, B).astype(np.float32)


def run_host(exe, *header, arrays):
    flat = np.concatenate([np.asarray(a, np.float32).ravel() for a in arrays])
    stdin = " ".join(str(h) for h in header) + "\n" + " ".join(f"{x:.9g}" for x in flat)
    out = subprocess.run([str(exe)], input=stdin, capture_output=True, text=True,
                         check=True).stdout
    return np.array(out.split(), dtype=np.float64)


def plain_system(P, xt, J, s):
    return tsu4.TwoQubitSystem(xtalk=xt, coupling=J, drive2=P == 4, expm_scaling=s)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_compose_math_on_the_host(host_builds, P):
    """``compose()``, one thread per sample (B7, and B4 and B6 on launches
    that fill the card)."""
    B, L, M, xt, J, s = 2, 7, 24, 0.1, 0.5, 4
    _, pulses, d1, d2, ep = pulse_case(P, B, L, M, 40 + P)
    W = run_host(host_builds["math"], 0, B, L, P, M, xt, J, s,
                 arrays=(pulses, d1, d2, ep)).reshape(B, M, 4, 4, 2)
    Ur, Ui = tsu4.propagate_su4_mc(*(torch.from_numpy(a).double() for a in (pulses, d1, d2, ep)),
                                   plain_system(P, xt, J, s))
    np.testing.assert_allclose(W[..., 0], Ur.numpy(), atol=PROD_TOL, rtol=0)
    np.testing.assert_allclose(W[..., 1], Ui.numpy(), atol=PROD_TOL, rtol=0)


# M = 128 fills whole kernel blocks on lane groups (64 samples on B4's 2
# lanes, 32 on B5's 4), 45 leaves a ragged block whose samples past M are
# masked
@pytest.mark.parametrize("P,M", [(2, 128), (3, 128), (4, 128), (4, 45)])
def test_lane_compose_math_on_the_host(host_builds, P, M):
    """B4's lane groups (``compose_lane()``): each sample's product as the
    kernel writes it, and the per-target mean F."""
    B, L, xt, J, s = 2, 7, 0.1, 0.5, 4
    rng, pulses, d1, d2, ep = pulse_case(P, B, L, M, 50 + P)
    tr, ti, gbar = targets_case(rng, B)
    out = run_host(host_builds["math"], 2, B, L, P, M, xt, J, s,
                   arrays=(pulses, d1, d2, ep, tr, ti, gbar))
    W, F = out[:-B].reshape(B, M, 4, 4, 2), out[-B:]
    args = [torch.from_numpy(a).double() for a in (pulses, tr, ti, d1, d2, ep)]
    F_ref, prod_ref = tk.mean_fidelity_su4_with_product_plain(*args, plain_system(P, xt, J, s))
    ref = prod_ref.numpy().transpose(0, 2, 1).reshape(B, M, 2, 4, 4)
    np.testing.assert_allclose(W[..., 0], ref[:, :, 0], atol=PROD_TOL, rtol=0)
    np.testing.assert_allclose(W[..., 1], ref[:, :, 1], atol=PROD_TOL, rtol=0)
    np.testing.assert_allclose(F, F_ref.numpy(), atol=FID_TOL[P], rtol=0)


def sweep_case(host_builds, mode, P, L, M, seed):
    """Run B5 on its lane groups (mode 1), B8 on its lane groups (mode 3) or
    B8's sample in one thread (mode 4) on the host; returns its gradients
    and autograd's through the plain version in f64."""
    B, xt, J, s = 2, 0.1, 0.5, 4
    rng, pulses, d1, d2, ep = pulse_case(P, B, L, M, seed)
    tr, ti, gbar = targets_case(rng, B)
    out = run_host(host_builds["math"], mode, B, L, P, M, xt, J, s,
                   arrays=(pulses, d1, d2, ep, tr, ti, gbar))
    got = (out[:B * L * P].reshape(B, L, P), *out[B * L * P:].reshape(3, B, M))
    want = tk.su4_objective_vjp_from_product_plain(
        *(torch.from_numpy(a).double() for a in (pulses, tr, ti, d1, d2, ep, gbar)), None,
        plain_system(P, xt, J, s))
    return got, want


def assert_grads(got, want):
    for name, g, ref in zip(("pulses", "delta1", "delta2", "eps"), got, want):
        np.testing.assert_allclose(g, ref.numpy(), atol=GRAD_TOL, rtol=0, err_msg=name)
    assert np.abs(got[0]).max() > 1e-3 and np.abs(got[1]).max() > 1e-6  # not vacuous


@pytest.mark.parametrize("P,L", [(2, 3), (3, 7), (4, 7)])
def test_reverse_sweep_math_on_the_host(host_builds, P, L):
    """B5's per-sample sweep in one thread, seeded with B4's product
    (``compose()``, then ``seed()``, ``reverse_sweep()``: B8's per-sample
    code, which is B5's seeded with B4's product) and a non-uniform
    per-target cotangent, against autograd through the plain version in
    f64."""
    assert_grads(*sweep_case(host_builds, 4, P, L, 40, 60 + P))


@pytest.mark.parametrize("P,L,M", [(2, 3, 128), (3, 7, 128), (4, 7, 128), (4, 7, 45)])
def test_lane_reverse_sweep_math_on_the_host(host_builds, P, L, M):
    """B5's lane groups (``seed_lane()``, ``reverse_sweep_lane()``), seeded
    with B4's lane-group product and a non-uniform per-target cotangent,
    against autograd through the plain version in f64."""
    assert_grads(*sweep_case(host_builds, 1, P, L, M, 60 + P))


@pytest.mark.parametrize("P,L,M", [(2, 3, 128), (4, 7, 45)])
def test_lane_rebuild_sweep_math_on_the_host(host_builds, P, L, M):
    """B8's lane groups (the product formed as B4's lane groups form it,
    ``product_rows_as_b4()``, then B5's seed and sweep) against autograd in
    f64, and equal to B5 seeded with B4's product, value for value."""
    got, want = sweep_case(host_builds, 3, P, L, M, 70 + P)
    b5, _ = sweep_case(host_builds, 1, P, L, M, 70 + P)
    assert_grads(got, want)
    for name, g, g5 in zip(("pulses", "delta1", "delta2", "eps"), got, b5):
        np.testing.assert_array_equal(g, g5, err_msg=name)


def host_counts(host_builds):
    """The count build: one thread per sample (compose() at L = 1, 2;
    seed(); the sweep at P = 2, 3, 4 for L = 1 then 2; B8's sample likewise),
    then the lane groups' (needed, executed, repeated work alike in every
    lane) per case (B4 at L = 1, 2; B5 at P = 2, 3, 4 for L = 1 then 2; B8
    likewise), then B7's chunks' (needed, combine, executed) at K = 2 (L =
    2, 4) and K = 4 (L = 4, 8)."""
    lines = subprocess.run([str(host_builds["count"])], capture_output=True, text=True,
                           check=True).stdout.splitlines()
    thread = [int(x) for x in lines[:15]]
    rows = [tuple(int(x) for x in line.split()) for line in lines[15:29]]
    chunks = [tuple(int(x) for x in line.split()) for line in lines[29:]]
    assert len(rows) == 14 and all(r[2] == 1 for r in rows), \
        "the repeated work differs between lanes"
    assert len(chunks) == 4
    return thread, rows, chunks


def test_compose_flops_on_the_host_are_the_bound_counts(host_builds):
    """``compose()`` (one thread per sample: B7, and B4 and B6 on launches
    that fill the card) per segment and per sample."""
    thread, lanes, _ = host_counts(host_builds)
    one, two = thread[:2]
    assert two - one == chip_smoke.SU4_FLOPS_PER_SEGMENT
    assert one - chip_smoke.SU4_FLOPS_PER_SEGMENT == chip_smoke.SU4_FLOPS_PER_SAMPLE
    (_, x1, _), (_, x2, _) = lanes[0], lanes[1]
    print(f"B4 on lane groups: {x2 - x1} flops executed per sample-segment (bound "
          f"{two - one}), {x1 - (x2 - x1)} per sample")


def test_reverse_sweep_flops_on_the_host_are_the_bound_counts(host_builds):
    """B5 per segment (the sweep and one add per channel for the sum over
    samples) and per sample (the energies, (1 + ε)/2 and the seed)."""
    thread, lanes, _ = host_counts(host_builds)
    seed, one, two = thread[2], thread[3:6], thread[6:9]
    for P, c1, c2 in zip((2, 3, 4), one, two):
        assert c2 - c1 == chip_smoke.SU4_VJP_FLOPS_PER_SEGMENT[P], P
        assert seed + c1 - (c2 - c1) == chip_smoke.SU4_VJP_FLOPS_PER_SAMPLE, P
    for P, (_, x1, _), (_, x2, _) in zip((2, 3, 4), lanes[2:5], lanes[5:8]):
        print(f"B5 on lane groups, P = {P}: {x2 - x1} flops executed per sample-segment "
              f"(bound {chip_smoke.SU4_VJP_FLOPS_PER_SEGMENT[P]}), {x1 - (x2 - x1)} per sample")


def test_rebuild_sweep_flops_on_the_host_are_the_bound_counts(host_builds):
    """B8 per segment (the product's segment and B5's) and per sample (the
    product's energies and (1 + ε)/2, then B5's per-sample work)."""
    thread, lanes, _ = host_counts(host_builds)
    one, two = thread[9:12], thread[12:15]
    for P, c1, c2 in zip((2, 3, 4), one, two):
        assert c2 - c1 == chip_smoke.SU4_B8_FLOPS_PER_SEGMENT[P] \
            == chip_smoke.SU4_FLOPS_PER_SEGMENT + chip_smoke.SU4_VJP_FLOPS_PER_SEGMENT[P], P
        assert c1 - (c2 - c1) == chip_smoke.SU4_B8_FLOPS_PER_SAMPLE, P
    for P, (_, x1, _), (_, x2, _) in zip((2, 3, 4), lanes[8:11], lanes[11:14]):
        print(f"B8 on lane groups, P = {P}: {x2 - x1} flops executed per sample-segment "
              f"(bound {chip_smoke.SU4_B8_FLOPS_PER_SEGMENT[P]}), {x1 - (x2 - x1)} per sample")


def test_lane_flops_on_the_host_are_the_bound_counts(host_builds):
    """The lane groups' B4, B5 and B8: the lanes' shares summed and the work
    every lane repeats taken once are the bound's counts, per segment and per
    sample."""
    _, r, _ = host_counts(host_builds)
    (n1, _, _), (n2, _, _) = r[0], r[1]
    assert n2 - n1 == chip_smoke.SU4_FLOPS_PER_SEGMENT
    assert n1 - (n2 - n1) == chip_smoke.SU4_FLOPS_PER_SAMPLE
    for P, (n1, _, _), (n2, _, _) in zip((2, 3, 4), r[2:5], r[5:8]):
        assert n2 - n1 == chip_smoke.SU4_VJP_FLOPS_PER_SEGMENT[P], P
        assert n1 - (n2 - n1) == chip_smoke.SU4_VJP_FLOPS_PER_SAMPLE, P
    for P, (n1, _, _), (n2, _, _) in zip((2, 3, 4), r[8:11], r[11:14]):
        assert n2 - n1 == chip_smoke.SU4_B8_FLOPS_PER_SEGMENT[P], P
        assert n1 - (n2 - n1) == chip_smoke.SU4_B8_FLOPS_PER_SAMPLE, P


# B7 on chunks (su4.cuh, "B7 on chunks"): a sample's L segments split into
# K chunks, one thread each, combined in a fixed tree of dense products;
# M = 45 leaves the last samples side by side past M (zero disorder, not
# stored); K > L leaves chunks with no segment.
@pytest.mark.parametrize("K", [1, 2, 4, 5, 8, 16, 32])
@pytest.mark.parametrize("L", [1, 7, 20])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_chunked_compose_math_on_the_host(host_builds, P, L, K):
    """B7 on K chunks (``compose_chunk()``, ``combine_chunks()``, chunk 0's
    product) against the plain version in f64 at the product tolerance."""
    B, M, xt, J, s = 2, 45, 0.1, 0.5, 4
    _, pulses, d1, d2, ep = pulse_case(P, B, L, M, 80 + 10 * P + L)
    W = run_host(host_builds["math"], 5, B, L, P, M, xt, J, s, K,
                 arrays=(pulses, d1, d2, ep)).reshape(B, M, 4, 4, 2)
    Ur, Ui = tsu4.propagate_su4_mc(*(torch.from_numpy(a).double() for a in (pulses, d1, d2, ep)),
                                   plain_system(P, xt, J, s))
    np.testing.assert_allclose(W[..., 0], Ur.numpy(), atol=PROD_TOL, rtol=0)
    np.testing.assert_allclose(W[..., 1], Ui.numpy(), atol=PROD_TOL, rtol=0)


# the design's overhead per sample on K chunks: K - 1 combines (matmul, 480
# flops)
COMBINE_FLOPS = 480


@pytest.mark.parametrize("K", [2, 4])
def test_chunk_flops_on_the_host_are_the_bound_counts(host_builds, K):
    """B7 on K chunks: the flops the function needs are the bound's
    (``chip_smoke.py``'s 3661 a segment, 10 a sample), and the combine's are
    apart, the same at every L; every chunk past the first forms the
    per-sample work again."""
    _, _, chunks = host_counts(host_builds)
    (n1, c1, x1), (n2, c2, x2) = chunks[:2] if K == 2 else chunks[2:]
    assert n2 - n1 == K * chip_smoke.SU4_FLOPS_PER_SEGMENT
    assert n1 - K * chip_smoke.SU4_FLOPS_PER_SEGMENT == chip_smoke.SU4_FLOPS_PER_SAMPLE
    assert c1 == c2 == (K - 1) * COMBINE_FLOPS
    assert x1 == n1 + c1 + (K - 1) * chip_smoke.SU4_FLOPS_PER_SAMPLE
    print(f"B7 on {K} chunks: {x2 - x1} flops executed per {K} sample-segments "
          f"(bound {n2 - n1}), combine {c1} a sample, {x1 - (x2 - x1)} per sample in all")


N_SM = 132  # an H100's SMs


def host_plans(host_builds, queries):
    """B7's plan K for each ``(B, M, L)`` on N_SM SMs."""
    stdin = f"6 {len(queries)}\n" + "\n".join(f"{B} {M} {L} {N_SM}" for B, M, L in queries)
    out = subprocess.run([str(host_builds["math"])], input=stdin, capture_output=True,
                         text=True, check=True).stdout.split()
    return [int(k) for k in out]


# the paths' B7 launches on an H100, with the plans measured best there
# (PERF.md): the GRAPE robustness curve, serving's E[F](sigma) sweep, the
# variants' sweep; then chip_smoke.py's check-su4 shapes (3 targets), which
# no path launches
@pytest.mark.parametrize("B,M,L,plan", [
    (1, 4096, 20, 4),
    (1, 40_000, 100, 2),
    (1, 2_000_000, 20, 1),
    (3, 200, 1, 1),
    (3, 200, 7, 4),
    (3, 200, 100, 16),
    (3, 16_384, 100, 1),
])
def test_launch_plan_on_the_host(host_builds, B, M, L, plan):
    """B7's plan (``prop_plan()``) at the paths' and the check's shapes."""
    assert host_plans(host_builds, [(B, M, L)]) == [plan]


@pytest.mark.parametrize("L", [1, 2, 3, 7, 20, 100])
def test_launch_plan_keeps_the_schedulers_supplied(host_builds, L):
    """The plan's K is a power of two within a warp and at most L; and where
    one thread per sample would give the schedulers under 1.5 warps each
    (blocks of 128 threads, 4 warps, over N_SM SMs of 4 schedulers), K > 1
    unless L = 1."""
    queries = [(B, M, L) for B in (1, 3, 5, 32)
               for M in (1, 45, 128, 1000, 4096, 6335, 6336, 8192, 12_800, 40_000, 2_000_000)]
    for (B, M, L_), K in zip(queries, host_plans(host_builds, queries)):
        case = (B, M, L_, K)
        assert K & (K - 1) == 0 and 1 <= K <= min(32, L_), case
        if B * -(-M // 128) < 1.5 * N_SM and L_ > 1:
            assert K > 1, case
