#!/usr/bin/env python3
r"""Smoke run of the PyTorch port on one CUDA card: build, check, serve,
score, train, and the two-qubit serving and training paths, then time.

    python3 chip_smoke.py

Twelve phases, each printing its own line with its seconds:

1. device: the card, torch and CUDA versions, ``nvidia-smi`` name and power limit;
2. build: one ``nvcc`` call per source, started together
   (``ops/csrc/propagate_su2.cu``: B1, B2, B3; ``propagate_su4.cu``: B4,
   B6, B7; ``propagate_su4_bwd.cu``: B5), with ptxas' registers and spills
   per kernel;
3. check: kernels B1 (mean fidelity), B3 (per-sample product) and B2 (the
   VJP of B3) against their plain PyTorch versions on the card, P ∈ {2, 3,
   4}, L ∈ {1, 7, 100}, M ∈ {1000, 2¹⁶}, plus B2 at L = 400, P = 4; and the
   full gradient of B1 (its backward runs B3 and B2) against autograd
   through its plain version;
4. check-su4: kernels B7 (SU(4) per-sample product) and B6 (SU(4) mean
   fidelity) against their plain versions, P ∈ {2, 3, 4 (drive2)},
   L ∈ {1, 7, 100}, M ∈ {200, 2¹⁴}; at L = 100 also against the plain
   version in f64;
5. check-su4-train: kernels B4 (B6 with each sample's product) and B5 (the
   product-seeded reverse sweep) against their plain versions, B5 under a
   non-uniform per-target cotangent, P ∈ {2, 3, 4}, L ∈ {3, 7, 100},
   M ∈ {1, 200, 1000};
6. serve: the ``length_100`` flagship (d512 × 8 layers, 16 heads, L = 100,
   P = 2) from its shipped ``.npz``, in bf16 (as the JAX demo serves) and
   f32, for the 5 named gates plus 3 random targets;
7. score: E[F] of those pulse tables through B1 at σ_δ = 1.0, ε_std = 0.05,
   M = 2²⁰ per target, and ``mc_fidelity_estimate`` through B3 on X(π),
   held against the flagship's published X(π) E[F] of 0.9502;
8. train: the training CLI (``workloads/universal_single_qubit.py``) at the
   flagship's full width with ``--backend pallas``, batch 200, M = 1000,
   two epochs of 5 steps in each of the three curriculum bands; then one
   step's gradient through ``pallas`` against ``xla`` from the same
   weights and draws, and ms per train step;
9. serve-su4: the two-qubit flagship ``two_qubit_d2_kak`` (d512 × 8 layers,
   16 heads, L = 100, drive2 P = 4, KAK tokens) from its shipped ``.npz``
   in f32, best-of-ℤ₄ serving of the 5 named gates (20 model inputs; the
   choice scored by B6), card pulses held against CPU pulses;
10. score-su4: ``workloads/two_qubit_eval.py::eval_pulse_tables`` through
    B6 at σ_δ ∈ {0, 0.1, 0.2}, M = 20 000, ε_std = 0.05, held against the
    JAX package's CPU table; then ``analysis/plots_su4.py``'s E[F](σ_δ)
    sweep (20 σ × 2000) and F(δ₁, δ₂) grid (61²) of CZ through B7, each
    against its plain version on the card;
11. train-su4: the two-qubit training CLI (``workloads/two_qubit.py``) on
    the flagship's recipe at full width with ``--backend pallas`` (batch
    32, M = 1024, σ_δ = 0.2, warm-started from ``two_qubit_d2_kak.npz``),
    2 epochs of 2 steps, its eval E[F] held above 0.85; then one step's
    gradient through ``pallas`` against ``xla`` at that width and M, ms per
    step of each, and a profile of pallas steps;
12. time: each kernel at the shape of each path that runs it (B1 and B3
    serving and training, B2 training, B6 and B7 two-qubit serving, B4, B5
    and B6 two-qubit training) with CUDA events, beside its plain version,
    its bound and its ptxas registers, spills and stack; one row of the
    ``kernels`` line per kernel and path, with that path's launches.

Phases 6–7 are the single-qubit serving path, phase 8's CLI run the
training path, phases 9–10 the two-qubit serving path and phase 11's CLI
run the two-qubit training path; the kernels' launch counters are set to 0
just before each and read just after, and every kernel of the path must
have been launched there.  Any failure raises and the run exits nonzero.
The line before the last is the card's ``nvidia-smi`` name and power
limit; the last line is ``{"ok": true, "device": {...}}``.  Exits nonzero
without a result where CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# f32 peak outside the tensor cores and HBM rate of one H100 SXM at 700 W
# (NVIDIA data sheet); the card's actual power limit is printed beside them.
PEAK_F32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12

# flops per (sample, segment), an FMA counted as 2 as in the peak above:
# Hamilton product 28 (16 products, 12 sums); sincos 20 (range reduction and
# the two minimax polynomials the JAX kernel evaluates); segment build 5 at
# P = 2 (half angle, sin scale, 3 axis products), 12 at P = 3 (axis norm,
# angle, division, 4 products), 13 at P = 4 (+ Δ + δ).
FLOPS_PER_SEGMENT = {2: 53, 3: 60, 4: 61}
FLOPS_PER_SAMPLE_FIDELITY = 12  # <q, q_t>, F, the sum

# B2 per (sample, segment), counted the same way from propagate_mc_vjp_kernel:
# the forward rebuild (segment 25 / 33 / 34 at P = 2 / 3 / 4, Hamilton 28),
# the sweep's segment again, three Hamilton products (R_k, A_k = G o conj(R_k)
# and the update G <- conj(q_k) o G, where G = conj(L_k) o g: 84), the chain
# rule (39 at P = 2; 55 with the Omega term at P = 3 / 4) and one add per
# pulse channel for the sum over samples.  Three products are what the VJP
# needs.
VJP_FLOPS_PER_SEGMENT = {2: 203, 3: 236, 4: 239}

FID_TOL = 1e-5  # as tests/test_pallas_kernel.py holds the JAX kernels
XPI_PUBLISHED = 0.9502  # README.md per-gate table, flagship X(π) at σ_δ = 1.0
XPI_TOL = 0.005
SERVE_TOL = 1e-3  # card f32 vs CPU f32 pulses (φ modulo 2π)
GRAD_RTOL = 1e-4  # as tests/test_pallas_kernel.py holds the JAX VJP kernel
TRAIN_GRAD_TOL = 1e-4  # pallas vs xla, relative to the global gradient norm

# SU(4), B4, B6 and B7, per (sample, segment) as counted in su4.cuh's
# compose(), which forms only what the math needs: A = -iHτ/2⁴ is sparse
# (12 of its 32 reals are zero) and anti-Hermitian, A² and A⁴ Hermitian, A³
# anti-Hermitian, so each is formed as an upper triangle from the products
# that are not zero: 10 (A) + 37 (A², closed form) + 128 (A³ = A²A) + 166
# (A⁴ = A²A²) + 184 (P − I, Q) + 448 (P − I + A⁴Q) + 4 × 544 (squarings of
# I + X as 2X + X², dense) + 512 (W ← W + X W); per sample 10 (energies,
# (1 + ε)/2) and, for B6 and B4, 134 (Tr(U†T), F, the sum).
SU4_FLOPS_PER_SEGMENT = 3661
SU4_FLOPS_PER_SAMPLE = 10
SU4_FLOPS_PER_SAMPLE_FIDELITY = 134
# B5 per (sample, segment), counted the same way from su4.cuh's
# reverse_sweep(): the segment rebuilt to T8(A) − I (973), the T8 adjoint
# (products with A⁴, Qᴴ, A², A: 3552), four squarings (2176) beside four
# squaring adjoints (4224), U_k = I + X (4), the 20 entries of D = E·U_k that
# the chain rule reads (316), the chain rule (57 / 58 / 65 at P = 2 / 3 / 4),
# V ← U_kᴴ V U_k (960) and one add per pulse channel for the sum over
# samples; per sample the energies, (1 + ε)/2 (10) and the seed V = G Pᴴ
# from the saved product (706).  Both held to the host build of the same code
# by tests/test_torch_su4_host.py.
SU4_VJP_FLOPS_PER_SEGMENT = {2: 12264, 3: 12266, 4: 12274}
SU4_VJP_FLOPS_PER_SAMPLE = 716
# the JAX suite's tolerances for its Pallas SU(4) kernels (tests/test_su4_pallas.py:43,
# :69, :121): products 2e-5, fidelities 1e-5 (2e-5 on drive2); at L = 100 widened to
# twice the plain f32 version's own error against f64 where that is larger
SU4_PROD_TOL = 2e-5
SU4_FID_TOL = {2: 1e-5, 3: 1e-5, 4: 2e-5}
SU4_SWEEP_TOL = 1e-5  # E[F](σ) means, B7 against plain
SU4_MC_TOL = 0.005  # σ > 0: different draws, M = 20 000 (slice 1's rule)
SU4_EXACT_TOL = 1e-3  # σ = 0 (exact) against the JAX package's CPU value
# the two-qubit training path: the flagship recipe's batch and MC budget; its
# eval E[F] at σ_δ = 0.2 after a warm start must stay far above chance (the
# shipped model's blended figure is 0.951)
TRAIN4_BATCH, TRAIN4_MC = 32, 1024
TRAIN4_MIN_EVAL_FID = 0.85
# The JAX package's table on the CPU, from
#   JAX_PLATFORMS=cpu python -m universal_quantum_optimal_control_tpu.workloads.two_qubit_eval \
#       --sigmas 0,0.1,0.2 --monte_carlo 20000 --save_pulses jax_eval.npz
# (defaults: two_qubit_d2_kak.npz, drive2, KAK tokens, ω_min 0.05, L = 100,
# best-of-ℤ₄, ε_std 0.05, seed 7), the values of its meta_json:
# gate → E[F] at σ_δ = 0 (exact), 0.1, 0.2.
JAX_SU4_TABLE = {
    "cz": (0.9888486862182617, 0.9826241135597229, 0.9670261740684509),
    "zz(pi/4)": (0.99638831615448, 0.9918046593666077, 0.9810918569564819),
    "cnot": (0.989017128944397, 0.9810863137245178, 0.9633392095565796),
    "iswap": (0.9822724461555481, 0.9560391306877136, 0.9090651869773865),
    "sqrt_swap": (0.9938800930976868, 0.9852356910705566, 0.9655939936637878),
}


def quat_tol(L: int) -> float:
    """f32 rounding tolerance for per-sample quaternions: each segment's
    sincos and Hamilton product add a few f32 ulps (≲ 1e-6 on unit-norm
    components), accumulating at most linearly over L dependent products."""
    return max(1e-5, 1e-6 * L)


def phase(name: str, t0: float, msg: str) -> None:
    print(f"[{name}] {msg} ({time.perf_counter() - t0:.2f} s)", flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def random_inputs(gen, B, L, P, M, dev):
    def u(lo, hi, shape):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    cols = [u(-math.pi, math.pi, (B, L))]
    if P >= 3:
        cols.append(u(-0.3, 1.5, (B, L)))  # some Ω < 0 exercise the clamp
    if P == 4:
        cols.append(u(-1.0, 1.0, (B, L)))
    cols.append(u(0.05, 0.5, (B, L)))
    pulses = torch.stack(cols, dim=-1).contiguous()
    delta = torch.randn((B, M), generator=gen, device=dev)
    eps = 0.05 * torch.randn((B, M), generator=gen, device=dev)
    q_t = torch.randn((B, 4), generator=gen, device=dev)
    q_t = (q_t / q_t.norm(dim=-1, keepdim=True)).contiguous()
    return pulses, q_t, delta, eps


def time_ms(fn, iters: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def roofline(ops, nbytes):
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bound(B, L, P, M, out_bytes, fidelity):
    ops = B * M * (L * FLOPS_PER_SEGMENT[P]
                   + (FLOPS_PER_SAMPLE_FIDELITY if fidelity else 0))
    in_bytes = 4 * (B * L * P + 2 * B * M + (4 * B if fidelity else 0))
    return roofline(ops, in_bytes + out_bytes)


def vjp_bound(B, L, P, M):
    """B2: reads pulses, δ, ε and g (B, M, 4) once; writes dpulses, dδ, dε."""
    in_bytes = 4 * (B * L * P + 2 * B * M + 4 * B * M)
    out_bytes = 4 * (B * L * P + 2 * B * M)
    return roofline(B * M * L * VJP_FLOPS_PER_SEGMENT[P], in_bytes + out_bytes)


def grads_close(what, names, atols, got, want, exact):
    """Hold a kernel's gradients against its plain f32 version:
    ``|kernel − plain| ≤ max(atol, 2·e32) + 1e-4·|plain|`` elementwise, with
    the JAX suite's atol (1e-4 pulses and targets, 1e-5 δ and ε) and e32 the
    plain f32 version's own max error against the same computation in f64.
    At L ≤ 7 e32 stays below atol / 2; at L = 100 and beyond it does not (the
    prefix is rebuilt through up to L products and dδ, dε sum L terms of
    growing size), so there the bound is what f32 itself allows.  Returns the
    worst |kernel − plain|, |kernel − f64| and |plain − f64|."""
    worst = [0.0, 0.0, 0.0]
    for name, atol, a, b, x in zip(names, atols, got, want, exact):
        for label, t in (("kernel", a), ("plain", b), ("f64", x)):
            if not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{what} d{name}: {label} gradient is not finite")
        e32 = float((b.double() - x).abs().max())
        err = (a - b).abs()
        bound_ = max(atol, 2.0 * e32)
        if not bool((err <= bound_ + GRAD_RTOL * b.abs()).all()):
            raise AssertionError(f"{what} d{name}: max |kernel - plain| {float(err.max()):.3e} "
                                 f"beyond max({atol:.0e}, 2·{e32:.2e}) + {GRAD_RTOL:.0e}·|plain|")
        errs = (float(err.max()), float((a.double() - x).abs().max()), e32)
        worst = [max(w, e) for w, e in zip(worst, errs)]
    return tuple(worst)


def check_vjp(case, pulses, delta, eps, g):
    """B2 against its plain version (and both against f64)."""
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import (
        propagate_mc_vjp_cuda, propagate_mc_vjp_plain)
    got = propagate_mc_vjp_cuda(pulses, delta, eps, g)
    want = propagate_mc_vjp_plain(pulses, delta, eps, g)
    exact = propagate_mc_vjp_plain(*(t.double() for t in (pulses, delta, eps, g)))
    return grads_close(f"B2 {case}", ("pulses", "delta", "eps"), (1e-4, 1e-5, 1e-5),
                       got, want, exact), got, want


def check_mean_fidelity_grad(case, pulses, q_t, delta, eps, gen):
    """B1's full gradient (pulses, q_t, δ, ε) under a per-target cotangent
    against autograd through its plain version (and both against f64)."""
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import (
        mean_fidelity_cuda, mean_fidelity_plain)
    gbar = torch.rand(pulses.shape[0], generator=gen, device=pulses.device)

    def grad(fn, dtype):
        leaves = [t.to(dtype).clone().requires_grad_(True) for t in (pulses, q_t, delta, eps)]
        return torch.autograd.grad(fn(*leaves), leaves, gbar.to(dtype))

    return grads_close(f"B1 gradient {case}", ("pulses", "q_target", "delta", "eps"),
                       (1e-4, 1e-4, 1e-5, 1e-5), grad(mean_fidelity_cuda, torch.float32),
                       grad(mean_fidelity_plain, torch.float32),
                       grad(mean_fidelity_plain, torch.float64))


def wrapped_phi_err(a: torch.Tensor, b: torch.Tensor, angles: int = 1) -> float:
    """Max |a − b| with the first ``angles`` channels compared modulo 2π."""
    d = torch.remainder(a[..., :angles] - b[..., :angles] + math.pi, 2 * math.pi) - math.pi
    return max(float(d.abs().max()), float((a[..., angles:] - b[..., angles:]).abs().max()))


def su4_random_inputs(gen, B, L, P, M, dev):
    """SU(4) pulses (φ, [φ₂,] [Ω,] τ) with some Ω < 0 (the clamp), disorder
    at σ 0.3 / 0.3 / 0.05 and random unitary targets; P = 4 is drive2."""
    from universal_quantum_optimal_control_tpu_torch.core.su4 import TwoQubitSystem

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((B, L), generator=gen, device=dev)

    cols = [u(-math.pi, math.pi)] + ([u(-math.pi, math.pi)] if P == 4 else []) \
        + ([u(-0.3, 2.0)] if P >= 3 else []) + [u(0.05, 0.6)]
    pulses = torch.stack(cols, dim=-1).contiguous()
    d1, d2, ep = (s * torch.randn((B, M), generator=gen, device=dev) for s in (0.3, 0.3, 0.05))
    z = torch.complex(torch.randn((B, 4, 4), generator=gen, device=dev, dtype=torch.float64),
                      torch.randn((B, 4, 4), generator=gen, device=dev, dtype=torch.float64))
    T = torch.linalg.qr(z)[0]
    return (pulses, T.real.float().contiguous(), T.imag.float().contiguous(), d1, d2, ep,
            TwoQubitSystem(drive2=P == 4))


def max_err(a, b) -> float:
    """Max |a − b| over a tensor or a (re, im) pair, in f64."""
    if isinstance(a, tuple):
        return max(max_err(x, y) for x, y in zip(a, b))
    return float((a.double() - b.double()).abs().max())


def su4_bound(B, L, P, M, fidelity, product=False):
    """B6 (``fidelity``), B4 (``fidelity`` and ``product``) or B7: reads
    pulses, δ₁, δ₂, ε (and the target) once; writes (B,) means, the
    per-sample products, or both."""
    per_sample = L * SU4_FLOPS_PER_SEGMENT + SU4_FLOPS_PER_SAMPLE
    if fidelity:
        per_sample += SU4_FLOPS_PER_SAMPLE_FIDELITY
    in_bytes = 4 * (B * L * P + 3 * B * M + (32 * B if fidelity else 0))
    out_bytes = (4 * B if fidelity else 0) + (4 * 32 * B * M if product or not fidelity else 0)
    return roofline(B * M * per_sample, in_bytes + out_bytes)


def su4_vjp_bound(B, L, P, M):
    """B5: reads pulses, the targets, ḡ, δ₁, δ₂, ε and B4's product once;
    writes dpulses, dδ₁, dδ₂ and dε."""
    in_bytes = 4 * (B * L * P + 32 * B + B + 3 * B * M + 32 * B * M)
    out_bytes = 4 * (B * L * P + 3 * B * M)
    flops = B * M * (L * SU4_VJP_FLOPS_PER_SEGMENT[P] + SU4_VJP_FLOPS_PER_SAMPLE)
    return roofline(flops, in_bytes + out_bytes)


def ptxas_table(built) -> dict:
    """``{entry function: {registers, stack_bytes, spill_store_bytes,
    spill_load_bytes}}`` from the libraries' ``-Xptxas -v`` logs."""
    table, name = {}, None
    for b in built.values():
        for line in b["log"].splitlines():
            m = re.search(r"Compiling entry function '([^']+)'", line)
            if m:
                name = m.group(1)
                table[name] = {}
                continue
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                          r"(\d+) bytes spill loads", line)
            if m and name:
                table[name].update(stack_bytes=int(m[1]), spill_store_bytes=int(m[2]),
                                   spill_load_bytes=int(m[3]))
            m = re.search(r"Used (\d+) registers", line)
            if m and name:
                table[name]["registers"] = int(m[1])
    return table


def ptxas_of(table: dict, fragment: str) -> dict:
    """The one entry function whose mangled name contains ``fragment``."""
    hits = [v for k, v in table.items() if fragment in k]
    if len(hits) != 1:
        raise AssertionError(f"{len(hits)} ptxas entries match {fragment!r}")
    return hits[0]


def check_su4_train(gen, dev) -> str:
    """B4 (mean and product) against its plain version and B5 against
    autograd through the plain forward under a non-uniform per-target ḡ (the
    CVaR path), P ∈ {2, 3, 4}, L ∈ {3, 7, 100}, M ∈ {1, 200, 1000}; every
    P ≥ 3 case has Ω < 0 entries.  Tolerances: B4 as B6 and B7 in
    check-su4; B5 the JAX suite's 1e-5 abs on gradients
    (tests/test_su4_pallas_bwd.py) with grads_close's relative part, widened
    to twice the plain f32 version's own error against f64 where larger."""
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su4 import (
        mean_fidelity_su4_with_product_cuda, mean_fidelity_su4_with_product_plain,
        su4_objective_vjp_from_product_cuda, su4_objective_vjp_from_product_plain)
    worst_f, worst_u, worst_g = 0.0, 0.0, [0.0] * 3
    n = 0
    for P in (2, 3, 4):
        for L in (3, 7, 100):
            for M in (1, 200, 1000):
                case = f"P={P} L={L} M={M}"
                pulses, tr, ti, d1, d2, ep, sys4 = su4_random_inputs(gen, 3, L, P, M, dev)
                gbar = 0.1 + torch.rand(3, generator=gen, device=dev)
                F_k, prod_k = mean_fidelity_su4_with_product_cuda(pulses, tr, ti, d1, d2, ep, sys4)
                got = su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar, prod_k,
                                                          sys4)
                torch.cuda.synchronize()
                F_p, prod_p = mean_fidelity_su4_with_product_plain(pulses, tr, ti, d1, d2, ep, sys4)
                err_f, err_u = max_err(F_k, F_p), max_err(prod_k, prod_p)
                tol_u, tol_f = SU4_PROD_TOL, SU4_FID_TOL[P]
                args64 = [t.double() for t in (pulses, tr, ti, d1, d2, ep)]
                if L > 7:
                    F64, prod64 = mean_fidelity_su4_with_product_plain(*args64, sys4)
                    tol_u = max(tol_u, 2 * max_err(prod_p, prod64))
                    tol_f = max(tol_f, 2 * max_err(F_p, F64))
                if not err_u <= tol_u:
                    raise AssertionError(f"B4 {case}: |product kernel - plain| {err_u:.3e} > "
                                         f"{tol_u:.2e}")
                if not err_f <= tol_f:
                    raise AssertionError(f"B4 {case}: |F kernel - plain| {err_f:.3e} > {tol_f:.2e}")
                want = su4_objective_vjp_from_product_plain(pulses, tr, ti, d1, d2, ep, gbar,
                                                            prod_p, sys4)
                exact = su4_objective_vjp_from_product_plain(*args64, gbar.double(), None, sys4)
                e5 = grads_close(f"B5 {case}", ("pulses", "delta1", "delta2", "eps"),
                                 (1e-5,) * 4, got, want, exact)
                worst_f, worst_u = max(worst_f, err_f), max(worst_u, err_u)
                worst_g = [max(w, e) for w, e in zip(worst_g, e5)]
                n += 1
                print(f"  {case}: B4 F err {err_f:.2e} (tol {tol_f:.1e}), product err "
                      f"{err_u:.2e} (tol {tol_u:.1e}); B5 err {e5[0]:.2e} (vs f64: kernel "
                      f"{e5[1]:.2e}, plain {e5[2]:.2e})")
    return (f"{n} cases; worst B4 F {worst_f:.3e}, product {worst_u:.3e}; worst B5 {worst_g[0]:.3e} "
            f"against plain (atol max(1e-5, 2× the plain f32 error), rtol {GRAD_RTOL:.0e}); "
            f"against f64: B5 kernel {worst_g[1]:.3e} / plain {worst_g[2]:.3e}")


def train_su4(ckpt, kw4, dev) -> dict:
    """The two-qubit training path: the CLI (``workloads/two_qubit.py``) on
    the ``two_qubit_d2_kak`` recipe at full width with ``--backend pallas``,
    warm-started from the shipped weights, 2 epochs of 2 steps in the σ_δ =
    0.2 band, with the kernels' counters set to 0 just before and read just
    after; then one step's gradient through ``pallas`` against ``xla`` from
    the same weights and draws, ms per step, and a profile of pallas steps.
    Returns what the time phase needs."""
    from universal_quantum_optimal_control_tpu_torch.data import kak_input_tokens
    from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as t4
    from universal_quantum_optimal_control_tpu_torch.training import (CurriculumBand, SU4System,
                                                                      TrainConfig, Trainer)
    from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit, two_qubit_eval

    B, M = TRAIN4_BATCH, TRAIN4_MC
    counters = {"B4": t4.mean_fidelity_su4_with_product_cuda,
                "B5": t4.su4_objective_vjp_from_product_cuda,
                "B6": t4.mean_fidelity_su4_cuda, "B7": t4.propagate_su4_mc_cuda}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "run"
        argv = ["--device", "cuda", "--backend", "pallas", "--max_pulses", "100",
                "--d_model", "512", "--n_layers", "8", "--n_heads", "16", "--drive2",
                "--kak_tokens", "--omega_min", "0.05", "--target_mode", "mixed",
                "--phase_augment", "--batch_size", str(B), "--monte_carlo", str(M),
                "--curriculum", "0.2", "--lr_schedule", "cosine", "--learning_rate", "1e-4",
                "--reset_opt_per_band", "--shuffle", "--recover_collapse", "0.05",
                "--restore", ckpt, "--train_size", "64", "--eval_size", "32",
                "--num_epoch", "2", "--save_path", str(save)]
        for c in counters.values():
            c.launches = 0
        history = two_qubit.main(argv)
        torch.cuda.synchronize()
        launches = {k: c.launches for k, c in counters.items()}
        t_cli = time.perf_counter() - t0
        if min(launches[k] for k in ("B4", "B5", "B6")) < 1:
            raise AssertionError(f"a kernel was not launched on the two-qubit training path: "
                                 f"{launches}")
        band = history["bands"][0]
        losses, fids = band["train_loss"], band["eval_fid"]
        if len(history["bands"]) != 1 or len(losses) != 2 or len(fids) != 2:
            raise AssertionError(f"expected 1 band × 2 epochs, got {history}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"a training loss is not finite: {losses}")
        if not all(TRAIN4_MIN_EVAL_FID < x <= 1.0 for x in fids):
            raise AssertionError(f"eval E[F] at sigma 0.2 {fids} outside ({TRAIN4_MIN_EVAL_FID}, "
                                 f"1] (the shipped model's blended figure is 0.951): the restore "
                                 f"or the KAK tokens are wrong")
        exports = sorted(save.glob("*_pulses.npz"))
        if len(exports) != 1 or not (save / "metrics.csv").exists():
            raise AssertionError(f"pulse exports {exports}, metrics.csv "
                                 f"{(save / 'metrics.csv').exists()}")
        with np.load(exports[0]) as z:
            if z["pulses"].shape != (64, 100, 4) or not np.isfinite(z["pulses"]).all():
                raise AssertionError(f"{exports[0].name}: {z['pulses'].shape}")
    print(f"  CLI: 1 band × 2 epochs × 2 steps at batch {B}, M = {M}, L = 100, d512 × 8 in "
          f"{t_cli:.2f} s; train loss " + " ".join(f"{x:.4f}" for x in losses)
          + "; eval E[F] at sigma 0.2 " + " ".join(f"{x:.5f}" for x in fids)
          + f"; launches {launches}")

    # one step's gradient through pallas and xla from the same weights and draws
    sys_p = SU4System(drive2=True, backend="pallas")
    model = two_qubit_eval.load_two_qubit_model(ckpt, device=dev, **kw4)
    targets = two_qubit.build_targets(2027, B, sys_p.system, mode="mixed", phase_augment=True)
    U = targets[:, 0].double().numpy() + 1j * targets[:, 1].double().numpy()
    x = torch.from_numpy(kak_input_tokens(U)).to(dev)
    targets = targets.to(dev)
    trainers = {b: Trainer(model, TrainConfig(monte_carlo=M, batch_size=B, learning_rate=1e-4),
                           system=SU4System(drive2=True, backend=b), device=dev)
                for b in ("pallas", "xla")}
    band = CurriculumBand(0.2)
    errors = trainers["pallas"].sample_errors(B, band)
    grads, step_loss, peak = {}, {}, {}
    for b, tr in trainers.items():
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        loss, _ = tr.objective(x, targets, errors)
        loss.backward()
        torch.cuda.synchronize()
        peak[b] = torch.cuda.max_memory_allocated() / 2**30
        grads[b] = torch.cat([p.grad.flatten() for p in model.parameters()])
        step_loss[b] = float(loss.detach())
    # the plain f32 version's own error at L = 100: the same step's loss and
    # pulse cotangent in f64 (the plain version from the model's pulses on),
    # chained through the same model Jacobian
    tr = trainers["xla"]
    model.train(False)
    pulses = model(x)
    p64 = pulses.detach().double().requires_grad_(True)
    F64 = t4.mean_fidelity_su4_plain(p64, *(t.double() for t in (targets[:, 0], targets[:, 1],
                                                                 *errors)), sys_p.system)
    (dp64,) = torch.autograd.grad(tr._loss_of_mean_fid(torch.mean(F64)), p64)
    g64 = torch.cat([g.flatten() for g in torch.autograd.grad(
        pulses, list(model.parameters()), dp64.float())])
    n64 = float(g64.norm())
    e32 = {b: float((g - g64).norm()) / n64 for b, g in grads.items()}
    gnorm = float(grads["xla"].norm())
    rel = float((grads["pallas"] - grads["xla"]).norm()) / gnorm
    tol = max(TRAIN_GRAD_TOL, 2.0 * e32["xla"])
    print(f"  one step at M = {M} (the plain autograd fits: peak {peak['xla']:.2f} GiB, pallas "
          f"{peak['pallas']:.2f} GiB), pallas vs xla: loss {step_loss['pallas']:.6f} / "
          f"{step_loss['xla']:.6f}, |g_pallas - g_xla| / |g_xla| {rel:.3e} (|g| {gnorm:.4e}, "
          f"tol max({TRAIN_GRAD_TOL:.0e}, 2× the plain f32 error) = {tol:.2e}); against the "
          f"step in f64 (loss and pulse cotangent): pallas {e32['pallas']:.3e}, xla "
          f"{e32['xla']:.3e} of the norm")
    if not rel <= tol:
        raise AssertionError(f"two-qubit pallas vs xla gradient: {rel:.3e} of the norm > "
                             f"{tol:.2e}")

    # ms per train step (fresh draws and dropout, as in the CLI), host clock
    # around synchronized steps
    step_ms = {}
    for b, n in (("pallas", 10), ("xla", 2)):
        tr = trainers[b]
        tr.train_step(x, targets, tr.sample_errors(B, band), dropout=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            tr.train_step(x, targets, tr.sample_errors(B, band), dropout=True)
        torch.cuda.synchronize()
        step_ms[b] = 1e3 * (time.perf_counter() - t1) / n
    tr = trainers["pallas"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            tr.train_step(x, targets, tr.sample_errors(B, band), dropout=True)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    dev_ms = sum(e.self_device_time_total for e in events) / 3e3
    ours_ms = sum(e.self_device_time_total for e in events
                  if any(k in e.key for k in ("mean_fid_su4_kernel", "su4_vjp_kernel",
                                              "reduce_partials_kernel",
                                              "reduce_columns_kernel"))) / 3e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"  profile of 3 pallas steps: kernels {dev_ms:.3f} ms per step, "
          f"{100 * dev_ms / step_ms['pallas']:.1f} % of the {step_ms['pallas']:.2f} ms step "
          f"(B4/B5 and their reductions {ours_ms:.3f} ms, "
          f"{100 * ours_ms / step_ms['pallas']:.1f} %); top, us per step: " + "; ".join(
              f"{e.key[:40]} {e.self_device_time_total / 3:.0f}" for e in top))
    model.eval()
    with torch.no_grad():
        pulses = model(x).contiguous()
    return {"launches": launches, "step_ms": step_ms, "fids": fids, "rel": rel, "e32": e32,
            "pulses": pulses, "targets": targets, "errors": errors}


def main() -> int:
    t_total = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke run "
              "needs a CUDA card", file=sys.stderr)
        return 1

    from universal_quantum_optimal_control_tpu_torch.analysis import mc_fidelity_estimate
    from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
    from universal_quantum_optimal_control_tpu_torch.data import named_gate_rotation_vectors
    from universal_quantum_optimal_control_tpu_torch.demo.app import (compute_pulses,
                                                                      load_pipeline)
    from universal_quantum_optimal_control_tpu_torch.ops import _build
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import (
        mean_fidelity_cuda, mean_fidelity_plain, propagate_mc_cuda, propagate_mc_plain,
        propagate_mc_vjp_cuda, propagate_mc_vjp_plain)
    from universal_quantum_optimal_control_tpu_torch.parallel import mean_fidelity_local
    from universal_quantum_optimal_control_tpu_torch.models import UniversalQOCTransformer
    from universal_quantum_optimal_control_tpu_torch.data import build_su2_dataset
    from universal_quantum_optimal_control_tpu_torch.training import (CurriculumBand,
                                                                      TrainConfig, Trainer)
    from universal_quantum_optimal_control_tpu_torch.utils import load_model_params
    from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit
    from universal_quantum_optimal_control_tpu_torch.analysis import plots_su4
    from universal_quantum_optimal_control_tpu_torch.core.su4 import fidelity_su4_ri
    from universal_quantum_optimal_control_tpu_torch.data import z4_representatives
    from universal_quantum_optimal_control_tpu_torch.demo.app import two_qubit_model_kwargs
    from universal_quantum_optimal_control_tpu_torch.ops.propagate_su4 import (
        mean_fidelity_su4_cuda, mean_fidelity_su4_plain, mean_fidelity_su4_with_product_cuda,
        mean_fidelity_su4_with_product_plain, propagate_su4_mc_cuda, propagate_su4_mc_plain,
        su4_objective_vjp_from_product_cuda, su4_objective_vjp_from_product_plain)
    from universal_quantum_optimal_control_tpu_torch.optimizers import named_two_qubit_targets
    from universal_quantum_optimal_control_tpu_torch.training import SU4System
    from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit_eval

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. device
    t0 = time.perf_counter()
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    phase("device", t0, f"{kind}; count {torch.cuda.device_count()}; torch "
          f"{torch.__version__}; CUDA {torch.version.cuda}; nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build_libraries()
    for name, b in built.items():
        _build.load_library(name)
        print(f"  {name}: nvcc {'cached' if b['cached'] else 'built'} {b['path']} in "
              f"{b['seconds']:.2f} s")
        for line in b["log"].splitlines():
            if any(k in line for k in ("registers", "Compiling entry", "spill")):
                print("    " + line.strip())
    ptx = ptxas_table(built)
    phase("build", t0, f"{len(built)} libraries, one nvcc call each, started together")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst_f, worst_q, worst_g, worst_fg = 0.0, 0.0, [0.0] * 3, [0.0] * 3
    for P in (2, 3, 4):
        for L in (1, 7, 100):
            for M in (1000, 1 << 16):
                pulses, q_t, delta, eps = random_inputs(gen, 3, L, P, M, dev)
                case = f"P={P} L={L} M={M}"
                f_k = mean_fidelity_cuda(pulses, q_t, delta, eps)
                f_p = mean_fidelity_plain(pulses, q_t, delta, eps)
                q_k = propagate_mc_cuda(pulses, delta, eps)
                q_p = propagate_mc_plain(pulses, delta, eps)
                torch.cuda.synchronize()
                err_f = float((f_k - f_p).abs().max())
                err_q = float((q_k - q_p).abs().max())
                err_n = float((q_k.norm(dim=-1) - 1.0).abs().max())
                same_sign = bool(((q_k * q_p).sum(-1) > 0).all())
                if not err_f <= FID_TOL:
                    raise AssertionError(f"B1 {case}: |F kernel - plain| {err_f:.3e} > {FID_TOL}")
                if not (err_q <= quat_tol(L) and err_n <= quat_tol(L)):
                    raise AssertionError(
                        f"B3 {case}: |q kernel - plain| {err_q:.3e}, | |q| - 1 | "
                        f"{err_n:.3e}, tolerance {quat_tol(L):.0e}")
                if not same_sign:
                    raise AssertionError(f"B3 {case}: quaternion sign differs from plain")
                worst_f, worst_q = max(worst_f, err_f), max(worst_q, err_q)
                g = torch.randn((3, M, 4), generator=gen, device=dev)
                e2, _, _ = check_vjp(case, pulses, delta, eps, g)
                e1 = check_mean_fidelity_grad(case, pulses, q_t, delta, eps, gen)
                worst_g = [max(w, e) for w, e in zip(worst_g, e2)]
                worst_fg = [max(w, e) for w, e in zip(worst_fg, e1)]
                print(f"  {case}: B1 err {err_f:.2e}  B3 err {err_q:.2e} "
                      f"norm err {err_n:.2e}  B2 err {e2[0]:.2e} (vs f64: kernel "
                      f"{e2[1]:.2e}, plain {e2[2]:.2e})  B1 grad err {e1[0]:.2e} "
                      f"(vs f64: {e1[1]:.2e}, {e1[2]:.2e})")
    # L = 400 at P = 4: B2 opts in to 59 KB of shared memory
    pulses, _, delta, eps = random_inputs(gen, 2, 400, 4, 1000, dev)
    g = torch.randn((2, 1000, 4), generator=gen, device=dev)
    e2, _, _ = check_vjp("P=4 L=400 M=1000", pulses, delta, eps, g)
    worst_g = [max(w, e) for w, e in zip(worst_g, e2)]
    print(f"  P=4 L=400 M=1000: B2 err {e2[0]:.2e} (vs f64: kernel {e2[1]:.2e}, "
          f"plain {e2[2]:.2e})")
    phase("check", t0, f"18 cases + B2 at L=400; worst B1 {worst_f:.3e} (tol "
          f"{FID_TOL:.0e}), worst B3 {worst_q:.3e} (tol max(1e-5, 1e-6 L)), worst B2 "
          f"{worst_g[0]:.3e} and B1 gradient {worst_fg[0]:.3e} against plain (rtol "
          f"{GRAD_RTOL:.0e}, atol max(1e-4 / 1e-5, 2× the plain f32 error)); against "
          f"f64: B2 kernel {worst_g[1]:.3e} / plain {worst_g[2]:.3e}, B1 gradient "
          f"kernel {worst_fg[1]:.3e} / plain {worst_fg[2]:.3e}")

    # 4. check-su4: B7 and B6 against their plain versions; at L = 100 the
    # tolerance is the larger of the JAX suite's and twice the plain f32
    # version's own error against f64 on the same inputs
    t0 = time.perf_counter()
    worst_u, worst_f4 = 0.0, 0.0
    for P in (2, 3, 4):
        for L in (1, 7, 100):
            for M in (200, 1 << 14):
                case = f"P={P} L={L} M={M}"
                pulses, tr, ti, d1, d2, ep, sys4 = su4_random_inputs(gen, 3, L, P, M, dev)
                U_k = propagate_su4_mc_cuda(pulses, d1, d2, ep, sys4)
                F_k = mean_fidelity_su4_cuda(pulses, tr, ti, d1, d2, ep, sys4)
                U_p = propagate_su4_mc_plain(pulses, d1, d2, ep, sys4)
                F_p = mean_fidelity_su4_plain(pulses, tr, ti, d1, d2, ep, sys4)
                torch.cuda.synchronize()
                err_u, err_f = max_err(U_k, U_p), max_err(F_k, F_p)
                tol_u, tol_f, e64_u, e64_f = SU4_PROD_TOL, SU4_FID_TOL[P], None, None
                if L > 7:
                    args64 = [t.double() for t in (pulses, tr, ti, d1, d2, ep)]
                    e64_u = max_err(U_p, propagate_su4_mc_plain(*args64[:1], *args64[3:], sys4))
                    e64_f = max_err(F_p, mean_fidelity_su4_plain(*args64, sys4))
                    tol_u, tol_f = max(tol_u, 2 * e64_u), max(tol_f, 2 * e64_f)
                if not err_u <= tol_u:
                    raise AssertionError(f"B7 {case}: |U kernel - plain| {err_u:.3e} > {tol_u:.2e}")
                if not err_f <= tol_f:
                    raise AssertionError(f"B6 {case}: |F kernel - plain| {err_f:.3e} > {tol_f:.2e}")
                worst_u, worst_f4 = max(worst_u, err_u), max(worst_f4, err_f)
                vs64 = "" if e64_u is None else (f"; plain vs f64: U {e64_u:.2e}, "
                                                 f"F {e64_f:.2e}")
                print(f"  {case}: B7 err {err_u:.2e} (tol {tol_u:.1e})  B6 err {err_f:.2e} "
                      f"(tol {tol_f:.1e}){vs64}")
    phase("check-su4", t0, f"18 cases; worst B7 {worst_u:.3e}, worst B6 {worst_f4:.3e} "
          f"against plain (tol {SU4_PROD_TOL:.0e} / {SU4_FID_TOL[2]:.0e}, "
          f"{SU4_FID_TOL[4]:.0e} drive2; at L = 100 max of those and 2× the plain f32 "
          f"error against f64)")

    # 5. check-su4-train: B4 and B5 against their plain versions
    t0 = time.perf_counter()
    phase("check-su4-train", t0, check_su4_train(gen, dev))

    # 6. serve — the main path starts here: counters to 0
    mean_fidelity_cuda.launches = 0
    propagate_mc_cuda.launches = 0
    t0 = time.perf_counter()
    gates = named_gate_rotation_vectors(device=dev)
    rng = np.random.default_rng(7)
    axes = rng.standard_normal((3, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rand_rv = np.concatenate([axes, rng.uniform(0.0, 2 * np.pi, (3, 1))], axis=1)
    rv = torch.cat([torch.stack(list(gates.values())),
                    torch.tensor(rand_rv, dtype=torch.float32, device=dev)])
    served = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        t1 = time.perf_counter()
        pipe = load_pipeline("length_100", dtype=dtype)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t1
        pipe(rv)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            pulses = pipe(rv)
        torch.cuda.synchronize()
        t_batch = (time.perf_counter() - t1) / reps
        if tuple(pulses.shape) != (8, 100, 2):
            raise AssertionError(f"{name} pulses shape {tuple(pulses.shape)} != (8, 100, 2)")
        phi, tau = pulses[..., 0], pulses[..., 1]
        if not bool(torch.isfinite(pulses).all()):
            raise AssertionError(f"{name} pulses are not finite")
        if not bool(((phi > -math.pi) & (phi <= math.pi)).all()):
            raise AssertionError(f"{name} phi outside (-pi, pi]")
        if not bool((tau >= 0).all()):
            raise AssertionError(f"{name} tau < 0")
        served[name] = pulses.contiguous()
        print(f"  {name}: load {t_load:.2f} s, {1e3 * t_batch:.2f} ms per batch of 8")
    single, _ = compute_pulses("length_100", 1.0, 0.0, 0.0, math.pi)
    if single.shape != (100, 2) or not np.isfinite(single).all():
        raise AssertionError(f"compute_pulses gave {single.shape}")
    cpu_ref = load_pipeline("length_100", device="cpu", dtype=torch.float32)(rv.cpu())
    serve_err = wrapped_phi_err(served["f32"].cpu(), cpu_ref)
    if not serve_err <= SERVE_TOL:
        raise AssertionError(f"card f32 pulses vs CPU f32: {serve_err:.3e} > {SERVE_TOL}")
    phase("serve", t0, f"length_100 bf16 + f32, 8 targets; card f32 vs CPU f32 "
          f"{serve_err:.2e} (tol {SERVE_TOL:.0e})")

    # 7. score
    t0 = time.perf_counter()
    q_t = rotation_vector_to_quat(rv).contiguous()
    M_score = 1 << 20
    sgen = torch.Generator(device=dev).manual_seed(2026)
    delta = torch.randn((8, M_score), generator=sgen, device=dev)
    eps = 0.05 * torch.randn((8, M_score), generator=sgen, device=dev)
    ef = {name: mean_fidelity_local(p, q_t, delta, eps, backend="pallas")
          for name, p in served.items()}
    torch.cuda.synchronize()
    for name, v in ef.items():
        if not bool(((v > 0) & (v <= 1) & torch.isfinite(v)).all()):
            raise AssertionError(f"{name} E[F] out of (0, 1]: {v.tolist()}")
    xpi = float(ef["f32"][0])
    if not abs(xpi - XPI_PUBLISHED) <= XPI_TOL:
        raise AssertionError(f"f32 X(pi) E[F] {xpi:.5f} not within {XPI_TOL} of "
                             f"{XPI_PUBLISHED}")
    mc_mean, mc_se = mc_fidelity_estimate(served["f32"][0], q_t[0], 1.0, 0.05,
                                          monte_carlo=1 << 18, device=dev)
    if not abs(mc_mean - XPI_PUBLISHED) <= XPI_TOL:
        raise AssertionError(f"mc_fidelity_estimate X(pi) {mc_mean:.5f} not within "
                             f"{XPI_TOL} of {XPI_PUBLISHED}")
    serve_launches = {"B1": mean_fidelity_cuda.launches, "B3": propagate_mc_cuda.launches}
    if min(serve_launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the serving path: "
                             f"{serve_launches}")
    for name in ef:
        print(f"  {name} E[F] (M=2^20): " + " ".join(f"{v:.5f}" for v in ef[name].tolist()))
    phase("score", t0, f"X(pi) E[F] f32 {xpi:.5f}, bf16 {float(ef['bf16'][0]):.5f}, "
          f"published {XPI_PUBLISHED}; mc_fidelity_estimate {mc_mean:.5f} ± "
          f"{mc_se:.5f} (M=2^18); launches {serve_launches}")

    # 8. train — the training path starts here: counters to 0
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        save = Path(tmp) / "run"
        argv = ["--device", "cuda", "--backend", "pallas", "--num_epoch", "2",
                "--train_size", "1024", "--eval_size", "200", "--save_path", str(save)]
        mean_fidelity_cuda.launches = 0
        propagate_mc_cuda.launches = 0
        propagate_mc_vjp_cuda.launches = 0
        history = universal_single_qubit.main(argv)
        torch.cuda.synchronize()
        train_launches = {"B1": mean_fidelity_cuda.launches,
                          "B2": propagate_mc_vjp_cuda.launches,
                          "B3": propagate_mc_cuda.launches}
        t_cli = time.perf_counter() - t0
        if min(train_launches.values()) < 1:
            raise AssertionError(f"a kernel was not launched on the training path: "
                                 f"{train_launches}")
        losses = [x for b in history["bands"] for x in b["train_loss"]]
        fids = [x for b in history["bands"] for x in b["eval_fid"]]
        if len(history["bands"]) != 3 or len(losses) != 6 or len(fids) != 6:
            raise AssertionError(f"expected 3 bands × 2 epochs, got {history}")
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"a training loss is not finite: {losses}")
        if not all(0.0 < x <= 1.0 for x in fids):
            raise AssertionError(f"an eval E[F] is outside (0, 1]: {fids}")
        tags = sorted(p.name for p in save.iterdir() if (p / "params.pt").exists())
        exports = sorted(save.glob("*_pulses.npz"))
        if len(tags) != 3 or len(exports) != 3:
            raise AssertionError(f"band checkpoints {tags}, pulse exports {exports}")
        for path in exports:
            with np.load(path) as z:
                if z["pulses"].shape != (1000, 100, 2) or not np.isfinite(z["pulses"]).all():
                    raise AssertionError(f"{path.name}: {z['pulses'].shape}")
        if not (save / "metrics.csv").exists():
            raise AssertionError("no metrics.csv")
    print(f"  CLI: 3 bands × 2 epochs × 5 steps at batch 200, M = 1000 in {t_cli:.2f} s "
          f"(kernel build cached); train loss " + " ".join(f"{x:.4f}" for x in losses)
          + "; eval E[F] " + " ".join(f"{x:.5f}" for x in fids))

    # one step's gradient through pallas and xla from the same weights and draws
    mp = load_model_params(universal_single_qubit.DEFAULT_CONFIG)
    mp["finetune"] = False
    model = UniversalQOCTransformer(**mp, dtype=torch.float32, device=dev)
    model.init_like_flax(torch.Generator(device=dev).manual_seed(5))
    rv_t, qt_t = build_su2_dataset(torch.Generator().manual_seed(11), 200, random=True,
                                   device=dev)
    trainers = {b: Trainer(model, TrainConfig(backend=b), device=dev)
                for b in ("pallas", "xla")}
    band = CurriculumBand(1.0)
    errors = trainers["pallas"].sample_errors(200, band)
    grads, step_loss = {}, {}
    for b, tr in trainers.items():
        model.zero_grad(set_to_none=True)
        loss, _ = tr.objective(rv_t, qt_t, errors)
        loss.backward()
        grads[b] = torch.cat([p.grad.flatten() for p in model.parameters()])
        step_loss[b] = float(loss.detach())
    gnorm = float(grads["xla"].norm())
    rel = float((grads["pallas"] - grads["xla"]).norm()) / gnorm
    if not rel <= TRAIN_GRAD_TOL:
        raise AssertionError(f"pallas vs xla gradient: {rel:.3e} of the norm > {TRAIN_GRAD_TOL}")
    print(f"  one step, pallas vs xla: loss {step_loss['pallas']:.6f} / "
          f"{step_loss['xla']:.6f}, |g_pallas - g_xla| / |g_xla| {rel:.3e} "
          f"(|g| {gnorm:.4e}, tol {TRAIN_GRAD_TOL:.0e})")

    # ms per train step (fresh draws and dropout, as in the CLI), host clock
    # around synchronized steps
    step_ms = {}
    for b, n in (("pallas", 20), ("xla", 3)):
        tr = trainers[b]
        for _ in range(2):
            tr.train_step(rv_t, qt_t, tr.sample_errors(200, band), dropout=True)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(n):
            tr.train_step(rv_t, qt_t, tr.sample_errors(200, band), dropout=True)
        torch.cuda.synchronize()
        step_ms[b] = 1e3 * (time.perf_counter() - t1) / n
    # where a pallas step's device time goes: kernel time by name from the
    # profiler (annotation ranges such as "Optimizer.step#…" are filed under
    # the device too and left out), over the unprofiled step time above
    tr = trainers["pallas"]
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(5):
            tr.train_step(rv_t, qt_t, tr.sample_errors(200, band), dropout=True)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key]
    dev_ms = sum(e.self_device_time_total for e in events) / 5e3
    ours_ms = sum(e.self_device_time_total for e in events
                  if any(k in e.key for k in ("mean_fid_kernel", "propagate_mc",
                                              "partials_kernel"))) / 5e3
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    print(f"  profile of 5 pallas steps: kernels {dev_ms:.3f} ms per step, "
          f"{100 * dev_ms / step_ms['pallas']:.1f} % of the {step_ms['pallas']:.2f} ms "
          f"step (B1/B2/B3 {ours_ms:.3f} ms); top, us per step: " + "; ".join(
              f"{e.key[:50]} {e.self_device_time_total / 5:.0f}" for e in top))
    phase("train", t0, f"ms per train step at full width, batch 200, M = 1000: pallas "
          f"{step_ms['pallas']:.2f}, xla {step_ms['xla']:.2f}; launches {train_launches}")

    # 9. serve-su4 — the two-qubit serving path starts here: counters to 0
    mean_fidelity_su4_cuda.launches = 0
    propagate_su4_mc_cuda.launches = 0
    t0 = time.perf_counter()
    ckpt, kw4 = two_qubit_model_kwargs("two_qubit_d2_kak")
    gates4 = named_two_qubit_targets()
    U4 = np.stack(list(gates4.values()))                    # (5, 4, 4) complex
    reps = np.stack([z4_representatives(u) for u in U4]).reshape(20, 4, 4)
    packed20 = SU4System.pack_target(reps).to(dev)
    t1 = time.perf_counter()
    model4 = two_qubit_eval.load_two_qubit_model(ckpt, device=dev, **kw4)
    torch.cuda.synchronize()
    t_load4 = time.perf_counter() - t1
    inputs20 = two_qubit_eval.model_inputs(packed20, kw4["kak_tokens"])
    with torch.no_grad():
        raw20 = model4(inputs20)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        for _ in range(5):
            raw20 = model4(inputs20)
        torch.cuda.synchronize()
    t_batch4 = (time.perf_counter() - t1) / 5
    if tuple(raw20.shape) != (20, 100, 4) or not bool(torch.isfinite(raw20).all()):
        raise AssertionError(f"two-qubit pulses {tuple(raw20.shape)}, finite "
                             f"{bool(torch.isfinite(raw20).all())}")
    if not bool(((raw20[..., 0] > -math.pi) & (raw20[..., 0] <= math.pi)).all()):
        raise AssertionError("two-qubit phi1 outside (-pi, pi]")
    if not bool(((raw20[..., 2] >= 0.05 - 1e-6) & (raw20[..., 3] >= 0.1 - 1e-6)).all()):
        raise AssertionError("two-qubit Omega < omega_min or tau < 0.1")
    sys4 = SU4System(drive2=True, backend="pallas")
    t1 = time.perf_counter()
    best4 = two_qubit_eval.best_phase_pulses(ckpt, U4, sys4, device=dev, **kw4).contiguous()
    torch.cuda.synchronize()
    t_best4 = time.perf_counter() - t1
    cpu_raw20 = two_qubit_eval.model_gate_pulses(ckpt, packed20.cpu(), **kw4)
    cpu_best4 = two_qubit_eval.best_phase_pulses(ckpt, U4, sys4, device="cpu", **kw4)
    serve4_err = wrapped_phi_err(raw20.cpu(), cpu_raw20, angles=2)
    best4_err = wrapped_phi_err(best4.cpu(), cpu_best4, angles=2)
    if not serve4_err <= SERVE_TOL:
        raise AssertionError(f"card f32 two-qubit pulses vs CPU f32: {serve4_err:.3e} > "
                             f"{SERVE_TOL}")
    if not best4_err <= SERVE_TOL:
        raise AssertionError(f"best-of-Z4 choice differs between card and CPU: "
                             f"{best4_err:.3e}")
    phase("serve-su4", t0, f"two_qubit_d2_kak f32: load {t_load4:.2f} s, "
          f"{1e3 * t_batch4:.2f} ms per batch of 20 (5 gates × 4 Z4 representatives), "
          f"best_phase_pulses {t_best4:.2f} s (load + KAK tokens + model + B6); card vs "
          f"CPU pulses {serve4_err:.2e}, best choice {best4_err:.2e} (tol {SERVE_TOL:.0e})")

    # 10. score-su4: the named-gate table through B6, then the sweep and the
    # grid of CZ through B7
    t0 = time.perf_counter()
    gates_packed = SU4System.pack_target(U4).to(dev)
    sigmas4 = [0.0, 0.1, 0.2]
    table4 = two_qubit_eval.eval_pulse_tables(best4, gates_packed, sigmas4,
                                              monte_carlo=20_000, epsilon_std=0.05,
                                              system=sys4)
    for i, g in enumerate(gates4):
        ref = JAX_SU4_TABLE[g]
        print(f"  {g}: E[F] " + " ".join(f"{v:.5f}" for v in table4[i]) + "  JAX CPU "
              + " ".join(f"{v:.5f}" for v in ref))
        if not abs(table4[i, 0] - ref[0]) <= SU4_EXACT_TOL:
            raise AssertionError(f"{g} sigma=0: {table4[i, 0]:.5f} vs JAX {ref[0]:.5f}")
        for k in (1, 2):
            if not abs(table4[i, k] - ref[k]) <= SU4_MC_TOL:
                raise AssertionError(f"{g} sigma={sigmas4[k]}: {table4[i, k]:.5f} vs JAX "
                                     f"{ref[k]:.5f} (tol {SU4_MC_TOL})")
    exact_err = float(np.abs(table4[:, 0] - [JAX_SU4_TABLE[g][0] for g in gates4]).max())
    mc_err = float(np.abs(table4[:, 1:] - [JAX_SU4_TABLE[g][1:] for g in gates4]).max())
    # E[F](σ) of CZ: 20 σ × 2000 samples through B7, against the plain version
    cz_pulses = best4[:1].contiguous()
    stds = np.arange(1, 21) * 0.05
    _, sweep_mean, sweep_se = plots_su4.fidelity_by_std_su4(
        best4[0], U4[0], sys4.system, stds=stds, monte_carlo=2000,
        generator=torch.Generator(device=dev).manual_seed(2028), device=dev)
    n1, n2, ne = plots_su4._sweep_draws(torch.Generator(device=dev).manual_seed(2028),
                                        len(stds), 2000, 0.05)
    st = torch.as_tensor(stds, dtype=torch.float32, device=dev)[:, None]
    sweep_d1 = (n1 * st).reshape(1, -1).contiguous()
    sweep_d2 = (n2 * st).reshape(1, -1).contiguous()
    sweep_e = ne.reshape(1, -1).contiguous()
    cz_r, cz_i = plots_su4._as_packed(U4[0], dev)
    Up = propagate_su4_mc_plain(cz_pulses, sweep_d1, sweep_d2, sweep_e, sys4.system)
    sweep_plain = fidelity_su4_ri(Up[0][0], Up[1][0], cz_r, cz_i).reshape(len(stds), -1).mean(1)
    sweep_err = float(np.abs(sweep_mean - sweep_plain.cpu().numpy()).max())
    if not sweep_err <= SU4_SWEEP_TOL:
        raise AssertionError(f"E[F](sigma) sweep, B7 vs plain: {sweep_err:.3e} > {SU4_SWEEP_TOL}")
    if not (0.0 < sweep_mean.min() and sweep_mean.max() <= 1.0
            and sweep_mean[-1] < sweep_mean[0]):
        raise AssertionError(f"E[F](sigma) outside (0, 1] or not lower at sigma 1.0: "
                             f"{sweep_mean}")
    # F(δ₁, δ₂) of CZ on a 61² grid through B7, against the plain version
    dg, grid_F = plots_su4.fidelity_grid_su4(best4[0], U4[0], sys4.system, n_delta=61,
                                             device=dev)
    dgt = torch.as_tensor(dg, device=dev)
    gd1, gd2 = (x.reshape(1, -1).contiguous() for x in torch.meshgrid(dgt, dgt, indexing="ij"))
    grid_plain = {}
    for dt in (torch.float32, torch.float64):
        Ug = propagate_su4_mc_plain(cz_pulses.to(dt), gd1.to(dt), gd2.to(dt),
                                    torch.zeros_like(gd1, dtype=dt), sys4.system)
        grid_plain[dt] = fidelity_su4_ri(Ug[0][0], Ug[1][0], cz_r.to(dt),
                                         cz_i.to(dt)).reshape(61, 61).cpu().numpy()
    grid_tol = max(SU4_PROD_TOL, 2 * float(np.abs(grid_plain[torch.float32]
                                                  - grid_plain[torch.float64]).max()))
    grid_err = float(np.abs(grid_F - grid_plain[torch.float32]).max())
    if not grid_err <= grid_tol:
        raise AssertionError(f"F(delta1, delta2) grid, B7 vs plain: {grid_err:.3e} > {grid_tol:.2e}")
    su4_launches = {"B6": mean_fidelity_su4_cuda.launches, "B7": propagate_su4_mc_cuda.launches}
    if min(su4_launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the two-qubit serving path: "
                             f"{su4_launches}")
    print(f"  CZ E[F](sigma) at sigma 0.05 / 0.5 / 1.0: {sweep_mean[0]:.5f} / "
          f"{sweep_mean[9]:.5f} / {sweep_mean[19]:.5f} (SE {sweep_se[19]:.5f}); grid F at "
          f"the centre {grid_F[30, 30]:.5f}, corner {grid_F[0, 0]:.5f}")
    phase("score-su4", t0, f"sigma=0 within {exact_err:.2e} of the JAX CPU table (tol "
          f"{SU4_EXACT_TOL:.0e}), sigma 0.1/0.2 within {mc_err:.2e} (tol {SU4_MC_TOL}); "
          f"sweep B7 vs plain {sweep_err:.2e} (tol {SU4_SWEEP_TOL:.0e}), grid {grid_err:.2e} "
          f"(tol {grid_tol:.1e}); launches {su4_launches}")

    # 11. train-su4 — the two-qubit training path: counters to 0 inside
    t0 = time.perf_counter()
    tq = train_su4(ckpt, kw4, dev)
    phase("train-su4", t0, f"ms per train step at full width, batch {TRAIN4_BATCH}, M = "
          f"{TRAIN4_MC}, L = 100: pallas {tq['step_ms']['pallas']:.2f}, xla "
          f"{tq['step_ms']['xla']:.2f}; pallas vs xla gradient {tq['rel']:.3e} of the norm "
          f"(against f64: pallas {tq['e32']['pallas']:.3e}, xla {tq['e32']['xla']:.3e}); "
          f"eval E[F] {tq['fids'][-1]:.5f}; launches {tq['launches']}")

    # 12. time each kernel at each path's shape: one row per (kernel, path),
    # its launches those of that path's run
    t0 = time.perf_counter()
    csrc = "universal_quantum_optimal_control_tpu_torch/ops/csrc/"
    names = {"B1": ("mean_fidelity_cuda (B1)", "ops/propagate_pallas.py:252", "propagate_su2.cu"),
             "B2": ("propagate_mc_vjp_cuda (B2)", "ops/propagate_pallas_bwd.py:74",
                    "propagate_su2.cu"),
             "B3": ("propagate_mc_cuda (B3)", "ops/propagate_pallas.py:240", "propagate_su2.cu"),
             "B6": ("mean_fidelity_su4_cuda (B6)", "ops/propagate_su4_pallas.py:226",
                    "propagate_su4.cu"),
             "B7": ("propagate_su4_mc_cuda (B7)", "ops/propagate_su4_pallas.py:215",
                    "propagate_su4.cu"),
             "B4": ("mean_fidelity_su4_with_product_cuda (B4)",
                    "ops/propagate_su4_pallas.py:256", "propagate_su4.cu"),
             "B5": ("su4_objective_vjp_from_product_cuda (B5)",
                    "ops/propagate_su4_pallas_bwd.py:364", "propagate_su4_bwd.cu")}
    # each kernel's entry function at pulse width P, as ptxas names it
    entry = {"B1": "mean_fid_kernelILi{}E", "B2": "propagate_mc_vjp_kernelILi{}E",
             "B3": "propagate_mc_kernelILi{}E", "B4": "mean_fid_su4_kernelILi{}ELb1E",
             "B5": "su4_vjp_kernelILi{}E", "B6": "mean_fid_su4_kernelILi{}ELb0E",
             "B7": "propagate_su4_kernelILi{}E"}
    launches = {"serve": serve_launches, "train": train_launches, "serve-su4": su4_launches,
                "train-su4": tq["launches"]}

    def row(kid, path, shape, err, ms, plain_ms, bound_):
        name, where, src = names[kid]
        return {"name": name, "route": "cuda", "source": csrc + src,
                "replaces": f"universal_quantum_optimal_control_tpu/{where}",
                "launches": launches[path][kid], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_[0], "bound_by": bound_[1],
                "library_ms": None, "path": path,
                "shape": "B={} L={} P={} M={}".format(*shape),
                "ptxas": ptxas_of(ptx, entry[kid].format(shape[2]))}

    def fid_row(path, p_, qt_, d_, e_, iters):
        B_, L_, P_ = p_.shape
        M_ = d_.shape[1]
        err = float((mean_fidelity_cuda(p_, qt_, d_, e_)
                     - mean_fidelity_plain(p_, qt_, d_, e_)).abs().max())
        if not err <= FID_TOL:
            raise AssertionError(f"B1 at the {path} shape: {err:.3e} > {FID_TOL}")
        return row("B1", path, (B_, L_, P_, M_), err,
                   time_ms(lambda: mean_fidelity_cuda(p_, qt_, d_, e_), iters),
                   time_ms(lambda: mean_fidelity_plain(p_, qt_, d_, e_), 3),
                   bound(B_, L_, P_, M_, 4 * B_, fidelity=True))

    def prop_row(path, p_, d_, e_, iters):
        B_, L_, P_ = p_.shape
        M_ = d_.shape[1]
        err = float((propagate_mc_cuda(p_, d_, e_) - propagate_mc_plain(p_, d_, e_)).abs().max())
        if not err <= quat_tol(L_):
            raise AssertionError(f"B3 at the {path} shape: {err:.3e} > {quat_tol(L_)}")
        return row("B3", path, (B_, L_, P_, M_), err,
                   time_ms(lambda: propagate_mc_cuda(p_, d_, e_), iters),
                   time_ms(lambda: propagate_mc_plain(p_, d_, e_), 3),
                   bound(B_, L_, P_, M_, 16 * B_ * M_, fidelity=False))

    pulses = served["f32"]
    pt = trainers["pallas"].predict(rv_t).contiguous()
    dt_, et_ = errors
    Bt, Lt, Pt = pt.shape
    Mt = dt_.shape[1]
    # B1, serving and training; at the training shape also forward + backward
    b1_train = fid_row("train", pt, qt_t, dt_, et_, 50)
    leaf = pt.clone().requires_grad_(True)

    def fwd_bwd(fn):
        return lambda: fn(leaf, qt_t, dt_, et_).mean().backward()

    b1_train["fwd_bwd_ms"] = time_ms(fwd_bwd(mean_fidelity_cuda), 20)
    b1_train["fwd_bwd_plain_ms"] = time_ms(fwd_bwd(mean_fidelity_plain), 3)
    # B2 at the training shape
    g_t = torch.randn((Bt, Mt, 4), generator=gen, device=dev)
    _, got, want = check_vjp("at the training shape", pt, dt_, et_, g_t)
    b2_train = row("B2", "train", (Bt, Lt, Pt, Mt),
                   max(float((a - b).abs().max()) for a, b in zip(got, want)),
                   time_ms(lambda: propagate_mc_vjp_cuda(pt, dt_, et_, g_t), 50),
                   time_ms(lambda: propagate_mc_vjp_plain(pt, dt_, et_, g_t), 3),
                   vjp_bound(Bt, Lt, Pt, Mt))
    p1 = pulses[:1].contiguous()
    d1, e1 = delta[:1, :1 << 18].contiguous(), eps[:1, :1 << 18].contiguous()
    # B6 at the named-gate table's shape (5 gates, σ_δ = 0.2 draws) and B7 at
    # the sweep's, each against its plain version (L = 100 tolerance rule)
    n4 = sys4.sample_errors(torch.Generator(device=dev).manual_seed(7), (5, 20_000), 1.0, 1.0)
    b6_in = (best4, gates_packed[:, 0].contiguous(), gates_packed[:, 1].contiguous(),
             n4[0] * 0.2, n4[1] * 0.2, n4[2] * 0.05)
    b7_in = (cz_pulses, sweep_d1, sweep_d2, sweep_e)
    b6_k, b6_p = mean_fidelity_su4_cuda(*b6_in, sys4.system), mean_fidelity_su4_plain(*b6_in, sys4.system)
    b7_k, b7_p = propagate_su4_mc_cuda(*b7_in, sys4.system), propagate_su4_mc_plain(*b7_in, sys4.system)
    b6_err, b7_err = max_err(b6_k, b6_p), max_err(b7_k, b7_p)
    b6_tol = max(SU4_FID_TOL[4], 2 * max_err(b6_p, mean_fidelity_su4_plain(
        *(t.double() for t in b6_in), sys4.system)))
    b7_tol = max(SU4_PROD_TOL, 2 * max_err(b7_p, propagate_su4_mc_plain(
        *(t.double() for t in b7_in), sys4.system)))
    if not (b6_err <= b6_tol and b7_err <= b7_tol):
        raise AssertionError(f"at the two-qubit serving shapes: B6 {b6_err:.3e} (tol "
                             f"{b6_tol:.2e}), B7 {b7_err:.3e} (tol {b7_tol:.2e})")
    b6_row = row("B6", "serve-su4", (5, 100, 4, 20_000), b6_err,
                 time_ms(lambda: mean_fidelity_su4_cuda(*b6_in, sys4.system), 20),
                 time_ms(lambda: mean_fidelity_su4_plain(*b6_in, sys4.system), 3),
                 su4_bound(5, 100, 4, 20_000, fidelity=True))
    b7_row = row("B7", "serve-su4", (1, 100, 4, sweep_d1.shape[1]), b7_err,
                 time_ms(lambda: propagate_su4_mc_cuda(*b7_in, sys4.system), 20),
                 time_ms(lambda: propagate_su4_mc_plain(*b7_in, sys4.system), 3),
                 su4_bound(1, 100, 4, sweep_d1.shape[1], fidelity=False))
    # B4, B5 and B6 at the two-qubit training shape (the restored model's
    # pulses on the step's targets and σ_δ = 0.2 draws), each against its
    # plain version (L = 100 tolerance rule)
    sysd = sys4.system
    tr4, ti4 = tq["targets"][:, 0].contiguous(), tq["targets"][:, 1].contiguous()
    in4 = (tq["pulses"], tr4, ti4, *tq["errors"])
    in64 = tuple(t.double() for t in in4)
    B4_, L4, P4 = tq["pulses"].shape
    M4 = tq["errors"][0].shape[1]
    shape4 = (B4_, L4, P4, M4)
    gbar4 = torch.full((B4_,), 1.0 / B4_, device=dev)
    F_k, prod_k = mean_fidelity_su4_with_product_cuda(*in4, sysd)
    F_p, prod_p = mean_fidelity_su4_with_product_plain(*in4, sysd)
    F64, prod64 = mean_fidelity_su4_with_product_plain(*in64, sysd)
    b4_errs = (max_err(F_k, F_p), max_err(prod_k, prod_p))
    b4_tols = (max(SU4_FID_TOL[4], 2 * max_err(F_p, F64)),
               max(SU4_PROD_TOL, 2 * max_err(prod_p, prod64)))
    if not all(e <= t for e, t in zip(b4_errs, b4_tols)):
        raise AssertionError(f"B4 at the two-qubit training shape: F, product errors {b4_errs} "
                             f"beyond {b4_tols}")
    g_k = su4_objective_vjp_from_product_cuda(*in4, gbar4, prod_k, sysd)
    g_p = su4_objective_vjp_from_product_plain(*in4, gbar4, prod_p, sysd)
    g64 = su4_objective_vjp_from_product_plain(*in64, gbar4.double(), None, sysd)
    e5 = grads_close("B5 at the two-qubit training shape", ("pulses", "delta1", "delta2", "eps"),
                     (1e-5,) * 4, g_k, g_p, g64)
    b6_train_err = max_err(mean_fidelity_su4_cuda(*in4, sysd), F_p)
    if not b6_train_err <= b4_tols[0]:
        raise AssertionError(f"B6 at the two-qubit training shape: {b6_train_err:.3e} > "
                             f"{b4_tols[0]:.2e}")
    b4_row = row("B4", "train-su4", shape4, max(b4_errs),
                 time_ms(lambda: mean_fidelity_su4_with_product_cuda(*in4, sysd), 20),
                 time_ms(lambda: mean_fidelity_su4_with_product_plain(*in4, sysd), 2),
                 su4_bound(*shape4, fidelity=True, product=True))
    b5_row = row("B5", "train-su4", shape4, e5[0],
                 time_ms(lambda: su4_objective_vjp_from_product_cuda(*in4, gbar4, prod_k, sysd), 20),
                 time_ms(lambda: su4_objective_vjp_from_product_plain(*in4, gbar4, prod_p, sysd),
                         2),
                 su4_vjp_bound(*shape4))
    b6_train = row("B6", "train-su4", shape4, b6_train_err,
                   time_ms(lambda: mean_fidelity_su4_cuda(*in4, sysd), 20),
                   time_ms(lambda: mean_fidelity_su4_plain(*in4, sysd), 2),
                   su4_bound(*shape4, fidelity=True))
    leaf4 = tq["pulses"].clone().requires_grad_(True)

    def fwd_bwd4(fn):
        return lambda: torch.autograd.grad(fn(leaf4, *in4[1:], sysd), leaf4, gbar4)

    b4_row["fwd_bwd_ms"] = time_ms(fwd_bwd4(mean_fidelity_su4_cuda), 20)
    b4_row["fwd_bwd_plain_ms"] = time_ms(fwd_bwd4(mean_fidelity_su4_plain), 2)
    kernels = [fid_row("serve", pulses, q_t, delta, eps, 20), b1_train, b2_train,
               prop_row("serve", p1, d1, e1, 20), prop_row("train", pt, dt_, et_, 50),
               b6_row, b7_row, b4_row, b5_row, b6_train]
    for k in kernels:
        print(f"  {k['name']} [{k['path']}] {k['shape']}: {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
              f"err {k['max_abs_err']:.2e}, launches {k['launches']}, ptxas {k['ptxas']}")
    print(f"  B1 [train] forward + backward {b1_train['fwd_bwd_ms']:.4f} ms, plain "
          f"{b1_train['fwd_bwd_plain_ms']:.3f} ms")
    print(f"  B4 + B5 [train-su4] forward + backward through mean_fidelity_su4_cuda "
          f"{b4_row['fwd_bwd_ms']:.4f} ms, plain {b4_row['fwd_bwd_plain_ms']:.3f} ms; B5 vs "
          f"f64: kernel {e5[1]:.2e}, plain {e5[2]:.2e}")
    phase("time", t0, "CUDA events, after a warm-up")

    print(f"total {time.perf_counter() - t_total:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
