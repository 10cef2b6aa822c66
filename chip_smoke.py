#!/usr/bin/env python3
r"""Smoke run of the PyTorch port on one CUDA card: build, check, serve, score.

    python3 chip_smoke.py

Six phases, each printing its own line with its seconds:

1. device: the card, torch and CUDA versions, ``nvidia-smi`` name and power limit;
2. build: the one ``nvcc`` call that compiles ``ops/csrc/propagate_su2.cu``;
3. check: kernels B1 (mean fidelity) and B3 (per-sample product) against
   their plain PyTorch versions on the card, P ∈ {2, 3, 4}, L ∈ {1, 7, 100},
   M ∈ {1000, 2¹⁶};
4. serve: the ``length_100`` flagship (d512 × 8 layers, 16 heads, L = 100,
   P = 2) from its shipped ``.npz``, in bf16 (as the JAX demo serves) and
   f32, for the 5 named gates plus 3 random targets;
5. score: E[F] of those pulse tables through B1 at σ_δ = 1.0, ε_std = 0.05,
   M = 2²⁰ per target, and ``mc_fidelity_estimate`` through B3 on X(π),
   held against the flagship's published X(π) E[F] of 0.9502;
6. time: each kernel at the serving shape with CUDA events, beside its
   plain version and its bound.

Phases 4 and 5 are the serving path; the kernels' launch counters are set
to 0 just before it and read just after, and every kernel must have been
launched there.  Any failure raises and the run exits nonzero.  The line
before the last is the card's ``nvidia-smi`` name and power limit; the last
line is ``{"ok": true, "device": {...}}``.  Exits nonzero without a result
where CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

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

FID_TOL = 1e-5  # as tests/test_pallas_kernel.py holds the JAX kernels
XPI_PUBLISHED = 0.9502  # README.md per-gate table, flagship X(π) at σ_δ = 1.0
XPI_TOL = 0.005
SERVE_TOL = 1e-3  # card f32 vs CPU f32 pulses (φ modulo 2π)


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


def bound(B, L, P, M, out_bytes, fidelity):
    ops = B * M * (L * FLOPS_PER_SEGMENT[P]
                   + (FLOPS_PER_SAMPLE_FIDELITY if fidelity else 0))
    in_bytes = 4 * (B * L * P + 2 * B * M + (4 * B if fidelity else 0))
    t_ops = ops / PEAK_F32_FLOPS
    t_bytes = (in_bytes + out_bytes) / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def wrapped_phi_err(a: torch.Tensor, b: torch.Tensor) -> float:
    d = torch.remainder(a[..., 0] - b[..., 0] + math.pi, 2 * math.pi) - math.pi
    return max(float(d.abs().max()), float((a[..., 1:] - b[..., 1:]).abs().max()))


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
        mean_fidelity_cuda, mean_fidelity_plain, propagate_mc_cuda, propagate_mc_plain)
    from universal_quantum_optimal_control_tpu_torch.parallel import mean_fidelity_local

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
    built = _build.build_library()
    _build.load_library()
    for line in built["log"].splitlines():
        if "registers" in line or "Compiling entry" in line:
            print("  " + line.strip())
    phase("build", t0, f"nvcc {'cached' if built['cached'] else 'built'} "
          f"{built['path']} in {built['seconds']:.2f} s")

    # 3. kernels against their plain versions
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(1234)
    worst_f, worst_q = 0.0, 0.0
    for P in (2, 3, 4):
        for L in (1, 7, 100):
            for M in (1000, 1 << 16):
                pulses, q_t, delta, eps = random_inputs(gen, 3, L, P, M, dev)
                f_k = mean_fidelity_cuda(pulses, q_t, delta, eps)
                f_p = mean_fidelity_plain(pulses, q_t, delta, eps)
                q_k = propagate_mc_cuda(pulses, delta, eps)
                q_p = propagate_mc_plain(pulses, delta, eps)
                torch.cuda.synchronize()
                err_f = float((f_k - f_p).abs().max())
                err_q = float((q_k - q_p).abs().max())
                err_n = float((q_k.norm(dim=-1) - 1.0).abs().max())
                same_sign = bool(((q_k * q_p).sum(-1) > 0).all())
                case = f"P={P} L={L} M={M}"
                if not err_f <= FID_TOL:
                    raise AssertionError(f"B1 {case}: |F kernel - plain| {err_f:.3e} > {FID_TOL}")
                if not (err_q <= quat_tol(L) and err_n <= quat_tol(L)):
                    raise AssertionError(
                        f"B3 {case}: |q kernel - plain| {err_q:.3e}, | |q| - 1 | "
                        f"{err_n:.3e}, tolerance {quat_tol(L):.0e}")
                if not same_sign:
                    raise AssertionError(f"B3 {case}: quaternion sign differs from plain")
                worst_f, worst_q = max(worst_f, err_f), max(worst_q, err_q)
                print(f"  {case}: B1 err {err_f:.2e}  B3 err {err_q:.2e} "
                      f"norm err {err_n:.2e}")
    phase("check", t0, f"18 cases; worst B1 {worst_f:.3e} (tol {FID_TOL:.0e}), "
          f"worst B3 {worst_q:.3e} (tol max(1e-5, 1e-6 L))")

    # 4. serve — the main path starts here: counters to 0
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

    # 5. score
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
    launches = {"B1": mean_fidelity_cuda.launches, "B3": propagate_mc_cuda.launches}
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the serving path: {launches}")
    for name in ef:
        print(f"  {name} E[F] (M=2^20): " + " ".join(f"{v:.5f}" for v in ef[name].tolist()))
    phase("score", t0, f"X(pi) E[F] f32 {xpi:.5f}, bf16 {float(ef['bf16'][0]):.5f}, "
          f"published {XPI_PUBLISHED}; mc_fidelity_estimate {mc_mean:.5f} ± "
          f"{mc_se:.5f} (M=2^18); launches {launches}")

    # 6. time each kernel at its serving shape
    t0 = time.perf_counter()
    kernels = []
    pulses = served["f32"]
    B, L, P = pulses.shape
    f_k = mean_fidelity_cuda(pulses, q_t, delta, eps)
    f_p = mean_fidelity_plain(pulses, q_t, delta, eps)
    ms = time_ms(lambda: mean_fidelity_cuda(pulses, q_t, delta, eps), 20)
    plain_ms = time_ms(lambda: mean_fidelity_plain(pulses, q_t, delta, eps), 3)
    bound_ms, bound_by = bound(B, L, P, M_score, 4 * B, fidelity=True)
    kernels.append({
        "name": "mean_fidelity_cuda (B1)", "route": "cuda",
        "source": "universal_quantum_optimal_control_tpu_torch/ops/csrc/propagate_su2.cu",
        "replaces": "universal_quantum_optimal_control_tpu/ops/propagate_pallas.py:252",
        "launches": launches["B1"], "max_abs_err": float((f_k - f_p).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": f"B={B} L={L} P={P} M={M_score}"})
    p1, d1, e1 = pulses[:1].contiguous(), delta[:1, :1 << 18].contiguous(), eps[:1, :1 << 18].contiguous()
    q_k = propagate_mc_cuda(p1, d1, e1)
    q_p = propagate_mc_plain(p1, d1, e1)
    ms = time_ms(lambda: propagate_mc_cuda(p1, d1, e1), 20)
    plain_ms = time_ms(lambda: propagate_mc_plain(p1, d1, e1), 3)
    bound_ms, bound_by = bound(1, L, P, 1 << 18, 16 << 18, fidelity=False)
    kernels.append({
        "name": "propagate_mc_cuda (B3)", "route": "cuda",
        "source": "universal_quantum_optimal_control_tpu_torch/ops/csrc/propagate_su2.cu",
        "replaces": "universal_quantum_optimal_control_tpu/ops/propagate_pallas.py:240",
        "launches": launches["B3"], "max_abs_err": float((q_k - q_p).abs().max()),
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": None, "shape": f"B=1 L={L} P={P} M={1 << 18}"})
    if not kernels[0]["max_abs_err"] <= FID_TOL:
        raise AssertionError(f"B1 at the serving shape: {kernels[0]['max_abs_err']:.3e} > {FID_TOL}")
    if not kernels[1]["max_abs_err"] <= quat_tol(L):
        raise AssertionError(f"B3 at the serving shape: {kernels[1]['max_abs_err']:.3e} > {quat_tol(L)}")
    for k in kernels:
        print(f"  {k['name']} {k['shape']}: {k['ms']:.4f} ms, plain {k['plain_ms']:.3f} ms, "
              f"bound {k['bound_ms']:.4f} ms ({k['bound_by']}), err {k['max_abs_err']:.2e}")
    phase("time", t0, "CUDA events, after a warm-up")

    print(f"total {time.perf_counter() - t_total:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
