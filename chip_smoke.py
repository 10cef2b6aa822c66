#!/usr/bin/env python3
r"""Smoke run of the PyTorch port on one CUDA card: build, check, serve,
score, train, time.

    python3 chip_smoke.py

Seven phases, each printing its own line with its seconds:

1. device: the card, torch and CUDA versions, ``nvidia-smi`` name and power limit;
2. build: the one ``nvcc`` call that compiles ``ops/csrc/propagate_su2.cu``;
3. check: kernels B1 (mean fidelity), B3 (per-sample product) and B2 (the
   VJP of B3) against their plain PyTorch versions on the card, P ∈ {2, 3,
   4}, L ∈ {1, 7, 100}, M ∈ {1000, 2¹⁶}, plus B2 at L = 400, P = 4; and the
   full gradient of B1 (its backward runs B3 and B2) against autograd
   through its plain version;
4. serve: the ``length_100`` flagship (d512 × 8 layers, 16 heads, L = 100,
   P = 2) from its shipped ``.npz``, in bf16 (as the JAX demo serves) and
   f32, for the 5 named gates plus 3 random targets;
5. score: E[F] of those pulse tables through B1 at σ_δ = 1.0, ε_std = 0.05,
   M = 2²⁰ per target, and ``mc_fidelity_estimate`` through B3 on X(π),
   held against the flagship's published X(π) E[F] of 0.9502;
6. train: the training CLI (``workloads/universal_single_qubit.py``) at the
   flagship's full width with ``--backend pallas``, batch 200, M = 1000,
   two epochs of 5 steps in each of the three curriculum bands; then one
   step's gradient through ``pallas`` against ``xla`` from the same
   weights and draws, and ms per train step;
7. time: each kernel at the shape of each path that runs it (B1 and B3
   serving and training, B2 training) with CUDA events, beside its plain
   version and its bound; one row of the ``kernels`` line per kernel and
   path, with that path's launches.

Phases 4–5 are the serving path and phase 6's CLI run the training path;
the kernels' launch counters are set to 0 just before each and read just
after, and every kernel of the path must have been launched there.  Any
failure raises and the run exits nonzero.  The line before the last is the
card's ``nvidia-smi`` name and power limit; the last line is
``{"ok": true, "device": {...}}``.  Exits nonzero without a result where
CUDA is unavailable.
"""

from __future__ import annotations

import json
import math
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
        mean_fidelity_cuda, mean_fidelity_plain, propagate_mc_cuda, propagate_mc_plain,
        propagate_mc_vjp_cuda, propagate_mc_vjp_plain)
    from universal_quantum_optimal_control_tpu_torch.parallel import mean_fidelity_local
    from universal_quantum_optimal_control_tpu_torch.models import UniversalQOCTransformer
    from universal_quantum_optimal_control_tpu_torch.data import build_su2_dataset
    from universal_quantum_optimal_control_tpu_torch.training import (CurriculumBand,
                                                                      TrainConfig, Trainer)
    from universal_quantum_optimal_control_tpu_torch.utils import load_model_params
    from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit

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
    serve_launches = {"B1": mean_fidelity_cuda.launches, "B3": propagate_mc_cuda.launches}
    if min(serve_launches.values()) < 1:
        raise AssertionError(f"a kernel was not launched on the serving path: "
                             f"{serve_launches}")
    for name in ef:
        print(f"  {name} E[F] (M=2^20): " + " ".join(f"{v:.5f}" for v in ef[name].tolist()))
    phase("score", t0, f"X(pi) E[F] f32 {xpi:.5f}, bf16 {float(ef['bf16'][0]):.5f}, "
          f"published {XPI_PUBLISHED}; mc_fidelity_estimate {mc_mean:.5f} ± "
          f"{mc_se:.5f} (M=2^18); launches {serve_launches}")

    # 6. train — the training path starts here: counters to 0
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

    # 7. time each kernel at each path's shape: one row per (kernel, path),
    # its launches those of that path's run
    t0 = time.perf_counter()
    src = "universal_quantum_optimal_control_tpu_torch/ops/csrc/propagate_su2.cu"
    names = {"B1": ("mean_fidelity_cuda (B1)", "ops/propagate_pallas.py:252"),
             "B2": ("propagate_mc_vjp_cuda (B2)", "ops/propagate_pallas_bwd.py:74"),
             "B3": ("propagate_mc_cuda (B3)", "ops/propagate_pallas.py:240")}
    launches = {"serve": serve_launches, "train": train_launches}

    def row(kid, path, shape, err, ms, plain_ms, bound_):
        name, where = names[kid]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": f"universal_quantum_optimal_control_tpu/{where}",
                "launches": launches[path][kid], "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound_[0], "bound_by": bound_[1],
                "library_ms": None, "path": path,
                "shape": "B={} L={} P={} M={}".format(*shape)}

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
    kernels = [fid_row("serve", pulses, q_t, delta, eps, 20), b1_train, b2_train,
               prop_row("serve", p1, d1, e1, 20), prop_row("train", pt, dt_, et_, 50)]
    for k in kernels:
        print(f"  {k['name']} [{k['path']}] {k['shape']}: {k['ms']:.4f} ms, plain "
              f"{k['plain_ms']:.3f} ms, bound {k['bound_ms']:.4f} ms ({k['bound_by']}), "
              f"err {k['max_abs_err']:.2e}, launches {k['launches']}")
    print(f"  B1 [train] forward + backward {b1_train['fwd_bwd_ms']:.4f} ms, plain "
          f"{b1_train['fwd_bwd_plain_ms']:.3f} ms")
    phase("time", t0, "CUDA events, after a warm-up")

    print(f"total {time.perf_counter() - t_total:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
