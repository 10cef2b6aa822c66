r"""Products-half / KAK-half eval split for a two-qubit checkpoint — CLI
(port of ``analysis/two_qubit_split_eval.py``, the numeric half).

The two-qubit trainer reports one blended ``eval_fid`` over its held-out
mixed target set.  This recomputes that set (the port's
``workloads/two_qubit.py`` eval set: ``build_targets`` on the eval seed
derived from ``--seed``, mixed, phase-augmented; first half products,
second half KAK) and reports the two halves apart, the duration
distribution T = Σ τ, and optionally a per-target CSV, a dump of the KAK
targets at chosen fidelity percentiles (the ``u_target`` ``.npz`` that
``workloads/two_qubit_grape.py --target_npz`` takes) and a per-channel loss
decomposition of the worst decile (:mod:`.dephasing_bound`).

The E[F] calls go through ``SU4System(backend="pallas")`` (kernel B6) by
default.  Each chunk of targets takes the same draws, from a generator
seeded with ``eval_seed``, as the JAX module reuses one key per chunk; the
numbers differ from the JAX package's, whose targets and draws come from
its threefry keys.

Usage::

    python -m universal_quantum_optimal_control_tpu_torch.analysis.two_qubit_split_eval \
        CHECKPOINT --sigma 0.2 [--monte_carlo 2048] [--eval_size 512]
"""

from __future__ import annotations

import argparse
import os
from typing import Optional

import numpy as np
import torch

from ..training.systems import SU4System
from ..utils import resolve_device
from ..workloads.two_qubit import build_targets
from ..workloads.two_qubit_eval import model_gate_pulses

__all__ = ["main", "split_eval"]


def split_eval(checkpoint: str, *, sigma: float, monte_carlo: int = 2048,
               eval_size: int = 512, seed: int = 0, epsilon_std: float = 0.05,
               chunk: int = 64, eval_seed: int = 42, system: Optional[SU4System] = None,
               targets: Optional[torch.Tensor] = None, device=None, **model_kw) -> dict:
    """Mean E[F] over the trainer's held-out eval set, split by half.

    ``targets`` (packed ``(N, 2, 4, 4)``, first half products, second half
    KAK) replaces the trainer's set where given.  ``model_kw`` forwards to
    :func:`..workloads.two_qubit_eval.model_gate_pulses`.  Returns
    ``{"products", "kak", "blended", "per_target", "targets", "pulses"}``.
    """
    dev = resolve_device(device)
    system = system or SU4System(drive2=model_kw.get("drive2", False), backend="pallas")
    if targets is None:  # the training CLI's eval seed for --seed
        eval_t_seed = int(np.random.SeedSequence(seed).generate_state(2)[1])
        targets = build_targets(eval_t_seed, eval_size, system.system, mode="mixed",
                                phase_augment=True)
    eval_t = targets.to(dev)
    n = eval_t.shape[0]
    all_pulses = model_gate_pulses(checkpoint, eval_t, **model_kw).contiguous()
    chunks = []
    for i in range(0, n, chunk):  # chunk the MC propagation only
        p, ts = all_pulses[i:i + chunk], eval_t[i:i + chunk]
        gen = torch.Generator(device=dev).manual_seed(eval_seed)
        d1, d2, ep = (torch.randn((p.shape[0], monte_carlo), generator=gen, device=dev) * s
                      for s in (sigma, sigma, epsilon_std))
        with torch.no_grad():
            chunks.append(system.local_mean_fidelity(p, ts, (d1, d2, ep)).cpu().numpy())
    F = np.concatenate(chunks)
    half = n // 2
    return {"products": float(F[:half].mean()), "kak": float(F[half:].mean()),
            "blended": float(F.mean()), "per_target": F,
            "targets": eval_t.cpu().numpy(), "pulses": all_pulses.cpu().numpy()}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint", help=".npz two-qubit model artifact")
    p.add_argument("--sigma", type=float, default=0.0)
    p.add_argument("--monte_carlo", type=int, default=2048)
    p.add_argument("--eval_size", type=int, default=512)
    p.add_argument("--seed", type=int, default=0,
                   help="trainer seed whose eval split to reproduce")
    p.add_argument("--epsilon_std", type=float, default=0.05)
    p.add_argument("--max_pulses", type=int, default=100,
                   help="checkpoint pulse-sequence length (the shipped flagship is L=100)")
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--n_heads", type=int, default=16)
    p.add_argument("--drive2", action="store_true")
    p.add_argument("--kak_features", action="store_true")
    p.add_argument("--kak_tokens", action="store_true")
    p.add_argument("--omega_min", type=float, default=0.0)
    p.add_argument("--per_target_csv", default=None,
                   help="write index,class,fid per eval target")
    p.add_argument("--dump_kak_percentiles", default=None,
                   help="comma list of percentiles of the KAK-half fidelity "
                        "distribution (e.g. '10,50,90'); the target nearest each "
                        "is dumped as <dump_dir>/kak_p<P>_i<IDX>.npz with a (4,4) "
                        "'u_target'")
    p.add_argument("--dump_dir", default="runs/kak_targets")
    p.add_argument("--channels_worst_decile", action="store_true",
                   help="per-channel (δ₁/δ₂/ε) loss decomposition of the "
                        "worst-decile KAK-half targets at --sigma")
    p.add_argument("--channels_mc", type=int, default=20_000)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back by itself")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns :func:`split_eval`'s dict."""
    from .dephasing_bound import measure_channels

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    system = SU4System(drive2=args.drive2, backend="pallas")
    out = split_eval(
        args.checkpoint, sigma=args.sigma, monte_carlo=args.monte_carlo,
        eval_size=args.eval_size, seed=args.seed, epsilon_std=args.epsilon_std,
        system=system, device=dev, max_pulses=args.max_pulses, d_model=args.d_model,
        n_layers=args.n_layers, n_heads=args.n_heads, drive2=args.drive2,
        kak_features=args.kak_features, kak_tokens=args.kak_tokens,
        omega_min=args.omega_min)
    print(f"sigma={args.sigma} M={args.monte_carlo} "
          f"products_half={out['products']:.4f} kak_half={out['kak']:.4f} "
          f"blended={out['blended']:.4f}")

    # the duration the model uses, and whether the τ box binds
    tau = out["pulses"][..., -1]
    T = tau.sum(axis=-1)
    sat = float((tau > 0.5 - 0.005).mean())
    print(f"duration T=sum(tau): mean={T.mean():.1f} p10={np.percentile(T, 10):.1f} "
          f"p50={np.percentile(T, 50):.1f} p90={np.percentile(T, 90):.1f} "
          f"max={T.max():.1f} tau_at_box_top={sat:.1%}")

    half = len(out["per_target"]) // 2
    if args.per_target_csv:
        if os.path.dirname(args.per_target_csv):
            os.makedirs(os.path.dirname(args.per_target_csv), exist_ok=True)
        with open(args.per_target_csv, "w") as f:
            f.write("index,class,fid\n")
            for i, v in enumerate(out["per_target"]):
                f.write(f"{i},{'products' if i < half else 'kak'},{v:.6f}\n")
        print(f"per-target CSV -> {args.per_target_csv}")
    kak_f = out["per_target"][half:]
    order = np.argsort(kak_f)
    if args.dump_kak_percentiles:
        os.makedirs(args.dump_dir, exist_ok=True)
        for ptxt in args.dump_kak_percentiles.split(","):
            j = order[min(len(order) - 1, int(round(float(ptxt) / 100 * (len(order) - 1))))]
            idx = half + int(j)
            path = os.path.join(args.dump_dir, f"kak_p{ptxt}_i{idx}.npz")
            # targets are packed (re, im); two_qubit_grape takes complex
            u_c = out["targets"][idx, 0] + 1j * out["targets"][idx, 1]
            np.savez(path, u_target=u_c, model_fid=out["per_target"][idx], sigma=args.sigma)
            print(f"p{ptxt}: eval index {idx} model_fid={out['per_target'][idx]:.4f} -> {path}")

    if args.channels_worst_decile:
        n10 = max(len(order) // 10, 1)
        groups = {"products half": np.arange(half), "KAK better 90%": half + order[n10:],
                  "KAK worst decile": half + order[:n10]}
        print(f"\nper-channel decomposition at sigma={args.sigma} "
              f"(M={args.channels_mc}, eps_std={args.epsilon_std}):")
        print("| subset | exact (no disorder) | E[F] δ₁ only | δ₂ only "
              "| ε only | full | f₁·f₂·f_ε |")
        print("|---|---:|---:|---:|---:|---:|---:|")
        for name, idx in groups.items():
            pl = torch.as_tensor(out["pulses"][idx], device=dev).contiguous()
            ts = torch.as_tensor(out["targets"][idx], device=dev)
            z = torch.zeros((len(idx), 1), device=dev)
            with torch.no_grad():
                f_exact = float(system.local_mean_fidelity(pl, ts, (z, z, z)).mean())
            rows, T_mean, _ = measure_channels(pl, ts, [args.sigma], system=system,
                                               monte_carlo=args.channels_mc,
                                               epsilon_std=args.epsilon_std)
            _, f1, f2, fe, ff, fp = rows[0]
            print(f"| {name} (n={len(idx)}, T̄={T_mean:.1f}) | {f_exact:.4f} "
                  f"| {f1:.4f} | {f2:.4f} | {fe:.4f} | {ff:.4f} | {fp:.4f} |")
    return out


if __name__ == "__main__":
    main()
