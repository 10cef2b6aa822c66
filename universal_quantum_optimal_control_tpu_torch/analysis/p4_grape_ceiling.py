r"""Single-target GRAPE ceiling of the 4-parameter pulse space — CLI
(PyTorch port of ``analysis/p4_grape_ceiling.py``).

Multi-start GRAPE from random pulse tables (no model prior) in the
(φ, Ω, Δ, τ) space, a σ_δ curriculum (direct ascent at σ = 1 from random
tables collapses), all (gate × start) tables polished jointly through
``workloads/finetune_gates.py::finetune_pulse_tables`` (on ``pallas``:
kernel B1 forward, B3 + B2 backward, at P = 4), then the best start per
gate scored at σ_δ = 1.

The JAX CLI's flags and defaults, plus ``--device`` (default ``cuda``);
the random tables and the disorder come from ``torch.Generator``\ s seeded
with ``--seed``, so they differ from the JAX package's draws.

Usage::

    python -m universal_quantum_optimal_control_tpu_torch.analysis.p4_grape_ceiling \
        [--starts 16] [--num_pulses 100] [--out p4_ceiling.md]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..core.su2 import rotation_vector_to_quat
from ..data import named_gate_rotation_vectors
from ..models import normalize_pulse_space
from ..utils import resolve_device
from ..workloads.finetune_gates import evaluate_tables, finetune_pulse_tables

__all__ = ["main", "measure_ceiling", "P4_SPACE"]

# the reference's declared 4-parameter space at the shipped flagship's
# ranges (Δ ∈ ±5, Ω ∈ [0, 1])
P4_SPACE = {"Delta": (-5.0, 5.0), "Omega": (0.0, 1.0),
            "phi": (-3.15, 3.15), "tau": (0.1, 0.5)}


def measure_ceiling(*, starts=16, num_pulses=100, monte_carlo=4096, eval_mc=200_000,
                    learning_rate=3e-3, seed=0,
                    curriculum=((0.4, 800), (0.7, 800), (1.0, 1500)),
                    epsilon_std=0.05, backend="pallas", gates=None, device=None):
    """Best-of-``starts`` random-init P = 4 GRAPE per named gate at σ_δ = 1.

    The tables start uniform in [0.05, 0.95] of the box, drawn from a
    generator seeded with ``seed`` on ``device``; band ``b`` polishes with
    seed ``seed + b``.  Returns ``(rows, pulses_by_gate)`` with rows of
    ``(gate, ceiling E[F], mean-over-starts E[F], best start index)``.
    """
    dev = resolve_device(device)
    space = normalize_pulse_space(P4_SPACE)
    rvecs = named_gate_rotation_vectors(device=dev)
    names = list(gates or rvecs.keys())
    q_t = rotation_vector_to_quat(torch.stack([rvecs[g] for g in names]))   # (G, 4)
    G, S, L, P = len(names), starts, num_pulses, len(space)

    gen = torch.Generator(device=dev).manual_seed(seed)
    low = torch.tensor([lo for _, (lo, _) in space], dtype=torch.float32, device=dev)
    high = torch.tensor([hi for _, (_, hi) in space], dtype=torch.float32, device=dev)
    u = 0.05 + 0.9 * torch.rand((G * S, L, P), generator=gen, device=dev)
    pulses = low + (high - low) * u
    q_rep = torch.repeat_interleave(q_t, S, dim=0).contiguous()            # (G·S, 4)

    for band, (d_std, steps) in enumerate(curriculum):
        print(f"[band {band}] sigma_delta={d_std} steps={steps}", flush=True)
        pulses, _ = finetune_pulse_tables(
            pulses, q_rep, space, steps=steps, monte_carlo=monte_carlo,
            learning_rate=learning_rate, delta_std=d_std, epsilon_std=epsilon_std,
            seed=seed + band, backend=backend, log_every=max(steps // 4, 1))

    f = evaluate_tables(pulses, q_rep, monte_carlo=eval_mc, delta_std=1.0,
                        epsilon_std=epsilon_std, backend=backend).reshape(G, S)
    tables = pulses.reshape(G, S, L, P).cpu().numpy()
    rows, best_pulses = [], {}
    for i, g in enumerate(names):
        j = int(f[i].argmax())
        rows.append((g, float(f[i, j]), float(f[i].mean()), j))
        best_pulses[g] = tables[i, j]
    return rows, best_pulses


def build_parser():
    p = argparse.ArgumentParser(
        description="P=4 single-target GRAPE ceiling (multi-start, random "
                    "init) at sigma_delta = 1")
    p.add_argument("--starts", type=int, default=16)
    p.add_argument("--num_pulses", type=int, default=100)
    p.add_argument("--monte_carlo", type=int, default=4096)
    p.add_argument("--eval_mc", type=int, default=200_000)
    p.add_argument("--learning_rate", type=float, default=3e-3)
    p.add_argument("--curriculum", default="0.4:800,0.7:800,1.0:1500",
                   help="comma-separated sigma:steps bands")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--backend", default="pallas", choices=["pallas", "xla"])
    p.add_argument("--gates", default=None,
                   help="comma-separated subset (default: all five)")
    p.add_argument("--out", default=None, help="markdown table output path")
    p.add_argument("--save_pulses", default=None,
                   help="optional .npz of the best table per gate")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None):
    """Run the CLI; returns ``(rows, best pulses by gate)``."""
    args = build_parser().parse_args(argv)
    gates = args.gates.split(",") if args.gates else None
    curriculum = tuple((float(b.split(":")[0]), int(b.split(":")[1]))
                       for b in args.curriculum.split(","))
    rows, best = measure_ceiling(
        starts=args.starts, num_pulses=args.num_pulses, monte_carlo=args.monte_carlo,
        eval_mc=args.eval_mc, learning_rate=args.learning_rate, seed=args.seed,
        curriculum=curriculum, backend=args.backend, gates=gates, device=args.device)
    lines = ["| gate | P=4 GRAPE ceiling (best of "
             f"{args.starts}) | mean over starts |", "|---|---:|---:|"]
    for g, best_f, mean_f, _ in rows:
        lines.append(f"| {g} | {best_f:.4f} | {mean_f:.4f} |")
    text = "\n".join(lines)
    print(text)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    if args.save_pulses:
        np.savez(args.save_pulses, **{f"pulses_{g}": v for g, v in best.items()})
    return rows, best


if __name__ == "__main__":
    main()
