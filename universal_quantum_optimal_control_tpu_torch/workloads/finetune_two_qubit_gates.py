r"""Per-gate two-qubit pulse finetuning — CLI (PyTorch port of
``workloads/finetune_two_qubit_gates.py``).

Two candidate sources per named gate, as in the JAX package:

1. **Model-basin polish**: the flagship's best-of-ℤ₄ pulse table, polished
   by Adam on a σ-mixed Monte-Carlo expected fidelity inside the model's
   own pulse box (:func:`finetune_su4_tables`).  On the ``pallas`` backend
   each step runs kernel B4 forward and B5 backward once per σ term (the
   exact term at M = 1 with zero disorder, then each σ > 0 at
   ``--monte_carlo``), all gates in one launch.
2. **Blocks GRAPE** (``--grape``): multi-start block-structured GRAPE with a
   σ curriculum (:mod:`..optimizers.two_qubit_grape`).

Each gate ships whichever candidate scores best on the σ-grid eval
(common draws across σ, ``two_qubit_eval.eval_pulse_tables``, kernel B6 on
``pallas``).  Output is one ``.npz`` bundle the demo serves for exact
named-gate requests (``demo/app.py``'s ``two_qubit_gates`` variant).

The JAX CLI's flags and defaults, except:

* ``--out`` defaults to ``weights/two_qubit_gates.npz`` under the working
  directory: the JAX default is the shipped bundle inside the JAX package,
  which no run of the port may overwrite;
* ``--device`` (default ``cuda``); the candidates' evaluation runs on
  ``--backend`` too (default ``pallas``: B6), where the JAX CLI evaluates
  on its XLA path;
* the random numbers come from ``torch.Generator``\ s (the polish's draws
  and each GRAPE run seeded with ``--seed``), so they differ from the JAX
  package's.

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.finetune_two_qubit_gates \
        --steps 1500 --out weights/two_qubit_gates.npz
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..optimizers.two_qubit_grape import (TwoQubitGrapeConfig, multistart_grape_su4,
                                          named_two_qubit_targets)
from ..training.systems import SU4System
from ..utils import resolve_device
from .two_qubit_eval import DEFAULT_CKPT, best_phase_pulses, eval_pulse_tables

__all__ = ["main", "finetune_su4_tables", "load_two_qubit_gate_bundle", "DRIVE2_SPACE"]

# the flagship's drive2 pulse box (the training-time range map: the sigmoid
# edges are baked into the head's calibration)
DRIVE2_SPACE = (("phi1", (-3.15, 3.15)), ("phi2", (-3.15, 3.15)),
                ("omega", (0.05, 1.0)), ("tau", (0.1, 0.5)))


def _logits_from_pulses(pulses: torch.Tensor, low: torch.Tensor,
                        high: torch.Tensor) -> torch.Tensor:
    """Invert the sigmoid range map so optimization starts exactly at the
    model's pulses (clipped a hair inside the open interval)."""
    u = torch.clamp((pulses - low) / (high - low), 1e-4, 1.0 - 1e-4)
    return torch.log(u / (1.0 - u))


def finetune_su4_tables(pulses0: torch.Tensor, targets_packed: torch.Tensor, pulse_space, *,
                        steps: int = 1500, monte_carlo: int = 4096,
                        learning_rate: float = 3e-3,
                        sigma_mix: Sequence[float] = (0.0, 0.1, 0.2),
                        epsilon_std: float = 0.05, seed: int = 0,
                        system: Optional[SU4System] = None, backend: str = "pallas",
                        log_every: int = 100,
                        draws: Optional[Sequence[Tuple[torch.Tensor, ...]]] = None
                        ) -> Tuple[torch.Tensor, list]:
    """Polish ``(G, L, P)`` SU(4) pulse tables by gradient ascent on the
    σ-mixed expected fidelity (equal-weight mean over ``sigma_mix``; the
    σ = 0 term is the exact fidelity), on ``pulses0``'s device.

    Each step takes fresh standard normals ``(n₁, n₂, n_ε)``, each
    ``(G, monte_carlo)``, in that order from a generator seeded with
    ``seed`` on that device, or ``draws[i]`` where given; the σ terms share them
    (δᵢ = σ·nᵢ, ε = ε_std·n_ε).  Adam is elementwise, so the G tables
    optimize jointly, each as if alone.  Returns ``(pulses, history)``;
    as in the JAX package the kept iterate is the one after the logged step
    (the first and every ``log_every``-th) whose objective was best.
    """
    system = system or SU4System(drive2=True, backend=backend)
    dev = pulses0.device
    low = torch.tensor([lo for _, (lo, _) in pulse_space], dtype=torch.float32, device=dev)
    high = torch.tensor([hi for _, (_, hi) in pulse_space], dtype=torch.float32, device=dev)
    logits = _logits_from_pulses(pulses0.float(), low, high).detach().requires_grad_(True)
    G = logits.shape[0]
    sig_pos = [float(s) for s in sigma_mix if s > 0.0]
    with_exact = any(s == 0.0 for s in sigma_mix)
    n_terms = len(sig_pos) + (1 if with_exact else 0)
    generator = torch.Generator(device=dev).manual_seed(seed)
    opt = torch.optim.Adam([logits], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    zeros1 = torch.zeros((G, 1), dtype=torch.float32, device=dev)

    def to_pulses(lg):
        return low + (high - low) * torch.sigmoid(lg)

    history = []
    best_logits, best_f = logits.detach().clone(), -np.inf
    for i in range(steps):
        if draws is not None:
            n1, n2, ne = draws[i]
        else:
            n1, n2, ne = (torch.randn((G, monte_carlo), generator=generator, device=dev)
                          for _ in range(3))
        ep = ne * epsilon_std
        pulses = to_pulses(logits)
        per_gate = torch.zeros((G,), dtype=torch.float32, device=dev)
        if with_exact:
            per_gate = per_gate + system.local_mean_fidelity(pulses, targets_packed,
                                                             (zeros1, zeros1, zeros1))
        for s in sig_pos:
            per_gate = per_gate + system.local_mean_fidelity(pulses, targets_packed,
                                                             (n1 * s, n2 * s, ep))
        per_gate = per_gate / n_terms
        opt.zero_grad(set_to_none=True)
        (-torch.mean(per_gate)).backward()
        opt.step()
        if (i + 1) % log_every == 0 or i == 0:
            mf = float(torch.mean(per_gate.detach()))
            history.append((i + 1, mf))
            if mf > best_f:
                best_f, best_logits = mf, logits.detach().clone()
            print(f"  step {i + 1:5d}  sigma-mixed mean E[F] {mf:.5f}", flush=True)
    with torch.no_grad():
        return to_pulses(best_logits), history


def load_two_qubit_gate_bundle(path: str):
    """Load a two-qubit gate bundle ``.npz`` → (dict gate → pulses, meta).

    Tables may be ragged across gates (model tables L = 40 or 100,
    blocks-GRAPE tables L = 2·n_blocks), so they ship as separate per-gate
    arrays."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta_json"]))
        tables = {g: z[f"pulses_{i}"] for i, g in enumerate(meta["gates"])}
    return tables, meta


def _score(table_row, sigmas, select_sigmas) -> float:
    idx = [sigmas.index(s) for s in select_sigmas]
    return float(np.mean([table_row[i] for i in idx]))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Finetune per-named-gate SU(4) pulse tables from the "
                    "two-qubit flagship (+ optional blocks GRAPE)")
    p.add_argument("--checkpoint", default=DEFAULT_CKPT)
    p.add_argument("--gates", default=None,
                   help="comma list; default = all five named gates")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--monte_carlo", type=int, default=4096)
    p.add_argument("--learning_rate", type=float, default=3e-3)
    p.add_argument("--sigma_mix", default="0,0.1,0.2",
                   help="polish objective: equal-weight mean E[F] over "
                        "these sigma_delta values (0 = exact term)")
    p.add_argument("--epsilon_std", type=float, default=0.05)
    p.add_argument("--eval_sigmas", default="0,0.1,0.2,0.3")
    p.add_argument("--eval_mc", type=int, default=20_000)
    p.add_argument("--select_sigmas", default="0,0.1,0.2",
                   help="per-gate winner = best mean eval E[F] over these")
    p.add_argument("--backend", default="pallas", choices=["xla", "pallas"],
                   help="pallas (default): kernels B4/B5 (polish) and B6 "
                        "(eval); xla: the eager plain version")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--grape", action=argparse.BooleanOptionalAction, default=True,
                   help="also run per-gate multi-start blocks GRAPE "
                        "(sigma curriculum) as a second candidate")
    p.add_argument("--grape_sigmas", default="0.1,0.2")
    p.add_argument("--grape_starts", type=int, default=16)
    p.add_argument("--grape_steps", type=int, default=2000)
    # flagship model featurization (two_qubit_d2_kak.npz training config)
    p.add_argument("--max_pulses", type=int, default=100,
                   help="checkpoint pulse-sequence length (the shipped flagship is L=100)")
    p.add_argument("--omega_min", type=float, default=0.05)
    p.add_argument("--kak_tokens", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument("--out", default=str(Path("weights") / "two_qubit_gates.npz"),
                   help="bundle path (default under the working directory)")
    p.add_argument("--table_out", default=None,
                   help="write the markdown eval table here as well")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back by itself")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"names", "sigmas", "select", "f_model",
    "candidates", "sources", "fidelity", "out"}``."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    sigmas = [float(s) for s in args.eval_sigmas.split(",")]
    select = [float(s) for s in args.select_sigmas.split(",")]
    sigma_mix = tuple(float(s) for s in args.sigma_mix.split(","))
    system = SU4System(drive2=True, backend=args.backend)

    gates = named_two_qubit_targets()
    names = [g.strip() for g in args.gates.split(",")] if args.gates else list(gates)
    U = np.stack([gates[g] for g in names])
    packed = SU4System.pack_target(U).to(dev)

    def evaluate(pulses, targets):
        return eval_pulse_tables(pulses, targets, sigmas, monte_carlo=args.eval_mc,
                                 epsilon_std=args.epsilon_std, system=system)

    pulses0 = best_phase_pulses(args.checkpoint, U, system, device=dev, drive2=True,
                                kak_tokens=args.kak_tokens, omega_min=args.omega_min,
                                max_pulses=args.max_pulses).contiguous()
    f_model = evaluate(pulses0, packed)
    print("model tables:", {g: [round(float(v), 4) for v in f_model[i]]
                            for i, g in enumerate(names)}, flush=True)

    space = DRIVE2_SPACE[:2] + ((("omega", (args.omega_min, 1.0)),) + DRIVE2_SPACE[3:])
    polished, _ = finetune_su4_tables(
        pulses0, packed, space, steps=args.steps, monte_carlo=args.monte_carlo,
        learning_rate=args.learning_rate, sigma_mix=sigma_mix,
        epsilon_std=args.epsilon_std, seed=args.seed, system=system)
    f_polish = evaluate(polished, packed)
    print("polished tables:", {g: [round(float(v), 4) for v in f_polish[i]]
                               for i, g in enumerate(names)}, flush=True)

    candidates = {g: [("model", pulses0[i].cpu().numpy(), f_model[i]),
                      ("polish", polished[i].cpu().numpy(), f_polish[i])]
                  for i, g in enumerate(names)}
    if args.grape:
        g_sigmas = tuple(float(s) for s in args.grape_sigmas.split(",") if s.strip())
        for i, g in enumerate(names):
            cfg = TwoQubitGrapeConfig(mode="blocks", n_starts=args.grape_starts,
                                      steps=args.grape_steps, drive2=True, sigmas=g_sigmas,
                                      seed=args.seed)
            gp, info = multistart_grape_su4(U[i], cfg, device=dev)
            fg = evaluate(torch.as_tensor(gp, device=dev)[None].contiguous(),
                          packed[i:i + 1])[0]
            candidates[g].append(("grape", gp, fg))
            print(f"grape {g}: {[round(float(v), 4) for v in fg]} "
                  f"(stages {[round(s['best_fid'], 4) for s in info['stages']]})", flush=True)

    chosen, fid_rows, sources = [], [], []
    for g in names:
        best = max(candidates[g], key=lambda c: _score(c[2], sigmas, select))
        sources.append(best[0])
        chosen.append(best[1])
        fid_rows.append([float(v) for v in best[2]])

    header = "| gate | source | " + " | ".join(f"E[F] σ={s:g}" for s in sigmas) + " |"
    lines = ["# Two-qubit per-gate finetuned bundle", "",
             f"Flagship `{Path(args.checkpoint).name}` basin polish vs "
             f"blocks GRAPE, best-of per gate; M={args.eval_mc}, "
             f"ε_std={args.epsilon_std}, CRN across σ.", "",
             header, "|" + "---|" * (len(sigmas) + 2)]
    for i, g in enumerate(names):
        lines.append(f"| {g} | {sources[i]} | "
                     + " | ".join(f"{v:.4f}" for v in fid_rows[i]) + " |")
    text = "\n".join(lines)
    print(text, flush=True)

    meta = {"gates": names, "sigmas": sigmas, "sources": sources, "fidelity": fid_rows,
            "fidelity_model": [[float(v) for v in row] for row in f_model],
            "epsilon_std": args.epsilon_std, "eval_mc": args.eval_mc, "drive2": True,
            "checkpoint": Path(args.checkpoint).name, "sigma_mix": list(sigma_mix),
            "steps": args.steps}
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, meta_json=json.dumps(meta),
             **{f"pulses_{i}": np.asarray(p, np.float32) for i, p in enumerate(chosen)})
    print(f"saved {out}")
    if args.table_out:
        Path(args.table_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.table_out).write_text(text + "\n")
    return {"names": names, "sigmas": sigmas, "select": select, "f_model": f_model,
            "candidates": candidates, "sources": sources, "fidelity": fid_rows,
            "out": str(out)}


if __name__ == "__main__":
    main()
