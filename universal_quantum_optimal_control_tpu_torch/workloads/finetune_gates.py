r"""Per-gate single-qubit pulse finetuning from a universal model — CLI
(PyTorch port of ``workloads/finetune_gates.py``).

Take a universal model's pulse table for each named gate, re-parameterize
it as sigmoid logits over the model's own pulse box, and polish each table
by direct gradient ascent on E[F] (:func:`finetune_pulse_tables`).  On the
``pallas`` backend each step runs kernel B1 forward and B3 + B2 backward,
all gates in one launch each.  The output is one ``.npz`` bundle of
per-gate tables with their eval fidelities, which ``demo/app.py`` serves
for exact named-gate requests (:func:`load_gate_bundle`).

The JAX CLI's flags and defaults, except:

* ``--out`` defaults to ``weights/length100_gates.npz`` under the working
  directory: the JAX default is the shipped bundle inside the JAX package,
  which no run of the port may overwrite;
* ``--device`` (default ``cuda``);
* the disorder comes from ``torch.Generator``\ s seeded with ``--seed``
  (the polish) and 123 (the evaluations), so the draws differ from the
  JAX package's.

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.finetune_gates \
        --variant length_100 --out weights/length100_gates.npz
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.errors import sample_ore_ple
from ..core.su2 import rotation_vector_to_quat
from ..data import named_gate_rotation_vectors
from ..parallel.mc_parallel import mean_fidelity_local
from ..utils import resolve_device

__all__ = ["main", "clamp_tau_nonnegative", "polish_step", "finetune_pulse_tables",
           "evaluate_tables", "load_gate_bundle"]


def clamp_tau_nonnegative(pulse_space):
    """The polish box with the τ channel's low edge clamped to 0.

    A zeroable-τ model box (low < 0) is physical only because the model's
    head relu's τ; the polish optimizes the raw box, and a negative
    duration is time-reversed evolution that undoes the disorder exactly
    (an unguarded polish reaches E[F] = 0.9999 at σ_δ = 1).  Zeroed
    segments start at the bottom edge and can still revive."""
    return tuple((name, (max(lo, 0.0), hi)) if name in ("tau", "t") else (name, (lo, hi))
                 for name, (lo, hi) in pulse_space)


def _logits_from_pulses(pulses: torch.Tensor, low: torch.Tensor,
                        high: torch.Tensor) -> torch.Tensor:
    """Invert the sigmoid range map so optimization starts exactly at the
    model's pulses (clipped a hair inside the open interval)."""
    u = torch.clamp((pulses - low) / (high - low), 1e-4, 1.0 - 1e-4)
    return torch.log(u / (1.0 - u))


def _box(pulse_space, device) -> Tuple[torch.Tensor, torch.Tensor]:
    low = torch.tensor([lo for _, (lo, _) in pulse_space], dtype=torch.float32, device=device)
    high = torch.tensor([hi for _, (_, hi) in pulse_space], dtype=torch.float32, device=device)
    return low, high


def polish_step(logits: torch.Tensor, optimizer: torch.optim.Optimizer,
                low: torch.Tensor, high: torch.Tensor, q_targets: torch.Tensor,
                delta: torch.Tensor, eps: torch.Tensor, backend: str = "pallas"
                ) -> torch.Tensor:
    """One Adam step on ``logits`` (a leaf ``(G, L, P)``) against
    ``−mean_g E[F]`` on the disorder ``(δ, ε)``, each ``(G, M)``.  Returns
    the per-gate E[F] ``(G,)`` before the step (detached)."""
    f = mean_fidelity_local(low + (high - low) * torch.sigmoid(logits), q_targets,
                            delta, eps, backend)
    optimizer.zero_grad(set_to_none=True)
    (-torch.mean(f)).backward()
    optimizer.step()
    return f.detach()


def finetune_pulse_tables(pulses0: torch.Tensor, q_targets: torch.Tensor, pulse_space, *,
                          steps: int = 1500, monte_carlo: int = 8192,
                          learning_rate: float = 3e-3, delta_std: float = 1.0,
                          epsilon_std: float = 0.05, seed: int = 0, backend: str = "pallas",
                          log_every: int = 100,
                          draws: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None
                          ) -> Tuple[torch.Tensor, list]:
    """Polish ``(G, L, P)`` pulse tables by direct gradient ascent on E[F],
    on ``pulses0``'s device.

    Plain Adam (optax's defaults, no clipping), the G tables jointly (Adam
    is elementwise, so each optimizes as if alone).  Each step draws fresh
    disorder ``(G, monte_carlo)`` from a generator seeded with ``seed`` on
    that device, or takes ``draws[i]`` where given.  Returns ``(pulses,
    history of (step, mean E[F]))``; as in the JAX package the kept iterate
    is the one after the logged step (the first and every
    ``log_every``-th) whose E[F] was best."""
    dev = pulses0.device
    low, high = _box(pulse_space, dev)
    logits = _logits_from_pulses(pulses0.float(), low, high).detach().requires_grad_(True)
    q_targets = q_targets.float().contiguous()
    opt = torch.optim.Adam([logits], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    generator = torch.Generator(device=dev).manual_seed(seed)
    history = []
    best_logits, best_f = logits.detach().clone(), -np.inf
    for i in range(steps):
        if draws is not None:
            delta, eps = draws[i]
        else:
            delta, eps = sample_ore_ple(generator, (logits.shape[0], monte_carlo),
                                        delta_std, epsilon_std)
        f = polish_step(logits, opt, low, high, q_targets, delta, eps, backend)
        if (i + 1) % log_every == 0 or i == 0:
            mf = float(torch.mean(f))
            history.append((i + 1, mf))
            if mf > best_f:
                best_f, best_logits = mf, logits.detach().clone()
            print(f"  step {i + 1:5d}  mean E[F] {mf:.5f}", flush=True)
    with torch.no_grad():
        return low + (high - low) * torch.sigmoid(best_logits), history


@torch.no_grad()
def evaluate_tables(pulses: torch.Tensor, q_targets: torch.Tensor, *,
                    monte_carlo: int = 200_000, delta_std: float = 1.0,
                    epsilon_std: float = 0.05, seed: int = 123, backend: str = "pallas",
                    draws: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> np.ndarray:
    """Converged per-gate E[F] ``(G,)`` on common draws across the gates
    (from a generator seeded with ``seed`` on the pulses' device, or
    ``draws`` where given)."""
    if draws is None:
        gen = torch.Generator(device=pulses.device).manual_seed(seed)
        draws = sample_ore_ple(gen, (pulses.shape[0], monte_carlo), delta_std, epsilon_std)
    f = mean_fidelity_local(pulses.float().contiguous(), q_targets.float().contiguous(),
                            *draws, backend)
    return f.cpu().numpy()


def load_gate_bundle(path: str):
    """Load a gate bundle ``.npz`` → (dict gate → pulses ``(L, P)``, metadata)."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta_json"]))
        tables = {g: z[f"pulses_{i}"] for i, g in enumerate(meta["gates"])}
    return tables, meta


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Finetune per-named-gate pulse tables from a universal "
                    "model checkpoint")
    p.add_argument("--variant", default="length_100",
                   help="demo model variant to initialize from")
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--gates", default=None,
                   help="comma list; default = all five named gates")
    p.add_argument("--steps", type=int, default=1500)
    p.add_argument("--monte_carlo", type=int, default=8192)
    p.add_argument("--learning_rate", type=float, default=3e-3)
    p.add_argument("--delta_std", type=float, default=1.0)
    p.add_argument("--epsilon_std", type=float, default=0.05)
    p.add_argument("--eval_mc", type=int, default=200_000)
    p.add_argument("--backend", default="pallas", choices=["xla", "pallas"],
                   help="pallas (default): kernel B1 forward, B3 + B2 backward; "
                        "xla: the eager plain version")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--pulse_params", type=int, default=None, choices=[2, 3, 4],
                   help="widen the polish space beyond the model's: 3 adds "
                        "the Rabi amplitude Omega, 4 adds the detuning "
                        "Delta.  Tables start at the model's pulses (Omega=1, "
                        "Delta=0), so any gain is the extra controls'")
    p.add_argument("--delta_range", type=float, default=5.0,
                   help="detuning control range (-x, x) for --pulse_params 4")
    p.add_argument("--out", default=str(Path("weights") / "length100_gates.npz"),
                   help="bundle path (default under the working directory)")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back by itself")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"names", "f_model", "f_start", "f_finetuned",
    "pulses", "history", "out"}`` (``f_start`` is the widened start's E[F],
    or ``f_model`` without widening)."""
    from ..demo.app import load_pipeline

    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    pipe = load_pipeline(args.variant, args.checkpoint, device=dev)
    gates = named_gate_rotation_vectors(device=dev)
    names = [g.strip() for g in args.gates.split(",")] if args.gates else list(gates)
    rv = torch.stack([gates[g] for g in names])                 # (G, 4)
    q_targets = rotation_vector_to_quat(rv).contiguous()
    pulses0 = pipe(rv).float()                                   # (G, L, P)
    ev = dict(monte_carlo=args.eval_mc, delta_std=args.delta_std,
              epsilon_std=args.epsilon_std, backend=args.backend)

    f0 = evaluate_tables(pulses0, q_targets, **ev)
    print("model E[F] at sigma={}: {}".format(
        args.delta_std, {g: round(float(v), 4) for g, v in zip(names, f0)}), flush=True)

    pulse_space = clamp_tau_nonnegative(tuple(pipe.model.pulse_space))
    pulses0 = torch.cat([pulses0[..., :-1], torch.clamp_min(pulses0[..., -1:], 0.0)], dim=-1)
    f_start = f0
    P0 = pulses0.shape[-1]
    if args.pulse_params and args.pulse_params > P0:
        if P0 != 2:
            raise ValueError("--pulse_params widening expects a 2-parameter "
                             f"source model, got P={P0}")
        # (φ, τ) → (φ, Ω[, Δ], τ) with the extra controls at their P = 2
        # values: Ω = 1 (the logits' clip puts it at 0.9999), Δ = 0, so step
        # 0 reproduces the source fidelity
        G, L, _ = pulses0.shape
        cols = [pulses0[..., 0], torch.ones((G, L), device=dev)]
        extra = [("omega", (0.0, 1.0))]
        if args.pulse_params == 4:
            cols.append(torch.zeros((G, L), device=dev))
            extra.append(("delta", (-args.delta_range, args.delta_range)))
        cols.append(pulses0[..., 1])
        pulses0 = torch.stack(cols, dim=-1)
        pulse_space = (pulse_space[0], *extra, pulse_space[1])
        f_start = evaluate_tables(pulses0, q_targets, **ev)
        print("widened P={} start E[F]: {}".format(
            args.pulse_params, {g: round(float(v), 4) for g, v in zip(names, f_start)}),
            flush=True)
    pulses, history = finetune_pulse_tables(
        pulses0.contiguous(), q_targets, pulse_space, steps=args.steps,
        monte_carlo=args.monte_carlo, learning_rate=args.learning_rate,
        delta_std=args.delta_std, epsilon_std=args.epsilon_std, seed=args.seed,
        backend=args.backend)

    f1 = evaluate_tables(pulses, q_targets, **ev)
    print("finetuned E[F]: {}".format(
        {g: round(float(v), 4) for g, v in zip(names, f1)}), flush=True)

    meta = {
        "gates": names,
        "rotation_vectors": rv.cpu().numpy().tolist(),
        "delta_std": args.delta_std,
        "epsilon_std": args.epsilon_std,
        "eval_mc": args.eval_mc,
        "fidelity_model": [float(v) for v in f0],
        "fidelity_finetuned": [float(v) for v in f1],
        "source_variant": args.variant,
        "steps": args.steps,
    }
    tables = pulses.cpu().numpy()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez(out, meta_json=json.dumps(meta),
             **{f"pulses_{i}": tables[i] for i in range(len(names))})
    print(f"saved {out}")
    return {"names": names, "f_model": f0, "f_start": f_start, "f_finetuned": f1,
            "pulses": pulses, "history": history, "out": str(out)}


if __name__ == "__main__":
    main()
