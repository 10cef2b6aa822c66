r"""Two-qubit named-gate evaluation — CLI entry point (PyTorch port of
``workloads/two_qubit_eval.py``).

Per-named-gate E[F] of the shipped universal two-qubit model (default
``two_qubit_d2_kak.npz``: drive2, KAK tokens, L = 100) at σ_δ ∈ {0, 0.1,
0.2} for CZ / ZZ(π/4) / CNOT / iSWAP / √SWAP, with common random numbers
across σ and σ = 0 evaluated exactly; ``--polish`` adds a per-gate
multi-start blocks GRAPE row (``(GRAPE)``) for the single-target
comparison.  The JAX CLI's flags and defaults, except:

* ``--backend`` defaults to ``pallas``: the scoring runs kernel B6 (also at
  σ = 0, with zero disorder at M = 1, and for ``--best_phase``'s choice).
  In the JAX package ``SU4System``'s "xla" is a compiled path and the eval
  CLI's default; in the port "xla" is the eager plain version, which must
  not carry the main path on a card.  ``--backend xla`` stays for
  comparison.
* ``--device`` (default ``cuda``; the CPU tests pass ``cpu``).
* ``--polish``'s GRAPE draws from a ``torch.Generator`` seeded with 0 (the
  JAX config's default seed), so its numbers differ from the JAX package's.
* The checkpoint is a shipped ``.npz`` artifact (read where it lies in the
  JAX package's ``demo/weights/``); Orbax ``dir:tag`` checkpoints are the
  JAX package's own.

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.two_qubit_eval \
        --sigmas 0,0.1,0.2 --monte_carlo 20000
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.su4_targets import kak_input_tokens, z4_representatives
from ..models import (TwoQubitQOCTransformer, load_params_npz, normalize_pulse_space,
                      params_from_jax)
from ..optimizers.two_qubit_grape import (TwoQubitGrapeConfig, multistart_grape_su4,
                                          named_two_qubit_targets)
from ..training.systems import SU4System
from ..utils import resolve_device

__all__ = ["main", "eval_pulse_tables", "model_gate_pulses", "best_phase_pulses",
           "load_two_qubit_model"]

_WEIGHTS = (Path(__file__).resolve().parent.parent.parent
            / "universal_quantum_optimal_control_tpu" / "demo" / "weights")
DEFAULT_CKPT = str(_WEIGHTS / "two_qubit_d2_kak.npz")


def load_two_qubit_model(checkpoint: str, *, max_pulses: int = 40, d_model: int = 512,
                         n_layers: int = 8, n_heads: int = 16, drive2: bool = False,
                         kak_features: bool = False, kak_tokens: bool = False,
                         omega_min: float = 0.0, device=None,
                         dtype: torch.dtype = torch.float32) -> TwoQubitQOCTransformer:
    """Build the eval-mode two-qubit model with ``checkpoint``'s weights.
    ``omega_min`` must match the training-time Ω range (the sigmoid's low
    edge is baked into the head)."""
    if not str(checkpoint).endswith(".npz"):
        raise ValueError(f"checkpoint must be an .npz artifact, got {checkpoint!r}")
    space = {"phi": (-3.15, 3.15), "tau": (0.1, 0.5)}
    if drive2:
        space = {"phi1": (-3.15, 3.15), "phi2": (-3.15, 3.15),
                 "omega": (omega_min, 1.0), "tau": (0.1, 0.5)}
    model = TwoQubitQOCTransformer(
        pulse_space=normalize_pulse_space(space), max_pulses=max_pulses,
        d_model=d_model, n_layers=n_layers, n_heads=n_heads, dtype=dtype,
        kak_features=kak_features, kak_tokens=kak_tokens, device=resolve_device(device))
    model.load_state_dict(params_from_jax(load_params_npz(str(checkpoint))))
    return model.eval()


def model_inputs(targets_packed: torch.Tensor, kak_tokens: bool) -> torch.Tensor:
    """The model's input for packed ``(G, 2, 4, 4)`` targets: the targets
    themselves, or their host KAK tokens ``(G, 9, 8)`` on the same device."""
    if not kak_tokens:
        return targets_packed
    packed = targets_packed.detach().cpu().numpy().astype(np.float64)
    U = packed[:, 0] + 1j * packed[:, 1]
    return torch.from_numpy(kak_input_tokens(U)).to(targets_packed.device)


def model_gate_pulses(checkpoint: str, targets_packed: torch.Tensor, *,
                      max_pulses: int = 40, d_model: int = 512, n_layers: int = 8,
                      n_heads: int = 16, drive2: bool = False,
                      kak_features: bool = False, kak_tokens: bool = False,
                      omega_min: float = 0.0, dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """Run the universal two-qubit model on packed ``(G, 2, 4, 4)`` targets →
    ``(G, L, P)`` pulses, on the targets' device.  ``max_pulses`` defaults to
    40 as in the JAX package, where the shipped flagship is L = 100: pass it."""
    model = load_two_qubit_model(
        str(checkpoint), max_pulses=max_pulses, d_model=d_model, n_layers=n_layers,
        n_heads=n_heads, drive2=drive2, kak_features=kak_features,
        kak_tokens=kak_tokens, omega_min=omega_min, device=targets_packed.device,
        dtype=dtype)
    with torch.no_grad():
        return model(model_inputs(targets_packed, kak_tokens))


def exact_fidelity(pulses: torch.Tensor, targets_packed: torch.Tensor,
                   system: SU4System) -> torch.Tensor:
    """``(G,)`` fidelity without disorder: the system's objective at M = 1
    with δ₁ = δ₂ = ε = 0 (kernel B6 on the ``pallas`` backend)."""
    z = torch.zeros((pulses.shape[0], 1), dtype=torch.float32, device=pulses.device)
    with torch.no_grad():
        return system.local_mean_fidelity(pulses, targets_packed, (z, z, z))


def best_phase_pulses(checkpoint: str, U: np.ndarray, system: SU4System,
                      device=None, **model_kw) -> torch.Tensor:
    """Inference-time global-phase canonicalization: run the model on all 4
    SU(4) ℤ₄ representatives of each gate and keep the pulse table whose
    exact σ = 0 fidelity is best (fidelity is phase-invariant, the
    featurization is not).  ``(G, 4, 4)`` complex → ``(G, L, P)`` pulses."""
    reps = np.stack([z4_representatives(u) for u in np.asarray(U)])  # (G, 4, 4, 4)
    G = reps.shape[0]
    packed = SU4System.pack_target(reps.reshape(G * 4, 4, 4)).to(resolve_device(device))
    pulses = model_gate_pulses(checkpoint, packed, **model_kw)
    best = torch.argmax(exact_fidelity(pulses, packed, system).view(G, 4), dim=1)
    return pulses.view(G, 4, *pulses.shape[1:])[torch.arange(G, device=pulses.device), best]


def eval_pulse_tables(pulses: torch.Tensor, targets_packed: torch.Tensor,
                      sigmas: Sequence[float], *, monte_carlo: int = 20_000,
                      epsilon_std: float = 0.05, seed: int = 7,
                      system: Optional[SU4System] = None,
                      draws: Optional[Tuple[torch.Tensor, ...]] = None) -> np.ndarray:
    """Per-gate E[F] at each σ_δ: ``(G, len(sigmas))``.

    Common random numbers across σ: one set of standard-normal draws
    ``(n₁, n₂, n_ε)``, each ``(G, monte_carlo)`` (from a generator seeded
    with ``seed`` on the pulses' device, or given as ``draws``), scaled to
    δᵢ = σ·nᵢ and ε = ε_std·n_ε.  σ = 0 is evaluated exactly (no disorder,
    M = 1).  ``system`` defaults to ``SU4System(backend="pallas")``.
    """
    system = system or SU4System(backend="pallas")
    G = pulses.shape[0]
    if draws is None:
        gen = torch.Generator(device=pulses.device).manual_seed(seed)
        draws = system.sample_errors(gen, (G, monte_carlo), 1.0, 1.0)
    n1, n2, ne = draws
    cols = []
    with torch.no_grad():
        for s in sigmas:
            if s == 0.0:
                F = exact_fidelity(pulses, targets_packed, system)
            else:
                F = system.local_mean_fidelity(pulses, targets_packed,
                                               (n1 * s, n2 * s, ne * epsilon_std))
            cols.append(F.cpu().numpy())
    return np.stack(cols, axis=1)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Evaluate the universal two-qubit model on named gates")
    p.add_argument("--checkpoint", default=DEFAULT_CKPT)
    p.add_argument("--sigmas", default="0,0.1,0.2")
    p.add_argument("--monte_carlo", type=int, default=20_000)
    p.add_argument("--epsilon_std", type=float, default=0.05)
    p.add_argument("--polish", action="store_true",
                   help="also run per-gate multi-start GRAPE (blocks mode) "
                        "for the single-target comparison row")
    p.add_argument("--polish_starts", type=int, default=16)
    p.add_argument("--polish_steps", type=int, default=2000)
    p.add_argument("--out", default=None,
                   help="write the markdown table here as well")
    p.add_argument("--save_pulses", default=None,
                   help="write per-gate model pulse tables to this .npz")
    p.add_argument("--max_pulses", type=int, default=100,
                   help="checkpoint's pulse-sequence length (default matches "
                        "the shipped L=100 flagship; pass 40 for the L=40 "
                        "artifacts, e.g. two_qubit_d2_kak_s0.npz)")
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--n_heads", type=int, default=16)
    p.add_argument("--drive2", action=argparse.BooleanOptionalAction, default=True,
                   help="the checkpoint was trained on the drive2 system "
                        "(4-parameter pulses); --no-drive2 for chi-only ones")
    p.add_argument("--kak_features", action="store_true",
                   help="the checkpoint uses the Makhlin/KAK input token")
    p.add_argument("--omega_min", type=float, default=0.05,
                   help="Omega range low edge baked into the checkpoint's head")
    p.add_argument("--kak_tokens", action=argparse.BooleanOptionalAction, default=True,
                   help="the checkpoint uses the full KAK featurization")
    p.add_argument("--best_phase", action=argparse.BooleanOptionalAction, default=True,
                   help="run the model on all 4 SU(4) Z4 representatives per "
                        "gate and keep the best; --no-best_phase evaluates the "
                        "textbook matrix as written")
    p.add_argument("--backend", default="pallas", choices=["xla", "pallas"],
                   help="pallas (default): kernel B6; xla: the eager plain "
                        "PyTorch version, for comparison")
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back by itself")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns ``{gate: {"model": [E[F] per σ], ["grape": ...]}}``."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    sigmas = [float(s) for s in args.sigmas.split(",")]
    system = SU4System(drive2=args.drive2, backend=args.backend)
    model_kw = dict(drive2=args.drive2, kak_features=args.kak_features,
                    kak_tokens=args.kak_tokens, omega_min=args.omega_min,
                    max_pulses=args.max_pulses, d_model=args.d_model,
                    n_layers=args.n_layers, n_heads=args.n_heads)

    gates = named_two_qubit_targets()
    names = list(gates)
    U = np.stack([gates[g] for g in names])              # (G, 4, 4) complex
    packed = SU4System.pack_target(U).to(dev)            # (G, 2, 4, 4)
    if args.best_phase:
        pulses = best_phase_pulses(args.checkpoint, U, system, device=dev, **model_kw)
    else:
        pulses = model_gate_pulses(args.checkpoint, packed, **model_kw)
    table = eval_pulse_tables(pulses, packed, sigmas, monte_carlo=args.monte_carlo,
                              epsilon_std=args.epsilon_std, system=system)
    rows = {g: {"model": [float(v) for v in table[i]]} for i, g in enumerate(names)}
    if args.polish:
        for i, g in enumerate(names):
            cfg = TwoQubitGrapeConfig(mode="blocks", n_starts=args.polish_starts,
                                      steps=args.polish_steps, drive2=args.drive2,
                                      sigmas=tuple(s for s in sigmas if s > 0))
            gp, info = multistart_grape_su4(U[i], cfg, device=dev)
            tp = eval_pulse_tables(torch.as_tensor(gp, device=dev)[None].contiguous(),
                                   packed[i:i + 1], sigmas, monte_carlo=args.monte_carlo,
                                   epsilon_std=args.epsilon_std, system=system)
            rows[g]["grape"] = [float(v) for v in tp[0]]
            print(f"polished {g}: stages {[round(s['best_fid'], 4) for s in info['stages']]}")

    header = "| gate | " + " | ".join(f"E[F] σ={s:g}" for s in sigmas) + " |"
    lines = ["# Two-qubit named-gate evaluation", "",
             f"Universal model `{Path(args.checkpoint).name}`; "
             f"M={args.monte_carlo}, ε_std={args.epsilon_std}, CRN across σ; "
             f"backend {args.backend} on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'}.",
             "", header, "|" + "---|" * (len(sigmas) + 1)]
    for g in names:
        lines.append("| " + g + " | " + " | ".join(f"{v:.4f}" for v in rows[g]["model"]) + " |")
        if "grape" in rows[g]:
            lines.append("| " + g + " (GRAPE) | "
                         + " | ".join(f"{v:.4f}" for v in rows[g]["grape"]) + " |")
    text = "\n".join(lines)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    if args.save_pulses:
        np.savez(args.save_pulses,
                 meta_json=json.dumps({"gates": names, "sigmas": sigmas,
                                       "fidelity": rows}),
                 **{f"pulses_{i}": pulses[i].cpu().numpy() for i in range(len(names))})
        print(f"saved {args.save_pulses}")
    return rows


if __name__ == "__main__":
    main()
