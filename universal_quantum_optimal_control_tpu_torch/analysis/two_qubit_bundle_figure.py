r"""Combined robustness figure for the two-qubit per-gate bundle (port of the
JAX package's ``analysis/two_qubit_bundle_figure.py``).

One plot: ``E[F](σ_δ)`` for every gate table of the shipped
``two_qubit_gates.npz`` (drive2 system, i.i.d. per-qubit off-resonance
draws, ε_std = 0.05), each gate's sweep one launch of kernel B7 on CUDA
(``analysis/plots_su4.py::fidelity_by_std_su4``: 12 σ × M samples).
:func:`bundle_curves` is the numeric half, which needs no matplotlib.

Usage (``--device cpu`` runs the plain version):
    python -m universal_quantum_optimal_control_tpu_torch.analysis.two_qubit_bundle_figure \
        --out /tmp/bundle.png --monte_carlo 256 --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..core.su4 import TwoQubitSystem
from ..optimizers.two_qubit_grape import named_two_qubit_targets
from ..utils.device import resolve_device
from ..workloads.finetune_two_qubit_gates import load_two_qubit_gate_bundle
from .plots import _pyplot
from .plots_su4 import fidelity_by_std_su4

__all__ = ["main", "render_bundle_figure", "bundle_curves"]

_DEFAULT_BUNDLE = str(Path(__file__).resolve().parent.parent.parent
                      / "universal_quantum_optimal_control_tpu" / "demo" / "weights"
                      / "two_qubit_gates.npz")


def bundle_curves(bundle_path: str, *, monte_carlo: int = 2000, stds=None,
                  epsilon_std: float = 0.05, seed: int = 0, device=None) -> dict:
    """``{gate: (stds, mean, se)}`` for every gate of the bundle, σ_δ = 0.05,
    0.10, …, 0.60 by default; each gate's draws from a generator seeded with
    ``seed`` on ``device``."""
    dev = resolve_device(device)
    tables, meta = load_two_qubit_gate_bundle(bundle_path)
    system = TwoQubitSystem(drive2=bool(meta.get("drive2", False)))
    gates = named_two_qubit_targets()
    stds = np.asarray(np.arange(0.05, 0.65, 0.05) if stds is None else stds, np.float32)
    return {g: fidelity_by_std_su4(tables[g], gates[g], system, stds=stds,
                                   epsilon_std=epsilon_std, monte_carlo=monte_carlo,
                                   generator=torch.Generator(device=dev).manual_seed(seed),
                                   device=dev)
            for g in meta["gates"]}


def render_bundle_figure(bundle_path: str, out_path: str, *, monte_carlo: int = 2000,
                         stds=None, epsilon_std: float = 0.05, seed: int = 0,
                         device=None) -> dict:
    """Render the combined E[F](σ_δ) sweep of every bundle gate to
    ``out_path``; returns :func:`bundle_curves`' ``{gate: (stds, mean, se)}``."""
    curves = bundle_curves(bundle_path, monte_carlo=monte_carlo, stds=stds,
                           epsilon_std=epsilon_std, seed=seed, device=device)
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(7.0, 5.0))
    for g, (s, mean, se) in curves.items():
        ax.errorbar(s, mean, yerr=se, marker="o", ms=3, lw=1.2, capsize=2, label=g)
    ax.set_xlabel(r"$\sigma_\delta$ (per-qubit off-resonance std)")
    ax.set_ylabel(r"$E[F]$")
    ax.set_ylim(0.4, 1.005)
    ax.grid(alpha=0.3)
    ax.legend(title="gate", loc="lower left")
    ax.set_title(f"two-qubit per-gate bundle robustness "
                 f"(drive2, ε_std={epsilon_std}, M={monte_carlo})")
    fig.tight_layout()
    Path(out_path).parent.mkdir(parents=True, exist_ok=True)
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return curves


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="Render the two-qubit gate-bundle robustness figure")
    p.add_argument("--bundle", default=_DEFAULT_BUNDLE)
    p.add_argument("--out", default="docs/two_qubit_gates_bundle.png")
    p.add_argument("--monte_carlo", type=int, default=2000)
    p.add_argument("--epsilon_std", type=float, default=0.05)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    curves = render_bundle_figure(args.bundle, args.out, monte_carlo=args.monte_carlo,
                                  epsilon_std=args.epsilon_std, seed=args.seed,
                                  device=args.device)
    for g, (s, mean, _) in curves.items():
        print(g, {round(float(a), 2): round(float(b), 4) for a, b in zip(s[::4], mean[::4])})
    print(f"saved {args.out}")


if __name__ == "__main__":
    main()
