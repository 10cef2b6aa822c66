r"""Model-vs-SCORE parity figure: one command, all five named gates (port of
the JAX package's ``analysis/parity_figure.py``).

Per named gate it evaluates the model variant's pulse table (served by
``demo/app.py::compute_pulses``) and the analytic SCORE composite on a
common disorder sweep (the same draws for both) and writes one multi-panel
figure and a markdown table.  The sweeps and estimates go through kernel B3
on CUDA: 20 launches, the SCORE tables 403 to 2019 segments long.

Usage (``--device cpu`` runs the plain versions):
    python -m universal_quantum_optimal_control_tpu_torch.analysis.parity_figure \
        --variant small_20 --monte_carlo 500 --out /tmp/parity --device cpu
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from ..data.su2_targets import named_gate_rotation_vectors
from ..utils.device import resolve_device
from .plots import _pyplot, fidelity_by_std, mc_fidelity_estimate, total_time_pi
from .score_pulses import NAMED_SCORE_TARGETS, build_score_pulses

__all__ = ["GATE_TO_SCORE", "gate_parity_curves", "render", "main"]

# named gate → SCORE composite spec (Y is SCORE-1 about φ = π/2; the four
# others are the published composites)
GATE_TO_SCORE = {
    "X": NAMED_SCORE_TARGETS["X(pi)"],
    "X(pi/2)": NAMED_SCORE_TARGETS["X(pi/2)"],
    "Y": [(1, 1 / 2)],
    "Z(pi/4)": NAMED_SCORE_TARGETS["Z(pi/4)"],
    "H": NAMED_SCORE_TARGETS["Hadamard"],
}


def gate_parity_curves(
    variant: str,
    checkpoint: Optional[str] = None,
    monte_carlo: int = 10000,
    stds=None,
    eval_delta_std: float = 1.0,
    epsilon_std: float = 0.05,
    seed: int = 0,
    device=None,
) -> Dict[str, Dict]:
    """Per-gate E[F](σ_δ) curves and E[F] at ``eval_delta_std`` for the model
    variant and the SCORE baseline: ``{gate: {"model" | "SCORE": {"stds",
    "mean", "se", "EF", "EF_se", "total_time_pi"}}}``.  Every sweep and
    every estimate starts from a generator seeded with ``seed`` on
    ``device``."""
    from ..demo.app import compute_pulses

    dev = resolve_device(device)
    score = build_score_pulses(dict(GATE_TO_SCORE))

    def gen():
        return torch.Generator(device=dev).manual_seed(seed)

    results: Dict[str, Dict] = {}
    for name, rv in named_gate_rotation_vectors(device="cpu").items():
        model_pulses, q_t = compute_pulses(variant, *rv.tolist(), checkpoint=checkpoint,
                                           device=dev)
        entry = {}
        for label, pulses in (("model", model_pulses), ("SCORE", score[name])):
            s, mean, se = fidelity_by_std(pulses, q_t, stds=stds, epsilon_std=epsilon_std,
                                          monte_carlo=monte_carlo, generator=gen(),
                                          device=dev)
            ef, ef_se = mc_fidelity_estimate(pulses, q_t, delta_std=eval_delta_std,
                                             epsilon_std=epsilon_std,
                                             monte_carlo=monte_carlo, generator=gen(),
                                             device=dev)
            entry[label] = {"stds": s, "mean": mean, "se": se, "EF": ef, "EF_se": ef_se,
                            "total_time_pi": total_time_pi(pulses)}
        results[name] = entry
    return results


def render(results: Dict[str, Dict], out_prefix: str,
           eval_delta_std: float = 1.0, title: str = "") -> Dict[str, str]:
    """Multi-panel figure ``{out_prefix}.png`` and markdown table
    ``{out_prefix}.md`` from :func:`gate_parity_curves`."""
    plt = _pyplot()

    Path(out_prefix).parent.mkdir(parents=True, exist_ok=True)

    n = len(results)
    fig, axes = plt.subplots(1, n, figsize=(3.2 * n, 3.4), sharey=True)
    axes = np.atleast_1d(axes)
    for ax, (gate, entry) in zip(axes, results.items()):
        for label, style in (("model", {"color": "C0"}),
                             ("SCORE", {"color": "C1", "ls": "--"})):
            e = entry[label]
            ax.plot(e["stds"], e["mean"], lw=1.5, label=label, **style)
            ax.fill_between(e["stds"], e["mean"] - e["se"], e["mean"] + e["se"], alpha=0.2,
                            color=style["color"])
        ax.set_title(gate)
        ax.set_xlabel(r"$\sigma_\delta$")
        ax.grid(alpha=0.3)
    axes[0].set_ylabel("E[F]")
    axes[0].legend()
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    fig_path = f"{out_prefix}.png"
    fig.savefig(fig_path, dpi=130, bbox_inches="tight")
    plt.close(fig)

    md_path = f"{out_prefix}.md"
    with open(md_path, "w") as f:
        f.write(f"# Model vs SCORE analytic baselines {title}\n\n")
        f.write(f"E[F] at σ_δ = {eval_delta_std:g} (ε_std 0.05), "
                "common random numbers; T in π units.\n\n")
        f.write("| gate | model E[F] | SCORE E[F] | model T | SCORE T |\n")
        f.write("|---|---:|---:|---:|---:|\n")
        for gate, entry in results.items():
            m, sc = entry["model"], entry["SCORE"]
            f.write(f"| {gate} | {m['EF']:.4f}±{m['EF_se']:.4f} "
                    f"| {sc['EF']:.4f}±{sc['EF_se']:.4f} "
                    f"| {m['total_time_pi']:.2f}π "
                    f"| {sc['total_time_pi']:.2f}π |\n")
    return {"figure": fig_path, "table": md_path}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="model-vs-SCORE robustness parity figure")
    p.add_argument("--variant", default=None, help="demo model variant (default: best shipped)")
    p.add_argument("--checkpoint", default=None, help="'dir:tag' or .npz")
    p.add_argument("--out", default="docs/model_vs_score")
    p.add_argument("--monte_carlo", type=int, default=10000)
    p.add_argument("--eval_delta_std", type=float, default=1.0)
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)

    from ..demo.app import default_variant
    variant = args.variant or default_variant()
    results = gate_parity_curves(variant, checkpoint=args.checkpoint,
                                 monte_carlo=args.monte_carlo,
                                 eval_delta_std=args.eval_delta_std, device=args.device)
    paths = render(results, args.out, eval_delta_std=args.eval_delta_std,
                   title=f"({variant})")
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
