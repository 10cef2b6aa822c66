r"""Side-by-side robustness comparison of pulse strategies (port of the JAX
package's ``analysis/compare.py``).

Evaluates named pulse tables against one target on a common disorder sweep:
every strategy sees the same draws (the generator is rewound to one state
before each sweep and each estimate, as the JAX package reuses one key),
through kernel B3 on CUDA.  Draws the combined figure only where a
``save_path`` is given.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..utils.device import resolve_device
from .plots import _pyplot, fidelity_by_std, mc_fidelity_estimate, total_time_pi

__all__ = ["compare_pulse_strategies"]


def compare_pulse_strategies(
    strategies: Dict[str, np.ndarray],
    u_target,
    stds: Optional[Sequence[float]] = None,
    epsilon_std: float = 0.05,
    monte_carlo: int = 10000,
    eval_delta_std: float = 1.0,
    save_path: Optional[str] = None,
    generator: Optional[torch.Generator] = None,
    title: str = "",
    device=None,
):
    """Compare pulse tables on E[F](σ_δ) curves and a summary.

    Args:
      strategies: name → pulses ``(L, P)``.
      u_target: target unitary (complex 2×2) or quaternion.
      generator: the draws' source, rewound before each use (default: one
        seeded with 0 on ``device``).
    Returns:
      ``(summary, fig)``: summary is name → dict(EF at ``eval_delta_std``,
      its SE, total time in π units (τ, the last column), the curve arrays);
      fig is None without ``save_path``.
    """
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    start = generator.get_state()

    def rewound():
        generator.set_state(start)
        return generator

    summary = {}
    for name, pulses in strategies.items():
        s, mean, se = fidelity_by_std(pulses, u_target, stds=stds, epsilon_std=epsilon_std,
                                      monte_carlo=monte_carlo, generator=rewound(),
                                      device=dev)
        ef, ef_se = mc_fidelity_estimate(pulses, u_target, delta_std=eval_delta_std,
                                         epsilon_std=epsilon_std, monte_carlo=monte_carlo,
                                         generator=rewound(), device=dev)
        summary[name] = {"EF": ef, "EF_se": ef_se, "total_time_pi": total_time_pi(pulses),
                         "stds": s, "mean": mean, "se": se}

    fig = None
    if save_path is not None:
        plt = _pyplot()
        fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4.5))
        for name, v in summary.items():
            s, mean, se = v["stds"], v["mean"], v["se"]
            ax1.plot(s, mean, lw=1.5, label=name)
            ax1.fill_between(s, mean - se, mean + se, alpha=0.2)
            ax2.loglog(s, np.clip(1 - mean, 1e-8, None), lw=1.5, label=name)
        ax1.set_xlabel(r"$\sigma_\delta$")
        ax1.set_ylabel("E[F]")
        ax1.set_title(f"{title} robustness")
        ax1.legend()
        ax2.set_xlabel(r"$\sigma_\delta$")
        ax2.set_ylabel("infidelity")
        ax2.set_title(f"{title} infidelity (log-log)")
        ax2.legend()
        lines = [f"{n}: E[F]@σ={eval_delta_std:g} = {v['EF']:.4f}±{v['EF_se']:.4f}, "
                 f"T = {v['total_time_pi']:.2f}π" for n, v in summary.items()]
        fig.suptitle("\n".join(lines), fontsize=8, y=1.08)
        fig.tight_layout()
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return summary, fig
