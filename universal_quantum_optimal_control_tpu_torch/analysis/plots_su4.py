r"""Two-qubit robustness surfaces and sweeps (port of ``analysis/plots_su4.py``).

The two-qubit system has two off-resonance channels, so its robustness
surface is F(δ₁, δ₂) at fixed ε (:func:`fidelity_grid_su4`) and its sweep
E[F](σ_δ) draws both channels i.i.d. (:func:`fidelity_by_std_su4`).  Both
propagate through kernel B7 (:func:`..ops.propagate_su4.propagate_su4_mc_cuda`)
on CUDA, as one target with all samples on the Monte-Carlo axis, then take
the fidelity in PyTorch.  The figure (:func:`fidelity_contour_plot_su4`)
draws the grid with the single-qubit contour levels; it imports matplotlib
when called.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.su4 import TwoQubitSystem, fidelity_su4_ri
from ..ops.propagate_su4 import propagate_su4_mc_cuda
from ..utils.device import resolve_device
from .plots import CONTOUR_LEVELS, LINE_LEVELS, _pyplot

__all__ = ["fidelity_grid_su4", "fidelity_contour_plot_su4", "fidelity_by_std_su4"]


def _as_packed(u_target, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A complex ``(4, 4)`` or a packed ``(2, 4, 4)`` target → f32 (re, im)
    (split in numpy on the host)."""
    u = np.asarray(u_target.cpu() if isinstance(u_target, torch.Tensor) else u_target)
    if u.ndim == 3 and u.shape[0] == 2:
        re, im = u[0], u[1]
    else:
        re, im = u.real, u.imag
    return (torch.as_tensor(np.asarray(re, np.float32), device=device),
            torch.as_tensor(np.asarray(im, np.float32), device=device))


def _fidelities(pulses: torch.Tensor, tr: torch.Tensor, ti: torch.Tensor,
                d1: torch.Tensor, d2: torch.Tensor, eps: torch.Tensor,
                system: TwoQubitSystem) -> torch.Tensor:
    """F of one ``(L, P)`` pulse table on ``(N,)`` samples, through B7."""
    Ur, Ui = propagate_su4_mc_cuda(pulses[None].contiguous(), d1.reshape(1, -1),
                                   d2.reshape(1, -1), eps.reshape(1, -1), system)
    return fidelity_su4_ri(Ur[0], Ui[0], tr, ti)


def fidelity_grid_su4(pulses, u_target, system: TwoQubitSystem = TwoQubitSystem(),
                      delta_range: Tuple[float, float] = (-1.5, 1.5),
                      n_delta: int = 101, epsilon: float = 0.0,
                      device=None) -> Tuple[np.ndarray, np.ndarray]:
    """Deterministic F(δ₁, δ₂) surface at fixed ε: the grid ``(n_delta,)``
    and ``F[i, j] = F(δ₁ = grid[i], δ₂ = grid[j])``."""
    dev = resolve_device(device)
    tr, ti = _as_packed(u_target, dev)
    dg = torch.linspace(*delta_range, n_delta, dtype=torch.float32, device=dev)
    dd1, dd2 = torch.meshgrid(dg, dg, indexing="ij")
    p = torch.as_tensor(pulses, dtype=torch.float32, device=dev)
    with torch.no_grad():
        F = _fidelities(p, tr, ti, dd1, dd2, torch.full_like(dd1, float(epsilon)), system)
    return dg.cpu().numpy(), F.reshape(n_delta, n_delta).cpu().numpy()


def fidelity_contour_plot_su4(pulses, u_target, system: TwoQubitSystem = TwoQubitSystem(),
                              save_path: Optional[str] = None, title: str = "",
                              n_delta: int = 101, device=None):
    """Filled F(δ₁, δ₂) contours at ε = 0 (:func:`fidelity_grid_su4`)."""
    plt = _pyplot()

    dg, F = fidelity_grid_su4(pulses, u_target, system, n_delta=n_delta, device=device)
    fig, ax = plt.subplots(figsize=(6.5, 5.5))
    cs = ax.contourf(dg, dg, F.T, levels=[0.0] + CONTOUR_LEVELS, cmap="viridis")
    ax.contour(dg, dg, F.T, levels=LINE_LEVELS, colors="white", linewidths=0.8)
    fig.colorbar(cs, ax=ax, label="fidelity")
    ax.set_xlabel(r"$\delta_1$")
    ax.set_ylabel(r"$\delta_2$")
    ax.set_title(f"{title}  two-qubit fidelity surface")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig


def _sweep_draws(generator: torch.Generator, S: int, monte_carlo: int,
                 epsilon_std: float) -> Tuple[torch.Tensor, ...]:
    """Standard-normal δ draws ``n₁, n₂`` and ε draws, each ``(S, monte_carlo)``."""
    def draw():
        return torch.randn((S, monte_carlo), generator=generator, device=generator.device)
    n1 = draw()
    n2 = draw()
    return n1, n2, draw() * epsilon_std


def _sweep_su4(pulses, tr, ti, n1, n2, ne, stds, system: TwoQubitSystem):
    """Mean and standard error of F per σ in ``stds`` ``(S,)`` over the
    draws ``(S, M)`` scaled to δᵢ = σ·nᵢ."""
    F = _fidelities(pulses, tr, ti, n1 * stds[:, None], n2 * stds[:, None], ne,
                    system).reshape(stds.shape[0], -1)
    return F.mean(dim=1), F.std(dim=1, correction=0) / math.sqrt(F.shape[1])


def fidelity_by_std_su4(pulses, u_target, system: TwoQubitSystem = TwoQubitSystem(),
                        stds: Optional[Sequence[float]] = None,
                        epsilon_std: float = 0.05, monte_carlo: int = 2000,
                        generator: Optional[torch.Generator] = None,
                        device=None) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """``E[F](σ_δ)`` with i.i.d. per-qubit off-resonance draws: returns
    ``(stds, mean, se)``.  ``generator`` defaults to one seeded with 0 on
    ``device``; its draws differ from the JAX package's."""
    dev = resolve_device(device)
    stds_t = torch.as_tensor(np.arange(0.05, 1.5, 0.05) if stds is None else stds,
                             dtype=torch.float32, device=dev)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    n1, n2, ne = _sweep_draws(generator, stds_t.shape[0], monte_carlo, epsilon_std)
    tr, ti = _as_packed(u_target, dev)
    p = torch.as_tensor(pulses, dtype=torch.float32, device=dev)
    with torch.no_grad():
        mean, se = _sweep_su4(p, tr, ti, n1, n2, ne, stds_t, system)
    return stds_t.cpu().numpy(), mean.cpu().numpy(), se.cpu().numpy()
