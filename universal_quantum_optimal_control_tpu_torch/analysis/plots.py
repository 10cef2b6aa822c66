r"""Analysis plots: fidelity contours, fidelity-vs-σ sweeps, pulse parameters
(port of the JAX package's ``analysis/plots.py``).

The figures keep the JAX package's semantics: filled contour levels {0.8,
0.9, 0.95, 0.99, 0.999, 1.0} with white lines at {0.95, 0.99, 0.999}, the
E[F] ± SE of M = 10 000 draws in the title, the σ_δ sweep over
[0.01, 2.0) in steps of 0.01, and piecewise-linear robustness fits.

Every Monte-Carlo number goes through kernel B3
(:func:`..ops.propagate_su2.propagate_mc_cuda`) on CUDA, one launch each:
the F(δ, ε) grid (1000 × 50 samples), the estimate, and the whole sweep
(every σ on the Monte-Carlo axis: 199 × 10 000 samples, a 32 MB product,
where the JAX package maps over σ to fit a TPU's memory).  On CPU tensors
the kernel's plain version runs.  The numeric functions need no
matplotlib; the drawing functions import it when called.

Each of :func:`fidelity_grid`, :func:`fidelity_by_std` and
:func:`mc_fidelity_estimate` computes its numbers into one packed f32
vector on the device and brings it to the host in one download.  On a card,
with the default seed-0 draws and no other capture under way, that
computation is a CUDA graph for each key (the function, the sizes and
scalars that fix the graph's shapes and constants, the inputs' shapes,
inference mode and the card),
kept in :data:`_GRAPHS` (``ops/graphs.py``): the first call of a key runs
eagerly, the second captures, later calls copy the pulses and the target
(and the sweep's σ values) in and replay under the span
``plots.graph_replay``.  A graph draws from its card's generator in
:data:`_DRAWS`, set back to seed 0 before each run, so every call draws
the seed-0 stream that the eager call draws from a new generator, and the
numbers are the eager call's bit for bit.  Every other call (the CPU, a
caller's generator, inside another capture) runs eagerly.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import su2
from ..core.errors import sample_ore_ple
from ..ops.graphs import GraphCache
from ..ops.propagate_su2 import propagate_mc_cuda
from ..utils.device import resolve_device
from ..utils.tracing import span
from .fits import piecewise_linear_eval, segmented_linear_fit

__all__ = [
    "CONTOUR_LEVELS",
    "LINE_LEVELS",
    "mc_fidelity_estimate",
    "fidelity_grid",
    "fidelity_contour_plot",
    "fidelity_by_std",
    "plot_fidelity_by_std",
    "plot_pulse_param",
    "total_time_pi",
]

CONTOUR_LEVELS = [0.8, 0.9, 0.95, 0.99, 0.999, 1.0]
LINE_LEVELS = [0.95, 0.99, 0.999]

# the figures' CUDA graphs, and the generator each card's graphs draw from
_GRAPHS = GraphCache("plots.graph_replay")
_DRAWS: Dict[torch.device, torch.Generator] = {}


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _as_target_quat(u_target, device: torch.device) -> torch.Tensor:
    """A ``(2, 2)`` unitary or a ``(4,)`` quaternion → f32 quaternion."""
    u = torch.as_tensor(u_target, device=device)
    if u.dim() >= 2 and u.shape[-2:] == (2, 2):
        return su2.su2_to_quat(u.to(torch.complex64))
    return u.to(torch.float32)


def _as_pulses(pulses, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(pulses, dtype=torch.float32, device=device).contiguous()


def total_time_pi(pulses) -> float:
    """Total evolution time of ``(L, P)`` pulses in π units: the sum of τ,
    the last column at every P (``(φ, τ)``, ``(φ, Ω, τ)``, ``(φ, Ω, Δ, τ)``)."""
    return float(np.sum(np.asarray(pulses)[:, -1])) / math.pi


def _fidelities(pulses: torch.Tensor, q_target: torch.Tensor, delta: torch.Tensor,
                eps: torch.Tensor) -> torch.Tensor:
    """F of one ``(L, P)`` table on ``(N,)`` samples, one B3 launch."""
    q = propagate_mc_cuda(pulses[None], delta.reshape(1, -1).contiguous(),
                          eps.reshape(1, -1).contiguous())[0]
    return su2.quat_fidelity(q, q_target[None])


def _mean_se(F: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and standard error over the last axis."""
    return F.mean(dim=-1), F.std(dim=-1, correction=0) / math.sqrt(F.shape[-1])


def _mc_stats(pulses: torch.Tensor, q_target: torch.Tensor,
              delta: torch.Tensor, eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and standard error of F over ``(M,)`` explicit disorder draws."""
    return _mean_se(_fidelities(pulses, q_target, delta, eps))


def _on_card(dev: torch.device) -> bool:
    return dev.type == "cuda"


def _graphed(dev: torch.device, generator: Optional[torch.Generator]) -> bool:
    """Whether a figure's call on ``dev`` with ``generator`` takes its graph."""
    return (_on_card(dev) and generator is None
            and not torch.cuda.is_current_stream_capturing())


def _packed(key: tuple, inputs: Tuple[torch.Tensor, ...], body: Callable, dev: torch.device,
            generator: Optional[torch.Generator] = None, draws: bool = False) -> np.ndarray:
    """``body(generator, *inputs)``, one f32 vector, on the host.

    ``key`` holds the sizes and scalars ``body`` bakes in; ``draws`` says
    whether it draws from ``generator`` (``None``: a new one seeded with 0).
    Where :func:`_graphed`, ``body`` runs as its CUDA graph (see the
    module's docstring), else eagerly.
    """
    with torch.no_grad():
        if not _graphed(dev, generator):
            if draws and generator is None:
                generator = torch.Generator(device=dev).manual_seed(0)
            return body(generator, *inputs).cpu().numpy()
        card = inputs[0].device
        key += (tuple(t.shape for t in inputs), torch.is_inference_mode_enabled(), card)
        gen = _DRAWS.get(card)
        if gen is None:
            gen = _DRAWS.setdefault(card, torch.Generator(device=card))

        def run(*t):
            return body(gen, *t)

        if not draws:
            out = _GRAPHS(key, inputs, run, run)
        else:
            def seed0():
                return gen.manual_seed(0)
            out = _GRAPHS(key, inputs, lambda *t: body(seed0(), *t), run, seed0, (gen,))
    return out.cpu().numpy()


@span("plots.mc_fidelity_estimate")
def mc_fidelity_estimate(pulses, u_target, delta_std: float = 1.0,
                         epsilon_std: float = 0.05, monte_carlo: int = 10000,
                         generator: Optional[torch.Generator] = None,
                         device=None) -> Tuple[float, float]:
    """``E[F] ± SE`` of ``(L, P)`` pulses under gaussian disorder.

    ``generator`` defaults to one seeded with 0 on ``device``; its draws
    differ from the JAX package's, so compare the two by distribution or on
    explicit draws.
    """
    dev = resolve_device(device)

    def body(gen, p, q):
        delta, eps = sample_ore_ple(gen, (monte_carlo,), delta_std, epsilon_std)
        return torch.stack(_mc_stats(p, q, delta, eps))

    mean, se = _packed(("estimate", int(monte_carlo), float(delta_std), float(epsilon_std)),
                       (_as_pulses(pulses, dev), _as_target_quat(u_target, dev)), body, dev,
                       generator, draws=True)
    return float(mean), float(se)


def _grid_fid(pulses: torch.Tensor, q_target: torch.Tensor, delta_grid: torch.Tensor,
              eps_grid: torch.Tensor) -> torch.Tensor:
    """``F[i, j] = F(δ = delta_grid[i], ε = eps_grid[j])``, the whole grid on
    the Monte-Carlo axis of one B3 launch."""
    dd, ee = torch.meshgrid(delta_grid, eps_grid, indexing="ij")
    return _fidelities(pulses, q_target, dd, ee).reshape(dd.shape)


@span("plots.fidelity_grid")
def fidelity_grid(pulses, u_target,
                  delta_range: Tuple[float, float] = (-3.0, 3.0),
                  eps_range: Tuple[float, float] = (-0.15, 0.15),
                  n_delta: int = 1000, n_eps: int = 50, device=None):
    """Deterministic F(δ, ε) surface: ``(delta_grid, eps_grid, F)`` in numpy,
    ``F`` of shape ``(n_delta, n_eps)``."""
    dev = resolve_device(device)
    delta_range, eps_range = tuple(map(float, delta_range)), tuple(map(float, eps_range))
    n_delta, n_eps = int(n_delta), int(n_eps)

    def body(_, p, q):
        dg = torch.linspace(*delta_range, n_delta, dtype=torch.float32, device=p.device)
        eg = torch.linspace(*eps_range, n_eps, dtype=torch.float32, device=p.device)
        return torch.cat([dg, eg, _grid_fid(p, q, dg, eg).reshape(-1)])

    out = _packed(("grid", delta_range, eps_range, n_delta, n_eps),
                  (_as_pulses(pulses, dev), _as_target_quat(u_target, dev)), body, dev)
    return (out[:n_delta], out[n_delta:n_delta + n_eps],
            out[n_delta + n_eps:].reshape(n_delta, n_eps))


def fidelity_contour_plot(pulses, u_target, save_path: Optional[str] = None,
                          title: str = "", monte_carlo: int = 10000,
                          delta_std: float = 1.0, epsilon_std: float = 0.05,
                          generator: Optional[torch.Generator] = None, device=None):
    """Filled fidelity contours over the (δ, ε) grid with the MC-estimated
    E[F] ± SE and the total evolution time T (π units, from τ) in the
    title.  Returns ``(fig, (mean, se))``."""
    plt = _pyplot()

    dg, eg, F = fidelity_grid(pulses, u_target, device=device)
    mean, se = mc_fidelity_estimate(pulses, u_target, delta_std, epsilon_std,
                                    monte_carlo, generator=generator, device=device)
    total_time = total_time_pi(pulses)

    fig, ax = plt.subplots(figsize=(8, 5))
    cs = ax.contourf(dg, eg, F.T, levels=[0.0] + CONTOUR_LEVELS, cmap="viridis")
    ax.contour(dg, eg, F.T, levels=LINE_LEVELS, colors="white", linewidths=0.8)
    fig.colorbar(cs, ax=ax, label="fidelity")
    ax.set_xlabel(r"off-resonant error $\delta$")
    ax.set_ylabel(r"pulse-length error $\epsilon$")
    ax.set_title(f"{title}  E[F] = {mean:.4f} ± {se:.4f}, T = {total_time:.2f}π")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig, (mean, se)


def _sweep_fid(pulses: torch.Tensor, q_target: torch.Tensor, normals_d: torch.Tensor,
               normals_e: torch.Tensor, stds: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and SE of F per σ in ``stds`` ``(S,)``: δ = σ·``normals_d`` and
    ε = ``normals_e``, each ``(S, M)``, all S·M samples in one B3 launch."""
    F = _fidelities(pulses, q_target, normals_d * stds[:, None], normals_e)
    return _mean_se(F.reshape(stds.shape[0], -1))


def _sweep_draws(generator: torch.Generator, S: int, monte_carlo: int,
                 epsilon_std: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Standard-normal δ draws and ε draws of std ``epsilon_std``, each
    ``(S, monte_carlo)``."""
    dev = generator.device
    nd = torch.randn((S, monte_carlo), generator=generator, device=dev)
    ne = torch.randn((S, monte_carlo), generator=generator, device=dev) * epsilon_std
    return nd, ne


@span("plots.fidelity_by_std")
def fidelity_by_std(pulses, u_target, stds: Optional[Sequence[float]] = None,
                    epsilon_std: float = 0.05, monte_carlo: int = 10000,
                    generator: Optional[torch.Generator] = None, device=None):
    """``E[F](σ_δ)`` sweep over σ_δ ∈ [0.01, 2.0) in steps of 0.01 (or
    ``stds``), ε_std = 0.05, M = 10 000: returns ``(stds, mean, se)`` in
    numpy.  The draws are common to every σ, as in the JAX package;
    ``generator`` defaults to one seeded with 0 on ``device``."""
    dev = resolve_device(device)
    stds_t = torch.as_tensor(np.arange(0.01, 2.0, 0.01) if stds is None else stds,
                             dtype=torch.float32, device=dev)
    S = stds_t.shape[0]

    def body(gen, p, q, st):
        nd, ne = _sweep_draws(gen, S, monte_carlo, epsilon_std)
        return torch.cat([st, *_sweep_fid(p, q, nd, ne, st)])

    out = _packed(("sweep", int(monte_carlo), float(epsilon_std)),
                  (_as_pulses(pulses, dev), _as_target_quat(u_target, dev), stds_t), body, dev,
                  generator, draws=True)
    return out[:S], out[S:2 * S], out[2 * S:]


def plot_fidelity_by_std(pulses, u_target, save_prefix: Optional[str] = None,
                         title: str = "", monte_carlo: int = 10000,
                         epsilon_std: float = 0.05,
                         generator: Optional[torch.Generator] = None, device=None):
    """Robustness curve and fits: a 2-segment piecewise-linear fit of F(σ)
    and a 3-segment log-log fit of the infidelity.

    Saves ``{prefix}_fidelity.png`` and ``{prefix}_infidelity_with_fit.png``;
    returns ``((stds, mean, se), (fig1, fig2))``.
    """
    plt = _pyplot()

    stds, mean, se = fidelity_by_std(pulses, u_target, monte_carlo=monte_carlo,
                                     epsilon_std=epsilon_std, generator=generator,
                                     device=device)

    fig1, ax = plt.subplots(figsize=(7, 4.5))
    ax.plot(stds, mean, lw=1.5, label="E[F]")
    ax.fill_between(stds, mean - se, mean + se, alpha=0.3)
    coef, breaks, _ = segmented_linear_fit(stds, mean, n_segments=2)
    ax.plot(stds, piecewise_linear_eval(stds, coef, breaks), "--",
            label=f"2-seg fit (break at σ={breaks[0]:.2f})")
    ax.set_xlabel(r"$\sigma_\delta$")
    ax.set_ylabel("E[F]")
    ax.set_title(f"{title} fidelity vs disorder")
    ax.legend()
    fig1.tight_layout()

    infid = np.clip(1.0 - mean, 1e-8, None)
    lx, ly = np.log10(stds), np.log10(infid)
    coef3, breaks3, _ = segmented_linear_fit(lx, ly, n_segments=3, max_candidates=40)
    fig2, ax2 = plt.subplots(figsize=(7, 4.5))
    ax2.loglog(stds, infid, lw=1.5, label="1 − E[F]")
    ax2.loglog(stds, 10 ** piecewise_linear_eval(lx, coef3, breaks3), "--",
               label="3-seg log-log fit")
    ax2.set_xlabel(r"$\sigma_\delta$")
    ax2.set_ylabel("infidelity")
    ax2.set_title(f"{title} infidelity (log-log)")
    ax2.legend()
    fig2.tight_layout()

    if save_prefix is not None:
        fig1.savefig(f"{save_prefix}_fidelity.png", dpi=120)
        fig2.savefig(f"{save_prefix}_infidelity_with_fit.png", dpi=120)
        plt.close(fig1)
        plt.close(fig2)
    return (stds, mean, se), (fig1, fig2)


def plot_pulse_param(pulses, save_path: Optional[str] = None, title: str = ""):
    """Histogram of the pulse durations and a step plot of φ over the
    cumulative rotation time in π units (φ first, τ last at every P)."""
    plt = _pyplot()

    p = np.asarray(pulses)
    phi, tau = p[:, 0], p[:, -1]
    t_cum = np.concatenate([[0.0], np.cumsum(tau)]) / math.pi

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 4))
    ax1.hist(tau, bins=30)
    ax1.set_xlabel(r"pulse duration $\tau$")
    ax1.set_ylabel("count")
    ax1.set_title(f"{title} durations")
    ax2.step(t_cum, np.concatenate([phi, phi[-1:]]), where="post")
    ax2.set_xlabel(r"cumulative time ($\pi$ units)")
    ax2.set_ylabel(r"$\phi$")
    ax2.set_title(f"{title} phase schedule")
    fig.tight_layout()
    if save_path is not None:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
    return fig
