r"""First-order Magnus / filter-function bound for two-qubit δ₂ dephasing,
the numeric half (port of ``analysis/dephasing_bound.py``).

On the cross-talk-only system the δ₂ error term ``½δ₂Z₂`` commutes with
everything but the χ-scaled cross-talk drive, so its toggling-frame axis
turns at most at rate ``χΩ̄`` and no pulse of duration T refocuses δ₂
below the effective time ``T_eff = sin(χΩ̄T)/(χΩ̄)``.  Unrefocused
dephasing ``exp(−i·θ/2·Z₂)``, θ = δ₂·T_eff, δ₂ ~ N(0, σ²), has

    E[F](σ) = (3 + 2·exp(−σ²·T_eff²/2)) / 5 .                       (*)

(the JAX module's docstring has the derivation).  :func:`measure` holds
shipped pulse tables against (*); :func:`measure_channels` splits the
drive2 system's loss by channel (δ₁, δ₂, ε), where the bound is vacuous.

The E[F] calls go through ``SU4System`` on ``backend="pallas"`` (kernel B6)
by default, where the JAX package jits its XLA path.  The draws come from
a ``torch.Generator`` seeded with ``seed`` (or are given as ``draws``), so
they differ from the JAX package's.  The CLI prints the tables as text.
"""

from __future__ import annotations

import argparse
from pathlib import Path
from typing import Optional, Tuple

import numpy as np
import torch

from ..training.systems import SU4System
from ..utils import resolve_device

__all__ = ["dephasing_bound", "effective_time", "rotation_budget", "measure",
           "measure_channels", "main"]

_WEIGHTS = (Path(__file__).resolve().parent.parent.parent
            / "universal_quantum_optimal_control_tpu" / "demo" / "weights")


def effective_time(T, chi: float, omega_bar: float = 1.0):
    """Minimal effective dephasing time: ``sin(χΩ̄T)/(χΩ̄)`` for
    ``χΩ̄T ≤ π/2`` (monotone branch), clamped to its maximum beyond."""
    x = chi * omega_bar
    return np.sin(np.minimum(np.asarray(T) * x, 0.5 * np.pi)) / x


def dephasing_bound(sigma, T_eff):
    """(*) — expected entanglement fidelity of unrefocused δ₂ dephasing."""
    s = np.asarray(sigma, np.float64)
    return (3.0 + 2.0 * np.exp(-0.5 * s * s * np.asarray(T_eff) ** 2)) / 5.0


def rotation_budget(T, rate: float):
    """Total toggling-frame rotation budget ``rate·T`` (radians) available
    to refocus a Z-dephasing channel whose frame axis turns at rate ≤
    ``rate``.  (*) binds only while ``rate·T ≤ π/2``: on the χ-only system
    δ₂'s rate is ``χΩ̄``, on ``drive2`` ``(1+χ)Ω̄``, where it is vacuous."""
    return float(rate) * np.asarray(T, np.float64)


def _model_pulses(checkpoint: str, n_targets: int, seed: int, drive2: bool = False,
                  kak_tokens: bool = False, omega_min: float = 0.0, max_pulses: int = 100,
                  device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The model's pulses on ``n_targets`` targets from the training CLI's
    ``build_targets`` (products, or mixed on drive2) with ``seed``."""
    from ..workloads.two_qubit import build_targets
    from ..workloads.two_qubit_eval import model_gate_pulses

    system = SU4System(drive2=drive2)
    targets = build_targets(seed, n_targets, system.system,
                            mode="mixed" if drive2 else "products").to(resolve_device(device))
    pulses = model_gate_pulses(checkpoint, targets, drive2=drive2, kak_tokens=kak_tokens,
                               omega_min=omega_min, max_pulses=max_pulses)
    return pulses, targets


def _normals(pulses: torch.Tensor, monte_carlo: int, seed: int, draws):
    """Standard normals ``(n₁, n₂, n_ε)``, each ``(B, monte_carlo)``."""
    if draws is not None:
        return draws
    gen = torch.Generator(device=pulses.device).manual_seed(seed)
    return tuple(torch.randn((pulses.shape[0], monte_carlo), generator=gen,
                             device=pulses.device) for _ in range(3))


def _mean_fid(system: SU4System):
    def f(pulses, targets, d1, d2, ep) -> float:
        with torch.no_grad():
            return float(torch.mean(system.local_mean_fidelity(pulses, targets, (d1, d2, ep))))
    return f


def measure(pulses: torch.Tensor, targets: torch.Tensor, sigmas, *, monte_carlo: int = 20_000,
            epsilon_std: float = 0.05, seed: int = 11, system: Optional[SU4System] = None,
            draws=None):
    """Rows of (σ, measured δ₂-only E[F], bound, full E[F], F₀·bound), with
    F₀ the δ₁/ε-only E[F]; then the mean T, T_eff and Ω̄.  ``system``
    defaults to the χ-only ``SU4System(backend="pallas")``."""
    system = system or SU4System(backend="pallas")
    n1, n2, ne = _normals(pulses, monte_carlo, seed, draws)
    zero = torch.zeros_like(n1)
    T = pulses[..., -1].sum(-1).cpu().numpy()
    omega_bar = (float(torch.clamp(pulses[..., 1], min=0.0).mean())
                 if pulses.shape[-1] == 3 else 1.0)
    T_eff = effective_time(T.mean(), system.system.xtalk, omega_bar)
    fid = _mean_fid(system)
    rows = []
    for s in sigmas:
        f_d2 = fid(pulses, targets, zero, n2 * s, zero)
        f_full = fid(pulses, targets, n1 * s, n2 * s, ne * epsilon_std)
        f0 = fid(pulses, targets, n1 * s, zero, ne * epsilon_std)
        bound = float(dephasing_bound(s, T_eff))
        rows.append((s, f_d2, bound, f_full, f0 * bound))
    return rows, T.mean(), T_eff, omega_bar


def measure_channels(pulses: torch.Tensor, targets: torch.Tensor, sigmas, *,
                     system: Optional[SU4System] = None, monte_carlo: int = 20_000,
                     epsilon_std: float = 0.05, seed: int = 11, draws=None):
    """Per-channel loss decomposition for the drive2 system: rows of (σ,
    E[F] δ₁ only, δ₂ only, ε only, full, product of the three); then the
    mean T and Ω̄.  ``system`` defaults to ``SU4System(drive2=True,
    backend="pallas")``."""
    system = system or SU4System(drive2=True, backend="pallas")
    n1, n2, ne = _normals(pulses, monte_carlo, seed, draws)
    ne = ne * epsilon_std
    zero = torch.zeros_like(n1)
    T = pulses[..., -1].sum(-1).cpu().numpy()
    P = pulses.shape[-1]
    omega_bar = float(torch.clamp(pulses[..., P - 2], min=0.0).mean()) if P >= 3 else 1.0
    fid = _mean_fid(system)
    f_eps = fid(pulses, targets, zero, zero, ne)
    rows = []
    for s in sigmas:
        f_d1 = fid(pulses, targets, n1 * s, zero, zero)
        f_d2 = fid(pulses, targets, zero, n2 * s, zero)
        f_full = fid(pulses, targets, n1 * s, n2 * s, ne)
        rows.append((s, f_d1, f_d2, f_eps, f_full, f_d1 * f_d2 * f_eps))
    return rows, T.mean(), omega_bar


def _render_channels(name, rows, T, omega_bar, chi) -> str:
    budget = rotation_budget(T, (1.0 + chi) * omega_bar)
    if budget > 0.5 * np.pi:
        status = (f"First-order Magnus bound status: **vacuous** — the δ "
                  f"toggling frames can traverse (1+χ)Ω̄T = {budget:.1f} rad "
                  f"(> π/2), so full first-order refocusing of either δ "
                  f"channel is geometrically unobstructed; the ceiling is "
                  f"empirical (single-target GRAPE).")
    else:
        status = (f"First-order Magnus bound status: **binding** "
                  f"(budget {budget:.2f} rad ≤ π/2).")
    out = [f"### {name}  (drive2; mean T = {T:.2f}, Ω̄ = {omega_bar:.2f})",
           "", status, "",
           "| σ_δ | E[F] δ₁ only | δ₂ only | ε only | full | f₁·f₂·f_ε |",
           "|---|---:|---:|---:|---:|---:|"]
    for s, f1, f2, fe, ff, fp in rows:
        out.append(f"| {s:g} | {f1:.4f} | {f2:.4f} | {fe:.4f} | {ff:.4f} | {fp:.4f} |")
    return "\n".join(out)


def _render(name, rows, T, T_eff, omega_bar) -> str:
    out = [f"### {name}  (mean T = {T:.2f}, Ω̄ = {omega_bar:.2f}, T_eff = {T_eff:.2f})", "",
           "| σ_δ | E[F] δ₂ only | bound (*) | E[F] full | F₀·bound |",
           "|---|---:|---:|---:|---:|"]
    for s, f2, b, ff, fb in rows:
        out.append(f"| {s:g} | {f2:.4f} | {b:.4f} | {ff:.4f} | {fb:.4f} |")
    return "\n".join(out)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Magnus/filter-function δ₂ dephasing bound vs shipped two-qubit artifacts")
    p.add_argument("--checkpoint", default=str(_WEIGHTS / "two_qubit_d2_kak.npz"),
                   help="universal two-qubit model artifact (.npz); the default is "
                        "the drive2+KAK flagship")
    p.add_argument("--max_pulses", type=int, default=100,
                   help="checkpoint pulse-sequence length (the shipped flagship is L=100)")
    p.add_argument("--cz", default=str(_WEIGHTS / "cz_robust_pulse.npz"),
                   help="cross-talk-only GRAPE pulse for the binding bound section")
    p.add_argument("--drive2", action=argparse.BooleanOptionalAction, default=True,
                   help="treat --checkpoint as a drive2+kak_tokens model and emit the "
                        "channel decomposition; --no-drive2 runs the cross-talk-only "
                        "bound comparison instead")
    p.add_argument("--omega_min", type=float, default=0.05)
    p.add_argument("--sigmas", default="0.05,0.1,0.2,0.4")
    p.add_argument("--n_targets", type=int, default=32)
    p.add_argument("--monte_carlo", type=int, default=20_000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back by itself")
    return p


def _pulse_npz(path, device):
    with np.load(path) as z:
        pulses = torch.as_tensor(z["pulses"], dtype=torch.float32, device=device)[None]
        targets = SU4System.pack_target(np.asarray(z["u_target"])[None]).to(device)
    return pulses.contiguous(), targets


def main(argv=None) -> str:
    """Run the CLI; returns the text it prints."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    sigmas = [float(s) for s in args.sigmas.split(",")]
    sections = ["# δ₂ dephasing bound vs measurement", "",
                "Formula (*): E[F] = (3 + 2·exp(−σ²T_eff²/2))/5 with "
                "T_eff = sin(χΩ̄T)/(χΩ̄) — see `analysis/dephasing_bound.py` "
                "for the derivation.", ""]
    chi_only = SU4System(backend="pallas")
    drive2 = SU4System(drive2=True, backend="pallas")

    if Path(args.checkpoint).exists():
        if args.drive2:
            pulses, targets = _model_pulses(args.checkpoint, args.n_targets, args.seed,
                                            drive2=True, kak_tokens=True,
                                            omega_min=args.omega_min,
                                            max_pulses=args.max_pulses, device=dev)
            rows, T, ob = measure_channels(pulses, targets, sigmas, system=drive2,
                                           monte_carlo=args.monte_carlo)
            sections.append(_render_channels(
                f"universal model `{Path(args.checkpoint).name}` "
                f"({args.n_targets} mixed targets)", rows, T, ob, drive2.system.xtalk))
        else:
            pulses, targets = _model_pulses(args.checkpoint, args.n_targets, args.seed,
                                            max_pulses=args.max_pulses, device=dev)
            rows, T, T_eff, ob = measure(pulses, targets, sigmas,
                                         monte_carlo=args.monte_carlo, system=chi_only)
            sections.append(_render(
                f"universal model `{Path(args.checkpoint).name}` "
                f"({args.n_targets} random targets)", rows, T, T_eff, ob))
        sections.append("")

    if Path(args.cz).exists():
        pulses, targets = _pulse_npz(args.cz, dev)
        rows, T, T_eff, ob = measure(pulses, targets, sigmas, monte_carlo=args.monte_carlo,
                                     system=chi_only)
        sections.append(_render(f"CZ GRAPE pulse `{Path(args.cz).name}`", rows, T, T_eff, ob))
        sections.append("")

    cz_d2 = _WEIGHTS / "cz_drive2_pulse.npz"
    if args.drive2 and cz_d2.exists():
        pulses, targets = _pulse_npz(cz_d2, dev)
        rows, T, ob = measure_channels(pulses, targets, sigmas, system=drive2,
                                       monte_carlo=args.monte_carlo)
        sections.append(_render_channels(f"CZ drive2 GRAPE pulse `{cz_d2.name}`", rows, T,
                                         ob, drive2.system.xtalk))

    text = "\n".join(sections)
    print(text)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    return text


if __name__ == "__main__":
    main()
