r"""Multi-start GRAPE for two-qubit gates (port of
``optimizers/two_qubit_grape.py``).

Block-structured GRAPE for entangling gates on the cross-talk + always-on-ZZ
system: the ``blocks`` mode alternates ``[drive(φⱼ, areaⱼ, Ω = Ω_max);
free(tⱼ)]`` segments (2·n_blocks pulses), which holds the echo/ZZ schedules
a CZ needs; ``table`` is a plain per-segment table.  All starts advance in
lockstep as the batch axis of the SU(4) propagator; disorder robustness is
trained by continuing on the Monte-Carlo expected fidelity over a σ
curriculum (fresh Adam moments per stage).

The gradients are autograd through the port's eager ``core/su4.py``
(``propagate_su4``, ``propagate_su4_mc``, ``fidelity_su4_ri``): the JAX
package differentiates its XLA path here, not a Pallas kernel, so this is
the port of XLA code, not a plain version standing in for a kernel.

Differences from the JAX package: a ``torch.Generator`` takes the place of
the PRNG key (initial parameters, then each MC step's draws, from one
generator), the device is explicit, and the final MC evaluation of each σ
stage draws from a generator seeded with :data:`EVAL_SEED` on that device
(the JAX package uses ``PRNGKey(123)``; the two give different numbers).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import su4
from ..utils.device import resolve_device

__all__ = ["TwoQubitGrapeConfig", "named_two_qubit_targets", "multistart_grape_su4",
           "exact_fids", "mc_fids", "step_exact", "step_mc", "EVAL_SEED"]

# seed of the generator behind each σ stage's final MC evaluation
EVAL_SEED = 123


@dataclasses.dataclass(frozen=True)
class TwoQubitGrapeConfig:
    mode: str = "blocks"          # "blocks" | "table"
    n_blocks: int = 10            # blocks mode: 2*n_blocks pulse segments
    num_pulses: int = 100         # table mode: segments
    n_starts: int = 24
    steps: int = 3000             # per curriculum stage
    learning_rate: float = 0.02
    omega_max: float = 2.0
    tau_max: float = 0.5          # table mode segment duration cap
    tfree_max: float = 8.0        # blocks mode free-evolution cap
    area_max: float = 4.0 * np.pi  # blocks mode drive-area cap (q1 angle)
    monte_carlo: int = 128        # disorder stages
    sigmas: Sequence[float] = ()  # disorder curriculum, e.g. (0.1, 0.2)
    epsilon_std: float = 0.05
    seed: int = 0
    xtalk: float = 0.1
    coupling: float = 0.5
    drive2: bool = False          # direct drive on qubit 2 (4-param pulses)


def named_two_qubit_targets() -> Dict[str, np.ndarray]:
    """The five named two-qubit gates (complex64 4×4), in the JAX package's
    order: CZ, ZZ(π/4), CNOT, iSWAP, √SWAP."""
    cz = np.diag([1, 1, 1, -1]).astype(np.complex64)
    zz = np.diag(np.exp(-1j * np.pi / 4 * np.array([1, -1, -1, 1]))).astype(np.complex64)
    cnot = np.array([[1, 0, 0, 0], [0, 1, 0, 0],
                     [0, 0, 0, 1], [0, 0, 1, 0]], np.complex64)
    iswap = np.array([[1, 0, 0, 0], [0, 0, 1j, 0],
                      [0, 1j, 0, 0], [0, 0, 0, 1]], np.complex64)
    sqrt_swap = np.array([[1, 0, 0, 0],
                          [0, 0.5 + 0.5j, 0.5 - 0.5j, 0],
                          [0, 0.5 - 0.5j, 0.5 + 0.5j, 0],
                          [0, 0, 0, 1]], np.complex64)
    return {"cz": cz, "zz(pi/4)": zz, "cnot": cnot, "iswap": iswap,
            "sqrt_swap": sqrt_swap}


def _init_raw(cfg: TwoQubitGrapeConfig, generator: torch.Generator) -> torch.Tensor:
    """``(n_starts, n, nchan)`` standard normals on the generator's device,
    one channel after another, scaled 1 (the phases) and 0.5 (the last two)."""
    n = cfg.n_blocks if cfg.mode == "blocks" else cfg.num_pulses
    nchan = 4 if cfg.drive2 else 3
    scale = [1.0] + [1.0] * (nchan - 3) + [0.5, 0.5]
    return torch.stack([torch.randn((cfg.n_starts, n), generator=generator,
                                    device=generator.device) * s for s in scale], -1)


def _to_pulses(raw: torch.Tensor, cfg: TwoQubitGrapeConfig) -> torch.Tensor:
    """Raw parameters → physical pulse tables: ``(S, L, 3)`` ``(φ, Ω, τ)``,
    or ``(S, L, 4)`` ``(φ₁, φ₂, Ω, τ)`` in ``drive2`` mode."""
    phi = math.pi * torch.tanh(raw[..., 0])
    if cfg.mode == "blocks":
        area = cfg.area_max * torch.sigmoid(raw[..., -2])
        tfree = cfg.tfree_max * torch.sigmoid(raw[..., -1])
        om_d = torch.full_like(phi, cfg.omega_max)
        tau_d = area / cfg.omega_max           # q1 rotation angle = Ω·τ
        zero = torch.zeros_like(phi)
        if cfg.drive2:
            phi2 = math.pi * torch.tanh(raw[..., 1])
            drive = torch.stack([phi, phi2, om_d, tau_d], -1)
            free = torch.stack([zero, zero, zero, tfree], -1)
        else:
            drive = torch.stack([phi, om_d, tau_d], -1)
            free = torch.stack([zero, zero, tfree], -1)
        return torch.stack([drive, free], 2).reshape(raw.shape[0], -1, raw.shape[-1])
    om = cfg.omega_max * torch.sigmoid(raw[..., -2])
    tau = 0.05 + (cfg.tau_max - 0.05) * torch.sigmoid(raw[..., -1])
    if cfg.drive2:
        phi2 = math.pi * torch.tanh(raw[..., 1])
        return torch.stack([phi, phi2, om, tau], -1)
    return torch.stack([phi, om, tau], -1)


def _system(cfg: TwoQubitGrapeConfig) -> su4.TwoQubitSystem:
    return su4.TwoQubitSystem(xtalk=cfg.xtalk, coupling=cfg.coupling, drive2=cfg.drive2)


def exact_fids(raw: torch.Tensor, cfg: TwoQubitGrapeConfig,
               target: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """``(S,)`` fidelity of each start without disorder."""
    pulses = _to_pulses(raw, cfg)
    z = torch.zeros(pulses.shape[:1], dtype=pulses.dtype, device=pulses.device)
    Ur, Ui = su4.propagate_su4(pulses, z, z, z, _system(cfg))
    return su4.fidelity_su4_ri(Ur, Ui, *target)


def mc_fids(raw: torch.Tensor, cfg: TwoQubitGrapeConfig,
            target: Tuple[torch.Tensor, torch.Tensor],
            draws: Tuple[torch.Tensor, torch.Tensor, torch.Tensor],
            sigma: float) -> torch.Tensor:
    """``(S,)`` E[F] of each start over standard-normal ``draws`` ``(n₁, n₂,
    n_ε)``, each ``(S, M)``: δᵢ = σ·nᵢ, ε = ε_std·n_ε."""
    n1, n2, ne = draws
    Ur, Ui = su4.propagate_su4_mc(_to_pulses(raw, cfg), n1 * sigma, n2 * sigma,
                                  ne * cfg.epsilon_std, _system(cfg))
    return torch.mean(su4.fidelity_su4_ri(Ur, Ui, target[0][None, None],
                                          target[1][None, None]), dim=1)


def _adam_step(raw: torch.Tensor, opt: torch.optim.Optimizer, fids: torch.Tensor) -> float:
    """One Adam step on −mean(fids); returns the mean before the step."""
    opt.zero_grad(set_to_none=True)
    loss = -torch.mean(fids)
    loss.backward()
    opt.step()
    return -float(loss.detach())


def step_exact(raw: torch.Tensor, opt: torch.optim.Optimizer, cfg: TwoQubitGrapeConfig,
               target: Tuple[torch.Tensor, torch.Tensor]) -> float:
    """One exact-stage step: Adam on −mean F over the starts, updating the
    leaf ``raw`` in place; returns the mean F before the update."""
    return _adam_step(raw, opt, exact_fids(raw, cfg, target))


def step_mc(raw: torch.Tensor, opt: torch.optim.Optimizer, cfg: TwoQubitGrapeConfig,
            target: Tuple[torch.Tensor, torch.Tensor],
            draws: Tuple[torch.Tensor, torch.Tensor, torch.Tensor], sigma: float) -> float:
    """One MC-stage step on the given standard-normal draws (see
    :func:`mc_fids`); returns the mean E[F] before the update."""
    return _adam_step(raw, opt, mc_fids(raw, cfg, target, draws, sigma))


def _draws(generator: torch.Generator, S: int, M: int) -> Tuple[torch.Tensor, ...]:
    """Standard normals ``(n₁, n₂, n_ε)``, each ``(S, M)``, in that order."""
    return tuple(torch.randn((S, M), generator=generator, device=generator.device)
                 for _ in range(3))


def _adam(raw: torch.Tensor, cfg: TwoQubitGrapeConfig) -> torch.optim.Adam:
    return torch.optim.Adam([raw], lr=cfg.learning_rate, betas=(0.9, 0.999), eps=1e-8)


def multistart_grape_su4(u_target: np.ndarray,
                         config: TwoQubitGrapeConfig = TwoQubitGrapeConfig(),
                         generator: Optional[torch.Generator] = None, device=None,
                         verbose: bool = False) -> Tuple[np.ndarray, Dict]:
    """Batched multi-start gradient search for a two-qubit gate.

    Stage 0 optimizes the exact (σ = 0) fidelity from ``n_starts`` random
    initializations in lockstep; each ``sigmas`` entry continues on the
    Monte-Carlo expected fidelity at that disorder level (common draws
    across starts, fresh each step).  ``generator`` defaults to one seeded
    with ``config.seed`` on ``device`` (default cuda).

    Returns ``(best_pulses (L, P), info)`` with per-stage best fidelities.
    """
    cfg = config
    dev = resolve_device(device) if generator is None else generator.device
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(cfg.seed)
    raw = _init_raw(cfg, generator).requires_grad_(True)
    S = cfg.n_starts
    Ut = np.asarray(u_target, np.complex64)
    target = (torch.as_tensor(Ut.real, device=dev), torch.as_tensor(Ut.imag, device=dev))

    info: Dict = {"stages": []}
    for sigma in [None] + list(cfg.sigmas):   # None = exact stage
        opt = _adam(raw, cfg)                  # fresh moments per stage
        for i in range(cfg.steps):
            if sigma is None:
                f = step_exact(raw, opt, cfg, target)
            else:
                f = step_mc(raw, opt, cfg, target, _draws(generator, S, cfg.monte_carlo),
                            float(sigma))
            if verbose and (i + 1) % max(cfg.steps // 10, 1) == 0:
                print(f"stage σ={sigma}: step {i+1} mean F={f:.5f}", flush=True)
        with torch.no_grad():
            if sigma is None:
                fids = exact_fids(raw, cfg, target)
            else:
                eval_gen = torch.Generator(device=dev).manual_seed(EVAL_SEED)
                fids = mc_fids(raw, cfg, target, _draws(eval_gen, S, cfg.monte_carlo),
                               float(sigma))
        info["stages"].append({
            "sigma": sigma, "best_fid": float(torch.max(fids)),
            "mean_fid": float(torch.mean(fids)), "best_start": int(torch.argmax(fids)),
        })

    best = info["stages"][-1]["best_start"]
    with torch.no_grad():
        best_pulses = _to_pulses(raw, cfg)[best].cpu().numpy()
        info["exact_fid_of_best"] = float(exact_fids(raw, cfg, target)[best])
    return best_pulses, info
