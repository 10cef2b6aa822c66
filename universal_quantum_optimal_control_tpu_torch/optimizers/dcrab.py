r"""dCRAB — dressed Chopped RAndom Basis optimization (PyTorch port of
``optimizers/dcrab.py``).

A Fourier-parameterized phase control ``φ(t) = φ₀ + Σₙ aₙ cos(ωₙt) +
bₙ sin(ωₙt)`` on random frequencies, optimized per restart round:

* the synthesis is one ``(1 × N) @ (N × T)`` product per round,
* propagation is a quaternion loop over the T = T/dt time steps for all
  disorder samples at once,
* the objective is the unsquared trace fidelity ``(|Tr| + 2)/6`` (a
  reference quirk: its maximum is 2/3).

Two optimization modes, all restart rounds batched: **gradient**
(:func:`optimize_dcrab_grad`, Adam through autograd) and
**derivative-free** (:func:`optimize_dcrab_nm`, a batched Nelder–Mead, or
SciPy's per round).  The JAX package computes all of this in XLA, outside
any Pallas kernel, so it stays plain PyTorch here.

Randomness: :func:`_setup` draws the disorder, the frequencies and the
initial amplitudes from a CPU ``torch.Generator`` (seeded with
``config.seed`` unless one is passed) and moves them to the device, so a
seed gives the same problem on any device; the draws differ from JAX's.
:func:`run_adam` and :func:`_nelder_mead_batched` take the problem and the
objective as given, so tests can pass the JAX package's inputs in.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.su2 import quat_trace_inner, segment_quat, su2_to_quat
from ..utils.device import resolve_device

__all__ = ["DcrabConfig", "DcrabProblem", "build_phi", "propagate_phase_control",
           "average_infidelity", "run_adam", "optimize_dcrab_grad", "optimize_dcrab_nm",
           "dcrab_optimize"]

DELTA_STD = 0.4    # reference dCRAB.py:6
EPSILON_STD = 0.05  # reference dCRAB.py:7


@dataclasses.dataclass(frozen=True)
class DcrabConfig:
    T: float = 6.0
    dt: float = 0.01
    n_modes: int = 12
    rounds: int = 5
    samples: int = 100
    w_min: float = 0.0
    w_max: float = 10.0
    delta_std: float = DELTA_STD
    epsilon_std: float = EPSILON_STD
    seed: int = 0


class DcrabProblem(NamedTuple):
    """One dCRAB problem: the time grid ``t (T,)``, the disorder ``delta``
    and ``eps (S,)``, the rounds' frequencies ``omegas (R, N)``, their
    initial parameters ``x0 (R, 1 + 2N)`` and the target quaternion
    ``q_target (4,)``."""

    t: torch.Tensor
    delta: torch.Tensor
    eps: torch.Tensor
    omegas: torch.Tensor
    x0: torch.Tensor
    q_target: torch.Tensor


def build_phi(params: torch.Tensor, t: torch.Tensor, omegas: torch.Tensor) -> torch.Tensor:
    """Fourier synthesis ``φ(t)`` (reference dCRAB.py:26-34) as one product.

    params: ``(..., 1 + 2N)`` = ``[φ₀, a₁..a_N, b₁..b_N]``; t: ``(T,)``;
    omegas: ``(..., N)`` → φ: ``(..., T)``.
    """
    N = omegas.shape[-1]
    phi0 = params[..., :1]
    a = params[..., 1:1 + N]
    b = params[..., 1 + N:1 + 2 * N]
    wt = omegas[..., :, None] * t  # (..., N, T)
    # An f32 product: TF32 stays off (torch's default; the port never turns
    # allow_tf32 on).  The JAX package pins HIGHEST here for the same
    # reason: inputs rounded to 10 mantissa bits cost ~1e-2 rad of phase at
    # N = 2000 modes.
    synth = (torch.matmul(a[..., None, :], torch.cos(wt))
             + torch.matmul(b[..., None, :], torch.sin(wt)))
    return phi0 + synth[..., 0, :]


def _left_matrix(q: torch.Tensor) -> torch.Tensor:
    """``(..., 4)`` quaternions → ``(..., 4, 4)`` matrices ``L(q)`` with
    ``L(q) p = q ⊗ p`` (the Hamilton product, ``core/su2.py::quat_multiply``)."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([w, -x, -y, -z,
                        x, w, -z, y,
                        y, z, w, -x,
                        z, -y, x, w], dim=-1).view(*q.shape[:-1], 4, 4)


def propagate_phase_control(phi_t: torch.Tensor, dt: float, delta: torch.Tensor,
                            eps: torch.Tensor) -> torch.Tensor:
    """Time-stepped propagation under ``H = ½(1+ε)(cos φ X + sin φ Y + δZ)``
    with fixed step dt (reference dCRAB.py:37-44), ``q ← q_k ⊗ q`` over the
    time steps.

    phi_t: ``(..., T)``; delta/eps: ``(S,)`` broadcastable → ``(..., S, 4)``.
    Every step's segment is formed at once; the loop then applies each as
    its left-multiplication matrix, one small batched product a step.
    """
    T = phi_t.shape[-1]
    seg = segment_quat(phi_t[..., :, None], dt, delta, eps)       # (..., T, S, 4)
    left = _left_matrix(seg)                                      # (..., T, S, 4, 4)
    shape = torch.broadcast_shapes(phi_t.shape[:-1] + delta.shape,
                                   phi_t.shape[:-1] + eps.shape)
    q = torch.zeros(shape + (4, 1), dtype=phi_t.dtype, device=phi_t.device)
    q[..., 0, 0] = 1.0
    for k in range(T):
        q = torch.matmul(left.select(-4, k), q)
    return q[..., 0]


def average_infidelity(params: torch.Tensor, t: torch.Tensor, omegas: torch.Tensor,
                       q_target: torch.Tensor, delta: torch.Tensor, eps: torch.Tensor,
                       dt: float) -> torch.Tensor:
    """``1 − E_S[(|Tr(U_t† U)| + 2)/6]`` (reference dCRAB.py:47-59)."""
    phi_t = build_phi(params, t, omegas)
    q = propagate_phase_control(phi_t, dt, delta, eps)
    tr = torch.abs(quat_trace_inner(q, q_target))
    return 1.0 - torch.mean((tr + 2.0) / 6.0, dim=-1)


def _as_quat(u_target, device) -> torch.Tensor:
    u = u_target if torch.is_tensor(u_target) else torch.as_tensor(np.asarray(u_target))
    if u.ndim == 1 and u.shape[-1] == 4:
        return u.to(device=device, dtype=torch.float32)
    return su2_to_quat(u.to(torch.complex64)).to(device)


def _setup(u_target, config: DcrabConfig, generator: Optional[torch.Generator] = None,
           device=None) -> DcrabProblem:
    """The problem's time grid, disorder draws, per-round frequencies,
    initial parameters (φ₀ = 0, amplitudes 0.01·N(0, 1)) and target,
    drawn in that order from ``generator`` (a CPU generator seeded with
    ``config.seed`` by default) and placed on ``device``."""
    cfg = config
    dev = resolve_device(device)
    gen = generator if generator is not None else torch.Generator().manual_seed(cfg.seed)
    gdev = gen.device
    t = torch.arange(0.0, cfg.T, cfg.dt, dtype=torch.float32)
    delta = torch.randn((cfg.samples,), generator=gen, device=gdev) * cfg.delta_std
    eps = torch.randn((cfg.samples,), generator=gen, device=gdev) * cfg.epsilon_std
    omegas = cfg.w_min + (cfg.w_max - cfg.w_min) * torch.rand(
        (cfg.rounds, cfg.n_modes), generator=gen, device=gdev)
    n_params = 1 + 2 * cfg.n_modes
    x0 = torch.zeros((cfg.rounds, n_params), device=gdev)
    x0[:, 1:] = 0.01 * torch.randn((cfg.rounds, n_params - 1), generator=gen, device=gdev)
    return DcrabProblem(*(v.to(dev) for v in (t, delta, eps, omegas, x0)),
                        _as_quat(u_target, dev))


def run_adam(problem: DcrabProblem, dt: float, steps: int, learning_rate: float
             ) -> Tuple[torch.Tensor, torch.Tensor, List[float]]:
    """Adam (optax's defaults) on the sum over rounds of each round's
    infidelity, ``steps`` steps from ``problem.x0``.  Returns ``(params (R,
    n), final per-round infidelity (R,), each step's summed infidelity
    before its update)``."""
    t, delta, eps, omegas, x0, q_target = problem
    params = x0.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([params], lr=learning_rate, betas=(0.9, 0.999), eps=1e-8)
    losses = []
    for _ in range(steps):
        loss = torch.sum(average_infidelity(params, t, omegas, q_target, delta, eps, dt))
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.detach())
    with torch.no_grad():
        infid = average_infidelity(params, t, omegas, q_target, delta, eps, dt)
    return params.detach(), infid, [float(x) for x in losses]


def optimize_dcrab_grad(u_target, config: DcrabConfig = DcrabConfig(), steps: int = 500,
                        learning_rate: float = 0.02,
                        generator: Optional[torch.Generator] = None, device=None,
                        return_losses: bool = False):
    """Gradient-mode dCRAB: Adam on the Fourier coefficients of all restart
    rounds at once (:func:`run_adam`).

    Returns ``((best_params, best_omegas), best_fidelity)`` (numpy, float),
    the reference's convention (dCRAB.py:121-125), and where
    ``return_losses`` each step's summed infidelity before its update.
    """
    cfg = config
    problem = _setup(u_target, cfg, generator, device)
    params, infid, losses = run_adam(problem, cfg.dt, steps, learning_rate)
    best = int(torch.argmin(infid))
    out = ((params[best].cpu().numpy(), problem.omegas[best].cpu().numpy()),
           1.0 - float(infid[best]))
    return out + (losses,) if return_losses else out


# --------------------------------------------------------------------------
# batched Nelder–Mead (derivative-free mode)
# --------------------------------------------------------------------------

@torch.no_grad()
def _nelder_mead_batched(f: Callable, x0: torch.Tensor, maxiter: int,
                         initial_step: float = 0.05, xatol: float = 1e-6,
                         fatol: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Vectorized Nelder–Mead: ``x0 (R, n)`` runs R independent optimizations
    in lockstep.  ``f`` maps ``(R·k, n)`` rows, grouped round-major (k rows
    a round), to ``(R·k,)`` objectives.

    Standard coefficients (α = 1, γ = 2, ρ = 0.5, σ = 0.5), the JAX
    package's iteration: the loop stops after ``maxiter`` iterations or
    when every simplex's f-spread is ≤ ``fatol`` (``xatol`` is accepted and
    unused, as there).  The reflection, expansion and contraction points
    are scored in one call; the shrunk simplex only where a round shrinks
    (the JAX loop scores it always and keeps it only there).
    """
    R, n = x0.shape
    eye = torch.eye(n, dtype=x0.dtype, device=x0.device) * initial_step
    simplex = torch.cat([x0[:, None, :], x0[:, None, :] + eye[None]], dim=1)  # (R, n+1, n)

    def eval_simplex(s):  # (R, k, n) -> (R, k)
        return f(s.reshape(R * s.shape[1], n)).reshape(R, s.shape[1])

    fvals = eval_simplex(simplex)
    it = 0
    while it < maxiter and bool(torch.any(fvals.amax(dim=1) - fvals.amin(dim=1) > fatol)):
        order = torch.argsort(fvals, dim=1, stable=True)
        simplex = torch.take_along_dim(simplex, order[..., None], dim=1)
        fvals = torch.take_along_dim(fvals, order, dim=1)

        worst = simplex[:, -1]
        f_best, f_second, f_worst = fvals[:, 0], fvals[:, -2], fvals[:, -1]
        centroid = torch.mean(simplex[:, :-1], dim=1)         # (R, n)
        xr = centroid + (centroid - worst)                    # reflection
        xe = centroid + 2.0 * (centroid - worst)              # expansion
        xc = centroid + 0.5 * (worst - centroid)              # contraction
        fr, fe, fc = eval_simplex(torch.stack([xr, xe, xc], dim=1)).unbind(1)

        use_expand = (fr < f_best) & (fe < fr)
        use_reflect = ~use_expand & (fr < f_second)
        use_contract = ~use_expand & ~use_reflect & (fc < f_worst)
        shrink = ~(use_expand | use_reflect | use_contract)

        new_point = torch.where(use_expand[:, None], xe,
                                torch.where(use_reflect[:, None], xr,
                                            torch.where(use_contract[:, None], xc, worst)))
        new_f = torch.where(use_expand, fe,
                            torch.where(use_reflect, fr,
                                        torch.where(use_contract, fc, f_worst)))
        simplex = torch.cat([simplex[:, :-1], new_point[:, None]], dim=1)
        fvals = torch.cat([fvals[:, :-1], new_f[:, None]], dim=1)

        if bool(shrink.any()):
            # shrink all but the best toward the best
            shrunk = simplex[:, :1] + 0.5 * (simplex - simplex[:, :1])
            simplex = torch.where(shrink[:, None, None], shrunk, simplex)
            fvals = torch.where(shrink[:, None], eval_simplex(shrunk), fvals)
        it += 1
    ibest = torch.argmin(fvals, dim=1)
    xbest = torch.take_along_dim(simplex, ibest[:, None, None], dim=1)[:, 0]
    fbest = torch.take_along_dim(fvals, ibest[:, None], dim=1)[:, 0]
    return xbest, fbest


def optimize_dcrab_nm(u_target, config: DcrabConfig = DcrabConfig(), maxiter: int = 1000,
                      generator: Optional[torch.Generator] = None, device=None,
                      use_scipy: bool = False):
    """Derivative-free dCRAB: the batched Nelder–Mead (all rounds in
    lockstep) by default; ``use_scipy=True`` runs SciPy's Nelder–Mead per
    round (the reference's loop, dCRAB.py:91-124).

    Nelder–Mead is meant for the low-dimensional regimes dCRAB normally
    runs in (N ≲ 30): at N = 2000 modes (4001 parameters) a simplex barely
    moves in ``maxiter`` iterations; use :func:`optimize_dcrab_grad` there.
    Returns ``((best_params, best_omegas), best_fidelity)``.
    """
    cfg = config
    t, delta, eps, omegas, x0, q_target = _setup(u_target, cfg, generator, device)

    if use_scipy:
        from scipy.optimize import minimize

        best_fid, best = -np.inf, None
        for rnd in range(cfg.rounds):
            def obj(p, w=omegas[rnd]):
                with torch.no_grad():
                    x = torch.as_tensor(p, dtype=torch.float32, device=x0.device)
                    return float(average_infidelity(x, t, w, q_target, delta, eps, cfg.dt))
            res = minimize(obj, x0[rnd].cpu().numpy(), method="Nelder-Mead",
                           options={"maxiter": maxiter})
            fid = 1.0 - float(res.fun)
            if fid > best_fid:
                best_fid = fid
                best = (res.x.copy(), omegas[rnd].cpu().numpy())
        return best, best_fid

    R = cfg.rounds

    def batched_obj(params_flat):  # (R·k, n) -> (R·k,)
        p = params_flat.reshape(R, params_flat.shape[0] // R, -1)
        return average_infidelity(p, t, omegas[:, None, :], q_target, delta, eps,
                                  cfg.dt).reshape(-1)

    xbest, fbest = _nelder_mead_batched(batched_obj, x0, maxiter)
    best = int(torch.argmin(fbest))
    return ((xbest[best].cpu().numpy(), omegas[best].cpu().numpy()),
            1.0 - float(fbest[best]))


def dcrab_optimize(u_target, mode: str = "grad", **kwargs):
    """Front door matching the reference entry point (dCRAB.py:68-125).

    ``mode``: "grad" (default) or "nm".  Config fields pass as keyword
    arguments; the rest go to the optimizer.
    """
    cfg_fields = {f.name for f in dataclasses.fields(DcrabConfig)}
    cfg = DcrabConfig(**{k: v for k, v in kwargs.items() if k in cfg_fields})
    rest = {k: v for k, v in kwargs.items() if k not in cfg_fields}
    if mode == "grad":
        return optimize_dcrab_grad(u_target, cfg, **rest)
    if mode == "nm":
        return optimize_dcrab_nm(u_target, cfg, **rest)
    raise ValueError(f"unknown mode: {mode}")
