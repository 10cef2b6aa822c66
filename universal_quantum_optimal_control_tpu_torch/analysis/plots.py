r"""Monte-Carlo robustness score ``E[F] ± SE`` of one pulse table.

Only the estimator of the JAX package's ``analysis/plots.py`` is ported; the
plotting functions wait for a later slice.  The per-sample propagation goes
through kernel B3 (:func:`..ops.propagate_su2.propagate_mc_cuda`) on CUDA.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core import su2
from ..core.errors import sample_ore_ple
from ..ops.propagate_su2 import propagate_mc_cuda
from ..utils.device import resolve_device

__all__ = ["mc_fidelity_estimate"]


def _as_target_quat(u_target, device: torch.device) -> torch.Tensor:
    """A ``(2, 2)`` unitary or a ``(4,)`` quaternion → f32 quaternion."""
    u = torch.as_tensor(u_target, device=device)
    if u.dim() >= 2 and u.shape[-2:] == (2, 2):
        return su2.su2_to_quat(u.to(torch.complex64))
    return u.to(torch.float32)


def _mc_stats(pulses: torch.Tensor, q_target: torch.Tensor,
              delta: torch.Tensor, eps: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and standard error of F over ``(M,)`` explicit disorder draws."""
    q = propagate_mc_cuda(pulses[None], delta[None], eps[None])[0]
    F = su2.quat_fidelity(q, q_target[None])
    return F.mean(), F.std(correction=0) / math.sqrt(F.shape[0])


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
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    delta, eps = sample_ore_ple(generator, (monte_carlo,), delta_std, epsilon_std)
    pulses = torch.as_tensor(pulses, dtype=torch.float32, device=dev).contiguous()
    mean, se = _mc_stats(pulses, _as_target_quat(u_target, dev), delta, eps)
    return float(mean), float(se)
