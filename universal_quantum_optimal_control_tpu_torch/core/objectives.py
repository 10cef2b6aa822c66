r"""Fidelities and training losses (PyTorch port of ``core/objectives.py``).

The three fidelity normalizations that coexist in the reference:

* :func:`entanglement_fidelity` — ``(|Tr(U†V)|² + d) / (d(d+1))``;
* :func:`trace_fidelity` — ``|Tr(U†V)|² / d²``;
* :func:`dcrab_fidelity` — ``(|Tr(U†V)| + d) / (d(d+1))`` with the trace
  magnitude NOT squared (the dCRAB quirk: its maximum is 2/3 at d = 2).

Their quaternion forms use ``Tr(U(q)†U(p)) = 2⟨q, p⟩``.  The losses act on
the Monte-Carlo expectation E[F]: negative-log, infidelity and the
log-barrier "sharp" loss ``log(1 + exp(−k(F − τ̄)))·(1 − F)``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .su2 import quat_trace_inner

__all__ = [
    "entanglement_fidelity",
    "trace_fidelity",
    "dcrab_fidelity",
    "entanglement_fidelity_q",
    "trace_fidelity_q",
    "negative_log_loss",
    "infidelity_loss",
    "sharp_loss",
    "log_barrier",
]


def _trace_abs(U_out: torch.Tensor, U_target: torch.Tensor) -> torch.Tensor:
    """``|Tr(U_out† U_target)|`` for batched complex matrices ``(..., d, d)``."""
    return torch.abs(torch.sum(torch.conj(U_out) * U_target, dim=(-2, -1)))


def entanglement_fidelity(U_out: torch.Tensor, U_target: torch.Tensor) -> torch.Tensor:
    """``F = (|Tr(U†V)|² + d) / (d(d+1))``."""
    d = U_out.shape[-1]
    t = _trace_abs(U_out, U_target)
    return (t * t + d) / (d * (d + 1))


def trace_fidelity(U_out: torch.Tensor, U_target: torch.Tensor) -> torch.Tensor:
    """``F = |Tr(U†V)|² / d²``."""
    d = U_out.shape[-1]
    t = _trace_abs(U_out, U_target)
    return (t * t) / (d * d)


def dcrab_fidelity(U_out: torch.Tensor, U_target: torch.Tensor) -> torch.Tensor:
    """``F = (|Tr(U†V)| + d) / (d(d+1))`` — the unsquared trace, kept as the
    reference has it."""
    d = U_out.shape[-1]
    return (_trace_abs(U_out, U_target) + d) / (d * (d + 1))


def entanglement_fidelity_q(q_out: torch.Tensor, q_target: torch.Tensor) -> torch.Tensor:
    """Quaternion form of :func:`entanglement_fidelity`: ``(4⟨q,p⟩² + 2)/6``."""
    t = quat_trace_inner(q_out, q_target)
    return (t * t + 2.0) / 6.0


def trace_fidelity_q(q_out: torch.Tensor, q_target: torch.Tensor) -> torch.Tensor:
    """Quaternion form of :func:`trace_fidelity`: ``⟨q,p⟩²``."""
    t = quat_trace_inner(q_out, q_target)
    return 0.25 * t * t


def negative_log_loss(mean_fidelity: torch.Tensor) -> torch.Tensor:
    """``−log E[F]``."""
    return -torch.log(mean_fidelity)


def infidelity_loss(mean_fidelity: torch.Tensor) -> torch.Tensor:
    """``1 − E[F]``."""
    return 1.0 - mean_fidelity


def log_barrier(x: torch.Tensor, tau_bar: float = 0.99, k: float = 100.0) -> torch.Tensor:
    """``log(1 + exp(−k(x − τ̄)))·(1 − x)`` with a stable softplus.

    ``F.softplus`` returns its argument unchanged above its threshold of 20.
    That changes no f32 value: there ``log(1 + eᵘ) − u = log(1 + e⁻ᵘ) <
    e⁻²⁰ ≈ 2.1e-9``, below half an ulp of any ``u ≥ 20`` (1.9e-6), so at
    k = 100 the loss equals JAX's exact ``softplus`` for every x.
    """
    return F.softplus(-k * (x - tau_bar)) * (1.0 - x)


def sharp_loss(mean_fidelity: torch.Tensor, tau_bar: float = 0.99,
               k: float = 100.0) -> torch.Tensor:
    """Log-barrier loss on E[F]."""
    return log_barrier(mean_fidelity, tau_bar, k)
