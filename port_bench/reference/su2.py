"""SU(2) Monte-Carlo propagation and fidelity, plain PyTorch.

A unitary is the unit quaternion ``q = (w, x, y, z)`` with
``U = w·I − i(x·X + y·Y + z·Z)``.  A phase-control segment ``(φ, τ)`` under
off-resonance δ and pulse-length error ε evolves by

    H = ½(1 + ε)(cos φ·X + sin φ·Y + δ·Z),   U = exp(−iHτ),

a rotation about ``(cos φ, sin φ, δ)`` by ``τ(1 + ε)√(1 + δ²)``.  The
sequence's unitary is ``U_L ⋯ U_1`` and the entanglement fidelity against a
target quaternion ``p`` is ``(4⟨q, p⟩² + 2)/6``.
"""

from __future__ import annotations

import torch

from . import elementwise_dtype


def hamilton(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The quaternion product ``a ⊗ b``, i.e. ``U(a) U(b)``."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack([aw * bw - ax * bx - ay * by - az * bz,
                        aw * bx + ax * bw + ay * bz - az * by,
                        aw * by + ay * bw + az * bx - ax * bz,
                        aw * bz + az * bw + ax * by - ay * bx], dim=-1)


def segment(phi, tau, delta, eps) -> torch.Tensor:
    """One segment's quaternion; the arguments broadcast."""
    norm = torch.sqrt(1.0 + delta * delta)
    half = 0.5 * tau * (1.0 + eps) * norm
    s = torch.sin(half) / norm
    parts = torch.broadcast_tensors(torch.cos(half), s * torch.cos(phi),
                                    s * torch.sin(phi), s * delta)
    return torch.stack(parts, dim=-1)


def propagate(pulses: torch.Tensor, delta: torch.Tensor, eps: torch.Tensor,
              precision: str = "f32") -> torch.Tensor:
    """``(B, L, 2)`` pulses and ``(B, M)`` disorder → ``(B, M, 4)``."""
    dt = elementwise_dtype(precision)
    pulses, delta, eps = pulses.to(dt), delta.to(dt), eps.to(dt)
    q = torch.zeros(delta.shape + (4,), dtype=dt, device=delta.device)
    q[..., 0] = 1.0
    for k in range(pulses.shape[1]):
        seg = segment(pulses[:, k, 0, None], pulses[:, k, 1, None], delta, eps)
        q = hamilton(seg, q)
    return q


def fidelity(q: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Entanglement fidelity of ``(..., 4)`` products against ``target``."""
    inner = torch.sum(q * target.to(q.dtype), dim=-1)
    return (4.0 * inner * inner + 2.0) / 6.0


def mean_fidelity(pulses, target, delta, eps, precision: str = "f32") -> torch.Tensor:
    """Per-target ``E[F]`` ``(B,)`` in f32 from ``(B, 4)`` targets."""
    q = propagate(pulses, delta, eps, precision)
    return fidelity(q, target[:, None, :]).float().mean(dim=1)
