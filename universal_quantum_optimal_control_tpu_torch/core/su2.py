r"""SU(2) algebra on real quaternions (PyTorch port of ``core/su2.py``).

Every SU(2) unitary is a real unit quaternion ``q = (w, x, y, z)`` under

    U(q) = w·I − i·(x·σx + y·σy + z·σz),

so ``exp(−i·(θ/2)·n̂·σ) ↔ (cos θ/2, sin θ/2 · n̂)``, composition is the
Hamilton product (``U(q1) @ U(q2) = U(q1 ⊗ q2)``), and the entanglement
fidelity for d = 2 is ``F = (4⟨q, p⟩² + 2) / 6``.

All functions take tensors, broadcast over leading axes with the quaternion
components in a trailing axis of size 4, and run on the device of their
inputs.
"""

from __future__ import annotations

import torch

__all__ = [
    "quat_multiply",
    "quat_conj",
    "quat_normalize",
    "axis_angle_to_quat",
    "rotation_vector_to_quat",
    "segment_quat",
    "segment_quat_amp",
    "segment_quat_det",
    "quat_to_su2",
    "su2_to_quat",
    "quat_trace_inner",
    "quat_fidelity",
]


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product ``q1 ⊗ q2`` — maps to ``U(q1) @ U(q2)``."""
    w1, x1, y1, z1 = q1.unbind(-1)
    w2, x2, y2, z2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
        ],
        dim=-1,
    )


def quat_conj(q: torch.Tensor) -> torch.Tensor:
    """Quaternion conjugate — maps to ``U(q)†`` for unit quaternions."""
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def quat_normalize(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.sqrt(torch.clamp_min(torch.sum(q * q, dim=-1, keepdim=True), eps))
    return q / n


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``exp(−i·(angle/2)·n̂·σ)`` as a quaternion; ``axis`` need not be unit.

    ``axis (..., 3)``, ``angle (...,)`` → ``(..., 4)``; identity as the angle
    or the axis norm goes to 0.
    """
    norm = torch.sqrt(torch.clamp_min(torch.sum(axis * axis, dim=-1), 1e-24))
    half = 0.5 * angle
    s = torch.sin(half) / norm
    return torch.cat([torch.cos(half)[..., None], axis * s[..., None]], dim=-1)


def rotation_vector_to_quat(rotation_vector: torch.Tensor) -> torch.Tensor:
    """Rotation vector ``(n_x, n_y, n_z, θ)`` → quaternion (axis normalized)."""
    n = rotation_vector[..., :3]
    theta = rotation_vector[..., 3]
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), 1e-12)
    return axis_angle_to_quat(n, theta)


def segment_quat(phi, tau, delta, epsilon) -> torch.Tensor:
    r"""Closed-form propagator of one phase-control segment (P = 2).

        H = ½·(1 + ε)·(cos φ·σx + sin φ·σy + δ·σz),   U = exp(−i·H·τ)

    a rotation about ``(cos φ, sin φ, δ)`` (norm ``√(1+δ²)``) by
    ``τ·(1+ε)·√(1+δ²)``.  Inputs broadcast elementwise.
    """
    anorm = torch.sqrt(1.0 + delta * delta)
    half = 0.5 * tau * (1.0 + epsilon) * anorm
    s = torch.sin(half) / anorm
    comps = torch.broadcast_tensors(
        torch.cos(half), s * torch.cos(phi), s * torch.sin(phi), s * delta)
    return torch.stack(comps, dim=-1)


def _axis_norm(omega, z):
    """``‖(Ω cos φ, Ω sin φ, z)‖`` with its square floored at 1e-24.

    The JAX package's XLA path floors the norm itself at 1e-12 after the
    square root, so its gradient is NaN where Ω ≤ 0 and z = 0 exactly (the
    square root's derivative at 0), which f32 draws do reach.  Flooring the
    square, as the TPU's backward kernel does, leaves every value with
    ‖a‖ ≥ 1e-12 unchanged and gives there the finite derivative
    ``∂q_z/∂z = ½·τ·(1 + ε)``, the limit of the closed form.
    """
    return torch.sqrt(torch.clamp_min(omega * omega + z * z, 1e-24))


def segment_quat_amp(phi, omega, tau, delta, epsilon) -> torch.Tensor:
    r"""Amplitude-modulated segment (P = 3), Ω ≤ 0 clamped to 0.

        H = ½·(1 + ε)·(Ω·cos φ·σx + Ω·sin φ·σy + δ·σz),   U = exp(−i·H·τ)
    """
    omega = torch.clamp_min(omega, 0.0)
    anorm = _axis_norm(omega, delta)
    half = 0.5 * tau * (1.0 + epsilon) * anorm
    s = torch.sin(half) / anorm
    comps = torch.broadcast_tensors(
        torch.cos(half), s * omega * torch.cos(phi), s * omega * torch.sin(phi),
        s * delta)
    return torch.stack(comps, dim=-1)


def segment_quat_det(phi, omega, det, tau, delta, epsilon) -> torch.Tensor:
    r"""Detuned amplitude-modulated segment (P = 4), parameters ``(φ, Ω, Δ, τ)``.

    The controllable detuning Δ adds to the disorder δ on the σz axis; Ω ≤ 0
    is clamped to 0:

        H = ½·(1 + ε)·(Ω·cos φ·σx + Ω·sin φ·σy + (Δ + δ)·σz)
    """
    omega = torch.clamp_min(omega, 0.0)
    z = det + delta
    anorm = _axis_norm(omega, z)
    half = 0.5 * tau * (1.0 + epsilon) * anorm
    s = torch.sin(half) / anorm
    comps = torch.broadcast_tensors(
        torch.cos(half), s * omega * torch.cos(phi), s * omega * torch.sin(phi),
        s * z)
    return torch.stack(comps, dim=-1)


def quat_to_su2(q: torch.Tensor) -> torch.Tensor:
    """Quaternion → complex64 2×2 SU(2) matrix ``(..., 2, 2)``."""
    w, x, y, z = q.float().unbind(-1)
    m00 = torch.complex(w, -z)
    m01 = torch.complex(-y, -x)
    m10 = torch.complex(y, -x)
    m11 = torch.complex(w, z)
    row0 = torch.stack([m00, m01], dim=-1)
    row1 = torch.stack([m10, m11], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def su2_to_quat(U: torch.Tensor) -> torch.Tensor:
    """Complex 2×2 SU(2) matrix → real quaternion ``(..., 4)`` (renormalized);
    inverts :func:`quat_to_su2`."""
    w = 0.5 * (U[..., 0, 0] + U[..., 1, 1]).real
    z = -0.5 * (U[..., 0, 0] - U[..., 1, 1]).imag
    x = -0.5 * (U[..., 0, 1] + U[..., 1, 0]).imag
    y = 0.5 * (U[..., 1, 0] - U[..., 0, 1]).real
    return quat_normalize(torch.stack([w, x, y, z], dim=-1))


def quat_trace_inner(q_out: torch.Tensor, q_target: torch.Tensor) -> torch.Tensor:
    """``Tr(U(q_out)† U(q_target)) = 2·⟨q_out, q_target⟩`` (real)."""
    return 2.0 * torch.sum(q_out * q_target, dim=-1)


def quat_fidelity(q_out: torch.Tensor, q_target: torch.Tensor) -> torch.Tensor:
    """Entanglement fidelity for d = 2: ``(|Tr|² + 2)/6 = (4⟨q,p⟩² + 2)/6``."""
    t = quat_trace_inner(q_out, q_target)
    return (t * t + 2.0) / 6.0
