r"""Monte-Carlo composite-pulse propagation in eager PyTorch.

This is the plain version of both SU(2) CUDA kernels
(:mod:`..ops.propagate_su2`) and the CPU oracle the tests hold them to.  It
composes ``U_L ⋯ U_2 U_1`` left to right (``q ← q_k ∘ q``), building one
segment at a time so the memory is ``O(B·M)`` at any L.
"""

from __future__ import annotations

import torch

from .su2 import quat_multiply, segment_quat, segment_quat_amp, segment_quat_det

__all__ = ["propagate_scan", "propagate_mc"]


def _segment_quats(pulses: torch.Tensor, delta: torch.Tensor,
                   epsilon: torch.Tensor) -> torch.Tensor:
    """Per-segment quaternions ``(..., L, 4)`` from ``(..., L, P)`` pulses.

    P = 2 → ``(φ, τ)``; P = 3 → ``(φ, Ω, τ)``; P = 4 → ``(φ, Ω, Δ, τ)``.
    ``delta``/``epsilon`` are ``(...)`` and broadcast over the L axis.
    """
    P = pulses.shape[-1]
    d, e = delta[..., None], epsilon[..., None]
    if P == 2:
        return segment_quat(pulses[..., 0], pulses[..., 1], d, e)
    if P == 3:
        return segment_quat_amp(pulses[..., 0], pulses[..., 1],
                                pulses[..., 2], d, e)
    if P == 4:
        return segment_quat_det(pulses[..., 0], pulses[..., 1],
                                pulses[..., 2], pulses[..., 3], d, e)
    raise ValueError(
        f"unsupported pulse parameter count: {P} (want 2, 3 or 4)")


def propagate_scan(pulses: torch.Tensor, delta: torch.Tensor,
                   epsilon: torch.Tensor) -> torch.Tensor:
    """Compose ``U_L ⋯ U_1``: ``(..., L, P)`` pulses, ``(...)`` disorder →
    ``(..., 4)`` quaternion."""
    L = pulses.shape[-2]
    shape = torch.broadcast_shapes(pulses.shape[:-2], delta.shape, epsilon.shape)
    q = torch.zeros(shape + (4,), dtype=pulses.dtype, device=pulses.device)
    q[..., 0] = 1.0
    for k in range(L):
        seg = _segment_quats(pulses[..., k:k + 1, :], delta, epsilon)[..., 0, :]
        q = quat_multiply(seg, q)
    return q


def propagate_mc(pulses: torch.Tensor, delta: torch.Tensor,
                 epsilon: torch.Tensor) -> torch.Tensor:
    """One pulse table per target, M samples: ``(B, L, P)`` pulses and
    ``(B, M)`` disorder → ``(B, M, 4)`` quaternions.  The pulse table
    broadcasts across the M axis without being repeated in memory."""
    return propagate_scan(pulses[:, None, :, :], delta, epsilon)
