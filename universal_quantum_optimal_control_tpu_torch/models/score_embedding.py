r"""SCORE composite-pulse embedding (PyTorch port of ``models/score_embedding.py``).

1. rescale the target rotation vector into the xz-plane (its in-plane
   azimuth is re-added to the output pulse phases),
2. branchless Y-X-Y Euler decomposition,
3. each Euler angle expands into a 3-pulse SCORE composite → 9 unitaries,
4. flattened into real vectors (interleaved re/im of the 2×2 matrices).

``middle_convention``: ``"angle"`` (middle pulse ``angle + 2θ'``, the
composite that reproduces the target) or ``"reference"`` (``φ + 2θ'``, the
upstream featurization).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..core.su2 import axis_angle_to_quat
from ..utils.device import resolve_device

__all__ = [
    "euler_yxy_from_rotation_vector",
    "score_correction_angle",
    "score_triplet",
    "score_sequence_from_yxy",
    "quat_to_real_vector",
    "score_features",
    "sinusoidal_positional_encoding",
]


def _safe_atan2(num: torch.Tensor, den: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """``atan2`` where ``mask``, 0 elsewhere, with safe arguments off-mask."""
    one = torch.ones_like(num)
    return torch.where(mask, torch.atan2(torch.where(mask, num, one),
                                         torch.where(mask, den, one)),
                       torch.zeros_like(num))


def euler_yxy_from_rotation_vector(rotation_vector: torch.Tensor,
                                   eps: float = 1e-12) -> torch.Tensor:
    """``(..., 4)`` rotation vectors ``(n_x, n_y, n_z, θ)`` → ``(..., 3)``
    angles ``(α, β, γ)`` with ``exp(−iθ/2 n·σ) = R_y(α) R_x(β) R_y(γ)``.

    Gimbal lock (β ≈ 0 → Y only; β ≈ π → the θ → π⁻ limit of the regular
    branch) is handled by masked selections, as in the JAX package.
    """
    n = rotation_vector[..., :3]
    theta = rotation_vector[..., 3]
    n = n / torch.clamp_min(torch.linalg.norm(n, dim=-1, keepdim=True), eps)

    s, c = torch.sin(theta / 2), torch.cos(theta / 2)
    w = c
    x = n[..., 0] * s
    y = n[..., 1] * s
    z = n[..., 2] * s

    # r² = x² + z² = sin²(β/2);  w² + y² = cos²(β/2)
    r2 = x * x + z * z
    c2 = w * w + y * y
    clip_eps = 1e-7  # representable in f32, keeps arccos finite at the poles
    beta = torch.arccos(torch.clamp(1.0 - 2.0 * r2, -1.0 + clip_eps, 1.0 - clip_eps))

    tol2 = 1e-9
    mask_beta0 = r2 < tol2
    mask_betapi = c2 < tol2
    mask_reg = ~mask_beta0 & ~mask_betapi

    alpha_reg = _safe_atan2(x * y - z * w, y * z + w * x, mask_reg)
    gamma_reg = _safe_atan2(x * y + z * w, w * x - y * z, mask_reg)
    alpha_b0 = 2.0 * _safe_atan2(y, w, mask_beta0)
    alpha_bpi = _safe_atan2(-z, x, mask_betapi)
    gamma_bpi = _safe_atan2(z, x, mask_betapi)

    alpha = alpha_reg + alpha_b0 + alpha_bpi  # disjoint branches
    gamma = gamma_reg + gamma_bpi
    return torch.stack([alpha, beta, gamma], dim=-1)


def score_correction_angle(angle: torch.Tensor) -> torch.Tensor:
    """SCORE flanking-pulse angle ``θ' = π − angle − asin(½ sin(angle/2))``."""
    return math.pi - angle - torch.arcsin(0.5 * torch.sin(angle / 2))


def score_triplet(phi: torch.Tensor, angle: torch.Tensor,
                  middle_convention: str = "angle") -> torch.Tensor:
    """3-pulse SCORE composite about in-plane axis φ by ``angle``:
    quaternions ``(..., 3, 4)`` ``[R(φ+π, θ'), R(φ, middle), R(φ+π, θ')]``."""
    theta_p = score_correction_angle(angle)
    if middle_convention == "angle":
        middle = angle + 2.0 * theta_p
    elif middle_convention == "reference":
        middle = phi + 2.0 * theta_p
    else:
        raise ValueError(f"unknown middle_convention: {middle_convention}")

    def in_plane_axis(p):
        return torch.stack([torch.cos(p), torch.sin(p), torch.zeros_like(p)], dim=-1)

    q_flank = axis_angle_to_quat(in_plane_axis(phi + math.pi), theta_p)
    q_mid = axis_angle_to_quat(in_plane_axis(phi), middle)
    return torch.stack([q_flank, q_mid, q_flank], dim=-2)


def score_sequence_from_yxy(euler_angles: torch.Tensor,
                            middle_convention: str = "angle") -> torch.Tensor:
    """Y-X-Y Euler triple → 9 SCORE quaternions ``(..., 9, 4)``:
    ``SCORE(0, α) ‖ SCORE(π/2, β) ‖ SCORE(0, γ)``."""
    alpha, beta, gamma = euler_angles.unbind(-1)
    zero = torch.zeros_like(alpha)
    half_pi = torch.full_like(alpha, math.pi / 2)
    return torch.cat([
        score_triplet(zero, alpha, middle_convention),
        score_triplet(half_pi, beta, middle_convention),
        score_triplet(zero, gamma, middle_convention),
    ], dim=-2)


def quat_to_real_vector(q: torch.Tensor) -> torch.Tensor:
    """Interleaved re/im flattening of ``U(q)`` without complex dtype: the
    fixed linear map ``[w, −z, −y, −x, y, −x, w, z]``."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([w, -z, -y, -x, y, -x, w, z], dim=-1)


def score_features(rotation_vector: torch.Tensor,
                   middle_convention: str = "angle") -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, 4)`` rotation vectors → ``(tokens (B, 9, 8), phi_offset (B,))``;
    ``phi_offset = atan2(n_y, n_x)`` is re-added to the output phases."""
    phi_offset = torch.atan2(rotation_vector[..., 1], rotation_vector[..., 0])
    n_xy = torch.sqrt(rotation_vector[..., 0] ** 2 + rotation_vector[..., 1] ** 2)
    rescaled = torch.stack(
        [n_xy, torch.zeros_like(n_xy), rotation_vector[..., 2],
         rotation_vector[..., 3]], dim=-1)
    euler = euler_yxy_from_rotation_vector(rescaled)
    quats = score_sequence_from_yxy(euler, middle_convention)
    return quat_to_real_vector(quats), phi_offset


def sinusoidal_positional_encoding(length: int, d_model: int,
                                   dtype: torch.dtype = torch.float32,
                                   device: Optional[torch.device] = None) -> torch.Tensor:
    """Standard sin/cos positional encoding ``(length, d_model)``."""
    dev = resolve_device(device)
    position = torch.arange(length, dtype=dtype, device=dev)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=dtype, device=dev)
                         * (-math.log(10000.0) / d_model))
    ang = position * div_term[None, :]
    pe = torch.zeros((length, d_model), dtype=dtype, device=dev)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe
