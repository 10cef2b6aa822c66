r"""SU(2) target sets: the training sets and the named benchmark gates
(PyTorch port of ``data/su2_targets.py``).

Targets are rotation vectors ``(n_x, n_y, n_z, θ)`` with a unit axis, and
their quaternions.  Grid mode meshes polar angle × rotation angle with a
random azimuth; random mode draws all three, uniformly or (``haar``) with
the axis uniform on the sphere.  The draws come from an explicit
``torch.Generator``; the torch and JAX random streams differ, so the
parity tests hand both packages the same angles through
:func:`targets_from_angles`.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from ..core.su2 import axis_angle_to_quat
from ..utils.device import resolve_device

__all__ = ["build_su2_dataset", "grid_angles", "targets_from_angles",
           "named_gate_rotation_vectors"]


def grid_angles(batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The grid's deterministic part: ``B' = ⌊√batch_size⌋`` linspace over
    polar θ ∈ [0, π] × rotation angle α ∈ [0, 2π], flattened θ-major
    (``B'²`` each, f32, on the CPU)."""
    Bs = math.isqrt(batch_size)
    theta_lin = torch.linspace(0.0, math.pi, Bs)
    alpha_lin = torch.linspace(0.0, 2.0 * math.pi, Bs)
    theta, alpha = torch.meshgrid(theta_lin, alpha_lin, indexing="ij")
    return theta.reshape(-1), alpha.reshape(-1)


def targets_from_angles(theta: torch.Tensor, alpha: torch.Tensor,
                        phi: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Polar θ, rotation angle α and azimuth φ ``(B,)`` →
    ``(rotation_vectors (B, 4), quaternions (B, 4))``, axis normalized."""
    n = torch.stack([torch.sin(theta) * torch.cos(phi),
                     torch.sin(theta) * torch.sin(phi),
                     torch.cos(theta)], dim=1)
    n = n / torch.linalg.norm(n, dim=1, keepdim=True)
    rotation_vector = torch.cat([n, alpha[:, None]], dim=1)
    return rotation_vector, axis_angle_to_quat(n, alpha)


def build_su2_dataset(generator: torch.Generator, batch_size: int = 10000,
                      random: bool = False, haar: bool = False,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Build ``(rotation_vectors (B, 4), target_quaternions (B, 4))``.

    Grid mode (``random=False``) has ``B = ⌊√batch_size⌋²`` targets; random
    mode has ``batch_size``.  The draws are made on the generator's device
    and the result is moved to ``device`` (``None`` → CUDA, raising where
    there is none), so a CPU generator gives the same set on any device.
    """
    dev = resolve_device(device)
    gdev = generator.device

    def uniform(n):
        return torch.rand((n,), generator=generator, device=gdev)

    if not random:
        theta, alpha = grid_angles(batch_size)
        theta, alpha = theta.to(gdev), alpha.to(gdev)
        phi = uniform(theta.shape[0]) * 2.0 * math.pi
    else:
        if haar:
            theta = torch.arccos(uniform(batch_size) * 2.0 - 1.0)
        else:
            theta = uniform(batch_size) * math.pi
        alpha = uniform(batch_size) * 2.0 * math.pi
        phi = uniform(batch_size) * 2.0 * math.pi
    rv, q = targets_from_angles(theta, alpha, phi)
    return rv.to(dev), q.to(dev)


_SQRT2 = 1.0 / math.sqrt(2.0)
_NAMED = {
    "X": (1.0, 0.0, 0.0, math.pi),
    "X(pi/2)": (1.0, 0.0, 0.0, math.pi / 2),
    "Y": (0.0, 1.0, 0.0, math.pi),
    "Z(pi/4)": (0.0, 0.0, 1.0, math.pi / 4),
    "H": (_SQRT2, 0.0, _SQRT2, math.pi),
}


def named_gate_rotation_vectors(device=None) -> Dict[str, torch.Tensor]:
    """Standard single-qubit benchmark gates as f32 rotation vectors."""
    dev = resolve_device(device)
    return {k: torch.tensor(v, dtype=torch.float32, device=dev)
            for k, v in _NAMED.items()}
