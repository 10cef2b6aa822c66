r"""Eval-mode inference wrapper over a trained pulse model."""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.su2 import su2_to_quat

__all__ = ["Pipeline", "rotation_vector_from_unitary"]


def rotation_vector_from_unitary(U: torch.Tensor) -> torch.Tensor:
    """``(B, 2, 2)`` SU(2) matrices → ``(B, 4)`` rotation vectors, through the
    quaternion: θ = 2·atan2(‖v‖, w), n = v/‖v‖ (+x as ‖v‖ → 0)."""
    q = su2_to_quat(U)
    w, v = q[..., 0], q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    safe = torch.clamp_min(vnorm, 1e-12)[..., None]
    n = torch.where(vnorm[..., None] > 1e-9, v / safe, v.new_tensor([1.0, 0.0, 0.0]))
    return torch.cat([n, theta[..., None]], dim=-1)


class Pipeline:
    """Eval-mode, no-grad inference: rotation vectors → pulses.

    Args:
      model: a pulse model (e.g. ``UniversalQOCTransformer``) holding its weights.
      base_pulse: finetune base pulse passed to a ``finetune`` model.
    """

    def __init__(self, model: nn.Module,
                 base_pulse: Optional[torch.Tensor] = None) -> None:
        self.model = model.eval()
        self.base_pulse = base_pulse
        self.device = next(model.parameters()).device

    @torch.no_grad()
    def __call__(self, rotation_vector) -> torch.Tensor:
        rv = torch.as_tensor(rotation_vector, dtype=torch.float32, device=self.device)
        if getattr(self.model, "finetune", False):
            return self.model(rv, base_pulse=self.base_pulse)
        return self.model(rv)

    def forward_with_unitary(self, unitary) -> torch.Tensor:
        """``(B, 2, 2)`` target unitaries → pulses."""
        U = torch.as_tensor(unitary, dtype=torch.complex64, device=self.device)
        return self(rotation_vector_from_unitary(U))
