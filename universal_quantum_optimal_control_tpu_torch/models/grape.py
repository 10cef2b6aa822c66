r"""GRAPE pulse model (PyTorch port of ``models/grape.py``).

Two modes, as in the JAX package:

* **MLP** (default): the reference reparameterization, a bias-free MLP
  ``4 → 3L → 3L`` with relu whose output channels ``(u_x, u_y, u_τ)`` map
  to ``(φ, τ)`` through ``φ = atan2(σ(u_y), σ(u_x))`` and the range map.
  Both sigmoids are positive, so the atan2 lies in (0, π/2) before the
  range map: a reference quirk, kept because the smooth surjection is what
  GRAPE optimizes through.  P = 2 only.
* **direct** (``direct=True``): a raw ``(num_targets, L, P + 1)`` logit
  table, classic GRAPE.  With ``num_targets == 1`` it broadcasts over the
  input batch; otherwise the batch must be the full target set.

The last channel (τ) goes through relu, as in the JAX module.  The model
has no dropout: ``forward`` takes the trainer's ``generator`` and ignores
it.  :meth:`GRAPE.init_like_flax` draws Flax's initial values (the Dense
kernels ``lecun_normal``, the direct logits ``normal(0.1)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..utils.device import resolve_device
from .universal_transformer import _TRUNC_STD, _pulse_space_json, normalize_pulse_space

__all__ = ["GRAPE"]


class GRAPE(nn.Module):
    """GRAPE pulse generator: ``(B, 4)`` rotation vectors → ``(B, L, P)``.

    ``device=None`` builds the parameters on CUDA (and raises where there
    is none).
    """

    def __init__(self, pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.035, 0.07))),
                 num_pulses: int = 400, num_qubits: int = 1, direct: bool = False,
                 num_targets: int = 1, device=None):
        super().__init__()
        if num_qubits != 1:
            raise ValueError(f"num_qubits={num_qubits}: this model is single-qubit")
        dev = resolve_device(device)
        self.pulse_space = normalize_pulse_space(pulse_space)
        self.num_pulses = num_pulses
        self.direct = bool(direct)
        self.num_targets = num_targets
        self.hparams = dict(pulse_space=_pulse_space_json(self.pulse_space),
                            num_pulses=num_pulses, num_qubits=num_qubits,
                            direct=self.direct, num_targets=num_targets)
        P = len(self.pulse_space)
        L = num_pulses
        if self.direct:
            self.pulse_logits = nn.Parameter(
                torch.zeros((num_targets, L, P + 1), device=dev))
        else:
            if P != 2:
                raise ValueError(
                    "the reference MLP reparameterization is defined for the "
                    "2-parameter (phi, tau) space; use direct=True for "
                    "general pulse spaces")
            self.fc1 = nn.Linear(4, 3 * L, bias=False, device=dev)
            self.fc2 = nn.Linear(3 * L, 3 * L, bias=False, device=dev)
        self.register_buffer(
            "low", torch.tensor([lo for _, (lo, _) in self.pulse_space], device=dev),
            persistent=False)
        self.register_buffer(
            "high", torch.tensor([hi for _, (_, hi) in self.pulse_space], device=dev),
            persistent=False)

    @property
    def param_dim(self) -> int:
        return len(self.pulse_space)

    @torch.no_grad()
    def init_like_flax(self, generator: torch.Generator) -> None:
        """Re-draw the weights from the JAX module's initializers, in place:
        the Dense kernels ``lecun_normal`` (a normal truncated at ±2σ, σ
        corrected so the drawn std is 1/√fan_in), the direct logits
        ``normal(0.1)``.  ``generator`` lies on the parameters' device."""
        if self.direct:
            self.pulse_logits.copy_(0.1 * torch.randn(
                self.pulse_logits.shape, generator=generator,
                device=self.pulse_logits.device))
            return
        for layer in (self.fc1, self.fc2):
            std = 1.0 / math.sqrt(layer.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)

    def forward(self, rotation_vector: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(B, 4)`` rotation vectors → ``(B, L, P)`` pulses.  ``generator``
        is accepted for the trainer's call and unused (no dropout)."""
        B = rotation_vector.shape[0]
        L, n_logits = self.num_pulses, self.param_dim + 1
        if self.direct:
            logits = self.pulse_logits
            if self.num_targets == 1:
                logits = logits.expand(B, L, n_logits)
            elif self.num_targets != B:
                raise ValueError(
                    f"direct GRAPE with num_targets={self.num_targets} "
                    f"requires the full target batch (B={B}) each call; "
                    "train full-batch or use num_targets=1")
        else:
            h = torch.relu(self.fc1(rotation_vector.float()))
            logits = self.fc2(h).view(B, L, 3)
        u = torch.sigmoid(logits)
        phi_unit = torch.atan2(u[..., 1], u[..., 0])
        units = torch.cat([phi_unit[..., None], u[..., 2:]], dim=-1)
        pulses = self.low + (self.high - self.low) * units
        return torch.cat([pulses[..., :-1], torch.relu(pulses[..., -1:])], dim=-1)
