r"""Named single-qubit benchmark gates as rotation vectors ``(n_x, n_y, n_z, θ)``.

The training-set builder ``build_su2_dataset`` is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from ..utils.device import resolve_device

__all__ = ["named_gate_rotation_vectors"]

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
