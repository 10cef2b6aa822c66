r"""Static-disorder sampler on an explicit ``torch.Generator``.

Draws ``δ ~ N(0, σ_δ²)`` (off-resonance error, ORE) and ``ε ~ N(0, σ_ε²)``
(pulse-length error, PLE).  The draws land on the generator's device.  The
torch and JAX random streams differ, so parity tests hand both packages the
same explicit draws instead of the same seed.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["sample_ore_ple"]


def sample_ore_ple(
    generator: torch.Generator,
    shape,
    delta_std: float = 1.0,
    epsilon_std: float = 0.05,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """ORE+PLE draw: independent gaussians ``(δ, ε)`` of the given shape."""
    dev = generator.device
    delta = torch.randn(shape, generator=generator, device=dev) * delta_std
    epsilon = torch.randn(shape, generator=generator, device=dev) * epsilon_std
    return delta, epsilon
