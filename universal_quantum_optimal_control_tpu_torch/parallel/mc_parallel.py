r"""Per-target Monte-Carlo objective on one device.

The backend names are the JAX package's, so later slices map 1:1:
``"xla"`` is the eager PyTorch path and ``"pallas"`` the hand-written
kernel B1 (on CPU tensors B1's wrapper computes its plain version).  Both
are differentiable: ``"xla"`` by autograd, ``"pallas"`` through B1's
backward (B3 and B2).  The mesh-sharded objective (``make_mean_fidelity``)
is not ported yet.
"""

from __future__ import annotations

import torch

from ..ops.propagate_su2 import mean_fidelity_cuda, mean_fidelity_plain

__all__ = ["mean_fidelity_local"]


def mean_fidelity_local(pulses: torch.Tensor, q_target: torch.Tensor,
                        delta: torch.Tensor, eps: torch.Tensor,
                        backend: str = "xla") -> torch.Tensor:
    """Per-target mean fidelity ``(B,)`` from ``(B, L, P)`` pulses,
    ``(B, 4)`` target quaternions and ``(B, M)`` disorder draws."""
    if backend == "pallas":
        return mean_fidelity_cuda(pulses, q_target, delta, eps)
    if backend == "xla":
        return mean_fidelity_plain(pulses, q_target, delta, eps)
    raise ValueError(f"unknown backend {backend!r} (want 'xla' or 'pallas')")
