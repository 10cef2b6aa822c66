r"""The Monte-Carlo objective, on one device or sharded over a mesh.

The backend names are the JAX package's, so later slices map 1:1:
``"xla"`` is the eager PyTorch path, ``"xla_remat"`` the same with the
segment scan under ``torch.utils.checkpoint`` (``propagate_mc(method=
"scan_remat")``), and ``"pallas"`` the hand-written kernel B1 (on CPU
tensors B1's wrapper computes its plain version).  All are differentiable:
``"xla"`` and ``"xla_remat"`` by autograd, ``"pallas"`` through B1's
backward (B3 and B2).

:func:`make_mean_fidelity` lifts the local objective onto a ``(data, mc)``
mesh (:mod:`.mesh`): each rank runs it on its block and every rank holds
the global mean.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.propagate import propagate_mc
from ..core.su2 import quat_fidelity
from ..ops.propagate_su2 import mean_fidelity_cuda, mean_fidelity_plain
from ..utils.tracing import span
from .mesh import Mesh

__all__ = ["make_mean_fidelity", "mean_fidelity_local"]


@span("mc.mean_fidelity")
def mean_fidelity_local(pulses: torch.Tensor, q_target: torch.Tensor,
                        delta: torch.Tensor, eps: torch.Tensor,
                        backend: str = "xla") -> torch.Tensor:
    """Per-target mean fidelity ``(B,)`` from ``(B, L, P)`` pulses,
    ``(B, 4)`` target quaternions and ``(B, M)`` disorder draws."""
    if backend == "pallas":
        return mean_fidelity_cuda(pulses, q_target, delta, eps)
    if backend == "xla":
        return mean_fidelity_plain(pulses, q_target, delta, eps)
    if backend == "xla_remat":
        q = propagate_mc(pulses, delta, eps, method="scan_remat")
        return torch.mean(quat_fidelity(q, q_target[:, None, :]), dim=1)
    raise ValueError(f"unknown backend {backend!r} (want 'xla', 'xla_remat' or 'pallas')")


def make_mean_fidelity(mesh: Optional[Mesh] = None, backend: str = "xla"):
    """Build ``mean_fid(pulses, q_target, delta, eps) -> scalar E[F]``.

    Without a mesh: the local computation.  With one, the arguments are the
    rank's blocks (pulses and targets sharded over ``data``, the disorder
    over ``(data, mc)``: :func:`.mesh.shard_spec`) and every rank gets the
    global mean.  Its gradient on a rank is that of the rank's block alone;
    summed over the ranks and scaled by ``mean_fid.grad_scale``
    (``1 / (data·mc)``) it is the global mean's.
    """
    def local(pulses, q_target, delta, eps):
        return torch.mean(mean_fidelity_local(pulses, q_target, delta, eps, backend))

    if mesh is None:
        local.grad_scale = 1.0
        return local

    def mean_fid(pulses, q_target, delta, eps):
        return mesh.all_mean(local(pulses, q_target, delta, eps))

    mean_fid.grad_scale = 1.0 / mesh.size
    return mean_fid
