r"""The single-qubit system the trainer drives (port of ``training/systems.py``).

A *system* samples its disorder channels and scores a pulse batch against
its targets.  Only the unsharded (``mesh=None``) objectives are ported; the
mesh waits for ``ROADMAP.md`` A.17, and ``SU4System`` for slice 3.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.errors import sample_ore_ple
from ..parallel.mc_parallel import mean_fidelity_local

__all__ = ["SU2System", "make_objective", "make_per_target_objective"]


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet (ROADMAP.md A.17: "
            "parallel/mesh.py and the sharded objective); pass mesh=None")


def make_objective(mesh: Optional[object], local_fn):
    """Lift ``local_fn(pulses, target, errors) -> (B,)`` per-target mean
    fidelities into the batch-mean scalar objective."""
    _no_mesh(mesh)

    def objective(pulses, target, errors):
        return torch.mean(local_fn(pulses, target, errors))
    return objective


def make_per_target_objective(mesh: Optional[object], local_fn):
    """Like :func:`make_objective` but returns the per-target ``(B,)`` mean
    fidelities — the input of the tail-focused (CVaR) loss."""
    _no_mesh(mesh)

    def objective(pulses, target, errors):
        return local_fn(pulses, target, errors)
    return objective


class SU2System:
    """Single-qubit system: ORE+PLE disorder, quaternion targets ``(B, 4)``.

    ``backend``: "xla" (the eager plain path) or "pallas" (kernel B1, whose
    backward runs B3 and B2).
    """

    def __init__(self, backend: str = "xla") -> None:
        self.backend = backend

    def sample_errors(self, generator: torch.Generator, shape, delta_std,
                      epsilon_std):
        return sample_ore_ple(generator, shape, delta_std, epsilon_std)

    def local_mean_fidelity(self, pulses, q_target, errors):
        delta, eps = errors
        return mean_fidelity_local(pulses, q_target, delta, eps, self.backend)
