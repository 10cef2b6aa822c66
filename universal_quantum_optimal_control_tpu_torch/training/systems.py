r"""The systems the trainer drives (port of ``training/systems.py``).

A *system* samples its disorder channels and scores a pulse batch against
its targets: :class:`SU2System` (single qubit) and :class:`SU4System` (two
qubits).  Both train on either backend, on one device or sharded over a
``(data, mc)`` mesh (:mod:`..parallel.mesh`) by :func:`make_objective` and
:func:`make_per_target_objective`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core import su4 as su4_mod
from ..core.errors import sample_ore_ple
from ..ops.propagate_su4 import mean_fidelity_su4_cuda, mean_fidelity_su4_plain
from ..parallel.mc_parallel import mean_fidelity_local
from ..parallel.mesh import MC_AXIS, Mesh
from ..utils.tracing import span

__all__ = ["SU2System", "SU4System", "make_objective", "make_per_target_objective"]


def make_objective(mesh: Optional[Mesh], local_fn):
    """Lift ``local_fn(pulses, target, errors) -> (B,)`` per-target mean
    fidelities into the batch-mean scalar objective.

    On a mesh the arguments are the rank's blocks (pulses and targets
    sharded over ``data``, each disorder channel over ``(data, mc)``) and
    every rank gets the global mean.  The gradient on a rank is that of its
    block's mean alone: the global one is the sum over the ranks times
    ``objective.grad_scale = 1 / (data·mc)``, the mean of equal blocks.
    """
    def objective(pulses, target, errors):
        f = torch.mean(local_fn(pulses, target, errors))
        return f if mesh is None else mesh.all_mean(f)

    objective.grad_scale = 1.0 if mesh is None else 1.0 / mesh.size
    return objective


def make_per_target_objective(mesh: Optional[Mesh], local_fn):
    """Like :func:`make_objective` but returns the per-target ``(B,)`` mean
    fidelities — the input of the tail-focused (CVaR) loss.

    On a mesh each target's mean is over its mc row and the result stays
    sharded over ``data`` (the rank's rows); the caller gathers the global
    batch (:meth:`..parallel.mesh.Mesh.gather`).  A target's mean over M
    is the mean of its ``mc`` blocks' means, whose gradients each rank sees
    unscaled, so the global gradient is the sum over the ranks times
    ``objective.grad_scale = 1 / mc``.
    """
    def objective(pulses, target, errors):
        f = local_fn(pulses, target, errors)
        return f if mesh is None else mesh.all_mean(f, MC_AXIS)

    objective.grad_scale = 1.0 if mesh is None else 1.0 / mesh.mc
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


class SU4System:
    """Two-qubit system: independent per-qubit off-resonance δ₁, δ₂ and a
    shared pulse-length error ε; targets are (re, im) 4×4 pairs stacked
    into ``(B, 2, 4, 4)``.

    ``backend``: "xla" (the eager plain path, differentiable by autograd)
    or "pallas" (kernel B6; under autograd B4 forward and B5 backward, as
    the JAX package's ``mean_fidelity_su4_trainable``).  The kernels
    hard-code the order-8 exponential: another ``expm_order`` raises.
    """

    def __init__(self, xtalk: float = 0.1, coupling: float = 0.5,
                 backend: str = "xla", drive2: bool = False) -> None:
        self.system = su4_mod.TwoQubitSystem(xtalk=xtalk, coupling=coupling,
                                             drive2=drive2)
        self.backend = backend

    @staticmethod
    def pack_target(U) -> torch.Tensor:
        """Complex ``(B, 4, 4)`` targets → real f32 ``(B, 2, 4, 4)`` on the
        CPU (split in numpy on the host)."""
        U = np.asarray(U)
        return torch.from_numpy(np.stack([U.real, U.imag], axis=1).astype(np.float32))

    def sample_errors(self, generator: torch.Generator, shape, delta_std,
                      epsilon_std):
        """``(δ₁, δ₂, ε)``, each gaussian of ``shape`` on the generator's
        device, drawn in that order."""
        def draw():
            return torch.randn(shape, generator=generator, device=generator.device)
        delta1 = draw() * delta_std
        delta2 = draw() * delta_std
        return delta1, delta2, draw() * epsilon_std

    @span("mc.mean_fidelity")
    def local_mean_fidelity(self, pulses, target, errors):
        delta1, delta2, eps = errors
        args = (pulses, target[:, 0].contiguous(), target[:, 1].contiguous(),
                delta1, delta2, eps, self.system)
        if self.backend == "pallas":
            return mean_fidelity_su4_cuda(*args)
        if self.backend == "xla":
            return mean_fidelity_su4_plain(*args)
        raise ValueError(f"unknown backend {self.backend!r} (want 'xla' or 'pallas')")
