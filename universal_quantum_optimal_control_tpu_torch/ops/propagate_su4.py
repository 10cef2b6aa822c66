r"""SU(4) Monte-Carlo kernels B6 and B7: wrappers, plain versions, counters.

Two hand-written CUDA kernels (``csrc/propagate_su4.cu``, built by
:mod:`._build`) replace the JAX package's Pallas kernels in
``ops/propagate_su4_pallas.py``:

* :func:`propagate_su4_mc_cuda` (B7, replaces ``_prop_kernel``):
  ``(B, L, P)`` pulses, ``(B, M)`` δ₁, δ₂ and ε → the per-sample product
  as (re, im), each ``(B, M, 4, 4)``.
* :func:`mean_fidelity_su4_cuda` (B6, replaces ``_fid_kernel``): the same
  and ``(B, 4, 4)`` target re and im → ``(B,)`` per-target mean
  entanglement fidelity.

P = 2 ``(φ, τ)`` (Ω ≡ 1), P = 3 ``(φ, Ω, τ)``, or P = 4 ``(φ₁, φ₂, Ω, τ)``
on the drive2 system only.  The kernels hard-code the order-8
Paterson–Stockmeyer exponential (``system.expm_order`` must be 8) and run
``system.expm_scaling`` squarings.  All tensors are f32.  On CPU tensors a
wrapper computes its plain PyTorch version (:mod:`..core.su4`); on CUDA
tensors it launches its kernel or raises — it never falls back.  Neither
kernel has a backward yet (B4 and B5, ``ROADMAP.md`` A.14), so a call whose
input requires a gradient raises on either route.  Each wrapper counts its
kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.su4 import TwoQubitSystem, fidelity_su4_ri, propagate_su4_mc, split_pulses
from ._build import load_library, raise_on
from .propagate_su2 import _MAX_TARGETS, _route

__all__ = [
    "propagate_su4_mc_cuda",
    "mean_fidelity_su4_cuda",
    "propagate_su4_mc_plain",
    "mean_fidelity_su4_plain",
]

# dynamic shared memory a block may use without an opt-in attribute, less
# room for the static target and reduction buffers: 6 floats per segment
_MAX_ROW_BYTES = 47 * 1024
_ROW_FLOATS = 6


def propagate_su4_mc_plain(pulses: torch.Tensor, delta1: torch.Tensor,
                           delta2: torch.Tensor, epsilon: torch.Tensor,
                           system: TwoQubitSystem = TwoQubitSystem()
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B7: eager :func:`..core.su4.propagate_su4_mc`."""
    return propagate_su4_mc(pulses, delta1, delta2, epsilon, system)


def mean_fidelity_su4_plain(pulses: torch.Tensor, target_re: torch.Tensor,
                            target_im: torch.Tensor, delta1: torch.Tensor,
                            delta2: torch.Tensor, epsilon: torch.Tensor,
                            system: TwoQubitSystem = TwoQubitSystem()) -> torch.Tensor:
    """Plain version of B6: eager propagation, fidelity, mean over M."""
    Ur, Ui = propagate_su4_mc(pulses, delta1, delta2, epsilon, system)
    return torch.mean(fidelity_su4_ri(Ur, Ui, target_re[:, None], target_im[:, None]), dim=1)


def _refuse_unported(system: TwoQubitSystem, *tensors: torch.Tensor) -> None:
    """What the kernels do not compute raises on either route, so a wrapper
    computes the same function on the CPU as on the card."""
    if system.expm_order != 8:
        raise NotImplementedError(
            f"the SU(4) kernels hard-code the order-8 Paterson–Stockmeyer "
            f"expm; system.expm_order={system.expm_order} would silently score "
            f"against different math — use the plain version or expm_order=8")
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise NotImplementedError(
            "the SU(4) kernels B6 and B7 have no backward: the training "
            "kernels B4 and B5 are ROADMAP.md A.14; differentiate the plain "
            "version (backend='xla') or call under torch.no_grad()")


def _check(pulses, delta1, delta2, epsilon, system: TwoQubitSystem,
           target_re: Optional[torch.Tensor] = None,
           target_im: Optional[torch.Tensor] = None) -> Tuple[int, int, int, int]:
    """Validate the kernels' inputs; returns ``(B, L, P, M)``."""
    named = {"pulses": pulses, "delta1": delta1, "delta2": delta2, "epsilon": epsilon}
    if target_re is not None:
        named.update(target_re=target_re, target_im=target_im)
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pulses.dim() != 3:
        raise ValueError(f"pulses must be (B, L, P), got {tuple(pulses.shape)}")
    split_pulses(pulses, system.drive2)  # raises on a P the system does not take
    if not 0 <= system.expm_scaling <= 30:
        raise ValueError(f"system.expm_scaling must lie in [0, 30], got "
                         f"{system.expm_scaling}")
    B, L, P = pulses.shape
    if delta1.dim() != 2 or delta1.shape[0] != B or \
            delta2.shape != delta1.shape or epsilon.shape != delta1.shape:
        raise ValueError(
            f"delta1, delta2 and epsilon must all be (B, M) with B={B}, got "
            f"{tuple(delta1.shape)}, {tuple(delta2.shape)} and {tuple(epsilon.shape)}")
    M = delta1.shape[1]
    if target_re is not None and not (
            tuple(target_re.shape) == tuple(target_im.shape) == (B, 4, 4)):
        raise ValueError(f"target_re and target_im must be ({B}, 4, 4), got "
                         f"{tuple(target_re.shape)} and {tuple(target_im.shape)}")
    if not (1 <= B <= _MAX_TARGETS and L >= 1 and M >= 1):
        raise ValueError(f"need 1 <= B <= {_MAX_TARGETS}, L >= 1, M >= 1; "
                         f"got B={B}, L={L}, M={M}")
    if 4 * _ROW_FLOATS * L > _MAX_ROW_BYTES:
        raise ValueError(f"L={L} exceeds the kernels' shared-memory pulse row "
                         f"({_MAX_ROW_BYTES} bytes)")
    return B, L, P, M


def _system_args(system: TwoQubitSystem):
    return float(system.xtalk), float(system.coupling), int(system.expm_scaling)


def _launch_propagate(pulses, delta1, delta2, epsilon, system):
    B, L, P, M = _check(pulses, delta1, delta2, epsilon, system)
    lib = load_library("su4")
    out_re = torch.empty((B, M, 4, 4), dtype=torch.float32, device=pulses.device)
    out_im = torch.empty_like(out_re)
    with torch.cuda.device(pulses.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uqoc_su4_propagate_mc(
            pulses.data_ptr(), delta1.data_ptr(), delta2.data_ptr(), epsilon.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(), B, L, P, M, *_system_args(system),
            stream)
    raise_on(lib, err, "propagate_su4_mc")
    propagate_su4_mc_cuda.launches += 1
    return out_re, out_im


def _launch_mean_fidelity(pulses, target_re, target_im, delta1, delta2, epsilon, system):
    B, L, P, M = _check(pulses, delta1, delta2, epsilon, system, target_re, target_im)
    lib = load_library("su4")
    dev = pulses.device
    partials = torch.empty((B, lib.uqoc_su4_num_blocks(M)), dtype=torch.float32, device=dev)
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uqoc_su4_mean_fidelity(
            pulses.data_ptr(), target_re.data_ptr(), target_im.data_ptr(),
            delta1.data_ptr(), delta2.data_ptr(), epsilon.data_ptr(),
            partials.data_ptr(), out.data_ptr(), B, L, P, M, *_system_args(system),
            stream)
    raise_on(lib, err, "mean_fidelity_su4")
    mean_fidelity_su4_cuda.launches += 1
    return out


def propagate_su4_mc_cuda(pulses: torch.Tensor, delta1: torch.Tensor,
                          delta2: torch.Tensor, epsilon: torch.Tensor,
                          system: TwoQubitSystem = TwoQubitSystem()
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7: per-sample products (re, im), each ``(B, M, 4, 4)``."""
    _refuse_unported(system, pulses, delta1, delta2, epsilon)
    if _route(pulses, delta1, delta2, epsilon) == "cpu":
        return propagate_su4_mc_plain(pulses, delta1, delta2, epsilon, system)
    return _launch_propagate(pulses, delta1, delta2, epsilon, system)


propagate_su4_mc_cuda.launches = 0


def mean_fidelity_su4_cuda(pulses: torch.Tensor, target_re: torch.Tensor,
                           target_im: torch.Tensor, delta1: torch.Tensor,
                           delta2: torch.Tensor, epsilon: torch.Tensor,
                           system: TwoQubitSystem = TwoQubitSystem()) -> torch.Tensor:
    """B6: per-target mean entanglement fidelity ``(B,)``."""
    tensors = (pulses, target_re, target_im, delta1, delta2, epsilon)
    _refuse_unported(system, *tensors)
    if _route(*tensors) == "cpu":
        return mean_fidelity_su4_plain(*tensors, system)
    return _launch_mean_fidelity(*tensors, system)


mean_fidelity_su4_cuda.launches = 0
