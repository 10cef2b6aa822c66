r"""SU(4) Monte-Carlo kernels B4, B5, B6 and B7: wrappers, plain versions,
counters, and the autograd Function that trains through B4 and B5.

Four hand-written CUDA kernels (``csrc/propagate_su4.cu`` and
``csrc/propagate_su4_bwd.cu``, built by :mod:`._build`) replace the JAX
package's Pallas kernels in ``ops/propagate_su4_pallas.py`` and
``ops/propagate_su4_pallas_bwd.py``:

* :func:`propagate_su4_mc_cuda` (B7, replaces ``_prop_kernel``):
  ``(B, L, P)`` pulses, ``(B, M)`` δ₁, δ₂ and ε → the per-sample product
  as (re, im), each ``(B, M, 4, 4)``.  No backward, as the JAX package's
  ``propagate_su4_mc_pallas`` has none.
* :func:`mean_fidelity_su4_cuda` (B6, replaces ``_fid_kernel``): the same
  and ``(B, 4, 4)`` target re and im → ``(B,)`` per-target mean
  entanglement fidelity.  Differentiable: when an input requires a
  gradient it runs B4 forward and B5 backward, as the JAX package's
  ``mean_fidelity_su4_trainable`` does; otherwise B6 alone.
* :func:`mean_fidelity_su4_with_product_cuda` (B4, replaces
  ``_fid_prod_kernel``): B6 that also returns each sample's product
  ``(B, 32, M)`` (16 re, then 16 im), the residual of B5.
* :func:`su4_objective_vjp_from_product_cuda` (B5, replaces
  ``_bwd_prod_kernel``): the VJP of the mean fidelity under a per-target
  cotangent ``gbar (B,)``, seeded with B4's product → ``(dpulses (B, L, P),
  dδ₁, dδ₂, dε (B, M))``.

P = 2 ``(φ, τ)`` (Ω ≡ 1), P = 3 ``(φ, Ω, τ)``, or P = 4 ``(φ₁, φ₂, Ω, τ)``
on the drive2 system only.  The kernels hard-code the order-8
Paterson–Stockmeyer exponential (``system.expm_order`` must be 8, on either
route) and run ``system.expm_scaling`` squarings.  All tensors are f32.  On
CPU tensors a wrapper computes its plain PyTorch version (:mod:`..core.su4`);
on CUDA tensors it launches its kernel or raises — it never falls back.
Each wrapper counts its kernel launches in its ``launches`` attribute,
wherever the launch happens (a backward pass counts too).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..core.su4 import TwoQubitSystem, fidelity_su4_ri, propagate_su4_mc, split_pulses
from ._build import load_library, raise_on
from .propagate_su2 import _MAX_TARGETS, _route

__all__ = [
    "propagate_su4_mc_cuda",
    "mean_fidelity_su4_cuda",
    "mean_fidelity_su4_with_product_cuda",
    "su4_objective_vjp_from_product_cuda",
    "propagate_su4_mc_plain",
    "mean_fidelity_su4_plain",
    "mean_fidelity_su4_with_product_plain",
    "su4_objective_vjp_from_product_plain",
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


def mean_fidelity_su4_with_product_plain(pulses: torch.Tensor, target_re: torch.Tensor,
                                         target_im: torch.Tensor, delta1: torch.Tensor,
                                         delta2: torch.Tensor, epsilon: torch.Tensor,
                                         system: TwoQubitSystem = TwoQubitSystem()
                                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of B4: B6's plain version and the per-sample products
    ``(B, 32, M)`` (16 re, then 16 im, row-major)."""
    Ur, Ui = propagate_su4_mc(pulses, delta1, delta2, epsilon, system)
    F = torch.mean(fidelity_su4_ri(Ur, Ui, target_re[:, None], target_im[:, None]), dim=1)
    B, M = Ur.shape[:2]
    prod = torch.cat([Ur.reshape(B, M, 16), Ui.reshape(B, M, 16)], dim=-1)
    return F, prod.transpose(1, 2).contiguous()


def su4_objective_vjp_from_product_plain(pulses: torch.Tensor, target_re: torch.Tensor,
                                         target_im: torch.Tensor, delta1: torch.Tensor,
                                         delta2: torch.Tensor, epsilon: torch.Tensor,
                                         gbar: torch.Tensor, prod: torch.Tensor,
                                         system: TwoQubitSystem = TwoQubitSystem()
                                         ) -> Tuple[torch.Tensor, ...]:
    """Plain version of B5: autograd through B6's plain version with
    cotangent ``gbar``.  ``prod`` is the kernel's residual; autograd keeps
    its own and does not read it."""
    del prod
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (pulses, delta1, delta2, epsilon)]
        F = mean_fidelity_su4_plain(leaves[0], target_re.detach(), target_im.detach(),
                                    *leaves[1:], system)
        return torch.autograd.grad(F, leaves, gbar)


def _refuse_unported(system: TwoQubitSystem) -> None:
    """What the kernels do not compute raises on either route, so a wrapper
    computes the same function on the CPU as on the card."""
    if system.expm_order != 8:
        raise NotImplementedError(
            f"the SU(4) kernels hard-code the order-8 Paterson–Stockmeyer "
            f"expm; system.expm_order={system.expm_order} would silently score "
            f"against different math — use the plain version or expm_order=8")


def _needs_grad(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def _check(pulses, delta1, delta2, epsilon, system: TwoQubitSystem,
           target_re: Optional[torch.Tensor] = None,
           target_im: Optional[torch.Tensor] = None,
           gbar: Optional[torch.Tensor] = None,
           prod: Optional[torch.Tensor] = None) -> Tuple[int, int, int, int]:
    """Validate the kernels' inputs; returns ``(B, L, P, M)``.  ``gbar`` and
    ``prod`` (B5's) skip the B4/B6/B7 shared-memory limit: B5's launcher
    opts in to more and reports the card's refusal past its limit."""
    named = {"pulses": pulses, "delta1": delta1, "delta2": delta2, "epsilon": epsilon}
    if target_re is not None:
        named.update(target_re=target_re, target_im=target_im)
    if gbar is not None:
        named.update(gbar=gbar, prod=prod)
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
    if gbar is not None and tuple(gbar.shape) != (B,):
        raise ValueError(f"gbar must be ({B},), got {tuple(gbar.shape)}")
    if prod is not None and tuple(prod.shape) != (B, 32, M):
        raise ValueError(
            f"prod must be ({B}, 32, {M}), the product of "
            f"mean_fidelity_su4_with_product_cuda on the same inputs, got {tuple(prod.shape)}")
    if not (1 <= B <= _MAX_TARGETS and L >= 1 and M >= 1):
        raise ValueError(f"need 1 <= B <= {_MAX_TARGETS}, L >= 1, M >= 1; "
                         f"got B={B}, L={L}, M={M}")
    if gbar is None and 4 * _ROW_FLOATS * L > _MAX_ROW_BYTES:
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


def _launch_mean_fidelity(pulses, target_re, target_im, delta1, delta2, epsilon, system,
                          product: bool = False):
    """B6, or B4 (``product``): returns the means, and B4's product."""
    B, L, P, M = _check(pulses, delta1, delta2, epsilon, system, target_re, target_im)
    lib = load_library("su4")
    dev = pulses.device
    partials = torch.empty((B, lib.uqoc_su4_num_blocks(M)), dtype=torch.float32, device=dev)
    out = torch.empty((B,), dtype=torch.float32, device=dev)
    prod = torch.empty((B, 32, M), dtype=torch.float32, device=dev) if product else None
    args = (pulses.data_ptr(), target_re.data_ptr(), target_im.data_ptr(),
            delta1.data_ptr(), delta2.data_ptr(), epsilon.data_ptr(),
            partials.data_ptr(), out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if product:
            err = lib.uqoc_su4_mean_fidelity_with_product(
                *args, prod.data_ptr(), B, L, P, M, *_system_args(system), stream)
        else:
            err = lib.uqoc_su4_mean_fidelity(*args, B, L, P, M, *_system_args(system), stream)
    if product:
        raise_on(lib, err, "mean_fidelity_su4_with_product")
        mean_fidelity_su4_with_product_cuda.launches += 1
        return out, prod
    raise_on(lib, err, "mean_fidelity_su4")
    mean_fidelity_su4_cuda.launches += 1
    return out


def _launch_vjp(pulses, target_re, target_im, delta1, delta2, epsilon, gbar, prod, system):
    B, L, P, M = _check(pulses, delta1, delta2, epsilon, system, target_re, target_im,
                        gbar, prod)
    lib = load_library("su4_bwd")
    dev = pulses.device
    partials = torch.empty((B, lib.uqoc_su4_vjp_num_blocks(M), L * P), dtype=torch.float32,
                           device=dev)
    dpulses = torch.empty((B, L, P), dtype=torch.float32, device=dev)
    dd1, dd2, deps = (torch.empty((B, M), dtype=torch.float32, device=dev) for _ in range(3))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uqoc_su4_objective_vjp(
            pulses.data_ptr(), target_re.data_ptr(), target_im.data_ptr(), gbar.data_ptr(),
            delta1.data_ptr(), delta2.data_ptr(), epsilon.data_ptr(), prod.data_ptr(),
            partials.data_ptr(), dpulses.data_ptr(), dd1.data_ptr(), dd2.data_ptr(),
            deps.data_ptr(), B, L, P, M, *_system_args(system), stream)
    raise_on(lib, err, "su4_objective_vjp_from_product")
    su4_objective_vjp_from_product_cuda.launches += 1
    return dpulses, dd1, dd2, deps


class _MeanFidelitySU4(torch.autograd.Function):
    """B4 forward, B5 backward (``mean_fidelity_su4_trainable``'s custom
    VJP): the forward saves the inputs and B4's per-sample product, the
    backward runs B5 once.  The targets are data, so their cotangents are
    None (the JAX ``_bwd`` returns zeros)."""

    @staticmethod
    def forward(ctx, pulses, target_re, target_im, delta1, delta2, epsilon, system):
        F, prod = mean_fidelity_su4_with_product_cuda(pulses, target_re, target_im,
                                                      delta1, delta2, epsilon, system)
        ctx.system = system
        ctx.save_for_backward(pulses, target_re, target_im, delta1, delta2, epsilon, prod)
        return F

    @staticmethod
    @once_differentiable
    def backward(ctx, gbar):
        pulses, target_re, target_im, delta1, delta2, epsilon, prod = ctx.saved_tensors
        dp, dd1, dd2, de = su4_objective_vjp_from_product_cuda(
            pulses, target_re, target_im, delta1, delta2, epsilon, gbar.contiguous(), prod,
            ctx.system)
        need = ctx.needs_input_grad
        return (dp if need[0] else None, None, None, dd1 if need[3] else None,
                dd2 if need[4] else None, de if need[5] else None, None)


def propagate_su4_mc_cuda(pulses: torch.Tensor, delta1: torch.Tensor,
                          delta2: torch.Tensor, epsilon: torch.Tensor,
                          system: TwoQubitSystem = TwoQubitSystem()
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7: per-sample products (re, im), each ``(B, M, 4, 4)``."""
    _refuse_unported(system)
    if _needs_grad(pulses, delta1, delta2, epsilon):
        raise NotImplementedError(
            "propagate_su4_mc_cuda (B7) has no backward, as the JAX package's "
            "propagate_su4_mc_pallas has no VJP: differentiate "
            "mean_fidelity_su4_cuda (backward B5) or the plain version, or call "
            "under torch.no_grad()")
    if _route(pulses, delta1, delta2, epsilon) == "cpu":
        return propagate_su4_mc_plain(pulses, delta1, delta2, epsilon, system)
    return _launch_propagate(pulses, delta1, delta2, epsilon, system)


propagate_su4_mc_cuda.launches = 0


def mean_fidelity_su4_cuda(pulses: torch.Tensor, target_re: torch.Tensor,
                           target_im: torch.Tensor, delta1: torch.Tensor,
                           delta2: torch.Tensor, epsilon: torch.Tensor,
                           system: TwoQubitSystem = TwoQubitSystem()) -> torch.Tensor:
    """B6: per-target mean entanglement fidelity ``(B,)``.  Under autograd
    (an input requires a gradient) B4 forward and B5 backward instead."""
    tensors = (pulses, target_re, target_im, delta1, delta2, epsilon)
    _refuse_unported(system)
    route = _route(*tensors)
    if _needs_grad(*tensors):
        return _MeanFidelitySU4.apply(*tensors, system)
    if route == "cpu":
        return mean_fidelity_su4_plain(*tensors, system)
    return _launch_mean_fidelity(*tensors, system)


mean_fidelity_su4_cuda.launches = 0


def mean_fidelity_su4_with_product_cuda(pulses: torch.Tensor, target_re: torch.Tensor,
                                        target_im: torch.Tensor, delta1: torch.Tensor,
                                        delta2: torch.Tensor, epsilon: torch.Tensor,
                                        system: TwoQubitSystem = TwoQubitSystem()
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """B4: the mean fidelity ``(B,)`` and the per-sample products
    ``(B, 32, M)``.  Not differentiable itself: it is the forward of
    :func:`mean_fidelity_su4_cuda` under autograd."""
    tensors = (pulses, target_re, target_im, delta1, delta2, epsilon)
    _refuse_unported(system)
    if _route(*tensors) == "cpu":
        with torch.no_grad():
            return mean_fidelity_su4_with_product_plain(*tensors, system)
    return _launch_mean_fidelity(*tensors, system, product=True)


mean_fidelity_su4_with_product_cuda.launches = 0


def su4_objective_vjp_from_product_cuda(pulses: torch.Tensor, target_re: torch.Tensor,
                                        target_im: torch.Tensor, delta1: torch.Tensor,
                                        delta2: torch.Tensor, epsilon: torch.Tensor,
                                        gbar: torch.Tensor, prod: torch.Tensor,
                                        system: TwoQubitSystem = TwoQubitSystem()
                                        ) -> Tuple[torch.Tensor, ...]:
    """B5: the VJP of the mean fidelity under ``gbar (B,)``, seeded with
    B4's ``prod`` on the same inputs → ``(dpulses, dδ₁, dδ₂, dε)``."""
    tensors = (pulses, target_re, target_im, delta1, delta2, epsilon, gbar, prod)
    _refuse_unported(system)
    if _route(*tensors) == "cpu":
        _check(pulses, delta1, delta2, epsilon, system, target_re, target_im, gbar, prod)
        return su4_objective_vjp_from_product_plain(*tensors, system)
    return _launch_vjp(*tensors, system)


su4_objective_vjp_from_product_cuda.launches = 0
