r"""SU(2) Monte-Carlo kernels B1, B2 and B3: wrappers, plain versions, counters.

Three hand-written CUDA kernels (``csrc/propagate_su2.cu``, built by
:mod:`._build`) replace the JAX package's Pallas kernels in
``ops/propagate_pallas.py`` and ``ops/propagate_pallas_bwd.py``:

* :func:`propagate_mc_cuda` (B3, replaces ``_prop_kernel``):
  ``(B, L, P)`` pulses, ``(B, M)`` δ and ε → ``(B, M, 4)`` quaternions.
  Differentiable: its backward is B2.
* :func:`mean_fidelity_cuda` (B1, replaces ``_fid_kernel``):
  ``(B, L, P)`` pulses, ``(B, 4)`` targets, ``(B, M)`` δ and ε → ``(B,)``
  per-target mean entanglement fidelity.  Differentiable in all four
  inputs: its backward re-runs B3 for the per-sample quaternions, seeds
  the cotangent analytically and runs B2, as ``_mf_bwd`` does.
* :func:`propagate_mc_vjp_cuda` (B2, replaces ``_bwd_kernel``): the VJP of
  B3, cotangent ``(B, M, 4)`` → ``(dpulses (B, L, P), dδ (B, M), dε (B, M))``,
  swept from B3's per-sample product (the caller's, or one B3 launch).

P ∈ {2, 3, 4}: ``(φ, τ)``, ``(φ, Ω, τ)`` or ``(φ, Ω, Δ, τ)``.  All tensors
are f32.  On CPU tensors a wrapper computes its plain PyTorch version
(differentiable by autograd); on CUDA tensors it launches its kernel or
raises — it never falls back.  Each wrapper counts its kernel launches in
its ``launches`` attribute, wherever the launch happens (a backward pass
counts too).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.autograd.function import once_differentiable

from ..core.propagate import propagate_mc
from ..core.su2 import quat_fidelity
from ..utils.tracing import span
from ._build import load_library, raise_on

__all__ = [
    "propagate_mc_cuda",
    "mean_fidelity_cuda",
    "propagate_mc_vjp_cuda",
    "propagate_mc_plain",
    "mean_fidelity_plain",
    "propagate_mc_vjp_plain",
]

_MAX_TARGETS = 65535  # grid.y limit

# per (device, stream): B1's per-target ticket counters, zeroed eagerly and
# zero between launches (each launch sets back what it drew)
_tickets: Dict[Tuple[int, int], torch.Tensor] = {}


def propagate_mc_plain(pulses: torch.Tensor, delta: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
    """Plain version of B3: eager :func:`..core.propagate.propagate_mc`."""
    return propagate_mc(pulses, delta, eps)


def mean_fidelity_plain(pulses: torch.Tensor, q_target: torch.Tensor,
                        delta: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: eager propagation, fidelity, mean over M."""
    q = propagate_mc(pulses, delta, eps)
    return torch.mean(quat_fidelity(q, q_target[:, None, :]), dim=1)


def propagate_mc_vjp_plain(pulses: torch.Tensor, delta: torch.Tensor,
                           eps: torch.Tensor, g: torch.Tensor
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of B2: autograd through the eager propagator with
    cotangent ``g``."""
    with torch.enable_grad():
        p, d, e = (t.detach().requires_grad_(True) for t in (pulses, delta, eps))
        q = propagate_mc(p, d, e)
        return torch.autograd.grad(q, (p, d, e), g)


def _route(*tensors: torch.Tensor) -> str:
    """``"cpu"`` (plain version) or ``"cuda"`` (kernel); anything else raises."""
    types = {t.device.type for t in tensors}
    if types == {"cpu"}:
        return "cpu"
    if types == {"cuda"} and len({t.device for t in tensors}) == 1:
        return "cuda"
    raise ValueError(
        f"tensors must all lie on the CPU or all on one CUDA device, got "
        f"{sorted(str(t.device) for t in tensors)}")


def _ticket_counters(dev: torch.device, stream: int, B: int) -> torch.Tensor:
    """B1's counters for a launch on ``stream``.  Under CUDA graph capture a
    fresh zeroed buffer: the graph replays its zeroing before each launch,
    and the cache keeps only counters that were zeroed when it filled."""
    if torch.cuda.is_current_stream_capturing():
        return torch.zeros((B,), dtype=torch.int32, device=dev)
    key = (dev.index, stream)
    t = _tickets.get(key)
    if t is None or t.numel() < B:
        t = torch.zeros((max(B, 256),), dtype=torch.int32, device=dev)
        _tickets[key] = t
    return t


def _check(pulses: torch.Tensor, delta: torch.Tensor, eps: torch.Tensor,
           q_target: Optional[torch.Tensor] = None,
           g: Optional[torch.Tensor] = None,
           q: Optional[torch.Tensor] = None) -> Tuple[int, int, int, int]:
    """Validate the kernels' inputs; ``g`` is B2's cotangent, ``q`` its
    product input.  A row longer than the card's shared memory takes is
    refused by the launcher (``uqoc_su2_max_len``), which raises."""
    named = {"pulses": pulses, "delta": delta, "eps": eps}
    if q_target is not None:
        named["q_target"] = q_target
    if g is not None:
        named["g"] = g
    if q is not None:
        named["q"] = q
    for name, t in named.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if pulses.dim() != 3 or pulses.shape[-1] not in (2, 3, 4):
        raise ValueError(
            f"pulses must be (B, L, P) with P in (2, 3, 4), got "
            f"{tuple(pulses.shape)}")
    B, L, P = pulses.shape
    if delta.dim() != 2 or delta.shape[0] != B or eps.shape != delta.shape:
        raise ValueError(
            f"delta and eps must both be (B, M) with B={B}, got "
            f"{tuple(delta.shape)} and {tuple(eps.shape)}")
    M = delta.shape[1]
    if q_target is not None and tuple(q_target.shape) != (B, 4):
        raise ValueError(f"q_target must be ({B}, 4), got {tuple(q_target.shape)}")
    if g is not None and tuple(g.shape) != (B, M, 4):
        raise ValueError(f"g must be ({B}, {M}, 4), got {tuple(g.shape)}")
    if q is not None and tuple(q.shape) != (B, M, 4):
        raise ValueError(f"q must be ({B}, {M}, 4), got {tuple(q.shape)}")
    if not (1 <= B <= _MAX_TARGETS and L >= 1 and M >= 1):
        raise ValueError(f"need 1 <= B <= {_MAX_TARGETS}, L >= 1, M >= 1; "
                         f"got B={B}, L={L}, M={M}")
    return B, L, P, M


def _launch_propagate_mc(pulses, delta, eps) -> torch.Tensor:
    B, L, P, M = _check(pulses, delta, eps)
    lib = load_library("su2")
    out = torch.empty((B, M, 4), dtype=torch.float32, device=pulses.device)
    with torch.cuda.device(pulses.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uqoc_su2_propagate_mc(
            pulses.data_ptr(), delta.data_ptr(), eps.data_ptr(),
            out.data_ptr(), B, L, P, M, stream)
    raise_on(lib, err, "propagate_mc")
    propagate_mc_cuda.launches += 1
    return out


def _launch_mean_fidelity(pulses, q_target, delta, eps) -> torch.Tensor:
    B, L, P, M = _check(pulses, delta, eps, q_target)
    lib = load_library("su2")
    partials = torch.empty((B, lib.uqoc_su2_num_blocks(M)), dtype=torch.float32,
                           device=pulses.device)
    out = torch.empty((B,), dtype=torch.float32, device=pulses.device)
    with torch.cuda.device(pulses.device):
        stream = torch.cuda.current_stream().cuda_stream
        tickets = _ticket_counters(pulses.device, stream, B)
        err = lib.uqoc_su2_mean_fidelity(
            pulses.data_ptr(), q_target.data_ptr(), delta.data_ptr(),
            eps.data_ptr(), partials.data_ptr(), tickets.data_ptr(), out.data_ptr(),
            B, L, P, M, stream)
    raise_on(lib, err, "mean_fidelity")
    mean_fidelity_cuda.launches += 1
    return out


def _launch_vjp(pulses, delta, eps, g, q):
    """B2 on B3's product ``q`` of the same inputs."""
    B, L, P, M = _check(pulses, delta, eps, g=g, q=q)
    lib = load_library("su2")
    dev = pulses.device
    partials = torch.empty((B, lib.uqoc_su2_vjp_num_blocks(M), L * P),
                           dtype=torch.float32, device=dev)
    dpulses = torch.empty((B, L, P), dtype=torch.float32, device=dev)
    ddelta = torch.empty((B, M), dtype=torch.float32, device=dev)
    deps = torch.empty((B, M), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uqoc_su2_propagate_mc_vjp(
            pulses.data_ptr(), delta.data_ptr(), eps.data_ptr(), g.data_ptr(),
            q.data_ptr(), partials.data_ptr(), dpulses.data_ptr(), ddelta.data_ptr(),
            deps.data_ptr(), B, L, P, M, stream)
    raise_on(lib, err, "propagate_mc_vjp")
    propagate_mc_vjp_cuda.launches += 1
    return dpulses, ddelta, deps


def _needed(ctx, *grads):
    return tuple(gr if need else None for gr, need in zip(grads, ctx.needs_input_grad))


class _PropagateMC(torch.autograd.Function):
    """B3 forward, B2 backward (``propagate_mc_pallas``'s custom VJP); the
    forward's product is kept for the backward only where a gradient is
    needed."""

    @staticmethod
    def forward(ctx, pulses, delta, eps):
        q = _launch_propagate_mc(pulses, delta, eps)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(pulses, delta, eps, q)
        return q

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        pulses, delta, eps, q = ctx.saved_tensors
        return _needed(ctx, *_launch_vjp(pulses, delta, eps, g.contiguous(), q))


class _MeanFidelity(torch.autograd.Function):
    """B1 forward; backward as ``_mf_bwd``: B3 for the per-sample
    quaternions, the fidelity's cotangent in closed form, then B2.

    ḡ is a per-target ``(B,)`` cotangent.  The TPU backward switches B3 and
    B2 to a sign-free half-angle sincos, valid only because every parity
    sign cancels there (``ROADMAP.md`` §C, the sign trap).  The CUDA B3
    resolves every sign (``csrc/su2.cuh``), so the backward reuses B3 as it
    is, and B2 sweeps from that product.
    """

    @staticmethod
    def forward(ctx, pulses, q_target, delta, eps):
        ctx.save_for_backward(pulses, q_target, delta, eps)
        return _launch_mean_fidelity(pulses, q_target, delta, eps)

    @staticmethod
    @span("mc.mean_fidelity.backward")
    @once_differentiable
    def backward(ctx, gbar):
        pulses, q_target, delta, eps = ctx.saved_tensors
        M = delta.shape[1]
        q = _launch_propagate_mc(pulses, delta, eps)           # (B, M, 4)
        inner = torch.sum(q * q_target[:, None, :], dim=-1)    # ⟨q, q_t⟩
        # F_b = mean_m (4·inner² + 2)/6  ⇒  dF_b/dq = (8/6)·inner·q_t / M
        scale = (8.0 / 6.0) * inner * gbar[:, None] / M        # (B, M)
        g_q = (scale[..., None] * q_target[:, None, :]).contiguous()
        d_pulses, d_delta, d_eps = _launch_vjp(pulses, delta, eps, g_q, q)
        d_qt = torch.sum(scale[..., None] * q, dim=1)          # (B, 4)
        return _needed(ctx, d_pulses, d_qt, d_delta, d_eps)


def propagate_mc_cuda(pulses: torch.Tensor, delta: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
    """B3: per-sample product quaternions ``(B, M, 4)``; backward B2."""
    if _route(pulses, delta, eps) == "cpu":
        return propagate_mc_plain(pulses, delta, eps)
    return _PropagateMC.apply(pulses, delta, eps)


propagate_mc_cuda.launches = 0


def mean_fidelity_cuda(pulses: torch.Tensor, q_target: torch.Tensor,
                       delta: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """B1: per-target mean entanglement fidelity ``(B,)``; backward B3 + B2."""
    if _route(pulses, q_target, delta, eps) == "cpu":
        return mean_fidelity_plain(pulses, q_target, delta, eps)
    return _MeanFidelity.apply(pulses, q_target, delta, eps)


mean_fidelity_cuda.launches = 0


def propagate_mc_vjp_cuda(pulses: torch.Tensor, delta: torch.Tensor,
                          eps: torch.Tensor, g: torch.Tensor,
                          q: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """B2: VJP of the MC propagator, ``(dpulses, dδ, dε)``.

    ``q``: B3's product ``(B, M, 4)`` of the same inputs, where the caller
    holds it; else B3 forms it first (one launch, counted in
    ``propagate_mc_cuda.launches``).  The plain version needs no ``q``.
    """
    tensors = (pulses, delta, eps, g) + (() if q is None else (q,))
    if _route(*tensors) == "cpu":
        return propagate_mc_vjp_plain(pulses, delta, eps, g)
    if q is None:
        q = _launch_propagate_mc(pulses, delta, eps)
    return _launch_vjp(pulses, delta, eps, g, q)


propagate_mc_vjp_cuda.launches = 0
