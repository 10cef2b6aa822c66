r"""SU(2) Monte-Carlo kernels B1 and B3: wrappers, plain versions, counters.

Two hand-written CUDA kernels (``csrc/propagate_su2.cu``, built by
:mod:`._build`) replace the JAX package's Pallas kernels in
``ops/propagate_pallas.py``:

* :func:`propagate_mc_cuda` (B3, replaces ``_prop_kernel``):
  ``(B, L, P)`` pulses, ``(B, M)`` δ and ε → ``(B, M, 4)`` quaternions.
* :func:`mean_fidelity_cuda` (B1, replaces ``_fid_kernel``):
  ``(B, L, P)`` pulses, ``(B, 4)`` targets, ``(B, M)`` δ and ε → ``(B,)``
  per-target mean entanglement fidelity.

P ∈ {2, 3, 4}: ``(φ, τ)``, ``(φ, Ω, τ)`` or ``(φ, Ω, Δ, τ)``.  All tensors
are f32.  On CPU tensors a wrapper computes its plain PyTorch version
(:func:`propagate_mc_plain`, :func:`mean_fidelity_plain`); on CUDA tensors
it launches its kernel or raises — it never falls back.  Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.propagate import propagate_mc
from ..core.su2 import quat_fidelity
from ._build import load_library

__all__ = [
    "propagate_mc_cuda",
    "mean_fidelity_cuda",
    "propagate_mc_plain",
    "mean_fidelity_plain",
]

# dynamic shared memory a block may use without an opt-in attribute, less
# room for the kernels' static reduction buffer
_MAX_ROW_BYTES = 47 * 1024
_MAX_TARGETS = 65535  # grid.y limit


def propagate_mc_plain(pulses: torch.Tensor, delta: torch.Tensor,
                       eps: torch.Tensor) -> torch.Tensor:
    """Plain version of B3: eager :func:`..core.propagate.propagate_mc`."""
    return propagate_mc(pulses, delta, eps)


def mean_fidelity_plain(pulses: torch.Tensor, q_target: torch.Tensor,
                        delta: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """Plain version of B1: eager propagation, fidelity, mean over M."""
    q = propagate_mc(pulses, delta, eps)
    return torch.mean(quat_fidelity(q, q_target[:, None, :]), dim=1)


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


def _check(pulses: torch.Tensor, delta: torch.Tensor, eps: torch.Tensor,
           q_target: Optional[torch.Tensor] = None) -> Tuple[int, int, int, int]:
    named = {"pulses": pulses, "delta": delta, "eps": eps}
    if q_target is not None:
        named["q_target"] = q_target
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
    if not (1 <= B <= _MAX_TARGETS and L >= 1 and M >= 1):
        raise ValueError(f"need 1 <= B <= {_MAX_TARGETS}, L >= 1, M >= 1; "
                         f"got B={B}, L={L}, M={M}")
    if 4 * L * (3 if P == 2 else P + 1) > _MAX_ROW_BYTES:
        raise ValueError(f"L={L} at P={P} exceeds the kernels' shared-memory "
                         f"pulse row ({_MAX_ROW_BYTES} bytes)")
    return B, L, P, M


def _raise_on(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.uqoc_su2_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")


def propagate_mc_cuda(pulses: torch.Tensor, delta: torch.Tensor,
                      eps: torch.Tensor) -> torch.Tensor:
    """B3: per-sample product quaternions ``(B, M, 4)``."""
    if _route(pulses, delta, eps) == "cpu":
        return propagate_mc_plain(pulses, delta, eps)
    B, L, P, M = _check(pulses, delta, eps)
    lib = load_library()
    out = torch.empty((B, M, 4), dtype=torch.float32, device=pulses.device)
    with torch.cuda.device(pulses.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uqoc_su2_propagate_mc(
            pulses.data_ptr(), delta.data_ptr(), eps.data_ptr(),
            out.data_ptr(), B, L, P, M, stream)
    _raise_on(lib, err, "propagate_mc")
    propagate_mc_cuda.launches += 1
    return out


propagate_mc_cuda.launches = 0


def mean_fidelity_cuda(pulses: torch.Tensor, q_target: torch.Tensor,
                       delta: torch.Tensor, eps: torch.Tensor) -> torch.Tensor:
    """B1: per-target mean entanglement fidelity ``(B,)``."""
    if _route(pulses, q_target, delta, eps) == "cpu":
        return mean_fidelity_plain(pulses, q_target, delta, eps)
    B, L, P, M = _check(pulses, delta, eps, q_target)
    lib = load_library()
    partials = torch.empty((B, lib.uqoc_su2_num_blocks(M)), dtype=torch.float32,
                           device=pulses.device)
    out = torch.empty((B,), dtype=torch.float32, device=pulses.device)
    with torch.cuda.device(pulses.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.uqoc_su2_mean_fidelity(
            pulses.data_ptr(), q_target.data_ptr(), delta.data_ptr(),
            eps.data_ptr(), partials.data_ptr(), out.data_ptr(), B, L, P, M,
            stream)
    _raise_on(lib, err, "mean_fidelity")
    mean_fidelity_cuda.launches += 1
    return out


mean_fidelity_cuda.launches = 0
