r"""Monte-Carlo composite-pulse propagation in eager PyTorch.

Four equivalent reductions, each returning the composed propagator
``U_L ⋯ U_2 U_1`` as a quaternion, as the JAX package's XLA paths:

* :func:`propagate_scan` composes left to right (``q ← q_k ∘ q``), building
  one segment at a time so the memory is ``O(B·M)`` at any L.  It is the
  plain version of both SU(2) CUDA kernels (:mod:`..ops.propagate_su2`) and
  the CPU oracle the tests hold them to.
* :func:`propagate_assoc` multiplies neighbouring pairs in a log-depth tree.
* :func:`propagate_scan_remat` runs the scan in ≈ √L chunks under
  ``torch.utils.checkpoint``: the backward keeps one carry a chunk and
  recomputes the segments inside it.
* :func:`propagate_unrolled` is the JAX package's fully unrolled loop; in
  eager PyTorch that is the scan's own ordered loop, so it runs
  :func:`propagate_scan`.

:func:`propagate_mc` broadcasts one pulse table across M disorder samples
without repeating it in memory; :func:`unitary_generator` is the complex
``(B, 2, 2)`` form of the reference's ``batched_unitary_generator``.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from .su2 import (quat_identity, quat_multiply, quat_to_su2, segment_quat,
                  segment_quat_amp, segment_quat_det)

__all__ = [
    "propagate_scan",
    "propagate_assoc",
    "propagate_scan_remat",
    "propagate_unrolled",
    "propagate_mc",
    "unitary_generator",
]


def _segment_quats(pulses: torch.Tensor, delta: torch.Tensor,
                   epsilon: torch.Tensor) -> torch.Tensor:
    """Per-segment quaternions ``(..., L, 4)`` from ``(..., L, P)`` pulses.

    P = 2 → ``(φ, τ)``; P = 3 → ``(φ, Ω, τ)``; P = 4 → ``(φ, Ω, Δ, τ)``.
    ``delta``/``epsilon`` are ``(...)`` and broadcast over the L axis.
    """
    P = pulses.shape[-1]
    d, e = delta[..., None], epsilon[..., None]
    if P == 2:
        return segment_quat(pulses[..., 0], pulses[..., 1], d, e)
    if P == 3:
        return segment_quat_amp(pulses[..., 0], pulses[..., 1],
                                pulses[..., 2], d, e)
    if P == 4:
        return segment_quat_det(pulses[..., 0], pulses[..., 1],
                                pulses[..., 2], pulses[..., 3], d, e)
    raise ValueError(
        f"unsupported pulse parameter count: {P} (want 2, 3 or 4)")


def _compose(q: torch.Tensor, pulses: torch.Tensor, delta: torch.Tensor,
             epsilon: torch.Tensor) -> torch.Tensor:
    """``U_L ⋯ U_1 · U(q)``: the segments of ``pulses`` applied after ``q``."""
    for k in range(pulses.shape[-2]):
        seg = _segment_quats(pulses[..., k:k + 1, :], delta, epsilon)[..., 0, :]
        q = quat_multiply(seg, q)
    return q


def _identity_like(pulses: torch.Tensor, delta: torch.Tensor,
                   epsilon: torch.Tensor) -> torch.Tensor:
    shape = torch.broadcast_shapes(pulses.shape[:-2], delta.shape, epsilon.shape)
    return quat_identity(shape, dtype=pulses.dtype, device=pulses.device)


def propagate_scan(pulses: torch.Tensor, delta: torch.Tensor,
                   epsilon: torch.Tensor) -> torch.Tensor:
    """Compose ``U_L ⋯ U_1``: ``(..., L, P)`` pulses, ``(...)`` disorder →
    ``(..., 4)`` quaternion."""
    return _compose(_identity_like(pulses, delta, epsilon), pulses, delta, epsilon)


def propagate_assoc(pulses: torch.Tensor, delta: torch.Tensor,
                    epsilon: torch.Tensor) -> torch.Tensor:
    """Compose by a log-depth pairwise product tree over L (the JAX
    package's ``lax.associative_scan``, the reference's pairwise tree):
    each level multiplies neighbours ``U_{2i+1} ∘ U_{2i}``, an odd last
    segment carried up as it is."""
    segs = _segment_quats(pulses, delta, epsilon)  # (..., L, 4)
    while segs.shape[-2] > 1:
        n = segs.shape[-2] // 2
        pairs = quat_multiply(segs[..., 1:2 * n:2, :], segs[..., 0:2 * n:2, :])
        segs = torch.cat([pairs, segs[..., 2 * n:, :]], dim=-2)
    return segs[..., 0, :]


def propagate_scan_remat(pulses: torch.Tensor, delta: torch.Tensor,
                         epsilon: torch.Tensor, chunk: int = 0) -> torch.Tensor:
    """Memory-light scan: ``chunk`` segments at a time (``0``: ⌊√L⌋), each
    chunk under ``torch.utils.checkpoint``, so the backward stores one carry
    a chunk and recomputes the chunk's segments: O(√L) memory at about one
    extra forward."""
    L = pulses.shape[-2]
    if chunk <= 0:
        chunk = max(int(L ** 0.5), 1)
    q = _identity_like(pulses, delta, epsilon)
    for start in range(0, L, chunk):
        q = checkpoint(_compose, q, pulses[..., start:start + chunk, :], delta, epsilon,
                       use_reentrant=False)
    return q


def propagate_unrolled(pulses: torch.Tensor, delta: torch.Tensor,
                       epsilon: torch.Tensor) -> torch.Tensor:
    """The JAX package's unrolled product; eagerly it is the same ordered
    loop as :func:`propagate_scan`, which it runs."""
    return propagate_scan(pulses, delta, epsilon)


_METHODS = {"scan": propagate_scan, "assoc": propagate_assoc,
            "scan_remat": propagate_scan_remat, "unrolled": propagate_unrolled}


def _method(method: str):
    if method not in _METHODS:
        raise ValueError(f"unknown method {method!r} (want one of {sorted(_METHODS)})")
    return _METHODS[method]


def propagate_mc(pulses: torch.Tensor, delta: torch.Tensor,
                 epsilon: torch.Tensor, method: str = "scan") -> torch.Tensor:
    """One pulse table per target, M samples: ``(B, L, P)`` pulses and
    ``(B, M)`` disorder → ``(B, M, 4)`` quaternions.  The pulse table
    broadcasts across the M axis without being repeated in memory."""
    return _method(method)(pulses[:, None, :, :], delta, epsilon)


def unitary_generator(pulses: torch.Tensor, error: torch.Tensor,
                      method: str = "scan") -> torch.Tensor:
    """The reference's ``batched_unitary_generator`` contract: ``(B, L, P)``
    pulses and ``(2, B)`` errors (row 0 δ, row 1 ε) → ``(B, 2, 2)``
    complex64 unitaries."""
    return quat_to_su2(_method(method)(pulses, error[0], error[1]))
