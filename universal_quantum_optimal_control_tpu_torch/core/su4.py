r"""SU(4) two-qubit propagation in eager PyTorch (port of ``core/su4.py``).

Same physics contract as the JAX package: qubit 1 is driven directly,
qubit 2 sees a cross-talk fraction χ of the drive, each qubit has its own
static off-resonance δᵢ, the drive amplitude carries a shared pulse-length
error ε, and an always-on ZZ coupling J entangles:

    H(φ; δ₁, δ₂, ε) = ½(1+ε)·Ω·[cos φ·X₁ + sin φ·Y₁ + χ·(cos φ·X₂ + sin φ·Y₂)]
                      + ½·(δ₁·Z₁ + δ₂·Z₂) + J·Z₁Z₂

(``drive2`` adds a second direct line on qubit 2 with symmetric cross-talk:
pulses are then (φ₁, φ₂, Ω, τ)).  Unitaries are (real, imag) pairs of
``(..., 4, 4)`` tensors; the segment exponential is the order-8
Paterson–Stockmeyer Taylor series with 4 squarings.

This is the plain version of the SU(4) CUDA kernels B6 and B7
(:mod:`..ops.propagate_su4`) and the CPU oracle the tests hold them to.
Only the ``"ri"`` layout (trailing ``(4, 4)`` matrices) is ported: the JAX
``"soa"`` layout is a TPU tiling of the same numbers (``ROADMAP.md`` A.21).
Every function computes in the dtype of its inputs (f32 or f64).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "TwoQubitSystem",
    "pauli_strings",
    "su4_hamiltonian",
    "expm_taylor_ri",
    "propagate_su4",
    "propagate_su4_mc",
    "split_pulses",
    "fidelity_su4_ri",
    "ri_from_complex",
    "complex_from_ri",
]

_I = np.eye(2)
_X = np.array([[0, 1], [1, 0]], dtype=np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], dtype=np.complex128)
_Z = np.array([[1, 0], [0, -1]], dtype=np.complex128)

# Taylor coefficients 1/k! of the order-8 series
_C = [1.0 / math.factorial(k) for k in range(9)]


def pauli_strings() -> Dict[str, np.ndarray]:
    """Two-qubit Pauli strings as complex128 numpy 4×4 matrices."""
    return {
        "X1": np.kron(_X, _I), "Y1": np.kron(_Y, _I), "Z1": np.kron(_Z, _I),
        "X2": np.kron(_I, _X), "Y2": np.kron(_I, _Y), "Z2": np.kron(_I, _Z),
        "ZZ": np.kron(_Z, _Z), "I": np.eye(4, dtype=np.complex128),
    }


_PAULI = pauli_strings()


class TwoQubitSystem(NamedTuple):
    """Static system parameters: cross-talk fraction χ, ZZ coupling J, the
    segment exponential's Taylor order and squarings, and the ``drive2``
    variant (a second direct drive line on qubit 2; 4-parameter pulses)."""

    xtalk: float = 0.1
    coupling: float = 0.5
    expm_order: int = 8
    expm_scaling: int = 4
    drive2: bool = False


def ri_from_complex(U: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return U.real.to(torch.float32), U.imag.to(torch.float32)


def complex_from_ri(Ur: torch.Tensor, Ui: torch.Tensor) -> torch.Tensor:
    return torch.complex(Ur.to(torch.float32), Ui.to(torch.float32))


def _tables(dtype: torch.dtype, device) -> Tuple[dict, dict]:
    """The Pauli strings as (real, imag) tensors of ``dtype`` on ``device``."""
    re = {k: torch.as_tensor(v.real, dtype=dtype, device=device) for k, v in _PAULI.items()}
    im = {k: torch.as_tensor(v.imag, dtype=dtype, device=device) for k, v in _PAULI.items()}
    return re, im


def su4_hamiltonian(phi: torch.Tensor, delta1: torch.Tensor, delta2: torch.Tensor,
                    epsilon: torch.Tensor, system: TwoQubitSystem,
                    omega: torch.Tensor = None,
                    phi2: torch.Tensor = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """H as a (real, imag) pair ``(..., 4, 4)``, broadcasting over leading axes.

    ``omega`` (optional) scales the drive amplitude (clamped at 0);
    ``phi2`` (optional) adds the drive2 line on qubit 2.
    """
    c, s = torch.cos(phi), torch.sin(phi)
    amp = 0.5 * (1.0 + epsilon)
    if omega is not None:
        amp = amp * torch.clamp(omega, min=0.0)
    chi = system.xtalk
    cx1, cy1 = amp * c, amp * s
    cx2, cy2 = amp * chi * c, amp * chi * s
    if phi2 is not None:
        c2, s2 = torch.cos(phi2), torch.sin(phi2)
        cx2 = cx2 + amp * c2
        cy2 = cy2 + amp * s2
        cx1 = cx1 + amp * chi * c2
        cy1 = cy1 + amp * chi * s2
    shape = torch.broadcast_shapes(phi.shape, delta1.shape, delta2.shape,
                                   epsilon.shape) + (4, 4)
    tables = _tables(cx1.dtype, cx1.device)

    def mix(table):
        return (cx1[..., None, None] * table["X1"]
                + cy1[..., None, None] * table["Y1"]
                + cx2[..., None, None] * table["X2"]
                + cy2[..., None, None] * table["Y2"]
                + (0.5 * delta1)[..., None, None] * table["Z1"]
                + (0.5 * delta2)[..., None, None] * table["Z2"]
                + torch.broadcast_to(system.coupling * table["ZZ"], shape))

    return mix(tables[0]), mix(tables[1])


def _matmul_ri(ar, ai, br, bi):
    """Complex matmul on (re, im) pairs: 3 real matmuls (Karatsuba), as the
    JAX package forms it."""
    k1 = torch.matmul(ar, br + bi)
    k2 = torch.matmul(ar + ai, bi)
    k3 = torch.matmul(ai - ar, br)
    return k1 - k2, k1 + k3


def expm_taylor_ri(Hr: torch.Tensor, Hi: torch.Tensor, tau: torch.Tensor,
                   order: int = 8, scaling: int = 4) -> Tuple[torch.Tensor, torch.Tensor]:
    """``exp(−i·H·τ)`` on (re, im) pairs by a scaled Taylor series and
    ``scaling`` squarings: A = −i·H·τ/2^s ⇒ (Ar, Ai) = (Hi·τ/2^s, −Hr·τ/2^s).

    Order 8 is evaluated Paterson–Stockmeyer style, ``T8 = P + A4·Q`` with
    P, Q cubics in A, A2, A3; any other order runs the plain term chain.
    """
    scale = tau[..., None, None] / (2.0 ** scaling)
    Ar = Hi * scale
    Ai = -Hr * scale
    eye = torch.eye(4, dtype=Ar.dtype, device=Ar.device).expand(Ar.shape)
    c = _C
    if order == 8:
        A2 = _matmul_ri(Ar, Ai, Ar, Ai)
        A3 = _matmul_ri(A2[0], A2[1], Ar, Ai)
        A4 = _matmul_ri(A2[0], A2[1], A2[0], A2[1])
        Pr = c[0] * eye + c[1] * Ar + c[2] * A2[0] + c[3] * A3[0]
        Pi = c[1] * Ai + c[2] * A2[1] + c[3] * A3[1]
        Qr = c[4] * eye + c[5] * Ar + c[6] * A2[0] + c[7] * A3[0] + c[8] * A4[0]
        Qi = c[5] * Ai + c[6] * A2[1] + c[7] * A3[1] + c[8] * A4[1]
        Mr, Mi = _matmul_ri(A4[0], A4[1], Qr, Qi)
        Ur, Ui = Pr + Mr, Pi + Mi
    else:
        Ur, Ui = eye + Ar, Ai
        Tr, Ti = Ar, Ai
        for k in range(2, order + 1):
            Tr, Ti = _matmul_ri(Tr, Ti, Ar / k, Ai / k)
            Ur, Ui = Ur + Tr, Ui + Ti
    for _ in range(scaling):
        Ur, Ui = _matmul_ri(Ur, Ui, Ur, Ui)
    return Ur, Ui


def split_pulses(pulses: torch.Tensor, drive2: bool):
    """``(..., L, P)`` → ``(φ, φ₂, Ω, τ)`` columns ``(..., L)``, absent ones
    None: P = 2 (φ, τ), P = 3 (φ, Ω, τ), or P = 4 (φ₁, φ₂, Ω, τ), which
    needs ``drive2``; ``drive2`` with another P raises."""
    P = pulses.shape[-1]
    if drive2:
        if P != 4:
            raise ValueError(
                f"system.drive2 expects 4-parameter pulses (phi1, phi2, "
                f"omega, tau); got P={P}")
        return pulses[..., 0], pulses[..., 1], pulses[..., 2], pulses[..., 3]
    if P not in (2, 3):
        raise ValueError(f"unsupported pulse parameter count: {P} "
                         f"(4-parameter pulses require drive2=True)")
    return pulses[..., 0], None, (pulses[..., 1] if P == 3 else None), pulses[..., -1]


def propagate_su4(pulses: torch.Tensor, delta1: torch.Tensor, delta2: torch.Tensor,
                  epsilon: torch.Tensor, system: TwoQubitSystem = TwoQubitSystem(),
                  layout: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Compose ``U_L ⋯ U_1`` for two-qubit pulse sequences.

    pulses ``(..., L, P)`` (see :func:`split_pulses`); disorder ``(...)``
    each, broadcasting against the pulses' leading axes.  Returns the
    (re, im) pair ``(..., 4, 4)``.  One segment at a time, so the memory is
    that of one batch of 4×4 matrices at any L.

    ``layout``: ``"ri"`` or ``"auto"`` (the same here); ``"soa"`` is the
    JAX package's TPU tiling and is not ported (``ROADMAP.md`` A.21).
    """
    if layout == "soa":
        raise NotImplementedError(
            "layout='soa' is the JAX package's TPU tiling of the same numbers "
            "and is not ported (ROADMAP.md A.21); use layout='ri'")
    if layout not in ("ri", "auto"):
        raise ValueError(f"unknown layout {layout!r} (soa | ri | auto)")
    phi, phi2, omega, tau = split_pulses(pulses, system.drive2)
    batch = torch.broadcast_shapes(phi.shape[:-1], delta1.shape, delta2.shape,
                                   epsilon.shape)
    dtype = torch.promote_types(pulses.dtype, delta1.dtype)
    Ur = torch.eye(4, dtype=dtype, device=pulses.device).expand(batch + (4, 4))
    Ui = torch.zeros(batch + (4, 4), dtype=dtype, device=pulses.device)

    def at(x, k):
        return None if x is None else x[..., k]

    for k in range(pulses.shape[-2]):
        Hr, Hi = su4_hamiltonian(phi[..., k], delta1, delta2, epsilon, system,
                                 omega=at(omega, k), phi2=at(phi2, k))
        Ukr, Uki = expm_taylor_ri(Hr, Hi, torch.broadcast_to(tau[..., k], batch),
                                  order=system.expm_order, scaling=system.expm_scaling)
        Ur, Ui = _matmul_ri(Ukr, Uki, Ur, Ui)
    return Ur, Ui


def propagate_su4_mc(pulses: torch.Tensor, delta1: torch.Tensor, delta2: torch.Tensor,
                     epsilon: torch.Tensor, system: TwoQubitSystem = TwoQubitSystem(),
                     layout: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Monte-Carlo form: pulses ``(B, L, P)``, disorder ``(B, M)`` →
    (re, im) ``(B, M, 4, 4)``."""
    return propagate_su4(pulses[:, None], delta1, delta2, epsilon, system, layout)


def fidelity_su4_ri(Ur: torch.Tensor, Ui: torch.Tensor, Tr: torch.Tensor,
                    Ti: torch.Tensor) -> torch.Tensor:
    """Entanglement fidelity ``(|Tr(U†T)|² + d)/(d(d+1))``, d = 4, on
    (re, im) pairs: Tr(U†T) = Σ (Ur·Tr + Ui·Ti) + i·Σ (Ur·Ti − Ui·Tr)."""
    re = torch.sum(Ur * Tr + Ui * Ti, dim=(-2, -1))
    im = torch.sum(Ur * Ti - Ui * Tr, dim=(-2, -1))
    return (re * re + im * im + 4.0) / 20.0
