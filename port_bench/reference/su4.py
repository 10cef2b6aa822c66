"""SU(4) drive2 Monte-Carlo propagation and fidelity, plain PyTorch.

Two qubits, each with a direct drive line and a cross-talk fraction χ of
the other's, static off-resonances δ₁, δ₂, a shared pulse-length error ε
and an always-on ZZ coupling J.  A segment ``(φ₁, φ₂, Ω, τ)`` evolves by

    H = ½(1+ε)·max(Ω, 0)·[(cos φ₁ + χ cos φ₂)X₁ + (sin φ₁ + χ sin φ₂)Y₁
                          + (χ cos φ₁ + cos φ₂)X₂ + (χ sin φ₁ + sin φ₂)Y₂]
        + ½(δ₁Z₁ + δ₂Z₂) + J·Z₁Z₂,

and ``exp(−iHτ)`` is the order-8 Taylor series of ``A = −iHτ/2⁴`` squared
four times (the configuration's ``expm_order`` and ``expm_scaling``),
here by Horner's rule with complex products of four real ones.  Matrices
are (real, imaginary) pairs of ``(..., 4, 4)`` tensors; the entanglement
fidelity is ``(|Tr(U†T)|² + 4)/20``.
"""

from __future__ import annotations

import numpy as np
import torch

from . import elementwise_dtype

_X = np.array([[0, 1], [1, 0]], np.complex128)
_Y = np.array([[0, -1j], [1j, 0]], np.complex128)
_Z = np.array([[1, 0], [0, -1]], np.complex128)
_I2 = np.eye(2)
PAULI = {"X1": np.kron(_X, _I2), "Y1": np.kron(_Y, _I2), "Z1": np.kron(_Z, _I2),
         "X2": np.kron(_I2, _X), "Y2": np.kron(_I2, _Y), "Z2": np.kron(_I2, _Z),
         "ZZ": np.kron(_Z, _Z)}


def cmul(ar, ai, br, bi):
    """Complex matrix product on (re, im) pairs."""
    return ar @ br - ai @ bi, ar @ bi + ai @ br


def hamiltonian(pulse, delta1, delta2, eps, xtalk: float, coupling: float):
    """``H`` as a (re, im) pair ``(..., 4, 4)``; ``pulse`` is ``(..., 4)``."""
    phi1, phi2, omega, _ = pulse.unbind(-1)
    amp = 0.5 * (1.0 + eps) * torch.clamp(omega, min=0.0)
    c1, s1, c2, s2 = torch.cos(phi1), torch.sin(phi1), torch.cos(phi2), torch.sin(phi2)
    coef = {"X1": amp * (c1 + xtalk * c2), "Y1": amp * (s1 + xtalk * s2),
            "X2": amp * (xtalk * c1 + c2), "Y2": amp * (xtalk * s1 + s2),
            "Z1": 0.5 * delta1, "Z2": 0.5 * delta2}
    dt, dev = amp.dtype, amp.device
    hr = coupling * torch.as_tensor(PAULI["ZZ"].real, dtype=dt, device=dev)
    hi = torch.zeros_like(hr)
    for name, c in coef.items():
        hr = hr + c[..., None, None] * torch.as_tensor(PAULI[name].real, dtype=dt, device=dev)
        hi = hi + c[..., None, None] * torch.as_tensor(PAULI[name].imag, dtype=dt, device=dev)
    return hr, hi


def expm(hr, hi, tau, order: int, scaling: int):
    """``exp(−iHτ)``: Taylor series of order ``order`` on ``A = −iHτ/2^s``,
    then ``s = scaling`` squarings."""
    scale = tau[..., None, None] / float(2 ** scaling)
    ar, ai = hi * scale, -hr * scale
    eye = torch.eye(4, dtype=ar.dtype, device=ar.device).expand(ar.shape)
    ur, ui = eye, torch.zeros_like(ar)
    for k in range(order, 0, -1):          # I + (A/k)(I + ...)
        tr, ti = cmul(ar / k, ai / k, ur, ui)
        ur, ui = eye + tr, ti
    for _ in range(scaling):
        ur, ui = cmul(ur, ui, ur, ui)
    return ur, ui


def propagate(pulses, delta1, delta2, eps, system: dict, precision: str = "f32"):
    """``(B, L, 4)`` pulses, ``(B, M)`` disorder → (re, im) ``(B, M, 4, 4)``."""
    return _propagate(pulses, delta1, delta2, eps, system, elementwise_dtype(precision))


def _propagate(pulses, delta1, delta2, eps, system: dict, dt: torch.dtype):
    pulses, delta1, delta2, eps = (t.to(dt) for t in (pulses, delta1, delta2, eps))
    shape = delta1.shape + (4, 4)
    ur = torch.eye(4, dtype=dt, device=pulses.device).expand(shape)
    ui = torch.zeros(shape, dtype=dt, device=pulses.device)
    for k in range(pulses.shape[1]):
        seg = pulses[:, k, None, :]
        hr, hi = hamiltonian(seg, delta1, delta2, eps, system["xtalk"], system["coupling"])
        tau = torch.broadcast_to(seg[..., 3], delta1.shape)
        sr, si = expm(hr, hi, tau, system["expm_order"], system["expm_scaling"])
        ur, ui = cmul(sr, si, ur, ui)
    return ur, ui


def fidelity(ur, ui, tr, ti) -> torch.Tensor:
    """``(|Tr(U†T)|² + 4)/20`` over the trailing 4×4 axes."""
    re = torch.sum(ur * tr + ui * ti, dim=(-2, -1))
    im = torch.sum(ur * ti - ui * tr, dim=(-2, -1))
    return (re * re + im * im + 4.0) / 20.0


def mean_fidelity(pulses, target, delta1, delta2, eps, system: dict,
                  precision: str = "f32") -> torch.Tensor:
    """Per-target ``E[F]`` ``(B,)`` in f32 from packed ``(B, 2, 4, 4)``
    targets."""
    ur, ui = propagate(pulses, delta1, delta2, eps, system, precision)
    tr = target[:, None, 0].to(ur.dtype)
    ti = target[:, None, 1].to(ur.dtype)
    return fidelity(ur, ui, tr, ti).float().mean(dim=1)


def unitary(pulses: np.ndarray, system: dict) -> np.ndarray:
    """Zero-disorder ``(n, 4, 4)`` complex128 unitaries of ``(n, L, 4)``
    pulse tables, in f64 on the CPU (the traffic's product targets)."""
    p = torch.from_numpy(np.asarray(pulses, np.float64))
    zero = torch.zeros(p.shape[0], 1, dtype=torch.float64)
    ur, ui = _propagate(p, zero, zero, zero, system, torch.float64)
    return ur[:, 0].numpy() + 1j * ui[:, 0].numpy()
