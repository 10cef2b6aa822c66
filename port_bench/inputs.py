"""What the benchmark makes from ``--seed`` and hands to both sides: the
weights, the targets, the pulse tables and the sub-seeds of the draws.

Weights are made on the device in one normal draw for all matrices
(scaled by 1/√fan_in), biases 0 and LayerNorm scales 1, in f32, the type
the model holds them in.  Seeds above 32 bits are taken whole.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from .reference import kak, su4 as ref_su4


def sub_seeds(seed: int, n: int) -> List[int]:
    """``n`` independent 63-bit seeds from the run's seed."""
    words = np.random.SeedSequence(seed % (1 << 64)).generate_state(2 * n, dtype=np.uint32)
    return [int((int(hi) << 31) ^ int(lo)) for hi, lo in zip(words[::2], words[1::2])]


def make_weights(shapes: Sequence[Tuple[str, tuple]], seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """Weights of the named shapes, drawn on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    matrices = [(k, s) for k, s in shapes if len(s) == 2]
    flat = torch.randn(sum(math.prod(s) for _, s in matrices), generator=gen,
                       device=device)
    out, at = {}, 0
    for k, s in matrices:
        n = math.prod(s)
        out[k] = flat[at:at + n].view(s) * (1.0 / math.sqrt(s[1]))
        at += n
    for k, s in shapes:
        if len(s) == 1:
            ones = ".ln" in k and k.endswith(".weight")
            out[k] = (torch.ones if ones else torch.zeros)(s, device=device)
    return {k: out[k] for k, _ in shapes}


def rotations(gen: torch.Generator, n: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` targets with the axis uniform on the sphere and the angle
    uniform in (0, 2π]: rotation vectors ``(n, 4)`` and quaternions
    ``(n, 4)`` on the generator's device; the first k of n are the k of k."""
    u = torch.rand((n, 3), generator=gen, device=gen.device, dtype=torch.float64)
    cos_polar = 1.0 - 2.0 * u[:, 0]
    sin_polar = torch.sqrt(torch.clamp(1.0 - cos_polar ** 2, min=0.0))
    azimuth = 2.0 * math.pi * u[:, 1]
    angle = 2.0 * math.pi * (1.0 - u[:, 2])
    axis = torch.stack([sin_polar * torch.cos(azimuth), sin_polar * torch.sin(azimuth),
                        cos_polar], dim=1)
    rv = torch.cat([axis, angle[:, None]], dim=1)
    q = torch.cat([torch.cos(angle / 2)[:, None], axis * torch.sin(angle / 2)[:, None]], dim=1)
    return rv.float(), q.float()


def pulse_tables(gen: torch.Generator, shape: tuple, pulse_space: dict) -> torch.Tensor:
    """Pulse tables ``shape + (P,)`` uniform in the pulse box."""
    box = torch.tensor(list(pulse_space.values()), dtype=torch.float32, device=gen.device)
    u = torch.rand(tuple(shape) + (box.shape[0],), generator=gen, device=gen.device)
    return box[:, 0] + (box[:, 1] - box[:, 0]) * u


def _haar_su2(rng: np.random.Generator, n: int) -> np.ndarray:
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([np.stack([w + 1j * z, y + 1j * x], -1),
                     np.stack([-y + 1j * x, w - 1j * z], -1)], -2)


def su4_targets(seed: int, n: int, system: dict, segments: int = 24) -> np.ndarray:
    """``n`` two-qubit targets ``(n, 4, 4)`` complex128, the mixed set of the
    two-qubit recipe: half zero-disorder products of ``segments`` random
    drive2 segments (φ₁, φ₂ uniform in (−π, π), Ω in (0, 1), τ in
    (0.1, 0.5)), half Weyl-chamber constructions
    ``(A₁⊗A₂)·exp(−i Σ cₖσₖσₖ)·(B₁⊗B₂)`` with Haar locals and c uniform in
    the box [0, π/4]³ sorted descending; shuffled, each times a random
    global phase."""
    rng = np.random.default_rng(seed)
    n_kak = n // 2
    m = n - n_kak
    lo = np.array([-np.pi, -np.pi, 0.0, 0.1])
    hi = np.array([np.pi, np.pi, 1.0, 0.5])
    products = ref_su4.unitary(lo + (hi - lo) * rng.uniform(size=(m, segments, 4)), system)
    c = np.sort(rng.uniform(size=(n_kak, 3)) * (np.pi / 4), axis=1)[:, ::-1]
    a1, a2, b1, b2 = (_haar_su2(rng, n_kak) for _ in range(4))
    local_a = np.einsum("nab,ncd->nacbd", a1, a2).reshape(n_kak, 4, 4)
    local_b = np.einsum("nab,ncd->nacbd", b1, b2).reshape(n_kak, 4, 4)
    U = np.concatenate([products, local_a @ kak.cartan_exp(c) @ local_b])[rng.permutation(n)]
    return U * np.exp(1j * rng.uniform(0.0, 2.0 * np.pi, size=n))[:, None, None]


def pack(U: np.ndarray) -> torch.Tensor:
    """Complex ``(n, 4, 4)`` → f32 ``(n, 2, 4, 4)`` (re, im) on the CPU."""
    return torch.from_numpy(np.stack([U.real, U.imag], axis=1).astype(np.float32))


def unpack(packed: torch.Tensor) -> np.ndarray:
    """f32 ``(n, 2, 4, 4)`` → complex128 ``(n, 4, 4)``, as the model's
    tokens are made from the packed targets."""
    p = packed.detach().cpu().double().numpy()
    return p[:, 0] + 1j * p[:, 1]
