r"""Two-qubit universal pulse model (PyTorch port of ``models/two_qubit.py``).

The target SU(4) unitary is featurized as 4 row tokens of interleaved
(re, im) entries (:func:`unitary_tokens`), optionally with a 5th token of
Makhlin local invariants (``kak_features``), or read as the host KAK
featurization ``(B, 9, 8)`` of :func:`..data.su4_targets.kak_input_tokens`
(``kak_tokens``, the shipped flagship's input).  The tokens go through
the single-qubit model's trunk
(:class:`.universal_transformer.PulseTransformer`), so the Flax numerics
and the ``.npz`` weights carry over unchanged (:func:`.serialization.params_from_jax`).
"""

from __future__ import annotations

import functools
import itertools
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..utils.device import resolve_device
from .universal_transformer import PulseTransformer, _pulse_space_json

__all__ = ["TwoQubitQOCTransformer", "unitary_tokens", "makhlin_invariants_ri"]


def unitary_tokens(packed_target: torch.Tensor) -> torch.Tensor:
    """Packed targets ``(B, 2, 4, 4)`` (re, im) → row tokens ``(B, 4, 8)``:
    token i is row i of the target, its 4 entries as interleaved (re, im)."""
    re, im = packed_target[:, 0], packed_target[:, 1]
    return torch.stack([re, im], dim=-1).reshape(*re.shape[:-1], 8)


# Magic (Bell) basis; m = Mᵀ M with M = Q†UQ is invariant under local
# rotations up to conjugation, so G1 = tr²(m)/(16·det U) and
# G2 = (tr²(m) − tr(m²))/(4·det U) depend only on the target's Cartan class.
_Q_MAGIC = (1.0 / np.sqrt(2.0)) * np.array(
    [[1, 0, 0, 1j], [0, 1j, 1, 0], [0, 1j, -1, 0], [1, 0, 0, -1j]], dtype=np.complex128)
_QR = np.asarray(_Q_MAGIC.real, np.float32)
_QI = np.asarray(_Q_MAGIC.imag, np.float32)
# 4×4 determinant by its 24-term permutation expansion, in (re, im) arithmetic
_PERMS = [(p, float(np.linalg.det(np.eye(4)[list(p)])))
          for p in itertools.permutations(range(4))]


def _mm_ri(ar, ai, br, bi):
    k1 = torch.matmul(ar, br + bi)
    k2 = torch.matmul(ar + ai, bi)
    k3 = torch.matmul(ai - ar, br)
    return k1 - k2, k1 + k3


def _det4_ri(Ur: torch.Tensor, Ui: torch.Tensor):
    """Closed-form complex determinant of ``(..., 4, 4)`` (re, im) pairs."""
    dr = torch.zeros(Ur.shape[:-2], dtype=Ur.dtype, device=Ur.device)
    di = torch.zeros_like(dr)
    for p, sgn in _PERMS:
        tr, ti = Ur[..., 0, p[0]], Ui[..., 0, p[0]]
        for r in range(1, 4):
            br, bi = Ur[..., r, p[r]], Ui[..., r, p[r]]
            tr, ti = tr * br - ti * bi, tr * bi + ti * br
        dr = dr + sgn * tr
        di = di + sgn * ti
    return dr, di


@functools.lru_cache(maxsize=None)
def _magic(dtype: torch.dtype, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The magic basis as (real, imag) tensors of ``dtype`` on ``device``,
    copied there once: a step captured in a CUDA graph copies nothing from
    the host.  Callers read them and never write."""
    return (torch.as_tensor(_QR, dtype=dtype, device=device),
            torch.as_tensor(_QI, dtype=dtype, device=device))


def makhlin_invariants_ri(packed_target: torch.Tensor) -> torch.Tensor:
    """Packed targets ``(B, 2, 4, 4)`` → Makhlin invariants ``(B, 3)``:
    ``(Re G1, Im G1, Re G2)``, in real arithmetic."""
    Ur, Ui = packed_target[:, 0], packed_target[:, 1]
    Qr, Qi = _magic(Ur.dtype, Ur.device)
    Tr, Ti = _mm_ri(Qr.T, -Qi.T, Ur, Ui)           # M = Q† U Q
    Mr, Mi = _mm_ri(Tr, Ti, Qr, Qi)
    mr, mi = _mm_ri(Mr.transpose(-1, -2), Mi.transpose(-1, -2), Mr, Mi)  # m = Mᵀ M
    tr_r = torch.diagonal(mr, dim1=-2, dim2=-1).sum(-1)
    tr_i = torch.diagonal(mi, dim1=-2, dim2=-1).sum(-1)
    tr2_r = tr_r * tr_r - tr_i * tr_i
    tr2_i = 2.0 * tr_r * tr_i
    # tr(m²) = Σᵢⱼ mᵢⱼ·mⱼᵢ
    trm2_r = torch.sum(mr * mr.transpose(-1, -2) - mi * mi.transpose(-1, -2), dim=(-2, -1))
    trm2_i = 2.0 * torch.sum(mr * mi.transpose(-1, -2), dim=(-2, -1))
    det_r, det_i = _det4_ri(Ur, Ui)
    inv_d = 1.0 / torch.clamp(det_r * det_r + det_i * det_i, min=1e-12)
    g1_r = (tr2_r * det_r + tr2_i * det_i) * inv_d / 16.0
    g1_i = (tr2_i * det_r - tr2_r * det_i) * inv_d / 16.0
    n_r, n_i = tr2_r - trm2_r, tr2_i - trm2_i
    g2_r = (n_r * det_r + n_i * det_i) * inv_d / 4.0
    return torch.stack([g1_r, g1_i, g2_r], dim=-1)


class TwoQubitQOCTransformer(PulseTransformer):
    """SU(4)-target transformer pulse generator.

    Numerics as :class:`.universal_transformer.UniversalQOCTransformer`,
    whose trunk it shares (:class:`.universal_transformer.PulseTransformer`):
    f32 parameters, the encoder computing in ``dtype`` (bf16 by default, as
    the Flax class), the head in f32; the sigmoid range map, relu(τ) and
    the (−π, π] wrap of channel 0, with no φ offset; the positional encoding
    made at each call for the tokens' count.  ``device=None`` builds the
    parameters on CUDA (and raises where there is none).
    """

    def __init__(self, pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.1, 0.5))),
                 max_pulses: int = 16, d_model: int = 256, n_layers: int = 12,
                 n_heads: int = 4, dropout: float = 0.1, num_qubits: int = 2,
                 dtype: torch.dtype = torch.bfloat16, kak_features: bool = False,
                 kak_tokens: bool = False, device=None):
        if num_qubits != 2:
            raise ValueError(f"num_qubits={num_qubits}: this model is two-qubit")
        super().__init__(pulse_space, max_pulses, d_model, n_layers, n_heads, dropout,
                         dtype, resolve_device(device))
        self.kak_features = kak_features
        self.kak_tokens = kak_tokens
        self.hparams = dict(pulse_space=_pulse_space_json(self.pulse_space),
                            max_pulses=max_pulses, d_model=d_model, n_layers=n_layers,
                            n_heads=n_heads, dropout=dropout, num_qubits=num_qubits,
                            dtype=str(dtype), kak_features=kak_features,
                            kak_tokens=kak_tokens)

    def forward(self, packed_target: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(B, 2, 4, 4)`` packed targets (or, with ``kak_tokens``, the
        ``(B, T, 8)`` host tokens) → ``(B, max_pulses, P)`` pulses.
        ``generator`` draws the dropout masks in train mode."""
        return super().forward(packed_target, None, generator)

    def _tokens(self, packed_target: torch.Tensor) -> Tuple[torch.Tensor, None]:
        if self.kak_tokens:
            tokens = packed_target.float()
            if tokens.dim() != 3 or tokens.shape[-1] != 8:
                raise ValueError(
                    f"kak_tokens expects (B, T, 8) precomputed tokens from "
                    f"data.su4_targets.kak_input_tokens; got shape {tuple(tokens.shape)}")
            return tokens, None
        tokens = unitary_tokens(packed_target.float())
        if self.kak_features:
            feats = makhlin_invariants_ri(packed_target.float())
            feats = nn.functional.pad(feats, (0, 8 - feats.shape[-1]))
            tokens = torch.cat([tokens, feats[:, None, :]], dim=1)
        return tokens, None
