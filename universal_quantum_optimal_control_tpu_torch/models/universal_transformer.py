r"""Universal pulse-synthesis transformer (PyTorch port of
``models/universal_transformer.py``).

Maps target rotation vectors ``(n_x, n_y, n_z, θ)`` to composite pulse
sequences ``(B, max_pulses, P)`` through the SCORE embedding and a post-LN
transformer encoder.  Numerics follow the Flax module so the JAX package's
weights carry over unchanged:

* parameters are f32; the encoder computes in ``dtype`` (default bf16, as
  the Flax class) with the weights cast at each call, LayerNorm statistics
  in f32 with ε = 1e-6, and the head reads the last token in f32;
* attention scales the query by 1/√head_dim before the scores;
* the head applies the sigmoid range map, the optional ``base_pulse``
  blend, relu(τ), the φ offset and the (−π, π] wrap, in that order;
* dropout follows Flax: keep with probability 1 − p and scale by 1/(1 − p),
  with one attention-weight mask shared over batch and heads (Flax's
  ``broadcast_dropout``); its bits come from the ``generator`` passed to
  ``forward``, so a training run is reproducible from its seed;
* :meth:`UniversalQOCTransformer.init_like_flax` draws the initial weights
  from Flax's defaults for training from scratch (serving loads weights).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.device import resolve_device
from .score_embedding import score_features, sinusoidal_positional_encoding

__all__ = ["UniversalQOCTransformer", "EncoderBlock", "init_like_flax",
           "normalize_pulse_space", "wrap_angle"]

PulseSpace = Tuple[Tuple[str, Tuple[float, float]], ...]

# std of a standard normal truncated to [-2, 2] (Flax's variance_scaling
# divides the target std by it)
_TRUNC_STD = 0.87962566103423978

# physics channel order: φ first (offset and wrap), τ last (relu)
_CANONICAL_KEY_ORDER = {"phi": 0, "phi1": 0, "phi2": 1,
                        "omega": 2, "Omega": 2, "delta": 3, "Delta": 3,
                        "tau": 4, "t": 4}


def normalize_pulse_space(pulse_space) -> PulseSpace:
    """Dict or tuple pulse space → canonical tuple form; recognized control
    names are reordered into the propagator's (φ…, Ω, Δ, τ) convention."""
    if isinstance(pulse_space, dict):
        items = [(k, (float(v[0]), float(v[1]))) for k, v in pulse_space.items()]
    else:
        items = [(k, (float(lo), float(hi))) for k, (lo, hi) in pulse_space]
    if all(k in _CANONICAL_KEY_ORDER for k, _ in items):
        items.sort(key=lambda kv: _CANONICAL_KEY_ORDER[kv[0]])
    return tuple(items)


def wrap_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap to (−π, π]."""
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


def _linear(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    return F.linear(x, layer.weight.to(dtype), layer.bias.to(dtype))


def _dropout(x: torch.Tensor, p: float, training: bool,
             generator: Optional[torch.Generator], shape=None) -> torch.Tensor:
    """Flax ``Dropout``: keep with probability 1 − p, scale by 1/(1 − p).
    ``shape`` broadcasts one mask over the dimensions it sets to 1."""
    if not training or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(shape or x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


@torch.no_grad()
def init_like_flax(model: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every weight of ``model`` from Flax's defaults, in place:
    ``Dense`` and attention kernels ``lecun_normal`` (a normal truncated at
    ±2σ, σ corrected so the drawn std is 1/√fan_in), biases 0, LayerNorm
    scale 1 and bias 0.  ``generator`` lies on the parameters' device."""
    for module in model.modules():
        if isinstance(module, nn.Linear):
            std = 1.0 / math.sqrt(module.in_features) / _TRUNC_STD
            nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                  generator=generator)
            nn.init.zeros_(module.bias)
        elif isinstance(module, nn.LayerNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)


class MultiHeadAttention(nn.Module):
    """Self-attention with Flax ``MultiHeadDotProductAttention`` numerics.

    ``query/key/value`` map ``d → heads·head_dim`` (Flax kernels
    ``(d, heads, head_dim)``), ``out`` maps back (Flax ``(heads, head_dim, d)``).
    """

    def __init__(self, d_model: int, n_heads: int, dropout: float, device):
        super().__init__()
        if d_model % n_heads:
            raise ValueError(f"d_model={d_model} is not divisible by n_heads={n_heads}")
        self.n_heads = n_heads
        self.dropout = dropout
        self.query = nn.Linear(d_model, d_model, device=device)
        self.key = nn.Linear(d_model, d_model, device=device)
        self.value = nn.Linear(d_model, d_model, device=device)
        self.out = nn.Linear(d_model, d_model, device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, T, d = x.shape
        H = self.n_heads
        Dh = d // H
        q = _linear(x, self.query, dtype).view(B, T, H, Dh)
        k = _linear(x, self.key, dtype).view(B, T, H, Dh)
        v = _linear(x, self.value, dtype).view(B, T, H, Dh)
        q = q / math.sqrt(Dh)
        scores = torch.einsum("bqhd,bkhd->bhqk", q, k)
        weights = torch.softmax(scores, dim=-1)
        weights = _dropout(weights, self.dropout, self.training, generator,
                           (1, 1, T, T))
        ctx = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, T, d)
        return _linear(ctx, self.out, dtype)


class EncoderBlock(nn.Module):
    """Post-LN encoder block: attention → residual → LN, then
    FFN(4d, relu) → residual → LN.  Dropout is active only in train mode."""

    def __init__(self, d_model: int, n_heads: int, dropout: float, device):
        super().__init__()
        self.dropout = dropout
        self.attn = MultiHeadAttention(d_model, n_heads, dropout, device)
        self.ln1 = nn.LayerNorm(d_model, eps=1e-6, device=device)
        self.dense0 = nn.Linear(d_model, 4 * d_model, device=device)
        self.dense1 = nn.Linear(4 * d_model, d_model, device=device)
        self.ln2 = nn.LayerNorm(d_model, eps=1e-6, device=device)

    def forward(self, x: torch.Tensor, dtype: torch.dtype,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p, train = self.dropout, self.training
        attn = _dropout(self.attn(x, dtype, generator), p, train, generator)
        x = self.ln1((x + attn).float()).to(dtype)
        h = torch.relu(_linear(x, self.dense0, dtype))
        h = _dropout(h, p, train, generator)
        h = _dropout(_linear(h, self.dense1, dtype), p, train, generator)
        return self.ln2((x + h).float()).to(dtype)


class UniversalQOCTransformer(nn.Module):
    """SCORE-embedding transformer pulse generator.

    ``n_layers=None`` means ``4 * max_pulses``.  ``device=None`` builds the
    parameters on CUDA (and raises where there is none).
    """

    def __init__(self, num_qubits: int = 1,
                 pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.1, 0.5))),
                 max_pulses: int = 16, d_model: int = 256,
                 n_layers: Optional[int] = 12, n_heads: int = 4,
                 dropout: float = 0.1, finetune: bool = False,
                 middle_convention: str = "angle",
                 dtype: torch.dtype = torch.bfloat16, device=None):
        super().__init__()
        if num_qubits != 1:
            raise ValueError(f"num_qubits={num_qubits}: this model is single-qubit")
        dev = resolve_device(device)
        self.pulse_space = normalize_pulse_space(pulse_space)
        self.max_pulses = max_pulses
        self.finetune = bool(finetune)
        self.middle_convention = middle_convention
        self.dtype = dtype
        n_layers = n_layers if n_layers is not None else 4 * max_pulses
        P = len(self.pulse_space)
        self.unitary_proj = nn.Linear(8, d_model, device=dev)
        self.encoder = nn.ModuleList(
            EncoderBlock(d_model, n_heads, dropout, dev) for _ in range(n_layers))
        self.head = nn.Linear(d_model, max_pulses * P, device=dev)
        self.register_buffer(
            "pe", sinusoidal_positional_encoding(9, d_model, device=dev),
            persistent=False)
        self.register_buffer(
            "low", torch.tensor([lo for _, (lo, _) in self.pulse_space], device=dev),
            persistent=False)
        self.register_buffer(
            "high", torch.tensor([hi for _, (_, hi) in self.pulse_space], device=dev),
            persistent=False)

    @property
    def param_dim(self) -> int:
        return len(self.pulse_space)

    def init_like_flax(self, generator: torch.Generator) -> None:
        """Re-draw every weight from Flax's defaults (:func:`init_like_flax`)."""
        init_like_flax(self, generator)

    def forward(self, rotation_vector: torch.Tensor,
                base_pulse: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """``(B, 4)`` rotation vectors → ``(B, max_pulses, P)`` pulses.
        ``generator`` draws the dropout masks in train mode."""
        dtype = self.dtype
        tokens, phi_offset = score_features(rotation_vector.float(),
                                            self.middle_convention)
        x = _linear(tokens.to(dtype), self.unitary_proj, dtype)
        x = x + self.pe.to(dtype)[None]
        for block in self.encoder:
            x = block(x, dtype, generator)

        logits = self.head(x[:, -1, :].float())
        pulses = self.low + (self.high - self.low) * torch.sigmoid(
            logits.view(-1, self.max_pulses, self.param_dim))
        if self.finetune:
            if base_pulse is None:
                raise ValueError("finetune=True requires an explicit base_pulse")
            pulses = 0.2 * pulses + base_pulse

        tau = torch.relu(pulses[..., -1:])
        phi = wrap_angle(pulses[..., :1] + phi_offset[:, None, None])
        return torch.cat([phi, pulses[..., 1:-1], tau], dim=-1)
