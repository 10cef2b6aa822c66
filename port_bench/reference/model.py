"""The universal pulse transformer, plain PyTorch over a dict of weights.

Input tokens: for one qubit the SCORE embedding of the target rotation
``(n_x, n_y, n_z, θ)`` (its in-plane azimuth ``atan2(n_y, n_x)`` taken off
and added back to the output phases; a Y-X-Y Euler split; each angle a
3-pulse SCORE composite; 9 SU(2) matrices as 8 interleaved reals); for two
qubits the 9 KAK tokens (:mod:`.kak`).  Then ``unitary_proj``, a sinusoidal
position code, ``n_layers`` post-LN encoder blocks (attention with the
query scaled by 1/√head_dim, residual, LayerNorm ε = 1e-6; a relu FFN of
4·d, residual, LayerNorm) and, on the last token in f32, a linear head
whose sigmoid maps into the pulse box; then relu(τ) and phase channel 0
wrapped to (−π, π].  Dropout keeps with probability 1 − p and scales by
1/(1 − p): per block one attention-weight mask shared over batch and heads,
then masks on the attention output, the FFN hidden layer and the FFN
output, drawn from the generator in that order.

Weights are f32; the encoder computes in the configured dtype with the
weights cast at each use, LayerNorm statistics in f32.  ``precision``
``"fp8"`` rounds every matmul operand through float8 e4m3 with a
per-tensor scale (the control of a bf16 encoder); ``"tf32"`` runs the f32
encoder's matmuls in TF32.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]

_FP8_MAX = 448.0


def parameter_shapes(d_model: int, n_layers: int, out_dim: int) -> List[Tuple[str, tuple]]:
    """Every weight's name and shape (``(out, in)`` matrices), in order."""
    d = d_model
    shapes = [("unitary_proj.weight", (d, 8)), ("unitary_proj.bias", (d,))]
    for i in range(n_layers):
        p = f"encoder.{i}."
        for name in ("query", "key", "value", "out"):
            shapes += [(p + f"attn.{name}.weight", (d, d)), (p + f"attn.{name}.bias", (d,))]
        shapes += [(p + "ln1.weight", (d,)), (p + "ln1.bias", (d,)),
                   (p + "dense0.weight", (4 * d, d)), (p + "dense0.bias", (4 * d,)),
                   (p + "dense1.weight", (d, 4 * d)), (p + "dense1.bias", (d,)),
                   (p + "ln2.weight", (d,)), (p + "ln2.bias", (d,))]
    shapes += [("head.weight", (out_dim, d)), ("head.bias", (out_dim,))]
    return shapes


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = _FP8_MAX / torch.clamp(x.detach().abs().amax().float(), min=1e-30)
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _Linear:
    """``x W^T + b`` in the compute dtype, operands rounded as ``precision``
    asks."""

    def __init__(self, dtype: torch.dtype, precision: str):
        self.dtype, self.fp8 = dtype, precision == "fp8"

    def __call__(self, x, w, b):
        w, b = w.to(self.dtype), b.to(self.dtype)
        if self.fp8:
            x, w = _fp8(x), _fp8(w)
        return F.linear(x, w, b)

    def matmul(self, a, b):
        if self.fp8:
            a, b = _fp8(a), _fp8(b)
        return a @ b


def _dropout(x, p: float, generator, shape=None):
    if generator is None or p == 0.0:
        return x
    keep = 1.0 - p
    mask = torch.rand(shape or x.shape, generator=generator, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def positions(length: int, d_model: int, device) -> torch.Tensor:
    """Sinusoidal position code ``(length, d_model)``: sin on even channels,
    cos on odd, frequencies ``10000^(−2i/d)``."""
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    freq = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32, device=device)
                     * (-math.log(10000.0) / d_model))
    pe = torch.zeros((length, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * freq)
    pe[:, 1::2] = torch.cos(pos * freq)
    return pe


def encode(weights: Weights, tokens: torch.Tensor, cfg: dict, dtype: torch.dtype,
           precision: str, generator: Optional[torch.Generator]) -> torch.Tensor:
    """``(B, T, 8)`` tokens → the head's f32 logits ``(B, L·P)``; dropout
    from ``generator`` when one is given."""
    lin = _Linear(dtype, precision)
    d, H, p = cfg["d_model"], cfg["n_heads"], cfg["dropout"]
    B, T, _ = tokens.shape
    Dh = d // H
    x = lin(tokens.to(dtype), weights["unitary_proj.weight"], weights["unitary_proj.bias"])
    x = x + positions(T, d, tokens.device).to(dtype)[None]
    for i in range(cfg["n_layers"]):
        w = {k[len(f"encoder.{i}."):]: v for k, v in weights.items()
             if k.startswith(f"encoder.{i}.")}

        def heads(name):
            return lin(x, w[f"attn.{name}.weight"], w[f"attn.{name}.bias"]) \
                .view(B, T, H, Dh).transpose(1, 2)

        q, k, v = heads("query") / math.sqrt(Dh), heads("key"), heads("value")
        att = torch.softmax(lin.matmul(q, k.transpose(-1, -2)), dim=-1)
        att = _dropout(att, p, generator, (1, 1, T, T))
        ctx = lin.matmul(att, v).transpose(1, 2).reshape(B, T, d)
        a = _dropout(lin(ctx, w["attn.out.weight"], w["attn.out.bias"]), p, generator)
        x = F.layer_norm((x + a).float(), (d,), w["ln1.weight"], w["ln1.bias"], 1e-6).to(dtype)
        h = torch.relu(lin(x, w["dense0.weight"], w["dense0.bias"]))
        h = _dropout(h, p, generator)
        h = _dropout(lin(h, w["dense1.weight"], w["dense1.bias"]), p, generator)
        x = F.layer_norm((x + h).float(), (d,), w["ln2.weight"], w["ln2.bias"], 1e-6).to(dtype)
    last = x[:, -1, :].float()
    head = _Linear(torch.float32, precision)
    return head(last, weights["head.weight"], weights["head.bias"])


def to_pulses(logits: torch.Tensor, cfg: dict, phase_offset=None) -> torch.Tensor:
    """Logits → ``(B, L, P)`` pulses in the box, relu(τ), φ wrapped."""
    box = list(cfg["pulse_space"].values())
    low = torch.tensor([lo for lo, _ in box], device=logits.device)
    high = torch.tensor([hi for _, hi in box], device=logits.device)
    pulses = low + (high - low) * torch.sigmoid(logits.view(logits.shape[0], -1, len(box)))
    phi = pulses[..., :1]
    if phase_offset is not None:
        phi = phi + phase_offset[:, None, None]
    phi = torch.remainder(phi + math.pi, 2.0 * math.pi) - math.pi
    return torch.cat([phi, pulses[..., 1:-1], torch.relu(pulses[..., -1:])], dim=-1)


# ----------------------------------------------------------------------
# SCORE embedding of a single-qubit target
# ----------------------------------------------------------------------

def _rotation(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    norm = torch.sqrt(torch.clamp_min(torch.sum(axis * axis, dim=-1), 1e-24))
    s = torch.sin(0.5 * angle) / norm
    return torch.cat([torch.cos(0.5 * angle)[..., None], axis * s[..., None]], dim=-1)


def _atan2_where(num, den, mask):
    one = torch.ones_like(num)
    return torch.where(mask, torch.atan2(torch.where(mask, num, one),
                                         torch.where(mask, den, one)), torch.zeros_like(num))


def _euler_yxy(rv: torch.Tensor) -> torch.Tensor:
    """Angles ``(α, β, γ)`` with ``exp(−iθ/2 n·σ) = R_y(α) R_x(β) R_y(γ)``;
    the poles β ≈ 0 and β ≈ π take their own branches."""
    n = rv[..., :3] / torch.clamp_min(torch.linalg.norm(rv[..., :3], dim=-1, keepdim=True),
                                      1e-12)
    s, c = torch.sin(rv[..., 3] / 2), torch.cos(rv[..., 3] / 2)
    w, x, y, z = c, n[..., 0] * s, n[..., 1] * s, n[..., 2] * s
    r2, c2 = x * x + z * z, w * w + y * y
    beta = torch.arccos(torch.clamp(1.0 - 2.0 * r2, -1.0 + 1e-7, 1.0 - 1e-7))
    at0, atpi = r2 < 1e-9, c2 < 1e-9
    reg = ~at0 & ~atpi
    alpha = (_atan2_where(x * y - z * w, y * z + w * x, reg)
             + 2.0 * _atan2_where(y, w, at0) + _atan2_where(-z, x, atpi))
    gamma = _atan2_where(x * y + z * w, w * x - y * z, reg) + _atan2_where(z, x, atpi)
    return torch.stack([alpha, beta, gamma], dim=-1)


def _score_triplet(phi: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """``[R(φ+π, θ'), R(φ, angle + 2θ'), R(φ+π, θ')]`` with the SCORE
    correction ``θ' = π − angle − asin(½ sin(angle/2))``."""
    corr = math.pi - angle - torch.arcsin(0.5 * torch.sin(angle / 2))

    def axis(a):
        return torch.stack([torch.cos(a), torch.sin(a), torch.zeros_like(a)], dim=-1)

    flank = _rotation(axis(phi + math.pi), corr)
    return torch.stack([flank, _rotation(axis(phi), angle + 2.0 * corr), flank], dim=-2)


def score_tokens(rv: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(B, 4)`` rotations → ``(tokens (B, 9, 8), azimuth (B,))``."""
    azimuth = torch.atan2(rv[..., 1], rv[..., 0])
    in_plane = torch.sqrt(rv[..., 0] ** 2 + rv[..., 1] ** 2)
    euler = _euler_yxy(torch.stack([in_plane, torch.zeros_like(in_plane), rv[..., 2],
                                    rv[..., 3]], dim=-1))
    alpha, beta, gamma = euler.unbind(-1)
    zero, quarter = torch.zeros_like(alpha), torch.full_like(alpha, math.pi / 2)
    q = torch.cat([_score_triplet(zero, alpha), _score_triplet(quarter, beta),
                   _score_triplet(zero, gamma)], dim=-2)
    w, x, y, z = q.unbind(-1)
    return torch.stack([w, -z, -y, -x, y, -x, w, z], dim=-1), azimuth


def pulses_su2(weights: Weights, rv: torch.Tensor, cfg: dict, dtype: torch.dtype,
               precision: str = "f32", generator=None) -> torch.Tensor:
    """Single-qubit model: ``(B, 4)`` rotations → ``(B, L, P)`` pulses."""
    tokens, azimuth = score_tokens(rv.float())
    logits = encode(weights, tokens, cfg, dtype, precision, generator)
    return to_pulses(logits, cfg, azimuth)


def pulses_su4(weights: Weights, tokens: torch.Tensor, cfg: dict, dtype: torch.dtype,
               precision: str = "f32", generator=None) -> torch.Tensor:
    """Two-qubit model: ``(B, 9, 8)`` KAK tokens → ``(B, L, P)`` pulses."""
    logits = encode(weights, tokens.float(), cfg, dtype, precision, generator)
    return to_pulses(logits, cfg)
