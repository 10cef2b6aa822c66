"""The yardstick's arithmetic: operations and bytes of the work a cell's
inputs need, and the H100's peaks.

Monte-Carlo work per (sample, segment) and per sample, an FMA counted as
2, as the host builds of the SU(2) and SU(4) per-sample math count them
(frozen here): the SU(2) product 47 a segment and 8 a sample at P = 2, the
fidelity 12 a sample, the reverse sweep 103 a segment and 15 a sample; the
SU(4) product 3661 a segment and 10 a sample, the fidelity 134 a sample,
the reverse sweep 12274 a segment (P = 4) and 716 a sample.  The work is
counted once, whatever implements it: a backward that forms the forward
product again does not count it twice.  Bytes count each input read once
and each output written once.

Model work: the matmuls' flops of the encoder and head, 2 per
multiply-add, forward; training counts the backward as twice that.
"""

from __future__ import annotations

from typing import Dict

import torch

PEAK_F32 = 67e12          # FLOP/s outside the tensor cores (data sheet, SXM, 700 W)
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12      # HBM bytes/s

SU2 = {"segment": 47, "sample": 8, "fidelity": 12, "vjp_segment": 103, "vjp_sample": 15}
SU4 = {"segment": 3661, "sample": 10, "fidelity": 134, "vjp_segment": 12274,
       "vjp_sample": 716}


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the chip could take: ``max(flops / peak, bytes / bandwidth)``."""
    return max(flops / PEAK_F32, nbytes / PEAK_BYTES)


def mc_work(family: str, B: int, L: int, P: int, M: int, backward: bool) -> Dict[str, float]:
    """Flops and bytes of the Monte-Carlo objective of ``B`` tables of ``L``
    segments of ``P`` parameters on ``M`` samples each: the product and the
    fidelity's mean, and with ``backward`` the reverse sweep to the
    gradients of pulses, targets and disorder.  Disorder channels: δ, ε
    (SU(2)) or δ₁, δ₂, ε (SU(4)); a target is 4 floats (SU(2)) or 32."""
    c = SU2 if family == "su2" else SU4
    channels, target = (2, 4) if family == "su2" else (3, 32)
    flops = B * M * (L * c["segment"] + c["sample"] + c["fidelity"])
    nbytes = 4 * (B * L * P + B * target + channels * B * M + B)
    if backward:
        flops += B * M * (L * c["vjp_segment"] + c["vjp_sample"])
        nbytes += 4 * (B + B * L * P + B * target + channels * B * M)
    return {"flops": float(flops), "bytes": float(nbytes)}


def samples_work(L: int, P: int, samples: int, outputs: int) -> Dict[str, float]:
    """One table's SU(2) product and fidelity on ``samples`` disorder draws
    (δ, ε each), ``outputs`` floats written."""
    flops = samples * (L * SU2["segment"] + SU2["sample"] + SU2["fidelity"])
    return {"flops": float(flops), "bytes": float(4 * (L * P + 4 + 2 * samples + outputs))}


def model_flops(cfg: dict, batch: int, tokens: int, training: bool) -> float:
    """Matmul flops of the encoder and head for ``batch`` sequences of
    ``tokens``: per token the input projection (8·d) and per layer the four
    attention maps (4d²), the FFN (8d²) and the scores and weighted sum
    (2·T·d); the head on the last token (d·L·P)."""
    d, n, T = cfg["d_model"], cfg["n_layers"], tokens
    macs = T * (8 * d + n * (12 * d * d + 2 * T * d)) + d * cfg["max_pulses"] * len(
        cfg["pulse_space"])
    return 2.0 * macs * batch * (3.0 if training else 1.0)


def matmul_peak(dtype: torch.dtype) -> float:
    """Peak of the dtype the encoder computes in, TF32 where f32 matmuls
    are allowed to use it."""
    if dtype in (torch.bfloat16, torch.float16):
        return PEAK_BF16
    if dtype == torch.float32 and torch.backends.cuda.matmul.allow_tf32:
        return PEAK_TF32
    return PEAK_F32
