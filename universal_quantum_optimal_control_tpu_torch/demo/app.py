r"""Serve the trained universal models: rotation → pulse table.

The serving half of the JAX package's ``demo/app.py``: the single-qubit
variant map, a cached model loader and ``compute_pulses``, and the
two-qubit model variants (``TWO_QUBIT_VARIANTS``, served through
``workloads/two_qubit_eval.py``).  Plotting, Gradio, the per-gate bundles
and the pulse-table variants are not ported yet.  The configs and ``.npz``
weights are the JAX package's own files, read where they lie (reading a
data file imports nothing of that package).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..core.su2 import rotation_vector_to_quat
from ..models import (Pipeline, UniversalQOCTransformer, load_params_npz,
                      normalize_pulse_space, params_from_jax)
from ..utils import load_model_params, resolve_device

__all__ = ["MODEL_VARIANTS", "TWO_QUBIT_VARIANTS", "load_pipeline", "compute_pulses",
           "two_qubit_model_kwargs"]

_JAX_PACKAGE_DIR = (Path(__file__).resolve().parent.parent.parent
                    / "universal_quantum_optimal_control_tpu")
_CONFIG_DIR = _JAX_PACKAGE_DIR / "configs"
_WEIGHTS_DIR = _JAX_PACKAGE_DIR / "demo" / "weights"

MODEL_VARIANTS: Dict[str, Dict] = {
    "length_100_med": {
        "config": str(_CONFIG_DIR / "universal_single_qubit_length100_med.json"),
        "checkpoint": str(_WEIGHTS_DIR / "length100_med.npz")},
    # the flagship: d512 × 8 layers, 16 heads, L = 100, P = 2
    "length_100": {"config": str(_CONFIG_DIR / "universal_single_qubit.json"),
                   "checkpoint": str(_WEIGHTS_DIR / "length100.npz")},
}


# Two-qubit universal models (drive2 system, KAK tokens; d512 × 8 layers,
# 16 heads): the flagship (L = 100, σ_δ 0.05–0.3) and its σ_δ < 0.05 and
# σ_δ ≥ 0.35 bands.  ``_s0`` is the L = 40 artifact: no ``max_pulses``, so
# the JAX default of 40 applies.
TWO_QUBIT_VARIANTS: Dict[str, Dict] = {
    "two_qubit_d2_kak": {
        "checkpoint": str(_WEIGHTS_DIR / "two_qubit_d2_kak.npz"),
        "drive2": True, "kak_tokens": True, "omega_min": 0.05,
        "max_pulses": 100},
    "two_qubit_d2_kak_s0": {
        "checkpoint": str(_WEIGHTS_DIR / "two_qubit_d2_kak_s0.npz"),
        "drive2": True, "kak_tokens": True, "omega_min": 0.05},
    "two_qubit_d2_kak_s04": {
        "checkpoint": str(_WEIGHTS_DIR / "two_qubit_d2_kak_s04.npz"),
        "drive2": True, "kak_tokens": True, "omega_min": 0.05,
        "max_pulses": 100},
}


def two_qubit_model_kwargs(variant: str) -> Tuple[str, Dict]:
    """``(checkpoint, keywords)`` of a two-qubit variant for
    ``workloads.two_qubit_eval.model_gate_pulses`` / ``best_phase_pulses``,
    with ``max_pulses`` explicit (40 where the variant names none)."""
    spec = dict(TWO_QUBIT_VARIANTS[variant])
    checkpoint = spec.pop("checkpoint")
    spec.setdefault("max_pulses", 40)
    return checkpoint, spec


@functools.lru_cache(maxsize=4)
def load_pipeline(variant: str, checkpoint: Optional[str] = None, device=None,
                  dtype: torch.dtype = torch.bfloat16) -> Pipeline:
    """Build and cache an eval-mode Pipeline for a model variant.

    ``checkpoint`` overrides the variant's ``.npz``; ``dtype`` is the
    encoder's compute dtype (bf16 by default, as the JAX demo serves).
    """
    spec = MODEL_VARIANTS[variant]
    ckpt = str(checkpoint or spec["checkpoint"])
    if not ckpt.endswith(".npz"):
        raise ValueError(f"checkpoint must be an .npz artifact, got {ckpt!r}")
    model_params = load_model_params(spec["config"])
    model_params["pulse_space"] = normalize_pulse_space(model_params["pulse_space"])
    model_params["finetune"] = False
    model = UniversalQOCTransformer(**model_params, dtype=dtype,
                                    device=resolve_device(device))
    model.load_state_dict(params_from_jax(load_params_npz(ckpt)))
    return Pipeline(model)


def compute_pulses(variant: str, x: float, y: float, z: float, theta: float,
                   checkpoint: Optional[str] = None, device=None,
                   dtype: torch.dtype = torch.bfloat16) -> Tuple[np.ndarray, torch.Tensor]:
    """Rotation spec → ``(pulses (L, P) numpy, target quaternion (4,))``."""
    n = np.asarray([x, y, z], np.float64)
    n = n / max(np.linalg.norm(n), 1e-12)
    rv = torch.tensor([[n[0], n[1], n[2], theta]], dtype=torch.float32)
    pipe = load_pipeline(variant, checkpoint, device, dtype)
    pulses = pipe(rv)[0].cpu().numpy()
    return pulses, rotation_vector_to_quat(rv[0])
