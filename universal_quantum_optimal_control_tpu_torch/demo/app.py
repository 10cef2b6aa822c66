r"""Serve the trained universal models: rotation → pulse table.

The serving half of the JAX package's ``demo/app.py``: the single-qubit
variant map (the shipped universal models, the ``length_400`` blend of
0.2 · model + its base pulse, and the ``length_100_gates`` /
``length_100_gates_p4`` per-gate bundles, which serve a bundle's table for
an exact named-gate request and the model elsewhere), a cached model
loader, ``compute_pulses`` and ``default_variant``; the two-qubit variants
(``TWO_QUBIT_VARIANTS``: the three model variants, served through
``workloads/two_qubit_eval.py``, the ``two_qubit_gates`` per-gate bundle
and the ``cz_robust`` / ``cz_drive2`` pulse tables) with the numeric half
of ``render_two_qubit_artifacts``: the pulse table it picks
(:func:`two_qubit_pulse_table`) and its E[F](σ_δ) sweep through kernel B7
(:func:`two_qubit_robustness`).  The CSV, the figures and Gradio are not
ported yet (``ROADMAP.md`` A.18).  The configs, ``.npz`` weights and the
base pulse ``.csv`` are the JAX package's own files, read where they lie
(reading a data file imports nothing of that package).
"""

from __future__ import annotations

import functools
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..analysis.plots_su4 import fidelity_by_std_su4
from ..core.su2 import rotation_vector_to_quat
from ..core.su4 import TwoQubitSystem
from ..models import (Pipeline, UniversalQOCTransformer, load_params_npz,
                      normalize_pulse_space, params_from_jax)
from ..optimizers.two_qubit_grape import named_two_qubit_targets
from ..training.systems import SU4System
from ..utils import load_model_params, resolve_device
from ..workloads.finetune_gates import load_gate_bundle
from ..workloads.finetune_two_qubit_gates import load_two_qubit_gate_bundle
from ..workloads.two_qubit_eval import model_gate_pulses
from ..workloads.universal_single_qubit import load_base_pulse

__all__ = ["MODEL_VARIANTS", "TWO_QUBIT_VARIANTS", "load_pipeline", "compute_pulses",
           "default_variant", "two_qubit_model_kwargs", "two_qubit_pulse_table",
           "two_qubit_robustness"]

_JAX_PACKAGE_DIR = (Path(__file__).resolve().parent.parent.parent
                    / "universal_quantum_optimal_control_tpu")
_CONFIG_DIR = _JAX_PACKAGE_DIR / "configs"
_WEIGHTS_DIR = _JAX_PACKAGE_DIR / "demo" / "weights"

# Single-qubit variants, the JAX map's.  ``length_400`` serves
# 0.2 · model + ``base_pulse`` (loaded once); the ``_gates`` variants serve a
# bundle's table for an exact named-gate request and their model elsewhere.
MODEL_VARIANTS: Dict[str, Dict] = {
    "length_100_med": {
        "config": str(_CONFIG_DIR / "universal_single_qubit_length100_med.json"),
        "checkpoint": str(_WEIGHTS_DIR / "length100_med.npz")},
    "small_20": {"config": str(_CONFIG_DIR / "universal_single_qubit_small20.json"),
                 "checkpoint": str(_WEIGHTS_DIR / "small20.npz")},
    # the flagship: d512 × 8 layers, 16 heads, L = 100, P = 2
    "length_100": {"config": str(_CONFIG_DIR / "universal_single_qubit.json"),
                   "checkpoint": str(_WEIGHTS_DIR / "length100.npz")},
    # L = 400, τ ∈ (−0.5, 0.5) through the head's relu, blended with a base
    "length_400": {"config": str(_CONFIG_DIR / "universal_single_qubit_length400.json"),
                   "checkpoint": str(_WEIGHTS_DIR / "length400.npz"),
                   "base_pulse": str(_WEIGHTS_DIR / "grape_x400_pulse.csv")},
    "length_100_gates": {
        "config": str(_CONFIG_DIR / "universal_single_qubit.json"),
        "checkpoint": str(_WEIGHTS_DIR / "length100.npz"),
        "gate_bundle": str(_WEIGHTS_DIR / "length100_gates.npz")},
    # the universal model in the 4-parameter space (φ, Ω, Δ, τ)
    "length_100_p4": {"config": str(_CONFIG_DIR / "universal_single_qubit_p4.json"),
                      "checkpoint": str(_WEIGHTS_DIR / "length100_p4.npz")},
    "length_100_gates_p4": {
        "config": str(_CONFIG_DIR / "universal_single_qubit_p4.json"),
        "checkpoint": str(_WEIGHTS_DIR / "length100_p4.npz"),
        "gate_bundle": str(_WEIGHTS_DIR / "length100_gates_p4.npz")},
    "length_400_p4": {
        "config": str(_CONFIG_DIR / "universal_single_qubit_length400_p4.json"),
        "checkpoint": str(_WEIGHTS_DIR / "length400_p4.npz")},
}


# Two-qubit variants.  "Model" variants run a universal two-qubit model
# (drive2 system, KAK tokens; d512 × 8 layers, 16 heads): the flagship
# (L = 100, σ_δ 0.05–0.3) and its σ_δ < 0.05 and σ_δ ≥ 0.35 bands
# (``_s0`` is the L = 40 artifact: no ``max_pulses``, so the JAX default of
# 40 applies).  ``two_qubit_gates`` serves the per-gate finetuned tables of
# its bundle (L = 40) for the named gates it holds and the flagship
# elsewhere; ``cz_robust`` (P = 3, the χ-only system) and ``cz_drive2``
# (P = 4, drive2) are single L = 20 CZ pulse tables.
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
    "two_qubit_gates": {
        "checkpoint": str(_WEIGHTS_DIR / "two_qubit_d2_kak.npz"),
        "drive2": True, "kak_tokens": True, "omega_min": 0.05,
        "max_pulses": 100,
        "gate_bundle": str(_WEIGHTS_DIR / "two_qubit_gates.npz")},
    "cz_robust": {"pulse_npz": str(_WEIGHTS_DIR / "cz_robust_pulse.npz")},
    "cz_drive2": {"pulse_npz": str(_WEIGHTS_DIR / "cz_drive2_pulse.npz"),
                  "drive2": True},
}

_MODEL_KEYS = ("drive2", "kak_features", "kak_tokens", "omega_min", "max_pulses",
               "d_model", "n_layers", "n_heads")


def two_qubit_model_kwargs(variant: str) -> Tuple[str, Dict]:
    """``(checkpoint, keywords)`` of a two-qubit model variant for
    ``workloads.two_qubit_eval.model_gate_pulses`` / ``best_phase_pulses``,
    with ``max_pulses`` explicit (40 where the variant names none)."""
    spec = TWO_QUBIT_VARIANTS[variant]
    if "checkpoint" not in spec:
        raise ValueError(f"two-qubit variant {variant!r} serves a fixed pulse table, "
                         f"not a model")
    kw = {k: spec[k] for k in _MODEL_KEYS if k in spec}
    kw.setdefault("max_pulses", 40)
    return spec["checkpoint"], kw


def two_qubit_pulse_table(variant: str, gate: str = "cz", device=None
                          ) -> Tuple[np.ndarray, np.ndarray, TwoQubitSystem, str]:
    """The pulse table a two-qubit variant serves, as the JAX package's
    ``render_two_qubit_artifacts`` picks it: ``(pulses (L, P) f32, u_target
    (4, 4) complex, system, label)``.

    A ``pulse_npz`` variant serves its ``pulses`` / ``u_target`` (``gate`` is
    not read); otherwise ``gate`` must be a named gate: the variant's gate
    bundle's table where the bundle holds it, else the variant's model on
    the textbook matrix (no ℤ₄ choice), run on ``device``."""
    spec = TWO_QUBIT_VARIANTS[variant]
    system = TwoQubitSystem(drive2=spec.get("drive2", False))
    if "pulse_npz" in spec:
        with np.load(spec["pulse_npz"]) as z:
            return z["pulses"], z["u_target"], system, variant
    targets = named_two_qubit_targets()
    if gate not in targets:
        raise ValueError(f"unknown gate {gate!r}; available: {sorted(targets)}")
    u_target = targets[gate]
    bundle = spec.get("gate_bundle")
    tables = load_two_qubit_gate_bundle(bundle)[0] if bundle and Path(bundle).exists() else {}
    if gate in tables:
        pulses = np.asarray(tables[gate])
    else:
        checkpoint, kw = two_qubit_model_kwargs(variant)
        packed = SU4System.pack_target(u_target[None]).to(resolve_device(device))
        pulses = model_gate_pulses(checkpoint, packed, **kw)[0].cpu().numpy()
    return pulses, u_target, system, f"{variant}:{gate}"


def two_qubit_robustness(variant: str, gate: str = "cz", monte_carlo: int = 2000,
                         device=None) -> Dict:
    """The numbers behind the JAX demo's E[F](σ_δ) figure of a two-qubit
    variant: its pulse table (:func:`two_qubit_pulse_table`) swept over the
    demo's grid σ_δ = 0.02, 0.04, …, 0.40 through kernel B7
    (``analysis/plots_su4.py::fidelity_by_std_su4``, its default draws).
    Returns ``{"label", "pulses", "u_target", "system", "stds", "mean",
    "se"}``."""
    pulses, u_target, system, label = two_qubit_pulse_table(variant, gate, device)
    stds, mean, se = fidelity_by_std_su4(pulses, u_target, system,
                                         stds=np.arange(0.02, 0.42, 0.02),
                                         monte_carlo=monte_carlo, device=device)
    return {"label": label, "pulses": pulses, "u_target": u_target, "system": system,
            "stds": stds, "mean": mean, "se": se}


@functools.lru_cache(maxsize=4)
def load_pipeline(variant: str, checkpoint: Optional[str] = None, device=None,
                  dtype: torch.dtype = torch.bfloat16) -> Pipeline:
    """Build and cache an eval-mode Pipeline for a model variant.

    ``checkpoint`` overrides the variant's ``.npz``; ``dtype`` is the
    encoder's compute dtype (bf16 by default, as the JAX demo serves).  A
    variant with a ``base_pulse`` serves the blend 0.2 · model + base, its
    base loaded once here.
    """
    spec = MODEL_VARIANTS[variant]
    ckpt = str(checkpoint or spec["checkpoint"])
    if not ckpt.endswith(".npz"):
        raise ValueError(f"checkpoint must be an .npz artifact, got {ckpt!r}")
    dev = resolve_device(device)
    model_params = load_model_params(spec["config"])
    model_params["pulse_space"] = normalize_pulse_space(model_params["pulse_space"])
    base_pulse = None
    if spec.get("base_pulse"):
        base_pulse = torch.as_tensor(load_base_pulse(spec["base_pulse"]), device=dev)
    model_params["finetune"] = base_pulse is not None
    model = UniversalQOCTransformer(**model_params, dtype=dtype, device=dev)
    model.load_state_dict(params_from_jax(load_params_npz(ckpt)))
    return Pipeline(model, base_pulse=base_pulse)


def _gate_bundle_lookup(variant: str, rv: np.ndarray) -> Optional[np.ndarray]:
    """The variant's bundle table ``(L, P)`` where the request ``rv`` ``(1,
    4)`` matches one of its named gates (axis and angle within 1e-5), else
    ``None``."""
    path = MODEL_VARIANTS[variant].get("gate_bundle")
    if not path or not Path(path).exists():
        return None
    tables, meta = load_gate_bundle(path)
    for name, gate_rv in zip(meta["gates"], meta["rotation_vectors"]):
        if np.allclose(rv[0], np.asarray(gate_rv, np.float32), atol=1e-5):
            return tables[name]
    return None


def compute_pulses(variant: str, x: float, y: float, z: float, theta: float,
                   checkpoint: Optional[str] = None, device=None,
                   dtype: torch.dtype = torch.bfloat16) -> Tuple[np.ndarray, torch.Tensor]:
    """Rotation spec → ``(pulses (L, P) numpy, target quaternion (4,))``: the
    variant's bundle table for an exact named-gate request, else its
    model's."""
    n = np.asarray([x, y, z], np.float64)
    n = n / max(np.linalg.norm(n), 1e-12)
    rv = np.asarray([[n[0], n[1], n[2], theta]], np.float32)
    pulses = _gate_bundle_lookup(variant, rv)
    if pulses is None:
        pipe = load_pipeline(variant, checkpoint, device, dtype)
        pulses = pipe(rv)[0].cpu().numpy()
    return pulses, rotation_vector_to_quat(torch.from_numpy(rv[0]))


def default_variant() -> str:
    """The flagship variant if its weights ship, else the best shipped one."""
    for name in ("length_100", "length_100_med", "small_20"):
        if MODEL_VARIANTS[name]["checkpoint"] is not None:
            return name
    return "length_100_med"
