r"""Interactive demo: serve the trained universal models (port of the JAX
package's ``demo/app.py``).

Pick a model variant and a target rotation (axis and angle), and get the
pulse table (CSV), the fidelity contour, the pulse-parameter plot, the
fidelity-vs-σ curve and a Bloch evolution video
(:func:`render_artifacts`); or, for a two-qubit variant, its pulse CSV,
F(δ₁, δ₂) contour and E[F](σ_δ) curve (:func:`render_two_qubit_artifacts`).

The single-qubit variant map holds the shipped universal models, the
``length_400`` blend of 0.2 · model + its base pulse, and the
``length_100_gates`` / ``length_100_gates_p4`` per-gate bundles, which serve
a bundle's table for an exact named-gate request and the model elsewhere.
The two-qubit variants (``TWO_QUBIT_VARIANTS``) are the three model
variants, served through ``workloads/two_qubit_eval.py``, the
``two_qubit_gates`` per-gate bundle and the ``cz_robust`` / ``cz_drive2``
pulse tables.  Models load once and are cached.  The Monte-Carlo numbers run
through kernel B3 (one qubit) or B7 (two qubits) on CUDA.  The configs,
``.npz`` weights and the base pulse ``.csv`` are the JAX package's own files,
read where they lie (reading a data file imports nothing of that package).

matplotlib is imported by the renderers when called, and Gradio by
:func:`launch_gradio`; without Gradio, ``main --serve`` renders through the
CLI instead.  On the CPU:
    python -m universal_quantum_optimal_control_tpu_torch.demo.app --device cpu \
        --variant small_20 --out /tmp/d
"""

from __future__ import annotations

import argparse
import csv
import functools
import tempfile
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
from ..training.checkpoint import restore_checkpoint
from ..training.systems import SU4System
from ..utils import load_model_params, resolve_device
from ..workloads.finetune_gates import load_gate_bundle
from ..workloads.finetune_two_qubit_gates import load_two_qubit_gate_bundle
from ..workloads.two_qubit_eval import model_gate_pulses
from ..workloads.universal_single_qubit import load_base_pulse

__all__ = ["MODEL_VARIANTS", "TWO_QUBIT_VARIANTS", "load_pipeline", "compute_pulses",
           "default_variant", "two_qubit_model_kwargs", "two_qubit_pulse_table",
           "two_qubit_robustness", "render_two_qubit_artifacts", "render_artifacts",
           "launch_gradio", "main"]

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


_PULSE_COLS = {2: ["phi", "tau"], 3: ["phi", "omega", "tau"],
               4: ["phi1", "phi2", "omega", "tau"]}


def _write_csv(path: str, header, pulses: np.ndarray) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(header)
        w.writerows(np.asarray(pulses).tolist())


def render_two_qubit_artifacts(variant: str, gate: str, out_dir: str,
                               monte_carlo: int = 2000, n_delta: int = 61,
                               device=None) -> Dict[str, str]:
    """Render a two-qubit variant's artifacts into ``out_dir``: the pulse
    CSV (``pulses.csv``), the F(δ₁, δ₂) contour (``contour_d1d2.png``, an
    ``n_delta``² grid through B7) and the E[F](σ_δ) curve
    (``fid_by_std.png``, :func:`two_qubit_robustness`).  Returns the paths
    under the keys ``csv``, ``contour`` and ``fidelity``."""
    from ..analysis.plots import _pyplot
    from ..analysis.plots_su4 import fidelity_contour_plot_su4

    plt = _pyplot()
    r = two_qubit_robustness(variant, gate, monte_carlo=monte_carlo, device=device)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    paths = {"csv": str(out / "pulses.csv")}
    _write_csv(paths["csv"], _PULSE_COLS[r["pulses"].shape[-1]], r["pulses"])

    paths["contour"] = str(out / "contour_d1d2.png")
    fidelity_contour_plot_su4(r["pulses"], r["u_target"], r["system"],
                              save_path=paths["contour"], title=r["label"],
                              n_delta=n_delta, device=device)

    paths["fidelity"] = str(out / "fid_by_std.png")
    fig, ax = plt.subplots(figsize=(6.0, 4.0))
    ax.errorbar(r["stds"], r["mean"], yerr=r["se"], lw=1.2)
    ax.set_xlabel(r"$\sigma_\delta$ (both qubits)")
    ax.set_ylabel("E[F]")
    ax.set_title(f"{r['label']}  two-qubit robustness")
    ax.grid(alpha=0.3)
    fig.tight_layout()
    fig.savefig(paths["fidelity"], dpi=120)
    plt.close(fig)
    return paths


@functools.lru_cache(maxsize=4)
def load_pipeline(variant: str, checkpoint: Optional[str] = None, random_init: bool = False,
                  device=None, dtype: torch.dtype = torch.bfloat16) -> Pipeline:
    """Build and cache an eval-mode Pipeline for a model variant.

    ``checkpoint`` overrides the variant's weights: an ``.npz`` artifact or a
    ``dir:tag`` band checkpoint of the port's trainer.  With neither (a
    variant registered without weights), ``random_init`` serves the port's
    initialization seeded with 0.  ``dtype`` is the encoder's compute dtype
    (bf16 by default, as the JAX demo serves).  A variant with a
    ``base_pulse`` serves the blend 0.2 · model + base, its base loaded once
    here.
    """
    spec = MODEL_VARIANTS[variant]
    dev = resolve_device(device)
    model_params = load_model_params(spec["config"])
    model_params["pulse_space"] = normalize_pulse_space(model_params["pulse_space"])
    base_pulse = None
    if spec.get("base_pulse"):
        base_pulse = torch.as_tensor(load_base_pulse(spec["base_pulse"]), device=dev)
    model_params["finetune"] = base_pulse is not None
    model = UniversalQOCTransformer(**model_params, dtype=dtype, device=dev)
    ckpt = checkpoint or spec["checkpoint"]
    if ckpt is not None and str(ckpt).endswith(".npz"):
        model.load_state_dict(params_from_jax(load_params_npz(str(ckpt))))
    elif ckpt is not None:
        base_dir, tag = str(ckpt).rsplit(":", 1)
        model.load_state_dict(restore_checkpoint(base_dir, tag)[0])
    elif random_init:
        model.init_like_flax(torch.Generator(device=dev).manual_seed(0))
    else:
        raise ValueError(f"no checkpoint registered for variant {variant}; pass "
                         "checkpoint='dir:tag' / a .npz path, or random_init=True")
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
                   checkpoint: Optional[str] = None, random_init: bool = False,
                   device=None, dtype: torch.dtype = torch.bfloat16
                   ) -> Tuple[np.ndarray, torch.Tensor]:
    """Rotation spec → ``(pulses (L, P) numpy, target quaternion (4,))``: the
    variant's bundle table for an exact named-gate request, else its
    model's."""
    n = np.asarray([x, y, z], np.float64)
    n = n / max(np.linalg.norm(n), 1e-12)
    rv = np.asarray([[n[0], n[1], n[2], theta]], np.float32)
    pulses = _gate_bundle_lookup(variant, rv)
    if pulses is None:
        pipe = load_pipeline(variant, checkpoint, random_init, device, dtype)
        pulses = pipe(rv)[0].cpu().numpy()
    return pulses, rotation_vector_to_quat(torch.from_numpy(rv[0]))


def default_variant() -> str:
    """The flagship variant if its weights ship, else the best shipped one."""
    for name in ("length_100", "length_100_med", "small_20"):
        if MODEL_VARIANTS[name]["checkpoint"] is not None:
            return name
    return "length_100_med"


# single-qubit channel order across P ∈ {2, 3, 4} (core/propagate.py)
_SU2_COLS = {2: ["phi", "tau"], 3: ["phi", "omega", "tau"],
             4: ["phi", "omega", "delta", "tau"]}


def render_artifacts(variant: str, x: float, y: float, z: float, theta: float,
                     out_dir: str, checkpoint: Optional[str] = None,
                     random_init: bool = False, monte_carlo: int = 10000,
                     video: bool = True, device=None) -> Dict[str, str]:
    """Render the full artifact set for one target into ``out_dir``; returns
    the paths under ``csv`` (``pulses.csv``), ``contour`` (``contour.png``),
    ``params`` (``params.png``), ``fidelity`` (``fid_fidelity.png``, beside
    ``fid_infidelity_with_fit.png``) and, with ``video``, ``video``: the
    path written, ``evolution.mp4`` or, without ffmpeg, ``evolution.gif``."""
    from ..analysis.bloch import animate_bloch_ensemble
    from ..analysis.plots import fidelity_contour_plot, plot_fidelity_by_std, plot_pulse_param

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    pulses, q_target = compute_pulses(variant, x, y, z, theta, checkpoint, random_init,
                                      device=device)

    paths = {"csv": str(out / "pulses.csv")}
    _write_csv(paths["csv"], _SU2_COLS[pulses.shape[-1]], pulses)
    paths["contour"] = str(out / "contour.png")
    fidelity_contour_plot(pulses, q_target, save_path=paths["contour"],
                          title=f"θ={theta:.3f}", monte_carlo=monte_carlo, device=device)
    paths["params"] = str(out / "params.png")
    plot_pulse_param(pulses, save_path=paths["params"])
    plot_fidelity_by_std(pulses, q_target, save_prefix=str(out / "fid"),
                         monte_carlo=monte_carlo, device=device)
    paths["fidelity"] = str(out / "fid_fidelity.png")
    if video:
        paths["video"] = animate_bloch_ensemble(pulses, q_target, n_samples=12,
                                                save_path=str(out / "evolution.mp4"),
                                                device=device)
    return paths


def launch_gradio(checkpoints: Dict[str, str], share: bool = False, device=None):
    """Gradio UI (needs gradio installed).  ``checkpoints`` (variant →
    checkpoint) override ``MODEL_VARIANTS``' before serving.  Each request
    renders into a fresh directory that outlives the call, so Gradio can
    still read the files it is handed."""
    import gradio as gr

    for k, v in checkpoints.items():
        MODEL_VARIANTS[k]["checkpoint"] = v

    def run(variant, x, y, z, theta):
        out_dir = tempfile.mkdtemp(prefix="uqoc_demo_")
        paths = render_artifacts(variant, x, y, z, theta, out_dir, device=device)
        return (paths["csv"], paths["contour"], paths["params"], paths["fidelity"],
                paths.get("video"))

    demo = gr.Interface(
        fn=run,
        inputs=[
            gr.Dropdown(list(MODEL_VARIANTS), value="length_100", label="model"),
            gr.Slider(-1, 1, value=1.0, label="n_x"),
            gr.Slider(-1, 1, value=0.0, label="n_y"),
            gr.Slider(-1, 1, value=0.0, label="n_z"),
            gr.Slider(0, float(np.pi), value=float(np.pi), label="θ"),
        ],
        outputs=[gr.File(label="pulse CSV"), gr.Image(label="contour"),
                 gr.Image(label="pulse params"), gr.Image(label="fidelity vs σ"),
                 gr.Video(label="evolution")],
        title="Universal Quantum Optimal Control (H100)",
    )
    demo.launch(share=share)
    return demo


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="QOC demo")
    p.add_argument("--variant", default=default_variant(), choices=list(MODEL_VARIANTS))
    p.add_argument("--checkpoint", default=None, help="'dir:tag'")
    p.add_argument("--random-init", action="store_true")
    p.add_argument("--axis", default="1,0,0")
    p.add_argument("--theta", type=float, default=float(np.pi))
    p.add_argument("--out", default="demo_out")
    p.add_argument("--monte_carlo", type=int, default=10000)
    p.add_argument("--no-video", action="store_true")
    p.add_argument("--serve", action="store_true",
                   help="launch the Gradio UI (requires gradio)")
    p.add_argument("--two_qubit", default=None, choices=list(TWO_QUBIT_VARIANTS),
                   help="render SU(4) artifacts for a two-qubit variant "
                        "instead of the single-qubit set")
    p.add_argument("--gate", default="cz",
                   help="named two-qubit gate for --two_qubit model variants")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)

    if args.two_qubit:
        paths = render_two_qubit_artifacts(args.two_qubit, args.gate, args.out,
                                           monte_carlo=min(args.monte_carlo, 4096),
                                           device=args.device)
        for k, v in paths.items():
            print(f"{k}: {v}")
        return

    if args.serve:
        try:
            ckpts = {args.variant: args.checkpoint} if args.checkpoint else {}
            launch_gradio(ckpts, device=args.device)
            return
        except ImportError:
            print("gradio not installed — falling back to CLI rendering")

    x, y, z = (float(v) for v in args.axis.split(","))
    paths = render_artifacts(args.variant, x, y, z, args.theta, args.out,
                             checkpoint=args.checkpoint, random_init=args.random_init,
                             monte_carlo=args.monte_carlo, video=not args.no_video,
                             device=args.device)
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
