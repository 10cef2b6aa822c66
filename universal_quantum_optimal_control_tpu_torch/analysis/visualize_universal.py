r"""Offline visualization CLI: the full analysis suite over the named gates
(port of the JAX package's ``analysis/visualize_universal.py``).

Loads a trained universal model, synthesizes pulses for the five named gates
(X, X(π/2), Y, Z(π/4), H) and writes per gate: the pulse CSV, the fidelity
contour plot, the pulse-parameter plot, the fidelity-vs-σ sweep and a
Bloch-ensemble video (a gif where ffmpeg is absent).  The Monte-Carlo work
runs through kernel B3 on CUDA.

Usage (``--checkpoint`` is a ``dir:tag`` band checkpoint of the port's
trainer; ``--random-init`` runs on the port's own seeded initialization):
    python -m universal_quantum_optimal_control_tpu_torch.analysis.visualize_universal \
        --checkpoint runs/u:band2_delta1_eps0.05 --config my_config.json \
        --out /tmp/viz --device cpu
"""

from __future__ import annotations

import argparse
import csv
from pathlib import Path

import torch

from ..core.su2 import rotation_vector_to_quat
from ..data import named_gate_rotation_vectors
from ..models import Pipeline, UniversalQOCTransformer, normalize_pulse_space
from ..training.checkpoint import restore_checkpoint
from ..utils import load_model_params, resolve_device
from .bloch import animate_bloch_ensemble
from .plots import fidelity_contour_plot, plot_fidelity_by_std, plot_pulse_param

__all__ = ["DEFAULT_CONFIG", "build_parser", "main"]

DEFAULT_CONFIG = str(Path(__file__).resolve().parent.parent.parent
                     / "universal_quantum_optimal_control_tpu" / "configs"
                     / "universal_single_qubit.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Visualize universal QOC model")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="'base_dir:tag' of a saved checkpoint")
    p.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    p.add_argument("--out", type=str, default="viz")
    p.add_argument("--monte_carlo", type=int, default=10000)
    p.add_argument("--random-init", action="store_true",
                   help="run with randomly initialized weights")
    p.add_argument("--gates", type=str, default=None,
                   help="comma-separated subset of gate names")
    p.add_argument("--skip-video", action="store_true")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)

    model_params = load_model_params(args.config)
    model_params["pulse_space"] = normalize_pulse_space(model_params["pulse_space"])
    model_params["finetune"] = bool(model_params.get("finetune"))
    model = UniversalQOCTransformer(**model_params, device=dev)

    gates = named_gate_rotation_vectors(device="cpu")
    if args.gates:
        wanted = [g.strip() for g in args.gates.split(",")]
        unknown = [g for g in wanted if g not in gates]
        if unknown:
            raise SystemExit(f"unknown gate(s) {unknown}; available: {sorted(gates)}")
        gates = {k: v for k, v in gates.items() if k in wanted}

    if args.random_init and args.checkpoint is None:
        model.init_like_flax(torch.Generator(device=dev).manual_seed(0))
    else:
        if args.checkpoint is None:
            raise SystemExit("--checkpoint or --random-init required")
        base_dir, tag = args.checkpoint.rsplit(":", 1)
        model.load_state_dict(restore_checkpoint(base_dir, tag)[0])

    pipe = Pipeline(model)

    for name, rv in gates.items():
        safe = name.replace("/", "-").replace("(", "_").replace(")", "")
        pulses = pipe(rv[None])[0].cpu().numpy()
        q_target = rotation_vector_to_quat(rv)

        with open(out / f"{safe}_pulses.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["phi", "tau"])
            w.writerows(pulses.tolist())

        fidelity_contour_plot(pulses, q_target, save_path=str(out / f"{safe}_contour.png"),
                              title=name, monte_carlo=args.monte_carlo, device=dev)
        plot_pulse_param(pulses, save_path=str(out / f"{safe}_params.png"), title=name)
        plot_fidelity_by_std(pulses, q_target, save_prefix=str(out / safe), title=name,
                             monte_carlo=args.monte_carlo, device=dev)
        if not args.skip_video:
            animate_bloch_ensemble(pulses, q_target, n_samples=12,
                                   save_path=str(out / f"{safe}_evolution.mp4"), title=name,
                                   device=dev)
        print(f"{name}: artifacts written under {out}/")


if __name__ == "__main__":
    main()
