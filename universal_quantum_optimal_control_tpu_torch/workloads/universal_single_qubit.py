r"""Universal single-qubit transformer training — CLI entry point (PyTorch port
of ``workloads/universal_single_qubit.py``).

SCORE-embedding transformer, grid train set / random eval set, curriculum
δ_std ∈ {0.4, 0.7, 1.0} with ε_std = 0.05, sharp (log-barrier) loss, batch
200, seed 0 — the JAX CLI's flags and defaults, except:

* ``--backend`` defaults to ``pallas``: the hand-written CUDA kernels
  (B1 forward, B3 + B2 backward).  In the JAX package "xla" is a compiled
  path of its own and its default; in the port "xla" is the eager plain
  PyTorch version, which must not be the main path on a card.  ``--backend
  xla`` stays for comparison.
* ``--device`` (default ``cuda``; the CPU tests pass ``cpu``).
* ``--mesh`` raises: the mesh is not ported yet (``ROADMAP.md`` A.17).
* ``--resume`` is passed on to the trainer (the JAX CLI parses it but never
  passes it on).

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.universal_single_qubit \
        --num_epoch 1000 --save_path weights/single_qubit_control
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from ..data import build_su2_dataset
from ..models import (UniversalQOCTransformer, load_params_npz, normalize_pulse_space,
                      params_from_jax, transfer_encoder_params)
from ..training import CurriculumBand, MetricsLogger, TrainConfig, Trainer
from ..utils import load_model_params, resolve_device

# the JAX package's config files, read as data
DEFAULT_CONFIG = str(Path(__file__).resolve().parent.parent.parent
                     / "universal_quantum_optimal_control_tpu" / "configs"
                     / "universal_single_qubit.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train universal QOC transformer")
    p.add_argument("--num_epoch", type=int, default=1000)
    p.add_argument("--save_path", type=str,
                   default="weights/single_qubit_control")
    p.add_argument("--config", type=str, default=DEFAULT_CONFIG,
                   help="model params JSON (reference-compatible)")
    p.add_argument("--batch_size", type=int, default=200,
                   help="reference: 200 for L=100, 50 for L=400")
    p.add_argument("--monte_carlo", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--backend", type=str, default="pallas",
                   choices=["xla", "pallas"],
                   help="pallas (default): the hand-written CUDA kernels, "
                        "B1 forward and B3 + B2 backward; xla: the eager "
                        "plain PyTorch version, for comparison (the JAX CLI "
                        "defaults to xla, a compiled path there)")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default) or cpu")
    p.add_argument("--mesh", type=str, default=None,
                   help="'data,mc' shards; not ported yet (raises)")
    p.add_argument("--train_size", type=int, default=10000)
    p.add_argument("--eval_size", type=int, default=1000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--fused_epoch", action=argparse.BooleanOptionalAction,
                   default=True,
                   help="no host sync inside an epoch (default on; "
                        "--no-fused_epoch reads every step's loss)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="encoder compute dtype; training defaults to f32 as "
                        "the JAX CLI does (serving stays bf16)")
    p.add_argument("--f32", action="store_true",
                   help="deprecated alias for --dtype f32 (now the default)")
    p.add_argument("--reset_opt_per_band", action="store_true",
                   help="fresh Adam moments at each curriculum band")
    p.add_argument("--shuffle", action="store_true",
                   help="re-draw minibatch composition each epoch")
    p.add_argument("--recover_collapse", type=float, default=0.0,
                   help="mid-band collapse recovery: reload band-best params "
                        "+ fresh optimizer when eval fidelity stays this far "
                        "below the band best for 3 consecutive epochs (0 = off)")
    p.add_argument("--state_every", type=int, default=0,
                   help="checkpoint FULL resume state every N epochs")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest saved state in --save_path")
    p.add_argument("--epochs_per_band", type=int, default=None,
                   help="alias for --num_epoch (epochs per curriculum band)")
    p.add_argument("--pretrained_encoder", type=str, default=None,
                   help="shipped .npz whose shape-matching encoder blocks + "
                        "unitary_proj are transplanted before training")
    p.add_argument("--finetune_base", type=str, default=None,
                   help="path to a base pulse table (.npz with 'pulses' or "
                        ".csv) for the finetune blend; implied by a string "
                        "'finetune' field in the config")
    return p


def load_base_pulse(path: str) -> np.ndarray:
    """Load a base pulse table for the finetune blend (npz or csv) as
    ``(1, L, P)`` f32, broadcasting over the batch."""
    if path.endswith(".npz"):
        with np.load(path) as data:
            arr = data["pulses"] if "pulses" in data else data[data.files[0]]
    else:
        arr = np.loadtxt(path, delimiter=",", skiprows=1)
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 3:  # saved batch — use the first sequence
        arr = arr[0]
    return arr[None]


def main(argv=None) -> dict:
    """Run the CLI; returns the training history."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)

    model_params = load_model_params(args.config)
    model_params["pulse_space"] = normalize_pulse_space(model_params["pulse_space"])
    finetune_cfg = model_params.get("finetune")
    base_path = args.finetune_base or (
        finetune_cfg if isinstance(finetune_cfg, str) else None)
    base_pulse = load_base_pulse(base_path) if base_path else None
    model_params["finetune"] = base_pulse is not None
    dtype = "f32" if args.f32 else args.dtype
    model_params["dtype"] = torch.float32 if dtype == "f32" else torch.bfloat16
    model = UniversalQOCTransformer(**model_params, device=device)

    epochs = (args.epochs_per_band if args.epochs_per_band is not None
              else args.num_epoch)
    # a per-band optimizer reset also resets the schedule, so the cosine
    # span is then one band's steps; otherwise it runs across all 3 bands
    n_bands = 1 if args.reset_opt_per_band else 3
    cfg = TrainConfig(
        monte_carlo=args.monte_carlo, batch_size=args.batch_size,
        epochs=epochs, learning_rate=args.learning_rate,
        loss="sharp", backend=args.backend, seed=args.seed,
        fused_epoch=args.fused_epoch, lr_schedule=args.lr_schedule,
        lr_schedule_steps=n_bands * epochs * max(args.train_size
                                                 // args.batch_size, 1),
        reset_optimizer_per_band=args.reset_opt_per_band,
        shuffle=args.shuffle, recover_collapse=args.recover_collapse,
        state_every=args.state_every,
    )
    mesh = tuple(int(x) for x in args.mesh.split(",")) if args.mesh else None
    trainer = Trainer(model, cfg, mesh=mesh, base_pulse=base_pulse, device=device)

    # the target sets are drawn on the CPU, so they are the same on any device
    gen = torch.Generator().manual_seed(args.seed)
    train_rv, train_qt = build_su2_dataset(gen, args.train_size, random=False,
                                           device=device)
    eval_rv, eval_qt = build_su2_dataset(gen, args.eval_size, random=True,
                                         device=device)

    params = None
    if args.pretrained_encoder:
        src = params_from_jax(load_params_npz(args.pretrained_encoder))
        params = transfer_encoder_params(src, trainer.init_params(),
                                         also=("unitary_proj",))
        print(f"transferred encoder from {args.pretrained_encoder}")

    curriculum = [CurriculumBand(d) for d in (0.4, 0.7, 1.0)]
    with MetricsLogger(path=f"{args.save_path}/metrics.csv", echo=True) as logger:
        _, history = trainer.train(
            train_rv, train_qt, eval_rv, eval_qt,
            curriculum=curriculum, params=params,
            save_dir=args.save_path, logger=logger, resume=args.resume)

    best = max(b["best_fid"] for b in history["bands"] if b["best_fid"] is not None)
    print(f"done; best eval fidelity across bands: {best:.4f}")
    return history


if __name__ == "__main__":
    main()
