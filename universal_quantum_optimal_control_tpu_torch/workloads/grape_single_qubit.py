r"""GRAPE single-qubit training — CLI entry point (PyTorch port of
``workloads/grape_single_qubit.py``).

The L = 400 pulse table through the bias-free MLP reparameterization
(``models/grape.py``), pulse space φ ∈ (−3.15, 3.15), τ ∈ (0.035, 0.07)
(``configs/grape_single_qubit.json`` of the JAX package, read as data),
curriculum δ_std ∈ {0.4, 0.7, 1.0} with ε_std 0.05, sharp loss, batch 100,
seed 42; the training set is the batch_size² grid, the eval set batch_size
random targets.  ``--direct`` trains one raw logit table for one target
(``--target_axis`` / ``--target_theta``).

The JAX CLI's flags and defaults (``--backend xla`` stays the default: in
the port that is the eager plain path; ``--backend pallas`` runs kernel B1
forward and B3 + B2 backward), except:

* ``--device`` (default ``cuda``; the CPU tests pass ``cpu``);
* ``--mesh data,mc`` runs one rank per cell under ``torchrun`` or any
  launcher that sets ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
  ``MASTER_PORT``, as the universal CLI does (``--direct`` trains one
  target, which does not shard over ``data``: use ``data`` 1);
* the targets and the disorder come from ``torch.Generator``\ s seeded
  with ``--seed``, so they differ from the JAX package's draws.

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.grape_single_qubit \
        --backend pallas --num_epoch 1000 --save_path weights/GRAPE
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.su2 import rotation_vector_to_quat
from ..data import build_su2_dataset
from ..models import GRAPE, normalize_pulse_space
from ..parallel.mesh import mesh_from_flag
from ..training import CurriculumBand, MetricsLogger, TrainConfig, Trainer
from ..utils import load_model_params, resolve_device

DEFAULT_CONFIG = str(Path(__file__).resolve().parent.parent.parent
                     / "universal_quantum_optimal_control_tpu" / "configs"
                     / "grape_single_qubit.json")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train GRAPE pulse model")
    p.add_argument("--num_epoch", type=int, default=1000)
    p.add_argument("--save_path", type=str, default="weights/GRAPE")
    p.add_argument("--config", type=str, default=DEFAULT_CONFIG)
    p.add_argument("--batch_size", type=int, default=100)
    p.add_argument("--monte_carlo", type=int, default=1000)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--backend", type=str, default="xla", choices=["xla", "pallas"],
                   help="xla (default, as the JAX CLI): the eager plain "
                        "version; pallas: the hand-written CUDA kernels, B1 "
                        "forward and B3 + B2 backward")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--mesh", type=str, default=None,
                   help="'data,mc': one rank per cell, under torchrun or a "
                        "launcher that sets RANK, WORLD_SIZE, MASTER_ADDR")
    p.add_argument("--fused_epoch", action=argparse.BooleanOptionalAction, default=True,
                   help="no host sync inside an epoch (default on; "
                        "--no-fused_epoch reads every step's loss)")
    p.add_argument("--lr_schedule", type=str, default="constant",
                   choices=["constant", "cosine"])
    p.add_argument("--direct", action="store_true",
                   help="optimize raw pulse logits (classic GRAPE) instead "
                        "of the reference MLP reparameterization; trains a "
                        "single-target pulse table for --target_axis/theta")
    p.add_argument("--target_axis", type=str, default="1,0,0",
                   help="direct mode: rotation axis of the single target")
    p.add_argument("--target_theta", type=float, default=3.141592653589793,
                   help="direct mode: rotation angle of the single target")
    p.add_argument("--seed", type=int, default=42)
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the training history."""
    args = build_parser().parse_args(argv)
    mesh, device, started = mesh_from_flag(args.mesh, args.device)
    try:
        return _run(args, mesh, resolve_device(device))
    finally:
        if started:
            dist.destroy_process_group()


def _run(args, mesh, device) -> dict:
    writer = mesh is None or mesh.rank == 0

    params_json = load_model_params(args.config)
    model = GRAPE(pulse_space=normalize_pulse_space(params_json["pulse_space"]),
                  num_pulses=params_json["num_pulses"], direct=args.direct,
                  device=device)
    cfg = TrainConfig(
        monte_carlo=args.monte_carlo, batch_size=args.batch_size,
        epochs=args.num_epoch, learning_rate=args.learning_rate,
        loss="sharp", backend=args.backend, seed=args.seed,
        fused_epoch=args.fused_epoch, lr_schedule=args.lr_schedule,
        lr_schedule_steps=3 * args.num_epoch * max(args.batch_size, 1),
    )
    trainer = Trainer(model, cfg, mesh=mesh, device=device)

    if args.direct:
        # classic GRAPE: one pulse table, one target; robustness comes from
        # the Monte-Carlo disorder axis, not target diversity
        n = np.asarray([float(v) for v in args.target_axis.split(",")])
        n = n / max(np.linalg.norm(n), 1e-12)
        train_rv = torch.tensor([[n[0], n[1], n[2], args.target_theta]],
                                dtype=torch.float32, device=device)
        train_qt = rotation_vector_to_quat(train_rv)
        eval_rv, eval_qt = train_rv, train_qt
    else:
        # the target sets are drawn on the CPU, so they are the same on any device
        gen = torch.Generator().manual_seed(args.seed)
        train_rv, train_qt = build_su2_dataset(gen, args.batch_size ** 2, random=False,
                                               device=device)
        eval_rv, eval_qt = build_su2_dataset(gen, args.batch_size, random=True,
                                             device=device)

    curriculum = [CurriculumBand(d) for d in (0.4, 0.7, 1.0)]
    with MetricsLogger(path=f"{args.save_path}/metrics.csv" if writer else None,
                       echo=writer) as logger:
        _, history = trainer.train(train_rv, train_qt, eval_rv, eval_qt,
                                   curriculum=curriculum, save_dir=args.save_path,
                                   logger=logger)

    best = max(b["best_fid"] for b in history["bands"])
    if writer:
        print(f"done; best eval fidelity across bands: {best:.4f}")
    return history


if __name__ == "__main__":
    main()
