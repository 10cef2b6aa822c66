r"""Config-driven runner: one ``RunConfig`` JSON → any training workload
(PyTorch port of ``workloads/run.py``).

The JSON holds the model, the trainer's config, the curriculum, the data
sizes and the save path, plus a ``workload`` field that picks the path:

* ``universal_single_qubit``: the SCORE-embedding transformer on the grid
  train set and a random eval set;
* ``grape_single_qubit``: the GRAPE pulse model on the same sets;
* ``two_qubit``: the SU(4) transformer on random product targets, through
  ``SU4System()`` as the JAX runner builds it — with its default backend
  ``"xla"`` (the eager plain path), whatever ``train.backend`` says.

A model ``dtype`` is given by name (``"float32"``, ``"bfloat16"``; the
transformers' default is bf16, as the Flax classes').  The target sets
come from CPU generators seeded with ``train.seed`` (the
two-qubit eval set from ``seed + 1``), so they are the same on any device
but differ from the JAX package's draws.  ``--device`` defaults to
``cuda``.

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.run run.json \
        [--save_path out] [--num_epoch N] [--device cuda|cpu]

Example JSON:
    {
      "workload": "universal_single_qubit",   // | grape_single_qubit | two_qubit
      "model": {"pulse_space": {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]},
                "max_pulses": 100, "d_model": 256, "n_layers": 6,
                "n_heads": 8, "dropout": 0.1},
      "train": {"monte_carlo": 512, "batch_size": 256, "epochs": 30,
                "learning_rate": 1e-4, "backend": "pallas"},
      "curriculum": [{"delta_std": 0.4}, {"delta_std": 0.7},
                     {"delta_std": 1.0}],
      "train_set_size": 2048, "eval_set_size": 256, "save_path": "weights/run"
    }
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any, Dict, Tuple

import torch

from ..data import build_su2_dataset
from ..models import GRAPE, TwoQubitQOCTransformer, UniversalQOCTransformer, normalize_pulse_space
from ..training import MetricsLogger, SU4System, Trainer
from ..utils import RunConfig, resolve_device
from .two_qubit import build_targets

__all__ = ["run", "main"]

WORKLOADS = ("universal_single_qubit", "grape_single_qubit", "two_qubit")


def run(config: RunConfig, workload: str, device=None) -> Tuple[float, Dict[str, Any]]:
    """Train ``config`` on ``workload``; returns the best eval fidelity
    across the bands and the trainer's history."""
    if workload not in WORKLOADS:
        raise ValueError(f"unknown workload: {workload}")
    device = resolve_device(device)
    model_kwargs = dict(config.model)
    model_kwargs["pulse_space"] = normalize_pulse_space(model_kwargs["pulse_space"])
    if isinstance(model_kwargs.get("dtype"), str):
        # a dtype by name, as JAX takes one ("float32", "bfloat16")
        model_kwargs["dtype"] = getattr(torch, model_kwargs["dtype"])
    system = None
    if workload == "universal_single_qubit":
        model_kwargs["finetune"] = bool(model_kwargs.get("finetune", False))
        model = UniversalQOCTransformer(**model_kwargs, device=device)
    elif workload == "grape_single_qubit":
        model = GRAPE(**model_kwargs, device=device)
    else:
        model = TwoQubitQOCTransformer(**model_kwargs, device=device)
        system = SU4System()
    trainer = Trainer(model, config.train, system=system, device=device)

    seed = config.train.seed
    if workload == "two_qubit":
        train_in = build_targets(seed, config.train_set_size, system.system).to(device)
        eval_in = build_targets(seed + 1, config.eval_set_size, system.system).to(device)
        train_t, eval_t = train_in, eval_in
    else:
        gen = torch.Generator().manual_seed(seed)
        train_in, train_t = build_su2_dataset(gen, config.train_set_size, device=device)
        eval_in, eval_t = build_su2_dataset(gen, config.eval_set_size, random=True,
                                            device=device)

    logger = MetricsLogger(
        path=f"{config.save_path}/metrics.csv" if config.save_path else None, echo=True)
    with logger:
        _, history = trainer.train(train_in, train_t, eval_in, eval_t,
                                   curriculum=config.curriculum,
                                   save_dir=config.save_path, logger=logger)
    best = max(b["best_fid"] for b in history["bands"] if b.get("best_fid") is not None)
    print(f"done; best eval fidelity across bands: {best:.4f}")
    return best, history


def main(argv=None) -> Tuple[float, Dict[str, Any]]:
    p = argparse.ArgumentParser(description="Config-driven training run")
    p.add_argument("config", type=str, help="RunConfig JSON with 'workload'")
    p.add_argument("--save_path", type=str, default=None)
    p.add_argument("--num_epoch", type=int, default=None)
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    args = p.parse_args(argv)

    with open(args.config) as f:
        raw = json.load(f)
    workload = raw.pop("workload", "universal_single_qubit")
    config = RunConfig.from_dict(raw)
    if args.save_path is not None:
        config.save_path = args.save_path
    if args.num_epoch is not None:
        config.train = dataclasses.replace(config.train, epochs=args.num_epoch)
    return run(config, workload, args.device)


if __name__ == "__main__":
    main()
