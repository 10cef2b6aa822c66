r"""Mid-run resume — the full training state (port of ``training/resume.py``).

The state holds the model, the optimizer (Adam moments and the schedule's
step count), the band's best model, the trainer generator's state, and the
curriculum position, so a run continues mid-band exactly where it stopped.
``base_dir/state_{step:08d}/`` holds ``tree.pt`` and ``meta.json``; the
latter is written last and marks the state complete.
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, Optional

import torch

__all__ = ["TrainState", "save_train_state", "restore_train_state",
           "latest_step"]


@dataclass
class TrainState:
    params: Dict[str, torch.Tensor]
    opt_state: Dict[str, Any]
    best_params: Dict[str, torch.Tensor]
    generator_state: torch.Tensor
    band_idx: int = 0
    epoch: int = 0
    best_fid: float = 0.0
    extra: Dict[str, Any] = field(default_factory=dict)


def _state_dir(base: str, step: int) -> Path:
    return Path(base).absolute() / f"state_{step:08d}"


def save_train_state(base_dir: str, state: TrainState, step: int) -> str:
    """Persist the full state under ``base_dir/state_{step}``."""
    path = _state_dir(base_dir, step)
    path.mkdir(parents=True, exist_ok=True)
    torch.save({"params": state.params, "opt_state": state.opt_state,
                "best_params": state.best_params,
                "generator_state": state.generator_state}, path / "tree.pt")
    meta = {"band_idx": state.band_idx, "epoch": state.epoch,
            "best_fid": state.best_fid, "extra": state.extra, "step": step}
    with open(path / "meta.json", "w") as f:
        json.dump(meta, f, indent=2, default=float)
    return str(path)


def latest_step(base_dir: str) -> Optional[int]:
    base = Path(base_dir)
    if not base.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in base.iterdir()
             if p.name.startswith("state_") and (p / "meta.json").exists()]
    return max(steps) if steps else None


def restore_train_state(base_dir: str, step: Optional[int] = None,
                        map_location="cpu") -> TrainState:
    """Restore the full state (latest step by default)."""
    if step is None:
        step = latest_step(base_dir)
        if step is None:
            raise FileNotFoundError(f"no train state under {base_dir}")
    path = _state_dir(base_dir, step)
    tree = torch.load(path / "tree.pt", map_location=map_location, weights_only=True)
    with open(path / "meta.json") as f:
        meta = json.load(f)
    return TrainState(
        params=tree["params"], opt_state=tree["opt_state"],
        best_params=tree["best_params"],
        generator_state=tree["generator_state"].cpu(),
        band_idx=int(meta["band_idx"]), epoch=int(meta["epoch"]),
        best_fid=float(meta["best_fid"]), extra=meta.get("extra", {}),
    )
