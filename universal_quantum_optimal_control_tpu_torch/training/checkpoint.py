r"""Band checkpoints, torch-native (port of ``training/checkpoint.py``).

Per curriculum band, ``base_dir/tag/`` holds ``params.pt`` (the model's
``state_dict``, on the CPU) and ``metadata.json`` (band, best fidelity).
The JAX package writes Orbax trees instead; the two formats are not
interchangeable.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, Mapping, Optional, Tuple

import torch

__all__ = ["save_checkpoint", "restore_checkpoint", "list_checkpoints"]

PARAMS_FILE = "params.pt"


def _ckpt_dir(base: str, tag: str) -> Path:
    return Path(base).absolute() / tag


def save_checkpoint(base_dir: str, params: Mapping[str, torch.Tensor], tag: str,
                    metadata: Optional[Dict] = None) -> str:
    """Save a ``state_dict`` under ``base_dir/tag`` (overwrites)."""
    path = _ckpt_dir(base_dir, tag)
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / f"{PARAMS_FILE}.{os.getpid()}.tmp"
    torch.save({k: v.detach().cpu() for k, v in params.items()}, tmp)
    os.replace(tmp, path / PARAMS_FILE)
    if metadata is not None:
        with open(path / "metadata.json", "w") as f:
            json.dump(metadata, f, indent=2, default=float)
    return str(path)


def restore_checkpoint(base_dir: str, tag: str, map_location="cpu"
                       ) -> Tuple[Dict[str, torch.Tensor], Optional[Dict]]:
    """Restore ``(state_dict, metadata)`` from ``base_dir/tag``."""
    path = _ckpt_dir(base_dir, tag)
    if not (path / PARAMS_FILE).exists():
        raise FileNotFoundError(
            f"no checkpoint at {path / PARAMS_FILE}; available tags in "
            f"{base_dir!r}: {list_checkpoints(base_dir)}")
    params = torch.load(path / PARAMS_FILE, map_location=map_location,
                        weights_only=True)
    meta_path = path / "metadata.json"
    metadata = None
    if meta_path.exists():
        with open(meta_path) as f:
            metadata = json.load(f)
    return params, metadata


def list_checkpoints(base_dir: str) -> list:
    base = Path(base_dir)
    if not base.exists():
        return []
    return sorted(p.name for p in base.iterdir() if (p / PARAMS_FILE).exists())
