"""Config loading (the port's copy of the JAX package's ``utils/config.py``;
the port may not import that package).

``load_model_params`` reads the reference's per-workload
``model_params.json`` unchanged, its pulse-space ranges turned into tuples.
``RunConfig`` holds a whole training run (model, trainer, curriculum, data
sizes, save path) as one serializable object; ``workloads/run.py`` runs it.
"""

from __future__ import annotations

import copy
import dataclasses
import json
from typing import Any, Dict, List, Optional

__all__ = ["load_model_params", "RunConfig", "load_run_config"]


def load_model_params(json_path: str) -> Dict[str, Any]:
    """Reference-compatible model-params loader: a ``model_params.json``
    dict with its pulse-space ranges turned into tuples."""
    with open(json_path) as f:
        params = json.load(f)
    if "pulse_space" in params:
        params["pulse_space"] = {
            k: tuple(v) for k, v in params["pulse_space"].items()}
    return params


def _trainer():
    # imported when used: the training package imports this one
    from ..training import trainer
    return trainer


def _default_curriculum():
    return [_trainer().CurriculumBand(d) for d in (0.4, 0.7, 1.0)]


@dataclasses.dataclass
class RunConfig:
    """Complete training-run description (the JAX ``RunConfig``, field for
    field and default for default)."""

    model: Dict[str, Any]
    train: "TrainConfig" = dataclasses.field(  # noqa: F821
        default_factory=lambda: _trainer().TrainConfig())
    curriculum: List["CurriculumBand"] = dataclasses.field(  # noqa: F821
        default_factory=_default_curriculum)
    train_set_size: int = 10000
    eval_set_size: int = 1000
    save_path: Optional[str] = None

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "RunConfig":
        """From a JSON dict: pulse-space ranges as tuples, ``train`` as a
        ``TrainConfig``, curriculum bands from dicts or sequences."""
        tr = _trainer()
        d = copy.deepcopy(dict(d))
        if "pulse_space" in d.get("model", {}):
            d["model"]["pulse_space"] = {
                k: tuple(v) for k, v in d["model"]["pulse_space"].items()}
        if isinstance(d.get("train"), dict):
            d["train"] = tr.TrainConfig(**d["train"])
        if "curriculum" in d:
            d["curriculum"] = [tr.CurriculumBand(**b) if isinstance(b, dict)
                               else tr.CurriculumBand(*b) for b in d["curriculum"]]
        return cls(**d)

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


def load_run_config(json_path: str) -> RunConfig:
    with open(json_path) as f:
        return RunConfig.from_dict(json.load(f))
