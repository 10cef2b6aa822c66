"""Model-config loading (copy of the JAX package's ``utils/config.py``
``load_model_params``; the port may not import that package)."""

from __future__ import annotations

import json
from typing import Any, Dict

__all__ = ["load_model_params"]


def load_model_params(json_path: str) -> Dict[str, Any]:
    """Reference-compatible model-params loader: a ``model_params.json``
    dict with its pulse-space ranges turned into tuples."""
    with open(json_path) as f:
        params = json.load(f)
    if "pulse_space" in params:
        params["pulse_space"] = {
            k: tuple(v) for k, v in params["pulse_space"].items()}
    return params
