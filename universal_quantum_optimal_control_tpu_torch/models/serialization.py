r"""Read the JAX package's ``.npz`` weight artifacts into the port's models.

The artifacts are flat ``.npz`` files keyed by ``//``-joined Flax tree paths
(``params//encoder_0//Dense_0//kernel``).  Matmul-sized tensors may be
stored as int8 with a per-output-channel f32 scale under ``<key>!scale``
(dequantized as ``q.astype(f32) * scale``); the rest may be f16.  Reading is
numpy only: the port never imports JAX to load them.

:func:`params_from_jax` is the one place that knows both layouts: it turns
Flax parameters (numpy arrays keyed by those paths) into the
``state_dict`` of :class:`.universal_transformer.UniversalQOCTransformer`.
:func:`transfer_encoder_params` copies the shape-matching blocks of one such
``state_dict`` into another (the ``--pretrained_encoder`` warm start).
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["load_params_npz", "params_from_jax", "transfer_encoder_params"]

_SEP = "//"
_SCALE_SUFFIX = "!scale"
_ATTN = "MultiHeadDotProductAttention_0"
_LAYER_NORMS = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2"}
_DENSES = {"Dense_0": "dense0", "Dense_1": "dense1"}


def load_params_npz(path: str) -> Dict[str, np.ndarray]:
    """All tensors of an artifact as f32 numpy arrays keyed by Flax path,
    int8 tensors dequantized with their ``!scale`` companions."""
    with np.load(path) as data:
        out = {}
        for key in data.files:
            if key.endswith(_SCALE_SUFFIX):
                continue
            arr = data[key]
            if arr.dtype == np.int8 and key + _SCALE_SUFFIX in data.files:
                arr = arr.astype(np.float32) * data[key + _SCALE_SUFFIX]
            out[key] = np.asarray(arr, dtype=np.float32)
    return out


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flax parameters keyed by ``//``-joined paths (with or without the
    leading ``params``) → the port model's f32 ``state_dict``.

    Flax ``Dense`` kernels are ``(in, out)``; torch ``Linear`` weights are
    ``(out, in)``.  Attention ``query/key/value`` kernels ``(d, H, Dh)`` and
    biases ``(H, Dh)`` flatten the heads; the ``out`` kernel ``(H, Dh, d)``
    likewise.  LayerNorm ``scale`` is the torch ``weight``.
    """
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        if parts[0] == "params":
            parts = parts[1:]
        arr = np.asarray(value, dtype=np.float32)
        name = _torch_name(parts, key)
        leaf = parts[-1]
        if leaf == "kernel":
            if parts[-2] == "out":
                arr = arr.reshape(-1, arr.shape[-1])
            else:
                arr = arr.reshape(arr.shape[0], -1)
            arr = arr.T
        elif leaf == "bias":
            arr = arr.reshape(-1)
        sd[name] = torch.from_numpy(np.array(arr, dtype=np.float32, order="C"))
    return sd


def _torch_name(parts, key: str) -> str:
    leaf = parts[-1]
    torch_leaf = {"kernel": "weight", "bias": "bias", "scale": "weight"}.get(leaf)
    if torch_leaf is None:
        raise KeyError(f"unrecognized parameter {key!r}")
    if len(parts) == 2 and parts[0] in ("unitary_proj", "head"):
        return f"{parts[0]}.{torch_leaf}"
    m = re.fullmatch(r"encoder_(\d+)", parts[0])
    if m:
        i = int(m.group(1))
        if len(parts) == 4 and parts[1] == _ATTN and \
                parts[2] in ("query", "key", "value", "out"):
            return f"encoder.{i}.attn.{parts[2]}.{torch_leaf}"
        if len(parts) == 3 and parts[1] in _LAYER_NORMS:
            return f"encoder.{i}.{_LAYER_NORMS[parts[1]]}.{torch_leaf}"
        if len(parts) == 3 and parts[1] in _DENSES and leaf != "scale":
            return f"encoder.{i}.{_DENSES[parts[1]]}.{torch_leaf}"
    raise KeyError(f"unrecognized parameter {key!r}")


def _module_of(name: str) -> str:
    """``encoder.3.attn.query.weight`` → ``encoder.3``; ``head.bias`` → ``head``."""
    parts = name.split(".")
    return ".".join(parts[:2]) if parts[0] == "encoder" else parts[0]


def transfer_encoder_params(src: Mapping[str, torch.Tensor],
                            dst: Mapping[str, torch.Tensor],
                            also: tuple = ()) -> Dict[str, torch.Tensor]:
    """Copy every shape-matching encoder block of ``src`` into ``dst``
    (port of the JAX package's ``models/two_qubit.py::transfer_encoder_params``).

    Both are ``state_dict``s of the port's transformer.  A block
    ``encoder.i`` (or a top-level module named in ``also``, such as
    ``"unitary_proj"``) is copied whole when ``dst`` has the same parameter
    names with the same shapes; everything else keeps ``dst``'s values.  As
    in the JAX package, modules named in ``also`` count toward the transfer,
    and a transfer of nothing raises.  Returns a new ``state_dict``.
    """
    groups: Dict[str, Dict[str, torch.Tensor]] = {}
    for name, value in src.items():
        groups.setdefault(_module_of(name), {})[name] = value
    out = dict(dst)
    transferred = 0
    for module, params in groups.items():
        if not (module.startswith("encoder.") or module in also):
            continue
        dst_names = {n for n in dst if _module_of(n) == module}
        if dst_names == set(params) and all(
                params[n].shape == dst[n].shape for n in params):
            for n, v in params.items():
                out[n] = v.detach().to(dtype=dst[n].dtype, device=dst[n].device).clone()
            transferred += 1
    if transferred == 0:
        raise ValueError(
            "no encoder blocks transferred — check that d_model/n_heads "
            "match between the source and destination models")
    return out
