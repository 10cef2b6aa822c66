r"""The JAX package's ``.npz`` weight artifacts: read into the port's models,
and written from them.

The artifacts are flat ``.npz`` files keyed by ``//``-joined Flax tree paths
(``params//encoder_0//Dense_0//kernel``).  Matmul-sized tensors may be
stored as int8 with a per-output-channel f32 scale under ``<key>!scale``
(dequantized as ``q.astype(f32) * scale``); the rest may be f16.  Reading is
numpy only: the port never imports JAX to load or write them.

:func:`params_from_jax` is the one place that knows both layouts: it turns
Flax parameters (numpy arrays keyed by those paths) into the
``state_dict`` of :class:`.universal_transformer.UniversalQOCTransformer`
or of :class:`.grape.GRAPE` (its bias-free ``fc1`` / ``fc2`` and the direct
``pulse_logits`` table); :func:`params_to_jax` is its inverse, and
:func:`save_params_npz` writes the JAX package's artifact format from it
(the same keys, layouts, dtypes and int8 quantization, so the JAX
package's loaders read the port's exports).
:func:`transfer_encoder_params` copies the shape-matching blocks of one such
``state_dict`` into another (the ``--pretrained_encoder`` warm start).
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch

__all__ = ["load_params_npz", "load_params_npz_tree", "save_params_npz",
           "params_from_jax", "params_to_jax", "transfer_encoder_params"]

_SEP = "//"
_SCALE_SUFFIX = "!scale"
_ATTN = "MultiHeadDotProductAttention_0"
_LAYER_NORMS = {"LayerNorm_0": "ln1", "LayerNorm_1": "ln2"}
_DENSES = {"Dense_0": "dense0", "Dense_1": "dense1"}
# int8 applies to float tensors of at least this many elements and ndim >= 2
_INT8_MIN_SIZE = 4096


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


def load_params_npz_tree(path: str, dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """An artifact as a nested dict keyed by its path parts (``params`` →
    ``encoder_0`` → … → ``kernel``), leaves as ``dtype`` tensors, int8
    tensors dequantized: no model structure is needed, so shape-tolerant
    uses (encoder transplants) can read any artifact."""
    tree: Dict[str, Any] = {}
    for key, arr in load_params_npz(path).items():
        node = tree
        parts = key.split(_SEP)
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = torch.as_tensor(arr, dtype=dtype)
    return tree


def _quantize_int8(v: np.ndarray):
    """Per-output-channel symmetric int8 quantization of an f32 tensor in
    the Flax layout, the output channel being the LAST axis (Flax ``Dense``
    kernels are ``(in, out)``): ``v ≈ q · scale``, ``scale`` broadcasting
    over ``v``; the JAX package's ``_quantize_int8`` step for step."""
    amax = np.abs(v).max(axis=tuple(range(v.ndim - 1)), keepdims=True)
    scale = (amax / 127.0).astype(np.float32)
    scale = np.where(scale == 0.0, 1.0, scale)
    q = np.clip(np.rint(v / scale), -127, 127).astype(np.int8)
    return q, scale


def save_params_npz(path: str, params: Mapping[str, Any], dtype=None,
                    n_heads: Optional[int] = None) -> None:
    """Write the JAX package's single-file artifact.

    ``params``: a port model's ``state_dict`` (turned into the Flax layout
    by :func:`params_to_jax`, which needs ``n_heads`` where there is
    attention), or Flax parameters already keyed by ``//``-joined paths.
    ``dtype``: ``None`` keeps f32; a numpy float dtype casts every tensor;
    ``"int8"`` stores float tensors with ndim ≥ 2 and ≥ 4096 elements as
    int8 with an f32 scale per output channel under ``<key>!scale`` (the
    quantization runs in the Flax layout, whose last axis is the output
    channel) and every other float tensor as f16.
    """
    flat = (dict(params) if all(_SEP in k for k in params)
            else params_to_jax(params, n_heads))
    flat = {k: np.asarray(v.detach().cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in flat.items()}
    if dtype == "int8":
        out: Dict[str, np.ndarray] = {}
        for k, v in flat.items():
            if not np.issubdtype(v.dtype, np.floating):
                out[k] = v
            elif v.ndim >= 2 and v.size >= _INT8_MIN_SIZE:
                out[k], out[k + _SCALE_SUFFIX] = _quantize_int8(v.astype(np.float32))
            else:
                out[k] = v.astype(np.float16)
        flat = out
    elif dtype is not None:
        flat = {k: v.astype(dtype) for k, v in flat.items()}
    np.savez_compressed(path, **flat)


def params_to_jax(state_dict: Mapping[str, torch.Tensor],
                  n_heads: Optional[int] = None) -> Dict[str, np.ndarray]:
    """A port model's ``state_dict`` → Flax parameters as f32 numpy arrays
    keyed by ``params//``-prefixed paths: the inverse of
    :func:`params_from_jax`.  ``Linear`` weights ``(out, in)`` become
    ``Dense`` kernels ``(in, out)``; the attention's flattened heads are
    split back with ``n_heads`` (``query/key/value`` kernels
    ``(d, H, Dh)``, biases ``(H, Dh)``, the ``out`` kernel ``(H, Dh, d)``);
    LayerNorm ``weight`` is ``scale``."""
    inverse = {v: k for k, v in {**_LAYER_NORMS, **_DENSES}.items()}
    flat: Dict[str, np.ndarray] = {}
    for name, value in state_dict.items():
        arr = value.detach().to("cpu", torch.float32).numpy()
        parts = name.split(".")
        if parts == ["pulse_logits"]:
            flat[_SEP.join(["params", "pulse_logits"])] = arr
            continue
        leaf = {"weight": "kernel", "bias": "bias"}.get(parts[-1])
        if leaf is None:
            raise KeyError(f"unrecognized parameter {name!r}")
        if parts[0] == "encoder" and len(parts) == 5 and parts[2] == "attn":
            if n_heads is None:
                raise ValueError(
                    f"{name}: the attention's flattened heads need n_heads to "
                    f"split back into the Flax layout; pass n_heads")
            proj = parts[3]
            d = arr.shape[-1] if leaf == "kernel" else None
            if leaf == "kernel":
                arr = arr.T  # (in, out)
                arr = (arr.reshape(n_heads, -1, arr.shape[1]) if proj == "out"
                       else arr.reshape(d, n_heads, -1))
            elif proj != "out":
                arr = arr.reshape(n_heads, -1)
            path = [f"encoder_{parts[1]}", _ATTN, proj, leaf]
        elif parts[0] == "encoder" and len(parts) == 4 and parts[2] in inverse:
            module = inverse[parts[2]]
            if module.startswith("LayerNorm") and leaf == "kernel":
                leaf = "scale"
            elif leaf == "kernel":
                arr = arr.T
            path = [f"encoder_{parts[1]}", module, leaf]
        elif len(parts) == 2 and parts[0] in ("unitary_proj", "head", "fc1", "fc2"):
            path = [parts[0], leaf]
            if leaf == "kernel":
                arr = arr.T
        else:
            raise KeyError(f"unrecognized parameter {name!r}")
        flat[_SEP.join(["params"] + path)] = np.ascontiguousarray(arr, dtype=np.float32)
    return flat


def params_from_jax(flat: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """Flax parameters keyed by ``//``-joined paths (with or without the
    leading ``params``) → the port model's f32 ``state_dict``.

    Flax ``Dense`` kernels are ``(in, out)``; torch ``Linear`` weights are
    ``(out, in)``.  Attention ``query/key/value`` kernels ``(d, H, Dh)`` and
    biases ``(H, Dh)`` flatten the heads; the ``out`` kernel ``(H, Dh, d)``
    likewise.  LayerNorm ``scale`` is the torch ``weight``.  GRAPE's
    ``pulse_logits`` table carries as it is.
    """
    sd: Dict[str, torch.Tensor] = {}
    for key, value in flat.items():
        parts = key.split(_SEP)
        if parts[0] == "params":
            parts = parts[1:]
        arr = np.asarray(value, dtype=np.float32)
        if parts == ["pulse_logits"]:
            sd["pulse_logits"] = torch.from_numpy(np.array(arr, order="C"))
            continue
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
    if len(parts) == 2 and parts[0] in ("unitary_proj", "head", "fc1", "fc2"):
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
