r"""Export a band checkpoint as a shippable single-file ``.npz`` (PyTorch
port of ``workloads/export_npz.py``).

The trainer writes per-band checkpoints (``save_path/band{i}_delta{d}_eps{e}``:
``params.pt`` and ``metadata.json``); the shipped artifacts are the JAX
package's ``.npz`` format (Flax paths and layouts, f16 or int8 with
per-output-channel scales: ``models/serialization.py::save_params_npz``),
which the port's ``demo/app.py`` and the JAX package both load.  The
checkpoint's metadata must name the model's ``n_heads`` (the trainer
records it) where the model has attention.

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.export_npz \
        runs/length100:band2_delta1_eps0.05 weights/length100.npz [--dtype f16]
"""

from __future__ import annotations

import argparse

import numpy as np

from ..models.serialization import save_params_npz
from ..training.checkpoint import restore_checkpoint

__all__ = ["main"]

DTYPES = {"f16": np.float16, "f32": np.float32, "int8": "int8"}


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description="band checkpoint -> npz export")
    p.add_argument("checkpoint", help="'dir:tag' band checkpoint")
    p.add_argument("out", help="output .npz path")
    p.add_argument("--dtype", default="f16", choices=sorted(DTYPES),
                   help="stored dtype (f16 halves the artifact; int8 quantizes "
                        "matmul-sized tensors per output channel and halves it "
                        "again; serving casts back to f32)")
    args = p.parse_args(argv)

    base_dir, tag = args.checkpoint.rsplit(":", 1)
    params, meta = restore_checkpoint(base_dir, tag)
    n_heads = None
    if any(".attn." in k for k in params):
        n_heads = ((meta or {}).get("model") or {}).get("n_heads")
        if n_heads is None:
            raise ValueError(
                f"{args.checkpoint}: its metadata.json names no model n_heads "
                f"(under 'model'), which the export needs to split the "
                f"attention's flattened heads into the Flax layout")
    save_params_npz(args.out, params, dtype=DTYPES[args.dtype], n_heads=n_heads)
    n = sum(v.numel() for v in params.values())
    print(f"wrote {args.out} ({n} params, {args.dtype})"
          + (f"; metadata: {meta}" if meta else ""))
    return args.out


if __name__ == "__main__":
    main()
