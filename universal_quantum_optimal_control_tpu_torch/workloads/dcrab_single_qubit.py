r"""dCRAB single-qubit optimization — CLI entry point (PyTorch port of
``workloads/dcrab_single_qubit.py``).

The reference dCRAB main (train/dCRAB/dCRAB.py:127-149): X(π/2) target,
N = 2000 Fourier modes, T = 6, dt = 0.01, 200 disorder samples, 5 restart
rounds, ω ∈ (0.1, N·π), seed 42; saves the best parameters to ``.npz``.
Gradient mode by default (Adam through autograd); ``--mode nm`` runs the
batched Nelder–Mead.  The JAX CLI's flags and defaults, plus ``--device``
(default ``cuda``).

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.dcrab_single_qubit \
        --mode grad --steps 500 --out dcrab_best_params.npz
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from ..core.su2 import axis_angle_to_quat
from ..optimizers.dcrab import dcrab_optimize


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="dCRAB pulse optimization")
    p.add_argument("--mode", type=str, default="grad", choices=["grad", "nm"])
    p.add_argument("--n_modes", type=int, default=2000)
    p.add_argument("--T", type=float, default=6.0)
    p.add_argument("--dt", type=float, default=0.01)
    p.add_argument("--rounds", type=int, default=5)
    p.add_argument("--samples", type=int, default=200)
    p.add_argument("--w_min", type=float, default=0.1)
    p.add_argument("--w_max", type=float, default=None,
                   help="default: n_modes * pi (reference dCRAB.py:141)")
    p.add_argument("--steps", type=int, default=500, help="adam steps (grad mode)")
    p.add_argument("--maxiter", type=int, default=1000,
                   help="NM iterations (nm mode, reference maxiter)")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", type=str, default="dcrab_best_params.npz")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"params", "omegas", "fidelity"}`` and, in
    grad mode, ``"losses"`` (each step's infidelity summed over rounds)."""
    args = build_parser().parse_args(argv)
    w_max = args.w_max if args.w_max is not None else args.n_modes * np.pi

    # target: X(pi/2) (reference dCRAB.py:130-131)
    q_target = axis_angle_to_quat(torch.tensor([1.0, 0.0, 0.0]), torch.tensor(math.pi / 2))

    cfg = dict(T=args.T, dt=args.dt, n_modes=args.n_modes, rounds=args.rounds,
               samples=args.samples, w_min=args.w_min, w_max=w_max, seed=args.seed)
    extra = ({"steps": args.steps, "return_losses": True} if args.mode == "grad"
             else {"maxiter": args.maxiter})
    out = dcrab_optimize(q_target, mode=args.mode, device=args.device, **cfg, **extra)
    (params, omegas), fid = out[:2]

    print(f"best fidelity: {fid:.6f}")
    np.savez(args.out, params=params, omegas=omegas)
    print(f"saved best parameters to '{args.out}'")
    result = {"params": params, "omegas": omegas, "fidelity": fid}
    if args.mode == "grad":
        result["losses"] = out[2]
    return result


if __name__ == "__main__":
    main()
