r"""Two-qubit gate GRAPE — CLI (PyTorch port of ``workloads/two_qubit_grape.py``).

Multi-start block-structured GRAPE for entangling gates on the cross-talk +
always-on-ZZ system (:mod:`..optimizers.two_qubit_grape`), optionally over
a σ curriculum, then an E[F](σ_δ) robustness curve for the final pulse.
The JAX CLI's flags and defaults, except:

* ``--device`` (default ``cuda``; the CPU tests pass ``cpu``); the
  robustness curve propagates through kernel B7, as there;
* the random numbers come from ``torch.Generator``\ s seeded with
  ``--seed`` (the optimization) and 1 (the curve), so they differ from the
  JAX package's.

It writes ``pulses.npz``, ``robustness.csv`` and ``result.json`` into
``--out`` as the JAX CLI does.

Usage:
    python -m universal_quantum_optimal_control_tpu_torch.workloads.two_qubit_grape \
        --gate cz --sigmas 0.1,0.2 --out weights/cz
"""

from __future__ import annotations

import argparse
import json
import math
from pathlib import Path

import numpy as np
import torch

from ..core import su4
from ..ops.propagate_su4 import propagate_su4_mc_cuda, propagate_su4_mc_plain
from ..optimizers.two_qubit_grape import (TwoQubitGrapeConfig, multistart_grape_su4,
                                          named_two_qubit_targets)
from ..utils import resolve_device

__all__ = ["build_parser", "robustness_curve", "main"]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Two-qubit gate GRAPE")
    p.add_argument("--gate", default="cz",
                   help=f"named target {sorted(named_two_qubit_targets())} "
                        "or use --target_npz")
    p.add_argument("--target_npz", default=None,
                   help=".npz with a complex (4,4) 'u_target' array")
    p.add_argument("--mode", default="blocks", choices=["blocks", "table"])
    p.add_argument("--n_blocks", type=int, default=10)
    p.add_argument("--num_pulses", type=int, default=100)
    p.add_argument("--n_starts", type=int, default=24)
    p.add_argument("--steps", type=int, default=3000)
    p.add_argument("--learning_rate", type=float, default=0.02)
    p.add_argument("--sigmas", default="",
                   help="comma-separated disorder curriculum, e.g. '0.1,0.2'")
    p.add_argument("--monte_carlo", type=int, default=128)
    p.add_argument("--xtalk", type=float, default=0.1)
    p.add_argument("--coupling", type=float, default=0.5)
    p.add_argument("--drive2", action="store_true",
                   help="system variant: direct drive line on qubit 2 "
                        "(4-parameter pulses, symmetric cross-talk)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default="weights/two_qubit_grape")
    p.add_argument("--curve_sigmas", default="0.02,0.05,0.1,0.15,0.2,0.3",
                   help="σ_δ grid for the final robustness curve")
    p.add_argument("--curve_mc", type=int, default=4096)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; never falls back by itself")
    return p


def robustness_curve(pulses, u_target, sigmas, monte_carlo, system: su4.TwoQubitSystem,
                     epsilon_std: float = 0.05, seed: int = 1, backend: str = "pallas",
                     device=None):
    """E[F](σ_δ) ± SE for one ``(L, P)`` pulse table: per σ, fresh draws of
    both qubits' δ at σ and a shared ε, ``(1, monte_carlo)`` each, from a
    generator seeded with ``seed``.  ``backend="pallas"`` propagates
    through kernel B7, ``"xla"`` through its eager plain version.  Returns
    rows ``(σ, mean, SE)``."""
    dev = resolve_device(device)
    Ut = np.asarray(u_target)
    TR = torch.as_tensor(Ut.real, dtype=torch.float32, device=dev)
    TI = torch.as_tensor(Ut.imag, dtype=torch.float32, device=dev)
    p = torch.as_tensor(np.asarray(pulses), dtype=torch.float32, device=dev)[None].contiguous()
    propagate = propagate_su4_mc_cuda if backend == "pallas" else propagate_su4_mc_plain
    gen = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for s in sigmas:
        d1, d2, ep = (torch.randn((1, monte_carlo), generator=gen, device=dev) * sd
                      for sd in (s, s, epsilon_std))
        with torch.no_grad():
            Ur, Ui = propagate(p, d1, d2, ep, system)
            F = su4.fidelity_su4_ri(Ur, Ui, TR, TI)[0].double()
        rows.append((float(s), float(F.mean()),
                     float(F.std(correction=0) / math.sqrt(monte_carlo))))
    return rows


def main(argv=None) -> dict:
    """Run the CLI; returns ``{"info", "curve", "pulses"}``."""
    args = build_parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.target_npz:
        u_target = np.load(args.target_npz)["u_target"]
    else:
        targets = named_two_qubit_targets()
        if args.gate not in targets:
            raise ValueError(f"unknown gate {args.gate!r}; "
                             f"available: {sorted(targets)} or --target_npz")
        u_target = targets[args.gate]

    sigmas = tuple(float(s) for s in args.sigmas.split(",") if s)
    cfg = TwoQubitGrapeConfig(
        mode=args.mode, n_blocks=args.n_blocks, num_pulses=args.num_pulses,
        n_starts=args.n_starts, steps=args.steps, learning_rate=args.learning_rate,
        sigmas=sigmas, monte_carlo=args.monte_carlo, xtalk=args.xtalk,
        coupling=args.coupling, seed=args.seed, drive2=args.drive2)
    pulses, info = multistart_grape_su4(u_target, cfg, device=dev, verbose=True)

    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "pulses.npz", pulses=pulses, u_target=np.asarray(u_target))

    system = su4.TwoQubitSystem(xtalk=args.xtalk, coupling=args.coupling,
                                drive2=args.drive2)
    curve_sigmas = [float(s) for s in args.curve_sigmas.split(",") if s]
    curve = robustness_curve(pulses, u_target, curve_sigmas, args.curve_mc, system,
                             device=dev)
    with open(out / "robustness.csv", "w") as f:
        f.write("sigma_delta,EF,SE\n")
        for s, m, se in curve:
            f.write(f"{s},{m},{se}\n")
    with open(out / "result.json", "w") as f:
        json.dump({"config": vars(args), "info": info, "curve": curve}, f, indent=1)

    for st in info["stages"]:
        print(f"stage σ={st['sigma']}: best F = {st['best_fid']:.5f} "
              f"(mean over starts {st['mean_fid']:.4f})")
    print(f"exact fidelity of shipped pulse: {info['exact_fid_of_best']:.5f}")
    for s, m, se in curve:
        print(f"  E[F](σ_δ={s:g}) = {m:.4f} ± {se:.4f}")
    print(f"artifacts in {out}/")
    return {"info": info, "curve": curve, "pulses": pulses}


if __name__ == "__main__":
    main()
