r"""Two-qubit universal transformer training — CLI entry point (PyTorch port
of ``workloads/two_qubit.py``).

SU(4) propagation with cross-talk and per-qubit off-resonant disorder, a
curriculum over σ_δ, optional warm starts (``--restore`` a two-qubit
``.npz`` or checkpoint, ``--pretrained_single_qubit`` an encoder
transplant).  Targets are zero-disorder products of random pulse
sequences, Weyl-chamber KAK constructions, or half each
(:func:`build_targets`).  The JAX CLI's flags and defaults, except:

* ``--backend`` defaults to ``pallas``: the hand-written CUDA kernels, B4
  forward and B5 backward on training steps, B6 on evaluation steps.  In
  the JAX package "xla" is a compiled path of its own and its default; in
  the port "xla" is the eager plain PyTorch version, which must not be the
  main path on a card.  ``--backend xla`` stays for comparison.
* ``--device`` (default ``cuda``; the CPU tests pass ``cpu``).
* The target sets are drawn on the CPU from seeds of the port's own
  (products: a ``torch.Generator``; KAK and phases: ``numpy``), so they
  are the same on any device and differ from the JAX package's, whose
  seeds come from its threefry keys.
* ``--restore`` / ``--pretrained_single_qubit``: a path ending in ``.npz``
  is a shipped JAX artifact (``models/serialization.py``); anything else is
  ``dir:tag`` of the port's own band checkpoints.
* The JAX package warms its TPU's device-to-host channel first
  (``utils/device_warmup.py``); the port only prints the same progress
  lines.

Usage (the flagship's σ_δ = 0.2 band, warm-started from its shipped weights):
    python -m universal_quantum_optimal_control_tpu_torch.workloads.two_qubit \
        --max_pulses 100 --drive2 --kak_tokens --omega_min 0.05 \
        --target_mode mixed --phase_augment --curriculum 0.2 --monte_carlo 1024 \
        --learning_rate 1e-4 --lr_schedule cosine --reset_opt_per_band --shuffle \
        --recover_collapse 0.05 --restore .../demo/weights/two_qubit_d2_kak.npz
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..core import su4
from ..data.su4_targets import kak_input_tokens, kak_targets, random_global_phase
from ..models import (TwoQubitQOCTransformer, load_params_npz, normalize_pulse_space,
                      params_from_jax, transfer_encoder_params)
from ..training import CurriculumBand, MetricsLogger, TrainConfig, Trainer
from ..training.checkpoint import restore_checkpoint
from ..training.systems import SU4System
from ..utils import resolve_device

__all__ = ["build_targets", "build_parser", "main"]

_PRODUCT_SEGMENTS = 24


def _mark(msg: str) -> None:
    """The JAX CLI's flushed, timestamped progress line on stderr."""
    print(f"[two_qubit {time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr, flush=True)


def build_targets(seed: int, n: int, system: su4.TwoQubitSystem, mode: str = "products",
                  phase_augment: bool = False, edge_frac: float = 0.0) -> torch.Tensor:
    """Entangling targets packed ``(n, 2, 4, 4)`` f32, on the CPU.

    ``mode="products"``: zero-disorder propagations of random 24-segment
    pulse sequences (inside the system's reachable set; on the ``drive2``
    system in its 4-parameter space), drawn from a ``torch.Generator``
    seeded with ``seed``.  ``mode="kak"``: Weyl-chamber-box KAK
    constructions (:func:`..data.su4_targets.kak_targets`) from
    ``numpy.random.default_rng(seed)``, which cover the CZ/CNOT/iSWAP edge
    classes random products essentially never visit.  ``mode="mixed"``:
    half and half.  ``phase_augment``: a random global phase on every
    target (physics-neutral; teaches the featurization phase invariance).
    """
    if mode not in ("products", "kak", "mixed"):
        raise ValueError(f"unknown target mode {mode!r}")
    rng = np.random.default_rng(seed)
    n_kak = {"products": 0, "kak": n, "mixed": n // 2}[mode]

    parts = []
    if n - n_kak > 0:
        m = n - n_kak
        gen = torch.Generator().manual_seed(seed)

        def u(lo, hi):
            return lo + (hi - lo) * torch.rand((m, _PRODUCT_SEGMENTS), generator=gen)

        cols = [u(-np.pi, np.pi)]
        if system.drive2:
            cols += [u(-np.pi, np.pi), u(0.0, 1.0)]
        cols.append(u(0.1, 0.5))
        zero = torch.zeros(m)
        Ur, Ui = su4.propagate_su4(torch.stack(cols, dim=-1), zero, zero, zero, system)
        parts.append(Ur.numpy() + 1j * Ui.numpy())
    if n_kak > 0:
        parts.append(kak_targets(rng, n_kak, edge_frac=edge_frac))

    U = np.concatenate(parts, axis=0)
    if phase_augment:
        U = random_global_phase(rng, U)
    return SU4System.pack_target(U)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train two-qubit pulse model")
    p.add_argument("--num_epoch", type=int, default=500)
    p.add_argument("--save_path", type=str, default="weights/two_qubit")
    p.add_argument("--max_pulses", type=int, default=40,
                   help="segments per pulse table (the shipped two_qubit_d2_kak "
                        "flagship is 100: pass it)")
    p.add_argument("--d_model", type=int, default=512)
    p.add_argument("--n_layers", type=int, default=8)
    p.add_argument("--n_heads", type=int, default=16)
    p.add_argument("--xtalk", type=float, default=0.1)
    p.add_argument("--coupling", type=float, default=0.5)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--monte_carlo", type=int, default=256)
    p.add_argument("--learning_rate", type=float, default=3e-5)
    p.add_argument("--train_size", type=int, default=256)
    p.add_argument("--eval_size", type=int, default=64)
    p.add_argument("--fused_epoch", action=argparse.BooleanOptionalAction, default=True,
                   help="no host sync inside an epoch (default on; --no-fused_epoch "
                        "reads every step's loss)")
    p.add_argument("--dtype", default="f32", choices=["f32", "bf16"],
                   help="encoder compute dtype (f32 default for training)")
    p.add_argument("--pretrained_single_qubit", type=str, default=None,
                   help="a single-qubit model (shipped .npz, or dir:tag of the "
                        "port's checkpoints) whose shape-matching encoder blocks "
                        "are transplanted before training")
    p.add_argument("--transfer_also", type=str, default="",
                   help="comma list of extra top-level modules to transplant "
                        "alongside the encoder blocks when shapes match (e.g. "
                        "'unitary_proj' or 'unitary_proj,head')")
    p.add_argument("--restore", type=str, default=None,
                   help="two-qubit weights to start from: a path ending in .npz "
                        "(a shipped artifact, e.g. the JAX package's "
                        "demo/weights/two_qubit_d2_kak.npz) or dir:tag of the "
                        "port's band checkpoints — lets curriculum bands run as "
                        "separate invocations")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--reset_opt_per_band", action="store_true",
                   help="fresh Adam moments at each curriculum band")
    p.add_argument("--shuffle", action="store_true",
                   help="re-draw minibatch composition each epoch")
    p.add_argument("--recover_collapse", type=float, default=0.0,
                   help="mid-band collapse recovery threshold (0 = off)")
    p.add_argument("--state_every", type=int, default=0,
                   help="checkpoint FULL resume state every N epochs")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest full resume state under save_path")
    p.add_argument("--tail_focus", type=float, default=0.0,
                   help="if > 0: CVaR training — average the loss over only the "
                        "worst this-fraction of per-target E[F] in each minibatch")
    p.add_argument("--tail_weight", type=float, default=1.0,
                   help="CVaR mixture weight w: loss = (1-w)*mean-loss + w*CVaR")
    p.add_argument("--pulse_params", type=int, default=2, choices=[2, 3],
                   help="2 = (phi, tau); 3 = (phi, Omega, tau) amplitude control")
    p.add_argument("--backend", default="pallas", choices=["xla", "pallas"],
                   help="pallas (default): the hand-written CUDA kernels, B4 "
                        "forward and B5 backward; xla: the eager plain PyTorch "
                        "version, for comparison (the JAX CLI defaults to xla, "
                        "a compiled path there)")
    p.add_argument("--device", type=str, default="cuda", help="cuda (default) or cpu")
    p.add_argument("--target_mode", default="products",
                   choices=["products", "kak", "mixed"],
                   help="training-target distribution: random reachable pulse "
                        "products, Weyl-chamber KAK constructions, or half each")
    p.add_argument("--edge_frac", type=float, default=0.0,
                   help="fraction of KAK targets with U-shaped Beta(0.3, 0.3) "
                        "Cartan coordinates (chamber corners and edges)")
    p.add_argument("--phase_augment", action="store_true",
                   help="random global phase on every target")
    p.add_argument("--lr_schedule", default="constant", choices=["constant", "cosine"],
                   help="cosine = 5%% linear warmup then cosine decay to 10%%, per "
                        "band (with --reset_opt_per_band)")
    p.add_argument("--omega_min", type=float, default=0.0,
                   help="lower edge of the Omega channel's range map (3- and "
                        "4-parameter spaces)")
    p.add_argument("--drive2", action="store_true",
                   help="system variant: direct drive line on qubit 2 with "
                        "symmetric cross-talk and 4-parameter (phi1, phi2, "
                        "Omega, tau) pulses")
    p.add_argument("--kak_features", action="store_true",
                   help="append a token with the target's Makhlin invariants")
    p.add_argument("--kak_tokens", action="store_true",
                   help="full KAK featurization: the host KAK decomposition of "
                        "every target as input tokens (data/su4_targets.py::"
                        "kak_input_tokens)")
    p.add_argument("--curriculum", default="0.2,0.4,0.7",
                   help="comma-separated delta_std curriculum bands")
    return p


def _load_state(spec: str):
    """A shipped ``.npz`` (JAX layout) or ``dir:tag`` of the port's
    checkpoints → a ``state_dict``."""
    if spec.endswith(".npz"):
        return params_from_jax(load_params_npz(spec))
    base_dir, tag = spec.rsplit(":", 1)
    return restore_checkpoint(base_dir, tag)[0]


def main(argv=None) -> dict:
    """Run the CLI; returns the training history."""
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    system = SU4System(xtalk=args.xtalk, coupling=args.coupling, backend=args.backend,
                       drive2=args.drive2)

    space = {"phi": (-3.15, 3.15), "tau": (0.1, 0.5)}
    if args.pulse_params == 3:
        space = {"phi": (-3.15, 3.15), "omega": (args.omega_min, 1.0), "tau": (0.1, 0.5)}
    if args.drive2:
        space = {"phi1": (-3.15, 3.15), "phi2": (-3.15, 3.15),
                 "omega": (args.omega_min, 1.0), "tau": (0.1, 0.5)}
    model = TwoQubitQOCTransformer(
        pulse_space=normalize_pulse_space(space), max_pulses=args.max_pulses,
        d_model=args.d_model, n_layers=args.n_layers, n_heads=args.n_heads,
        dtype=torch.float32 if args.dtype == "f32" else torch.bfloat16,
        kak_features=args.kak_features, kak_tokens=args.kak_tokens, device=device)

    train_seed, eval_seed = (int(s) for s in np.random.SeedSequence(args.seed)
                             .generate_state(2))
    _mark("building train targets")
    train_t = build_targets(train_seed, args.train_size, system.system,
                            mode=args.target_mode, phase_augment=args.phase_augment,
                            edge_frac=args.edge_frac)
    _mark("building eval targets")
    eval_t = build_targets(eval_seed, args.eval_size, system.system,
                           mode=args.target_mode, phase_augment=args.phase_augment,
                           edge_frac=args.edge_frac)
    train_x, eval_x = train_t, eval_t
    if args.kak_tokens:
        def tokens_of(packed):
            U = packed[:, 0].double().numpy() + 1j * packed[:, 1].double().numpy()
            return torch.from_numpy(kak_input_tokens(U))

        train_x, eval_x = tokens_of(train_t), tokens_of(eval_t)
    train_x, train_t, eval_x, eval_t = (x.to(device) for x in (train_x, train_t, eval_x,
                                                               eval_t))

    _mark("targets built")
    cfg = TrainConfig(
        monte_carlo=args.monte_carlo, batch_size=args.batch_size, epochs=args.num_epoch,
        learning_rate=args.learning_rate, lr_schedule=args.lr_schedule,
        lr_schedule_steps=args.num_epoch * max(args.train_size // args.batch_size, 1),
        loss="sharp", backend=args.backend, seed=args.seed, fused_epoch=args.fused_epoch,
        reset_optimizer_per_band=args.reset_opt_per_band, shuffle=args.shuffle,
        recover_collapse=args.recover_collapse, state_every=args.state_every,
        tail_focus=args.tail_focus, tail_weight=args.tail_weight)
    trainer = Trainer(model, cfg, system=system, device=device)

    _mark("init_params")
    params = trainer.init_params()
    if args.restore:
        params = _load_state(args.restore)
        print(f"restored two-qubit params from {args.restore}")
    if args.pretrained_single_qubit:
        also = tuple(m for m in args.transfer_also.split(",") if m)
        params = transfer_encoder_params(_load_state(args.pretrained_single_qubit), params,
                                         also=also)
        print(f"transferred encoder from {args.pretrained_single_qubit}")

    _mark("entering train loop")
    curriculum = [CurriculumBand(float(d)) for d in args.curriculum.split(",") if d != ""]
    with MetricsLogger(path=f"{args.save_path}/metrics.csv", echo=True) as logger:
        _, history = trainer.train(train_x, train_t, eval_x, eval_t, curriculum=curriculum,
                                   params=params, save_dir=args.save_path, logger=logger,
                                   resume=args.resume)

    best = max(b["best_fid"] for b in history["bands"] if b["best_fid"] is not None)
    print(f"done; best eval fidelity across bands: {best:.4f}")
    return history


if __name__ == "__main__":
    main()
