"""Training steps, as the curriculum trainer runs them.

Each step is ``Trainer.train_step(inputs, targets, trainer.sample_errors(B,
band), dropout=True)`` on the next minibatch of a fixed set made from the
seed, cycled; the band is the configuration's.  Set-up builds one trainer
(model, Adam state, disorder generator), drives it through the first
``checked_steps`` steps on rows that all differ, and hands the same
trainer to the window.  What is compared with the reference's replay of
those steps from the same weights and draws (:func:`compare`): each
step's loss, each leaf's norm of the first gradient as Adam got it (from
its first moment after one step: ``m₁ = (1 − β₁)·g``) and each leaf's
norm of the parameters' change over the checked steps.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import inputs as make
from port_bench import work as yardstick
from port_bench.harness import Run, log
from port_bench.reference import kak, model as ref_model, su2 as ref_su2, su4 as ref_su4
from port_bench.reference.train import BETA1, leaf_gaps, moving_leaves, replay

UNIT = "step"
FAULTS = ("half_batch", "unchanged_state")


def _sizes(run: Run):
    cfg, tr = run.config, run.config["training"]
    return cfg, tr, tr["batch_size"], tr["monte_carlo"], cfg["max_pulses"], len(cfg["pulse_space"])


def _two_qubit(run: Run) -> bool:
    return run.config["num_qubits"] == 2


def inputs(run: Run) -> dict:
    """The weights, the minibatch set and the disorder stream's seed."""
    cfg, tr, B, M, L, P = _sizes(run)
    s_weights, s_data, s_stream = make.sub_seeds(run.seed, 3)
    t0 = time.perf_counter()
    shapes = ref_model.parameter_shapes(cfg["d_model"], cfg["n_layers"], L * P)
    weights = make.make_weights(shapes, s_weights, run.device)
    n = B * run.traffic["minibatches"]
    if _two_qubit(run):
        targets = make.pack(make.su4_targets(s_data, n, cfg["system"])).to(run.device)
        x = None
    else:
        gen = torch.Generator(device=run.device).manual_seed(s_data)
        x, targets = make.rotations(gen, n)
    log(f"setup inputs {time.perf_counter() - t0:.3f} s ({n} targets)")
    return {"weights": weights, "x": x, "targets": targets, "stream": s_stream}


def setup(run: Run, inp: dict) -> None:
    t0 = time.perf_counter()
    from universal_quantum_optimal_control_tpu_torch.data.su4_targets import kak_input_tokens
    from universal_quantum_optimal_control_tpu_torch.models import (
        TwoQubitQOCTransformer, UniversalQOCTransformer, normalize_pulse_space)
    from universal_quantum_optimal_control_tpu_torch.training import (
        CurriculumBand, TrainConfig, Trainer)
    from universal_quantum_optimal_control_tpu_torch.training.systems import (
        SU2System, SU4System)

    log(f"setup program import {time.perf_counter() - t0:.3f} s")
    cfg, tr, B, M, L, P = _sizes(run)
    t0 = time.perf_counter()
    kw = dict(pulse_space=normalize_pulse_space(cfg["pulse_space"]), max_pulses=L,
              d_model=cfg["d_model"], n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
              dropout=cfg["dropout"], dtype=getattr(torch, tr["dtype"]), device=run.device)
    if _two_qubit(run):
        s = cfg["system"]
        model = TwoQubitQOCTransformer(kak_tokens=True, **kw)
        system = SU4System(xtalk=s["xtalk"], coupling=s["coupling"], backend=tr["backend"],
                           drive2=s["drive2"])
        t1 = time.perf_counter()
        x = torch.from_numpy(kak_input_tokens(make.unpack(inp["targets"]))).to(run.device)
        log(f"setup KAK tokens {time.perf_counter() - t1:.3f} s")
    else:
        model = UniversalQOCTransformer(**kw)
        system = SU2System(tr["backend"])
        x = inp["x"]
    model.load_state_dict(inp["weights"])
    trainer = Trainer(model, TrainConfig(
        monte_carlo=M, batch_size=B, learning_rate=tr["learning_rate"],
        lr_schedule=tr["lr_schedule"], lr_schedule_steps=tr.get("lr_schedule_steps", 0),
        grad_clip=tr["grad_clip"], loss="sharp", loss_tau_bar=tr["loss_tau_bar"],
        loss_k=tr["loss_k"], backend=tr["backend"]), system=system, device=run.device)
    trainer.generator.manual_seed(inp["stream"])
    band = CurriculumBand(tr["delta_std"], tr["epsilon_std"])
    targets, n_batches = inp["targets"], run.traffic["minibatches"]
    log(f"setup model and trainer {time.perf_counter() - t0:.3f} s")

    def step(i: int):
        rows = slice((i % n_batches) * B, (i % n_batches + 1) * B)
        return trainer.train_step(x[rows], targets[rows], trainer.sample_errors(B, band),
                                  dropout=True)

    t0 = time.perf_counter()
    names = [k for k, _ in model.named_parameters()]
    losses = []
    for i in range(run.traffic["checked_steps"]):
        losses.append(step(i)[0])
        if i == 0:
            # the first moment after one step; none where Adam got no gradient
            moments = [trainer.optimizer.state.get(p, {}).get("exp_avg")
                       for p in model.parameters()]
            m1 = torch.stack([torch.linalg.vector_norm(m) if m is not None
                              else torch.zeros((), device=run.device) for m in moments])
            grad = dict(zip(names, (m1 / (1.0 - BETA1)).tolist()))
    change = torch.stack([torch.linalg.vector_norm(p.detach() - inp["weights"][k])
                          for k, p in model.named_parameters()])
    run.state.update(
        trainer=trainer, model=model, step=step, next=run.traffic["checked_steps"],
        outputs={"loss": torch.stack(losses).tolist(), "grad": grad,
                 "change": dict(zip(names, change.tolist()))})
    log(f"setup checked steps {time.perf_counter() - t0:.3f} s")


def window(run: Run, seconds: float) -> dict:
    step, i = run.state["step"], run.state["next"]
    sync = torch.cuda.synchronize if run.device.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    n = 0
    while time.perf_counter() - t0 < seconds:
        step(i + n)
        n += 1
    sync()
    elapsed = time.perf_counter() - t0
    run.state["next"] = i + n
    return {"attempted": n, "failed": 0, "metrics": {"step_ms": 1e3 * elapsed / n},
            "unit_s": elapsed / n}


def unit(run: Run):
    def one():
        run.state["step"](run.state["next"])
        run.state["next"] += 1
    return one


def work(run: Run) -> dict:
    cfg, tr, B, M, L, P = _sizes(run)
    family = "su4" if _two_qubit(run) else "su2"
    return {"family": family, "mc": yardstick.mc_work(family, B, L, P, M, backward=True),
            "model_flops": yardstick.model_flops(cfg, B, 9, training=True),
            "model_peak": yardstick.matmul_peak(run.state["model"].dtype)}


def release(run: Run) -> None:
    for k in ("trainer", "model", "step"):
        run.state.pop(k, None)


def reference(run: Run, inp: dict, got=None, control: bool = False, fault=None) -> dict:
    """The reference's replay of the checked steps (TF32 as the control;
    ``fault`` ``"half_batch"`` takes the loss over half the batch,
    ``"unchanged_state"`` reports no change)."""
    cfg, tr, B, M, L, P = _sizes(run)
    steps = run.traffic["checked_steps"]
    dtype, dev = getattr(torch, tr["dtype"]), run.device
    targets = inp["targets"][:steps * B]
    precision = "tf32" if control else "f32"
    if _two_qubit(run):
        system = cfg["system"]
        x = torch.from_numpy(kak.kak_input_tokens(make.unpack(targets))).to(dev)

        def forward(params, tokens, gen):
            return ref_model.pulses_su4(params, tokens, cfg, dtype, precision, gen)

        def draw(gen, n):
            return tuple(torch.randn((n, M), generator=gen, device=dev) * s
                         for s in (tr["delta_std"], tr["delta_std"], tr["epsilon_std"]))

        def mean_fid(p, t, e):
            return ref_su4.mean_fidelity(p, t, *e, system, precision)
        rows = max(1, int(3e10 // (M * L * 8192)))
    else:
        x = inp["x"][:steps * B]

        def forward(params, rv, gen):
            return ref_model.pulses_su2(params, rv, cfg, dtype, precision, gen)

        def draw(gen, n):
            return (torch.randn((n, M), generator=gen, device=dev) * tr["delta_std"],
                    torch.randn((n, M), generator=gen, device=dev) * tr["epsilon_std"])

        def mean_fid(p, t, e):
            return ref_su2.mean_fidelity(p, t, *e, precision)
        rows = max(1, int(3e10 // (M * L * 256)))
    batches = [(x[s * B:(s + 1) * B], targets[s * B:(s + 1) * B]) for s in range(steps)]
    gen = torch.Generator(device=dev).manual_seed(inp["stream"])
    out = replay(inp["weights"], batches, forward, draw, mean_fid, tr, gen, precision,
                 rows=rows, half_batch=fault == "half_batch")
    if fault == "unchanged_state":
        out["change"] = {k: 0.0 for k in out["change"]}
    return out


def compare(run: Run, got: dict, want: dict) -> dict:
    """The worst step's loss gap, the worst leaf's gap of the first
    gradient's norm, and the median leaf's gap of the change's norm (the
    worst leaf's change swings with the round-off of one small leaf's
    near-zero gradients under Adam: logged, not compared)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(got["loss"], want["loss"]))
    grad = leaf_gaps(got["grad"], want["grad"], list(want["grad"]))
    change = leaf_gaps(got["change"], want["change"], moving_leaves(want["grad_raw"]))
    worst_grad, worst_change = max(grad, key=grad.get), max(change, key=change.get)
    log(f"worst leaves: gradient {worst_grad} {grad[worst_grad]:.3e}, "
        f"change {worst_change} {change[worst_change]:.3e}")
    return {"loss_gap": float(loss), "grad_gap": grad[worst_grad],
            "change_gap": float(np.median(list(change.values())))}
