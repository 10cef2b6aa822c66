"""Two-qubit demo requests: one named gate in, its pulse table and the
numbers of its two figures out.

A request is one of the demo's five named gates (CZ, ZZ(π/4), CNOT,
iSWAP, √SWAP; the traffic's ``named``, host numbers), cycled in an order
drawn from the seed.  The program answers it as
``demo/app.py::render_two_qubit_artifacts`` does for the
``two_qubit_d2_kak`` variant, which has no gate bundle, so its table comes
from the model (``two_qubit_pulse_table``'s model branch: the textbook
matrix, no ℤ₄ choice):

1. the target packed (``SU4System.pack_target``), its KAK tokens on the
   host (``workloads/two_qubit_eval.py::model_inputs(..., kak_tokens=True)``);
2. the model's forward at B = 1, and the table to the host;
3. ``analysis/plots_su4.py::fidelity_by_std_su4`` over the demo's σ_δ
   (``two_qubit_robustness``: all σ in one B7 launch) and
   ``fidelity_grid_su4`` on the ``n_delta``² grid (B7, the contour's), as
   the demo computes them (the drawing itself is left out); their numbers
   to the host.

``model_gate_pulses`` builds the model from a checkpoint on every call;
here it is built once in set-up as ``load_two_qubit_model`` builds it
(weights from the seed instead of the ``.npz``, the demo's f32).  The
benchmark's own host span ``model`` covers steps 1–2.  Requests arrive at
a fixed rate; a sample, drawn from the seed, is checked: the served table
against the reference model's, the figures' numbers by the reference on
the served table with the same draws.
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch

from port_bench import inputs as make
from port_bench import work as yardstick
from port_bench.entries.arrivals import open_loop
from port_bench.harness import Run, log
from port_bench.reference import kak, matmul_precision, model as ref_model, su4 as ref_su4

UNIT = "request"
FAULTS = ("half_batch", "answer_altered")
_DRAW_SEED = 0   # the figures' default generator seed


def _stds(t: dict) -> np.ndarray:
    lo, hi, step = t["sweep"]["stds"]
    return np.arange(lo, hi, step)


def _dtype(cfg: dict) -> torch.dtype:
    return getattr(torch, cfg["training"]["dtype"])


def inputs(run: Run) -> dict:
    """The weights, and the named gates in an order drawn from the seed."""
    cfg, t = run.config, run.traffic
    s_weights, s_order = make.sub_seeds(run.seed, 2)
    shapes = ref_model.parameter_shapes(cfg["d_model"], cfg["n_layers"],
                                        cfg["max_pulses"] * len(cfg["pulse_space"]))
    weights = make.make_weights(shapes, s_weights, run.device)
    named = np.asarray([np.asarray(re) + 1j * np.asarray(im) for re, im in t["named"].values()])
    order = np.random.default_rng(s_order).permutation(len(named))
    return {"weights": weights, "U": named[order]}


def setup(run: Run, inp: dict) -> None:
    from universal_quantum_optimal_control_tpu_torch.analysis.plots_su4 import (
        fidelity_by_std_su4, fidelity_grid_su4)
    from universal_quantum_optimal_control_tpu_torch.core.su4 import TwoQubitSystem
    from universal_quantum_optimal_control_tpu_torch.models import (
        TwoQubitQOCTransformer, normalize_pulse_space)
    from universal_quantum_optimal_control_tpu_torch.training.systems import SU4System
    from universal_quantum_optimal_control_tpu_torch.workloads.two_qubit_eval import model_inputs

    cfg, t, dev = run.config, run.traffic, run.device
    t0 = time.perf_counter()
    model = TwoQubitQOCTransformer(
        pulse_space=normalize_pulse_space(cfg["pulse_space"]), max_pulses=cfg["max_pulses"],
        d_model=cfg["d_model"], n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
        dropout=cfg["dropout"], dtype=_dtype(cfg), kak_tokens=True, device=dev)
    model.load_state_dict(inp["weights"])
    model.eval()
    system = TwoQubitSystem(**cfg["system"])
    log(f"setup model {time.perf_counter() - t0:.3f} s")
    sw, g = t["sweep"], t["grid"]
    stds = _stds(t)
    spans = run.state.setdefault("spans", {"model": [0.0, 0]})

    def request(i: int) -> dict:
        U = inp["U"][i % len(inp["U"])]
        t_model = time.perf_counter()
        packed = SU4System.pack_target(U[None]).to(dev)
        with torch.no_grad():
            table = model(model_inputs(packed, True))[0].cpu().numpy()
        spans["model"][0] += time.perf_counter() - t_model
        spans["model"][1] += 1
        _, mean, se = fidelity_by_std_su4(table, U, system, stds=stds,
                                          epsilon_std=sw["epsilon_std"],
                                          monte_carlo=sw["monte_carlo"], device=dev)
        _, grid = fidelity_grid_su4(table, U, system, tuple(g["delta_range"]), g["n_delta"],
                                    g["epsilon"], device=dev)
        return {"pulses": table, "grid": grid, "sweep": np.stack([mean, se])}

    t0 = time.perf_counter()
    for i in range(t["warmup"]):
        request(i)
    spans["model"] = [0.0, 0]
    log(f"setup warm-up {time.perf_counter() - t0:.3f} s ({t['warmup']} requests)")
    run.state.update(request=request, next=t["warmup"], model=model)


def window(run: Run, seconds: float) -> dict:
    warm = run.traffic["warmup"]
    out = open_loop(run, lambda i: run.state["request"](warm + i), seconds)
    run.state["outputs"] = {warm + i: v for i, v in out.pop("kept").items()}
    out["spans"] = {k: list(v) for k, v in run.state["spans"].items()}
    return out


def unit(run: Run):
    def one():
        run.state["request"](run.state["next"])
        run.state["next"] += 1
    return one


def work(run: Run) -> dict:
    """The figures' samples on the served table."""
    t, cfg = run.traffic, run.config
    L, P = cfg["max_pulses"], len(cfg["pulse_space"])
    samples = len(_stds(t)) * t["sweep"]["monte_carlo"] + t["grid"]["n_delta"] ** 2
    return {"family": "su4", "mc": yardstick.mc_work("su4", 1, L, P, samples, False),
            "model_flops": yardstick.model_flops(cfg, 1, 9, training=False),
            "model_peak": yardstick.matmul_peak(run.state["model"].dtype)}


def release(run: Run) -> None:
    for k in ("request", "model"):
        run.state.pop(k, None)


def _figures(table: np.ndarray, U: np.ndarray, t: dict, system: dict, device,
             precision: str, half: bool) -> dict:
    """The sweep's mean and standard error and the grid of one served table,
    by the reference, with the program's draws."""
    p = torch.as_tensor(table, dtype=torch.float32, device=device)[None]
    target = make.pack(U[None]).to(device)
    tr, ti = target[:, None, 0], target[:, None, 1]
    sw, g = t["sweep"], t["grid"]

    def fidelity(d1, d2, eps):
        ur, ui = ref_su4.propagate(p, d1.reshape(1, -1), d2.reshape(1, -1), eps.reshape(1, -1),
                                   system, precision)
        return ref_su4.fidelity(ur, ui, tr.to(ur.dtype), ti.to(ur.dtype))[0].float()

    gen = torch.Generator(device=device).manual_seed(_DRAW_SEED)
    stds = torch.as_tensor(_stds(t), dtype=torch.float32, device=device)
    S, M = stds.shape[0], sw["monte_carlo"]
    n1, n2, ne = (torch.randn((S, M), generator=gen, device=device) for _ in range(3))
    F = fidelity(n1 * stds[:, None], n2 * stds[:, None], ne * sw["epsilon_std"]).reshape(S, M)
    if half:
        F = F[:, :M // 2]
    mean, se = F.mean(-1), F.std(-1, correction=0) / math.sqrt(F.shape[-1])
    dg = torch.linspace(*g["delta_range"], g["n_delta"], dtype=torch.float32, device=device)
    dd1, dd2 = torch.meshgrid(dg, dg, indexing="ij")
    grid = fidelity(dd1, dd2, torch.full_like(dd1, float(g["epsilon"]))).reshape(dd1.shape)
    return {"sweep": torch.stack([mean, se]).cpu().numpy(), "grid": grid.cpu().numpy()}


def reference(run: Run, inp: dict, got=None, control: bool = False, fault=None) -> dict:
    """For each checked request: the reference model's table of the target
    (TF32 as the control), and the figures' numbers of the served table
    (``got``'s, or without ``got`` the reference's own; bf16 Monte-Carlo
    arithmetic as the control).  ``fault`` ``"half_batch"`` takes the sweep
    over half its samples, ``"answer_altered"`` moves the first segment's
    φ₁ by 0.5."""
    cfg, t, dev = run.config, run.traffic, run.device
    indices = list(got) if got is not None else [t["warmup"] + i for i in range(t["checked"])]
    encoder, mc = ("tf32", "bf16") if control else ("f32", "f32")
    out = {}
    for i in indices:
        U = inp["U"][i % len(inp["U"])]
        tokens = torch.from_numpy(kak.kak_input_tokens(make.unpack(make.pack(U[None])))).to(dev)
        with torch.no_grad(), matmul_precision(encoder):
            table = ref_model.pulses_su4(inp["weights"], tokens, cfg, _dtype(cfg),
                                         encoder)[0].cpu().numpy()
        if fault == "answer_altered":
            table[0, 0] += 0.5
        served = got[i]["pulses"] if got is not None else table
        with torch.no_grad(), matmul_precision("f32"):
            figures = _figures(served, U, t, cfg["system"], dev, mc, fault == "half_batch")
        out[i] = dict(figures, pulses=table)
    return out


def compare(run: Run, got: dict, want: dict) -> dict:
    """``pulse_gap``: the served table against the reference's (φ₁, φ₂ mod
    2π); ``grid_gap`` and ``sweep_gap``: the figures' numbers."""
    def pulse_gap(i):
        d = got[i]["pulses"] - want[i]["pulses"]
        d[:, :2] = np.remainder(d[:, :2] + np.pi, 2 * np.pi) - np.pi
        return float(np.max(np.abs(d)))

    def gap(key):
        return max(float(np.max(np.abs(got[i][key] - want[i][key]))) for i in want)

    return {"pulse_gap": max(pulse_gap(i) for i in want), "grid_gap": gap("grid"),
            "sweep_gap": gap("sweep")}
