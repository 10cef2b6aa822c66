"""Demo requests: one target in, its pulse table and the numbers of its
figures out.

A request is a rotation (axis uniform on the sphere, angle uniform in
(0, 2π]) from a pool made from the seed and cycled, sent as host numbers.  The pulses come from
``models/pipeline.py::Pipeline`` over the configuration's model in the
serving dtype, built once in set-up as ``demo/app.py::load_pipeline``
builds it (weights from the seed instead of the shipped file), and copied
to the host; then ``analysis/plots.py``'s ``fidelity_grid``,
``fidelity_by_std`` and ``mc_fidelity_estimate`` at the traffic's sizes,
as ``demo/app.py::render_artifacts`` draws them (the drawing itself is
left out).  Requests arrive at a fixed rate; a sample, drawn from the seed,
is checked: the pulses against the reference model's, the numbers against
the reference's on the served pulses.
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
from port_bench.reference import model as ref_model, su2 as ref_su2

UNIT = "request"
FAULTS = ("half_batch", "answer_altered")
_DRAW_SEED = 0   # the figures' default generator seed


def _stds(t: dict) -> np.ndarray:
    lo, hi, step = t["sweep"]["stds"]
    return np.arange(lo, hi, step)


def inputs(run: Run) -> dict:
    cfg = run.config
    s_weights, s_targets = make.sub_seeds(run.seed, 2)
    shapes = ref_model.parameter_shapes(cfg["d_model"], cfg["n_layers"],
                                        cfg["max_pulses"] * len(cfg["pulse_space"]))
    weights = make.make_weights(shapes, s_weights, run.device)
    rv, q = make.rotations(torch.Generator().manual_seed(s_targets), run.traffic["pool"])
    return {"weights": weights, "rv": rv.numpy(), "q": q.numpy()}


def setup(run: Run, inp: dict) -> None:
    from universal_quantum_optimal_control_tpu_torch.analysis.plots import (
        fidelity_by_std, fidelity_grid, mc_fidelity_estimate)
    from universal_quantum_optimal_control_tpu_torch.models import (
        Pipeline, UniversalQOCTransformer, normalize_pulse_space)

    cfg, t, dev = run.config, run.traffic, run.device
    t0 = time.perf_counter()
    model = UniversalQOCTransformer(
        pulse_space=normalize_pulse_space(cfg["pulse_space"]), max_pulses=cfg["max_pulses"],
        d_model=cfg["d_model"], n_layers=cfg["n_layers"], n_heads=cfg["n_heads"],
        dropout=cfg["dropout"], finetune=False,
        dtype=getattr(torch, cfg["serving"]["dtype"]), device=dev)
    model.load_state_dict(inp["weights"])
    pipe = Pipeline(model)
    log(f"setup pipeline {time.perf_counter() - t0:.3f} s")
    g, sw, est = t["grid"], t["sweep"], t["estimate"]
    stds = _stds(t)
    spans = run.state.setdefault("spans", {"model": [0.0, 0]})

    def request(i: int) -> dict:
        i %= t["pool"]
        rv, q = inp["rv"][i:i + 1], inp["q"][i]
        t_model = time.perf_counter()
        pulses = pipe(rv)[0].cpu().numpy()
        spans["model"][0] += time.perf_counter() - t_model
        spans["model"][1] += 1
        _, _, grid = fidelity_grid(pulses, q, tuple(g["delta_range"]), tuple(g["eps_range"]),
                                   g["n_delta"], g["n_eps"], device=dev)
        _, mean, se = fidelity_by_std(pulses, q, stds=stds, epsilon_std=sw["epsilon_std"],
                                      monte_carlo=sw["monte_carlo"], device=dev)
        estimate = mc_fidelity_estimate(pulses, q, est["delta_std"], est["epsilon_std"],
                                        est["monte_carlo"], device=dev)
        return {"pulses": pulses, "grid": grid, "sweep": np.stack([mean, se]),
                "estimate": np.asarray(estimate)}

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
    t, cfg = run.traffic, run.config
    L, P = cfg["max_pulses"], len(cfg["pulse_space"])
    g = t["grid"]
    samples = (g["n_delta"] * g["n_eps"] + len(_stds(t)) * t["sweep"]["monte_carlo"]
               + t["estimate"]["monte_carlo"])
    outputs = g["n_delta"] * g["n_eps"] + 2 * len(_stds(t)) + 2
    return {"family": "su2", "mc": yardstick.samples_work(L, P, samples, outputs),
            "model_flops": yardstick.model_flops(cfg, 1, 9, training=False),
            "model_peak": yardstick.matmul_peak(run.state["model"].dtype)}


def release(run: Run) -> None:
    for k in ("request", "model"):
        run.state.pop(k, None)


def _numbers(pulses: np.ndarray, q: np.ndarray, t: dict, device, precision: str,
             half: bool) -> dict:
    """The figures' numbers of one served table, by the reference."""
    p = torch.as_tensor(pulses, dtype=torch.float32, device=device)[None]
    target = torch.as_tensor(q, dtype=torch.float32, device=device)[None]
    g, sw, est = t["grid"], t["sweep"], t["estimate"]
    dg = torch.linspace(*g["delta_range"], g["n_delta"], dtype=torch.float32, device=device)
    eg = torch.linspace(*g["eps_range"], g["n_eps"], dtype=torch.float32, device=device)
    dd, ee = torch.meshgrid(dg, eg, indexing="ij")
    qg = ref_su2.propagate(p, dd.reshape(1, -1), ee.reshape(1, -1), precision)
    grid = ref_su2.fidelity(qg, target[:, None]).float().reshape(dd.shape)

    def stats(f):
        f = f.float()
        if half:
            f = f[..., :f.shape[-1] // 2]
        return f.mean(-1), f.std(-1, correction=0) / math.sqrt(f.shape[-1])

    gen = torch.Generator(device=device).manual_seed(_DRAW_SEED)
    stds = torch.as_tensor(_stds(t), dtype=torch.float32, device=device)
    S, M = stds.shape[0], sw["monte_carlo"]
    nd = torch.randn((S, M), generator=gen, device=device)
    ne = torch.randn((S, M), generator=gen, device=device) * sw["epsilon_std"]
    qs = ref_su2.propagate(p, (nd * stds[:, None]).reshape(1, -1), ne.reshape(1, -1), precision)
    mean, se = stats(ref_su2.fidelity(qs, target[:, None]).reshape(S, M))
    gen.manual_seed(_DRAW_SEED)
    M = est["monte_carlo"]
    de = torch.randn((M,), generator=gen, device=device) * est["delta_std"]
    ee1 = torch.randn((M,), generator=gen, device=device) * est["epsilon_std"]
    qe = ref_su2.propagate(p, de[None], ee1[None], precision)
    em, es = stats(ref_su2.fidelity(qe, target[:, None])[0])
    return {"grid": grid.cpu().numpy(), "sweep": torch.stack([mean, se]).cpu().numpy(),
            "estimate": np.asarray([float(em), float(es)])}


def reference(run: Run, inp: dict, got=None, control: bool = False, fault=None) -> dict:
    """The checked requests' pulses by the reference model (fp8 as the
    control), and the figures' numbers on the served pulses (``got``'s, or
    without ``got`` the reference's own; bf16 as the control).  ``fault``
    ``"half_batch"`` averages the sweep and estimate over half the samples,
    ``"answer_altered"`` moves the first segment's phase by 0.5."""
    cfg, t, dev = run.config, run.traffic, run.device
    indices = list(got) if got is not None else [t["warmup"] + i for i in range(t["checked"])]
    dtype = getattr(torch, cfg["serving"]["dtype"])
    out = {}
    for i in indices:
        j = i % t["pool"]
        rv = torch.as_tensor(inp["rv"][j:j + 1], device=dev)
        with torch.no_grad():
            pulses = ref_model.pulses_su2(inp["weights"], rv, cfg, dtype,
                                          "fp8" if control else "f32")[0].cpu().numpy()
        if fault == "answer_altered":
            pulses[0, 0] += 0.5
        served = got[i]["pulses"] if got is not None else pulses
        out[i] = dict(_numbers(served, inp["q"][j], t, dev, "bf16" if control else "f32",
                               fault == "half_batch"), pulses=pulses)
    return out


def compare(run: Run, got: dict, want: dict) -> dict:
    def gap(key):
        return max(float(np.max(np.abs(got[i][key] - want[i][key]))) for i in want)

    def pulse_gap(i):
        d = got[i]["pulses"] - want[i]["pulses"]
        d[:, 0] = np.remainder(d[:, 0] + np.pi, 2 * np.pi) - np.pi
        return float(np.max(np.abs(d)))

    return {"pulse_gap": max(pulse_gap(i) for i in want), "grid_gap": gap("grid"),
            "sweep_gap": gap("sweep"), "estimate_gap": gap("estimate")}
