"""Scoring requests: the Monte-Carlo E[F] of a set of pulse tables.

A request holds ``tables`` pulse tables and their target quaternions from
a pool made from the seed; it reseeds the benchmark's generator with the
request's own seed, draws its disorder through ``SU2System.sample_errors``
at ``(tables, monte_carlo)``, calls ``mean_fidelity_local(...,
backend="pallas")`` and copies the per-table E[F] to the host.  Requests
arrive at a fixed rate (:mod:`port_bench.entries.arrivals`); a sample of
them, drawn from the seed, is scored again by the reference.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from port_bench import inputs as make
from port_bench import work as yardstick
from port_bench.entries.arrivals import open_loop, request_seed
from port_bench.harness import Run, log
from port_bench.reference import su2 as ref_su2

UNIT = "request"
FAULTS = ("half_batch", "answer_altered")


def inputs(run: Run) -> dict:
    t = run.traffic
    s_pool, s_draws = make.sub_seeds(run.seed, 2)
    gen = torch.Generator(device=run.device).manual_seed(s_pool)
    shape = (t["pool"], t["tables"], run.config["max_pulses"])
    pulses = make.pulse_tables(gen, shape, run.config["pulse_space"])
    _, q = make.rotations(gen, t["pool"] * t["tables"])
    return {"pulses": pulses, "targets": q.view(t["pool"], t["tables"], 4),
            "draws": s_draws}


def setup(run: Run, inp: dict) -> None:
    from universal_quantum_optimal_control_tpu_torch.parallel.mc_parallel import (
        mean_fidelity_local)
    from universal_quantum_optimal_control_tpu_torch.training.systems import SU2System

    t = run.traffic
    system = SU2System("pallas")
    gen = torch.Generator(device=run.device)
    pool = t["pool"]

    def request(i: int) -> np.ndarray:
        gen.manual_seed(request_seed(inp["draws"], i))
        delta, eps = system.sample_errors(gen, (t["tables"], t["monte_carlo"]),
                                          t["delta_std"], t["epsilon_std"])
        with torch.no_grad():
            f = mean_fidelity_local(inp["pulses"][i % pool], inp["targets"][i % pool],
                                    delta, eps, backend="pallas")
        return f.cpu().numpy()

    t0 = time.perf_counter()
    for i in range(t["warmup"]):
        request(i)
    log(f"setup warm-up {time.perf_counter() - t0:.3f} s ({t['warmup']} requests)")
    run.state.update(request=request, next=0)


def window(run: Run, seconds: float) -> dict:
    out = open_loop(run, run.state["request"], seconds)
    run.state["outputs"] = {"ef": out.pop("kept")}
    return out


def unit(run: Run):
    def one():
        run.state["request"](run.state["next"])
        run.state["next"] += 1
    return one


def work(run: Run) -> dict:
    t = run.traffic
    L, P = run.config["max_pulses"], len(run.config["pulse_space"])
    return {"family": "su2",
            "mc": yardstick.mc_work("su2", t["tables"], L, P, t["monte_carlo"], backward=False),
            "model_flops": 0.0, "model_peak": yardstick.PEAK_F32}


def release(run: Run) -> None:
    run.state.pop("request", None)


def reference(run: Run, inp: dict, got=None, control: bool = False, fault=None) -> dict:
    """Per-table E[F] of the checked requests (``got``'s, or as many as a
    run checks), in f32 or, as the control, in bf16; ``fault``
    ``"half_batch"`` averages over half the samples, ``"answer_altered"``
    hands each table the next one's E[F]."""
    t = run.traffic
    indices = list(got["ef"]) if got is not None else list(range(t["checked"]))
    gen = torch.Generator(device=run.device)
    out = {}
    for i in indices:
        gen.manual_seed(request_seed(inp["draws"], i))
        shape = (t["tables"], t["monte_carlo"])
        delta = torch.randn(shape, generator=gen, device=run.device) * t["delta_std"]
        eps = torch.randn(shape, generator=gen, device=run.device) * t["epsilon_std"]
        if fault == "half_batch":
            delta, eps = delta[:, :shape[1] // 2], eps[:, :shape[1] // 2]
        k = i % t["pool"]
        f = ref_su2.mean_fidelity(inp["pulses"][k], inp["targets"][k], delta, eps,
                                  "bf16" if control else "f32").cpu().numpy()
        out[i] = np.roll(f, -1) if fault == "answer_altered" else f
    return {"ef": out}


def compare(run: Run, got: dict, want: dict) -> dict:
    return {"ef_gap": max(float(np.max(np.abs(got["ef"][i] - want["ef"][i])))
                          for i in want["ef"])}
