"""The two-qubit demo cell's own files on the CPU: the reference's table
and figures against the program's at a tiny size, the cell's Monte-Carlo
work, and each fault the cell can have, planted in the timed path, making
``correct`` false.  A test for the card reads the control and the faults
at the cell's widths."""

import copy
import json
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import harness, work  # noqa: E402
from port_bench.control import readings  # noqa: E402
from port_bench.reference import matmul_precision  # noqa: E402

import universal_quantum_optimal_control_tpu_torch.analysis.plots_su4 as plots_su4  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.models import TwoQubitQOCTransformer  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.optimizers.two_qubit_grape import (  # noqa: E402
    named_two_qubit_targets)

CELL = "two_qubit_d2_kak.serve"
SEED = 2 ** 31 + 12345


def _run(device=torch.device("cpu"), seed=SEED) -> harness.Run:
    with open(REPO / "BENCHMARK.json") as f:
        return harness.resolve(json.load(f), CELL, REPO, seed, device)


def tiny_run() -> harness.Run:
    """The cell at a size a CPU test holds: widths, table length, samples
    and grid cut; limits as they are."""
    run = _run()
    run.config = copy.deepcopy(run.config)
    run.config.update(max_pulses=4, d_model=32, n_layers=2, n_heads=4)
    t = run.traffic = copy.deepcopy(run.traffic)
    t["grid"].update(n_delta=5)
    t["sweep"].update(monte_carlo=16)
    t.update(rate_per_s=10, checked=2, profile_units=1)
    return run


def correct() -> bool:
    result = harness.execute(tiny_run(), 0.3, False, time.perf_counter(), {"setup_s": "s"}, {})
    return result["correct"]


def test_the_named_gates_are_the_programs():
    run = tiny_run()
    U = harness.entry(run).inputs(run)["U"]
    named = named_two_qubit_targets()
    assert len(U) == len(named)
    for u in named.values():
        assert min(np.max(np.abs(u - v)) for v in U) < 1e-7


def test_reference_table_and_figures_match_the_program():
    run = tiny_run()
    drv = harness.entry(run)
    inp = drv.inputs(run)
    with matmul_precision("f32"):
        drv.setup(run, inp)
        got = {i: run.state["request"](i) for i in (0, 3, 5, 6)}
    numbers = drv.compare(run, got, drv.reference(run, inp, got))
    assert numbers["pulse_gap"] < 2e-5
    assert numbers["grid_gap"] < 1e-5 and numbers["sweep_gap"] < 1e-5


def test_work_counts_the_figures_samples():
    run = _run()
    run.state["model"] = type("Model", (), {"dtype": torch.float32})   # as the program's holds it
    w = harness.entry(run).work(run)
    assert w["family"] == "su4"
    assert w["mc"] == work.mc_work("su4", 1, 100, 4, 20 * 2000 + 61 * 61, False)
    assert w["model_flops"] == work.model_flops(run.config, 1, 9, training=False)


def test_a_sound_run_is_correct():
    assert correct()


def test_a_sweep_over_half_its_samples_is_caught(monkeypatch):
    sound = plots_su4._sweep_su4

    def half(pulses, tr, ti, n1, n2, ne, stds, system):
        m = n1.shape[1] // 2
        return sound(pulses, tr, ti, n1[:, :m], n2[:, :m], ne[:, :m], stds, system)
    monkeypatch.setattr(plots_su4, "_sweep_su4", half)
    assert not correct()


def test_a_table_altered_where_it_is_produced_is_caught(monkeypatch):
    sound = TwoQubitQOCTransformer.forward

    def altered(self, *args, **kwargs):
        p = sound(self, *args, **kwargs).clone()
        p[:, 0, 0] += 0.5
        return p
    monkeypatch.setattr(TwoQubitQOCTransformer, "forward", altered)
    assert not correct()


@pytest.mark.gpu
def test_control_and_faults_fail_a_limit():
    """At the cell's widths and sizes, two checked requests: the control
    and each planted fault fail at least one limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    run = _run(torch.device("cuda", 0), seed=3 + len(CELL))
    run.traffic = dict(run.traffic, checked=2)
    for name, numbers in readings(run, harness.entry(run)).items():
        assert [k for k, v in numbers.items() if v > run.limits[k]], (name, numbers, run.limits)
