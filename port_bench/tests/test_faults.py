"""The comparison that decides ``correct``, driven through a whole run at a
tiny size on the CPU (the harness's look for a card skipped): a sound
program passes; with the timed path broken underneath, each fault the cell
can have makes ``correct`` false."""

import copy
import json
import sys
import time
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import harness  # noqa: E402

import universal_quantum_optimal_control_tpu_torch.analysis.plots as plots  # noqa: E402
import universal_quantum_optimal_control_tpu_torch.parallel.mc_parallel as mc  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.models import Pipeline  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.training import Trainer  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.training.systems import (  # noqa: E402
    SU2System, SU4System)

SEED = 2 ** 31 + 12345


def tiny_run(cell: str) -> harness.Run:
    """The cell as ``BENCHMARK.json`` has it, at a size a CPU test holds:
    the widths, batch, samples and request sizes cut; limits as they are."""
    with open(REPO / "BENCHMARK.json") as f:
        run = harness.resolve(json.load(f), cell, REPO, SEED, torch.device("cpu"))
    run.config = copy.deepcopy(run.config)
    run.config.update(max_pulses=6, d_model=32, n_layers=2, n_heads=4)
    if "training" in run.config:
        run.config["training"].update(batch_size=4, monte_carlo=16)
    t = run.traffic = copy.deepcopy(run.traffic)
    if t["entry"] == "train":
        t.update(minibatches=3, profile_units=1)
    elif t["entry"] == "score":
        t.update(monte_carlo=256, pool=4, rate_per_s=40, checked=3, profile_units=2)
    else:
        t["grid"].update(n_delta=20, n_eps=5)
        t["sweep"].update(monte_carlo=64)
        t["estimate"].update(monte_carlo=128)
        t.update(rate_per_s=10, checked=2, profile_units=1, pool=8)
    return run


def correct(cell: str, trace: bool = False) -> bool:
    run = tiny_run(cell)
    result = harness.execute(run, 0.3, trace, time.perf_counter(), {"setup_s": "s"}, {})
    return result["correct"]


CELLS = ["length_100.train", "two_qubit_d2_kak.train", "length_100.score", "length_100.serve"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    assert correct(cell, trace=cell.endswith("score"))


@pytest.mark.parametrize("cell", ["length_100.train", "two_qubit_d2_kak.train"])
def test_a_step_that_leaves_the_state_unchanged_is_caught(cell, monkeypatch):
    monkeypatch.setattr(Trainer, "apply_gradients", lambda self: None)
    assert not correct(cell)


@pytest.mark.parametrize("cell,system", [("length_100.train", SU2System),
                                         ("two_qubit_d2_kak.train", SU4System)])
def test_a_step_over_half_the_batch_is_caught(cell, system, monkeypatch):
    sound = system.local_mean_fidelity

    def half(self, pulses, target, errors):
        h = pulses.shape[0] // 2
        return sound(self, pulses[:h], target[:h], tuple(e[:h] for e in errors))
    monkeypatch.setattr(system, "local_mean_fidelity", half)
    assert not correct(cell)


def test_scoring_over_half_the_samples_is_caught(monkeypatch):
    sound = mc.mean_fidelity_local

    def half(pulses, q, delta, eps, backend="xla"):
        m = delta.shape[1] // 2
        return sound(pulses, q, delta[:, :m].contiguous(), eps[:, :m].contiguous(), backend)
    monkeypatch.setattr(mc, "mean_fidelity_local", half)
    assert not correct("length_100.score")


def test_a_score_altered_where_it_is_produced_is_caught(monkeypatch):
    sound = mc.mean_fidelity_local
    monkeypatch.setattr(mc, "mean_fidelity_local",
                        lambda *a, **k: torch.roll(sound(*a, **k), 1))
    assert not correct("length_100.score")


def test_served_pulses_altered_where_they_are_produced_are_caught(monkeypatch):
    sound = Pipeline.__call__

    def altered(self, rv):
        p = sound(self, rv).clone()
        p[:, 0, 0] += 0.5
        return p
    monkeypatch.setattr(Pipeline, "__call__", altered)
    assert not correct("length_100.serve")


def test_figures_over_half_the_samples_are_caught(monkeypatch):
    sound = plots._mean_se
    monkeypatch.setattr(plots, "_mean_se", lambda F: sound(F[..., :F.shape[-1] // 2]))
    assert not correct("length_100.serve")
