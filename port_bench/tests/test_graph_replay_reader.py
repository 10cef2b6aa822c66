"""CPU tests of ``graph_replay_pct.step``: the share of traced steps that
replayed a captured CUDA graph, read from a hand-built span list, and
nothing for another kind of unit, a root count other than the traced units
or a program whose steps never replay."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import harness  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.utils.tracing import Span  # noqa: E402

MS = 1_000_000   # ns


def _read():
    return harness.load_module(REPO / "port_bench" / "metrics" / "graph_replay_pct.step.py",
                               "port_bench.metrics.graph_replay_pct.step").read


def _ctx(unit, units):
    return {"unit": unit, "trace": {"units": units}}


def _eager_step(out, t0):
    """One eager step from ``t0`` ms: its forward, backward and optimizer
    spans inside ``trainer.step``, no replay."""
    root = len(out)
    out.append(Span("trainer.step", t0 * MS, (t0 + 45) * MS, None, root))
    for name, a, b in (("model.forward", 1, 11), ("trainer.backward", 14, 34),
                       ("trainer.optimizer", 35, 43)):
        out.append(Span(name, (t0 + a) * MS, (t0 + b) * MS, root, root))
    return out


def _replay_step(out, t0):
    """One step from ``t0`` ms that replays its graph: 1 ms of it inside
    ``trainer.graph_replay``, no other span inside."""
    root = len(out)
    out.append(Span("trainer.step", t0 * MS, (t0 + 3) * MS, None, root))
    out.append(Span("trainer.graph_replay", (t0 + 1) * MS, (t0 + 2) * MS, root, root))
    return out


@pytest.mark.parametrize("steps,want", [((_replay_step,) * 2, 100.0),
                                        ((_eager_step, _replay_step, _replay_step,
                                          _replay_step), 75.0),
                                        ((_eager_step, _eager_step), None)])
def test_graph_replay_share_counts_the_replaying_steps(steps, want):
    records = []
    for i, make in enumerate(steps):
        make(records, 50 * i)
    read = _read()
    assert read(_ctx("step", len(steps)), records) == want
    assert read(_ctx("request", len(steps)), records) is None      # another kind of unit
    assert read(_ctx("step", len(steps) + 1), records) is None      # a root count off the units
    assert read(_ctx("step", len(steps)), []) is None               # nothing recorded
