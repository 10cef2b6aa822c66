"""CPU tests of the readers of the program's spans: each reads a hand-built
span list to its value, and reads nothing for another kind of unit, an
empty list or a root count other than the traced units."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import harness  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.utils.tracing import Span  # noqa: E402

MS = 1_000_000   # ns


def _read(name):
    return harness.load_module(REPO / "port_bench" / "metrics" / f"{name}.py",
                               f"port_bench.metrics.{name}").read


def _ctx(unit, units):
    return {"unit": unit, "trace": {"units": units}}


def _step(out, t0, kernels_backward=True):
    """One step from ``t0`` ms: forward 10, objective 2, backward 20 (of it
    the kernels' 3), optimizer 8, in a 45 ms step."""
    root = len(out)

    def add(name, a, b, parent):
        out.append(Span(name, (t0 + a) * MS, (t0 + b) * MS, parent, root))
        return len(out) - 1
    add("trainer.step", 0, 45, None)
    add("model.forward", 1, 11, root)
    add("mc.mean_fidelity", 11, 13, root)
    bwd = add("trainer.backward", 14, 34, root)
    if kernels_backward:
        add("mc.mean_fidelity.backward", 20, 23, bwd)
    add("trainer.optimizer", 35, 43, root)
    return out


def _request(out, t0):
    """One request from ``t0`` ms: the model 6, then figures of 1, 2 and 0.5."""
    for name, a, b in (("model.forward", 0, 6), ("plots.fidelity_grid", 7, 8),
                       ("plots.fidelity_by_std", 8, 10),
                       ("plots.mc_fidelity_estimate", 10, 10.5)):
        out.append(Span(name, int((t0 + a) * MS), int((t0 + b) * MS), None, len(out)))
    return out


STEP_VALUES = {"optimizer_ms.step": 8.0, "model_host_ms.step": 10.0 + 17.0,
               "kernels_host_ms.step": 2.0 + 3.0}
REQUEST_VALUES = {"model_host_ms.request": 6.0, "figures_ms.request": 3.5}


@pytest.mark.parametrize("name", sorted(STEP_VALUES))
def test_step_readers_read_a_span_list(name):
    records = _step(_step([], 0), 50)
    assert _read(name)(_ctx("step", 2), records) == pytest.approx(STEP_VALUES[name])


@pytest.mark.parametrize("name", sorted(REQUEST_VALUES))
def test_request_readers_read_a_span_list(name):
    records = _request(_request(_request([], 0), 20), 40)
    assert _read(name)(_ctx("request", 3), records) == pytest.approx(REQUEST_VALUES[name])


@pytest.mark.parametrize("name", sorted({**STEP_VALUES, **REQUEST_VALUES}))
def test_readers_read_nothing_where_they_should_not(name):
    read = _read(name)
    own, other = ("step", "request") if name in STEP_VALUES else ("request", "step")
    make = _step if own == "step" else _request
    records = make(make([], 0), 50)
    assert read(_ctx(own, 2), records) is not None
    assert read(_ctx(other, 2), records) is None                 # another kind of unit
    assert read(_ctx(own, 2), []) is None                         # nothing recorded
    assert read(_ctx(own, 3), records) is None                    # a root count ≠ units
    assert read(_ctx(own, 1), records) is None
    assert read(_ctx(own, 0), []) is None
    assert read({"unit": own, "trace": None}, records) is None


def test_step_readers_on_the_plain_backward():
    """Without the kernels' backward span the backward's whole time is the
    model's."""
    records = _step([], 0, kernels_backward=False)
    assert _read("model_host_ms.step")(_ctx("step", 1), records) == pytest.approx(30.0)
    assert _read("kernels_host_ms.step")(_ctx("step", 1), records) == pytest.approx(2.0)


def test_the_program_records_nothing_without_a_profiler():
    """In the process of a run the readers read the program's own list,
    which holds nothing until a profiler records."""
    from universal_quantum_optimal_control_tpu_torch.utils import tracing

    tracing.clear()
    assert _read("optimizer_ms.step")(_ctx("step", 1)) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """A program that has no ``utils/tracing.py`` (before it had spans):
    the readers report nothing and raise nothing."""
    from universal_quantum_optimal_control_tpu_torch import utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "universal_quantum_optimal_control_tpu_torch.utils.tracing",
                        None)
    for name in sorted({**STEP_VALUES, **REQUEST_VALUES}):
        unit = "step" if name in STEP_VALUES else "request"
        assert _read(name)(_ctx(unit, 1)) is None
