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


def _request(out, t0):
    """One request from ``t0`` ms: the model 6, then figures of 1, 2 and 0.5."""
    for name, a, b in (("model.forward", 0, 6), ("plots.fidelity_grid", 7, 8),
                       ("plots.fidelity_by_std", 8, 10),
                       ("plots.mc_fidelity_estimate", 10, 10.5)):
        out.append(Span(name, int((t0 + a) * MS), int((t0 + b) * MS), None, len(out)))
    return out


REQUEST_VALUES = {"model_host_ms.request": 6.0, "figures_ms.request": 3.5}


@pytest.mark.parametrize("name", sorted(REQUEST_VALUES))
def test_request_readers_read_a_span_list(name):
    records = _request(_request(_request([], 0), 20), 40)
    assert _read(name)(_ctx("request", 3), records) == pytest.approx(REQUEST_VALUES[name])


@pytest.mark.parametrize("name", sorted(REQUEST_VALUES))
def test_readers_read_nothing_where_they_should_not(name):
    read = _read(name)
    records = _request(_request([], 0), 50)
    assert read(_ctx("request", 2), records) is not None
    assert read(_ctx("step", 2), records) is None                 # another kind of unit
    assert read(_ctx("request", 2), []) is None                   # nothing recorded
    assert read(_ctx("request", 3), records) is None              # a root count ≠ units
    assert read(_ctx("request", 1), records) is None
    assert read(_ctx("request", 0), []) is None
    assert read({"unit": "request", "trace": None}, records) is None


def test_the_program_records_nothing_without_a_profiler():
    """In the process of a run the readers read the program's own list,
    which holds nothing until a profiler records."""
    from universal_quantum_optimal_control_tpu_torch.utils import tracing

    tracing.clear()
    assert _read("model_host_ms.request")(_ctx("request", 1)) is None


def test_a_program_without_spans_reads_nothing(monkeypatch):
    """A program that has no ``utils/tracing.py`` (before it had spans):
    the readers report nothing and raise nothing."""
    from universal_quantum_optimal_control_tpu_torch import utils

    monkeypatch.delattr(utils, "tracing")
    monkeypatch.setitem(sys.modules, "universal_quantum_optimal_control_tpu_torch.utils.tracing",
                        None)
    for name in sorted(REQUEST_VALUES):
        assert _read(name)(_ctx("request", 1)) is None
