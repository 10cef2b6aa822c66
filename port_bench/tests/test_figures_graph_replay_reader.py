"""CPU tests of ``figures_graph_replay_pct.request``: the share of a traced
request's figure calls that replayed a captured CUDA graph, read from a
hand-built span list, and nothing for another kind of unit, a
``model.forward`` count other than the traced requests, requests with no
figure call or a program whose figures never replay."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import harness  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.utils.tracing import Span  # noqa: E402

MS = 1_000_000   # ns
FIGURES = ("plots.fidelity_grid", "plots.fidelity_by_std", "plots.mc_fidelity_estimate")


def _read():
    return harness.load_module(
        REPO / "port_bench" / "metrics" / "figures_graph_replay_pct.request.py",
        "port_bench.metrics.figures_graph_replay_pct.request").read


def _ctx(unit, units):
    return {"unit": unit, "trace": {"units": units}}


def _request(out, t0, replayed, figures=FIGURES):
    """One request from ``t0`` ms: its forward, then one call of each of
    ``figures``, those whose index is in ``replayed`` with a
    ``plots.graph_replay`` span inside."""
    out.append(Span("model.forward", t0 * MS, (t0 + 1) * MS, None, len(out)))
    for i, name in enumerate(figures):
        a = t0 + 2 + 3 * i
        root = len(out)
        out.append(Span(name, a * MS, (a + 2) * MS, None, root))
        if i in replayed:
            out.append(Span("plots.graph_replay", a * MS + MS // 4, (a + 1) * MS, root, root))
    return out


@pytest.mark.parametrize("replayed,want", [(((0, 1, 2),) * 2, 100.0),
                                           (((), (0, 1, 2), (0, 1, 2), (0, 1, 2)), 75.0),
                                           (((0,), (0, 1, 2)), 400.0 / 6),
                                           (((), ()), None)])
def test_figure_replay_share_counts_the_replaying_calls(replayed, want):
    records = []
    for i, r in enumerate(replayed):
        _request(records, 50 * i, r)
    read = _read()
    n = len(replayed)
    got = read(_ctx("request", n), records)
    assert got is None if want is None else got == pytest.approx(want)
    assert read(_ctx("step", n), records) is None           # another kind of unit
    assert read(_ctx("request", n + 1), records) is None    # a forward count off the units
    assert read(_ctx("request", n), []) is None             # nothing recorded
    assert read({"unit": "request", "trace": None}, records) is None    # no trace


def test_figure_replay_share_reads_nothing_without_figure_calls():
    """Requests whose forward replays but that call no figure (the two-qubit
    demo's figures open no spans) read nothing."""
    records = []
    for i in range(2):
        root = len(records)
        records.append(Span("model.forward", 50 * i * MS, (50 * i + 1) * MS, None, root))
        records.append(Span("model.graph_replay", 50 * i * MS, 50 * i * MS + MS // 2,
                            root, root))
    assert _read()(_ctx("request", 2), records) is None
