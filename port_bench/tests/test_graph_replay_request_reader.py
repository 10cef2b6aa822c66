"""CPU tests of ``graph_replay_pct.request``: the share of traced requests
whose model forward replayed a captured CUDA graph, read from a hand-built
span list, and nothing for another kind of unit, a ``model.forward`` count
other than the traced requests or a program whose forward never replays."""

import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import harness  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.utils.tracing import Span  # noqa: E402

MS = 1_000_000   # ns


def _read():
    return harness.load_module(REPO / "port_bench" / "metrics" / "graph_replay_pct.request.py",
                               "port_bench.metrics.graph_replay_pct.request").read


def _ctx(unit, units):
    return {"unit": unit, "trace": {"units": units}}


def _eager_request(out, t0):
    """One request from ``t0`` ms whose forward runs eagerly, then its
    figures."""
    root = len(out)
    out.append(Span("model.forward", t0 * MS, (t0 + 10) * MS, None, root))
    out.append(Span("plots.fidelity_grid", (t0 + 11) * MS, (t0 + 13) * MS, None, len(out)))
    return out


def _replay_request(out, t0):
    """One request from ``t0`` ms whose forward replays its graph, 0.5 ms of
    it inside ``model.graph_replay``, then its figures."""
    root = len(out)
    out.append(Span("model.forward", t0 * MS, (t0 + 1) * MS, None, root))
    out.append(Span("model.graph_replay", t0 * MS + MS // 4, t0 * MS + 3 * MS // 4, root, root))
    out.append(Span("plots.fidelity_grid", (t0 + 2) * MS, (t0 + 4) * MS, None, len(out)))
    return out


@pytest.mark.parametrize("requests,want", [((_replay_request,) * 2, 100.0),
                                           ((_eager_request, _replay_request,
                                             _replay_request, _replay_request), 75.0),
                                           ((_eager_request, _eager_request), None)])
def test_graph_replay_share_counts_the_replaying_requests(requests, want):
    records = []
    for i, make in enumerate(requests):
        make(records, 50 * i)
    read = _read()
    n = len(requests)
    assert read(_ctx("request", n), records) == want
    assert read(_ctx("step", n), records) is None           # another kind of unit
    assert read(_ctx("request", n + 1), records) is None    # a forward count off the units
    assert read(_ctx("request", n), []) is None             # nothing recorded
    assert read({"unit": "request", "trace": None}, records) is None    # no trace
