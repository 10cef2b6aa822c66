"""The single-qubit figures' CUDA graphs (``analysis/plots.py`` through
``ops/graphs.py::GraphCache``) on the CPU.

``fidelity_grid``, ``fidelity_by_std`` and ``mc_fidelity_estimate`` take
their graph on a card with the default seed-0 draws and no other capture
under way; the CPU, a caller's generator and a call inside another capture
stay eager.  On a stand-in for the card's graph (``tests/test_torch_graphs.py``'s,
with every run, the first too, running the body: a card's graph draws at
its runs, after the cache sets its generator back to seed 0), the calls of
one key warm up, capture, then replay, each answer equal bit for bit to the
eager computation of the parent's code on the seed-0 stream, each a copy of
its own, with one key for each shape and each scalar the graph bakes in.
The card's tests (``tests/test_torch_gpu.py``) hold the real graphs to the
eager calls.
"""

import contextlib

import numpy as np
import pytest
import torch

from test_torch_graphs import _StandIn
from universal_quantum_optimal_control_tpu_torch.analysis import plots
from universal_quantum_optimal_control_tpu_torch.core.errors import sample_ore_ple
from universal_quantum_optimal_control_tpu_torch.ops import graphs
from universal_quantum_optimal_control_tpu_torch.utils import tracing

FIGURES = ("grid", "sweep", "estimate")
GRID = {"delta_range": (-2.0, 2.0), "eps_range": (-0.1, 0.1), "n_delta": 7, "n_eps": 3}
SWEEP = {"stds": np.arange(0.1, 0.6, 0.1), "epsilon_std": 0.05, "monte_carlo": 64}
ESTIMATE = {"delta_std": 1.0, "epsilon_std": 0.05, "monte_carlo": 64}
Q = np.asarray([0.5, 0.5, -0.5, 0.5], dtype=np.float32)


def _table(seed, L=4):
    g = torch.Generator().manual_seed(seed)
    return torch.stack([6.0 * torch.rand(L, generator=g) - 3.0,
                        0.1 + 0.4 * torch.rand(L, generator=g)], dim=-1).numpy()


def _call(figure, pulses, **kw):
    """One figure call on the CPU, its answer as a tuple of arrays."""
    if figure == "grid":
        return plots.fidelity_grid(pulses, Q, device="cpu", **{**GRID, **kw})
    if figure == "sweep":
        return plots.fidelity_by_std(pulses, Q, device="cpu", **{**SWEEP, **kw})
    return tuple(np.float32(x) for x in plots.mc_fidelity_estimate(
        pulses, Q, device="cpu", **{**ESTIMATE, **kw}))


def _eager(figure, pulses, generator=None, **kw):
    """The same numbers as the parent computed them, each call drawing from
    ``generator`` or a new one seeded with 0."""
    p, q = torch.as_tensor(pulses), torch.as_tensor(Q)
    g = torch.Generator().manual_seed(0) if generator is None else generator
    with torch.no_grad():
        if figure == "grid":
            a = {**GRID, **kw}
            dg = torch.linspace(*a["delta_range"], a["n_delta"], dtype=torch.float32)
            eg = torch.linspace(*a["eps_range"], a["n_eps"], dtype=torch.float32)
            return dg.numpy(), eg.numpy(), plots._grid_fid(p, q, dg, eg).numpy()
        if figure == "sweep":
            a = {**SWEEP, **kw}
            st = torch.as_tensor(a["stds"], dtype=torch.float32)
            nd, ne = plots._sweep_draws(g, st.shape[0], a["monte_carlo"], a["epsilon_std"])
            mean, se = plots._sweep_fid(p, q, nd, ne, st)
            return st.numpy(), mean.numpy(), se.numpy()
        a = {**ESTIMATE, **kw}
        delta, eps = sample_ore_ple(g, (a["monte_carlo"],), a["delta_std"], a["epsilon_std"])
        return tuple(t.numpy() for t in plots._mc_stats(p, q, delta, eps))


def _assert_same_bits(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


class _Drawing(_StandIn):
    """The stand-in graph whose every run, the first too, runs the body."""

    def __init__(self, *args):
        super().__init__(*args)
        self.ran = False


@pytest.fixture
def fresh_cache(monkeypatch):
    """The figures' cache and generators, new for the test."""
    monkeypatch.setattr(plots, "_GRAPHS", graphs.GraphCache("plots.graph_replay"))
    monkeypatch.setattr(plots, "_DRAWS", {})
    return plots._GRAPHS


@pytest.fixture
def stand_in(monkeypatch, fresh_cache):
    """The figures' graph path on the CPU: the CPU taken for a card, the
    side stream's warm-up run in place, a capture a :class:`_Drawing`."""
    def record(self, body, static, generators):
        out = body(*static)
        return _Drawing(body, static, out), out

    monkeypatch.setattr(graphs.GraphCache, "_warm_up",
                        lambda self, eager, inputs: eager(*inputs))
    monkeypatch.setattr(graphs.GraphCache, "_record", record)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(plots, "_on_card", lambda dev: True)
    return fresh_cache


@pytest.mark.parametrize("off", [None, "cpu", "generator", "capturing"])
def test_each_condition_keeps_the_figures_eager(monkeypatch, off):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: off == "capturing")
    dev = torch.device("cpu" if off == "cpu" else "cuda")
    generator = torch.Generator() if off == "generator" else None
    assert plots._graphed(dev, generator) == (off is None)


@pytest.mark.parametrize("figure", FIGURES)
def test_figures_warm_up_capture_then_replay(stand_in, figure):
    """Five calls on five tables: a warm-up, a capture and three replays,
    each the parent's numbers on the seed-0 stream, bit for bit."""
    tables = [_table(s) for s in range(5)]
    got = [_call(figure, t) for t in tables]
    assert (stand_in.captures, stand_in.replays) == (1, 3)
    assert len(stand_in._graphs) == 1
    for g, t in zip(got, tables):
        _assert_same_bits(g, _eager(figure, t))


@pytest.mark.parametrize("figure", FIGURES)
def test_figure_answers_are_copies(stand_in, figure):
    """No two calls' answers share memory, and a later replay rewrites none."""
    got = [_call(figure, _table(s)) for s in range(4)]
    kept = [tuple(np.array(a, copy=True) for a in g) for g in got]
    _call(figure, _table(9))
    for g, k in zip(got, kept):
        _assert_same_bits(g, k)
    arrays = [np.asarray(a) for g in got for a in g]
    assert not any(np.shares_memory(a, b) for i, a in enumerate(arrays)
                   for b in arrays[i + 1:])


@pytest.mark.parametrize("figure,other", [
    ("grid", {"n_delta": 8}), ("grid", {"n_eps": 4}), ("grid", {"delta_range": (-3.0, 3.0)}),
    ("grid", {"eps_range": (-0.2, 0.2)}),
    ("sweep", {"stds": np.arange(0.1, 0.5, 0.1)}), ("sweep", {"epsilon_std": 0.1}),
    ("sweep", {"monte_carlo": 32}),
    ("estimate", {"delta_std": 0.5}), ("estimate", {"epsilon_std": 0.1}),
    ("estimate", {"monte_carlo": 32}),
])
def test_figures_keep_a_key_per_size_and_scalar(stand_in, figure, other):
    """Two keys called in turn: each warms up, captures and replays on its
    own, and answers with its own sizes and scalars."""
    for i in range(6):
        kw = other if i % 2 else {}
        _assert_same_bits(_call(figure, _table(i), **kw), _eager(figure, _table(i), **kw))
    assert (stand_in.captures, stand_in.replays, len(stand_in._graphs)) == (2, 2, 2)


@pytest.mark.parametrize("figure", FIGURES)
def test_figures_keep_a_key_per_table_length(stand_in, figure):
    for i in range(6):
        L = 4 if i % 2 else 6
        _assert_same_bits(_call(figure, _table(i, L)), _eager(figure, _table(i, L)))
    assert (stand_in.captures, stand_in.replays, len(stand_in._graphs)) == (2, 2, 2)


def test_sweep_sigmas_are_an_input_of_one_graph(stand_in):
    """σ values of one count share a graph, each call's copied in."""
    for i, lo in enumerate((0.1, 0.2, 0.3, 0.4)):
        stds = np.arange(lo, lo + 0.5, 0.1)[:5]
        got = _call("sweep", _table(i), stds=stds)
        _assert_same_bits(got, _eager("sweep", _table(i), stds=stds))
    assert (stand_in.captures, stand_in.replays, len(stand_in._graphs)) == (1, 2, 1)


@pytest.mark.parametrize("figure", ["sweep", "estimate"])
def test_a_callers_generator_stays_eager_and_advances(stand_in, figure):
    """With the default key's graph captured, a call with the caller's own
    generator runs eagerly, draws from it as the parent did, and leaves it
    where the parent's call left it."""
    for s in range(3):
        _call(figure, _table(s))
    counts = (stand_in.captures, stand_in.replays)
    gen, ref = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
    for s in range(2):
        _assert_same_bits(_call(figure, _table(s), generator=gen),
                          _eager(figure, _table(s), generator=ref))
    assert torch.equal(gen.get_state(), ref.get_state())
    assert (stand_in.captures, stand_in.replays) == counts


@pytest.mark.parametrize("figure", FIGURES)
def test_figures_inside_another_capture_stay_eager(stand_in, monkeypatch, figure):
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: True)
    for s in range(3):
        _assert_same_bits(_call(figure, _table(s)), _eager(figure, _table(s)))
    assert (stand_in.captures, stand_in.replays, len(stand_in._graphs)) == (0, 0, 0)


@pytest.mark.parametrize("figure", FIGURES)
def test_figures_on_the_cpu_stay_eager(fresh_cache, figure):
    for s in range(3):
        _assert_same_bits(_call(figure, _table(s)), _eager(figure, _table(s)))
    assert (fresh_cache.captures, fresh_cache.replays, len(fresh_cache._graphs)) == (0, 0, 0)
    assert not plots._DRAWS


def test_graph_replay_span_inside_each_figure(stand_in):
    for s in range(2):
        for figure in FIGURES:
            _call(figure, _table(s))
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for figure in FIGURES:
            _call(figure, _table(2))
    spans = list(tracing.recorded())
    tracing.clear()
    assert [s.name for s in spans] == [
        "plots.fidelity_grid", "plots.graph_replay", "plots.fidelity_by_std",
        "plots.graph_replay", "plots.mc_fidelity_estimate", "plots.graph_replay"]
    assert [s.parent for s in spans] == [None, 0, None, 2, None, 4]
