"""The pulse models' eval forward as a CUDA graph (``models/eval_graph.py``),
on the CPU.

Off a card, in train mode, with autograd, with a dropout generator, under
anomaly mode and inside another capture the forward runs eagerly: no
capture, no replay, the eager numbers.  The graph's key follows the
parameters' storage (an in-place ``load_state_dict`` keeps it, a new
parameter drops it) and the input's shape, dtype and base pulse.  The
bookkeeping of the graph path (warm-up, capture, replays, at most
``limit`` keys, a copy of the static output for each caller) runs here
on a stand-in for the card's graph; the card's tests
(``tests/test_torch_gpu.py``) hold the real graph to the eager forward.
"""

import contextlib

import pytest
import torch
from torch import nn

from universal_quantum_optimal_control_tpu_torch.models import (
    TwoQubitQOCTransformer, UniversalQOCTransformer, eval_graph)
from universal_quantum_optimal_control_tpu_torch.utils import tracing


def _universal(**kw):
    model = UniversalQOCTransformer(max_pulses=4, d_model=16, n_layers=1, n_heads=2,
                                    dtype=torch.float32, device="cpu", **kw)
    model.init_like_flax(torch.Generator().manual_seed(0))
    return model


def _two_qubit():
    model = TwoQubitQOCTransformer(max_pulses=4, d_model=16, n_layers=1, n_heads=2,
                                   kak_tokens=True, dtype=torch.float32, device="cpu")
    model.init_like_flax(torch.Generator().manual_seed(0))
    return model


def _inputs(family, B=2):
    g = torch.Generator().manual_seed(1)
    if family == "two_qubit":
        return _two_qubit(), torch.randn((B, 9, 8), generator=g)
    return _universal(), torch.rand((B, 4), generator=g)


@pytest.mark.parametrize("family", ["universal", "two_qubit"])
@pytest.mark.parametrize("mode", ["eval_no_grad", "train", "grad", "generator"])
def test_forward_stays_eager_on_the_cpu(family, mode):
    model, x = _inputs(family)
    model.train(mode == "train")
    kw = {"generator": torch.Generator().manual_seed(2)} if mode == "generator" else {}
    grad = torch.enable_grad() if mode == "grad" else torch.no_grad()
    with grad:
        outs = [model(x, **kw) for _ in range(3)]
        want = model._forward(x, None, kw.get("generator"))
        assert not model.graphs.graphable(model, x, kw.get("generator"))
    assert (model.graph_captures, model.graph_replays) == (0, 0)
    if mode != "train":      # a train-mode forward draws new masks each call
        for out in outs:
            assert torch.equal(out, want)
    assert (outs[0].grad_fn is not None) == (mode == "grad")
    assert len({out.data_ptr() for out in outs}) == len(outs)


@pytest.mark.parametrize("off", [None, "train", "grad", "generator", "anomaly", "capturing"])
def test_each_condition_keeps_the_forward_eager_on_a_card(monkeypatch, off):
    """With the parameters and the input taken as on one card, the graph is
    taken in eval mode without autograd, and each condition alone keeps the
    forward eager."""
    model, x = _inputs("universal")
    monkeypatch.setattr(eval_graph.EvalGraphs, "on_card", staticmethod(lambda m, t: True))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: off == "capturing")
    model.train(off == "train")
    generator = torch.Generator() if off == "generator" else None
    with torch.set_grad_enabled(off == "grad"), torch.autograd.set_detect_anomaly(
            off == "anomaly"):
        assert model.graphs.graphable(model, x, generator) == (off is None)


def test_on_card_needs_the_input_beside_the_parameters():
    model, x = _inputs("universal")
    assert not eval_graph.EvalGraphs.on_card(model, x)
    assert not eval_graph.EvalGraphs.on_card(nn.Module(), x)    # no parameters


def test_graph_key_follows_the_parameters_storage_and_the_input():
    model, x = _inputs("universal")
    before = eval_graph.EvalGraphs.storage(model)
    assert len(before) == len(list(model.parameters())) + len(list(model.buffers()))
    other = _universal()
    model.load_state_dict(other.state_dict())             # copies into the same storage
    assert eval_graph.EvalGraphs.storage(model) == before
    model.head.weight = nn.Parameter(model.head.weight.detach().clone())
    after = eval_graph.EvalGraphs.storage(model)
    assert after != before
    model.head.bias.data = model.head.bias.data.clone()    # new storage, same Parameter
    assert eval_graph.EvalGraphs.storage(model) != after

    key = eval_graph.EvalGraphs.key
    base = torch.zeros((4, 2))
    assert key(x, None) == key(x.clone(), None)
    assert key(x, None) != key(x[:1], None)
    assert key(x, None) != key(x.double(), None)
    assert key(x, base) != key(x, None)
    assert key(x, base) != key(x, base.clone())
    outside = key(x, None)
    with torch.inference_mode():
        assert key(x, None) != outside


class _StandIn:
    """The card's graph stood in for on the CPU: ``replay`` runs the
    captured forward on the static input into the static output."""

    def __init__(self, forward, static, base, out):
        self.forward, self.static, self.base, self.out = forward, static, base, out

    def replay(self):
        self.out.copy_(self.forward(self.static, self.base, None))


@pytest.fixture
def stand_in(monkeypatch):
    """The graph path on the CPU: every call graphable, the side stream's
    warm-up run in place, a capture a :class:`_StandIn`."""
    def capture(self, forward, x, base):
        static = torch.empty_like(x)
        out = torch.empty_like(forward(x, base, None))
        return eval_graph._Graph(_StandIn(forward, static, base, out), static, out)

    monkeypatch.setattr(eval_graph.EvalGraphs, "graphable", lambda self, m, x, g: True)
    monkeypatch.setattr(eval_graph.EvalGraphs, "_warm_up",
                        lambda self, forward, x, base: forward(x, base, None))
    monkeypatch.setattr(eval_graph.EvalGraphs, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())


@pytest.mark.parametrize("family", ["universal", "two_qubit"])
def test_graph_path_warms_up_captures_then_replays(stand_in, family):
    model, x = _inputs(family)
    model.eval()
    g = torch.Generator().manual_seed(3)
    xs = [x + 0.1 * torch.randn(x.shape, generator=g) for _ in range(5)]
    with torch.no_grad():
        want = [model._forward(xi, None, None) for xi in xs]
        got = [model(xi) for xi in xs]
    assert (model.graph_captures, model.graph_replays) == (1, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # each caller owns its answer: no two alias, and a replay rewrites none
    assert len({t.data_ptr() for t in got}) == len(got)
    assert not any(t.data_ptr() == model.graphs._graphs[model.graphs.key(x, None)].out.data_ptr()
                   for t in got)


def test_graph_path_keeps_a_key_per_shape_and_drops_the_oldest(stand_in):
    model, _ = _inputs("universal")
    model.eval()
    model.graphs.limit = 2
    with torch.no_grad():
        for B in (1, 2, 1, 2, 1, 2):          # two keys: warm-up, capture, replay each
            model(torch.rand((B, 4)))
        assert (model.graph_captures, model.graph_replays) == (2, 2)
        model(torch.rand((3, 4)))              # a third key drops B = 1, the oldest
        assert [k[0] for k in model.graphs._graphs] == [(2, 4), (3, 4)]
        model(torch.rand((1, 4)))              # B = 1 warms up again
        assert (model.graph_captures, model.graph_replays) == (2, 2)


def test_graph_path_drops_its_graphs_for_new_storage_not_for_loaded_weights(stand_in):
    model, x = _inputs("universal")
    model.eval()
    other = _universal().eval()
    other.init_like_flax(torch.Generator().manual_seed(5))
    with torch.no_grad():
        for _ in range(3):
            model(x)
        model.load_state_dict(other.state_dict())          # in place: the graph stays
        assert torch.equal(model(x), other._forward(x, None, None))
        assert (model.graph_captures, model.graph_replays) == (1, 2)
        model.head.weight = nn.Parameter(model.head.weight.detach().clone())
        model(x)                                           # new storage: warms up again
        assert (model.graph_captures, model.graph_replays) == (1, 2)
        model(x)
        assert (model.graph_captures, model.graph_replays) == (2, 2)


def test_graph_path_reads_the_base_pulse_in_place(stand_in):
    model = _universal(finetune=True)
    model.eval()
    x = torch.rand((1, 4), generator=torch.Generator().manual_seed(6))
    base = torch.zeros((4, 2))
    with torch.no_grad():
        for _ in range(3):
            model(x, base_pulse=base)
        base.add_(0.25)
        assert torch.equal(model(x, base_pulse=base), model._forward(x, base, None))
        with pytest.raises(ValueError, match="requires an explicit base_pulse"):
            model(x)
    assert (model.graph_captures, model.graph_replays) == (1, 2)


def test_graph_replay_span_inside_the_forward(stand_in):
    model, x = _inputs("two_qubit")
    model.eval()
    with torch.no_grad():
        for _ in range(2):
            model(x)
        tracing.clear()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            model(x)
    spans = list(tracing.recorded())
    tracing.clear()
    assert [s.name for s in spans] == ["model.forward", "model.graph_replay"]
    assert spans[1].parent == 0


def test_a_copied_model_starts_with_no_graphs(stand_in):
    import copy

    model, x = _inputs("universal")
    model.eval()
    with torch.no_grad():
        model(x)
        twin = copy.deepcopy(model)
        assert twin.graphs is not model.graphs and not twin.graphs._graphs
        assert torch.equal(twin(x), model(x))
