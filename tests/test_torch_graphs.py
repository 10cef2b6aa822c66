"""The port's CUDA-graph cache (``ops/graphs.py``) and its two callers, the
pulse models' eval forward and the trainer's step, on the CPU.

Off a card, in train mode, with autograd, with a dropout generator, under
anomaly mode and inside another capture the forward runs eagerly: no
capture, no replay, the eager numbers.  The forward's key follows the
parameters' storage (an in-place ``load_state_dict`` keeps it, a new
parameter drops it) and the input's shape, dtype and base pulse.  The
bookkeeping of the cache (warm-up, capture, replays, at most ``limit``
keys, a copy of the static outputs for each caller, the kernel wrappers'
launch counts moved from the capture to the runs) runs here on a stand-in
for the card's graph, for the forward and for the trainer's step; the
card's tests (``tests/test_torch_gpu.py``) hold the real graphs to the
eager calls.
"""

import contextlib

import pytest
import torch
from torch import nn

from universal_quantum_optimal_control_tpu_torch.models import (
    TwoQubitQOCTransformer, UniversalQOCTransformer)
from universal_quantum_optimal_control_tpu_torch.models.universal_transformer import (
    PulseTransformer)
from universal_quantum_optimal_control_tpu_torch.ops import graphs
from universal_quantum_optimal_control_tpu_torch.training import (
    CurriculumBand, TrainConfig, Trainer)
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
        assert not model.graphable(x, kw.get("generator"))
    assert (model.graphs.captures, model.graphs.replays) == (0, 0)
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
    monkeypatch.setattr(PulseTransformer, "on_card", staticmethod(lambda m, t: True))
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: off == "capturing")
    model.train(off == "train")
    generator = torch.Generator() if off == "generator" else None
    with torch.set_grad_enabled(off == "grad"), torch.autograd.set_detect_anomaly(
            off == "anomaly"):
        assert model.graphable(x, generator) == (off is None)


def test_on_card_needs_the_input_beside_the_parameters():
    model, x = _inputs("universal")
    assert not PulseTransformer.on_card(model, x)
    assert not PulseTransformer.on_card(nn.Module(), x)    # no parameters


def test_graph_key_follows_the_parameters_storage_and_the_input():
    model, x = _inputs("universal")
    before = PulseTransformer.storage(model)
    assert len(before) == len(list(model.parameters())) + len(list(model.buffers()))
    other = _universal()
    model.load_state_dict(other.state_dict())             # copies into the same storage
    assert PulseTransformer.storage(model) == before
    model.head.weight = nn.Parameter(model.head.weight.detach().clone())
    after = PulseTransformer.storage(model)
    assert after != before
    model.head.bias.data = model.head.bias.data.clone()    # new storage, same Parameter
    assert PulseTransformer.storage(model) != after

    key = PulseTransformer.key
    base = torch.zeros((4, 2))
    assert key(x, None) == key(x.clone(), None)
    assert key(x, None) != key(x[:1], None)
    assert key(x, None) != key(x.double(), None)
    assert key(x, base) != key(x, None)
    assert key(x, base) != key(x, base.clone())
    outside = key(x, None)
    with torch.inference_mode():
        assert key(x, None) != outside


def _outputs(out):
    return (out,) if torch.is_tensor(out) else tuple(out)


class _StandIn:
    """The card's graph stood in for on the CPU.  The capture runs the body
    once, for the call that captured it (the static inputs start as that
    call's), so the first ``replay`` runs nothing; every later one runs the
    body on the static inputs into the static outputs, with the kernel
    wrappers' counts left as they were (no Python runs in a replay)."""

    def __init__(self, body, static, out):
        self.body, self.static, self.out, self.ran = body, static, _outputs(out), True

    def replay(self):
        if self.ran:
            self.ran = False
            return
        counts = [f.launches for f in graphs.COUNTED]
        for dst, src in zip(self.out, _outputs(self.body(*self.static))):
            dst.detach().copy_(src.detach())
        for f, n in zip(graphs.COUNTED, counts):
            f.launches = n


@pytest.fixture
def cache_stand_in(monkeypatch):
    """The cache on the CPU: the side stream's warm-up run in place, a
    capture a :class:`_StandIn`."""
    def record(self, body, static, generators):
        out = body(*static)
        return _StandIn(body, static, out), out

    monkeypatch.setattr(graphs.GraphCache, "_warm_up",
                        lambda self, eager, inputs: eager(*inputs))
    monkeypatch.setattr(graphs.GraphCache, "_record", record)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())


@pytest.fixture
def stand_in(monkeypatch, cache_stand_in):
    """The forward's graph path on the CPU: every forward graphable."""
    monkeypatch.setattr(PulseTransformer, "graphable", lambda self, x, g: True)


@pytest.mark.parametrize("family", ["universal", "two_qubit"])
def test_graph_path_warms_up_captures_then_replays(stand_in, family):
    model, x = _inputs(family)
    model.eval()
    g = torch.Generator().manual_seed(3)
    xs = [x + 0.1 * torch.randn(x.shape, generator=g) for _ in range(5)]
    with torch.no_grad():
        want = [model._forward(xi, None, None) for xi in xs]
        got = [model(xi) for xi in xs]
    assert (model.graphs.captures, model.graphs.replays) == (1, 3)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    # each caller owns its answer: no two alias, and a replay rewrites none
    assert len({t.data_ptr() for t in got}) == len(got)
    static = model.graphs._graphs[model.key(x, None)].outputs[0]
    assert not any(t.data_ptr() == static.data_ptr() for t in got)


def test_graph_path_keeps_a_key_per_shape_and_drops_the_oldest(stand_in):
    model, _ = _inputs("universal")
    model.eval()
    model.graphs.limit = 2
    with torch.no_grad():
        for B in (1, 2, 1, 2, 1, 2):          # two keys: warm-up, capture, replay each
            model(torch.rand((B, 4)))
        assert (model.graphs.captures, model.graphs.replays) == (2, 2)
        model(torch.rand((3, 4)))              # a third key drops B = 1, the oldest
        assert [k[0] for k in model.graphs._graphs] == [(2, 4), (3, 4)]
        model(torch.rand((1, 4)))              # B = 1 warms up again
        assert (model.graphs.captures, model.graphs.replays) == (2, 2)


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
        assert (model.graphs.captures, model.graphs.replays) == (1, 2)
        model.head.weight = nn.Parameter(model.head.weight.detach().clone())
        model(x)                                           # new storage: warms up again
        assert (model.graphs.captures, model.graphs.replays) == (1, 2)
        model(x)
        assert (model.graphs.captures, model.graphs.replays) == (2, 2)


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
    assert (model.graphs.captures, model.graphs.replays) == (1, 2)


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


class _Counted:
    """A kernel wrapper's launch counter, for the stand-in's steps."""

    launches = 0


def _graphed_trainer(counted=None):
    """A small CPU trainer whose steps take the graph path (with the graphed
    step's Adam: fused, capturable, its learning rate a tensor), its inputs,
    and, with ``counted``, an objective that counts one launch a call in it."""
    model = _universal()
    tr = Trainer(model, TrainConfig(monte_carlo=16, batch_size=4, learning_rate=1e-3),
                 device="cpu")
    tr._graphed = True
    tr.reset_optimizer()
    if counted is not None:
        mean_fid = tr._mean_fid

        def counting(*args):
            counted.launches += 1
            return mean_fid(*args)
        tr._mean_fid = counting
    g = torch.Generator().manual_seed(4)
    rv = torch.cat([nn.functional.normalize(torch.randn((4, 3), generator=g), dim=-1),
                    6.0 * torch.rand((4, 1), generator=g)], dim=-1)
    target = nn.functional.normalize(torch.randn((4, 4), generator=g), dim=-1)
    return tr, rv, target


def _steps(tr, rv, target, n, dropout=True):
    return [tr.train_step(rv, target, tr.sample_errors(4, CurriculumBand(0.3)), dropout=dropout)
            for _ in range(n)]


def test_trainer_steps_warm_up_capture_then_replay(cache_stand_in):
    """Three graphed steps: the eager step, a capture and one replay, each
    counted once, giving the eager steps' losses, parameters and generator
    state bit for bit."""
    tr, rv, target = _graphed_trainer()
    got = _steps(tr, rv, target, 3)
    assert (tr.graphs.captures, tr.graphs.replays, tr.step_count) == (1, 1, 3)
    ref, *_ = _graphed_trainer()
    want = [ref._eager_step(rv, target, ref.sample_errors(4, CurriculumBand(0.3)), True)
            for _ in range(3)]
    for (loss, fid), (loss0, fid0) in zip(got, want):
        assert torch.equal(loss, loss0) and torch.equal(fid, fid0)
    for p, p0 in zip(tr.model.parameters(), ref.model.parameters()):
        assert torch.equal(p, p0)
    assert torch.equal(tr.generator.get_state(), ref.generator.get_state())


def test_trainer_keeps_a_graph_for_each_dropout_value(cache_stand_in):
    tr, rv, target = _graphed_trainer()
    for dropout in (True, False, True, False, True, False):
        _steps(tr, rv, target, 1, dropout)
    assert sorted(k[0] for k in tr.graphs._graphs) == [False, True]
    assert (tr.graphs.captures, tr.graphs.replays) == (2, 2)


def test_trainer_counts_launches_at_the_runs_not_the_capture(monkeypatch, cache_stand_in):
    """A counting wrapper's launches: one for the eager step, one for the
    capturing step (the capture's own are moved to the graph's runs) and one
    for each replay, which the graph holds."""
    counted = _Counted()
    monkeypatch.setattr(graphs, "COUNTED", (counted,))
    tr, rv, target = _graphed_trainer(counted)
    seen = []
    for _ in range(4):
        _steps(tr, rv, target, 1)
        seen.append(counted.launches)
    assert seen == [1, 2, 3, 4]
    (step,) = tr.graphs._graphs.values()
    assert step.launches == ((counted, 1),)


def test_trainer_step_outputs_are_copies(cache_stand_in):
    """Each step's loss and E[F] are tensors of their own, which no later
    replay rewrites, and none is the graph's static output."""
    tr, rv, target = _graphed_trainer()
    got = _steps(tr, rv, target, 3)
    kept = [(loss.clone(), fid.clone()) for loss, fid in got]
    got += _steps(tr, rv, target, 2)
    for (loss, fid), (loss0, fid0) in zip(got, kept):
        assert torch.equal(loss, loss0) and torch.equal(fid, fid0)
    (step,) = tr.graphs._graphs.values()
    ptrs = {t.data_ptr() for pair in got for t in pair}
    assert len(ptrs) == 10 and not ptrs & {t.data_ptr() for t in step.outputs}
    assert len({float(loss) for loss, _ in got}) == 5


def test_reset_optimizer_drops_the_step_graphs(cache_stand_in):
    tr, rv, target = _graphed_trainer()
    _steps(tr, rv, target, 3)
    tr.reset_optimizer()
    assert not tr.graphs._graphs and tr.step_count == 0
    _steps(tr, rv, target, 1)                  # warms up again
    assert (tr.graphs.captures, tr.graphs.replays) == (1, 1)
    _steps(tr, rv, target, 2)
    assert (tr.graphs.captures, tr.graphs.replays, tr.step_count) == (2, 2, 3)


def test_trainer_replay_span_inside_the_step(cache_stand_in):
    tr, rv, target = _graphed_trainer()
    _steps(tr, rv, target, 2)
    tracing.clear()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        _steps(tr, rv, target, 1)
    spans = list(tracing.recorded())
    tracing.clear()
    assert spans[0].name == "trainer.step"
    assert [s.parent for s in spans if s.name == "trainer.graph_replay"] == [0]
