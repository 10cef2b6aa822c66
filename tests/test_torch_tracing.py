"""PyTorch port: the named host spans of ``utils/tracing.py`` (CPU, tiny
sizes, the kernels' plain versions).

With no profiler recording, a span records nothing and never enters
``record_function``.  Under ``torch.profiler.profile`` a training step
records ``trainer.step`` and, nested under it and sharing its unit,
``model.forward``, ``mc.mean_fidelity``, ``trainer.backward`` and
``trainer.optimizer``, whose self times add up to the step; the chrome
trace holds each span as a ``user_annotation`` around the ATen operations
it timed; ``TrainConfig.profile_dir``'s ``trace.json`` carries the
``trainer.*`` spans; a serving request through ``Pipeline`` records
``model.forward`` and the three figures' spans.
"""

import json

import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu_torch.analysis.plots import (
    fidelity_by_std, fidelity_grid, mc_fidelity_estimate)
from universal_quantum_optimal_control_tpu_torch.data import su2_targets as tdata
from universal_quantum_optimal_control_tpu_torch.models import (
    Pipeline, TwoQubitQOCTransformer, UniversalQOCTransformer, normalize_pulse_space)
from universal_quantum_optimal_control_tpu_torch.training import (
    CurriculumBand, TrainConfig, Trainer)
from universal_quantum_optimal_control_tpu_torch.training.systems import SU4System
from universal_quantum_optimal_control_tpu_torch.utils import tracing

TINY = dict(num_qubits=1, pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.1, 0.5))),
            max_pulses=8, d_model=32, n_layers=2, n_heads=4, dropout=0.1)
DRIVE2_SPACE = (("phi1", (-3.15, 3.15)), ("phi2", (-3.15, 3.15)),
                ("omega", (0.05, 1.0)), ("tau", (0.1, 0.5)))
STEP_CHILDREN = ("model.forward", "mc.mean_fidelity", "trainer.backward", "trainer.optimizer")
FIGURES = ("plots.fidelity_grid", "plots.fidelity_by_std", "plots.mc_fidelity_estimate")
B, M = 4, 16


@pytest.fixture(autouse=True)
def fresh_record():
    tracing.clear()
    yield
    tracing.clear()


def _su2_step():
    model = UniversalQOCTransformer(**TINY, dtype=torch.float32, device="cpu")
    tr = Trainer(model, TrainConfig(monte_carlo=M, batch_size=B, backend="pallas"),
                 device="cpu")
    rv, qt = tdata.build_su2_dataset(torch.Generator().manual_seed(0), B, device="cpu")
    return lambda: tr.train_step(rv, qt, tr.sample_errors(B, CurriculumBand(0.4)),
                                 dropout=True)


def _su4_step():
    model = TwoQubitQOCTransformer(pulse_space=normalize_pulse_space(DRIVE2_SPACE),
                                   max_pulses=4, d_model=16, n_layers=1, n_heads=2,
                                   kak_tokens=True, dtype=torch.float32, device="cpu")
    tr = Trainer(model, TrainConfig(monte_carlo=M, batch_size=B, backend="pallas"),
                 system=SU4System(drive2=True, backend="pallas"), device="cpu")
    g = torch.Generator().manual_seed(0)
    tokens = torch.randn((B, 9, 8), generator=g)
    u = torch.linalg.qr(torch.complex(torch.randn((B, 4, 4), generator=g, dtype=torch.float64),
                                      torch.randn((B, 4, 4), generator=g,
                                                  dtype=torch.float64)))[0]
    target = torch.stack([u.real, u.imag], dim=1).float()
    return lambda: tr.train_step(tokens, target, tr.sample_errors(B, CurriculumBand(0.2)),
                                 dropout=True)


def _serve_request():
    model = UniversalQOCTransformer(**TINY, dtype=torch.float32, device="cpu")
    pipe = Pipeline(model)
    rv, q = tdata.build_su2_dataset(torch.Generator().manual_seed(1), 1, device="cpu")

    def request():
        pulses = pipe(rv)[0].cpu().numpy()
        fidelity_grid(pulses, q[0], n_delta=6, n_eps=3, device="cpu")
        fidelity_by_std(pulses, q[0], stds=np.arange(0.1, 0.4, 0.1), monte_carlo=32,
                        device="cpu")
        mc_fidelity_estimate(pulses, q[0], monte_carlo=64, device="cpu")
    return request


def _refuse(*args, **kwargs):
    raise AssertionError("record_function entered with no profiler recording")


def test_no_profiler_records_nothing_and_enters_no_annotation(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    model = UniversalQOCTransformer(**TINY, dtype=torch.float32, device="cpu")
    tr = Trainer(model, TrainConfig(monte_carlo=M, batch_size=B, epochs=2, backend="pallas"),
                 device="cpu")
    rv, qt = tdata.build_su2_dataset(torch.Generator().manual_seed(0), 16, device="cpu")
    tr.train(rv, qt, rv[:B], qt[:B], curriculum=[CurriculumBand(0.4), CurriculumBand(0.7)])
    _su4_step()()
    _serve_request()()
    with tracing.span("trainer.backward", backward=True):
        pass
    assert tracing.recorded() == []


@pytest.mark.parametrize("make_step,kernels_backward", [(_su2_step, False), (_su4_step, True)],
                         ids=["su2", "su4"])
def test_train_step_spans_nest_under_one_unit(make_step, kernels_backward):
    """On CPU tensors B1's wrapper differentiates its plain version by
    autograd, while the SU(4) objective runs B4/B5's plain versions
    through its autograd Function: there ``mc.mean_fidelity.backward``
    nests under ``trainer.backward``."""
    step = make_step()
    step()                      # warm: nothing recorded without a profiler
    with torch.profiler.profile():
        step()
    spans = tracing.recorded()
    names = ["trainer.step", *STEP_CHILDREN]
    if kernels_backward:
        names.insert(4, "mc.mean_fidelity.backward")
    assert [s.name for s in spans] == names
    root = spans[0]
    assert root.parent is None and root.unit == 0
    for s in spans[1:]:
        parent = spans[s.parent]
        assert s.unit == 0, s
        assert parent.name == ("trainer.backward" if s.name == "mc.mean_fidelity.backward"
                               else "trainer.step"), s
        assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns, s
    steps = [s for s in spans if s.parent == 0]
    for a, b in zip(steps, steps[1:]):
        assert a.end_ns <= b.start_ns, (a, b)
    t = tracing.totals()
    assert all(t[n]["count"] == 1 for n in t)
    assert sum(v["self_s"] for v in t.values()) == pytest.approx(t["trainer.step"]["total_s"],
                                                               rel=1e-9)
    children = sum(t[n]["total_s"] for n in STEP_CHILDREN)
    assert t["trainer.step"]["self_s"] == pytest.approx(t["trainer.step"]["total_s"] - children,
                                                        rel=1e-9)


def test_each_step_is_its_own_unit():
    step = _su2_step()
    with torch.profiler.profile():
        step()
        step()
    spans = tracing.recorded()
    roots = [i for i, s in enumerate(spans) if s.parent is None]
    assert [spans[i].name for i in roots] == ["trainer.step", "trainer.step"]
    assert [s.unit for s in spans] == [roots[0]] * 5 + [roots[1]] * 5
    assert tracing.totals()["trainer.step"]["count"] == 2


def _events(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    return [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]


def _interval(e):
    return float(e["ts"]), float(e["ts"]) + float(e["dur"])


def test_chrome_trace_holds_each_span_around_its_ops(tmp_path):
    step = _su2_step()
    step()
    with torch.profiler.profile() as prof:
        step()
    events = _events(prof, tmp_path)
    annotations = {e["name"]: _interval(e) for e in events if e.get("cat") == "user_annotation"}
    spans = {n: annotations[n] for n in ("trainer.step", *STEP_CHILDREN)}
    ops = [(e["name"], *_interval(e)) for e in events if e.get("cat") == "cpu_op"]

    def inside(name):
        a, b = spans[name]
        return {n for n, s, e in ops if a <= s and e <= b}

    root_a, root_b = spans["trainer.step"]
    for name in STEP_CHILDREN:
        a, b = spans[name]
        assert root_a <= a <= b <= root_b, name
    # each span's own operations: the head's sigmoid, B1's plain objective,
    # the autograd nodes of the backward, Adam's step
    assert "aten::sigmoid" in inside("model.forward")
    assert "aten::sigmoid" not in inside("trainer.optimizer")
    assert any(n.startswith("aten::") for n in inside("mc.mean_fidelity"))
    assert any("Backward" in n for n in inside("trainer.backward"))
    assert not any("Backward" in n for n in inside("model.forward"))
    a, b = spans["trainer.optimizer"]
    adam_a, adam_b = annotations["Optimizer.step#Adam.step"]
    assert a <= adam_a <= adam_b <= b


def test_profile_dir_trace_carries_trainer_spans(tmp_path):
    model = UniversalQOCTransformer(**TINY, dtype=torch.float32, device="cpu")
    cfg = TrainConfig(monte_carlo=M, batch_size=B, epochs=1, backend="pallas",
                      profile_dir=str(tmp_path / "prof"), profile_steps=2)
    tr = Trainer(model, cfg, device="cpu")
    rv, qt = tdata.build_su2_dataset(torch.Generator().manual_seed(0), 16, device="cpu")
    tr.train(rv, qt, rv[:B], qt[:B], curriculum=[CurriculumBand(0.4)])
    events = json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]
    names = [e["name"] for e in events if e.get("cat") == "user_annotation"]
    for name in ("trainer.step", "trainer.backward", "trainer.optimizer"):
        assert names.count(name) == cfg.profile_steps, name
    assert tracing.totals()["trainer.step"]["count"] == cfg.profile_steps


def test_serve_request_records_the_model_and_the_figures():
    request = _serve_request()
    request()
    assert tracing.recorded() == []
    with torch.profiler.profile():
        request()
    spans = tracing.recorded()
    assert [s.name for s in spans] == ["model.forward", *FIGURES]
    assert all(s.parent is None and s.unit == i for i, s in enumerate(spans))
    t = tracing.totals()
    assert all(t[n]["self_s"] == t[n]["total_s"] > 0.0 for n in t)


def test_span_as_decorator_checks_at_each_call():
    @tracing.span("x")
    def f(a, b=1):
        """doc"""
        return a + b

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert f(1, b=2) == 3 and tracing.recorded() == []
    with torch.profiler.profile():
        assert f(2) == 3
    assert [s.name for s in tracing.recorded()] == ["x"]
    assert f(3) == 4 and len(tracing.recorded()) == 1


def test_totals_leave_out_open_spans_and_count_covered_time_once():
    S = tracing.Span
    spans = [S("a", 0, 100, None, 0),
             S("b", 10, 40, 0, 0), S("c", 30, 50, 0, 0),   # overlapping children
             S("d", 45, 46, 2, 0),                          # a grandchild
             S("a", 200, None, None, 4)]                    # still open
    t = tracing.totals(spans)
    assert t["a"] == pytest.approx({"count": 1, "total_s": 100e-9, "self_s": 60e-9})
    assert t["b"]["self_s"] == pytest.approx(30e-9) and t["d"]["self_s"] == pytest.approx(1e-9)
    assert t["c"] == pytest.approx({"count": 1, "total_s": 20e-9, "self_s": 19e-9})
