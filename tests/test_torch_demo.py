"""PyTorch port, slice 4b: the demo's renderers, loader and UI
(``demo/app.py``) against the JAX package on the CPU.

The renderers write the JAX package's file names under its dict keys; the
two-qubit pulse CSV is byte-identical to the JAX one.  The CLI keeps the
JAX flags, choices and defaults (plus ``--device``) and, for ``--serve``
without Gradio, the JAX line.  The Gradio wiring runs on the stub of
``tests/test_demo_app.py``; the files a callback returns must still exist
after it returns (``ROADMAP.md`` §C: the JAX callback returns deleted files).
"""

import argparse
import json
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.demo import app as japp
from universal_quantum_optimal_control_tpu_torch.demo import app as tapp
from universal_quantum_optimal_control_tpu_torch.models import UniversalQOCTransformer
from universal_quantum_optimal_control_tpu_torch.training.checkpoint import restore_checkpoint
from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit as cli

TINY_JSON = {"num_qubits": 1, "pulse_space": {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]},
             "max_pulses": 5, "d_model": 16, "n_layers": 1, "n_heads": 2,
             "dropout": 0.1, "finetune": None}
SU2_FILES = {"csv": "pulses.csv", "contour": "contour.png", "params": "params.png",
             "fidelity": "fid_fidelity.png"}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A tiny config and a band checkpoint of it, written by the port's trainer."""
    tmp = tmp_path_factory.mktemp("demo")
    cfg = tmp / "tiny.json"
    cfg.write_text(json.dumps(TINY_JSON))
    cli.main(["--device", "cpu", "--num_epoch", "1", "--save_path", str(tmp / "run"),
              "--batch_size", "8", "--monte_carlo", "16", "--train_size", "8",
              "--eval_size", "4", "--config", str(cfg)])
    return str(cfg), str(tmp / "run") + ":band2_delta1_eps0.05"


@pytest.fixture
def tiny_variant(tiny, monkeypatch):
    cfg, _ = tiny
    monkeypatch.setitem(tapp.MODEL_VARIANTS, "_tiny", {"config": cfg, "checkpoint": None})
    tapp.load_pipeline.cache_clear()
    yield "_tiny"
    tapp.load_pipeline.cache_clear()


def test_load_pipeline_from_a_band_checkpoint_and_random_init(tiny, tiny_variant):
    _, ckpt = tiny
    with pytest.raises(ValueError, match="no checkpoint registered for variant _tiny"):
        tapp.load_pipeline(tiny_variant, device="cpu")
    pipe = tapp.load_pipeline(tiny_variant, ckpt, device="cpu", dtype=torch.float32)
    model = UniversalQOCTransformer(**{**TINY_JSON, "finetune": False},
                                    dtype=torch.float32, device="cpu")
    model.load_state_dict(restore_checkpoint(*ckpt.rsplit(":", 1))[0])
    rv = torch.tensor([[1.0, 0.0, 0.0, np.pi], [0.0, 0.6, 0.8, 1.0]])
    np.testing.assert_array_equal(pipe(rv).numpy(), model.eval()(rv).detach().numpy())
    # random init: the port's own initialization, seeded with 0
    rnd = tapp.load_pipeline(tiny_variant, random_init=True, device="cpu",
                             dtype=torch.float32)
    again = UniversalQOCTransformer(**{**TINY_JSON, "finetune": False},
                                    dtype=torch.float32, device="cpu")
    again.init_like_flax(torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(rnd(rv).numpy(), again.eval()(rv).detach().numpy())
    pulses, q = tapp.compute_pulses(tiny_variant, 1.0, 0.0, 0.0, np.pi, checkpoint=ckpt,
                                    device="cpu", dtype=torch.float32)
    assert pulses.shape == (5, 2)
    np.testing.assert_array_equal(pulses, pipe(rv[:1])[0].numpy())
    np.testing.assert_allclose(q.numpy(), [0.0, 1.0, 0.0, 0.0], atol=1e-7)


def test_render_artifacts_writes_the_jax_files(tiny, tiny_variant, tmp_path):
    _, ckpt = tiny
    paths = tapp.render_artifacts(tiny_variant, 0.0, 1.0, 0.0, np.pi / 2, str(tmp_path),
                                  checkpoint=ckpt, monte_carlo=30, device="cpu")
    assert set(paths) == set(SU2_FILES) | {"video"}
    for key, name in SU2_FILES.items():
        assert Path(paths[key]) == tmp_path / name
        assert Path(paths[key]).stat().st_size > 0, key
    assert (tmp_path / "fid_infidelity_with_fit.png").stat().st_size > 0
    assert Path(paths["video"]).name in ("evolution.mp4", "evolution.gif")
    assert Path(paths["video"]).stat().st_size > 0
    rows = (tmp_path / "pulses.csv").read_text().splitlines()
    assert rows[0] == "phi,tau" and len(rows) == 6
    no_video = tapp.render_artifacts(tiny_variant, 0.0, 1.0, 0.0, np.pi / 2,
                                     str(tmp_path / "nv"), checkpoint=ckpt, monte_carlo=30,
                                     video=False, device="cpu")
    assert set(no_video) == set(SU2_FILES)


def test_render_artifacts_keys_match_jax(monkeypatch, tmp_path):
    """The JAX renderer's keys and files on the shipped small_20, with its
    Monte-Carlo work cut short (the figures themselves are checked above)."""
    jpaths = japp.render_artifacts("small_20", 1.0, 0.0, 0.0, np.pi, str(tmp_path / "j"),
                                   monte_carlo=20, video=False)
    tpaths = tapp.render_artifacts("small_20", 1.0, 0.0, 0.0, np.pi, str(tmp_path / "t"),
                                   monte_carlo=20, video=False, device="cpu")
    assert set(tpaths) == set(jpaths)
    assert {k: Path(v).name for k, v in tpaths.items()} == \
        {k: Path(v).name for k, v in jpaths.items()}
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == \
        sorted(p.name for p in (tmp_path / "j").iterdir())


@pytest.mark.parametrize("variant,ncols", [("cz_robust", 3), ("cz_drive2", 4)])
def test_two_qubit_artifacts_match_jax(variant, ncols, tmp_path):
    t = tapp.render_two_qubit_artifacts(variant, "cz", str(tmp_path / "t"), monte_carlo=64,
                                        n_delta=9, device="cpu")
    j = japp.render_two_qubit_artifacts(variant, "cz", str(tmp_path / "j"), monte_carlo=64,
                                        n_delta=9)
    assert set(t) == set(j) == {"csv", "contour", "fidelity"}
    for k in t:
        assert Path(t[k]).name == Path(j[k]).name and Path(t[k]).stat().st_size > 0
    header = Path(t["csv"]).read_text().splitlines()[0]
    assert len(header.split(",")) == ncols
    assert Path(t["csv"]).read_bytes() == Path(j["csv"]).read_bytes()


def _jax_parser():
    """The parser the JAX ``main`` builds (it builds it inline)."""
    seen = {}

    class _Stop(Exception):
        pass

    def grab(self, argv=None, namespace=None):
        seen["parser"] = self
        raise _Stop

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = grab
    try:
        japp.main([])
    except _Stop:
        pass
    finally:
        argparse.ArgumentParser.parse_args = orig
    return seen["parser"]


def test_cli_keeps_the_jax_flags_choices_and_defaults():
    j = {a.dest: a for a in _jax_parser()._actions}
    t = {a.dest: a for a in tapp.build_parser()._actions}
    assert set(t) - set(j) == {"device"}
    for dest, a in j.items():
        b = t[dest]
        assert (b.option_strings, b.default, b.type, b.choices) == \
            (a.option_strings, a.default, a.type, a.choices), dest
    assert t["device"].default is None


def test_serve_without_gradio_prints_the_jax_line(monkeypatch, tmp_path, capsys):
    monkeypatch.setitem(sys.modules, "gradio", None)
    lines = {}
    for name, app in (("jax", japp), ("port", tapp)):
        monkeypatch.setattr(app, "render_artifacts",
                            lambda *a, **k: {"csv": str(tmp_path / "pulses.csv")})
        argv = ["--serve", "--variant", "small_20", "--out", str(tmp_path)]
        app.main(argv + (["--device", "cpu"] if app is tapp else []))
        lines[name] = capsys.readouterr().out
    assert lines["port"] == lines["jax"]
    assert lines["jax"].splitlines()[0] == "gradio not installed — falling back to CLI rendering"


class _FakeComponent:
    def __init__(self, *args, **kwargs):
        self.args = args
        self.kwargs = kwargs


class _FakeInterface:
    def __init__(self, fn=None, inputs=None, outputs=None, **kwargs):
        self.fn = fn
        self.inputs = inputs
        self.outputs = outputs
        self.kwargs = kwargs
        self.launched = None

    def launch(self, share=False):
        self.launched = {"share": share}


def _fake_gradio():
    gr = types.ModuleType("gradio")
    gr.Interface = _FakeInterface
    for name in ("Dropdown", "Slider", "File", "Image", "Video"):
        setattr(gr, name, _FakeComponent)
    return gr


def _fake_render(calls):
    def render(variant, x, y, z, theta, out_dir, **kwargs):
        calls["args"] = (variant, x, y, z, theta)
        paths = {}
        for k, fname in (("csv", "pulses.csv"), ("contour", "contour.png"),
                         ("params", "params.png"), ("fidelity", "fid_fidelity.png"),
                         ("video", "evolution.gif")):
            p = Path(out_dir) / fname
            p.write_bytes(b"x")
            paths[k] = str(p)
        return paths
    return render


def test_launch_gradio_wiring_and_files_outlive_the_callback(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", _fake_gradio())
    results = {}
    for name, app in (("jax", japp), ("port", tapp)):
        calls = {}
        monkeypatch.setattr(app, "render_artifacts", _fake_render(calls))
        demo = app.launch_gradio({})
        assert demo.launched == {"share": False}
        assert len(demo.inputs) == 5 and len(demo.outputs) == 5
        results[name] = demo.fn("small_20", 1.0, 0.0, 0.0, float(np.pi))
        assert calls["args"] == ("small_20", 1.0, 0.0, 0.0, float(np.pi))
        assert len(results[name]) == 5
        assert results[name][0].endswith("pulses.csv")
        assert results[name][4].endswith("evolution.gif")
    # the port's files are there for Gradio to read; the JAX ones are gone
    assert all(Path(p).exists() for p in results["port"])
    assert not any(Path(p).exists() for p in results["jax"])
    for p in results["port"]:
        Path(p).unlink()
    Path(results["port"][0]).parent.rmdir()


def test_launch_gradio_checkpoint_override(monkeypatch):
    monkeypatch.setitem(sys.modules, "gradio", _fake_gradio())
    old = tapp.MODEL_VARIANTS["small_20"]["checkpoint"]
    try:
        tapp.launch_gradio({"small_20": "/tmp/other.npz"})
        assert tapp.MODEL_VARIANTS["small_20"]["checkpoint"] == "/tmp/other.npz"
    finally:
        tapp.MODEL_VARIANTS["small_20"]["checkpoint"] = old


def test_two_qubit_cli_prints_its_paths(tmp_path, capsys):
    tapp.main(["--two_qubit", "cz_robust", "--out", str(tmp_path), "--monte_carlo", "32",
               "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert [line.split(":")[0] for line in out] == ["csv", "contour", "fidelity"]
    assert (tmp_path / "contour_d1d2.png").stat().st_size > 0
