"""PyTorch port, slice 4b: the figure CLIs (``parity_figure``,
``two_qubit_bundle_figure``, ``visualize_universal``) against the JAX
package on the CPU.

The parity table is written from one results dict by both packages and must
match byte for byte.  The curves draw their own samples (the torch and JAX
streams differ), so they are held within 5 combined standard errors of the
JAX values at M = 300 over 3 σ; SCORE's total time exactly and the model's
within 0.01π.  The visualize CLI runs on a tiny band checkpoint that the
port's own trainer writes.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.analysis import parity_figure as jparity
from universal_quantum_optimal_control_tpu.analysis import two_qubit_bundle_figure as jbundle
from universal_quantum_optimal_control_tpu.analysis import visualize_universal as jviz
from universal_quantum_optimal_control_tpu_torch.analysis import parity_figure as tparity
from universal_quantum_optimal_control_tpu_torch.analysis import two_qubit_bundle_figure as tbundle
from universal_quantum_optimal_control_tpu_torch.analysis import visualize_universal as tviz
from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit as cli

STDS, M = [0.2, 0.6, 1.0], 300
TINY_JSON = {"num_qubits": 1, "pulse_space": {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]},
             "max_pulses": 6, "d_model": 16, "n_layers": 1, "n_heads": 2,
             "dropout": 0.1, "finetune": None}


def _within_5_se(got, want, what):
    lim = 5 * np.sqrt(np.square(got[1]) + np.square(want[1]))
    assert np.all(np.abs(np.asarray(got[0]) - np.asarray(want[0])) <= lim), \
        (what, got, want)


@pytest.fixture(scope="module")
def parity():
    got = tparity.gate_parity_curves("small_20", monte_carlo=M, stds=STDS, device="cpu")
    want = jparity.gate_parity_curves("small_20", monte_carlo=M, stds=STDS)
    return got, want


def test_parity_curves_match_jax_within_5_se(parity):
    got, want = parity
    assert list(got) == list(want) == list(tparity.GATE_TO_SCORE)
    assert tparity.GATE_TO_SCORE == jparity.GATE_TO_SCORE
    for gate in want:
        for label in ("model", "SCORE"):
            g, w = got[gate][label], want[gate][label]
            assert set(g) == set(w)
            np.testing.assert_allclose(g["stds"], w["stds"], atol=0)
            _within_5_se((g["EF"], g["EF_se"]), (w["EF"], w["EF_se"]), (gate, label))
            _within_5_se((g["mean"], g["se"]), (w["mean"], w["se"]), (gate, label))
        assert got[gate]["SCORE"]["total_time_pi"] == want[gate]["SCORE"]["total_time_pi"]
        assert abs(got[gate]["model"]["total_time_pi"]
                   - want[gate]["model"]["total_time_pi"]) <= 0.01
    # the SCORE tables run 403 to 2019 segments
    assert round(want["Z(pi/4)"]["SCORE"]["total_time_pi"], 2) == 73.20


def test_parity_render_writes_the_jax_table(parity, tmp_path):
    got, _ = parity
    tpaths = tparity.render(got, str(tmp_path / "t" / "parity"), title="(small_20)")
    jpaths = jparity.render(got, str(tmp_path / "j" / "parity"), title="(small_20)")
    assert set(tpaths) == set(jpaths) == {"figure", "table"}
    assert Path(tpaths["table"]).read_bytes() == Path(jpaths["table"]).read_bytes()
    assert Path(tpaths["figure"]).stat().st_size > 0


def test_parity_cli(tmp_path, capsys, monkeypatch):
    calls = {}

    def fake_curves(variant, **kw):
        calls.update(variant=variant, **kw)
        return {"X": {k: {"stds": np.array([0.5]), "mean": np.array([0.9]),
                          "se": np.array([0.01]), "EF": 0.9, "EF_se": 0.01,
                          "total_time_pi": 1.0} for k in ("model", "SCORE")}}

    monkeypatch.setattr(tparity, "gate_parity_curves", fake_curves)
    tparity.main(["--variant", "small_20", "--monte_carlo", "7", "--device", "cpu",
                  "--out", str(tmp_path / "p")])
    assert calls["variant"] == "small_20" and calls["monte_carlo"] == 7
    out = capsys.readouterr().out.splitlines()
    assert out == [f"figure: {tmp_path / 'p'}.png", f"table: {tmp_path / 'p'}.md"]


def test_bundle_figure_matches_jax_within_5_se(tmp_path):
    got = tbundle.render_bundle_figure(tbundle._DEFAULT_BUNDLE, str(tmp_path / "t.png"),
                                       monte_carlo=M, stds=STDS, device="cpu")
    want = jbundle.render_bundle_figure(jbundle._DEFAULT_BUNDLE, str(tmp_path / "j.png"),
                                        monte_carlo=M, stds=STDS)
    assert Path(tbundle._DEFAULT_BUNDLE).resolve() == Path(jbundle._DEFAULT_BUNDLE).resolve()
    assert list(got) == list(want) and len(want) == 5
    for g in want:
        np.testing.assert_allclose(got[g][0], want[g][0], atol=0)
        _within_5_se(got[g][1:], want[g][1:], g)
    assert (tmp_path / "t.png").stat().st_size > 0
    # the numeric half alone, as the card runs it, gives the same curves
    again = tbundle.bundle_curves(tbundle._DEFAULT_BUNDLE, monte_carlo=M, stds=STDS,
                                  device="cpu")
    for g in got:
        for a, b in zip(again[g], got[g]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def band_checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("viz")
    cfg = tmp / "tiny.json"
    cfg.write_text(json.dumps(TINY_JSON))
    cli.main(["--device", "cpu", "--num_epoch", "1", "--save_path", str(tmp / "run"),
              "--batch_size", "8", "--monte_carlo", "16", "--train_size", "8",
              "--eval_size", "4", "--config", str(cfg)])
    return str(tmp / "run") + ":band2_delta1_eps0.05", str(cfg)


def test_visualize_cli_on_a_port_band_checkpoint(band_checkpoint, tmp_path, capsys):
    ckpt, cfg = band_checkpoint
    out = tmp_path / "viz"
    tviz.main(["--checkpoint", ckpt, "--config", cfg, "--out", str(out), "--monte_carlo",
               "40", "--gates", "X,H", "--device", "cpu"])
    for safe in ("X", "H"):
        for suffix in ("_pulses.csv", "_contour.png", "_params.png", "_fidelity.png",
                       "_infidelity_with_fit.png"):
            assert (out / f"{safe}{suffix}").stat().st_size > 0, safe + suffix
        assert any((out / f"{safe}_evolution.{ext}").exists() for ext in ("mp4", "gif"))
    rows = (out / "X_pulses.csv").read_text().splitlines()
    assert rows[0] == "phi,tau" and len(rows) == 1 + TINY_JSON["max_pulses"]
    assert capsys.readouterr().out.count("artifacts written under") == 2


def test_visualize_random_init_and_errors(band_checkpoint, tmp_path):
    _, cfg = band_checkpoint
    out = tmp_path / "r"
    tviz.main(["--random-init", "--config", cfg, "--out", str(out), "--monte_carlo", "20",
               "--gates", "Z(pi/4)", "--skip-video", "--device", "cpu"])
    assert (out / "Z_pi-4_pulses.csv").stat().st_size > 0
    assert not list(out.glob("*_evolution.*"))
    with pytest.raises(SystemExit, match="--checkpoint or --random-init required"):
        tviz.main(["--config", cfg, "--out", str(out), "--device", "cpu"])
    # the unknown-gate error, word for word the JAX one
    argv = ["--gates", "X,FOO", "--config", cfg, "--out", str(tmp_path / "e")]
    with pytest.raises(SystemExit) as t_err:
        tviz.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as j_err:
        jviz.main(argv)
    assert str(t_err.value) == str(j_err.value)
    assert str(t_err.value).startswith("unknown gate(s) ['FOO']; available: [")


def test_visualize_parser_keeps_the_jax_flags():
    t, j = tviz.build_parser(), jviz.build_parser()
    jflags = {a.dest: (a.default, a.option_strings) for a in j._actions}
    tflags = {a.dest: (a.default, a.option_strings) for a in t._actions}
    assert set(tflags) - set(jflags) == {"device"}
    for dest, (default, opts) in jflags.items():
        if dest == "config":
            assert Path(tflags[dest][0]).resolve() == Path(default).resolve()
        else:
            assert tflags[dest] == (default, opts), dest
    assert torch.cuda.is_available() or tflags["device"][0] is None
