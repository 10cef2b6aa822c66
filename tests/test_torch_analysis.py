"""PyTorch port, slice 4b: the analysis modules (``fits``, ``score_pulses``,
``plots``, ``bloch``, ``compare``) against the JAX package on the CPU, on the
same numpy-seeded inputs.

Tolerances: the numpy copies (fits, SCORE) exactly, the SCORE CSVs byte for
byte; the Monte-Carlo helpers on explicit draws (L ≤ 20, P ∈ {2, 4}) 1e-5
abs (f32 products of the same segments); the rotation matrix and the
spinor map 1e-6; the Bloch trajectories 1e-5.  ``compare`` draws its own
samples, so it is held within 5 combined standard errors of the JAX values
at M = 400 and 3 σ.  The figures are checked as files: each exists and is
non-empty under the JAX package's name.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.analysis import bloch as jbloch
from universal_quantum_optimal_control_tpu.analysis import compare as jcompare
from universal_quantum_optimal_control_tpu.analysis import fits as jfits
from universal_quantum_optimal_control_tpu.analysis import plots as jplots
from universal_quantum_optimal_control_tpu.analysis import score_pulses as jscore
from universal_quantum_optimal_control_tpu.core.propagate import propagate_scan as jscan
from universal_quantum_optimal_control_tpu_torch import analysis as tanalysis
from universal_quantum_optimal_control_tpu_torch.analysis import bloch as tbloch
from universal_quantum_optimal_control_tpu_torch.analysis import compare as tcompare
from universal_quantum_optimal_control_tpu_torch.analysis import fits as tfits
from universal_quantum_optimal_control_tpu_torch.analysis import plots as tplots
from universal_quantum_optimal_control_tpu_torch.analysis import plots_su4 as tplots_su4
from universal_quantum_optimal_control_tpu_torch.analysis import score_pulses as tscore
from universal_quantum_optimal_control_tpu_torch.optimizers import named_two_qubit_targets
from universal_quantum_optimal_control_tpu_torch.core.su4 import TwoQubitSystem

REPO = Path(__file__).resolve().parent.parent
BOX = {2: ([-3.0, 0.1], [3.0, 0.5]), 4: ([-3.0, 0.0, -2.0, 0.1], [3.0, 1.0, 2.0, 0.5])}


def _pulses(rng, L, P):
    lo, hi = (np.asarray(b) for b in BOX[P])
    return (lo + (hi - lo) * rng.random((L, P))).astype(np.float32)


def _unit_quat(rng):
    q = rng.standard_normal(4).astype(np.float32)
    return q / np.linalg.norm(q)


def _sem(*se):
    return float(np.sqrt(np.sum(np.square(se), axis=0)).max())


# ---------------------------------------------------------------------------
# fits and SCORE: the port's numpy copies
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_segments,max_candidates", [(1, 60), (2, 60), (3, 20)])
def test_fits_equal_jax(n_segments, max_candidates):
    rng = np.random.default_rng(n_segments)
    x = np.sort(rng.random(80)) * 2
    y = np.where(x < 0.8, 1 - 0.1 * x, 1.2 - 0.4 * x) + 0.01 * rng.standard_normal(80)
    cj, bj, yj = jfits.segmented_linear_fit(x, y, n_segments, max_candidates)
    ct, bt, yt = tfits.segmented_linear_fit(x, y, n_segments, max_candidates)
    np.testing.assert_array_equal(ct, cj)
    assert bt == bj
    np.testing.assert_array_equal(yt, yj)
    np.testing.assert_array_equal(tfits.piecewise_linear_eval(x[::3], ct, bt),
                                  jfits.piecewise_linear_eval(x[::3], cj, bj))


def test_score_tables_and_csvs_equal_jax(tmp_path):
    assert tscore.SCORE_ANGLE_VECTORS == jscore.SCORE_ANGLE_VECTORS
    assert tscore.NAMED_SCORE_TARGETS == jscore.NAMED_SCORE_TARGETS
    for n in tscore.SCORE_ANGLE_VECTORS:
        np.testing.assert_array_equal(tscore.score_n_config(n, 0.3, 123),
                                      jscore.score_n_config(n, 0.3, 123))
    got = tscore.build_score_pulses(save_dir=str(tmp_path / "t"))
    want = jscore.build_score_pulses(save_dir=str(tmp_path / "j"))
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    names = sorted(p.name for p in (tmp_path / "j").iterdir())
    assert sorted(p.name for p in (tmp_path / "t").iterdir()) == names and len(names) == 4
    for name in names:
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()


# ---------------------------------------------------------------------------
# the Monte-Carlo helpers on explicit draws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("P", [2, 4])
def test_grid_sweep_and_stats_match_jax_on_explicit_draws(P):
    rng = np.random.default_rng(10 + P)
    pulses, q = _pulses(rng, 20, P), _unit_quat(rng)
    dg = np.linspace(-3, 3, 9, dtype=np.float32)
    eg = np.linspace(-0.15, 0.15, 5, dtype=np.float32)
    want = np.asarray(jplots._grid_fid(*map(jnp.asarray, (pulses, q, dg, eg))))
    got = tplots._grid_fid(*map(torch.from_numpy, (pulses, q, dg, eg)))
    assert got.shape == (9, 5)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)

    nd = rng.standard_normal((3, 300)).astype(np.float32)
    ne = (0.05 * rng.standard_normal((3, 300))).astype(np.float32)
    stds = np.array([0.1, 0.5, 1.0], np.float32)
    want = jplots._sweep_fid(*map(jnp.asarray, (pulses, q, nd, ne, stds)))
    got = tplots._sweep_fid(*map(torch.from_numpy, (pulses, q, nd, ne, stds)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)

    want = jplots._mc_stats(*map(jnp.asarray, (pulses, q, nd[2], ne[2])))
    got = tplots._mc_stats(*map(torch.from_numpy, (pulses, q, nd[2], ne[2])))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), atol=1e-5)


def test_public_grid_and_sweep_shapes_and_draws():
    rng = np.random.default_rng(3)
    pulses, q = _pulses(rng, 8, 2), _unit_quat(rng)
    dg, eg, F = tplots.fidelity_grid(pulses, q, n_delta=11, n_eps=4, device="cpu")
    jdg, jeg, jF = jplots.fidelity_grid(pulses, q, n_delta=11, n_eps=4)
    np.testing.assert_allclose(dg, jdg, atol=1e-6)
    np.testing.assert_allclose(eg, jeg, atol=1e-7)
    np.testing.assert_allclose(F, jF, atol=1e-5)
    stds, mean, se = tplots.fidelity_by_std(pulses, q, monte_carlo=50, device="cpu")
    assert stds.shape == mean.shape == se.shape == (199,)
    np.testing.assert_allclose(stds, np.arange(0.01, 2.0, 0.01), atol=1e-6)
    # common random numbers: at σ → 0 every draw sees the same pulse
    assert se[0] < se[-1] and np.all((mean > 0) & (mean <= 1))
    # the sweep is one draw of (S, M) normals from the generator
    gen = torch.Generator().manual_seed(5)
    _, m1, _ = tplots.fidelity_by_std(pulses, q, stds=[0.3], monte_carlo=40, generator=gen,
                                      device="cpu")
    nd, ne = tplots._sweep_draws(torch.Generator().manual_seed(5), 1, 40, 0.05)
    m2, _ = tplots._sweep_fid(torch.from_numpy(pulses), torch.from_numpy(q), nd, ne,
                              torch.tensor([0.3]))
    np.testing.assert_allclose(m1, m2.numpy(), atol=0)


def test_total_time_reads_tau_from_the_last_column():
    p4 = np.array([[0.1, 0.7, 0.3, 0.2], [0.2, 0.9, -0.3, 0.4]], np.float32)
    assert tplots.total_time_pi(p4) == pytest.approx(0.6 / np.pi, rel=1e-6)
    p2 = p4[:, [0, 3]]
    assert tplots.total_time_pi(p2) == pytest.approx(
        float(np.sum(p2[:, 1])) / np.pi, rel=0)


# ---------------------------------------------------------------------------
# Bloch
# ---------------------------------------------------------------------------

def test_rotation_matrix_and_spinor_map_match_jax():
    rng = np.random.default_rng(4)
    q = rng.standard_normal((6, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    np.testing.assert_allclose(tbloch.quat_rotation_matrix(torch.from_numpy(q)).numpy(),
                               np.asarray(jbloch.quat_rotation_matrix(jnp.asarray(q))),
                               atol=1e-6)
    psi = (rng.standard_normal((5, 2)) + 1j * rng.standard_normal((5, 2))).astype(np.complex64)
    psi /= np.linalg.norm(psi, axis=-1, keepdims=True)
    np.testing.assert_allclose(tbloch.spinor_to_bloch(torch.from_numpy(psi)).numpy(),
                               np.asarray(jbloch.spinor_to_bloch(jnp.asarray(psi))),
                               atol=1e-6)


def _endpoint_by_propagator(pulses, d, e, r0=(0.0, 0.0, 1.0)):
    q = jscan(jnp.asarray(pulses)[None], jnp.asarray(d), jnp.asarray(e))
    return np.asarray(jbloch.quat_rotation_matrix(q)) @ np.asarray(r0, np.float32)


def test_bloch_trajectories_p2_match_jax():
    rng = np.random.default_rng(5)
    pulses = _pulses(rng, 16, 2)
    d = (0.3 * rng.standard_normal(12)).astype(np.float32)
    e = (0.02 * rng.standard_normal(12)).astype(np.float32)
    for r0 in ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0)):
        got = tbloch.bloch_trajectories(pulses, d, e, r0=r0, device="cpu")
        assert got.shape == (12, 17, 3)
        np.testing.assert_allclose(got, jbloch.bloch_trajectories(pulses, d, e, r0=r0),
                                   atol=1e-5)
    np.testing.assert_allclose(got[:, 0], np.broadcast_to([1.0, 0, 0], (12, 3)), atol=0)


def test_bloch_trajectories_p4_end_at_the_propagator():
    """At P = 4 the trajectory ends at R(q)·ẑ of the P-dispatching
    propagator; the JAX trajectory, which reads every row as (φ, τ), does
    not (``ROADMAP.md`` §C: the Bloch trajectories ignore the pulse space)."""
    rng = np.random.default_rng(6)
    pulses = _pulses(rng, 6, 4)
    d = np.array([0.1, -0.2], np.float32)
    e = np.array([0.01, 0.02], np.float32)
    want = _endpoint_by_propagator(pulses, d, e)
    got = tbloch.bloch_trajectories(pulses, d, e, device="cpu")
    np.testing.assert_allclose(got[:, -1], want, atol=1e-5)
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)
    jax_end = jbloch.bloch_trajectories(pulses, d, e)[:, -1]
    assert np.abs(jax_end - want).max() > 1e-2


def test_animation_writes_the_jax_file_and_reads_tau(tmp_path):
    rng = np.random.default_rng(7)
    pulses = _pulses(rng, 5, 4)
    path = tbloch.animate_bloch_ensemble(pulses, _unit_quat(rng), n_samples=3,
                                         save_path=str(tmp_path / "evolution.mp4"),
                                         device="cpu")
    assert Path(path).stat().st_size > 0
    assert Path(path).name in ("evolution.mp4", "evolution.gif")


# ---------------------------------------------------------------------------
# compare
# ---------------------------------------------------------------------------

def test_compare_matches_jax_within_5_se(tmp_path):
    rng = np.random.default_rng(8)
    strategies = {"a": _pulses(rng, 10, 2), "b": _pulses(rng, 14, 4)}
    q = _unit_quat(rng)
    stds, M = [0.2, 0.6, 1.0], 400
    got, fig = tcompare.compare_pulse_strategies(strategies, q, stds=stds, monte_carlo=M,
                                                 device="cpu")
    assert fig is None
    want, _ = jcompare.compare_pulse_strategies(strategies, q, stds=stds, monte_carlo=M)
    assert list(got) == list(want)
    for name in want:
        g, w = got[name], want[name]
        assert set(g) == set(w)
        assert abs(g["EF"] - w["EF"]) <= 5 * _sem(g["EF_se"], w["EF_se"])
        np.testing.assert_allclose(g["stds"], w["stds"], atol=1e-7)
        assert np.all(np.abs(g["mean"] - w["mean"]) <= 5 * np.sqrt(g["se"] ** 2 + w["se"] ** 2))
    # τ is the last column: the P = 4 strategy's time is its column 3
    assert got["b"]["total_time_pi"] == pytest.approx(
        float(np.sum(strategies["b"][:, 3])) / np.pi, rel=1e-6)
    assert got["a"]["total_time_pi"] == want["a"]["total_time_pi"]
    # the same draws for every strategy: a strategy listed twice reads the same
    twice, _ = tcompare.compare_pulse_strategies({"x": strategies["a"], "y": strategies["a"]},
                                                 q, stds=stds, monte_carlo=M, device="cpu")
    assert twice["x"]["EF"] == twice["y"]["EF"] == got["a"]["EF"]
    np.testing.assert_array_equal(twice["x"]["mean"], twice["y"]["mean"])
    # the figure, where asked for
    _, fig = tcompare.compare_pulse_strategies(strategies, q, stds=stds, monte_carlo=50,
                                               save_path=str(tmp_path / "cmp.png"),
                                               device="cpu")
    assert fig is not None and (tmp_path / "cmp.png").stat().st_size > 0


# ---------------------------------------------------------------------------
# the figures, as files
# ---------------------------------------------------------------------------

def test_single_qubit_figures_write_the_jax_files(tmp_path):
    rng = np.random.default_rng(9)
    pulses = _pulses(rng, 6, 4)
    q = _unit_quat(rng)
    fig, (mean, se) = tplots.fidelity_contour_plot(pulses, q, save_path=str(tmp_path / "c.png"),
                                                   title="t", monte_carlo=100, device="cpu")
    assert 0 < mean <= 1 and se > 0
    # T in the title reads τ from the last column
    assert f"T = {float(np.sum(pulses[:, 3])) / np.pi:.2f}π" in fig.axes[0].get_title()
    (stds, m, s), _ = tplots.plot_fidelity_by_std(pulses, q, save_prefix=str(tmp_path / "f"),
                                                  monte_carlo=30, device="cpu")
    assert stds.shape == m.shape == s.shape == (199,)
    tplots.plot_pulse_param(pulses, save_path=str(tmp_path / "p.png"))
    for name in ("c.png", "f_fidelity.png", "f_infidelity_with_fit.png", "p.png"):
        assert (tmp_path / name).stat().st_size > 0, name


def test_two_qubit_contour_figure(tmp_path):
    rng = np.random.default_rng(10)
    pulses = (rng.random((4, 4)) * [6.0, 6.0, 1.0, 0.5] - [3.0, 3.0, 0.0, 0.0]).astype(np.float32)
    u = named_two_qubit_targets()["cz"]
    tplots_su4.fidelity_contour_plot_su4(pulses, u, TwoQubitSystem(drive2=True),
                                         save_path=str(tmp_path / "c4.png"), n_delta=7,
                                         device="cpu")
    assert (tmp_path / "c4.png").stat().st_size > 0


def test_exports_match_jax():
    import universal_quantum_optimal_control_tpu.analysis as janalysis

    jnames = {n for n in dir(janalysis) if not n.startswith("_")}
    tnames = {n for n in dir(tanalysis) if not n.startswith("_")}
    assert jnames <= tnames, sorted(jnames - tnames)
    assert tplots.CONTOUR_LEVELS == jplots.CONTOUR_LEVELS
    assert tplots.LINE_LEVELS == jplots.LINE_LEVELS


def test_imports_and_runs_without_matplotlib():
    """The card's machine has no matplotlib: the analysis package, the demo
    and the smoke script import without it, and the numeric functions run."""
    code = (
        "import sys\n"
        "sys.modules['matplotlib'] = None\n"
        "import numpy as np\n"
        "import universal_quantum_optimal_control_tpu_torch.analysis as a\n"
        "import universal_quantum_optimal_control_tpu_torch.demo.app\n"
        "import universal_quantum_optimal_control_tpu_torch.analysis.parity_figure\n"
        "import universal_quantum_optimal_control_tpu_torch.analysis.two_qubit_bundle_figure\n"
        "import universal_quantum_optimal_control_tpu_torch.analysis.visualize_universal\n"
        "import chip_smoke\n"
        "p = np.tile(np.array([[0.0, 1.0]], np.float32), (3, 1))\n"
        "q = np.array([1.0, 0.0, 0.0, 0.0], np.float32)\n"
        "s, m, se = a.fidelity_by_std(p, q, stds=[0.1, 0.5], monte_carlo=20, device='cpu')\n"
        "t = a.bloch_trajectories(p, np.zeros(2), np.zeros(2), device='cpu')\n"
        "assert m.shape == (2,) and t.shape == (2, 4, 3)\n"
        "try:\n"
        "    a.plot_pulse_param(p)\n"
        "except ImportError:\n"
        "    print('drawing needs matplotlib')\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["drawing", "needs", "matplotlib", "ok"]
