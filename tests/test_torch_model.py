"""PyTorch port, model and serving: SCORE features, the transformer, the
``.npz`` loader, the pipeline and the E[F] estimators against the JAX
package (CPU, f32), plus the port's import and packaging rules.

Tolerances (abs):
* 1e-6 for ``score_features`` — a few f32 ulps of O(1) trigonometry;
* 1e-4 for the small transformer's pulses (φ modulo 2π) — two encoder
  blocks of f32 matmuls, softmax and LayerNorm summed in another order;
* 1e-3 for the d512 × 8 flagship's pulses (φ modulo 2π) — the same at
  eight layers of width 512, ending in a 200-wide sigmoid head;
* 1e-4 for E[F] on explicit draws — inherits the pulses' 1e-3 at the
  flagship, damped by the average over disorder.
"""

import ast
import os
import subprocess
import sys
import tomllib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.analysis import plots as jplots
from universal_quantum_optimal_control_tpu.data import named_gate_rotation_vectors as jnamed
from universal_quantum_optimal_control_tpu.demo import app as japp
from universal_quantum_optimal_control_tpu.models import (
    Pipeline as JPipeline,
    UniversalQOCTransformer as JModel,
    normalize_pulse_space as jnormalize,
    rotation_vector_from_unitary as jrv_from_u,
    score_embedding as jse,
)
from universal_quantum_optimal_control_tpu.models.serialization import (
    _flatten,
    load_params_npz as jload_npz,
    load_params_npz_tree as jload_npz_tree,
)
from universal_quantum_optimal_control_tpu.parallel import mc_parallel as jmc
from universal_quantum_optimal_control_tpu.utils import load_model_params as jload_config
from universal_quantum_optimal_control_tpu_torch.analysis import plots as tplots
from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
from universal_quantum_optimal_control_tpu_torch.data import named_gate_rotation_vectors
from universal_quantum_optimal_control_tpu_torch.demo import app as tapp
from universal_quantum_optimal_control_tpu_torch.models import (
    Pipeline,
    UniversalQOCTransformer,
    load_params_npz,
    params_from_jax,
    rotation_vector_from_unitary,
    score_embedding as tse,
)
from universal_quantum_optimal_control_tpu_torch.parallel import mean_fidelity_local

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "universal_quantum_optimal_control_tpu_torch"


def wrapped_err(a, b):
    a, b = np.asarray(a), np.asarray(b)
    dphi = np.angle(np.exp(1j * (a[..., 0].astype(np.float64) - b[..., 0])))
    return max(np.abs(dphi).max(), np.abs(a[..., 1:] - b[..., 1:]).max())


def rotation_vectors(n=12, seed=0):
    rng = np.random.default_rng(seed)
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rv = np.concatenate([axes, rng.uniform(0, 2 * np.pi, (n, 1))], axis=1)
    named = np.stack([np.asarray(v) for v in jnamed().values()])
    # gimbal cases: θ = 0, a z-axis rotation (β = 0), θ = π in the xz-plane
    gimbal = np.asarray([[1, 0, 0, 0], [0, 0, 1, 1.3], [0.6, 0, 0.8, np.pi]])
    return np.concatenate([rv, named, gimbal]).astype(np.float32)


@pytest.mark.parametrize("convention", ["angle", "reference"])
def test_score_features_match_jax(convention):
    rv = rotation_vectors()
    jt, jo = jse.score_features(jnp.asarray(rv), convention)
    tt, to = tse.score_features(torch.from_numpy(rv), convention)
    # 1e-6 abs plus 1e-5 rel: near the β = π pole (the first random target,
    # θ = 3.05) the Euler atan2s amplify the 1-ulp difference between XLA's
    # and PyTorch's f32 sin into 2.5e-6 on a 0.34 feature
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-6, rtol=1e-5)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)
    # from the same Euler angles, the SCORE sequence and its flattening agree
    # at 1e-6 abs everywhere
    euler = np.array(jse.euler_yxy_from_rotation_vector(jnp.asarray(rv)))
    jq = jse.quat_to_real_vector(jse.score_sequence_from_yxy(jnp.asarray(euler), convention))
    tq = tse.quat_to_real_vector(tse.score_sequence_from_yxy(torch.from_numpy(euler),
                                                             convention))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), atol=1e-6)
    te = tse.euler_yxy_from_rotation_vector(torch.from_numpy(rv)).numpy()
    np.testing.assert_allclose(te, euler, atol=1e-6)


def test_positional_encoding_matches_jax():
    j = np.asarray(jse.sinusoidal_positional_encoding(9, 64))
    t = tse.sinusoidal_positional_encoding(9, 64, device="cpu").numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)


TINY_SPACES = {
    2: {"phi": (-3.15, 3.15), "tau": (0.1, 0.5)},
    4: {"Delta": (-1.0, 1.0), "Omega": (0.0, 1.5), "phi": (-3.15, 3.15),
        "tau": (-0.5, 0.5)},  # τ < 0 exercises relu(τ)
}


@pytest.mark.parametrize("P", [2, 4])
def test_small_transformer_matches_jax(P):
    kw = dict(num_qubits=1, pulse_space=jnormalize(TINY_SPACES[P]), max_pulses=8,
              d_model=32, n_layers=2, n_heads=4, dropout=0.1)
    jm = JModel(**kw, dtype=jnp.float32)
    rv = rotation_vectors(seed=P)
    params = jm.init(jax.random.PRNGKey(P), rv[:1])
    j = np.asarray(jm.apply(params, rv))
    tm = UniversalQOCTransformer(**kw, dtype=torch.float32, device="cpu")
    tm.load_state_dict(params_from_jax(_flatten(params)))
    t = Pipeline(tm)(rv).numpy()
    assert t.shape == j.shape == (len(rv), 8, P)
    assert wrapped_err(t, j) <= 1e-4
    assert np.all(t[..., -1] >= 0) and np.all(np.abs(t[..., 0]) <= np.pi)


def test_npz_loader_matches_jax():
    path = tapp.MODEL_VARIANTS["length_100_med"]["checkpoint"]
    flat = load_params_npz(path)
    jflat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, prefix + k + "//")
            else:
                jflat[prefix + k] = np.asarray(v)

    walk(jload_npz_tree(path), "")
    assert set(flat) == set(jflat)
    with np.load(path) as raw:
        assert any(raw[k].dtype == np.int8 for k in raw.files)  # int8 + !scale
    for k, v in flat.items():
        assert v.dtype == np.float32
        np.testing.assert_array_equal(v, jflat[k])


def test_params_from_jax_rejects_unknown_keys():
    with pytest.raises(KeyError, match="unrecognized"):
        params_from_jax({"params//encoder_0//Conv_0//kernel": np.zeros((2, 2))})


def test_rotation_vector_from_unitary_matches_jax():
    from universal_quantum_optimal_control_tpu.core import su2 as jsu2
    q = np.asarray(jsu2.rotation_vector_to_quat(jnp.asarray(rotation_vectors())))
    U = np.array(jsu2.quat_to_su2(jnp.asarray(q)))
    j = np.asarray(jrv_from_u(jnp.asarray(U)))
    t = rotation_vector_from_unitary(torch.from_numpy(U)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-5)


@pytest.fixture(scope="module")
def flagship():
    """length_100 loaded by both packages in f32, with both sides' pulses
    for the 5 named gates."""
    spec = japp.MODEL_VARIANTS["length_100"]
    mp = jload_config(spec["config"])
    mp["pulse_space"] = jnormalize(mp["pulse_space"])
    mp["finetune"] = False
    jm = JModel(**mp, dtype=jnp.float32)
    rv = np.stack([np.asarray(v) for v in jnamed().values()])
    target = jax.jit(jm.init)(jax.random.PRNGKey(0), rv[:1])
    jpipe = JPipeline(jm, jload_npz(spec["checkpoint"], target))
    pipe = tapp.load_pipeline("length_100", device="cpu", dtype=torch.float32)
    return rv, jpipe, np.asarray(jpipe(rv)), pipe, pipe(rv).numpy()


@pytest.mark.artifacts
def test_flagship_pulses_match_jax(flagship):
    rv, jpipe, jp, pipe, tp = flagship
    assert tp.shape == (5, 100, 2)
    assert wrapped_err(tp, jp) <= 1e-3
    single, q = tapp.compute_pulses("length_100", 1.0, 0.0, 0.0, np.pi,
                                    device="cpu", dtype=torch.float32)
    np.testing.assert_allclose(single, tp[0], atol=1e-5)
    np.testing.assert_allclose(q.numpy(), [0.0, 1.0, 0.0, 0.0], atol=1e-6)
    # the unitary entry point: X(π/2) and Z(π/4), away from the θ = π pole
    U = np.asarray([[[np.cos(np.pi / 4), -1j * np.sin(np.pi / 4)],
                     [-1j * np.sin(np.pi / 4), np.cos(np.pi / 4)]],
                    [[np.exp(-1j * np.pi / 8), 0], [0, np.exp(1j * np.pi / 8)]]],
                   np.complex64)
    assert wrapped_err(pipe.forward_with_unitary(U).numpy(),
                       jpipe.forward_with_unitary(U)) <= 1e-3


@pytest.mark.artifacts
def test_flagship_expected_fidelity_matches_jax(flagship):
    rv, _, jp, _, tp = flagship
    rng = np.random.default_rng(3)
    delta = rng.standard_normal((5, 4096)).astype(np.float32)
    eps = (0.05 * rng.standard_normal((5, 4096))).astype(np.float32)
    qt = rotation_vector_to_quat(torch.from_numpy(rv))
    j = np.asarray(jmc.mean_fidelity_local(jnp.asarray(jp), jnp.asarray(qt.numpy()),
                                           jnp.asarray(delta), jnp.asarray(eps)))
    t = mean_fidelity_local(torch.from_numpy(tp), qt, torch.from_numpy(delta),
                            torch.from_numpy(eps), backend="pallas").numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)
    # the B3 estimator on the same explicit draws
    jm, jse_ = jplots._mc_stats(jnp.asarray(jp[0]), jnp.asarray(qt[0].numpy()),
                                jnp.asarray(delta[0]), jnp.asarray(eps[0]))
    tm, tse_ = tplots._mc_stats(torch.from_numpy(tp[0]), qt[0],
                                torch.from_numpy(delta[0]), torch.from_numpy(eps[0]))
    np.testing.assert_allclose([float(tm), float(tse_)], [float(jm), float(jse_)],
                               atol=1e-4)


@pytest.mark.artifacts
def test_bf16_served_expected_fidelity_matches_jax_bf16():
    """The demo serves ``length_100`` in bf16 (as the JAX demo does): each
    package's bf16 pulses, scored by its plain version on the same draws
    (σ_δ = 1, ε_std = 0.05, M = 2¹⁴), give the same E[F] within 1e-4 on the
    5 named gates and 3 seeded random targets.  The pulses themselves differ
    by up to ~1e-2 rad: bf16 rounds at other places in the two frameworks,
    and the average over disorder damps that."""
    spec = japp.MODEL_VARIANTS["length_100"]
    mp = jload_config(spec["config"])
    mp["pulse_space"] = jnormalize(mp["pulse_space"])
    mp["finetune"] = False
    jm = JModel(**mp, dtype=jnp.bfloat16)
    rv = rotation_vectors(n=3, seed=11)[:8]  # 3 random, then the 5 named
    target = jax.jit(jm.init)(jax.random.PRNGKey(0), rv[:1])
    jp = np.asarray(JPipeline(jm, jload_npz(spec["checkpoint"], target))(rv))
    tp = tapp.load_pipeline("length_100", device="cpu", dtype=torch.bfloat16)(rv).numpy()
    rng = np.random.default_rng(12)
    delta = rng.standard_normal((8, 1 << 14)).astype(np.float32)
    eps = (0.05 * rng.standard_normal((8, 1 << 14))).astype(np.float32)
    qt = rotation_vector_to_quat(torch.from_numpy(rv))
    j = np.asarray(jmc.mean_fidelity_local(jnp.asarray(jp), jnp.asarray(qt.numpy()),
                                           jnp.asarray(delta), jnp.asarray(eps)))
    t = mean_fidelity_local(torch.from_numpy(tp), qt, torch.from_numpy(delta),
                            torch.from_numpy(eps), backend="xla").numpy()
    np.testing.assert_allclose(t, j, atol=1e-4)
    assert np.all((t > 0.5) & (t <= 1.0))


def test_mc_fidelity_estimate_runs_on_cpu():
    pulses = np.stack([np.full(8, 0.0), np.full(8, np.pi / 8)], -1).astype(np.float32)
    mean, se = tplots.mc_fidelity_estimate(pulses, np.asarray([0, 1.0, 0, 0]),
                                           delta_std=0.0, epsilon_std=0.0,
                                           monte_carlo=64, device="cpu")
    # eight π/8 x-rotations make X(π) exactly without disorder
    assert abs(mean - 1.0) < 1e-6 and se < 1e-6
    U = np.asarray([[0, -1j], [-1j, 0]], np.complex64)  # X(π) as a unitary
    mean_u, _ = tplots.mc_fidelity_estimate(pulses, U, 1.0, 0.05, 256, device="cpu")
    assert 0.0 < mean_u < 1.0


def test_named_gates_and_device_default():
    gates = named_gate_rotation_vectors(device="cpu")
    j = jnamed()
    assert list(gates) == list(j)
    for k in j:
        np.testing.assert_allclose(gates[k].numpy(), np.asarray(j[k]), atol=0)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tapp.load_pipeline("length_100_med")


FORBIDDEN = ("jax", "flax", "optax", "orbax", "torch.utils.cpp_extension",
             "universal_quantum_optimal_control_tpu")
# drawing and the UI are optional (the card's machine has neither): imported
# only inside the function that draws or serves, never at a module's import
LAZY_ONLY = ("matplotlib", "gradio")


def _is(mod, names):
    return any(mod == f or mod.startswith(f + ".") for f in names)


def _imports(path):
    """``(module, inside a function)`` for each absolute import of the file."""
    tree = ast.parse(path.read_text())
    in_function = {id(n) for fn in ast.walk(tree)
                   if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
                   for n in ast.walk(fn) if n is not fn}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, id(node) in in_function) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, id(node) in in_function


TRAINING_HALF = ("training/__init__.py", "training/checkpoint.py", "training/metrics.py",
                 "training/resume.py", "training/systems.py", "training/trainer.py",
                 "workloads/__init__.py", "workloads/universal_single_qubit.py")
TWO_QUBIT_SERVING = ("core/su4.py", "ops/propagate_su4.py", "data/su4_targets.py",
                     "models/two_qubit.py", "optimizers/__init__.py",
                     "optimizers/two_qubit_grape.py", "workloads/two_qubit_eval.py",
                     "analysis/plots_su4.py")
TWO_QUBIT_PER_GATE = ("workloads/two_qubit_grape.py", "workloads/finetune_two_qubit_gates.py",
                      "analysis/dephasing_bound.py", "analysis/two_qubit_split_eval.py",
                      "demo/app.py")
SLICE_2 = ("models/grape.py", "workloads/grape_single_qubit.py", "workloads/finetune_gates.py",
           "analysis/p4_grape_ceiling.py", "optimizers/dcrab.py",
           "workloads/dcrab_single_qubit.py")
SLICE_4B = ("analysis/fits.py", "analysis/score_pulses.py", "analysis/bloch.py",
            "analysis/compare.py", "analysis/parity_figure.py",
            "analysis/two_qubit_bundle_figure.py", "analysis/visualize_universal.py")


def test_port_imports_nothing_forbidden():
    files = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
    assert len(files) > 15
    assert {str(p.relative_to(PORT)) for p in files if PORT in p.parents} >= \
        set(TRAINING_HALF) | set(TWO_QUBIT_SERVING) | set(TWO_QUBIT_PER_GATE) | set(SLICE_2) \
        | set(SLICE_4B)
    for path in files:
        for mod, lazy in _imports(path):
            assert not _is(mod, FORBIDDEN), f"{path.relative_to(REPO)} imports {mod}"
            assert lazy or not _is(mod, LAZY_ONLY), \
                f"{path.relative_to(REPO)} imports {mod} at module level"


def test_port_import_loads_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import universal_quantum_optimal_control_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'flax', 'optax', 'orbax', 'matplotlib',\n"
        "                                  'gradio')\n"
        "             or m.startswith('universal_quantum_optimal_control_tpu.')\n"
        "             or m == 'universal_quantum_optimal_control_tpu')\n"
        "need = ['training.trainer', 'training.systems', 'training.checkpoint',\n"
        "        'training.resume', 'training.metrics', 'workloads.universal_single_qubit',\n"
        "        'core.su4', 'ops.propagate_su4', 'data.su4_targets', 'models.two_qubit',\n"
        "        'optimizers.two_qubit_grape', 'workloads.two_qubit_eval',\n"
        "        'workloads.two_qubit', 'workloads.two_qubit_grape',\n"
        "        'workloads.finetune_two_qubit_gates', 'analysis.dephasing_bound',\n"
        "        'analysis.two_qubit_split_eval', 'demo.app',\n"
        "        'analysis.plots_su4', 'models.grape', 'workloads.grape_single_qubit',\n"
        "        'workloads.finetune_gates', 'analysis.p4_grape_ceiling',\n"
        "        'optimizers.dcrab', 'workloads.dcrab_single_qubit',\n"
        "        'analysis.fits', 'analysis.score_pulses', 'analysis.bloch',\n"
        "        'analysis.compare', 'analysis.parity_figure',\n"
        "        'analysis.two_qubit_bundle_figure', 'analysis.visualize_universal']\n"
        "missing = [m for m in need if p.__name__ + '.' + m not in sys.modules]\n"
        "print(bad, missing)\n"
        "sys.exit(1 if bad or missing else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_packaging_finds_the_port():
    from setuptools import find_packages
    include = tomllib.loads((REPO / "pyproject.toml").read_text())[
        "tool"]["setuptools"]["packages"]["find"]["include"]
    found = set(find_packages(where=str(REPO), include=include))
    sub = {"core", "ops", "parallel", "models", "data", "demo", "analysis", "utils",
           "training", "workloads", "optimizers"}
    port = "universal_quantum_optimal_control_tpu_torch"
    assert {port} | {f"{port}.{s}" for s in sub} <= found


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_a_card(where, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run in full")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if where == "alone":
        cwd = tmp_path
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
