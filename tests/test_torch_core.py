"""PyTorch port, core: quaternion algebra, segment closed forms and the plain
propagator against the JAX package on the same numpy inputs (CPU, f32).

Tolerances: 1e-6 abs for single operations (a few f32 ulps of O(1) values,
since the two frameworks' sin/cos/sqrt may round differently), 1e-5 abs for
the L = 20 product (those differences accumulate over 20 dependent Hamilton
products).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.core import propagate as jprop
from universal_quantum_optimal_control_tpu.core import su2 as jsu2
from universal_quantum_optimal_control_tpu_torch.core import errors as terrors
from universal_quantum_optimal_control_tpu_torch.core import propagate as tprop
from universal_quantum_optimal_control_tpu_torch.core import su2 as tsu2
from universal_quantum_optimal_control_tpu_torch.utils import resolve_device

OP_TOL = 1e-6
PRODUCT_TOL = 1e-5


def _rng(seed):
    return np.random.default_rng(seed)


def _quats(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _both(fn_name, *args):
    j = getattr(jsu2, fn_name)(*[jnp.asarray(a) for a in args])
    t = getattr(tsu2, fn_name)(*[torch.from_numpy(np.array(a)) for a in args])
    return np.asarray(j), t.numpy()


@pytest.mark.parametrize("fn_name", ["quat_multiply", "quat_trace_inner",
                                     "quat_fidelity"])
def test_binary_quat_ops_match_jax(fn_name):
    rng = _rng(0)
    j, t = _both(fn_name, _quats(rng, 64), _quats(rng, 64))
    np.testing.assert_allclose(t, j, atol=OP_TOL)


@pytest.mark.parametrize("fn_name", ["quat_conj", "quat_normalize"])
def test_unary_quat_ops_match_jax(fn_name):
    q = 3.0 * _rng(1).standard_normal((64, 4)).astype(np.float32)
    j, t = _both(fn_name, q)
    np.testing.assert_allclose(t, j, atol=OP_TOL)


def test_axis_angle_and_rotation_vector_match_jax():
    rng = _rng(2)
    axis = rng.standard_normal((64, 3)).astype(np.float32)
    axis[0] = 0.0  # zero axis → identity
    angle = rng.uniform(-2 * np.pi, 2 * np.pi, 64).astype(np.float32)
    j, t = _both("axis_angle_to_quat", axis, angle)
    np.testing.assert_allclose(t, j, atol=OP_TOL)
    rv = np.concatenate([axis, angle[:, None]], axis=1)
    j, t = _both("rotation_vector_to_quat", rv)
    np.testing.assert_allclose(t, j, atol=OP_TOL)


def test_su2_round_trip_matches_jax():
    q = _quats(_rng(3), 64)
    j, t = _both("quat_to_su2", q)
    assert t.dtype == np.complex64
    np.testing.assert_allclose(t, j, atol=OP_TOL)
    j2, t2 = _both("su2_to_quat", j)
    np.testing.assert_allclose(t2, j2, atol=OP_TOL)
    np.testing.assert_allclose(t2, q, atol=OP_TOL)


def _segment_inputs(rng, n=256):
    return dict(
        phi=rng.uniform(-np.pi, np.pi, n).astype(np.float32),
        omega=rng.uniform(-0.5, 1.5, n).astype(np.float32),  # Ω < 0 clamps
        det=rng.uniform(-1.0, 1.0, n).astype(np.float32),
        tau=rng.uniform(0.0, 0.6, n).astype(np.float32),
        delta=rng.standard_normal(n).astype(np.float32),
        epsilon=(0.05 * rng.standard_normal(n)).astype(np.float32),
    )


@pytest.mark.parametrize("fn_name,keys", [
    ("segment_quat", ("phi", "tau", "delta", "epsilon")),
    ("segment_quat_amp", ("phi", "omega", "tau", "delta", "epsilon")),
    ("segment_quat_det", ("phi", "omega", "det", "tau", "delta", "epsilon")),
])
def test_segment_closed_forms_match_jax(fn_name, keys):
    x = _segment_inputs(_rng(4))
    j, t = _both(fn_name, *(x[k] for k in keys))
    np.testing.assert_allclose(t, j, atol=OP_TOL)
    np.testing.assert_allclose(np.linalg.norm(t, axis=-1), 1.0, atol=OP_TOL)


def mc_inputs(P, B=3, L=20, M=64, seed=5):
    rng = _rng(seed + P)
    cols = [rng.uniform(-np.pi, np.pi, (B, L))]
    if P >= 3:
        cols.append(rng.uniform(-0.3, 1.5, (B, L)))
    if P == 4:
        cols.append(rng.uniform(-1.0, 1.0, (B, L)))
    cols.append(rng.uniform(0.05, 0.5, (B, L)))
    pulses = np.stack(cols, axis=-1).astype(np.float32)
    delta = rng.standard_normal((B, M)).astype(np.float32)
    eps = (0.05 * rng.standard_normal((B, M))).astype(np.float32)
    return pulses, delta, eps


@pytest.mark.parametrize("P", [2, 3, 4])
def test_propagate_mc_matches_jax_scan(P):
    pulses, delta, eps = mc_inputs(P)
    j = np.asarray(jprop.propagate_mc(jnp.asarray(pulses), jnp.asarray(delta),
                                      jnp.asarray(eps), method="scan"))
    t = tprop.propagate_mc(torch.from_numpy(pulses), torch.from_numpy(delta),
                           torch.from_numpy(eps)).numpy()
    assert t.shape == (3, 64, 4)
    np.testing.assert_allclose(t, j, atol=PRODUCT_TOL)


def test_propagate_rejects_unknown_pulse_width():
    with pytest.raises(ValueError, match="parameter count"):
        tprop.propagate_mc(torch.zeros(1, 2, 5), torch.zeros(1, 3), torch.zeros(1, 3))


def test_sample_ore_ple_uses_the_generator():
    g1 = torch.Generator().manual_seed(11)
    g2 = torch.Generator().manual_seed(11)
    d1, e1 = terrors.sample_ore_ple(g1, (4, 50000), delta_std=0.7, epsilon_std=0.05)
    d2, e2 = terrors.sample_ore_ple(g2, (4, 50000), delta_std=0.7, epsilon_std=0.05)
    assert torch.equal(d1, d2) and torch.equal(e1, e2)
    assert d1.shape == e1.shape == (4, 50000) and d1.device.type == "cpu"
    # independent gaussians of the given stds (5-sigma bounds at n = 2e5)
    assert abs(float(d1.std()) - 0.7) < 0.01 and abs(float(e1.std()) - 0.05) < 1e-3
    assert abs(float(torch.corrcoef(torch.stack([d1.flatten(), e1.flatten()]))[0, 1])) < 0.012


def test_entry_points_default_to_cuda(tmp_path):
    """``resolve_device``, the ``Trainer``, ``build_su2_dataset``, the
    training CLIs, the two-qubit eval CLI and its model loader, and the SU(4)
    grid and sweep run on CUDA unless given the CPU, and raise where there
    is no CUDA; none moves to the CPU by itself.  The eval CLI scores with
    ``SU4System(backend="pallas")``, kernel B6; the two-qubit training CLI
    trains through B4 and B5 and keeps the JAX CLI's ``--max_pulses`` 40."""
    from universal_quantum_optimal_control_tpu_torch.analysis import (fidelity_by_std_su4,
                                                                      fidelity_grid_su4)
    from universal_quantum_optimal_control_tpu_torch.data import build_su2_dataset
    from universal_quantum_optimal_control_tpu_torch.training import SU4System, Trainer
    from universal_quantum_optimal_control_tpu_torch.workloads import (two_qubit,
                                                                       two_qubit_eval,
                                                                       universal_single_qubit)

    model = torch.nn.Linear(4, 2)
    gen = torch.Generator().manual_seed(0)
    argv = ["--num_epoch", "1", "--save_path", str(tmp_path / "run")]
    eval_args = two_qubit_eval.build_parser().parse_args([])
    assert (eval_args.device, eval_args.backend) == ("cuda", "pallas")
    train2_args = two_qubit.build_parser().parse_args([])
    assert (train2_args.device, train2_args.backend, train2_args.max_pulses) == \
        ("cuda", "pallas", 40)
    pulses = torch.zeros(3, 4)
    cz = torch.diag(torch.tensor([1.0, 1.0, 1.0, -1.0])).numpy()
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        for call in (resolve_device, lambda: Trainer(model),
                     lambda: build_su2_dataset(gen, 16),
                     lambda: universal_single_qubit.main(argv),
                     lambda: two_qubit.main(["--save_path", str(tmp_path / "run2")]),
                     lambda: two_qubit_eval.main(["--out", str(tmp_path / "eval.md")]),
                     lambda: two_qubit_eval.load_two_qubit_model(two_qubit_eval.DEFAULT_CKPT),
                     lambda: two_qubit_eval.best_phase_pulses(
                         two_qubit_eval.DEFAULT_CKPT, cz[None], SU4System(backend="pallas")),
                     lambda: fidelity_grid_su4(pulses, cz, n_delta=3),
                     lambda: fidelity_by_std_su4(pulses, cz, monte_carlo=4)):
            with pytest.raises(RuntimeError, match="device='cpu'"):
                call()
        assert not any((tmp_path / f).exists() for f in ("run", "run2", "eval.md"))
    assert resolve_device("cpu").type == "cpu"
    assert Trainer(model, device="cpu").device.type == "cpu"
    rv, q = build_su2_dataset(gen, 16, device="cpu")
    assert rv.device.type == q.device.type == "cpu"
