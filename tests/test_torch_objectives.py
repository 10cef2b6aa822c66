"""PyTorch port, the pieces of the training half of slice 1 below the
trainer: ``build_su2_dataset``, the objectives, the optimizer and its
schedule, the Flax-like initialization, the encoder transfer, checkpoints
and base pulses, against the JAX package on the same numpy inputs (CPU,
f32).  The trainer and the CLI are in ``test_torch_train.py``.

Tolerances:
* 1e-6 abs for the dataset's grid and its rotation-vector → quaternion map
  and for the fidelities and losses (rtol 1e-6 as well where the log
  barrier reaches ~10²): a few f32 ulps of single operations;
* 1e-6 relative for the clip and the learning-rate schedule, 2e-5 for
  each Adam update (see ``test_clip_then_adam_matches_optax``).
"""

import dataclasses
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from universal_quantum_optimal_control_tpu.core import objectives as jobj
from universal_quantum_optimal_control_tpu.core import su2 as jsu2
from universal_quantum_optimal_control_tpu.data import su2_targets as jdata
from universal_quantum_optimal_control_tpu.models import UniversalQOCTransformer as JModel
from universal_quantum_optimal_control_tpu.models.serialization import _flatten
from universal_quantum_optimal_control_tpu.models.two_qubit import (
    transfer_encoder_params as jtransfer)
from universal_quantum_optimal_control_tpu.training import TrainConfig as JConfig
from universal_quantum_optimal_control_tpu.training import Trainer as JTrainer
from universal_quantum_optimal_control_tpu.workloads import universal_single_qubit as jcli
from universal_quantum_optimal_control_tpu_torch.core import objectives as tobj
from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
from universal_quantum_optimal_control_tpu_torch.data import su2_targets as tdata
from universal_quantum_optimal_control_tpu_torch.models import (
    UniversalQOCTransformer, params_from_jax, transfer_encoder_params)
from universal_quantum_optimal_control_tpu_torch.training import (
    TrainConfig, Trainer, learning_rate_at, list_checkpoints, restore_checkpoint,
    save_checkpoint)
from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit as cli

TINY = dict(num_qubits=1, pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.1, 0.5))),
            max_pulses=8, d_model=32, n_layers=2, n_heads=4, dropout=0.1)


# ---------------------------------------------------------------------------
# dataset
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_size", [100, 1000])  # 1000 → a 31 × 31 grid
def test_grid_dataset_matches_jax(batch_size):
    key = jax.random.PRNGKey(batch_size)
    j_rv, j_q = (np.asarray(a) for a in jdata.build_su2_dataset(key, batch_size))
    Bs = math.isqrt(batch_size)
    # JAX's own azimuth draw, handed to the port's deterministic map
    phi = np.array(jax.random.uniform(key, (Bs * Bs,)) * 2.0 * jnp.pi)
    theta, alpha = tdata.grid_angles(batch_size)
    rv, q = tdata.targets_from_angles(theta, alpha, torch.from_numpy(phi))
    np.testing.assert_allclose(rv.numpy(), j_rv, atol=1e-6)
    np.testing.assert_allclose(q.numpy(), j_q, atol=1e-6)
    # build_su2_dataset itself: the grid part (α, cos θ) is JAX's exactly; the
    # azimuth is its own draw
    t_rv, t_q = tdata.build_su2_dataset(torch.Generator().manual_seed(0), batch_size,
                                        device="cpu")
    assert t_rv.shape == t_q.shape == (Bs * Bs, 4)
    np.testing.assert_allclose(t_rv[:, 3].numpy(), j_rv[:, 3], atol=1e-6)
    np.testing.assert_allclose(t_rv[:, 2].numpy(), j_rv[:, 2], atol=1e-6)
    np.testing.assert_allclose(t_q.numpy(), rotation_vector_to_quat(t_rv).numpy(), atol=1e-6)


@pytest.mark.parametrize("haar", [False, True])
def test_random_dataset_draws_and_map(haar):
    gen = torch.Generator().manual_seed(3)
    rv, q = tdata.build_su2_dataset(gen, 20000, random=True, haar=haar, device="cpu")
    rv2, _ = tdata.build_su2_dataset(torch.Generator().manual_seed(3), 20000, random=True,
                                     haar=haar, device="cpu")
    assert torch.equal(rv, rv2) and rv.shape == (20000, 4)
    np.testing.assert_allclose(torch.linalg.norm(rv[:, :3], dim=1).numpy(), 1.0, atol=1e-6)
    assert float(rv[:, 3].min()) >= 0.0 and float(rv[:, 3].max()) <= 2 * math.pi
    # the map against JAX's on the same vectors
    j_q = np.asarray(jsu2.axis_angle_to_quat(jnp.asarray(rv[:, :3].numpy()),
                                             jnp.asarray(rv[:, 3].numpy())))
    np.testing.assert_allclose(q.numpy(), j_q, atol=1e-6)
    # Haar: cos θ ~ U(-1, 1), so E[n_z²] = 1/3; the polar draw θ ~ U(0, π)
    # gives E[cos² θ] = 1/2 (5-sigma bounds at n = 2e4)
    mean_nz2 = float((rv[:, 2] ** 2).mean())
    assert abs(mean_nz2 - (1 / 3 if haar else 1 / 2)) < 0.012


# ---------------------------------------------------------------------------
# objectives
# ---------------------------------------------------------------------------

def _unitaries(rng, n, d):
    z = rng.standard_normal((n, d, d)) + 1j * rng.standard_normal((n, d, d))
    q, r = np.linalg.qr(z)
    return (q * (np.diagonal(r, axis1=-2, axis2=-1) / np.abs(np.diagonal(
        r, axis1=-2, axis2=-1)))[:, None, :]).astype(np.complex64)


@pytest.mark.parametrize("name", ["entanglement_fidelity", "trace_fidelity",
                                  "dcrab_fidelity"])
@pytest.mark.parametrize("d", [2, 4])
def test_matrix_fidelities_match_jax(name, d):
    rng = np.random.default_rng(d)
    U, V = _unitaries(rng, 64, d), _unitaries(rng, 64, d)
    V[0] = U[0]  # the maximum: 1, 1 and 2/(d+1) (the unsquared dCRAB quirk)
    j = np.asarray(getattr(jobj, name)(jnp.asarray(U), jnp.asarray(V)))
    t = getattr(tobj, name)(torch.from_numpy(U), torch.from_numpy(V)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)


@pytest.mark.parametrize("name", ["entanglement_fidelity_q", "trace_fidelity_q"])
def test_quaternion_fidelities_match_jax(name):
    rng = np.random.default_rng(7)
    q = rng.standard_normal((2, 64, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    j = np.asarray(getattr(jobj, name)(jnp.asarray(q[0]), jnp.asarray(q[1])))
    t = getattr(tobj, name)(torch.from_numpy(q[0]), torch.from_numpy(q[1])).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)


@pytest.mark.parametrize("name,kw", [
    ("negative_log_loss", {}), ("infidelity_loss", {}),
    ("sharp_loss", {}), ("sharp_loss", {"tau_bar": 0.95, "k": 30.0}),
    ("log_barrier", {})])
def test_losses_match_jax(name, kw):
    """E[F] from 0.01 to 1: at k = 100 the softplus argument runs past its
    threshold of 20 for E[F] < 0.79, where torch returns the argument."""
    f = np.concatenate([np.linspace(0.01, 1.0, 400), [0.79, 0.7899, 0.99, 0.995]]
                       ).astype(np.float32)
    j = np.asarray(getattr(jobj, name)(jnp.asarray(f), **kw))
    t = getattr(tobj, name)(torch.from_numpy(f), **kw).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizer and schedule
# ---------------------------------------------------------------------------

def _zero_params(shapes):
    model = torch.nn.Module()
    for i, s in enumerate(shapes):
        model.register_parameter(f"p{i}", torch.nn.Parameter(torch.zeros(s)))
    return model


@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_clip_then_adam_matches_optax(schedule):
    """Five steps of the JAX trainer's optax chain and the port's
    clip-then-Adam on identical gradients; steps 0, 2 and 4 have a global
    norm above the clip, 1 and 3 below it.

    The clip is held to 1e-6 relative.  Each step's Adam update is held to
    2e-5 relative: optax forms the bias correction 1 − 0.999ᵗ in f32 from
    0.999 rounded to 0.99900001, which leaves it 1.3e-5 to 2.7e-5 off for
    t ≤ 5 (half that after the square root), while torch forms it in
    float64; 1e-6 is below optax's own rounding there."""
    shapes = [(3, 5), (5,), (2, 2, 2)]
    rng = np.random.default_rng(11)
    grads = [[(rng.standard_normal(s) * (3.0 if step % 2 == 0 else 0.05)).astype(np.float32)
              for s in shapes] for step in range(5)]
    kw = dict(learning_rate=1e-2, lr_schedule=schedule, lr_schedule_steps=40,
              grad_clip=1.0)
    jtr = JTrainer(object(), JConfig(**kw))
    jparams = [jnp.zeros(s, jnp.float32) for s in shapes]
    jstate = jtr.optimizer.init(jparams)
    model = _zero_params(shapes)
    tr = Trainer(model, TrainConfig(**kw), device="cpu")

    def set_grads(g):
        for p, x in zip(model.parameters(), g):
            p.grad = torch.from_numpy(x.copy())

    for step, g in enumerate(grads):
        norm = math.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g))
        assert (norm >= 1.0) == (step % 2 == 0)
        clipped, _ = optax.clip_by_global_norm(1.0).update([jnp.asarray(x) for x in g], None)
        set_grads(g)
        tr._clip_grads()
        for p, c in zip(model.parameters(), clipped):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(c), rtol=1e-6, atol=0)

        before = [p.detach().clone() for p in model.parameters()]
        updates, jstate = jtr.optimizer.update([jnp.asarray(x) for x in g], jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        set_grads(g)
        tr.apply_gradients()
        for p, b, u in zip(model.parameters(), before, updates):
            np.testing.assert_allclose((p.detach() - b).numpy(), np.asarray(u), rtol=2e-5,
                                       atol=0)
    assert tr.step_count == 5


def test_cosine_schedule_matches_optax_step_for_step():
    """1e-6 relative, plus two f32 ulps of the peak rate: optax evaluates
    the warm-up (init − peak)·frac + peak in f32, and its cancellation near
    the start leaves about one ulp of the peak (1.8e-6 of 0.05·lr)."""
    cfg = TrainConfig(learning_rate=3e-4, lr_schedule="cosine", lr_schedule_steps=1000)
    sched = optax.warmup_cosine_decay_schedule(
        init_value=3e-4 * 0.05, peak_value=3e-4, warmup_steps=50, decay_steps=1000,
        end_value=3e-4 * 0.1)
    steps = np.arange(1200)
    j = np.asarray(jax.vmap(sched)(jnp.asarray(steps)))
    t = np.asarray([learning_rate_at(cfg, int(s)) for s in steps])
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=2 * np.spacing(np.float32(3e-4)))
    assert learning_rate_at(TrainConfig(learning_rate=3e-4), 777) == 3e-4
    with pytest.raises(ValueError, match="lr_schedule"):
        learning_rate_at(TrainConfig(lr_schedule="linear"), 0)


def test_train_config_fields_and_defaults_match_jax():
    t = {f.name: f.default for f in dataclasses.fields(TrainConfig)}
    j = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert t == j


def test_init_like_flax_matches_flax_statistics():
    """Dense kernels: lecun_normal (truncated at ±2σ, std 1/√fan_in); biases
    0; LayerNorm 1 and 0.  Per layer, the drawn std agrees with Flax's own
    draw within 3 % and neither exceeds the truncation bound."""
    kw = {**TINY, "d_model": 128, "n_heads": 8, "n_layers": 1, "max_pulses": 16}
    jm = JModel(**kw, dtype=jnp.float32)
    jp = params_from_jax(_flatten(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4)))))
    model = UniversalQOCTransformer(**kw, dtype=torch.float32, device="cpu")
    model.init_like_flax(torch.Generator().manual_seed(0))
    sd = model.state_dict()
    assert set(sd) == set(jp)
    for name, w in sd.items():
        if name.endswith("bias"):
            assert float(w.abs().max()) == 0.0 == float(jp[name].abs().max())
        elif ".ln" in name:
            assert torch.equal(w, torch.ones_like(w)) and torch.equal(jp[name], w)
        else:
            fan_in = w.shape[1]
            target = 1.0 / math.sqrt(fan_in)
            limit = 2.0 * target / 0.87962566103423978
            for x in (w, jp[name]):
                assert abs(float(x.std()) - target) < 0.03 * target, name
                assert float(x.abs().max()) <= limit * (1 + 1e-6), name


# ---------------------------------------------------------------------------
# encoder transfer, checkpoints, base pulses
# ---------------------------------------------------------------------------

def test_transfer_encoder_params_matches_jax():
    src_j = jax.jit(JModel(**TINY, dtype=jnp.float32).init)(jax.random.PRNGKey(1),
                                                            jnp.zeros((1, 4)))
    dst_kw = {**TINY, "max_pulses": 6}  # another head: only encoder + unitary_proj move
    dst_j = jax.jit(JModel(**dst_kw, dtype=jnp.float32).init)(jax.random.PRNGKey(2),
                                                              jnp.zeros((1, 4)))
    out_j = jtransfer(src_j, dst_j, also=("unitary_proj",))
    out_t = transfer_encoder_params(params_from_jax(_flatten(src_j)),
                                    params_from_jax(_flatten(dst_j)),
                                    also=("unitary_proj",))
    want = params_from_jax(_flatten(out_j))
    assert set(out_t) == set(want)
    for k in want:
        np.testing.assert_array_equal(out_t[k].numpy(), want[k].numpy(), err_msg=k)
    # the head kept the destination's values
    np.testing.assert_array_equal(out_t["head.weight"].numpy(),
                                  params_from_jax(_flatten(dst_j))["head.weight"].numpy())
    other = UniversalQOCTransformer(**{**TINY, "d_model": 16}, device="cpu").state_dict()
    with pytest.raises(ValueError, match="no encoder blocks"):
        transfer_encoder_params(params_from_jax(_flatten(src_j)), other)


def test_checkpoint_round_trip(tmp_path):
    model = UniversalQOCTransformer(**TINY, device="cpu")
    path = save_checkpoint(str(tmp_path), model.state_dict(), "band0",
                           metadata={"best_fid": np.float32(0.5)})
    params, meta = restore_checkpoint(str(tmp_path), "band0")
    assert Path(path) == tmp_path / "band0" and meta == {"best_fid": 0.5}
    for k, v in model.state_dict().items():
        assert torch.equal(params[k], v)
    assert list_checkpoints(str(tmp_path)) == ["band0"]
    with pytest.raises(FileNotFoundError, match="band0"):
        restore_checkpoint(str(tmp_path), "band9")


def test_load_base_pulse_matches_jax(tmp_path):
    table = np.random.default_rng(0).uniform(0, 1, (3, 8, 2)).astype(np.float32)
    np.savez(tmp_path / "p.npz", pulses=table)
    np.savetxt(tmp_path / "p.csv", table[0], delimiter=",", header="phi,tau")
    for name in ("p.npz", "p.csv"):
        j = np.asarray(jcli.load_base_pulse(str(tmp_path / name)))
        t = cli.load_base_pulse(str(tmp_path / name))
        assert t.shape == (1, 8, 2)
        np.testing.assert_array_equal(t, j)
