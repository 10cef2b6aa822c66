"""PyTorch port, slice 2: the GRAPE model (``models/grape.py``) and its
training CLI (``workloads/grape_single_qubit.py``) against the JAX package.

The same numpy inputs go through both packages (CPU, f32, L = 16):

* the forward from carried-over parameters, MLP and direct mode, pulses
  within 1e-5 abs (the atan2 quirk included: φ before the range map lies
  in (0, π/2));
* three trainer steps against the JAX trainer's ``_objective`` (the JAX
  Pallas kernels in interpret mode or, in direct mode, its XLA path; the
  port's kernels' plain versions on CPU tensors) at the tolerances of
  ``tests/test_torch_train.py::test_three_train_steps_match_jax``: losses
  and E[F] 1e-4 relative, gradients 1e-4 relative plus 1e-4 of the step's
  largest |g|, parameters as there;
* the initial values' statistics, the direct-mode ``ValueError``, and the
  CLI end to end on the CPU (``--mesh`` of more ranks than run raises).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from universal_quantum_optimal_control_tpu.models import GRAPE as JGRAPE
from universal_quantum_optimal_control_tpu.models.serialization import _flatten
from universal_quantum_optimal_control_tpu.training import TrainConfig as JConfig
from universal_quantum_optimal_control_tpu.training import Trainer as JTrainer
from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
from universal_quantum_optimal_control_tpu_torch.models import GRAPE, params_from_jax
from universal_quantum_optimal_control_tpu_torch.training import TrainConfig, Trainer
from universal_quantum_optimal_control_tpu_torch.workloads import grape_single_qubit as cli

SPACE2 = (("phi", (-3.15, 3.15)), ("tau", (0.035, 0.07)))
SPACE4 = (("phi", (-3.15, 3.15)), ("omega", (0.0, 1.0)), ("delta", (-5.0, 5.0)),
          ("tau", (0.1, 0.5)))
L = 16


def rotation_vectors(B, seed=0):
    rng = np.random.default_rng(seed)
    axes = rng.standard_normal((B, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return np.concatenate([axes, rng.uniform(0, 2 * np.pi, (B, 1))], 1).astype(np.float32)


def carried(jm, tm, rv):
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.asarray(rv))
    tm.load_state_dict(params_from_jax(_flatten(params)))
    return params


@pytest.mark.parametrize("direct,space,num_targets,B", [
    (False, SPACE2, 1, 5), (True, SPACE2, 1, 5), (True, SPACE4, 1, 5), (True, SPACE4, 3, 3)])
def test_forward_with_carried_params_matches_jax(direct, space, num_targets, B):
    rv = rotation_vectors(B)
    jm = JGRAPE(pulse_space=space, num_pulses=L, direct=direct, num_targets=num_targets)
    tm = GRAPE(pulse_space=space, num_pulses=L, direct=direct, num_targets=num_targets,
               device="cpu")
    params = carried(jm, tm, rv)
    want = np.asarray(jm.apply(params, jnp.asarray(rv)))
    got = tm(torch.from_numpy(rv)).detach().numpy()
    assert got.shape == want.shape == (B, L, len(space))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[..., -1] >= 0).all()
    if not direct:
        # the quirk: atan2 of two positive sigmoids, then the range map
        lo, hi = space[0][1]
        assert ((got[..., 0] >= lo) & (got[..., 0] <= lo + (hi - lo) * np.pi / 2)).all()


def test_direct_mode_needs_the_full_target_batch():
    rv = rotation_vectors(2)
    jm = JGRAPE(pulse_space=SPACE2, num_pulses=L, direct=True, num_targets=3)
    with pytest.raises(ValueError, match="requires the full target batch"):
        jm.init(jax.random.PRNGKey(0), jnp.asarray(rv))
    tm = GRAPE(pulse_space=SPACE2, num_pulses=L, direct=True, num_targets=3, device="cpu")
    with pytest.raises(ValueError, match="requires the full target batch"):
        tm(torch.from_numpy(rv))
    with pytest.raises(ValueError, match="2-parameter"):
        GRAPE(pulse_space=SPACE4, num_pulses=L, device="cpu")


def test_init_like_flax_draws_the_jax_initializers():
    """lecun_normal kernels (std 1/√fan_in, truncated at 2σ) and normal(0.1)
    direct logits, as the JAX module's draws give them."""
    gen = torch.Generator().manual_seed(0)
    tm = GRAPE(pulse_space=SPACE2, num_pulses=400, device="cpu")
    tm.init_like_flax(gen)
    for layer in (tm.fc1, tm.fc2):
        w = layer.weight.detach()
        std = 1.0 / np.sqrt(layer.in_features)
        assert abs(float(w.std()) / std - 1.0) < 0.05
        assert float(w.abs().max()) <= 2.0 * std / 0.87962566103423978 + 1e-6
    jp = JGRAPE(pulse_space=SPACE2, num_pulses=400).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 4)))["params"]
    ratio = float(jnp.std(jp["fc2"]["kernel"])) / float(tm.fc2.weight.detach().std())
    assert abs(ratio - 1.0) < 0.05
    td = GRAPE(pulse_space=SPACE4, num_pulses=400, direct=True, device="cpu")
    td.init_like_flax(gen)
    assert abs(float(td.pulse_logits.detach().std()) - 0.1) < 0.005


@pytest.mark.parametrize("direct,jax_backend", [(False, "pallas"), (True, "xla")])
def test_three_train_steps_match_jax(direct, jax_backend):
    """JAX ``Trainer`` (MLP mode on backend "pallas", interpret mode;
    direct mode on its XLA path, which keeps the file's time down) and the
    port's ``Trainer`` (backend "pallas", the plain versions on CPU
    tensors) from the same parameters, batches and explicit disorder; the
    optimizer is clip-then-Adam in both.  Tolerances as the flagship's
    three-step test."""
    B = 1 if direct else 8
    M = 64
    kw = dict(monte_carlo=M, batch_size=B, learning_rate=1e-3, seed=0)
    jm = JGRAPE(pulse_space=SPACE2, num_pulses=L, direct=direct)
    jtr = JTrainer(jm, JConfig(**kw, backend=jax_backend))
    rng = np.random.default_rng(21)
    batches = []
    for i in range(3):
        rv = rotation_vectors(B, seed=30 + i)
        qt = rotation_vector_to_quat(torch.from_numpy(rv)).numpy()
        batches.append((rv, qt, (0.7 * rng.standard_normal((B, M))).astype(np.float32),
                        (0.05 * rng.standard_normal((B, M))).astype(np.float32)))
    params = jtr.init_params(jnp.asarray(batches[0][0]))
    opt_state = jtr.optimizer.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(jtr._objective, has_aux=True))

    model = GRAPE(pulse_space=SPACE2, num_pulses=L, direct=direct, device="cpu")
    model.load_state_dict(params_from_jax(_flatten(params)))
    p0 = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, TrainConfig(**kw, backend="pallas"), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    near_zero = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in model.named_parameters()}

    for rv, qt, delta, eps in batches:
        with pltpu.force_tpu_interpret_mode():
            (j_loss, j_fid), j_grads = value_and_grad(
                params, jnp.asarray(rv), jnp.asarray(qt),
                (jnp.asarray(delta), jnp.asarray(eps)), None)
        updates, opt_state = jtr.optimizer.update(j_grads, opt_state, params)
        params = optax.apply_updates(params, updates)

        args = (torch.from_numpy(rv), torch.from_numpy(qt),
                (torch.from_numpy(delta), torch.from_numpy(eps)))
        loss, fid = tr.objective(*args)
        grads = torch.autograd.grad(loss, list(model.parameters()))
        step_loss, step_fid = tr.train_step(*args)
        assert float(step_loss) == float(loss.detach())
        np.testing.assert_allclose(float(loss.detach()), float(j_loss), rtol=1e-4)
        np.testing.assert_allclose(float(fid.detach()), float(j_fid), rtol=1e-4)
        jg = params_from_jax(_flatten(j_grads))
        scale = max(float(g.abs().max()) for g in jg.values())
        for n, g in zip(names, grads):
            np.testing.assert_allclose(g.numpy(), jg[n].numpy(), rtol=1e-4,
                                       atol=1e-4 * scale, err_msg=n)
            near_zero[n] |= (g - jg[n]).abs() > 1e-2 * jg[n].abs()

    lr = kw["learning_rate"]
    jp = params_from_jax(_flatten(params))
    n_near_zero = 0
    for n, p in model.named_parameters():
        err = ((p.detach() - p0[n]) - (jp[n] - p0[n])).abs()
        assert bool((err[~near_zero[n]] <= 1e-3 * lr).all()), n
        assert bool((err[near_zero[n]] <= 2 * 3 * lr).all()), n
        n_near_zero += int(near_zero[n].sum())
    assert n_near_zero < 0.01 * sum(p.numel() for p in model.parameters())


def tiny_config(tmp_path):
    path = tmp_path / "grape_tiny.json"
    path.write_text('{"pulse_space": {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]}, '
                    '"num_pulses": 16}')
    return str(path)


def test_cli_runs_on_cpu(tmp_path):
    """MLP mode on the batch_size² grid (batch 4: 4 steps an epoch), three
    bands, a checkpoint and a pulse export per band; then direct mode on
    X(π), whose eval E[F] rises."""
    cfg = tiny_config(tmp_path)
    save = tmp_path / "g"
    hist = cli.main(["--device", "cpu", "--backend", "pallas", "--num_epoch", "2",
                     "--batch_size", "4", "--monte_carlo", "32", "--learning_rate", "3e-3",
                     "--config", cfg, "--save_path", str(save)])
    assert len(hist["bands"]) == 3
    assert all(len(b["eval_fid"]) == 2 for b in hist["bands"])
    exports = sorted(save.glob("*_pulses.npz"))
    assert len(exports) == 3 and (save / "metrics.csv").exists()
    with np.load(exports[0]) as z:
        assert z["pulses"].shape == (16, 16, 2)
    hist = cli.main(["--device", "cpu", "--direct", "--num_epoch", "15",
                     "--monte_carlo", "64", "--learning_rate", "3e-2", "--config", cfg,
                     "--save_path", str(tmp_path / "d")])
    fids = hist["bands"][0]["eval_fid"]
    assert fids[-1] > fids[0]


def test_cli_mesh_and_default_device_raise(tmp_path):
    with pytest.raises(ValueError, match="mesh 2x1 != 1 devices"):
        cli.main(["--device", "cpu", "--mesh", "2,1", "--save_path", str(tmp_path)])
    args = cli.build_parser().parse_args([])
    assert (args.backend, args.device, args.batch_size, args.seed) == ("xla", "cuda", 100, 42)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cli.main(["--num_epoch", "1", "--save_path", str(tmp_path)])
