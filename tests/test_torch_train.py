"""PyTorch port, training half of slice 1: one train step of the whole
slice against the JAX package's trainer on the same numpy inputs, dropout,
and the training CLI end to end (CPU, f32, small size: d_model 32, 2
layers, 4 heads, max_pulses 8).  The pieces below the trainer are in
``test_torch_objectives.py``.

Tolerances: 1e-4 for the losses and gradients of the whole slice
(relative, or absolute against the step's gradient scale): the two
frameworks' f32 transformers, and the Pallas kernels' polynomial sin/cos
against libm; parameters after 3 steps: see
``test_three_train_steps_match_jax``.  The CLI's resumed and unfused runs
are held to 1e-6 relative against the uninterrupted fused run: the same
arithmetic in the same order.
"""

import json
import math
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from universal_quantum_optimal_control_tpu.models import UniversalQOCTransformer as JModel
from universal_quantum_optimal_control_tpu.models.serialization import _flatten
from universal_quantum_optimal_control_tpu.training import TrainConfig as JConfig
from universal_quantum_optimal_control_tpu.training import Trainer as JTrainer
from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
from universal_quantum_optimal_control_tpu_torch.data import su2_targets as tdata
from universal_quantum_optimal_control_tpu_torch.models import (
    UniversalQOCTransformer, params_from_jax)
from universal_quantum_optimal_control_tpu_torch.training import (
    CurriculumBand, TrainConfig, Trainer, list_checkpoints)
from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit as cli

TINY = dict(num_qubits=1, pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.1, 0.5))),
            max_pulses=8, d_model=32, n_layers=2, n_heads=4, dropout=0.1)
TINY_JSON = {"num_qubits": 1, "pulse_space": {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]},
             "max_pulses": 8, "d_model": 32, "n_layers": 2, "n_heads": 4,
             "dropout": 0.1, "finetune": None}


# ---------------------------------------------------------------------------
# the slice as a whole: three train steps from carried-over parameters
# ---------------------------------------------------------------------------

def _batches(n_steps, B=8, M=64, seed=21):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        axes = rng.standard_normal((B, 3))
        axes /= np.linalg.norm(axes, axis=1, keepdims=True)
        rv = np.concatenate([axes, rng.uniform(0, 2 * np.pi, (B, 1))], 1).astype(np.float32)
        qt = rotation_vector_to_quat(torch.from_numpy(rv)).numpy()
        delta = (0.7 * rng.standard_normal((B, M))).astype(np.float32)
        eps = (0.05 * rng.standard_normal((B, M))).astype(np.float32)
        out.append((rv, qt, delta, eps))
    return out


@pytest.mark.parametrize("tail_focus,jax_backend", [(0.0, "pallas"), (0.25, "xla")])
def test_three_train_steps_match_jax(tail_focus, jax_backend):
    """JAX ``Trainer`` (backend "pallas": the Pallas kernels in interpret
    mode; the CVaR case, whose point is the top-k loss, against JAX's
    "xla" path) and the port's ``Trainer`` (backend "pallas", the plain
    versions on CPU tensors) from the same parameters, batches and explicit
    disorder, without dropout (JAX's ``_objective(..., dropout_key=None)``).

    Losses agree to 1e-4 relative and gradients to 1e-4 relative plus 1e-4
    of the step's largest |g|.  Parameters after 3 Adam steps: Adam's
    update is about lr·g/|g| entry by entry, so an entry whose gradient is
    near 0 (inside the absolute part of that tolerance) may step another
    way.  Entries whose gradients agree to 1 % relative at every step are
    held to 1e-3·lr; the others to the 2·lr per step that a flipped update
    can cost, and they must be under 1 % of all entries."""
    kw = dict(monte_carlo=64, batch_size=8, learning_rate=1e-3, seed=0,
              tail_focus=tail_focus, tail_weight=0.5)
    jm = JModel(**TINY, dtype=jnp.float32)
    jtr = JTrainer(jm, JConfig(**kw, backend=jax_backend))
    batches = _batches(3)
    params = jtr.init_params(jnp.asarray(batches[0][0][:2]))
    opt_state = jtr.optimizer.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(jtr._objective, has_aux=True))

    model = UniversalQOCTransformer(**TINY, dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_jax(_flatten(params)))
    p0 = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, TrainConfig(**kw, backend="pallas"), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    near_zero = {n: torch.zeros_like(p, dtype=torch.bool)
                 for n, p in model.named_parameters()}

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
        assert float(step_fid) == float(fid.detach())
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


def test_dropout_comes_from_the_trainer_generator():
    """Train mode draws its masks from the generator passed to forward:
    the same seed gives the same pulses, another seed other pulses, and
    eval mode is deterministic.  Attention masks are shared over batch and
    heads (Flax's broadcast_dropout)."""
    model = UniversalQOCTransformer(**{**TINY, "dropout": 0.5}, dtype=torch.float32,
                                    device="cpu")
    model.init_like_flax(torch.Generator().manual_seed(0))
    rv = torch.from_numpy(_batches(1)[0][0])
    model.train()
    a = model(rv, generator=torch.Generator().manual_seed(1))
    b = model(rv, generator=torch.Generator().manual_seed(1))
    c = model(rv, generator=torch.Generator().manual_seed(2))
    assert torch.equal(a, b) and not torch.equal(a, c)
    model.eval()
    assert torch.equal(model(rv), model(rv, generator=torch.Generator().manual_seed(3)))


# ---------------------------------------------------------------------------
# the CLI end to end on the CPU
# ---------------------------------------------------------------------------

def _run_cli(tmp_path, save, *extra):
    cfg = tmp_path / "tiny.json"
    cfg.write_text(json.dumps(TINY_JSON))
    return cli.main(["--device", "cpu", "--num_epoch", "2", "--save_path", str(save),
                     "--batch_size", "8", "--monte_carlo", "32", "--train_size", "36",
                     "--eval_size", "8", "--config", str(cfg), *extra])


def test_cli_trains_exports_and_resumes(tmp_path, capsys):
    save = tmp_path / "run"
    history = _run_cli(tmp_path, save, "--state_every", "1")
    assert "best eval fidelity across bands" in capsys.readouterr().out
    rows = (save / "metrics.csv").read_text().splitlines()
    assert rows[0].split(",") == ["t_wall", "band", "delta_std", "epsilon_std", "epoch",
                                  "train_loss", "eval_fid", "best_fid",
                                  "throughput_props_s"]
    assert len(rows) == 1 + 3 * 2
    tags = list_checkpoints(str(save))
    assert tags == ["band0_delta0.4_eps0.05", "band1_delta0.7_eps0.05",
                    "band2_delta1_eps0.05"]
    for tag in tags:
        with np.load(save / f"{tag}_pulses.npz") as z:
            assert z["pulses"].shape == (32, 8, 2) and np.isfinite(z["pulses"]).all()
    best = [b["best_fid"] for b in history["bands"]]
    assert all(0.0 < f <= 1.0 for f in best)
    assert all(math.isfinite(x) for b in history["bands"] for x in b["train_loss"])

    # resume mid-band: keep the state saved after band 1's first epoch
    states = sorted((save / "state").iterdir())
    assert [p.name for p in states] == [f"state_{i:08d}" for i in range(1, 7)]
    for p in states[3:]:
        shutil.rmtree(p)
    resumed = _run_cli(tmp_path, save, "--state_every", "1", "--resume")
    bands = resumed["bands"]
    assert bands[0]["skipped_resume"] and len(bands[1]["eval_fid"]) == 1
    # the continuation is the uninterrupted run's, step for step
    np.testing.assert_allclose(bands[1]["train_loss"], history["bands"][1]["train_loss"][1:],
                               rtol=1e-6)
    np.testing.assert_allclose(bands[2]["train_loss"], history["bands"][2]["train_loss"],
                               rtol=1e-6)
    np.testing.assert_allclose(bands[2]["eval_fid"], history["bands"][2]["eval_fid"],
                               rtol=1e-6)


def test_cli_pretrained_encoder_and_mesh(tmp_path, capsys):
    src = jax.jit(JModel(**TINY, dtype=jnp.float32).init)(jax.random.PRNGKey(4),
                                                          jnp.zeros((1, 4)))
    npz = tmp_path / "src.npz"
    np.savez(npz, **{k: np.asarray(v) for k, v in _flatten(src).items()})
    _run_cli(tmp_path, tmp_path / "warm", "--pretrained_encoder", str(npz), "--num_epoch", "1")
    assert f"transferred encoder from {npz}" in capsys.readouterr().out
    with pytest.raises(NotImplementedError, match="A.17"):
        _run_cli(tmp_path, tmp_path / "mesh", "--mesh", "2,4")


def test_cli_options_run_and_unfused_epochs_match_fused(tmp_path):
    """The unfused epoch (one host read per step) computes what the fused
    one does; shuffle, per-band optimizer reset, collapse recovery, the
    cosine schedule and a finetune base pulse run end to end."""
    fused = _run_cli(tmp_path, tmp_path / "fused")
    unfused = _run_cli(tmp_path, tmp_path / "unfused", "--no-fused_epoch")
    for a, b in zip(fused["bands"], unfused["bands"]):
        np.testing.assert_allclose(a["train_loss"], b["train_loss"], rtol=1e-6)
        np.testing.assert_allclose(a["eval_fid"], b["eval_fid"], rtol=1e-6)
    base = tmp_path / "base.csv"
    np.savetxt(base, np.tile([[0.0, 0.3]], (8, 1)), delimiter=",", header="phi,tau")
    history = _run_cli(tmp_path, tmp_path / "options", "--shuffle", "--reset_opt_per_band",
                       "--recover_collapse", "1e-6", "--lr_schedule", "cosine",
                       "--finetune_base", str(base))
    assert all(0.0 < b["best_fid"] <= 1.0 for b in history["bands"])
    assert all("recoveries" in b for b in history["bands"])


def test_trainer_profiles_and_evaluates(tmp_path):
    model = UniversalQOCTransformer(**TINY, dtype=torch.float32, device="cpu")
    cfg = TrainConfig(monte_carlo=16, batch_size=4, epochs=1, profile_dir=str(tmp_path / "prof"),
                      profile_steps=1, debug_nans=True)
    tr = Trainer(model, cfg, device="cpu")
    rv, qt = tdata.build_su2_dataset(torch.Generator().manual_seed(0), 16, device="cpu")
    params, history = tr.train(rv, qt, rv[:4], qt[:4], curriculum=[CurriculumBand(0.4)])
    assert (tmp_path / "prof" / "trace.json").exists()
    f = tr.evaluate(params, rv[:4], qt[:4], 0.4, 0.05)
    assert f == tr.evaluate(None, rv[:4], qt[:4], 0.4, 0.05) and 0.0 < f <= 1.0
