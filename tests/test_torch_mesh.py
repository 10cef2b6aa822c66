"""PyTorch port, the ``(data, mc)`` mesh (``parallel/mesh.py``,
``parallel/mc_parallel.py::make_mean_fidelity``, the sharded objectives of
``training/systems.py``, the sharded trainer and the training CLI's
``--mesh``) on the CPU.

Each mesh case runs 4 gloo ranks as a 2 × 2 mesh, started by
``tests/torch_mesh_worker.py`` as separate processes that meet at a file
store under the test's temporary directory (no TCP port, so parallel test
workers cannot collide), each spawn with its own timeout.  The inputs are
drawn with numpy; the weights are a JAX initialization carried through
``params_from_jax``.

Tolerances: the port's sharded objectives against the JAX package's on its
virtual 8-device CPU mesh (``make_mesh(4, data=2, mc=2)``): values 1e-5,
gradients 1e-4 relative plus 1e-4 of the largest entry (the two
frameworks' f32 sums in different orders); the port sharded against the
port unsharded: 2e-6, the same arithmetic but for the order of the means.
Trainer steps: losses and E[F] 1e-5 relative, gradients 1e-5 of the
largest entry (the ranks sum the parameters' gradients of their blocks,
each target's Monte-Carlo halves in another order than one process);
parameters after the steps 1e-3·lr absolute where the two runs' gradients
agree to 1 % at every step, else the 2·lr a step that an Adam update can
move when its gradient is rounding noise (the attention's key bias, to
which softmax is blind, has a gradient of 0 up to rounding); the ranks'
parameters bit-identical.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.models import UniversalQOCTransformer as JModel
from universal_quantum_optimal_control_tpu.models.serialization import _flatten
from universal_quantum_optimal_control_tpu.parallel import make_mean_fidelity as j_mean_fidelity
from universal_quantum_optimal_control_tpu.parallel import make_mesh as j_make_mesh
from universal_quantum_optimal_control_tpu.training.systems import SU2System as JSystem
from universal_quantum_optimal_control_tpu.training.systems import make_objective as j_objective
from universal_quantum_optimal_control_tpu.training.systems import (
    make_per_target_objective as j_per_target)
from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
from universal_quantum_optimal_control_tpu_torch.models import params_from_jax
from universal_quantum_optimal_control_tpu_torch.parallel import (DATA_AXIS, MC_AXIS, Mesh,
                                                                  make_mean_fidelity, make_mesh,
                                                                  mesh_shape, replicated,
                                                                  shard_spec)
from universal_quantum_optimal_control_tpu_torch.training import (SU2System, make_objective,
                                                                  make_per_target_objective)
from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit as cli

sys.path.insert(0, str(Path(__file__).parent))
import torch_mesh_worker as worker  # noqa: E402

B, L, M = 8, 6, 64
NAMES = ("mean_fidelity", "objective", "per_target")


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    pulses = np.stack([rng.uniform(-3.0, 3.0, (B, L)), rng.uniform(0.1, 0.5, (B, L))], -1)
    qt = rng.standard_normal((B, 4))
    qt /= np.linalg.norm(qt, axis=1, keepdims=True)
    arrays = dict(pulses=pulses, q_t=qt, delta=rng.standard_normal((B, M)),
                  eps=0.05 * rng.standard_normal((B, M)), w=rng.uniform(0.0, 1.0, B))
    return {k: torch.from_numpy(v.astype(np.float32)) for k, v in arrays.items()}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def sharded(inputs, tmp_path_factory):
    return worker.spawn("objectives", 4, 2, 2, tmp_path_factory.mktemp("objectives"), inputs)


def _port_unsharded(name, backend, inp):
    p = inp["pulses"].clone().requires_grad_(True)
    args = (inp["q_t"], inp["delta"], inp["eps"])
    if name == "mean_fidelity":
        v = make_mean_fidelity(None, backend)(p, *args)
        v.backward()
    elif name == "objective":
        v = make_objective(None, SU2System(backend).local_mean_fidelity)(p, args[0], args[1:])
        v.backward()
    else:
        v = make_per_target_objective(None, SU2System(backend).local_mean_fidelity)(
            p, args[0], args[1:])
        torch.sum(inp["w"] * v).backward()
    return v.detach(), p.grad


def _jax(name, backend, inp):
    """The JAX package on make_mesh(4, data=2, mc=2); the port's "pallas"
    (B1's plain version on the CPU) against JAX's "xla"."""
    mesh = j_make_mesh(4, data=2, mc=2)
    jb = "xla" if backend == "pallas" else backend
    pulses, qt, d, e, w = (jnp.asarray(inp[k].numpy()) for k in ("pulses", "q_t", "delta",
                                                                 "eps", "w"))
    if name == "mean_fidelity":
        fn = jax.jit(j_mean_fidelity(mesh, jb))
        value = fn(pulses, qt, d, e)
        grad = jax.grad(lambda p: fn(p, qt, d, e))(pulses)
    elif name == "objective":
        fn = jax.jit(j_objective(mesh, JSystem(jb).local_mean_fidelity))
        value = fn(pulses, qt, (d, e))
        grad = jax.grad(lambda p: fn(p, qt, (d, e)))(pulses)
    else:
        fn = jax.jit(j_per_target(mesh, JSystem(jb).local_mean_fidelity))
        value = fn(pulses, qt, (d, e))
        grad = jax.grad(lambda p: jnp.sum(w * fn(p, qt, (d, e))))(pulses)
    return np.asarray(value), np.asarray(grad)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,data,mc", [(1, None, None), (2, None, None), (4, None, None),
                                       (8, None, None), (8, 4, None), (8, None, 8)])
def test_factorization_matches_jax(n, data, mc):
    j = j_make_mesh(n, data=data, mc=mc)
    assert mesh_shape(n, data, mc) == (j.shape["data"], j.shape["mc"])


def test_mismatched_mesh_raises_as_jax():
    with pytest.raises(ValueError, match="mesh 3x5 != 8 devices"):
        j_make_mesh(data=3, mc=5)
    with pytest.raises(ValueError, match=r"mesh 3x5 != 1 devices"):
        make_mesh(data=3, mc=5)
    with pytest.raises(ValueError, match=r"mesh 3x5 != 1 devices"):
        cli.main(["--device", "cpu", "--mesh", "3,5"])


def test_backend_follows_the_requested_device(monkeypatch):
    """gloo for ranks on the CPU whatever cards the host has; NCCL only
    where each rank of the host has a card of its own."""
    from universal_quantum_optimal_control_tpu_torch.parallel import mesh as mesh_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert mesh_mod.default_backend("cpu") == "gloo"
    assert mesh_mod.default_backend(torch.device("cpu")) == "gloo"
    assert mesh_mod.default_backend("cuda") == "nccl"
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "8")
    assert mesh_mod.default_backend("cuda") == "gloo"


def test_mesh_flag_passes_the_device_to_the_group(monkeypatch):
    """``--device cpu --mesh 2,2`` joins the group with the CPU's backend."""
    from universal_quantum_optimal_control_tpu_torch.parallel import mesh as mesh_mod

    seen = []
    monkeypatch.setattr(mesh_mod, "init_distributed", lambda **kw: seen.append(kw))
    with pytest.raises(ValueError, match=r"mesh 2x2 != 1 devices"):
        mesh_mod.mesh_from_flag("2,2", "cpu")
    assert seen == [{"device": "cpu"}]


def test_trivial_mesh_and_shard_specs():
    """Without a process group the mesh is 1 × 1 and its collectives are
    the identity; a spec cuts a rank's block by its coordinates."""
    mesh = make_mesh()
    assert (mesh.shape, mesh.size, mesh.rank) == ({"data": 1, "mc": 1}, 1, 0)
    x = torch.arange(24.0).reshape(4, 6).requires_grad_(True)
    assert mesh.all_mean(x) is x and mesh.gather(x) is x
    assert torch.equal(shard_spec(mesh, DATA_AXIS, MC_AXIS)(x), x)
    assert replicated(mesh)(x) is x
    cell = Mesh(2, 3)  # rank 0's view of a 2 × 3 mesh, no collectives
    assert torch.equal(shard_spec(cell, DATA_AXIS, MC_AXIS)(x), x[:2, :2])
    assert torch.equal(shard_spec(cell, None, MC_AXIS)(x), x[:, :2])
    with pytest.raises(ValueError, match="does not shard evenly"):
        shard_spec(cell, MC_AXIS)(x)
    with pytest.raises(ValueError, match="unknown mesh axis"):
        shard_spec(cell, "model")


def test_gradient_factors():
    """The batch mean averages data·mc equal blocks; a target's mean
    averages its mc blocks."""
    mesh = Mesh(2, 2)
    local = SU2System("xla").local_mean_fidelity
    assert make_objective(mesh, local).grad_scale == 0.25
    assert make_mean_fidelity(mesh).grad_scale == 0.25
    assert make_per_target_objective(mesh, local).grad_scale == 0.5
    assert make_objective(None, local).grad_scale == 1.0
    assert make_per_target_objective(None, local).grad_scale == 1.0


def test_trainer_refuses_uneven_shards():
    """B must divide by data and M by mc, as JAX refuses uneven shards."""
    from universal_quantum_optimal_control_tpu_torch.models import UniversalQOCTransformer
    from universal_quantum_optimal_control_tpu_torch.training import TrainConfig, Trainer

    model = UniversalQOCTransformer(**worker.TINY, device="cpu")
    with pytest.raises(ValueError, match="does not shard evenly over 'mc'"):
        Trainer(model, TrainConfig(monte_carlo=63), mesh=Mesh(2, 2), device="cpu")
    tr = Trainer(model, TrainConfig(monte_carlo=64, batch_size=3), mesh=Mesh(2, 2),
                 device="cpu")
    rv = torch.zeros((3, 4))
    with pytest.raises(ValueError, match="does not shard evenly over 'data'"):
        tr.train(rv, torch.zeros((3, 4)), rv, torch.zeros((3, 4)), epochs=1)


# ---------------------------------------------------------------------------
# the sharded objectives, 2 × 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", worker.BACKENDS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_objective_matches_jax_mesh(sharded, inputs, name, backend):
    jv, jg = _jax(name, backend, inputs)
    for rank, res in enumerate(sharded):
        v, g = res[(name, backend)]
        np.testing.assert_allclose(v.numpy(), jv, rtol=1e-5, atol=1e-5, err_msg=str(rank))
        np.testing.assert_allclose(g.numpy(), jg, rtol=1e-4, atol=1e-4 * np.abs(jg).max(),
                                   err_msg=str(rank))


@pytest.mark.parametrize("backend", worker.BACKENDS)
@pytest.mark.parametrize("name", NAMES)
def test_sharded_objective_matches_unsharded(sharded, inputs, name, backend):
    v0, g0 = _port_unsharded(name, backend, inputs)
    for rank, res in enumerate(sharded):
        v, g = res[(name, backend)]
        np.testing.assert_allclose(v.numpy(), v0.numpy(), rtol=0, atol=2e-6, err_msg=str(rank))
        np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=0, atol=2e-6, err_msg=str(rank))


def test_sharded_values_are_the_same_on_every_rank(sharded):
    for key in (k for k in sharded[0] if isinstance(k, tuple)):
        assert all(torch.equal(r[key][0], sharded[0][key][0]) for r in sharded[1:]), key


def test_sharded_disorder_gradient_matches_jax(sharded, inputs):
    fn = jax.jit(j_mean_fidelity(j_make_mesh(4, data=2, mc=2), "xla"))
    p, qt, d, e = (jnp.asarray(inputs[k].numpy()) for k in ("pulses", "q_t", "delta", "eps"))
    jg = np.asarray(jax.grad(lambda x: fn(p, qt, x, e))(d))
    for res in sharded:
        np.testing.assert_allclose(res["delta_grad"].numpy(), jg, rtol=1e-4,
                                   atol=1e-4 * np.abs(jg).max())


# ---------------------------------------------------------------------------
# the sharded trainer, 2 × 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trainer_inputs():
    rng = np.random.default_rng(21)
    axes = rng.standard_normal((B, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rv = np.concatenate([axes, rng.uniform(0, 2 * np.pi, (B, 1))], 1).astype(np.float32)
    params = jax.jit(JModel(**{**worker.TINY, "dtype": jnp.float32}).init)(
        jax.random.PRNGKey(3), jnp.zeros((1, 4)))
    return {"rv": torch.from_numpy(rv), "qt": rotation_vector_to_quat(torch.from_numpy(rv)),
            "delta": torch.from_numpy((0.7 * rng.standard_normal((B, M))).astype(np.float32)),
            "eps": torch.from_numpy((0.05 * rng.standard_normal((B, M))).astype(np.float32)),
            "params": params_from_jax(_flatten(params))}


@pytest.fixture(scope="module")
def trainer_runs(trainer_inputs, tmp_path_factory):
    return (worker.task_trainer(None, trainer_inputs),
            worker.spawn("trainer", 4, 2, 2, tmp_path_factory.mktemp("trainer"),
                         trainer_inputs))


LR = 1e-3  # the tiny trainer's learning rate


def _steps_close(got, want):
    """Parameters after Adam steps: 1e-3·lr where the gradients agreed to 1 %
    at every step, else 2·lr a step (an update flipped by rounding noise)."""
    noisy = torch.zeros_like(want["grads"][0], dtype=torch.bool)
    for g, g0 in zip(got["grads"], want["grads"]):
        noisy |= (g - g0).abs() > 1e-2 * g0.abs()
    assert int(noisy.sum()) < 0.01 * noisy.numel()
    offset = 0
    for k, v in want["params"].items():
        err = (got["params"][k] - v).abs().flatten()
        mask = noisy[offset:offset + err.numel()]
        assert bool((err[~mask] <= 1e-3 * LR).all()), k
        assert bool((err[mask] <= 2 * LR * len(want["grads"])).all()), k
        offset += err.numel()


@pytest.mark.parametrize("case", ["plain", "cvar"])
def test_sharded_trainer_step_equals_unsharded(trainer_runs, case):
    """Dropout off, the same global batches and disorder: the sharded
    gradients (the parameters' gradients of the ranks' blocks summed over
    the ranks, times 1/(data·mc) for the batch mean, 1/mc for the CVaR
    loss) are the unsharded ones, so the losses and the parameters after
    two steps are too."""
    one, ranks = trainer_runs
    for res in ranks:
        np.testing.assert_allclose(res[case]["losses"], one[case]["losses"], rtol=1e-5)
        for g, g0 in zip(res[case]["grads"], one[case]["grads"]):
            np.testing.assert_allclose(g.numpy(), g0.numpy(), rtol=0,
                                       atol=1e-5 * float(g0.abs().max()))
        _steps_close(res[case], one[case])


def test_sharded_trainer_with_dropout_keeps_the_unsharded_draws(trainer_runs):
    """Dropout on, the trainer's own disorder: each rank draws the whole
    batch's disorder and masks and keeps its block (the model runs on the
    rank's rows), so the losses are the unsharded run's, and the ranks'
    parameters stay bit-identical."""
    one, ranks = trainer_runs
    for res in ranks:
        np.testing.assert_allclose(res["dropout"]["losses"], one["dropout"]["losses"],
                                   rtol=1e-5)
        _steps_close(res["dropout"], one["dropout"])
        for k, v in ranks[0]["dropout"]["params"].items():
            assert torch.equal(res["dropout"]["params"][k], v), k


@pytest.mark.parametrize("case", ["plain", "cvar", "dropout"])
def test_sharded_trainer_steps_eagerly(trainer_runs, case):
    """A mesh's step is never a CUDA graph (gloo's all-reduce cannot be
    captured), nor is a step on the CPU: both counters stay 0 and Adam is
    not capturable, on every rank and in the one-process run."""
    one, ranks = trainer_runs
    for res in [one, *ranks]:
        assert res[case]["graphs"] == (0, 0, [False])


# ---------------------------------------------------------------------------
# the training CLI's --mesh, 2 × 2 gloo ranks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    config = tmp / "tiny.json"
    config.write_text('{"num_qubits": 1, "pulse_space": {"phi": [-3.15, 3.15], "tau": '
                      '[0.1, 0.5]}, "max_pulses": 8, "d_model": 32, "n_layers": 2, '
                      '"n_heads": 4, "dropout": 0.1, "finetune": null}')
    argv = ["--device", "cpu", "--num_epoch", "1", "--batch_size", "8", "--monte_carlo",
            str(M), "--train_size", "16", "--eval_size", "8", "--config", str(config)]
    tr, history = cli.run(cli.build_parser().parse_args(argv + ["--save_path",
                                                                str(tmp / "one")]))
    ranks = worker.spawn("cli", 4, 2, 2, tmp, {"argv": argv + ["--mesh", "2,2", "--save_path",
                                                               str(tmp / "mesh")]})
    return history, tr.model.state_dict(), ranks, tmp


def test_cli_mesh_matches_the_one_process_run(cli_runs):
    history, _, ranks, _ = cli_runs
    for res in ranks:
        for a, b in zip(res["history"]["bands"], history["bands"]):
            for key in ("step_loss", "step_fid", "train_loss", "eval_fid"):
                assert len(a[key]) == len(b[key]) > 0
                np.testing.assert_allclose(a[key], b[key], rtol=1e-5, err_msg=key)


def test_cli_mesh_ranks_stay_bit_identical(cli_runs):
    _, params, ranks, _ = cli_runs
    assert set(ranks[0]["params"]) == set(params)
    for res in ranks:
        for k, v in ranks[0]["params"].items():
            assert torch.equal(res["params"][k], v), k


def test_cli_mesh_only_rank_0_writes(cli_runs):
    _, _, ranks, tmp = cli_runs
    assert len(ranks[0]["writes"]) == 3
    assert all(res["writes"] == [] for res in ranks[1:])
    assert (tmp / "mesh" / "metrics.csv").read_text().count("\n") == 1 + 3
    assert sorted(p.name for p in (tmp / "mesh").glob("*_pulses.npz")) == sorted(
        p.name for p in (tmp / "one").glob("*_pulses.npz"))
