"""PyTorch port, training half of slice 3: the SU(4) training kernels' plain
versions (B4: the mean fidelity with each sample's product; B5: the
product-seeded VJP), the autograd route of ``mean_fidelity_su4_cuda``, the
training-set builders, three train steps of the whole slice and the
two-qubit training CLI, against the JAX package on the same numpy inputs
(CPU, f32).

No Pallas kernel runs here: the JAX suite's own interpret-mode tests of its
SU(4) VJP kernels take minutes each on a CPU, so the port is held to what
those tests hold the kernels to, the XLA path (``core/su4.py``
``propagate_su4_mc`` + ``fidelity_su4_ri``, and ``jax.grad`` through it),
at their tolerances: products 2e-5 abs and mean fidelities 1e-5 (2e-5 at
drive2) (``tests/test_su4_pallas.py``), gradients 1e-5 abs
(``tests/test_su4_pallas_bwd.py``).  Three train steps: as
``tests/test_torch_train.py::test_three_train_steps_match_jax``.  The
CLI's resumed run is held to 1e-6 relative against the uninterrupted run:
the same arithmetic in the same order.
"""

import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.core import su4 as jsu4
from universal_quantum_optimal_control_tpu.data import su4_targets as jtargets
from universal_quantum_optimal_control_tpu.models import UniversalQOCTransformer as JSingle
from universal_quantum_optimal_control_tpu.models import normalize_pulse_space as jnormalize
from universal_quantum_optimal_control_tpu.models.serialization import _flatten
from universal_quantum_optimal_control_tpu.models.two_qubit import TwoQubitQOCTransformer as JModel
from universal_quantum_optimal_control_tpu.training import TrainConfig as JConfig
from universal_quantum_optimal_control_tpu.training import Trainer as JTrainer
from universal_quantum_optimal_control_tpu.training.systems import SU4System as JSU4System
from universal_quantum_optimal_control_tpu_torch.core import su4 as tsu4
from universal_quantum_optimal_control_tpu_torch.data import su4_targets as ttargets
from universal_quantum_optimal_control_tpu_torch.models import (
    TwoQubitQOCTransformer, normalize_pulse_space, params_from_jax)
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as tk
from universal_quantum_optimal_control_tpu_torch.training import (
    SU4System, TrainConfig, Trainer, list_checkpoints)
from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit as cli

PROD_TOL = 2e-5
FID_TOL = {2: 1e-5, 3: 1e-5, 4: 2e-5}
GRAD_TOL = 1e-5
DRIVE2_SPACE = (("phi1", (-3.15, 3.15)), ("phi2", (-3.15, 3.15)),
                ("omega", (0.05, 1.0)), ("tau", (0.1, 0.5)))


def case(P, B=2, L=3, M=200, seed=0):
    """Pulses (φ, [φ₂,] [Ω,] τ) with some Ω < 0 (the clamp), disorder at
    σ 0.3 / 0.3 / 0.05, random SU(4) targets and a non-uniform per-target
    cotangent, all f32 numpy."""
    rng = np.random.default_rng(seed + 10 * P + L)
    cols = [rng.uniform(-3.1, 3.1, (B, L))]
    if P == 4:
        cols.append(rng.uniform(-3.1, 3.1, (B, L)))
    if P >= 3:
        cols.append(rng.uniform(-0.3, 2.0, (B, L)))
    cols.append(rng.uniform(0.05, 0.6, (B, L)))
    pulses = np.stack(cols, -1).astype(np.float32)
    d1, d2, ep = (s * rng.standard_normal((B, M)).astype(np.float32) for s in (0.3, 0.3, 0.05))
    T = np.linalg.qr(rng.standard_normal((B, 4, 4)) + 1j * rng.standard_normal((B, 4, 4)))[0]
    gbar = rng.uniform(0.1, 2.0, B).astype(np.float32)
    return pulses, d1, d2, ep, T.real.astype(np.float32), T.imag.astype(np.float32), gbar


def t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_b4_plain_matches_jax_xla(P):
    """B4 as its wrapper computes it on CPU tensors: the mean and the
    per-sample product, laid out (B, 32, M) as 16 re then 16 im."""
    pulses, d1, d2, ep, Tr, Ti, _ = case(P, L=7)
    sj, st = jsu4.TwoQubitSystem(drive2=P == 4), tsu4.TwoQubitSystem(drive2=P == 4)
    Urj, Uij = jsu4.propagate_su4_mc(*j(pulses, d1, d2, ep), sj, layout="ri")
    Fj = jnp.mean(jsu4.fidelity_su4_ri(Urj, Uij, *j(Tr[:, None], Ti[:, None])), axis=1)
    F, prod = tk.mean_fidelity_su4_with_product_cuda(*t(pulses, Tr, Ti, d1, d2, ep), st)
    assert F.shape == (2,) and prod.shape == (2, 32, 200) and prod.is_contiguous()
    np.testing.assert_allclose(F.numpy(), np.asarray(Fj), atol=FID_TOL[P], rtol=0)
    Ur = prod[:, :16].transpose(1, 2).reshape(2, 200, 4, 4)
    Ui = prod[:, 16:].transpose(1, 2).reshape(2, 200, 4, 4)
    np.testing.assert_allclose(Ur.numpy(), np.asarray(Urj), atol=PROD_TOL, rtol=0)
    np.testing.assert_allclose(Ui.numpy(), np.asarray(Uij), atol=PROD_TOL, rtol=0)
    # the same means as B6's plain version, and no launch on CPU tensors
    before = tk.mean_fidelity_su4_with_product_cuda.launches
    torch.testing.assert_close(F, tk.mean_fidelity_su4_plain(*t(pulses, Tr, Ti, d1, d2, ep), st),
                               rtol=0, atol=0)
    assert tk.mean_fidelity_su4_with_product_cuda.launches == before


@pytest.mark.parametrize("L", [3, 24])
@pytest.mark.parametrize("P", [2, 3, 4])
def test_b5_plain_and_autograd_route_match_jax_grad(P, L):
    """B5's plain version, and autograd through ``mean_fidelity_su4_cuda``
    (whose backward on CPU tensors is that plain version, seeded by B4's),
    against ``jax.grad`` of Σ_b ḡ_b·E[F]_b through the JAX XLA path."""
    pulses, d1, d2, ep, Tr, Ti, gbar = case(P, L=L)
    sj, st = jsu4.TwoQubitSystem(drive2=P == 4), tsu4.TwoQubitSystem(drive2=P == 4)

    def obj(p, a, b, e):
        Ur, Ui = jsu4.propagate_su4_mc(p, a, b, e, sj, layout="ri")
        F = jnp.mean(jsu4.fidelity_su4_ri(Ur, Ui, *j(Tr[:, None], Ti[:, None])), axis=1)
        return jnp.sum(jnp.asarray(gbar) * F)

    want = jax.grad(obj, argnums=(0, 1, 2, 3))(*j(pulses, d1, d2, ep))
    tens = t(pulses, Tr, Ti, d1, d2, ep)
    _, prod = tk.mean_fidelity_su4_with_product_cuda(*tens, st)
    plain = tk.su4_objective_vjp_from_product_cuda(*tens, *t(gbar), prod, st)
    leaves = [x.clone().requires_grad_(True) for x in t(pulses, d1, d2, ep)]
    F = tk.mean_fidelity_su4_cuda(leaves[0], *t(Tr, Ti), *leaves[1:], st)
    routed = torch.autograd.grad(F, leaves, *t(gbar))
    for name, a, b, w in zip(("pulses", "delta1", "delta2", "eps"), plain, routed, want):
        assert a.shape == w.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0, err_msg=name)
        np.testing.assert_allclose(b.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0, err_msg=name)
    assert float(np.abs(np.asarray(want[0])).max()) > 1e-3  # not vacuous
    with pytest.raises(ValueError, match="prod must be"):
        tk.su4_objective_vjp_from_product_cuda(*tens, *t(gbar), prod[:, :, :9].contiguous(), st)


def test_target_builders_match_jax_bit_for_bit():
    for seed in (0, 5):
        for fn, args in ((ttargets.haar_su2, (7,)),):
            np.testing.assert_array_equal(fn(np.random.default_rng(seed), *args),
                                          jtargets.haar_su2(np.random.default_rng(seed), *args))
        for kw in ({}, {"edge_frac": 0.3}, {"c_max": 0.5, "edge_frac": 1.0}):
            a = ttargets.kak_targets(np.random.default_rng(seed), 10, **kw)
            b = jtargets.kak_targets(np.random.default_rng(seed), 10, **kw)
            assert a.shape == (10, 4, 4) and a.dtype == np.complex128
            np.testing.assert_array_equal(a, b)
        U = ttargets.kak_targets(np.random.default_rng(seed), 6)
        np.testing.assert_array_equal(
            ttargets.random_global_phase(np.random.default_rng(seed + 1), U),
            jtargets.random_global_phase(np.random.default_rng(seed + 1), U))


def test_build_targets_modes_and_seeds():
    system = tsu4.TwoQubitSystem(drive2=True)
    a = cli.build_targets(3, 6, system, mode="mixed", phase_augment=True, edge_frac=0.5)
    assert a.shape == (6, 2, 4, 4) and a.dtype == torch.float32
    assert torch.equal(a, cli.build_targets(3, 6, system, mode="mixed", phase_augment=True,
                                            edge_frac=0.5))
    assert not torch.equal(a, cli.build_targets(4, 6, system, mode="mixed",
                                                phase_augment=True, edge_frac=0.5))
    # unitary to the f32 rounding of 24 segments of 4 squarings each
    U = a[:, 0].double().numpy() + 1j * a[:, 1].double().numpy()
    np.testing.assert_allclose(np.einsum("nji,njk->nik", U.conj(), U),
                               np.broadcast_to(np.eye(4), U.shape), atol=1e-4)
    # the KAK half is the JAX builder's for the same numpy seed
    kak = jtargets.kak_targets(np.random.default_rng(3), 3, edge_frac=0.5)
    b = cli.build_targets(3, 6, system, mode="mixed", edge_frac=0.5)
    np.testing.assert_allclose(b[3:, 0].numpy(), kak.real, atol=1e-7)
    assert cli.build_targets(1, 4, tsu4.TwoQubitSystem(), mode="products").shape == (4, 2, 4, 4)
    with pytest.raises(ValueError, match="unknown target mode"):
        cli.build_targets(1, 4, system, mode="gates")


# ---------------------------------------------------------------------------
# the slice as a whole: three train steps from carried-over parameters
# ---------------------------------------------------------------------------

def _batches(n_steps, B=4, M=32, seed=31):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_steps):
        z = rng.standard_normal((B, 4, 4)) + 1j * rng.standard_normal((B, 4, 4))
        U = np.linalg.qr(z)[0]
        tokens = jtargets.kak_input_tokens(U).astype(np.float32)
        packed = np.stack([U.real, U.imag], axis=1).astype(np.float32)
        d1, d2 = ((0.2 * rng.standard_normal((B, M))).astype(np.float32) for _ in range(2))
        eps = (0.05 * rng.standard_normal((B, M))).astype(np.float32)
        out.append((tokens, packed, d1, d2, eps))
    return out


def test_three_train_steps_match_jax():
    """The JAX ``Trainer`` with ``SU4System("xla")`` and the port's with
    ``SU4System("pallas")`` (B4 forward, B5 backward: their plain versions
    on CPU tensors), a tiny KAK-token drive2 model (d_model 16, 1 layer,
    L = 4), the same parameters, batches and explicit disorder, without
    dropout.  Tolerances as ``tests/test_torch_train.py``: losses and
    gradients 1e-4 (relative; gradients plus 1e-4 of the step's largest
    |g|); parameters after 3 Adam steps 1e-3·lr where every step's
    gradients agree to 1 %, else 2·lr per step on under 1 % of entries."""
    kw = dict(monte_carlo=32, batch_size=4, learning_rate=1e-3, seed=0)
    arch = dict(max_pulses=4, d_model=16, n_layers=1, n_heads=2, kak_tokens=True)
    jm = JModel(pulse_space=jnormalize(DRIVE2_SPACE), dtype=jnp.float32, **arch)
    jtr = JTrainer(jm, JConfig(**kw), system=JSU4System(drive2=True, backend="xla"))
    batches = _batches(3)
    params = jtr.init_params(jnp.asarray(batches[0][0][:2]))
    opt_state = jtr.optimizer.init(params)
    value_and_grad = jax.jit(jax.value_and_grad(jtr._objective, has_aux=True))

    model = TwoQubitQOCTransformer(pulse_space=normalize_pulse_space(DRIVE2_SPACE),
                                   dtype=torch.float32, device="cpu", **arch)
    model.load_state_dict(params_from_jax(_flatten(params)))
    p0 = {k: v.clone() for k, v in model.state_dict().items()}
    tr = Trainer(model, TrainConfig(**kw, backend="pallas"),
                 system=SU4System(drive2=True, backend="pallas"), device="cpu")
    names = [n for n, _ in model.named_parameters()]
    near_zero = {n: torch.zeros_like(p, dtype=torch.bool) for n, p in model.named_parameters()}

    for tokens, packed, d1, d2, eps in batches:
        (j_loss, j_fid), j_grads = value_and_grad(
            params, jnp.asarray(tokens), jnp.asarray(packed), j(d1, d2, eps), None)
        updates, opt_state = jtr.optimizer.update(j_grads, opt_state, params)
        params = jax.tree_util.tree_map(lambda p, u: p + u, params, updates)

        args = (*t(tokens, packed), t(d1, d2, eps))
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


# ---------------------------------------------------------------------------
# the CLI end to end on the CPU
# ---------------------------------------------------------------------------

def _tiny_npzs(tmp_path):
    """A two-qubit artifact of the CLI's tiny drive2 KAK-token model and a
    single-qubit one of the same encoder width, both from JAX inits."""
    two = JModel(pulse_space=jnormalize(DRIVE2_SPACE), max_pulses=4, d_model=16, n_layers=1,
                 n_heads=2, kak_tokens=True, dtype=jnp.float32)
    one = JSingle(num_qubits=1, pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.1, 0.5))),
                  max_pulses=4, d_model=16, n_layers=1, n_heads=2, dropout=0.1,
                  dtype=jnp.float32)
    paths = {}
    for name, model, x in (("two", two, jnp.zeros((1, 9, 8))), ("one", one, jnp.zeros((1, 4)))):
        flat = _flatten(jax.jit(model.init)(jax.random.PRNGKey(9), x))
        paths[name] = tmp_path / f"{name}.npz"
        np.savez(paths[name], **{k: np.asarray(v) for k, v in flat.items()})
    return paths


def _run_cli(save, *extra):
    return cli.main(["--device", "cpu", "--num_epoch", "2", "--save_path", str(save),
                     "--max_pulses", "4", "--d_model", "16", "--n_layers", "1",
                     "--n_heads", "2", "--batch_size", "4", "--monte_carlo", "16",
                     "--train_size", "8", "--eval_size", "4", "--drive2", "--kak_tokens",
                     "--omega_min", "0.05", "--target_mode", "mixed", "--phase_augment",
                     "--curriculum", "0,0.2", "--lr_schedule", "cosine",
                     "--reset_opt_per_band", "--shuffle", "--recover_collapse", "0.05",
                     *extra])


def test_cli_trains_restores_transfers_and_resumes(tmp_path, capsys):
    npz = _tiny_npzs(tmp_path)
    save = tmp_path / "run"
    history = _run_cli(save, "--restore", str(npz["two"]), "--pretrained_single_qubit",
                       str(npz["one"]), "--state_every", "1")
    out = capsys.readouterr().out
    assert f"restored two-qubit params from {npz['two']}" in out
    assert f"transferred encoder from {npz['one']}" in out
    assert "best eval fidelity across bands" in out
    rows = (save / "metrics.csv").read_text().splitlines()
    assert len(rows) == 1 + 2 * 2
    assert list_checkpoints(str(save)) == ["band0_delta0_eps0.05", "band1_delta0.2_eps0.05"]
    with np.load(save / "band1_delta0.2_eps0.05_pulses.npz") as z:
        assert z["pulses"].shape == (8, 4, 4) and np.isfinite(z["pulses"]).all()
        assert (z["pulses"][..., 2] >= 0.05 - 1e-6).all()  # Ω above omega_min
    assert all(0.0 < b["best_fid"] <= 1.0 for b in history["bands"])

    # resume mid-band: keep the state saved after band 1's first epoch
    states = sorted((save / "state").iterdir())
    assert [p.name for p in states] == [f"state_{i:08d}" for i in range(1, 5)]
    shutil.rmtree(states[3])
    resumed = _run_cli(save, "--state_every", "1", "--resume")
    bands = resumed["bands"]
    assert bands[0]["skipped_resume"] and len(bands[1]["eval_fid"]) == 1
    np.testing.assert_allclose(bands[1]["train_loss"], history["bands"][1]["train_loss"][1:],
                               rtol=1e-6)
    np.testing.assert_allclose(bands[1]["eval_fid"], history["bands"][1]["eval_fid"][1:],
                               rtol=1e-6)


def test_cli_restores_port_checkpoints_and_compares_backends(tmp_path):
    """``--restore dir:tag`` of the port's own checkpoint; ``--backend xla``
    (the plain path) trains the same steps as ``pallas`` on the CPU."""
    save = tmp_path / "a"
    _run_cli(save, "--num_epoch", "1", "--curriculum", "0")
    runs = {b: _run_cli(tmp_path / b, "--num_epoch", "1", "--curriculum", "0.2", "--backend", b,
                        "--restore", f"{save}:band0_delta0_eps0.05")
            for b in ("pallas", "xla")}
    np.testing.assert_allclose(runs["pallas"]["bands"][0]["train_loss"],
                               runs["xla"]["bands"][0]["train_loss"], rtol=1e-6)
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        _run_cli(tmp_path / "c", "--restore", f"{save}:band9")
