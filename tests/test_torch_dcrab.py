"""PyTorch port, slice 2: dCRAB (``optimizers/dcrab.py``,
``workloads/dcrab_single_qubit.py``) against the JAX package (CPU, f32,
N = 12 modes, T/dt = 60 steps, 3 rounds, 16 disorder samples).

* ``build_phi``, ``propagate_phase_control`` and ``average_infidelity``
  within 1e-5 of the JAX functions on the same inputs, the gradient of
  the infidelity within 1e-4 relative (to its largest entry);
* 5 Adam steps of :func:`run_adam` against ``optax.adam`` through
  ``jax.grad`` on the same problem: parameters 2e-5 relative plus 1e-3 of
  the step size (Adam moves an entry by about lr·g/|g|, so a gradient
  entry 10× below the largest, held to 1e-4 of the largest, may move
  1e-3·lr apart; as the flagship's three-step test);
* ``_nelder_mead_batched`` from the same ``x0`` on the same objective:
  the best f-values within 1e-5 after 30 iterations;
* the front door's dispatch, SciPy's per-round branch, and the CLI.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from universal_quantum_optimal_control_tpu.optimizers import dcrab as jd
from universal_quantum_optimal_control_tpu_torch.optimizers import dcrab as td
from universal_quantum_optimal_control_tpu_torch.workloads import dcrab_single_qubit as cli

N, T, DT, R, S = 12, 60, 0.05, 3, 16


def problem(seed=0):
    """A problem as numpy arrays: the reference's shapes, X(π/2) target."""
    rng = np.random.default_rng(seed)
    t = (np.arange(T) * DT).astype(np.float32)
    delta = (0.4 * rng.standard_normal(S)).astype(np.float32)
    eps = (0.05 * rng.standard_normal(S)).astype(np.float32)
    omegas = rng.uniform(0.1, 10.0, (R, N)).astype(np.float32)
    x0 = np.zeros((R, 1 + 2 * N), np.float32)
    x0[:, 1:] = 0.3 * rng.standard_normal((R, 2 * N))
    q = np.asarray([np.cos(np.pi / 4), np.sin(np.pi / 4), 0.0, 0.0], np.float32)
    return t, delta, eps, omegas, x0, q


def as_torch(arrays):
    return td.DcrabProblem(*(torch.from_numpy(a) for a in arrays))


def test_build_phi_and_propagation_match_jax():
    t, delta, eps, omegas, x0, _ = problem()
    phi = td.build_phi(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(omegas))
    jphi = jd.build_phi(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(omegas))
    assert phi.shape == (R, T)
    np.testing.assert_allclose(phi.numpy(), np.asarray(jphi), atol=1e-5, rtol=0)
    q = td.propagate_phase_control(phi, DT, torch.from_numpy(delta), torch.from_numpy(eps))
    jq = jd.propagate_phase_control(jphi, DT, jnp.asarray(delta), jnp.asarray(eps))
    assert q.shape == (R, S, 4)
    np.testing.assert_allclose(q.numpy(), np.asarray(jq), atol=1e-5, rtol=0)
    np.testing.assert_allclose(q.norm(dim=-1).numpy(), 1.0, atol=1e-5)


def test_average_infidelity_and_gradient_match_jax():
    t, delta, eps, omegas, x0, q = problem(1)
    jargs = [jnp.asarray(a) for a in (t, omegas, q, delta, eps)]

    def jloss(p):
        return jnp.sum(jd.average_infidelity(p, *jargs, DT))

    jval = jd.average_infidelity(jnp.asarray(x0), *jargs, DT)
    jgrad = np.asarray(jax.grad(jloss)(jnp.asarray(x0)))
    p = torch.from_numpy(x0).requires_grad_(True)
    val = td.average_infidelity(p, *(torch.from_numpy(a) for a in (t, omegas, q, delta, eps)),
                                DT)
    (grad,) = torch.autograd.grad(val.sum(), p)
    np.testing.assert_allclose(val.detach().numpy(), np.asarray(jval), atol=1e-5, rtol=0)
    assert (val.detach().numpy() >= 1.0 / 3.0 - 1e-6).all()   # fidelity ≤ 2/3
    scale = float(np.abs(jgrad).max())
    np.testing.assert_allclose(grad.numpy(), jgrad, rtol=1e-4, atol=1e-4 * scale)


def test_five_adam_steps_match_optax():
    arrays = problem(2)
    t, delta, eps, omegas, x0, q = arrays
    lr = 0.02
    jargs = [jnp.asarray(a) for a in (t, omegas, q, delta, eps)]
    opt = optax.adam(lr)
    params = jnp.asarray(x0)
    state = opt.init(params)
    grad = jax.jit(jax.value_and_grad(lambda p: jnp.sum(jd.average_infidelity(p, *jargs, DT))))
    jlosses = []
    for _ in range(5):
        loss, g = grad(params)
        updates, state = opt.update(g, state)
        params = optax.apply_updates(params, updates)
        jlosses.append(float(loss))
    got, infid, losses = td.run_adam(as_torch(arrays), DT, 5, lr)
    np.testing.assert_allclose(losses, jlosses, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(params), rtol=2e-5, atol=1e-3 * lr)
    np.testing.assert_allclose(
        infid.numpy(), np.asarray(jd.average_infidelity(params, *jargs, DT)), atol=1e-5)


def test_batched_nelder_mead_matches_jax():
    t, delta, eps, omegas, x0, q = problem(3)
    x0 = x0[:, :9]                                  # N = 4 modes
    omegas = omegas[:, :4]
    jargs = [jnp.asarray(a) for a in (t, q, delta, eps)]
    targs = [torch.from_numpy(a) for a in (t, q, delta, eps)]

    def jobj(flat):
        p = flat.reshape(R, flat.shape[0] // R, -1)
        return jd.average_infidelity(p, jargs[0], jnp.asarray(omegas)[:, None, :], jargs[1],
                                     jargs[2], jargs[3], DT).reshape(-1)

    def tobj(flat):
        p = flat.reshape(R, flat.shape[0] // R, -1)
        return td.average_infidelity(p, targs[0], torch.from_numpy(omegas)[:, None, :],
                                     targs[1], targs[2], targs[3], DT).reshape(-1)

    jx, jf = jax.jit(lambda x: jd._nelder_mead_batched(jobj, x, 30))(jnp.asarray(x0))
    x, f = td._nelder_mead_batched(tobj, torch.from_numpy(x0), 30)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=0)
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), atol=1e-4, rtol=0)
    assert (f.numpy() < tobj(torch.from_numpy(x0)).numpy()).all()


def test_nelder_mead_on_a_quadratic_stops_at_fatol():
    def f(x):
        return ((x - 1.0) ** 2).sum(-1)

    x, fx = td._nelder_mead_batched(f, torch.zeros((2, 3)), maxiter=2000)
    assert (fx < 1e-7).all()
    np.testing.assert_allclose(x.numpy(), 1.0, atol=1e-3)


def test_front_door_dispatch():
    kw = dict(T=1.0, dt=0.05, n_modes=3, rounds=2, samples=8, device="cpu")
    (params, omegas), fid = td.dcrab_optimize(np.asarray([0.0, 1.0, 0.0, 0.0]), mode="grad",
                                              steps=5, **kw)
    assert params.shape == (7,) and omegas.shape == (3,) and 0.0 < fid <= 2 / 3
    (params, omegas), fid_nm = td.dcrab_optimize(np.asarray([0.0, 1.0, 0.0, 0.0]), mode="nm",
                                                 maxiter=10, **kw)
    assert params.shape == (7,) and 0.0 < fid_nm <= 2 / 3
    (_, _), fid_sp = td.optimize_dcrab_nm(np.eye(2, dtype=np.complex64), td.DcrabConfig(
        T=1.0, dt=0.05, n_modes=2, rounds=2, samples=8), maxiter=20, device="cpu",
        use_scipy=True)
    assert 0.0 < fid_sp <= 2 / 3
    with pytest.raises(ValueError, match="unknown mode"):
        td.dcrab_optimize(np.asarray([1.0, 0.0, 0.0, 0.0]), mode="bfgs", device="cpu")
    assert (td.DELTA_STD, td.EPSILON_STD) == (jd.DELTA_STD, jd.EPSILON_STD) == (0.4, 0.05)


def test_setup_draws_one_problem_on_any_device():
    cfg = td.DcrabConfig(T=1.0, dt=0.05, n_modes=3, rounds=2, samples=8, w_min=0.1,
                         w_max=5.0)
    a = td._setup(np.asarray([1.0, 0.0, 0.0, 0.0]), cfg, device="cpu")
    b = td._setup(np.asarray([1.0, 0.0, 0.0, 0.0]), cfg, device="cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert a.t.shape == (20,) and a.x0.shape == (2, 7) and (a.x0[:, 0] == 0).all()
    assert ((a.omegas >= 0.1) & (a.omegas <= 5.0)).all()


def test_cli_runs_on_cpu(tmp_path):
    out = tmp_path / "dcrab.npz"
    res = cli.main(["--device", "cpu", "--mode", "grad", "--n_modes", "4", "--T", "2",
                    "--dt", "0.05", "--rounds", "2", "--samples", "16", "--steps", "20",
                    "--out", str(out)])
    assert res["losses"][-1] < res["losses"][0] and 0.0 < res["fidelity"] <= 2 / 3
    with np.load(out) as z:
        assert z["params"].shape == (9,) and z["omegas"].shape == (4,)
    res = cli.main(["--device", "cpu", "--mode", "nm", "--n_modes", "2", "--T", "1",
                    "--dt", "0.05", "--rounds", "2", "--samples", "8", "--maxiter", "20",
                    "--out", str(out)])
    assert 0.0 < res["fidelity"] <= 2 / 3
    args = cli.build_parser().parse_args([])
    assert (args.n_modes, args.T, args.dt, args.samples, args.rounds, args.seed,
            args.device) == (2000, 6.0, 0.01, 200, 5, 42, "cuda")


def test_default_entry_points_run_on_cuda_and_raise_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["--steps", "1", "--out", str(tmp_path / "d.npz")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        td.dcrab_optimize(np.asarray([1.0, 0.0, 0.0, 0.0]), mode="nm", maxiter=1)
