"""PyTorch port, slice 3's last part: kernel B8's plain version (the SU(4)
VJP that forms each sample's product itself), the two-qubit multi-start
GRAPE optimizer and its CLI, against the JAX package on the same numpy
inputs (CPU, f32).

No Pallas kernel runs here.  B8's reference is what the JAX suite holds its
SU(4) VJP kernels to, ``jax.vjp`` of the per-target mean of
``fidelity_su4_ri`` over ``propagate_su4_mc`` (the XLA path), with a
non-uniform cotangent, at 1e-5 abs (``tests/test_su4_pallas_bwd.py``);
the JAX package's ``su4_objective_vjp_pallas`` itself is not run in
interpret mode, whose CPU compile alone outlasts the suite.  GRAPE: the
JAX package differentiates its XLA path, so the reference steps are built
here from its ``_to_pulses``, ``su4.propagate_su4`` /
``propagate_su4_mc``, ``fidelity_su4_ri`` and ``optax.adam``; raw
parameters within 2e-5 relative after three steps (optax forms Adam's bias
correction in f32, torch in f64: ``tests/test_torch_train.py``), mean
fidelities within 1e-5.  Pulse maps: 1e-6 abs.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from universal_quantum_optimal_control_tpu.core import su4 as jsu4
from universal_quantum_optimal_control_tpu.optimizers import two_qubit_grape as jg
from universal_quantum_optimal_control_tpu_torch.core import su4 as tsu4
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as tk
from universal_quantum_optimal_control_tpu_torch.optimizers import two_qubit_grape as tg
from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit_grape as cli

GRAD_TOL = 1e-5


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
    return pulses, T.real.astype(np.float32), T.imag.astype(np.float32), d1, d2, ep, gbar


def t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_b8_plain_matches_jax_vjp(P):
    """B8's plain version and its wrapper's CPU route against ``jax.vjp``
    of the per-target mean fidelity through the XLA path under ``gbar``;
    the wrapper equals the plain version, which equals B5's plain version,
    and launches nothing on CPU tensors."""
    pulses, tr, ti, d1, d2, ep, gbar = case(P)
    sj, st = jsu4.TwoQubitSystem(drive2=P == 4), tsu4.TwoQubitSystem(drive2=P == 4)

    def mean_fid(p, a, b, e):
        Ur, Ui = jsu4.propagate_su4_mc(p, a, b, e, sj, layout="ri")
        return jnp.mean(jsu4.fidelity_su4_ri(Ur, Ui, jnp.asarray(tr)[:, None],
                                             jnp.asarray(ti)[:, None]), axis=1)

    _, vjp = jax.vjp(mean_fid, *(jnp.asarray(x) for x in (pulses, d1, d2, ep)))
    want = vjp(jnp.asarray(gbar))
    tens = t(pulses, tr, ti, d1, d2, ep, gbar)
    before = tk.su4_objective_vjp_cuda.launches
    got = tk.su4_objective_vjp_cuda(*tens, st)
    assert tk.su4_objective_vjp_cuda.launches == before
    plain = tk.su4_objective_vjp_plain(*tens, st)
    _, prod = tk.mean_fidelity_su4_with_product_cuda(*tens[:6], st)
    b5 = tk.su4_objective_vjp_from_product_plain(*tens, prod, st)
    assert got[0].shape == (2, 3, P) and all(g.shape == (2, 200) for g in got[1:])
    for name, a, p5, b, w in zip(("pulses", "delta1", "delta2", "eps"), got, b5, plain, want):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)
        torch.testing.assert_close(p5, b, rtol=0, atol=0, msg=name)
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_TOL, rtol=0,
                                   err_msg=name)
    assert float(got[0].abs().max()) > 1e-3  # not vacuous


def test_b8_wrapper_checks_inputs_on_either_route():
    pulses, tr, ti, d1, d2, ep, gbar = t(*case(4))
    st = tsu4.TwoQubitSystem(drive2=True)
    with pytest.raises(ValueError, match="gbar must be"):
        tk.su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar[:1], st)
    with pytest.raises(TypeError, match="float32"):
        tk.su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar.double(), st)
    with pytest.raises(NotImplementedError, match="order-8"):
        tk.su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar, st._replace(expm_order=6))


@pytest.mark.parametrize("mode", ["blocks", "table"])
@pytest.mark.parametrize("drive2", [False, True])
def test_to_pulses_matches_jax(mode, drive2):
    cfg_j = jg.TwoQubitGrapeConfig(mode=mode, drive2=drive2, n_blocks=5, num_pulses=7,
                                   n_starts=3)
    cfg_t = tg.TwoQubitGrapeConfig(mode=mode, drive2=drive2, n_blocks=5, num_pulses=7,
                                   n_starts=3)
    n = 5 if mode == "blocks" else 7
    raw = np.random.default_rng(3).standard_normal((3, n, 4 if drive2 else 3)) \
        .astype(np.float32) * 2
    want = np.asarray(jg._to_pulses(jnp.asarray(raw), cfg_j))
    got = tg._to_pulses(torch.from_numpy(raw), cfg_t).numpy()
    assert got.shape == want.shape == (3, 2 * n if mode == "blocks" else n, 4 if drive2 else 3)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("drive2", [False, True])
def test_init_raw_shape_and_scale(drive2):
    cfg = tg.TwoQubitGrapeConfig(n_blocks=50, n_starts=400, drive2=drive2)
    raw = tg._init_raw(cfg, torch.Generator().manual_seed(0))
    nchan = 4 if drive2 else 3
    assert raw.shape == (400, 50, nchan) and raw.dtype == torch.float32
    want = [1.0] * (nchan - 2) + [0.5, 0.5]
    std = raw.reshape(-1, nchan).std(0).numpy()
    np.testing.assert_allclose(std, want, rtol=0.03)
    assert float(raw.mean().abs()) < 0.02
    table = tg._init_raw(tg.TwoQubitGrapeConfig(mode="table", num_pulses=9, n_starts=2),
                         torch.Generator().manual_seed(0))
    assert table.shape == (2, 9, 3)


def _jax_reference(raw0, cfg, target, draws, sigma):
    """Three exact steps, then three MC steps at ``sigma`` on ``draws``
    (each (n₁, n₂, n_ε) standard normals), built from the JAX package's
    pieces; fresh Adam moments for the MC stage, as per stage there."""
    system = jsu4.TwoQubitSystem(xtalk=cfg.xtalk, coupling=cfg.coupling, drive2=cfg.drive2)
    TR, TI = (jnp.asarray(x) for x in target)
    S = raw0.shape[0]

    def exact(raw):
        z = jnp.zeros((S,), jnp.float32)
        Ur, Ui = jsu4.propagate_su4(jg._to_pulses(raw, cfg), z, z, z, system)
        return jnp.mean(jsu4.fidelity_su4_ri(Ur, Ui, TR, TI))

    def mc(raw, n1, n2, ne):
        Ur, Ui = jsu4.propagate_su4_mc(jg._to_pulses(raw, cfg), n1 * sigma, n2 * sigma,
                                       ne * cfg.epsilon_std, system)
        return jnp.mean(jsu4.fidelity_su4_ri(Ur, Ui, TR[None, None], TI[None, None]))

    opt = optax.adam(cfg.learning_rate)
    raw, fs = jnp.asarray(raw0), []
    for fn, args in ((exact, [()] * 3), (mc, [tuple(jnp.asarray(x) for x in d) for d in draws])):
        state = opt.init(raw)
        value_and_grad = jax.jit(jax.value_and_grad(fn))
        for a in args:
            f, g = value_and_grad(raw, *a)
            upd, state = opt.update(jax.tree_util.tree_map(lambda x: -x, g), state)
            raw = optax.apply_updates(raw, upd)
            fs.append(float(f))
    return np.asarray(raw), fs


@pytest.mark.parametrize("drive2", [False, True])
def test_grape_steps_match_jax(drive2):
    kw = dict(n_blocks=3, n_starts=3, drive2=drive2, monte_carlo=16, learning_rate=0.05)
    cfg_j, cfg_t = jg.TwoQubitGrapeConfig(**kw), tg.TwoQubitGrapeConfig(**kw)
    rng = np.random.default_rng(5)
    raw0 = rng.standard_normal((3, 3, 4 if drive2 else 3)).astype(np.float32)
    U = jg.named_two_qubit_targets()["cz"]
    target = (U.real.astype(np.float32), U.imag.astype(np.float32))
    draws = [tuple(rng.standard_normal((3, 16)).astype(np.float32) for _ in range(3))
             for _ in range(3)]
    want_raw, want_f = _jax_reference(raw0, cfg_j, target, draws, 0.1)

    raw = torch.from_numpy(raw0.copy()).requires_grad_(True)
    tt = t(*target)
    got_f = []
    opt = tg._adam(raw, cfg_t)
    for _ in range(3):
        got_f.append(tg.step_exact(raw, opt, cfg_t, tt))
    opt = tg._adam(raw, cfg_t)  # fresh moments per stage
    for d in draws:
        got_f.append(tg.step_mc(raw, opt, cfg_t, tt, t(*d), 0.1))
    np.testing.assert_allclose(got_f, want_f, atol=1e-5, rtol=0)
    np.testing.assert_allclose(raw.detach().numpy(), want_raw, rtol=2e-5,
                               atol=2e-5 * np.abs(want_raw).max())
    assert np.abs(want_raw - raw0).max() > 0.05  # the steps moved it


def test_multistart_grape_runs_every_stage():
    cfg = tg.TwoQubitGrapeConfig(n_blocks=2, n_starts=2, steps=2, sigmas=(0.1, 0.2),
                                 monte_carlo=8, drive2=True)
    pulses, info = tg.multistart_grape_su4(tg.named_two_qubit_targets()["cz"], cfg,
                                           device="cpu")
    assert pulses.shape == (4, 4) and np.isfinite(pulses).all()
    assert [s["sigma"] for s in info["stages"]] == [None, 0.1, 0.2]
    assert all(0.0 < s["best_fid"] <= 1.0 + 1e-6 and s["best_start"] in (0, 1)
               for s in info["stages"])
    assert 0.0 < info["exact_fid_of_best"] <= 1.0 + 1e-6
    # the same seed gives the same run
    again, info2 = tg.multistart_grape_su4(tg.named_two_qubit_targets()["cz"], cfg,
                                           device="cpu")
    np.testing.assert_array_equal(pulses, again)
    assert info2 == info


def test_robustness_curve_routes_agree():
    pulses = case(4, B=1, L=5)[0][0]
    U = jg.named_two_qubit_targets()["cz"]
    system = tsu4.TwoQubitSystem(drive2=True)
    before = tk.propagate_su4_mc_cuda.launches
    rows = cli.robustness_curve(pulses, U, [0.0, 0.1], 64, system, device="cpu")
    plain = cli.robustness_curve(pulses, U, [0.0, 0.1], 64, system, backend="xla",
                                 device="cpu")
    assert tk.propagate_su4_mc_cuda.launches == before
    assert [r[0] for r in rows] == [0.0, 0.1]
    np.testing.assert_allclose(np.asarray(rows), np.asarray(plain), atol=1e-7, rtol=0)
    assert all(0.0 < m <= 1.0 and se >= 0.0 for _, m, se in rows)


def test_grape_cli_on_the_cpu(tmp_path):
    out = cli.main(["--device", "cpu", "--gate", "cz", "--drive2", "--n_blocks", "2",
                    "--n_starts", "2", "--steps", "3", "--sigmas", "0.1",
                    "--monte_carlo", "8", "--curve_mc", "16", "--curve_sigmas", "0.05,0.1",
                    "--out", str(tmp_path)])
    with np.load(tmp_path / "pulses.npz") as z:
        assert z["pulses"].shape == (4, 4)
        np.testing.assert_array_equal(z["u_target"], jg.named_two_qubit_targets()["cz"])
    lines = (tmp_path / "robustness.csv").read_text().splitlines()
    assert lines[0] == "sigma_delta,EF,SE" and len(lines) == 3
    result = json.loads((tmp_path / "result.json").read_text())
    assert result["config"]["gate"] == "cz" and len(result["info"]["stages"]) == 2
    assert len(out["curve"]) == 2
    with pytest.raises(ValueError, match="unknown gate"):
        cli.main(["--device", "cpu", "--gate", "foo", "--out", str(tmp_path)])


def test_grape_cli_flags_match_jax():
    from universal_quantum_optimal_control_tpu.workloads import two_qubit_grape as jcli

    want = {a.dest: a.default for a in jcli.build_parser()._actions}
    got = {a.dest: a.default for a in cli.build_parser()._actions}
    assert set(got) - set(want) == {"device"}
    assert {k: got[k] for k in want} == want
