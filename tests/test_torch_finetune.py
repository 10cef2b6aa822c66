"""PyTorch port, slice 2: the per-gate polish (``workloads/finetune_gates.py``)
and the P = 4 ceiling (``analysis/p4_grape_ceiling.py``) against the JAX
package (CPU, f32, small tables).

* ``_logits_from_pulses`` and ``clamp_tau_nonnegative`` as the JAX ones;
* 5 polish steps on injected draws (``polish_step``, kernel B1's plain
  version on CPU tensors) against ``jax.value_and_grad`` through the JAX
  ``mean_fidelity_local(backend="pallas")`` (interpret mode) and
  ``optax.adam(3e-3)``: E[F] 1e-5, logits 2e-5 relative (optax forms
  Adam's bias correction in f32, ROADMAP §C) plus 2e-5 of the step size;
* the best-logged iterate kept as the JAX loop keeps it;
* ``evaluate_tables`` on equal draws within 1e-5 of the JAX objective;
* the CLI: ``--pulse_params 3/4`` widening reproduces the P = 2 start
  within 1e-4, and its bundle reads back;
* ``load_gate_bundle`` on both shipped bundles, as the JAX loader;
* a tiny ceiling run.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from universal_quantum_optimal_control_tpu.analysis import p4_grape_ceiling as jceil
from universal_quantum_optimal_control_tpu.demo import app as japp
from universal_quantum_optimal_control_tpu.parallel.mc_parallel import \
    mean_fidelity_local as jmean_fid
from universal_quantum_optimal_control_tpu.workloads import finetune_gates as jft
from universal_quantum_optimal_control_tpu_torch.analysis import p4_grape_ceiling as tceil
from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
from universal_quantum_optimal_control_tpu_torch.models import normalize_pulse_space
from universal_quantum_optimal_control_tpu_torch.workloads import finetune_gates as tft

SPACE = (("phi", (-3.15, 3.15)), ("tau", (-0.5, 0.5)))
SPACE4 = tuple(normalize_pulse_space(tceil.P4_SPACE))


def tables(G=3, L=8, P=2, seed=0):
    rng = np.random.default_rng(seed)
    space = SPACE if P == 2 else SPACE4
    lo = np.asarray([a for _, (a, _) in space], np.float32)
    hi = np.asarray([b for _, (_, b) in space], np.float32)
    pulses = (lo + (hi - lo) * rng.uniform(0.1, 0.9, (G, L, P))).astype(np.float32)
    axes = rng.standard_normal((G, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    rv = np.concatenate([axes, rng.uniform(0, 2 * np.pi, (G, 1))], 1).astype(np.float32)
    q = rotation_vector_to_quat(torch.from_numpy(rv)).numpy()
    return pulses, q, lo, hi


def draws(G, M, n, seed=1):
    rng = np.random.default_rng(seed)
    return [((1.0 * rng.standard_normal((G, M))).astype(np.float32),
             (0.05 * rng.standard_normal((G, M))).astype(np.float32)) for _ in range(n)]


def test_logits_and_tau_clamp_match_jax():
    pulses, _, lo, hi = tables()
    pulses[0, 0] = lo            # clipped a hair inside the open interval
    pulses[1, 0] = hi
    got = tft._logits_from_pulses(torch.from_numpy(pulses), torch.from_numpy(lo),
                                  torch.from_numpy(hi)).numpy()
    want = np.asarray(jft._logits_from_pulses(jnp.asarray(pulses), jnp.asarray(lo),
                                              jnp.asarray(hi)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    for space in (SPACE, SPACE4, (("phi", (-3.15, 3.15)), ("t", (-0.2, 0.5)))):
        assert tft.clamp_tau_nonnegative(space) == jft.clamp_tau_nonnegative(space)
    assert tft.clamp_tau_nonnegative(SPACE)[1] == ("tau", (0.0, 0.5))


@pytest.mark.parametrize("P", [2, 4])
def test_five_polish_steps_match_jax(P):
    G, L, M, lr = 3, 8, 64, 3e-3
    pulses, q, lo, hi = tables(G, L, P)
    space = tft.clamp_tau_nonnegative(SPACE if P == 2 else SPACE4)
    lo_t, hi_t = tft._box(space, "cpu")
    steps = draws(G, M, 5)

    jlo, jhi = jnp.asarray(lo_t.numpy()), jnp.asarray(hi_t.numpy())
    jq = jnp.asarray(q)
    jlogits = jft._logits_from_pulses(jnp.asarray(pulses), jlo, jhi)
    opt = optax.adam(lr)
    opt_state = opt.init(jlogits)

    def loss_fn(lg, d, e):
        f = jmean_fid(jlo + (jhi - jlo) * jax.nn.sigmoid(lg), jq, d, e, "pallas")
        return -jnp.mean(f), f

    value_and_grad = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))

    logits = tft._logits_from_pulses(torch.from_numpy(pulses), lo_t, hi_t)
    logits = logits.detach().requires_grad_(True)
    topt = torch.optim.Adam([logits], lr=lr, betas=(0.9, 0.999), eps=1e-8)
    qt = torch.from_numpy(q)
    for d, e in steps:
        with pltpu.force_tpu_interpret_mode():
            (_, jf), g = value_and_grad(jlogits, jnp.asarray(d), jnp.asarray(e))
        updates, opt_state = opt.update(g, opt_state)
        jlogits = optax.apply_updates(jlogits, updates)
        f = tft.polish_step(logits, topt, lo_t, hi_t, qt, torch.from_numpy(d),
                            torch.from_numpy(e), backend="pallas")
        np.testing.assert_allclose(f.numpy(), np.asarray(jf), atol=1e-5, rtol=0)
        want = np.asarray(jlogits)
        np.testing.assert_allclose(logits.detach().numpy(), want, rtol=2e-5, atol=2e-5 * lr)


def test_finetune_keeps_the_best_logged_iterate():
    """The kept table is the iterate after the logged step whose E[F] was
    best (JAX ``finetune_pulse_tables``), on injected draws."""
    G, L, M = 2, 6, 32
    pulses, q, _, _ = tables(G, L)
    space = tft.clamp_tau_nonnegative(SPACE)
    steps = draws(G, M, 6, seed=5)
    dr = [(torch.from_numpy(d), torch.from_numpy(e)) for d, e in steps]
    got, hist = tft.finetune_pulse_tables(torch.from_numpy(pulses), torch.from_numpy(q),
                                          space, steps=6, learning_rate=0.05, log_every=2,
                                          draws=dr, backend="xla")
    assert [s for s, _ in hist] == [1, 2, 4, 6]
    # replay: the iterates after each step
    lo, hi = tft._box(space, "cpu")
    logits = tft._logits_from_pulses(torch.from_numpy(pulses), lo, hi)
    logits = logits.detach().requires_grad_(True)
    opt = torch.optim.Adam([logits], lr=0.05)
    after, fs = [], []
    for d, e in dr:
        fs.append(float(tft.polish_step(logits, opt, lo, hi, torch.from_numpy(q), d, e,
                                        "xla").mean()))
        after.append(logits.detach().clone())
    logged = [0, 1, 3, 5]
    best = max(logged, key=lambda i: (fs[i], -i))
    np.testing.assert_allclose([f for _, f in hist], [fs[i] for i in logged], rtol=1e-6)
    want = lo + (hi - lo) * torch.sigmoid(after[best])
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=1e-7)


def test_evaluate_tables_matches_jax_on_equal_draws():
    pulses, q, _, _ = tables(G=4, L=10)
    d, e = draws(4, 2048, 1, seed=9)[0]
    got = tft.evaluate_tables(torch.from_numpy(pulses), torch.from_numpy(q),
                              draws=(torch.from_numpy(d), torch.from_numpy(e)))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jmean_fid(jnp.asarray(pulses), jnp.asarray(q), jnp.asarray(d),
                                    jnp.asarray(e), "pallas"))
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # its own draws: common across the gates, seeded
    a = tft.evaluate_tables(torch.from_numpy(pulses), torch.from_numpy(q), monte_carlo=512)
    b = tft.evaluate_tables(torch.from_numpy(pulses), torch.from_numpy(q), monte_carlo=512)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["length100_gates.npz", "length100_gates_p4.npz"])
def test_load_gate_bundle_matches_jax(name):
    path = japp._WEIGHTS_DIR / name
    tables_t, meta_t = tft.load_gate_bundle(str(path))
    tables_j, meta_j = jft.load_gate_bundle(str(path))
    assert meta_t == meta_j
    assert list(tables_t) == meta_t["gates"] == ["X", "X(pi/2)", "Y", "Z(pi/4)", "H"]
    for g in meta_t["gates"]:
        assert tables_t[g].dtype == np.float32
        np.testing.assert_array_equal(tables_t[g], tables_j[g])
    assert len(meta_t["fidelity_finetuned"]) == 5


@pytest.mark.artifacts
@pytest.mark.parametrize("P", [3, 4])
def test_cli_widening_reproduces_the_p2_start(P, tmp_path):
    """``--pulse_params 3/4`` starts at Ω = 1 (0.9999 through the clip),
    Δ = 0: the widened start's E[F] is the P = 2 model's within 1e-4 on the
    same eval draws.  Two polish steps run on the widened table, and the
    bundle reads back with P columns."""
    out = tmp_path / "bundle.npz"
    res = tft.main(["--device", "cpu", "--gates", "X,H", "--steps", "2",
                    "--monte_carlo", "64", "--eval_mc", "4000", "--pulse_params", str(P),
                    "--out", str(out)])
    np.testing.assert_allclose(res["f_start"], res["f_model"], atol=1e-4)
    tables_, meta = tft.load_gate_bundle(str(out))
    assert meta["gates"] == ["X", "H"] and meta["source_variant"] == "length_100"
    assert tables_["X"].shape == (100, P)
    np.testing.assert_allclose(meta["fidelity_finetuned"], res["f_finetuned"])


def test_cli_default_out_is_not_the_shipped_bundle():
    args = tft.build_parser().parse_args([])
    assert args.out == "weights/length100_gates.npz"
    assert (args.steps, args.monte_carlo, args.learning_rate, args.eval_mc, args.device) == \
        (1500, 8192, 3e-3, 200_000, "cuda")


def test_tiny_ceiling_run():
    """Random P = 4 tables in the (φ, Ω, Δ, τ) box, two bands, the best of 2
    starts per gate scored at σ_δ = 1."""
    assert SPACE4 == tuple(normalize_pulse_space(jceil.P4_SPACE))
    assert [k for k, _ in SPACE4] == ["phi", "Omega", "Delta", "tau"]
    rows, best = tceil.measure_ceiling(starts=2, num_pulses=6, monte_carlo=32, eval_mc=500,
                                       curriculum=((0.4, 3), (1.0, 3)), gates=["X", "H"],
                                       device="cpu")
    assert [r[0] for r in rows] == ["X", "H"]
    for g, ceiling, mean, j in rows:
        assert 0.0 < mean <= ceiling <= 1.0 and j in (0, 1)
        lo = np.asarray([a for _, (a, _) in SPACE4])
        hi = np.asarray([b for _, (_, b) in SPACE4])
        assert best[g].shape == (6, 4)
        assert ((best[g] >= lo) & (best[g] <= hi)).all()


def test_default_entry_points_run_on_cuda_and_raise_without_it(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tft.main(["--gates", "X", "--steps", "1", "--out", str(tmp_path / "b.npz")])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tceil.measure_ceiling(starts=1, num_pulses=2, gates=["X"], curriculum=((0.4, 1),))
