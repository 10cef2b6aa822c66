"""PyTorch port, two-qubit serving slice: KAK featurization, Makhlin
invariants, the two-qubit transformer, the shipped ``two_qubit_d2_kak``
flagship, best-of-ℤ₄ serving and the named-gate evaluation against the JAX
package (CPU, f32).

Tolerances (abs):
* 1e-9 for the KAK featurization (float64 numpy on both sides, the same
  code) and 1e-6 for the f32 tokens built from it;
* 1e-5 for the Makhlin invariants (f32 products of unit-modulus entries)
  and for the d32 × 2 model's pulses (φ modulo 2π: two encoder blocks of
  f32 matmuls, softmax and LayerNorm summed in another order);
* 1e-3 for the d512 × 8 flagship's pulses (φ₁, φ₂ modulo 2π), as for the
  single-qubit flagship: eight layers of width 512 ending in a 400-wide
  sigmoid head;
* 1e-4 for E[F] on matched inputs: the σ = 0 table (exact, no disorder)
  served end to end from each package's own pulses, and the σ = 0.2
  column on the same pulses and draws (M = 64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.data import su4_targets as jtargets
from universal_quantum_optimal_control_tpu.demo import app as japp
from universal_quantum_optimal_control_tpu.models import normalize_pulse_space as jnormalize
from universal_quantum_optimal_control_tpu.models.serialization import _flatten
from universal_quantum_optimal_control_tpu.models.two_qubit import (
    TwoQubitQOCTransformer as JModel,
    makhlin_invariants_ri as jmakhlin,
)
from universal_quantum_optimal_control_tpu.optimizers.two_qubit_grape import (
    named_two_qubit_targets as jnamed,
)
from universal_quantum_optimal_control_tpu.training.systems import SU4System as JSU4System
from universal_quantum_optimal_control_tpu.workloads import two_qubit_eval as je
from universal_quantum_optimal_control_tpu_torch.data import su4_targets as ttargets
from universal_quantum_optimal_control_tpu_torch.demo import app as tapp
from universal_quantum_optimal_control_tpu_torch.models import (
    TwoQubitQOCTransformer,
    load_params_npz,
    makhlin_invariants_ri,
    normalize_pulse_space,
    params_from_jax,
    unitary_tokens,
)
from universal_quantum_optimal_control_tpu_torch.optimizers import named_two_qubit_targets
from universal_quantum_optimal_control_tpu_torch.training import SU4System
from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit_eval as te

FLAGSHIP = dict(max_pulses=100, drive2=True, kak_tokens=True, omega_min=0.05)


def wrapped_err(a, b, angles=2):
    """Max |a − b| with the first ``angles`` channels compared modulo 2π."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    dphi = np.angle(np.exp(1j * (a[..., :angles] - b[..., :angles])))
    return max(np.abs(dphi).max(), np.abs(a[..., angles:] - b[..., angles:]).max())


def haar_unitaries(n, seed):
    rng = np.random.default_rng(seed)
    z = rng.standard_normal((n, 4, 4)) + 1j * rng.standard_normal((n, 4, 4))
    q, r = np.linalg.qr(z)
    d = np.diagonal(r, axis1=1, axis2=2)
    return q * (d / np.abs(d))[:, None]


def named_gates():
    gates = named_two_qubit_targets()
    return list(gates), np.stack(list(gates.values()))


def test_named_gates_and_variants_match_jax():
    t, j = named_two_qubit_targets(), jnamed()
    assert list(t) == list(j)
    for k in j:
        assert t[k].dtype == j[k].dtype
        np.testing.assert_array_equal(t[k], j[k])
    for name, spec in tapp.TWO_QUBIT_VARIANTS.items():
        assert spec == japp.TWO_QUBIT_VARIANTS[name], name
    assert set(tapp.TWO_QUBIT_VARIANTS) == set(japp.TWO_QUBIT_VARIANTS) == {
        "two_qubit_d2_kak", "two_qubit_d2_kak_s0", "two_qubit_d2_kak_s04", "two_qubit_gates",
        "cz_robust", "cz_drive2"}
    ckpt, kw = tapp.two_qubit_model_kwargs("two_qubit_d2_kak_s0")
    assert ckpt.endswith("two_qubit_d2_kak_s0.npz") and kw["max_pulses"] == 40


def test_su4_targets_match_jax():
    names, U = named_gates()
    targets = np.concatenate([U.astype(np.complex128), haar_unitaries(6, 0),
                              haar_unitaries(3, 1).astype(np.complex64).astype(np.complex128)])
    np.testing.assert_allclose(ttargets.kak_input_tokens(targets),
                               jtargets.kak_input_tokens(targets), atol=1e-6)
    for u in targets:
        np.testing.assert_allclose(ttargets.z4_representatives(u),
                                   jtargets.z4_representatives(u), atol=1e-12)
        tk, jk = ttargets.kak_decompose(u), jtargets.kak_decompose(u)
        for a, b in zip(tk, jk):
            np.testing.assert_allclose(a, b, atol=1e-9)
        # exact up to the ℤ₄ global phase of the SU(4) normalization; an
        # f32-sourced target is unitary to ~4e-8 only, and that lands here
        overlap = abs(np.trace(u.conj().T @ ttargets.kak_reconstruct(*tk))) / 4.0
        defect = np.abs(u.conj().T @ u - np.eye(4)).max()
        assert abs(1.0 - overlap) < 1e-9 + 10 * defect


def test_makhlin_invariants_and_tokens_match_jax():
    names, U = named_gates()
    targets = np.concatenate([U, haar_unitaries(8, 2).astype(np.complex64)])
    packed = np.stack([targets.real, targets.imag], axis=1).astype(np.float32)
    np.testing.assert_allclose(makhlin_invariants_ri(torch.from_numpy(packed)).numpy(),
                               np.asarray(jmakhlin(jnp.asarray(packed))), atol=1e-5)
    from universal_quantum_optimal_control_tpu.models.two_qubit import unitary_tokens as jtok
    np.testing.assert_array_equal(unitary_tokens(torch.from_numpy(packed)).numpy(),
                                  np.asarray(jtok(jnp.asarray(packed))))


SMALL = {
    "rows": dict(pulse_space={"phi": (-3.15, 3.15), "tau": (0.1, 0.5)}),
    "kak_features": dict(pulse_space={"phi": (-3.15, 3.15), "omega": (0.0, 2.0),
                                      "tau": (-0.5, 0.5)}, kak_features=True),
    "kak_tokens": dict(pulse_space={"phi1": (-3.15, 3.15), "phi2": (-3.15, 3.15),
                                    "omega": (0.05, 1.0), "tau": (0.1, 0.5)},
                       kak_tokens=True),
}


@pytest.mark.parametrize("mode", list(SMALL))
def test_small_two_qubit_model_matches_flax(mode):
    spec = dict(SMALL[mode])
    space = spec.pop("pulse_space")
    kw = dict(max_pulses=6, d_model=32, n_layers=2, n_heads=4, dropout=0.1, **spec)
    names, U = named_gates()
    targets = np.concatenate([U, haar_unitaries(5, 3).astype(np.complex64)])
    packed = np.stack([targets.real, targets.imag], axis=1).astype(np.float32)
    inputs = ttargets.kak_input_tokens(targets) if mode == "kak_tokens" else packed
    jm = JModel(pulse_space=jnormalize(space), **kw, dtype=jnp.float32)
    params = jm.init(jax.random.PRNGKey(7), jnp.asarray(inputs[:1]))
    want = np.asarray(jm.apply(params, jnp.asarray(inputs)))
    tm = TwoQubitQOCTransformer(pulse_space=normalize_pulse_space(space), **kw,
                                dtype=torch.float32, device="cpu").eval()
    tm.load_state_dict(params_from_jax(_flatten(params)))
    with torch.no_grad():
        got = tm(torch.from_numpy(inputs)).numpy()
    P = len(space)
    assert got.shape == want.shape == (len(targets), 6, P)
    assert wrapped_err(got, want, angles=2 if P == 4 else 1) <= 1e-5
    assert np.all(got[..., -1] >= 0) and np.all(np.abs(got[..., 0]) <= np.pi)
    if mode == "rows":
        with pytest.raises(ValueError, match="two-qubit"):
            TwoQubitQOCTransformer(num_qubits=1, device="cpu")
    if mode == "kak_tokens":
        with pytest.raises(ValueError, match="kak_input_tokens"):
            tm(torch.from_numpy(packed))


def test_init_like_flax_draws_flax_defaults():
    tm = TwoQubitQOCTransformer(max_pulses=8, d_model=64, n_layers=2, n_heads=4,
                                device="cpu")
    tm.init_like_flax(torch.Generator().manual_seed(0))
    w = tm.encoder[0].dense1.weight.detach()  # fan_in 256
    assert abs(float(w.std()) - 1.0 / 16.0) < 0.002 and float(w.abs().max()) <= 2.0 / 16 / 0.8796 + 1e-6
    assert float(tm.head.bias.abs().max()) == 0.0
    assert float((tm.encoder[1].ln2.weight - 1.0).abs().max()) == 0.0


@pytest.fixture(scope="module")
def flagship():
    """The 5 named gates × 4 ℤ₄ representatives through both flagships."""
    names, U = named_gates()
    reps = np.stack([ttargets.z4_representatives(u) for u in U]).reshape(20, 4, 4)
    packed = SU4System.pack_target(reps)
    jp = np.asarray(je.model_gate_pulses(je.DEFAULT_CKPT, jnp.asarray(packed.numpy()),
                                         **FLAGSHIP))
    tp = te.model_gate_pulses(te.DEFAULT_CKPT, packed, **FLAGSHIP).numpy()
    return U, packed, jp, tp


@pytest.mark.artifacts
def test_flagship_npz_loads_every_key():
    with np.load(te.DEFAULT_CKPT) as raw:
        assert len(raw.files) == 182
    sd = params_from_jax(load_params_npz(te.DEFAULT_CKPT))
    model = TwoQubitQOCTransformer(pulse_space=normalize_pulse_space(
        {"phi1": (-3.15, 3.15), "phi2": (-3.15, 3.15), "omega": (0.05, 1.0),
         "tau": (0.1, 0.5)}), max_pulses=100, d_model=512, n_layers=8, n_heads=16,
        kak_tokens=True, device="cpu")
    result = model.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert len(sd) == len(model.state_dict())


@pytest.mark.artifacts
def test_flagship_pulses_match_jax(flagship):
    _, _, jp, tp = flagship
    assert tp.shape == jp.shape == (20, 100, 4)
    assert wrapped_err(tp, jp) <= 1e-3
    assert np.all(tp[..., 2] >= 0.05 - 1e-6) and np.all(tp[..., 3] >= 0.1 - 1e-6)


@pytest.mark.artifacts
def test_flagship_serves_the_jax_table_at_sigma_zero(flagship):
    """Best-of-ℤ₄ serving and the exact σ = 0 column, each package end to
    end from its own pulses (the port's scoring through B6's plain version)."""
    U, packed, jp, tp = flagship
    jsys, tsys = JSU4System(drive2=True), SU4System(drive2=True, backend="pallas")
    jbest = np.asarray(je.best_phase_pulses(je.DEFAULT_CKPT, U, jsys, **FLAGSHIP))
    tbest = te.best_phase_pulses(te.DEFAULT_CKPT, U, tsys, device="cpu", **FLAGSHIP)
    assert wrapped_err(tbest.numpy(), jbest) <= 1e-3  # the same representatives won
    gates = SU4System.pack_target(U)
    jtab = je.eval_pulse_tables(jnp.asarray(jbest), jnp.asarray(gates.numpy()), [0.0],
                                monte_carlo=8, system=jsys)
    ttab = te.eval_pulse_tables(tbest, gates, [0.0], monte_carlo=8, system=tsys)
    np.testing.assert_allclose(ttab, jtab, atol=1e-4)
    assert ttab.min() > 0.98


@pytest.mark.artifacts
def test_eval_pulse_tables_match_jax_on_matched_draws(flagship):
    U, packed, jp, tp = flagship
    pulses = jp[::4]  # one representative per gate, the same in both
    gates = SU4System.pack_target(U)
    jsys = JSU4System(drive2=True)
    jtab = je.eval_pulse_tables(jnp.asarray(pulses), jnp.asarray(gates.numpy()), [0.0, 0.2],
                                monte_carlo=64, system=jsys)
    base = jsys.sample_errors(jax.random.PRNGKey(7), (5, 64), 1.0, 1.0)
    draws = tuple(torch.from_numpy(np.array(x)) for x in base)
    for backend in ("pallas", "xla"):
        ttab = te.eval_pulse_tables(torch.from_numpy(pulses), gates, [0.0, 0.2],
                                    system=SU4System(drive2=True, backend=backend),
                                    draws=draws)
        assert ttab.shape == (5, 2)
        np.testing.assert_allclose(ttab, jtab, atol=1e-4)


@pytest.mark.artifacts
def test_eval_cli_on_the_cpu(tmp_path):
    out, npz = tmp_path / "gates.md", tmp_path / "pulses.npz"
    argv = ["--device", "cpu", "--sigmas", "0,0.1", "--monte_carlo", "16",
            "--out", str(out), "--save_pulses", str(npz)]
    rows = te.main(argv)
    assert list(rows) == list(named_two_qubit_targets())
    assert all(0.98 < r["model"][0] <= 1.0 and 0.0 < r["model"][1] <= 1.0
               for r in rows.values())
    assert "| cz |" in out.read_text()
    with np.load(npz) as z:
        assert z["pulses_0"].shape == (100, 4)
    # --polish: per-gate blocks GRAPE (tiny), a "(GRAPE)" row per gate
    polished = te.main(argv + ["--polish", "--polish_starts", "2", "--polish_steps", "2"])
    assert all(len(r["grape"]) == 2 and 0.0 < min(r["grape"]) and max(r["grape"]) <= 1.0
               for r in polished.values())
    np.testing.assert_allclose([r["model"] for r in polished.values()],
                               [r["model"] for r in rows.values()], rtol=0, atol=0)
    assert "| cz (GRAPE) |" in out.read_text()
    with pytest.raises(ValueError, match=r"\.npz"):
        te.load_two_qubit_model("weights/dir:tag", device="cpu")


@pytest.mark.artifacts
@pytest.mark.parametrize("variant", ["two_qubit_d2_kak_s0", "two_qubit_d2_kak_s04"])
def test_band_variants_load_and_serve(variant):
    ckpt, kw = tapp.two_qubit_model_kwargs(variant)
    names, U = named_gates()
    pulses = te.best_phase_pulses(ckpt, U[:2], SU4System(drive2=True, backend="pallas"),
                                  device="cpu", **kw)
    assert pulses.shape == (2, kw["max_pulses"], 4)
    assert bool(torch.isfinite(pulses).all())
