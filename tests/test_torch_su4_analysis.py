"""PyTorch port, slice 3's last part: the numeric halves of the δ₂
dephasing bound (``analysis/dephasing_bound.py``) and of the products/KAK
split eval (``analysis/two_qubit_split_eval.py``), against the JAX package
on the same numpy inputs (CPU, f32).

Tolerances: the closed forms to f64 rounding (the same numpy code); E[F]
on matched draws within 1e-5 (f32 means of the same products, summed in
another order), on either backend (B6's plain version on CPU tensors, or
the plain path).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.analysis import dephasing_bound as jdb
from universal_quantum_optimal_control_tpu.training.systems import SU4System as JSU4System
from universal_quantum_optimal_control_tpu_torch.analysis import dephasing_bound as tdb
from universal_quantum_optimal_control_tpu_torch.analysis import two_qubit_split_eval as tsplit
from universal_quantum_optimal_control_tpu_torch.demo import app as tapp
from universal_quantum_optimal_control_tpu_torch.training import SU4System
from universal_quantum_optimal_control_tpu_torch.workloads import two_qubit as ttrain

FLAGSHIP = dict(max_pulses=100, drive2=True, kak_tokens=True, omega_min=0.05)
CKPT = tapp.TWO_QUBIT_VARIANTS["two_qubit_d2_kak"]["checkpoint"]


def test_dephasing_closed_forms_match_jax():
    T = np.array([0.5, 7.0, 20.0, 40.0])
    for chi, ob in ((0.1, 1.0), (0.1, 0.6), (1.1, 1.0)):
        np.testing.assert_allclose(tdb.effective_time(T, chi, ob), jdb.effective_time(T, chi, ob),
                                   rtol=1e-15)
    sig = np.array([0.0, 0.05, 0.2, 0.4])
    np.testing.assert_allclose(tdb.dephasing_bound(sig, 6.3), jdb.dephasing_bound(sig, 6.3),
                               rtol=1e-15)
    assert tdb.rotation_budget(7.0, 1.1) == jdb.rotation_budget(7.0, 1.1)
    assert tdb.dephasing_bound(0.0, 5.0) == 1.0


def _jax_normals(seed, B, M):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    return tuple(np.array(jax.random.normal(k, (B, M))) for k in (k1, k2, k3))


def _pulse_npz(variant):
    pulses, u_target, _, _ = tapp.two_qubit_pulse_table(variant)
    return pulses[None], SU4System.pack_target(u_target[None])


def test_measure_and_channels_match_jax_on_matched_draws():
    M, sigmas = 64, [0.05, 0.2]
    p3, t3 = _pulse_npz("cz_robust")
    want = jdb.measure(jnp.asarray(p3), jnp.asarray(t3.numpy()), sigmas, monte_carlo=M)
    draws = tuple(torch.from_numpy(x) for x in _jax_normals(11, 1, M))
    for backend in ("pallas", "xla"):
        got = tdb.measure(torch.from_numpy(p3), t3, sigmas, monte_carlo=M, draws=draws,
                          system=SU4System(backend=backend))
        np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), atol=1e-5)
        np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)
    p4, t4 = _pulse_npz("cz_drive2")
    want = jdb.measure_channels(jnp.asarray(p4), jnp.asarray(t4.numpy()), sigmas,
                                monte_carlo=M)
    got = tdb.measure_channels(torch.from_numpy(p4), t4, sigmas, monte_carlo=M, draws=draws)
    np.testing.assert_allclose(np.asarray(got[0]), np.asarray(want[0]), atol=1e-5)
    np.testing.assert_allclose(got[1:], want[1:], rtol=1e-6)


@pytest.mark.artifacts
def test_dephasing_cli_on_the_cpu(tmp_path):
    out = tmp_path / "bound.md"
    text = tdb.main(["--device", "cpu", "--n_targets", "2", "--monte_carlo", "16",
                     "--sigmas", "0.1", "--out", str(out)])
    assert text.count("### ") == 3 and "vacuous" in text and "| 0.1 |" in text
    assert out.read_text() == text + "\n"


@pytest.mark.artifacts
def test_split_eval_halves_on_explicit_targets(tmp_path):
    system = SU4System(drive2=True, backend="pallas")
    prod = ttrain.build_targets(3, 2, system.system, mode="products")
    kak = ttrain.build_targets(4, 3, system.system, mode="kak")
    targets = torch.cat([prod, kak[:2]])
    out = tsplit.split_eval(CKPT, sigma=0.2, monte_carlo=16, chunk=3, targets=targets,
                            system=system, device="cpu", **FLAGSHIP)
    F = out["per_target"]
    assert F.shape == (4,) and out["pulses"].shape == (4, 100, 4)
    assert out["products"] == pytest.approx(F[:2].mean()) and \
        out["kak"] == pytest.approx(F[2:].mean()) and out["blended"] == pytest.approx(F.mean())
    jsys = JSU4System(drive2=True)
    for i, n in ((0, 3), (3, 1)):  # each chunk takes the same draws
        gen = torch.Generator().manual_seed(42)
        d = [(torch.randn((n, 16), generator=gen) * s).numpy() for s in (0.2, 0.2, 0.05)]
        want = jsys.local_mean_fidelity(jnp.asarray(out["pulses"][i:i + n]),
                                        jnp.asarray(targets.numpy()[i:i + n]),
                                        tuple(jnp.asarray(x) for x in d))
        np.testing.assert_allclose(F[i:i + n], np.asarray(want), atol=1e-5)

    csv, dump = tmp_path / "t.csv", tmp_path / "kak"
    res = tsplit.main([CKPT, "--device", "cpu", "--sigma", "0.1", "--monte_carlo", "8",
                       "--eval_size", "4", "--drive2", "--kak_tokens", "--omega_min", "0.05",
                       "--per_target_csv", str(csv), "--dump_kak_percentiles", "50",
                       "--dump_dir", str(dump), "--channels_worst_decile", "--channels_mc", "8"])
    assert csv.read_text().splitlines()[0] == "index,class,fid" and len(res["per_target"]) == 4
    (dumped,) = dump.glob("kak_p50_i*.npz")
    with np.load(dumped) as z:
        assert z["u_target"].shape == (4, 4) and np.iscomplexobj(z["u_target"])
