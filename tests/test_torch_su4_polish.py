"""PyTorch port, slice 3's last part: the per-gate polish
(``workloads/finetune_two_qubit_gates.py``), the gate bundle and the
two-qubit demo variants' pulse selection and sweep, against the JAX
package on the same numpy inputs (CPU, f32).

Tolerances: the range map's inverse 1e-5 abs on logits (f32 log of a
clipped ratio); three polish steps on injected draws, per-step σ-mixed
E[F] within 1e-5 and the kept pulses within 2e-5 abs (Adam's f32 bias
correction in optax, ``tests/test_torch_train.py``), the ``pallas`` route
(B4/B5's plain versions on CPU tensors) within 1e-6 of ``xla``; the
bundle and the pulse tables exactly; the flagship's fallback pulses 1e-3
(φ modulo 2π), as ``tests/test_torch_two_qubit.py``.
"""

import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from universal_quantum_optimal_control_tpu.analysis import plots_su4 as jplots
from universal_quantum_optimal_control_tpu.demo import app as japp
from universal_quantum_optimal_control_tpu.training.systems import SU4System as JSU4System
from universal_quantum_optimal_control_tpu.workloads import finetune_two_qubit_gates as jft
from universal_quantum_optimal_control_tpu_torch.analysis import plots_su4 as tplots
from universal_quantum_optimal_control_tpu_torch.demo import app as tapp
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as tk
from universal_quantum_optimal_control_tpu_torch.optimizers import named_two_qubit_targets
from universal_quantum_optimal_control_tpu_torch.training import SU4System
from universal_quantum_optimal_control_tpu_torch.workloads import finetune_two_qubit_gates as ft

BUNDLE = tapp.TWO_QUBIT_VARIANTS["two_qubit_gates"]["gate_bundle"]


def box_pulses(G, L, seed):
    """Pulses inside the drive2 box, some within 1e-5 of an edge (the clip)."""
    rng = np.random.default_rng(seed)
    lo = np.array([lo for _, (lo, _) in ft.DRIVE2_SPACE], np.float32)
    hi = np.array([hi for _, (_, hi) in ft.DRIVE2_SPACE], np.float32)
    u = rng.uniform(0.02, 0.98, (G, L, 4))
    u[0, 0] = 1e-6
    return (lo + (hi - lo) * u).astype(np.float32), lo, hi


def test_logits_from_pulses_inverts_the_range_map():
    pulses, lo, hi = box_pulses(3, 6, 0)
    want = np.asarray(jft._logits_from_pulses(jnp.asarray(pulses), jnp.asarray(lo),
                                              jnp.asarray(hi)))
    got = ft._logits_from_pulses(*(torch.from_numpy(x) for x in (pulses, lo, hi)))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    back = torch.from_numpy(lo) + torch.from_numpy(hi - lo) * torch.sigmoid(got)
    inside = np.ones(pulses.shape, bool)
    inside[0, 0] = False  # clipped to 1e-4 inside the edge
    np.testing.assert_allclose(back.numpy()[inside], pulses[inside], atol=1e-5, rtol=0)
    assert float(got[0, 0].max()) == pytest.approx(np.log(1e-4 / (1 - 1e-4)), abs=1e-4)


def _jax_polish(pulses0, packed, draws, sigma_mix, lr, eps_std, log_every):
    """The JAX finetune loop on injected draws, from its pieces
    (``_logits_from_pulses``, ``SU4System.local_mean_fidelity``,
    ``optax.adam``); the kept iterate by its rule."""
    system = JSU4System(drive2=True)
    lo = jnp.asarray([lo for _, (lo, _) in jft.DRIVE2_SPACE])
    hi = jnp.asarray([hi for _, (_, hi) in jft.DRIVE2_SPACE])
    lg = jft._logits_from_pulses(jnp.asarray(pulses0), lo, hi)
    G = pulses0.shape[0]
    z1 = jnp.zeros((G, 1), jnp.float32)
    sig_pos = [s for s in sigma_mix if s > 0]

    def loss(lg, n1, n2, ne):
        pulses = lo + (hi - lo) * jax.nn.sigmoid(lg)
        per = system.local_mean_fidelity(pulses, packed, (z1, z1, z1))
        for s in sig_pos:
            per += system.local_mean_fidelity(pulses, packed, (n1 * s, n2 * s, ne * eps_std))
        per = per / (len(sig_pos) + 1)
        return -jnp.mean(per), per

    opt = optax.adam(lr)
    state = opt.init(lg)
    value_and_grad = jax.jit(jax.value_and_grad(loss, has_aux=True))
    best, best_f, hist = lg, -np.inf, []
    for i, d in enumerate(draws):
        (_, f), g = value_and_grad(lg, *(jnp.asarray(x) for x in d))
        upd, state = opt.update(g, state)
        lg = optax.apply_updates(lg, upd)
        if (i + 1) % log_every == 0 or i == 0:
            mf = float(jnp.mean(f))
            hist.append((i + 1, mf))
            if mf > best_f:
                best_f, best = mf, lg
    return np.asarray(lo + (hi - lo) * jax.nn.sigmoid(best)), hist


@pytest.mark.parametrize("log_every", [1, 2])
def test_polish_steps_match_jax(log_every):
    G, L, M = 2, 5, 32
    pulses0, _, _ = box_pulses(G, L, 1)
    U = np.stack([named_two_qubit_targets()[g] for g in ("cz", "iswap")])
    packed = SU4System.pack_target(U)
    rng = np.random.default_rng(2)
    draws = [tuple(rng.standard_normal((G, M)).astype(np.float32) for _ in range(3))
             for _ in range(3)]
    mix = (0.0, 0.1, 0.2)
    want_p, want_h = _jax_polish(pulses0, jnp.asarray(packed.numpy()), draws, mix, 0.05, 0.05,
                                 log_every)
    got = {}
    for backend in ("xla", "pallas"):
        before = (tk.mean_fidelity_su4_with_product_cuda.launches,
                  tk.su4_objective_vjp_from_product_cuda.launches)
        got[backend] = ft.finetune_su4_tables(
            torch.from_numpy(pulses0), packed, ft.DRIVE2_SPACE, steps=3, monte_carlo=M,
            learning_rate=0.05, sigma_mix=mix, system=SU4System(drive2=True, backend=backend),
            log_every=log_every, draws=[tuple(torch.from_numpy(x) for x in d) for d in draws])
        assert (tk.mean_fidelity_su4_with_product_cuda.launches,
                tk.su4_objective_vjp_from_product_cuda.launches) == before
    for pulses, hist in got.values():
        assert [h[0] for h in hist] == [h[0] for h in want_h]
        np.testing.assert_allclose([h[1] for h in hist], [h[1] for h in want_h], atol=1e-5)
        np.testing.assert_allclose(pulses.numpy(), want_p, atol=2e-5, rtol=0)
    torch.testing.assert_close(got["pallas"][0], got["xla"][0], atol=1e-6, rtol=0)
    assert np.abs(want_p - pulses0).max() > 1e-3  # the steps moved it


def test_polish_draws_come_from_the_seeded_generator():
    """Each step's (n₁, n₂, n_ε), in that order, from a generator seeded
    with ``seed``: the same run as those draws given explicitly."""
    pulses0, _, _ = box_pulses(1, 3, 3)
    packed = SU4System.pack_target(named_two_qubit_targets()["cz"][None])
    kw = dict(steps=2, monte_carlo=8, system=SU4System(drive2=True, backend="xla"),
              log_every=1)
    a = ft.finetune_su4_tables(torch.from_numpy(pulses0), packed, ft.DRIVE2_SPACE, seed=4, **kw)
    gen = torch.Generator().manual_seed(4)
    draws = [tuple(torch.randn((1, 8), generator=gen) for _ in range(3)) for _ in range(2)]
    b = ft.finetune_su4_tables(torch.from_numpy(pulses0), packed, ft.DRIVE2_SPACE,
                               draws=draws, **kw)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)
    assert a[1] == b[1]


def test_bundle_loads_as_the_jax_loader_reads_it():
    tables, meta = ft.load_two_qubit_gate_bundle(BUNDLE)
    jtables, jmeta = jft.load_two_qubit_gate_bundle(BUNDLE)
    assert meta == jmeta and list(tables) == list(jtables) == meta["gates"]
    for g in tables:
        assert tables[g].dtype == jtables[g].dtype and tables[g].shape == (40, 4)
        np.testing.assert_array_equal(tables[g], jtables[g])


def test_finetune_cli_flags_match_jax():
    want = {a.dest: a.default for a in jft.build_parser()._actions}
    got = {a.dest: a.default for a in ft.build_parser()._actions}
    assert set(got) - set(want) == {"device"}
    assert want["out"].endswith("demo/weights/two_qubit_gates.npz")
    assert got.pop("out") == "weights/two_qubit_gates.npz"  # never the shipped bundle
    want.pop("out")
    assert {k: got[k] for k in want} == want


def _jax_selection(monkeypatch, tmp_path, variant, gate):
    """The table, target and system the JAX demo's renderer picks, with its
    contour and sweep replaced by stubs that record their inputs."""
    seen = {}

    def contour(pulses, u_target, system, **kw):
        seen.update(pulses=np.asarray(pulses), u_target=np.asarray(u_target), system=system)

    def sweep(pulses, u_target, system, stds=None, **kw):
        return np.asarray(stds), np.ones(len(stds)), np.zeros(len(stds))

    monkeypatch.setattr(jplots, "fidelity_contour_plot_su4", contour)
    monkeypatch.setattr(jplots, "fidelity_by_std_su4", sweep)
    japp.render_two_qubit_artifacts(variant, gate, str(tmp_path / variant))
    return seen


@pytest.mark.parametrize("variant,gate", [("cz_robust", "cz"), ("cz_drive2", "cz"),
                                          ("two_qubit_gates", "iswap"),
                                          ("two_qubit_gates", "sqrt_swap")])
def test_variant_pulse_tables_match_jax(monkeypatch, tmp_path, variant, gate):
    assert tapp.TWO_QUBIT_VARIANTS[variant] == japp.TWO_QUBIT_VARIANTS[variant]
    want = _jax_selection(monkeypatch, tmp_path, variant, gate)
    pulses, u_target, system, label = tapp.two_qubit_pulse_table(variant, gate, device="cpu")
    np.testing.assert_array_equal(pulses, want["pulses"])
    np.testing.assert_array_equal(u_target, want["u_target"])
    assert system.drive2 == want["system"].drive2 and system.xtalk == want["system"].xtalk
    assert pulses.shape == ((20, 3) if variant == "cz_robust" else
                            (20, 4) if variant == "cz_drive2" else (40, 4))


@pytest.mark.artifacts
def test_variant_model_fallback_matches_jax(monkeypatch, tmp_path):
    """A gate the bundle lacks falls back to the flagship on the textbook
    matrix, in the JAX package as in the port."""
    tables, meta = ft.load_two_qubit_gate_bundle(BUNDLE)
    small = tmp_path / "cz_only.npz"
    meta = dict(meta, gates=["cz"])
    np.savez(small, meta_json=json.dumps(meta), pulses_0=tables["cz"])
    for mod in (tapp, japp):
        spec = dict(mod.TWO_QUBIT_VARIANTS["two_qubit_gates"], gate_bundle=str(small))
        monkeypatch.setitem(mod.TWO_QUBIT_VARIANTS, "two_qubit_gates", spec)
    want = _jax_selection(monkeypatch, tmp_path, "two_qubit_gates", "cnot")
    pulses, _, _, label = tapp.two_qubit_pulse_table("two_qubit_gates", "cnot", device="cpu")
    assert pulses.shape == want["pulses"].shape == (100, 4) and label == "two_qubit_gates:cnot"
    dphi = np.angle(np.exp(1j * (pulses[:, :2] - want["pulses"][:, :2])))
    assert max(np.abs(dphi).max(), np.abs(pulses[:, 2:] - want["pulses"][:, 2:]).max()) <= 1e-3
    kept, _, _, _ = tapp.two_qubit_pulse_table("two_qubit_gates", "cz", device="cpu")
    np.testing.assert_array_equal(kept, tables["cz"])
    with pytest.raises(ValueError, match="unknown gate"):
        tapp.two_qubit_pulse_table("two_qubit_gates", "foo", device="cpu")
    with pytest.raises(ValueError, match="fixed pulse table"):
        tapp.two_qubit_model_kwargs("cz_drive2")


def test_variant_robustness_is_the_sweep_of_its_table():
    out = tapp.two_qubit_robustness("cz_drive2", monte_carlo=64, device="cpu")
    assert out["label"] == "cz_drive2" and len(out["stds"]) == 20
    np.testing.assert_allclose(out["stds"], np.arange(0.02, 0.42, 0.02), atol=1e-7)
    stds, mean, se = tplots.fidelity_by_std_su4(out["pulses"], out["u_target"], out["system"],
                                                stds=np.arange(0.02, 0.42, 0.02),
                                                monte_carlo=64, device="cpu")
    np.testing.assert_array_equal(out["mean"], mean)
    assert 0.9 < mean[0] <= 1.0 and mean[-1] < mean[0]


@pytest.mark.artifacts
def test_finetune_cli_on_the_cpu(tmp_path):
    digest = hashlib.sha256(open(BUNDLE, "rb").read()).hexdigest()
    out = tmp_path / "bundle.npz"
    res = ft.main(["--device", "cpu", "--gates", "cz,iswap", "--steps", "2",
                   "--monte_carlo", "8", "--eval_mc", "16", "--grape_starts", "2",
                   "--grape_steps", "2", "--out", str(out), "--table_out",
                   str(tmp_path / "t.md")])
    tables, meta = ft.load_two_qubit_gate_bundle(out)
    assert meta["gates"] == ["cz", "iswap"] and len(meta["sources"]) == 2
    assert set(meta["sources"]) <= {"model", "polish", "grape"}
    for i, g in enumerate(meta["gates"]):
        assert tables[g].shape in ((100, 4), (20, 4))
        chosen = ft._score(meta["fidelity"][i], res["sigmas"], res["select"])
        model = ft._score(meta["fidelity_model"][i], res["sigmas"], res["select"])
        assert chosen >= model  # the model table is a candidate
    assert "| cz |" in (tmp_path / "t.md").read_text()
    assert hashlib.sha256(open(BUNDLE, "rb").read()).hexdigest() == digest
