"""PyTorch port, SU(4) propagation: ``core/su4.py``, the plain versions of
kernels B6 and B7 (what their wrappers compute on CPU tensors),
``SU4System`` and the numeric halves of ``analysis/plots_su4.py``, against
the JAX package's XLA path (``core.su4``, layout "ri") on the same numpy
inputs (CPU, f32).

The JAX suite holds its Pallas SU(4) kernels to that XLA path
(``tests/test_su4_pallas.py``: products 2e-5 abs, fidelities 1e-5, 2e-5 at
drive2); its interpret-mode cases are marked slow, so no Pallas kernel runs
here and the port is held to the same oracle at the same tolerances, at
L ≤ 7.  The Hamiltonian is held at 1e-6 (a few f32 ulps of O(1)
entries), one segment's exponential at 2e-6 (nine dependent 4×4 products
of such entries, summed in another order).  The F(δ₁, δ₂) grid and the E[F](σ)
sweep at L = 7 are held at 1e-5 (the fidelity tolerance: F is a sum of
products of those entries).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.analysis import plots_su4 as jplots
from universal_quantum_optimal_control_tpu.core import su4 as jsu4
from universal_quantum_optimal_control_tpu.training.systems import SU4System as JSU4System
from universal_quantum_optimal_control_tpu_torch.analysis import plots_su4 as tplots
from universal_quantum_optimal_control_tpu_torch.core import su4 as tsu4
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as tk
from universal_quantum_optimal_control_tpu_torch.training import SU4System

PROD_TOL = 2e-5
FID_TOL = {2: 1e-5, 3: 1e-5, 4: 2e-5}


def case(P, B=3, L=7, M=200, seed=0):
    """Pulses (φ, [φ₂,] [Ω,] τ) with some Ω < 0 (the clamp), disorder at
    σ 0.3 / 0.3 / 0.05, and random SU(4) targets, all f32 numpy."""
    rng = np.random.default_rng(seed + 10 * P)
    cols = [rng.uniform(-3.1, 3.1, (B, L))]
    if P == 4:
        cols.append(rng.uniform(-3.1, 3.1, (B, L)))
    if P >= 3:
        cols.append(rng.uniform(-0.3, 2.0, (B, L)))
    cols.append(rng.uniform(0.05, 0.6, (B, L)))
    pulses = np.stack(cols, -1).astype(np.float32)
    d1, d2, ep = (s * rng.standard_normal((B, M)).astype(np.float32) for s in (0.3, 0.3, 0.05))
    z = rng.standard_normal((B, 4, 4)) + 1j * rng.standard_normal((B, 4, 4))
    q, r = np.linalg.qr(z)
    T = q * (np.diagonal(r, axis1=1, axis2=2) / np.abs(np.diagonal(r, axis1=1, axis2=2)))[:, None]
    return pulses, d1, d2, ep, T.real.astype(np.float32), T.imag.astype(np.float32)


def systems(P):
    return jsu4.TwoQubitSystem(drive2=P == 4), tsu4.TwoQubitSystem(drive2=P == 4)


def t(*arrays):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in arrays)


def j(*arrays):
    return tuple(jnp.asarray(a) for a in arrays)


def test_pauli_strings_and_hamiltonian_match_jax():
    jp, tp = jsu4.pauli_strings(), tsu4.pauli_strings()
    assert list(jp) == list(tp)
    for k in jp:
        np.testing.assert_array_equal(tp[k], jp[k])
    rng = np.random.default_rng(1)
    phi, om, phi2 = (rng.uniform(-3, 3, 16).astype(np.float32) for _ in range(3))
    d1, d2, ep = (rng.standard_normal(16).astype(np.float32) for _ in range(3))
    for drive2 in (False, True):
        kw_j = dict(omega=jnp.asarray(om), phi2=jnp.asarray(phi2) if drive2 else None)
        kw_t = dict(omega=torch.from_numpy(om), phi2=torch.from_numpy(phi2) if drive2 else None)
        Hj = jsu4.su4_hamiltonian(*j(phi, d1, d2, ep), jsu4.TwoQubitSystem(), **kw_j)
        Ht = tsu4.su4_hamiltonian(*t(phi, d1, d2, ep), tsu4.TwoQubitSystem(), **kw_t)
        for a, b in zip(Ht, Hj):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


@pytest.mark.parametrize("order", [8, 6])
def test_expm_taylor_matches_jax_and_is_unitary(order):
    rng = np.random.default_rng(2)
    Hr = rng.standard_normal((8, 4, 4)).astype(np.float32)
    Hi = rng.standard_normal((8, 4, 4)).astype(np.float32)
    Hr, Hi = (Hr + Hr.transpose(0, 2, 1)) / 2, (Hi - Hi.transpose(0, 2, 1)) / 2  # Hermitian
    tau = rng.uniform(0.05, 0.5, 8).astype(np.float32)
    Uj = jsu4.expm_taylor_ri(*j(Hr, Hi, tau), order=order)
    Ut = tsu4.expm_taylor_ri(*t(Hr, Hi, tau), order=order)
    for a, b in zip(Ut, Uj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-6)
    U = tsu4.complex_from_ri(*Ut).numpy()
    # unitary to f32 rounding doubled by each of the 4 squarings
    np.testing.assert_allclose(np.einsum("bji,bjk->bik", U.conj(), U),
                               np.broadcast_to(np.eye(4), U.shape), atol=1e-5)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_propagate_su4_mc_and_fidelity_match_jax(P):
    pulses, d1, d2, ep, Tr, Ti = case(P)
    sj, st = systems(P)
    Uj = jsu4.propagate_su4_mc(*j(pulses, d1, d2, ep), sj, layout="ri")
    Ut = tsu4.propagate_su4_mc(*t(pulses, d1, d2, ep), st)
    for a, b in zip(Ut, Uj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=PROD_TOL)
    Fj = jsu4.fidelity_su4_ri(*Uj, *j(Tr[:, None], Ti[:, None]))
    Ft = tsu4.fidelity_su4_ri(*Ut, *t(Tr[:, None], Ti[:, None]))
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), atol=FID_TOL[P])
    # the un-batched form on one sample, and the f64 path
    U1 = tsu4.propagate_su4(*t(pulses[0], d1[0, :1], d2[0, :1], ep[0, :1]), st)
    np.testing.assert_allclose(U1[0].numpy(), Ut[0][0, :1].numpy(), atol=1e-6)
    U64 = tsu4.propagate_su4_mc(*(x.double() for x in t(pulses, d1, d2, ep)), st)
    assert U64[0].dtype == torch.float64
    np.testing.assert_allclose(U64[0].numpy(), Ut[0].numpy(), atol=PROD_TOL)


@pytest.mark.parametrize("P", [2, 3, 4])
def test_kernel_plain_versions_match_jax_xla(P):
    """B7 and B6 as their wrappers compute them on CPU tensors."""
    pulses, d1, d2, ep, Tr, Ti = case(P, seed=5)
    sj, st = systems(P)
    Urj, Uij = jsu4.propagate_su4_mc(*j(pulses, d1, d2, ep), sj, layout="ri")
    Urt, Uit = tk.propagate_su4_mc_cuda(*t(pulses, d1, d2, ep), st)
    assert Urt.shape == Uit.shape == (3, 200, 4, 4)
    np.testing.assert_allclose(Urt.numpy(), np.asarray(Urj), atol=PROD_TOL)
    np.testing.assert_allclose(Uit.numpy(), np.asarray(Uij), atol=PROD_TOL)
    Fj = jnp.mean(jsu4.fidelity_su4_ri(Urj, Uij, *j(Tr[:, None], Ti[:, None])), axis=1)
    Ft = tk.mean_fidelity_su4_cuda(*t(pulses, Tr, Ti, d1, d2, ep), st)
    assert Ft.shape == (3,)
    np.testing.assert_allclose(Ft.numpy(), np.asarray(Fj), atol=FID_TOL[P])
    # the system's objective on packed targets, on either backend
    packed = np.stack([Tr, Ti], axis=1)
    for backend in ("xla", "pallas"):
        Fp = SU4System(drive2=P == 4, backend=backend).local_mean_fidelity(
            *t(pulses, packed), t(d1, d2, ep))
        np.testing.assert_allclose(Fp.numpy(), np.asarray(Fj), atol=FID_TOL[P])


def test_unitarity_at_long_sequences():
    pulses, d1, d2, ep, _, _ = case(4, B=2, L=100, M=16)
    Ur, Ui = tk.propagate_su4_mc_cuda(*t(pulses, d1, d2, ep), tsu4.TwoQubitSystem(drive2=True))
    U = tsu4.complex_from_ri(Ur, Ui).numpy()
    np.testing.assert_allclose(np.einsum("bmji,bmjk->bmik", U.conj(), U),
                               np.broadcast_to(np.eye(4), U.shape), atol=1e-4)


def test_pulse_widths_and_layouts_are_checked():
    pulses, d1, d2, ep, Tr, Ti = case(3)
    args = t(pulses, d1, d2, ep)
    with pytest.raises(ValueError, match="drive2 expects 4-parameter"):
        tsu4.propagate_su4_mc(*args, tsu4.TwoQubitSystem(drive2=True))
    with pytest.raises(ValueError, match="require drive2"):
        tsu4.propagate_su4_mc(*t(case(4)[0], d1, d2, ep), tsu4.TwoQubitSystem())
    Us = tsu4.propagate_su4_mc(*args, tsu4.TwoQubitSystem(), layout="soa")
    for a, b in zip(Us, tsu4.propagate_su4_mc(*args, tsu4.TwoQubitSystem(), layout="ri")):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="unknown layout"):
        tsu4.propagate_su4_mc(*args, tsu4.TwoQubitSystem(), layout="tiles")
    Ua = tsu4.propagate_su4_mc(*args, tsu4.TwoQubitSystem(), layout="auto")
    Ur = tsu4.propagate_su4_mc(*args, tsu4.TwoQubitSystem(), layout="ri")
    assert all(torch.equal(a, b) for a, b in zip(Ua, Ur))


def test_kernel_input_checks():
    """The CUDA route's checks, run on CPU tensors (no launch happens)."""
    pulses, d1, d2, ep, Tr, Ti = t(*case(4, M=64))
    st = tsu4.TwoQubitSystem(drive2=True)
    assert tk._check(pulses, d1, d2, ep, st, Tr, Ti) == (3, 7, 4, 64)
    with pytest.raises(TypeError, match="float32"):
        tk._check(pulses.double(), d1, d2, ep, st)
    with pytest.raises(ValueError, match="contiguous"):
        tk._check(pulses, d1.t().contiguous().t(), d2, ep, st)
    with pytest.raises(ValueError, match="drive2 expects 4-parameter"):
        tk._check(pulses[..., 1:].contiguous(), d1, d2, ep, st)
    with pytest.raises(ValueError, match="require drive2"):
        tk._check(pulses, d1, d2, ep, tsu4.TwoQubitSystem())
    with pytest.raises(NotImplementedError, match="order-8"):  # on either route
        tk.mean_fidelity_su4_cuda(pulses, Tr, Ti, d1, d2, ep, st._replace(expm_order=6))
    with pytest.raises(ValueError, match=r"\(B, M\)"):
        tk._check(pulses, d1, d2[:, :10].contiguous(), ep, st)
    with pytest.raises(ValueError, match="target_re"):
        tk._check(pulses, d1, d2, ep, st, Tr[:2].contiguous(), Ti)
    with pytest.raises(ValueError, match="shared-memory"):
        tk._check(torch.zeros(3, 4000, 4), d1, d2, ep, st)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tk.propagate_su4_mc_cuda(pulses, d1, d2, ep.to("meta"), st)


def test_wrappers_count_no_launch_on_cpu_and_refuse_gradients():
    """On CPU tensors no wrapper launches or counts.  B7 refuses a gradient
    on either route (the JAX ``propagate_su4_mc_pallas`` has no VJP); B6's
    route differentiates (its backward is B5, here the plain version) and
    gives the plain path's gradient."""
    pulses, d1, d2, ep, Tr, Ti = t(*case(2, M=16))
    counters = (tk.propagate_su4_mc_cuda, tk.mean_fidelity_su4_cuda,
                tk.mean_fidelity_su4_with_product_cuda, tk.su4_objective_vjp_from_product_cuda)
    before = tuple(c.launches for c in counters)
    tk.propagate_su4_mc_cuda(pulses, d1, d2, ep)
    tk.mean_fidelity_su4_cuda(pulses, Tr, Ti, d1, d2, ep)
    leaf = pulses.clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no VJP"):
        tk.propagate_su4_mc_cuda(leaf, d1, d2, ep)
    F = tk.mean_fidelity_su4_cuda(leaf, Tr, Ti, d1, d2, ep)
    (g_k,) = torch.autograd.grad(F.sum(), leaf)
    with torch.no_grad():  # no gradient asked for: B7 runs
        tk.propagate_su4_mc_cuda(leaf, d1, d2, ep)
    packed = torch.stack([Tr, Ti], dim=1)
    F = SU4System(backend="pallas").local_mean_fidelity(leaf, packed, (d1, d2, ep))
    (g_s,) = torch.autograd.grad(F.sum(), leaf)
    assert tuple(c.launches for c in counters) == before
    # the plain path differentiates: d E[F] / d pulses, finite, and the
    # kernels' route gives the same gradient
    F = SU4System(backend="xla").local_mean_fidelity(leaf, packed, (d1, d2, ep))
    (g,) = torch.autograd.grad(F.sum(), leaf)
    assert g.shape == pulses.shape and bool(torch.isfinite(g).all())
    torch.testing.assert_close(g_k, g, rtol=0, atol=1e-7)
    torch.testing.assert_close(g_s, g, rtol=0, atol=1e-7)
    with pytest.raises(NotImplementedError, match="order-8"):
        sys_ = SU4System(backend="pallas")
        sys_.system = sys_.system._replace(expm_order=6)
        sys_.local_mean_fidelity(pulses, packed, (d1, d2, ep))
    with pytest.raises(ValueError, match="unknown backend"):
        SU4System(backend="tpu").local_mean_fidelity(pulses, packed, (d1, d2, ep))


def test_su4_system_pack_target_and_sample_errors():
    rng = np.random.default_rng(3)
    U = (rng.standard_normal((5, 4, 4)) + 1j * rng.standard_normal((5, 4, 4))).astype(np.complex64)
    np.testing.assert_array_equal(SU4System.pack_target(U).numpy(),
                                  np.asarray(JSU4System.pack_target(U)))
    sys_ = SU4System(xtalk=0.2, coupling=0.4, drive2=True)
    assert sys_.system == tsu4.TwoQubitSystem(xtalk=0.2, coupling=0.4, drive2=True)
    assert sys_.backend == "xla"
    draws = [sys_.sample_errors(torch.Generator().manual_seed(4), (4, 20000), 0.3, 0.05)
             for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*draws))
    d1, d2, ep = draws[0]
    assert d1.shape == d2.shape == ep.shape == (4, 20000)
    # independent gaussians of the given stds (5-sigma bounds at n = 8e4)
    assert abs(float(d1.std()) - 0.3) < 4e-3 and abs(float(d2.std()) - 0.3) < 4e-3
    assert abs(float(ep.std()) - 0.05) < 7e-4
    assert abs(float(torch.corrcoef(torch.stack([d1.flatten(), d2.flatten()]))[0, 1])) < 0.018


def test_grid_and_sweep_match_jax():
    pulses = case(4, B=1, L=7)[0][0]
    cz = np.diag([1, 1, 1, -1]).astype(np.complex64)
    sj, st = systems(4)
    dg_t, F_t = tplots.fidelity_grid_su4(pulses, cz, st, n_delta=11, epsilon=0.02, device="cpu")
    dg_j, F_j = jplots.fidelity_grid_su4(pulses, cz, sj, n_delta=11, epsilon=0.02)
    np.testing.assert_allclose(dg_t, dg_j, atol=1e-7)
    assert F_t.shape == (11, 11)
    np.testing.assert_allclose(F_t, F_j, atol=1e-5)
    # the packed (2, 4, 4) form of the target gives the same surface
    _, F_p = tplots.fidelity_grid_su4(pulses, np.stack([cz.real, cz.imag]), st,
                                      n_delta=11, epsilon=0.02, device="cpu")
    np.testing.assert_array_equal(F_p, F_t)
    # the sweep on matched draws
    rng = np.random.default_rng(6)
    stds = np.asarray([0.05, 0.2, 0.6], np.float32)
    n1, n2 = (rng.standard_normal((3, 500)).astype(np.float32) for _ in range(2))
    ne = (0.05 * rng.standard_normal((3, 500))).astype(np.float32)
    tr, ti = cz.real.astype(np.float32), cz.imag.astype(np.float32)
    mj, sej = jplots._sweep_su4(*j(pulses, tr, ti, n1, n2, ne, stds), sj.xtalk, sj.coupling,
                                sj.drive2)
    mt, set_ = tplots._sweep_su4(*t(pulses, tr, ti, n1, n2, ne, stds), st)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mj), atol=1e-5)
    np.testing.assert_allclose(set_.numpy(), np.asarray(sej), atol=1e-5)
    # the public sweep: shapes, defaults and a seeded generator
    s, m, se = tplots.fidelity_by_std_su4(pulses, cz, st, stds=[0.0, 0.3], monte_carlo=64,
                                          generator=torch.Generator().manual_seed(1),
                                          device="cpu")
    assert s.shape == m.shape == se.shape == (2,)
    assert 0.0 < m[1] <= 1.0 and se[1] > 0.0
    s, m, _ = tplots.fidelity_by_std_su4(pulses, cz, st, monte_carlo=8, device="cpu")
    assert len(s) == 29 and np.isfinite(m).all()
