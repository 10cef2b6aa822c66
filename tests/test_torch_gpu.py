"""PyTorch port on a CUDA card: the hand-written kernels B1, B2, B3, B4,
B5, B6 and B7 against their plain versions, their input checks and their
launch counters, B1's backward (B3 + B2) against autograd through its plain
version, and the SU(4) mean fidelity's backward (B4 + B5) against autograd
through its plain version.

This file imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest configures JAX).  Without a card
every test skips.  Tolerance 1e-5 abs on quaternions and fidelities at
L = 7, and rtol = atol = 1e-4 on pulse gradients, rtol 1e-4 / atol 1e-5 on
dδ and dε, as ``tests/test_pallas_kernel.py`` holds the JAX kernels.  At
L = 400 the plain f32 version is itself about 1e-3 from an f64 reference
on dδ and dε (the prefix is rebuilt through up to L products and the
gradients sum L terms), so there atol is max(that atol, twice the plain f32
version's own error against f64 on the same inputs).
"""

import math

import pytest
import torch

from universal_quantum_optimal_control_tpu_torch.core import su4
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su2 as tk
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as t4

pytestmark = pytest.mark.gpu
TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def inputs(P, M, dev, B=3, L=7, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed + P)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((B, L), generator=g, device=dev)

    cols = [u(-math.pi, math.pi)] + ([u(-0.3, 1.5)] if P >= 3 else []) \
        + ([u(-1.0, 1.0)] if P == 4 else []) + [u(0.05, 0.5)]
    pulses = torch.stack(cols, dim=-1).contiguous()
    delta = torch.randn((B, M), generator=g, device=dev)
    eps = 0.05 * torch.randn((B, M), generator=g, device=dev)
    q_t = torch.nn.functional.normalize(torch.randn((B, 4), generator=g, device=dev), dim=-1)
    return pulses, q_t, delta, eps


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 1000])  # ragged: no multiple of the block
def test_kernels_match_plain(card, P, M):
    pulses, q_t, delta, eps = inputs(P, M, card)
    q_k = tk.propagate_mc_cuda(pulses, delta, eps)
    f_k = tk.mean_fidelity_cuda(pulses, q_t, delta, eps)
    torch.cuda.synchronize()
    torch.testing.assert_close(q_k, tk.propagate_mc_plain(pulses, delta, eps),
                               atol=TOL, rtol=0)
    torch.testing.assert_close(f_k, tk.mean_fidelity_plain(pulses, q_t, delta, eps),
                               atol=TOL, rtol=0)


def test_each_call_counts_one_launch(card):
    pulses, q_t, delta, eps = inputs(2, 256, card)
    before = (tk.propagate_mc_cuda.launches, tk.mean_fidelity_cuda.launches)
    tk.propagate_mc_cuda(pulses, delta, eps)
    tk.mean_fidelity_cuda(pulses, q_t, delta, eps)
    assert (tk.propagate_mc_cuda.launches, tk.mean_fidelity_cuda.launches) == \
        (before[0] + 1, before[1] + 1)


def test_cuda_inputs_are_checked_not_converted(card):
    pulses, q_t, delta, eps = inputs(2, 256, card)
    with pytest.raises(TypeError, match="float32"):
        tk.propagate_mc_cuda(pulses.double(), delta, eps)
    with pytest.raises(ValueError, match="contiguous"):
        tk.mean_fidelity_cuda(pulses, q_t, delta.t().contiguous().t(), eps)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tk.propagate_mc_cuda(pulses, delta.cpu(), eps)


def assert_vjp_close(got, want, exact=None):
    """``exact``: the plain version in f64, which widens atol to twice the
    plain f32 version's own error where that is larger."""
    for i, (a, b, atol) in enumerate(zip(got, want, (1e-4, 1e-5, 1e-5))):
        if exact is not None:
            atol = max(atol, 2.0 * float((b.double() - exact[i]).abs().max()))
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 1000])  # ragged: no multiple of the block
def test_vjp_kernel_matches_plain(card, P, M):
    pulses, _, delta, eps = inputs(P, M, card)
    g = torch.randn((3, M, 4), generator=torch.Generator(device=card).manual_seed(P),
                    device=card)
    got = tk.propagate_mc_vjp_cuda(pulses, delta, eps, g)
    torch.cuda.synchronize()
    assert_vjp_close(got, tk.propagate_mc_vjp_plain(pulses, delta, eps, g))


def test_vjp_kernel_long_sequence_opts_in_to_large_shared_memory(card):
    """L = 400 at P = 4 takes 59 KB of shared memory, above the 48 KB a
    launch gets without the opt-in attribute."""
    pulses, _, delta, eps = inputs(4, 1000, card, B=2, L=400)
    g = torch.randn((2, 1000, 4), generator=torch.Generator(device=card).manual_seed(9),
                    device=card)
    got = tk.propagate_mc_vjp_cuda(pulses, delta, eps, g)
    torch.cuda.synchronize()
    exact = tk.propagate_mc_vjp_plain(*(t.double() for t in (pulses, delta, eps, g)))
    assert_vjp_close(got, tk.propagate_mc_vjp_plain(pulses, delta, eps, g), exact)


def test_vjp_kernel_past_the_shared_memory_limit_raises(card):
    """L = 1600 at P = 4 needs 231 KB, past the 227 KB an sm_90 block may
    opt in to: the launcher's error is raised, nothing is launched or
    counted, and the next launch is unaffected."""
    pulses, _, delta, eps = inputs(4, 64, card, B=1, L=1600)
    g = torch.zeros((1, 64, 4), device=card)
    before = tk.propagate_mc_vjp_cuda.launches
    with pytest.raises(RuntimeError, match="propagate_mc_vjp launch failed"):
        tk.propagate_mc_vjp_cuda(pulses, delta, eps, g)
    assert tk.propagate_mc_vjp_cuda.launches == before
    pulses, _, delta, eps = inputs(4, 64, card, B=1)
    tk.propagate_mc_vjp_cuda(pulses, delta, eps, g)
    torch.cuda.synchronize()
    assert tk.propagate_mc_vjp_cuda.launches == before + 1


def test_vjp_kernel_at_zero_axis_norm_matches_plain(card):
    """Ω ≤ 0 with Δ + δ = 0 exactly in the first segment: B2 and the plain
    version both floor the squared axis norm and give the finite limit."""
    pulses = torch.tensor([[[0.3, -0.1, 0.3, 0.4], [1.0, 0.8, -0.2, 0.3]]], device=card)
    delta = torch.tensor([[-0.3, 0.5]], device=card)
    eps = torch.tensor([[0.01, 0.02]], device=card)
    g = torch.randn((1, 2, 4), generator=torch.Generator(device=card).manual_seed(0),
                    device=card)
    got = tk.propagate_mc_vjp_cuda(pulses, delta, eps, g)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in got)
    assert_vjp_close(got, tk.propagate_mc_vjp_plain(pulses, delta, eps, g))


def test_vjp_counts_one_launch_and_checks_inputs(card):
    pulses, _, delta, eps = inputs(2, 256, card)
    g = torch.zeros((3, 256, 4), device=card)
    before = tk.propagate_mc_vjp_cuda.launches
    tk.propagate_mc_vjp_cuda(pulses, delta, eps, g)
    assert tk.propagate_mc_vjp_cuda.launches == before + 1
    with pytest.raises(ValueError, match="g must be"):
        tk.propagate_mc_vjp_cuda(pulses, delta, eps, g[:, :10].contiguous())
    with pytest.raises(TypeError, match="float32"):
        tk.propagate_mc_vjp_cuda(pulses, delta, eps, g.double())
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tk.propagate_mc_vjp_cuda(pulses, delta, eps, g.cpu())


@pytest.mark.parametrize("P", [2, 4])
def test_mean_fidelity_backward_runs_b3_and_b2_once(card, P):
    pulses, q_t, delta, eps = inputs(P, 1000, card)
    gbar = torch.rand(3, generator=torch.Generator(device=card).manual_seed(3), device=card)
    leaves = [t.clone().requires_grad_(True) for t in (pulses, q_t, delta, eps)]
    counts = (tk.mean_fidelity_cuda.launches, tk.propagate_mc_cuda.launches,
              tk.propagate_mc_vjp_cuda.launches)
    f = tk.mean_fidelity_cuda(*leaves)
    got = torch.autograd.grad(f, leaves, gbar)
    assert (tk.mean_fidelity_cuda.launches, tk.propagate_mc_cuda.launches,
            tk.propagate_mc_vjp_cuda.launches) == tuple(c + 1 for c in counts)
    ref = [t.clone().requires_grad_(True) for t in (pulses, q_t, delta, eps)]
    want = torch.autograd.grad(tk.mean_fidelity_plain(*ref), ref, gbar)
    for name, a, b in zip(("pulses", "q_target", "delta", "eps"), got, want):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 if name in ("delta", "eps")
                                   else 1e-4, msg=name)


# SU(4): kernels B6 (mean fidelity) and B7 (per-sample product) against their
# plain versions, at the JAX suite's tolerances for its Pallas twins
# (tests/test_su4_pallas.py): products 2e-5, fidelities 1e-5 (2e-5 drive2).

SU4_FID_TOL = {2: 1e-5, 3: 1e-5, 4: 2e-5}


def su4_inputs(P, M, dev, B=3, L=7, seed=0):
    g = torch.Generator(device=dev).manual_seed(100 + seed + P)

    def u(lo, hi):
        return lo + (hi - lo) * torch.rand((B, L), generator=g, device=dev)

    cols = [u(-3.1, 3.1)] + ([u(-3.1, 3.1)] if P == 4 else []) \
        + ([u(-0.3, 2.0)] if P >= 3 else []) + [u(0.05, 0.6)]
    pulses = torch.stack(cols, dim=-1).contiguous()
    d1, d2, ep = (s * torch.randn((B, M), generator=g, device=dev) for s in (0.3, 0.3, 0.05))
    z = torch.complex(torch.randn((B, 4, 4), generator=g, device=dev, dtype=torch.float64),
                      torch.randn((B, 4, 4), generator=g, device=dev, dtype=torch.float64))
    T = torch.linalg.qr(z)[0]
    tr, ti = T.real.float().contiguous(), T.imag.float().contiguous()
    return pulses, tr, ti, d1, d2, ep, su4.TwoQubitSystem(drive2=P == 4)


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 200])  # ragged: no multiple of the block
def test_su4_kernels_match_plain(card, P, M):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(P, M, card)
    Ur, Ui = t4.propagate_su4_mc_cuda(pulses, d1, d2, ep, sys_)
    F = t4.mean_fidelity_su4_cuda(pulses, tr, ti, d1, d2, ep, sys_)
    torch.cuda.synchronize()
    Ur_p, Ui_p = t4.propagate_su4_mc_plain(pulses, d1, d2, ep, sys_)
    torch.testing.assert_close(Ur, Ur_p, atol=2e-5, rtol=0)
    torch.testing.assert_close(Ui, Ui_p, atol=2e-5, rtol=0)
    torch.testing.assert_close(F, t4.mean_fidelity_su4_plain(pulses, tr, ti, d1, d2, ep, sys_),
                               atol=SU4_FID_TOL[P], rtol=0)


def test_su4_each_call_counts_one_launch(card):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(4, 256, card)
    before = (t4.propagate_su4_mc_cuda.launches, t4.mean_fidelity_su4_cuda.launches)
    t4.propagate_su4_mc_cuda(pulses, d1, d2, ep, sys_)
    t4.mean_fidelity_su4_cuda(pulses, tr, ti, d1, d2, ep, sys_)
    assert (t4.propagate_su4_mc_cuda.launches, t4.mean_fidelity_su4_cuda.launches) == \
        (before[0] + 1, before[1] + 1)


def test_su4_inputs_are_checked_not_converted(card):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(3, 64, card)
    pulses4 = su4_inputs(4, 64, card)[0]
    before = (t4.propagate_su4_mc_cuda.launches, t4.mean_fidelity_su4_cuda.launches)
    with pytest.raises(ValueError, match="drive2 expects 4-parameter"):
        t4.propagate_su4_mc_cuda(pulses, d1, d2, ep, sys_._replace(drive2=True))
    with pytest.raises(ValueError, match="require drive2"):
        t4.mean_fidelity_su4_cuda(pulses4, tr, ti, d1, d2, ep, sys_)
    with pytest.raises(TypeError, match="float32"):
        t4.propagate_su4_mc_cuda(pulses, d1.double(), d2, ep, sys_)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        t4.mean_fidelity_su4_cuda(pulses, tr.cpu(), ti, d1, d2, ep, sys_)
    with pytest.raises(NotImplementedError, match="no VJP"):
        t4.propagate_su4_mc_cuda(pulses.clone().requires_grad_(True), d1, d2, ep, sys_)
    assert (t4.propagate_su4_mc_cuda.launches, t4.mean_fidelity_su4_cuda.launches) == before


# SU(4) training: B4 (B6 with the per-sample product) and B5 (the
# product-seeded reverse sweep) against their plain versions, at the JAX
# suite's tolerances (tests/test_su4_pallas.py, tests/test_su4_pallas_bwd.py):
# products 2e-5, fidelities 1e-5 (2e-5 drive2), gradients 1e-5 abs.

SU4_GRAD_TOL = 1e-5


def su4_gbar(B, dev):
    """A non-uniform per-target cotangent (the CVaR path)."""
    return torch.linspace(0.2, 1.8, B, device=dev)


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 200])  # ragged: no multiple of the block
def test_su4_training_kernels_match_plain(card, P, M):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(P, M, card)
    F, prod = t4.mean_fidelity_su4_with_product_cuda(pulses, tr, ti, d1, d2, ep, sys_)
    gbar = su4_gbar(3, card)
    got = t4.su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar, prod, sys_)
    torch.cuda.synchronize()
    F_p, prod_p = t4.mean_fidelity_su4_with_product_plain(pulses, tr, ti, d1, d2, ep, sys_)
    torch.testing.assert_close(F, F_p, atol=SU4_FID_TOL[P], rtol=0)
    torch.testing.assert_close(prod, prod_p, atol=2e-5, rtol=0)
    want = t4.su4_objective_vjp_from_product_plain(pulses, tr, ti, d1, d2, ep, gbar, prod, sys_)
    assert got[0].shape == (3, 7, P)
    for name, a, b in zip(("pulses", "delta1", "delta2", "eps"), got, want):
        torch.testing.assert_close(a, b, atol=SU4_GRAD_TOL, rtol=0, msg=name)


def test_su4_backward_runs_b4_and_b5_once(card):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(4, 300, card)
    gbar = su4_gbar(3, card)
    leaves = [t.clone().requires_grad_(True) for t in (pulses, d1, d2, ep)]
    counts = lambda: (t4.mean_fidelity_su4_cuda.launches,  # noqa: E731
                      t4.mean_fidelity_su4_with_product_cuda.launches,
                      t4.su4_objective_vjp_from_product_cuda.launches,
                      t4.propagate_su4_mc_cuda.launches)
    before = counts()
    F = t4.mean_fidelity_su4_cuda(leaves[0], tr, ti, *leaves[1:], sys_)
    got = torch.autograd.grad(F, leaves, gbar)
    assert counts() == (before[0], before[1] + 1, before[2] + 1, before[3])
    ref = [t.clone().requires_grad_(True) for t in (pulses, d1, d2, ep)]
    want = torch.autograd.grad(t4.mean_fidelity_su4_plain(ref[0], tr, ti, *ref[1:], sys_),
                               ref, gbar)
    for name, a, b in zip(("pulses", "delta1", "delta2", "eps"), got, want):
        torch.testing.assert_close(a, b, atol=SU4_GRAD_TOL, rtol=0, msg=name)


def test_su4_no_gradient_runs_b6_only(card):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(4, 64, card)
    leaf = pulses.clone().requires_grad_(True)
    before = (t4.mean_fidelity_su4_cuda.launches, t4.mean_fidelity_su4_with_product_cuda.launches,
              t4.su4_objective_vjp_from_product_cuda.launches)
    with torch.no_grad():
        t4.mean_fidelity_su4_cuda(leaf, tr, ti, d1, d2, ep, sys_)
    t4.mean_fidelity_su4_cuda(pulses, tr, ti, d1, d2, ep, sys_)
    assert (t4.mean_fidelity_su4_cuda.launches, t4.mean_fidelity_su4_with_product_cuda.launches,
            t4.su4_objective_vjp_from_product_cuda.launches) == \
        (before[0] + 2, before[1], before[2])


def test_su4_training_inputs_are_checked_not_converted(card):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(4, 64, card)
    F, prod = t4.mean_fidelity_su4_with_product_cuda(pulses, tr, ti, d1, d2, ep, sys_)
    gbar = su4_gbar(3, card)
    before = t4.su4_objective_vjp_from_product_cuda.launches
    with pytest.raises(ValueError, match="prod must be"):
        t4.su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar,
                                               prod[:, :, :10].contiguous(), sys_)
    with pytest.raises(ValueError, match="gbar must be"):
        t4.su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar[:2], prod, sys_)
    with pytest.raises(TypeError, match="float32"):
        t4.su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar.double(), prod,
                                               sys_)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        t4.su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar, prod.cpu(), sys_)
    with pytest.raises(TypeError, match="float32"):
        t4.mean_fidelity_su4_with_product_cuda(pulses.double(), tr, ti, d1, d2, ep, sys_)
    assert t4.su4_objective_vjp_from_product_cuda.launches == before
