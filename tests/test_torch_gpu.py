"""PyTorch port on a CUDA card: the hand-written kernels B1, B2, B3, B4,
B5, B6, B7 and B8 against their plain versions (B8 also against B5 seeded
by B4, within 1e-6: the same product code and the same sweep), their input
checks and their launch counters, B1's backward (B3 + B2) against autograd through its plain
version, and the SU(4) mean fidelity's backward (B4 + B5) against autograd
through its plain version.

B1 sums over blocks inside its one launch and B2 over a warp's lanes by
exchanges: two runs on the same inputs must give the same bits; B2
on B3's product passed in or formed by B3 itself the same bits; a sample
whose angles pass the polynomial sincos's range takes libm's, and holds;
B1 and B3 at the longest row the card's shared memory takes, and one
chunk past it; B1 captured in a CUDA graph, then called eagerly.

Slice 2's shapes: B1, B3 and B2 at the GRAPE step's (100, 400, 2, 1000)
and the P = 4 polish's (5, 100, 4, 8192), each input in its pulse box, and
one GRAPE training step on the card (L = 400, B1 forward, B3 + B2
backward, one launch each).

B4, B6, B5 and B8 run each sample on a group of four lanes; their cases
include M = 4096 + 3, whose last block ends inside a group of samples, and
two launches on the same inputs must agree bit for bit.

Slice 4a: the sharded objective ``make_mean_fidelity(mesh, "pallas")``
through B1 on 2 gloo ranks of a 1 × 2 mesh that share the card, against one
process's B1 (value 2e-6, gradient 1e-5 of its largest entry); the
``xla_remat`` backend on CUDA tensors against ``xla`` (the plain path, no
kernel launched).

Slice 4b: the figures' sweep (``analysis/plots.py::fidelity_by_std``, every
σ on B3's Monte-Carlo axis, one launch) on the SCORE Z(π/4) table
(L = 2019, the longest row a path gives B3) against its plain version on
the same draws, and the Bloch trajectories' endpoints against B3's product
rotated onto ẑ at P = 2 and 4 (tolerance: 1e-5 or twice the plain f32
version's own error against f64, whichever is larger).

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
from universal_quantum_optimal_control_tpu_torch.core.su2 import quat_fidelity
from universal_quantum_optimal_control_tpu_torch.ops import _build
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


@pytest.mark.parametrize("P", [2, 4])
def test_b1_and_b3_at_the_longest_row_the_card_takes(card, P):
    """B1 and B3 opt in to more than 48 KB of shared memory, up to the
    card's limit less their static buffers (``uqoc_su2_max_len``): at that
    length both launch and hold to their plain versions (atol widened to
    twice the plain f32 version's own error against f64, as at long L); one
    chunk longer the launcher's refusal is raised, nothing is counted, and
    the next launch is unaffected."""
    lib = _build.load_library("su2")
    L1, L3 = lib.uqoc_su2_max_len(1, P), lib.uqoc_su2_max_len(3, P)
    assert 2000 < L1 <= L3
    pulses, q_t, delta, eps = inputs(P, 64, card, B=1, L=L1)
    f = tk.mean_fidelity_cuda(pulses, q_t, delta, eps)
    q = tk.propagate_mc_cuda(pulses, delta, eps)
    torch.cuda.synchronize()
    q32 = tk.propagate_mc_plain(pulses, delta, eps)
    q64 = tk.propagate_mc_plain(*(t.double() for t in (pulses, delta, eps)))
    e32 = float((q32.double() - q64).abs().max())
    torch.testing.assert_close(q, q32, atol=max(TOL, 2 * e32), rtol=0)
    # mean_fidelity_plain's fidelity, from the products above
    f32 = quat_fidelity(q32, q_t[:, None, :]).mean(1)
    f64 = quat_fidelity(q64, q_t.double()[:, None, :]).mean(1)
    torch.testing.assert_close(f, f32, atol=max(TOL, 2 * float((f32.double() - f64).abs().max())),
                               rtol=0)
    pulses3 = inputs(P, 64, card, B=1, L=L3)[0]
    q3 = tk.propagate_mc_cuda(pulses3, delta, eps)
    torch.cuda.synchronize()
    torch.testing.assert_close(q3.norm(dim=-1), torch.ones_like(q3[..., 0]), atol=1e-3, rtol=0)
    counts = (tk.mean_fidelity_cuda.launches, tk.propagate_mc_cuda.launches)
    long1 = inputs(P, 64, card, B=1, L=L1 + 4)[0]
    long3 = inputs(P, 64, card, B=1, L=L3 + 4)[0]
    with pytest.raises(RuntimeError, match="mean_fidelity launch failed"):
        tk.mean_fidelity_cuda(long1, q_t, delta, eps)
    with pytest.raises(RuntimeError, match="propagate_mc launch failed"):
        tk.propagate_mc_cuda(long3, delta, eps)
    assert (tk.mean_fidelity_cuda.launches, tk.propagate_mc_cuda.launches) == counts
    assert torch.equal(tk.mean_fidelity_cuda(pulses, q_t, delta, eps), f)


def test_b1_captured_in_a_graph_then_called_eagerly(card):
    """B1's first call on a stream made inside a CUDA graph capture: the
    graph zeroes its own ticket counters at each replay, and the eager calls
    on that stream after it get counters zeroed eagerly (the capture leaves
    none in the cache); every result the same bits as B1 on the default
    stream."""
    pulses, q_t, delta, eps = inputs(2, 50_000, card, B=4, L=20)
    want = tk.mean_fidelity_cuda(pulses, q_t, delta, eps)
    side = torch.cuda.Stream()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = tk.mean_fidelity_cuda(pulses, q_t, delta, eps)
    assert (pulses.device.index, side.cuda_stream) not in tk._tickets
    with torch.cuda.stream(side):
        eager = [tk.mean_fidelity_cuda(pulses, q_t, delta, eps) for _ in range(2)]
    side.synchronize()
    for got in eager:
        assert torch.equal(got, want)
    for _ in range(2):
        out.zero_()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)
    with torch.cuda.stream(side):
        got = tk.mean_fidelity_cuda(pulses, q_t, delta, eps)
    side.synchronize()
    assert torch.equal(got, want)


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


@pytest.mark.parametrize("L", [400, 1000])
def test_vjp_kernel_long_sequence_opts_in_to_large_shared_memory(card, L):
    """L = 400 at P = 4 (the longest pulse table the repo ships) takes 25 KB
    of shared memory; L = 1000 takes 64 KB, above the 48 KB a launch gets
    without the opt-in attribute."""
    lib = _build.load_library("su2")
    assert (lib.uqoc_su2_vjp_smem_bytes(L, 4) > 48 * 1024) == (L == 1000)
    pulses, _, delta, eps = inputs(4, 1000, card, B=2, L=L)
    g = torch.randn((2, 1000, 4), generator=torch.Generator(device=card).manual_seed(9),
                    device=card)
    got = tk.propagate_mc_vjp_cuda(pulses, delta, eps, g)
    torch.cuda.synchronize()
    exact = tk.propagate_mc_vjp_plain(*(t.double() for t in (pulses, delta, eps, g)))
    assert_vjp_close(got, tk.propagate_mc_vjp_plain(pulses, delta, eps, g), exact)


def test_vjp_kernel_past_the_shared_memory_limit_raises(card):
    """L = 4000 at P = 4 needs 256 KB, past the 227 KB an sm_90 block may
    opt in to: the launcher's error is raised, nothing is launched or
    counted, and the next launch is unaffected."""
    assert _build.load_library("su2").uqoc_su2_vjp_smem_bytes(4000, 4) > 232448
    pulses, _, delta, eps = inputs(4, 64, card, B=1, L=4000)
    g = torch.zeros((1, 64, 4), device=card)
    before = tk.propagate_mc_vjp_cuda.launches
    with pytest.raises(RuntimeError, match="propagate_mc_vjp launch failed"):
        tk.propagate_mc_vjp_cuda(pulses, delta, eps, g, torch.zeros_like(g))
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


@pytest.mark.parametrize("P", [2, 3, 4])
def test_vjp_kernel_with_and_without_the_product_is_the_same(card, P):
    """B2 on B3's product passed in, and B2 forming it through B3 itself
    (one B3 launch, counted there): the same bits."""
    pulses, _, delta, eps = inputs(P, 1000, card)
    g = torch.randn((3, 1000, 4), generator=torch.Generator(device=card).manual_seed(P),
                    device=card)
    q = tk.propagate_mc_cuda(pulses, delta, eps)
    counts = (tk.propagate_mc_cuda.launches, tk.propagate_mc_vjp_cuda.launches)
    without = tk.propagate_mc_vjp_cuda(pulses, delta, eps, g)
    assert (tk.propagate_mc_cuda.launches, tk.propagate_mc_vjp_cuda.launches) == \
        (counts[0] + 1, counts[1] + 1)
    with_q = tk.propagate_mc_vjp_cuda(pulses, delta, eps, g, q)
    for a, b in zip(without, with_q):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="q must be"):
        tk.propagate_mc_vjp_cuda(pulses, delta, eps, g, q[:, :10].contiguous())


@pytest.mark.parametrize("P", [2, 4])
def test_b1_and_b2_give_the_same_bits_on_two_runs(card, P):
    """B1's one-launch sum over blocks (whichever block draws the last
    ticket sums in block order) and B2's warp sums: the same inputs give the
    same bits, at a shape of many blocks per target."""
    pulses, q_t, delta, eps = inputs(P, 50_000, card, B=4, L=20)
    g = torch.randn((4, 50_000, 4), generator=torch.Generator(device=card).manual_seed(1),
                    device=card)
    first = (tk.mean_fidelity_cuda(pulses, q_t, delta, eps),
             *tk.propagate_mc_vjp_cuda(pulses, delta, eps, g))
    second = (tk.mean_fidelity_cuda(pulses, q_t, delta, eps),
              *tk.propagate_mc_vjp_cuda(pulses, delta, eps, g))
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P", [2, 4])
def test_kernels_take_libm_past_the_polynomials_range(card, P):
    """A segment of τ = 2400 and samples at δ = ε = 0: the half angle τ/2 =
    1200 (Ω = 1, Δ = 0 there at P = 4) is past the polynomial sincos's range,
    so these samples take libm's sincosf; the angle is the same f32 number
    in the plain version, so B3 and B1 hold to it at the usual tolerances,
    and B2 too where its gradients, which grow with τ, allow twice the plain
    f32 version's own error."""
    lib = _build.load_library("su2")
    assert 1200.0 > lib.uqoc_su2_poly_max()
    pulses, q_t, delta, eps = inputs(P, 256, card, L=7)
    pulses[:, 3, -1] = 2400.0
    if P == 4:
        pulses[:, 3, 1:3] = torch.tensor([1.0, 0.0], device=card)
    delta.zero_()
    eps.zero_()
    torch.testing.assert_close(tk.propagate_mc_cuda(pulses, delta, eps),
                               tk.propagate_mc_plain(pulses, delta, eps), atol=TOL, rtol=0)
    torch.testing.assert_close(tk.mean_fidelity_cuda(pulses, q_t, delta, eps),
                               tk.mean_fidelity_plain(pulses, q_t, delta, eps), atol=TOL, rtol=0)
    g = torch.randn((3, 256, 4), generator=torch.Generator(device=card).manual_seed(2),
                    device=card)
    # dε and dτ scale with τ = 2400: atol also allows twice the plain f32
    # version's own error against f64, as at long L
    exact = tk.propagate_mc_vjp_plain(*(t.double() for t in (pulses, delta, eps, g)))
    assert_vjp_close(tk.propagate_mc_vjp_cuda(pulses, delta, eps, g),
                     tk.propagate_mc_vjp_plain(pulses, delta, eps, g), exact)


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


# ragged: no multiple of the block; 4096 + 3 ends inside a lane group's block
@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 200, 4099])
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


# 8449 samples for 3 targets fill an H100's schedulers: one thread a sample
@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("M", [1, 200, 4099, 8449])  # ragged, as above
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


@pytest.mark.parametrize("P,L,M", [(2, 3, 1), (3, 7, 200), (4, 7, 1000), (4, 24, 300),
                                   (4, 7, 4099), (4, 7, 8449)])
def test_b8_matches_plain_and_b5_seeded_by_b4(card, P, L, M):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(P, M, card, L=L, seed=L)
    gbar = su4_gbar(3, card)
    before = (t4.su4_objective_vjp_cuda.launches,
              t4.su4_objective_vjp_from_product_cuda.launches)
    got = t4.su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar, sys_)
    assert (t4.su4_objective_vjp_cuda.launches,
            t4.su4_objective_vjp_from_product_cuda.launches) == (before[0] + 1, before[1])
    _, prod = t4.mean_fidelity_su4_with_product_cuda(pulses, tr, ti, d1, d2, ep, sys_)
    seeded = t4.su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar, prod,
                                                    sys_)
    torch.cuda.synchronize()
    want = t4.su4_objective_vjp_plain(pulses, tr, ti, d1, d2, ep, gbar, sys_)
    assert got[0].shape == (3, L, P) and all(g.shape == (3, M) for g in got[1:])
    for name, a, b, c in zip(("pulses", "delta1", "delta2", "eps"), got, want, seeded):
        torch.testing.assert_close(a, b, atol=SU4_GRAD_TOL, rtol=0, msg=name)
        torch.testing.assert_close(a, c, atol=1e-6, rtol=0, msg=name)


def test_b8_inputs_are_checked_not_converted(card):
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(4, 64, card)
    gbar = su4_gbar(3, card)
    before = t4.su4_objective_vjp_cuda.launches
    with pytest.raises(ValueError, match="gbar must be"):
        t4.su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar[:2], sys_)
    with pytest.raises(TypeError, match="float32"):
        t4.su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar.double(), sys_)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        t4.su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar.cpu(), sys_)
    assert t4.su4_objective_vjp_cuda.launches == before


def test_su4_lane_group_kernels_are_deterministic(card):
    """B4, B6, B5 and B8 sum over samples in a fixed order (group sums,
    warp shuffles, block partials, double pass 2): two launches on the same
    inputs give the same bits."""
    pulses, tr, ti, d1, d2, ep, sys_ = su4_inputs(4, 4099, card)
    gbar = su4_gbar(3, card)

    def run():
        F, prod = t4.mean_fidelity_su4_with_product_cuda(pulses, tr, ti, d1, d2, ep, sys_)
        F6 = t4.mean_fidelity_su4_cuda(pulses, tr, ti, d1, d2, ep, sys_)
        g5 = t4.su4_objective_vjp_from_product_cuda(pulses, tr, ti, d1, d2, ep, gbar, prod, sys_)
        g8 = t4.su4_objective_vjp_cuda(pulses, tr, ti, d1, d2, ep, gbar, sys_)
        return (F, prod, F6, *g5, *g8)

    first, second = run(), run()
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


def test_su4_launches_take_both_paths(card):
    """B4, B6, B5 and B8 run one thread per sample where the launch gives
    the card's warp schedulers at least 1.5 warps each, and a lane group per
    sample where it would give fewer; the cases above cover both."""
    from universal_quantum_optimal_control_tpu_torch.ops._build import load_library
    fwd, bwd = load_library("su4"), load_library("su4_bwd")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    full = 3 * n_sm // 2 * 128  # samples of one target that fill the card
    for lanes in (fwd.uqoc_su4_lanes, bwd.uqoc_su4_vjp_lanes):
        assert lanes(3, 200) > 1 and lanes(3, 4099) > 1
        assert lanes(1, full) == 1 and lanes(3, 8449) == 1


# B7's plans (K chunks of a sample's segments, one thread each): every
# branch against the plain version, at max(2e-5, twice the plain f32
# version's own error against f64) as chip_smoke.py holds B7 at L = 100;
# K = 1 is one thread per sample; the cases take M = 1, M = 45 (a block's
# last samples past M), L = 1 and L < K (chunks with no segment).
B7_PLANS = [1, 2, 4, 8, 16, 32]


def b7_tol(pulses, d1, d2, ep, sys_):
    plain = t4.propagate_su4_mc_plain(pulses, d1, d2, ep, sys_)
    exact = t4.propagate_su4_mc_plain(*(t.double() for t in (pulses, d1, d2, ep)), sys_)
    err = max(float((a.double() - b).abs().max()) for a, b in zip(plain, exact))
    return plain, max(2e-5, 2 * err)


@pytest.mark.parametrize("chunks", B7_PLANS)
@pytest.mark.parametrize("P,L,M", [(4, 1, 1), (2, 1, 45), (3, 3, 45), (4, 7, 45),
                                   (4, 20, 4099), (4, 100, 300)])
def test_b7_plans_match_plain(card, P, L, M, chunks):
    pulses, _, _, d1, d2, ep, sys_ = su4_inputs(P, M, card, L=L, seed=L)
    got = t4._launch_propagate(pulses, d1, d2, ep, sys_, chunks=chunks)
    torch.cuda.synchronize()
    want, tol = b7_tol(pulses, d1, d2, ep, sys_)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=tol, rtol=0)


@pytest.mark.parametrize("chunks", B7_PLANS)
def test_b7_gives_the_same_bits_on_a_rerun(card, chunks):
    """The chunks combine in a fixed tree: two launches on the same inputs
    give the same bits, and the card's own plan equals the same plan named."""
    pulses, _, _, d1, d2, ep, sys_ = su4_inputs(4, 4099, card, L=20)
    first = t4._launch_propagate(pulses, d1, d2, ep, sys_, chunks=chunks)
    second = t4._launch_propagate(pulses, d1, d2, ep, sys_, chunks=chunks)
    planned = t4.propagate_su4_mc_cuda(pulses, d1, d2, ep, sys_)
    named = t4._launch_propagate(pulses, d1, d2, ep, sys_,
                                 chunks=t4.propagate_su4_plan(3, 4099, 20))
    torch.cuda.synchronize()
    for a, b, c, d in zip(first, second, planned, named):
        assert torch.equal(a, b) and torch.equal(c, d)


def test_b7_refuses_a_plan_it_does_not_run(card):
    pulses, _, _, d1, d2, ep, sys_ = su4_inputs(4, 64, card)
    before = t4.propagate_su4_mc_cuda.launches
    for chunks in [3, 0, 64, -2]:
        with pytest.raises(RuntimeError, match="invalid argument"):
            t4._launch_propagate(pulses, d1, d2, ep, sys_, chunks=chunks)
    assert t4.propagate_su4_mc_cuda.launches == before


def test_b7_plan_beside_b4_lanes(card):
    """Where B4 and B6 take lane groups (one thread per sample gives the
    schedulers under 1.5 warps each) B7 never runs one thread per sample
    unless L = 1; on an H100 (132 SMs) the GRAPE curve, serving's sweep and
    the variants' sweep take the plans PERF.md states."""
    from universal_quantum_optimal_control_tpu_torch.ops._build import load_library
    lib = load_library("su4")
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    full = 3 * n_sm // 2 * 128
    for B, M, L in [(1, 4096, 20), (1, 40_000, 100), (1, 2_000_000, 20), (3, 200, 7),
                    (5, 4096, 100), (1, full, 100), (1, full - 128, 100), (3, 1, 1)]:
        K = t4.propagate_su4_plan(B, M, L)
        if lib.uqoc_su4_lanes(B, M) > 1 and L > 1:
            assert K > 1, (B, M, L)
        assert 1 <= K <= max(1, L) and lib.uqoc_su4_prop_blocks_per_sm(K, 4, L) >= 1
    if n_sm == 132:
        assert [t4.propagate_su4_plan(*shape) for shape in
                [(1, 4096, 20), (1, 40_000, 100), (1, 2_000_000, 20)]] == [4, 2, 1]


# Slice 2's shapes: GRAPE's step (100, 400, 2, 1000), τ in its box [0.035,
# 0.07], and the P = 4 polish (5, 100, 4, 8192) in the (φ, Ω, Δ, τ) box;
# atol widened to twice the plain f32 version's own error against f64.

SLICE2_BOXES = {2: ((-3.15, 3.15), (0.035, 0.07)),
                4: ((-3.15, 3.15), (0.0, 1.0), (-5.0, 5.0), (0.1, 0.5))}


def slice2_inputs(B, L, P, M, dev, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    box = torch.tensor(SLICE2_BOXES[P], device=dev)
    u = torch.rand((B, L, P), generator=g, device=dev)
    pulses = (box[:, 0] + (box[:, 1] - box[:, 0]) * u).contiguous()
    delta = torch.randn((B, M), generator=g, device=dev)
    eps = 0.05 * torch.randn((B, M), generator=g, device=dev)
    q_t = torch.nn.functional.normalize(torch.randn((B, 4), generator=g, device=dev), dim=-1)
    return pulses, q_t, delta, eps


@pytest.mark.parametrize("shape", [(100, 400, 2, 1000), (5, 100, 4, 8192)])
def test_b1_b3_b2_at_slice_2_shapes(card, shape):
    pulses, q_t, delta, eps = slice2_inputs(*shape, card)
    B, L, P, M = shape
    f = tk.mean_fidelity_cuda(pulses, q_t, delta, eps)
    f32 = tk.mean_fidelity_plain(pulses, q_t, delta, eps)
    f64 = tk.mean_fidelity_plain(*(t.double() for t in (pulses, q_t, delta, eps)))
    torch.testing.assert_close(f, f32, rtol=0,
                               atol=max(TOL, 2 * float((f32.double() - f64).abs().max())))
    q = tk.propagate_mc_cuda(pulses, delta, eps)
    torch.testing.assert_close(q, tk.propagate_mc_plain(pulses, delta, eps), rtol=0,
                               atol=max(TOL, 1e-6 * L))
    g = torch.randn((B, M, 4), generator=torch.Generator(device=card).manual_seed(5),
                    device=card)
    got = tk.propagate_mc_vjp_cuda(pulses, delta, eps, g, q)
    torch.cuda.synchronize()
    exact = tk.propagate_mc_vjp_plain(*(t.double() for t in (pulses, delta, eps, g)))
    assert_vjp_close(got, tk.propagate_mc_vjp_plain(pulses, delta, eps, g), exact)


def test_grape_step_on_the_card(card):
    """One GRAPE training step at L = 400 through B1 (backward B3 + B2): the
    pulses' gradient within the rule above of autograd through the plain
    version, and one launch of each kernel per step."""
    from universal_quantum_optimal_control_tpu_torch.core import rotation_vector_to_quat
    from universal_quantum_optimal_control_tpu_torch.models import GRAPE
    from universal_quantum_optimal_control_tpu_torch.training import TrainConfig, Trainer

    B, M = 16, 512
    model = GRAPE(pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.035, 0.07))),
                  num_pulses=400, device=card)
    model.init_like_flax(torch.Generator(device=card).manual_seed(0))
    g = torch.Generator(device=card).manual_seed(1)
    rv = torch.cat([torch.nn.functional.normalize(torch.randn((B, 3), generator=g, device=card),
                                                  dim=-1),
                    6.0 * torch.rand((B, 1), generator=g, device=card)], dim=-1)
    qt = rotation_vector_to_quat(rv).contiguous()
    delta = torch.randn((B, M), generator=g, device=card)
    eps = 0.05 * torch.randn((B, M), generator=g, device=card)
    pulses = model(rv).detach().contiguous()
    grads = []
    for fn, dtype in ((tk.mean_fidelity_cuda, torch.float32),
                      (tk.mean_fidelity_plain, torch.float32),
                      (tk.mean_fidelity_plain, torch.float64)):
        p = pulses.to(dtype).requires_grad_(True)
        (grad,) = torch.autograd.grad(
            fn(p, qt.to(dtype), delta.to(dtype), eps.to(dtype)).mean(), p)
        grads.append(grad)
    e32 = float((grads[1].double() - grads[2]).abs().max())
    torch.testing.assert_close(grads[0], grads[1], rtol=1e-4, atol=max(1e-4, 2 * e32))
    tr = Trainer(model, TrainConfig(monte_carlo=M, batch_size=B, backend="pallas"),
                 device=card)
    counts = (tk.mean_fidelity_cuda.launches, tk.propagate_mc_cuda.launches,
              tk.propagate_mc_vjp_cuda.launches)
    before = model.fc2.weight.detach().clone()
    loss, fid = tr.train_step(rv, qt, (delta, eps))
    torch.cuda.synchronize()
    assert (tk.mean_fidelity_cuda.launches, tk.propagate_mc_cuda.launches,
            tk.propagate_mc_vjp_cuda.launches) == tuple(c + 1 for c in counts)
    assert bool(torch.isfinite(loss)) and 0.0 < float(fid) <= 1.0
    assert not torch.equal(before, model.fc2.weight.detach())


def test_sharded_objective_through_b1_on_one_card(card, tmp_path):
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).parent))
    import torch_mesh_worker as worker

    gen = torch.Generator().manual_seed(3)
    B, L, M = 40, 100, 1000
    u = torch.rand((B, L, 2), generator=gen)
    inp = {"pulses": torch.stack([-math.pi + 2 * math.pi * u[..., 0], 0.1 + 0.4 * u[..., 1]],
                                 -1).contiguous(),
           "q_t": torch.nn.functional.normalize(torch.randn((B, 4), generator=gen), dim=-1),
           "delta": torch.randn((B, M), generator=gen),
           "eps": 0.05 * torch.randn((B, M), generator=gen)}
    ranks = worker.spawn("objectives_card", 2, 1, 2, tmp_path, inp, timeout=240.0)
    p = inp["pulses"].to(card).requires_grad_(True)
    v = tk.mean_fidelity_cuda(p, *(inp[k].to(card) for k in ("q_t", "delta", "eps"))).mean()
    v.backward()
    g = p.grad.cpu()
    for res in ranks:
        assert all(n >= 1 for n in res["launches"]), res["launches"]
        assert abs(float(res["value"]) - float(v)) <= 2e-6
        assert float((res["grad"] - g).abs().max()) <= 1e-5 * float(g.abs().max())


def test_xla_remat_backend_on_cuda_tensors(card):
    from universal_quantum_optimal_control_tpu_torch.parallel import mean_fidelity_local

    pulses, q_t, delta, eps = inputs(2, 500, card, B=4, L=30)
    for c in (tk.mean_fidelity_cuda, tk.propagate_mc_cuda, tk.propagate_mc_vjp_cuda):
        c.launches = 0
    grads = {}
    for backend in ("xla_remat", "xla"):
        p = pulses.clone().requires_grad_(True)
        f = mean_fidelity_local(p, q_t, delta, eps, backend)
        f.mean().backward()
        grads[backend] = (f.detach(), p.grad)
    assert tk.mean_fidelity_cuda.launches == tk.propagate_mc_cuda.launches == 0
    assert float((grads["xla_remat"][0] - grads["xla"][0]).abs().max()) <= 1e-6
    assert float((grads["xla_remat"][1] - grads["xla"][1]).abs().max()) <= 1e-5


def test_figures_sweep_on_the_longest_score_table(card):
    from universal_quantum_optimal_control_tpu_torch.analysis import plots
    from universal_quantum_optimal_control_tpu_torch.analysis.score_pulses import \
        build_score_pulses

    table = build_score_pulses()["Z(pi/4)"]
    assert table.shape == (2019, 2)
    pulses = torch.as_tensor(table, device=card)
    q_t = torch.nn.functional.normalize(torch.ones(4, device=card), dim=0)
    tk.propagate_mc_cuda.launches = 0
    stds, mean, se = plots.fidelity_by_std(table, q_t, stds=[0.1, 1.0, 1.9], monte_carlo=4000,
                                           generator=torch.Generator(card).manual_seed(3),
                                           device=card)
    assert tk.propagate_mc_cuda.launches == 1
    nd, ne = plots._sweep_draws(torch.Generator(card).manual_seed(3), 3, 4000, 0.05)
    st = torch.as_tensor(stds, device=card)[:, None]
    ref = {}
    for dt in (torch.float32, torch.float64):
        q = tk.propagate_mc_plain(pulses[None].to(dt), (nd * st).reshape(1, -1).to(dt),
                                  ne.reshape(1, -1).to(dt))[0]
        ref[dt] = quat_fidelity(q, q_t[None].to(dt)).reshape(3, -1).mean(1)
    tol = max(TOL, 2 * float((ref[torch.float32].double() - ref[torch.float64]).abs().max()))
    assert float((torch.as_tensor(mean, device=card) - ref[torch.float32]).abs().max()) <= tol
    assert mean[0] > mean[2] and se[2] > 0


@pytest.mark.parametrize("P", [2, 4])
def test_bloch_endpoints_at_b3s_product(card, P):
    from universal_quantum_optimal_control_tpu_torch.analysis import bloch

    pulses, _, delta, eps = inputs(P, 12, card, B=1, L=100, seed=9)
    traj = bloch.bloch_trajectories(pulses[0], delta[0], eps[0], device=card)
    q = tk.propagate_mc_cuda(pulses, delta, eps)[0]
    end = bloch.quat_rotation_matrix(q)[..., 2].cpu()
    r0 = torch.tensor([0.0, 0.0, 1.0], dtype=torch.float64, device=card)
    end64 = bloch._trajectories(pulses[0].double(), delta[0].double(), eps[0].double(),
                                r0)[:, -1].cpu()
    tol = max(TOL, 2 * float((torch.as_tensor(traj[:, -1]).double() - end64).abs().max()))
    assert float((torch.as_tensor(traj[:, -1]) - end).abs().max()) <= tol
