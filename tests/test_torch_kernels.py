"""PyTorch port, kernels B1, B2 and B3: their plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU).

The card-only tests are in ``test_torch_gpu.py``.  Tolerance 1e-5 abs on
quaternions and fidelities, as ``tests/test_pallas_kernel.py`` holds the JAX kernels to the XLA path (the
Pallas kernels evaluate sin/cos by minimax polynomials, the plain versions
by libm; at L ≤ 8 the difference stays below 1e-5).  Gradients: rtol =
atol = 1e-4 on pulse and target gradients, rtol 1e-4 / atol 1e-5 on dδ and
dε, as the same file holds the JAX VJP kernel to ``jax.vjp`` of the XLA
scan (atol covers near-zero entries, rtol the O(1) ones whose f32
accumulation differs).
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import jax

from universal_quantum_optimal_control_tpu.core import propagate as jprop
from universal_quantum_optimal_control_tpu.ops import propagate_pallas as jpk
from universal_quantum_optimal_control_tpu.ops.propagate_pallas_bwd import (
    propagate_mc_vjp_pallas as jvjp)
from universal_quantum_optimal_control_tpu.parallel import mc_parallel as jmc
from universal_quantum_optimal_control_tpu_torch.ops import _build
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su2 as tk
from universal_quantum_optimal_control_tpu_torch.parallel import mean_fidelity_local

TOL = 1e-5
REPO = Path(__file__).resolve().parent.parent


def kernel_inputs(P, M, B=2, L=8, seed=0):
    rng = np.random.default_rng(100 * P + M + seed)
    cols = [rng.uniform(-np.pi, np.pi, (B, L))]
    if P >= 3:
        cols.append(rng.uniform(-0.3, 1.5, (B, L)))  # Ω < 0 exercises the clamp
    if P == 4:
        cols.append(rng.uniform(-1.0, 1.0, (B, L)))
    cols.append(rng.uniform(0.05, 0.5, (B, L)))
    pulses = np.stack(cols, axis=-1).astype(np.float32)
    delta = rng.standard_normal((B, M)).astype(np.float32)
    eps = (0.05 * rng.standard_normal((B, M))).astype(np.float32)
    q_t = rng.standard_normal((B, 4)).astype(np.float32)
    q_t /= np.linalg.norm(q_t, axis=-1, keepdims=True)
    return pulses, q_t, delta, eps


CASES = [(P, M) for P in (2, 3, 4) for M in (256, 200)]  # 200: ragged M


@pytest.mark.parametrize("P,M", CASES)
def test_b3_plain_matches_pallas_prop_kernel(P, M):
    pulses, _, delta, eps = kernel_inputs(P, M)
    with pltpu.force_tpu_interpret_mode():
        j = np.asarray(jpk.propagate_mc_pallas(jnp.asarray(pulses), jnp.asarray(delta),
                                               jnp.asarray(eps)))
    t = tk.propagate_mc_cuda(torch.from_numpy(pulses), torch.from_numpy(delta),
                             torch.from_numpy(eps)).numpy()
    assert t.shape == (2, M, 4)
    np.testing.assert_allclose(t, j, atol=TOL)


@pytest.mark.parametrize("P,M", CASES)
def test_b1_plain_matches_pallas_fid_kernel(P, M):
    pulses, q_t, delta, eps = kernel_inputs(P, M)
    with pltpu.force_tpu_interpret_mode():
        j = np.asarray(jpk.mean_fidelity_pallas(jnp.asarray(pulses), jnp.asarray(q_t),
                                                jnp.asarray(delta), jnp.asarray(eps)))
    t = tk.mean_fidelity_cuda(*(torch.from_numpy(a) for a in (pulses, q_t, delta, eps)))
    assert t.shape == (2,)
    np.testing.assert_allclose(t.numpy(), j, atol=TOL)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_mean_fidelity_local_backends_match_jax_xla(backend):
    pulses, q_t, delta, eps = kernel_inputs(2, 512, L=20, seed=1)
    j = np.asarray(jmc.mean_fidelity_local(*(jnp.asarray(a) for a in (pulses, q_t, delta, eps)),
                                           backend="xla"))
    t = mean_fidelity_local(*(torch.from_numpy(a) for a in (pulses, q_t, delta, eps)),
                            backend=backend)
    np.testing.assert_allclose(t.numpy(), j, atol=TOL)
    with pytest.raises(ValueError, match="backend"):
        mean_fidelity_local(*(torch.from_numpy(a) for a in (pulses, q_t, delta, eps)),
                            backend="tpu")


def assert_grads_close(got, want, names):
    """Pulse / target gradients at rtol = atol = 1e-4; dδ, dε at rtol 1e-4,
    atol 1e-5."""
    for name, a, b in zip(names, got, want):
        atol = 1e-5 if name in ("delta", "eps") else 1e-4
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("P,M", [(2, 256), (2, 200), (3, 200), (4, 200)])
def test_b2_plain_matches_pallas_bwd_kernel_and_xla_vjp(P, M):
    pulses, _, delta, eps = kernel_inputs(P, M)
    g = np.random.default_rng(P + M).standard_normal((2, M, 4)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (pulses, delta, eps)]
    with pltpu.force_tpu_interpret_mode():
        j_kernel = jvjp(*jargs, jnp.asarray(g))
    _, vjp = jax.vjp(lambda p, d, e: jprop.propagate_mc(p, d, e, method="scan"), *jargs)
    j_xla = vjp(jnp.asarray(g))
    t = tk.propagate_mc_vjp_cuda(*(torch.from_numpy(a) for a in (pulses, delta, eps, g)))
    assert [tuple(x.shape) for x in t] == [(2, 8, P), (2, M), (2, M)]
    names = ("pulses", "delta", "eps")
    assert_grads_close([x.numpy() for x in t], j_kernel, names)
    assert_grads_close([x.numpy() for x in t], j_xla, names)


@pytest.mark.parametrize("P,M", CASES)
def test_b2_with_the_product_matches_pallas_bwd_kernel(P, M):
    """B2 handed B3's product, as a caller that holds it passes it (here the
    plain propagator's): the port against the JAX ``_bwd_kernel`` in
    interpret mode on the same numpy-seeded inputs, at the tolerances
    above; the same values as without the product."""
    pulses, _, delta, eps = kernel_inputs(P, M, seed=5)
    g = np.random.default_rng(7 * P + M).standard_normal((2, M, 4)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        j_kernel = jvjp(*(jnp.asarray(a) for a in (pulses, delta, eps, g)))
    args = [torch.from_numpy(a) for a in (pulses, delta, eps, g)]
    q = tk.propagate_mc_plain(*args[:3])
    t = tk.propagate_mc_vjp_cuda(*args, q)
    assert [tuple(x.shape) for x in t] == [(2, 8, P), (2, M), (2, M)]
    assert_grads_close([x.numpy() for x in t], j_kernel, ("pulses", "delta", "eps"))
    for a, b in zip(t, tk.propagate_mc_vjp_cuda(*args)):
        assert torch.equal(a, b)


# Ω ≤ 0 with Δ + δ = 0 exactly in the first segment: the axis norm is 0
DEGENERATE = (np.asarray([[[0.3, -0.1, 0.3, 0.4], [1.0, 0.8, -0.2, 0.3]]], np.float32),
              np.asarray([[-0.3, 0.5]], np.float32), np.asarray([[0.01, 0.02]], np.float32))


def test_b2_plain_at_zero_axis_norm_matches_pallas_bwd_kernel():
    """JAX's XLA VJP is NaN here (the square root's derivative at 0); the
    TPU kernel floors the squared norm and gives the finite limit, and so
    do the port's plain version and B2."""
    pulses, delta, eps = DEGENERATE
    g = np.random.default_rng(0).standard_normal((1, 2, 4)).astype(np.float32)
    jargs = [jnp.asarray(a) for a in (pulses, delta, eps, g)]
    _, vjp = jax.vjp(lambda p, d, e: jprop.propagate_mc(p, d, e, method="scan"), *jargs[:3])
    assert np.isnan(np.asarray(vjp(jargs[3])[1])[0, 0])
    with pltpu.force_tpu_interpret_mode():
        j_kernel = jvjp(*jargs)
    t = tk.propagate_mc_vjp_cuda(*(torch.from_numpy(a) for a in (pulses, delta, eps, g)))
    assert all(bool(torch.isfinite(x).all()) for x in t)
    assert_grads_close([x.numpy() for x in t], j_kernel, ("pulses", "delta", "eps"))


@pytest.mark.parametrize("P", [2, 3, 4])
def test_b1_gradient_matches_jax_grad_of_pallas_objective(P):
    """All four inputs' gradients under a per-target cotangent ḡ (B,), the
    input the trainer's CVaR path hands back."""
    pulses, q_t, delta, eps = kernel_inputs(P, 200, seed=3)
    gbar = np.asarray([0.7, -1.3], np.float32)
    with pltpu.force_tpu_interpret_mode():
        _, vjp = jax.vjp(jpk.mean_fidelity_pallas,
                         *(jnp.asarray(a) for a in (pulses, q_t, delta, eps)))
        j = vjp(jnp.asarray(gbar))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (pulses, q_t, delta, eps)]
    t = torch.autograd.grad(tk.mean_fidelity_cuda(*leaves), leaves, torch.from_numpy(gbar))
    assert_grads_close([x.numpy() for x in t], j, ("pulses", "q_target", "delta", "eps"))


def test_wrappers_count_no_launch_on_cpu():
    pulses, q_t, delta, eps = (torch.from_numpy(a) for a in kernel_inputs(2, 64))
    counters = (tk.propagate_mc_cuda, tk.mean_fidelity_cuda, tk.propagate_mc_vjp_cuda)
    before = [c.launches for c in counters]
    tk.propagate_mc_cuda(pulses, delta, eps)
    tk.propagate_mc_vjp_cuda(pulses, delta, eps, torch.ones(2, 64, 4))
    leaf = pulses.clone().requires_grad_(True)
    tk.mean_fidelity_cuda(leaf, q_t, delta, eps).sum().backward()
    assert leaf.grad is not None
    assert [c.launches for c in counters] == before


def test_kernel_input_checks():
    pulses, q_t, delta, eps = (torch.from_numpy(a) for a in kernel_inputs(3, 64))
    assert tk._check(pulses, delta, eps, q_t) == (2, 8, 3, 64)
    with pytest.raises(TypeError, match="float32"):
        tk._check(pulses.double(), delta, eps)
    with pytest.raises(ValueError, match="contiguous"):
        tk._check(pulses, delta.t().contiguous().t(), eps)
    with pytest.raises(ValueError, match="P in"):
        tk._check(torch.zeros(2, 8, 5), delta, eps)
    with pytest.raises(ValueError, match=r"\(B, M\)"):
        tk._check(pulses, delta[:1].contiguous(), eps)
    with pytest.raises(ValueError, match="q_target"):
        tk._check(pulses, delta, eps, q_t[:1].contiguous())
    # the row's length is the card's to refuse: every launcher opts in to
    # more than 48 KB of shared memory and raises past the card's limit
    # (tests/test_torch_gpu.py holds B1 and B2 at that limit)
    assert tk._check(torch.zeros(2, 4000, 4), delta, eps) == (2, 4000, 4, 64)
    # B2: g and B3's product q are checked
    g = torch.zeros(2, 64, 4)
    assert tk._check(torch.zeros(2, 400, 4), delta, eps, g=g) == (2, 400, 4, 64)
    assert tk._check(torch.zeros(2, 4000, 4), delta, eps, g=g) == (2, 4000, 4, 64)
    assert tk._check(pulses, delta, eps, g=g, q=g) == (2, 8, 3, 64)
    with pytest.raises(ValueError, match="g must be"):
        tk._check(pulses, delta, eps, g=g[:, :10].contiguous())
    with pytest.raises(ValueError, match="q must be"):
        tk._check(pulses, delta, eps, g=g, q=g[:, :10].contiguous())
    with pytest.raises(TypeError, match="float32"):
        tk._check(pulses, delta, eps, g=g, q=g.double())


def test_build_is_one_nvcc_call_into_an_ignored_directory():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-Xcompiler -fPIC" in flags and "-O3" in flags
    assert "--use_fast_math" not in flags  # sincosf stays accurate
    # one nvcc call per source (su2: B1, B2, B3; su4: B4, B6, B7; su4_bwd:
    # B5), started together
    assert set(_build.SOURCES) == {"su2", "su4", "su4_bwd"}
    for name, src in _build.SOURCES.items():
        assert src.exists()
        assert _build.library_path(name) == REPO / "build" / "torch_kernels" / f"libuqoc_{name}.so"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build_libraries()
