"""PyTorch port, kernels B1 and B3: their plain versions against the JAX
package's Pallas kernels (interpret mode on the CPU).

The card-only tests are in ``test_torch_gpu.py``.  Tolerance 1e-5 abs on
quaternions and fidelities, as ``tests/test_pallas_kernel.py`` holds the JAX kernels to the XLA path (the
Pallas kernels evaluate sin/cos by minimax polynomials, the plain versions
by libm; at L ≤ 8 the difference stays below 1e-5).
"""

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from universal_quantum_optimal_control_tpu.ops import propagate_pallas as jpk
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


def test_wrappers_count_no_launch_on_cpu():
    pulses, q_t, delta, eps = (torch.from_numpy(a) for a in kernel_inputs(2, 64))
    before = (tk.propagate_mc_cuda.launches, tk.mean_fidelity_cuda.launches)
    tk.propagate_mc_cuda(pulses, delta, eps)
    tk.mean_fidelity_cuda(pulses, q_t, delta, eps)
    assert (tk.propagate_mc_cuda.launches, tk.mean_fidelity_cuda.launches) == before


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
    with pytest.raises(ValueError, match="shared-memory"):
        tk._check(torch.zeros(2, 4000, 4), delta, eps)


def test_build_is_one_nvcc_call_into_an_ignored_directory():
    flags = " ".join(_build.NVCC_FLAGS)
    assert "-gencode arch=compute_90a,code=sm_90a" in flags
    assert "-shared" in flags and "-Xcompiler -fPIC" in flags and "-O3" in flags
    assert "--use_fast_math" not in flags  # sincosf stays accurate
    assert _build.LIBRARY == REPO / "build" / "torch_kernels" / "libuqoc_su2.so"
    assert "build/" in (REPO / ".gitignore").read_text().split()
    assert _build.SOURCE.exists()
    if shutil.which("nvcc") is None and not Path("/usr/local/cuda/bin/nvcc").exists():
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build_library()
