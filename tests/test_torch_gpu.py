"""PyTorch port on a CUDA card: the hand-written kernels B1 and B3 against
their plain versions, their input checks and their launch counters.

This file imports nothing of JAX, so it also runs where JAX is absent:

    python -m pytest tests/test_torch_gpu.py -m gpu --noconftest -q

(``--noconftest``: the suite's conftest configures JAX).  Without a card
every test skips.  Tolerance 1e-5 abs on quaternions and fidelities at
L = 7, as ``tests/test_pallas_kernel.py`` holds the JAX kernels.
"""

import math

import pytest
import torch

from universal_quantum_optimal_control_tpu_torch.ops import propagate_su2 as tk

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
