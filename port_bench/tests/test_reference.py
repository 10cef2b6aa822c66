"""The frozen reference against the program's plain versions, at small
sizes on the CPU (they are written apart; they must agree)."""

import copy
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from port_bench import inputs  # noqa: E402
from port_bench.reference import kak, model as ref_model, su2 as ref_su2, su4 as ref_su4  # noqa: E402
from port_bench.reference.train import learning_rate, sharp_loss  # noqa: E402

from universal_quantum_optimal_control_tpu_torch.core import su4 as port_su4  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.data.su4_targets import kak_input_tokens  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.models import (  # noqa: E402
    TwoQubitQOCTransformer, UniversalQOCTransformer, normalize_pulse_space)
from universal_quantum_optimal_control_tpu_torch.ops.propagate_su2 import mean_fidelity_plain  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.ops.propagate_su4 import (  # noqa: E402
    mean_fidelity_su4_plain)
from universal_quantum_optimal_control_tpu_torch.core.objectives import sharp_loss as port_sharp  # noqa: E402
from universal_quantum_optimal_control_tpu_torch.training.trainer import (  # noqa: E402
    TrainConfig, learning_rate_at)

CPU = torch.device("cpu")


def _config(name, **small):
    cfg = json.loads((REPO / "port_bench" / "configs" / f"{name}.json").read_text())
    cfg = copy.deepcopy(cfg)
    cfg.update(small)
    return cfg


def test_su2_mean_fidelity_matches_the_plain_version():
    gen = torch.Generator().manual_seed(3)
    pulses = inputs.pulse_tables(gen, (3, 7), {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]})
    _, q = inputs.rotations(gen, 3)
    delta, eps = torch.randn((3, 50), generator=gen), 0.05 * torch.randn((3, 50), generator=gen)
    got = ref_su2.mean_fidelity(pulses, q, delta, eps)
    np.testing.assert_allclose(got, mean_fidelity_plain(pulses, q, delta, eps), atol=2e-6)


def test_su4_mean_fidelity_matches_the_plain_version():
    cfg = _config("two_qubit_d2_kak")
    s = cfg["system"]
    gen = torch.Generator().manual_seed(4)
    pulses = inputs.pulse_tables(gen, (2, 5), cfg["pulse_space"])
    target = inputs.pack(inputs.su4_targets(1, 2, s))
    d1, d2, e = (torch.randn((2, 16), generator=gen) * x for x in (0.2, 0.2, 0.05))
    system = port_su4.TwoQubitSystem(xtalk=s["xtalk"], coupling=s["coupling"], drive2=True)
    want = mean_fidelity_su4_plain(pulses, target[:, 0].contiguous(), target[:, 1].contiguous(),
                                   d1, d2, e, system)
    np.testing.assert_allclose(ref_su4.mean_fidelity(pulses, target, d1, d2, e, s), want,
                               atol=2e-6)


def test_su4_targets_are_unitary():
    U = inputs.su4_targets(7, 6, _config("two_qubit_d2_kak")["system"])
    np.testing.assert_allclose(U @ U.conj().transpose(0, 2, 1), np.broadcast_to(np.eye(4), U.shape),
                               atol=1e-12)


def test_kak_tokens_match_the_program():
    U = inputs.unpack(inputs.pack(inputs.su4_targets(2, 8, _config("two_qubit_d2_kak")["system"])))
    np.testing.assert_array_equal(kak.kak_input_tokens(U), kak_input_tokens(U))


def _weights(model, seed):
    shapes = [(k, tuple(v.shape)) for k, v in model.state_dict().items()]
    return inputs.make_weights(shapes, seed, CPU)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_su2_model_matches_the_program(dtype):
    cfg = _config("length_100", max_pulses=6, d_model=32, n_layers=2, n_heads=4)
    port = UniversalQOCTransformer(pulse_space=normalize_pulse_space(cfg["pulse_space"]),
                                   max_pulses=6, d_model=32, n_layers=2, n_heads=4,
                                   dtype=dtype, device=CPU)
    w = _weights(port, 5)
    assert [k for k, _ in ref_model.parameter_shapes(32, 2, 12)] == list(w)
    port.load_state_dict(w)
    rv, _ = inputs.rotations(torch.Generator().manual_seed(1), 5)
    for train in (False, True):
        port.train(train)
        g1, g2 = (torch.Generator().manual_seed(9) if train else None for _ in range(2))
        want = port(rv, generator=g1)
        got = ref_model.pulses_su2(w, rv, cfg, dtype, "f32", g2)
        np.testing.assert_allclose(got.detach(), want.detach(), atol=2e-5 if dtype == torch.float32 else 5e-2)


def test_su4_model_matches_the_program():
    cfg = _config("two_qubit_d2_kak", max_pulses=5, d_model=32, n_layers=2, n_heads=4)
    port = TwoQubitQOCTransformer(pulse_space=normalize_pulse_space(cfg["pulse_space"]),
                                  max_pulses=5, d_model=32, n_layers=2, n_heads=4,
                                  dtype=torch.float32, kak_tokens=True, device=CPU).train()
    w = _weights(port, 6)
    port.load_state_dict(w)
    U = inputs.su4_targets(3, 4, cfg["system"])
    tokens = torch.from_numpy(kak.kak_input_tokens(U))
    want = port(tokens, generator=torch.Generator().manual_seed(2))
    got = ref_model.pulses_su4(w, tokens, cfg, torch.float32, "f32",
                               torch.Generator().manual_seed(2))
    np.testing.assert_allclose(got.detach(), want.detach(), atol=2e-5)


def test_loss_and_schedule_match_the_program():
    f = torch.linspace(0.5, 0.999, 11)
    np.testing.assert_allclose(sharp_loss(f, 0.99, 100.0), port_sharp(f, 0.99, 100.0), rtol=1e-6)
    train = {"learning_rate": 1e-4, "lr_schedule": "cosine", "lr_schedule_steps": 4000}
    cfg = TrainConfig(learning_rate=1e-4, lr_schedule="cosine", lr_schedule_steps=4000)
    for step in (0, 1, 2, 199, 200, 1000, 3999, 5000):
        assert learning_rate(train, step) == pytest.approx(learning_rate_at(cfg, step), rel=1e-12)
