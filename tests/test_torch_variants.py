"""PyTorch port, slice 2: the single-qubit serving map (``demo/app.py``)
against the JAX package's.

The six variants the port adds (``small_20``, the ``length_400`` blend,
``length_100_p4``, ``length_400_p4`` and the bundle variants
``length_100_gates`` / ``length_100_gates_p4``) serve f32 pulses within
1e-5 of the JAX ``Pipeline`` on the same weights (φ compared modulo 2π) on
3 random targets, away from the score embedding's θ = π pole; a bundle
variant serves its bundle's table, bit for bit, for a request within 1e-5
of a named gate and its model's pulses for one past that edge, as the JAX
``_gate_bundle_lookup`` decides; ``default_variant`` is the JAX one.
"""

import functools
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.demo import app as japp
from universal_quantum_optimal_control_tpu.models import Pipeline as JPipeline
from universal_quantum_optimal_control_tpu.models import UniversalQOCTransformer as JModel
from universal_quantum_optimal_control_tpu.models import normalize_pulse_space as jnormalize
from universal_quantum_optimal_control_tpu.models.serialization import load_params_npz_tree
from universal_quantum_optimal_control_tpu.utils import load_model_params as jload_config
from universal_quantum_optimal_control_tpu.workloads import finetune_gates as jft
from universal_quantum_optimal_control_tpu.workloads.universal_single_qubit import \
    load_base_pulse as jload_base
from universal_quantum_optimal_control_tpu_torch.demo import app as tapp

NEW_VARIANTS = ("small_20", "length_400", "length_100_p4", "length_400_p4",
                "length_100_gates", "length_100_gates_p4")
TOL = 1e-5


def wrapped_err(a, b):
    d = np.remainder(a[..., 0] - b[..., 0] + np.pi, 2 * np.pi) - np.pi
    return max(float(np.abs(d).max()), float(np.abs(a[..., 1:] - b[..., 1:]).max()))


def random_targets(n=3, seed=4):
    rng = np.random.default_rng(seed)
    axes = rng.standard_normal((n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return np.concatenate([axes, rng.uniform(0.3, 2.5, (n, 1))], 1).astype(np.float32)


@functools.lru_cache(maxsize=None)
def jax_pipeline(config, checkpoint, base):
    """The JAX package's f32 Pipeline of a variant's model (its demo serves
    bf16; the weights are read without an init)."""
    mp = jload_config(config)
    mp["pulse_space"] = jnormalize(mp["pulse_space"])
    base_pulse = None if base is None else jnp.asarray(jload_base(base))
    mp["finetune"] = base_pulse is not None
    return JPipeline(JModel(**mp, dtype=jnp.float32), load_params_npz_tree(checkpoint),
                     base_pulse=base_pulse)


def jax_pulses(variant, rv):
    spec = japp.MODEL_VARIANTS[variant]
    return np.asarray(jax_pipeline(spec["config"], spec["checkpoint"],
                                   spec.get("base_pulse"))(rv))


def test_variant_map_is_the_jax_map():
    """Every JAX variant is served, from the same files."""
    assert set(tapp.MODEL_VARIANTS) == set(japp.MODEL_VARIANTS)
    for name, spec in japp.MODEL_VARIANTS.items():
        port = tapp.MODEL_VARIANTS[name]
        assert set(port) == set(spec), name
        for key, path in spec.items():
            assert Path(port[key]).resolve() == Path(path).resolve(), (name, key)


@pytest.mark.artifacts
@pytest.mark.parametrize("variant", NEW_VARIANTS)
def test_variant_pulses_match_jax(variant):
    rv = random_targets()
    pipe = tapp.load_pipeline(variant, device="cpu", dtype=torch.float32)
    got = pipe(rv).numpy()
    want = jax_pulses(variant, rv)
    assert got.shape == want.shape == (3, pipe.model.max_pulses, pipe.model.param_dim)
    assert wrapped_err(got, want) <= TOL
    if variant == "length_400":
        # the blend 0.2 · model + base, the base loaded once
        assert pipe.model.finetune
        np.testing.assert_array_equal(
            pipe.base_pulse.numpy(), jload_base(japp.MODEL_VARIANTS[variant]["base_pulse"]))
        assert float(got[..., -1].min()) >= 0.0  # the head's relu on τ


@pytest.mark.artifacts
@pytest.mark.parametrize("variant", ["length_100_gates", "length_100_gates_p4"])
def test_bundle_lookup_on_both_sides_of_the_edge(variant):
    """The match is ``np.allclose(..., atol=1e-5)`` on (n, θ), as in the
    JAX map: a component that is 0 in the gate may be off by 1e-5 (here
    5e-6 hits, 2e-5 misses) and θ by 1e-5 + 1e-5·|θ|.  A hit serves the
    bundle's table as it is stored, a miss the variant's model."""
    tables, meta = jft.load_gate_bundle(japp.MODEL_VARIANTS[variant]["gate_bundle"])
    for name, rv in zip(meta["gates"], meta["rotation_vectors"]):
        zero = [i for i in range(3) if rv[i] == 0.0][0]
        rv = np.asarray([rv], np.float32)
        for shift, hit in ((0.0, True), (5e-6, True), (2e-5, False), (-2e-5, False)):
            near = rv.copy()
            near[0, zero] += shift
            got = tapp._gate_bundle_lookup(variant, near)
            want = japp._gate_bundle_lookup(variant, near)
            assert (got is not None) == (want is not None) == hit, (name, shift)
            if hit:
                assert got.dtype == np.float32
                np.testing.assert_array_equal(got, tables[name])
        theta_miss = rv.copy()
        theta_miss[0, 3] += 1e-5 + 2e-5 * abs(rv[0, 3])
        assert tapp._gate_bundle_lookup(variant, theta_miss) is None
        assert japp._gate_bundle_lookup(variant, theta_miss) is None
    # compute_pulses: X exactly → the table; X(π + 1e-4) → the model's pulses
    served, q = tapp.compute_pulses(variant, 1.0, 0.0, 0.0, math.pi, device="cpu",
                                    dtype=torch.float32)
    np.testing.assert_array_equal(served, tables["X"])
    np.testing.assert_allclose(q.numpy(), [0.0, 1.0, 0.0, 0.0], atol=1e-6)
    off, _ = tapp.compute_pulses(variant, 1.0, 0.0, 0.0, math.pi + 1e-4, device="cpu",
                                 dtype=torch.float32)
    model = tapp.load_pipeline(variant, device="cpu", dtype=torch.float32)
    rv_off = np.asarray([[1.0, 0.0, 0.0, math.pi + 1e-4]], np.float32)
    np.testing.assert_array_equal(off, model(rv_off)[0].numpy())
    assert not np.array_equal(off, tables["X"])


def test_default_variant_is_the_jax_one():
    assert tapp.default_variant() == japp.default_variant() == "length_100"


def test_model_variants_without_a_bundle_never_look_one_up():
    rv = np.asarray([[1.0, 0.0, 0.0, math.pi]], np.float32)
    for name in ("length_100", "small_20", "length_400", "length_100_p4"):
        assert tapp._gate_bundle_lookup(name, rv) is None
