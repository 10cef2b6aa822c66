"""PyTorch port, the training side of slice 4: ``utils/config.py::RunConfig``,
``workloads/run.py``, ``models/serialization.py::save_params_npz`` /
``params_to_jax`` / ``load_params_npz_tree``, the band checkpoint's model
metadata and ``workloads/export_npz.py``, on the CPU at tiny widths.

The writer is held to the JAX package's array for array: JAX parameters
carried into the port (``params_from_jax``) and written back give the same
keys, dtypes and arrays as the JAX ``save_params_npz`` for f32, f16 and
int8 (exactly: the same numpy arithmetic in the same layout); re-exporting
the shipped ``demo/weights/length100.npz`` (int8) gives its int8 tensors
exactly and its scales within 1 ulp.  An exported band checkpoint serves
through the port's demo loader within 1e-6 of the trainer's own eval-mode
pulses (the same f32 weights and arithmetic).
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from universal_quantum_optimal_control_tpu.models import UniversalQOCTransformer as JModel
from universal_quantum_optimal_control_tpu.models.serialization import _flatten
from universal_quantum_optimal_control_tpu.models.serialization import (
    load_params_npz_tree as j_load_tree)
from universal_quantum_optimal_control_tpu.models.serialization import (
    save_params_npz as j_save_npz)
from universal_quantum_optimal_control_tpu.utils.config import RunConfig as JRunConfig
from universal_quantum_optimal_control_tpu_torch.demo import app
from universal_quantum_optimal_control_tpu_torch.models import (GRAPE, TwoQubitQOCTransformer,
                                                                UniversalQOCTransformer,
                                                                load_params_npz,
                                                                load_params_npz_tree,
                                                                params_from_jax, params_to_jax,
                                                                save_params_npz)
from universal_quantum_optimal_control_tpu_torch.models.serialization import _quantize_int8
from universal_quantum_optimal_control_tpu_torch.training import (restore_checkpoint,
                                                                  save_checkpoint)
from universal_quantum_optimal_control_tpu_torch.utils import RunConfig, load_run_config
from universal_quantum_optimal_control_tpu_torch.workloads import export_npz, run
from universal_quantum_optimal_control_tpu_torch.workloads import universal_single_qubit as cli

SHIPPED = (Path(__file__).resolve().parent.parent / "universal_quantum_optimal_control_tpu"
           / "demo" / "weights" / "length100.npz")
TINY = dict(num_qubits=1, pulse_space=(("phi", (-3.15, 3.15)), ("tau", (0.1, 0.5))),
            max_pulses=8, d_model=32, n_layers=2, n_heads=4, dropout=0.1)
TINY_JSON = {"num_qubits": 1, "pulse_space": {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]},
             "max_pulses": 8, "d_model": 32, "n_layers": 2, "n_heads": 4,
             "dropout": 0.1, "finetune": None}
RUN_JSON = {
    "model": {k: v for k, v in TINY_JSON.items() if k != "num_qubits"},
    "train": {"monte_carlo": 16, "batch_size": 4, "epochs": 1, "learning_rate": 1e-3,
              "backend": "pallas", "tail_focus": 0.25},
    "curriculum": [{"delta_std": 0.4}, [0.7, 0.02], {"delta_std": 1.0, "epsilon_std": 0.05}],
    "train_set_size": 16, "eval_set_size": 4, "save_path": None,
}


@pytest.fixture(scope="module")
def jax_params():
    return jax.jit(JModel(**TINY, dtype=jnp.float32).init)(jax.random.PRNGKey(7),
                                                           jnp.zeros((1, 4)))


# ---------------------------------------------------------------------------
# RunConfig and the runner
# ---------------------------------------------------------------------------

def test_run_config_from_dict_matches_jax():
    t = RunConfig.from_dict(RUN_JSON)
    j = JRunConfig.from_dict(json.loads(json.dumps(RUN_JSON)))
    assert t.to_dict() == j.to_dict()
    assert RunConfig.from_dict({"model": {}}).to_dict() == \
        JRunConfig.from_dict({"model": {}}).to_dict()
    assert RUN_JSON["model"]["pulse_space"]["phi"] == [-3.15, 3.15]  # input left as it was


def test_load_run_config_reads_the_json(tmp_path):
    path = tmp_path / "run.json"
    path.write_text(json.dumps(RUN_JSON))
    assert load_run_config(str(path)).to_dict() == RunConfig.from_dict(RUN_JSON).to_dict()


@pytest.mark.parametrize("workload", run.WORKLOADS)
def test_run_completes(tmp_path, capsys, workload):
    cfg = json.loads(json.dumps(RUN_JSON))
    cfg["workload"] = workload
    if workload == "grape_single_qubit":
        cfg["model"] = {"pulse_space": {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]},
                        "num_pulses": 6}
    elif workload == "two_qubit":
        cfg["model"] = {"pulse_space": {"phi": [-3.15, 3.15], "tau": [0.1, 0.5]},
                        "max_pulses": 4, "d_model": 16, "n_layers": 1, "n_heads": 2}
        cfg["train"]["monte_carlo"] = 8
    path = tmp_path / "run.json"
    path.write_text(json.dumps(cfg))
    best, history = run.main([str(path), "--device", "cpu", "--save_path",
                              str(tmp_path / "out"), "--num_epoch", "1"])
    assert "best eval fidelity across bands" in capsys.readouterr().out
    assert len(history["bands"]) == 3 and 0.0 < best <= 1.0
    assert (tmp_path / "out" / "metrics.csv").exists()
    assert len(list((tmp_path / "out").glob("band*/params.pt"))) == 3


def test_run_rejects_unknown_workloads_and_missing_files(tmp_path):
    path = tmp_path / "run.json"
    path.write_text(json.dumps({**RUN_JSON, "workload": "three_qubit"}))
    with pytest.raises(ValueError, match="unknown workload: three_qubit"):
        run.main([str(path), "--device", "cpu"])
    with pytest.raises(FileNotFoundError):
        run.main([str(tmp_path / "absent.json"), "--device", "cpu"])


# ---------------------------------------------------------------------------
# the .npz writer
# ---------------------------------------------------------------------------

def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("dtype", [None, np.float32, np.float16, "int8"])
def test_save_params_npz_matches_the_jax_writer(tmp_path, jax_params, dtype):
    sd = params_from_jax(_flatten(jax_params))
    j_save_npz(str(tmp_path / "jax.npz"), jax_params, dtype=dtype)
    save_params_npz(str(tmp_path / "port.npz"), sd, dtype=dtype, n_heads=TINY["n_heads"])
    j, t = _npz(tmp_path / "jax.npz"), _npz(tmp_path / "port.npz")
    assert set(t) == set(j)
    if dtype == "int8":
        assert any(k.endswith("!scale") for k in t)
    for k in j:
        assert t[k].dtype == j[k].dtype and t[k].shape == j[k].shape, k
        np.testing.assert_array_equal(t[k], j[k], err_msg=k)


def test_reexport_of_the_shipped_int8_artifact(tmp_path):
    sd = params_from_jax(load_params_npz(str(SHIPPED)))
    save_params_npz(str(tmp_path / "again.npz"), sd, dtype="int8", n_heads=16)
    want, got = _npz(SHIPPED), _npz(tmp_path / "again.npz")
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        if k.endswith("!scale"):
            ulps = np.abs(got[k].view(np.int32).astype(np.int64) - v.view(np.int32))
            assert int(ulps.max()) <= 1, k
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def _models():
    gen = torch.Generator().manual_seed(1)
    out = {
        "universal": (UniversalQOCTransformer(**TINY, device="cpu"), TINY["n_heads"]),
        "two_qubit": (TwoQubitQOCTransformer(max_pulses=4, d_model=16, n_layers=1, n_heads=2,
                                             kak_tokens=True, device="cpu"), 2),
        "grape_mlp": (GRAPE(num_pulses=5, device="cpu"), None),
        "grape_direct": (GRAPE(num_pulses=5, direct=True, num_targets=3, device="cpu"), None),
    }
    for model, _ in out.values():
        model.init_like_flax(gen)
    return out


@pytest.mark.parametrize("kind", ["universal", "two_qubit", "grape_mlp", "grape_direct"])
def test_params_to_jax_inverts_params_from_jax(kind):
    model, n_heads = _models()[kind]
    sd = model.state_dict()
    flat = params_to_jax(sd, n_heads)
    assert all(k.startswith("params//") and v.dtype == np.float32 for k, v in flat.items())
    back = params_from_jax(flat)
    assert set(back) == set(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


def test_params_to_jax_gives_the_flax_tree(jax_params):
    """Keys and shapes of a port model's parameters in the Flax layout are
    the JAX model's."""
    want = {k: np.asarray(v) for k, v in _flatten(jax_params).items()}
    got = params_to_jax(params_from_jax(want), TINY["n_heads"])
    assert {k: v.shape for k, v in got.items()} == {k: v.shape for k, v in want.items()}
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    with pytest.raises(ValueError, match="n_heads"):
        params_to_jax(params_from_jax(want))


def test_load_params_npz_tree_matches_jax(tmp_path, jax_params):
    path = str(tmp_path / "tree.npz")
    j_save_npz(path, jax_params, dtype="int8")
    t, j = load_params_npz_tree(path), j_load_tree(path)

    def leaves(tree, prefix=()):
        for k, v in tree.items():
            yield from (leaves(v, prefix + (k,)) if isinstance(v, dict) else [(prefix + (k,), v)])

    jl = dict(leaves(j))
    tl = dict(leaves(t))
    assert set(tl) == set(jl)
    for k, v in jl.items():
        assert tl[k].dtype == torch.float32
        np.testing.assert_array_equal(tl[k].numpy(), np.asarray(v), err_msg=str(k))


# ---------------------------------------------------------------------------
# band checkpoint → .npz export
# ---------------------------------------------------------------------------

TAG = "band2_delta1_eps0.05"


@pytest.fixture(scope="module")
def band_checkpoint(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    config = tmp / "tiny.json"
    config.write_text(json.dumps(TINY_JSON))
    trainer, _ = cli.run(cli.build_parser().parse_args(
        ["--device", "cpu", "--num_epoch", "1", "--batch_size", "8", "--monte_carlo", "16",
         "--train_size", "16", "--eval_size", "8", "--config", str(config), "--save_path",
         str(tmp / "run")]))
    return tmp, config, trainer


def test_checkpoint_metadata_records_the_model(band_checkpoint):
    tmp, _, _ = band_checkpoint
    _, meta = restore_checkpoint(str(tmp / "run"), TAG)
    assert meta["model"]["class"] == "UniversalQOCTransformer"
    assert {k: meta["model"][k] for k in ("d_model", "n_layers", "n_heads", "max_pulses")} == \
        {"d_model": 32, "n_layers": 2, "n_heads": 4, "max_pulses": 8}


@pytest.mark.parametrize("dtype", ["f32", "f16", "int8"])
def test_export_cli_round_trips(band_checkpoint, dtype, monkeypatch):
    tmp, config, trainer = band_checkpoint
    out = str(tmp / f"{dtype}.npz")
    export_npz.main([f"{tmp / 'run'}:{TAG}", out, "--dtype", dtype])
    params, _ = restore_checkpoint(str(tmp / "run"), TAG)
    flat = params_to_jax(params, TINY["n_heads"])
    loaded = load_params_npz(out)
    # the JAX package reads the export
    jt = j_load_tree(out)
    for k, v in loaded.items():
        node = jt
        for part in k.split("//"):
            node = node[part]
        np.testing.assert_array_equal(np.asarray(node), v, err_msg=k)
    if dtype == "f32":
        # served through the port's demo loader, as the trainer serves it
        monkeypatch.setitem(app.MODEL_VARIANTS, "tiny_export",
                            {"config": str(config), "checkpoint": out})
        pipe = app.load_pipeline("tiny_export", device="cpu", dtype=torch.float32)
        rv = np.array([[1.0, 0.0, 0.0, np.pi], [0.0, 0.6, 0.8, 1.1]], np.float32)
        trainer.model.load_state_dict(params)
        want = trainer.predict(torch.from_numpy(rv))
        np.testing.assert_allclose(pipe(rv).cpu().numpy(), want.numpy(), atol=1e-6)
        for k, v in flat.items():
            np.testing.assert_array_equal(loaded[k], v, err_msg=k)
        return
    for k, v in flat.items():
        if dtype == "int8" and v.ndim >= 2 and v.size >= 4096:
            q, scale = _quantize_int8(v)
            want = q.astype(np.float32) * scale
        else:
            want = v.astype(np.float16).astype(np.float32)
        np.testing.assert_array_equal(loaded[k], want, err_msg=k)


def test_export_without_the_model_metadata_raises(tmp_path, band_checkpoint):
    tmp, _, _ = band_checkpoint
    params, _ = restore_checkpoint(str(tmp / "run"), TAG)
    save_checkpoint(str(tmp_path), params, tag="bare", metadata={"best_fid": 0.5})
    with pytest.raises(ValueError, match="n_heads"):
        export_npz.main([f"{tmp_path}:bare", str(tmp_path / "x.npz")])
