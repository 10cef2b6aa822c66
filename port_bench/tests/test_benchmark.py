"""CPU tests of the benchmark's own files: every name resolves, the frozen
yardstick matches the program's counts, nothing imports JAX, and ``run.py``
refuses to run without a card."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "port_bench"
sys.path.insert(0, str(REPO))

from port_bench import harness, work  # noqa: E402

FORBIDDEN = {"jax", "jaxlib", "flax", "universal_quantum_optimal_control_tpu"}


def _bench() -> dict:
    with open(REPO / "BENCHMARK.json") as f:
        return json.load(f)


@pytest.mark.parametrize("cell", [w["name"] for w in _bench()["workloads"]])
def test_cell_resolves_to_its_files(cell):
    bench = _bench()
    run = harness.resolve(bench, cell, REPO, 1, torch.device("cpu"))
    drv = harness.entry(run)
    for attr in ("UNIT", "FAULTS", "inputs", "setup", "window", "unit", "work", "release",
                 "reference", "compare"):
        assert hasattr(drv, attr), (cell, attr)
    e2e = {m["name"]: m["unit"] for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])}
    assert "setup_s" in e2e and len(e2e) >= 2
    readers = harness.metric_readers(bench, cell, e2e)
    assert readers, cell
    assert all(m in e2e for m in {p["moves"] for p in bench["per_layer"]
                                  if cell in p.get("workloads", [])})


def test_every_metric_and_config_has_its_file():
    bench = _bench()
    for m in bench["per_layer"]:
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for c in bench["configs"]:
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    used = {w["traffic"] for w in bench["workloads"]}
    for t in used:
        assert (BENCH / "traffic" / f"{t}.json").is_file()
    for w in bench["workloads"]:
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def test_shares_are_named_and_bounded_as_shares():
    for m in _bench()["per_layer"]:
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%" and m["better"] == "higher", m["name"]


def test_frozen_work_counts_match_the_host_counters():
    """The counts ``chip_smoke.py`` holds to the host builds of the
    per-sample math (``tests/test_torch_su{2,4}_host.py``)."""
    smoke = {}
    for node in ast.parse((REPO / "chip_smoke.py").read_text()).body:
        if isinstance(node, ast.Assign) and isinstance(node.targets[0], ast.Name):
            try:
                smoke[node.targets[0].id] = ast.literal_eval(node.value)
            except ValueError:
                pass
    assert work.SU2["segment"] == smoke["FLOPS_PER_SEGMENT"][2]
    assert work.SU2["sample"] == smoke["FLOPS_PER_SAMPLE"][2]
    assert work.SU2["fidelity"] == smoke["FLOPS_PER_SAMPLE_FIDELITY"]
    assert work.SU2["vjp_segment"] == smoke["VJP_FLOPS_PER_SEGMENT"][2]
    assert work.SU2["vjp_sample"] == smoke["VJP_FLOPS_PER_SAMPLE"][2]
    assert work.SU4["segment"] == smoke["SU4_FLOPS_PER_SEGMENT"]
    assert work.SU4["sample"] == smoke["SU4_FLOPS_PER_SAMPLE"]
    assert work.SU4["fidelity"] == smoke["SU4_FLOPS_PER_SAMPLE_FIDELITY"]
    assert work.SU4["vjp_segment"] == smoke["SU4_VJP_FLOPS_PER_SEGMENT"][4]
    assert work.SU4["vjp_sample"] == smoke["SU4_VJP_FLOPS_PER_SAMPLE"]
    assert work.PEAK_F32 == smoke["PEAK_F32_FLOPS"]
    assert work.PEAK_BYTES == smoke["PEAK_BYTES_PER_S"]


def test_model_flops_of_the_flagship():
    cfg = json.loads((BENCH / "configs" / "length_100.json").read_text())
    params = sum(p.numel() for n, p in _port_model(cfg).named_parameters()
                 if n.endswith("weight") and p.dim() == 2 and not n.startswith("head"))
    flops = work.model_flops(cfg, 1, 9, training=False)
    attention = 2 * 9 * cfg["n_layers"] * 2 * 9 * cfg["d_model"]
    head = 2 * cfg["d_model"] * cfg["max_pulses"] * 2
    assert flops == 2 * 9 * params + attention + head


def _port_model(cfg):
    from universal_quantum_optimal_control_tpu_torch.models import UniversalQOCTransformer
    return UniversalQOCTransformer(pulse_space=cfg["pulse_space"], max_pulses=cfg["max_pulses"],
                                   d_model=cfg["d_model"], n_layers=cfg["n_layers"],
                                   n_heads=cfg["n_heads"], device="cpu")


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH)))
def test_no_module_imports_jax(path):
    found = _imports(path)
    assert not found & FORBIDDEN, found & FORBIDDEN
    if "reference" in path.parts:
        assert "universal_quantum_optimal_control_tpu_torch" not in found


def test_run_without_a_card_exits_nonzero_and_prints_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload", "length_100.score", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
