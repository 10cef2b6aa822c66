"""One run of one cell: set-up, the measured window, the traced sub-window,
the comparison with the reference, the result line.

Everything that belongs to one configuration, traffic mix, cell or
per-layer metric is a file of its own, found by the name that
``BENCHMARK.json`` gives it:

* ``BENCHMARK.json``'s cell entry names its configuration (whose ``file``
  is the configuration's sizes) and its traffic ``<mix>``;
* ``traffic/<mix>.json`` holds the mix's parameters and names the entry
  (``entries/<entry>.py``) that offers it to the program;
* ``limits/<cell>.json`` holds the limit of each number compared;
* ``metrics/<metric>.py`` reads one per-layer metric (``read(ctx)``).

An entry module offers one kind of traffic.  It has ``UNIT`` ("step" or
"request") and ``inputs``, ``setup``, ``window``, ``unit``, ``work``,
``release``, ``reference`` and ``compare``; see ``entries/train.py``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Dict, Optional

import torch

from . import trace as tracing

ROOT = Path(__file__).resolve().parent          # port_bench/
FORBIDDEN = ("jax", "jaxlib", "flax", "universal_quantum_optimal_control_tpu")


def log(msg: str) -> None:
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Run:
    """One run: the cell's name, its configuration, traffic and limits, the
    seed and the device; ``state`` is the entry's."""

    cell: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: torch.device
    state: dict = dataclasses.field(default_factory=dict)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def entry(run: Run):
    name = run.traffic["entry"]
    return load_module(ROOT / "entries" / f"{name}.py", f"port_bench.entries.{name}")


def resolve(bench: dict, cell: str, repo: Path, seed: int, device: torch.device) -> Run:
    """The :class:`Run` of ``cell`` as ``bench`` (``BENCHMARK.json``) names it."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if cell not in cells:
        raise SystemExit(f"unknown workload {cell!r}; known: {sorted(cells)}")
    w = cells[cell]
    cfg_file = {c["name"]: c["file"] for c in bench["configs"]}[w["config"]]
    with open(repo / cfg_file) as f:
        config = json.load(f)
    with open(ROOT / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(ROOT / "limits" / f"{cell}.json") as f:
        limits = json.load(f)
    return Run(cell, config, traffic, limits, seed, device)


def metric_readers(bench: dict, cell: str, end_to_end: Dict[str, float]) -> Dict[str, Callable]:
    """The readers of the per-layer metrics this cell reports: those that
    list it, and those without a list whose ``moves`` metric it reports."""
    out = {}
    for m in bench["per_layer"]:
        listed = m.get("workloads")
        if (cell in listed) if listed is not None else (m["moves"] in end_to_end):
            path = ROOT / "metrics" / f"{m['name']}.py"
            out[m["name"]] = (load_module(path, f"port_bench.metrics.{m['name']}").read,
                              m["unit"])
    return out


def forbidden_modules() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))


def execute(run: Run, seconds: float, trace: bool, t_start: float,
            end_to_end: Dict[str, str], readers: Optional[Dict[str, Callable]] = None) -> dict:
    """Set up, measure ``seconds``, optionally trace, compare; returns the
    result's fields and ``checks``: ``{name: [value, limit]}``.  ``metrics``
    are those of ``end_to_end`` (name → unit) or, with ``trace``, those
    that ``readers`` (name → (reader, unit)) find."""
    drv = entry(run)
    inputs = drv.inputs(run)
    drv.setup(run, inputs)
    if run.device.type == "cuda":
        torch.cuda.synchronize(run.device)
    setup_s = time.perf_counter() - t_start
    log(f"setup_s {setup_s:.3f}")
    win = drv.window(run, seconds)
    log(f"window: {win['attempted']} {drv.UNIT}s, {win['failed']} failed, "
        f"{json.dumps(win['metrics'])}")
    result = {"attempted": win["attempted"], "failed": win["failed"]}
    if trace:
        tr = tracing.timed_profile(drv.unit(run), run.traffic["profile_units"], run.device)
        log(f"traced {tr['units']} {drv.UNIT}s in {tr['seconds']:.2f} s; program kernels "
            f"{tr['port_kernels']}")
        ctx = {"unit": drv.UNIT, "trace": tr, "unit_s": win["unit_s"],
               "work": drv.work(run), "spans": win.get("spans", {})}
        values = {name: read(ctx) for name, (read, _) in (readers or {}).items()}
        result["metrics"] = {name: {"value": v, "unit": readers[name][1]}
                             for name, v in values.items() if v is not None}
        result["busy_s"], result["window_s"] = tr["busy_s"], tr["window_s"]
        result["breakdown"] = tr["breakdown"]
    else:
        values = dict(win["metrics"], setup_s=setup_s)
        result["metrics"] = {name: {"value": values[name], "unit": unit}
                             for name, unit in end_to_end.items() if name in values}
    result["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(run.device)
                                   if run.device.type == "cuda" else 0)
    drv.release(run)
    gc.collect()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    got = run.state.pop("outputs")
    want = drv.reference(run, inputs, got)
    numbers = drv.compare(run, got, want)
    log(f"reference and comparison {time.perf_counter() - t0:.2f} s")
    result["checks"] = {k: [v, run.limits[k]] for k, v in numbers.items()}
    result["correct"] = (win["failed"] == 0
                         and all(v <= run.limits[k] for k, v in numbers.items()))
    return result
