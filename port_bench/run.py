"""Run one cell of the port's benchmark once and print its result line.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell, its configuration, traffic, limits
and per-layer metrics are found by name from ``BENCHMARK.json``
(:mod:`port_bench.harness`).  Progress, set-up phases and each number
compared with its limit go to standard error; the last line of standard
output is the result.  Exits non-zero, printing no result, without the
CUDA cards the cell asks for, or if JAX or the JAX package was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
CACHE = REPO / "build" / "port_bench_cache"
# every build and kernel cache inside the checkout, at fixed paths
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("CUDA_CACHE_PATH", "nv_compute")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
# one process with few threads: the host's own BLAS and OpenMP pools stay at one
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path.insert(0, str(REPO))


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    from port_bench import harness

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    harness.log(f"setup import {time.perf_counter() - T_START:.3f} s")
    run = harness.resolve(bench, args.workload, REPO, args.seed, device)
    end_to_end = {m["name"]: m["unit"] for m in bench["end_to_end"]
                  if args.workload in m.get("workloads", [args.workload])}
    readers = harness.metric_readers(bench, args.workload, end_to_end) if args.trace else None
    result = harness.execute(run, args.seconds, bool(args.trace), T_START, end_to_end, readers)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules were imported: {found}", file=sys.stderr)
        return 4
    device_info = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                   "count": cell["chips"], "memory_peak_bytes": result["memory_peak_bytes"]}
    if args.trace:
        device_info.update(busy_s=result["busy_s"], window_s=result["window_s"])
    line = {"correct": result["correct"], "attempted": result["attempted"],
            "failed": result["failed"], "metrics": result["metrics"], "device": device_info}
    if args.trace:
        line["breakdown"] = result["breakdown"]
    line["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in result["checks"].items()}
    for k, (v, lim) in result["checks"].items():
        print(f"check {k} {v!r} limit {lim!r} {'ok' if v <= lim else 'FAIL'}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
