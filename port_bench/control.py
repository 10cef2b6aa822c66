"""Readings that set the limits of a cell's comparison.

    python3 port_bench/control.py --workload <cell> --seeds 1,2,3

For each seed, the cell's inputs are made as a run makes them, and the
numbers a run compares are read for stand-ins of the program: the
reference itself one precision lower than the configuration states (the
control: TF32 for an f32 encoder, fp8 for a bf16 one, bf16 for f32
Monte-Carlo arithmetic) and the reference with each fault of the cell's
entry module planted (``FAULTS``).  A sound limit lies between the program's
largest reading over a dozen seeds and the smallest of these.  Prints one
JSON line a seed; runs no timed window and needs no program.
"""

import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))


def readings(run, drv) -> dict:
    """``{"control": numbers, "<fault>": numbers, ...}`` for one seed."""
    inp = drv.inputs(run)
    out = {}
    for name, kw in [("control", {"control": True})] + [(f, {"fault": f}) for f in drv.FAULTS]:
        got = drv.reference(run, inp, None, **kw)
        out[name] = drv.compare(run, got, drv.reference(run, inp, got))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    import torch

    from port_bench import harness

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    with open(REPO / "BENCHMARK.json") as f:
        bench = json.load(f)
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        run = harness.resolve(bench, args.workload, REPO, seed, torch.device("cuda", 0))
        line = {"workload": args.workload, "seed": seed,
                **readings(run, harness.entry(run)), "limits": run.limits,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
