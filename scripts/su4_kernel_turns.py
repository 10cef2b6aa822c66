#!/usr/bin/env python3
r"""Time two builds of the SU(4) kernels B4, B6, B5 and B8 on one CUDA card,
in turns.

    git archive <commit> universal_quantum_optimal_control_tpu_torch/ops \
        | tar -x -C build/parent
    python scripts/su4_kernel_turns.py --parent build/parent

``--parent`` names a directory holding another version's
``universal_quantum_optimal_control_tpu_torch/ops/_build.py`` and
``ops/csrc/``.  Both that version and this tree's are built with ``nvcc``
(each into the ``build/torch_kernels`` beside its own package), loaded with
ctypes and launched through their common C interface on the same inputs: B4
and B5 at the per-gate polish's shape (5, 100, 4, 4096) and at the two-qubit
training shape (32, 100, 4, 1024), B6 at the named-gate table's (5, 100, 4,
20 000), B8 at the training shape.  Each kernel is timed with CUDA events
after a warm-up in the order parent, this tree, this tree, parent, and its
outputs compared between the two builds.  Prints each row and, last, one
JSON line ``{"card": ..., "rows": [...]}``; exits nonzero where CUDA is
unavailable or the two builds disagree by more than 1e-4.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its constants and helpers; its main is not run)

SHAPES = {"polish": (5, 100, 4, 4096), "train": (32, 100, 4, 1024),
          "table": (5, 100, 4, 20_000)}
ROWS = [("B4", "polish"), ("B5", "polish"), ("B4", "train"), ("B5", "train"),
        ("B6", "table"), ("B8", "train")]
# parent against this tree: a gross disagreement only (chip_smoke.py holds
# each kernel to its plain version at the JAX suite's tolerances)
TOL = 1e-4


def load_build(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def num_blocks(export, B, M):
    """A block-count export of either interface: (M) before the launch-size
    choice of lanes per sample, (B, M) after it."""
    return export(B, M) if len(export.argtypes) == 2 else export(M)


def launchers(build):
    """B4, B6, B5 and B8 through one build's C interface."""
    fwd, bwd = build.load_library("su4"), build.load_library("su4_bwd")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def b46(x, product):
        pulses, tr, ti, d1, d2, ep, sys_ = x
        B, L, P = pulses.shape
        M = d1.shape[1]
        partials = torch.empty((B, num_blocks(fwd.uqoc_su4_num_blocks, B, M)),
                               device=pulses.device)
        out = torch.empty((B,), device=pulses.device)
        args = [t.data_ptr() for t in (pulses, tr, ti, d1, d2, ep, partials, out)]
        sysargs = (float(sys_.xtalk), float(sys_.coupling), int(sys_.expm_scaling))
        if product:
            prod = torch.empty((B, 32, M), device=pulses.device)
            err = fwd.uqoc_su4_mean_fidelity_with_product(*args, prod.data_ptr(), B, L, P, M,
                                                          *sysargs, stream())
            build.raise_on(fwd, err, "B4")
            return out, prod
        build.raise_on(fwd, fwd.uqoc_su4_mean_fidelity(*args, B, L, P, M, *sysargs, stream()),
                       "B6")
        return (out,)

    def b58(x, gbar, prod):
        pulses, tr, ti, d1, d2, ep, sys_ = x
        B, L, P = pulses.shape
        M = d1.shape[1]
        dev = pulses.device
        partials = torch.empty((B, num_blocks(bwd.uqoc_su4_vjp_num_blocks, B, M), L * P),
                               device=dev)
        dpulses = torch.empty((B, L, P), device=dev)
        dd = [torch.empty((B, M), device=dev) for _ in range(3)]
        ins = [t.data_ptr() for t in (pulses, tr, ti, gbar, d1, d2, ep)]
        outs = [partials.data_ptr(), dpulses.data_ptr(), *(t.data_ptr() for t in dd),
                B, L, P, M, float(sys_.xtalk), float(sys_.coupling), int(sys_.expm_scaling),
                stream()]
        if prod is None:
            build.raise_on(bwd, bwd.uqoc_su4_objective_vjp_rebuild(*ins, *outs), "B8")
        else:
            build.raise_on(bwd, bwd.uqoc_su4_objective_vjp(*ins, prod.data_ptr(), *outs), "B5")
        return (dpulses, *dd)

    return {"B4": lambda x, g, p: b46(x, True), "B6": lambda x, g, p: b46(x, False),
            "B5": lambda x, g, p: b58(x, g, p), "B8": lambda x, g, p: b58(x, g, None)}


def lanes(build, kid, B, M):
    """Lanes per sample a build's kernel takes at (B, M); None for a build
    without lane groups (one thread per sample)."""
    fwd = kid in ("B4", "B6")
    lib = build.load_library("su4" if fwd else "su4_bwd")
    export = getattr(lib, "uqoc_su4_lanes" if fwd else "uqoc_su4_vjp_lanes", None)
    return None if export is None else export(B, M)


def ptxas_regs(build, built, kid, B, M, P):
    """ptxas' report for the instantiation a build launches at the shape: a
    build with lane groups names its lanes as the last template argument."""
    entry = {"B4": "mean_fid_su4_kernelILi{}ELb1E", "B6": "mean_fid_su4_kernelILi{}ELb0E",
             "B5": "su4_vjp_kernelILi{}ELb0E", "B8": "su4_vjp_kernelILi{}ELb1E"}[kid]
    n = lanes(build, kid, B, M)
    suffix = "EEv" if n is None else f"Li{n}E"
    return chip_smoke.ptxas_of(chip_smoke.ptxas_table(built), entry.format(P) + suffix)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory holding the other version's "
                         "universal_quantum_optimal_control_tpu_torch/ops")
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("su4_kernel_turns: needs a CUDA card", file=sys.stderr)
        return 1
    ops = "universal_quantum_optimal_control_tpu_torch/ops/_build.py"
    builds = {"parent": load_build(args.parent / ops, "parent_build"),
              "this": load_build(ROOT / ops, "this_build")}
    built = {k: b.build_libraries(["su4", "su4_bwd"]) for k, b in builds.items()}
    run = {k: launchers(b) for k, b in builds.items()}
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(9)
    inputs = {}
    for shape_name, (B, L, P, M) in SHAPES.items():
        x = chip_smoke.su4_random_inputs(gen, B, L, P, M, dev)
        gbar = torch.full((B,), 1.0 / B, device=dev)
        inputs[shape_name] = (x, gbar, run["this"]["B4"](x, gbar, None)[1])
    card = chip_smoke.nvidia_smi()
    rows = []
    for kid, shape_name in ROWS:
        x, gbar, prod = inputs[shape_name]
        B, L, P, M = SHAPES[shape_name]
        outs = {k: run[k][kid](x, gbar, prod) for k in run}
        torch.cuda.synchronize()
        diff = max(float((a - b).abs().max()) for a, b in zip(outs["parent"], outs["this"]))
        times = []
        for who in ("parent", "this", "this", "parent"):
            fn = run[who][kid]
            times.append(chip_smoke.time_ms(lambda: fn(x, gbar, prod), args.iters))
        if kid in ("B5", "B8"):
            bound = chip_smoke.su4_vjp_bound(B, L, P, M, rebuild=kid == "B8")
        else:
            bound = chip_smoke.su4_bound(B, L, P, M, fidelity=True, product=kid == "B4")
        parent_ms, this_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        row = {"kernel": kid, "shape": shape_name, "B": B, "L": L, "P": P, "M": M,
               "times_ms": times, "parent_ms": parent_ms, "this_ms": this_ms,
               "bound_ms": bound[0], "parent_share": bound[0] / parent_ms,
               "this_share": bound[0] / this_ms, "max_abs_diff": diff,
               "lanes": {k: lanes(builds[k], kid, B, M) for k in builds},
               "ptxas": {k: ptxas_regs(builds[k], built[k], kid, B, M, P) for k in built}}
        rows.append(row)
        print(f"{kid} {shape_name} {(B, L, P, M)}: parent {times[0]:.4f} / {times[3]:.4f} ms, "
              f"this {times[1]:.4f} / {times[2]:.4f} ms; bound {bound[0]:.4f} ms: "
              f"{100 * row['parent_share']:.1f} % -> {100 * row['this_share']:.1f} %; "
              f"|parent - this| {diff:.2e}; registers {row['ptxas']['parent'].get('registers')}"
              f" -> {row['ptxas']['this'].get('registers')} ({row['lanes']['this']} lanes a "
              f"sample)")
        if not diff <= TOL:
            raise AssertionError(f"{kid} {shape_name}: the builds differ by {diff:.3e} > "
                                 f"{TOL:.0e}")
    print(json.dumps({"card": card, "rows": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
