#!/usr/bin/env python3
r"""Time two builds of the SU(4) kernels B4, B6, B5, B8 and B7 on one CUDA
card, in turns.

    git archive <commit> universal_quantum_optimal_control_tpu_torch/ops \
        | tar -x -C build/parent
    python scripts/su4_kernel_turns.py --parent build/parent \
        [--b7-chunks 8 2] [--sass build/su4_sass]

``--parent`` names a directory holding another version's
``universal_quantum_optimal_control_tpu_torch/ops/_build.py`` and
``ops/csrc/``.  Both that version and this tree's are built with ``nvcc``
(each into the ``build/torch_kernels`` beside its own package), loaded with
ctypes and launched through their common C interface on the same inputs: B4
and B5 at the per-gate polish's shape (5, 100, 4, 4096), at its exact
term's (5, 100, 4, 1) and at the two-qubit training shape (32, 100, 4,
1024), B6 at the named-gate table's (5, 100, 4, 20 000), the training shape
and the variants' table (5, 40, 4, 20 000), B8 at the training shape, B7 at
the GRAPE robustness curve's (1, 20, 4, 4096), serving's E[F](σ) sweep (1,
100, 4, 40 000) and the variants' sweep (1, 20, 4, 2 000 000).  Each kernel
is timed after a warm-up in the order parent, this tree, this tree, parent,
by CUDA events around a loop of launches, as device time
(``chip_smoke.device_ms``: each launch queued behind a long one, since the
host's enqueue exceeds a short launch) and as kernel time (``kernel_ms``:
the kernels' durations in a profile, kept only where every kernel of the
call appears once a call and the time lies between the bound and the
device time, else null), and its outputs compared between the two builds,
beside this tree's plain version's time; B7's rows also give each build's
plan, its error against the plain version in f64 and whether a rerun gives
the same bits.  ``--b7-chunks`` times this tree's B7 under each named plan
K (chunks a sample) at the curve's, serving's and the sweep's shapes, in
turns with the card's own plan, as device and kernel time.
``--sass`` writes each build's SASS (``cuobjdump -sass``) of the SU(4)
forward library and prints B7's opcode counts.  Prints each row and, last,
one JSON line ``{"card": ..., "rows": [...]}``; exits nonzero where CUDA is
unavailable or the two builds disagree by more than 1e-4.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its constants and helpers; its main is not run)
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su4 as t4  # noqa: E402

SHAPES = {"polish": (5, 100, 4, 4096), "exact": (5, 100, 4, 1), "train": (32, 100, 4, 1024),
          "table": (5, 100, 4, 20_000), "variants": (5, 40, 4, 20_000),
          "curve": (1, 20, 4, 4096), "serving": (1, 100, 4, 40_000),
          "sweep": (1, 20, 4, 2_000_000)}
ROWS = [("B4", "polish"), ("B5", "polish"), ("B4", "exact"), ("B5", "exact"),
        ("B4", "train"), ("B5", "train"),
        ("B6", "table"), ("B6", "train"), ("B6", "variants"), ("B8", "train"),
        ("B7", "curve"), ("B7", "serving"), ("B7", "sweep")]
B7_PLAN_SHAPES = ("curve", "serving", "sweep")
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

    def b7(x, chunks=None):
        pulses, _, _, d1, d2, ep, sys_ = x
        B, L, P = pulses.shape
        M = d1.shape[1]
        out_re = torch.empty((B, M, 4, 4), device=pulses.device)
        out_im = torch.empty_like(out_re)
        args = [t.data_ptr() for t in (pulses, d1, d2, ep, out_re, out_im)] + [B, L, P, M]
        sysargs = (float(sys_.xtalk), float(sys_.coupling), int(sys_.expm_scaling))
        if chunks is None:
            err = fwd.uqoc_su4_propagate_mc(*args, *sysargs, stream())
        else:
            err = fwd.uqoc_su4_propagate_mc_plan(*args, chunks, *sysargs, stream())
        build.raise_on(fwd, err, "B7")
        return out_re, out_im

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
            "B5": lambda x, g, p: b58(x, g, p), "B8": lambda x, g, p: b58(x, g, None),
            "B7": lambda x, g, p: b7(x), "B7 plan": b7}


def lanes(build, kid, B, M):
    """Lanes per sample a build's kernel takes at (B, M); None for a build
    without lane groups (one thread per sample)."""
    fwd = kid in ("B4", "B6")
    lib = build.load_library("su4" if fwd else "su4_bwd")
    export = getattr(lib, "uqoc_su4_lanes" if fwd else "uqoc_su4_vjp_lanes", None)
    return None if export is None else export(B, M)


def kernel_ms(fn, n: int, bound: float, device: float):
    """The device's kernel time per call of ``fn``, from a profile (CUPTI)
    of ``n`` calls after a warm-up: the kernels' own durations, without the
    launch and event gaps that ``chip_smoke.device_ms`` includes (6 µs for
    an empty op on an H100).  A profile counts only where it kept every
    kernel of the call ``n`` times and its time lies between ``bound`` (the
    least time the card could take) and ``device`` (the same call's device
    time, measured just before, with 1 % for the clock's drift between the
    two loops: a long kernel's two readings differ by up to 0.3 % on an
    H100); else it is taken again, and after three refused profiles the
    reading is None."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    for attempt in range(3):
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA and "#" not in e.key
                   and e.count > 0]
        ms = sum(e.self_device_time_total for e in kernels) / n / 1e3
        counts = sorted({e.count for e in kernels})
        if kernels and counts == [n] and bound <= ms <= 1.01 * device:
            return ms
        print(f"  kernel time refused (profile {attempt + 1}): {ms:.4f} ms, counts {counts} "
              f"for {n} calls, bound {bound:.4f}, device {device:.4f} ms")
    return None


def mean(a, b):
    return None if a is None or b is None else (a + b) / 2


def fmt(ms) -> str:
    return "null" if ms is None else f"{ms:.4f}"


def plain(kid, x, gbar, prod):
    """The kernel's plain version (this tree's) on the same inputs."""
    pulses, tr, ti, d1, d2, ep, sys_ = x
    if kid == "B7":
        return t4.propagate_su4_mc_plain(pulses, d1, d2, ep, sys_)
    if kid == "B6":
        return t4.mean_fidelity_su4_plain(pulses, tr, ti, d1, d2, ep, sys_)
    if kid == "B4":
        return t4.mean_fidelity_su4_with_product_plain(pulses, tr, ti, d1, d2, ep, sys_)
    if kid == "B5":
        return t4.su4_objective_vjp_from_product_plain(pulses, tr, ti, d1, d2, ep, gbar, prod,
                                                       sys_)
    return t4.su4_objective_vjp_plain(pulses, tr, ti, d1, d2, ep, gbar, sys_)


def b7_plan(build, B, M, L):
    """B7's plan K (chunks a sample) in a build at the shape; None for a
    build without plans (one thread per sample)."""
    lib = build.load_library("su4")
    if getattr(lib, "uqoc_su4_prop_chunks", None) is None:
        return None
    return lib.uqoc_su4_prop_chunks(B, M, L)


def b7_entry(chunks, P):
    """The mangled-name fragment of B7's kernel under plan K."""
    if chunks is None or chunks == 1:
        return f"propagate_su4_kernelILi{P}E"
    return f"propagate_su4_chunks_kernelILi{P}E"


def ptxas_regs(build, built, kid, B, M, P, L):
    """ptxas' report for the instantiation a build launches at the shape: a
    build with lane groups names its lanes as the last template argument."""
    table = chip_smoke.ptxas_table(built)
    if kid == "B7":
        return chip_smoke.ptxas_of(table, b7_entry(b7_plan(build, B, M, L), P))
    entry = {"B4": "mean_fid_su4_kernelILi{}ELb1E", "B6": "mean_fid_su4_kernelILi{}ELb0E",
             "B5": "su4_vjp_kernelILi{}ELb0E", "B8": "su4_vjp_kernelILi{}ELb1E"}[kid]
    n = lanes(build, kid, B, M)
    suffix = "EEv" if n is None else f"Li{n}E"
    return chip_smoke.ptxas_of(table, entry.format(P) + suffix)


def sass_dump(built, out: Path) -> dict:
    """Each build's SASS of the SU(4) forward library into
    ``out/<build>.sass``; per B7 kernel at P = 4 the static count of each
    opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out.mkdir(parents=True, exist_ok=True)
    hists = {}
    for name, b in built.items():
        text = subprocess.run([tool, "-sass", b["su4"]["path"]], capture_output=True,
                              text=True, check=True).stdout
        (out / f"{name}.sass").write_text(text)
        hists[name] = {}
        for m in re.finditer(r"Function : (\S*propagate_su4_(?:chunks_)?kernelILi4E\S*)\n(.*?)"
                             r"(?=\n\s*Function :|\Z)", text, re.S):
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", m[2])
            hist = {}
            for op in ops:
                hist[op] = hist.get(op, 0) + 1
            hists[name][m[1]] = dict(sorted(hist.items(), key=lambda kv: -kv[1]))
            print(f"SASS {name} {m[1]}: {len(ops)} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in list(hists[name][m[1]].items())[:14]))
    return hists


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory holding the other version's "
                         "universal_quantum_optimal_control_tpu_torch/ops")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--b7-chunks", nargs="*", type=int, default=[],
                    help="plans K (chunks a sample) under which to time this tree's B7")
    ap.add_argument("--sass", type=Path, default=None,
                    help="directory for each build's SASS and B7's opcode counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("su4_kernel_turns: needs a CUDA card", file=sys.stderr)
        return 1
    ops = "universal_quantum_optimal_control_tpu_torch/ops/_build.py"
    builds = {"parent": load_build(args.parent / ops, "parent_build"),
              "this": load_build(ROOT / ops, "this_build")}
    built = {k: b.build_libraries(["su4", "su4_bwd"]) for k, b in builds.items()}
    run = {k: launchers(b) for k, b in builds.items()}
    hists = sass_dump(built, args.sass) if args.sass else None
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
        extra = {}
        if kid == "B7":
            exact = t4.propagate_su4_mc_plain(x[0].double(), *(t.double() for t in x[3:6]), x[6])
            again = {k: run[k][kid](x, gbar, prod) for k in run}
            torch.cuda.synchronize()
            extra = {"vs_f64": {k: chip_smoke.max_err(o, exact) for k, o in outs.items()},
                     "same_bits": {k: all(torch.equal(a, b) for a, b in zip(outs[k], again[k]))
                                   for k in run},
                     "plan": {k: b7_plan(builds[k], B, M, L) for k in builds}}
            del exact, again
        if kid in ("B5", "B8"):
            bound = chip_smoke.su4_vjp_bound(B, L, P, M, rebuild=kid == "B8")
        else:
            bound = chip_smoke.su4_bound(B, L, P, M, fidelity=kid != "B7", product=kid == "B4")
        times, device, kernel = [], [], []
        for who in ("parent", "this", "this", "parent"):
            fn = run[who][kid]
            times.append(chip_smoke.time_ms(lambda: fn(x, gbar, prod), args.iters))
            # the host's enqueue may exceed a short launch
            device.append(chip_smoke.device_ms(lambda: fn(x, gbar, prod), args.iters))
            kernel.append(kernel_ms(lambda: fn(x, gbar, prod), args.iters, bound[0],
                                    device[-1]))
        extra.update(plain_ms=chip_smoke.time_ms(lambda: plain(kid, x, gbar, prod), 2),
                     device_ms=device, parent_device_ms=(device[0] + device[3]) / 2,
                     this_device_ms=(device[1] + device[2]) / 2, kernel_ms=kernel,
                     parent_kernel_ms=mean(kernel[0], kernel[3]),
                     this_kernel_ms=mean(kernel[1], kernel[2]))
        parent_ms, this_ms = (times[0] + times[3]) / 2, (times[1] + times[2]) / 2
        row = {"kernel": kid, "shape": shape_name, "B": B, "L": L, "P": P, "M": M,
               "times_ms": times, "parent_ms": parent_ms, "this_ms": this_ms,
               "bound_ms": bound[0], "parent_share": bound[0] / parent_ms,
               "this_share": bound[0] / this_ms, "max_abs_diff": diff,
               "lanes": {k: lanes(builds[k], kid, B, M) for k in builds},
               "ptxas": {k: ptxas_regs(builds[k], built[k], kid, B, M, P, L) for k in built},
               **extra}
        rows.append(row)
        print(f"{kid} {shape_name} {(B, L, P, M)}: parent {times[0]:.4f} / {times[3]:.4f} ms, "
              f"this {times[1]:.4f} / {times[2]:.4f} ms; bound {bound[0]:.4f} ms: "
              f"{100 * row['parent_share']:.1f} % -> {100 * row['this_share']:.1f} %; "
              f"|parent - this| {diff:.2e}; registers {row['ptxas']['parent'].get('registers')}"
              f" -> {row['ptxas']['this'].get('registers')} ({row['lanes']['this']} lanes a "
              f"sample)")
        print(f"  device time: parent {device[0]:.4f} / {device[3]:.4f} ms, this "
              f"{device[1]:.4f} / {device[2]:.4f} ms; kernel time: parent {fmt(kernel[0])} / "
              f"{fmt(kernel[3])} ms, this {fmt(kernel[1])} / {fmt(kernel[2])} ms; plain "
              f"{extra['plain_ms']:.3f} ms")
        if kid == "B7":
            print(f"  B7 plan {extra['plan']}, error vs f64 {extra['vs_f64']}, same bits on a "
                  f"rerun {extra['same_bits']}")
        if not diff <= TOL:
            raise AssertionError(f"{kid} {shape_name}: the builds differ by {diff:.3e} > "
                                 f"{TOL:.0e}")
    this = run["this"]
    for shape_name in B7_PLAN_SHAPES if args.b7_chunks else ():
        x, gbar, prod = inputs[shape_name]
        B, L, P, M = SHAPES[shape_name]
        bound = chip_smoke.su4_bound(B, L, P, M, fidelity=False)[0]
        base = this["B7"](x, gbar, prod)
        for chunks in args.b7_chunks:
            diff = max(float((a - b).abs().max())
                       for a, b in zip(base, this["B7 plan"](x, chunks)))
            planned = lambda: this["B7"](x, gbar, prod)  # noqa: E731
            forced = lambda: this["B7 plan"](x, chunks)  # noqa: E731
            times, kernel = [], []
            for fn in (planned, forced, forced, planned):
                times.append(chip_smoke.device_ms(fn, args.iters))
                kernel.append(kernel_ms(fn, args.iters, bound, times[-1]))
            regs = chip_smoke.ptxas_of(chip_smoke.ptxas_table(built["this"]),
                                       b7_entry(chunks, P))
            rows.append({"kernel": "B7", "shape": shape_name, "B": B, "L": L, "P": P, "M": M,
                         "forced_chunks": chunks, "plan": b7_plan(builds["this"], B, M, L),
                         "device_ms": times, "planned_ms": (times[0] + times[3]) / 2,
                         "forced_ms": (times[1] + times[2]) / 2, "kernel_ms": kernel,
                         "planned_kernel_ms": mean(kernel[0], kernel[3]),
                         "forced_kernel_ms": mean(kernel[1], kernel[2]), "max_abs_diff": diff,
                         "ptxas": regs})
            print(f"B7 {shape_name} under K = {chunks}: device {rows[-1]['forced_ms']:.4f} ms "
                  f"(kernel {fmt(rows[-1]['forced_kernel_ms'])}) against "
                  f"{rows[-1]['planned_ms']:.4f} ms ({fmt(rows[-1]['planned_kernel_ms'])}) "
                  f"under K = {rows[-1]['plan']}; |diff| {diff:.2e}; registers "
                  f"{regs.get('registers')}")
            if not diff <= TOL:
                raise AssertionError(f"B7 {shape_name} under K = {chunks}: {diff:.3e} > "
                                     f"{TOL:.0e}")
    print(json.dumps({"card": card, "rows": rows, "sass": hists}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
