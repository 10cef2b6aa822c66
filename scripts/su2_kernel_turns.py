#!/usr/bin/env python3
r"""Time two builds of the SU(2) kernels B1, B3 and B2 on one CUDA card, in
turns.

    git archive <commit> universal_quantum_optimal_control_tpu_torch/ops \
        | tar -x -C build/parent
    python scripts/su2_kernel_turns.py --parent build/parent \
        [--variant cap40=-maxrregcount=40] [--sass build/su2_sass]

``--parent`` names a directory holding another version's
``universal_quantum_optimal_control_tpu_torch/ops/_build.py`` and
``ops/csrc/``.  That version and this tree's are built with ``nvcc`` (each
into the ``build/torch_kernels`` beside its own package), loaded with ctypes
and launched through their C interfaces on the same inputs; B2's interface
takes B3's product where this tree's does (``q``), and B1's the ticket
counters of its one-launch sum.  Each ``--variant NAME=FLAGS``
builds this tree's sources once more with extra ``nvcc`` flags (a register
cap, a ``-D`` for an experiment's ``#if``), into ``build/variants/NAME``.

Rows, on random pulses (φ in (−π, π], τ in [0.05, 0.5]) at σ_δ = 1,
ε_std = 0.05, as ``chip_smoke.random_inputs`` draws them: B1 at the
serving shape (8, 100, 2, 2²⁰) and the training shape (200, 100, 2, 1000),
B3 at (1, 100, 2, 2¹⁸) and the training shape, B2 at the training shape
under the training step's cotangent (B1's backward at ḡ = 1/B), and B1's
whole backward there (B3, the cotangent's glue in PyTorch, B2).  Each row is
timed with CUDA events over ``--iters`` launches after a warm-up, buffers
allocated beforehand, in the order parent, this tree, the variants, the
variants again, this tree, parent; and once more as a CUDA graph of those
launches (the device's time without the host's enqueue).  Each build's
outputs are compared with the parent's, and with the plain version in f64
(``ops/propagate_su2.py``); this tree's B1 and B2 run twice and must give
the same bits.  Prints each row and, last, one JSON line ``{"card": ...,
"rows": [...], ...}``; exits nonzero where CUDA is unavailable, two builds
disagree by more than 1e-4, or a rerun differs.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (its constants and helpers; its main is not run)
from universal_quantum_optimal_control_tpu_torch.ops import propagate_su2 as tk  # noqa: E402

SHAPES = {"serve": (8, 100, 2, 1 << 20), "train": (200, 100, 2, 1000),
          "serve_b3": (1, 100, 2, 1 << 18)}
ROWS = [("B1", "serve"), ("B1", "train"), ("B3", "serve_b3"), ("B3", "train"),
        ("B2", "train"), ("B1 backward", "train")]
TOL = 1e-4  # builds against each other: a gross disagreement only
OPS = "universal_quantum_optimal_control_tpu_torch/ops/_build.py"
ENTRY = {"B1": "mean_fid_kernel", "B2": "propagate_mc_vjp_kernel", "B3": "propagate_mc_kernel"}


def load_build(path: Path, name: str, flags=(), build_dir=None):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if flags:
        mod.NVCC_FLAGS = tuple(mod.NVCC_FLAGS) + tuple(flags)
    if build_dir is not None:
        mod.BUILD_DIR = build_dir
    return mod


class Launchers:
    """B1, B3 and B2 through one build's C interface, on buffers allocated
    once per shape."""

    def __init__(self, build):
        self.lib = build.load_library("su2")
        self.build = build
        self.new = len(self.lib.uqoc_su2_mean_fidelity.argtypes) == 12
        self.bufs = {}

    def _buf(self, key, shape, dtype=torch.float32, zero=False):
        t = self.bufs.get(key)
        if t is None or tuple(t.shape) != tuple(shape):
            t = (torch.zeros if zero else torch.empty)(shape, dtype=dtype, device="cuda")
            self.bufs[key] = t
        return t

    def _stream(self):
        return torch.cuda.current_stream().cuda_stream

    def b3(self, pulses, delta, eps):
        B, L, P = pulses.shape
        M = delta.shape[1]
        out = self._buf(("b3", B, M), (B, M, 4))
        err = self.lib.uqoc_su2_propagate_mc(pulses.data_ptr(), delta.data_ptr(),
                                             eps.data_ptr(), out.data_ptr(), B, L, P, M,
                                             self._stream())
        self.build.raise_on(self.lib, err, "B3")
        return out

    def b1(self, pulses, q_t, delta, eps):
        B, L, P = pulses.shape
        M = delta.shape[1]
        partials = self._buf(("b1p", B, M), (B, self.lib.uqoc_su2_num_blocks(M)))
        out = self._buf(("b1", B), (B,))
        ptrs = [pulses.data_ptr(), q_t.data_ptr(), delta.data_ptr(), eps.data_ptr(),
                partials.data_ptr()]
        if self.new:
            ptrs.append(self._buf(("tickets", B), (B,), torch.int32, zero=True).data_ptr())
        err = self.lib.uqoc_su2_mean_fidelity(*ptrs, out.data_ptr(), B, L, P, M, self._stream())
        self.build.raise_on(self.lib, err, "B1")
        return out

    def b2(self, pulses, delta, eps, g, q):
        B, L, P = pulses.shape
        M = delta.shape[1]
        nblk = (self.lib.uqoc_su2_vjp_num_blocks if self.new else self.lib.uqoc_su2_num_blocks)(M)
        partials = self._buf(("b2p", B, M), (B, nblk, L * P))
        dp = self._buf(("b2dp", B, L), (B, L, P))
        dd, de = self._buf(("b2dd", B, M), (B, M)), self._buf(("b2de", B, M), (B, M))
        ins = [pulses.data_ptr(), delta.data_ptr(), eps.data_ptr(), g.data_ptr()]
        if self.new:
            ins.append(q.data_ptr())
        ins.append(partials.data_ptr())
        err = self.lib.uqoc_su2_propagate_mc_vjp(*ins, dp.data_ptr(), dd.data_ptr(),
                                                 de.data_ptr(), B, L, P, M, self._stream())
        self.build.raise_on(self.lib, err, "B2")
        return dp, dd, de

    def b1_backward(self, pulses, q_t, delta, eps, gbar):
        """B1's backward as ``_MeanFidelity.backward`` runs it."""
        M = delta.shape[1]
        q = self.b3(pulses, delta, eps)
        inner = torch.sum(q * q_t[:, None, :], dim=-1)
        scale = (8.0 / 6.0) * inner * gbar[:, None] / M
        g_q = (scale[..., None] * q_t[:, None, :]).contiguous()
        d_pulses, d_delta, d_eps = self.b2(pulses, delta, eps, g_q, q)
        return d_pulses, torch.sum(scale[..., None] * q, dim=1), d_delta, d_eps


def training_cotangent(pulses, q_t, delta, eps):
    """B1's backward's cotangent of B3's product at ḡ = 1/B, from the plain
    product (the same for every build)."""
    B, M = delta.shape
    q = tk.propagate_mc_plain(pulses, delta, eps)
    inner = torch.sum(q * q_t[:, None, :], dim=-1)
    scale = (8.0 / 6.0) * inner / (B * M)
    return (scale[..., None] * q_t[:, None, :]).contiguous()


def graph_ms(fn, iters):
    """The device's time per call of ``fn`` inside a CUDA graph of ``iters``
    calls."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def max_diff(a, b) -> float:
    return max(float((x.double() - y.double()).abs().max()) for x, y in zip(a, b))


def sass_histograms(builds, built, out: Path):
    """Each build's SASS (``cuobjdump -sass``) into ``out/<build>.sass`` and
    per P = 2 kernel the static count of each opcode."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    out.mkdir(parents=True, exist_ok=True)
    hists = {}
    for name, b in built.items():
        text = subprocess.run([tool, "-sass", b["su2"]["path"]], capture_output=True,
                              text=True, check=True).stdout
        (out / f"{name}.sass").write_text(text)
        hists[name] = {}
        for kid, entry in ENTRY.items():
            m = re.search(r"Function : (\S*" + entry + r"ILi2E\S*)\n(.*?)(?=\n\s*Function :|\Z)",
                          text, re.S)
            if not m:
                continue
            ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", m[2])
            hist = {}
            for op in ops:
                hist[op] = hist.get(op, 0) + 1
            hists[name][kid] = dict(sorted(hist.items(), key=lambda kv: -kv[1]))
            print(f"SASS {name} {kid} (P = 2): {len(ops)} instructions; "
                  + ", ".join(f"{k} {v}" for k, v in list(hists[name][kid].items())[:12]))
    return hists


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", required=True, type=Path,
                    help="directory holding the other version's "
                         "universal_quantum_optimal_control_tpu_torch/ops")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=FLAGS: this tree's sources with extra nvcc flags")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sass", type=Path, default=None,
                    help="directory for each build's SASS and its opcode counts")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("su2_kernel_turns: needs a CUDA card", file=sys.stderr)
        return 1
    builds = {"parent": load_build(args.parent / OPS, "parent_build"),
              "this": load_build(ROOT / OPS, "this_build")}
    for spec in args.variant:
        name, _, flags = spec.partition("=")
        builds[name] = load_build(ROOT / OPS, f"{name}_build", flags.split(),
                                  ROOT / "build" / "variants" / name)
    built = {k: b.build_libraries(["su2"]) for k, b in builds.items()}
    ptx = {k: chip_smoke.ptxas_table(v) for k, v in built.items()}
    run = {k: Launchers(b) for k, b in builds.items()}
    hists = sass_histograms(builds, built, args.sass) if args.sass else None
    order = list(builds)[:1] + list(builds)[1:] + list(builds)[1:][::-1] + list(builds)[:1]

    gen = torch.Generator(device="cuda").manual_seed(10)
    inputs = {name: chip_smoke.random_inputs(gen, *shape, torch.device("cuda"))
              for name, shape in SHAPES.items()}
    card = chip_smoke.nvidia_smi()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    rows, failures = [], []
    for kid, shape_name in ROWS:
        pulses, q_t, delta, eps = inputs[shape_name]
        B, L, P, M = SHAPES[shape_name]
        gbar = torch.full((B,), 1.0 / B, device="cuda")
        g = training_cotangent(pulses, q_t, delta, eps) if kid == "B2" else None
        if kid == "B2":  # each build's B2 on its own B3's product, as training runs it
            prods = {k: r.b3(pulses, delta, eps).clone() for k, r in run.items()}
            fns = {k: (lambda r=r, q=prods[k]: r.b2(pulses, delta, eps, g, q))
                   for k, r in run.items()}
        elif kid == "B1":
            fns = {k: (lambda r=r: (r.b1(pulses, q_t, delta, eps),)) for k, r in run.items()}
        elif kid == "B3":
            fns = {k: (lambda r=r: (r.b3(pulses, delta, eps),)) for k, r in run.items()}
        else:
            fns = {k: (lambda r=r: r.b1_backward(pulses, q_t, delta, eps, gbar))
                   for k, r in run.items()}
        outs = {k: tuple(t.clone() for t in fn()) for k, fn in fns.items()}
        again = tuple(t.clone() for t in fns["this"]())
        torch.cuda.synchronize()
        rerun_same = all(torch.equal(a, b) for a, b in zip(outs["this"], again))
        diffs = {k: max_diff(outs["parent"], o) for k, o in outs.items() if k != "parent"}
        # against the plain version in f64
        args64 = [t.double() for t in (pulses, q_t, delta, eps)]
        if kid == "B1":
            exact = (tk.mean_fidelity_plain(*args64),)
        elif kid == "B3":
            exact = (tk.propagate_mc_plain(args64[0], *args64[2:]),)
        elif kid == "B2":
            exact = tk.propagate_mc_vjp_plain(args64[0], *args64[2:], g.double())
        else:
            leaves = [t.clone().requires_grad_(True) for t in args64]
            exact = torch.autograd.grad(tk.mean_fidelity_plain(*leaves), leaves, gbar.double())
        vs_f64 = {k: max_diff(o, exact) for k, o in outs.items()}
        # the launches in turns (eager, buffers allocated), then as graphs
        times = [(who, chip_smoke.time_ms(fns[who], args.iters)) for who in order]
        graphs = [(who, graph_ms(fns[who], args.iters)) for who in order]
        eager = {k: sum(t for w, t in times if w == k) / 2 for k in builds}
        device = {k: sum(t for w, t in graphs if w == k) / 2 for k in builds}
        if kid == "B1":
            bnd = chip_smoke.bound(B, L, P, M, 4 * B, fidelity=True)
        elif kid == "B3":
            bnd = chip_smoke.bound(B, L, P, M, 16 * B * M, fidelity=False)
        elif kid == "B2":
            bnd = chip_smoke.vjp_bound(B, L, P, M)
        else:
            bnd = (None, None)
        row = {"kernel": kid, "shape": shape_name, "B": B, "L": L, "P": P, "M": M,
               "times_ms": times, "graph_times_ms": graphs, "eager_ms": eager,
               "device_ms": device, "bound_ms": bnd[0], "bound_by": bnd[1],
               "max_abs_diff_vs_parent": diffs, "max_abs_err_vs_f64": vs_f64,
               "rerun_same_bits": rerun_same,
               "libm_samples": chip_smoke.libm_samples(pulses, delta, eps)}
        if kid in ENTRY:
            entry = ENTRY[kid] + f"ILi{P}E"
            row["ptxas"] = {k: chip_smoke.ptxas_of(t, entry) for k, t in ptx.items()}
            row["occupancy"] = {}
            for k, r in run.items():
                if not r.new:
                    continue
                knum = {"B1": 1, "B2": 2, "B3": 3}[kid]
                per_sm = r.lib.uqoc_su2_blocks_per_sm(knum, P, L)
                threads = r.lib.uqoc_su2_threads(knum)
                blocks = B * math.ceil(M / threads)
                row["occupancy"][k] = {"threads_per_block": threads, "blocks_per_sm": per_sm,
                                       "waves": blocks / (per_sm * n_sm)}
        rows.append(row)
        shares = "" if bnd[0] is None else ", share of bound " + " / ".join(
            f"{k} {100 * bnd[0] / device[k]:.1f} %" for k in builds)
        print(f"{kid} {shape_name} {(B, L, P, M)}: eager "
              + ", ".join(f"{w} {t:.4f}" for w, t in times) + " ms; device (graph) "
              + ", ".join(f"{k} {t:.4f}" for k, t in device.items()) + " ms"
              + ("" if bnd[0] is None else f"; bound {bnd[0]:.4f} ms ({bnd[1]})") + shares
              + "; vs parent " + ", ".join(f"{k} {d:.2e}" for k, d in diffs.items())
              + "; vs f64 " + ", ".join(f"{k} {d:.2e}" for k, d in vs_f64.items())
              + f"; rerun same bits {rerun_same}"
              + ("; ptxas " + ", ".join(f"{k} {v.get('registers')} regs" for k, v in
                                        row["ptxas"].items()) if "ptxas" in row else "")
              + ("; occupancy " + json.dumps(row["occupancy"]) if row.get("occupancy") else ""),
              flush=True)
        if not all(d <= TOL for d in diffs.values()):
            failures.append(f"{kid} {shape_name}: builds differ by {diffs} > {TOL:.0e}")
        if not rerun_same:
            failures.append(f"{kid} {shape_name}: this tree's rerun gave other bits")
    print(json.dumps({"card": card, "rows": rows, "sass": hists}))
    if failures:
        raise AssertionError("; ".join(failures))
    return 0


if __name__ == "__main__":
    sys.exit(main())
