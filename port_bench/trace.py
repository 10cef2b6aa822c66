"""A profiled sub-window and its reduction: kernels, busy time, idle gaps.

``torch.profiler`` (CPU and CUDA activities) records a fixed number of
units (steps or requests) run back to back inside a ``port_bench.window``
annotation; the trace is written to a temporary file, read back and
deleted.  Device operations are the kernels, copies and sets; their
union clipped to the annotation is the busy time.  A kernel is the
program's own unless its name marks it as ATen's, cuBLAS's, cuDNN's,
NCCL's or another library's, or as a copy or a set (a CUDA graph's memcpy
and memset nodes run as kernels).  Device time is also summed by class of
operation (:data:`CLASSES`).
"""

from __future__ import annotations

import json
import os
import re
import tempfile
import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LIBRARY = re.compile(
    r"at::|at_cuda_detail|c10::|cunn_|cublas|cutlass|gemm|gemv|xmma|sgemm|splitK|"
    r"nvjet|softmax_warp|dot_kernel|nrm2|cudnn|nccl|cub::|thrust::|flash|fmha|pytorch_|"
    r"memcpy|memset",
    re.IGNORECASE)
WINDOW = "port_bench.window"
# Classes of a library's kernels, the first whose pattern matches the name;
# a kernel that none matches is "other" (see :func:`op_class`).
CLASSES = (
    ("gemm", re.compile(r"gemm|gemv|xmma|nvjet|splitK|dot_kernel|cublas", re.IGNORECASE)),
    ("draws", re.compile(r"distribution_|philox|curand|normal_kernel", re.IGNORECASE)),
    ("elementwise", re.compile(r"elementwise|reduce_kernel|multi_tensor_apply|foreach|fused_adam",
                               re.IGNORECASE)),
)
_COPY = re.compile(r"memcpy|memset", re.IGNORECASE)


def is_library_kernel(name: str) -> bool:
    return bool(_LIBRARY.search(name))


def op_class(cat: str, name: str) -> str:
    """The class of one device operation: "copy" for a copy or a set, kernel
    or not; "program" for the program's own kernels; else the first of
    :data:`CLASSES` whose pattern matches, or "other"."""
    if cat != "kernel" or _COPY.search(name):
        return "copy"
    if not is_library_kernel(name):
        return "program"
    return next((cls for cls, pattern in CLASSES if pattern.search(name)), "other")


def profile(unit: Callable[[], None], n: int, device: torch.device) -> List[dict]:
    """Run ``unit`` ``n`` times under the profiler; the trace's events."""
    from torch.profiler import ProfilerActivity, profile as torch_profile, record_function

    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize(device)
    with torch_profile(activities=activities) as prof:
        with record_function(WINDOW):
            for _ in range(n):
                unit()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return [e for e in events if e.get("ph") == "X"]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return [(a, b) for a, b in merged]


def reduce(events: List[dict], units: int) -> Dict:
    """Sums over the annotated sub-window, in seconds: ``window_s``,
    ``busy_s`` (union of device operations), ``kernels`` (count),
    ``port_kernel_s`` (the program's own kernels), ``by_class`` (device time
    of each class of operation, :func:`op_class`), and the breakdown's ten
    longest device operations and idle gaps, each gap named by the
    innermost host operation running at its middle."""
    window = [e for e in events if e.get("name") == WINDOW and e.get("cat") == "user_annotation"]
    w0 = min(float(e["ts"]) for e in window)
    w1 = max(float(e["ts"]) + float(e["dur"]) for e in window)
    device, host = [], []
    for e in events:
        a = max(float(e["ts"]), w0)
        b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if b <= a:
            continue
        if e.get("cat") in _DEVICE_CATS:
            device.append((a, b, e["cat"], e["name"]))
        elif e.get("cat") in ("cpu_op", "cuda_runtime") and e["name"] != WINDOW:
            host.append((a, b, e["name"]))
    kernels = [d for d in device if d[2] == "kernel"]
    by_name: Dict[str, float] = defaultdict(float)
    by_class: Dict[str, float] = defaultdict(float)
    for a, b, cat, name in device:
        by_name[name] += (b - a) * 1e-6
        by_class[op_class(cat, name)] += (b - a) * 1e-6
    busy = _union([(a, b) for a, b, _, _ in device])
    gaps: Dict[str, float] = defaultdict(float)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    host.sort()
    stack: List[Tuple[float, float, str]] = []
    j = 0
    for a, b in zip(edges[::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            while stack and stack[-1][1] < host[j][0]:
                stack.pop()
            stack.append(host[j])
            j += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        gaps[stack[-1][2] if stack else "host (between ops)"] += (b - a) * 1e-6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "units": units,
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "kernels": len(kernels),
        "port_kernel_s": sum((b - a) for a, b, _, name in kernels
                             if not is_library_kernel(name)) * 1e-6,
        "port_kernels": sorted({name[:80] for _, _, _, name in kernels
                                if not is_library_kernel(name)}),
        "by_class": dict(by_class),
        "breakdown": {"device_ops": [[n[:120], s] for n, s in top],
                      "idle_gaps": [[n[:120], s] for n, s in
                                    sorted(gaps.items(), key=lambda kv: -kv[1])[:10]]},
    }


def timed_profile(unit: Callable[[], None], n: int, device: torch.device) -> Dict:
    """Profile ``n`` units and reduce; adds ``seconds`` spent tracing."""
    t0 = time.perf_counter()
    out = reduce(profile(unit, n, device), n)
    out["seconds"] = time.perf_counter() - t0
    return out
