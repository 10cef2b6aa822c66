r"""Build and load the port's CUDA kernels: one ``nvcc`` call per source,
bound by ctypes.

Each source under ``ops/csrc/`` (``propagate_su2.cu``: B1, B2, B3;
``propagate_su4.cu``: B4, B6, B7; ``propagate_su4_bwd.cu``: B5, B8; all include
``common.cuh``, the SU(2) one ``su2.cuh``, the SU(4) two ``su4.cuh``) is
compiled for ``sm_90a`` into a shared library with a plain C interface,
``build/torch_kernels/libuqoc_<name>.so`` at the root of the checkout.  No
source includes a PyTorch header, so a build takes seconds, and the
``nvcc`` calls of all stale libraries run at once.  A build runs at first
use and is cached by a hash of the source, the shared headers and the
flags, kept beside the library; a changed source rebuilds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["NVCC_FLAGS", "SOURCES", "library_path", "build_libraries", "load_library",
           "raise_on"]

CSRC = Path(__file__).parent / "csrc"
SOURCES = {"su2": CSRC / "propagate_su2.cu", "su4": CSRC / "propagate_su4.cu",
           "su4_bwd": CSRC / "propagate_su4_bwd.cu"}
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def library_path(name: str) -> Path:
    return BUILD_DIR / f"libuqoc_{name}.so"


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (default "
        "/usr/local/cuda); the CUDA kernels are built with it at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build_libraries(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile each named library (default: all) unless its cached build
    matches its source; the stale ones' ``nvcc`` calls run concurrently.

    Returns ``{name: {"path", "seconds", "cached", "log"}}``; ``log`` is
    nvcc's output (``-Xptxas -v``: registers, spills, shared memory).
    Raises ``RuntimeError`` with nvcc's output if a build fails.
    """
    names = list(SOURCES if names is None else names)
    out, running = {}, {}
    for name in names:
        lib = library_path(name)
        stamp = lib.with_name(lib.name + ".sha256")
        log_path = lib.with_name(lib.name + ".log")
        digest = _digest(name)
        if lib.exists() and stamp.exists() and stamp.read_text() == digest:
            log = log_path.read_text() if log_path.exists() else ""
            out[name] = {"path": str(lib), "seconds": 0.0, "cached": True, "log": log}
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        running[name] = (proc, cmd, tmp, digest, time.perf_counter())
    failures = []
    for name, (proc, cmd, tmp, digest, t0) in running.items():
        log = proc.communicate()[0]
        seconds = time.perf_counter() - t0
        lib = library_path(name)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failures.append(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
            continue
        os.replace(tmp, lib)
        lib.with_name(lib.name + ".log").write_text(log)
        lib.with_name(lib.name + ".sha256").write_text(digest)
        out[name] = {"path": str(lib), "seconds": seconds, "cached": False, "log": log}
    if failures:
        raise RuntimeError("\n".join(failures))
    return out


def _declare_su2(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    for name in ("uqoc_su2_num_blocks", "uqoc_su2_vjp_num_blocks"):
        getattr(lib, name).argtypes = [i64]
        getattr(lib, name).restype = i32
    lib.uqoc_su2_threads.argtypes = [i32]
    lib.uqoc_su2_threads.restype = i32
    lib.uqoc_su2_blocks_per_sm.argtypes = [i32, i32, i32]
    lib.uqoc_su2_blocks_per_sm.restype = i32
    lib.uqoc_su2_max_len.argtypes = [i32, i32]
    lib.uqoc_su2_max_len.restype = i32
    lib.uqoc_su2_vjp_smem_bytes.argtypes = [i32, i32]
    lib.uqoc_su2_vjp_smem_bytes.restype = i64
    lib.uqoc_su2_poly_max.argtypes = []
    lib.uqoc_su2_poly_max.restype = f32
    lib.uqoc_su2_propagate_mc.argtypes = [ptr, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
    lib.uqoc_su2_propagate_mc.restype = i32
    lib.uqoc_su2_mean_fidelity.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
    lib.uqoc_su2_mean_fidelity.restype = i32
    lib.uqoc_su2_propagate_mc_vjp.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
    lib.uqoc_su2_propagate_mc_vjp.restype = i32


def _declare_su4(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.uqoc_su4_num_blocks.argtypes = [i32, i64]
    lib.uqoc_su4_num_blocks.restype = i32
    lib.uqoc_su4_lanes.argtypes = [i32, i64]
    lib.uqoc_su4_lanes.restype = i32
    lib.uqoc_su4_blocks_per_sm.argtypes = [i32, i64, i32, i32, i32]
    lib.uqoc_su4_blocks_per_sm.restype = i32
    lib.uqoc_su4_propagate_mc.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, f32, f32, i32, ptr]
    lib.uqoc_su4_propagate_mc.restype = i32
    lib.uqoc_su4_mean_fidelity.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, f32, f32, i32, ptr]
    lib.uqoc_su4_mean_fidelity.restype = i32
    lib.uqoc_su4_mean_fidelity_with_product.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, f32, f32, i32, ptr]
    lib.uqoc_su4_mean_fidelity_with_product.restype = i32


def _declare_su4_bwd(lib: ctypes.CDLL) -> None:
    ptr, i32, i64, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.uqoc_su4_vjp_num_blocks.argtypes = [i32, i64]
    lib.uqoc_su4_vjp_num_blocks.restype = i32
    lib.uqoc_su4_vjp_lanes.argtypes = [i32, i64]
    lib.uqoc_su4_vjp_lanes.restype = i32
    lib.uqoc_su4_vjp_blocks_per_sm.argtypes = [i32, i64, i32, i32, i32]
    lib.uqoc_su4_vjp_blocks_per_sm.restype = i32
    lib.uqoc_su4_objective_vjp.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i64, f32, f32, i32, ptr]
    lib.uqoc_su4_objective_vjp.restype = i32
    lib.uqoc_su4_objective_vjp_rebuild.argtypes = [
        ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
        i32, i32, i32, i64, f32, f32, i32, ptr]
    lib.uqoc_su4_objective_vjp_rebuild.restype = i32


_DECLARE = {"su2": _declare_su2, "su4": _declare_su4, "su4_bwd": _declare_su4_bwd}


def load_library(name: str) -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures
    of library ``name`` (``"su2"``, ``"su4"`` or ``"su4_bwd"``)."""
    with _lock:
        if name not in _libs:
            build_libraries([name])
            lib = ctypes.CDLL(str(library_path(name)))
            lib.uqoc_error_string.argtypes = [ctypes.c_int]
            lib.uqoc_error_string.restype = ctypes.c_char_p
            _DECLARE[name](lib)
            _libs[name] = lib
        return _libs[name]


def raise_on(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise ``RuntimeError`` naming the CUDA error if a launcher failed."""
    if err != 0:
        msg = lib.uqoc_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {err} ({msg})")
