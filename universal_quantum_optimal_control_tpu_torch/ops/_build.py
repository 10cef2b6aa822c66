r"""Build and load the port's CUDA kernels: one ``nvcc`` call, bound by ctypes.

``ops/csrc/propagate_su2.cu`` is compiled for ``sm_90a`` into a shared
library with a plain C interface, ``build/torch_kernels/libuqoc_su2.so`` at
the root of the checkout.  The source includes no PyTorch header, so the
build takes seconds.  It runs at first use and is cached by a hash of the
source and the flags, kept beside the library; a changed source rebuilds.
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
from typing import Optional

__all__ = ["NVCC_FLAGS", "SOURCE", "LIBRARY", "build_library", "load_library"]

SOURCE = Path(__file__).parent / "csrc" / "propagate_su2.cu"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "torch_kernels"
LIBRARY = BUILD_DIR / "libuqoc_su2.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (shutil.which("nvcc"), os.path.join(cuda_home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin (default "
        "/usr/local/cuda); the CUDA kernels are built with it at first use")


def _digest() -> str:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()


def build_library() -> dict:
    """Compile the library unless the cached build matches the source.

    Returns ``{"path", "seconds", "cached", "log"}``; ``log`` is nvcc's
    output (``-Xptxas -v`` register and shared-memory report).  Raises
    ``RuntimeError`` with nvcc's output if the build fails.
    """
    digest = _digest()
    stamp = LIBRARY.with_name(LIBRARY.name + ".sha256")
    log_path = LIBRARY.with_name(LIBRARY.name + ".log")
    if LIBRARY.exists() and stamp.exists() and stamp.read_text() == digest:
        log = log_path.read_text() if log_path.exists() else ""
        return {"path": str(LIBRARY), "seconds": 0.0, "cached": True, "log": log}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_name(f"{LIBRARY.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, LIBRARY)
    log_path.write_text(log)
    stamp.write_text(digest)
    return {"path": str(LIBRARY), "seconds": seconds, "cached": False, "log": log}


def load_library() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C signatures."""
    global _lib
    with _lock:
        if _lib is None:
            build_library()
            lib = ctypes.CDLL(str(LIBRARY))
            ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
            lib.uqoc_su2_error_string.argtypes = [i32]
            lib.uqoc_su2_error_string.restype = ctypes.c_char_p
            lib.uqoc_su2_num_blocks.argtypes = [i64]
            lib.uqoc_su2_num_blocks.restype = i32
            lib.uqoc_su2_propagate_mc.argtypes = [
                ptr, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
            lib.uqoc_su2_propagate_mc.restype = i32
            lib.uqoc_su2_mean_fidelity.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
            lib.uqoc_su2_mean_fidelity.restype = i32
            lib.uqoc_su2_propagate_mc_vjp.argtypes = [
                ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i64, ptr]
            lib.uqoc_su2_propagate_mc_vjp.restype = i32
            _lib = lib
        return _lib
