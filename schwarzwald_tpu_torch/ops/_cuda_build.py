"""Build of the hand-written CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles each kernel source into a shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: seconds per build, not
minutes). The library lands in csrc/build/ and is rebuilt when its source
is newer, the way native/loader.py treats the C++ host kernels. The build
runs under a lock because the tiler's worker threads (and test processes)
can reach the first use at the same time.

Flags: sm_90a (Hopper), -O3, and -fmad=false so nvcc never contracts a
multiply and an add into an FMA: the kernels' distance tests must round
exactly as the host's.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time

from ..native.loader import build_lock, is_fresh

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: dict = {}
# name -> {"seconds": build wall time (0.0 when up to date), "log": ptxas}
build_info: dict = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built")


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and return the loaded library."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    with build_lock(BUILD_DIR):
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if is_fresh(so, [src]):
            build_info[name] = {"seconds": 0.0, "log": ""}
        else:
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "log": proc.stderr}
        lib = ctypes.CDLL(so)
        _loaded[name] = lib
    return lib
