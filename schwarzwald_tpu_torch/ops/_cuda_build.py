"""Build of the hand-written CUDA kernels (csrc/*.cu) at first use.

`nvcc` compiles each kernel source into a shared library with a plain C
interface, loaded with ctypes (no PyTorch headers: seconds per build, not
minutes). The library lands in csrc/build/ and is rebuilt when its source
is newer, the way native/loader.py treats the C++ host kernels, or when it
was built with other flags (a stamp beside it holds the nvcc command). Each
library builds under its own lock (threads of this process and other
processes), because the tiler's worker threads and test processes can reach
its first use at the same time, while different libraries may build in
parallel.

Flags: sm_90a (Hopper), -O3, and -fmad=false so nvcc never contracts a
multiply and an add into an FMA: the kernels' distance tests must round
exactly as the host's; -lineinfo adds line tables only (no change to the
generated code), so that compute-sanitizer's reports name source lines.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
import time

from ..native.loader import is_fresh
from ..util import startup

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC_DIR, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-lineinfo", "-shared", "-Xcompiler",
              "-fPIC", "-Xptxas", "-v"]

_loaded: dict = {}
# name -> {"seconds": build wall time (0.0 when up to date), "log": ptxas}
build_info: dict = {}
_locks: dict = {}
_locks_guard = threading.Lock()


@contextlib.contextmanager
def _library_lock(name: str):
    """Exclusive per library, across the threads of this process and
    across processes."""
    with _locks_guard:
        lock = _locks.setdefault(name, threading.Lock())
    os.makedirs(BUILD_DIR, exist_ok=True)
    with lock, open(os.path.join(BUILD_DIR, f".{name}.lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


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


def _stamp(flags) -> str:
    """What a build's stamp holds: the flags, one per line."""
    return "\n".join(flags) + "\n"


def _built_with(so: str, flags) -> bool:
    try:
        with open(f"{so}.flags") as f:
            return f.read() == _stamp(flags)
    except OSError:
        return False


def load_kernel_library(name: str) -> ctypes.CDLL:
    """Build csrc/<name>.cu if needed and return the loaded library."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    src = os.path.join(CSRC_DIR, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}.so")
    with startup.timed("kernel libraries"), _library_lock(name):
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        if is_fresh(so, [src]) and _built_with(so, NVCC_FLAGS):
            build_info[name] = {"seconds": 0.0, "log": ""}
        else:
            tmp = f"{so}.{os.getpid()}.tmp"
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src]
            t0 = time.perf_counter()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
            os.replace(tmp, so)
            with open(f"{so}.flags", "w") as f:
                f.write(_stamp(NVCC_FLAGS))
            build_info[name] = {"seconds": time.perf_counter() - t0,
                                "log": proc.stderr}
        lib = ctypes.CDLL(so)
        _loaded[name] = lib
    return lib
