"""Morton interleave on the card: the binding of the CUDA kernel
(csrc/morton.cu) and its plain-torch version.

This is the counterpart of schwarzwald_tpu/ops/device.py
`morton_interleave_pallas` (:217) and `interleave21` (:201). Three 21-bit
grid coordinates per point become one 63-bit Morton key: bit i of z, y and
x goes to key bit 3i, 3i+1 and 3i+2. The key is one non-negative
torch.int64 (signed order equals unsigned order below 2^63), where the JAX
package split it into (hi, lo) uint32 words because the TPU lacks 64-bit
integers.

`interleave` dispatches on the tensors' device: a CUDA tensor launches the
kernel (and raises if it cannot), a CPU tensor runs `interleave21`.
`launches` counts kernel launches; the wrapper adds one where it launches
and nowhere else.
"""
from __future__ import annotations

import ctypes
import threading

import torch

_lock = threading.Lock()
launches = 0


def reset_counters() -> None:
    global launches
    with _lock:
        launches = 0


def snapshot() -> dict:
    with _lock:
        return {"launches": launches}


# -- the plain-torch version ---------------------------------------------------

def expand_bits_by_3(v: torch.Tensor) -> torch.Tensor:
    """Spread the low 21 bits of each int64 so that two zero bits separate
    neighbours (bit i goes to bit 3i)."""
    v = v.to(torch.int64) & 0x1FFFFF
    v = (v | (v << 32)) & 0x001F00000000FFFF
    v = (v | (v << 16)) & 0x001F0000FF0000FF
    v = (v | (v << 8)) & 0x100F00F00F00F00F
    v = (v | (v << 4)) & 0x10C30C30C30C30C3
    v = (v | (v << 2)) & 0x1249249249249249
    return v


def interleave21(x: torch.Tensor, y: torch.Tensor,
                 z: torch.Tensor) -> torch.Tensor:
    """21-bit grid coordinates -> the (n,) int64 Morton key, x highest in
    each bit triple (calculate_morton_index, OctreeAlgorithms.h:64-87)."""
    return (expand_bits_by_3(z) | (expand_bits_by_3(y) << 1)
            | (expand_bits_by_3(x) << 2))


# -- the CUDA kernel -----------------------------------------------------------

_c_fn = None


def _kernel_fn():
    """ctypes entry point of csrc/morton.cu (built and loaded at first
    use)."""
    global _c_fn
    if _c_fn is None:
        from ._cuda_build import load_kernel_library

        fn = load_kernel_library("morton").morton_interleave
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _c_fn = fn
    return _c_fn


def interleave_cuda(x: torch.Tensor, y: torch.Tensor,
                    z: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream. x, y, z: contiguous (n,)
    int32 CUDA tensors on one device. Returns the (n,) int64 keys on it."""
    device = x.device
    if device.type != "cuda":
        raise ValueError(f"interleave_cuda needs CUDA tensors, got {device}")
    n = x.shape[0] if x.dim() == 1 else -1
    for name, t in (("x", x), ("y", y), ("z", z)):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} has dtype {t.dtype}, expected "
                            f"torch.int32")
        if t.dim() != 1 or t.shape[0] != n:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                             f"one dimension of the same length as x")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    fn = _kernel_fn()
    out = torch.empty(n, dtype=torch.int64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(y.data_ptr()),
                 ctypes.c_void_p(z.data_ptr()), n,
                 ctypes.c_void_p(out.data_ptr()), ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"morton kernel launch failed: CUDA error {err}")
    global launches
    with _lock:
        launches += 1
    return out


def interleave(x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """The Morton keys of int32 grid coordinates on their device: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if x.device.type == "cuda":
        return interleave_cuda(x, y, z)
    if x.device.type == "cpu":
        return interleave21(x, y, z)
    raise ValueError(f"no Morton kernel for device {x.device}")
