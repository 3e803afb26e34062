"""MIN_DISTANCE (Poisson-disk) sampling on the device.

The counterpart of schwarzwald_tpu/ops/device_poisson.py with the same
signature. `backend="cuda"` runs the hand-written CUDA kernels on the
calling thread's stream, with the prep on the card
(ops/poisson_cuda.range_mask_cuda, csrc/poisson.cu); `backend="cpu"` runs
the host prep and the block-sequential plain-torch version on the CPU. Both
run the f64 mode, which is bit-equal to the native host kernel, so
`--use-device` output is byte-identical to a host run. (The JAX package's
XLA relaxation `_relax`, kept there for f64 parity on the cpu backend, has
no counterpart: the plain version serves.)
"""
from __future__ import annotations

import numpy as np

from . import poisson_cuda


def poisson_accept_mask_device(sorted_keys: np.ndarray,
                               positions: np.ndarray,
                               root_extent_x: float, spacing: float,
                               analyze_mask: np.ndarray | None = None,
                               backend: str | None = None
                               ) -> np.ndarray | None:
    """Device Poisson-disk acceptance over one Morton-sorted range.

    Returns the boolean accept mask (same contract as the native
    poisson_accept_mask) or None when the range is outside the kernel's
    envelope (spacing <= 0, or the pair-list gate) and the caller's host
    kernel takes it. `sorted_keys` and `root_extent_x` are unused (kept for
    the reference signature): the kernel needs only the positions' order."""
    n = positions.shape[0]
    if n == 0:
        return np.zeros(0, dtype=bool)
    if backend not in ("cuda", "cpu"):
        raise ValueError(f"Poisson device backend must be cuda or cpu, "
                         f"got {backend!r}")
    if spacing <= 0:
        return None
    if backend == "cuda":
        mask = poisson_cuda.range_mask_cuda(positions, spacing, analyze_mask,
                                            "f64")
        poisson_cuda.count("pair_gate" if mask is None else "kernel")
        return mask
    prep = poisson_cuda.prep(positions, spacing, analyze_mask, "f64")
    poisson_cuda.count("pair_gate" if prep is None else "plain")
    return None if prep is None else poisson_cuda.accept_mask(prep, "cpu")
