"""Native (C++) host kernels, loaded via ctypes.

The reference implements its whole runtime in C++; here the host-side hot
loops that cannot be vectorized (greedy Poisson-disk acceptance, LAS point
record transcoding) are C++ with numpy-fallback twins. The library is
compiled from this package's native/src automatically on first use when a
compiler is available (see loader.py).
"""
from __future__ import annotations

import functools

from ..util import startup


@functools.lru_cache(maxsize=1)
def _lib():
    try:
        from . import loader
        with startup.timed("native library"):
            return loader.load()
    except Exception:
        return None


def poisson_sample_kernel():
    """Returns callable(positions, node_min, node_max, spacing, analyze_mask)
    -> bool mask, or None if the native library is unavailable."""
    lib = _lib()
    if lib is None:
        return None
    return lib.poisson_accept_mask


def las_codec():
    """Returns the native LAS point-record transcoder or None."""
    lib = _lib()
    if lib is None:
        return None
    return lib
