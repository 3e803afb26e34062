"""`--use-device` and the card's set-up at the start of a run.

`resolve_use_device` resolves the option; for "cuda" it imports torch and
checks that torch can use a card. `set_up` then imports torch for "cuda"
and "cpu" and, under "cuda", creates the CUDA context and loads the
sampler's kernel library. The CLI calls both before it builds the
TilerProcess, and TilerProcess.run calls them again for library callers
(the second call does nothing), so the host run ("host") imports no torch
at all, a card run that cannot use the card fails before it writes
anything, and the start stays outside TilerProcess.run's durations.

The set-up runs on the caller's own thread. In a thread of its own beside
the read and the index it lost on an H100 host: `import torch` and the
engine's host threads wait on each other for the interpreter lock, so the
import took longer and the host work before the first device site more
than doubled (PERF.md section 6).

This module imports no torch when it is imported.
"""
from __future__ import annotations

import contextlib
import sys

from ..util import startup
from .sampling import GRID_SAMPLERS

NO_CARD = ("--use-device cuda: torch.cuda.is_available() is False (no CUDA "
           "card visible); pass --use-device host for the native host run "
           "or cpu for the plain-torch versions")

_ready: set = set()  # the (use_device, sampling) pairs set up


def _import_torch():
    """torch; its first import in the process timed for the start split."""
    first = "torch" not in sys.modules
    with startup.timed("import torch") if first else contextlib.nullcontext():
        import torch
    return torch


def resolve_use_device(requested: str) -> str | None:
    """Resolve --use-device to the engine's "cuda", "cpu" or None.

    "cuda" (the default) raises when torch sees no card; "cpu" selects the
    plain-torch versions of the kernels; "host" is the JAX package's
    default, the native host run (None to the engine). Only "cuda"
    imports torch."""
    if requested == "cuda":
        if not _import_torch().cuda.is_available():
            raise RuntimeError(NO_CARD)
        return "cuda"
    if requested == "cpu":
        return "cpu"
    if requested == "host":
        return None
    raise ValueError(f"--use-device must be cuda, cpu or host, "
                     f"got {requested!r}")


def set_up(use_device: str | None, sampling: str) -> None:
    """Import torch for a run on `use_device` ("cuda" or "cpu"; None, the
    host run, imports nothing), resolved by `resolve_use_device`. Under
    "cuda": create the CUDA context and load the kernel library that the
    sampler needs (K2's for MIN_DISTANCE*, the sweep X2's for the grid
    samplers), each timed for the start split (util/startup.py). Once for
    each pair of arguments."""
    if use_device is None or (use_device, sampling) in _ready:
        return
    torch = _import_torch()
    if use_device == "cuda":
        with startup.timed("CUDA context"):
            torch.cuda.synchronize()  # the first call creates the context
        # each timed as "kernel libraries"
        if sampling in GRID_SAMPLERS:
            from . import device_tiling

            device_tiling._kernel_fn()
        else:  # the Poisson samplers
            from . import poisson_cuda

            poisson_cuda._kernel_fns("f64")
    _ready.add((use_device, sampling))
