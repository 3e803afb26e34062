"""The split of a tiler process's start: where its seconds go before and
in the first steps of TilerProcess.run.

Parts (seconds, summed when a part happens more than once in one run):

  - "interpreter to cli.main": from the process's start (the kernel's
    start time of the process) to the first call of cli.main;
  - "port imports": cli.main importing the tiler (no torch);
  - "import torch", "CUDA context", "kernel libraries": the card's set-up
    before the run (ops/device_start.py);
  - "native library": loading (and, when stale, building) the native
    host kernels (native._lib);
  - "TilerProcess.run".

cli.main starts a split (`begin`); TilerProcess.run logs it at its end on
one `start split:` line, a JSON object that also holds "run end (epoch)",
the wall clock when the run returned, and starts the next one. The CLI run
as a program logs one more line at the interpreter's exit handlers ("exit
handlers (epoch)", `log_at_exit`), so that a launcher can split the last
part, the run's end to the process's exit; a launcher that calls cli.main
itself registers `log_at_exit` with atexit. Imports no torch.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time

from . import log

PREFIX = "start split: "
RUN_END = "run end (epoch)"
AT_EXIT = "exit handlers (epoch)"

_lock = threading.Lock()
parts: dict = {}
_began = False  # cli.main has been called in this process


def process_age() -> float | None:
    """Seconds since this process started, to the kernel's clock tick
    (Linux: /proc/self/stat's start time against CLOCK_BOOTTIME); None
    where that is not readable."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def begin() -> None:
    """Start a split (cli.main): drop the parts so far; on the process's
    first call, add the interpreter's start."""
    global _began
    age = None if _began else process_age()
    _began = True
    with _lock:
        parts.clear()
        if age is not None:
            parts["interpreter to cli.main"] = age


def add(part: str, seconds: float) -> None:
    with _lock:
        parts[part] = parts.get(part, 0.0) + seconds


@contextlib.contextmanager
def timed(part: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        add(part, time.perf_counter() - t0)


def log_split() -> None:
    """One `start split:` line with every part so far and the wall clock
    now; the next run's parts start from none."""
    with _lock:
        doc = {k: round(v, 6) for k, v in parts.items()}
        parts.clear()
    doc[RUN_END] = time.time()
    log.info(PREFIX + json.dumps(doc))


def log_at_exit() -> None:
    """A `start split:` line with the wall clock when the interpreter runs
    its exit handlers (after it joined the threads that are not daemons,
    before it tears down the modules and unloads the libraries); the CLI
    registers it with atexit when it runs as a program."""
    log.info(PREFIX + json.dumps({AT_EXIT: time.time()}))


def parse(text: str) -> dict | None:
    """The `start split:` objects in a process's output merged, or None."""
    found = None
    for line in text.splitlines():
        if line.startswith(PREFIX):
            found = {**(found or {}), **json.loads(line[len(PREFIX):])}
    return found
