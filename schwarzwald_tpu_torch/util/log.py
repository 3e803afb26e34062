"""Mutex-guarded stdout logging (util::write_log,
schwarzwald/util/terminal/stdout_helper.h:10)."""
from __future__ import annotations

import sys
import threading

_lock = threading.Lock()
verbose = True


def write_log(message: str) -> None:
    with _lock:
        sys.stdout.write(message)
        if not message.endswith("\n"):
            sys.stdout.write("\n")
        sys.stdout.flush()


def info(message: str) -> None:
    if verbose:
        write_log(message)


def warn(message: str) -> None:
    write_log(f"warning: {message}")
