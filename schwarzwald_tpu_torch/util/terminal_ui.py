"""Terminal progress UI.

Parity: TerminalUI + TerminalUIAsyncRenderer (schwarzwald/util/terminal/
TerminalUI.{h,cpp}): unicode block progress bars redrawn every 50 ms on a
TTY, plain log lines every 5 s otherwise, driven by a background thread.
"""
from __future__ import annotations

import sys
import threading

from .progress import ProgressReporter

TTY_REDRAW_INTERVAL = 0.05   # TerminalUI.h:84-88
LOG_INTERVAL = 5.0

_BLOCKS = " ▏▎▍▌▋▊▉█"


def render_progress_bar(fraction: float, width: int = 30) -> str:
    fraction = min(max(fraction, 0.0), 1.0)
    cells = fraction * width
    full = int(cells)
    frac = int((cells - full) * 8)
    bar = "█" * full
    if full < width:
        bar += _BLOCKS[frac]
        bar += " " * (width - full - 1)
    return bar


class TerminalUI:
    def __init__(self, progress: ProgressReporter):
        self.progress = progress
        self._is_tty = sys.stdout.isatty()
        self._lines_drawn = 0

    def redraw(self) -> None:
        counters = self.progress.counters()
        if not counters:
            return
        if self._is_tty:
            if self._lines_drawn:
                sys.stdout.write(f"\x1b[{self._lines_drawn}A")
            for name, (value, maximum) in counters.items():
                frac = value / maximum if maximum else 0.0
                bar = render_progress_bar(frac)
                sys.stdout.write(
                    f"\r{name:<12} [{bar}] {100 * frac:6.2f}% "
                    f"({value:,}/{maximum:,})\x1b[K\n")
            self._lines_drawn = len(counters)
            sys.stdout.flush()
        else:
            parts = [f"{name}: {100 * (v / m if m else 0):.1f}%"
                     for name, (v, m) in counters.items()]
            sys.stdout.write(" | ".join(parts) + "\n")
            sys.stdout.flush()


class TerminalUIAsyncRenderer:
    """Background redraw thread; use as a context manager."""

    def __init__(self, ui: TerminalUI):
        self.ui = ui
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self) -> None:
        interval = (TTY_REDRAW_INTERVAL if self.ui._is_tty else LOG_INTERVAL)
        while not self._stop.wait(interval):
            self.ui.redraw()

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=1.0)
        self.ui.redraw()
        return False
