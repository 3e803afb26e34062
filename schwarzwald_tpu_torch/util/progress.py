"""Progress reporting + throughput sampling.

Parity: ProgressReporter named atomic counters (schwarzwald/util/debug/
ProgressReporter.h:8-80; counter names from core/util/Definitions.h:77-82)
and ThroughputSampler discontinuous (count, duration) windows
(util/debug/ThroughputCounter.h:30-48) feeding the adaptive scheduler.
"""
from __future__ import annotations

import collections
import threading
import time

LOADING = "loading"
INDEXING = "indexing"
CONVERTING = "converting"
GENERATING_TILESETS = "generating tilesets"


class ProgressReporter:
    def __init__(self):
        self._lock = threading.Lock()
        self._progress: dict[str, float] = {}
        self._maxima: dict[str, float] = {}

    def register_progress_counter(self, name: str, maximum) -> None:
        with self._lock:
            self._progress[name] = 0
            self._maxima[name] = maximum

    def increment(self, name: str, amount=1) -> None:
        with self._lock:
            self._progress[name] = self._progress.get(name, 0) + amount

    # increment_progress alias (ProgressReporter.h naming)
    increment_progress = increment

    def get_progress(self, name: str):
        with self._lock:
            return self._progress.get(name, 0)

    def get_progress_as_percentage(self, name: str) -> float:
        with self._lock:
            maximum = self._maxima.get(name) or 0
            if not maximum:
                return 0.0
            return 100.0 * self._progress.get(name, 0) / maximum

    def counters(self):
        with self._lock:
            return {name: (self._progress.get(name, 0), self._maxima[name])
                    for name in self._maxima}


class ThroughputSampler:
    """Sliding window of (count, duration) samples -> items/second."""

    def __init__(self, window: int = 1):
        self._samples = collections.deque(maxlen=window)
        self._lock = threading.Lock()

    def push_sample(self, count: int, duration_seconds: float) -> None:
        with self._lock:
            self._samples.append((count, duration_seconds))

    def get_throughput_per_second(self) -> float:
        with self._lock:
            total = sum(c for c, _ in self._samples)
            seconds = sum(d for _, d in self._samples)
            return total / seconds if seconds > 0 else 0.0


class ThroughputCounter:
    """Sliding window of continuous (count, timestamp) samples
    (ThroughputCounter.h:6-28): rate over the spanned wall-clock window."""

    def __init__(self, window: int = 16):
        self._samples = collections.deque(maxlen=window)
        self._lock = threading.Lock()

    def push_entry(self, count: int, timestamp: float | None = None) -> None:
        with self._lock:
            self._samples.append((count,
                                  timestamp if timestamp is not None
                                  else time.perf_counter()))

    def get_throughput_per_second(self) -> float:
        with self._lock:
            if len(self._samples) < 2:
                return 0.0
            total = sum(c for c, _ in list(self._samples)[1:])
            span = self._samples[-1][1] - self._samples[0][1]
            return total / span if span > 0 else 0.0


class Timer:
    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self.start
        return False
