"""Chrome-trace (chrome://tracing) span recording.

Parity: the tf::ChromeObserver executor traces the reference attaches to
its read/index executors under --journal (core/util/Scheduler.cpp:10-67,
86-105). Spans recorded here (read/index phases per iteration, per-node
work, persistence flushes) serialize to the Trace Event JSON format and
load directly in chrome://tracing / Perfetto.
"""
from __future__ import annotations

import json
import threading
import time


class ChromeTracer:
    def __init__(self):
        self._events: list[dict] = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def _now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def complete_event(self, name: str, start_us: float, dur_us: float,
                       track: str = "main", args: dict | None = None) -> None:
        with self._lock:
            self._events.append({
                "name": name, "ph": "X", "ts": start_us, "dur": dur_us,
                "pid": 0, "tid": track, **({"args": args} if args else {})})

    def span(self, name: str, track: str = "main", args: dict | None = None):
        tracer = self

        class _Span:
            def __enter__(self):
                self.start = tracer._now_us()
                return self

            def __exit__(self, *exc):
                tracer.complete_event(name, self.start,
                                      tracer._now_us() - self.start,
                                      track, args)
                return False

        return _Span()

    def instant(self, name: str, track: str = "main") -> None:
        with self._lock:
            self._events.append({"name": name, "ph": "i",
                                 "ts": self._now_us(), "pid": 0,
                                 "tid": track, "s": "t"})

    def write(self, path: str) -> None:
        with self._lock:
            doc = {"traceEvents": self._events, "displayTimeUnit": "ms"}
        with open(path, "w") as f:
            json.dump(doc, f)


_global_tracer: ChromeTracer | None = None


def global_tracer() -> ChromeTracer | None:
    return _global_tracer


def enable_tracing() -> ChromeTracer:
    global _global_tracer
    _global_tracer = ChromeTracer()
    return _global_tracer


def trace_span(name: str, track: str = "main"):
    """Span against the global tracer; no-op when tracing is disabled."""
    tracer = _global_tracer
    if tracer is None:
        class _Null:
            def __enter__(self):
                return self

            def __exit__(self, *exc):
                return False

        return _Null()
    return tracer.span(name, track)
