"""In-memory persistence for tests and benchmarks.

Equivalent of MemoryPersistence (schwarzwald/core/io/MemoryPersistence.h:
14-52): node name -> PointBuffer map; lossless.
"""
from __future__ import annotations

import threading

from ..core.pointbuffer import PointBuffer


class MemoryPersistence:
    is_lossless = True

    def __init__(self):
        self._store: dict[str, tuple] = {}
        self._lock = threading.Lock()

    def persist_points(self, points: PointBuffer, bounds, node_name: str) -> None:
        with self._lock:
            self._store[node_name] = (points.copy(), bounds)

    def retrieve_points(self, node_name: str) -> PointBuffer:
        with self._lock:
            entry = self._store.get(node_name)
            return entry[0].copy() if entry else PointBuffer()

    def node_exists(self, node_name: str) -> bool:
        with self._lock:
            return node_name in self._store

    def node_names(self):
        with self._lock:
            return sorted(self._store)

    def bounds_of(self, node_name: str):
        with self._lock:
            return self._store[node_name][1]

    def close(self) -> None:
        pass
