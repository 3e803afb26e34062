"""Memory-bounded LRU cache with eviction handlers.

Parity: LRUCache (schwarzwald/core/datastructures/LRUCache.h:15-116):
capacity in bytes, least-recently-used eviction when over budget, and
registered evict handlers called with each evicted (key, value). Sizing
uses a caller-provided size function (the reference's MemoryIntrospectable
concept, util/concepts/MemoryIntrospection.h:20-115); numpy-backed values
default to nbytes.
"""
from __future__ import annotations

import collections
import threading


def default_size_of(value) -> int:
    nbytes = getattr(value, "nbytes", None)
    if nbytes is not None:
        return int(nbytes)
    if hasattr(value, "positions"):  # PointBuffer
        total = value.positions.nbytes
        for arr in value.columns.values():
            total += arr.nbytes
        return total
    try:
        import sys
        return sys.getsizeof(value)
    except Exception:
        return 1


class LRUCache:
    def __init__(self, capacity_bytes: int, size_of=default_size_of):
        self.capacity = capacity_bytes
        self.size_of = size_of
        self._entries: collections.OrderedDict = collections.OrderedDict()
        self._sizes: dict = {}
        self._used = 0
        self._evict_handlers = []
        self._lock = threading.Lock()

    @property
    def used_bytes(self) -> int:
        return self._used

    def add_evict_handler(self, fn) -> None:
        self._evict_handlers.append(fn)

    def put(self, key, value) -> None:
        with self._lock:
            size = self.size_of(value)
            if key in self._entries:
                self._used -= self._sizes[key]
                del self._entries[key]
            self._entries[key] = value
            self._sizes[key] = size
            self._used += size
            evicted = []
            while self._used > self.capacity and len(self._entries) > 1:
                k, v = self._entries.popitem(last=False)
                self._used -= self._sizes.pop(k)
                evicted.append((k, v))
        for k, v in evicted:
            for fn in self._evict_handlers:
                fn(k, v)

    def try_get(self, key):
        with self._lock:
            if key not in self._entries:
                return None
            self._entries.move_to_end(key)
            return self._entries[key]

    def remove(self, key) -> None:
        with self._lock:
            if key in self._entries:
                del self._entries[key]
                self._used -= self._sizes.pop(key)

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key) -> bool:
        with self._lock:
            return key in self._entries
