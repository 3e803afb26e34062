"""Point sources: multi-file concurrent read front-end.

Parity: PointSource / MultiReaderPointSource (schwarzwald/core/point_source/
PointSource.{h,cpp}): per-file lock/release handles so multiple reader
threads each own one file at a time, a per-point transformation chain
applied after decode (SRS + 3DTILES center-shift, installed by the process
layer, TilerProcess.cpp:539-561), and IgnoreErrors handling for corrupted
files mid-read (points dropped, cursor forced to end, PointSource.cpp:36-50).

Adds what the reference lacks (SURVEY §4): an in-memory source so full-tiler
integration tests run hermetically.
"""
from __future__ import annotations

import threading

from ..core.pointbuffer import PointBuffer
from ..util.errors import IgnoreErrors, chain_error
from . import las


class FileCursor:
    """One input file + read position."""

    def __init__(self, path: str):
        self.path = path
        self.position = 0
        self._file: las.LASFile | None = None

    def open(self):
        if self._file is None:
            self._file = las.LASFile(self.path)
        return self._file

    def read_next_fused(self, count: int, attributes, shift_to_center: bool,
                        center, bounds_min, bounds_max) -> PointBuffer:
        f = self.open()
        buf = f.read_points_fused(self.position, count, attributes,
                                  shift_to_center, center, bounds_min,
                                  bounds_max)
        self.position += buf.count
        return buf

    def read_next_fused_into(self, count: int, attributes,
                             shift_to_center: bool, center, bounds_min,
                             bounds_max, out_buffer, out_keys,
                             offset: int) -> int:
        f = self.open()
        n = f.read_points_fused_into(self.position, count, attributes,
                                     shift_to_center, center, bounds_min,
                                     bounds_max, out_buffer, out_keys, offset)
        self.position += n
        return n

    @property
    def exhausted(self) -> bool:
        if self._file is None:
            try:
                self.open()
            except Exception:
                return True
        return self.position >= self._file.count

    def read_next(self, count: int, attributes=None) -> PointBuffer:
        f = self.open()
        buf = f.read_points(self.position, count, attributes)
        self.position += buf.count
        return buf

    def force_to_end(self) -> None:
        if self._file is not None:
            self.position = self._file.count
        else:
            self.position = 1 << 62


class InMemorySource:
    """Hermetic source for tests: a list of PointBuffers acting as 'files'."""

    def __init__(self, buffers):
        self._buffers = list(buffers)
        self._positions = [0] * len(self._buffers)

    def paths(self):
        return [f"<memory:{i}>" for i in range(len(self._buffers))]

    def count_of(self, index: int) -> int:
        return self._buffers[index].count

    def read(self, index: int, start: int, count: int) -> PointBuffer:
        return self._buffers[index].slice(start, min(start + count,
                                                     self._buffers[index].count))


class MultiReaderPointSource:
    """Concurrent multi-file read front-end with per-file handles."""

    def __init__(self, sources, errors_to_ignore: IgnoreErrors = IgnoreErrors.NONE):
        self._cursors = [FileCursor(p) for p in sources]
        self._errors_to_ignore = errors_to_ignore
        self._locked: set[int] = set()
        self._lock = threading.Lock()
        self._transformations = []
        self._attributes = None
        self._fused = None

    def add_transformation(self, fn) -> None:
        """fn(PointBuffer) -> PointBuffer applied after every read."""
        self._transformations.append(fn)

    def set_attributes(self, attributes) -> None:
        self._attributes = attributes

    def enable_fused_indexing(self, shift_to_center: bool, center,
                              bounds_min, bounds_max) -> None:
        """Fuse decode + (center-shift) + clamp + Morton encode into the
        read (only valid when the transform chain is the standard one, i.e.
        no SRS reprojection). Replaces add_transformation for positions."""
        import numpy as np

        self._fused = (bool(shift_to_center),
                       np.asarray(center, np.float64),
                       np.asarray(bounds_min, np.float64),
                       np.asarray(bounds_max, np.float64))

    def max_parallelism(self) -> int:
        """Read parallelism is bounded by the number of unfinished files."""
        with self._lock:
            return sum(1 for i, c in enumerate(self._cursors)
                       if not c.exhausted)

    def lock_source(self) -> int | None:
        """Acquire any unfinished, unlocked file; returns a handle index."""
        with self._lock:
            for i, cursor in enumerate(self._cursors):
                if i in self._locked or cursor.exhausted:
                    continue
                self._locked.add(i)
                return i
            return None

    def release_source(self, handle: int) -> None:
        with self._lock:
            self._locked.discard(handle)

    @property
    def supports_region_reads(self) -> bool:
        return self._fused is not None

    def read_next_into_region(self, handle: int, count: int, out_buffer,
                              out_keys, offset: int) -> int:
        """Fused region read: decode + transform + index directly into the
        preallocated batch slot at `offset` (disjoint-region reads,
        Tiler.cpp:376-405). Only valid when fused indexing is enabled."""
        cursor = self._cursors[handle]
        shift, center, bmin, bmax = self._fused
        try:
            return cursor.read_next_fused_into(
                count, self._attributes, shift, center, bmin, bmax,
                out_buffer, out_keys, offset)
        except Exception as err:
            if self._errors_to_ignore & IgnoreErrors.CORRUPTED_FILES:
                cursor.force_to_end()
                return 0
            raise chain_error(err, f"Reading points from {cursor.path} failed")

    def read_next_into(self, handle: int, count: int) -> PointBuffer:
        cursor = self._cursors[handle]
        try:
            if self._fused is not None:
                shift, center, bmin, bmax = self._fused
                buf = cursor.read_next_fused(count, self._attributes, shift,
                                             center, bmin, bmax)
            else:
                buf = cursor.read_next(count, self._attributes)
        except Exception as err:
            if self._errors_to_ignore & IgnoreErrors.CORRUPTED_FILES:
                # Drop the remainder of the corrupted file
                # (PointSource.cpp:36-50).
                cursor.force_to_end()
                return PointBuffer()
            raise chain_error(err, f"Reading points from {cursor.path} failed")
        if self._fused is None or buf.morton_keys is None:
            for fn in self._transformations:
                buf = fn(buf)
        return buf

    def all_exhausted(self) -> bool:
        with self._lock:
            return all(c.exhausted for c in self._cursors)

    # -- checkpoint support -------------------------------------------------

    def cursor_positions(self) -> dict:
        """Current read offsets per file (checkpoint state)."""
        with self._lock:
            return {c.path: c.position for c in self._cursors}

    def restore_positions(self, positions: dict) -> None:
        with self._lock:
            for cursor in self._cursors:
                if cursor.path in positions:
                    cursor.position = int(positions[cursor.path])
