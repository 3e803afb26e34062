"""SoA point container (host side, numpy).

The TPU-native analogue of PointBuffer (schwarzwald/core/datastructures/
PointBuffer.h:19-305): a struct-of-arrays container for positions plus up to
12 optional LAS attributes. Unlike the reference's per-point proxy iterators,
all operations here are whole-column vectorized — `take` (fancy-gather) is the
workhorse that replaces per-point copies in the persist path.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .attributes import ATTRIBUTE_LAYOUT, PointAttribute


def _column(attr: PointAttribute, count: int) -> np.ndarray:
    dtype, width = ATTRIBUTE_LAYOUT[attr]
    shape = (count, width) if width > 1 else (count,)
    return np.zeros(shape, dtype=dtype)


@dataclasses.dataclass
class PointBuffer:
    """positions is always present; other attributes are optional columns."""

    positions: np.ndarray  # (N, 3) float64
    columns: dict  # PointAttribute -> ndarray (excluding Position)
    # Optional precomputed Morton-63 keys aligned with positions (set by the
    # fused read+index path; the tiling engine uses them when present).
    morton_keys: np.ndarray | None

    def __init__(self, positions=None, columns=None, **kwargs):
        if positions is None:
            positions = np.empty((0, 3), dtype=np.float64)
        self.positions = np.ascontiguousarray(positions, dtype=np.float64)
        self.columns = {}
        self.morton_keys = None
        if columns:
            for attr, arr in columns.items():
                self.set_column(attr, arr)
        for name, arr in kwargs.items():
            self.set_column(PointAttribute[name], arr)

    @classmethod
    def empty(cls, count: int, attributes) -> "PointBuffer":
        """Preallocated buffer (PointBuffer.h:127 ctor) enabling concurrent
        region-writes by readers."""
        buf = cls(np.zeros((count, 3), dtype=np.float64))
        for attr in attributes:
            if attr != PointAttribute.Position:
                buf.columns[attr] = _column(attr, count)
        return buf

    @property
    def count(self) -> int:
        return int(self.positions.shape[0])

    def __len__(self) -> int:
        return self.count

    @property
    def empty_(self) -> bool:
        return self.count == 0

    def attributes(self):
        return {PointAttribute.Position} | set(self.columns)

    def has(self, attr: PointAttribute) -> bool:
        return attr == PointAttribute.Position or attr in self.columns

    def get(self, attr: PointAttribute):
        if attr == PointAttribute.Position:
            return self.positions
        return self.columns.get(attr)

    def set_column(self, attr: PointAttribute, arr) -> None:
        if attr == PointAttribute.Position:
            self.positions = np.ascontiguousarray(arr, dtype=np.float64)
            return
        dtype, width = ATTRIBUTE_LAYOUT[attr]
        arr = np.asarray(arr, dtype=dtype)
        expected = (self.count, width) if width > 1 else (self.count,)
        if arr.shape != expected:
            raise ValueError(
                f"Column {attr} has shape {arr.shape}, expected {expected}"
            )
        self.columns[attr] = arr

    def take(self, indices) -> "PointBuffer":
        """Gather a sub-buffer by indices (replaces per-point copying).

        Routes through the native prefetching row gather when available —
        numpy fancy indexing is DRAM-latency bound on big out-of-LLC
        buffers and this is the persist path's workhorse."""
        gathered = _native_take(self, indices)
        if gathered is not None:
            return gathered
        out = PointBuffer(self.positions[indices])
        for attr, arr in self.columns.items():
            out.columns[attr] = arr[indices]
        return out

    def slice(self, start: int, stop: int) -> "PointBuffer":
        out = PointBuffer(self.positions[start:stop])
        for attr, arr in self.columns.items():
            out.columns[attr] = arr[start:stop]
        return out

    def write_region(self, offset: int, other: "PointBuffer") -> None:
        """Write `other` into [offset, offset+len(other)) of this buffer."""
        end = offset + other.count
        self.positions[offset:end] = other.positions
        for attr, arr in other.columns.items():
            if attr in self.columns:
                self.columns[attr][offset:end] = arr

    def append(self, other: "PointBuffer") -> "PointBuffer":
        """Concatenate; keeps only attributes present in both (apply_schema
        discipline, PointBuffer.h:141-167)."""
        if self.count == 0:
            return other.copy()
        if other.count == 0:
            return self.copy()
        out = PointBuffer(np.concatenate([self.positions, other.positions]))
        for attr in set(self.columns) & set(other.columns):
            out.columns[attr] = np.concatenate(
                [self.columns[attr], other.columns[attr]]
            )
        return out

    def copy(self) -> "PointBuffer":
        out = PointBuffer(self.positions.copy())
        out.columns = {a: arr.copy() for a, arr in self.columns.items()}
        return out

    def detach_base(self) -> "PointBuffer":
        """Return a buffer whose arrays own their memory (self when they
        already do). Long-lived references (the node cache) must not hold
        slice VIEWS: a view keeps its whole base array alive, so caching
        per-node views of a batch-level gather pins the entire gather
        while the LRU accounts only the view's nbytes — measured as the
        100M uniform soak's ~20 GB peak RSS (per-level revisit gathers
        pinned by cached node slices; detaching re-bounds the cache at
        its byte budget)."""
        if (self.positions.base is None
                and (self.morton_keys is None
                     or self.morton_keys.base is None)
                and all(arr.base is None
                        for arr in self.columns.values())):
            return self
        out = PointBuffer(self.positions if self.positions.base is None
                          else self.positions.copy())
        out.columns = {a: (arr if arr.base is None else arr.copy())
                       for a, arr in self.columns.items()}
        if self.morton_keys is not None:
            out.morton_keys = (self.morton_keys
                               if self.morton_keys.base is None
                               else self.morton_keys.copy())
        return out

    def keep_attributes(self, attributes) -> "PointBuffer":
        out = PointBuffer(self.positions)
        out.columns = {a: arr for a, arr in self.columns.items() if a in attributes}
        return out

    @staticmethod
    def concatenate(buffers) -> "PointBuffer":
        buffers = [b for b in buffers if b.count]
        if not buffers:
            return PointBuffer()
        out = PointBuffer(np.concatenate([b.positions for b in buffers]))
        common = set(buffers[0].columns)
        for b in buffers[1:]:
            common &= set(b.columns)
        for attr in common:
            out.columns[attr] = np.concatenate([b.columns[attr] for b in buffers])
        if all(b.morton_keys is not None for b in buffers):
            out.morton_keys = np.concatenate([b.morton_keys for b in buffers])
        return out

    def __eq__(self, other) -> bool:
        if not isinstance(other, PointBuffer):
            return NotImplemented
        if not np.array_equal(self.positions, other.positions):
            return False
        if set(self.columns) != set(other.columns):
            return False
        return all(
            np.array_equal(arr, other.columns[a]) for a, arr in self.columns.items()
        )


_TAKE_MIN_ROWS = 2048


def _native_take(buf: PointBuffer, indices) -> "PointBuffer | None":
    """take() through the native single-chunk row gather, one flat pass
    per column. Returns None (numpy fallback) for small gathers, boolean
    masks, or dtypes the kernel has no row size for."""
    idx = np.asarray(indices)
    if idx.dtype == bool or idx.size < _TAKE_MIN_ROWS or idx.ndim != 1:
        return None
    from .. import native
    lib = native.las_codec()
    if lib is None:
        return None
    cols = list(buf.columns.items())
    for _, arr in cols:
        if not arr.flags.c_contiguous or arr.itemsize * (
                arr.shape[1] if arr.ndim > 1 else 1) not in (
                    1, 2, 3, 4, 6, 8, 16, 24):
            return None
    if not buf.positions.flags.c_contiguous:
        return None
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    if idx.size and (idx.min() < 0 or idx.max() >= buf.count):
        return None  # numpy handles negative / out-of-range semantics
    out = PointBuffer.__new__(PointBuffer)
    out.positions = np.empty((idx.size, 3), dtype=np.float64)
    out.morton_keys = None
    lib.gather_rows_single(buf.positions, idx, 24, out.positions)
    out.columns = {}
    for attr, arr in cols:
        row = arr.itemsize * (arr.shape[1] if arr.ndim > 1 else 1)
        dst = np.empty((idx.size,) + arr.shape[1:], dtype=arr.dtype)
        lib.gather_rows_single(arr, idx, row, dst)
        out.columns[attr] = dst
    return out
