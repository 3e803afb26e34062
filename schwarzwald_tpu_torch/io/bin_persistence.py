"""BIN/BINZ node persistence: the tiler's lossless columnar dump.

Exact file format of BinaryPersistence (schwarzwald/core/io/
BinaryPersistence.h:24-200): u32 attribute bitmask, u64 point count,
positions as (N,3) float64, then per-attribute columns in the fixed write
order; BINZ wraps the stream in zlib (best_speed, matching
boost::iostreams::zlib_compressor defaults which emit a standard zlib
stream).
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from ..core.attributes import PointAttribute
from ..core.pointbuffer import PointBuffer

A = PointAttribute

# (bit, attribute, dtype, width) in FILE WRITE ORDER
# (BinaryPersistence.h:121-200; bit constants :24-36).
_LAYOUT = [
    (1 << 0, A.RGB, "u1", 3),
    (1 << 1, A.Normal, "<f4", 3),
    (1 << 2, A.Intensity, "<u2", 1),
    (1 << 3, A.Classification, "u1", 1),
    (1 << 4, A.EdgeOfFlightLine, "u1", 1),
    (1 << 5, A.GPSTime, "<f8", 1),
    (1 << 6, A.NumberOfReturns, "u1", 1),
    (1 << 7, A.ReturnNumber, "u1", 1),
    (1 << 8, A.PointSourceID, "<u2", 1),
    (1 << 10, A.ScanAngleRank, "i1", 1),
    (1 << 9, A.ScanDirectionFlag, "u1", 1),
    (1 << 11, A.UserData, "u1", 1),
]


def serialize(points: PointBuffer, output_attributes=None) -> bytes:
    chunks = []
    bitmask = 0
    for bit, attr, _, _ in _LAYOUT:
        if points.has(attr) and (output_attributes is None
                                 or attr in output_attributes):
            bitmask |= bit
    chunks.append(struct.pack("<IQ", bitmask, points.count))
    chunks.append(np.ascontiguousarray(points.positions,
                                       dtype="<f8").tobytes())
    for bit, attr, dtype, _ in _LAYOUT:
        if bitmask & bit:
            chunks.append(np.ascontiguousarray(points.get(attr),
                                               dtype=dtype).tobytes())
    return b"".join(chunks)


def deserialize(raw: bytes) -> PointBuffer:
    bitmask, count = struct.unpack_from("<IQ", raw, 0)
    off = 12
    positions = np.frombuffer(raw, dtype="<f8", count=count * 3,
                              offset=off).reshape(count, 3).copy()
    off += count * 24
    buf = PointBuffer(positions)
    for bit, attr, dtype, width in _LAYOUT:
        if not (bitmask & bit):
            continue
        dt = np.dtype(dtype)
        arr = np.frombuffer(raw, dtype=dt, count=count * width, offset=off)
        off += count * width * dt.itemsize
        if width > 1:
            arr = arr.reshape(count, width)
        buf.set_column(attr, arr.copy())
    return buf


class BinaryPersistence:
    is_lossless = True

    def __init__(self, work_dir: str, input_attributes=None,
                 output_attributes=None, compressed: bool = False):
        self.work_dir = work_dir
        self.output_attributes = output_attributes
        self.compressed = compressed
        self.extension = ".binz" if compressed else ".bin"
        os.makedirs(work_dir, exist_ok=True)
        from .staging import FileStaging
        self._staging = FileStaging(work_dir)

    def _path(self, node_name: str) -> str:
        return os.path.join(self.work_dir, node_name + self.extension)

    def persist_points(self, points: PointBuffer, bounds, node_name: str):
        if not points.count:
            return
        raw = serialize(points, self.output_attributes)
        if self.compressed:
            raw = zlib.compress(raw, 1)  # zlib::best_speed
        with open(self._staging.path_for(self._path(node_name)), "wb") as f:
            f.write(raw)

    def retrieve_points(self, node_name: str) -> PointBuffer:
        path = self._path(node_name)
        if not os.path.exists(path):
            return PointBuffer()
        with open(path, "rb") as f:
            raw = f.read()
        if self.compressed:
            raw = zlib.decompress(raw)
        return deserialize(raw)

    def node_exists(self, node_name: str) -> bool:
        return os.path.exists(self._path(node_name))

    def node_names(self) -> list:
        """Committed node names (engine convention), for the device
        revisit sweep's subtree enumeration."""
        ext = self.extension
        return sorted(f[:-len(ext)] for f in os.listdir(self.work_dir)
                      if f.endswith(ext)
                      and os.path.isfile(os.path.join(self.work_dir, f)))

    def begin_batch(self) -> None:
        self._staging.begin()

    def commit_batch(self, extra_renames=None) -> None:
        self._staging.commit(extra_renames)

    def close(self) -> None:
        pass
