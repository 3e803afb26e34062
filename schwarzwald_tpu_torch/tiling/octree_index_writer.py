"""Binary (de)serialization of Morton index arrays.

Parity: OctreeIndexWriter (schwarzwald/core/tiling/OctreeIndexWriter.h:
10-90): 'indx' magic header + count + raw uint64 keys; a debugging /
analysis artifact for dumping a node's sorted index stream.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = b"indx"


def write_octree_indices_to_file(path: str, keys: np.ndarray) -> None:
    keys = np.ascontiguousarray(keys, dtype="<u8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<Q", keys.size))
        f.write(keys.tobytes())


def read_octree_indices_from_file(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not an octree index file")
        (count,) = struct.unpack("<Q", f.read(8))
        return np.frombuffer(f.read(count * 8), dtype="<u8").copy()
