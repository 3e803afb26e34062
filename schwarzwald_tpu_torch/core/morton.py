"""Morton-64 index machinery (vectorized numpy; device twin in ops/morton_jax.py).

Semantic parity targets:
  - Key layout: 21 levels x 3 bits, packed big-endian (root octant in the most
    significant 3 bits of the 63-bit key) — schwarzwald/core/datastructures/
    MortonIndex.h:54-169.
  - Encoding: normalize position to [0, 2^21) per axis, truncate, clamp to
    2^21-1, interleave with x in the highest of each bit-triple
    (key = z | y<<1 | x<<2) — schwarzwald/core/tiling/OctreeAlgorithms.h:64-87.
  - Naming conventions Simple / Potree ("r" prefix) / Entwine ("d-x-y-z") —
    MortonIndex.h:36-52, OctreeNodeIndex.h:386-416.
"""
from __future__ import annotations

import numpy as np

MAX_LEVELS = 21  # MortonIndex64Levels (MortonIndex.h:227)

_U = np.uint64


def expand_bits_by_3(v: np.ndarray) -> np.ndarray:
    """Spread the low 21 bits of each uint64 so 3 positions separate them."""
    v = v.astype(np.uint64) & _U(0x1FFFFF)
    v = (v | (v << _U(32))) & _U(0x1F00000000FFFF)
    v = (v | (v << _U(16))) & _U(0x1F0000FF0000FF)
    v = (v | (v << _U(8))) & _U(0x100F00F00F00F00F)
    v = (v | (v << _U(4))) & _U(0x10C30C30C30C30C3)
    v = (v | (v << _U(2))) & _U(0x1249249249249249)
    return v


def contract_bits_by_3(v: np.ndarray) -> np.ndarray:
    """Inverse of expand_bits_by_3 (gathers every 3rd bit)."""
    v = v.astype(np.uint64) & _U(0x1249249249249249)
    v = (v | (v >> _U(2))) & _U(0x10C30C30C30C30C3)
    v = (v | (v >> _U(4))) & _U(0x100F00F00F00F00F)
    v = (v | (v >> _U(8))) & _U(0x1F0000FF0000FF)
    v = (v | (v >> _U(16))) & _U(0x1F00000000FFFF)
    v = (v | (v >> _U(32))) & _U(0x1FFFFF)
    return v


def encode(positions: np.ndarray, bounds_min: np.ndarray, bounds_extent: np.ndarray) -> np.ndarray:
    """Morton-64 keys for positions relative to root bounds.

    Mirrors calculate_morton_index (OctreeAlgorithms.h:64-87): the scale is
    computed as 2^21 / extent first, then (pos - min) * scale, truncated
    toward zero and clamped to 2^21 - 1 so edge points don't overflow.
    Positions must already be inside the bounds (clamp outliers first; see
    index_point, OctreeAlgorithms.h:145-175).
    """
    positions = np.asarray(positions, dtype=np.float64)
    scale = (2.0 ** MAX_LEVELS) / np.asarray(bounds_extent, dtype=np.float64)
    normalized = (positions - np.asarray(bounds_min, dtype=np.float64)) * scale
    bits = np.minimum(normalized.astype(np.uint64), _U(2 ** MAX_LEVELS - 1))
    return (
        expand_bits_by_3(bits[..., 2])
        | (expand_bits_by_3(bits[..., 1]) << _U(1))
        | (expand_bits_by_3(bits[..., 0]) << _U(2))
    )


def encode_naive(position: np.ndarray, bounds) -> int:
    """Scalar oracle: descend octants level by level.

    Mirrors calculate_morton_index_naive (OctreeAlgorithms.h:89-102); used by
    property tests to pin the fast encoder (cf. TestOctreeIndexing.cpp:584).
    """
    from .aabb import octant_bounds, octant_of_position

    key = 0
    cur = bounds
    for level in range(MAX_LEVELS):
        octant = octant_of_position(position, cur)
        key = set_octant_at_level(key, level, octant)
        cur = octant_bounds(octant, cur)
    return int(key)


def grid_coords(keys: np.ndarray, levels: int | np.ndarray) -> tuple:
    """De-interleave node keys of the given depth into (x, y, z) grid indices.

    `keys` are depth-`levels` node keys (i.e. only the low 3*levels bits are
    used). Matches OctreeNodeIndex::to_grid_index (OctreeNodeIndex.h:357).
    """
    keys = np.asarray(keys, dtype=np.uint64)
    x = contract_bits_by_3(keys >> _U(2))
    y = contract_bits_by_3(keys >> _U(1))
    z = contract_bits_by_3(keys)
    return x, y, z


def from_grid_coords(x, y, z) -> np.ndarray:
    return (
        expand_bits_by_3(np.asarray(z, dtype=np.uint64))
        | (expand_bits_by_3(np.asarray(y, dtype=np.uint64)) << _U(1))
        | (expand_bits_by_3(np.asarray(x, dtype=np.uint64)) << _U(2))
    )


def truncate_to_level(keys: np.ndarray, level) -> np.ndarray:
    """Keep levels 0..level inclusive, shifted down (MortonIndex.h:123-129)."""
    shift = (_U(MAX_LEVELS) - np.asarray(level, dtype=np.uint64) - _U(1)) * _U(3)
    return np.asarray(keys, dtype=np.uint64) >> shift


def octant_at_level(keys: np.ndarray, level) -> np.ndarray:
    shift = (_U(MAX_LEVELS) - np.asarray(level, dtype=np.uint64) - _U(1)) * _U(3)
    return (np.asarray(keys, dtype=np.uint64) >> shift) & _U(0b111)


def set_octant_at_level(key, level: int, octant: int):
    shift = _U((MAX_LEVELS - level - 1) * 3)
    return np.uint64(key) | (_U(octant & 0b111) << shift)


# ---------------------------------------------------------------------------
# Node indices: a (key-prefix, depth) pair identifying an octree node.
# The depth-d node key uses the low 3*d bits (same layout a truncate_to_level
# of a point key produces). Equivalent role to OctreeNodeIndex64.
# ---------------------------------------------------------------------------


def node_name_potree(node_key: int, levels: int) -> str:
    """Potree-style name: 'r' + octant digits (MortonIndex.h:43-45)."""
    digits = []
    for level in range(levels):
        shift = 3 * (levels - level - 1)
        digits.append(str((int(node_key) >> shift) & 0b111))
    return "r" + "".join(digits)


def node_name_simple(node_key: int, levels: int) -> str:
    return node_name_potree(node_key, levels)[1:]


def node_name_entwine(node_key: int, levels: int) -> str:
    """Entwine-style name 'depth-x-y-z' (MortonIndex.h:46-51)."""
    x, y, z = grid_coords(np.uint64(node_key), levels)
    return f"{levels}-{int(x)}-{int(y)}-{int(z)}"


def parse_node_name(name: str) -> tuple:
    """Parse any of the three conventions; returns (node_key, levels)."""
    if "-" in name:
        parts = name.split("-")
        if len(parts) != 4:
            raise ValueError(f"Invalid Entwine node name: {name}")
        d, x, y, z = (int(p) for p in parts)
        return int(from_grid_coords(x, y, z)), d
    if name.startswith("r"):
        name = name[1:]
    key = 0
    for ch in name:
        o = ord(ch) - ord("0")
        if not 0 <= o <= 7:
            raise ValueError(f"Invalid octant digit in node name: {ch!r}")
        key = (key << 3) | o
    return key, len(name)


def potree_name_to_entwine_name(name: str) -> str:
    key, levels = parse_node_name(name)
    return node_name_entwine(key, levels)


def entwine_name_to_potree_name(name: str) -> str:
    key, levels = parse_node_name(name)
    return node_name_potree(key, levels)


def node_parent(node_key: int, levels: int) -> tuple:
    if levels == 0:
        raise ValueError("Root node has no parent")
    return node_key >> 3, levels - 1


def node_child(node_key: int, levels: int, octant: int) -> tuple:
    return (node_key << 3) | (octant & 0b111), levels + 1
