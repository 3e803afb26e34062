"""Axis-aligned bounding boxes (float64 host math).

Semantics match the reference AABB (schwarzwald/core/math/AABB.h:10-96):
`extent = max - min`, `center = min + extent/2`, `makeCubic` re-centers a cube
of the max extent, and octant bounds are derived by iterative halving
(schwarzwald/core/tiling/OctreeAlgorithms.cpp:3-18) so that floating-point
behavior is bit-identical along any octree path.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AABB:
    min: np.ndarray  # (3,) float64
    max: np.ndarray  # (3,) float64

    def __init__(self, min=None, max=None):
        if min is None:
            min = np.full(3, np.finfo(np.float64).max)
        if max is None:
            max = np.full(3, -np.finfo(np.float64).max)
        self.min = np.asarray(min, dtype=np.float64).copy()
        self.max = np.asarray(max, dtype=np.float64).copy()

    def extent(self) -> np.ndarray:
        return self.max - self.min

    def center(self) -> np.ndarray:
        # min + extent/2, matching AABB::getCenter (AABB.h:70)
        return self.min + self.extent() / 2

    def diagonal_length(self) -> float:
        return float(np.sqrt(np.sum(self.extent() ** 2)))

    def is_inside(self, p: np.ndarray) -> np.ndarray:
        p = np.atleast_2d(np.asarray(p, dtype=np.float64))
        return np.all((p >= self.min) & (p <= self.max), axis=-1)

    def update(self, other: "AABB") -> None:
        self.min = np.minimum(self.min, other.min)
        self.max = np.maximum(self.max, other.max)

    def update_point(self, p: np.ndarray) -> None:
        self.min = np.minimum(self.min, p)
        self.max = np.maximum(self.max, p)

    def cubic(self) -> "AABB":
        # AABB::makeCubic (AABB.h:50-61): cube of max extent about the center.
        max_extent = float(np.max(self.extent()))
        half = max_extent / 2
        c = self.center()
        return AABB(c - half, c + half)

    def translated(self, t: np.ndarray) -> "AABB":
        return AABB(self.min + t, self.max + t)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, AABB)
            and np.array_equal(self.min, other.min)
            and np.array_equal(self.max, other.max)
        )

    def __repr__(self) -> str:
        return f"AABB(min={self.min.tolist()}, max={self.max.tolist()})"


def octant_bounds(octant: int, parent: AABB) -> AABB:
    """Bounds of one octant; bit2 = x, bit1 = y, bit0 = z.

    Matches get_octant_bounds (OctreeAlgorithms.cpp:3-18): child min is
    parent.min (+ extent/2 for the upper half), child max = child min +
    extent/2, evaluated in this exact order for FP parity.
    """
    ext = parent.extent()
    half = ext / 2
    mn = parent.min.copy()
    if octant & 1:
        mn[2] = parent.min[2] + half[2]
    if (octant >> 1) & 1:
        mn[1] = parent.min[1] + half[1]
    if (octant >> 2) & 1:
        mn[0] = parent.min[0] + half[0]
    return AABB(mn, mn + half)


def bounds_from_octants(octants, root: AABB) -> AABB:
    """Bounds of the node reached by descending the given octant digits."""
    b = root
    for o in octants:
        b = octant_bounds(int(o), b)
    return b


def octant_of_position(position: np.ndarray, bounds: AABB) -> int:
    """get_octant (OctreeAlgorithms.cpp:74-85): which octant a point is in."""
    ext = bounds.extent()
    n = (2 * (np.asarray(position, dtype=np.float64) - bounds.min) / ext).astype(
        np.uint8
    )
    i = np.minimum(n, 1)
    return int((i[2]) | (i[1] << 1) | (i[0] << 2))
