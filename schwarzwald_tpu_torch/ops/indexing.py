"""Point indexing: outlier clamping, Morton encoding, octant partitioning.

Parity targets:
  - index_point / index_points with OutlierPointsBehaviour::ClampToBounds
    (schwarzwald/core/tiling/OctreeAlgorithms.h:145-197)
  - partition_points_into_child_octants (OctreeAlgorithms.h:240-265) —
    realized here as a vectorized boundary search over the sorted keys
    instead of the reference's 8 linear find_if scans.
  - get_bounds_from_morton_index (OctreeAlgorithms.h:104-116) — vectorized
    octant-descent over many node prefixes at once, preserving the exact
    FP evaluation order (child_min = parent_min + extent/2 per level).
"""
from __future__ import annotations

import numpy as np

from ..core import morton

_U = np.uint64


def clamp_to_bounds(positions: np.ndarray, bounds_min, bounds_max) -> np.ndarray:
    """OutlierPointsBehaviour::ClampToBounds (OctreeAlgorithms.h:157-170).

    The reference mutates the point position in place; callers here must use
    the returned (possibly copied) array for all later processing AND
    persistence, matching that behavior.
    """
    lo = np.asarray(bounds_min, dtype=np.float64)
    hi = np.asarray(bounds_max, dtype=np.float64)
    inside = np.all((positions >= lo) & (positions <= hi), axis=-1)
    if inside.all():
        return positions
    return np.clip(positions, lo, hi)


def index_points(positions: np.ndarray, bounds_min, bounds_max):
    """Clamp outliers and compute Morton-64 keys.

    Returns (keys, positions) where positions are the (clamped) coordinates
    to use downstream. Mirrors index_point (OctreeAlgorithms.h:145-175).
    Large batches go through the fused OpenMP native kernel.
    """
    positions = np.ascontiguousarray(positions, dtype=np.float64)
    # the fused kernel wins at EVERY size (~15 us vs ~60 us per call even
    # at n=16 — per-node cached re-reads make tens of thousands of calls
    # per out-of-core run); the numpy chain below is the fallback twin
    if positions.shape[0] > 0:
        from .. import native
        lib = native.las_codec()
        if lib is not None:
            if not positions.flags.writeable:
                positions = positions.copy()
            keys = lib.index_points_fused(positions, bounds_min, bounds_max)
            return keys, positions
    positions = clamp_to_bounds(positions, bounds_min, bounds_max)
    extent = np.asarray(bounds_max, np.float64) - np.asarray(bounds_min, np.float64)
    keys = morton.encode(positions, bounds_min, extent)
    return keys, positions


def is_sorted(keys: np.ndarray) -> bool:
    """True when keys are already nondecreasing (one cheap vector pass).

    Node contents are persisted in key order, and the lossy-sink re-read
    (LAS/LAZ quantization) is an identity transform whenever the stored
    values are already aligned to the sink's grid — the common case
    (input LAS/LAZ at the same or coarser scale than the output). The
    re-sort of retrieved contents then has nothing to do; callers use
    this check to skip the radix argsort plus the reorder gather (the
    two dominated the finalize reconstruction profile) while keeping the
    full sort as the fallback for genuinely perturbed keys."""
    if keys.size <= 1:
        return True
    return bool((keys[1:] >= keys[:-1]).all())


def sort_by_key(keys: np.ndarray):
    """Stable argsort by Morton key.

    std::sort in the reference is unstable but compares only on the key
    (Sampling.h:159-164); we pick the deterministic stable order so results
    are reproducible and merge semantics match std::merge stability. Uses
    the native LSD radix argsort (also stable) for large inputs.
    """
    if keys.size >= 1 << 16:
        from .. import native
        lib = native.las_codec()
        if lib is not None:
            return lib.radix_argsort(keys)
    return np.argsort(keys, kind="stable")


def sort_with_keys(keys: np.ndarray) -> tuple:
    """(sorted_keys, order) — like sort_by_key but the sorted keys come
    straight from the native sort's internal state instead of a separate
    keys[order] gather (8 bytes/element saved on the batch hot path)."""
    if keys.size >= 1 << 16:
        from .. import native
        lib = native.las_codec()
        if lib is not None:
            return lib.radix_sort_kv(keys)
    order = np.argsort(keys, kind="stable")
    return keys[order], order


def child_octant_boundaries(sorted_keys: np.ndarray, start: int, end: int,
                            level: int) -> np.ndarray:
    """Boundaries of the 8 child ranges of sorted_keys[start:end].

    `level` is the absolute key level (0 = root octant) to partition at, as in
    partition_points_into_child_octants (OctreeAlgorithms.h:240-265). Returns
    9 offsets b with child o occupying [b[o], b[o+1]).

    Implemented as binary searches for the child boundary KEY values (the
    prefix with octant o+1 and zeros below) — no temporary per-point octant
    array is materialized, so the cost is O(log n) per child regardless of
    range size.
    """
    shift = _U((morton.MAX_LEVELS - level - 1) * 3)
    # All points in the range share the prefix above `level` (precondition
    # of partition_points_into_child_octants); take it from the first key.
    prefix = sorted_keys[start] >> (shift + _U(3))
    boundary_keys = ((prefix << _U(3))
                     + np.arange(1, 8, dtype=np.uint64)) << shift
    out = np.empty(9, dtype=np.int64)
    out[0] = start
    out[1:8] = start + np.searchsorted(sorted_keys[start:end], boundary_keys,
                                       side="left")
    out[8] = end
    return out


def run_starts(cell_ids: np.ndarray) -> np.ndarray:
    """Indices of the first element of each run of equal values (sorted input)."""
    if cell_ids.size == 0:
        return np.empty(0, dtype=np.int64)
    changed = np.empty(cell_ids.size, dtype=bool)
    changed[0] = True
    np.not_equal(cell_ids[1:], cell_ids[:-1], out=changed[1:])
    return np.flatnonzero(changed)


def bounds_from_prefixes(prefixes: np.ndarray, depth: int,
                         root_min: np.ndarray, root_max: np.ndarray,
                         shared_levels: int = 0):
    """Vectorized get_bounds_from_morton_index for many node prefixes.

    `prefixes` are node keys of `depth` levels (low 3*depth bits used, as
    produced by truncate). Descends level by level, accumulating
    min += bit * (extent / 2^(l+1)) in the same order as the reference's
    iterated get_octant_bounds (OctreeAlgorithms.cpp:3-18) so FP results are
    bit-identical. Returns (mins, maxs) of shape (len(prefixes), 3).

    shared_levels: number of leading levels IDENTICAL across all prefixes
    (e.g. the containing node's octant path) — descended once on scalars
    with the exact same FP sequence, then broadcast.
    """
    prefixes = np.asarray(prefixes, dtype=np.uint64)
    n = prefixes.shape[0]
    if n == 1:
        # scalar fast path: the engine asks for ONE node's bounds on every
        # node visit; per-level numpy ops on 3-element arrays cost ~100 us
        # while the identical IEEE sequence in python floats costs ~2 us.
        # (x + 0.0 matches numpy's x + 0.0*half bit-for-bit, including
        # the -0.0 -> +0.0 normalization.)
        l0, l1, l2 = (float(root_min[0]), float(root_min[1]),
                      float(root_min[2]))
        h0, h1, h2 = (float(root_max[0]), float(root_max[1]),
                      float(root_max[2]))
        p = int(prefixes[0])
        for level in range(depth):
            octant = (p >> (3 * (depth - level - 1))) & 7
            e0 = (h0 - l0) * 0.5
            e1 = (h1 - l1) * 0.5
            e2 = (h2 - l2) * 0.5
            l0 = l0 + (e0 if octant & 4 else 0.0)
            l1 = l1 + (e1 if octant & 2 else 0.0)
            l2 = l2 + (e2 if octant & 1 else 0.0)
            h0, h1, h2 = l0 + e0, l1 + e1, l2 + e2
        return (np.array([[l0, l1, l2]]), np.array([[h0, h1, h2]]))
    lo = np.asarray(root_min, np.float64).copy()
    hi = np.asarray(root_max, np.float64).copy()
    for level in range(min(shared_levels, depth) if n else 0):
        half3 = (hi - lo) * 0.5
        octant = int(prefixes[0] >> _U(3 * (depth - level - 1))) & 0b111
        bits3 = np.array([(octant >> 2) & 1, (octant >> 1) & 1, octant & 1],
                         dtype=np.float64)
        lo = lo + bits3 * half3
        hi = lo + half3
    mins = np.broadcast_to(lo, (n, 3)).copy()
    maxs = np.broadcast_to(hi, (n, 3)).copy()
    half = np.empty((n, 3), dtype=np.float64)
    bits = np.empty((n, 3), dtype=np.float64)
    for level in range(min(shared_levels, depth), depth):
        # Recompute extent from (max - min) each level exactly like the
        # iterated get_octant_bounds calls — (min+half)-min is not always
        # equal to half in IEEE754, so no shortcut here. In-place ops keep
        # the identical FP sequence ((x/2 == x*0.5 exactly).
        np.subtract(maxs, mins, out=half)
        half *= 0.5
        shift = _U(3 * (depth - level - 1))
        octant = (prefixes >> shift) & _U(0b111)
        # bit2 = x, bit1 = y, bit0 = z (get_octant_bounds)
        bits[:, 0] = (octant >> _U(2)) & _U(1)
        bits[:, 1] = (octant >> _U(1)) & _U(1)
        bits[:, 2] = octant & _U(1)
        bits *= half
        mins += bits
        np.add(mins, half, out=maxs)
    return mins, maxs
