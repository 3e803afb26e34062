"""Sampling strategies over Morton-sorted point ranges (numpy host versions).

All five CLI strategies of the reference, re-expressed as vectorized
segmented operations over the sorted key array instead of per-point scalar
loops (reference: schwarzwald/core/tiling/Sampling.h):

  RANDOM_GRID      RandomSortedGridSampling   (Sampling.h:187-308)
  GRID_CENTER      GridCenterSampling         (Sampling.h:314-416)
  MIN_DISTANCE     PoissonDiskSampling        (Sampling.h:421-471)
  MIN_DISTANCE_FAST AdaptivePoissonDiskSampling (Sampling.h:477-542)
  JITTERED         JitteredSampling           (Sampling.h:598-759)

Semantics contract (sample_points, Sampling.h:793-821): given a range sorted
by Morton key, return a stable partition where [0, count) are the selected
points and [count, n) the remainder, both preserving relative input order
(stable_partition_with_jumps, util/algorithms/Algorithm.h:24-78).

We return a permutation `order` (or None for the identity) plus the selected
count; callers apply it to keys/positions/attribute indices.

MIN_DISTANCE is inherently sequential (greedy acceptance over a hash grid);
the pure-python implementation here is the semantic oracle, with a C++
native kernel (schwarzwald_tpu/native) used when available.
"""
from __future__ import annotations

import dataclasses
import enum
import math

import numpy as np

from ..core import morton
from . import indexing
from .permutations import (NUM_PERMUTATIONS, PERMUTATIONS_16, PERMUTATIONS_32,
                           PERMUTATIONS_64)

_U = np.uint64

# the samplers whose device path is the octree sweep (ops/device_tiling.py);
# the Poisson samplers' device path is their kernel (ops/poisson_cuda.py)
GRID_SAMPLERS = ("RANDOM_GRID", "GRID_CENTER", "JITTERED")


class SamplingBehaviour(enum.Enum):
    """Sampling.h:170-181."""

    TakeAllWhenCountBelowMaxPoints = 0
    AlwaysAdhereToMinSpacing = 1


class SampleResult:
    """Stable partition of a Morton-sorted range: selected points (in
    original order) first, the rest (in original order) after.

    `order` — the full permutation — is materialized lazily from
    (selected indices, mask): the finalize reconstruction pass persists
    only the selected prefix, so the rest-half of the permutation (a
    flatnonzero + concatenate over the whole node) is never built there.
    order=None with no lazy parts means the identity arrangement
    (take-all / first-point cases)."""

    __slots__ = ("_order", "selected_count", "_selected", "_mask")

    def __init__(self, order: np.ndarray | None, selected_count: int,
                 selected: np.ndarray | None = None,
                 mask: np.ndarray | None = None):
        self._order = order
        self.selected_count = int(selected_count)
        self._selected = selected
        self._mask = mask

    @property
    def order(self) -> np.ndarray | None:
        if self._order is None and self._selected is not None:
            self._order = np.concatenate(
                [self._selected, np.flatnonzero(~self._mask)])
            self._selected = self._mask = None
        return self._order

    def selected_indices(self) -> np.ndarray | None:
        """Indices of the selected points without forcing the full
        permutation; None = identity prefix (first selected_count rows)."""
        if self._selected is not None:
            return self._selected
        if self._order is not None:
            return self._order[:self.selected_count]
        return None

    def apply(self, arr: np.ndarray) -> np.ndarray:
        return arr if self.order is None else arr[self.order]


def candidate_level_in_octree(root_extent_x: float, spacing_at_node: float) -> int:
    """max(-1, floor(log2f(root_extent_x / spacing_at_node)) - 1).

    The C++ calls std::log2f, i.e. float32 log of a float32 argument; we
    narrow identically so level decisions match bit-for-bit
    (Sampling.h:223-229).
    """
    ratio = np.float32(root_extent_x / spacing_at_node)
    return max(-1, int(math.floor(float(np.log2(ratio)))) - 1)


def spacing_at_node_level(spacing_at_root: float, node_level: int) -> float:
    """spacing_at_root / 2^(node_level+1), double math (Sampling.h:210-211)."""
    return spacing_at_root / math.pow(2, node_level + 1)


def candidate_levels(root_extent_x: float, spacing_at_root: float,
                     max_depth: int):
    """Per-node-level candidate grid level (static, computed on host).
    Index i corresponds to node level i-1 (root = -1)."""
    out = []
    for node_level in range(-1, min(morton.MAX_LEVELS - 1, max_depth) + 1):
        spacing = spacing_at_node_level(spacing_at_root, node_level)
        out.append(candidate_level_in_octree(root_extent_x, spacing))
    return out


def _take_all(behaviour: SamplingBehaviour, n: int, max_points: int) -> bool:
    return (behaviour is SamplingBehaviour.TakeAllWhenCountBelowMaxPoints
            and n <= max_points)


def _identity_first_point(n: int) -> SampleResult:
    """partition_at_root (Sampling.h:290-295): take first point, no reorder."""
    return SampleResult(None, min(1, n))


def _stable_order(selected_idx: np.ndarray, n: int) -> SampleResult:
    """[selected in order] + [rest in order] permutation, rest built
    lazily (SampleResult docstring)."""
    mask = np.zeros(n, dtype=bool)
    mask[selected_idx] = True
    return SampleResult(None, int(selected_idx.size),
                        selected=selected_idx, mask=mask)


def _stable_order_from_mask(selected_mask: np.ndarray) -> SampleResult:
    """_stable_order when the boolean mask already exists (Poisson paths):
    skips rebuilding it from indices."""
    selected = np.flatnonzero(selected_mask)
    return SampleResult(None, int(selected.size),
                        selected=selected, mask=selected_mask)


def _argmin_per_run(values: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """First index of the minimum value within each run (min_element tie rule)."""
    n = values.size
    nruns = starts.size
    run_lengths = np.diff(np.append(starts, n))
    run_of_point = np.repeat(np.arange(nruns), run_lengths)
    run_min = np.minimum.reduceat(values, starts)
    is_min = values == run_min[run_of_point]
    min_positions = np.flatnonzero(is_min)
    if min_positions.size == 0:
        # All-NaN distances (NaN == NaN is False) leave no minima; degrade
        # to an empty selection instead of indexing first[0] below.
        return min_positions
    # min_positions is ascending, so runs_at_min is non-decreasing: the
    # first minimum of each run sits at a value change (np.unique here
    # would re-sort a sorted array)
    runs_at_min = run_of_point[min_positions]
    first = np.empty(runs_at_min.size, dtype=bool)
    first[0] = True
    np.not_equal(runs_at_min[1:], runs_at_min[:-1], out=first[1:])
    return min_positions[first]


# ---------------------------------------------------------------------------
# Grid strategies
# ---------------------------------------------------------------------------


def sample_random_grid(keys: np.ndarray, positions: np.ndarray, node_key: int,
                       node_level: int, root_min, root_max,
                       spacing_at_root: float, behaviour: SamplingBehaviour,
                       max_points_per_node: int) -> SampleResult:
    """RandomSortedGridSampling: first point per candidate-level grid cell."""
    n = keys.size
    if _take_all(behaviour, n, max_points_per_node):
        return SampleResult(None, n)
    root_extent_x = float(np.asarray(root_max)[0] - np.asarray(root_min)[0])
    spacing = spacing_at_node_level(spacing_at_root, node_level)
    cand = candidate_level_in_octree(root_extent_x, spacing)
    if cand == -1:
        return _identity_first_point(n)
    cells = morton.truncate_to_level(keys, cand)
    starts = indexing.run_starts(cells)
    return _stable_order(starts, n)


def sample_grid_center(keys: np.ndarray, positions: np.ndarray, node_key: int,
                       node_level: int, root_min, root_max,
                       spacing_at_root: float, behaviour: SamplingBehaviour,
                       max_points_per_node: int) -> SampleResult:
    """GridCenterSampling: per-cell point closest to the cell center."""
    n = keys.size
    if _take_all(behaviour, n, max_points_per_node):
        return SampleResult(None, n)
    root_extent_x = float(np.asarray(root_max)[0] - np.asarray(root_min)[0])
    spacing = spacing_at_node_level(spacing_at_root, node_level)
    cand = candidate_level_in_octree(root_extent_x, spacing)
    if cand == -1:
        return _identity_first_point(n)
    if n >= 512:
        from .. import native
        lib = native.las_codec()
        if lib is not None:
            mask = lib.grid_center_argmin(keys, positions, cand,
                                          root_min, root_max)
            return _stable_order_from_mask(mask)
    return _grid_center_numpy(keys, positions, cand, node_level,
                              root_min, root_max)


def _grid_center_numpy(keys, positions, cand, node_level, root_min,
                       root_max) -> SampleResult:
    """Vectorized numpy twin of the native grid_center_argmin kernel
    (differential-tested against it; also the small-n path)."""
    n = keys.size
    cells = morton.truncate_to_level(keys, cand)
    starts = indexing.run_starts(cells)
    # Cell bounds: descend cand+1 levels from root along the first point's
    # octants (Sampling.h:387-390); centers via getCenter = min + extent/2.
    # Within a node all cells share the node's own octant path, so those
    # levels descend once (scalar) — same FP sequence, fewer array passes.
    # Verified, not assumed: with sorted cells, first==last on the top
    # digits implies all share them (callers may pass arbitrary ranges).
    shared = min(max(0, node_level + 1), cand + 1)
    if shared and starts.size > 1:
        shift = _U(3 * (cand + 1 - shared))
        if (cells[starts[0]] >> shift) != (cells[starts[-1]] >> shift):
            shared = 0
    mins, maxs = indexing.bounds_from_prefixes(
        cells[starts], cand + 1, root_min, root_max, shared_levels=shared)
    centers = mins + (maxs - mins) / 2
    run_lengths = np.diff(np.append(starts, n))
    run_of_point = np.repeat(np.arange(starts.size), run_lengths)
    diff = positions - centers[run_of_point]
    dist_sq = np.einsum("ij,ij->i", diff, diff)
    selected = _argmin_per_run(dist_sq, starts)
    return _stable_order(selected, n)


def sample_jittered(keys: np.ndarray, positions: np.ndarray, node_key: int,
                    node_level: int, root_min, root_max,
                    spacing_at_root: float, behaviour: SamplingBehaviour,
                    max_points_per_node: int) -> SampleResult:
    """JitteredSampling: per-cell pseudo-random target from permutation tables."""
    n = keys.size
    if _take_all(behaviour, n, max_points_per_node):
        return SampleResult(None, n)

    node_prefix = morton.truncate_to_level(
        np.uint64(node_key), node_level) if node_level >= 0 else np.uint64(0)
    node_min, node_max = indexing.bounds_from_prefixes(
        np.array([node_prefix], dtype=np.uint64), node_level + 1,
        root_min, root_max)
    node_min = node_min[0]
    node_extent_x = float(node_max[0][0] - node_min[0])

    spacing = spacing_at_node_level(spacing_at_root, node_level)
    perfect_cell_count = node_extent_x / spacing
    actual_cell_count = _prev_power_of_two(int(perfect_cell_count))
    if actual_cell_count < 16:
        raise RuntimeError(
            "Grids smaller than 16x16 are not supported currently!")
    levels = int(math.log2(actual_cell_count))
    grid_level = node_level + levels
    if grid_level >= morton.MAX_LEVELS:
        raise RuntimeError(
            f"Node at level {node_level} is too small to be sampled with "
            f"JitteredSampling (grid level {grid_level})")

    grid_mask = _U((1 << (3 * levels)) - 1)
    grid_cell_size = node_extent_x / actual_cell_count
    permutation_cell_size = grid_cell_size / actual_cell_count

    start_index = (3 * (node_level + 1)) % NUM_PERMUTATIONS
    if actual_cell_count <= 16:
        table = PERMUTATIONS_16
    elif actual_cell_count <= 32:
        table = PERMUTATIONS_32
    else:
        table = PERMUTATIONS_64
    p0 = table[start_index]
    p1 = table[(start_index + 1) % NUM_PERMUTATIONS]
    p2 = table[(start_index + 2) % NUM_PERMUTATIONS]
    plen = min(actual_cell_count, 64)

    if n >= 512:
        from .. import native
        lib = native.las_codec()
        if lib is not None:
            mask = lib.jittered_argmin(
                keys, positions, grid_level, levels, node_min,
                grid_cell_size, permutation_cell_size, p0, p1, p2, plen)
            return _stable_order_from_mask(mask)
    return _jittered_numpy(keys, positions, grid_level, levels, grid_mask,
                           node_min, grid_cell_size, permutation_cell_size,
                           p0, p1, p2, plen)


def _jittered_numpy(keys, positions, grid_level, levels, grid_mask, node_min,
                    grid_cell_size, permutation_cell_size, p0, p1, p2,
                    plen) -> SampleResult:
    """Vectorized numpy twin of the native jittered_argmin kernel
    (differential-tested against it; also the small-n path)."""
    n = keys.size
    cells = morton.truncate_to_level(keys, grid_level)
    starts = indexing.run_starts(cells)
    rel = cells[starts] & grid_mask
    gx, gy, gz = morton.grid_coords(rel, levels)
    gx = gx.astype(np.int64)
    gy = gy.astype(np.int64)
    gz = gz.astype(np.int64)

    px = p0[(gy + gz) % plen].astype(np.float64) - 1.0
    py = p1[(gx + gz) % plen].astype(np.float64) - 1.0
    pz = p2[(gx + gy) % plen].astype(np.float64) - 1.0

    # per-run target coordinates (runs << points); distances accumulate
    # per axis into one scratch vector — the (n,3) diff temporary plus
    # einsum doubled the memory traffic of this hot path, which is what
    # the finalize reconstruction of big ancestors is bound by
    tx = node_min[0] + gx * grid_cell_size + px * permutation_cell_size
    ty = node_min[1] + gy * grid_cell_size + py * permutation_cell_size
    tz = node_min[2] + gz * grid_cell_size + pz * permutation_cell_size

    run_lengths = np.diff(np.append(starts, n))
    run_of_point = np.repeat(np.arange(starts.size), run_lengths)
    d = positions[:, 0] - tx[run_of_point]
    np.multiply(d, d, out=d)
    t = positions[:, 1] - ty[run_of_point]
    d += np.multiply(t, t, out=t)
    t = positions[:, 2] - tz[run_of_point]
    d += np.multiply(t, t, out=t)
    selected = _argmin_per_run(d, starts)
    return _stable_order(selected, n)


def _prev_power_of_two(v: int) -> int:
    """get_prev_power_of_two (core/util/stuff.h:315-318)."""
    if v <= 0:
        return 0
    return 1 << (v.bit_length() - 1)


# ---------------------------------------------------------------------------
# Poisson-disk (MIN_DISTANCE / MIN_DISTANCE_FAST)
# ---------------------------------------------------------------------------


def _poisson_accept_mask(positions: np.ndarray, node_min, node_max,
                         spacing: float,
                         analyze_mask: np.ndarray | None = None) -> np.ndarray:
    """Greedy sequential Poisson-disk acceptance over a sparse hash grid.

    Exact semantics of SparseGrid::add over the sorted order
    (datastructures/SparseGrid.cpp:117-146, GridCell.cpp:41-58): cell size =
    5*spacing per axis, clamped integer cell coords, acceptance iff no
    previously accepted point within `spacing` in the 27-cell neighborhood.
    Pure-python oracle; the native C++ kernel implements the same contract.
    """
    node_min = np.asarray(node_min, np.float64)
    extent = np.asarray(node_max, np.float64) - node_min
    # The SparseGrid receives spacing narrowed to float32
    # (Sampling.h:448-449); cell size uses it times cellSizeFactor=5.0
    # (SparseGrid.cpp:9-19) and squaredSpacing is the float32 square.
    spacing_f = float(np.float32(spacing))
    cell = spacing_f * 5.0
    dims = np.array([int(extent[0] / cell), int(extent[1] / cell),
                     int(extent[2] / cell)], dtype=np.int64)
    sq_spacing = float(np.float32(spacing) * np.float32(spacing))

    n = positions.shape[0]
    # Integer cell coords for all points, vectorized (truncation toward zero
    # matches the C++ (int) casts for the in-bounds coordinates; clamped after).
    rel = positions - node_min
    coords = np.empty((n, 3), dtype=np.int64)
    for axis in range(3):
        if extent[axis] != 0:
            raw = (dims[axis] * rel[:, axis]) / extent[axis]
        else:
            raw = np.zeros(n)
        coords[:, axis] = np.clip(raw.astype(np.int64),
                                  0, max(dims[axis] - 1, 0))

    cells: dict = {}
    accepted = np.zeros(n, dtype=bool)
    lo = np.maximum(coords - 1, 0)
    hi = np.minimum(coords + 1, np.maximum(dims - 1, 0))
    for idx in range(n):
        if analyze_mask is not None and not analyze_mask[idx]:
            continue
        p = positions[idx]
        ok = True
        for i in range(lo[idx, 0], hi[idx, 0] + 1):
            for j in range(lo[idx, 1], hi[idx, 1] + 1):
                for k in range(lo[idx, 2], hi[idx, 2] + 1):
                    pts = cells.get((i, j, k))
                    if pts is None:
                        continue
                    for q in pts:
                        d = p - q
                        if d[0] * d[0] + d[1] * d[1] + d[2] * d[2] < sq_spacing:
                            ok = False
                            break
                    if not ok:
                        break
                if not ok:
                    break
            if not ok:
                break
        if ok:
            key = (coords[idx, 0], coords[idx, 1], coords[idx, 2])
            cells.setdefault(key, []).append(p)
            accepted[idx] = True
    return accepted


def _poisson_backend(positions, node_min, node_max, spacing, analyze_mask):
    from .. import native
    kernel = native.poisson_sample_kernel()
    if kernel is not None:
        return kernel(positions, node_min, node_max, spacing, analyze_mask)
    return _poisson_accept_mask(positions, node_min, node_max, spacing,
                                analyze_mask)


def _poisson_device_attempt(keys, positions, root_min, root_max, spacing,
                            analyze_mask, device_backend):
    """Run the device Poisson kernel (ops/device_poisson); None sends the
    range to the host kernel by a deterministic rule (ranges under the
    device floor, the kernel's pair-list gate). A kernel fault raises."""
    if not device_backend:
        return None
    from . import device_poisson, poisson_cuda
    if keys.size < poisson_cuda.DEVICE_FLOOR:
        poisson_cuda.count("below_floor")
        return None
    root_extent_x = float(np.asarray(root_max)[0] - np.asarray(root_min)[0])
    return device_poisson.poisson_accept_mask_device(
        keys, positions, root_extent_x, spacing, analyze_mask,
        backend=device_backend)


def sample_min_distance(keys: np.ndarray, positions: np.ndarray, node_key: int,
                        node_level: int, root_min, root_max,
                        spacing_at_root: float, behaviour: SamplingBehaviour,
                        max_points_per_node: int,
                        device_backend: str | None = None) -> SampleResult:
    """PoissonDiskSampling (Sampling.h:421-471)."""
    n = keys.size
    if _take_all(behaviour, n, max_points_per_node):
        return SampleResult(None, n)
    node_prefix = morton.truncate_to_level(
        np.uint64(node_key), node_level) if node_level >= 0 else np.uint64(0)
    node_min, node_max = indexing.bounds_from_prefixes(
        np.array([node_prefix], dtype=np.uint64), node_level + 1,
        root_min, root_max)
    spacing = spacing_at_node_level(spacing_at_root, node_level)
    accepted = _poisson_device_attempt(keys, positions, root_min, root_max,
                                       spacing, None, device_backend)
    if accepted is None:
        accepted = _poisson_backend(positions, node_min[0], node_max[0],
                                    spacing, None)
    return _stable_order_from_mask(accepted)


def sample_min_distance_fast(keys: np.ndarray, positions: np.ndarray,
                             node_key: int, node_level: int, root_min,
                             root_max, spacing_at_root: float,
                             behaviour: SamplingBehaviour,
                             max_points_per_node: int,
                             device_backend: str | None = None) -> SampleResult:
    """AdaptivePoissonDiskSampling (Sampling.h:477-542) with the default
    density function of TilerProcess::make_sampling_strategy
    (core/process/TilerProcess.cpp:500-508)."""
    n = keys.size
    if _take_all(behaviour, n, max_points_per_node):
        return SampleResult(None, n)
    root_extent_x = float(np.asarray(root_max)[0] - np.asarray(root_min)[0])
    spacing = spacing_at_node_level(spacing_at_root, node_level)
    cand = candidate_level_in_octree(root_extent_x, spacing)
    if cand == -1:
        return _identity_first_point(n)
    node_prefix = morton.truncate_to_level(
        np.uint64(node_key), node_level) if node_level >= 0 else np.uint64(0)
    node_min, node_max = indexing.bounds_from_prefixes(
        np.array([node_prefix], dtype=np.uint64), node_level + 1,
        root_min, root_max)
    density = _default_density_per_level(node_level)
    nth = int(round(1.0 / density))
    # counter starts at nth-1 so the first point is always analyzed
    # (Sampling.h:522-536); analyzed points are those at positions
    # 0, nth, 2*nth, ... of the range.
    analyze = np.zeros(n, dtype=bool)
    analyze[::max(nth, 1)] = True
    accepted = _poisson_device_attempt(keys, positions, root_min, root_max,
                                       spacing, analyze, device_backend)
    if accepted is None:
        accepted = _poisson_backend(positions, node_min[0], node_max[0],
                                    spacing, analyze)
    return _stable_order_from_mask(accepted)


def _default_density_per_level(node_level: int) -> float:
    if node_level < 0:
        return 0.25
    if node_level < 1:
        return 0.5
    return 1.0


# ---------------------------------------------------------------------------
# Strategy dispatch + required depth
# ---------------------------------------------------------------------------

STRATEGIES = {
    "RANDOM_GRID": sample_random_grid,
    "GRID_CENTER": sample_grid_center,
    "MIN_DISTANCE": sample_min_distance,
    "MIN_DISTANCE_FAST": sample_min_distance_fast,
    "JITTERED": sample_jittered,
}


@dataclasses.dataclass
class SamplingStrategy:
    """Named strategy + parameters (the std::variant equivalent)."""

    name: str
    max_points_per_node: int = 20_000
    # When set ("cuda"/"cpu"), MIN_DISTANCE* ranges large enough run the
    # device Poisson kernel (ops/device_poisson); host otherwise.
    device_backend: str | None = None

    def __post_init__(self):
        if self.name not in STRATEGIES:
            raise ValueError(f'Unrecognized sampling strategy name "{self.name}"')

    def needs_positions(self, n: int, behaviour: SamplingBehaviour) -> bool:
        """Whether sample() will read `positions` for this range: take-all
        short-circuits before touching them, and RANDOM_GRID selects purely
        on keys — callers can skip the (expensive) position gather."""
        if _take_all(behaviour, n, self.max_points_per_node):
            return False
        return self.name != "RANDOM_GRID"

    def sample(self, keys, positions, node_key, node_level, root_min, root_max,
               spacing_at_root, behaviour) -> SampleResult:
        fn = STRATEGIES[self.name]
        kwargs = {}
        if self.device_backend and self.name in ("MIN_DISTANCE",
                                                 "MIN_DISTANCE_FAST"):
            kwargs["device_backend"] = self.device_backend
        return fn(keys, positions, node_key, node_level, root_min, root_max,
                  spacing_at_root, behaviour, self.max_points_per_node,
                  **kwargs)


def required_morton_index_depth(strategy: SamplingStrategy, node_level: int,
                                root_extent_x: float,
                                spacing_at_root: float) -> int:
    """Sampling.cpp:29-62: index depth a strategy needs for a node level."""
    if strategy.name in ("RANDOM_GRID", "GRID_CENTER"):
        spacing = spacing_at_node_level(spacing_at_root, node_level)
        return candidate_level_in_octree(root_extent_x, spacing)
    if strategy.name in ("MIN_DISTANCE", "MIN_DISTANCE_FAST"):
        return node_level
    # JITTERED (Sampling.cpp:48-59): node extent approximated as
    # root_extent_x / 2^(level+1), unlike sample_points which descends the
    # actual bounds — kept as-is for parity.
    spacing = spacing_at_node_level(spacing_at_root, node_level)
    node_extent_x = root_extent_x / math.pow(2, node_level + 1)
    perfect_cell_count = node_extent_x / spacing
    actual = _prev_power_of_two(int(perfect_cell_count))
    levels = int(math.log2(actual)) if actual > 0 else 0
    return node_level + levels
