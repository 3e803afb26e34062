"""The level-synchronous octree sweep in torch ops (device path of the grid
samplers).

The counterpart of schwarzwald_tpu/ops/device_tiling.py:38-370. For a
Morton-sorted FRESH batch it computes, for every point, the octree level of
the node that keeps it, one level at a time over the whole batch:

  - take-all when a node's point count <= max_points_per_node
    (SamplingBehaviour::TakeAllWhenCountBelowMaxPoints, Sampling.h:170-181);
  - otherwise the first remaining point per candidate-level grid cell
    (RANDOM_GRID, Sampling.h:187-308), the remaining point closest to its
    cell centre (GRID_CENTER, Sampling.h:314-416) or to the permutation
    target of its jitter cell (JITTERED, Sampling.h:695-753);
  - terminal nodes at min(20, max_depth) keep everything
    (tile_terminal_node, TilingAlgorithms.cpp:206-241);
  - the cand == -1 "take the first point" root case (Sampling.h:290-295);
  - levels whose grid exceeds the 21-level Morton capacity (the reference's
    re-rooting case, TilingAlgorithms.cpp:444-483) and JITTERED grids under
    16 cells stop the sweep: the points still remaining stay at level 0 for
    the host engine.

Output levels are int8, node_level + 2 (root -1 -> 1), 0 = unassigned.
Keys are one int64 per point, where the JAX package used (hi, lo) uint32
words. Cells are contiguous runs of the sorted order, so every per-cell
quantity is a prefix scan, a gather, or one scatter-min.

The float64 geometry (cell centres, node bounds, jitter targets, squared
distances) keeps the JAX package's order of operations with each multiply
and add its own eager op, so no fused multiply-add changes a rounding: on a
card with true float64 the distances equal the host engine's bit for bit.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from . import sampling

MAX_LEVELS = 21


def candidate_levels(root_extent_x: float, spacing_at_root: float,
                     max_depth: int):
    """Per-node-level candidate grid level (static, computed on host).
    Index i corresponds to node level i-1 (root = -1)."""
    out = []
    for node_level in range(-1, min(MAX_LEVELS - 1, max_depth) + 1):
        spacing = sampling.spacing_at_node_level(spacing_at_root, node_level)
        out.append(sampling.candidate_level_in_octree(root_extent_x, spacing))
    return out


def jittered_static_config(root_extent_x: float, spacing_at_root: float,
                           node_level: int):
    """Static per-level JITTERED grid config, or None when unsupported
    (grid < 16 cells raises in the reference; grid level >= 21 re-roots).
    Mirrors JitteredSampling's setup (Sampling.h:620-693) with the node
    extent computed as root_extent / 2^(level+1) (as
    required_morton_index_depth does, Sampling.cpp:48-59)."""
    spacing = sampling.spacing_at_node_level(spacing_at_root, node_level)
    node_extent_x = root_extent_x / math.pow(2, node_level + 1)
    actual = sampling._prev_power_of_two(int(node_extent_x / spacing))
    if actual < 16:
        return None
    levels = int(math.log2(actual))
    grid_level = node_level + levels
    if grid_level >= MAX_LEVELS:
        return None
    from .permutations import (NUM_PERMUTATIONS, PERMUTATIONS_16,
                               PERMUTATIONS_32, PERMUTATIONS_64)

    start = (3 * (node_level + 1)) % NUM_PERMUTATIONS
    table = (PERMUTATIONS_16 if actual <= 16
             else PERMUTATIONS_32 if actual <= 32 else PERMUTATIONS_64)
    perms = (tuple(int(v) for v in table[start]),
             tuple(int(v) for v in table[(start + 1) % NUM_PERMUTATIONS]),
             tuple(int(v) for v in table[(start + 2) % NUM_PERMUTATIONS]))
    return {"levels": levels, "grid_level": grid_level,
            "actual": actual, "plen": min(actual, 64), "perms": perms}


def jittered_static_configs(root_extent_x: float, spacing_at_root: float,
                            max_depth: int) -> tuple:
    """Per-level JITTERED configs for octree_select_grid (index
    node_level + 1), as tuples (levels, grid_level, actual, plen, perms)."""
    out = []
    for node_level in range(-1, min(MAX_LEVELS - 1, max_depth) + 1):
        cfg = jittered_static_config(root_extent_x, spacing_at_root,
                                     node_level)
        out.append(None if cfg is None else
                   (cfg["levels"], cfg["grid_level"], cfg["actual"],
                    cfg["plen"], cfg["perms"]))
    return tuple(out)


def _first_in_cell(key: torch.Tensor, groups: int) -> torch.Tensor:
    """Mask: point starts a new cell whose id is the top `groups` octant
    digits (a node AT level l has l+1 digits). groups <= 0 -> root."""
    first = torch.zeros(key.shape[0], dtype=torch.bool, device=key.device)
    first[:1] = True
    if groups <= 0:
        return first
    cell = key >> (3 * MAX_LEVELS - 3 * groups)
    first[1:] = cell[1:] != cell[:-1]
    return first


def _segment_fields(first: torch.Tensor, remaining: torch.Tensor,
                    iota: torch.Tensor):
    """Per-point helpers for the cell segmentation defined by `first`:
    (cell_start_index, remaining_before_in_cell, remaining_in_cell). Cells
    are contiguous runs, so per-cell totals are prefix sums gathered at the
    cell's first and last element."""
    n = first.shape[0]
    cell_start = torch.cummax(torch.where(first, iota, 0), 0).values
    rem = remaining.to(torch.int64)
    csum_r = torch.cumsum(rem, 0)
    r_before_cell = csum_r[cell_start] - rem[cell_start]
    before_in_cell = csum_r - rem - r_before_cell
    # index of my cell's LAST element: the nearest following cell end, a
    # reverse cummin (flip, cummin, flip)
    last = torch.ones_like(first)
    last[:-1] = first[1:]
    ends = torch.where(last, iota, n - 1)
    cell_end = torch.cummin(ends.flip(0), 0).values.flip(0)
    in_cell = csum_r[cell_end] - r_before_cell
    return cell_start, before_in_cell, in_cell


def _segment_min(first: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Per-point min over the point's contiguous segment: segment ids from
    a prefix sum of `first`, one scatter-min per segment, a gather back.
    Min does not depend on order, so the atomics of a CUDA scatter give a
    deterministic result."""
    seg = torch.cumsum(first.to(torch.int64), 0) - 1
    mins = torch.full_like(values, math.inf).scatter_reduce(
        0, seg, values, "amin", include_self=False)
    return mins[seg]


def _key_axis_bit(key: torch.Tensor, descent_level: int,
                  axis: int) -> torch.Tensor:
    """Bit of the given axis (0=x, 1=y, 2=z) at octant-descent level t:
    key bit 3*(20-t) + (2-axis)."""
    return (key >> (3 * (MAX_LEVELS - 1 - descent_level) + 2 - axis)) & 1


def _node_min_max(key: torch.Tensor, depth: int, root_min, root_max):
    """Per-point min/max of its depth-`depth` node, by the same iterative
    octant halving as the host (indexing.bounds_from_prefixes): each mins
    update is a multiply, then an add."""
    n = key.shape[0]
    mins = [torch.full((n,), float(root_min[a]), dtype=torch.float64,
                       device=key.device) for a in range(3)]
    maxs = [torch.full((n,), float(root_max[a]), dtype=torch.float64,
                       device=key.device) for a in range(3)]
    for t in range(depth):
        for a in range(3):
            half = (maxs[a] - mins[a]) / 2
            bit = _key_axis_bit(key, t, a).to(torch.float64)
            mins[a] = mins[a] + bit * half
            maxs[a] = mins[a] + half
    return mins, maxs


def _cell_centers(key: torch.Tensor, depth: int, root_min, root_max):
    """Per-point centre of its depth-`depth` cell."""
    mins, maxs = _node_min_max(key, depth, root_min, root_max)
    return [mins[a] + (maxs[a] - mins[a]) / 2 for a in range(3)]


def _grid_coords_of_cell(key: torch.Tensor, node_level: int, levels: int):
    """Per-point (gx, gy, gz) of its jitter-grid cell relative to its node:
    the `levels` octant digits below the node, de-interleaved
    (OctreeNodeIndex::to_grid_index semantics)."""
    g = [torch.zeros(key.shape[0], dtype=torch.int64, device=key.device)
         for _ in range(3)]
    for j in range(levels):
        t = node_level + 1 + j  # absolute descent level of this digit
        shift = levels - 1 - j
        for a in range(3):
            g[a] = g[a] | (_key_axis_bit(key, t, a) << shift)
    return g


def _sq_dist(positions: torch.Tensor, tx, ty, tz) -> torch.Tensor:
    """((px-tx)^2 + (py-ty)^2) + (pz-tz)^2, summed left to right."""
    dx = positions[:, 0] - tx
    dy = positions[:, 1] - ty
    dz = positions[:, 2] - tz
    return (dx * dx + dy * dy) + dz * dz


def _pick_closest(key, dist, remaining, iota, cell_groups: int):
    """The remaining point of least distance in each cell of `cell_groups`
    digits, the first one on ties."""
    cell_first = _first_in_cell(key, cell_groups)
    masked = torch.where(remaining, dist, math.inf)
    is_min = remaining & (masked == _segment_min(cell_first, masked))
    _, before_eq, _ = _segment_fields(cell_first, is_min, iota)
    return is_min & (before_eq == 0)


def _pick_grid_center(key, positions, cand: int, remaining, iota,
                      root_min, root_max):
    """GRID_CENTER selection: remaining point closest to its cand-cell
    centre, first on ties (GridCenterSampling, Sampling.h:314-416)."""
    cx, cy, cz = _cell_centers(key, cand + 1, root_min, root_max)
    return _pick_closest(key, _sq_dist(positions, cx, cy, cz), remaining,
                         iota, cand + 1)


def _pick_jittered(key, positions, node_level: int, cfg, remaining, iota,
                   root_min, root_max):
    """JITTERED selection (Sampling.h:695-753): per jitter-grid cell, the
    remaining point closest to the permutation-table target point."""
    levels, grid_level, actual, plen, perms = cfg
    nmins, nmaxs = _node_min_max(key, node_level + 1, root_min, root_max)
    grid_cell_size = (nmaxs[0] - nmins[0]) / actual
    permutation_cell_size = grid_cell_size / actual
    gx, gy, gz = _grid_coords_of_cell(key, node_level, levels)
    table = [torch.tensor(p, dtype=torch.int64, device=key.device)
             for p in perms]
    p = [(table[0][(gy + gz) % plen] - 1).to(torch.float64),
         (table[1][(gx + gz) % plen] - 1).to(torch.float64),
         (table[2][(gx + gy) % plen] - 1).to(torch.float64)]
    # nmins + (g * grid_cell_size + p * permutation_cell_size)
    t = [nmins[a] + (g.to(torch.float64) * grid_cell_size
                     + p[a] * permutation_cell_size)
         for a, g in enumerate((gx, gy, gz))]
    return _pick_closest(key, _sq_dist(positions, *t), remaining, iota,
                         grid_level + 1)


def octree_select_grid(key: torch.Tensor, cands, max_points: int,
                       max_depth: int, strategy: str = "RANDOM_GRID",
                       positions: torch.Tensor | None = None, root_min=None,
                       root_max=None, jit_cfgs=None,
                       min_node_level: int = -1) -> torch.Tensor:
    """Per-point octree assignment level of a Morton-sorted FRESH batch
    under RANDOM_GRID, GRID_CENTER or JITTERED sampling, on the keys'
    device.

    key: (n,) int64 sorted keys. GRID_CENTER and JITTERED need the (n, 3)
    float64 positions in key order and the root bounds (root_min, root_max:
    three floats each); JITTERED also the configs of
    jittered_static_configs. min_node_level: selection starts at this node
    level (FAST's start-node level - 1; -1 starts at the root).

    Returns (n,) int8 levels: 0 = unassigned (host path), otherwise
    node_level + 2."""
    n = key.shape[0]
    device = key.device
    iota = torch.arange(n, dtype=torch.int64, device=device)
    remaining = torch.ones(n, dtype=torch.bool, device=device)
    out = torch.zeros(n, dtype=torch.int8, device=device)
    max_level = min(MAX_LEVELS - 1, max_depth)

    for node_level in range(min_node_level, max_level + 1):
        # Early exit once every point is assigned (the JAX program's
        # lax.cond short-circuit). It reads one flag back from the device,
        # so each level synchronises the host with the card once.
        if not bool(remaining.any()):
            break
        if strategy == "JITTERED":
            cfg = jit_cfgs[node_level + 1]
            cand = None
            is_terminal = node_level >= max_level
            if not is_terminal and cfg is None:
                break  # <16 grid (reference raises) or >=21 grid level
        else:
            cfg = None
            cand = cands[node_level + 1]
            requires_deeper = cand > node_level
            is_terminal = (node_level >= max_level if requires_deeper
                           else cand >= max_level)
            if not is_terminal and cand >= MAX_LEVELS:
                break  # re-rooting territory: the host engine finishes
        participating = remaining
        if is_terminal:
            out.masked_fill_(participating, node_level + 2)
            break

        node_first = _first_in_cell(key, node_level + 1)
        _, before_node, in_node = _segment_fields(node_first, participating,
                                                  iota)
        take_all = in_node <= max_points
        if strategy == "JITTERED":
            pick = _pick_jittered(key, positions, node_level, cfg,
                                  participating, iota, root_min, root_max)
        elif cand == -1:
            pick = participating & (before_node == 0)
        elif strategy == "GRID_CENTER":
            pick = _pick_grid_center(key, positions, cand, participating,
                                     iota, root_min, root_max)
        else:
            pick_first = _first_in_cell(key, cand + 1)
            _, before_cand, _ = _segment_fields(pick_first, participating,
                                                iota)
            pick = participating & (before_cand == 0)
        selected = torch.where(take_all, participating, pick)
        out.masked_fill_(selected, node_level + 2)
        remaining = remaining & ~selected
    return out


def octree_select_random_grid(key: torch.Tensor, cands, max_points: int,
                              max_depth: int) -> torch.Tensor:
    return octree_select_grid(key, cands, max_points, max_depth,
                              strategy="RANDOM_GRID")


def keys_tensor(sorted_keys: np.ndarray, device) -> torch.Tensor:
    """Host uint64 keys (< 2^63) as an int64 tensor on `device`."""
    return torch.from_numpy(
        np.ascontiguousarray(sorted_keys).view(np.int64)).to(device)
