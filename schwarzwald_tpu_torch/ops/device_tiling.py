"""The level-synchronous octree sweep X2 (device path of the grid
samplers): the binding of its CUDA kernel (csrc/sweep.cu) and its plain
version in torch ops.

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
words. Which levels run, and what each picks, depends only on the
candidate levels, the JITTERED configs, max_depth and min_node_level:
`level_plan` decides it on the host for both routes.

`octree_select_grid` dispatches on the keys' device: a CUDA tensor
launches the kernel (`octree_select_grid_cuda`: one cooperative launch on
the current stream for the whole plan, nothing read back, counted in
`x2_launches` where it goes out), a CPU tensor runs the plain version
(`octree_select_grid_torch`). In the plain version cells are contiguous
runs of the sorted order, so every per-cell quantity is a prefix scan, a
gather, or one scatter-min.

The float64 geometry (cell centres, node bounds, jitter targets, squared
distances) keeps the JAX package's order of operations with each multiply
and add its own eager op, so no fused multiply-add changes a rounding: on a
card with true float64 the distances equal the host engine's bit for bit.
"""
from __future__ import annotations

import ctypes
import math
import threading

import numpy as np
import torch

from . import sampling
# the host engine reads the candidate levels without importing torch
from .sampling import candidate_levels  # noqa: F401

MAX_LEVELS = 21


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


# the pick of a level: the first remaining point of its pick cell, the one
# nearest the cell's centre, the one nearest the jitter target
PICK_FIRST, PICK_CENTER, PICK_JITTER = 0, 1, 2


def level_plan(strategy: str, cands, max_depth: int, jit_cfgs=None,
               min_node_level: int = -1) -> list:
    """The sweep's levels, decided on the host before any launch: they
    depend only on the candidate levels, the JITTERED configs, max_depth
    and min_node_level. One dict per level, in order: node_level,
    terminal (every remaining point takes the level, and the plan ends),
    node_groups / pick_groups (octant digits of the node cell and of the
    pick cell; <= 0 is one cell), pick (PICK_*), depth (GRID_CENTER: the
    pick cell's depth; JITTERED: the node's), cand and cfg. The plan stops
    before a level whose candidate grid is at or past the 21-level Morton
    capacity, or a JITTERED level without a config: their points stay at 0
    for the host engine."""
    if strategy not in sampling.GRID_SAMPLERS:
        raise ValueError(f"no octree sweep for sampler {strategy!r}")
    max_level = min(MAX_LEVELS - 1, max_depth)
    plan = []
    for node_level in range(min_node_level, max_level + 1):
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
        level = {"node_level": node_level, "terminal": is_terminal,
                 "node_groups": node_level + 1, "cand": cand, "cfg": cfg}
        if is_terminal:
            level.update(pick=PICK_FIRST, pick_groups=node_level + 1,
                         depth=0)
        elif strategy == "JITTERED":
            level.update(pick=PICK_JITTER, pick_groups=cfg[1] + 1,
                         depth=node_level + 1)
        elif cand == -1:
            level.update(pick=PICK_FIRST, pick_groups=node_level + 1,
                         depth=0)
        elif strategy == "GRID_CENTER":
            level.update(pick=PICK_CENTER, pick_groups=cand + 1,
                         depth=cand + 1)
        else:
            level.update(pick=PICK_FIRST, pick_groups=cand + 1, depth=0)
        plan.append(level)
        if is_terminal:
            break
    return plan


def octree_select_grid(key: torch.Tensor, cands, max_points: int,
                       max_depth: int, strategy: str = "RANDOM_GRID",
                       positions: torch.Tensor | None = None, root_min=None,
                       root_max=None, jit_cfgs=None,
                       min_node_level: int = -1) -> torch.Tensor:
    """Per-point octree assignment level of a Morton-sorted FRESH batch
    under RANDOM_GRID, GRID_CENTER or JITTERED sampling, on the keys'
    device: the kernel of csrc/sweep.cu for a CUDA tensor, the plain
    version `octree_select_grid_torch` for a CPU tensor.

    key: (n,) int64 sorted keys. GRID_CENTER and JITTERED need the (n, 3)
    float64 positions in key order and the root bounds (root_min, root_max:
    three floats each); JITTERED also the configs of
    jittered_static_configs. min_node_level: selection starts at this node
    level (FAST's start-node level - 1; -1 starts at the root).

    Returns (n,) int8 levels: 0 = unassigned (host path), otherwise
    node_level + 2."""
    args = (key, cands, max_points, max_depth, strategy, positions,
            root_min, root_max, jit_cfgs, min_node_level)
    if key.device.type == "cuda":
        return octree_select_grid_cuda(*args)
    if key.device.type == "cpu":
        return octree_select_grid_torch(*args)
    raise ValueError(f"no octree sweep for device {key.device}")


def octree_select_grid_torch(key: torch.Tensor, cands, max_points: int,
                             max_depth: int, strategy: str = "RANDOM_GRID",
                             positions: torch.Tensor | None = None,
                             root_min=None, root_max=None, jit_cfgs=None,
                             min_node_level: int = -1) -> torch.Tensor:
    """The plain version of octree_select_grid in torch ops, on any device
    (the kernel's reference on the card)."""
    n = key.shape[0]
    device = key.device
    iota = torch.arange(n, dtype=torch.int64, device=device)
    remaining = torch.ones(n, dtype=torch.bool, device=device)
    out = torch.zeros(n, dtype=torch.int8, device=device)

    for level in level_plan(strategy, cands, max_depth, jit_cfgs,
                            min_node_level):
        node_level, cand, cfg = (level["node_level"], level["cand"],
                                 level["cfg"])
        # Early exit once every point is assigned (the JAX program's
        # lax.cond short-circuit). It reads one flag back from the device.
        if not bool(remaining.any()):
            break
        participating = remaining
        if level["terminal"]:
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


# -- the CUDA kernel -----------------------------------------------------------

_lock = threading.Lock()
x2_launches = 0  # kernels of csrc/sweep.cu launched, counted where launched

LEVEL_INTS = 9 + 3 * 64  # one level of the packed plan (csrc/sweep.cu Level)
# levels a plan holds at most: node levels -1 .. MAX_LEVELS - 1
MAX_PLAN_LEVELS = MAX_LEVELS + 1


def reset_counters() -> None:
    global x2_launches
    with _lock:
        x2_launches = 0


def snapshot() -> dict:
    with _lock:
        return {"x2_launches": x2_launches}


def _pack_plan(plan: list) -> np.ndarray:
    """The plan as csrc/sweep.cu reads it from the launch's device buffer:
    LEVEL_INTS int32 per level (node_level, terminal, node_groups,
    pick_groups, pick, depth, levels, actual, plen, then the three
    permutation rows of 64), at least one row."""
    if len(plan) > MAX_PLAN_LEVELS:
        raise ValueError(f"a plan holds at most {MAX_PLAN_LEVELS} levels, "
                         f"got {len(plan)}")
    packed = np.zeros((max(len(plan), 1), LEVEL_INTS), dtype=np.int32)
    for row, lv in zip(packed, plan):
        row[:6] = (lv["node_level"], lv["terminal"], lv["node_groups"],
                   lv["pick_groups"], lv["pick"], lv["depth"])
        if lv["pick"] == PICK_JITTER:
            levels, _, actual, plen, perms = lv["cfg"]
            row[6:9] = (levels, actual, plen)
            for a, perm in enumerate(perms):
                row[9 + 64 * a:9 + 64 * a + plen] = perm[:plen]
    return packed


_c_fn = None


def _kernel_fn():
    """ctypes entry points of csrc/sweep.cu (built and loaded at first
    use): {"config": x2_config, "sweep": x2_sweep}."""
    global _c_fn
    if _c_fn is None:
        from ._cuda_build import load_kernel_library

        lib = load_kernel_library("sweep")
        if lib.x2_level_ints() != LEVEL_INTS:
            raise RuntimeError("csrc/sweep.cu packs another plan layout")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        cint = ctypes.POINTER(i32)
        config = lib.x2_config
        config.argtypes = [i64, i32, cint, cint, cint, ctypes.POINTER(i64)]
        sweep = lib.x2_sweep
        sweep.argtypes = [p, p, i64, p, p, p, p, p, p, p, i32, p, i64, p,
                          i32, i32, i32, i32, p]
        for fn in (config, sweep):
            fn.restype = ctypes.c_int
        _c_fn = {"config": config, "sweep": sweep}
    return _c_fn


def _check_inputs(key, positions, strategy, root_min, root_max,
                  jit_cfgs) -> None:
    """Raise on an input the kernel does not take; loads nothing."""
    if strategy not in sampling.GRID_SAMPLERS:
        raise ValueError(f"no octree sweep for sampler {strategy!r}")
    if key.dtype != torch.int64:
        raise TypeError(f"key has dtype {key.dtype}, expected torch.int64")
    if key.dim() != 1:
        raise ValueError(f"key has shape {tuple(key.shape)}, expected (n,)")
    if not key.is_contiguous():
        raise ValueError("key must be contiguous")
    if key.shape[0] >= 2 ** 31:
        raise ValueError(f"{key.shape[0]} points: the kernel indexes fewer "
                         f"than 2^31")
    if strategy != "RANDOM_GRID":
        if positions is None or root_min is None or root_max is None:
            raise ValueError(f"{strategy} needs positions, root_min and "
                             f"root_max")
        if positions.dtype != torch.float64:
            raise TypeError(f"positions have dtype {positions.dtype}, "
                            f"expected torch.float64")
        if tuple(positions.shape) != (key.shape[0], 3):
            raise ValueError(f"positions have shape "
                             f"{tuple(positions.shape)}, expected "
                             f"({key.shape[0]}, 3)")
        if not positions.is_contiguous():
            raise ValueError("positions must be contiguous")
        if positions.device != key.device:
            raise ValueError(f"positions are on {positions.device}, the "
                             f"keys on {key.device}")
        if len(root_min) != 3 or len(root_max) != 3:
            raise ValueError("root_min and root_max take three values each")
    if strategy == "JITTERED" and jit_cfgs is None:
        raise ValueError("JITTERED needs jit_cfgs")
    if key.device.type != "cuda":
        raise ValueError(f"octree_select_grid_cuda needs CUDA tensors, got "
                         f"{key.device}")


def octree_select_grid_cuda(key: torch.Tensor, cands, max_points: int,
                            max_depth: int, strategy: str = "RANDOM_GRID",
                            positions: torch.Tensor | None = None,
                            root_min=None, root_max=None, jit_cfgs=None,
                            min_node_level: int = -1,
                            out: torch.Tensor | None = None) -> torch.Tensor:
    """octree_select_grid by the kernel of csrc/sweep.cu: one cooperative
    launch on the current stream of the keys' device for the whole plan
    (which goes to the card in a buffer of its own), nothing read back. A
    launch the card refuses raises. `out` (tests): a contiguous (n,) int8
    CUDA tensor to write, else one from torch.empty. Scratch comes from
    torch.empty, of any content."""
    _check_inputs(key, positions, strategy, root_min, root_max, jit_cfgs)
    n = key.shape[0]
    device = key.device
    if out is None:
        out = torch.empty(n, dtype=torch.int8, device=device)
    elif (out.dtype != torch.int8 or tuple(out.shape) != (n,)
          or not out.is_contiguous() or out.device != device):
        raise ValueError("out must be a contiguous (n,) int8 tensor on the "
                         "keys' device")
    if n == 0:
        return out
    plan = level_plan(strategy, cands, max_depth, jit_cfgs, min_node_level)
    packed = _pack_plan(plan)
    distance = any(lv["pick"] != PICK_FIRST for lv in plan)
    bounds = np.zeros(6, dtype=np.float64)
    if positions is not None and root_min is not None:
        bounds[:3] = [float(v) for v in root_min]
        bounds[3:] = [float(v) for v in root_max]
    fns = _kernel_fn()

    def ptr(t):
        return ctypes.c_void_p(0 if t is None else t.data_ptr())

    # The scratch and the plan's buffer may be freed while the kernel still
    # runs: the caching allocator hands a block back only to work queued
    # after it on the same stream, where they were allocated and launched.
    with torch.cuda.device(device):
        grid, tile, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
        work_bytes = ctypes.c_int64()
        err = fns["config"](n, int(distance), ctypes.byref(grid),
                            ctypes.byref(tile), ctypes.byref(smem),
                            ctypes.byref(work_bytes))
        if err != 0:
            raise RuntimeError(f"octree sweep kernel: no launch fits the "
                               f"card: CUDA error {err}")
        # from pinned memory: the copy waits on nothing
        plan_t = torch.from_numpy(packed).pin_memory().to(
            device, non_blocking=True)
        alive = torch.empty(len(plan) + 1, dtype=torch.int32, device=device)
        count = torch.empty(2 * n, dtype=torch.int32, device=device)
        index = torch.empty(2 * n, dtype=torch.int32, device=device)
        dist = (torch.empty(2 * n, dtype=torch.int64, device=device)
                if distance else None)
        pdist = (torch.empty(n, dtype=torch.int64, device=device)
                 if distance else None)
        work = (torch.empty(work_bytes.value, dtype=torch.uint8,
                            device=device) if work_bytes.value else None)
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fns["sweep"](ptr(key), ptr(positions if distance else None), n,
                           ptr(out), ptr(alive), ptr(count), ptr(index),
                           ptr(dist), ptr(pdist), ptr(plan_t), len(plan),
                           bounds.ctypes.data_as(ctypes.c_void_p),
                           int(max_points), ptr(work), int(distance),
                           grid.value, tile.value, smem.value,
                           ctypes.c_void_p(stream))
    if err != 0:
        raise RuntimeError(f"octree sweep kernel launch failed: CUDA error "
                           f"{err}")
    global x2_launches
    with _lock:
        x2_launches += 1
    return out


def octree_select_random_grid(key: torch.Tensor, cands, max_points: int,
                              max_depth: int) -> torch.Tensor:
    return octree_select_grid(key, cands, max_points, max_depth,
                              strategy="RANDOM_GRID")


def keys_tensor(sorted_keys: np.ndarray, device) -> torch.Tensor:
    """Host uint64 keys (< 2^63) as an int64 tensor on `device`."""
    return torch.from_numpy(
        np.ascontiguousarray(sorted_keys).view(np.int64)).to(device)
