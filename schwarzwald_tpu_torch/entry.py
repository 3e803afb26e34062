"""The port's flagship step, the counterpart of the JAX package's
`__graft_entry__.entry()`: the batch step (Morton interleave on kernel K1,
stable key sort with the point index as payload, start-level histogram) and
the complete level-synchronous octree selection under RANDOM_GRID, over
65,536 random 21-bit grid coordinates.

    fn, args = entry("cuda")
    batch, levels = fn(*args)
"""
from __future__ import annotations

import numpy as np
import torch

from .ops import device, device_tiling

N_POINTS = 1 << 16


def entry(device_name: str = "cpu"):
    """(fn, (x, y, z)): fn runs the step on the inputs' device and returns
    (SortedBatch, int8 levels). The inputs are int32 tensors on
    `device_name`, drawn as the JAX entry draws them."""
    rng = np.random.default_rng(0)
    x, y, z = (torch.from_numpy(
        rng.integers(0, 1 << 21, N_POINTS).astype(np.int32)).to(device_name)
        for _ in range(3))
    cands = device_tiling.candidate_levels(
        root_extent_x=64.0, spacing_at_root=2.0, max_depth=100)

    def fn(x, y, z):
        batch = device.encode_sort_grid(x, y, z, level=3, device=x.device)
        levels = device_tiling.octree_select_random_grid(
            batch.keys, cands, 20_000, 100)
        return batch, levels

    return fn, (x, y, z)
