"""Candidate grid levels of the octree sweep.

Only the host-side helper the engine uses (schwarzwald_tpu/ops/
device_tiling.py:35-46). The level-synchronous device sweep itself is ROADMAP
Queue 1 item 4.
"""
from __future__ import annotations

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
