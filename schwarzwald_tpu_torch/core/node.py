"""Octree node structure and spacing/level math.

Parity: octree::NodeStructure (schwarzwald/core/tiling/Node.h:12-19) and the
spacing -> level formulas (Node.cpp:37-57). The root of the whole octree is
level -1; level 0 nodes have half the root side length.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from .aabb import AABB
from . import morton


@dataclasses.dataclass
class NodeStructure:
    name: str           # Potree-style name, e.g. "r0426"
    morton_key: int     # absolute Morton key with octants set down to `level`
    bounds: AABB
    level: int          # root = -1
    max_spacing: float  # spacing at this node
    max_depth: int


def root_node(bounds: AABB, spacing_at_root: float, max_depth: int) -> NodeStructure:
    return NodeStructure(
        name="r",
        morton_key=0,
        bounds=bounds,
        level=-1,
        max_spacing=float(spacing_at_root),
        max_depth=int(max_depth),
    )


def node_from_index(node_key: int, levels: int, root: NodeStructure) -> NodeStructure:
    """Build the NodeStructure for a node index below the given root.

    Matches the construction in TilingAlgorithmV3 (TilingAlgorithms.cpp:
    1327-1343, 1640-1656): level = levels - 1, spacing halves per level,
    bounds by iterative octant halving, morton key with the node's octants in
    the top levels.

    The bounds descent runs on python floats with the exact IEEE sequence of
    the reference's iterated get_octant_bounds (e = (h-l)*0.5; l += bit
    ? e : 0.0; h = l+e) — the per-level numpy small-array ops this used to
    do cost ~0.1 ms per node, which dominated sweep persists at out-of-core
    node counts."""
    digits = []
    l0, l1, l2 = (float(root.bounds.min[0]), float(root.bounds.min[1]),
                  float(root.bounds.min[2]))
    h0, h1, h2 = (float(root.bounds.max[0]), float(root.bounds.max[1]),
                  float(root.bounds.max[2]))
    for i in range(levels):
        o = (node_key >> (3 * (levels - 1 - i))) & 0b111
        digits.append(o)
        e0 = (h0 - l0) * 0.5
        e1 = (h1 - l1) * 0.5
        e2 = (h2 - l2) * 0.5
        l0 = l0 + (e0 if o & 4 else 0.0)
        l1 = l1 + (e1 if o & 2 else 0.0)
        l2 = l2 + (e2 if o & 1 else 0.0)
        h0, h1, h2 = l0 + e0, l1 + e1, l2 + e2
    key = (int(node_key) << (3 * (morton.MAX_LEVELS - levels))) \
        if levels <= morton.MAX_LEVELS else int(node_key)
    return NodeStructure(
        name="r" + "".join(str(o) for o in digits),
        morton_key=key,
        bounds=AABB(np.array([l0, l1, l2]), np.array([h0, h1, h2])),
        level=levels - 1,
        max_spacing=root.max_spacing / (2.0 ** levels),
        max_depth=root.max_depth,
    )


def spacing_at_level(spacing_at_root: float, node_level: int) -> float:
    """Spacing halves per level; root is level -1 (Node.cpp:48-56)."""
    return spacing_at_root / (2.0 ** (node_level + 1))


def first_node_level_obeying_spacing(target_spacing: float, root_extent_x: float) -> int:
    """Last level (from root) where the node side is >= target spacing.

    Matches Node.cpp:37-46 including the float32 log2f evaluation: the C++
    code computes std::log2f on a float argument, so we narrow to float32
    before the log for bit-comparable level decisions.
    """
    ratio = np.float32(root_extent_x / target_spacing)
    return max(-1, int(math.floor(float(np.log2(ratio)))) - 1)


def node_level_to_sample_from(source_node_level: int, root: NodeStructure) -> int:
    """Grid-sampling candidate level for a node (Node.cpp:48-57)."""
    spacing = root.max_spacing / (2.0 ** (source_node_level + 1))
    return first_node_level_obeying_spacing(spacing, float(root.bounds.extent()[0]))
