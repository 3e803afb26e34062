"""Cesium 3D Tiles persistence: one .pnts per node + a tileset.json forest.

Parity: Cesium3DTilesPersistence (schwarzwald/core/io/
Cesium3DTilesPersistence.cpp): in-memory tileset tree grown on every node
write (on_write_node, :81-158), geometricError = root_spacing / 2^depth
(:94-95), bounding volumes translated by the global offset (:90), and a
forest of tileset.json files split every MAX_DEPTH=2 levels on close
(write_tilesets, :174-213). Lossless (f32 positions are exact after the
3DTILES center-shift truncation performed by the tiler).
"""
from __future__ import annotations

import os
import threading

import numpy as np

from ..core.aabb import AABB, octant_bounds
from ..core.attributes import RGBMapping
from ..core.pointbuffer import PointBuffer
from . import pnts
from .tileset import Tileset, write_tileset_json

TILESET_SPLIT_DEPTH = 2  # MAX_DEPTH (Cesium3DTilesPersistence.cpp:179)


def get_root_bounds_from_node(node_name: str, node_bounds: AABB) -> AABB:
    """get_root_bounds_from_node (OctreeAlgorithms.cpp): invert the octant
    descent from the node's bounds back up to the root."""
    mins = node_bounds.min.copy()
    maxs = node_bounds.max.copy()
    for digit in reversed(node_name[1:]):
        octant = int(digit)
        ext = maxs - mins
        if octant & 1:
            mins[2] -= ext[2]
        else:
            maxs[2] += ext[2]
        if (octant >> 1) & 1:
            mins[1] -= ext[1]
        else:
            maxs[1] += ext[1]
        if (octant >> 2) & 1:
            mins[0] -= ext[0]
        else:
            maxs[0] += ext[0]
    return AABB(mins, maxs)


class Cesium3DTilesPersistence:
    is_lossless = True

    def __init__(self, work_dir: str, input_attributes, output_attributes,
                 rgb_mapping: RGBMapping, spacing_at_root: float,
                 global_offset):
        if not set(input_attributes) <= set(output_attributes) \
                and rgb_mapping == RGBMapping.Nothing:
            pass  # attribute clamping is handled by the process layer
        self.work_dir = work_dir
        self.input_attributes = set(input_attributes)
        self.output_attributes = set(output_attributes)
        self.rgb_mapping = rgb_mapping
        self.spacing_at_root = spacing_at_root
        self.global_offset = np.asarray(global_offset, dtype=np.float64)
        self._root_tileset: Tileset | None = None
        self._by_name: dict[str, Tileset] = {}
        self._lock = threading.Lock()
        os.makedirs(work_dir, exist_ok=True)
        from .staging import FileStaging
        self._staging = FileStaging(work_dir)
        from .write_behind import writer_from_env
        self._writer = writer_from_env()

    def _path(self, node_name: str) -> str:
        return os.path.join(self.work_dir, node_name + ".pnts")

    def persist_points(self, points: PointBuffer, bounds: AABB,
                       node_name: str) -> None:
        if not points.count:
            raise RuntimeError("persist_points requires a non-empty range")
        path = self._staging.path_for(self._path(node_name))
        if self._writer is not None:
            buf, total = pnts.encode_pnts_into(
                points, self.output_attributes, self.global_offset,
                self.rgb_mapping, self._writer.alloc)
            self._writer.submit(path, buf, total)
        else:
            pnts.write_pnts(path, points, self.output_attributes,
                            self.global_offset, self.rgb_mapping)
        self._on_write_node(node_name, bounds)

    def _wait_written(self, path: str) -> None:
        if self._writer is not None:
            self._writer.wait(path)

    def retrieve_points(self, node_name: str) -> PointBuffer:
        path = self._path(node_name)
        self._wait_written(path)
        if not os.path.exists(path):
            return PointBuffer()
        buf, _ = pnts.read_pnts(path, self.input_attributes)
        return buf

    def node_exists(self, node_name: str) -> bool:
        path = self._path(node_name)
        self._wait_written(path)
        return os.path.exists(path)

    def node_names(self) -> list:
        """Committed node names, for the device revisit sweep."""
        if self._writer is not None:
            self._writer.drain()
        return sorted(f[:-5] for f in os.listdir(self.work_dir)
                      if f.endswith(".pnts")
                      and os.path.isfile(os.path.join(self.work_dir, f)))

    def begin_batch(self) -> None:
        self._staging.begin()

    def commit_batch(self, extra_renames=None) -> None:
        if self._writer is not None:
            self._writer.drain()  # renames must see completed files
        self._staging.commit(extra_renames)

    # -- tileset tree -------------------------------------------------------

    def _setup(self, tileset: Tileset, node_name: str,
               node_bounds: AABB) -> None:
        depth = len(node_name) - 1
        tileset.name = node_name
        tileset.content_url = node_name + ".pnts"
        tileset.url = node_name + ".json"
        tileset.bounding_box = Tileset.bounding_box_from_aabb(
            node_bounds.translated(self.global_offset))
        tileset.geometric_error = self.spacing_at_root / (2.0 ** depth)

    def _on_write_node(self, node_name: str, node_bounds: AABB) -> None:
        """Grow the in-memory tileset tree, creating missing ancestors
        (on_write_node, Cesium3DTilesPersistence.cpp:81-158)."""
        with self._lock:
            if self._root_tileset is None:
                root_bounds = get_root_bounds_from_node(node_name, node_bounds)
                self._root_tileset = Tileset()
                self._setup(self._root_tileset, "r", root_bounds)
                self._by_name["r"] = self._root_tileset

            current = self._root_tileset
            current_bounds = self._bounds_of_root()
            for idx in range(1, len(node_name)):
                sub_name = node_name[:idx + 1]
                octant = int(node_name[idx])
                child_bounds = octant_bounds(octant, current_bounds)
                child = self._by_name.get(sub_name)
                if child is None:
                    child = Tileset()
                    self._setup(child, sub_name, child_bounds)
                    current.children.append(child)
                    self._by_name[sub_name] = child
                current = child
                current_bounds = child_bounds

    def _bounds_of_root(self) -> AABB:
        bb = self._root_tileset.bounding_box
        center = np.array(bb[0:3]) - self.global_offset
        ext = np.array([bb[3], bb[7], bb[11]])
        return AABB(center - ext / 2, center + ext / 2)

    def close(self) -> None:
        """Write the tileset.json forest (write_tilesets, cpp:174-213)."""
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        self._reconcile_existing_nodes()
        if self._root_tileset is None:
            return
        # children were appended in node-completion order, which under the
        # start-node thread fan-out is nondeterministic; normalize to name
        # order so output is byte-identical at any concurrency (the
        # reference leaves completion order in the file — a cosmetic,
        # documented deviation)
        stack = [self._root_tileset]
        while stack:
            t = stack.pop()
            t.children.sort(key=lambda c: c.name)
            stack.extend(t.children)
        queue = [self._root_tileset]
        while queue:
            root = queue.pop(0)
            write_tileset_json(os.path.join(self.work_dir, root.name + ".json"),
                               root, TILESET_SPLIT_DEPTH + 1)
            queue.extend(self._collect_at_depth(root, TILESET_SPLIT_DEPTH))

    def _reconcile_existing_nodes(self) -> None:
        """Register .pnts files written by a previous (resumed) session so
        the tileset forest covers the whole on-disk octree."""
        if self._root_tileset is None:
            return
        root_bounds = self._bounds_of_root()
        for name in os.listdir(self.work_dir):
            if not name.endswith(".pnts"):
                continue
            node_name = name[:-5]
            if node_name in self._by_name:
                continue
            from ..core.aabb import bounds_from_octants
            try:
                digits = [int(c) for c in node_name[1:]]
            except ValueError:
                continue
            self._on_write_node(node_name,
                                bounds_from_octants(digits, root_bounds))

    @staticmethod
    def _collect_at_depth(tileset: Tileset, remaining: int):
        if remaining == 0:
            return list(tileset.children)
        out = []
        for child in tileset.children:
            out.extend(Cesium3DTilesPersistence._collect_at_depth(
                child, remaining - 1))
        return out
