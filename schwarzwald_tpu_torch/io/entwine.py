"""Entwine/EPT persistence (Potree-compatible).

Parity: EntwinePersistence (schwarzwald/core/io/EntwinePersistence.cpp):
ept-data/ LAS or LAZ files named in Entwine convention ("0-0-0-0"),
thread-safe node->count hierarchy, ept-hierarchy/*.json split into subtrees
of depth 5 with negative counts marking external subtree references
(create_hierarchy_files, :52-130), ept.json schema mapping (:133-280) and
the ept-data/ept-hierarchy/ept-sources folder scaffold (:31-49).
"""
from __future__ import annotations

import json
import os
import threading

from ..core import morton
from ..core.aabb import AABB
from ..core.attributes import PointAttribute
from ..core.pointbuffer import PointBuffer
from .las_persistence import LASPersistence

SPLIT_DEPTH = 5  # EntwinePersistence.cpp:56

A = PointAttribute

# point_attributes_to_ept_schema (EntwinePersistence.cpp:133-196).
# Entries are (name, size, type, offset, scale); Position expands to X/Y/Z.
_SCHEMA_MAP = {
    A.Position: [("X", 4, "signed", 0, 1), ("Y", 4, "signed", 0, 1),
                 ("Z", 4, "signed", 0, 1)],
    A.RGB: [("Red", 2, "unsigned"), ("Green", 2, "unsigned"),
            ("Blue", 2, "unsigned")],
    A.Intensity: [("Intensity", 2, "unsigned")],
    A.Classification: [("Classification", 1, "unsigned")],
    A.EdgeOfFlightLine: [("EdgeOfFlightLine", 1, "unsigned")],
    A.GPSTime: [("GpsTime", 8, "float")],
    A.Normal: [("NX", 4, "float"), ("NY", 4, "float"), ("NZ", 4, "float")],
    A.NumberOfReturns: [("NumberOfReturns", 1, "unsigned")],
    A.PointSourceID: [("PointSourceID", 2, "unsigned")],
    A.ReturnNumber: [("ReturnNumber", 1, "unsigned")],
    A.ScanAngleRank: [("ScanAngleRank", 1, "signed")],
    A.ScanDirectionFlag: [("ScanDirectionFlag", 1, "unsigned")],
    A.UserData: [("UserData", 1, "unsigned")],
}


def point_attributes_to_ept_schema(attributes) -> list:
    schema = []
    for attr in sorted(attributes, key=lambda a: a.value):
        for entry in _SCHEMA_MAP[attr]:
            d = {"name": entry[0], "size": entry[1], "type": entry[2]}
            if len(entry) > 3:
                d["offset"] = entry[3]
                d["scale"] = entry[4]
            schema.append(d)
    return schema


def write_ept_json(path: str, *, bounds: AABB, conforming_bounds: AABB,
                   data_type: str, points: int, schema: list, span: float,
                   srs=None, version: str = "1.0.0") -> None:
    doc = {
        "bounds": [*map(float, bounds.min), *map(float, bounds.max)],
        "boundsConforming": [*map(float, conforming_bounds.min),
                             *map(float, conforming_bounds.max)],
        "dataType": data_type,  # "las" | "laszip"
        "hierarchyType": "json",
        "points": points,
        "schema": schema,
        "span": span,
        "srs": srs or {"authority": "", "horizontal": "", "wkt": ""},
        "version": version,
    }
    with open(path, "w") as f:
        json.dump(doc, f, separators=(",", ":"))


def potree_name_to_entwine_name(node_name: str) -> str:
    key, levels = morton.parse_node_name(node_name)
    return morton.node_name_entwine(key, levels)


def create_hierarchy_files(root_dir: str, hierarchy: dict) -> None:
    """Split the node->count map into subtrees of SPLIT_DEPTH levels
    (EntwinePersistence.cpp:52-130); negative counts mark subtree refs."""
    def subtree_parent(key: int, levels: int):
        while levels % SPLIT_DEPTH != 0:
            key >>= 3
            levels -= 1
        return key, levels

    split: dict = {}
    # sorted: hierarchy insertion order is completion order, which under
    # the start-node thread fan-out is nondeterministic — normalize so
    # output is byte-identical at any concurrency
    for entwine_name, count in sorted(hierarchy.items()):
        key, levels = morton.parse_node_name(entwine_name)
        parent = subtree_parent(key, levels)
        if parent not in split:
            # new subtree root: mark it in its own parent subtree chain
            p_key, p_levels = parent
            while p_levels > 0:
                gp = subtree_parent(p_key >> 3, p_levels - 1)
                split.setdefault(gp, {})[(p_key, p_levels)] = -1
                p_key, p_levels = gp
        split.setdefault(parent, {})[(key, levels)] = int(count)

    hierarchy_dir = os.path.join(root_dir, "ept-hierarchy")
    for (p_key, p_levels), nodes in split.items():
        doc = {morton.node_name_entwine(k, lv): c
               for (k, lv), c in sorted(nodes.items())}
        path = os.path.join(hierarchy_dir,
                            morton.node_name_entwine(p_key, p_levels) + ".json")
        with open(path, "w") as f:
            json.dump(doc, f, separators=(",", ":"))


class EntwinePersistence:
    is_lossless = False

    def __init__(self, work_dir: str, input_attributes=None,
                 output_attributes=None, compressed: bool = False,
                 extended: bool = False, laz_extended_output: bool = False):
        self.work_dir = work_dir
        self.compressed = compressed
        self.extension = ".laz" if compressed else ".las"
        os.makedirs(work_dir, exist_ok=True)
        for sub in ("ept-data", "ept-hierarchy", "ept-sources"):
            os.makedirs(os.path.join(work_dir, sub), exist_ok=True)
        self._las = LASPersistence(os.path.join(work_dir, "ept-data"),
                                   input_attributes, output_attributes,
                                   compressed=compressed, extended=extended,
                                   laz_extended_output=laz_extended_output)
        self._hierarchy: dict[str, int] = {}
        self._lock = threading.Lock()

    def persist_points(self, points: PointBuffer, bounds: AABB,
                       node_name: str) -> None:
        if not points.count:
            return
        entwine_name = potree_name_to_entwine_name(node_name)
        self._las.persist_points(points, bounds, entwine_name)
        with self._lock:
            self._hierarchy[entwine_name] = points.count

    def retrieve_points(self, node_name: str) -> PointBuffer:
        return self._las.retrieve_points(potree_name_to_entwine_name(node_name))

    def node_exists(self, node_name: str) -> bool:
        return self._las.node_exists(potree_name_to_entwine_name(node_name))

    def node_names(self) -> list:
        """Node names converted back to the engine's potree convention."""
        from ..core import morton

        out = []
        for name in self._las.node_names():
            try:
                key, levels = morton.parse_node_name(name)
            except (ValueError, IndexError):
                continue  # stray file, not a node
            out.append(morton.node_name_potree(key, levels))
        return sorted(out)

    def simulate_retrieve(self, points, bounds):
        return self._las.simulate_retrieve(points, bounds)

    def begin_batch(self) -> None:
        self._las.begin_batch()

    def commit_batch(self, extra_renames=None) -> None:
        self._las.commit_batch(extra_renames)

    def close(self) -> None:
        # drain + stop the write-behind pool FIRST so the directory scan
        # below sees only complete files
        self._las.close()
        with self._lock:
            # Register nodes written by a previous (resumed) session that
            # this session never revisited.
            data_dir = os.path.join(self.work_dir, "ept-data")
            for name in os.listdir(data_dir):
                stem, ext = os.path.splitext(name)
                if ext != self.extension or stem in self._hierarchy:
                    continue
                try:
                    from . import las as las_mod
                    f = las_mod.LASFile(os.path.join(data_dir, name))
                    self._hierarchy[stem] = f.count
                except Exception:
                    continue
            create_hierarchy_files(self.work_dir, self._hierarchy)
