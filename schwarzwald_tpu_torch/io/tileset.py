"""3D Tiles tileset model + tileset.json writer.

Parity: Tileset (schwarzwald/core/pointcloud/Tileset.h:68-117,
boundingBoxFromAABB Tileset.cpp) and writeTilesetJSON
(core/io/TileSetWriter.cpp): refine ADD, box bounding volumes
(center + axis half-vectors), external-tileset references below max_depth.
"""
from __future__ import annotations

import dataclasses
import json
from typing import List

from ..core.aabb import AABB


@dataclasses.dataclass
class Tileset:
    name: str = ""
    url: str = ""              # external tileset json, e.g. "r04.json"
    content_url: str = ""      # pnts content, e.g. "r04.pnts"
    geometric_error: float = 500.0
    bounding_box: list = None  # 12 doubles: center + 3 axis vectors
    children: List["Tileset"] = dataclasses.field(default_factory=list)
    version: str = "0.0"

    @staticmethod
    def bounding_box_from_aabb(aabb: AABB) -> list:
        """boundingBoxFromAABB: center + extent-aligned axes
        (Tileset.cpp:95-118)."""
        c = aabb.center()
        e = aabb.extent()
        return [float(c[0]), float(c[1]), float(c[2]),
                float(e[0]), 0.0, 0.0,
                0.0, float(e[1]), 0.0,
                0.0, 0.0, float(e[2])]


def _write_tile(tileset: Tileset, remaining_levels: int) -> dict:
    """write_tileset (TileSetWriter.cpp:41-81): at remaining_levels == 0 the
    content uri points to the external tileset json instead of the pnts."""
    node = {
        "boundingVolume": {"box": tileset.bounding_box},
        "geometricError": tileset.geometric_error,
        "refine": "ADD",
        "content": {
            "uri": tileset.url if remaining_levels == 0 else tileset.content_url
        },
    }
    if tileset.children and remaining_levels > 0:
        node["children"] = [_write_tile(c, remaining_levels - 1)
                            for c in tileset.children]
    return node


def _emit_tile(out: list, t: Tileset, remaining_levels: int) -> None:
    """Direct string emission of _write_tile's structure — the tileset
    forest writes hundreds of files per run and json.dump dominated the
    FAST close; repr() of floats matches json.dumps exactly."""
    box = ",".join(repr(v) for v in t.bounding_box)
    uri = t.url if remaining_levels == 0 else t.content_url
    out.append('{"boundingVolume":{"box":[%s]},"geometricError":%s,'
               '"refine":"ADD","content":{"uri":"%s"}'
               % (box, repr(t.geometric_error), uri))
    if t.children and remaining_levels > 0:
        out.append(',"children":[')
        for i, c in enumerate(t.children):
            if i:
                out.append(",")
            _emit_tile(out, c, remaining_levels - 1)
        out.append("]")
    out.append("}")


def write_tileset_json(path: str, tileset: Tileset, max_depth: int) -> None:
    out = ['{"asset":{"version":"%s"},"geometricError":%s,"root":'
           % (tileset.version, repr(tileset.geometric_error))]
    _emit_tile(out, tileset, max_depth)
    out.append("}")
    with open(path, "w") as f:
        f.write("".join(out))
