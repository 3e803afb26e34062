"""ConverterProcess: offline conversion of a tiled octree between formats.

Parity: ConverterProcess (schwarzwald/core/process/ConverterProcess.cpp):
parse properties.json / ept.json to recover root bounds + spacing
(parse_properties, :55-211), scan the source directory for node files
filtered by max_depth (find_all_octree_node_files, :297-324), rebuild the
octree from file names (generate_tree, :326-380), then convert node-by-node
with a thread pool to 3DTILES (pnts + subtree tileset.jsons of 3 levels,
split_tree_into_subtrees :400-489) or LAS/LAZ (:536-560).

A copy of the JAX package's converter (schwarzwald_tpu/process/converter.py)
with the port's own modules. The conversion is host work there too (node
files decoded and re-encoded by the native codec, in a thread pool): it
runs nothing on a device, and the port adds nothing to it.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import json
import os
import shutil

from ..core import morton, octree
from ..core.aabb import AABB, bounds_from_octants
from ..core.pointbuffer import PointBuffer
from ..io import las
from ..io.bin_persistence import BinaryPersistence
from ..io.las_persistence import LASPersistence
from ..io.pnts import read_pnts, write_pnts
from ..io.tileset import Tileset, write_tileset_json
from ..core.attributes import PointAttribute
from ..util import log

SUBTREE_LEVELS = 3  # split_tree_into_subtrees (ConverterProcess.cpp:640-660)

NODE_EXTENSIONS = (".bin", ".binz", ".las", ".laz", ".pnts")


@dataclasses.dataclass
class ConverterArguments:
    source_folder: str
    output_folder: str
    output_format: str = "3DTILES"  # 3DTILES | LAS | LAZ
    source_projection: str | None = None
    max_depth: int = -1
    delete_source: bool = False


def parse_properties(source_folder: str):
    """Recover (root_bounds, spacing) from properties.json, ept.json or a
    Potree v1 cloud.js (parse_properties, ConverterProcess.cpp:55-211)."""
    props = os.path.join(source_folder, "properties.json")
    if os.path.exists(props):
        doc = json.load(open(props))
        sp = doc["source_properties"]
        bounds = AABB(sp["bounds"]["min"], sp["bounds"]["max"])
        return bounds, float(sp["root_spacing"])
    ept = os.path.join(source_folder, "ept.json")
    if os.path.exists(ept):
        doc = json.load(open(ept))
        b = doc["bounds"]
        bounds = AABB(b[:3], b[3:])
        # EPT: spacing derives from bounds / span (ConverterProcess.cpp:135)
        return bounds, float(bounds.extent()[0]) / float(doc["span"])
    cloud_js = os.path.join(source_folder, "cloud.js")
    if os.path.exists(cloud_js):
        doc = json.load(open(cloud_js))
        bb = doc["boundingBox"]
        bounds = AABB([bb["lx"], bb["ly"], bb["lz"]],
                      [bb["ux"], bb["uy"], bb["uz"]])
        return bounds, float(doc["spacing"])
    raise RuntimeError(
        f"No properties.json, ept.json or cloud.js found in {source_folder}")


def find_all_octree_node_files(source_folder: str, max_depth: int):
    """Scan for node files; returns {potree_name: path}."""
    candidates = [source_folder, os.path.join(source_folder, "ept-data")]
    out = {}
    for folder in candidates:
        if not os.path.isdir(folder):
            continue
        for name in os.listdir(folder):
            stem, ext = os.path.splitext(name)
            if ext.lower() not in NODE_EXTENSIONS:
                continue
            try:
                key, levels = morton.parse_node_name(stem)
            except ValueError:
                continue
            if max_depth >= 0 and levels > max_depth:
                continue
            out["r" + morton.node_name_simple(key, levels)] = \
                os.path.join(folder, name)
    return out


def generate_tree(node_files: dict) -> octree.Octree:
    tree = octree.Octree()
    for name, path in node_files.items():
        key, levels = morton.parse_node_name(name)
        tree.insert((key, levels), path)
    return tree


def read_node_points(path: str) -> PointBuffer:
    """get_persistence_for_file (ConverterProcess.cpp:237-270)."""
    ext = os.path.splitext(path)[1].lower()
    if ext in (".bin", ".binz"):
        sink = BinaryPersistence(os.path.dirname(path),
                                 compressed=(ext == ".binz"))
        return sink.retrieve_points(os.path.splitext(os.path.basename(path))[0])
    if ext in (".las", ".laz"):
        return las.read_las(path)
    if ext == ".pnts":
        buf, rtc = read_pnts(path)
        buf.positions = buf.positions + rtc
        return buf
    raise ValueError(f"Unsupported node file {path}")


def convert_to_3dtiles(args: ConverterArguments, bounds: AABB,
                       spacing: float, node_files: dict,
                       transform=None) -> None:
    offset = bounds.center()
    by_name: dict[str, Tileset] = {}

    def node_bounds(name: str) -> AABB:
        return bounds_from_octants([int(c) for c in name[1:]], bounds)

    def convert_one(item):
        name, path = item
        buf = read_node_points(path)
        if not buf.count:
            return
        if transform is not None:
            buf.positions = transform.transform_positions(buf.positions)
        # .pnts stores f32 positions RELATIVE to RTC_CENTER: re-center before
        # the f32 cast (absolute UTM-scale coords would lose precision and
        # render displaced by +offset). Reference re-centers per node via
        # setOriginToSmallestPoint (ConverterProcess.cpp:517).
        buf.positions = buf.positions - offset
        write_pnts(os.path.join(args.output_folder, name + ".pnts"), buf,
                   {PointAttribute.Position, PointAttribute.RGB,
                    PointAttribute.Intensity}, offset)

    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(convert_one, sorted(node_files.items())))

    # Build the tileset forest (subtrees of SUBTREE_LEVELS levels)
    for name in sorted(node_files, key=len):
        ts = Tileset(name=name, url=name + ".json",
                     content_url=name + ".pnts",
                     geometric_error=spacing / (2.0 ** (len(name) - 1)),
                     bounding_box=Tileset.bounding_box_from_aabb(
                         node_bounds(name)))
        by_name[name] = ts
        if len(name) > 1 and name[:-1] in by_name:
            by_name[name[:-1]].children.append(ts)
    if "r" not in by_name:
        raise RuntimeError("Converter: no root node found")
    queue = [by_name["r"]]
    while queue:
        root = queue.pop(0)
        write_tileset_json(
            os.path.join(args.output_folder, root.name + ".json"),
            root, SUBTREE_LEVELS)
        frontier = [root]
        for _ in range(SUBTREE_LEVELS):
            frontier = [c for t in frontier for c in t.children]
        queue.extend(frontier)


def convert_to_las(args: ConverterArguments, bounds: AABB,
                   node_files: dict, compressed: bool,
                   transform=None) -> None:
    sink = LASPersistence(args.output_folder, compressed=compressed)

    def node_bounds(name: str) -> AABB:
        return bounds_from_octants([int(c) for c in name[1:]], bounds)

    def convert_one(item):
        name, path = item
        buf = read_node_points(path)
        if buf.count:
            if transform is not None:
                buf.positions = transform.transform_positions(buf.positions)
            sink.persist_points(buf, node_bounds(name), name)

    with concurrent.futures.ThreadPoolExecutor() as pool:
        list(pool.map(convert_one, sorted(node_files.items())))
    sink.close()  # drain the write-behind queue before returning


def run_conversion(args: ConverterArguments) -> None:
    """run_conversion (ConverterProcess.cpp:737-767)."""
    from ..io.srs import make_transform

    transform = make_transform(args.source_projection)
    bounds, spacing = parse_properties(args.source_folder)
    if args.source_projection:
        bounds = transform.transform_aabb(bounds)
    node_files = find_all_octree_node_files(args.source_folder,
                                            args.max_depth)
    if not node_files:
        raise RuntimeError(f"No octree node files in {args.source_folder}")
    if os.path.exists(args.output_folder):
        for entry in os.listdir(args.output_folder):
            full = os.path.join(args.output_folder, entry)
            shutil.rmtree(full) if os.path.isdir(full) else os.remove(full)
    os.makedirs(args.output_folder, exist_ok=True)

    fmt = args.output_format.upper()
    if fmt == "3DTILES":
        convert_to_3dtiles(args, bounds, spacing, node_files, transform)
    elif fmt in ("LAS", "LAZ"):
        convert_to_las(args, bounds, node_files, compressed=(fmt == "LAZ"),
                       transform=transform)
    else:
        raise ValueError(f"Unsupported converter output format {fmt}")

    if args.delete_source:
        for path in node_files.values():
            os.remove(path)
    log.info(f"Converted {len(node_files)} nodes to {fmt}")
