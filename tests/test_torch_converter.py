"""The port's converter (schwarzwald_tpu_torch/process/converter.py, CLI
`--converter` and `convert()`) against the JAX package's on the CPU. Each
case tiles one input once (with the JAX CLI), copies the tiled tree, and
converts one copy with each package; the converted trees must be equal
byte for byte (tolerance 0: every .pnts, tileset .json, .las and .laz),
and so must what is left of the sources under --delete-source. The JAX
package's converter cases (tests/test_process.py and tests/test_laz.py)
run here through both packages, with their own checks; then every source
format into every target format, --max-depth, --delete-source,
--source-projection EPSG:32631 and the convert() API."""
import json
import os
import shutil

import numpy as np
import pytest
import torch

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
import schwarzwald_tpu_torch
from schwarzwald_tpu.cli import main as jax_cli
from schwarzwald_tpu.io import las
from schwarzwald_tpu.io.pnts import read_pnts
from schwarzwald_tpu_torch.cli import main as port_cli

from test_torch_sinks import FORMATS, assert_same_tree, write_attributed_las

torch.set_num_threads(1)

CLIS = {"jax": jax_cli, "port": port_cli}


def tile(tmp_path, fmt, n=5000, seed=1, extra=()):
    """The JAX CLI's RANDOM_GRID tree of an attributed uniform cloud."""
    src = tmp_path / "in.las"
    write_attributed_las(src, n, seed)
    out = tmp_path / f"tiled_{fmt}"
    assert jax_cli(["--tiler", "-i", str(src), "-o", str(out),
                    "--spacing", "10", "--sampling", "RANDOM_GRID",
                    "--output-format", fmt, *extra]) == 0
    return out


def convert_both(tmp_path, tiled, target, extra=()):
    """Convert a copy of `tiled` with each package's CLI into a fresh
    folder; returns {"jax": folder, "port": folder} and asserts the two
    are byte-identical."""
    outs = {}
    for pkg, cli in CLIS.items():
        source = tmp_path / f"src_{pkg}"
        shutil.copytree(tiled, source)
        out = tmp_path / f"conv_{pkg}"
        assert cli(["--converter", "-i", str(source), "-o", str(out),
                    "--output-format", target, *extra]) == 0
        outs[pkg] = out
    assert_same_tree(outs["jax"], outs["port"])
    return outs


def pnts_points(folder) -> int:
    return sum(read_pnts(str(folder / f))[0].count
               for f in os.listdir(folder) if f.endswith(".pnts"))


# -- the JAX package's converter cases, through both packages ----------------

def test_converter_3dtiles_to_las(tmp_path):
    """tests/test_process.py test_converter_3dtiles_to_las."""
    outs = convert_both(tmp_path, tile(tmp_path, "BIN"), "LAS")
    for out in outs.values():
        assert las.read_las(str(out / "r.las")).count > 0


def test_converter_bin_to_3dtiles(tmp_path):
    """tests/test_process.py test_converter_bin_to_3dtiles: RTC-relative
    positions that give back the source node's points."""
    from schwarzwald_tpu.io.bin_persistence import BinaryPersistence

    tiled = tile(tmp_path, "BIN")
    outs = convert_both(tmp_path, tiled, "3DTILES")
    src_pts = BinaryPersistence(str(tiled)).retrieve_points("r").positions
    buf, rtc = read_pnts(str(outs["port"] / "r.pnts"))
    np.testing.assert_allclose(rtc, [50.0, 50.0, 50.0])
    np.testing.assert_allclose(np.sort(buf.positions + rtc, axis=0),
                               np.sort(src_pts, axis=0), atol=1e-4)
    assert np.abs(buf.positions).max() <= 100.0


def test_converter_cloud_js_input(tmp_path):
    """tests/test_process.py test_converter_cloud_js_input: a Potree v1
    folder (cloud.js and one .bin node)."""
    from schwarzwald_tpu.core.aabb import AABB
    from schwarzwald_tpu.core.pointbuffer import PointBuffer
    from schwarzwald_tpu.io.bin_persistence import BinaryPersistence

    src = tmp_path / "potree"
    src.mkdir()
    pos = np.random.default_rng(3).uniform(1, 99, (500, 3))
    BinaryPersistence(str(src)).persist_points(
        PointBuffer(pos), AABB([0.0] * 3, [100.0] * 3), "r")
    (src / "cloud.js").write_text(json.dumps({
        "spacing": 5.0, "boundingBox": {"lx": 0.0, "ly": 0.0, "lz": 0.0,
                                        "ux": 100.0, "uy": 100.0,
                                        "uz": 100.0}}))
    outs = convert_both(tmp_path, src, "3DTILES")
    doc = json.load(open(outs["port"] / "r.json"))
    assert doc["root"]["geometricError"] == 5.0


def test_library_api_tile_and_convert(tmp_path):
    """tests/test_process.py test_library_api_tile_and_convert: tile() to
    BIN, then convert() to LAS, in each package."""
    src = tmp_path / "in.las"
    write_attributed_las(src, 3000, 4)
    outs = {}
    for name, pkg, device in (("jax", schwarzwald_tpu, {}),
                              ("port", schwarzwald_tpu_torch,
                               {"use_device": "host"})):
        stats = pkg.tile(str(src), str(tmp_path / f"out_{name}"),
                         sampling_strategy="RANDOM_GRID",
                         output_format="BIN", spacing=8.0, **device)
        assert stats.points_processed == 3000
        pkg.convert(str(tmp_path / f"out_{name}"),
                    str(tmp_path / f"conv_{name}"), output_format="LAS")
        assert (tmp_path / f"conv_{name}" / "r.las").exists()
        outs[name] = tmp_path / f"conv_{name}"
    assert_same_tree(tmp_path / "out_jax", tmp_path / "out_port")
    assert_same_tree(outs["jax"], outs["port"])


def test_converter_laz_output(tmp_path):
    """tests/test_laz.py test_converter_laz_output."""
    outs = convert_both(tmp_path, tile(tmp_path, "BIN"), "LAZ")
    assert las.read_las(str(outs["port"] / "r.laz")).count > 0


def test_converter_entwine_laz_to_3dtiles(tmp_path):
    """tests/test_laz.py test_converter_entwine_laz_to_3dtiles: an ACCURATE
    ENTWINE_LAZ tree (entwine node names, .laz nodes) to 3D Tiles, every
    point once."""
    tiled = tile(tmp_path, "ENTWINE_LAZ",
                 extra=("--tiling-strategy", "ACCURATE"))
    outs = convert_both(tmp_path, tiled, "3DTILES")
    doc = json.load(open(outs["port"] / "r.json"))
    assert doc["root"]["geometricError"] > 0
    assert pnts_points(outs["port"]) == 5000


# -- every source format into every target -------------------------------------

@pytest.mark.parametrize("target", ["3DTILES", "LAS", "LAZ"])
@pytest.mark.parametrize("source", FORMATS)
def test_converter_every_format(tmp_path, source, target):
    tiled = tile(tmp_path, source, n=8000, seed=5,
                 extra=("--max-points-per-node", "1000"))
    outs = convert_both(tmp_path, tiled, target)
    names = os.listdir(outs["port"])
    assert f"r.{target.lower() if target != '3DTILES' else 'pnts'}" in names


@pytest.mark.parametrize("max_depth", [0, 1, 2])
@pytest.mark.parametrize("target", ["3DTILES", "LAZ"])
def test_converter_max_depth(tmp_path, target, max_depth):
    """--max-depth d converts the nodes of levels 0..d only."""
    tiled = tile(tmp_path, "3DTILES", n=12_000, seed=6,
                 extra=("--max-points-per-node", "500"))
    outs = convert_both(tmp_path, tiled, target,
                        extra=("--max-depth", str(max_depth)))
    ext = ".pnts" if target == "3DTILES" else ".laz"
    nodes = [f[:-len(ext)] for f in os.listdir(outs["port"])
             if f.endswith(ext)]
    assert max(len(n) - 1 for n in nodes) == max_depth
    deeper = [f for f in os.listdir(tiled)
              if f.endswith(".pnts") and len(f) - 6 > max_depth]
    assert deeper  # the source has nodes below the cut


@pytest.mark.parametrize("source", ["BIN", "LAZ", "ENTWINE_LAS"])
def test_converter_delete_source(tmp_path, source):
    """--delete-source removes each converted node file (only those) in
    both packages: the outputs and what is left of the sources agree."""
    tiled = tile(tmp_path, source, n=6000, seed=7,
                 extra=("--max-points-per-node", "500"))
    outs = convert_both(tmp_path, tiled, "3DTILES",
                        extra=("--delete-source", "--max-depth", "1"))
    left = {pkg: sorted(os.path.relpath(os.path.join(d, f),
                                        tmp_path / f"src_{pkg}")
                        for d, _, fs in os.walk(tmp_path / f"src_{pkg}")
                        for f in fs) for pkg in CLIS}
    assert left["jax"] == left["port"]
    assert "properties.json" in left["port"]
    converted = [f[:-5] for f in os.listdir(outs["port"])
                 if f.endswith(".pnts")]
    assert "r" in converted and max(map(len, converted)) == 2
    nodes = [f for f in left["port"]
             if f.endswith((".bin", ".laz", ".las"))]
    assert nodes  # the nodes below level 1 stay
    assert not any(os.path.basename(f).split(".")[0] in ("r", "0-0-0-0")
                   for f in nodes)


@pytest.mark.parametrize("target", ["3DTILES", "LAS", "LAZ"])
def test_converter_source_projection(tmp_path, target):
    """--source-projection EPSG:32631 (UTM zone 31N, no NTv2 grid): the
    converted points on the WGS84 ellipsoid, as tests/test_srs.py's tiler
    case puts them."""
    from schwarzwald_tpu.core.aabb import AABB
    from schwarzwald_tpu.core.pointbuffer import PointBuffer

    rng = np.random.default_rng(8)
    n = 3000
    pos = np.column_stack([rng.uniform(447000, 449000, n),
                           rng.uniform(5411000, 5413000, n),
                           rng.uniform(0, 50, n)])
    src = tmp_path / "utm.las"
    las.write_las(str(src), PointBuffer(pos),
                  AABB([447000, 5411000, 0], [449000, 5413000, 50]))
    tiled = tmp_path / "tiled"
    assert jax_cli(["--tiler", "-i", str(src), "-o", str(tiled),
                    "--output-format", "BIN", "--sampling", "RANDOM_GRID",
                    "--spacing", "20"]) == 0
    outs = convert_both(tmp_path, tiled, target,
                        extra=("--source-projection", "EPSG:32631"))
    if target == "3DTILES":
        buf, rtc = read_pnts(str(outs["port"] / "r.pnts"))
        pts = buf.positions + rtc
    else:
        pts = las.read_las(str(outs["port"] / f"r.{target.lower()}")
                           ).positions
    radii = np.linalg.norm(pts, axis=1)
    assert np.all((radii > 6.3e6) & (radii < 6.45e6))


@pytest.mark.parametrize("target", ["3DTILES", "LAZ"])
def test_convert_api(tmp_path, target):
    """convert(source, output, output_format, **options) in both
    packages, with converter options passed through."""
    tiled = tile(tmp_path, "LAS", n=6000, seed=9,
                 extra=("--max-points-per-node", "1000"))
    outs = {}
    for name, pkg in (("jax", schwarzwald_tpu),
                      ("port", schwarzwald_tpu_torch)):
        outs[name] = tmp_path / f"api_{name}"
        pkg.convert(str(tiled), str(outs[name]), output_format=target,
                    max_depth=1)
    assert_same_tree(outs["jax"], outs["port"])


def test_converter_empties_its_output_folder(tmp_path):
    """The output folder is emptied first, as the JAX converter does."""
    tiled = tile(tmp_path, "BIN")
    out = tmp_path / "conv"
    (out / "stale").mkdir(parents=True)
    (out / "stale.pnts").write_bytes(b"old")
    assert port_cli(["--converter", "-i", str(tiled), "-o", str(out),
                     "--output-format", "LAS"]) == 0
    assert sorted(os.listdir(out)) == sorted(
        f[:-4] + ".las" for f in os.listdir(tiled) if f.endswith(".bin"))
