"""The port's tiler in every output format against the JAX package, end to
end on the CPU: one LAS input (RGB, intensity and classification on every
point) tiled by the JAX CLI (its default, the native host run) and by the
port's CLI with `--use-device host` and `--use-device cpu` (the kernels'
plain-torch versions), under the default sampler MIN_DISTANCE and under
RANDOM_GRID, in each of the 7 formats. The trees must be equal byte for
byte (tolerance 0), file by file: every node file (.pnts, .bin, .binz,
.las, .laz, ept-data/*), every tileset and EPT hierarchy .json and
ept.json. The only fields that depend on the clock are properties.json's
two timing fields (performance_stats.prepare_duration and
indexing_duration), which are left out of the comparison; ept.json, the
hierarchy files and the LAS/LAZ headers carry no date or time."""
import json
import os

import numpy as np
import pytest
import torch

import schwarzwald_tpu  # noqa: F401  (the reference; enables jax x64)
from schwarzwald_tpu.cli import main as jax_cli
from schwarzwald_tpu_torch.cli import main as port_cli
from schwarzwald_tpu_torch.ops import poisson_cuda

torch.set_num_threads(1)

FORMATS = ("3DTILES", "BIN", "BINZ", "LAS", "LAZ", "ENTWINE_LAS",
           "ENTWINE_LAZ")
NODE_FILES = (".pnts", ".bin", ".binz", ".las", ".laz")
# the timing fields of properties.json (PERF.md §2)
CLOCK_FIELDS = ("prepare_duration", "indexing_duration")


def write_attributed_las(path, n, seed, extent=100.0):
    """n uniform points in a cube of `extent` with RGB, intensity and
    classification, written by the JAX package's LAS writer."""
    from schwarzwald_tpu.core.aabb import AABB
    from schwarzwald_tpu.core.attributes import PointAttribute as A
    from schwarzwald_tpu.core.pointbuffer import PointBuffer
    from schwarzwald_tpu.io import las

    rng = np.random.default_rng(seed)
    buf = PointBuffer(rng.uniform(1.0, extent - 1.0, (n, 3)))
    buf.set_column(A.RGB, rng.integers(0, 255, (n, 3), dtype=np.uint8))
    buf.set_column(A.Intensity, rng.integers(0, 65535, n, dtype=np.uint16))
    buf.set_column(A.Classification, rng.integers(0, 10, n, dtype=np.uint8))
    las.write_las(str(path), buf, AABB([0.0] * 3, [extent] * 3))


def tree(root) -> dict:
    """{relative path: bytes} of an output tree; properties.json as its
    document without the clock fields."""
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            full = os.path.join(d, f)
            with open(full, "rb") as fh:
                data = fh.read()
            rel = os.path.relpath(full, root)
            if rel == "properties.json":
                data = json.loads(data)
                for field in CLOCK_FIELDS:
                    data["performance_stats"].pop(field)
            out[rel] = data
    return out


def assert_same_tree(a, b) -> int:
    """Byte-compare two trees (properties.json up to its clock fields);
    returns the number of node files, which must be positive."""
    ta, tb = tree(a), tree(b)
    assert sorted(ta) == sorted(tb)
    for rel in ta:
        assert ta[rel] == tb[rel], rel
    nodes = sum(rel.endswith(NODE_FILES) for rel in ta)
    assert nodes > 0
    return nodes


# 15,000 points, at most 2,000 per node: a tree four levels deep, whose
# finalize pass samples ranges of more than 4,096 points (the device
# Poisson path's floor)
ARGS = ["--max-points-per-node", "2000"]


@pytest.fixture(scope="module")
def jax_trees(tmp_path_factory):
    """The JAX package's tree of one (format, sampler), made once."""
    root = tmp_path_factory.mktemp("sinks")
    src = root / "in.las"
    write_attributed_las(src, 15_000, 20261016)
    made = {}

    def get(fmt, sampler):
        if (fmt, sampler) not in made:
            out = root / f"jax_{fmt}_{sampler}"
            assert jax_cli(["--tiler", "-i", str(src), "-o", str(out),
                            "--output-format", fmt, "--sampling", sampler]
                           + ARGS) == 0
            made[fmt, sampler] = out
        return src, made[fmt, sampler]

    return get


@pytest.mark.parametrize("sampler", ["MIN_DISTANCE", "RANDOM_GRID"])
@pytest.mark.parametrize("use_device", ["host", "cpu"])
@pytest.mark.parametrize("fmt", FORMATS)
def test_port_writes_the_jax_tree(jax_trees, tmp_path, fmt, use_device,
                                  sampler):
    src, want = jax_trees(fmt, sampler)
    out = tmp_path / "port"
    poisson_cuda.reset_counters()
    assert port_cli(["--tiler", "-i", str(src), "-o", str(out),
                     "--output-format", fmt, "--sampling", sampler,
                     "--use-device", use_device] + ARGS) == 0
    counts = poisson_cuda.snapshot()
    assert counts["launches"] == 0
    if sampler == "MIN_DISTANCE":
        # the cpu run sent its large ranges through the plain-torch
        # version of the Poisson kernel, the host run none
        assert (counts["plain"] > 0) == (use_device == "cpu"), counts
    assert assert_same_tree(want, out) > 1
    if fmt.startswith("ENTWINE"):
        ept = json.load(open(out / "ept.json"))
        assert ept["points"] == 15_000
        assert ept["dataType"] == ("laszip" if fmt == "ENTWINE_LAZ"
                                   else "las")
