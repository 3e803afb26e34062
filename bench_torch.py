#!/usr/bin/env python3
"""Benchmark of the PyTorch + CUDA port (schwarzwald_tpu_torch): one cell of
BENCHMARK.json per command.

    python3 bench_torch.py --cell md_10M_terrain_3dtiles --seed 7
    python3 bench_torch.py --cell md_10M_terrain_3dtiles --rehearse

A cell is one tiler configuration (`config`) under one input (`traffic`).
Run from the root of a checkout on a machine with the cell's number of CUDA
cards (`chips`), nvcc and g++. Steps, in order:

  1. the kernels built (nvcc, g++: `build_s`); set-up (`setup_s`): the
     input drawn from --seed with numpy.random.default_rng (an airborne
     scan of a terrain, `draw_points`) and written through the port's
     io.las (io.laz for LAZ) writer, full LAS point records (format 3);
     the files' sha256 checked against the cell's reference manifest; then
     every file read back through io.las: the LAS/LAZ read and write rates;
  2. the baseline run, a reading only: the CLI on the host (--use-device
     host), or for a --multichip cell the one-card run at start level 3;
  3. the traced run (never timed): the CLI's TilerProcess in a fresh process
     under torch.profiler (CPU and CUDA), with K2's per-range trace
     (ops/poisson_cuda.trace) and the port's util/trace.py spans on: the
     per-layer metrics, the device idle share and the breakdown (the device
     operations that took the most time and the longest idle gaps, each named
     by the spans open on the host at that moment);
  4. the warm-up and the timed runs: `python -m schwarzwald_tpu_torch.cli
     --tiler ...` in a fresh process each, as a user runs it; the rate is the
     points read over the process's wall seconds; none after a failed run;
  5. kernel K2 alone, timed with CUDA events, where the cell names it.

Every run's tree is held against the cell's reference manifest,
benchmark_torch/<cell>.json: the sha256 of each file of the tree that the
JAX package's CLI wrote on the host from the same input
(benchmark_torch/make_reference.py), properties.json without its two timing
fields. Every metric is printed by name with its unit; the last line of
standard output is one JSON object. A run that exits non-zero or writes
another tree counts as failed; any failure, a kernel that does not build or
launch, or no card, exits non-zero. There is no fallback to the CPU:
--rehearse runs the cell on the CPU (--use-device cpu, about 20,000 points,
against benchmark_torch/<cell>.rehearse.json) to check the steps, and
reports its numbers under "rehearsal", never under "metrics".

    python3 bench_torch.py tile-once --result R.json [--profile T.json]
        [--fixed-start-level L] -- <cli arguments>

is the traced run and the one-card baseline run (steps 2 and 3).
"""
from __future__ import annotations

import argparse
import bisect
import hashlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

from chip_smoke import event_ms

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCHMARK = os.path.join(ROOT, "BENCHMARK.json")
MANIFESTS = os.path.join(ROOT, "benchmark_torch")
WORK = os.path.join(ROOT, ".bench_torch_work")
REHEARSE_POINTS = 20_000     # points of a rehearsal cell, over all its files
REHEARSE_NODE = 2_000        # --max-points-per-node of a rehearsal
RUN_TIMEOUT_S = 1200
NOT_MEASURED = "not measured (no card)"
TIMING_FIELDS = ("prepare_duration", "indexing_duration")

# the trace's device operations, the window marker and the host spans
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_CAT = "trace_span"
WINDOW = "bench_torch.run"


def fail(msg: str) -> int:
    print(f"bench_torch: FAIL: {msg}", file=sys.stderr, flush=True)
    return 1


def load_benchmark() -> dict:
    with open(BENCHMARK) as f:
        return json.load(f)


def cell_metrics(bench: dict, name: str) -> list:
    """The metrics BENCHMARK.json names for a cell: every end-to-end metric
    and the per-layer metrics whose `workloads` list the cell."""
    return (list(bench["metrics"]["end_to_end"])
            + [m for m in bench["metrics"]["per_layer"]
               if name in m["workloads"]])


# -- the input: an airborne scan of a terrain --------------------------------
#
# The pulse density is the traffic's (`density_per_m2`); the input is
# `tiles` square tiles of side sqrt(points per tile / density) side by side
# along x, over `files` files. The shapes on the ground are assumptions of
# this model, listed in BENCHMARK.json's `traffic_model`:
RELIEF_M = 120.0          # ground: 16 Gaussian hills and hollows on 300 m
                          # (relief scaled down on a span under 1 km)
HILLS = 16
WOODS = 24                # woodland: where a second such field is positive
BUILDING_CELL_M = 40.0    # at most one flat-roofed building per 40 m cell,
BUILDING_SHARE = 0.3      # in 30% of the cells outside woodland
TREE_CELL_M = 8.0         # at most one tree per 8 m cell: in 90% of the
TREE_SHARE = (0.9, 0.03)  # cells in woodland, 3% outside
SWATH_M = 600.0           # flight lines along x, 600 m swaths from 1,000 m
FLYING_HEIGHT_M = 1000.0
PULSE_S = 2e-6            # 500 kHz: the GPS time step between points


def _field(bumps, x, y):
    """Sum of Gaussian bumps (centres, sigmas, heights) at (x, y)."""
    import numpy as np

    out = np.zeros(np.shape(x))
    for cx, cy, s, a in zip(*bumps):
        out += a * np.exp(-((x - cx) ** 2 + (y - cy) ** 2) / (2.0 * s * s))
    return out


def landscape(rng, span_x: float, span_y: float) -> dict:
    """The ground and what stands on it, over the whole dataset (each file
    is one tile of it): the height field, the woodland field, the
    buildings on a BUILDING_CELL_M lattice and the trees on a TREE_CELL_M
    lattice (each inside its cell, so a point looks up its own cell only)."""
    import numpy as np

    scale = max(span_x, span_y)
    relief = RELIEF_M * min(1.0, scale / 1000.0)
    land = {"ground": (rng.uniform(0, span_x, HILLS),
                       rng.uniform(0, span_y, HILLS),
                       rng.uniform(0.1, 0.4, HILLS) * scale,
                       rng.uniform(-0.5, 1.0, HILLS) * relief),
            "woods": (rng.uniform(0, span_x, WOODS),
                      rng.uniform(0, span_y, WOODS),
                      rng.uniform(0.05, 0.2, WOODS) * scale,
                      rng.choice(np.array([-1.0, 1.0]), WOODS))}
    for kind, cell in (("building", BUILDING_CELL_M), ("tree", TREE_CELL_M)):
        shape = (math.ceil(span_x / cell), math.ceil(span_y / cell))
        cx = (np.arange(shape[0])[:, None] + 0.5) * cell + np.zeros(shape)
        cy = (np.arange(shape[1])[None, :] + 0.5) * cell + np.zeros(shape)
        wooded = _field(land["woods"], cx, cy) > 0
        u = rng.random(shape)
        if kind == "building":
            size = rng.uniform(8.0, 30.0, (2,) + shape)   # x and y sides
            cx = cx + (rng.random(shape) - 0.5) * (cell - size[0])
            cy = cy + (rng.random(shape) - 0.5) * (cell - size[1])
            top = 300.0 + _field(land["ground"], cx, cy) + rng.uniform(
                4.0, 15.0, shape)
            land[kind] = dict(present=~wooded & (u < BUILDING_SHARE),
                              cx=cx, cy=cy, hx=size[0] / 2, hy=size[1] / 2,
                              top=top)
        else:
            cx = cx + rng.uniform(-0.5, 0.5, shape)
            cy = cy + rng.uniform(-0.5, 0.5, shape)
            land[kind] = dict(
                present=u < np.where(wooded, *TREE_SHARE),
                cx=cx, cy=cy, r=rng.uniform(1.5, 3.5, shape),
                height=rng.uniform(6.0, 30.0, shape))
    return land


def draw_points(rng, land: dict, n: int, x0: float, side: float,
                first_index: int = 0):
    """A PointBuffer of n full-width LAS points (format 3) of the tile
    [x0, x0 + side] x [0, side], in acquisition order: pulses uniform over
    the tile; a pulse inside a building's footprint is a roof return
    (class 6), under a tree's crown one of 1-4 returns (high, medium or low
    vegetation by its height above the ground, 5 / 4 / 3; a quarter reach
    the ground, 2), elsewhere the ground (2; 8% grass, 3; 1% unclassified,
    1). Flight lines run along x in SWATH_M swaths, alternating direction:
    scan angle, edge of flight line and point source id follow the swath,
    GPS time the order."""
    import numpy as np

    from schwarzwald_tpu_torch.core.attributes import PointAttribute as A
    from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer

    x = x0 + rng.uniform(0.0, side, n)
    y = rng.uniform(0.0, side, n)
    ground = 300.0 + _field(land["ground"], x, y)
    z = ground + rng.normal(0.0, 0.02, n)
    cls = np.full(n, 2, dtype=np.uint8)
    returns = np.ones(n, dtype=np.uint8)
    number = np.ones(n, dtype=np.uint8)

    def lookup(kind, cell):
        f = land[kind]
        i = np.minimum((x // cell).astype(np.int64), f["present"].shape[0] - 1)
        j = np.minimum((y // cell).astype(np.int64), f["present"].shape[1] - 1)
        return f, i, j

    b, i, j = lookup("building", BUILDING_CELL_M)
    roof = (b["present"][i, j] & (np.abs(x - b["cx"][i, j]) <= b["hx"][i, j])
            & (np.abs(y - b["cy"][i, j]) <= b["hy"][i, j]))
    z[roof] = b["top"][i[roof], j[roof]] + rng.normal(0.0, 0.02,
                                                       int(roof.sum()))
    cls[roof] = 6
    t, i, j = lookup("tree", TREE_CELL_M)
    crown = (~roof & t["present"][i, j] & ((x - t["cx"][i, j]) ** 2
                                           + (y - t["cy"][i, j]) ** 2
                                           < t["r"][i, j] ** 2))
    m = int(crown.sum())
    k = rng.integers(1, 5, m).astype(np.uint8)
    r = (1 + rng.random(m) * k).astype(np.uint8)
    reach = rng.random(m) < 0.25
    above = np.where(reach, 0.0, t["height"][i[crown], j[crown]]
                     * (1.0 - rng.random(m) ** 3))
    returns[crown], number[crown] = k, np.where(reach, k, r)
    z[crown] = ground[crown] + above
    cls[crown] = np.select([reach, above >= 2.0, above >= 0.5],
                           [2, 5, 4], 3).astype(np.uint8)
    u = np.where(roof | crown, 1.0, rng.random(n))
    grass, other = u < 0.08, (u >= 0.08) & (u < 0.09)
    z[grass] = ground[grass] + rng.uniform(0.05, 0.5, int(grass.sum()))
    cls[grass] = 3
    z[other] = ground[other] + rng.uniform(0.0, 5.0, int(other.sum()))
    cls[other] = 1

    strip = (y // SWATH_M).astype(np.int64)
    order = np.lexsort((np.where(strip % 2 == 0, x, -x), strip))
    x, y, z, cls, strip = x[order], y[order], z[order], cls[order], \
        strip[order]
    returns, number = returns[order], number[order]
    across = y - (strip + 0.5) * SWATH_M
    return PointBuffer(np.stack([x, y, z], axis=1), columns={
        A.Intensity: rng.integers(0, 1 << 16, n, dtype=np.uint16),
        A.NumberOfReturns: returns,
        A.ReturnNumber: number,
        A.ScanDirectionFlag: rng.integers(0, 2, n, dtype=np.uint8),
        A.EdgeOfFlightLine: (np.abs(across) > SWATH_M / 2 - 0.5).astype(
            np.uint8),
        A.Classification: cls,
        A.ScanAngleRank: np.rint(np.degrees(np.arctan(
            across / FLYING_HEIGHT_M))).astype(np.int8),
        A.UserData: np.zeros(n, dtype=np.uint8),
        A.PointSourceID: (strip + 1).astype(np.uint16),
        A.GPSTime: 3.0e8 + (first_index + np.arange(n)) * PULSE_S,
        A.RGB: rng.integers(0, 256, (n, 3), dtype=np.uint8),
    })


def points_per_file(traffic: dict, rehearse: bool) -> int:
    files = int(traffic["files"])
    if rehearse:  # whole thousands, so the scaled read size divides a file
        return REHEARSE_POINTS // files // 1000 * 1000
    return int(traffic["points"]) // files


def tile_points(traffic: dict, rehearse: bool) -> int:
    """Points of one tile: a file holds `tiles` / `files` tiles."""
    per_file = int(traffic.get("tiles", traffic["files"])) // int(
        traffic["files"])
    return points_per_file(traffic, rehearse) // per_file


def tile_side(traffic: dict, rehearse: bool) -> float:
    """The side in metres of one square tile at the traffic's pulse
    density."""
    return math.sqrt(tile_points(traffic, rehearse)
                     / float(traffic["density_per_m2"]))


def write_inputs(traffic: dict, seed: int, directory: str,
                 rehearse: bool = False) -> tuple:
    """Draw the cell's input from `seed` and write it through the port's
    io.las / io.laz writer into `directory`: `tiles` square tiles side by
    side along x, in that order over `files` files, each file's header
    bounds those of its points. Returns (paths, points, seconds spent in
    the writer)."""
    import numpy as np

    from schwarzwald_tpu_torch.core.aabb import AABB
    from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer
    from schwarzwald_tpu_torch.io import las

    os.makedirs(directory, exist_ok=True)
    rng = np.random.default_rng(seed)
    files = int(traffic["files"])
    tiles = int(traffic.get("tiles", files))
    n, side = tile_points(traffic, rehearse), tile_side(traffic, rehearse)
    land = landscape(rng, tiles * side, side)
    compressed = traffic["format"] == "LAZ"
    paths, write_s = [], 0.0
    for i in range(files):
        per_file = tiles // files
        buf = PointBuffer.concatenate([
            draw_points(rng, land, n, t * side, side, first_index=t * n)
            for t in range(i * per_file, (i + 1) * per_file)])
        path = os.path.join(directory,
                            f"part{i}.{'laz' if compressed else 'las'}")
        t0 = time.perf_counter()
        las.write_las(path, buf, AABB(buf.positions.min(axis=0),
                                      buf.positions.max(axis=0)),
                      compressed=compressed)
        write_s += time.perf_counter() - t0
        paths.append(path)
        del buf
    return paths, n * tiles, write_s


def read_inputs(paths: list) -> float:
    """Seconds to read every input file whole through io.las."""
    from schwarzwald_tpu_torch.io import las

    t0 = time.perf_counter()
    for path in paths:
        las.read_las(path)
    return time.perf_counter() - t0


# -- the reference: a manifest of the JAX package's tree ---------------------

def manifest_path(cell: str, rehearse: bool) -> str:
    return os.path.join(MANIFESTS,
                        f"{cell}{'.rehearse' if rehearse else ''}.json")


def file_digest(path: str) -> str:
    """sha256 of a file; of properties.json without its two timing fields
    (the rest as sorted JSON)."""
    h = hashlib.sha256()
    if os.path.basename(path) == "properties.json":
        with open(path) as f:
            doc = json.load(f)
        for key in TIMING_FIELDS:
            doc["performance_stats"].pop(key)
        h.update(json.dumps(doc, sort_keys=True).encode())
    else:
        with open(path, "rb") as f:
            for chunk in iter(lambda: f.read(1 << 22), b""):
                h.update(chunk)
    return h.hexdigest()


def tree_digests(root: str) -> dict:
    """{path relative to root, '/'-separated: file_digest} of a tree."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            full = os.path.join(d, name)
            out[os.path.relpath(full, root).replace(os.sep, "/")] = \
                file_digest(full)
    return dict(sorted(out.items()))


def compare_tree(root: str, want: dict) -> int:
    """Hold the tree under `root` against a manifest's digests: raises
    RuntimeError naming the files that are missing, extra or differ;
    returns the number of files."""
    got = tree_digests(root)
    if set(got) != set(want):
        raise RuntimeError(f"the tree differs in files: "
                           f"{sorted(set(got) ^ set(want))[:10]}")
    bad = [rel for rel in got if got[rel] != want[rel]]
    if bad:
        raise RuntimeError(f"{len(bad)} of {len(got)} files differ: "
                           f"{bad[:10]}")
    return len(got)


def load_manifest(cell: str, seed: int, rehearse: bool) -> dict:
    path = manifest_path(cell, rehearse)
    if not os.path.exists(path):
        raise RuntimeError(f"no reference manifest {path}: make it with "
                           f"benchmark_torch/make_reference.py")
    with open(path) as f:
        manifest = json.load(f)
    if manifest["seed"] != seed:
        raise RuntimeError(f"{path} holds the tree of seed "
                           f"{manifest['seed']}, not {seed}")
    return manifest


# -- the kernels' build -------------------------------------------------------

def build_kernels(rehearse: bool) -> tuple:
    """Build what the cell runs: the native host kernels and, on the card,
    csrc/poisson.cu, csrc/morton.cu and csrc/sweep.cu, all at once.
    Returns (seconds, whether any library was built rather than found up
    to date)."""
    from concurrent.futures import ThreadPoolExecutor

    from schwarzwald_tpu_torch import native
    from schwarzwald_tpu_torch.native import loader
    from schwarzwald_tpu_torch.ops import _cuda_build

    t0 = time.perf_counter()
    native_built = not loader.is_fresh(loader._SO, loader._SRCS)
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(native._lib)]
        if not rehearse:
            jobs += [pool.submit(_cuda_build.load_kernel_library, name)
                     for name in ("poisson", "morton", "sweep")]
        if jobs[0].result() is None:
            raise RuntimeError("the native host kernels did not build")
        for job in jobs[1:]:
            job.result()
    built = native_built or any(info["seconds"] > 0 for info
                                in _cuda_build.build_info.values())
    return time.perf_counter() - t0, built


# -- runs ---------------------------------------------------------------------

CONFIG_FLAGS = {"sampling": "--sampling",
                "tiling_strategy": "--tiling-strategy",
                "output_format": "--output-format",
                "max_points_per_node": "--max-points-per-node",
                "diagonal_fraction": "--spacing-by-diagonal-fraction",
                "internal_cache_size": "--internal-cache-size",
                "batch_read_size": "--batch-read-size",
                "multichip": "--multichip"}


def config_argv(config: dict, traffic: dict, rehearse: bool) -> list:
    """The CLI flags of a cell's configuration. A rehearsal scales the
    cache and read sizes with the points per file, so the cell keeps its
    batches, and takes REHEARSE_NODE points per node."""
    values = {k: config[k] for k in CONFIG_FLAGS if config.get(k)}
    if rehearse:
        ratio = (points_per_file(traffic, True)
                 / points_per_file(traffic, False))
        for key in ("internal_cache_size", "batch_read_size"):
            values[key] = max(1, round(values[key] * ratio))
        values["max_points_per_node"] = REHEARSE_NODE
    argv = []
    for key, value in values.items():
        argv += [CONFIG_FLAGS[key], str(value)]
    return argv


def run_process(cmd: list, log: str) -> tuple:
    """(exit code, wall seconds) of one fresh process, its output in
    `log`."""
    path = os.environ.get("PYTHONPATH")
    env = dict(os.environ, SCHWARZWALD_TPU_NO_UI="1",
               PYTHONPATH=ROOT + (os.pathsep + path if path else ""))
    with open(log, "w") as out:
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            rc = proc.wait(timeout=RUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        return rc, time.perf_counter() - t0


def cli_cmd(argv: list) -> list:
    return [sys.executable, "-m", "schwarzwald_tpu_torch.cli", "--tiler",
            *argv]


def tile_once_cmd(argv: list, result: str, profile: str | None = None,
                  fixed_start_level: int | None = None) -> list:
    cmd = [sys.executable, os.path.abspath(__file__), "tile-once",
           "--result", result]
    if profile:
        cmd += ["--profile", profile]
    if fixed_start_level is not None:
        cmd += ["--fixed-start-level", str(fixed_start_level)]
    return cmd + ["--", *argv]


def tile_seconds(out_dir: str) -> float:
    """TilerProcess.run's own seconds, as the run wrote them into its
    properties.json (prepare and indexing durations, ms)."""
    with open(os.path.join(out_dir, "properties.json")) as f:
        stats = json.load(f)["performance_stats"]
    return sum(stats[key] for key in TIMING_FIELDS) / 1e3


def log_tail(log: str, nbytes: int = 3000) -> str:
    with open(log, errors="replace") as f:
        return f.read()[-nbytes:]


# -- tile-once: the traced run and the one-card baseline ----------------------

def k2_ranges_summary(ranges: list) -> dict:
    """K2's range path summed over the device ranges of `ranges` (records
    of poisson_cuda.trace): stream ms of upload, prep, kernel, download;
    the sending threads' wall ms from a range's start to the end of its
    synchronise."""
    out = {"ranges": len(ranges)}
    for part in ("upload", "prep", "kernel", "download"):
        out[f"{part}_ms"] = sum(r[f"{part}_ms"] for r in ranges)
    out["sender_wall_ms"] = sum((r["t1"] - r["t0"]) * 1e3 for r in ranges)
    return out


def tile_once(argv) -> int:
    """One CLI run in this process: `cli.main` on the arguments after `--`,
    its TilerProcess kept for `device_stats`, the start level pinned with
    --fixed-start-level. With --profile, also K2's range trace, the K2
    launches at the end of each batch and of the finalize (read where the
    util/trace.py spans of the batch and the finalize end), and
    torch.profiler over the run, with the spans merged into its Chrome
    trace on the profiler's clock. Writes the results to --result."""
    ap = argparse.ArgumentParser(prog="bench_torch.py tile-once")
    ap.add_argument("--result", required=True)
    ap.add_argument("--profile", default=None)
    ap.add_argument("--fixed-start-level", type=int, default=None)
    ap.add_argument("cli", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cli_args = args.cli[1:] if args.cli[:1] == ["--"] else args.cli

    import torch

    from schwarzwald_tpu_torch import cli
    from schwarzwald_tpu_torch.ops import poisson_cuda
    from schwarzwald_tpu_torch.process import tiler_process
    from schwarzwald_tpu_torch.util import trace

    procs = []

    class KeptTilerProcess(tiler_process.TilerProcess):
        def __init__(self, targs):
            if args.fixed_start_level is not None:
                targs.fixed_start_level = args.fixed_start_level
            super().__init__(targs)
            procs.append(self)

    marks = []  # (span name, K2 launches when it ended)

    class BatchTracer(trace.ChromeTracer):
        def complete_event(self, name, start_us, dur_us, track="main",
                           args=None):
            if name in ("index_batch", "finalize_reconstruct_ancestors"):
                marks.append((name, poisson_cuda.snapshot()["launches"]))
            super().complete_event(name, start_us, dur_us, track, args)

    tiler_process.TilerProcess = KeptTilerProcess
    poisson_cuda.reset_counters()
    result = {}
    if args.profile is None:
        rc = cli.main(cli_args)
    else:
        from torch.profiler import ProfilerActivity, profile, record_function

        cuda = torch.cuda.is_available()
        tracer = trace._global_tracer = BatchTracer()
        poisson_cuda.trace = []
        activities = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=activities) as prof:
            with record_function(WINDOW):
                anchor_us = tracer._now_us()
                rc = cli.main(cli_args)
                for d in range(torch.cuda.device_count() if cuda else 0):
                    torch.cuda.synchronize(d)
        ranges, poisson_cuda.trace = poisson_cuda.trace, None
        prof.export_chrome_trace(args.profile)
        with open(args.profile) as f:
            doc = json.load(f)
        merge_spans(doc, tracer._events, anchor_us)
        result.update(k2_path=k2_ranges_summary(ranges),
                      launches_after=marks, breakdown=breakdown(doc))
    result.update(rc=rc, k2=poisson_cuda.snapshot(),
                  device_stats=procs[-1].device_stats if procs else None)
    with open(args.result, "w") as f:
        json.dump(result, f)
    return int(rc or 0)


# -- the breakdown of a traced run --------------------------------------------

def merge_spans(doc: dict, span_events: list, anchor_us: float) -> None:
    """Append the util/trace.py spans (ChromeTracer events on its own
    clock) to a torch.profiler Chrome trace as SPAN_CAT events on the
    profiler's clock: `anchor_us` is the tracer's time read just inside the
    WINDOW annotation, so its start maps to the window's."""
    window = next(e for e in doc["traceEvents"]
                  if e.get("name") == WINDOW and e.get("ph") == "X")
    offset = float(window["ts"]) - anchor_us
    doc["traceEvents"].extend(
        {"ph": "X", "cat": SPAN_CAT, "name": e["name"],
         "ts": e["ts"] + offset, "dur": e["dur"], "pid": "host",
         "tid": e["tid"]}
        for e in span_events if e.get("ph") == "X")


def _union(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _span_at(spans: list):
    """A lookup t -> the names of the spans open at t on any thread, in
    the order they opened, joined by "+" (None when none is open)."""
    edges = sorted({t for s in spans for t in (s[0], s[1])})
    labels, active = [], []
    by_start = sorted(spans)
    k = 0
    for a in edges[:-1]:
        while k < len(by_start) and by_start[k][0] <= a:
            active.append(by_start[k])
            k += 1
        active = [s for s in active if s[1] > a]
        labels.append("+".join(s[2] for s in active) or None)

    def at(t: float):
        i = bisect.bisect_right(edges, t) - 1
        return labels[i] if 0 <= i < len(labels) else None
    return at


def breakdown(doc: dict, top: int = 10, gaps: int = 5) -> dict:
    """Where a traced run's time went on the device, from its Chrome trace:
    the window (the WINDOW annotation, else the span of all events), per
    device the busy time (the union of its kernels, copies and sets) and
    the idle share of the window, their mean as `idle_share`; the summed
    time of each host span (`span_ms`, threads overlapping); the device
    operations with the most summed time, grouped by name and by the spans
    open on the host when each began; the longest idle gaps of the first
    device, each with the spans open at its middle. `measured` is False,
    and `idle_share` None, when the trace holds no device operation."""
    events = [e for e in doc.get("traceEvents", []) if e.get("ph") == "X"]
    window = next((e for e in events if e.get("name") == WINDOW), None)
    if window is not None:
        w0, w1 = float(window["ts"]), float(window["ts"] + window["dur"])
    else:
        w0 = min(float(e["ts"]) for e in events)
        w1 = max(float(e["ts"] + e["dur"]) for e in events)
    spans = [(float(e["ts"]), float(e["ts"] + e["dur"]), e["name"])
             for e in events if e.get("cat") == SPAN_CAT]
    span_ms = {}
    for a, b, name in spans:
        span_ms[name] = span_ms.get(name, 0.0) + (b - a) / 1e3
    out = {"measured": False, "window_ms": (w1 - w0) / 1e3,
           "idle_share": None,
           "span_ms": dict(sorted(span_ms.items(), key=lambda kv: -kv[1]))}
    device_ops = [e for e in events if e.get("cat") in DEVICE_CATS]
    if not device_ops:
        return out
    span_at = _span_at(spans)
    per_device = {}
    for e in device_ops:
        dev = (e.get("args") or {}).get("device", e.get("pid"))
        a = max(w0, float(e["ts"]))
        b = min(w1, float(e["ts"] + e["dur"]))
        if b > a:
            per_device.setdefault(str(dev), []).append((a, b))
    devices = {}
    for dev, intervals in sorted(per_device.items()):
        busy = sum(b - a for a, b in _union(intervals))
        devices[dev] = {"busy_ms": busy / 1e3,
                        "idle_share": 1.0 - busy / (w1 - w0)}
    ops = {}
    for e in device_ops:
        key = (e["name"], span_at(float(e["ts"])))
        ms, count = ops.get(key, (0.0, 0))
        ops[key] = (ms + float(e["dur"]) / 1e3, count + 1)
    first = _union(per_device[min(per_device)]) if per_device else []
    idle = [(a, b) for a, b in zip([w0] + [b for _, b in first],
                                   [a for a, _ in first] + [w1]) if b > a]
    idle.sort(key=lambda g: g[0] - g[1])
    out.update(
        measured=True, devices=devices,
        idle_share=(sum(d["idle_share"] for d in devices.values())
                    / len(devices)) if devices else 1.0,
        top_ops=[{"name": name[:160], "span": span, "ms": ms, "count": n}
                 for (name, span), (ms, n) in sorted(
                     ops.items(), key=lambda kv: -kv[1][0])[:top]],
        idle_gaps=[{"start_ms": (a - w0) / 1e3, "ms": (b - a) / 1e3,
                    "span": span_at((a + b) / 2)} for a, b in idle[:gaps]])
    return out


# -- kernel K2 alone ----------------------------------------------------------

K2_CASES = {"k2_ms_uniform_262144": "uniform_262144",
            "k2_ms_root": "root_5490148"}


def k2_alone(names: set) -> dict:
    """Kernel K2 alone on the card in f64, timed with CUDA events
    (chip_smoke.event_ms), at the named cases of
    ops/sanitize_kernels.poisson_cases."""
    import torch

    from schwarzwald_tpu_torch.ops import poisson_cuda
    from schwarzwald_tpu_torch.ops.sanitize_kernels import poisson_cases

    out = {}
    cases = {K2_CASES[k]: k for k in names}
    for case, pos, spacing, analyze, _, _ in poisson_cases(set(cases)):
        p = poisson_cuda.prep(pos, spacing, analyze, "f64")
        if p is None:
            raise RuntimeError(f"{case}: prep declined the range")
        planes, ptr, bj = (torch.from_numpy(a).cuda()
                           for a in (p.planes, p.pair_ptr, p.pair_bj))
        out[cases[case]] = event_ms(lambda: poisson_cuda.accept_mask_cuda(
            planes, None, p.sq, ptr, bj),
            launches=3 if case.startswith("root") else 10)[1]
        del planes, ptr, bj
    torch.cuda.empty_cache()
    return out


# -- one cell -----------------------------------------------------------------

def quartiles(values: list) -> tuple:
    import numpy as np

    q1, med, q3 = np.percentile(values, [25, 50, 75])
    return float(q1), float(med), float(q3)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def measure(cell: dict, wanted: set, args, work: str) -> tuple:
    """Run one cell's steps; returns (values by metric name, the runs, the
    breakdown of the traced run)."""
    rehearse = args.rehearse
    traffic, config = cell["traffic"], cell["config"]
    use_device = "cpu" if rehearse else "cuda"
    manifest = load_manifest(cell["name"], args.seed, rehearse)
    values = {}

    values["build_s"], built = build_kernels(rehearse)
    t0 = time.perf_counter()
    paths, points, write_s = write_inputs(traffic, args.seed,
                                          os.path.join(work, "input"),
                                          rehearse)
    values["setup_s"] = time.perf_counter() - t0
    drawn = {os.path.basename(p): file_digest(p) for p in paths}
    if drawn != manifest["input"]:
        raise RuntimeError(f"the input drawn from seed {args.seed} is not "
                           f"the reference's: {drawn} against "
                           f"{manifest['input']}")
    read_s = read_inputs(paths)
    kind = "laz" if traffic["format"] == "LAZ" else "las"
    values[f"{kind}_write_points_per_s"] = points / write_s
    values[f"{kind}_read_points_per_s"] = points / read_s
    state = "built" if built else "up to date"
    print(f"build {values['build_s']:.3f} s ({state}); set-up: {points} "
          f"points in {len(paths)} {traffic['format']} file(s), drawn and "
          f"written in "
          f"{values['setup_s']:.3f} s (the writer {write_s:.3f} s, read back "
          f"in {read_s:.3f} s), equal to the reference's input", flush=True)

    src = paths[0] if len(paths) == 1 else os.path.dirname(paths[0])
    out_dir = os.path.join(work, "out")
    flags = config_argv(config, traffic, rehearse)
    logs = os.path.join(work, "logs")
    os.makedirs(logs)
    runs = []

    def record(kind: str, cmd: list, log: str) -> bool:
        shutil.rmtree(out_dir, ignore_errors=True)
        rc, seconds = run_process(cmd, log)
        tile_s, tree = None, None
        if rc == 0:
            tile_s = tile_seconds(out_dir)
            try:
                tree = (f"identical ({compare_tree(out_dir, manifest['tree'])}"
                        f" files)")
            except RuntimeError as exc:
                tree = f"differs: {exc}"
        ok = rc == 0 and tree.startswith("identical")
        runs.append({"kind": kind, "rc": rc, "seconds": seconds,
                     "tile_s": tile_s, "points_per_s": points / seconds,
                     "tree": tree, "ok": ok})
        print(f"run {kind}: exit {rc}, {seconds:.3f} s ({tile_s} s in "
              f"TilerProcess.run), {points / seconds:.1f} points/s; tree "
              f"{tree}", flush=True)
        if not ok:
            print(log_tail(log), flush=True)
        return ok

    # the baseline, a reading only
    log = os.path.join(logs, "baseline.log")
    if cell["baseline"] == "host":
        record("baseline", cli_cmd(["-i", src, "-o", out_dir, *flags,
                                    "--use-device", "host"]), log)
        name = "host_points_per_s"
    else:
        single = list(flags)
        if "--multichip" in single:
            i = single.index("--multichip")
            del single[i:i + 2]
        record("baseline", tile_once_cmd(
            ["--tiler", "-i", src, "-o", out_dir, *single, "--use-device",
             use_device], os.path.join(work, "baseline.json"),
            fixed_start_level=3), log)
        name = "one_card_points_per_s"
    if runs[-1]["rc"] != 0:
        raise RuntimeError(f"the baseline run exited {runs[-1]['rc']}: "
                           f"{log_tail(log)}")
    values[name] = runs[-1]["points_per_s"]
    values["baseline_tile_points_per_s"] = points / runs[-1]["tile_s"]

    # the traced run
    result_path = os.path.join(work, "traced.json")
    ok = record("traced", tile_once_cmd(
        ["--tiler", "-i", src, "-o", out_dir, *flags, "--use-device",
         use_device], result_path, profile=os.path.join(work, "trace.json")),
        os.path.join(logs, "traced.log"))
    traced = {}
    if runs[-1]["rc"] == 0:
        with open(result_path) as f:
            traced = json.load(f)

    # the warm-up and the timed runs, up to the first that fails (the cell
    # has failed then)
    warmups, timed_runs = (0, 1) if rehearse else (cell["warmups"],
                                                  cell["runs"])
    for i in range(warmups + timed_runs):
        if not ok:
            break
        ok = record("warm-up" if i < warmups else "timed", cli_cmd(
            ["-i", src, "-o", out_dir, *flags, "--use-device", use_device]),
            os.path.join(logs, f"run{i}.log"))
    timed = [r for r in runs if r["kind"] == "timed" and r["ok"]]

    attempted = [r for r in runs if r["kind"] != "baseline"]
    values["failure_share"] = (sum(not r["ok"] for r in attempted)
                               / len(attempted))
    if timed:
        q1, med, q3 = quartiles([r["points_per_s"] for r in timed])
        values.update(tiler_points_per_s=med, tiler_points_per_s_q1=q1,
                      tiler_points_per_s_q3=q3)
        values["tile_points_per_s"] = quartiles(
            [points / r["tile_s"] for r in timed])[1]
        values["process_overhead_s"] = quartiles(
            [r["seconds"] - r["tile_s"] for r in timed])[1]
    values["tiler_runs"] = len(timed)
    values.update(traced_metrics(traced, rehearse))
    kernels = wanted & set(K2_CASES)
    if kernels:
        values.update({k: NOT_MEASURED for k in kernels} if rehearse
                      else k2_alone(kernels))
    return values, runs, traced.get("breakdown")


def traced_metrics(traced: dict, rehearse: bool) -> dict:
    """The per-layer metrics read from the traced run's results."""
    if not traced:
        return {}
    stats = traced.get("device_stats") or {}
    out = {"k2_launches": traced["k2"]["launches"],
           "device_sweeps_ok": stats.get("device_sweeps_ok"),
           "device_reroots": stats.get("device_reroots")}
    if "exchange_s" in stats:
        out["exchange_ms_per_batch"] = [s * 1e3 for s in stats["exchange_s"]]
    path = traced["k2_path"]
    out["k2_ranges"] = path["ranges"]
    for key in ("upload_ms", "prep_ms", "kernel_ms", "download_ms",
                "sender_wall_ms"):
        out[f"k2_{key}"] = (NOT_MEASURED if rehearse and not path["ranges"]
                            else path[key])
    before, per_batch = 0, []
    for name, launches in traced["launches_after"]:
        if name == "index_batch":
            per_batch.append(launches - before)
        else:
            out["k2_launches_at_finalize"] = launches - before
        before = launches
    out["k2_launches_per_batch"] = per_batch
    b = traced["breakdown"]
    out["device_idle_share"] = (b["idle_share"] if b["measured"] else
                                "not measured (no device operation in the "
                                "trace)")
    return out


def run_cell(args) -> int:
    bench = load_benchmark()
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.cell not in cells:
        return fail(f"no cell {args.cell!r} in BENCHMARK.json (cells: "
                    f"{', '.join(cells)})")
    cell = cells[args.cell]
    import numpy as np
    import torch

    head = {"cell": cell["name"], "seed": args.seed,
            "cpu_count": os.cpu_count(), "torch": torch.__version__,
            "numpy": np.__version__}
    if args.rehearse:
        head["device"] = "cpu"
    else:
        if not torch.cuda.is_available():
            return fail("torch.cuda.is_available() is False: no CUDA card "
                        "(--rehearse runs the cell on the CPU)")
        if torch.cuda.device_count() < cell["chips"]:
            return fail(f"{cell['name']} needs {cell['chips']} cards, "
                        f"{torch.cuda.device_count()} visible")
        head.update(device="cuda", card=nvidia_smi(),
                    kind=torch.cuda.get_device_name(0),
                    count=torch.cuda.device_count())
        print(head["card"], flush=True)  # the card's name and power limit
    print(f"cell {cell['name']}: seed {args.seed}, {os.cpu_count()} CPU "
          f"cores, device {head['device']}, torch {torch.__version__}, "
          f"numpy {np.__version__}", flush=True)
    metrics = cell_metrics(bench, cell["name"])
    wanted = {m["name"] for m in metrics}
    work = args.work
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    t0 = time.perf_counter()
    try:
        values, runs, brk = measure(cell, wanted, args, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    seconds = time.perf_counter() - t0

    units = {m["name"]: m["unit"] for m in metrics}
    label = "rehearsal" if args.rehearse else "metric"
    for m in metrics:
        value = values.get(m["name"])
        print(f"{label} {m['name']}: {value} {m['unit']}", flush=True)
    if "tiler_points_per_s" in values:
        print(f"{label} tiler_points_per_s quartiles: "
              f"{values['tiler_points_per_s_q1']} / "
              f"{values['tiler_points_per_s_q3']} points/s over "
              f"{values['tiler_runs']} timed runs", flush=True)
    if brk:
        print(f"breakdown: {json.dumps(brk)}", flush=True)
    missing = sorted(wanted - set(values))
    ok = all(r["ok"] for r in runs) and values["tiler_runs"] > 0
    result = dict(head, ok=ok and not missing, seconds=seconds, units=units,
                  reference=os.path.relpath(
                      manifest_path(cell["name"], args.rehearse), ROOT),
                  runs=runs)
    result["rehearsal" if args.rehearse else "metrics"] = dict(
        {k: values[k] for k in sorted(wanted) if k in values},
        **{k: values[k] for k in ("tiler_points_per_s_q1",
                                  "tiler_points_per_s_q3", "tiler_runs",
                                  "build_s") if k in values},
        breakdown=brk)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    print(f"cell {cell['name']}: {seconds:.1f} s", flush=True)
    print(json.dumps(result))
    if missing:
        return fail(f"metrics named in BENCHMARK.json not measured: "
                    f"{missing}")
    if not ok:
        return fail(f"{sum(not r['ok'] for r in runs)} of {len(runs)} runs "
                    f"failed")
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["tile-once"]:
        return tile_once(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", required=True,
                    help="a cell (workload) of BENCHMARK.json")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--rehearse", action="store_true",
                    help="run the cell on the CPU (--use-device cpu) at "
                         f"{REHEARSE_POINTS} points, to check the steps")
    ap.add_argument("--work", default=WORK,
                    help="directory for the input and the trees (emptied "
                         "before and removed after)")
    ap.add_argument("--json", default=None,
                    help="also write the result object to this file")
    args = ap.parse_args(argv)
    args.work = os.path.abspath(args.work)
    return run_cell(args)


if __name__ == "__main__":
    sys.exit(main())
