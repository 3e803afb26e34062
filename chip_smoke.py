#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (schwarzwald_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (Hopper,
sm_90a), nvcc and g++. Phases, in order; any failure exits non-zero, and
each phase prints its seconds:

  1. environment: torch, the card, its power limit; build every kernel of
     the port from the checkout's sources, all at once (csrc/poisson.cu and
     csrc/morton.cu with nvcc, the native host kernels with g++);
  2. each kernel against its plain-torch version on the card: K2 (Poisson,
     phase A's close lists and phase B's decisions) on Morton-sorted ranges
     (uniform up to 1.5M points, clustered, duplicates, a ::3 analyze mask,
     a dense range at the pair gate's edge that runs window by window) in
     both precision modes, and the main path's root-shaped range of
     5,490,148 points in f64 (the plain version skipped there for time);
     the pair CSR built on the card against the host's; every f64 mask
     also against the native host kernel; per case the kernel's time with
     phase A and phase B apart, its bounds (bytes, and the close pairs'
     distance tests) and its share of each, and the peak scratch. K1
     (Morton interleave) on 10M and 10,000,001 random coordinates with
     one-hot edge rows, also against the host encode, timed with CUDA
     events. Results must be equal exactly;
  3. the MIN_DISTANCE main path (kernel K2): a 10M-point uniform LAS tiled
     at the defaults (FAST, MIN_DISTANCE, 3D Tiles, 20,000 points per node,
     spacing = diagonal/250) with use_device="cuda" and "host"; the trees
     must be byte-identical (properties.json up to its two timing fields),
     every tile must hold finite positions, the tiles must hold at least
     every input point, and K2 must have been launched. Each device range's
     time is split into upload, prep (AABBs and pair CSR), phase A + B and
     download, each as stream time and as the sending thread's wall and
     CPU time; each worker thread's ranges must have run on one stream of
     its own, and the ranges on more than one stream;
  4. the batch step (kernel K1): 10M uniform float64 positions through
     encode_sort_batch on the card and the host grid coordinates through
     encode_sort_grid, against the host encode + sort + histogram; the
     port's entry() on the card against the CPU; K1 must have been launched;
  5. the grid samplers' main path (the octree sweep): a 10M-point clustered
     LAS (250 Gaussian clusters) tiled with RANDOM_GRID, and a 1M-point one
     (25 clusters) with GRID_CENTER and JITTERED, each with
     use_device="cuda" and on the host; byte-identical trees, device sweeps
     persisted, fresh start nodes above 20,000 points, no re-rooted range,
     and levels assigned at 3 or more depths;
  6. multichip and multihost: dryrun_multichip(4) on the card (K1 once per
     shard, the lossless exchange, a miniature tile against single-device
     FAST); phase 3's 10M uniform cloud tiled with MIN_DISTANCE over 4
     shards (--multichip 4, every shard on the one card) and phase 5's 10M
     clustered cloud with RANDOM_GRID, each byte-identical to the one-card
     run at start level 3, with the exchange's synchronised time per batch,
     the points per shard, K2's launches and device ranges, the sweep time
     per owner; the uniform cloud as two 5M files tiled by two CLI
     processes (--multihost 0 2 and 1 2) sharing the card, and again on the
     host: the two trees byte-identical, .mh-exchange/ gone, every point
     once at and below the start level;
  7. the other sinks and the converter: phase 3's 10M uniform cloud tiled
     into ENTWINE_LAZ (MIN_DISTANCE, K2) and phase 5's 1M clustered cloud
     into BIN, BINZ, LAS, LAZ and ENTWINE_LAS (RANDOM_GRID, the sweep),
     each on the card and on the host, byte for byte (properties.json up
     to its two timing fields; ept.json, the EPT hierarchy and the LAS
     headers hold no clock field); then convert() on the card runs' trees
     and on the host runs' trees, byte for byte: the ENTWINE_LAZ tree to
     3D Tiles, phase 3's 3D Tiles tree to LAZ and to LAS at --max-depth 4,
     with each conversion's points per second;
  8. the summary: one JSON line for the kernels (with each kernel's
     launches on every path that ran it), then the result line.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_PATH_POINTS = 10_000_000   # the reference's default batch
GRID_SMALL_POINTS = 1_000_000   # GRID_CENTER and JITTERED runs
TIMING_CASE = "uniform_262144"  # the K2 row's ms / plain_ms
ROOT_POINTS = 5_490_148         # the 10M main path's root range
ROOT_CASE = f"root_{ROOT_POINTS}"
DENSE_POINTS = 92_160           # 180 blocks at the pair gate's edge
K1_SIZES = (10_000_000, 10_000_001)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    return 1


def synced(fn):
    """(result, milliseconds) of fn with a device synchronise on each side."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def median_ms(fn, reps: int = 3):
    """(last result, median ms of `reps` synced runs after a warm-up)."""
    synced(fn)
    times = []
    for _ in range(reps):
        out, ms = synced(fn)
        times.append(ms)
    return out, sorted(times)[reps // 2]


def event_ms(fn, launches: int = 20, reps: int = 3):
    """(last result, median over `reps` windows of the mean ms per launch)
    of fn, timed with CUDA events around `launches` back-to-back launches,
    after a warm-up: for kernels too short for the host clock."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(launches):
            out = fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / launches)
    return out, sorted(times)[reps // 2]


def sorted_range(pos, extent):
    """Clamp, Morton-encode and sort a cloud with the port's indexing."""
    import numpy as np

    from schwarzwald_tpu_torch.ops import indexing

    keys, clamped = indexing.index_points(pos, np.zeros(3),
                                          np.full(3, extent))
    _, order = indexing.sort_with_keys(keys)
    return clamped[order]


# -- phase 1: build --------------------------------------------------------------

def phase_build() -> None:
    """Build the native host kernels and every CUDA source in parallel."""
    from concurrent.futures import ThreadPoolExecutor

    from schwarzwald_tpu_torch import native
    from schwarzwald_tpu_torch.ops import _cuda_build, morton_cuda, poisson_cuda

    def build_native():
        t0 = time.perf_counter()
        if native._lib() is None:
            raise RuntimeError("native host kernels did not build")
        return time.perf_counter() - t0

    with ThreadPoolExecutor(3) as pool:
        host = pool.submit(build_native)
        cuda = [pool.submit(_cuda_build.load_kernel_library, name)
                for name in ("poisson", "morton")]
        seconds = host.result()
        for f in cuda:
            f.result()
    print(f"build: native host kernels {seconds:.1f} s", flush=True)
    for precision in ("f64", "f32"):
        poisson_cuda._kernel_fns(precision)
    morton_cuda._kernel_fn()
    for name in ("poisson", "morton"):
        info = _cuda_build.build_info[name]
        print(f"build: csrc/{name}.cu {info['seconds']:.1f} s (nvcc "
              f"{' '.join(_cuda_build.NVCC_FLAGS)})", flush=True)
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}", flush=True)


# -- phase 2: kernels against their plain versions ---------------------------------

def poisson_cases():
    """(name, sorted positions, spacing, analyze mask, extent, precision
    modes). The root-shaped range is the 10M main path's largest (the
    root's 5,490,148 points at the root spacing, 1000 * sqrt(3) / 250); the
    dense range sits at the pair gate's edge (87.5 pairs per block, 1.8e9
    close pairs), so the kernels run window by window."""
    import numpy as np

    rng = np.random.default_rng(20260816)
    ext = 64.0
    both = ("f64", "f32")
    cases = []
    for n in (4096, 262_144, 1_500_000):
        pos = sorted_range(rng.uniform(0.0, ext, (n, 3)), ext)
        cases.append((f"uniform_{n}", pos, 2.0, None, ext, both))
    centers = rng.uniform(4.0, ext - 4.0, (64, 3))
    pos = np.concatenate([c + rng.normal(0.0, 0.8, (3000, 3))
                          for c in centers])
    cases.append(("clustered_192000",
                  sorted_range(np.clip(pos, 0.0, ext - 1e-9), ext), 0.6,
                  None, ext, both))
    pos = sorted_range(rng.uniform(0.0, ext, (262_144, 3)), ext)
    pos[5000:6000] = pos[4999]  # a run of exact duplicates
    cases.append(("duplicates_262144", pos, 1.0, None, ext, both))
    pos = sorted_range(rng.uniform(0.0, ext, (262_144, 3)), ext)
    analyze = np.zeros(pos.shape[0], dtype=bool)
    analyze[::3] = True
    cases.append(("analyze3_262144", pos, 2.0, analyze, ext, both))
    pos = sorted_range(rng.uniform(0.0, 10.0, (DENSE_POINTS, 3)), 10.0)
    cases.append((f"dense_{DENSE_POINTS}", pos, 6.0, None, 10.0, both))
    pos = sorted_range(rng.uniform(0.0, 1000.0, (ROOT_POINTS, 3)), 1000.0)
    cases.append((ROOT_CASE, pos, 1000.0 * 3 ** 0.5 / 250, None, 1000.0,
                  ("f64",)))
    return cases


# published peaks of one H100 SXM at 700 W (NVIDIA's data sheet): memory,
# and f64 / f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 34e12, "f32": 67e12}


def poisson_bounds(p, close_pairs: int) -> dict:
    """The least time of one K2 call on these inputs: the bytes (three
    coordinates and the analyze byte in, one mask byte out, per point) over
    the memory rate, and the operations the function cannot avoid on this
    data over the peak rate of the mode: the exact d2 of each of its close
    pairs, 8 operations each. Also the AABB-pair formulation's count (every
    point pair of a listed block pair, j < i within a block), which phase
    A's chunk cull does not all evaluate: shown, not a floor."""
    n, elt = p.n, p.planes.itemsize
    n_bytes = n * (3 * elt + 1 + (p.analyze is not None))
    sizes = [min(p.block, n - b * p.block) for b in range(p.n_blocks)]
    tests = (p.pair_bj.size * p.block * p.block
             + sum(s * (s - 1) // 2 for s in sizes))
    peak = PEAK_FLOPS["f64" if elt == 8 else "f32"]
    byte_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    op_ms = 8 * close_pairs / peak * 1e3
    return {"byte_ms": byte_ms, "op_ms": op_ms,
            "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms > op_ms else "operations",
            "tests": tests, "tests_ms": 8 * tests / peak * 1e3}


def kernel_runs(fn, reps: int = 3):
    """fn(stats) `reps` times after a warm-up, each synchronised: (last
    result, median ms, phase A and B ms and stats of the median run, peak
    scratch bytes of the warm-up)."""
    import torch

    from schwarzwald_tpu_torch.ops import poisson_cuda

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    synced(lambda: fn({}))
    scratch = torch.cuda.max_memory_allocated() - base
    runs = []
    for _ in range(reps):
        stats = {}
        out, ms = synced(lambda: fn(stats))
        runs.append((ms, poisson_cuda.phase_ms(stats), stats))
    ms, phases, stats = sorted(runs, key=lambda r: r[0])[reps // 2]
    return out, ms, phases, stats, scratch


def phase_poisson_kernel(report: dict) -> None:
    """K2 vs its plain version (and vs native in f64) on the card, with
    the pair CSR built on the card against the host's, and phase A and
    phase B each against its plain version on the ranges of up to 262,144
    points."""
    import numpy as np
    import torch

    from schwarzwald_tpu_torch import native
    from schwarzwald_tpu_torch.ops import poisson_cuda

    host_kernel = native.poisson_sample_kernel()
    dev = torch.device("cuda")
    max_err = 0
    for name, pos, spacing, analyze, ext, modes in poisson_cases():
        t0 = time.perf_counter()
        native_mask = host_kernel(pos, np.zeros(3), np.full(3, ext), spacing,
                                  analyze)
        native_s = time.perf_counter() - t0
        for precision in modes:
            p = poisson_cuda.prep(pos, spacing, analyze, precision)
            if p is None:
                raise RuntimeError(f"{name}: prep declined the range")
            planes = torch.from_numpy(p.planes).to(dev)
            ana = (None if p.analyze is None
                   else torch.from_numpy(p.analyze).to(dev))
            ptr, bj = poisson_cuda.pair_csr_torch(
                planes, poisson_cuda.inflation(spacing),
                poisson_cuda.MAX_PAIRS_PER_BLOCK * p.n_blocks)
            if not (np.array_equal(ptr.cpu().numpy(), p.pair_ptr)
                    and np.array_equal(bj.cpu().numpy(), p.pair_bj)):
                raise RuntimeError(f"{name} {precision}: the pair CSR built "
                                   f"on the card differs from the host's")
            got, k_ms, phases, stats, scratch = kernel_runs(
                lambda st: poisson_cuda.accept_mask_cuda(
                    planes, ana, p.sq, ptr, bj, stats=st))
            if p.n <= 262_144 and not name.startswith("dense"):
                check_phases(name, precision, planes, ana, p, ptr, bj, got,
                             stats)
            got = got.cpu().numpy()
            b = poisson_bounds(p, stats["close_entries"])
            plain = "plain skipped (time)"
            if name != ROOT_CASE:
                want, plain_ms = synced(lambda: poisson_cuda.accept_mask_torch(
                    planes, ana, p.sq, ptr, bj))
                want = want.cpu().numpy()
                err = int(np.abs(got.astype(np.int16) - want).max())
                max_err = max(max_err, err)
                if err:
                    raise RuntimeError(
                        f"{name} {precision}: kernel mask differs from the "
                        f"plain version at {int((got != want).sum())} points")
                plain = f"plain_ms={plain_ms:.3f}"
            print(f"kernel poisson {name} {precision}: n={p.n} "
                  f"blocks={p.n_blocks} pairs/block="
                  f"{p.pair_bj.size / p.n_blocks:.2f} "
                  f"close_pairs={stats['close_entries']} "
                  f"windows={stats['windows']} accepted={int(got.sum())} "
                  f"kernel_ms={k_ms:.3f} (phase A {phases['A']:.3f}, "
                  f"phase B {phases['B']:.3f}) {plain}; bound "
                  f"{b['bound_ms']:.6f} ms by {b['bound_by']}, the kernel "
                  f"at {100 * b['bound_ms'] / k_ms:.4f}% of it (byte floor "
                  f"{b['byte_ms']:.6f} ms, the kernel at "
                  f"{100 * b['byte_ms'] / k_ms:.4f}%; close pairs x 8 "
                  f"operations {b['op_ms']:.6f} ms, the kernel at "
                  f"{100 * b['op_ms'] / k_ms:.4f}%; not a floor: the "
                  f"AABB-pair formulation's {b['tests']:.4g} tests "
                  f"{b['tests_ms']:.4f} ms); peak scratch "
                  f"{scratch / 2 ** 20:.1f} MiB; native host "
                  f"{native_s * 1e3:.1f} ms", flush=True)
            if precision == "f64" and not np.array_equal(got.view(bool),
                                                         native_mask):
                raise RuntimeError(f"{name} f64: kernel mask differs from "
                                   f"the native host kernel")
            if name.startswith("dense") and stats["windows"] < 2:
                raise RuntimeError(f"{name}: the kernels ran in one window")
            if precision == "f64" and name in (TIMING_CASE, ROOT_CASE):
                if stats["windows"] != 1:
                    raise RuntimeError(f"{name}: the kernels ran in "
                                       f"{stats['windows']} windows")
                lists = stats["lists"]
                deps = poisson_cuda.block_deps(lists[0], lists[1], p.n)
                print(f"kernel poisson {name} f64: phase B waits on "
                      f"{sum(map(len, deps)) / p.n_blocks:.2f} blocks per "
                      f"block; longest dependency chain "
                      f"{poisson_cuda.longest_chain(deps)} of "
                      f"{p.n_blocks} blocks", flush=True)
            if name == TIMING_CASE and precision == "f64":
                report.update(ms=k_ms, plain_ms=plain_ms,
                              bound_ms=b["bound_ms"], bound_by=b["bound_by"],
                              phase_a_ms=phases["A"], phase_b_ms=phases["B"],
                              scratch_mib=scratch / 2 ** 20)
            del planes, ana, ptr, bj
    report["max_abs_err"] = max_err


def check_phases(name, precision, planes, ana, p, ptr, bj, mask,
                 stats) -> None:
    """Phase A's lists of a one-window kernel call (`stats["lists"]`) and
    its phase B mask against their plain versions, exactly (the same lists
    in the same order; the plain phase B on the plain lists)."""
    import torch

    from schwarzwald_tpu_torch.ops import poisson_cuda

    if stats["windows"] != 1:
        raise RuntimeError(f"{name} {precision}: the kernels ran in "
                           f"{stats['windows']} windows")
    want = poisson_cuda.close_lists_torch(planes, ana, p.sq, ptr, bj)
    if not all(torch.equal(g, w) for g, w in zip(stats["lists"], want)):
        raise RuntimeError(f"{name} {precision}: phase A's close lists "
                           f"differ from their plain version")
    if not torch.equal(mask, poisson_cuda.decide_torch(p.n, *want)):
        raise RuntimeError(f"{name} {precision}: phase B's mask differs "
                           f"from its plain version")


def edge_coords(n: int, seed: int):
    """(n,) int32 random 21-bit coordinates per axis whose first rows are
    the one-hot edge rows (each bit alone, 0 and 2^21 - 1 on one axis,
    the other two at 0)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    axes = [rng.integers(0, 1 << 21, n).astype(np.int32) for _ in range(3)]
    oh = np.array([1 << i for i in range(21)] + [0, (1 << 21) - 1],
                  dtype=np.int32)
    for a in range(3):
        for b in range(3):
            axes[a][b * oh.size:(b + 1) * oh.size] = oh if a == b else 0
    return axes


def phase_morton_kernel(report: dict) -> None:
    """K1 vs its plain version and the host encode on the card."""
    import numpy as np
    import torch

    from schwarzwald_tpu_torch.core import morton
    from schwarzwald_tpu_torch.ops import morton_cuda

    max_err = 0
    for n in K1_SIZES:
        axes = edge_coords(n, n)
        x, y, z = (torch.from_numpy(a).cuda() for a in axes)
        got, k_ms = event_ms(lambda: morton_cuda.interleave_cuda(x, y, z))
        want, plain_ms = event_ms(lambda: morton_cuda.interleave21(x, y, z))
        err = int((got - want).abs().max())
        max_err = max(max_err, err)
        host = morton.from_grid_coords(*(a.view(np.uint32) for a in axes))
        host_equal = np.array_equal(got.cpu().numpy().view(np.uint64), host)
        # 12 bytes read and 8 written per point
        print(f"kernel morton n={n}: kernel_ms={k_ms:.3f} "
              f"({20 * n / k_ms / 1e6:.1f} GB/s) plain_ms={plain_ms:.3f} "
              f"max_abs_err={err} host_equal={host_equal}", flush=True)
        if err or not torch.equal(got, want):
            raise RuntimeError(f"n={n}: K1 differs from its plain version")
        if not host_equal:
            raise RuntimeError(f"n={n}: K1 differs from the host encode")
        if n == K1_SIZES[0]:
            report.update(ms=k_ms, plain_ms=plain_ms,
                          bound_ms=20 * n / HBM_BYTES_PER_S * 1e3,
                          bound_by="bytes")
    report["max_abs_err"] = max_err


# -- output trees ------------------------------------------------------------------

def tree_files(root: str) -> dict:
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            full = os.path.join(d, f)
            out[os.path.relpath(full, root)] = full
    return out


def compare_trees(a: str, b: str) -> int:
    """Byte-compare two output trees; properties.json up to its timing
    fields. Returns the number of files compared."""
    fa, fb = tree_files(a), tree_files(b)
    if set(fa) != set(fb):
        raise RuntimeError(f"output trees differ in files: "
                           f"{sorted(set(fa) ^ set(fb))[:10]}")
    for rel in sorted(fa):
        with open(fa[rel], "rb") as x, open(fb[rel], "rb") as y:
            da, db = x.read(), y.read()
        if rel == "properties.json":
            ja, jb = json.loads(da), json.loads(db)
            for doc in (ja, jb):
                doc["performance_stats"].pop("prepare_duration")
                doc["performance_stats"].pop("indexing_duration")
            if ja != jb:
                raise RuntimeError("properties.json differs")
        elif da != db:
            raise RuntimeError(f"{rel} differs between cuda and host runs")
    return len(fa)


def count_points(root: str) -> int:
    import numpy as np

    from schwarzwald_tpu_torch.io.pnts import read_pnts

    total = 0
    for rel, full in tree_files(root).items():
        if rel.endswith(".pnts"):
            buf, _ = read_pnts(full)
            if not np.isfinite(buf.positions).all():
                raise RuntimeError(f"{rel}: non-finite positions")
            total += buf.count
    return total


# -- phase 3: the MIN_DISTANCE main path --------------------------------------------

def write_uniform_las(path: str, n: int) -> None:
    import numpy as np

    from schwarzwald_tpu_torch.core.aabb import AABB
    from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer
    from schwarzwald_tpu_torch.io import las

    rng = np.random.default_rng(7)
    las.write_las(path, PointBuffer(rng.uniform(1.0, 999.0, (n, 3))),
                  AABB([0.0] * 3, [1000.0] * 3))


def phase_min_distance(work: str, report: dict, card: str) -> None:
    import schwarzwald_tpu_torch as sz
    from schwarzwald_tpu_torch.ops import poisson_cuda

    src = os.path.join(work, "cloud.las")
    t0 = time.perf_counter()
    write_uniform_las(src, MAIN_PATH_POINTS)
    print(f"main path: wrote {MAIN_PATH_POINTS} uniform points in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    rates = {}
    for mode in ("cuda", "host"):
        out = os.path.join(work, f"out_{mode}")
        # where the device run's time goes: each device range's stream
        # time in four parts (CUDA events on the range's own stream)
        poisson_cuda.trace = []
        poisson_cuda.reset_counters()
        t0 = time.perf_counter()
        try:
            sz.tile([src], out, use_device=mode)
        finally:
            seconds = time.perf_counter() - t0
            counts = poisson_cuda.snapshot()
            ranges, poisson_cuda.trace = poisson_cuda.trace, None
        rates[mode] = MAIN_PATH_POINTS / seconds
        print(f"main path {mode}: {seconds:.2f} s, "
              f"{rates[mode]:.0f} points/s on {card}; counters {counts}",
              flush=True)
        if mode == "host":
            if counts["launches"] or ranges:
                raise RuntimeError("the host run launched the kernels")
            continue
        report["launches"] = counts["launches"]
        report["launches_by_path"]["3 MIN_DISTANCE main path"] = \
            counts["launches"]
        if counts["launches"] <= 0 or not ranges:
            raise RuntimeError("the main path launched no Poisson kernel")
        sizes = sorted(r["n"] for r in ranges)
        largest = max(ranges, key=lambda r: r["n"])
        print(f"main path cuda: {len(ranges)} device ranges, {sum(sizes)} "
              f"points, sizes min/median/max {sizes[0]}/"
              f"{sizes[len(sizes) // 2]}/{sizes[-1]}; per part, the stream "
              f"time (CUDA events) / the calling thread's wall time "
              f"enqueueing it / that thread's CPU time, in ms", flush=True)
        for label, rs in (("summed over the ranges", ranges),
                          (f"the root range ({largest['n']} points, "
                           f"{largest['windows']} windows)", [largest])):
            split = "; ".join(
                f"{part} {sum(r[f'{part}_ms'] for r in rs):.1f} / "
                f"{sum(r[f'host_{part}_ms'] for r in rs):.1f} / "
                f"{sum(r[f'cpu_{part}_ms'] for r in rs):.1f}"
                for part in ("upload", "prep", "kernel", "download"))
            print(f"main path cuda: {label}: {split} (phase A "
                  f"{sum(r['A'] for r in rs):.1f}, B "
                  f"{sum(r['B'] for r in rs):.1f}); final synchronise "
                  f"{sum(r['wait_ms'] for r in rs):.1f}", flush=True)
        # one stream per worker thread, no stream shared between threads
        streams = {r["stream"] for r in ranges}
        threads = {}
        for r in ranges:
            threads.setdefault(r["thread"], set()).add(r["stream"])
        pools = {}
        for name in threads:  # ThreadPoolExecutor-<pool>_<worker>
            pool = name.rsplit("_", 1)[0]
            pools[pool] = pools.get(pool, 0) + 1
        print(f"main path cuda: {len(threads)} threads sent ranges "
              f"({', '.join(f'{p} x{k}' for p, k in sorted(pools.items()))})"
              f", on {len(streams)} streams", flush=True)
        if any(len(s) != 1 for s in threads.values()):
            raise RuntimeError("a worker thread ran its ranges on more than "
                               "one stream")
        if len(streams) != len(threads):
            raise RuntimeError("worker threads shared a stream")
        if len(streams) < 2 and len(ranges) > 1 and (os.cpu_count() or 1) > 1:
            raise RuntimeError("every device range ran on one stream while "
                               "the engine had more than one worker")
    n_files = compare_trees(os.path.join(work, "out_cuda"),
                            os.path.join(work, "out_host"))
    # ancestors rebuilt at finalize repeat points of their children, so
    # the tiles hold at least (not exactly) the input
    n_points = count_points(os.path.join(work, "out_cuda"))
    if n_points < MAIN_PATH_POINTS:
        raise RuntimeError(f"tiles hold {n_points} points, fewer than the "
                           f"{MAIN_PATH_POINTS} read")
    print(f"main path: {n_files} files byte-identical (cuda vs host), "
          f"{n_points} points in the tiles; cuda/host rate "
          f"{rates['cuda'] / rates['host']:.3f}", flush=True)
    # cloud.las, out_cuda and out_host stay for phases 6 and 7


# -- phase 4: the batch step -------------------------------------------------------

def phase_batch_step(report: dict, card: str) -> None:
    """encode_sort_batch / encode_sort_grid at 10M points and entry() on
    the card, against the host; K1's launches in this run are counted."""
    import numpy as np
    import torch

    from schwarzwald_tpu_torch.core import morton
    from schwarzwald_tpu_torch.entry import entry
    from schwarzwald_tpu_torch.ops import device, indexing, morton_cuda

    n, ext = MAIN_PATH_POINTS, 1000.0
    pos = np.random.default_rng(11).uniform(0.0, ext, (n, 3))
    bmin, bext = np.zeros(3), np.full(3, ext)
    t0 = time.perf_counter()
    host_keys, _ = indexing.index_points(pos.copy(), bmin, bmin + bext)
    sk, order = indexing.sort_with_keys(host_keys)
    hist = np.bincount(morton.truncate_to_level(sk, 2).astype(np.int64),
                       minlength=512)
    host_s = time.perf_counter() - t0
    gx, gy, gz = (a.astype(np.uint32)
                  for a in morton.grid_coords(host_keys, 21))
    pos_t = torch.from_numpy(pos)

    morton_cuda.reset_counters()
    batch, ms = synced(lambda: device.encode_sort_batch(
        pos_t, bmin, bext, level=3, device="cuda"))
    grid, grid_ms = synced(lambda: device.encode_sort_grid(
        gx, gy, gz, level=3, device="cuda"))
    fn, args = entry("cuda")
    (e_batch, e_levels), entry_ms = synced(lambda: fn(*args))
    launches = morton_cuda.snapshot()["launches"]

    for name, b in (("encode_sort_batch", batch), ("encode_sort_grid", grid)):
        if not (np.array_equal(b.keys.cpu().numpy().view(np.uint64), sk)
                and np.array_equal(b.order.cpu().numpy(), order)
                and np.array_equal(b.node_histogram.cpu().numpy(), hist)):
            raise RuntimeError(f"{name} on the card differs from the host "
                               f"encode + sort + histogram")
    fn_cpu, args_cpu = entry("cpu")
    c_batch, c_levels = fn_cpu(*args_cpu)
    for a, b in zip((*e_batch, e_levels), (*c_batch, c_levels)):
        if not torch.equal(a.cpu(), b):
            raise RuntimeError("entry() on the card differs from the CPU")
    if not (c_levels > 0).all():
        raise RuntimeError("entry() left points unassigned")
    print(f"batch step n={n}: encode_sort_batch {ms:.1f} ms, "
          f"encode_sort_grid {grid_ms:.1f} ms (host encode + sort + "
          f"histogram {host_s * 1e3:.1f} ms) on {card}; entry() "
          f"{entry_ms:.1f} ms, levels "
          f"{sorted(set(c_levels.tolist()))}; K1 launches {launches}",
          flush=True)
    report["launches"] = launches
    report["launches_by_path"]["4 batch step"] = launches
    if launches <= 0:
        raise RuntimeError("the batch step launched no Morton kernel")


# -- phase 5: the grid samplers' main path ---------------------------------------------

def write_clustered_las(path: str, n: int, seed: int) -> None:
    """Gaussian clusters of 40,000 points and varying width (sigma 2 to 25
    units) in the 1000-unit cube, as dense patches of an airborne scan:
    start nodes above the 20,000-point take-all limit, so the sweep works
    through several levels."""
    import numpy as np

    from schwarzwald_tpu_torch.core.aabb import AABB
    from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer
    from schwarzwald_tpu_torch.io import las

    rng = np.random.default_rng(seed)
    k = max(1, n // 40_000)
    centers = rng.uniform(50.0, 950.0, (k, 3))
    sigmas = rng.uniform(2.0, 25.0, k)
    counts = np.full(k, n // k)
    counts[:n % k] += 1
    pos = rng.normal(0.0, 1.0, (n, 3))
    pos *= np.repeat(sigmas, counts)[:, None]
    pos += np.repeat(centers, counts, axis=0)
    np.clip(pos, 1.0, 999.0, out=pos)
    las.write_las(path, PointBuffer(pos), AABB([0.0] * 3, [1000.0] * 3))


def phase_grid_samplers(work: str, card: str) -> None:
    import torch

    from schwarzwald_tpu_torch.ops import device_tiling
    from schwarzwald_tpu_torch.process.tiler_process import (TilerArguments,
                                                             TilerProcess)
    from schwarzwald_tpu_torch.tiling.engine import TilingAlgorithmFast

    # observation only: the sweep's seconds and levels per group (with a
    # synchronise, so the seconds are the device's), and the sizes of the
    # fresh start nodes handed to the sweep
    sweeps, fresh_sizes = [], []
    select = device_tiling.octree_select_grid
    pipelined = TilingAlgorithmFast._device_fresh_sweep_pipelined

    def timed_select(key, *args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = select(key, *args, **kwargs)
        torch.cuda.synchronize()
        sweeps.append((key.shape[0], time.perf_counter() - t,
                       torch.unique(out).tolist()))
        return out

    def observed_pipelined(self, arena, fresh, root, level):
        fresh_sizes.extend(sn[1].size for sn in fresh)
        return pipelined(self, arena, fresh, root, level)

    sources = {}
    for sampler, n, seed in (("RANDOM_GRID", MAIN_PATH_POINTS, 17),
                             ("GRID_CENTER", GRID_SMALL_POINTS, 18),
                             ("JITTERED", GRID_SMALL_POINTS, 18)):
        src = sources.get(n)
        if src is None:
            src = sources[n] = os.path.join(work, f"clustered_{n}.las")
            t0 = time.perf_counter()
            write_clustered_las(src, n, seed)
            print(f"grid samplers: wrote {n} clustered points in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        rates = {}
        for mode in ("cuda", "host"):
            out = os.path.join(work, f"{sampler}_{mode}")
            sweeps.clear()
            fresh_sizes.clear()
            device_tiling.octree_select_grid = timed_select
            TilingAlgorithmFast._device_fresh_sweep_pipelined = \
                observed_pipelined
            proc = TilerProcess(TilerArguments(
                sources=[src], output_directory=out, diagonal_fraction=250,
                sampling_strategy=sampler, use_device=mode))
            t0 = time.perf_counter()
            try:
                proc.run()
            finally:
                seconds = time.perf_counter() - t0
                device_tiling.octree_select_grid = select
                TilingAlgorithmFast._device_fresh_sweep_pipelined = pipelined
            rates[mode] = n / seconds
            stats = proc.device_stats
            print(f"grid {sampler} {mode}: {seconds:.2f} s, "
                  f"{rates[mode]:.0f} points/s on {card}; {stats}",
                  flush=True)
            if mode == "host":
                if sweeps or stats["device_sweeps_ok"]:
                    raise RuntimeError("the host run ran the device sweep")
                continue
            levels = sorted({lv for _, _, lvs in sweeps for lv in lvs})
            big = sum(1 for s in fresh_sizes if s > 20_000)
            print(f"grid {sampler} cuda: {len(fresh_sizes)} fresh start "
                  f"nodes, {big} above 20,000 points (largest "
                  f"{max(fresh_sizes, default=0)}); {stats['device_reroots']}"
                  f" re-rooted groups; sweep levels (node level + 2) "
                  f"{levels}", flush=True)
            for g, (pts, s, _) in enumerate(sweeps):
                print(f"grid {sampler} cuda: sweep group {g}: {pts} points "
                      f"{s:.3f} s", flush=True)
            if stats["device_sweeps_ok"] <= 0:
                raise RuntimeError(f"{sampler}: no device sweep persisted")
            if stats["device_reroots"]:
                raise RuntimeError(f"{sampler}: a group hit the re-root rule")
            if big == 0:
                raise RuntimeError(f"{sampler}: no fresh start node above "
                                   f"20,000 points")
            if len([lv for lv in levels if lv > 0]) < 3:
                raise RuntimeError(f"{sampler}: the sweep assigned fewer "
                                   f"than 3 distinct levels")
        n_files = compare_trees(os.path.join(work, f"{sampler}_cuda"),
                                os.path.join(work, f"{sampler}_host"))
        n_points = count_points(os.path.join(work, f"{sampler}_cuda"))
        if n_points < n:
            raise RuntimeError(f"{sampler}: tiles hold {n_points} points, "
                               f"fewer than the {n} read")
        print(f"grid {sampler}: {n_files} files byte-identical (cuda vs "
              f"host), {n_points} points; cuda/host rate "
              f"{rates['cuda'] / rates['host']:.3f}", flush=True)
        for mode in ("cuda", "host"):
            shutil.rmtree(os.path.join(work, f"{sampler}_{mode}"))


# -- phase 6: multichip and multihost -----------------------------------------

SHARDS = 4  # the JAX package's dry run and tests use --multichip 4
START_LEVEL = 3  # the multi-device ownership level and multihost's plan level

# one host of a --multihost run: the port's CLI, then the Poisson kernel's
# counters of this process and its import and run seconds on a line of
# their own
COUNTERS = "k2 counters "
HOST_SCRIPT = ("import json, sys, time\n"
               "t0 = time.perf_counter()\n"
               "from schwarzwald_tpu_torch import cli\n"
               "from schwarzwald_tpu_torch.ops import poisson_cuda\n"
               "t1 = time.perf_counter()\n"
               "rc = cli.main(sys.argv[1:])\n"
               f"print({COUNTERS!r} + json.dumps(dict(\n"
               "    poisson_cuda.snapshot(), import_s=t1 - t0,\n"
               "    run_s=time.perf_counter() - t1)))\n"
               "sys.exit(rc)\n")


def tile_once(src: str, out: str, **options):
    """(TilerProcess after its run, seconds) of one run at the defaults of
    tile(): diagonal fraction 250, FAST, 3D Tiles."""
    from schwarzwald_tpu_torch.process.tiler_process import (TilerArguments,
                                                             TilerProcess)

    proc = TilerProcess(TilerArguments(sources=[src], output_directory=out,
                                       diagonal_fraction=250, **options))
    t0 = time.perf_counter()
    proc.run()
    return proc, time.perf_counter() - t0


def deep_points(root: str, level: int = START_LEVEL) -> int:
    """Points of the tiles at and below `level`: every input point exactly
    once under FAST, whose ancestors repeat points of their children."""
    from schwarzwald_tpu_torch.io.pnts import read_pnts

    total = 0
    for rel, full in tree_files(root).items():
        name = os.path.basename(rel)
        if name.endswith(".pnts") and len(name[:-5]) - 1 >= level:
            total += read_pnts(full)[0].count
    return total


def run_hosts(files, out: str, use_device: str, card: str) -> tuple:
    """Two CLI processes, `--multihost 0 2` and `--multihost 1 2`, sharing
    `out` (and the card). Returns (seconds, K2 launches of both)."""
    env = dict(os.environ, PYTHONPATH=ROOT, SCHWARZWALD_TPU_NO_UI="1")
    argv = ["--tiler", "-i", *files, "-o", out, "--use-device", use_device,
            "--sampling", "MIN_DISTANCE"]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", HOST_SCRIPT, *argv,
                               "--multihost", str(i), "2"], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        outputs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    seconds = time.perf_counter() - t0
    launches = 0
    for i, (p, text) in enumerate(zip(procs, outputs)):
        if p.returncode != 0:
            raise RuntimeError(f"host {i} ({use_device}) exited "
                               f"{p.returncode}: {text[-3000:]}")
        lines = text.splitlines()
        counts = [ln for ln in lines if ln.startswith(COUNTERS)][-1]
        counts = json.loads(counts[len(COUNTERS):])
        stats = [ln for ln in lines if ln.startswith("Device stats: ")][-1]
        print(f"multihost {use_device}: host {i} on {card}: K2 counters "
              f"{counts}; {stats}", flush=True)
        launches += counts["launches"]
    return seconds, launches


def phase_multichip(work: str, k1: dict, k2: dict, card: str) -> None:
    """dryrun_multichip(4); the 10M MIN_DISTANCE and RANDOM_GRID runs over
    4 shards against the single-card runs at start level 3, byte for byte;
    two --multihost CLI processes on the card against two on the host."""
    import numpy as np
    import torch

    from schwarzwald_tpu_torch.core.aabb import AABB
    from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer
    from schwarzwald_tpu_torch.entry import dryrun_multichip
    from schwarzwald_tpu_torch.io import las
    from schwarzwald_tpu_torch.ops import (device_tiling, morton_cuda,
                                           poisson_cuda)

    morton_cuda.reset_counters()
    t0 = time.perf_counter()
    dryrun_multichip(SHARDS)
    launches = morton_cuda.snapshot()["launches"]
    print(f"multichip: dryrun_multichip({SHARDS}) passed in "
          f"{time.perf_counter() - t0:.2f} s on {card}; K1 launches "
          f"{launches}", flush=True)
    k1["launches_by_path"][f"6 dryrun_multichip({SHARDS})"] = launches
    if launches != SHARDS:
        raise RuntimeError(f"dryrun_multichip({SHARDS}) launched K1 "
                           f"{launches} times, not once per shard")

    # MIN_DISTANCE, 10M uniform (phase 3's cloud): the exchange, then K2
    # per range
    src = os.path.join(work, "cloud.las")
    for label, options in (("multichip", {"multichip": SHARDS}),
                           ("single", {"fixed_start_level": START_LEVEL})):
        poisson_cuda.trace = []
        poisson_cuda.reset_counters()
        try:
            proc, seconds = tile_once(src, os.path.join(work, f"md_{label}"),
                                      use_device="cuda", **options)
        finally:
            counts = poisson_cuda.snapshot()
            ranges, poisson_cuda.trace = poisson_cuda.trace, None
        stats = proc.device_stats
        print(f"multichip MIN_DISTANCE {label}: {seconds:.2f} s, "
              f"{MAIN_PATH_POINTS / seconds:.0f} points/s on {card}; "
              f"{len(ranges)} device ranges; K2 counters {counts}; "
              f"{stats}", flush=True)
        if counts["launches"] <= 0 or not ranges:
            raise RuntimeError(f"MIN_DISTANCE {label}: no K2 launch")
        if label == "multichip":
            k2["launches_by_path"][f"6 MIN_DISTANCE --multichip {SHARDS}"] = \
                counts["launches"]
            if stats["shards"] != SHARDS or stats["cards"] < 1:
                raise RuntimeError(f"the run had {stats['shards']} shards "
                                   f"on {stats['cards']} cards")
            if sum(stats["points_per_shard"]) != MAIN_PATH_POINTS:
                raise RuntimeError("the shards did not own every point")
            print(f"multichip MIN_DISTANCE: exchange "
                  f"{', '.join(f'{s * 1e3:.1f}' for s in stats['exchange_s'])}"
                  f" ms per batch (synchronised, host copies included) on "
                  f"{card}", flush=True)
    n_files = compare_trees(os.path.join(work, "md_multichip"),
                            os.path.join(work, "md_single"))
    deep = deep_points(os.path.join(work, "md_multichip"))
    print(f"multichip MIN_DISTANCE: {n_files} files byte-identical "
          f"({SHARDS} shards vs one card at start level {START_LEVEL}); "
          f"{deep} points at and below level {START_LEVEL}", flush=True)
    if deep != MAIN_PATH_POINTS:
        raise RuntimeError(f"{deep} points at and below the start level")
    for label in ("multichip", "single"):
        shutil.rmtree(os.path.join(work, f"md_{label}"))

    # two hosts: the same cloud as two 5M files, one per host
    pos = np.random.default_rng(7).uniform(1.0, 999.0, (MAIN_PATH_POINTS, 3))
    half = MAIN_PATH_POINTS // 2
    parts = []
    for i, part in enumerate((pos[:half], pos[half:])):
        path = os.path.join(work, f"part{i}.las")
        las.write_las(path, PointBuffer(part), AABB([0.0] * 3, [1000.0] * 3))
        parts.append(path)
    del pos
    for mode in ("cuda", "host"):
        out = os.path.join(work, f"mh_{mode}")
        seconds, launches = run_hosts(parts, out, mode, card)
        print(f"multihost {mode}: two processes, {seconds:.2f} s, "
              f"{MAIN_PATH_POINTS / seconds:.0f} points/s on {card}; K2 "
              f"launches {launches}", flush=True)
        if os.path.exists(os.path.join(out, ".mh-exchange")):
            raise RuntimeError(f"multihost {mode}: .mh-exchange/ is left")
        if mode == "cuda":
            k2["launches_by_path"]["6 MIN_DISTANCE --multihost 0 2 + 1 2"] = \
                launches
            if launches <= 0:
                raise RuntimeError("the two cuda hosts launched no K2")
        elif launches:
            raise RuntimeError("the two host-run hosts launched K2")
    n_files = compare_trees(os.path.join(work, "mh_cuda"),
                            os.path.join(work, "mh_host"))
    deep = deep_points(os.path.join(work, "mh_cuda"))
    print(f"multihost: {n_files} files byte-identical (two cuda hosts vs two "
          f"host-run hosts); {deep} points at and below level "
          f"{START_LEVEL}", flush=True)
    if deep != MAIN_PATH_POINTS:
        raise RuntimeError(f"{deep} points at and below the start level")
    for name in ("mh_cuda", "mh_host", *map(os.path.basename, parts)):
        path = os.path.join(work, name)
        shutil.rmtree(path) if os.path.isdir(path) else os.remove(path)

    # RANDOM_GRID, 10M clustered (phase 5's cloud): one sweep per owner,
    # on the owner's device
    src = os.path.join(work, f"clustered_{MAIN_PATH_POINTS}.las")
    sweeps = []
    select = device_tiling.octree_select_grid

    def timed_select(key, *args, **kwargs):  # observation only
        torch.cuda.synchronize(key.device)
        t = time.perf_counter()
        out = select(key, *args, **kwargs)
        torch.cuda.synchronize(key.device)
        sweeps.append((str(key.device), key.shape[0],
                       time.perf_counter() - t))
        return out

    for label, options in (("multichip", {"multichip": SHARDS}),
                           ("single", {"fixed_start_level": START_LEVEL})):
        sweeps.clear()
        device_tiling.octree_select_grid = timed_select
        try:
            proc, seconds = tile_once(src, os.path.join(work, f"rg_{label}"),
                                      use_device="cuda",
                                      sampling_strategy="RANDOM_GRID",
                                      **options)
        finally:
            device_tiling.octree_select_grid = select
        stats = proc.device_stats
        print(f"multichip RANDOM_GRID {label}: {seconds:.2f} s, "
              f"{MAIN_PATH_POINTS / seconds:.0f} points/s on {card}; "
              f"{stats}", flush=True)
        for g, (dev, pts, s) in enumerate(sweeps):
            print(f"multichip RANDOM_GRID {label}: sweep {g} on {dev}: "
                  f"{pts} points {s * 1e3:.1f} ms on {card}", flush=True)
        if stats["device_sweeps_ok"] <= 0:
            raise RuntimeError(f"RANDOM_GRID {label}: no device sweep")
    n_files = compare_trees(os.path.join(work, "rg_multichip"),
                            os.path.join(work, "rg_single"))
    print(f"multichip RANDOM_GRID: {n_files} files byte-identical "
          f"({SHARDS} shards vs one card at start level {START_LEVEL})",
          flush=True)
    for label in ("multichip", "single"):
        shutil.rmtree(os.path.join(work, f"rg_{label}"))


# -- phase 7: the other sinks and the converter --------------------------------

SINK_FORMATS = ("BIN", "BINZ", "LAS", "LAZ", "ENTWINE_LAS")
CONVERT_DEPTH = 4  # --max-depth of the 3D Tiles tree's LAS / LAZ conversions


def converted_points(root: str) -> int:
    """Points of a converted tree: its .pnts tiles' counts (positions
    checked finite) and its LAS / LAZ files' header counts."""
    from schwarzwald_tpu_torch.io import las

    total = count_points(root)
    for rel, full in tree_files(root).items():
        if rel.endswith((".las", ".laz")):
            total += las.LASFile(full).count
    return total


def phase_sinks_and_converter(work: str, k2: dict, card: str) -> None:
    """ENTWINE_LAZ at 10M with K2, the five other formats at 1M under
    RANDOM_GRID, each on the card and on the host, byte for byte; then the
    converter on the card runs' trees against the host runs' trees."""
    import schwarzwald_tpu_torch as sz
    from schwarzwald_tpu_torch.core.attributes import OutputFormat
    from schwarzwald_tpu_torch.ops import poisson_cuda

    # ENTWINE_LAZ, MIN_DISTANCE (the default), phase 3's 10M uniform cloud
    src = os.path.join(work, "cloud.las")
    walls = {}
    for mode in ("cuda", "host"):
        poisson_cuda.reset_counters()
        try:
            proc, walls[mode] = tile_once(
                src, os.path.join(work, f"ept_{mode}"), use_device=mode,
                output_format=OutputFormat.ENTWINE_LAZ)
        finally:
            counts = poisson_cuda.snapshot()
        print(f"sinks ENTWINE_LAZ MIN_DISTANCE {mode}: {walls[mode]:.2f} s, "
              f"{MAIN_PATH_POINTS / walls[mode]:.0f} points/s on {card}; K2 "
              f"counters {counts}", flush=True)
        if mode == "cuda":
            k2["launches_by_path"]["7 ENTWINE_LAZ MIN_DISTANCE"] = \
                counts["launches"]
            if counts["launches"] <= 0:
                raise RuntimeError("the ENTWINE_LAZ cuda run launched no K2")
        elif counts["launches"]:
            raise RuntimeError("the ENTWINE_LAZ host run launched K2")
    n_files = compare_trees(os.path.join(work, "ept_cuda"),
                            os.path.join(work, "ept_host"))
    with open(os.path.join(work, "ept_cuda", "ept.json")) as f:
        ept_points = json.load(f)["points"]
    if ept_points != MAIN_PATH_POINTS:
        raise RuntimeError(f"ept.json counts {ept_points} points")
    print(f"sinks ENTWINE_LAZ: {n_files} files byte-identical (cuda vs host; "
          f"properties.json up to its two timing fields); cuda/host rate "
          f"{walls['host'] / walls['cuda']:.3f}", flush=True)

    # BIN, BINZ, LAS, LAZ, ENTWINE_LAS under RANDOM_GRID, phase 5's 1M
    # clustered cloud: the octree sweep
    src = os.path.join(work, f"clustered_{GRID_SMALL_POINTS}.las")
    for fmt in SINK_FORMATS:
        walls = {}
        for mode in ("cuda", "host"):
            proc, walls[mode] = tile_once(
                src, os.path.join(work, f"{fmt}_{mode}"), use_device=mode,
                sampling_strategy="RANDOM_GRID",
                output_format=OutputFormat(fmt))
            sweeps = proc.device_stats["device_sweeps_ok"]
            if (sweeps > 0) != (mode == "cuda"):
                raise RuntimeError(f"{fmt} {mode}: {sweeps} device sweeps")
        n_files = compare_trees(os.path.join(work, f"{fmt}_cuda"),
                                os.path.join(work, f"{fmt}_host"))
        print(f"sinks {fmt} RANDOM_GRID: cuda {walls['cuda']:.2f} s, host "
              f"{walls['host']:.2f} s, cuda/host rate "
              f"{walls['host'] / walls['cuda']:.3f} on {card}; {n_files} "
              f"files byte-identical", flush=True)
        for mode in ("cuda", "host"):
            shutil.rmtree(os.path.join(work, f"{fmt}_{mode}"))

    # the converter on the 10M trees: each conversion of a card run's tree
    # equals the same conversion of the host run's tree
    for source, target, options in (
            ("ept", "3DTILES", {}),
            ("out", "LAZ", {"max_depth": CONVERT_DEPTH}),
            ("out", "LAS", {"max_depth": CONVERT_DEPTH})):
        points = {}
        for mode in ("cuda", "host"):
            out = os.path.join(work, f"conv_{mode}")
            t0 = time.perf_counter()
            sz.convert(os.path.join(work, f"{source}_{mode}"), out,
                       output_format=target, **options)
            seconds = time.perf_counter() - t0
            points[mode] = converted_points(out)
            print(f"converter {source}_{mode} -> {target} {options}: "
                  f"{points[mode]} points in {seconds:.2f} s, "
                  f"{points[mode] / seconds:.0f} points/s", flush=True)
        n_files = compare_trees(os.path.join(work, "conv_cuda"),
                                os.path.join(work, "conv_host"))
        depths = {len(os.path.splitext(f)[0]) - 1
                  for f in os.listdir(os.path.join(work, "conv_cuda"))
                  if f.endswith((".pnts", ".las", ".laz"))}
        print(f"converter {source} -> {target}: {n_files} files "
              f"byte-identical (cuda trees vs host trees), node levels "
              f"{sorted(depths)}", flush=True)
        if points["cuda"] < (MAIN_PATH_POINTS if source == "ept" else 1):
            raise RuntimeError(f"{source} -> {target}: {points['cuda']} "
                               f"points converted")
        if options and max(depths) > CONVERT_DEPTH:
            raise RuntimeError(f"{source} -> {target}: a node below level "
                               f"{CONVERT_DEPTH}")
        for mode in ("cuda", "host"):
            shutil.rmtree(os.path.join(work, f"conv_{mode}"))


# -- main --------------------------------------------------------------------------

def timed_phase(name: str, fn, *args) -> None:
    t0 = time.perf_counter()
    fn(*args)
    print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)


def main() -> int:
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("torch.cuda.is_available() is False")
    sys.path.insert(0, ROOT)
    try:
        import schwarzwald_tpu_torch
    except ImportError:
        return fail("schwarzwald_tpu_torch not found: run from the root of "
                    "a checkout")
    if not os.path.abspath(schwarzwald_tpu_torch.__file__).startswith(
            ROOT + os.sep):
        return fail("schwarzwald_tpu_torch is not this checkout's")

    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {card} x{torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)  # the card's name and power limit

    # no single PyTorch call computes either function: library_ms is null
    k2 = {"name": "poisson_accept_mask", "route": "cuda",
          "source": "schwarzwald_tpu_torch/csrc/poisson.cu",
          "replaces": "schwarzwald_tpu/ops/poisson_pallas.py:135",
          "library_ms": None, "at": f"{TIMING_CASE} f64",
          "launches_by_path": {}}
    k1 = {"name": "morton_interleave", "route": "cuda",
          "source": "schwarzwald_tpu_torch/csrc/morton.cu",
          "replaces": "schwarzwald_tpu/ops/device.py:217",
          "library_ms": None, "at": f"n={K1_SIZES[0]}",
          "launches_by_path": {}}
    timed_phase("1 build", phase_build)
    timed_phase("2 K2 vs plain", phase_poisson_kernel, k2)
    timed_phase("2 K1 vs plain", phase_morton_kernel, k1)

    work = os.path.join(ROOT, ".chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        timed_phase("3 MIN_DISTANCE main path", phase_min_distance, work, k2,
                    smi)
        timed_phase("4 batch step", phase_batch_step, k1, smi)
        timed_phase("5 grid samplers", phase_grid_samplers, work, smi)
        timed_phase("6 multichip and multihost", phase_multichip, work, k1,
                    k2, smi)
        timed_phase("7 other sinks and the converter",
                    phase_sinks_and_converter, work, k2, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)

    keys = ("name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "at", "launches_by_path")
    kernels = [{k: r[k] for k in keys} for r in (k1, k2)]
    kernels[1].update({k: k2[k] for k in ("phase_a_ms", "phase_b_ms",
                                          "scratch_mib")})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
