#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (schwarzwald_tpu_torch) on one card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one CUDA card (Hopper,
sm_90a), nvcc and g++. Phases, in order; any failure exits non-zero:

  1. environment: torch, the card, its power limit; build every kernel of
     the main path from the checkout's sources (csrc/*.cu with nvcc, the
     native host kernels with g++);
  2. each kernel against its plain-torch version on the card, on
     Morton-sorted ranges (uniform up to 1.5M points, clustered,
     duplicates, a ::3 analyze mask), in both precision modes; masks must
     be equal exactly, and the f64 masks must equal the native host kernel;
  3. the main path: a 10M-point uniform LAS tiled at the defaults (FAST,
     MIN_DISTANCE, 3D Tiles, 20,000 points per node, spacing =
     diagonal/250) with use_device="cuda" and on the host; the two output
     trees must be byte-identical (properties.json up to its two timing
     fields), every tile must hold finite positions, the tiles must hold at
     least every input point, and the kernel must have been launched;
  4. the summary: one JSON line per the kernels, then the result line.

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
MAIN_PATH_POINTS = 10_000_000   # the reference's default batch
TIMING_CASE = "uniform_262144"  # the kernel row's ms / plain_ms


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


def sorted_range(pos, extent):
    """Clamp, Morton-encode and sort a cloud with the port's indexing."""
    import numpy as np

    from schwarzwald_tpu_torch.ops import indexing

    keys, clamped = indexing.index_points(pos, np.zeros(3),
                                          np.full(3, extent))
    _, order = indexing.sort_with_keys(keys)
    return clamped[order]


def kernel_cases():
    """(name, sorted positions, spacing, analyze mask, extent)."""
    import numpy as np

    rng = np.random.default_rng(20260816)
    ext = 64.0
    cases = []
    for n in (4096, 262_144, 1_500_000):
        pos = sorted_range(rng.uniform(0.0, ext, (n, 3)), ext)
        cases.append((f"uniform_{n}", pos, 2.0, None, ext))
    centers = rng.uniform(4.0, ext - 4.0, (64, 3))
    pos = np.concatenate([c + rng.normal(0.0, 0.8, (3000, 3))
                          for c in centers])
    cases.append(("clustered_192000",
                  sorted_range(np.clip(pos, 0.0, ext - 1e-9), ext), 0.6,
                  None, ext))
    pos = sorted_range(rng.uniform(0.0, ext, (262_144, 3)), ext)
    pos[5000:6000] = pos[4999]  # a run of exact duplicates
    cases.append(("duplicates_262144", pos, 1.0, None, ext))
    pos = sorted_range(rng.uniform(0.0, ext, (262_144, 3)), ext)
    analyze = np.zeros(pos.shape[0], dtype=bool)
    analyze[::3] = True
    cases.append(("analyze3_262144", pos, 2.0, analyze, ext))
    return cases


def phase_kernels(report: dict) -> None:
    """Kernel vs plain version (and vs native in f64) on the card."""
    import numpy as np
    import torch

    from schwarzwald_tpu_torch import native
    from schwarzwald_tpu_torch.ops import poisson_cuda

    host_kernel = native.poisson_sample_kernel()
    if host_kernel is None:
        raise RuntimeError("native host kernels did not build")
    dev = torch.device("cuda")
    max_err = 0
    for name, pos, spacing, analyze, ext in kernel_cases():
        native_mask = host_kernel(pos, np.zeros(3), np.full(3, ext), spacing,
                                  analyze)
        for precision in ("f64", "f32"):
            p = poisson_cuda.prep(pos, spacing, analyze, precision)
            if p is None:
                raise RuntimeError(f"{name}: prep declined the range")
            planes = torch.from_numpy(p.planes).to(dev)
            ana = (None if p.analyze is None
                   else torch.from_numpy(p.analyze).to(dev))
            ptr = torch.from_numpy(p.pair_ptr).to(dev)
            bj = torch.from_numpy(p.pair_bj).to(dev)

            def kernel():
                return poisson_cuda.accept_mask_cuda(planes, ana, p.sq, ptr,
                                                     bj)

            synced(kernel)  # warm
            times = []
            for _ in range(3):
                got, ms = synced(kernel)
                times.append(ms)
            k_ms = sorted(times)[1]
            want, plain_ms = synced(lambda: poisson_cuda.accept_mask_torch(
                planes, ana, p.sq, ptr, bj))
            got = got.cpu().numpy()
            want = want.cpu().numpy()
            err = int(np.abs(got.astype(np.int16) - want).max())
            max_err = max(max_err, err)
            line = (f"kernel poisson {name} {precision}: n={pos.shape[0]} "
                    f"blocks={p.n_blocks} pairs/block="
                    f"{p.pair_bj.size / p.n_blocks:.2f} "
                    f"accepted={int(got.sum())} kernel_ms={k_ms:.3f} "
                    f"plain_ms={plain_ms:.3f}")
            print(line, flush=True)
            if err:
                raise RuntimeError(f"{name} {precision}: kernel mask differs "
                                   f"from the plain version at "
                                   f"{int((got != want).sum())} points")
            if precision == "f64" and not np.array_equal(got.view(bool),
                                                         native_mask):
                raise RuntimeError(f"{name} f64: kernel mask differs from "
                                   f"the native host kernel")
            if name == TIMING_CASE and precision == "f64":
                report["ms"] = k_ms
                report["plain_ms"] = plain_ms
    report["max_abs_err"] = max_err


def write_uniform_las(path: str, n: int) -> None:
    import numpy as np

    from schwarzwald_tpu_torch.core.aabb import AABB
    from schwarzwald_tpu_torch.core.pointbuffer import PointBuffer
    from schwarzwald_tpu_torch.io import las

    rng = np.random.default_rng(7)
    las.write_las(path, PointBuffer(rng.uniform(1.0, 999.0, (n, 3))),
                  AABB([0.0] * 3, [1000.0] * 3))


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


def phase_main_path(work: str, report: dict, card: str) -> None:
    import schwarzwald_tpu_torch as sz
    from schwarzwald_tpu_torch.ops import poisson_cuda

    src = os.path.join(work, "cloud.las")
    t0 = time.perf_counter()
    write_uniform_las(src, MAIN_PATH_POINTS)
    print(f"main path: wrote {MAIN_PATH_POINTS} uniform points in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # where the device run's time goes: wall time inside the device Poisson
    # path (prep upload, kernel, mask download) per range; ranges run from
    # several threads at once, so the sum can exceed the run's wall time
    ranges = []
    lock = threading.Lock()
    accept_mask = poisson_cuda.accept_mask

    def timed_accept_mask(p, device):
        t = time.perf_counter()
        out = accept_mask(p, device)
        with lock:
            ranges.append((p.n, time.perf_counter() - t))
        return out

    rates = {}
    for mode in ("cuda", "host"):
        out = os.path.join(work, f"out_{mode}")
        poisson_cuda.reset_counters()
        ranges.clear()
        poisson_cuda.accept_mask = timed_accept_mask
        t0 = time.perf_counter()
        try:
            sz.tile([src], out, use_device=None if mode == "host" else mode)
        finally:
            poisson_cuda.accept_mask = accept_mask
        seconds = time.perf_counter() - t0
        counts = poisson_cuda.snapshot()
        rates[mode] = MAIN_PATH_POINTS / seconds
        print(f"main path {mode}: {seconds:.2f} s, "
              f"{rates[mode]:.0f} points/s on {card}; counters {counts}",
              flush=True)
        if ranges:
            sizes = sorted(n for n, _ in ranges)
            print(f"main path {mode}: {len(ranges)} device ranges, "
                  f"{sum(sizes)} points, sizes min/median/max "
                  f"{sizes[0]}/{sizes[len(sizes) // 2]}/{sizes[-1]}, "
                  f"{sum(s for _, s in ranges):.2f} s summed inside the "
                  f"device Poisson path (largest range "
                  f"{max(ranges)[1]:.2f} s)", flush=True)
        if mode == "cuda":
            report["launches"] = counts["launches"]
            if counts["launches"] <= 0:
                raise RuntimeError("the main path launched no Poisson kernel")
        elif counts["launches"]:
            raise RuntimeError("the host run launched the kernel")
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
    from schwarzwald_tpu_torch.ops import _cuda_build, poisson_cuda

    card = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {card} x{torch.cuda.device_count()}", flush=True)
    print(smi, flush=True)  # the card's name and power limit

    t0 = time.perf_counter()
    from schwarzwald_tpu_torch import native
    if native._lib() is None:
        return fail("native host kernels did not build")
    print(f"build: native host kernels {time.perf_counter() - t0:.1f} s",
          flush=True)
    for precision in ("f64", "f32"):
        poisson_cuda._kernel_fn(precision)
    info = _cuda_build.build_info["poisson"]
    print(f"build: csrc/poisson.cu {info['seconds']:.1f} s (nvcc "
          f"{' '.join(_cuda_build.NVCC_FLAGS)})", flush=True)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}", flush=True)

    report = {"name": "poisson_accept_mask", "route": "cuda",
              "source": "schwarzwald_tpu_torch/csrc/poisson.cu",
              "replaces": "schwarzwald_tpu/ops/poisson_pallas.py:135",
              "at": f"{TIMING_CASE} f64"}
    phase_kernels(report)

    work = os.path.join(ROOT, ".chip_smoke_work")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        phase_main_path(work, report, f"{smi}")
    finally:
        shutil.rmtree(work, ignore_errors=True)

    kernels = [{k: report[k] for k in ("name", "route", "source", "replaces",
                                       "launches", "max_abs_err", "ms",
                                       "plain_ms", "at")}]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
