#!/usr/bin/env python3
"""Times of K2's prep and the sweep X2 on the card, at the shapes of
PERF.md's kernel table, and the prep of every range of a cell's run.

    python3 bench_kernels.py shapes [--parent DIR] [--pairs N]
    python3 bench_kernels.py ranges [--cell C] [--threads N|default]
        [--parent DIR] [--pairs N]

Run from the root of a checkout on a machine with one card. Each
measurement runs in a fresh process on one checkout's package: this one,
and with --parent DIR (another checkout, e.g. the parent commit unpacked
with git archive) that one too, in the order parent, this, this, parent,
N times (default 1), so two versions are compared inside one call.

  shapes: the prep (`poisson_cuda._prep` into a one-off workspace, f64, as
      the range path runs it) at `uniform_262144` (512 blocks), the 10M
      main path's root (5,490,148 points) and uniform ranges of
      PREP_CURVE blocks, and X2
      (`device_tiling.octree_select_grid_cuda`) on the 4M-point clustered
      group from the root and from level 2 under each grid sampler
      (sanitize_kernels' cases): the mean ms per call over windows of
      back-to-back calls between two CUDA events, each window queued
      behind a spin kernel so that it times the card and not the host's
      enqueue (chip_smoke.event_ms with queued=True: median of 3 windows,
      after a warm-up), and the launches per call;
  ranges: the cell's input (bench_torch.write_inputs, from the manifest's
      seed, into .bench_kernels_work/, checked against the manifest), one
      CLI run per process with --threads (default 1: one sending thread,
      one stream; `default`: the CLI's own) and K2's range trace on: per
      range its blocks and the
      prep's stream time between the CUDA events around its launches;
      summed and by block count (powers of two), with the prep launches
      and K2's launches and ranges of the run, and the three slowest
      ranges with their place in the run. Each run's tree is held against
      the manifest.

Prints the card's name and power limit first; the last line of standard
output is one JSON object.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import bench_torch as bt
from chip_smoke import event_ms

THIS_ROOT = bt.ROOT
WORK = os.path.join(THIS_ROOT, ".bench_kernels_work")
PREP_CASES = ("uniform_262144", "root_5490148")
# the prep on uniform ranges of these many blocks at uniform_262144's
# density (2 spacings per 64 units of 262,144 points)
PREP_CURVE = (8, 64, 200, 512, 768, 1024, 1536, 2048, 3072, 4096, 4097, 8192)
SWEEP_CASES = ("clustered_4M_level-1", "clustered_4M_level2")
BIN_EDGES = (8, 16, 32, 64, 128, 200, 256, 512, 1024, 4096, 1 << 31)


def card_ms(fn, calls: int) -> float:
    """The mean ms per call of fn on the card (queued windows)."""
    return event_ms(fn, launches=calls, queued=True)[1]


def measure_shapes() -> dict:
    """The prep and X2 at the kernel table's shapes, on the imported
    checkout's package."""
    import numpy as np
    import torch

    from schwarzwald_tpu_torch.ops import (device_tiling, poisson_cuda,
                                           sanitize_kernels as sk)

    dev = torch.device("cuda")
    out = {}
    rng = np.random.default_rng(14)
    curve = []
    for nb in PREP_CURVE:
        n = nb * poisson_cuda.BLOCK
        extent = 64.0 * (n / 262_144) ** (1 / 3)
        curve.append((f"uniform_{nb}_blocks",
                      sk.sorted_range(rng.uniform(0.0, extent, (n, 3)),
                                      extent), 2.0, None, extent, None))
    for name, pos, spacing, _, _, _ in (sk.poisson_cases(set(PREP_CASES))
                                        + curve):
        n = pos.shape[0]
        nb = -(-n // poisson_cuda.BLOCK)
        p = torch.from_numpy(pos).to(dev)
        buf = poisson_cuda._Workspace(dev, counted=False).arrays(n, "f64",
                                                                 False)

        def prep():
            poisson_cuda._prep(p.view(-1), None, n, nb, spacing, "f64", buf)

        before = poisson_cuda.prep_launches
        prep()
        torch.cuda.synchronize()
        launches = poisson_cuda.prep_launches - before
        out[f"prep {name}"] = {"blocks": nb, "launches": launches,
                               "ms": card_ms(prep, 50 if nb < 4096 else 10)}
        del p, buf
    for case in sk.sweep_cases(set(SWEEP_CASES)):
        for sampler in sk.SWEEP_SAMPLERS:
            key, args, kw = sk.sweep_args(case, sampler, dev)

            def sweep():
                device_tiling.octree_select_grid_cuda(key, *args, **kw)

            before = device_tiling.snapshot()["x2_launches"]
            sweep()
            torch.cuda.synchronize()
            launches = device_tiling.snapshot()["x2_launches"] - before
            out[f"X2 {case[0]} {sampler}"] = {
                "n": int(key.shape[0]), "launches": launches,
                "ms": card_ms(sweep, 10)}
    return out


def measure_ranges(cli_args: list, out_dir: str) -> dict:
    """One CLI run on the card with K2's range trace on: per range its
    points and the prep's stream ms; the run's launch counts."""
    from schwarzwald_tpu_torch import cli
    from schwarzwald_tpu_torch.ops import poisson_cuda

    poisson_cuda.trace = []
    t0 = time.perf_counter()
    rc = cli.main([*cli_args, "-o", out_dir])
    wall = time.perf_counter() - t0
    ranges, poisson_cuda.trace = poisson_cuda.trace, None
    return {"rc": rc, "wall_s": wall,
            "prep_launches": poisson_cuda.prep_launches,
            "k2": poisson_cuda.snapshot(),
            "ranges": [(r["n"], r["prep_ms"], r.get("prep_launches"))
                       for r in ranges]}


def child(argv) -> int:
    """`child`: one measurement on the checkout at --root, written to
    --result; the CLI's arguments (ranges) follow `--`."""
    cut = argv.index("--") if "--" in argv else len(argv)
    ap = argparse.ArgumentParser(prog="bench_kernels.py child")
    ap.add_argument("--what", choices=("shapes", "ranges"), required=True)
    ap.add_argument("--root", required=True)
    ap.add_argument("--result", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv[:cut])
    # the package of --root, not this file's directory
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [args.root] + [p for p in sys.path
                                 if os.path.abspath(p or ".") != here]
    if args.what == "shapes":
        got = measure_shapes()
    else:
        got = measure_ranges(argv[cut + 1:], args.out)
    with open(args.result, "w") as f:
        json.dump(got, f)
    return 0


def run_child(root: str, what: str, extra: list) -> dict:
    result = os.path.join(WORK, "result.json")
    cmd = [sys.executable, os.path.abspath(__file__), "child", "--what",
           what, "--root", root, "--result", result, *extra]
    env = dict(os.environ, SCHWARZWALD_TPU_NO_UI="1", PYTHONPATH=root)
    proc = subprocess.run(cmd, cwd=root, env=env, capture_output=True,
                          text=True, timeout=1800)
    if proc.returncode != 0:
        raise RuntimeError(f"{what} on {root}: exit {proc.returncode}: "
                           f"{proc.stderr[-3000:]}")
    with open(result) as f:
        return json.load(f)


def by_blocks(ranges: list, block: int = 512) -> list:
    """The ranges' prep ms by block count, from (points, ms, launches or
    None) per range: one row per bin of BIN_EDGES (blocks <= edge) that
    holds a range, with the prep launches the ranges recorded (None where
    the checkout records none)."""
    rows, lo = [], 0
    for edge in BIN_EDGES:
        got = [(m, k) for n, m, k in ranges if lo < -(-n // block) <= edge]
        if got:
            ms = [m for m, _ in got]
            known = [k for _, k in got if k is not None]
            rows.append({"blocks": f"{lo + 1}-{edge}", "ranges": len(ms),
                         "sum_ms": sum(ms), "median_ms": statistics.median(ms),
                         "max_ms": max(ms),
                         "launches": sum(known) if known else None})
        lo = edge
    return rows


def build(root: str) -> None:
    """The kernels and the native library of the checkout at `root`, in a
    process of their own."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from schwarzwald_tpu_torch import native; native._lib(); "
            "from schwarzwald_tpu_torch.ops._cuda_build import "
            "load_kernel_library as k; k('poisson'); k('sweep')")
    subprocess.run([sys.executable, "-c", code, root], check=True, cwd=root)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["child"]:
        return child(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("what", choices=("shapes", "ranges"))
    ap.add_argument("--cell", default="md_10M_terrain_3dtiles")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--pairs", type=int, default=1)
    ap.add_argument("--threads", default="1")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("bench_kernels: FAIL: no CUDA card", file=sys.stderr)
        return 1
    print(bt.nvidia_smi(), flush=True)
    roots = {"this": THIS_ROOT}
    order = ["this"]
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
        order = ["parent", "this", "this", "parent"] * args.pairs
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    runs = []
    try:
        for root in roots.values():
            build(root)
        extra = []
        if args.what == "ranges":
            cell = {c["name"]: c for c in bt.load_benchmark()["workloads"]}[
                args.cell]
            with open(bt.manifest_path(args.cell, False)) as f:
                seed = json.load(f)["seed"]
            manifest = bt.load_manifest(args.cell, seed, False)
            paths, points, _ = bt.write_inputs(
                cell["traffic"], seed, os.path.join(WORK, "input"))
            drawn = {os.path.basename(p): bt.file_digest(p) for p in paths}
            if drawn != manifest["input"]:
                raise RuntimeError("the input drawn is not the reference's")
            out_dir = os.path.join(WORK, "out")
            extra = ["--out", out_dir, "--", "--tiler", "-i", paths[0],
                     *bt.config_argv(cell["config"], cell["traffic"], False),
                     "--use-device", "cuda"]
            if args.threads != "default":
                extra += ["--threads", args.threads]
        for name in order:
            if args.what == "ranges":
                shutil.rmtree(out_dir, ignore_errors=True)
            got = run_child(roots[name], args.what, extra)
            got["label"] = name
            if args.what == "ranges":
                got["files"] = bt.compare_tree(out_dir, manifest["tree"])
                ranges = got.pop("ranges")
                got["by_blocks"] = by_blocks(ranges)
                # the slowest ranges, with their place in the run's order
                got["slowest"] = sorted(
                    ([k, *r] for k, r in enumerate(ranges)),
                    key=lambda r: -r[2])[:3]
                got["prep_ms"] = sum(r["sum_ms"] for r in got["by_blocks"])
                print(f"{name}: {args.cell} --threads {args.threads}, "
                      f"{got['k2']['kernel']} ranges on "
                      f"the card, prep launches {got['prep_launches']}, K2 "
                      f"launches {got['k2']['launches']}, prep stream ms "
                      f"summed {got['prep_ms']:.3f}; tree identical "
                      f"({got['files']} files)", flush=True)
                print(f"  slowest (order, points, ms, launches): "
                      f"{got['slowest']}", flush=True)
                for row in got["by_blocks"]:
                    print(f"  blocks {row['blocks']}: {row['ranges']} "
                          f"ranges, prep ms summed {row['sum_ms']:.3f}, "
                          f"median {row['median_ms']:.4f}, max "
                          f"{row['max_ms']:.4f}, prep launches "
                          f"{row['launches']}", flush=True)
            else:
                for k, v in got.items():
                    if k != "label":
                        print(f"{name}: {k}: {v}", flush=True)
            runs.append(got)
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(json.dumps({"what": args.what, "cell": args.cell,
                      "threads": args.threads, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
