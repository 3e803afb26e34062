#!/usr/bin/env python3
"""Where the grid samplers' device sweep (X2) spends its time, on the input
of a grid-sampler cell of BENCHMARK.json: one CLI run per cell in a fresh
process with every step of the sweep timed apart.

    python3 bench_sweep.py [--cells rg_10M_terrain_3dtiles,gc_10M_laz_entwine]
        [--rehearse]

Run from the root of a checkout on a machine with one card. Per cell:

  1. the cell's input drawn from its manifest's seed (bench_torch
     .write_inputs) into .bench_sweep_work/ (emptied before, removed after)
     and checked against the manifest;
  2. one run of `cli.main` on the card in a child process, with each step
     of every device sweep bracketed by a synchronise of the card (so the
     run is slower than an untimed one, and no step overlaps another):
     the keys' upload (`device_tiling.keys_tensor`), the positions' gather
     and upload (GRID_CENTER and JITTERED: the rest of
     `_device_select_levels`), the sweep itself (`octree_select_grid`,
     host wall), the copy back (`_materialize_levels`) and the persist
     (`_persist_device_assignment`), per group in launch order, so the
     first group (the first use of each kernel in the process) stands
     apart from the later ones; on the same group the native host sweep
     (`_host_sweep_levels`, its levels held against the card's);
  3. after the run, each group's sweep again on the same tensors, now
     warm: its host wall, its span on the card (CUDA events) and the
     card's busy time inside it (torch.profiler: the union of its kernels,
     copies and sets), and the launches of the port's sweep kernel where
     the checkout has one (`device_tiling.x2_launches`).

The run's tree is held against the cell's manifest. The last line of
standard output is one JSON object. --rehearse runs the same on the CPU
(--use-device cpu, the rehearsal input); its numbers are no device's.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import bench_torch as bt

GRID_CELLS = ("rg_10M_terrain_3dtiles", "gc_10M_laz_entwine")
WORK = os.path.join(bt.ROOT, ".bench_sweep_work")


def child(argv) -> int:
    """`run`: one instrumented cli.main run; writes the groups to
    --result."""
    ap = argparse.ArgumentParser(prog="bench_sweep.py run")
    ap.add_argument("--result", required=True)
    ap.add_argument("cli", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cli_args = args.cli[1:] if args.cli[:1] == ["--"] else args.cli

    import numpy as np
    import torch

    from schwarzwald_tpu_torch import cli
    from schwarzwald_tpu_torch.ops import device_tiling
    from schwarzwald_tpu_torch.tiling import engine

    groups = []   # one dict per device sweep, in launch order
    replays = []  # (group, key, args, kwargs) to sweep again after the run

    def sync(device):
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)

    def timed(fn, device):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        return out, (time.perf_counter() - t0) * 1e3

    keys_tensor = device_tiling.keys_tensor
    select = device_tiling.octree_select_grid
    select_levels = engine.TilingAlgorithmBase._device_select_levels
    materialize = engine.TilingAlgorithmBase._materialize_levels
    persist = engine.TilingAlgorithmBase._persist_device_assignment

    def timed_keys(sorted_keys, device):
        out, ms = timed(lambda: keys_tensor(sorted_keys, device), device)
        groups[-1]["keys_upload_ms"] = ms
        return out

    def timed_select(key, *a, **kw):
        before = getattr(device_tiling, "x2_launches", None)
        out, ms = timed(lambda: select(key, *a, **kw), key.device)
        g = groups[-1]
        g["sweep_ms"] = ms
        if before is not None:
            g["x2_launches"] = device_tiling.x2_launches - before
        replays.append((g, key, a, kw))
        return out

    def timed_select_levels(self, arena, sorted_keys, sorted_ids, root,
                            min_node_level=-1, device=None,
                            materialize=True):
        dev = torch.device(self.meta.use_device if device is None
                           else device)
        g = {"group": len(groups), "points": int(sorted_keys.size),
             "device": str(dev), "sampler": self.sampling_strategy.name}
        groups.append(g)
        levels, ms = timed(lambda: select_levels(
            self, arena, sorted_keys, sorted_ids, root, min_node_level,
            device, False), dev)
        g["select_levels_ms"] = ms
        # the positions' gather and upload: what the two timed calls
        # inside do not hold
        g["positions_ms"] = ms - g["keys_upload_ms"] - g["sweep_ms"]
        broken = getattr(self, "_host_sweep_broken", False)
        t0 = time.perf_counter()
        host = self._host_sweep_levels(arena, sorted_keys, sorted_ids, root,
                                       min_node_level=min_node_level)
        g["host_sweep_ms"] = (time.perf_counter() - t0) * 1e3
        self._host_sweep_broken = broken
        g["host_equal"] = host is not None and bool(np.array_equal(
            host, levels.cpu().numpy()))
        return self._materialize_levels(levels) if materialize else levels

    def timed_materialize(self, device_levels):
        out, ms = timed(lambda: materialize(self, device_levels),
                        device_levels.device)
        # the engines copy the groups back in the order they launched them
        next(g for g in groups if "materialize_ms" not in g)[
            "materialize_ms"] = ms
        return out

    def timed_persist(self, arena, sorted_keys, sorted_ids, levels, root):
        t0 = time.perf_counter()
        persist(self, arena, sorted_keys, sorted_ids, levels, root)
        ms = (time.perf_counter() - t0) * 1e3
        next(g for g in groups if "persist_ms" not in g
             and g["points"] == sorted_keys.size)["persist_ms"] = ms

    device_tiling.keys_tensor = timed_keys
    device_tiling.octree_select_grid = timed_select
    engine.TilingAlgorithmBase._device_select_levels = timed_select_levels
    engine.TilingAlgorithmBase._materialize_levels = timed_materialize
    engine.TilingAlgorithmBase._persist_device_assignment = timed_persist
    t0 = time.perf_counter()
    rc = cli.main(cli_args)
    run_s = time.perf_counter() - t0
    device_tiling.octree_select_grid = select

    for g, key, a, kw in replays:
        _, g["replay_wall_ms"] = timed(lambda: select(key, *a, **kw),
                                       key.device)
        if key.device.type != "cuda":
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(key.device)
        start.record()
        select(key, *a, **kw)
        end.record()
        torch.cuda.synchronize(key.device)
        g["replay_card_span_ms"] = start.elapsed_time(end)
        g["replay_busy_ms"] = busy_ms(lambda: select(key, *a, **kw),
                                      key.device)
    with open(args.result, "w") as f:
        json.dump({"rc": rc, "run_s": run_s, "groups": groups}, f)
    return int(rc or 0)


def busy_ms(fn, device) -> float:
    """The card's busy time while fn runs: the union of the kernels, copies
    and sets that torch.profiler records, in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            doc = json.load(f)
    intervals = [(float(e["ts"]), float(e["ts"] + e["dur"]))
                 for e in doc.get("traceEvents", [])
                 if e.get("ph") == "X" and e.get("cat") in bt.DEVICE_CATS]
    return sum(b - a for a, b in bt._union(intervals)) / 1e3


def describe(g: dict) -> str:
    keys = ("keys_upload_ms", "positions_ms", "sweep_ms", "materialize_ms",
            "persist_ms", "host_sweep_ms", "replay_wall_ms",
            "replay_card_span_ms", "replay_busy_ms", "x2_launches")
    parts = ", ".join(f"{k} {g[k]:.3f}" if isinstance(g[k], float)
                      else f"{k} {g[k]}" for k in keys if k in g)
    return (f"{g['sampler']} group {g['group']} ({g['points']} points on "
            f"{g['device']}): {parts}; host levels equal: "
            f"{g['host_equal']}")


def run_cell(name: str, rehearse: bool) -> dict:
    cell = {c["name"]: c for c in bt.load_benchmark()["workloads"]}[name]
    with open(bt.manifest_path(name, rehearse)) as f:
        seed = json.load(f)["seed"]
    manifest = bt.load_manifest(name, seed, rehearse)
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    try:
        t0 = time.perf_counter()
        paths, points, _ = bt.write_inputs(cell["traffic"], seed,
                                           os.path.join(WORK, "input"),
                                           rehearse)
        drawn = {os.path.basename(p): bt.file_digest(p) for p in paths}
        if drawn != manifest["input"]:
            raise RuntimeError(f"{name}: the input drawn is not the "
                               f"reference's")
        print(f"{name}: {points} points drawn in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        out_dir = os.path.join(WORK, "out")
        result = os.path.join(WORK, "result.json")
        log = os.path.join(WORK, "run.log")
        cmd = [sys.executable, os.path.abspath(__file__), "run", "--result",
               result, "--", "--tiler", "-i", paths[0],
               *bt.config_argv(cell["config"], cell["traffic"], rehearse),
               "--use-device", "cpu" if rehearse else "cuda", "-o", out_dir]
        env = dict(os.environ, SCHWARZWALD_TPU_NO_UI="1")
        with open(log, "w") as f:
            proc = subprocess.run(cmd, cwd=bt.ROOT, env=env, stdout=f,
                                  stderr=subprocess.STDOUT,
                                  timeout=bt.RUN_TIMEOUT_S)
        if proc.returncode != 0:
            raise RuntimeError(f"{name}: exit {proc.returncode}: "
                               f"{bt.log_tail(log)}")
        with open(result) as f:
            got = json.load(f)
        got.update(cell=name, points=points,
                   tile_s=bt.tile_seconds(out_dir),
                   files=bt.compare_tree(out_dir, manifest["tree"]))
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    print(f"{name}: cli.main {got['run_s']:.3f} s (TilerProcess.run "
          f"{got['tile_s']:.3f} s, every step synchronised); tree "
          f"identical ({got['files']} files)", flush=True)
    for g in got["groups"]:
        print(f"  {describe(g)}", flush=True)
        if not g["host_equal"]:
            raise RuntimeError(f"{name}: group {g['group']}: the host "
                               f"sweep's levels differ from the card's")
    return got


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["run"]:
        return child(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cells", default=",".join(GRID_CELLS))
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    if not args.rehearse:
        import torch

        if not torch.cuda.is_available():
            print("bench_sweep: FAIL: no CUDA card", file=sys.stderr)
            return 1
        print(bt.nvidia_smi(), flush=True)
    cells = [run_cell(c, args.rehearse) for c in args.cells.split(",") if c]
    print(json.dumps({"cells": cells}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
