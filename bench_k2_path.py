#!/usr/bin/env python3
"""Where a cell's tiler run spends its time, on the input of a cell of
BENCHMARK.json (md_10M_terrain_3dtiles by default): the MIN_DISTANCE range
path's host time, the process's start, and the run in two checkouts side
by side.

    python3 bench_k2_path.py [--cell C] [--threads 1,2,4,8,default]
        [--parent DIR] [--pairs N] [--host-pairs N] [--rehearse]

Run from the root of a checkout on a machine with the cell's cards (four
for md_10M_multichip4, one for the others). Steps:

  1. the cell's input drawn from its manifest's seed (bench_torch
     .write_inputs) into .bench_k2_path_work/ (emptied before, removed
     after) and checked against the manifest; the kernels built in each
     checkout;
  2. the host run (--use-device host) of this checkout, a reading;
  3. for each --threads value, one CLI run of this checkout on the card in
     a fresh process with K2's range trace on (ops/poisson_cuda.trace):
     per part of a range (upload, prep, kernel, download), summed over the
     ranges, the stream time (CUDA events), the sending thread's wall time,
     its CPU time, and the wall that neither explains (per range
     max(0, wall - max(stream, CPU)), summed); the sending threads' summed
     wall. Every such sum adds up concurrent threads, so it can exceed the
     run's wall; and a stream span between two events holds the time the
     stream waited for its thread to enqueue the next step. The allocations
     the run made (torch.cuda.memory_stats: device segments and requests;
     torch.cuda.host_memory_stats: pinned blocks made) and, where the
     checkout has them, the workspaces' peaks. The grid samplers' cells
     send no range: their traced runs read the run alone;
  4. with --parent DIR (another checkout, e.g. the parent commit unpacked
     with git archive): one traced run of it at the default threads, then
     N pairs of untraced runs, in the order parent, this, this, parent:
     TilerProcess.run's seconds (properties.json) and the process's wall;
  5. with --host-pairs N: N pairs of untraced runs of this checkout in the
     order host, card, card, host (the card run against the host run in
     one call).

Every run prints its points per second and its start split: the start
(launch to TilerProcess.run), the run (properties.json's durations) and
the run's end to the process's exit (from properties.json's modification
time to the exit, on the wall clock), and the parts the checkout's own
`start split:` log line names, where it has one (util/startup.py). An
untraced run imports nothing before cli.main, as the CLI does alone.

Every run's tree is held against the cell's manifest (benchmark_torch/);
a run that exits non-zero or writes another tree fails the command. The
last line of standard output is one JSON object. --rehearse runs steps
1-4 on the CPU (--use-device cpu, the rehearsal input of bench_torch.py,
no range reaches the card) to check the plumbing; its numbers are no
device's.
"""
from __future__ import annotations

import argparse
import atexit
import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import bench_torch as bt

CELLS = tuple(c["name"] for c in bt.load_benchmark()["workloads"])
WORK = os.path.join(bt.ROOT, ".bench_k2_path_work")
PARTS = ("upload", "prep", "kernel", "download")
DEVICE_STATS = ("segment.all.allocated", "allocation.all.allocated",
                "reserved_bytes.all.peak", "num_alloc_retries")
HOST_STATS = ("num_host_alloc", "allocations.allocated",
              "allocated_bytes.peak")


# -- one CLI run in a fresh process ---------------------------------------------

def child(argv) -> int:
    """`run`: cli.main of the checkout at --root on the arguments after
    `--`, with K2's range trace on under --trace; writes what it read to
    --result."""
    ap = argparse.ArgumentParser(prog="bench_k2_path.py run")
    ap.add_argument("--root", required=True)
    ap.add_argument("--result", required=True)
    ap.add_argument("--trace", action="store_true")
    ap.add_argument("cli", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cli_args = args.cli[1:] if args.cli[:1] == ["--"] else args.cli
    sys.path.insert(0, args.root)

    from schwarzwald_tpu_torch import cli
    try:  # the exit line of the start split, as the CLI's program logs it
        from schwarzwald_tpu_torch.util import startup
        atexit.register(startup.log_at_exit)
    except ImportError:  # a checkout from before the start split
        pass

    if args.trace:
        from schwarzwald_tpu_torch.ops import poisson_cuda

        poisson_cuda.trace = []
    t0 = time.perf_counter()
    rc = cli.main(cli_args)
    seconds = time.perf_counter() - t0
    out = {"rc": rc, "main_s": seconds, "k2": {"launches": 0},
           "prep_launches": 0, "ranges": 0}
    if "torch" not in sys.modules:  # a run that never imported torch
        with open(args.result, "w") as f:
            json.dump(out, f)
        return int(rc or 0)
    import torch

    from schwarzwald_tpu_torch.ops import poisson_cuda

    ranges, poisson_cuda.trace = poisson_cuda.trace or [], None
    out.update(k2=poisson_cuda.snapshot(), ranges=len(ranges),
               prep_launches=getattr(poisson_cuda, "prep_launches", None))
    for part in PARTS:
        for kind in ("", "host_", "cpu_"):
            key = f"{kind}{part}_ms"
            out[key] = sum(r.get(key, 0.0) for r in ranges)
        out[f"unexplained_{part}_ms"] = sum(unexplained_ms(r, part)
                                            for r in ranges)
    out["sender_wall_ms"] = sum((r["t1"] - r["t0"]) * 1e3 for r in ranges)
    out["wait_ms"] = sum(r.get("wait_ms", 0.0) for r in ranges)
    out["threads"] = len({r["thread"] for r in ranges})
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        stats = torch.cuda.memory_stats()
        out["device"] = {k: stats.get(k) for k in DEVICE_STATS}
        host = getattr(torch.cuda, "host_memory_stats", None)
        if host is not None:
            stats = host()
            out["pinned"] = {k: stats.get(k) for k in HOST_STATS}
        out["streams"] = poisson_cuda.stream_stats()
        ws = getattr(poisson_cuda, "workspace_stats", None)
        if ws is not None:
            out["workspaces"] = ws()
    with open(args.result, "w") as f:
        json.dump(out, f)
    return int(rc or 0)


def unexplained_ms(record: dict, part: str) -> float:
    """The wall of one part of one traced range that neither its stream
    time nor its thread's CPU time explains: max(0, wall - max(stream,
    CPU)). Time the thread waited (for the interpreter lock, the host's
    scheduler, or in a synchronise) that the stream's span does not
    cover."""
    wall = record.get(f"host_{part}_ms", 0.0)
    return max(0.0, wall - max(record.get(f"{part}_ms", 0.0),
                               record.get(f"cpu_{part}_ms", 0.0)))


def build(root: str, rehearse: bool) -> None:
    """The kernels of the checkout at `root`, built in a process of their
    own (so the runs find them up to date): each csrc/*.cu it has."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from schwarzwald_tpu_torch import native; native._lib()")
    if not rehearse:
        csrc = os.path.join(root, "schwarzwald_tpu_torch", "csrc")
        names = sorted(f[:-3] for f in os.listdir(csrc) if f.endswith(".cu"))
        code += ("; from schwarzwald_tpu_torch.ops._cuda_build import "
                 "load_kernel_library as k; "
                 + "; ".join(f"k({name!r})" for name in names))
    subprocess.run([sys.executable, "-c", code, root], check=True, cwd=root)


def run(work: str, root: str, cli_args: list, trace: bool, manifest: dict,
        label: str, points: int) -> dict:
    """One CLI run of the checkout at `root` in a fresh process; its start
    split; its tree held against the manifest."""
    out_dir = os.path.join(work, "out")
    shutil.rmtree(out_dir, ignore_errors=True)
    result = os.path.join(work, "result.json")
    log = os.path.join(work, "run.log")
    cmd = [sys.executable, os.path.abspath(__file__), "run", "--root", root,
           "--result", result, *(["--trace"] if trace else []), "--",
           "--tiler", *cli_args, "-o", out_dir]
    env = dict(os.environ, SCHWARZWALD_TPU_NO_UI="1", PYTHONPATH=root)
    t0 = time.perf_counter()
    with open(log, "w") as f:
        proc = subprocess.run(cmd, cwd=root, env=env, stdout=f,
                              stderr=subprocess.STDOUT,
                              timeout=bt.RUN_TIMEOUT_S)
    exited = time.time()
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: exit {proc.returncode}: "
                           f"{bt.log_tail(log)}")
    with open(result) as f:
        got = json.load(f)
    # this checkout's parser: a child of another checkout must import
    # that checkout's package first, so this process imports it here only
    from schwarzwald_tpu_torch.util import startup

    with open(log, errors="replace") as f:
        text = f.read()
    tile_s = bt.tile_seconds(out_dir)
    ended = os.stat(os.path.join(out_dir, "properties.json")).st_mtime_ns
    exit_s = exited - ended / 1e9
    split = startup.parse(text)
    got.update(label=label, wall_s=wall, tile_s=tile_s,
               points_per_s=points / wall, start_s=wall - tile_s - exit_s,
               exit_s=exit_s, split=split,
               files=bt.compare_tree(out_dir, manifest["tree"]),
               # what an OpenMP runtime printed (two are loaded: the
               # native library's and torch's)
               omp_lines=[line for line in text.splitlines()
                          if "OMP: " in line or "libgomp" in line])
    if split and startup.AT_EXIT in split:
        # the part of the exit after the interpreter's exit handlers
        got["teardown_s"] = exited - split[startup.AT_EXIT]
    return got


def describe(r: dict) -> str:
    text = (f"{r['label']}: {r['points_per_s']:.0f} points/s, wall "
            f"{r['wall_s']:.3f} s: start {r['start_s']:.3f} s, "
            f"TilerProcess.run {r['tile_s']:.3f} s, run to exit "
            f"{r['exit_s']:.3f} s; tree identical ({r['files']} files)")
    if r["split"]:
        text += "\n  start split: " + ", ".join(
            f"{k} {v:.3f} s" for k, v in r["split"].items()
            if "(epoch)" not in k)
    if r["omp_lines"]:
        text += f"\n  OpenMP printed: {r['omp_lines'][:5]}"
    if "teardown_s" in r:
        text += (f"; of the run to exit, {r['teardown_s']:.3f} s after the "
                 f"exit handlers")
    if not r["ranges"]:
        return text
    split = "; ".join(f"{p} {r[f'{p}_ms']:.1f} / {r[f'host_{p}_ms']:.1f} / "
                      f"{r[f'cpu_{p}_ms']:.1f} / "
                      f"{r.get(f'unexplained_{p}_ms', 0.0):.1f}"
                      for p in PARTS)
    text += (f"\n  {r['ranges']} ranges from {r['threads']} threads, K2 "
             f"launches {r['k2']['launches']}, prep launches "
             f"{r['prep_launches']}; per part, stream / wall / CPU / "
             f"unexplained wall ms summed over the ranges: {split} "
             f"(unexplained in all "
             f"{sum(r.get(f'unexplained_{p}_ms', 0.0) for p in PARTS):.1f});"
             f" final synchronise {r['wait_ms']:.1f}; sending threads' wall "
             f"{r['sender_wall_ms']:.1f} ms")
    for key in ("device", "pinned", "workspaces", "streams"):
        if key in r:
            text += f"\n  {key}: {r[key]}"
    return text


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["run"]:
        return child(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cell", default=CELLS[0], choices=CELLS)
    ap.add_argument("--threads", default="1,2,4,8,default")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--pairs", type=int, default=3)
    ap.add_argument("--host-pairs", type=int, default=0)
    ap.add_argument("--rehearse", action="store_true")
    args = ap.parse_args(argv)
    work = WORK
    rehearse = args.rehearse
    if not rehearse:
        import torch

        if not torch.cuda.is_available():
            print("bench_k2_path: FAIL: no CUDA card", file=sys.stderr)
            return 1
        print(bt.nvidia_smi(), flush=True)
    cell = {c["name"]: c for c in bt.load_benchmark()["workloads"]}[
        args.cell]
    with open(bt.manifest_path(args.cell, rehearse)) as f:
        seed = json.load(f)["seed"]
    manifest = bt.load_manifest(args.cell, seed, rehearse)
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    roots = {"this": bt.ROOT}
    if args.parent:
        roots["parent"] = os.path.abspath(args.parent)
    try:
        t0 = time.perf_counter()
        for root in roots.values():
            build(root, rehearse)
        paths, points, _ = bt.write_inputs(cell["traffic"], seed,
                                           os.path.join(work, "input"),
                                           rehearse)
        drawn = {os.path.basename(p): bt.file_digest(p) for p in paths}
        if drawn != manifest["input"]:
            raise RuntimeError("the input drawn is not the reference's")
        print(f"built and drawn in {time.perf_counter() - t0:.1f} s: "
              f"{points} points", flush=True)
        flags = ["-i", paths[0], *bt.config_argv(cell["config"],
                                                 cell["traffic"], rehearse)]
        device = ["--use-device", "cpu" if rehearse else "cuda"]
        runs = [run(work, bt.ROOT, flags + ["--use-device", "host"], False,
                    manifest, "host", points)]
        print(describe(runs[-1]), flush=True)
        for t in args.threads.split(","):
            extra = [] if t == "default" else ["--threads", t]
            runs.append(run(work, bt.ROOT, flags + device + extra, True,
                            manifest, f"this, traced, threads {t}", points))
            print(describe(runs[-1]), flush=True)
        if args.parent:
            runs.append(run(work, roots["parent"], flags + device, True,
                            manifest, "parent, traced, threads default",
                            points))
            print(describe(runs[-1]), flush=True)
            for i in range(args.pairs):
                for name in ("parent", "this", "this", "parent"):
                    runs.append(run(work, roots[name], flags + device, False,
                                    manifest, f"{name}, timed, pair {i}",
                                    points))
                    print(describe(runs[-1]), flush=True)
        for i in range(args.host_pairs):
            for name in ("host", "card", "card", "host"):
                runs.append(run(work, bt.ROOT, flags + (
                    ["--use-device", "host"] if name == "host" else device),
                    False, manifest, f"{name}, timed, pair {i}", points))
                print(describe(runs[-1]), flush=True)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    summary = {"points": points, "runs": runs}
    timed = {}
    for r in runs:
        if ", timed" in r["label"]:
            timed.setdefault(r["label"].split(",")[0], []).append(r)
    for name, rs in timed.items():
        summary[f"{name}_tile_s_median"] = statistics.median(
            r["tile_s"] for r in rs)
        summary[f"{name}_wall_s_median"] = statistics.median(
            r["wall_s"] for r in rs)
        summary[f"{name}_points_per_s_median"] = statistics.median(
            points / r["wall_s"] for r in rs)
        for part in ("start", "exit"):
            summary[f"{name}_{part}_s_median"] = statistics.median(
                r[f"{part}_s"] for r in rs)
    if "host" in timed:
        # each card run against the host run beside it in its pair
        summary["card_minus_host_tile_s_median"] = statistics.median(
            c["tile_s"] - h["tile_s"]
            for c, h in zip(timed["card"], timed["host"]))
        print(f"medians: host TilerProcess.run "
              f"{summary['host_tile_s_median']:.3f} s, card "
              f"{summary['card_tile_s_median']:.3f} s; card minus host, "
              f"run by run: {summary['card_minus_host_tile_s_median']:.3f} s",
              flush=True)
    if "parent" in timed:
        summary["this_over_parent_points_per_s"] = (
            summary["this_points_per_s_median"]
            / summary["parent_points_per_s_median"])
        print(f"medians: parent {summary['parent_points_per_s_median']:.0f}"
              f" points/s (TilerProcess.run "
              f"{summary['parent_tile_s_median']:.3f} s, start "
              f"{summary['parent_start_s_median']:.3f} s, to exit "
              f"{summary['parent_exit_s_median']:.3f} s), this "
              f"{summary['this_points_per_s_median']:.0f} points/s "
              f"({summary['this_tile_s_median']:.3f} s, start "
              f"{summary['this_start_s_median']:.3f} s, to exit "
              f"{summary['this_exit_s_median']:.3f} s): this / parent "
              f"{summary['this_over_parent_points_per_s']:.4f}", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
