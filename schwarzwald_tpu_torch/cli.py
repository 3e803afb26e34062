"""Command-line interface.

Flag surface parity with the reference executable
(schwarzwald/executable/main.cpp:190-577): --tiler / --converter modes,
spacing / diagonal-fraction, cache sizes with SI suffixes (parse_memory_size,
main.cpp:47-97), thread-count spec ("6" adaptive vs "2 6" fixed split,
main.cpp:99-146), compositional --ignore flags, sampling / tiling strategy
selection, and the converter options.
"""
from __future__ import annotations

import argparse
import atexit
import re
import sys

from .core.attributes import OutputFormat, RGBMapping
from .process.scheduler import AdaptiveThreadCount, FixedThreadCount
from .util.errors import parse_ignore_errors
from .util import log, startup

_MEMORY_SUFFIXES = {
    "B": 1, "KB": 10 ** 3, "MB": 10 ** 6, "GB": 10 ** 9, "TB": 10 ** 12,
    "KIB": 1 << 10, "MIB": 1 << 20, "GIB": 1 << 30, "TIB": 1 << 40,
}


def parse_memory_size(text: str) -> int:
    """'800MiB' / '256MB' -> bytes (parse_memory_size, main.cpp:47-97)."""
    m = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*([A-Za-z]+)?\s*", text)
    if not m:
        raise argparse.ArgumentTypeError(f"Invalid memory size: {text!r}")
    value = float(m.group(1))
    suffix = (m.group(2) or "B").upper()
    if suffix not in _MEMORY_SUFFIXES:
        raise argparse.ArgumentTypeError(
            f"Invalid memory size suffix in {text!r}")
    return int(value * _MEMORY_SUFFIXES[suffix])


def parse_threads(text: str):
    """'6' -> adaptive(6); '2 6' -> fixed(read=2, index=6)
    (parse_threads_count, main.cpp:99-146)."""
    parts = text.split()
    if len(parts) == 1:
        return AdaptiveThreadCount(int(parts[0]))
    if len(parts) == 2:
        return FixedThreadCount(int(parts[0]), int(parts[1]))
    raise argparse.ArgumentTypeError(
        f"--threads expects one or two numbers, got {text!r}")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="schwarzwald-tpu-torch",
        description="Point-cloud octree tiler on PyTorch + CUDA "
                    "(LAS/LAZ -> 3D Tiles / EPT / binary)")
    p.add_argument("--tiler", action="store_true",
                   help="Run the tiler process to generate an octree from "
                        "the source file(s).")
    p.add_argument("--converter", action="store_true",
                   help="Run the converter process to convert the octree "
                        "into a different file format.")
    p.add_argument("--source", "-i", nargs="+", default=[],
                   help="Input files and/or folders (LAS/LAZ).")
    p.add_argument("--outdir", "-o", default=".",
                   help="Output directory.")
    p.add_argument("--spacing", "-s", type=float, default=0.0,
                   help="Distance between points at root level; halves each "
                        "level.")
    p.add_argument("--spacing-by-diagonal-fraction", "-d", type=int,
                   default=0, dest="diagonal_fraction",
                   help="spacing = diagonal / value")
    p.add_argument("--max-points-per-node", type=int, default=20_000)
    p.add_argument("--internal-cache-size", type=int, default=10_000_000,
                   help="Number of points to cache before indexer has to run")
    p.add_argument("--batch-read-size", type=int, default=1_000_000,
                   help="Max points to read in a single batch from each file")
    p.add_argument("--output-format", default="3DTILES",
                   choices=["3DTILES", "ENTWINE_LAS", "ENTWINE_LAZ", "BIN",
                            "BINZ", "LAS", "LAZ"])
    p.add_argument("--sampling", default="MIN_DISTANCE",
                   choices=["RANDOM_GRID", "GRID_CENTER", "MIN_DISTANCE",
                            "MIN_DISTANCE_FAST", "JITTERED"])
    p.add_argument("--calculate-rgb-from", default="NONE",
                   choices=["NONE", "INTENSITY_LINEAR", "INTENSITY_LOG"])
    p.add_argument("--cache-size", type=parse_memory_size, default="512MiB",
                   help="In-memory node cache size with SI suffix "
                        "(e.g. 800MiB); 0 disables. Skips disk re-reads of "
                        "hot nodes for lossless outputs.")
    p.add_argument("--journal", action="store_true",
                   help="Write a detailed journal for performance analysis")
    p.add_argument("--source-projection", default=None,
                   help="Source spatial reference system of the points")
    p.add_argument("--ignore", nargs="*", default=[],
                   help="Error categories to ignore: MISSING_FILES, "
                        "INACCESSIBLE_FILES, UNSUPPORTED_FILE_FORMAT, "
                        "CORRUPTED_FILES, MISSING_POINT_ATTRIBUTES, "
                        "ALL_FILE_ERRORS, ALL_ERRORS, NONE")
    p.add_argument("--tiling-strategy", default="FAST",
                   choices=["FAST", "ACCURATE"])
    p.add_argument("--threads", type=parse_threads, default=None,
                   help='"6" = 6 adaptive threads; "2 6" = 2 read + 6 index')
    p.add_argument("--max-depth", type=int, default=-1,
                   help="Maximum tree depth (converter: levels to convert)")
    p.add_argument("--resume", action="store_true",
                   help="Resume an interrupted tiler run from its last "
                        "completed batch (tiler_state.json checkpoint)")
    p.add_argument("--delete-source", action="store_true",
                   help="(converter) delete source files once converted")
    p.add_argument("--use-device", default="cuda",
                   choices=["cuda", "cpu", "host"],
                   help="Device selection: cuda (the default; raises "
                        "without a card) runs the grid samplers' octree "
                        "sweep and the MIN_DISTANCE Poisson kernels on the "
                        "CUDA card, cpu their plain PyTorch versions, host "
                        "the native host kernels only")
    p.add_argument("--multichip", type=int, default=0,
                   help="Shard every batch's sort + octree split over N "
                        "shards (lossless point exchange to the owning "
                        "shard; FAST semantics at the ownership level 3). "
                        "Under --use-device cuda shard d runs on card "
                        "d %% (number of cards); under cpu or host on the "
                        "CPU")
    p.add_argument("--no-packed-spill", action="store_true",
                   help="Write user-facing node files on every visit "
                        "instead of spilling to the packed arena and "
                        "draining once at the end")
    p.add_argument("--checkpoint-interval", type=float, default=10.0,
                   metavar="SECONDS",
                   help="Minimum seconds between durable resume "
                        "checkpoints on packed-spill runs (0 = after "
                        "every batch; default 10). Output is unaffected; "
                        "a crash re-reads the window's batches")
    p.add_argument("--laz-extended-output", action="store_true",
                   help="Write LAS 1.4 layered (v3) LAZ when the input "
                        "demands extended-range attributes. Off by "
                        "default: the v3 context tables here are a "
                        "reconstruction, so compressed output downgrades "
                        "to the interoperable legacy formats 0-3 unless "
                        "this flag opts in (interop warning logged)")
    p.add_argument("--multihost", type=int, nargs=2, default=None,
                   metavar=("INDEX", "COUNT"),
                   help="Run as host INDEX of COUNT over a shared output "
                        "filesystem (per-host file assignment, octree-block "
                        "ownership, filesystem point exchange)")
    return p


def main(argv=None) -> int:
    startup.begin()
    args = build_parser().parse_args(argv)

    if args.converter:
        from .process.converter import ConverterArguments, run_conversion
        conv = ConverterArguments(
            source_folder=args.source[0] if args.source else ".",
            output_folder=args.outdir,
            output_format=args.output_format,
            source_projection=args.source_projection,
            max_depth=args.max_depth,
            delete_source=args.delete_source)
        run_conversion(conv)
        return 0

    if not args.tiler:
        log.write_log("Specify one of --tiler or --converter")
        return 2
    if not args.source:
        log.write_log("No input files (--source)")
        return 2
    if args.spacing == 0 and args.diagonal_fraction == 0:
        args.diagonal_fraction = 250  # default fallback (main.cpp:412-418)

    with startup.timed("port imports"):  # no torch (ops/device_start.py)
        from .ops import device_start
        from .process.tiler_process import TilerArguments, TilerProcess
    # the card's set-up before the run and before the output is touched:
    # cuda raises without a card, the host run imports no torch
    device_start.set_up(device_start.resolve_use_device(args.use_device),
                        args.sampling)
    targs = TilerArguments(
        sources=args.source,
        output_directory=args.outdir,
        spacing=args.spacing,
        diagonal_fraction=args.diagonal_fraction,
        max_depth=args.max_depth,
        max_points_per_node=args.max_points_per_node,
        internal_cache_size=args.internal_cache_size,
        max_batch_read_size=args.batch_read_size,
        sampling_strategy=args.sampling,
        tiling_strategy=args.tiling_strategy,
        output_format=OutputFormat(args.output_format),
        rgb_mapping={"NONE": RGBMapping.Nothing,
                     "INTENSITY_LINEAR": RGBMapping.FromIntensityLinear,
                     "INTENSITY_LOG": RGBMapping.FromIntensityLogarithmic}[
                         args.calculate_rgb_from],
        source_projection=args.source_projection,
        errors_to_ignore=parse_ignore_errors(args.ignore),
        thread_config=args.threads,
        journal=args.journal,
        resume=args.resume,
        use_device=args.use_device,
        cache_size_bytes=args.cache_size or 0,
        multichip=args.multichip,
        multihost_index=args.multihost[0] if args.multihost else 0,
        multihost_count=args.multihost[1] if args.multihost else 1,
        laz_extended_output=args.laz_extended_output,
        packed_spill=not args.no_packed_spill,
        checkpoint_interval_s=args.checkpoint_interval,
    )
    TilerProcess(targs).run()
    return 0


if __name__ == "__main__":
    atexit.register(startup.log_at_exit)
    sys.exit(main())
