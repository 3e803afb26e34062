"""schwarzwald_tpu_torch — the point-cloud tiler on PyTorch and CUDA.

The PyTorch + CUDA port of `schwarzwald_tpu` for NVIDIA Hopper (H100). The
host modules (I/O, Morton indexing, the tiling engine, the native C++
kernels) are the JAX package's own, copied so this package never imports
JAX. `--use-device cuda`, the default, selects the device paths: the
MIN_DISTANCE Poisson-disk accept mask of every large node range runs on
hand-written CUDA kernels (csrc/poisson.cu, ops/poisson_cuda.py), and the
grid samplers' fresh octree assignment is a level-synchronous sweep in
torch ops (ops/device_tiling.py). `--use-device host` is the native host
run, `--use-device cpu` the kernels' plain-torch versions. The batch step
(ops/device.py, entry.py; on the card by default) runs the Morton
interleave as a hand-written CUDA kernel (csrc/morton.cu,
ops/morton_cuda.py). `--multichip N` shards each batch over N devices
through a lossless exchange (ops/device.py ShardedExchange, on the cards,
N shards on fewer cards when need be); `--multihost i n` splits the files
and the octree over hosts that share the output directory
(parallel/multihost.py). Output is byte-identical to the host run, in
every output format (3D Tiles, BIN, BINZ, LAS, LAZ, ENTWINE_LAS,
ENTWINE_LAZ). `convert()` and `--converter` convert a tiled octree to 3D
Tiles, LAS or LAZ (process/converter.py), host work as in the JAX package.

Reference parity targets (cited throughout as reference file:line):
  - Octree structure & per-node point selection semantics:
    schwarzwald/core/tiling/{TilingAlgorithms,Sampling,OctreeAlgorithms}
  - Output formats: 3D Tiles (pnts + tileset.json), Entwine/EPT, LAS/LAZ,
    binary dumps: schwarzwald/core/io/
  - CLI surface: schwarzwald/executable/main.cpp
"""

# Keep large allocations on the brk heap instead of per-allocation mmaps:
# the tiler's hot loops allocate and free tens-of-MB numpy buffers every
# batch, and glibc's default M_MMAP_THRESHOLD returns each one to the OS on
# free, so every batch re-pays first-touch page faults (~45 MB/s on this
# deployment — measured ~20% of a gather-heavy out-of-core run). Tunable
# only via mallopt at runtime; harmless no-op on non-glibc platforms.
try:
    import ctypes as _ctypes

    _libc = _ctypes.CDLL(None, use_errno=True)
    _libc.mallopt(-3, 1 << 30)  # M_MMAP_THRESHOLD
    _libc.mallopt(-1, 1 << 30)  # M_TRIM_THRESHOLD
except Exception:
    _libc = None


def malloc_trim() -> bool:
    """Release free heap pages back to the OS (glibc malloc_trim(0)).

    The mallopt tuning above trades RSS for throughput: freed big
    buffers stay mapped so the next batch skips first-touch faults.
    SCHWARZWALD_MALLOC_TRIM=1 calls this once per checkpoint window
    (see process/tiler.py) for memory-constrained deployments — opt-in
    because re-faulting costs ~2x wall clock on big-tree runs while the
    peak RSS there is live data, not retained-free heap (measured, see
    README). glibc >= 2.8 releases interior free chunks page-wise, not
    just the heap top. Returns False when unavailable (non-glibc)."""
    try:
        return bool(_libc is not None and _libc.malloc_trim(0) >= 0)
    except Exception:
        return False

__version__ = "0.1.0"


def tile(sources, output_directory, **options):
    """High-level library entry point: tile LAS files into an octree.

    Equivalent to the CLI --tiler mode; `options` accepts the
    TilerArguments fields (spacing, diagonal_fraction, sampling_strategy,
    tiling_strategy, output_format, max_points_per_node, use_device, ...).
    `use_device` is "cuda" unless given ("cpu" or "host" otherwise), and
    raises without a card. `multichip=N` shards each batch over N devices
    (parallel/multidevice.py); `multihost_index=i, multihost_count=n` runs
    host i of n sharing `output_directory` (parallel/multihost.py).
    Returns the PerformanceStats of the run.

        import schwarzwald_tpu_torch as sz
        sz.tile(["cloud.las"], "out/")                     # on the card
        sz.tile(["cloud.las"], "out/", use_device="host")  # host only
        sz.tile(["cloud.las"], "out/", multichip=4)        # 4 shards
    """
    from .core.attributes import OutputFormat
    from .process.tiler_process import TilerArguments, TilerProcess

    if isinstance(sources, str):
        sources = [sources]
    fmt = options.get("output_format")
    if isinstance(fmt, str):
        options["output_format"] = OutputFormat(fmt)
    if not options.get("spacing") and not options.get("diagonal_fraction"):
        options["diagonal_fraction"] = 250
    args = TilerArguments(sources=list(sources),
                          output_directory=output_directory, **options)
    return TilerProcess(args).run()


def convert(source_folder, output_folder, output_format="3DTILES", **options):
    """High-level converter entry point (CLI --converter mode)."""
    from .process.converter import ConverterArguments, run_conversion

    run_conversion(ConverterArguments(
        source_folder=source_folder, output_folder=output_folder,
        output_format=output_format, **options))


def __getattr__(name):
    if name == "OutputFormat":
        from .core.attributes import OutputFormat
        return OutputFormat
    if name == "SamplingStrategy":
        from .ops.sampling import SamplingStrategy
        return SamplingStrategy
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
