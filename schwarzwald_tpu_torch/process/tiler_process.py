"""TilerProcess: end-to-end tiler driver.

Parity: TilerProcess (schwarzwald/core/process/TilerProcess.cpp): expand
directories to files, existence/format checks honoring IgnoreErrors
(:157-197), attribute intersection across files + clamping to the output
format's supported set (determine_input_and_output_attributes, :262-350),
per-file metadata scan with SRS-transformed bounds (:352-387), spacing from
the cubic-bounds diagonal when -d is set (:598-604), persistence/sampling/
tiler construction with the 3DTILES center-shift + f32-truncate transform
chain (:539-561), properties.json and ept.json outputs (:75-151, 664-682).
"""
from __future__ import annotations

import base64
import dataclasses
import json
import os
import shutil
import time

import numpy as np

from ..core.aabb import AABB
from ..core.attributes import (OutputFormat, PointAttribute, RGBMapping,
                               supported_output_attributes_for_format)
from ..core.metadata import DatasetMetadata
from ..core.pointbuffer import PointBuffer
from ..io import las
from ..io.persistence import make_persistence
from ..io.point_source import MultiReaderPointSource
from ..io.srs import make_transform
from ..ops.sampling import SamplingStrategy
from ..tiling import TilerMetaParameters, TilingStrategy
from ..util import log, startup
from ..util.errors import IgnoreErrors, chain_error
from ..util.progress import INDEXING, LOADING, ProgressReporter
from .scheduler import AdaptiveThreadCount, FixedThreadCount
from .tiler import Tiler

SUPPORTED_EXTENSIONS = (".las", ".laz")


@dataclasses.dataclass
class TilerArguments:
    sources: list
    output_directory: str
    spacing: float = 0.0
    diagonal_fraction: int = 0
    max_depth: int = -1
    max_points_per_node: int = 20_000
    internal_cache_size: int = 10_000_000
    max_batch_read_size: int = 1_000_000
    sampling_strategy: str = "MIN_DISTANCE"
    tiling_strategy: str = "FAST"
    output_format: OutputFormat = OutputFormat.CZM_3DTILES
    rgb_mapping: RGBMapping = RGBMapping.Nothing
    source_projection: str | None = None
    errors_to_ignore: IgnoreErrors = IgnoreErrors.NONE
    thread_config: object = None
    journal: bool = False
    # Resume an interrupted run from the per-batch checkpoint
    # (tiler_state.json). New capability vs. the reference (which wipes the
    # output and restarts, TilerProcess.cpp:47-73); granularity is a batch
    # boundary — the on-disk octree is consistent between batches because
    # nodes are re-read + merged on every visit (TilingAlgorithms.cpp:50-109).
    resume: bool = False
    # Device selection (cuda/cpu/host): with a device, the grid samplers
    # run the octree sweep and MIN_DISTANCE* ranges the Poisson kernels;
    # host is the native host run (ops/device_start.resolve_use_device).
    use_device: str = "cuda"
    # In-memory node cache size in bytes (--cache-size); see
    # TilerMetaParameters.cache_size_bytes. Default matches the CLI's
    # 512 MiB — out-of-core revisits re-read every touched node per batch
    # (TilingAlgorithms.cpp:50-109), and serving those from memory also
    # preserves the re-derived-key memo (engine._read_cached_points).
    cache_size_bytes: int = 512 << 20
    # Multi-chip mesh size (0 = single device); see TilerMetaParameters.
    multichip: int = 0
    # Multi-host tiling over a shared output filesystem: this process's
    # index and the total process count (parallel.multihost — file
    # assignment + octree-block ownership + filesystem point exchange).
    # count <= 1 = single host.
    multihost_index: int = 0
    multihost_count: int = 1
    # Spill internal node traffic to a packed single-file arena and write
    # the user-facing files once at the end (io/packed_spill.py). On by
    # default; --no-packed-spill restores per-visit file writes.
    packed_spill: bool = True
    # Opt into LAS 1.4 layered (v3) LAZ output when the input demands
    # extended-range attributes; without it compressed output downgrades
    # to the legacy interoperable formats 0-3 (see LASPersistence).
    laz_extended_output: bool = False
    # Pin FAST's start-node level instead of estimating it from the first
    # batch (None = estimate). First-class hook used by tests and by
    # operators who want reproducible structure across runs with
    # different batch orders; mirrors multihost's plan.start_level pin.
    fixed_start_level: int | None = None
    # Minimum seconds between durable checkpoints for sinks that support
    # deferred commits (the packed spill arena): a commit costs two
    # fdatasync calls (~0.2 s on this deployment), so out-of-core runs
    # amortize them over a window. 0 = checkpoint after every batch.
    # Crash-recovery granularity widens to the window; output bytes are
    # unaffected (resume simply re-reads the uncommitted batches).
    checkpoint_interval_s: float = 10.0


@dataclasses.dataclass
class PerformanceStats:
    prepare_duration_ms: int = 0
    indexing_duration_ms: int = 0
    points_processed: int = 0


def write_properties_json(output_directory: str, bounds: AABB,
                          root_spacing: float, perf: PerformanceStats) -> None:
    """properties.json (TilerProcess.cpp:75-151)."""
    doc = {
        "source_properties": {
            "bounds": {"min": [*map(float, bounds.min)],
                       "max": [*map(float, bounds.max)]},
            "root_spacing": float(root_spacing),
            "processed_points": perf.points_processed,
        },
        "performance_stats": {
            "prepare_duration": perf.prepare_duration_ms,
            "indexing_duration": perf.indexing_duration_ms,
        },
    }
    with open(os.path.join(output_directory, "properties.json"), "w") as f:
        json.dump(doc, f, separators=(",", ":"))


def device_stats(algorithm) -> dict:
    """The device observability of a run: grid-sampler sweeps persisted and
    sweeps whose range went to the host recursion at re-rooting depths;
    under --multichip also the shards, the cards they run on, the points
    each shard owned and the exchange's seconds per batch; under
    --multihost the wall seconds of each step on this host."""
    host_steps = getattr(algorithm, "seconds", None)
    algorithm = getattr(algorithm, "inner", algorithm)  # multihost
    stats = {
        "device_sweeps_ok": getattr(algorithm, "device_sweeps_ok", 0),
        "device_reroots": getattr(algorithm, "device_reroots", 0),
    }
    if host_steps is not None:
        stats["multihost_s"] = dict(host_steps)
    exchange = getattr(algorithm, "exchange", None)
    if exchange is not None:
        stats.update(
            shards=exchange.n_dev,
            cards=len({d for d in exchange.mesh if d.type == "cuda"}),
            points_per_shard=list(exchange.owned_points),
            exchange_s=list(exchange.route_seconds))
    return stats


class TilerProcess:
    def __init__(self, args: TilerArguments):
        self.args = args
        self.input_attributes: set = set()
        self.extended_formats = False
        self.output_attributes: set = set()
        self.progress = ProgressReporter()

    # -- prepare ------------------------------------------------------------

    def _expand_sources(self) -> list:
        """Directories -> all LAS/LAZ files within (recursively)."""
        out = []
        for source in self.args.sources:
            if os.path.isdir(source):
                for root, _, files in os.walk(source):
                    for name in sorted(files):
                        if name.lower().endswith(SUPPORTED_EXTENSIONS):
                            out.append(os.path.join(root, name))
            else:
                out.append(source)
        return out

    def _check_file(self, path: str) -> bool:
        ignore = self.args.errors_to_ignore
        if not os.path.exists(path):
            if ignore & IgnoreErrors.MISSING_FILES:
                log.warn(f"Ignoring missing file {path}")
                return False
            raise FileNotFoundError(path)
        if not path.lower().endswith(SUPPORTED_EXTENSIONS):
            if ignore & IgnoreErrors.UNSUPPORTED_FILE_FORMAT:
                log.warn(f"Ignoring file with unsupported format {path}")
                return False
            raise ValueError(f"Unsupported file format: {path}")
        return True

    def _prepare_output_directory(self) -> None:
        """Wipe existing output (TilerProcess.cpp:47-73)."""
        out = self.args.output_directory
        if os.path.exists(out):
            log.info("Output directory not empty, removing existing files")
            for entry in os.listdir(out):
                if self.args.journal and entry == "journal":
                    continue
                full = os.path.join(out, entry)
                shutil.rmtree(full) if os.path.isdir(full) else os.remove(full)
        else:
            os.makedirs(out, exist_ok=True)

    def _determine_attributes(self, files: list) -> None:
        """Intersect attributes over all file headers, then clamp to the
        output format's supported set (TilerProcess.cpp:262-350). Files
        missing attributes that others have are reported — an error unless
        MISSING_POINT_ATTRIBUTES is ignored
        (check_for_missing_point_attributes, TilerProcess.cpp:437-489)."""
        per_file: dict[str, set] = {}
        self.extended_formats = False
        for path in files:
            try:
                f = las.LASFile(path)
            except Exception as err:
                if self.args.errors_to_ignore & IgnoreErrors.INACCESSIBLE_FILES:
                    log.warn(f"Ignoring inaccessible file {path}: {err}")
                    continue
                raise chain_error(err, f"Could not read attributes of {path}")
            per_file[path] = f.attributes()
            if las.base_point_format(f.header.point_data_format) >= 6:
                # extended-range source attributes (4-bit return counts,
                # 8-bit classifications): LAS/LAZ outputs must emit LAS 1.4
                # formats 6/7 or truncate them
                self.extended_formats = True
        if not per_file:
            raise RuntimeError("Found no input attributes to process")
        union: set = set().union(*per_file.values())
        common: set = set.intersection(*per_file.values())
        for path, attrs in per_file.items():
            missing = union - attrs
            if not missing:
                continue
            from ..core.attributes import print_attributes
            msg = (f"Missing attribute(s) {print_attributes(missing)} "
                   f"in file {path}")
            if self.args.errors_to_ignore & IgnoreErrors.MISSING_POINT_ATTRIBUTES:
                log.warn(msg)
            else:
                raise RuntimeError(msg)
        supported = supported_output_attributes_for_format(
            self.args.output_format)
        unsupported = common - supported
        if unsupported:
            from ..core.attributes import print_attributes
            log.warn(
                f"Not all point attributes in the input files are supported "
                f"by output format {self.args.output_format.value}; "
                f"attributes {print_attributes(unsupported)} will be ignored")
        # the reference REMOVES unsupported attributes from the input set
        # (TilerProcess.cpp:343-347) — they are neither decoded nor carried
        self.input_attributes = common & supported
        self.output_attributes = common & supported
        if self.args.rgb_mapping != RGBMapping.Nothing:
            self.output_attributes.add(PointAttribute.RGB)
            # the mapping computes RGB from intensity at write time
            if PointAttribute.Intensity in common:
                self.input_attributes.add(PointAttribute.Intensity)

    def _calculate_dataset_metadata(self, files: list,
                                    transform) -> DatasetMetadata:
        metadata = DatasetMetadata()
        for path in files:
            try:
                f = las.LASFile(path)
            except Exception as err:
                if self.args.errors_to_ignore & IgnoreErrors.INACCESSIBLE_FILES:
                    log.warn(f"Ignoring file {path} during metadata scan: {err}")
                    continue
                raise chain_error(err, "Calculating dataset metadata failed")
            bounds = transform.transform_aabb(f.header.bounds())
            metadata.add_file_metadata(path, f.count, bounds)
        return metadata

    # -- run ----------------------------------------------------------------

    def run(self) -> PerformanceStats:
        from ..ops import device_start
        from ..util.config import configure

        prepare_start = time.perf_counter()
        # resolved and set up before the output is touched (cli.main has
        # done both already): cuda raises without a card, and the host run
        # imports no torch
        use_device = device_start.resolve_use_device(self.args.use_device)
        device_start.set_up(use_device, self.args.sampling_strategy)

        files = [p for p in self._expand_sources() if self._check_file(p)]
        if not files:
            raise RuntimeError("No point files to process")

        multihost = self.args.multihost_count > 1
        is_primary = not multihost or self.args.multihost_index == 0

        state_path = os.path.join(self.args.output_directory,
                                  "tiler_state.json")
        # The checkpoint file is READ only after make_persistence below:
        # sink construction replays any pending staging manifest
        # (io/staging.py), which can legitimately advance the checkpoint
        # when the previous run crashed mid-commit.
        resume_requested = self.args.resume and os.path.exists(state_path)
        if resume_requested:
            if multihost:
                raise RuntimeError("--resume is not supported with multihost")
        elif is_primary:
            self._prepare_output_directory()

        mh_coord = None
        if multihost:
            from ..parallel.multihost import MultiHostCoordinator
            os.makedirs(self.args.output_directory, exist_ok=True)
            # The coordinator constructor is itself the 'prepared'
            # handshake: host 0 publishes a run nonce, others block on it
            # and join the nonce-named exchange directory.
            mh_coord = MultiHostCoordinator(self.args.output_directory,
                                            self.args.multihost_index,
                                            self.args.multihost_count)
        configure(self.args.output_directory, self.args.journal)
        if self.args.journal:
            # Chrome-trace of the read/index pipeline (the reference's
            # tf::ChromeObserver equivalent, Scheduler.cpp:86-105).
            from ..util.trace import enable_tracing
            tracer = enable_tracing()
        else:
            tracer = None
        self._determine_attributes(files)

        transform = make_transform(self.args.source_projection)
        metadata = self._calculate_dataset_metadata(files, transform)
        total_count = metadata.total_points_count()
        if not total_count:
            raise RuntimeError("Found no points to process")
        cubic_bounds = metadata.total_bounds_cubic()
        log.info(f"Total points: {total_count}")

        if self.args.diagonal_fraction:
            self.args.spacing = float(np.float32(
                cubic_bounds.diagonal_length() / self.args.diagonal_fraction))
            log.info(f"Spacing calculated from diagonal: {self.args.spacing}")
        if self.args.spacing <= 0:
            raise RuntimeError("Spacing or diagonal fraction must be set")

        self.progress.register_progress_counter(LOADING, total_count)
        self.progress.register_progress_counter(INDEXING, total_count)

        persistence = make_persistence(
            self.args.output_format, self.args.output_directory,
            self.input_attributes, self.output_attributes,
            self.args.rgb_mapping, self.args.spacing, cubic_bounds,
            extended=self.extended_formats,
            laz_extended_output=self.args.laz_extended_output)
        n_batches = -(-total_count // max(1, self.args.max_batch_read_size))
        if self.args.packed_spill and n_batches >= 3:
            # Internal node traffic goes to the packed spill arena; the
            # user-facing files are written once at close (drain). Only
            # for genuinely out-of-core runs (>= 3 batches): a single-
            # batch run writes every node exactly once anyway, so the
            # arena round-trip would be pure overhead (~0.3 s/1M
            # measured). Multi-host runs get a PER-HOST arena (owned
            # subtrees are disjoint); every host publishes its arena via
            # drain_and_discard before the subtree_done barrier so the
            # distributed ancestor reconstruction reads real files
            # (parallel/multihost.py).
            from ..io.packed_spill import PackedSpillStore
            suffix = (f"_h{self.args.multihost_index}" if multihost else "")
            persistence = PackedSpillStore(persistence,
                                           self.args.output_directory,
                                           dir_name=".spill" + suffix)

        resume_state = None
        if resume_requested:
            # Read AFTER sink construction so a manifest replay (crash
            # mid-commit) is reflected in what we resume from.
            resume_state = json.load(open(state_path))
            log.info(f"Resuming from checkpoint: "
                     f"{resume_state.get('points_processed', 0)} points "
                     f"already processed")

        shift_to_center = self.args.output_format == OutputFormat.CZM_3DTILES
        max_depth = (100 if self.args.max_depth <= 0
                     else self.args.max_depth)

        thread_config = self.args.thread_config or AdaptiveThreadCount(
            os.cpu_count() or 4)
        if isinstance(thread_config, FixedThreadCount):
            # never more read threads than files (TilerProcess.cpp:389-434)
            if len(files) < thread_config.num_threads_for_reading:
                diff = thread_config.num_threads_for_reading - len(files)
                thread_config = FixedThreadCount(
                    len(files), thread_config.num_threads_for_indexing + diff)
        concurrency = (thread_config.num_threads_for_indexing
                       if isinstance(thread_config, FixedThreadCount)
                       else thread_config.num_threads)

        meta = TilerMetaParameters(
            spacing_at_root=self.args.spacing,
            max_depth=max_depth,
            max_points_per_node=self.args.max_points_per_node,
            internal_cache_size=self.args.internal_cache_size,
            batch_read_size=self.args.max_batch_read_size,
            tiling_strategy=TilingStrategy(self.args.tiling_strategy),
            shift_points_to_origin=shift_to_center,
            concurrency=max(1, concurrency),
            use_device=use_device,
            cache_size_bytes=self.args.cache_size_bytes,
            multichip=self.args.multichip,
        )

        mh_plan = None
        mh_algorithm = None
        if mh_coord is not None:
            from ..parallel.multihost import plan_multihost_tiling
            files_with_counts = [
                (path, count) for path, (count, _bounds)
                in metadata.get_all_files_metadata().items()]
            mh_plan = plan_multihost_tiling(
                files_with_counts, metadata.total_bounds_tight(),
                start_level=3,
                process_index=self.args.multihost_index,
                process_count=self.args.multihost_count)
            files = mh_plan.local_files
            log.info(f"Multi-host {mh_plan.process_index}/"
                     f"{mh_plan.process_count}: {len(files)} local files, "
                     f"owned node block {mh_plan.owned_node_range}")

        source = MultiReaderPointSource(files, self.args.errors_to_ignore)
        source.set_attributes(self.input_attributes)
        center = cubic_bounds.center()

        def transform_chain(buf: PointBuffer) -> PointBuffer:
            if buf.count == 0:
                return buf
            buf.positions = transform.transform_positions(buf.positions)
            if shift_to_center:
                # Shift to cloud center + truncate to f32 for lossless pnts
                # storage (TilerProcess.cpp:546-561).
                shifted = buf.positions - center
                buf.positions = shifted.astype(np.float32).astype(np.float64)
            return buf

        source.add_transformation(transform_chain)
        if self.args.source_projection is None:
            # No SRS reprojection -> the whole decode + shift + clamp +
            # Morton-encode pipeline fuses into one native read pass.
            tiler_bounds = (metadata.total_bounds_cubic_at_origin()
                            if shift_to_center else cubic_bounds)
            source.enable_fused_indexing(shift_to_center, center,
                                         tiler_bounds.min, tiler_bounds.max)

        sampling_strategy = SamplingStrategy(self.args.sampling_strategy,
                                             self.args.max_points_per_node)

        resumed_points = 0
        if resume_state is not None:
            source.restore_positions(resume_state.get("files", {}))
            resumed_points = int(resume_state.get("points_processed", 0))

        def checkpoint(cursor_snapshot, points_processed, algorithm):
            # Writes the new state to a tmp file and returns the
            # (tmp, final) rename pair; the Tiler folds the rename into the
            # batch's atomic staging commit (or applies it directly when
            # the sink has no staging), so the checkpoint can never point
            # at a batch whose node writes didn't commit, nor vice versa.
            # start_nodes_used can reach tens of thousands of (key, level)
            # pairs out-of-core; packed little-endian u64/u8 arrays keep
            # the per-batch checkpoint write O(bytes), not O(json tokens)
            used = sorted(getattr(algorithm, "_start_nodes_used", ()))
            keys = np.array([k for k, _ in used], dtype="<u8")
            lvls = np.array([lv for _, lv in used], dtype=np.uint8)
            state = {
                "files": cursor_snapshot,
                "points_processed": resumed_points + points_processed,
                "level_of_start_nodes":
                    getattr(algorithm, "level_of_start_nodes", None),
                "start_nodes_packed": {
                    "keys": base64.b64encode(keys.tobytes()).decode(),
                    "levels": base64.b64encode(lvls.tobytes()).decode(),
                },
            }
            tmp = state_path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(state, f)
            return (tmp, state_path)

        if mh_plan is not None:
            from ..parallel.multihost import TilingAlgorithmMultiHost
            if meta.tiling_strategy != TilingStrategy.Fast:
                # the static Morton-block ownership requires FAST's fixed
                # start level; silently running a different strategy than
                # requested would be worse than refusing (the
                # level_of_start_nodes setter raises for the same reason)
                raise RuntimeError(
                    f"--multihost requires the FAST tiling strategy "
                    f"(got {meta.tiling_strategy.name}): octree ownership "
                    f"is a fixed start-level Morton-block partition")
            mh_algorithm = TilingAlgorithmMultiHost(
                sampling_strategy, persistence, meta, mh_plan, mh_coord,
                self.progress)

        tiler = Tiler(metadata, meta, sampling_strategy, self.progress,
                      source, persistence, self.input_attributes,
                      thread_config,
                      # single-batch runs skip checkpoint+staging: a crash
                      # restarts from scratch either way, and the staging
                      # renames cost one metadata op per node file
                      checkpoint_callback=None if (multihost
                                                   or n_batches <= 1)
                      else checkpoint,
                      algorithm=mh_algorithm,
                      checkpoint_interval_s=self.args.checkpoint_interval_s)
        # total dataset size for the FAST start-level estimator's cap
        # (see _estimate_start_node_level) — the metadata scan knows it
        # before the first batch
        tiler.algorithm.total_points_hint = total_count
        if (self.args.fixed_start_level is not None
                and hasattr(tiler.algorithm, "level_of_start_nodes")):
            tiler.algorithm.level_of_start_nodes = \
                int(self.args.fixed_start_level)
        if resume_state is not None:
            level = resume_state.get("level_of_start_nodes")
            if level is not None and hasattr(tiler.algorithm,
                                             "level_of_start_nodes"):
                tiler.algorithm.level_of_start_nodes = int(level)
            if hasattr(tiler.algorithm, "_start_nodes_used"):
                packed = resume_state.get("start_nodes_packed")
                if packed is not None:
                    keys = np.frombuffer(
                        base64.b64decode(packed["keys"]), dtype="<u8")
                    lvls = np.frombuffer(
                        base64.b64decode(packed["levels"]), dtype=np.uint8)
                    tiler.algorithm._start_nodes_used.update(
                        zip(keys.tolist(), lvls.tolist()))
                else:  # legacy checkpoint layout (pre-packed)
                    tiler.algorithm._start_nodes_used.update(
                        (int(k), int(lv)) for k, lv in
                        resume_state.get("start_nodes_used", ()))
            self.progress.increment(INDEXING, resumed_points)
            self.progress.increment(LOADING, resumed_points)

        prepare_end = time.perf_counter()
        log.info(f"Using {self.args.sampling_strategy} sampling")

        indexing_start = time.perf_counter()
        if log.verbose and os.environ.get("SCHWARZWALD_TPU_NO_UI") is None:
            from ..util.terminal_ui import TerminalUI, TerminalUIAsyncRenderer
            with TerminalUIAsyncRenderer(TerminalUI(self.progress)):
                num_processed = tiler.run()
        else:
            num_processed = tiler.run()
        if is_primary:
            # multihost: only host 0 writes the index artifacts (tileset
            # forest / EPT hierarchy); the distributed finalize's last
            # barrier already published every host's files, and the sinks
            # reconcile the full node set from the shared output
            # directory on close.
            from ..util.trace import trace_span
            with trace_span("sink_close_drain_index", "io"):
                persistence.close()
        self.device_stats = device_stats(tiler.algorithm)
        log.info(f"Device stats: {self.device_stats}")
        indexing_end = time.perf_counter()

        stats = PerformanceStats(
            prepare_duration_ms=int((prepare_end - prepare_start) * 1000),
            indexing_duration_ms=int((indexing_end - indexing_start) * 1000),
            points_processed=total_count,
        )
        if tracer is not None:
            from ..util.config import global_config
            from ..util.journal import JournalStore
            tracer.write(os.path.join(global_config().journal_directory,
                                      "executor_trace.json"))
            JournalStore.global_store().flush_all()
        if is_primary:
            write_properties_json(self.args.output_directory, cubic_bounds,
                                  self.args.spacing, stats)
        if is_primary and os.path.exists(state_path):
            os.remove(state_path)  # run completed; checkpoint obsolete

        if is_primary and self.args.output_format in (
                OutputFormat.ENTWINE_LAS, OutputFormat.ENTWINE_LAZ):
            from ..io.entwine import (point_attributes_to_ept_schema,
                                      write_ept_json)
            write_ept_json(
                os.path.join(self.args.output_directory, "ept.json"),
                bounds=cubic_bounds, conforming_bounds=cubic_bounds,
                data_type=("laszip" if self.args.output_format
                           == OutputFormat.ENTWINE_LAZ else "las"),
                # multihost: host 0 processed only its own files; ept.json
                # describes the whole dataset
                points=total_count if multihost else num_processed,
                schema=point_attributes_to_ept_schema(self.output_attributes),
                span=self.args.spacing)

        indexed = self.progress.get_progress(INDEXING)
        dropped = total_count - indexed
        if dropped:
            log.info(f"Tiler finished with warnings - Indexed {indexed} out "
                     f"of {total_count} points ({dropped} points could not "
                     f"be indexed)")
        else:
            log.info(f"Tiler finished - Indexed {indexed} points")
        startup.add("TilerProcess.run", time.perf_counter() - prepare_start)
        startup.log_split()
        return stats
