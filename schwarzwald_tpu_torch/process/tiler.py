"""The Tiler runtime loop: double-buffered read/index overlap.

Parity: Tiler (schwarzwald/core/process/Tiler.cpp:203-551): per iteration,
a read stage decodes up to internal_cache_size points from the sources with
`read_concurrency` worker threads, while the index stage tiles the previous
batch; the two run concurrently and hand buffers over through a one-slot
queue (the queue plays the role of the producer/consumer semaphore pair,
Tiler.cpp:176-177, 543-551). The scheduler rebalances thread counts per
iteration from measured throughputs.
"""
from __future__ import annotations

import concurrent.futures
import os
import queue
import threading

from ..core.pointbuffer import PointBuffer
from ..ops.sampling import SamplingStrategy
from ..tiling import TilerMetaParameters, make_tiling_algorithm
from ..util.progress import LOADING, ThroughputSampler, Timer
from .scheduler import AdaptiveThreadCount, make_scheduler

MAX_OCTREE_LEVELS = 21


class Tiler:
    def __init__(self, dataset_metadata, meta: TilerMetaParameters,
                 sampling_strategy: SamplingStrategy, progress_reporter,
                 point_source, persistence, input_attributes,
                 thread_config=None, checkpoint_callback=None,
                 algorithm=None, checkpoint_interval_s: float = 0.0):
        import numpy as np

        self.meta = meta
        self.progress = progress_reporter
        self.point_source = point_source
        self.persistence = persistence
        self.input_attributes = input_attributes
        self.thread_config = thread_config or AdaptiveThreadCount(4)
        # Called after each fully indexed batch with the source cursor
        # snapshot taken when that batch finished reading — the
        # checkpoint/resume hook (new capability vs. the reference, which
        # is strictly one-shot; resume granularity is a batch boundary).
        self.checkpoint_callback = checkpoint_callback
        # Checkpoint cadence: a commit costs two fdatasync calls
        # (~0.1 s each on this deployment's filesystem), so out-of-core
        # runs amortize them over a time window instead of paying per
        # batch. Deferral applies ONLY to sinks that advertise
        # supports_deferred_commit (the packed spill arena, whose re-reads
        # come from its in-memory index): per-file staged sinks need the
        # per-batch commit for read-your-writes across batches. 0 keeps
        # the exact per-batch behavior; crash recovery granularity widens
        # to the window either way (resume re-reads the skipped batches).
        self.checkpoint_interval_s = checkpoint_interval_s

        bounds_cubic = dataset_metadata.total_bounds_cubic()
        ratio = np.log2(np.float32(
            bounds_cubic.extent()[0] / meta.spacing_at_root))
        if ratio >= MAX_OCTREE_LEVELS:
            raise RuntimeError(
                "spacing at root node is too small compared to bounds of data!")
        self.bounds = (dataset_metadata.total_bounds_cubic_at_origin()
                       if meta.shift_points_to_origin else bounds_cubic)

        self.algorithm = algorithm if algorithm is not None else \
            make_tiling_algorithm(meta.tiling_strategy, sampling_strategy,
                                  persistence, meta, progress_reporter)

    # -- read stage ---------------------------------------------------------

    def _read_pool(self, read_concurrency: int):
        """Persistent reader pool, grown when the adaptive scheduler raises
        the read concurrency (one pool per run, not per batch)."""
        pool = getattr(self, "_reader_pool", None)
        workers = max(1, read_concurrency)
        if pool is None or self._reader_pool_size < workers:
            if pool is not None:
                pool.shutdown(wait=True)
            pool = concurrent.futures.ThreadPoolExecutor(max_workers=workers)
            self._reader_pool = pool
            self._reader_pool_size = workers
        return pool

    def _read_batch_into_slot(self, read_concurrency: int, slot) -> PointBuffer | None:
        """Region-read path: fill a preallocated batch slot (positions,
        keys, attribute columns) via disjoint-region writes — the
        reference's preallocated double-buffer design (Tiler.cpp:235-236,
        376-405), which on this deployment also avoids re-faulting fresh
        pages every batch."""
        import numpy as np

        from ..core.pointbuffer import PointBuffer as PB

        target = self.meta.internal_cache_size
        chunk = self.meta.batch_read_size
        if slot.buffer is None:
            slot.buffer = PB.empty(target, self.input_attributes)
            slot.keys = np.empty(target, dtype=np.uint64)
        state = {"offset": 0}
        lock = threading.Lock()
        pool = self._read_pool(read_concurrency)

        def read_one() -> int:
            handle = self.point_source.lock_source()
            if handle is None:
                return 0
            try:
                with lock:
                    offset = state["offset"]
                    count = min(chunk, target - offset)
                    if count <= 0:
                        return 0
                    state["offset"] = offset + count  # reserve region
                n = self.point_source.read_next_into_region(
                    handle, count, slot.buffer, slot.keys, offset)
                if n < count:
                    with lock:
                        # return unused reservation (only safe because
                        # reads are effectively sequential per batch on
                        # the shared offset; shrink when we were the top)
                        if state["offset"] == offset + count:
                            state["offset"] = offset + n
                        else:
                            state["holes"] = state.get("holes", [])
                            state["holes"].append((offset + n, offset + count))
                return n
            finally:
                self.point_source.release_source(handle)

        while state["offset"] < target \
                and not self.point_source.all_exhausted():
            n_tasks = max(1, min(read_concurrency,
                                 -(-(target - state["offset"]) // chunk)))
            results = list(pool.map(lambda _: read_one(), range(n_tasks)))
            if not any(results):
                break

        holes = state.get("holes")
        if holes:
            # Compact rare short-read holes (corrupt/ignored files).
            self._compact_slot(slot, state["offset"], holes)
            total = state["offset"] - sum(b - a for a, b in holes)
        else:
            total = state["offset"]
        if total == 0:
            return None
        batch = slot.buffer.slice(0, total)
        batch.morton_keys = slot.keys[:total]
        if self.progress is not None:
            self.progress.increment(LOADING, total)
        return batch

    @staticmethod
    def _compact_slot(slot, end: int, holes) -> None:
        import numpy as np

        keep = np.ones(end, dtype=bool)
        for a, b in holes:
            keep[a:b] = False
        idx = np.flatnonzero(keep)
        slot.buffer.positions[:idx.size] = slot.buffer.positions[idx]
        slot.keys[:idx.size] = slot.keys[idx]
        for arr in slot.buffer.columns.values():
            arr[:idx.size] = arr[idx]

    def _read_batch(self, read_concurrency: int) -> PointBuffer | None:
        """Fill up to internal_cache_size points using a file-parallel pool
        (build_execution_graph_for_reading, Tiler.cpp:289-421)."""
        target = self.meta.internal_cache_size
        chunk = self.meta.batch_read_size
        collected: list[PointBuffer] = []
        total = 0
        lock = threading.Lock()

        def read_one() -> int:
            nonlocal total
            handle = self.point_source.lock_source()
            if handle is None:
                return 0
            try:
                buf = self.point_source.read_next_into(handle, chunk)
            finally:
                self.point_source.release_source(handle)
            with lock:
                if buf.count:
                    collected.append(buf)
                    total += buf.count
            return buf.count

        pool = self._read_pool(read_concurrency)
        while total < target and not self.point_source.all_exhausted():
            remaining = target - total
            n_tasks = max(1, min(read_concurrency,
                                 -(-remaining // chunk)))
            results = list(pool.map(lambda _: read_one(),
                                    range(n_tasks)))
            if not any(results):
                break

        if not collected:
            return None
        batch = PointBuffer.concatenate(collected)
        if self.progress is not None:
            self.progress.increment(LOADING, batch.count)
        return batch

    # -- main loop ----------------------------------------------------------

    def run(self) -> int:
        read_sampler = ThroughputSampler(1)
        index_sampler = ThroughputSampler(1)
        scheduler = make_scheduler(self.thread_config, read_sampler,
                                   index_sampler)

        handoff: queue.Queue = queue.Queue(maxsize=1)
        concurrency_box = {"read": 1}
        points_processed = 0

        from ..util.trace import trace_span

        class _Slot:
            def __init__(self):
                self.buffer = None
                self.keys = None
                # Released by the index loop only after process_batch is done
                # with the slot's views — the consumer-side semaphore of the
                # reference's swap handshake (Tiler.cpp:543-551). Without it
                # the reader could refill a slot the indexer still reads.
                self.free = threading.Semaphore(1)

        slots = [_Slot(), _Slot()]
        slot_box = {"idx": 0}

        def read_next_batch(read_c):
            if self.point_source.supports_region_reads:
                slot = slots[slot_box["idx"]]
                slot_box["idx"] ^= 1
                slot.free.acquire()
                return self._read_batch_into_slot(read_c, slot), slot
            return self._read_batch(read_c), None

        def reader():
            try:
                while True:
                    with trace_span("read_batch", "read"), Timer() as t:
                        batch, slot = read_next_batch(concurrency_box["read"])
                    if batch is None:
                        if slot is not None:
                            slot.free.release()
                        handoff.put(None)
                        return
                    read_sampler.push_sample(batch.count, t.seconds)
                    # snapshot after this batch's reads, before next start
                    handoff.put((batch,
                                 self.point_source.cursor_positions(), slot))
            except BaseException as err:  # propagate to the index loop
                handoff.put(err)

        read_c, index_c = scheduler.get_read_and_index_concurrency(
            self.point_source.max_parallelism())
        concurrency_box["read"] = read_c
        reader_thread = threading.Thread(target=reader, daemon=True)
        reader_thread.start()

        from ..util.config import global_config
        from ..util.journal import JournalStore

        journal = None
        if global_config().is_journaling_enabled:
            # throughput_stats journal (Tiler.cpp:45-62, 100-123)
            journal = JournalStore.global_store().new_journal(
                "throughput_stats").with_record_type(
                ["iteration", "read_throughput", "index_throughput",
                 "read_concurrency", "index_concurrency"]).as_csv(
                global_config().journal_directory).into_single_file().build()

        iteration = 0
        import time as _time

        deferral = (self.checkpoint_interval_s > 0 and getattr(
            self.persistence, "supports_deferred_commit", False))
        last_commit = _time.monotonic()
        batch_open = False
        while True:
            item = handoff.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            batch, cursor_snapshot, slot = item
            read_c, index_c = scheduler.get_read_and_index_concurrency(
                self.point_source.max_parallelism())
            concurrency_box["read"] = read_c
            with trace_span("index_batch", "index"), Timer() as t:
                try:
                    # Checkpointable runs stage node writes per batch; the
                    # checkpoint file's own rename rides in the SAME staging
                    # manifest as the node renames, so node state and resume
                    # state advance atomically — a crash at any instant
                    # leaves either both or neither reflecting this batch
                    # (see io/staging.py). Deferred-commit sinks widen the
                    # commit window to checkpoint_interval_s (see __init__).
                    staged = (self.checkpoint_callback is not None
                              and hasattr(self.persistence, "begin_batch"))
                    if staged and not batch_open:
                        self.persistence.begin_batch()
                        batch_open = True
                    self.algorithm.process_batch(batch, self.bounds)
                    points_processed += batch.count
                    due = (not deferral
                           or _time.monotonic() - last_commit
                           >= self.checkpoint_interval_s)
                    if staged and due:
                        rename = self.checkpoint_callback(
                            cursor_snapshot, points_processed, self.algorithm)
                        self.persistence.commit_batch(
                            [rename] if rename else None)
                        batch_open = False
                        last_commit = _time.monotonic()
                        if deferral and os.environ.get(
                                "SCHWARZWALD_MALLOC_TRIM"):
                            # Opt-in only: measured on the 100M uniform
                            # soak, a trim per checkpoint window HALVED
                            # throughput (0.208 -> 0.100 Mpts/s, pages
                            # re-faulted at ~45 MB/s) while peak RSS
                            # barely moved (18.7 -> 17.7 GB — the peak
                            # is live node cache + write-back window,
                            # not retained-free heap). Offered for
                            # memory-constrained deployments where RSS
                            # matters more than wall clock.
                            from .. import malloc_trim

                            malloc_trim()
                    elif self.checkpoint_callback is not None and not staged:
                        rename = self.checkpoint_callback(
                            cursor_snapshot, points_processed, self.algorithm)
                        if rename:
                            os.replace(*rename)
                finally:
                    if slot is not None:
                        slot.free.release()
            index_sampler.push_sample(batch.count, t.seconds)
            if journal is not None:
                journal.add_record([
                    iteration,
                    read_sampler.get_throughput_per_second(),
                    index_sampler.get_throughput_per_second(),
                    read_c, index_c])
            iteration += 1

        reader_thread.join()
        if getattr(self, "_reader_pool", None) is not None:
            self._reader_pool.shutdown(wait=True)
            self._reader_pool = None
        with trace_span("finalize_reconstruct_ancestors", "index"):
            self.algorithm.finalize(self.bounds)
        if journal is not None:
            journal.flush()
        return points_processed
