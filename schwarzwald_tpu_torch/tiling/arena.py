"""Per-batch point arena: chunked SoA store with global-id gather.

Plays the role of PointsCache (TilingAlgorithms.h:22-46) + the reference's
IndexedPoint::point_reference indirection: tiling works on (key, global-id)
pairs, and point data (positions + attributes) is gathered from the arena
only when persisting a node.
"""
from __future__ import annotations

import threading

import numpy as np

from .. import native
from ..core.pointbuffer import PointBuffer


class PointArena:
    def __init__(self):
        self._chunks: list[PointBuffer] = []
        self._offsets = [0]
        # per-row chunk index (u32, capacity-doubled): lets the native
        # gather fuse locate+copy in one pass instead of a per-row binary
        # search over offsets (~2x on out-of-core persist gathers)
        self._chunk_map = np.empty(0, dtype=np.uint32)
        # appends come from concurrent subtree workers (_read_cached_points
        # during the start-node fan-out); reads of already-appended ids
        # are lock-free (grow-only: chunk lands before its offset entry)
        self._append_lock = threading.Lock()

    @property
    def count(self) -> int:
        return self._offsets[-1]

    # Position-gather scratch: CLASS-level thread-local so the buffer
    # survives across per-batch arena instances — out-of-core runs build a
    # fresh arena every batch, and re-faulting ~100 MB of fresh pages per
    # batch costs seconds on this deployment (first-touch ~45 MB/s).
    _scratch_tls = threading.local()

    # Shared grow-only iota: np.arange of tens of MB per batch is
    # measurably expensive on this deployment (first-touch page faults);
    # chunk-id ranges are views into one cached array instead.
    _iota = np.empty(0, dtype=np.int64)

    _iota_lock = threading.Lock()

    @classmethod
    def _iota_view(cls, start: int, stop: int) -> np.ndarray:
        with cls._iota_lock:
            if stop > cls._iota.size:
                cls._iota = np.arange(max(stop, 2 * cls._iota.size),
                                      dtype=np.int64)
            return cls._iota[start:stop]

    def append(self, buffer: PointBuffer) -> np.ndarray:
        """Add a chunk; returns the global ids of its points (a shared
        read-only view — copy before mutating)."""
        with self._append_lock:
            start = self._offsets[-1]
            end = start + buffer.count
            if end > self._chunk_map.size:
                grown = np.empty(max(end, 2 * self._chunk_map.size, 4096),
                                 dtype=np.uint32)
                grown[:start] = self._chunk_map[:start]
                self._chunk_map = grown
            self._chunk_map[start:end] = len(self._chunks)
            self._chunks.append(buffer)
            self._offsets.append(end)
            self._offsets_arr = None  # invalidate the cached array
        return self._iota_view(start, end)

    _offsets_arr = None

    # -- native two-level-indirection gather -------------------------------
    #
    # numpy cannot express out[i] = chunks[chunk_ids[i]][local[i]] without
    # a python loop over chunk runs (argsort + per-run fancy indexing);
    # the native gather_rows kernel does it in one flat pass — measured 9x
    # faster for f64x3 rows on this deployment. Base-pointer tables are
    # cached per column and invalidated by appends (keyed on chunk count).

    def _ptr_table(self, attr):
        """(ptrs, row_bytes) for positions (attr None) or a column, or
        None when any chunk's array is non-contiguous / row-shape-mismatched
        (callers fall back to the numpy run loop).

        Built INCREMENTALLY: out-of-core revisits append a chunk per
        cached-node read and gather thousands of times per batch — a
        full rebuild per append made this O(chunks x gathers) (measured
        4 s of a 19 s multihost run). Entry: [n_seen, ptrs(capacity),
        row_bytes, dtype]; only chunks past n_seen are scanned. A
        mismatch poisons the attr permanently (the table must cover every
        chunk, so later appends can never un-poison it)."""
        cache = getattr(self, "_ptrs_cache", None)
        if cache is None:
            with self._append_lock:
                cache = getattr(self, "_ptrs_cache", None)
                if cache is None:
                    cache = self._ptrs_cache = {}
        ent = cache.get(attr)
        if ent is None:
            with self._append_lock:
                ent = cache.get(attr)
                if ent is None:
                    ent = cache[attr] = [0, np.empty(64, dtype=np.uint64),
                                         None, None]
        seen = ent[0]  # single read: a concurrent poison sets it to None
        if seen is None:
            return None  # poisoned
        n_chunks = len(self._chunks)
        if n_chunks > seen:
            # extension mutates shared entry state: serialize with the
            # append lock (concurrent subtree workers gather while others
            # append); double-checked inside
            with self._append_lock:
                if ent[0] is None:
                    return None
                n_seen, ptrs, row_bytes, dtype = ent
                if n_chunks > n_seen:
                    if n_chunks > ptrs.size:
                        grown = np.empty(max(n_chunks, 2 * ptrs.size),
                                         dtype=np.uint64)
                        grown[:n_seen] = ptrs[:n_seen]
                        ptrs = ent[1] = grown
                    for i in range(n_seen, n_chunks):
                        c = self._chunks[i]
                        a = (c.positions if attr is None
                             else c.columns.get(attr))
                        if a is None or not a.flags.c_contiguous:
                            ent[0] = None
                            return None
                        # C-contiguous row stride IS the row byte width —
                        # avoids a ~3 us np.prod per chunk
                        rb = (a.strides[0] if a.ndim > 1
                              else a.dtype.itemsize)
                        if row_bytes is None:
                            row_bytes, dtype = rb, a.dtype
                            ent[2], ent[3] = rb, a.dtype
                        elif rb != row_bytes or a.dtype != dtype:
                            # dtype check matters even at equal width: the
                            # numpy fallback value-casts on assignment,
                            # native bit-copies
                            ent[0] = None
                            return None
                        ptrs[i] = a.ctypes.data
                    ent[0] = n_chunks
        # views beyond n_chunks are never dereferenced (ids handed out
        # before this call never reference a later chunk)
        return ent[1][:n_chunks], ent[2]

    def _offsets_array(self) -> np.ndarray:
        # the offsets array is rebuilt only after appends: out-of-core
        # batches accumulate thousands of cached-read chunks and the
        # per-gather list->array conversion dominated _locate
        offsets = self._offsets_arr
        if offsets is None or offsets.size != len(self._offsets):
            offsets = self._offsets_arr = np.asarray(self._offsets,
                                                     dtype=np.int64)
        return offsets

    def _native_rows(self, lib, ptrs: np.ndarray, ids: np.ndarray,
                     row_bytes: int, out: np.ndarray) -> None:
        """One native gather: single-chunk direct, multi-chunk through the
        fused chunk-map kernel (no per-row binary search)."""
        if len(self._chunks) == 1:
            lib.gather_rows(ptrs, None, ids, row_bytes, out)
        else:
            ids = np.ascontiguousarray(ids, dtype=np.int64)
            lib.gather_rows_mapped(ptrs, self._chunk_map,
                                   self._offsets_array(), ids, row_bytes,
                                   out)

    def _locate(self, ids: np.ndarray):
        offsets = self._offsets_array()
        lib = native._lib()
        if lib is not None and ids.dtype == np.int64 \
                and ids.flags.c_contiguous:
            return lib.locate_rows(offsets, ids)
        chunk_ids = np.searchsorted(offsets, ids, side="right") - 1
        local = ids - offsets[chunk_ids]
        return chunk_ids, local

    @staticmethod
    def _chunk_runs(chunk_ids: np.ndarray):
        """Group a gather by source chunk: (order, starts, ends) where
        order is a stable permutation sorting chunk_ids and starts/ends
        delimit the per-chunk runs. One argsort instead of a boolean mask
        per chunk — out-of-core batches carry thousands of cached-node
        chunks, and the per-chunk masks made positions() O(chunks x n)
        (measured 2 s per 2M-point merge; this path is ~50 ms)."""
        order = np.argsort(chunk_ids, kind="stable")
        sorted_ids = chunk_ids[order]
        if sorted_ids.size == 0:
            starts = np.empty(0, dtype=np.int64)
        else:
            changed = np.empty(sorted_ids.size, dtype=bool)
            changed[0] = True
            np.not_equal(sorted_ids[1:], sorted_ids[:-1], out=changed[1:])
            starts = np.flatnonzero(changed)
        ends = np.append(starts[1:], sorted_ids.size)
        return order, sorted_ids, starts, ends

    def positions(self, ids: np.ndarray) -> np.ndarray:
        out = np.empty((ids.size, 3), dtype=np.float64)
        lib = native._lib()
        if lib is not None:
            tab = self._ptr_table(None)
            if tab is not None and tab[1] == 24:
                self._native_rows(lib, tab[0], ids, 24, out)
                return out
        if len(self._chunks) == 1:
            return self._chunks[0].positions[ids]
        chunk_ids, local = self._locate(ids)
        c0 = chunk_ids[0] if ids.size else 0
        if ids.size and chunk_ids[-1] == c0 and (chunk_ids == c0).all():
            return self._chunks[c0].positions[local]
        order, sorted_ids, starts, ends = self._chunk_runs(chunk_ids)
        for s, e in zip(starts, ends):
            sel = order[s:e]
            out[sel] = self._chunks[sorted_ids[s]].positions[local[sel]]
        return out

    def positions_scratch(self, ids: np.ndarray) -> np.ndarray:
        """positions() into a reused grow-only scratch buffer — for callers
        that CONSUME the gather and never retain it (samplers). Avoids
        re-faulting fresh pages per node, the dominant cost of deep
        MIN_DISTANCE trees on this deployment's VM. The result is only
        valid until the next positions_scratch call on this arena FROM THE
        SAME THREAD — the buffer is thread-local so concurrent subtree
        workers never clobber each other's in-flight gathers."""
        n = ids.size
        tls = self._scratch_tls
        buf = getattr(tls, "pos", None)
        if buf is None or buf.shape[0] < n:
            buf = tls.pos = np.empty((max(n, 1024), 3), dtype=np.float64)
        out = buf[:n]
        lib = native._lib()
        if lib is not None:
            tab = self._ptr_table(None)
            if tab is not None and tab[1] == 24:
                self._native_rows(lib, tab[0], ids, 24, out)
                return out
        if len(self._chunks) == 1:
            np.take(self._chunks[0].positions, ids, axis=0, out=out)
            return out
        chunk_ids, local = self._locate(ids)
        c0 = chunk_ids[0] if n else 0
        if n and chunk_ids[-1] == c0 and (chunk_ids == c0).all():
            np.take(self._chunks[c0].positions, local, axis=0, out=out)
            return out
        order, sorted_ids, starts, ends = self._chunk_runs(chunk_ids)
        for s, e in zip(starts, ends):
            sel = order[s:e]
            out[sel] = self._chunks[sorted_ids[s]].positions[local[sel]]
        return out

    def _native_gather(self, lib, ids: np.ndarray):
        """gather() through the native kernel: positions + every common
        column in one flat pass each. Returns None (caller falls back to
        the numpy run loop) on non-contiguous / schema-mismatched chunks."""
        tab = self._ptr_table(None)
        if tab is None or tab[1] != 24:
            return None
        if len(self._chunks) == 1:
            ref_chunks = [self._chunks[0]]
        else:
            ids = np.ascontiguousarray(ids, dtype=np.int64)
            # referenced-chunk set for the column intersection: one pass
            # over the (already maintained) chunk map instead of a locate
            referenced = np.zeros(len(self._chunks), dtype=bool)
            referenced[self._chunk_map[ids]] = True
            ref_chunks = ([self._chunks[i] for i in np.flatnonzero(referenced)]
                          or [self._chunks[0]])
        common = set(ref_chunks[0].columns)
        for c in ref_chunks[1:]:
            common &= set(c.columns)
        tabs = {}
        for attr in common:
            t = self._ptr_table(attr)
            if t is None:
                return None
            tabs[attr] = t
        out = PointBuffer(np.empty((ids.size, 3), dtype=np.float64))
        self._native_rows(lib, tab[0], ids, 24, out.positions)
        cols = {}
        for attr in common:
            template = ref_chunks[0].columns[attr]
            dst = np.empty((ids.size,) + template.shape[1:],
                           dtype=template.dtype)
            self._native_rows(lib, tabs[attr][0], ids, tabs[attr][1], dst)
            cols[attr] = dst
        out.columns = cols
        return out

    def gather(self, ids: np.ndarray) -> PointBuffer:
        """Gather points in the given (arbitrary) order into a PointBuffer.

        Attributes: intersection across chunks (all chunks in one run share
        the input schema, so this is the identity in practice).
        """
        lib = native._lib()
        if lib is not None:
            buf = self._native_gather(lib, ids)
            if buf is not None:
                return buf
        if len(self._chunks) == 1:
            return self._chunks[0].take(ids)
        chunk_ids, local = self._locate(ids)
        c0 = chunk_ids[0] if ids.size else 0
        if ids.size and chunk_ids[-1] == c0 and (chunk_ids == c0).all():
            return self._chunks[c0].take(local)
        order, sorted_ids, starts, ends = self._chunk_runs(chunk_ids)
        uniq = sorted_ids[starts]
        common = set(self._chunks[uniq[0]].columns)
        for c in uniq[1:]:
            common &= set(self._chunks[c].columns)
        out = PointBuffer(np.empty((ids.size, 3), dtype=np.float64))
        cols = {}
        for attr in common:
            template = self._chunks[uniq[0]].columns[attr]
            cols[attr] = np.empty((ids.size,) + template.shape[1:],
                                  dtype=template.dtype)
        for s, e in zip(starts, ends):
            sel = order[s:e]
            chunk = self._chunks[sorted_ids[s]]
            out.positions[sel] = chunk.positions[local[sel]]
            for attr in common:
                cols[attr][sel] = chunk.columns[attr][local[sel]]
        out.columns = cols
        return out
