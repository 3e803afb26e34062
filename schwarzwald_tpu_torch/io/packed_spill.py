"""Packed single-file spill arena for the tiler's internal node traffic.

SURVEY hard part #5 / round-3 verdict item 2: the engine re-persists every
visited node on every batch, which on file-per-node sinks costs
O(batches x nodes) file creates + renames — the measured floor of the
out-of-core configs (100M soak at 0.13 Mpts/s) and a third of the
single-batch default config. This store sits between the engine and the
user-facing sink:

  * during tiling, node writes APPEND to one data file
    (<out>/.spill/data.bin, BIN-serialized extents) with an in-memory
    offset index — no file creates, no renames, sequential IO;
  * terminal nodes get true append semantics (append_points): the new
    batch extent is appended and retrieval returns extents NEWEST FIRST,
    exactly the reference's [batch_k, previous file content] concat
    order (tile_terminal_node, TilingAlgorithms.cpp:206-241), so no
    read-modify-write;
  * at close(), the live nodes DRAIN once into the wrapped sink (the
    user-facing format) — each output file is created exactly once per
    run instead of once per visit;
  * for LOSSY sinks (LAS/LAZ quantization) the spill stores the sink's
    simulate_retrieve() result, so every re-read during tiling returns
    byte-for-byte what the reference's write-then-re-read would have —
    output parity is preserved, and the drain's re-quantization is
    idempotent (positions already sit on the scale grid).

Crash consistency (--resume): writes between checkpoints live only in
memory + unjournaled data-file bytes. commit_batch() syncs the data file
and publishes this batch's index entries as a journal segment through the
SAME FileStaging manifest as the tiler checkpoint rename — segment and
checkpoint advance atomically (io/staging.py). On reopen, committed
segments rebuild the index and the data file is truncated to the last
committed extent; uncommitted tail bytes are discarded, mirroring the
abandoned-staged-files rule of the per-file protocol.

Multi-host runs get a PER-HOST arena (owned subtrees are disjoint); every
host drains it before the subtree_done barrier so the distributed
ancestor reconstruction reads real files; see TilerProcess and
parallel/multihost.py.
"""
from __future__ import annotations

import json
import os
import threading

import numpy as np

from ..core.aabb import AABB
from ..core.pointbuffer import PointBuffer
from . import bin_persistence as binio
from .staging import FileStaging


class PackedSpillStore:
    # Re-reads are served from the in-memory index + data file, never from
    # staged-vs-final paths, so the tiler may batch several process_batch
    # calls into one begin/commit window (checkpoint_interval_s).
    supports_deferred_commit = True

    # Write-back budget: dirty node versions live in memory and hit the
    # data file once per commit window (or when this many bytes
    # accumulate), not once per visit. Out-of-core revisits rewrite every
    # touched node every batch — write-through spilled ~tree_size bytes
    # per batch and the commit fdatasync is charged by BYTES on this
    # filesystem, so coalescing superseded versions is the lever. The
    # buffers are the same objects the engine's node cache holds
    # (references, not copies), so steady-state extra memory is bounded
    # by this budget only when the LRU evicts first.
    WRITEBACK_BUDGET = 256 << 20

    def __init__(self, inner, output_directory: str,
                 dir_name: str = ".spill"):
        self.inner = inner
        self.dir = os.path.join(output_directory, dir_name)
        os.makedirs(self.dir, exist_ok=True)
        self.data_path = os.path.join(self.dir, "data.bin")
        self._staging = FileStaging(self.dir)  # replays a mid-commit crash
        self._lock = threading.Lock()
        # name -> {"bounds": (min3, max3), "extents": [(off, len), ...]}
        # extents NEWEST FIRST (terminal concat order)
        self._index: dict[str, dict] = {}
        self._pending: list[dict] = []  # journal entries since last commit
        # write-back set: name -> {"op": "put"|"add", "bufs": [PointBuffer
        # NEWEST FIRST], "bounds": AABB}; "put" supersedes any flushed
        # extents, "add" stacks on top of them (terminal concat order)
        self._dirty: dict[str, dict] = {}
        self._dirty_bytes = 0
        self._segments = sorted(
            f for f in os.listdir(self.dir)
            if f.startswith("journal-") and f.endswith(".json"))
        committed_end = 0
        for seg in self._segments:
            doc = json.load(open(os.path.join(self.dir, seg)))
            for e in self._unpack_entries(doc):
                self._apply_entry(e)
            committed_end = doc["data_end"]
        # discard any uncommitted tail from a crashed batch
        if os.path.exists(self.data_path):
            if os.path.getsize(self.data_path) > committed_end:
                with open(self.data_path, "r+b") as f:
                    f.truncate(committed_end)
        # 1 MB userspace buffer: node blobs are a few KB and out-of-core
        # runs append tens of thousands per batch — the default 8 KB
        # buffer made nearly every blob a write(2)
        self._f = open(self.data_path, "ab", buffering=1 << 20)
        self._read_fd = os.open(self.data_path, os.O_RDONLY)
        self._drained = False
        # Snapshot the wrapped sink's pre-existing nodes ONCE (resumed
        # runs): node_exists is on the per-node hot path and a stat costs
        # ~1 ms on slow filesystems. The inner set only changes at drain.
        self._inner_names: set = set()
        if hasattr(self.inner, "node_names"):
            try:
                self._inner_names = set(self.inner.node_names())
            except Exception:
                pass

    # -- sink facade --------------------------------------------------------

    @property
    def is_lossless(self):
        return self.inner.is_lossless

    def simulate_retrieve(self, points: PointBuffer, bounds: AABB):
        return self.inner.simulate_retrieve(points, bounds)

    def _spillable(self, points: PointBuffer, bounds: AABB) -> PointBuffer:
        if self.inner.is_lossless:
            return points
        # store exactly what the wrapped sink's write-then-re-read would
        # return, so merge parity is preserved
        return self.inner.simulate_retrieve(points, bounds)

    def _append_blob(self, blob: bytes) -> tuple:
        off = self._f.tell()
        self._f.write(blob)
        return off, len(blob)

    def _record(self, op: str, name: str, off: int, length: int,
                bounds: AABB) -> list:
        # compact positional form: the journal holds one entry per node
        # write and out-of-core runs write hundreds of thousands — dict
        # keys tripled the json cost
        return [op, name, off, length,
                np.array(bounds.min, dtype=np.float64),
                np.array(bounds.max, dtype=np.float64)]

    def _apply_entry(self, e: list) -> None:
        op, name, off, length, bmin, bmax = e
        ext = (off, length)
        if op == "put" or name not in self._index:
            self._index[name] = {"bounds": (bmin, bmax), "extents": [ext]}
        else:
            # newest first: the latest append is read back first
            self._index[name]["extents"].insert(0, ext)

    @staticmethod
    def _buf_nbytes(points: PointBuffer) -> int:
        n = points.positions.nbytes
        for arr in points.columns.values():
            n += arr.nbytes
        return n

    def persist_points(self, points: PointBuffer, bounds: AABB,
                       node_name: str) -> None:
        buf = self._spillable(points, bounds)
        with self._lock:
            old = self._dirty.get(node_name)
            if old is not None:
                self._dirty_bytes -= sum(self._buf_nbytes(b)
                                         for b in old["bufs"])
            self._dirty[node_name] = {"op": "put", "bufs": [buf],
                                      "bounds": bounds}
            self._dirty_bytes += self._buf_nbytes(buf)
            if self._dirty_bytes > self.WRITEBACK_BUDGET:
                self._flush_dirty_locked()

    def append_points(self, points: PointBuffer, bounds: AABB,
                      node_name: str) -> None:
        """Terminal-node append: new extent first on retrieval."""
        buf = self._spillable(points, bounds)
        with self._lock:
            entry = self._dirty.get(node_name)
            if entry is None:
                entry = self._dirty[node_name] = {"op": "add", "bufs": [],
                                                  "bounds": bounds}
                if (node_name not in self._index
                        and node_name in self._inner_names):
                    # Appending over a node that exists ONLY as a wrapped
                    # sink file (a resumed run whose prior session did not
                    # use the spill): adopt the file's points as the
                    # OLDEST extent, else retrieve_points would skip the
                    # inner fallback (a record now exists here) and the
                    # drain would overwrite the file with the new points
                    # only — silently losing the previous session's data.
                    prior = self.inner.retrieve_points(node_name)
                    if prior.count:
                        entry["bufs"].append(prior)  # oldest last
                        self._dirty_bytes += self._buf_nbytes(prior)
            entry["bufs"].insert(0, buf)  # newest first
            entry["bounds"] = bounds
            self._dirty_bytes += self._buf_nbytes(buf)
            if self._dirty_bytes > self.WRITEBACK_BUDGET:
                self._flush_dirty_locked()

    def _flush_dirty_locked(self) -> None:
        """Append every dirty version to the data file and record journal
        entries — called at commit (durability) or when the write-back
        budget overflows. Oldest version first, so _apply_entry's
        insert-at-front reproduces the newest-first extent order."""
        for name, entry in self._dirty.items():
            first = entry["op"] == "put"
            for buf in reversed(entry["bufs"]):  # oldest first
                blob = binio.serialize(buf)
                off, length = self._append_blob(blob)
                e = self._record("put" if first else "add", name, off,
                                 length, entry["bounds"])
                first = False
                self._apply_entry(e)
                self._pending.append(e)
        self._dirty.clear()
        self._dirty_bytes = 0

    def retrieve_points(self, node_name: str) -> PointBuffer:
        with self._lock:
            dirty = self._dirty.get(node_name)
            parts = list(dirty["bufs"]) if dirty is not None else []
            extents = []
            if dirty is None or dirty["op"] != "put":
                entry = self._index.get(node_name)
                if entry is not None:
                    self._f.flush()
                    extents = list(entry["extents"])
                elif dirty is None:
                    # not spilled this run: a resumed/pre-existing node of
                    # the wrapped sink (or another host's drained node)
                    return self.inner.retrieve_points(node_name)
        for off, length in extents:
            raw = os.pread(self._read_fd, length, off)
            parts.append(binio.deserialize(raw))
        if len(parts) == 1:
            return parts[0]
        return PointBuffer.concatenate(parts)

    def node_exists(self, node_name: str) -> bool:
        with self._lock:
            if node_name in self._dirty or node_name in self._index:
                return True
        return node_name in self._inner_names

    def node_names(self) -> list:
        with self._lock:
            names = set(self._index)
            names.update(self._dirty)
        names.update(self._inner_names)
        return sorted(names)

    # -- batch atomicity ----------------------------------------------------

    def begin_batch(self) -> None:
        self._staging.begin()

    def commit_batch(self, extra_renames=None) -> None:
        with self._lock:
            self._flush_dirty_locked()
            self._f.flush()
            # fdatasync: data + the size metadata needed to read it back
            # (POSIX guarantees both); skips the inode timestamp flush
            # that made fsync ~80 ms/call on this deployment
            os.fdatasync(self._f.fileno())
            data_end = self._f.tell()
            pending, self._pending = self._pending, []
            seg_name = f"journal-{len(self._segments):06d}.json"
            self._segments.append(seg_name)
        seg_path = os.path.join(self.dir, seg_name)
        staged = self._staging.path_for(seg_path)
        with open(staged, "w") as f:
            json.dump(self._pack_entries(pending, data_end), f)
            f.flush()
            os.fdatasync(f.fileno())
        self._staging.commit(extra_renames)

    @staticmethod
    def _pack_entries(pending: list, data_end: int) -> dict:
        """Columnar segment layout: out-of-core batches journal thousands
        of entries, and the positional-list JSON (6 nested lists + 6 float
        reprs per entry) dominated commit cost. ops ride as a 'p'/'a'
        string, names newline-joined, offsets/lengths/bounds as base64
        little-endian arrays. The loader accepts this and the legacy
        "entries" layout."""
        import base64

        n = len(pending)
        offs = np.empty(n, dtype="<u8")
        lens = np.empty(n, dtype="<u8")
        bounds = np.empty((n, 6), dtype="<f8")
        names = []
        ops = []
        for i, (op, name, off, length, bmin, bmax) in enumerate(pending):
            ops.append("p" if op == "put" else "a")
            names.append(name)
            offs[i] = off
            lens[i] = length
            bounds[i, :3] = bmin
            bounds[i, 3:] = bmax
        return {"packed": {
            "ops": "".join(ops),
            "names": "\n".join(names),
            "offs": base64.b64encode(offs.tobytes()).decode(),
            "lens": base64.b64encode(lens.tobytes()).decode(),
            "bounds": base64.b64encode(bounds.tobytes()).decode(),
        }, "data_end": data_end}

    @staticmethod
    def _unpack_entries(doc: dict):
        import base64

        if "packed" not in doc:
            yield from doc["entries"]
            return
        p = doc["packed"]
        if not p["ops"]:
            return
        offs = np.frombuffer(base64.b64decode(p["offs"]), dtype="<u8")
        lens = np.frombuffer(base64.b64decode(p["lens"]), dtype="<u8")
        bounds = np.frombuffer(base64.b64decode(p["bounds"]),
                               dtype="<f8").reshape(-1, 6)
        names = p["names"].split("\n")
        for i, op in enumerate(p["ops"]):
            yield ["put" if op == "p" else "add", names[i], int(offs[i]),
                   int(lens[i]), bounds[i, :3].tolist(),
                   bounds[i, 3:].tolist()]

    # -- drain --------------------------------------------------------------

    def drain(self) -> None:
        """Write every live node once through the wrapped sink. Dirty
        (never-flushed) versions drain straight from memory — their bytes
        never touch the data file."""
        if self._drained:
            return
        self._drained = True
        with self._lock:
            names = sorted(set(self._index) | set(self._dirty))
        for name in names:
            dirty = self._dirty.get(name)
            if dirty is not None and (dirty["op"] == "put"
                                      or name not in self._index):
                bounds = dirty["bounds"]
                if not isinstance(bounds, AABB):
                    bounds = AABB(np.asarray(bounds[0]),
                                  np.asarray(bounds[1]))
            else:
                entry = self._index[name]
                bounds = AABB(np.asarray(entry["bounds"][0]),
                              np.asarray(entry["bounds"][1]))
            self.inner.persist_points(self.retrieve_points(name), bounds,
                                      name)

    def drain_and_discard(self) -> None:
        """Drain into the wrapped sink and delete the spill scratch WITHOUT
        closing the wrapped sink — multihost hosts publish their subtree
        this way before the subtree_done barrier (only host 0 closes the
        shared sink / writes the index artifacts)."""
        self.drain()
        # idempotent fd teardown: multihost finalize drains the arena and
        # TilerProcess.close() drains again later — a second os.close on
        # the same fd NUMBER could close an unrelated live fd the kernel
        # reused in between
        try:
            if self._f is not None:
                self._f.close()
                self._f = None
            if self._read_fd >= 0:
                os.close(self._read_fd)
                self._read_fd = -1
        except Exception:
            pass
        # the spill is scratch space: remove it once the sink owns the data
        import shutil

        shutil.rmtree(self.dir, ignore_errors=True)

    def close(self) -> None:
        self.drain_and_discard()
        self.inner.close()
