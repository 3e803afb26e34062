"""ctypes loader for the native kernels, with on-demand compilation.

The C++ sources in native/src are this package's own copy of the JAX
package's host kernels and LAZ codec (unchanged), so the port builds and
runs without that package's tree; the tests hold the two packages' codec
bytes and host-kernel results equal. The library builds into this
package's native/build/.
"""
from __future__ import annotations

import contextlib
import ctypes
import fcntl
import os
import subprocess
import threading

import numpy as np

_SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
_SRCS = [os.path.join(_SRC_DIR, "schwarzwald_native.cpp"),
         os.path.join(_SRC_DIR, "laz.cpp")]
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "build")
_SO = os.path.join(_BUILD_DIR, "libschwarzwald_native.so")

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
_i8p = np.ctypeslib.ndpointer(np.int8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
_i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")


_build_thread_lock = threading.Lock()


def is_fresh(target: str, sources) -> bool:
    return os.path.exists(target) and all(
        os.path.getmtime(target) >= os.path.getmtime(src) for src in sources)


@contextlib.contextmanager
def build_lock(directory: str):
    """Exclusive across threads of this process and across processes
    (test workers): first use can come from several of each at once."""
    os.makedirs(directory, exist_ok=True)
    with _build_thread_lock, open(os.path.join(directory, ".lock"),
                                  "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _ensure_built() -> str:
    if is_fresh(_SO, _SRCS):
        return _SO
    # build into a private name, then rename into place
    with build_lock(_BUILD_DIR):
        if is_fresh(_SO, _SRCS):
            return _SO
        tmp = f"{_SO}.{os.getpid()}.tmp"
        cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC",
               "-march=native", "-fopenmp", "-o", tmp] + _SRCS
        try:
            subprocess.run(cmd, check=True, capture_output=True)
        except subprocess.CalledProcessError:
            cmd.remove("-fopenmp")
            subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, _SO)
    return _SO


class NativeLib:
    def __init__(self, lib: ctypes.CDLL):
        self._lib = lib
        lib.poisson_accept_mask.argtypes = [
            _f64p, ctypes.c_int64, _f64p, _f64p, ctypes.c_double,
            ctypes.c_void_p, _u8p]
        lib.octree_sweep.argtypes = [
            _u64p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _f64p, _f64p, ctypes.c_double, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, _i8p]
        lib.grid_center_argmin.argtypes = [
            _u64p, _f64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _f64p, _f64p, _u8p]
        lib.jittered_argmin.argtypes = [
            _u64p, _f64p, ctypes.c_int64, ctypes.c_int32, ctypes.c_uint64,
            ctypes.c_int32, _f64p, ctypes.c_double, ctypes.c_double,
            _u32p, _u32p, _u32p, ctypes.c_int64, _u8p]
        lib.quantize_i32.argtypes = [
            _f64p, ctypes.c_int64, _f64p, _f64p, _i32p]
        lib.locate_rows.argtypes = [
            _i64p, ctypes.c_int64, _i64p, ctypes.c_int64, _i64p, _i64p]
        lib.gather_rows.argtypes = [
            _u64p, ctypes.c_void_p, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.gather_rows_mapped.argtypes = [
            _u64p, _u32p, _i64p, _i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p]
        lib.radix_argsort_u64.argtypes = [_u64p, ctypes.c_int64, _i64p]
        lib.radix_sort_kv_u64.argtypes = [_u64p, ctypes.c_int64, _i64p,
                                          _u64p]
        lib.index_points_fused.argtypes = [
            _f64p, ctypes.c_int64, _f64p, _f64p, _u64p]
        lib.las_decode_index_fused.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int32, _f64p, _f64p,
            ctypes.c_int32, _f64p, _f64p, _f64p, _f64p, _u64p]
        lib.las_decode.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _f64p, _f64p] + [ctypes.c_void_p] * 10
        lib.las_encode.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
            _f64p, _f64p] + [ctypes.c_void_p] * 9
        lib.laz_decode_points.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _u16p, _i32p, ctypes.c_int32, _u8p]
        lib.laz_decode_points.restype = ctypes.c_int64
        lib.laz_encode_stream.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int32,
            _u16p, _i32p, ctypes.c_int32, _u8p, ctypes.c_int64]
        lib.laz_encode_stream.restype = ctypes.c_int64
        lib.laz_read_chunk_table.argtypes = [
            _u8p, ctypes.c_int64, _u32p, ctypes.c_int64]
        lib.laz_read_chunk_table.restype = ctypes.c_int64
        lib.laz_read_chunk_table_variable.argtypes = [
            _u8p, ctypes.c_int64, _u32p, _u32p, ctypes.c_int64]
        lib.laz_read_chunk_table_variable.restype = ctypes.c_int64
        lib.laz_decode_chunks_parallel_v.argtypes = [
            _u8p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
            _u16p, _i32p, ctypes.c_int32, _u8p]
        lib.laz_decode_chunks_parallel_v.restype = ctypes.c_int64
        lib.laz_decode_chunks_parallel.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32,
            _i64p, ctypes.c_int64, _u16p, _i32p, ctypes.c_int32, _u8p]
        lib.laz_decode_chunks_parallel.restype = ctypes.c_int64
        # test-only coder primitive drivers (tests/test_laz_primitives.py)
        lib.laz_test_encode_symbols.argtypes = [
            _u32p, ctypes.c_int64, ctypes.c_uint32, _u8p, ctypes.c_int64]
        lib.laz_test_encode_symbols.restype = ctypes.c_int64
        lib.laz_test_decode_symbols.argtypes = [
            _u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_uint32, _u32p]
        lib.laz_test_decode_symbols.restype = ctypes.c_int64
        lib.laz_test_encode_bits.argtypes = [
            _u8p, ctypes.c_int64, _u8p, ctypes.c_int64]
        lib.laz_test_encode_bits.restype = ctypes.c_int64
        lib.laz_test_ic_compress.argtypes = [
            _i32p, _i32p, _u32p, ctypes.c_int64, ctypes.c_uint32,
            ctypes.c_uint32, _u8p, ctypes.c_int64]
        lib.laz_test_ic_compress.restype = ctypes.c_int64
        lib.laz_test_ic_decompress.argtypes = [
            _u8p, ctypes.c_int64, _i32p, _u32p, ctypes.c_int64,
            ctypes.c_uint32, ctypes.c_uint32, _i32p]
        lib.laz_test_ic_decompress.restype = ctypes.c_int64

    def poisson_accept_mask(self, positions, node_min, node_max, spacing,
                            analyze_mask=None) -> np.ndarray:
        if not (isinstance(positions, np.ndarray)
                and positions.dtype == np.float64
                and positions.flags.c_contiguous):
            positions = np.ascontiguousarray(positions, dtype=np.float64)
        n = positions.shape[0]
        out = np.empty(n, dtype=np.uint8)
        if analyze_mask is not None:
            analyze_mask = np.ascontiguousarray(analyze_mask, dtype=np.uint8)
            mask_ptr = analyze_mask.ctypes.data_as(ctypes.c_void_p)
        else:
            mask_ptr = None
        self._lib.poisson_accept_mask(
            positions, n,
            np.ascontiguousarray(node_min, dtype=np.float64),
            np.ascontiguousarray(node_max, dtype=np.float64),
            float(spacing), mask_ptr, out)
        # view, not astype: this wrapper runs once per node visit and the
        # extra n-byte copy was measurable at out-of-core visit counts
        return out.view(bool)

    SWEEP_STRATEGY_IDS = {"MIN_DISTANCE": 0, "MIN_DISTANCE_FAST": 1,
                          "RANDOM_GRID": 2, "GRID_CENTER": 3,
                          "JITTERED": 4}

    _perm_tables = None  # contiguous-u32 jitter tables, loaded once

    def octree_sweep(self, keys: np.ndarray, tiers, positions, strategy: str,
                     min_node_level: int, max_depth: int, max_points: int,
                     root_min, root_max, spacing_at_root: float,
                     cands) -> np.ndarray:
        """Host level-synchronous octree assignment over a merged
        (key asc, tier asc) array. Returns int8 levels (node_level + 2);
        0 = unassigned (re-rooting depths / JITTERED error grids — caller
        falls back to the recursion). tiers None = fresh batch; positions
        None is valid for RANDOM_GRID; cands None is valid for
        MIN_DISTANCE and JITTERED."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        n = keys.size
        out = np.zeros(n, dtype=np.int8)
        if tiers is not None:
            tiers = np.ascontiguousarray(tiers, dtype=np.int8)
        if positions is not None:
            positions = np.ascontiguousarray(positions, dtype=np.float64)
        if cands is not None:
            cands = np.ascontiguousarray(cands, dtype=np.int32)
        p16 = p32 = p64 = None
        if strategy == "JITTERED":
            if NativeLib._perm_tables is None:
                from ..ops import permutations
                NativeLib._perm_tables = tuple(
                    np.ascontiguousarray(t, dtype=np.uint32)
                    for t in (permutations.PERMUTATIONS_16,
                              permutations.PERMUTATIONS_32,
                              permutations.PERMUTATIONS_64))
            p16, p32, p64 = NativeLib._perm_tables
        self._lib.octree_sweep(
            keys,
            None if tiers is None else
            tiers.ctypes.data_as(ctypes.c_void_p),
            None if positions is None else
            positions.ctypes.data_as(ctypes.c_void_p),
            n, self.SWEEP_STRATEGY_IDS[strategy], min_node_level,
            max_depth, max_points,
            np.ascontiguousarray(root_min, dtype=np.float64),
            np.ascontiguousarray(root_max, dtype=np.float64),
            float(spacing_at_root),
            None if cands is None else
            cands.ctypes.data_as(ctypes.c_void_p),
            None if p16 is None else p16.ctypes.data_as(ctypes.c_void_p),
            None if p32 is None else p32.ctypes.data_as(ctypes.c_void_p),
            None if p64 is None else p64.ctypes.data_as(ctypes.c_void_p),
            out)
        return out

    def grid_center_argmin(self, keys: np.ndarray, positions: np.ndarray,
                           cand: int, root_min, root_max) -> np.ndarray:
        """GridCenterSampling selection mask over one sorted node range:
        per cand-level cell, the first point at minimum distance to the
        cell center (any NaN in a cell selects nothing — numpy reduceat
        parity). Caller handles take-all / cand==-1 short-circuits."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        positions = np.ascontiguousarray(positions, dtype=np.float64)
        out = np.zeros(keys.size, dtype=np.uint8)
        self._lib.grid_center_argmin(
            keys, positions, keys.size, 3 * (20 - cand), cand + 1,
            np.ascontiguousarray(root_min, dtype=np.float64),
            np.ascontiguousarray(root_max, dtype=np.float64), out)
        return out.view(bool)

    def jittered_argmin(self, keys: np.ndarray, positions: np.ndarray,
                        grid_level: int, levels: int, node_min,
                        grid_cell_size: float, permutation_cell_size: float,
                        p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                        plen: int) -> np.ndarray:
        """JitteredSampling selection mask: per grid-level cell, the first
        point at minimum distance to the cell's permutation-table target.
        Caller derives the grid parameters (and raises the reference's
        small-grid / too-deep errors) exactly as the numpy path."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        positions = np.ascontiguousarray(positions, dtype=np.float64)
        out = np.zeros(keys.size, dtype=np.uint8)
        self._lib.jittered_argmin(
            keys, positions, keys.size, 3 * (20 - grid_level),
            np.uint64((1 << (3 * levels)) - 1), levels,
            np.ascontiguousarray(node_min, dtype=np.float64),
            float(grid_cell_size), float(permutation_cell_size),
            np.ascontiguousarray(p0, dtype=np.uint32),
            np.ascontiguousarray(p1, dtype=np.uint32),
            np.ascontiguousarray(p2, dtype=np.uint32), int(plen), out)
        return out.view(bool)

    def quantize_i32(self, positions: np.ndarray, scale: np.ndarray,
                     offset: np.ndarray) -> np.ndarray:
        """Fused I32_QUANTIZE of an (n, 3) position block (bit-identical
        to the numpy subtract/divide/round-half-away/astype chain)."""
        positions = np.ascontiguousarray(positions, dtype=np.float64)
        out = np.empty((positions.shape[0], 3), dtype=np.int32)
        scale3 = np.ascontiguousarray(
            np.broadcast_to(np.asarray(scale, dtype=np.float64), 3))
        offset3 = np.ascontiguousarray(
            np.broadcast_to(np.asarray(offset, dtype=np.float64), 3))
        self._lib.quantize_i32(positions, positions.shape[0], scale3,
                               offset3, out)
        return out

    def locate_rows(self, offsets: np.ndarray, ids: np.ndarray) -> tuple:
        """(chunk_ids, local) for global row ids against sorted chunk
        offsets — fused searchsorted(right)-1 + subtract."""
        chunk_ids = np.empty(ids.size, dtype=np.int64)
        local = np.empty(ids.size, dtype=np.int64)
        self._lib.locate_rows(offsets, offsets.size, ids, ids.size,
                              chunk_ids, local)
        return chunk_ids, local

    def gather_rows_single(self, src: np.ndarray, idx: np.ndarray,
                           row_bytes: int, out: np.ndarray) -> None:
        """out[i] = row idx[i] of a single contiguous source array."""
        srcs = np.array([src.ctypes.data], dtype=np.uint64)
        self._lib.gather_rows(srcs, None, idx, idx.size, row_bytes,
                              out.ctypes.data_as(ctypes.c_void_p))

    def gather_rows(self, srcs: np.ndarray, chunk_ids, local: np.ndarray,
                    row_bytes: int, out: np.ndarray) -> None:
        """out[i] = row local[i] of the array whose base pointer is
        srcs[chunk_ids[i]] (srcs[0] for all rows when chunk_ids is None).
        Caller guarantees the source arrays are C-contiguous, alive, and
        row_bytes-wide; out must be C-contiguous with n*row_bytes bytes."""
        if chunk_ids is not None:
            chunk_ids = np.ascontiguousarray(chunk_ids, dtype=np.int64)
        local = np.ascontiguousarray(local, dtype=np.int64)
        self._lib.gather_rows(
            srcs,
            None if chunk_ids is None else
            chunk_ids.ctypes.data_as(ctypes.c_void_p),
            local, local.size, row_bytes,
            out.ctypes.data_as(ctypes.c_void_p))

    def gather_rows_mapped(self, srcs: np.ndarray, chunk_map: np.ndarray,
                           offsets: np.ndarray, ids: np.ndarray,
                           row_bytes: int, out: np.ndarray) -> None:
        """Fused locate+gather: out[i] = row (ids[i]-offsets[c]) of
        srcs[c], c = chunk_map[ids[i]] — one pass, no binary search."""
        self._lib.gather_rows_mapped(
            srcs, chunk_map, offsets, ids, ids.size, row_bytes,
            out.ctypes.data_as(ctypes.c_void_p))

    def radix_argsort(self, keys: np.ndarray) -> np.ndarray:
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty(keys.size, dtype=np.int64)
        self._lib.radix_argsort_u64(keys, keys.size, out)
        return out

    def radix_sort_kv(self, keys: np.ndarray) -> tuple:
        """(sorted_keys, order) in one pass (no host-side keys[order])."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        order = np.empty(keys.size, dtype=np.int64)
        sorted_keys = np.empty(keys.size, dtype=np.uint64)
        self._lib.radix_sort_kv_u64(keys, keys.size, order, sorted_keys)
        return sorted_keys, order

    def index_points_fused(self, positions: np.ndarray, bmin,
                           bmax) -> np.ndarray:
        """Clamps positions IN PLACE and returns Morton-63 keys."""
        assert positions.flags.c_contiguous
        keys = np.empty(positions.shape[0], dtype=np.uint64)
        self._lib.index_points_fused(
            positions, positions.shape[0],
            np.ascontiguousarray(bmin, dtype=np.float64),
            np.ascontiguousarray(bmax, dtype=np.float64), keys)
        return keys

    def las_decode_index_fused_into(self, records: np.ndarray, stride: int,
                                    las_scale, las_offset,
                                    shift_to_center: bool, center, bmin,
                                    bmax, positions_out: np.ndarray,
                                    keys_out: np.ndarray) -> None:
        """Decode into caller-provided (contiguous view) outputs."""
        n = keys_out.shape[0]
        assert positions_out.flags.c_contiguous
        assert keys_out.flags.c_contiguous
        self._lib.las_decode_index_fused(
            np.ascontiguousarray(records[:n * stride], dtype=np.uint8), n,
            stride,
            np.ascontiguousarray(las_scale, dtype=np.float64),
            np.ascontiguousarray(las_offset, dtype=np.float64),
            1 if shift_to_center else 0,
            np.ascontiguousarray(center, dtype=np.float64),
            np.ascontiguousarray(bmin, dtype=np.float64),
            np.ascontiguousarray(bmax, dtype=np.float64),
            positions_out, keys_out)

    def las_decode_index_fused(self, records: np.ndarray, stride: int,
                               las_scale, las_offset, shift_to_center: bool,
                               center, bmin, bmax):
        """Raw LAS records -> (positions f64 (N,3), keys u64)."""
        n = records.size // stride
        positions = np.empty((n, 3), dtype=np.float64)
        keys = np.empty(n, dtype=np.uint64)
        self._lib.las_decode_index_fused(
            np.ascontiguousarray(records, dtype=np.uint8), n, stride,
            np.ascontiguousarray(las_scale, dtype=np.float64),
            np.ascontiguousarray(las_offset, dtype=np.float64),
            1 if shift_to_center else 0,
            np.ascontiguousarray(center, dtype=np.float64),
            np.ascontiguousarray(bmin, dtype=np.float64),
            np.ascontiguousarray(bmax, dtype=np.float64),
            positions, keys)
        return positions, keys

    @staticmethod
    def _ptr(arr):
        return (arr.ctypes.data_as(ctypes.c_void_p)
                if arr is not None else None)

    def las_decode(self, records: np.ndarray, stride: int, fmt: int,
                   scale, offset, *, positions=None, intensity=None,
                   flags=None, classification=None, scan_angle=None,
                   user_data=None, point_source_id=None, gps_time=None,
                   rgb8=None, rgb16=None) -> None:
        n = records.size // stride
        self._lib.las_decode(
            np.ascontiguousarray(records, dtype=np.uint8), n, stride, fmt,
            np.ascontiguousarray(scale, dtype=np.float64),
            np.ascontiguousarray(offset, dtype=np.float64),
            self._ptr(positions), self._ptr(intensity), self._ptr(flags),
            self._ptr(classification), self._ptr(scan_angle),
            self._ptr(user_data), self._ptr(point_source_id),
            self._ptr(gps_time), self._ptr(rgb8), self._ptr(rgb16))

    def laz_decode_points(self, data: np.ndarray, n_points: int,
                          chunk_size: int, item_types: np.ndarray,
                          item_sizes: np.ndarray,
                          record_length: int) -> np.ndarray:
        """Decode complete chunks starting at data[0] into raw records."""
        out = np.empty(n_points * record_length, dtype=np.uint8)
        rc = self._lib.laz_decode_points(
            np.ascontiguousarray(data, dtype=np.uint8), data.size,
            n_points, chunk_size,
            np.ascontiguousarray(item_types, dtype=np.uint16),
            np.ascontiguousarray(item_sizes, dtype=np.int32),
            item_types.size, out)
        if rc < 0:
            raise ValueError(f"LAZ decode failed (code {rc})")
        return out

    def laz_encode_stream(self, records: np.ndarray,
                          record_length: int, chunk_size: int,
                          item_types: np.ndarray,
                          item_sizes: np.ndarray) -> np.ndarray:
        """Raw records -> complete chunked LAZ point-data stream.

        Returns a VIEW into a pooled per-thread scratch buffer — valid
        until this thread's next laz_encode_stream call (callers write it
        out immediately)."""
        import threading

        records = np.ascontiguousarray(records, dtype=np.uint8)
        n_points = records.size // record_length
        item_types = np.ascontiguousarray(item_types, dtype=np.uint16)
        item_sizes = np.ascontiguousarray(item_sizes, dtype=np.int32)
        capacity = records.size + records.size // 4 + 65536 \
            + (n_points // max(1, chunk_size) + 1) * (record_length + 32)
        tls = getattr(self, "_tls", None)
        if tls is None:
            tls = self._tls = threading.local()
        while True:
            out = getattr(tls, "laz_out", None)
            if out is None or out.size < capacity:
                out = tls.laz_out = np.empty(capacity, dtype=np.uint8)
            rc = self._lib.laz_encode_stream(
                records, n_points, chunk_size, item_types, item_sizes,
                item_types.size, out, out.size)
            if rc == -1:
                capacity = out.size * 2
                tls.laz_out = None
                continue
            if rc < 0:
                raise ValueError(f"LAZ encode failed (code {rc})")
            return out[:rc]

    def laz_decode_chunks_parallel(self, data: np.ndarray, n_points: int,
                                   chunk_size: int,
                                   chunk_offsets: np.ndarray,
                                   item_types: np.ndarray,
                                   item_sizes: np.ndarray,
                                   record_length: int) -> np.ndarray:
        """Decode independent chunks across host threads (OpenMP)."""
        out = np.empty(n_points * record_length, dtype=np.uint8)
        rc = self._lib.laz_decode_chunks_parallel(
            np.ascontiguousarray(data, dtype=np.uint8), data.size,
            n_points, chunk_size,
            np.ascontiguousarray(chunk_offsets, dtype=np.int64),
            chunk_offsets.size,
            np.ascontiguousarray(item_types, dtype=np.uint16),
            np.ascontiguousarray(item_sizes, dtype=np.int32),
            item_types.size, out)
        if rc < 0:
            raise ValueError(f"LAZ parallel decode failed (code {rc})")
        return out

    def laz_decode_chunks_parallel_v(self, data: np.ndarray,
                                     chunk_offsets: np.ndarray,
                                     point_starts: np.ndarray,
                                     item_types: np.ndarray,
                                     item_sizes: np.ndarray,
                                     record_length: int) -> np.ndarray:
        """Variable-count chunks (adaptive chunking) across host threads.

        chunk_offsets: byte offset of each chunk relative to data start;
        point_starts: exclusive prefix of per-chunk counts (n_chunks+1)."""
        n_points = int(point_starts[-1])
        out = np.empty(n_points * record_length, dtype=np.uint8)
        rc = self._lib.laz_decode_chunks_parallel_v(
            np.ascontiguousarray(data, dtype=np.uint8), data.size,
            np.ascontiguousarray(chunk_offsets, dtype=np.int64),
            np.ascontiguousarray(point_starts, dtype=np.int64),
            chunk_offsets.size,
            np.ascontiguousarray(item_types, dtype=np.uint16),
            np.ascontiguousarray(item_sizes, dtype=np.int32),
            item_types.size, out)
        if rc < 0:
            raise ValueError(f"LAZ parallel decode failed (code {rc})")
        return out

    def laz_read_chunk_table(self, data: np.ndarray,
                             max_chunks: int) -> np.ndarray:
        sizes = np.empty(max_chunks, dtype=np.uint32)
        rc = self._lib.laz_read_chunk_table(
            np.ascontiguousarray(data, dtype=np.uint8), data.size,
            sizes, max_chunks)
        if rc < 0:
            raise ValueError(f"LAZ chunk table read failed (code {rc})")
        return sizes[:rc]

    def laz_read_chunk_table_variable(self, data: np.ndarray,
                                      max_chunks: int) -> tuple:
        """(per-chunk point counts, per-chunk byte sizes) of an
        adaptive-chunking table (VLR chunk_size == U32_MAX)."""
        counts = np.empty(max_chunks, dtype=np.uint32)
        sizes = np.empty(max_chunks, dtype=np.uint32)
        rc = self._lib.laz_read_chunk_table_variable(
            np.ascontiguousarray(data, dtype=np.uint8), data.size,
            counts, sizes, max_chunks)
        if rc < 0:
            raise ValueError(
                f"LAZ variable chunk table read failed (code {rc})")
        return counts[:rc], sizes[:rc]

    def las_encode(self, records: np.ndarray, stride: int, fmt: int,
                   scale, offset, *, positions=None, intensity=None,
                   flags=None, classification=None, scan_angle=None,
                   user_data=None, point_source_id=None, gps_time=None,
                   rgb16=None) -> None:
        n = records.size // stride
        self._lib.las_encode(
            records, n, stride, fmt,
            np.ascontiguousarray(scale, dtype=np.float64),
            np.ascontiguousarray(offset, dtype=np.float64),
            self._ptr(positions), self._ptr(intensity), self._ptr(flags),
            self._ptr(classification), self._ptr(scan_angle),
            self._ptr(user_data), self._ptr(point_source_id),
            self._ptr(gps_time), self._ptr(rgb16))


    # -- test-only coder primitive drivers --------------------------------

    def laz_test_encode_symbols(self, syms, num_symbols: int) -> bytes:
        syms = np.ascontiguousarray(syms, dtype=np.uint32)
        out = np.empty(syms.size * 8 + 64, dtype=np.uint8)
        rc = self._lib.laz_test_encode_symbols(
            syms, syms.size, num_symbols, out, out.size)
        if rc < 0:
            raise ValueError(f"encode_symbols failed ({rc})")
        return out[:rc].tobytes()

    def laz_test_decode_symbols(self, data: bytes, n: int,
                                num_symbols: int) -> np.ndarray:
        buf = np.frombuffer(data, dtype=np.uint8).copy()
        out = np.empty(n, dtype=np.uint32)
        rc = self._lib.laz_test_decode_symbols(
            buf, buf.size, n, num_symbols, out)
        if rc < 0:
            raise ValueError(f"decode_symbols failed ({rc})")
        return out

    def laz_test_encode_bits(self, bits) -> bytes:
        bits = np.ascontiguousarray(bits, dtype=np.uint8)
        out = np.empty(bits.size + 64, dtype=np.uint8)
        rc = self._lib.laz_test_encode_bits(bits, bits.size, out, out.size)
        if rc < 0:
            raise ValueError(f"encode_bits failed ({rc})")
        return out[:rc].tobytes()

    def laz_test_ic_compress(self, preds, reals, ctxs, bits: int,
                             n_contexts: int) -> bytes:
        preds = np.ascontiguousarray(preds, dtype=np.int32)
        reals = np.ascontiguousarray(reals, dtype=np.int32)
        ctxs = np.ascontiguousarray(ctxs, dtype=np.uint32)
        out = np.empty(preds.size * 12 + 64, dtype=np.uint8)
        rc = self._lib.laz_test_ic_compress(
            preds, reals, ctxs, preds.size, bits, n_contexts, out, out.size)
        if rc < 0:
            raise ValueError(f"ic_compress failed ({rc})")
        return out[:rc].tobytes()

    def laz_test_ic_decompress(self, data: bytes, preds, ctxs, bits: int,
                               n_contexts: int) -> np.ndarray:
        buf = np.frombuffer(data, dtype=np.uint8).copy()
        preds = np.ascontiguousarray(preds, dtype=np.int32)
        ctxs = np.ascontiguousarray(ctxs, dtype=np.uint32)
        out = np.empty(preds.size, dtype=np.int32)
        rc = self._lib.laz_test_ic_decompress(
            buf, buf.size, preds, ctxs, preds.size, bits, n_contexts, out)
        if rc < 0:
            raise ValueError(f"ic_decompress failed ({rc})")
        return out


def load() -> NativeLib:
    if os.environ.get("SCHWARZWALD_TPU_NO_NATIVE"):
        raise RuntimeError("native disabled via SCHWARZWALD_TPU_NO_NATIVE")
    so = _ensure_built()
    return NativeLib(ctypes.CDLL(so))
