"""LAS reader/writer (numpy structured records; native codec fast path).

Replaces the reference's LASzip wrapper (schwarzwald/core/io/LASFile.{h,cpp})
for uncompressed LAS. Point formats 0-3; LAS 1.0-1.4 headers on read
(including 1.4 extended counts, LASFile.cpp:269-277), LAS 1.2 headers on
write with the same field policy as LASPersistence (LASPersistence.cpp:
101-137). LAZ decode requires the native entropy codec (gated; the design
extension point mirrors pc::PointFile, core/io/PointcloudFile.h).
"""
from __future__ import annotations

import dataclasses
import struct

import numpy as np

from ..core.aabb import AABB
from ..core.attributes import PointAttribute
from ..core.pointbuffer import PointBuffer

HEADER_SIZE_12 = 227
HEADER_SIZE_14 = 375

# Record layouts for point formats 0-3 (LAS 1.2) and the extended
# formats 6-8 (LAS 1.4): read support for both, write always 0-3
# (matching LASPersistence, which emits LAS 1.2).
_BASE_FIELDS = [
    ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
    ("intensity", "<u2"), ("flags", "u1"), ("classification", "u1"),
    ("scan_angle", "i1"), ("user_data", "u1"), ("point_source_id", "<u2"),
]
_GPS_FIELD = [("gps_time", "<f8")]
_RGB_FIELDS = [("red", "<u2"), ("green", "<u2"), ("blue", "<u2")]
# LAS 1.4 extended record (formats 6+): 15-bit return info, 16-bit scan
# angle (0.006 degree units), gps time always present.
_EXT_FIELDS = [
    ("x", "<i4"), ("y", "<i4"), ("z", "<i4"),
    ("intensity", "<u2"), ("flags", "u1"), ("flags2", "u1"),
    ("classification", "u1"), ("user_data", "u1"), ("scan_angle", "<i2"),
    ("point_source_id", "<u2"), ("gps_time", "<f8"),
]


# Waveform-bearing formats are their base record plus a trailing 29-byte
# wave packet (descriptor u1, offset u8, size u4, return-point f4, x/y/z(t)
# f4 each). The tiler reads the base attributes and skips the payload —
# matching the reference, which reads formats 5/10 through LASzip as
# RGB-bearing records (LASFile.cpp:421-426) and never consumes waveforms.
_WAVEFORM_BASE = {4: 1, 5: 3, 9: 6, 10: 8}
WAVE_PACKET_BYTES = 29


def base_point_format(fmt: int) -> int:
    """Waveform formats collapse to their attribute-equivalent base."""
    return _WAVEFORM_BASE.get(fmt, fmt)


def point_record_dtype(fmt: int) -> np.dtype:
    fmt = base_point_format(fmt)
    if fmt >= 6:
        fields = list(_EXT_FIELDS)
        if fmt in (7, 8):
            fields += _RGB_FIELDS
        if fmt == 8:
            fields += [("nir", "<u2")]
        return np.dtype(fields)
    fields = list(_BASE_FIELDS)
    if fmt in (1, 3):
        fields += _GPS_FIELD
    if fmt in (2, 3):
        fields += _RGB_FIELDS
    return np.dtype(fields)


def record_length_for_format(fmt: int) -> int:
    return {0: 20, 1: 28, 2: 26, 3: 34, 4: 57, 5: 63,
            6: 30, 7: 36, 8: 38, 9: 59, 10: 67}[fmt]


def attributes_for_format(fmt: int) -> set:
    """Attribute presence by point_data_format (LASFile.cpp:414-444;
    extended formats 6-10 always carry GPS time; waveform formats carry
    their base format's attributes)."""
    fmt = base_point_format(fmt)
    attrs = {PointAttribute.Position, PointAttribute.Intensity,
             PointAttribute.ReturnNumber, PointAttribute.NumberOfReturns,
             PointAttribute.ScanDirectionFlag, PointAttribute.EdgeOfFlightLine,
             PointAttribute.Classification, PointAttribute.ScanAngleRank,
             PointAttribute.UserData, PointAttribute.PointSourceID}
    if fmt in (1, 3, 6, 7, 8):
        attrs.add(PointAttribute.GPSTime)
    if fmt in (2, 3, 7, 8):
        attrs.add(PointAttribute.RGB)
    return attrs


@dataclasses.dataclass
class LASHeader:
    version_major: int = 1
    version_minor: int = 2
    point_data_format: int = 0
    point_record_length: int = 20
    point_count: int = 0
    points_by_return: tuple = (0, 0, 0, 0, 0)
    scale: np.ndarray = None
    offset: np.ndarray = None
    mins: np.ndarray = None
    maxs: np.ndarray = None
    offset_to_point_data: int = HEADER_SIZE_12
    header_size: int = HEADER_SIZE_12
    is_compressed: bool = False
    n_vlrs: int = 0

    def bounds(self) -> AABB:
        return AABB(self.mins, self.maxs)


def parse_header(raw: bytes) -> LASHeader:
    if raw[:4] != b"LASF":
        raise ValueError("Not a LAS file (missing LASF signature)")
    h = LASHeader()
    h.version_major, h.version_minor = raw[24], raw[25]
    h.header_size = struct.unpack_from("<H", raw, 94)[0]
    h.offset_to_point_data = struct.unpack_from("<I", raw, 96)[0]
    h.n_vlrs = struct.unpack_from("<I", raw, 100)[0]
    fmt = raw[104]
    # LAZ files set bit 7 of the point data format.
    h.is_compressed = bool(fmt & 0x80)
    h.point_data_format = fmt & 0x3F
    h.point_record_length = struct.unpack_from("<H", raw, 105)[0]
    legacy_count = struct.unpack_from("<I", raw, 107)[0]
    h.points_by_return = struct.unpack_from("<5I", raw, 111)
    h.scale = np.array(struct.unpack_from("<3d", raw, 131))
    h.offset = np.array(struct.unpack_from("<3d", raw, 155))
    bb = struct.unpack_from("<6d", raw, 179)  # max_x,min_x,max_y,min_y,max_z,min_z
    h.maxs = np.array([bb[0], bb[2], bb[4]])
    h.mins = np.array([bb[1], bb[3], bb[5]])
    h.point_count = legacy_count
    if (h.version_major, h.version_minor) >= (1, 4) and len(raw) >= 255:
        extended = struct.unpack_from("<Q", raw, 247)[0]
        if extended and not legacy_count:
            h.point_count = extended  # LASFile.cpp:269-277
    return h


class LASFile:
    """Read-mode LAS file with batched record decode."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            raw = f.read(376)
        self.header = parse_header(raw)
        if self.header.is_compressed or path.lower().endswith(".laz"):
            from . import laz
            self._laz = laz.LAZReader(path, self.header)
        else:
            self._laz = None
            if self.header.point_data_format > 10:
                raise ValueError(
                    f"Unsupported point data format "
                    f"{self.header.point_data_format} (supported: 0-10)")

    @property
    def count(self) -> int:
        return self.header.point_count

    def attributes(self) -> set:
        return attributes_for_format(self.header.point_data_format)

    def _read_records(self, start: int, count: int) -> np.ndarray:
        h = self.header
        if self._laz is not None:
            return self._laz.read_records(start, count)
        stride = h.point_record_length
        with open(self.path, "rb") as f:
            f.seek(h.offset_to_point_data + start * stride)
            return np.fromfile(f, dtype=np.uint8, count=count * stride)

    def read_points(self, start: int, count: int,
                    attributes: set | None = None) -> PointBuffer:
        """Decode records [start, start+count) into a PointBuffer."""
        h = self.header
        count = max(0, min(count, h.point_count - start))
        if count == 0:
            return PointBuffer()
        records = self._read_records(start, count)
        return decode_records(records, h, attributes or self.attributes())

    def read_points_fused_into(self, start: int, count: int, attributes: set,
                               shift_to_center: bool, center, bounds_min,
                               bounds_max, out_buffer: PointBuffer,
                               out_keys: np.ndarray, offset: int) -> int:
        """Region variant of read_points_fused: decodes into
        out_buffer[offset:offset+n] / out_keys[offset:offset+n] (the
        reference's read-into-disjoint-regions design, Tiler.cpp:376-405,
        which doubles as page-reuse on VMs with slow first-touch faults).
        Returns the number of points decoded."""
        from .. import native

        h = self.header
        count = max(0, min(count, h.point_count - start))
        if count == 0:
            return 0
        lib = native.las_codec()
        stride = h.point_record_length
        nbytes = count * stride
        if self._laz is not None:
            records = np.ascontiguousarray(
                self._laz.read_records(start, count))
        else:
            scratch = getattr(self, "_records_scratch", None)
            if scratch is None or scratch.size < nbytes:
                scratch = np.empty(nbytes, dtype=np.uint8)
                self._records_scratch = scratch
            with open(self.path, "rb") as f:
                f.seek(h.offset_to_point_data + start * stride)
                f.readinto(memoryview(scratch[:nbytes]))
            records = scratch[:nbytes]

        pos_region = out_buffer.positions[offset:offset + count]
        keys_region = out_keys[offset:offset + count]
        if lib is not None:
            lib.las_decode_index_fused_into(
                records, stride, h.scale, h.offset, shift_to_center, center,
                bounds_min, bounds_max, pos_region, keys_region)
        else:
            tmp = decode_records(records.copy(), h, {PointAttribute.Position})
            pos = tmp.positions
            if shift_to_center:
                pos = (pos - np.asarray(center)).astype(np.float32) \
                    .astype(np.float64)
            from ..ops import indexing
            keys, pos = indexing.index_points(pos, bounds_min, bounds_max)
            pos_region[:] = pos
            keys_region[:] = keys
        decode_records_into(records, h, attributes, out_buffer, offset, count)
        return count

    def read_points_fused(self, start: int, count: int, attributes: set,
                          shift_to_center: bool, center, bounds_min,
                          bounds_max) -> PointBuffer:
        """Fused read path: one native pass produces transformed + clamped
        positions AND Morton keys (buffer.morton_keys); attributes decode
        from the same records. Falls back to read_points when the native
        codec is unavailable."""
        from .. import native

        h = self.header
        count = max(0, min(count, h.point_count - start))
        if count == 0:
            return PointBuffer()
        lib = native.las_codec()
        if lib is None:
            return self.read_points(start, count, attributes)
        records = self._read_records(start, count)
        positions, keys = lib.las_decode_index_fused(
            records, h.point_record_length, h.scale, h.offset,
            shift_to_center, center, bounds_min, bounds_max)
        buf = decode_records(records, h, set(attributes)
                             - {PointAttribute.Position},
                             decode_positions=False)
        buf.positions = positions
        buf.morton_keys = keys
        return buf


def decode_records(records: np.ndarray, header: LASHeader,
                   attributes: set,
                   decode_positions: bool = True) -> PointBuffer:
    # waveform formats (4/5/9/10): decode the base record; the trailing
    # wave packet falls into the padded-dtype gap and is skipped
    fmt = base_point_format(header.point_data_format)
    stride = header.point_record_length
    dtype = point_record_dtype(fmt)
    n = records.size // stride
    if stride == dtype.itemsize:
        rec = records.view(dtype)
    else:
        # extra bytes per record beyond the standard layout: view with a
        # padded dtype
        padded = np.dtype({"names": [f[0] for f in dtype.descr],
                           "formats": [f[1] for f in dtype.descr],
                           "offsets": [dtype.fields[f[0]][1]
                                       for f in dtype.descr],
                           "itemsize": stride})
        rec = records.view(padded)

    if decode_positions:
        positions = np.empty((n, 3), dtype=np.float64)
        positions[:, 0] = rec["x"] * header.scale[0] + header.offset[0]
        positions[:, 1] = rec["y"] * header.scale[1] + header.offset[1]
        positions[:, 2] = rec["z"] * header.scale[2] + header.offset[2]
    else:
        positions = np.empty((n, 3), dtype=np.float64)
    buf = PointBuffer(positions)

    flags = rec["flags"]
    extended = fmt >= 6
    A = PointAttribute
    if A.Intensity in attributes:
        buf.set_column(A.Intensity, rec["intensity"].copy())
    if A.ReturnNumber in attributes:
        buf.set_column(A.ReturnNumber,
                       flags & 0xF if extended else flags & 0x7)
    if A.NumberOfReturns in attributes:
        buf.set_column(A.NumberOfReturns,
                       (flags >> 4) & 0xF if extended else (flags >> 3) & 0x7)
    dir_src = rec["flags2"] if extended else flags
    if A.ScanDirectionFlag in attributes:
        buf.set_column(A.ScanDirectionFlag, (dir_src >> 6) & 0x1)
    if A.EdgeOfFlightLine in attributes:
        buf.set_column(A.EdgeOfFlightLine, (dir_src >> 7) & 0x1)
    if A.Classification in attributes:
        buf.set_column(A.Classification, rec["classification"].copy())
    if A.ScanAngleRank in attributes:
        if extended:
            # extended 16-bit angle in 0.006 degree units -> legacy i8 rank
            # (laszip compatibility-mode conversion)
            rank = np.clip(np.round(rec["scan_angle"] * 0.006), -128, 127)
            buf.set_column(A.ScanAngleRank, rank.astype(np.int8))
        else:
            buf.set_column(A.ScanAngleRank, rec["scan_angle"].copy())
    if A.UserData in attributes:
        buf.set_column(A.UserData, rec["user_data"].copy())
    if A.PointSourceID in attributes:
        buf.set_column(A.PointSourceID, rec["point_source_id"].copy())
    if A.GPSTime in attributes and fmt in (1, 3, 6, 7, 8):
        buf.set_column(A.GPSTime, rec["gps_time"].copy())
    if A.RGB in attributes and fmt in (2, 3, 7, 8):
        rgb = np.empty((n, 3), dtype=np.uint8)
        # 16 -> 8 bit via >> 8 (LASFile.cpp:521-525)
        rgb[:, 0] = rec["red"] >> 8
        rgb[:, 1] = rec["green"] >> 8
        rgb[:, 2] = rec["blue"] >> 8
        buf.set_column(A.RGB, rgb)
    return buf


def decode_records_into(records: np.ndarray, header: LASHeader,
                        attributes: set, out_buffer: PointBuffer,
                        offset: int, count: int) -> None:
    """Decode non-position attributes into the columns of a preallocated
    buffer region (positions handled by the fused native pass)."""
    fmt = base_point_format(header.point_data_format)
    stride = header.point_record_length
    dtype = point_record_dtype(fmt)
    if stride == dtype.itemsize:
        rec = records[:count * stride].view(dtype)
    else:
        padded = np.dtype({"names": [f[0] for f in dtype.descr],
                           "formats": [f[1] for f in dtype.descr],
                           "offsets": [dtype.fields[f[0]][1]
                                       for f in dtype.descr],
                           "itemsize": stride})
        rec = records[:count * stride].view(padded)

    cols = out_buffer.columns
    end = offset + count
    flags = rec["flags"]
    extended = fmt >= 6
    dir_src = rec["flags2"] if extended else flags
    A = PointAttribute
    if A.Intensity in cols:
        cols[A.Intensity][offset:end] = rec["intensity"]
    if A.ReturnNumber in cols:
        cols[A.ReturnNumber][offset:end] = \
            flags & 0xF if extended else flags & 0x7
    if A.NumberOfReturns in cols:
        cols[A.NumberOfReturns][offset:end] = \
            (flags >> 4) & 0xF if extended else (flags >> 3) & 0x7
    if A.ScanDirectionFlag in cols:
        cols[A.ScanDirectionFlag][offset:end] = (dir_src >> 6) & 0x1
    if A.EdgeOfFlightLine in cols:
        cols[A.EdgeOfFlightLine][offset:end] = (dir_src >> 7) & 0x1
    if A.Classification in cols:
        cols[A.Classification][offset:end] = rec["classification"]
    if A.ScanAngleRank in cols:
        if extended:
            cols[A.ScanAngleRank][offset:end] = np.clip(
                np.round(rec["scan_angle"] * 0.006), -128, 127
            ).astype(np.int8)
        else:
            cols[A.ScanAngleRank][offset:end] = rec["scan_angle"]
    if A.UserData in cols:
        cols[A.UserData][offset:end] = rec["user_data"]
    if A.PointSourceID in cols:
        cols[A.PointSourceID][offset:end] = rec["point_source_id"]
    if A.GPSTime in cols and fmt in (1, 3, 6, 7, 8):
        cols[A.GPSTime][offset:end] = rec["gps_time"]
    if A.RGB in cols and fmt in (2, 3, 7, 8):
        cols[A.RGB][offset:end, 0] = rec["red"] >> 8
        cols[A.RGB][offset:end, 1] = rec["green"] >> 8
        cols[A.RGB][offset:end, 2] = rec["blue"] >> 8


def choose_point_format(buffer: PointBuffer, extended: bool = False) -> int:
    """Format from gps/rgb presence (LASPersistence.cpp:101-104).

    With extended=True (LAS 1.4 inputs whose attribute ranges exceed the
    legacy formats: 4-bit return counts, 16-bit scan angles, 8-bit
    classifications), emit the extended formats 6/7 instead — gps time is
    always present there, rgb selects 7."""
    has_rgb = buffer.has(PointAttribute.RGB)
    if extended:
        return 7 if has_rgb else 6
    has_gps = buffer.has(PointAttribute.GPSTime)
    return (1 if has_gps else 0) + (2 if has_rgb else 0)


def compute_las_scale_from_bounds(bounds: AABB) -> float:
    """LASPersistence.cpp:16-28 (adopted from Potree)."""
    diagonal = bounds.diagonal_length()
    if diagonal > 1_000_000:
        return 0.01
    if diagonal > 100_000:
        return 0.001
    if diagonal > 1:
        return 0.001
    return 0.0001


def quantize_positions(positions: np.ndarray, scale, offset) -> np.ndarray:
    """I32_QUANTIZE semantics: round half away from zero."""
    if positions.shape[0] >= 256:
        from .. import native
        lib = native.las_codec()
        if lib is not None:
            return lib.quantize_i32(positions, np.asarray(scale),
                                    np.asarray(offset))
    v = (positions - np.asarray(offset)) / np.asarray(scale)
    return np.where(v >= 0, v + 0.5, v - 0.5).astype(np.int32)


def simulate_roundtrip(buffer: PointBuffer, fmt: int, scale,
                       offset) -> PointBuffer:
    """Column-level equivalent of encode_records followed by
    decode_records(attributes_for_format(fmt)) — what a LAS persist +
    re-read returns, without packing/unpacking record structs.

    The round trip is lossy only in a handful of places (position grid
    quantization, legacy 3-bit return masks, the extended scan-angle unit
    conversion); everything else is an identity copy because PointBuffer
    columns already use the canonical LAS dtypes (ATTRIBUTE_LAYOUT).
    Differentially tested against the real encode+decode pair
    (tests/test_las.py::test_simulate_roundtrip_matches_encode_decode)."""
    fmt = base_point_format(fmt)
    scale = np.asarray(scale, dtype=np.float64)
    offset = np.asarray(offset, dtype=np.float64)
    n = buffer.count
    xyz = quantize_positions(buffer.positions, scale, offset)
    positions = np.empty((n, 3), dtype=np.float64)
    positions[:, 0] = xyz[:, 0] * scale[0] + offset[0]
    positions[:, 1] = xyz[:, 1] * scale[1] + offset[1]
    positions[:, 2] = xyz[:, 2] * scale[2] + offset[2]
    out = PointBuffer(positions)

    extended = fmt >= 6
    A = PointAttribute

    def col(attr, dtype):
        c = buffer.get(attr)
        return c if c is not None else np.zeros(n, dtype=dtype)

    out.columns[A.Intensity] = col(A.Intensity, np.uint16).copy()
    ret_mask = 0xF if extended else 0x7
    out.columns[A.ReturnNumber] = col(A.ReturnNumber, np.uint8) & ret_mask
    out.columns[A.NumberOfReturns] = \
        col(A.NumberOfReturns, np.uint8) & ret_mask
    out.columns[A.ScanDirectionFlag] = \
        col(A.ScanDirectionFlag, np.uint8) & 0x1
    out.columns[A.EdgeOfFlightLine] = \
        col(A.EdgeOfFlightLine, np.uint8) & 0x1
    out.columns[A.Classification] = col(A.Classification, np.uint8).copy()
    rank = col(A.ScanAngleRank, np.int8)
    if extended:
        # i8 rank -> i16 0.006-degree units -> i8 rank (encode + decode
        # sides of the laszip compatibility-mode conversion)
        units = np.clip(np.round(rank.astype(np.float64) / 0.006),
                        -32768, 32767)
        rank = np.clip(np.round(units * 0.006), -128, 127).astype(np.int8)
    else:
        rank = rank.copy()
    out.columns[A.ScanAngleRank] = rank
    out.columns[A.UserData] = col(A.UserData, np.uint8).copy()
    out.columns[A.PointSourceID] = col(A.PointSourceID, np.uint16).copy()
    if fmt in (1, 3, 6, 7, 8):
        out.columns[A.GPSTime] = col(A.GPSTime, np.float64).copy()
    if fmt in (2, 3, 7, 8):
        rgb = buffer.get(A.RGB)
        out.columns[A.RGB] = (rgb.copy() if rgb is not None
                              else np.zeros((n, 3), dtype=np.uint8))
    return out


def encode_records(buffer: PointBuffer, fmt: int, scale, offset) -> np.ndarray:
    dtype = point_record_dtype(fmt)
    rec = np.zeros(buffer.count, dtype=dtype)
    xyz = quantize_positions(buffer.positions, scale, offset)
    rec["x"], rec["y"], rec["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    A = PointAttribute
    extended = fmt >= 6
    if buffer.has(A.Intensity):
        rec["intensity"] = buffer.get(A.Intensity)
    flags = np.zeros(buffer.count, dtype=np.uint8)
    if extended:
        # format 6+: byte 14 = return (4 bits) | count (4 bits); byte 15 =
        # classification flags | scanner channel | direction | edge
        if buffer.has(A.ReturnNumber):
            flags |= buffer.get(A.ReturnNumber) & 0xF
        if buffer.has(A.NumberOfReturns):
            flags |= (buffer.get(A.NumberOfReturns) & 0xF) << 4
        rec["flags"] = flags
        flags2 = np.zeros(buffer.count, dtype=np.uint8)
        if buffer.has(A.ScanDirectionFlag):
            flags2 |= (buffer.get(A.ScanDirectionFlag) & 0x1) << 6
        if buffer.has(A.EdgeOfFlightLine):
            flags2 |= (buffer.get(A.EdgeOfFlightLine) & 0x1) << 7
        rec["flags2"] = flags2
    else:
        if buffer.has(A.ReturnNumber):
            flags |= buffer.get(A.ReturnNumber) & 0x7
        if buffer.has(A.NumberOfReturns):
            flags |= (buffer.get(A.NumberOfReturns) & 0x7) << 3
        if buffer.has(A.ScanDirectionFlag):
            flags |= (buffer.get(A.ScanDirectionFlag) & 0x1) << 6
        if buffer.has(A.EdgeOfFlightLine):
            flags |= (buffer.get(A.EdgeOfFlightLine) & 0x1) << 7
        rec["flags"] = flags
    if buffer.has(A.Classification):
        rec["classification"] = buffer.get(A.Classification)
    if buffer.has(A.ScanAngleRank):
        if extended:
            # legacy i8 rank (degrees) -> extended i16 in 0.006 degree
            # units (laszip compatibility-mode conversion, inverse of the
            # read-side mapping)
            rank = buffer.get(A.ScanAngleRank).astype(np.float64)
            rec["scan_angle"] = np.clip(
                np.round(rank / 0.006), -32768, 32767).astype(np.int16)
        else:
            rec["scan_angle"] = buffer.get(A.ScanAngleRank)
    if buffer.has(A.UserData):
        rec["user_data"] = buffer.get(A.UserData)
    if buffer.has(A.PointSourceID):
        rec["point_source_id"] = buffer.get(A.PointSourceID)
    if fmt in (1, 3) or extended:
        rec["gps_time"] = (buffer.get(A.GPSTime)
                           if buffer.has(A.GPSTime) else 0.0)
    if fmt in (2, 3, 7, 8) and buffer.has(A.RGB):
        rgb = buffer.get(A.RGB).astype(np.uint16)
        # 8 -> 16 bit via << 8 (LASPersistence.h:184-186)
        rec["red"] = rgb[:, 0] << 8
        rec["green"] = rgb[:, 1] << 8
        rec["blue"] = rgb[:, 2] << 8
    return rec


def build_header_bytes(header: LASHeader) -> bytes:
    """LAS public header block. Emits LAS 1.2 (227 bytes) for the legacy
    point formats and LAS 1.4 (375 bytes, extended 64-bit counts, legacy
    counts zeroed per spec) when point_data_format >= 6."""
    extended = (header.point_data_format & 0x3F) >= 6
    size = HEADER_SIZE_14 if extended else HEADER_SIZE_12
    raw = bytearray(size)
    raw[0:4] = b"LASF"
    raw[24] = 1
    raw[25] = 4 if extended else 2
    if extended:
        # global encoding bit 4: CRS is WKT (mandatory for formats 6+)
        struct.pack_into("<H", raw, 6, 1 << 4)
    software = b"pointcloud_tiler"  # LASPersistence.cpp:119
    raw[58:58 + len(software)] = software
    struct.pack_into("<H", raw, 94, size)
    struct.pack_into("<I", raw, 96, header.offset_to_point_data)
    struct.pack_into("<I", raw, 100, header.n_vlrs)
    raw[104] = header.point_data_format
    struct.pack_into("<H", raw, 105, header.point_record_length)
    if not extended:
        struct.pack_into("<I", raw, 107, min(header.point_count, 0xFFFFFFFF))
        struct.pack_into("<5I", raw, 111, *header.points_by_return)
    struct.pack_into("<3d", raw, 131, *header.scale)
    struct.pack_into("<3d", raw, 155, *header.offset)
    struct.pack_into("<6d", raw, 179,
                     header.maxs[0], header.mins[0],
                     header.maxs[1], header.mins[1],
                     header.maxs[2], header.mins[2])
    if extended:
        # 227: waveform EVLR offset, 235: first EVLR offset, 243: # EVLRs
        struct.pack_into("<Q", raw, 247, header.point_count)
        by_return = list(header.points_by_return[:15])
        by_return += [0] * (15 - len(by_return))
        struct.pack_into("<15Q", raw, 255, *by_return)
    return bytes(raw)


def _las_file_parts(buffer: PointBuffer, bounds: AABB,
                    compressed: bool, extended: bool) -> list:
    """The complete LAS/LAZ file content as a list of buffer-protocol
    parts (bytes / contiguous uint8 views), shared by the synchronous
    write and the write-behind encode-into-pooled-buffer path so both
    produce byte-identical files."""
    fmt = choose_point_format(buffer, extended=extended)
    scale = compute_las_scale_from_bounds(bounds)
    header_size = HEADER_SIZE_14 if fmt >= 6 else HEADER_SIZE_12
    header = LASHeader(
        version_minor=4 if fmt >= 6 else 2,
        point_data_format=fmt,
        point_record_length=record_length_for_format(fmt),
        point_count=buffer.count,
        points_by_return=(buffer.count, 0, 0, 0, 0),
        scale=np.full(3, scale),
        offset=bounds.min.copy(),
        mins=bounds.min.copy(),
        maxs=bounds.max.copy(),
        offset_to_point_data=header_size,
        header_size=header_size,
    )
    records = encode_records(buffer, fmt, header.scale, header.offset)
    if compressed:
        from . import laz
        return laz.laz_file_parts(header, records)
    return [build_header_bytes(header),
            np.ascontiguousarray(records).view(np.uint8).reshape(-1)]


def write_las(path: str, buffer: PointBuffer, bounds: AABB,
              compressed: bool = False, extended: bool = False) -> None:
    """One-shot LAS write with the LASPersistence header policy:
    offset = bounds.min, min/max = bounds, scale from bounds diagonal.
    extended=True emits LAS 1.4 point format 6/7 (see
    choose_point_format)."""
    with open(path, "wb") as f:
        for part in _las_file_parts(buffer, bounds, compressed, extended):
            f.write(part)


def encode_las_into(buffer: PointBuffer, bounds: AABB, alloc,
                    compressed: bool = False,
                    extended: bool = False) -> tuple:
    """Encode the full LAS/LAZ file content into a buffer obtained from
    `alloc(size)` (an AsyncFileWriter pool, or bytearray for a one-shot).
    Returns (buffer, nbytes); the buffer owns a copy of everything, so
    the point data may be reused by the caller immediately. Byte-
    identical to write_las (same parts)."""
    parts = [memoryview(p).cast("B")
             for p in _las_file_parts(buffer, bounds, compressed, extended)]
    total = sum(len(p) for p in parts)
    out = alloc(total)
    dst = memoryview(out)
    off = 0
    for p in parts:
        dst[off:off + len(p)] = p
        off += len(p)
    return out, total


def read_las(path: str, attributes: set | None = None) -> PointBuffer:
    f = LASFile(path)
    return f.read_points(0, f.count, attributes)
