"""3D Tiles .pnts point-cloud binary reader/writer.

Format parity with PNTSWriter/PNTSReader (schwarzwald/core/io/
PNTSWriter.cpp:108-260, PNTSReader.cpp): 28-byte header ("pnts", version 1,
total size, feature-table JSON/binary byte lengths, zero batch table),
feature-table JSON padded with spaces to 8 bytes, binary body with
per-attribute aligned offsets, 8-byte aligned total. POSITION is float32x3
(PNTSWriter.cpp:304-320), RGB uint8x3, INTENSITY uint16; RGB may be derived
from intensity via linear (>>8 greyscale) or log mapping
(PNTSWriter.cpp:507-525).
"""
from __future__ import annotations

import json
import math
import struct

import numpy as np

from ..core.attributes import PointAttribute, RGBMapping
from ..core.pointbuffer import PointBuffer

A = PointAttribute
HEADER_SIZE = 28


def _align(v: int, alignment: int) -> int:
    rem = v % alignment
    return v if rem == 0 else v + alignment - rem


def rgb_from_intensity(intensity: np.ndarray,
                       mapping: RGBMapping) -> np.ndarray:
    if mapping == RGBMapping.FromIntensityLinear:
        grey = (intensity >> 8).astype(np.uint8)
    else:
        grey = (255 * np.log(intensity.astype(np.float32) + 1)
                / math.log(np.iinfo(np.uint16).max)).astype(np.uint8)
    return np.repeat(grey[:, None], 3, axis=1)


import threading

_tls = threading.local()


def _scratch_cast(arr: np.ndarray, dtype: str, key: str) -> np.ndarray:
    """Cast into a pooled (thread-local, grow-only) scratch buffer.

    The result is written to a file immediately and never escapes, so the
    buffer is reusable; pooling avoids re-faulting fresh pages per node,
    which costs ~45 MB/s on this deployment's VM (ARCHITECTURE.md)."""
    n = arr.size
    pool = getattr(_tls, "pool", None)
    if pool is None:
        pool = _tls.pool = {}
    buf = pool.get(key)
    if buf is None or buf.size < n:
        buf = pool[key] = np.empty(max(n, 1 << 16), dtype=dtype)
    out = buf[:n].reshape(arr.shape)
    np.copyto(out, arr, casting="unsafe")
    return out


def _binary_attributes(points: PointBuffer, output_attributes,
                       rgb_mapping: RGBMapping):
    """Yield (json_name, contiguous array, alignment) in canonical order."""
    out = []
    if A.Position in output_attributes:
        out.append(("POSITION",
                    _scratch_cast(points.positions, "<f4", "pos"), 4))
    if A.RGB in output_attributes:
        if rgb_mapping != RGBMapping.Nothing and points.has(A.Intensity):
            rgb = rgb_from_intensity(points.get(A.Intensity), rgb_mapping)
            out.append(("RGB", rgb, 1))
        elif points.has(A.RGB):
            out.append(("RGB",
                        np.ascontiguousarray(points.get(A.RGB), dtype="u1"),
                        1))
    if A.Intensity in output_attributes and points.has(A.Intensity):
        out.append(("INTENSITY",
                    np.ascontiguousarray(points.get(A.Intensity),
                                         dtype="<u2"), 2))
    return out


_PAD = b"\x00" * 8


def encode_pnts_into(points: PointBuffer, output_attributes, rtc_center,
                     rgb_mapping: RGBMapping, alloc) -> tuple:
    """Encode a full .pnts payload into a buffer obtained from `alloc(size)`
    (an AsyncFileWriter pool, or bytearray for a one-shot). Returns
    (buffer, nbytes). The buffer owns a copy of every array, so the point
    data may be reused by the caller immediately."""
    n = points.count
    ft: dict = {"POINTS_LENGTH": n,
                "RTC_CENTER": [float(rtc_center[0]), float(rtc_center[1]),
                               float(rtc_center[2])]}
    arrays = _binary_attributes(points, output_attributes, rgb_mapping)
    parts = []  # (pad_bytes, array) pairs
    offset = 0
    for name, arr, alignment in arrays:
        aligned = _align(offset, alignment)
        ft[name] = {"byteOffset": aligned}
        parts.append((aligned - offset, arr))
        offset = aligned + arr.nbytes
    body_size = _align(offset, 8)
    tail_pad = body_size - offset

    ft_json = json.dumps(ft, separators=(",", ":")).encode()
    ft_json_size = _align(len(ft_json), 8)

    total = HEADER_SIZE + ft_json_size + body_size
    buf = alloc(total)
    view = memoryview(buf)
    view[0:4] = b"pnts"
    struct.pack_into("<6I", buf, 4, 1, total, ft_json_size, body_size, 0, 0)
    pos = HEADER_SIZE
    view[pos:pos + len(ft_json)] = ft_json
    pos += len(ft_json)
    if len(ft_json) != ft_json_size:
        pad = ft_json_size - len(ft_json)
        view[pos:pos + pad] = b" " * pad
        pos += pad
    for pad, arr in parts:
        if pad:
            view[pos:pos + pad] = _PAD[:pad]
            pos += pad
        view[pos:pos + arr.nbytes] = memoryview(arr).cast("B")
        pos += arr.nbytes
    if tail_pad:
        view[pos:pos + tail_pad] = _PAD[:tail_pad]
        pos += tail_pad
    return buf, total


def write_pnts(path: str, points: PointBuffer, output_attributes,
               rtc_center, rgb_mapping: RGBMapping = RGBMapping.Nothing):
    buf, total = encode_pnts_into(points, output_attributes, rtc_center,
                                  rgb_mapping, bytearray)
    with open(path, "wb") as f:
        f.write(memoryview(buf)[:total])


def read_pnts(path: str, attributes=None):
    """Returns (PointBuffer, rtc_center). Positions come back float32-valued
    (the format stores f32); RGB/INTENSITY restored when present."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:4] != b"pnts":
        raise ValueError(f"{path}: not a pnts file")
    version, total, ft_json_size, ft_bin_size, _, _ = struct.unpack_from(
        "<6I", raw, 4)
    ft = json.loads(raw[HEADER_SIZE:HEADER_SIZE + ft_json_size].decode())
    n = ft["POINTS_LENGTH"]
    body = raw[HEADER_SIZE + ft_json_size:HEADER_SIZE + ft_json_size + ft_bin_size]
    rtc = np.array(ft.get("RTC_CENTER", [0.0, 0.0, 0.0]))

    buf = PointBuffer(np.zeros((n, 3)))
    if "POSITION" in ft:
        off = ft["POSITION"]["byteOffset"]
        pos = np.frombuffer(body, dtype="<f4", count=n * 3,
                            offset=off).reshape(n, 3)
        buf.positions = pos.astype(np.float64)
    if "RGB" in ft and (attributes is None or A.RGB in attributes):
        off = ft["RGB"]["byteOffset"]
        rgb = np.frombuffer(body, dtype="u1", count=n * 3,
                            offset=off).reshape(n, 3)
        buf.set_column(A.RGB, rgb.copy())
    if "INTENSITY" in ft and (attributes is None or A.Intensity in attributes):
        off = ft["INTENSITY"]["byteOffset"]
        buf.set_column(A.Intensity,
                       np.frombuffer(body, dtype="<u2", count=n,
                                     offset=off).copy())
    return buf, rtc
