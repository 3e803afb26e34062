"""NTv2 grid-shift file (.gsb) reader and bilinear shift interpolation.

The reference delegates arbitrary datum transformations to PROJ
(core/util/Transformation.cpp:74+), which consumes NTv2 grids for
grid-based datum shifts (NAD27->NAD83 ntv2_0.gsb, OSTN15, BETA2007, ...).
This module implements the same consumption path natively: parse the
binary NTv2 layout, select the densest sub-grid containing each point,
bilinearly interpolate the (latitude, longitude) shift and apply it in
the geodetic stage (io/srs.py wires `+nadgrids=<path>.gsb`).

Format (Natural Resources Canada, "NTv2 Developer's Guide"):

  * overview header: NUM_OREC 16-byte records, each an 8-char ASCII key
    plus an 8-byte value (int32 + 4 pad bytes for counts, f64 for
    ellipsoid constants, 8-char ASCII for names);
  * per sub-grid: NUM_SREC 16-byte records (SUB_NAME/PARENT/CREATED/
    UPDATED as ASCII, S_LAT/N_LAT/E_LONG/W_LONG/LAT_INC/LONG_INC as f64
    arc-seconds, GS_COUNT as int32), then GS_COUNT 16-byte nodes of four
    f32s: lat shift, lon shift (arc-seconds), lat accuracy, lon accuracy;
  * node order: row-major south to north; WITHIN a row west-positive
    longitude increasing, i.e. from E_LONG to W_LONG — NTv2 longitudes
    are POSITIVE WEST (both conventions handled here, east-positive at
    the API boundary);
  * both byte orders exist in the wild (Canadian originals big-endian,
    NOAA distributions little-endian) — detected from NUM_OREC.

Shift direction: NTv2 stores FROM->TO (e.g. NAD27->NAD83); the forward
transform adds the interpolated shift, the inverse iterates (the shift
field is smooth, 4 fixed-point steps reach f64 roundoff like PROJ's
gridshift inverse).
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class SubGrid:
    name: str
    parent: str
    s_lat: float   # arc-seconds, geodetic latitude
    n_lat: float
    e_lon: float   # arc-seconds, POSITIVE WEST (NTv2 native)
    w_lon: float
    lat_inc: float
    lon_inc: float
    # (rows, cols): rows south->north, cols east->west (positive-west
    # increasing), exactly the file's node order reshaped
    lat_shift: np.ndarray  # arc-seconds, f64
    lon_shift: np.ndarray  # arc-seconds positive west, f64

    @property
    def rows(self) -> int:
        return self.lat_shift.shape[0]

    @property
    def cols(self) -> int:
        return self.lat_shift.shape[1]

    def contains(self, lat_sec, lon_west_sec):
        """Vectorized containment (inclusive bounds, like PROJ)."""
        return ((lat_sec >= self.s_lat) & (lat_sec <= self.n_lat)
                & (lon_west_sec >= self.e_lon)
                & (lon_west_sec <= self.w_lon))


def _read_records(buf: bytes, off: int, n: int):
    recs = []
    for i in range(n):
        key = buf[off + 16 * i: off + 16 * i + 8].decode(
            "ascii", "replace").strip()
        recs.append((key, buf[off + 16 * i + 8: off + 16 * i + 16]))
    return recs


class NTv2Grid:
    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            buf = f.read()
        if len(buf) < 16 * 11:
            raise ValueError(f"{path!r}: too short to be an NTv2 file")
        # byte-order detection: NUM_OREC's value must be a small int (11)
        num_orec_le = int(np.frombuffer(buf, "<i4", 1, 8)[0])
        num_orec_be = int(np.frombuffer(buf, ">i4", 1, 8)[0])
        if num_orec_le == 11:
            self._f8, self._i4, self._f4 = "<f8", "<i4", "<f4"
        elif num_orec_be == 11:
            self._f8, self._i4, self._f4 = ">f8", ">i4", ">f4"
        else:
            raise ValueError(
                f"{path!r}: NUM_OREC is neither 11 LE nor 11 BE "
                f"({num_orec_le}/{num_orec_be}) — not an NTv2 grid")
        header = dict(_read_records(buf, 0, 11))
        missing = {"NUM_OREC", "NUM_SREC", "NUM_FILE"} - set(header)
        if missing:
            raise ValueError(
                f"{path!r}: missing NTv2 overview records {sorted(missing)}")
        num_srec = int(np.frombuffer(header["NUM_SREC"], self._i4, 1)[0])
        num_file = int(np.frombuffer(header["NUM_FILE"], self._i4, 1)[0])
        self.gs_type = header.get("GS_TYPE", b"SECONDS ").decode(
            "ascii", "replace").strip()
        if self.gs_type != "SECONDS":
            raise NotImplementedError(
                f"{path!r}: GS_TYPE {self.gs_type!r} (only SECONDS grids "
                f"are supported, which is every published NTv2 grid)")
        self.system_from = header.get("SYSTEM_F", b"").decode(
            "ascii", "replace").strip()
        self.system_to = header.get("SYSTEM_T", b"").decode(
            "ascii", "replace").strip()

        self.subgrids: list[SubGrid] = []
        off = 16 * 11
        for _ in range(num_file):
            recs = dict(_read_records(buf, off, num_srec))
            off += 16 * num_srec

            def f8(key):
                return float(np.frombuffer(recs[key], self._f8, 1)[0])

            try:
                count = int(np.frombuffer(recs["GS_COUNT"], self._i4, 1)[0])
                s_lat, n_lat = f8("S_LAT"), f8("N_LAT")
                e_lon, w_lon = f8("E_LONG"), f8("W_LONG")
                lat_inc, lon_inc = f8("LAT_INC"), f8("LONG_INC")
            except KeyError as missing:
                raise ValueError(
                    f"{path!r}: sub-grid header is missing the "
                    f"{missing.args[0]!r} record — corrupt NTv2 file") \
                    from None
            import math
            if (not all(map(math.isfinite,
                            (s_lat, n_lat, e_lon, w_lon, lat_inc, lon_inc)))
                    or lat_inc <= 0 or lon_inc <= 0
                    or n_lat < s_lat or w_lon < e_lon
                    or (n_lat - s_lat) / lat_inc > 1e7
                    or (w_lon - e_lon) / lon_inc > 1e7):
                raise ValueError(
                    f"{path!r} sub-grid {recs.get('SUB_NAME')}: invalid "
                    f"extent/increment records — corrupt NTv2 file")
            rows = int(round((n_lat - s_lat) / lat_inc)) + 1
            cols = int(round((w_lon - e_lon) / lon_inc)) + 1
            if rows * cols != count:
                raise ValueError(
                    f"{path!r} sub-grid {recs.get('SUB_NAME')}: GS_COUNT "
                    f"{count} != rows*cols {rows}*{cols}")
            if rows < 2 or cols < 2:
                # a 1-row/1-column grid cannot be bilinearly interpolated
                # (the index clip would wrap to -1 silently)
                raise ValueError(
                    f"{path!r} sub-grid {recs.get('SUB_NAME')}: degenerate "
                    f"{rows}x{cols} grid (need at least 2x2 nodes)")
            nodes = np.frombuffer(buf, self._f4, count * 4, off).reshape(
                count, 4)
            off += 16 * count
            self.subgrids.append(SubGrid(
                name=recs["SUB_NAME"].decode("ascii", "replace").strip(),
                parent=recs["PARENT"].decode("ascii", "replace").strip(),
                s_lat=s_lat, n_lat=n_lat, e_lon=e_lon, w_lon=w_lon,
                lat_inc=lat_inc, lon_inc=lon_inc,
                lat_shift=nodes[:, 0].astype(np.float64).reshape(rows, cols),
                lon_shift=nodes[:, 1].astype(np.float64).reshape(rows, cols),
            ))
        if not self.subgrids:
            raise ValueError(f"{path!r}: no sub-grids")

    # -- interpolation ------------------------------------------------------

    def _select(self, lat_sec: np.ndarray, lon_west_sec: np.ndarray):
        """Per-point sub-grid index: the DENSEST (smallest LAT_INC)
        containing sub-grid, i.e. the most refined child — PROJ's
        selection rule. -1 where no sub-grid contains the point."""
        choice = np.full(lat_sec.shape, -1, dtype=np.int64)
        chosen_inc = np.full(lat_sec.shape, np.inf)
        for idx, g in enumerate(self.subgrids):
            inside = g.contains(lat_sec, lon_west_sec)
            better = inside & (g.lat_inc < chosen_inc)
            choice[better] = idx
            chosen_inc[better] = g.lat_inc
        return choice

    def covers(self, lon_deg: np.ndarray, lat_deg: np.ndarray):
        """Boolean mask: which east-positive-degree points fall inside
        at least one sub-grid."""
        lat_sec = np.asarray(lat_deg, np.float64) * 3600.0
        lon_west_sec = -np.asarray(lon_deg, np.float64) * 3600.0
        return self._select(lat_sec, lon_west_sec) >= 0

    def shift_seconds(self, lon_deg: np.ndarray, lat_deg: np.ndarray,
                      choice: np.ndarray | None = None):
        """Bilinear (d_lat_sec, d_lon_east_sec) at east-positive degree
        coordinates. Raises on points outside every sub-grid — silent
        pass-through would mix datums within one output tile. `choice`
        skips the containment scan when the caller already ran _select
        on exactly these points (the +nadgrids batch hot path)."""
        lat_sec = np.asarray(lat_deg, np.float64) * 3600.0
        lon_west_sec = -np.asarray(lon_deg, np.float64) * 3600.0
        if choice is None:
            choice = self._select(lat_sec, lon_west_sec)
        if np.any(choice < 0):
            bad = np.flatnonzero(choice < 0)[0]
            raise ValueError(
                f"point (lon={lon_deg.flat[bad]:.6f}, "
                f"lat={lat_deg.flat[bad]:.6f}) is outside every sub-grid "
                f"of NTv2 file {self.path!r}")
        d_lat = np.empty_like(lat_sec)
        d_lon_west = np.empty_like(lat_sec)
        for idx in np.unique(choice):
            g = self.subgrids[idx]
            m = choice == idx
            # fractional node coordinates; row 0 at S_LAT, col 0 at E_LONG
            r = (lat_sec[m] - g.s_lat) / g.lat_inc
            c = (lon_west_sec[m] - g.e_lon) / g.lon_inc
            r0 = np.clip(np.floor(r).astype(np.int64), 0, g.rows - 2)
            c0 = np.clip(np.floor(c).astype(np.int64), 0, g.cols - 2)
            fr = r - r0
            fc = c - c0
            for out, field in ((d_lat, g.lat_shift),
                               (d_lon_west, g.lon_shift)):
                v00 = field[r0, c0]
                v01 = field[r0, c0 + 1]
                v10 = field[r0 + 1, c0]
                v11 = field[r0 + 1, c0 + 1]
                out[m] = ((1 - fr) * ((1 - fc) * v00 + fc * v01)
                          + fr * ((1 - fc) * v10 + fc * v11))
        return d_lat, -d_lon_west  # east-positive longitude shift

    def forward(self, lon_deg: np.ndarray, lat_deg: np.ndarray):
        """FROM-datum -> TO-datum (e.g. NAD27 -> NAD83) in degrees."""
        d_lat, d_lon = self.shift_seconds(lon_deg, lat_deg)
        return lon_deg + d_lon / 3600.0, lat_deg + d_lat / 3600.0

    def try_forward(self, lon_deg: np.ndarray, lat_deg: np.ndarray):
        """forward() restricted to covered points: returns (lon, lat,
        covered_mask) with uncovered coordinates passed through
        unchanged. ONE containment scan (covers + forward would run the
        per-subgrid selection twice on the tiler's batch hot path)."""
        lat_sec = np.asarray(lat_deg, np.float64) * 3600.0
        lon_west_sec = -np.asarray(lon_deg, np.float64) * 3600.0
        choice = self._select(lat_sec, lon_west_sec)
        covered = choice >= 0
        lon = np.array(lon_deg, np.float64, copy=True)
        lat = np.array(lat_deg, np.float64, copy=True)
        if np.any(covered):
            d_lat, d_lon = self.shift_seconds(lon[covered], lat[covered],
                                              choice=choice[covered])
            lon[covered] += d_lon / 3600.0
            lat[covered] += d_lat / 3600.0
        return lon, lat, covered

    def inverse(self, lon_deg: np.ndarray, lat_deg: np.ndarray,
                iterations: int = 4):
        """TO-datum -> FROM-datum: fixed-point on the smooth shift field
        (PROJ's gridshift inverse; 4 steps reach f64 roundoff for
        arc-second-scale shifts)."""
        lon = np.array(lon_deg, np.float64, copy=True)
        lat = np.array(lat_deg, np.float64, copy=True)
        for _ in range(iterations):
            d_lat, d_lon = self.shift_seconds(lon, lat)
            lon = lon_deg - d_lon / 3600.0
            lat = lat_deg - d_lat / 3600.0
        return lon, lat


_GRID_CACHE: dict = {}


def load_grid(path: str) -> NTv2Grid:
    """Memoized loader (the tiler calls the transform once per batch)."""
    key = (os.path.abspath(path), os.path.getmtime(path))
    grid = _GRID_CACHE.get(key)
    if grid is None:
        grid = _GRID_CACHE[key] = NTv2Grid(path)
    return grid
