"""Spatial reference system transforms.

Parity: SRSTransformHelper / IdentityTransform / Proj4Transform
(schwarzwald/core/util/Transformation.{h,cpp}). The reference wraps the
PROJ C library (proj_create_crs_to_crs, Transformation.cpp:74+); here the
transforms the tiler actually needs are implemented directly:

  - WGS84 geodetic (EPSG:4326 / +proj=longlat) -> Cesium world (ECEF)
  - Transverse Mercator / UTM (EPSG:326xx north, 327xx south,
    +proj=utm +zone=N [+south], +proj=tmerc ...) -> geodetic -> ECEF,
    via Karney's exact-to-nanometers 6th-order Krueger series
    (C.F.F. Karney, "Transverse Mercator with an accuracy of a few
    nanometers", J. Geod. 85, 2011)
  - Lambert conformal conic 1SP/2SP (+proj=lcc; EPSG:2154 Lambert-93 and
    the state-plane/national-grid family) via the ellipsoidal formulas of
    Snyder, "Map Projections: A Working Manual", USGS PP 1395, p. 105-110
  - Albers equal-area conic (+proj=aea; EPSG:5070 CONUS Albers),
    Snyder p. 98-103
  - Mercator, spherical (EPSG:3857 web tiles) and ellipsoidal
    (EPSG:3395, +proj=merc [+lat_ts]), Snyder p. 41-47
  - Polar stereographic (+proj=stere +lat_0=+-90; EPSG:3031/3413 polar
    LiDAR grids, EPSG:5041/5042 UPS), Snyder p. 160-163
  - Transverse Mercator on any supported ellipsoid with lat_0 != 0
    (EPSG:27700 OSGB and the non-UTM national TM grids): the Krueger
    series is evaluated per-ellipsoid and the natural-origin northing
    offset k0*M(lat_0) is folded into the false northing
  - 3/7-parameter Helmert datum shifts (+towgs84=..., position-vector
    convention, EPSG:9606) applied in ECEF after the inverse projection
  - NTv2 grid-based datum shifts (+nadgrids=<file.gsb>[,...] — the
    NAD27->NAD83 / OSTN-style path), bilinear per-point shifts with
    PROJ's densest-subgrid selection and @optional / null fallback
    semantics (io/ntv2.py); takes precedence over +towgs84 like PROJ

AABB transform follows the reference: transform the 8 corners and
re-min/max (Transformation.cpp:10-45).
"""
from __future__ import annotations

import math
import re

import numpy as np

from ..core.aabb import AABB

# WGS84 ellipsoid
_A = 6378137.0
_F = 1.0 / 298.257223563
_E2 = _F * (2 - _F)
_E = math.sqrt(_E2)


class IdentityTransform:
    def transform_positions(self, positions: np.ndarray) -> np.ndarray:
        return positions

    def transform_aabb(self, aabb: AABB) -> AABB:
        return aabb


def geodetic_to_ecef(positions: np.ndarray) -> np.ndarray:
    """lon/lat (degrees) + height -> Cesium world (ECEF) coordinates."""
    lon = np.radians(positions[:, 0])
    lat = np.radians(positions[:, 1])
    h = positions[:, 2]
    n = _A / np.sqrt(1 - _E2 * np.sin(lat) ** 2)
    out = np.empty_like(positions)
    out[:, 0] = (n + h) * np.cos(lat) * np.cos(lon)
    out[:, 1] = (n + h) * np.cos(lat) * np.sin(lon)
    out[:, 2] = (n * (1 - _E2) + h) * np.sin(lat)
    return out


# ---------------------------------------------------------------------------
# Transverse Mercator (Krueger series, order n^6)
# ---------------------------------------------------------------------------

def _krueger_series(n: float):
    """Karney 2011 eq. 12/14: the alpha (forward) and beta (inverse)
    coefficient tuples for third-flattening n, to order n^6."""
    alpha = (
        n / 2 - 2 * n ** 2 / 3 + 5 * n ** 3 / 16 + 41 * n ** 4 / 180
        - 127 * n ** 5 / 288 + 7891 * n ** 6 / 37800,
        13 * n ** 2 / 48 - 3 * n ** 3 / 5 + 557 * n ** 4 / 1440
        + 281 * n ** 5 / 630 - 1983433 * n ** 6 / 1935360,
        61 * n ** 3 / 240 - 103 * n ** 4 / 140 + 15061 * n ** 5 / 26880
        + 167603 * n ** 6 / 181440,
        49561 * n ** 4 / 161280 - 179 * n ** 5 / 168
        + 6601661 * n ** 6 / 7257600,
        34729 * n ** 5 / 80640 - 3418889 * n ** 6 / 1995840,
        212378941 * n ** 6 / 319334400,
    )
    beta = (
        n / 2 - 2 * n ** 2 / 3 + 37 * n ** 3 / 96 - n ** 4 / 360
        - 81 * n ** 5 / 512 + 96199 * n ** 6 / 604800,
        n ** 2 / 48 + n ** 3 / 15 - 437 * n ** 4 / 1440 + 46 * n ** 5 / 105
        - 1118711 * n ** 6 / 3870720,
        17 * n ** 3 / 480 - 37 * n ** 4 / 840 - 209 * n ** 5 / 4480
        + 5569 * n ** 6 / 90720,
        4397 * n ** 4 / 161280 - 11 * n ** 5 / 504
        - 830251 * n ** 6 / 7257600,
        4583 * n ** 5 / 161280 - 108847 * n ** 6 / 3991680,
        20648693 * n ** 6 / 638668800,
    )
    return alpha, beta


_N = _F / (2.0 - _F)
_A_BAR = _A / (1 + _N) * (1 + _N ** 2 / 4 + _N ** 4 / 64 + _N ** 6 / 256)
_ALPHA, _BETA = _krueger_series(_N)


def _tmerc_forward_raw(lon_deg, lat_deg, lon0_deg, k0, x0, y0,
                       a_bar, alpha, e):
    lam = np.radians(np.asarray(lon_deg, np.float64) - lon0_deg)
    phi = np.radians(np.asarray(lat_deg, np.float64))
    sphi = np.sin(phi)
    t = np.sinh(np.arctanh(sphi) - e * np.arctanh(e * sphi))
    xi = np.arctan2(t, np.cos(lam))
    eta = np.arcsinh(np.sin(lam) / np.sqrt(t * t + np.cos(lam) ** 2))
    xi_s, eta_s = xi, eta
    for j, aj in enumerate(alpha, start=1):
        xi_s = xi_s + aj * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_s = eta_s + aj * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    return (k0 * a_bar * eta_s + x0, k0 * a_bar * xi_s + y0)


def _tau_from_tau_prime(tau_p, e=_E):
    """Invert tau' = tau*sqrt(1+sigma^2) - sigma*sqrt(1+tau^2) by Newton
    (Karney 2011, eq. 19-21)."""
    e2m = 1 - e * e
    tau = tau_p / math.sqrt(e2m)  # first guess
    for _ in range(6):
        sig = np.sinh(e * np.arctanh(e * tau / np.sqrt(1 + tau * tau)))
        tau_p_i = tau * np.sqrt(1 + sig * sig) - sig * np.sqrt(1 + tau * tau)
        dtau = ((tau_p - tau_p_i) * (1 + e2m * tau * tau)
                / (e2m * np.sqrt((1 + tau_p_i * tau_p_i) * (1 + tau * tau))))
        tau = tau + dtau
    return tau


def _tmerc_inverse_raw(easting, northing, lon0_deg, k0, x0, y0,
                       a_bar, beta, e):
    xi = (np.asarray(northing, np.float64) - y0) / (k0 * a_bar)
    eta = (np.asarray(easting, np.float64) - x0) / (k0 * a_bar)
    xi_p, eta_p = xi, eta
    for j, b in enumerate(beta, start=1):
        xi_p = xi_p - b * np.sin(2 * j * xi) * np.cosh(2 * j * eta)
        eta_p = eta_p - b * np.cos(2 * j * xi) * np.sinh(2 * j * eta)
    tau_p = np.sin(xi_p) / np.sqrt(np.sinh(eta_p) ** 2 + np.cos(xi_p) ** 2)
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    tau = _tau_from_tau_prime(tau_p, e)
    lat = np.degrees(np.arctan(tau))
    lon = lon0_deg + np.degrees(lam)
    return lon, lat


def tmerc_forward(lon_deg, lat_deg, lon0_deg: float, k0: float,
                  false_easting: float, false_northing: float):
    """Geodetic (degrees) -> transverse Mercator easting/northing
    (WGS84, natural origin on the equator)."""
    return _tmerc_forward_raw(lon_deg, lat_deg, lon0_deg, k0,
                              false_easting, false_northing,
                              _A_BAR, _ALPHA, _E)


def tmerc_inverse(easting, northing, lon0_deg: float, k0: float,
                  false_easting: float, false_northing: float):
    """Transverse Mercator easting/northing -> geodetic lon/lat
    (degrees; WGS84, natural origin on the equator)."""
    return _tmerc_inverse_raw(easting, northing, lon0_deg, k0,
                              false_easting, false_northing,
                              _A_BAR, _BETA, _E)


# ---------------------------------------------------------------------------
# Conic projections (Lambert conformal 1SP/2SP, Albers equal-area)
# ---------------------------------------------------------------------------
# Ellipsoidal formulas from Snyder, USGS PP 1395. Ellipsoid is a parameter
# (default WGS84) so the published Clarke-1866 test vectors (Snyder's
# worked examples) validate the implementation independently.

_ELLIPSOIDS = {
    "wgs84": (6378137.0, 1.0 / 298.257223563),
    "grs80": (6378137.0, 1.0 / 298.257222101),
    "clrk66": (6378206.4, 1.0 - math.sqrt(1.0 - 0.00676866)),
    "airy": (6377563.396, 1.0 / 299.3249646),       # OSGB36
    "intl": (6378388.0, 1.0 / 297.0),                # ED50 / Snyder examples
    "bessel": (6377397.155, 1.0 / 299.1528128),      # DHDN / Tokyo / RD / CH
    "evrst30": (6377276.345, 1.0 / 300.8017),        # Everest 1830 (1937)
    "evrstss": (6377298.556, 1.0 / 300.8017),        # Everest (Sabah/Sarawak)
}


def _snyder_m(phi, e):
    return np.cos(phi) / np.sqrt(1 - (e * np.sin(phi)) ** 2)


def _snyder_t(phi, e):
    s = np.sin(phi)
    return (np.tan(math.pi / 4 - phi / 2)
            / ((1 - e * s) / (1 + e * s)) ** (e / 2))


def _phi_from_t(t, e):
    """Invert t(phi) (Snyder eq. 7-9, fixed-point iteration)."""
    phi = math.pi / 2 - 2 * np.arctan(t)
    for _ in range(8):
        s = e * np.sin(phi)
        phi = (math.pi / 2
               - 2 * np.arctan(t * ((1 - s) / (1 + s)) ** (e / 2)))
    return phi


class LCCParams:
    """Lambert conformal conic. 2SP when lat2 is given (EPSG:9802),
    1SP with scale k0 otherwise (EPSG:9801)."""

    def __init__(self, lat0: float, lon0: float, lat1: float,
                 lat2: float | None = None, k0: float = 1.0,
                 x0: float = 0.0, y0: float = 0.0,
                 ellipsoid: str = "wgs84", towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.e2 = f * (2 - f)
        e = math.sqrt(self.e2)
        self.a, self.e = a, e
        self.lon0 = lon0
        self.x0, self.y0 = x0, y0
        self.towgs84 = towgs84
        phi0, phi1 = math.radians(lat0), math.radians(lat1)
        m1, t1 = _snyder_m(phi1, e), _snyder_t(phi1, e)
        if lat2 is not None and lat2 != lat1:
            phi2 = math.radians(lat2)
            m2, t2 = _snyder_m(phi2, e), _snyder_t(phi2, e)
            self.n = ((math.log(m1) - math.log(m2))
                      / (math.log(t1) - math.log(t2)))
            self.k0 = 1.0
        else:
            self.n = math.sin(phi1)
            self.k0 = k0
        self.F = m1 / (self.n * t1 ** self.n)
        t0 = _snyder_t(phi0, e)
        self.rho0 = a * self.F * t0 ** self.n * self.k0


def lcc_forward(lon_deg, lat_deg, p: LCCParams):
    phi = np.radians(np.asarray(lat_deg, np.float64))
    lam = np.radians(np.asarray(lon_deg, np.float64) - p.lon0)
    t = _snyder_t(phi, p.e)
    rho = p.a * p.F * t ** p.n * p.k0
    theta = p.n * lam
    return (rho * np.sin(theta) + p.x0,
            p.rho0 - rho * np.cos(theta) + p.y0)


def lcc_inverse(easting, northing, p: LCCParams):
    sign = 1.0 if p.n >= 0 else -1.0  # southern-cone sign flips (Snyder)
    x = np.asarray(easting, np.float64) - p.x0
    y = p.rho0 - (np.asarray(northing, np.float64) - p.y0)
    rho = sign * np.sqrt(x * x + y * y)
    theta = np.arctan2(sign * x, sign * y)
    t = (rho / (p.a * p.F * p.k0)) ** (1.0 / p.n)
    phi = _phi_from_t(t, p.e)
    return (p.lon0 + np.degrees(theta / p.n), np.degrees(phi))


def _snyder_q(phi, e):
    s = np.sin(phi)
    return (1 - e * e) * (s / (1 - (e * s) ** 2)
                          - (1 / (2 * e)) * np.log((1 - e * s) / (1 + e * s)))


class AlbersParams:
    """Albers equal-area conic, two standard parallels (EPSG:9822)."""

    def __init__(self, lat0: float, lon0: float, lat1: float, lat2: float,
                 x0: float = 0.0, y0: float = 0.0,
                 ellipsoid: str = "wgs84", towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.e2 = f * (2 - f)
        e = math.sqrt(self.e2)
        self.a, self.e = a, e
        self.towgs84 = towgs84
        self.lon0 = lon0
        self.x0, self.y0 = x0, y0
        phi0 = math.radians(lat0)
        phi1, phi2 = math.radians(lat1), math.radians(lat2)
        m1, m2 = _snyder_m(phi1, e), _snyder_m(phi2, e)
        q0, q1, q2 = (_snyder_q(p, e) for p in (phi0, phi1, phi2))
        if lat1 != lat2:
            self.n = (m1 * m1 - m2 * m2) / (q2 - q1)
        else:
            self.n = math.sin(phi1)
        self.C = m1 * m1 + self.n * q1
        self.rho0 = a * math.sqrt(self.C - self.n * q0) / self.n


def albers_forward(lon_deg, lat_deg, p: AlbersParams):
    phi = np.radians(np.asarray(lat_deg, np.float64))
    lam = np.radians(np.asarray(lon_deg, np.float64) - p.lon0)
    q = _snyder_q(phi, p.e)
    rho = p.a * np.sqrt(p.C - p.n * q) / p.n
    theta = p.n * lam
    return (rho * np.sin(theta) + p.x0,
            p.rho0 - rho * np.cos(theta) + p.y0)


def albers_inverse(easting, northing, p: AlbersParams):
    sign = 1.0 if p.n >= 0 else -1.0
    x = np.asarray(easting, np.float64) - p.x0
    y = p.rho0 - (np.asarray(northing, np.float64) - p.y0)
    rho = np.sqrt(x * x + y * y)
    theta = np.arctan2(sign * x, sign * y)
    q = (p.C - (rho * p.n / p.a) ** 2) / p.n
    e, e2 = p.e, p.e * p.e
    # Snyder eq. 3-16 iteration, seeded by the spherical inverse
    phi = np.arcsin(np.clip(q / 2, -1, 1))
    for _ in range(8):
        s = np.sin(phi)
        es = e * s
        phi = phi + ((1 - es * es) ** 2 / (2 * np.cos(phi))
                     * (q / (1 - e2) - s / (1 - es * es)
                        + (1 / (2 * e)) * np.log((1 - es) / (1 + es))))
    return (p.lon0 + np.degrees(theta / p.n), np.degrees(phi))


class TmercParams:
    """Transverse Mercator on any supported ellipsoid, natural origin at
    (lat0, lon0). The Krueger series is rebuilt for the ellipsoid's
    third flattening; a nonzero lat0 becomes a constant northing offset
    -k0*M(lat0) folded into the false northing (the rectifying latitude
    xi is linear in meridian distance), so forward/inverse keep the
    equator-origin form."""

    def __init__(self, lon0: float, lat0: float = 0.0, k0: float = 0.9996,
                 x0: float = 500000.0, y0: float = 0.0,
                 ellipsoid: str = "wgs84", towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.a, self.e2 = a, f * (2 - f)
        self.e = math.sqrt(self.e2)
        n = f / (2.0 - f)
        self.a_bar = a / (1 + n) * (1 + n ** 2 / 4 + n ** 4 / 64
                                    + n ** 6 / 256)
        self.alpha, self.beta = _krueger_series(n)
        self.lon0, self.k0, self.x0 = lon0, k0, x0
        self.towgs84 = towgs84
        if lat0 != 0.0:
            # meridian distance to lat0 via the series at lam=0
            phi0 = math.radians(lat0)
            s0 = math.sin(phi0)
            t0 = math.sinh(math.atanh(s0) - self.e * math.atanh(self.e * s0))
            xi0 = math.atan(t0)
            xi_s = xi0 + sum(aj * math.sin(2 * j * xi0)
                             for j, aj in enumerate(self.alpha, start=1))
            self.y0 = y0 - k0 * self.a_bar * xi_s
        else:
            self.y0 = y0


def tmerc_forward_p(lon_deg, lat_deg, p: TmercParams):
    return _tmerc_forward_raw(lon_deg, lat_deg, p.lon0, p.k0, p.x0, p.y0,
                              p.a_bar, p.alpha, p.e)


def tmerc_inverse_p(easting, northing, p: TmercParams):
    return _tmerc_inverse_raw(easting, northing, p.lon0, p.k0, p.x0, p.y0,
                              p.a_bar, p.beta, p.e)


# ---------------------------------------------------------------------------
# Mercator (spherical web tiles / ellipsoidal), Snyder p. 41-47
# ---------------------------------------------------------------------------


class MercParams:
    """Mercator. spherical=True is the web-tile convention (EPSG:3857:
    spherical formulas on the WGS84 semi-major axis, geodetic latitude
    used directly); otherwise ellipsoidal (EPSG:3395), with the scale
    either k0 or cos(lat_ts)-derived (Snyder eq. 7-8)."""

    def __init__(self, lon0: float = 0.0, k0: float = 1.0,
                 lat_ts: float = 0.0, x0: float = 0.0, y0: float = 0.0,
                 spherical: bool = False, ellipsoid: str = "wgs84",
                 towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.spherical = spherical
        self.a = a
        self.e2 = 0.0 if spherical else f * (2 - f)
        self.e = math.sqrt(self.e2)
        self.lon0, self.x0, self.y0 = lon0, x0, y0
        self.towgs84 = towgs84
        if lat_ts != 0.0:
            phi_ts = math.radians(lat_ts)
            self.k0 = (math.cos(phi_ts) if spherical
                       else float(_snyder_m(phi_ts, self.e)))
        else:
            self.k0 = k0


def _wrap_lon(lon_deg):
    """Wrap to (-180, 180] (cylindrical/azimuthal charts are periodic)."""
    return -((-np.asarray(lon_deg, np.float64) + 180.0) % 360.0 - 180.0)


def merc_forward(lon_deg, lat_deg, p: MercParams):
    lam = np.radians(_wrap_lon(np.asarray(lon_deg, np.float64) - p.lon0))
    phi = np.radians(np.asarray(lat_deg, np.float64))
    x = p.a * p.k0 * lam
    if p.spherical:
        y = p.a * p.k0 * np.log(np.tan(math.pi / 4 + phi / 2))
    else:
        y = -p.a * p.k0 * np.log(_snyder_t(phi, p.e))
    return x + p.x0, y + p.y0


def merc_inverse(easting, northing, p: MercParams):
    x = np.asarray(easting, np.float64) - p.x0
    y = np.asarray(northing, np.float64) - p.y0
    lon = _wrap_lon(p.lon0 + np.degrees(x / (p.a * p.k0)))
    if p.spherical:
        phi = 2 * np.arctan(np.exp(y / (p.a * p.k0))) - math.pi / 2
    else:
        phi = _phi_from_t(np.exp(-y / (p.a * p.k0)), p.e)
    return lon, np.degrees(phi)


# ---------------------------------------------------------------------------
# Polar stereographic, Snyder p. 160-163 (eq. 21-33..21-40, ellipsoidal)
# ---------------------------------------------------------------------------


class PolarStereoParams:
    """Polar stereographic. Variant B (standard parallel lat_ts, EPSG:9829
    — EPSG:3031/3413) when lat_ts is given; variant A (scale k0 at the
    pole, EPSG:9810 — EPSG:5041/5042 UPS) otherwise. south selects the
    aspect (defaults to the hemisphere of lat_ts)."""

    def __init__(self, lat_ts: float | None = None, lon0: float = 0.0,
                 k0: float = 1.0, x0: float = 0.0, y0: float = 0.0,
                 south: bool | None = None, ellipsoid: str = "wgs84",
                 towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.a, self.e2 = a, f * (2 - f)
        e = self.e = math.sqrt(self.e2)
        self.lon0, self.x0, self.y0 = lon0, x0, y0
        self.towgs84 = towgs84
        self.south = (lat_ts is not None and lat_ts < 0) \
            if south is None else south
        if lat_ts is not None:
            phi_c = math.radians(abs(lat_ts))
            m_c = float(_snyder_m(phi_c, e))
            t_c = float(_snyder_t(phi_c, e))
            self.rho_factor = a * m_c / t_c  # rho = rho_factor * t
        else:
            # pole-scale form: rho = 2 a k0 t / sqrt((1+e)^(1+e)(1-e)^(1-e))
            self.rho_factor = (2.0 * a * k0
                               / math.sqrt((1 + e) ** (1 + e)
                                           * (1 - e) ** (1 - e)))


def polar_stereo_forward(lon_deg, lat_deg, p: PolarStereoParams):
    # south aspect: negate phi/lam/lam0 in, negate x/y out (Snyder p. 161)
    sgn = -1.0 if p.south else 1.0
    lam = np.radians(sgn * np.asarray(lon_deg, np.float64) - sgn * p.lon0)
    phi = np.radians(sgn * np.asarray(lat_deg, np.float64))
    t = _snyder_t(phi, p.e)
    rho = p.rho_factor * t
    x = rho * np.sin(lam)
    y = -rho * np.cos(lam)
    return sgn * x + p.x0, sgn * y + p.y0


def polar_stereo_inverse(easting, northing, p: PolarStereoParams):
    sgn = -1.0 if p.south else 1.0
    x = sgn * (np.asarray(easting, np.float64) - p.x0)
    y = sgn * (np.asarray(northing, np.float64) - p.y0)
    rho = np.sqrt(x * x + y * y)
    t = rho / p.rho_factor
    phi = _phi_from_t(t, p.e)
    lam = np.arctan2(x, -y)  # lam = sgn*(lon - lon0)
    return _wrap_lon(p.lon0 + sgn * np.degrees(lam)), sgn * np.degrees(phi)


# ---------------------------------------------------------------------------
# Oblique stereographic (EPSG:9809 "double" stereographic, PROJ +proj=sterea)
# ---------------------------------------------------------------------------


class ObliqueStereoParams:
    """Oblique (and equatorial) stereographic via the conformal sphere —
    EPSG method 9809, the Netherlands RD New projection (EPSG:28992).
    Formulas: EPSG Guidance Note 7-2, 'Oblique and Equatorial
    Stereographic'; independently vectored against the GN7-2 Amersfoort
    worked example in tests/test_srs.py."""

    def __init__(self, lat0: float, lon0: float, k0: float = 1.0,
                 x0: float = 0.0, y0: float = 0.0,
                 ellipsoid: str = "wgs84", towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.a, self.e2 = a, f * (2 - f)
        e = self.e = math.sqrt(self.e2)
        self.k0, self.x0, self.y0 = k0, x0, y0
        self.lon0 = lon0
        self.towgs84 = towgs84
        phi0 = math.radians(lat0)
        s0 = math.sin(phi0)
        nu0 = a / math.sqrt(1 - self.e2 * s0 * s0)
        rho0 = a * (1 - self.e2) / (1 - self.e2 * s0 * s0) ** 1.5
        self.R = math.sqrt(rho0 * nu0)
        n = self.n = math.sqrt(1 + self.e2 * math.cos(phi0) ** 4
                               / (1 - self.e2))
        w1 = ((1 + s0) / (1 - s0)
              * ((1 - e * s0) / (1 + e * s0)) ** e) ** n
        sin_chi1 = (w1 - 1) / (w1 + 1)
        self.c = ((n + s0) * (1 - sin_chi1)) / ((n - s0) * (1 + sin_chi1))
        w2 = self.c * w1
        self.chi0 = math.asin((w2 - 1) / (w2 + 1))
        self.lam0 = math.radians(lon0)  # Lambda_0 on the sphere = lon0


def oblique_stereo_forward(lon_deg, lat_deg, p: ObliqueStereoParams):
    lam_g = np.radians(np.asarray(lon_deg, np.float64))
    phi = np.radians(np.asarray(lat_deg, np.float64))
    # geodetic -> conformal sphere
    lam = p.n * (lam_g - math.radians(p.lon0)) + p.lam0
    s = np.sin(phi)
    es = p.e * s
    w = p.c * ((1 + s) / (1 - s) * ((1 - es) / (1 + es)) ** p.e) ** p.n
    chi = np.arcsin((w - 1) / (w + 1))
    dlam = lam - p.lam0
    b = (1 + np.sin(chi) * math.sin(p.chi0)
         + np.cos(chi) * math.cos(p.chi0) * np.cos(dlam))
    x = p.x0 + 2 * p.R * p.k0 * np.cos(chi) * np.sin(dlam) / b
    y = p.y0 + 2 * p.R * p.k0 * (np.sin(chi) * math.cos(p.chi0)
                                 - np.cos(chi) * math.sin(p.chi0)
                                 * np.cos(dlam)) / b
    return x, y


def oblique_stereo_inverse(easting, northing, p: ObliqueStereoParams):
    xp = np.asarray(easting, np.float64) - p.x0
    yp = np.asarray(northing, np.float64) - p.y0
    g = 2 * p.R * p.k0 * math.tan(math.pi / 4 - p.chi0 / 2)
    h = 4 * p.R * p.k0 * math.tan(p.chi0) + g
    i = np.arctan2(xp, h + yp)
    j = np.arctan2(xp, g - yp) - i
    chi = p.chi0 + 2 * np.arctan2(yp - xp * np.tan(j / 2), 2 * p.R * p.k0)
    lam = j + 2 * i + p.lam0
    # conformal sphere -> geodetic (iterate isometric latitude, GN7-2)
    psi = 0.5 * np.log((1 + np.sin(chi)) / (p.c * (1 - np.sin(chi)))) / p.n
    phi = 2 * np.arctan(np.exp(psi)) - math.pi / 2
    for _ in range(6):
        es = p.e * np.sin(phi)
        psi_i = np.log(np.tan(phi / 2 + math.pi / 4)
                       * ((1 - es) / (1 + es)) ** (p.e / 2))
        phi = phi - (psi_i - psi) * np.cos(phi) \
            * (1 - es * es) / (1 - p.e2)
    lon = np.degrees((lam - p.lam0) / p.n) + p.lon0
    return _wrap_lon(lon), np.degrees(phi)


# ---------------------------------------------------------------------------
# Hotine oblique Mercator (EPSG:9812 variant A / 9815 variant B,
# PROJ +proj=omerc)
# ---------------------------------------------------------------------------


class OmercParams:
    """Hotine oblique Mercator. Variant B (EPSG:9815, false coordinates at
    the projection centre — PROJ's omerc default) unless no_uoff, which
    gives variant A (EPSG:9812, natural origin — PROJ +no_uoff).
    Formulas: EPSG Guidance Note 7-2 'Hotine Oblique Mercator';
    independently vectored against the GN7-2 Timbalai 1948 / RSO Borneo
    worked example in tests/test_srs.py."""

    def __init__(self, latc: float, lonc: float, alpha: float,
                 gamma: float | None = None, k0: float = 1.0,
                 x0: float = 0.0, y0: float = 0.0, no_uoff: bool = False,
                 ellipsoid: str = "wgs84", towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.a, self.e2 = a, f * (2 - f)
        e = self.e = math.sqrt(self.e2)
        self.x0, self.y0 = x0, y0
        self.no_uoff = no_uoff
        self.towgs84 = towgs84
        phic = math.radians(latc)
        alphac = math.radians(alpha)
        self.gammac = math.radians(gamma if gamma is not None else alpha)
        sc = math.sin(phic)
        self.B = math.sqrt(1 + self.e2 * math.cos(phic) ** 4
                           / (1 - self.e2))
        self.A = (a * self.B * k0 * math.sqrt(1 - self.e2)
                  / (1 - self.e2 * sc * sc))
        t0 = float(_snyder_t(phic, e))
        D = (self.B * math.sqrt(1 - self.e2)
             / (math.cos(phic) * math.sqrt(1 - self.e2 * sc * sc)))
        D2 = max(D * D, 1.0)
        sign = -1.0 if latc < 0 else 1.0
        F = D + math.sqrt(D2 - 1) * sign
        self.H = F * t0 ** self.B
        G = (F - 1 / F) / 2
        self.gamma0 = math.asin(math.sin(alphac) / D)
        self.lam0 = (math.radians(lonc)
                     - math.asin(G * math.tan(self.gamma0)) / self.B)
        if abs(abs(alpha) - 90.0) < 1e-12:
            # GN7-2 special case alpha_c = 90
            self.uc = self.A * (math.radians(lonc) - self.lam0)
        else:
            self.uc = ((self.A / self.B)
                       * math.atan2(math.sqrt(D2 - 1), math.cos(alphac))
                       * sign)

    @classmethod
    def from_two_points(cls, lat0: float, lat1: float, lon1: float,
                        lat2: float, lon2: float, k0: float = 1.0,
                        x0: float = 0.0, y0: float = 0.0,
                        no_uoff: bool = False, ellipsoid: str = "wgs84",
                        towgs84=None) -> "OmercParams":
        """Two-point Hotine oblique Mercator (PROJ +proj=omerc +lat_1
        +lon_1 +lat_2 +lon_2): the central line passes through the two
        given points; azimuth and origin longitude are DERIVED (Snyder
        1987 eqs. 9-16..9-24) and the result delegates to the
        azimuth-form constructor, so both forms share one forward/
        inverse. Validated by internal consistency in tests/test_srs.py:
        two points taken ON the GN7-2-vectored RSO Borneo central line
        reproduce that projection's lam0/gamma0/alpha_c exactly."""
        a, f = _ELLIPSOIDS[ellipsoid]
        e2 = f * (2 - f)
        e = math.sqrt(e2)
        phi0 = math.radians(lat0)
        s0 = math.sin(phi0)
        B = math.sqrt(1 + e2 * math.cos(phi0) ** 4 / (1 - e2))
        D = (B * math.sqrt(1 - e2)
             / (math.cos(phi0) * math.sqrt(1 - e2 * s0 * s0)))
        D2 = max(D * D, 1.0)
        sign = -1.0 if lat0 < 0 else 1.0
        F = D + math.sqrt(D2 - 1) * sign  # Snyder 9-15
        t0 = float(_snyder_t(phi0, e))
        E = F * t0 ** B                   # Snyder 9-16 (E carries t0^B)
        if abs(lat1 - lat2) < 1e-12 or abs(lat1) >= 90 or abs(lat2) >= 90:
            raise ValueError(
                f"two-point omerc needs two distinct non-polar latitudes "
                f"(got lat_1={lat1}, lat_2={lat2}); with lat_1 == lat_2 "
                f"the cone parameter P is 0 (PROJ rejects this too)")
        t1 = float(_snyder_t(math.radians(lat1), e))
        t2 = float(_snyder_t(math.radians(lat2), e))
        H = t1 ** B
        L = t2 ** B
        Fs = E / H
        G = (Fs - 1 / Fs) / 2
        J = (E * E - L * H) / (E * E + L * H)
        P = (L - H) / (L + H)
        lam1, lam2 = math.radians(lon1), math.radians(lon2)
        # Snyder's arctans are PRINCIPAL VALUE: atan2 here lands on the
        # 180-degree-rotated central line whenever P < 0 (verified against
        # the azimuth form in tests/test_srs.py)
        lam0 = ((lam1 + lam2) / 2
                - math.atan(J * math.tan(B * (lam1 - lam2) / 2) / P)
                / B)                      # Snyder 9-22 (errata numbering)
        gamma0 = math.atan(math.sin(B * (lam1 - lam0)) / G)
        alphac = math.asin(D * math.sin(gamma0))
        # express as the azimuth form: the equivalent lonc reproduces this
        # lam0 through the one-point relation lam0 = lonc - asin(G tan
        # gamma0)/B (G here is the CENTER point's (F-1/F)/2)
        G_center = (F - 1 / F) / 2
        lonc = math.degrees(
            lam0 + math.asin(G_center * math.tan(gamma0)) / B)
        return cls(latc=lat0, lonc=lonc, alpha=math.degrees(alphac),
                   gamma=math.degrees(gamma0), k0=k0, x0=x0, y0=y0,
                   no_uoff=no_uoff, ellipsoid=ellipsoid, towgs84=towgs84)


def omerc_forward(lon_deg, lat_deg, p: OmercParams):
    lam = np.radians(np.asarray(lon_deg, np.float64))
    phi = np.radians(np.asarray(lat_deg, np.float64))
    t = _snyder_t(phi, p.e)
    q = p.H / t ** p.B
    s = (q - 1 / q) / 2
    bl = p.B * (lam - p.lam0)
    v_num = -np.sin(bl) * math.cos(p.gamma0) + s * math.sin(p.gamma0)
    t_big = (q + 1 / q) / 2
    u_cap = v_num / t_big
    v = p.A * np.log((1 - u_cap) / (1 + u_cap)) / (2 * p.B)
    u = (p.A * np.arctan2(s * math.cos(p.gamma0)
                          + np.sin(bl) * math.sin(p.gamma0), np.cos(bl))
         / p.B)
    if not p.no_uoff:
        # variant B: false coordinates at the projection centre
        # (uc already carries sign(lat_c); atan2 term is non-negative)
        u = u - p.uc
    x = v * math.cos(p.gammac) + u * math.sin(p.gammac) + p.x0
    y = u * math.cos(p.gammac) - v * math.sin(p.gammac) + p.y0
    return x, y


def omerc_inverse(easting, northing, p: OmercParams):
    xp = np.asarray(easting, np.float64) - p.x0
    yp = np.asarray(northing, np.float64) - p.y0
    v = xp * math.cos(p.gammac) - yp * math.sin(p.gammac)
    u = yp * math.cos(p.gammac) + xp * math.sin(p.gammac)
    if not p.no_uoff:
        u = u + p.uc
    q = np.exp(-p.B * v / p.A)
    s = (q - 1 / q) / 2
    t_big = (q + 1 / q) / 2
    bu = p.B * u / p.A
    v_cap = np.sin(bu)
    u_cap = (v_cap * math.cos(p.gamma0) + s * math.sin(p.gamma0)) / t_big
    t = (p.H / np.sqrt((1 + u_cap) / (1 - u_cap))) ** (1 / p.B)
    phi = _phi_from_t(t, p.e)
    lam = p.lam0 - np.arctan2(s * math.cos(p.gamma0)
                              - v_cap * math.sin(p.gamma0),
                              np.cos(bu)) / p.B
    return _wrap_lon(np.degrees(lam)), np.degrees(phi)


# ---------------------------------------------------------------------------
# Swiss oblique Mercator (EPSG:9814, PROJ +proj=somerc) — CH1903 / LV03
# (EPSG:21781) and CH1903+ / LV95 (EPSG:2056)
# ---------------------------------------------------------------------------


class SomercParams:
    """Swiss oblique Mercator: conformal sphere + rotation to a pseudo
    equator through the projection centre (Bern), then equatorial
    Mercator. Formulas: swisstopo, 'Formulas and constants for the
    calculation of the Swiss conformal cylindrical projection'; cross
    checked against swisstopo's published approximate polynomial series
    in tests/test_srs.py."""

    def __init__(self, lat0: float, lon0: float, k0: float = 1.0,
                 x0: float = 0.0, y0: float = 0.0,
                 ellipsoid: str = "bessel", towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.a, self.e2 = a, f * (2 - f)
        e = self.e = math.sqrt(self.e2)
        self.x0, self.y0 = x0, y0
        self.lon0 = lon0
        self.towgs84 = towgs84
        phi0 = math.radians(lat0)
        s0 = math.sin(phi0)
        self.R = (a * math.sqrt(1 - self.e2) * k0
                  / (1 - self.e2 * s0 * s0))
        self.alpha = math.sqrt(1 + self.e2 * math.cos(phi0) ** 4
                               / (1 - self.e2))
        self.b0 = math.asin(s0 / self.alpha)
        self.K = (math.log(math.tan(math.pi / 4 + self.b0 / 2))
                  - self.alpha
                  * math.log(math.tan(math.pi / 4 + phi0 / 2)
                             * ((1 - e * s0) / (1 + e * s0)) ** (e / 2)))


def somerc_forward(lon_deg, lat_deg, p: SomercParams):
    phi = np.radians(np.asarray(lat_deg, np.float64))
    es = p.e * np.sin(phi)
    S = (p.alpha * np.log(np.tan(math.pi / 4 + phi / 2)
                          * ((1 - es) / (1 + es)) ** (p.e / 2)) + p.K)
    b = 2 * np.arctan(np.exp(S)) - math.pi / 2
    lam = p.alpha * np.radians(np.asarray(lon_deg, np.float64) - p.lon0)
    lbar = np.arctan2(np.sin(lam),
                      math.sin(p.b0) * np.tan(b)
                      + math.cos(p.b0) * np.cos(lam))
    bbar = np.arcsin(math.cos(p.b0) * np.sin(b)
                     - math.sin(p.b0) * np.cos(b) * np.cos(lam))
    x = p.R * lbar + p.x0
    y = p.R * np.log(np.tan(math.pi / 4 + bbar / 2)) + p.y0
    return x, y


def somerc_inverse(easting, northing, p: SomercParams):
    lbar = (np.asarray(easting, np.float64) - p.x0) / p.R
    bbar = 2 * np.arctan(np.exp((np.asarray(northing, np.float64) - p.y0)
                                / p.R)) - math.pi / 2
    b = np.arcsin(math.cos(p.b0) * np.sin(bbar)
                  + math.sin(p.b0) * np.cos(bbar) * np.cos(lbar))
    lam = np.arctan2(np.sin(lbar),
                     math.cos(p.b0) * np.cos(lbar)
                     - math.sin(p.b0) * np.tan(bbar))
    lon = p.lon0 + np.degrees(lam) / p.alpha
    # conformal sphere latitude -> geodetic (fixed point, swisstopo)
    S = np.log(np.tan(math.pi / 4 + b / 2))
    phi = b
    for _ in range(8):
        es = p.e * np.sin(phi)
        phi = 2 * np.arctan(np.exp((S - p.K) / p.alpha
                                   + p.e * np.log(np.tan(
                                       math.pi / 4
                                       + np.arcsin(es) / 2)))) \
            - math.pi / 2
    return _wrap_lon(lon), np.degrees(phi)


# ---------------------------------------------------------------------------
# Helmert datum shift (EPSG:9606 position-vector 7-parameter)
# ---------------------------------------------------------------------------


def helmert_to_wgs84(ecef: np.ndarray, params) -> np.ndarray:
    """Apply a +towgs84 3- or 7-parameter transform to geocentric
    coordinates (position-vector sign convention: rotations rotate the
    position, matching PROJ's +towgs84). Translations in metres,
    rotations in arc-seconds, scale in ppm."""
    t = np.asarray(params, np.float64)
    if t.size == 3:
        return ecef + t
    dx, dy, dz, rx, ry, rz, s = t
    arc = math.pi / (180.0 * 3600.0)
    rx, ry, rz = rx * arc, ry * arc, rz * arc
    m = 1.0 + s * 1e-6
    rot = np.array([[1.0, -rz, ry],
                    [rz, 1.0, -rx],
                    [-ry, rx, 1.0]])
    return m * (ecef @ rot.T) + np.array([dx, dy, dz])


def geodetic_to_ecef_on(positions: np.ndarray, a: float,
                        e2: float) -> np.ndarray:
    """lon/lat/h -> geocentric on an arbitrary ellipsoid (for datum
    shifts the geocentric frame must be the SOURCE datum's)."""
    lon = np.radians(positions[:, 0])
    lat = np.radians(positions[:, 1])
    h = positions[:, 2]
    n = a / np.sqrt(1 - e2 * np.sin(lat) ** 2)
    out = np.empty_like(positions)
    out[:, 0] = (n + h) * np.cos(lat) * np.cos(lon)
    out[:, 1] = (n + h) * np.cos(lat) * np.sin(lon)
    out[:, 2] = (n * (1 - e2) + h) * np.sin(lat)
    return out


# 7-parameter shift OSGB36 -> WGS84 (OS "A guide to coordinate systems in
# Great Britain", table of Helmert parameters, inverted to the to-WGS84
# direction); 3-parameter NAD27 -> WGS84 mean-CONUS approximation
# (historic PROJ datum table) — metre-level only, like the reference's
# PROJ fallback when no grid is installed.
_OSGB36_TOWGS84 = (446.448, -125.157, 542.06, 0.15, 0.247, 0.842, -20.489)
_NAD27_TOWGS84 = (-8.0, 160.0, 176.0)


def _parse_projection(text: str):
    """Returns 'geodetic', or a *Params object for the projection."""
    s = text.strip().lower()

    def param(name, default):
        m2 = re.search(rf"\+{name}=(-?[\d.eE+]*\d)", s)
        return float(m2.group(1)) if m2 else default

    def towgs84():
        m2 = re.search(r"\+towgs84=([-\d.,eE+]+)", s)
        if m2:
            vals = tuple(float(v) for v in m2.group(1).split(","))
            if len(vals) not in (3, 7):
                raise ValueError(
                    f"+towgs84 needs 3 or 7 parameters, got {len(vals)}")
            return vals
        if "+datum=nad27" in s:
            return _NAD27_TOWGS84
        if "+datum=osgb36" in s:
            return _OSGB36_TOWGS84
        return None

    def ellps():
        if "+datum=nad27" in s:
            return "clrk66"
        if "+datum=osgb36" in s:
            return "airy"
        m2 = re.search(r"\+ellps=(\w+)", s)
        name = m2.group(1) if m2 else "wgs84"
        if name not in _ELLIPSOIDS:
            raise NotImplementedError(f"ellipsoid {name!r} not supported "
                                      f"(supported: {list(_ELLIPSOIDS)})")
        return name

    m = re.fullmatch(r"epsg:\s*(\d+)", s)
    if m:
        code = int(m.group(1))
        if code == 4326:
            return "geodetic"
        if 32601 <= code <= 32660:  # WGS84 / UTM north
            return TmercParams(lon0=(code - 32600) * 6 - 183)
        if 32701 <= code <= 32760:  # WGS84 / UTM south
            return TmercParams(lon0=(code - 32700) * 6 - 183, y0=10000000.0)
        if code == 2154:  # RGF93 / Lambert-93 (France national grid)
            return LCCParams(lat0=46.5, lon0=3.0, lat1=49.0, lat2=44.0,
                             x0=700000.0, y0=6600000.0, ellipsoid="grs80")
        if code == 5070:  # NAD83 / CONUS Albers
            return AlbersParams(lat0=23.0, lon0=-96.0, lat1=29.5,
                                lat2=45.5, ellipsoid="grs80")
        if code == 3857:  # WGS84 / web ("pseudo") Mercator
            return MercParams(spherical=True)
        if code == 3395:  # WGS84 / world Mercator (ellipsoidal)
            return MercParams()
        if code == 3031:  # WGS84 / Antarctic polar stereographic
            return PolarStereoParams(lat_ts=-71.0, lon0=0.0)
        if code == 3413:  # WGS84 / NSIDC Arctic polar stereographic
            return PolarStereoParams(lat_ts=70.0, lon0=-45.0)
        if code == 5041:  # WGS84 / UPS north
            return PolarStereoParams(k0=0.994, x0=2e6, y0=2e6, south=False)
        if code == 5042:  # WGS84 / UPS south
            return PolarStereoParams(k0=0.994, x0=2e6, y0=2e6, south=True)
        if code == 27700:  # OSGB36 / British National Grid
            return TmercParams(lat0=49.0, lon0=-2.0, k0=0.9996012717,
                               x0=400000.0, y0=-100000.0, ellipsoid="airy",
                               towgs84=_OSGB36_TOWGS84)
        if code == 28992:  # Amersfoort / RD New (Netherlands)
            return ObliqueStereoParams(
                lat0=52.0 + 9.0 / 60 + 22.178 / 3600,
                lon0=5.0 + 23.0 / 60 + 15.500 / 3600,
                k0=0.9999079, x0=155000.0, y0=463000.0,
                ellipsoid="bessel",
                towgs84=(565.417, 50.3319, 465.552,
                         -0.398957, 0.343988, -1.8774, 4.0725))
        if code in (21781, 2056):  # CH1903 / LV03 and CH1903+ / LV95
            lv95 = code == 2056
            return SomercParams(
                lat0=46.0 + 57.0 / 60 + 8.66 / 3600,
                lon0=7.0 + 26.0 / 60 + 22.50 / 3600,
                x0=2600000.0 if lv95 else 600000.0,
                y0=1200000.0 if lv95 else 200000.0,
                ellipsoid="bessel",
                towgs84=(674.374, 15.056, 405.346))
        if code == 29873:  # Timbalai 1948 / RSO Borneo (m)
            return OmercParams(
                latc=4.0, lonc=115.0,
                alpha=53.0 + 18.0 / 60 + 56.9537 / 3600,
                gamma=53.0 + 7.0 / 60 + 48.3685 / 3600,
                k0=0.99984, x0=590476.87, y0=442857.65,
                ellipsoid="evrstss", towgs84=(-679.0, 669.0, -48.0))
        raise NotImplementedError(
            f"EPSG:{code} is not supported (supported: 4326, 326xx/327xx "
            f"UTM, 2154, 5070, 3857, 3395, 3031, 3413, 5041/5042, 27700, "
            f"28992, 21781/2056, 29873; or a +proj=tmerc/utm/lcc/aea/merc/"
            f"stere/sterea/omerc/somerc/longlat string)")
    if "longlat" in s or "latlong" in s:
        shift = towgs84()
        return GeodeticParams(ellipsoid=ellps(), towgs84=shift) \
            if shift or ellps() != "wgs84" else "geodetic"
    if "+proj=utm" in s:
        zone = re.search(r"\+zone=(\d+)", s)
        if not zone:
            raise ValueError(f"+proj=utm without +zone= in {text!r}")
        return TmercParams(lon0=int(zone.group(1)) * 6 - 183,
                           y0=10000000.0 if "+south" in s else 0.0,
                           ellipsoid=ellps(), towgs84=towgs84())
    if "+proj=tmerc" in s:
        return TmercParams(lon0=param("lon_0", 0.0),
                           lat0=param("lat_0", 0.0),
                           k0=param("k_0", param("k", 1.0)),
                           x0=param("x_0", 0.0), y0=param("y_0", 0.0),
                           ellipsoid=ellps(), towgs84=towgs84())
    if "+proj=merc" in s:
        # the web-mercator proj string is spherical: +a == +b (or +R)
        a_p = param("a", None)
        b_p = param("b", None)
        spherical = ("+r=" in s) or (a_p is not None and a_p == b_p)
        return MercParams(lon0=param("lon_0", 0.0),
                          k0=param("k_0", param("k", 1.0)),
                          lat_ts=param("lat_ts", 0.0),
                          x0=param("x_0", 0.0), y0=param("y_0", 0.0),
                          spherical=spherical, ellipsoid=ellps(),
                          towgs84=towgs84())
    if "+proj=sterea" in s:
        return ObliqueStereoParams(lat0=param("lat_0", 0.0),
                                   lon0=param("lon_0", 0.0),
                                   k0=param("k_0", param("k", 1.0)),
                                   x0=param("x_0", 0.0),
                                   y0=param("y_0", 0.0),
                                   ellipsoid=ellps(), towgs84=towgs84())
    if "+proj=stere" in s:
        lat0 = param("lat_0", 90.0)
        if abs(lat0) != 90.0:
            # PROJ's oblique +proj=stere differs from the double
            # stereographic; route the oblique aspect through the
            # conformal-sphere method only where that IS the CRS's
            # definition (+proj=sterea above, EPSG:9809)
            raise NotImplementedError(
                f"oblique +proj=stere (lat_0={lat0}) is not supported; "
                f"polar aspects (+lat_0=+-90) and the double "
                f"stereographic (+proj=sterea, EPSG:9809) are")
        lat_ts = param("lat_ts", None)
        return PolarStereoParams(lat_ts=lat_ts, lon0=param("lon_0", 0.0),
                                 k0=param("k_0", param("k", 1.0)),
                                 x0=param("x_0", 0.0), y0=param("y_0", 0.0),
                                 south=lat0 < 0, ellipsoid=ellps(),
                                 towgs84=towgs84())
    if "+proj=somerc" in s:
        return SomercParams(lat0=param("lat_0", 0.0),
                            lon0=param("lon_0", 0.0),
                            k0=param("k_0", param("k", 1.0)),
                            x0=param("x_0", 0.0), y0=param("y_0", 0.0),
                            ellipsoid=ellps(), towgs84=towgs84())
    if "+proj=omerc" in s:
        alpha = param("alpha", None)
        if alpha is None:
            lat1, lon1 = param("lat_1", None), param("lon_1", None)
            lat2, lon2 = param("lat_2", None), param("lon_2", None)
            if None in (lat1, lon1, lat2, lon2):
                raise NotImplementedError(
                    f"+proj=omerc needs +alpha or the two-point form "
                    f"(+lat_1 +lon_1 +lat_2 +lon_2) in {text!r}")
            return OmercParams.from_two_points(
                lat0=param("lat_0", 0.0), lat1=lat1, lon1=lon1,
                lat2=lat2, lon2=lon2, k0=param("k_0", param("k", 1.0)),
                x0=param("x_0", 0.0), y0=param("y_0", 0.0),
                no_uoff="+no_uoff" in s or "+no_off" in s,
                ellipsoid=ellps(), towgs84=towgs84())
        return OmercParams(latc=param("lat_0", 0.0),
                           lonc=param("lonc", param("lon_0", 0.0)),
                           alpha=alpha, gamma=param("gamma", None),
                           k0=param("k_0", param("k", 1.0)),
                           x0=param("x_0", 0.0), y0=param("y_0", 0.0),
                           no_uoff="+no_uoff" in s or "+no_off" in s,
                           ellipsoid=ellps(), towgs84=towgs84())
    if "+proj=lcc" in s:
        # EPSG:9801 (1SP) gives only lat_0 — the natural origin IS the
        # single standard parallel; EPSG:9802 (2SP) gives lat_1/lat_2
        lat0 = param("lat_0", None)
        lat1 = param("lat_1", lat0 if lat0 is not None else 0.0)
        lat2 = re.search(r"\+lat_2=(-?[\d.]+)", s)
        two_sp = lat2 is not None and float(lat2.group(1)) != lat1
        # Only the 1SP form degenerates at the equator (n = sin(lat1) = 0);
        # a 2SP cone with lat_1=0, lat_2!=0 has a nonzero cone constant
        # n = (ln m1 - ln m2) / (ln t1 - ln t2).
        if lat1 == 0.0 and lat0 in (None, 0.0) and not two_sp:
            raise NotImplementedError(
                f"+proj=lcc without a standard parallel (lat_1 or lat_0) "
                f"in {text!r}: the 1SP cone constant would be 0")
        return LCCParams(lat0=lat0 if lat0 is not None else lat1,
                         lon0=param("lon_0", 0.0),
                         lat1=lat1,
                         lat2=float(lat2.group(1)) if lat2 else None,
                         k0=param("k_0", param("k", 1.0)),
                         x0=param("x_0", 0.0), y0=param("y_0", 0.0),
                         ellipsoid=ellps())
    if "+proj=aea" in s:
        return AlbersParams(lat0=param("lat_0", 0.0),
                            lon0=param("lon_0", 0.0),
                            lat1=param("lat_1", 0.0),
                            lat2=param("lat_2", 0.0),
                            x0=param("x_0", 0.0), y0=param("y_0", 0.0),
                            ellipsoid=ellps())
    raise NotImplementedError(
        f"Source projection {text!r} is not supported (supported: WGS84 "
        f"geodetic, UTM EPSG:326xx/327xx, EPSG:2154, 5070, 3857, 3395, "
        f"3031, 3413, 5041/5042, 27700, 28992, 21781/2056, 29873, and "
        f"+proj=utm/tmerc/lcc/aea/merc/stere/sterea/omerc/somerc/longlat "
        f"strings with optional +towgs84 / +nadgrids=<file.gsb>)")


class GeodeticParams:
    """Geodetic lon/lat on a non-WGS84 datum (ellipsoid + optional
    +towgs84 shift)."""

    def __init__(self, ellipsoid: str = "wgs84", towgs84=None):
        a, f = _ELLIPSOIDS[ellipsoid]
        self.a, self.e2 = a, f * (2 - f)
        self.towgs84 = towgs84


def _parse_nadgrids(text: str):
    """Case-SENSITIVE +nadgrids parse (values are file paths); returns
    the comma-separated spec list or None."""
    m = re.search(r"\+nadgrids=(\S+)", text)
    return m.group(1).split(",") if m else None


def _apply_nadgrids(specs, lon_deg, lat_deg):
    """PROJ +nadgrids semantics: try each spec in order; points covered
    by an earlier grid never see a later one; '@' marks an optional
    (skippable-if-missing) file; 'null' is the identity for everything
    still unshifted. Points no spec covers raise — silent pass-through
    would mix datums inside one output tile."""
    import os

    from . import ntv2

    lon = np.array(lon_deg, np.float64, copy=True)
    lat = np.array(lat_deg, np.float64, copy=True)
    remaining = np.ones(lon.shape, dtype=bool)
    for spec in specs:
        optional = spec.startswith("@")
        name = spec[1:] if optional else spec
        if name == "null":
            return lon, lat
        if not os.path.exists(name):
            if optional:
                continue
            raise FileNotFoundError(
                f"+nadgrids file {name!r} not found (prefix with '@' to "
                f"make it optional)")
        grid = ntv2.load_grid(name)
        if remaining.all():
            lon, lat, covered = grid.try_forward(lon, lat)
            remaining &= ~covered
        else:
            g_lon, g_lat, covered = grid.try_forward(lon[remaining],
                                                     lat[remaining])
            idx = np.flatnonzero(remaining)
            lon[idx], lat[idx] = g_lon, g_lat
            remaining[idx[covered]] = False
        if not remaining.any():
            return lon, lat
    if remaining.any():
        bad = np.flatnonzero(remaining)[0]
        raise ValueError(
            f"point (lon={lon_deg[bad]:.6f}, lat={lat_deg[bad]:.6f}) is "
            f"outside every +nadgrids grid {specs} (append ',null' to "
            f"pass uncovered points through unshifted)")
    return lon, lat


class Proj4Transform:
    """Source CRS -> Cesium world (ECEF). Geodetic WGS84 directly;
    projected CRS via the projection inverse to geodetic on the source
    ellipsoid, then geocentric, then an optional Helmert +towgs84 shift
    into the WGS84 frame — or, when +nadgrids is present, a grid-based
    geodetic-stage shift into the target datum (treated as WGS84, like
    PROJ) that takes precedence over +towgs84."""

    def __init__(self, source_projection: str):
        self.source_projection = source_projection
        self._params = _parse_projection(source_projection)
        self._nadgrids = _parse_nadgrids(source_projection)

    def transform_positions(self, positions: np.ndarray) -> np.ndarray:
        if self._params == "geodetic" and not self._nadgrids:
            return geodetic_to_ecef(positions)
        p = self._params
        if p == "geodetic" or isinstance(p, GeodeticParams):
            lon, lat = positions[:, 0], positions[:, 1]
        elif isinstance(p, LCCParams):
            lon, lat = lcc_inverse(positions[:, 0], positions[:, 1], p)
        elif isinstance(p, AlbersParams):
            lon, lat = albers_inverse(positions[:, 0], positions[:, 1], p)
        elif isinstance(p, MercParams):
            lon, lat = merc_inverse(positions[:, 0], positions[:, 1], p)
        elif isinstance(p, PolarStereoParams):
            lon, lat = polar_stereo_inverse(positions[:, 0],
                                            positions[:, 1], p)
        elif isinstance(p, ObliqueStereoParams):
            lon, lat = oblique_stereo_inverse(positions[:, 0],
                                              positions[:, 1], p)
        elif isinstance(p, OmercParams):
            lon, lat = omerc_inverse(positions[:, 0], positions[:, 1], p)
        elif isinstance(p, SomercParams):
            lon, lat = somerc_inverse(positions[:, 0], positions[:, 1], p)
        else:
            lon, lat = tmerc_inverse_p(positions[:, 0], positions[:, 1], p)
        if self._nadgrids:
            # geodetic-stage grid shift into the target datum; the result
            # is WGS84-frame geodetic (NAD83 == WGS84 at grid accuracy,
            # PROJ's treatment), so +towgs84 never also applies
            lon, lat = _apply_nadgrids(
                self._nadgrids, np.asarray(lon, np.float64),
                np.asarray(lat, np.float64))
            return geodetic_to_ecef(
                np.column_stack([lon, lat, positions[:, 2]]))
        geo = np.column_stack([lon, lat, positions[:, 2]])
        # Web Mercator heights are WGS84-ellipsoidal and its latitude is
        # WGS84-geodetic by convention, so the spherical radius never
        # enters the ECEF stage.
        a, e2 = ((_A, _E2) if getattr(p, "spherical", False)
                 else (p.a, p.e2))
        ecef = geodetic_to_ecef_on(geo, a, e2)
        if getattr(p, "towgs84", None):
            ecef = helmert_to_wgs84(ecef, p.towgs84)
        return ecef

    def transform_aabb(self, aabb: AABB) -> AABB:
        corners = np.array([[aabb.min[0] if i & 1 else aabb.max[0],
                             aabb.min[1] if i & 2 else aabb.max[1],
                             aabb.min[2] if i & 4 else aabb.max[2]]
                            for i in range(8)])
        transformed = self.transform_positions(corners)
        return AABB(transformed.min(axis=0), transformed.max(axis=0))


def make_transform(source_projection: str | None):
    if source_projection:
        return Proj4Transform(source_projection)
    return IdentityTransform()
