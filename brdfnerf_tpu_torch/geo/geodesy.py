"""Geodesy kernels: ECEF <-> geodetic <-> UTM, sun directions, scaling
(the port's copy of the JAX package's geo/geodesy.py, NumPy path only:
the JAX package's native C++ dispatch of large UTM batches is not
copied, ROADMAP.md Queue 1 item 7).

Self-contained (no pyproj / utm / rpcm): ECEF conversions use the same
closed forms as the reference (sat_utils.py:110-146); UTM uses the
Karney-Krueger 6th-order transverse-Mercator series (the same series pyproj
evaluates for +proj=utm), accurate to sub-millimeter for |lon - lon0| < 10deg,
far beyond the meter-scale DSM fidelity the pipeline needs.

These conversions run HOST-SIDE in float64 NumPy: they feed dataset
ingestion and DSM evaluation, where meter-level absolute coordinates
(|UTM| ~ 5e6 m) exceed float32 precision.  Device-side training math uses
scene-normalized O(1) float32 coordinates instead (datasets normalize via
scaling_params, matching satellite.py:141-164).
"""

from __future__ import annotations

import math

import numpy as np

# WGS84
_A = 6378137.0
_FINV = 298.257223563
_F = 1.0 / _FINV
_E2 = 1.0 - (1.0 - _F) * (1.0 - _F)
_K0 = 0.9996
_E = math.sqrt(_E2)


def latlon_to_ecef(lat, lon, alt):
    """Geodetic degrees -> ECEF meters (sat_utils.py:110-125)."""
    rad_lat = lat * (np.pi / 180.0)
    rad_lon = lon * (np.pi / 180.0)
    v = _A / np.sqrt(1.0 - _E2 * np.sin(rad_lat) ** 2)
    x = (v + alt) * np.cos(rad_lat) * np.cos(rad_lon)
    y = (v + alt) * np.cos(rad_lat) * np.sin(rad_lon)
    z = (v * (1.0 - _E2) + alt) * np.sin(rad_lat)
    return x, y, z


def ecef_to_latlon(x, y, z):
    """ECEF meters -> geodetic degrees (Bowring; sat_utils.py:127-146)."""
    a = _A
    e = 8.1819190842622e-2
    asq = a * a
    esq = e * e
    b = np.sqrt(asq * (1.0 - esq))
    ep = np.sqrt((asq - b * b) / (b * b))
    p = np.sqrt(x * x + y * y)
    th = np.arctan2(a * z, b * p)
    lon = np.arctan2(y, x)
    lat = np.arctan2(z + ep * ep * b * np.sin(th) ** 3,
                      p - esq * a * np.cos(th) ** 3)
    n = a / np.sqrt(1.0 - esq * np.sin(lat) ** 2)
    alt = p / np.cos(lat) - n
    return lat * 180.0 / np.pi, lon * 180.0 / np.pi, alt


def utm_zone_from_latlon(lat0: float, lon0: float):
    """UTM zone number + hemisphere letter band, from the first point
    (mirrors utm.latlon_to_zone_number / latitude_to_zone_letter usage in
    sat_utils.py:156-157)."""
    zone = int((lon0 + 180.0) // 6) + 1
    # special zones (Norway / Svalbard), matching the `utm` package
    if 56.0 <= lat0 < 64.0 and 3.0 <= lon0 < 12.0:
        zone = 32
    if 72.0 <= lat0 <= 84.0:
        if 0.0 <= lon0 < 9.0:
            zone = 31
        elif 9.0 <= lon0 < 21.0:
            zone = 33
        elif 21.0 <= lon0 < 33.0:
            zone = 35
        elif 33.0 <= lon0 < 42.0:
            zone = 37
    letters = "CDEFGHJKLMNPQRSTUVWXX"
    idx = int((lat0 + 80.0) // 8)
    letter = letters[max(0, min(idx, len(letters) - 1))]
    return zone, letter


# --- Karney-Krueger series coefficients (6th order in n) ---
_N = _F / (2.0 - _F)
_N2, _N3, _N4, _N5, _N6 = _N**2, _N**3, _N**4, _N**5, _N**6
# rectifying radius
_A_CAP = _A / (1.0 + _N) * (1.0 + _N2 / 4.0 + _N4 / 64.0 + _N6 / 256.0)
_ALPHA = (
    _N / 2.0 - 2.0 * _N2 / 3.0 + 5.0 * _N3 / 16.0 + 41.0 * _N4 / 180.0
    - 127.0 * _N5 / 288.0 + 7891.0 * _N6 / 37800.0,
    13.0 * _N2 / 48.0 - 3.0 * _N3 / 5.0 + 557.0 * _N4 / 1440.0
    + 281.0 * _N5 / 630.0 - 1983433.0 * _N6 / 1935360.0,
    61.0 * _N3 / 240.0 - 103.0 * _N4 / 140.0 + 15061.0 * _N5 / 26880.0
    + 167603.0 * _N6 / 181440.0,
    49561.0 * _N4 / 161280.0 - 179.0 * _N5 / 168.0 + 6601661.0 * _N6 / 7257600.0,
    34729.0 * _N5 / 80640.0 - 3418889.0 * _N6 / 1995840.0,
    212378941.0 * _N6 / 319334400.0,
)
_BETA = (
    _N / 2.0 - 2.0 * _N2 / 3.0 + 37.0 * _N3 / 96.0 - _N4 / 360.0
    - 81.0 * _N5 / 512.0 + 96199.0 * _N6 / 604800.0,
    _N2 / 48.0 + _N3 / 15.0 - 437.0 * _N4 / 1440.0 + 46.0 * _N5 / 105.0
    - 1118711.0 * _N6 / 3870720.0,
    17.0 * _N3 / 480.0 - 37.0 * _N4 / 840.0 - 209.0 * _N5 / 4480.0
    + 5569.0 * _N6 / 90720.0,
    4397.0 * _N4 / 161280.0 - 11.0 * _N5 / 504.0 - 830251.0 * _N6 / 7257600.0,
    4583.0 * _N5 / 161280.0 - 108847.0 * _N6 / 3991680.0,
    20648693.0 * _N6 / 638668800.0,
)


def utm_from_latlon(lats, lons, zone: int | None = None,
                    southern: bool | None = None):
    """Geodetic degrees -> UTM (easting, northing) meters.

    If zone is None it is derived from the first point (like
    sat_utils.utm_from_latlon:148-162, which fixes the zone from element 0).
    Returns (easting, northing).  Southern-hemisphere northings carry the
    10,000,000 m false northing, matching +proj=utm.  Callers that already
    hold the scene's (zone, 'N'/'S') should pass `southern` explicitly —
    inferring it from the first point would shift an equator-straddling
    cloud by 1e7 m if that point were an outlier on the wrong side.
    """
    lats = np.asarray(lats, dtype=np.float64)
    lons = np.asarray(lons, dtype=np.float64)
    if zone is None:
        zone, _ = utm_zone_from_latlon(float(np.asarray(lats, dtype=np.float64).ravel()[0]),
                                       float(np.asarray(lons, dtype=np.float64).ravel()[0]))
    lon0 = math.radians(zone * 6.0 - 183.0)
    phi = np.deg2rad(np.asarray(lats, dtype=np.float64))
    lam = np.deg2rad(lons) - lon0

    # conformal latitude
    e = _E
    t = np.sinh(np.arctanh(np.sin(phi))
                 - e * np.arctanh(e * np.sin(phi)))
    xi_p = np.arctan2(t, np.cos(lam))
    eta_p = np.arcsinh(np.sin(lam) / np.sqrt(t * t + np.cos(lam) ** 2))

    # series over sin/cos(2j xi_p) * cosh/sinh(2j eta_p): evaluate the
    # four j=1 transcendentals once and advance j by angle-addition
    # (24 transcendental array passes -> 4; error of the recurrence is
    # ~ulp over 6 doublings, verified against the direct form in tests)
    s2, c2 = np.sin(2.0 * xi_p), np.cos(2.0 * xi_p)
    sh2, ch2 = np.sinh(2.0 * eta_p), np.cosh(2.0 * eta_p)
    sj, cj, shj, chj = s2, c2, sh2, ch2
    xi = xi_p
    eta = eta_p
    for j, a in enumerate(_ALPHA, start=1):
        if j > 1:
            sj, cj = sj * c2 + cj * s2, cj * c2 - sj * s2
            shj, chj = shj * ch2 + chj * sh2, chj * ch2 + shj * sh2
        xi = xi + a * sj * chj
        eta = eta + a * cj * shj

    easting = _K0 * _A_CAP * eta + 500000.0
    northing = _K0 * _A_CAP * xi
    # the false northing follows the SCENE's hemisphere (explicit arg when
    # the caller knows it, else first point, like the zone), not each
    # point's: a +proj=utm CRS applies one false northing to every
    # coordinate, so an equator-straddling cloud must stay continuous
    # (per-point application would split it by 1e7 m)
    if southern is None:
        southern = bool(lats.ravel()[0] < 0.0) if lats.size else False
    if southern:
        northing = northing + 10000000.0
    return easting, northing


def latlon_from_utm(easting, northing, zone: int, northern: bool = True):
    """UTM meters -> geodetic degrees (inverse Karney-Krueger series)."""
    easting = np.asarray(easting)
    northing = np.asarray(northing)
    y = np.where(np.asarray(northern), northing, northing - 10000000.0)
    xi = y / (_K0 * _A_CAP)
    eta = (easting - 500000.0) / (_K0 * _A_CAP)

    # same angle-addition recurrence as the forward series
    s2, c2 = np.sin(2.0 * xi), np.cos(2.0 * xi)
    sh2, ch2 = np.sinh(2.0 * eta), np.cosh(2.0 * eta)
    sj, cj, shj, chj = s2, c2, sh2, ch2
    xi_p = xi
    eta_p = eta
    for j, b in enumerate(_BETA, start=1):
        if j > 1:
            sj, cj = sj * c2 + cj * s2, cj * c2 - sj * s2
            shj, chj = shj * ch2 + chj * sh2, chj * ch2 + shj * sh2
        xi_p = xi_p - b * sj * chj
        eta_p = eta_p - b * cj * shj

    chi = np.arcsin(np.sin(xi_p) / np.cosh(eta_p))
    # geodetic latitude from conformal latitude: fixed-point
    # phi <- arctan( sinh( asinh(tan chi) + e * atanh(e * sin phi) ) ),
    # converging to ~1e-12 rad in < 8 iterations at mid-latitudes.
    t0 = np.arcsinh(np.tan(chi))
    phi = chi
    for _ in range(8):
        phi = np.arctan(np.sinh(t0 + _E * np.arctanh(_E * np.sin(phi))))
    lam = np.arctan2(np.sinh(eta_p), np.cos(xi_p))
    lon0 = zone * 6.0 - 183.0
    return np.rad2deg(phi), np.rad2deg(lam) + lon0


def sun_direction(sun_elevation_deg, sun_azimuth_deg):
    """Unit sun direction [sin(az)cos(el), cos(az)cos(el), sin(el)]
    (datasets/satellite.py:239-254)."""
    el = np.deg2rad(np.asarray(sun_elevation_deg))
    az = np.deg2rad(np.asarray(sun_azimuth_deg))
    d = np.stack([np.sin(az) * np.cos(el),
                   np.cos(az) * np.cos(el),
                   np.sin(el)], axis=-1)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


def scaling_params(v):
    """Half-range scale and center offset of a vector (sat_utils.py:81-88)."""
    vec = np.asarray(v).ravel()
    scale = (vec.max() - vec.min()) / 2.0
    offset = vec.min() + scale
    return float(scale), float(offset)
