"""Spherical/local coordinate conversions (accelerator-first rebuild).

Replaces the reference's external ``astroutils.geometry`` dependency
(imported at /root/reference/prisim/interferometry.py:18-25 and used
throughout, e.g. altaz2dircos/hadec2altaz in observe(),
/root/reference/prisim/interferometry.py:6150-6185).

Conventions (matching the reference):
  * altaz:  (altitude, azimuth) in degrees; azimuth measured East of North.
  * hadec:  (hour angle, declination) in degrees; HA = LST - RA.
  * radec:  (right ascension, declination) in degrees.
  * dircos: (l, m, n) direction cosines aligned with local (East, North, Up).

Every function is written against an array namespace ``xp`` (jax.numpy by
default) so the same math runs inside jit on device and in float64 numpy on the
host for golden tests.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np


def _deg2rad(x, xp):
    return x * (xp.pi / 180.0)


def _rad2deg(x, xp):
    return x * (180.0 / xp.pi)


def altaz2dircos(altaz, xp=jnp):
    """(N,2) alt-az degrees -> (N,3) direction cosines (E, N, U)."""
    alt = _deg2rad(altaz[..., 0], xp)
    az = _deg2rad(altaz[..., 1], xp)
    l = xp.cos(alt) * xp.sin(az)
    m = xp.cos(alt) * xp.cos(az)
    n = xp.sin(alt)
    return xp.stack([l, m, n], axis=-1)


def dircos2altaz(dircos, xp=jnp):
    """(N,3) direction cosines -> (N,2) alt-az in degrees."""
    l, m, n = dircos[..., 0], dircos[..., 1], dircos[..., 2]
    alt = xp.arcsin(xp.clip(n, -1.0, 1.0))
    az = xp.arctan2(l, m) % (2.0 * xp.pi)
    return xp.stack([_rad2deg(alt, xp), _rad2deg(az, xp)], axis=-1)


def hadec2altaz(hadec, latitude, xp=jnp):
    """(N,2) (HA, dec) degrees -> (N,2) (alt, az) degrees at given latitude."""
    ha = _deg2rad(hadec[..., 0], xp)
    dec = _deg2rad(hadec[..., 1], xp)
    lat = _deg2rad(xp.asarray(latitude), xp)
    sinalt = xp.sin(dec) * xp.sin(lat) + xp.cos(dec) * xp.cos(lat) * xp.cos(ha)
    sinalt = xp.clip(sinalt, -1.0, 1.0)
    alt = xp.arcsin(sinalt)
    # Azimuth east of north.
    y = -xp.cos(dec) * xp.sin(ha)
    x = xp.sin(dec) * xp.cos(lat) - xp.cos(dec) * xp.sin(lat) * xp.cos(ha)
    az = xp.arctan2(y, x) % (2.0 * xp.pi)
    return xp.stack([_rad2deg(alt, xp), _rad2deg(az, xp)], axis=-1)


def altaz2hadec(altaz, latitude, xp=jnp):
    """(N,2) (alt, az) degrees -> (N,2) (HA, dec) degrees at given latitude."""
    alt = _deg2rad(altaz[..., 0], xp)
    az = _deg2rad(altaz[..., 1], xp)
    lat = _deg2rad(xp.asarray(latitude), xp)
    sindec = xp.sin(alt) * xp.sin(lat) + xp.cos(alt) * xp.cos(lat) * xp.cos(az)
    sindec = xp.clip(sindec, -1.0, 1.0)
    dec = xp.arcsin(sindec)
    y = -xp.cos(alt) * xp.sin(az)
    x = xp.sin(alt) * xp.cos(lat) - xp.cos(alt) * xp.sin(lat) * xp.cos(az)
    ha = xp.arctan2(y, x) % (2.0 * xp.pi)
    ha = xp.where(ha > xp.pi, ha - 2.0 * xp.pi, ha)  # wrap to (-180, 180]
    return xp.stack([_rad2deg(ha, xp), _rad2deg(dec, xp)], axis=-1)


def radec2altaz(radec, lst_deg, latitude, xp=jnp):
    """(N,2) (RA, dec) degrees + LST (deg) -> (N,2) (alt, az) degrees."""
    ha = (lst_deg - radec[..., 0]) % 360.0
    hadec = xp.stack([ha, radec[..., 1]], axis=-1)
    return hadec2altaz(hadec, latitude, xp=xp)


def hadec2dircos(hadec, latitude, xp=jnp):
    return altaz2dircos(hadec2altaz(hadec, latitude, xp=xp), xp=xp)


def enu2xyz(enu, latitude, xp=jnp):
    """Local ENU -> equatorial XYZ (X toward HA=0/dec=0, Z toward NCP)."""
    lat = _deg2rad(xp.asarray(latitude), xp)
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    x = -n * xp.sin(lat) + u * xp.cos(lat)
    y = e
    z = n * xp.cos(lat) + u * xp.sin(lat)
    return xp.stack([x, y, z], axis=-1)


def xyz2enu(xyz, latitude, xp=jnp):
    """Equatorial XYZ -> local ENU (inverse of enu2xyz)."""
    lat = _deg2rad(xp.asarray(latitude), xp)
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    e = y
    n = -x * xp.sin(lat) + z * xp.cos(lat)
    u = x * xp.cos(lat) + z * xp.sin(lat)
    return xp.stack([e, n, u], axis=-1)


def sphdist(lon1, lat1, lon2, lat2, xp=jnp):
    """Great-circle distance (degrees) between (lon, lat) points in degrees.

    Haversine formulation (stable at small separations); replaces
    astroutils GEOM.sphdist used for off-axis beam angles
    (/root/reference/prisim/primary_beams.py:602-604).
    """
    p1 = _deg2rad(lat1, xp)
    p2 = _deg2rad(lat2, xp)
    dl = _deg2rad(lon2 - lon1, xp)
    dp = p2 - p1
    a = xp.sin(dp / 2.0) ** 2 + xp.cos(p1) * xp.cos(p2) * xp.sin(dl / 2.0) ** 2
    return _rad2deg(2.0 * xp.arcsin(xp.sqrt(xp.clip(a, 0.0, 1.0))), xp)


def spherematch_host(lon1, lat1, lon2, lat2, matchrad_deg):
    """Host-side cone match: indices of (lon2, lat2) within matchrad of any
    (lon1, lat1) point. Replaces astroutils GEOM.spherematch as used for the
    per-snapshot ROI source cut (/root/reference/scripts/run_prisim.py:1715-1726).

    Returns (idx1, idx2, dist_deg) like the reference's maxmatches=0 mode.
    """
    lon1 = np.atleast_1d(np.asarray(lon1, dtype=np.float64))
    lat1 = np.atleast_1d(np.asarray(lat1, dtype=np.float64))
    lon2 = np.asarray(lon2, dtype=np.float64)
    lat2 = np.asarray(lat2, dtype=np.float64)
    v1 = altaz2dircos(np.stack([lat1, lon1], axis=-1), xp=np)  # reuse math:
    # note altaz2dircos(lat, lon) gives unit vectors for any spherical frame.
    v2 = altaz2dircos(np.stack([lat2, lon2], axis=-1), xp=np)
    cosr = np.cos(np.radians(matchrad_deg))
    dots = v1 @ v2.T  # (N1, N2)
    i1, i2 = np.where(dots >= cosr)
    d = np.degrees(np.arccos(np.clip(dots[i1, i2], -1.0, 1.0)))
    return i1, i2, d


# -- Earth-fixed (WGS84) conversions, host-side -----------------------------

_WGS84_A = 6378137.0
_WGS84_F = 1.0 / 298.257223563


def lla2ecef(lat_deg, lon_deg, alt_m=0.0):
    """Geodetic lat/lon/alt -> ECEF XYZ meters (WGS84). Host numpy.
    (astroutils.geometry.lla2ecef equivalent, used by the reference's
    UVData adapter at /root/reference/prisim/interferometry.py:9545-9550.)"""
    lat = np.radians(np.asarray(lat_deg, dtype=np.float64))
    lon = np.radians(np.asarray(lon_deg, dtype=np.float64))
    alt = np.asarray(alt_m, dtype=np.float64)
    e2 = _WGS84_F * (2.0 - _WGS84_F)
    N = _WGS84_A / np.sqrt(1.0 - e2 * np.sin(lat) ** 2)
    x = (N + alt) * np.cos(lat) * np.cos(lon)
    y = (N + alt) * np.cos(lat) * np.sin(lon)
    z = (N * (1.0 - e2) + alt) * np.sin(lat)
    return np.stack([x, y, z], axis=-1)


def enu2ecef(enu, lat_deg, lon_deg, alt_m=0.0):
    """Local ENU offsets at (lat, lon, alt) -> absolute ECEF XYZ meters."""
    enu = np.asarray(enu, dtype=np.float64)
    lat = np.radians(np.float64(lat_deg))
    lon = np.radians(np.float64(lon_deg))
    e, n, u = enu[..., 0], enu[..., 1], enu[..., 2]
    x = -np.sin(lon) * e - np.sin(lat) * np.cos(lon) * n \
        + np.cos(lat) * np.cos(lon) * u
    y = np.cos(lon) * e - np.sin(lat) * np.sin(lon) * n \
        + np.cos(lat) * np.sin(lon) * u
    z = np.cos(lat) * n + np.sin(lat) * u
    origin = lla2ecef(lat_deg, lon_deg, alt_m)
    return np.stack([x, y, z], axis=-1) + origin
