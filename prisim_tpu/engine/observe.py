"""Snapshot / drift-scan observation drivers (functional observe()).

The reference's InterferometerArray.observe()/observing_run()
(/root/reference/prisim/interferometry.py:5874-6660) becomes a pure
function scanned over accumulations:

  host (float64): ephemeris -> per-snapshot ENU rotation matrices and
  phase-center dircos, split to two-float32;
  device (jit):   rotate celestial unit vectors to ENU in double-float,
  evaluate beams in f32, beam-weight the precomputed spectrum, and run the
  NUDFT kernel; lax.scan over snapshots.

No astropy-in-the-loop, no per-snapshot host round trips, static shapes
throughout.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as CNST
from .. import geometry as geom
from .. import twofloat as tf
from .nudft import nudft_visibilities, freq_grid_scalars

__all__ = ["Instrument", "Observation", "enu_rotation_from_eq",
           "simulate_snapshot", "simulate_drift", "SkySources"]


def enu_rotation_from_eq(lst_deg, lat_deg):
    """3x3 rotation: celestial equatorial cartesian (X to RA=0 on the
    equator, Z to NCP) -> local (E, N, U), at given LST/latitude.
    Host-side float64; supports array lst -> (..., 3, 3)."""
    th = np.radians(np.asarray(lst_deg, dtype=np.float64))
    ph = np.radians(np.float64(lat_deg))
    ct, st = np.cos(th), np.sin(th)
    cp, sp = np.cos(ph), np.sin(ph)
    z = np.zeros_like(ct)
    o = np.ones_like(ct)
    M = np.stack([
        np.stack([-st, ct, z], axis=-1),
        np.stack([-sp * ct, -sp * st, cp * o], axis=-1),
        np.stack([cp * ct, cp * st, sp * o], axis=-1),
    ], axis=-2)
    return M


def df_rotate3(Mh, Ml, sh, sl):
    """Two-float (3,3) @ (S,3)^T -> (S,3) rotated two-float vectors."""
    outs_h, outs_l = [], []
    for i in range(3):
        ph, pl = tf.two_prod(sh[:, 0], Mh[i, 0])
        pl = pl + (sh[:, 0] * Ml[i, 0] + sl[:, 0] * Mh[i, 0])
        for k in (1, 2):
            qh, ql = tf.two_prod(sh[:, k], Mh[i, k])
            ql = ql + (sh[:, k] * Ml[i, k] + sl[:, k] * Mh[i, k])
            ph, pl = tf.df_add(ph, pl, qh, ql)
        outs_h.append(ph)
        outs_l.append(pl)
    return jnp.stack(outs_h, axis=-1), jnp.stack(outs_l, axis=-1)


@dataclass
class SkySources:
    """Device-ready sky: celestial unit vectors (two-float) + spectrum."""
    s_eq_hi: jnp.ndarray     # (S, 3)
    s_eq_lo: jnp.ndarray
    flux: jnp.ndarray        # (S, C) float32, Jy
    src_shape_sigma: Optional[jnp.ndarray] = None  # (S,) uv-sigma or None

    @classmethod
    def from_skymodel(cls, skymodel, freqs):
        """Precompute spectrum and unit vectors from a host SkyModel.

        Power-law spectra are evaluated ON DEVICE: the (S, C) table at
        north-star sizes is 3.2 GB — a single-core f64 host evaluation
        took 249 s and the result then crossed the host->device link;
        the jit version moves only the per-source parameters (~10 MB)
        and runs in milliseconds."""
        ra = np.radians(skymodel.location[:, 0])
        dec = np.radians(skymodel.location[:, 1])
        s_eq = np.stack([np.cos(dec) * np.cos(ra),
                         np.cos(dec) * np.sin(ra),
                         np.sin(dec)], axis=-1)
        sh, sl = tf.split_f64(s_eq)
        if skymodel.spec_kind == "power-law":
            p = skymodel.spec_parms
            off = p.get("flux-offset", 0.0)

            @jax.jit
            def _pl(scale, fref, alpha, offset, f):
                return (offset[:, None] + scale[:, None]
                        * (f[None, :] / fref[:, None])
                        ** alpha[:, None]).astype(jnp.float32)

            flux = _pl(jnp.asarray(p["flux-scale"], jnp.float32),
                       jnp.asarray(p["freq-ref"], jnp.float32),
                       jnp.asarray(p["power-law-index"], jnp.float32),
                       jnp.asarray(off, jnp.float32)
                       if np.ndim(off) else
                       jnp.full(len(p["flux-scale"]), float(off),
                                jnp.float32),
                       jnp.asarray(freqs, jnp.float32))
        else:
            flux = skymodel.generate_spectrum(
                np.asarray(freqs)).astype(np.float32)
        sigma = None
        if skymodel.src_shape is not None:
            # FWHM = sqrt(maj*min) deg; sigma_uv = 1/(sqrt(2 ln2) * fwhm_dc)
            # (cf. /root/reference/prisim/interferometry.py:6263-6268)
            fwhm = np.sqrt(skymodel.src_shape[:, 0] * skymodel.src_shape[:, 1])
            fwhm_dc = 2.0 * np.sin(0.5 * np.radians(fwhm))
            with np.errstate(divide="ignore"):
                sigma = np.where(fwhm_dc > 0,
                                 1.0 / (np.sqrt(2 * np.log(2)) *
                                        np.maximum(fwhm_dc, 1e-12)),
                                 np.inf).astype(np.float32)
        return cls(jnp.asarray(sh), jnp.asarray(sl),
                   jnp.asarray(flux),
                   None if sigma is None else jnp.asarray(sigma))


@dataclass
class Instrument:
    """Static instrument description (device arrays + host metadata)."""
    bl_hi: jnp.ndarray       # (B, 3) ENU meters
    bl_lo: jnp.ndarray
    freqs: np.ndarray        # (C,) Hz, host float64, uniform grid
    telescope: dict = field(default_factory=dict)
    latitude: float = 0.0
    longitude: float = 0.0
    altitude: float = 0.0
    A_eff: float = 154.0
    eff_Q: float = 1.0

    @classmethod
    def build(cls, baseline_vectors, freqs, **kw):
        bh, bl = tf.split_f64(np.asarray(baseline_vectors, dtype=np.float64))
        return cls(jnp.asarray(bh), jnp.asarray(bl),
                   np.asarray(freqs, dtype=np.float64), **kw)

    @property
    def nu0(self):
        return float(self.freqs[0])

    @property
    def dnu(self):
        return float(self.freqs[1] - self.freqs[0])

    @property
    def nchan(self):
        return int(self.freqs.size)

    @property
    def nbl(self):
        return int(self.bl_hi.shape[0])

    def grid_scalars(self):
        return freq_grid_scalars(self.nu0, self.dnu)


@dataclass
class Observation:
    """Per-snapshot pointing/timing, host-computed (float64)."""
    lst_deg: np.ndarray          # (T,)
    jd: np.ndarray               # (T,)
    t_acc: np.ndarray            # (T,) seconds
    pointing_altaz: np.ndarray   # (T, 2) phased-up center, degrees
    mode: str = "drift"

    @property
    def n_acc(self):
        return int(self.lst_deg.size)

    def rotations(self, latitude):
        M = enu_rotation_from_eq(self.lst_deg, latitude)
        return tf.split_f64(M)

    def pc_dircos(self):
        return geom.altaz2dircos(self.pointing_altaz, xp=np)


def _beam_and_flux(s_enu_hi, flux, freqs_f32, beam_fn, pc=None):
    """amps = beam(s) * flux, zeroed below the horizon (the ROI cut,
    cf. /root/reference/prisim/interferometry.py:6203-6216).

    pc: optional (3,) per-snapshot pointing dircos (traced). A beam_fn
    marked `needs_pointing = True` receives it as a third argument —
    the per-snapshot beamformer steering the reference re-derives in
    its ROI precompute (primary_beams.py:288-316 with per-snapshot
    pointing_info, run_prisim.py:1897-1912)."""
    if pc is not None and getattr(beam_fn, "needs_pointing", False):
        pb = beam_fn(s_enu_hi, freqs_f32, pc)
    else:
        pb = beam_fn(s_enu_hi, freqs_f32)
    above = (s_enu_hi[:, 2] > 0.0)[:, None]
    return jnp.where(above, pb * flux, 0.0)


def simulate_snapshot(instrument, sky, Mh, Ml, pch, pcl, beam_fn,
                      src_block=512, gradient=False, use_pallas=False):
    """One accumulation: returns (B, C) complex64 noiseless visibilities.

    Mh/Ml: (3,3) two-float ENU rotation; pch/pcl: (3,) two-float phase
    center dircos. All jit-safe; beam_fn(dircos, freqs)->(S, C).
    use_pallas: route point-source NUDFTs through the Pallas kernel
    (engine.pallas_nudft); gradients and extended sources stay on the
    XLA engine.
    """
    sh, sl = df_rotate3(Mh, Ml, sky.s_eq_hi, sky.s_eq_lo)
    seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
    freqs_f32 = jnp.asarray(instrument.freqs, dtype=jnp.float32)
    amps = _beam_and_flux(sh, sky.flux, freqs_f32, beam_fn, pc=pch)
    kw = {}
    if sky.src_shape_sigma is not None:
        kw = dict(src_shape_sigma=sky.src_shape_sigma, s_sky=sh,
                  inv_wl=freqs_f32 / CNST.c)
    elif gradient:
        kw = dict(s_sky=sh)
    if use_pallas and not kw:
        from .pallas_nudft import nudft_pallas
        return nudft_pallas(seh, sel, instrument.bl_hi,
                            instrument.bl_lo, amps,
                            instrument.grid_scalars(), instrument.nchan)
    return nudft_visibilities(seh, sel, instrument.bl_hi, instrument.bl_lo,
                              amps, instrument.grid_scalars(),
                              instrument.nchan, src_block=src_block,
                              gradient=gradient, **kw)


def simulate_drift_rotations(instrument, sky, Mh, Ml, pch, pcl,
                             beam_fn, src_block=512, gradient=False,
                             use_pallas=False):
    """lax.scan over precomputed per-accumulation rotations/phase
    centers. Taking the schedule as ARGUMENTS (rather than closing over
    an Observation) lets the driver jit this once and reuse the same
    executable across host-level accumulation chunks."""

    def step(_, x):
        mh, ml, ph, pl = x
        out = simulate_snapshot(instrument, sky, mh, ml, ph, pl, beam_fn,
                                src_block=src_block, gradient=gradient,
                                use_pallas=use_pallas)
        return None, out

    _, vis = jax.lax.scan(step, None, (jnp.asarray(Mh), jnp.asarray(Ml),
                                       jnp.asarray(pch),
                                       jnp.asarray(pcl)))
    return vis


def simulate_drift(instrument, sky, observation, beam_fn, src_block=512,
                   gradient=False, use_pallas=False):
    """All accumulations via lax.scan. Returns (T, B, C) complex64
    (transpose to the reference's (nbl, nchan, n_acc) at IO time)."""
    Mh, Ml = observation.rotations(instrument.latitude)
    pc = observation.pc_dircos()
    pch, pcl = tf.split_f64(pc)
    return simulate_drift_rotations(instrument, sky, Mh, Ml, pch, pcl,
                                    beam_fn, src_block=src_block,
                                    gradient=gradient,
                                    use_pallas=use_pallas)
