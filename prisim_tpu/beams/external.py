"""External (tabulated HEALPix) primary beams.

Rebuild of the reference's external-beam path: log10(beam) interpolated
bilinearly in angle on the HEALPix grid and along frequency, then
peak-normalized per channel (/root/reference/scripts/run_prisim.py:
1897-1912, healpix_interp_along_axis in astroutils).

Host-side: precompute angular gather indices/weights once per pointing;
frequency interpolation runs in scipy (float64). The product feeds the
jit engine as a static (nsrc, nchan) array — or, for drift scans where the
same sky grid rotates, as per-snapshot gathers on device.
"""

from __future__ import annotations

import numpy as np

from .. import healpix as hp


class ExternalBeam:
    """HEALPix-sampled power beam, possibly chromatic.

    beam_maps : (npix, nfreq) power values (peak-normalized or not)
    freqs     : (nfreq,) frequencies in Hz
    """

    def __init__(self, beam_maps, freqs, nest=False, spec_interp="cubic"):
        self.maps = np.atleast_2d(np.asarray(beam_maps, dtype=np.float64))
        if self.maps.shape[0] < self.maps.shape[1] and \
                self.maps.shape[1] % 12 == 0:
            pass  # assume (npix, nfreq) always; no transpose guessing
        self.freqs = np.atleast_1d(np.asarray(freqs, dtype=np.float64))
        self.nside = hp.npix2nside(self.maps.shape[0])
        self.nest = nest
        self.spec_interp = spec_interp

    @classmethod
    def from_fits(cls, path, **kw):
        # io.fitsio.read_fits returns plain dicts: {'header': {...},
        # 'data': ndarray} for image HDUs (io/fitsio.py:213).
        from ..io import fitsio as fio
        hdus = fio.read_fits(path)
        data = None
        freqs = None
        for h in hdus:
            d = h.get("data")
            if d is None:
                continue
            name = str(h["header"].get("EXTNAME", "")).strip().upper()
            if name in ("FREQS", "FREQUENCIES", "FREQ"):
                freqs = np.asarray(d, dtype=np.float64).ravel()
            elif name in ("BEAM", "") and data is None and d.ndim >= 1:
                data = np.asarray(d, dtype=np.float64)
        if data is None:
            raise ValueError(f"no beam data found in {path}")
        if data.ndim == 1:
            data = data[:, None]
        if data.shape[0] % 12 != 0 and data.shape[1] % 12 == 0:
            data = data.T
        if freqs is None:
            freqs = np.asarray([150e6])
        return cls(data, freqs, **kw)

    @classmethod
    def from_hdf5(cls, path, **kw):
        import h5py
        with h5py.File(path, "r") as f:
            maps = np.asarray(f["beam"])
            freqs = (np.asarray(f["freqs"]) if "freqs" in f
                     else np.asarray([150e6]))
        return cls(maps, freqs, **kw)

    def channel_table(self, channels, chromatic=True, select_freq=None):
        """Host-precomputed per-channel log10 beam table (npix, nchan)
        float32 — the frequency interpolation runs ONCE here instead of
        per snapshot. Feed to `device_evaluate`."""
        channels = np.asarray(channels, dtype=np.float64)
        with np.errstate(divide="ignore"):
            logmaps = np.log10(np.clip(self.maps, 1e-30, None))
        if not chromatic:
            idx = int(np.argmin(np.abs(
                self.freqs - (select_freq or np.median(channels)))))
            table = np.repeat(logmaps[:, idx:idx + 1], channels.size,
                              axis=1)
        elif self.freqs.size == 1:
            table = np.repeat(logmaps, channels.size, axis=1)
        else:
            from scipy.interpolate import make_interp_spline
            k = {"nearest": 0, "linear": 1, "quadratic": 2,
                 "cubic": 3}.get(self.spec_interp, 3)
            k = min(k, self.freqs.size - 1)
            f = make_interp_spline(self.freqs, logmaps, k=k, axis=1)
            table = f(channels)
        return table.astype(np.float32)

    def interp_weights(self, altaz_deg):
        """Host per-snapshot angular weights: (pix (4, S) int32,
        wgt (4, S) float32) — O(S) work, the only per-snapshot host
        cost of the device evaluation path."""
        theta = np.radians(90.0 - np.asarray(altaz_deg)[:, 0])
        phi = np.radians(np.asarray(altaz_deg)[:, 1])
        pix, wgt = hp.get_interp_weights(self.nside, theta, phi)
        if self.nest:
            pix = hp.ring2nest(self.nside, pix)
        return pix.astype(np.int32), wgt.astype(np.float32)

    @staticmethod
    def device_evaluate(logtable, pix, wgt):
        """Jit-safe beam power (S, C): 4-neighbor row gather from the
        device-resident (npix, C) log table, weighted sum in log space,
        per-channel peak normalization, 10^. Row gathers move C
        contiguous floats per index — DMA-shaped, unlike the
        per-element gathers.
        Replaces a per-snapshot host scipy loop."""
        import jax.numpy as jnp
        rows = logtable[pix.reshape(-1)]              # (4S, C)
        rows = rows.reshape(pix.shape + (logtable.shape[1],))
        logbeam = jnp.sum(wgt[..., None] * rows, axis=0)   # (S, C)
        peak = jnp.max(logbeam, axis=0)
        peak = jnp.where(peak <= 0.0, 0.0, peak)
        return 10.0 ** (logbeam - peak[None, :])

    def evaluate(self, altaz_deg, channels, chromatic=True,
                 select_freq=None):
        """Beam power at source (alt, az) positions for each channel.

        Interpolation happens on log10(beam) and the result is normalized
        to unit peak per channel, mirroring the reference. Returns
        (nsrc, nchan) float64.
        """
        theta = np.radians(90.0 - np.asarray(altaz_deg)[:, 0])
        phi = np.radians(np.asarray(altaz_deg)[:, 1])
        pix, wgt = hp.get_interp_weights(self.nside, theta, phi)
        if self.nest:
            pix = hp.ring2nest(self.nside, pix)
        with np.errstate(divide="ignore"):
            logmaps = np.log10(np.clip(self.maps, 1e-30, None))
        # Angular interpolation: (nsrc, nfreq_model)
        logbeam_model = np.einsum("kn,knf->nf", wgt, logmaps[pix])

        channels = np.asarray(channels, dtype=np.float64)
        if not chromatic:
            idx = int(np.argmin(np.abs(
                self.freqs - (select_freq or np.median(channels)))))
            logbeam = np.repeat(logbeam_model[:, idx:idx + 1],
                                channels.size, axis=1)
        elif self.freqs.size == 1:
            logbeam = np.repeat(logbeam_model, channels.size, axis=1)
        else:
            from scipy.interpolate import make_interp_spline
            k = {"nearest": 0, "linear": 1, "quadratic": 2,
                 "cubic": 3}.get(self.spec_interp, 3)
            k = min(k, self.freqs.size - 1)
            f = make_interp_spline(self.freqs, logbeam_model, k=k, axis=1)
            logbeam = f(channels)
        # Peak-normalize per channel (reference clamps the max at >= 0 dB).
        peak = np.nanmax(logbeam, axis=0)
        peak = np.where(peak <= 0.0, 0.0, peak)
        logbeam = logbeam - peak[None, :]
        return 10.0 ** logbeam
