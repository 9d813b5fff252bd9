"""Sky model: source catalog + spectrum generation.

Rebuild of the *external* ``astroutils.catalog.SkyModel`` class that the
reference depends on (constructed in /root/reference/scripts/run_prisim.py:
1020-1702 with spec_type 'func' power-law / tanh global-EoR or tabulated
'spectrum', consumed by generate_spectrum(...interp_method='pchip') inside
observe() at /root/reference/prisim/interferometry.py:6222-6249).

Design note: spectra are *precomputed on the host* (float64,
pchip via scipy) into a dense (nsrc, nchan) array that lives on device,
sharded along the channel axis — replacing the reference's per-snapshot
spectrum generation + HDF5 "previous sky" cache
(/root/reference/prisim/interferometry.py:6222-6249). Per-snapshot work on
device is then a pure gather of ROI rows.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from . import constants as CNST
from . import healpix as hp

__all__ = ["SkyModel", "powerlaw_spectrum", "tanh_eor_spectrum",
           "healpix_diffuse_model", "random_point_source_model"]


def powerlaw_spectrum(freqs, flux_ref, freq_ref, spindex, flux_offset=0.0):
    """S(nu) = offset + S_ref * (nu/nu_ref)^alpha, broadcasting to
    (nsrc, nchan)."""
    freqs = np.asarray(freqs, dtype=np.float64).reshape(1, -1)
    flux_ref = np.asarray(flux_ref, dtype=np.float64).reshape(-1, 1)
    freq_ref = np.asarray(freq_ref, dtype=np.float64).reshape(-1, 1)
    spindex = np.asarray(spindex, dtype=np.float64).reshape(-1, 1)
    off = np.asarray(flux_offset, dtype=np.float64).reshape(-1, 1)
    return off + flux_ref * (freqs / freq_ref) ** spindex


def tanh_eor_spectrum(freqs, flux_scale, freq_half, z_width, flux_offset):
    """Global-EoR tanh model: S(nu) rises from 0 (post-reionization) to
    flux_scale (neutral) around the half-reionization redshift implied by
    freq_half (cf. /root/reference/scripts/run_prisim.py:1074-1084)."""
    freqs = np.asarray(freqs, dtype=np.float64).reshape(1, -1)
    z = CNST.rest_freq_HI / freqs - 1.0
    z_half = CNST.rest_freq_HI / np.asarray(freq_half, dtype=np.float64) \
        .reshape(-1, 1) - 1.0
    zw = np.asarray(z_width, dtype=np.float64).reshape(-1, 1)
    scale = np.asarray(flux_scale, dtype=np.float64).reshape(-1, 1)
    off = np.asarray(flux_offset, dtype=np.float64).reshape(-1, 1)
    return off + 0.5 * scale * np.tanh((z - z_half) / np.maximum(zw, 1e-12))


@dataclass
class SkyModel:
    """Point-source / pixelized sky catalog.

    location      (nsrc, 2) [RA, dec] in degrees at `epoch_jyear`
    spec_kind     'power-law' | 'tanh' | 'spectrum'
    spec_parms    dict of per-source parameter arrays (see functions above)
    spectrum      tabulated (nsrc, nf_model) fluxes (spec_kind='spectrum')
    freqs_model   (nf_model,) frequencies of the tabulated spectrum
    src_shape     (nsrc, 3) [maj, min, pa] in degrees, or None (point srcs)
    flux_unit     'Jy' (per source / per pixel)
    """
    location: np.ndarray
    spec_kind: str = "power-law"
    spec_parms: dict = field(default_factory=dict)
    spectrum: Optional[np.ndarray] = None
    freqs_model: Optional[np.ndarray] = None
    src_shape: Optional[np.ndarray] = None
    flux_unit: str = "Jy"
    epoch_jyear: float = 2000.0
    name: str = "skymodel"

    def __post_init__(self):
        self.location = np.atleast_2d(np.asarray(self.location,
                                                 dtype=np.float64))

    @property
    def nsrc(self):
        return self.location.shape[0]

    def generate_spectrum(self, freqs, ind=None):
        """Fluxes (nsel, nchan) at the requested frequencies (Hz).

        Tabulated models use monotone pchip interpolation along frequency,
        matching the reference's interp_method='pchip'
        (/root/reference/prisim/interferometry.py:6242-6249)."""
        freqs = np.asarray(freqs, dtype=np.float64)
        sel = slice(None) if ind is None else np.asarray(ind)
        if self.spec_kind == "power-law":
            p = self.spec_parms
            return powerlaw_spectrum(
                freqs, np.asarray(p["flux-scale"])[sel],
                np.asarray(p["freq-ref"])[sel],
                np.asarray(p["power-law-index"])[sel],
                np.asarray(p.get("flux-offset", 0.0))[sel]
                if np.ndim(p.get("flux-offset", 0.0))
                else float(p.get("flux-offset", 0.0)))
        if self.spec_kind == "tanh":
            p = self.spec_parms
            return tanh_eor_spectrum(
                freqs, np.asarray(p["flux-scale"])[sel],
                np.asarray(p["freq-ref"])[sel],
                np.asarray(p["z-width"])[sel],
                np.asarray(p["flux-offset"])[sel])
        if self.spec_kind == "spectrum":
            from scipy.interpolate import PchipInterpolator
            spec = self.spectrum[sel]
            fm = np.asarray(self.freqs_model, dtype=np.float64)
            if fm.size == 1:
                return np.repeat(spec, freqs.size, axis=1)
            if (freqs.size == fm.size) and np.allclose(freqs, fm):
                return np.array(spec, dtype=np.float64)
            interp = PchipInterpolator(fm, spec, axis=1, extrapolate=True)
            return interp(freqs)
        raise ValueError(f"unknown spec_kind {self.spec_kind!r}")

    @staticmethod
    def concat(models):
        """Concatenate power-law point-source models (the reference's
        csm = SUMSS + NVSS merge, run_prisim.py:1325-1529)."""
        models = [m for m in models if m.nsrc > 0]
        if not models:
            raise ValueError("no models to concatenate")
        if any(m.spec_kind != "power-law" for m in models):
            raise ValueError("concat supports power-law models only")
        keys = ("flux-scale", "freq-ref", "power-law-index")
        parms = {k: np.concatenate([np.asarray(m.spec_parms[k],
                                               dtype=np.float64)
                                    for m in models]) for k in keys}
        shapes = None
        if all(m.src_shape is not None for m in models):
            shapes = np.concatenate([m.src_shape for m in models])
        return SkyModel(
            location=np.concatenate([m.location for m in models]),
            spec_kind="power-law", spec_parms=parms, src_shape=shapes,
            name="+".join(m.name for m in models))

    def subset(self, ind):
        return SkyModel(
            location=self.location[ind],
            spec_kind=self.spec_kind,
            spec_parms={k: (np.asarray(v)[ind] if np.ndim(v) else v)
                        for k, v in self.spec_parms.items()},
            spectrum=None if self.spectrum is None else self.spectrum[ind],
            freqs_model=self.freqs_model,
            src_shape=None if self.src_shape is None else self.src_shape[ind],
            flux_unit=self.flux_unit, epoch_jyear=self.epoch_jyear,
            name=self.name)

    # ------------------------------------------------------------------ IO
    def save_hdf5(self, path):
        import h5py
        with h5py.File(path, "w") as f:
            hdr = f.create_group("header")
            hdr.attrs["name"] = self.name
            hdr.attrs["spec_kind"] = self.spec_kind
            hdr.attrs["flux_unit"] = self.flux_unit
            hdr.attrs["epoch_jyear"] = self.epoch_jyear
            f.create_dataset("location", data=self.location)
            if self.src_shape is not None:
                f.create_dataset("src_shape", data=self.src_shape)
            if self.spectrum is not None:
                f.create_dataset("spectrum", data=self.spectrum,
                                 compression="gzip")
                f.create_dataset("freqs_model", data=self.freqs_model)
            pg = f.create_group("spec_parms")
            for k, v in self.spec_parms.items():
                pg.create_dataset(k, data=np.asarray(v))

    @classmethod
    def load_hdf5(cls, path):
        import h5py
        with h5py.File(path, "r") as f:
            hdr = f["header"].attrs
            parms = {k: np.asarray(v) for k, v in f["spec_parms"].items()}
            return cls(
                location=np.asarray(f["location"]),
                spec_kind=str(hdr["spec_kind"]),
                spec_parms=parms,
                spectrum=np.asarray(f["spectrum"]) if "spectrum" in f else None,
                freqs_model=(np.asarray(f["freqs_model"])
                             if "freqs_model" in f else None),
                src_shape=(np.asarray(f["src_shape"])
                           if "src_shape" in f else None),
                flux_unit=str(hdr["flux_unit"]),
                epoch_jyear=float(hdr["epoch_jyear"]),
                name=str(hdr["name"]))


def temperature_to_jy_per_pixel(T, freqs, nside):
    """Rayleigh-Jeans: S_pix [Jy] = T [K] * 2 k nu^2 / c^2 * Omega_pix / Jy."""
    freqs = np.asarray(freqs, dtype=np.float64).reshape(1, -1)
    T = np.asarray(T, dtype=np.float64)
    if T.ndim == 1:
        T = T[:, None]
    omega = hp.nside2pixarea(nside)
    return T * (2.0 * CNST.k_B * freqs ** 2 / CNST.c ** 2) * omega / CNST.Jy


def healpix_diffuse_model(temp_map, freqs_model, spindex=-2.55,
                          nest=False, name="dsm"):
    """Diffuse sky from a HEALPix temperature map at one or more
    frequencies: pixel centers become point sources with per-pixel fluxes
    (the reference's DSM/GSM path, /root/reference/scripts/run_prisim.py:
    1089-1140).

    temp_map: (npix,) single-frequency map (power-law extended with
    `spindex`) or (npix, nf) multi-frequency cube (tabulated spectrum).
    """
    temp_map = np.asarray(temp_map, dtype=np.float64)
    freqs_model = np.atleast_1d(np.asarray(freqs_model, dtype=np.float64))
    nside = hp.npix2nside(temp_map.shape[0])
    theta, phi = hp.pix2ang(nside, np.arange(temp_map.shape[0]), nest=nest)
    # Equatorial mapping: RA = phi, dec = 90 - theta.
    location = np.stack([np.degrees(phi), 90.0 - np.degrees(theta)], axis=-1)
    flux = temperature_to_jy_per_pixel(temp_map, freqs_model, nside)
    if freqs_model.size == 1:
        return SkyModel(
            location=location, spec_kind="power-law",
            spec_parms={
                "flux-scale": flux[:, 0],
                "freq-ref": np.full(flux.shape[0], freqs_model[0]),
                # spectral index in flux: T ~ nu^alpha => S ~ nu^(alpha+2)
                "power-law-index": np.full(flux.shape[0], spindex + 2.0),
                "flux-offset": np.zeros(flux.shape[0]),
            }, name=name)
    return SkyModel(location=location, spec_kind="spectrum",
                    spectrum=flux, freqs_model=freqs_model, name=name)


def random_point_source_model(nsrc, flux_min=1.0, flux_max=100.0,
                              spindex_mean=-0.83, spindex_rms=0.0,
                              seed=0, name="random"):
    """Synthetic power-law point-source catalog with an S^-2 count law,
    for tests and benchmarks (spectral-index randomization mirrors
    /root/reference/scripts/run_prisim.py:1129-1133)."""
    rng = np.random.RandomState(seed)
    ra = rng.uniform(0.0, 360.0, nsrc)
    dec = np.degrees(np.arcsin(rng.uniform(-1.0, 1.0, nsrc)))
    u = rng.uniform(size=nsrc)
    flux = flux_min * flux_max / (flux_max - u * (flux_max - flux_min))
    spindex = spindex_mean + (spindex_rms * rng.randn(nsrc)
                              if spindex_rms > 0 else np.zeros(nsrc))
    return SkyModel(
        location=np.stack([ra, dec], axis=-1), spec_kind="power-law",
        spec_parms={"flux-scale": flux,
                    "freq-ref": np.full(nsrc, 150e6),
                    "power-law-index": spindex,
                    "flux-offset": np.zeros(nsrc)},
        name=name)
