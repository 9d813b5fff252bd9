"""Simulation driver: YAML parameters -> end-to-end run -> saved products.

Rebuild of the reference's monolithic MPI driver
(/root/reference/scripts/run_prisim.py, 2339 LoC) as a library function +
thin CLI. The MPI rank/chunk machinery (:1731-2210) is replaced by the
jit/scan/shard_map engine (prisim_tpu.engine, prisim_tpu.parallel); the
per-rank file concatenate (:2224-2287) disappears — one process drives
the whole mesh.

Pipeline (mirroring run_prisim.py top-to-bottom):
  load_parms -> layout (+ perturbations) -> baselines (+ cuts/redundancy)
  -> frequency grid -> observation schedule (drift|track) -> sky model
  -> beam fn -> simulate (jit drift scan) -> Tsys/noise -> gains ->
  phasing -> optional delay transform -> save HDF5/NPZ/UVFITS/UVH5 ->
  metadata (simparms.yaml + meta.yaml).
"""

from __future__ import annotations

import contextlib
import functools
import os
import time

import numpy as np

from . import __version__
from . import geometry as geom
from .baselines import build_baselines
from .config import load_parms, dump_parms
from .engine.noise import thermal_noise_rms, generate_noise
from .engine.observe import (Instrument, Observation, SkySources,
                             simulate_drift)
from .gains import GainInfo, apply_gains
from .layouts import preset_layout, parse_layout_file, ArrayLayout
from .skymodel import SkyModel, random_point_source_model
from .vis import VisibilitySet, phase_centering, project_baselines, \
    delay_transform

__all__ = ["run_simulation", "build_layout", "build_schedule",
           "build_sky", "build_tsys", "precess_sky_to_obs_epoch", "main"]

SIDEREAL_DEG_PER_SEC = 360.0 / 86164.0905


def build_layout(parms):
    """Array layout from parms['array'] (getBaselineInfo layout branch,
    /root/reference/prisim/interferometry.py:1465-1851), including seeded
    position perturbations (:1686-1694)."""
    ap = parms["array"]
    if ap.get("layout_positions") is not None:
        # inline ENU positions (meters): programmatic configs and
        # layouts whose data files the reference leaves unbundled
        pos = np.asarray(ap["layout_positions"], dtype=np.float64)
        if pos.ndim != 2 or pos.shape[1] not in (2, 3):
            raise ValueError("array.layout_positions must be (N, 2|3)")
        if pos.shape[1] == 2:
            pos = np.concatenate([pos, np.zeros((pos.shape[0], 1))], 1)
        labels = ap.get("layout_labels")
        labels = (np.asarray([str(l) for l in labels])
                  if labels is not None else
                  np.asarray([str(i) for i in range(pos.shape[0])]))
        layout = ArrayLayout(pos, labels)
    elif ap.get("file"):
        pp = ap.get("parser") or {}
        layout = parse_layout_file(ap["file"],
                                   comment=pp.get("comment") or "#",
                                   skip_rows=pp.get("data_start") or 0)
    else:
        layout = preset_layout(ap["layout"], minR=ap.get("minR"),
                               maxR=ap.get("maxR"),
                               element_size=parms["antenna"].get("size"))
    rms_t = ap.get("rms_tgtplane") or 0.0
    rms_e = ap.get("rms_elevation") or 0.0
    if rms_t > 0 or rms_e > 0:
        rng = np.random.RandomState(ap.get("seed"))
        pos = np.array(layout.positions, dtype=np.float64)
        pos[:, :2] += rms_t * rng.randn(pos.shape[0], 2)
        pos[:, 2] += rms_e * rng.randn(pos.shape[0])
        layout = ArrayLayout(pos, layout.labels)
    prefix = parms["telescope"].get("label_prefix") or ""
    if prefix:
        layout = ArrayLayout(layout.positions,
                             np.asarray([prefix + str(l)
                                         for l in layout.labels]))
    return layout


def build_frequencies(parms):
    bp = parms["bandpass"]
    nchan = int(bp["nchan"])
    df = float(bp["freq_resolution"])
    f_center = float(bp["freq"])
    return f_center + df * (np.arange(nchan) - nchan / 2)


def _jd_init_from_obs_date(parms, lst_init_deg, longitude):
    """Julian date at the start of the observation: the first instant on
    obsparm.obs_date (UT, 'YYYY/MM/DD') at which the local sidereal time
    equals lst_init (the reference's julian_date_from_LAST flow,
    run_prisim.py:661-667)."""
    from . import ephemeris as eph
    date = str(parms["obsparm"].get("obs_date") or "2015/11/23")
    y, m, d = [int(x) for x in date.replace("-", "/").split("/")[:3]]
    jd0 = eph.julian_date(y, m, d)                       # midnight UT
    dlst = (lst_init_deg - eph.lst_deg(jd0, longitude)) % 360.0
    return jd0 + dlst / 360.98564736629          # sidereal rate deg/day


def build_schedule(parms, latitude, longitude=None):
    """Observation schedule (run_prisim.py:576-740): drift (fixed altaz
    or ha/dec pointing) or track (fixed ra/dec). jd_init falls back to
    obsparm.obs_date + lst_init via the ephemeris (run_prisim.py:
    661-667) when pointing.jd_init is not given."""
    op = parms["obsparm"]
    pt = parms["pointing"]
    if longitude is None:
        longitude = float(parms["telescope"].get("longitude") or 0.0)
    n_acc = int(op["n_acc"]) if op.get("t_obs") is None else \
        int(np.ceil(float(op["t_obs"]) / float(op["t_acc"])))
    t_acc = float(op["t_acc"])
    lst_init = float(pt.get("lst_init") or 0.0) * 15.0 \
        if abs(float(pt.get("lst_init") or 0.0)) <= 24.0 \
        else float(pt["lst_init"])
    jd_init = pt.get("jd_init")
    if jd_init is None:
        jd_init = _jd_init_from_obs_date(parms, lst_init, longitude)
    lst = (lst_init + SIDEREAL_DEG_PER_SEC * t_acc *
           (np.arange(n_acc) + 0.5)) % 360.0
    jd = jd_init + t_acc * (np.arange(n_acc) + 0.5) / 86400.0
    if pt.get("file"):
        # pointing file: text columns (lst_deg, alt, az), one row per
        # accumulation (run_prisim.py pointing-file branch :576-660)
        data = np.atleast_2d(np.genfromtxt(pt["file"], comments="#"))
        lst = data[:, 0]
        n_acc = lst.size
        jd = jd_init + t_acc * (np.arange(n_acc) + 0.5) / 86400.0
        obs = Observation(lst_deg=lst, jd=jd,
                          t_acc=np.full(n_acc, t_acc),
                          pointing_altaz=data[:, 1:3], mode="file")
        return _apply_snapshot_selection(obs, parms)
    mode = op.get("obs_mode", "drift")
    if mode == "drift":
        di = pt.get("drift_init") or {}
        if di.get("alt") is not None and di.get("az") is not None:
            altaz = np.tile([[float(di["alt"]), float(di["az"])]],
                            (n_acc, 1))
        else:
            ha = float(di.get("ha") or 0.0)
            dec = float(di.get("dec") if di.get("dec") is not None
                        else latitude)
            hadec = np.tile([[ha, dec]], (n_acc, 1))
            altaz = geom.hadec2altaz(hadec, latitude, xp=np)
    elif mode == "track":
        ti = pt.get("track_init") or {}
        ra = float(ti.get("ra") or 0.0)
        dec = float(ti.get("dec") if ti.get("dec") is not None
                    else latitude)
        ha = lst - ra
        hadec = np.stack([ha, np.full(n_acc, dec)], axis=-1)
        altaz = geom.hadec2altaz(hadec, latitude, xp=np)
    else:
        raise ValueError("obs_mode must be 'drift' or 'track'")
    obs = Observation(lst_deg=lst, jd=jd, t_acc=np.full(n_acc, t_acc),
                      pointing_altaz=altaz, mode=mode)
    return _apply_snapshot_selection(obs, parms)


def _apply_snapshot_selection(obs, parms):
    """snapshot.pick / snapshot.range / snapshot.avg_drifts
    (run_prisim.py snapshot section; defaultparms.yaml 'snapshot')."""
    sn = parms.get("snapshot") or {}
    idx = None
    if sn.get("pick") is not None:
        idx = np.atleast_1d(np.asarray(sn["pick"], dtype=int))
    elif sn.get("range") is not None:
        lo, hi = sn["range"]
        idx = np.arange(int(lo), int(hi))
    if idx is not None:
        obs = Observation(lst_deg=obs.lst_deg[idx], jd=obs.jd[idx],
                          t_acc=obs.t_acc[idx],
                          pointing_altaz=obs.pointing_altaz[idx],
                          mode=obs.mode)
    if sn.get("beam_switch") and obs.mode == "file":
        # drift-and-shift (dns) beam-switch selection
        # (run_prisim.py:604-660): keep the snapshots at which the
        # pointing moves by more than snapshot.shift_threshold degrees
        # (great-circle; reference default 1.0), and give each kept
        # snapshot the LST midpoint and accumulated duration of its
        # whole drift segment (lst_edges_left/right there)
        thr = float(sn.get("shift_threshold") or 1.0)
        alt, az = obs.pointing_altaz[:, 0], obs.pointing_altaz[:, 1]
        dang = np.asarray(geom.sphdist(az[1:], alt[1:], az[:-1],
                                       alt[:-1], xp=np))
        keep = np.r_[True, dang > thr]
        idx2 = np.where(keep)[0]
        lst_u = np.unwrap(obs.lst_deg, period=360.0)
        edges = np.r_[lst_u, lst_u[-1] + (lst_u[-1] - lst_u[-2]
                                          if lst_u.size > 1 else 0.0)]
        left = lst_u[idx2]
        right = np.r_[edges[idx2[1:]], edges[-1]]
        t_seg = (right - left) / SIDEREAL_DEG_PER_SEC
        obs = Observation(lst_deg=(0.5 * (left + right)) % 360.0,
                          jd=obs.jd[idx2], t_acc=t_seg,
                          pointing_altaz=obs.pointing_altaz[idx2],
                          mode=obs.mode)
    if sn.get("avg_drifts"):
        # collapse all drift snapshots to their mean epoch with the
        # total accumulation time (snapshot.avg_drifts semantics)
        obs = Observation(
            lst_deg=np.asarray([obs.lst_deg.mean()]),
            jd=np.asarray([obs.jd.mean()]),
            t_acc=np.asarray([obs.t_acc.sum()]),
            pointing_altaz=obs.pointing_altaz.mean(axis=0,
                                                   keepdims=True),
            mode=obs.mode)
    return obs


def build_sky(parms, freqs):
    """Sky model from parms['skyparm']/parms['catalog']
    (run_prisim.py:1020-1702). Supported models: 'custom' (ascii catalog:
    RA DEC FLUX [SPINDEX] [MAJAX MINAX PA]), 'skymod_hdf5' (native
    SkyModel HDF5), 'random' (synthetic catalog), 'usm' (uniform diffuse
    HEALPix), 'hpx'/'dsm' (HEALPix map from .npy/.npz via
    healpix_diffuse_model)."""
    sp = parms["skyparm"]
    cat = parms["catalog"]
    model = (sp.get("model") or "custom").lower()
    if model == "random":
        sm = random_point_source_model(
            int(sp.get("nsrc") or 100),
            flux_min=float(sp.get("flux_min") or 1.0),
            flux_max=float(sp.get("flux_max") or 100.0),
            spindex_mean=float(sp.get("spindex") or -0.83),
            spindex_rms=float(sp.get("spindex_rms") or 0.0),
            seed=int(sp.get("seed") or 0))
    elif model == "custom":
        path = cat.get("custom_file")
        if not path:
            raise ValueError("catalog.custom_file required for "
                             "skyparm.model='custom'")
        data = np.atleast_2d(np.genfromtxt(path, comments="#"))
        ra, dec, flux = data[:, 0], data[:, 1], data[:, 2]
        spindex = data[:, 3] if data.shape[1] > 3 else \
            np.full(ra.size, float(sp.get("spindex") or -0.83))
        src_shape = data[:, 4:7] if data.shape[1] >= 7 else None
        ref = float(sp.get("custom_reffreq") or 0.15) * 1e9
        sm = SkyModel(location=np.stack([ra, dec], axis=-1),
                      spec_kind="power-law",
                      spec_parms={"flux-scale": flux,
                                  "freq-ref": np.full(ra.size, ref),
                                  "power-law-index": spindex},
                      src_shape=src_shape)
        fmin = sp.get("flux_min")
        if fmin is not None:
            sm = sm.subset(np.where(flux >= float(fmin))[0])
    elif model in ("csm", "asm"):
        # csm: combined point-source model — SUMSS below dec -30, NVSS
        # above (run_prisim.py:1325-1529). asm: all-sky model — the
        # same point sources merged with the DSM diffuse map
        # (run_prisim.py:810, 1089-1200: use_GSM reads the
        # DSM_file_prefix FITS table then concatenates SUMSS + NVSS).
        from . import catalogs as CATS
        parts = []
        if model == "asm":
            path = cat.get("DSM_file_prefix") or cat.get("spectrum_file")
            if not path:
                raise ValueError("asm needs catalog.DSM_file_prefix "
                                 "(per-pixel DSM FITS table)")
            from .catalogs import read_dsm_fits
            parts.append(read_dsm_fits(
                path, nside=int(sp.get("nside") or 64),
                map_freq=float(sp.get("custom_reffreq") or 0.15) * 1e9))
        if cat.get("SUMSS_file"):
            parts.append(CATS.read_sumss(
                cat["SUMSS_file"],
                spindex_rms=float(sp.get("spindex_rms") or 0.0),
                spindex_seed=sp.get("spindex_seed")))
        if cat.get("NVSS_file"):
            parts.append(CATS.read_nvss(
                cat["NVSS_file"], exclude_sumss_sky=bool(
                    cat.get("SUMSS_file")),
                spindex_rms=float(sp.get("spindex_rms") or 0.0),
                spindex_seed=sp.get("spindex_seed")))
        if not parts or (model == "csm" and not any(
                cat.get(k) for k in ("SUMSS_file", "NVSS_file"))):
            raise ValueError("%s needs catalog.SUMSS_file and/or "
                             "catalog.NVSS_file" % model)
        # the flux cut applies to the point-source catalogs only: the
        # reference's asm branch filters SUMSS/NVSS by brightness but
        # keeps every DSM pixel (run_prisim.py:1141,1186)
        ndiff = 1 if model == "asm" else 0
        if sp.get("flux_min") is not None and len(parts) > ndiff:
            ps = SkyModel.concat(parts[ndiff:])
            ps = CATS.flux_cut(ps, flux_min=sp["flux_min"],
                               flux_max=sp.get("flux_max"),
                               cut_freq=(float(sp["fluxcut_reffreq"])
                                         if sp.get("fluxcut_reffreq")
                                         else None))
            parts = parts[:ndiff] + [ps]
        sm = SkyModel.concat(parts)
    elif model in ("hi_monopole", "monopole"):
        # global-EoR tanh monopole on a uniform HEALPix sky
        # (run_prisim.py HI_monopole branch; global_EoR_parms)
        from . import healpix as hp
        from .skymodel import tanh_eor_spectrum
        nside = int(sp.get("nside") or 32)
        npix = hp.nside2npix(nside)
        theta, phi = hp.pix2ang(nside, np.arange(npix))
        gp = sp.get("global_EoR_parms") or [0.027, 150e6, 1.0]
        temp = np.broadcast_to(
            tanh_eor_spectrum(freqs, gp[0], gp[1], gp[2], 0.0),
            (npix, freqs.size)).copy()           # K (brightness temp)
        from .skymodel import temperature_to_jy_per_pixel
        spectrum = temperature_to_jy_per_pixel(temp, freqs, nside) \
            if (sp.get("flux_unit", "K")).lower() == "k" \
            else temp * hp.nside2pixarea(nside)
        sm = SkyModel(
            location=np.stack([np.degrees(phi),
                               90.0 - np.degrees(theta)], axis=-1),
            spec_kind="spectrum", spectrum=spectrum,
            freqs_model=np.asarray(freqs, dtype=np.float64),
            name="HI_monopole")
    elif model == "noise":
        # noise-only simulation: an empty sky (run_prisim.py 'noise'
        # branch) — one zero-flux source keeps shapes static
        sm = SkyModel(location=np.asarray([[0.0, -90.0]]),
                      spec_kind="power-law",
                      spec_parms={"flux-scale": np.asarray([0.0]),
                                  "freq-ref": np.asarray([150e6]),
                                  "power-law-index": np.asarray([0.0])},
                      name="noise")
    elif model in ("sumss", "nvss", "gleam", "mwacs"):
        from . import catalogs as CATS
        reader = {"sumss": CATS.read_sumss, "nvss": CATS.read_nvss,
                  "gleam": CATS.read_gleam, "mwacs": CATS.read_mwacs}
        path = cat.get(model.upper() + "_file") or cat.get("custom_file")
        if not path:
            raise ValueError("catalog.%s_file required for "
                             "skyparm.model=%r" % (model.upper(), model))
        kw = {}
        if model in ("sumss", "nvss", "mwacs"):
            kw = dict(spindex_mean=float(sp.get("spindex") or -0.83),
                      spindex_rms=float(sp.get("spindex_rms") or 0.0),
                      spindex_seed=sp.get("spindex_seed"))
        elif model == "gleam":
            kw = dict(select_freq=float(np.median(freqs)))
        sm = reader[model](path, **kw)
        if sp.get("flux_min") is not None or sp.get("flux_max") is not None:
            sm = CATS.flux_cut(
                sm, flux_min=sp.get("flux_min"),
                flux_max=sp.get("flux_max"),
                cut_freq=(float(sp["fluxcut_reffreq"])
                          if sp.get("fluxcut_reffreq") else None))
    elif model in ("skymod_hdf5", "hdf5"):
        sm = SkyModel.load_hdf5(cat["skymod_file"])
    elif model in ("hi_cube", "hi_fluctuations", "lidz", "21cmfast"):
        # HI lightcone cube: FITS simulation cubes (Lidz/21cmFAST,
        # run_prisim.py:1020-1065) or npz with 'maps' (npix, nf)
        # HEALPix brightness maps + 'freqs'
        path = cat.get("spectrum_file") or cat.get("skymod_file")
        if not path:
            raise ValueError("catalog.spectrum_file required for HI cube")
        if str(path).endswith((".fits", ".FITS")):
            from .catalogs import read_hi_cube_fits
            sm = read_hi_cube_fits(
                path, center_freq=float(parms["bandpass"]["freq"]),
                fluctuations=(model == "hi_fluctuations"))
        else:
            from .skymodel import healpix_diffuse_model
            with np.load(path) as d:
                maps = d["maps"]
                fmdl = d["freqs"]
            if model == "hi_fluctuations":
                maps = maps - maps.mean(axis=0, keepdims=True)
            sm = healpix_diffuse_model(maps, freqs_model=fmdl)
    elif model in ("usm", "hpx", "dsm", "gsm", "gsm2008", "gsm2016"):
        from .skymodel import healpix_diffuse_model
        from . import healpix as hp
        nside = int(sp.get("nside") or 64)
        if model == "usm":
            temp = np.ones(hp.nside2npix(nside))
        else:
            path = cat.get("DSM_file_prefix") or cat.get("spectrum_file")
            if not path:
                if model in ("gsm", "gsm2008", "gsm2016"):
                    # the reference builds the map in-process with
                    # pygsm (run_prisim.py:1257-1260); pygsm is not in
                    # this environment so the map must be pre-made
                    raise ValueError(
                        "skyparm.model=%r needs a pre-generated map: "
                        "run `python -m prisim_tpu.tools gsm --nside N "
                        "--freqs f0,f1,... -o map.npz` where pygsm is "
                        "installed, then set catalog.spectrum_file to "
                        "the npz (keys 'maps' (npix, nf) and 'freqs')"
                        % model)
                raise ValueError("catalog file required for HEALPix sky")
            if str(path).endswith((".fits", ".FITS")) or \
                    not os.path.exists(str(path)):
                # per-pixel FITS catalog (or the reference's file
                # prefix, expanded inside the reader)
                from .catalogs import read_dsm_fits
                temp = read_dsm_fits(
                    path, nside=nside,
                    map_freq=float(sp.get("custom_reffreq") or 0.15)
                    * 1e9)
            else:
                temp = np.load(path)
                if hasattr(temp, "files"):
                    if "maps" in temp.files and "freqs" in temp.files:
                        # multi-frequency map set (e.g. `tools gsm`
                        # output): exact per-frequency spectra instead
                        # of a single power law
                        temp = healpix_diffuse_model(
                            temp["maps"], freqs_model=temp["freqs"])
                    else:
                        temp = temp[temp.files[0]]
        if isinstance(temp, SkyModel):
            sm = temp
        else:
            sm = healpix_diffuse_model(
                temp,
                freqs_model=np.asarray([float(sp.get("custom_reffreq")
                                              or 0.15) * 1e9]),
                spindex=float(sp.get("spindex") or -2.55))
    else:
        raise ValueError("unsupported skyparm.model %r (catalog data "
                         "files are not bundled)" % model)
    return sm


def precess_sky_to_obs_epoch(sky, parms, obs):
    """Precess catalog coordinates from skyparm.epoch (a Julian year,
    e.g. '2000') to the observing epoch — the reference precesses the
    sky model to the obs epoch once (run_prisim.py:1690-1692) and
    transforms FK5->AltAz per snapshot (interferometry.py:6174-6180).
    J2000->2015 is ~0.2 deg, far outside the 1e-6 visibility budget."""
    from . import ephemeris as eph
    ep = parms["skyparm"].get("epoch")
    if ep is None:
        return sky
    jd_from = float(eph.jyear_to_jd(float(ep)))
    jd_to = float(np.mean(np.asarray(obs.jd, dtype=np.float64)))
    if abs(jd_to - jd_from) < 1.0:                # same epoch: no-op
        return sky
    ra, dec = eph.precess_radec(sky.location[:, 0], sky.location[:, 1],
                                jd_from, jd_to)
    import dataclasses
    return dataclasses.replace(
        sky, location=np.stack([ra, dec], axis=-1),
        epoch_jyear=2000.0 + (jd_to - eph.JD_J2000) / 365.25)


def _src_block_from_memuse(parms, nbl, nchan, nsrc):
    """processing.memuse (GB) -> source-streaming block size via the
    reference's DFT-matrix memory model (run_prisim.py:1737-1743:
    nsrc*nchan*nbl*8 B), scaled by skyparm.fsky (fraction of the model
    above the horizon at any instant, defaultparms.yaml:643-656)."""
    proc = parms["processing"]
    memuse = proc.get("memuse")
    if memuse is None:
        return None
    bytes_per_src = nbl * nchan * 8.0          # complex64 phase matrix
    fsky = parms["skyparm"].get("fsky")
    eff_nsrc = nsrc * (float(fsky) if fsky else 1.0)
    blk = int(float(memuse) * 2 ** 30 / bytes_per_src)
    return int(np.clip(blk, 16, max(16, eff_nsrc)))


def build_tsys(parms, freqs, nbl, n_acc):
    """System temperature (nbl, nchan, nacc): flat telescope.Tsys or
    Trx + Tant_ref (f/f_ref)^spindex (the Tsysinfo model,
    /root/reference/prisim/interferometry.py:5993-6086)."""
    tp = parms["telescope"]
    if tp.get("Tsys") is not None:
        tsys = np.full((nbl, freqs.size, n_acc), float(tp["Tsys"]))
    else:
        tant = (float(tp.get("Tant_ref") or 0.0) *
                (freqs / float(tp.get("Tant_freqref") or 150e6))
                ** float(tp.get("Tant_spindex") or 0.0))
        tsys = np.broadcast_to(
            (float(tp.get("Trx") or 0.0) + tant)[None, :, None],
            (nbl, freqs.size, n_acc)).copy()
    return tsys


def _blgroups_dict(bls):
    """Redundancy bookkeeping for the saved product (the reference's
    blgroups/reversemap, interferometry.py:1640-1658): unique-exemplar
    label pair -> member all-pairs label strings."""
    if bls.group_of is None:
        return None
    out = {}
    all_lab = np.asarray(bls.all_labels, dtype=str)
    uniq_lab = np.asarray(bls.labels, dtype=str)
    for u in range(bls.nbl):
        members = np.where(bls.group_of == u)[0]
        key = "%s_%s" % (uniq_lab[u, 0], uniq_lab[u, 1])
        out[key] = ["%s_%s" % (all_lab[m, 0], all_lab[m, 1])
                    for m in members]
    return out


def _bandpass_weights(parms, nbl, freqs, n_acc):
    """Channel flagging -> bp; window shape -> bp_wts
    (run_prisim.py:908-981 flags; processing.bpass_shape).

    For frequency-chunked runs the reference builds the bandpass once
    over the FULL band before chunking (run_prisim.py:898-981): flag
    indices, edge flags, and window shapes are global-band quantities.
    When pp._chunk metadata is present, compute on the full grid and
    slice this chunk's channels."""
    chunk = (parms.get("pp") or {}).get("_chunk")
    if chunk and int(chunk.get("axis", -1)) == 1:
        nchan_total = int(chunk["nchan_total"])
        chan0 = int(chunk["chan0"])
        df = float(parms["bandpass"]["freq_resolution"])
        freqs_full = (freqs[0] - df * chan0) + df * np.arange(nchan_total)
        bp, wts = _bandpass_weights_full(parms, nbl, freqs_full, n_acc)
        sl = slice(chan0, chan0 + freqs.size)
        return (np.ascontiguousarray(bp[:, sl, :]),
                np.ascontiguousarray(wts[:, sl, :]))
    return _bandpass_weights_full(parms, nbl, freqs, n_acc)


def _bandpass_weights_full(parms, nbl, freqs, n_acc):
    from . import windows as win
    nchan = freqs.size
    bp = np.ones((nbl, nchan, n_acc))
    pfb = (parms.get("bandpass") or {}).get("pfb_method")
    ccw = int(parms["processing"].get("coarse_channel_width") or 16)
    shape1d = None
    if pfb == "theoretical" and parms["bandpass"].get("pfb_file"):
        # measured PFB response from a FITS table (run_prisim.py:
        # 916-927): hdu0 = per-filter response grid (dB), hdu1 =
        # frequency axis (MHz); summed in linear units and interpolated
        # onto the channels
        shape1d = win.pfb_theoretical_shape(
            parms["bandpass"]["pfb_file"], freqs)
    elif pfb is not None:
        # analytic PFB scalloping (stand-in for the empirical MWA
        # table, DSP.PFB_empirical at run_prisim.py:914)
        shape1d = win.pfb_shape(nchan, ccw)
    if shape1d is not None and not parms["processing"].get("bp_correct",
                                                           True):
        bp *= shape1d[None, :, None]
    abf = parms["processing"].get("ant_bpass_file")
    if abf:
        # antenna bandpass table: npz with 'faxis' (Hz) and complex
        # 'band'; |band| interpolated onto the channels and peak-
        # normalized (run_prisim.py:934-944)
        with np.load(abf) as d:
            faxis = np.asarray(d["faxis"], dtype=np.float64)
            band = np.abs(np.asarray(d["band"]))
        band = band / band.max()
        ant_bp = np.interp(freqs, faxis, band)
        bp *= ant_bp[None, :, None]
    fl = parms.get("flags") or {}
    n_edge = [int(x) for x in (fl.get("n_edge_flag") or [0, 0])]
    if fl.get("flag_repeat_edge_channels") and shape1d is not None \
            and (n_edge[0] or n_edge[1]):
        # flag around every coarse-channel edge of the PFB shape instead
        # of the band edges (run_prisim.py:928-940, 964-966)
        e0 = int(np.argmin(shape1d))
        edges = (e0 + np.arange(nchan // ccw) * ccw) % nchan
        edges = np.unique(np.hstack([edges, [edges.min() - ccw,
                                             edges.max() + ccw]]))
        for e in edges:
            bp[:, max(0, e - n_edge[0]):
               max(0, min(nchan, e + n_edge[1])), :] = 0.0
    else:
        if n_edge[0]:
            bp[:, :n_edge[0], :] = 0.0
        if n_edge[1]:
            bp[:, nchan - n_edge[1]:, :] = 0.0
    flag_chan = np.asarray(fl.get("flag_chan") if fl.get("flag_chan")
                           is not None else [-1]).ravel().astype(int)
    if fl.get("bp_flag_repeat"):
        # within-coarse-channel offsets repeated across every coarse
        # channel (run_prisim.py:971-974)
        flag_chan = flag_chan[flag_chan >= 0] % ccw
        reps = np.arange(0, nchan, ccw)
        flag_chan = np.unique((flag_chan[None, :] +
                               reps[:, None]).ravel())
    flag_chan = flag_chan[(flag_chan >= 0) & (flag_chan < nchan)]
    if flag_chan.size:
        bp[:, flag_chan, :] = 0.0
    shape = (parms["processing"].get("bpass_shape") or "rect").lower()
    if shape == "rect":
        wts = np.ones((nbl, nchan, n_acc))
    else:
        w = win.window_vals(nchan, shape=shape, xp=np)
        wts = np.broadcast_to(w[None, :, None],
                              (nbl, nchan, n_acc)).copy()
    return bp, wts


def _use_pallas(parms):
    """processing.use_pallas: 'auto' takes the Pallas kernel where it
    compiles (engine.pallas_nudft.pallas_available); true demands it
    and raises where it cannot compile; false keeps the XLA engine."""
    from .engine.pallas_nudft import pallas_available
    up = parms["processing"].get("use_pallas", "auto")
    if up == "auto":
        return pallas_available()
    if up and not pallas_available():
        import jax
        raise ValueError(
            "processing.use_pallas: true needs the Pallas kernel, which "
            "compiles only for NVIDIA GPUs (platform here: %s); set "
            "use_pallas to auto or false" % jax.devices()[0].platform)
    return bool(up)


class _EngineDemotion(Exception):
    """Internal: re-run with demoted engine/spread parms AFTER the
    current _run_simulation_inner frame unwinds. A recursive re-entry
    (rounds 3-4) kept the demoted attempt's device buffers alive
    through the outer frame's locals — gate executables plus the
    (S, C) amps working set — and a north-star fallback could run out
    of device memory."""

    def __init__(self, parms):
        super().__init__("engine demotion")
        self.parms = parms


def run_simulation(parms, outdir=None, verbose=True, save=True,
                   _sky_override=None):
    """Run a full simulation from a parameter source (path/str/dict).

    Returns (VisibilitySet, output_dir or None)."""
    import jax
    from .utils import enable_compilation_cache
    enable_compilation_cache()
    if not isinstance(parms, dict) or "telescope" not in parms:
        parms = load_parms(parms)
    t0 = time.time()
    profile_dir = (parms.get("diagnosis") or {}).get("jax_profile")
    profiler = None
    if profile_dir:
        # device-level tracing (the device-side upgrade of the
        # reference's psutil monitor; view with tensorboard or xprof)
        import jax.profiler as _jprof
        os.makedirs(profile_dir, exist_ok=True)
        profiler = _jprof.trace(profile_dir)
        profiler.__enter__()
    monitor = None
    if (parms.get("diagnosis") or {}).get("resource_monitor"):
        from .diagnostics import ResourceMonitor
        ds = parms["dirstruct"]
        mon_path = os.path.join(ds.get("rootdir") or "./",
                                "resource_monitor.jsonl")
        monitor = ResourceMonitor(
            mon_path, interval=float(
                (parms["diagnosis"].get("refresh_interval") or 1.0)))
        monitor.start()
    try:
        cur = parms
        while True:
            try:
                return _run_simulation_inner(cur, outdir, verbose,
                                             save, _sky_override, t0)
            except _EngineDemotion as dem:
                # the failed attempt's frame is unwound here: its
                # device buffers drop to refcount 0 before the re-run
                # allocates its own working set
                cur = dem.parms
                import gc
                gc.collect()
    finally:
        if monitor is not None:
            monitor.stop()
        if profiler is not None:
            profiler.__exit__(None, None, None)


def _sector_mask(dircos, k, n_sectors, xp=None):
    """Per-snapshot azimuthal sky-sector membership (jit-safe).

    The reference re-sections the above-horizon sky per snapshot into
    n azimuth wedge-pairs of width 180/n deg: sector k is
    az in [-w/2 + k*w, -w/2 + (k+1)*w) union the antipodal wedge
    (run_prisim.py:1859-1875). Both wedges collapse to
    floor(((az + w/2) mod 180) / w) == k. Evaluated from the CURRENT
    ENU direction cosines, so membership tracks the drift exactly
    (round-3 partitioned the catalog once at the mean LST)."""
    import jax.numpy as jnp
    xp = xp or jnp
    az = xp.degrees(xp.arctan2(dircos[..., 0], dircos[..., 1]))
    w = 180.0 / n_sectors
    m = xp.mod(az + 0.5 * w, 180.0)
    return (xp.floor(m / w) == k).astype(dircos.dtype)


def _run_simulation_inner(parms, outdir, verbose, save, _sky_override,
                          t0):
    import jax
    tp = parms["telescope"]
    lat = float(tp["latitude"])

    def _phase(label, _last=[time.time()]):
        # wall-clock breakdown of the pipeline stages (verbose runs):
        # at north-star sizes the host sky build and device transfers
        # rival the kernel, and this is how a user finds out
        now = time.time()
        if verbose:
            print("[prisim_tpu] ... %s (+%.1f s)" % (label,
                                                     now - _last[0]))
        _last[0] = now

    layout = build_layout(parms)
    blp = parms.get("baseline") or {}
    bls = build_baselines(layout,
                          redundant=bool(parms["array"].get("redundant",
                                                            True)),
                          min_length=blp.get("min"),
                          max_length=blp.get("max"),
                          direction_deg=blp.get("direction"))
    freqs = build_frequencies(parms)
    obs = build_schedule(parms, lat)
    _phase("layout/baselines/schedule built")
    sky = _sky_override if _sky_override is not None \
        else build_sky(parms, freqs)
    if _sky_override is None:
        sky = precess_sky_to_obs_epoch(sky, parms, obs)

    roi = parms["skyparm"].get("roi_radius")
    if roi is not None and _sky_override is None:
        # restrict the catalog to sources within roi_radius degrees of
        # the (mean-LST) pointing center (skyparm.roi_radius)
        pc_altaz = build_schedule(parms, lat).pointing_altaz.mean(axis=0)
        hadec = geom.altaz2hadec(pc_altaz.reshape(1, 2), lat, xp=np)
        pc_ra = (np.mean(obs.lst_deg) - hadec[0, 0]) % 360.0
        d = geom.sphdist(sky.location[:, 0], sky.location[:, 1],
                         pc_ra, hadec[0, 1], xp=np)
        sky = sky.subset(np.where(d <= float(roi))[0])
        if sky.nsrc == 0:
            raise ValueError(
                "skyparm.roi_radius=%.1f deg leaves no sources in the "
                "field of view" % float(roi))

    n_sectors = int(parms["processing"].get("n_sky_sectors") or 1)
    if _sky_override is not None:
        n_sectors = 1
    if n_sectors > 1:
        # azimuthal sky sectors simulated as separate outputs with
        # PER-SNAPSHOT membership (run_prisim.py:1859-1875): the sector
        # wedge is applied inside the jit as an amplitude mask on the
        # snapshot's CURRENT source azimuths (same trick as the horizon
        # cut), so drift-scan edge sources land in the right sector at
        # every accumulation. A host-side prefilter drops sources that
        # never enter the sector during the whole scan (with a 2-deg
        # guard margin; the in-jit mask is the ground truth).
        w = 180.0 / n_sectors
        lst = np.asarray(obs.lst_deg, dtype=np.float64)
        ha = (lst[:, None] - sky.location[None, :, 0])      # (T, S) deg
        dec = np.radians(sky.location[:, 1])[None, :]
        lat_r = np.radians(lat)
        har = np.radians(ha)
        sin_alt = (np.sin(lat_r) * np.sin(dec)
                   + np.cos(lat_r) * np.cos(dec) * np.cos(har))
        # azimuth from north, eastward (matches dircos e/n convention)
        az = np.degrees(np.arctan2(
            -np.cos(dec) * np.sin(har),
            np.sin(dec) * np.cos(lat_r)
            - np.cos(dec) * np.sin(lat_r) * np.cos(har)))
        above = sin_alt > np.sin(np.radians(-2.0))
        fold = np.mod(az + 0.5 * w, 180.0)
        outs = []
        import copy as _copy
        for k in range(n_sectors):
            # margin-expanded wedge membership at ANY snapshot
            lo_k, hi_k = k * w - 2.0, (k + 1) * w + 2.0
            inw = (fold >= lo_k) & (fold < hi_k)
            if lo_k < 0.0:
                inw |= fold >= lo_k + 180.0
            if hi_k > 180.0:
                inw |= fold < hi_k - 180.0
            keep = np.where(np.any(inw & above, axis=0))[0]
            sub = sky.subset(keep)
            if sub.nsrc == 0:
                outs.append(None)
                continue
            p2 = _copy.deepcopy(parms)
            p2["processing"]["n_sky_sectors"] = 1
            p2["_sector"] = (k, n_sectors)
            if p2["dirstruct"].get("simid"):
                p2["dirstruct"]["simid"] += "_sector%d" % k
            outs.append(run_simulation(
                p2, outdir=None if outdir is None
                else outdir + "_sector%d" % k,
                verbose=verbose, save=save, _sky_override=sub)[0])
        return outs, outdir

    telescope = {
        "id": tp.get("id", "custom"),
        "shape": parms["antenna"].get("shape", "dish"),
        "size": parms["antenna"].get("size", 14.0),
        "ocoords": parms["antenna"].get("ocoords", "altaz"),
        "orientation": parms["antenna"].get("orientation", [90.0, 270.0]),
        "groundplane": parms["antenna"].get("ground_plane"),
    }
    ori = np.asarray(telescope["orientation"], dtype=np.float64)
    if telescope["ocoords"] == "altaz":
        telescope["orientation_dircos"] = tuple(
            geom.altaz2dircos(ori.reshape(1, 2), xp=np)[0])

    inst = Instrument.build(bls.vectors, freqs, latitude=lat,
                            longitude=float(tp.get("longitude") or 0.0),
                            altitude=float(tp.get("altitude") or 0.0),
                            A_eff=float(tp.get("A_eff") or 154.0),
                            eff_Q=float(tp.get("eff_Q") or 1.0),
                            telescope=telescope)
    _phase("sky model built (%d sources)" % sky.nsrc)
    sks = SkySources.from_skymodel(sky, freqs)
    _phase("spectra precomputed")

    from .beams.dispatch import primary_beam

    pointing_info = None
    if parms["antenna"].get("phased_array"):
        # phased-array beamformer: element positions + per-element delay/
        # gain errors (phasedarray section; primary_beam_generator's
        # pointing_info path, /root/reference/prisim/primary_beams.py:
        # 288-316)
        pa = parms.get("phasedarray") or {}
        if pa.get("file"):
            from .layouts import parse_layout_file
            elem = parse_layout_file(pa["file"], skip_rows=0)
            telescope["element_locs"] = np.asarray(elem.positions)
        else:
            from .beams import mwa_tile_positions
            telescope["element_locs"] = mwa_tile_positions()
        pc0 = geom.altaz2dircos(obs.pointing_altaz[:1], xp=np)[0]
        pointing_info = {
            "pointing_center_dircos": tuple(pc0),
            "delayerr": float(pa.get("delayerr") or 0.0),
            "gainerr": float(pa.get("gainerr") or 0.0),
            "nrand": int(pa.get("nrand") or 1)}

    _sector = parms.get("_sector")
    bm_cfg = parms.get("beam") or {}
    achromatic = (bm_cfg.get("chromatic") is False)
    sel_freq = float(bm_cfg.get("select_freq") or 150e6)
    pol = str(bm_cfg.get("pol") or "X").upper()
    if pol in ("XY", "DUAL"):
        # dual-polarization run (beyond the single-pol reference): X
        # and Y feeds simulated separately (the Y feed is X rotated 90
        # deg in azimuth), products per pol, plus combined
        # two-polarization UVFITS/UVH5 exports from _finalize
        import copy as _copy
        outs = []
        for p in ("X", "Y"):
            p2 = _copy.deepcopy(parms)
            p2["beam"]["pol"] = p
            if p2["dirstruct"].get("simid"):
                p2["dirstruct"]["simid"] += "_pol" + p
            outs.append(run_simulation(
                p2, outdir=None if outdir is None
                else outdir + "_pol" + p,
                verbose=verbose, save=save, _sky_override=_sky_override))
        (vs_x, dir_x), (vs_y, _) = outs
        if save and dir_x is not None:
            from .io.uvfits import save_uvfits
            from .io.uvh5 import save_uvh5
            base = os.path.join(dir_x, "simdata", "simvis_dualpol")
            save_uvfits(vs_x, base + ".uvfits", vs_second=vs_y)
            save_uvh5(vs_x, base + ".uvh5", vs_second=vs_y)
            # standard 4-pol products (XX, YY + explicit zero flagged
            # cross-pols) so downstream tools see the full linear
            # polarization axis (interferometry.py:9528-9618)
            base4 = os.path.join(dir_x, "simdata", "simvis_4pol")
            save_uvfits(vs_x, base4 + ".uvfits", vs_second=vs_y,
                        four_pol=True)
            save_uvh5(vs_x, base4 + ".uvh5", vs_second=vs_y,
                      four_pol=True)
            if verbose:
                print("[prisim_tpu] dual-pol exports -> %s.{uvfits,"
                      "uvh5} + %s.{uvfits,uvh5}" % (base, base4))
        return [vs_x, vs_y], dir_x
    if pol == "FULL":
        # full-polarization run (beyond the single-pol reference):
        # XX, YY AND the physical XY=YX leakage
        # product from crossed-dipole Jones vectors (beams/jones.py).
        # Three component sims share the sky and schedule; the engines
        # see each Mueller weight as an ordinary (sign-indefinite)
        # beam. With real dipole Jones vectors B_YX = B_XY, so one
        # cross sim covers both UVFITS/UVH5 cross products.
        import copy as _copy
        outs = []
        for comp in ("XX", "YY", "XY"):
            p2 = _copy.deepcopy(parms)
            p2["beam"]["pol"] = "X"
            p2["_mueller_component"] = comp
            if p2["dirstruct"].get("simid"):
                p2["dirstruct"]["simid"] += "_" + comp.lower()
            outs.append(run_simulation(
                p2, outdir=None if outdir is None
                else outdir + "_" + comp.lower(),
                verbose=verbose, save=save, _sky_override=_sky_override))
        (vs_xx, dir_x), (vs_yy, _), (vs_xy, _) = outs
        if save and dir_x is not None:
            from .io.uvfits import save_uvfits
            from .io.uvh5 import save_uvh5
            base = os.path.join(dir_x, "simdata", "simvis_fullpol")
            save_uvfits(vs_xx, base + ".uvfits", vs_second=vs_yy,
                        four_pol=True, vs_cross=vs_xy)
            save_uvh5(vs_xx, base + ".uvh5", vs_second=vs_yy,
                      four_pol=True, vs_cross=vs_xy)
            if verbose:
                print("[prisim_tpu] full-pol exports -> %s.{uvfits,"
                      "uvh5}" % base)
        return [vs_xx, vs_yy, vs_xy], dir_x
    if pol not in ("X", "Y"):
        raise ValueError("beam.pol must be X, Y, XY, or full")

    def beam_fn(dircos, f, pc=None):
        import jax.numpy as jnp
        pinfo = pointing_info
        if pc is not None and pointing_info is not None:
            # per-snapshot beamformer steering: the engines thread the
            # snapshot's pointing dircos through the scan exactly like
            # the rotation matrices, so a tracking phased array steers
            # per accumulation (primary_beams.py:288-316 + the per-
            # snapshot pointing_info of run_prisim.py:1897-1912) —
            # round-3 froze snapshot 0's pointing for the whole run
            pinfo = dict(pointing_info, pointing_center_dircos=pc)
        pb = None
        if achromatic:
            pb1 = primary_beam(dircos, jnp.asarray([sel_freq],
                                                   jnp.float32),
                               telescope, pointing_info=pinfo,
                               pol=pol)
            pb = jnp.broadcast_to(pb1, (dircos.shape[0], f.shape[0]))
        else:
            pb = primary_beam(dircos, f, telescope,
                              pointing_info=pinfo, pol=pol)
        if _sector is not None:
            pb = pb * _sector_mask(dircos, *_sector)[:, None]
        return pb

    beam_fn.needs_pointing = pointing_info is not None

    _mueller = parms.get("_mueller_component")
    if _mueller is not None:
        # full-pol component run: the beam IS the unpolarized-sky
        # Mueller weight of the configured crossed-dipole feeds
        # (beams/jones.py); XY is sign-indefinite, which the NUDFT
        # engines never assume away.
        from .beams.jones import mueller_unpol_weights
        fd = dict((parms.get("beam") or {}).get("feeds") or {})
        _mkw = dict(
            length=float(fd.get("length") or 1.3),
            ground_height=(None if fd.get("height") is None
                           else float(fd["height"])),
            x_orientation_deg=float(fd.get("x_orientation_deg") or 0.0),
            y_orientation_deg=float(
                90.0 if fd.get("y_orientation_deg") is None
                else fd["y_orientation_deg"]),
            short_dipole=bool(fd.get("short_dipole")),
            half_wave=bool(fd.get("half_wave", True)))
        _comp = str(_mueller).upper()
        if _comp not in ("XX", "YY", "XY"):
            raise ValueError("_mueller_component must be XX, YY or XY")

        def beam_fn(dircos, f, pc=None):  # noqa: F811
            pb = mueller_unpol_weights(dircos, f, **_mkw)[_comp]
            if _sector is not None:
                pb = pb * _sector_mask(dircos, *_sector)[:, None]
            return pb

        beam_fn.needs_pointing = False

    # Two-float beam form for the truth-amps NUFFT path (round 5):
    # attached when the configured beam reduces to a plain chromatic
    # zenith Airy power pattern — the flagship drift configs. Anything
    # steering, sectoring, ground-plane-modified, or non-dish keeps
    # the f32 path (the engine falls back automatically).
    if (_sector is None and pointing_info is None and not achromatic
            and not (parms.get("beam") or {}).get("use_external")
            and pol in ("X", "Y") and _mueller is None
            and not telescope.get("groundplane")):
        from .beams.analytic import airy_beam_df, airy_df_available
        tid = telescope.get("id")
        odc = telescope.get("orientation_dircos")
        # hera/hirax steer the Airy axis by orientation_dircos; the
        # two-float form is zenith-only, so require it to BE zenith
        # (the default [alt=90] orientation). The generic 'dish' shape
        # ignores orientation entirely (dispatch.py).
        zenith = odc is None or (abs(odc[0]) < 1e-12
                                 and abs(odc[1]) < 1e-12
                                 and odc[2] > 0)
        dia = ((14.0 if tid == "hera" else 6.0) if
               (tid in ("hera", "hirax") and zenith)
               else telescope.get("size")
               if (tid not in ("vla", "gmrt", "ugmrt", "mwa",
                               "mwa_dipole", "paper", "hera", "hirax")
                   and telescope.get("aperture_locs") is None
                   and telescope.get("shape") == "dish") else None)
        if dia and airy_df_available(freqs, float(dia)):
            _dia = float(dia)

            def _beam_df(s_hi, s_lo, f_nodes):
                return airy_beam_df(s_hi, s_lo, f_nodes, _dia)

            beam_fn.df_eval = _beam_df

    bm = parms.get("beam") or {}
    if bm.get("use_external") and bm.get("file"):
        # external HEALPix beam: host-side log-interp per snapshot
        # (run_prisim.py:1897-1912) feeding precomputed amps to the
        # jit NUDFT — the beam table stays out of the traced graph.
        from .beams.external import ExternalBeam
        ext = (ExternalBeam.from_hdf5(bm["file"])
               if not str(bm["file"]).endswith((".fits", ".uvbeam"))
               else ExternalBeam.from_fits(bm["file"]))
        vis_list = []
        import jax
        import jax.numpy as jnp
        from . import twofloat as tf2
        from .engine.observe import df_rotate3, simulate_snapshot
        Mh_all, Ml_all = obs.rotations(lat)
        pch, pcl = tf2.split_f64(obs.pc_dircos())
        # Device-side beam evaluation: the
        # (npix, nchan) log-beam table is frequency-interpolated ONCE
        # and uploaded once; per snapshot the host computes only the
        # O(S) angular interp weights, and the jit step does the
        # 4-neighbor row gather + 10^ + NUDFT in one compile.
        logtable = jnp.asarray(ext.channel_table(
            freqs, chromatic=bool(bm.get("chromatic", True)),
            select_freq=bm.get("select_freq")))
        src_block_ext = int(parms["processing"].get("src_block") or 512)
        use_pl_ext = _use_pallas(parms)

        @jax.jit
        def ext_snapshot(mh, ml, ph, pl_, pix, wgt):
            def beam(s, f):
                pb = ExternalBeam.device_evaluate(logtable, pix, wgt)
                if _sector is not None:
                    pb = pb * _sector_mask(s, *_sector)[:, None]
                return pb
            return simulate_snapshot(inst, sks, mh, ml, ph, pl_, beam,
                                     src_block=src_block_ext,
                                     use_pallas=use_pl_ext)

        pending = None                # depth-2 pipeline: the fetch of
        for t in range(obs.n_acc):    # snapshot t-1 overlaps compute t
            sh, _ = df_rotate3(jnp.asarray(Mh_all[t]),
                               jnp.asarray(Ml_all[t]),
                               sks.s_eq_hi, sks.s_eq_lo)
            sh_np = np.asarray(sh, dtype=np.float64)
            altaz = geom.dircos2altaz(
                np.clip(sh_np, -1.0, 1.0), xp=np)
            pix, wgt = ext.interp_weights(altaz)
            nxt = ext_snapshot(
                jnp.asarray(Mh_all[t]), jnp.asarray(Ml_all[t]),
                jnp.asarray(pch[t]), jnp.asarray(pcl[t]),
                jnp.asarray(pix), jnp.asarray(wgt))
            if pending is not None:
                vis_list.append(np.asarray(pending))
            pending = nxt
        if pending is not None:
            vis_list.append(np.asarray(pending))
        skyvis = np.ascontiguousarray(
            np.transpose(np.stack(vis_list), (1, 2, 0)))
        gradients = None
        return _finalize_simulation(parms, vs_inputs=dict(
            bls=bls, freqs=freqs, obs=obs, layout=layout,
            telescope=telescope, skyvis=skyvis, gradients=None,
            lat=lat, tp=tp), outdir=outdir, verbose=verbose, save=save,
            t0=t0)

    if verbose:
        print("[prisim_tpu] %d bl x %d chan x %d acc, %d sources"
              % (bls.nbl, freqs.size, obs.n_acc, sks.flux.shape[0]))
    grad = parms["processing"].get("gradient_mode")
    src_block = int(parms["processing"].get("src_block") or 512)
    mem_block = _src_block_from_memuse(parms, bls.nbl, freqs.size,
                                       sks.flux.shape[0])
    if mem_block is not None:
        src_block = min(src_block, mem_block)
    out = None
    pp = parms.get("pp") or {}
    engine = (parms["processing"].get("engine") or "auto").lower()
    if engine == "auto":
        engine = "direct"
    if engine == "nufft" and not grad and sks.src_shape_sigma is None:
        # EXPERIMENTAL delay-space NUFFT engine (processing.engine:
        # nufft): fully jittable snapshot (fixed Chebyshev spectral
        # basis), compiled once and looped over accumulations; falls
        # back to direct for gradients/extended sources
        import jax.numpy as jnp
        from . import twofloat as _tf
        from .engine.nufft_delay import (simulate_snapshot_nufft_jit,
                                         chebyshev_projection)
        from .engine.observe import simulate_snapshot
        Mh, Ml = obs.rotations(inst.latitude)
        pch, pcl = _tf.split_f64(obs.pc_dircos())
        # default spectral rank is bandwidth-aware: rank 16 reaches the
        # f32 fit floor for <=40% fractional bandwidth; chromatic
        # (Airy) beams over a full octave need 32 — the rank-24 fit
        # residual is COHERENT across sources and dominated the banded
        # engine's full-scale error (f64 algorithm probe, round 3:
        # rank 24 -> 3.5e-6 scaled at nside-128, rank 32 -> 1.5e-7;
        # benchmarks/probe_banded_f64.py)
        frac_bw = (freqs[-1] - freqs[0]) / freqs[freqs.size // 2]
        rank_default = 16 if frac_bw <= 0.4 else 32
        rank = int(parms["processing"].get("nufft_rank")
                   or rank_default)
        # rank approaching nchan makes the Chebyshev basis f32-toxic
        # (rank 31 at C=32 measured 1.6e-2 rel; tests/test_parallel);
        # cap at half the channel count
        rank = min(rank, max(2, freqs.size // 2))
        spread = str(parms["processing"].get("nufft_spread")
                     or "sorted").lower()
        if spread == "auto":
            spread = "sorted"
        pinvQ, Q = chebyshev_projection(freqs, min(rank, freqs.size))
        # banded plan numerics override (config processing.nufft_beta;
        # None rides the plan default)
        plan_kw = {}
        if parms["processing"].get("nufft_beta"):
            plan_kw["beta"] = parms["processing"]["nufft_beta"]
        ndev_nufft = len(jax.devices())
        direct0 = None
        # Both banded routes (single-device and 'bl'-mesh) carry their
        # own shared-amps gate at the 2e-6 default — the cross-program
        # direct0 yardstick below is only for the sorted spread.
        banded_gated = spread == "banded"
        if parms["processing"].get("nufft_crosscheck", True) \
                and not banded_gated:
            # The gate's direct reference snapshot runs BEFORE the fast
            # engine so its working set (full (S, C) beam amps + phase
            # blocks) has the whole device memory to itself — evaluating it after
            # the banded dispatch ResourceExhausted at north-star size
            # at north-star size, and it must be JITTED: the eager call
            # materializes the beam, the flux product and the horizon
            # mask as separate (S, C) device arrays (~3.2 GB each at
            # nside 256) instead of letting XLA fuse them. The sky
            # pytree rides as an ARGUMENT (closure-captured device
            # arrays become executable constants).
            _direct_jit = jax.jit(
                lambda seqh, seql, fx, mh, ml, ph, pl:
                simulate_snapshot(
                    inst, SkySources(s_eq_hi=seqh, s_eq_lo=seql,
                                     flux=fx,
                                     src_shape_sigma=
                                     sks.src_shape_sigma),
                    mh, ml, ph, pl, beam_fn, src_block=src_block))
            direct0 = np.asarray(_direct_jit(
                sks.s_eq_hi, sks.s_eq_lo, sks.flux,
                jnp.asarray(Mh[0]), jnp.asarray(Ml[0]),
                jnp.asarray(pch[0]), jnp.asarray(pcl[0])))
        if ndev_nufft > 1 and ((parms.get("pp") or {}).get("key")
                               or "freq").lower() != "none" \
                and spread == "banded":
            # multi-chip banded NUFFT: the banded plan shards over 'bl'
            # only (each shard FFTs the full band), so the mesh rides
            # the baseline axis regardless of pp.key — the result is
            # identical to any other decomposition of the same sum.
            # nufft_spread: sorted restores pp.key semantics for the
            # mesh.
            from .parallel.mesh import (make_mesh,
                                        simulate_drift_banded_sharded)
            if ((parms.get("pp") or {}).get("key") or "").lower() \
                    != "bl" and verbose:
                print("[prisim_tpu] banded NUFFT on %d devices: mesh "
                      "rides the 'bl' axis (full band per shard)"
                      % ndev_nufft)
            nmesh = make_mesh(axis_names=("bl", "chan"),
                              shape=(ndev_nufft, 1))
            node_model_m = bool(parms["processing"].get(
                "nufft_node_model", True))
            rank_m = min(rank, max(2, freqs.size // 2))
            truth_req_m = str(parms["processing"].get(
                "nufft_truth_amps", "auto")).lower()
            truth_m = None
            if node_model_m and truth_req_m in ("auto", "true", "1",
                                                "yes", "on") \
                    and hasattr(beam_fn, "df_eval"):
                from .engine.nufft_delay import chebyshev_node_model
                nmt = chebyshev_node_model(freqs, rank_m)
                truth_m = {"beam_df": beam_fn.df_eval,
                           "flux_nodes": sky.generate_spectrum(
                               nmt.nu_nodes)}
            if parms["processing"].get("nufft_crosscheck", True):
                # Shared-amps gate for the mesh path: one
                # single-device jit program feeds the exact
                # direct NUDFT and the banded pipeline the SAME coeff
                # model the shards consume (same rank, node model, and
                # collapse=False plan geometry — per-baseline banded
                # arithmetic is shard-invariant), so the default
                # tolerance enforces the 2e-6 spec instead of the
                # ~3e-5 cross-program beam-recompute floor.
                from .engine.nufft_banded import (
                    make_banded_plan, make_banded_snapshot_fns)
                try:
                    gplan = make_banded_plan(
                        np.asarray(bls.vectors), inst.nu0, inst.dnu,
                        freqs.size, rank=rank_m, collapse=False,
                        **plan_kw)
                except ValueError as exc:
                    print("[prisim_tpu] banded NUFFT plan rejected "
                          "(%s); re-running with the sorted spread"
                          % exc)
                    p2 = dict(parms)
                    p2["processing"] = dict(parms["processing"],
                                            nufft_spread="sorted")
                    raise _EngineDemotion(p2)
                gsnap = make_banded_snapshot_fns(
                    inst, sks, beam_fn, gplan, pinvQ, Q,
                    gate_src_block=src_block,
                    node_model=node_model_m, truth=truth_m)
                tol = float(parms["processing"].get(
                    "nufft_crosscheck_tol") or 2e-6)
                rtol_m = float(parms["processing"].get(
                    "nufft_resid_tol") or 1e-4)
                dg, bg, okg, residg, csA_m = gsnap.gate_fn(
                    jnp.asarray(Mh[0]), jnp.asarray(Ml[0]),
                    jnp.asarray(pch[0]), jnp.asarray(pcl[0]))
                # normalize by the coherent flux scale max_c Σ_s|A_sc|
                # (>= max|V| by the triangle inequality): the metric
                # every f32 engine's absolute error actually scales
                # with. See _gate_impl's return docstring.
                scale = max(float(np.abs(dg).max()), csA_m, 1e-30)
                rel = float(np.abs(bg - dg).max()) / scale
                resid_bad = truth_m is not None and residg > rtol_m
                if not okg or rel > tol or resid_bad:
                    print("[prisim_tpu] banded NUFFT mesh shared-amps "
                          "cross-check FAILED (rel=%.2e > %.0e, ok=%s"
                          "%s); falling back to the direct engine"
                          % (rel, tol, okg,
                             ", model resid=%.2e > %.0e"
                             % (residg, rtol_m) if resid_bad else ""))
                    p2 = dict(parms)
                    p2["processing"] = dict(parms["processing"],
                                            engine="direct")
                    raise _EngineDemotion(p2)
                if verbose:
                    print("[prisim_tpu] banded/direct mesh shared-amps"
                          " cross-check ok (rel=%.2e%s)"
                          % (rel, ", truth amps, model resid=%.2e"
                             % residg if truth_m is not None else ""))
            vis_cube, ok_b = simulate_drift_banded_sharded(
                inst, sks, obs, beam_fn, nmesh,
                rank=min(rank, freqs.size),
                node_model=node_model_m,
                truth=truth_m, plan_kw=plan_kw)
            if not ok_b:
                print("[prisim_tpu] banded NUFFT unit-source check "
                      "failed; re-running with the sorted spread")
                p2 = dict(parms)
                p2["processing"] = dict(parms["processing"],
                                        nufft_spread="sorted")
                raise _EngineDemotion(p2)
            snaps = [np.asarray(vis_cube[t])
                     for t in range(obs.n_acc)]
        elif ndev_nufft > 1 and ((parms.get("pp") or {}).get("key")
                                 or "freq").lower() != "none":
            # multi-chip NUFFT: same mesh decompositions as the direct
            # engine (bl/chan/src), sorted spreading per shard
            from .parallel.mesh import (make_mesh,
                                        simulate_drift_nufft_sharded)
            key = ((parms.get("pp") or {}).get("key") or "freq").lower()
            axes = (parms.get("pp") or {}).get("mesh_axes")
            if key == "src":
                nmesh = make_mesh(axis_names=("bl", "chan", "src"),
                                  shape=tuple(axes) if axes
                                  else (1, 1, ndev_nufft))
            elif key == "freq":
                nmesh = make_mesh(axis_names=("bl", "chan"),
                                  shape=tuple(axes) if axes
                                  else (1, ndev_nufft))
            else:
                nmesh = make_mesh(axis_names=("bl", "chan"),
                                  shape=tuple(axes) if axes
                                  else (ndev_nufft, 1))
            vis_cube = simulate_drift_nufft_sharded(
                inst, sks, obs, beam_fn, nmesh,
                rank=min(rank, freqs.size))
            snaps = [np.asarray(vis_cube[t])
                     for t in range(obs.n_acc)]
        elif spread == "banded":
            # banded spread (engine/nufft_banded.py). Each snapshot also
            # returns an `ok` span-check flag; any failure (non-unit
            # source vectors whose bins could fall outside the static
            # block range) demotes the whole run to the sorted spread;
            # a plan whose row buffer exceeds its byte budget raises at
            # build time and demotes too.
            from .engine.nufft_banded import (
                make_banded_plan, make_banded_snapshot_fns)
            try:
                plan = make_banded_plan(
                    np.asarray(bls.vectors), inst.nu0, inst.dnu,
                    freqs.size, rank=min(rank, freqs.size),
                    **plan_kw)
            except ValueError as exc:
                print("[prisim_tpu] banded NUFFT plan rejected (%s); "
                      "re-running with the sorted spread" % exc)
                p2 = dict(parms)
                p2["processing"] = dict(parms["processing"],
                                        nufft_spread="sorted")
                raise _EngineDemotion(p2)
            node_model = bool(parms["processing"].get(
                "nufft_node_model", True))
            if node_model and not parms["processing"].get(
                    "nufft_crosscheck", True):
                # The node model fits each source's FLUX spectrum at
                # Chebyshev nodes before beam evaluation — exact for
                # smooth spectra, but tabulated/non-smooth spectra lose
                # accuracy vs the projection form, and with the gate
                # off nothing would catch it.
                print("[prisim_tpu] warning: nufft_node_model is on "
                      "with nufft_crosscheck disabled — non-smooth "
                      "source spectra may lose accuracy ungated "
                      "(set nufft_node_model: false for the "
                      "projection form)")
            # truth-amps (round 5): the whole node-amps chain in
            # two-float32 + a dual spread — takes the banded engine
            # under 1e-6 vs the f64 model truth (the f32 chain floors
            # at ~3.5e-6 at north-star source counts;
            # benchmarks/accuracy_northstar.py --golden f64amps).
            # Auto-enabled when the beam carries a two-float
            # form (plain chromatic Airy) and the node model is on.
            truth_req = str(parms["processing"].get(
                "nufft_truth_amps", "auto")).lower()
            truth = None
            if node_model and truth_req in ("auto", "true", "1",
                                            "yes", "on") \
                    and hasattr(beam_fn, "df_eval"):
                from .engine.nufft_delay import chebyshev_node_model
                nmt = chebyshev_node_model(freqs,
                                           min(rank, freqs.size))
                truth = {"beam_df": beam_fn.df_eval,
                         "flux_nodes": sky.generate_spectrum(
                             nmt.nu_nodes)}
            elif truth_req in ("true", "1", "yes", "on"):
                print("[prisim_tpu] nufft_truth_amps requested but "
                      "unavailable (needs the node model and a "
                      "two-float beam form); using the f32 path")
            snap_b = make_banded_snapshot_fns(
                inst, sks, beam_fn, plan, pinvQ, Q,
                gate_src_block=src_block, node_model=node_model,
                truth=truth)
            if parms["processing"].get("nufft_crosscheck", True):
                # shared-amps gate (run BEFORE the snapshot pipeline so
                # its direct working set has the whole HBM): one jit
                # program feeds both engines identical beam amps, so
                # the default tolerance can enforce the 1e-6-class spec
                # instead of the ~3e-5 cross-program yardstick floor
                tol = float(parms["processing"].get(
                    "nufft_crosscheck_tol") or 2e-6)
                rtol = float(parms["processing"].get(
                    "nufft_resid_tol") or 1e-4)
                direct0, banded0, ok0, resid0, csA0 = snap_b.gate_fn(
                    jnp.asarray(Mh[0]), jnp.asarray(Ml[0]),
                    jnp.asarray(pch[0]), jnp.asarray(pcl[0]))
                dump = os.environ.get("PRISIM_DEBUG_XCHECK_DUMP")
                if dump:
                    np.savez(dump, fast0=banded0, direct0=direct0,
                             Mh0=np.asarray(Mh[0]), Ml0=np.asarray(Ml[0]),
                             pch0=np.asarray(pch[0]),
                             pcl0=np.asarray(pcl[0]), freqs=freqs,
                             bl=np.asarray(bls.vectors), rank=rank,
                             resid0=np.asarray(resid0),
                             csA0=csA0,
                             truth_on=truth is not None,
                             s_eq_hi=np.asarray(sks.s_eq_hi),
                             s_eq_lo=np.asarray(sks.s_eq_lo),
                             flux=np.asarray(sks.flux),
                             flux_nodes=(np.asarray(truth["flux_nodes"])
                                         if truth is not None else 0))
                # Relative to the coherent flux scale max_c Σ_s|A_sc|
                # (>= max|V|; equal for a single dominant source):
                # any f32 source-summation engine's ABSOLUTE error is
                # ~1ulp-walk x this sum, while max|V| over the
                # simulated rows cancels far below it on diffuse
                # skies. Normalizing by max|V| would
                # demote every diffuse-sky run for a bound NO f32
                # engine (the direct one included) can meet.
                scale = max(float(np.abs(direct0).max()), csA0, 1e-30)
                rel = float(np.abs(banded0 - direct0).max()) / scale
                resid_bad = truth is not None and resid0 > rtol
                if not ok0 or rel > tol or resid_bad:
                    print("[prisim_tpu] banded NUFFT shared-amps "
                          "cross-check FAILED (rel=%.2e > %.0e, ok=%s"
                          "%s); falling back to the direct engine"
                          % (rel, tol, ok0,
                             ", model resid=%.2e > %.0e"
                             % (resid0, rtol) if resid_bad else ""))
                    p2 = dict(parms)
                    p2["processing"] = dict(parms["processing"],
                                            engine="direct")
                    raise _EngineDemotion(p2)
                if verbose:
                    print("[prisim_tpu] banded/direct shared-amps "
                          "cross-check ok (rel=%.2e%s)"
                          % (rel, ", truth amps, model resid=%.2e"
                             % resid0 if truth is not None else ""))
                direct0 = None        # generic gate below is bypassed
                _phase("banded shared-amps gate (compile + run)")
            # dispatch ahead of fetching, but BOUND the in-flight
            # window: every enqueued snapshot allocates its (D_dirs x S)
            # two-float u and (S, r) coefficient buffers at dispatch
            # time. A window of 4 keeps the pipeline full at ~4
            # snapshot-intermediates of peak memory.
            window = max(1, int(parms["processing"].get(
                "nufft_inflight") or 4))
            pend = []
            for t in range(obs.n_acc):
                pend.append(snap_b(jnp.asarray(Mh[t]),
                                   jnp.asarray(Ml[t]),
                                   jnp.asarray(pch[t]),
                                   jnp.asarray(pcl[t])))
                if t >= window:
                    pend[t - window][0].block_until_ready()
            all_ok = bool(np.asarray(jnp.stack(
                [okf for _, okf in pend]).all()))
            snaps = [np.asarray(v) for v, _ in pend] if all_ok else []
            _phase("banded snapshots computed + fetched")
            if not all_ok:
                print("[prisim_tpu] banded NUFFT unit-source check "
                      "failed; "
                      "re-running with the sorted spread")
                p2 = dict(parms)
                p2["processing"] = dict(parms["processing"],
                                        nufft_spread="sorted")
                raise _EngineDemotion(p2)
        else:
            snap = jax.jit(
                lambda mh, ml, ph, pl: simulate_snapshot_nufft_jit(
                    inst, sks, mh, ml, ph, pl, beam_fn, pinvQ, Q,
                    spread=spread))
            snaps = [np.asarray(snap(
                jnp.asarray(Mh[t]), jnp.asarray(Ml[t]),
                jnp.asarray(pch[t]), jnp.asarray(pcl[t])))
                for t in range(obs.n_acc)]
        if parms["processing"].get("nufft_crosscheck", True) \
                and not banded_gated:
            # Automatic accuracy gate: the fast engine's first snapshot
            # is re-evaluated with the exact direct NUDFT; a mismatch
            # beyond tolerance falls the WHOLE run back to the direct
            # engine (approximate-engine results are never silently
            # trusted; cf. the reference's always-exact loop,
            # run_prisim.py:1858-2210). This cross-program comparison
            # carries the ~1e-7/element beam-recompute yardstick term
            # (coherent over sources), so its default stays 1e-4; both
            # banded paths above gate shared-amps at 2e-6 instead.
            tol = float(parms["processing"].get("nufft_crosscheck_tol")
                        or 1e-4)
            dump = os.environ.get("PRISIM_DEBUG_XCHECK_DUMP")
            if dump:
                # Failure-forensics hook: the saved pair + exact engine
                # inputs let a standalone replay (benchmarks/) bisect a
                # gate failure stage by stage. This is how the round-3
                # rank-16-config-default bug was isolated.
                np.savez(dump, fast0=np.asarray(snaps[0]),
                         direct0=direct0, Mh0=np.asarray(Mh[0]),
                         Ml0=np.asarray(Ml[0]), pch0=np.asarray(pch[0]),
                         pcl0=np.asarray(pcl[0]), freqs=freqs,
                         bl=np.asarray(bls.vectors), rank=rank)
            scale = max(float(np.abs(direct0).max()), 1e-30)
            rel = float(np.abs(snaps[0] - direct0).max()) / scale
            if rel > tol:
                print("[prisim_tpu] NUFFT engine cross-check FAILED "
                      "(rel=%.2e > %.0e); falling back to the direct "
                      "engine" % (rel, tol))
                p2 = dict(parms)
                p2["processing"] = dict(parms["processing"],
                                        engine="direct")
                raise _EngineDemotion(p2)
            if verbose:
                print("[prisim_tpu] NUFFT/direct cross-check ok "
                      "(rel=%.2e)" % rel)
        skyvis = np.ascontiguousarray(
            np.transpose(np.stack(snaps), (1, 2, 0)))
        return _finalize_simulation(parms, vs_inputs=dict(
            bls=bls, freqs=freqs, obs=obs, layout=layout,
            telescope=telescope, skyvis=skyvis, gradients=None,
            lat=lat, tp=tp), outdir=outdir, verbose=verbose, save=save,
            t0=t0)
    # Kernel choice (processing.use_pallas: auto|true|false) applies to
    # BOTH the single-device and the sharded paths.
    plain = not grad and sks.src_shape_sigma is None
    use_pallas = _use_pallas(parms)
    if verbose:
        print("[prisim_tpu] engine: direct, %s"
              % ("Pallas kernel" if use_pallas and plain else "XLA"))
    ndev = len(jax.devices())
    # pp.key: 'none' pins the run to one device even on a multi-chip
    # host (debugging / golden comparisons without mocking jax.devices)
    if ndev > 1 and plain and (pp.get("key") or "freq").lower() != "none":
        # multi-chip: the reference's MPI decompositions map onto one
        # jax mesh (SURVEY.md section 2.7; run_prisim.py:1749-2210).
        from .parallel.mesh import (make_mesh, simulate_drift_sharded,
                                    simulate_drift_src_sharded)
        key = (pp.get("key") or "freq").lower()
        axes = pp.get("mesh_axes")
        if key == "src":
            mesh = make_mesh(axis_names=("bl", "chan", "src"),
                             shape=tuple(axes) if axes else (1, 1, ndev))
            out = simulate_drift_src_sharded(inst, sks, obs, beam_fn,
                                             mesh, src_block=src_block,
                                             use_pallas=use_pallas)
        else:
            if axes:
                shape = tuple(axes)
            elif key == "freq":
                shape = (1, ndev)
            else:                                    # 'bl'
                shape = (ndev, 1)
            mesh = make_mesh(axis_names=("bl", "chan"), shape=shape)
            out = simulate_drift_sharded(inst, sks, obs, beam_fn, mesh,
                                         src_block=src_block,
                                         use_pallas=use_pallas)
    _phase("engine dispatched")
    if out is None and grad:
        out = simulate_drift(inst, sks, obs, beam_fn, src_block=src_block,
                             gradient=True, use_pallas=use_pallas)
    elif out is None:
        # ONE jitted executable reused for every chunk of acc_chunk
        # accumulations (processing.acc_chunk; default: all in one);
        # the last chunk is padded to the fixed shape.
        cs = min(int(parms["processing"].get("acc_chunk") or obs.n_acc),
                 obs.n_acc)
        if verbose and cs < obs.n_acc:
            print("[prisim_tpu] scanning %d accumulations in "
                  "chunks of %d" % (obs.n_acc, cs))
        from .engine.observe import simulate_drift_rotations
        from . import twofloat as _tf
        Mh_a, Ml_a = obs.rotations(inst.latitude)
        pch_a, pcl_a = _tf.split_f64(obs.pc_dircos())

        # The sky arrays are jit ARGUMENTS: closing over sks would embed
        # the multi-GB (S, C) flux in the compiled program as a constant.
        def _drift_chunk(seqh, seql, fx, mh, ml, ph, pl_):
            sky_ = SkySources(s_eq_hi=seqh, s_eq_lo=seql, flux=fx,
                              src_shape_sigma=sks.src_shape_sigma)
            return simulate_drift_rotations(
                inst, sky_, mh, ml, ph, pl_, beam_fn=beam_fn,
                src_block=src_block, use_pallas=use_pallas)

        _drift_inner = jax.jit(_drift_chunk)

        def drift_jit(mh, ml, ph, pl_):
            return _drift_inner(sks.s_eq_hi, sks.s_eq_lo, sks.flux,
                                mh, ml, ph, pl_)

        def chunk_args(i0):
            sl_ = slice(i0, i0 + cs)
            mh, ml = Mh_a[sl_], Ml_a[sl_]
            ph, pl_ = pch_a[sl_], pcl_a[sl_]
            if mh.shape[0] < cs:                   # pad last chunk
                rep = cs - mh.shape[0]
                mh = np.concatenate([mh, mh[-1:].repeat(rep, 0)])
                ml = np.concatenate([ml, ml[-1:].repeat(rep, 0)])
                ph = np.concatenate([ph, ph[-1:].repeat(rep, 0)])
                pl_ = np.concatenate([pl_, pl_[-1:].repeat(rep, 0)])
            return mh, ml, ph, pl_

        # pipeline depth 2: dispatch chunk k+1 before fetching chunk k,
        # so the device->host transfer of one chunk overlaps the next
        # chunk's compute (async dispatch)
        starts = list(range(0, obs.n_acc, cs))
        parts = []
        pending = drift_jit(*chunk_args(starts[0]))
        for i0 in starts[1:]:
            nxt = drift_jit(*chunk_args(i0))
            parts.append(np.asarray(pending))
            pending = nxt
        parts.append(np.asarray(pending))
        out = np.concatenate(parts, axis=0)[:obs.n_acc]
    gradients = None
    if grad:
        vis_tbc, grad_tbc = out
        # (T, 3, B, C) -> reference layout (3, nbl, nchan, nacc)
        gradients = {"baseline": np.ascontiguousarray(
            np.transpose(np.asarray(grad_tbc), (1, 2, 3, 0)))}
    else:
        vis_tbc = out
    skyvis = np.ascontiguousarray(
        np.transpose(np.asarray(vis_tbc), (1, 2, 0)))
    _phase("visibilities computed + transferred")
    return _finalize_simulation(parms, vs_inputs=dict(
        bls=bls, freqs=freqs, obs=obs, layout=layout,
        telescope=telescope, skyvis=skyvis, gradients=gradients,
        lat=lat, tp=tp), outdir=outdir, verbose=verbose, save=save,
        t0=t0)


def _finalize_simulation(parms, vs_inputs, outdir, verbose, save, t0):
    """Shared tail of run_simulation: noise, gains, container, phasing,
    projection, optional delay transform, save."""
    bls = vs_inputs["bls"]
    freqs = vs_inputs["freqs"]
    obs = vs_inputs["obs"]
    layout = vs_inputs["layout"]
    telescope = vs_inputs["telescope"]
    skyvis = vs_inputs["skyvis"]
    gradients = vs_inputs["gradients"]
    lat = vs_inputs["lat"]
    tp = vs_inputs["tp"]

    def _fphase(label, _last=[time.time()]):
        now = time.time()
        if verbose:
            print("[prisim_tpu] ... %s (+%.1f s)" % (label,
                                                     now - _last[0]))
        _last[0] = now

    # noise + gains
    tsys = build_tsys(parms, freqs, bls.nbl, obs.n_acc)
    df = float(parms["bandpass"]["freq_resolution"])
    rms = np.asarray(thermal_noise_rms(
        float(tp.get("A_eff") or 154.0), df, float(obs.t_acc[0]),
        tsys, nbl=bls.nbl, nchan=freqs.size, ntimes=obs.n_acc,
        eff_Q=float(tp.get("eff_Q") or 1.0), xp=np))
    import jax
    import jax.random as jr
    chunk = (parms.get("pp") or {}).get("_chunk")
    _fphase("Tsys + radiometer rms")
    # Draw the thermal noise on the HOST CPU backend: threefry2x32 is
    # bit-identical across jax backends, so the values match a device
    # draw while the (B, C, T) cube never pays the device->host
    # transfer.
    try:
        cpu0 = jax.devices("cpu")[0]
    except RuntimeError:
        cpu0 = None
    with jax.default_device(cpu0) if cpu0 is not None \
            else contextlib.nullcontext():
        key = jr.PRNGKey(int(parms["skyparm"].get("seed") or 0))
        if chunk is not None:
            # chunked runs must draw INDEPENDENT noise per chunk while
            # a single-shot run with the same seed stays reproducible
            key = jr.fold_in(key, int(chunk["index"]))
        noise = np.asarray(generate_noise(key, rms))
    _fphase("thermal noise drawn")
    gains = 1.0
    if parms["gains"].get("file"):
        gi = GainInfo.read_hdf5(parms["gains"]["file"])
        gains = gi.eval_gains(bls.labels, freqs=freqs,
                              times=np.asarray(obs.jd) - obs.jd[0],
                              kind=parms["gains"].get("interp") or "cubic",
                              smoothness=parms["gains"].get("smoothness"))
    vis = apply_gains(skyvis, gains, noise)
    _fphase("gains applied")

    bp, bp_wts = _bandpass_weights(parms, bls.nbl, freqs, obs.n_acc)
    vs = VisibilitySet(
        baselines=bls.vectors, labels=bls.labels, freqs=freqs,
        lst=obs.lst_deg, skyvis=skyvis, vis=vis, vis_noise=noise,
        vis_rms=rms, timestamps=obs.jd, t_acc=obs.t_acc,
        bp=bp, bp_wts=bp_wts, Tsys=tsys,
        A_eff=float(tp.get("A_eff") or 154.0),
        eff_Q=float(tp.get("eff_Q") or 1.0),
        latitude=lat, longitude=float(tp.get("longitude") or 0.0),
        altitude=float(tp.get("altitude") or 0.0),
        pointing_center=obs.pointing_altaz, pointing_coords="altaz",
        phase_center=obs.pointing_altaz.copy(),
        phase_center_coords="altaz",
        telescope=telescope,
        layout=dict(positions=np.asarray(layout.positions),
                    labels=np.asarray(layout.labels, dtype=str),
                    ids=np.arange(len(layout.labels)), coords="ENU"),
        flux_unit="Jy", gradients=gradients,
        blgroups=_blgroups_dict(bls))

    ph = parms.get("phasing") or {}
    if ph.get("center") is not None:
        vs = phase_centering(vs, np.atleast_2d(
            np.asarray(ph["center"], dtype=np.float64)),
            ph.get("coords", "altaz"))
    vs = project_baselines(vs)
    _fphase("phased + projected")
    if parms["processing"].get("delay_transform"):
        vs = delay_transform(vs, pad=float(
            parms["processing"].get("f_pad") or 1.0))

    outpath = None
    if save:
        outpath = _save_products(vs, parms, outdir)
        _fphase("products saved")
    if verbose:
        print("[prisim_tpu] done in %.2f s%s"
              % (time.time() - t0,
                 (" -> " + outpath) if outpath else ""))
    return vs, outpath


def _save_products(vs, parms, outdir=None):
    """Output directory tree + products + metadata
    (run_prisim.py:742-783, 2212-2335)."""
    from .io import save_fits, save_hdf5, save_npz
    ds = parms["dirstruct"]
    if outdir is None:
        simid = ds.get("simid") or time.strftime("sim_%Y%m%d_%H%M%S")
        outdir = os.path.join(ds.get("rootdir") or "./",
                              ds.get("project") or "prisim_tpu", simid)
    os.makedirs(os.path.join(outdir, "simdata"), exist_ok=True)
    os.makedirs(os.path.join(outdir, "metainfo"), exist_ok=True)
    base = os.path.join(outdir, "simdata", "simvis")
    fmt = (parms["save_formats"].get("fmt") or "HDF5").lower()
    if fmt == "hdf5":
        save_hdf5(vs, base + ".hdf5")
    elif fmt == "fits":
        # native-schema FITS product (interferometry.py:8393
        # save(fmt='fits'); round 5 closes the last format gap)
        save_fits(vs, base + ".fits")
    if parms["save_formats"].get("npz"):
        save_npz(vs, base + ".npz")
    vs_uv = vs
    wants_uv = bool(parms["save_formats"].get("uvfits")
                    or parms["save_formats"].get("uvh5"))
    if wants_uv and parms.get("save_redundant") and vs.blgroups:
        # expand unique baselines onto the full redundant set for the
        # UVData-format exports (run_prisim.py:2289-2328 duplicates
        # measurements before pyuvdata_write). ONLY when a UV format is
        # actually requested: at HERA-331 scale the expansion is
        # 630 -> 54,615 baselines (~40 GB of arrays) and building it
        # unconditionally cost 10 minutes per north-star run.
        try:
            from .baselines import baseline_generator, uniq_baselines
            import dataclasses
            vecs, pairs = baseline_generator(
                np.asarray(vs.layout["positions"], dtype=np.float64),
                labels=np.asarray(vs.layout["labels"], dtype=str))
            uvec, ind, counts, group_of = uniq_baselines(vecs)
            d = np.linalg.norm(np.asarray(vs.baselines)[:, None, :]
                               - uvec[None, :, :], axis=-1)
            match = d.argmin(axis=1)
            inv = np.full(uvec.shape[0], -1)
            inv[match] = np.arange(match.size)
            expand = inv[group_of]
            if np.all(expand >= 0):
                kw = {n: np.asarray(getattr(vs, n))[expand]
                      for n in ("skyvis", "vis", "vis_noise", "vis_rms",
                                "bp", "bp_wts", "Tsys")
                      if getattr(vs, n) is not None}
                vs_uv = dataclasses.replace(
                    vs, baselines=vecs, labels=pairs,
                    projected_baselines=None, **kw)
                vs_uv = project_baselines(vs_uv)
        except Exception as exc:
            print("[prisim_tpu] save_redundant expansion failed (%s); "
                  "writing unique baselines" % exc)
    # AIPS code for the simulated feed: X -> -5 (XX), Y -> -6 (YY)
    polcode = (-6,) if str((parms.get("beam") or {}).get("pol")
                           or "X").upper() == "Y" else (-5,)
    if parms["save_formats"].get("uvfits"):
        from .io.uvfits import save_uvfits
        save_uvfits(vs_uv, base + ".uvfits", pols=polcode)
    if parms["save_formats"].get("uvh5"):
        from .io.uvh5 import save_uvh5
        save_uvh5(vs_uv, base + ".uvh5", pols=polcode)
    if parms.get("plots"):
        try:
            _save_plots(vs, outdir)
        except Exception as exc:     # diagnostics must never kill a run
            print("[prisim_tpu] plots failed: %s" % exc)
    dump_parms(parms, os.path.join(outdir, "metainfo", "simparms.yaml"))
    meta = {"user": os.environ.get("USER", "unknown"),
            "date": time.strftime("%Y-%m-%dT%H:%M:%S"),
            "prisim_tpu_version": __version__}
    dump_parms(meta, os.path.join(outdir, "metainfo", "meta.yaml"))
    return outdir


def _save_plots(vs, outdir):
    """Diagnostic figures under <outdir>/figures/ (the 'plots' config
    flag, /root/reference/prisim/examples/simparms/defaultparms.yaml:
    1033-1036 — documented but unimplemented in the reference driver):
    amplitude waterfalls for the shortest/median/longest baseline,
    amplitude vs baseline length, and a delay-spectrum waterfall when
    lags are present."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    figdir = os.path.join(outdir, "figures")
    os.makedirs(figdir, exist_ok=True)
    cube = np.asarray(vs.vis if vs.vis is not None else vs.skyvis)
    lens = vs.baseline_lengths
    order = np.argsort(lens)
    picks = [order[0], order[order.size // 2], order[-1]]
    fig, axes = plt.subplots(1, len(picks), figsize=(4 * len(picks), 3),
                             squeeze=False)
    for ax, b in zip(axes[0], picks):
        im = ax.imshow(np.abs(cube[b]).T, aspect="auto", origin="lower",
                       extent=[vs.freqs[0] / 1e6, vs.freqs[-1] / 1e6,
                               0, cube.shape[2]])
        ax.set_title("|V| bl %.1f m" % lens[b])
        ax.set_xlabel("freq [MHz]")
        ax.set_ylabel("accumulation")
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(os.path.join(figdir, "vis_waterfall.png"), dpi=100)
    plt.close(fig)
    fig, ax = plt.subplots(figsize=(5, 3.5))
    ax.semilogy(lens, np.abs(cube).mean(axis=(1, 2)), ".")
    ax.set_xlabel("baseline length [m]")
    ax.set_ylabel("mean |V| [Jy]")
    fig.tight_layout()
    fig.savefig(os.path.join(figdir, "amp_vs_baseline.png"), dpi=100)
    plt.close(fig)
    if vs.lags is not None and vs.skyvis_lag is not None:
        lag = np.asarray(vs.skyvis_lag)
        fig, ax = plt.subplots(figsize=(5, 3.5))
        im = ax.imshow(np.log10(np.abs(lag[:, :, 0]) + 1e-12),
                       aspect="auto", origin="lower",
                       extent=[vs.lags[0] * 1e6, vs.lags[-1] * 1e6,
                               0, lag.shape[0]])
        ax.set_xlabel("delay [us]")
        ax.set_ylabel("baseline index")
        fig.colorbar(im, ax=ax, label="log10 |V(tau)|")
        fig.tight_layout()
        fig.savefig(os.path.join(figdir, "delay_waterfall.png"), dpi=100)
        plt.close(fig)
    return figdir


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(
        description="prisim_tpu simulation driver "
                    "(run_prisim.py equivalent)")
    p.add_argument("-i", "--infile", required=True,
                   help="YAML simulation parameters")
    p.add_argument("-o", "--outdir", default=None)
    p.add_argument("-q", "--quiet", action="store_true")
    args = p.parse_args(argv)
    parms = load_parms(args.infile)
    if int((parms.get("pp") or {}).get("n_chunks") or 1) > 1:
        run_simulation_chunked(parms, outdir=args.outdir,
                               verbose=not args.quiet)
    else:
        run_simulation(parms, outdir=args.outdir,
                       verbose=not args.quiet)




def run_simulation_chunked(parms, outdir=None, verbose=True):
    """Chunked execution with checkpoint/resume.

    The reference writes per-chunk ``simdata/_part_N`` files and
    concatenates on rank 0 (run_prisim.py:1995,2224-2287), which doubles
    as crash recovery. Here: split the accumulation axis (pp.key
    'freq': the channel axis) into pp.n_chunks pieces, simulate each to
    ``simdata/_part_i.hdf5`` — skipping parts that already exist
    (RESUME) — then concatenate, save the final products, and apply
    processing.cleanup (>=1 removes part files;
    defaultparms.yaml:920-933 semantics)."""
    from .io import save_hdf5, load_hdf5
    from .vis import concatenate
    if not isinstance(parms, dict) or "telescope" not in parms:
        parms = load_parms(parms)
    pp = parms.get("pp") or {}
    n_chunks = int(pp.get("n_chunks") or 1)
    if n_chunks <= 1:
        return run_simulation(parms, outdir=outdir, verbose=verbose)
    ds = parms["dirstruct"]
    if outdir is None:
        simid = ds.get("simid") or time.strftime("sim_%Y%m%d_%H%M%S")
        outdir = os.path.join(ds.get("rootdir") or "./",
                              ds.get("project") or "prisim_tpu", simid)
    os.makedirs(os.path.join(outdir, "simdata"), exist_ok=True)
    key = (pp.get("key") or "freq").lower()
    axis = 1 if key == "freq" else 2
    import copy as _copy
    if axis == 1:
        edges = np.linspace(0, int(parms["bandpass"]["nchan"]),
                            n_chunks + 1).astype(int)
    else:
        edges = np.linspace(0, int(parms["obsparm"]["n_acc"]),
                            n_chunks + 1).astype(int)
    parts = []
    for i in range(n_chunks):
        part_path = os.path.join(outdir, "simdata",
                                 "_part_%d.hdf5" % i)
        if os.path.exists(part_path):
            if verbose:
                print("[prisim_tpu] resume: part %d exists, skipping" % i)
            parts.append(part_path)
            continue
        p2 = _copy.deepcopy(parms)
        p2["pp"]["n_chunks"] = 1
        p2["pp"]["_chunk"] = {
            "index": i, "axis": axis,
            "chan0": int(edges[i]) if axis == 1 else 0,
            "nchan_total": int(parms["bandpass"]["nchan"])}
        if axis == 1:
            nchan = int(parms["bandpass"]["nchan"])
            df = float(parms["bandpass"]["freq_resolution"])
            f_center = float(parms["bandpass"]["freq"])
            f_lo = f_center + df * (-nchan / 2)
            nloc = int(edges[i + 1] - edges[i])
            p2["bandpass"]["nchan"] = nloc
            p2["bandpass"]["freq"] = f_lo + df * (edges[i] + nloc / 2)
        else:
            n_acc = int(parms["obsparm"]["n_acc"])
            p2["obsparm"]["n_acc"] = n_acc     # schedule then pick
            p2["snapshot"]["pick"] = list(range(int(edges[i]),
                                                int(edges[i + 1])))
            p2["snapshot"]["all"] = False
        vs_i, _ = run_simulation(p2, verbose=False, save=False)
        save_hdf5(vs_i, part_path)
        parts.append(part_path)
        if verbose:
            print("[prisim_tpu] chunk %d/%d -> %s"
                  % (i + 1, n_chunks, part_path))
    vs = concatenate([load_hdf5(p) for p in parts], axis)
    if parms["processing"].get("delay_transform"):
        # lag-domain products were dropped by concatenate (partial-band
        # spectra are invalid); recompute over the merged band
        vs = delay_transform(vs, pad=float(
            parms["processing"].get("f_pad") or 1.0))
    outpath = _save_products(vs, parms, outdir)
    # record the decomposition (run_prisim.py:1793-1801 chunkinfo.yaml)
    os.makedirs(os.path.join(outpath, "metainfo"), exist_ok=True)
    dump_parms({"key": key, "n_chunks": n_chunks,
                "chunk_edges": [int(e) for e in edges],
                "parts": [os.path.basename(p) for p in parts]},
               os.path.join(outpath, "metainfo", "chunkinfo.yaml"))
    cleanup = int(parms["processing"].get("cleanup") or 0)
    if cleanup >= 1:
        for p in parts:
            os.remove(p)
    return vs, outpath


if __name__ == "__main__":
    main()
