"""Native HDF5 persistence for VisibilitySet, reference-schema compatible.

Mirrors the reference's ``InterferometerArray.save(fmt='hdf5')``
(/root/reference/prisim/interferometry.py:8717-8852) group layout —
header / telescope_parms / spectral_info / antenna_element / layout /
timing / skyparms / array / instrument / visibilities{freq_spectrum,
delay_spectrum} / gradients / blgroupinfo — so files written by either
implementation round-trip through the other's reader
(``__init__(init_file=...)``, :5140)."""

from __future__ import annotations

import numpy as np

from ..utils import require_h5py

from .. import __version__
from ..vis import VisibilitySet

__all__ = ["save_hdf5", "load_hdf5", "save_npz", "load_npz"]


def _enc_labels(labels):
    labels = np.asarray(labels, dtype=str)
    maxlen = max(1, int(max(len(s) for s in labels.ravel())))
    dt = [("A2", "S%d" % maxlen), ("A1", "S%d" % maxlen)]
    out = np.empty(labels.shape[0], dtype=dt)
    out["A2"] = np.char.encode(labels[:, 0])
    out["A1"] = np.char.encode(labels[:, 1])
    return out


def _dec_labels(structured):
    a2 = np.char.decode(structured["A2"].astype("S"))
    a1 = np.char.decode(structured["A1"].astype("S"))
    return np.stack([a2, a1], axis=-1)


def save_hdf5(vs, path, overwrite=True):
    """Write a VisibilitySet in the reference HDF5 schema."""
    h5py = require_h5py()
    with h5py.File(path, "w" if overwrite else "w-") as f:
        hdr = f.create_group("header")
        hdr["PRISim#"] = "prisim_tpu-" + __version__
        hdr["flux_unit"] = vs.flux_unit
        tel = f.create_group("telescope_parms")
        tel["latitude"] = vs.latitude
        tel["longitude"] = vs.longitude
        tel["altitude"] = vs.altitude
        tel["latitude"].attrs["units"] = "deg"
        if "id" in vs.telescope:
            tel["id"] = vs.telescope["id"]
        spec = f.create_group("spectral_info")
        spec["freq_resolution"] = vs.freq_resolution
        spec["freqs"] = np.asarray(vs.freqs)
        spec["freqs"].attrs["units"] = "Hz"
        if vs.lags is not None:
            spec["lags"] = np.asarray(vs.lags)
        bp, bp_wts = vs.default_bp()
        spec["bp"] = bp
        spec["bp_wts"] = bp_wts
        ant = f.create_group("antenna_element")
        for k in ("shape", "size", "ocoords", "orientation",
                  "groundplane"):
            if vs.telescope.get(k) is not None:
                ant[k] = vs.telescope[k]
        if vs.layout:
            lay = f.create_group("layout")
            lay["positions"] = np.asarray(vs.layout["positions"],
                                          dtype=np.float64)
            lay["positions"].attrs["coords"] = vs.layout.get("coords",
                                                             "ENU")
            lay["labels"] = np.char.encode(
                np.asarray(vs.layout["labels"], dtype=str))
            lay["ids"] = np.asarray(vs.layout.get(
                "ids", np.arange(len(vs.layout["labels"]))))
        tim = f.create_group("timing")
        if vs.t_acc is not None:
            tim["t_acc"] = np.asarray(vs.t_acc)
            tim["t_obs"] = float(np.sum(vs.t_acc))
        tim["n_acc"] = vs.n_acc
        if vs.timestamps is not None:
            tim["timestamps"] = np.asarray(vs.timestamps)
        sky = f.create_group("skyparms")
        sky["pointing_coords"] = vs.pointing_coords
        sky["phase_center_coords"] = vs.phase_center_coords
        sky["LST"] = np.asarray(vs.lst).ravel()
        sky["LST"].attrs["units"] = "deg"
        if vs.pointing_center is not None:
            sky["pointing_center"] = np.asarray(vs.pointing_center)
        if vs.phase_center is not None:
            sky["phase_center"] = np.asarray(vs.phase_center)
        arr = f.create_group("array")
        arr["labels"] = _enc_labels(vs.labels)
        arr["baselines"] = np.asarray(vs.baselines)
        arr["baselines"].attrs["coords"] = "local-ENU"
        arr["baselines"].attrs["units"] = "m"
        if vs.projected_baselines is not None:
            arr["projected_baselines"] = np.asarray(
                vs.projected_baselines)
        ins = f.create_group("instrument")
        ins["effective_area"] = np.asarray(vs.A_eff)
        ins["efficiency"] = np.asarray(vs.eff_Q)
        if vs.Tsys is not None:
            ins["Tsys"] = np.asarray(vs.Tsys)
            ins["Tsys"].attrs["units"] = "K"
        vgrp = f.create_group("visibilities")
        fgrp = vgrp.create_group("freq_spectrum")
        for key, val in (("rms", vs.vis_rms), ("vis", vs.vis),
                         ("skyvis", vs.skyvis), ("noise", vs.vis_noise)):
            if val is not None:
                fgrp[key] = np.asarray(val)
                fgrp[key].attrs["units"] = "Jy"
        lgrp = vgrp.create_group("delay_spectrum")
        for key, val in (("vis", vs.vis_lag), ("skyvis", vs.skyvis_lag),
                         ("noise", vs.vis_noise_lag),
                         ("lag_kernel", vs.lag_kernel)):
            if val is not None:
                lgrp[key] = np.asarray(val)
                lgrp[key].attrs["units"] = "Jy Hz"
        if vs.gradients:
            ggrp = f.create_group("gradients")
            for k, v in vs.gradients.items():
                ggrp[k] = np.asarray(v)
        if vs.blgroups is not None:
            bgrp = f.create_group("blgroupinfo").create_group("groups")
            for k, v in vs.blgroups.items():
                bgrp[str(k)] = np.asarray(v, dtype="S")


def _get(f, key, default=None):
    node = f
    for part in key.split("/"):
        if part not in node:
            return default
        node = node[part]
    val = node[()]
    if isinstance(val, bytes):
        return val.decode()
    return val


def load_hdf5(path):
    """Read a reference-schema HDF5 sim back into a VisibilitySet
    (counterpart of InterferometerArray.__init__(init_file=...),
    /root/reference/prisim/interferometry.py:5140)."""
    h5py = require_h5py()
    with h5py.File(path, "r") as f:
        labels = _dec_labels(f["array/labels"][()])
        layout = None
        if "layout" in f:
            layout = dict(
                positions=f["layout/positions"][()],
                labels=np.char.decode(f["layout/labels"][()].astype("S")),
                ids=f["layout/ids"][()],
                coords=f["layout/positions"].attrs.get("coords", "ENU"))
            if isinstance(layout["coords"], bytes):
                layout["coords"] = layout["coords"].decode()
        telescope = {}
        if "antenna_element" in f:
            for k in f["antenna_element"]:
                telescope[k] = _get(f, "antenna_element/" + k)
        if _get(f, "telescope_parms/id") is not None:
            telescope["id"] = _get(f, "telescope_parms/id")
        grads = None
        if "gradients" in f:
            grads = {k: f["gradients"][k][()] for k in f["gradients"]}
        blgroups = None
        if "blgroupinfo" in f and "groups" in f["blgroupinfo"]:
            blgroups = {k: f["blgroupinfo/groups"][k][()].astype(str)
                        for k in f["blgroupinfo/groups"]}
        vs = VisibilitySet(
            baselines=f["array/baselines"][()],
            labels=labels,
            freqs=f["spectral_info/freqs"][()],
            lst=f["skyparms/LST"][()],
            skyvis=_get(f, "visibilities/freq_spectrum/skyvis"),
            vis=_get(f, "visibilities/freq_spectrum/vis"),
            vis_noise=_get(f, "visibilities/freq_spectrum/noise"),
            vis_rms=_get(f, "visibilities/freq_spectrum/rms"),
            timestamps=_get(f, "timing/timestamps"),
            t_acc=_get(f, "timing/t_acc"),
            bp=_get(f, "spectral_info/bp"),
            bp_wts=_get(f, "spectral_info/bp_wts"),
            Tsys=_get(f, "instrument/Tsys"),
            A_eff=_get(f, "instrument/effective_area", 154.0),
            eff_Q=_get(f, "instrument/efficiency", 1.0),
            latitude=float(_get(f, "telescope_parms/latitude", 0.0)),
            longitude=float(_get(f, "telescope_parms/longitude", 0.0)),
            altitude=float(_get(f, "telescope_parms/altitude", 0.0)),
            pointing_center=_get(f, "skyparms/pointing_center"),
            pointing_coords=_get(f, "skyparms/pointing_coords", "altaz"),
            phase_center=_get(f, "skyparms/phase_center"),
            phase_center_coords=_get(f, "skyparms/phase_center_coords",
                                     "altaz"),
            projected_baselines=_get(f, "array/projected_baselines"),
            telescope=telescope,
            layout=layout,
            flux_unit=_get(f, "header/flux_unit", "Jy"),
            lags=_get(f, "spectral_info/lags"),
            vis_lag=_get(f, "visibilities/delay_spectrum/vis"),
            skyvis_lag=_get(f, "visibilities/delay_spectrum/skyvis"),
            vis_noise_lag=_get(f, "visibilities/delay_spectrum/noise"),
            lag_kernel=_get(f, "visibilities/delay_spectrum/lag_kernel"),
            gradients=grads,
            blgroups=blgroups,
        )
    return vs


def save_npz(vs, path):
    """Compressed NPZ export (reference save(npz=True),
    /root/reference/prisim/interferometry.py:8858-8864)."""
    kw = dict(skyvis_freq=vs.skyvis, lst=vs.lst, freq=vs.freqs,
              bl=vs.baselines, bl_length=vs.baseline_lengths)
    if vs.timestamps is not None:
        kw["timestamp"] = vs.timestamps
    if vs.vis is not None and vs.vis_noise is not None:
        kw["vis_freq"] = vs.vis
        kw["vis_noise_freq"] = vs.vis_noise
    np.savez_compressed(path, **kw)


def load_npz(path):
    """Read an NPZ export back into a (minimal) VisibilitySet."""
    with np.load(path, allow_pickle=False) as d:
        nbl = d["bl"].shape[0]
        labels = np.stack([np.asarray([str(i) for i in range(nbl)])] * 2,
                          axis=-1)
        return VisibilitySet(
            baselines=d["bl"], labels=labels, freqs=d["freq"],
            lst=d["lst"],
            skyvis=d["skyvis_freq"] if "skyvis_freq" in d else None,
            vis=d["vis_freq"] if "vis_freq" in d else None,
            vis_noise=(d["vis_noise_freq"]
                       if "vis_noise_freq" in d else None),
            timestamps=d["timestamp"] if "timestamp" in d else None)
