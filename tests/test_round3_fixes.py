"""Round-3 correctness fixes: FITS external beams, Y-pol default
orientation, scalar flux-offset parity, negative LST covariance shifts,
NUFFT chan-shard edge padding."""

import numpy as np
import pytest

from prisim_tpu.config import load_parms
from prisim_tpu.driver import run_simulation


def _base_parms(extra=None):
    p = {
        "dirstruct": {"rootdir": "/tmp", "project": "round3_test"},
        "telescope": {"id": "custom", "latitude": -30.72,
                      "A_eff": 154.0, "Trx": 100.0},
        "array": {"layout": "HERA-7", "redundant": False},
        "antenna": {"shape": "dish", "size": 14.0},
        "bandpass": {"freq": 150e6, "freq_resolution": 781250.0,
                     "nchan": 8},
        "obsparm": {"obs_mode": "drift", "n_acc": 1, "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": 8},
        "save_formats": {"fmt": "HDF5", "npz": False},
    }
    for k, v in (extra or {}).items():
        p.setdefault(k, {})
        p[k] = {**p[k], **v} if isinstance(v, dict) else v
    return load_parms(p)


def _write_beam_maps(nside):
    from prisim_tpu import healpix as hp
    npix = hp.nside2npix(nside)
    t, _ = hp.pix2ang(nside, np.arange(npix))
    cz = np.clip(np.cos(t), 0.0, None)
    return np.stack([cz ** 2, cz ** 4], axis=-1)  # (npix, 2)


def test_external_beam_from_fits_roundtrip(tmp_path):
    """ExternalBeam.from_fits reads maps written by io.fitsio (the
    driver's FITS external-beam entry, previously dead code that
    crashed on import: beams/external.py)."""
    from prisim_tpu.io import fitsio as fio
    from prisim_tpu.beams.external import ExternalBeam
    maps = _write_beam_maps(16)
    freqs = np.asarray([150e6, 160e6])
    path = str(tmp_path / "beam.fits")
    with open(path, "wb") as fh:
        fio.write_image(fh, maps, primary=True)
        fio.write_image(fh, freqs, extname="FREQS")
    ext = ExternalBeam.from_fits(path)
    assert ext.maps.shape == maps.shape
    np.testing.assert_allclose(ext.freqs, freqs)
    altaz = np.asarray([[90.0, 0.0], [60.0, 45.0]])
    pb = ext.evaluate(altaz, np.asarray([150e6, 155e6, 160e6]))
    assert pb.shape == (2, 3)
    assert np.isfinite(pb).all()
    assert (pb[0] > 0.98).all()            # ~unit peak at zenith
    assert (pb[1] < pb[0]).all()           # falls off at 60 deg alt


def test_external_beam_fits_vs_hdf5_driver(tmp_path):
    """Driver runs with a .fits beam file and matches the identical
    beam delivered as HDF5 (driver.py external-beam dispatch)."""
    import h5py
    maps = _write_beam_maps(16)
    freqs = np.asarray([150e6, 160e6])
    from prisim_tpu.io import fitsio as fio
    fpath = str(tmp_path / "beam.fits")
    with open(fpath, "wb") as fh:
        fio.write_image(fh, maps, primary=True)
        fio.write_image(fh, freqs, extname="FREQS")
    hpath = str(tmp_path / "beam.hdf5")
    with h5py.File(hpath, "w") as f:
        f["beam"] = maps
        f["freqs"] = freqs
    vs_f, _ = run_simulation(_base_parms(
        {"beam": {"use_external": True, "file": fpath},
         "bandpass": {"nchan": 4, "freq": 155e6}}),
        verbose=False, save=False)
    vs_h, _ = run_simulation(_base_parms(
        {"beam": {"use_external": True, "file": hpath},
         "bandpass": {"nchan": 4, "freq": 155e6}}),
        verbose=False, save=False)
    np.testing.assert_allclose(vs_f.skyvis, vs_h.skyvis, rtol=1e-6)
    assert np.abs(vs_f.skyvis).max() > 0


def test_ypol_differs_without_explicit_orientation():
    """A Y-feed dipole with the DEFAULT (absent) orientation must still
    be the X beam rotated 90 deg in azimuth (beams/dispatch.py): dual-pol
    products were silently duplicating XX as YY."""
    from prisim_tpu.beams.dispatch import primary_beam
    # off-zenith, off-axis direction so the dipole pattern is
    # orientation-sensitive
    dc = np.asarray([[0.6, 0.1, np.sqrt(1 - 0.36 - 0.01)],
                     [0.1, 0.6, np.sqrt(1 - 0.01 - 0.36)]])
    freqs = np.asarray([150e6])
    tel = {"shape": "dipole", "size": 0.74}
    pbx = np.asarray(primary_beam(dc, freqs, tel, pol="X"))
    pby = np.asarray(primary_beam(dc, freqs, tel, pol="Y"))
    assert not np.allclose(pbx, pby)
    # the 90-deg rotation swaps the two mirrored directions
    np.testing.assert_allclose(pby[0], pbx[1], rtol=1e-5)
    # explicit default orientation matches the implicit default
    pby2 = np.asarray(primary_beam(
        dc, freqs, dict(tel, orientation_dircos=(1.0, 0.0, 0.0)),
        pol="Y"))
    np.testing.assert_allclose(pby, pby2, rtol=1e-6)


def test_scalar_flux_offset_host_device_parity():
    """SkyModel.generate_spectrum applies SCALAR flux-offsets the same
    way the on-device power-law path does (skymodel.py vs
    engine/observe.py SkySources.from_skymodel)."""
    from prisim_tpu.skymodel import SkyModel
    from prisim_tpu.engine import SkySources
    freqs = 100e6 + 1e6 * np.arange(8)
    sm = SkyModel(location=np.asarray([[10.0, -30.0], [20.0, -40.0]]),
                  spec_kind="power-law",
                  spec_parms={"flux-scale": np.asarray([4.0, 8.0]),
                              "freq-ref": np.full(2, 150e6),
                              "power-law-index": np.full(2, -0.8),
                              "flux-offset": 1.5})
    host = sm.generate_spectrum(freqs)
    np.testing.assert_allclose(
        host, 1.5 + np.asarray([4.0, 8.0])[:, None]
        * (freqs[None, :] / 150e6) ** -0.8, rtol=1e-12)
    dev = np.asarray(SkySources.from_skymodel(sm, freqs).flux)
    np.testing.assert_allclose(dev, host, rtol=1e-5)


def test_xcpdps_negative_lst_shift_masks_wraparound():
    """xcpdps_full with a NEGATIVE lst shift NaN-masks the trailing
    wrapped samples (analysis/bispectrum.py); previously they entered
    the cross power as valid data."""
    from prisim_tpu.analysis.bispectrum import cpds_ft, xcpdps_full
    rng = np.random.default_rng(3)
    nlst, ndays, ntri, nchan = 6, 2, 3, 32
    eicp = np.exp(1j * rng.uniform(-np.pi, np.pi,
                                   (nlst, ndays, ntri, nchan)))
    wts = np.ones(eicp.shape)
    freqs = 150e6 + 100e3 * np.arange(nchan)
    ft = cpds_ft(eicp, wts, freqs, freq_center=[152e6], bw_eff=2e6,
                 pad=1.0)
    r = xcpdps_full(ft, cohax=(2,), incohax=(1,),
                    lst_shifts=np.asarray([1, -1]))
    P = r["P"]
    # axesmap: lst pair occupies two axes (shift axis + nlst axis)
    ax_shift, ax_lst = r["axesmap"][1]
    Pm = np.moveaxis(P, (ax_shift, ax_lst), (0, 1))
    n_nan_pos = np.isnan(Pm[0].real).sum()
    n_nan_neg = np.isnan(Pm[1].real).sum()
    assert n_nan_pos > 0
    assert n_nan_neg == n_nan_pos          # mirror masking
    # +1 masks the FIRST lst sample, -1 the LAST
    assert np.isnan(Pm[0, 0].real).all()
    assert not np.isnan(Pm[0, -1].real).any()
    assert np.isnan(Pm[1, -1].real).all()
    assert not np.isnan(Pm[1, 0].real).any()


def test_nufft_sharded_nondivisible_channels():
    """simulate_drift_nufft_sharded with nchan not divisible by the
    chan-mesh size: padded channels are edge-replicated so the last
    shard's spectral fit stays clean (parallel/mesh.py)."""
    import jax
    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device (CPU) mesh")
    from prisim_tpu import layouts as lay, baselines as bl
    from prisim_tpu import twofloat as tf
    from prisim_tpu.skymodel import SkyModel
    from prisim_tpu.engine import (Instrument, SkySources,
                                   enu_rotation_from_eq)
    from prisim_tpu.engine.nufft_delay import (chebyshev_projection,
                                               simulate_snapshot_nufft_jit)
    from prisim_tpu.parallel.mesh import (make_mesh,
                                          simulate_drift_nufft_sharded)
    import jax.numpy as jnp

    nchan = 30                               # NOT divisible by 2
    freqs = 150e6 + 100e3 * np.arange(nchan)
    layout = lay.preset_layout("HERA-7")
    bset = bl.build_baselines(layout, redundant=False)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    rng = np.random.default_rng(5)
    nsrc = 64
    loc = np.stack([rng.uniform(0, 360, nsrc),
                    rng.uniform(-60, 0, nsrc)], axis=-1)
    model = SkyModel(location=loc, spec_kind="power-law", spec_parms={
        "flux-scale": rng.uniform(0.5, 2.0, nsrc),
        "freq-ref": np.full(nsrc, 150e6),
        "power-law-index": np.full(nsrc, -0.8)})
    sky = SkySources.from_skymodel(model, freqs)

    class Obs:
        n_acc = 1

        def rotations(self, lat):
            M = enu_rotation_from_eq(30.0, lat)
            Mh, Ml = tf.split_f64(M)
            return Mh[None], Ml[None]

        def pc_dircos(self):
            return np.asarray([[0.0, 0.0, 1.0]])

    obs = Obs()
    beam_fn = lambda s, f: jnp.ones((s.shape[0], f.shape[0]),
                                    jnp.float32)
    mesh = make_mesh(axis_names=("bl", "chan"), shape=(1, 2),
                     devices=jax.devices()[:2])
    vis = np.asarray(simulate_drift_nufft_sharded(
        inst, sky, obs, beam_fn, mesh, rank=8))
    assert vis.shape == (1, bset.nbl, nchan)
    # golden: single-device jit path
    pinvQ, Q = chebyshev_projection(freqs, 8)
    Mh, Ml = obs.rotations(inst.latitude)
    pch, pcl = tf.split_f64(obs.pc_dircos())
    gold = np.asarray(simulate_snapshot_nufft_jit(
        inst, sky, jnp.asarray(Mh[0]), jnp.asarray(Ml[0]),
        jnp.asarray(pch[0]), jnp.asarray(pcl[0]), beam_fn, pinvQ, Q))
    scale = np.abs(gold).max()
    assert np.abs(vis[0] - gold).max() / scale < 2e-4


def test_external_beam_device_evaluate_matches_host():
    # the driver's jit beam path (channel_table + interp_weights +
    # device_evaluate) must reproduce the host evaluate() reference
    import jax.numpy as jnp
    from prisim_tpu import healpix as hp
    from prisim_tpu.beams.external import ExternalBeam

    nside = 16
    theta, _ = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    bfreqs = np.array([150e6, 155e6, 160e6])
    maps = np.stack([np.exp(-(theta / (0.4 * 150e6 / f)) ** 2)
                     for f in bfreqs], axis=1)
    ext = ExternalBeam(maps, bfreqs)
    rng = np.random.default_rng(0)
    altaz = np.stack([rng.uniform(5, 90, 200),
                      rng.uniform(0, 360, 200)], -1)
    chans = 150e6 + 195312.5 * np.arange(8)
    host = ext.evaluate(altaz, chans, chromatic=True)
    table = jnp.asarray(ext.channel_table(chans, chromatic=True))
    pix, wgt = ext.interp_weights(altaz)
    dev = np.asarray(ExternalBeam.device_evaluate(
        table, jnp.asarray(pix), jnp.asarray(wgt)))
    assert np.abs(dev - host).max() / np.abs(host).max() < 2e-5


def _write_feko_file(path, freqs_mhz, ntheta=19, nphi=13, sigma=25.0):
    """Synthetic FEKO far-field export: per-frequency blocks, regular
    (theta, phi) grid, gaussian beam in dB whose width shrinks with
    frequency (chromatic)."""
    th = np.linspace(0.0, 90.0, ntheta)
    ph = np.linspace(0.0, 360.0, nphi)
    with open(path, "w") as f:
        for fm in freqs_mhz:
            f.write(f"#Frequency: {fm * 1e6:.1f}\n")
            f.write(f'"" Theta Samples: {ntheta}\n')
            f.write(f'"" Phi Samples: {nphi}\n')
            sig = sigma * 150.0 / fm
            for p in ph:
                for t in th:
                    g_db = -10.0 * (t / sig) ** 2
                    f.write(f"{t:.4f} {p:.4f} 0.0 0.0 {g_db:.6f}\n")


def test_feko_converter_chromatic_spline(tmp_path):
    import h5py
    from prisim_tpu.tools import feko_to_healpix
    from prisim_tpu.beams.external import ExternalBeam
    from prisim_tpu import healpix as hp
    infile = str(tmp_path / "beam.ffe")
    out = str(tmp_path / "beam.hdf5")
    _write_feko_file(infile, [140.0, 150.0, 160.0])
    maps = feko_to_healpix(infile, out, nside=16, interp="spline")
    assert maps.shape == (hp.nside2npix(16), 3)
    with h5py.File(out, "r") as f:
        assert f["beam"].shape == maps.shape
        np.testing.assert_allclose(np.asarray(f["freqs"]),
                                   [140e6, 150e6, 160e6])
    # spline map matches the analytic gaussian away from boundaries
    t, _ = hp.pix2ang(16, np.arange(hp.nside2npix(16)))
    up = np.degrees(t) < 60.0
    for i, fm in enumerate([140.0, 150.0, 160.0]):
        sig = 25.0 * 150.0 / fm
        expect = 10.0 ** (-(np.degrees(t[up]) / sig) ** 2)
        expect /= expect.max()   # converter normalizes at pixel centers
        np.testing.assert_allclose(maps[up, i], expect, atol=5e-3)
    # chromatic: higher frequency -> narrower beam
    mid = (np.degrees(t) > 20) & (np.degrees(t) < 40)
    assert maps[mid, 2].mean() < maps[mid, 0].mean()
    # consumable by ExternalBeam and the driver
    eb = ExternalBeam.from_hdf5(out)
    bp = eb.evaluate(np.stack([90.0 - np.degrees(t[:8]),
                               np.zeros(8)], -1),
                     np.asarray([145e6, 155e6]))
    assert bp.shape == (8, 2) and np.isfinite(bp).all()


def test_feko_converter_healpix_and_generic(tmp_path):
    from prisim_tpu.tools import feko_to_healpix
    from prisim_tpu import healpix as hp
    infile = str(tmp_path / "beam.ffe")
    _write_feko_file(infile, [150.0], ntheta=46, nphi=25)
    out = str(tmp_path / "b2.hdf5")
    maps = feko_to_healpix(infile, out, nside=8, interp="healpix")
    t, _ = hp.pix2ang(8, np.arange(hp.nside2npix(8)))
    up = np.degrees(t) < 60.0
    expect = 10.0 ** (-(np.degrees(t[up]) / 25.0) ** 2)
    np.testing.assert_allclose(maps[up, 0], expect, atol=0.15)
    # generic table fallback (no FEKO headers): Re/Im field columns
    gen = str(tmp_path / "plain.txt")
    rng = np.random.default_rng(0)
    with open(gen, "w") as f:
        for _ in range(4000):
            th = rng.uniform(0, np.pi / 2)
            phi = rng.uniform(0, 2 * np.pi)
            e = np.exp(-(np.degrees(th) / 25.0) ** 2 / 2)
            f.write(f"{np.degrees(th):.4f} {np.degrees(phi):.4f} "
                    f"{e:.6f} 0.0 0.0 0.0\n")
    out2 = str(tmp_path / "b3.hdf5")
    maps2 = feko_to_healpix(gen, out2, nside=8)
    assert maps2.shape == (hp.nside2npix(8), 1)
    assert abs(maps2.max() - 1.0) < 1e-12


def test_feko_beam_drives_simulation(tmp_path):
    from prisim_tpu.tools import feko_to_healpix
    infile = str(tmp_path / "beam.ffe")
    out = str(tmp_path / "beam.hdf5")
    _write_feko_file(infile, [145.0, 155.0])
    feko_to_healpix(infile, out, nside=16, interp="spline")
    p = _base_parms({"beam": {"use_external": True, "file": out,
                              "chromatic": True}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    assert np.isfinite(vs.skyvis).all()
    assert np.abs(vs.skyvis).max() > 0


def test_mesh_bench_weak_scaling():
    """tools mesh-check --bench: fixed per-device work across mesh
    sizes, per-device rates + efficiency reported."""
    from prisim_tpu.tools import mesh_bench
    rows = mesh_bench(n_devices=2, per_bl=4, nchan=8, nside=4,
                      repeats=1)
    assert [r["devices"] for r in rows] == [1, 2]
    for r in rows:
        assert r["nbl"] == 4 * r["devices"]
        assert r["gmacs_per_device"] >= 0
        assert "weak_scaling_efficiency" in r
    assert rows[0]["weak_scaling_efficiency"] == 1.0


def test_nufft_rank_defaults_to_bandwidth_aware_auto():
    """processing.nufft_rank must default to None (auto): a hard
    default of 16 silently overrode the driver's bandwidth-aware rank
    and put an 8.4e-4 coherent octave-band fit error in every banded
    north-star run (root-caused round 3 via the crosscheck dump)."""
    from prisim_tpu.config import load_parms
    p = load_parms({"bandpass": {"nchan": 8, "freq": 150e6}})
    assert p["processing"]["nufft_rank"] is None
