"""Aux components: antenna_power, aperture synthesis uvw, PFB shape,
snapshot selection, pointing file, sky sectors."""

import numpy as np
import pytest

from prisim_tpu.engine.power import antenna_power
from prisim_tpu.aperture_synthesis import gen_uvw, reorder_uvw, uvw_grid
from prisim_tpu.skymodel import SkyModel
from prisim_tpu.windows import pfb_shape
from prisim_tpu.config import load_parms
from prisim_tpu.driver import build_schedule, run_simulation
from prisim_tpu import constants as CNST


def test_antenna_power_uniform_beam_equals_mean_flux():
    import jax.numpy as jnp
    sm = SkyModel(location=np.asarray([[10.0, -30.0], [200.0, -31.0]]),
                  spec_kind="power-law",
                  spec_parms={"flux-scale": np.asarray([4.0, 8.0]),
                              "freq-ref": np.full(2, 150e6),
                              "power-law-index": np.zeros(2)})
    freqs = np.asarray([150e6, 160e6])
    beam = lambda d, f: jnp.ones((d.shape[0], f.shape[0]), jnp.float32)
    # at lst=10 only the first source (ra=10) is near zenith; the second
    # (ra=200) is below the horizon at lat=-30.7
    p = antenna_power(sm, freqs, [10.0], -30.7, beam)
    np.testing.assert_allclose(p[0], 4.0, rtol=1e-6)
    # lst=205: both? source1 at ha=195 -> below horizon; source2 visible
    p2 = antenna_power(sm, freqs, [200.0], -30.7, beam)
    np.testing.assert_allclose(p2[0], 8.0, rtol=1e-6)


def test_gen_uvw_zenith():
    bl = np.asarray([[100.0, 0.0, 0.0], [0.0, 50.0, 0.0]])
    lat = -30.7
    # phase center at zenith: hadec = (0, lat)
    uvw = gen_uvw(bl, lat, [10.0], np.asarray([[0.0, lat]]), "hadec")
    assert uvw.shape == (2, 3, 1)
    # East baseline at zenith phase center: u = |b|, w = 0
    np.testing.assert_allclose(uvw[0, :, 0], [100.0, 0.0, 0.0],
                               atol=1e-9)
    np.testing.assert_allclose(uvw[1, :, 0], [0.0, 50.0, 0.0],
                               atol=1e-9)


def test_gen_uvw_wavelengths_and_grid():
    bl = np.asarray([[100.0, 0.0, 0.0]])
    freqs = np.asarray([150e6, 300e6])
    uvw_m, uvw_l = gen_uvw(bl, -30.7, [0.0],
                           np.asarray([[0.0, -30.7]]), "hadec",
                           freqs=freqs)
    wl = CNST.c / freqs
    np.testing.assert_allclose(uvw_l[0, 0, :, 0], 100.0 / wl, rtol=1e-12)
    flat = reorder_uvw(uvw_l)
    assert flat.shape == (3, 2)
    grid = uvw_grid(uvw_l, spacing=0.5, pow2=True)
    assert all(np.log2(len(grid[k])) % 1 == 0 for k in "uvw")


def test_pfb_shape_properties():
    s = pfb_shape(128, 16)
    assert s.shape == (128,)
    assert s.max() == 1.0
    # periodic over coarse channels
    np.testing.assert_allclose(s[:16], s[16:32], rtol=1e-12)
    # scalloped: edges lower than centers
    assert s[0] < s[8]


def _base_parms(extra=None):
    d = {"bandpass": {"nchan": 8, "freq": 155e6,
                      "freq_resolution": 195312.5},
         "array": {"layout": "HERA-7"},
         "obsparm": {"n_acc": 4, "t_acc": 60.0},
         "skyparm": {"model": "random", "nsrc": 16, "seed": 2}}
    if extra:
        for k, v in extra.items():
            d.setdefault(k, {}).update(v)
    return load_parms(d)


def test_snapshot_pick_and_range():
    p = _base_parms({"snapshot": {"pick": [0, 2], "all": False}})
    obs = build_schedule(p, -30.7)
    assert obs.n_acc == 2
    p = _base_parms({"snapshot": {"range": [1, 4], "all": False}})
    obs = build_schedule(p, -30.7)
    assert obs.n_acc == 3


def test_snapshot_avg_drifts():
    p = _base_parms({"snapshot": {"avg_drifts": True}})
    obs = build_schedule(p, -30.7)
    assert obs.n_acc == 1
    np.testing.assert_allclose(obs.t_acc[0], 240.0)


def test_pointing_file(tmp_path):
    pf = str(tmp_path / "pointing.txt")
    np.savetxt(pf, np.asarray([[10.0, 90.0, 270.0],
                               [11.0, 85.0, 90.0]]))
    p = _base_parms({"pointing": {"file": pf}})
    obs = build_schedule(p, -30.7)
    assert obs.n_acc == 2
    np.testing.assert_allclose(obs.lst_deg, [10.0, 11.0])
    np.testing.assert_allclose(obs.pointing_altaz[1], [85.0, 90.0])


def test_sky_sectors(tmp_path):
    p = _base_parms({"processing": {"n_sky_sectors": 2},
                     "skyparm": {"nsrc": 64}})
    outs, _ = run_simulation(p, verbose=False, save=False)
    assert isinstance(outs, list) and len(outs) == 2
    present = [o for o in outs if o is not None]
    assert len(present) >= 1
    # sector sims are over the same baseline set
    p1 = _base_parms()
    full, _ = run_simulation(p1, verbose=False, save=False)
    for o in present:
        assert o.skyvis.shape == full.skyvis.shape


def test_pfb_bandpass_in_driver():
    p = _base_parms({"bandpass": {"pfb_method": "analytic", "nchan": 32},
                     "processing": {"bp_correct": False,
                                    "coarse_channel_width": 16}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    bp1 = np.asarray(vs.bp)[0, :, 0]
    assert bp1.max() == 1.0 and bp1.min() < 0.9


def test_external_beam_driver(tmp_path):
    import h5py
    from prisim_tpu import healpix as hp
    # chromatic HEALPix beam: cos^2 at 150 MHz, cos^4 at 160 MHz
    nside = 16
    npix = hp.nside2npix(nside)
    t, _ = hp.pix2ang(nside, np.arange(npix))
    cz = np.clip(np.cos(t), 0.0, None)
    maps = np.stack([cz ** 2, cz ** 4], axis=-1)
    bf = str(tmp_path / "beam.hdf5")
    with h5py.File(bf, "w") as f:
        f["beam"] = maps
        f["freqs"] = np.asarray([150e6, 160e6])
    p = _base_parms({"beam": {"use_external": True, "file": bf},
                     "bandpass": {"nchan": 8, "freq": 155e6}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    assert vs.skyvis.shape[0] == 9
    assert np.isfinite(vs.skyvis).all()
    assert np.abs(vs.skyvis).max() > 0
    # external beam result differs from the analytic default beam
    p2 = _base_parms({"bandpass": {"nchan": 8, "freq": 155e6}})
    vs2, _ = run_simulation(p2, verbose=False, save=False)
    assert not np.allclose(vs.skyvis, vs2.skyvis)


def test_phased_array_beam_driver():
    p = _base_parms({"antenna": {"phased_array": True, "shape": "dipole",
                                 "size": 0.74},
                     "telescope": {"id": "mwa"},
                     "phasedarray": {"delayerr": 0.0, "gainerr": 0.0,
                                     "nrand": 1}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    assert np.isfinite(vs.skyvis).all()
    # beamformed tile differs from bare dipole
    p2 = _base_parms({"antenna": {"shape": "dipole", "size": 0.74},
                      "telescope": {"id": "mwa_dipole"}})
    vs2, _ = run_simulation(p2, verbose=False, save=False)
    assert not np.allclose(vs.skyvis, vs2.skyvis)


def test_achromatic_beam():
    p = _base_parms({"beam": {"chromatic": False, "select_freq": 155e6}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    assert np.isfinite(vs.skyvis).all()


def test_roi_radius_restricts_sky():
    p_all = _base_parms({"skyparm": {"nsrc": 128}})
    p_roi = _base_parms({"skyparm": {"nsrc": 128, "roi_radius": 60.0}})
    vs_all, _ = run_simulation(p_all, verbose=False, save=False)
    vs_roi, _ = run_simulation(p_roi, verbose=False, save=False)
    # ROI sim sums fewer sources -> generally weaker visibilities
    assert np.abs(vs_roi.skyvis).sum() < np.abs(vs_all.skyvis).sum()
    # an ROI that empties the sky raises a clear error
    import pytest as _pytest
    p_bad = _base_parms({"skyparm": {"nsrc": 16, "roi_radius": 0.01}})
    with _pytest.raises(ValueError, match="no sources"):
        run_simulation(p_bad, verbose=False, save=False)


def test_hi_cube_sky(tmp_path):
    from prisim_tpu import healpix as hp
    nside = 8
    npix = hp.nside2npix(nside)
    maps = np.abs(np.random.RandomState(0).randn(npix, 3))
    path = str(tmp_path / "cube.npz")
    np.savez(path, maps=maps, freqs=np.asarray([150e6, 155e6, 160e6]))
    p = _base_parms({"skyparm": {"model": "hi_cube"},
                     "catalog": {"spectrum_file": path}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    assert np.isfinite(vs.skyvis).all()
    assert np.abs(vs.skyvis).max() > 0


def test_spectral_smooth():
    from prisim_tpu.analysis.closure import spectral_smooth
    rng = np.random.RandomState(0)
    smooth = np.exp(1j * np.linspace(0, 1, 32))[None, :, None]
    cube = np.broadcast_to(smooth, (2, 32, 1)).copy()
    cube[:, 16, :] = 100.0  # an RFI spike
    out = spectral_smooth(cube, window_size=5, mode="median")
    assert np.abs(out[0, 16, 0]) < 2.0  # spike removed
    out2 = spectral_smooth(cube, mode="interp", flag_chans=[16])
    assert np.abs(out2[0, 16, 0] - smooth[0, 16, 0]) < 1e-2


def test_ant_bpass_file(tmp_path):
    path = str(tmp_path / "antbp.npz")
    faxis = np.linspace(140e6, 170e6, 64)
    band = 1.0 - 0.3 * ((faxis - 155e6) / 15e6) ** 2
    np.savez(path, faxis=faxis, band=band.astype(complex))
    p = _base_parms({"processing": {"ant_bpass_file": path},
                     "bandpass": {"nchan": 16}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    bp1 = np.asarray(vs.bp)[0, :, 0]
    assert bp1.max() <= 1.0 and bp1.std() > 0  # curved bandpass applied


def test_analysis_product_save(tmp_path):
    from prisim_tpu.io.dicth5 import save_dict_hdf5, load_dict_hdf5
    from prisim_tpu.analysis.delay import subband_delay_transform
    from prisim_tpu.vis import VisibilitySet
    vs = VisibilitySet(
        baselines=np.random.RandomState(0).randn(2, 3) * 30,
        labels=np.asarray([["1", "0"], ["2", "0"]]),
        freqs=150e6 + 1e5 * np.arange(32), lst=np.asarray([10.0]),
        skyvis=np.ones((2, 32, 1), dtype=complex), latitude=-30.7)
    sb = subband_delay_transform(vs, freq_center=[152e6], bw_eff=2e6)
    path = str(tmp_path / "ds.hdf5")
    save_dict_hdf5(sb, path)
    back = load_dict_hdf5(path)
    np.testing.assert_allclose(back["skyvis_lag"], sb["skyvis_lag"])
    np.testing.assert_allclose(back["lags"], sb["lags"])
    assert back["shape"] == "bhw"


def test_pfb_theoretical_from_fits(tmp_path):
    """pfb_method='theoretical' reads the measured PFB FITS table
    (response grid dB + frequency axis MHz, run_prisim.py:916-927) and
    flag_repeat_edge_channels flags coarse-channel edges."""
    import numpy as np
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import _bandpass_weights, build_frequencies
    from prisim_tpu.io.fitsio import write_image
    from prisim_tpu.windows import pfb_theoretical_shape

    nchan, ccw = 32, 8
    f0, df = 150e6, 100e3
    freqs = f0 + df * (np.arange(nchan) - nchan / 2)
    # dense response table: one filter column, scalloped in dB with
    # minima at coarse-channel edges
    fmhz = np.linspace(140.0, 160.0, 400)
    fine = (fmhz - freqs[0] / 1e6) / (df / 1e6)
    resp_db = -6.0 * (1 - np.cos(2 * np.pi * fine / ccw)) / 2
    path = str(tmp_path / "pfb.fits")
    with open(path, "wb") as fh:
        write_image(fh, resp_db.reshape(-1, 1), primary=True)
        write_image(fh, fmhz, extname="FREQS")
    shape = pfb_theoretical_shape(path, freqs)
    assert shape.shape == (nchan,)
    assert abs(shape.max() - 1.0) < 1e-12
    assert shape.min() < 0.3                   # scalloping survived

    parms = load_parms({
        "bandpass": {"nchan": nchan, "freq": f0, "freq_resolution": df,
                     "pfb_method": "theoretical", "pfb_file": path},
        "processing": {"bp_correct": False, "coarse_channel_width": ccw},
        "flags": {"n_edge_flag": [1, 1],
                  "flag_repeat_edge_channels": True},
    })
    bp, wts = _bandpass_weights(parms, 3, build_frequencies(parms), 2)
    # bp carries the scalloped shape (bp_correct false)
    nonzero = bp[0, :, 0] > 0
    assert nonzero.any()
    got = bp[0, nonzero, 0] / bp[0, nonzero, 0].max()
    exp = shape[nonzero] / shape[nonzero].max()
    np.testing.assert_allclose(got, exp, rtol=1e-9)
    # every coarse-channel edge (pfb minima) got flagged
    e0 = int(np.argmin(shape))
    for k in range(nchan // ccw):
        e = (e0 + k * ccw) % nchan
        assert bp[0, e, 0] == 0.0
    # but mid-coarse-channel channels survive
    assert bp[0, (e0 + ccw // 2) % nchan, 0] > 0
