"""Config loader + end-to-end driver tests."""

import os

import numpy as np
import pytest
import yaml

from prisim_tpu.config import (DEFAULT_PARMS, load_parms, merge_parms,
                               dump_parms)
from prisim_tpu.driver import (run_simulation, build_schedule, build_sky,
                               build_tsys, build_frequencies)

EXAMPLE = os.path.join(os.path.dirname(__file__), "..", "prisim_tpu",
                       "examples", "simparms", "hera19_random.yaml")


def test_load_partial_config_inherits_defaults():
    parms = load_parms({"telescope": {"latitude": -26.7}})
    assert parms["telescope"]["latitude"] == -26.7
    assert parms["telescope"]["A_eff"] == DEFAULT_PARMS[
        "telescope"]["A_eff"]
    assert parms["bandpass"]["nchan"] == 256


def test_unknown_key_rejected():
    with pytest.raises(KeyError):
        load_parms({"telscope": {"latitude": 0.0}})
    with pytest.raises(KeyError):
        load_parms({"telescope": {"lattitude": 0.0}})


def test_template_overlay(tmp_path):
    template = {"telescope": {"latitude": 1.0, "A_eff": 100.0},
                "bandpass": {"nchan": 32}}
    tpath = str(tmp_path / "template.yaml")
    with open(tpath, "w") as f:
        yaml.safe_dump(template, f)
    custom = {"preload": {"template": tpath},
              "telescope": {"latitude": 2.0}}
    parms = load_parms(custom)
    assert parms["telescope"]["latitude"] == 2.0
    assert parms["telescope"]["A_eff"] == 100.0
    assert parms["bandpass"]["nchan"] == 32


def test_deep_nesting_rejected():
    t = {"a": {"b": {"c": {"d": 1}}}}
    with pytest.raises(TypeError):
        merge_parms(t, {"a": {"b": {"c": {"d": 2}}}})


def test_noop_keys_warn_when_set():
    """Inert compatibility keys (NOOP_KEYS) warn when explicitly set to
    a non-default value — the schema must not pretend they do
    something."""
    import warnings
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        load_parms({"processing": {"memsave": True},
                    "pp": {"method": "mp"}})
    msgs = [str(x.message) for x in w]
    assert any("processing.memsave" in m for m in msgs)
    assert any("pp.method" in m for m in msgs)
    # defaults stay silent
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        load_parms({"telescope": {"latitude": -26.7}})
    assert not [m for m in w if "no effect" in str(m.message)]


def test_schedule_drift_lst_progression():
    parms = load_parms({"obsparm": {"n_acc": 3, "t_acc": 600.0},
                        "pointing": {"lst_init": 4.0}})
    obs = build_schedule(parms, -30.7224)
    assert obs.n_acc == 3
    dlst = np.diff(obs.lst_deg)
    # 600 s of sidereal rotation ~ 2.5069 deg
    np.testing.assert_allclose(dlst, 600.0 * 360.0 / 86164.0905,
                               rtol=1e-9)
    np.testing.assert_allclose(np.diff(obs.jd), 600.0 / 86400.0)
    # zenith drift pointing at ha=0, dec=latitude
    np.testing.assert_allclose(obs.pointing_altaz[:, 0], 90.0,
                               atol=1e-6)


def test_schedule_track_follows_source():
    parms = load_parms({"obsparm": {"obs_mode": "track", "n_acc": 2,
                                    "t_acc": 600.0},
                        "pointing": {"lst_init": 4.0,
                                     "track_init": {"ra": 60.0,
                                                    "dec": -30.7224}}})
    obs = build_schedule(parms, -30.7224)
    # pointing altitude changes as the source moves
    assert obs.pointing_altaz[0, 0] != obs.pointing_altaz[1, 0]


def test_build_sky_custom_catalog(tmp_path):
    cat = str(tmp_path / "cat.txt")
    np.savetxt(cat, np.asarray([[10.0, -30.0, 5.0, -0.8],
                                [20.0, -25.0, 15.0, -0.7]]))
    parms = load_parms({"skyparm": {"model": "custom", "flux_min": 10.0},
                        "catalog": {"custom_file": cat}})
    sm = build_sky(parms, build_frequencies(parms))
    assert sm.nsrc == 1  # flux_min cut removed the 5 Jy source
    np.testing.assert_allclose(sm.location[0], [20.0, -25.0])


def test_build_tsys_spectral():
    parms = load_parms({"telescope": {"Trx": 50.0, "Tant_ref": 200.0,
                                      "Tant_freqref": 150e6,
                                      "Tant_spindex": -2.55}})
    freqs = np.asarray([150e6, 180e6])
    tsys = build_tsys(parms, freqs, nbl=2, n_acc=1)
    np.testing.assert_allclose(tsys[0, 0, 0], 250.0)
    np.testing.assert_allclose(
        tsys[0, 1, 0], 50.0 + 200.0 * (180e6 / 150e6) ** -2.55,
        rtol=1e-12)


def test_end_to_end_driver(tmp_path):
    parms = load_parms(os.path.abspath(EXAMPLE))
    # shrink for test speed
    parms["bandpass"]["nchan"] = 16
    parms["obsparm"]["n_acc"] = 2
    parms["skyparm"]["nsrc"] = 32
    parms["dirstruct"]["rootdir"] = str(tmp_path)
    vs, outdir = run_simulation(parms, verbose=False)
    assert vs.skyvis.shape == (30, 16, 2)   # HERA-19: 30 unique baselines
    assert vs.vis is not None and vs.vis_noise is not None
    assert np.isfinite(vs.skyvis).all()
    assert np.abs(vs.skyvis).max() > 0
    # noise statistics ~ radiometer rms
    ratio = np.std(vs.vis_noise.real) / (vs.vis_rms.mean() / np.sqrt(2))
    assert 0.8 < ratio < 1.2
    # outputs on disk
    assert os.path.exists(os.path.join(outdir, "simdata",
                                       "simvis.hdf5"))
    assert os.path.exists(os.path.join(outdir, "simdata", "simvis.npz"))
    assert os.path.exists(os.path.join(outdir, "simdata",
                                       "simvis.uvfits"))
    assert os.path.exists(os.path.join(outdir, "simdata",
                                       "simvis.uvh5"))
    assert os.path.exists(os.path.join(outdir, "metainfo",
                                       "simparms.yaml"))
    # HDF5 round-trips
    from prisim_tpu.io import load_hdf5
    back = load_hdf5(os.path.join(outdir, "simdata", "simvis.hdf5"))
    np.testing.assert_allclose(back.skyvis, vs.skyvis)


def test_driver_gradient_mode(tmp_path):
    parms = load_parms({"bandpass": {"nchan": 8},
                        "obsparm": {"n_acc": 1, "t_acc": 10.0},
                        "array": {"layout": "HERA-7"},
                        "skyparm": {"model": "random", "nsrc": 16},
                        "processing": {"gradient_mode": "baseline"}})
    vs, _ = run_simulation(parms, verbose=False, save=False)
    assert vs.gradients is not None
    assert vs.gradients["baseline"].shape == (3, vs.nbl, 8, 1)


def test_save_redundant_expands_uv_exports(tmp_path):
    parms = load_parms({
        "dirstruct": {"rootdir": str(tmp_path)},
        "bandpass": {"nchan": 8, "freq": 155e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7", "redundant": True},
        "obsparm": {"n_acc": 1, "t_acc": 10.0},
        "skyparm": {"model": "random", "nsrc": 8},
        "save_redundant": True,
        "save_formats": {"uvh5": True, "npz": False}})
    vs, outdir = run_simulation(parms, verbose=False)
    assert vs.nbl == 9                      # unique baselines in HDF5
    from prisim_tpu.io.uvh5 import read_uvh5_arrays
    back = read_uvh5_arrays(os.path.join(outdir, "simdata",
                                         "simvis.uvh5"))
    assert back["Nbls"] == 21               # all pairs in UVH5
    # redundant copies carry identical visibilities
    uvw = back["uvw_array"]
    v = back["visdata"][:, :, 0]
    d = np.linalg.norm(uvw - uvw[0], axis=1)
    twins = np.where(d < 1e-6)[0]
    assert twins.size >= 2
    np.testing.assert_allclose(v[twins[0]], v[twins[1]], rtol=1e-6)


def test_extended_sources_through_driver(tmp_path):
    cat = str(tmp_path / "ext.txt")
    # two extended gaussian sources (maj min pa in deg)
    np.savetxt(cat, np.asarray([
        [40.0, -30.0, 10.0, -0.8, 2.0, 1.5, 0.0],
        [50.0, -28.0, 5.0, -0.7, 1.0, 1.0, 0.0]]))
    p = load_parms({
        "bandpass": {"nchan": 8, "freq": 150e6,
                     "freq_resolution": 97656.25},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 10.0},
        "skyparm": {"model": "custom", "flux_min": None},
        "catalog": {"custom_file": cat}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    assert np.isfinite(vs.skyvis).all()
    # point-source version of the same catalog gives larger long-baseline
    # amplitudes (extended sources are resolved down)
    np.savetxt(cat, np.asarray([[40.0, -30.0, 10.0, -0.8],
                                [50.0, -28.0, 5.0, -0.7]]))
    vs_pt, _ = run_simulation(p, verbose=False, save=False)
    blen = vs.baseline_lengths
    longest = blen.argmax()
    assert (np.abs(vs.skyvis[longest]).mean()
            < np.abs(vs_pt.skyvis[longest]).mean())


def test_multi_source_analytic_golden(tmp_path):
    """Driver output for a 3-source catalog matches the analytic
    visibility sum with a delta (uniform) beam to ~1e-6."""
    from prisim_tpu import constants as CNST
    from prisim_tpu import geometry as geom
    cat = str(tmp_path / "three.txt")
    srcs = np.asarray([[40.0, -30.0, 10.0, 0.0],
                       [55.0, -25.0, 4.0, 0.0],
                       [30.0, -45.0, 7.0, 0.0]])
    np.savetxt(cat, srcs)
    p = load_parms({
        "telescope": {"id": "custom", "latitude": -30.7224},
        "antenna": {"shape": "delta"},
        "bandpass": {"nchan": 16, "freq": 150e6,
                     "freq_resolution": 97656.25},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 10.0},
        "pointing": {"lst_init": 40.0 / 15.0},
        # epoch None: catalog coordinates are AT the observing epoch
        # (the analytic golden below uses them unprecessed)
        "skyparm": {"model": "custom", "flux_min": None, "epoch": None},
        "phasing": {"center": [90.0, 270.0], "coords": "altaz"},
        "catalog": {"custom_file": cat}})
    vs, _ = run_simulation(p, verbose=False, save=False)
    # analytic: V = sum_src S exp(-2pi i nu b.(s - z)/c) above horizon
    lst = float(vs.lst[0])
    lat = -30.7224
    hadec = np.stack([lst - srcs[:, 0], srcs[:, 1]], axis=-1)
    altaz = geom.hadec2altaz(hadec, lat, xp=np)
    sdc = geom.altaz2dircos(altaz, xp=np)
    up = altaz[:, 0] > 0
    z = np.asarray([0.0, 0.0, 1.0])
    nu = np.asarray(vs.freqs)
    V = np.zeros((vs.nbl, vs.nchan), dtype=complex)
    for k in np.where(up)[0]:
        tau = np.asarray(vs.baselines) @ (sdc[k] - z) / CNST.c
        V += srcs[k, 2] * np.exp(-2j * np.pi * nu[None, :]
                                 * tau[:, None])
    got = vs.skyvis[:, :, 0]
    assert np.abs(got - V).max() / np.abs(V).max() < 3e-6


def test_full_pipeline_example(tmp_path):
    """The examples/full_pipeline.py walkthrough runs end-to-end (its
    internal UVFITS round-trip assertion is the check)."""
    from prisim_tpu.examples.full_pipeline import main
    out = main(str(tmp_path), verbose=False)
    assert out["dps"]["skyvis"].shape[0] == out["vs"].nbl
    import numpy as np
    assert np.isfinite(np.asarray(out["closure"])).all()


def test_plots_flag(tmp_path):
    """plots: true writes diagnostic figures under <outdir>/figures/."""
    import os
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation
    p = load_parms({
        "dirstruct": {"rootdir": str(tmp_path), "project": "p"},
        "bandpass": {"nchan": 8, "freq": 155e6, "freq_resolution": 1e5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 10.0},
        "skyparm": {"model": "random", "nsrc": 8, "seed": 0},
        "plots": True,
        "processing": {"delay_transform": True}})
    vs, outdir = run_simulation(p, verbose=False)
    figs = sorted(os.listdir(os.path.join(outdir, "figures")))
    assert figs == ["amp_vs_baseline.png", "delay_waterfall.png",
                    "vis_waterfall.png"]
    for f in figs:
        assert os.path.getsize(os.path.join(outdir, "figures", f)) > 5000


def test_driver_gains_file(tmp_path):
    """gains.file: antenna gain table applied as g(A2) conj(g(A1));
    two driver runs (with/without gains) differ exactly by that factor
    on the noiseless cube."""
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation
    from prisim_tpu.gains import GainInfo, GainTable
    base = {
        "dirstruct": {"rootdir": str(tmp_path), "project": "p"},
        "bandpass": {"nchan": 4, "freq": 155e6, "freq_resolution": 1e5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 10.0},
        "skyparm": {"model": "random", "nsrc": 8, "seed": 0}}
    p0 = load_parms(dict(base))
    vs0, _ = run_simulation(p0, verbose=False, save=False)
    labels = np.unique(np.asarray(vs0.labels, dtype=str))
    rng = np.random.RandomState(5)
    g = (1.0 + 0.1 * rng.randn(labels.size)) * \
        np.exp(1j * 0.2 * rng.randn(labels.size))
    gi = GainInfo(antenna_based=GainTable(
        gains=g[:, None, None], label=labels))
    gpath = str(tmp_path / "gains.hdf5")
    gi.write_hdf5(gpath)
    p1 = load_parms({**base, "gains": {"file": gpath}})
    vs1, _ = run_simulation(p1, verbose=False, save=False)
    lut = {l: i for i, l in enumerate(labels)}
    pairs = np.asarray(vs0.labels, dtype=str)
    expect = np.asarray([g[lut[a2]] * np.conj(g[lut[a1]])
                         for a2, a1 in pairs])
    # vis = gains * skyvis + noise; skyvis itself is gain-free
    np.testing.assert_allclose(np.asarray(vs1.skyvis),
                               np.asarray(vs0.skyvis), rtol=1e-6)
    ratio = (np.asarray(vs1.vis) - np.asarray(vs1.vis_noise)) / \
        np.asarray(vs0.skyvis)
    np.testing.assert_allclose(
        ratio, np.broadcast_to(expect[:, None, None], ratio.shape),
        rtol=1e-5)


def test_driver_nufft_engine():
    """processing.engine: nufft produces the same sky visibilities as
    the direct engine to NUFFT accuracy."""
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation
    base = {
        "bandpass": {"nchan": 32, "freq": 155e6, "freq_resolution": 1e5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 2, "t_acc": 10.0},
        "skyparm": {"model": "random", "nsrc": 64, "seed": 0}}
    v0, _ = run_simulation(load_parms(dict(base)), verbose=False,
                           save=False)
    p1 = dict(base)
    p1["processing"] = {"engine": "nufft"}
    v1, _ = run_simulation(load_parms(p1), verbose=False, save=False)
    rel = np.abs(np.asarray(v1.skyvis) - np.asarray(v0.skyvis)).max() \
        / np.abs(np.asarray(v0.skyvis)).max()
    assert rel < 2e-5, rel
    # noise/gains stages run identically downstream
    assert v1.vis is not None and np.isfinite(v1.vis).all()


def test_acc_chunked_scan_matches_full(tmp_path):
    """processing.acc_chunk splits the drift scan at the host level
    (the HBM guard for long scans over multi-GB skies) and reproduces
    the unchunked result exactly."""
    base = {
        "bandpass": {"nchan": 8, "freq": 155e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 5, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 16},
        "pp": {"key": "none"}}
    p1 = load_parms(base)
    vs1, _ = run_simulation(p1, verbose=False, save=False)
    p2 = load_parms(dict(base, processing={"acc_chunk": 2}))
    vs2, _ = run_simulation(p2, verbose=False, save=False)
    np.testing.assert_allclose(vs2.skyvis, vs1.skyvis, rtol=2e-6,
                               atol=1e-6 * np.abs(vs1.skyvis).max())


def test_nufft_crosscheck_gate_falls_back(capsys):
    """A failing NUFFT/direct cross-check falls the WHOLE run back to
    the direct engine (the safety gate that protects runs where the
    sorted spread underperforms; forced here with an impossible
    tolerance)."""
    base = {
        "bandpass": {"nchan": 16, "freq": 155e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 10.0},
        "skyparm": {"model": "random", "nsrc": 16},
        "pp": {"key": "none"}}
    p_direct = load_parms(base)
    vs_direct, _ = run_simulation(p_direct, verbose=False, save=False)
    p_gated = load_parms(dict(base, processing={
        "engine": "nufft", "nufft_crosscheck_tol": 1e-30}))
    vs_gated, _ = run_simulation(p_gated, verbose=True, save=False)
    out = capsys.readouterr().out
    assert "cross-check FAILED" in out
    np.testing.assert_allclose(vs_gated.skyvis, vs_direct.skyvis,
                               rtol=1e-6)
