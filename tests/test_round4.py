"""Round-4 parity closures: 'asm' combined sky model
(run_prisim.py:810,1089-1200), gsm map-file workflow
(run_prisim.py:1253-1279), closure-phase rms/MAD time-bin statistics
(bispectrum_phase.py:1727,1789-1797,1911-1928), friendly banded FFT
lengths."""

import numpy as np
import pytest

from prisim_tpu.config import load_parms
from prisim_tpu.driver import build_sky, build_frequencies

from test_catalog_fits import _write_dsm, NPIX
from test_catalogs import _write_sumss, _write_nvss


def test_asm_merge(tmp_path):
    """asm = DSM diffuse + SUMSS + NVSS point sources; the flux cut
    applies to the point sources only (run_prisim.py:1141,1186 filter
    SUMSS/NVSS by brightness but keep every DSM pixel)."""
    dsm = str(tmp_path / "dsm_150.0_MHz_nside_8.fits")
    _write_dsm(dsm, nside=8)
    sumss = str(tmp_path / "sumss.txt")
    _write_sumss(sumss)
    nvss = str(tmp_path / "nvss.fits")
    _write_nvss(nvss)
    p = load_parms({"skyparm": {"model": "asm", "nside": 8,
                                "flux_min": None},
                    "catalog": {"DSM_file_prefix": str(tmp_path / "dsm"),
                                "SUMSS_file": sumss,
                                "NVSS_file": nvss}})
    sm = build_sky(p, build_frequencies(p))
    n_nvss = int(np.sum(np.linspace(-60, 40, 5) > -30.0))
    assert sm.nsrc == NPIX + 3 + n_nvss
    assert "DSM" in sm.name and "SUMSS" in sm.name and "NVSS" in sm.name

    # flux_min=2.0 Jy: every DSM pixel (~1.1 Jy at nside 8) survives;
    # all SUMSS (0.1-0.3 Jy) are cut; NVSS keeps fluxes >= 2 Jy
    p2 = load_parms({"skyparm": {"model": "asm", "nside": 8,
                                 "flux_min": 2.0},
                     "catalog": {"DSM_file_prefix": str(tmp_path / "dsm"),
                                 "SUMSS_file": sumss,
                                 "NVSS_file": nvss}})
    sm2 = build_sky(p2, build_frequencies(p2))
    nvss_dec = np.linspace(-60, 40, 5)
    nvss_flux = np.linspace(1.0, 5.0, 5)
    n_nvss2 = int(np.sum((nvss_dec > -30.0) & (nvss_flux >= 2.0)))
    assert sm2.nsrc == NPIX + 0 + n_nvss2


def test_asm_requires_dsm(tmp_path):
    p = load_parms({"skyparm": {"model": "asm"}, "catalog": {}})
    with pytest.raises(ValueError, match="DSM_file_prefix"):
        build_sky(p, build_frequencies(p))


def test_gsm_needs_map_file_message():
    p = load_parms({"skyparm": {"model": "gsm2008", "nside": 8},
                    "catalog": {}})
    with pytest.raises(ValueError, match="tools gsm"):
        build_sky(p, build_frequencies(p))


def test_gsm_npz_multifreq_maps(tmp_path):
    """A pre-generated multi-frequency map npz (the `tools gsm` output
    schema) feeds the gsm branch as exact per-frequency spectra."""
    from prisim_tpu import healpix as hp
    nside = 8
    npix = hp.nside2npix(nside)
    fmdl = np.array([140e6, 150e6, 160e6])
    rng = np.random.RandomState(3)
    maps = 100.0 * (1.0 + 0.1 * rng.rand(npix, fmdl.size))
    path = str(tmp_path / "gsm.npz")
    np.savez(path, maps=maps, freqs=fmdl)
    p = load_parms({"bandpass": {"nchan": 4, "freq": 150e6,
                                 "freq_resolution": 390625.0},
                    "skyparm": {"model": "gsm2008", "nside": nside},
                    "catalog": {"spectrum_file": path}})
    sm = build_sky(p, build_frequencies(p))
    assert sm.nsrc == npix
    spec = sm.generate_spectrum(build_frequencies(p))
    assert spec.shape == (npix, 4)
    assert np.all(spec > 0)


def test_gsm_tool_gated():
    """`tools gsm` raises the documented error where pygsm is absent."""
    from prisim_tpu.tools import gsm_to_npz
    try:
        import pygdsm  # noqa: F401
        pytest.skip("pygdsm installed; gating not exercised")
    except ImportError:
        pass
    try:
        import pygsm  # noqa: F401
        pytest.skip("pygsm installed; gating not exercised")
    except ImportError:
        pass
    with pytest.raises(RuntimeError, match="pygsm"):
        gsm_to_npz("/tmp/x.npz", nside=8, freqs=[150e6])


def test_eq2gal_rotation_orthonormal():
    from prisim_tpu.tools import _EQ2GAL
    np.testing.assert_allclose(_EQ2GAL @ _EQ2GAL.T, np.eye(3),
                               atol=1e-7)
    # NGP (gal z axis) at ra=192.8595 dec=27.1283 (J2000)
    ngp = _EQ2GAL[2]
    ra, dec = np.radians(192.85948), np.radians(27.12825)
    v = np.array([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                  np.sin(dec)])
    np.testing.assert_allclose(ngp, v, atol=2e-6)


def test_tbin_stats_noise():
    """rms/MAD of pure gaussian phase noise match the analytic values:
    rms -> sigma, MAD -> 0.6745 sigma (bispectrum_phase.py:1789-1797)."""
    from prisim_tpu.analysis.bispectrum import ClosurePhaseData
    rng = np.random.RandomState(11)
    sigma = 0.3
    nlst, nd, nt, nc = 400, 1, 3, 4
    cp = sigma * rng.randn(nlst, nd, nt, nc)
    cpd = ClosurePhaseData(cp=cp, wts=np.ones_like(cp),
                           freqs=np.linspace(100e6, 200e6, nc),
                           lst=np.linspace(0.0, 4.0, nlst),
                           days=np.array([2458000.0]),
                           triads=np.arange(3 * nt).reshape(nt, 3))
    st = cpd.tbin_stats(lstbinsize=2.01)
    assert st["rms"].shape == (2, nd, nt, nc)
    np.testing.assert_allclose(st["rms"], sigma, rtol=0.25)
    np.testing.assert_allclose(st["mad"], 0.6745 * sigma, rtol=0.25)
    # flagged samples are excluded: zero-weight half at huge values
    cp2 = cp.copy()
    cp2[::2] = 100.0
    w2 = np.ones_like(cp)
    w2[::2] = 0.0
    cpd2 = ClosurePhaseData(cp=cp2, wts=w2, freqs=cpd.freqs,
                            lst=cpd.lst, days=cpd.days,
                            triads=cpd.triads)
    st2 = cpd2.tbin_stats(lstbinsize=2.01)
    np.testing.assert_allclose(st2["rms"], sigma, rtol=0.35)
    np.testing.assert_allclose(st2["mad"], 0.6745 * sigma, rtol=0.35)
    with pytest.raises(ValueError):
        cpd.tbin_stats()
    st3 = cpd.tbin_stats(daybinsize=1.0)
    assert st3["rms"].shape == (nlst, 1, nt, nc)
    # one sample per day bin: std is 0
    np.testing.assert_allclose(st3["rms"], 0.0, atol=1e-12)


def test_banded_plan_awkward_nchan():
    """A prime-ish nchan (delay grid n = 2 x 127) runs the backend FFT at
    that length and stays accurate vs the f64 NUFFT reference."""
    from prisim_tpu import constants as CNST
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine import nufft_banded as NB
    from prisim_tpu.engine.nufft_delay import nufft_delay_visibilities
    import jax.numpy as jnp
    rng = np.random.RandomState(5)
    nchan = 127
    bl = rng.uniform(-40, 40, (6, 3))
    plan = NB.make_banded_plan(bl, 150e6, 97656.25, nchan, rank=1,
                               T_s=256)
    assert plan.n == 2 * nchan
    s = rng.randn(300, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s[:, 2] = np.abs(s[:, 2])
    se = s - np.asarray([0.0, 0.0, 1.0])
    amps = rng.uniform(0.1, 1.0, 300)
    gold = nufft_delay_visibilities((se @ bl.T) / CNST.c, amps, 150e6,
                                    97656.25, nchan)
    seh, sel = tf.split_f64(se)
    vis, ok = NB.nufft_banded_visibilities(
        plan, jnp.asarray(seh), jnp.asarray(sel),
        jnp.asarray(amps, jnp.float32)[:, None],
        np.ones((nchan, 1), np.float32))
    assert bool(ok)
    assert np.abs(np.asarray(vis) - gold).max() / np.abs(gold).max() < 5e-6


def test_banded_gate_demotes_degraded_run(capsys):
    """A deliberately degraded banded run (forced
    rank 4 over a full octave -> coherent fit error >> 2e-6) must trip
    the shared-amps gate and demote to the direct engine."""
    from prisim_tpu.driver import run_simulation

    base = {
        "bandpass": {"nchan": 32, "freq": 150e6,
                     "freq_resolution": 3.125e6},   # 100-200 MHz octave
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 128, "seed": 5},
        "pp": {"key": "none"},
    }
    p = load_parms(dict(base, processing={
        "engine": "nufft", "nufft_spread": "banded", "nufft_rank": 4}))
    vs, _ = run_simulation(p, verbose=True, save=False)
    out = capsys.readouterr().out
    assert "cross-check FAILED" in out
    # demoted result is the direct engine's
    p2 = load_parms(dict(base, processing={"engine": "direct"}))
    vs2, _ = run_simulation(p2, verbose=False, save=False)
    np.testing.assert_allclose(np.asarray(vs.skyvis),
                               np.asarray(vs2.skyvis), rtol=0, atol=0)


def test_banded_gate_passes_good_run(capsys):
    """A healthy banded run passes the shared-amps gate at its 2e-6
    default and reports the measured rel."""
    from prisim_tpu.driver import run_simulation
    p = load_parms({
        "bandpass": {"nchan": 16, "freq": 150e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 64, "seed": 5},
        "pp": {"key": "none"},
        "processing": {"engine": "nufft", "nufft_spread": "banded"}})
    vs, _ = run_simulation(p, verbose=True, save=False)
    out = capsys.readouterr().out
    assert "shared-amps cross-check ok" in out
    assert np.isfinite(np.asarray(vs.skyvis)).all()


def _one_source_parms(tmp_path, ra, dec, extra=None):
    cat = tmp_path / "one.txt"
    cat.write_text("%f %f 10.0 0.0\n" % (ra, dec))
    base = {
        "telescope": {"latitude": -30.0},
        "bandpass": {"nchan": 8, "freq": 150e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 2, "t_acc": 9600.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "custom", "flux_min": None},
        "catalog": {"custom_file": str(cat)},
    }
    if extra:
        for k, v in extra.items():
            base.setdefault(k, {}).update(v)
    return load_parms(base)


def test_sector_mask_formula():
    """Wedge-pair membership: az and az+180 share a sector; n sectors
    tile the full circle (run_prisim.py:1875 roi_ind condition)."""
    import jax.numpy as jnp
    from prisim_tpu.driver import _sector_mask
    az = np.linspace(0.0, 359.0, 720)
    alt = np.full_like(az, 40.0)
    from prisim_tpu import geometry as geom
    s = geom.altaz2dircos(np.stack([alt, az], -1), xp=np)
    for n in (2, 4):
        total = np.zeros(az.size)
        for k in range(n):
            m = np.asarray(_sector_mask(jnp.asarray(s, jnp.float32),
                                        k, n))
            # antipodal pairing
            m2 = np.asarray(_sector_mask(jnp.asarray(
                geom.altaz2dircos(np.stack(
                    [alt, (az + 180.0) % 360.0], -1), xp=np),
                jnp.float32), k, n))
            np.testing.assert_array_equal(m, m2)
            total += m
        np.testing.assert_allclose(total, 1.0)


def test_sectors_per_snapshot_membership(tmp_path):
    """A drifting source near a wedge boundary lands in DIFFERENT
    sectors at different accumulations (the reference's per-snapshot
    ROI sectoring, run_prisim.py:1859-1875; round-3 partitioned once
    at the mean LST)."""
    from prisim_tpu import geometry as geom
    from prisim_tpu.driver import run_simulation

    # source at dec=-50 (lat=-30): azimuth swings through the sector-0/
    # sector-1 boundary (az=225 for n=2) between HA=20 and HA=60 deg
    lst_centers = np.array([20.05, 60.16])          # from t_acc=9600
    ra = 0.0
    dec = -50.0
    ha = lst_centers - ra
    altaz = geom.hadec2altaz(
        np.stack([ha, np.full(2, dec)], -1), -30.0, xp=np)
    assert np.all(altaz[:, 0] > 0.0)                # above horizon
    fold = np.mod(altaz[:, 1] + 45.0, 180.0)
    sector_of = np.floor(fold / 90.0).astype(int)
    assert sector_of[0] != sector_of[1], \
        "test geometry must cross the wedge boundary"

    p = _one_source_parms(
        tmp_path, ra, dec,
        extra={"processing": {"n_sky_sectors": 2}, "pp": {"key": "none"}})
    outs, _ = run_simulation(p, verbose=False, save=False)
    p_full = _one_source_parms(tmp_path, ra, dec,
                               extra={"pp": {"key": "none"}})
    vs_full, _ = run_simulation(p_full, verbose=False, save=False)
    full = np.abs(np.asarray(vs_full.skyvis))       # (B, C, T)
    assert full[..., 0].max() > 0 and full[..., 1].max() > 0
    for k in range(2):
        vk = outs[k]
        mag = np.zeros((1, 1, 2)) if vk is None \
            else np.abs(np.asarray(vk.skyvis))
        for t in range(2):
            if sector_of[t] == k:
                assert mag[..., t].max() > 1e-6, (k, t)
            else:
                np.testing.assert_allclose(mag[..., t], 0.0, atol=1e-7)


def test_sectors_partition_full_sky(tmp_path):
    """Sector outputs sum to the full-sky run at every accumulation."""
    from prisim_tpu.driver import run_simulation
    base = {
        "telescope": {"latitude": -30.0},
        "bandpass": {"nchan": 8, "freq": 150e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 2, "t_acc": 3600.0},
        "skyparm": {"model": "random", "nsrc": 96, "seed": 7},
        "pp": {"key": "none"},
    }
    p_full = load_parms(dict(base))
    vs_full, _ = run_simulation(p_full, verbose=False, save=False)
    p_sec = load_parms(dict(base, processing={"n_sky_sectors": 3}))
    outs, _ = run_simulation(p_sec, verbose=False, save=False)
    tot = None
    for vk in outs:
        if vk is None:
            continue
        v = np.asarray(vk.skyvis)
        tot = v if tot is None else tot + v
    full = np.asarray(vs_full.skyvis)
    np.testing.assert_allclose(tot, full, atol=2e-4 * np.abs(full).max())


def test_phased_array_per_snapshot_pointing(tmp_path):
    """Track-mode beamformed array steers per accumulation: snapshot t
    of a 2-acc track run equals a 1-acc run at the same LST/pointing
    (primary_beams.py:288-316; round-3 froze snapshot-0 pointing)."""
    from prisim_tpu.driver import run_simulation

    def parms(lst_init, n_acc):
        return load_parms({
            "telescope": {"id": "mwa", "latitude": -26.7},
            "antenna": {"shape": "dipole", "size": 0.74,
                        "phased_array": True},
            "phasedarray": {"delayerr": 0.0, "gainerr": 0.0},
            "bandpass": {"nchan": 8, "freq": 150e6,
                         "freq_resolution": 195312.5},
            "array": {"layout": "HERA-7"},
            "obsparm": {"n_acc": n_acc, "t_acc": 3600.0,
                        "obs_mode": "track"},
            "pointing": {"lst_init": lst_init,
                         "track_init": {"ra": 30.0, "dec": -26.7}},
            "skyparm": {"model": "random", "nsrc": 48, "seed": 3},
            "pp": {"key": "none"},
        })

    sid_per_sec = 360.0 / 86164.0905
    p2 = parms(0.0, 2)
    vs2, _ = run_simulation(p2, verbose=False, save=False)
    # 1-acc run centered on the 2-acc run's SECOND accumulation:
    # lst_init + 1.5*t_acc*sidereal = lst_init' + 0.5*t_acc*sidereal
    p1 = parms(3600.0 * sid_per_sec / 15.0, 1)   # lst_init in hours
    vs1, _ = run_simulation(p1, verbose=False, save=False)
    a = np.asarray(vs2.skyvis)[..., 1]
    b = np.asarray(vs1.skyvis)[..., 0]
    scale = np.abs(a).max()
    np.testing.assert_allclose(a, b, atol=2e-5 * scale)
    # and it must DIFFER from the first accumulation's steering
    assert np.abs(a - np.asarray(vs2.skyvis)[..., 0]).max() > 1e-3 * scale


def test_chebyshev_node_model_exact_on_rank_polynomials():
    """The node model's interpolation operators are mutually
    consistent: coefficients -> node values -> coefficients round-trips
    exactly, and the full-grid expansion of node values equals the
    basis evaluation of the coefficients (f32)."""
    from prisim_tpu.engine.nufft_delay import chebyshev_node_model
    freqs = 100e6 + 195312.5 * np.arange(64)
    nm = chebyshev_node_model(freqs, rank=6)
    rng = np.random.RandomState(7)
    coef = rng.standard_normal((5, 6)).astype(np.float32)
    vals = coef @ np.asarray(nm.V, np.float64).T         # (5, r) nodes
    back = vals @ np.asarray(nm.node2coef, np.float64)
    np.testing.assert_allclose(back, coef, rtol=0, atol=1e-5)
    full = vals @ np.asarray(nm.expand, np.float64).T    # (5, C)
    direct = coef @ np.asarray(nm.Q, np.float64).T
    np.testing.assert_allclose(full, direct, rtol=0,
                               atol=1e-5 * np.abs(direct).max())
    # node frequencies live strictly inside the band
    assert nm.nu_nodes.min() > freqs[0] - 1.0
    assert nm.nu_nodes.max() < freqs[-1] + 1.0


def test_banded_node_model_knob_matches_projection_form():
    """processing.nufft_node_model=False routes the banded engine
    through the round-3 projection form; both forms agree with each
    other and pass the gate on a smooth sky."""
    from prisim_tpu.driver import run_simulation
    base = {
        "bandpass": {"nchan": 16, "freq": 150e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 64, "seed": 5},
        "pp": {"key": "none"},
    }
    pn = load_parms(dict(base, processing={
        "engine": "nufft", "nufft_spread": "banded"}))
    vs_n, _ = run_simulation(pn, verbose=False, save=False)
    pp_ = load_parms(dict(base, processing={
        "engine": "nufft", "nufft_spread": "banded",
        "nufft_node_model": False}))
    vs_p, _ = run_simulation(pp_, verbose=False, save=False)
    a, b = np.asarray(vs_n.skyvis), np.asarray(vs_p.skyvis)
    scale = np.abs(a).max()
    np.testing.assert_allclose(a, b, atol=5e-6 * scale)
