"""Engine tests: NUDFT precision vs float64 golden, closed forms,
drift driver, noise statistics."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from prisim_tpu import constants as CNST
from prisim_tpu import geometry as geom
from prisim_tpu import twofloat as tf
from prisim_tpu import skymodel as sm
from prisim_tpu.engine import (nudft_visibilities, nudft_reference_f64,
                               Instrument, Observation, SkySources,
                               simulate_snapshot, simulate_drift,
                               enu_rotation_from_eq, thermal_noise_rms,
                               generate_noise)
from prisim_tpu.engine.nudft import freq_grid_scalars
from prisim_tpu.beams import airy_beam


def _random_problem(S=300, B=64, C=128, bl_scale=500.0, seed=0,
                    nu0=100e6, dnu=100e3):
    rng = np.random.default_rng(seed)
    # random upper-hemisphere sources
    alt = np.degrees(np.arcsin(rng.uniform(0.05, 1.0, S)))
    az = rng.uniform(0, 360, S)
    s = geom.altaz2dircos(np.stack([alt, az], axis=-1), xp=np)
    bl = rng.uniform(-bl_scale, bl_scale, (B, 3))
    bl[:, 2] *= 0.01
    amps = rng.uniform(0.1, 10.0, (S, C))
    freqs = nu0 + dnu * np.arange(C)
    pc = np.array([0.0, 0.0, 1.0])
    return s, bl, amps, freqs, pc


def _run_engine_path(s, bl, amps, freqs, pc, **kw):
    s_eff = s - pc[None, :]
    seh, sel = tf.split_f64(s_eff)
    blh, bll = tf.split_f64(bl)
    gs = freq_grid_scalars(freqs[0], freqs[1] - freqs[0])
    out = nudft_visibilities(
        jnp.asarray(seh), jnp.asarray(sel), jnp.asarray(blh),
        jnp.asarray(bll), jnp.asarray(amps, dtype=jnp.float32), gs,
        len(freqs), **kw)
    if isinstance(out, tuple):
        return tuple(np.asarray(o) for o in out)
    return np.asarray(out)


def test_single_source_closed_form():
    # V(b, nu) = A exp(-2 pi i nu (s-pc).b / c) exactly.
    s = geom.altaz2dircos(np.array([[47.0, 123.0]]), xp=np)
    bl = np.array([[100.0, -50.0, 3.0], [14.6, 0.0, 0.0]])
    C = 32
    freqs = 150e6 + 390625.0 * np.arange(C)
    amps = np.full((1, C), 2.5)
    pc = geom.altaz2dircos(np.array([[90.0, 0.0]]), xp=np)[0]
    got = _run_engine_path(s, bl, amps, freqs, pc)
    tau = ((s - pc) @ bl.T / CNST.c)[0]  # (B,)
    want = 2.5 * np.exp(-2j * np.pi * tau[:, None] * freqs[None, :])
    assert np.max(np.abs(got - want)) / 2.5 < 2e-6


@pytest.mark.parametrize("bl_scale,C", [(500.0, 128), (3000.0, 96)])
def test_nudft_matches_f64_golden(bl_scale, C):
    # HERA-scale and long-baseline regimes; target <= ~1e-6 relative.
    s, bl, amps, freqs, pc = _random_problem(S=300, B=48, C=C,
                                             bl_scale=bl_scale)
    got = _run_engine_path(s, bl, amps, freqs, pc, src_block=128)
    want = nudft_reference_f64(s - pc[None, :], bl, amps, freqs)
    scale = np.sum(np.abs(amps), axis=0).max()  # worst-case coherent sum
    err = np.max(np.abs(got - want)) / scale
    assert err < 2e-6, f"relative error {err:.2e}"


def test_nudft_f32_naive_would_fail():
    # Demonstrate the two-float machinery is load-bearing: a plain f32
    # phase evaluation misses the 1e-6 target by orders of magnitude.
    s, bl, amps, freqs, pc = _random_problem(S=50, B=16, C=32,
                                             bl_scale=3000.0)
    s_eff = (s - pc[None, :]).astype(np.float32)
    tau = (s_eff @ bl.astype(np.float32).T / np.float32(CNST.c))
    phase = (2 * np.pi * tau[:, :, None].astype(np.float32)
             * freqs.astype(np.float32)[None, None, :]).astype(np.float32)
    naive = np.einsum("sc,sbc->bc", amps, np.exp(-1j * phase))
    want = nudft_reference_f64(s - pc[None, :], bl, amps, freqs)
    scale = np.sum(np.abs(amps), axis=0).max()
    naive_err = np.max(np.abs(naive - want)) / scale
    assert naive_err > 1e-5  # naive f32 fails


def test_nudft_extended_sources():
    s, bl, amps, freqs, pc = _random_problem(S=40, B=12, C=32)
    rng = np.random.default_rng(3)
    fwhm_deg = rng.uniform(0.1, 1.0, 40)
    fwhm_dc = 2 * np.sin(0.5 * np.radians(fwhm_deg))
    sigma = (1.0 / (np.sqrt(2 * np.log(2)) * fwhm_dc)).astype(np.float32)
    got = _run_engine_path(
        s, bl, amps, freqs, pc, src_block=64,
        src_shape_sigma=jnp.asarray(sigma),
        s_sky=jnp.asarray(s.astype(np.float32)),
        inv_wl=jnp.asarray((freqs / CNST.c).astype(np.float32)))
    want = nudft_reference_f64(s - pc[None, :], bl, amps, freqs, s_sky=s,
                               src_shape_sigma=sigma)
    scale = np.sum(np.abs(amps), axis=0).max()
    assert np.max(np.abs(got - want)) / scale < 5e-6


def test_nudft_gradient():
    s, bl, amps, freqs, pc = _random_problem(S=60, B=12, C=32)
    got_v, got_g = _run_engine_path(s, bl, amps, freqs, pc, src_block=64,
                                 gradient=True,
                                 s_sky=jnp.asarray(s.astype(np.float32)))
    want_v, want_g = nudft_reference_f64(s - pc[None, :], bl, amps, freqs,
                                         s_sky=s, gradient=True)
    scale = np.sum(np.abs(amps), axis=0).max()
    assert np.max(np.abs(got_v - want_v)) / scale < 2e-6
    assert np.max(np.abs(got_g - want_g)) / scale < 2e-6


def test_rotation_matrix_properties():
    M = enu_rotation_from_eq(123.4, -30.7)
    assert np.allclose(M @ M.T, np.eye(3), atol=1e-14)
    # NCP maps to north-up plane: E component zero, U = sin(lat).
    ncp = M @ np.array([0.0, 0.0, 1.0])
    assert ncp[0] == pytest.approx(0.0, abs=1e-14)
    assert ncp[2] == pytest.approx(np.sin(np.radians(-30.7)), abs=1e-12)
    # A source at RA=LST on the equator transits the meridian: E=0.
    lst = 123.4
    s_eq = np.array([np.cos(np.radians(lst)), np.sin(np.radians(lst)), 0.0])
    enu = M @ s_eq
    assert enu[0] == pytest.approx(0.0, abs=1e-12)


def test_rotation_matches_geometry_module():
    # Rotation path and hadec2altaz path must agree.
    lat, lst = -30.72, 77.0
    ra, dec = np.array([40.0]), np.array([-25.0])
    M = enu_rotation_from_eq(lst, lat)
    s_eq = np.stack([np.cos(np.radians(dec)) * np.cos(np.radians(ra)),
                     np.cos(np.radians(dec)) * np.sin(np.radians(ra)),
                     np.sin(np.radians(dec))], axis=-1)
    enu = s_eq @ M.T
    altaz = geom.hadec2altaz(np.stack([lst - ra, dec], axis=-1), lat, xp=np)
    want = geom.altaz2dircos(altaz, xp=np)
    assert np.allclose(enu, want, atol=1e-12)


def _small_sim(n_acc=3, C=16, nsrc=50):
    from prisim_tpu import layouts as lay
    from prisim_tpu import baselines as bls
    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=True)
    freqs = 150e6 + 390625.0 * np.arange(C)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72,
                            telescope={"id": "hera"})
    model = sm.random_point_source_model(nsrc, seed=7)
    sky = SkySources.from_skymodel(model, freqs)
    lst = np.linspace(10.0, 20.0, n_acc)
    obs = Observation(lst_deg=lst, jd=2457349.5 + lst / 360.0,
                      t_acc=np.full(n_acc, 120.0),
                      pointing_altaz=np.tile([90.0, 270.0], (n_acc, 1)))
    beam_fn = lambda dc, f: airy_beam(dc, f, 14.0)
    return inst, sky, obs, beam_fn, model, bset


def test_simulate_drift_matches_host_reference():
    inst, sky, obs, beam_fn, model, bset = _small_sim()
    vis = np.asarray(simulate_drift(inst, sky, obs, beam_fn, src_block=64))
    assert vis.shape == (3, bset.nbl, 16)
    # Golden: per-snapshot host f64 computation.
    for t in range(3):
        M = enu_rotation_from_eq(obs.lst_deg[t], inst.latitude)
        ra = np.radians(model.location[:, 0])
        dec = np.radians(model.location[:, 1])
        s_eq = np.stack([np.cos(dec) * np.cos(ra), np.cos(dec) * np.sin(ra),
                         np.sin(dec)], axis=-1)
        s_enu = s_eq @ M.T
        above = s_enu[:, 2] > 0
        pc = np.array([0.0, 0.0, 1.0])
        flux = model.generate_spectrum(inst.freqs)
        pb = np.asarray(airy_beam(s_enu[above], inst.freqs, 14.0))
        amps = pb * flux[above]
        want = nudft_reference_f64(s_enu[above] - pc, bset.vectors, amps,
                                   inst.freqs)
        scale = np.sum(np.abs(amps), axis=0).max()
        assert np.max(np.abs(vis[t] - want)) / scale < 3e-6


def test_zenith_phase_center_flat_phase():
    # Source exactly at the phase center -> visibilities are real positive.
    freqs = 150e6 + 1e5 * np.arange(8)
    inst = Instrument.build(np.array([[300.0, 200.0, 5.0]]), freqs,
                            latitude=-30.0)
    model = sm.SkyModel(location=[[15.0, -30.0]], spec_kind="power-law",
                        spec_parms={"flux-scale": np.array([4.0]),
                                    "freq-ref": np.array([150e6]),
                                    "power-law-index": np.array([0.0]),
                                    "flux-offset": np.array([0.0])})
    sky = SkySources.from_skymodel(model, freqs)
    lst = np.array([15.0])  # source at (ra=lst, dec=lat) = zenith
    obs = Observation(lst_deg=lst, jd=np.array([2457349.5]),
                      t_acc=np.array([10.0]),
                      pointing_altaz=np.array([[90.0, 270.0]]))
    beam_fn = lambda dc, f: jnp.ones((dc.shape[0], f.shape[0]))
    vis = np.asarray(simulate_drift(inst, sky, obs, beam_fn, src_block=64))
    assert np.max(np.abs(vis.imag)) < 4e-6 * 4.0
    assert np.allclose(vis.real, 4.0, atol=2e-5)


def test_thermal_noise_rms_and_stats():
    rms = thermal_noise_rms(154.0, 390625.0, 10.0, 200.0, nbl=2, nchan=3,
                            ntimes=1, xp=np)
    want = 2 * CNST.k_B / np.sqrt(10.0 * 390625.0) * (200.0 / 154.0) / CNST.Jy
    assert np.allclose(rms, want)
    # K units
    rms_k = thermal_noise_rms(154.0, 390625.0, 10.0, 200.0, flux_unit="K",
                              xp=np)
    assert np.allclose(rms_k, 200.0 / np.sqrt(10.0 * 390625.0))
    # Statistics: complex RMS ~ rms, split evenly between re/im.
    key = jax.random.PRNGKey(0)
    n = generate_noise(key, jnp.full((1000, 16, 1), 3.0))
    n = np.asarray(n)
    assert np.std(n.real) == pytest.approx(3.0 / np.sqrt(2), rel=0.02)
    assert np.sqrt(np.mean(np.abs(n) ** 2)) == pytest.approx(3.0, rel=0.02)
    # Determinism.
    n2 = np.asarray(generate_noise(key, jnp.full((1000, 16, 1), 3.0)))
    assert np.array_equal(n, n2)
