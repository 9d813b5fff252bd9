"""BASELINE.json config measurements (the reference configs #1-#5).

#1: HERA-7 hex snapshot - 64 chans, nside-64 diffuse sky, Airy beam.

#2: MWA-128-scale point-source catalog sim — 128-antenna array,
    256 chans, chromatic dipole beam, 10 accumulations.
#3: HERA-37 drift + thermal noise -> delay power spectrum with CLEAN
    (the full analysis stack on-device).
#4: HERA-331 chromatic FEKO external beam at north-star scale
    (nside-256 sky, 1024 chans, 100 accumulations).
#5: SKA-low-scale closure phases — 512 antennas, redundant triads
    through the bispectrum-phase pipeline.

    python benchmarks/bench_configs.py [1|2|3|4|5] [--small]

Each prints one JSON line with wall-clock and shape details. --small
shrinks for CPU smoke runs (the full sizes want the GPU). Configs that
write or read HDF5 products need h5py.
"""

import argparse
import json
import os
import tempfile
import time

import numpy as np


def config1(small=False):
    """HERA-7 hex snapshot (BASELINE config #1): 64 chans, nside-64
    diffuse (USM) sky, Airy beam — the smallest reference config,
    measured driver end-to-end. Dominated by fixed costs (compile +
    host-device round-trips), so it bounds the framework's minimum-job
    latency rather than throughput."""
    import shutil
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation

    nchan = 16 if small else 64
    nside = 16 if small else 64
    root = os.path.join(tempfile.gettempdir(), "bench_cfg1")
    shutil.rmtree(root, ignore_errors=True)
    parms = load_parms({
        "dirstruct": {"rootdir": root, "project": "hera7_snapshot"},
        "telescope": {"id": "hera", "latitude": -30.7224,
                      "A_eff": 154.0, "eff_Q": 0.96, "Trx": 100.0},
        "array": {"layout": "HERA-7", "redundant": True},
        "antenna": {"shape": "dish", "size": 14.0},
        "bandpass": {"freq": 150e6, "freq_resolution": 781250.0,
                     "nchan": nchan},
        "obsparm": {"obs_mode": "drift", "n_acc": 1, "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": nside},
        "save_formats": {"fmt": "HDF5", "npz": False},
    })
    t0 = time.perf_counter()
    vs, outdir = run_simulation(parms, verbose=False, save=True)
    dt = time.perf_counter() - t0
    assert np.isfinite(vs.skyvis).all()
    return dict(config="hera7-snapshot", nbl=vs.skyvis.shape[0],
                nchan=nchan, nside=nside, seconds=dt)


def config2(small=False):
    """MWA-128 catalog sim: the reference's config (dipole beams with
    ground plane, chromatic, point-source catalog, 10 acc). The MWA
    layout data file is not bundled (reference downloads it); a
    128-antenna random-uniform 1.5 km layout stands in — same baseline
    count and source regime."""
    import jax
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation
    from prisim_tpu.layouts import ArrayLayout
    from prisim_tpu import layouts as lay

    nant = 32 if small else 128
    nchan = 32 if small else 256
    nsrc = 256 if small else 4096
    n_acc = 2 if small else 10
    rng = np.random.default_rng(42)
    pos = np.zeros((nant, 3))
    pos[:, :2] = rng.uniform(-750, 750, (nant, 2))
    layout = ArrayLayout(positions=pos,
                         labels=np.asarray([f"A{i}" for i in range(nant)]))
    # register as a transient preset via layout file? run_simulation
    # accepts explicit positions through array.layout_positions
    loc = np.stack([rng.uniform(0, 360, nsrc),
                    rng.uniform(-80, 20, nsrc)], axis=-1)
    flux = rng.pareto(1.8, nsrc) + 0.05
    spindex = rng.normal(-0.83, 0.1, nsrc)
    import tempfile
    cat = tempfile.NamedTemporaryFile(suffix=".txt", delete=False,
                                      mode="w")
    cat.write("# ra dec flux spindex\n")
    for i in range(nsrc):
        cat.write(f"{loc[i,0]:.6f} {loc[i,1]:.6f} {flux[i]:.4f} "
                  f"{spindex[i]:.4f}\n")
    cat.close()
    parms = load_parms({
        "dirstruct": {"rootdir": tempfile.gettempdir(),
                      "project": "bench_cfg2"},
        "telescope": {"id": "mwa_dipole", "latitude": -26.7,
                      "A_eff": 21.0, "Trx": 50.0},
        "array": {"layout_positions": pos.tolist()},
        "antenna": {"shape": "dipole", "size": 0.74},
        "beam": {"use_external": False, "chromatic": True},
        "bandpass": {"freq": 150e6, "freq_resolution": 160e3,
                     "nchan": nchan},
        "obsparm": {"obs_mode": "drift", "n_acc": n_acc, "t_acc": 112.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "custom"},
        "catalog": {"custom_file": cat.name},
        "save_formats": {"fmt": "HDF5", "npz": False},
    })
    t0 = time.perf_counter()
    vs, _ = run_simulation(parms, verbose=False, save=False)
    dt = time.perf_counter() - t0
    assert np.isfinite(vs.skyvis).all()
    return dict(config="mwa128-catalog", seconds=dt, nant=nant,
                nbl=vs.skyvis.shape[0], nchan=nchan, nsrc=nsrc,
                n_acc=n_acc)


def config5(small=False):
    """512-antenna closure-phase pipeline at scale (BASELINE config #5):
    fully-redundant 16x32 grid (HIRAX/SKA-low-core analog), unique-
    baseline simulation, redundant-triad enumeration, closure phases,
    day binning (median), subband delay transform, xcpdps covariance."""
    import jax.numpy as jnp
    from prisim_tpu import layouts as lay, baselines as bls
    from prisim_tpu.skymodel import SkyModel
    from prisim_tpu.engine import (Instrument, SkySources)
    from prisim_tpu.engine.observe import simulate_drift, Observation
    from prisim_tpu.analysis.closure import (unique_triads_fast,
                                             triad_baseline_indices,
                                             closure_phases)
    from prisim_tpu.analysis.bispectrum import (ClosurePhaseData,
                                                cpds_ft, xcpdps_full)

    grid = [4, 8] if small else [16, 32]           # 32 / 512 antennas
    layout = lay.ArrayLayout(*_grid_positions(grid, spacing=7.0))
    bset = bls.build_baselines(layout, redundant=True)
    nchan = 16 if small else 128
    n_acc = 2 if small else 8
    max_classes = 64 if small else 512
    freqs = 150e6 + 100e3 * np.arange(nchan)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    rng = np.random.default_rng(1)
    nsrc = 128 if small else 1024
    loc = np.stack([rng.uniform(0, 360, nsrc),
                    rng.uniform(-75, 15, nsrc)], axis=-1)
    model = SkyModel(location=loc, spec_kind="power-law", spec_parms={
        "flux-scale": rng.uniform(0.5, 3.0, nsrc),
        "freq-ref": np.full(nsrc, 150e6),
        "power-law-index": np.full(nsrc, -0.8)})
    sky = SkySources.from_skymodel(model, freqs)

    t0 = time.perf_counter()
    lsts = (np.arange(n_acc) * 60.0 / 240.0) % 360.0
    obs = Observation(lst_deg=lsts, jd=np.full(n_acc, 2458000.0),
                      t_acc=np.full(n_acc, 60.0),
                      pointing_altaz=np.stack(
                          [np.full(n_acc, 90.0), np.zeros(n_acc)], -1),
                      mode="drift")
    beam_fn = lambda s, f: jnp.ones((s.shape[0], f.shape[0]),
                                    jnp.float32)
    vis = np.asarray(simulate_drift(inst, sky, obs, beam_fn,
                                    src_block=1024))
    t_sim = time.perf_counter() - t0

    # redundant-triad enumeration + closure phases over unique classes
    t0 = time.perf_counter()
    triads = unique_triads_fast(layout.labels, layout.positions,
                                max_classes=max_classes)
    idx, conj = triad_baseline_indices(
        bset.labels, triads, baselines=bset.vectors,
        ant_positions=layout.positions, ant_labels=layout.labels)
    vis_bct = np.ascontiguousarray(np.transpose(vis, (1, 2, 0)))
    cp, _ = closure_phases(vis_bct, idx, conj)   # (ntri, nchan, nacc)
    t_cp = time.perf_counter() - t0

    # bispectrum-phase pipeline: (nlst, ndays, ntriads, nchan)
    t0 = time.perf_counter()
    ntri = cp.shape[0]
    cp4 = np.transpose(cp, (2, 0, 1))[:, None, :, :]     # (nlst,1,t,c)
    ndays = 4
    cp4 = np.repeat(cp4, ndays, axis=1)
    cp4 = cp4 + 0.01 * np.random.default_rng(2).normal(size=cp4.shape)
    cpd = ClosurePhaseData(cp=cp4, wts=np.ones(cp4.shape), freqs=freqs,
                           lst=lsts / 15.0,
                           days=2458000.0 + np.arange(ndays,
                                                      dtype=float),
                           triads=np.asarray(triads))
    sm_cpd = cpd.smooth_in_tbins(daybinsize=2.0, stat="median")
    ft = cpds_ft(sm_cpd.eicp * sm_cpd.wts, sm_cpd.wts, freqs,
                 freq_center=[152e6], bw_eff=2e6, pad=1.0)
    ps = xcpdps_full(ft, cohax=(2,), incohax=(1, 3),
                     collapse_axes=(3,), lst_shifts=np.arange(2))
    t_ps = time.perf_counter() - t0
    return dict(config="closure-512", nant=layout.positions.shape[0],
                nbl_unique=bset.nbl, ntriads=int(ntri), nchan=nchan,
                n_acc=n_acc, sim_seconds=t_sim, closure_seconds=t_cp,
                xcpdps_seconds=t_ps,
                P_shape=list(np.asarray(ps["P"]).shape))


def config3(small=False):
    """HERA-37 drift scan + thermal noise -> delay power spectrum
    (BASELINE config #3): driver end-to-end with noise to a
    reference-schema HDF5, then the `tools delay-ps` pipeline with
    delay-CLEAN on — the one config exercising the analysis stack
    (DelaySpectrum.delayClean / DelayPowerSpectrum.compute_power_spectrum,
    /root/reference/prisim/delay_spectrum.py:1622,3982) on-device at
    scale."""
    import shutil
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation
    from prisim_tpu.tools import delay_ps

    nchan = 32 if small else 256
    nside = 16 if small else 128
    n_acc = 2 if small else 10
    root = os.path.join(tempfile.gettempdir(), "bench_cfg3")
    shutil.rmtree(root, ignore_errors=True)
    parms = load_parms({
        "dirstruct": {"rootdir": root, "project": "hera37_dps"},
        "telescope": {"id": "hera", "latitude": -30.7224,
                      "A_eff": 154.0, "eff_Q": 0.96, "Trx": 100.0},
        "array": {"layout": "HERA-37", "redundant": True},
        "antenna": {"shape": "dish", "size": 14.0},
        "bandpass": {"freq": 150e6, "freq_resolution": 390625.0,
                     "nchan": nchan},
        "obsparm": {"obs_mode": "drift", "n_acc": n_acc,
                    "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": nside},
        "save_formats": {"fmt": "HDF5", "npz": False},
    })
    t0 = time.perf_counter()
    vs, outdir = run_simulation(parms, verbose=False, save=True)
    t_sim = time.perf_counter() - t0
    import os
    simfile = os.path.join(outdir, "simdata", "simvis.hdf5")
    t0 = time.perf_counter()
    dps = delay_ps(simfile, os.path.join(root, "delay_ps.hdf5"),
                   pad=1.0, nside_beam=32, clean=True,
                   gain=0.1, maxiter=100 if small else 200,
                   threshold=5e-3)
    t_ps = time.perf_counter() - t0
    assert np.isfinite(np.asarray(dps["skyvis"])).all()
    assert "cc_skyvis_ps" in dps
    return dict(config="hera37-drift-dps", nbl=vs.skyvis.shape[0],
                nchan=nchan, nside=nside, n_acc=n_acc,
                sim_seconds=t_sim, delay_ps_seconds=t_ps,
                noise_rms=float(np.std(np.asarray(vs.vis_noise).real)))


def _write_synthetic_feko(path, freqs_hz, ntheta=91, nphi=73,
                          d_eff=14.0):
    """Synthesize a FEKO far-field text export: per-frequency
    '#Frequency' blocks over a (theta, phi) grid with gain dB in the
    last column. The pattern is a chromatic tapered-aperture power
    beam with a mild phi-dependent ellipticity — structure enough to
    exercise the spline + chromatic interpolation paths
    (scripts/FEKO_beam_to_healpix.py input format)."""
    from prisim_tpu import constants as CNST
    theta = np.linspace(0.0, 90.0, ntheta)
    phi = np.linspace(0.0, 360.0, nphi)
    with open(path, "w") as f:
        for nu in freqs_hz:
            f.write('#Request Name: FarField\n')
            f.write('#Frequency: %.1f\n' % nu)
            f.write('#No. of Theta Samples: %d\n' % ntheta)
            f.write('#No. of Phi Samples: %d\n' % nphi)
            f.write('#  "Theta" "Phi" "Gain(Total)"\n')
            tt = np.radians(theta)[:, None]
            pp = np.radians(phi)[None, :]
            # elliptical gaussian-in-sin(theta) beam, width ~ lambda/D
            sig0 = 0.42 * CNST.c / (nu * d_eff)
            sx = sig0 * 1.08
            sy = sig0 * 0.94
            st = np.sin(tt)
            arg = ((st * np.cos(pp)) / sx) ** 2 \
                + ((st * np.sin(pp)) / sy) ** 2
            gdb = -10.0 * arg / np.log(10.0)
            # first sidelobe-ish ripple so the spline has structure
            gdb = gdb + 3.0 * np.sin(4.0 * st / sig0) ** 2 \
                * np.exp(-0.5 * arg) * 0.05
            for j in range(nphi):
                for i in range(ntheta):
                    f.write("%.4f %.4f %.6f\n"
                            % (theta[i], phi[j], gdb[i, j]))
    return path


def config4(small=False):
    """HERA-331 chromatic FEKO external-beam sim at north-star scale
    (BASELINE config #4): synthetic FEKO text export -> `tools
    feko2hpx` (spline, chromatic multi-frequency) -> external-beam
    driver path, nside-256 sky x 1024 chans x 100 accumulations
    (reference flow: scripts/FEKO_beam_to_healpix.py ->
    run_prisim.py:1897-1912 external pbinfo)."""
    import os
    import shutil
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation
    from prisim_tpu.tools import feko_to_healpix

    nchan = 64 if small else 1024
    nside = 16 if small else 256
    n_acc = 2 if small else 100
    beam_nside = 16 if small else 64
    root = os.path.join(tempfile.gettempdir(), "bench_cfg4")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root, exist_ok=True)
    t0 = time.perf_counter()
    feko_txt = _write_synthetic_feko(
        os.path.join(root, "feko_beam.txt"),
        freqs_hz=np.linspace(100e6, 200e6, 3 if small else 8))
    beam_h5 = os.path.join(root, "feko_beam.hdf5")
    feko_to_healpix(feko_txt, beam_h5, nside=beam_nside,
                    interp="spline")
    t_beam = time.perf_counter() - t0
    parms = load_parms({
        "dirstruct": {"rootdir": root, "project": "hera331_feko"},
        "telescope": {"id": "hera", "latitude": -30.7224,
                      "A_eff": 154.0, "eff_Q": 0.96, "Trx": 100.0},
        "array": {"layout": "HERA-331", "redundant": True},
        "antenna": {"shape": "dish", "size": 14.0},
        "beam": {"use_external": True, "file": beam_h5,
                 "chromatic": True},
        "bandpass": {"freq": 150e6, "freq_resolution": 97656.25,
                     "nchan": nchan},
        "obsparm": {"obs_mode": "drift", "n_acc": n_acc,
                    "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": nside},
        "save_formats": {"fmt": "HDF5", "npz": False},
    })
    t0 = time.perf_counter()
    vs, outdir = run_simulation(parms, verbose=True, save=True)
    t_sim = time.perf_counter() - t0
    assert np.isfinite(vs.skyvis).all()
    return dict(config="hera331-feko-northstar",
                nbl=vs.skyvis.shape[0], nchan=nchan, nside_sky=nside,
                nside_beam=beam_nside, n_acc=n_acc,
                beam_convert_seconds=t_beam, sim_seconds=t_sim)


def _grid_positions(shape, spacing=7.0):
    ny, nx = shape
    xs, ys = np.meshgrid(np.arange(nx), np.arange(ny))
    pos = np.zeros((nx * ny, 3))
    pos[:, 0] = xs.ravel() * spacing
    pos[:, 1] = ys.ravel() * spacing
    labels = np.asarray([str(i) for i in range(nx * ny)])
    return pos, labels


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("which", choices=["1", "2", "3", "4", "5"])
    ap.add_argument("--small", action="store_true")
    args = ap.parse_args()
    fn = {"1": config1, "2": config2, "3": config3,
          "4": config4, "5": config5}[args.which]
    rec = fn(args.small)
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
