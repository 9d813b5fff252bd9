"""On-card smoke check: prisim_tpu's main path on one NVIDIA GPU.

    python chip_smoke.py            # one card: phases 1-3
    python chip_smoke.py --mesh4    # four cards: the mesh decompositions

Phases (one process; any failure raises and exits non-zero):

1. Device report: JAX's platform, device kind and count, the card's name
   and power limit from nvidia-smi, the JAX version, the compile-cache
   directory, and whether h5py and yaml import. Exits non-zero when JAX
   finds no GPU.
2. Every visibility engine at the headline snapshot shape (HERA-37
   all-pairs: 666 baselines x 1024 channels x the 49,152-pixel nside-64
   sky), compiled for the card: memory analysis, warm seconds per
   snapshot, peak device bytes, and the error against the float64
   reference on a baseline x channel slice over all sources, relative to
   the coherent flux scale max_c sum_s |A_sc|.
3. The driver end to end on prisim_tpu/examples/simparms/
   hera331_northstar.yaml (HERA-331 redundant, 1024 channels, nside 256)
   with n_acc cut to 2: product written, read back and compared, and
   snapshot 0 checked against the float64 reference.

--mesh4 runs the phase-3 configuration with pp.key bl, freq and src on
four cards and compares each with pp.key none on one card.

The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NORTHSTAR = os.path.join(HERE, "prisim_tpu", "examples", "simparms",
                         "hera331_northstar.yaml")
# tolerances relative to the coherent flux scale max_c sum_s |A_sc|
TOL_DIRECT = 2e-6        # direct and banded engines
TOL_SORTED = 1e-4        # sorted spread: its own driver gate tolerance
N_ACC = 2                # phase 3's cut of the flagship's 100


def log(msg=""):
    print(msg, flush=True)


def module_imports(name):
    try:
        __import__(name)
        return True
    except ImportError:
        return False


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------

def device_report():
    """Print the device lines; raise SystemExit unless JAX runs on a GPU.
    Returns {'platform', 'kind', 'count', 'h5py', 'yaml'}."""
    import jax
    from prisim_tpu.utils import enable_compilation_cache
    devs = jax.devices()
    d0 = devs[0]
    log("[device] jax %s: platform=%s kind=%s count=%d"
        % (jax.__version__, d0.platform, d0.device_kind, len(devs)))
    if d0.platform != "gpu":
        raise SystemExit("chip_smoke: JAX found no GPU (platform %s)"
                         % d0.platform)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    log("[device] nvidia-smi --query-gpu=name,power.limit:")
    for line in smi.stdout.strip().splitlines():
        log(line.strip())
    log("[device] compile cache: %s" % enable_compilation_cache())
    rep = dict(platform=d0.platform, kind=d0.device_kind, count=len(devs),
               h5py=module_imports("h5py"), yaml=module_imports("yaml"))
    log("[device] imports: h5py=%s yaml=%s" % (rep["h5py"], rep["yaml"]))
    return rep


# --------------------------------------------------------------------------
# shared checks
# --------------------------------------------------------------------------

def compare(name, got, ref, scale, tol):
    """max |got - ref| / scale, raising AssertionError beyond tol or on
    a shape mismatch or non-finite values."""
    got = np.asarray(got)
    ref = np.asarray(ref)
    if got.shape != ref.shape:
        raise AssertionError("%s: shape %s != reference %s"
                             % (name, got.shape, ref.shape))
    if not np.all(np.isfinite(got)):
        raise AssertionError("%s: non-finite values" % name)
    rel = float(np.abs(got - ref).max() / scale)
    log("[check] %s: max|V - V_f64| / coherent scale = %.3e "
        "(tolerance %.0e, %s slice)" % (name, rel, tol,
                                        "x".join(map(str, ref.shape))))
    if not rel <= tol:
        raise AssertionError("%s: error %.3e exceeds %.0e"
                             % (name, rel, tol))
    return rel


def reference_slice(s_eff, bl, amps_cols, freqs_cols, chunk=65536):
    """float64 NUDFT over all sources for the given baselines and the
    channels whose f32 amps are amps_cols (S, c), summed in source
    chunks to bound host memory."""
    from prisim_tpu.engine.nudft import nudft_reference_f64
    out = 0.0
    for s0 in range(0, s_eff.shape[0], chunk):
        out = out + nudft_reference_f64(s_eff[s0:s0 + chunk], bl,
                                        amps_cols[s0:s0 + chunk],
                                        freqs_cols)
    return out


def slice_indices(nbl, nchan, n_b=8, n_c=64):
    """Baselines spread over the list (first and last included) and
    channels spread over the band."""
    return (np.unique(np.linspace(0, nbl - 1, min(n_b, nbl)).astype(int)),
            np.unique(np.linspace(0, nchan - 1,
                                  min(n_c, nchan)).astype(int)))


def snapshot_reference(inst, sky, beam_fn, rot, bsel, csel):
    """f64 reference of one snapshot on the (bsel, csel) slice, fed the
    engines' own f32 amps. Returns (reference, coherent scale)."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine.observe import df_rotate3, _beam_and_flux

    freqs_f32 = jnp.asarray(inst.freqs, jnp.float32)

    @jax.jit
    def inputs(seqh, seql, flux, mh, ml, ph, pl):
        sh, sl = df_rotate3(mh, ml, seqh, seql)
        seh, sel = tf.df_add(sh, sl, -ph[None, :], -pl[None, :])
        amps = _beam_and_flux(sh, flux, freqs_f32, beam_fn, pc=ph)
        return (seh, sel, amps[:, jnp.asarray(csel)],
                jnp.max(jnp.sum(jnp.abs(amps), axis=0)))

    seh, sel, cols, scale = inputs(sky.s_eq_hi, sky.s_eq_lo, sky.flux,
                                   *rot)
    s_eff = tf.join_f64(seh, sel)
    bl = tf.join_f64(inst.bl_hi, inst.bl_lo)[bsel]
    ref = reference_slice(s_eff, bl, np.asarray(cols),
                          np.asarray(inst.freqs)[csel])
    return ref, float(scale)


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------

def headline_problem(layout="HERA-37", nchan=1024, nside=64):
    """The headline snapshot: all-pairs baselines of `layout`, `nchan`
    channels of 97.65625 kHz from 100 MHz, every pixel of an nside sky
    with power-law spectra (made from seed 0), a 14 m Airy beam."""
    import jax.numpy as jnp
    from prisim_tpu import baselines as bls
    from prisim_tpu import healpix as hp
    from prisim_tpu import layouts as lay
    from prisim_tpu import skymodel as sm
    from prisim_tpu import twofloat as tf
    from prisim_tpu.beams import airy_beam
    from prisim_tpu.engine import (Instrument, SkySources,
                                   enu_rotation_from_eq)

    bset = bls.build_baselines(lay.preset_layout(layout), redundant=False)
    freqs = 100e6 + 97656.25 * np.arange(nchan)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    rng = np.random.default_rng(0)
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    loc = np.stack([np.degrees(phi), 90.0 - np.degrees(theta)], axis=-1)
    nsrc = loc.shape[0]
    model = sm.SkyModel(location=loc, spec_kind="power-law", spec_parms={
        "flux-scale": rng.uniform(0.1, 10.0, nsrc),
        "freq-ref": np.full(nsrc, 150e6),
        "power-law-index": np.full(nsrc, -0.8),
        "flux-offset": np.zeros(nsrc)})
    sky = SkySources.from_skymodel(model, freqs)
    Mh, Ml = tf.split_f64(enu_rotation_from_eq(30.0, inst.latitude))
    pch, pcl = tf.split_f64(np.array([0.0, 0.0, 1.0]))
    rot = tuple(jnp.asarray(a) for a in (Mh, Ml, pch, pcl))

    def beam_fn(s, f):
        return airy_beam(s, f, 14.0)

    return dict(inst=inst, sky=sky, beam_fn=beam_fn, rot=rot,
                vectors=np.asarray(bset.vectors), freqs=freqs)


def engine_programs(p, names):
    """name -> (jitted program, its arguments, tolerance) for one
    snapshot of problem p; each program returns (B, C) complex64."""
    import jax
    from prisim_tpu.engine import SkySources
    from prisim_tpu.engine.nufft_banded import (make_banded_plan,
                                                make_banded_snapshot_fns)
    from prisim_tpu.engine.nufft_delay import (chebyshev_projection,
                                               simulate_snapshot_nufft_jit)
    from prisim_tpu.engine.observe import simulate_snapshot

    inst, sky, beam_fn = p["inst"], p["sky"], p["beam_fn"]
    sky_args = (sky.s_eq_hi, sky.s_eq_lo, sky.flux)
    freqs = p["freqs"]
    frac_bw = (freqs[-1] - freqs[0]) / freqs[freqs.size // 2]
    rank = min(16 if frac_bw <= 0.4 else 32, max(2, freqs.size // 2))
    pinvQ, Q = chebyshev_projection(freqs, rank)

    def sky_of(seqh, seql, flux):
        return SkySources(s_eq_hi=seqh, s_eq_lo=seql, flux=flux)

    progs = {}
    for name in names:
        if name in ("direct-xla", "direct-pallas"):
            def direct(seqh, seql, flux, mh, ml, ph, pl,
                       _pallas=name == "direct-pallas"):
                return simulate_snapshot(inst, sky_of(seqh, seql, flux),
                                         mh, ml, ph, pl, beam_fn,
                                         use_pallas=_pallas)
            progs[name] = (jax.jit(direct), sky_args + p["rot"],
                           TOL_DIRECT)
        elif name == "nufft-sorted":
            def sorted_(seqh, seql, flux, mh, ml, ph, pl):
                return simulate_snapshot_nufft_jit(
                    inst, sky_of(seqh, seql, flux), mh, ml, ph, pl,
                    beam_fn, pinvQ, Q, spread="sorted")
            progs[name] = (jax.jit(sorted_), sky_args + p["rot"],
                           TOL_SORTED)
        elif name == "banded":
            plan = make_banded_plan(p["vectors"], inst.nu0, inst.dnu,
                                    freqs.size, rank=rank)
            run = make_banded_snapshot_fns(inst, sky, beam_fn, plan,
                                           pinvQ, Q)
            prog = run.program

            def banded(*a, _prog=prog):
                return _prog(*a)[0]
            progs[name] = (jax.jit(banded),
                           p["rot"] + run.program_args, TOL_DIRECT)
        else:
            raise ValueError("unknown engine %r" % name)
    return progs


def time_program(compiled, args, repeats=3):
    out = compiled(*args)
    out.block_until_ready()
    t0 = time.perf_counter()
    for _ in range(repeats):
        out = compiled(*args)
    out.block_until_ready()
    return out, (time.perf_counter() - t0) / repeats


def engines_phase(names, problem=None, repeats=3):
    """Compile, time and check each engine; returns name -> record."""
    import jax
    from prisim_tpu.diagnostics import all_highest, dot_precisions
    p = problem or headline_problem()
    inst = p["inst"]
    B, C, S = inst.nbl, inst.nchan, p["sky"].flux.shape[0]
    log("[engines] snapshot %d baselines x %d channels x %d sources"
        % (B, C, S))
    bsel, csel = slice_indices(B, C)
    ref, scale = snapshot_reference(inst, p["sky"], p["beam_fn"], p["rot"],
                                    bsel, csel)
    out = {}
    for name, (prog, args, tol) in engine_programs(p, names).items():
        highest = all_highest(dot_precisions(prog, *args))
        t0 = time.perf_counter()
        compiled = prog.lower(*args).compile()
        t_compile = time.perf_counter() - t0
        log("[engines] %s: compiled in %.1f s; memory_analysis: %s"
            % (name, t_compile, compiled.memory_analysis()))
        vis, dt = time_program(compiled, args, repeats)
        stats = jax.devices()[0].memory_stats() or {}
        log("[engines] %s: %.6f s per snapshot (warm, mean of %d); "
            "peak_bytes_in_use %s" % (name, dt, repeats,
                                      stats.get("peak_bytes_in_use")))
        if not highest:
            raise AssertionError("%s: an f32 contraction runs below "
                                 "Precision.HIGHEST" % name)
        got = np.asarray(vis)[np.ix_(bsel, csel)]
        rel = compare("%s (every f32 contraction at HIGHEST)" % name, got,
                      ref, scale, tol)
        out[name] = dict(seconds=dt, rel=rel, compile_seconds=t_compile)
    return out


# --------------------------------------------------------------------------
# phase 3
# --------------------------------------------------------------------------

def northstar_parms(n_acc=N_ACC):
    from prisim_tpu.config import load_parms
    parms = load_parms(NORTHSTAR)
    log("[driver] reduced: obsparm.n_acc %d -> %d (all widths as "
        "published: HERA-331 redundant, %d channels, nside %d)"
        % (parms["obsparm"]["n_acc"], n_acc, parms["bandpass"]["nchan"],
           parms["skyparm"]["nside"]))
    parms["obsparm"]["n_acc"] = n_acc
    return parms


def driver_inputs(parms):
    """The instrument, sky, beam and snapshot-0 rotation the driver
    builds for a plain drift run (pol X, no sectors, no ROI cut), from
    its own builders."""
    import jax.numpy as jnp
    from prisim_tpu import driver as drv
    from prisim_tpu import geometry as geom
    from prisim_tpu import twofloat as tf
    from prisim_tpu.baselines import build_baselines
    from prisim_tpu.beams.dispatch import primary_beam
    from prisim_tpu.engine import Instrument, SkySources

    tp = parms["telescope"]
    lat = float(tp["latitude"])
    blp = parms.get("baseline") or {}
    bls = build_baselines(drv.build_layout(parms),
                          redundant=bool(parms["array"].get("redundant",
                                                            True)),
                          min_length=blp.get("min"),
                          max_length=blp.get("max"),
                          direction_deg=blp.get("direction"))
    freqs = drv.build_frequencies(parms)
    obs = drv.build_schedule(parms, lat)
    sky = drv.precess_sky_to_obs_epoch(drv.build_sky(parms, freqs), parms,
                                       obs)
    ant = parms["antenna"]
    telescope = {"id": tp.get("id", "custom"),
                 "shape": ant.get("shape", "dish"),
                 "size": ant.get("size", 14.0),
                 "ocoords": ant.get("ocoords", "altaz"),
                 "orientation": ant.get("orientation", [90.0, 270.0]),
                 "groundplane": ant.get("ground_plane")}
    if telescope["ocoords"] == "altaz":
        ori = np.asarray(telescope["orientation"], np.float64)
        telescope["orientation_dircos"] = tuple(
            geom.altaz2dircos(ori.reshape(1, 2), xp=np)[0])
    inst = Instrument.build(bls.vectors, freqs, latitude=lat)

    def beam_fn(dircos, f):
        return primary_beam(dircos, f, telescope, pol="X")

    Mh, Ml = obs.rotations(lat)
    pch, pcl = tf.split_f64(obs.pc_dircos())
    rot = tuple(jnp.asarray(a[0]) for a in (Mh, Ml, pch, pcl))
    return inst, SkySources.from_skymodel(sky, freqs), beam_fn, rot


def driver_phase(parms, formats):
    """run_simulation on parms with products saved, read back and
    compared; snapshot 0 checked against the f64 reference."""
    from prisim_tpu.driver import run_simulation
    from prisim_tpu.io import load_hdf5, load_npz
    parms["save_formats"] = dict(parms["save_formats"],
                                 fmt="HDF5" if formats["h5py"] else "none",
                                 npz=not formats["h5py"])
    outdir = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t0 = time.perf_counter()
        vs, path = run_simulation(parms, outdir=outdir, verbose=True,
                                  save=True)
        log("[driver] run_simulation: %.1f s wall-clock"
            % (time.perf_counter() - t0))
        base = os.path.join(path, "simdata", "simvis")
        back = (load_hdf5(base + ".hdf5") if formats["h5py"]
                else load_npz(base + ".npz"))
        for attr in ("skyvis", "vis", "vis_noise"):
            if not np.array_equal(np.asarray(getattr(back, attr)),
                                  np.asarray(getattr(vs, attr))):
                raise AssertionError("product %s read back differs" % attr)
        log("[driver] product %s.%s written and read back equal "
            "(skyvis, vis, vis_noise %s)"
            % (base, "hdf5" if formats["h5py"] else "npz",
               np.asarray(vs.skyvis).shape))
    finally:
        shutil.rmtree(outdir, ignore_errors=True)
    inst, sky, beam_fn, rot = driver_inputs(parms)
    bsel, csel = slice_indices(inst.nbl, inst.nchan)
    ref, scale = snapshot_reference(inst, sky, beam_fn, rot, bsel, csel)
    got = np.asarray(vs.skyvis)[:, :, 0][np.ix_(bsel, csel)]
    compare("driver snapshot 0", got, ref, scale, TOL_DIRECT)
    return vs


# --------------------------------------------------------------------------
# --mesh4
# --------------------------------------------------------------------------

def mesh_phase(parms, keys=("bl", "freq", "src")):
    """Each pp.key decomposition over all devices vs pp.key none on one
    device, same process; also checks that every mesh the driver builds
    spans every device."""
    import copy
    import jax
    from prisim_tpu.driver import run_simulation
    from prisim_tpu.parallel.mesh import make_mesh

    ndev = len(jax.devices())
    shapes = {"bl": (("bl", "chan"), (ndev, 1)),
              "freq": (("bl", "chan"), (1, ndev)),
              "src": (("bl", "chan", "src"), (1, 1, ndev))}
    for key in keys:
        mesh = make_mesh(axis_names=shapes[key][0], shape=shapes[key][1])
        if set(mesh.devices.flat) != set(jax.devices()):
            raise AssertionError("pp.key %s: mesh leaves devices out" % key)
    log("[mesh] %d devices: %s" % (ndev, jax.devices()))
    inst, sky, beam_fn, rot = driver_inputs(parms)
    _, scale = snapshot_reference(inst, sky, beam_fn, rot, [0], [0])

    def run(key):
        p2 = copy.deepcopy(parms)
        p2["pp"]["key"] = key
        t0 = time.perf_counter()
        vs, _ = run_simulation(p2, verbose=False, save=False)
        log("[mesh] pp.key %s: %.1f s wall-clock"
            % (key, time.perf_counter() - t0))
        return np.asarray(vs.skyvis)

    base = run("none")
    for key in keys:
        compare("pp.key %s vs none" % key, run(key), base, scale,
                TOL_DIRECT)
    # the sharded engine's output really is spread over every device
    from prisim_tpu.parallel.mesh import simulate_drift_sharded
    from prisim_tpu.engine.observe import Observation
    mesh = make_mesh(axis_names=("bl", "chan"), shape=(ndev, 1))
    obs = Observation(lst_deg=np.asarray([0.0]),
                      jd=np.asarray([2458000.5]), t_acc=np.asarray([60.0]),
                      pointing_altaz=np.asarray([[90.0, 270.0]]))
    vis = simulate_drift_sharded(inst, sky, obs, beam_fn, mesh)
    shard_devs = {s.device for s in vis.addressable_shards}
    if shard_devs != set(jax.devices()):
        raise AssertionError("sharded output on %d of %d devices"
                             % (len(shard_devs), ndev))
    log("[mesh] sharded output spans all %d devices" % ndev)


# --------------------------------------------------------------------------

ENGINES = ("direct-xla", "direct-pallas", "nufft-sorted", "banded")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mesh4", action="store_true",
                    help="four-card mesh decompositions vs one card")
    args = ap.parse_args(argv)
    rep = device_report()
    if args.mesh4:
        if rep["count"] != 4:
            raise SystemExit("--mesh4 needs 4 devices, found %d"
                             % rep["count"])
        mesh_phase(northstar_parms())
    else:
        engines_phase(ENGINES)
        driver_phase(northstar_parms(), rep)
    print(json.dumps({"ok": True, "device": {
        "platform": rep["platform"], "kind": rep["kind"],
        "count": rep["count"]}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
