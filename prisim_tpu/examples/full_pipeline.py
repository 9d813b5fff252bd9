"""End-to-end example: simulate -> export -> delay power spectrum ->
closure phases.

Runnable demonstration of the whole stack, the workflow a user of the
reference drives via run_prisim.py + the DelaySpectrum/ClosurePhase
classes (/root/reference/prisim/scripts/run_prisim.py,
/root/reference/prisim/delay_spectrum.py:3260,
/root/reference/prisim/bispectrum_phase.py:1497):

    python -m prisim_tpu.examples.full_pipeline [outdir]

Runs in ~1 minute on CPU at the default (tiny) size; scale the YAML
knobs up for real work. On an NVIDIA GPU the driver routes the
visibility hot loop as processing.use_pallas says (auto: the Pallas
kernel where it compiles).
"""

from __future__ import annotations

import os
import sys
import tempfile

import numpy as np


def main(outdir=None, verbose=True):
    from prisim_tpu import config, driver, tools
    from prisim_tpu.io import load_hdf5
    from prisim_tpu.analysis.closure import closure_phases_vs

    if outdir is None:
        outdir = tempfile.mkdtemp(prefix="prisim_tpu_example_")
    here = os.path.dirname(__file__)
    parms = config.load_parms(os.path.join(here, "simparms",
                                           "hera19_random.yaml"))
    parms["dirstruct"]["rootdir"] = outdir
    parms["dirstruct"]["project"] = "full_pipeline"

    # 1. simulate (noiseless sky visibilities + thermal noise, all
    #    products written under <rootdir>/<project>/<simid>/)
    vs, simdir = driver.run_simulation(parms, verbose=verbose)
    base = os.path.join(simdir, "simdata", "simvis")
    sim_h5 = base + ".hdf5"
    if verbose:
        print("simulated %d baselines x %d channels x %d accumulations"
              % (vs.nbl, vs.nchan, vs.n_acc))
        print("products:", sorted(os.listdir(os.path.dirname(base))))

    # 2. delay power spectrum in K^2 (Mpc/h)^3 (one command; CLEANs the
    #    foregrounds and normalizes with the analytic HERA beam volume)
    dps_path = os.path.join(outdir, "dps.hdf5")
    dps = tools.delay_ps(sim_h5, dps_path, nside_beam=16, clean=True,
                         maxiter=50)
    if verbose:
        kp = np.asarray(dps["kprll"])
        pk = np.asarray(dps["skyvis"])       # (nbl, nlag, nacc)
        print("delay PS: z=%.2f, k_parallel in [%.3f, %.3f] h/Mpc, "
              "peak P(k)=%.3e K^2 (Mpc/h)^3"
              % (dps["z"], kp.min(), kp.max(), pk.max()))

    # 3. closure phases on all unique antenna triads
    sim = load_hdf5(sim_h5)
    cl = closure_phases_vs(sim)                 # unique triads by default
    cp = np.asarray(cl["closure_phase_skyvis"])  # (ntri, nchan, nacc)
    if verbose:
        print("closure phases: %d unique triads, rms %.3f rad"
              % (len(cl["triads"]), float(np.std(cp))))

    # 4. round-trip check through the UVFITS export
    from prisim_tpu.io.uvfits import load_uvfits
    # the export expands unique baselines onto the full redundant set
    # (save_redundant) and writes the noiseless cube by default, so match
    # rows by antenna-pair label and compare against skyvis
    back = load_uvfits(base + ".uvfits")     # single data cube -> skyvis
    sent = np.asarray(sim.skyvis)
    where = {tuple(p): i
             for i, p in enumerate(np.asarray(back.labels, dtype=str))}
    rows = [where[tuple(p)] for p in np.asarray(sim.labels, dtype=str)]
    got = np.asarray(back.skyvis)[rows]
    resid = np.max(np.abs(got - sent))
    scale = np.max(np.abs(sent))
    if verbose:
        print("UVFITS round trip: max |dV| = %.2e (%.1e relative)"
              % (resid, resid / scale))
    assert resid / scale < 1e-5
    return dict(vs=vs, simdir=simdir, dps=dps, closure=cp, outdir=outdir)


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
