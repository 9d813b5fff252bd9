"""Benchmark: NUDFT complex MACs/sec/chip on an NVIDIA GPU.

Runs the HERA-37 headline snapshot — 666 all-pairs baselines x 1024
channels x a 49,152-pixel (nside-64) sky — through the direct engine the
driver picks (the Pallas kernel where it compiles, else XLA), the XLA
direct engine and the banded NUFFT engine, and compares with a measured
CPU throughput of the reference's inner loop (phase_matrix =
exp(-2 pi i tau nu); skyvis = sum over sources — the float64 numpy
formulation of the reference's prisim/interferometry.py:6355-6376) timed
on a scaled-down problem.

    python bench.py

Fails when JAX finds no GPU. Prints the device (platform, kind, count,
card name and power limit) on earlier lines and ONE JSON line last:
{"metric", "value", "unit", "vs_baseline", "detail"}.
"""

import json
import time

import numpy as np

import chip_smoke as cs


def _gpu_macs_per_sec(repeats=3):
    """Seconds per headline snapshot of each engine; the fastest that
    agrees with the XLA direct engine sets the rate."""
    p = cs.headline_problem()
    inst = p["inst"]
    nbl, nchan = inst.nbl, inst.nchan
    nsrc = int(p["sky"].flux.shape[0])
    from prisim_tpu.engine.pallas_nudft import pallas_available
    names = ["direct-xla", "banded"]
    if pallas_available():
        names.insert(1, "direct-pallas")
    results, outputs = {}, {}
    for name, (prog, args, _) in cs.engine_programs(p, names).items():
        compiled = prog.lower(*args).compile()
        vis, results[name] = cs.time_program(compiled, args, repeats)
        outputs[name] = np.asarray(vis)
    ref = outputs["direct-xla"]
    agree = {k: float(np.abs(v - ref).max() / np.abs(ref).max())
             for k, v in outputs.items()}
    timed = {k: v for k, v in results.items() if agree[k] < 1e-4}
    best = min(timed, key=timed.get)
    dt = timed[best]
    macs = float(nsrc) * nbl * nchan
    return macs / dt, dt, dict(nbl=nbl, nchan=nchan, nsrc=nsrc,
                               kernel=best, per_kernel_seconds=results,
                               agreement_vs_xla=agree)


def _cpu_reference_macs_per_sec(nsrc=1024, nbl=666, nchan=128):
    """Reference-style float64 numpy inner loop, timed on a small slab."""
    from prisim_tpu import constants as CNST
    rng = np.random.default_rng(1)
    s = rng.normal(size=(nsrc, 3))
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    bl = rng.uniform(-200, 200, (nbl, 3))
    freqs = 100e6 + 97656.25 * np.arange(nchan)
    amps = rng.uniform(0.1, 10.0, (nsrc, nchan))
    tau = s @ bl.T / CNST.c
    t0 = time.perf_counter()
    phase = 2.0 * np.pi * tau[:, :, None] * freqs[None, None, :]
    vis = np.sum(amps[:, None, :] * np.exp(-1j * phase), axis=0)
    dt = time.perf_counter() - t0
    del vis
    return (nsrc * nbl * nchan) / dt


def _end_to_end_seconds(nchan=256, n_acc=2, nside=64):
    """Driver-inclusive wall-clock: config -> sim -> noise -> gains ->
    product save, the whole product path (not just the kernel). HERA-37
    drift scan, `nchan` channels, nside-`nside` USM sky, `n_acc`
    accumulations with thermal noise."""
    import shutil
    import tempfile
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation
    h5 = cs.module_imports("h5py")
    tmp = tempfile.mkdtemp(prefix="prisim_bench_")
    parms = load_parms({
        "dirstruct": {"rootdir": tmp, "project": "bench_e2e"},
        "telescope": {"id": "hera", "latitude": -30.72,
                      "A_eff": 154.0, "Trx": 100.0},
        "array": {"layout": "HERA-37", "redundant": False},
        "antenna": {"shape": "dish", "size": 14.0},
        "bandpass": {"freq": 150e6, "freq_resolution": 781250.0,
                     "nchan": nchan},
        "obsparm": {"obs_mode": "drift", "n_acc": n_acc, "t_acc": 60.0},
        "pointing": {"lst_init": 0.0},
        "skyparm": {"model": "usm", "nside": nside},
        "save_formats": {"fmt": "HDF5" if h5 else "none", "npz": not h5},
    })
    try:
        t0 = time.perf_counter()
        run_simulation(parms, verbose=False, save=True)
        return time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main():
    cs.device_report()
    rate, dt, shape = _gpu_macs_per_sec()
    cpu_rate = _cpu_reference_macs_per_sec()
    e2e = _end_to_end_seconds()
    print(json.dumps({
        "metric": "NUDFT complex MACs/sec/chip (HERA-37, 1024 chan, "
                  "nside-64 sky)",
        "value": rate,
        "unit": "MAC/s",
        "vs_baseline": rate / cpu_rate,
        "detail": {"snapshot_seconds": dt, **shape,
                   # task-effective MACs when the banded NUFFT wins: the
                   # direct engine's S*B*C MAC count divided by the
                   # banded runtime (the card executes O(S*K + B*C log
                   # C) ops for the same task)
                   "mac_equivalent": shape.get("kernel") == "banded",
                   "cpu_reference_macs_per_sec": cpu_rate,
                   "end_to_end_seconds_hera37_256c_2acc": e2e},
    }))


if __name__ == "__main__":
    main()
