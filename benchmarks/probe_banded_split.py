"""Split the banded engine's f64-algorithm floor into its two terms.

probe_proj_chip measured the full-scale banded residual at 1.66e-6
even with the projection AND the whole banded evaluation in exact
f64 — so the floor is in the algorithm, not f32 arithmetic. The
algorithm has exactly two approximation steps:

  1. rank-r Chebyshev fit of the (S, C) amps:  A ~ P @ Q.T
  2. K-tap Kaiser-Bessel spread + deconvolution (the NUFFT)

This probe separates them at full north-star scale:

  V1      = exact f64 direct NUDFT of the FITTED amps (P @ Q.T)
  err_fit = |V1 - golden| / scale      (pure rank/basis error)
  err_kb  = |banded_f64(P) - V1| / scale  (pure spread error)

and sweeps K (and optionally rank) on whichever term dominates.

    JAX_PLATFORMS=cpu python \
        benchmarks/probe_banded_split.py [--nside 256] [--rank 32]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from accuracy_northstar import (build_problem, engine_amps,
                                golden_slice, baseline_slice)
from probe_proj_chip import banded_f64_eval


def direct_f64(prob, A64, bl_idx, chunk=2048):
    """Exact f64 NUDFT of arbitrary (S, C) f64 amps on the slice."""
    from prisim_tpu import constants as CNST
    s_eff = prob["s_eff64"]
    freqs = prob["freqs"]
    bl = np.asarray(prob["inst"].bl_hi, np.float64) + \
        np.asarray(prob["inst"].bl_lo, np.float64)
    bl = bl[bl_idx]
    up = np.any(A64 != 0.0, axis=1)
    s_eff = s_eff[up]
    A = A64[up]
    V = np.zeros((bl.shape[0], freqs.size), np.complex128)
    for i0 in range(0, A.shape[0], chunk):
        sl = slice(i0, min(i0 + chunk, A.shape[0]))
        tau = s_eff[sl] @ bl.T / CNST.c
        phase = (2.0 * np.pi) * tau[:, :, None] * freqs[None, None, :]
        E = np.cos(phase) - 1j * np.sin(phase)
        V += np.einsum("sc,sbc->bc", A[sl], E)
    return V


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=256)
    ap.add_argument("--nchan", type=int, default=1024)
    ap.add_argument("--nbl-slice", type=int, default=8)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--ksweep", type=int, nargs="*", default=[9, 13])
    ap.add_argument("--beta", type=float, nargs="*", default=[2.0])
    ap.add_argument("--v1-cache", default=None,
                    help="npz path to cache the fitted-amps direct V1")
    args = ap.parse_args()

    from prisim_tpu.engine.nufft_delay import chebyshev_projection

    prob = build_problem(nside=args.nside, nchan=args.nchan)
    bl_idx, _ = baseline_slice(prob, args.nbl_slice)
    sh, sl, amps_np = engine_amps(prob)
    cache = "/tmp/acc_ns_golden_%d_%d_%d.npz" % (
        args.nside, args.nchan, args.nbl_slice)
    if os.path.exists(cache):
        Vg = np.load(cache)["Vg"]
    else:
        Vg, tg, n_up = golden_slice(prob, amps_np, bl_idx)
        np.savez(cache, Vg=Vg, tg=tg, n_up=int(n_up))
    scale = np.abs(Vg).max()

    pinvQ, Q = chebyshev_projection(prob["freqs"], args.rank)
    A64 = amps_np.astype(np.float64)
    P64 = A64 @ np.asarray(pinvQ, np.float64)
    Afit = P64 @ np.asarray(Q, np.float64).T
    print(json.dumps({"amps_fit_maxrel": float(
        np.abs(Afit - A64).max() / np.abs(A64).max())}), flush=True)

    t0 = time.perf_counter()
    if args.v1_cache and os.path.exists(args.v1_cache):
        V1 = np.load(args.v1_cache)["V1"]
    else:
        V1 = direct_f64(prob, Afit, bl_idx)
        if args.v1_cache:
            np.savez(args.v1_cache, V1=V1)
    print(json.dumps({
        "err_fit_scaled": float(np.abs(V1 - Vg).max() / scale),
        "direct_seconds": time.perf_counter() - t0}), flush=True)

    for beta in args.beta:
        for K in args.ksweep:
            Vb = banded_f64_eval(prob, bl_idx, P64, Q, args.nchan, K=K,
                                 beta=beta)
            print(json.dumps({
                "K": K, "beta": beta,
                "err_kb_scaled": float(np.abs(Vb - V1).max() / scale),
                "err_total_scaled": float(np.abs(Vb - Vg).max()
                                          / scale)}), flush=True)


if __name__ == "__main__":
    main()
