"""Truth-yardstick probe: engines' inputs vs the f64 model amps.

probe_basis (round 4) showed the banded engine's "fit error" floors at
~2.3e-6 fit_maxrel regardless of rank (32->48) or fit variable: the
residual is the F32 QUANTIZATION NOISE of the beam-weighted amps
themselves (~1e-7/element), which no smooth basis can represent and
whose zero-phase coherent sum over ~4e5 sources is ~1.3e-6 of scale.
The round-3 golden consumes those exact f32 values, so it CONTAINS the
noise; the fit smooths it away and gets penalized for it.

The reference computes beams in f64 (primary_beams.py is numpy f64),
so the parity yardstick is an f64-amps golden. This probe measures, at
a reduced scale (nside 128 default; CPU-runnable):

  T   = f64 NUDFT of f64 model amps  (the truth)
  G32 = f64 NUDFT of the engine's f32 amps (the round-3 golden)
  F   = f64 NUDFT of the rank-r fitted f32 amps (banded fit floor)
  Bf  = f64 banded algorithm (fit + KB spread) at K taps

reporting each vs T and vs G32. Prediction: |G32 - T| ~ 1e-6-class
(the direct engines inherit it), |F - T| << |F - G32| (the fit is
closer to truth than to the noisy golden).

    JAX_PLATFORMS=cpu python \
        benchmarks/probe_truth.py [--nside 128] [--rank 32] [--k 11]
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from accuracy_northstar import (build_problem, engine_amps,
                                baseline_slice)
from probe_banded_split import direct_f64
from probe_proj_chip import banded_f64_eval


def bessel_j1_np(x):
    """f64 numpy twin of beams.analytic.bessel_j1 (same Chebyshev
    model for |x|<8 and A&S asymptotic beyond — the fit IS the model,
    so evaluating it in f64 gives the model's truth; the engine's f32
    evaluation adds ~2e-7/element rounding)."""
    from prisim_tpu.beams.analytic import _J1_CHEB
    ax = np.abs(x)
    t = x * x / 32.0 - 1.0
    small = x * np.polynomial.chebyshev.chebval(t, _J1_CHEB)
    z = 8.0 / np.maximum(ax, 1e-20)
    y2 = z * z
    p1 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4
         + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    p2 = 0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5
         + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6)))
    xx = ax - 2.356194491
    big = np.sqrt(0.636619772 / np.maximum(ax, 1e-20)) * \
        (np.cos(xx) * p1 - z * np.sin(xx) * p2) * np.sign(x)
    return np.where(ax < 8.0, small, big)


def f64_amps(prob, diameter=14.0, flux_parms=None):
    """(S, C) f64 model amps: Airy(power) x power-law flux, horizon-
    masked — the host-f64 twin of accuracy_northstar.engine_amps."""
    from prisim_tpu import constants as CNST
    s = prob["s_enu"]                                   # (S, 3) f64
    freqs = np.asarray(prob["freqs"], np.float64)
    sin_t = np.sqrt(np.clip(s[:, 0] ** 2 + s[:, 1] ** 2, 0.0, 1.0))
    below = s[:, 2] < 0.0
    k = 2.0 * np.pi * freqs / CNST.c
    arg = k[None, :] * (0.5 * diameter) * sin_t[:, None]
    small = np.abs(arg) < 1e-6
    safe = np.where(small, 1.0, arg)
    pattern = np.where(small, 1.0 - arg * arg / 8.0,
                       2.0 * bessel_j1_np(safe) / safe)
    pb = pattern ** 2
    fp = flux_parms or prob["flux_parms"]
    flux = fp["flux_scale"][:, None] * (
        freqs[None, :] / fp["freq_ref"][:, None]) \
        ** fp["power_law_index"][:, None]
    amps = np.where(below[:, None], 0.0, pb * flux)
    return amps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=128)
    ap.add_argument("--nchan", type=int, default=1024)
    ap.add_argument("--nbl-slice", type=int, default=8)
    ap.add_argument("--rank", type=int, default=32)
    ap.add_argument("--k", type=int, default=11)
    args = ap.parse_args()

    from prisim_tpu.engine.nufft_delay import chebyshev_projection

    prob = build_problem(nside=args.nside, nchan=args.nchan)
    # rebuild the flux parms with the same seed as build_problem
    rng = np.random.default_rng(0)
    nsrc = prob["nsrc"]
    prob["flux_parms"] = dict(
        flux_scale=rng.uniform(0.1, 10.0, nsrc),
        freq_ref=np.full(nsrc, 150e6),
        power_law_index=np.full(nsrc, -0.8))

    bl_idx, _ = baseline_slice(prob, args.nbl_slice)
    sh, sl, A32 = engine_amps(prob)
    A64 = f64_amps(prob)
    # per-element engine-amps rounding vs the model
    d = np.abs(A32.astype(np.float64) - A64)
    print(json.dumps({"amps_elem_maxrel": float(
        d.max() / np.abs(A64).max()),
        "amps_elem_rms_rel": float(
            np.sqrt((d ** 2).mean()) / np.abs(A64).max())}), flush=True)

    t0 = time.perf_counter()
    T = direct_f64(prob, A64, bl_idx)
    G32 = direct_f64(prob, A32.astype(np.float64), bl_idx)
    print(json.dumps({"goldens_seconds": time.perf_counter() - t0}),
          flush=True)
    scale = np.abs(T).max()

    pinvQ, Q = chebyshev_projection(prob["freqs"], args.rank)
    P64 = A32.astype(np.float64) @ np.asarray(pinvQ, np.float64)
    Afit = P64 @ np.asarray(Q, np.float64).T
    F = direct_f64(prob, Afit, bl_idx)
    Bf = banded_f64_eval(prob, bl_idx, P64, Q, args.nchan, K=args.k)

    def rel(X, Y):
        return float(np.abs(X - Y).max() / scale)

    print(json.dumps({
        "G32_vs_T": rel(G32, T),
        "F_vs_T": rel(F, T), "F_vs_G32": rel(F, G32),
        "banded_f64_vs_T": rel(Bf, T),
        "banded_f64_vs_G32": rel(Bf, G32),
        "K": args.k, "rank": args.rank}), flush=True)


if __name__ == "__main__":
    main()
