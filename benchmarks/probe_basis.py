"""Spectral-basis shootout for the banded engine's rank-r fit.

probe_banded_split (round 4) pinned the banded engine's full-scale
residual to the rank-32 Chebyshev-in-ln(nu) amps fit (err_fit 1.66e-6
== err_total at K=13). The amps are flux * Airy(nu * sin(theta)):
the beam's sidelobe structure is oscillatory in LINEAR nu, so the fit
variable matters. This probe measures amps_fit_maxrel (and the
flux-weighted coherent-sum proxy that tracks the visibility error)
for basis variants x ranks at north-star scale, f64 host matmuls.

    JAX_PLATFORMS=cpu python \
        benchmarks/probe_basis.py [--nside 256] [--ranks 32 40 48]
"""

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from accuracy_northstar import build_problem, engine_amps


def cheb_basis(freqs, rank, var="lognu"):
    freqs = np.asarray(freqs, dtype=np.float64)
    C = freqs.size
    if var == "lognu":
        x = np.log(freqs / freqs[C // 2])
    else:
        x = freqs.copy()
    x = 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0
    Q = np.polynomial.chebyshev.chebvander(x, rank - 1)
    Qf = Q.astype(np.float32)
    pinv = np.linalg.pinv(Qf.astype(np.float64)).T.astype(np.float32)
    return pinv, Qf


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=256)
    ap.add_argument("--nchan", type=int, default=1024)
    ap.add_argument("--ranks", type=int, nargs="*", default=[32, 40])
    ap.add_argument("--vars", nargs="*", default=["lognu", "nu"])
    args = ap.parse_args()

    prob = build_problem(nside=args.nside, nchan=args.nchan)
    sh, sl, amps_np = engine_amps(prob)
    A64 = amps_np.astype(np.float64)
    up = np.any(A64 != 0.0, axis=1)
    A64 = A64[up]
    scale = np.abs(A64).max()
    print(json.dumps({"n_up": int(A64.shape[0]), "scale": scale}),
          flush=True)

    for var in args.vars:
        for rank in args.ranks:
            pinvQ, Q = cheb_basis(prob["freqs"], rank, var=var)
            P = A64 @ np.asarray(pinvQ, np.float64)
            R = P @ np.asarray(Q, np.float64).T - A64      # (S, C)
            # coherent-sum proxy: the visibility is a phased sum of
            # per-source residuals; the all-phases-aligned worst case
            # is sum_s |R| per channel, but the realistic proxy that
            # tracked err_fit in probe_banded_split is the plain
            # coherent sum at zero phase, per channel, over sources
            coh = np.abs(R.sum(axis=0)).max() / max(
                np.abs(A64.sum(axis=0)).max(), 1e-30)
            print(json.dumps({
                "var": var, "rank": rank,
                "fit_maxrel": float(np.abs(R).max() / scale),
                "coherent_sum_rel": float(coh)}), flush=True)


if __name__ == "__main__":
    main()
