"""North-star accuracy measurement: engines vs f64 golden at HERA-331 scale.

Measures the relative visibility error of the direct engines (XLA U.W and
the Pallas kernel where it compiles) against the direct float64 golden at
the north-star problem size: HERA-331 unique baselines (incl. the longest,
~876 m, where two-float phase headroom is worst), 1024 channels,
nside-256 sky (786,432 pixels; ~half above horizon carry flux).

The f64 golden is O(S*B*C) numpy on one host core, so only a slice of
baselines is golden-checked — chosen to span the full length range, which
is what controls phase-cycle count and therefore precision. The engines
are run at full source count so f32 accumulation error at true scale is
included.

Usage (on an NVIDIA GPU; the Pallas kernel compiles only there):
       python benchmarks/accuracy_northstar.py [--nbl-slice 8]
           [--nside 256] [--nchan 1024]
Prints one JSON line per engine with max relative error (scaled by
max |V_golden|) and the worst per-element relative error among
|V| > 1e-3 * max.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import tempfile
import time

import numpy as np


def build_problem(nside=256, nchan=1024, lst_deg=30.0, seed=0):
    import jax.numpy as jnp
    from prisim_tpu import layouts as lay
    from prisim_tpu import baselines as bls
    from prisim_tpu import healpix as hp
    from prisim_tpu import skymodel as sm
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine import (Instrument, SkySources,
                                   enu_rotation_from_eq)

    layout = lay.preset_layout("HERA-331")
    bset = bls.build_baselines(layout, redundant=True)
    freqs = 100e6 + 97656.25 * np.arange(nchan)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)

    rng = np.random.default_rng(seed)
    theta, phi = hp.pix2ang(nside, np.arange(hp.nside2npix(nside)))
    ra = np.degrees(phi)
    dec = 90.0 - np.degrees(theta)
    loc = np.stack([ra, dec], axis=-1)
    nsrc = loc.shape[0]
    flux_parms = dict(flux_scale=rng.uniform(0.1, 10.0, nsrc),
                      freq_ref=np.full(nsrc, 150e6),
                      power_law_index=np.full(nsrc, -0.8))
    model = sm.SkyModel(location=loc, spec_kind="power-law", spec_parms={
        "flux-scale": flux_parms["flux_scale"],
        "freq-ref": flux_parms["freq_ref"],
        "power-law-index": flux_parms["power_law_index"],
        "flux-offset": np.zeros(nsrc)})
    sky = SkySources.from_skymodel(model, freqs)

    # Host-side f64 geometry (exactly what the engines consume as splits)
    M64 = enu_rotation_from_eq(lst_deg, inst.latitude)
    ra_r = np.radians(loc[:, 0])
    dec_r = np.radians(loc[:, 1])
    s_eq = np.stack([np.cos(dec_r) * np.cos(ra_r),
                     np.cos(dec_r) * np.sin(ra_r),
                     np.sin(dec_r)], axis=-1)
    s_enu = s_eq @ M64.T
    pc = np.array([0.0, 0.0, 1.0])
    s_eff64 = s_enu - pc[None, :]
    return dict(inst=inst, sky=sky, bset=bset, freqs=freqs, M64=M64,
                s_eff64=s_eff64, s_enu=s_enu, pc=pc, nsrc=nsrc,
                flux_parms=flux_parms)


def baseline_slice(prob, nbl_slice):
    """Indices of a shortest..longest-spanning baseline slice (length
    controls phase-cycle count). Shared by the stage-isolation probes
    so yardstick and probes can never diverge on WHICH baselines they
    compare (the round-3 'yardstick was the bottleneck' lesson)."""
    bl = np.asarray(prob["inst"].bl_hi, dtype=np.float64) + \
        np.asarray(prob["inst"].bl_lo, dtype=np.float64)
    lengths = np.sqrt((bl ** 2).sum(1))
    order = np.argsort(lengths)
    pick = np.unique(np.linspace(0, order.size - 1, nbl_slice)
                     .astype(int))
    return order[pick], lengths


def engine_amps(prob):
    """Beam-weighted fluxes on device (f32), identical input to all paths."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.beams import airy_beam
    from prisim_tpu.engine.observe import df_rotate3

    sky = prob["sky"]
    freqs_f32 = jnp.asarray(prob["freqs"], dtype=jnp.float32)
    Mh, Ml = tf.split_f64(prob["M64"])

    @jax.jit
    def amps_fn(mh, ml, s_eq_hi, s_eq_lo, flux):
        # all large arrays are ARGUMENTS: a closure capture would embed
        # them as multi-GB HLO literals and stall the remote compile
        sh, sl = df_rotate3(mh, ml, s_eq_hi, s_eq_lo)
        pb = airy_beam(sh, freqs_f32, 14.0)
        amps = jnp.where((sh[:, 2] > 0.0)[:, None], pb * flux, 0.0)
        return sh, sl, amps

    sh, sl, amps = amps_fn(jnp.asarray(Mh), jnp.asarray(Ml),
                           jnp.asarray(sky.s_eq_hi),
                           jnp.asarray(sky.s_eq_lo),
                           jnp.asarray(sky.flux))
    return sh, sl, np.asarray(amps)


def golden_slice(prob, amps_np, bl_idx, chunk=2048):
    """f64 direct sum over nonzero-amp sources for the baseline slice."""
    from prisim_tpu import constants as CNST
    s_eff = prob["s_eff64"]
    freqs = prob["freqs"]
    bl = np.asarray(prob["inst"].bl_hi, dtype=np.float64) + \
        np.asarray(prob["inst"].bl_lo, dtype=np.float64)
    bl = bl[bl_idx]
    up = np.any(amps_np != 0.0, axis=1)
    s_eff = s_eff[up]
    A = amps_np[up].astype(np.float64)
    S = s_eff.shape[0]
    V = np.zeros((bl.shape[0], freqs.size), dtype=np.complex128)
    t0 = time.perf_counter()
    for i0 in range(0, S, chunk):
        sl = slice(i0, min(i0 + chunk, S))
        tau = s_eff[sl] @ bl.T / CNST.c                     # (s, b)
        phase = (2.0 * np.pi) * tau[:, :, None] * freqs[None, None, :]
        E = np.cos(phase) - 1j * np.sin(phase)
        V += np.einsum("sc,sbc->bc", A[sl], E)
    return V, time.perf_counter() - t0, int(S)


def run_engines(prob, sh, sl, amps_np, bl_idx, nchan):
    import jax
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine.nudft import nudft_visibilities
    from prisim_tpu.engine.pallas_nudft import nudft_pallas

    inst = prob["inst"]
    pch, pcl = tf.split_f64(prob["pc"])
    seh, sel = tf.df_add(sh, sl, -jnp.asarray(pch)[None, :],
                         -jnp.asarray(pcl)[None, :])
    blh = jnp.asarray(np.asarray(inst.bl_hi)[bl_idx])
    bll = jnp.asarray(np.asarray(inst.bl_lo)[bl_idx])
    gs = inst.grid_scalars()

    out = {}
    timing = {}

    # each engine with a donated fresh copy of amps (3.2 GB at
    # nside 256)
    @functools.partial(jax.jit, donate_argnums=(2,))
    def pal(seh, sel, amps):
        v = nudft_pallas(seh, sel, blh, bll, amps, gs, nchan)
        return jnp.real(v), jnp.imag(v)

    @functools.partial(jax.jit, donate_argnums=(2,))
    def xla(seh, sel, amps):
        v = nudft_visibilities(seh, sel, blh, bll, amps, gs, nchan,
                               src_block=4096)
        return jnp.real(v), jnp.imag(v)

    t0 = time.perf_counter()
    vr, vi = jax.block_until_ready(pal(seh, sel, jnp.asarray(amps_np)))
    timing["pallas"] = time.perf_counter() - t0
    out["pallas"] = np.asarray(vr) + 1j * np.asarray(vi)
    del vr, vi

    try:
        t0 = time.perf_counter()
        vr, vi = jax.block_until_ready(xla(seh, sel,
                                           jnp.asarray(amps_np)))
        timing["xla"] = time.perf_counter() - t0
        out["xla"] = np.asarray(vr) + 1j * np.asarray(vi)
    except Exception as exc:
        print(json.dumps({"warning": "xla engine failed: %s"
                          % str(exc)[:160]}))
    return out, timing


def model_amps_df(prob, rank, diameter=14.0, chunk=65536):
    """(hi, lo) f32 pair of the rank-r node-model amps, computed on the
    host in f64 — the channel-expanded twin of the engine truth-amps
    path (engine/nufft_banded.make_coeff_fn_truth): Airy model beam
    (Chebyshev [0,8) + true-J1 tail fit [8,32], beams/analytic.py) at
    the Chebyshev node frequencies x f64 power-law flux, coefficients
    by node interpolation, expanded with Q64."""
    from prisim_tpu import constants as CNST
    from prisim_tpu.beams.analytic import _J1_CHEB, _AIRY_TAIL_CHEB
    from prisim_tpu.engine.nufft_delay import chebyshev_node_model

    nm = chebyshev_node_model(prob["freqs"], rank)
    s = prob["s_enu"]
    S = s.shape[0]
    C = prob["freqs"].size
    fp = prob["flux_parms"]
    sin_t = np.sqrt(np.clip(s[:, 0] ** 2 + s[:, 1] ** 2, 0.0, 1.0))
    below = s[:, 2] < 0.0
    a = np.pi * nm.nu_nodes * diameter / CNST.c
    hi = np.empty((S, C), np.float32)
    lo = np.empty((S, C), np.float32)
    M = nm.node2coef64 @ nm.Q64.T                       # (r, C)
    for i0 in range(0, S, chunk):
        sl = slice(i0, min(i0 + chunk, S))
        x = a[None, :] * sin_t[sl, None]                # (s, r)
        small = 2.0 * np.polynomial.chebyshev.chebval(
            x * x / 32.0 - 1.0, _J1_CHEB)
        tail = np.polynomial.chebyshev.chebval((x - 20.0) / 12.0,
                                               _AIRY_TAIL_CHEB)
        pat = np.where(x < 8.0, small, tail) ** 2
        fluxn = fp["flux_scale"][sl, None] * (
            nm.nu_nodes[None, :] / fp["freq_ref"][sl, None]) \
            ** fp["power_law_index"][sl, None]
        amps = np.where(below[sl, None], 0.0,
                        (pat * fluxn) @ M)              # (s, C) f64
        hi[sl] = amps.astype(np.float32)
        lo[sl] = (amps - hi[sl].astype(np.float64)).astype(np.float32)
    return hi, lo


def run_pallas_truth(prob, sh, sl, bl_idx, nchan, rank):
    """Direct Pallas kernel fed the TRUTH amps as a two-float pair —
    two kernel passes (the NUDFT is linear; the lo visibilities are
    ~60 ulp of the hi ones and add cleanly in complex128 on host).
    Expected error vs the f64 truth: the kernel's own transform floor
    plus the rank-r model convergence, with the f32 amps chain
    eliminated."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine.pallas_nudft import nudft_pallas

    inst = prob["inst"]
    pch, pcl = tf.split_f64(prob["pc"])
    seh, sel = tf.df_add(sh, sl, -jnp.asarray(pch)[None, :],
                         -jnp.asarray(pcl)[None, :])
    blh = jnp.asarray(np.asarray(inst.bl_hi)[bl_idx])
    bll = jnp.asarray(np.asarray(inst.bl_lo)[bl_idx])
    gs = inst.grid_scalars()
    amps_h, amps_l = model_amps_df(prob, rank)

    @functools.partial(jax.jit, donate_argnums=(2,))
    def pal(seh, sel, amps):
        v = nudft_pallas(seh, sel, blh, bll, amps, gs, nchan)
        return jnp.real(v), jnp.imag(v)

    t0 = time.perf_counter()
    vr, vi = jax.block_until_ready(pal(seh, sel, jnp.asarray(amps_h)))
    V = (np.asarray(vr).astype(np.float64)
         + 1j * np.asarray(vi).astype(np.float64))
    vr, vi = jax.block_until_ready(pal(seh, sel, jnp.asarray(amps_l)))
    V = V + (np.asarray(vr).astype(np.float64)
             + 1j * np.asarray(vi).astype(np.float64))
    return V, time.perf_counter() - t0


def f64_amps(prob, diameter=14.0):
    """(S, C) f64 model amps — the truth yardstick. Airy (power) via
    the same Chebyshev J1 model the engine evaluates in f32, times the
    f64 power-law flux, horizon-masked. The reference computes beams
    in f64 (primary_beams.py:517 uses scipy), so THIS is the
    reference-parity golden; the round-3 shared-f32-amps golden
    contains the engine amps' own ~1e-6-class coherent f32 jitter
    (probe_truth, round 4)."""
    from prisim_tpu import constants as CNST
    from prisim_tpu.beams.analytic import _J1_CHEB
    s = prob["s_enu"]
    freqs = np.asarray(prob["freqs"], np.float64)
    sin_t = np.sqrt(np.clip(s[:, 0] ** 2 + s[:, 1] ** 2, 0.0, 1.0))
    below = s[:, 2] < 0.0
    k = 2.0 * np.pi * freqs / CNST.c
    pb = np.empty((s.shape[0], freqs.size))
    chunk = 65536
    for i0 in range(0, s.shape[0], chunk):
        slc = slice(i0, min(i0 + chunk, s.shape[0]))
        arg = k[None, :] * (0.5 * diameter) * sin_t[slc, None]
        t = arg * arg / 32.0 - 1.0
        g = np.polynomial.chebyshev.chebval(t, _J1_CHEB)
        pat = np.where(np.abs(arg) < 8.0, 2.0 * g,
                       _j1_asymptotic_over_x(arg))
        pb[slc] = pat * pat
    fp = prob["flux_parms"]
    flux = fp["flux_scale"][:, None] * (
        freqs[None, :] / fp["freq_ref"][:, None]) \
        ** fp["power_law_index"][:, None]
    return np.where(below[:, None], 0.0, pb * flux)


def _j1_asymptotic_over_x(x):
    """2*J1(x)/x via the A&S asymptotic branch (|x| >= 8), f64."""
    ax = np.abs(x)
    z = 8.0 / np.maximum(ax, 1e-20)
    y2 = z * z
    p1 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4
         + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    p2 = 0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5
         + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6)))
    xx = ax - 2.356194491
    j1 = np.sqrt(0.636619772 / np.maximum(ax, 1e-20)) * \
        (np.cos(xx) * p1 - z * np.sin(xx) * p2) * np.sign(x)
    return 2.0 * j1 / np.where(x == 0.0, 1.0, x)


def run_banded(prob, sh, sl, amps_np, bl_idx, nchan, ktaps=None,
               tile=None, gblk=None, rank=24, node_model=False,
               truth=False, beta=None):
    """Banded-spread NUFFT engine on the baseline slice, full sources.

    The plan is built on the sliced vectors only — the banded engine is
    per-baseline-independent, so its slice output is bit-identical to
    the corresponding rows of a full-array run.

    CRITICAL (measured, round 3): the engine must consume the SAME
    beam-weighted amps as the golden. An earlier version recomputed
    the beam inside its own jit program; the ~1e-7 per-element f32
    differences between two beam evaluations (different fusion, or
    different backends for the cached golden) sum coherently across
    786k sources into a ~3.4e-6 scaled floor that NO engine knob could
    move — it was the yardstick, not the engine (probe_banded_f64
    swept K/rank/basis to prove it)."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine import Instrument
    from prisim_tpu.engine.nufft_banded import (
        make_banded_plan, nufft_banded_visibilities)
    from prisim_tpu.engine.nufft_delay import (chebyshev_projection,
                                               spectral_project)

    inst = prob["inst"]
    bl64 = (np.asarray(inst.bl_hi, np.float64)
            + np.asarray(inst.bl_lo, np.float64))[bl_idx]
    inst_sl = Instrument.build(bl64, prob["freqs"],
                               latitude=inst.latitude)
    pinvQ, Q = chebyshev_projection(prob["freqs"], rank)
    kw = {k: v for k, v in
          dict(K=ktaps, T_s=tile, G_blk=gblk, beta=beta).items() if v}
    plan = make_banded_plan(bl64, inst_sl.nu0, inst_sl.dnu, nchan,
                            rank=rank, **kw)
    pch, pcl = tf.split_f64(prob["pc"])

    if truth:
        # round-5 truth-amps path: two-float node amps (df32 Airy +
        # host-f64 flux node values) with a dual spread — the whole
        # node-amps chain at ~1e-9/element instead of the f32 chain's
        # ~1e-7 (engine/nufft_banded.make_coeff_fn_truth)
        from prisim_tpu.engine.nufft_banded import make_coeff_fn_truth
        from prisim_tpu.engine.nufft_banded import (_prep,
                                                    _banded_spread,
                                                    _payload_pad, _post)
        from prisim_tpu.beams.analytic import airy_beam_df
        cf = make_coeff_fn_truth(prob["freqs"], rank,
                                 lambda a, b, f:
                                 airy_beam_df(a, b, f, 14.0))
        nm = cf.node_model
        fp = prob["flux_parms"]
        fluxn64 = fp["flux_scale"][:, None] * (
            nm.nu_nodes[None, :] / fp["freq_ref"][:, None]) \
            ** fp["power_law_index"][:, None]
        fnh, fnl = tf.split_f64(fluxn64)
        Q_j = jnp.asarray(Q, jnp.float32)

        @jax.jit
        def banded(sh, sl, fnh, fnl):
            seh, sel = tf.df_add(sh, sl, -jnp.asarray(pch)[None, :],
                                 -jnp.asarray(pcl)[None, :])
            Ph, Pl = cf(sh, sl, fnh, fnl)
            u_h, u_l, P_r, ok = _prep(plan, seh, sel, Ph)
            v = _post(plan, _banded_spread(plan, u_h, u_l, P_r), Q_j)
            v = v + _post(plan, _banded_spread(plan, u_h, u_l,
                                               _payload_pad(plan, Pl)),
                          Q_j)
            return jnp.real(v), jnp.imag(v), ok

        t0 = time.perf_counter()
        vr, vi, ok = jax.block_until_ready(
            banded(sh, sl, jnp.asarray(fnh), jnp.asarray(fnl)))
        dt = time.perf_counter() - t0
        if not bool(np.asarray(jax.device_get(ok))):
            print(json.dumps({"warning": "banded span check failed"}))
        return np.asarray(vr) + 1j * np.asarray(vi), dt, plan

    if node_model:
        # round-4 production form: beam x flux at the rank Chebyshev
        # nodes, coefficients by interpolation (zero fit residual vs
        # the model; see engine/nufft_banded.make_banded_snapshot_fns)
        from prisim_tpu.engine.nufft_delay import chebyshev_node_model
        from prisim_tpu.beams import airy_beam
        nm = chebyshev_node_model(prob["freqs"], rank)
        nodes_f32 = jnp.asarray(nm.nu_nodes, jnp.float32)
        hi = jax.lax.Precision.HIGHEST

        @jax.jit
        def banded(sh, sl, flux):
            seh, sel = tf.df_add(sh, sl, -jnp.asarray(pch)[None, :],
                                 -jnp.asarray(pcl)[None, :])
            fluxC = spectral_project(flux, jnp.asarray(pinvQ))
            fluxn = jnp.einsum("sr,nr->sn", fluxC, jnp.asarray(nm.V),
                               precision=hi)
            pb = airy_beam(sh, nodes_f32, 14.0)
            ampsn = jnp.where((sh[:, 2] > 0.0)[:, None], pb * fluxn,
                              0.0)
            P = jnp.einsum("sn,nr->sr", ampsn,
                           jnp.asarray(nm.node2coef), precision=hi)
            v, ok = nufft_banded_visibilities(plan, seh, sel, P, Q)
            return jnp.real(v), jnp.imag(v), ok

        t0 = time.perf_counter()
        vr, vi, ok = jax.block_until_ready(
            banded(sh, sl, jnp.asarray(prob["sky"].flux)))
        dt = time.perf_counter() - t0
        if not bool(np.asarray(jax.device_get(ok))):
            print(json.dumps({"warning": "banded span check failed"}))
        return np.asarray(vr) + 1j * np.asarray(vi), dt, plan

    @jax.jit
    def banded(sh, sl, amps):
        seh, sel = tf.df_add(sh, sl, -jnp.asarray(pch)[None, :],
                             -jnp.asarray(pcl)[None, :])
        P = spectral_project(amps, pinvQ)
        v, ok = nufft_banded_visibilities(plan, seh, sel, P, Q)
        return jnp.real(v), jnp.imag(v), ok

    t0 = time.perf_counter()
    vr, vi, ok = jax.block_until_ready(
        banded(sh, sl, jnp.asarray(amps_np)))
    dt = time.perf_counter() - t0
    if not bool(np.asarray(jax.device_get(ok))):
        print(json.dumps({"warning": "banded span check failed"}))
    return np.asarray(vr) + 1j * np.asarray(vi), dt, plan


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nside", type=int, default=256)
    ap.add_argument("--nchan", type=int, default=1024)
    ap.add_argument("--nbl-slice", type=int, default=8)
    ap.add_argument("--banded", action="store_true",
                    help="also measure the banded-spread NUFFT engine")
    ap.add_argument("--banded-only", action="store_true")
    ap.add_argument("--banded-k", type=int, default=None)
    ap.add_argument("--banded-tile", type=int, default=None)
    ap.add_argument("--banded-gblk", type=int, default=None)
    ap.add_argument("--banded-rank", type=int, default=24)
    ap.add_argument("--beta", type=float, default=None,
                    help="banded delay-grid oversampling (plan "
                         "default 2.0; edges of the deconvolved band "
                         "are where the KB correction is largest)")
    ap.add_argument("--node-model", action="store_true",
                    help="banded engine consumes the rank-r node "
                         "model (round-4 production form)")
    ap.add_argument("--truth-amps", action="store_true",
                    help="two-float node amps + dual spread (round-5 "
                         "production form)")
    ap.add_argument("--pallas-truth", action="store_true",
                    help="direct Pallas kernel on two-float model "
                         "amps (dual pass) — the spec-accuracy mode")
    ap.add_argument("--golden", default="f32amps",
                    choices=["f32amps", "f64amps"],
                    help="f32amps: f64 transform of the shared f32 "
                         "engine amps (round-3 yardstick; contains "
                         "their ~1e-6 coherent jitter). f64amps: f64 "
                         "model amps — the reference-parity truth")
    args = ap.parse_args()

    prob = build_problem(nside=args.nside, nchan=args.nchan)
    bl_idx, lengths = baseline_slice(prob, args.nbl_slice)
    print(json.dumps({"info": "problem", "nbl_total": int(lengths.size),
                      "bl_slice_lengths_m": np.round(lengths[bl_idx], 1)
                      .tolist(), "nsrc": prob["nsrc"],
                      "nchan": args.nchan}))

    sh, sl, amps_np = engine_amps(prob)
    if args.banded_only:
        eng, timing = {}, {}
    else:
        eng, timing = run_engines(prob, sh, sl, amps_np, bl_idx,
                                  args.nchan)
    plan = None
    if args.pallas_truth:
        eng["pallas_truth"], timing["pallas_truth"] = run_pallas_truth(
            prob, sh, sl, bl_idx, args.nchan, args.banded_rank)
    if args.banded or args.banded_only:
        eng["banded"], timing["banded"], plan = run_banded(
            prob, sh, sl, amps_np, bl_idx, args.nchan,
            ktaps=args.banded_k, tile=args.banded_tile,
            gblk=args.banded_gblk, rank=args.banded_rank,
            node_model=args.node_model, truth=args.truth_amps,
            beta=args.beta)

    cache = os.path.join(tempfile.gettempdir(),
                         "acc_ns_golden%s_%d_%d_%d.npz") % (
        "64" if args.golden == "f64amps" else "",
        args.nside, args.nchan, args.nbl_slice)
    if os.path.exists(cache):
        z = np.load(cache)
        Vg, tg, n_up = z["Vg"], float(z["tg"]), int(z["n_up"])
    else:
        gold_amps = f64_amps(prob) if args.golden == "f64amps" \
            else amps_np
        Vg, tg, n_up = golden_slice(prob, gold_amps, bl_idx)
        np.savez(cache, Vg=Vg, tg=tg, n_up=n_up)
    scale = np.abs(Vg).max()
    mask = np.abs(Vg) > 1e-3 * scale
    for name, V in eng.items():
        err = np.abs(V - Vg)
        rel_max_scaled = float(err.max() / scale)
        rel_elem = float((err[mask] / np.abs(Vg)[mask]).max())
        rec = {
            "engine": name,
            "golden": args.golden,
            "node_model": (args.node_model if name == "banded"
                           else None),
            "truth_amps": (args.truth_amps if name == "banded"
                           else None),
            "rel_max_scaled": rel_max_scaled,
            "rel_elem_worst": rel_elem,
            "engine_seconds_incl_compile": timing[name],
            "golden_seconds": tg, "n_src_above_horizon": n_up}
        if name == "banded" and plan is not None:
            rec["plan"] = dict(K=plan.K, G_blk=plan.G_blk, T_s=plan.T_s,
                               rank=plan.rank, beta=plan.beta)
        print(json.dumps(rec))


if __name__ == "__main__":
    main()
