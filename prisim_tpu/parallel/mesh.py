"""Device-mesh parallelism: shard_map over (baseline, channel, source) axes.

The reference's MPI decompositions (/root/reference/scripts/run_prisim.py:
1749-2210 — freq-axis chunks, baseline-axis chunks with static or
work-stealing scheduling, source-axis split with a recv-sum reduce, and
filesystem-based concatenation) collapse into jax shardings over one
device mesh:

  * bl/freq chunking  -> shard_map over mesh axes ('bl', 'chan'):
    embarrassingly parallel, no collectives until host gather at write-out;
    the memory-model-driven chunk sizing disappears (static shapes stream
    sources through a fixed-size scan block).
  * src-axis split + recv-sum -> source-sharded shard_map with a single
    jax.lax.psum over the 'src' axis.
  * work-stealing counter -> unnecessary under SPMD static sharding.

Channel shards compute their own frequency sub-grid via an axis-index
offset fed to the NUDFT phase factorization (exact in the double-float
representation), so no shard ever materializes the full channel axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from .. import twofloat as tf
from ..engine.nudft import nudft_visibilities
from ..engine.observe import df_rotate3

__all__ = ["make_mesh", "pad_to_multiple", "simulate_drift_sharded",
           "simulate_drift_src_sharded", "simulate_drift_nufft_sharded",
           "simulate_drift_banded_sharded"]


def make_mesh(shape=None, axis_names=("bl", "chan"), devices=None):
    """Build a Mesh over the available devices.

    shape: tuple matching axis_names; default puts all devices on the
    first axis (visibilities are embarrassingly parallel over baselines).
    """
    devices = devices if devices is not None else jax.devices()
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {shape} != #devices {n}")
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, axis_names)


def pad_to_multiple(arr, multiple, axis=0, value=0.0):
    """Pad `arr` along `axis` so its length is a multiple of `multiple`."""
    n = arr.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return np.asarray(arr)
    pad = [(0, 0)] * arr.ndim
    pad[axis] = (0, target - n)
    return np.pad(np.asarray(arr), pad, constant_values=value)


def _drift_core(blh, bll, freqs_f32, flux, seqh, seql, Mh, Ml, pch, pcl,
                grid_scalars, beam_fn, nchan_local, src_block, has_chan,
                has_src, use_pallas=False):
    """Per-shard drift scan: each device handles its local (bl, chan, src)
    block across all snapshots; lax.scan over time stays on-device."""
    chan0 = (jax.lax.axis_index("chan") * nchan_local) if has_chan else 0

    def step(_, x):
        mh, ml, ph, pl = x
        sh, sl = df_rotate3(mh, ml, seqh, seql)
        seh, sel = tf.df_add(sh, sl, -ph[None, :], -pl[None, :])
        pb = beam_fn(sh, freqs_f32)
        amps = jnp.where((sh[:, 2] > 0.0)[:, None], pb * flux, 0.0)
        if use_pallas:
            from ..engine.pallas_nudft import nudft_pallas
            vis = nudft_pallas(seh, sel, blh, bll, amps, grid_scalars,
                               nchan_local, chan0=chan0)
        else:
            vis = nudft_visibilities(seh, sel, blh, bll, amps,
                                     grid_scalars, nchan_local,
                                     chan0=chan0, src_block=src_block)
        if has_src:
            vis = jax.lax.psum(vis, "src")
        return None, vis

    _, vis = jax.lax.scan(step, None, (Mh, Ml, pch, pcl))
    return vis


def _sharded_drift(mesh, instrument, sky, observation, beam_fn, src_block,
                   src_axis, use_pallas=False):
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_bl = axis_sizes.get("bl", 1)
    n_ch = axis_sizes.get("chan", 1)
    n_src = axis_sizes.get("src", 1)
    has_chan = "chan" in axis_sizes
    has_src = src_axis and "src" in axis_sizes
    if src_axis and not has_src:
        raise ValueError("src-sharded mode needs a 'src' mesh axis")

    # Host-side padding to divisible sizes (pad baselines/sources with
    # zero rows: zero amplitude/zero vector contributes nothing).
    blh = pad_to_multiple(np.asarray(instrument.bl_hi), n_bl)
    bll = pad_to_multiple(np.asarray(instrument.bl_lo), n_bl)
    nchan = instrument.nchan
    nchan_pad = -(-nchan // n_ch) * n_ch
    freqs = instrument.nu0 + instrument.dnu * np.arange(nchan_pad)
    flux = pad_to_multiple(np.asarray(sky.flux), n_ch, axis=1)
    seqh = pad_to_multiple(np.asarray(sky.s_eq_hi), n_src)
    seql = pad_to_multiple(np.asarray(sky.s_eq_lo), n_src)
    flux = pad_to_multiple(flux, n_src, axis=0)
    # Padded sources sit at the origin (below-horizon mask keeps them at
    # amplitude zero only if z<=0; force zero flux instead).
    if seqh.shape[0] != sky.s_eq_hi.shape[0]:
        flux[sky.s_eq_hi.shape[0]:, :] = 0.0

    Mh, Ml = observation.rotations(instrument.latitude)
    pc = observation.pc_dircos()
    pch, pcl = tf.split_f64(pc)

    nchan_local = nchan_pad // n_ch
    gs = instrument.grid_scalars()

    bl_p = P("bl", None) if "bl" in axis_sizes else P(None, None)
    ch_p = P("chan") if has_chan else P(None)
    src_p = P("src", None) if has_src else P(None, None)
    flux_p = P("src" if has_src else None, "chan" if has_chan else None)

    in_specs = (bl_p, bl_p, ch_p, flux_p, src_p, src_p,
                P(), P(), P(), P())
    out_specs = P(None, "bl" if "bl" in axis_sizes else None,
                  "chan" if has_chan else None)

    fn = functools.partial(_drift_core, grid_scalars=gs, beam_fn=beam_fn,
                           nchan_local=nchan_local, src_block=src_block,
                           has_chan=has_chan, has_src=has_src,
                           use_pallas=use_pallas)
    mapped = jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False))
    vis = mapped(jnp.asarray(blh), jnp.asarray(bll),
                 jnp.asarray(freqs, dtype=jnp.float32),
                 jnp.asarray(flux, dtype=jnp.float32),
                 jnp.asarray(seqh), jnp.asarray(seql),
                 jnp.asarray(Mh), jnp.asarray(Ml), jnp.asarray(pch),
                 jnp.asarray(pcl))
    return vis[:, :instrument.nbl, :nchan]


def _nufft_drift_core(blh, bll, freqs_f32, flux, seqh, seql, Mh, Ml,
                      pch, pcl, *, nu0, dnu, nchan_local, rank, K, beta,
                      has_chan, has_src, beam_fn):
    """Per-shard NUFFT drift scan (sorted segment-sum spreading).

    The NUFFT is independent per baseline, so 'bl' sharding is natural;
    'chan' shards run their own sub-band NUFFT with the carrier offset
    by chan0*dnu*tau cycles (exact in two-float); 'src' shards psum
    their partial visibilities — the spreading is linear in sources."""
    from ..engine.nufft_delay import (nufft_delay_multirank_sorted,
                                      delays_two_float,
                                      chebyshev_basis_jit,
                                      spectral_project)

    chan0 = (jax.lax.axis_index("chan") * nchan_local) if has_chan \
        else None
    pinvQ, Qb = chebyshev_basis_jit(freqs_f32, rank)

    def step(_, x):
        mh, ml, ph, pl = x
        sh, sl = df_rotate3(mh, ml, seqh, seql)
        seh, sel = tf.df_add(sh, sl, -ph[None, :], -pl[None, :])
        pb = beam_fn(sh, freqs_f32)
        amps = jnp.where((sh[:, 2] > 0.0)[:, None], pb * flux, 0.0)
        # blocked-Kahan projection (bf16/f32-accumulation traps;
        # engine/nufft_delay.spectral_project)
        P = spectral_project(amps, pinvQ)                     # (S, r)
        th, tl = delays_two_float(seh, sel, blh, bll)
        vis = nufft_delay_multirank_sorted(th, tl, P, Qb, nu0, dnu,
                                           nchan_local, beta=beta, K=K,
                                           chan0=chan0)
        if has_src:
            vis = jax.lax.psum(vis, "src")
        return None, vis

    _, vis = jax.lax.scan(step, None, (Mh, Ml, pch, pcl))
    return vis


def simulate_drift_nufft_sharded(instrument, sky, observation, beam_fn,
                                 mesh, rank=16, K=13, beta=2.0):
    """Drift scan through the NUFFT engine, sharded over
    ('bl', 'chan'[, 'src']) like the direct path. Each chan shard's
    sub-band frequencies come from the NUFFT carrier offset; padded
    baselines/sources contribute zeros. Returns (T, B, C) complex64."""
    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_bl = axis_sizes.get("bl", 1)
    n_ch = axis_sizes.get("chan", 1)
    n_src = axis_sizes.get("src", 1)
    has_src = "src" in axis_sizes and n_src > 1

    blh = pad_to_multiple(np.asarray(instrument.bl_hi), n_bl)
    bll = pad_to_multiple(np.asarray(instrument.bl_lo), n_bl)
    nchan = instrument.nchan
    nchan_pad = -(-nchan // n_ch) * n_ch
    freqs = instrument.nu0 + instrument.dnu * np.arange(nchan_pad)
    # Channel padding is EDGE-replicated, not zero: the padded columns
    # land in the last chan shard and enter its Chebyshev spectral fit —
    # a spectrum that discontinuously drops to zero distorts the fit
    # across that shard's real channels. Replicated edges keep the fit
    # smooth; the padded output columns are trimmed on return.
    flux = np.asarray(sky.flux)
    if nchan_pad != flux.shape[1]:
        flux = np.pad(flux, ((0, 0), (0, nchan_pad - flux.shape[1])),
                      mode="edge")
    seqh = pad_to_multiple(np.asarray(sky.s_eq_hi), n_src)
    seql = pad_to_multiple(np.asarray(sky.s_eq_lo), n_src)
    flux = pad_to_multiple(flux, n_src, axis=0)
    if seqh.shape[0] != sky.s_eq_hi.shape[0]:
        flux = np.ascontiguousarray(flux)
        flux[sky.s_eq_hi.shape[0]:, :] = 0.0

    Mh, Ml = observation.rotations(instrument.latitude)
    pch, pcl = tf.split_f64(observation.pc_dircos())
    nchan_local = nchan_pad // n_ch

    bl_p = P("bl", None) if "bl" in axis_sizes else P(None, None)
    ch_p = P("chan") if "chan" in axis_sizes else P(None)
    src_p = P("src", None) if has_src else P(None, None)
    flux_p = P("src" if has_src else None,
               "chan" if "chan" in axis_sizes else None)
    in_specs = (bl_p, bl_p, ch_p, flux_p, src_p, src_p,
                P(), P(), P(), P())
    out_specs = P(None, "bl" if "bl" in axis_sizes else None,
                  "chan" if "chan" in axis_sizes else None)

    fn = functools.partial(_nufft_drift_core, nu0=instrument.nu0,
                           dnu=instrument.dnu, nchan_local=nchan_local,
                           rank=min(int(rank), nchan_local), K=K,
                           beta=beta,
                           has_chan="chan" in axis_sizes,
                           has_src=has_src, beam_fn=beam_fn)
    mapped = jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False))
    vis = mapped(jnp.asarray(blh), jnp.asarray(bll),
                 jnp.asarray(freqs, dtype=jnp.float32),
                 jnp.asarray(flux, dtype=jnp.float32),
                 jnp.asarray(seqh), jnp.asarray(seql),
                 jnp.asarray(Mh), jnp.asarray(Ml), jnp.asarray(pch),
                 jnp.asarray(pcl))
    return vis[:, :instrument.nbl, :nchan]


def simulate_drift_banded_sharded(instrument, sky, observation, beam_fn,
                                  mesh, rank=32,
                                  node_model=True, truth=None,
                                  plan_kw=None):
    """Drift scan through the banded-spread NUFFT engine
    (engine/nufft_banded.py), sharded over the 'bl' mesh axis.

    The banded plan is per-baseline-independent, so its per-baseline
    tables (block ranges, |b|, bin-offset ramp) shard cleanly along B
    as shard_map operands; the direction table and source arrays
    replicate. Delay-domain spreading needs each shard to hold the full
    band (the FFT runs over all channels), so 'chan'/'src' mesh axes
    are rejected — route those decompositions through
    simulate_drift_nufft_sharded (sorted spread) instead.

    Returns ((T, B, C) complex64, ok) where ok is the AND of every
    shard's unit-source span check (False => caller must fall back;
    cf. the single-device driver path, driver.py)."""
    import dataclasses
    from ..engine.nufft_banded import (make_banded_plan, _prep,
                                       _banded_spread, _post,
                                       _payload_pad, spatial_permutation,
                                       reorder_sources, make_coeff_fn)
    from ..engine.nufft_delay import chebyshev_projection

    axis_sizes = dict(zip(mesh.axis_names, mesh.devices.shape))
    n_bl = axis_sizes.get("bl", 1)
    if any(v > 1 for k, v in axis_sizes.items() if k != "bl"):
        raise ValueError("banded sharding supports only the 'bl' mesh "
                         "axis (the spread needs the full band per "
                         "shard); use the sorted spread for chan/src "
                         "meshes")

    nchan = instrument.nchan
    # rank approaching nchan makes the Chebyshev basis f32-toxic
    # (measured: rank 31 at C=32 -> 1.6e-2, rank 32 -> 0.3 rel error;
    # rank 24 -> 5e-6). Half the channel count is a safe ceiling.
    rank = min(int(rank), max(2, nchan // 2))
    bl64 = (np.asarray(instrument.bl_hi, np.float64)
            + np.asarray(instrument.bl_lo, np.float64))
    B = bl64.shape[0]
    B_pad = -(-B // n_bl) * n_bl
    if B_pad != B:
        # pad with copies of the first baseline (a zero vector would be
        # rejected by the direction grouping); padded rows are trimmed
        bl64 = np.concatenate(
            [bl64, np.repeat(bl64[:1], B_pad - B, axis=0)], axis=0)
    # collapse=False: the shard_map below shards the plan tables over
    # the 'bl' mesh axis positionally — a collapsed plan's expansion
    # gather would cross shard boundaries. Redundant inputs are rare on
    # the mesh path (the driver already simulates unique baselines).
    plan = make_banded_plan(bl64, instrument.nu0, instrument.dnu,
                            nchan, rank=rank, collapse=False,
                            **(plan_kw or {}))
    pinvQ, Q = chebyshev_projection(np.asarray(instrument.freqs), rank)

    perm = spatial_permutation(np.asarray(sky.s_eq_hi, np.float64)
                               + np.asarray(sky.s_eq_lo, np.float64))
    sky = reorder_sources(sky, perm)

    Mh, Ml = observation.rotations(instrument.latitude)
    pch, pcl = tf.split_f64(observation.pc_dircos())
    Q_j = jnp.asarray(Q, jnp.float32)
    coeff_fn = make_coeff_fn(instrument.freqs, rank, pinvQ, beam_fn,
                             node_model=node_model)
    coeffs_df = None
    fnh = fnl = jnp.zeros((0,), jnp.float32)   # placeholder operands
    if truth is not None:
        # round-5 truth-amps on the mesh: sources (and their flux node
        # values) replicate across the 'bl' shards, so the two-float
        # coefficient payloads are computed identically per shard and
        # the dual spread runs on each shard's baseline rows.
        from ..engine.nufft_banded import make_coeff_fn_truth
        coeffs_df = make_coeff_fn_truth(instrument.freqs, rank,
                                        truth["beam_df"])
        fluxn64 = np.asarray(truth["flux_nodes"], np.float64)[perm]
        fnh_np, fnl_np = tf.split_f64(fluxn64)
        fnh = jnp.asarray(fnh_np)
        fnl = jnp.asarray(fnl_np)

    def fn(dofb, blo, nblk, blh, bll, ramp, seqh, seql, flux,
           fnh_s, fnl_s, mh_t, ml_t, pch_t, pcl_t):
        lplan = dataclasses.replace(plan, d_of_b=dofb, blk_lo=blo,
                                    n_blk=nblk, blen_hi=blh,
                                    blen_lo=bll, ramp=ramp)

        def step(_, mt):
            mh, ml, ph, pl_ = mt
            sh, sl = df_rotate3(mh, ml, seqh, seql)
            seh, sel = tf.df_add(sh, sl, -ph[None, :], -pl_[None, :])
            if truth is not None:
                Pc, Pl2 = coeffs_df(sh, sl, fnh_s, fnl_s)
            else:
                Pc = coeff_fn(sh, flux, ph)
            u_h, u_l, P_r, ok = _prep(lplan, seh, sel, Pc)
            v = _post(lplan, _banded_spread(lplan, u_h, u_l, P_r), Q_j)
            if truth is not None:
                Pl_r = _payload_pad(lplan, Pl2)
                v = v + _post(lplan,
                              _banded_spread(lplan, u_h, u_l, Pl_r), Q_j)
            return None, (v, ok)

        _, (vis, oks) = jax.lax.scan(step, None,
                                     (mh_t, ml_t, pch_t, pcl_t))
        return vis, jnp.all(oks)[None]

    bl_p = P("bl") if "bl" in axis_sizes else P(None)
    bl2_p = P("bl", None) if "bl" in axis_sizes else P(None, None)
    in_specs = (bl_p, bl_p, bl_p, bl_p, bl_p, bl2_p,
                P(), P(), P(), P(), P(), P(), P(), P(), P())
    out_specs = (P(None, "bl" if "bl" in axis_sizes else None, None),
                 bl_p)
    mapped = jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                               out_specs=out_specs, check_vma=False))
    vis, oks = mapped(
        jnp.asarray(plan.d_of_b), jnp.asarray(plan.blk_lo),
        jnp.asarray(plan.n_blk), jnp.asarray(plan.blen_hi),
        jnp.asarray(plan.blen_lo), jnp.asarray(plan.ramp),
        jnp.asarray(sky.s_eq_hi), jnp.asarray(sky.s_eq_lo),
        jnp.asarray(sky.flux), fnh, fnl, jnp.asarray(Mh),
        jnp.asarray(Ml), jnp.asarray(pch), jnp.asarray(pcl))
    ok = bool(np.asarray(jax.device_get(jnp.all(oks))))
    return vis[:, :B, :], ok


def simulate_drift_sharded(instrument, sky, observation, beam_fn, mesh,
                           src_block=512, use_pallas=False):
    """Drift scan sharded over ('bl', 'chan'). Returns (T, B, C) complex64
    with padded rows/cols stripped (result still device-sharded).
    use_pallas routes each shard's NUDFT through the Pallas kernel."""
    return _sharded_drift(mesh, instrument, sky, observation, beam_fn,
                          src_block, src_axis=False,
                          use_pallas=use_pallas)


def simulate_drift_src_sharded(instrument, sky, observation, beam_fn, mesh,
                               src_block=512, use_pallas=False):
    """Drift scan with the *source* axis sharded and a psum reduce — the
    mesh equivalent of the reference's pp.key='src' mode with its rank-0
    recv-sum (/root/reference/scripts/run_prisim.py:1845-1856)."""
    return _sharded_drift(mesh, instrument, sky, observation, beam_fn,
                          src_block, src_axis=True,
                          use_pallas=use_pallas)
