"""Banded-spread NUFFT (engine/nufft_banded.py): correctness of the
XLA spread vs the f64 NUFFT reference and the direct engine."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from prisim_tpu import twofloat as tf
from prisim_tpu import constants as CNST
from prisim_tpu.engine.nufft_banded import (
    BandedPlan, group_directions, make_banded_plan,
    nufft_banded_visibilities, simulate_snapshot_nufft_banded)
from prisim_tpu.engine.nufft_delay import (chebyshev_projection,
                                           nufft_delay_visibilities)


def test_group_directions():
    bl = np.asarray([[14.6, 0, 0], [29.2, 0, 0], [0, 14.6, 0],
                     [-14.6, 0, 0], [43.8, 0.0, 0.0]])
    dirs, d_of_b = group_directions(bl)
    assert dirs.shape[0] == 3            # +x, +y, -x
    assert d_of_b[0] == d_of_b[1] == d_of_b[4]
    assert d_of_b[2] != d_of_b[0]
    assert d_of_b[3] != d_of_b[0]        # opposite direction is distinct
    np.testing.assert_allclose(np.linalg.norm(dirs, axis=1), 1.0,
                               rtol=1e-12)


def _random_sources(S, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(S, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    v[:, 2] = np.abs(v[:, 2])            # upper hemisphere
    pc = np.asarray([0.0, 0.0, 1.0])
    se = v - pc[None, :]
    return se, rng


def _bl_set():
    """Small array with shared directions: EW + NE lattice multiples."""
    a1 = np.asarray([14.6, 0.0, 0.0])
    a2 = np.asarray([7.3, 12.64, 0.0])
    bls = [m * a1 for m in (1, 2, 3)] + [m * a2 for m in (1, 2)] \
        + [a1 + a2, 2 * a1 - a2]
    return np.asarray(bls)


def test_banded_matches_f64_nufft_flat_spectrum():
    """Flat spectra, rank-1 basis: banded spread vs the f64 numpy NUFFT
    (engine accuracy class ~1e-6)."""
    S, C = 512, 64
    nu0, dnu = 150e6, 100e3
    se, rng = _random_sources(S)
    bl = _bl_set()
    amps = rng.uniform(0.1, 1.0, S)

    tau = (se @ bl.T) / CNST.c                       # (S, B)
    gold = nufft_delay_visibilities(tau, amps, nu0, dnu, C)

    plan = make_banded_plan(bl, nu0, dnu, C, rank=1, T_s=128)
    seh, sel = tf.split_f64(se)
    P = jnp.asarray(amps, jnp.float32)[:, None]
    Qc = np.ones((C, 1), np.float32)
    vis, ok = nufft_banded_visibilities(plan, jnp.asarray(seh),
                                        jnp.asarray(sel), P, Qc)
    assert bool(ok)
    vis = np.asarray(vis)
    scale = np.abs(gold).max()
    rel = np.abs(vis - gold).max() / scale
    assert rel < 5e-6, rel


def test_banded_multiblock_sweep():
    """Baselines spanning MANY delay blocks (n_blk_max >> 1): the
    ownership sentinel must keep non-member sources out of every tap
    row (a bare -1 sentinel leaked taps 1..K-1 into rows 0..K-2 of
    every swept block — caught only at multi-block spans)."""
    S, C = 1024, 512
    se, rng = _random_sources(S, seed=11)
    a1 = np.asarray([14.6, 0.0, 0.0])
    a2 = np.asarray([7.3, 12.64, 0.0])
    bl = np.asarray([m * a1 for m in (1, 4, 9, 20)]
                    + [m * a2 for m in (1, 7, 15)] + [20 * a1 + 15 * a2])
    amps = rng.uniform(0.1, 1.0, S)
    tau = (se @ bl.T) / CNST.c
    gold = nufft_delay_visibilities(tau, amps, 150e6, 100e3, C)
    for K in (13, 9):
        plan = make_banded_plan(bl, 150e6, 100e3, C, rank=1, T_s=256,
                                K=K)
        assert plan.n_blk_max >= 4
        seh, sel = tf.split_f64(se)
        P = jnp.asarray(amps, jnp.float32)[:, None]
        Qc = np.ones((C, 1), np.float32)
        vis, ok = nufft_banded_visibilities(plan, jnp.asarray(seh),
                                            jnp.asarray(sel), P, Qc)
        assert bool(ok)
        rel = np.abs(np.asarray(vis) - gold).max() / np.abs(gold).max()
        assert rel < 5e-6, (K, rel)


def test_banded_guards():
    """The block sweep is exact by construction for unit sources, so
    the failure modes are (a) a plan whose row buffer exceeds its byte
    budget — a plan-time ValueError — and (b) non-unit source
    vectors, which trip the runtime ok flag instead of silently
    aliasing bins outside the static block range."""
    S, C = 512, 64
    se, rng = _random_sources(S, seed=3)
    with pytest.raises(ValueError):
        # ~3000 km baseline: a ~6 GB row buffer for one baseline
        make_banded_plan(np.asarray([[3e6, 0.0, 0.0]]), 150e6, 100e3,
                         4096, rank=24)
    with pytest.raises(ValueError):
        make_banded_plan(np.asarray([[300.0, 0.0, 0.0]]), 150e6, 100e3,
                         C, rank=1, G_blk=20)        # not 8-aligned
    plan = make_banded_plan(np.asarray([[300.0, 0.0, 0.0]]), 150e6,
                            100e3, C, rank=1, T_s=512)
    seh, sel = tf.split_f64(se * 3.0)                # NON-unit sources
    P = jnp.asarray(rng.uniform(0.1, 1.0, S), jnp.float32)[:, None]
    Qc = np.ones((C, 1), np.float32)
    vis, ok = nufft_banded_visibilities(plan, jnp.asarray(seh),
                                        jnp.asarray(sel), P, Qc)
    assert not bool(ok)


def test_banded_snapshot_vs_direct_engine():
    """Observe-level banded snapshot vs the exact direct engine on a
    HERA-7 snapshot with chromatic power-law sky + Airy beam."""
    from prisim_tpu import layouts as lay, baselines as bls
    from prisim_tpu.skymodel import SkyModel
    from prisim_tpu.engine import (Instrument, SkySources,
                                   enu_rotation_from_eq)
    from prisim_tpu.engine.observe import simulate_snapshot
    from prisim_tpu.beams import airy_beam

    C = 64
    freqs = 150e6 + 100e3 * np.arange(C)
    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=False)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    rng = np.random.default_rng(7)
    S = 384
    loc = np.stack([rng.uniform(0, 360, S),
                    rng.uniform(-75, 15, S)], axis=-1)
    model = SkyModel(location=loc, spec_kind="power-law", spec_parms={
        "flux-scale": rng.uniform(0.5, 2.0, S),
        "freq-ref": np.full(S, 150e6),
        "power-law-index": rng.uniform(-1.0, -0.6, S)})
    sky = SkySources.from_skymodel(model, freqs)
    Mh, Ml = tf.split_f64(enu_rotation_from_eq(30.0, inst.latitude))
    pch, pcl = tf.split_f64(np.asarray([0.0, 0.0, 1.0]))
    beam_fn = lambda s, f: airy_beam(s, f, 14.0)

    gold = np.asarray(np.asarray(simulate_snapshot(
        inst, sky, jnp.asarray(Mh), jnp.asarray(Ml), jnp.asarray(pch),
        jnp.asarray(pcl), beam_fn, src_block=512)))

    rank = 8
    pinvQ, Q = chebyshev_projection(freqs, rank)
    plan = make_banded_plan(bset.vectors, inst.nu0, inst.dnu, C,
                            rank=rank, T_s=128)
    vis, ok = simulate_snapshot_nufft_banded(
        inst, sky, jnp.asarray(Mh), jnp.asarray(Ml), jnp.asarray(pch),
        jnp.asarray(pcl), beam_fn, plan, pinvQ, Q)
    assert bool(ok)
    vis = np.asarray(vis)
    scale = np.abs(gold).max()
    rel = np.abs(vis - gold).max() / scale
    assert rel < 1e-5, rel


def test_banded_spatial_sort_invariance():
    """make_banded_snapshot_fns(spatial_sort=True) reorders sources by
    NEST index and the kernel sweeps per-tile dynamic block ranges —
    both exactness-preserving, so sorted and unsorted runs must agree
    to summation-order noise."""
    from prisim_tpu import layouts as lay, baselines as bls
    from prisim_tpu.skymodel import SkyModel
    from prisim_tpu.engine import (Instrument, SkySources,
                                   enu_rotation_from_eq)
    from prisim_tpu.engine.nufft_banded import (make_banded_snapshot_fns,
                                                spatial_permutation)
    from prisim_tpu.beams import airy_beam

    C = 32
    freqs = 150e6 + 100e3 * np.arange(C)
    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=False)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    rng = np.random.default_rng(13)
    S = 300
    loc = np.stack([rng.uniform(0, 360, S),
                    rng.uniform(-75, 15, S)], axis=-1)
    model = SkyModel(location=loc, spec_kind="power-law", spec_parms={
        "flux-scale": rng.uniform(0.5, 2.0, S),
        "freq-ref": np.full(S, 150e6),
        "power-law-index": np.full(S, -0.8)})
    sky = SkySources.from_skymodel(model, freqs)
    perm = spatial_permutation(np.asarray(sky.s_eq_hi, np.float64)
                               + np.asarray(sky.s_eq_lo, np.float64))
    assert sorted(perm.tolist()) == list(range(S))    # a permutation

    Mh, Ml = tf.split_f64(enu_rotation_from_eq(30.0, inst.latitude))
    pch, pcl = tf.split_f64(np.asarray([0.0, 0.0, 1.0]))
    beam_fn = lambda s, f: airy_beam(s, f, 14.0)
    rank = 6
    pinvQ, Q = chebyshev_projection(freqs, rank)
    plan = make_banded_plan(bset.vectors, inst.nu0, inst.dnu, C,
                            rank=rank, T_s=128)
    args = tuple(jnp.asarray(a) for a in (Mh, Ml, pch, pcl))
    out = {}
    for flag in (True, False):
        run = make_banded_snapshot_fns(inst, sky, beam_fn, plan, pinvQ,
                                       Q,
                                       spatial_sort=flag)
        v, ok = run(*args)
        assert bool(ok)
        out[flag] = np.asarray(v)
    scale = np.abs(out[False]).max()
    rel = np.abs(out[True] - out[False]).max() / scale
    assert rel < 2e-6, rel


def test_driver_banded_engine_end_to_end():
    # processing.nufft_spread: banded routes through the banded spread;
    # the built-in cross-check gate validates
    # snapshot 0 against the direct engine at 1e-4
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import run_simulation

    p = load_parms({
        "bandpass": {"nchan": 16, "freq": 150e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 64, "seed": 5},
        "pp": {"key": "none"},
        "processing": {"engine": "nufft", "nufft_spread": "banded",
                       "nufft_rank": 8}})
    vs, _ = run_simulation(p, verbose=True, save=False)
    vis = np.asarray(vs.skyvis)
    assert np.isfinite(vis).all() and np.abs(vis).max() > 0

    p2 = load_parms({
        "bandpass": {"nchan": 16, "freq": 150e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 64, "seed": 5},
        "pp": {"key": "none"},
        "processing": {"engine": "direct"}})
    vs2, _ = run_simulation(p2, verbose=False, save=False)
    gold = np.asarray(vs2.skyvis)
    rel = np.abs(vis - gold).max() / np.abs(gold).max()
    assert rel < 1e-4, rel


def test_banded_source_chunked_sweep_matches_unchunked():
    """src_chunk < S routes the snapshot through the in-jit chunk scan
    (the HBM-bounding path the driver needs at north-star direction
    counts); results must match the unchunked run to summation-order
    noise, including a chunk count that does not divide S."""
    from prisim_tpu import layouts as lay, baselines as bls
    from prisim_tpu.skymodel import SkyModel
    from prisim_tpu.engine import (Instrument, SkySources,
                                   enu_rotation_from_eq)
    from prisim_tpu.engine.nufft_banded import (make_banded_plan,
                                                make_banded_snapshot_fns)
    from prisim_tpu.engine.nufft_delay import chebyshev_projection
    from prisim_tpu.beams import airy_beam

    C = 32
    freqs = 150e6 + 100e3 * np.arange(C)
    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=False)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    rng = np.random.default_rng(7)
    S = 300                          # 3 chunks of 128 (padded to 384)
    loc = np.stack([rng.uniform(0, 360, S),
                    rng.uniform(-75, 15, S)], axis=-1)
    model = SkyModel(location=loc, spec_kind="power-law", spec_parms={
        "flux-scale": rng.uniform(0.5, 2.0, S),
        "freq-ref": np.full(S, 150e6),
        "power-law-index": np.full(S, -0.8)})
    sky = SkySources.from_skymodel(model, freqs)
    Mh, Ml = tf.split_f64(enu_rotation_from_eq(30.0, inst.latitude))
    pch, pcl = tf.split_f64(np.asarray([0.0, 0.0, 1.0]))
    beam_fn = lambda s, f: airy_beam(s, f, 14.0)
    rank = 6
    pinvQ, Q = chebyshev_projection(freqs, rank)
    plan = make_banded_plan(bset.vectors, inst.nu0, inst.dnu, C,
                            rank=rank, T_s=128)
    args = tuple(jnp.asarray(a) for a in (Mh, Ml, pch, pcl))
    out = {}
    for chunk in (None, 128):
        run = make_banded_snapshot_fns(inst, sky, beam_fn, plan, pinvQ,
                                       Q,
                                       src_chunk=chunk)
        v, ok = run(*args)
        assert bool(ok)
        out[chunk] = np.asarray(v)
    assert run.n_chunks == 3
    scale = np.abs(out[None]).max()
    rel = np.abs(out[128] - out[None]).max() / scale
    assert rel < 2e-6, rel
