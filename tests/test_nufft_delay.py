"""Experimental delay-space NUFFT vs the direct f64 DFT."""

import numpy as np
import pytest

from prisim_tpu.engine.nufft_delay import nufft_delay_visibilities


def _direct(tau, amps, nu0, dnu, nchan):
    nus = nu0 + dnu * np.arange(nchan)
    ph = np.exp(-2j * np.pi * nus[None, None, :] * tau[:, :, None])
    return np.sum(amps[:, :, None] * ph, axis=0)


def test_nufft_matches_direct():
    rng = np.random.RandomState(0)
    S, B, C = 700, 12, 256
    nu0, dnu = 100e6, 97656.25
    # HERA-scale delays: up to ~300 m baselines
    tau = rng.uniform(-1e-6, 1e-6, (S, B))
    amps = rng.uniform(0.1, 10.0, (S, B))
    V = nufft_delay_visibilities(tau, amps, nu0, dnu, C)
    Vd = _direct(tau, amps, nu0, dnu, C)
    rel = np.abs(V - Vd).max() / np.abs(Vd).max()
    assert rel < 1e-9, rel


def test_nufft_accuracy_vs_taps():
    """More taps -> monotonically better accuracy (sanity of the KB
    kernel/deconvolution pairing)."""
    rng = np.random.RandomState(1)
    S, B, C = 300, 4, 128
    nu0, dnu = 150e6, 1e5
    tau = rng.uniform(-5e-7, 5e-7, (S, B))
    amps = rng.uniform(0.5, 2.0, (S, B))
    Vd = _direct(tau, amps, nu0, dnu, C)
    rels = []
    for K in (5, 9, 13):
        V = nufft_delay_visibilities(tau, amps, nu0, dnu, C, K=K)
        rels.append(np.abs(V - Vd).max() / np.abs(Vd).max())
    assert rels[0] > rels[1] > rels[2]
    assert rels[1] < 1e-6


def test_nufft_multiperiod_folding():
    """Delays spanning several 1/dnu periods fold exactly (long
    baselines at fine channel widths)."""
    rng = np.random.RandomState(4)
    S, B, C = 200, 3, 64
    nu0, dnu = 150e6, 1e5
    tau = rng.uniform(-3e-5, 3e-5, (S, B))   # ~6 periods
    amps = rng.uniform(0.5, 2.0, (S, B))
    V = nufft_delay_visibilities(tau, amps, nu0, dnu, C)
    Vd = _direct(tau, amps, nu0, dnu, C)
    assert np.abs(V - Vd).max() / np.abs(Vd).max() < 1e-9


def test_nufft_spectral_lowrank():
    """Power-law spectra over a full octave compress to rank ~12."""
    from prisim_tpu.engine.nufft_delay import \
        nufft_delay_visibilities_spectral
    rng = np.random.RandomState(2)
    S, B, C = 512, 6, 128
    nu0, dnu = 100e6, 781250.0          # 100-200 MHz
    freqs = nu0 + dnu * np.arange(C)
    tau = rng.uniform(-6e-7, 6e-7, (S, B))
    F = rng.uniform(0.1, 10.0, S)
    al = rng.uniform(-2.5, 0.0, S)
    A = F[:, None] * (freqs[None, :] / 150e6) ** al[:, None]
    V, trunc = nufft_delay_visibilities_spectral(tau, A, nu0, dnu, C,
                                                 rank=12)
    ph = np.exp(-2j * np.pi * freqs[None, None, :] * tau[:, :, None])
    Vd = np.sum(A[:, None, :] * ph, axis=0)
    rel = np.abs(V - Vd).max() / np.abs(Vd).max()
    assert rel < 1e-8, rel
    assert trunc < 1e-10


def test_nufft_jax_port():
    """f32+two-float jax port matches the f64 reference to ~3e-6 and is
    jittable."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine.nufft_delay import nufft_delay_visibilities_jax
    rng = np.random.RandomState(3)
    S, B, C = 400, 8, 128
    nu0, dnu = 100e6, 97656.25
    tau = rng.uniform(-1e-6, 1e-6, (S, B))
    amps = rng.uniform(0.1, 10.0, (S, B)).astype(np.float32)
    th, tl = tf.split_f64(tau)
    fn = jax.jit(lambda a, b, c: nufft_delay_visibilities_jax(
        a, b, c, nu0, dnu, C))
    Vj = np.asarray(fn(jnp.asarray(th), jnp.asarray(tl),
                       jnp.asarray(amps)))
    Vd = _direct(tau, amps.astype(np.float64), nu0, dnu, C)
    rel = np.abs(Vj - Vd).max() / np.abs(Vd).max()
    assert rel < 1e-5, rel


def test_nufft_snapshot_vs_direct_engine():
    """Observe-level NUFFT path vs simulate_snapshot on a real HERA-19
    snapshot (Airy beams, power-law spectra)."""
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu import layouts as lay, baselines as bls, skymodel as sm
    from prisim_tpu.engine import (Instrument, SkySources,
                                   enu_rotation_from_eq)
    from prisim_tpu.engine.observe import simulate_snapshot
    from prisim_tpu.engine.nufft_delay import simulate_snapshot_nufft
    from prisim_tpu.beams import airy_beam

    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=False)
    nchan = 64
    freqs = 120e6 + 97656.25 * np.arange(nchan)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    sky = SkySources.from_skymodel(
        sm.random_point_source_model(128, seed=0), freqs)
    Mh, Ml = tf.split_f64(enu_rotation_from_eq(30.0, inst.latitude))
    pch, pcl = tf.split_f64(np.array([0.0, 0.0, 1.0]))
    beam = lambda dc, f: airy_beam(dc, f, 14.0)
    args = [jnp.asarray(x) for x in (Mh, Ml, pch, pcl)]
    V0 = np.asarray(simulate_snapshot(inst, sky, *args, beam))
    V1 = simulate_snapshot_nufft(inst, sky, *args, beam)
    rel = np.abs(V1 - V0).max() / np.abs(V0).max()
    assert rel < 2e-5, rel


def test_nufft_jax_baseline_sharded():
    """The jax NUFFT composes with shard_map over the baseline axis
    (each shard grids and FFTs its own baselines independently)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from jax import shard_map
    from prisim_tpu import twofloat as tf
    from prisim_tpu.parallel import make_mesh
    from prisim_tpu.engine.nufft_delay import nufft_delay_visibilities_jax

    rng = np.random.RandomState(5)
    S, B, C = 200, 8, 64
    nu0, dnu = 100e6, 97656.25
    tau = rng.uniform(-1e-6, 1e-6, (S, B))
    amps = rng.uniform(0.1, 10.0, (S, B)).astype(np.float32)
    th, tl = tf.split_f64(tau)
    mesh = make_mesh((4,), ("bl",), devices=jax.devices()[:4])

    def local(a, b, c):
        return nufft_delay_visibilities_jax(a, b, c, nu0, dnu, C)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(P(None, "bl"), P(None, "bl"),
                             P(None, "bl")),
                   out_specs=P("bl", None))
    Vs = np.asarray(jax.jit(fn)(jnp.asarray(th), jnp.asarray(tl),
                                jnp.asarray(amps)))
    V1 = np.asarray(nufft_delay_visibilities_jax(
        jnp.asarray(th), jnp.asarray(tl), jnp.asarray(amps),
        nu0, dnu, C))
    np.testing.assert_allclose(Vs, V1, rtol=0, atol=2e-5 * np.abs(V1).max())


def test_nufft_gather_variant():
    """Scatter-free gather-based spreading
    matches the f64 reference; undersized window degrades measurably
    (guard against silent source drops going unnoticed)."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine.nufft_delay import \
        nufft_delay_visibilities_jax_gather
    rng = np.random.RandomState(6)
    S, B, C = 400, 6, 128
    nu0, dnu = 100e6, 97656.25
    tau = rng.uniform(-1e-6, 1e-6, (S, B))
    amps = rng.uniform(0.1, 10.0, (S, B)).astype(np.float32)
    th, tl = tf.split_f64(tau)
    n = 2 * C
    h = 1.0 / (n * dnu)
    m0 = np.rint(tau / h).astype(int) % n
    occ = max(np.histogram(m0[:, b], bins=np.arange(n + 1))[0].max()
              for b in range(B))
    W = int(14 * occ + 16)
    fn = jax.jit(lambda a, b, c: nufft_delay_visibilities_jax_gather(
        a, b, c, nu0, dnu, C, W))
    Vg = np.asarray(fn(jnp.asarray(th), jnp.asarray(tl),
                       jnp.asarray(amps)))
    Vd = _direct(tau, amps.astype(np.float64), nu0, dnu, C)
    rel = np.abs(Vg - Vd).max() / np.abs(Vd).max()
    assert rel < 1e-5, rel
    Vs = np.asarray(nufft_delay_visibilities_jax_gather(
        jnp.asarray(th), jnp.asarray(tl), jnp.asarray(amps),
        nu0, dnu, C, window=4))
    assert np.abs(Vs - Vd).max() / np.abs(Vd).max() > 1e-3


def test_nufft_spectral_chebyshev_basis():
    """Fixed Chebyshev basis (no data-dependent SVD — the jittable
    round-2 factorization) matches the SVD basis."""
    from prisim_tpu.engine.nufft_delay import \
        nufft_delay_visibilities_spectral
    rng = np.random.RandomState(7)
    S, B, C = 300, 4, 128
    nu0, dnu = 100e6, 781250.0
    freqs = nu0 + dnu * np.arange(C)
    tau = rng.uniform(-6e-7, 6e-7, (S, B))
    A = rng.uniform(0.1, 10.0, S)[:, None] \
        * (freqs[None, :] / 150e6) ** rng.uniform(-2.5, 0.0, S)[:, None]
    Vd = np.sum(A[:, None, :] * np.exp(
        -2j * np.pi * freqs[None, None, :] * tau[:, :, None]), axis=0)
    V, resid = nufft_delay_visibilities_spectral(
        tau, A, nu0, dnu, C, rank=10, basis="chebyshev")
    assert resid < 1e-8
    assert np.abs(V - Vd).max() / np.abs(Vd).max() < 1e-8

def test_gather_auto_window_sizing():
    """window=None auto-sizes from concrete delays (no silent source
    drops); size_gather_window bounds the sliding-bin occupancy even for
    CLUSTERED delays."""
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine.nufft_delay import (
        nufft_delay_visibilities_jax_gather, size_gather_window)
    rng = np.random.RandomState(11)
    S, B, C = 300, 4, 64
    nu0, dnu = 100e6, 97656.25
    # heavily clustered delays: half the sources in a tiny interval
    tau = np.concatenate([
        rng.uniform(-1e-6, 1e-6, (S // 2, B)),
        rng.uniform(0.0, 2e-9, (S - S // 2, B))], axis=0)
    amps = rng.uniform(0.1, 10.0, (S, B)).astype(np.float32)
    th, tl = tf.split_f64(tau)
    V = np.asarray(nufft_delay_visibilities_jax_gather(
        jnp.asarray(th), jnp.asarray(tl), jnp.asarray(amps),
        nu0, dnu, C))                      # window=None -> auto
    Vd = _direct(tau, amps.astype(np.float64), nu0, dnu, C)
    rel = np.abs(V - Vd).max() / np.abs(Vd).max()
    assert rel < 1e-5, rel
    W = size_gather_window(tau, dnu, C)
    assert W >= S - S // 2                 # covers the clustered bin


def test_nufft_sorted_variant():
    """Sorted segment-sum spreading (occupancy-independent path;
    sort + compensated cumsum + boundary difference + polynomial tap
    weights) matches the f64 reference on CLUSTERED delays — the case
    whose worst-case occupancy blows up the gather window — at the
    ~3e-7 class, and the sort/boundary setup is reusable across
    spectral ranks."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine.nufft_delay import (
        nufft_delay_visibilities_jax_sorted, _sorted_spread_setup,
        fold_delay_bins)
    rng = np.random.RandomState(8)
    S, B, C = 1024, 6, 128
    nu0, dnu = 100e6, 97656.25
    # half the sources cluster within a couple of delay bins
    tau = np.concatenate([rng.uniform(-1e-6, 1e-6, (S // 2, B)),
                          rng.normal(0.0, 2e-8, (S // 2, B))])
    amps = rng.uniform(0.1, 10.0, (S, B)).astype(np.float32)
    th, tl = tf.split_f64(tau)
    fn = jax.jit(lambda a, b, c: nufft_delay_visibilities_jax_sorted(
        a, b, c, nu0, dnu, C))
    Vs = np.asarray(fn(jnp.asarray(th), jnp.asarray(tl),
                       jnp.asarray(amps)))
    Vd = _direct(tau, amps.astype(np.float64), nu0, dnu, C)
    rel = np.abs(Vs - Vd).max() / np.abs(Vd).max()
    assert rel < 1.5e-6, rel
    # precomputed setup path (rank-loop reuse) is identical
    m0, _, n = fold_delay_bins(jnp.asarray(th), jnp.asarray(tl), dnu, C)
    setup = _sorted_spread_setup(m0, n)
    V2 = np.asarray(nufft_delay_visibilities_jax_sorted(
        jnp.asarray(th), jnp.asarray(tl), jnp.asarray(amps),
        nu0, dnu, C, setup=setup))
    # jit-vs-eager fusion rounding only — the plan must not change bins
    assert np.abs(V2 - Vs).max() / np.abs(Vd).max() < 1e-6
