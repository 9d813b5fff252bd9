"""Generic-aperture and feed-illumination beams
(reference primary_beams.py:1758, 2344, 2572)."""

import numpy as np
import jax.numpy as jnp

from prisim_tpu import constants as CNST
from prisim_tpu.beams import (array_field_pattern,
                              generic_aperture_field_pattern,
                              feed_illumination_of_aperture,
                              feed_aperture_combined_field_pattern,
                              mwa_tile_positions, primary_beam)


def _sky(n=40, seed=2):
    rng = np.random.RandomState(seed)
    lm = 0.8 * (rng.rand(n, 2) - 0.5)
    nn = np.sqrt(1.0 - (lm ** 2).sum(axis=1))
    return np.column_stack([lm, nn])


FREQS = np.linspace(140e6, 160e6, 5)


def test_generic_aperture_matches_array_field_pattern():
    """MWA tile from aperture samples == array_field_pattern: same
    isotropic radiators, same result."""
    pos = mwa_tile_positions()
    dc = _sky()
    af = np.asarray(array_field_pattern(pos, dc, FREQS))
    gen = np.asarray(generic_aperture_field_pattern(pos, dc, FREQS))
    np.testing.assert_allclose(gen, af, rtol=1e-5, atol=1e-7)
    # with pointing compensation
    p = np.asarray([0.1, -0.05, np.sqrt(1 - 0.1 ** 2 - 0.05 ** 2)])
    af_p = np.asarray(array_field_pattern(pos, dc, FREQS,
                                          pointing_dircos=p))
    gen_p = np.asarray(generic_aperture_field_pattern(
        pos, dc, FREQS, pointing_dircos=p))
    np.testing.assert_allclose(gen_p, af_p, rtol=1e-5, atol=1e-7)


def test_generic_aperture_freq_dependent_gains():
    """(nelem, nchan) complex gains — the capability array_field_pattern
    lacks — against a direct numpy evaluation."""
    rng = np.random.RandomState(4)
    pos = rng.randn(6, 3) * 2.0
    pos[:, 2] = 0.0
    dc = _sky(10)
    g = rng.randn(6, FREQS.size) + 1j * rng.randn(6, FREQS.size)
    out = np.asarray(generic_aperture_field_pattern(
        pos, dc, FREQS, gains=g))[:, :, 0]
    geom = -(dc @ pos.T) / CNST.c
    golden = np.einsum(
        "ac,sac->sc", g,
        np.exp(2j * np.pi * FREQS[None, None, :]
               * geom[:, :, None])) / pos.shape[0]
    np.testing.assert_allclose(out, golden, rtol=2e-4, atol=1e-6)


def test_delta_feed_illumination_is_uniform():
    pos = mwa_tile_positions()
    rel, illum = feed_illumination_of_aperture(
        pos, {"shape": "delta"}, FREQS)
    np.testing.assert_allclose(np.asarray(illum),
                               np.ones_like(np.asarray(illum)))
    # delta feed -> combined pattern reduces to the bare aperture factor
    dc = _sky(12)
    comb = np.asarray(feed_aperture_combined_field_pattern(
        pos, {"shape": "delta"}, dc, FREQS, power=True))
    bare = np.asarray(generic_aperture_field_pattern(
        pos, dc, FREQS, power=True))
    np.testing.assert_allclose(comb, bare, rtol=1e-5, atol=1e-7)


def test_dipole_feed_weights_aperture():
    """A dipole feed above the aperture plane produces non-uniform
    illumination and modifies the beam."""
    rng = np.random.RandomState(8)
    pos = np.column_stack([rng.uniform(-7, 7, 64),
                           rng.uniform(-7, 7, 64), np.zeros(64)])
    feed = {"shape": "dipole", "size": 0.74,
            "orientation_dircos": (1.0, 0.0, 0.0),
            "position": (0.0, 0.0, 5.0)}
    rel, illum = feed_illumination_of_aperture(pos, feed, FREQS)
    illum = np.asarray(illum)
    assert np.std(np.abs(illum[:, 0, 0])) > 1e-3
    dc = _sky(12)
    comb = np.asarray(feed_aperture_combined_field_pattern(
        pos, feed, dc, FREQS, power=True))
    bare = np.asarray(generic_aperture_field_pattern(
        pos, dc, FREQS, power=True))
    assert comb.shape == bare.shape
    assert not np.allclose(comb, bare)


def test_dispatch_aperture_locs():
    """telescope['aperture_locs'] routes primary_beam through the
    generic-aperture path."""
    pos = mwa_tile_positions()
    dc = _sky(15)
    pb = np.asarray(primary_beam(jnp.asarray(dc),
                                 jnp.asarray(FREQS, jnp.float32),
                                 {"aperture_locs": pos}))
    golden = np.asarray(generic_aperture_field_pattern(
        pos, dc, FREQS.astype(np.float32), power=True))
    np.testing.assert_allclose(pb, golden, rtol=1e-5, atol=1e-7)
    pb_feed = np.asarray(primary_beam(
        jnp.asarray(dc), jnp.asarray(FREQS, jnp.float32),
        {"aperture_locs": pos, "feedinfo": {"shape": "delta"}}))
    np.testing.assert_allclose(pb_feed, golden, rtol=1e-5, atol=1e-7)
