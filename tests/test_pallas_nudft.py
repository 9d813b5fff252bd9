"""Pallas NUDFT kernel (Triton route) vs XLA path and float64 golden, in
the Pallas interpreter — the kernel's arithmetic and wrapper (padding,
tiling, channel offset) without a GPU."""

import numpy as np
import pytest
import jax.numpy as jnp

from prisim_tpu import twofloat as tf
from prisim_tpu.engine.nudft import (nudft_visibilities,
                                     nudft_reference_f64,
                                     freq_grid_scalars)
from prisim_tpu.engine.pallas_nudft import (nudft_pallas, pallas_available,
                                            _sincos_cycles)


def _problem(S=100, B=37, C=48, seed=0):
    rng = np.random.RandomState(seed)
    s = rng.randn(S, 3)
    s /= np.linalg.norm(s, axis=1, keepdims=True)
    s[:, 2] = np.abs(s[:, 2])
    pc = np.asarray([0.0, 0.0, 1.0])
    se = s - pc
    bl = rng.randn(B, 3) * 200.0
    amps = rng.rand(S, C).astype(np.float32)
    nu0, dnu = 150e6, 97656.25
    freqs = nu0 + dnu * np.arange(C)
    seh, sel = tf.split_f64(se)
    blh, bll = tf.split_f64(bl)
    gs = freq_grid_scalars(nu0, dnu)
    return (jnp.asarray(seh), jnp.asarray(sel), jnp.asarray(blh),
            jnp.asarray(bll), jnp.asarray(amps), gs, C,
            se, bl, amps, freqs)


def test_pallas_matches_f64_golden():
    seh, sel, blh, bll, amps, gs, C, se, bl, a_np, freqs = _problem()
    got = np.asarray(nudft_pallas(seh, sel, blh, bll, amps, gs, C,
                                  bl_tile=8, chan_tile=16, src_chunk=32,
                                  interpret=True))
    want = nudft_reference_f64(se, bl, a_np, freqs)
    scale = np.abs(want).max()
    err = np.abs(got - want).max() / scale
    assert err < 2e-6, err


def test_pallas_matches_xla_path():
    seh, sel, blh, bll, amps, gs, C, *_ = _problem(S=70, B=21, C=32,
                                                   seed=1)
    got = np.asarray(nudft_pallas(seh, sel, blh, bll, amps, gs, C,
                                  bl_tile=4, src_chunk=16,
                                  interpret=True))
    ref = np.asarray(nudft_visibilities(seh, sel, blh, bll, amps, gs, C,
                                        src_block=32))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 2e-6


def test_pallas_ragged_sizes():
    # S, B not multiples of the tiles; C not a power of two
    seh, sel, blh, bll, amps, gs, C, se, bl, a_np, freqs = _problem(
        S=53, B=13, C=24, seed=2)
    got = np.asarray(nudft_pallas(seh, sel, blh, bll, amps, gs, C,
                                  bl_tile=8, chan_tile=16, src_chunk=16,
                                  interpret=True))
    assert got.shape == (13, 24)
    want = nudft_reference_f64(se, bl, a_np, freqs)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6


def test_pallas_long_baseline_phase_wraps():
    # |b| = 3 km at 200 MHz: ~2000 phase cycles — stresses frac reduction
    seh, sel, blh, bll, amps, gs, C, se, bl, a_np, freqs = _problem(
        S=40, B=8, C=16, seed=3)
    bl = bl * 15.0
    blh, bll = tf.split_f64(bl)
    got = np.asarray(nudft_pallas(seh, sel, jnp.asarray(blh),
                                  jnp.asarray(bll), amps, gs, C,
                                  bl_tile=8, src_chunk=8,
                                  interpret=True))
    want = nudft_reference_f64(se, bl, a_np, freqs)
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6


def test_pallas_channel_offset():
    """chan0 (a channel shard's offset on the mesh) moves the kernel's
    frequency grid: channels 40..63 of a 64-channel band, with baselines
    long enough that the offset spans many phase cycles."""
    seh, sel, blh, bll, amps, gs, C, se, bl, a_np, freqs = _problem(
        S=64, B=9, C=64, seed=4)
    bl = bl * 10.0
    blh, bll = map(jnp.asarray, tf.split_f64(bl))
    got = np.asarray(nudft_pallas(seh, sel, blh, bll, amps[:, 40:], gs,
                                  24, chan0=40, src_chunk=16,
                                  interpret=True))
    want = nudft_reference_f64(se, bl, a_np[:, 40:], freqs[40:])
    assert np.abs(got - want).max() / np.abs(want).max() < 2e-6


def test_kernel_sincos_polynomial():
    """The kernel's folded-Taylor (cos, sin) of 2 pi f over [-1/2, 1/2]
    stays at the f32 rounding floor."""
    f = np.linspace(-0.5, 0.5, 100001).astype(np.float32)
    c, s = _sincos_cycles(jnp.asarray(f))
    ang = 2.0 * np.pi * f.astype(np.float64)
    assert np.abs(np.asarray(c) - np.cos(ang)).max() < 2e-7
    assert np.abs(np.asarray(s) - np.sin(ang)).max() < 2e-7


@pytest.mark.parametrize("platform,expected", [
    ("gpu", True), ("cpu", False), ("METAL", False)])
def test_pallas_available_per_platform(platform, expected):
    assert pallas_available(platform) is expected


def test_compiled_kernel_refused_off_gpu():
    """Without interpret=True the kernel compiles only for NVIDIA GPUs:
    on the CPU it raises instead of falling back to the interpreter."""
    seh, sel, blh, bll, amps, gs, C, *_ = _problem(S=8, B=2, C=8)
    with pytest.raises(ValueError, match="NVIDIA"):
        nudft_pallas(seh, sel, blh, bll, amps, gs, C)


def test_driver_use_pallas_true_raises_off_gpu():
    """processing.use_pallas: true where the kernel cannot compile is an
    error, never a silent interpreter run; auto picks the XLA engine."""
    from prisim_tpu.config import load_parms
    from prisim_tpu.driver import _use_pallas, run_simulation
    parms = load_parms({
        "bandpass": {"nchan": 8, "freq": 150e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 8, "seed": 1},
        "pp": {"key": "none"},
        "processing": {"use_pallas": True}})
    with pytest.raises(ValueError, match="use_pallas"):
        run_simulation(parms, verbose=False, save=False)
    parms["processing"]["use_pallas"] = "auto"
    assert _use_pallas(parms) is False
