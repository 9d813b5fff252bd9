"""Pallas (Triton route) kernel for the point-source NUDFT visibility sum.

Same sum as nudft.py — V(b, c) = sum_s A(s, c) e^{-2 pi i nu_c tau_sb}
with the cycle count carried in two-float32 and reduced mod 1 before a
single f32 sincos (see that module's docstring and
the reference's prisim/interferometry.py:6323-6376) — laid out for a
GPU's blocks:

* Each program owns one (baseline tile x channel tile) output block,
  held in registers as a (BT, QT, L) tensor: BT baselines, QT coarse
  channel groups of L fine channels. Blocks share nothing, so the grid
  fills the card's SMs with no cross-block carry.
* A fori_loop over single sources runs inside the block. Per (source,
  baseline) the phasor factorizes on the uniform channel grid as
  e(p0 + (q L + r) d) = U_q * W_r: QT + L two-float sincos evaluate the
  whole QT*L-channel row, and the per-channel work is one complex
  multiply and two fused multiply-adds on FP32 cores (the sum is not a
  matrix product: the phasor depends on source, baseline and channel).
* Sources are summed plainly over chunks of `src_chunk` and the chunk
  sums Kahan-folded into the block accumulator, which keeps the f32
  carry's random walk out of the 1e-6 budget at 10^5-10^6 sources.

Gradient and extended-source modes run on the XLA engine
(nudft.nudft_visibilities)."""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .. import twofloat as tf

__all__ = ["nudft_pallas", "pallas_available"]


def pallas_available(platform=None):
    """True where the Triton-route kernel compiles: NVIDIA GPUs.
    `platform` defaults to that of the first JAX device."""
    if platform is None:
        platform = jax.devices()[0].platform
    return platform == "gpu"


def _next_pow2(n):
    p = 1
    while p < n:
        p *= 2
    return p


_SIN = tuple(float(np.float32((-1.0) ** k * (2.0 * np.pi) ** (2 * k + 1)
                               / np.prod(np.arange(1, 2 * k + 2))))
             for k in range(5))
_COS = tuple(float(np.float32((-1.0) ** k * (2.0 * np.pi) ** (2 * k)
                               / np.prod(np.arange(1, 2 * k + 1))))
             for k in range(6))


def _sincos_cycles(f):
    """(cos, sin) of 2 pi f for f in [-1/2, 1/2]: fold to t = f - q/4 in
    [-1/8, 1/8], Taylor polynomials in t (truncation < 2e-9), quadrant
    select. Elementwise only, so each lane evaluates its own channels."""
    q = jnp.floor(f * 4.0 + 0.5)
    t = f - q * 0.25
    t2 = t * t
    sp = np.float32(_SIN[4])
    for c in _SIN[3::-1]:
        sp = sp * t2 + np.float32(c)
    sn = sp * t
    cs = np.float32(_COS[5])
    for c in _COS[4::-1]:
        cs = cs * t2 + np.float32(c)
    qi = q.astype(jnp.int32) & 3
    odd = (qi & 1) == 1
    c1 = jnp.where(odd, sn, cs)
    s1 = jnp.where(odd, cs, sn)
    c1 = jnp.where((qi == 1) | (qi == 2), -c1, c1)
    s1 = jnp.where(qi >= 2, -s1, s1)
    return c1, s1


def _frac(h, l):
    # df_frac with floor(x + 1/2) for round (no round in the Triton
    # lowering); any nearest integer keeps the result in [-1/2, 1/2]
    n = jnp.floor((h + l) + 0.5)
    return tf.fast_two_sum(h - n, l)


def _kernel(scal_ref, src_ref, bl_ref, amps_ref, vr_ref, vi_ref, *,
            n_chunks, src_chunk, BT, CT, dmask):
    g0h, g0l = scal_ref[0], scal_ref[1]
    gdh, gdl = scal_ref[2], scal_ref[3]
    chan0 = scal_ref[4]
    two_pi_h = scal_ref[5]
    # local channel index j CT + i (global: chan0 + local), exact in f32
    cidx = ((pl.program_id(1) * CT).astype(jnp.float32)
            + jax.lax.broadcasted_iota(jnp.float32, (1, CT), 1))
    bh = [bl_ref[k, :][:, None] for k in range(3)]              # (BT, 1)
    bl = [bl_ref[3 + k, :][:, None] for k in range(3)]

    def source(s, acc):
        vr, vi = acc
        # k = s_eff . b in two-float, (BT, 1) meters
        kh = kl = None
        for ax in range(3):
            sh = src_ref[ax, s]
            sl = src_ref[3 + ax, s]
            ph, pe = tf.two_prod(bh[ax], sh)
            pe = pe + (bh[ax] * sl + bl[ax] * sh)
            kh, kl = (ph, pe) if kh is None else tf.df_add(kh, kl, ph, pe)
        # cycles p0 + c d at local channel c: d = k dnu/c and
        # p0 = k nu0/c + chan0 d
        dh, dl = _frac(*tf.df_mul(kh, kl, gdh, gdl))
        oh, oe = tf.two_prod(dh, chan0)
        p0h, p0l = _frac(*tf.df_add(*tf.df_mul(kh, kl, g0h, g0l), oh,
                                    oe + dl * chan0))
        # dA: d with the low mantissa bits cleared, so c dA is exact for
        # every local c; c dB is a small correction
        dA = jax.lax.bitcast_convert_type(
            jax.lax.bitcast_convert_type(dh, jnp.uint32)
            & jnp.uint32(dmask), jnp.float32)
        dB = (dh - dA) + dl
        t, e = tf.two_sum(p0h, cidx * dA)                       # (BT, CT)
        fh = t - jnp.floor(t + 0.5)                             # exact
        fh, e2 = tf.two_sum(fh, cidx * dB)
        fl = (e + e2) + p0l
        c, sn = _sincos_cycles(fh)
        # first-order rotation by the low part: e^{-2 pi i (fh + fl)}
        a = two_pi_h * fl
        c, sn = c - sn * a, sn + c * a
        amp = amps_ref[s, :][None, :]                           # (1, CT)
        return vr + amp * c, vi - amp * sn

    def chunk(c, carry):
        sr, si, cr, ci = carry
        zero = jnp.zeros((BT, CT), jnp.float32)
        vr, vi = jax.lax.fori_loop(c * src_chunk, (c + 1) * src_chunk,
                                   source, (zero, zero))
        yr = vr - cr
        tr = sr + yr
        yi = vi - ci
        ti = si + yi
        return tr, ti, (tr - sr) - yr, (ti - si) - yi

    zero = jnp.zeros((BT, CT), jnp.float32)
    sr, si, _, _ = jax.lax.fori_loop(0, n_chunks, chunk,
                                     (zero, zero, zero, zero))
    vr_ref[...] = sr
    vi_ref[...] = si


@functools.partial(jax.jit, static_argnames=(
    "nchan", "bl_tile", "chan_tile", "src_chunk", "interpret"))
def nudft_pallas(seh, sel, blh, bll, amps, grid_scalars, nchan, chan0=0,
                 bl_tile=1, chan_tile=512, src_chunk=64, interpret=False):
    """Point-source NUDFT, complex64 (B, nchan). Arguments as
    nudft_visibilities; bl_tile x chan_tile is the output block of one
    program (powers of 2; one warp each — the fastest of the tilings
    measured on an H100), src_chunk the plain-summed source run between
    Kahan folds. interpret=True runs the kernel in the Pallas
    interpreter (the CPU tests); without it the kernel compiles only
    for NVIDIA GPUs."""
    if not interpret and not pallas_available():
        raise ValueError("the Pallas NUDFT kernel compiles only for NVIDIA "
                         "GPUs (platform here: %s)"
                         % jax.devices()[0].platform)
    S = seh.shape[0]
    B = blh.shape[0]
    nchan = int(nchan)
    BT, CT = int(bl_tile), min(int(chan_tile), _next_pow2(nchan))
    if BT & (BT - 1) or CT & (CT - 1):
        raise ValueError("bl_tile and chan_tile must be powers of 2")
    C_pad = -(-nchan // CT) * CT
    S_pad = -(-S // src_chunk) * src_chunk
    B_pad = -(-B // BT) * BT

    def rows8(h, l, n):
        # (N, 3) hi/lo pair -> (8, n) rows [hi xyz, lo xyz, 0, 0]
        x = jnp.concatenate([jnp.asarray(h, jnp.float32),
                             jnp.asarray(l, jnp.float32)], axis=1)
        return jnp.pad(x, ((0, n - x.shape[0]), (0, 2))).T

    src = rows8(seh, sel, S_pad)
    bls = rows8(blh, bll, B_pad)
    a = jnp.pad(jnp.asarray(amps, jnp.float32),
                ((0, S_pad - S), (0, C_pad - amps.shape[1])))
    g0h, g0l, gdh, gdl = grid_scalars
    scal = jnp.stack([jnp.asarray(v, jnp.float32) for v in (
        g0h, g0l, gdh, gdl, chan0, tf.TWO_PI_HI, tf.TWO_PI_LO, 0.0)])
    # clear as many low mantissa bits of d as local channel indices
    # need, so that index x d_hi is exact
    cbits = max(1, int(np.ceil(np.log2(C_pad))))
    kernel = functools.partial(_kernel, n_chunks=S_pad // src_chunk,
                               src_chunk=src_chunk, BT=BT, CT=CT,
                               dmask=(0xFFFFFFFF << cbits) & 0xFFFFFFFF)
    out_spec = pl.BlockSpec((BT, CT), lambda i, j: (i, j))
    out_shape = jax.ShapeDtypeStruct((B_pad, C_pad), jnp.float32)
    vr, vi = pl.pallas_call(
        kernel,
        grid=(B_pad // BT, C_pad // CT),
        in_specs=[pl.BlockSpec((8,), lambda i, j: (0,)),
                  pl.BlockSpec((8, S_pad), lambda i, j: (0, 0)),
                  pl.BlockSpec((8, BT), lambda i, j: (0, i)),
                  pl.BlockSpec((S_pad, CT), lambda i, j: (0, j))],
        out_specs=[out_spec, out_spec],
        out_shape=[out_shape, out_shape],
        compiler_params=plgpu.CompilerParams(num_warps=1, num_stages=1),
        interpret=interpret,
        name="nudft_point",
    )(scal, src, bls, a)
    return (vr + 1j * vi)[:B, :nchan]
