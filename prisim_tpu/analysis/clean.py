"""Hogbom CLEAN for 1-D complex (delay-domain) spectra, batched on device.

Rebuild of ``complex1dClean`` (/root/reference/prisim/delay_spectrum.py:
133-354) and ``DelaySpectrum.delayClean`` (:1622-1841). The reference
runs one sequential Python loop per (baseline, time) spectrum, fanned out
over a multiprocessing.Pool (:1748-1777). Here the iteration is a
``lax.while_loop`` (iterations are inherently sequential) and the
(bl, time) fan-out is a ``vmap`` — one fused XLA program, no pools.

Semantics matched to the reference:
* kernel is normalized to peak |k| = 1; the component at the residual
  peak is shifted via a roll of the kernel (circular, as NP.roll does);
* per-iteration clean component = gain * residual_peak;
* termination: |peak| <= threshold * max|input| (relative) or absolute
  threshold, OR maxiter, OR (when a clean box masks out >2 pixels)
  in-box MAD <= out-of-box MAD.
Differences: the rms-vs-iteration history arrays are not returned
(fixed-shape jit cannot grow lists; final in/out MAD and iteration count
are returned instead).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["complex_clean_1d", "batch_clean", "delay_clean_vs"]


def _mad(x, w):
    """Weighted median absolute deviation |x - median(x)| over w>0."""
    med_r = _wmedian(jnp.real(x), w)
    med_i = _wmedian(jnp.imag(x), w)
    dev = jnp.abs(x - (med_r + 1j * med_i))
    return _wmedian(dev, w)


def _wmedian(vals, w):
    """Median of vals where w > 0 (jit-safe: sorts with +inf padding)."""
    big = jnp.where(w > 0, vals, jnp.inf)
    n = jnp.sum(w > 0)
    s = jnp.sort(big)
    idx_hi = jnp.clip(n // 2, 0, vals.size - 1)
    idx_lo = jnp.clip((n - 1) // 2, 0, vals.size - 1)
    return 0.5 * (s[idx_lo] + s[idx_hi])


@functools.partial(jax.jit, static_argnames=("maxiter", "use_box_stop"))
def complex_clean_1d(inp, kernel, cbox=None, gain=0.1, maxiter=100,
                     threshold=5e-3, threshold_abs=False,
                     use_box_stop=True):
    """CLEAN one complex spectrum.

    inp, kernel: (n,) complex; cbox: (n,) bool or None.
    Returns dict(cc, res, niter, inrms, outrms, terminated_by).
    terminated_by codes: 0 threshold, 1 maxiter, 2 inrms<outrms."""
    inp = jnp.asarray(inp, dtype=jnp.complex64)
    kernel = jnp.asarray(kernel, dtype=jnp.complex64)
    n = inp.shape[0]
    kernel = kernel / jnp.max(jnp.abs(kernel))
    kmaxind = jnp.argmax(jnp.abs(kernel))
    if cbox is None:
        cbox_f = jnp.ones(n, dtype=jnp.float32)
        has_out = False
    else:
        cbox_f = jnp.asarray(cbox, dtype=jnp.float32)
        has_out = True
    inp_max = jnp.max(jnp.abs(inp))
    lolim = jnp.where(threshold_abs,
                      threshold / jnp.maximum(inp_max, 1e-30),
                      threshold)

    def cond(state):
        cc, res, itr, done_code = state
        return done_code < 0

    def body(state):
        cc, res, itr, _ = state
        masked = jnp.abs(res) * cbox_f
        ind = jnp.argmax(masked)
        maxres = res[ind]
        ccval = gain * maxres
        cc = cc.at[ind].add(ccval)
        res = res - ccval * jnp.roll(kernel, ind - kmaxind)
        itr = itr + 1
        cond1 = jnp.abs(maxres) <= lolim * inp_max
        cond2 = itr >= maxiter
        code = jnp.where(cond1, 0, jnp.where(cond2, 1, -1))
        if has_out and use_box_stop:
            n_out = jnp.sum(1.0 - cbox_f)
            inr = _mad(res, cbox_f)
            outr = _mad(res, 1.0 - cbox_f)
            cond3 = (n_out > 2) & (inr <= outr)
            code = jnp.where((code < 0) & cond3, 2, code)
        return (cc, res, itr, code)

    cc0 = jnp.zeros_like(inp)
    state = (cc0, inp, jnp.int32(0), jnp.int32(-1))
    cc, res, niter, code = jax.lax.while_loop(cond, body, state)
    inrms = _mad(res, cbox_f)
    outrms = _mad(res, 1.0 - cbox_f) if has_out else jnp.float32(0.0)
    return dict(cc=cc, res=res, niter=niter, inrms=inrms, outrms=outrms,
                terminated_by=code)


def batch_clean(specs, kernels, cboxes=None, gain=0.1, maxiter=100,
                threshold=5e-3, threshold_abs=False, use_box_stop=True):
    """vmap complex_clean_1d over leading batch axes.

    specs, kernels: (..., n) complex; cboxes: (..., n) bool or None.
    Returns dict of stacked outputs (the reference's Pool fan-out,
    /root/reference/prisim/delay_spectrum.py:1748-1777)."""
    specs = jnp.asarray(specs, dtype=jnp.complex64)
    kernels = jnp.broadcast_to(
        jnp.asarray(kernels, dtype=jnp.complex64), specs.shape)
    batch_shape = specs.shape[:-1]
    n = specs.shape[-1]
    flat_s = specs.reshape(-1, n)
    flat_k = kernels.reshape(-1, n)
    if cboxes is None:
        fn = jax.vmap(lambda s, k: complex_clean_1d(
            s, k, None, gain, maxiter, threshold, threshold_abs,
            use_box_stop=False))
        out = fn(flat_s, flat_k)
    else:
        flat_b = jnp.broadcast_to(jnp.asarray(cboxes),
                                  specs.shape).reshape(-1, n)
        fn = jax.vmap(lambda s, k, b: complex_clean_1d(
            s, k, b, gain, maxiter, threshold, threshold_abs,
            use_box_stop=use_box_stop))
        out = fn(flat_s, flat_k, flat_b)
    return {key: np.asarray(val).reshape(
        batch_shape + (() if val.ndim == 1 else (n,)))
        for key, val in out.items()}


def delay_clean_vs(vs, pad=1.0, gain=0.1, maxiter=100, threshold=5e-3,
                   horizon_buffer=0.0):
    """Delay-CLEAN all (bl, time) delay spectra of a VisibilitySet
    (DelaySpectrum.delayClean, /root/reference/prisim/delay_spectrum.py:
    1622): delay-transform, build per-baseline horizon clean boxes
    (|lag| <= |b|/c + buffer), CLEAN, return dict with cc/residual lag
    cubes shaped (nbl, nlag, n_acc)."""
    from ..vis import delay_transform
    vst = delay_transform(vs, pad=pad)
    lags = vst.lags
    cubes = {}
    for name in ("skyvis_lag", "vis_lag", "vis_noise_lag"):
        if getattr(vst, name) is not None:
            cubes[name] = np.asarray(getattr(vst, name))
    kern = np.asarray(vst.lag_kernel)
    blc = vs.baseline_lengths / 299792458.0 + horizon_buffer
    cbox = (np.abs(lags)[None, :, None] <=
            blc[:, None, None])                  # (nbl, nlag, 1)
    out = {"lags": lags}
    for name, cube in cubes.items():
        x = np.transpose(cube, (0, 2, 1))        # (nbl, nacc, nlag)
        k = np.transpose(kern, (0, 2, 1))
        b = np.broadcast_to(np.transpose(cbox, (0, 2, 1)), x.shape)
        res = batch_clean(x, k, b, gain=gain, maxiter=maxiter,
                          threshold=threshold)
        out["cc_" + name] = np.transpose(res["cc"], (0, 2, 1))
        out["res_" + name] = np.transpose(res["res"], (0, 2, 1))
        out["niter_" + name] = res["niter"]
    return out
