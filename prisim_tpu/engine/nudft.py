"""Non-uniform DFT visibility kernel (the framework's metric kernel).

Computes V(b, nu_c) = sum_src A(src, c) * exp(-2 pi i nu_c (tau_src,b - tau_pc,b))
— the hot loop of the reference's InterferometerArray.observe()
(the reference's prisim/interferometry.py:6323-6376) — redesigned for
float32 accelerators:

* **Precision without float64.** The phase cycle count nu*(s.b)/c reaches
  ~1e3 cycles; float32 alone quantizes phase at ~1e-4 rad. All cycle
  arithmetic here is double-float32 (see ../twofloat.py), reduced mod 1
  exactly, giving ~1e-7-cycle accuracy before a single f32 sincos.

* **Transcendental hoisting (U.W factorization).** On a uniform channel
  grid nu_c = nu0 + c*dnu, the per-(src,bl,chan) phase splits as
  p(c) = p0 + c*d with c = q*L + r. We evaluate phasors
  U[s,b,q] = e^{-2pi i (p0 + qL d)} and W[s,b,r] = e^{-2pi i (r d)} —
  O(S*B*(C/L + L)) sincos — and form the full phasor as one complex
  multiply per (s,b,c). For C=1024, L=32 that is a 16x cut in
  transcendental work; the inner loop is pure multiply-accumulate.
  Every contraction runs at Precision.HIGHEST: at default precision an
  NVIDIA GPU may take f32 products in TF32 (~1e-3 relative).

* **Static shapes, scan-blocked sources.** Sources stream through in
  fixed-size blocks under lax.scan so the working set stays bounded and
  XLA can pipeline; the ROI cut of the reference becomes amplitude
  masking (beam is zero below the horizon) plus optional host-side
  gathers — no data-dependent shapes anywhere.

The Pallas kernel in pallas_nudft.py implements the same factorization
for point sources in registers; this module is the portable XLA path
and the correctness reference for it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as CNST
from .. import twofloat as tf

__all__ = ["nudft_visibilities", "nudft_reference_f64", "freq_grid_scalars",
           "choose_ql"]


def freq_grid_scalars(nu0, dnu):
    """Host-side: split (nu0/c, dnu/c) into two-float32 scalars."""
    g0h, g0l = tf.split_f64(np.float64(nu0) / CNST.c)
    gdh, gdl = tf.split_f64(np.float64(dnu) / CNST.c)
    return (jnp.float32(g0h), jnp.float32(g0l),
            jnp.float32(gdh), jnp.float32(gdl))


def choose_ql(nchan):
    """Pick the channel factorization C <= Q*L with L ~ sqrt(C)."""
    L = 1
    while L * L < nchan:
        L *= 2
    Q = -(-nchan // L)
    return Q, L


def _phasors(p0h, p0l, dh, dl, steps):
    """Phasors e^{-2 pi i frac(p0 + k*d)} for integer k in `steps`.

    p0, d: (S, B) two-floats; steps: (K,) float32 exact integers.
    Returns (cos, sin) of shape (S, B, K) — sin already negated.
    """
    k = steps.reshape(1, 1, -1)
    # (p0 + k*d) in two-float: k*dh is exact-ish via two_prod; k*dl small.
    mh, ml = tf.two_prod(dh[..., None], k)
    ml = ml + dl[..., None] * k
    th, tl = tf.df_add(p0h[..., None], p0l[..., None], mh, ml)
    th, tl = tf.df_frac(th, tl, xp=jnp)
    cosv, sinv = tf.df_sincos_cycles(th, tl, xp=jnp)
    return cosv, -sinv


def _source_block_vis(seh, sel, blh, bll, amps, g0h, g0l, gdh, gdl, Q, L,
                      chan0=0, s_sky=None, bl_len=None, inv_wl=None,
                      sigma_uv=None, gradient=False):
    """Visibility contribution of one source block.

    seh/sel: (S, 3) effective direction cosines (s_hat - pc_hat), two-float
    blh/bll: (B, 3) baseline vectors (meters), two-float
    amps:    (S, Q*L) beam-weighted fluxes (padded channels are zero)
    Returns (V_re, V_im): (B, Q*L) float32, plus optional gradient
    (3, B, Q*L).
    """
    kh, kl = tf.df_dot3(seh[:, None, :], sel[:, None, :],
                        blh[None, :, :], bll[None, :, :])      # (S, B) meters
    p0h, p0l = tf.df_frac(*tf.df_mul(kh, kl, g0h, g0l), xp=jnp)
    dh, dl = tf.df_frac(*tf.df_mul(kh, kl, gdh, gdl), xp=jnp)

    S, B = kh.shape
    # chan0 shifts the local grid under channel sharding: global channel
    # index is chan0 + q*L + r (chan0 may be a traced axis offset).
    q_steps = (jnp.arange(Q, dtype=jnp.float32) * jnp.float32(L)
               + jnp.asarray(chan0, dtype=jnp.float32))
    r_steps = jnp.arange(L, dtype=jnp.float32)
    Uc, Us = _phasors(p0h, p0l, dh, dl, q_steps)               # (S, B, Q)
    Wc, Ws = _phasors(jnp.zeros_like(p0h), jnp.zeros_like(p0l),
                      dh, dl, r_steps)                          # (S, B, L)

    A = amps.reshape(S, Q, L)

    wts = None
    if sigma_uv is not None:
        # Extended-source gaussian visibility weights
        # (cf. /root/reference/prisim/interferometry.py:6257-6283):
        # w = exp(-0.5 (u_proj / sigma_src)^2),
        # u_proj = sqrt(|b|^2 - (s_sky.b)^2) / lambda_c.
        ksky = jnp.einsum("sk,bk->sb", s_sky, blh,
                          precision=jax.lax.Precision.HIGHEST)   # (S, B)
        proj = jnp.sqrt(jnp.clip(bl_len[None, :] ** 2 - ksky ** 2, 0.0,
                                 None))                          # meters
        u_proj = proj[:, :, None] * inv_wl[None, None, :]       # (S,B,C)
        wts = jnp.exp(-0.5 * (u_proj / sigma_uv[:, None, None]) ** 2)
        wts = wts.reshape(S, B, Q, L)

    def chan_group(_, q):
        Aq = A[:, q, :]                                          # (S, L)
        # T = A * W  (complex with A real), shapes (S, B, L)
        Tr = Aq[:, None, :] * Wc
        Ti = Aq[:, None, :] * Ws
        if wts is not None:
            wq = wts[:, :, q, :]
            Tr = Tr * wq
            Ti = Ti * wq
        ur = Uc[:, :, q]
        ui = Us[:, :, q]
        hi = jax.lax.Precision.HIGHEST
        vr = jnp.einsum("sb,sbl->bl", ur, Tr, precision=hi) - \
            jnp.einsum("sb,sbl->bl", ui, Ti, precision=hi)
        vi = jnp.einsum("sb,sbl->bl", ur, Ti, precision=hi) + \
            jnp.einsum("sb,sbl->bl", ui, Tr, precision=hi)
        if gradient:
            # G[k] = sum_s s_sky[k] * A * E  (cf. interferometry.py:6313-6343)
            gr = jnp.einsum("sk,sb,sbl->kbl", s_sky, ur, Tr,
                            precision=hi) - \
                jnp.einsum("sk,sb,sbl->kbl", s_sky, ui, Ti,
                           precision=hi)
            gi = jnp.einsum("sk,sb,sbl->kbl", s_sky, ur, Ti,
                            precision=hi) + \
                jnp.einsum("sk,sb,sbl->kbl", s_sky, ui, Tr,
                           precision=hi)
            return None, (vr, vi, gr, gi)
        return None, (vr, vi)

    _, out = jax.lax.scan(chan_group, None, jnp.arange(Q))
    if gradient:
        vr, vi, gr, gi = out
        return (jnp.transpose(vr, (1, 0, 2)).reshape(B, Q * L),
                jnp.transpose(vi, (1, 0, 2)).reshape(B, Q * L),
                jnp.transpose(gr, (1, 2, 0, 3)).reshape(3, B, Q * L),
                jnp.transpose(gi, (1, 2, 0, 3)).reshape(3, B, Q * L))
    vr, vi = out
    return (jnp.transpose(vr, (1, 0, 2)).reshape(B, Q * L),
            jnp.transpose(vi, (1, 0, 2)).reshape(B, Q * L))


@functools.partial(jax.jit,
                   static_argnames=("nchan", "src_block", "gradient",
                                    "ql"))
def nudft_visibilities(seh, sel, blh, bll, amps, grid_scalars, nchan,
                       chan0=0, src_shape_sigma=None, s_sky=None,
                       inv_wl=None, src_block=512, gradient=False,
                       ql=None):
    """Full NUDFT over all sources, scan-blocked.

    seh/sel : (S, 3) two-float effective dircos (s_hat - pc_hat) per source
    blh/bll : (B, 3) two-float baselines (meters, local ENU)
    amps    : (S, C) float32 beam-weighted source fluxes (Jy)
    grid_scalars : output of freq_grid_scalars(nu0, dnu)
    nchan   : static int (jnp arrays are padded to Q*L internally)
    src_shape_sigma : optional (S,) gaussian sigma in uv units for extended
        sources; requires s_sky (S,3) f32 sky dircos and inv_wl (C,) 1/lambda.
    gradient: also return dV/db "moment" sums (3, B, C) complex.

    Returns complex64 (B, C) visibilities (and gradient if requested).
    """
    g0h, g0l, gdh, gdl = grid_scalars
    S = seh.shape[0]
    B = blh.shape[0]
    nchan = int(nchan)
    Q, L = ql if ql is not None else choose_ql(nchan)
    if Q * L < nchan:
        raise ValueError("ql=%r covers %d < nchan=%d channels"
                         % (ql, Q * L, nchan))
    C_pad = Q * L

    if amps.shape[1] < C_pad:
        amps = jnp.pad(amps, ((0, 0), (0, C_pad - amps.shape[1])))
    if inv_wl is not None and inv_wl.shape[0] < C_pad:
        inv_wl = jnp.pad(inv_wl, (0, C_pad - inv_wl.shape[0]))

    nblk = -(-S // src_block)
    S_pad = nblk * src_block

    def pad_src(x):
        if x.shape[0] < S_pad:
            return jnp.pad(x, ((0, S_pad - x.shape[0]),)
                           + ((0, 0),) * (x.ndim - 1))
        return x

    seh_p, sel_p, amps_p = pad_src(seh), pad_src(sel), pad_src(amps)
    s_sky_p = pad_src(s_sky) if s_sky is not None else None
    sig_p = pad_src(src_shape_sigma) if src_shape_sigma is not None else None
    bl_len = jnp.sqrt(jnp.sum(blh ** 2, axis=1))

    def kahan(sum_, comp, x):
        # Compensated accumulation: without it, the f32 carry quantizes
        # each block add at eps*|V|, a random walk that reaches ~3e-6
        # relative over the north-star source count (measured; see
        # benchmarks/accuracy_northstar.py).
        y = x - comp
        t = sum_ + y
        return t, (t - sum_) - y

    def body(carry, blk):
        idx = blk * src_block
        sl = lambda x: jax.lax.dynamic_slice_in_dim(x, idx, src_block, 0)
        kw = {}
        if sig_p is not None:
            kw = dict(s_sky=sl(s_sky_p), bl_len=bl_len, inv_wl=inv_wl,
                      sigma_uv=sl(sig_p))
        elif gradient:
            kw = dict(s_sky=sl(s_sky_p))
        out = _source_block_vis(sl(seh_p), sl(sel_p), blh, bll, sl(amps_p),
                                g0h, g0l, gdh, gdl, Q, L, chan0=chan0,
                                gradient=gradient, **kw)
        if gradient:
            vr, vi, gr, gi = out
            cvr, cvi, cgr, cgi, kvr, kvi = carry
            cvr, kvr = kahan(cvr, kvr, vr)
            cvi, kvi = kahan(cvi, kvi, vi)
            return (cvr, cvi, cgr + gr, cgi + gi, kvr, kvi), None
        vr, vi = out
        cvr, kvr = kahan(carry[0], carry[2], vr)
        cvi, kvi = kahan(carry[1], carry[3], vi)
        return (cvr, cvi, kvr, kvi), None

    zbc = jnp.zeros((B, C_pad), jnp.float32)
    if gradient:
        init = (zbc, zbc, jnp.zeros((3, B, C_pad), jnp.float32),
                jnp.zeros((3, B, C_pad), jnp.float32), zbc, zbc)
    else:
        init = (zbc, zbc, zbc, zbc)
    carry, _ = jax.lax.scan(body, init, jnp.arange(nblk))
    vis = (carry[0] + 1j * carry[1])[:, :nchan]
    if gradient:
        grad = (carry[2] + 1j * carry[3])[:, :, :nchan]
        return vis, grad
    return vis


# ----------------------------------------------------------------------------
# Host float64 golden reference (mirrors the reference formulas exactly)
# ----------------------------------------------------------------------------

def nudft_reference_f64(s_eff, baselines, amps, freqs, s_sky=None,
                        src_shape_sigma=None, gradient=False):
    """Direct float64 numpy evaluation of the same sum, for golden tests
    (the reference's double-precision phase_matrix path,
    /root/reference/prisim/interferometry.py:6355-6376)."""
    s_eff = np.asarray(s_eff, dtype=np.float64)
    baselines = np.asarray(baselines, dtype=np.float64)
    amps = np.asarray(amps, dtype=np.float64)
    freqs = np.asarray(freqs, dtype=np.float64)
    tau = s_eff @ baselines.T / CNST.c                           # (S, B)
    phase = 2.0 * np.pi * tau[:, :, None] * freqs[None, None, :]
    E = np.exp(-1j * phase)
    W = 1.0
    if src_shape_sigma is not None:
        bl_len = np.sqrt(np.sum(baselines ** 2, axis=1))
        ksky = np.asarray(s_sky, dtype=np.float64) @ baselines.T
        proj = np.sqrt(np.clip(bl_len[None, :] ** 2
                               - ksky ** 2, 0, None))
        u_proj = proj[:, :, None] * (freqs / CNST.c)[None, None, :]
        W = np.exp(-0.5 * (u_proj
                           / np.asarray(src_shape_sigma)[:, None, None]) ** 2)
    vis = np.einsum("sc,sbc->bc", amps, E * W)
    if gradient:
        grad = np.einsum("sk,sc,sbc->kbc", np.asarray(s_sky, np.float64),
                         amps, E * W)
        return vis, grad
    return vis
