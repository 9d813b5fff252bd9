"""EXPERIMENTAL: delay-space NUFFT evaluation of visibility spectra.

The direct NUDFT engine costs O(S·B·C) MACs. On a uniform channel grid
the frequency axis of

    V(b, nu_c) = sum_s A_s e^{-2 pi i (nu0 + c dnu) tau_sb}

is a 1-D type-3 NUFFT from the (non-uniform) delays tau_sb to C uniform
frequencies, per baseline: Kaiser-Bessel spreading of the carrier-phased
amplitudes onto an oversampled uniform delay grid, one FFT, and a
diagonal deconvolution — O(S·K + beta·C log C) per baseline instead of
O(S·C), a ~C/log C ≈ 100x algorithmic speedup at C=1024.

This module is the ROADMAP round-2 engine in prototype form, in three
layers (all validated in tests/test_nufft_delay.py):
  * `nufft_delay_visibilities` — f64 numpy reference (~1e-12 vs direct);
  * `nufft_delay_visibilities_spectral` — truncated-SVD factorization of
    frequency-dependent amplitudes (rank 12 covers full-octave power
    laws at 2e-11);
  * `nufft_delay_visibilities_jax` / `simulate_snapshot_nufft` —
    jittable f32 + two-float port (~3e-6, the engine accuracy class),
    matching `observe.simulate_snapshot` end-to-end at 3.2e-6.
  * `nufft_delay_visibilities_jax_gather` — SCATTER-FREE spreading
    (sort + searchsorted + windowed gather, all plain XLA ops),
    matching the f64 reference at 2.8e-6.

Algorithm reference: standard gridding NUFFT (Dutt & Rokhlin 1993;
finufft's kb design). The reference implementation evaluates the dense
phase matrix instead (/root/reference/prisim/interferometry.py:
6323-6343).

Every matmul runs at Precision.HIGHEST (at default precision an f32
product may be taken at reduced precision — TF32 on an NVIDIA GPU), and
the spectral rank is bandwidth-aware (a rank-16 Chebyshev fit over a
full octave is not accurate enough). The driver's
processing.nufft_crosscheck gate guards every run.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["nufft_delay_visibilities", "nufft_delay_visibilities_spectral",
           "nufft_delay_visibilities_jax",
           "nufft_delay_visibilities_jax_gather",
           "nufft_delay_visibilities_jax_sorted",
           "nufft_delay_multirank_sorted", "fold_delay_bins",
           "kb_tap_coeffs", "size_gather_window", "spectral_project",
           "simulate_snapshot_nufft", "kb_kernel", "kb_fourier"]


def kb_kernel(z, K, alpha):
    """Kaiser-Bessel spreading kernel w(z) on |z| <= K/2 (z in grid
    units), zero outside."""
    from numpy import i0
    arg = 1.0 - (2.0 * z / K) ** 2
    inside = arg > 0
    out = np.zeros_like(np.asarray(z, dtype=np.float64))
    out[inside] = i0(alpha * np.sqrt(arg[inside])) / i0(alpha)
    return out


def kb_fourier(k_over_n, K, alpha):
    """Continuous Fourier transform of the KB kernel at frequency
    xi = k/n cycles per grid step: what(xi) = (K/I0(alpha)) *
    sinh(sqrt(alpha^2 - (pi K xi)^2)) / sqrt(...), analytically
    continued to sinc when the argument turns imaginary."""
    from numpy import i0
    xi = np.asarray(k_over_n, dtype=np.float64)
    t = alpha ** 2 - (np.pi * K * xi) ** 2
    out = np.empty_like(t)
    pos = t > 0
    rt = np.sqrt(np.abs(t))
    out[pos] = np.sinh(rt[pos]) / rt[pos]
    out[~pos] = np.sinc(rt[~pos] / np.pi)
    return K * out / i0(alpha)


def nufft_delay_visibilities(tau, amps, nu0, dnu, nchan, beta=2.0,
                             K=13, alpha=None):
    """Visibility spectra via per-baseline 1-D type-3 NUFFT.

    tau  : (S, B) geometric delays in seconds (phase-center subtracted)
    amps : (S,) or (S, B) frequency-flat amplitudes
    Returns (B, C) complex128, equal to
    sum_s amps e^{-2 pi i (nu0 + c dnu) tau} to NUFFT accuracy
    (~1e-12 at beta=2, K=13)."""
    tau = np.asarray(tau, dtype=np.float64)
    S, B = tau.shape
    amps = np.asarray(amps, dtype=np.float64)
    if amps.ndim == 1:
        amps = np.broadcast_to(amps[:, None], (S, B))
    if alpha is None:
        alpha = np.pi * K * (1.0 - 0.5 / beta) - 0.01  # standard choice
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)                   # grid step in seconds
    # carrier at mid-band so the FFT modes are centered: k = c - C/2
    # in [-C/2, C/2), inside the kernel's accuracy band |k| <= n/(2 beta)
    nu_mid = nu0 + (nchan // 2) * dnu
    carrier = np.exp(-2j * np.pi * nu_mid * tau)
    # grid coordinate; delays fold mod 1/dnu EXACTLY for the evaluated
    # modes (k dnu (tau + p/dnu) differs by whole cycles), so the
    # scatter's mod-n wraparound supports arbitrary delay ranges
    phi = tau / h
    m0 = np.rint(phi).astype(np.int64)   # center taps: |phi - m0| <= 1/2
    grid = np.zeros((B, n), dtype=np.complex128)
    half = K // 2
    for j in range(-half, half + 1):      # K taps, vectorized over (S,B)
        m = m0 + j
        w = kb_kernel(phi - m, K, alpha)  # (S, B)
        np.add.at(grid, (np.arange(B)[None, :], m % n),
                  amps * carrier * w)
    # FFT: G[k] = sum_m grid[m] e^{-2 pi i k m / n}, centered modes
    G = np.fft.fft(grid, axis=1)
    k = np.arange(nchan) - nchan // 2          # (C,) in [-C/2, C/2)
    Gk = G[:, k % n]
    V = Gk / kb_fourier(k / n, K, alpha)[None, :]
    return V


def nufft_delay_visibilities_spectral(tau, amps_sc, nu0, dnu, nchan,
                                      rank=12, beta=2.0, K=13,
                                      alpha=None, basis="svd"):
    """NUFFT evaluation with frequency-dependent amplitudes.

    amps_sc: (S, C) per-source spectra (e.g. beam-weighted power laws).
    Factorizes A ~ sum_r P_r(s) Q_r(c) by truncated SVD and runs one
    flat-spectrum NUFFT per rank:

        V(b, c) = sum_r Q_r(c) * NUFFT[P_r](b, c)

    Smooth spectra (power laws over a ~20% fractional band) compress to
    rank ~10 at <=1e-6, so the cost is rank * O(S K + beta C log C) per
    baseline — still ~C/(K rank) times cheaper than direct. Returns
    ((B, C) complex128, spectral truncation error estimate)."""
    amps_sc = np.asarray(amps_sc, dtype=np.float64)
    S, C = amps_sc.shape
    if C != nchan:
        raise ValueError("amps_sc second axis must be nchan")
    if basis == "chebyshev":
        # FIXED basis in ln(nu): Q = chebvander rows, P = amps @ pinv(Q)
        # — one matmul, no data-dependent SVD (jit-friendly; rank 8
        # fits full-octave power laws at ~1e-7)
        freqs = nu0 + dnu * np.arange(C)
        x = np.log(freqs / freqs[C // 2])
        x = 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0
        Q = np.polynomial.chebyshev.chebvander(x, rank - 1)   # (C, r)
        P = amps_sc @ np.linalg.pinv(Q).T                     # (S, r)
        resid = np.abs(P @ Q.T - amps_sc).max() /             max(np.abs(amps_sc).max(), 1e-300)
        comps = [(P[:, i], Q[:, i]) for i in range(rank)]
        trunc = float(resid)
    else:
        U, sv, Vt = np.linalg.svd(amps_sc, full_matrices=False)
        r = min(rank, sv.size)
        trunc = float(sv[r:].sum() / max(sv.sum(), 1e-300))
        comps = [(U[:, i] * sv[i], Vt[i]) for i in range(r)]
    out = 0.0
    for p_r, q_r in comps:
        Vi = nufft_delay_visibilities(tau, p_r, nu0, dnu, nchan,
                                      beta=beta, K=K, alpha=alpha)
        out = out + Vi * q_r[None, :]
    return out, trunc


def nufft_delay_visibilities_jax(tau_h, tau_l, amps, nu0, dnu, nchan,
                                 beta=2.0, K=13, alpha=None):
    """JAX (f32 + two-float phase) port of nufft_delay_visibilities.

    tau_h/tau_l: (S, B) two-float delays in seconds (split_f64 of the
    f64 delays, or df arithmetic upstream); amps: (S,) or (S, B) f32.
    Returns (B, C) complex64. Phase-critical steps (the nu_mid carrier
    and the grid coordinate) run in two-float so the ~150-cycle phases
    keep ~1e-6 relative accuracy; kernel weights
    and the FFT are plain f32. The spreading scatter is XLA's."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.special import i0 as j_i0
    from .. import twofloat as tf

    if alpha is None:
        alpha = np.pi * K * (1.0 - 0.5 / beta) - 0.01
    alpha = float(alpha)
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)                     # host f64 scalars
    S, B = tau_h.shape
    amps = jnp.asarray(amps, jnp.float32)
    if amps.ndim == 1:
        amps = jnp.broadcast_to(amps[:, None], (S, B))
    nu_mid = nu0 + (nchan // 2) * dnu

    # two-float carrier cycles: nu_mid * tau, reduced mod 1
    nmh, nml = [jnp.float32(x) for x in _split_host(nu_mid)]
    ch, cl = tf.df_mul(tau_h, tau_l, nmh, nml)
    fh, fl = tf.df_frac(ch, cl)
    ang = -2.0 * np.pi * (fh + fl)
    carr_re = jnp.cos(ang)
    carr_im = jnp.sin(ang)

    # two-float grid coordinate phi = tau / h; delays fold mod 1/dnu
    # exactly for the evaluated modes, so mod-n wraparound in the
    # scatter supports arbitrary delay ranges (no tmin shift needed)
    invh_h, invh_l = [jnp.float32(x) for x in _split_host(1.0 / h)]
    ph_h, ph_l = tf.df_mul(tau_h, tau_l, invh_h, invh_l)
    m0 = jnp.rint(ph_h).astype(jnp.int32)
    z0 = (ph_h - m0.astype(jnp.float32)) + ph_l   # |z0| <= 1/2, f32

    src = amps * carr_re + 1j * (amps * carr_im)
    grid = jnp.zeros((B, n), jnp.complex64)
    bidx = jnp.broadcast_to(jnp.arange(B)[None, :], (S, B))
    i0a = float(np.i0(alpha))
    for j in range(-(K // 2), K // 2 + 1):
        z = z0 - jnp.float32(j)
        arg = 1.0 - (2.0 * z / K) ** 2
        w = jnp.where(arg > 0,
                      j_i0(alpha * jnp.sqrt(jnp.clip(arg, 0.0, 1.0)))
                      / i0a, 0.0)
        grid = grid.at[bidx, (m0 + j) % n].add(src * w)
    G = jnp.fft.fft(grid, axis=1)
    k = np.arange(nchan) - nchan // 2
    Gk = G[:, k % n]
    deconv = jnp.asarray(1.0 / kb_fourier(k / n, K, alpha), jnp.float32)
    return Gk * deconv[None, :]


def _split_host(x):
    """Host-side f64 -> (hi, lo) f32 split."""
    hi = np.float32(x)
    lo = np.float32(x - np.float64(hi))
    return hi, lo


def simulate_snapshot_nufft(instrument, sky, Mh, Ml, pch, pcl, beam_fn,
                            rank=12, beta=2.0, K=13):
    """EXPERIMENTAL observe-level entry: one accumulation via the
    delay-space NUFFT instead of the direct NUDFT.

    Same inputs as engine.observe.simulate_snapshot; returns (B, C)
    complex64. Host-side SVD factorizes the beam-weighted spectrum per
    snapshot (rank flat-spectrum transforms); delays are built in
    two-float on device. Accuracy ~1e-5 vs the direct engine (NUFFT
    3e-6 + rank truncation); use the direct path when exactness
    matters."""
    import jax.numpy as jnp
    from .. import twofloat as tf
    from .observe import df_rotate3, _beam_and_flux

    sh, sl = df_rotate3(Mh, Ml, sky.s_eq_hi, sky.s_eq_lo)
    seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
    freqs_f32 = jnp.asarray(instrument.freqs, dtype=jnp.float32)
    amps = _beam_and_flux(sh, sky.flux, freqs_f32, beam_fn, pc=pch)

    # two-float tau = (se . b) / c per (source, baseline)
    from .. import constants as CNST
    th = tl = None
    for i in range(3):
        ph_, pl_ = tf.df_mul(seh[:, i:i + 1], sel[:, i:i + 1],
                             instrument.bl_hi[None, :, i],
                             instrument.bl_lo[None, :, i])
        th, tl = (ph_, pl_) if th is None else tf.df_add(th, tl, ph_, pl_)
    ich, icl = [jnp.float32(x) for x in _split_host(1.0 / CNST.c)]
    th, tl = tf.df_mul(th, tl, ich, icl)

    A = np.asarray(amps, dtype=np.float64)                    # host SVD
    U, sv, Vt = np.linalg.svd(A, full_matrices=False)
    r = min(rank, sv.size)
    out = 0.0
    for i in range(r):
        Vi = nufft_delay_visibilities_jax(
            th, tl, jnp.asarray((U[:, i] * sv[i]).astype(np.float32)),
            instrument.nu0, instrument.dnu, instrument.nchan,
            beta=beta, K=K)
        out = out + np.asarray(Vi) * Vt[i][None, :]
    return out


def size_gather_window(tau, dnu, nchan, beta=2.0, K=13, margin=1.0):
    """Host-side sizing of the gather window: the max occupancy of any
    K+1-bin sliding window of the folded delay-bin histogram, over all
    baselines (the bound the gather variant's fixed window must cover —
    undersizing silently drops sources). `tau` is the concrete (S, B)
    delay array (f64); `margin` scales the result (>1 for safety when
    delays will move between calls, e.g. over a drift scan)."""
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)
    m0 = np.rint(np.asarray(tau, dtype=np.float64) / h).astype(np.int64)
    m0 %= n
    worst = 0
    win = np.ones(K + 1)
    for b in range(m0.shape[1]):
        counts = np.bincount(m0[:, b], minlength=n).astype(np.float64)
        # circular K+1-bin sliding sum (edge bins see wrapped bins)
        ext = np.concatenate([counts[-(K // 2):], counts,
                              counts[:K // 2]])
        occ = np.convolve(ext, win, mode="valid")
        worst = max(worst, int(occ.max()))
    return max(1, int(np.ceil(worst * float(margin))))


def nufft_delay_visibilities_jax_gather(tau_h, tau_l, amps, nu0, dnu,
                                        nchan, window=None, beta=2.0,
                                        K=13, alpha=None):
    """Scatter-free variant of nufft_delay_visibilities_jax.

    Spreading by GATHER instead of scatter: per baseline, sources are
    sorted by delay bin; each grid bin reduces a fixed-width `window` of
    the sorted stream located with searchsorted (dense windowed
    reductions, no scatter). `window` must
    bound the number of sources within +-K/2 bins of any bin
    (~K * (1 + S*beta*nchan_density)); undersizing silently drops
    sources, so size it on the host from the actual delays:
    window >= max over bins of occupancy, e.g. via
    np.histogram(m0) -> (K+1) * max_count. Cost n*window per baseline
    (= S*K for quasi-uniform delays).

    Same accuracy as the scatter variant (~3e-6).

    window=None auto-sizes from the concrete delays via
    size_gather_window (requires non-traced tau; under jit pass an
    explicit window sized on the host)."""
    import jax
    import jax.numpy as jnp
    from jax.core import Tracer
    from jax.scipy.special import i0 as j_i0
    from .. import twofloat as tf

    if window is None:
        if isinstance(tau_h, Tracer):
            raise ValueError(
                "window=None needs concrete delays to auto-size; under "
                "jit, precompute window=size_gather_window(tau, dnu, "
                "nchan, beta, K) on the host")
        tau = (np.asarray(tau_h, dtype=np.float64)
               + np.asarray(tau_l, dtype=np.float64))
        window = size_gather_window(tau, dnu, nchan, beta=beta, K=K)
    window = int(window)
    if alpha is None:
        alpha = np.pi * K * (1.0 - 0.5 / beta) - 0.01
    alpha = float(alpha)
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)
    S, B = tau_h.shape
    amps = jnp.asarray(amps, jnp.float32)
    if amps.ndim == 1:
        amps = jnp.broadcast_to(amps[:, None], (S, B))
    nu_mid = nu0 + (nchan // 2) * dnu
    nmh, nml = [jnp.float32(x) for x in _split_host(nu_mid)]
    ch, cl = tf.df_mul(tau_h, tau_l, nmh, nml)
    fh, fl = tf.df_frac(ch, cl)
    ang = -2.0 * np.pi * (fh + fl)
    invh_h, invh_l = [jnp.float32(x) for x in _split_host(1.0 / h)]
    ph_h, ph_l = tf.df_mul(tau_h, tau_l, invh_h, invh_l)
    m0 = jnp.rint(ph_h).astype(jnp.int32)
    z0 = (ph_h - m0.astype(jnp.float32)) + ph_l
    m0 = m0 % n                                  # folded bin index
    src_re = amps * jnp.cos(ang)
    src_im = amps * jnp.sin(ang)
    half = K // 2
    i0a = float(np.i0(alpha))

    def one_baseline(m0_b, z_b, re_b, im_b):
        order = jnp.argsort(m0_b)
        ms = m0_b[order]
        # periodic extension so edge bins see wrapped contributors:
        # the sorted stream is tripled with bins shifted by -n/0/+n
        ms3 = jnp.concatenate([ms - n, ms, ms + n])
        zs = jnp.tile(z_b[order], 3)
        res = jnp.tile(re_b[order], 3)
        ims = jnp.tile(im_b[order], 3)
        g = jnp.arange(n, dtype=jnp.int32)
        start = jnp.searchsorted(ms3, g - half)   # (n,)
        idx = start[:, None] + jnp.arange(window, dtype=jnp.int32)[None]
        valid = idx < 3 * S
        idx = jnp.clip(idx, 0, 3 * S - 1)
        dm = ms3[idx] - g[:, None]               # (n, window)
        z = zs[idx] + dm.astype(jnp.float32)     # phi - g, |.| <= K/2
        arg = 1.0 - (2.0 * z / K) ** 2
        w = jnp.where((arg > 0) & valid & (jnp.abs(dm) <= half),
                      j_i0(alpha * jnp.sqrt(jnp.clip(arg, 0.0, 1.0)))
                      / i0a, 0.0)
        return (jnp.sum(res[idx] * w, axis=1),
                jnp.sum(ims[idx] * w, axis=1))

    gr, gi = jax.vmap(one_baseline, in_axes=(1, 1, 1, 1))(m0, z0,
                                                          src_re, src_im)
    G = jnp.fft.fft(gr + 1j * gi, axis=1)
    k = np.arange(nchan) - nchan // 2
    Gk = G[:, k % n]
    deconv = jnp.asarray(1.0 / kb_fourier(k / n, K, alpha), jnp.float32)
    return Gk * deconv[None, :]


def kb_tap_coeffs(K, alpha, degree=12):
    """Host-side per-tap Chebyshev fits of the KB kernel.

    Evaluating i0(alpha*sqrt(arg))/i0(alpha) directly in f32 loses
    ~alpha*eps ~ 2e-6 relative (the sqrt feeds a sharp exponent) — the
    measured accuracy plateau of the jax spreading paths. Instead each
    tap j's weight w_j(z0) = kb(z0 - j) is fit on z0 in [-1/2, 1/2] by a
    degree-`degree` polynomial with f64 coefficients (fit error ~1e-10),
    then Horner-evaluated in f32: absolute error ~eps * max_z w_j, which
    is what a summed spreading weight needs. Returns (K, degree+1)
    float64 monomial coefficients, highest degree first (np.polyval
    order)."""
    half = K // 2
    z = np.polynomial.chebyshev.chebpts1(64) * 0.5          # 64 nodes
    out = np.empty((K, degree + 1))
    for idx, j in enumerate(range(-half, half + 1)):
        w = kb_kernel(z - j, K, alpha)
        cheb = np.polynomial.chebyshev.Chebyshev.fit(z, w, degree,
                                                     domain=[-0.5, 0.5])
        out[idx] = cheb.convert(kind=np.polynomial.Polynomial).coef[::-1]
    return out


def fold_delay_bins(tau_h, tau_l, dnu, nchan, beta=2.0):
    """Two-float folding of delays onto the oversampled grid: returns
    (m0 (S,B) int32 in [0, n), z0 (S,B) f32 in [-1/2, 1/2], n).

    The SAME computation the sorted spread uses internally — external
    plans (sort reuse across spectral ranks) must derive m0 from here,
    since an f64 recomputation can round ties to a different bin."""
    import jax.numpy as jnp
    from .. import twofloat as tf
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)
    invh_h, invh_l = [jnp.float32(x) for x in _split_host(1.0 / h)]
    ph_h, ph_l = tf.df_mul(tau_h, tau_l, invh_h, invh_l)
    m0 = jnp.rint(ph_h).astype(jnp.int32)
    z0 = (ph_h - m0.astype(jnp.float32)) + ph_l
    return m0 % n, z0, n


def _sorted_spread_setup(m0, n):
    """Per-baseline sort of folded bin indices + segment boundaries.

    m0: (S, B) int32 folded bin indices (0..n-1). Returns
    (order (S, B), starts (n+1, B)) — `order` sorts each baseline's
    sources by bin; `starts[g]` is the first sorted position of bin g
    (starts[n] = S). Host/jit agnostic; reused across spectral ranks."""
    import jax
    import jax.numpy as jnp
    order = jnp.argsort(m0, axis=0)                       # (S, B)
    ms = jnp.take_along_axis(m0, order, axis=0)           # sorted bins
    g = jnp.arange(int(n) + 1, dtype=m0.dtype)
    starts = jax.vmap(lambda col: jnp.searchsorted(col, g),
                      in_axes=1, out_axes=1)(ms)          # (n+1, B)
    return order, starts


def nufft_delay_visibilities_jax_sorted(tau_h, tau_l, amps, nu0, dnu,
                                        nchan, beta=2.0, K=13,
                                        alpha=None, setup=None,
                                        chan0=None):
    """Scatter-free, occupancy-INDEPENDENT spreading (the sorted spread).

    The gather variant's fixed window must bound the worst-case bin
    occupancy, which clustered delays blow up ~12x (ROADMAP; measured).
    Here each tap's spreading is an exact segment sum over sources
    sorted by delay bin, computed as a cumulative sum differenced at the
    segment boundaries:

        T_j[g] = sum_{s: m0_s = g} src_s * kb(z0_s - j)
               = cumsum(vals_j)[starts[g+1]] - cumsum(vals_j)[starts[g]]
        grid[g] = sum_j T_j[g - j]   (K rolls)

    — one argsort per (baseline, snapshot) (reusable across spectral
    ranks via `setup`), K cumsums of length S, K×n boundary gathers and
    K rolls per baseline: O(S·(log S + K) + n·K), with NO window bound
    and no occupancy sensitivity. All ops are dense XLA (sort, cumsum,
    gather, roll, FFT).

    Cancellation note: the boundary difference subtracts two running
    f32 sums of magnitude ~sqrt(S)·amp (the carrier randomizes signs),
    so per-bin error is ~eps·sqrt(S)·amp — within the NUFFT engine's
    ~3e-6 class at north-star source counts (checked in
    tests/test_nufft_delay.py).

    setup: optional (order, starts) from _sorted_spread_setup(m0, n) to
    amortize the sort across ranks.
    chan0: optional global channel offset of this (mesh-sharded) block —
    may be a traced f32 scalar (jax.lax.axis_index * nchan). The
    carrier shifts by chan0*dnu*tau cycles in two-float, so channel
    shards evaluate their exact global sub-band (the NUDFT chan0
    mechanism of parallel/mesh.py, NUFFT edition).
    Returns (B, C) complex64."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.special import i0 as j_i0
    from .. import twofloat as tf

    if alpha is None:
        alpha = np.pi * K * (1.0 - 0.5 / beta) - 0.01
    alpha = float(alpha)
    n = int(beta * nchan)
    h = 1.0 / (n * dnu)
    S, B = tau_h.shape
    amps = jnp.asarray(amps, jnp.float32)
    if amps.ndim == 1:
        amps = jnp.broadcast_to(amps[:, None], (S, B))
    nu_mid = nu0 + (nchan // 2) * dnu
    nmh, nml = [jnp.float32(x) for x in _split_host(nu_mid)]
    ch, cl = tf.df_mul(tau_h, tau_l, nmh, nml)
    if chan0 is not None:
        # carrier offset for a channel shard: += chan0 * (dnu * tau)
        # cycles, all in two-float (chan0 is an exact small f32 int)
        dnh, dnl = [jnp.float32(x) for x in _split_host(dnu)]
        dth, dtl = tf.df_mul(tau_h, tau_l, dnh, dnl)
        c0 = jnp.asarray(chan0, jnp.float32)
        oh, oe = tf.two_prod(dth, c0)
        ch, cl = tf.df_add(ch, cl, oh, oe + dtl * c0)
    fh, fl = tf.df_frac(ch, cl)
    cosv, sinv = tf.df_sincos_cycles(fh, fl, xp=jnp)
    m0, z0, _ = fold_delay_bins(tau_h, tau_l, dnu, nchan, beta=beta)
    src_re = amps * cosv
    src_im = amps * (-sinv)
    if setup is None:
        setup = _sorted_spread_setup(m0, n)
    order, starts = setup
    half = K // 2
    i0a = float(np.i0(alpha))

    zs = jnp.take_along_axis(z0, order, axis=0)           # (S, B)
    res = jnp.take_along_axis(src_re, order, axis=0)
    ims = jnp.take_along_axis(src_im, order, axis=0)
    tap_coeffs = kb_tap_coeffs(K, alpha)                  # (K, d+1) f64

    def df_cumsum(x):
        # Compensated prefix sum: a plain f32 cumsum random-walks to
        # ~sqrt(S)*amp and the boundary difference cancels it back down,
        # costing ~eps*sqrt(S) per bin (measured 5e-6 at S=8192). The
        # two-float scan keeps the running sum to ~eps^2*S.
        h, l = jax.lax.associative_scan(
            lambda a, b: tf.df_add(a[0], a[1], b[0], b[1]),
            (x, jnp.zeros_like(x)), axis=0)
        return h, l

    def tap(j):
        # Horner on the host-fit f64 tap polynomial (see kb_tap_coeffs)
        co = tap_coeffs[j + half]
        w = jnp.full_like(zs, np.float32(co[0]))
        for c in co[1:]:
            w = w * zs + jnp.float32(c)
        # exclusive-prefix cumsum with a leading zero: T[g] =
        # cs[starts[g+1]] - cs[starts[g]] is then exact segment algebra
        zpad = jnp.zeros((1, B), jnp.float32)

        def bounds(csh, csl):
            csh = jnp.concatenate([zpad, csh], axis=0)    # (S+1, B)
            csl = jnp.concatenate([zpad, csl], axis=0)
            ah = jnp.take_along_axis(csh, starts[1:], axis=0)
            al = jnp.take_along_axis(csl, starts[1:], axis=0)
            bh = jnp.take_along_axis(csh, starts[:-1], axis=0)
            bl = jnp.take_along_axis(csl, starts[:-1], axis=0)
            th, tl_ = tf.df_add(ah, al, -bh, -bl)         # (n, B)
            return th + tl_

        tr = bounds(*df_cumsum(w * res))
        ti = bounds(*df_cumsum(w * ims))
        return jnp.roll(tr, j, axis=0), jnp.roll(ti, j, axis=0)

    gr = jnp.zeros((n, B), jnp.float32)
    gi = jnp.zeros((n, B), jnp.float32)
    for j in range(-half, half + 1):                      # static K
        tr, ti = tap(j)
        gr = gr + tr
        gi = gi + ti
    G = jnp.fft.fft(jnp.transpose(gr) + 1j * jnp.transpose(gi), axis=1)
    k = np.arange(nchan) - nchan // 2
    Gk = G[:, k % n]
    deconv = jnp.asarray(1.0 / kb_fourier(k / n, K, alpha), jnp.float32)
    return Gk * deconv[None, :]


def nufft_delay_multirank_sorted(tau_h, tau_l, P, Qc, nu0, dnu, nchan,
                                 beta=2.0, K=13, alpha=None, chan0=None):
    """Multi-rank sorted-spread NUFFT: V = sum_r Qc[:, r] * NUFFT[P[:, r]].

    The production form of the sorted spread (see
    nufft_delay_visibilities_jax_sorted for the algorithm): the
    rank-INDEPENDENT work — two-float carrier phasors, delay-bin
    folding, the per-baseline argsort and boundary table, sorted
    gathers — is hoisted out of the rank loop, and both the spectral
    rank loop and the K-tap loop run under lax.scan (a static unroll of
    rank x K cumsum stages produced a very large HLO, and recomputed the
    carrier per rank).

    P: (S, r) spectral source coefficients; Qc: (C, r) basis columns.
    Returns (B, C) complex64."""
    import jax
    import jax.numpy as jnp
    from .. import twofloat as tf

    if alpha is None:
        alpha = np.pi * K * (1.0 - 0.5 / beta) - 0.01
    alpha = float(alpha)
    n = int(beta * nchan)
    S, B = tau_h.shape
    nu_mid = nu0 + (nchan // 2) * dnu
    nmh, nml = [jnp.float32(x) for x in _split_host(nu_mid)]
    ch, cl = tf.df_mul(tau_h, tau_l, nmh, nml)
    if chan0 is not None:
        dnh, dnl = [jnp.float32(x) for x in _split_host(dnu)]
        dth, dtl = tf.df_mul(tau_h, tau_l, dnh, dnl)
        c0 = jnp.asarray(chan0, jnp.float32)
        oh, oe = tf.two_prod(dth, c0)
        ch, cl = tf.df_add(ch, cl, oh, oe + dtl * c0)
    fh, fl = tf.df_frac(ch, cl)
    cosv, sinv = tf.df_sincos_cycles(fh, fl, xp=jnp)
    m0, z0, _ = fold_delay_bins(tau_h, tau_l, dnu, nchan, beta=beta)
    order, starts = _sorted_spread_setup(m0, n)
    zs = jnp.take_along_axis(z0, order, axis=0)          # (S, B)
    crs = jnp.take_along_axis(cosv, order, axis=0)
    cis = jnp.take_along_axis(-sinv, order, axis=0)
    tap_coeffs = jnp.asarray(kb_tap_coeffs(K, alpha), jnp.float32)
    tap_shift = jnp.arange(-(K // 2), K // 2 + 1, dtype=jnp.int32)
    k = np.arange(nchan) - nchan // 2
    deconv = jnp.asarray(1.0 / kb_fourier(k / n, K, alpha), jnp.float32)
    Qc = jnp.asarray(Qc, jnp.float32)
    zpad = jnp.zeros((1, B), jnp.float32)

    def df_cumsum(x):
        return jax.lax.associative_scan(
            lambda a, b: tf.df_add(a[0], a[1], b[0], b[1]),
            (x, jnp.zeros_like(x)), axis=0)

    def bounds(csh, csl):
        csh = jnp.concatenate([zpad, csh], axis=0)
        csl = jnp.concatenate([zpad, csl], axis=0)
        ah = jnp.take_along_axis(csh, starts[1:], axis=0)
        al = jnp.take_along_axis(csl, starts[1:], axis=0)
        bh = jnp.take_along_axis(csh, starts[:-1], axis=0)
        bl = jnp.take_along_axis(csl, starts[:-1], axis=0)
        th_, tl_ = tf.df_add(ah, al, -bh, -bl)
        return th_ + tl_                                  # (n, B)

    def one_rank(acc, pq):
        p_col, q_col = pq                                 # (S,), (C,)
        ps = p_col[order]                                 # (S, B)
        vre = ps * crs
        vim = ps * cis

        def one_tap(grid, tap):
            co, j = tap                                   # (d+1,), ()
            w = jnp.full_like(zs, co[0])
            for ci in range(1, co.shape[0]):
                w = w * zs + co[ci]
            tr = bounds(*df_cumsum(w * vre))
            ti = bounds(*df_cumsum(w * vim))
            gr, gi = grid
            return (gr + jnp.roll(tr, j, axis=0),
                    gi + jnp.roll(ti, j, axis=0)), None

        (gr, gi), _ = jax.lax.scan(
            one_tap, (jnp.zeros((n, B), jnp.float32),
                      jnp.zeros((n, B), jnp.float32)),
            (tap_coeffs, tap_shift))
        G = jnp.fft.fft(jnp.transpose(gr) + 1j * jnp.transpose(gi),
                        axis=1)
        Vi = G[:, k % n] * deconv[None, :]
        return acc + Vi * q_col[None, :], None

    acc0 = jnp.zeros((B, nchan), jnp.complex64)
    out, _ = jax.lax.scan(one_rank, acc0, (P.T, Qc.T))
    return out


def delays_two_float(seh, sel, bl_hi, bl_lo):
    """Two-float geometric delays tau = (s_eff . b)/c, (S, B) seconds."""
    import jax.numpy as jnp
    from .. import twofloat as tf
    from .. import constants as CNST
    th = tl = None
    for i in range(3):
        ph_, pl_ = tf.df_mul(seh[:, i:i + 1], sel[:, i:i + 1],
                             bl_hi[None, :, i], bl_lo[None, :, i])
        th, tl = (ph_, pl_) if th is None else tf.df_add(th, tl, ph_, pl_)
    ich, icl = [jnp.float32(x) for x in _split_host(1.0 / CNST.c)]
    return tf.df_mul(th, tl, ich, icl)


def chebyshev_basis_jit(freqs_f32, rank):
    """In-jit fixed Chebyshev basis in ln(nu) with its projector.

    Same role as chebyshev_projection but traceable (for shard_map
    bodies where each channel shard fits its own local sub-band).
    Returns (pinvQ (C, r), Q (C, r)) f32 with P = amps @ pinvQ via a
    normal-equations solve (Chebyshev-Vandermonde columns are well
    conditioned at r ~ 10)."""
    import jax.numpy as jnp
    x = jnp.log(freqs_f32 / freqs_f32[freqs_f32.shape[0] // 2])
    x = 2.0 * (x - x.min()) / jnp.maximum(x.max() - x.min(), 1e-30) - 1.0
    cols = [jnp.ones_like(x)]
    if rank > 1:
        cols.append(x)
    for _ in range(2, rank):
        cols.append(2.0 * x * cols[-1] - cols[-2])
    Q = jnp.stack(cols, axis=1)                           # (C, r)
    # least-squares projector via QR: normal equations square the
    # Vandermonde conditioning and lose ~3 digits in f32 (measured
    # 1.4e-3 engine error); QR keeps it at the f32 eps class. The
    # product at HIGHEST precision (an f32 matmul at default precision
    # may run in TF32 on an NVIDIA GPU).
    import jax
    q, r = jnp.linalg.qr(Q)
    pinvQ = jnp.matmul(q, jnp.linalg.inv(r).T,
                       precision=jax.lax.Precision.HIGHEST)   # (C, r)
    return pinvQ, Q


def chebyshev_projection(freqs, rank):
    """Host-precomputed fixed spectral basis: returns (pinvQ (C, r),
    Q (C, r)) f32 for jit-internal factorization P = amps @ pinvQ."""
    freqs = np.asarray(freqs, dtype=np.float64)
    C = freqs.size
    x = np.log(freqs / freqs[C // 2])
    x = 2.0 * (x - x.min()) / (x.max() - x.min()) - 1.0
    Q = np.polynomial.chebyshev.chebvander(x, rank - 1)       # (C, r)
    # pinv of the f32-CAST basis, not the f64 one: the engine combines
    # P with the f32 Q, and a pseudo-inverse of a slightly different
    # (uncast) matrix leaves a first-order basis-mismatch residual
    # ~eps*cond(Q) that is COHERENT across sources (round-3 banded
    # error budget). With matched pinv, P @ Q.T is a true projection
    # and the only residual is the fit itself.
    Qf = Q.astype(np.float32)
    return (np.linalg.pinv(Qf.astype(np.float64)).T.astype(np.float32),
            Qf)


def chebyshev_node_model(freqs, rank):
    """Node form of the rank-r spectral model (round 4).

    The projection form (P = amps @ pinvQ) cannot take the banded
    engine under 1e-6 at north-star scale: the f32-evaluated (S, C)
    amps carry ~1ulp channel-jitter (beam-slope x position-quantization
    + per-element rounding) that no smooth basis represents, and its
    coherent sum over ~4e5 sources measured 1.2-1.8e-6 of scale — for
    the f32-amps golden and the direct engines too
    (benchmarks/probe_truth.py). The node form makes the spectral
    model EXPLICIT instead: evaluate beam x flux at the rank
    Chebyshev nodes of the band and define the amps as the unique
    degree-(r-1) interpolant. The fit residual vs this model is zero
    by construction; the model's error vs the exact f64 beam is the
    smooth Chebyshev convergence (measured in f64 by
    benchmarks/probe_truth.py --node-model), and the engine never
    materializes an (S, C) table at all.

    Returns a NodeModel with
      nu_nodes  (r,)  f64  node frequencies
      node2coef (r, r) f32  P = amps_at_nodes @ node2coef
      V         (r, r) f32  values_at_nodes = coefficients @ V.T
      Q         (C, r) f32  full-grid basis (matches
                            chebyshev_projection's x = scaled ln nu)
      expand    (C, r) f32  amps_full = amps_at_nodes @ expand.T"""
    freqs = np.asarray(freqs, dtype=np.float64)
    C = freqs.size
    x = np.log(freqs / freqs[C // 2])
    xlo, xhi = x.min(), x.max()
    xs = 2.0 * (x - xlo) / (xhi - xlo) - 1.0
    t = np.polynomial.chebyshev.chebpts1(rank)             # (r,)
    x_nodes = xlo + (t + 1.0) * 0.5 * (xhi - xlo)
    nu_nodes = freqs[C // 2] * np.exp(x_nodes)
    V = np.polynomial.chebyshev.chebvander(t, rank - 1)    # (r, r)
    Vinv = np.linalg.inv(V)
    Q = np.polynomial.chebyshev.chebvander(xs, rank - 1)   # (C, r)
    return NodeModel(
        nu_nodes=nu_nodes, node2coef=Vinv.T.astype(np.float32),
        V=V.astype(np.float32), Q=Q.astype(np.float32),
        expand=(Q @ Vinv).astype(np.float32),
        node2coef64=Vinv.T, Q64=Q)


@dataclass
class NodeModel:
    """Static pieces of the rank-r spectral node model
    (chebyshev_node_model)."""
    nu_nodes: np.ndarray
    node2coef: np.ndarray
    V: np.ndarray
    Q: np.ndarray
    expand: np.ndarray
    node2coef64: np.ndarray = None   # f64 twins for the two-float
    Q64: np.ndarray = None           # truth-amps path (round 5)


def spectral_project(amps, pinvQ, block=128):
    """P = amps @ pinvQ with channel-blocked Kahan accumulation.

    A single HIGHEST-precision matmul still accumulates its C partial
    products in f32: the ~sqrt(C)*eps rounding of each P entry is
    value-correlated across sources sharing a spectral family, so at
    north-star source counts it summed coherently into a ~1.8e-6
    scaled visibility error that no spread/rank/tile knob could move.
    Blocking the channel axis and
    Kahan-combining the per-block partials cuts the accumulation depth
    to `block` + exact cross-block compensation."""
    import jax
    import jax.numpy as jnp
    amps = jnp.asarray(amps, jnp.float32)
    W = jnp.asarray(pinvQ, jnp.float32)
    S, C = amps.shape
    r = W.shape[1]
    nb = -(-C // block)
    if nb * block != C:
        amps = jnp.pad(amps, ((0, 0), (0, nb * block - C)))
        W = jnp.pad(W, ((0, nb * block - C), (0, 0)))
    A = amps.reshape(S, nb, block)
    Wb = W.reshape(nb, block, r)
    parts = jnp.einsum("snc,ncr->nsr", A, Wb,
                       precision=jax.lax.Precision.HIGHEST)

    def body(carry, p):
        s, c = carry
        y = p - c
        t = s + y
        return (t, (t - s) - y), None

    (tot, _), _ = jax.lax.scan(
        body, (jnp.zeros((S, r), jnp.float32),
               jnp.zeros((S, r), jnp.float32)), parts)
    return tot


def simulate_snapshot_nufft_jit(instrument, sky, Mh, Ml, pch, pcl,
                                beam_fn, pinvQ, Q, beta=2.0, K=13,
                                spread="sorted"):
    """Fully jittable NUFFT snapshot: the spectral factorization is one
    matmul against the fixed Chebyshev basis (chebyshev_projection) —
    no host round trip, so the whole accumulation fits in one jit (and
    under lax control flow for drift scans). Returns (B, C) complex64.

    spread: 'sorted' (default; scatter-free, occupancy-independent,
    with one argsort shared across all spectral ranks) or
    'scatter' (XLA scatter-add; fast on CPU backends)."""
    import jax
    import jax.numpy as jnp
    from .. import twofloat as tf
    from .. import constants as CNST
    from .observe import df_rotate3, _beam_and_flux

    sh, sl = df_rotate3(Mh, Ml, sky.s_eq_hi, sky.s_eq_lo)
    seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
    freqs_f32 = jnp.asarray(instrument.freqs, dtype=jnp.float32)
    amps = _beam_and_flux(sh, sky.flux, freqs_f32, beam_fn, pc=pch)
    # Blocked-Kahan projection (see spectral_project): reduced-
    # precision matmuls destroy it, and a single HIGHEST matmul still
    # costs ~1.8e-6 of f32 accumulation coherence at north-star source
    # counts
    P = spectral_project(amps, pinvQ)                         # (S, r)
    th, tl = delays_two_float(seh, sel, instrument.bl_hi,
                              instrument.bl_lo)
    Qd = jnp.asarray(Q)
    if spread == "sorted":
        # hoisted carrier/sort + lax.scan over ranks and taps
        return nufft_delay_multirank_sorted(
            th, tl, P, Qd, instrument.nu0, instrument.dnu,
            instrument.nchan, beta=beta, K=K)
    out = 0.0
    for i in range(Q.shape[1]):                  # static unroll, r~10
        Vi = nufft_delay_visibilities_jax(th, tl, P[:, i],
                                          instrument.nu0,
                                          instrument.dnu,
                                          instrument.nchan,
                                          beta=beta, K=K)
        out = out + Vi * Qd[:, i][None, :]
    return out
