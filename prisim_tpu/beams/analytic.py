"""Analytic primary beam models, vectorized over (nsrc, nchan) in JAX.

Rebuild of /root/reference/prisim/primary_beams.py (airy at :517, gaussian
at :629, VLA PBCOR at :445, GMRT at :734, ground plane at :812, dipole at
:975, array factor at :1482, uniform apertures at :2057/:2274) as pure
jax functions over direction cosines — no coordinate-system branching in
the hot path; hosts convert once to dircos.

All functions take:
  dircos : (nsrc, 3) direction cosines in local (E, N, U)
  freqs  : (nchan,) frequencies in Hz
and return (nsrc, nchan) float arrays (field or power patterns).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as CNST


def _hmm(a, b):
    """a @ b at full f32 precision (an NVIDIA GPU's default may take
    f32 products in TF32)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _j1_cheb_coeffs(deg=26):
    """Chebyshev coefficients of g(u) = J1(sqrt(u))/sqrt(u) on
    u in [0, 64] (t = u/32 - 1), fit in f64 at import time against the
    J1 power series (exact to ~1e-14 on [0, 8])."""
    nodes = np.cos(np.pi * (np.arange(2 * deg + 2) + 0.5)
                   / (2 * deg + 2))                    # t in (-1, 1)
    u = 32.0 * (nodes + 1.0)
    xh = np.sqrt(u) / 2.0                              # x/2, <= 4
    # J1(x) = sum_m (-1)^m / (m! (m+1)!) (x/2)^(2m+1)
    # => g = J1/x = 0.5 * sum_m (-1)^m / (m! (m+1)!) (x/2)^(2m) / ...
    g = np.zeros_like(u)
    term = 0.5 * np.ones_like(u)                       # m = 0: 1/(0!1!)/2
    x2 = xh * xh
    for m in range(1, 40):
        g += term
        term = -term * x2 / (m * (m + 1))
    return np.polynomial.chebyshev.chebfit(nodes, g, deg)


_J1_CHEB = _j1_cheb_coeffs()


def bessel_j1(x):
    """Bessel J1, float32-clean on device (jax has no float32 j1).

    |x| < 8: J1(x) = x * g(x^2) with g a degree-26 Chebyshev fit on
    [0, 64], Clenshaw-evaluated — coefficients are O(0.1) so the f32
    evaluation carries ~eps absolute error. The previous
    Abramowitz-Stegun rational form summed terms of ~1e12 magnitude to
    a ~1e10 result near x=8 (a ~75x cancellation): ~4e-6 relative
    noise in f32 that dominated the WHOLE framework's visibility error
    budget at north-star source counts (the beam-amps jitter summed
    coherently to ~1.8e-6 of scale and no engine knob could move it —
    benchmarks/probe_truth.py, round 4). The reference evaluates J1 in
    f64 scipy (primary_beams.py:517) where the cancellation is
    harmless.

    |x| >= 8: the A&S asymptotic form (O(1) coefficients, f32-safe)."""
    ax = jnp.abs(x)
    # |x| < 8 branch: Clenshaw on t = x^2/32 - 1
    t = x * x * jnp.float32(1.0 / 32.0) - 1.0
    t2 = 2.0 * t
    b1 = jnp.zeros_like(t)
    b2 = jnp.zeros_like(t)
    for c in _J1_CHEB[:0:-1]:
        b1, b2 = t2 * b1 - b2 + jnp.float32(c), b1
    g = t * b1 - b2 + jnp.float32(_J1_CHEB[0])
    small = x * g
    # |x| >= 8 asymptotic branch
    z = 8.0 / jnp.maximum(ax, 1e-20)
    y2 = z * z
    p1 = 1.0 + y2 * (0.183105e-2 + y2 * (-0.3516396496e-4
         + y2 * (0.2457520174e-5 + y2 * (-0.240337019e-6))))
    p2 = 0.04687499995 + y2 * (-0.2002690873e-3 + y2 * (0.8449199096e-5
         + y2 * (-0.88228987e-6 + y2 * 0.105787412e-6)))
    xx = ax - 2.356194491
    big = jnp.sqrt(0.636619772 / jnp.maximum(ax, 1e-20)) * \
        (jnp.cos(xx) * p1 - z * jnp.sin(xx) * p2) * jnp.sign(x)
    return jnp.where(ax < 8.0, small, big)


def _offaxis_sin(dircos, pointing_dircos=None):
    """sin(angle from beam axis) for each source; horizon mask.

    With no pointing center the axis is zenith: sin(theta) = sqrt(l^2+m^2).
    With a pointing center p, uses |s x p| = sin(angle)."""
    if pointing_dircos is None:
        sin_t = jnp.sqrt(jnp.clip(dircos[:, 0] ** 2 + dircos[:, 1] ** 2,
                                  0.0, 1.0))
        below = dircos[:, 2] < 0.0
        return sin_t, below
    p = jnp.asarray(pointing_dircos).reshape(3)
    p = p / jnp.linalg.norm(p)
    cosang = jnp.clip(_hmm(dircos, p), -1.0, 1.0)
    sinang = jnp.sqrt(jnp.clip(1.0 - cosang ** 2, 0.0, 1.0))
    below = jnp.logical_or(dircos[:, 2] < 0.0, cosang < 0.0)
    return sinang, below


def _j1_true(x, N=4096):
    """True J1 in f64 via the integral representation
    J1(x) = (1/pi) * int_0^pi cos(theta - x sin(theta)) dtheta,
    midpoint rule (geometric convergence for analytic integrands;
    validated to ~5e-17 against tabulated J1(1), J1(8)). Fit-time
    only — never traced."""
    x = np.asarray(x, np.float64)
    th = (np.arange(N) + 0.5) * np.pi / N
    return np.mean(np.cos(th[None, :] - x[:, None]
                          * np.sin(th)[None, :]), axis=1)


_AIRY_TAIL_HI = 32.0


def _airy_tail_cheb(deg=40):
    """Chebyshev coefficients of h(x) = 2 J1(x)/x on x in [8, 32]
    (t = (x - 20)/12), fit in f64 against the true J1 integral.
    Residual ~1e-16: on this domain the truth path needs no
    trigonometry at all (the A&S asymptotic form is itself good to
    2.3e-10 here, but its f32 evaluation loses ~3e-7 absolute to
    sin/cos argument reduction at x~30)."""
    xs = np.linspace(8.0, _AIRY_TAIL_HI, 4001)
    h = 2.0 * _j1_true(xs) / xs
    t = (xs - 20.0) / 12.0
    return np.polynomial.chebyshev.chebfit(t, h, deg)


_AIRY_TAIL_CHEB = _airy_tail_cheb()


def _df_clenshaw(th, tl, coeffs):
    """Two-float Clenshaw evaluation of a Chebyshev series at the
    two-float argument (th + tl), coefficients host f64 (split into
    exact two-float pairs). Absolute error ~deg * 2^-45 * max|b| —
    f64-class for O(1) coefficient scales.

    The recurrence runs as a lax.scan over the coefficient table: a
    fully unrolled two-float chain of this depth sends the XLA CPU
    optimizer super-linear (two such chains in one jit never finished
    compiling), while the scan body is a handful of ops compiled
    once."""
    import jax
    from .. import twofloat as tf
    t2h, t2l = tf.df_add(th, tl, th, tl)
    cs = np.asarray(coeffs, np.float64)
    chs = cs.astype(np.float32)
    cls = (cs - chs.astype(np.float64)).astype(np.float32)
    ctab = jnp.asarray(np.stack([chs[:0:-1], cls[:0:-1]], axis=-1))
    z = jnp.zeros_like(th)

    def step(carry, c):
        b1h, b1l, b2h, b2l = carry
        ph, pl = tf.df_mul(t2h, t2l, b1h, b1l)
        ph, pl = tf.df_add(ph, pl, -b2h, -b2l)
        nh, nl = tf.df_add(ph, pl, c[0], c[1])
        return (nh, nl, b1h, b1l), None

    (b1h, b1l, b2h, b2l), _ = jax.lax.scan(step, (z, z, z, z), ctab)
    c0h = np.float32(cs[0])
    c0l = np.float32(cs[0] - np.float64(c0h))
    ph, pl = tf.df_mul(th, tl, b1h, b1l)
    ph, pl = tf.df_add(ph, pl, -b2h, -b2l)
    return tf.df_add(ph, pl, c0h, c0l)


def airy_beam_df(s_hi, s_lo, freqs, diameter, power=True):
    """Two-float32 Airy power pattern at static frequencies —
    ~f64-accurate in float32 hardware (no float64 anywhere).

    The f32 `airy_beam` carries ~1-3e-7/element rounding whose
    incoherent sum over north-star source counts floors every
    engine's visibility error at ~3.5e-6 of scale vs the f64 truth
    (benchmarks/accuracy_northstar.py --golden f64amps, round 5); the
    reference never sees this because its beams are f64 numpy
    (primary_beams.py:517). This path reproduces the f64 model to
    ~1e-9: sin(theta) from the two-float source vectors via df_sqrt,
    x = pi*D*nu/c * sin(theta) with exactly-split f64 constants, and
    2*J1(x)/x by two-float Clenshaw — the existing [0,8) Chebyshev
    plus a degree-40 true-J1 fit on [8,32] (no division, no trig).

    s_hi, s_lo : (S, 3) two-float ENU direction cosines
    freqs      : (r,) HOST f64 frequencies (static at trace time);
                 requires pi*D*max(freqs)/c <= 32 (callers gate on
                 airy_df_available)
    Returns (hi, lo) of the (S, r) power (or field) pattern, zeroed
    below the horizon (sign of the two-float Up component, matching
    the f64 golden's mask)."""
    from .. import twofloat as tf
    freqs = np.asarray(freqs, np.float64)
    a = np.pi * freqs * (diameter / CNST.c)      # x = a * sin(theta)
    if a.max() > _AIRY_TAIL_HI:
        raise ValueError("airy_beam_df: pi*D*nu/c = %.1f exceeds the "
                         "[8,32] tail fit domain" % a.max())
    ah = a.astype(np.float32)
    al = (a - ah.astype(np.float64)).astype(np.float32)
    ah = jnp.asarray(ah)[None, :]
    al = jnp.asarray(al)[None, :]

    lh, ll = s_hi[:, 0], s_lo[:, 0]
    mh, ml = s_hi[:, 1], s_lo[:, 1]
    s2h, s2l = tf.df_add(*tf.df_mul(lh, ll, lh, ll),
                         *tf.df_mul(mh, ml, mh, ml))
    over = (s2h + s2l) >= 1.0
    s2h = jnp.where(over, 1.0, s2h)
    s2l = jnp.where(over, 0.0, s2l)
    sth, stl = tf.df_sqrt(s2h, s2l)

    xh, xl = tf.df_mul(sth[:, None], stl[:, None], ah, al)   # (S, r)
    # branch A: x < 8, g(u) = J1(x)/x on u = x^2
    uh, ul = tf.df_mul(xh, xl, xh, xl)
    tsh, tsl = tf.df_add_f(*(uh * np.float32(1.0 / 32.0),
                             ul * np.float32(1.0 / 32.0)),
                           np.float32(-1.0))
    gh, gl = _df_clenshaw(tsh, tsl, _J1_CHEB)
    smh, sml = 2.0 * gh, 2.0 * gl
    # branch B: 8 <= x <= 32, h(x) = 2 J1(x)/x directly
    c12 = 1.0 / 12.0
    c12h = np.float32(c12)
    c12l = np.float32(c12 - np.float64(c12h))
    tth, ttl = tf.df_mul(*tf.df_add_f(xh, xl, np.float32(-20.0)),
                         c12h, c12l)
    bgh, bgl = _df_clenshaw(tth, ttl, _AIRY_TAIL_CHEB)
    tail = xh >= 8.0
    ph = jnp.where(tail, bgh, smh)
    pl = jnp.where(tail, bgl, sml)
    if power:
        ph, pl = tf.df_mul(ph, pl, ph, pl)
    above = (s_hi[:, 2] + s_lo[:, 2]) > 0.0
    ph = jnp.where(above[:, None], ph, 0.0)
    pl = jnp.where(above[:, None], pl, 0.0)
    return ph, pl


def airy_df_available(freqs, diameter):
    """True when airy_beam_df's tail fit covers the band."""
    return (np.pi * float(np.max(freqs)) * diameter / CNST.c
            <= _AIRY_TAIL_HI)


def airy_beam(dircos, freqs, diameter, pointing_dircos=None, power=True):
    """Airy pattern of a uniformly illuminated dish: 2 J1(x)/x with
    x = k (D/2) sin(theta) (cf. primary_beams.py:611-626)."""
    sin_t, below = _offaxis_sin(dircos, pointing_dircos)
    k = 2.0 * jnp.pi * jnp.asarray(freqs) / CNST.c
    arg = k[None, :] * (0.5 * diameter) * sin_t[:, None]
    small = jnp.abs(arg) < 1e-6
    safe = jnp.where(small, 1.0, arg)
    pattern = jnp.where(small, 1.0 - arg * arg / 8.0,
                        2.0 * bessel_j1(safe) / safe)
    pattern = jnp.where(below[:, None], 0.0, pattern)
    return pattern ** 2 if power else pattern


def gaussian_beam(dircos, freqs, diameter, pointing_dircos=None, power=True):
    """Chromatic gaussian with FWHM aperture `diameter`
    (cf. primary_beams.py:718-728)."""
    sin_t, below = _offaxis_sin(dircos, pointing_dircos)
    wl = CNST.c / jnp.asarray(freqs)
    sigma_aprtr = diameter / (2.0 * jnp.sqrt(2.0 * jnp.log(2.0))) / wl
    sigma_dircos = 1.0 / (2.0 * jnp.pi * sigma_aprtr)
    pattern = jnp.exp(-0.5 * (sin_t[:, None] / sigma_dircos[None, :]) ** 2)
    pattern = jnp.where(below[:, None], 0.0, pattern)
    return pattern ** 2 if power else pattern


def dipole_beam(dircos, freqs, length, orientation_dircos=(1.0, 0.0, 0.0),
                short_dipole=False, half_wave=False, power=True):
    """Finite-length dipole field pattern
    (cf. primary_beams.py:1208-1237):
      E = (cos(kh cos a) - cos(kh)) / sin a, normalized by (1 - cos kh),
    where a is the angle between source and dipole axis."""
    d = jnp.asarray(np.asarray(orientation_dircos,
                               dtype=np.float32)).reshape(3)
    d = d / jnp.linalg.norm(d)
    cosa = jnp.clip(_hmm(dircos, d), -1.0, 1.0)
    sina = jnp.sqrt(jnp.clip(1.0 - cosa ** 2, 1e-12, 1.0))
    if short_dipole:
        pattern = jnp.broadcast_to(sina[:, None],
                                   (dircos.shape[0], len(np.atleast_1d(freqs))))
        return pattern ** 2 if power else pattern
    if half_wave:
        pattern = jnp.cos(0.5 * jnp.pi * cosa) / sina
        pattern = jnp.broadcast_to(pattern[:, None],
                                   (dircos.shape[0], len(np.atleast_1d(freqs))))
        return pattern ** 2 if power else pattern
    k = 2.0 * jnp.pi * jnp.asarray(freqs) / CNST.c
    kh = k * (0.5 * length)
    maxpat = 1.0 - jnp.cos(kh)
    num = jnp.cos(kh[None, :] * cosa[:, None]) - jnp.cos(kh)[None, :]
    pattern = num / sina[:, None] / maxpat[None, :]
    # L'Hopital limit as a -> 0: kh sin(kh cos a) tan(a) -> 0
    pattern = jnp.where(jnp.abs(jnp.abs(cosa) - 1.0)[:, None] < 1e-10,
                        0.0, pattern)
    return pattern ** 2 if power else pattern


def ground_plane_pattern(dircos, freqs, height, modifier=None, power=False):
    """Image-dipole ground-plane factor 2 sin(k h sin(alt)), peak-normalized
    (cf. primary_beams.py:948-970)."""
    k = 2.0 * jnp.pi * jnp.asarray(freqs) / CNST.c
    sinalt = jnp.clip(dircos[:, 2], 0.0, 1.0)
    gp = 2.0 * jnp.sin(k[None, :] * height * sinalt[:, None])
    if modifier is not None:
        val = 1.0 / jnp.sqrt(jnp.clip(jnp.abs(dircos[:, 2]), 1e-10, None))
        if "scale" in modifier:
            val = val * modifier["scale"]
        if "max" in modifier:
            val = jnp.clip(val, 0.0, modifier["max"])
        gp = gp * val[:, None]
    gp = gp / (2.0 * jnp.sin(k[None, :] * height))
    return gp ** 2 if power else gp


_VLA_FREQ_REF = np.array([0.0738, 0.3275, 1.465, 4.885, 8.435, 14.965,
                          22.485, 43.315])
_VLA_PARMS = np.array([
    [-0.897, 2.71, -0.242], [-0.935, 3.23, -0.378], [-1.343, 6.579, -1.186],
    [-1.372, 6.940, -1.309], [-1.306, 6.253, -1.100],
    [-1.305, 6.155, -1.030], [-1.417, 7.332, -1.352],
    [-1.321, 6.185, -0.983]])

_GMRT_FREQ_REF = np.array([0.235, 0.325, 0.610, 1.420])
_GMRT_PARMS = {
    "gmrt": np.array([[-3.366, 46.159, -29.963, 7.529],
                      [-3.397, 47.192, -30.931, 7.803],
                      [-3.486, 47.749, -35.203, 10.399],
                      [-2.27961, 21.4611, -9.7929, 1.80153]]),
    "ugmrt": np.array([[np.nan] * 4,
                       [-2.939, 33.312, -16.659, 3.006],
                       [-3.190, 38.642, -20.471, 3.964],
                       [-2.608, 27.357, -13.091, 2.365]]),
}


def _offaxis_deg(dircos):
    n = jnp.clip(dircos[:, 2], -1.0, 1.0)
    return jnp.degrees(jnp.arccos(n))


def vla_pbcor_beam(dircos, freqs, clip_negative=True):
    """AIPS PBCOR 3-term polynomial in (angle[arcmin] * freq[GHz])^2
    (cf. primary_beams.py:483-513). Band selected by the first frequency."""
    f_ghz = np.asarray(freqs, dtype=np.float64) / 1e9
    idx = int(np.argmin(np.abs(_VLA_FREQ_REF - f_ghz[0])))
    a1, a2, a3 = _VLA_PARMS[idx]
    ang = _offaxis_deg(dircos)
    x = (ang[:, None] * 60.0 * jnp.asarray(f_ghz)[None, :]) ** 2
    pb = 1.0 + a1 * x / 1e3 + a2 * x ** 2 / 1e7 + a3 * x ** 3 / 1e10
    if clip_negative:
        pb = jnp.clip(pb, 0.0, None)
    return pb


def gmrt_beam(dircos, freqs, instrument="gmrt", clip_negative=True):
    """GMRT/uGMRT PBCOR 4-term polynomial (cf. primary_beams.py:752-795)."""
    f_ghz = np.asarray(freqs, dtype=np.float64) / 1e9
    idx = int(np.argmin(np.abs(_GMRT_FREQ_REF - f_ghz[0])))
    a1, a2, a3, a4 = _GMRT_PARMS[instrument][idx]
    ang = _offaxis_deg(dircos)
    x = (ang[:, None] * 60.0 * jnp.asarray(f_ghz)[None, :]) ** 2
    pb = (1.0 + a1 * x / 1e3 + a2 * x ** 2 / 1e7 + a3 * x ** 3 / 1e10
          + a4 * x ** 4 / 1e13)
    if clip_negative:
        pb = jnp.clip(pb, 0.0, None)
    return pb


def _sinc(x):
    return jnp.sinc(x)  # normalized sinc sin(pi x)/(pi x)


def uniform_rect_aperture_beam(dircos, freqs, sides,
                               pointing_dircos=None, power=True):
    """sinc x sinc pattern of a uniformly illuminated rectangular aperture
    (cf. primary_beams.py:2230-2243)."""
    wl = CNST.c / jnp.asarray(freqs)
    if pointing_dircos is None:
        rel = dircos
    else:
        rel = dircos - jnp.asarray(pointing_dircos).reshape(1, 3)
    arg1 = sides[0] * rel[:, 0][:, None] / wl[None, :]
    arg2 = sides[1] * rel[:, 1][:, None] / wl[None, :]
    ab = _sinc(arg1) * _sinc(arg2)
    ab = jnp.where((dircos[:, 2] < 0.0)[:, None], 0.0, ab)
    return ab ** 2 if power else ab


def uniform_square_aperture_beam(dircos, freqs, side, pointing_dircos=None,
                                 power=True):
    return uniform_rect_aperture_beam(dircos, freqs, (side, side),
                                      pointing_dircos=pointing_dircos,
                                      power=power)


def mwa_tile_positions():
    """4x4 grid of dipoles, 1.1 m spacing (cf. primary_beams.py:289-292)."""
    x, y = np.meshgrid(1.1 * np.linspace(-1.5, 1.5, 4),
                       1.1 * np.linspace(1.5, -1.5, 4))
    return np.stack([x.ravel(), y.ravel(), np.zeros(16)], axis=-1)


def array_field_pattern(element_pos, dircos, freqs, pointing_dircos=None,
                        delays=None, gains=None, delayerr=0.0, gainerr_db=0.0,
                        nrand=1, key=None):
    """Beamformer array factor with optional random delay/gain errors.

    AF(s, nu) = (1/N) sum_a g_a exp(i 2 pi nu (delta_a - s.x_a / c))
    with delta_a = x_a . p / c delay compensation toward pointing p
    (cf. primary_beams.py:1600-1755). Returns (nsrc, nchan, nrand) complex.
    """
    element_pos = jnp.asarray(element_pos, dtype=jnp.float32)
    nant = element_pos.shape[0]
    freqs = jnp.asarray(freqs)
    if delays is None:
        if pointing_dircos is not None:
            p = jnp.asarray(pointing_dircos).reshape(3)
            delays = _hmm(element_pos, p) / CNST.c
        else:
            delays = jnp.zeros(nant)
    else:
        delays = jnp.asarray(delays).reshape(nant)
    if gains is None:
        gains = jnp.ones(nant)
    else:
        gains = jnp.asarray(gains).reshape(nant)

    if (delayerr > 0.0 or gainerr_db > 0.0) and key is None:
        key = jax.random.PRNGKey(0)
    d = delays[:, None] + jnp.zeros((nant, nrand))
    g = gains[:, None] + jnp.zeros((nant, nrand))
    if delayerr > 0.0:
        key, sub = jax.random.split(key)
        d = d + delayerr * jax.random.normal(sub, (nant, nrand))
    if gainerr_db > 0.0:
        key, sub = jax.random.split(key)
        g = g * 10.0 ** ((gainerr_db / 10.0)
                         * jax.random.normal(sub, (nant, nrand)))

    geom_delay = -_hmm(dircos, element_pos.T) / CNST.c     # (nsrc, nant)
    # phase: 2 pi nu (geom + delay) -> (nsrc, nant, nchan, nrand)
    tot = geom_delay[:, :, None, None] + d[None, :, None, :]
    phase = 2.0 * jnp.pi * freqs[None, None, :, None] * tot
    af = jnp.sum(g[None, :, None, :]
                 * jnp.exp(1j * phase), axis=1) / nant
    return af  # (nsrc, nchan, nrand)


def _bc_element_chan(x, nelem, nchan, what):
    """Normalize per-element/per-channel arrays to (nelem|1, nchan|1):
    scalar, (nelem,), (nchan,), (nelem, nchan), or already-3D
    (nelem, nchan, nrand) (returned unchanged)."""
    x = jnp.asarray(x)
    if x.ndim == 0:
        return x.reshape(1, 1)
    if x.ndim == 1:
        if x.shape[0] == nelem:
            return x.reshape(nelem, 1)
        if x.shape[0] == nchan:
            return x.reshape(1, nchan)
        if x.shape[0] == 1:
            return x.reshape(1, 1)
        raise ValueError("size of %s inconsistent with elements/channels"
                         % what)
    if x.ndim == 2:
        return x
    if x.ndim == 3:
        return x
    raise ValueError("%s must be scalar, 1-D, 2-D or 3-D" % what)


def generic_aperture_field_pattern(aperture_locs, dircos, freqs,
                                   pointing_dircos=None, delays=None,
                                   gains=None, delayerr=0.0,
                                   gainerr_db=0.0, nrand=1, key=None,
                                   power=False):
    """Field pattern of an arbitrary aperture of isotropic radiators.

    Generalizes array_field_pattern with FREQUENCY-DEPENDENT complex
    element gains and delays — scalars, (nelem,), (nchan,),
    (nelem, nchan), or (nelem, nchan, nrand) — modeling aperture surface
    imperfections (generic_aperture_field_pattern,
    /root/reference/prisim/primary_beams.py:1758-2055).

    AF(s, nu) = (1/N) sum_a g_a(nu) exp(i 2 pi nu (d_a(nu) - s.x_a/c)),
    d_a defaulting to x_a.p/c delay compensation toward pointing p.
    Returns (nsrc, nchan, nrand) complex field, or the power pattern
    mean_nrand |AF|^2 (nsrc, nchan) when power=True."""
    aperture_locs = jnp.asarray(aperture_locs, dtype=jnp.float32)
    if aperture_locs.shape[1] == 2:
        aperture_locs = jnp.concatenate(
            [aperture_locs, jnp.zeros((aperture_locs.shape[0], 1),
                                      dtype=jnp.float32)], axis=1)
    nelem = aperture_locs.shape[0]
    dircos = jnp.asarray(dircos)
    freqs = jnp.asarray(freqs)
    nchan = freqs.shape[0]
    if delays is None:
        if pointing_dircos is not None:
            p = jnp.asarray(pointing_dircos).reshape(3)
            delays = (_hmm(aperture_locs, p) / CNST.c).reshape(nelem, 1)
        else:
            delays = jnp.zeros((1, 1))
    else:
        delays = _bc_element_chan(delays, nelem, nchan, "delays")
    gains = jnp.ones((1, 1)) if gains is None else \
        _bc_element_chan(gains, nelem, nchan, "gains")
    if delays.ndim == 2:
        delays = delays[:, :, None]
    if gains.ndim == 2:
        gains = gains[:, :, None]

    if (delayerr > 0.0 or gainerr_db > 0.0) and key is None:
        key = jax.random.PRNGKey(0)
    if delayerr > 0.0:
        key, sub = jax.random.split(key)
        delays = delays + delayerr * jax.random.normal(
            sub, (nelem, 1, nrand))
    if gainerr_db > 0.0:
        key, sub = jax.random.split(key)
        gains = gains * 10.0 ** ((gainerr_db / 10.0)
                                 * jax.random.normal(sub,
                                                     (nelem, 1, nrand)))
    nr = max(int(nrand), delays.shape[-1], gains.shape[-1])

    geom_delay = -_hmm(dircos, aperture_locs.T) / CNST.c   # (nsrc, nelem)
    # (nsrc, nelem, nchan, nrand)
    tot = geom_delay[:, :, None, None] + delays[None, :, :, :]
    phase = 2.0 * jnp.pi * freqs[None, None, :, None] * tot
    af = jnp.sum(gains[None] * jnp.exp(1j * phase), axis=1) / nelem
    if af.shape[-1] != nr:
        af = jnp.broadcast_to(af, af.shape[:-1] + (nr,))
    if power:
        return jnp.mean(jnp.abs(af) ** 2, axis=-1)
    return af


def _feed_sky_field(feedinfo, dircos, freqs, short_dipole=False,
                    half_wave=True):
    """Complex feed element field at the given directions: the shared
    shape dispatch of feed_illumination_of_aperture /
    feed_aperture_combined_field_pattern
    (/root/reference/prisim/primary_beams.py:2510-2560, 2752-2790).
    Returns (nsrc, nchan, nrand) complex."""
    shape = (feedinfo or {}).get("shape", "delta")
    nsrc = dircos.shape[0]
    nchan = freqs.shape[0]
    if shape == "delta":
        ep = jnp.ones((nsrc, nchan))
    elif shape == "dipole":
        ep = dipole_beam(dircos, freqs, feedinfo["size"],
                         orientation_dircos=feedinfo.get(
                             "orientation_dircos", (1.0, 0.0, 0.0)),
                         short_dipole=short_dipole, half_wave=half_wave,
                         power=False)
    elif shape == "dish":
        ep = airy_beam(dircos, freqs, feedinfo["size"], power=False)
    elif shape == "rect":
        ep = uniform_rect_aperture_beam(dircos, freqs, feedinfo["size"],
                                        power=False)
    elif shape == "square":
        ep = uniform_square_aperture_beam(dircos, freqs,
                                          feedinfo["size"], power=False)
    else:
        raise ValueError("invalid feed shape %r" % shape)
    ep = ep[:, :, None].astype(jnp.complex64)
    if feedinfo.get("element_locs") is not None:
        # phased-array feed: isotropic-radiator array factor
        ep = ep * array_field_pattern(feedinfo["element_locs"], dircos,
                                      freqs)
    if feedinfo.get("groundplane") is not None and shape != "dish":
        gp = ground_plane_pattern(dircos, freqs,
                                  feedinfo["groundplane"],
                                  modifier=feedinfo.get("ground_modify"),
                                  power=False)
        ep = ep * gp[:, :, None]
    return ep


def feed_illumination_of_aperture(aperture_locs, feedinfo, freqs,
                                  short_dipole=False, half_wave=True):
    """Complex feed illumination of aperture samples
    (feed_illumination_of_aperture,
    /root/reference/prisim/primary_beams.py:2344-2570).

    aperture_locs: (N, 2|3) sample positions, ENU meters. feedinfo:
    dict with position (3,), shape, size, orientation_dircos,
    element_locs (phased-array feed), groundplane. The feed's field
    pattern is evaluated along the directions from the feed to each
    sample (apertures below the feed are mirrored — the feed "only
    points upwards", reference :2504-2506).

    Returns (rel_locs (N, 3), illumination (N, nchan, nrand))."""
    locs = np.asarray(aperture_locs, dtype=np.float64)
    if locs.shape[1] == 2:
        locs = np.hstack([locs, np.zeros((locs.shape[0], 1))])
    pos = np.asarray((feedinfo or {}).get("position") or (0.0, 0.0, 0.0),
                     dtype=np.float64).reshape(3)
    rel = locs - pos[None, :]
    look = -rel if rel[:, 2].mean() < 0.0 else rel
    r = np.linalg.norm(look, axis=1)
    safe = np.where(r > 0, r, 1.0)
    dirs = look / safe[:, None]
    dirs[r == 0] = (0.0, 0.0, 1.0)          # sample at the feed: zenith
    illum = _feed_sky_field(feedinfo, jnp.asarray(dirs),
                            jnp.asarray(freqs),
                            short_dipole=short_dipole,
                            half_wave=half_wave)
    return rel, illum


def feed_aperture_combined_field_pattern(aperture_locs, feedinfo, dircos,
                                         freqs, pointing_dircos=None,
                                         short_dipole=False,
                                         half_wave=True, power=True):
    """Combined feed x aperture pattern
    (feed_aperture_combined_field_pattern,
    /root/reference/prisim/primary_beams.py:2572-2828): the feed's own
    sky field pattern times the aperture array factor whose per-element
    complex gains are the feed's illumination of the aperture samples.
    Returns (nsrc, nchan) power (default) or (nsrc, nchan, nrand)
    field."""
    dircos = jnp.asarray(dircos)
    freqs = jnp.asarray(freqs)
    rel, illum = feed_illumination_of_aperture(
        aperture_locs, feedinfo, freqs, short_dipole=short_dipole,
        half_wave=half_wave)
    feed_fp = _feed_sky_field(feedinfo, dircos, freqs,
                              short_dipole=short_dipole,
                              half_wave=half_wave)
    ap = generic_aperture_field_pattern(rel, dircos, freqs,
                                        pointing_dircos=pointing_dircos,
                                        gains=illum, power=False)
    field = ap * feed_fp
    if power:
        return jnp.mean(jnp.abs(field) ** 2, axis=-1)
    return field
