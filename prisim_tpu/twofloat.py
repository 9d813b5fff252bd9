"""Double-float ("two-float") arithmetic in float32 for accelerators.

Accelerators run float32 far faster than float64 (an H100 has 67 TFLOP/s
of float32 against 34 of float64). The NUDFT phase argument 2*pi*nu*(b.s)/c reaches
~1e3 cycles at HERA-331 scale; representing it in a single float32 quantizes
the phase at ~1e-4 rad, far above the 1e-6 relative-error target
(cf. the float64 phase path in the reference,
/root/reference/prisim/interferometry.py:6355-6376). We therefore carry the
*cycle count* of the phase as an unevaluated sum of two float32s (hi + lo),
good to ~2^-44 relative, reduce it modulo 1 exactly, and only then convert to
radians for f32 sin/cos.

All ops are branch-free, jit-safe, and require no FMA (Dekker/Veltkamp
algorithms). They work identically under numpy for host-side golden tests.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Veltkamp split constant for float32 (2^12 + 1).
_SPLIT_F32 = 4097.0

# 2*pi as a two-float32 (hi rounds to 6.2831855; lo carries the residual).
TWO_PI_HI = float(np.float32(2.0 * np.pi))
TWO_PI_LO = float(np.float32(2.0 * np.pi - np.float64(np.float32(2.0 * np.pi))))


def two_sum(a, b):
    """Knuth exact addition: a + b = s + e with s = fl(a+b)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Dekker exact addition, requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Split a float32 into 12-bit hi and lo halves.

    Host (numpy) values take Veltkamp's split. Traced values clear the
    low 12 mantissa bits instead: a GPU compiler may contract
    Veltkamp's `t - (t - a)` with t = 4097 a into a fused multiply-add,
    which leaves hi with more than 12 bits and two_prod inexact. The
    masked halves make every partial product in two_prod exact whether
    or not it is contracted, and give the same (p, e) pair."""
    if isinstance(a, (np.ndarray, np.generic, float, int)):
        t = _SPLIT_F32 * a
        hi = t - (t - a)
        return hi, a - hi
    bits = jax.lax.bitcast_convert_type(a, jnp.uint32)
    hi = jax.lax.bitcast_convert_type(bits & jnp.uint32(0xFFFFF000),
                                      jnp.float32)
    return hi, a - hi


def two_prod(a, b):
    """Dekker exact multiplication: a * b = p + e with p = fl(a*b)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def df_add(xh, xl, yh, yl):
    """(xh+xl) + (yh+yl) -> normalized two-float."""
    sh, se = two_sum(xh, yh)
    te = xl + yl + se
    return fast_two_sum(sh, te)


def df_add_f(xh, xl, y):
    """(xh+xl) + y -> normalized two-float."""
    sh, se = two_sum(xh, y)
    return fast_two_sum(sh, se + xl)


def df_mul(xh, xl, yh, yl):
    """(xh+xl) * (yh+yl) -> normalized two-float (drops xl*yl)."""
    ph, pe = two_prod(xh, yh)
    pe = pe + (xh * yl + xl * yh)
    return fast_two_sum(ph, pe)


def df_mul_f(xh, xl, y):
    """(xh+xl) * y -> normalized two-float."""
    ph, pe = two_prod(xh, y)
    pe = pe + xl * y
    return fast_two_sum(ph, pe)


def df_neg(xh, xl):
    return -xh, -xl


def df_sqrt(xh, xl, xp=jnp):
    """sqrt(xh+xl) -> normalized two-float, for x >= 0.

    One Newton refinement of the f32 rsqrt seed in two-float
    arithmetic: s0 = x*r, e = x - s0^2 (exact via two_prod), s = s0 +
    e*r/2. Relative error ~2^-45; x == 0 maps to (0, 0) exactly."""
    safe = xp.maximum(xh, np.float32(1e-30))
    r = 1.0 / xp.sqrt(safe)
    s0 = safe * r                       # ~sqrt(x), f32
    p, pe = two_prod(s0, s0)            # s0^2 exactly
    # e = (x - s0^2) in two-float; |e| <~ ulp(x)
    eh, el = df_add(xh, xl, -p, -pe)
    corr = (eh + el) * (0.5 * r)
    h, lo = fast_two_sum(s0, corr)
    zero = xh <= 0.0
    return xp.where(zero, 0.0, h), xp.where(zero, 0.0, lo)


def df_frac(xh, xl, xp=jnp):
    """Reduce a two-float to its fractional part in [-0.5, 0.5].

    Valid while |xh| < 2^23 so that round(xh) is exactly representable and
    xh - round(xh+xl) is a Sterbenz-exact subtraction.
    """
    n = xp.round(xh + xl)
    h = xh - n  # exact: both are integers-scale values within f32 range
    return fast_two_sum(h, xl)


def df_sincos_cycles(ch, cl, xp=jnp, two_pi=(TWO_PI_HI, TWO_PI_LO)):
    """(cos, sin) of 2*pi*(ch+cl) for a frac-reduced two-float cycle count.

    Collapsing the cycles to a single f32 before the multiply costs
    ~2^-24 cycles (~4e-7 rad) per phasor, and multiplying by a single-f32
    2*pi costs another ~2.5e-7 rad at |c|=0.5 — both above the 1e-6
    visibility budget at north-star scale. Here the radian conversion is
    a two-float product (ah + al, |al| <~ 2e-7) and the residual enters
    through the first-order rotation sin(ah+al) ~= sin+cos*al,
    cos(ah+al) ~= cos-sin*al, leaving only the f32 sincos intrinsic
    error (~1 ulp).

    `two_pi` lets kernel callers pass the constants as opaque runtime
    values, so a compiler cannot constant-fold the compensated
    product.
    """
    ph, plo = two_pi
    ah, al = df_mul(ch, cl, ph, plo)
    c = xp.cos(ah)
    s = xp.sin(ah)
    return c - s * al, s + c * al


def df_dot3(ah, al, bh, bl):
    """Two-float dot product of 3-vectors along the last axis.

    a, b: (..., 3) two-float arrays. Returns (..., ) two-float.
    Used for kdot = s_hat . b (meters) where s_hat carries f64-sourced
    hi/lo parts; accuracy ~|b| * 2^-44.
    """
    ph, pl = two_prod(ah[..., 0], bh[..., 0])
    pl = pl + (ah[..., 0] * bl[..., 0] + al[..., 0] * bh[..., 0])
    for k in (1, 2):
        qh, ql = two_prod(ah[..., k], bh[..., k])
        ql = ql + (ah[..., k] * bl[..., k] + al[..., k] * bh[..., k])
        ph, pl = df_add(ph, pl, qh, ql)
    return ph, pl


# ----------------------------------------------------------------------------
# Host-side converters (numpy float64 -> two-float32 pairs)
# ----------------------------------------------------------------------------

def split_f64(x):
    """Split float64 array into (hi, lo) float32 arrays with hi+lo ~= x."""
    x = np.asarray(x, dtype=np.float64)
    hi = x.astype(np.float32)
    lo = (x - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def join_f64(hi, lo):
    """Recombine two-float32 into float64 (host-side, for tests)."""
    return np.asarray(hi, dtype=np.float64) + np.asarray(lo, dtype=np.float64)
