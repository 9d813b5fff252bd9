"""Jones-vector feed models and Mueller beam weights for full-pol runs.

The reference is single-polarization: its beam dispatcher returns one
power pattern per run (/root/reference/prisim/primary_beams.py:9) and
its pyuvdata exports carry a single linear product
(/root/reference/prisim/interferometry.py:9528-9618). This module goes
beyond it: physical
XY/YX cross-polarization from dipole Jones vectors, so a `beam.pol:
"full"` run produces all four linear correlations with real leakage
instead of flagged zeros.

Physics. A linear feed p with horizontal orientation p_hat responds to
the transverse field of a source at direction s_hat with the Jones
VECTOR

    J_p(s, nu) = A_p(s, nu) * (p_hat - (p_hat . s_hat) s_hat)

where the unnormalized transverse projection has norm sin(psi_p)
(psi_p = angle between s_hat and the dipole axis) and A_p =
F_p(psi_p)/sin(psi_p) * g(theta, nu) carries the finite-length element
factor F_p and the ground-plane image factor g. For an UNPOLARIZED sky
(Stokes I only, the reference's regime) the correlated power beam
between feeds p and q is the Mueller weight

    B_pq(s, nu) = 1/2 <(J_p . E)(J_q . E)*> * 2/|E|^2 = J_p . J_q*

(the sky field E is isotropic in the transverse plane, so the average
collapses to the dot product of the Jones vectors — no theta/phi basis
needed, which also removes the zenith azimuth singularity). With real
dipole Jones vectors B_XY is real and B_YX = B_XY; the complex-Jones
combiner `mueller_from_jones` handles external beams with phase.

Visibilities then follow from the SAME scalar NUDFT engines, once per
product: V_pq(b, nu) = sum_s B_pq(s, nu) I_s(nu) exp(-2 pi i nu b.s/c).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from .. import constants as CNST

__all__ = ["dipole_jones", "mueller_unpol_weights", "mueller_from_jones"]


def _element_amp(cosa, freqs, length, short_dipole=False,
                 half_wave=False):
    """Element factor A = F(psi)/sin(psi) for a linear dipole, as a
    function of cos(psi) — (S, C), peak-normalized at psi = 90 deg.

    F matches beams.analytic.dipole_beam (primary_beams.py:1208-1237):
    short:      F = sin(psi)          -> A = 1
    half-wave:  F = cos(pi/2 cos psi) -> A = F / sin(psi)
    finite L:   F = (cos(kh cos psi) - cos(kh)) / (1 - cos(kh))
    The sin(psi) in A cancels the |transverse projection| = sin(psi)
    of the unnormalized Jones vector, so J = A * (p - (p.s)s) has
    |J| = F exactly."""
    cosa = jnp.clip(cosa, -1.0, 1.0)
    sina2 = jnp.clip(1.0 - cosa * cosa, 1e-12, 1.0)
    freqs = jnp.atleast_1d(jnp.asarray(freqs, jnp.float32))
    nf = freqs.shape[0]
    if short_dipole:
        return jnp.broadcast_to(jnp.ones_like(cosa)[:, None],
                                (cosa.shape[0], nf))
    if half_wave:
        a = jnp.cos(0.5 * jnp.pi * cosa) / sina2
        # psi -> 0: F -> 0 like (pi/2)(pi/4)... the ratio F/sin^2 is
        # finite but the Jones vector itself carries one sin factor;
        # A*sin(psi) = F/sin(psi) -> pi/2 * ... use the safe clip above
        return jnp.broadcast_to(a[:, None], (cosa.shape[0], nf))
    k = 2.0 * jnp.pi * jnp.asarray(freqs, jnp.float32) / CNST.c
    kh = k * (0.5 * float(length))
    num = jnp.cos(kh[None, :] * cosa[:, None]) - jnp.cos(kh)[None, :]
    return num / sina2[:, None] / (1.0 - jnp.cos(kh))[None, :]


def dipole_jones(dircos, freqs, orientation_dircos=(1.0, 0.0, 0.0),
                 length=1.0, ground_height=None, short_dipole=False,
                 half_wave=True):
    """Jones vector of one linear feed: (amp (S, C), evec (S, 3)).

    J(s, nu) = amp * evec with evec = p_hat - (p_hat.s_hat) s_hat (the
    unnormalized transverse projection; frequency-independent) and amp
    the element factor times the ground-plane image factor
    2 sin(k h s_z) (primary_beams.py:948-970) when ground_height is
    given. The split keeps the device arrays small: the direction
    vector is (S, 3) once, not (S, C, 3)."""
    dircos = jnp.asarray(dircos, jnp.float32)
    p = np.asarray(orientation_dircos, dtype=np.float64)
    p = p / np.linalg.norm(p)
    p = jnp.asarray(p, jnp.float32)
    cosa = jnp.matmul(dircos, p, precision=jax.lax.Precision.HIGHEST)
    evec = p[None, :] - cosa[:, None] * dircos
    amp = _element_amp(cosa, freqs, length, short_dipole=short_dipole,
                       half_wave=half_wave)
    if ground_height is not None:
        k = 2.0 * jnp.pi * jnp.asarray(freqs, jnp.float32) / CNST.c
        sz = jnp.clip(dircos[:, 2], 0.0, 1.0)
        amp = amp * (2.0 * jnp.sin(k[None, :] * float(ground_height)
                                   * sz[:, None]))
    return amp, evec


def mueller_unpol_weights(dircos, freqs, length=1.3,
                          ground_height=None,
                          x_orientation_deg=0.0,
                          y_orientation_deg=90.0,
                          short_dipole=False, half_wave=True):
    """Unpolarized-sky Mueller beam weights {XX, YY, XY} of a crossed
    linear-dipole pair, each (S, C) float32.

    Orientation angles are degrees east-through-north of the dipole
    AXES (X along east by default, Y along north). XX and YY are
    normalized to 1 at zenith per frequency; XY is normalized by
    sqrt(zenith_XX * zenith_YY) so the hermitian structure survives.
    A y_orientation_deg other than x+90 models feed misalignment: the
    zenith XY leakage becomes cos(dtheta) instead of 0, and off-zenith
    leakage picks up the projection asymmetry. The engines consume
    these exactly like any power beam (amps = B_pq * flux); B_XY is
    sign-indefinite, which the NUDFT path never assumes away."""
    dircos = jnp.asarray(dircos, jnp.float32)
    ax = np.radians(float(x_orientation_deg))
    ay = np.radians(float(y_orientation_deg))
    px = (np.cos(ax), np.sin(ax), 0.0)
    py = (np.cos(ay), np.sin(ay), 0.0)
    # zenith row appended for normalization (evaluated in the same
    # traced program, so the normalization is jit-safe)
    zen = jnp.asarray([[0.0, 0.0, 1.0]], jnp.float32)
    dall = jnp.concatenate([dircos, zen], axis=0)
    kw = dict(length=length, ground_height=ground_height,
              short_dipole=short_dipole, half_wave=half_wave)
    amp_x, ev_x = dipole_jones(dall, freqs, orientation_dircos=px, **kw)
    amp_y, ev_y = dipole_jones(dall, freqs, orientation_dircos=py, **kw)
    dot_xx = jnp.sum(ev_x * ev_x, axis=1)[:, None]       # (S+1, 1)
    dot_yy = jnp.sum(ev_y * ev_y, axis=1)[:, None]
    dot_xy = jnp.sum(ev_x * ev_y, axis=1)[:, None]
    b_xx = amp_x * amp_x * dot_xx
    b_yy = amp_y * amp_y * dot_yy
    b_xy = amp_x * amp_y * dot_xy
    zx = jnp.maximum(b_xx[-1:], 1e-30)                   # (1, C)
    zy = jnp.maximum(b_yy[-1:], 1e-30)
    return {"XX": b_xx[:-1] / zx,
            "YY": b_yy[:-1] / zy,
            "XY": b_xy[:-1] / jnp.sqrt(zx * zy)}


def mueller_from_jones(jx_theta, jx_phi, jy_theta, jy_phi):
    """Unpolarized-sky Mueller weights from complex Jones components
    on any (theta_hat, phi_hat) transverse basis: B_pq = J_p . J_q^*.

    Returns {XX, YY (real float32), XY (complex64)}; B_YX =
    conj(B_XY). For external full-pol beams (e.g. simulated Jones
    tables) where the feed response carries phase."""
    jxt = jnp.asarray(jx_theta)
    jxp = jnp.asarray(jx_phi)
    jyt = jnp.asarray(jy_theta)
    jyp = jnp.asarray(jy_phi)
    b_xx = (jnp.abs(jxt) ** 2 + jnp.abs(jxp) ** 2).astype(jnp.float32)
    b_yy = (jnp.abs(jyt) ** 2 + jnp.abs(jyp) ** 2).astype(jnp.float32)
    b_xy = (jxt * jnp.conj(jyt) + jxp * jnp.conj(jyp)).astype(
        jnp.complex64)
    return {"XX": b_xx, "YY": b_yy, "XY": b_xy}
