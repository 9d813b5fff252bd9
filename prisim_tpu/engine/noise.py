"""Thermal noise model (radiometer equation) with jax PRNG.

Rebuild of thermalNoiseRMS / generateNoise
(/root/reference/prisim/interferometry.py:89-330; SIRA II ch. 9 eqs
9-12..9-15): complex visibility noise RMS

  sigma(Jy) = 2 k_B Tsys / (A_eff eff_Q sqrt(dt df)) / 1e-26
  sigma(K)  = Tsys / (eff_Q sqrt(dt df))

with 1/sqrt(2) of sigma into each of the real/imag parts. The reference's
numpy RandomState draws become counter-based threefry keys — identical
noise for identical (key, shape), independent of device count/layout.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import constants as CNST

__all__ = ["thermal_noise_rms", "generate_noise"]


def thermal_noise_rms(A_eff, df, dt, Tsys, nbl=1, nchan=1, ntimes=1,
                      flux_unit="Jy", eff_Q=1.0, xp=jnp):
    """Complex-visibility thermal noise RMS, broadcast to (nbl,nchan,ntimes).

    A_eff / Tsys / eff_Q may be scalars or arrays broadcastable to
    (nbl, nchan, ntimes)."""
    Tsys = xp.asarray(Tsys)
    A_eff = xp.asarray(A_eff)
    eff_Q = xp.asarray(eff_Q)
    if flux_unit.lower() == "k":
        rms = Tsys / eff_Q / xp.sqrt(dt * df)
    elif flux_unit.lower() == "jy":
        rms = (2.0 * CNST.k_B / xp.sqrt(dt * df)
               * (Tsys / A_eff / eff_Q) / CNST.Jy)
    else:
        raise ValueError("flux_unit must be 'K' or 'Jy'")
    return xp.broadcast_to(rms, (nbl, nchan, ntimes))


def generate_noise(key, noise_rms, shape=None):
    """Complex gaussian noise with the given per-sample RMS.

    key: jax PRNG key; noise_rms broadcastable to `shape`
    (default: noise_rms.shape). Returns complex64, built inside one
    jit."""
    if shape is None:
        shape = noise_rms.shape
    shape = tuple(int(n) for n in shape)

    @functools.partial(jax.jit, static_argnames=("shp",))
    def _gen(key, rms, shp):
        kr, ki = jax.random.split(key)
        scale = rms / np.sqrt(2.0)
        re = scale * jax.random.normal(kr, shp, dtype=jnp.float32)
        im = scale * jax.random.normal(ki, shp, dtype=jnp.float32)
        return re + 1j * im

    return _gen(key, jnp.asarray(noise_rms), shape)


def tsys_model(Trx, Tant_T0, Tant_f0, Tant_spindex, freqs, Tnet=None,
               xp=jnp):
    """Tsys(nu) = Trx + T0 (nu/f0)^spindex, or Tnet override
    (cf. /root/reference/prisim/interferometry.py:5897-5925)."""
    if Tnet is not None:
        return xp.broadcast_to(xp.asarray(Tnet), xp.asarray(freqs).shape)
    freqs = xp.asarray(freqs)
    return Trx + Tant_T0 * (freqs / Tant_f0) ** Tant_spindex
