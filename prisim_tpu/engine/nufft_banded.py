"""Banded delay-grid NUFFT: the spread of the type-3 NUFFT engine.

* Baselines are grouped by DIRECTION on the host: tau_sb = |b| u_sd / c
  with u_sd = s_eff . b_hat_d, so all baselines sharing a direction
  share one source stream. Per snapshot the device computes only
  elementwise two-float u and the (S, r) spectral projection.
* The grid's occupied delay-bin range per baseline is STATIC: |u| <= 2
  for unit sources, so bins live in +-2|b|/(c h). The plan precomputes,
  per baseline, the first occupied G_blk-aligned block (`blk_lo`) and
  the number of blocks (`n_blk`), which fix each baseline's output
  rows (row p <-> absolute bin blk_lo G_blk + p) and R_max.
* The spread is plain XLA: per tile of T_s sources, each (baseline,
  source) pair adds its K Kaiser-Bessel taps times the carrier-phased
  spectral coefficients into the baseline's rows with an `.at[].add`
  scatter, and tiles are Kahan-folded.
* Post wraps rows mod n by a reshape-sum, FFTs, and applies the
  per-baseline integer bin offset as an EXACT host-computed FFT phase
  ramp (roll theorem) — no per-baseline roll/gather.

Exactness is constructional (every source's bin lies inside its
baseline's static block range); the `ok` flag only guards non-unit
source vectors, and the driver's nufft cross-check gate still
validates snapshot 0 against the direct engine.

Algorithm reference: gridding type-3 NUFFT (Dutt & Rokhlin 1993); the
reference implementation evaluates the dense phase matrix instead
(/root/reference/prisim/interferometry.py:6323-6376).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .nufft_delay import kb_fourier, kb_tap_coeffs

__all__ = ["make_banded_plan", "BandedPlan",
           "group_directions", "nufft_banded_visibilities",
           "simulate_snapshot_nufft_banded", "make_banded_snapshot_fns",
           "spatial_permutation", "reorder_sources"]

_PAD_U = 3.0          # outside any physical u (|s_eff · b̂| <= 2)
# largest (B, R_max, 2r) f32 row buffer a plan may ask for: the spread
# holds it three times (tile sum, running sum, Kahan compensation)
_ROW_BUFFER_BYTES = 4 << 30


# --------------------------------------------------------------------------
# host-side plan
# --------------------------------------------------------------------------

def spatial_permutation(s_eq, nside=512):
    """Host permutation ordering sources by HEALPix NEST index.

    Consecutive NEST indices tile compact sky patches, so a T_s-source
    tile spans a narrow u = s·b̂ range for EVERY baseline direction at
    once and its taps land in a few neighbouring rows. Source positions
    are static across snapshots, so this costs one argsort at plan
    time and nothing per snapshot. Visibilities are sums over sources:
    any order is exact.
    """
    from .. import healpix as hp
    s = np.asarray(s_eq, dtype=np.float64)
    r = np.linalg.norm(s, axis=1)
    theta = np.arccos(np.clip(s[:, 2] / r, -1.0, 1.0))
    phi = np.mod(np.arctan2(s[:, 1], s[:, 0]), 2.0 * np.pi)
    pix = hp.ang2pix(nside, theta, phi, nest=True)
    return np.argsort(pix, kind="stable")


def reorder_sources(sky, perm):
    """SkySources with every per-source array taken along axis 0."""
    import jax.numpy as jnp
    idx = jnp.asarray(np.asarray(perm, np.int32))
    rep = {"s_eq_hi": jnp.take(sky.s_eq_hi, idx, axis=0),
           "s_eq_lo": jnp.take(sky.s_eq_lo, idx, axis=0),
           "flux": jnp.take(sky.flux, idx, axis=0)}
    if sky.src_shape_sigma is not None:
        rep["src_shape_sigma"] = jnp.take(sky.src_shape_sigma, idx,
                                          axis=0)
    import dataclasses
    return dataclasses.replace(sky, **rep)


def group_directions(bl_vectors, decimals=9):
    """Group baselines by unit direction: (dirs (D, 3) f64, d_of_b (B,)
    int32). Opposite directions are distinct groups (φ = |b|·u keeps
    one sign convention per stream)."""
    bl = np.asarray(bl_vectors, dtype=np.float64)
    norm = np.linalg.norm(bl, axis=1)
    if np.any(norm == 0):
        raise ValueError("zero-length baseline")
    unit = bl / norm[:, None]
    key = np.round(unit, decimals)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    dirs = np.empty_like(uniq)
    for g in range(uniq.shape[0]):
        dirs[g] = unit[np.argmax(inv == g)]
    return dirs, inv.astype(np.int32)


@dataclass
class BandedPlan:
    """Static per-(layout, band, rank) data for the banded NUFFT."""
    nu0: float
    dnu: float
    nchan: int
    rank: int
    beta: float
    K: int
    alpha: float
    n: int                     # oversampled FFT length
    h: float                   # delay grid step (s)
    T_s: int                   # source tile
    G_blk: int                 # block granularity (rows, mult of 8)
    G_win: int                 # per-block window rows (G_blk + taps)
    n_blk_max: int             # max blocks over baselines
    R_max: int                 # output rows per baseline
    dirs_hi: np.ndarray        # (D, 3) f32 two-float direction split
    dirs_lo: np.ndarray
    d_of_b: np.ndarray         # (B,) int32
    blk_lo: np.ndarray         # (B,) int32 first block (bin/G_blk, signed)
    n_blk: np.ndarray          # (B,) int32 blocks to sweep
    blen_hi: np.ndarray        # (B,) f32 two-float |b|
    blen_lo: np.ndarray
    tap_w: np.ndarray          # (K, deg+1) f64 per-tap poly (polyval)
    deconv: np.ndarray         # (C,) f32 1/what(k/n)
    ramp: np.ndarray           # (B, C) c64 exact bin-offset phase ramp
    consts: dict = field(default_factory=dict)
    # redundancy collapse (round 4): the sweep runs over UNIQUE
    # canonical baseline vectors only; expand_idx/conj recover the full
    # set afterward (V(-b) = conj(V(b)) exactly — the amps are real).
    # None => identity (collapse=False or no redundancy found).
    expand_idx: np.ndarray = None   # (B_full,) int32 row of unique set
    conj: np.ndarray = None         # (B_full,) bool conjugate the row

    @property
    def nbl(self):
        return self.d_of_b.shape[0]

    @property
    def nbl_full(self):
        return (self.d_of_b.shape[0] if self.expand_idx is None
                else self.expand_idx.shape[0])

    @property
    def ndir(self):
        return self.dirs_hi.shape[0]


def _split(x):
    hi = np.float32(x)
    lo = np.float32(np.float64(x) - np.float64(hi))
    return hi, lo


def make_banded_plan(bl_vectors, nu0, dnu, nchan, rank, beta=2.0, K=9,
                     T_s=2048, G_blk=32, tap_degree=10,
                     collapse=True):
    """Build the static plan for a set of baseline vectors (meters) and
    a uniform frequency grid. Exact for arbitrary (3-D) baselines.

    ``collapse`` (default): sweep only UNIQUE canonical baseline
    vectors. Identical vectors give identical visibilities, and
    V(-b) = conj(V(b)) exactly (the beam x flux amps are real), so a
    sign-canonicalized dedup loses no accuracy — the engine's analog
    of the reference's redundancy compression (simulate unique
    baselines, duplicate_measurements, interferometry.py:1465,6823),
    applied transparently inside the engine. Rows are keyed at
    round(bl, 6): baselines within ~1 um share the first occurrence's
    exact f64 vector (sub-microradian phase difference — far below the
    f32 engine floor, and far tighter than the 0.01 m redundancy key
    `baselines.uniq_baselines` uses, so near-redundant rows surviving a
    redundant=False run are NOT merged). An all-pairs HERA-37 snapshot
    collapses 666 -> 63 spread rows (10.6x less spread work); a
    pre-uniqued set (the north-star 630) passes through unchanged.

    Raises ValueError when the (B, R_max, 2r) row buffer would exceed
    _ROW_BUFFER_BYTES (callers fall back to the sorted / direct
    engines)."""
    from .. import constants as CNST
    bl = np.asarray(bl_vectors, dtype=np.float64)
    if K % 2 == 0:
        raise ValueError("K must be odd (tap rows -half..+half)")
    expand_idx = conj_mask = None
    if collapse:
        key = np.round(bl, 6)                      # um-level identity
        neg = ((key[:, 0] < 0)
               | ((key[:, 0] == 0) & (key[:, 1] < 0))
               | ((key[:, 0] == 0) & (key[:, 1] == 0)
                  & (key[:, 2] < 0)))
        can = np.where(neg[:, None], -bl, bl)
        _, first, inv = np.unique(np.round(can, 6), axis=0,
                                  return_index=True,
                                  return_inverse=True)
        if first.shape[0] < bl.shape[0] or neg.any():
            expand_idx = inv.astype(np.int32)
            conj_mask = neg
            bl = can[first]                        # exact f64 rows
    alpha = np.pi * K * (1.0 - 0.5 / beta) - 0.01
    n = int(np.ceil(beta * nchan))
    h = 1.0 / (n * dnu)
    dirs, d_of_b = group_directions(bl)
    blen = np.linalg.norm(bl, axis=1)
    inv_ch = 1.0 / (CNST.c * h)
    if G_blk % 8:
        raise ValueError("G_blk must be a multiple of 8")
    half = K // 2
    G_win = int(-(-(G_blk + K - 1) // 8) * 8)
    # static per-baseline occupied range: bins in ±(phimax + 1)
    phimax = blen * 2.0 * inv_ch
    blk_lo = np.floor((-phimax - half - 2.0) / G_blk).astype(np.int32)
    hi_own = phimax + 2.0 - half          # max first-tap (ownership) row
    n_blk = (np.floor(hi_own / G_blk).astype(np.int64)
             - blk_lo.astype(np.int64) + 1).astype(np.int32)
    n_blk_max = int(n_blk.max())
    R_max = n_blk_max * G_blk + (G_win - G_blk)
    R_max = int(-(-R_max // 8) * 8)
    if bl.shape[0] * R_max * 2 * rank * 4 > _ROW_BUFFER_BYTES:
        raise ValueError(
            "banded plan: row buffer (%d x %d x %d) exceeds %d bytes;"
            " longest baseline %.0f m spans too many delay bins at"
            " nchan=%d" % (bl.shape[0], R_max, 2 * rank,
                           _ROW_BUFFER_BYTES, blen.max(), nchan))
    k = np.arange(nchan) - nchan // 2
    deconv = (1.0 / kb_fourier(k / n, K, alpha)).astype(np.float32)
    dh, dl = zip(*[_split(v) for v in dirs.ravel()])
    dirs_hi = np.asarray(dh, np.float32).reshape(dirs.shape)
    dirs_lo = np.asarray(dl, np.float32).reshape(dirs.shape)
    bh, blo = zip(*[_split(v) for v in blen])
    numid = nu0 + (nchan // 2) * dnu
    # exact roll-theorem ramp for the per-baseline bin offset
    # off_b = blk_lo_b * G_blk: row p holds bin off_b + p, and
    # FFT(grid)[k] = FFT(rows)[k] * e^{-2πi k off_b / n} at the kept
    # FFT indices k (f64 host trig on exact integer args)
    k_idx = np.concatenate([np.arange(n - nchan // 2, n),
                            np.arange(0, nchan - nchan // 2)])
    off = (blk_lo.astype(np.int64) * G_blk) % n
    m = (k_idx[None, :] * off[:, None]) % n
    ang = 2.0 * np.pi * m / n
    ramp = (np.cos(ang) - 1j * np.sin(ang)).astype(np.complex64)
    return BandedPlan(
        nu0=float(nu0), dnu=float(dnu), nchan=int(nchan), rank=int(rank),
        beta=float(beta), K=int(K), alpha=float(alpha), n=n, h=h,
        T_s=int(T_s), G_blk=int(G_blk), G_win=G_win,
        n_blk_max=n_blk_max, R_max=R_max,
        dirs_hi=dirs_hi, dirs_lo=dirs_lo, d_of_b=d_of_b,
        blk_lo=blk_lo, n_blk=n_blk,
        blen_hi=np.asarray(bh, np.float32),
        blen_lo=np.asarray(blo, np.float32),
        tap_w=kb_tap_coeffs(K, alpha, degree=tap_degree),
        deconv=deconv, ramp=ramp,
        consts=dict(inv_ch=inv_ch, numid_c=numid / CNST.c),
        expand_idx=expand_idx, conj=conj_mask)


# --------------------------------------------------------------------------
# spread (plain XLA)
# --------------------------------------------------------------------------

def _spread_tile(plan, uh, ul, P):
    """Grid rows of one source tile: (B, R_max, 2r) f32, row p of
    baseline b holding bin blk_lo_b * G_blk + p; columns [re | im] of
    the carrier-phased spectral coefficients. uh/ul: (D, T) two-float u;
    P: (T, r). Pads and out-of-range sources park at row R_max, which
    the scatter drops."""
    import jax.numpy as jnp
    from .. import twofloat as tf

    d_of_b = jnp.asarray(plan.d_of_b)
    uh_b = jnp.take(uh, d_of_b, axis=0)                       # (B, T)
    ul_b = jnp.take(ul, d_of_b, axis=0)
    blh = jnp.asarray(plan.blen_hi)[:, None]
    bll = jnp.asarray(plan.blen_lo)[:, None]
    ivh, ivl = _split(plan.consts["inv_ch"])
    nmh, nml = _split(plan.consts["numid_c"])
    # t = |b| u; phi = t/(c h) the signed grid bin; carrier (nu_mid/c) t
    th, tl = tf.df_mul(blh, bll, uh_b, ul_b)
    ph_h, ph_l = tf.df_mul(th, tl, ivh, ivl)
    fh, fl = tf.df_frac(*tf.df_mul(th, tl, nmh, nml), xp=jnp)
    cosv, sinv = tf.df_sincos_cycles(fh, fl, xp=jnp)
    m0 = jnp.round(ph_h)
    z0 = (ph_h - m0) + ph_l                                   # [-1/2, 1/2]
    half = plan.K // 2
    base0 = (jnp.asarray(plan.blk_lo) * plan.G_blk)[:, None]
    row0 = m0.astype(jnp.int32) - half - base0
    valid = (uh_b < np.float32(2.5)) & (row0 >= 0) \
        & (row0 <= plan.R_max - plan.K)
    row0 = jnp.where(valid, row0, plan.R_max)
    # tap weights w_j(z0): host-fit Horner polynomials (kb_tap_coeffs)
    ws = []
    for co in np.asarray(plan.tap_w, np.float64):
        w = jnp.full_like(z0, np.float32(co[0]))
        for c in co[1:]:
            w = w * z0 + np.float32(c)
        ws.append(w)
    w = jnp.stack(ws, axis=-1)                              # (B, T, K)
    B = row0.shape[0]
    V = jnp.concatenate([P[None] * cosv[..., None],
                         P[None] * (-sinv)[..., None]], axis=-1)
    # each source's K taps land in rows row0 .. row0 + K - 1
    rows = row0[..., None] + jnp.arange(plan.K, dtype=jnp.int32)
    bidx = jnp.broadcast_to(jnp.arange(B)[:, None, None], rows.shape)
    upd = w[..., None] * V[:, :, None, :]                   # (B, T, K, 2r)
    return jnp.zeros((B, plan.R_max, V.shape[-1]), jnp.float32) \
        .at[bidx, rows].add(upd, mode="drop")


def _banded_spread(plan, uh, ul, P):
    """Spread every source onto its baseline's delay rows: (B, R_max,
    2r) f32. uh/ul: (D, S_pad) two-float u; P: (S_pad, r), S_pad a
    multiple of plan.T_s. Tiles of T_s sources are summed plainly and
    Kahan-folded across tiles: a short baseline's row collects most of
    the sky, and the plain f32 carry's random walk across tiles would
    otherwise reach the 1e-6 budget at 10^5-10^6 sources."""
    import jax
    import jax.numpy as jnp

    T_s = plan.T_s
    n_tiles = P.shape[0] // T_s
    zero = jnp.zeros((plan.nbl, plan.R_max, 2 * plan.rank), jnp.float32)

    def body(carry, j):
        tot, comp = carry
        s0 = j * T_s
        o = _spread_tile(
            plan, jax.lax.dynamic_slice_in_dim(uh, s0, T_s, 1),
            jax.lax.dynamic_slice_in_dim(ul, s0, T_s, 1),
            jax.lax.dynamic_slice_in_dim(P, s0, T_s, 0))
        y = o - comp
        t = tot + y
        return (t, (t - tot) - y), None

    (tot, _), _ = jax.lax.scan(body, (zero, zero), jnp.arange(n_tiles))
    return tot


# --------------------------------------------------------------------------
# XLA prep / post
# --------------------------------------------------------------------------

def _two_float_u(seh, sel, dirs_hi, dirs_lo):
    """u = s_eff · b̂_d in two-float: (D, S) pair."""
    from .. import twofloat as tf
    th = tl = None
    for ax in range(3):
        ph, plo = tf.df_mul(dirs_hi[:, ax:ax + 1], dirs_lo[:, ax:ax + 1],
                            seh[None, :, ax], sel[None, :, ax])
        th, tl = (ph, plo) if th is None else tf.df_add(th, tl, ph, plo)
    return th, tl


def _prep(plan, seh, sel, P):
    """Elementwise u per direction and the T_s-padded spectral payload.

    Returns (u_h (D, S_pad), u_l (D, S_pad), P (S_pad, r), ok).
    ok guards non-unit source vectors (|u| must stay ≤ 2 for the static
    block range to cover every bin)."""
    import jax.numpy as jnp
    S = seh.shape[0]
    T_s = plan.T_s
    S_pad = -(-S // T_s) * T_s
    r = plan.rank

    uh, ul = _two_float_u(seh, sel, jnp.asarray(plan.dirs_hi),
                          jnp.asarray(plan.dirs_lo))          # (D, S)
    ok = jnp.max(jnp.abs(uh)) <= np.float32(2.0 + 1e-4)
    if S_pad != S:
        pad = ((0, 0), (0, S_pad - S))
        uh = jnp.pad(uh, pad, constant_values=np.float32(_PAD_U))
        ul = jnp.pad(ul, pad)
        P = jnp.pad(P, ((0, S_pad - S), (0, 0)))
    return uh, ul, jnp.asarray(P, jnp.float32), ok


def _payload_pad(plan, P):
    """T_s-pad a SECOND spectral payload to ride the u streams `_prep`
    built for the first one (truth mode's lo payload). Must pad
    identically — `_banded_spread` derives S_pad from the payload
    shape, and an unpadded payload silently swept zero tiles."""
    import jax.numpy as jnp
    S = P.shape[0]
    S_pad = -(-S // plan.T_s) * plan.T_s
    if S_pad != S:
        P = jnp.pad(P, ((0, S_pad - S), (0, 0)))
    return jnp.asarray(P, jnp.float32)


def _post(plan, out, Qc):
    """Wrap rows mod n (reshape-sum) + exact ramp for the per-baseline
    bin offset + FFT + deconvolve + rank combine.
    out: (B, R_max, 2r); Qc: (C, r). Returns (B, C) complex64."""
    import jax as _jax
    import jax.numpy as jnp
    B = out.shape[0]
    r = plan.rank
    n = plan.n
    R = plan.R_max
    m = -(-R // n)
    gu = jnp.pad(out, ((0, 0), (0, m * n - R), (0, 0)))
    gw = gu.reshape(B, m, n, 2 * r).sum(axis=1)               # (B, n, 2r)
    grid_c = gw[..., :r] + 1j * gw[..., r:]                   # (B, n, r)
    Gf = jnp.fft.fft(grid_c, axis=1)
    C = plan.nchan
    half = C // 2
    Gk = jnp.concatenate([Gf[:, n - half:, :], Gf[:, :C - half, :]],
                         axis=1)                              # (B, C, r)
    # deconvolution folded into the basis (one (C, r) host-size
    # multiply) and the per-baseline ramp applied AFTER the rank
    # combine on (B, C): the previous order paid two full (B, C, r)
    # elementwise passes (round-4 prep/post shave)
    Qd = jnp.asarray(Qc, jnp.float32) \
        * jnp.asarray(plan.deconv)[:, None]                   # (C, r)
    V = jnp.einsum("bcr,cr->bc", Gk, Qd,
                   precision=_jax.lax.Precision.HIGHEST)
    V = V * jnp.asarray(plan.ramp)
    if plan.expand_idx is not None:
        # redundancy expansion: gather unique rows onto the full
        # baseline list, conjugating sign-flipped vectors (exact)
        V = V[jnp.asarray(plan.expand_idx)]
        if plan.conj is not None and bool(np.any(plan.conj)):
            V = jnp.where(jnp.asarray(plan.conj)[:, None],
                          jnp.conj(V), V)
    return V


def nufft_banded_visibilities(plan, seh, sel, P, Qc):
    """Full banded NUFFT evaluation.

    seh/sel : (S, 3) two-float phase-centered source vectors (s - pc)
    P       : (S, r) spectral coefficients (amps @ pinvQ)
    Qc      : (C, r) spectral basis
    Returns ((B, C) complex64, ok bool scalar). ok False => a source
    vector was not unit (its bins could fall outside the static block
    range): fall back."""
    u_h, u_l, P_r, ok = _prep(plan, seh, sel, P)
    out = _banded_spread(plan, u_h, u_l, P_r)
    return _post(plan, out, Qc), ok


def simulate_snapshot_nufft_banded(instrument, sky, Mh, Ml, pch, pcl,
                                   beam_fn, plan, pinvQ, Q):
    """Observe-level entry mirroring simulate_snapshot_nufft_jit
    (nufft_delay.py) on the banded spread. Returns ((B, C) c64, ok)."""
    import jax
    import jax.numpy as jnp
    from .. import twofloat as tf
    from .observe import df_rotate3, _beam_and_flux

    sh, sl = df_rotate3(Mh, Ml, sky.s_eq_hi, sky.s_eq_lo)
    seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
    freqs_f32 = jnp.asarray(instrument.freqs, dtype=jnp.float32)
    amps = _beam_and_flux(sh, sky.flux, freqs_f32, beam_fn, pc=pch)
    from .nufft_delay import spectral_project
    P = spectral_project(amps, pinvQ)                         # (S, r)
    return nufft_banded_visibilities(plan, seh, sel, P, Q)


def make_coeff_fn(freqs, rank, pinvQ, beam_fn, node_model=True):
    """coeffs(sh, fx, pch) -> (S, rank) spectral coefficients of the
    beam-weighted fluxes, in either spectral form (round-4 node model
    or the round-3 full-channel projection) — shared by the
    single-device banded stages and the 'bl'-mesh sharded path so both
    compute identical models. The returned function carries the
    NodeModel (or None) as ``coeffs.node_model``."""
    import jax
    import jax.numpy as jnp
    from .nufft_delay import spectral_project, chebyshev_node_model
    from .observe import _beam_and_flux

    freqs_f32 = jnp.asarray(freqs, dtype=jnp.float32)
    pinvQ_j = jnp.asarray(pinvQ)
    if not node_model:
        def coeffs(sh, fx, pch):
            amps = _beam_and_flux(sh, fx, freqs_f32, beam_fn, pc=pch)
            return spectral_project(amps, pinvQ_j)

        coeffs.node_model = None
        return coeffs

    nm = chebyshev_node_model(freqs, rank)
    nodes_f32 = jnp.asarray(nm.nu_nodes, jnp.float32)
    n2c_j = jnp.asarray(nm.node2coef)                      # (r, r)
    V_j = jnp.asarray(nm.V)                                # (r, r)
    hi = jax.lax.Precision.HIGHEST

    def coeffs(sh, fx, pch):
        fluxC = spectral_project(fx, pinvQ_j)              # (S, r)
        fluxn = jnp.einsum("sr,nr->sn", fluxC, V_j,
                           precision=hi)                   # node values
        ampsn = _beam_and_flux(sh, fluxn, nodes_f32, beam_fn, pc=pch)
        return jnp.einsum("sn,nr->sr", ampsn, n2c_j, precision=hi)

    coeffs.node_model = nm
    return coeffs


def _df_matmul_rows(ah, al, M64):
    """Two-float (S, k) @ f64 (k, n) -> (S, n) two-float.

    M64 rides as exactly-split f32 pairs; the contraction runs as a
    lax.scan over k with per-step df arithmetic (an unrolled two-float
    chain of this size sends the XLA optimizer super-linear — see
    beams/analytic._df_clenshaw)."""
    import jax
    import jax.numpy as jnp
    from .. import twofloat as tf
    M64 = np.asarray(M64, np.float64)
    Mh = M64.astype(np.float32)
    Ml = (M64 - Mh.astype(np.float64)).astype(np.float32)
    z = jnp.zeros(ah.shape[:-1] + (M64.shape[1],), jnp.float32)

    def step(carry, inp):
        oh, ol = carry
        avh, avl, rh, rl = inp
        th, tl = tf.df_mul(avh[:, None], avl[:, None],
                           rh[None, :], rl[None, :])
        return tf.df_add(oh, ol, th, tl), None

    (oh, ol), _ = jax.lax.scan(
        step, (z, z),
        (jnp.transpose(ah), jnp.transpose(al),
         jnp.asarray(Mh), jnp.asarray(Ml)))
    return oh, ol


def make_coeff_fn_truth(freqs, rank, beam_df_fn):
    """Two-float node-model coefficients — the round-5 truth-amps path.

    The f32 amps chain floors EVERY engine's error vs the f64 model
    truth at ~3.5e-6 of scale at north-star source counts: per-element
    ~1e-7 evaluation/storage rounding, summed incoherently over ~4e5
    sources (benchmarks/accuracy_northstar.py --golden f64amps,
    round 5). The reference never sees this because its beam x flux
    is f64 numpy (primary_beams.py:517, run_prisim.py catalog fluxes).
    Here the whole node-amps chain is two-float32:

      beam at the r Chebyshev nodes : beam_df_fn (e.g.
                                      beams.analytic.airy_beam_df,
                                      ~1e-9 vs the f64 model)
      flux at the nodes             : HOST f64 (they are
                                      time-independent), split hi/lo
                                      and passed per call
      values -> coefficients        : two-float scan matmul with the
                                      exactly-split f64 node2coef

    Returns coeffs_df(sh, sl, fnh, fnl) -> ((S, r) hi, (S, r) lo)
    Chebyshev coefficient pairs; the caller runs the banded spread
    twice (hi + lo payloads) and sums after the linear post stage.
    Carries the NodeModel as .node_model."""
    from .. import twofloat as tf
    from .nufft_delay import chebyshev_node_model

    nm = chebyshev_node_model(freqs, rank)

    def coeffs_df(sh, sl, fnh, fnl):
        bh, bl = beam_df_fn(sh, sl, nm.nu_nodes)
        ah, al = tf.df_mul(bh, bl, fnh, fnl)
        return _df_matmul_rows(ah, al, nm.node2coef64)

    coeffs_df.node_model = nm
    return coeffs_df


def make_banded_snapshot_fns(instrument, sky, beam_fn, plan, pinvQ, Q,
                             spatial_sort=True,
                             src_chunk=None, gate_src_block=512,
                             node_model=True, truth=None):
    """Three separately-jitted stages for one banded snapshot.

    ``node_model`` (round 4, default): evaluate beam x flux at the
    rank Chebyshev NODES of the band and take the interpolant's
    coefficients directly (nufft_delay.chebyshev_node_model) instead
    of projecting a full (S, C) f32 amps table. The projection form's
    residual is floored at 1.2-1.8e-6 of scale at north-star source
    counts by f32 channel-jitter in the amps themselves (probe_truth,
    round 4); the node form has zero fit residual vs its model, whose
    own error vs the exact f64 beam is the smooth rank-r Chebyshev
    convergence. It also skips the full-channel beam evaluation and
    the (S, C) materialization: prep does S*r transcendentals instead
    of S*C. The flux table rides through its rank-r coefficients
    (power-law/smooth spectra fit to ~1e-9; arbitrary tabulated
    spectra are exactly what the driver's cross-check gate demotes).

    The stages (run.stages) time prep, spread and post separately;
    run() is the fused one-dispatch program.

    ``spatial_sort`` reorders the sources ONCE by HEALPix NEST index
    (spatial_permutation): exact in any order. Sky arrays ride as jit
    ARGUMENTS — closed-over device arrays would become executable
    constants, embedding the (S, C) flux table in the compiled
    program.

    Returns run(Mh, Ml, pch, pcl) -> ((B, C) complex64, ok) where every
    intermediate stays on device.
    """
    import jax
    import jax.numpy as jnp
    from .. import twofloat as tf
    from .nufft_delay import spectral_project
    from .observe import df_rotate3, _beam_and_flux

    if spatial_sort:
        perm = spatial_permutation(
            np.asarray(sky.s_eq_hi, np.float64)
            + np.asarray(sky.s_eq_lo, np.float64))
        sky = reorder_sources(sky, perm)

    freqs_f32 = jnp.asarray(instrument.freqs, dtype=jnp.float32)
    pinvQ_j = jnp.asarray(pinvQ)
    Q_j = jnp.asarray(Q, jnp.float32)

    _coeffs = make_coeff_fn(instrument.freqs, plan.rank, pinvQ,
                            beam_fn, node_model=node_model)
    nm = _coeffs.node_model
    _coeffs_df = None
    if truth is not None:
        # round-5 truth-amps path: two-float coefficient payloads,
        # dual spread. truth = {"beam_df": fn(sh, sl, freqs_f64) ->
        # (hi, lo), "flux_nodes": (S, r) HOST f64 in ORIGINAL source
        # order} — permuted/padded here alongside the sky arrays.
        _coeffs_df = make_coeff_fn_truth(instrument.freqs, plan.rank,
                                         truth["beam_df"])
        fluxn64 = np.asarray(truth["flux_nodes"], np.float64)
        if spatial_sort:
            fluxn64 = fluxn64[perm]

    # Source chunking: prep materializes a (2 x D_dirs x S_chunk) f32
    # two-float u plus several temps of the same shape — at HERA-331's
    # direction count x nside-256 the unchunked arrays alone exceed
    # device memory (ResourceExhausted on the FIRST snapshot).
    # Bound the u pair at ~0.75 GB and scan chunks inside ONE jit
    # (single dispatch; XLA frees each chunk's temps before the next).
    S = int(sky.s_eq_hi.shape[0])
    if src_chunk is None:
        per_src = max(1, plan.ndir) * 8
        cap = int((768 << 20) / per_src / plan.T_s) * plan.T_s
        src_chunk = min(-(-S // plan.T_s) * plan.T_s,
                        max(plan.T_s, cap))
    src_chunk = int(src_chunk)
    n_chunks = -(-S // src_chunk)
    S_pad = n_chunks * src_chunk
    seqh_a = jnp.asarray(sky.s_eq_hi)
    seql_a = jnp.asarray(sky.s_eq_lo)
    flux_a = jnp.asarray(sky.flux)
    if S_pad != S:
        # pad with zenith-direction unit rows (|s|=1 keeps the span
        # check true) at zero flux
        padrow = jnp.zeros((S_pad - S, 3), jnp.float32).at[:, 2].set(1.0)
        seqh_a = jnp.concatenate([seqh_a, padrow])
        seql_a = jnp.concatenate(
            [seql_a, jnp.zeros((S_pad - S, 3), jnp.float32)])
        flux_a = jnp.concatenate(
            [flux_a, jnp.zeros((S_pad - S, flux_a.shape[1]),
                               flux_a.dtype)])
    fnh_a = fnl_a = None
    if truth is not None:
        if S_pad != S:
            fluxn64 = np.concatenate(
                [fluxn64, np.zeros((S_pad - S, fluxn64.shape[1]))])
        fnh_np, fnl_np = tf.split_f64(fluxn64)
        fnh_a = jnp.asarray(fnh_np)
        fnl_a = jnp.asarray(fnl_np)

    def _payloads(sh, sl, fx_c, pch, fnh_c, fnl_c):
        """Chunk spectral payloads: one P in the f32 forms, (P_hi,
        P_lo) two-float pair in truth mode."""
        if truth is not None:
            return _coeffs_df(sh, sl, fnh_c, fnl_c)
        return (_coeffs(sh, fx_c, pch),)

    n_pay = 2 if truth is not None else 1

    def _chunk_sweep(Mh, Ml, pch, pcl, seqh, seql, flux, fnh, fnl):
        def chunk(carry, c):
            tots, comps, okc = carry
            s0 = c * src_chunk
            sh_c = jax.lax.dynamic_slice_in_dim(seqh, s0, src_chunk)
            sl_c = jax.lax.dynamic_slice_in_dim(seql, s0, src_chunk)
            fx_c = jax.lax.dynamic_slice_in_dim(flux, s0, src_chunk)
            fnh_c = fnl_c = None
            if truth is not None:
                fnh_c = jax.lax.dynamic_slice_in_dim(fnh, s0,
                                                     src_chunk)
                fnl_c = jax.lax.dynamic_slice_in_dim(fnl, s0,
                                                     src_chunk)
            sh, sl = df_rotate3(Mh, Ml, sh_c, sl_c)
            seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
            Ps = _payloads(sh, sl, fx_c, pch, fnh_c, fnl_c)
            u_h, u_l, P_r, ok = _prep(plan, seh, sel, Ps[0])
            outs = [_banded_spread(plan, u_h, u_l, P_r)]
            for P2 in Ps[1:]:
                P2_r = _payload_pad(plan, P2)
                outs.append(_banded_spread(plan, u_h, u_l, P2_r))
            # Kahan across chunks: the grid bins on short baselines
            # hold near-coherent partial sums ~S/nbins in magnitude,
            # and plain f32 `t + o` re-rounds the FULL bin value once
            # per chunk — a cross-chunk random walk that the post's
            # band-edge deconvolution amplifies past the 2e-6 gate.
            new_t, new_c = [], []
            for t, cm, o in zip(tots, comps, outs):
                y = o - cm
                s = t + y
                new_t.append(s)
                new_c.append((s - t) - y)
            return (tuple(new_t), tuple(new_c),
                    jnp.logical_and(okc, ok)), None

        zero = jnp.zeros((plan.nbl, plan.R_max, 2 * plan.rank),
                         jnp.float32)
        init = ((zero,) * n_pay, (zero,) * n_pay, jnp.bool_(True))
        (tots, _, ok), _ = jax.lax.scan(chunk, init,
                                        jnp.arange(n_chunks))
        return tots, ok

    @jax.jit
    def stage_prep(Mh, Ml, pch, pcl, s_eq_hi, s_eq_lo, flux):
        sh, sl = df_rotate3(Mh, Ml, s_eq_hi, s_eq_lo)
        seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
        P = _coeffs(sh, flux, pch)
        return _prep(plan, seh, sel, P)

    @jax.jit
    def stage_spread(u_h, u_l, P_r):
        return _banded_spread(plan, u_h, u_l, P_r)

    @jax.jit
    def stage_post(out):
        return _post(plan, out, Q_j)

    # ONE fused jit program per snapshot: prep -> spread -> post in a
    # single dispatch, so XLA schedules the post's reshape/FFT right
    # after the spread.
    if n_chunks == 1:
        @jax.jit
        def _fused(Mh, Ml, pch, pcl, seqh, seql, flux, fnh, fnl):
            sh, sl = df_rotate3(Mh, Ml, seqh, seql)
            seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
            Ps = _payloads(sh, sl, flux, pch, fnh, fnl)
            u_h, u_l, P_r, ok = _prep(plan, seh, sel, Ps[0])
            v = _post(plan, _banded_spread(plan, u_h, u_l, P_r), Q_j)
            for P2 in Ps[1:]:
                # truth mode: the lo payload rides the same u streams;
                # _post is linear, and the correction (~60 ulp of the
                # hi visibilities) adds cleanly in complex64
                P2_r = _payload_pad(plan, P2)
                v = v + _post(plan, _banded_spread(plan, u_h, u_l, P2_r), Q_j)
            return v, ok

        def run(Mh, Ml, pch, pcl):
            return _fused(Mh, Ml, pch, pcl, seqh_a, seql_a, flux_a,
                          fnh_a, fnl_a)

        run.stages = (stage_prep, stage_spread, stage_post)
        run.program = _fused
    else:
        @jax.jit
        def _fused_chunked(Mh, Ml, pch, pcl, seqh, seql, flux, fnh,
                           fnl):
            outs, ok = _chunk_sweep(Mh, Ml, pch, pcl, seqh, seql,
                                    flux, fnh, fnl)
            v = _post(plan, outs[0], Q_j)
            for o in outs[1:]:
                v = v + _post(plan, o, Q_j)
            return v, ok

        sweep_jit = jax.jit(_chunk_sweep)

        def run(Mh, Ml, pch, pcl):
            return _fused_chunked(Mh, Ml, pch, pcl, seqh_a, seql_a,
                                  flux_a, fnh_a, fnl_a)

        run.stages = (sweep_jit, stage_post)
        run.program = _fused_chunked
    def _gate_impl(Mh, Ml, pch, pcl, seqh, seql, flux, fnh, fnl):
        """Shared-program cross-check: ONE jit program computes the
        source vectors once per chunk and feeds BOTH the exact direct
        NUDFT and the banded pipeline. Under the f32 node model the
        direct reference consumes the TRUE full-channel beam x flux
        amps while the banded side consumes the rank-r node
        interpolant, so the gate measures transform error AND model
        inadequacy (a rank too low for the band trips it —
        tests/test_round4.py demotion test). The comparison's floor is
        the per-element f32 beam-evaluation difference between the two
        paths summed over sources; with the Chebyshev J1
        (beams/analytic.py) that noise is ~1ulp incoherent rounding,
        not the old A&S cancellation jitter, so the 2e-6 default holds
        at north-star source counts (probe_truth round 4).

        In TRUTH mode the banded engine is more accurate than an f32
        direct reference (that's the point), so the direct side
        consumes the same two-float model amps, the transform
        comparison stays at the 2e-6 class, and model adequacy is
        gated separately via the amps-space residual (`resid` return;
        driver tol 1e-4 — rank-4-on-an-octave measures ~1e-1, the
        healthy floor is ~5e-7).

        Comparing engines that re-evaluate the beam in separate jit
        programs carries a ~1e-7 per-element cross-program beam
        difference that sums coherently over north-star source counts
        into a ~3e-5 floor —
        two orders looser than the 1e-6 spec the gate should enforce.
        Returns (direct re, direct im, banded re, banded im, ok,
        resid, coherent_scale) where coherent_scale is
        max_c Σ_s |A_sc| — the denominator the driver's tolerance is
        calibrated against (see the return-site comment below)."""
        from .nudft import nudft_visibilities
        gs = instrument.grid_scalars()
        nchan = instrument.nchan
        nbl = plan.nbl_full        # direct side runs the FULL bl set

        def chunk(carry, c):
            (tots, tcomps, okc, vd, comp, vdl, rmax, amax,
             csum) = carry
            s0 = c * src_chunk
            sh_c = jax.lax.dynamic_slice_in_dim(seqh, s0, src_chunk)
            sl_c = jax.lax.dynamic_slice_in_dim(seql, s0, src_chunk)
            fx_c = jax.lax.dynamic_slice_in_dim(flux, s0, src_chunk)
            fnh_c = fnl_c = None
            if truth is not None:
                fnh_c = jax.lax.dynamic_slice_in_dim(fnh, s0,
                                                     src_chunk)
                fnl_c = jax.lax.dynamic_slice_in_dim(fnl, s0,
                                                     src_chunk)
            sh, sl = df_rotate3(Mh, Ml, sh_c, sl_c)
            seh, sel = tf.df_add(sh, sl, -pch[None, :], -pcl[None, :])
            Ps = _payloads(sh, sl, fx_c, pch, fnh_c, fnl_c)
            amps = _beam_and_flux(sh, fx_c, freqs_f32, beam_fn,
                                  pc=pch)
            u_h, u_l, P_r, ok = _prep(plan, seh, sel, Ps[0])
            outs = [_banded_spread(plan, u_h, u_l, P_r)]
            for P2 in Ps[1:]:
                P2_r = _payload_pad(plan, P2)
                outs.append(_banded_spread(plan, u_h, u_l, P2_r))
            if truth is None:
                vc = nudft_visibilities(seh, sel, instrument.bl_hi,
                                        instrument.bl_lo, amps, gs,
                                        nchan,
                                        src_block=gate_src_block)
                vlo = jnp.zeros_like(vd)
                rm = ra = jnp.float32(0.0)
                cs = jnp.sum(jnp.abs(amps), axis=0)       # (C,)
            else:
                # truth mode: the direct reference consumes THE SAME
                # two-float rank-r model amps the banded side spreads
                # (expanded to channels in two-float; a single-f32
                # direct side would re-introduce its own ~3.5e-6
                # amps-rounding floor and trip the gate against a
                # MORE accurate engine). Model adequacy is gated
                # separately in amps space below.
                amh, aml = _df_matmul_rows(
                    Ps[0], Ps[1], _coeffs_df.node_model.Q64.T)
                vc = nudft_visibilities(seh, sel, instrument.bl_hi,
                                        instrument.bl_lo, amh, gs,
                                        nchan,
                                        src_block=gate_src_block)
                vlo = nudft_visibilities(seh, sel, instrument.bl_hi,
                                         instrument.bl_lo, aml, gs,
                                         nchan,
                                         src_block=gate_src_block)
                # rank-r model residual vs the true full-channel f32
                # amps: catches a rank too low for the band (or a
                # non-smooth tabulated spectrum) that the shared-model
                # transform comparison can no longer see
                rm = jnp.max(jnp.abs((amh - amps) + aml))
                ra = jnp.max(jnp.abs(amps))
                cs = jnp.sum(jnp.abs(amh), axis=0)        # (C,)
            # Kahan across chunks on BOTH sides: the direct vis
            # accumulator and the banded grid accumulators (the grid's
            # short-baseline bins re-round their full near-coherent
            # value on every plain add — the 1e-5-class cross-chunk
            # walk that spuriously tripped this gate at north-star
            # chunk counts, round 5)
            y = vc - comp
            t = vd + y
            new_t, new_c = [], []
            for tt, cm, o in zip(tots, tcomps, outs):
                yb = o - cm
                sb = tt + yb
                new_t.append(sb)
                new_c.append((sb - tt) - yb)
            return (tuple(new_t), tuple(new_c),
                    jnp.logical_and(okc, ok), t,
                    (t - vd) - y, vdl + vlo,
                    jnp.maximum(rmax, rm), jnp.maximum(amax, ra),
                    csum + cs), None

        # The banded accumulator runs over the COLLAPSED (unique
        # canonical) rows — _banded_spread returns plan.nbl rows and
        # _post re-expands to nbl_full; the direct-side vd/comp
        # accumulators run over the FULL set.
        zero = jnp.zeros((plan.nbl, plan.R_max, 2 * plan.rank),
                         jnp.float32)
        init = ((zero,) * n_pay, (zero,) * n_pay, jnp.bool_(True),
                jnp.zeros((nbl, nchan), jnp.complex64),
                jnp.zeros((nbl, nchan), jnp.complex64),
                jnp.zeros((nbl, nchan), jnp.complex64),
                jnp.float32(0.0), jnp.float32(0.0),
                jnp.zeros((nchan,), jnp.float32))
        (tots, _, ok, vd, _, vdl, rmax, amax, csum), _ = jax.lax.scan(
            chunk, init, jnp.arange(n_chunks))
        vd = vd + vdl
        vb = _post(plan, tots[0], Q_j)
        for o in tots[1:]:
            vb = vb + _post(plan, o, Q_j)
        resid = rmax / jnp.maximum(amax, jnp.float32(1e-30))
        # coherent flux scale: max over channels of Σ_s |A_sc| — the
        # largest visibility any baseline could see (attained as
        # baseline -> 0, and by aliased rows on under-resolved
        # pixelized skies). Every f32 source-summation engine's
        # ABSOLUTE error scales with this sum (per-element ~1ulp
        # rounding walks over it), while max|V| over the simulated
        # rows can cancel orders of magnitude below it — normalizing
        # the gate by max|V| would demand an f32-impossible bound on
        # cancelling skies (the same absolute error reads 100x apart
        # depending on the baseline set's |V| max).
        return (jnp.real(vd), jnp.imag(vd), jnp.real(vb),
                jnp.imag(vb), ok, resid, jnp.max(csum))

    gate_jit = jax.jit(_gate_impl)

    def gate(Mh, Ml, pch, pcl):
        dr, di, br, bi, ok, resid, csA = gate_jit(
            Mh, Ml, pch, pcl, seqh_a, seql_a, flux_a, fnh_a, fnl_a)
        direct0 = np.asarray(dr) + 1j * np.asarray(di)
        banded0 = np.asarray(br) + 1j * np.asarray(bi)
        return (direct0, banded0, bool(np.asarray(ok)),
                float(np.asarray(resid)), float(np.asarray(csA)))

    run.gate_fn = gate
    run.n_chunks = n_chunks
    run.src_chunk = src_chunk
    run.sky_args = (seqh_a, seql_a, flux_a)
    # run(*rot) == run.program(*rot, *run.program_args)
    run.program_args = (seqh_a, seql_a, flux_a, fnh_a, fnl_a)
    run.node_model = nm
    return run
