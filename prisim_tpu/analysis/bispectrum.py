"""Bispectrum (closure) phase pipeline: HERA-style closure-phase delay
power spectra.

Rebuild of /root/reference/prisim/bispectrum_phase.py (4884 LoC):
``write_PRISim_bispectrum_phase_to_npz`` (:40), ``loadnpz``/``npz2hdf5``
(:253,:360), ``class ClosurePhase`` (:1497 — expicp :1694,
smooth_in_tbins :1727, subtract :1978, subsample_differencing :2023) and
``class ClosurePhaseDelaySpectrum`` (:2274 — FT :2349,
compute_power_spectrum :2888) plus the incoherent averaging helpers
(:806, :1235).

Design: the reference's numpy masked arrays become explicit
(value, weight) pairs; the data layout is the HERA-standard
closure-phase cube ``cp`` of shape (nlst, ndays, ntriads, nchan) with
float weights ``wts`` (0 = flagged). All reductions are
weight-aware nansum/nanmean."""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np

from .. import constants as CNST
from .. import windows as win

# xcpdps_full switches to the lazy (factor-side) covariance collapse
# when the materialized cross-power block would exceed this many bytes
_LAZY_COLLAPSE_BYTES = 2.68e8
from .cosmology import (cosmo100, dkprll_deta, comoving_depth, freq_to_z,
                        jy2k)

__all__ = ["ClosurePhaseData", "closure_npz_from_vs", "load_closure_npz",
           "cpds_ft", "cross_power_spectrum", "kbin_average",
           "power_spectrum_uncertainty", "rescale_power_spectrum",
           "average_rescaled_power_spectrum"]


@dataclass
class ClosurePhaseData:
    """Closure phases cp (nlst, ndays, ntriads, nchan) + weights + axes."""
    cp: np.ndarray
    wts: np.ndarray
    freqs: np.ndarray              # (nchan,)
    lst: np.ndarray                # (nlst,) hours
    days: np.ndarray               # (ndays,) JD
    triads: np.ndarray             # (ntriads, 3) labels

    @property
    def eicp(self):
        """exp(i cp) with flagged samples zero-weighted
        (ClosurePhase.expicp, bispectrum_phase.py:1694)."""
        return np.exp(1j * self.cp)

    def smooth_in_tbins(self, lstbinsize=None, daybinsize=None,
                        stat="mean"):
        """Bin along LST (hours) and/or days; weighted mean or median of
        e^{i cp}; returns a new ClosurePhaseData on the binned grid
        (smooth_in_tbins, bispectrum_phase.py:1727-1977)."""
        eicp = self.eicp * self.wts
        wts = self.wts.copy()
        lst, days = self.lst, self.days
        if lstbinsize is not None:
            edges = np.arange(lst.min(), lst.max() + lstbinsize,
                              lstbinsize)
            which = np.clip(np.digitize(lst, edges) - 1, 0,
                            edges.size - 2)
            nb = edges.size - 1
            se = np.zeros((nb,) + eicp.shape[1:], dtype=complex)
            sw = np.zeros((nb,) + wts.shape[1:])
            if stat == "median":
                se_list = [[] for _ in range(nb)]
                for i, b in enumerate(which):
                    se_list[b].append(i)
                for b in range(nb):
                    if se_list[b]:
                        sel = np.asarray(se_list[b])
                        wsel = wts[sel]
                        med_r = _wmedian_axis0(self.eicp[sel].real, wsel)
                        med_i = _wmedian_axis0(self.eicp[sel].imag, wsel)
                        se[b] = med_r + 1j * med_i
                        sw[b] = wsel.sum(axis=0)
                se = se * sw
            else:
                np.add.at(se, which, eicp)
                np.add.at(sw, which, wts)
            lst = 0.5 * (edges[:-1] + edges[1:])
            eicp, wts = se, sw
        if daybinsize is not None:
            # contiguous JD binning along the day axis (the reference's
            # daybinsize branch, bispectrum_phase.py:1751-1855); for the
            # randomized equal-count split used in noise estimation see
            # subsample_differencing
            edges = np.arange(days.min(), days.max() + daybinsize,
                              daybinsize)
            if edges.size < 2:
                edges = np.asarray([days.min(), days.max() + 1.0])
            which = np.clip(np.digitize(days, edges) - 1, 0,
                            edges.size - 2)
            nb = edges.size - 1
            se = np.zeros(eicp.shape[:1] + (nb,) + eicp.shape[2:],
                          dtype=complex)
            sw = np.zeros(wts.shape[:1] + (nb,) + wts.shape[2:])
            if stat == "median":
                for b in range(nb):
                    sel = np.where(which == b)[0]
                    if sel.size:
                        wsel = np.moveaxis(wts[:, sel], 1, 0)
                        ei = np.moveaxis(
                            np.where(wts[:, sel] > 0, eicp[:, sel]
                                     / np.maximum(wts[:, sel], 1e-30),
                                     0.0), 1, 0)
                        med_r = _wmedian_axis0(ei.real, wsel)
                        med_i = _wmedian_axis0(ei.imag, wsel)
                        sw[:, b] = wsel.sum(axis=0)
                        se[:, b] = (med_r + 1j * med_i) * sw[:, b]
            else:
                np.add.at(se, (slice(None), which), eicp)
                np.add.at(sw, (slice(None), which), wts)
            days = 0.5 * (edges[:-1] + edges[1:])
            eicp, wts = se, sw
        with np.errstate(invalid="ignore", divide="ignore"):
            mean_eicp = np.where(wts > 0, eicp / np.maximum(wts, 1e-30),
                                 0.0)
        cp = np.angle(np.where(wts > 0, mean_eicp, 1.0))
        return ClosurePhaseData(cp=cp, wts=wts, freqs=self.freqs, lst=lst,
                                days=days, triads=self.triads)

    def tbin_stats(self, lstbinsize=None, daybinsize=None):
        """Per-bin noise statistics of the closure phase across the
        binned axis — the reference's 'rms'/'mad' outputs of
        smooth_in_tbins (bispectrum_phase.py:1789-1797 day axis,
        :1911-1928 LST axis; docstring :1727 names mean/median/rms/MAD).

        rms = masked std of cp within each bin along the binned axis;
        mad = masked median of |cp - angle(median e^{i cp} in bin)|
        along the binned axis. Exactly one of lstbinsize (hours) /
        daybinsize (days) must be given. Returns dict(rms, mad,
        centers) with the binned axis replaced by nbins."""
        if (lstbinsize is None) == (daybinsize is None):
            raise ValueError("give exactly one of lstbinsize/daybinsize")
        axis = 0 if lstbinsize is not None else 1
        coord = self.lst if axis == 0 else self.days
        size = lstbinsize if axis == 0 else daybinsize
        edges = np.arange(coord.min(), coord.max() + size, size)
        if edges.size < 2:
            edges = np.asarray([coord.min(), coord.max() + 1.0])
        which = np.clip(np.digitize(coord, edges) - 1, 0,
                        edges.size - 2)
        nb = edges.size - 1
        out_shape = (self.cp.shape[:axis] + (nb,)
                     + self.cp.shape[axis + 1:])
        rms = np.zeros(out_shape)
        mad = np.zeros(out_shape)
        for b in range(nb):
            sel = np.where(which == b)[0]
            if not sel.size:
                continue
            cpb = np.moveaxis(np.take(self.cp, sel, axis=axis), axis, 0)
            wb = np.moveaxis(np.take(self.wts, sel, axis=axis), axis, 0)
            mcp = np.ma.array(cpb, mask=(wb <= 0))
            idx = (slice(None),) * axis + (b,)
            rms[idx] = np.ma.std(mcp, axis=0).filled(0.0)
            eib = np.moveaxis(np.take(self.eicp, sel, axis=axis),
                              axis, 0)
            med = (_wmedian_axis0(eib.real, wb)
                   + 1j * _wmedian_axis0(eib.imag, wb))
            dev = np.ma.array(np.abs(cpb - np.angle(med)[None]),
                              mask=(wb <= 0))
            mad[idx] = np.ma.median(dev, axis=0).filled(0.0)
        return dict(rms=rms, mad=mad,
                    centers=0.5 * (edges[:-1] + edges[1:]))

    def subtract(self, model_cp):
        """Subtract a model closure phase (broadcastable to cp)
        (ClosurePhase.subtract, bispectrum_phase.py:1978)."""
        return replace(self, cp=self.cp - np.asarray(model_cp))

    def subsample_differencing(self, ndaybins=4, seed=0):
        """Split days into ndaybins bins; return per-bin mean eicp and the
        pairwise half-differences used for noise estimation
        (subsample_differencing, bispectrum_phase.py:2023-2252).

        Returns dict(eicp_mean (nbins, nlst, ntriads, nchan),
        eicp_diff (npairs, nlst, ntriads, nchan), wts_mean, pairs)."""
        ndays = self.days.size
        if ndaybins > ndays:
            raise ValueError("more day bins than days")
        rng = np.random.RandomState(seed)
        perm = rng.permutation(ndays)
        bins = np.array_split(perm, ndaybins)
        eicp_w = self.eicp * self.wts
        means, wmeans = [], []
        for b in bins:
            w = self.wts[:, b].sum(axis=1)
            e = eicp_w[:, b].sum(axis=1)
            with np.errstate(invalid="ignore", divide="ignore"):
                means.append(np.where(w > 0, e / np.maximum(w, 1e-30),
                                      0.0))
            wmeans.append(w)
        means = np.stack(means)                      # (nbins, nlst, ntri, nchan)
        wmeans = np.stack(wmeans)
        pairs = [(i, j) for i in range(ndaybins)
                 for j in range(i + 1, ndaybins)]
        diffs = np.stack([0.5 * (means[i] - means[j]) for i, j in pairs])
        return dict(eicp_mean=means, eicp_diff=diffs, wts_mean=wmeans,
                    pairs=np.asarray(pairs))

    # ---------------------------------------------------------------- IO
    def save_npz(self, path):
        """HERA-layout NPZ (loadnpz counterpart,
        bispectrum_phase.py:253-360)."""
        np.savez_compressed(
            path, closures=np.transpose(self.cp, (0, 1, 2, 3)),
            flags=(self.wts <= 0), frequency=self.freqs,
            last=np.broadcast_to(self.lst[:, None],
                                 (self.lst.size, self.days.size)),
            days=self.days,
            triads=np.asarray(self.triads, dtype="U"))

    def save_hdf5(self, path):
        """cpinfo-tree HDF5 (npz2hdf5 counterpart,
        bispectrum_phase.py:360-470)."""
        import h5py
        with h5py.File(path, "w") as f:
            raw = f.create_group("raw")
            raw["cphase"] = self.cp
            raw["flags"] = (self.wts <= 0)
            raw["wts"] = self.wts
            f["spectral_info/freqs"] = self.freqs
            f["timing/lst"] = self.lst
            f["timing/days"] = self.days
            f["triads"] = np.char.encode(
                np.asarray(self.triads, dtype=str))

    @classmethod
    def load_hdf5(cls, path):
        import h5py
        with h5py.File(path, "r") as f:
            return cls(cp=f["raw/cphase"][()], wts=f["raw/wts"][()],
                       freqs=f["spectral_info/freqs"][()],
                       lst=f["timing/lst"][()],
                       days=f["timing/days"][()],
                       triads=np.char.decode(f["triads"][()].astype("S")))


def _wmedian_axis0(vals, wts):
    """Weighted median along axis 0 (ties to lower); wts>0 mask."""
    masked = np.where(wts > 0, vals, np.nan)
    return np.nanmedian(masked, axis=0)


def closure_npz_from_vs(vs, path=None, ant_triplets=None, datatype="vis"):
    """Extract sim closure phases into the HERA NPZ layout
    (write_PRISim_bispectrum_phase_to_npz, bispectrum_phase.py:40-250):
    nlst = n_acc, ndays = 1."""
    from .closure import closure_phases_vs
    res = closure_phases_vs(vs, ant_triplets=ant_triplets)
    key = {"skyvis": "closure_phase_skyvis", "vis": "closure_phase_vis",
           "noise": "closure_phase_noise"}[datatype]
    if key not in res:
        key = "closure_phase_skyvis"
    # (ntri, nchan, nacc) -> (nlst=nacc, ndays=1, ntri, nchan)
    cp = np.transpose(res[key], (2, 0, 1))[:, None, :, :]
    cpd = ClosurePhaseData(
        cp=cp, wts=np.ones_like(cp), freqs=np.asarray(vs.freqs),
        lst=np.asarray(vs.lst) / 15.0,       # deg -> hours
        days=np.asarray([vs.timestamps[0] if vs.timestamps is not None
                         else 2451545.0]),
        triads=np.asarray(res["triads"], dtype=str))
    if path is not None:
        cpd.save_npz(path)
    return cpd


def load_closure_npz(path):
    """Load a HERA-layout closure NPZ (loadnpz,
    bispectrum_phase.py:253-360)."""
    with np.load(path) as d:
        cp = d["closures"]
        flags = d["flags"] if "flags" in d else np.zeros_like(cp,
                                                              dtype=bool)
        lst = d["last"]
        if lst.ndim == 2:
            lst = lst[:, 0]
        days = d["days"] if "days" in d else np.arange(cp.shape[1],
                                                       dtype=float)
        triads = d["triads"] if "triads" in d else np.zeros(
            (cp.shape[2], 3), dtype="U1")
        return ClosurePhaseData(cp=cp, wts=(~flags).astype(np.float64),
                                freqs=d["frequency"], lst=lst, days=days,
                                triads=triads)


def cpds_ft(eicp, wts, freqs, freq_center, bw_eff, shape="bhw",
            fftpow=1.0, pad=1.0):
    """Windowed subband delay transform of e^{i cp}
    (ClosurePhaseDelaySpectrum.FT, bispectrum_phase.py:2349-2787).

    eicp: (..., nchan) complex; returns dict(lags, freq_wts,
    dspec (nwin, ..., nlag) in 'Jy Hz'-like units of the scaled eicp)."""
    freqs = np.asarray(freqs, dtype=np.float64)
    nchan = freqs.size
    df = freqs[1] - freqs[0]
    freq_center = np.atleast_1d(np.asarray(freq_center, dtype=np.float64))
    bw_eff = np.broadcast_to(
        np.atleast_1d(np.asarray(bw_eff, dtype=np.float64)),
        freq_center.shape)
    freq_wts = np.stack([win.subband_window(freqs, fc, bw, shape=shape,
                                            fftpow=fftpow, xp=np)
                         for fc, bw in zip(freq_center, bw_eff)])
    npad = int(nchan * pad)
    lags = win.spectral_axis(nchan + npad, delx=df, shift=True, xp=np)
    x = (np.asarray(eicp) * np.asarray(wts))[..., None, :] \
        * freq_wts                                   # (..., nwin, nchan)
    xp_ = np.pad(x, [(0, 0)] * (x.ndim - 1) + [(0, npad)])
    dspec = np.fft.fftshift(np.fft.ifft(xp_, axis=-1), axes=-1) \
        * ((nchan + npad) * df)
    # move the window axis to the front: (nwin, ..., nlag)
    dspec = np.moveaxis(dspec, -2, 0)
    return dict(lags=lags, freq_wts=freq_wts, dspec=dspec,
                freq_center=freq_center, bw_eff=bw_eff, pad=pad)


def cross_power_spectrum(ft1, ft2, beam_omega_bw=None, cosmo=cosmo100,
                         units="mk"):
    """Cross power spectrum of two closure-phase delay spectra.

    ft1/ft2: dicts from cpds_ft with matching axes (dspec shape
    (nwin, ..., nlag)). beam_omega_bw: (nwin,) beam 3-D volume (Sr Hz);
    if None, the 'basic' normalization 1/bw_eff is used
    (compute_power_spectrum, bispectrum_phase.py:3350-3604).
    Returns dict(kprll (nwin, nlag), z, P cross-PS cube, factor)."""
    d1, d2 = ft1["dspec"], ft2["dspec"]
    factor, kprll, z = _ps_normalization(ft1["freq_center"],
                                         ft1["bw_eff"], ft1["lags"],
                                         beam_omega_bw, cosmo, units)
    P = d1 * np.conj(d2) * factor.reshape(
        (-1,) + (1,) * (d1.ndim - 1))
    return dict(kprll=kprll, z=z, P=P, factor=factor, lags=ft1["lags"],
                freq_center=ft1["freq_center"])


def _ps_normalization(freq_center, bw_eff, lags, beam_omega_bw=None,
                      cosmo=cosmo100, units="mk"):
    """Cosmological delay->P(k) normalization shared by the cross-PS
    entry points (bispectrum_phase.py:3395-3417): returns
    (factor (nwin,), kprll (nwin, nlag), z (nwin,))."""
    z = freq_to_z(freq_center)
    wl = CNST.c / freq_center
    drz = comoving_depth(bw_eff, z, cosmo)
    rz = np.asarray([cosmo.comoving_distance(zz) for zz in z])
    if beam_omega_bw is None:
        jac1 = 1.0 / bw_eff
        jac2 = drz / bw_eff
        tempfac = np.ones_like(wl)
    else:
        jac1 = 1.0 / np.broadcast_to(np.atleast_1d(beam_omega_bw),
                                     np.shape(freq_center))
        jac2 = rz ** 2 * drz / bw_eff
        tempfac = jy2k(wl) if units == "mk" else np.ones_like(wl)
    factor = jac1 * jac2 * tempfac ** 2
    kprll = np.stack([dkprll_deta(zz, cosmo) * lags for zz in z])
    return factor, kprll, z


def kbin_average(kprll, P, kbins=None, num_kbins=None, kbintype="log"):
    """Incoherent k-bin averaging of a power spectrum along its last axis
    (incoherent_kbin_averaging, bispectrum_phase.py:1235-1496).

    kprll: (nwin, nlag); P: (nwin, ..., nlag). Returns dict(kbin_edges,
    kbin_centers, P_kbin (nwin, ..., nbins))."""
    kprll = np.asarray(kprll)
    P = np.asarray(P)
    nwin = kprll.shape[0]
    if kbins is None:
        num_kbins = num_kbins or 10
        kmax = np.abs(kprll).max()
        if kbintype == "log":
            kmin = np.abs(kprll[kprll != 0]).min()
            kbins = np.logspace(np.log10(kmin * 0.999),
                                np.log10(kmax * 1.001), num_kbins + 1)
        else:
            kbins = np.linspace(0.0, kmax * 1.001, num_kbins + 1)
    kbins = np.asarray(kbins)
    nb = kbins.size - 1
    out = np.full(P.shape[:-1] + (nb,), np.nan, dtype=P.dtype)
    centers = np.sqrt(kbins[:-1] * kbins[1:]) if kbintype == "log" \
        else 0.5 * (kbins[:-1] + kbins[1:])
    for w in range(nwin):
        which = np.digitize(np.abs(kprll[w]), kbins) - 1
        for b in range(nb):
            sel = which == b
            if np.any(sel):
                out[w, ..., b] = np.mean(P[w][..., sel], axis=-1)
    return dict(kbin_edges=kbins, kbin_centers=centers, P_kbin=out)


def cross_power_diagonal(ft, axis_values, axis=1, offsets=(0, 1),
                         beam_omega_bw=None, cosmo=cosmo100):
    """Cross power spectra along covariance diagonals of one axis.

    The reference's compute_power_spectrum collapse_axes machinery
    (bispectrum_phase.py:3350-3604 with OPS.array_trace): for each
    offset m, average d[i] * conj(d[i+m]) over all valid i along `axis`
    of the dspec cube (nwin, nlst, ndays, ntriads, nlag). Cross-products
    at offset m > 0 suppress noise (it decorrelates) while the signal
    (coherent across neighboring LSTs/days) remains.

    ft: dict from cpds_ft; axis: which dspec axis to trace (1=lst,
    2=day, 3=triad); axis_values: coordinate array for that axis.
    Returns dict(P (noffsets, nwin, ..., nlag) with the traced axis
    removed, offsets, axis_offsets (coordinate lags), nsamples)."""
    d = ft["dspec"]
    n = d.shape[axis]
    ps0 = cross_power_spectrum(ft, ft, beam_omega_bw=beam_omega_bw,
                               cosmo=cosmo)
    outs, nsamp, coord = [], [], []
    for m in offsets:
        if m >= n:
            continue
        sl_a = [slice(None)] * d.ndim
        sl_b = [slice(None)] * d.ndim
        sl_a[axis] = slice(0, n - m)
        sl_b[axis] = slice(m, n)
        prod = d[tuple(sl_a)] * np.conj(d[tuple(sl_b)])
        P = prod.mean(axis=axis) * ps0["factor"].reshape(
            (-1,) + (1,) * (d.ndim - 2))
        outs.append(P)
        nsamp.append(n - m)
        av = np.asarray(axis_values)
        coord.append(float(np.mean(av[m:] - av[:n - m])) if n - m > 0
                     else np.nan)
    return dict(P=np.stack(outs), offsets=np.asarray(offsets[:len(outs)]),
                axis_offsets=np.asarray(coord),
                nsamples=np.asarray(nsamp), kprll=ps0["kprll"],
                z=ps0["z"], lags=ps0["lags"])


def _array_trace(arr, ax1, ax2):
    """Nan-aware diagonal collapse of a square (N, N) axis pair: the
    (ax1, ax2) covariance block is replaced (at ax1) by its 2N-1
    leading-diagonal means, offsets -(N-1)..(N-1)
    (the astroutils OPS.array_trace role in bispectrum_phase.py:3546).
    Returns (out, offsets, counts) — counts are the per-offset numbers
    of non-nan samples averaged (diagweights)."""
    arr = np.asarray(arr)
    n = arr.shape[ax1]
    if arr.shape[ax2] != n:
        raise ValueError("axes %d/%d are not a square pair" % (ax1, ax2))
    offsets = np.arange(-(n - 1), n)
    if ax1 >= ax2:
        raise ValueError("expected ax1 < ax2")
    # move the pair to the back (ax2 first so ax1's index is unshifted)
    work = np.moveaxis(np.moveaxis(arr, ax2, -1), ax1, -2)
    outs, counts = [], []
    for o in offsets:
        idx_i = np.arange(max(0, -o), min(n, n - o))
        diag = work[..., idx_i, idx_i + o]          # (..., ndiag)
        valid = ~np.isnan(diag.real)
        cnt = valid.sum(axis=-1)
        s = np.nansum(diag, axis=-1)
        # all-NaN diagonals (e.g. LST-shift-masked samples) stay NaN so
        # later nanmean/avgcov stages ignore them instead of seeing a
        # fake zero power
        outs.append(np.where(cnt > 0, s / np.where(cnt > 0, cnt, 1),
                             np.nan))
        counts.append(cnt.max() if cnt.size else 0)
    out = np.stack(outs, axis=-1)                    # (..., 2n-1)
    out = np.moveaxis(out, -1, ax1)
    return out, offsets, np.asarray(counts)


def xcpdps_full(ft, twts=None, cohax=(), incohax=(), collapse_axes=(),
                lst_shifts=None, avgcov=False, preX=None, postX=None,
                preXnorm=False, postXnorm=False, stat="mean",
                beam_omega_bw=None, cosmo=cosmo100, units="mk"):
    """Full closure-phase cross-power machinery: arbitrary coherent /
    incoherent axis combinations with covariance collapse
    (ClosurePhaseDelaySpectrum.compute_power_spectrum,
    bispectrum_phase.py:2888-3604).

    ft   : dict from cpds_ft; dspec axes (nwin, nlst, ndays, ntriads,
           nlag). Axis ids follow the reference: 1=lst, 2=days,
           3=triads.
    twts : optional (nlst, ndays, ntriads, 1) weights (time flags) used
           in the coherent average.
    cohax: axes averaged coherently (weighted mean, or median when
           stat='median') BEFORE cross-multiplication, keepdims.
    incohax: axes cross-multiplied incoherently. Each axis a expands to
           a pair: for days/triads the full (N, N) covariance block
           d1[i] conj(d2[j]); for the LST axis only `lst_shifts`
           covariance diagonals are formed (default offsets (0, 1)) —
           d2 rolled by each shift with rolled-off entries NaN.
    collapse_axes: subset of incohax whose covariance blocks are
           reduced to per-diagonal means (_array_trace; for LST the
           shift axis already is the diagonal axis, so the partner nlst
           axis is nanmean-ed away).
    avgcov: weighted nanmean of the collapsed diagonal axes down to one
           sample (weights = per-diagonal sample counts x postX).
    preX/postX: {axis_id: weight array} applied before / after the
           cross-multiplication, with optional normalization.

    Returns dict(P, diagoffsets {axis: offsets}, diagweights,
    axesmap {axis: positions in P}, nsamples_coh, nsamples_incoh,
    kprll, z, lags, lst_shifts)."""
    d = np.array(ft["dspec"], dtype=np.complex128)
    nwin = d.shape[0]
    cohax = tuple(np.atleast_1d(cohax).astype(int)) if cohax != () else ()
    incohax = tuple(np.atleast_1d(incohax).astype(int)) \
        if incohax != () else ()
    collapse_axes = tuple(np.atleast_1d(collapse_axes).astype(int)) \
        if collapse_axes != () else ()
    if set(cohax) & set(incohax):
        raise ValueError("cohax and incohax must be disjoint")
    if not set(collapse_axes) <= set(incohax):
        raise ValueError("collapse_axes must be a subset of incohax")
    if lst_shifts is None:
        lst_shifts = np.arange(2)
    lst_shifts = np.asarray(lst_shifts, dtype=int)
    preX = dict(preX or {})
    postX = dict(postX or {})

    factor, kprll, z = _ps_normalization(ft["freq_center"],
                                         ft["bw_eff"], ft["lags"],
                                         beam_omega_bw, cosmo, units)
    nsamples_coh = int(np.prod([d.shape[a] for a in cohax])) \
        if cohax else 1
    ninc = int(np.prod([d.shape[a] for a in incohax])) if incohax else 1
    nsamples_incoh = ninc * (ninc - 1) if incohax else 1

    # ---- coherent stage ------------------------------------------------
    if cohax:
        if twts is not None:
            w = np.asarray(twts, dtype=np.float64)[None, ...]
            if stat == "mean":
                d = (np.sum(w * d, axis=cohax, keepdims=True)
                     / np.sum(np.broadcast_to(w, d.shape), axis=cohax,
                              keepdims=True))
            else:
                d = np.median(d.real, axis=cohax, keepdims=True) \
                    + 1j * np.median(d.imag, axis=cohax, keepdims=True)
        elif stat == "mean":
            d = np.mean(d, axis=cohax, keepdims=True)
        else:
            d = np.median(d.real, axis=cohax, keepdims=True) \
                + 1j * np.median(d.imag, axis=cohax, keepdims=True)

    if not incohax:
        P = np.abs(d) ** 2 * factor.reshape((-1,) + (1,) * (d.ndim - 1))
        return dict(P=P, diagoffsets={}, diagweights={}, axesmap={},
                    nsamples_coh=nsamples_coh, nsamples_incoh=1,
                    kprll=kprll, z=z, lags=ft["lags"],
                    lst_shifts=lst_shifts)

    # ---- incoherent cross-multiplication -------------------------------
    w1 = np.ones((1,) * d.ndim)
    for a in incohax:
        if a in preX:
            shp = [1] * d.ndim
            shp[a] = -1
            w1 = w1 * np.asarray(preX[a]).reshape(shp)
    d1 = d * w1
    d2 = d * w1

    # Lazy covariance collapse (512-antenna scale):
    # materializing an (N, N) triad/day covariance pair costs
    # N x the data volume (17 GB at 512 triads) only to be traced down
    # to 2N-1 diagonal means. For the largest mean-collapsed axis the
    # diagonals are instead extracted straight from the d1/d2 factors
    # (P[.., i, i+o, ..] = d1[i+o] conj(d2[i])), one offset at a time
    # (BASELINE config #5 is the case it is for). Gated behind a
    # size threshold so small cases keep the reference-exact path;
    # both paths leave all-NaN diagonals as NaN.
    lazy = None
    if stat == "mean":
        cands = [int(a) for a in collapse_axes if a != 1]
        if cands:
            est = 16.0 * d.size * lst_shifts.size if 1 in incohax \
                else 16.0 * d.size
            for a in incohax:
                if a != 1:
                    est *= d.shape[a]
            big = max(cands, key=lambda a: d.shape[a])
            if est > _LAZY_COLLAPSE_BYTES and d.shape[big] > 1:
                lazy = big
    lazy_pos = None

    expandax_map = {}
    for a in sorted(incohax, reverse=True):
        if a == lazy:
            lazy_pos = a
            continue
        if lazy_pos is not None and a < lazy_pos:
            lazy_pos += 1
        d1 = np.expand_dims(d1, axis=a)
        if a == 1:
            # LST: only the requested covariance diagonals, via rolls
            base = np.expand_dims(d2, axis=a)
            shp = list(base.shape)
            shp[a] = lst_shifts.size
            rolled = np.empty(shp, dtype=base.dtype)
            for si, s in enumerate(lst_shifts):
                r = np.roll(base[:, 0, ...], s, axis=a)
                sl = [slice(None)] * r.ndim
                # mask the wrapped-around samples: leading s for s>=0,
                # trailing |s| for negative shifts
                sl[a] = slice(0, s) if s >= 0 else slice(s, None)
                r[tuple(sl)] = np.nan
                rolled[:, si, ...] = r
            d2 = rolled
        else:
            d2 = np.expand_dims(d2, axis=a + 1)
        expandax_map[a] = np.array([a, a + 1])
        for k in expandax_map:
            if k > a:
                expandax_map[k] = expandax_map[k] + 1
    lazy_offs = lazy_cnts = None
    if lazy is None:
        P = d1 * np.conj(d2)
    else:
        n = d1.shape[lazy_pos]
        lazy_offs = np.arange(-(n - 1), n)
        c2 = np.conj(d2)
        outs, lazy_cnts = [], []
        for o in lazy_offs:
            idx = np.arange(max(0, -o), min(n, n - o))
            prod = np.take(d1, idx + o, axis=lazy_pos) \
                * np.take(c2, idx, axis=lazy_pos)
            cnt = (~np.isnan(prod.real)).sum(axis=lazy_pos)
            s = np.nansum(prod, axis=lazy_pos)
            outs.append(np.where(cnt > 0,
                                 s / np.where(cnt > 0, cnt, 1), np.nan))
            lazy_cnts.append(int(cnt.max()) if cnt.size else 0)
        P = np.stack(outs, axis=lazy_pos)
        expandax_map[lazy] = np.array([lazy_pos])
    P = P * factor.reshape((-1,) + (1,) * (P.ndim - 1))
    if preXnorm:
        wnorm = (np.expand_dims(w1, 0).sum() if w1.size == 1
                 else np.nansum(w1 ** 2))
        P = P / wnorm

    # ---- covariance collapse -------------------------------------------
    diagoffsets, diagweights = {}, {}
    for colax in collapse_axes:
        if colax == lazy:
            # collapsed during the lazy cross-multiplication; the
            # offsets axis already sits at expandax_map[lazy][0] and no
            # axis is removed, so no position bookkeeping changes
            diagoffsets[colax] = lazy_offs
            diagweights[colax] = np.asarray(lazy_cnts)
            continue
        if colax == 1:
            ax_partner = int(expandax_map[1][-1])
            diagweights[1] = np.sum(
                ~np.isnan(P.real).all(
                    axis=tuple(i for i in range(P.ndim)
                               if i != ax_partner)))
            P = np.nanmean(P, axis=ax_partner) if stat == "mean" \
                else np.nanmedian(P.real, axis=ax_partner) \
                + 1j * np.nanmedian(P.imag, axis=ax_partner)
            diagoffsets[1] = lst_shifts
        else:
            ax1, ax2 = (int(x) for x in expandax_map[colax])
            P, offs, cnts = _array_trace(P, ax1, ax2)
            diagoffsets[colax] = offs
            diagweights[colax] = cnts
        for k in expandax_map:
            if k > colax:
                expandax_map[k] = expandax_map[k] - 1
        expandax_map[colax] = np.atleast_1d(expandax_map[colax][0])

    if collapse_axes:
        wpost = np.ones((1,) * P.ndim)
        for colax in collapse_axes:
            if colax in postX:
                shp = [1] * P.ndim
                shp[int(expandax_map[colax][0])] = -1
                wpost = wpost * np.asarray(postX[colax]).reshape(shp)
        P = P * wpost
        sum_axes = tuple(int(expandax_map[c][0]) for c in collapse_axes)
        if postXnorm:
            P = P / np.nansum(wpost, axis=sum_axes, keepdims=True)
        if avgcov:
            dw = np.ones((1,) * P.ndim)
            for colax in collapse_axes:
                shp = [1] * P.ndim
                shp[int(expandax_map[colax][0])] = -1
                dw = dw * np.asarray(
                    diagweights[colax], dtype=np.float64).reshape(shp) \
                    if np.ndim(diagweights[colax]) else dw
            num = np.nansum(P * dw, axis=sum_axes, keepdims=True)
            den = np.nansum(np.broadcast_to(dw, P.shape)
                            * ~np.isnan(P.real), axis=sum_axes,
                            keepdims=True)
            P = num / np.where(den > 0, den, 1)
            for colax in collapse_axes:
                diagoffsets.pop(colax, None)

    return dict(P=P, diagoffsets=diagoffsets, diagweights=diagweights,
                axesmap={k: np.atleast_1d(v).tolist()
                         for k, v in expandax_map.items()},
                nsamples_coh=nsamples_coh, nsamples_incoh=nsamples_incoh,
                kprll=kprll, z=z, lags=ft["lags"], lst_shifts=lst_shifts)


def incoherent_average(ps_list, weights=None):
    """Weighted incoherent (nan-aware) average of power spectra across
    realizations (incoherent_cross_power_spectrum_average,
    bispectrum_phase.py:806-1234). ps_list: list of arrays of one
    shape; weights: matching list (default: nsamples=1 each)."""
    arr = np.stack([np.asarray(p) for p in ps_list])
    if weights is None:
        w = np.ones(arr.shape[0])
    else:
        w = np.asarray(weights, dtype=np.float64)
    wshape = (arr.shape[0],) + (1,) * (arr.ndim - 1)
    w = w.reshape(wshape) if w.ndim == 1 else w
    num = np.nansum(arr * w, axis=0)
    den = np.nansum(np.broadcast_to(w, arr.shape)
                    * ~np.isnan(arr), axis=0)
    return num / np.where(den > 0, den, 1.0)


def _dict_to_hdf5(group, d):  # retained alias; see io.dicth5
    for k, v in d.items():
        key = str(k)
        if isinstance(v, dict):
            _dict_to_hdf5(group.create_group(key), v)
        elif v is None:
            group.attrs[key] = "__none__"
        elif np.isscalar(v) or isinstance(v, str):
            group.attrs[key] = v
        else:
            arr = np.asarray(v)
            if arr.dtype.kind in "UO":
                arr = np.char.encode(arr.astype(str))
            group[key] = arr


def _hdf5_to_dict(group):
    out = {}
    for k, v in group.attrs.items():
        out[k] = None if (isinstance(v, str) and v == "__none__") else v
    for k in group:
        node = group[k]
        if hasattr(node, "keys"):
            out[k] = _hdf5_to_dict(node)
        else:
            arr = node[()]
            if getattr(arr, "dtype", None) is not None and \
                    arr.dtype.kind == "S":
                arr = np.char.decode(arr)
            out[k] = arr
    return out


def power_spectrum_uncertainty(cpd, freq_center, bw_eff, shape="bhw",
                               fftpow=1.0, pad=1.0, ndaybins=4, seed=0,
                               cosmo=cosmo100):
    """Uncertainty of the closure-phase power spectrum from
    subsample differencing: delay-transform the day-pair half-differences
    of e^{i cp} and form their auto power spectra, incoherently averaged
    over pairs (ClosurePhaseDelaySpectrum.compute_power_spectrum_
    uncertainty, /root/reference/prisim/bispectrum_phase.py:3605-4360,
    fed by the errinfo tree built in subsample_differencing :2023).

    Returns dict(kprll, z, P_err (nwin, nlst, ntriads, nlag), npairs).
    The sign convention of the half differences cancels sky signal, so
    |FT(diff)|^2 estimates the noise floor of the cross spectrum."""
    sub = cpd.subsample_differencing(ndaybins=ndaybins, seed=seed)
    diffs = sub["eicp_diff"]                 # (npairs, nlst, ntri, nchan)
    wts = np.ones(diffs.shape)
    ps_list = []
    ftref = None
    for i in range(diffs.shape[0]):
        ft = cpds_ft(diffs[i], wts[i], cpd.freqs, freq_center, bw_eff,
                     shape=shape, fftpow=fftpow, pad=pad)
        ftref = ft
        ps = cross_power_spectrum(ft, ft, cosmo=cosmo)
        ps_list.append(np.abs(ps["P"]))
    avg = incoherent_average(ps_list)        # array, pair-averaged
    out = cross_power_spectrum(ftref, ftref, cosmo=cosmo)
    return dict(kprll=out["kprll"], z=out["z"], lags=out["lags"],
                freq_center=out["freq_center"],
                P_err=avg, npairs=diffs.shape[0])


def rescale_power_spectrum(ps, freq_wts, vis_triad, vis_lst_hours,
                           units="Jy"):
    """Rescale a dimensionless closure-phase power spectrum to physical
    visibility units (rescale_power_spectrum,
    /root/reference/prisim/bispectrum_phase.py:4361-4494).

    ps: dict from cross_power_spectrum with P (nwin, nlst, ..., nlag)
    and 'lst' (hours); freq_wts: (nwin, nchan) subband windows (from
    cpds_ft); vis_triad: (nvis_lst, 3, nchan) complex visibilities of
    the triad's three baselines; vis_lst_hours: (nvis_lst,).

    Each closure LST maps to the nearest visibility LST (circular);
    the scale is the harmonic combination
    1 / sum_bl |Vbar_bl|^-2 of the window-weighted mean visibility
    amplitudes, giving P in <units>^2 (Mpc/h)^3. Adds 'P_absscale' and
    'absscale_units' to a copy of ps."""
    ps = dict(ps)
    freq_wts = np.atleast_2d(np.asarray(freq_wts, dtype=np.float64))
    vis = np.asarray(vis_triad)
    vlst = np.asarray(vis_lst_hours, dtype=np.float64) * 15.0  # deg
    clst = np.asarray(ps["lst"], dtype=np.float64) * 15.0
    dmat = clst.reshape(-1, 1) - vlst.reshape(1, -1)
    dmat = (dmat + 180.0) % 360.0 - 180.0
    nearest = np.argmin(np.abs(dmat), axis=1)            # (nlst,)
    vsel = vis[nearest]                                  # (nlst, 3, nchan)
    wsum = freq_wts.sum(axis=-1)                         # (nwin,)
    vbar = np.einsum("wc,lbc->wlb", freq_wts, vsel) /         np.maximum(wsum, 1e-30)[:, None, None]           # (nwin, nlst, 3)
    with np.errstate(divide="ignore"):
        mult = 1.0 / np.sum(1.0 / np.maximum(np.abs(vbar), 1e-30) ** 2,
                            axis=-1)                     # (nwin, nlst)
    P = np.asarray(ps["P"])
    mult_b = mult.reshape(mult.shape + (1,) * (P.ndim - 2))
    ps["P_absscale"] = P * mult_b
    ps["absscale_units"] = "%s^2 (Mpc/h)^3" % units
    ps["absscale_mult"] = mult
    return ps


def average_rescaled_power_spectrum(P, kprll, avgax, kprll_llim=None):
    """Average a rescaled power spectrum over the given axes, with
    inverse-variance weights estimated from the |k_parallel| >=
    kprll_llim region (average_rescaled_power_spectrum,
    /root/reference/prisim/bispectrum_phase.py:4495-4637).

    P: (nwin, ..., nlag); kprll: (nwin, nlag); avgax: int or tuple of
    axes in [1, P.ndim-2] (the window and lag axes are preserved)."""
    P = np.asarray(P)
    avgax = tuple(np.atleast_1d(avgax))
    if any(a <= 0 or a >= P.ndim - 1 for a in avgax):
        raise ValueError("avgax must lie strictly between the window "
                         "and lag axes")
    if kprll_llim is None:
        wts = np.ones((1,) * P.ndim)
    else:
        mask = np.abs(np.asarray(kprll)) >= abs(kprll_llim)  # (nwin, nlag)
        mask_b = mask[(slice(None),) + (None,) * (P.ndim - 2)]
        sel = np.where(mask_b, P, np.nan)
        var = np.nanvar(sel.real, axis=-1, keepdims=True)             + np.nanvar(sel.imag, axis=-1, keepdims=True)
        with np.errstate(divide="ignore"):
            wts = 1.0 / np.maximum(var, 1e-300)
    num = np.sum(wts * P, axis=avgax, keepdims=True)
    den = np.sum(wts * np.ones_like(P.real), axis=avgax, keepdims=True)
    return num / np.maximum(den, 1e-300)


def save_xcpdps(ps, path):
    """Save a (nested dict) cross power spectrum product to HDF5
    (save_CPhase_cross_power_spectrum, bispectrum_phase.py:471-631)."""
    from ..io.dicth5 import save_dict_hdf5
    save_dict_hdf5(ps, path)


def read_xcpdps(path):
    """Read back an HDF5 cross power spectrum product
    (read_CPhase_cross_power_spectrum, bispectrum_phase.py:632-805)."""
    from ..io.dicth5 import load_dict_hdf5
    return load_dict_hdf5(path)
