"""YAML configuration: parameter schema + template-overlay loader.

Mirrors the reference's parameter surface
(/root/reference/prisim/examples/simparms/defaultparms.yaml, ~20
sections) and its preload-template overlay semantics
(/root/reference/scripts/run_prisim.py:63-101): a custom YAML may name a
template under preload.template; custom keys override the template
key-by-key up to 3 nesting levels; unknown keys are rejected."""

from __future__ import annotations

import copy
import json
import os
import warnings

__all__ = ["DEFAULT_PARMS", "load_parms", "merge_parms", "dump_parms",
           "parse_yaml"]


DEFAULT_PARMS = {
    "preload": {"template": None},
    "dirstruct": {"rootdir": "./", "project": "prisim_tpu_test",
                  "simid": None},
    "telescope": {
        "label_prefix": "", "id": "custom",
        "latitude": -30.7224, "longitude": 21.4278, "altitude": 0.0,
        "A_eff": 154.0, "eff_aprtr": 0.65, "eff_Q": 0.96,
        "Trx": 50.0, "Tant_freqref": 150e6, "Tant_spindex": -2.55,
        "Tant_ref": 200.0, "Tsys": None},
    "array": {
        "redundant": True, "layout": "HERA-19", "file": None,
        "layout_positions": None, "layout_labels": None,
        "filepathtype": "default",
        "parser": {"comment": None, "delimiter": None, "data_start": 3,
                   "data_end": None, "header_start": 0, "label": None,
                   "east": "East", "north": "North", "up": "Up"},
        "minR": 141.0, "maxR": 141.0,
        "rms_tgtplane": 0.0, "rms_elevation": 0.0, "seed": 200},
    "baseline": {"min": None, "max": None, "direction": None},
    "antenna": {"shape": "dish", "size": 14.0,
                "orientation": [90.0, 270.0], "ocoords": "altaz",
                "phased_array": False, "ground_plane": None},
    "phasedarray": {"file": None, "filepathtype": "default",
                    "delayerr": 0.0, "gainerr": 0.0, "nrand": 1},
    "beam": {"use_external": False, "file": None,
             "filepathtype": "default", "filefmt": "HDF5",
             "identifier": "", "pol": "X", "chromatic": True,
             "select_freq": 150e6, "spec_interp": "cubic",
             # pol 'full': 4-pol run with physical XY/YX leakage from
             # crossed-dipole Jones vectors (beams/jones.py — beyond
             # the single-pol reference). feeds configures the Jones
             # model: dipole length [m], ground-plane height [m]
             # (None = free space), X/Y axis azimuths [deg E-thru-N],
             # short_dipole/half_wave element factor selection.
             "feeds": {"length": 1.3, "height": None,
                       "x_orientation_deg": 0.0,
                       "y_orientation_deg": 90.0,
                       "short_dipole": False, "half_wave": True}},
    "bandpass": {"freq": 150e6, "freq_resolution": 390625.0,
                 "nchan": 256, "pfb_method": None, "pfb_filepath":
                 "default", "pfb_file": None},
    "obsparm": {"obs_date": "2015/11/23", "obs_mode": "drift",
                "t_obs": None, "n_acc": 2, "t_acc": 1080.0},
    "gains": {"file": None, "filepathtype": "default",
              # interpolation onto the sim grids: linear|cubic|nearest
              # (interp1d, GainInfo.interpolate_gains) or 'spline'
              # (smoothing splines, GainInfo.splinator/spline_gains,
              # interferometry.py:3107/3382) with optional smoothness
              "interp": "cubic", "smoothness": None},
    "pointing": {"file": None, "jd_init": None, "lst_init": 0.0,
                 "drift_init": {"alt": None, "az": None, "ha": 0.0,
                                "dec": -30.7224},
                 "track_init": {"ra": 0.0, "dec": -30.7224, "ha": 0.0,
                                "epoch": "2000"}},
    "phasing": {"center": [90.0, 270.0], "coords": "altaz"},
    "snapshot": {"avg_drifts": False, "beam_switch": False, "pick": None,
                 "range": None, "all": True},
    "skyparm": {"model": "custom", "fsky": None, "epoch": "2000",
                "nside": None, "n_mdl_freqs": 8, "parallel": False,
                "flux_unit": "Jy", "custom_reffreq": 0.15,
                "flux_min": 10.0, "flux_max": None,
                "fluxcut_reffreq": None, "spindex": -0.83,
                "spindex_rms": 0.0, "spindex_seed": None,
                "roi_radius": None, "lidz": True, "21cmfast": False,
                "global_EoR_parms": [0.027, 150e6, 1.0],
                "nsrc": 100, "seed": 100},
    "catalog": {"filepathtype": "default", "DSM_file_prefix": None,
                "spectrum_file": None, "SUMSS_file": None,
                "NVSS_file": None, "MWACS_file": None, "GLEAM_file": None,
                "custom_file": None, "skymod_file": None},
    "processing": {"gradient_mode": None, "memuse": None,
                   "memavail": None, "n_bins_blo": 4, "n_sky_sectors": 1,
                   "bpass_shape": "rect", "ant_bpass_file": None,
                   "f_pad": 1.0, "coarse_channel_width": 16,
                   "bp_correct": True, "noise_bp_correct": False,
                   "n_pad": 0, "max_abs_delay": 1.0,
                   "delay_transform": False, "memsave": False,
                   "store_prev_sky": True, "cleanup": 3,
                   "src_block": 512, "use_pallas": "auto", "acc_chunk": None,
                   # nufft_rank None = bandwidth-aware auto (16 narrow
                   # band / 32 wide; driver.py). A hard default of 16
                   # would override the auto logic and put a coherent
                   # octave-band fit error in every wide-band run.
                   # engine 'auto' = the direct engine; 'nufft' selects
                   # the delay-space NUFFT (gradient/extended runs stay
                   # direct).
                   "engine": "auto", "nufft_rank": None,
                   # 'auto' = the sorted spread; 'banded' the banded
                   # delay-grid spread (engine/nufft_banded.py)
                   "nufft_spread": "auto",
                   "nufft_crosscheck": True, "nufft_inflight": None,
                   # None = path-aware default: 2e-6 for the banded
                   # shared-amps gates (single-device and mesh),
                   # measured RELATIVE TO THE COHERENT FLUX SCALE
                   # max_c Σ_s|A_sc| — the invariant any f32 engine's
                   # absolute error actually scales with (max|V|
                   # denominators swing with the baseline set on
                   # diffuse skies while the absolute error doesn't
                   # move); 1e-4 for
                   # cross-program gates whose yardstick carries the
                   # coherent beam-recompute term
                   "nufft_crosscheck_tol": None,
                   # Banded engine spectral form (round 4): True =
                   # evaluate beam x flux at the rank Chebyshev nodes
                   # (zero fit residual vs the model, S*r instead of
                   # S*C prep transcendentals); False = project the
                   # full (S, C) amps table (the round-3 form). The
                   # shared-program gate checks EITHER form against
                   # the true full-channel amps and demotes on
                   # mismatch, so tabulated/non-smooth spectra are
                   # safe under both.
                   "nufft_node_model": True,
                   # 'auto': two-float node amps + dual spread when
                   # the beam has a two-float form (plain chromatic
                   # Airy) — the ≤1e-6-vs-f64-truth path (round 5);
                   # the f32 amps chain floors at ~3.5e-6 at
                   # north-star source counts. false restores the
                   # f32 node model.
                   "nufft_truth_amps": "auto",
                   # truth-mode model-adequacy gate: max |rank-r model
                   # - true f32 amps| / max|amps| (healthy ~5e-7;
                   # rank-4-on-an-octave ~1e-1)
                   "nufft_resid_tol": 1e-4,
                   # banded plan delay-grid oversampling (None = the
                   # plan default, engine/nufft_banded.make_banded_plan)
                   "nufft_beta": None},
    "pp": {"key": "freq", "eqvol": True, "method": "pool",
           "mesh_axes": None, "n_chunks": 1},
    "flags": {"flag_chan": -1, "bp_flag_repeat": False,
              "n_edge_flag": [0, 0],
              "flag_repeat_edge_channels": False},
    "save_redundant": True,
    "save_formats": {"fmt": "HDF5", "npz": True, "uvfits": False,
                     "uvh5": False, "uvfits_method": None,
                     "phase_center": None},
    "plots": False,
    "diagnosis": {"resource_monitor": False, "refresh_interval": None,
                  "wait_after_run": False, "jax_profile": None},
}


# Keys accepted for reference-YAML compatibility but deliberately inert
# here, with the reason. The schema must tell the truth: load_parms
# warns when a config sets one of these to a non-default value
# instead of silently ignoring it.
NOOP_KEYS = {
    "processing.memsave":
        "the engine always runs the compensated-float32 path "
        "(<=1e-6 vs float64; there is no float64 mode to save memory "
        "from)",
    "processing.store_prev_sky":
        "spectra are precomputed once for the whole run; the reference's "
        "per-snapshot HDF5 spectrum cache (interferometry.py:6222-6249) "
        "is obsolete",
    "processing.n_bins_blo":
        "parsed but never used by the reference itself "
        "(run_prisim.py:225 is its only mention)",
    "skyparm.parallel":
        "host-side catalog construction is vectorized numpy; no process "
        "pool exists to parallelize",
    "skyparm.lidz":
        "HI-cube selection is via skyparm.model (hi_cube/lidz/21cmfast), "
        "not this boolean",
    "skyparm.21cmfast":
        "HI-cube selection is via skyparm.model, not this boolean",
    "pp.eqvol":
        "SPMD mesh sharding is always statically balanced; there is no "
        "work-stealing counter to toggle (SURVEY.md section 2.7)",
    "pp.method":
        "no multiprocessing pool exists; device parallelism comes from "
        "the jax mesh",
}


def _noop_key_warnings(custom, defaults=None):
    """Warnings for explicitly-set inert keys (dotted-path lookup)."""
    out = []
    defaults = defaults or DEFAULT_PARMS
    for dotted, why in NOOP_KEYS.items():
        sec, key = dotted.split(".")
        val = (custom.get(sec) or {}).get(key, _MISSING) \
            if isinstance(custom.get(sec), dict) else _MISSING
        if val is _MISSING:
            continue
        if val != (defaults.get(sec) or {}).get(key):
            out.append("config key %s=%r has no effect: %s"
                       % (dotted, val, why))
    return out


class _Missing:
    def __repr__(self):
        return "<missing>"


_MISSING = _Missing()


def merge_parms(template, custom, _depth=0, _path=""):
    """Overlay custom onto template, rejecting unknown keys; at most 3
    nested dict levels (run_prisim.py:76-101 semantics)."""
    if _depth >= 3:
        raise TypeError("parameter nesting deeper than 3 levels is not "
                        "supported (at %s)" % _path)
    out = copy.deepcopy(template)
    for key, val in custom.items():
        if key == "preload":
            continue
        if key not in template:
            raise KeyError("invalid parameter %r found in custom "
                           "simulation parameters" % (_path + key))
        if isinstance(val, dict) and isinstance(template[key], dict):
            out[key] = merge_parms(template[key], val, _depth + 1,
                                   _path + key + ".")
        else:
            out[key] = copy.deepcopy(val)
    return out


def load_parms(source, use_builtin_defaults=True):
    """Load simulation parameters from a YAML path, a YAML string, or a
    dict. Applies preload.template overlay if present; otherwise overlays
    onto the builtin DEFAULT_PARMS (so partial configs are valid)."""
    if isinstance(source, dict):
        custom = copy.deepcopy(source)
    elif isinstance(source, str) and os.path.exists(source):
        with open(source) as f:
            custom = parse_yaml(f.read()) or {}
    elif isinstance(source, str):
        custom = parse_yaml(source) or {}
    else:
        raise TypeError("source must be a path, YAML string, or dict")
    template = None
    preload = custom.get("preload") or {}
    if preload.get("template"):
        with open(preload["template"]) as f:
            template = parse_yaml(f.read())
    elif use_builtin_defaults:
        template = DEFAULT_PARMS
    for msg in _noop_key_warnings(custom):
        warnings.warn(msg, stacklevel=2)
    if template is None:
        return custom
    return merge_parms(template, custom)


def parse_yaml(text):
    """YAML text -> python objects. pyyaml is imported only here; JSON
    text (what dump_parms writes, itself valid YAML) parses without
    it."""
    try:
        import yaml
    except ImportError:
        try:
            return json.loads(text)
        except ValueError:
            raise ImportError("pyyaml is needed to parse YAML that is not "
                              "JSON") from None
    return yaml.safe_load(text)


def dump_parms(parms, path):
    """Write resolved parameters (metadata provenance, the reference's
    simparms.yaml at run_prisim.py:2212-2220) as JSON, which is valid
    YAML: load_parms reads it back with or without pyyaml."""
    with open(path, "w") as f:
        json.dump(parms, f, indent=1)
        f.write("\n")
