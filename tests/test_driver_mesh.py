"""Driver multi-chip dispatch: on the 8-device CPU mesh (conftest), the
pp.key config must route through shard_map and agree with single-device
results."""

import numpy as np
import pytest

from prisim_tpu.config import load_parms
from prisim_tpu.driver import run_simulation


def _parms(key, mesh_axes=None):
    return load_parms({
        "bandpass": {"nchan": 16, "freq": 155e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 2, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 32, "seed": 4},
        "pp": {"key": key, "mesh_axes": mesh_axes},
    })


@pytest.mark.parametrize("key,axes", [
    ("freq", None), ("bl", None), ("src", None), ("freq", [2, 4]),
])
def test_driver_mesh_matches_reference_key(key, axes):
    import jax
    assert len(jax.devices()) == 8
    vs, _ = run_simulation(_parms(key, axes), verbose=False, save=False)
    # golden: pp.key='none' pins the run to the single-device path (a
    # first-class driver option, no jax.devices mocking)
    parms = _parms(key, axes)
    parms["pp"]["key"] = "none"
    vs1, _ = run_simulation(parms, verbose=False, save=False)
    assert vs.skyvis.shape == vs1.skyvis.shape
    scale = np.abs(vs1.skyvis).max()
    assert np.abs(vs.skyvis - vs1.skyvis).max() / scale < 5e-6


@pytest.mark.parametrize("key", ["freq", "bl", "src"])
def test_driver_mesh_pallas_matches_xla(key, pallas_interpreted):
    """processing.use_pallas=true on the CPU mesh routes each shard's
    NUDFT through the Pallas kernel (interpreted here; compiled on a
    multi-GPU host) and agrees with the XLA engine."""
    parms = _parms(key)
    parms["processing"]["use_pallas"] = False
    vs_xla, _ = run_simulation(parms, verbose=False, save=False)
    parms2 = _parms(key)
    parms2["processing"]["use_pallas"] = True
    vs_pl, _ = run_simulation(parms2, verbose=False, save=False)
    scale = np.abs(vs_xla.skyvis).max()
    assert np.abs(vs_pl.skyvis - vs_xla.skyvis).max() / scale < 5e-6


def test_driver_mesh_banded_nufft_matches_direct():
    """processing.engine: nufft + nufft_spread: banded on a multi-device
    run routes through simulate_drift_banded_sharded (mesh over 'bl')
    and agrees with the single-device direct engine. The driver's
    cross-check gate stays on, so a mismatch would demote the run and
    fail the shape assertion implicitly."""
    parms = _parms("freq")
    parms["processing"] = dict(parms.get("processing") or {},
                               engine="nufft", nufft_spread="banded")
    vs, _ = run_simulation(parms, verbose=False, save=False)
    golden = _parms("freq")
    golden["pp"]["key"] = "none"
    vs1, _ = run_simulation(golden, verbose=False, save=False)
    scale = np.abs(vs1.skyvis).max()
    assert np.abs(vs.skyvis - vs1.skyvis).max() / scale < 2e-5
