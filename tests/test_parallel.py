"""Sharded simulation must match the single-device path bit-for-bit-ish
on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from prisim_tpu import skymodel as sm
from prisim_tpu import layouts as lay
from prisim_tpu import baselines as bls
from prisim_tpu.engine import (Instrument, Observation, SkySources,
                               simulate_drift)
from prisim_tpu.beams import airy_beam
from prisim_tpu.parallel import (make_mesh, simulate_drift_sharded,
                                 simulate_drift_src_sharded)


def _problem(C=24, n_acc=2, nsrc=80):
    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=False)  # 21 baselines
    freqs = 150e6 + 390625.0 * np.arange(C)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    model = sm.random_point_source_model(nsrc, seed=11)
    sky = SkySources.from_skymodel(model, freqs)
    lst = np.linspace(30.0, 40.0, n_acc)
    obs = Observation(lst_deg=lst, jd=2457349.5 + lst / 360.0,
                      t_acc=np.full(n_acc, 60.0),
                      pointing_altaz=np.tile([90.0, 270.0], (n_acc, 1)))
    beam_fn = lambda dc, f: airy_beam(dc, f, 14.0)
    return inst, sky, obs, beam_fn


def test_eight_devices_available():
    assert len(jax.devices()) == 8


@pytest.mark.parametrize("shape,axes", [
    ((8, 1), ("bl", "chan")),
    ((1, 8), ("bl", "chan")),
    ((4, 2), ("bl", "chan")),
    ((2, 4), ("bl", "chan")),
])
def test_bl_chan_sharding_matches_single_device(shape, axes):
    inst, sky, obs, beam_fn = _problem()
    ref = np.asarray(simulate_drift(inst, sky, obs, beam_fn, src_block=64))
    mesh = make_mesh(shape, axes)
    got = np.asarray(simulate_drift_sharded(inst, sky, obs, beam_fn, mesh,
                                            src_block=64))
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / scale < 1e-5


def test_src_sharding_psum_matches():
    inst, sky, obs, beam_fn = _problem()
    ref = np.asarray(simulate_drift(inst, sky, obs, beam_fn, src_block=64))
    mesh = make_mesh((4, 2), ("src", "chan"))
    got = np.asarray(simulate_drift_src_sharded(inst, sky, obs, beam_fn,
                                                mesh, src_block=64))
    scale = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / scale < 1e-5


def test_three_axis_mesh():
    inst, sky, obs, beam_fn = _problem()
    ref = np.asarray(simulate_drift(inst, sky, obs, beam_fn, src_block=64))
    mesh = make_mesh((2, 2, 2), ("src", "bl", "chan"))
    got = np.asarray(simulate_drift_src_sharded(inst, sky, obs, beam_fn,
                                                mesh, src_block=64))
    scale = np.abs(ref).max()
    assert np.max(np.abs(got - ref)) / scale < 1e-5


def test_sharded_pallas_matches_xla_path(pallas_interpreted):
    """Pallas kernel inside shard_map over a ('bl','chan') CPU mesh
    (interpret mode) must match the sharded XLA engine, exercising the
    chan0 channel-offset path of the kernel."""
    import jax
    import numpy as np
    from prisim_tpu import layouts as lay
    from prisim_tpu import baselines as bls
    from prisim_tpu import skymodel as sm
    from prisim_tpu.engine import Instrument, Observation, SkySources
    from prisim_tpu.parallel.mesh import make_mesh, simulate_drift_sharded
    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=False)
    freqs = 150e6 + 97656.25 * np.arange(32)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    sky = SkySources.from_skymodel(
        sm.random_point_source_model(24, seed=8), freqs)
    lst = np.asarray([15.0, 15.5])
    obs = Observation(lst_deg=lst, jd=2458000.5 + lst / 360.0,
                      t_acc=np.full(2, 30.0),
                      pointing_altaz=np.tile([90.0, 270.0], (2, 1)))
    import jax.numpy as jnp
    beam = lambda s, f: jnp.ones((s.shape[0], f.shape[0]), jnp.float32)
    mesh = make_mesh(axis_names=("bl", "chan"), shape=(2, 4))
    ref = np.asarray(simulate_drift_sharded(inst, sky, obs, beam, mesh))
    got = np.asarray(simulate_drift_sharded(inst, sky, obs, beam, mesh,
                                            use_pallas=True))
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 5e-6


def test_nufft_sharded_matches_single_device():
    """simulate_drift_nufft_sharded over (bl), (chan), and (src+psum)
    meshes agrees with the unsharded NUFFT snapshot and with the direct
    engine at the engine accuracy class, on the 8-device CPU mesh."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu import layouts as lay
    from prisim_tpu import baselines as bls
    from prisim_tpu import skymodel as sm
    from prisim_tpu import twofloat as tf
    from prisim_tpu.engine import (Instrument, SkySources,
                                   enu_rotation_from_eq)
    from prisim_tpu.engine.observe import Observation, simulate_drift
    from prisim_tpu.beams import airy_beam
    from prisim_tpu.parallel.mesh import (make_mesh,
                                          simulate_drift_nufft_sharded)

    layout = lay.preset_layout("HERA-7")
    bset = bls.build_baselines(layout, redundant=False)
    nchan = 64
    freqs = 150e6 + 781250.0 * np.arange(nchan)
    inst = Instrument.build(bset.vectors, freqs, latitude=-30.72)
    model = sm.random_point_source_model(48, flux_min=1.0,
                                         flux_max=10.0, seed=3)
    sky = SkySources.from_skymodel(model, freqs)
    obs = Observation(lst_deg=np.asarray([20.0, 20.3]),
                      jd=2458000.5 + np.asarray([0.0, 1e-3]),
                      t_acc=np.asarray([10.0, 10.0]),
                      pointing_altaz=np.asarray([[90.0, 270.0]] * 2))

    def beam_fn(s, f):
        return airy_beam(s, f, 14.0)

    direct = np.asarray(simulate_drift(inst, sky, obs, beam_fn,
                                       src_block=64))
    scale = np.abs(direct).max()
    for shape, names in [((8, 1), ("bl", "chan")),
                         ((1, 8), ("bl", "chan")),
                         ((1, 1, 8), ("bl", "chan", "src"))]:
        mesh = make_mesh(axis_names=names, shape=shape)
        vis = np.asarray(simulate_drift_nufft_sharded(
            inst, sky, obs, beam_fn, mesh, rank=16))
        assert vis.shape == direct.shape
        rel = np.abs(vis - direct).max() / scale
        assert rel < 2e-5, (shape, rel)


def test_banded_sharded_matches_single_device():
    """simulate_drift_banded_sharded over a 'bl' mesh (the banded
    engine's multi-device decomposition) agrees with the direct engine at
    the engine accuracy class and rejects non-'bl' meshes. 21 baselines
    over 8 shards also exercises the padded-baseline trim."""
    from prisim_tpu.parallel.mesh import (make_mesh,
                                          simulate_drift_banded_sharded)

    inst, sky, obs, beam_fn = _problem(C=32, n_acc=2, nsrc=64)
    ref = np.asarray(simulate_drift(inst, sky, obs, beam_fn,
                                    src_block=64))
    mesh = make_mesh((8, 1), ("bl", "chan"))
    got, ok = simulate_drift_banded_sharded(inst, sky, obs, beam_fn,
                                            mesh)
    got = np.asarray(got)
    assert ok
    assert got.shape == ref.shape
    scale = np.abs(ref).max()
    assert np.abs(got - ref).max() / scale < 2e-5

    with pytest.raises(ValueError):
        simulate_drift_banded_sharded(
            inst, sky, obs, beam_fn, make_mesh((1, 8), ("bl", "chan")))
