"""prisim_tpu — an accelerator-native radio interferometer simulation framework.

A from-scratch JAX/XLA/Pallas rebuild of the capabilities of PRISim
(nithyanandan/PRISim): visibility simulation via non-uniform DFT over sky
models with primary beams, instrument gains and thermal noise, plus delay
spectrum / closure phase (bispectrum phase) analysis pipelines — designed
for device meshes (shard_map/pjit) rather than MPI ranks.

Public entry points (lazy — importing prisim_tpu does not pull in jax):

    from prisim_tpu import run_simulation, load_parms     # driver
    from prisim_tpu.vis import VisibilitySet              # container
    from prisim_tpu.io import save_hdf5, load_hdf5        # persistence
    from prisim_tpu.analysis import ...                   # delay/closure

See PARITY.md for the component-by-component map to the reference.
"""

__version__ = "0.1.0"

_LAZY = {
    "run_simulation": ("prisim_tpu.driver", "run_simulation"),
    "run_simulation_chunked": ("prisim_tpu.driver",
                               "run_simulation_chunked"),
    "load_parms": ("prisim_tpu.config", "load_parms"),
    "DEFAULT_PARMS": ("prisim_tpu.config", "DEFAULT_PARMS"),
    "VisibilitySet": ("prisim_tpu.vis", "VisibilitySet"),
    "SkyModel": ("prisim_tpu.skymodel", "SkyModel"),
    "GainInfo": ("prisim_tpu.gains", "GainInfo"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError("module 'prisim_tpu' has no attribute %r" % name)


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
