"""Small runtime utilities."""

from __future__ import annotations

__all__ = ["require_h5py"]


def require_h5py():
    """Import h5py on first use: the simulation's main path runs without
    it, and only HDF5 products need it."""
    try:
        import h5py
    except ImportError:
        raise ImportError(
            "h5py is needed to read or write HDF5 files; install h5py or "
            "choose another product format (save_formats.fmt / npz)") \
            from None
    return h5py


def enable_compilation_cache():
    """Turn on JAX's persistent compilation cache; returns its directory.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX already uses that
    directory and nothing is set here. Otherwise the cache lives at one
    fixed path inside the checkout, `<checkout>/.jax_cache` — the path
    is part of the cache key, so it must not move between runs."""
    import os
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    loc = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", loc)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return loc
