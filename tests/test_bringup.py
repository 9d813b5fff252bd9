"""GPU bring-up: contraction precision, compile-cache placement, runs
without pyyaml/h5py, and chip_smoke.py's checks at toy size on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


@pytest.fixture(scope="module")
def toy_problem():
    return cs.headline_problem("HERA-7", nchan=32, nside=4)


# --------------------------------------------------------------------------
# precision
# --------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["direct-xla", "nufft-sorted", "banded"])
def test_every_contraction_is_highest(engine, toy_problem):
    """Every f32 dot_general in an engine's jitted snapshot carries
    Precision.HIGHEST: at default precision an NVIDIA GPU may take f32
    products in TF32 (~1e-3 relative)."""
    from prisim_tpu.diagnostics import all_highest, dot_precisions
    prog, args, _ = cs.engine_programs(toy_problem, [engine])[engine]
    precs = dot_precisions(prog, *args)
    assert precs, "no contraction found"
    assert all_highest(precs), precs


def test_precision_audit_flags_default_dot():
    """The audit itself: a default-precision f32 einsum is flagged, the
    HIGHEST one is not."""
    import jax
    import jax.numpy as jnp
    from prisim_tpu.diagnostics import all_highest, dot_precisions
    a = jnp.ones((4, 4), jnp.float32)
    assert not all_highest(dot_precisions(
        lambda x: jnp.einsum("ij,jk->ik", x, x), a))
    assert all_highest(dot_precisions(
        lambda x: jnp.einsum("ij,jk->ik", x, x,
                             precision=jax.lax.Precision.HIGHEST), a))


def test_two_prod_masked_split_matches_veltkamp():
    """The traced split (low 12 mantissa bits cleared) gives the same
    exact (p, e) pair as the host Veltkamp split."""
    import jax.numpy as jnp
    from prisim_tpu import twofloat as tf
    rng = np.random.default_rng(0)
    a = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096)
         ).astype(np.float32)
    b = (rng.standard_normal(4096) * 10.0 ** rng.uniform(-3, 3, 4096)
         ).astype(np.float32)
    p_np, e_np = tf.two_prod(a, b)
    p_j, e_j = tf.two_prod(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(np.asarray(p_j), p_np)
    np.testing.assert_array_equal(np.asarray(e_j), e_np)
    exact = a.astype(np.float64) * b.astype(np.float64)
    np.testing.assert_array_equal(
        np.asarray(p_j, np.float64) + np.asarray(e_j, np.float64), exact)


# --------------------------------------------------------------------------
# compile cache
# --------------------------------------------------------------------------

def test_compile_cache_respects_env_dir(monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, JAX uses it and the program
    sets nothing."""
    import jax
    from prisim_tpu.utils import enable_compilation_cache
    calls = []
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert enable_compilation_cache() == str(tmp_path)
    assert calls == []


def test_compile_cache_fixed_path_in_checkout(monkeypatch):
    """Unset, the cache is one fixed directory inside the checkout."""
    import jax
    from prisim_tpu.utils import enable_compilation_cache
    calls = []
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    loc = enable_compilation_cache()
    assert loc == os.path.join(ROOT, ".jax_cache")
    assert ("jax_compilation_cache_dir", loc) in calls


# --------------------------------------------------------------------------
# optional packages
# --------------------------------------------------------------------------

def test_main_path_imports_neither_yaml_nor_h5py():
    code = ("import sys, prisim_tpu.driver, prisim_tpu.config, "
            "prisim_tpu.io, prisim_tpu.tools; "
            "print(json_ok := 'yaml' not in sys.modules "
            "and 'h5py' not in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=120,
                         env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith("True")


def test_parms_roundtrip_without_yaml(monkeypatch, tmp_path):
    """dump_parms writes JSON (valid YAML) and load_parms reads it back
    with pyyaml unavailable."""
    from prisim_tpu.config import dump_parms, load_parms
    parms = load_parms({"bandpass": {"nchan": 16}})
    monkeypatch.setitem(sys.modules, "yaml", None)
    path = str(tmp_path / "simparms.yaml")
    dump_parms(parms, path)
    with open(path) as f:
        assert json.load(f) == parms
    assert load_parms(path) == parms


def test_yaml_text_needs_pyyaml(monkeypatch):
    from prisim_tpu.config import parse_yaml
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="pyyaml"):
        parse_yaml("bandpass:\n  nchan: 16\n")


def _tiny_parms(tmp_path, fmt):
    from prisim_tpu.config import load_parms
    return load_parms({
        "dirstruct": {"rootdir": str(tmp_path), "project": "p",
                      "simid": "s"},
        "bandpass": {"nchan": 8, "freq": 150e6,
                     "freq_resolution": 195312.5},
        "array": {"layout": "HERA-7"},
        "obsparm": {"n_acc": 1, "t_acc": 60.0},
        "skyparm": {"model": "random", "nsrc": 8, "seed": 2},
        "pp": {"key": "none"},
        "save_formats": {"fmt": fmt, "npz": True}})


def test_npz_run_without_yaml_and_h5py(monkeypatch, tmp_path):
    """run_simulation through _save_products with neither pyyaml nor
    h5py importable: npz product and JSON metadata."""
    from prisim_tpu.driver import run_simulation
    from prisim_tpu.io import load_npz
    monkeypatch.setitem(sys.modules, "yaml", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    vs, out = run_simulation(_tiny_parms(tmp_path, "none"), verbose=False)
    back = load_npz(os.path.join(out, "simdata", "simvis.npz"))
    np.testing.assert_array_equal(back.vis, vs.vis)
    with open(os.path.join(out, "metainfo", "meta.yaml")) as f:
        assert "prisim_tpu_version" in json.load(f)


def test_hdf5_product_without_h5py_raises(monkeypatch, tmp_path):
    from prisim_tpu.driver import run_simulation
    monkeypatch.setitem(sys.modules, "h5py", None)
    with pytest.raises(ImportError, match="h5py"):
        run_simulation(_tiny_parms(tmp_path, "HDF5"), verbose=False)


# --------------------------------------------------------------------------
# chip_smoke at toy size
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fault", ["perturbed", "shape", "nan"])
def test_smoke_compare_catches_bad_result(fault):
    rng = np.random.default_rng(1)
    ref = rng.standard_normal((8, 64)) + 1j * rng.standard_normal((8, 64))
    scale = 100.0
    assert cs.compare("ok", ref + 1e-5, ref, scale, 2e-6) <= 2e-6
    bad = ref.copy()
    if fault == "perturbed":
        bad[3, 17] += 1e-3
    elif fault == "shape":
        bad = bad[:, :63]
    else:
        bad[0, 0] = np.nan
    with pytest.raises(AssertionError):
        cs.compare(fault, bad, ref, scale, 2e-6)


def test_smoke_engines_phase_toy(toy_problem):
    """Phase 2's compile-time-check-compare loop on the CPU (the kernel
    is left out: it compiles only for the GPU)."""
    rec = cs.engines_phase(["direct-xla", "nufft-sorted", "banded"],
                           problem=toy_problem, repeats=1)
    assert rec["direct-xla"]["rel"] < cs.TOL_DIRECT
    assert rec["banded"]["rel"] < cs.TOL_DIRECT
    assert rec["nufft-sorted"]["rel"] < cs.TOL_SORTED


def _toy_northstar():
    parms = cs.northstar_parms()
    parms["array"]["layout"] = "HERA-19"
    parms["bandpass"]["nchan"] = 16
    parms["skyparm"]["nside"] = 4
    return parms


def test_smoke_driver_phase_toy():
    """Phase 3 on a cut-down flagship config: product round trip (npz,
    as without h5py) and snapshot 0 against the f64 reference."""
    vs = cs.driver_phase(_toy_northstar(), {"h5py": False, "yaml": True})
    assert np.asarray(vs.skyvis).shape == (30, 16, cs.N_ACC)


def test_smoke_mesh4_toy_on_four_cpu_devices():
    """chip_smoke's --mesh4 comparison (pp.key bl/freq/src on four
    devices vs none on one) on four virtual CPU devices."""
    code = ("import sys; sys.path.insert(0, %r); import jax; "
            "jax.config.update('jax_platforms', 'cpu'); "
            "import test_bringup as t, chip_smoke as cs; "
            "assert len(jax.devices()) == 4; "
            "cs.mesh_phase(t._toy_northstar()); print('MESH_OK')"
            % os.path.join(ROOT, "tests"))
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "MESH_OK" in out.stdout
    assert out.stdout.count("[check] pp.key") == 3
