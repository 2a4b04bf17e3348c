"""The platform contract: which engine `auto` picks, where the compile cache
lives, and that the GPU-only entry points refuse to run without a GPU."""

import functools
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from cloudsc_tpu import kernels
from cloudsc_tpu.runtime import driver as drv

ROOT = Path(__file__).resolve().parents[1]


def _cpu_env(**extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_COMPILATION_CACHE_DIR", "XLA_FLAGS")}
    env.update(JAX_PLATFORMS="cpu", **extra)
    return env


@pytest.mark.parametrize("platform,engine", [("gpu", "triton"),
                                             ("cpu", "xla")])
def test_auto_engine_follows_platform(monkeypatch, platform, engine):
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert drv.resolve_backend("auto") == engine
    # an explicit engine is taken as given on every platform
    assert drv.resolve_backend("xla") == "xla"
    assert drv.resolve_backend("triton") == "triton"


def test_unknown_engine_is_an_error():
    with pytest.raises(ValueError, match="unknown backend"):
        drv.resolve_backend("pallas")


def test_kernel_failure_is_not_replaced_by_the_scan(input_100, params):
    """The compiled kernel cannot run on the CPU; asking for it there is an
    error, never a silent run of another engine."""
    d = drv.CloudscDriver(params, input_100.ptsphy, dtype=jnp.float32,
                          backend="triton")
    assert d.backend == "triton"
    with pytest.raises(Exception):
        d.run(input_100, iterations=1)


def test_grouped_layout_is_tied_to_the_kernel(params, monkeypatch):
    monkeypatch.setattr(
        kernels, "step_fn",
        lambda backend: functools.partial(lambda *a, **k: None))
    assert drv.CloudscDriver(params, 3600.0, backend="triton").grouped
    assert not drv.CloudscDriver(params, 3600.0, backend="xla").grouped


@pytest.mark.parametrize("env_dir", [False, True])
def test_compile_cache_placement(tmp_path, env_dir):
    """$JAX_COMPILATION_CACHE_DIR when set (and nothing set in code), else
    the fixed .jax_cache directory of the checkout."""
    code = ("import cloudsc_tpu, jax; cloudsc_tpu.enable_compilation_cache();"
            " print(jax.config.jax_compilation_cache_dir)")
    env = _cpu_env()
    if env_dir:
        env["JAX_COMPILATION_CACHE_DIR"] = str(tmp_path / "cache")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    want = tmp_path / "cache" if env_dir else ROOT / ".jax_cache"
    assert out.stdout.strip().splitlines()[-1] == str(want)


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_gpu_entry_points_refuse_the_cpu(script):
    out = subprocess.run([sys.executable, script], cwd=ROOT, env=_cpu_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "columns/s" not in out.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Outside a checkout (only the script in the directory) it cannot run."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         env=_cpu_env(), capture_output=True, text=True,
                         timeout=300)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
