import os
import sys

# Tests run on a virtual 8-device CPU mesh: sharding logic is validated without
# several GPUs. CLOUDSC_TEST_PLATFORM=cuda selects the card instead (the tests
# marked gpu; chip_smoke.py runs them).
os.environ["JAX_PLATFORMS"] = os.environ.get("CLOUDSC_TEST_PLATFORM", "cpu")
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)

import cloudsc_tpu  # noqa: E402

cloudsc_tpu.enable_compilation_cache()

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cloudsc_tpu.data import default_input_path, default_reference_path  # noqa: E402

REFERENCE_DATA = default_input_path()
REFERENCE_H5 = default_reference_path()


@pytest.fixture(scope="session")
def input_100():
    from cloudsc_tpu.data import load_input

    return load_input(REFERENCE_DATA, ngptot=100)


@pytest.fixture(scope="session")
def params(input_100):
    from cloudsc_tpu.params import Params

    return Params.from_input(input_100)


@pytest.fixture(scope="session")
def reference_100():
    from cloudsc_tpu.data import load_reference

    return load_reference(REFERENCE_H5)


@pytest.fixture(scope="session")
def golden_outputs_fp64(input_100, params):
    """The fp64 scheme outputs at 100 columns — shared across tests."""
    import jax.numpy as jnp

    from cloudsc_tpu.physics import cloudsc, make_inputs

    fields = make_inputs(input_100, dtype=jnp.float64)
    fn = jax.jit(lambda f: cloudsc(f, params, input_100.ptsphy))
    return jax.block_until_ready(fn(fields))


def relerr(got, want):
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    errsum = np.abs(got - want).sum()
    refsum = np.abs(want).sum()
    return errsum / refsum if refsum > 0 else errsum


# ---------------------------------------------------------------------------
# quick/slow split: `pytest -m quick` is the bounded core set (CI stage 1 and
# judge environments); `-m slow` is the interpret-mode kernel sweeps and
# property tests that dominate wall time on a 1-core host. Every test gets
# exactly one of the two markers, assigned here by module/name so the split
# can't silently drift as tests are added (unlisted modules default to slow).
# ---------------------------------------------------------------------------
QUICK_MODULES = {
    "test_golden",       # fp64/fp32 golden tables (the correctness bar)
    "test_multidevice",  # virtual 8-device mesh vs single-device
    "test_data",         # loader/expand contracts
    "test_native",       # C++ host data path vs numpy
    "test_tools",        # serialbox converter round trips
    "test_pmon",         # energy-monitor plumbing
    "test_triton",       # fused kernel vs the scan (interpret), CUDA lowering
    "test_platform",     # engine choice, compile cache, GPU-only entry points
}
QUICK_TESTS = {
    "test_cli_serial_golden",                 # reference-arg-parity smoke
    "test_validation_table_survives_nonfinite",
}


def pytest_collection_modifyitems(config, items):
    for item in items:
        name = item.name.split("[")[0]
        module = item.module.__name__.rsplit(".", 1)[-1]
        if module in QUICK_MODULES or name in QUICK_TESTS:
            item.add_marker(pytest.mark.quick)
        else:
            item.add_marker(pytest.mark.slow)
