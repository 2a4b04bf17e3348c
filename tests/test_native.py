"""Native (C++) host data path vs the NumPy reference implementations.

The native library mirrors the reference's native loaders/validators
(ref: src/cloudsc_c/cloudsc/load_state.c, cloudsc_validate.c); these tests
pin its semantics to the NumPy path bit-for-bit (expand is pure memcpy;
stats are compared to tolerance since summation order differs).
"""

import numpy as np
import pytest

from cloudsc_tpu.native import expand_native, field_stats_native, get_lib

pytestmark = pytest.mark.skipif(
    get_lib() is None, reason="native library unavailable (no compiler?)"
)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32, np.bool_])
@pytest.mark.parametrize("shape", [(100,), (137, 100), (5, 137, 100)])
@pytest.mark.parametrize("ngptot", [100, 250, 4096])
def test_expand_matches_numpy(dtype, shape, ngptot):
    rng = np.random.default_rng(0)
    if dtype == np.bool_:
        src = rng.random(shape) > 0.5
    elif dtype == np.int32:
        src = rng.integers(0, 100, shape).astype(np.int32)
    else:
        src = rng.standard_normal(shape).astype(dtype)
    got = expand_native(src, ngptot)
    assert got is not None
    reps = -(-ngptot // shape[-1])
    want = np.tile(src, (1,) * (src.ndim - 1) + (reps,))[..., :ngptot]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [np.float64, np.float32, np.int32, np.bool_])
@pytest.mark.parametrize("shape", [(100,), (137, 100)])
@pytest.mark.parametrize("ngptot", [100, 250, 4096])
def test_expand_grouped_matches_numpy(dtype, shape, ngptot):
    from cloudsc_tpu.data.expand import group_counts

    rng = np.random.default_rng(2)
    if dtype == np.bool_:
        src = rng.random(shape) > 0.5
    elif dtype == np.int32:
        src = rng.integers(0, 100, shape).astype(np.int32)
    else:
        src = rng.standard_normal(shape).astype(dtype)
    got = expand_native(src, ngptot, grouped=True)
    assert got is not None
    want = np.repeat(src, group_counts(shape[-1], ngptot), axis=-1)
    np.testing.assert_array_equal(got, want)


def test_field_stats_matches_numpy():
    rng = np.random.default_rng(1)
    field = rng.standard_normal((137, 5000))
    ref = field + rng.standard_normal((137, 5000)) * 1e-9
    got = field_stats_native(field, ref)
    assert got is not None
    minval, maxval, maxerr, errsum, refsum = got
    diff = np.abs(field - ref)
    assert minval == field.min()
    assert maxval == field.max()
    assert maxerr == diff.max()
    np.testing.assert_allclose(errsum, diff.sum(), rtol=1e-12)
    np.testing.assert_allclose(refsum, np.abs(ref).sum(), rtol=1e-12)
