"""Checks that need an NVIDIA GPU: the fused kernel as compiled for the card.

Marked `gpu`; they skip on a machine without one and `chip_smoke.py` runs
them on the card (phase 5): `python -m pytest -m gpu tests/` with
CLOUDSC_TEST_PLATFORM=cuda.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (chip_smoke.py runs these on one)")


def test_auto_engine_is_the_kernel(gpu):
    from cloudsc_tpu.runtime.driver import resolve_backend

    assert resolve_backend("auto") == "triton"


def test_compiled_kernel_layouts_bitwise_per_column(gpu):
    """The cyclic layout, the one-card grouped layout and the four-shard
    grouped layout put different columns side by side in a block, so the
    per-block skips fire on different blocks. As compiled for the card, in
    fp32 (where the kernel's division is approximate), every column must
    come out bitwise the same in all three: no column's result depends on
    its block-mates."""
    from cloudsc_tpu.data import default_input_path, load_input
    from cloudsc_tpu.data.expand import activity_perm, group_inverse
    from cloudsc_tpu.kernels import cloudsc_triton
    from cloudsc_tpu.params import Params
    from cloudsc_tpu.physics import make_inputs

    ncol, klon = 16384, 100
    inp = load_input(default_input_path(), ngptot=ncol, expand=False)
    params = Params.from_input(inp)
    fn = jax.jit(lambda f: cloudsc_triton(f, params, inp.ptsphy))
    want = fn(make_inputs(inp, dtype=jnp.float32))
    for nshards in (1, 4):
        perm = activity_perm(inp.fields["PCLV"], inp.fields["TENDENCY_TMP_CLD"],
                             inp.ptsphy, params.ydecldp.rlmin, nshards=nshards)
        got = fn(make_inputs(inp, dtype=jnp.float32, column_order="grouped",
                             column_perm=perm))
        inv = jnp.asarray(group_inverse(klon, ncol, perm=perm))
        for name in want._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(want, name)),
                np.asarray(getattr(got, name)[..., inv]),
                err_msg=f"{name}, {nshards} shard(s)")


def test_compiled_kernel_matches_scan_with_padding(gpu):
    """The kernel compiled through Triton for the card, in fp64 at a column
    count that is not a multiple of its block, against the scan on the
    card: only the section-8 sums' order and FMA contraction differ."""
    from cloudsc_tpu.data import default_input_path, load_input
    from cloudsc_tpu.kernels import cloudsc_triton
    from cloudsc_tpu.params import Params
    from cloudsc_tpu.physics import cloudsc, make_inputs

    inp = load_input(default_input_path(), ngptot=300)
    params = Params.from_input(inp)
    fields = make_inputs(inp, dtype=jnp.float64)
    ref = jax.jit(lambda f: cloudsc(f, params, inp.ptsphy))(fields)
    out = jax.jit(lambda f: cloudsc_triton(f, params, inp.ptsphy))(fields)
    for name in ref._fields:
        a = np.asarray(getattr(ref, name))
        b = np.asarray(getattr(out, name))
        assert b.shape == a.shape and np.isfinite(b).all(), name
        refsum = np.abs(a).sum()
        err = np.abs(a - b).sum()
        assert err <= 5e-12 * refsum if refsum > 0 else err == 0.0, name
