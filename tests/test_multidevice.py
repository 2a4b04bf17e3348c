"""Multi-device sharding equality on a virtual 8-device CPU mesh.

Sharding the embarrassingly parallel column axis must be bitwise identical to
single-device execution — this program's analogue of the reference's MPI-vs-serial
bitwise comparability (ref: README.md:167-175). Also exercises the distributed
validation-norm reductions (the CLOUDSC_MPI_REDUCE_* analogue).
"""

import jax
import numpy as np
import pytest

from cloudsc_tpu.runtime import dist


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs the virtual multi-device CPU platform")
    return dist.column_mesh()


def test_mesh_devices(mesh):
    assert mesh.devices.size == 8


def test_sharded_equals_single(input_100, params, mesh):
    import jax.numpy as jnp

    from cloudsc_tpu.data import load_input
    from cloudsc_tpu.physics import cloudsc, make_inputs
    from conftest import REFERENCE_DATA

    # 800 columns = 8 devices x 100; tiled input means every shard holds the
    # same physical columns.
    inp = load_input(REFERENCE_DATA, ngptot=800)
    fields = make_inputs(inp, dtype=jnp.float64)

    single = jax.jit(lambda f: cloudsc(f, params, inp.ptsphy))(fields)
    sharded_fn = dist.sharded_cloudsc(params, inp.ptsphy, mesh)
    sharded = sharded_fn(dist.shard_fields(fields, mesh))

    for name in ("plude", "pfplsl", "pfhpsn", "tendency_loc_t", "prainfrac_toprfz"):
        a = np.asarray(getattr(single, name))
        b = np.asarray(getattr(sharded, name))
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_distributed_error_norms(mesh):
    rng = np.random.default_rng(0)
    field = rng.normal(size=(137, 800))
    ref = field + rng.normal(scale=1e-9, size=field.shape)
    norms_fn = dist.sharded_error_norms(mesh)
    got = np.asarray(norms_fn(field, ref))
    np.testing.assert_allclose(got[0], field.min(), rtol=1e-12)
    np.testing.assert_allclose(got[1], field.max(), rtol=1e-12)
    np.testing.assert_allclose(got[2], np.abs(field - ref).max(), rtol=1e-12)
    np.testing.assert_allclose(got[3], np.abs(field - ref).sum(), rtol=1e-9)
    np.testing.assert_allclose(got[4], np.abs(ref).sum(), rtol=1e-9)


def test_driver_mesh_kernel_bitwise_vs_single(mesh, monkeypatch):
    """The fused kernel on the mesh — one kernel per device's shard under
    shard_map, grouped column layout, outputs gathered back to canonical
    order — equals the one-device run bitwise per column, and the sharded
    validation norms equal the one-device norms (interpret mode on the
    virtual CPU devices)."""
    import functools

    import jax.numpy as jnp

    from cloudsc_tpu.data import load_input
    from cloudsc_tpu import kernels
    from cloudsc_tpu.kernels.triton_cloudsc import cloudsc_triton
    from cloudsc_tpu.params import Params
    from cloudsc_tpu.runtime import driver as drv
    from conftest import REFERENCE_DATA

    interpreted = functools.partial(cloudsc_triton, interpret=True)
    monkeypatch.setattr(kernels, "step_fn", lambda backend: interpreted)

    inp = load_input(REFERENCE_DATA, ngptot=8 * 128, expand=False)
    params = Params.from_input(inp)
    outs = {}
    for use_mesh in (False, True):
        d = drv.CloudscDriver(params, inp.ptsphy, dtype=jnp.float32,
                              backend="triton", use_mesh=use_mesh)
        assert d.grouped
        outs[use_mesh], _, _ = d.run(inp, iterations=1, fetch_outputs=False)
    for name in outs[False]._fields:
        a = np.asarray(getattr(outs[False], name))
        b = np.asarray(getattr(outs[True], name))
        np.testing.assert_array_equal(a, b, err_msg=name)

    norms = dist.sharded_error_norms(mesh)
    one = np.asarray(dist.error_norms(outs[False].tendency_loc_t,
                                      outs[False].tendency_loc_t * 0.5)
                     ["errsum"])
    got = np.asarray(norms(outs[True].tendency_loc_t,
                           outs[True].tendency_loc_t * 0.5))
    np.testing.assert_allclose(got[3], one, rtol=1e-6)
