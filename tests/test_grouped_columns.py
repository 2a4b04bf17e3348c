"""Activity-grouped column layout: permutation math and bitwise equality of
grouped vs cyclic kernel outputs.

The benchmark expansion tiles the snapshot's KLON columns cyclically
(ref: expand_mod.F90:237-334), so every column block of the fused kernel
mixes many distinct columns and the per-block dynamic skips approach the
whole-batch rate. The grouped layout writes each source column's copies
contiguously — a pure permutation — making blocks homogeneous. Because
columns are independent and the skips are value-exact, gathering grouped
outputs with group_inverse must reconstruct the cyclic outputs BITWISE.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cloudsc_tpu.data import load_input
from cloudsc_tpu.data.expand import (
    activity_perm,
    expand_field,
    group_counts,
    group_inverse,
)
from cloudsc_tpu.kernels.triton_cloudsc import cloudsc_triton
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import make_inputs

from conftest import REFERENCE_DATA as INPUT_PATH


@pytest.mark.parametrize("klon,ncol", [(7, 23), (100, 256), (5, 5), (10, 3),
                                       (100, 163840)])
def testgroup_permutation_properties(klon, ncol):
    counts = group_counts(klon, ncol)
    assert counts.sum() == ncol
    # grouped source ids are a permutation of the cyclic source ids
    grouped_src = np.repeat(np.arange(klon), counts)
    cyclic_src = np.arange(ncol) % klon
    assert sorted(grouped_src) == sorted(cyclic_src)
    # the inverse picks a grouped column with the same source
    inv = group_inverse(klon, ncol)
    assert inv.shape == (ncol,)
    np.testing.assert_array_equal(grouped_src[inv], cyclic_src)


@pytest.mark.parametrize("klon,ncol", [(7, 23), (100, 256), (5, 5),
                                       (100, 163840)])
def test_group_inverse_with_source_permutation(klon, ncol):
    """Sorted grouping = pre-permuted sources + plain grouped layout; the
    perm-aware inverse must route every canonical column to a position
    holding its source."""
    rng = np.random.default_rng(3)
    perm = rng.permutation(klon).astype(np.int64)
    counts = group_counts(klon, ncol)          # position-based counts
    layout_src = np.repeat(perm, counts)       # source held at each position
    inv = group_inverse(klon, ncol, perm=perm)
    np.testing.assert_array_equal(
        layout_src[inv], np.arange(ncol, dtype=np.int64) % klon
    )


def test_activity_perm_is_valid_and_deterministic():
    rng = np.random.default_rng(4)
    nclv, nlev, klon = 5, 9, 11
    pclv = np.abs(rng.standard_normal((nclv, nlev, klon))) * 1e-6
    tcld = rng.standard_normal((nclv, nlev, klon)) * 1e-10
    pclv[:, :, 0] = 0.0  # a fully clear column
    tcld[:, :, 0] = 0.0
    p1 = activity_perm(pclv, tcld, 3600.0, 1e-8)
    p2 = activity_perm(pclv, tcld, 3600.0, 1e-8)
    np.testing.assert_array_equal(p1, p2)
    assert sorted(p1) == list(range(klon))
    # descending activity: the clear column sorts last (edge padding
    # replicates the final column, so it must be the least active)
    assert p1[-1] == 0
    # shard-dealt variant (mesh runs): still a permutation, and the busiest
    # columns spread one-per-shard instead of all landing on shard 0
    p8 = activity_perm(pclv, tcld, 3600.0, 1e-8, nshards=4)
    assert sorted(p8) == list(range(klon))
    shard_of = np.empty(klon, np.int64)
    for s in range(4):
        lo = s * (klon // 4) + min(s, klon % 4)
        shard_of[lo:lo + klon // 4 + (s < klon % 4)] = s
    top4 = [int(np.where(p8 == c)[0][0]) for c in p1[:4]]
    assert sorted(shard_of[top4]) == [0, 1, 2, 3]


def test_expand_field_grouped_is_permutation():
    rng = np.random.default_rng(0)
    src = rng.standard_normal((3, 7))
    cyc = expand_field(src, 23)
    grp = expand_field(src, 23, order="grouped")
    inv = group_inverse(7, 23)
    np.testing.assert_array_equal(grp[..., inv], cyc)


@pytest.fixture
def interpreted_driver(monkeypatch):
    """The driver with the fused kernel in interpret mode (CPU)."""
    import functools

    from cloudsc_tpu.kernels.triton_cloudsc import cloudsc_triton
    from cloudsc_tpu import kernels
    from cloudsc_tpu.runtime import driver as drv

    monkeypatch.setattr(kernels, "step_fn", lambda backend: functools.partial(
        cloudsc_triton, interpret=True))
    return drv.CloudscDriver


def _cyclic_kernel(inp, params):
    fields = make_inputs(inp, dtype=jnp.float32)
    return cloudsc_triton(fields, params, inp.ptsphy, interpret=True)


def _assert_bitwise(want, got):
    for name in want._fields:
        np.testing.assert_array_equal(np.asarray(getattr(want, name)),
                                      np.asarray(getattr(got, name)),
                                      err_msg=name)


def test_grouped_kernel_outputs_bitwise_equal_cyclic():
    """End-to-end: the kernel on the grouped layout, inverse-gathered, is
    bitwise identical to the cyclic layout (interpret mode on CPU)."""
    ngptot = 256
    inp = load_input(INPUT_PATH, ngptot=ngptot, expand=False)
    params = Params.from_input(inp)
    klon = np.asarray(inp.fields["PT"]).shape[-1]
    assert klon < ngptot  # grouping must actually permute here

    grouped = make_inputs(inp, dtype=jnp.float32, column_order="grouped")
    out = cloudsc_triton(grouped, params, inp.ptsphy, interpret=True)
    inv = group_inverse(klon, ngptot)
    _assert_bitwise(_cyclic_kernel(inp, params),
                    jax.tree.map(lambda a: a[..., inv], out))


def test_driver_grouped_matches_cyclic(interpreted_driver):
    """The driver glue: prepare() expands grouped and activity-sorted,
    run() gathers outputs back to canonical order — returned outputs must be
    bitwise identical to the kernel on the cyclic layout."""
    inp = load_input(INPUT_PATH, ngptot=256, expand=False)
    params = Params.from_input(inp)
    d = interpreted_driver(params, inp.ptsphy, dtype=jnp.float32,
                           backend="triton")
    assert d.grouped
    out, _, _ = d.run(inp, iterations=1)
    assert d.group_perm is not None
    _assert_bitwise(_cyclic_kernel(inp, params), out)


def test_driver_grouped_small_ngptot(interpreted_driver):
    """ngptot < klon: fewer requested columns than the snapshot holds (the
    reference's ctest runs e.g. `1 100 16`). The grouped expansion then has
    empty groups and the activity sort must self-disable (driver only sorts
    when klon < ncol) — outputs must still match the cyclic layout bitwise."""
    inp = load_input(INPUT_PATH, ngptot=16, expand=False)
    params = Params.from_input(inp)
    d = interpreted_driver(params, inp.ptsphy, dtype=jnp.float32,
                           backend="triton")
    out, _, _ = d.run(inp, iterations=1)
    assert d.group_perm is None  # sort self-disabled below klon
    _assert_bitwise(_cyclic_kernel(inp, params), out)


def test_driver_chained_non_tile_multiple(interpreted_driver):
    """iterations>1 with ngptot NOT a multiple of the kernel's block: the
    chained loop's zero-scaled dependency must leave the values unchanged.
    This is the timed path of every CLI run with --iterations > 1."""
    inp = load_input(INPUT_PATH, ngptot=100, expand=False)
    params = Params.from_input(inp)
    outs = []
    for iterations in (2, 1):
        d = interpreted_driver(params, inp.ptsphy, dtype=jnp.float32,
                               backend="triton")
        outs.append(d.run(inp, iterations=iterations)[0])
    _assert_bitwise(outs[1], outs[0])
