"""The fused Triton kernel vs the XLA scan oracle, on the CPU.

The kernel runs in the Pallas interpreter here; it shares its physics body
(scheme.level_init / level_step) with the scan, so the fp64 golden tests
already guard the numerics. These tests guard the kernel's *schedule* — the
carries across the level loop, the section-8 flux sums, NCLDTOP masking and
column padding — and that every configuration still lowers for CUDA, which
catches primitives the Triton route does not support without a card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudsc_tpu.data import load_input
from cloudsc_tpu.kernels import triton_cloudsc
from cloudsc_tpu.kernels.triton_cloudsc import cloudsc_triton
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import cloudsc, make_inputs
from cloudsc_tpu.physics.scheme import SchemeConfig

from conftest import REFERENCE_DATA as INPUT_PATH

NGPTOT = 256  # two 128-column blocks

CONFIGS = [
    None,
    SchemeConfig(iwarmrain=1),
    SchemeConfig(ievaprain=1),
    SchemeConfig(ievapsnow=2),
    SchemeConfig(idepice=2),
]


def _cfg_id(c):
    if c is None:
        return "default"
    return f"w{c.iwarmrain}r{c.ievaprain}s{c.ievapsnow}d{c.idepice}"


@pytest.fixture(scope="module")
def setup():
    inp = load_input(INPUT_PATH, ngptot=NGPTOT)
    return inp, Params.from_input(inp)


@pytest.fixture(scope="module", params=["fp32", "fp64"])
def oracle_pair(request, setup):
    inp, params = setup
    dtype = jnp.float32 if request.param == "fp32" else jnp.float64
    fields = make_inputs(inp, dtype=dtype)
    ref = jax.jit(lambda f: cloudsc(f, params, inp.ptsphy))(fields)
    return request.param, fields, ref


def _errors(ref, out):
    """Per field: (errsum/refsum, max abs err / max abs value)."""
    errs = {}
    for name in ref._fields:
        a = np.asarray(getattr(ref, name), np.float64)
        b = np.asarray(getattr(out, name), np.float64)
        assert a.shape == b.shape, (name, a.shape, b.shape)
        d = np.abs(a - b)
        refsum = np.abs(a).sum()
        errs[name] = (d.sum() / refsum if refsum > 0 else d.sum(),
                      d.max() / max(np.abs(a).max(), 1e-30))
    return errs


def _assert_close(prec, ref, out):
    # fp64: only the section-8 running sums may differ (a sequential sum in
    # the kernel, XLA's cumsum order in the scan), at a few ulps;
    # fp32: the bar the fused kernel has always been held to vs the scan
    for name, (rel, maxrel) in _errors(ref, out).items():
        if prec == "fp64":
            assert rel <= 1e-14, f"{name}: errsum/refsum {rel:.3e}"
        else:
            assert maxrel < 1e-5, f"{name}: maxrel {maxrel:.3e}"


def test_kernel_matches_scan(setup, oracle_pair):
    inp, params = setup
    prec, fields, ref = oracle_pair
    out = cloudsc_triton(fields, params, inp.ptsphy, interpret=True)
    _assert_close(prec, ref, out)


def test_kernel_column_padding(setup, oracle_pair):
    """ncol not a multiple of the block: pad columns must not leak."""
    inp, params = setup
    prec, fields, ref = oracle_pair
    cut = NGPTOT - 96
    fields_c = {k: v[..., :cut] for k, v in fields.items()}
    ref_c = jax.tree.map(lambda a: a[..., :cut], ref)
    out = cloudsc_triton(fields_c, params, inp.ptsphy, interpret=True)
    _assert_close(prec, ref_c, out)


def test_kernel_block_invariance(setup, oracle_pair):
    """Results are bitwise identical for every column block width (the
    NPROMA invariance property, ref: ctest sweeps over NPROMA)."""
    inp, params = setup
    _, fields, _ = oracle_pair
    a = cloudsc_triton(fields, params, inp.ptsphy, interpret=True)
    for block in (64, 256):
        b = cloudsc_triton(fields, params, inp.ptsphy, block=block,
                           interpret=True)
        for name in a._fields:
            np.testing.assert_array_equal(
                np.asarray(getattr(a, name)), np.asarray(getattr(b, name)),
                err_msg=f"{name} @ block {block}",
            )


def test_kernel_levels_above_cloud_top(setup, oracle_pair):
    """Rows above NCLDTOP carry the section-1 values and zero condensate
    tendencies, exactly as in the scan (the JK loop starts at NCLDTOP)."""
    inp, params = setup
    _, fields, ref = oracle_pair
    ktop = int(params.ydecldp.ncldtop) - 1
    assert ktop > 0
    out = cloudsc_triton(fields, params, inp.ptsphy, interpret=True)
    for name in ("plude", "pcovptot", "tendency_loc_t", "tendency_loc_q",
                 "tendency_loc_a"):
        np.testing.assert_array_equal(np.asarray(getattr(out, name))[:ktop],
                                      np.asarray(getattr(ref, name))[:ktop])
    assert not np.asarray(out.tendency_loc_cld)[:, :ktop].any()


@pytest.mark.parametrize("prec", ["fp32", "fp64"])
@pytest.mark.parametrize("cfg", CONFIGS, ids=_cfg_id)
def test_kernel_lowers_for_cuda(setup, prec, cfg):
    """Every scheme configuration, in both precisions, lowers to one Triton
    custom call for CUDA (no card needed to lower)."""
    inp, params = setup
    dtype = jnp.float32 if prec == "fp32" else jnp.float64
    fields = {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
              for k, v in make_inputs(inp, dtype=dtype, host=True).items()}
    lowered = jax.jit(
        lambda f: cloudsc_triton(f, params, inp.ptsphy, cfg)
    ).trace(fields).lower(lowering_platforms=("cuda",))
    text = lowered.as_text()
    assert text.count("__gpu$xla.gpu.triton") == 1


def test_kernel_reads_only_needed_aerosol_rows(setup):
    """The aerosol rows join the kernel's inputs only where the scheme
    configuration reads them."""
    _, params = setup
    from cloudsc_tpu.physics import scheme

    c = scheme.derived_consts(params, 3600.0, jnp.float32)
    names = triton_cloudsc._aerosol_fields(c)
    assert ("pre_ice" in names) == bool(c.LAERICESED)
    assert ("pccn" in names) == bool(c.LAERLIQAUTOLSP or c.LAERLIQCOLL)
