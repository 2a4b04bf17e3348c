"""Arbitrary vertical level counts (the IFS runs L62/L91/L137; the
reference CUDA variant hardcodes KLEV=137, ref: cloudsc_cuda/cloudsc/
cloudsc_c.cu:53 — this framework must not).

Truncating the snapshot's BOTTOM levels yields a physically consistent
shallower atmosphere (monotone pressures, surface = the new last half
level); both engines must run it, agree with each other, and stay finite (the
kernel's level loop takes its bounds from the input's shape)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudsc_tpu.physics import cloudsc, make_inputs


def _truncated(inp, nlev):
    """Cut the atmosphere at `nlev` full levels (keep the top)."""
    fields = {}
    for name, a in inp.fields.items():
        if a.ndim >= 2 and a.shape[-2] == inp.klev:
            fields[name] = np.ascontiguousarray(a[..., :nlev, :])
        elif a.ndim >= 2 and a.shape[-2] == inp.klev + 1:
            fields[name] = np.ascontiguousarray(a[..., :nlev + 1, :])
        else:
            fields[name] = a
    return dataclasses.replace(inp, fields=fields, klev=nlev)


@pytest.mark.parametrize("nlev", [61, 68, 91])
def test_engines_agree_at_any_level_count(input_100, params, nlev):
    from cloudsc_tpu.kernels import cloudsc_triton

    inp = _truncated(input_100, nlev)
    fields = make_inputs(inp, dtype=jnp.float32)
    out_s = jax.jit(lambda f: cloudsc(f, params, inp.ptsphy))(fields)
    out_p = cloudsc_triton(fields, params, inp.ptsphy, interpret=True)
    jax.block_until_ready((out_s, out_p))
    assert out_s.pfplsl.shape == (nlev + 1, 100)
    for name in ("tendency_loc_t", "tendency_loc_q", "pcovptot",
                 "pfplsl", "pfplsn", "plude"):
        a = np.asarray(getattr(out_s, name), dtype=np.float64)
        b = np.asarray(getattr(out_p, name), dtype=np.float64)
        assert np.isfinite(a).all() and np.isfinite(b).all(), name
        maxrel = np.abs(a - b).max() / (np.abs(a).max() + 1e-30)
        assert maxrel < 2e-5, f"{name} @ L{nlev}: kernel vs scan {maxrel}"


# Note: a truncated run is NOT expected to reproduce the full-depth run's
# upper levels — the RHcrit ramp is a function of sigma = p / p_surface
# (ref: cloudsc.F90:1407-1412), and truncation moves the surface, so
# section 3.4b legitimately changes at every level. The cross-engine
# agreement above is the meaningful generality guarantee.
