"""Alternate scheme versions (ref: cloudsc.F90:562-580 switches).

No golden data exists for the non-default configurations (the reference
hardcodes 2/2/1/1), so these tests pin:
  - finiteness and physical sanity of each alternate,
  - that alternates actually change the answer (not silently ignored),
  - scan-vs-kernel agreement for each configuration (the cross-engine
    consistency test the reference gets from its 14 variants).
"""

import itertools

import jax
import numpy as np
import pytest

from cloudsc_tpu.data import load_input
from cloudsc_tpu.params import Params
from cloudsc_tpu.physics import cloudsc, make_inputs
from cloudsc_tpu.physics.scheme import SchemeConfig
from cloudsc_tpu.kernels import cloudsc_triton

from conftest import REFERENCE_DATA as INPUT_PATH

ALTERNATES = [
    SchemeConfig(iwarmrain=1),
    SchemeConfig(ievaprain=1),
    SchemeConfig(ievapsnow=2),
    SchemeConfig(idepice=2),
]


@pytest.fixture(scope="module")
def setup():
    import jax.numpy as jnp

    inp = load_input(INPUT_PATH, ngptot=100)
    params = Params.from_input(inp)
    fields = make_inputs(inp, dtype=jnp.float64)
    default = jax.jit(lambda f: cloudsc(f, params, inp.ptsphy))(fields)
    return inp, params, fields, default


@pytest.mark.parametrize("cfg", ALTERNATES,
                         ids=lambda c: f"w{c.iwarmrain}r{c.ievaprain}"
                                       f"s{c.ievapsnow}d{c.idepice}")
def test_alternate_finite_and_distinct(setup, cfg):
    inp, params, fields, default = setup
    out = jax.jit(lambda f: cloudsc(f, params, inp.ptsphy, config=cfg))(fields)
    changed = False
    for name, arr in out._asdict().items():
        a = np.asarray(arr)
        assert np.isfinite(a).all(), f"{name} not finite under {cfg}"
        if not np.array_equal(a, np.asarray(getattr(default, name))):
            changed = True
    # the reference snapshot produces zero rain flux (all precip is snow),
    # so the rain-evaporation scheme choice legitimately cannot change the
    # answer for this input
    if cfg.ievaprain == 2:
        assert changed, f"{cfg} produced identical outputs to the default"
    # physical sanity: cloud fraction tendency bounded, precip fluxes >= 0
    assert np.asarray(out.pfplsl).min() >= 0.0
    assert np.asarray(out.pfplsn).min() >= 0.0


@pytest.mark.parametrize("cfg", ALTERNATES,
                         ids=lambda c: f"w{c.iwarmrain}r{c.ievaprain}"
                                       f"s{c.ievapsnow}d{c.idepice}")
def test_alternate_kernel_matches_scan(setup, cfg):
    import jax.numpy as jnp

    inp, params, _, _ = setup
    inp512 = load_input(INPUT_PATH, ngptot=256)
    fields = make_inputs(inp512, dtype=jnp.float32)
    ref = jax.jit(
        lambda f: cloudsc(f, params, inp512.ptsphy, config=cfg)
    )(fields)
    out = cloudsc_triton(fields, params, inp512.ptsphy, config=cfg,
                         interpret=True)
    for name in ref._fields:
        a = np.asarray(getattr(ref, name), dtype=np.float64)
        b = np.asarray(getattr(out, name), dtype=np.float64)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
        assert err < 1e-5, f"{name}: {err:.2e} under {cfg}"


def test_aerosol_couplings_kernel_matches_scan(setup):
    """Synthetically enable the aerosol couplings (off in the snapshot) and
    check scan-vs-kernel agreement — exercises the extra input rows."""
    import copy

    import jax.numpy as jnp

    inp, params, _, _ = setup
    p2 = copy.deepcopy(params)
    p2.ydecldp.laericesed = True
    p2.ydecldp.laericeauto = True
    p2.ydecldp.laerliqautolsp = True
    p2.ydecldp.laerliqcoll = True
    cfg = SchemeConfig(iwarmrain=1)  # the aerosol CCN branches live here

    inp512 = load_input(INPUT_PATH, ngptot=256)
    fields = dict(make_inputs(inp512, dtype=jnp.float32))
    # the snapshot carries zero aerosol fields (the couplings are off in the
    # reference config) — substitute physically plausible values
    shape = fields["pt"].shape
    fields["pccn"] = jnp.full(shape, 125.0, jnp.float32)      # CCN cm-3
    fields["pnice"] = jnp.full(shape, 1.0e4, jnp.float32)     # IN m-3
    fields["pre_ice"] = jnp.full(shape, 50.0e-6, jnp.float32)  # re [m]
    fields["plcrit_aer"] = jnp.full(shape, 5.0e-4, jnp.float32)
    fields["picrit_aer"] = jnp.full(shape, 2.0e-4, jnp.float32)
    ref = jax.jit(lambda f: cloudsc(f, p2, inp512.ptsphy, config=cfg))(fields)
    for name, arr in ref._asdict().items():
        assert np.isfinite(np.asarray(arr)).all(), name
    out = cloudsc_triton(fields, p2, inp512.ptsphy, config=cfg,
                         interpret=True)
    for name in ref._fields:
        a = np.asarray(getattr(ref, name), dtype=np.float64)
        b = np.asarray(getattr(out, name), dtype=np.float64)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
        assert err < 1e-5, f"{name}: {err:.2e}"


def _raining_fields(inp, dtype):
    """Synthetic raining state: the snapshot produces zero rain flux (all
    precip is snow), so the rain-evaporation scheme switch cannot change its
    outputs (ref: cloudsc.F90:2121-2279 only acts in the clear-sky precip
    fraction under falling rain). Seed rain condensate through the warm lower
    troposphere so sedimentation builds a rain flux that evaporates below."""
    import jax.numpy as jnp

    fields = dict(make_inputs(inp, dtype=dtype))
    pclv = np.asarray(fields["pclv"]).copy()
    nlev = pclv.shape[1]
    # rain water through levels ~60% depth down to the surface
    lo = int(nlev * 0.6)
    pclv[2, lo:, :] = 2.0e-4                     # IR slot of (4, nlev, ncol)
    fields["pclv"] = jnp.asarray(pclv, dtype=dtype)
    return fields


def test_rain_evap_schemes_diverge_on_raining_input(setup):
    """ievaprain=1 (Sundqvist, ref: 2121-2184) vs 2 (Abel-Boutle, ref:
    2190-2279) must produce materially different humidity tendencies once
    rain actually falls — proves the Sundqvist branch is wired, which the
    zero-rain snapshot cannot."""
    import jax.numpy as jnp

    inp, params, _, _ = setup
    fields = _raining_fields(inp, jnp.float64)

    outs = {}
    for iev in (1, 2):
        cfg = SchemeConfig(ievaprain=iev)
        out = jax.jit(
            lambda f, c=cfg: cloudsc(f, params, inp.ptsphy, config=c)
        )(fields)
        for name, arr in out._asdict().items():
            assert np.isfinite(np.asarray(arr)).all(), f"{name} iev={iev}"
        outs[iev] = out
    # the synthetic rain must actually reach the flux diagnostics
    assert np.asarray(outs[1].pfplsl).max() > 1.0e-5
    dq = np.abs(
        np.asarray(outs[1].tendency_loc_q) - np.asarray(outs[2].tendency_loc_q)
    ).max()
    scale = np.abs(np.asarray(outs[2].tendency_loc_q)).max()
    assert dq > 1.0e-3 * scale, (
        f"rain-evap alternates indistinguishable: dq={dq:.3e} scale={scale:.3e}"
    )


def test_rain_evap_sundqvist_kernel_matches_scan(setup):
    """Cross-engine agreement for the Sundqvist branch under real rain (the
    snapshot never exercises it in either engine)."""
    import jax.numpy as jnp

    inp, params, _, _ = setup
    inp512 = load_input(INPUT_PATH, ngptot=256)
    fields = _raining_fields(inp512, jnp.float32)
    cfg = SchemeConfig(ievaprain=1)
    ref = jax.jit(lambda f: cloudsc(f, params, inp512.ptsphy, config=cfg))(fields)
    out = cloudsc_triton(fields, params, inp512.ptsphy, config=cfg,
                         interpret=True)
    for name in ref._fields:
        a = np.asarray(getattr(ref, name), dtype=np.float64)
        b = np.asarray(getattr(out, name), dtype=np.float64)
        err = np.abs(a - b).max() / max(np.abs(a).max(), 1e-30)
        assert err < 1e-5, f"{name}: {err:.2e}"
