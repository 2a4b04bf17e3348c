"""Robustness under randomized physically-plausible states.

The golden snapshot exercises one meteorological situation; the guarded
denominators / SIGN tricks the scheme inherits from the Fortran
(ref: cloudsc.F90:2142-2143 and the MAX(x,ZEPSEC) patterns throughout) exist
to survive OTHER states. These property tests perturb the snapshot into
hundreds of distinct column states — warm rain, deep supersaturation,
melting layers, saturated boundary layers — and pin that both engines stay
finite and physical. Complements tests/test_scheme_versions.py's single
synthetic raining state.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cloudsc_tpu.physics import cloudsc, make_inputs


def _perturbed_fields(inp, dtype, seed):
    """Random multiplicative/additive perturbations within physical ranges.

    Pressures, land-sea mask and convection type keep the snapshot values
    (perturbing them risks unphysical, not merely unusual, states); moisture,
    condensates, temperature, convective fluxes and forcings are shaken hard
    enough to flip branch guards (rain presence, melting-layer latch,
    supersaturation, erosion) across columns.
    """
    rng = np.random.default_rng(seed)
    fields = dict(make_inputs(inp, dtype=dtype))

    def mul(name, lo, hi):
        a = np.asarray(fields[name])
        fields[name] = jnp.asarray(
            a * rng.uniform(lo, hi, size=a.shape), dtype=dtype
        )

    # temperature: +-8 K level-correlated shift (branch flips: RTT, RTHOMO,
    # melting layer) — correlated so lapse structure stays plausible
    pt = np.asarray(fields["pt"])
    shift = rng.uniform(-8.0, 8.0, size=(1, pt.shape[1]))
    fields["pt"] = jnp.asarray(pt + shift, dtype=dtype)
    # moisture 0.3-1.7x (sub-saturated through supersaturated)
    mul("pq", 0.3, 1.7)
    # condensates 0-5x per species/level/column, plus seeded rain in the
    # lower troposphere on half the columns (the snapshot has none)
    pclv = np.asarray(fields["pclv"]) * rng.uniform(
        0.0, 5.0, size=fields["pclv"].shape
    )
    nlev, ncol = pclv.shape[-2:]
    rain_cols = rng.random(ncol) < 0.5
    # note: the boolean index axis moves to the FRONT of the selection
    # (separated advanced indices), hence (ncols_true, nlevs) size order
    pclv[2, int(nlev * 0.55):, rain_cols] += rng.uniform(
        0.0, 5e-4, size=(int(rain_cols.sum()), nlev - int(nlev * 0.55))
    )
    fields["pclv"] = jnp.asarray(pclv, dtype=dtype)
    # cloud fraction: random in [0, 1] where the snapshot had any structure
    pa = np.clip(
        np.asarray(fields["pa"]) * rng.uniform(0.0, 2.5, size=fields["pa"].shape),
        0.0, 1.0,
    )
    fields["pa"] = jnp.asarray(pa, dtype=dtype)
    # convection: detrainment/mass fluxes 0-3x, supersat carry 0-4x
    for name in ("plude", "plu", "psnde", "pmfu", "pmfd", "psupsat"):
        mul(name, 0.0, 3.0)
    # dynamical/radiative forcings flipped and scaled (evap vs cond forcing)
    for name in ("pvervel", "phrsw", "phrlw", "pvfl", "pvfi"):
        mul(name, -1.5, 1.5)
    # cumulative tendencies shaken (section-1 state init)
    for name in ("tendency_tmp_t", "tendency_tmp_q", "tendency_tmp_a",
                 "tendency_tmp_cld"):
        mul(name, 0.0, 2.0)
    return fields


FINITE_OUTPUTS = (
    "plude", "pcovptot", "prainfrac_toprfz", "pfplsl", "pfplsn",
    "pfhpsl", "pfhpsn", "pfsqlf", "pfsqif", "pfcqlng", "pfcqnng",
    "pfsqrf", "pfsqsf", "pfcqrng", "pfcqsng", "pfsqltur", "pfsqitur",
    "tendency_loc_t", "tendency_loc_q", "tendency_loc_a", "tendency_loc_cld",
)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scan_engine_finite_and_physical(input_100, params, seed):
    fields = _perturbed_fields(input_100, jnp.float64, seed)
    out = jax.jit(lambda f: cloudsc(f, params, input_100.ptsphy))(fields)
    jax.block_until_ready(out)
    for name in FINITE_OUTPUTS:
        a = np.asarray(getattr(out, name))
        assert np.isfinite(a).all(), f"{name}: NaN/inf under seed {seed}"
    cov = np.asarray(out.pcovptot)
    assert (cov >= 0.0).all() and (cov <= 1.0).all(), "precip cover outside [0,1]"
    rf = np.asarray(out.prainfrac_toprfz)
    assert (rf >= 0.0).all() and (rf <= 1.0).all(), "rain fraction outside [0,1]"
    # tendencies bounded: |dT/dt| < 0.1 K/s even under the hardest shake
    assert np.abs(np.asarray(out.tendency_loc_t)).max() < 0.1


def test_kernel_agrees_on_perturbed_state(input_100, params):
    """The fused kernel (interpret mode, fp32) tracks the scan engine on a
    randomized state that fires the rain/melt/supersat branches the snapshot
    leaves cold — the cross-engine guard off the golden trajectory."""
    from cloudsc_tpu.kernels import cloudsc_triton

    fields = _perturbed_fields(input_100, jnp.float32, seed=3)
    out_s = jax.jit(
        lambda f: cloudsc(f, params, input_100.ptsphy)
    )(fields)
    out_p = cloudsc_triton(fields, params, input_100.ptsphy, interpret=True)
    jax.block_until_ready((out_s, out_p))
    for name in ("tendency_loc_t", "tendency_loc_q", "pcovptot",
                 "pfplsl", "pfplsn"):
        a = np.asarray(getattr(out_s, name), dtype=np.float64)
        b = np.asarray(getattr(out_p, name), dtype=np.float64)
        scale = np.abs(a).max() + 1e-30
        maxrel = np.abs(a - b).max() / scale
        assert maxrel < 2e-5, f"{name}: kernel vs scan maxrel {maxrel}"


def test_validation_table_survives_nonfinite():
    """A NaN/Inf-producing regression must still print the validation table
    with the row flagged — the moment the table matters most. The reference's
    Fortran E20.13 prints NaN/Infinity without raising (validate_mod.F90:292);
    unlike Fortran's silent `NaN > x .eqv. .false.`, we force the `!!!!` flag
    on any non-finite statistic."""
    from cloudsc_tpu.validate import _e20_13, error_line, field_errors

    ref = np.linspace(0.1, 1.0, 64).reshape(8, 8)
    for bad in (np.nan, np.inf, -np.inf):
        field = ref.copy()
        field[3, 4] = bad
        errs = field_errors("PCOVPTOT", field, ref)
        assert errs.flagged, f"non-finite stats not flagged for {bad}"
        line = error_line(errs)  # must not raise
        assert "!!!!" in line
        assert ("NaN" in line) or ("Infinity" in line)
        assert len(line.split()) >= 7
    # formatting unit: exact field width, sign handling
    assert _e20_13(float("nan")).strip() == "NaN"
    assert _e20_13(float("inf")).strip() == "Infinity"
    assert _e20_13(float("-inf")).strip() == "-Infinity"
    assert all(len(_e20_13(v)) == 20
               for v in (float("nan"), float("inf"), float("-inf")))
