"""Golden-file validation at the reference workload (100 cols x 137 levels).

This is the reference's entire test strategy (golden diff vs reference.h5,
ref: SURVEY.md section 4): fp64 on CPU must match at ulp level, fp32 to ~1e-6.

fp64 error attribution (bench/fp64_attribution.py): on CPU the worst field's
errsum/refsum is 2.4e-15 (PFHPSN) and a 1-ulp perturbation of jnp.exp moves
the outputs MORE than the observed vs-reference residual — so the residual is
transcendental-ulp noise between gfortran's and XLA's libm, irreducible by
op-order changes. The CPU run (cli --platform cpu) is the golden surface.
"""

import jax
import numpy as np
import pytest

from conftest import relerr

from cloudsc_tpu.validate import FIELD_ATTR, REF_DATASET, VALIDATION_ORDER

# ulp-level bar, ~100x tighter than the round-1 back-fitted 5e-12. Measured
# worst cases: PFHPSN 2.4e-15; PFSQLF/PFSQRF 1.9e-14 — but their absolute
# errsum is 2e-17, BELOW machine eps (the reference's own metric floors that
# to zero, ref: validate_mod.F90:273-283), inflated only by a heavily
# cancelling ~1e-3 refsum.
FP64_TOL = 5.0e-14
# fp32 tolerances on the errsum/refsum metric. The cumulative flux diagnostics
# (PFSQ*/PFCQ*) and the CLD/Q tendencies have tiny reference sums with heavy
# cancellation, so single precision legitimately loses several digits there;
# the reference itself never validates its SINGLE build (CI compiles it without
# ctest, ref: .github/workflows/build.yml:172). Prognostic fields are tight.
FP32_TOL_DEFAULT = 2.0e-2
FP32_TOL = {
    "PFSQLF": 0.5, "PFSQIF": 0.5, "PFSQRF": 0.5, "PFSQSF": 0.5,
    "PFCQLNG": 0.5, "PFCQNNG": 0.5, "PFCQRNG": 0.5, "PFCQSNG": 0.5,
    "TENDENCY_LOC%CLD": 0.1, "TENDENCY_LOC%Q": 0.05,
}


@pytest.mark.parametrize("name", [n for n, _ in VALIDATION_ORDER])
def test_golden_fp64(golden_outputs_fp64, reference_100, name):
    got = np.asarray(getattr(golden_outputs_fp64, FIELD_ATTR[name]))
    want = reference_100[REF_DATASET[name]]
    assert got.shape == want.shape
    assert relerr(got, want) < FP64_TOL, f"{name} exceeds fp64 tolerance"


def test_golden_fp32(input_100, params, reference_100):
    import jax.numpy as jnp

    from cloudsc_tpu.physics import cloudsc, make_inputs

    fields = make_inputs(input_100, dtype=jnp.float32)
    fn = jax.jit(lambda f: cloudsc(f, params, input_100.ptsphy))
    out = jax.block_until_ready(fn(fields))
    bad = {}
    for name, _ in VALIDATION_ORDER:
        got = np.asarray(getattr(out, FIELD_ATTR[name]))
        want = reference_100[REF_DATASET[name]]
        err = relerr(got, want)
        if err > FP32_TOL.get(name, FP32_TOL_DEFAULT):
            bad[name] = err
    assert not bad, f"fp32 fields over tolerance: {bad}"


def test_outputs_finite(golden_outputs_fp64):
    for name, arr in golden_outputs_fp64._asdict().items():
        assert np.isfinite(np.asarray(arr)).all(), f"{name} has non-finite values"


def test_golden_fp64_flag_count(golden_outputs_fp64, reference_100):
    """Pin the validation-table `!!!!` count on the CPU fp64 surface.

    The reference's own reruns show 0 flags (bar: relerr <= 10*eps,
    ref: validate_mod.F90:287-289, output-example/GNU.haswell.out tail). Our
    CPU fp64 run sits at the same bar except PFHPSN, whose 2.4e-15 residual
    marginally exceeds 2.2e-16*10 and is attributed to libm ulp differences
    (see module docstring). Pinning the count catches silent degradations that
    would otherwise hide inside a loose tolerance."""
    from cloudsc_tpu.validate import validate_outputs

    errs = validate_outputs(golden_outputs_fp64,
                            {k: reference_100[k] for k in
                             (n.replace("%", "_") for n, _ in VALIDATION_ORDER)},
                            ngptotg=100, print_table=False)
    flagged = [e.name for e in errs if e.flagged]
    assert len(flagged) <= 1, f"fp64 flag count regressed: {flagged}"


def test_flag_threshold_uses_working_precision():
    """The `!!!!` threshold is 10*EPSILON(1.0_JPRB) — the WORKING precision's
    epsilon (ref: validate_mod.F90:270,289): an sp build flags at 10*sp-eps,
    not the fp64 bar. A relative error of ~1e-9 is beyond 10*fp64-eps but
    well inside 10*sp-eps, so the same numbers must flag as fp64 input and
    pass as fp32 input."""
    import numpy as np

    from cloudsc_tpu.validate import field_errors

    ref = np.linspace(1.0, 2.0, 4096)
    noise = 1e-9 * ref
    e64 = field_errors("X", ref + noise, ref)
    assert e64.flagged and e64.relerr > 0
    # identical VALUES presented at fp32 working precision: compute the
    # stats from the fp64 field but stamp the fp32 eps the way field_errors
    # does for an fp32 array (the cast itself would add ~1e-7 error)
    e32 = field_errors("X", (ref + noise).astype(np.float32), ref)
    assert e32.eps == float(np.finfo(np.float32).eps)
    assert e32.relerr < 10.0 * e32.eps  # cast error ~eps, threshold 10*eps
    assert not e32.flagged
