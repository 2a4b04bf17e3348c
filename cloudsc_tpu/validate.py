"""Golden-file validation: per-field error norms + the reference's table format.

Reproduces the statistics and stdout format of the reference validator so the
output is directly comparable (and JUBE-parseable):
  per field: min, max, AbsMaxErr, AvgAbsErr/GP, MaxRelErr-%
  with a ' !!!!' flag when the relative error exceeds 10*machine-eps
(ref: src/common/module/validate_mod.F90:263-296; header print
 ref: src/common/module/cloudsc_global_state_mod.F90:296-299).

In a multi-device run the norms are reduced across the mesh with psum/pmin/pmax —
this program's equivalent of the reference's MPI reductions
(ref: validate_mod.F90:148-151); see runtime/dist.py.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# validation order and field dimensionality (ref: cloudsc_global_state_mod.F90:324-345)
VALIDATION_ORDER = [
    ("PLUDE", 2), ("PCOVPTOT", 2), ("PRAINFRAC_TOPRFZ", 1),
    ("PFSQLF", 2), ("PFSQIF", 2), ("PFCQLNG", 2), ("PFCQNNG", 2),
    ("PFSQRF", 2), ("PFSQSF", 2), ("PFCQRNG", 2), ("PFCQSNG", 2),
    ("PFSQLTUR", 2), ("PFSQITUR", 2),
    ("PFPLSL", 2), ("PFPLSN", 2), ("PFHPSL", 2), ("PFHPSN", 2),
    ("TENDENCY_LOC%A", 2), ("TENDENCY_LOC%Q", 2), ("TENDENCY_LOC%T", 2),
    ("TENDENCY_LOC%CLD", 3),
]

# output-struct attribute for each validated name
FIELD_ATTR = {
    "PLUDE": "plude", "PCOVPTOT": "pcovptot",
    "PRAINFRAC_TOPRFZ": "prainfrac_toprfz",
    "PFSQLF": "pfsqlf", "PFSQIF": "pfsqif",
    "PFCQLNG": "pfcqlng", "PFCQNNG": "pfcqnng",
    "PFSQRF": "pfsqrf", "PFSQSF": "pfsqsf",
    "PFCQRNG": "pfcqrng", "PFCQSNG": "pfcqsng",
    "PFSQLTUR": "pfsqltur", "PFSQITUR": "pfsqitur",
    "PFPLSL": "pfplsl", "PFPLSN": "pfplsn",
    "PFHPSL": "pfhpsl", "PFHPSN": "pfhpsn",
    "TENDENCY_LOC%A": "tendency_loc_a",
    "TENDENCY_LOC%Q": "tendency_loc_q",
    "TENDENCY_LOC%T": "tendency_loc_t",
    "TENDENCY_LOC%CLD": "tendency_loc_cld",
}

REF_DATASET = {name: name.replace("%", "_") for name in FIELD_ATTR}


@dataclasses.dataclass
class FieldErrors:
    name: str
    ndim: int
    minval: float
    maxval: float
    maxerr: float
    errsum: float
    refsum: float
    avgpgp: float
    # epsilon of the WORKING precision: the reference's threshold is
    # 10*EPSILON(1.0_JPRB), i.e. sp eps in a single-precision build
    # (ref: validate_mod.F90:270,289) — an fp32 run must not be flagged
    # against the fp64 bar.
    eps: float = float(np.finfo(np.float64).eps)

    @property
    def relerr(self) -> float:
        """Relative error variant selection (ref: validate_mod.F90:273-283)."""
        if self.errsum < self.eps:
            return 0.0
        if self.refsum < self.eps:
            return self.errsum / (1.0 + self.refsum)
        return self.errsum / self.refsum

    @property
    def flagged(self) -> bool:
        # a NaN/Inf anywhere in the stats is the worst possible mismatch —
        # flag it (NaN would otherwise compare False and slip through); the
        # reference's Fortran prints non-finite values and relies on the
        # same > comparison, which silently UNflags NaN — we deviate here
        # on purpose: the table must scream exactly when physics produced
        # non-finite output (ref: validate_mod.F90:287-290)
        import math

        if not all(map(math.isfinite, (self.maxerr, self.errsum, self.refsum))):
            return True
        return self.relerr > 10.0 * self.eps


def field_errors(name: str, field, ref, ngptotg: int | None = None) -> FieldErrors:
    """Error statistics for one field (ref: validate_mod.F90 VALIDATE_R1/R2/R3).

    Large fields take the threaded C++ single-pass path (the analogue of the
    reference's native cloudsc_validate.c); numpy otherwise.
    """
    field = np.asarray(field)
    work_eps = float(np.finfo(field.dtype).eps) if np.issubdtype(
        field.dtype, np.floating) else float(np.finfo(np.float64).eps)
    field = field.astype(np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    n = ngptotg if ngptotg is not None else field.shape[-1]
    stats = None
    if field.size > (1 << 20) and field.shape == ref.shape:
        from .native import field_stats_native

        stats = field_stats_native(field, ref)
    if stats is None:
        diff = np.abs(field - ref)
        stats = (
            float(field.min()), float(field.max()), float(diff.max()),
            float(diff.sum()), float(np.abs(ref).sum()),
        )
    minval, maxval, maxerr, errsum, refsum = stats
    return FieldErrors(
        name=name,
        ndim=field.ndim,
        minval=float(minval),
        maxval=float(maxval),
        maxerr=float(maxerr),
        errsum=float(errsum),
        refsum=float(refsum),
        avgpgp=float(errsum / n),
        eps=work_eps,
    )


def _e20_13(x: float) -> str:
    """Fortran E20.13 formatting: 0.XXXXXXXXXXXXXE+ee in a 20-char field.

    Non-finite values print like gfortran's E edit descriptor ("NaN",
    "Infinity", "-Infinity" right-justified) instead of raising — a
    NaN-producing regression must still render the validation table
    (ref: validate_mod.F90:292-294 prints whatever the norms are)."""
    import math

    if math.isnan(x):
        return "NaN".rjust(20)
    if math.isinf(x):
        return ("-Infinity" if x < 0 else "Infinity").rjust(20)
    if x == 0.0:
        return "0.0000000000000E+00".rjust(20)

    neg = x < 0.0
    ax = abs(x)
    exp = int(math.floor(math.log10(ax))) + 1
    mant = ax / 10.0**exp
    # rounding may push the mantissa to 1.0
    mant_str = f"{mant:.13f}"
    if mant_str.startswith("1"):
        exp += 1
        mant = ax / 10.0**exp
        mant_str = f"{mant:.13f}"
    body = f"0.{mant_str[2:]}E{exp:+03d}"
    if neg:
        body = "-" + body
    return body.rjust(20)


def error_line(errs: FieldErrors) -> str:
    """One validation row (ref: validate_mod.F90:292-294 format 1000)."""
    relerr = errs.relerr
    iopt = 1 if errs.errsum < errs.eps else (
        2 if errs.refsum < errs.eps else 3
    )
    clwarn = " !!!!" if errs.flagged else ""
    vals = "".join(
        " " + _e20_13(v)
        for v in (errs.minval, errs.maxval, errs.maxerr, errs.avgpgp, 100.0 * relerr)
    )
    return f" {errs.name:<20s} {errs.ndim}D{iopt}{vals}{clwarn}"


def validation_header() -> str:
    names = ["MinValue", "MaxValue", "AbsMaxErr", "AvgAbsErr/GP", "MaxRelErr-%"]
    return " " + f"{'Variable':<20s} {'Dim':<3s}" + "".join(f" {n:<20s}" for n in names)


def validate_outputs(outputs, reference: dict, ngptotg: int | None = None,
                     print_table: bool = True,
                     multiprocess: bool = False) -> list[FieldErrors]:
    """Validate a CloudscOutputs struct against the reference dict.

    With `multiprocess=True` the per-field norms are allreduced across
    jax processes before the table is built (the MPI-reduced global table of
    the reference, ref: validate_mod.F90:148-151); every process returns the
    same global statistics, and the caller gates printing to rank 0.
    """
    results = []
    rows = []
    for name, _ in VALIDATION_ORDER:
        got = np.asarray(getattr(outputs, FIELD_ATTR[name]))
        want = np.asarray(reference[REF_DATASET[name]])
        errs = field_errors(name, got, want, ngptotg=ngptotg)
        rows.append([errs.minval, errs.maxval, errs.maxerr,
                     errs.errsum, errs.refsum])
        results.append(errs)
    if multiprocess:
        from .runtime.dist import allreduce_field_norms

        reduced = allreduce_field_norms(np.asarray(rows, dtype=np.float64))
        n = float(ngptotg) if ngptotg else 1.0
        results = [
            dataclasses.replace(
                e, minval=r[0], maxval=r[1], maxerr=r[2],
                errsum=r[3], refsum=r[4], avgpgp=r[3] / n,
            )
            for e, r in zip(results, reduced)
        ]
    if print_table:
        lines = [validation_header()]
        lines += [error_line(errs) for errs in results]
        print("\n".join(lines))
    return results


def device_field_norms(outputs, reference: dict):
    """All 21 fields' (min, max, maxerr, errsum, refsum) computed ON DEVICE in
    one jitted program — the mesh-run validation path.

    The reference never gathers field data for validation; it reduces norms
    (ref: validate_mod.F90:148-151). Accelerator and mesh runs do the same:
    they reduce on device and fetch only the (21, 5) result, never the
    gigabytes of output fields. `reference` arrays must already be on device with the
    same sharding as the outputs. Sums run in fp64 where x64 is enabled
    (CPU meshes), else the working precision.
    """
    import jax
    import jax.numpy as jnp

    @jax.jit
    def norms(outs, refs):
        rows = []
        for name, _ in VALIDATION_ORDER:
            f = getattr(outs, FIELD_ATTR[name])
            r = refs[REF_DATASET[name]]
            f = f[..., : r.shape[-1]]  # drop tile/mesh padding columns
            d = jnp.abs(f - r)
            rows.append(jnp.stack([
                jnp.min(f), jnp.max(f), jnp.max(d),
                jnp.sum(d), jnp.sum(jnp.abs(r)),
            ]))
        return jnp.stack(rows)

    return norms(outputs, reference)


def validate_from_norms(norms: np.ndarray, ngptotg: int,
                        print_table: bool = True,
                        multiprocess: bool = False,
                        work_eps: float | None = None) -> list[FieldErrors]:
    """Build the validation table from precomputed (21, 5) norm rows
    (device-side path); optionally allreduce across processes first.
    `work_eps` is the run's working-precision epsilon (fp32 runs flag at
    10*sp-eps like the reference's SINGLE build, ref: validate_mod.F90:270)."""
    norms = np.asarray(norms, dtype=np.float64)
    if work_eps is None:
        work_eps = float(np.finfo(np.float64).eps)
    if multiprocess:
        from .runtime.dist import allreduce_field_norms

        norms = allreduce_field_norms(norms)
    results = []
    for (name, ndim_hint), r in zip(VALIDATION_ORDER, norms):
        results.append(FieldErrors(
            name=name, ndim=ndim_hint, minval=float(r[0]), maxval=float(r[1]),
            maxerr=float(r[2]), errsum=float(r[3]), refsum=float(r[4]),
            avgpgp=float(r[3]) / float(ngptotg), eps=work_eps,
        ))
    if print_table:
        lines = [validation_header()]
        lines += [error_line(errs) for errs in results]
        print("\n".join(lines))
    return results
