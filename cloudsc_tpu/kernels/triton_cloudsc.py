"""The fused CLOUDSC column kernel for NVIDIA GPUs (Pallas, Triton route).

The schedule is the reference's fastest GPU variant, CUDA "k-caching"
(ref: src/cloudsc_cuda/cloudsc/cloudsc_c_k_caching.cu:55-77):

  * one program per block of BLOCK columns, one column per thread;
  * the vertical sweep is a loop over levels inside the program;
  * the level-to-level carries and the section-8 running flux sums are
    loop-carried values, so they live in registers;
  * device memory sees only the true inputs (one row per field and level,
    coalesced across the block's columns) and the true outputs (one row per
    field and level, stored as it is produced).

The physics is the shared body of `physics.scheme` (`level_init`,
`initial_carry`, `level_step`), called unchanged on (BLOCK,) rows. Its
dynamic skips (`scheme.inert_skip`) become one branch per block inside the
kernel. Inputs are the plain `physics.make_inputs` field dict; outputs are
`CloudscOutputs`, in the layout of the XLA scan engine (`physics.cloudsc`),
which stays the oracle.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..physics import scheme
from ..physics.cloudsc import CloudscOutputs
from ..physics.scheme import IL, II, IR, IS, IV, NCLV

# One column per thread: 128 columns on 4 warps (measured choice, PERF.md).
BLOCK = 128
NUM_WARPS = 4

# (nlev, ncol) inputs, read one row per level
_LEVEL_FIELDS = (
    "pt", "pq", "pa", "pap", "tendency_tmp_t", "tendency_tmp_q",
    "tendency_tmp_a", "pvfl", "pvfi", "pvervel", "phrsw", "phrlw",
    "pmfu", "pmfd", "plu", "plude", "psnde", "psupsat",
)
_SPECIES_FIELDS = ("pclv", "tendency_tmp_cld")      # (nclv, nlev, ncol)
_COLUMN_FIELDS = ("plsm", "ldcum", "ktype")          # (ncol,)

_LEVEL_OUT = ("plude", "pcovptot", "tendency_loc_t", "tendency_loc_q",
              "tendency_loc_a")
_HALF_OUT = ("pfsqlf", "pfsqif", "pfcqlng", "pfcqnng", "pfsqrf", "pfsqsf",
             "pfcqrng", "pfcqsng", "pfsqltur", "pfsqitur", "pfplsl", "pfplsn",
             "pfhpsl", "pfhpsn")
# section-8 running sums: liquid, ice, their negative corrections, and the
# two VDF fluxes (ref: 2798-2857)
_SUMS = ("lf", "if", "lng", "nng", "ltur", "itur")


def _aerosol_fields(c) -> tuple:
    """The aerosol rows the scheme configuration reads (level_step's
    x["pre_ice"] etc.); the others are never loaded."""
    names = []
    if c.LAERICESED:
        names.append("pre_ice")
    if c.LAERICEAUTO:
        names += ["picrit_aer", "pnice"]
    if c.LAERLIQAUTOLSP or c.LAERLIQCOLL:
        names += ["plcrit_aer", "pccn"]
    return tuple(names)


def _kernel(c, nlev, level_names, *refs):
    n_lev, n_sp = len(level_names), len(_SPECIES_FIELDS)
    n_in = n_lev + n_sp + 1 + len(_COLUMN_FIELDS)
    ins, outs = refs[:n_in], refs[n_in:]
    lev = dict(zip(level_names, ins[:n_lev]))
    spc = dict(zip(_SPECIES_FIELDS, ins[n_lev:n_lev + n_sp]))
    paph_ref = ins[n_lev + n_sp]
    plsm_ref, ldcum_ref, ktype_ref = ins[n_lev + n_sp + 1:]
    o_lev = dict(zip(_LEVEL_OUT, outs[:len(_LEVEL_OUT)]))
    o_cld = outs[len(_LEVEL_OUT)]
    o_half = dict(zip(_HALF_OUT, outs[len(_LEVEL_OUT) + 1:-1]))
    o_prainfrac = outs[-1]

    zqtmst, ptsphy = c.zqtmst, c.ptsphy
    ktop = c.NCLDTOP - 1                      # 0-based first physics level
    paph_surf = paph_ref[nlev, :]
    zero = jnp.zeros_like(paph_surf)
    cols = dict(land=plsm_ref[:] > 0.5, ldcum=ldcum_ref[:] != 0,
                ktype=ktype_ref[:], paph_surf=paph_surf)

    def init_at(k):
        """Section 1 at level k (ref: 654-808)."""
        raw = dict(
            pt=lev["pt"][k, :], pq=lev["pq"][k, :], pa=lev["pa"][k, :],
            pap=lev["pap"][k, :],
            tendency_tmp_t=lev["tendency_tmp_t"][k, :],
            tendency_tmp_q=lev["tendency_tmp_q"][k, :],
            tendency_tmp_a=lev["tendency_tmp_a"][k, :],
            pclv=[spc["pclv"][m, k, :] for m in range(4)],
            tendency_tmp_cld=[spc["tendency_tmp_cld"][m, k, :]
                              for m in range(4)],
        )
        return raw["pap"], scheme.level_init(raw, c)

    def emit(k, ini, sums, pfplsx, *, plude, pcovptot, tend_t, tend_q,
             tend_a, zqxn):
        """Level k's output rows and half-level row k+1 (sections 6 and 8,
        ref: 2722-2773, 2788-2867), in the scan engine's op order. `zqxn`
        None marks a level above NCLDTOP, whose condensate tendency rows
        stay zero as in the Fortran (the JK loop starts at NCLDTOP)."""
        o_lev["plude"][k, :] = plude
        o_lev["pcovptot"][k, :] = pcovptot
        o_lev["tendency_loc_t"][k, :] = tend_t
        o_lev["tendency_loc_q"][k, :] = tend_q
        o_lev["tendency_loc_a"][k, :] = tend_a
        zqx0, zlneg = ini["zqx0"], ini["zlneg"]
        for m in (IL, II, IR, IS):
            o_cld[m, k, :] = (zero if zqxn is None
                              else (zqxn[m] - zqx0[m]) * zqtmst)
        o_cld[IV, k, :] = zero
        if zqxn is None:
            zqxn = [zero] * NCLV

        zgdph_r = -c.zrg_r * (paph_ref[k + 1, :] - paph_ref[k, :]) * zqtmst
        pvfl, pvfi = lev["pvfl"][k, :], lev["pvfi"][k, :]
        zfoealfa = ini["zfoealfa"]
        liq_inc = (zqxn[IL] - zqx0[IL] + pvfl * ptsphy
                   - zfoealfa * plude) * zgdph_r
        ice_inc = (zqxn[II] - zqx0[II] + pvfi * ptsphy
                   - (1.0 - zfoealfa) * plude) * zgdph_r
        rain_inc = (zqxn[IR] - zqx0[IR]) * zgdph_r
        snow_inc = (zqxn[IS] - zqx0[IS]) * zgdph_r
        # rain/snow accumulate onto the liquid/ice flux of the level above
        # (ref: 2818-2819)
        o_half["pfsqrf"][k + 1, :] = sums["lf"] + rain_inc
        o_half["pfsqsf"][k + 1, :] = sums["if"] + snow_inc
        o_half["pfcqrng"][k + 1, :] = sums["lng"] + zlneg[IR] * zgdph_r
        o_half["pfcqsng"][k + 1, :] = sums["nng"] + zlneg[IS] * zgdph_r
        sums = {
            "lf": sums["lf"] + liq_inc,
            "if": sums["if"] + ice_inc,
            "lng": sums["lng"] + zlneg[IL] * zgdph_r,
            "nng": sums["nng"] + zlneg[II] * zgdph_r,
            "ltur": sums["ltur"] + pvfl * ptsphy * zgdph_r,
            "itur": sums["itur"] + pvfi * ptsphy * zgdph_r,
        }
        for name, key in (("pfsqlf", "lf"), ("pfsqif", "if"),
                          ("pfcqlng", "lng"), ("pfcqnng", "nng"),
                          ("pfsqltur", "ltur"), ("pfsqitur", "itur")):
            o_half[name][k + 1, :] = sums[key]
        pfplsl = pfplsx[IR] + pfplsx[IL]
        pfplsn = pfplsx[IS] + pfplsx[II]
        o_half["pfplsl"][k + 1, :] = pfplsl
        o_half["pfplsn"][k + 1, :] = pfplsn
        o_half["pfhpsl"][k + 1, :] = -c.RLVTT * pfplsl
        o_half["pfhpsn"][k + 1, :] = -c.RLSTT * pfplsn
        return sums

    # half-level row 0: no flux enters the top of the atmosphere
    for name in _HALF_OUT:
        o_half[name][0, :] = zero
    o_half["pfhpsl"][0, :] = -c.RLVTT * zero
    o_half["pfhpsn"][0, :] = -c.RLSTT * zero

    sums0 = {key: zero for key in _SUMS}
    carry0 = scheme.initial_carry(zero, c)

    # levels above NCLDTOP: section-1 values pass through, no physics
    def above(k, state):
        sums, _ = state
        pap, ini = init_at(k)
        sums = emit(k, ini, sums, carry0["pfplsx"], plude=lev["plude"][k, :],
                    pcovptot=zero, tend_t=ini["tend_t_pre"],
                    tend_q=ini["tend_q_pre"], tend_a=zero, zqxn=None)
        return sums, (ini["ztp1"], ini["za"], pap)

    if ktop > 0:
        sums, prev = jax.lax.fori_loop(0, ktop, above,
                                       (sums0, (zero, zero, zero)))
    else:
        # the scan reads row jk-1 clamped into range: row 0 itself
        pap0, ini0 = init_at(0)
        sums, prev = sums0, (ini0["ztp1"], ini0["za"], pap0)

    def level(k, state):
        sums, prev, carry = state
        pap, ini = init_at(k)
        kn = jnp.minimum(k + 1, nlev - 1)      # jk+1 reads clamp (masked)
        x = dict(
            ztp1=ini["ztp1"], za=ini["za"], zaorig=ini["zaorig"],
            zqx=ini["zqx"],
            zqsmix=ini["zqsmix"], zqsliq=ini["zqsliq"], zqsice=ini["zqsice"],
            zfoeew=ini["zfoeew"], zfoeewmt=ini["zfoeewmt"],
            zfoeeliqt=ini["zfoeeliqt"], zfoealfa=ini["zfoealfa"],
            zli=ini["zli"], zliqfrac=ini["zliqfrac"], zicefrac=ini["zicefrac"],
            zfoeeliq=ini["zfoeeliq"], zfoeeice=ini["zfoeeice"],
            zfokoop=ini["zfokoop"],
            ztp1_prev=prev[0], za_prev=prev[1], pap=pap, pap_prev=prev[2],
            paph=paph_ref[k, :], paph_next=paph_ref[k + 1, :],
            # the scheme consumes the mass fluxes and heating rates only
            # summed (level_step's x["pmf"] / x["zhr"])
            pmf=lev["pmfu"][k, :] + lev["pmfd"][k, :],
            pmf_next=lev["pmfu"][kn, :] + lev["pmfd"][kn, :],
            plu_next=lev["plu"][kn, :],
            pvervel=lev["pvervel"][k, :],
            zhr=lev["phrsw"][k, :] + lev["phrlw"][k, :],
            plude_in=lev["plude"][k, :], psnde=lev["psnde"][k, :],
            psupsat=lev["psupsat"][k, :],
            tend_t_pre=ini["tend_t_pre"], tend_q_pre=ini["tend_q_pre"],
            not_first=k > ktop, not_last=k < nlev - 1,
            **cols,
        )
        for name in _aerosol_fields(c):
            x[name] = lev[name][k, :]
        carry, ys = scheme.level_step(x, carry, c)
        sums = emit(k, ini, sums, carry["pfplsx"], plude=ys["plude"],
                    pcovptot=ys["pcovptot"], tend_t=ys["tend_t"],
                    tend_q=ys["tend_q"], tend_a=ys["tend_a"],
                    zqxn=ys["zqxn"])
        return sums, (ini["ztp1"], ini["za"], pap), carry

    _, _, carry = jax.lax.fori_loop(ktop, nlev, level, (sums, prev, carry0))
    o_prainfrac[:] = carry["prainfrac"]


def cloudsc_triton(fields: dict, params, ptsphy: float, config=None, *,
                   block: int = BLOCK,
                   interpret: bool = False) -> CloudscOutputs:
    """One CLOUDSC step over all columns with the fused kernel.

    `fields` is the `physics.make_inputs` dict. Columns are padded to a
    multiple of `block` by repeating the last column (padding stays
    physical, so no branch fires on garbage) and the outputs are cut back.
    `block` other than BLOCK is for the block-invariance tests;
    `interpret=True` runs the kernel in the Pallas interpreter (CPU tests).
    """
    pt = fields["pt"]
    dtype = pt.dtype
    nlev, ncol = pt.shape
    c = scheme.derived_consts(params, ptsphy, dtype, config)
    level_names = _LEVEL_FIELDS + _aerosol_fields(c)

    ncol_p = -(-ncol // block) * block

    def pad(a):
        if ncol_p == ncol:
            return a
        return jnp.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, ncol_p - ncol)],
                       mode="edge")

    args = ([pad(fields[n]) for n in level_names]
            + [pad(fields[n]) for n in _SPECIES_FIELDS]
            + [pad(fields["paph"]), pad(fields["plsm"]),
               pad(fields["ldcum"].astype(jnp.int32)),
               pad(fields["ktype"].astype(jnp.int32))])

    def spec(a):
        shape = a.shape[:-1] + (block,)
        lead = (0,) * (a.ndim - 1)
        return pl.BlockSpec(shape, lambda i: (*lead, i))

    lev_s = jax.ShapeDtypeStruct((nlev, ncol_p), dtype)
    half_s = jax.ShapeDtypeStruct((nlev + 1, ncol_p), dtype)
    cld_s = jax.ShapeDtypeStruct((NCLV, nlev, ncol_p), dtype)
    col_s = jax.ShapeDtypeStruct((ncol_p,), dtype)
    out_shape = ([lev_s] * len(_LEVEL_OUT) + [cld_s]
                 + [half_s] * len(_HALF_OUT) + [col_s])

    outs = pl.pallas_call(
        lambda *refs: _kernel(c, nlev, level_names, *refs),
        out_shape=out_shape,
        grid=(ncol_p // block,),
        in_specs=[spec(a) for a in args],
        out_specs=[spec(s) for s in out_shape],
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=NUM_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="cloudsc_k_caching",
    )(*args)
    named = dict(zip(_LEVEL_OUT + ("tendency_loc_cld",) + _HALF_OUT
                     + ("prainfrac_toprfz",), outs))
    return CloudscOutputs(**{k: v[..., :ncol] for k, v in named.items()})
