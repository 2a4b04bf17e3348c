"""The CLOUDSC prognostic cloud microphysics scheme as an XLA program.

This is the XLA execution engine for the scheme and the oracle of the fused
GPU kernel (`kernels.triton_cloudsc`): the physics itself lives in
`scheme.py`, which both share. The behavioral spec is
src/cloudsc_fortran/cloudsc.F90 in the reference (ref: line numbers point
there). Structure, redesigned for XLA:

  precompute   sections 0-2 — state init, tiny-value clipping, saturation
               curves, tropopause — `level_init` batched over (lev, col)
               [ref: 548-843]
  level scan   sections 3-6 — one `lax.scan` over the vertical calling
               `level_step`, carrying exactly the JK->JK+1 recurrences
               (precip flux row, new cloud fraction/species from the level
               above, precip cover memory, cloud-top distance, rain-freeze
               latch)                                          [ref: 854-2775]
  postcompute  section 8 — cumulative half-level flux diagnostics as
               cumsums over levels                             [ref: 2780-2867]

Columns live on the trailing, contiguous axis and are embarrassingly
parallel, so the scheme vmaps/shards over them trivially.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from . import scheme
from .scheme import IL, II, IR, IS, IV, NCLV


class CloudscOutputs(NamedTuple):
    plude: jax.Array              # (nlev, ncol)   scaled detrainment (inout)
    pcovptot: jax.Array           # (nlev, ncol)   precip fraction
    prainfrac_toprfz: jax.Array   # (ncol,)        rain frac at top of refreeze layer
    pfsqlf: jax.Array             # (nlev+1, ncol) flux of liquid
    pfsqif: jax.Array             # (nlev+1, ncol) flux of ice
    pfcqlng: jax.Array            # (nlev+1, ncol) -ve correction, liquid
    pfcqnng: jax.Array            # (nlev+1, ncol) -ve correction, ice
    pfsqrf: jax.Array             # (nlev+1, ncol) flux of rain
    pfsqsf: jax.Array             # (nlev+1, ncol) flux of snow
    pfcqrng: jax.Array            # (nlev+1, ncol) -ve correction, rain
    pfcqsng: jax.Array            # (nlev+1, ncol) -ve correction, snow
    pfsqltur: jax.Array           # (nlev+1, ncol) VDF liquid flux
    pfsqitur: jax.Array           # (nlev+1, ncol) VDF ice flux
    pfplsl: jax.Array             # (nlev+1, ncol) liq+rain sedimentation flux
    pfplsn: jax.Array             # (nlev+1, ncol) ice+snow sedimentation flux
    pfhpsl: jax.Array             # (nlev+1, ncol) enthalpy flux, liquid
    pfhpsn: jax.Array             # (nlev+1, ncol) enthalpy flux, ice
    tendency_loc_t: jax.Array     # (nlev, ncol)
    tendency_loc_q: jax.Array     # (nlev, ncol)
    tendency_loc_a: jax.Array     # (nlev, ncol)
    tendency_loc_cld: jax.Array   # (nclv, nlev, ncol) — vapour slot zero


def make_inputs(inp, dtype=jnp.float64, column_order: str = "cyclic",
                column_perm=None, host: bool = False) -> dict:
    """Convert a loaded InputData into the field dict cloudsc() consumes.

    host=True keeps the arrays in NumPy, so the caller times (or shards) the
    transfer to the device itself.

    Accepts unexpanded InputData (load_input(expand=False)): fields are
    cast at file width FIRST, then expanded — the cheap order (a fp32
    expand writes half the bytes of expand-then-cast). column_order selects
    the expansion layout (data.expand.expand_field): "grouped" is the
    activity-grouped permutation the fused kernel's per-block skips prefer;
    column_perm (grouped only) pre-permutes the source columns (activity
    sorting)."""
    import numpy as np

    from ..data.expand import expand_field

    if column_perm is not None and column_order != "grouped":
        raise ValueError("column_perm requires column_order='grouped'")
    f = inp.fields
    ngptot = inp.ngptot

    def cast(name, to=None):
        a = np.asarray(f[name])
        to = np.dtype(to if to is not None else np.dtype(dtype))
        if a.dtype != to:
            a = a.astype(to)
        if a.shape[-1] != ngptot:
            if column_perm is not None:
                a = a[..., column_perm]
            a = expand_field(a, ngptot, order=column_order)
        return a if host else jnp.asarray(a)

    return {
        "pt": cast("PT"), "pq": cast("PQ"),
        "tendency_tmp_t": cast("TENDENCY_TMP_T"),
        "tendency_tmp_q": cast("TENDENCY_TMP_Q"),
        "tendency_tmp_a": cast("TENDENCY_TMP_A"),
        "tendency_tmp_cld": cast("TENDENCY_TMP_CLD"),
        "pvfa": cast("PVFA"), "pvfl": cast("PVFL"), "pvfi": cast("PVFI"),
        "pdyna": cast("PDYNA"), "pdynl": cast("PDYNL"), "pdyni": cast("PDYNI"),
        "phrsw": cast("PHRSW"), "phrlw": cast("PHRLW"),
        "pvervel": cast("PVERVEL"), "pap": cast("PAP"), "paph": cast("PAPH"),
        "plsm": cast("PLSM"),
        "ldcum": cast("LDCUM", to=bool),
        "ktype": cast("KTYPE", to="int32"),
        "plu": cast("PLU"), "plude": cast("PLUDE"), "psnde": cast("PSNDE"),
        "pmfu": cast("PMFU"), "pmfd": cast("PMFD"),
        "pa": cast("PA"), "pclv": cast("PCLV"), "psupsat": cast("PSUPSAT"),
        "plcrit_aer": cast("PLCRIT_AER"), "picrit_aer": cast("PICRIT_AER"),
        "pre_ice": cast("PRE_ICE"), "pccn": cast("PCCN"), "pnice": cast("PNICE"),
    }


def cloudsc(fields: dict, params, ptsphy: float, config=None) -> CloudscOutputs:
    """One CLOUDSC step over all columns. Jit with params/ptsphy baked in, e.g.
    `jax.jit(lambda f: cloudsc(f, params, ptsphy))`. `config` selects the
    scheme versions (scheme.SchemeConfig; reference defaults when None).
    `fields` is the make_inputs field dict.
    """
    pt = fields["pt"]
    dtype = pt.dtype
    nlev, ncol = pt.shape
    c = scheme.derived_consts(params, ptsphy, dtype, config)

    # ==================================================================
    # 1. INITIAL VALUES (ref: 654-808) — level_init batched over (lev, col)
    # ==================================================================
    raw = dict(
        pt=pt, pq=fields["pq"], pa=fields["pa"], pap=fields["pap"],
        tendency_tmp_t=fields["tendency_tmp_t"],
        tendency_tmp_q=fields["tendency_tmp_q"],
        tendency_tmp_a=fields["tendency_tmp_a"],
        pclv=[fields["pclv"][m] for m in range(4)],
        tendency_tmp_cld=[fields["tendency_tmp_cld"][m] for m in range(4)],
    )
    ini = scheme.level_init(raw, c)

    # The scan closes over the full (nlev, ncol) arrays and dynamic-slices the
    # rows it needs (jk, jk-1, jk+1) — no shifted/stacked xs copies are ever
    # materialized, which matters at benchmark sizes (dozens of ~90MB arrays).
    # Out-of-range jk+1 reads clamp to the last row; every consumer masks them
    # with `not_last`, mirroring the Fortran IF(JK<KLEV) guards.
    closure = dict(
        ztp1=ini["ztp1"], za=ini["za"], zaorig=ini["zaorig"],
        zqsmix=ini["zqsmix"], zqsliq=ini["zqsliq"], zqsice=ini["zqsice"],
        zfoeew=ini["zfoeew"], zfoeewmt=ini["zfoeewmt"],
        zfoeeliqt=ini["zfoeeliqt"],
        zfoealfa=ini["zfoealfa"], zli=ini["zli"],
        zliqfrac=ini["zliqfrac"], zicefrac=ini["zicefrac"],
        zfoeeliq=ini["zfoeeliq"], zfoeeice=ini["zfoeeice"],
        zfokoop=ini["zfokoop"],
        pap=fields["pap"], paph=fields["paph"],
        # the scheme only ever consumes these summed (scheme.level_step) —
        # hoisting the adds here is bitwise-neutral (same IEEE adds, once)
        pmf=fields["pmfu"] + fields["pmfd"],
        zhr=fields["phrsw"] + fields["phrlw"],
        pvervel=fields["pvervel"],
        plude_in=fields["plude"], plu=fields["plu"], psnde=fields["psnde"],
        psupsat=fields["psupsat"],
        tend_t_pre=ini["tend_t_pre"], tend_q_pre=ini["tend_q_pre"],
        pre_ice=fields["pre_ice"], picrit_aer=fields["picrit_aer"],
        pnice=fields["pnice"], plcrit_aer=fields["plcrit_aer"],
        pccn=fields["pccn"],
    )
    zqx0, zlneg, zfoealfa = ini["zqx0"], ini["zlneg"], ini["zfoealfa"]
    tend_t_full, tend_q_full = ini["tend_t_pre"], ini["tend_q_pre"]
    plude_in_full = fields["plude"]
    pvfl, pvfi = fields["pvfl"], fields["pvfi"]
    pap, paph = closure["pap"], closure["paph"]
    ztp1_full = closure["ztp1"]
    paph_surf = paph[nlev]
    land, ldcum, ktype = fields["plsm"] > 0.5, fields["ldcum"], fields["ktype"]
    _zqx_full = ini["zqx"]

    ktop = c.NCLDTOP - 1           # 0-based first scan level
    zqtmst = c.zqtmst
    zeros2 = jnp.zeros((nlev, ncol), dtype)

    # ==================================================================
    # 2. tropopause level (ref: 821-832) — diagnostic only in this config
    # ==================================================================
    ztp1 = ztp1_full
    zsig = pap / paph_surf[None, :]
    trop_cond = (zsig[:-1] > 0.1) & (zsig[:-1] < 0.4) & (ztp1[:-1] > ztp1[1:])
    rev = trop_cond[::-1]
    last_idx = (nlev - 2) - jnp.argmax(rev, axis=0)
    ztrpaus = jnp.where(
        trop_cond.any(axis=0),
        jnp.take_along_axis(zsig[:-1], last_idx[None, :], axis=0)[0],
        0.1,
    )
    del ztrpaus  # retained for parity; unused since CY37R1 (ref: 1414-1419)

    # ==================================================================
    # 3-6. THE VERTICAL SCAN (ref: 854-2775)
    # ==================================================================
    def make_x(k):
        """Per-level view: rows at jk (and jk-1 / jk+1 where the scheme needs)."""
        row = lambda name, off=0: jax.lax.dynamic_index_in_dim(
            closure[name], k + off, axis=0, keepdims=False
        )
        x = {
            "ztp1": row("ztp1"), "ztp1_prev": row("ztp1", -1),
            "za": row("za"), "za_prev": row("za", -1), "zaorig": row("zaorig"),
            "zqx": [
                jax.lax.dynamic_index_in_dim(_zqx_full[m], k, 0, keepdims=False)
                for m in range(NCLV)
            ],
            "zqsmix": row("zqsmix"), "zqsliq": row("zqsliq"),
            "zqsice": row("zqsice"), "zfoeew": row("zfoeew"),
            "zfoeewmt": row("zfoeewmt"), "zfoeeliqt": row("zfoeeliqt"),
            "zfoealfa": row("zfoealfa"), "zli": row("zli"),
            "zliqfrac": row("zliqfrac"), "zicefrac": row("zicefrac"),
            "zfoeeliq": row("zfoeeliq"), "zfoeeice": row("zfoeeice"),
            "zfokoop": row("zfokoop"),
            "pap": row("pap"), "pap_prev": row("pap", -1),
            "paph": row("paph"), "paph_next": row("paph", 1),
            "pmf": row("pmf"), "pmf_next": row("pmf", 1),
            "pvervel": row("pvervel"), "zhr": row("zhr"),
            "plude_in": row("plude_in"), "plu_next": row("plu", 1),
            "psnde": row("psnde"), "psupsat": row("psupsat"),
            "tend_t_pre": row("tend_t_pre"), "tend_q_pre": row("tend_q_pre"),
            "paph_surf": paph_surf, "land": land,
            "ldcum": ldcum, "ktype": ktype,
            "not_first": k > ktop,
            "not_last": k < nlev - 1,
        }
        if c.LAERICESED:
            x["pre_ice"] = row("pre_ice")
        if c.LAERICEAUTO:
            x["picrit_aer"] = row("picrit_aer")
            x["pnice"] = row("pnice")
        if c.LAERLIQAUTOLSP or c.LAERLIQCOLL:
            x["plcrit_aer"] = row("plcrit_aer")
            x["pccn"] = row("pccn")
        return x

    xs = jnp.arange(ktop, nlev, dtype=jnp.int32)
    sl = slice(ktop, nlev)
    carry0 = scheme.initial_carry(ztp1_full[0], c)

    def step(carry, k):
        new_carry, ys = scheme.level_step(make_x(k), carry, c)
        ys = dict(ys)
        ys["zqxn"] = jnp.stack(ys["zqxn"])
        ys["pfplsx_next"] = jnp.stack(ys["pfplsx_next"])
        return new_carry, ys

    # unroll: XLA fuses across consecutive levels (fewer loop-boundary
    # materializations of the ~40-array carry/slice working set). Value- and
    # order-exact — the per-level ops are unchanged, only the loop structure
    # differs — so the fp64 goldens hold bitwise. GPU: measured at 163,840
    # columns on an H100 (PERF.md), unroll 2 and 4 both run ~3% faster than
    # 1 in fp32 and fp64, and 4 doubles the compile time of 2, so 2. CPU:
    # 4 in fp64, 1 in fp32 (CPU A/B). CLOUDSC_SCAN_UNROLL overrides.
    if jax.default_backend() == "gpu":
        default_unroll = "2"
    else:
        default_unroll = "4" if dtype == jnp.float64 else "1"
    unroll = int(os.environ.get("CLOUDSC_SCAN_UNROLL", default_unroll))
    carry_end, ys = jax.lax.scan(step, carry0, xs, unroll=unroll)

    # ==================================================================
    # assemble full-level arrays
    # ==================================================================
    zqxn2d = [zeros2.at[sl].set(ys["zqxn"][:, m]) for m in range(NCLV)]
    plude = plude_in_full.at[sl].set(ys["plude"])
    pcovptot = zeros2.at[sl].set(ys["pcovptot"])
    tend_t = tend_t_full.at[sl].set(ys["tend_t"])
    tend_q = tend_q_full.at[sl].set(ys["tend_q"])
    tend_a = zeros2.at[sl].set(ys["tend_a"])
    tend_cld = jnp.zeros((NCLV, nlev, ncol), dtype)
    for m in (IL, II, IR, IS):
        tend_cld = tend_cld.at[m, sl].set(
            (ys["zqxn"][:, m] - zqx0[m][sl]) * zqtmst
        )

    # generalized precip flux on half levels: rows 0..ktop are zero, row jk+1
    # comes from scan step jk (ref: 687, 2698-2702)
    zpfplsx = jnp.concatenate(
        [jnp.zeros((ktop + 1, NCLV, ncol), dtype), ys["pfplsx_next"]], axis=0
    )

    # ==================================================================
    # 8. flux diagnostics (ref: 2788-2867)
    # ==================================================================
    pfplsl = zpfplsx[:, IR] + zpfplsx[:, IL]
    pfplsn = zpfplsx[:, IS] + zpfplsx[:, II]

    zgdph_r = -c.zrg_r * (paph[1:] - paph[:-1]) * zqtmst  # (nlev, ncol)
    liq_inc = (
        zqxn2d[IL] - zqx0[IL] + pvfl * ptsphy - zfoealfa * plude
    ) * zgdph_r
    ice_inc = (
        zqxn2d[II] - zqx0[II] + pvfi * ptsphy - (1.0 - zfoealfa) * plude
    ) * zgdph_r
    rain_inc = (zqxn2d[IR] - zqx0[IR]) * zgdph_r
    snow_inc = (zqxn2d[IS] - zqx0[IS]) * zgdph_r

    def half_cumsum(inc):
        """PF(jk+1) = sum_{j<=jk} inc(j); PF(0)=0 (ref: 2798-2857)."""
        cum = jnp.cumsum(inc, axis=0)
        return jnp.concatenate([jnp.zeros((1, ncol), dtype), cum], axis=0)

    pfsqlf = half_cumsum(liq_inc)
    pfsqif = half_cumsum(ice_inc)
    pfcqlng = half_cumsum(zlneg[IL] * zgdph_r)
    pfcqnng = half_cumsum(zlneg[II] * zgdph_r)
    pfsqltur = half_cumsum(pvfl * ptsphy * zgdph_r)
    pfsqitur = half_cumsum(pvfi * ptsphy * zgdph_r)
    # rain/snow fluxes accumulate onto the liquid/ice flux of the level above —
    # an intentional-looking aliasing preserved from the reference (ref: 2818-2819)
    pfsqrf = jnp.concatenate(
        [jnp.zeros((1, ncol), dtype), pfsqlf[:-1] + rain_inc], axis=0
    )
    pfsqsf = jnp.concatenate(
        [jnp.zeros((1, ncol), dtype), pfsqif[:-1] + snow_inc], axis=0
    )
    pfcqrng = jnp.concatenate(
        [jnp.zeros((1, ncol), dtype), pfcqlng[:-1] + zlneg[IR] * zgdph_r], axis=0
    )
    pfcqsng = jnp.concatenate(
        [jnp.zeros((1, ncol), dtype), pfcqnng[:-1] + zlneg[IS] * zgdph_r], axis=0
    )

    pfhpsl = -c.RLVTT * pfplsl
    pfhpsn = -c.RLSTT * pfplsn

    return CloudscOutputs(
        plude=plude,
        pcovptot=pcovptot,
        prainfrac_toprfz=carry_end["prainfrac"],
        pfsqlf=pfsqlf,
        pfsqif=pfsqif,
        pfcqlng=pfcqlng,
        pfcqnng=pfcqnng,
        pfsqrf=pfsqrf,
        pfsqsf=pfsqsf,
        pfcqrng=pfcqrng,
        pfcqsng=pfcqsng,
        pfsqltur=pfsqltur,
        pfsqitur=pfsqitur,
        pfplsl=pfplsl,
        pfplsn=pfplsn,
        pfhpsl=pfhpsl,
        pfhpsn=pfhpsn,
        tendency_loc_t=tend_t,
        tendency_loc_q=tend_q,
        tendency_loc_a=tend_a,
        tendency_loc_cld=tend_cld,
    )
