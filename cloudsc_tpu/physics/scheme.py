"""Shape-agnostic CLOUDSC physics: per-level state init + the level step.

These functions contain the entire scheme body (behavioral spec:
src/cloudsc_fortran/cloudsc.F90 in the reference; all ref: line numbers below
point there). They are written purely elementwise over arrays of *any* shape so
the same code drives two execution engines:

  - the XLA path (`physics.cloudsc`): `level_init` batched over (nlev, ncol),
    then `lax.scan` calling `level_step` on (ncol,) rows;
  - the fused GPU kernel (`kernels.triton_cloudsc`): both called per level
    on (BLOCK,) rows inside a loop over levels, one program per column
    block — the k-caching schedule
    (ref: src/cloudsc_cuda/cloudsc/cloudsc_c_k_caching.cu:55-77).

Floating-point op order follows the Fortran statement order so fp64 results
match reference.h5 to ~1e-13 relative; fp32 uses the same code path (the
reference's SINGLE build split, ref: parkind1.F90:40-44, is a dtype parameter).

Op-count engineering (the fused kernel is compute-bound):

  * structural sparsity — the 5x5 source (ZSOLQA) and implicit (ZSOLQB)
    matrices have compile-time-known zero entries in the wired configuration;
    they are tracked as Python ``None`` and every consumer (sink sums, the
    conservation rescale, the LU solve) statically skips them. Adding or
    eliminating an exact zero only ever flips the sign of a floating-point
    zero, which no downstream consumer distinguishes, so results are unchanged.
  * the run-out ordering (ref: 2502-2527) is computed as lexicographic ranks
    from 20 pairwise comparisons instead of five sequential masked-argmin
    rounds — identical selection including the first-minimum-wins tie rule.
  * the exp-heavy saturation values (FOEELIQ/FOEEICE/FOEEWM/FOKOOP share two
    exponentials) are evaluated once in level_init and reused by the step.
"""

from __future__ import annotations

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp

from .thermo import (
    foealfa,
    foedelta,
    foedem_a,
    foeewm_a,
    foeldcpm_a,
)

# 0-based species indices (ref: yoecldp.F90:86-91)
IL, II, IR, IS, IV = 0, 1, 2, 3, 4
NCLV = 5
# phase markers: 0=vapour 1=liquid 2=ice (ref: cloudsc.F90:603-607)
IPHASE = (1, 2, 1, 2, 0)
# melting targets (ref: cloudsc.F90:613-617)
IMELT = (II, IR, IS, IR, -1)
# falling species (rain, snow; ice sediments but LLFALL=false, ref: 640-651)
LLFALL = (False, False, True, True, False)

ZEPSEC = 1.0e-14  # ref: cloudsc.F90:589
# numerical wet-bulb fit constants (ref: cloudsc.F90:421-425)
ZTW1, ZTW2, ZTW3, ZTW4, ZTW5 = 1329.31, 0.0074615, 0.85e5, 40.637, 275.0

CARRY_KEYS = (
    "zanewm1", "zqxnm1", "pfplsx", "zcovptot", "zcovpmax",
    "zcldtopdist", "llrainliq", "prainfrac",
)


def chain(terms):
    """Left-to-right sum, preserving the Fortran accumulation order."""
    acc = terms[0]
    for t in terms[1:]:
        acc = acc + t
    return acc


# -- structural-sparsity helpers: None == compile-time zero -------------------

def sadd(a, b):
    if a is None:
        return b
    if b is None:
        return a
    return a + b


def sneg(a):
    return None if a is None else -a


def schain(terms):
    """Left-to-right sum over non-None terms (None if all are None)."""
    acc = None
    for t in terms:
        acc = sadd(acc, t)
    return acc


# Diagnostic probe: set to a callable(tag, mask) to record the per-element
# guard masks feeding the dynamic fast paths (eager analysis runs only —
# bench/activity_probe.py; None on every production path).
probe_hook = None


def block_any(mask):
    """`jnp.any` over the whole batch, written as an integer max: the Pallas
    Triton lowering has no boolean reduction (reduce_or), an int32 max it
    has. The predicate's value is the same, so every consumer is unchanged."""
    return jnp.max(jnp.where(mask, jnp.int32(1), jnp.int32(0))) > 0


def block_all(mask):
    """`jnp.all` over the whole batch, as an integer min (see block_any)."""
    return jnp.min(jnp.where(mask, jnp.int32(1), jnp.int32(0))) > 0


def inert_skip(mask, active_fn, ops, force=None, tag=None):
    """Dynamic fast path for a physics region that is inert wherever `mask`
    is False: when the mask is False EVERYWHERE in the batch (fused kernel:
    this column block; scan engine: the whole batch), the region's increments
    are exactly zero and its `where(mask, ...)` updates are the identity, so
    returning the operands unchanged is value-exact. Inside the fused kernel
    the scalar-predicate `lax.cond` is a branch per block; in the scan it is
    an XLA conditional per level. Branch and join cost something, so this
    is only worth it for LARGE bodies — one cond around a whole region, not
    one per section. Contract: every value `active_fn` RETURNS needs a
    matching `ops` seed equal to its exact inert value (the skip path just
    returns `ops`), in the same tuple position; values that are only
    CONSUMED by the branch may be closed over freely — closure capture and
    operand passing see the identical traced arrays. `force`
    (a traced always-True scalar) pins the predicate on THROUGH the same
    lax.cond, so branch codegen is unchanged — the oracle configuration the
    inertness tests diff against (inlining the branch instead would change
    XLA fusion and add ulp noise)."""
    if probe_hook is not None:
        probe_hook(tag, mask)
    pred = block_any(mask)
    if force is not None:
        pred = pred | force
    return jax.lax.cond(pred, active_fn, lambda o: o, ops)


class SchemeConfig(SimpleNamespace):
    """Scheme-version switches (ref: cloudsc.F90:562-580). The reference
    hardcodes (2, 2, 1, 1); the alternates are implemented and selectable:
      iwarmrain: 1 Sundqvist-1989 | 2 Khairoutdinov-Kogan-2000
      ievaprain: 1 Sundqvist      | 2 Abel-Boutle-2013
      ievapsnow: 1 Sundqvist      | 2 PSD-based
      idepice:   1 Rotstayn-2001  | 2 ice-PSD-based
    """

    def __init__(self, iwarmrain=2, ievaprain=2, ievapsnow=1, idepice=1,
                 dynamic_skips=True, s521_round_skip=None):
        if s521_round_skip is None:
            s521_round_skip = (
                os.environ.get("CLOUDSC_S521_ROUND_SKIP", "0") == "1"
            )
        super().__init__(iwarmrain=int(iwarmrain), ievaprain=int(ievaprain),
                         ievapsnow=int(ievapsnow), idepice=int(idepice),
                         dynamic_skips=bool(dynamic_skips),
                         s521_round_skip=bool(s521_round_skip))


def derived_consts(params, ptsphy: float, dtype,
                   config: SchemeConfig | None = None) -> SimpleNamespace:
    """Scalar constants shared by every section (the ASSOCIATE block +
    derived values, ref: cloudsc.F90:503-545, 585-591). Everything is a plain
    Python float/int/bool — a compile-time constant of the XLA program and of
    the fused kernel (the reference's CUDA constant memory,
    ref: yomcst.cuf.F90)."""
    cst, thf, e = params.ydcst, params.ydthf, params.ydecldp
    c = SimpleNamespace()
    c.cst, c.thf, c.e = cst, thf, e
    c.ptsphy = float(ptsphy)
    c.RG, c.RD, c.RCPD, c.RETV = cst.rg, cst.rd, cst.rcpd, cst.retv
    c.RLVTT, c.RLSTT, c.RLMLT = cst.rlvtt, cst.rlstt, cst.rlmlt
    c.RTT, c.RV = cst.rtt, cst.rv
    c.R4LES, c.R4IES = thf.r4les, thf.r4ies
    c.R5LES, c.R5IES = thf.r5les, thf.r5ies
    c.RALVDCP, c.RALSDCP, c.RALFDCP = thf.ralvdcp, thf.ralsdcp, thf.ralfdcp
    c.NCLDTOP = int(e.ncldtop)      # 1-based as in Fortran
    c.NSSOPT = int(e.nssopt)
    c.LAERICESED = bool(e.laericesed)
    c.LAERICEAUTO = bool(e.laericeauto)
    c.LAERLIQAUTOLSP = bool(e.laerliqautolsp)
    c.LAERLIQCOLL = bool(e.laerliqcoll)
    cfg = config or SchemeConfig()
    c.IWARMRAIN, c.IEVAPRAIN = cfg.iwarmrain, cfg.ievaprain
    c.IEVAPSNOW, c.IDEPICE = cfg.ievapsnow, cfg.idepice
    c.zqtmst = 1.0 / c.ptsphy
    c.zrdcp = c.RD / c.RCPD
    c.zrg_r = 1.0 / c.RG
    c.zrldcp = 1.0 / (c.RALSDCP - c.RALVDCP)
    # 100*eps of the working precision (ref: 555)
    c.zepsilon = 100.0 * float(jnp.finfo(dtype).eps)
    c.zvqx = (0.0, e.rvice, e.rvrain, e.rvsnow, 0.0)  # fall speed per species
    c.dtype = dtype

    # False = always trace the active branch (tests prove the dynamic
    # fast paths are value-exact by diffing against this)
    c.dynamic_skips = bool(getattr(cfg, "dynamic_skips", True))
    # per-round dynamic skips inside the 5.2.1 rescale (see _rescale_sinks)
    c.s521_round_skip = bool(getattr(cfg, "s521_round_skip", False))
    return c


def level_init(raw: dict, c) -> dict:
    """Section 1 'initial values' (ref: 654-808), elementwise over any shape.

    `raw` holds same-shape arrays: pt, pq, pa, pap, tendency_tmp_{t,q,a},
    pclv (list of the 4 condensates), tendency_tmp_cld (list of 4). Returns
    every derived per-level quantity the level step consumes, plus the
    section-1 tendency/clipping bookkeeping (zlneg, zqx0).

    """
    cst, thf, e = c.cst, c.thf, c.e
    zqtmst, RETV = c.zqtmst, c.RETV
    RALVDCP, RALSDCP = c.RALVDCP, c.RALSDCP

    ztp1 = raw["pt"] + c.ptsphy * raw["tendency_tmp_t"]
    zqx = [None] * NCLV
    zqx[IV] = raw["pq"] + c.ptsphy * raw["tendency_tmp_q"]
    for m in (IL, II, IR, IS):
        zqx[m] = raw["pclv"][m] + c.ptsphy * raw["tendency_tmp_cld"][m]
    za = raw["pa"] + c.ptsphy * raw["tendency_tmp_a"]
    zqx0 = list(zqx)
    zaorig = za

    zero = jnp.zeros_like(ztp1)
    tend_t = zero
    tend_q = zero
    zlneg = [zero] * NCLV

    # tidy tiny cloud cover / total water (ref: 696-721)
    cond = ((zqx[IL] + zqx[II]) < e.rlmin) | (za < e.ramin)
    for m, lat in ((IL, RALVDCP), (II, RALSDCP)):
        zlneg[m] = zlneg[m] + jnp.where(cond, zqx[m], 0.0)
        zqadj = zqx[m] * zqtmst
        tend_q = tend_q + jnp.where(cond, zqadj, 0.0)
        tend_t = tend_t - jnp.where(cond, lat * zqadj, 0.0)
        zqx[IV] = zqx[IV] + jnp.where(cond, zqx[m], 0.0)
        zqx[m] = jnp.where(cond, 0.0, zqx[m])
    za = jnp.where(cond, 0.0, za)

    # tidy small CLV amounts (ref: 727-743)
    for m in (IL, II, IR, IS):
        c2 = zqx[m] < e.rlmin
        zlneg[m] = zlneg[m] + jnp.where(c2, zqx[m], 0.0)
        zqadj = zqx[m] * zqtmst
        tend_q = tend_q + jnp.where(c2, zqadj, 0.0)
        lat = RALVDCP if IPHASE[m] == 1 else RALSDCP
        tend_t = tend_t - jnp.where(c2, lat * zqadj, 0.0)
        zqx[IV] = zqx[IV] + jnp.where(c2, zqx[m], 0.0)
        zqx[m] = jnp.where(c2, 0.0, zqx[m])

    # saturation curves (ref: 749-784). The two exponentials are evaluated
    # once and reused across FOEEWM/FOEELIQ/FOEEICE/FOKOOP — bitwise-identical
    # to calling each statement function separately (they share the exact
    # subexpressions), but 8 fewer exp() per level on the hot path.
    pap = raw["pap"]
    zfoealfa = foealfa(ztp1, thf)
    exp_liq = jnp.exp(thf.r3les * (ztp1 - cst.rtt) / (ztp1 - thf.r4les))
    exp_ice = jnp.exp(thf.r3ies * (ztp1 - cst.rtt) / (ztp1 - thf.r4ies))
    zfoeeliq = thf.r2es * exp_liq     # == foeeliq(ztp1)
    zfoeeice = thf.r2es * exp_ice     # == foeeice(ztp1)
    zfoeewmt = jnp.minimum(
        thf.r2es * (zfoealfa * exp_liq + (1.0 - zfoealfa) * exp_ice)
        / pap, 0.5
    )
    zqsmix = zfoeewmt / (1.0 - RETV * zfoeewmt)
    zdelta = foedelta(ztp1, cst)
    zfoeew = jnp.minimum(
        (zdelta * zfoeeliq + (1.0 - zdelta) * zfoeeice) / pap, 0.5
    )
    zfoeew = jnp.minimum(0.5, zfoeew)
    zqsice = zfoeew / (1.0 - RETV * zfoeew)
    zfoeeliqt = jnp.minimum(zfoeeliq / pap, 0.5)
    zqsliq = zfoeeliqt / (1.0 - RETV * zfoeeliqt)
    # Koop supersaturation limit (ref: fccld.func.h:27), reused in 3.1/3.7
    zfokoop = jnp.minimum(
        thf.rkoop1 - thf.rkoop2 * ztp1, zfoeeliq / zfoeeice
    )

    # cloud fraction in [0,1]; liquid/ice split (ref: 786-808)
    za = jnp.maximum(0.0, jnp.minimum(1.0, za))
    zli = zqx[IL] + zqx[II]
    has_li = zli > e.rlmin
    zliqfrac = jnp.where(has_li, zqx[IL] / jnp.where(has_li, zli, 1.0), 0.0)
    zicefrac = jnp.where(has_li, 1.0 - zliqfrac, 0.0)

    return dict(
        ztp1=ztp1, za=za, zaorig=zaorig, zqx=zqx, zqx0=zqx0,
        zqsmix=zqsmix, zqsliq=zqsliq, zqsice=zqsice,
        zfoeew=zfoeew, zfoeewmt=zfoeewmt, zfoeeliqt=zfoeeliqt,
        zfoealfa=zfoealfa, zli=zli, zliqfrac=zliqfrac, zicefrac=zicefrac,
        zfoeeliq=zfoeeliq, zfoeeice=zfoeeice, zfokoop=zfokoop,
        tend_t_pre=tend_t, tend_q_pre=tend_q, zlneg=zlneg,
    )


def initial_carry(like, c) -> dict:
    """Column-carry reset (ref: 687, 838-843); `like` sets shape/dtype."""
    zero = jnp.zeros_like(like)
    return dict(
        zanewm1=zero,
        zqxnm1=[zero] * NCLV,
        pfplsx=[zero] * NCLV,     # flux arriving at the current level
        zcovptot=zero,
        zcovpmax=zero,
        zcldtopdist=zero,
        llrainliq=jnp.ones_like(like, dtype=bool),
        prainfrac=zero,
    )


def level_step(x: dict, carry: dict, c) -> tuple[dict, dict]:
    """Sections 3-6 for one level (ref: 854-2775), elementwise over any shape.

    `x` holds per-level slabs (see cloudsc.py's make_x / the fused kernel for
    the exact contract); `carry` holds the JK->JK+1 recurrences. Returns
    (new_carry, ys) where ys are the per-level emissions.
    """
    e, cst, thf = c.e, c.cst, c.thf
    ptsphy, zqtmst = c.ptsphy, c.zqtmst
    RG, RD, RETV, RTT, RV = c.RG, c.RD, c.RETV, c.RTT, c.RV
    RLSTT = c.RLSTT
    R4LES, R4IES, R5LES, R5IES = c.R4LES, c.R4IES, c.R5LES, c.R5IES
    RALVDCP, RALSDCP = c.RALVDCP, c.RALSDCP
    zrldcp, zrdcp, zrg_r, zepsilon = c.zrldcp, c.zrdcp, c.zrg_r, c.zepsilon
    NSSOPT = c.NSSOPT

    not_first = x["not_first"]
    not_last = x["not_last"]
    ztp1 = x["ztp1"]
    za = x["za"]
    zqx = list(x["zqx"])
    zqsmix, zqsliq, zqsice = x["zqsmix"], x["zqsliq"], x["zqsice"]
    pap, paph, paph_next = x["pap"], x["paph"], x["paph_next"]
    paph_surf = x["paph_surf"]
    land, ldcum, ktype = x["land"], x["ldcum"], x["ktype"]
    zfoealfa_k = x["zfoealfa"]
    pfplsx_row = carry["pfplsx"]

    zero = jnp.zeros_like(ztp1)
    # test hook: a traced always-True scalar that pins every dynamic
    # fast-path predicate ON without changing branch codegen
    force_on = (None if c.dynamic_skips
                else block_any(jnp.isfinite(ztp1)))
    dtype = ztp1.dtype

    def madd(mask, v):
        return jnp.where(mask, v, 0.0)

    # ---- 3.0 per-level init (ref: 854-983) --------------------------
    # ZSOLQA/ZSOLQB start as structural zeros (None); only entries the wired
    # configuration can touch ever become arrays.
    zqxfg = list(zqx)
    solqa = [[None for _ in range(NCLV)] for _ in range(NCLV)]
    solqb = [[None for _ in range(NCLV)] for _ in range(NCLV)]
    zfallsrce = [None] * NCLV
    zfallsink = [None] * NCLV
    zconvsrce = [None] * NCLV
    zconvsink = [None] * NCLV
    zpsupsatsrce = [None] * NCLV
    solab = zero
    solac = zero

    zdp = paph_next - paph
    zgdp = RG / zdp
    zrho = pap / (RD * ztp1)
    zdtgdp = ptsphy * zgdp
    zrdtgdp = zdp * (1.0 / (ptsphy * RG))

    zfacw = R5LES / (ztp1 - R4LES) ** 2
    zcor = 1.0 / (1.0 - RETV * x["zfoeeliqt"])
    zdqsliqdt = zfacw * zcor * zqsliq
    zcorqsliq = 1.0 + RALVDCP * zdqsliqdt

    zfaci = R5IES / (ztp1 - R4IES) ** 2
    zcor = 1.0 / (1.0 - RETV * x["zfoeew"])
    zdqsicedt = zfaci * zcor * zqsice
    zcorqsice = 1.0 + RALSDCP * zdqsicedt

    zalfaw = zfoealfa_k
    zfac = zalfaw * zfacw + (1.0 - zalfaw) * zfaci
    zcor = 1.0 / (1.0 - RETV * x["zfoeewmt"])
    zdqsmixdt = zfac * zcor * zqsmix
    zcorqsmix = 1.0 + foeldcpm_a(zfoealfa_k, thf) * zdqsmixdt

    zevaplimmix = jnp.maximum((zqsmix - zqx[IV]) / zcorqsmix, 0.0)

    ztmpa = 1.0 / jnp.maximum(za, ZEPSEC)
    zliqcld = zqx[IL] * ztmpa
    zicecld = zqx[II] * ztmpa
    zlicld = zliqcld + zicecld

    # evaporate very small liquid/ice (ref: 971-983)
    for m in (IL, II):
        tiny = zqx[m] < e.rlmin
        solqa[IV][m] = sadd(solqa[IV][m], madd(tiny, zqx[m]))
        solqa[m][IV] = sadd(solqa[m][IV], -madd(tiny, zqx[m]))

    # ---- 3.1 ice supersaturation adjustment (ref: 985-1088) ---------
    zfokoop = x["zfokoop"]
    warm_or_off = (ztp1 >= RTT) | (NSSOPT == 0)
    zfac = jnp.where(warm_or_off, 1.0, za + zfokoop * (1.0 - za))
    zfaci = jnp.where(warm_or_off, 1.0, ptsphy / e.rkooptau)

    high_a = za > 1.0 - e.ramin
    zsup_cld = jnp.maximum((zqx[IV] - zfac * zqsice) / zcorqsice, 0.0)
    zqp1env = (zqx[IV] - za * zqsice) / jnp.maximum(1.0 - za, zepsilon)
    zsup_env = jnp.maximum(
        (1.0 - za) * (zqp1env - zfac * zqsice) / zcorqsice, 0.0
    )
    zsupsat = jnp.where(high_a, zsup_cld, zsup_env)

    has_sup = zsupsat > ZEPSEC
    warm = ztp1 > e.rthomo
    if probe_hook is not None:
        probe_hook("s31", has_sup | (x["psupsat"] > ZEPSEC))
    for m, w in ((IL, warm), (II, ~warm)):
        amt = madd(has_sup & w, zsupsat)
        solqa[m][IV] = sadd(solqa[m][IV], amt)
        solqa[IV][m] = sadd(solqa[IV][m], -amt)
        zqxfg[m] = zqxfg[m] + amt
    solac = jnp.where(has_sup, (1.0 - za) * zfaci, solac)

    psupsat = x["psupsat"]
    has_ps = psupsat > ZEPSEC
    for m, w in ((IL, warm), (II, ~warm)):
        amt = madd(has_ps & w, psupsat)
        solqa[m][m] = sadd(solqa[m][m], amt)
        zpsupsatsrce[m] = amt
        zqxfg[m] = zqxfg[m] + amt
    solac = jnp.where(has_ps, (1.0 - za) * zfaci, solac)

    # ---- 3.2 detrainment from convection (ref: 1100-1127) -----------
    plude_scaled = x["plude_in"] * zdtgdp
    plu_next = x["plu_next"]
    lcond = (
        not_last & ldcum & (plude_scaled > e.rlmin) & (plu_next > ZEPSEC)
    )
    solac = solac + madd(lcond, plude_scaled / jnp.where(lcond, plu_next, 1.0))
    zconvsrce[IL] = madd(lcond, zalfaw * plude_scaled)
    zconvsrce[II] = madd(lcond, (1.0 - zalfaw) * plude_scaled)
    solqa[IL][IL] = sadd(solqa[IL][IL], zconvsrce[IL])
    solqa[II][II] = sadd(solqa[II][II], zconvsrce[II])
    plude_out = jnp.where(
        not_last, jnp.where(lcond, plude_scaled, 0.0), x["plude_in"]
    )
    solqa[IS][IS] = sadd(
        solqa[IS][IS], madd(not_last & ldcum, x["psnde"] * zdtgdp)
    )
    if probe_hook is not None:
        probe_hook(
            "s32", lcond | (not_last & ldcum & (x["psnde"] * zdtgdp != 0.0))
        )

    # ---- 3.3 subsidence source + in-layer evaporation (ref: 1143-1194)
    # x["pmf"] = PMFU + PMFD: the mass fluxes are only ever consumed summed
    # (ref: 1145, 1203, 1288), so the sum is hoisted to the caller
    zmf = jnp.maximum(0.0, x["pmf"] * zdtgdp)
    zacust = zmf * carry["zanewm1"]
    zlcust = [None] * NCLV
    for m in (IL, II):
        zlcust[m] = madd(not_first, zmf * carry["zqxnm1"][m])
        zconvsrce[m] = sadd(zconvsrce[m], zlcust[m])
    zdtdp = zrdcp * 0.5 * (x["ztp1_prev"] + ztp1) / paph
    zdtforc = zdtdp * (pap - x["pap_prev"])
    zdqs_sub = carry["zanewm1"] * zdtforc * zdqsmixdt
    zlfinalsum = zero
    for m in (IL, II):
        zlfinal = jnp.maximum(0.0, zlcust[m] - zdqs_sub)
        zevap = jnp.minimum(zlcust[m] - zlfinal, zevaplimmix)
        zlfinal = zlcust[m] - zevap
        zlfinalsum = zlfinalsum + madd(not_first, zlfinal)
        solqa[m][m] = sadd(solqa[m][m], madd(not_first, zlcust[m]))
        solqa[IV][m] = sadd(solqa[IV][m], madd(not_first, zevap))
        solqa[m][IV] = sadd(solqa[m][IV], -madd(not_first, zevap))
    zacust = jnp.where(zlfinalsum < ZEPSEC, 0.0, zacust)
    solac = solac + madd(not_first, zacust)

    # subsidence sink to layer below (ref: 1201-1217)
    zmfdn = madd(
        not_last,
        jnp.maximum(0.0, x["pmf_next"] * zdtgdp),
    )
    if probe_hook is not None:
        probe_hook("s33", (not_first & (zmf > 0.0)) | (zmfdn > 0.0))
    solab = solab + zmfdn
    solqb[IL][IL] = sadd(solqb[IL][IL], zmfdn)
    solqb[II][II] = sadd(solqb[II][II], zmfdn)
    zconvsink[IL] = zmfdn
    zconvsink[II] = zmfdn

    # ---- 3.4 turbulent erosion (ref: 1230-1261) ----------------------
    zldifdt = jnp.where(
        (ktype > 0) & (plude_out > ZEPSEC),
        e.rcldiff_convi * e.rcldiff * ptsphy,
        e.rcldiff * ptsphy,
    )
    has_cld = x["zli"] > ZEPSEC
    ze = zldifdt * jnp.maximum(zqsmix - zqx[IV], 0.0)
    zleros = za * ze
    zleros = jnp.minimum(zleros, zevaplimmix)
    zleros = jnp.minimum(zleros, x["zli"])
    zaeros = zleros / jnp.where(has_cld, zlicld, 1.0)
    if probe_hook is not None:
        probe_hook("s34e", has_cld)
    solac = solac - madd(has_cld, zaeros)
    for m, frac in ((IL, x["zliqfrac"]), (II, x["zicefrac"])):
        amt = madd(has_cld, frac * zleros)
        solqa[IV][m] = sadd(solqa[IV][m], amt)
        solqa[m][IV] = sadd(solqa[m][IV], -amt)

    # ---- 3.4b condensation/evaporation from dqsat/dt (ref: 1281-1325)
    zdtdp = zrdcp * ztp1 / pap
    zdpmxdt = zdp * zqtmst
    zmfdn2 = madd(not_last, x["pmf_next"])
    # (pmfu+pmfd)+zmfdn2 associates left-to-right in the Fortran
    # (ref: 1288), so consuming the pre-summed pmf preserves the op
    # order exactly
    zwtot = x["pvervel"] + 0.5 * RG * (x["pmf"] + zmfdn2)
    zwtot = jnp.minimum(zdpmxdt, jnp.maximum(-zdpmxdt, zwtot))
    # x["zhr"] = PHRSW + PHRLW (ref: 1289 — only ever consumed summed)
    zzzdt = x["zhr"]
    zdtdiab = (
        jnp.minimum(zdpmxdt * zdtdp, jnp.maximum(-zdpmxdt * zdtdp, zzzdt))
        * ptsphy
    )  # + RALFDCP*ZLDEFR, with ZLDEFR==0 (ref: 1290-1293)
    zdtforc = zdtdp * zwtot * ptsphy + zdtdiab
    tloc = jnp.maximum(ztp1 + zdtforc, 160.0)
    qloc = zqsmix
    zqp = 1.0 / pap
    # inlined CUADJTQ, 2 Newton iterations (ref: 1303-1319)
    for _ in range(2):
        alfa_n = foealfa(tloc, thf)
        zqsat = jnp.minimum(foeewm_a(tloc, alfa_n, cst, thf) * zqp, 0.5)
        zcor_n = 1.0 / (1.0 - RETV * zqsat)
        zqsat = zqsat * zcor_n
        zcond = (qloc - zqsat) / (
            1.0 + zqsat * zcor_n * foedem_a(tloc, alfa_n, thf)
        )
        tloc = tloc + foeldcpm_a(alfa_n, thf) * zcond
        qloc = qloc - zcond
    zdqs = qloc - zqsmix

    # 3.4a evaporation of clouds (ref: 1333-1356)
    evap_m = zdqs > 0.0
    zlevap = za * jnp.minimum(zdqs, zlicld)
    zlevap = jnp.minimum(zlevap, zevaplimmix)
    zlevap = jnp.minimum(zlevap, jnp.maximum(zqsmix - zqx[IV], 0.0))
    for m, frac in ((IL, x["zliqfrac"]), (II, x["zicefrac"])):
        amt = madd(evap_m, frac * zlevap)
        solqa[IV][m] = sadd(solqa[IV][m], amt)
        solqa[m][IV] = sadd(solqa[m][IV], -amt)

    # 3.4b(1) increase of cloud water in existing clouds (ref: 1362-1396)
    c1m = (za > ZEPSEC) & (zdqs <= -e.rlmin)
    zlcond1 = jnp.maximum(-zdqs, 0.0)
    zcorq = 1.0 / (1.0 - RETV * zqsmix)
    zcdmax = jnp.where(
        za > 0.99,
        (zqx[IV] - zqsmix)
        / (1.0 + zcorq * zqsmix * foedem_a(ztp1, zfoealfa_k, thf)),
        (zqx[IV] - za * zqsmix) / jnp.where(c1m, za, 1.0),
    )
    zlcond1 = jnp.maximum(jnp.minimum(zlcond1, zcdmax), 0.0)
    zlcond1 = za * zlcond1
    zlcond1 = jnp.where(zlcond1 < e.rlmin, 0.0, zlcond1)
    for m, w in ((IL, warm), (II, ~warm)):
        amt = madd(c1m & w, zlcond1)
        solqa[m][IV] = sadd(solqa[m][IV], amt)
        solqa[IV][m] = sadd(solqa[IV][m], -amt)
        zqxfg[m] = zqxfg[m] + amt

    # 3.4b(2) generation of new clouds (ref: 1400-1499)
    c2m = (zdqs <= -e.rlmin) & (za < 1.0 - ZEPSEC)
    zsigk = pap / paph_surf
    zrhc = jnp.where(
        zsigk > 0.8,
        e.ramid + (1.0 - e.ramid) * ((zsigk - 0.8) / 0.2) ** 2,
        e.ramid,
    )
    if NSSOPT in (0, 1):  # none / Tompkins
        zqe = (zqx[IV] - za * zqsice) / jnp.maximum(ZEPSEC, 1.0 - za)
        zqe = jnp.maximum(0.0, zqe)
    elif NSSOPT == 2:  # Lohmann and Karcher
        zqe = zqx[IV]
    else:  # Gierens
        zqe = zqx[IV] + x["zli"]
    zfac2 = jnp.where((ztp1 >= RTT) | (NSSOPT == 0), 1.0, zfokoop)
    in_range = (zqe >= zrhc * zqsice * zfac2) & (zqe < zqsice * zfac2)
    c2m = c2m & in_range
    zacond = (
        -(1.0 - za) * zfac2 * zdqs
        / jnp.maximum(2.0 * (zfac2 * zqsice - zqe), ZEPSEC)
    )
    zacond = jnp.minimum(zacond, 1.0 - za)
    zlcond2 = -zfac2 * zdqs * 0.5 * zacond
    zzdl = 2.0 * (zfac2 * zqsice - zqe) / jnp.maximum(ZEPSEC, 1.0 - za)
    zlcondlim = (za - 1.0) * zfac2 * zdqs - zfac2 * zqsice + zqx[IV]
    zlcond2 = jnp.where(
        zfac2 * zdqs < -zzdl, jnp.minimum(zlcond2, zlcondlim), zlcond2
    )
    zlcond2 = jnp.maximum(zlcond2, 0.0)
    kill = (zlcond2 < e.rlmin) | ((1.0 - za) < ZEPSEC)
    zlcond2 = jnp.where(kill, 0.0, zlcond2)
    zacond = jnp.where(kill | (zlcond2 == 0.0), 0.0, zacond)
    solac = solac + madd(c2m, zacond)
    for m, w in ((IL, warm), (II, ~warm)):
        amt = madd(c2m & w, zlcond2)
        solqa[m][IV] = sadd(solqa[m][IV], amt)
        solqa[IV][m] = sadd(solqa[IV][m], -amt)
        zqxfg[m] = zqxfg[m] + amt

    # ---- 3.7 ice deposition -------------------------------------------
    # cloud-top distance carry, shared by both schemes (ref: 1529-1533);
    # updated unconditionally (not guarded by dep_m), so it stays outside
    # the precipitation branch that the rest of 3.7 joins below
    reset_top = (x["za_prev"] < e.rcldtopcf) & (za >= e.rcldtopcf)
    zcldtopdist = jnp.where(
        reset_top, 0.0, carry["zcldtopdist"] + zdp / (zrho * RG)
    )

    # 4.2 sedimentation source/sink (ref: 1714-1746) -- pure functions of
    # the incoming flux and density/aerosol inputs, independent of
    # everything in the branched region (and exactly zero on inert levels,
    # where no flux arrives), so they stay outside it. Only the zqxfg
    # updates join the branch: their accumulation order against 3.7's
    # deposition updates must match the reference. The solqa diagonal adds
    # commute out bitwise (nothing inside the branch touches a diagonal).
    for m in (II, IR, IS):
        zfallsrce[m] = madd(not_first, pfplsx_row[m] * zdtgdp)
        solqa[m][m] = sadd(solqa[m][m], zfallsrce[m])
        if m == II and c.LAERICESED:
            vq = 0.002 * x["pre_ice"]
        else:
            vq = c.zvqx[m]
        zfallsink[m] = zdtgdp * (vq * zrho)

    # 4.4b's rain-fraction latch is hoisted out of the branch: it writes
    # the level carries and depends only on start-of-level state
    # (ref: 2044-2056)
    rain_p = zqx[IR] > ZEPSEC
    latch = rain_p & (ztp1 <= RTT) & (x["ztp1_prev"] > RTT)
    zqpretot_f = jnp.maximum(zqx[IS] + zqx[IR], ZEPSEC)
    prainfrac = jnp.where(latch, zqx[IR] / zqpretot_f, carry["prainfrac"])
    # pure logical form, no bool-valued select
    llrainliq = (latch & (prainfrac > 0.8)) | (~latch & carry["llrainliq"])

    # ================================================================
    # 3.7-4.5 ice deposition + precipitation block (ref: 1501-2421)
    # ================================================================
    # Every process from 3.7 through 4.5 needs condensate or precipitation
    # at the level. `pre_m` is a cheap superset of every per-process guard,
    # evaluated on START-of-region state (the region's own updates only
    # move mass between species that already exist, or import it through
    # an incoming flux), so when it is False everywhere in the batch the
    # whole region is value-exact inert and ONE branch skips its ~12
    # transcendentals (see inert_skip; per-section branches measured as a
    # net loss). Guard coverage: 3.7 dep_m needs zqxfg[IL] > RLMIN; 4.2's
    # fall source (hoisted above) needs an incoming flux; 4.3p has_pre
    # needs post-fall precip mass; 4.3a snow_m / 4.3b-c liq_m need in-cloud
    # ice/liquid (zero when zqxfg <= 0); 4.4a melt needs ice+snow;
    # 4.4b/4.5r need rain (zqx[IR] <= zqxfg[IR] pre-fall, all pre-branch
    # sources are non-negative); 4.4c needs liquid; 4.5s needs snow. The
    # write-only zcovpmax output is seeded with zeros, which ARE its exact
    # inert value; the zcovptot carry is exactly 0 whenever pre_m is False
    # (5.3 zeroes it unless the level above emitted a rain/snow flux, and
    # any flux into this level sets pre_m).
    flux_in = (
        (pfplsx_row[II] > 0.0)
        | (pfplsx_row[IR] > 0.0)
        | (pfplsx_row[IS] > 0.0)
    )
    pre_m = (
        (zqxfg[IL] > 0.0) | (zqxfg[II] > 0.0)
        | (zqxfg[IR] > 0.0) | (zqxfg[IS] > 0.0)
        | flux_in
    )
    # The same branch also swallows the implicit solver and the tendency
    # sections (4.6, 5.2.x, 5.3, 6): on a level where pre_m is False AND
    # every explicit source accumulated so far is exactly zero, the 5x5
    # solve is the bitwise identity — the condensate right-hand sides are
    # zero (every outside-region first-guess update is a non-negative add,
    # so zqxfg == 0 forces zqx == 0 and all explicit terms zero), vapour
    # keeps a unit diagonal (nothing writes solqb on the vapour row or
    # column), and the subsidence solqb diagonals only divide a zero RHS.
    # Then 5.2.3's clip adds exact zeros, 5.3 emits zero fluxes, and the
    # section-6 increments vanish term by term. The only sections that can
    # write a nonzero solqa entry WITHOUT raising the first guess are the
    # detrainment/subsidence sources (3.2/3.3), so the region guard ORs an
    # any-nonzero test over the solqa entries live at this point (measured:
    # on the snapshot this does not raise the fire rate —
    # bench/activity_probe.py, tags precip vs solver).
    region_m = pre_m
    for _mm in range(NCLV):
        for _nn in range(NCLV):
            if solqa[_mm][_nn] is not None:
                region_m = region_m | (solqa[_mm][_nn] != 0.0)
    if probe_hook is not None:
        # true activity of the branched 5.2.2+ solve: in-branch writes all
        # require region_m; outside the branch the only solver-relevant
        # state is the subsidence solqb diagonals (zmfdn) — falling species
        # mass zqx[m] != 0 implies zqxfg[m] > 0 and hence pre_m. Recorded
        # OUTSIDE the branch so the rate is unbiased on skipped levels.
        probe_hook("solver", region_m | (zmfdn > 0.0))
    _blk_a = [
        (IS, IL), (IR, IL), (IL, IS), (IL, IR),   # 4.3b warm rain (KK2000)
        (IR, II), (II, IR), (IR, IS), (IS, IR),   # 4.4a melt + 4.4b freeze
        (II, IL), (IL, II),                       # 3.7 dep + 4.4c hom.freeze
        (IV, IR), (IR, IV), (IV, IS), (IS, IV),   # 4.5 evap/sublimation
    ]
    _blk_b = [(IS, II), (IS, IL), (IR, IL)]       # 4.3a / 4.3b(v1) / 4.3c
    _sqa0, _sqb0, _qf0 = solqa, solqb, zqxfg
    _zicecld30 = zicecld  # in-cloud ice as of section 3.0, read by 3.7

    def _precip_active(ops):
        # shadow the threaded structures with branch-local copies; the
        # section code below is textually identical to the unbranched
        # formulation. solqa/solqb/zqxfg are DEAD after the branch (the
        # solver and tendency sections consume them in here), so they are
        # seeded through the closure; the entries this region writes are
        # materialized to zero arrays exactly like the old operand seeds,
        # keeping the solver's structural-sparsity pattern unchanged.
        solqa = [row[:] for row in _sqa0]
        solqb = [row[:] for row in _sqb0]
        zqxfg = list(_qf0)
        for m, n in _blk_a:
            if solqa[m][n] is None:
                solqa[m][n] = zero
        for m, n in _blk_b:
            if solqb[m][n] is None:
                solqb[m][n] = zero
        # zcovptot's initial value: the closure array IS the ops seed
        # (carry["zcovptot"] is passed as the seed below), so read it by
        # name rather than by a positional index into ops
        zcovptot = carry["zcovptot"]

        dep_m = (ztp1 < RTT) & (zqxfg[IL] > e.rlmin)
        zvpice = x["zfoeeice"] * RV / RD
        zvpliq = zvpice * zfokoop
        zicenuclei = 1000.0 * jnp.exp(
            12.96 * (zvpliq - zvpice) / zvpliq - 0.639
        )
        zinfactor = jnp.minimum(zicenuclei / 15000.0, 1.0)
        if c.IDEPICE == 1:  # Rotstayn 2001 monodisperse (ref: 1519-1601)
            zadd = RLSTT * (RLSTT / (RV * ztp1) - 1.0) / (2.4e-2 * ztp1)
            zbdd = RV * ztp1 * pap / (2.21 * zvpice)
            zcvds = (
                7.8
                * (zicenuclei / zrho) ** 0.666
                * (zvpliq - zvpice)
                / (8.87 * (zadd + zbdd) * zvpice)
            )
            zice0 = jnp.maximum(
                _zicecld30, zicenuclei * e.riceinit / zrho
            )
            zinew_b = 0.666 * zcvds * ptsphy + zice0**0.666
            zinew = zinew_b * jnp.sqrt(zinew_b)      # == zinew_b**1.5
            zdepos = jnp.maximum(za * (zinew - zice0), 0.0)
        else:  # IDEPICE == 2: ice-PSD deposition (ref: 1608-1689)
            zice0 = jnp.maximum(
                _zicecld30, zicenuclei * e.riceinit / zrho
            )
            zaplusb = (
                e.rcl_apb1 * zvpice - e.rcl_apb2 * zvpice * ztp1
                + pap * e.rcl_apb3 * (ztp1 * ztp1 * ztp1)
            )
            zcorrfac = jnp.sqrt(1.0 / zrho)
            ztq = ztp1 / 273.0
            zcorrfac2 = ztq * jnp.sqrt(ztq) * (393.0 / (ztp1 + 120.0))
            zpr02 = zrho * zice0 * e.rcl_const1i  # ZTCG = ZFACX1I = 1
            zterm1 = (
                (zvpliq - zvpice) * ztp1**2 * zvpice * zcorrfac2
                * e.rcl_const2i / (zrho * zaplusb * zvpice)
            )
            zterm2 = (
                0.65 * e.rcl_const6i * zpr02 ** e.rcl_const4i
                + e.rcl_const3i * jnp.sqrt(zcorrfac) * jnp.sqrt(zrho)
                * zpr02 ** e.rcl_const5i / jnp.sqrt(zcorrfac2)
            )
            zdepos = jnp.maximum(za * zterm1 * zterm2 * ptsphy, 0.0)
        ztopred = jnp.minimum(
            zinfactor
            + (1.0 - zinfactor)
            * (e.rdepliqrefrate + zcldtopdist / e.rdepliqrefdepth),
            1.0,
        )
        zdepos = jnp.minimum(zdepos, zqxfg[IL])
        # cloud-top reduction for turbulence/nucleation/fallout (ref: 1581-1586)
        zdepos = zdepos * ztopred
        amt = madd(dep_m, zdepos)
        solqa[II][IL] = sadd(solqa[II][IL], amt)
        solqa[IL][II] = sadd(solqa[IL][II], -amt)
        zqxfg[II] = zqxfg[II] + amt
        zqxfg[IL] = zqxfg[IL] - amt

        # ==============================================================
        # 4. PRECIPITATION PROCESSES
        # ==============================================================
        # revised in-cloud condensate (ref: 1700-1705)
        ztmpa = 1.0 / jnp.maximum(za, ZEPSEC)
        zliqcld = zqxfg[IL] * ztmpa
        zicecld = zqxfg[II] * ztmpa
        zlicld = zliqcld + zicecld

        # 4.2 sedimentation fall source, hoisted part applied to the first
        # guess in reference order (ref: 1714-1726)
        zqpretot = zero
        for m in (II, IR, IS):
            zqxfg[m] = zqxfg[m] + zfallsrce[m]
            zqpretot = zqpretot + madd(not_first, zqxfg[m])

        # 4.3p precip cover overlap, MAX-RAN (ref: 1767-1784); zcovptot here
        # is the incoming carry value (the same array seeds the matching
        # ops slot, so the skip path returns it unchanged)
        has_pre = zqpretot > ZEPSEC
        zcovptot_new = 1.0 - (
            (1.0 - zcovptot)
            * (1.0 - jnp.maximum(za, x["za_prev"]))
            / (1.0 - jnp.minimum(x["za_prev"], 1.0 - 1.0e-6))
        )
        zcovptot = jnp.where(has_pre, jnp.maximum(zcovptot_new, e.rcovpmin), 0.0)
        zcovpclr = jnp.where(has_pre, jnp.maximum(0.0, zcovptot - za), 0.0)
        covp_safe = jnp.where(has_pre, zcovptot, 1.0)
        zraincld = jnp.where(has_pre, zqxfg[IR] / covp_safe, 0.0)
        zsnowcld = jnp.where(has_pre, zqxfg[IS] / covp_safe, 0.0)
        zcovpmax = jnp.where(
            has_pre, jnp.maximum(zcovptot, carry["zcovpmax"]), 0.0
        )

        snow_m = (ztp1 <= RTT) & (zicecld > ZEPSEC)
        liq_m = zliqcld > ZEPSEC
        rime_m = (ztp1 <= RTT) & (zliqcld > ZEPSEC)
        zfallcorr = (e.rdensref / zrho) ** 0.4
        rime2 = rime_m & (zsnowcld > ZEPSEC) & (zcovptot > 0.01)
        zicetot = zqxfg[II] + zqxfg[IS]
        melt_m = (zicetot > ZEPSEC) & (ztp1 > RTT)
        frz_cold = rain_p & (ztp1 < RTT)

        # 4.3a snow autoconversion, Lin et al. 1983 (ref: 1789-1811)
        zzco = ptsphy * e.rsnowlin1 * jnp.exp(e.rsnowlin2 * (ztp1 - RTT))
        if c.LAERICEAUTO:
            zlcrit = x["picrit_aer"]
            zzco = zzco * (e.rnice / x["pnice"]) ** 0.333
        else:
            zlcrit = e.rlcritsnow
        zsnowaut = zzco * (1.0 - jnp.exp(-((zicecld / zlcrit) ** 2)))
        solqb[IS][II] = sadd(solqb[IS][II], madd(snow_m, zsnowaut))

        # 4.3b warm-rain autoconversion/accretion (ref: 1819-1927)
        if c.IWARMRAIN == 1:  # Sundqvist (1989), implicit (ref: 1826-1874)
            zzco = e.rkconv * ptsphy
            if c.LAERLIQAUTOLSP:
                zlcrit = x["plcrit_aer"]
                zzco = zzco * (e.rccn / x["pccn"]) ** 0.333
            else:
                zlcrit = jnp.where(land, e.rclcrit_land, e.rclcrit_sea)
            # collection enhancement from precipitation flux through the cloud
            zprecip = (pfplsx_row[IS] + pfplsx_row[IR]) / jnp.maximum(
                ZEPSEC, zcovptot
            )
            pr_pos = zprecip > 0.0
            pr_sqrt = jnp.where(
                pr_pos, jnp.sqrt(jnp.where(pr_pos, zprecip, 1.0)), 0.0
            )
            zcfpr = 1.0 + e.rprc1 * pr_sqrt
            if c.LAERLIQCOLL:
                zcfpr = zcfpr * (e.rccn / x["pccn"]) ** 0.333
            zzco = zzco * zcfpr
            zlcrit = zlcrit / jnp.maximum(zcfpr, ZEPSEC)
            # exp guarded against overflow for large arguments (ref: 1864-1868)
            zarg = zliqcld / zlcrit
            zrainaut = jnp.where(
                zarg < 20.0,
                zzco * (1.0 - jnp.exp(-(zarg * zarg))),
                zzco,
            )
            cold = ztp1 <= RTT
            solqb[IS][IL] = sadd(solqb[IS][IL], madd(liq_m & cold, zrainaut))
            solqb[IR][IL] = sadd(solqb[IR][IL], madd(liq_m & ~cold, zrainaut))
        elif c.IWARMRAIN == 2:  # Khairoutdinov and Kogan (2000)
            # the CCN-number power has a compile-time base on land and sea:
            # fold zconst**RCL_KKBauN into the land/sea select
            zconst_pow = jnp.where(
                land,
                e.rcl_kk_cloud_num_land ** e.rcl_kkbaun,
                e.rcl_kk_cloud_num_sea ** e.rcl_kkbaun,
            )
            zlcrit = jnp.where(land, e.rclcrit_land, e.rclcrit_sea)
            above = zliqcld > zlcrit
            zrainaut = (
                1.5 * za * ptsphy
                * e.rcl_kkaau
                * jnp.maximum(zliqcld, 0.0) ** e.rcl_kkbauq
                * zconst_pow
            )
            zrainaut = jnp.minimum(zrainaut, zqxfg[IL])
            zrainaut = jnp.where(zrainaut < ZEPSEC, 0.0, zrainaut)
            zrainacc = (
                2.0 * za * ptsphy
                * e.rcl_kkaac
                * jnp.maximum(zliqcld * zraincld, 0.0) ** e.rcl_kkbac
            )
            zrainacc = jnp.minimum(zrainacc, zqxfg[IL])
            zrainacc = jnp.where(zrainacc < ZEPSEC, 0.0, zrainacc)
            zrainaut = jnp.where(above, zrainaut, 0.0)
            zrainacc = jnp.where(above, zrainacc, 0.0)
            cold = ztp1 <= RTT
            for dst, sel_c in ((IS, cold), (IR, ~cold)):
                mm = liq_m & sel_c
                solqa[dst][IL] = sadd(solqa[dst][IL], madd(mm, zrainaut))
                solqa[dst][IL] = sadd(solqa[dst][IL], madd(mm, zrainacc))
                solqa[IL][dst] = sadd(solqa[IL][dst], -madd(mm, zrainaut))
                solqa[IL][dst] = sadd(solqa[IL][dst], -madd(mm, zrainacc))
        else:
            raise NotImplementedError(f"IWARMRAIN={c.IWARMRAIN} unknown")

        # riming: snow collects cloud liquid (ref: 1935-1980)
        rime_base = jnp.maximum(zrho * zsnowcld * e.rcl_const1s, 0.0)
        # adjoint-safe power: d(x**p)/dx at x=0 is inf for p<1; the guarded
        # form has a BITWISE-identical forward value (0**p = 0) and a zero
        # cotangent at the clamp, keeping jax.grad/vjp finite
        rime_pos = rime_base > 0.0
        rime_pow = jnp.where(
            rime_pos,
            jnp.where(rime_pos, rime_base, 1.0) ** e.rcl_const8s,
            0.0,
        )
        zsnowrime = (
            0.3 * zcovptot * ptsphy * e.rcl_const7s * zfallcorr
            * rime_pow
        )
        zsnowrime = jnp.minimum(zsnowrime, 1.0)
        solqb[IS][IL] = sadd(solqb[IS][IL], madd(rime2, zsnowrime))

        # 4.4a melting of snow and ice (ref: 1990-2034)
        zsubsat = jnp.maximum(zqsice - zqx[IV], 0.0)
        ztdmtw0 = ztp1 - RTT - zsubsat * (
            ZTW1 + ZTW2 * (pap - ZTW3) - ZTW4 * (ztp1 - ZTW5)
        )
        zcons1 = jnp.abs(ptsphy * (1.0 + 0.5 * ztdmtw0) / e.rtaumel)
        zmeltmax = madd(melt_m, jnp.maximum(ztdmtw0 * zcons1 * zrldcp, 0.0))
        for m in (II, IS):
            n = IMELT[m]
            mm = (zmeltmax > ZEPSEC) & (zicetot > ZEPSEC)
            zalfa_m = zqxfg[m] / jnp.where(mm, zicetot, 1.0)
            zmelt = jnp.minimum(zqxfg[m], zalfa_m * zmeltmax)
            amt = madd(mm, zmelt)
            zqxfg[m] = zqxfg[m] - amt
            zqxfg[n] = zqxfg[n] + amt
            solqa[n][m] = sadd(solqa[n][m], amt)
            solqa[m][n] = sadd(solqa[m][n], -amt)

        # 4.4c freezing of liquid (ref: 2099-2112) — runs before the rain
        # sub-branch below; this commutes bitwise with 4.4b/4.5r (disjoint
        # solqa entries, disjoint zqxfg species, no shared temporaries)
        zfrzmax = jnp.maximum((e.rthomo - ztp1) * zrldcp, 0.0)
        frz_m = (zfrzmax > ZEPSEC) & (zqxfg[IL] > ZEPSEC)
        zfrz = jnp.minimum(zqxfg[IL], zfrzmax)
        amt = madd(frz_m, zfrz)
        solqa[II][IL] = sadd(solqa[II][IL], amt)
        solqa[IL][II] = sadd(solqa[IL][II], -amt)

        # ---- rain sub-branch: 4.4b freezing + 4.5 rain evaporation ------
        # the only processes that need rain; value-exact inert when no rain
        # exists at the level (rain lives only below the melting layer, so
        # this skips the Abel-Boutle PSD transcendentals on most levels)
        rain_m2 = rain_p | (zqxfg[IR] > ZEPSEC)
        # inside _precip_active every threaded solqa entry was seeded
        # from the ops tuple (zero arrays for structurally-absent ones),
        # so the sub-branch operands are never None
        _rsqa0 = [solqa[IS][IR], solqa[IR][IS], solqa[IV][IR], solqa[IR][IV]]

        def _rain_active(ops):
            sa_sr, sa_rs, sa_vr, sa_rv, covp, qf_r = ops
            # 4.4b freezing of rain (ref: 2039-2094)
            lam_den = jnp.where(rain_p, zrho * zqx[IR], 1.0)
            # ZLAMBDA**RCL_CONST6R with the exponents folded into one power
            zlambda_c6 = (e.rcl_fac1 / lam_den) ** (e.rcl_fac2 * e.rcl_const6r)
            ztemp = e.rcl_fzrab * (ztp1 - RTT)
            zfrz_het = (
                ptsphy * (e.rcl_const5r / zrho)
                * (jnp.exp(ztemp) - 1.0)
                * zlambda_c6
            )
            zfrzmax_liq = jnp.maximum(zfrz_het, 0.0)
            zcons1f = jnp.abs(ptsphy * (1.0 + 0.5 * (RTT - ztp1)) / e.rtaumel)
            zfrzmax_mix = jnp.maximum((RTT - ztp1) * zcons1f * zrldcp, 0.0)
            zfrzmax = jnp.where(llrainliq, zfrzmax_liq, zfrzmax_mix)
            frz_m = frz_cold & (zfrzmax > ZEPSEC)
            zfrz = jnp.minimum(zqx[IR], zfrzmax)
            amt = madd(frz_m, zfrz)
            sa_sr = sadd(sa_sr, amt)
            sa_rs = sadd(sa_rs, -amt)

            # 4.5 rain evaporation (ref: 2114-2281)
            if c.IEVAPRAIN == 1:  # Sundqvist scheme (ref: 2121-2184)
                zzrh = e.rprecrhmax + (
                    1.0 - e.rprecrhmax
                ) * zcovpmax / jnp.maximum(ZEPSEC, 1.0 - za)
                zzrh = jnp.minimum(jnp.maximum(zzrh, e.rprecrhmax), 1.0)
                zqe = (zqx[IV] - za * zqsliq) / jnp.maximum(ZEPSEC, 1.0 - za)
                zqe = jnp.maximum(0.0, jnp.minimum(zqe, zqsliq))
                llo1 = (
                    (zcovpclr > ZEPSEC)
                    & (qf_r > ZEPSEC)
                    & (zqe < zzrh * zqsliq)
                )
                denom = covp * zdtgdp
                denom = jnp.sign(denom) * jnp.maximum(jnp.abs(denom), zepsilon)
                denom = jnp.where(denom == 0.0, zepsilon, denom)
                zpreclr = qf_r * zcovpclr / denom
                zbeta1 = (
                    jnp.sqrt(pap / paph_surf)
                    / e.rvrfactor
                    * zpreclr
                    / jnp.maximum(zcovpclr, ZEPSEC)
                )
                b1_pos = zbeta1 > 0.0
                b1_pow = jnp.where(
                    b1_pos, jnp.where(b1_pos, zbeta1, 1.0) ** 0.5777, 0.0
                )
                zbeta = RG * e.rpecons * 0.5 * b1_pow
                zdenom = 1.0 + zbeta * ptsphy * zcorqsliq
                zdpr = zcovpclr * zbeta * (zqsliq - zqe) / zdenom * zdp * zrg_r
                zdpevap = zdpr * zdtgdp
                zevap = jnp.minimum(zdpevap, qf_r)
                # same diagnostic skip tag as the IEVAPRAIN==2 branch so
                # kernel-lab attribution works under either scheme config
                amt = madd(llo1, zevap)
                sa_vr = sadd(sa_vr, amt)
                sa_rv = sadd(sa_rv, -amt)
                covp = jnp.where(
                    llo1,
                    jnp.maximum(
                        e.rcovpmin,
                        covp
                        - jnp.maximum(
                            0.0,
                            (covp - za) * zevap
                            / jnp.where(llo1, qf_r, 1.0),
                        ),
                    ),
                    covp,
                )
                qf_r = qf_r - amt
            elif c.IEVAPRAIN == 2:
                zzrh = e.rprecrhmax + (
                    1.0 - e.rprecrhmax
                ) * zcovpmax / jnp.maximum(ZEPSEC, 1.0 - za)
                zzrh = jnp.minimum(jnp.maximum(zzrh, e.rprecrhmax), 1.0)
                zzrh = jnp.minimum(0.8, zzrh)
                zqe = jnp.maximum(0.0, jnp.minimum(zqx[IV], zqsliq))
                llo1 = (
                    (zcovpclr > ZEPSEC)
                    & (qf_r > ZEPSEC)
                    & (zqe < zzrh * zqsliq)
                )
                zpreclr = qf_r / jnp.where(llo1, covp, 1.0)
                zesatliq = RV / RD * x["zfoeeliq"]
                lam_den = jnp.where(llo1, zrho * zpreclr, 1.0)
                lam_base = e.rcl_fac1 / lam_den
                # T**3._JPRB is a *real* power in the Fortran; x*x*x differs
                # by ulps only, far inside the validation tolerance
                zevap_denom = (
                    e.rcl_cdenom1 * zesatliq
                    - e.rcl_cdenom2 * ztp1 * zesatliq
                    + e.rcl_cdenom3 * (ztp1 * ztp1 * ztp1) * pap
                )
                ztq = ztp1 / 273.0
                zcorr2 = ztq * jnp.sqrt(ztq) * 393.0 / (ztp1 + 120.0)
                zsubsat = jnp.maximum(zzrh * zqsliq - zqe, 0.0)
                zbeta = (
                    (0.5 / zqsliq) * ztp1**2 * zesatliq
                    * e.rcl_const1r
                    * (zcorr2 / zevap_denom)
                    * (
                        0.78 / lam_base ** (e.rcl_fac2 * e.rcl_const4r)
                        + e.rcl_const2r
                        * jnp.sqrt(zrho * zfallcorr)
                        / (
                            jnp.sqrt(zcorr2)
                            * lam_base ** (e.rcl_fac2 * e.rcl_const3r)
                        )
                    )
                )
                zdenom = 1.0 + zbeta * ptsphy
                zdpevap = zcovpclr * zbeta * ptsphy * zsubsat / zdenom
                zevap = jnp.minimum(zdpevap, qf_r)
                amt = madd(llo1, zevap)
                sa_vr = sadd(sa_vr, amt)
                sa_rv = sadd(sa_rv, -amt)
                covp = jnp.where(
                    llo1,
                    jnp.maximum(
                        e.rcovpmin,
                        covp
                        - jnp.maximum(
                            0.0,
                            (covp - za) * zevap
                            / jnp.where(llo1, qf_r, 1.0),
                        ),
                    ),
                    covp,
                )
                qf_r = qf_r - amt
            else:
                raise NotImplementedError(f"IEVAPRAIN={c.IEVAPRAIN} unknown")
            return (sa_sr, sa_rs, sa_vr, sa_rv, covp, qf_r)

        (
            solqa[IS][IR], solqa[IR][IS], solqa[IV][IR], solqa[IR][IV],
            zcovptot, zqxfg[IR],
        ) = inert_skip(
            rain_m2,
            _rain_active,
            (
                *(zero if v is None else v for v in _rsqa0),
                zcovptot,
                zqxfg[IR],
            ),
            force=force_on,
            tag="rain",
        )

        # 4.5 snow sublimation, Sundqvist (ref: 2289-2347)
        if c.IEVAPSNOW == 1:
            zzrh = e.rprecrhmax + (1.0 - e.rprecrhmax) * zcovpmax / jnp.maximum(
                ZEPSEC, 1.0 - za
            )
            zzrh = jnp.minimum(jnp.maximum(zzrh, e.rprecrhmax), 1.0)
            zqe = (zqx[IV] - za * zqsice) / jnp.maximum(ZEPSEC, 1.0 - za)
            zqe = jnp.maximum(0.0, jnp.minimum(zqe, zqsice))
            llo1 = (
                (zcovpclr > ZEPSEC)
                & (zqxfg[IS] > ZEPSEC)
                & (zqe < zzrh * zqsice)
            )
            denom = zcovptot * zdtgdp
            denom = jnp.sign(denom) * jnp.maximum(jnp.abs(denom), zepsilon)
            denom = jnp.where(denom == 0.0, zepsilon, denom)
            zpreclr = zqxfg[IS] * zcovpclr / denom
            zbeta1 = (
                jnp.sqrt(pap / paph_surf)
                / e.rvrfactor
                * zpreclr
                / jnp.maximum(zcovpclr, ZEPSEC)
            )
            b1_pos = zbeta1 > 0.0
            b1_pow = jnp.where(
                b1_pos, jnp.where(b1_pos, zbeta1, 1.0) ** 0.5777, 0.0
            )
            zbeta = RG * e.rpecons * b1_pow
            zdenom = 1.0 + zbeta * ptsphy * zcorqsice
            zdpr = zcovpclr * zbeta * (zqsice - zqe) / zdenom * zdp * zrg_r
            zdpevap = zdpr * zdtgdp
            zevap = jnp.minimum(zdpevap, zqxfg[IS])
            amt = madd(llo1, zevap)
            solqa[IV][IS] = sadd(solqa[IV][IS], amt)
            solqa[IS][IV] = sadd(solqa[IS][IV], -amt)
            zcovptot = jnp.where(
                llo1,
                jnp.maximum(
                    e.rcovpmin,
                    zcovptot
                    - jnp.maximum(
                        0.0,
                        (zcovptot - za) * zevap
                        / jnp.where(llo1, zqxfg[IS], 1.0),
                    ),
                ),
                zcovptot,
            )
            zqxfg[IS] = zqxfg[IS] - amt
        elif c.IEVAPSNOW == 2:  # PSD-based sublimation (ref: 2349-2419)
            zzrh = e.rprecrhmax + (1.0 - e.rprecrhmax) * zcovpmax / jnp.maximum(
                ZEPSEC, 1.0 - za
            )
            zzrh = jnp.minimum(jnp.maximum(zzrh, e.rprecrhmax), 1.0)
            zqe = (zqx[IV] - za * zqsice) / jnp.maximum(ZEPSEC, 1.0 - za)
            zqe = jnp.maximum(0.0, jnp.minimum(zqe, zqsice))
            llo1 = (
                (zcovpclr > ZEPSEC)
                & (zqx[IS] > ZEPSEC)
                & (zqe < zzrh * zqsice)
            )
            zpreclr = zqx[IS] / jnp.where(llo1, jnp.maximum(zcovptot, ZEPSEC), 1.0)
            zvpice2 = x["zfoeeice"] * RV / RD
            # ZTCG = ZFACX1S = 1 (ref: 2382-2387)
            zaplusb = (
                e.rcl_apb1 * zvpice2 - e.rcl_apb2 * zvpice2 * ztp1
                + pap * e.rcl_apb3 * (ztp1 * ztp1 * ztp1)
            )
            zcorrfac = jnp.sqrt(1.0 / zrho)
            ztq = ztp1 / 273.0
            zcorrfac2 = ztq * jnp.sqrt(ztq) * (393.0 / (ztp1 + 120.0))
            zpr02 = zrho * zpreclr * e.rcl_const1s
            zterm1 = (
                (zqsice - zqe) * ztp1**2 * zvpice2 * zcorrfac2
                * e.rcl_const2s / (zrho * zaplusb * zqsice)
            )
            p2_pos = zpr02 > 0.0
            zpr02s = jnp.where(p2_pos, zpr02, 1.0)
            zterm2 = (
                0.65 * e.rcl_const6s
                * jnp.where(p2_pos, zpr02s ** e.rcl_const4s, 0.0)
                + e.rcl_const3s * jnp.sqrt(zcorrfac) * jnp.sqrt(zrho)
                * jnp.where(p2_pos, zpr02s ** e.rcl_const5s, 0.0)
                / jnp.sqrt(zcorrfac2)
            )
            zdpevap = jnp.maximum(zcovpclr * zterm1 * zterm2 * ptsphy, 0.0)
            zevaplimice = jnp.maximum((zqsice - zqx[IV]) / zcorqsice, 0.0)
            zevap = jnp.minimum(zdpevap, zevaplimice)
            zevap = jnp.minimum(zevap, zqx[IS])
            amt = madd(llo1, zevap)
            solqa[IV][IS] = sadd(solqa[IV][IS], amt)
            solqa[IS][IV] = sadd(solqa[IS][IV], -amt)
            zcovptot = jnp.where(
                llo1,
                jnp.maximum(
                    e.rcovpmin,
                    zcovptot
                    - jnp.maximum(
                        0.0,
                        (zcovptot - za) * zevap / jnp.where(llo1, zqx[IS], 1.0),
                    ),
                ),
                zcovptot,
            )
            zqxfg[IS] = zqxfg[IS] - amt
        else:
            raise NotImplementedError(f"IEVAPSNOW={c.IEVAPSNOW} unknown")

        # 4.6 evaporate small precipitation amounts (ref: 2426-2435)
        for m in (IR, IS):
            small = zqxfg[m] < e.rlmin
            solqa[IV][m] = sadd(solqa[IV][m], madd(small, zqxfg[m]))
            solqa[m][IV] = sadd(solqa[m][IV], -madd(small, zqxfg[m]))

        # ==============================================================
        # 5.2.1 conservation scaling of explicit sinks (ref: 2467-2580)
        # ==============================================================
        # The Fortran sorts the 5 species by run-out ratio (ascending strict-<
        # scan; first minimum wins, ref: 2502-2527) then, in that order, rescales
        # the negative entries of the selected row and column, recomputing the
        # scale factor from the updated matrix each round (ref: 2533-2580).
        #
        # The ordering here is computed as lexicographic (ratio, species-index)
        # ranks from pairwise comparisons — identical to the sequential scan
        # including its tie rule. The rescale rounds are unavoidable (each round's
        # factor depends on the previous round's updates) but run on the sparse
        # matrix with one-hot row/column gathers.
        zsinksum = [
            schain([sneg(solqa[m][n]) for n in range(NCLV)]) for m in range(NCLV)
        ]
        zmax = [jnp.maximum(zqx[m], ZEPSEC) for m in range(NCLV)]
        # Dynamic fast path: when NO species overshoots anywhere in this batch
        # (kernel: this column block; scan: the whole batch), every scale factor
        # is exactly 1.0 — zratio is 1.0 wherever sink <= zmax, every round
        # recomputes the same plain sums and again selects 1.0, and the final
        # application multiplies each entry by 1.0. The rescale is the bitwise
        # identity, so the 5 sequential rounds are skipped entirely. (Written
        # as a select, not as zmax/zmax: the factor must be exactly 1 under
        # an approximate division too, or a column's result would depend on
        # whether its block-mates overshoot.) Levels with no active
        # sink anywhere are common (60% of the snapshot's levels measured in
        # fp64), and the reference's own rescale self-disables the same way via
        # its ratio formula (ref: 2492-2498).
        def _no_overshoot():
            acc = None
            for m in range(NCLV):
                lvl_ok = block_all(zsinksum[m] <= zmax[m])
                acc = lvl_ok if acc is None else (acc & lvl_ok)
            return acc

        sq_idx = [
            (m, n)
            for m in range(NCLV)
            for n in range(NCLV)
            if solqa[m][n] is not None
        ]

        def _rescale_sinks(vals):
            sq = [[None] * NCLV for _ in range(NCLV)]
            for (m, n), v in zip(sq_idx, vals):
                sq[m][n] = v
            # a species that does not overshoot gets exactly 1.0 whatever
            # the division's rounding: IEEE division gives zmax/zmax == 1,
            # but Triton's fp32 division (div.full.f32) is 2 ulp, and a
            # factor of 1 - ulp would make an inert column's result depend
            # on whether a block-mate overshoots (NaN still propagates)
            zratio = [
                jnp.where(zsinksum[m] <= zmax[m], 1.0,
                          zmax[m] / jnp.maximum(zsinksum[m], zmax[m]))
                for m in range(NCLV)
            ]
            iz = jnp.zeros_like(ztp1, dtype=jnp.int32)
            rank = []
            for m in range(NCLV):
                r = iz
                for n in range(NCLV):
                    if n == m:
                        continue
                    if n < m:
                        r = r + (zratio[n] <= zratio[m]).astype(jnp.int32)
                    else:
                        r = r + (zratio[n] < zratio[m]).astype(jnp.int32)
                rank.append(r)
            # Lazy-scaling rounds. The sequential algorithm only ever applies TWO
            # factors to an entry: ratio(row species, at its round) when the
            # entry is negative, and ratio(column species, at its round) when the
            # MIRRORED entry is negative (ref: 2566-2576). Since every species is
            # selected exactly once, the round-r sink for species m needs the
            # original row m with at most ONE prior factor applied — the column
            # update from species n with rank[n] < rank[m] and a negative
            # mirrored entry. With ratio_fin initialised to 1 and finalised
            # rank-by-rank, a dense per-species sink recompute each round
            # reproduces the sequential values exactly (same per-term products,
            # same left-to-right summation); the factors are then applied per
            # entry once at the end. Signs never change under the positive
            # scalings, so all masks come from the original matrix.
            neg0 = [
                [None if sq[m][n] is None else sq[m][n] < 0.0
                 for n in range(NCLV)]
                for m in range(NCLV)
            ]
            # prec[m][n]: entry (m, n) receives species-n's column factor BEFORE
            # species-m's own round
            prec = [
                [
                    None if (n == m or neg0[n][m] is None)  # rank[m]<rank[m] never
                    else (neg0[n][m] & (rank[n] < rank[m]))
                    for n in range(NCLV)
                ]
                for m in range(NCLV)
            ]
            one = jnp.ones_like(ztp1)
            # Round 0 reuses the ordering ratio: with every ratio_fin still 1 the
            # round-0 sink recompute is term-for-term (and summation-order)
            # identical to zsinksum, so the first-selected species' factor IS
            # zratio — bitwise. (ref: 2543-2560 recompute the same plain sum the
            # ordering used at 2481-2498.) Rounds 1..NCLV-1 remain data-dependent.
            ratio_fin = [
                jnp.where(rank[m] == 0, zratio[m], one) for m in range(NCLV)
            ]
            zmaxe = [jnp.maximum(zqx[m], ZEPSEC) for m in range(NCLV)]
            # Per-round dynamic skip (CLOUDSC_S521_ROUND_SKIP=1). The initial
            # overshoot count is NOT a sound round predicate: a round scales
            # both the negative entry AND its mirror (ref: 2571-2575), so an
            # earlier round can shrink another species' SOURCES and induce an
            # overshoot that was not there initially. The sound guard is the
            # worst case over any factors f in (0, 1]: the recomputed sink of
            # species m at its round is sum_n(-sq[m][n]*f_n) where negative
            # entries contribute at most their unscaled value and positive
            # entries contribute <= 0, so it is bounded by the negative-
            # entries-only sum. A species with that bound <= zmax can NEVER
            # overshoot; its round selects ratio_sel == 1.0
            # exactly and is the bitwise identity. Round r is therefore
            # skippable when every column's rank-r species carries the
            # guarantee — a batch-level lax.cond, value-exact like the outer
            # no-overshoot skip (which is the all-species case of this bound).
            never_over = None
            if c.s521_round_skip:
                never_over = []
                for m in range(NCLV):
                    npart = None
                    for n in range(NCLV):
                        if sq[m][n] is None:
                            continue
                        npart = sadd(
                            npart, madd(sq[m][n] < 0.0, -sq[m][n])
                        )
                    never_over.append(
                        jnp.ones_like(zmax[m], dtype=bool)
                        if npart is None else (npart <= zmax[m])
                    )
            for round_i in range(1, NCLV):
                # exactly ONE species has rank == round_i per column, so the
                # round's division is done once on the one-hot-selected
                # (numerator, denominator) pair — bitwise identical to dividing
                # per species (summing four exact zeros and one value changes no
                # bits), and 4 fewer divides per round
                def _round(rf, _r=round_i):
                    ratio_fin = list(rf)
                    sel = [rank[m] == _r for m in range(NCLV)]
                    num = None
                    den = None
                    for m in range(NCLV):
                        sink = None
                        for n in range(NCLV):
                            if sq[m][n] is None:
                                continue
                            v = sq[m][n]
                            if prec[m][n] is not None:
                                v = v * jnp.where(prec[m][n], ratio_fin[n], 1.0)
                            sink = sadd(sink, -v)
                        num = sadd(num, madd(sel[m], zmaxe[m]))
                        den = sadd(
                            den, madd(sel[m], jnp.maximum(sink, zmaxe[m]))
                        )
                    # den >= num; equal means no overshoot: exactly 1.0,
                    # as for zratio above
                    ratio_sel = jnp.where(den <= num, 1.0, num / den)
                    for m in range(NCLV):
                        ratio_fin[m] = jnp.where(sel[m], ratio_sel, ratio_fin[m])
                    return tuple(ratio_fin)

                if c.s521_round_skip:
                    unsafe = None
                    for m in range(NCLV):
                        u = (rank[m] == round_i) & jnp.logical_not(
                            never_over[m]
                        )
                        unsafe = u if unsafe is None else (unsafe | u)
                    if probe_hook is not None:
                        probe_hook(f"s521r{round_i}", unsafe)
                    need = block_any(unsafe)
                    if force_on is not None:
                        need = need | force_on
                    ratio_fin = list(jax.lax.cond(
                        need, _round, lambda rf: rf, tuple(ratio_fin)
                    ))
                else:
                    ratio_fin = list(_round(tuple(ratio_fin)))
            out = []
            for m, n in sq_idx:
                v = sq[m][n]
                if neg0[m][n] is not None:
                    v = v * jnp.where(neg0[m][n], ratio_fin[m], 1.0)
                if neg0[n][m] is not None:
                    v = v * jnp.where(neg0[n][m], ratio_fin[n], 1.0)
                out.append(v)
            return tuple(out)

        vals0 = tuple(solqa[m][n] for m, n in sq_idx)
        if probe_hook is not None:
            _over = None
            for m in range(NCLV):
                o = zsinksum[m] > zmax[m]
                _over = o if _over is None else (_over | o)
            probe_hook("s521", _over)
        pred_skip = _no_overshoot()
        if force_on is not None:
            pred_skip = pred_skip & jnp.logical_not(force_on)
        scaled = jax.lax.cond(
            pred_skip, lambda vals: vals, _rescale_sinks, vals0
        )
        for (m, n), v in zip(sq_idx, scaled):
            solqa[m][n] = v

        # ==============================================================
        # 5.2.2 implicit 5x5 solve (LHS build + non-pivoting LU,
        #       ref: 2589-2668) — unrolled with structural zeros skipped
        # ==============================================================
        one = jnp.ones_like(ztp1)
        qlhs = [[None] * NCLV for _ in range(NCLV)]
        for mcol in range(NCLV):
            diag = sadd(one, zfallsink[mcol])
            for o in range(NCLV):
                diag = sadd(diag, solqb[o][mcol])
            qlhs[mcol][mcol] = diag
        for nrow in range(NCLV):
            for mcol in range(NCLV):
                if nrow != mcol:
                    qlhs[nrow][mcol] = sneg(solqb[nrow][mcol])
        zqxn = [
            zqx[m]
            + chain([solqa[m][n] for n in range(NCLV) if solqa[m][n] is not None])
            for m in range(NCLV)
        ]
        # non-pivoting recursive factorization (ref: 2640-2650); eliminating a
        # structural zero is a no-op, so the sparse skip is value-exact
        for jn in range(NCLV - 1):
            for jm in range(jn + 1, NCLV):
                if qlhs[jm][jn] is None:
                    continue
                qlhs[jm][jn] = qlhs[jm][jn] / qlhs[jn][jn]
                for ik in range(jn + 1, NCLV):
                    if qlhs[jn][ik] is None:
                        continue
                    qlhs[jm][ik] = sadd(
                        qlhs[jm][ik], -(qlhs[jm][jn] * qlhs[jn][ik])
                    )
        # backsubstitution (ref: 2654-2668)
        for jn in range(1, NCLV):
            for jm in range(jn):
                if qlhs[jn][jm] is not None:
                    zqxn[jn] = zqxn[jn] - qlhs[jn][jm] * zqxn[jm]
        zqxn[NCLV - 1] = zqxn[NCLV - 1] / qlhs[NCLV - 1][NCLV - 1]
        for jn in range(NCLV - 2, -1, -1):
            for jm in range(jn + 1, NCLV):
                if qlhs[jn][jm] is not None:
                    zqxn[jn] = zqxn[jn] - qlhs[jn][jm] * zqxn[jm]
            zqxn[jn] = zqxn[jn] / qlhs[jn][jn]

        # clip small/negative values to vapour (ref: 2673-2680)
        for n in (IL, II, IR, IS):
            neg_n = zqxn[n] < ZEPSEC
            zqxn[IV] = zqxn[IV] + madd(neg_n, zqxn[n])
            zqxn[n] = jnp.where(neg_n, 0.0, zqxn[n])

        # ==============================================================
        # 5.3 precipitation flux to the next level (ref: 2698-2712)
        # ==============================================================
        pfplsx_next = [
            zero if zfallsink[m] is None else zfallsink[m] * zqxn[m] * zrdtgdp
            for m in range(NCLV)
        ]
        zqpre2 = pfplsx_next[IS] + pfplsx_next[IR]
        zcovptot = jnp.where(zqpre2 < ZEPSEC, 0.0, zcovptot)

        # ==============================================================
        # 6. tendencies (ref: 2722-2773)
        # ==============================================================
        tend_t = x["tend_t_pre"]
        for m in (IL, II, IR, IS):
            sinks = sadd(zfallsink[m], zconvsink[m])
            zfluxq = sadd(
                sadd(sadd(zpsupsatsrce[m], zconvsrce[m]), zfallsrce[m]),
                None if sinks is None else -(sinks * zqxn[m]),
            )
            lat = RALVDCP if IPHASE[m] == 1 else RALSDCP
            tend_t = tend_t + lat * (zqxn[m] - zqx[m] - zfluxq) * zqtmst
        tend_q = x["tend_q_pre"] + (zqxn[IV] - zqx[IV]) * zqtmst

        return (*zqxn, *pfplsx_next, tend_t, tend_q, zcovptot,
                zcovpmax)

    # ==============================================================
    # 5.1 cloud-fraction solver (ref: 2446-2455)
    # ==============================================================
    zanew = jnp.minimum((za + solac) / (1.0 + solab), 1.0)
    zanew = jnp.where(zanew < e.ramin, 0.0, zanew)
    zda = zanew - x["zaorig"]
    zanewm1_new = zanew

    _ops = (
        # inert seeds: the solve is the identity on skipped levels (new
        # state = old state), the precip fluxes out are zero, and the
        # section-6 increments vanish term by term (see the region_m
        # note above; proven value-exact by tests/test_invariance.py)
        *zqx,
        *(zero,) * NCLV,
        x["tend_t_pre"],
        x["tend_q_pre"],
        # exactly 0 whenever the guard is False (5.3 zeroes it unless
        # the level above emitted a flux, and any incoming flux sets
        # pre_m)
        carry["zcovptot"],
        # write-only output: the zero seed IS its exact inert value
        zero,
    )
    _out = inert_skip(region_m, _precip_active, _ops, force=force_on,
                      tag="precip")
    zqxn = list(_out[:NCLV])
    pfplsx_next = list(_out[NCLV:2 * NCLV])
    tend_t, tend_q, zcovptot, zcovpmax = _out[2 * NCLV:]
    tend_a = zda * zqtmst

    new_carry = dict(
        zanewm1=zanewm1_new,
        zqxnm1=list(zqxn),
        pfplsx=pfplsx_next,
        zcovptot=zcovptot,
        zcovpmax=zcovpmax,
        zcldtopdist=zcldtopdist,
        llrainliq=llrainliq,
        prainfrac=prainfrac,
    )
    ys = dict(
        zqxn=list(zqxn),
        pfplsx_next=pfplsx_next,
        plude=plude_out,
        pcovptot=zcovptot,
        tend_t=tend_t,
        tend_q=tend_q,
        tend_a=tend_a,
    )
    return new_carry, ys
