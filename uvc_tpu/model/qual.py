"""Final variant qualities: vectorized BcfFormat_symbol_calc_qual
(main.hpp:4908-5343).

Produces, per (pos, symbol): the binomial-tier qualities bIAQ/cIAQ, the
power-law qualities cPLQ1/2 and their caps cPCQ1/2, duplex increment
dVQinc, systematic caps bMQQ (MQ) and aBQQ (BQ, from fmtarrays), T-in-N
contamination qualities bTINQ/cTINQ, the germline quality gVQ1, the final
somatic tiers cVQ1/cVQ2, and the contamination LOD CONTQ.
"""

import functools
import math

import jax.numpy as jnp

from ..constants import Symbol, NUM_SYMBOLS, SequencingPlatform
from .dpv import (IS_SUBST, IS_INS, IS_DEL, numstates2phred, phred2nat,
                  _ftype, _itype, _minr, _maxr)
from . import sscs as sscs_mod

# traced together with dpv.calc_dpv into the one jitted model program
# (see calling.model_stage); float64 on CPU (x64), float32/int32 on GPU
np = jnp

NS = NUM_SYMBOLS
INV_LOG10 = 10.0 / math.log(10.0)
FLT_EPSILON = 1.1920928955078125e-07
INS_N_ANCHOR_BASES = 1
TIN_CONTAM_MICRO_VQ_DELTA = 0


def binom_lr(prob, a, b, bidirectional=False):
    DBL_EPSILON = 2.220446049250313e-16
    prob = (np.asarray(prob, _ftype()) + DBL_EPSILON) / (1.0 + 2.0 * DBL_EPSILON)
    a = np.asarray(a, _ftype()) + DBL_EPSILON
    b = np.asarray(b, _ftype()) + DBL_EPSILON
    A = prob * (a + b)
    B = (1.0 - prob) * (a + b)
    lr = INV_LOG10 * (a * np.log(a / A) + b * np.log(b / B))
    if bidirectional:
        return lr
    return np.where(a > A, lr, 0.0)


_N_UNITS_TO_PHRED = (0, 0, 3, 5, 6, 7, 8, 8, 9, 10, 10, 10, 11, 11, 11,
                     12, 12, 12, 13)
DBL_EPS_ = 2.220446049250313e-16


def _indel_phred_j(ampfact, repeatsize, repeatnum):
    repeatsize = jnp.asarray(repeatsize, _ftype())
    region_size = repeatsize * jnp.asarray(repeatnum, _ftype())
    num_slips = jnp.where(region_size > 64, region_size - 8.0,
                          jnp.log1p(jnp.exp(jnp.minimum(region_size, 65.0) - 8.0)))
    num_slips = num_slips * ampfact / (repeatsize * repeatsize)
    prob = (1.0 - DBL_EPS_) / (num_slips + 1.0)
    return jnp.floor(-10.0 * jnp.log10(prob)).astype(_itype())


def _indel_len_rusize_phred_j(indel_len, repeatunit_size):
    indel_len = jnp.asarray(indel_len, _itype())
    ru = jnp.asarray(repeatunit_size, _itype())
    exact = indel_len % ru == 0
    n_units = jnp.where(exact, indel_len // ru, indel_len)
    tab = jnp.asarray(_N_UNITS_TO_PHRED, dtype=_itype())
    return tab[jnp.minimum(n_units, len(_N_UNITS_TO_PHRED) - 1)]


def calc_qual(F, cfg, is_tumor_only=True, tpfa=None, tki=None):
    P = F["P"]
    sym = np.broadcast_to(np.arange(NS)[None, :], (P, NS))
    is_subst = np.broadcast_to(IS_SUBST[None, :], (P, NS))
    is_ins = np.broadcast_to(IS_INS[None, :], (P, NS))
    is_del = np.broadcast_to(IS_DEL[None, :], (P, NS))
    is_indel = is_ins | is_del
    refsym = F["ref_syms"][:, None]
    refsym_eff = np.where(is_subst, refsym, int(Symbol.LINK_M))
    is_rescued = not is_tumor_only

    table = jnp.asarray(sscs_mod.table_from_cfg(cfg))
    rescue_add = 0 if is_tumor_only else 4
    sscs_phrederr = table[np.broadcast_to(refsym_eff, (P, NS)), sym] + rescue_add

    cFA2 = (F["cDP2f"] + F["cDP2r"] + 0.5) / (F["CDP2"] + 1.0)
    umi_cFA = (F["cDP2v"] + 0.5) / (F["CDP2"] * 100 + 1.0)
    umi_cFA_w = (F["cDP2w"] + 0.5) / (F["CDP2"] * 100 + 1.0)

    is_AT_TA = (((refsym == 0) & (sym == 3)) | ((refsym == 3) & (sym == 0)))
    pow_origin = np.where(
        is_subst,
        np.where(is_AT_TA, cfg.fam_phred_pow_sscs_transversion_AT_TA_origin,
                 cfg.fam_phred_pow_sscs_snv_origin),
        cfg.fam_phred_pow_sscs_indel_origin)
    powlaw_sscs_inc1 = sscs_phrederr - pow_origin
    max_sscs_sub = max(cfg.fam_phred_sscs_transition_CG_TA,
                       cfg.fam_phred_sscs_transition_AT_GC,
                       cfg.fam_phred_sscs_transversion_CG_AT,
                       cfg.fam_phred_sscs_transversion_other)
    powlaw_sscs_inc4tn = np.where(
        is_subst, max_sscs_sub - cfg.fam_phred_pow_sscs_snv_origin,
        powlaw_sscs_inc1)
    is_oxidation = (((refsym == 1) & (sym == 0)) | ((refsym == 2) & (sym == 3)))
    powlaw_sscs_inc4tn = powlaw_sscs_inc4tn + np.where(
        is_oxidation, cfg.tn_q_inc_max_sscs_CG_AT, cfg.tn_q_inc_max_sscs_other)

    tpfa_arr = tpfa if tpfa is not None else np.full((P, NS), -1.0)
    t2n_contam = np.maximum(tpfa_arr, 0) * cfg.contam_t2n_mul_frac
    contamfrac = cfg.contam_any_mul_frac + (1.0 - cfg.contam_any_mul_frac) * t2n_contam

    aDP = F["aDPff"] + F["aDPfr"] + F["aDPrf"] + F["aDPrr"]
    ADP = F["ADPff"] + F["ADPrf"] + F["ADPfr"] + F["ADPrr"]
    cDP0 = F["cDP1f"] + F["cDP1r"]
    CDP0 = F["CDP1"]
    cDP2 = F["cDP2f"] + F["cDP2r"]
    CDP2 = F["CDP2"]

    aavgMQ = F["aMQs"] // np.maximum(1, aDP)
    diffAaMQs = (F["AMQs"] - F["aMQs"]) // np.maximum(1, ADP - aDP) - aavgMQ
    F["aAaMQ"] = diffAaMQs

    noUMI_bias_inc = np.minimum(cfg.bias_FA_powerlaw_noUMI_phred_inc_snv, aDP // 2)
    pl_noUMI = cfg.powlaw_anyvar_base + np.where(
        is_subst, noUMI_bias_inc, cfg.bias_FA_powerlaw_noUMI_phred_inc_indel)
    withUMI_bias_inc = np.minimum(
        cfg.bias_FA_powerlaw_withUMI_phred_inc_snv
        - cfg.bias_FA_powerlaw_noUMI_phred_inc_snv, cDP2 // 2) + noUMI_bias_inc
    pl_withUMI = cfg.powlaw_anyvar_base + np.where(
        is_subst, withUMI_bias_inc, cfg.bias_FA_powerlaw_withUMI_phred_inc_indel)

    prior_w = 1.0 / (F["cDPmf"] + F["cDPmr"] + 1.0)
    fam_thres_hbq = np.where(is_subst, cfg.fam_thres_highBQ_snv,
                             cfg.fam_thres_highBQ_indel)
    cMmQ = np.round(numstates2phred(
        (F["cDPMf"] + F["cDPmf"] + F["cDPMr"] + F["cDPmr"]
         + np.power(10.0, fam_thres_hbq / 10.0) * prior_w)
        / (F["cDPmf"] + F["cDPmr"] + prior_w))).astype(_itype())
    F["cMmQ"] = cMmQ

    nb1 = F["bIADb"] * 100 + 1
    nb2 = np.minimum(nb1, F["cDP1v"] + 1)
    pb1 = 10 * F["bIAQb"] // np.maximum(1, F["bIADb"])
    pb2 = pb1 + np.round(10 * numstates2phred(nb2 / nb1)).astype(_itype())
    duped_frag_binom_qual = np.where(is_indel, pb1, pb2) * nb2 // (10 * 100)
    contam_frag_q = np.round(binom_lr(t2n_contam, cDP0, CDP0 - cDP0)).astype(_itype()) + 9 - 3

    h3_snp = max(0, 2 * cfg.germ_phred_hetero_snp - cfg.germ_phred_het3al_snp
                 - TIN_CONTAM_MICRO_VQ_DELTA)
    h3_indel = max(0, 2 * cfg.germ_phred_hetero_indel - cfg.germ_phred_het3al_indel
                   - TIN_CONTAM_MICRO_VQ_DELTA)
    h3inc = np.where(is_subst, h3_snp, h3_indel)
    h3inc = np.where(is_indel, np.maximum(h3_indel + 1 - F["gapLen"], 0), h3inc)
    contam_bypassed = h3inc

    normcDP1 = F["cDP12f"] + F["cDP12r"] + 1
    normCDP1 = F["CDP12"] + 1
    normBDP = F["BDP"] + 1
    d1 = 2 if is_rescued else 1
    dec1a = np.where((cfg.fam_min_n_copies // d1 <= normCDP1)
                     | (cfg.fam_min_n_copies_DPxAD // d1 <= normCDP1 * normcDP1),
                     0, powlaw_sscs_inc1 + 3)
    dec1b = np.where(((cfg.fam_min_overseq_perc - 100) // d1 + 100) * normCDP1
                     <= 100 * normBDP, 0, powlaw_sscs_inc1 + 3)
    sscs_dec1 = np.maximum(dec1a, dec1b)
    sscs_dec2 = np.maximum(fam_thres_hbq - cMmQ, 0)
    cIADn = (F["cIADf"] + F["cIADr"]) * 100 + 1
    cIADmin = np.minimum(cIADn, F["cDP2v"] + 1)

    sscs_fw = F["cIAQf"] + F["cIAQr"] * np.minimum(
        cfg.fam_phred_dscs_all - F["cIDQf"], F["cIDQr"]) // np.maximum(F["cIDQr"], 1)
    sscs_rv = F["cIAQr"] + F["cIAQf"] * np.minimum(
        cfg.fam_phred_dscs_all - F["cIDQr"], F["cIDQf"]) // np.maximum(F["cIDQf"], 1)
    contam_sscs_q = np.round(binom_lr(t2n_contam, cDP2, CDP2 - cDP2)).astype(_itype()) + 9 - 3

    sscs_max = np.maximum(sscs_fw, sscs_rv)
    sscs_binom_qual = (np.maximum(
        sscs_max - (numstates2phred(cIADn / cIADmin) * cIADn / 100.0), 0)
        .astype(_itype()) * cIADmin) // cIADn
    halv = cfg.microadjust_fam_binom_qual_halving_thres
    sscs_binom_qual = np.where(
        (sscs_max > halv) & is_subst,
        np.minimum(sscs_binom_qual, halv + (sscs_max - halv) // 2),
        sscs_binom_qual)
    sscs_binom_qual = sscs_binom_qual - sscs_dec1 - sscs_dec2

    min_bcFA_v = (F["cDP1v"] + 0.5) / (F["CDP1"] * 100 + 1.0)
    dedup_v = np.round(cfg.powlaw_exponent * numstates2phred(min_bcFA_v)
                       + pl_noUMI).astype(_itype())
    min_bcFA_w = (F["cDP1w"] + 0.5) / (F["CDP1"] * 100 + 1.0)
    dedup_w = np.round(cfg.powlaw_exponent * numstates2phred(min_bcFA_w)
                       + pl_noUMI + cfg.tn_q_inc_max).astype(_itype())

    ds_vq_pl = np.round(INV_LOG10 * np.minimum(
        np.log((F["cDP12f"] + 0.5) / (F["CDP12b_l"] + 1.0)),
        np.log((F["cDP12r"] + 0.5) / (F["CDP12b_r"] + 1.0)))).astype(_itype()) \
        + sscs_phrederr
    ds_vq_bin = 3 * np.minimum(F["cDP2f"], F["cDP2r"])
    powlaw_sscs_inc2 = np.maximum(0, _minr(
        [sscs_fw, sscs_rv, ds_vq_pl, ds_vq_bin,
         np.full((P, NS), 3)])) * (cFA2 > 0.002)
    sscs_dec3 = (-3) if is_rescued else np.where(cFA2 >= 0.003, 0, 5)
    sscs_base_2 = (pl_withUMI + powlaw_sscs_inc1 + powlaw_sscs_inc2
                   - sscs_dec1 - sscs_dec2 - sscs_dec3)
    sscs_base_2tn = (pl_withUMI + powlaw_sscs_inc4tn + powlaw_sscs_inc2
                     - sscs_dec1 - sscs_dec2 - sscs_dec3)
    sscs_v = np.round(cfg.powlaw_exponent * numstates2phred(umi_cFA)
                      + sscs_base_2).astype(_itype())
    sscs_w = np.round(cfg.powlaw_exponent * numstates2phred(umi_cFA_w)
                      + sscs_base_2tn).astype(_itype())

    dFA = (F["dDP2"] + 0.5) / (F["DDP1"] + 1.0)
    dSNR = (F["dDP2"] + 0.5) / (F["dDP1"] + 1.0)
    dnormFA = dFA * np.power(dSNR, 1.0 / cfg.powlaw_exponent)
    dscs_est = np.round((cfg.fam_phred_dscs_max + sscs_phrederr) / 2.0).astype(_itype())
    dFA_vq_binom = ((dscs_est - np.round(numstates2phred(1.0 / dnormFA)).astype(_itype()))
                    * F["dDP2"] * cIADmin // cIADn)
    dFA_vq_powlaw = (cfg.powlaw_anyvar_base
                     + (dscs_est - cfg.fam_phred_pow_dscs_all_origin)
                     + np.round(numstates2phred(dnormFA * np.minimum(
                         1.0, (F["cDP1v"] + 0.5) / (F["CDP1"] * 100 + 1.0))))
                     ).astype(_itype())

    # IonTorrent-only flat near-indel penalty applied to every allele
    # quality of the position (is_indel_penal_applied, main.hpp:5199-5204);
    # C round() is half-AWAY-from-zero — floor(x+0.5) for the non-negative
    # log ratio, not banker's rounding
    is_proton = (cfg.inferred_sequencing_platform
                 == SequencingPlatform.IONTORRENT)
    if is_proton and not is_rescued:
        _e = FLT_EPSILON
        _m3 = _maxr([aDP + _e, F["APDP"][:, 1][:, None],
                     F["APDP"][:, 2][:, None]])
        indel_penal_base = np.floor(
            cfg.indel_multiallele_samepos_penal / math.log(2.0)
            * np.log(_m3 / (aDP + _e)) + 0.5).astype(_itype())
    else:
        indel_penal_base = np.zeros((P, NS), dtype=_itype())

    # indel-specific adjustments (main.hpp:5122-5181)
    repeatnum = F["ctx_repeatnum"][:, None].astype(_itype())
    repeatsize = F["ctx_unitlen"][:, None].astype(_itype())
    has_indelstr = (F["gapLen"] > 0) & (F["cDP0a"] > 0) & is_indel
    indel_pq = np.minimum(_indel_phred_j(
        cfg.indel_polymerase_slip_rate, repeatsize, repeatnum), 24) + 2 - 10.0
    eff_tl1 = repeatsize * np.maximum(1, repeatnum) - repeatsize
    eff_tl2 = np.maximum(F["rtr1_tracklen_3"] - F["rtr1_unitlen_3"],
                         F["rtr2_tracklen_3"] - F["rtr2_unitlen_3"])[:, None] // 3
    eff_tl = np.maximum(eff_tl1, eff_tl2)
    indel_ic = (numstates2phred(
        np.maximum(F["gapLen"] + np.where(is_ins, INS_N_ANCHOR_BASES, 0), 1)
        / (eff_tl + 1.0))
        + np.where(is_ins, numstates2phred(cfg.indel_del_to_ins_err_ratio)
                   * np.minimum(200, F["cDP0a"]) / 200.0, 0.0))
    ins_cd = F["ins_cdepth"][:, None]
    del_cd = F["del_cdepth"][:, None]
    ins1_cd = F["ins1_cdepth"][:, None]
    del1_cd = F["del1_cdepth"][:, None]
    indelcdepth = np.where(is_ins, ins_cd, del_cd).astype(_ftype())
    indelcdepth = np.where(sym == int(Symbol.LINK_D1), indelcdepth + ins1_cd, indelcdepth)
    indelcdepth = np.where(sym == int(Symbol.LINK_I1),
                           indelcdepth + del1_cd / cfg.indel_del_to_ins_err_ratio,
                           indelcdepth)
    eps = FLT_EPSILON
    ipm1 = np.round(cfg.indel_multiallele_samepos_penal / math.log(2.0)
                    * np.log((indelcdepth + eps)
                             / (F["cDP0a"] + eps))).astype(_itype())
    nearInDelDP = np.where(is_ins, F["APDP"][:, 1][:, None], F["APDP"][:, 2][:, None])
    ipm2 = np.round(cfg.indel_multiallele_diffpos_penal / math.log(2.0)
                    * np.log((nearInDelDP + eps)
                             / (np.maximum(aDP, nearInDelDP) + eps))).astype(_itype())
    ipg = np.round(cfg.indel_tetraallele_germline_penal_value / math.log(2.0)
                   * np.log((ins_cd + del_cd + eps) / (F["cDP0a"] + eps))
                   ).astype(_itype()) - int(cfg.indel_tetraallele_germline_penal_thres)
    # IonTorrent is more error-prone with complex InDels: be lenient
    # (non_neg_minus of samepos_penal, main.hpp:5244-5246)
    if is_proton:
        ipm1 = np.maximum(ipm1 - int(cfg.indel_multiallele_samepos_penal), 0)
    ins_pc = cfg.indel_ins_penal_pseudocount
    ipm_ins = ipm1 * ins_pc // (ins_pc + F["gapLen"])
    indel_penal4multi = np.where(has_indelstr,
                                 np.where(is_ins, ipm_ins,
                                          np.maximum(ipm1, ipm2)), 0)
    indel_penal4multi_soma = np.where(has_indelstr,
                                      np.where(is_ins, ipm_ins, ipm1), 0)
    indel_penal4multi_g = np.where(has_indelstr, ipg, 0)

    dedup_v = dedup_v + np.where(has_indelstr, np.round(indel_ic).astype(_itype()), 0)
    dedup_w = dedup_w + np.where(has_indelstr, np.round(indel_ic).astype(_itype()), 0)
    duped_frag_binom_qual = duped_frag_binom_qual + np.where(
        has_indelstr, np.round(indel_pq).astype(_itype()), 0)
    sscs_ic = numstates2phred(np.square(np.maximum(F["gapLen"], 1)).astype(_ftype())
                              / (eff_tl + 1.0))
    sscs_ivd = np.round(cfg.powlaw_exponent
                        * numstates2phred(cfg.indel_del_to_ins_err_ratio)).astype(_itype())
    # non_neg_minus(int, double) keeps the subtrahend in DOUBLE (no inner
    # truncation); the final value truncates toward zero at the
    # uvc1_qual_t assignment (main.hpp:5268-5272)
    extra_reward = np.trunc(
        np.maximum(sscs_ivd - sscs_ic * np.where(is_ins, 0, eff_tl)
                   / round(cfg.indel_polymerase_size), 0.0)
        - sscs_ivd // 2).astype(_itype())
    sscs_v = sscs_v + np.where(has_indelstr,
                               np.round(sscs_ic).astype(_itype()) + extra_reward, 0)
    sscs_w = sscs_w + np.where(has_indelstr,
                               np.round(sscs_ic).astype(_itype()) + extra_reward, 0)
    sscs_binom_qual = sscs_binom_qual + np.where(
        has_indelstr, np.round(indel_pq).astype(_itype()) + extra_reward, 0)
    # non_neg_minus of the overseq ratio above the flat threshold, NOT a
    # min-cap (main.hpp:5278-5281)
    indel_UMI_penal = np.where(
        has_indelstr & F["enable_tier2"],
        np.maximum((F["BDP"] + 1.0) / (F["CDP1"] + 1.0)
                   * cfg.fam_indel_nonUMI_phred_dec_per_fold_overseq
                   - (cfg.fam_thres_emperr_all_flat_indel + 1)
                   * cfg.fam_indel_nonUMI_phred_dec_per_fold_overseq,
                   0.0).astype(_itype()), 0)
    if is_rescued:
        sscs_binom_qual = np.where(is_oxidation,
                                   np.maximum(sscs_binom_qual, np.minimum(aDP, 3)),
                                   sscs_binom_qual)

    # systematic MQ cap (main.hpp:5189-5258)
    readlenMQcap = F["APXM"][:, 2][:, None] // np.maximum(1, F["APDP"][:, 0][:, None]) - 17
    diffMQ = np.maximum(0, diffAaMQs)
    is_aln_xacc = cfg.inferred_maxMQ > 60
    msub = np.minimum(cfg.germ_phred_homalt_snp, ADP * 3)
    sysMQadd = np.where(sym == refsym_eff, 0, msub)
    sysMQadd_soma = np.where(sym != refsym_eff, 0, msub)
    is_MQ_unadj = is_aln_xacc | (~is_subst) | (aDP > ADP * 3 // 4)
    sysMQminus = (np.where(is_MQ_unadj, 0, np.maximum(60 - 30 - aavgMQ, 0) * 2 // 5)
                  + np.where(is_MQ_unadj | (sym != refsym_eff), 0,
                             np.maximum(np.minimum(15, diffMQ) - aavgMQ, 0)))
    diffMQ2 = diffMQ.copy()
    if is_tumor_only:
        aDPxf = F["aDPff"] + F["aDPrf"] + 0.5
        aDPxr = F["aDPfr"] + F["aDPrr"] + 0.5
        ADPxf = F["ADPff"] + F["ADPrf"] + 1.0
        ADPxr = F["ADPfr"] + F["ADPrr"] + 1.0
        DBL_EPSILON = 2.220446049250313e-16
        imba = (((aDPxr / ADPxr) * 2 < (aDPxf / ADPxf))
                | ((aDPxf / ADPxf) * 2 < (aDPxr / ADPxr))
                | ((F["aLI1"] + 0.5) / (F["ALI2"] + 1.0) * (2 * (1.0 + DBL_EPSILON)) < aDPxr / ADPxr)
                | ((F["aRI1"] + 0.5) / (F["ARI2"] + 1.0) * (2 * (1.0 + DBL_EPSILON)) < aDPxf / ADPxf))
        low_bmq = F["bMQ"] < 20
        diffMQ2 = np.where(low_bmq & imba,
                           np.maximum(diffMQ2, 20 - np.minimum(F["bMQ"], 20)),
                           diffMQ2)
    sysMQ_base = (F["bMQ"] * (cfg.syserr_MQ_max - int(cfg.syserr_MQ_nonref_base))
                  // cfg.syserr_MQ_max + int(cfg.syserr_MQ_nonref_base)
                  - diffMQ2 - F["bNMQ"])
    sysMQ = np.where((sym == refsym_eff) & (ADP > aDP * 2), F["bMQ"],
                     sysMQ_base - numstates2phred(
                         (ADP + 1.0) / (aDP + 0.5)).astype(_itype()))
    is_nonWGS = F["short_frag"]
    normal_rescued_MQ = np.minimum(
        np.maximum(readlenMQcap - 60, 0),
        np.where(is_nonWGS, cfg.lib_nonwgs_normal_max_rescued_MQ,
                 cfg.lib_wgs_normal_max_rescued_MQ))
    sysMQVQ1 = np.minimum(np.maximum(sysMQ, cfg.syserr_MQ_min) + sysMQadd,
                          readlenMQcap)
    sysBQVQ = np.where(is_subst, F["aBQQ"], 200)

    a_pcr = F["APDP"][:, 5][:, None]
    a_dp0 = F["APDP"][:, 0][:, None]
    is_strong_amp = a_pcr * 100 > a_dp0 * 50
    is_weak_amp = a_pcr * 100 > a_dp0 * 30
    is_tmore_amp = is_weak_amp if is_tumor_only else is_strong_amp
    apxm1pos = F["APXM"][:, 1][:, None]
    adhoc = (is_tmore_amp & is_indel & (sysMQVQ1 > 70)
             & (apxm1pos // np.maximum(a_dp0, 1) > 20))
    sysMQVQ1 = np.where(adhoc, 70 + (sysMQVQ1 - 70) * 5
                        // np.maximum(apxm1pos // np.maximum(a_dp0, 1) - 15, 1),
                        sysMQVQ1)
    ipb_add = np.zeros((P, NS), dtype=_itype())
    if is_tumor_only:
        delAPDP = np.maximum(F["APDP"][:, 2], F["APDP"][:, 4])[:, None]
        snv_dp = F["APDP"][:, 6][:, None]
        c1 = ((a_dp0 < 3 * delAPDP) & (a_dp0 < 3 * snv_dp)
              & (aDP * 3 < delAPDP) & (aDP * 3 < snv_dp) & is_subst
              & ((F["rtr2_tracklen_3"] >= 8 * F["rtr2_unitlen_3"])[:, None]))
        ipb_add = np.where(c1, cfg.microadjust_germline_mix_with_del_snv_penalty, 0)
        c2 = is_tmore_amp & is_del
        ipb_add = np.where(c2 & (aDP * 4 < F["APDP"][:, 2][:, None]),
                           np.maximum(ipb_add, 5), ipb_add)
        ipb_add = np.where(c2 & ~(aDP * 4 < F["APDP"][:, 2][:, None])
                           & (F["cDP0a"] * 3 < 2 * del_cd),
                           np.maximum(ipb_add, 2), ipb_add)
    sysMQVQ = np.maximum(0, sysMQVQ1)
    ipb2 = indel_penal_base + ipb_add

    fADPfx = F["ADPff"] + F["ADPfr"]
    fADPrx = F["ADPrf"] + F["ADPrr"]
    fADPxf = F["ADPff"] + F["ADPrf"]
    fADPxr = F["ADPfr"] + F["ADPrr"]
    fold = cfg.microadjust_strand_orientation_absence_DP_fold
    frx_imba = np.maximum(fADPfx, fADPrx) > fold * (np.minimum(fADPfx, fADPrx) + 1)
    xfr_imba = np.maximum(fADPxf, fADPxr) > fold * (np.minimum(fADPxf, fADPxr) + 1)
    dedup_v_minus = np.where(
        is_subst,
        np.where(frx_imba, cfg.microadjust_orientation_absence_snv_penalty, 0)
        + np.where(xfr_imba, cfg.microadjust_strand_absence_snv_penalty, 0),
        np.where(is_tmore_amp, cfg.microadjust_dedup_absence_indel_penalty, 0))

    tn_syserr_q = sysMQVQ + cfg.tn_q_inc_max + normal_rescued_MQ

    F["bMQQ"] = sysMQVQ
    F["bIAQ"] = duped_frag_binom_qual - ipb2
    F["cIAQ"] = sscs_binom_qual - indel_penal_base
    F["cPCQ1"] = np.minimum(dedup_w - ipb2, tn_syserr_q)
    F["cPLQ1"] = dedup_v - ipb2 - dedup_v_minus
    F["cPCQ2"] = np.minimum(sscs_w - indel_penal_base, tn_syserr_q)
    F["cPLQ2"] = sscs_v - indel_penal_base
    F["bTINQ"] = contam_frag_q + contam_bypassed
    F["cTINQ"] = contam_sscs_q + contam_bypassed

    aDPpc = (sym == refsym_eff).astype(_itype())
    penal4BQerr = np.where(
        is_subst, 5 + cfg.penal4lowdep // np.square(np.maximum(1, aDP + aDPpc)), 0)
    indel_q_inc = np.where(
        is_indel & is_tumor_only,
        _indel_len_rusize_phred_j(np.maximum(F["gapLen"], 1),
                                  np.maximum(repeatnum, 1)), 0)
    indel_q_inc = np.where(F["gapLen"] > 0, indel_q_inc, 0)
    F["gVQ1"] = np.maximum(
        0, indel_q_inc + _minr([
            np.minimum(sysBQVQ, np.maximum(sysMQVQ - sysMQminus, 0)),
            F["bIAQ"] - penal4BQerr,
            F["cPLQ1"]])
        - 2 * _maxr([
            np.zeros((P, NS), dtype=_itype()),
            indel_penal4multi - int(cfg.indel_multiallele_soma_penal_thres),
            indel_penal4multi_g]))
    sys_soma_minus = (0 if is_rescued
                      else 15 - np.minimum(np.minimum(ADP * 15 // 100, aDP), 15))
    sys_soma = np.maximum(
        np.minimum(sysBQVQ, sysMQVQ + sysMQadd_soma) - sys_soma_minus, 0)
    bcVQ1 = _minr([
        sys_soma,
        F["bIAQ"] - (0 if is_rescued else penal4BQerr),
        F["cPLQ1"]]) - indel_penal4multi_soma
    F["cVQ1"] = np.maximum(0, np.minimum(bcVQ1, F["bTINQ"]) - indel_UMI_penal)

    mincVQ2 = np.zeros((P, NS), dtype=_itype())
    floor_v = np.minimum(
        cfg.germ_phred_homalt_indel + numstates2phred(umi_cFA),
        F["cDP2v"] * 3 / 100).astype(_itype()) \
        + (np.where(is_ins, INS_N_ANCHOR_BASES, 0) - INS_N_ANCHOR_BASES) * 3
    mincVQ2 = np.where(is_indel, np.maximum(mincVQ2, floor_v), mincVQ2)
    dVQinc = np.minimum(np.minimum(dFA_vq_binom, dFA_vq_powlaw)
                        - np.maximum(0, np.minimum(F["cIAQ"], F["cPLQ2"])),
                        cfg.fam_phred_dscs_inc_max)
    F["dVQinc"] = dVQinc
    cVQ2 = _minr([
        sys_soma, F["cIAQ"] + np.maximum(0, dVQinc),
        F["cPLQ2"] + np.maximum(0, dVQinc)]) - indel_penal4multi
    F["cVQ2"] = np.maximum(mincVQ2, np.minimum(cVQ2, F["cTINQ"]))

    cDP1y = F["cDP1x"] if is_rescued else F["cDP1v"]
    CDP1y = F["CDP1x"] if is_rescued else F["CDP1v"]
    binom_contam = binom_lr(contamfrac, cDP1y, CDP1y)
    DBL_EPSILON = 2.220446049250313e-16
    # logit2(a, b) = logit((a+eps)/(a+b+2eps)) = log((a+eps)/(b+eps))
    # (main_conversion.hpp:216-219)
    p1 = (cDP1y + 1) / (CDP1y.astype(_ftype()) + 1.0)
    power_contam = np.round(INV_LOG10 * cfg.powlaw_exponent * np.maximum(
        np.log((p1 + DBL_EPSILON) / (contamfrac + DBL_EPSILON)), 0.0))
    F["CONTQ"] = np.minimum(binom_contam, power_contam).astype(_itype())
    return F
