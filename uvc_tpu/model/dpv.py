"""Bias-reduced effective depths: vectorized BcfFormat_symbol_calc_DPv
(main.hpp:4253-4906).

Computes ~20 candidate bias-corrected allele fractions per (pos, symbol)
via the dp4_to_pcFA Bayes-factor machinery and MIN-combines them into the
six effective depths cDP1v/w/x (fragment tier) and cDP2v/w/x (SSCS tier),
each x100 fixed-point, plus the bNMQ mismatch-region penalty and the FTS
bias filter codes.

Dense tumor-only path (tpfa = -1 for all alleles); the rescued (normal)
path reuses the same kernels with per-allele tpfa overrides.
"""

import functools
import math

import jax.numpy as jnp
import numpy as onp

from ..constants import Symbol, NUM_SYMBOLS, SequencingPlatform

# The whole DPv battery is pure [P,14] elementwise tensor math, so it is
# written in jax.numpy and traced into ONE jitted program together with
# calc_qual (see calling.model_stage): float64 on CPU (x64 enabled -> bit
# comparable with the reference math), float32/int32 on GPU where the same
# program is the production model stage.
np = jnp  # module-wide alias: every op below traces

NS = NUM_SYMBOLS
INV_LOG10 = 10.0 / math.log(10.0)
DBL_EPSILON = 2.220446049250313e-16
DBLFLT_EPS = 1.1920928955078125e-07


def _minr(arrs):
    return functools.reduce(jnp.minimum, arrs)


def _maxr(arrs):
    return functools.reduce(jnp.maximum, arrs)


def _ftype():
    return jnp.result_type(float)


def _itype():
    return jnp.result_type(int)


def tdiv(a, b):
    """C-style integer division truncating toward zero (traceable)."""
    a = jnp.asarray(a, dtype=_itype())
    b = jnp.asarray(b, dtype=_itype())
    q = jnp.abs(a) // jnp.abs(b)
    return jnp.where((a < 0) != (b < 0), -q, q)


def _dp4(osf, adp, adf, dpp, dpf, pl_exp, n_nats, ad_avg=None, dp_avg=None,
         priorAD=0.5, priorDP=1.0, bidirectional=False, osf_disabled=False):
    """dp4_to_pcFA (main_conversion.hpp:798-849), traceable."""
    adp = np.asarray(adp, _ftype())
    adf = np.asarray(adf, _ftype())
    dpp = np.asarray(dpp, _ftype())
    dpf = np.asarray(dpf, _ftype())
    if not osf_disabled:
        dpf = dpf * osf
        dpp = dpp * osf
        adf = adf * osf
        adp = adp * osf
    dpf = dpf + priorDP
    dpp = dpp + priorDP
    adf = adf + priorAD
    adp = adp + priorAD
    nobias = (adf + adp) / (dpf + dpp)
    pass_ge = (adp / dpp) >= (adf / dpf)
    if bidirectional:
        dpp2 = np.where(pass_ge, dpf, dpp)
        dpf2 = np.where(pass_ge, dpp, dpf)
        adp2 = np.where(pass_ge, adf, adp)
        adf2 = np.where(pass_ge, adp, adf)
        dpp, dpf, adp, adf = dpp2, dpf2, adp2, adf2
    bdf = dpf * 2 - adf
    bdp = dpp * 2 - adp
    apf = adp / (adp + adf)
    bpf = bdp / (bdp + bdf)
    if not bidirectional and ad_avg is not None:
        use = (np.asarray(ad_avg) >= 0) & (np.asarray(dp_avg) >= 0)
        interp = ad_avg / (ad_avg + dp_avg * 0.9)
        apf = np.where(use, interp, apf)
        bpf = np.where(use, 1.0 - apf, bpf)
    ig = adf * np.log((1.0 - apf) / (1.0 - bpf))
    if bidirectional:
        ig = ig + adp * np.log(apf / bpf)
    fail_fa = adf / dpf
    pass_fa = adp / dpp
    shrunk = np.maximum(pass_fa, fail_fa * np.exp((n_nats - ig) / pl_exp))
    pc = np.where(ig <= n_nats, fail_fa, shrunk)
    if not bidirectional:
        pc = np.where(pass_ge, pass_fa, pc)
    return pc, nobias


def phred2nat(x):
    return np.asarray(x, _ftype()) * (math.log(10.0) / 10.0)


def numstates2phred(x):
    return INV_LOG10 * np.log(x)


IS_SUBST = onp.zeros(NS, dtype=bool)
IS_SUBST[:6] = True
IS_INS = onp.zeros(NS, dtype=bool)
IS_INS[[10, 11, 12]] = True
IS_DEL = onp.zeros(NS, dtype=bool)
IS_DEL[[7, 8, 9]] = True
IS_INDEL = IS_INS | IS_DEL

# FTS bias filter ids in push order (bcf_formats_generator1 FILTER ids)
FTS_NAMES = ("aStrand", "aBQXM", "aInsertSize", "aAlignL", "aAlignR",
             "aPositionL", "aPositionR", "abPositionL", "abPositionR",
             "bcDup", "cbDup", "c0Orientation", "c2Orientation",
             "c2PositionL", "c2PositionR", "c2AlignL", "c2AlignR",
             "c2StrictPosL", "c2StrictPosR")


def calc_dpv(F, cfg, is_tumor_only=True, tpfa=None):
    """Adds cDP1v/w/x, cDP2v/w/x, bNM*, FTS flags to F (all [P,14])."""
    P = F["P"]
    sym = np.broadcast_to(np.arange(NS)[None, :], (P, NS))
    is_subst = np.broadcast_to(IS_SUBST[None, :], (P, NS))
    is_ins = np.broadcast_to(IS_INS[None, :], (P, NS))
    is_del = np.broadcast_to(IS_DEL[None, :], (P, NS))
    is_indel = is_ins | is_del
    refsym = F["ref_syms"][:, None]
    is_refsym = (sym == refsym) & is_subst | (sym == int(Symbol.LINK_M))

    unbias_ratio = 1.0 if is_tumor_only else math.sqrt(2.0)
    unbias_qualadd = 0 if is_tumor_only else 3
    allbias_allprior = 0 if is_tumor_only else 31

    prepdp = F["APDP"]
    a_dp_pos = prepdp[:, 0][:, None]
    a_pcr_pos = prepdp[:, 5][:, None]
    is_strong_amp = a_pcr_pos * 100 > a_dp_pos * 50
    is_weak_amp = a_pcr_pos * 100 > a_dp_pos * 30

    is_rescued = (tpfa is not None)
    if is_rescued:
        pfa = np.where(np.asarray(tpfa) >= 0, tpfa, 0.5)
        rescued_allele = np.asarray(tpfa) >= 0
    else:
        pfa = 0.5
        rescued_allele = np.zeros((P, NS), dtype=bool)
    c2altpc = 0.025

    ADP1 = F["ADPff"] + F["ADPfr"] + F["ADPrf"] + F["ADPrr"]
    aDP1 = F["aDPff"] + F["aDPfr"] + F["aDPrf"] + F["aDPrr"]
    aDP = aDP1
    ADP = np.maximum(ADP1, prepdp[:, 9][:, None])
    cDP1 = F["cDP1f"] + F["cDP1r"]
    CDP1 = F["CDP1"]

    cFA2 = (F["cDP2f"] + F["cDP2r"] + c2altpc) / (F["CDP2"] + 1.0)
    cFA3 = (F["cDP3f"] + F["cDP3r"] + c2altpc) / (F["CDP3"] + 1.0)

    # ---- counter-bias (nobias_flag gate; default 0x2 with non-amplicon ->
    # gate passes only when is_nmore_amplicon)
    counterbias_P_FA = np.full((P, NS), 1e-9)
    counterbias_BQ_FA = np.full((P, NS), 1e-9)
    dir_bias_div = np.ones((P, NS))
    is_nmore_amp = is_strong_amp if is_tumor_only else is_weak_amp
    gate_cb = ((is_nmore_amp & (0x2 == (0x2 & cfg.nobias_flag)))
               | ((~is_nmore_amp) & (0x1 == (0x1 & cfg.nobias_flag))))
    if True:  # traced: np.where gates replace the host-side .any() skip
        using_bias_oddsA = ((aDP - F["aP1"] + 0.5) / (ADP - F["AP1"] + 1.0))
        using_bias_oddsA = using_bias_oddsA / (1.0 - np.minimum(using_bias_oddsA, 1 - 1e-12))
        using_nobias_oddsA = ((F["aP1"] + 0.5) / (F["AP1"] + 1.0))
        using_nobias_oddsA = using_nobias_oddsA / (1.0 - np.minimum(using_nobias_oddsA, 1 - 1e-12))
        is_pos_cb = (gate_cb
                     & (using_bias_oddsA * cfg.microadjust_counterbias_pos_odds_ratio
                        < using_nobias_oddsA * (unbias_ratio - DBL_EPSILON))
                     & (F["aP1"] * (unbias_ratio - DBL_EPSILON) > aDP - F["aP1"])
                     & ((ADP - F["AP1"]) * cfg.microadjust_counterbias_pos_fold_ratio
                        * (unbias_ratio - DBL_EPSILON) > F["AP1"])
                     & (((cfg.primerlen == 0) and (cfg.primerlen2 != 0)) | ~is_subst))
        cb_val = (F["aP1"] + 0.5) / (np.maximum(F["AP1"], prepdp[:, 9][:, None]) + 1.0)
        counterbias_P_FA = np.where(is_pos_cb, np.maximum(1e-9, cb_val),
                                    np.where(gate_cb, 2e-9, 1e-9))
        # BQ counterbias (substitutions)
        ADPxf = F["ADPff"] + F["ADPrf"]
        ADPxr = F["ADPfr"] + F["ADPrr"]
        is_f_good = (ADPxr + 150 <= ADPxf * 5 * unbias_ratio)
        is_r_good = (ADPxf + 150 <= ADPxr * 5 * unbias_ratio)
        avg_f_a = F["a1BQf"] // np.maximum(1, F["aDPff"] + F["aDPrf"])
        avg_r_a = F["a1BQr"] // np.maximum(1, F["aDPfr"] + F["aDPrr"])
        avg_f_A = F["A1BQf"] // np.maximum(1, ADPxf)
        avg_r_A = F["A1BQr"] // np.maximum(1, ADPxr)
        f_cb = (gate_cb & is_subst & (F["a1BQf"] >= F["a1BQr"])
                & is_f_good & is_r_good
                & (avg_f_a + unbias_qualadd >= avg_r_A + 14)
                & (avg_r_A <= 14 + unbias_qualadd))
        r_cb = (gate_cb & is_subst & (F["a1BQr"] >= F["a1BQf"])
                & is_f_good & is_r_good
                & (avg_r_a + unbias_qualadd >= avg_f_A + 14)
                & (avg_f_A <= 14 + unbias_qualadd))
        counterbias_BQ_FA = np.where(
            f_cb, np.maximum(counterbias_BQ_FA,
                             (F["aDPff"] + F["aDPrf"] + 0.5) / (ADPxf + 1.0)),
            counterbias_BQ_FA)
        counterbias_BQ_FA = np.where(
            r_cb, np.maximum(counterbias_BQ_FA,
                             (F["aDPfr"] + F["aDPrr"] + 0.5) / (ADPxr + 1.0)),
            counterbias_BQ_FA)
        dir_bias_div = np.where(
            gate_cb & ~is_subst,
            1.0 + F["gapLen"] // cfg.indel_str_repeatsize_max, 1.0)

    rtr1_tl = F["rtr1_tracklen_3"][:, None]
    rtr2_tl = F["rtr2_tracklen_3"][:, None]
    aDPgap = np.maximum(
        np.maximum(F["APDP"][:, 1], F["APDP"][:, 2])[:, None] - F["aP3"], 0)
    aDPFAgap = np.where(rtr1_tl + rtr2_tl < cfg.indel_str_repeatsize_max, 1.0,
                        (F["aP3"] + pfa) / (aDPgap + 1.0))
    aDPFA1 = (aDP + pfa) / (ADP + 1.0)
    labelFA = (F["aP2"] + 1.5 + F["aP2"]) / (F["AP2"] + 2.0 + F["aP2"])
    aDPFA = np.minimum(
        np.where(is_subst,
                 np.minimum(aDPFA1, np.maximum(aDPFA1 / 3, aDPFAgap)),
                 aDPFA1),
        labelFA * (ADP + 1.0) / (F["AP2"] + 0.5) * unbias_ratio)
    aDPplus = np.where(is_subst, 0,
                       (aDP + 1) * cfg.bias_prior_DPadd_perc // 100)
    dp_coef = np.where(
        sym == int(Symbol.LINK_M),
        np.maximum(cfg.contam_any_mul_frac,
                   1.0 - np.maximum(rtr1_tl, rtr2_tl)
                   / (np.maximum(np.maximum(1, F["ALPL"]), F["ARPL"])
                      / np.maximum(1.0 / 150.0, F["ABQ2"]))), 1.0)
    aPprior = np.full((P, NS), cfg.bias_priorfreq_pos)
    aBprior = aPprior.copy()
    apxm1 = F["APXM"][:, 1][:, None]
    apxm0 = F["APXM"][:, 0][:, None]
    is_in_indel_read = (apxm1 / 15.0 * cfg.microadjust_bias_pos_indel_fold
                        * cfg.bias_prior_var_DP_mul
                        > (aDP + aDPplus) * dp_coef)
    apdp12max = np.maximum(F["APDP"][:, 1], F["APDP"][:, 2])[:, None]
    apdp34max = np.maximum(F["APDP"][:, 3], F["APDP"][:, 4])[:, None]
    is_in_indel_len = (apdp12max * cfg.bias_prior_var_DP_mul
                       > (aDP + aDPplus) * dp_coef)
    is_in_indel_rtr = (apdp34max * cfg.bias_prior_var_DP_mul
                       > (aDP + aDPplus) * dp_coef)
    is_in_rtr = np.maximum(rtr1_tl, rtr2_tl) > round(cfg.indel_polymerase_size)

    # IonTorrent: DNV-dominated reads also lower the position-bias prior
    # (is_in_dnv_read, main.hpp:4429-4431); APDP carries snv_dp at [6] and
    # dnv_dp at [7]
    is_in_dnv_read = ((cfg.inferred_sequencing_platform
                       == SequencingPlatform.IONTORRENT)
                      & (prepdp[:, 7][:, None] * 2 > prepdp[:, 6][:, None]))
    m_read = (is_in_indel_read | is_in_dnv_read
              | (is_indel & (apxm0 > apxm1
                             * cfg.microadjust_bias_pos_indel_misma_to_indel_ratio)))
    aPprior -= np.where(m_read, cfg.bias_priorfreq_indel_in_read_div, 0)
    aBprior -= np.where(m_read, cfg.bias_priorfreq_indel_in_read_div, 0)
    not_linkm_nn = (sym != int(Symbol.LINK_M)) & (sym != int(Symbol.LINK_NN))
    maxpf = np.zeros((P, NS))
    maxpf = np.where(is_in_indel_len & not_linkm_nn,
                     np.maximum(maxpf, cfg.bias_priorfreq_indel_in_var_div2), maxpf)
    maxpf = np.where(is_in_indel_rtr & not_linkm_nn,
                     np.maximum(maxpf, cfg.bias_priorfreq_indel_in_str_div2), maxpf)
    maxpf = np.where(is_in_rtr & not_linkm_nn,
                     np.maximum(maxpf, cfg.bias_priorfreq_var_in_str_div2), maxpf)
    aPprior -= maxpf
    aBprior -= maxpf
    aPprior += allbias_allprior
    aBprior += allbias_allprior
    F["nPF_P"] = np.round(aPprior).astype(_itype())
    F["nPF_B"] = np.round(aBprior).astype(_itype())

    aIprior = np.where(is_subst, cfg.bias_priorfreq_ipos_snv,
                       cfg.bias_priorfreq_ipos_indel) + allbias_allprior
    homopol_len = (np.where(F["rtr1_unitlen_3"] == 1, F["rtr1_tracklen_3"], 0)
                   + np.where(F["rtr2_unitlen_3"] == 1, F["rtr2_tracklen_3"], 0))[:, None]
    # IonTorrent homopolymer reduction omitted on the Illumina path
    aSBprior = np.where(
        is_subst,
        np.minimum(F["aBQ"], F["bMQ"]) + cfg.bias_priorfreq_strand_snv_base,
        cfg.bias_priorfreq_strand_indel) + allbias_allprior

    dedup_A2C1 = np.minimum(
        1.0, np.maximum(CDP1, cfg.bias_reduction_by_high_sequencingDP_min_n_totDepth)
        / np.maximum(ADP1, 1))
    dedup_a2c1 = np.minimum(
        1.0, np.maximum(cDP1, cfg.bias_reduction_by_high_sequencingDP_min_n_altDepth)
        / np.maximum(aDP1, 1))
    dedup_frac = np.maximum(dedup_A2C1, dedup_a2c1)

    pl = cfg.powlaw_exponent
    prior_pc = np.where(is_in_indel_read, cfg.bias_FA_pseudocount_indel_in_read, 0.5)

    def pcfa_dir(a1, aD, A2, AD2, prior_nats, aL, aB, AL, AB):
        return _dp4(dedup_frac, a1, aD, A2, AD2, pl, phred2nat(prior_nats),
                    np.maximum(1, aL) / np.maximum(1, aB),
                    np.maximum(1, AL) / np.maximum(1, AB),
                    prior_pc, 1.0, bidirectional=False)[0]

    aLPFA = pcfa_dir(F["aLP1"], aDP, F["ALP2"] + F["aLP1"] - F["aLP2"], ADP,
                     aPprior, F["aLPL"], F["aBQ2"], F["ALPL"], F["ABQ2"])
    aRPFA = pcfa_dir(F["aRP1"], aDP, F["ARP2"] + F["aRP1"] - F["aRP2"], ADP,
                     aPprior, F["aRPL"], F["aBQ2"], F["ARPL"], F["ABQ2"])
    aLBFA = pcfa_dir(F["aLB1"], aDP, F["ALB2"] + F["aLB1"] - F["aLB2"], ADP,
                     aBprior, F["aLBL"], F["aBQ2"], F["ALBL"], F["ABQ2"])
    aRBFA = pcfa_dir(F["aRB1"], aDP, F["ARB2"] + F["aRB1"] - F["aRB2"], ADP,
                     aBprior, F["aRBL"], F["aBQ2"], F["ARBL"], F["ABQ2"])
    is_tmore_amp = is_weak_amp if is_tumor_only else is_strong_amp

    normCDP1 = F["CDP12"] + 1
    normBDP = F["BDP"] + 1
    c2DP = F["cDP2f"] + F["cDP2r"]

    try_t2 = ((c2DP >= 2)
              & (normBDP * cfg.fam_bias_overseq_perc >= normCDP1 * 100)
              & ((prepdp[:, 11] * 100 > prepdp[:, 0] * 50)[:, None]))
    if tpfa is not None:
        # rescued fmts take the TUMOR record's tier-2 flag (is_rescued ?
        # tki.enable_tier2_consensus_format_tags : try_..., main.hpp:4475)
        try_t2 = np.where(np.asarray(tpfa) >= 0,
                          F["tki_et2"].astype(bool), try_t2)
    F["enable_tier2"] = try_t2

    cFA2L = np.where(try_t2,
                     (np.square(F["c2LP0"].astype(_ftype())) * 2
                      / np.maximum(1, np.minimum(c2DP, F["c2LP0"] * 4)) + c2altpc)
                     / (F["C2LP0"] + 1.0), 1.0)
    cFA2R = np.where(try_t2,
                     (np.square(F["c2RP0"].astype(_ftype())) * 2
                      / np.maximum(1, np.minimum(c2DP, F["c2RP0"] * 4)) + c2altpc)
                     / (F["C2RP0"] + 1.0), 1.0)

    if True:  # traced: the np.where(try_t2, ...) gates do the masking
        C2DP = F["CDP2"]

        def pcfa_c2(a1, A2, a2, AL, AB, aL, aB, prior):
            return _dp4(-1.0, a1, c2DP, A2 + a1 - a2, C2DP, pl,
                        phred2nat(prior),
                        np.maximum(1, aL) / np.maximum(1, aB),
                        np.maximum(1, AL) / np.maximum(1, AB),
                        c2altpc, 1.0, bidirectional=False, osf_disabled=True)[0]

        c2Pp = np.maximum(0, aPprior)
        c2Bp = np.maximum(0, aBprior)
        c2LPFA = np.where(try_t2, pcfa_c2(F["c2LP1"], F["C2LP2"], F["c2LP2"],
                                          F["C2LPL"], F["C2BQ2"], F["c2LPL"],
                                          F["c2BQ2"], c2Pp), 1.0)
        c2RPFA = np.where(try_t2, pcfa_c2(F["c2RP1"], F["C2RP2"], F["c2RP2"],
                                          F["C2RPL"], F["C2BQ2"], F["c2RPL"],
                                          F["c2BQ2"], c2Pp), 1.0)
        c2LBFA = np.where(try_t2, pcfa_c2(F["c2LB1"], F["C2LB2"], F["c2LB2"],
                                          F["C2LBL"], F["C2BQ2"], F["c2LBL"],
                                          F["c2BQ2"], c2Bp), 1.0)
        c2RBFA = np.where(try_t2, pcfa_c2(F["c2RB1"], F["C2RB2"], F["c2RB2"],
                                          F["C2RBL"], F["C2BQ2"], F["c2RBL"],
                                          F["c2BQ2"], c2Bp), 1.0)

    # insert-end bias
    ADPxr2 = F["ADPfr"] + F["ADPrr"]
    ALpd = (F["ALI2"] + 0.5) / (ADPxr2 - F["ALI2"] + 0.5)
    aLpd = (F["aLI1"] + ALpd / (1.0 + ALpd)) / (
        F["aDPfr"] + F["aDPrr"] - F["aLI1"] + 1.0 / (1.0 + ALpd))
    aLIFAx = _dp4(dedup_frac, F["aLI1"], F["aDPfr"] + F["aDPrr"],
                  F["ALI2"] + F["aLI1"] - F["aLI2"], ADPxr2, pl,
                  phred2nat(aIprior), aLpd, ALpd, 0.25, 0.5,
                  bidirectional=False)
    aLIFA = aLIFAx[0] * np.where(is_tmore_amp, dir_bias_div,
                                 np.maximum(dir_bias_div, aDPFA / aLIFAx[1]))
    ADPxf2 = F["ADPff"] + F["ADPrf"]
    ARpd = (F["ARI2"] + 0.5) / (ADPxf2 - F["ARI2"] + 0.5)
    aRpd = (F["aRI1"] + ARpd / (1.0 + ARpd)) / (
        F["aDPff"] + F["aDPrf"] - F["aRI1"] + 1.0 / (1.0 + ARpd))
    aRIFAx = _dp4(dedup_frac, F["aRI1"], F["aDPff"] + F["aDPrf"],
                  F["ARI2"] + F["aRI1"] - F["aRI2"], ADPxf2, pl,
                  phred2nat(aIprior), aRpd, ARpd, 0.25, 0.5,
                  bidirectional=False)
    aRIFA = aRIFAx[0] * np.where(is_tmore_amp, dir_bias_div,
                                 np.maximum(dir_bias_div, aDPFA / aRIFAx[1]))
    aSIFA = np.maximum(
        (F["aLI1"] + 0.5) / (F["ALI2"] + F["aLI1"] - F["aLI2"] + 1.0),
        (F["aRI1"] + 0.5) / (F["ARI2"] + F["aRI1"] - F["aRI2"] + 1.0))

    # indel nobias rescue (main.hpp:4537-4568)
    indel_mac = np.maximum(1, F["bDPa"]) / np.maximum(1, F["bDPf"] + F["bDPr"]).astype(_ftype())
    apdp13max = np.maximum(F["APDP"][:, 1], F["APDP"][:, 3])[:, None]
    apdp24max = np.maximum(F["APDP"][:, 2], F["APDP"][:, 4])[:, None]
    is_major_reg = ((apdp13max + apdp24max) * 0.5 * (1.0 + DBLFLT_EPS)
                    < aDP * indel_mac)
    rescue1 = (np.minimum(F["gapLen"], cfg.microadjust_nobias_pos_indel_maxlen)
               * aDPFA * indel_mac >= cfg.nobias_pos_indel_lenfrac_thres)
    rescue2 = ((np.maximum(rtr1_tl, rtr2_tl) >= cfg.nobias_pos_indel_str_track_len)
               & is_major_reg
               & ~(apxm0 > apxm1 * cfg.microadjust_nobias_pos_indel_misma_to_indel_ratio))
    resc = is_indel & (rescue1 | rescue2)
    aLPFA = aLPFA + np.where(resc, 2.0, 0.0)
    aRPFA = aRPFA + np.where(resc, 2.0, 0.0)
    aLBFA = aLBFA + np.where(resc, 2.0, 0.0)
    aRBFA = aRBFA + np.where(resc, 2.0, 0.0)
    c2LPFA = c2LPFA + np.where(resc & try_t2, 2.0, 0.0)
    c2RPFA = c2RPFA + np.where(resc & try_t2, 2.0, 0.0)
    c2LBFA = c2LBFA + np.where(resc & try_t2, 2.0, 0.0)
    c2RBFA = c2RBFA + np.where(resc & try_t2, 2.0, 0.0)
    resc_i = is_indel & ((F["bMQ"] >= cfg.microadjust_nobias_pos_indel_bMQ)
                         & (F["a2XM2"] * 100 >= aDP * 100 * cfg.microadjust_nobias_pos_indel_perc))
    aLIFA = aLIFA + np.where(resc_i, 2.0, 0.0)
    aRIFA = aRIFA + np.where(resc_i, 2.0, 0.0)

    # LINK_M / LINK_NN shrink (main.hpp:4562-4565)
    is_linkm_nn = (sym == int(Symbol.LINK_M)) | (sym == int(Symbol.LINK_NN))
    pc = cfg.bias_FA_pseudocount_indel_in_read
    aLBFA = np.where(is_linkm_nn,
                     np.minimum(aLBFA, (pc + F["aLB1"]) / (pc * 2 + ADP)), aLBFA)
    aRBFA = np.where(is_linkm_nn,
                     np.minimum(aRBFA, (pc + F["aRB1"]) / (pc * 2 + ADP)), aRBFA)
    # ref SNP allele: insert-end bias does not apply (main.hpp:4566-4568)
    ref_snp = (sym == refsym) & is_subst
    airmax = np.maximum(aLIFA, aRIFA)
    aLIFA = np.where(ref_snp, airmax, aLIFA)
    aRIFA = np.where(ref_snp, airmax, aRIFA)

    # large-indel-region position-bias floor (main.hpp:4570-4585)
    avg_sqr_ilen = np.maximum(
        F["APXM"][:, 4] // np.maximum(1, F["APDP"][:, 1]),
        F["APXM"][:, 5] // np.maximum(1, F["APDP"][:, 2]))[:, None]
    big_reg = ((~is_subst)
               & (cfg.microadjust_nobias_pos_indel_maxlen ** 2 < avg_sqr_ilen)
               & (is_linkm_nn | (np.square(F["gapLen"] * 2) < avg_sqr_ilen)))
    aLP_minA = (pc + F["aLP1"]) / (pc * 2 + F["ALP1"])
    aRP_minA = (pc + F["aRP1"]) / (pc * 2 + F["ALP1"])  # ALP1 twice: quirk
    aLPFA = np.where(big_reg, np.minimum(aLPFA, aLP_minA), aLPFA)
    aRPFA = np.where(big_reg, np.minimum(aRPFA, aRP_minA), aRPFA)
    c2LPFA = np.where(big_reg & try_t2, np.minimum(c2LPFA, aLP_minA), c2LPFA)
    c2RPFA = np.where(big_reg & try_t2, np.minimum(c2RPFA, aRP_minA), c2RPFA)

    # rescued runs AND IonTorrent take the max of the two insert-end FAs
    # (main.hpp:4653-4655)
    if (not is_tumor_only) or (cfg.inferred_sequencing_platform
                               == SequencingPlatform.IONTORRENT):
        airmax = np.maximum(aLIFA, aRIFA)
        aLIFA = airmax
        aRIFA = airmax.copy()

    aPFFA = (F["aPF1"] + pfa * 100.0) / (F["APF2"] + (F["aPF1"] - F["aPF2"]) + 100.0)

    aSSFAx = _dp4(dedup_frac, F["aRIf"], F["aLIr"], F["ARIf"], F["ALIr"], pl,
                  phred2nat(aSBprior), bidirectional=True)
    ori_base = np.where(is_subst, cfg.bias_priorfreq_orientation_snv_base,
                        cfg.bias_priorfreq_orientation_indel_base) + allbias_allprior
    ori_all = (np.log(np.square(np.maximum(
        aDPFA, cfg.bias_orientation_min_effective_allelefrac)))
        + phred2nat(ori_base))
    cROFA1x = _dp4(dedup_frac, F["cDP1f"], F["cDP1r"], F["CDP1b_l"],
                   F["CDP1b_r"], pl, ori_all, bidirectional=True)
    cROFA2x = _dp4(-1.0, F["cDP2f"], F["cDP2r"], F["CDP2b_l"], F["CDP2b_r"],
                   pl, ori_all, priorAD=c2altpc, priorDP=1.0,
                   bidirectional=True, osf_disabled=True)

    aSSFA = aSSFAx[0] * dir_bias_div
    cROFA1 = cROFA1x[0] * dir_bias_div
    cROFA2 = cROFA2x[0] * dir_bias_div

    bAD = F["bDPf"] + F["bDPr"]
    AD = F["cDP1f"] + F["cDP1r"]
    F["bAD"] = np.where(is_indel, np.minimum(bAD, F["bDPa"]), bAD)
    F["AD"] = np.where(is_indel, np.minimum(AD, F["cDP0a"]), AD)

    short_frag = ((F["APLRI"][:, 0] + F["APLRI"][:, 2])
                  < (F["APLRI"][:, 1] + F["APLRI"][:, 3]) * cfg.lib_wgs_min_avg_fraglen)[:, None]
    F["short_frag"] = short_frag
    bFA = (F["bDPa"] + pfa) / (F["BDP"] + 1.0)
    cFA0 = (F["cDP0a"] + pfa * np.where(short_frag, cfg.lib_nonwgs_ad_pseudocount, 1.0)) \
        / (F["CDP1"] + 1.0)

    is_r_weak = (ADPxr2 * cfg.microadjust_nobias_strand_all_fold < ADPxf2 * unbias_ratio)
    is_f_weak = (ADPxf2 * cfg.microadjust_nobias_strand_all_fold < ADPxr2 * unbias_ratio)
    aLIFA = aLIFA + np.where(is_r_weak, 4.0, 0.0)
    aRIFA = aRIFA + np.where(is_f_weak, 4.0, 0.0)
    aSSFA = aSSFA + np.where(is_r_weak, 4.0, 0.0) + np.where(is_f_weak, 4.0, 0.0)

    aLPFA2 = np.maximum(aDPFA * 0.01, aLPFA)
    aRPFA2 = np.maximum(aDPFA * 0.01, aRPFA)
    aLBFA2 = np.maximum(aDPFA * 0.01, aLBFA)
    aRBFA2 = np.maximum(aDPFA * 0.01, aRBFA)
    c2LPFA2 = np.maximum(cFA2 * 0.01, c2LPFA)
    c2RPFA2 = np.maximum(cFA2 * 0.01, c2RPFA)
    c2LBFA2 = np.maximum(cFA2 * 0.01, c2LBFA)
    c2RBFA2 = np.maximum(cFA2 * 0.01, c2RBFA)
    aLIFA2 = np.maximum(aDPFA * 0.01, aLIFA)
    aRIFA2 = np.maximum(aDPFA * 0.01, aRIFA)
    aSSFA2 = np.maximum(aDPFA * 0.05, aSSFA)
    cROFA1 = np.maximum(aDPFA * 1e-4, cROFA1)
    cROFA2 = np.maximum(aDPFA * 1e-4, cROFA2)

    # systematic mismatch-region MQ penalty (bNMQ)
    fBTA = F["BTA"] + 200.0
    fBTB = F["BTB"] + 6.0
    fbTA = F["bTAf"] + F["bTAr"] + 100.0
    fbTB = F["bTBf"] + F["bTBr"] + 3.0
    frag_sidelen_frac = 1.0 - np.minimum(
        np.clip(F["aLIT"] // np.maximum(1, F["aDPfr"] + F["aDPrr"])
                - cfg.microadjust_longfrag_sidelength_min, 0,
                cfg.microadjust_longfrag_sidelength_max),
        np.clip(F["aRIT"] // np.maximum(1, F["aDPff"] + F["aDPrf"])
                - cfg.microadjust_longfrag_sidelength_min, 0,
                cfg.microadjust_longfrag_sidelength_max)
    ) / cfg.microadjust_longfrag_sidelength_zeroMQpenalty
    _alt_frac = fbTB / fbTA
    alt_frac = np.where(is_nmore_amp, np.maximum(0, _alt_frac - 0.2) * 1.25,
                        _alt_frac)
    nonalt_frac = ((fBTB + cfg.contam_any_mul_frac * fbTB - fbTB)
                   / (fBTA + cfg.contam_any_mul_frac * fbTA - fbTA))
    frac_mut = np.maximum(cfg.syserr_MQ_NMR_expfrac,
                          cfg.syserr_MQ_NMR_altfrac_coef * alt_frac * frag_sidelen_frac
                          - cfg.syserr_MQ_NMR_nonaltfrac_coef * nonalt_frac)
    bNMQ = np.round(numstates2phred(np.power(
        frac_mut / cfg.syserr_MQ_NMR_expfrac, cfg.syserr_MQ_NMR_pl_exponent))
        * frac_mut).astype(_itype())
    F["bNMa"] = np.round(100 * alt_frac).astype(_itype())
    F["bNMb"] = np.round(100 * nonalt_frac).astype(_itype())
    F["bNMQ"] = bNMQ

    is_tmore_amp_pl = is_tmore_amp | ((cfg.primerlen > 0) and not (0x4 & cfg.primer_flag))
    bFAa = bFA
    tier1_selfonly_min = _minr([
        cROFA1, aLPFA2, aRPFA2, aLBFA2, aRBFA2, cFA0,
        aDPFA * np.clip(1.0 + aDPFA - alt_frac, 0.1, 1.0),
        aPFFA * aSSFA2 / np.maximum(aSSFA2, aSSFAx[1])])
    tier1_selfplus_min = _minr([
        aSSFA2, aLIFA2, aRIFA2, np.maximum(aDPFA * 0.01, aSIFA), bFAa])

    cFA2a = np.where(is_tmore_amp_pl & (not is_rescued),
                     cFA2 * cfg.powlaw_amplicon_allele_fraction_coef, cFA2)
    t3gate = (normBDP * 100 > normCDP1 * tdiv(
        cfg.fam_tier3DP_bias_overseq_perc - 100, 2 if is_rescued else 1) + normCDP1 * 100)
    cFA3a = np.where(t3gate, cFA3, 1.0)
    c23FA = cFA2a

    tier2_selfonly_min = _minr([
        cROFA2, c2LPFA2, c2RPFA2, c2LBFA2, c2RBFA2, cFA2a, cFA3a, cFA2L, cFA2R])

    # FTS bias flags
    thresr = cfg.bias_thres_FTS_FA
    fts = {}
    for name, refFA, biasFA in (
            ("aStrand", aDPFA, aSSFA2), ("aBQXM", aDPFA, aPFFA),
            ("aInsertSize", aDPFA, aSIFA), ("aAlignL", aDPFA, aLBFA2),
            ("aAlignR", aDPFA, aRBFA2), ("aPositionL", aDPFA, aLPFA2),
            ("aPositionR", aDPFA, aRPFA2), ("abPositionL", aDPFA, aLIFA2),
            ("abPositionR", aDPFA, aRIFA2), ("bcDup", bFA, cFA0),
            ("cbDup", cFA0, bFA), ("c0Orientation", cFA0, cROFA1),
            ("c2Orientation", cFA2, cROFA2), ("c2PositionL", cFA2, c2LPFA2),
            ("c2PositionR", cFA2, c2RPFA2), ("c2AlignL", cFA2, c2LBFA2),
            ("c2AlignR", cFA2, c2RBFA2), ("c2StrictPosL", cFA2, cFA2L),
            ("c2StrictPosR", cFA2, cFA2R)):
        # C round() semantics (half-away-from-zero, main.hpp:4268), NOT
        # numpy's banker's rounding: the ratio is always >= 0 here
        fts[name] = (biasFA < refFA * thresr,
                     np.floor(100.0 * biasFA / refFA + 0.5).astype(_itype()))
    F["FTS"] = fts
    # nNFA/nAFA/nBCFA deciphred diagnostics in the reference's exact push
    # order (main.hpp:4745-4773: nNFA counterbias/aDP/b/c0/c2; nAFA
    # aSSFA2,aPFFA,aSIFA,aLBFA2,aRBFA2,aLPFA2,aRPFA2,aLIFA2,aRIFA2; nBCFA
    # cFA0,bFA,cROFA1,cROFA2,c2LPFA2,c2RPFA2,c2LBFA2,c2RBFA2,cFA2L,cFA2R);
    # ONE stacked log pass over all 25 planes instead of 25 ufunc dispatches
    _dp_src = (counterbias_P_FA, counterbias_BQ_FA, aDPFA, bFA, cFA0, cFA2,
               aSSFA2, aPFFA, aSIFA, aLBFA2, aRBFA2, aLPFA2, aRPFA2,
               aLIFA2, aRIFA2,
               cFA0, bFA, cROFA1, cROFA2, c2LPFA2, c2RPFA2, c2LBFA2,
               c2RBFA2, cFA2L, cFA2R)
    _dp_stack = np.stack([np.broadcast_to(x, aDPFA.shape) for x in _dp_src])
    _dp_all = (-np.round(100.0 / math.log(10.0)
                         * np.log(np.maximum(_dp_stack, 1e-12)))
               .astype(_itype()))
    F["nNFA"] = [_dp_all[i] for i in range(6)]
    F["nAFA"] = [_dp_all[i] for i in range(6, 15)]
    F["nBCFA"] = [_dp_all[i] for i in range(15, 25)]

    aNCFA = np.where(
        is_tumor_only & short_frag & is_indel
        & (F["gapLen"] >= cfg.lib_nonwgs_clip_penal_min_indelsize),
        np.maximum((F["aNC"] + 0.5) / (ADP + 1.0),
                   np.clip((F["cDP1f"] + F["cDP1r"]) / 300.0, 1.0 / 3.0, 2.0 / 3.0)
                   * aDPFA),
        2.0)
    cb_norm = np.where(
        is_tumor_only | ~short_frag, 1e-9,
        np.clip(aPFFA * aPFFA * (1.0 / cfg.lib_nonwgs_normal_full_self_rescue_fa),
                aPFFA * cfg.lib_nonwgs_normal_min_self_rescue_fa_ratio, aPFFA))
    counterbias_FA = np.maximum(np.maximum(counterbias_P_FA, counterbias_BQ_FA),
                                cb_norm)

    dedup_FA = (np.minimum(bFA, cFA0) if is_tumor_only
                else np.maximum(bFA, cFA0))
    frac_umi2seg = _minr([np.ones((P, NS)), c23FA / aDPFA,
                                      aDPFA / c23FA])

    refbias = np.zeros((P, NS))
    if is_rescued:
        noinfo = (F["gapLen"] * np.where(is_ins, 2, 1)
                  + np.maximum(np.maximum(F["gapLen"], rtr1_tl),
                               F["rtr2_anyTR_tracklen_3"][:, None]))
        rb = noinfo / ((np.minimum(F["ALPL"], F["ARPL"]) * 2 + noinfo)
                       / (F["ABQ2"] + 0.5))
        refbias = np.where(is_indel & rescued_allele,
                           np.minimum(rb, cfg.microadjust_refbias_indel_max), 0.0)

    def norm_fa(FA):
        return (FA + FA * refbias) / (FA + (1.0 - FA) / (1.0 + refbias) + FA * refbias)

    min_v = np.maximum(np.minimum(np.minimum(tier1_selfplus_min,
                                             tier1_selfonly_min), aNCFA),
                       counterbias_FA)
    F["cDP1v"] = (norm_fa(min_v) * F["CDP1"] * 100).astype(_itype())
    min_w = np.maximum(_minr([aLPFA2, aRPFA2, aLBFA2, aRBFA2,
                                          bFA, aNCFA]), counterbias_FA)
    F["cDP1w"] = (norm_fa(min_w) * F["CDP1"] * 100).astype(_itype())
    min_x = np.minimum(aPFFA, dedup_FA)
    if not is_tumor_only:
        min_x = np.maximum(min_x, counterbias_FA)
    F["cDP1x"] = 1 + (min_x * F["CDP1"] * 100).astype(_itype())

    c2XB = np.clip(3.0 * c2LBFA2 * c2RBFA2 * aSSFA2 / (cFA2 ** 3),
                   np.minimum(c2LBFA2, c2RBFA2) / 8.0,
                   np.minimum(c2LBFA2, c2RBFA2))
    c2XP = np.clip(3.0 * c2LPFA2 * c2RPFA2 * aSSFA2 / (cFA2 ** 3),
                   np.minimum(c2LPFA2, c2RPFA2) / 8.0,
                   np.minimum(c2LPFA2, c2RPFA2))
    c2XX = np.minimum(c2XB, c2XP)
    min_c2v = np.maximum(np.minimum(_minr([
        tier1_selfplus_min, tier2_selfonly_min, c2XX]), aNCFA),
        counterbias_FA * frac_umi2seg)
    F["cDP2v"] = (norm_fa(min_c2v) * F["CDP2"] * 100).astype(_itype())
    min_c2w = np.maximum(_minr([
        c2LPFA2, c2RPFA2, c2XX, c2LBFA2, c2RBFA2, cFA2, aNCFA]),
        counterbias_FA * frac_umi2seg)
    F["cDP2w"] = (norm_fa(min_c2w) * F["CDP2"] * 100).astype(_itype())
    min_c2x = np.minimum(aPFFA, c23FA)
    F["cDP2x"] = 1 + (min_c2x * F["CDP2"] * 100).astype(_itype())
    return F


def candidate_mask(F, cfg, is_tumor_only=True, rescued_pos_sym=None):
    """Which (pos, symbol) pairs become fmt candidates (main.cpp:805-841):
    alt symbols need bdepth >= min_altdp_thres; the ref symbol is included
    when the position's total bdepth minus the ref bdepth reaches the same
    threshold. In rescued (normal) mode only rescued pairs are candidates.

    Host-side gating (plain numpy): this runs BEFORE the jitted model to
    pick the candidate rows it will evaluate."""
    P = F["P"]
    bdepth = F["bDPf"] + F["bDPr"]
    refsym = F["ref_syms"][:, None]
    sym = onp.broadcast_to(onp.arange(NS)[None, :], (P, NS))
    is_ref = ((sym == refsym) & IS_SUBST[None, :]) | (sym == int(Symbol.LINK_M))
    ref_bdepth = onp.take_along_axis(bdepth, refsym, axis=1)
    ref_bdepth_l = onp.take_along_axis(
        bdepth, onp.full((P, 1), int(Symbol.LINK_M)), axis=1)
    tot = F["BDP"]
    nonref = onp.where(IS_SUBST[None, :], tot - ref_bdepth, tot - ref_bdepth_l)
    if is_tumor_only:
        mask = onp.where(is_ref, nonref >= cfg.min_altdp_thres,
                         bdepth >= cfg.min_altdp_thres)
        if cfg.should_output_all:
            mask = onp.ones((P, NS), dtype=bool)
    else:
        mask = onp.zeros((P, NS), dtype=bool)
        if rescued_pos_sym is not None:
            for (p, s) in rescued_pos_sym:
                if 0 <= p < P:
                    mask[p, :] = True  # pos-rescued: all symbols at the pos
    return mask


def _sum_by_symboltype_j(arr):
    """[.., 14] -> per-symbol broadcast of the symboltype sums, traceable."""
    base = arr[..., :6].sum(axis=-1, keepdims=True)
    link = arr[..., 6:].sum(axis=-1, keepdims=True)
    return jnp.concatenate([jnp.broadcast_to(base, arr.shape[:-1] + (6,)),
                            jnp.broadcast_to(link, arr.shape[:-1] + (8,))],
                           axis=-1)


def _nn_broadcast_j(arr):
    """Value of the type's NN symbol broadcast to all symbols, traceable."""
    base_nn = arr[..., int(Symbol.BASE_NN)][..., None]
    link_nn = arr[..., int(Symbol.LINK_NN)][..., None]
    return jnp.concatenate(
        [jnp.broadcast_to(base_nn, arr.shape[:-1] + (6,)),
         jnp.broadcast_to(link_nn, arr.shape[:-1] + (8,))], axis=-1)


def sum_dpv(F, cand):
    """BcfFormat_symbol_sum_DPv (main.hpp:4888-4906): per-position sums of
    the six reductions over the CANDIDATE symbols of each type ([0]) and
    the candidate NN symbol's value ([1])."""
    for nm in ("cDP1v", "cDP1w", "cDP1x", "cDP2v", "cDP2w", "cDP2x"):
        masked = np.where(cand, F[nm], 0)
        F["C" + nm[1:]] = _sum_by_symboltype_j(masked)
        F["C" + nm[1:] + "_nn"] = _nn_broadcast_j(masked)
    return F
