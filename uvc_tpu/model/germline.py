"""Germline genotyper core: vectorized output_germline (main.hpp:5457-5775).

Computes, per (position, symboltype): the 4-genotype likelihood array GL4
over {0/0, 0/1, 1/1, 1/2}, the resulting normal-evidence LOD
nlodq = GL(0/0) - max(GL(others)), and the identities of the top-2 ALT
alleles (consumed by the tumor-normal join). The GERMLINE VCF line itself
is emitted by vcfout when OUTVAR_GERMLINE is requested.
"""

import math

import numpy as np

from ..constants import Symbol, NUM_SYMBOLS
from .dpv import IS_SUBST, IS_INS

NS = NUM_SYMBOLS
INV_LOG10 = 10.0 / math.log(10.0)
DBL_EPSILON = 2.220446049250313e-16


def binom_lr(prob, a, b):
    """numpy float64 calc_binom_10log10_likeratio: the germline stage runs
    on the HOST (in forked pileup workers that must never touch jax), so
    it keeps its own numpy kernel (main_conversion.hpp:222-237)."""
    prob = (np.asarray(prob, np.float64) + DBL_EPSILON) / (1.0 + 2.0 * DBL_EPSILON)
    a = np.asarray(a, np.float64) + DBL_EPSILON
    b = np.asarray(b, np.float64) + DBL_EPSILON
    A = prob * (a + b)
    B = (1.0 - prob) * (a + b)
    lr = INV_LOG10 * (a * np.log(a / A) + b * np.log(b / B))
    return np.where(a > A, lr, 0.0)

SYMBOL_TO_INDEL_N_UNITS = np.array(
    [0, 0, 0, 0, 0, 0, 0, -3, -2, -1, 3, 2, 1, 0, 0], dtype=np.int64)

# symbols participating per type (BASE_NN excluded, LINK_NN included;
# main.cpp:1042-1044)
BASE_CAND = [0, 1, 2, 3, 4]
LINK_CAND = [6, 7, 8, 9, 10, 11, 12, 13]


def het_lodq(a1, a2, expfrac, pl_exp):
    binom = binom_lr(expfrac, a1, a2)
    x = (a1 + 0.5) * 0.5 / expfrac
    y = (a2 + 0.5) * 0.5 / (1.0 - expfrac)
    power = np.round(INV_LOG10 * pl_exp * np.maximum(
        np.log((x + DBL_EPSILON) / (y + DBL_EPSILON)), 0.0))
    return np.minimum(binom, power).astype(np.int64)


def germline_nlodq(F, cand, cfg, is_tumor_only=True):
    """Returns per (pos, symboltype=2): nlodq, alt1_sym, alt2_sym,
    alt1/alt2 per-allele metrics needed by the TN join and ranking."""
    P = F["P"]
    refsym = F["ref_syms"]
    # int64 before the int64-min sentinel: an f32 device returns gVQ1 as
    # int32, where the sentinel would wrap to 0 and read as present
    gvq = np.where(cand, F["gVQ1"].astype(np.int64), np.iinfo(np.int64).min)
    contq = F["CONTQ"]
    adnorm = F["cDP1v"] / 100.0

    out = {}
    for st, symbols in ((0, BASE_CAND), (1, LINK_CAND)):
        cols = np.array(symbols)
        g = gvq[:, cols]            # [P, k]
        cq = contq[:, cols]
        ad = adnorm[:, cols]
        present = cand[:, cols]
        if st == 0:
            isref = cols[None, :] == refsym[:, None]
        else:
            isref = np.broadcast_to(
                (cols == int(Symbol.LINK_M)) | (cols == int(Symbol.LINK_NN)),
                (P, len(cols)))
        # ref pick: argmax gvq among ref & present; dummy (gvq=0, ad=0.5)
        gref = np.where(isref & present, g, np.iinfo(np.int64).min)
        r_idx = np.argmax(gref, axis=1)
        has_ref = np.take_along_axis(gref, r_idx[:, None], 1)[:, 0] > np.iinfo(np.int64).min
        a0 = np.where(has_ref, np.take_along_axis(g, r_idx[:, None], 1)[:, 0], 0)
        cq0 = np.where(has_ref, np.take_along_axis(cq, r_idx[:, None], 1)[:, 0], 0)
        ad0 = np.where(has_ref, np.take_along_axis(ad, r_idx[:, None], 1)[:, 0], 0.5)
        # alts sorted by gvq desc, first-come order for ties replicated by
        # stable sort over (-gvq); float sentinel avoids int64-min negation
        # overflow
        galt = np.where((~isref) & present, g.astype(np.float64), -np.inf)
        order = np.argsort(-galt, axis=1, kind="stable")
        g_sorted = np.take_along_axis(
            np.where((~isref) & present, g, np.iinfo(np.int64).min), order, 1)
        cq_sorted = np.take_along_axis(cq, order, 1)
        ad_sorted = np.take_along_axis(ad, order, 1)
        sym_sorted = cols[order]

        def pick(i):
            if i < g_sorted.shape[1]:
                valid = g_sorted[:, i] > np.iinfo(np.int64).min
                return (np.where(valid, g_sorted[:, i], 0),
                        np.where(valid, cq_sorted[:, i], 0),
                        np.where(valid, ad_sorted[:, i], 0.5),
                        np.where(valid, sym_sorted[:, i], NS))
            z = np.zeros(P, dtype=np.int64)
            return z, z.copy(), np.full(P, 0.5), np.full(P, NS, dtype=np.int64)

        a1, cq1, ad1, sym1 = pick(0)
        a2, cq2, ad2, sym2 = pick(1)
        a3, cq3, ad3, sym3 = pick(2)

        # symbolNN merge (main.hpp:5536-5548)
        is_subst_ref = st == 0
        symbolNN = (int(Symbol.BASE_NN) if (is_subst_ref or is_tumor_only)
                    else int(Symbol.LINK_NN))
        m1 = sym1 == symbolNN
        ad0 = np.where(m1, ad0 + ad1, ad0)
        ad1 = np.where(m1, 0.0, ad1)
        m2 = sym2 == symbolNN
        ad0 = np.where(m2, ad0 + ad2, ad0)
        ad2 = np.where(m2, 0.0, ad2)

        pl = cfg.powlaw_exponent
        a0a1 = het_lodq(ad0, ad1, 1.0 - cfg.germ_hetero_FA, pl)
        a1a0 = het_lodq(ad1, ad0, cfg.germ_hetero_FA, pl)
        a1a2 = het_lodq(ad1, ad2, 0.5, pl)
        a2a1 = het_lodq(ad2, ad1, 0.5, pl)

        phred_hetero = (cfg.germ_phred_hetero_snp if st == 0
                        else cfg.germ_phred_hetero_indel)
        phred_homalt = (cfg.germ_phred_homalt_snp if st == 0
                        else cfg.germ_phred_homalt_indel)
        phred_tri_al = (cfg.germ_phred_het3al_snp if st == 0
                        else cfg.germ_phred_het3al_indel)

        a0L = np.minimum(a0, cq0)
        if is_tumor_only:
            a1L, a2L, a3L = a1, a2, a3
        else:
            a1L = np.minimum(a1, cq1)
            a2L = np.minimum(a2, cq2)
            a3L = np.minimum(a3, cq3)

        a2penal = np.maximum(a2L - (phred_tri_al - phred_hetero), 0)
        a3penal = np.maximum(a3L - phred_hetero, 0)
        a01hetp = np.maximum(np.maximum(a0a1, a1a0), 0)
        a12hetp = np.maximum(np.maximum(a1a2, a2a1) - 3, 0)
        a03trip = np.maximum(a0L, a3L)

        tri = np.zeros(P, dtype=np.int64)
        both_ins = IS_INS[np.minimum(sym1, NS - 1)] & IS_INS[np.minimum(sym2, NS - 1)]
        tri += np.where(both_ins, 3, 0)
        same = both_ins & (sym1 == sym2)
        tri += np.where(same, 3, 0)
        tri += np.where(same & (sym1 == int(Symbol.LINK_I3P)), 3, 0)
        n1 = SYMBOL_TO_INDEL_N_UNITS[np.minimum(sym1, NS)]
        n2 = SYMBOL_TO_INDEL_N_UNITS[np.minimum(sym2, NS)]
        nz = (n1 != 0) & (n2 != 0)
        tri -= np.where(nz, np.clip(np.abs(n1 - n2) * 3 - 5, 0, 9), 0)

        GL0 = -0 - a1L - a2penal - a3penal
        GL1 = (-phred_hetero - np.maximum(a01hetp, a2L)
               - np.maximum(np.minimum(a01hetp, a2L) - phred_hetero, 0) - a3penal)
        GL2 = (-phred_homalt - np.maximum(a0L, a2L)
               - np.maximum(np.minimum(a0L, a2L) - phred_hetero, 0) - a3penal)
        GL3 = (-phred_tri_al - np.maximum(a12hetp, a03trip)
               - np.maximum(np.minimum(a12hetp, a03trip) - phred_hetero, 0)
               - np.maximum(np.minimum(a12hetp, np.minimum(a0L, a3L)) - phred_hetero, 0)
               - tri)
        nlodq = GL0 - np.maximum(np.maximum(GL1, GL2), GL3)
        out[st] = {
            "nlodq": nlodq, "GL4": np.stack([GL0, GL1, GL2, GL3], axis=1),
            "alt1_sym": sym1, "alt2_sym": sym2,
            "alt1_cDP1v": np.where(sym1 < NS, 0, 0),  # filled below
            "a_lodqs": np.stack([a0L, a1L, a2L, a3L], axis=1),
            "het_lodqs": np.stack([a0a1, a1a0, a1a2, a2a1], axis=1),
        }
        # per-alt arrays for the TN join (cDP1x / CDP1x of the top-2 alts)
        for nm, s_arr in (("alt1", sym1), ("alt2", sym2)):
            valid = s_arr < NS
            si = np.minimum(s_arr, NS - 1)
            rows = np.arange(P)
            out[st][nm + "_cDP1x"] = np.where(valid, F["cDP1x"][rows, si], 50)
            out[st][nm + "_cVQ1"] = np.where(valid, F["cVQ1"][rows, si], 0)
            out[st][nm + "_cVQ2"] = np.where(valid, F["cVQ2"][rows, si], 0)
            out[st][nm + "_cDP0a"] = np.where(valid, F["cDP0a"][rows, si], 0)
    return out
